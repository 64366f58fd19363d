"""The port's four-step NTT (``ops/four_step.py``) against the JAX package.

(a) ``build_four_step_tables`` equals ``seal_tpu.ntt_tables.build_mxu_tables``
    once the latter's int8 digit planes (value = sum_p plane_p * 2^(7p)) and
    uint32 lo/hi words are recomposed: forced splits at n=1024 (n2=2) and
    n=2048 (n2=4), an ``inv_scale`` other than 1, and the default
    factorization at n=65536 and n=131072.
(b) ``stage_plain`` equals the Pallas ``_stage_kernel`` through
    ``_run_stage(..., interpret=True)`` with and without the twiddle, at
    n1=512 with 60-bit moduli, where the JAX package splits the contraction
    (kchunk 256 < K = 512).  Butterflies over the tables' root tables (the
    card's stage kernel runs them) equal ``stage_plain`` for all four
    transforms; at the N=65536 and 131072 splits the root tables hold the
    powers the matrices are built from.
(c) ``four_step_forward`` / ``four_step_inverse`` equal
    ``pallas_ntt_forward`` / ``pallas_ntt_inverse(interpret=True)`` at
    n=2048, n2=4 (the staged branch), and the port's butterflies.
(d) The staged key switch with the four-step NTT equals
    ``switch_key_contract_plain``.
(e) ``ops/ntt.py`` sends a CUDA tensor above n=32768 to the stage kernel and
    a smaller one to kernel A, and to the butterflies inside
    ``plain_on_card()``; the stage kernel's wrapper refuses CPU tensors.
    The card is faked; nothing runs on one.
(f) Tables cut from a bundle take their four-step constants from the
    bundle's, which it builds once and keeps.

Every comparison is exact equality of reduced residues.
"""

import numpy as np
import pytest
import torch

from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus
from seal_tpu.ntt_tables import build_mxu_tables
from seal_tpu.ops import pallas_mxu_ntt as PL
from seal_tpu.ops import u64 as JU

from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SealContext, SecurityLevel
from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.modulus import Modulus
from seal_tpu_torch.ntt_tables import build_four_step_tables, build_limb_tables, default_split, four_step_tables_for
from seal_tpu_torch.ops import four_step as FS
from seal_tpu_torch.ops import ntt as NTT
from seal_tpu_torch.ops.cuda_four_step import stage_cuda
from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_plain
from seal_tpu_torch.ops.rns import slice_limbs, take_limbs


def _planes_value(planes: np.ndarray) -> np.ndarray:
    """int8 digit planes (P, ...) -> uint64 values."""
    out = np.zeros(planes.shape[1:], dtype=np.uint64)
    for p in range(planes.shape[0]):
        out += planes[p].astype(np.uint64) << np.uint64(7 * p)
    return out


def _words(lo, hi) -> np.ndarray:
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _assert_tables_equal(mt, ft):
    k = ft.q.shape[0]
    n = ft.n1 * ft.n2
    assert (mt.n1, mt.n2) == (ft.n1, ft.n2)
    for jax_planes, port in ((mt.w_planes, ft.w), (mt.f_planes, ft.f),
                             (mt.winv_planes, ft.winv), (mt.finv_planes, ft.finv)):
        np.testing.assert_array_equal(u64_to_numpy(port), _planes_value(jax_planes))
    for (lo, hi), port in (((mt.t_op_lo, mt.t_op_hi), ft.tw_op), ((mt.t_qt_lo, mt.t_qt_hi), ft.tw_qt),
                           ((mt.ti_op_lo, mt.ti_op_hi), ft.twi_op), ((mt.ti_qt_lo, mt.ti_qt_hi), ft.twi_qt)):
        np.testing.assert_array_equal(u64_to_numpy(port), _words(lo, hi).reshape(k, n))
    np.testing.assert_array_equal(u64_to_numpy(ft.q).reshape(k), _words(mt.q_lo, mt.q_hi).reshape(k))
    np.testing.assert_array_equal(u64_to_numpy(ft.ratio_lo).reshape(k),
                                  _words(mt.ratio_lo_lo, mt.ratio_lo_hi).reshape(k))
    np.testing.assert_array_equal(u64_to_numpy(ft.ratio_hi).reshape(k),
                                  _words(mt.ratio_hi_lo, mt.ratio_hi_hi).reshape(k))


def _moduli(n, bits):
    jm = JaxCoeffModulus.create(n, bits)
    pm = CoeffModulus.create(n, bits)
    assert [m.value for m in jm] == [m.value for m in pm]
    return jm, pm


@pytest.mark.parametrize("log_n, n2, bits, inv_scale", [
    (10, 2, [60, 40], None),
    (11, 4, [60, 50, 40], None),
    (11, 4, [60, 40], [65537, 1 << 40]),
])
def test_tables_equal_jax_mxu_tables(log_n, n2, bits, inv_scale):
    jm, pm = _moduli(1 << log_n, bits)
    mt = build_mxu_tables(log_n, jm, n2=n2, inv_scale=inv_scale)
    ft = build_four_step_tables(log_n, pm, n2=n2, inv_scale=inv_scale, device="cpu")
    _assert_tables_equal(mt, ft)


@pytest.mark.parametrize("log_n, n1, n2", [(16, 512, 128), (17, 512, 256)])
def test_default_factorization_at_large_n(log_n, n1, n2):
    """The JAX package's rule keeps n1 <= 512; one 50-bit modulus."""
    jm, pm = _moduli(1 << log_n, [50])
    mt = build_mxu_tables(log_n, jm)
    ft = build_four_step_tables(log_n, pm, device="cpu")
    assert default_split(log_n) == n2 and (ft.n1, ft.n2) == (n1, n2)
    _assert_tables_equal(mt, ft)


@pytest.fixture(scope="module")
def staged_n1024():
    """n=1024 split 512 x 2 over two 60-bit moduli, tables of both packages."""
    jm, pm = _moduli(1024, [60, 60])
    mt = build_mxu_tables(10, jm, n2=2)
    assert mt.kchunk_a < 512                      # the JAX contraction is split
    return mt, build_four_step_tables(10, pm, n2=2, device="cpu")


@pytest.mark.parametrize("matrix", ["w", "winv"])
@pytest.mark.parametrize("twiddle", [False, True])
def test_stage_equals_pallas_stage_kernel(staged_n1024, matrix, twiddle):
    mt, ft = staged_n1024
    q = np.array(ft.moduli_values, dtype=np.uint64).reshape(1, -1, 1, 1)
    x = np.random.default_rng(3).integers(0, 1 << 62, (2, 2, 512, 2), dtype=np.uint64) % q
    x[..., 0, 0] = q[..., 0, 0] - np.uint64(1)
    planes = mt.w_planes if matrix == "w" else mt.winv_planes
    jtw = (mt.t_op_lo, mt.t_op_hi, mt.t_qt_lo, mt.t_qt_hi) if twiddle else None
    want = JU.to_np_u64(PL._run_stage(JU.from_np_u64(x), planes, mt, mt.kchunk_a, jtw,
                                      transpose_const=False, interpret=True))
    spec = FS.StageSpec(512, 512, 2, (2, 1), (2, 1))
    ptw = (ft.tw_op, ft.tw_qt) if twiddle else None
    got = FS.stage_plain(u64_from_numpy(x.reshape(2, 2, 1024), "cpu"), matrix, ft, spec, ptw)
    np.testing.assert_array_equal(u64_to_numpy(got).reshape(x.shape), want)


def _butterflies(x: np.ndarray, roots, q: int, inverse: bool) -> np.ndarray:
    """The transform of every column of x (..., M, ncols), Python ints mod q,
    as butterflies over one limb's root table: Cooley-Tukey, natural to
    bit-reversed order (stage s reads slot 2^s + block), or Gentleman-Sande,
    bit-reversed to natural (stage s reads slot 1 + M - M/2^s + block; slot 0
    scales the last stage's sum, slot M - 1 is its root, already scaled)."""
    a = x.copy()
    M = a.shape[-2]
    log_m = M.bit_length() - 1
    for s in range(log_m):
        if not inverse:
            gap = M >> (s + 1)
            for blk in range(1 << s):
                lo = a[..., 2 * blk * gap:(2 * blk + 1) * gap, :]
                hi = a[..., (2 * blk + 1) * gap:(2 * blk + 2) * gap, :]
                t = hi * roots[(1 << s) + blk] % q
                lo[...], hi[...] = (lo + t) % q, (lo - t) % q
        else:
            gap = 1 << s
            offset = 1 + M - (M >> s)
            for blk in range(M >> (s + 1)):
                lo = a[..., 2 * blk * gap:(2 * blk + 1) * gap, :]
                hi = a[..., (2 * blk + 1) * gap:(2 * blk + 2) * gap, :]
                scale = roots[0] if s == log_m - 1 else 1
                lo[...], hi[...] = (lo + hi) * scale % q, (lo - hi) * roots[offset + blk] % q
    return a


def _stage_by_butterflies(x: torch.Tensor, name: str, ft, spec, twiddle) -> torch.Tensor:
    """A stage as the card's kernel computes it: read each column through the
    input strides, run the named transform's butterflies, multiply by the
    twiddle at the output position and write through the output strides."""
    *lead, k, n = x.shape
    xs = u64_to_numpy(x).reshape(-1, k, n).astype(object)
    out = np.empty_like(xs)
    roots = u64_to_numpy(getattr(ft, f"{name}_roots")).astype(object)
    tw = None if twiddle is None else u64_to_numpy(twiddle[0]).astype(object)
    m_idx, t_idx = np.meshgrid(np.arange(spec.M), np.arange(spec.ncols), indexing="ij")
    src = m_idx * spec.x_strides[0] + t_idx * spec.x_strides[1]
    dst = m_idx * spec.out_strides[0] + t_idx * spec.out_strides[1]
    for limb, q in enumerate(ft.moduli_values):
        col = xs[:, limb][:, src] % q                                   # (rows, M, ncols)
        y = _butterflies(col, list(roots[limb, 0]), q, name in FS.INVERSE_TRANSFORMS)
        if tw is not None:
            y = y * tw[limb][dst] % q
        out[:, limb][:, dst] = y
    return u64_from_numpy(out.astype(np.uint64).reshape(x.shape), "cpu")


@pytest.mark.parametrize("log_n, n2, inv_scale", [
    (12, 64, None),                   # n1 = n2
    (11, 16, [3, 1 << 40]),           # n1 = 128 > n2, inv_scale != 1
    (10, 128, [65537, 5]),            # n1 = 8 < n2
])
@pytest.mark.parametrize("twiddle", [False, True])
def test_butterflies_over_root_tables_equal_stage_plain(log_n, n2, inv_scale, twiddle):
    """Every transform of both directions, in both stage layouts, on lazy
    inputs (below 4q forward, 2q inverse)."""
    mods = CoeffModulus.create(1 << log_n, [60, 40])
    ft = build_four_step_tables(log_n, mods, n2=n2, inv_scale=inv_scale, device="cpu")
    gen = torch.Generator().manual_seed(log_n + twiddle)
    cases = ((FS.forward_specs(ft), ("w", "f"), (ft.tw_op, ft.tw_qt), 4),
             (FS.inverse_specs(ft), ("finv", "winv"), (ft.twi_op, ft.twi_qt), 2))
    for specs, names, tw, lazy in cases:
        for spec, name in zip(specs, names):
            x = torch.randint(0, 1 << 62, (2, 2, 1 << log_n), generator=gen) % (lazy * ft.q)
            x[0, :, 0] = lazy * ft.q[:, 0] - 1
            twx = tw if twiddle else None
            assert torch.equal(_stage_by_butterflies(x, name, ft, spec, twx),
                               FS.stage_plain(x, name, ft, spec, twx)), name


@pytest.mark.parametrize("log_n", [16, 17])
def test_root_tables_hold_the_matrices_powers_at_large_n(log_n):
    """At N=65536 (512 x 128) and 131072 (512 x 256), where the dense
    product is too slow to run here: the generators read from the matrices
    (W[0, r] = eta^r, F[t2, 1] = zeta^brv(t2)) and the scales (Winv[0, 0],
    Finv[0, 0]) give every slot of the four root tables by the butterflies'
    table rules, and the Shoup quotients match."""
    mods = CoeffModulus.create(1 << log_n, [50])
    ft = build_four_step_tables(log_n, mods, device="cpu")
    q = ft.moduli_values[0]
    n1, n2 = ft.n1, ft.n2
    W, F = u64_to_numpy(ft.w[0]).astype(object), u64_to_numpy(ft.f[0]).astype(object)
    Winv, Finv = u64_to_numpy(ft.winv[0]).astype(object), u64_to_numpy(ft.finv[0]).astype(object)
    eta = int(W[0, 1])                     # W[0, r] = eta^r (brv(0) = 0)
    zeta = int(F[1 << (n2.bit_length() - 2), 1])   # F[t2, 1] = zeta^brv(t2); brv(n2/2) = 1
    assert int(W[0, 2]) == eta * eta % q and pow(eta, n1, q) == q - 1
    assert pow(zeta, n2, q) == 1 and pow(zeta, n2 // 2, q) == q - 1
    inv_n1, inv_n2 = int(Winv[0, 0]), int(Finv[0, 0])       # the scales, row 0 of the inverses
    assert inv_n1 * n1 % q == 1 and inv_n2 * n2 % q == 1

    def brv(v, bits):
        return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0

    for name, M, root, cyclic in (("w", n1, eta, False), ("f", n2, zeta, True)):
        log_m = M.bit_length() - 1
        fwd = [int(v) for v in u64_to_numpy(getattr(ft, f"{name}_roots")[0, 0])]
        qt = [int(v) for v in u64_to_numpy(getattr(ft, f"{name}_roots")[0, 1])]
        inv = [int(v) for v in u64_to_numpy(getattr(ft, f"{name}inv_roots")[0, 0])]
        scale = inv_n2 if cyclic else inv_n1
        assert fwd[0] == 1 and inv[0] == scale
        for s in range(log_m):
            for b in range(1 << s):
                e = brv(b, s) * (M >> (s + 1)) if cyclic else brv((1 << s) + b, log_m)
                assert fwd[(1 << s) + b] == pow(root, e, q)
                assert qt[(1 << s) + b] == (fwd[(1 << s) + b] << 64) // q
            offset = 1 + M - (M >> s)
            for b in range(M >> (s + 1)):
                want = pow(fwd[(M >> (s + 1)) + b], -1, q) * (scale if s == log_m - 1 else 1) % q
                assert inv[offset + b] == want


@pytest.fixture(scope="module")
def staged_n2048():
    jm, pm = _moduli(2048, [60, 40])
    return (build_mxu_tables(11, jm, n2=4), build_four_step_tables(11, pm, n2=4, device="cpu"),
            build_limb_tables(11, pm, device="cpu"))


@pytest.mark.parametrize("inverse", [False, True])
def test_transforms_equal_pallas_staged_and_butterflies(staged_n2048, inverse):
    mt, ft, lt = staged_n2048
    assert mt.n1 == 512 > PL._FUSED_MAX_N1          # the staged branch
    q = np.array(ft.moduli_values, dtype=np.uint64).reshape(-1, 1)
    x = np.random.default_rng(5 + inverse).integers(0, 1 << 62, (2, 2, 2048), dtype=np.uint64) % (
        q * np.uint64(2 if inverse else 4))
    x[..., 0] = q[:, 0] * np.uint64(2 if inverse else 4) - np.uint64(1)
    pallas_op = PL.pallas_ntt_inverse if inverse else PL.pallas_ntt_forward
    want = JU.to_np_u64(pallas_op(JU.from_np_u64(x), mt, interpret=True))
    port_op = FS.four_step_inverse if inverse else FS.four_step_forward
    xt = u64_from_numpy(x, "cpu")
    got = u64_to_numpy(port_op(xt, ft))
    np.testing.assert_array_equal(got, want)
    butterflies = NTT.ntt_inverse(xt, lt) if inverse else NTT.ntt_forward(xt, lt)
    np.testing.assert_array_equal(got, u64_to_numpy(butterflies))


def test_inverse_with_inv_scale_equals_butterflies():
    """inv_scale folds into Winv as it folds into the butterflies' last stage."""
    mods = CoeffModulus.create(4096, [60, 40])
    scale = [3, 1 << 40]
    ft = build_four_step_tables(12, mods, inv_scale=scale, device="cpu")
    lt = build_limb_tables(12, mods, inv_scale=scale, device="cpu")
    x = torch.randint(0, 1 << 62, (2, 4096), generator=torch.Generator().manual_seed(2)) % (2 * lt.q)
    assert torch.equal(FS.four_step_inverse(x, ft), NTT.ntt_inverse(x, lt))


def test_staged_key_switch_with_four_step_ntt_equals_plain():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(2048)
    parms.set_coeff_modulus(CoeffModulus.create(2048, [60, 40, 40, 60]))
    ctx = SealContext(parms, True, SecurityLevel.NONE, device="cpu")
    cd = ctx.first_context_data()
    plan = Evaluator(ctx)._plan(cd)
    sel = plan.sel_tables
    gen = torch.Generator().manual_seed(9)
    t_n = torch.randint(0, 1 << 62, (plan.D, 2048), generator=gen) % cd.limb_tables().q
    t_c = NTT.ntt_inverse(t_n, cd.limb_tables())
    key = torch.randint(0, 1 << 62, (2, plan.D, sel.q.shape[0], 2048), generator=gen) % sel.q
    want = switch_key_contract_plain(t_c, t_n, key, sel, plan.need_reduce)
    four_step = lambda x, t: FS.four_step_forward(x, four_step_tables_for(t))
    got = switch_key_contract_plain(t_c, t_n, key, sel, plan.need_reduce, ntt=four_step)
    assert torch.equal(got, want)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to test the
    dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("log_n, stage_launches, ntt_launches", [(15, 0, 1), (14, 0, 1), (16, 2, 0)])
@pytest.mark.parametrize("inverse", [False, True])
def test_dispatch_sends_large_n_on_card_to_stage_kernel(monkeypatch, log_n, stage_launches,
                                                        ntt_launches, inverse):
    calls = {"stage": 0, "ntt": 0}

    def fake_stage(x, name, ft, spec, twiddle=None):
        calls["stage"] += 1
        assert spec.M * spec.ncols == 1 << log_n
        return x.as_subclass(torch.Tensor).clone()

    def fake_ntt(x, t, inverse):
        calls["ntt"] += 1
        return x.as_subclass(torch.Tensor).clone()

    monkeypatch.setattr(NTT, "stage_cuda", fake_stage)
    monkeypatch.setattr(NTT, "ntt_cuda", fake_ntt)
    monkeypatch.setattr(NTT, "ntt_forward", lambda *a, **k: pytest.fail("fell back to the butterflies"))
    monkeypatch.setattr(NTT, "ntt_inverse", lambda *a, **k: pytest.fail("fell back to the butterflies"))
    t = build_limb_tables(log_n, [Modulus(CoeffModulus.create(1 << log_n, [40])[0].value)], device="cpu")
    x = torch.zeros((1, 1 << log_n), dtype=torch.int64).as_subclass(_OnCard)
    assert x.is_cuda
    (NTT.inverse if inverse else NTT.forward)(x, t)
    assert calls == {"stage": stage_launches, "ntt": ntt_launches}


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_on_card_sends_card_tensors_to_the_butterflies(monkeypatch, inverse):
    """Inside the switch a tensor on the card runs the butterflies; after it,
    and after an exception inside it, the kernels again."""
    fail = lambda *a, **k: pytest.fail("launched a kernel inside plain_on_card")
    monkeypatch.setattr(NTT, "stage_cuda", fail)
    monkeypatch.setattr(NTT, "ntt_cuda", fail)
    t = build_limb_tables(15, [Modulus(CoeffModulus.create(1 << 15, [40])[0].value)], device="cpu")
    x = torch.randint(0, 1 << 30, (1, 1 << 15), generator=torch.Generator().manual_seed(3))
    want = NTT.ntt_inverse(x, t) if inverse else NTT.ntt_forward(x, t)
    on_card = x.as_subclass(_OnCard)
    with NTT.plain_on_card():
        assert not NTT.use_kernels(on_card)
        got = (NTT.inverse if inverse else NTT.forward)(on_card, t)
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert NTT.use_kernels(on_card) and not NTT.use_kernels(x)
    with pytest.raises(RuntimeError), NTT.plain_on_card():
        raise RuntimeError
    assert NTT.use_kernels(on_card)


@pytest.mark.parametrize("cut", ["slice", "take"])
def test_cut_tables_select_the_whole_bundles_four_step_constants(cut):
    """A bundle cut from a context's tables takes its four-step constants
    from the whole bundle's, built once and kept by it; they equal the
    constants built for the cut's own moduli."""
    mods = CoeffModulus.create(4096, [60, 40, 50])
    whole = build_limb_tables(12, mods, inv_scale=[5, 7, 11], device="cpu")
    rows = [1, 2] if cut == "slice" else [2, 0]
    part = slice_limbs(whole, 1, 3) if cut == "slice" else take_limbs(whole, rows)
    ft = four_step_tables_for(part)
    assert four_step_tables_for(part) is ft
    assert whole.four_step.tables is four_step_tables_for(whole)
    want = build_four_step_tables(12, [mods[i] for i in rows], inv_scale=[[5, 7, 11][i] for i in rows],
                                  device="cpu")
    for name in ft._fields:
        a, b = getattr(ft, name), getattr(want, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name


def test_stage_wrapper_refuses_what_the_kernel_does_not_take():
    ft = build_four_step_tables(10, CoeffModulus.create(1024, [40]), n2=32, device="cpu")
    spec_a, _ = FS.forward_specs(ft)
    with pytest.raises(ValueError, match="CUDA"):
        stage_cuda(torch.zeros((1, 1024), dtype=torch.int64), "w", ft, spec_a)


def test_stage_refuses_an_unknown_transform():
    """The stage names a transform of the tables, of the stage's size."""
    ft = build_four_step_tables(10, CoeffModulus.create(1024, [40]), n2=16, device="cpu")
    spec_a, _ = FS.forward_specs(ft)
    with pytest.raises(ValueError, match="one of"):
        FS.stage_plain(torch.zeros((1, 1024), dtype=torch.int64), "t", ft, spec_a)
    with pytest.raises(ValueError, match="16-point"):
        FS.stage_plain(torch.zeros((1, 1024), dtype=torch.int64), "f", ft, spec_a)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one.  On the
card (where JAX is absent, so the suite's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The wire path's tests load Microsoft SEAL's blobs onto the card and serve a
serialized request there, against the bytes the CPU gives.  The other tests
check what the kernel wrappers refuse, and run anywhere.  Every comparison
is exact equality of reduced residues.
"""

import os

import numpy as np
import pytest
import torch

from seal_tpu_torch import (CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, GaloisKeys,
                            KeyGenerator, PRNGType, RelinKeys, SchemeType, SealContext, SecurityLevel,
                            UniformRandomGeneratorFactory)
from seal_tpu_torch import golden
from seal_tpu_torch import serialization as S
from seal_tpu_torch import valcheck
from seal_tpu_torch.convert import (ciphertext_from_numpy, galois_keys_from_numpy, plaintext_from_numpy,
                                    relin_keys_from_numpy, u64_from_numpy, u64_to_numpy)
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.modulus import Modulus
from seal_tpu_torch.ntt_tables import build_limb_tables, four_step_tables_for
from seal_tpu_torch.ops import four_step as FS
from seal_tpu_torch.ops import ntt as NTT
from seal_tpu_torch.ops import u64 as U64
from seal_tpu_torch.ops.cuda_four_step import stage_cuda
from seal_tpu_torch.ops.cuda_modarith import OPS as MODARITH_OPS
from seal_tpu_torch.ops.cuda_modarith import modarith_cuda
from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda, switch_key_contract_plain
from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse
from seal_tpu_torch.ops.rns import slice_limbs
from seal_tpu_torch.ops.cuda_corner_turn import corner_turn_cuda
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
from seal_tpu_torch.parallel.dist_ntt import DistNTT
from seal_tpu_torch.parallel.mesh import DeviceMesh
from seal_tpu_torch.parallel.remote_ntt import corner_turn_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", torch.cuda.current_device())


def _context(n, bits, device):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    return SealContext(parms, True, SecurityLevel.NONE, device=device)


def _uniform(shape, bound, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, 1 << 62, shape, dtype=torch.int64, device=device, generator=gen) % bound


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [2, 3, 4, 5, 6, 10, 13, 14, 15])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain(card, log_n, inverse):
    """Clusters of 2 (n = 4, 8), 4 (16, 32) and 8 blocks (n >= 64)."""
    mods = CoeffModulus.create(max(1 << log_n, 1024), [60, 50, 40])
    t = build_limb_tables(log_n, mods, device=card)
    x = _uniform((2, 3, 1 << log_n), t.q * (2 if inverse else 4), card, log_n)
    with NTT.plain_on_card():
        want = ntt_inverse(x, t) if inverse else ntt_forward(x, t)
    assert torch.equal(ntt_cuda(x, t, inverse), want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [10, 13, 14, 15])
@pytest.mark.parametrize("rows", [1, 2, 8, 80])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain_at_row_counts(card, log_n, rows, inverse):
    """One launch over 1, 2 and 8 rows (the main path's calls) and 80 (a
    batch of 8 requests, 2 polys, 5 limbs); the dispatch sends every size
    here to kernel A."""
    k = {1: 1, 2: 2, 8: 2, 80: 5}[rows]
    mods = CoeffModulus.create(1 << log_n, [60, 40, 40, 40, 60][:k])
    t = build_limb_tables(log_n, mods, device=card)
    x = _uniform((rows // k, k, 1 << log_n), t.q * (2 if inverse else 4), card, rows + log_n)
    with NTT.plain_on_card():
        want = ntt_inverse(x, t) if inverse else ntt_forward(x, t)
    before = ntt_cuda.launches
    got = (NTT.inverse if inverse else NTT.forward)(x, t)
    assert ntt_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
def test_switch_key_kernel_matches_plain(card, diag):
    ctx = _context(4096, [60, 40, 40, 60], card)
    cd = ctx.first_context_data()
    plan = Evaluator(ctx)._plan(cd)
    t = plan.sel_tables
    t_n = _uniform((plan.D, 4096), cd.limb_tables().q, card, 1)
    t_c = ntt_inverse(t_n, cd.limb_tables())
    key = _uniform((2, plan.D + 1, t.q.shape[0], 4096), t.q, card, 2)   # one extra key row
    t_n = t_n if diag else None
    with NTT.plain_on_card():
        want = switch_key_contract_plain(t_c, t_n, key, t, plan.need_reduce)
    assert torch.equal(switch_key_contract_cuda(t_c, t_n, key, t, plan.need_reduce), want)


def _medium_key_switch(card, level, B, lo, hi, diag, seed):
    """Inputs of kernel B on decomposition rows [lo, hi) of the N=32768
    default chain (golden.medium_context) at the given level: B ciphertexts,
    a key with one decomposition row more than the level has."""
    ctx = golden.medium_context(card)
    cd = ctx.first_context_data()
    for _ in range(level):
        cd = cd.next_context_data
    plan = Evaluator(ctx)._plan(cd)
    t = plan.sel_tables
    rows = build_limb_tables(15, cd.parms.coeff_modulus[lo:hi], device=card)
    t_n = _uniform((B, hi - lo, 32768), rows.q, card, seed)
    t_c = ntt_inverse(t_n, rows)
    key = _uniform((2, plan.D + 1, t.q.shape[0], 32768), t.q, card, seed + 1)[:, lo:hi]
    return t_c, (t_n if diag else None), key, t, plan.need_reduce[lo:hi]


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("level", [0, 1])
def test_switch_key_kernel_matches_plain_at_n32768(card, diag, level):
    """The default 128-bit chain at N=32768: D=15, Rn=16 at the first level
    (a thread owns 8 coefficients), D=14 under a key of 16 rows at the next."""
    t_c, t_n, key, t, need = _medium_key_switch(card, level, 1, 0, 15 - level, diag, 3 + level)
    before = switch_key_contract_cuda.launches
    got = switch_key_contract_cuda(t_c[0], None if t_n is None else t_n[0], key, t, need)
    assert switch_key_contract_cuda.launches == before + 1 and got.shape == (2, 16 - level, 32768)
    with NTT.plain_on_card():
        want = switch_key_contract_plain(t_c[0], None if t_n is None else t_n[0], key, t, need)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
def test_batched_switch_key_kernel_at_n32768_with_row_offset(card, diag):
    """Three ciphertexts in one launch on rows [4, 11) of the first level's
    decomposition (a limb rank's share; the diagonal at i == 4 + j)."""
    t_c, t_n, key, t, need = _medium_key_switch(card, 0, 3, 4, 11, diag, 9)
    got = switch_key_contract_cuda(t_c, t_n, key, t, need, row_offset=4)
    with NTT.plain_on_card():
        want = switch_key_contract_plain(t_c, t_n, key, t, need, row_offset=4)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [3, 4, 5, 6, 10, 11, 13, 14])
@pytest.mark.parametrize("diag", [False, True])
def test_switch_key_kernel_cluster_sizes(card, log_n, diag):
    """Clusters of 2 (n = 8), 4 (16, 32) and 8 blocks, from chunks smaller
    than a warp's coefficients to 512 threads of 4 coefficients (n=16384)."""
    mods = CoeffModulus.create(max(1 << log_n, 1024), [60, 40, 50, 60])
    ctx_t = build_limb_tables(log_n, mods, device=card)
    level = build_limb_tables(log_n, mods[:3], device=card)
    need = torch.tensor([[qj > qi for qi in ctx_t.q.flatten().tolist()] for qj in level.q.flatten().tolist()],
                        device=card)
    t_n = _uniform((3, 1 << log_n), level.q, card, log_n)
    t_c = ntt_inverse(t_n, level)
    key = _uniform((2, 3, 4, 1 << log_n), ctx_t.q, card, log_n + 1)
    t_n = t_n if diag else None
    got = switch_key_contract_cuda(t_c, t_n, key, ctx_t, need)
    with NTT.plain_on_card():
        want = switch_key_contract_plain(t_c, t_n, key, ctx_t, need)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [10, 13, 15])
def test_switch_key_kernel_barrett_guard(card, log_n):
    """D=66 > 64 at N=1024, 8192 and 32768: the u128 sums are reduced after
    64 summands inside the cluster's row loop (at N=32768 the key alone is
    2.3 GB, and the kernel's instantiation for D > 64 spills)."""
    n = 1 << log_n
    mods = CoeffModulus.create(n, [40] * 67)
    t = build_limb_tables(log_n, mods, device=card)
    level = build_limb_tables(log_n, mods[:66], device=card)
    qs = t.q.flatten().tolist()
    need = torch.tensor([[qj > qi for qi in qs] for qj in qs[:66]], device=card)
    t_n = _uniform((66, n), level.q, card, 5)
    t_c = ntt_inverse(t_n, level)
    key = _uniform((2, 66, 67, n), t.q, card, 6)
    got = switch_key_contract_cuda(t_c, t_n, key, t, need)
    with NTT.plain_on_card():
        want = switch_key_contract_plain(t_c, t_n, key, t, need)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_medium_slice_on_card_gives_medium_digest(card):
    """The N=32768 request on the default chain: one launch of kernel B,
    none of the stage kernel, the JAX package's digest."""
    ctx = golden.medium_context(card)
    d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, card)
    a = ciphertext_from_numpy(d1, ctx.first_parms_id, True, 2.0 ** 40, card)
    b = ciphertext_from_numpy(d2, ctx.first_parms_id, True, 2.0 ** 40, card)
    ev = Evaluator(ctx)
    before = (stage_cuda.launches, switch_key_contract_cuda.launches)
    out = ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk))
    after = (stage_cuda.launches, switch_key_contract_cuda.launches)
    assert golden.digest(u64_to_numpy(out.data)) == golden.MEDIUM_DIGEST
    assert [y - x for x, y in zip(before, after)] == [0, 1]


def _linear_setup(ctx, device, requests):
    ct, pt, g, r = golden.linear_inputs(ctx)
    n = ctx.first_context_data().parms.poly_modulus_degree
    keys = [None] * n
    keys[golden.LINEAR_GALOIS_ELT >> 1] = g
    S = golden.LINEAR_SCALE
    cts = [ciphertext_from_numpy(golden.linear_inputs(ctx, i)[0] if i else ct, ctx.first_parms_id, True, S, device)
           for i in range(requests)]
    return (cts, plaintext_from_numpy(pt, ctx.first_parms_id, S, device),
            galois_keys_from_numpy(keys, ctx.key_parms_id, device), relin_keys_from_numpy([r], ctx.key_parms_id, device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 32768])
def test_rotations_on_card_match_plain(card, n):
    """rotate_vector(1) through kernel B, one ciphertext, a batch of 4 and
    one after mod_switch_to_next (the key trimmed to the level's rows), equal
    to the plain path on the card: one launch of kernel B each."""
    ctx = _context(n, list(golden.GOLDEN_BITS), card) if n == 8192 else golden.medium_context(card)
    cts, _, gk, _ = _linear_setup(ctx, card, 4)
    ev, bev = Evaluator(ctx), BatchEvaluator(ctx)

    def rotations():
        return (ev.rotate_vector(cts[0], 1, gk).data,
                bev.rotate_vector(CiphertextBatch.from_ciphertexts(cts), 1, gk).data,
                ev.rotate_vector(ev.mod_switch_to_next(cts[1]), 1, gk).data)

    before = switch_key_contract_cuda.launches
    got = rotations()
    assert switch_key_contract_cuda.launches == before + 3
    with NTT.plain_on_card():
        want = rotations()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1][0], got[0])


@pytest.mark.cuda
def test_linear_step_on_card_gives_linear_digest(card):
    """The N=32768 linear-layer step: two launches of kernel B, none of the
    stage kernel, the JAX package's digest."""
    ctx = golden.medium_context(card)
    cts, pt, gk, rk = _linear_setup(ctx, card, 1)
    before = (stage_cuda.launches, switch_key_contract_cuda.launches)
    out = golden.linear_layer_step(Evaluator(ctx), cts[0], pt, gk, rk)
    after = (stage_cuda.launches, switch_key_contract_cuda.launches)
    assert golden.digest(u64_to_numpy(out.data)) == golden.LINEAR_DIGEST
    assert [y - x for x, y in zip(before, after)] == [0, 2]


@pytest.mark.cuda
def test_slice_on_card_gives_golden_digest(card):
    ctx = _context(golden.GOLDEN_N, list(golden.GOLDEN_BITS), card)
    d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    kc0, kc1 = golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)
    rk = relin_keys_from_numpy([(kc0, kc1)], ctx.key_parms_id, card)
    a = ciphertext_from_numpy(d1, ctx.first_parms_id, True, 2.0 ** 40, card)
    b = ciphertext_from_numpy(d2, ctx.first_parms_id, True, 2.0 ** 40, card)
    ev = Evaluator(ctx)
    out = ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk))
    assert golden.digest(u64_to_numpy(out.data)) == golden.GOLDEN_DIGEST


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [15, 16, 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_kernel_matches_plain(card, log_n, inverse):
    """Both stages of a transform at N=32768 (256/128), 65536 (512/128)
    and 131072 (512/256), then the whole transform against the butterflies."""
    mods = CoeffModulus.create(1 << log_n, [60, 40, 60])
    t = build_limb_tables(log_n, mods, device=card)
    ft = four_step_tables_for(t)
    x = _uniform((2, 3, 1 << log_n), t.q * (2 if inverse else 4), card, log_n)
    specs = FS.inverse_specs(ft) if inverse else FS.forward_specs(ft)
    names = ("finv", "winv") if inverse else ("w", "f")
    tws = ((ft.twi_op, ft.twi_qt) if inverse else (ft.tw_op, ft.tw_qt), None)
    h = x
    for spec, name, tw in zip(specs, names, tws):
        got = stage_cuda(h, name, ft, spec, tw)
        with NTT.plain_on_card():
            want = FS.stage_plain(h, name, ft, spec, tw)
        assert torch.equal(got, want)
        h = got
    with NTT.plain_on_card():
        want = ntt_inverse(x, t) if inverse else ntt_forward(x, t)
    assert torch.equal(h, want)
    assert torch.equal((NTT.inverse if inverse else NTT.forward)(x, t), want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [15, 16, 17])
@pytest.mark.parametrize("rows", [1, 2, 6, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_kernel_matches_plain_at_row_counts(card, log_n, rows, inverse):
    """Both stages of every default split (256/128, 512/128, 512/256), with
    and without the twiddle, over the row counts of the N=65536 request's
    calls; the first stage's input lazy (below 4q)."""
    k = {1: 1, 2: 2, 6: 3, 12: 4}[rows]
    mods = CoeffModulus.create(1 << log_n, [60, 40, 40, 60][:k])
    ft = four_step_tables_for(build_limb_tables(log_n, mods, device=card))
    x = _uniform((rows // k, k, 1 << log_n), ft.q * 4, card, rows + log_n)
    specs = FS.inverse_specs(ft) if inverse else FS.forward_specs(ft)
    names = ("finv", "winv") if inverse else ("w", "f")
    tw = (ft.twi_op, ft.twi_qt) if inverse else (ft.tw_op, ft.tw_qt)
    for spec, name in zip(specs, names):
        for twiddle in (tw, None):
            with NTT.plain_on_card():
                want = FS.stage_plain(x, name, ft, spec, twiddle)
            assert torch.equal(stage_cuda(x, name, ft, spec, twiddle), want)


@pytest.mark.cuda
def test_large_slice_on_card_runs_the_stage_kernel(card):
    ctx = _context(golden.LARGE_N, list(golden.LARGE_BITS), card)
    d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, card)
    a = ciphertext_from_numpy(d1, ctx.first_parms_id, True, 2.0 ** 40, card)
    b = ciphertext_from_numpy(d2, ctx.first_parms_id, True, 2.0 ** 40, card)
    ev = Evaluator(ctx)
    before = (stage_cuda.launches, ntt_cuda.launches, switch_key_contract_cuda.launches)
    out = ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk))
    after = (stage_cuda.launches, ntt_cuda.launches, switch_key_contract_cuda.launches)
    assert golden.digest(u64_to_numpy(out.data)) == golden.LARGE_DIGEST
    assert [y - x for x, y in zip(before, after)] == [12, 0, 0]


def test_ntt_wrapper_refuses_what_the_kernel_does_not_take():
    t = build_limb_tables(4, [Modulus(97)], device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda(torch.zeros((1, 16), dtype=torch.int64), t, inverse=False)


def test_ntt_wrapper_refuses_n_beyond_shared_memory():
    """Kernel A spreads a row over a cluster up to n = 32768, the JAX
    package's fused range; larger rows go to the stage kernel."""
    t = build_limb_tables(16, [Modulus(786433)], device="cpu")
    with pytest.raises(ValueError, match="n <= 32768"):
        ntt_cuda(torch.zeros((1, 1 << 16), dtype=torch.int64), t, inverse=True)


def _corner_case(P, k, r, c, devices, transposed, seed):
    """Sources and two sets of destinations for a corner turn over ranks on
    ``devices``; with ``transposed``, the views the inverse transform uses."""
    srcs, dsts, want = [], [], []
    for m in range(P):
        dev = devices[m]
        if transposed:
            srcs.append(_uniform((k, r, P, c), 1 << 60, dev, seed + m).transpose(1, 2))
            dsts.append(torch.empty((k, P, r, c), dtype=torch.int64, device=dev).transpose(1, 2))
            want.append(torch.empty((k, P, r, c), dtype=torch.int64, device=dev).transpose(1, 2))
        else:
            srcs.append(_uniform((k, P, r, c), 1 << 60, dev, seed + m))
            dsts.append(torch.empty((k, r, P, c), dtype=torch.int64, device=dev))
            want.append(torch.empty((k, r, P, c), dtype=torch.int64, device=dev))
    return srcs, dsts, want


@pytest.mark.cuda
@pytest.mark.parametrize("P, k, r, c", [(8, 4, 64, 16), (8, 2, 8, 16), (2, 3, 1, 5), (2, 1, 1, 16)])
@pytest.mark.parametrize("transposed", [False, True])
def test_corner_turn_kernel_matches_plain(card, P, k, r, c, transposed):
    """Every rank on one card: one launch; N=65536's and N=8192's shapes at
    P=8, and odd ones (c odd takes the 8-byte loop)."""
    srcs, dsts, want = _corner_case(P, k, r, c, [card] * P, transposed, P + c)
    before = corner_turn_cuda.launches
    corner_turn_cuda(srcs, dsts)
    assert corner_turn_cuda.launches == before + 1
    corner_turn_plain(srcs, want)
    assert all(torch.equal(a, b) for a, b in zip(dsts, want))


@pytest.mark.cuda
def test_corner_turn_across_two_cards(card):
    """Ranks alternating between two cards: peer access, one launch per
    card, and the distributed NTT equal to the single-card transform.  The
    one-card machine the smoke run uses leaves this unrun."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    devices = [torch.device("cuda", m % 2) for m in range(4)]
    srcs, dsts, want = _corner_case(4, 2, 16, 16, devices, False, 7)
    before = corner_turn_cuda.launches
    corner_turn_cuda(srcs, dsts)
    assert corner_turn_cuda.launches == before + 2
    corner_turn_plain(srcs, want)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert all(torch.equal(a, b) for a, b in zip(dsts, want))
    mods = CoeffModulus.create(8192, [60, 40])
    t = build_limb_tables(13, mods, device=card)
    dist = DistNTT(four_step_tables_for(t), DeviceMesh(devices, ("limb",)))
    x = _uniform((2, 8192), t.q * 4, card, 3)
    assert torch.equal(dist.forward(x), NTT.forward(x, t))


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("rows", [(0, 3), (1, 3)])
def test_batched_switch_key_kernel_matches_single_launches(card, diag, rows):
    """B=3 ciphertexts in one launch against three launches, on all the
    decomposition rows and on rows [1, 3) of a sliced key (a limb rank's
    share; the diagonal then sits at i == 1 + j)."""
    ctx = _context(4096, [60, 40, 40, 60], card)
    cd = ctx.first_context_data()
    plan = Evaluator(ctx)._plan(cd)
    t = plan.sel_tables
    lo, hi = rows
    level = build_limb_tables(12, cd.parms.coeff_modulus[lo:hi], device=card)
    t_n = _uniform((3, hi - lo, 4096), level.q, card, 1)
    t_c = ntt_inverse(t_n, level)
    key = _uniform((2, plan.D + 1, t.q.shape[0], 4096), t.q, card, 2)[:, lo:hi]
    t_n = t_n if diag else None
    need = plan.need_reduce[lo:hi]
    before = switch_key_contract_cuda.launches
    got = switch_key_contract_cuda(t_c, t_n, key, t, need, row_offset=lo)
    assert switch_key_contract_cuda.launches == before + 1 and got.shape == (3, 2, t.q.shape[0], 4096)
    for b in range(3):
        one = switch_key_contract_cuda(t_c[b], None if t_n is None else t_n[b], key, t, need, row_offset=lo)
        assert torch.equal(got[b], one)
    with NTT.plain_on_card():
        want = switch_key_contract_plain(t_c, t_n, key, t, need, row_offset=lo)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [13, 16])
@pytest.mark.parametrize("P", [2, 8])
def test_stage_kernel_on_rank_shards(card, log_n, P):
    """The distributed NTT's stages over P ranks: column shards of n2/P
    (16 columns at P=8) and row shards of n1/P (8 rows at N=8192, 64 at
    N=65536, P=8), against the plain stage and the single-card transform."""
    mods = CoeffModulus.create(1 << log_n, [60, 40, 40, 60])
    t = build_limb_tables(log_n, mods, device=card)
    ft = four_step_tables_for(t)
    dist = DistNTT(ft, DeviceMesh([card] * P, ("limb",)))
    assert dist.cols == ft.n2 // P and dist.rows == ft.n1 // P
    x = _uniform((4, 1 << log_n), t.q * 4, card, log_n)
    for m, col in enumerate(dist.split_columns(x)):
        for name, tw in (("w", dist.tw[m]), ("winv", None)):
            args = (col, name, dist.tables[m], dist.spec_cols, tw)
            with NTT.plain_on_card():
                want = FS.stage_plain(*args)
            assert torch.equal(stage_cuda(*args), want)
    for m, row in enumerate(dist.split_rows(x)):
        for name, tw in (("finv", dist.twi[m]), ("f", None)):
            args = (row, name, dist.tables[m], dist.spec_rows, tw)
            with NTT.plain_on_card():
                want = FS.stage_plain(*args)
            assert torch.equal(stage_cuda(*args), want)
    before = corner_turn_cuda.launches
    fwd = dist.forward(x)
    assert torch.equal(fwd, NTT.forward(x, t))
    assert torch.equal(dist.inverse(fwd), torch.where(x >= 2 * t.q, x - 2 * t.q, x) % t.q)
    assert corner_turn_cuda.launches == before + 2


@pytest.mark.cuda
def test_dryrun_on_one_card(card):
    from seal_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(8, devices=[card] * 8)


def test_corner_turn_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 2, 1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        corner_turn_cuda([x, x], [torch.zeros((1, 1, 2, 4), dtype=torch.int64)] * 2)


# -- BFV (golden.bfv_context: bfv_default(n), t = PlainModulus.batching(n, 20)) --

@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 32768])
def test_ntt_kernel_matches_plain_on_the_behz_tables(card, n):
    """The BFV multiply's two transforms over q U Bsk (the t-scaled inverse
    included) at a request's shapes and a batch of 4's, and the key-switch
    tail's inverse NTTs."""
    ctx = golden.bfv_context(n, card)
    cd = ctx.first_context_data()
    t = cd.behz_limb_tables()
    rows = t.q.shape[0]
    key_t = ctx.key_context_data().limb_tables()
    k = len(cd.coeff_modulus_values)
    cases = [(t, (4, rows, n), False), (t, (3, rows, n), True), (t, (4, 4, rows, n), False),
             (t, (4, 3, rows, n), True), (slice_limbs(key_t, k, k + 1), (2, 1, n), True),
             (slice_limbs(key_t, 0, k), (2, k, n), True)]
    for i, (tab, shape, inverse) in enumerate(cases):
        x = _uniform(shape, tab.q * (2 if inverse else 4), card, i)
        with NTT.plain_on_card():
            want = ntt_inverse(x, tab) if inverse else ntt_forward(x, tab)
        assert torch.equal(ntt_cuda(x, tab, inverse), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 32768])
def test_switch_key_kernel_without_diagonal_at_bfv_shapes(card, n):
    """BFV's relinearization: a coefficient-form target, no diagonal (D=4,
    Rn=5 at N=8192; D=15, Rn=16 at N=32768), one ciphertext and a batch of 4."""
    ctx = golden.bfv_context(n, card)
    cd = ctx.first_context_data()
    plan = Evaluator(ctx)._plan(cd)
    D, sel = plan.D, plan.sel_tables
    assert (D, sel.q.shape[0]) == ((4, 5) if n == 8192 else (15, 16))
    key = _uniform((2, D, D + 1, n), sel.q, card, 1)
    for shape in ((D, n), (4, D, n)):
        t_c = _uniform(shape, cd.limb_tables().q, card, len(shape))
        got = switch_key_contract_cuda(t_c, None, key, sel, plan.need_reduce)
        with NTT.plain_on_card():
            want = switch_key_contract_plain(t_c, None, key, sel, plan.need_reduce)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 32768])
def test_bfv_request_on_card_gives_bfv_digest(card, n):
    """build_bfv_mult_relin through the kernels: the JAX package's digest,
    equal to the plain path on the card, 4 launches of kernel A and 1 of
    kernel B, none of the stage kernel; a batch of 2 through
    BatchEvaluator equal to the single requests, with 1 launch of B."""
    from seal_tpu_torch.pipeline import build_bfv_mult_relin

    ctx = golden.bfv_context(n, card)
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, card)
    key = rk.key(2)
    pairs = [golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r) for r in range(2)]
    cts = [[ciphertext_from_numpy(d, ctx.first_parms_id, False, 1.0, card) for d in pair] for pair in pairs]
    fn = build_bfv_mult_relin(ctx)
    before = (ntt_cuda.launches, switch_key_contract_cuda.launches, stage_cuda.launches)
    out = fn(cts[0][0].data, cts[0][1].data, key["c0"], key["c1"])
    after = (ntt_cuda.launches, switch_key_contract_cuda.launches, stage_cuda.launches)
    assert [y - x for x, y in zip(before, after)] == [4, 1, 0]
    assert golden.digest(u64_to_numpy(out)) == (golden.BFV_DIGEST if n == 8192 else golden.BFV_MEDIUM_DIGEST)
    with NTT.plain_on_card():
        assert torch.equal(fn(cts[0][0].data, cts[0][1].data, key["c0"], key["c1"]), out)
    ev, bev = Evaluator(ctx), BatchEvaluator(ctx)
    singles = [ev.relinearize(ev.multiply(a, b), rk).data for a, b in cts]
    assert torch.equal(singles[0], out)
    before = switch_key_contract_cuda.launches
    batch = bev.relinearize(bev.multiply(CiphertextBatch.from_ciphertexts([a for a, _ in cts]),
                                         CiphertextBatch.from_ciphertexts([b for _, b in cts])), rk)
    assert switch_key_contract_cuda.launches == before + 1
    for r in range(2):
        assert torch.equal(batch.data[r], singles[r])


# -- BGV (golden.bgv_context: BFV's chain and t as a BGV context) ---------------

def _bgv_request_inputs(ctx, device, requests):
    n = ctx.first_context_data().parms.poly_modulus_degree
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, device)
    galois = [None] * n
    galois[golden.BGV_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.BGV_GALOIS_SEED)
    gk = galois_keys_from_numpy(galois, ctx.key_parms_id, device)
    cts = [[ciphertext_from_numpy(d, ctx.first_parms_id, True, 1.0, device)
            for d in golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)] for r in range(requests)]
    return cts, rk, gk


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 32768])
def test_ntt_kernel_matches_plain_at_bgv_shapes(card, n):
    """The reduced transforms BGV adds: the key-switch tail's inverse of the
    (2, 1, n) special-prime rows and forward of the (2, D, n) correction,
    and the mod-t switch's (2, 1, n) inverse and (2, k - 1, n) forward; one
    request's shapes and a batch of 4's."""
    ctx = golden.bgv_context(n, card)
    cd = ctx.first_context_data()
    first_t, key_t = cd.limb_tables(), ctx.key_context_data().limb_tables()
    k = len(cd.coeff_modulus_values)
    cases = [(slice_limbs(key_t, k, k + 1), (2, 1, n), True), (slice_limbs(key_t, 0, k), (2, k, n), False),
             (slice_limbs(first_t, k - 1, k), (2, 1, n), True), (slice_limbs(first_t, 0, k - 1), (2, k - 1, n), False)]
    cases += [(tab, (4, *shape), inverse) for tab, shape, inverse in cases]
    for i, (tab, shape, inverse) in enumerate(cases):
        x = _uniform(shape, tab.q * (2 if inverse else 4), card, i)
        with NTT.plain_on_card():
            want = ntt_inverse(x, tab) if inverse else ntt_forward(x, tab)
        assert torch.equal(ntt_cuda(x, tab, inverse), want)


@pytest.mark.cuda
def test_bgv_request_on_card_gives_bgv_digest(card):
    """golden.bgv_request at N=8192 through the kernels: the JAX package's
    digest and correction factor, equal to the plain path on the card, 8
    launches of kernel A and 2 of kernel B, none of the stage kernel; a
    batch of 2 through BatchEvaluator equal to the single requests, with the
    same launches."""
    ctx = golden.bgv_context(golden.BGV_N, card)
    cts, rk, gk = _bgv_request_inputs(ctx, card, 2)
    ev, bev = Evaluator(ctx), BatchEvaluator(ctx)
    counters = lambda: (ntt_cuda.launches, switch_key_contract_cuda.launches, stage_cuda.launches)
    before = counters()
    out = golden.bgv_request(ev, *cts[0], rk, gk)
    assert [y - x for x, y in zip(before, counters())] == [8, 2, 0]
    assert golden.digest(u64_to_numpy(out.data)) == golden.BGV_DIGEST
    assert out.correction_factor == golden.BGV_CORRECTION_FACTOR
    with NTT.plain_on_card():
        assert torch.equal(golden.bgv_request(ev, *cts[0], rk, gk).data, out.data)
    singles = [golden.bgv_request(ev, a, b, rk, gk) for a, b in cts]
    before = counters()
    batch = golden.bgv_request(bev, CiphertextBatch.from_ciphertexts([a for a, _ in cts]),
                               CiphertextBatch.from_ciphertexts([b for _, b in cts]), rk, gk)
    assert [y - x for x, y in zip(before, counters())] == [8, 2, 0]
    assert batch.correction_factor == golden.BGV_CORRECTION_FACTOR
    for r in range(2):
        assert torch.equal(batch.data[r], singles[r].data)


# -- the wire path ------------------------------------------------------------------------

WIRE = os.path.join(os.path.dirname(__file__), "data", "wire")
WIRE_SEED = tuple(0x1111111111111111 * (i + 1) for i in range(8))


def _wire_blob(name):
    with open(os.path.join(WIRE, name), "rb") as f:
        return f.read()


def _wire_context(name, device):
    parms, _ = S.params_load(_wire_blob(f"{name}_parms.bin"))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, WIRE_SEED))
    return SealContext(parms, True, SecurityLevel.NONE, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_wire_blobs_load_onto_the_card(card, scheme):
    """Microsoft SEAL's secret key, public key and ciphertexts (full and
    seeded) load onto the card, pass valcheck and decrypt to the manifest's
    plaintext."""
    ctx = _wire_context(scheme, card)
    sk, _ = S.secret_key_load(_wire_blob(f"{scheme}_sk.bin"), ctx)
    pk, _ = S.public_key_load(_wire_blob(f"{scheme}_pk.bin"), ctx)
    assert sk.data.is_cuda and pk.data.data.is_cuda
    with open(os.path.join(WIRE, "manifest.txt")) as f:
        want = dict(line.strip().split(" ", 1) for line in f if "_hex" in line)[f"{scheme}_pt_hex"]
    for name in (f"{scheme}_ct.bin", f"{scheme}_ct_seeded.bin"):
        ct, _ = S.ciphertext_load(_wire_blob(name), ctx)
        assert ct.data.is_cuda and valcheck.is_valid_for(ct, ctx)
        assert Decryptor(ctx, sk).decrypt(ct).to_string() == want


def _wire_request(n):
    """A CKKS client on the CPU: request bytes (parameters, seeded relin and
    Galois keys, a plaintext, two seeded ciphertexts), and its secret key."""
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, (5, 6, 7, 8, 9, 10, 11, 12)))
    ctx = SealContext(parms, True, SecurityLevel.TC128, device="cpu")
    kg = KeyGenerator(ctx)
    enc = CKKSEncoder(ctx)
    rng = np.random.default_rng(3)
    sym = Encryptor(ctx, secret_key=kg.secret_key)
    cts = [sym.encrypt_symmetric(enc.encode(rng.uniform(-1, 1, n // 2), golden.LINEAR_SCALE), save_seed=True)
           for _ in range(2)]
    return {"params": S.params_save(parms), "rk": S.kswitch_keys_save(kg.create_relin_keys(save_seed=True), ctx),
            "gk": S.kswitch_keys_save(kg.create_galois_keys_from_steps([1], save_seed=True), ctx),
            "pt": S.plaintext_save(enc.encode(rng.uniform(-1, 1, n // 2), golden.LINEAR_SCALE)),
            "cts": [S.ciphertext_save(c) for c in cts]}, kg.secret_key


def _wire_serve(request, device):
    ctx = SealContext(S.params_load(request["params"])[0], True, SecurityLevel.TC128, device=device)
    rk, _ = S.kswitch_keys_load(request["rk"], ctx, RelinKeys)
    gk, _ = S.kswitch_keys_load(request["gk"], ctx, GaloisKeys)
    pt, _ = S.plaintext_load(request["pt"], ctx)
    cts = [S.ciphertext_load(b, ctx)[0] for b in request["cts"]]
    assert all(c.data.device.type == torch.device(device).type and valcheck.is_valid_for(c, ctx) for c in cts)
    ev = Evaluator(ctx)
    return [S.ciphertext_save(golden.linear_layer_step(ev, c, pt, gk, rk), S.COMPR_NONE) for c in cts], ctx


@pytest.mark.cuda
def test_wire_request_on_the_card_gives_the_cpu_bytes(card):
    """load -> serve (the linear-layer step at N=8192) -> save on the card
    gives the CPU's reply bytes; decrypt_batch of the replies on the card
    equals decrypt of each."""
    request, sk = _wire_request(8192)
    cpu_replies, _ = _wire_serve(request, "cpu")
    card_replies, ctx = _wire_serve(request, card)
    assert card_replies == cpu_replies
    sk_card, _ = S.secret_key_load(S.secret_key_save(sk), ctx)
    dec = Decryptor(ctx, sk_card)
    replies = [S.ciphertext_load(r, ctx)[0] for r in card_replies]
    batch = dec.decrypt_batch(CiphertextBatch.from_ciphertexts(replies))
    for one, plain in zip(replies, batch):
        assert torch.equal(dec.decrypt(one).rns_data, plain.rns_data)


# -- kernels C and D: the BLAKE2xb stream and the samplers ------------------------------

def _stream_seeds(S, device, seed=10):
    words = np.random.default_rng(seed).integers(0, 1 << 64, size=(S, 8), dtype=np.uint64)
    return torch.from_numpy(words.view(np.int64)).to(device)


def _prime_near(x, two_n):
    from seal_tpu_torch import numth
    c = x - (x % two_n) + 1
    while not numth.is_prime(c):
        c -= two_n
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("S, nwords", [(1, 1), (3, 511), (3, 513), (2, 1500), (15, 16 * 32768 + 16 * 128)])
def test_blake2xb_kernel_matches_plain_and_the_host_stream(card, S, nwords):
    from seal_tpu_torch.ops import blake2_dev as B
    from seal_tpu_torch.ops.cuda_blake2 import expand_stream_words_cuda
    from seal_tpu_torch.random.prng import Blake2xbPRNG
    seeds = _stream_seeds(S, card)
    before = expand_stream_words_cuda.launches
    got = expand_stream_words_cuda(seeds, nwords)
    torch.cuda.synchronize()
    assert expand_stream_words_cuda.launches == before + 1
    assert torch.equal(got, B.expand_stream_words_plain(seeds, nwords))
    host = seeds.cpu().numpy().view(np.uint64)
    for i in range(min(S, 3)):
        want = np.frombuffer(Blake2xbPRNG(tuple(int(w) for w in host[i])).generate(8 * nwords), dtype="<u8")
        np.testing.assert_array_equal(u64_to_numpy(got[i]), want)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["high_rejection", "bfv_default(32768)"])
def test_sample_kernel_matches_plain(card, chain):
    """Kernel D's two entry points against their plain versions: at 62-bit
    moduli that reject one word in 16 (counts non-zero, then the fix-up on
    the card against the host sampler), and over the N=32768 key level of
    the default chain with D=15 streams."""
    from seal_tpu_torch.ops import blake2_dev as B
    from seal_tpu_torch.ops.cuda_blake2 import cbd_lifted_cuda, uniform_bulk_cuda
    from seal_tpu_torch.random.prng import Blake2xbPRNG
    from seal_tpu_torch.random.sampler import sample_poly_uniform
    if chain == "high_rejection":
        n, S = 512, 3
        moduli = (_prime_near(3 << 60, 2 * n), _prime_near((3 << 60) - (1 << 55), 2 * n))
    else:
        n, S = 32768, 15
        moduli = tuple(m.value for m in CoeffModulus.bfv_default(n)) + (_prime_near(1 << 60, 2 * n),)
    seeds = _stream_seeds(S, card, 11)
    words = B.expand_stream_words(seeds, len(moduli) * n + B.uniform_tail_words(n, moduli)[1])
    q, mm, rhi = B.uniform_constants(moduli, card)
    before = (uniform_bulk_cuda.launches, cbd_lifted_cuda.launches)
    vals, counts = uniform_bulk_cuda(words, n, q, mm, rhi)
    noise = cbd_lifted_cuda(words, n, q, 67)
    torch.cuda.synchronize()
    assert (uniform_bulk_cuda.launches, cbd_lifted_cuda.launches) == (before[0] + 1, before[1] + 1)
    with NTT.plain_on_card():
        want_vals, want_counts = B.uniform_bulk_plain(words, n, moduli)
        want_noise = B.cbd_lifted_plain(words, n, moduli, 67)
    assert torch.equal(vals, want_vals) and torch.equal(counts, want_counts)
    assert bool((counts > 0).all()) == (chain == "high_rejection")
    assert torch.equal(noise, want_noise)
    if chain == "high_rejection":
        got, overflow = B.uniform_from_seed_words(seeds, n, moduli)
        torch.cuda.synchronize()
        assert not overflow.any()
        host = seeds.cpu().numpy().view(np.uint64)
        for i in range(S):
            want = sample_poly_uniform(Blake2xbPRNG(tuple(int(w) for w in host[i])), n, moduli)
            np.testing.assert_array_equal(u64_to_numpy(got[i]), want)


class _FreshSeeds(UniformRandomGeneratorFactory):
    """A BLAKE2XB factory whose create() draws a new seed at each call from
    seeded numpy; restart() replays the draws."""

    def __init__(self, seed):
        super().__init__(PRNGType.BLAKE2XB)
        self.seed = seed
        self.restart()

    def restart(self):
        self.rng = np.random.default_rng(self.seed)

    def create(self, seed=None):
        if seed is None:
            seed = tuple(int(w) for w in self.rng.integers(0, 1 << 64, size=8, dtype=np.uint64))
        return super().create(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", [SchemeType.CKKS, SchemeType.BFV, SchemeType.BGV])
def test_device_sampled_keys_on_card_equal_the_host_path(card, scheme, monkeypatch):
    """Keygen and symmetric encryption at N=8192 through kernels C and D
    (two launches of C and one of each of D's entry points per key and per
    encryption), equal to the host-sampled path on the card, with a factory
    that hands out a distinct seed per draw (replayed for each path), so
    that each of the key's rows comes from its own stream."""
    from seal_tpu_torch import PlainModulus, rlwe
    from seal_tpu_torch.ops.cuda_blake2 import cbd_lifted_cuda, expand_stream_words_cuda, uniform_bulk_cuda
    parms = EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(8192)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(8192))
    if scheme != SchemeType.CKKS:
        parms.set_plain_modulus(PlainModulus.batching(8192, 20))
    factory = _FreshSeeds(9)
    parms.set_random_generator(factory)
    ctx = SealContext(parms, True, SecurityLevel.TC128, device=card)
    kg = KeyGenerator(ctx)

    def client():
        factory.restart()
        rk = kg.create_relin_keys(save_seed=True).keys[0]
        ct = Encryptor(ctx, secret_key=kg.secret_key).encrypt_zero_symmetric(save_seed=True)
        return rk, ct

    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
    want_rk, want_ct = client()
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "1")
    counters = (expand_stream_words_cuda, uniform_bulk_cuda, cbd_lifted_cuda)
    before = [f.launches for f in counters] + [rlwe.host_fallbacks]
    rk, ct = client()
    torch.cuda.synchronize()
    assert [f.launches for f in counters] + [rlwe.host_fallbacks] == [before[0] + 4, before[1] + 2,
                                                                      before[2] + 2, before[3]]
    assert torch.equal(rk["c0"], want_rk["c0"]) and torch.equal(rk["c1"], want_rk["c1"])
    assert rk["seeds"] == want_rk["seeds"] and len(set(s.seed for s in rk["seeds"])) == rk["c1"].shape[0]
    assert torch.equal(ct.data, want_ct.data) and ct.seed_info == want_ct.seed_info


def test_blake2_wrappers_refuse_what_the_kernels_do_not_take():
    from seal_tpu_torch.ops.cuda_blake2 import cbd_lifted_cuda, expand_stream_words_cuda, uniform_bulk_cuda
    q = torch.tensor([97], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        expand_stream_words_cuda(torch.zeros((1, 8), dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="CUDA"):
        uniform_bulk_cuda(torch.zeros((1, 16), dtype=torch.int64), 8, q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        cbd_lifted_cuda(torch.zeros((1, 16), dtype=torch.int64), 8, q, 0)
    with pytest.raises(ValueError, match="stream words"):
        uniform_bulk_cuda(torch.zeros((1, 16), dtype=torch.int32), 8, q, q, q)


# -- BFV and BGV on a mesh, debug mode and the event timers (the tooling) --

def _mesh_request_inputs(ctx, n, requests, ntt):
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, ctx.device)
    galois = [None] * n
    galois[golden.BGV_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.BGV_GALOIS_SEED)
    gk = galois_keys_from_numpy(galois, ctx.key_parms_id, ctx.device)
    cts = [tuple(ciphertext_from_numpy(d, ctx.first_parms_id, ntt, 1.0, ctx.device)
                 for d in golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)) for r in range(requests)]
    return rk, gk, [CiphertextBatch.from_ciphertexts([c[i] for c in cts]) for i in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
@pytest.mark.parametrize("mesh", [dict(limb_parallel=2), dict(limb_parallel=2, hosts=2, replicate_keys=True)])
def test_bfv_bgv_mesh_bodies_on_the_card_match_one_device(card, scheme, mesh):
    """multiply -> relinearize -> rotate_rows(1) -> mod_switch_to_next of 8
    N=8192 requests on 8 ranks of the card, equal to the batch on one
    device; BGV's correction factor too."""
    from seal_tpu_torch.parallel.mesh import make_mesh

    n = 8192
    ctx = (golden.bfv_context if scheme == "BFV" else golden.bgv_context)(n, card)
    rk, gk, (b1, b2) = _mesh_request_inputs(ctx, n, 8, scheme == "BGV")
    bev = BatchEvaluator(ctx, make_mesh(8, devices=[card] * 8, **mesh))
    got = golden.bgv_request(bev, bev.shard(b1), bev.shard(b2), rk, gk).unshard()
    want = golden.bgv_request(BatchEvaluator(ctx), b1, b2, rk, gk)
    assert torch.equal(got.data, want.data) and got.correction_factor == want.correction_factor


@pytest.mark.cuda
def test_debug_mode_on_the_card(card, monkeypatch):
    """SEAL_TPU_DEBUG=1 around kernels A and B: a CKKS and a BFV request
    pass every range check and give the outputs of the run without it; an
    NTT operand at 4q raises before kernel A launches."""
    from seal_tpu_torch import debug
    from seal_tpu_torch.pipeline import build_bfv_mult_relin

    ctx = _context(golden.GOLDEN_N, list(golden.GOLDEN_BITS), card)
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, card)
    a, b = (ciphertext_from_numpy(d, ctx.first_parms_id, True, 2.0 ** 40, card)
            for d in golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED))
    ev = Evaluator(ctx)
    bctx = golden.bfv_context(golden.BFV_N, card)
    key = relin_keys_from_numpy([golden.key_inputs(bctx, golden.GOLDEN_KEY_SEED)], bctx.key_parms_id, card).key(2)
    x, y = (u64_from_numpy(d, card) for d in golden.request_inputs(bctx, golden.GOLDEN_REQUEST_SEED))
    bfv = build_bfv_mult_relin(bctx)

    def run():
        return ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk)).data, bfv(x, y, key["c0"], key["c1"])

    monkeypatch.delenv("SEAL_TPU_DEBUG", raising=False)
    plain = run()
    monkeypatch.setenv("SEAL_TPU_DEBUG", "1")
    before = (ntt_cuda.launches, switch_key_contract_cuda.launches)
    checked = run()
    assert (ntt_cuda.launches - before[0], switch_key_contract_cuda.launches - before[1]) == (9, 2)
    assert all(torch.equal(p, c) for p, c in zip(plain, checked))
    assert golden.digest(u64_to_numpy(checked[0])) == golden.GOLDEN_DIGEST
    assert golden.digest(u64_to_numpy(checked[1])) == golden.BFV_DIGEST
    t = ctx.first_context_data().limb_tables()
    with pytest.raises(debug.RangeError, match="ntt_forward input < 4q"):
        NTT.forward(2 * t.two_q.expand(-1, golden.GOLDEN_N).contiguous(), t)


@pytest.mark.cuda
def test_device_time_us_agrees_with_event_timing(card):
    """profiling.device_time_us of kernel A against CUDA events around 200
    back-to-back launches: within a factor of two (both read the card's
    time where the kernel outlasts the host's launch)."""
    from seal_tpu_torch import profiling

    mods = CoeffModulus.create(32768, [60] * 16)
    t = build_limb_tables(15, mods, device=card)
    x = _uniform((2, 16, 32768), t.q * 4, card, 3)
    us = profiling.device_time_us(lambda: ntt_cuda(x, t, False), lo=10, hi=60)
    for _ in range(3):
        ntt_cuda(x, t, False)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        ntt_cuda(x, t, False)
    end.record()
    torch.cuda.synchronize()
    events_us = start.elapsed_time(end) / 200 * 1e3
    assert 0.5 * events_us < us < 2 * events_us, (us, events_us)


# -- kernel E: the modular functions of ops/u64.py ------------------------------

MODARITH_BASES = {"ckks": "CKKS N=32768, 15 limbs of 55 bits, 8 x 2 rows",
                  "bfv_q": "BFV N=8192, q's 4 limbs, 32 x 2 rows",
                  "bfv_bsk": "BFV N=8192, the Bsk base, 32 x 2 rows"}


def _modarith_base(base, device):
    """(leading axes, tables) at a benchmark cell's shapes."""
    if base == "ckks":
        return (8, 2), build_limb_tables(15, CoeffModulus.create(32768, [55] * 15), device=device)
    cd = golden.bfv_context(8192, device).first_context_data()
    if base == "bfv_q":
        return (32, 2), cd.limb_tables()
    behz = cd.behz_limb_tables()
    return (32, 2), slice_limbs(behz, len(cd.coeff_modulus_values), behz.q.shape[0])


def _words(shape, device, gen):
    """Full-range 64-bit words."""
    return torch.randint(-(1 << 63), (1 << 63) - 1, shape, dtype=torch.int64, device=device, generator=gen)


def _shoup_constants(t, gen):
    """A per-limb multiplicand y < q and its Shoup quotient floor(y 2^64 / q)."""
    qs = [int(v) for v in t.q.flatten().tolist()]
    ys = [int(v) % q for v, q in zip(torch.randint(0, 1 << 62, (len(qs),), generator=gen).tolist(), qs)]
    y = u64_from_numpy(np.array([[v] for v in ys], dtype=np.uint64), t.q.device)
    yq = u64_from_numpy(np.array([[(v << 64) // q] for v, q in zip(ys, qs)], dtype=np.uint64), t.q.device)
    return y, yq


def _modarith_args(name, lead, t, values, seed):
    """The function's operands in its order: ``values`` "random" (every
    operand full-range words, the constants too), "edges" (data words 0,
    q-1, 2q-1, 4q-1, 2^62, 2^63 and -1 among random words) or "lazy" (data
    as x + c - y with x, y < q and c = 2q, 4q)."""
    device = t.q.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    k, n = t.q.shape[0], 1 << t.log_n
    shape = (*lead, k, n)
    q, rlo, rhi = t.q, t.ratio_lo, t.ratio_hi
    y, yq = _shoup_constants(t, host)

    def below(bound):
        return torch.randint(0, 1 << 62, shape, dtype=torch.int64, device=device, generator=gen) % bound

    if values == "random":
        q, rlo, rhi = (_words((k, 1), device, gen) for _ in range(3))
        y, yq = _words(shape, device, gen), _words(shape, device, gen)
        data = lambda: _words(shape, device, gen)                          # noqa: E731
    elif values == "edges":
        one = torch.ones_like(q)
        edges = torch.stack([0 * q, q - 1, 2 * q - 1, 4 * q - 1, one << 62, one << 63, -one], dim=-1)   # (k, 1, 7)

        def data():
            pick = torch.randint(0, 2 * edges.shape[-1], shape, device=device, generator=gen)
            table = edges.expand(*shape, edges.shape[-1])
            edge = table.gather(-1, pick.clamp(max=edges.shape[-1] - 1)[..., None])[..., 0]
            return torch.where(pick < edges.shape[-1], edge, _words(shape, device, gen))
    else:
        c = 2 * q if name in ("add_mod", "sub_mod", "neg_mod", "mul_mod_shoup_lazy") else 4 * q
        data = lambda: below(q) + c - below(q)                              # noqa: E731
    return {
        "add_mod": lambda: (data(), data(), q),
        "sub_mod": lambda: (data(), data(), q),
        "neg_mod": lambda: (data(), q),
        "barrett_reduce_64": lambda: (data(), q, rhi),
        "barrett_reduce_128": lambda: ((data(), data()), q, rlo, rhi),
        "mul_mod": lambda: (data(), data(), q, rlo, rhi),
        "mul_mod_shoup": lambda: (data(), y, yq, q),
        "mul_mod_shoup_lazy": lambda: (data(), y, yq, q),
    }[name]()


def _kernel_e_against_plain(name, args, case=""):
    """Kernel E's output (one launch) equals the plain body's on the card."""
    f = getattr(U64, name)
    before = modarith_cuda.launches
    got = f(*args)
    assert modarith_cuda.launches == before + 1, case
    with NTT.plain_on_card():
        want = f(*args)
    assert got.shape == want.shape and got.is_contiguous(), case
    assert torch.equal(got, want), (name, case)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["random", "edges", "lazy"])
@pytest.mark.parametrize("base", sorted(MODARITH_BASES))
@pytest.mark.parametrize("name", sorted(MODARITH_OPS))
def test_modarith_kernel_matches_plain(card, name, base, values):
    lead, t = _modarith_base(base, card)
    _kernel_e_against_plain(name, _modarith_args(name, lead, t, values, len(name) + len(base)))


def _modarith_layouts(card):
    """(function, operands) of each layout the port passes, at N=32768 with
    (15, 1) constants, and of the kernel's other paths."""
    _, t = _modarith_base("ckks", card)
    q, rlo, rhi = t.q, t.ratio_lo, t.ratio_hi
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    y, yq = _shoup_constants(t, torch.Generator().manual_seed(5))
    n = 1 << t.log_n
    full, three = _words((8, 2, 15, n), card, gen), _words((8, 3, 15, n), card, gen)
    last = _words((8, 2, 1, n), card, gen)
    rows = full.numel() // 64
    return {
        "ct_data[..., :2, :, :]": ("add_mod", (three[..., :2, :, :], full, q)),
        "new[..., :1, :, :] over the ciphertext axis": ("add_mod", (full[..., :1, :, :], three[..., :2, :, :], q)),
        "x[..., :k-1, :] with sliced constants": ("mul_mod_shoup", (full[..., :14, :], y[:14], yq[:14], q[:14])),
        "prod[..., lo:hi, :]": ("barrett_reduce_128", ((three[:, 1:, 1:3, :], full[..., 1:3, :]), q[1:3], rlo[1:3],
                                                        rhi[1:3])),
        "(..., 1, n) over the limbs": ("barrett_reduce_64", (last, q[:14], rhi[:14])),
        "(1, 1) constants": ("mul_mod_shoup_lazy", (full, y[:1], yq[:1], q[:1])),
        "0-dim constants": ("barrett_reduce_64", (full[:, 0, 2], q[2, 0], rhi[2, 0])),
        "strided last axis (copied)": ("sub_mod", (full[..., ::2], full[..., 1::2], q)),
        "odd rows, unaligned (scalar loads)": ("mul_mod", (full[..., 1:], full[..., :-1], q, rlo, rhi)),
        "even rows, unaligned (scalar loads)": ("neg_mod", (full[..., 1:-1], q)),
        "more rows than the grid's y, per-row constants": ("barrett_reduce_64", (
            full.reshape(-1, 64), _words((rows, 1), card, gen), _words((rows, 1), card, gen))),
    }


@pytest.mark.cuda
def test_modarith_kernel_on_each_layout(card):
    """Bit for bit with the plain bodies, one launch each; no launch for
    an empty call."""
    for case, (name, args) in _modarith_layouts(card).items():
        _kernel_e_against_plain(name, args, case)
    empty = torch.empty((0, 15, 8), dtype=torch.int64, device=card)
    before = modarith_cuda.launches
    assert U64.add_mod(empty, empty, torch.ones((15, 1), dtype=torch.int64, device=card)).shape == (0, 15, 8)
    assert modarith_cuda.launches == before

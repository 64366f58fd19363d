"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one.  On the
card (where JAX is absent, so the suite's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The other tests check what the kernel wrappers refuse, and run anywhere.
Every comparison is exact equality of reduced residues.
"""

import pytest
import torch

from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SealContext, SecurityLevel
from seal_tpu_torch import golden
from seal_tpu_torch.convert import ciphertext_from_numpy, relin_keys_from_numpy, u64_to_numpy
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.modulus import Modulus
from seal_tpu_torch.ntt_tables import build_limb_tables, four_step_tables_for
from seal_tpu_torch.ops import four_step as FS
from seal_tpu_torch.ops import ntt as NTT
from seal_tpu_torch.ops.cuda_four_step import stage_cuda
from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda, switch_key_contract_plain
from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse


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
@pytest.mark.parametrize("log_n", [4, 10, 13, 14])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain(card, log_n, inverse):
    mods = CoeffModulus.create(1 << log_n, [60, 50, 40])
    t = build_limb_tables(log_n, mods, device=card)
    x = _uniform((2, 3, 1 << log_n), t.q * (2 if inverse else 4), card, log_n)
    want = ntt_inverse(x, t) if inverse else ntt_forward(x, t)
    assert torch.equal(ntt_cuda(x, t, inverse), want)


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
    want = switch_key_contract_plain(t_c, t_n, key, t, plan.need_reduce)
    assert torch.equal(switch_key_contract_cuda(t_c, t_n, key, t, plan.need_reduce), want)


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
    mats = (ft.finv, ft.winv) if inverse else (ft.w, ft.f)
    tws = ((ft.twi_op, ft.twi_qt) if inverse else (ft.tw_op, ft.tw_qt), None)
    h = x
    for spec, b, tw in zip(specs, mats, tws):
        got = stage_cuda(h, b, ft, spec, tw)
        assert torch.equal(got, FS.stage_plain(h, b, ft, spec, tw))
        h = got
    want = ntt_inverse(x, t) if inverse else ntt_forward(x, t)
    assert torch.equal(h, want)
    assert torch.equal((NTT.inverse if inverse else NTT.forward)(x, t), want)


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
    """N=32768 needs 256 KB for a row; a block has 227 KB."""
    t = build_limb_tables(15, [Modulus(786433)], device="cpu")
    with pytest.raises(ValueError, match="n <= 16384"):
        ntt_cuda(torch.zeros((1, 1 << 15), dtype=torch.int64), t, inverse=True)

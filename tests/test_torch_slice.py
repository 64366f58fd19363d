"""The port's CKKS server slice against the JAX package, end to end.

(a) ``build_ckks_mult_relin_rescale`` at N=8192, bits [60, 40, 40, 40, 60]
    on the golden splitmix64 inputs: the port on the CPU equals
    ``jax.jit(seal_tpu.pipeline.build_ckks_mult_relin_rescale(ctx))`` bit
    for bit, and gives ``golden.GOLDEN_DIGEST``.
(b) N=1024 with real keys and ciphertexts from the client of
    ``__graft_entry__._build`` (each package's own, on host sampling and the
    host ladder): Evaluator multiply -> relinearize -> rescale_to_next
    equals the JAX package's in data, scale and parms_id.
(c) importing every module of the port loads neither JAX nor ``seal_tpu``.
(d) a context with no device on a machine without CUDA raises.
(e) the same pipeline at N=65536, bits [60, 40, 40, 60] (the size where the
    card runs every NTT on the four-step stage kernel): the port's plain
    path equals the JAX pipeline and gives ``golden.LARGE_DIGEST``.
(f) the same pipeline at N=32768 on the default 128-bit chain
    (``golden.medium_context``: 16 moduli, D=15, Rn=16, kernel B's largest
    fused shape on the card): the port's plain path gives
    ``golden.MEDIUM_DIGEST`` (~10 s); the JAX pipeline's side (~45 s) is
    marked ``slow``.

A CKKS user's whole computation at N=1024 (keygen to decode) is held
against the JAX package in ``tests/test_torch_client.py``.

The JAX package's answers to (a), (b) and (e) are frozen in
``tests/data/jax_answers/`` (``tests/jax_answers.py``); the tests marked
``slow`` recompute them and the JAX side of ``GOLDEN_DIGEST``.

Every comparison is exact equality of reduced residues: the slice is
integer arithmetic.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.pipeline import build_ckks_mult_relin_rescale as jax_pipeline

import seal_tpu_torch as P
from seal_tpu_torch import golden
from seal_tpu_torch.convert import (
    ciphertext_from_numpy, ciphertext_to_numpy, relin_keys_from_numpy, relin_keys_to_numpy,
    u64_from_numpy, u64_to_numpy,
)
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.pipeline import build_ckks_mult_relin_rescale

import jax_answers as JA


def _port_context(n, bits, device="cpu"):
    parms = P.EncryptionParameters(P.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(P.CoeffModulus.create(n, bits))
    return P.SealContext(parms, True, P.SecurityLevel.NONE, device=device)


ANSWERS = JA.Answers(__file__)
ARGS = ("request 1", "request 2", "relin key c0", "relin key c1")


def _jax_context(n, bits):
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JaxCoeffModulus.create(n, bits))
    return JaxContext(jp, True, JaxSecurityLevel.NONE)


def _pipeline_case(side, n, bits):
    """One package's pipeline on the golden inputs; with the port's context."""
    pctx = _port_context(n, bits)
    args = (*golden.request_inputs(pctx, golden.GOLDEN_REQUEST_SEED), *golden.key_inputs(pctx, golden.GOLDEN_KEY_SEED))
    if side == "jax":
        jctx = _jax_context(n, bits)
        assert jctx.first_parms_id == pctx.first_parms_id
        out = JU.to_np_u64(jax.jit(jax_pipeline(jctx))(*(JU.from_np_u64(a) for a in args)))
    else:
        out = u64_to_numpy(build_ckks_mult_relin_rescale(pctx)(*(u64_from_numpy(a, "cpu") for a in args)))
    return dict(zip(ARGS, args)), {"out": out}, pctx


@pytest.fixture(scope="module")
def golden_outputs():
    """The port's plain path (CPU) at N=8192 on the golden inputs, with its
    inputs and context."""
    return _pipeline_case("port", golden.GOLDEN_N, list(golden.GOLDEN_BITS))


@pytest.mark.slow
def test_jax_pipeline_gives_golden_digest():
    _, outputs, _ = _pipeline_case("jax", golden.GOLDEN_N, list(golden.GOLDEN_BITS))
    assert outputs["out"].shape == (2, len(golden.GOLDEN_BITS) - 2, golden.GOLDEN_N)
    assert golden.digest(outputs["out"]) == golden.GOLDEN_DIGEST


def test_port_pipeline_equals_jax_at_n8192(golden_outputs, request):
    inputs, outputs, pctx = golden_outputs
    ANSWERS.check(request.node.name, inputs, outputs)
    port_out = outputs["out"]
    assert golden.digest(port_out) == golden.GOLDEN_DIGEST
    q = np.array(pctx.first_context_data().next_context_data.coeff_modulus_values, dtype=np.uint64)
    assert (port_out < q[None, :, None]).all()


def _evaluator_case(side):
    """Multiply -> relinearize -> rescale_to_next on real N=1024 ciphertexts
    of the client of ``__graft_entry__._build`` (its seed, encoder values
    and symmetric encryptions), on host sampling and the host ladder."""
    if side == "jax":
        from seal_tpu.ckks_encoder import CKKSEncoder as Encoder
        from seal_tpu.encryptor import Encryptor
        from seal_tpu.keygen import KeyGenerator
        from seal_tpu.random import PRNGType, UniformRandomGeneratorFactory as Factory
        Parameters, Scheme, Modulus, Ev = JaxParameters, JaxScheme, JaxCoeffModulus, JaxEvaluator
        context = lambda parms: JaxContext(parms, True, JaxSecurityLevel.NONE)
    else:
        Encoder, Encryptor, KeyGenerator, PRNGType, Factory = (P.CKKSEncoder, P.Encryptor, P.KeyGenerator,
                                                               P.PRNGType, P.UniformRandomGeneratorFactory)
        Parameters, Scheme, Modulus, Ev = P.EncryptionParameters, P.SchemeType, P.CoeffModulus, Evaluator
        context = lambda parms: P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")
    n, bits = 1024, [60, 40, 40, 40, 60]
    scale = 2.0 ** bits[1]
    with pytest.MonkeyPatch.context() as mp:
        for var in ("SEAL_TPU_DEVICE_SAMPLING", "SEAL_TPU_DEVICE_FFT", "SEAL_TPU_DEVICE_COMPOSE"):
            mp.setenv(var, "0")
        parms = Parameters(Scheme.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(Modulus.create(n, bits))
        parms.set_random_generator(Factory(PRNGType.BLAKE2XB, (1, 2, 3, 4, 5, 6, 7, 8)))
        ctx = context(parms)
        keygen = KeyGenerator(ctx)
        rk = keygen.create_relin_keys()
        enc, encoder = Encryptor(ctx, secret_key=keygen.secret_key), Encoder(ctx)
        vals = np.linspace(0.0, 1.0, n // 2)
        ct1 = enc.encrypt_symmetric(encoder.encode(vals, scale))
        ct2 = enc.encrypt_symmetric(encoder.encode(vals[::-1].copy(), scale))
    ev = Ev(ctx)
    out = ev.rescale_to_next(ev.relinearize(ev.multiply(ct1, ct2), rk))
    return {"ct1": ct1, "ct2": ct2, "relin keys": rk}, {"out": out}


@pytest.fixture(scope="module")
def evaluator_outputs():
    """The port's Evaluator on its own N=1024 ciphertexts."""
    return _evaluator_case("port")


def test_evaluator_equals_jax_at_n1024(evaluator_outputs, request):
    inputs, outputs = evaluator_outputs
    ANSWERS.check(request.node.name, inputs, outputs)


def test_convert_round_trip():
    rng = np.random.default_rng(4)
    data = rng.integers(0, np.iinfo(np.uint64).max, (2, 3, 16), dtype=np.uint64, endpoint=True)
    ct = ciphertext_from_numpy(data, (1, 2, 3, 4), True, 2.0 ** 40, "cpu", correction_factor=7)
    back, pid, ntt, scale, factor = ciphertext_to_numpy(ct)
    np.testing.assert_array_equal(back, data)
    assert (pid, ntt, scale, factor) == ((1, 2, 3, 4), True, 2.0 ** 40, 7)
    rk = relin_keys_from_numpy([None, (data, data[::-1].copy())], (5, 6, 7, 8), "cpu")
    keys, pid = relin_keys_to_numpy(rk)
    assert keys[0] is None and pid == (5, 6, 7, 8)
    np.testing.assert_array_equal(keys[1][0], data)
    np.testing.assert_array_equal(keys[1][1], data[::-1])
    with pytest.raises(ValueError):
        ciphertext_from_numpy(data.astype(np.int64), (1, 2, 3, 4), True, 1.0, "cpu")


@pytest.fixture(scope="module")
def large_golden_outputs():
    """The port's plain path (CPU) at N=65536, with its inputs."""
    return _pipeline_case("port", golden.LARGE_N, list(golden.LARGE_BITS))


def test_pipelines_give_large_golden_digest_at_n65536(large_golden_outputs, request):
    inputs, outputs, _ = large_golden_outputs
    ANSWERS.check(request.node.name, inputs, outputs)
    assert outputs["out"].shape == (2, len(golden.LARGE_BITS) - 2, golden.LARGE_N)
    assert golden.digest(outputs["out"]) == golden.LARGE_DIGEST


def test_port_imports_neither_jax_nor_seal_tpu():
    code = (
        "import sys, pkgutil, importlib, seal_tpu_torch\n"
        "for m in pkgutil.walk_packages(seal_tpu_torch.__path__, 'seal_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'seal_tpu'"
        " or m.startswith('seal_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('seal_tpu_torch')]))\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20   # every module of the port was imported


def test_context_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parms = P.EncryptionParameters(P.SchemeType.CKKS)
    parms.set_poly_modulus_degree(1024)
    parms.set_coeff_modulus(P.CoeffModulus.create(1024, [40, 40]))
    with pytest.raises(RuntimeError):
        P.SealContext(parms, True, P.SecurityLevel.NONE)
    assert P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu").device.type == "cpu"


def test_unported_schemes_raise_not_implemented():
    """Every scheme runs on one device and on a mesh now (BGV:
    tests/test_torch_bgv.py, tests/test_torch_mesh_bfv_bgv.py): BGV data
    sharded over a 2-rank limb mesh multiplies to the product on one
    device."""
    from seal_tpu_torch.parallel.mesh import make_mesh

    parms = P.EncryptionParameters(P.SchemeType.BGV)
    parms.set_poly_modulus_degree(1024)
    parms.set_coeff_modulus(P.CoeffModulus.create(1024, [40, 40, 40]))
    parms.set_plain_modulus(P.Modulus(65537))
    ctx = P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")
    ev = Evaluator(ctx, mesh=make_mesh(2, limb_parallel=2, devices=["cpu"] * 2))
    data = torch.arange(2 * 2 * 1024, dtype=torch.int64).reshape(2, 2, 1024)
    ct = P.Ciphertext(data, ctx.first_parms_id, True, 1.0)
    sharded = ev.shard(ct)
    got = ev.multiply(sharded, sharded)
    assert torch.equal(got.data.unshard(), Evaluator(ctx).multiply(ct, ct).data)


def _medium_args(ctx):
    d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    kc0, kc1 = golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)
    return d1, d2, kc0, kc1


def test_port_pipeline_gives_medium_golden_digest_at_n32768():
    pctx = golden.medium_context("cpu")
    cd = pctx.first_context_data()
    assert (cd.parms.poly_modulus_degree, len(cd.coeff_modulus_values)) == (golden.MEDIUM_N, 15)
    port_out = u64_to_numpy(build_ckks_mult_relin_rescale(pctx)(*(u64_from_numpy(a, "cpu") for a in _medium_args(pctx))))
    assert port_out.shape == (2, 14, golden.MEDIUM_N)
    assert golden.digest(port_out) == golden.MEDIUM_DIGEST


@pytest.mark.slow
def test_jax_pipeline_gives_medium_golden_digest_at_n32768():
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(golden.MEDIUM_N)
    jp.set_coeff_modulus(JaxCoeffModulus.bfv_default(golden.MEDIUM_N))
    jctx = JaxContext(jp, True, JaxSecurityLevel.TC128)
    pctx = golden.medium_context("cpu")
    assert jctx.first_parms_id == pctx.first_parms_id
    args = _medium_args(pctx)
    jax_out = JU.to_np_u64(jax.jit(jax_pipeline(jctx))(*(JU.from_np_u64(a) for a in args)))
    assert golden.digest(jax_out) == golden.MEDIUM_DIGEST


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    yield ("test_port_pipeline_equals_jax_at_n8192", *_pipeline_case(side, golden.GOLDEN_N, list(golden.GOLDEN_BITS))[:2])
    yield ("test_evaluator_equals_jax_at_n1024", *_evaluator_case(side))
    yield ("test_pipelines_give_large_golden_digest_at_n65536",
           *_pipeline_case(side, golden.LARGE_N, list(golden.LARGE_BITS))[:2])


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))

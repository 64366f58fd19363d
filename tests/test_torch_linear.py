"""One step of an encrypted linear layer, the port against the JAX package.

The step is ``golden.linear_layer_step``: multiply_plain -> rotate_vector(1)
-> multiply -> relinearize -> rescale_to_next, the inner loop of
``benchmarks/batched_32768.py``, on the splitmix64 inputs of
``golden.linear_inputs``:

(a) N=8192 on the golden chain (bits [60, 40, 40, 40, 60]): the port's
    Evaluator and its BatchEvaluator (2 requests as one batch) on the CPU
    equal the JAX package's Evaluator, the step under one ``jax.jit``,
    whose answer is frozen in ``tests/data/jax_answers/`` (the test marked
    ``slow`` recomputes it, about a minute on the CPU);
(b) N=32768 on the default 128-bit chain (``golden.medium_context``, D=15,
    Rn=16): the port's plain path gives ``golden.LINEAR_DIGEST`` (~15 s);
    the JAX package's side (~2 minutes) is marked ``slow``.

Every comparison is exact equality of reduced residues.
"""

import jax
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import Ciphertext as JaxCiphertext, GaloisKeys as JaxGaloisKeys, Plaintext as JaxPlaintext
from seal_tpu.data import RelinKeys as JaxRelinKeys
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme

import seal_tpu_torch as P
from seal_tpu_torch import golden
from seal_tpu_torch.convert import (ciphertext_from_numpy, galois_keys_from_numpy, plaintext_from_numpy,
                                    relin_keys_from_numpy, u64_to_numpy)
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch

import jax_answers as JA

S = golden.LINEAR_SCALE


def _jax_step(jctx, inputs, jit):
    """The JAX package's step on numpy inputs; under one ``jax.jit`` when
    ``jit`` (the transparency check, a host read, is then off)."""
    ct, pt, (g0, g1), (r0, r1) = inputs
    n = jctx.first_context_data().parms.poly_modulus_degree
    gk = JaxGaloisKeys()
    gk.parms_id, gk.keys = jctx.key_parms_id, [None] * n
    gk.keys[golden.LINEAR_GALOIS_ELT >> 1] = {"c0": JU.from_np_u64(g0), "c1": JU.from_np_u64(g1)}
    rk = JaxRelinKeys()
    rk.parms_id, rk.keys = jctx.key_parms_id, [{"c0": JU.from_np_u64(r0), "c1": JU.from_np_u64(r1)}]
    ev = JaxEvaluator(jctx, throw_on_transparent=not jit)

    def step(data, plain):
        c = JaxCiphertext(data=data, parms_id=jctx.first_parms_id, is_ntt_form=True, scale=S)
        p = JaxPlaintext()
        p.parms_id, p.scale, p.rns_data = jctx.first_parms_id, S, plain
        return golden.linear_layer_step(ev, c, p, gk, rk).data

    fn = jax.jit(step) if jit else step
    return JU.to_np_u64(fn(JU.from_np_u64(ct), JU.from_np_u64(pt)))


def _port_inputs(ctx, inputs):
    ct, pt, g, r = inputs
    n = ctx.first_context_data().parms.poly_modulus_degree
    keys = [None] * n
    keys[golden.LINEAR_GALOIS_ELT >> 1] = g
    return (ciphertext_from_numpy(ct, ctx.first_parms_id, True, S, "cpu"),
            plaintext_from_numpy(pt, ctx.first_parms_id, S, "cpu"),
            galois_keys_from_numpy(keys, ctx.key_parms_id, "cpu"),
            relin_keys_from_numpy([r], ctx.key_parms_id, "cpu"))


ANSWERS = JA.Answers(__file__)


def _n8192_contexts(side):
    n, bits = golden.GOLDEN_N, list(golden.GOLDEN_BITS)
    pp = P.EncryptionParameters(P.SchemeType.CKKS)
    pp.set_poly_modulus_degree(n)
    pp.set_coeff_modulus(P.CoeffModulus.create(n, bits))
    pctx = P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu")
    if side == "port":
        return pctx, None
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JaxCoeffModulus.create(n, bits))
    return pctx, JaxContext(jp, True, JaxSecurityLevel.NONE)


def _step_inputs(inputs):
    ct, pt, (g0, g1), (r0, r1) = inputs
    return {"ciphertext": ct, "plain": pt, "galois key c0": g0, "galois key c1": g1, "relin key c0": r0,
            "relin key c1": r1}


def _n8192_case(side):
    pctx, jctx = _n8192_contexts(side)
    inputs = golden.linear_inputs(pctx)
    if side == "jax":
        out = _jax_step(jctx, inputs, jit=True)
    else:
        out = golden.linear_layer_step(Evaluator(pctx), *_port_inputs(pctx, inputs))
    return _step_inputs(inputs), {"out": out if side == "jax" else out.data}


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    yield ("test_linear_step_equals_jax_at_n8192", *_n8192_case(side))


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))


def test_linear_step_equals_jax_at_n8192(request):
    pctx, _ = _n8192_contexts("port")
    inputs = golden.linear_inputs(pctx)
    ct, pt, gk, rk = _port_inputs(pctx, inputs)
    out = golden.linear_layer_step(Evaluator(pctx), ct, pt, gk, rk)
    ANSWERS.check(request.node.name, _step_inputs(inputs), {"out": out.data})
    cd = pctx.first_context_data()
    assert out.parms_id == cd.next_context_data.parms_id and out.scale == S ** 3 / cd.coeff_modulus_values[-1]
    # two requests as one batch equal the requests one by one
    second = _port_inputs(pctx, golden.linear_inputs(pctx, 1))[0]
    batch = golden.linear_layer_step(BatchEvaluator(pctx), CiphertextBatch.from_ciphertexts([ct, second]), pt, gk, rk)
    assert torch.equal(batch[0].data, out.data) and batch.scale == out.scale
    assert torch.equal(batch[1].data, golden.linear_layer_step(Evaluator(pctx), second, pt, gk, rk).data)


def test_port_linear_step_gives_linear_digest_at_n32768():
    ctx = golden.medium_context("cpu")
    out = golden.linear_layer_step(Evaluator(ctx), *_port_inputs(ctx, golden.linear_inputs(ctx)))
    data = u64_to_numpy(out.data)
    assert data.shape == (2, 14, golden.MEDIUM_N)
    assert golden.digest(data) == golden.LINEAR_DIGEST


@pytest.mark.slow
def test_jax_linear_step_gives_linear_digest_at_n32768():
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(golden.MEDIUM_N)
    jp.set_coeff_modulus(JaxCoeffModulus.bfv_default(golden.MEDIUM_N))
    jctx = JaxContext(jp, True, JaxSecurityLevel.TC128)
    pctx = golden.medium_context("cpu")
    assert jctx.first_parms_id == pctx.first_parms_id
    assert golden.digest(_jax_step(jctx, golden.linear_inputs(pctx), jit=False)) == golden.LINEAR_DIGEST

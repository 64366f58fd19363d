"""The plain reference and the benchmark's inputs, against the port and the
JAX package's digests.

On the CPU: the frozen splitmix generator equals ``golden.py``'s; the
reference's arithmetic and transforms are exact; the reference reproduces
the JAX package's digests of the BFV request at N=8192 and of the CKKS
linear-layer step at N=32768; and at a small N the reference equals the
port's output for each mix, through the whole harness.  On the card (marked
``cuda``): the same through the port's kernels at the cells' own sizes.
"""

import json
import random
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.inputs import Inputs, residues, splitmix64
from portbench.reference import ntt as NTT
from portbench.reference.arith import addmod, is_prime, mulmod, primes_below, submod
from portbench.reference.program import Ct, Key, Plain, Reference, galois_elts_all
from seal_tpu_torch import golden
from seal_tpu_torch.ops.poly import get_elts_all
from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 12345, 2 ** 63 + 5])
def test_splitmix_is_golden_frozen(seed):
    assert (splitmix64(seed, 4096, "cpu").numpy().view(np.uint64) == golden.splitmix64(seed, 4096)).all()


def test_residues_are_golden_frozen():
    mods = [36028797017456641, 17592186028033, 72057594037338113, (1 << 61) - 1]
    got = residues(7, mods, (2, 3), 64, "cpu").numpy().view(np.uint64)
    assert (got == golden._residues(7, mods, (2, 3), 64)).all()


def test_a_key_made_alone_is_its_place_in_the_client_set(small_spec):
    config = __import__("json").loads((ROOT / small_spec["configs"][0]["file"]).read_text())
    inputs = Inputs(config, 2 ** 31 + 3, "cpu")
    inputs.CHUNK_WORDS = 3 * 2 * len(inputs.data_primes) * len(inputs.key_primes) * inputs.n  # 3 keys a chunk
    keys = inputs.key_set("galois_keys", 5, 8)
    for j in range(8):
        assert torch.equal(keys[j], inputs.key("galois_keys", 5, j))
    assert not torch.equal(keys[0], inputs.key("galois_keys", 6, 0))


@pytest.mark.parametrize("n", [256, 8192, 32768])
def test_the_default_galois_elements_are_the_programs(n):
    assert galois_elts_all(n) == list(get_elts_all(n))


@pytest.mark.parametrize("bits", [30, 44, 55, 60, 61])
def test_mulmod_is_exact(bits):
    rng = random.Random(bits)
    q = primes_below(1 << 16, bits, 1)[0]
    a = [rng.randrange(q) for _ in range(2000)] + [q - 1, 0, 1]
    b = [rng.randrange(q) for _ in range(2000)] + [q - 1, q - 1, 1]
    qt = torch.tensor(q)
    got = mulmod(torch.tensor(a), torch.tensor(b), qt).tolist()
    assert got == [x * y % q for x, y in zip(a, b)]
    assert addmod(torch.tensor(a), torch.tensor(b), qt).tolist() == [(x + y) % q for x, y in zip(a, b)]
    assert submod(torch.tensor(a), torch.tensor(b), qt).tolist() == [(x - y) % q for x, y in zip(a, b)]


def test_aux_primes():
    ps = primes_below(16384, 61, 6)
    assert all(is_prime(p) and p % 16384 == 1 and p.bit_length() == 61 for p in ps)
    candidates = range(((1 << 61) - 1) // 16384 * 16384 + 1, ps[-1] - 1, -16384)
    assert [c for c in candidates if is_prime(c)] == ps


def test_ntt_matches_the_port():
    ctx = golden.bfv_context(8192, device="cpu")
    cd = ctx.first_context_data()
    primes = cd.coeff_modulus_values
    x = residues(3, primes, (2,), 8192, "cpu")
    t = NTT.tables(primes, 8192, "cpu")
    fwd = NTT.forward(x, t)
    port_t = cd.limb_tables()
    assert torch.equal(fwd, ntt_forward(x, port_t))
    assert torch.equal(NTT.inverse(fwd, t), x)
    assert torch.equal(ntt_inverse(fwd, port_t), x)


def test_reference_reproduces_the_bfv_digest():
    ctx = golden.bfv_context(8192, device="cpu")
    cd = ctx.first_context_data()
    cfg = {"scheme": "bfv", "poly_modulus_degree": 8192, "coeff_modulus": cd.coeff_modulus_values,
           "special_prime": ctx.key_context_data().coeff_modulus_values[-1],
           "plain_modulus": cd.parms.plain_modulus.value}
    a, b = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    k0, k1 = golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)
    ref = Reference(cfg, "cpu")
    out = ref.relinearize(ref.multiply(Ct(_t(a), False), Ct(_t(b), False)), Key(torch.stack([_t(k0), _t(k1)])))
    assert golden.digest(out.data.numpy().view(np.uint64)) == golden.BFV_DIGEST


def test_reference_reproduces_the_linear_step_digest():
    ctx = golden.medium_context(device="cpu")
    cd = ctx.first_context_data()
    cfg = {"scheme": "ckks", "poly_modulus_degree": golden.MEDIUM_N, "coeff_modulus": cd.coeff_modulus_values,
           "special_prime": ctx.key_context_data().coeff_modulus_values[-1]}
    ct, pt, g, r = golden.linear_inputs(ctx)
    s = golden.LINEAR_SCALE
    ref = Reference(cfg, "cpu")
    c = Ct(_t(ct), True, s)
    x = ref.rotate_vector(ref.multiply_plain(c, Plain(_t(pt), s)), 1,
                          {golden.LINEAR_GALOIS_ELT: Key(torch.stack([_t(g[0]), _t(g[1])]))})
    out = ref.rescale_to_next(ref.relinearize(ref.multiply(x, c), Key(torch.stack([_t(r[0]), _t(r[1])]))))
    assert golden.digest(out.data.numpy().view(np.uint64)) == golden.LINEAR_DIGEST
    assert out.scale == s ** 3 / cd.coeff_modulus_values[-1]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_port_for_each_mix(small_spec, workload):
    result = harness.run(small_spec, ROOT, workload, 2 ** 31 + 99, 4.0, False, time.perf_counter(),
                         device="cpu", require_card=False)
    assert result["correct"], result["checks"]
    assert result["checks"]["compared_requests"]["value"] >= result["checks"]["compared_requests"]["limit"]


@pytest.mark.cuda
def test_mulmod_on_the_card(card):
    rng = random.Random(5)
    q = primes_below(1 << 16, 61, 1)[0]
    a = [rng.randrange(q) for _ in range(100000)]
    b = [rng.randrange(q) for _ in range(100000)]
    got = mulmod(torch.tensor(a, device=card), torch.tensor(b, device=card), torch.tensor(q, device=card))
    assert got.cpu().tolist() == [x * y % q for x, y in zip(a, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_port_on_the_card(spec, card, workload):
    result = harness.run(spec, ROOT, workload, 2 ** 31 + 101, 2.0, False, time.perf_counter())
    assert result["correct"], result["checks"]

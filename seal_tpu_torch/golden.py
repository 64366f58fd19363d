"""Deterministic pipeline inputs and the golden digest of the main path.

The inputs come from a splitmix64 counter (Steele, Lea and Flood, 2014)
computed in numpy uint64, reduced mod each modulus; they depend on no
library's random stream, so the JAX package, the port on the CPU and the
port on the card all see the same bits.  Uniform residues stand in for
ciphertexts and keys: the server path's arithmetic is the same on any
residues, and a digest of its output ties each implementation to the
others.

``GOLDEN_DIGEST`` is the SHA-256 of the little-endian u64 bytes of
``jax.jit(seal_tpu.pipeline.build_ckks_mult_relin_rescale(ctx))`` on the
inputs ``key_inputs(ctx, GOLDEN_KEY_SEED)`` and
``request_inputs(ctx, GOLDEN_REQUEST_SEED)``, for CKKS N=8192 with
coefficient-modulus bits [60, 40, 40, 40, 60], ``SecurityLevel.NONE`` and
the chain expanded (the context of ``__graft_entry__._build``).
``LARGE_DIGEST`` is the same for N=65536 with bits [60, 40, 40, 60], where
every NTT of the card runs on the four-step stage kernel.
``MEDIUM_DIGEST`` is the same for N=32768 on the default 128-bit chain
(:func:`medium_context`: ``CoeffModulus.bfv_default(32768)``, 16 moduli,
``SecurityLevel.TC128``), the heaviest key switch of the repository's
configurations (D=15 decomposition rows, Rn=16 output limbs), fused into one
launch of kernel B on the card.  All three were computed once with the JAX
package on the CPU; ``tests/test_torch_slice.py``
recomputes them from both the JAX package and the port's plain path (the
JAX side of ``MEDIUM_DIGEST`` in a test marked ``slow``), and
``chip_smoke.py`` from the kernels on the card.

``LINEAR_DIGEST`` is the SHA-256 of one step of an encrypted linear layer,
the inner loop of ``benchmarks/batched_32768.py`` (:func:`linear_layer_step`:
multiply_plain -> rotate_vector(1) -> multiply -> relinearize ->
rescale_to_next), on :func:`medium_context` with the inputs of
:func:`linear_inputs`: the ciphertext is the first of
``request_inputs(ctx, GOLDEN_REQUEST_SEED)`` at scale 2^40, the plaintext
``plain_inputs(ctx, 2)`` at scale 2^40, the Galois key of element 3 (one
step) ``galois_key_inputs(ctx, 3)``, and the relinearization key
``key_inputs(ctx, GOLDEN_KEY_SEED)``.  It was computed once with the JAX
package's ``Evaluator`` on the CPU (``SEAL_TPU_NTT`` at its default,
``JAX_PLATFORMS=cpu``), by :func:`linear_layer_step` on those inputs carried
across with ``seal_tpu.ops.u64.from_np_u64``; ``tests/test_torch_linear.py``
recomputes it from the port's plain path and, in a test marked ``slow``,
from the JAX package, and ``chip_smoke.py`` from the kernels on the card.

``BFV_DIGEST`` and ``BFV_MEDIUM_DIGEST`` are the SHA-256 of the BFV server
request, ``seal_tpu.pipeline.build_bfv_mult_relin`` (the BEHZ multiply then
relinearization, output (2, k, n)), on :func:`bfv_context` at N=8192 and
N=32768 (``CoeffModulus.bfv_default(n)`` at ``SecurityLevel.TC128``, the
plain modulus ``PlainModulus.batching(n, 20)``, chain expanded: k=4 data
limbs and a 5-prime Bsk at N=8192, k=15 and 16 at N=32768), with
``request_inputs(ctx, GOLDEN_REQUEST_SEED)`` read as coefficient-form
ciphertexts and ``key_inputs(ctx, GOLDEN_KEY_SEED)``.  Each was computed
once by ``jax.jit`` of that pipeline on the CPU (``JAX_PLATFORMS=cpu``,
every setting at its default), the inputs carried across with
``seal_tpu.ops.u64.from_np_u64``.  ``tests/test_torch_bfv.py`` recomputes
``BFV_DIGEST`` from the port's plain path and both from the JAX package
(marked ``slow``), ``chip_smoke.py`` both from the kernels on the card.

``BGV_DIGEST`` and ``BGV_MEDIUM_DIGEST`` are the SHA-256 of the BGV server
request (:func:`bgv_request`: multiply -> relinearize -> rotate_rows(1) ->
mod_switch_to_next, output (2, k - 1, n) in NTT form) on
:func:`bgv_context` at N=8192 and N=32768 (the chain and plain modulus of
``BFV_CHAIN`` as a BGV context), with ``request_inputs(ctx,
GOLDEN_REQUEST_SEED)`` read as NTT-form ciphertexts of correction factor
1, the relinearization key ``key_inputs(ctx, GOLDEN_KEY_SEED)`` and the
Galois key ``galois_key_inputs(ctx, BGV_GALOIS_SEED)`` of element
``BGV_GALOIS_ELT``.  ``BGV_CORRECTION_FACTOR`` and
``BGV_MEDIUM_CORRECTION_FACTOR`` are the output's correction factors: the
first level's q_last^-1 mod t.  The JAX package's ``pipeline.py`` has no
BGV request, so each digest was computed once by :func:`bgv_request` on the
JAX package's ``Evaluator`` on the CPU (``JAX_PLATFORMS=cpu``, every
setting at its default), the inputs carried across with
``seal_tpu.ops.u64.from_np_u64`` into its ``Ciphertext``, ``RelinKeys``
and ``GaloisKeys``.  ``tests/test_torch_bgv.py`` recomputes ``BGV_DIGEST``
from the port's plain path and both from the JAX package (marked
``slow``), ``chip_smoke.py`` both from the kernels on the card.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from .context import SealContext
from .modulus import CoeffModulus, PlainModulus, SecurityLevel
from .params import EncryptionParameters, SchemeType

GOLDEN_N = 8192
GOLDEN_BITS = (60, 40, 40, 40, 60)
GOLDEN_KEY_SEED = 0
GOLDEN_REQUEST_SEED = 1
GOLDEN_DIGEST = "07ad955fcfa99447cf40fde7c64159c6b2b7a2e658684cdd61dc917dd569b6eb"
LARGE_N = 65536
LARGE_BITS = (60, 40, 40, 60)
LARGE_DIGEST = "a125529dbd63f6a1af2c9c146075c5b0291303113d8ae5ce08151d1c208aa702"
MEDIUM_N = 32768
MEDIUM_CHAIN = "CoeffModulus.bfv_default(32768): 16 moduli, 881 bits; SecurityLevel.TC128; chain expanded"
MEDIUM_DIGEST = "c71d85f32d95061a9225125fc67ab03d618d1e2a6b377020504f2e7ac8ff415e"
LINEAR_SCALE = 2.0 ** 40
LINEAR_PLAIN_SEED = 2
LINEAR_GALOIS_SEED = 3
LINEAR_GALOIS_ELT = 3            # get_elt_from_step(1)
LINEAR_DIGEST = "1363d56db28f6ce40db9c3b33598a9c9d2b0f5a364d4dcc380f3ce3b72ac56fc"
BFV_N = 8192
BFV_MEDIUM_N = 32768
BFV_PLAIN_BITS = 20
BFV_CHAIN = ("CoeffModulus.bfv_default(n), SecurityLevel.TC128, plain modulus PlainModulus.batching(n, 20), "
             "chain expanded")
BFV_DIGEST = "4062ed8c6578304ce3911ff1ddfd1ced83bc00394dbd2ba74f3bd0722d1987b2"
BFV_MEDIUM_DIGEST = "ca5db221d01a3267e9311d613f70e5bece2f8341f04b59a25b86ad131bb4c0f1"
BGV_N = 8192
BGV_MEDIUM_N = 32768
BGV_GALOIS_SEED = 3
BGV_GALOIS_ELT = 3               # get_elt_from_step(1)
BGV_DIGEST = "3000863a542e67fd5dde075e02ccbbfe3a3e23d1773357f6c92f7d42abfdecc0"
BGV_CORRECTION_FACTOR = 366676
BGV_MEDIUM_DIGEST = "7f4c2fb0cbea6c2403110be9dc00423e97ea217a05461cc1cf75abfe0156078c"
BGV_MEDIUM_CORRECTION_FACTOR = 201238

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def splitmix64(seed: int, count: int) -> np.ndarray:
    """The first ``count`` outputs of splitmix64 started at ``seed``."""
    with np.errstate(over="ignore"):
        z = np.uint64(seed) + _GAMMA * np.arange(1, count + 1, dtype=np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
        return z ^ (z >> np.uint64(31))


def _residues(seed: int, moduli, lead: Tuple[int, ...], n: int) -> np.ndarray:
    """(*lead, k, n) uint64, element [..., i, :] reduced mod moduli[i]."""
    q = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
    count = int(np.prod(lead, dtype=np.int64)) * len(moduli) * n
    return splitmix64(seed, count).reshape(*lead, len(moduli), n) % q


def medium_context(device=None) -> SealContext:
    """The CKKS context of ``MEDIUM_DIGEST`` (``MEDIUM_CHAIN``), the chain of
    ``benchmarks/batched_32768.py``."""
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(MEDIUM_N)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(MEDIUM_N))
    return SealContext(parms, True, SecurityLevel.TC128, device=device)


def bfv_context(n: int, device=None) -> SealContext:
    """The BFV context of ``BFV_DIGEST`` (n=8192) and ``BFV_MEDIUM_DIGEST``
    (n=32768): ``BFV_CHAIN``, the repository's BFV workload
    (``benchmarks/run_all.py:58-66``)."""
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, BFV_PLAIN_BITS))
    return SealContext(parms, True, SecurityLevel.TC128, device=device)


def bgv_context(n: int, device=None) -> SealContext:
    """The BGV context of ``BGV_DIGEST`` (n=8192) and ``BGV_MEDIUM_DIGEST``
    (n=32768): ``BFV_CHAIN``'s chain and plain modulus as a BGV context, the
    repository's BGV configuration (``BASELINE.json`` configs[2])."""
    parms = EncryptionParameters(SchemeType.BGV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, BFV_PLAIN_BITS))
    return SealContext(parms, True, SecurityLevel.TC128, device=device)


def bgv_request(ev, ct1, ct2, relin_keys, galois_keys):
    """multiply -> relinearize -> rotate_rows(1) -> mod_switch_to_next, the
    BGV server request.  ``ev`` is an Evaluator or a BatchEvaluator, of
    either package: the method names are the same."""
    product = ev.relinearize(ev.multiply(ct1, ct2), relin_keys)
    return ev.mod_switch_to_next(ev.rotate_rows(product, 1, galois_keys))


def request_inputs(context: SealContext, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Two size-2 ciphertexts' data at the first level: (2, k, n) each;
    uniform residues, read as NTT form (CKKS) or coefficients (BFV)."""
    cd = context.first_context_data()
    n = cd.parms.poly_modulus_degree
    both = _residues(seed, cd.coeff_modulus_values, (2, 2), n)
    return both[0], both[1]


def key_inputs(context: SealContext, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A relinearization key's two components: (D, k_key, n) each."""
    D = len(context.first_context_data().parms.coeff_modulus)
    key_cd = context.key_context_data()
    n = key_cd.parms.poly_modulus_degree
    both = _residues(seed, key_cd.coeff_modulus_values, (2, D), n)
    return both[0], both[1]


def plain_inputs(context: SealContext, seed: int) -> np.ndarray:
    """An NTT-form plaintext's data at the first level: (k, n)."""
    cd = context.first_context_data()
    return _residues(seed, cd.coeff_modulus_values, (), cd.parms.poly_modulus_degree)


def galois_key_inputs(context: SealContext, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A Galois key's two components, for element 3 (a rotation by one
    step): (D, k_key, n) each."""
    return key_inputs(context, seed)


def linear_inputs(context: SealContext, request: int = 0):
    """The numpy inputs of request ``request`` of the linear-layer step:
    (ciphertext data (2, k, n), plaintext data (k, n), Galois key pair,
    relinearization key pair)."""
    ct, _ = request_inputs(context, GOLDEN_REQUEST_SEED + request)
    return (ct, plain_inputs(context, LINEAR_PLAIN_SEED), galois_key_inputs(context, LINEAR_GALOIS_SEED),
            key_inputs(context, GOLDEN_KEY_SEED))


def linear_layer_step(ev, ct, plain, galois_keys, relin_keys):
    """multiply_plain -> rotate_vector(1) -> multiply -> relinearize ->
    rescale_to_next (``benchmarks/batched_32768.py:70-78``).  ``ev`` is an
    Evaluator or a BatchEvaluator, of either package: the method names are
    the same."""
    rotated = ev.rotate_vector(ev.multiply_plain(ct, plain), 1, galois_keys)
    return ev.rescale_to_next(ev.relinearize(ev.multiply(rotated, ct), relin_keys))


def digest(out: np.ndarray) -> str:
    """SHA-256 of a uint64 array's little-endian bytes."""
    return hashlib.sha256(np.ascontiguousarray(out, dtype="<u8").tobytes()).hexdigest()

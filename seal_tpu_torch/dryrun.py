"""One sharded step of the port's multi-device layer, checked.

The twin of ``__graft_entry__.dryrun_multichip`` for what the port runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import golden, numth
from .context import SealContext
from .convert import ciphertext_from_numpy, galois_keys_from_numpy, relin_keys_from_numpy, u64_from_numpy
from .encoders import BatchEncoder
from .encryptor import Encryptor
from .evaluator import Evaluator
from .keygen import KeyGenerator
from .modulus import CoeffModulus, Modulus, PlainModulus, SecurityLevel
from .ntt_tables import build_four_step_tables, build_limb_tables
from .ops import ntt as NTT
from .params import EncryptionParameters, SchemeType
from .parallel.batch import BatchEvaluator, CiphertextBatch
from .parallel.dist_ntt import DistNTT
from .parallel.mesh import DeviceMesh, HEMesh, make_mesh
from .random import PRNGType, UniformRandomGeneratorFactory


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _batched_step(ctx: SealContext, hem: HEMesh, batch: int) -> None:
    """multiply -> relinearize -> rescale_to_next, and a rotation by one step
    (Galois element 3), over ``batch`` seeded requests, sharded over
    ``hem``, against the unsharded batch and the single-ciphertext
    evaluator."""
    device = ctx.device
    kc0, kc1 = golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)
    rk = relin_keys_from_numpy([(kc0, kc1)], ctx.key_parms_id, device)
    galois = [None] * ctx.key_context_data().parms.poly_modulus_degree
    galois[golden.LINEAR_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.LINEAR_GALOIS_SEED)
    gk = galois_keys_from_numpy(galois, ctx.key_parms_id, device)
    pairs = []
    for r in range(batch):
        d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)
        pairs.append(tuple(ciphertext_from_numpy(d, ctx.first_parms_id, True, 2.0 ** 30, device) for d in (d1, d2)))
    b1 = CiphertextBatch.from_ciphertexts([a for a, _ in pairs])
    b2 = CiphertextBatch.from_ciphertexts([b for _, b in pairs])

    def step(bev, x, y):
        return bev.rescale_to_next(bev.relinearize(bev.multiply(x, y), rk))

    sharded = BatchEvaluator(ctx, hem)
    got = step(sharded, sharded.shard(b1), sharded.shard(b2)).unshard()
    want = step(BatchEvaluator(ctx), b1, b2)
    _check(torch.equal(got.data, want.data), f"the batch on the {hem.mesh.shape} mesh differs from the unsharded batch")
    rot = sharded.apply_galois(sharded.shard(b1), golden.LINEAR_GALOIS_ELT, gk).unshard()
    _check(torch.equal(rot.data, BatchEvaluator(ctx).apply_galois(b1, golden.LINEAR_GALOIS_ELT, gk).data),
           f"the rotation on the {hem.mesh.shape} mesh differs from the unsharded batch")
    ev = Evaluator(ctx)
    for r, (a, b) in enumerate(pairs):
        single = ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk))
        _check(torch.equal(got.data[r], single.data) and got.scale == single.scale,
               f"request {r} of the batch differs from the single-ciphertext evaluator")
        _check(torch.equal(rot.data[r], ev.rotate_vector(a, 1, gk).data),
               f"rotated request {r} of the batch differs from the single-ciphertext evaluator")


def _bfv_step(hem: HEMesh, batch: int) -> None:
    """The sharded BFV part: the BEHZ square of ``batch`` encryptions and
    ``apply_galois(b, 3, gk)`` (a rotation by one step) at N=64, bits [40,
    30, 30, 30, 40], keys and encryptions from a seeded BLAKE2XB factory,
    each equal to the unsharded batch."""
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 30, 30, 30, 40]))
    parms.set_plain_modulus(PlainModulus.batching(64, 20))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, (9,) * 8))
    ctx = SealContext(parms, True, SecurityLevel.NONE, device=hem.mesh.device(0))
    kg = KeyGenerator(ctx)
    gk = kg.create_galois_keys([3])
    enc = Encryptor(ctx, secret_key=kg.secret_key)
    be = BatchEncoder(ctx)
    t = parms.plain_modulus.value
    cts = [enc.encrypt_symmetric(be.encode(np.arange(i, i + 64, dtype=np.uint64) % t)) for i in range(batch)]
    b = CiphertextBatch.from_ciphertexts(cts)
    sharded = BatchEvaluator(ctx, hem)
    one = BatchEvaluator(ctx)
    prod = sharded.multiply(sharded.shard(b), sharded.shard(b)).unshard()
    _check(torch.equal(prod.data, one.multiply(b, b).data),
           f"the BFV product on the {hem.mesh.shape} mesh differs from the unsharded batch")
    rot = sharded.apply_galois(sharded.shard(b), 3, gk).unshard()
    _check(torch.equal(rot.data, one.apply_galois(b, 3, gk).data),
           f"the BFV rotation on the {hem.mesh.shape} mesh differs from the unsharded batch")


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Run and check one sharded step over an ``n_devices``-rank mesh.

    ``devices`` places the ranks (a device may repeat, e.g. ``["cuda:0"] *
    8`` for 8 ranks on one card, or ``["cpu"] * 8``); without it each rank
    is a card of its own.  Three parts, each raising on a mismatch:

    1. the batched CKKS step (multiply -> relinearize -> rescale_to_next)
       and a rotation by one step (apply_galois, element 3) of 2 x (data
       ranks) seeded requests at N=64, bits [40, 30, 30, 30, 40], on a
       (n/2, 2) (data, limb) mesh, or (n, 1) for odd n, equal to the
       unsharded batch and to the single-ciphertext evaluator;
    2. the distributed NTT round trip at N=8192 with two 40-bit primes over
       a flat limb mesh of all the ranks (their number must divide n1 = 64),
       the forward transform equal to the single-device transform
       (``ops.ntt.forward``: kernel A on a card; the distributed one runs
       the stage and corner-turn kernels there);
    3. the sharded BFV multiply (a square) of 2 x (data ranks) seeded
       encryptions and ``apply_galois(b, 3, gk)`` on the mesh of part 1,
       each equal to the unsharded batch;
    4. for n >= 8 and n % 4 == 0, the batched CKKS step and the rotation on
       the (host=2, data, limb=2) mesh with replicated keys.
    """
    limb = 2 if n_devices % 2 == 0 else 1
    hem = make_mesh(n_devices, limb_parallel=limb, devices=devices)
    device = hem.mesh.device(0)

    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    # 4 data limbs, so the ciphertexts' limb axis splits over the limb axis of 2
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 30, 30, 30, 40]))
    ctx = SealContext(parms, True, SecurityLevel.NONE, device=device)
    _batched_step(ctx, hem, 2 * hem.batch_size)
    _bfv_step(hem, 2 * hem.batch_size)

    n_big = 8192
    mods = [Modulus(p) for p in numth.get_primes(2 * n_big, 40, 2)]
    log_n = n_big.bit_length() - 1
    ft = build_four_step_tables(log_n, mods, device=device)
    flat = DeviceMesh(list(hem.mesh.devices.ravel()), ("limb",))
    qv = np.array([m.value for m in mods], dtype=np.uint64)
    x = u64_from_numpy(np.random.default_rng(1).integers(0, qv[:, None], (2, n_big), dtype=np.uint64), device)
    dist = DistNTT(ft, flat)
    want = NTT.forward(x, build_limb_tables(log_n, mods, device=device))
    fwd = dist.forward(x)
    _check(torch.equal(fwd, want), "the distributed NTT differs from the single-device transform")
    _check(torch.equal(dist.inverse(fwd), x), "the distributed NTT round trip failed")

    if n_devices >= 8 and n_devices % 4 == 0:
        hem3 = make_mesh(n_devices, limb_parallel=2, hosts=2, replicate_keys=True, devices=devices)
        _check(hem3.host_axis == "host" and hem3.host_size == 2, "the 3-axis mesh lacks its host axis")
        _batched_step(ctx, hem3, hem3.batch_size)

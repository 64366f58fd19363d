#!/usr/bin/env python3
"""Drive the port's CKKS, BFV and BGV paths on one NVIDIA card, kernels checked.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (CUDA_HOME, default /usr/local/cuda) and
the repository's ``seal_tpu_torch`` package; it imports nothing of JAX or
``seal_tpu``.  Phases, each printing its lines:

1. setup: the card's name and power limit, torch and CUDA versions, the
   kernels built from ``seal_tpu_torch/csrc`` (seconds, ptxas registers);
2. kernel A (negacyclic NTT) against its plain PyTorch version on the card,
   bit-exact, at every shape and modulus set of the main path, the same
   calls batched over phase 8a's 8 requests, one N=16384 shape, and the six
   transforms of one request at N=32768 (one launch each), with the
   kernel's time by CUDA events and by the profiler's device time, and the
   plain version's;
3. kernel B (fused key-switch contraction, a thread block cluster per
   output row) against its plain version: D=4 with and without the
   diagonal, the next level's key trim, and D=66 at N=1024 (the Barrett
   guard every 64 summands), timed the same ways;
4. the slice: Evaluator multiply -> relinearize -> rescale_to_next for 8
   requests at CKKS N=8192, bits [60, 40, 40, 40, 60], equal to the plain
   path on the card, the first request equal to the golden digest of the
   JAX package's output, and the launch counters showing both kernels on
   every request; then ms per request, requests/s and a profiler split;
5. the four-step stage kernel against its plain version, bit-exact, at
   every stage shape of one N=65536 request (512/128 and 128/512, with and
   without the twiddle) and at N=32768 (256/128) and N=131072 (512/256),
   then whole four-step transforms on the card against the butterflies,
   with the kernel's time (events and profiler device time), the plain
   version's and the bound;
6. the staged key switch at N=65536 (D=3, Rn=4: the decompose and the
   contraction in plain PyTorch, the NTT on the stage kernel) against the
   plain version on the card;
7. a CKKS user's whole computation at N=65536, bits [60, 40, 40, 60], on a
   context on the card with a seeded BLAKE2XB factory: keygen, encode of
   two seeded vectors, encryption (secret key, and public key for one of
   them), 4 requests of multiply -> relinearize -> rescale_to_next, decrypt
   and decode; every key, ciphertext and plaintext equal to the same steps
   on the plain path on the card, the splitmix request equal to the JAX
   package's N=65536 digest, the decoded products within 1e-3, the stage
   kernel's launches counted per step (kernels A and B never run at this
   size); then the steps' times and a profiler split of the requests;
8. the multi-device layer (``seal_tpu_torch/parallel``), every rank of each
   8-rank mesh on this one card:
   (a) phase 4's 8 requests as one batch through ``BatchEvaluator``, without
       a mesh and on a (data 4, limb 2) mesh, bit-identical to phase 4's
       outputs and the golden digest; ms per request, launches per request
       (profiler), device-busy share, launches of kernels A and B per batch;
       kernel B's batched launch per request;
   (b) the distributed NTT at N=65536 over the 4 moduli of [60, 40, 40, 60],
       P=8, forward and inverse on the stage and corner-turn kernels,
       bit-identical to the single-card transform, the round trip giving the
       input back, against the single-card time;
   (c) the corner-turn kernel bit-exact against its plain version at (b)'s
       shapes in both directions and at P=2, r=1, timed against its plain
       version, one PyTorch permute+copy_ (its library yardstick) and its
       bound;
   (d) ``dryrun.dryrun_multichip(8, devices=[card] * 8)``;
9. the N=32768 server request on the default 128-bit chain
   (``golden.medium_context``: ``CoeffModulus.bfv_default(32768)``, 16
   moduli, ``SecurityLevel.TC128``; D=15, Rn=16), splitmix inputs:
   (a) the baseline first: 4 requests with the key switch forced to the
       staged formulation (the decompose and contraction in plain PyTorch,
       the NTT on kernel A), as the parent tree ran this size; ms and
       launches per request, the staged key switch's own device time;
   (b) kernel B bit-exact against its plain version at D=15, Rn=16, with
       and without the diagonal, at the next level (key rows trimmed) and
       batched over 4 ciphertexts; device time, events, plain, bound;
   (c) the 4 requests of Evaluator multiply -> relinearize ->
       rescale_to_next through kernel B, sequentially and as one
       ``BatchEvaluator`` batch: request 0 equal to the plain path on the
       card and to ``golden.MEDIUM_DIGEST``, the batch and the baseline
       equal to the sequential outputs, 1 launch of kernel B per request and
       per batch and none of the stage kernel; ms and launches per request,
       device-busy share and a profiler split;
10. one step of an encrypted linear layer at N=32768 on the same chain
   (``golden.linear_layer_step``: multiply_plain -> rotate_vector(1) ->
   multiply -> relinearize -> rescale_to_next, the inner loop of
   ``benchmarks/batched_32768.py``):
   (a) splitmix inputs (``golden.linear_inputs``): one request through
       ``Evaluator`` equal to the plain path on the card and to
       ``golden.LINEAR_DIGEST``; 4 requests sequentially and as one
       ``BatchEvaluator`` batch, the batch equal to the sequential outputs;
       2 launches of kernel B per request and per batch (the rotation's key
       switch and the relinearization's), 8 of kernel A (3 per key switch,
       2 for the rescale), none of the stage kernel; ms per ciphertext
       sequentially and batched, launches per ciphertext, device-busy share
       and a profiler split (kernel A, kernel B, the gathers, the rest);
   (b) real keys from a seeded BLAKE2XB factory: the secret key,
       ``create_relin_keys()`` and ``create_galois_keys_from_steps([1])``
       equal to the same calls on the plain path on the card;
       ``np.linspace(0, 1, N/2)`` encoded at 2^40, encrypted 4 times with
       the secret key, the step run as one batch, decrypted and decoded
       within 1e-3 of ``np.roll(v*v, -1) * v``;
   (c) ``mod_switch_to_next`` then ``rotate_vector(1)`` on the card (kernel
       B with the key's rows trimmed to the level), equal to the plain path;
11. BFV (``golden.bfv_context``: ``CoeffModulus.bfv_default(n)`` at
   ``SecurityLevel.TC128``, t = ``PlainModulus.batching(n, 20)``), at N=8192
   (k=4, a 5-prime Bsk, D=4, Rn=5) and N=32768 (k=15, 16, D=15, Rn=16):
   (a) kernel A bit-exact against its plain version at the BFV request's
       transforms (the BEHZ forward NTT over q U Bsk, the t-scaled inverse
       over q U Bsk, the key-switch tail's two inverse NTTs), one request's
       and a batch's; kernel B with no diagonal (a coefficient-form target)
       at D=4, Rn=5 and D=15, Rn=16, one ciphertext and a batch; times and
       bounds as in phases 2 and 3;
   (b, c) ``pipeline.build_bfv_mult_relin`` (the BEHZ multiply, then
       relinearization) on splitmix inputs equal to the plain path on the
       card and to ``golden.BFV_DIGEST`` / ``BFV_MEDIUM_DIGEST``; 8 requests
       at N=8192 (4 at N=32768) of Evaluator multiply -> relinearize
       sequentially and as one ``BatchEvaluator`` batch, the batch equal to
       the sequential outputs; kernel A 4 launches and kernel B 1 per request
       and per batch, no stage-kernel launch; ms per request, launches per
       request, device-busy share and a profiler split (kernel A, kernel B,
       the BEHZ base conversions timed alone, the rest);
   (d) real keys at N=8192 from a seeded BLAKE2XB factory (secret, public,
       relinearization, and Galois keys for rotate_rows(1) and
       rotate_columns) equal to the plain path on the card; two BatchEncoder
       vectors encrypted with the public key; multiply -> relinearize ->
       rotate_rows(1) -> rotate_columns -> mod_switch_to_next equal to the
       plain path, decoded equal to numpy's slot-wise product mod t with the
       rows rotated and the columns swapped; the invariant noise budget
       before and after, above 0;
12. BGV (``golden.bgv_context``: phase 11's chain and t as a BGV context),
   at N=8192 (k=4, D=4, Rn=5) and N=32768 (k=15, D=15, Rn=16):
   (a) kernel A bit-exact against its plain version at the BGV request's
       transforms (the key switch's inverse of the target, the tail's
       reduced inverse of the special-prime rows and forward of the
       correction, the mod-t switch's inverse mod q_last and forward of the
       correction), one request's and a batch's; kernel B with an NTT-form
       target and the diagonal, one ciphertext and a batch; times and
       bounds as in phases 2 and 3;
   (b) ``golden.bgv_request`` (multiply -> relinearize -> rotate_rows(1) ->
       mod_switch_to_next) on splitmix inputs equal to the plain path on the
       card, to ``golden.BGV_DIGEST`` / ``BGV_MEDIUM_DIGEST`` and their
       correction factors; 8 requests at N=8192 (4 at N=32768) sequentially
       and as one ``BatchEvaluator`` batch, the batch equal to the
       sequential outputs; kernel A 8 launches and kernel B 2 per request
       and per batch, no stage-kernel launch; ms per request, launches per
       request, device-busy share and a profiler split;
   (c) real keys at N=8192 from a seeded BLAKE2XB factory equal to the
       plain path on the card; three BatchEncoder vectors a, b, c encrypted
       with the public key; x, y = mod_switch_to_next(enc a, enc b), z =
       relinearize(multiply(x, y)) (correction factor f^2), w = add(z,
       mod_switch_to_next(enc c)) (factor f: the balancing path), then
       rotate_rows(1) and rotate_columns, equal to the plain path, decoded
       equal to numpy's (a b + c) mod t with the rows rotated and the
       columns swapped; the noise budget fresh and at the end, above 0.
13. The wire path (``serialization.py``, ``valcheck.py``; zstd only where
   the ``zstandard`` module imports, and the modes that ran are printed):
   (a) Microsoft SEAL's blobs (``tests/data/wire``) on the card: contexts
       from the four parameter blobs with the blobs' fixed seed; the port's
       fixed-seed secret keys, the BFV public, relinearization and Galois
       keys and the N=4096 public and Galois keys, made on the card, equal
       to the blobs byte for byte; every object loaded onto the card and
       checked with ``valcheck.is_valid_for`` (key rows as public keys);
       the BFV ciphertexts (full, seeded, compressed, the product) and the
       BGV ones decrypt to the manifest, the BFV product through the
       loaded relinearization keys (full and seeded) and rotations through
       the loaded Galois keys (N=64 full and seeded, N=4096) give its
       slots, the CKKS ones decode within 1e-3; kernels A and B counted;
   (b) the linear-layer step at N=32768 on ``bfv_default(32768)``, TC128,
       over the wire: a client on the card (seeded BLAKE2XB keygen,
       relinearization and Galois keys with ``save_seed``, 4
       ``encrypt_symmetric(save_seed=True)`` and a weight plaintext) saves
       every object in every mode (the bytes and the save ms printed); a
       server builds its context from the parameters' bytes, loads and
       checks every object (ms split into decompression, seed expansion,
       host-to-device copy, valcheck and the rest), each loaded object
       equal to the saved one; 4 requests served bytes in to bytes out and
       as one batch, every reply equal to serving the client's in-memory
       objects, kernel A 8 and kernel B 2 launches per request and per
       batch; ms per request over the wire against in memory; the client
       decrypts the replies (``decrypt`` of each equal to ``decrypt_batch``,
       both timed) and decodes them within 1e-3 of numpy;
   (c) ``Evaluator(ctx, throw_on_transparent=False)``: the same replies,
       its ms per request beside the default's.

14. Device sampling (``ops/blake2_dev.py``: kernel C, the BLAKE2xb stream,
   ``csrc/blake2xb.cu``; kernel D, the uniform sampler's bulk pass and the
   CBD noise, ``csrc/sample.cu``), with a BLAKE2XB factory that hands out
   a distinct seed per draw from seeded numpy, replayed for each path:
   (a) kernels C and D bit-exact against their plain versions at the calls
       of one relinearization key at N=8192 ([60, 40, 40, 40, 60]: D=4
       streams, k_key=5) and at N=32768 (``bfv_default(32768)``: D=15,
       k_key=16), kernel C's first and last streams equal to the host
       BLAKE2xb stream; per call, the profiler's mean device operation
       times the operations a call records (kernel C's root and node
       passes, the bulk pass's zero fill of its counts and its kernel, the
       CBD pass), and back-to-back calls by events; plain time and bound;
   (b) relinearization keys (with and without ``save_seed``, their D
       public seeds distinct), a Galois key and a seeded public key at
       N=8192 and N=32768 on the device path equal to the host path
       (``SEAL_TPU_DEVICE_SAMPLING=0``) byte for byte, 2 launches of kernel
       C (each two kernels) and 1 of each entry point of kernel D per key,
       no draw redone on the host; ``create_relin_keys()``,
       ``create_galois_keys_from_steps([1])`` and one ``encrypt_symmetric``
       at N=8192, 32768 and 65536 timed on both paths, interleaved;
   (c) an N=32768 ``encrypt_symmetric(save_seed=True)`` equal to the host
       path's, saved and loaded through ``serialization.py`` (its c1
       expanded from the seed on the host) equal to the one in memory.
   Keygen and symmetric encryption run through kernels C and D in every
   phase; phases 7, 10(b), 11(d), 12(c) and 13 print their launches in the
   counted run and fail if either kernel ran no time.
15. BFV and BGV on an 8-rank mesh of the card, and the tooling:
   (a) ``build_bfv_mult_relin``'s requests (phase 11's; 8 at N=8192, 4 at
       N=32768, whose 15 limbs split 8 + 7) as one ``BatchEvaluator`` batch
       on a (data 4, limb 2) mesh: equal to phase 11's batch outputs and
       request 0 to ``BFV_DIGEST`` / ``BFV_MEDIUM_DIGEST``, 32 launches of
       kernel A and 8 of B per batch (worked out from the code: a rank's
       BEHZ transforms, 2, and its key-switch tail, 2; its contraction, 1),
       ms and launches per request and the device-busy share;
   (b) ``golden.bgv_request`` the same way: equal to phase 12's outputs and
       correction factors and to ``BGV_DIGEST`` / ``BGV_MEDIUM_DIGEST``, the
       switch re-splitting 15 -> 14 limbs (7 + 7), 64 launches of A and 16
       of B per batch (a rank's two key switches, 3 each, and its mod-t
       switch, 2; its two contractions);
   (c) N=8192 BFV on a (host 2, data 2, limb 2) mesh with replicated keys:
       multiply, rotate_rows(1) and a request equal to the unsharded batch
       and phase 11; then ``dryrun.dryrun_multichip(8, devices=[card] * 8)``
       with its BFV part;
   (d) ``SEAL_TPU_DEBUG=1``: phase 4's request 0 and phase 11's pass every
       range check with their outputs and launches unchanged, the checked
       run's ms printed beside the unchecked;
   (e) the seven example twins (``seal_tpu_torch/examples/``) on the card,
       each to its asserts;
   (f) ``profiling.device_time_us`` (CUDA events around bursts of calls) of
       kernel C's and the bulk pass's N=32768 calls beside phase 14(a)'s
       profiler device time.

The line before the last is a JSON object of the kernels' numbers; the last
is ``{"ok": true, "device": {...}}``.  Any mismatch, build failure or launch
error raises before those lines, and the exit code is not 0.  Without a
CUDA device it exits with code 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores, taken here as the rate of 32-bit
# integer operations.  The card issues INT32 at no more than that rate, so a
# bound computed with it is a lower bound on the time.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# 32-bit operations counted per u64 operation: a 64x64-bit multiply (low or
# high half) takes four 32x32-bit partial products; an add, subtract or
# compare-and-select takes two.
OPS_MUL64 = 4
OPS_ADD64 = 2
# One Harvey butterfly: three u64 multiplies (Shoup) and six adds,
# subtracts and conditional subtractions.
OPS_BUTTERFLY = 3 * OPS_MUL64 + 6 * OPS_ADD64
# One BLAKE2b compression: 12 rounds of 8 G steps, each 6 u64 adds, 4 xors
# and 3 rotations of two funnel shifts (the rotation by 32 is a register
# swap), then 16 xors into the state; an xor counts as an add.
OPS_COMPRESS = 12 * 8 * 13 * OPS_ADD64 + 16 * OPS_ADD64
# the numpy seed of phase 14's factories, which hand out a new seed per draw
SAMPLING_SEED = 51
# the seeds of phase 11's and phase 12's slot vectors
BFV_SLOT_SEED = 11
BGV_SLOT_SEED = 12
# phase 13: Microsoft SEAL's blobs (tests/data/wire) and their fixed PRNG
# seed; the wire client's factory seed and the seed of its slot vectors
WIRE_DATA = os.path.join(ROOT, "tests", "data", "wire")
WIRE_SEED = tuple(0x1111111111111111 * (i + 1) for i in range(8))
WIRE_CLIENT_SEED = (41, 42, 43, 44, 45, 46, 47, 48)
WIRE_SLOT_SEED = 13


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, launches=None, attempts=3, recorded=None):
    """Device time of fn() per call from a profiler run of iters calls.
    With ``launches`` (the device operations one call records), the mean
    duration of the operations the trace recorded times that count, so an
    operation missing from the trace does not lower it; without, every
    recorded operation summed over iters.  A run that recorded no device
    time is repeated, up to ``attempts`` runs; None if none did.  A dict
    ``recorded`` gets the count of operations the trace held."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if recorded is not None:
            recorded["events"] = recorded.get("events", 0) + len(events)
        if events:
            total_us = sum(e.time_range.elapsed_us() for e in events)
            if launches is not None:
                return total_us / len(events) * launches / 1e3
            return total_us / iters / 1e3
    return None


def kernel_ms(fn, iters, launches=1, recorded=None):
    """(device ms, events ms) per call of fn(), which records ``launches``
    device operations (a kernel, or for instance two kernels, or a fill and
    a kernel): the profiler's device time (the card's work), else, where
    the profiler recorded none, the events' time; and back-to-back calls
    timed by CUDA events, which the host paces once its launch path
    outlasts the kernel.  ``recorded``: as for :func:`device_ms`."""
    events = cuda_ms(fn, iters)
    dev = device_ms(fn, min(iters, 50), launches=launches, recorded=recorded)
    return (events if dev is None else dev), events


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ntt_work(rows, k, log_n):
    """Bytes and 32-bit operations of one NTT call over rows x n."""
    n = 1 << log_n
    nbytes = 8 * (2 * rows * n + 2 * k * n)          # data in and out, one table pair
    ops = rows * (log_n * (n // 2) * OPS_BUTTERFLY + n * 2 * OPS_ADD64)
    return nbytes, ops


def switch_key_work(D, key_rows, Rn, log_n, diag, B=1):
    """Bytes and 32-bit operations of one kernel-B call over B ciphertexts:
    their rows in (t_c, and t_n with the diagonal), the key's 2 D rows of Rn
    limbs once, the (Rn, n) root table pair, B outputs of 2 Rn rows."""
    n = 1 << log_n
    nbytes = 8 * n * (B * D * (2 if diag else 1) + 2 * D * Rn + 2 * Rn + B * 2 * Rn)
    ntts = D * Rn - (D if diag else 0)
    ops = ntts * log_n * (n // 2) * OPS_BUTTERFLY
    # per (j, i, coefficient): Barrett-64 (2 mul, 2 add), two guards, two
    # 64x64->128 products and two u128 adds; per output: Barrett-128
    ops += D * Rn * n * (2 * OPS_MUL64 + 2 * OPS_ADD64 + 2 * OPS_ADD64 + 2 * OPS_MUL64 + 4 * OPS_ADD64)
    ops += 2 * Rn * n * (5 * OPS_MUL64 + 8 * OPS_ADD64)
    return nbytes, B * ops


def stage_work(rows, k, spec, twiddle):
    """Bytes and 32-bit operations of the FUNCTION one stage computes: an
    M-point transform of every column (its butterflies), plus the twiddle.
    Bytes: the data in and out, the twiddle pair, and a root table pair of
    M entries per limb, the same rule as kernel A's.  The kernel's dense
    product reads the (k, M, K) matrix and does M*K multiply-adds per column
    instead, but a faster design is held to the same yardstick."""
    n = spec.M * spec.ncols
    nbytes = 8 * (2 * rows * n + 2 * k * spec.M + (2 * k * n if twiddle else 0))
    log_m = spec.M.bit_length() - 1
    ops = rows * spec.ncols * (spec.M // 2) * log_m * OPS_BUTTERFLY
    if twiddle:
        ops += rows * n * (3 * OPS_MUL64 + 2 * OPS_ADD64)
    return nbytes, ops


def device_split(prof, names):
    """Device microseconds by kernel-name group from a profiler run."""
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    groups = {g: sum(v for name, v in by_name.items() if key in name) for g, key in names.items()}
    return by_name, groups


def lazy_input(t, shape, factor, gen):
    """Uniform values in [0, factor * q) per limb, on the card."""
    bound = t.q * factor                                   # (k, 1)
    raw = torch.randint(0, 1 << 62, shape, dtype=torch.int64, device="cuda", generator=gen)
    return raw % bound


def profile_run(fn):
    """(wall ms, device launches, device busy ms) of one profiled call; the
    last two None when the profiler recorded no device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return wall_ms, None, None
    return wall_ms, len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


# launches of kernels C and D (blake2xb, sample_uniform, sample_cbd) in each
# phase's counted keygen or client run, for the kernels' JSON line
SAMPLING = {}


def sampling_launches():
    """The launch counters of kernels C and D: (C, D uniform, D CBD)."""
    from seal_tpu_torch.ops.cuda_blake2 import cbd_lifted_cuda, expand_stream_words_cuda, uniform_bulk_cuda
    return expand_stream_words_cuda.launches, uniform_bulk_cuda.launches, cbd_lifted_cuda.launches


def sampled(phase, fn):
    """fn()'s result; its launches of kernels C and D go to SAMPLING[phase],
    and a run that launched either kernel no time fails."""
    before = sampling_launches()
    out = fn()
    counts = tuple(a - b for a, b in zip(sampling_launches(), before))
    SAMPLING[phase] = {"blake2xb": counts[0], "sample_uniform": counts[1], "sample_cbd": counts[2]}
    check(min(counts) > 0, f"phase {phase}: keygen and encryption launched kernels C and D (C, D uniform, D CBD) "
                           f"{counts} times")
    print(f"[sampling] phase {phase}: kernel C {counts[0]} launches, kernel D {counts[1]} (uniform) and "
          f"{counts[2]} (CBD)")
    return out


def multi_device_phase(dev, ctx, cts, rk, seq_outs, big_t, gen):
    """Phase 8: the batched server, the distributed NTT and the corner-turn
    kernel, every rank of each 8-rank mesh on ``dev``.  Returns the corner
    turn's entry of the kernels' JSON line and kernel B's batched time."""
    from seal_tpu_torch import dryrun, golden
    from seal_tpu_torch.convert import u64_to_numpy
    from seal_tpu_torch.ntt_tables import four_step_tables_for
    from seal_tpu_torch.ops import ntt as NTT
    from seal_tpu_torch.ops.cuda_corner_turn import corner_turn_cuda
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
    from seal_tpu_torch.parallel.dist_ntt import DistNTT
    from seal_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
    from seal_tpu_torch.parallel.remote_ntt import corner_turn_plain

    ranks = [dev] * 8
    requests = len(cts)

    # (a) the batched server at N=8192
    hem = make_mesh(8, limb_parallel=2, devices=ranks)
    servers = {"one batch": BatchEvaluator(ctx), "(data 4, limb 2) mesh": BatchEvaluator(ctx, hem)}
    expect = {"one batch": (5, 1), "(data 4, limb 2) mesh": (40, 8)}   # kernel A, kernel B per batch

    def serve(bev):
        b1 = bev.shard(CiphertextBatch.from_ciphertexts([a for a, _ in cts]))
        b2 = bev.shard(CiphertextBatch.from_ciphertexts([b for _, b in cts]))
        return bev.rescale_to_next(bev.relinearize(bev.multiply(b1, b2), rk)).unshard()

    for label, bev in servers.items():
        serve(bev)                                     # warm-up: plans and tables
        torch.cuda.synchronize()
        ntt_cuda.launches = switch_key_contract_cuda.launches = 0
        stage_cuda.launches = corner_turn_cuda.launches = 0
        out = serve(bev)
        torch.cuda.synchronize()
        a_n, b_n = ntt_cuda.launches, switch_key_contract_cuda.launches
        check((a_n, b_n) == expect[label] and stage_cuda.launches == corner_turn_cuda.launches == 0,
              f"batched server, {label}: launches A {a_n}, B {b_n}, stage {stage_cuda.launches}, "
              f"corner turn {corner_turn_cuda.launches}; expected A, B = {expect[label]}")
        for r in range(requests):
            check(torch.equal(out.data[r], seq_outs[r].data) and out.scale == seq_outs[r].scale
                  and out.parms_id == seq_outs[r].parms_id,
                  f"batched server, {label}: request {r} differs from phase 4's")
        dig = golden.digest(u64_to_numpy(out.data[0]))
        check(dig == golden.GOLDEN_DIGEST, f"batched server, {label}: golden digest mismatch {dig}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            serve(bev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / requests)
        wall, n_dev, busy = profile_run(lambda: serve(bev))
        prof_line = ("the profiler recorded no device time: not measured" if n_dev is None else
                     f"under the profiler {n_dev / requests:.1f} device launches per request, device busy "
                     f"{busy:.3f} ms of {wall:.3f} ms ({100 * busy / wall:.1f}% of wall)")
        print(f"[batched server] {label}: {requests} requests bit-identical to phase 4 and the golden digest; "
              f"kernel A {a_n} and kernel B {b_n} launches per batch; ms per request over 3 runs "
              f"{', '.join(f'{t:.3f}' for t in times)} (median {sorted(times)[1]:.3f}); {prof_line}")

    plan = servers["one batch"].ev._plan(ctx.first_context_data())
    D, n = plan.D, ctx.first_context_data().parms.poly_modulus_degree
    Rn = plan.sel_tables.q.shape[0]
    level_t = ctx.first_context_data().limb_tables()
    t_n = lazy_input(level_t, (requests, D, n), 1, gen)
    t_c = NTT.ntt_inverse(t_n, level_t)
    key = lazy_input(plan.sel_tables, (2, D, Rn, n), 1, gen)
    batched = switch_key_contract_cuda(t_c, t_n, key, plan.sel_tables, plan.need_reduce)
    for r in range(requests):
        check(torch.equal(batched[r], switch_key_contract_cuda(t_c[r], t_n[r], key, plan.sel_tables,
                                                               plan.need_reduce)),
              f"kernel B's batched launch differs from its single launch on request {r}")
    sk_batch_ms = cuda_ms(lambda: switch_key_contract_cuda(t_c, t_n, key, plan.sel_tables, plan.need_reduce), 50)
    sk_one_ms = cuda_ms(lambda: switch_key_contract_cuda(t_c[0], t_n[0], key, plan.sel_tables, plan.need_reduce), 50)
    print(f"[batched server] kernel B, one launch for {requests} requests (D={D}, Rn={Rn}, N={n}): equal to "
          f"{requests} single launches; {sk_batch_ms * 1e3:.2f} us per launch, {sk_batch_ms * 1e3 / requests:.2f} "
          f"us per request (single launch {sk_one_ms * 1e3:.2f} us)")

    # (b) the distributed NTT
    ft = four_step_tables_for(big_t)
    k, n_big = big_t.q.shape[0], 1 << big_t.log_n
    dist = DistNTT(ft, DeviceMesh(ranks, ("limb",)))
    x = lazy_input(big_t, (k, n_big), 4, gen)
    want = NTT.forward(x, big_t)
    x_red = torch.where(x >= 2 * big_t.q, x - 2 * big_t.q, x) % big_t.q
    ntt_cuda.launches = switch_key_contract_cuda.launches = 0
    stage_cuda.launches = corner_turn_cuda.launches = 0
    fwd = dist.forward(x)
    back = dist.inverse(fwd)
    torch.cuda.synchronize()
    turn_launches, dist_stages = corner_turn_cuda.launches, stage_cuda.launches
    check(torch.equal(fwd, want), "the distributed NTT differs from the single-card transform")
    check(torch.equal(back, x_red) and torch.equal(back, NTT.inverse(want, big_t)),
          "the distributed NTT round trip does not give the input back")
    check(turn_launches == 2 and dist_stages == 32,
          f"the round trip launched the corner turn {turn_launches} and the stage kernel {dist_stages} "
          f"times; expected 2 and 32")
    dist_ms = (cuda_ms(lambda: dist.forward(x), 10), cuda_ms(lambda: dist.inverse(fwd), 10))
    one_ms = (cuda_ms(lambda: NTT.forward(x, big_t), 10), cuda_ms(lambda: NTT.inverse(want, big_t), 10))
    cols = dist.split_columns(x)
    core_ms = cuda_ms(lambda: dist.forward_shards(cols), 10)
    print(f"[distributed NTT] N={n_big}, {k} moduli, P=8 ranks (n1={ft.n1}, n2={ft.n2}: {dist.cols}-column and "
          f"{dist.rows}-row shards): forward and inverse bit-identical to the single-card transform, the round "
          f"trip gives the input back; round trip: {turn_launches} corner-turn and {dist_stages} stage launches")
    print(f"[distributed NTT] forward {dist_ms[0] * 1e3:.1f} us, inverse {dist_ms[1] * 1e3:.1f} us (split and join "
          f"included); single card: forward {one_ms[0] * 1e3:.1f} us, inverse {one_ms[1] * 1e3:.1f} us; "
          f"the forward on shards alone {core_ms * 1e3:.1f} us (CUDA events around back-to-back calls)")
    dist_dev = {"forward": device_ms(lambda: dist.forward(x), 5), "inverse": device_ms(lambda: dist.inverse(fwd), 5),
           "forward on shards": device_ms(lambda: dist.forward_shards(cols), 5),
           "single-card forward": device_ms(lambda: NTT.forward(x, big_t), 5),
           "single-card inverse": device_ms(lambda: NTT.inverse(want, big_t), 5)}
    print("[distributed NTT] device time per call (profiler, every kernel summed, copies included): "
          + ", ".join(f"{name} {'not measured' if v is None else f'{v * 1e3:.1f} us'}" for name, v in dist_dev.items()))

    # (c) the corner-turn kernel
    P, r, c = 8, dist.rows, dist.cols
    h = [a.view(k, P, r, c) for a in dist.split_columns(x)]          # (b)'s forward shape, any values
    ht = [a.view(k, r, P, c) for a in dist.split_rows(x)]             # (b)'s inverse shape
    cases = {
        "forward": (h, lambda: [torch.empty((k, r, P, c), dtype=torch.int64, device=dev) for _ in range(P)],
                    lambda d: d),
        "inverse": ([a.transpose(1, 2) for a in ht],
                    lambda: [torch.empty((k, P, r, c), dtype=torch.int64, device=dev) for _ in range(P)],
                    lambda d: d.transpose(1, 2)),
    }
    odd = [torch.randint(0, 1 << 62, (k, 2, 1, 5), dtype=torch.int64, device=dev, generator=gen)
           for _ in range(2)]                                             # P=2, r=1, c odd: 8-byte stores
    got, ref = ([torch.empty((k, 1, 2, 5), dtype=torch.int64, device=dev) for _ in range(2)] for _ in range(2))
    corner_turn_cuda(odd, got)
    corner_turn_plain(odd, ref)
    torch.cuda.synchronize()
    max_err = max(int((a - b).abs().max()) for a, b in zip(got, ref))
    check(max_err == 0, f"the corner turn disagrees with its plain version at P=2, r=1: max abs err {max_err}")
    print("[corner turn] P=2, r=1, c=5 (4, 2, 1, 5) x 2 ranks: bit-exact")
    turn = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    for label, (srcs, make, view) in cases.items():
        bufs, refs = make(), make()
        dsts, ref_dsts = [view(b) for b in bufs], [view(b) for b in refs]
        corner_turn_cuda(srcs, dsts)
        corner_turn_plain(srcs, ref_dsts)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(bufs, refs))
        check(err == 0, f"the corner turn disagrees with its plain version ({label}): max abs err {err}")
        max_err = max(max_err, err)
        # A launch's host side (the wrapper's checks, ctypes) outlasts the
        # copy, so back-to-back launches timed by events measure the host;
        # the profiler's kernel durations give the device time.
        paced = {"kernel": cuda_ms(lambda: corner_turn_cuda(srcs, dsts), 200),
                 "plain": cuda_ms(lambda: corner_turn_plain(srcs, ref_dsts), 200)}
        ms = device_ms(lambda: corner_turn_cuda(srcs, dsts), 50, launches=1)
        plain_ms = device_ms(lambda: corner_turn_plain(srcs, ref_dsts), 50)
        # the library yardstick: every rank's tensor stacked on the card, one permute + copy_
        stacked = torch.stack([s.contiguous() if label == "forward" else s.transpose(1, 2).contiguous()
                               for s in srcs])
        whole = torch.stack(bufs)
        perm = (2, 1, 3, 0, 4) if label == "forward" else (3, 1, 0, 2, 4)
        whole.copy_(stacked.permute(*perm))
        check(all(torch.equal(whole[j], bufs[j]) for j in range(P)), f"permute + copy_ differs ({label})")
        paced["permute+copy_"] = cuda_ms(lambda: whole.copy_(stacked.permute(*perm)), 200)
        lib_ms = device_ms(lambda: whole.copy_(stacked.permute(*perm)), 50, launches=1)
        if ms is None or plain_ms is None or lib_ms is None:
            print("[corner turn] the profiler recorded no device time: the times below are host-paced")
            ms, plain_ms, lib_ms = paced["kernel"], paced["plain"], paced["permute+copy_"]
        nbytes = 2 * 8 * k * P * r * c * P                               # every element read once, written once
        b, _ = bound_ms(nbytes, 0)
        print(f"[corner turn] {label} {tuple(srcs[0].shape)} x {P} ranks: bit-exact; device time per call: kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.1f} us, permute+copy_ {lib_ms * 1e3:.2f} us, bound "
              f"{b * 1e3:.3f} us (bytes); back-to-back calls timed by events: "
              + ", ".join(f"{name} {t * 1e3:.2f} us" for name, t in paced.items()))
        turn["ms"] += ms
        turn["plain_ms"] += plain_ms
        turn["library_ms"] += lib_ms
        turn["bytes"] += nbytes

    # (d) the dryrun
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(8, devices=ranks)
    torch.cuda.synchronize()
    print(f"[dryrun] dryrun_multichip(8, devices=[{str(dev)!r}] * 8): OK in {time.perf_counter() - t0:.1f} s")

    b_turn, by_turn = bound_ms(turn["bytes"], 0)
    entry = {"name": "corner_turn", "route": "cuda", "source": "seal_tpu_torch/csrc/corner_turn.cu",
             "replaces": "seal_tpu/parallel/remote_ntt.py:35", "launches": turn_launches,
             "max_abs_err": max_err, "ms": turn["ms"], "plain_ms": turn["plain_ms"], "bound_ms": b_turn,
             "bound_by": by_turn, "library_ms": turn["library_ms"]}
    return entry, sk_batch_ms / requests


def medium_phase(gen):
    """Phase 9: the N=32768 server request on the default 128-bit chain.
    Returns kernel B's numbers at this size for the kernels' JSON line."""
    from seal_tpu_torch import golden
    from seal_tpu_torch.convert import ciphertext_from_numpy, relin_keys_from_numpy, u64_to_numpy
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.ops import cuda_switch_key as SK
    from seal_tpu_torch.ops import ntt as NTT
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch

    kernel_b = SK.switch_key_contract_cuda
    ctx = golden.medium_context()                        # the default device: the card
    cd = ctx.first_context_data()
    n = golden.MEDIUM_N
    requests = 4
    scale = 2.0 ** 40
    t0 = time.perf_counter()
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, "cuda")
    cts = []
    for r in range(requests):
        d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)
        cts.append((ciphertext_from_numpy(d1, ctx.first_parms_id, True, scale, "cuda"),
                    ciphertext_from_numpy(d2, ctx.first_parms_id, True, scale, "cuda")))
    torch.cuda.synchronize()
    ev = Evaluator(ctx)
    plan = ev._plan(cd)
    D, sel = plan.D, plan.sel_tables
    Rn = sel.q.shape[0]
    print(f"[medium] N={n}, {golden.MEDIUM_CHAIN}: D={D}, Rn={Rn}; splitmix key and {requests} request pairs "
          f"made and copied to the card in {time.perf_counter() - t0:.1f} s")

    def serve():
        return [ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk)) for a, b in cts]

    groups = {"kernel A forward": "ntt_forward_kernel", "kernel A inverse": "ntt_inverse_kernel",
              "kernel B": "switch_key_kernel"}

    def measure(label, fn, count):
        """Warm-up, one counted run, 3 timed runs, one profiled run: the
        outputs, the launches of A, B and the stage kernel, and the times."""
        fn()
        torch.cuda.synchronize()
        ntt_cuda.launches = kernel_b.launches = stage_cuda.launches = 0
        outs = fn()
        torch.cuda.synchronize()
        launches = (ntt_cuda.launches, kernel_b.launches, stage_cuda.launches)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / count)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, split = device_split(prof, groups)
        n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        if by_name:
            busy = sum(by_name.values()) / 1e3
            prof_line = (f"under the profiler {n_dev / count:.1f} device launches per request, device busy "
                         f"{busy / count:.3f} ms per request, {100 * busy / wall_ms:.1f}% of wall; per request "
                         + ", ".join(f"{g} {v / 1e3 / count:.4f} ms" for g, v in split.items())
                         + f", other kernels (plain PyTorch elementwise arithmetic, copies) "
                         f"{(busy - sum(split.values()) / 1e3) / count:.3f} ms")
        else:
            prof_line = "the profiler recorded no device time: not measured"
        print(f"[medium] {label}: launches for {count} requests: kernel A {launches[0]}, kernel B {launches[1]}, "
              f"stage kernel {launches[2]}; ms per request over 3 runs "
              f"{', '.join(f'{t:.3f}' for t in times)} (median {sorted(times)[1]:.3f}); {prof_line}")
        return outs, launches

    # (a) the baseline: the parent's path at this size, the key switch
    # forced to the staged formulation (kernel B's range cut to n <= 16384
    # for this block only)
    level_t = cd.limb_tables()
    t_n = lazy_input(level_t, (D, n), 1, gen)
    t_c = NTT.ntt_inverse(t_n, level_t)
    key = lazy_input(sel, (2, D, Rn, n), 1, gen)
    kernel_range = SK.MAX_LOG_N
    SK.MAX_LOG_N = 14
    try:
        staged_outs, staged_launches = measure("baseline, the staged key switch", serve, requests)
        check(staged_launches[1] == 0, "the baseline launched kernel B")
        staged_fn = lambda: SK.switch_key_contract(t_c, t_n, key, sel, plan.need_reduce)
        staged = staged_fn()
        staged_events = cuda_ms(staged_fn, 5, warmup=1)
        staged_wall, staged_n, staged_busy = profile_run(staged_fn)
    finally:
        SK.MAX_LOG_N = kernel_range
    staged_line = ("the profiler recorded no device time: not measured" if staged_n is None else
                   f"device time {staged_busy * 1e3:.1f} us in {staged_n} launches, wall {staged_wall * 1e3:.1f} us")
    print(f"[medium] baseline: the staged key switch alone (D={D}, Rn={Rn}, N={n}): {staged_line}; "
          f"{staged_events * 1e3:.1f} us a call back to back by events")

    # (b) kernel B against its plain version
    check(torch.equal(kernel_b(t_c, t_n, key, sel, plan.need_reduce), staged),
          "kernel B differs from the staged key switch at N=32768")
    nxt = cd.next_context_data
    nplan = ev._plan(nxt)
    nt = nxt.limb_tables()
    nt_n = lazy_input(nt, (nplan.D, n), 1, gen)
    bt_n = lazy_input(level_t, (requests, D, n), 1, gen)
    cases = [("the request's call", t_c, t_n, key, sel, plan.need_reduce, True),
             ("no diagonal", t_c, None, key, sel, plan.need_reduce, False),
             ("next level, key trimmed", NTT.ntt_inverse(nt_n, nt), nt_n,
              lazy_input(nplan.sel_tables, (2, D, Rn - 1, n), 1, gen), nplan.sel_tables, nplan.need_reduce, True),
             (f"batch of {requests}", NTT.ntt_inverse(bt_n, level_t), bt_n, key, sel, plan.need_reduce, True)]
    result = {}
    max_err = 0
    for label, c_, n_, k_, t_, need, diag in cases:
        fn = lambda: kernel_b(c_, n_, k_, t_, need)
        got = fn()
        want = SK.switch_key_contract_plain(c_, n_, k_, t_, need)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"kernel B disagrees with its plain version at N={n}, {label}: max abs err {err}")
        max_err = max(max_err, err)
        ms, events_ms = kernel_ms(fn, 20)
        plain_ms = cuda_ms(lambda: SK.switch_key_contract_plain(c_, n_, k_, t_, need), 2, warmup=1)
        B = c_.shape[0] if c_.dim() == 3 else 1
        nbytes, ops = switch_key_work(c_.shape[-2], k_.shape[1], t_.q.shape[0], cd.log_n, diag, B)
        b, by = bound_ms(nbytes, ops)
        print(f"[medium] kernel B, {label} (B={B}, D={c_.shape[-2]}, key rows {k_.shape[1]}, Rn={t_.q.shape[0]}): "
              f"bit-exact; kernel {ms * 1e3:.2f} us device time ({ms * 1e3 / B:.2f} us per ciphertext), "
              f"{events_ms * 1e3:.2f} us back to back by events; plain {plain_ms * 1e3:.1f} us by events; bound "
              f"{b * 1e3:.3f} us ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G 32-bit operations)")
        if not result:
            result = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "max_abs_err": 0}
    result["max_abs_err"] = max_err
    result["staged_ms"] = None if staged_n is None else staged_busy

    # (c) the requests through kernel B
    with NTT.plain_on_card():
        ref0 = ev.rescale_to_next(ev.relinearize(ev.multiply(*cts[0]), rk))
    outs, launches = measure("kernel B, sequential", serve, requests)
    check(launches[1] == requests and launches[2] == 0,
          f"sequential requests launched kernel B {launches[1]} and the stage kernel {launches[2]} times; "
          f"expected {requests} and 0")
    check(torch.equal(outs[0].data, ref0.data), "request 0 differs from the plain path on the card")
    check(tuple(outs[0].data.shape) == (2, D - 1, n) and outs[0].parms_id == cd.next_context_data.parms_id,
          "request 0: wrong shape or level")
    dig = golden.digest(u64_to_numpy(outs[0].data))
    check(dig == golden.MEDIUM_DIGEST, f"N={n} golden digest mismatch: {dig}")
    for r in range(requests):
        check(torch.equal(outs[r].data, staged_outs[r].data), f"request {r} differs from the staged baseline")
    bev = BatchEvaluator(ctx)

    def serve_batch():
        b1 = CiphertextBatch.from_ciphertexts([a for a, _ in cts])
        b2 = CiphertextBatch.from_ciphertexts([b for _, b in cts])
        return bev.rescale_to_next(bev.relinearize(bev.multiply(b1, b2), rk))

    batch, blaunches = measure(f"kernel B, one batch of {requests}", serve_batch, requests)
    check(blaunches[1] == 1 and blaunches[2] == 0,
          f"the batch launched kernel B {blaunches[1]} and the stage kernel {blaunches[2]} times; expected 1 and 0")
    for r in range(requests):
        check(torch.equal(batch.data[r], outs[r].data), f"batched request {r} differs from the sequential one")
    print(f"[medium] {requests} requests of multiply -> relinearize -> rescale_to_next: request 0 equal to the plain "
          f"path on the card and to the JAX package's N={n} digest; the batch and the staged baseline equal to the "
          f"sequential outputs; kernel B {launches[1] // requests} launch per request, 1 per batch; kernel A "
          f"{launches[0] / requests:g} per request; no stage-kernel launch")
    result["launches"] = launches[1]
    return result


def linear_phase():
    """Phase 10: one step of an encrypted linear layer at N=32768 on the
    default 128-bit chain, through kernels A and B.  Returns kernel B's and
    kernel A's numbers of this phase for the kernels' JSON line."""
    from seal_tpu_torch import CKKSEncoder, Decryptor, Encryptor, KeyGenerator, PRNGType, UniformRandomGeneratorFactory
    from seal_tpu_torch import golden
    from seal_tpu_torch.convert import (ciphertext_from_numpy, galois_keys_from_numpy, plaintext_from_numpy,
                                        relin_keys_from_numpy, u64_to_numpy)
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.modulus import CoeffModulus, SecurityLevel
    from seal_tpu_torch.ops import ntt as NTT
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda
    from seal_tpu_torch.params import EncryptionParameters, SchemeType
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
    from seal_tpu_torch.context import SealContext

    step = golden.linear_layer_step
    requests = 4
    S = golden.LINEAR_SCALE
    n = golden.MEDIUM_N

    # ---- (a) splitmix inputs ------------------------------------------------
    t_a = time.perf_counter()
    ctx = golden.medium_context()                        # the default device: the card
    cd = ctx.first_context_data()
    ct_np, pt_np, g_np, r_np = golden.linear_inputs(ctx)
    keys = [None] * n
    keys[golden.LINEAR_GALOIS_ELT >> 1] = g_np
    gk = galois_keys_from_numpy(keys, ctx.key_parms_id, "cuda")
    rk = relin_keys_from_numpy([r_np], ctx.key_parms_id, "cuda")
    pt = plaintext_from_numpy(pt_np, ctx.first_parms_id, S, "cuda")
    cts = [ciphertext_from_numpy(golden.linear_inputs(ctx, r)[0] if r else ct_np, ctx.first_parms_id, True, S, "cuda")
           for r in range(requests)]
    del keys, g_np, r_np
    torch.cuda.synchronize()
    ev, bev = Evaluator(ctx), BatchEvaluator(ctx)
    print(f"[linear] N={n}, {golden.MEDIUM_CHAIN}: splitmix Galois key (element {golden.LINEAR_GALOIS_ELT}), "
          f"relinearization key, plaintext and {requests} ciphertexts made and copied to the card in "
          f"{time.perf_counter() - t_a:.1f} s")

    def serve():
        return [step(ev, c, pt, gk, rk) for c in cts]

    def serve_batch():
        return step(bev, CiphertextBatch.from_ciphertexts(cts), pt, gk, rk)

    groups = {"kernel A": "ntt_", "kernel B": "switch_key_kernel", "gathers (index_select)": "indexSelect"}

    def counted(fn):
        """fn() with the three counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        ntt_cuda.launches = switch_key_contract_cuda.launches = stage_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {"ntt": ntt_cuda.launches, "switch_key": switch_key_contract_cuda.launches,
                     "four_step_stage": stage_cuda.launches}

    def measure(label, fn):
        """Warm-up, one counted run, 3 timed runs, one profiled run; ms per
        ciphertext and the profiler's split."""
        fn()
        outs, launches = counted(fn)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / requests)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, split = device_split(prof, groups)
        n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        if by_name:
            busy = sum(by_name.values()) / 1e3
            prof_line = (f"under the profiler {n_dev / requests:.1f} device launches per ciphertext, device busy "
                         f"{busy / requests:.3f} ms per ciphertext, {100 * busy / wall_ms:.1f}% of wall {wall_ms:.3f} "
                         f"ms; per ciphertext " + ", ".join(f"{g} {v / 1e3 / requests:.4f} ms" for g, v in split.items())
                         + f", other kernels (plain PyTorch elementwise arithmetic, copies) "
                         f"{(busy - sum(split.values()) / 1e3) / requests:.3f} ms")
        else:
            busy, prof_line = None, "the profiler recorded no device time: not measured"
        print(f"[linear] {label}: launches for {requests} ciphertexts: kernel A {launches['ntt']}, kernel B "
              f"{launches['switch_key']}, stage kernel {launches['four_step_stage']}; ms per ciphertext over 3 runs "
              f"{', '.join(f'{t:.3f}' for t in times)} (median {sorted(times)[1]:.3f}); {prof_line}")
        return outs, launches, sorted(times)[1], busy

    with NTT.plain_on_card():
        ref0 = step(ev, cts[0], pt, gk, rk)
    one, one_launches = counted(lambda: step(ev, cts[0], pt, gk, rk))
    check(torch.equal(one.data, ref0.data), "linear step: request 0 differs from the plain path on the card")
    check(tuple(one.data.shape) == (2, len(cd.coeff_modulus_values) - 1, n)
          and one.parms_id == cd.next_context_data.parms_id and one.scale == S ** 3 / cd.coeff_modulus_values[-1],
          "linear step: wrong shape, level or scale")
    dig = golden.digest(u64_to_numpy(one.data))
    check(dig == golden.LINEAR_DIGEST, f"linear step: N={n} digest mismatch: {dig}")
    # per request: kernel B for the rotation's and the relinearization's key
    # switch; kernel A three times per key switch (the inverse NTT of the
    # target, the inverse NTT mod the special prime, the tail's NTT) and twice
    # for the rescale (the inverse NTT mod q_last, the NTT of the rest)
    check(one_launches == {"ntt": 8, "switch_key": 2, "four_step_stage": 0},
          f"linear step: one request launched {one_launches}; expected 8 of kernel A, 2 of kernel B, 0 stage")
    outs, launches, seq_ms, seq_busy = measure("sequential", serve)
    check(launches == {"ntt": 8 * requests, "switch_key": 2 * requests, "four_step_stage": 0},
          f"linear step: {requests} sequential requests launched {launches}")
    check(torch.equal(outs[0].data, one.data), "linear step: sequential request 0 differs from the single run")
    batch, blaunches, batch_ms, batch_busy = measure(f"one batch of {requests}", serve_batch)
    check(blaunches == {"ntt": 8, "switch_key": 2, "four_step_stage": 0},
          f"linear step: the batch launched {blaunches}; expected 8 of kernel A, 2 of kernel B, 0 stage")
    for r in range(requests):
        check(torch.equal(batch.data[r], outs[r].data), f"linear step: batched request {r} differs from the sequential one")
    print(f"[linear] (a) {requests} requests of multiply_plain -> rotate_vector(1) -> multiply -> relinearize -> "
          f"rescale_to_next: request 0 equal to the plain path on the card and to the JAX package's N={n} digest; the "
          f"batch equal to the sequential outputs; kernel B 2 launches per request and 2 per batch, kernel A 8 per "
          f"request and 8 per batch, no stage-kernel launch; batched: {batch_ms:.3f} ms per ciphertext (the port's "
          f"counterpart of ckks_n32768_batched_linear_layer_us_per_ct: {batch_ms * 1e3:.1f} us per ciphertext), "
          f"sequential {seq_ms:.3f} ms per ciphertext; {time.perf_counter() - t_a:.1f} s")
    del outs, batch, ref0

    # ---- (c) a rotation at the next level ----------------------------------
    t_c = time.perf_counter()
    low = ev.mod_switch_to_next(cts[0])
    check(low.data.is_contiguous(), "mod_switch_to_next left non-contiguous data")
    rot, rot_launches = counted(lambda: ev.rotate_vector(low, 1, gk))
    with NTT.plain_on_card():
        rot_ref = ev.rotate_vector(ev.mod_switch_to_next(cts[0]), 1, gk)
    check(torch.equal(rot.data, rot_ref.data), "rotation after mod_switch_to_next differs from the plain path")
    check(rot_launches == {"ntt": 3, "switch_key": 1, "four_step_stage": 0},
          f"rotation after mod_switch_to_next launched {rot_launches}")
    print(f"[linear] (c) mod_switch_to_next then rotate_vector(1) (D={len(low.data[0])}, the key's rows trimmed from "
          f"{gk.key(golden.LINEAR_GALOIS_ELT)['c0'].shape[0]}): equal to the plain path on the card; kernel B 1 launch, "
          f"kernel A 3; {time.perf_counter() - t_c:.1f} s")
    del ev, bev, gk, rk, cts, pt, low, rot, rot_ref
    torch.cuda.empty_cache()

    # ---- (b) real keys ------------------------------------------------------
    t_b = time.perf_counter()
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, (11, 12, 13, 14, 15, 16, 17, 18)))
    rctx = SealContext(parms, True, SecurityLevel.TC128)

    def keygen():
        kg = KeyGenerator(rctx)
        return kg.secret_key, kg.create_relin_keys(), kg.create_galois_keys_from_steps([1])

    with NTT.plain_on_card():
        ref_keys = keygen()
    torch.cuda.synchronize()
    t_k = time.perf_counter()
    sk, rrk, rgk = sampled("10b", keygen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t_k
    elt = golden.LINEAR_GALOIS_ELT
    pairs = [("secret key", sk.data, ref_keys[0].data),
             ("relin key c0", rrk.key(2)["c0"], ref_keys[1].key(2)["c0"]),
             ("relin key c1", rrk.key(2)["c1"], ref_keys[1].key(2)["c1"]),
             ("Galois key c0", rgk.key(elt)["c0"], ref_keys[2].key(elt)["c0"]),
             ("Galois key c1", rgk.key(elt)["c1"], ref_keys[2].key(elt)["c1"])]
    for name, got, want in pairs:
        check(torch.equal(got, want), f"real keys: {name} differs from the plain path on the card")
    check(sum(k is not None for k in rgk.keys) == 1 and len(rgk.keys) == n, "real keys: wrong Galois key set")
    del ref_keys, pairs
    v = np.linspace(0.0, 1.0, n // 2)
    enc = CKKSEncoder(rctx)
    pv = enc.encode(v, S)
    sym = Encryptor(rctx, secret_key=sk)
    rcts = [sym.encrypt_symmetric(pv) for _ in range(requests)]
    rbev = BatchEvaluator(rctx)
    rbatch = CiphertextBatch.from_ciphertexts(rcts)
    rout, rlaunches = counted(lambda: step(rbev, rbatch, pv, rgk, rrk))
    with NTT.plain_on_card():
        rref = step(rbev, rbatch, pv, rgk, rrk)
    check(torch.equal(rout.data, rref.data), "real keys: the batch differs from the plain path on the card")
    check(rlaunches == {"ntt": 8, "switch_key": 2, "four_step_stage": 0}, f"real keys: the batch launched {rlaunches}")
    dec = Decryptor(rctx, sk)
    model = np.roll(v * v, -1) * v
    worst = 0.0
    for r in range(requests):
        got = enc.decode(dec.decrypt(rout[r]))
        check(got.shape == (n // 2,) and np.isfinite(got).all(), f"real keys: decoded request {r} is malformed")
        err = float(np.max(np.abs(got.real - model)))
        check(err < 1e-3, f"real keys: decoded request {r} is {err} from np.roll(v*v, -1) * v")
        worst = max(worst, err)
    print(f"[linear] (b) real keys (seeded BLAKE2XB): the secret key, create_relin_keys() and "
          f"create_galois_keys_from_steps([1]) equal to the plain path on the card (keygen {keygen_s:.2f} s on the "
          f"card); {requests} encryptions of linspace(0, 1, {n // 2}) at 2^40 through the step as one batch (kernel B "
          f"{rlaunches['switch_key']}, kernel A {rlaunches['ntt']}), equal to the plain path, decoded within "
          f"{worst:.3e} of np.roll(v*v, -1) * v (bound 1e-3); {time.perf_counter() - t_b:.1f} s")
    del rctx, rbev, rbatch, rout, rref, rcts, sk, rrk, rgk
    torch.cuda.empty_cache()
    return {"launches_per_request": one_launches["switch_key"], "launches_per_batch": blaunches["switch_key"],
            "ms_per_ct_sequential": seq_ms, "ms_per_ct_batched": batch_ms,
            "device_busy_ms_per_ct_batched": None if batch_busy is None else batch_busy / requests,
            "ntt_launches_per_request": one_launches["ntt"]}

def bfv_phase(gen):
    """Phase 11: BFV on the card (``golden.bfv_context``: bfv_default(n) at
    SecurityLevel.TC128, t = PlainModulus.batching(n, 20)).  Returns the
    BFV entries of kernels A and B for the kernels' JSON line, and the
    batch's outputs by N for phase 15."""
    from seal_tpu_torch import Decryptor, Encryptor, KeyGenerator, PRNGType, UniformRandomGeneratorFactory
    from seal_tpu_torch import golden
    from seal_tpu_torch.context import SealContext
    from seal_tpu_torch.convert import ciphertext_from_numpy, relin_keys_from_numpy, u64_to_numpy
    from seal_tpu_torch.encoders import BatchEncoder
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.modulus import CoeffModulus, PlainModulus, SecurityLevel
    from seal_tpu_torch.ops import ntt as NTT
    from seal_tpu_torch.ops import rns as R
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda, switch_key_contract_plain
    from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse
    from seal_tpu_torch.ops.rns import slice_limbs
    from seal_tpu_torch.params import EncryptionParameters, SchemeType
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
    from seal_tpu_torch.pipeline import build_bfv_mult_relin

    def counted(fn):
        """fn() with the three counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        ntt_cuda.launches = switch_key_contract_cuda.launches = stage_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, (ntt_cuda.launches, switch_key_contract_cuda.launches, stage_cuda.launches)

    result = {"ntt": {}, "switch_key": {}}
    batch_outs = {}             # n -> phase 11's batch outputs, for phase 15
    max_err = {"ntt": 0, "switch_key": 0}
    for n, requests in ((golden.BFV_N, 8), (golden.BFV_MEDIUM_N, 4)):
        t_n = time.perf_counter()
        tag = f"[bfv N={n}]"
        ctx = golden.bfv_context(n)                      # the default device: the card
        cd = ctx.first_context_data()
        k = len(cd.coeff_modulus_values)
        behz_t = cd.behz_limb_tables()
        rows = behz_t.q.shape[0]
        key_t = ctx.key_context_data().limb_tables()
        ev, bev = Evaluator(ctx), BatchEvaluator(ctx)
        plan = ev._plan(cd)
        D, sel = plan.D, plan.sel_tables
        Rn = sel.q.shape[0]
        print(f"{tag} {golden.BFV_CHAIN}: t={cd.parms.plain_modulus.value}, k={k}, Bsk {rows - k} primes, D={D}, "
              f"Rn={Rn}")

        # ---- (a) kernels A and B at BFV's shapes against their plain versions
        # (label, tables, shape, inverse); the first four are one request's
        cases = [("BEHZ forward NTT over q U Bsk", behz_t, (4, rows, n), False),
                 ("BEHZ t-scaled inverse NTT over q U Bsk", behz_t, (3, rows, n), True),
                 ("key-switch tail: iNTT mod the special prime", slice_limbs(key_t, k, k + 1), (2, 1, n), True),
                 ("key-switch tail: iNTT of the sum", slice_limbs(key_t, 0, k), (2, k, n), True)]
        cases += [(f"batch of {requests}, {label}", t, (requests, *shape), inverse)
                  for label, t, shape, inverse in cases[:4]]
        per_request = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
        for i, (label, t, shape, inverse) in enumerate(cases):
            x = lazy_input(t, shape, 2 if inverse else 4, gen)
            plain_fn = (lambda: ntt_inverse(x, t)) if inverse else (lambda: ntt_forward(x, t))
            got = ntt_cuda(x, t, inverse)
            want = plain_fn()
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(err == 0, f"kernel A disagrees with its plain version at N={n}, {label}: max abs err {err}")
            ms, events_ms = kernel_ms(lambda: ntt_cuda(x, t, inverse), 50)
            plain_ms = cuda_ms(plain_fn, 3, warmup=1)
            nbytes, ops = ntt_work(x.numel() // n, shape[-2], t.log_n)
            b, by = bound_ms(nbytes, ops)
            print(f"{tag} kernel A, {label} {'inverse' if inverse else 'forward'} {tuple(shape)}: bit-exact; kernel "
                  f"{ms * 1e3:.2f} us device time, {events_ms * 1e3:.2f} us back to back by events; plain "
                  f"{plain_ms * 1e3:.1f} us by events; bound {b * 1e3:.3f} us ({by})")
            if i < 4:
                per_request["ms"] += ms
                per_request["plain_ms"] += plain_ms
                per_request["bytes"] += nbytes
                per_request["ops"] += ops
        b_a, by_a = bound_ms(per_request["bytes"], per_request["ops"])
        a_entry = {"ms": per_request["ms"], "plain_ms": per_request["plain_ms"], "bound_ms": b_a, "bound_by": by_a,
                   "max_abs_err": 0}
        b_entry = {}
        key = lazy_input(sel, (2, D, Rn, n), 1, gen)
        for label, shape in (("one request", (D, n)), (f"batch of {requests}", (requests, D, n))):
            t_c = lazy_input(cd.limb_tables(), shape, 1, gen)
            fn = lambda: switch_key_contract_cuda(t_c, None, key, sel, plan.need_reduce)
            got = fn()
            want = switch_key_contract_plain(t_c, None, key, sel, plan.need_reduce)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(err == 0, f"kernel B disagrees with its plain version at N={n}, {label}, no diagonal: {err}")
            ms, events_ms = kernel_ms(fn, 20)
            plain_ms = cuda_ms(lambda: switch_key_contract_plain(t_c, None, key, sel, plan.need_reduce), 2, warmup=1)
            B = t_c.shape[0] if t_c.dim() == 3 else 1
            nbytes, ops = switch_key_work(D, D, Rn, cd.log_n, False, B)
            b, by = bound_ms(nbytes, ops)
            print(f"{tag} kernel B, {label}, no diagonal (B={B}, D={D}, Rn={Rn}): bit-exact; kernel {ms * 1e3:.2f} us "
                  f"device time ({ms * 1e3 / B:.2f} us per ciphertext), {events_ms * 1e3:.2f} us back to back by "
                  f"events; plain {plain_ms * 1e3:.1f} us by events; bound {b * 1e3:.3f} us ({by})")
            if not b_entry:
                b_entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "max_abs_err": 0}

        # ---- (b, c) the requests: multiply -> relinearize, splitmix inputs
        rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, "cuda")
        cts = []
        for r in range(requests):
            d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)
            cts.append((ciphertext_from_numpy(d1, ctx.first_parms_id, False, 1.0, "cuda"),
                        ciphertext_from_numpy(d2, ctx.first_parms_id, False, 1.0, "cuda")))
        fn = build_bfv_mult_relin(ctx)
        key2 = rk.key(2)
        one, one_launches = counted(lambda: fn(cts[0][0].data, cts[0][1].data, key2["c0"], key2["c1"]))
        with NTT.plain_on_card():
            ref0 = fn(cts[0][0].data, cts[0][1].data, key2["c0"], key2["c1"])
        check(torch.equal(one, ref0), f"{tag} build_bfv_mult_relin differs from the plain path on the card")
        check(tuple(one.shape) == (2, k, n), f"{tag} build_bfv_mult_relin: shape {tuple(one.shape)}")
        dig = golden.digest(u64_to_numpy(one))
        want_dig = golden.BFV_DIGEST if n == golden.BFV_N else golden.BFV_MEDIUM_DIGEST
        check(dig == want_dig, f"{tag} BFV digest mismatch: {dig}")
        # per request: kernel A for the BEHZ forward and t-scaled inverse
        # transforms (both bases in one launch each) and the key-switch tail's
        # two inverse transforms; kernel B once; no stage kernel
        check(one_launches == (4, 1, 0), f"{tag} one request launched (A, B, stage) {one_launches}; expected (4, 1, 0)")

        def serve():
            return [ev.relinearize(ev.multiply(a, b), rk) for a, b in cts]

        def serve_batch():
            b1 = CiphertextBatch.from_ciphertexts([a for a, _ in cts])
            b2 = CiphertextBatch.from_ciphertexts([b for _, b in cts])
            return bev.relinearize(bev.multiply(b1, b2), rk)

        # the BEHZ steps alone at a request's shapes and the batch's: their
        # device time is the profiler split's "base conversions"
        def behz(lead):
            x = lazy_input(cd.limb_tables(), (*lead, 4, k, n), 1, gen)
            joined = lazy_input(behz_t, (*lead, 3, rows, n), 1, gen)
            tool = cd.rns_tool
            return lambda: (R.sm_mrq(R.fastbconv_m_tilde(x, tool), tool), R.fastbconv_sk(R.fast_floor(joined, tool), tool))

        groups = {"kernel A": "ntt_", "kernel B": "switch_key_kernel"}
        timings = {}
        for label, run, count, expect, lead in (("sequential", serve, requests, (4 * requests, requests, 0), ()),
                                                (f"one batch of {requests}", serve_batch, requests, (4, 1, 0),
                                                 (requests,))):
            run()
            outs, launches = counted(run)
            check(launches == expect, f"{tag} {label}: launched (A, B, stage) {launches}; expected {expect}")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / count)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            by_name, split = device_split(prof, groups)
            n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
            behz_ms = device_ms(behz(lead), 3)
            behz_ms = None if behz_ms is None else behz_ms * (count if not lead else 1)
            if by_name:
                busy = sum(by_name.values()) / 1e3
                conv = "not measured" if behz_ms is None else f"{behz_ms / count:.4f} ms"
                other = (busy - sum(split.values()) / 1e3 - (behz_ms or 0.0)) / count
                prof_line = (f"under the profiler {n_dev / count:.1f} device launches per request, device busy "
                             f"{busy / count:.3f} ms per request, {100 * busy / wall_ms:.1f}% of wall {wall_ms:.3f} ms; "
                             f"per request " + ", ".join(f"{g} {v / 1e3 / count:.4f} ms" for g, v in split.items())
                             + f", the BEHZ base conversions and their tails (timed alone) {conv}, other kernels "
                             f"(plain PyTorch elementwise arithmetic, copies) {other:.3f} ms")
            else:
                busy, prof_line = None, "the profiler recorded no device time: not measured"
            median = sorted(times)[1]
            print(f"{tag} {label}: launches for {count} requests: kernel A {launches[0]}, kernel B {launches[1]}, "
                  f"stage kernel {launches[2]}; ms per request over 3 runs {', '.join(f'{t:.3f}' for t in times)} "
                  f"(median {median:.3f}); {prof_line}")
            timings[label] = {"outs": outs, "launches": launches, "ms_per_request": median,
                              "device_busy_ms_per_request": None if busy is None else busy / count}
        seq = timings["sequential"]
        batch = timings[f"one batch of {requests}"]
        for r in range(requests):
            check(torch.equal(batch["outs"].data[r], seq["outs"][r].data),
                  f"{tag} batched request {r} differs from the sequential one")
        check(torch.equal(seq["outs"][0].data, one), f"{tag} the Evaluator's request 0 differs from the pipeline's")
        print(f"{tag} {requests} requests of multiply -> relinearize: request 0 equal to the plain path on the card "
              f"and to the JAX package's digest; the batch equal to the sequential outputs; kernel A 4 launches per "
              f"request and 4 per batch, kernel B 1 and 1, no stage-kernel launch; "
              f"{time.perf_counter() - t_n:.1f} s")
        name = f"n{n}"
        result["ntt"][name] = dict(a_entry, launches_per_request=one_launches[0],
                                   launches_per_batch=batch["launches"][0])
        result["switch_key"][name] = dict(b_entry, launches_per_request=one_launches[1],
                                          launches_per_batch=batch["launches"][1],
                                          ms_per_request_sequential=seq["ms_per_request"],
                                          ms_per_request_batched=batch["ms_per_request"],
                                          device_busy_ms_per_request_batched=batch["device_busy_ms_per_request"])
        batch_outs[n] = batch["outs"]
        del cts, rk, one, ref0, timings, seq, batch, ev, bev, plan, ctx
        torch.cuda.empty_cache()

    # ---- (d) real keys at N=8192 ---------------------------------------------
    t_d = time.perf_counter()
    n = golden.BFV_N
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, golden.BFV_PLAIN_BITS))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, (21, 22, 23, 24, 25, 26, 27, 28)))
    rctx = SealContext(parms, True, SecurityLevel.TC128)
    tv = parms.plain_modulus.value

    def keygen():
        kg = KeyGenerator(rctx)
        return kg.secret_key, kg.create_public_key(), kg.create_relin_keys(), kg.create_galois_keys_from_steps([1, 0])

    with NTT.plain_on_card():
        ref_keys = keygen()
    sk, pk, rk, gk = sampled("11d", keygen)
    columns = 2 * n - 1
    for name, got, want in (("secret key", sk.data, ref_keys[0].data), ("public key", pk.data.data, ref_keys[1].data.data),
                            ("relin key", rk.key(2)["c0"], ref_keys[2].key(2)["c0"]),
                            ("row Galois key", gk.key(3)["c1"], ref_keys[3].key(3)["c1"]),
                            ("column Galois key", gk.key(columns)["c0"], ref_keys[3].key(columns)["c0"])):
        check(torch.equal(got, want), f"real keys: the {name} differs from the plain path on the card")
    del ref_keys
    rng = np.random.default_rng(BFV_SLOT_SEED)
    va = rng.integers(0, tv, size=n, dtype=np.uint64)
    vb = rng.integers(0, tv, size=n, dtype=np.uint64)
    be = BatchEncoder(rctx)
    enc = Encryptor(rctx, public_key=pk)
    ca, cb = enc.encrypt(be.encode(va)), enc.encrypt(be.encode(vb))
    dec = Decryptor(rctx, sk)
    budget_before = dec.invariant_noise_budget(ca)
    ev = Evaluator(rctx)

    def chain():
        prod = ev.relinearize(ev.multiply(ca, cb), rk)
        return ev.mod_switch_to_next(ev.rotate_columns(ev.rotate_rows(prod, 1, gk), gk))

    out, launches = counted(chain)
    with NTT.plain_on_card():
        ref = chain()
    check(torch.equal(out.data, ref.data), "real keys: the chain differs from the plain path on the card")
    # kernel B for the relinearization and the two rotations; kernel A twice
    # for the multiply and twice in each key switch's tail
    check(launches == (8, 3, 0), f"real keys: the chain launched (A, B, stage) {launches}; expected (8, 3, 0)")
    budget_after = dec.invariant_noise_budget(out)
    check(budget_after > 0, f"real keys: the noise budget is spent ({budget_after} bits)")
    prod = (va.astype(object) * vb.astype(object) % tv).astype(np.uint64)
    half = n // 2
    rows_rotated = np.concatenate([np.roll(prod[:half], -1), np.roll(prod[half:], -1)])
    want = np.concatenate([rows_rotated[half:], rows_rotated[:half]])
    got = be.decode(dec.decrypt(out))
    check(got.shape == (n,) and np.array_equal(got, want),
          "real keys: the decoded chain differs from the slot-wise product mod t, rows rotated and columns swapped")
    print(f"[bfv real keys] N={n}, t={tv}: keygen (seeded BLAKE2XB; secret, public, relinearization, and Galois keys "
          f"for rotate_rows(1) and rotate_columns) equal to the plain path on the card; two BatchEncoder vectors "
          f"encrypted with the public key; multiply -> relinearize -> rotate_rows(1) -> rotate_columns -> "
          f"mod_switch_to_next (kernel A {launches[0]}, kernel B {launches[1]}) equal to the plain path, decrypted and "
          f"decoded equal to numpy's slot-wise product mod t with rows rotated and columns swapped; invariant noise "
          f"budget {budget_before} bits before, {budget_after} after; {time.perf_counter() - t_d:.1f} s")
    return result, batch_outs


def bgv_phase(gen):
    """Phase 12: BGV on the card (``golden.bgv_context``: bfv_default(n) at
    SecurityLevel.TC128, t = PlainModulus.batching(n, 20), as a BGV
    context).  Returns the BGV entries of kernels A and B for the kernels'
    JSON line, and the batch's outputs by N for phase 15."""
    from seal_tpu_torch import Decryptor, Encryptor, KeyGenerator, PRNGType, UniformRandomGeneratorFactory
    from seal_tpu_torch import golden
    from seal_tpu_torch.context import SealContext
    from seal_tpu_torch.convert import ciphertext_from_numpy, galois_keys_from_numpy, relin_keys_from_numpy, u64_to_numpy
    from seal_tpu_torch.encoders import BatchEncoder
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.modulus import CoeffModulus, PlainModulus, SecurityLevel
    from seal_tpu_torch.ops import ntt as NTT
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda, switch_key_contract_plain
    from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse
    from seal_tpu_torch.ops.rns import slice_limbs
    from seal_tpu_torch.params import EncryptionParameters, SchemeType
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch

    def counted(fn):
        """fn() with the three counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        ntt_cuda.launches = switch_key_contract_cuda.launches = stage_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, (ntt_cuda.launches, switch_key_contract_cuda.launches, stage_cuda.launches)

    result = {"ntt": {}, "switch_key": {}}
    batch_outs = {}             # n -> phase 12's batch outputs, for phase 15
    for n, requests in ((golden.BGV_N, 8), (golden.BGV_MEDIUM_N, 4)):
        t_n = time.perf_counter()
        tag = f"[bgv N={n}]"
        ctx = golden.bgv_context(n)                      # the default device: the card
        cd = ctx.first_context_data()
        k = len(cd.coeff_modulus_values)
        first_t, key_t = cd.limb_tables(), ctx.key_context_data().limb_tables()
        ev, bev = Evaluator(ctx), BatchEvaluator(ctx)
        plan = ev._plan(cd)
        D, sel = plan.D, plan.sel_tables
        Rn = sel.q.shape[0]
        print(f"[bgv N={n}] {golden.BFV_CHAIN}, as BGV: t={cd.parms.plain_modulus.value}, k={k}, D={D}, Rn={Rn}")

        # ---- (a) kernels A and B at BGV's shapes against their plain versions
        # (label, tables, shape, inverse, calls per request)
        cases = [("key switch: iNTT of the target", first_t, (D, n), True, 2),
                 ("key-switch tail: iNTT mod the special prime", slice_limbs(key_t, k, k + 1), (2, 1, n), True, 2),
                 ("key-switch tail: NTT of the correction", slice_limbs(key_t, 0, k), (2, D, n), False, 2),
                 ("mod-t switch: iNTT mod q_last", slice_limbs(first_t, k - 1, k), (2, 1, n), True, 1),
                 ("mod-t switch: NTT of the correction", slice_limbs(first_t, 0, k - 1), (2, k - 1, n), False, 1)]
        cases += [(f"batch of {requests}, {label}", t, (requests, *shape), inverse, 0)
                  for label, t, shape, inverse, _ in cases]
        per_request = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
        for label, t, shape, inverse, calls in cases:
            x = lazy_input(t, shape, 2 if inverse else 4, gen)
            plain_fn = (lambda: ntt_inverse(x, t)) if inverse else (lambda: ntt_forward(x, t))
            got = ntt_cuda(x, t, inverse)
            want = plain_fn()
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(err == 0, f"kernel A disagrees with its plain version at N={n}, {label}: max abs err {err}")
            if not calls:
                # the batch's shapes: checked, not timed (each profiled timing costs seconds of host time)
                print(f"{tag} kernel A, {label} {'inverse' if inverse else 'forward'} {tuple(shape)}: bit-exact")
                continue
            ms, events_ms = kernel_ms(lambda: ntt_cuda(x, t, inverse), 30)
            plain_ms = cuda_ms(plain_fn, 2, warmup=1)
            nbytes, ops = ntt_work(x.numel() // n, shape[-2], t.log_n)
            b, by = bound_ms(nbytes, ops)
            print(f"{tag} kernel A, {label} {'inverse' if inverse else 'forward'} {tuple(shape)}: bit-exact (max abs "
                  f"err {err}); kernel {ms * 1e3:.2f} us device time, {events_ms * 1e3:.2f} us back to back by events; "
                  f"plain {plain_ms * 1e3:.1f} us by events; bound {b * 1e3:.3f} us ({by})")
            per_request["ms"] += calls * ms
            per_request["plain_ms"] += calls * plain_ms
            per_request["bytes"] += calls * nbytes
            per_request["ops"] += calls * ops
        b_a, by_a = bound_ms(per_request["bytes"], per_request["ops"])
        a_entry = {"ms": per_request["ms"], "plain_ms": per_request["plain_ms"], "bound_ms": b_a, "bound_by": by_a,
                   "max_abs_err": 0}
        b_entry = {}
        key = lazy_input(sel, (2, D, Rn, n), 1, gen)
        for label, shape in (("one request", (D, n)), (f"batch of {requests}", (requests, D, n))):
            t_n_form = lazy_input(first_t, shape, 1, gen)
            t_c = ntt_inverse(t_n_form, first_t)
            fn = lambda: switch_key_contract_cuda(t_c, t_n_form, key, sel, plan.need_reduce)
            got = fn()
            want = switch_key_contract_plain(t_c, t_n_form, key, sel, plan.need_reduce)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(err == 0, f"kernel B disagrees with its plain version at N={n}, {label}, diagonal: {err}")
            ms, events_ms = kernel_ms(fn, 20)
            plain_ms = cuda_ms(lambda: switch_key_contract_plain(t_c, t_n_form, key, sel, plan.need_reduce), 2,
                               warmup=1)
            B = t_c.shape[0] if t_c.dim() == 3 else 1
            nbytes, ops = switch_key_work(D, D, Rn, cd.log_n, True, B)
            b, by = bound_ms(nbytes, ops)
            print(f"{tag} kernel B, {label}, NTT-form target with the diagonal (B={B}, D={D}, Rn={Rn}): bit-exact "
                  f"(max abs err {err}); kernel {ms * 1e3:.2f} us device time ({ms * 1e3 / B:.2f} us per "
                  f"ciphertext), {events_ms * 1e3:.2f} us back to back by events; plain {plain_ms * 1e3:.1f} us by "
                  f"events; bound {b * 1e3:.3f} us ({by})")
            if not b_entry:
                # one request's two key switches
                b_entry = {"ms": 2 * ms, "plain_ms": 2 * plain_ms, "bound_ms": 2 * b, "bound_by": by,
                           "max_abs_err": 0}
        del key, t_c, t_n_form

        # ---- (b) the requests: multiply -> relinearize -> rotate_rows(1) ->
        # mod_switch_to_next, splitmix inputs
        rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, "cuda")
        galois = [None] * n
        galois[golden.BGV_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.BGV_GALOIS_SEED)
        gk = galois_keys_from_numpy(galois, ctx.key_parms_id, "cuda")
        cts = [tuple(ciphertext_from_numpy(d, ctx.first_parms_id, True, 1.0, "cuda")
                     for d in golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)) for r in range(requests)]
        del galois
        golden.bgv_request(ev, *cts[0], rk, gk)                 # warm-up: plans and tables
        one, one_launches = counted(lambda: golden.bgv_request(ev, *cts[0], rk, gk))
        with NTT.plain_on_card():
            ref0 = golden.bgv_request(ev, *cts[0], rk, gk)
        check(torch.equal(one.data, ref0.data), f"{tag} the request differs from the plain path on the card")
        check(tuple(one.data.shape) == (2, k - 1, n) and one.parms_id == cd.next_context_data.parms_id
              and one.is_ntt_form, f"{tag} the request: shape {tuple(one.data.shape)} or level wrong")
        dig = golden.digest(u64_to_numpy(one.data))
        want_dig, want_cf = ((golden.BGV_DIGEST, golden.BGV_CORRECTION_FACTOR) if n == golden.BGV_N
                             else (golden.BGV_MEDIUM_DIGEST, golden.BGV_MEDIUM_CORRECTION_FACTOR))
        check(dig == want_dig, f"{tag} BGV digest mismatch: {dig}")
        check(one.correction_factor == want_cf, f"{tag} correction factor {one.correction_factor}, expected {want_cf}")
        # per request: kernel A three times per key switch (the target's
        # inverse, the tail's inverse mod the special prime and forward of the
        # correction) and twice for the mod-t switch; kernel B once per key switch
        check(one_launches == (8, 2, 0), f"{tag} one request launched (A, B, stage) {one_launches}; expected (8, 2, 0)")

        def serve():
            return [golden.bgv_request(ev, a, b, rk, gk) for a, b in cts]

        def serve_batch():
            return golden.bgv_request(bev, CiphertextBatch.from_ciphertexts([a for a, _ in cts]),
                                      CiphertextBatch.from_ciphertexts([b for _, b in cts]), rk, gk)

        groups = {"kernel A": "ntt_", "kernel B": "switch_key_kernel"}
        timings = {}
        for label, run, expect in (("sequential", serve, (8 * requests, 2 * requests, 0)),
                                   (f"one batch of {requests}", serve_batch, (8, 2, 0))):
            run()
            outs, launches = counted(run)
            check(launches == expect, f"{tag} {label}: launched (A, B, stage) {launches}; expected {expect}")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / requests)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            by_name, split = device_split(prof, groups)
            n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
            if by_name:
                busy = sum(by_name.values()) / 1e3
                other = (busy - sum(split.values()) / 1e3) / requests
                prof_line = (f"under the profiler {n_dev / requests:.1f} device launches per request, device busy "
                             f"{busy / requests:.3f} ms per request, {100 * busy / wall_ms:.1f}% of wall "
                             f"{wall_ms:.3f} ms; per request "
                             + ", ".join(f"{g} {v / 1e3 / requests:.4f} ms" for g, v in split.items())
                             + f", other kernels (plain PyTorch elementwise arithmetic, gathers, copies) {other:.3f} ms")
                split_ms = {g: v / 1e3 / requests for g, v in split.items()}
            else:
                busy, split_ms = None, {}
                prof_line = "the profiler recorded no device time: not measured"
            median = sorted(times)[1]
            print(f"{tag} {label}: launches for {requests} requests: kernel A {launches[0]}, kernel B {launches[1]}, "
                  f"stage kernel {launches[2]}; ms per request over 3 runs {', '.join(f'{t:.3f}' for t in times)} "
                  f"(median {median:.3f}); {prof_line}")
            timings[label] = {"outs": outs, "launches": launches, "ms_per_request": median,
                              "device_busy_ms_per_request": None if busy is None else busy / requests,
                              "split": split_ms}
        seq = timings["sequential"]
        batch = timings[f"one batch of {requests}"]
        check(batch["outs"].correction_factor == want_cf, f"{tag} the batch's correction factor differs")
        for r in range(requests):
            check(torch.equal(batch["outs"].data[r], seq["outs"][r].data),
                  f"{tag} batched request {r} differs from the sequential one")
        check(torch.equal(seq["outs"][0].data, one.data), f"{tag} the sequential request 0 differs from the counted one")
        print(f"{tag} {requests} requests of multiply -> relinearize -> rotate_rows(1) -> mod_switch_to_next: request "
              f"0 equal to the plain path on the card and to the JAX package's digest, correction factor {want_cf}; "
              f"the batch equal to the sequential outputs; kernel A 8 launches per request and 8 per batch, kernel B "
              f"2 and 2, no stage-kernel launch; {time.perf_counter() - t_n:.1f} s")
        name = f"n{n}"
        for kernel, entry, index in (("ntt", a_entry, 0), ("switch_key", b_entry, 1)):
            group = "kernel A" if index == 0 else "kernel B"
            result[kernel][name] = dict(entry, launches_per_request=one_launches[index],
                                        launches_per_batch=batch["launches"][index],
                                        device_ms_per_request_sequential=seq["split"].get(group),
                                        device_ms_per_request_batched=batch["split"].get(group))
        result["switch_key"][name].update(ms_per_request_sequential=seq["ms_per_request"],
                                          ms_per_request_batched=batch["ms_per_request"],
                                          device_busy_ms_per_request_sequential=seq["device_busy_ms_per_request"],
                                          device_busy_ms_per_request_batched=batch["device_busy_ms_per_request"])
        batch_outs[n] = batch["outs"]
        del cts, rk, gk, one, ref0, timings, seq, batch, ev, bev, plan, ctx
        torch.cuda.empty_cache()

    # ---- (c) real keys at N=8192 ---------------------------------------------
    t_c0 = time.perf_counter()
    n = golden.BGV_N
    parms = EncryptionParameters(SchemeType.BGV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, golden.BFV_PLAIN_BITS))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, (31, 32, 33, 34, 35, 36, 37, 38)))
    rctx = SealContext(parms, True, SecurityLevel.TC128)
    tv = parms.plain_modulus.value

    def keygen():
        kg = KeyGenerator(rctx)
        return kg.secret_key, kg.create_public_key(), kg.create_relin_keys(), kg.create_galois_keys_from_steps([1, 0])

    with NTT.plain_on_card():
        ref_keys = keygen()
    sk, pk, rk, gk = sampled("12c", keygen)
    columns = 2 * n - 1
    for name, got, want in (("secret key", sk.data, ref_keys[0].data), ("public key", pk.data.data, ref_keys[1].data.data),
                            ("relin key", rk.key(2)["c0"], ref_keys[2].key(2)["c0"]),
                            ("row Galois key", gk.key(3)["c1"], ref_keys[3].key(3)["c1"]),
                            ("column Galois key", gk.key(columns)["c0"], ref_keys[3].key(columns)["c0"])):
        check(torch.equal(got, want), f"BGV real keys: the {name} differs from the plain path on the card")
    del ref_keys
    rng = np.random.default_rng(BGV_SLOT_SEED)
    va, vb, vc = (rng.integers(0, tv, size=n, dtype=np.uint64) for _ in range(3))
    be = BatchEncoder(rctx)
    enc = Encryptor(rctx, public_key=pk)
    ca, cb, cc = (enc.encrypt(be.encode(v)) for v in (va, vb, vc))
    dec = Decryptor(rctx, sk)
    budget_before = dec.invariant_noise_budget(ca)
    ev = Evaluator(rctx)
    factors = {}

    def chain():
        x, y = ev.mod_switch_to_next(ca), ev.mod_switch_to_next(cb)
        z = ev.relinearize(ev.multiply(x, y), rk)
        c = ev.mod_switch_to_next(cc)
        factors.update(x=x.correction_factor, z=z.correction_factor, c=c.correction_factor)
        w = ev.add(z, c)
        return ev.rotate_columns(ev.rotate_rows(w, 1, gk), gk)

    out, launches = counted(chain)
    with NTT.plain_on_card():
        ref = chain()
    check(torch.equal(out.data, ref.data), "BGV real keys: the chain differs from the plain path on the card")
    f = factors["x"]
    check(f != 1 and factors["z"] == f * f % tv and factors["c"] == f and factors["z"] != factors["c"],
          f"BGV real keys: correction factors {factors}; expected f != 1, z = f^2, c = f")
    # kernel A: three mod-t switches (two each) and three key switches
    # (three each); kernel B: the relinearization and the two rotations
    check(launches == (15, 3, 0), f"BGV real keys: the chain launched (A, B, stage) {launches}; expected (15, 3, 0)")
    budget_after = dec.invariant_noise_budget(out)
    check(budget_after > 0, f"BGV real keys: the noise budget is spent ({budget_after} bits)")
    a, b, c = (v.astype(object) for v in (va, vb, vc))
    want = ((a * b + c) % tv).astype(np.uint64)
    half = n // 2
    rows_rotated = np.concatenate([np.roll(want[:half], -1), np.roll(want[half:], -1)])
    want = np.concatenate([rows_rotated[half:], rows_rotated[:half]])
    got = be.decode(dec.decrypt(out))
    check(got.shape == (n,) and np.array_equal(got, want),
          "BGV real keys: the decoded chain differs from numpy's (a b + c) mod t, rows rotated and columns swapped")
    print(f"[bgv real keys] N={n}, t={tv}: keygen (seeded BLAKE2XB; secret, public, relinearization, and Galois keys "
          f"for rotate_rows(1) and rotate_columns) equal to the plain path on the card; three BatchEncoder vectors "
          f"encrypted with the public key; x, y = mod_switch_to_next(enc a, enc b) (correction factor {f}), z = "
          f"relinearize(multiply(x, y)) ({factors['z']}), w = add(z, mod_switch_to_next(enc c)) balanced to "
          f"{out.correction_factor}, rotate_rows(1), rotate_columns (kernel A {launches[0]}, kernel B {launches[1]}) "
          f"equal to the plain path, decrypted and decoded equal to numpy's (a b + c) mod t with rows rotated and "
          f"columns swapped; invariant noise budget {budget_before} bits fresh, {budget_after} at the end; "
          f"{time.perf_counter() - t_c0:.1f} s")
    return result, batch_outs


def _median(values):
    return sorted(values)[len(values) // 2]


def wire_phase(card_line, n=None):
    """Phase 13: the wire path.  (a) Microsoft SEAL's blobs on the card;
    (b) the N=32768 linear-layer request saved by a client, loaded, checked
    and served on the card, its replies saved and decrypted; (c) the same
    request with ``throw_on_transparent=False``.  Returns the launches of
    kernels A and B for the kernels' JSON line.  ``n`` (default
    ``golden.MEDIUM_N``) sizes (b) and (c)."""
    from seal_tpu_torch import (BatchEncoder, CKKSEncoder, Ciphertext, Decryptor, Encryptor, GaloisKeys,
                                KeyGenerator, PRNGType, PublicKey, RelinKeys, SealContext,
                                UniformRandomGeneratorFactory)
    from seal_tpu_torch import golden
    from seal_tpu_torch import serialization as S
    from seal_tpu_torch import valcheck as V
    from seal_tpu_torch.convert import u64_from_numpy
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.modulus import CoeffModulus, SecurityLevel
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda
    from seal_tpu_torch.params import EncryptionParameters, SchemeType
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
    from seal_tpu_torch.random.sampler import sample_poly_uniform

    n = n or golden.MEDIUM_N
    modes = {"none": S.COMPR_NONE, "zlib": S.COMPR_ZLIB}
    if S._HAS_ZSTD:
        modes["zstd"] = S.COMPR_ZSTD
    print(f"[wire] {card_line}; compression modes {', '.join(modes)}"
          + ("" if S._HAS_ZSTD else " (zstandard is not installed here: zstd not run)"))

    def counted(fn):
        """fn() with the three counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        ntt_cuda.launches = switch_key_contract_cuda.launches = stage_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {"ntt": ntt_cuda.launches, "switch_key": switch_key_contract_cuda.launches,
                     "four_step_stage": stage_cuda.launches}

    def timed(fn):
        """(fn(), host ms up to a synchronize)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def valid_for(obj, ctx):
        """valcheck.is_valid_for; a public key's data check is its
        ciphertext's, and a key-switching key's rows are checked as public
        keys at the key level."""
        if isinstance(obj, PublicKey):
            return V.is_metadata_valid_for(obj, ctx) and V.is_data_valid_for(obj.data, ctx)
        if isinstance(obj, (RelinKeys, GaloisKeys)):
            return all(valid_for(PublicKey(Ciphertext(torch.stack([e["c0"][j], e["c1"][j]]), obj.parms_id, True)), ctx)
                       for e in obj.keys if e is not None for j in range(e["c0"].shape[0]))
        return V.is_valid_for(obj, ctx)

    # ---- (a) Microsoft SEAL's blobs ----------------------------------------
    t_a = time.perf_counter()

    def blob(name):
        with open(os.path.join(WIRE_DATA, name), "rb") as f:
            return f.read()

    manifest = {"ckks_val": {}, "bfv4096_rot_slot": {}}
    for line in blob("manifest.txt").decode().splitlines():
        key, _, rest = line.strip().partition(" ")
        if key in manifest:
            idx, val = rest.split(" ", 1)
            manifest[key][int(idx)] = float(val) if key == "ckks_val" else int(val)
        elif key.endswith("_hex"):
            manifest[key] = rest
    ctxs = {}
    for name in ("bfv", "bgv", "ckks", "bfv4096"):
        raw = blob(f"{name}_parms.bin")
        parms, _ = S.params_load(raw)
        check(S.params_save(parms, S.COMPR_NONE) == raw, f"wire: {name}_parms.bin does not save back byte for byte")
        parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, WIRE_SEED))
        ctxs[name] = SealContext(parms, True, SecurityLevel.TC128 if name == "bfv4096" else SecurityLevel.NONE)
    loaded = []

    def load(kind, name, ctx):
        raw = blob(name)
        loader = {"ct": S.ciphertext_load, "sk": S.secret_key_load, "pk": S.public_key_load,
                  "pt": S.plaintext_load, "rk": lambda b, c: S.kswitch_keys_load(b, c, RelinKeys),
                  "gk": lambda b, c: S.kswitch_keys_load(b, c, GaloisKeys)}[kind]
        obj, used = loader(raw, ctx)
        check(used == len(raw), f"wire: {name} loaded {used} of {len(raw)} bytes")
        if kind in ("rk", "gk"):
            tensors = [t for e in obj.keys if e is not None for t in (e["c0"], e["c1"])]
        else:
            tensors = [{"ct": lambda: obj.data, "sk": lambda: obj.data, "pk": lambda: obj.data.data,
                        "pt": lambda: obj.rns_data}[kind]()]
            tensors = [t for t in tensors if t is not None]
        check(valid_for(obj, ctx), f"wire: {name} fails valcheck.is_valid_for")
        check(all(t.device == ctx.device for t in tensors), f"wire: {name} did not load onto {ctx.device}")
        loaded.append(name)
        return obj

    # the port's fixed-seed keys, made on the card, against the reference's bytes
    for name in ("bfv", "bgv", "ckks", "bfv4096"):
        check(S.secret_key_save(KeyGenerator(ctxs[name]).secret_key, S.COMPR_NONE) == blob(f"{name}_sk.bin"),
              f"wire: the fixed-seed {name} secret key differs from {name}_sk.bin")
    kg = KeyGenerator(ctxs["bfv"])
    for label, got in (("bfv_pk", S.public_key_save(kg.create_public_key(), S.COMPR_NONE)),
                       ("bfv_rlk", S.kswitch_keys_save(kg.create_relin_keys(), ctxs["bfv"], S.COMPR_NONE)),
                       ("bfv_glk", S.kswitch_keys_save(kg.create_galois_keys_from_steps([1, -1]), ctxs["bfv"],
                                                       S.COMPR_NONE))):
        check(got == blob(f"{label}.bin"), f"wire: the fixed-seed {label} made on the card differs from {label}.bin")
    kg = KeyGenerator(ctxs["bfv4096"])
    check(S.public_key_save(kg.create_public_key(), S.COMPR_NONE) == blob("bfv4096_pk.bin"),
          "wire: the fixed-seed bfv4096 public key differs from bfv4096_pk.bin")
    check(S.kswitch_keys_save(kg.create_galois_keys_from_steps([1]), ctxs["bfv4096"], S.COMPR_NONE)
          == blob("bfv4096_glk.bin"), "wire: the fixed-seed bfv4096 Galois keys differ from bfv4096_glk.bin")
    del kg

    def serve_blobs():
        ctx = ctxs["bfv"]
        sk = load("sk", "bfv_sk.bin", ctx)
        load("pk", "bfv_pk.bin", ctx)
        load("sk", "bfv_sk_zlib.bin", ctx)
        dec, ev = Decryptor(ctx, sk), Evaluator(ctx)
        check(load("pt", "bfv_pt.bin", ctx).to_string() == manifest["bfv_pt_hex"], "wire: bfv_pt.bin")
        names = ["bfv_ct", "bfv_ct_seeded", "bfv_ct_zlib"] + (["bfv_ct_zstd"] if S._HAS_ZSTD else [])
        for name in names:
            got = dec.decrypt(load("ct", f"{name}.bin", ctx)).to_string()
            check(got == manifest["bfv_pt_hex"], f"wire: {name}.bin decrypts to {got!r}")
        check(dec.decrypt(load("ct", "bfv_ct_prod.bin", ctx)).to_string() == manifest["bfv_prod_hex"],
              "wire: bfv_ct_prod.bin")
        ct = load("ct", "bfv_ct.bin", ctx)
        for name in ("bfv_rlk", "bfv_rlk_seeded"):
            rk = load("rk", f"{name}.bin", ctx)
            got = dec.decrypt(ev.add(ev.relinearize(ev.multiply(ct, ct), rk), ct)).to_string()
            check(got == manifest["bfv_prod_hex"], f"wire: bfv_ct x bfv_ct with {name} decrypts to {got!r}")
        be = BatchEncoder(ctx)
        vals = np.arange(be.slots, dtype=np.uint64) % 17
        sym = Encryptor(ctx, secret_key=sk).encrypt_symmetric(be.encode(vals))
        half = be.slots // 2
        want = np.concatenate([np.roll(vals[:half], -1), np.roll(vals[half:], -1)])
        for name in ("bfv_glk", "bfv_glk_seeded"):
            got = be.decode(dec.decrypt(ev.rotate_rows(sym, 1, load("gk", f"{name}.bin", ctx))))
            check(np.array_equal(got, want), f"wire: rotate_rows(1) with {name}.bin")
        ctx = ctxs["bfv4096"]
        sk, gk = load("sk", "bfv4096_sk.bin", ctx), load("gk", "bfv4096_glk.bin", ctx)
        be, dec, ev = BatchEncoder(ctx), Decryptor(ctx, sk), Evaluator(ctx)
        for name in ["bfv4096_ct", "bfv4096_ct_zlib"] + (["bfv4096_ct_zstd"] if S._HAS_ZSTD else []):
            ct = load("ct", f"{name}.bin", ctx)
            check(S.ciphertext_save(ct, S.COMPR_NONE) == blob("bfv4096_ct.bin"), f"wire: {name}.bin re-saved")
            got = be.decode(dec.decrypt(ev.rotate_rows(ct, 1, gk)))
            check(all(got[i] == v for i, v in manifest["bfv4096_rot_slot"].items()),
                  f"wire: {name}.bin rotated does not give the manifest's slots")
        ctx = ctxs["bgv"]
        dec = Decryptor(ctx, load("sk", "bgv_sk.bin", ctx))
        load("pk", "bgv_pk.bin", ctx)
        for name in ("bgv_ct", "bgv_ct_seeded"):
            got = dec.decrypt(load("ct", f"{name}.bin", ctx)).to_string()
            check(got == manifest["bgv_pt_hex"], f"wire: {name}.bin decrypts to {got!r}")
        ctx = ctxs["ckks"]
        dec, enc = Decryptor(ctx, load("sk", "ckks_sk.bin", ctx)), CKKSEncoder(ctx)
        load("pk", "ckks_pk.bin", ctx)
        worst = 0.0
        for name in ("ckks_ct", "ckks_ct_seeded", "ckks_pt"):
            obj = load("pt" if name == "ckks_pt" else "ct", f"{name}.bin", ctx)
            vals = enc.decode(obj if name == "ckks_pt" else dec.decrypt(obj))
            err = max(max(abs(vals[i].real - v), abs(vals[i].imag)) for i, v in manifest["ckks_val"].items())
            check(err < 1e-3, f"wire: {name}.bin decodes {err} from the manifest")
            worst = max(worst, err)
        return worst

    worst, blob_launches = counted(serve_blobs)
    check(blob_launches["ntt"] > 0 and blob_launches["switch_key"] > 0,
          f"wire: SEAL's blobs were served without kernels A and B: {blob_launches}")
    print(f"[wire] (a) Microsoft SEAL's blobs: the four parameter sets save back byte for byte; the port's "
          f"fixed-seed secret keys (bfv, bgv, ckks, bfv4096), bfv public, relinearization and Galois keys and "
          f"bfv4096 public and Galois keys, made on the card, equal the reference's blobs byte for byte; "
          f"{len(loaded)} loads onto the card, each passing valcheck.is_valid_for (key rows as public keys); "
          f"bfv_ct, bfv_ct_seeded, the zlib{' and zstd' if S._HAS_ZSTD else ''} blobs decrypt to bfv_pt_hex; "
          f"bfv_ct x bfv_ct -> relinearize (bfv_rlk and bfv_rlk_seeded) + bfv_ct and bfv_ct_prod decrypt to "
          f"bfv_prod_hex; rotate_rows(1) with bfv_glk, bfv_glk_seeded and bfv4096_glk gives the expected slots; "
          f"bgv_ct and bgv_ct_seeded decrypt to bgv_pt_hex; ckks_ct, ckks_ct_seeded and ckks_pt decode within "
          f"{worst:.2e} of the manifest (bound 1e-3); launches: kernel A {blob_launches['ntt']}, kernel B "
          f"{blob_launches['switch_key']}; {time.perf_counter() - t_a:.1f} s")
    del ctxs

    # ---- (b) the N=32768 linear-layer request over the wire ----------------
    t_b = time.perf_counter()
    requests = 4
    scale = golden.LINEAR_SCALE
    step = golden.linear_layer_step
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, WIRE_CLIENT_SEED))
    cctx = SealContext(parms, True, SecurityLevel.TC128)
    kg = KeyGenerator(cctx)
    sk = kg.secret_key
    rk = kg.create_relin_keys(save_seed=True)
    gk = kg.create_galois_keys_from_steps([1], save_seed=True)
    enc = CKKSEncoder(cctx)
    rng = np.random.default_rng(WIRE_SLOT_SEED)
    vs = [rng.uniform(-1, 1, n // 2) for _ in range(requests)]
    w = rng.uniform(-1, 1, n // 2)
    pw = enc.encode(w, scale)
    sym = Encryptor(cctx, secret_key=sk)
    cts = [sym.encrypt_symmetric(enc.encode(v, scale), save_seed=True) for v in vs]
    torch.cuda.synchronize()
    client_s = time.perf_counter() - t_b

    def unseeded_ct(ct):
        out = ct.copy()
        out.seed_info = None
        return out

    def unseeded_keys(keys):
        out = type(keys)()
        out.parms_id = keys.parms_id
        out.keys = [None if e is None else {"c0": e["c0"], "c1": e["c1"], "seeds": None} for e in keys.keys]
        return out

    full_cts = [unseeded_ct(c) for c in cts]
    objects = {  # kind: (saver, the object as the client sends it, its full form)
        "params": (lambda o, m: S.params_save(o, m), parms, None),
        "secret key": (S.secret_key_save, sk, None),
        "plaintext": (S.plaintext_save, pw, None),
        "ciphertext": (S.ciphertext_save, cts[0], full_cts[0]),
        "relin key": (lambda o, m: S.kswitch_keys_save(o, cctx, m), rk, unseeded_keys(rk)),
        "Galois key": (lambda o, m: S.kswitch_keys_save(o, cctx, m), gk, unseeded_keys(gk)),
    }
    sizes, save_ms, blobs = {}, {}, {}

    def save_one(label, mode, save, obj):
        raw, ms = timed(lambda: save(obj, modes[mode]))
        sizes[(label, mode)], save_ms[(label, mode)], blobs[(label, mode)] = len(raw), ms, raw

    # the full keys' compressed forms, only there to show what the seeds
    # save, are written two at a time in threads (zlib and zstd release
    # the GIL); every other save runs alone
    with ThreadPoolExecutor(2) as pool:
        pending = []
        for kind, (save, sent, full) in objects.items():
            for form, obj in (("seeded", sent), ("full", full)) if full is not None else (("", sent),):
                label = f"{kind}{' ' + form if form else ''}"
                for mode in modes:
                    if form == "full" and "key" in kind and mode != "none":
                        pending.append((label, mode, save, obj))
                    else:
                        save_one(label, mode, save, obj)
        for future in [pool.submit(save_one, *args) for args in pending]:
            future.result()
    request = {mode: {"params": blobs[("params", mode)], "plaintext": blobs[("plaintext", mode)],
                      "relin key": blobs[("relin key seeded", mode)], "Galois key": blobs[("Galois key seeded", mode)],
                      "cts": [blobs[("ciphertext seeded", mode)]] + [S.ciphertext_save(c, m) for c in cts[1:]]}
               for mode, m in modes.items()}
    k = len(cctx.first_context_data().coeff_modulus_values)
    k_key = len(cctx.key_context_data().coeff_modulus_values)
    # a seeded ciphertext drops c1 (8 k n bytes) and stores its seed (a
    # header and 65 bytes); each of a seeded key's D rows likewise
    check(sizes[("ciphertext full", "none")] - sizes[("ciphertext seeded", "none")] == 8 * k * n - 81,
          "wire: the seeded ciphertext does not drop c1")
    for label in ("relin key", "Galois key"):
        check(sizes[(f"{label} full", "none")] - sizes[(f"{label} seeded", "none")] == k * (8 * k_key * n - 81),
              f"wire: the seeded {label} does not drop c1")
    print(f"[wire] (b) CKKS N={n}, CoeffModulus.bfv_default({n}) ({k_key} moduli), SecurityLevel.TC128: client keygen (seeded BLAKE2XB; relinearization and Galois "
          f"(element {golden.LINEAR_GALOIS_ELT}) keys with save_seed), {requests} encrypt_symmetric(save_seed=True) of "
          f"uniform(-1, 1) vectors and one weight plaintext at 2^40 in {client_s:.1f} s on the card")
    print(f"[wire] bytes per object ({card_line}): " + "; ".join(
        f"{label} " + ", ".join(f"{mode} {sizes[(label, mode)]}" for mode in modes)
        for label in dict.fromkeys(lbl for lbl, _ in sizes)))
    print(f"[wire] save ms per object (host clock to a synchronize, {card_line}; the full keys' compressed forms two "
          f"at a time in threads): " + "; ".join(
        f"{label} " + ", ".join(f"{mode} {save_ms[(label, mode)]:.1f}" for mode in modes)
        for label in dict.fromkeys(lbl for lbl, _ in save_ms)))

    # the server: a context from the parameters' bytes, every object loaded and checked
    sparms, _ = S.params_load(request["none"]["params"])
    sctx = SealContext(sparms, True, SecurityLevel.TC128)
    key_moduli = sctx.key_context_data().coeff_modulus_values
    first_moduli = sctx.first_context_data().coeff_modulus_values
    loads, host_parts = {}, {}

    def load_split(label, mode, load, host_shapes, seeds, moduli):
        """Load a blob and split its time: decompression, seed expansion,
        host-to-device copy (the last two timed alone once per object),
        valcheck, and the rest: the total less the parts, parsing and host
        copies (it may fall below 0 by the runs' spread)."""
        raw = blobs[(label, mode)]
        obj, total = timed(lambda: load(raw))
        _, decompress = timed(lambda: S.load_header_wrapped(raw))
        if label not in host_parts:                      # the same in every mode
            expand = sum(timed(lambda: sample_poly_uniform(seed.make_prng(), n, moduli))[1] for seed in seeds)
            h2d = sum(timed(lambda: u64_from_numpy(np.zeros(shape, dtype=np.uint64), sctx.device))[1]
                      for shape in host_shapes)
            host_parts[label] = expand, h2d
        expand, h2d = host_parts[label]
        ok, check_ms = timed(lambda: valid_for(obj, sctx))
        check(ok, f"wire: the loaded {label} ({mode}) fails valcheck.is_valid_for")
        loads[(label, mode)] = {"load_ms": total, "decompress_ms": decompress, "expand_ms": expand,
                                "h2d_ms": h2d, "valcheck_ms": check_ms,
                                "parse_ms": total - decompress - expand - h2d}
        return obj

    def load_rk(b):
        return S.kswitch_keys_load(b, sctx, RelinKeys)[0]

    def load_gk(b):
        return S.kswitch_keys_load(b, sctx, GaloisKeys)[0]

    def load_ct(b):
        return S.ciphertext_load(b, sctx)[0]

    server = {}
    for mode in modes:
        server[mode] = {
            "relin key": load_split("relin key seeded", mode, load_rk, [(k, k_key, n)] * 2, rk.keys[0]["seeds"],
                                    key_moduli),
            "Galois key": load_split("Galois key seeded", mode, load_gk, [(k, k_key, n)] * 2,
                                     gk.key(golden.LINEAR_GALOIS_ELT)["seeds"], key_moduli),
            "plaintext": load_split("plaintext", mode, lambda b: S.plaintext_load(b, sctx)[0], [(k, n)], [],
                                    first_moduli),
            "ciphertext": load_split("ciphertext seeded", mode, load_ct, [(2, k, n)], [cts[0].seed_info],
                                     first_moduli),
        }
        load_split("relin key full", mode, load_rk, [(k, k_key, n)] * 2, [], key_moduli)
        load_split("Galois key full", mode, load_gk, [(k, k_key, n)] * 2, [], key_moduli)
        full_ct = load_split("ciphertext full", mode, load_ct, [(2, k, n)], [], first_moduli)
        check(torch.equal(full_ct.data, full_cts[0].data), f"wire: the full ciphertext ({mode}) differs")
    print(f"[wire] load ms per object ({card_line}; host clock to a synchronize; split into decompression, seed "
          f"expansion, host-to-device copy, valcheck and the rest, parsing and host copies): " + "; ".join(
              f"{label} {mode}: {v['load_ms']:.1f} (decompress {v['decompress_ms']:.1f}, expand {v['expand_ms']:.1f}, "
              f"h2d {v['h2d_ms']:.1f}, parse {v['parse_ms']:.1f}) + valcheck {v['valcheck_ms']:.1f}"
              for (label, mode), v in loads.items()))

    # every loaded object equals the object that was saved
    srv = server["none"]
    for mode in modes:
        s = server[mode]
        for name, keys in (("relin key", rk), ("Galois key", gk)):
            check(all((a is None) == (b is None) and (a is None or (torch.equal(a["c0"], b["c0"])
                                                                     and torch.equal(a["c1"], b["c1"])))
                      for a, b in zip(s[name].keys, keys.keys)) and len(s[name].keys) == len(keys.keys),
                  f"wire: the loaded {name} ({mode}) differs from the saved one")
        check(s["plaintext"] == pw and s["ciphertext"].seed_info is None
              and torch.equal(s["ciphertext"].data, full_cts[0].data), f"wire: loaded objects ({mode}) differ")
    check(sparms.parms_id == parms.parms_id and sctx.first_parms_id == cctx.first_parms_id,
          "wire: the server's parameters differ from the client's")
    srk, sgk, spt = srv["relin key"], srv["Galois key"], srv["plaintext"]
    ev, bev, ev_fast = Evaluator(sctx), BatchEvaluator(sctx), Evaluator(sctx, throw_on_transparent=False)

    def serve_request(blob_in, evaluator):
        """Bytes in to bytes out: load, check, serve, save."""
        ct, _ = S.ciphertext_load(blob_in, sctx)
        check(V.is_valid_for(ct, sctx), "wire: a request fails valcheck.is_valid_for")
        return S.ciphertext_save(step(evaluator, ct, spt, sgk, srk), S.COMPR_NONE)

    def serve_all(evaluator, mode="none"):
        return [serve_request(b, evaluator) for b in request[mode]["cts"]]

    # in memory: the client's own objects, served by an evaluator of the client's context
    mev = Evaluator(cctx)
    memory = [step(mev, c, pw, gk, rk) for c in full_cts]
    replies, wire_launches = counted(lambda: serve_all(ev))
    check(wire_launches == {"ntt": 8 * requests, "switch_key": 2 * requests, "four_step_stage": 0},
          f"wire: {requests} requests over the wire launched {wire_launches}")
    one, one_launches = counted(lambda: step(ev, S.ciphertext_load(request["none"]["cts"][0], sctx)[0], spt, sgk, srk))
    check(one_launches == {"ntt": 8, "switch_key": 2, "four_step_stage": 0},
          f"wire: one request launched {one_launches}; expected 8 of kernel A, 2 of kernel B, 0 stage")
    for r in range(requests):
        check(replies[r] == S.ciphertext_save(memory[r], S.COMPR_NONE),
              f"wire: reply {r} differs from serving the in-memory objects")
    for mode in modes:
        if mode != "none":
            check(serve_all(ev, mode) == replies, f"wire: the {mode} request gives other replies")
    batch_in = CiphertextBatch.from_ciphertexts([S.ciphertext_load(b, sctx)[0] for b in request["none"]["cts"]])
    batch_out, batch_launches = counted(lambda: step(bev, batch_in, spt, sgk, srk))
    check(batch_launches == {"ntt": 8, "switch_key": 2, "four_step_stage": 0},
          f"wire: the batch launched {batch_launches}; expected 8 of kernel A, 2 of kernel B, 0 stage")
    batch_replies = [S.ciphertext_save(batch_out[r], S.COMPR_NONE) for r in range(requests)]
    check(batch_replies == replies, "wire: the batch's replies differ from the sequential ones")
    fast = serve_all(ev_fast)
    check(fast == replies, "wire: throw_on_transparent=False gives other replies")

    # timings: bytes in to bytes out against the step on in-memory objects
    in_memory = [S.ciphertext_load(b, sctx)[0] for b in request["none"]["cts"]]
    runs = {"wire": [], "wire, throw_on_transparent=False": [], "in memory": [], "in memory, batch": []}
    for _ in range(3):
        runs["wire"].append(timed(lambda: serve_all(ev))[1] / requests)
        runs["wire, throw_on_transparent=False"].append(timed(lambda: serve_all(ev_fast))[1] / requests)
        runs["in memory"].append(timed(lambda: [step(ev, c, spt, sgk, srk) for c in in_memory])[1] / requests)
        runs["in memory, batch"].append(timed(lambda: step(bev, batch_in, spt, sgk, srk))[1] / requests)
    part = {"load": [], "valcheck": [], "step": [], "save": []}
    for b in request["none"]["cts"]:
        ct, ms = timed(lambda: S.ciphertext_load(b, sctx)[0])
        part["load"].append(ms)
        part["valcheck"].append(timed(lambda: V.is_valid_for(ct, sctx))[1])
        out, ms = timed(lambda: step(ev, ct, spt, sgk, srk))
        part["step"].append(ms)
        part["save"].append(timed(lambda: S.ciphertext_save(out, S.COMPR_NONE))[1])
    print(f"[wire] (b) {requests} requests loaded (seeded, none{', zlib, zstd' if S._HAS_ZSTD else ', zlib'}), "
          f"checked with is_valid_for, served through multiply_plain -> rotate_vector(1) -> multiply -> relinearize "
          f"-> rescale_to_next and saved: replies equal to serving the client's in-memory objects, in every mode; "
          f"the batch of {requests} through BatchEvaluator equal to the sequential replies; kernel A 8 launches and "
          f"kernel B 2 per request and per batch, no stage launch")
    print(f"[wire] ms per request ({card_line}; host clock to a synchronize, median of 3 runs of {requests}): "
          + ", ".join(f"{label} {_median(v):.3f} (runs {', '.join(f'{x:.3f}' for x in v)})" for label, v in runs.items())
          + "; one request's parts (median of the 4): " + ", ".join(f"{p} {_median(v):.3f}" for p, v in part.items()))

    # the client again: the replies decrypted one by one and as a batch
    dec = Decryptor(cctx, sk)
    reply_cts = [S.ciphertext_load(r, cctx)[0] for r in replies]
    plains = [dec.decrypt(c) for c in reply_cts]
    reply_batch = CiphertextBatch.from_ciphertexts(reply_cts)
    batch_plains = dec.decrypt_batch(reply_batch)
    for r in range(requests):
        check(torch.equal(plains[r].rns_data, batch_plains[r].rns_data), f"wire: decrypt_batch differs at {r}")
    worst = 0.0
    for r, v in enumerate(vs):
        got = enc.decode(plains[r])
        check(got.shape == (n // 2,) and np.isfinite(got).all(), f"wire: decoded reply {r} is malformed")
        err = float(np.max(np.abs(got.real - np.roll(v * w, -1) * v)))
        check(err < 1e-3, f"wire: decoded reply {r} is {err} from np.roll(v*w, -1) * v")
        worst = max(worst, err)
    dec_ms = [timed(lambda: [dec.decrypt(c) for c in reply_cts])[1] for _ in range(3)]
    batch_ms = [timed(lambda: dec.decrypt_batch(reply_batch))[1] for _ in range(3)]
    print(f"[wire] (b) the client loads the {requests} replies; decrypt of each equals decrypt_batch of the batch; "
          f"decoded within {worst:.3e} of np.roll(v*w, -1) * v (bound 1e-3); {requests} decrypt calls "
          f"{_median(dec_ms):.3f} ms, decrypt_batch {_median(batch_ms):.3f} ms ({card_line}, median of 3)")
    print(f"[wire] (c) Evaluator(ctx, throw_on_transparent=False): the same reply bytes; "
          f"{_median(runs['wire, throw_on_transparent=False']):.3f} ms per request over the wire against "
          f"{_median(runs['wire']):.3f} with the check (an observation, not a claim)")
    del cctx, sctx, server, srv, srk, sgk, rk, gk, kg, mev, memory, batch_in, batch_out, in_memory
    torch.cuda.empty_cache()
    timing = {"ms_per_request_wire": _median(runs["wire"]), "ms_per_request_in_memory": _median(runs["in memory"])}
    return {name: {"launches_per_request": one_launches[name], "launches_per_batch": batch_launches[name],
                   "seal_blob_launches": blob_launches[name], **timing} for name in ("ntt", "switch_key")}


def blake2xb_work(S, nwords):
    """Bytes and 32-bit operations of one kernel-C call: the seeds in and
    the words out; the compressions the stream needs (the key block, a root
    per buffer, a node per 8 words)."""
    compressions = S * (1 + -(-nwords // 512) + -(-nwords // 8))
    return 8 * S * (8 + nwords), compressions * OPS_COMPRESS


def u64_max_abs_err(got, want):
    """max |got - want| of two equal-shaped integer tensors, int64 ones read
    as the u64 words they hold."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if a.dtype == np.int64:
        a, b = a.view(np.uint64), b.view(np.uint64)
    else:
        a, b = a.astype(np.int64), b.astype(np.int64)
    return int(np.max(np.where(a >= b, a - b, b - a))) if a.size else 0


def uniform_work(S, k, n):
    """Kernel D's bulk pass: a word in and a residue out per (stream, limb,
    coefficient), the counts; a compare, a Barrett reduction (two 64-bit
    products, two subtractions) per word."""
    return 16 * S * k * n + 4 * S * k + 24 * k, S * k * n * (3 * OPS_ADD64 + 2 * OPS_MUL64)


def cbd_work(S, k, n):
    """Kernel D's CBD pass: 6 bytes in per coefficient, a residue out per
    limb; six popcounts, two masks and five adds per coefficient, a select
    per limb."""
    return 6 * S * n + 8 * S * k * n + 8 * k, S * n * 13 + S * k * n * OPS_ADD64


class host_sampling:
    """``SEAL_TPU_DEVICE_SAMPLING=0`` inside the block: keygen and
    encryption sample on the host, as the JAX package then does."""

    def __enter__(self):
        self.before = os.environ.get("SEAL_TPU_DEVICE_SAMPLING")
        os.environ["SEAL_TPU_DEVICE_SAMPLING"] = "0"

    def __exit__(self, *exc):
        if self.before is None:
            del os.environ["SEAL_TPU_DEVICE_SAMPLING"]
        else:
            os.environ["SEAL_TPU_DEVICE_SAMPLING"] = self.before


def sampling_phase(gen, device=None, sizes=(8192, 32768, 65536)):
    """Phase 14: device sampling.  (a) kernels C and D against their plain
    versions and the host stream at one relinearization key's shapes; (b)
    keygen on the device path against the host path, byte for byte, with
    its launches, and the client's keygen and encryption times on both
    paths; (c) a seeded encryption saved and loaded.  Returns kernels C's
    and D's numbers by entry point and N, and the client's ms by N and step,
    for the kernels' JSON line.  ``sizes``: (a) and (b) run at the first two,
    (b)'s times at all three, (c) at the second."""
    from seal_tpu_torch import (CKKSEncoder, CoeffModulus, EncryptionParameters, Encryptor, KeyGenerator,
                                PRNGType, SchemeType, SealContext, SecurityLevel, UniformRandomGeneratorFactory)
    from seal_tpu_torch import golden, rlwe
    from seal_tpu_torch import serialization as S
    from seal_tpu_torch.convert import u64_to_numpy
    from seal_tpu_torch.ops import blake2_dev as B
    from seal_tpu_torch.ops.cuda_blake2 import cbd_lifted_cuda, expand_stream_words_cuda, uniform_bulk_cuda
    from seal_tpu_torch.random.prng import Blake2xbPRNG

    class FreshSeeds(UniformRandomGeneratorFactory):
        """A BLAKE2XB factory whose create() draws a new seed at each call
        from numpy, seeded; restart() replays the draws, so that the device
        and the host path get the same seeds in the same order while a
        key's D bootstrap streams all differ (a fixed-seed factory makes
        them equal, and a row taken from the wrong stream could not show)."""

        def __init__(self, seed):
            super().__init__(PRNGType.BLAKE2XB)
            self.seed = seed
            self.restart()

        def restart(self):
            self.rng = np.random.default_rng([SAMPLING_SEED, self.seed])

        def create(self, seed=None):
            if seed is None:
                seed = tuple(int(w) for w in self.rng.integers(0, 1 << 64, size=8, dtype=np.uint64))
            return super().create(seed)

    t_phase = time.time()
    fallbacks = rlwe.host_fallbacks

    def context(n):
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        bits = {8192: golden.GOLDEN_BITS, 65536: golden.LARGE_BITS}.get(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)) if bits else CoeffModulus.bfv_default(n))
        parms.set_random_generator(FreshSeeds(n))
        return SealContext(parms, True, SecurityLevel.NONE if bits else SecurityLevel.TC128, device=device)

    contexts = {n: context(n) for n in sizes}

    # ---- (a) kernels C and D at one relinearization key's shapes ---------------
    kernels = {name: {} for name in ("blake2xb", "sample_uniform", "sample_cbd")}
    max_err = dict.fromkeys(kernels, 0)
    # kernels a call records on the card: kernel C's root and node passes,
    # the zero fill of the bulk pass's counts and its kernel, the CBD pass
    per_call = {"blake2xb": 2, "sample_uniform": 2, "sample_cbd": 1}
    for n in sizes[:2]:
        ctx = contexts[n]
        moduli = tuple(ctx.key_context_data().coeff_modulus_values)
        k, D = len(moduli), len(ctx.first_context_data().parms.coeff_modulus)
        dev = ctx.device
        seeds = torch.randint(-(1 << 63), (1 << 63) - 1, (D, 8), dtype=torch.int64, device=dev, generator=gen)
        nw_noise = (64 + 6 * n + 7) // 8
        nw_uniform = k * n + B.uniform_tail_words(n, moduli)[1]
        boot = expand_stream_words_cuda(seeds, nw_noise)
        public = boot[:, :8].contiguous()
        words = expand_stream_words_cuda(public, nw_uniform)
        q, mm, rhi = B.uniform_constants(moduli, dev)
        vals, counts = uniform_bulk_cuda(words, n, q, mm, rhi)
        noise = cbd_lifted_cuda(boot, n, q, 64)
        torch.cuda.synchronize()
        want_vals, want_counts = B.uniform_bulk_plain(words, n, moduli)
        for name, label, got, want in (
                ("blake2xb", "kernel C, the noise streams", boot, B.expand_stream_words_plain(seeds, nw_noise)),
                ("blake2xb", "kernel C, the uniform streams", words, B.expand_stream_words_plain(public, nw_uniform)),
                ("sample_uniform", "kernel D, the uniform values", vals, want_vals),
                ("sample_uniform", "kernel D, the rejection counts", counts, want_counts),
                ("sample_cbd", "kernel D, the CBD noise", noise, B.cbd_lifted_plain(boot, n, moduli, 64))):
            err = u64_max_abs_err(got, want)
            check(err == 0 and torch.equal(got, want), f"N={n}: {label} differ from the plain version: max abs "
                                                       f"err {err}")
            max_err[name] = max(max_err[name], err)
        for i in (0, D - 1):
            for label, sd, got, nw in (("noise", seeds, boot, nw_noise), ("uniform", public, words, nw_uniform)):
                host = Blake2xbPRNG(tuple(int(w) for w in u64_to_numpy(sd[i]))).generate(8 * nw)
                check(u64_to_numpy(got[i]).tobytes() == host, f"N={n}: kernel C's {label} stream {i} differs from "
                                                               f"the host BLAKE2xb stream")
        calls = {
            "blake2xb": [(lambda: expand_stream_words_cuda(seeds, nw_noise),
                          lambda: B.expand_stream_words_plain(seeds, nw_noise), blake2xb_work(D, nw_noise)),
                         (lambda: expand_stream_words_cuda(public, nw_uniform),
                          lambda: B.expand_stream_words_plain(public, nw_uniform), blake2xb_work(D, nw_uniform))],
            "sample_uniform": [(lambda: uniform_bulk_cuda(words, n, q, mm, rhi),
                                lambda: B.uniform_bulk_plain(words, n, moduli), uniform_work(D, k, n))],
            "sample_cbd": [(lambda: cbd_lifted_cuda(boot, n, q, 64),
                            lambda: B.cbd_lifted_plain(boot, n, moduli, 64), cbd_work(D, k, n))],
        }
        for name, fns in calls.items():
            tot = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
            recorded, iters = {}, 100 if n < 32768 else 30
            for kernel, plain, (nbytes, ops) in fns:
                ms, events_ms = kernel_ms(kernel, iters, launches=per_call[name], recorded=recorded)
                tot["ms"] += ms
                tot["events_ms"] += events_ms
                tot["plain_ms"] += cuda_ms(plain, 3, warmup=1)
                tot["bytes"] += nbytes
                tot["ops"] += ops
            b, by = bound_ms(tot["bytes"], tot["ops"])
            kernels[name][n] = {"ms": tot["ms"], "events_ms": tot["events_ms"], "plain_ms": tot["plain_ms"],
                                "bound_ms": b, "bound_by": by, "calls": len(fns),
                                "device_ops_per_call": per_call[name]}
            expected = len(fns) * min(iters, 50) * per_call[name]
            print(f"[sampling] (a) N={n}, one relinearization key (D={D} streams, k_key={k}): {name} bit-exact, "
                  f"{len(fns)} call(s) of {per_call[name]} device operation(s) each: kernel "
                  f"{tot['ms'] * 1e3:.2f} us device time (the mean recorded operation times {per_call[name]}; the "
                  f"traces held {recorded.get('events', 0)} operations of {expected}), {tot['events_ms'] * 1e3:.2f} us "
                  f"back to back by events; plain {tot['plain_ms'] * 1e3:.1f} us by events; bound "
                  f"{b * 1e3:.3f} us ({by}: {tot['bytes'] / 1e6:.2f} MB, {tot['ops'] / 1e9:.3f} G 32-bit operations)")
        print(f"[sampling] (a) N={n}: kernel C's streams 0 and {D - 1} equal the host BLAKE2xb stream; "
              f"{int(counts.sum())} uniform words rejected")
        del boot, public, words, vals, counts, noise, want_vals, want_counts, calls

    # ---- (b) keygen: the device path against the host path ---------------------
    def keys(n):
        contexts[n].key_context_data().parms.random_generator.restart()
        kg = KeyGenerator(contexts[n])
        out = []
        for save_seed in (False, True):
            rk = kg.create_relin_keys(save_seed=save_seed).keys[0]
            out += [rk["c0"], rk["c1"], [s.seed for s in rk["seeds"]] if save_seed else None]
            if save_seed:
                check(len(set(out[-1])) == rk["c1"].shape[0], f"(b) N={n}: the key's public seeds are not distinct")
        gk = kg.create_galois_keys_from_steps([1])
        g = gk.key(3)
        pk = kg.create_public_key(save_seed=True)
        return out + [g["c0"], g["c1"], pk.data.data, pk.data.seed_info.seed]

    host_keys = {}
    with host_sampling():
        for n in sizes[:2]:
            host_keys[n] = keys(n)
    # per key, and per encryption: kernel C twice (the bootstrap streams, the
    # uniform streams), kernel D once for each entry point; four keys per N
    dev_keys = sampled("14b", lambda: {n: keys(n) for n in sizes[:2]})
    check(SAMPLING["14b"] == {"blake2xb": 16, "sample_uniform": 8, "sample_cbd": 8},
          f"(b) keygen launched kernels C and D {SAMPLING['14b']}, predicted 16, 8 and 8")
    for n in sizes[:2]:
        for i, (got, want) in enumerate(zip(dev_keys[n], host_keys[n])):
            same = torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want
            check(same, f"(b) N={n}: key part {i} on the device path differs from the host path")
    del dev_keys, host_keys
    print(f"[sampling] (b) N={sizes[0]} and N={sizes[1]}, a BLAKE2XB factory handing out a distinct seed per draw "
          f"(replayed for each path): relinearization keys (with and without save_seed), "
          f"the Galois key of step 1 and the seeded public key on the device path equal to the host path byte for "
          f"byte, seeds included; 2 launches of kernel C and 1 of each entry point of kernel D per key")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    client_ms = {}
    for n, ctx in contexts.items():
        kg = KeyGenerator(ctx)
        plain = CKKSEncoder(ctx).encode(np.linspace(-1.0, 1.0, n // 2), 2.0 ** 40)
        sym = Encryptor(ctx, secret_key=kg.secret_key)
        steps = {"create_relin_keys()": kg.create_relin_keys,
                 "create_galois_keys_from_steps([1])": lambda: kg.create_galois_keys_from_steps([1]),
                 "encrypt_symmetric": lambda: sym.encrypt_symmetric(plain)}
        client_ms[n] = {}
        for name, fn in steps.items():
            runs = {"device": [], "host": []}
            for path in ("host", "device", "device", "host", "host", "device", "device", "host"):
                if path == "host":
                    with host_sampling():
                        runs[path].append(timed(fn))
                else:
                    runs[path].append(timed(fn))
            # the first run of each path warms up
            dev_ms, host_ms = _median(runs["device"][1:]), _median(runs["host"][1:])
            client_ms[n][name] = {"device_ms": dev_ms, "host_ms": host_ms}
            print(f"[sampling] (b) N={n} {name}: device path {dev_ms:.3f} ms, host path {host_ms:.3f} ms (medians "
                  f"of 3 after a warm-up, interleaved; device runs "
                  f"{', '.join(f'{v:.3f}' for v in runs['device'][1:])}, host runs "
                  f"{', '.join(f'{v:.3f}' for v in runs['host'][1:])})")
        del kg, plain, sym, steps
    check(rlwe.host_fallbacks == fallbacks, f"{rlwe.host_fallbacks - fallbacks} draws overflowed to the host")

    # ---- (c) a seeded encryption over the wire --------------------------------
    ctx = contexts[sizes[1]]
    kg = KeyGenerator(ctx)
    plain = CKKSEncoder(ctx).encode(np.linspace(-1.0, 1.0, sizes[1] // 2), 2.0 ** 40)
    factory = ctx.key_context_data().parms.random_generator
    factory.restart()
    ct = Encryptor(ctx, secret_key=kg.secret_key).encrypt_symmetric(plain, save_seed=True)
    factory.restart()
    with host_sampling():
        host_ct = Encryptor(ctx, secret_key=kg.secret_key).encrypt_symmetric(plain, save_seed=True)
    check(torch.equal(ct.data, host_ct.data) and ct.seed_info == host_ct.seed_info,
          "(c) the seeded encryption differs from the host path")
    t0 = time.perf_counter()
    raw = S.ciphertext_save(ct, S.COMPR_NONE)
    loaded, used = S.ciphertext_load(raw, ctx)
    torch.cuda.synchronize()
    wire_ms = (time.perf_counter() - t0) * 1e3
    check(used == len(raw) and loaded.parms_id == ct.parms_id and loaded.scale == ct.scale,
          "(c) the seeded ciphertext did not load back whole")
    check(torch.equal(loaded.data, ct.data), "(c) the loaded ciphertext (c1 expanded on the host from its seed) "
                                             "differs from the one kernels C and D sampled")
    print(f"[sampling] (c) N={sizes[1]}: encrypt_symmetric(save_seed=True) on the device path equals the host path; "
          f"saved ({len(raw)} bytes) and loaded with c1 expanded from its seed on the host in {wire_ms:.1f} ms, equal "
          f"to the ciphertext in memory")
    print(f"[sampling] phase 14 in {time.time() - t_phase:.1f} s; {rlwe.host_fallbacks - fallbacks} host fallbacks")
    return kernels, client_ms, max_err


def tooling_mesh_phase(card, gen, card_line, ckks, bfv_outs, bgv_outs, sampling):
    """Phase 15: BFV and BGV on an 8-rank mesh of the card, the (host 2,
    data 2, limb 2) mesh with replicated keys and the dryrun, debug mode on
    the card, the example twins, and the event timers' cross-check of
    kernels C and D.  ``ckks``: phase 4's (context, requests, relinearization
    keys, outputs); ``bfv_outs``/``bgv_outs``: phases 11's and 12's batch
    outputs by N; ``sampling``: phase 14's kernel numbers; ``card``: the
    device of every rank.  Returns the mesh entries of kernels A and B for
    the kernels' JSON line and (f)'s times."""
    import contextlib
    import importlib
    import io

    from seal_tpu_torch import CoeffModulus, dryrun, golden, profiling
    from seal_tpu_torch.convert import (ciphertext_from_numpy, galois_keys_from_numpy, relin_keys_from_numpy,
                                        u64_from_numpy, u64_to_numpy)
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.examples import NAMES
    from seal_tpu_torch.ops import blake2_dev as B
    from seal_tpu_torch.ops.cuda_blake2 import expand_stream_words_cuda, uniform_bulk_cuda
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda
    from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
    from seal_tpu_torch.parallel.mesh import make_mesh, split_bounds
    from seal_tpu_torch.pipeline import build_bfv_mult_relin

    ranks = [card] * 8

    def counted(fn):
        """fn() with the three counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        ntt_cuda.launches = switch_key_contract_cuda.launches = stage_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, (ntt_cuda.launches, switch_key_contract_cuda.launches, stage_cuda.launches)

    def timed(fn, count, runs=3):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / count)
        return times

    # ---- (a), (b) BFV and BGV on the (data 4, limb 2) mesh ---------------------
    # Launches per batch, from the code (parallel/sharded.py): a rank that
    # holds some of the level's k limbs runs
    # - BFV's multiply (bfv_multiply): kernel A for the forward and the
    #   t-scaled inverse NTT over its q limbs and Bsk: 2;
    # - a BFV key switch: kernel B once; kernel A for the tail's two inverse
    #   NTTs (mod the special prime, and of its limbs of the sum): 2;
    # - a BGV key switch: kernel B once; kernel A for the inverse NTT of its
    #   limbs of the target and the tail's inverse and forward NTT: 3;
    # and a rank that holds limbs below the last runs BGV's mod-t switch
    # (mod_switch): kernel A for the inverse NTT of the broadcast last limb
    # and the forward NTT of its limbs' correction: 2.  At k = 4 (2 + 2) and
    # k = 15 (8 + 7) every rank does all of it: A 32 and B 8 per BFV batch,
    # A 64 and B 16 per BGV batch.
    hem = make_mesh(8, limb_parallel=2, devices=ranks)

    def expect(scheme, k):
        ranges = split_bounds(k, 2) * 4
        holding = sum(hi > lo for lo, hi in ranges)
        switching = sum(min(hi, k - 1) > lo for lo, hi in ranges)
        if scheme == "bfv":
            return 4 * holding, holding, 0
        return 6 * holding + 2 * switching, 2 * holding, 0
    entries = {"ntt": {"bfv": {}, "bgv": {}}, "switch_key": {"bfv": {}, "bgv": {}}}
    for scheme, sizes in (("bfv", ((golden.BFV_N, 8), (golden.BFV_MEDIUM_N, 4))),
                          ("bgv", ((golden.BGV_N, 8), (golden.BGV_MEDIUM_N, 4)))):
        for n, requests in sizes:
            t_n = time.perf_counter()
            tag = f"[mesh {scheme} N={n}]"
            ctx = (golden.bfv_context if scheme == "bfv" else golden.bgv_context)(n, card)
            k = len(ctx.first_context_data().coeff_modulus_values)
            rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, card)
            galois = [None] * n
            galois[golden.BGV_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.BGV_GALOIS_SEED)
            gk = galois_keys_from_numpy(galois, ctx.key_parms_id, card)
            cts = [tuple(ciphertext_from_numpy(d, ctx.first_parms_id, scheme == "bgv", 1.0, card)
                         for d in golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)) for r in range(requests)]
            b1, b2 = (CiphertextBatch.from_ciphertexts([c[i] for c in cts]) for i in range(2))
            bev = BatchEvaluator(ctx, hem)

            def serve():
                x, y = bev.shard(b1), bev.shard(b2)
                if scheme == "bfv":
                    return bev.relinearize(bev.multiply(x, y), rk)
                return golden.bgv_request(bev, x, y, rk, gk)

            serve()                                        # warm-up: plans and tables
            out, launches = counted(serve)
            check(launches == expect(scheme, k), f"{tag} launched (A, B, stage) {launches}; expected "
                                                 f"{expect(scheme, k)}")
            want = (bfv_outs if scheme == "bfv" else bgv_outs)[n]
            whole = out.unshard()
            check(torch.equal(whole.data, want.data) and whole.parms_id == want.parms_id
                  and whole.correction_factor == want.correction_factor,
                  f"{tag} the mesh's outputs differ from phase {11 if scheme == 'bfv' else 12}'s batch")
            dig = golden.digest(u64_to_numpy(whole.data[0]))
            want_dig = {(golden.BFV_N, "bfv"): golden.BFV_DIGEST, (golden.BFV_MEDIUM_N, "bfv"): golden.BFV_MEDIUM_DIGEST,
                        (golden.BGV_N, "bgv"): golden.BGV_DIGEST,
                        (golden.BGV_MEDIUM_N, "bgv"): golden.BGV_MEDIUM_DIGEST}[(n, scheme)]
            check(dig == want_dig, f"{tag} request 0's digest {dig}")
            split = [sh.shape[-2] for sh in out.data.shards[:2]]
            k_out = k if scheme == "bfv" else k - 1
            check(split == [hi - lo for lo, hi in split_bounds(k_out, 2)],
                  f"{tag} limbs split {split} over the limb axis for k={k_out}")
            times = timed(serve, requests)
            wall, n_dev, busy = profile_run(serve)
            prof_line = ("the profiler recorded no device time: not measured" if n_dev is None else
                         f"under the profiler {n_dev / requests:.1f} device launches per request, device busy "
                         f"{busy / requests:.3f} ms per request of wall {wall / requests:.3f} ms "
                         f"({100 * busy / wall:.1f}%)")
            median = sorted(times)[1]
            print(f"{tag} {requests} requests ({'multiply -> relinearize' if scheme == 'bfv' else 'golden.bgv_request'})"
                  f" as one batch on the (data 4, limb 2) mesh of 8 ranks of the card: equal to phase "
                  f"{11 if scheme == 'bfv' else 12}'s batch and the JAX package's digest, correction factor "
                  f"{whole.correction_factor}, limbs {k} -> {k_out} split {split}; launches per batch: kernel A "
                  f"{launches[0]}, kernel B {launches[1]}, stage {launches[2]} ({launches[0] / requests:g} and "
                  f"{launches[1] / requests:g} per request); ms per request over 3 runs "
                  f"{', '.join(f'{t:.3f}' for t in times)} (median {median:.3f}); {prof_line}; "
                  f"{time.perf_counter() - t_n:.1f} s")
            for kernel, index in (("ntt", 0), ("switch_key", 1)):
                entries[kernel][scheme][f"n{n}"] = {
                    "launches_per_batch": launches[index], "requests": requests, "ms_per_request": median,
                    "device_busy_ms_per_request": None if busy is None else busy / requests}
            del cts, b1, b2, out, whole, rk, gk, bev, ctx
            torch.cuda.empty_cache()

    # ---- (c) BFV on the (host 2, data 2, limb 2) mesh with replicated keys -----
    t_c = time.perf_counter()
    n = golden.BFV_N
    ctx = golden.bfv_context(n, card)
    rk = relin_keys_from_numpy([golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)], ctx.key_parms_id, card)
    galois = [None] * n
    galois[golden.BGV_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.BGV_GALOIS_SEED)
    gk = galois_keys_from_numpy(galois, ctx.key_parms_id, card)
    b1, b2 = (CiphertextBatch.from_ciphertexts([
        ciphertext_from_numpy(golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)[i], ctx.first_parms_id,
                              False, 1.0, card) for r in range(4)]) for i in range(2))
    hem3 = make_mesh(8, limb_parallel=2, hosts=2, replicate_keys=True, devices=ranks)
    check(hem3.host_size == 2 and hem3.batch_size == 4 and hem3.limb_size == 2, "the 3-axis mesh's shape")
    bev3, one = BatchEvaluator(ctx, hem3), BatchEvaluator(ctx)
    rk3 = bev3.ev.shard_keys(rk)
    check(all(s.shape == rk.key(2)["c0"].shape for s in rk3.key(2)["c0"].shards),
          "replicated keys: a rank does not hold the whole key")
    prod = bev3.multiply(bev3.shard(b1), bev3.shard(b2)).unshard()
    check(torch.equal(prod.data, one.multiply(b1, b2).data), "the 3-axis mesh's BFV product differs")
    rot = bev3.rotate_rows(bev3.shard(b1), 1, gk).unshard()
    check(torch.equal(rot.data, one.rotate_rows(b1, 1, gk).data), "the 3-axis mesh's BFV rotation differs")
    relin = bev3.relinearize(bev3.multiply(bev3.shard(b1), bev3.shard(b2)), rk3).unshard()
    check(torch.equal(relin.data, bfv_outs[n].data[:4]), "the 3-axis mesh's BFV request differs from phase 11's")
    print(f"[mesh bfv N={n}] (host 2, data 2, limb 2) mesh, replicated keys (every rank holds the whole key): "
          f"multiply, rotate_rows(1) and multiply -> relinearize of 4 requests equal to the unsharded batch and "
          f"phase 11's; {time.perf_counter() - t_c:.1f} s")
    del ctx, rk, rk3, gk, b1, b2, prod, rot, relin, bev3, one
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(8, devices=ranks)
    torch.cuda.synchronize()
    print(f"[dryrun] dryrun_multichip(8, devices=[{str(card)!r}] * 8), its BFV part included: OK in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (d) SEAL_TPU_DEBUG=1 on the card --------------------------------------
    ctx4, cts4, rk4, outs4 = ckks
    ev4 = Evaluator(ctx4)
    a, b = cts4[0]
    bctx = golden.bfv_context(golden.BFV_N, card)
    bkey = relin_keys_from_numpy([golden.key_inputs(bctx, golden.GOLDEN_KEY_SEED)], bctx.key_parms_id, card).key(2)
    x, y = (u64_from_numpy(d, card) for d in golden.request_inputs(bctx, golden.GOLDEN_REQUEST_SEED))
    bfv_fn = build_bfv_mult_relin(bctx)
    requests_debug = (("CKKS N=8192 (phase 4's request 0)", lambda: ev4.rescale_to_next(ev4.relinearize(
                          ev4.multiply(a, b), rk4)).data, (5, 1, 0), outs4[0].data),
                      ("BFV N=8192 (phase 11's request 0)", lambda: bfv_fn(x, y, bkey["c0"], bkey["c1"]), (4, 1, 0),
                       bfv_outs[golden.BFV_N].data[0]))
    before = os.environ.get("SEAL_TPU_DEBUG")
    for label, fn, launches_expected, want in requests_debug:
        runs = {}
        for mode in ("unset", "1"):
            if mode == "1":
                os.environ["SEAL_TPU_DEBUG"] = "1"
            else:
                os.environ.pop("SEAL_TPU_DEBUG", None)
            try:
                fn()                                       # warm-up
                got, launches = counted(fn)
                runs[mode] = (got, launches, timed(fn, 1, runs=5))
            finally:
                if before is None:
                    os.environ.pop("SEAL_TPU_DEBUG", None)
                else:
                    os.environ["SEAL_TPU_DEBUG"] = before
        for mode, (got, launches, _) in runs.items():
            check(launches == launches_expected, f"debug mode {mode}, {label}: launched (A, B, stage) {launches}; "
                                                 f"expected {launches_expected}")
            check(torch.equal(got, want), f"debug mode {mode}, {label}: the output differs")
        plain_ms, debug_ms = sorted(runs["unset"][2])[2], sorted(runs["1"][2])[2]
        print(f"[debug] {label}: with SEAL_TPU_DEBUG=1 every range check passes (NTT inputs and outputs around "
              f"kernel A, the contraction's u128 margin and target around kernel B) and the output equals the run "
              f"without it; launches of A, B, stage {runs['1'][1]} with the switch and {runs['unset'][1]} without "
              f"(phase 4's and 11's per request); median of 5 runs {debug_ms:.3f} ms checked, {plain_ms:.3f} ms "
              f"unchecked")
    del bctx, bkey, x, y, bfv_fn

    # ---- (e) the example twins on the card --------------------------------------
    for name in NAMES:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"seal_tpu_torch.examples.{name}").main(card)
        torch.cuda.synchronize()
        last = buf.getvalue().rstrip().splitlines()[-1]
        check(last.endswith("OK"), f"example {name} ended with {last!r}")
        print(f"[examples] seal_tpu_torch/examples/{name}.py on {torch.cuda.get_device_name(0)}: passed its asserts "
              f"in {time.perf_counter() - t0:.1f} s")

    # ---- (f) kernels C and D timed by CUDA events at N=32768 --------------------
    n = 32768
    moduli = tuple(m.value for m in CoeffModulus.bfv_default(n))
    k, D = len(moduli), len(moduli) - 1
    seeds = torch.randint(-(1 << 63), (1 << 63) - 1, (D, 8), dtype=torch.int64, device=card, generator=gen)
    nw_noise = (64 + 6 * n + 7) // 8
    nw_uniform = k * n + B.uniform_tail_words(n, moduli)[1]
    public = expand_stream_words_cuda(seeds, nw_noise)[:, :8].contiguous()
    words = expand_stream_words_cuda(public, nw_uniform)
    q, mm, rhi = B.uniform_constants(moduli, card)
    c_us = (profiling.device_time_us(lambda: expand_stream_words_cuda(seeds, nw_noise), lo=10, hi=60)
            + profiling.device_time_us(lambda: expand_stream_words_cuda(public, nw_uniform), lo=10, hi=60))
    bulk_us = profiling.device_time_us(lambda: uniform_bulk_cuda(words, n, q, mm, rhi), lo=10, hi=60)
    cross = {"blake2xb": c_us / 1e3, "sample_uniform": bulk_us / 1e3}
    for name, ms in cross.items():
        print(f"[timers] {name} at N=32768 (one relinearization key's calls, D={D}, k_key={k}): "
              f"profiling.device_time_us (CUDA events around bursts of 10 and 60 calls, the slope) "
              f"{ms * 1e3:.2f} us against phase 14(a)'s profiler device time {sampling[name][n]['ms'] * 1e3:.2f} us "
              f"and its back-to-back events {sampling[name][n]['events_ms'] * 1e3:.2f} us; {card_line}")
    return entries, cross


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SealContext, SecurityLevel
    from seal_tpu_torch import golden
    from seal_tpu_torch.convert import ciphertext_from_numpy, relin_keys_from_numpy, u64_to_numpy
    from seal_tpu_torch.evaluator import Evaluator
    from seal_tpu_torch.ntt_tables import build_limb_tables, four_step_tables_for
    from seal_tpu_torch.ops import cuda_build
    from seal_tpu_torch.ops.cuda_ntt import ntt_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda, switch_key_contract_plain
    from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse
    from seal_tpu_torch.ops.rns import slice_limbs
    from seal_tpu_torch import CKKSEncoder, Decryptor, Encryptor, KeyGenerator, PRNGType, UniformRandomGeneratorFactory
    from seal_tpu_torch.ops import four_step as FS
    from seal_tpu_torch.ops import ntt as NTT
    from seal_tpu_torch.ops.cuda_four_step import stage_cuda
    from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract
    from seal_tpu_torch.random.prng import blake2xb

    t_start = time.time()
    # ---- phase 1: setup --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card_line = smi[0].strip()
    print("[setup] card (nvidia-smi name, power.limit):")
    print(card_line)
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.time()
    cuda_build.build_all()
    print(f"[setup] kernels built from {os.path.relpath(cuda_build.CSRC, ROOT)} in {time.time() - t0:.1f} s")
    t0 = time.time()
    blake2xb(64, b"")                                   # builds csrc/blake2.c with cc
    print(f"[setup] host BLAKE2 library built in {time.time() - t0:.1f} s")
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"[setup] ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def context(n, bits, expand=True):
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        return SealContext(parms, expand, SecurityLevel.NONE)

    ctx = context(golden.GOLDEN_N, list(golden.GOLDEN_BITS))
    cd = ctx.first_context_data()
    key_cd = ctx.key_context_data()
    first_t = cd.limb_tables()
    key_t = key_cd.limb_tables()
    k = len(cd.parms.coeff_modulus)
    log_n = cd.log_n

    max_err = {"ntt": 0, "switch_key": 0, "four_step_stage": 0}

    # ---- phase 2: kernel A vs plain --------------------------------------
    # (label, tables, shape, inverse, on the port's main path per request)
    cases = [
        ("key switch: iNTT of the target", first_t, (k, 1 << log_n), True, True),
        ("key switch: iNTT mod the special prime", slice_limbs(key_t, k, k + 1), (2, 1, 1 << log_n), True, True),
        ("key switch: tail NTT", slice_limbs(key_t, 0, k), (2, k, 1 << log_n), False, True),
        ("rescale: iNTT mod q_last, both polys", slice_limbs(first_t, k - 1, k), (2, 1, 1 << log_n), True, True),
        ("rescale: NTT, both polys", slice_limbs(first_t, 0, k - 1), (2, k - 1, 1 << log_n), False, True),
        ("rescale: iNTT mod q_last, one poly", slice_limbs(first_t, k - 1, k), (1, 1 << log_n), True, False),
        ("rescale: NTT, one poly", slice_limbs(first_t, 0, k - 1), (k - 1, 1 << log_n), False, False),
    ]
    # phase 8a's batch of 8 requests: the same calls with a leading batch axis
    cases += [(f"batch of 8, {label}", t, (8, *shape), inverse, False)
              for label, t, shape, inverse, on_path in cases[:5]]
    mods16 = CoeffModulus.create(16384, list(golden.GOLDEN_BITS))
    t16 = build_limb_tables(14, mods16, device="cuda")
    cases.append(("N=16384 NTT", t16, (2, 5, 16384), False, False))
    cases.append(("N=16384 iNTT", t16, (2, 5, 16384), True, False))
    # N=32768, one launch a transform since kernel A spreads a row over a
    # cluster: the calls of one request of phase 7's chain at this size
    ctx32 = context(32768, list(golden.LARGE_BITS))
    t32_first, t32_key = ctx32.first_context_data().limb_tables(), ctx32.key_context_data().limb_tables()
    k32 = t32_first.q.shape[0]
    cases += [
        ("N=32768 key switch: iNTT of the target", t32_first, (k32, 32768), True, False),
        ("N=32768 key switch: NTT of the decomposition", t32_key, (k32, k32 + 1, 32768), False, False),
        ("N=32768 key switch: iNTT mod the special prime", slice_limbs(t32_key, k32, k32 + 1), (2, 1, 32768),
         True, False),
        ("N=32768 key switch: tail NTT", slice_limbs(t32_key, 0, k32), (2, k32, 32768), False, False),
        ("N=32768 rescale: iNTT mod q_last", slice_limbs(t32_first, k32 - 1, k32), (2, 1, 32768), True, False),
        ("N=32768 rescale: NTT", slice_limbs(t32_first, 0, k32 - 1), (2, k32 - 1, 32768), False, False),
    ]

    ntt_totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    n32_device_ms = 0.0
    for label, t, shape, inverse, on_path in cases:
        x = lazy_input(t, shape, 2 if inverse else 4, gen)
        plain_fn = (lambda: ntt_inverse(x, t)) if inverse else (lambda: ntt_forward(x, t))
        got = ntt_cuda(x, t, inverse)
        want = plain_fn()
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"kernel A disagrees with its plain version on {label} {shape}: max abs err {err}")
        max_err["ntt"] = max(max_err["ntt"], err)
        ms, events_ms = kernel_ms(lambda: ntt_cuda(x, t, inverse), 200)
        plain_ms = cuda_ms(plain_fn, 10, warmup=1)
        rows = x.numel() // shape[-1]
        nbytes, ops = ntt_work(rows, shape[-2], t.log_n)
        b, by = bound_ms(nbytes, ops)
        print(f"[kernel A] {label} {'inverse' if inverse else 'forward'} {tuple(shape)}: bit-exact; "
              f"kernel {ms * 1e3:.2f} us device time, {events_ms * 1e3:.2f} us back to back by events; "
              f"plain {plain_ms * 1e3:.1f} us by events; bound {b * 1e3:.3f} us ({by})")
        if t.log_n == 15:
            n32_device_ms += ms
        if on_path:
            ntt_totals["ms"] += ms
            ntt_totals["events_ms"] += events_ms
            ntt_totals["plain_ms"] += plain_ms
            ntt_totals["bytes"] += nbytes
            ntt_totals["ops"] += ops
    print(f"[kernel A] per N={1 << log_n} request (5 calls): device time {ntt_totals['ms'] * 1e3:.2f} us, "
          f"back to back by events {ntt_totals['events_ms'] * 1e3:.2f} us; per N=32768 request's 6 transforms "
          f"(one launch each): device time {n32_device_ms * 1e3:.2f} us")

    # ---- phase 3: kernel B vs plain --------------------------------------
    sk_main = {}

    def sk_case(label, context_, level_cd, key_rows, diag, main=False):
        ev = Evaluator(context_)
        plan = ev._plan(level_cd)
        D = plan.D
        n = level_cd.parms.poly_modulus_degree
        sel = plan.sel_tables
        Rn = sel.q.shape[0]
        level_t = level_cd.limb_tables()
        t_n = lazy_input(level_t, (D, n), 1, gen)
        t_c = ntt_inverse(t_n, level_t)
        t_n_arg = t_n if diag else None
        key = lazy_input(sel, (2, key_rows, Rn, n), 1, gen)
        got = switch_key_contract_cuda(t_c, t_n_arg, key, sel, plan.need_reduce)
        want = switch_key_contract_plain(t_c, t_n_arg, key, sel, plan.need_reduce)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"kernel B disagrees with its plain version on {label}: max abs err {err}")
        max_err["switch_key"] = max(max_err["switch_key"], err)
        ms, events_ms = kernel_ms(lambda: switch_key_contract_cuda(t_c, t_n_arg, key, sel, plan.need_reduce), 100)
        plain_ms = cuda_ms(lambda: switch_key_contract_plain(t_c, t_n_arg, key, sel, plan.need_reduce), 5, warmup=1)
        nbytes, ops = switch_key_work(D, key_rows, Rn, level_cd.log_n, diag)
        b, by = bound_ms(nbytes, ops)
        print(f"[kernel B] {label} (D={D}, key rows {key_rows}, Rn={Rn}, N={n}, diagonal {diag}): bit-exact; "
              f"kernel {ms * 1e3:.2f} us device time, {events_ms * 1e3:.2f} us back to back by events; "
              f"plain {plain_ms * 1e3:.1f} us by events; bound {b * 1e3:.3f} us ({by})")
        if main:
            sk_main.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)

    sk_case("main path", ctx, cd, k, True, main=True)
    sk_case("no diagonal", ctx, cd, k, False)
    sk_case("next level, key trimmed", ctx, cd.next_context_data, k, True)
    wide = context(1024, [40] * 67, expand=False)
    sk_case("wide chain, Barrett guard", wide, wide.first_context_data(), 66, True)

    # ---- phase 4: the slice ----------------------------------------------
    requests = 8
    kc0, kc1 = golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)
    rk = relin_keys_from_numpy([(kc0, kc1)], ctx.key_parms_id, "cuda")
    scale = 2.0 ** 40
    cts = []
    for r in range(requests):
        d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED + r)
        cts.append((ciphertext_from_numpy(d1, ctx.first_parms_id, True, scale, "cuda"),
                    ciphertext_from_numpy(d2, ctx.first_parms_id, True, scale, "cuda")))

    def serve(ev):
        outs = []
        for a, b in cts:
            outs.append(ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk)))
        return outs

    ev = Evaluator(ctx)
    with NTT.plain_on_card():
        serve(ev)                                       # warm-up: plans and tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = serve(ev)
        torch.cuda.synchronize()
    plain_req_ms = (time.perf_counter() - t0) * 1e3 / requests

    serve(ev)                                           # warm-up
    torch.cuda.synchronize()
    ntt_cuda.launches = 0
    switch_key_contract_cuda.launches = 0
    stage_cuda.launches = 0
    t0 = time.perf_counter()
    outs = serve(ev)
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t0) * 1e3 / requests
    launches = {"ntt": ntt_cuda.launches, "switch_key": switch_key_contract_cuda.launches}
    check(stage_cuda.launches == 0, f"the stage kernel ran {stage_cuda.launches} times at N=8192")

    # Kernel A per request: iNTT of the target, iNTT mod the special prime,
    # the tail NTT, and the rescale's iNTT and NTT over both polys at once.
    check(launches["ntt"] == 5 * requests, f"kernel A launched {launches['ntt']} times, expected {5 * requests}")
    check(launches["switch_key"] == requests,
          f"kernel B launched {launches['switch_key']} times, expected {requests}")
    for r, (got, want) in enumerate(zip(outs, ref)):
        check(got.parms_id == cd.next_context_data.parms_id and got.scale == scale * scale / cd.coeff_modulus_values[-1],
              f"request {r}: wrong level or scale")
        check(tuple(got.data.shape) == (2, k - 1, 1 << log_n), f"request {r}: shape {tuple(got.data.shape)}")
        check(torch.equal(got.data, want.data), f"request {r}: kernel path differs from the plain path on the card")
    q_rest = cd.next_context_data.limb_tables().q
    check(bool(((outs[0].data >= 0) & (outs[0].data < q_rest)).all()), "output residues out of range")
    dig = golden.digest(u64_to_numpy(outs[0].data))
    check(dig == golden.GOLDEN_DIGEST, f"golden digest mismatch: {dig}")
    print(f"[slice] {requests} requests of multiply -> relinearize -> rescale_to_next at N={1 << log_n}, "
          f"bits {list(golden.GOLDEN_BITS)}: equal to the plain path on the card; request 1 matches the "
          f"golden digest of the JAX package")
    print(f"[slice] launches: kernel A {launches['ntt']} ({launches['ntt'] // requests} per request), "
          f"kernel B {launches['switch_key']} ({launches['switch_key'] // requests} per request)")
    print(f"[slice] kernels: {req_ms:.3f} ms per request, {1e3 / req_ms:.1f} requests/s; "
          f"plain path on the card: {plain_req_ms:.3f} ms per request")
    repeats = []
    for _ in range(3):
        t0 = time.perf_counter()
        serve(ev)
        torch.cuda.synchronize()
        repeats.append((time.perf_counter() - t0) * 1e3 / requests)
    repeats.sort()
    print(f"[slice] 3 more runs of {requests} requests: ms per request min {repeats[0]:.3f}, "
          f"median {repeats[1]:.3f}, max {repeats[-1]:.3f} (median {1e3 / repeats[1]:.1f} requests/s)")

    # Where the time goes: device time by kernel over the same requests.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(ev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device_events:
        print("[profile] the profiler recorded no device time: not measured")
    else:
        by_name = {}
        for e in device_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy_us = sum(by_name.values())
        ntt_us = sum(v for name, v in by_name.items() if "ntt_forward_kernel" in name or "ntt_inverse_kernel" in name)
        sk_us = sum(v for name, v in by_name.items() if "switch_key_kernel" in name)
        print(f"[profile] {requests} requests under the profiler: wall {wall_us / 1e3:.3f} ms, "
              f"{len(device_events)} kernel launches, device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / wall_us:.1f}% of wall); kernel A {ntt_us / 1e3:.3f} ms, "
              f"kernel B {sk_us / 1e3:.3f} ms, other kernels (plain PyTorch elementwise arithmetic, copies) "
              f"{(busy_us - ntt_us - sk_us) / 1e3:.3f} ms")
        for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            print(f"[profile]   {v / 1e3:9.3f} ms  {name[:100]}")


    # ---- phase 5: the stage kernel vs plain ------------------------------
    large = context(golden.LARGE_N, list(golden.LARGE_BITS))
    lcd, lkey = large.first_context_data(), large.key_context_data()
    lk = len(lcd.parms.coeff_modulus)
    lt_first, lt_key = lcd.limb_tables(), lkey.limb_tables()
    lt_next = lcd.next_context_data.limb_tables()
    n_large = golden.LARGE_N
    # (label, tables, shape, inverse, on the N=65536 request path)
    transforms = [
        ("key switch: iNTT of the target", lt_first, (lk, n_large), True, True),
        ("key switch: NTT of the decomposition", lt_key, (lk, lk + 1, n_large), False, True),
        ("key switch: iNTT mod the special prime", slice_limbs(lt_key, lk, lk + 1), (2, 1, n_large), True, True),
        ("key switch: tail NTT", slice_limbs(lt_key, 0, lk), (2, lk, n_large), False, True),
        ("rescale: iNTT mod q_last", slice_limbs(lt_first, lk - 1, lk), (2, 1, n_large), True, True),
        ("rescale: NTT", lt_next, (2, lk - 1, n_large), False, True),
        ("keygen: NTT at the key level", lt_key, (lk + 1, n_large), False, False),
    ]
    for log_n, bits in ((15, [60, 40, 40, 60]), (17, [60, 40, 40, 60])):
        mods = CoeffModulus.create(1 << log_n, bits)
        tt = build_limb_tables(log_n, mods, device="cuda")
        transforms.append((f"N={1 << log_n} NTT", tt, (2, len(mods), 1 << log_n), False, False))
        transforms.append((f"N={1 << log_n} iNTT", tt, (2, len(mods), 1 << log_n), True, False))

    stage_totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "madds": 0, "b_bytes": 0}
    for label, t, shape, inverse, on_path in transforms:
        ft = four_step_tables_for(t)
        x = lazy_input(t, shape, 2 if inverse else 4, gen)
        specs = FS.inverse_specs(ft) if inverse else FS.forward_specs(ft)
        names = ("finv", "winv") if inverse else ("w", "f")
        tws = ((ft.twi_op, ft.twi_qt) if inverse else (ft.tw_op, ft.tw_qt), None)
        rows = x.numel() // shape[-1]
        h = x
        for which, (spec, name, tw) in enumerate(zip(specs, names, tws)):
            got = stage_cuda(h, name, ft, spec, tw)
            want = FS.stage_plain(h, name, ft, spec, tw)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(err == 0, f"the stage kernel disagrees with its plain version on {label}, stage {which}: "
                            f"max abs err {err}")
            max_err["four_step_stage"] = max(max_err["four_step_stage"], err)
            ms, events_ms = kernel_ms(lambda: stage_cuda(h, name, ft, spec, tw), 50)
            plain_ms = cuda_ms(lambda: FS.stage_plain(h, name, ft, spec, tw), 2, warmup=1)
            nbytes, ops = stage_work(rows, t.q.shape[0], spec, tw is not None)
            bnd, by = bound_ms(nbytes, ops)
            madds = rows * spec.M * spec.K * spec.ncols
            b_bytes = 8 * t.q.shape[0] * spec.M * spec.K
            print(f"[stage] {label} {tuple(shape)} stage {which} ({spec.M}x{spec.K}, {spec.ncols} columns, "
                  f"twiddle {tw is not None}): bit-exact; kernel {ms * 1e3:.2f} us device time, {events_ms * 1e3:.2f} "
                  f"us back to back by events; plain {plain_ms * 1e3:.1f} us by events; "
                  f"bound {bnd * 1e3:.3f} us ({by}; for information, the dense product does "
                  f"{madds / 1e6:.1f} M multiply-adds and reads {b_bytes / 1e6:.2f} MB of matrix)")
            if on_path:
                stage_totals["ms"] += ms
                stage_totals["events_ms"] += events_ms
                stage_totals["plain_ms"] += plain_ms
                stage_totals["bytes"] += nbytes
                stage_totals["ops"] += ops
                stage_totals["madds"] += madds
                stage_totals["b_bytes"] += b_bytes
            h = got
        four_step = FS.four_step_inverse if inverse else FS.four_step_forward
        transform = lambda x, t: four_step(x, ft, stage=stage_cuda)          # N=32768 too: the stage kernel's split
        butterflies = ntt_inverse if inverse else ntt_forward
        full = transform(x, t)
        torch.cuda.synchronize()
        check(torch.equal(full, butterflies(x, t)), f"the four-step transform differs from the butterflies on {label}")
        fms = cuda_ms(lambda: transform(x, t), 10)
        bms = cuda_ms(lambda: butterflies(x, t), 3, warmup=1)
        print(f"[stage] {label}: the whole four-step transform (2 launches) equals the butterflies; {fms * 1e3:.1f} us, "
              f"butterflies in plain PyTorch {bms * 1e3:.1f} us")

    # ---- phase 6: the staged key switch at N=65536 -----------------------
    lplan = Evaluator(large)._plan(lcd)
    lsel = lplan.sel_tables
    t_n = lazy_input(lt_first, (lplan.D, n_large), 1, gen)
    t_c = ntt_inverse(t_n, lt_first)
    key = lazy_input(lsel, (2, lplan.D, lsel.q.shape[0], n_large), 1, gen)
    got = switch_key_contract(t_c, t_n, key, lsel, lplan.need_reduce)
    want = switch_key_contract_plain(t_c, t_n, key, lsel, lplan.need_reduce)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "the staged key switch differs from the plain version at N=65536")
    sk_ms = cuda_ms(lambda: switch_key_contract(t_c, t_n, key, lsel, lplan.need_reduce), 10)
    sk_plain_ms = cuda_ms(lambda: switch_key_contract_plain(t_c, t_n, key, lsel, lplan.need_reduce), 3, warmup=1)
    print(f"[staged key switch] D={lplan.D}, Rn={lsel.q.shape[0]}, N={n_large}: equal to the plain version on the "
          f"card; {sk_ms * 1e3:.1f} us (the NTT on the stage kernel, the rest plain PyTorch), "
          f"plain {sk_plain_ms * 1e3:.1f} us")

    # ---- phase 7: the CKKS round trip at N=65536 -------------------------
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n_large)
    parms.set_coeff_modulus(CoeffModulus.create(n_large, list(golden.LARGE_BITS)))
    parms.set_random_generator(UniformRandomGeneratorFactory(PRNGType.BLAKE2XB, (1, 2, 3, 4, 5, 6, 7, 8)))
    rctx = SealContext(parms, True, SecurityLevel.NONE)           # the default device: the card
    slots = n_large // 2
    rng = np.random.default_rng(2024)
    vals_a = rng.uniform(-1.0, 1.0, slots)
    vals_b = rng.uniform(-1.0, 1.0, slots)
    round_requests = 4

    def round_trip():
        """Every step of the computation; returns its outputs and, per
        step, (seconds, stage-kernel launches)."""
        steps = {}

        def step(name, fn):
            torch.cuda.synchronize()
            before, t0 = stage_cuda.launches, time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            steps[name] = (time.perf_counter() - t0, stage_cuda.launches - before)
            return out

        def keys():
            kg = KeyGenerator(rctx)
            return kg.secret_key, kg.create_relin_keys(), kg.create_public_key()

        sk, rk, pk = step("keygen", keys)
        enc = CKKSEncoder(rctx)
        pa, pb = step("encode", lambda: (enc.encode(vals_a, scale), enc.encode(vals_b, scale)))
        sym = Encryptor(rctx, secret_key=sk)
        ca, cb, ca_pk = step("encrypt", lambda: (sym.encrypt_symmetric(pa), sym.encrypt_symmetric(pb),
                                                 Encryptor(rctx, public_key=pk).encrypt(pa)))
        ev = Evaluator(rctx)
        pairs = [((ca, cb), (ca_pk, cb))[r % 2] for r in range(round_requests)]
        prods = step("requests", lambda: [ev.rescale_to_next(ev.relinearize(ev.multiply(x, y), rk))
                                          for x, y in pairs])
        dec = Decryptor(rctx, sk)
        plains = step("decrypt", lambda: [dec.decrypt(c) for c in prods])
        values = step("decode", lambda: [enc.decode(p) for p in plains])
        tensors = {"secret key": sk.data, "relin key c0": rk.key(2)["c0"], "relin key c1": rk.key(2)["c1"],
                   "public key": pk.data.data, "plaintext a": pa.rns_data, "plaintext b": pb.rns_data,
                   "ciphertext a": ca.data, "ciphertext b": cb.data, "ciphertext a (public key)": ca_pk.data}
        tensors.update({f"product {r}": c.data for r, c in enumerate(prods)})
        tensors.update({f"decrypted {r}": p.rns_data for r, p in enumerate(plains)})
        return tensors, values, steps, (ev, rk, pairs)

    with NTT.plain_on_card():
        ref_tensors, ref_values, plain_steps, _ = round_trip()
    round_trip()                                          # warm-up: tables and plans
    ntt_cuda.launches = 0
    switch_key_contract_cuda.launches = 0
    stage_cuda.launches = 0
    tensors, values, steps, (rev, rrk, rpairs) = sampled("7", round_trip)
    large_launches = {"four_step_stage": stage_cuda.launches, "ntt": ntt_cuda.launches,
                      "switch_key": switch_key_contract_cuda.launches}
    for name, tensor in tensors.items():
        check(torch.equal(tensor, ref_tensors[name]), f"round trip: {name} differs from the plain path on the card")
    for r, (got_v, want_v) in enumerate(zip(values, ref_values)):
        check(np.array_equal(got_v, want_v), f"round trip: decoded request {r} differs from the plain path")
        err = float(np.max(np.abs(got_v.real - vals_a * vals_b)))
        check(np.isfinite(got_v).all() and got_v.shape == (slots,) and err < 1e-3,
              f"round trip: decoded request {r} is {err} from the exact product")
    check(large_launches["ntt"] == 0 and large_launches["switch_key"] == 0,
          f"kernels A and B ran at N=65536: {large_launches}")
    # per request: the key switch's four transforms and the rescale's two, two launches each
    per_request = steps["requests"][1] / round_requests
    check(per_request == 12, f"the stage kernel ran {per_request} times per request, expected 12")
    drk = relin_keys_from_numpy([golden.key_inputs(rctx, golden.GOLDEN_KEY_SEED)], rctx.key_parms_id, "cuda")
    d1, d2 = golden.request_inputs(rctx, golden.GOLDEN_REQUEST_SEED)
    da = ciphertext_from_numpy(d1, rctx.first_parms_id, True, scale, "cuda")
    db = ciphertext_from_numpy(d2, rctx.first_parms_id, True, scale, "cuda")
    dig = golden.digest(u64_to_numpy(rev.rescale_to_next(rev.relinearize(rev.multiply(da, db), drk)).data))
    check(dig == golden.LARGE_DIGEST, f"N=65536 golden digest mismatch: {dig}")
    print(f"[round trip] N={n_large}, bits {list(golden.LARGE_BITS)}: keys, ciphertexts, plaintexts and decoded "
          f"values equal to the plain path on the card; {round_requests} decoded products within 1e-3 of the "
          f"exact ones; the splitmix request matches the JAX package's N={n_large} digest")
    print(f"[round trip] launches in the counted run: stage kernel {large_launches['four_step_stage']} "
          f"({per_request:.0f} per request), kernel A {large_launches['ntt']}, kernel B {large_launches['switch_key']}")
    for name, (sec, n_launch) in steps.items():
        extra = f", {sec * 1e3 / round_requests:.3f} ms per request" if name == "requests" else ""
        print(f"[round trip] {name}: {sec * 1e3:.3f} ms{extra}, {n_launch} stage launches; plain path on the card "
              f"{plain_steps[name][0] * 1e3:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in rpairs:
            rev.rescale_to_next(rev.relinearize(rev.multiply(x, y), rrk))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, groups = device_split(prof, {"stage": "four_step_stage_kernel"})
    if not by_name:
        print("[round trip profile] the profiler recorded no device time: not measured")
    else:
        busy_us = sum(by_name.values())
        print(f"[round trip profile] {round_requests} requests under the profiler: wall {wall_us / 1e3:.3f} ms, "
              f"{sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)} kernel launches, "
              f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% of wall); stage kernel "
              f"{groups['stage'] / 1e3:.3f} ms, other kernels (plain PyTorch elementwise arithmetic, copies) "
              f"{(busy_us - groups['stage']) / 1e3:.3f} ms, host and idle {(wall_us - busy_us) / 1e3:.3f} ms")
        for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            print(f"[round trip profile]   {v / 1e3:9.3f} ms  {name[:100]}")
    b_stage, by_stage = bound_ms(stage_totals["bytes"], stage_totals["ops"])
    print(f"[round trip] the stage kernel per request: {stage_totals['ms'] * 1e3:.1f} us device time over 12 calls, "
          f"{stage_totals['events_ms'] * 1e3:.1f} us back to back by events, bound "
          f"{b_stage * 1e3:.3f} us ({by_stage}), plain {stage_totals['plain_ms'] * 1e3:.1f} us by events; for "
          f"information, the dense product's {stage_totals['madds'] / 1e9:.3f} G multiply-adds and "
          f"{stage_totals['b_bytes'] / 1e6:.2f} MB of matrix reads")

    # ---- phase 8: the multi-device layer ---------------------------------
    turn_entry, sk_batched_ms = multi_device_phase(
        torch.device("cuda", torch.cuda.current_device()), ctx, cts, rk, outs, lt_key, gen)

    # ---- phase 9: the N=32768 request on the default chain ---------------
    sk_medium = medium_phase(gen)

    # ---- phase 10: the N=32768 encrypted linear-layer step ----------------
    t_linear = time.time()
    linear = linear_phase()
    print(f"[linear] phase 10 in {time.time() - t_linear:.1f} s")

    # ---- phase 11: BFV at N=8192 and N=32768 -------------------------------
    t_bfv = time.time()
    bfv, bfv_outs = bfv_phase(gen)
    print(f"[bfv] phase 11 in {time.time() - t_bfv:.1f} s")

    # ---- phase 12: BGV at N=8192 and N=32768 -------------------------------
    t_bgv = time.time()
    bgv, bgv_outs = bgv_phase(gen)
    print(f"[bgv] phase 12 in {time.time() - t_bgv:.1f} s")

    # ---- phase 13: the wire path -------------------------------------------
    t_wire = time.time()
    wire = sampled("13", lambda: wire_phase(card_line))
    print(f"[wire] phase 13 in {time.time() - t_wire:.1f} s")

    # ---- phase 14: device sampling -----------------------------------------
    sampling, client_ms, sampling_err = sampling_phase(gen)

    # ---- phase 15: BFV and BGV on a mesh, and the tooling -------------------
    t_mesh = time.time()
    mesh, event_slopes = tooling_mesh_phase(torch.device("cuda", torch.cuda.current_device()), gen, card_line,
                                            (ctx, cts, rk, outs), bfv_outs, bgv_outs, sampling)
    print(f"[mesh] phase 15 in {time.time() - t_mesh:.1f} s")

    b_ntt, by_ntt = bound_ms(ntt_totals["bytes"], ntt_totals["ops"])
    kernels = {"kernels": [
        {"name": "ntt", "route": "cuda", "source": "seal_tpu_torch/csrc/ntt.cu",
         "replaces": "seal_tpu/ops/pallas_mxu_ntt.py:227", "launches": launches["ntt"],
         "max_abs_err": max_err["ntt"], "ms": ntt_totals["ms"], "plain_ms": ntt_totals["plain_ms"],
         "bound_ms": b_ntt, "bound_by": by_ntt, "library_ms": None, "bfv": bfv["ntt"], "bgv": bgv["ntt"], "wire": wire["ntt"],
         "mesh": mesh["ntt"]},
        {"name": "switch_key", "route": "cuda", "source": "seal_tpu_torch/csrc/switch_key.cu",
         "replaces": "seal_tpu/ops/pallas_switch_key.py:62", "launches": launches["switch_key"],
         "max_abs_err": max(max_err["switch_key"], sk_medium["max_abs_err"]), "ms": sk_main["ms"],
         "plain_ms": sk_main["plain_ms"], "bound_ms": sk_main["bound_ms"], "bound_by": sk_main["bound_by"],
         "library_ms": None, "n32768": sk_medium, "linear_layer": linear, "bfv": bfv["switch_key"],
         "bgv": bgv["switch_key"], "wire": wire["switch_key"], "mesh": mesh["switch_key"]},
        {"name": "four_step_stage", "route": "cuda", "source": "seal_tpu_torch/csrc/four_step.cu",
         "replaces": "seal_tpu/ops/pallas_mxu_ntt.py:84", "launches": large_launches["four_step_stage"],
         "max_abs_err": max_err["four_step_stage"], "ms": stage_totals["ms"],
         "plain_ms": stage_totals["plain_ms"], "bound_ms": b_stage, "bound_by": by_stage, "library_ms": None},
        turn_entry,
    ]}
    for name, source, replaces in (
            ("blake2xb", "seal_tpu_torch/csrc/blake2xb.cu", "seal_tpu/ops/blake2_dev.py:184"),
            ("sample_uniform", "seal_tpu_torch/csrc/sample.cu", "seal_tpu/ops/blake2_dev.py:281"),
            ("sample_cbd", "seal_tpu_torch/csrc/sample.cu", "seal_tpu/ops/blake2_dev.py:393")):
        main_key = sampling[name][8192]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": SAMPLING["14b"][name], "max_abs_err": sampling_err[name], "ms": main_key["ms"],
                 "plain_ms": main_key["plain_ms"], "bound_ms": main_key["bound_ms"], "bound_by": main_key["bound_by"],
                 "library_ms": None, "n32768": sampling[name][32768],
                 "phases": {phase: counts[name] for phase, counts in SAMPLING.items()}}
        if name in event_slopes:
            entry["n32768"] = dict(entry["n32768"], event_slope_ms=event_slopes[name])
        if name == "blake2xb":
            entry["client_ms"] = client_ms
        kernels["kernels"].append(entry)
    print(f"[done] all phases passed in {time.time() - t_start:.1f} s; kernel A's ms, plain_ms and bound_ms "
          f"sum the five calls of one N=8192 request, the stage kernel's the twelve of one N=65536 request; its "
          f"launches count the whole N=65536 round trip, keygen to decode; each kernel's ms is the profiler's device time, each plain_ms CUDA events around calls of the plain version (the corner turn's: device time)")
    print("[done] library_ms is null for the first three kernels: no PyTorch call computes a negacyclic NTT mod q, "
          "the key-switch contraction or a modular matrix product (the CUDA int64 matmul is missing and does no "
          "modular reduction); the corner turn's numbers sum its forward and inverse turn of one N=65536 round "
          "trip, its launches count the counted remote round trip, its library_ms is one permute+copy_ of the "
          "stacked ranks per turn")
    print(f"[done] kernel B batched over phase 4's {len(cts)} requests: {sk_batched_ms * 1e3:.2f} us per request "
          f"by events; kernel B's n32768 entry: phase 9's call of one N=32768 request (profiler device time), its "
          f"plain version, its bound, its launches in the counted sequential run, and staged_ms, the device time "
          f"of the staged key switch it replaces (every kernel summed); the bfv objects of kernels A and B: phase "
          f"11's calls of one BFV request at N=8192 and N=32768 (A: its four transforms summed; B: one call, no "
          f"diagonal), their launches per request and per batch; the bgv objects: phase 12's calls of one BGV "
          f"request at both sizes (A: its eight transforms summed; B: its two calls with the diagonal), their "
          f"launches per request and per batch, and the profiler's device time of each kernel per request in the "
          f"sequential and the batched run; the wire objects: phase 13's launches per served request and per batch, "
          f"on SEAL's blobs, and its ms per request over the wire and in memory")
    print("[done] kernels C (blake2xb) and D (sample_uniform, sample_cbd, one source with two entry points) replace "
          "no Pallas kernel but the jnp code of seal_tpu/ops/blake2_dev.py at the lines given; their ms, plain_ms and "
          "bound_ms sum the calls of one N=8192 relinearization key (kernel C: the bootstrap and the uniform streams), "
          "n32768 those of one N=32768 key on bfv_default(32768), each call's ms the profiler's mean device operation "
          "times the operations a call records (device_ops_per_call: kernel C's root and node passes; the bulk pass's "
          "zero fill of its counts and its kernel; the CBD pass); launches count wrapper calls in phase 14(b)'s counted "
          "keygen (four keys at each of the two sizes), so a launch of kernel C is two kernels; phases the launches "
          "in each phase's counted keygen or client run; max_abs_err is phase 14(a)'s largest difference from the "
          "plain version, read as u64; library_ms is null: no PyTorch call computes "
          "BLAKE2b or the samplers; client_ms holds phase 14(b)'s keygen and encryption ms on the device path and "
          "on the host path (SEAL_TPU_DEVICE_SAMPLING=0) at N=8192, 32768 and 65536")
    print("[done] the mesh objects of kernels A and B: phase 15's launches per batch of the BFV request (multiply -> "
          "relinearize) and the BGV request on the (data 4, limb 2) mesh of 8 ranks of the card at N=8192 (8 "
          "requests) and N=32768 (4), with the ms and device-busy ms per request; event_slope_ms in the n32768 "
          "objects of blake2xb and sample_uniform: phase 15(f)'s profiling.device_time_us of the same calls")
    print(card_line)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

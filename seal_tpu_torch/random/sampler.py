"""RLWE secret and noise samplers (host, numpy) over the PRNG byte streams.

Port of ``seal_tpu/random/sampler.py`` (counterpart of
``util/rlwe.cpp:21-135``), with the same byte consumption:

* ``sample_poly_uniform``: a bulk fill of k*n u64 words, then per-limb
  rejection redraws in row-major order (seeded-ciphertext expansion depends
  on it);
* ``sample_poly_cbd`` (the default noise): 6 bytes per coefficient, the top
  bits of bytes 2 and 5 masked to 5 bits, difference of Hamming weights;
* ``sample_poly_ternary``: one 32-bit word per coefficient, 0xFFFFFFFF
  rejected, mapped by division as libstdc++'s
  ``uniform_int_distribution(0, 2)`` does;
* ``sample_poly_normal``: the optional clipped Gaussian (sigma 3.2),
  Box-Muller over stream doubles.

* ``sample_poly_uniform_seal_3_4`` / ``_3_5``: the uniform samplers of
  Microsoft SEAL 3.4 and 3.5 (rlwe.cpp:134-188), which expand the seeded
  ciphertexts of blobs of those versions (``serialization.ciphertext_load``):
  two 32-bit words per attempt, a rejected attempt redrawn at once.

The noise and secret samplers return uint64 arrays of shape (k, n): the
sampled small value in every RNS limb, negatives as q_i - |v|; the uniform
ones a residue per limb.
"""

from __future__ import annotations

import math
import struct
from typing import Sequence

import numpy as np

NOISE_STANDARD_DEVIATION = 3.2
NOISE_MAX_DEVIATION = NOISE_STANDARD_DEVIATION * 6


def _replicate_signed(values: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
    """Signed small ints (n,) -> (k, n) uint64 with negatives lifted mod q_i."""
    v = values.astype(np.int64)
    out = np.zeros((len(moduli), len(values)), dtype=np.uint64)
    for i, q in enumerate(moduli):
        out[i] = np.where(v < 0, np.uint64(q) + v.astype(np.uint64), v.astype(np.uint64))
    return out


def sample_poly_ternary(prng, n: int, moduli: Sequence[int]) -> np.ndarray:
    """Uniform ternary {-1, 0, 1} secret polynomial (rlwe.cpp:21-38)."""
    scaling = ((1 << 32) - 1) // 3  # 1431655765
    past = 3 * scaling              # only 0xFFFFFFFF is rejected
    buf = np.frombuffer(prng.generate(4 * n), dtype="<u4").astype(np.int64)
    bad = buf >= past
    while bad.any():
        redraw = np.frombuffer(prng.generate(4 * int(bad.sum())), dtype="<u4").astype(np.int64)
        buf[np.where(bad)[0]] = redraw
        bad = buf >= past
    return _replicate_signed((buf // scaling) - 1, moduli)


def sample_poly_cbd(prng, n: int, moduli: Sequence[int]) -> np.ndarray:
    """Centered binomial noise, sigma=3.2 (rlwe.cpp:66-103)."""
    raw = np.frombuffer(prng.generate(6 * n), dtype=np.uint8).reshape(n, 6).copy()
    raw[:, 2] &= 0x1F
    raw[:, 5] &= 0x1F
    weights = np.unpackbits(raw, axis=1).sum(axis=1, dtype=np.int64)
    pos = np.unpackbits(raw[:, :3], axis=1).sum(axis=1, dtype=np.int64)
    return _replicate_signed(2 * pos - weights, moduli)


def sample_poly_normal(prng, n: int, moduli: Sequence[int]) -> np.ndarray:
    """Clipped Gaussian noise (cf. clipnormal.h)."""
    out = np.zeros(n, dtype=np.int64)
    i = 0
    while i < n:
        u1, u2 = struct.unpack("<2Q", prng.generate(16))
        a = (u1 >> 11) / (1 << 53)
        b = (u2 >> 11) / (1 << 53)
        if a <= 0.0:
            continue
        r = math.sqrt(-2.0 * math.log(a)) * NOISE_STANDARD_DEVIATION
        for val in (r * math.cos(2 * math.pi * b), r * math.sin(2 * math.pi * b)):
            if i < n and abs(val) <= NOISE_MAX_DEVIATION:
                out[i] = int(round(val))
                i += 1
    return _replicate_signed(out, moduli)


def sample_poly_uniform(prng, n: int, moduli: Sequence[int]) -> np.ndarray:
    """Uniform polynomial mod each q_i (rlwe.cpp:104-135)."""
    k = len(moduli)
    dest = np.frombuffer(prng.generate(8 * k * n), dtype="<u8").reshape(k, n).copy()
    max_random = 0xFFFFFFFFFFFFFFFF
    for j, q in enumerate(moduli):
        max_multiple = max_random - (max_random % q) - 1
        row = dest[j]
        # redraw only the offending positions, in the reference's order
        for c in np.nonzero(row >= np.uint64(max_multiple))[0]:
            r = int(row[c])
            while r >= max_multiple:
                (r,) = struct.unpack("<Q", prng.generate(8))
            row[c] = r
        np.mod(row, np.uint64(q), out=row)
    return dest


def _sample_poly_uniform_legacy(prng, n: int, moduli: Sequence[int], shift_a: int, shift_b: int,
                                max_random: int) -> np.ndarray:
    """The SEAL 3.4 / 3.5 uniform samplers' common engine (rlwe.cpp:134-188).

    An attempt is two 32-bit stream words a, b combined as
    ``(a << shift_a) | (b >> shift_b)``; a rejected attempt is redrawn for
    the same coefficient before the scan moves on, so the accepted attempts,
    in stream order, are the coefficients in order.  Attempts are drawn in
    batches and the accepted ones kept until a limb has n: each attempt is 8
    stream bytes, in the reference's order.
    """
    dest = np.zeros((len(moduli), n), dtype=np.uint64)
    for j, q in enumerate(moduli):
        max_multiple = max_random - (max_random % q) - 1
        accepted = np.zeros(0, dtype=np.uint64)
        while len(accepted) < n:
            words = np.frombuffer(prng.generate(8 * (n - len(accepted))), dtype="<u4").astype(np.uint64)
            rand = (words[0::2] << np.uint64(shift_a)) | (words[1::2] >> np.uint64(shift_b))
            accepted = np.concatenate([accepted, rand[rand < np.uint64(max_multiple)]])
        dest[j] = accepted % np.uint64(q)
    return dest


def sample_poly_uniform_seal_3_4(prng, n: int, moduli: Sequence[int]) -> np.ndarray:
    """SEAL 3.4: (engine() << 31) | (engine() >> 1), a 63-bit range (rlwe.cpp:137-163)."""
    return _sample_poly_uniform_legacy(prng, n, moduli, 31, 1, (1 << 63) - 1)


def sample_poly_uniform_seal_3_5(prng, n: int, moduli: Sequence[int]) -> np.ndarray:
    """SEAL 3.5: (engine() << 32) | engine(), the full 64-bit range (rlwe.cpp:165-188)."""
    return _sample_poly_uniform_legacy(prng, n, moduli, 32, 0, (1 << 64) - 1)


# The default noise sampler (the reference's SEAL_NOISE_SAMPLER: CBD).
sample_poly_noise = sample_poly_cbd


def noise_sampler_for(parms):
    """The parameter set's noise sampler (``set_noise_sampler``)."""
    return sample_poly_normal if parms.noise_sampler == "gaussian" else sample_poly_cbd

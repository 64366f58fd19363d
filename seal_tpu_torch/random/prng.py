"""Deterministic PRNGs with byte-stream parity to the reference.

Port of ``seal_tpu/random/prng.py`` (counterpart of
``native/src/seal/randomgen.{h,cpp}``): a 512-bit seed drives a
counter-mode XOF refilled in 4 KiB buffers.  SHAKE-256 comes from
``hashlib``; BLAKE2xb from the port's copy of the C source
(``csrc/blake2.c``), compiled with ``cc`` at first use into the package's
gitignored ``build/`` directory and loaded with ``ctypes`` (``host_c.py``).

blake2xb construction (cf. ``util/blake2xb.c:36-140``):
  root  = blake2b(input, key=seed, fanout=1, depth=1, xof_length=outlen)
  block_i = blake2b(root, digest=min(64, rem), fanout=0, depth=0,
                    leaf_size=64, node_offset=i, inner_size=64,
                    xof_length=outlen)
"""

from __future__ import annotations

import ctypes
import enum
import functools
import hashlib
import os
import struct
from typing import Optional, Tuple

from .. import host_c

PRNG_SEED_UINT64_COUNT = 8
PRNG_SEED_BYTE_COUNT = PRNG_SEED_UINT64_COUNT * 8
_BUFFER_SIZE = 4096


@functools.cache
def _native() -> ctypes.CDLL:
    """The BLAKE2 library, compiled from ``csrc/blake2.c`` at first use."""
    lib = host_c.load("blake2")
    lib.seal_blake2xb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t]
    lib.seal_blake2xb_fill.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_char_p]
    return lib


class PRNGType(enum.IntEnum):
    """cf. ``prng_type`` (randomgen.h:26-31)."""

    UNKNOWN = 0
    BLAKE2XB = 1
    SHAKE256 = 2


def random_seed() -> Tuple[int, ...]:
    """Fresh 512-bit seed from OS entropy (cf. ``random_bytes``)."""
    return tuple(struct.unpack("<8Q", os.urandom(PRNG_SEED_BYTE_COUNT)))


def blake2xb(outlen: int, data: bytes, key: bytes = b"") -> bytes:
    """The blake2xb XOF."""
    if not (0 < outlen <= 0xFFFFFFFF):
        raise ValueError("invalid outlen")
    out = ctypes.create_string_buffer(outlen)
    _native().seal_blake2xb(out, outlen, data, len(data), key, len(key))
    return out.raw


class _BufferedPRNG:
    """4 KiB-buffered deterministic byte stream (``UniformRandomGenerator``)."""

    prng_type = PRNGType.UNKNOWN

    def __init__(self, seed: Tuple[int, ...]):
        if len(seed) != PRNG_SEED_UINT64_COUNT:
            raise ValueError("seed must be 8 uint64 words")
        self.seed = tuple(int(s) & 0xFFFFFFFFFFFFFFFF for s in seed)
        self._seed_bytes = struct.pack("<8Q", *self.seed)
        self._pos = 0  # absolute position in the concatenated block stream

    def _fill_blocks(self, first_block: int, nbytes: int) -> bytes:
        """Bytes of blocks [first_block, ...) covering nbytes."""
        raise NotImplementedError

    def generate(self, byte_count: int) -> bytes:
        """Next byte_count bytes of the stream: the concatenation of
        successive 4 KiB refills, served from the absolute position."""
        first_block = self._pos // _BUFFER_SIZE
        offset = self._pos % _BUFFER_SIZE
        span = offset + byte_count
        nblocks_bytes = (span + _BUFFER_SIZE - 1) // _BUFFER_SIZE * _BUFFER_SIZE
        raw = self._fill_blocks(first_block, nblocks_bytes)
        self._pos += byte_count
        return raw[offset : offset + byte_count]

    def info(self) -> "UniformRandomGeneratorInfo":
        return UniformRandomGeneratorInfo(self.prng_type, self.seed)


class Blake2xbPRNG(_BufferedPRNG):
    """Default PRNG: counter-mode blake2xb keyed by the seed
    (cf. ``Blake2xbPRNG::refill_buffer``, randomgen.cpp:204-214)."""

    prng_type = PRNGType.BLAKE2XB

    def _fill_blocks(self, first_block: int, nbytes: int) -> bytes:
        out = ctypes.create_string_buffer(nbytes)
        _native().seal_blake2xb_fill(out, nbytes, first_block, self._seed_bytes)
        return out.raw


class Shake256PRNG(_BufferedPRNG):
    """SHAKE-256 PRNG (cf. ``Shake256PRNG::refill_buffer``, randomgen.cpp:216-227)."""

    prng_type = PRNGType.SHAKE256

    def _fill_blocks(self, first_block: int, nbytes: int) -> bytes:
        out = bytearray()
        counter = first_block
        while len(out) < nbytes:
            out += hashlib.shake_256(self._seed_bytes + struct.pack("<Q", counter)).digest(_BUFFER_SIZE)
            counter += 1
        return bytes(out)


class UniformRandomGeneratorFactory:
    """Factory with optional fixed ("default") seed (``randomgen.h:396-470``)."""

    def __init__(self, prng_type: PRNGType = PRNGType.BLAKE2XB, default_seed: Optional[Tuple[int, ...]] = None):
        self.prng_type = prng_type
        self.default_seed = tuple(default_seed) if default_seed is not None else None

    @property
    def use_random_seed(self) -> bool:
        return self.default_seed is None

    def create(self, seed: Optional[Tuple[int, ...]] = None) -> _BufferedPRNG:
        if seed is None:
            seed = self.default_seed if self.default_seed is not None else random_seed()
        cls = {PRNGType.BLAKE2XB: Blake2xbPRNG, PRNGType.SHAKE256: Shake256PRNG}[self.prng_type]
        return cls(seed)

    @staticmethod
    def default_factory() -> "UniformRandomGeneratorFactory":
        return UniformRandomGeneratorFactory(PRNGType.BLAKE2XB)


class UniformRandomGeneratorInfo:
    """(prng_type, seed) pair recorded in seeded ciphertexts
    (``randomgen.h:55-304``)."""

    def __init__(self, prng_type: PRNGType = PRNGType.UNKNOWN, seed: Tuple[int, ...] = (0,) * 8):
        self.prng_type = PRNGType(prng_type)
        self.seed = tuple(int(s) & 0xFFFFFFFFFFFFFFFF for s in seed)

    def make_prng(self) -> Optional[_BufferedPRNG]:
        """The generator of this type and seed; None for an unknown type."""
        if self.prng_type == PRNGType.BLAKE2XB:
            return Blake2xbPRNG(self.seed)
        if self.prng_type == PRNGType.SHAKE256:
            return Shake256PRNG(self.seed)
        return None

    def save_members(self) -> bytes:
        """u8 type, then the 8 seed words (little-endian)."""
        return struct.pack("<B8Q", int(self.prng_type), *self.seed)

    @classmethod
    def load_members(cls, data: bytes) -> "UniformRandomGeneratorInfo":
        (ptype,) = struct.unpack_from("<B", data, 0)
        return cls(PRNGType(ptype), struct.unpack_from("<8Q", data, 1))

    SAVE_SIZE_RAW = 1 + PRNG_SEED_BYTE_COUNT

    def __eq__(self, other):
        return (
            isinstance(other, UniformRandomGeneratorInfo)
            and self.prng_type == other.prng_type
            and self.seed == other.seed
        )

"""Encryption parameters and parms-id hashing.

Port of ``seal_tpu/params.py`` (counterpart of
``native/src/seal/encryptionparams.{h,cpp}``): a parameter set is
(scheme, N, coeff_modulus chain, plain_modulus), identified by a 256-bit
blake2b hash over the little-endian u64 words [scheme, N, q_1..q_k, t]
(``encryptionparams.cpp:124-158``), recomputed on every mutation.
``hashlib.blake2b(digest_size=32)`` gives the same bytes as the JAX
package's native blake2b.  The random-generator factory and the noise
sampler ride along without entering the parms-id.
"""

from __future__ import annotations

import enum
import hashlib
import struct
from typing import List, Optional, Sequence, Tuple

from .modulus import Modulus
from .random import UniformRandomGeneratorFactory

ParmsId = Tuple[int, int, int, int]
PARMS_ID_ZERO: ParmsId = (0, 0, 0, 0)


class SchemeType(enum.IntEnum):
    """cf. ``scheme_type`` (encryptionparams.h:25-38)."""

    NONE = 0x0
    BFV = 0x1
    CKKS = 0x2
    BGV = 0x3


class EncryptionParameters:
    def __init__(self, scheme: SchemeType = SchemeType.NONE):
        self._scheme = SchemeType(scheme)
        self._poly_modulus_degree = 0
        self._coeff_modulus: List[Modulus] = []
        self._plain_modulus = Modulus(0)
        self._random_factory: Optional[UniformRandomGeneratorFactory] = None
        self._noise_sampler = "cbd"
        self._parms_id = PARMS_ID_ZERO
        self._compute_parms_id()

    def set_poly_modulus_degree(self, degree: int):
        if self._scheme == SchemeType.NONE and degree:
            raise ValueError("poly_modulus_degree is not supported for this scheme")
        self._poly_modulus_degree = int(degree)
        self._compute_parms_id()

    def set_coeff_modulus(self, moduli: Sequence[Modulus]):
        if self._scheme == SchemeType.NONE and moduli:
            raise ValueError("coeff_modulus is not supported for this scheme")
        self._coeff_modulus = [m if isinstance(m, Modulus) else Modulus(m) for m in moduli]
        self._compute_parms_id()

    def set_plain_modulus(self, modulus):
        if self._scheme == SchemeType.CKKS:
            raise ValueError("plain_modulus is not supported for this scheme")
        self._plain_modulus = modulus if isinstance(modulus, Modulus) else Modulus(modulus)
        self._compute_parms_id()

    def set_random_generator(self, factory: UniformRandomGeneratorFactory):
        """Select the PRNG factory (the reference's SEAL_DEFAULT_PRNG option,
        at run time); a factory with a default seed makes keygen and
        encryption deterministic."""
        self._random_factory = factory

    def set_noise_sampler(self, kind: str):
        """'cbd' (centered binomial, the default) or 'gaussian' (clipped
        normal, sigma 3.2)."""
        if kind not in ("cbd", "gaussian"):
            raise ValueError("noise sampler must be 'cbd' or 'gaussian'")
        self._noise_sampler = kind

    @property
    def scheme(self) -> SchemeType:
        return self._scheme

    @property
    def poly_modulus_degree(self) -> int:
        return self._poly_modulus_degree

    @property
    def coeff_modulus(self) -> List[Modulus]:
        return list(self._coeff_modulus)

    @property
    def plain_modulus(self) -> Modulus:
        return self._plain_modulus

    @property
    def random_generator(self) -> UniformRandomGeneratorFactory:
        return self._random_factory or UniformRandomGeneratorFactory.default_factory()

    @property
    def noise_sampler(self) -> str:
        return self._noise_sampler

    @property
    def parms_id(self) -> ParmsId:
        return self._parms_id

    def clone(self) -> "EncryptionParameters":
        p = EncryptionParameters(self._scheme)
        p._poly_modulus_degree = self._poly_modulus_degree
        p._coeff_modulus = list(self._coeff_modulus)
        p._plain_modulus = self._plain_modulus
        p._random_factory = self._random_factory
        p._noise_sampler = self._noise_sampler
        p._compute_parms_id()
        return p

    def _compute_parms_id(self):
        words = [int(self._scheme), self._poly_modulus_degree]
        words += [m.value for m in self._coeff_modulus]
        words += [self._plain_modulus.value]
        data = struct.pack(f"<{len(words)}Q", *words)
        digest = hashlib.blake2b(data, digest_size=32).digest()
        self._parms_id = tuple(struct.unpack("<4Q", digest))

    def __eq__(self, other):
        return isinstance(other, EncryptionParameters) and self._parms_id == other._parms_id

    def __hash__(self):
        return hash(self._parms_id)

    def __repr__(self):
        return (
            f"EncryptionParameters(scheme={self._scheme.name}, n={self._poly_modulus_degree}, "
            f"coeff_modulus_bits={[m.bit_count for m in self._coeff_modulus]}, "
            f"plain_modulus={self._plain_modulus.value})"
        )

"""Plaintexts, ciphertexts and keys.

Port of ``seal_tpu/data.py`` (counterparts of ``plaintext.h`` /
``ciphertext.h`` / ``secretkey.h`` / ``publickey.h`` / ``kswitchkeys.h``): a
ciphertext is one int64 tensor of shape (size, k, n), layout
[poly][rns_limb][coeff] as in ``ciphertext.h:728-742``, plus host metadata;
key-switching keys are stacked over the decomposition axis, each component
(D, k_key, n).  A plaintext is either a coefficient polynomial on the host
or an RNS polynomial in NTT form on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .params import ParmsId, PARMS_ID_ZERO


class Plaintext:
    """Either a coefficient polynomial (parms_id zero, a host numpy uint64
    array) or an RNS polynomial in NTT form tied to a context level (an
    int64 (k, n) tensor on the context's device), cf. ``plaintext.h:796-802``."""

    def __init__(self, coeff_count: int = 0):
        self.parms_id: ParmsId = PARMS_ID_ZERO
        self.scale: float = 1.0
        self.coeff_data: np.ndarray = np.zeros(coeff_count, dtype=np.uint64)
        self.rns_data: Optional[torch.Tensor] = None

    @classmethod
    def from_coeffs(cls, coeffs) -> "Plaintext":
        p = cls()
        p.coeff_data = np.asarray(coeffs, dtype=np.uint64).copy()
        return p

    @classmethod
    def from_hex(cls, hex_poly: str) -> "Plaintext":
        """Parse SEAL's hex-polynomial format, e.g. '3x^2 + 1x^1 + 2'."""
        terms = {}
        s = hex_poly.replace(" ", "")
        if not s:
            return cls(0)
        for term in s.split("+"):
            if "x^" in term:
                c, e = term.split("x^")
                coeff, exp = (int(c, 16) if c else 1), int(e)
            elif term.endswith("x"):
                coeff, exp = (int(term[:-1], 16) if term[:-1] else 1), 1
            else:
                coeff, exp = int(term, 16), 0
            terms[exp] = terms.get(exp, 0) + coeff
        data = np.zeros(max(terms) + 1, dtype=np.uint64)
        for e, c in terms.items():
            data[e] = c
        return cls.from_coeffs(data)

    @property
    def is_ntt_form(self) -> bool:
        return self.parms_id != PARMS_ID_ZERO

    @property
    def coeff_count(self) -> int:
        return int(self.rns_data.numel()) if self.is_ntt_form else len(self.coeff_data)

    def significant_coeff_count(self) -> int:
        nz = np.nonzero(self.coeff_data)[0]
        return int(nz[-1]) + 1 if len(nz) else 0

    def to_string(self) -> str:
        """SEAL's hex-polynomial format (plaintext.cpp to_string)."""
        if self.is_ntt_form:
            raise ValueError("cannot convert NTT-form plaintext to string")
        nz = np.nonzero(self.coeff_data)[0]
        if len(nz) == 0:
            return "0"
        parts = []
        for e in reversed(nz):
            c = format(int(self.coeff_data[e]), "X")
            parts.append(c if e == 0 else f"{c}x^{e}")
        return " + ".join(parts)

    def __eq__(self, other):
        """Coefficient plaintexts compare up to trailing zeros; NTT-form
        ones by level and data."""
        if not isinstance(other, Plaintext):
            return NotImplemented
        if self.is_ntt_form != other.is_ntt_form:
            return False
        if self.is_ntt_form:
            return self.parms_id == other.parms_id and torch.equal(self.rns_data.cpu(), other.rns_data.cpu())
        asig, bsig = self.significant_coeff_count(), other.significant_coeff_count()
        return asig == bsig and bool((self.coeff_data[:asig] == other.coeff_data[:bsig]).all())

    def copy(self) -> "Plaintext":
        p = Plaintext()
        p.parms_id = self.parms_id
        p.scale = self.scale
        p.coeff_data = self.coeff_data.copy()
        p.rns_data = self.rns_data
        return p


class Ciphertext:
    """RNS ciphertext: int64 (size, k, n) + metadata (cf. ``ciphertext.h``)."""

    def __init__(
        self,
        data: Optional[torch.Tensor] = None,
        parms_id: ParmsId = PARMS_ID_ZERO,
        is_ntt_form: bool = False,
        scale: float = 1.0,
        correction_factor: int = 1,
    ):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self.correction_factor = correction_factor
        # the public seed of c1 for seeded (compressed) ciphertexts
        self.seed_info = None

    @property
    def size(self) -> int:
        return 0 if self.data is None else int(self.data.shape[0])

    @property
    def coeff_modulus_size(self) -> int:
        return 0 if self.data is None else int(self.data.shape[1])

    @property
    def poly_modulus_degree(self) -> int:
        return 0 if self.data is None else int(self.data.shape[2])

    def poly(self, j: int) -> torch.Tensor:
        return self.data[j]

    def to_np(self) -> np.ndarray:
        """The data as a (size, k, n) numpy uint64 array, read from the device."""
        data = self.data.unshard() if hasattr(self.data, "unshard") else self.data
        return data.detach().cpu().contiguous().numpy().view(np.uint64)

    def copy(self) -> "Ciphertext":
        c = Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale, self.correction_factor)
        c.seed_info = self.seed_info
        return c

    def is_transparent(self) -> bool:
        """True if every poly beyond c0 is zero (cf. ``ciphertext.h:451``).

        Reads one flag back from the device (from each rank's, for data
        sharded over a mesh), which waits for the data.
        """
        if self.size < 2:
            return True
        parts = getattr(self.data, "shards", [self.data])
        return not any(bool(torch.any(p[1:] != 0)) for p in parts)


class SecretKey:
    """NTT-form ternary secret at the key level, (k_key, n) (``secretkey.h:297``)."""

    def __init__(self, data: Optional[torch.Tensor] = None, parms_id: ParmsId = PARMS_ID_ZERO):
        self.data = data
        self.parms_id = parms_id

    def zeroize(self):
        """Best-effort erasure (the reference's clear_on_destruction): the
        key drops its tensor for zeros of the same shape and device, and its
        level.  Copies the caller made are the caller's to erase."""
        if self.data is not None:
            self.data = torch.zeros_like(self.data)
        self.parms_id = PARMS_ID_ZERO


class PublicKey:
    """Encryption of zero in NTT form at the key level (``publickey.h:268``)."""

    def __init__(self, ciphertext: Optional[Ciphertext] = None):
        self.data = ciphertext if ciphertext is not None else Ciphertext()

    @property
    def parms_id(self) -> ParmsId:
        return self.data.parms_id


class KSwitchKeys:
    """Key-switching keys, stacked for the contraction.

    ``keys[index]`` is None or a dict with 'c0', 'c1': int64 tensors of
    shape (num_decomp, k_key, n), the two components of each
    decomposition-limb encryption, NTT form (cf. ``kswitchkeys.h:340``).
    """

    def __init__(self):
        self.parms_id: ParmsId = PARMS_ID_ZERO
        self.keys: List[Optional[dict]] = []

    def size(self) -> int:
        """The number of keys present."""
        return sum(1 for k in self.keys if k is not None)


class RelinKeys(KSwitchKeys):
    """Relinearization keys: index = key_power - 2 (``relinkeys.h:58``)."""

    @staticmethod
    def get_index(key_power: int) -> int:
        if key_power < 2:
            raise ValueError("key_power cannot be less than 2")
        return key_power - 2

    def has_key(self, key_power: int) -> bool:
        i = self.get_index(key_power)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, key_power: int) -> dict:
        return self.keys[self.get_index(key_power)]


class GaloisKeys(KSwitchKeys):
    """Galois keys: index = (galois_elt - 1) / 2 (``galoiskeys.h:48``)."""

    @staticmethod
    def get_index(galois_elt: int) -> int:
        if not (galois_elt & 1):
            raise ValueError("galois_elt is not valid")
        return (galois_elt - 1) >> 1

    def has_key(self, galois_elt: int) -> bool:
        i = self.get_index(galois_elt)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, galois_elt: int) -> dict:
        return self.keys[self.get_index(galois_elt)]

"""BatchEncoder: N slots of Z_t as a 2 x (N/2) matrix (BFV and BGV).

Port of ``seal_tpu/encoders.py`` (counterpart of ``batchencoder.{h,cpp}``):
slot values go to the bit-reversed positions of the generator-3 orbit
(the index map, batchencoder.cpp:64-88), then an inverse negacyclic NTT
mod t makes slot-wise products polynomial products.  Host data in, host
data out: the mod-t transform runs on the host in the port's copy of the
JAX package's C NTT (``csrc/ntt_mod.c``, built at first use by
``host_c.py``), as the reference's does; a device launch would be a round
trip and nothing else.  The CKKS encoder is ``ckks_encoder.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from . import host_c, numth
from .context import SealContext
from .data import Plaintext
from .ntt_tables import host_c_ntt_tables
from .params import SchemeType


@functools.cache
def _native() -> ctypes.CDLL:
    lib = host_c.load("ntt_mod")
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.seal_ntt_mod_fwd.argtypes = [u64p, ctypes.c_size_t, ctypes.c_uint64, u64p, u64p]
    lib.seal_ntt_mod_fwd.restype = None
    lib.seal_ntt_mod_inv.argtypes = [u64p, ctypes.c_size_t, ctypes.c_uint64, u64p, u64p,
                                     ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
    lib.seal_ntt_mod_inv.restype = None
    return lib


def _u64p(arr: np.ndarray):
    if arr.dtype != np.uint64 or not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("expected a contiguous uint64 array")
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class BatchEncoder:
    def __init__(self, context: SealContext):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        cd = context.first_context_data()
        if cd.parms.scheme not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")
        if not cd.qualifiers.using_batching:
            raise ValueError("encryption parameters are not valid for batching")
        self.context = context
        self.slots = n = cd.parms.poly_modulus_degree
        logn = n.bit_length() - 1
        row_size = n >> 1
        m = n << 1
        index_map = np.zeros(n, dtype=np.int64)
        pos = 1
        for i in range(row_size):
            index_map[i] = numth.reverse_bits((pos - 1) >> 1, logn)
            index_map[row_size | i] = numth.reverse_bits((m - pos - 1) >> 1, logn)
            pos = (pos * 3) & (m - 1)
        self.index_map = index_map

    def _tables(self) -> dict:
        cd = self.context.first_context_data()
        return host_c_ntt_tables(cd.log_n, cd.parms.plain_modulus)

    def encode(self, values: Sequence[int]) -> Plaintext:
        """uint64 slot values -> coefficient plaintext (inverse NTT mod t)."""
        t = self.context.first_context_data().parms.plain_modulus.value
        arr = np.asarray(values if isinstance(values, (np.ndarray, list, tuple)) else list(values), dtype=np.uint64)
        if arr.ndim != 1:
            raise ValueError("values_matrix must be one-dimensional")
        if arr.size > self.slots:
            raise ValueError("values_matrix size is too large")
        if arr.size and int(arr.max()) >= t:
            raise ValueError("input value is larger than plain_modulus")
        buf = np.zeros(self.slots, dtype=np.uint64)
        buf[self.index_map[: arr.size]] = arr
        c = self._tables()
        _native().seal_ntt_mod_inv(_u64p(buf), buf.size, c["q"], _u64p(c["inv_op"]), _u64p(c["inv_qt"]),
                                   c["invn_op"], c["invn_qt"], c["last_op"], c["last_qt"])
        return Plaintext.from_coeffs(buf)

    def encode_int64(self, values: Sequence[int]) -> Plaintext:
        """Signed variant: negatives wrap mod t (batchencoder.cpp:150-194)."""
        t = self.context.first_context_data().parms.plain_modulus.value
        arr = np.asarray(values, dtype=np.int64)
        if arr.size and (int(arr.min()) < -(t >> 1) or int(arr.max()) > (t - 1) >> 1):
            raise ValueError("input value is out of range")
        return self.encode(np.where(arr < 0, arr + t, arr).astype(np.uint64))

    def decode(self, plain: Plaintext) -> np.ndarray:
        if plain.is_ntt_form:
            raise ValueError("plain cannot be in NTT form")
        buf = np.zeros(self.slots, dtype=np.uint64)
        data = plain.coeff_data[: self.slots]
        buf[: len(data)] = data
        c = self._tables()
        _native().seal_ntt_mod_fwd(_u64p(buf), buf.size, c["q"], _u64p(c["fwd_op"]), _u64p(c["fwd_qt"]))
        return buf[self.index_map]

    def decode_int64(self, plain: Plaintext) -> np.ndarray:
        t = self.context.first_context_data().parms.plain_modulus.value
        vals = self.decode(plain)
        return np.where(vals > np.uint64(t >> 1), vals.astype(np.int64) - t, vals.astype(np.int64))

"""Wrapper of kernel A, the card's negacyclic NTT (``csrc/ntt.cu``).

Replaces ``seal_tpu/ops/pallas_mxu_ntt.py:_fused_kernel``.  The plain
version is ``ops/ntt.py:ntt_forward`` / ``ntt_inverse``; the kernel's
output is always reduced to [0, q), so it is compared with the plain
version's reduced output.  ``ntt_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ntt_tables import LimbTables
from . import cuda_build

# A row is spread over the shared memory of a cluster of (up to) 8 blocks:
# 32 KB of data and 64 KB of roots a block at n = 32768.  Larger rows go to
# the four-step stage kernel, as the JAX package sends n > 32768 past
# _fused_kernel.  A chunk needs at least two elements: n >= 4.
MIN_LOG_N = 2
MAX_LOG_N = 15

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("ntt")
    lib.seal_ntt_forward.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.seal_ntt_forward.restype = _I
    lib.seal_ntt_inverse.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.seal_ntt_inverse.restype = _I
    return lib


def _check_inputs(x: torch.Tensor, t: LimbTables):
    if x.dim() < 2:
        raise ValueError("ntt_cuda takes data of shape (..., k, n)")
    *_, k, n = x.shape
    if t.log_n < 1 or n != 1 << t.log_n or k != t.q.shape[0]:
        raise ValueError(f"data (..., {k}, {n}) does not match tables over {t.q.shape[0]} limbs at n={1 << t.log_n}")
    if not MIN_LOG_N <= t.log_n <= MAX_LOG_N:
        raise ValueError(f"ntt_cuda spreads a row over a cluster's shared memory and supports "
                         f"{1 << MIN_LOG_N} <= n <= {1 << MAX_LOG_N}, got n={n}")
    if not x.is_cuda:
        raise ValueError("ntt_cuda takes a CUDA tensor")
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError(f"ntt_cuda takes contiguous int64 data, got {x.dtype}")
    for name, a in zip(t._fields, t[: LimbTables.N_ARRAY_FIELDS]):
        if a.device != x.device or a.dtype != torch.int64 or not a.is_contiguous():
            raise ValueError(f"table {name} must be a contiguous int64 tensor on {x.device}")


def ntt_cuda(x: torch.Tensor, t: LimbTables, inverse: bool) -> torch.Tensor:
    """Negacyclic NTT of every (..., limb) row of ``x`` on the card.

    Forward input in [0, 4q), inverse input in [0, 2q); output in [0, q).
    """
    _check_inputs(x, t)
    lib = _lib()
    *_, k, n = x.shape
    rows = x.numel() // n
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if inverse:
            rc = lib.seal_ntt_inverse(
                x.data_ptr(), out.data_ptr(), t.inv_op.data_ptr(), t.inv_qt.data_ptr(),
                t.invn_op.data_ptr(), t.invn_qt.data_ptr(), t.invn_last_op.data_ptr(),
                t.invn_last_qt.data_ptr(), t.q.data_ptr(), rows, k, t.log_n, stream)
        else:
            rc = lib.seal_ntt_forward(
                x.data_ptr(), out.data_ptr(), t.fwd_op.data_ptr(), t.fwd_qt.data_ptr(),
                t.q.data_ptr(), rows, k, t.log_n, stream)
        ntt_cuda.launches += 1
    cuda_build.check(rc, "ntt_cuda")
    return out


ntt_cuda.launches = 0

"""Kernel B, the fused key-switch contraction, and its plain version.

``switch_key_contract_cuda`` wraps ``csrc/switch_key.cu``, which replaces
``seal_tpu/ops/pallas_switch_key.py:_sk_kernel``.
``switch_key_contract_plain`` is the staged formulation of
``seal_tpu/evaluator.py:594-630``: reduce, batched forward NTT, u128
contraction over the decomposition axis with a Barrett guard every 64
summands, final Barrett.  The kernel spreads a row over the shared memory
of a thread block cluster, up to n = 32768, the JAX package's fused range
(``pallas_switch_key.py:49-56``, ``fits_fused``).  Above it the card runs
the staged formulation itself, as the JAX package does there: the decompose
and the contraction in plain PyTorch, the batched NTT on the four-step stage
kernel.
All take the contract of
``seal_tpu.ops.pallas_switch_key.switch_key_contract``:

* ``t_c``: (..., D, n) coefficient-form source limbs, limb j < q_j, for
  any leading batch of ciphertexts that share the key;
* ``t_n``: (..., D, n) the same source in NTT form (the i == j fast path of
  evaluator.cpp:2686-2692), or None;
* ``key``: (2, D', Rn, n) the selected key columns, D' >= D; rows beyond D
  are not used (a key made for a higher level);
* ``t``: ``LimbTables`` over the Rn output moduli;
* ``need_reduce``: (D, Rn) bool, True where q_j > q_i;
* ``row_offset``: the rows are decomposition rows [row_offset, row_offset +
  D) (a rank of a mesh contracts its own rows; their sums add mod q_i), so
  the fast path applies at i == row_offset + j.

and return (..., 2, Rn, n) in NTT form, in [0, q_i).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ntt_tables import LimbTables
from . import cuda_build
from . import u64 as U
from .ntt import forward, ntt_forward, use_kernels

# Kernel B spreads a row over a cluster of 8 blocks' shared memory:
# n <= 32768, as kernel A.
MAX_LOG_N = 15

_ACC_WINDOW = 64  # lazy u128 summands between Barrett guards (defines.h:66)
_MIN_LOG_N = 3    # a cluster of 2 blocks, chunks of at least 4 coefficients

_P = ctypes.c_void_p
_I = ctypes.c_int


def switch_key_contract_plain(t_c: torch.Tensor, t_n, key: torch.Tensor, t: LimbTables,
                              need_reduce: torch.Tensor, ntt=None, row_offset: int = 0) -> torch.Tensor:
    """The staged formulation, in plain PyTorch on the tensors' device.

    ``ntt(x, t)`` replaces the butterflies for the batched forward NTT of
    the (..., D, Rn, n) decomposition; any exact transform gives the same
    output.
    """
    D, n = t_c.shape[-2:]
    key = key[:, :D]
    tt = t_c[..., :, None, :]                                    # (..., D, 1, n)
    reduced = U.barrett_reduce_64(tt, t.q, t.ratio_hi)           # (..., D, Rn, n)
    t_op = torch.where(need_reduce[:, :, None], reduced, tt)
    t_op = ntt_forward(t_op, t, lazy=True) if ntt is None else ntt(t_op, t)   # < 4q
    if t_n is not None:
        rows = [j for j in range(D) if row_offset + j < key.shape[2]]
        t_op[..., rows, [row_offset + j for j in rows], :] = t_n[..., rows, :]
    lo = torch.zeros(t_op.shape[:-3] + key.shape[:1] + key.shape[2:], dtype=torch.int64, device=t_c.device)
    acc = (lo, torch.zeros_like(lo))
    for j in range(D):
        acc = U.add128(acc, U.mul64_wide(t_op[..., j, None, :, :], key[:, j]))
        if (j + 1) % _ACC_WINDOW == 0 and j + 1 < D:
            acc = (U.barrett_reduce_128(acc, t.q, t.ratio_lo, t.ratio_hi), torch.zeros_like(lo))
    return U.barrett_reduce_128(acc, t.q, t.ratio_lo, t.ratio_hi)


@functools.cache
def _lib():
    lib = cuda_build.load("switch_key")
    lib.seal_switch_key_contract.argtypes = [_P] * 10 + [_I] * 6 + [_P]
    lib.seal_switch_key_contract.restype = _I
    return lib


def _check_inputs(t_c, t_n, key, t, need_reduce, row_offset):
    if t_c.dim() not in (2, 3):
        raise ValueError("t_c must have shape (D, n) or (B, D, n)")
    D, n = t_c.shape[-2:]
    if not (_MIN_LOG_N <= t.log_n <= MAX_LOG_N):
        raise ValueError(f"switch_key_contract_cuda spreads a row over a cluster's shared memory and supports "
                         f"{1 << _MIN_LOG_N} <= n <= {1 << MAX_LOG_N}, got n={n}")
    if not t_c.is_cuda:
        raise ValueError("switch_key_contract_cuda takes CUDA tensors")
    dev = t_c.device
    tensors = {"t_c": t_c}
    if t_n is not None:
        tensors["t_n"] = t_n
    for name, a in tensors.items():
        if a.device != dev or a.dtype != torch.int64 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int64 tensor on {dev}")
    if t_n is not None and t_n.shape != t_c.shape:
        raise ValueError("t_n must have the shape of t_c")
    if key.dim() != 4 or key.shape[0] != 2 or key.shape[1] < D or key.shape[3] != n:
        raise ValueError(f"key must have shape (2, D' >= {D}, Rn, {n}), got {tuple(key.shape)}")
    Rn = key.shape[2]
    if (key.device != dev or key.dtype != torch.int64 or key.stride()[1:] != (Rn * n, n, 1)
            or key.stride(0) % (Rn * n)):
        raise ValueError(f"key must be an int64 tensor on {dev} whose rows of (Rn, n) are contiguous")
    if t.q.shape[0] != Rn or n != 1 << t.log_n:
        raise ValueError("tables must cover the Rn output moduli at the data's n")
    if t_c.numel() // (D * n or 1) > 65535:
        raise ValueError("switch_key_contract_cuda takes at most 65535 ciphertexts a launch")
    if need_reduce.shape != (D, Rn) or need_reduce.dtype != torch.bool or need_reduce.device != dev:
        raise ValueError(f"need_reduce must be a ({D}, {Rn}) bool tensor on {dev}")
    if row_offset < 0:
        raise ValueError("row_offset must not be negative")
    for name in ("fwd_op", "fwd_qt", "q", "ratio_lo", "ratio_hi"):
        a = getattr(t, name)
        if a.device != dev or a.dtype != torch.int64 or not a.is_contiguous():
            raise ValueError(f"table {name} must be a contiguous int64 tensor on {dev}")


def switch_key_contract_cuda(t_c: torch.Tensor, t_n, key: torch.Tensor, t: LimbTables,
                             need_reduce: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Kernel B on the card; one launch for the whole batch, one cluster of
    blocks per (output limb, ciphertext)."""
    _check_inputs(t_c, t_n, key, t, need_reduce, row_offset)
    lib = _lib()
    *lead, D, n = t_c.shape
    Rn = key.shape[2]
    B = t_c.numel() // (D * n) if D else 0
    if B == 0 or D == 0:           # no rows: the empty sum
        return torch.zeros((*lead, 2, Rn, n), dtype=torch.int64, device=t_c.device)
    out = torch.empty((*lead, 2, Rn, n), dtype=torch.int64, device=t_c.device)
    need_reduce = need_reduce.contiguous()
    with torch.cuda.device(t_c.device):
        stream = torch.cuda.current_stream(t_c.device).cuda_stream
        rc = lib.seal_switch_key_contract(
            t_c.data_ptr(), None if t_n is None else t_n.data_ptr(), key.data_ptr(),
            need_reduce.data_ptr(), t.fwd_op.data_ptr(), t.fwd_qt.data_ptr(), t.q.data_ptr(),
            t.ratio_lo.data_ptr(), t.ratio_hi.data_ptr(), out.data_ptr(),
            B, D, key.stride(0) // (Rn * n), Rn, t.log_n, row_offset, stream)
        switch_key_contract_cuda.launches += 1
    cuda_build.check(rc, "switch_key_contract_cuda")
    return out


switch_key_contract_cuda.launches = 0


def switch_key_contract(t_c: torch.Tensor, t_n, key: torch.Tensor, t: LimbTables,
                        need_reduce: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Kernel B for tensors on the card up to n = 32768, the staged
    formulation on the stage kernel above that, the plain version on the CPU
    (or on the card inside ``ops.ntt.plain_on_card()``)."""
    if use_kernels(t_c):
        if t.log_n <= MAX_LOG_N:
            return switch_key_contract_cuda(t_c, t_n, key, t, need_reduce, row_offset)
        return switch_key_contract_plain(t_c, t_n, key, t, need_reduce, ntt=forward, row_offset=row_offset)
    return switch_key_contract_plain(t_c, t_n, key, t, need_reduce, row_offset=row_offset)

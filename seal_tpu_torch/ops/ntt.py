"""Negacyclic NTT / inverse NTT: the plain butterflies and the dispatch.

Port of ``seal_tpu/ops/ntt.py``.  ``ntt_forward`` and ``ntt_inverse`` are
the plain PyTorch versions: Harvey butterflies on int64 tensors, each stage
a static reshape ``(..., k, m, 2, gap)`` plus elementwise u64 ops, with
twiddle tables laid out so stage slices are contiguous.  Outputs are in the
reference's bit-reversed NTT order (``util/dwthandler.h:94-356``); lazy
reduction keeps values in [0, 4q) through the forward stages and [0, 2q)
through the inverse (``util/ntt.h:195-340``).

``forward`` and ``inverse`` are what the rest of the port calls (the
dispatch of ``seal_tpu/ops/ntt.py:90-115,155-229``):

* a tensor on the card at n <= 32768, where a row fits the shared memory
  of a cluster of blocks, goes to kernel A (``ops/cuda_ntt.py``), one
  launch, as the JAX package sends n <= 32768 to ``_fused_kernel``;
* a tensor on the card above that goes to the four-step transform
  (``ops/four_step.py``) on the stage kernel (``ops/cuda_four_step.py``),
  two launches per transform;
* a tensor on the CPU goes to the butterflies at every n.

Nothing falls back: a tensor on the card launches a kernel or raises.  Both
kernels' outputs are reduced to [0, q), as the JAX package's Pallas
kernels' are, even when ``lazy`` is asked for.  With ``SEAL_TPU_DEBUG=1``
(``debug.py``) the two wrappers check the reference's range contracts
(``util/ntt.h:195-340``) on their input and output, around the kernel.

:func:`plain_on_card` is the one switch between the card's kernels and
their plain versions: inside it, every entry point of the port (keygen,
encryption, the encoder, the evaluator) runs the plain PyTorch versions on
the card too, to check the kernels.  :func:`use_kernels` is what each
dispatch reads.  Both live in ``ops/u64.py``, whose modular functions
dispatch too, and are exported here.

Shapes: data is int64 (..., k, n); all k RNS limbs transform together.
"""

from __future__ import annotations

import torch

from .. import debug
from ..ntt_tables import LimbTables, four_step_tables_for
from . import u64 as U
from .cuda_four_step import stage_cuda
from .cuda_ntt import MAX_LOG_N, ntt_cuda
from .four_step import four_step_forward, four_step_inverse
from .u64 import plain_on_card, use_kernels


def _guard(x: torch.Tensor, two_q: torch.Tensor) -> torch.Tensor:
    """Reduce from [0, 4q) to [0, 2q) with one conditional subtraction."""
    return torch.where(x >= two_q, x - two_q, x)


def _check_shape(x: torch.Tensor, t: LimbTables):
    *_, k, n = x.shape
    if k != t.q.shape[0] or n != 1 << t.log_n:
        raise ValueError(f"data (..., {k}, {n}) does not match tables over {t.q.shape[0]} limbs at n={1 << t.log_n}")


def ntt_forward(x: torch.Tensor, t: LimbTables, lazy: bool = False) -> torch.Tensor:
    """Forward negacyclic NTT; input coefficients in [0, 4q).

    Output in [0, q), or [0, 4q) when ``lazy``.
    """
    _check_shape(x, t)
    *lead, k, n = x.shape
    two_q = t.two_q[:, :, None]                  # (k, 1, 1)
    q = t.q[:, :, None]
    for s in range(t.log_n):
        m = 1 << s
        gap = n >> (s + 1)
        xr = x.reshape(*lead, k, m, 2, gap)
        x0, x1 = xr[..., 0, :], xr[..., 1, :]
        w_op = t.fwd_op[:, m : 2 * m, None]
        w_qt = t.fwd_qt[:, m : 2 * m, None]
        u = _guard(x0, two_q)
        v = U.mul_mod_shoup_lazy(x1, w_op, w_qt, q)
        x = torch.stack([u + v, u + two_q - v], dim=-2).reshape(*lead, k, n)
    if lazy:
        return x
    y = _guard(x, t.two_q)
    return torch.where(y >= t.q, y - t.q, y)


def ntt_inverse(x: torch.Tensor, t: LimbTables, lazy: bool = False) -> torch.Tensor:
    """Inverse negacyclic NTT with 1/n fused into the last stage.

    Input in [0, 2q); output in [0, q), or [0, 2q) when ``lazy``.
    """
    _check_shape(x, t)
    *lead, k, n = x.shape
    two_q = t.two_q[:, :, None]
    q = t.q[:, :, None]
    offset = 1
    for s in range(t.log_n):
        m = n >> (s + 1)
        gap = 1 << s
        xr = x.reshape(*lead, k, m, 2, gap)
        x0, x1 = xr[..., 0, :], xr[..., 1, :]
        if m > 1:
            w_op = t.inv_op[:, offset : offset + m, None]
            w_qt = t.inv_qt[:, offset : offset + m, None]
            a = _guard(x0 + x1, two_q)
            b = U.mul_mod_shoup_lazy(x0 + two_q - x1, w_op, w_qt, q)
        else:
            # Final stage: fuse the multiplication by n^{-1}.
            u = _guard(x0, two_q)
            a = U.mul_mod_shoup_lazy(_guard(u + x1, two_q), t.invn_op[:, :, None], t.invn_qt[:, :, None], q)
            b = U.mul_mod_shoup_lazy(u + two_q - x1, t.invn_last_op[:, :, None], t.invn_last_qt[:, :, None], q)
        x = torch.stack([a, b], dim=-2).reshape(*lead, k, n)
        offset += m
    if lazy:
        return x
    return torch.where(x >= t.q, x - t.q, x)


def forward(x: torch.Tensor, t: LimbTables, lazy: bool = False) -> torch.Tensor:
    """Forward NTT on the tensor's device: the card's kernel or the
    butterflies.  Input in [0, 4q); output in [0, q), or [0, 4q) when
    ``lazy``."""
    checked = debug.enabled()
    if checked:
        debug.check_below(x, 2 * t.two_q, "ntt_forward input < 4q (ntt.h:200-209)")
    if use_kernels(x):
        if t.log_n <= MAX_LOG_N:
            y = ntt_cuda(x, t, inverse=False)
        else:
            _check_shape(x, t)
            y = four_step_forward(x.contiguous(), four_step_tables_for(t), stage=stage_cuda)
    else:
        y = ntt_forward(x, t, lazy)
    if checked:
        if lazy:
            debug.check_below(y, 2 * t.two_q, "ntt_forward_lazy output < 4q")
        else:
            debug.check_below(y, t.q, "ntt_forward output < q")
    return y


def inverse(x: torch.Tensor, t: LimbTables, lazy: bool = False) -> torch.Tensor:
    """Inverse NTT on the tensor's device: the card's kernel or the
    butterflies.  Input in [0, 2q); output in [0, q), or [0, 2q) when
    ``lazy``."""
    checked = debug.enabled()
    if checked:
        debug.check_below(x, t.two_q, "ntt_inverse input < 2q (ntt.h:298-307)")
    if use_kernels(x):
        if t.log_n <= MAX_LOG_N:
            y = ntt_cuda(x, t, inverse=True)
        else:
            _check_shape(x, t)
            y = four_step_inverse(x.contiguous(), four_step_tables_for(t), stage=stage_cuda)
    else:
        y = ntt_inverse(x, t, lazy)
    if checked:
        if lazy:
            debug.check_below(y, t.two_q, "ntt_inverse_lazy output < 2q")
        else:
            debug.check_below(y, t.q, "ntt_inverse output < q")
    return y

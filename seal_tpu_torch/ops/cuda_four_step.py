"""Wrapper of the four-step stage kernel (``csrc/four_step.cu``).

Replaces ``seal_tpu/ops/pallas_mxu_ntt.py:_stage_kernel``.  ``stage_cuda``
has the contract of ``ops/four_step.py:stage_plain``, its plain version, and
takes only CUDA tensors: where the plain version multiplies by the named
transform's matrix, the kernel runs its butterflies over the root table
``FourStepTables.<name>_roots``.  ``stage_cuda.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..ntt_tables import FourStepTables
from . import cuda_build
from .four_step import INVERSE_TRANSFORMS, MAX_Q_BITS, StageSpec, check_transform

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("four_step")
    lib.seal_four_step_stage.argtypes = [_P] * 6 + [_I] * 10 + [_P]
    lib.seal_four_step_stage.restype = _I
    return lib


def _compact(strides, shape) -> bool:
    """The two layouts a stage reads and writes: row-major or transposed."""
    (s0, s1), (d0, d1) = strides, shape
    return (s0, s1) == (d1, 1) or (s0, s1) == (1, d0)


def _power_of_two(v: int) -> bool:
    return v >= 1 and v & (v - 1) == 0


def _check_inputs(x, name, ft: FourStepTables, spec: StageSpec, twiddle):
    if not x.is_cuda:
        raise ValueError("stage_cuda takes CUDA tensors")
    if x.dim() < 2:
        raise ValueError("stage_cuda takes data of shape (..., k, n)")
    *_, k, n = x.shape
    M, K, ncols = spec.M, spec.K, spec.ncols
    check_transform(ft, name, M)
    if k != ft.q.shape[0] or K != M or M * ncols != n:
        raise ValueError(f"data (..., {k}, {n}) does not match a ({M} x {K}) stage over {ncols} "
                         f"columns and {ft.q.shape[0]} limbs")
    if not (M >= 2 and _power_of_two(M) and _power_of_two(ncols)):
        raise ValueError(f"stage_cuda runs butterflies: M = {M} >= 2 and {ncols} columns must be powers of two")
    if not (_compact(spec.x_strides, (K, ncols)) and _compact(spec.out_strides, (M, ncols))):
        raise ValueError(f"strides {spec.x_strides}, {spec.out_strides} are not a row-major or "
                         f"transposed layout")
    if max(ft.moduli_values) >> MAX_Q_BITS:
        raise ValueError(f"stage_cuda needs moduli below 2^{MAX_Q_BITS}")
    roots = getattr(ft, f"{name}_roots")
    tensors = {"x": x, "roots": roots, "q": ft.q}
    if twiddle is not None:
        tensors.update(tw_op=twiddle[0], tw_qt=twiddle[1])
        if tuple(twiddle[0].shape) != (k, n) or tuple(twiddle[1].shape) != (k, n):
            raise ValueError(f"twiddles must have shape ({k}, {n})")
    for tname, a in tensors.items():
        if a.device != x.device or a.dtype != torch.int64 or not a.is_contiguous():
            raise ValueError(f"{tname} must be a contiguous int64 tensor on {x.device}")
    return roots


def stage_cuda(x: torch.Tensor, name: str, ft: FourStepTables, spec: StageSpec,
               twiddle: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One stage on the card; one launch.  Input below 4q, output in [0, q)."""
    roots = _check_inputs(x, name, ft, spec, twiddle)
    lib = _lib()
    *_, k, n = x.shape
    rows = x.numel() // n
    out = torch.empty_like(x)
    if rows == 0:
        return out
    tw_op, tw_qt = (None, None) if twiddle is None else (twiddle[0].data_ptr(), twiddle[1].data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.seal_four_step_stage(
            x.data_ptr(), roots.data_ptr(), tw_op, tw_qt, ft.q.data_ptr(), out.data_ptr(), rows, k, n,
            spec.M, spec.ncols, int(name in INVERSE_TRANSFORMS), *spec.x_strides, *spec.out_strides,
            stream)
        stage_cuda.launches += 1
    cuda_build.check(rc, "stage_cuda")
    return out


stage_cuda.launches = 0

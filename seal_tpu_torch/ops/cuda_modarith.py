"""Wrapper of kernel E, the modular functions of ``ops/u64.py`` on the
card (``csrc/modarith.cu``).

Replaces no Pallas kernel: XLA fused this arithmetic on the TPU.  The plain
versions are the bodies of ``ops/u64.py``'s ``add_mod``, ``sub_mod``,
``neg_mod``, ``barrett_reduce_64``, ``barrett_reduce_128``, ``mul_mod``,
``mul_mod_shoup`` and ``mul_mod_shoup_lazy``, which send a CUDA tensor here
outside ``plain_on_card()``; the outputs are bit-identical on every int64
input.  ``modarith_cuda.launches`` counts the launches.

Operands broadcast as PyTorch broadcasts them, and are read where they lie:
each goes to the kernel as its pointer and its element strides over the
broadcast shape (0 on a broadcast axis), with the axes that are one run of
memory in every operand merged (:func:`layout`).  Only an operand whose
innermost remaining axis is strided (neither contiguous nor broadcast) is
copied, to a contiguous tensor.  The output is a new contiguous int64
tensor of the broadcast shape.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from . import cuda_build

# name: (the kernel's op code, number of operands)
OPS = {
    "add_mod": (0, 3),
    "sub_mod": (1, 3),
    "neg_mod": (2, 2),
    "barrett_reduce_64": (3, 3),
    "barrett_reduce_128": (4, 5),
    "mul_mod": (5, 5),
    "mul_mod_shoup": (6, 4),
    "mul_mod_shoup_lazy": (7, 4),
}
MAX_DIMS = 6          # collapsed axes the kernel takes (csrc/modarith.cu: kMaxDims)
MAX_ROWS = (1 << 31) - 1

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("modarith")
    lib.seal_modarith.argtypes = [_I, _P, _P, _P]
    lib.seal_modarith.restype = _I
    return lib


def _broadcast(shapes: Sequence[Sequence[int]]) -> Tuple[int, ...]:
    """The broadcast shape, as ``torch.broadcast_shapes`` gives it; that
    function imports sympy at its first call (seconds of set-up) and takes
    tens of microseconds a call."""
    out = [1] * max(len(s) for s in shapes)
    for s in shapes:
        lead = len(out) - len(s)
        for i, d in enumerate(s):
            o = out[lead + i]
            if d != 1 and d != o:
                if o != 1:
                    raise ValueError(f"shapes {[tuple(x) for x in shapes]} do not broadcast")
                out[lead + i] = d
    return tuple(out)


def _collapse(shape: Sequence[int], operands) -> Tuple[List[int], List[List[int]]]:
    """The axes of ``shape`` with those of size 1 dropped and each merged
    into the one before it where every operand walks the two as one run,
    and each operand's element strides over them (0 on an axis that the
    operand lacks or holds once); at least one axis.  ``operands``: each
    operand's (sizes, strides)."""
    ndim = len(shape)
    per = [[0] * (ndim - len(sizes)) + [0 if n == 1 else st for n, st in zip(sizes, strides)]
           for sizes, strides in operands]
    dims: List[int] = []
    out: List[List[int]] = [[] for _ in per]
    for axis, size in enumerate(shape):
        if size == 1:
            continue
        if dims and all(st[-1] == size * s[axis] for st, s in zip(out, per)):
            dims[-1] *= size
            for st, s in zip(out, per):
                st[-1] = s[axis]
        else:
            dims.append(size)
            for st, s in zip(out, per):
                st.append(s[axis])
    if not dims:
        return [1], [[0] for _ in per]
    return dims, out


@functools.lru_cache(maxsize=4096)
def _plan(operands: tuple):
    """:func:`layout` by the operands' (sizes, strides): the broadcast
    shape, the collapsed axes, each operand's strides over them, and the
    operands strided on the innermost axis.  A call's layout repeats from
    call to call, so it is worked out once: the host's time a launch sets
    the pace where a call's device work is a few milliseconds."""
    shape = _broadcast([sizes for sizes, _ in operands])
    dims, strides = _collapse(shape, operands)
    strided = tuple(i for i, st in enumerate(strides) if st[-1] not in (0, 1))
    return shape, tuple(dims), tuple(tuple(st) for st in strides), strided


def _key(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((a.shape, a.stride()) for a in tensors)


def layout(operands: Sequence[torch.Tensor]):
    """The broadcast shape, the collapsed axes, and for each operand the
    tensor the kernel reads (the operand itself, or a contiguous copy where
    its innermost collapsed stride is neither 0 nor 1) with its strides
    over the collapsed axes."""
    tensors = list(operands)
    shape, dims, strides, strided = _plan(_key(tensors))
    if strided:
        for i in strided:
            tensors[i] = tensors[i].contiguous()
        shape, dims, strides, _ = _plan(_key(tensors))
    return shape, dims, list(zip(tensors, strides))


def modarith_cuda(name: str, *operands: torch.Tensor) -> torch.Tensor:
    """``ops/u64.py``'s function ``name`` on CUDA tensors, one launch; the
    operands in that function's order, a u128 as its two halves."""
    op, count = OPS[name]
    if len(operands) != count:
        raise ValueError(f"modarith_cuda({name!r}) takes {count} operands, got {len(operands)}")
    device = operands[0].device
    for a in operands:
        if not isinstance(a, torch.Tensor) or a.dtype != torch.int64:
            raise ValueError(f"modarith_cuda({name!r}) takes int64 tensors, got {getattr(a, 'dtype', type(a))}")
        if not a.is_cuda or a.device != device:
            raise ValueError(f"modarith_cuda({name!r}) takes CUDA tensors on one device, got {a.device}")
    shape, dims, read = layout(operands)
    if len(dims) > MAX_DIMS or math.prod(dims[:-1]) > MAX_ROWS:
        raise ValueError(f"modarith_cuda({name!r}): operands {[tuple(a.shape) for a in operands]} collapse to "
                         f"{list(dims)}, beyond the kernel's {MAX_DIMS} axes or {MAX_ROWS} rows")
    out = torch.empty(shape, dtype=torch.int64, device=device)
    if out.numel() == 0:
        return out
    words = [len(dims), *dims]
    for tensor, strides in read:
        words += [tensor.data_ptr(), *strides]
    desc = array.array("q", words)
    with torch.cuda.device(device):
        rc = _lib().seal_modarith(op, desc.buffer_info()[0], out.data_ptr(),
                                  torch.cuda.current_stream(device).cuda_stream)
        modarith_cuda.launches += 1
    cuda_build.check(rc, f"modarith_cuda({name!r})")
    return out


modarith_cuda.launches = 0

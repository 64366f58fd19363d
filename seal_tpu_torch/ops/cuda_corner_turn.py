"""Wrapper of the corner-turn kernel (``csrc/corner_turn.cu``).

Replaces ``seal_tpu/parallel/remote_ntt.py:_a2a_kernel``.
``corner_turn_cuda`` has the contract of ``parallel/remote_ntt.py:
corner_turn_plain``, its plain version, and takes only CUDA tensors: one
launch per card that holds source ranks.  Ranks on different cards reach
each other's memory through peer access, which the wrapper enables for
every pair it needs and which it requires: it never stages through the
host.  ``corner_turn_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import cuda_build

MAX_RANKS = 64   # the kernel's parameter block holds this many pointers

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# (device, peer) pairs whose peer access this process has enabled: CUDA
# keeps that state per process, and enabling a pair twice is an error.
_peer_enabled = set()


@functools.cache
def _lib():
    lib = cuda_build.load("corner_turn")
    lib.seal_corner_turn.argtypes = [_P, _P, _I, _P, _I, _I, _I, _I] + [_L] * 6 + [_I, _P]
    lib.seal_corner_turn.restype = _I
    lib.seal_enable_peer_access.argtypes = [_I, _I]
    lib.seal_enable_peer_access.restype = _I
    return lib


def enable_peer_access(device: int, peer: int) -> None:
    """Let card ``device`` store to card ``peer``'s memory, or raise."""
    if (device, peer) in _peer_enabled:
        return
    rc = _lib().seal_enable_peer_access(device, peer)
    if rc == -2:
        raise RuntimeError(f"cuda:{device} has no peer access to cuda:{peer}; the corner turn does not "
                           f"stage through the host")
    cuda_build.check(rc, f"enable_peer_access({device}, {peer})")
    _peer_enabled.add((device, peer))


def _check_inputs(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]):
    P = len(dsts)
    if not 1 <= P <= MAX_RANKS or len(srcs) != P:
        raise ValueError(f"corner_turn_cuda takes 1 to {MAX_RANKS} ranks, as many sources as destinations; "
                         f"got {len(srcs)} and {P}")
    if srcs[0].dim() != 4 or srcs[0].shape[1] != P:
        raise ValueError(f"sources must have shape (k, {P}, r, c), got {tuple(srcs[0].shape)}")
    k, _, r, c = srcs[0].shape
    if k * P * r * c >= 1 << 31:
        raise ValueError("corner_turn_cuda indexes a source with 32-bit integers: below 2^31 elements")
    for name, group, shape in (("source", srcs, (k, P, r, c)), ("destination", dsts, (k, r, P, c))):
        for a in group:
            if not a.is_cuda or a.dtype != torch.int64:
                raise ValueError(f"corner_turn_cuda takes int64 CUDA tensors, got a {name} {a.dtype} on {a.device}")
            if tuple(a.shape) != shape:
                raise ValueError(f"every {name} must have shape {shape}, got {tuple(a.shape)}")
            if a.stride() != group[0].stride() or a.stride(-1) != 1:
                raise ValueError(f"every {name} must have the strides of the first, unit along c; got "
                                 f"{a.stride()} and {group[0].stride()}")


def corner_turn_cuda(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]) -> None:
    """Store block j of every source rank m, ``srcs[m][:, j]`` (k, r, c),
    into ``dsts[j][:, :, m]``.  Sources are (k, P, r, c) and destinations
    (k, r, P, c) views, each group with one set of strides and contiguous
    along c.  Runs on the current streams; a card that stores into another
    card waits for that card's stream first, and that card's stream waits
    for the stores."""
    _check_inputs(srcs, dsts)
    k, P, r, c = srcs[0].shape
    if k * P * r * c == 0:
        return
    lib = _lib()
    s_k, s_j, s_r, _ = srcs[0].stride()
    d_k, d_r, d_m, _ = dsts[0].stride()
    ptrs = [a.data_ptr() for a in list(srcs) + list(dsts)]
    vec = int(c % 2 == 0 and all(s % 2 == 0 for s in (s_k, s_j, s_r, d_k, d_r, d_m))
              and all(p % 16 == 0 for p in ptrs))
    dst_ptrs = (_P * P)(*[d.data_ptr() for d in dsts])
    by_card = {}
    for m, s in enumerate(srcs):
        by_card.setdefault(s.device.index, []).append(m)
    dst_cards = {d.device.index for d in dsts}
    for card, ranks in by_card.items():
        peers = sorted(dst_cards - {card})
        for peer in peers:
            enable_peer_access(card, peer)
        stream = torch.cuda.current_stream(card)
        for peer in peers:
            stream.wait_stream(torch.cuda.current_stream(peer))
        src_ptrs = (_P * len(ranks))(*[srcs[m].data_ptr() for m in ranks])
        src_ranks = (_I * len(ranks))(*ranks)
        with torch.cuda.device(card):
            rc = lib.seal_corner_turn(src_ptrs, src_ranks, len(ranks), dst_ptrs, k, P, r, c,
                                      s_k, s_j, s_r, d_k, d_r, d_m, vec, stream.cuda_stream)
            corner_turn_cuda.launches += 1
        cuda_build.check(rc, "corner_turn_cuda")
        for peer in peers:
            torch.cuda.current_stream(peer).wait_stream(stream)


corner_turn_cuda.launches = 0

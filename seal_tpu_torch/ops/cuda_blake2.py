"""Wrappers of kernel C, the BLAKE2xb stream (``csrc/blake2xb.cu``), and
kernel D, the RLWE samplers over it (``csrc/sample.cu``).

Neither replaces a Pallas kernel: they replace the jnp code of
``seal_tpu/ops/blake2_dev.py`` (``expand_stream_words``, the bulk of
``uniform_from_seed_words``, and ``cbd_noise_from_words`` with
``lift_signed``), which the JAX package runs on the device by default for
keygen and symmetric encryption.  The plain versions are
``ops/blake2_dev.py:expand_stream_words_plain``, ``uniform_bulk_plain`` and
``cbd_lifted_plain``; the outputs are bit-identical.  Each entry point takes
CUDA tensors only, checks its arguments and raises, and counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib_c():
    lib = cuda_build.load("blake2xb")
    lib.seal_blake2xb_expand.argtypes = [_P, _P, _P, _I, _L, _P]
    lib.seal_blake2xb_expand.restype = _I
    return lib


@functools.cache
def _lib_d():
    lib = cuda_build.load("sample")
    lib.seal_sample_uniform_bulk.argtypes = [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.seal_sample_uniform_bulk.restype = _I
    lib.seal_sample_cbd_lifted.argtypes = [_P, _L, _L, _P, _P, _I, _I, _I, _P]
    lib.seal_sample_cbd_lifted.restype = _I
    return lib


def _check_words(what: str, words: torch.Tensor, min_words: int):
    if words.dtype != torch.int64 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError(f"{what} takes contiguous (S, W) int64 stream words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if not words.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor, got one on {words.device}")
    if words.shape[1] < min_words:
        raise ValueError(f"{what} needs {min_words} stream words per seed, got {words.shape[1]}")


def _check_limbs(what: str, words: torch.Tensor, *consts: torch.Tensor):
    k = consts[0].numel()
    for c in consts:
        if c.device != words.device or c.dtype != torch.int64 or c.dim() != 1 or c.numel() != k \
                or not c.is_contiguous():
            raise ValueError(f"{what} takes per-limb constants as contiguous ({k},) int64 tensors on {words.device}")
    if k < 1:
        raise ValueError(f"{what} needs at least one modulus")


def expand_stream_words_cuda(seed_words: torch.Tensor, nwords: int) -> torch.Tensor:
    """The BLAKE2xb stream of S seeds on the card: (S, 8) -> (S, nwords),
    the words of ``Blake2xbPRNG(seed).generate(8 * nwords)``."""
    if not seed_words.is_cuda:
        raise ValueError(f"expand_stream_words_cuda takes a CUDA tensor, got one on {seed_words.device}")
    if seed_words.dtype != torch.int64 or seed_words.dim() != 2 or seed_words.shape[1] != 8:
        raise ValueError(f"expand_stream_words_cuda takes (S, 8) int64 seeds, got {seed_words.dtype} "
                         f"{tuple(seed_words.shape)}")
    S = seed_words.shape[0]
    if nwords < 0 or S >= 1 << 31 or -(-nwords // 512) >= 1 << 31:
        raise ValueError(f"expand_stream_words_cuda: {S} streams of {nwords} words is out of range")
    seeds = seed_words.contiguous()
    out = torch.empty(S, nwords, dtype=torch.int64, device=seeds.device)
    if S == 0 or nwords == 0:
        return out
    nbuf = -(-nwords // 512)
    roots = torch.empty(S, nbuf, 8, dtype=torch.int64, device=seeds.device)    # the root pass's output
    lib = _lib_c()
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        rc = lib.seal_blake2xb_expand(seeds.data_ptr(), roots.data_ptr(), out.data_ptr(), S, nwords, stream)
        expand_stream_words_cuda.launches += 1
    cuda_build.check(rc, "expand_stream_words_cuda")
    return out


def uniform_bulk_cuda(words: torch.Tensor, n: int, q: torch.Tensor, max_multiple: torch.Tensor,
                      ratio_hi: torch.Tensor):
    """The uniform sampler's bulk pass on the card: (S, W) stream words ->
    (values (S, k, n), rejections (S, k) int32).  Word j*n + c of stream s
    goes to (s, j, c), reduced mod q_j; words >= max_multiple[j] (unsigned)
    are counted."""
    k = q.numel()
    _check_words("uniform_bulk_cuda", words, k * n)
    _check_limbs("uniform_bulk_cuda", words, q, max_multiple, ratio_hi)
    S, W = words.shape
    if n < 1 or S >= 1 << 16 or k >= 1 << 16 or n >= 1 << 30:
        raise ValueError(f"uniform_bulk_cuda: S={S}, k={k}, n={n} is out of range")
    vals = torch.empty(S, k, n, dtype=torch.int64, device=words.device)
    counts = torch.zeros(S, k, dtype=torch.int32, device=words.device)
    if S == 0:
        return vals, counts
    lib = _lib_d()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.seal_sample_uniform_bulk(words.data_ptr(), W, q.data_ptr(), max_multiple.data_ptr(),
                                          ratio_hi.data_ptr(), vals.data_ptr(), counts.data_ptr(), S, k, n,
                                          stream)
        uniform_bulk_cuda.launches += 1
    cuda_build.check(rc, "uniform_bulk_cuda")
    return vals, counts


def cbd_lifted_cuda(words: torch.Tensor, n: int, q: torch.Tensor, skip_bytes: int) -> torch.Tensor:
    """CBD noise from the stream words on the card, lifted to residues:
    (S, W) -> (S, k, n), 6 bytes per coefficient from ``skip_bytes``."""
    k = q.numel()
    if skip_bytes < 0 or n < 1:
        raise ValueError(f"cbd_lifted_cuda: skip_bytes={skip_bytes}, n={n} is out of range")
    _check_words("cbd_lifted_cuda", words, -(-(skip_bytes + 6 * n) // 8))
    _check_limbs("cbd_lifted_cuda", words, q)
    S, W = words.shape
    if S >= 1 << 16 or n >= 1 << 30:
        raise ValueError(f"cbd_lifted_cuda: S={S}, n={n} is out of range")
    out = torch.empty(S, k, n, dtype=torch.int64, device=words.device)
    if S == 0:
        return out
    lib = _lib_d()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.seal_sample_cbd_lifted(words.data_ptr(), W, skip_bytes, q.data_ptr(), out.data_ptr(), S, k, n,
                                        stream)
        cbd_lifted_cuda.launches += 1
    cuda_build.check(rc, "cbd_lifted_cuda")
    return out


expand_stream_words_cuda.launches = 0
uniform_bulk_cuda.launches = 0
cbd_lifted_cuda.launches = 0

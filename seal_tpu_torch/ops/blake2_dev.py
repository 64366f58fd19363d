"""Device sampling: the BLAKE2xb stream and the RLWE samplers over it.

Port of ``seal_tpu/ops/blake2_dev.py``.  The reference draws every random
polynomial from a counter-mode BLAKE2xb PRNG on the host
(``randomgen.cpp:204-214``, ``util/rlwe.cpp:21-135``).  The construction is
counter-mode: every 4 KiB buffer, and every 64-byte output node inside it,
is an independent BLAKE2b compression, so the expansion runs on the
tensor's device and only the 64-byte seeds travel there.

A u64 is one ``torch.int64`` holding the same 64 bits (ROADMAP ground rule
"Number format").  Additions wrap in two's complement, as int64 addition
does on the CPU's vector units and on the card; a right rotation masks the
arithmetic shift, ``(x >> c) & (2^(64-c) - 1)``; the rejection tests
compare unsigned (``u64._ge``) and a word of 2^63 or more is reduced with
``u64.barrett_reduce_64``, never ``torch.remainder``.

* ``expand_stream_words``: the raw stream of S seeds, byte-identical to
  ``Blake2xbPRNG.generate`` (little-endian words, node-major); kernel C
  (``csrc/blake2xb.cu``) on the card.
* ``uniform_from_seed_words``: ``sample_poly_uniform`` (rlwe.cpp:104) with
  its per-limb sequential rejection redraws.  The bulk pass (compare,
  count, reduce) is kernel D's first entry point on the card; the fix-up,
  which runs only for a limb where a word was rejected, stays plain
  PyTorch on every device: the m-th rejected bulk position takes the m-th
  acceptable word of the stream's continuation, and limb j+1's window
  starts where limb j's redraws stopped.
* ``cbd_noise_from_words`` and ``lift_signed``: ``sample_poly_cbd``
  (rlwe.cpp:66) in its popcount form, and the lift to residues;
  ``cbd_lifted`` is both at once, kernel D's second entry point on the
  card.

Each public function dispatches as ``ops/ntt.py:forward`` does: under
``ntt.use_kernels(x)`` it launches the kernel (``ops/cuda_blake2.py``),
elsewhere (the CPU, or inside ``ntt.plain_on_card()``) it runs the plain
version.  Nothing falls back.  A tail window that runs dry (odds about
2^-1000 for the provisioned windows) is reported as ``overflow``; the
callers (``rlwe.py``, ``keygen.py``) then draw the same bytes on the host.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import torch

from ..ntt_tables import u64_tensor
from . import u64 as U
from .cuda_blake2 import cbd_lifted_cuda, expand_stream_words_cuda, uniform_bulk_cuda
from .ntt import use_kernels

_M64 = (1 << 64) - 1

_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
]

_BUFFER = 4096            # bytes per counter block (Blake2xbPRNG buffer)
_WORDS_PER_BUFFER = 512   # u64 words


def _s64(value: int) -> int:
    """A u64 bit pattern as the int64 that holds it."""
    value &= _M64
    return value - (1 << 64) if value >> 63 else value


def _rotr(x: torch.Tensor, c: int) -> torch.Tensor:
    return ((x >> c) & ((1 << (64 - c)) - 1)) | (x << (64 - c))


def _g(a, b, c, d, x, y):
    """BLAKE2b's G on four columns at once (rows of (4, ...) tensors)."""
    a = a + b + x
    d = _rotr(d ^ a, 32)
    c = c + d
    b = _rotr(b ^ c, 24)
    a = a + b + y
    d = _rotr(d ^ a, 16)
    c = c + d
    b = _rotr(b ^ c, 63)
    return a, b, c, d


def _compress(h: torch.Tensor, m: torch.Tensor, t0: int, last: bool) -> torch.Tensor:
    """BLAKE2b compression F(h, m, t=(t0, 0), last) over every lane.

    ``h``: (8, ...) state words; ``m``: (16, ...) message words, both
    broadcastable to one lane shape.  cf. native/blake2.c:b2b_compress (RFC
    7693 §3.2).  The state is held as (16, ...) rows so each round is two
    G steps over four columns: the column step on rows (0-3, 4-7, 8-11,
    12-15), the diagonal step with rows 4-7, 8-11 and 12-15 rotated by one,
    two and three.
    """
    lanes = torch.broadcast_shapes(h.shape[1:], m.shape[1:])
    iv = list(_IV)
    iv[4] ^= t0
    if last:
        iv[6] ^= _M64
    tail = torch.tensor([_s64(w) for w in iv], dtype=torch.int64, device=h.device)
    tail = tail.view(8, *([1] * len(lanes))).expand(8, *lanes)
    a, b = h.expand(8, *lanes)[:4], h.expand(8, *lanes)[4:]
    c, d = tail[:4], tail[4:]
    for s in _SIGMA:
        a, b, c, d = _g(a, b, c, d, m[s[0:8:2]], m[s[1:8:2]])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, m[s[8:16:2]], m[s[9:16:2]])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return h ^ torch.cat([a, b]) ^ torch.cat([c, d])


def _root_param_h0() -> List[int]:
    """h init for the xb root hash: digest 64, key 64, fanout 1, depth 1,
    xof_length = 4096 (native/blake2.c:176-192)."""
    pb = [0] * 8
    pb[0] = 64 | (64 << 8) | (1 << 16) | (1 << 24)
    pb[1] = _BUFFER << 32  # node_offset 0 | xof_length 4096
    return [_IV[i] ^ pb[i] for i in range(8)]


def _node_param_h0() -> List[int]:
    """h init for output node 0: digest 64, fanout 0, depth 0, leaf 64,
    node_offset 0, xof_length 4096, inner 64 (native/blake2.c:194-207);
    node j XORs j into word 1."""
    pb = [0] * 8
    pb[0] = 64 | (64 << 32)  # digest_length 64 | leaf_length 64 (bytes 4-7)
    pb[1] = _BUFFER << 32    # node_offset (low 32) | xof_length
    pb[2] = 64 << 8          # node_depth 0 | inner_length 64
    return [_IV[i] ^ pb[i] for i in range(8)]


def _const(words: Sequence[int], device, ndim: int) -> torch.Tensor:
    t = torch.tensor([_s64(w) for w in words], dtype=torch.int64, device=device)
    return t.view(len(words), *([1] * ndim))


def expand_stream_words_plain(seed_words: torch.Tensor, nwords: int, chunk_buffers: int = 256) -> torch.Tensor:
    """The BLAKE2xb counter-mode stream of S seeds in plain PyTorch.

    ``seed_words``: (S, 8) int64, the 512-bit PRNG seeds.  Returns (S,
    nwords) int64, byte-identical (little-endian words) to
    ``Blake2xbPRNG(seed).generate(8 * nwords)`` for each seed.  Buffers are
    expanded ``chunk_buffers`` at a time, which bounds the memory.
    """
    S = seed_words.shape[0]
    dev = seed_words.device
    nbuf = -(-nwords // _WORDS_PER_BUFFER)
    # the key block: shared by every buffer of a stream (t = 128, not final)
    zeros8 = torch.zeros(8, 1, dtype=torch.int64, device=dev).expand(8, S)
    m_key = torch.cat([seed_words.t(), zeros8])
    hk = _compress(_const(_root_param_h0(), dev, 1), m_key, 128, False)         # (8, S)
    node_h = _const(_node_param_h0(), dev, 3).repeat(1, 1, 1, 64)               # (8, 1, 1, 64)
    node_h[1] ^= torch.arange(64, dtype=torch.int64, device=dev)
    chunks = []
    for first in range(0, nbuf, chunk_buffers):
        C = min(chunk_buffers, nbuf - first)
        # root per (S, C): m[0] = the buffer counter, the rest zero; t = 136, final
        counters = torch.arange(first, first + C, dtype=torch.int64, device=dev)
        m_root = torch.cat([counters.view(1, 1, C).expand(1, S, C),
                            torch.zeros(15, 1, 1, dtype=torch.int64, device=dev).expand(15, S, C)])
        root = _compress(hk[:, :, None], m_root, 136, True)                     # (8, S, C)
        # output nodes over (S, C, 64): m = root || zeros, t = 64, final
        m_node = torch.cat([root[..., None], torch.zeros(8, S, C, 1, dtype=torch.int64, device=dev)])
        out = _compress(node_h, m_node, 64, True)                               # (8, S, C, 64)
        chunks.append(out.permute(1, 2, 3, 0).reshape(S, C * _WORDS_PER_BUFFER))
    words = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)
    return words[:, :nwords].contiguous()


def expand_stream_words(seed_words: torch.Tensor, nwords: int, chunk_buffers: int = 256) -> torch.Tensor:
    """The BLAKE2xb stream of S seeds, (S, 8) -> (S, nwords): kernel C on the
    card, the plain version elsewhere (``chunk_buffers`` bounds its memory)."""
    if use_kernels(seed_words):
        return expand_stream_words_cuda(seed_words, nwords)
    return expand_stream_words_plain(seed_words, nwords, chunk_buffers)


# ---------------------------------------------------------------------------
# Samplers over the stream
# ---------------------------------------------------------------------------

def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def uniform_reject_prob(q: int) -> float:
    """Exact per-word rejection probability of sample_poly_uniform.

    Words >= max_multiple = 2^64 - (2^64-1 mod q) - 1 are rejected, i.e.
    (2^64-1 mod q) + 2 values.  Moduli from the reference's prime search sit
    just below a power of two, so this is ~2^-20 or smaller.
    """
    return float((_M64 % q) + 2) / 2.0 ** 64


def uniform_tail_words(n: int, moduli: Sequence[int]) -> Tuple[list, int]:
    """Per-limb rejection-tail window sizes and the total tail provision.

    Each window is sized so that exhausting it (a binomial tail beyond ~12
    sigma, plus slack) has astronomically small odds; an overflow is
    flagged regardless.
    """
    tjs = []
    for q in moduli:
        mean = n * uniform_reject_prob(q)
        tjs.append(_pow2ceil(int(2 * mean + 12 * math.sqrt(mean + 1) + 64)))
    return tjs, sum(tjs)


@functools.lru_cache(maxsize=64)
def uniform_constants(moduli: Tuple[int, ...], device: torch.device):
    """(q, max_multiple, floor(2^128/q) >> 64) per limb, each (k,) int64."""
    mm = [_M64 - (_M64 % q) - 1 for q in moduli]
    rhi = [((1 << 128) // q) >> 64 for q in moduli]
    return u64_tensor(list(moduli), device), u64_tensor(mm, device), u64_tensor(rhi, device)


def uniform_bulk_plain(words: torch.Tensor, n: int, moduli: Sequence[int]):
    """The bulk pass over the first k*n words of each stream, (S, W) ->
    (values (S, k, n), rejections (S, k) int32): every word reduced mod its
    limb's q, and the words >= max_multiple counted per (seed, limb)."""
    k = len(moduli)
    S = words.shape[0]
    q, mm, rhi = uniform_constants(tuple(moduli), words.device)
    bulk = words[:, : k * n].reshape(S, k, n)
    bad = U._ge(bulk, mm[:, None])
    vals = U.barrett_reduce_64(bulk, q[:, None], rhi[:, None])
    return vals, bad.sum(dim=2, dtype=torch.int32)


def uniform_bulk(words: torch.Tensor, n: int, moduli: Sequence[int]):
    """The bulk pass: kernel D's first entry point on the card, the plain
    version elsewhere."""
    if use_kernels(words):
        q, mm, rhi = uniform_constants(tuple(moduli), words.device)
        return uniform_bulk_cuda(words, n, q, mm, rhi)
    return uniform_bulk_plain(words, n, moduli)


def _fixup(wj, tail, offset, mm, t_per: int, T: int):
    """The sequential redraws of one limb over all S streams (plain
    PyTorch, ``seal_tpu/ops/blake2_dev.py:323-354``).  Returns (the raw
    replacement words where the bulk word was rejected, else the bulk
    words; words consumed; overflow), all (S, ...)."""
    S = wj.shape[0]
    dev = wj.device
    ar = torch.arange(t_per, dtype=torch.int64, device=dev)
    bad = U._ge(wj, mm)
    nbad = bad.sum(dim=1)
    rank = torch.cumsum(bad, dim=1)
    off_c = torch.clamp(offset, max=T - t_per)
    w = torch.gather(tail, 1, off_c[:, None] + ar[None, :])
    good = ~U._ge(w, mm)
    cg = torch.cumsum(good, dim=1)
    ngood = cg[:, -1]
    # compaction: m[r] = index of the (r+1)-th acceptable tail word, via a
    # permutation scatter
    dest = torch.where(good, cg - 1, ngood[:, None] + (ar[None, :] - cg))
    m = torch.zeros(S, t_per, dtype=torch.int64, device=dev).scatter_(1, dest, ar.expand(S, t_per))
    idx_c = torch.gather(m, 1, torch.clamp(rank - 1, 0, t_per - 1))
    vals = torch.where(bad, torch.gather(w, 1, idx_c), wj)
    last_idx = torch.gather(m, 1, torch.clamp(nbad - 1, 0, t_per - 1)[:, None])[:, 0]
    consumed = torch.where(nbad > 0, torch.clamp(last_idx, max=t_per - 1) + 1, torch.zeros_like(nbad))
    over = (nbad > ngood) | ((offset + consumed > T - t_per) & (nbad > 0)) | (offset > T - t_per)
    return vals, consumed, over


def uniform_from_seed_words(seed_words: torch.Tensor, n: int, moduli: Sequence[int],
                            chunk_buffers: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_poly_uniform`` for S seeds: (S, 8) -> (values (S, k, n) in
    [0, q_i), overflow (S,) bool).

    Byte-exact with rlwe.cpp:104-135 and ``random/sampler.py``: a bulk fill
    of k*n words, then per-limb sequential redraws from the stream's
    continuation.  The rejection counts come back to the host once; the
    fix-up runs only for a limb where some stream rejected a word (as the
    JAX package's ``lax.cond`` does, over every stream at once), and
    chains each stream's window offset from limb to limb.  ``overflow``
    flags a stream whose tail window ran dry: its values are then not the
    reference's, and the caller must draw it on the host.
    """
    S = seed_words.shape[0]
    k = len(moduli)
    tjs, T = uniform_tail_words(n, moduli)
    words = expand_stream_words(seed_words, k * n + T, chunk_buffers)
    vals, counts = uniform_bulk(words, n, moduli)
    overflow = torch.zeros(S, dtype=torch.bool, device=words.device)
    limbs = torch.nonzero(counts.cpu().any(dim=0)).flatten().tolist()        # one read-back
    if not limbs:
        return vals, overflow
    q, mm, rhi = uniform_constants(tuple(moduli), words.device)
    tail = words[:, k * n:]
    offset = torch.zeros(S, dtype=torch.int64, device=words.device)
    for j in limbs:
        # limbs without a rejection consume nothing and keep their bulk values
        t_per = tjs[j]
        raw, consumed, over = _fixup(words[:, j * n:(j + 1) * n], tail, offset, mm[j], t_per, T)
        vals[:, j] = U.barrett_reduce_64(raw, q[j], rhi[j])
        overflow |= over
        offset = offset + consumed
    return vals, overflow


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., W) u64 words -> (..., 8*W) int64 byte values (little-endian)."""
    parts = [(words >> (8 * i)) & 0xFF for i in range(8)]
    return torch.stack(parts, dim=-1).reshape(*words.shape[:-1], -1)


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 8*W) int64 byte values -> (..., W) u64 words (little-endian)."""
    b = b.reshape(*b.shape[:-1], -1, 8)
    out = b[..., 0].clone()
    for i in range(1, 8):
        out |= b[..., i] << (8 * i)
    return out


_CBD_MASK = (0xFF, 0xFF, 0x1F, 0xFF, 0xFF, 0x1F)


def _popcount8(v: torch.Tensor) -> torch.Tensor:
    """Popcount of byte values."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def cbd_noise_from_words(words: torch.Tensor, n: int, skip_bytes: int = 0) -> torch.Tensor:
    """``sample_poly_cbd``: (..., W) stream words -> (..., n) int64 noise.

    Byte-exact with rlwe.cpp:66-103: 6 bytes per coefficient from
    ``skip_bytes`` into the stream, the top 3 bits of bytes 2 and 5
    masked, noise = popcount(first 3 bytes) - popcount(last 3 bytes).
    """
    b = words_to_bytes(words)[..., skip_bytes: skip_bytes + 6 * n]
    b = b.reshape(*b.shape[:-1], n, 6)
    mask = torch.tensor(_CBD_MASK, dtype=torch.int64, device=words.device)
    pc = _popcount8(b & mask)
    return pc[..., :3].sum(dim=-1) - pc[..., 3:].sum(dim=-1)


def lift_signed(vals: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """(..., n) signed values -> (..., k, n) residues, negatives as q_i - |v|
    (``random/sampler.py:_replicate_signed``)."""
    q = u64_tensor([[v] for v in moduli], vals.device)             # (k, 1)
    v = vals[..., None, :]
    return torch.where(v < 0, q + v, v).expand(*vals.shape[:-1], len(moduli), vals.shape[-1]).contiguous()


def cbd_lifted_plain(words: torch.Tensor, n: int, moduli: Sequence[int], skip_bytes: int = 0) -> torch.Tensor:
    """``lift_signed(cbd_noise_from_words(...))``: (S, W) -> (S, k, n)."""
    return lift_signed(cbd_noise_from_words(words, n, skip_bytes), moduli)


def cbd_lifted(words: torch.Tensor, n: int, moduli: Sequence[int], skip_bytes: int = 0) -> torch.Tensor:
    """CBD noise lifted to residues, (S, W) -> (S, k, n): kernel D's second
    entry point on the card, the plain version elsewhere."""
    if use_kernels(words):
        q, _, _ = uniform_constants(tuple(moduli), words.device)
        return cbd_lifted_cuda(words, n, q, skip_bytes)
    return cbd_lifted_plain(words, n, moduli, skip_bytes)

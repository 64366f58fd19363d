"""Negacyclic NTT table generation (host) and the device table bundle.

Port of ``seal_tpu/ntt_tables.py`` (host counterpart of the reference's
``NTTTables``, ``util/ntt.cpp:241-300``): powers of the minimal primitive
2n-th root psi stored so that each butterfly stage reads a contiguous slice —

  * forward table: slot ``j`` holds ``psi^bitrev(j, log_n)``; stage ``s``
    (with ``m = 2^s`` blocks) reads slots ``[m, 2m)``.
  * inverse table: slot ``bitrev(i-1, log_n) + 1`` holds ``psi^-i``; stages
    read slots sequentially from 1 (sizes n/2, n/4, ..., 1), with ``1/n``
    fused into the last stage.

Each twiddle carries a Shoup quotient ``floor(w << 64 / q)``.  ``LimbTables``
packs the tables of a whole RNS modulus vector into int64 tensors, one per
u64 array (the JAX package splits each into uint32 lo/hi words).  A Shoup
quotient or Barrett word can reach 2^64 - 1: it is stored as the int64 with
the same bits, which is what CUDA code reads as ``uint64_t``.

``FourStepTables`` is the counterpart of the JAX package's ``MXUTables``:
the same factorization of the length-n transform into an n1-point matrix
stage, a twiddle and an n2-point matrix stage, with the same matrices, but
stored as u64 values (the card multiplies 64-bit integers natively) rather
than as int8 digit planes.  Beside each matrix it keeps the Shoup root table
of the butterflies that compute the same sub-transform, which the card's
stage kernel runs.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import numth
from .modulus import Modulus

_MASK64 = (1 << 64) - 1
_HOST_NTT_CACHE = {}


def cached_host_ntt_tables(log_n: int, modulus: Modulus) -> "HostNTTTables":
    """Shared cache: tables depend only on (log_n, q), reused across levels."""
    key = (log_n, modulus.value)
    if key not in _HOST_NTT_CACHE:
        _HOST_NTT_CACHE[key] = HostNTTTables(log_n, modulus)
    return _HOST_NTT_CACHE[key]


class HostNTTTables:
    """Exact-integer NTT tables for one (log_n, q) pair."""

    def __init__(self, log_n: int, modulus: Modulus):
        if not (0 <= log_n <= 17):
            raise ValueError("log_n out of range")
        self.log_n = log_n
        self.n = 1 << log_n
        self.modulus = modulus
        q = modulus.value
        self.root = numth.minimal_primitive_root(2 * self.n, q)
        self.inv_root = numth.invert_mod(self.root, q)

        n, psi, ipsi = self.n, self.root, self.inv_root
        fwd = [1] * n
        power = psi
        for i in range(1, n):
            fwd[numth.reverse_bits(i, log_n)] = power
            power = power * psi % q
        self.root_powers = fwd
        inv = [1] * n
        power = ipsi
        for i in range(1, n):
            inv[numth.reverse_bits(i - 1, log_n) + 1] = power
            power = power * ipsi % q
        self.inv_root_powers = inv
        self.inv_degree = numth.invert_mod(n, q)
        # Last inverse stage fuses 1/n: the y-output root is scaled by 1/n.
        self.scaled_last_inv_root = self.inv_root_powers[n - 1] * self.inv_degree % q if n > 1 else self.inv_degree


def _shoup(operand: int, q: int) -> int:
    return ((operand << 64) // q) & _MASK64


_HOST_C_NTT_CACHE: dict = {}


def host_c_ntt_tables(log_n: int, modulus: Modulus) -> dict:
    """numpy uint64 (op, qt) twiddle arrays and the fused inverse constants
    of the host C NTT (``csrc/ntt_mod.c``), cached per (log_n, q)."""
    key = (log_n, modulus.value)
    t = _HOST_C_NTT_CACHE.get(key)
    if t is None:
        tab = cached_host_ntt_tables(log_n, modulus)
        q = modulus.value

        def pair(vals):
            return np.array(vals, dtype=np.uint64), np.array([_shoup(w, q) for w in vals], dtype=np.uint64)

        fwd_op, fwd_qt = pair(tab.root_powers)
        inv_op, inv_qt = pair(tab.inv_root_powers)
        t = _HOST_C_NTT_CACHE[key] = {
            "q": q, "fwd_op": fwd_op, "fwd_qt": fwd_qt, "inv_op": inv_op, "inv_qt": inv_qt,
            "invn_op": tab.inv_degree, "invn_qt": _shoup(tab.inv_degree, q),
            "last_op": tab.scaled_last_inv_root, "last_qt": _shoup(tab.scaled_last_inv_root, q),
        }
    return t


def u64_tensor(values, device=None) -> torch.Tensor:
    """Python ints or a numpy uint64 array -> int64 tensor with the same bits."""
    a = np.asarray(values, dtype=np.uint64)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


class LimbTables(NamedTuple):
    """Device NTT + modulus constants for a vector of k moduli.

    Twiddle tables have shape (k, n); per-limb constants have shape (k, 1)
    so they broadcast over the coefficient axis.  All int64.
    """

    fwd_op: torch.Tensor
    fwd_qt: torch.Tensor
    inv_op: torch.Tensor
    inv_qt: torch.Tensor
    invn_op: torch.Tensor        # 1/n (times inv_scale), (k, 1)
    invn_qt: torch.Tensor
    invn_last_op: torch.Tensor   # last inverse root / n (times inv_scale)
    invn_last_qt: torch.Tensor
    q: torch.Tensor
    two_q: torch.Tensor
    ratio_lo: torch.Tensor       # floor(2^128/q) low u64
    ratio_hi: torch.Tensor       # floor(2^128/q) high u64
    log_n: int = 0
    moduli_values: tuple = ()
    # per-limb scalar folded into the inverse transform's 1/n constants
    inv_scale: tuple = ()
    # the four-step constants of these limbs, built at first use
    four_step: "FourStepSlot | None" = None

    N_ARRAY_FIELDS = 12  # fields before the metadata tail

    @property
    def device(self) -> torch.device:
        return self.q.device


def build_limb_tables(
    log_n: int,
    moduli: Sequence[Modulus],
    host_tables: "Sequence[HostNTTTables] | None" = None,
    inv_scale: "Sequence[int] | None" = None,
    device=None,
) -> LimbTables:
    """Build the device bundle for a modulus vector.

    ``inv_scale`` (per-limb ints) folds an extra scalar into the inverse
    transform's fused 1/n stage, as ``seal_tpu.ntt_tables.build_limb_tables``
    does.
    """
    if host_tables is None:
        host_tables = [cached_host_ntt_tables(log_n, m) for m in moduli]
    k = len(moduli)
    if inv_scale is None:
        inv_scale = [1] * k

    fwd_op, fwd_qt, inv_op, inv_qt = [], [], [], []
    invn, invn_qt, last, last_qt = [], [], [], []
    for mod, tab, s in zip(moduli, host_tables, inv_scale):
        q = mod.value
        fwd_op.append(tab.root_powers)
        fwd_qt.append([_shoup(w, q) for w in tab.root_powers])
        inv_op.append(tab.inv_root_powers)
        inv_qt.append([_shoup(w, q) for w in tab.inv_root_powers])
        s %= q
        invn.append([tab.inv_degree * s % q])
        invn_qt.append([_shoup(tab.inv_degree * s % q, q)])
        last.append([tab.scaled_last_inv_root * s % q])
        last_qt.append([_shoup(tab.scaled_last_inv_root * s % q, q)])

    qv = [[m.value] for m in moduli]
    ratio = [m.const_ratio for m in moduli]
    arrays = (
        fwd_op, fwd_qt, inv_op, inv_qt, invn, invn_qt, last, last_qt,
        qv, [[2 * v] for (v,) in qv],
        [[r & _MASK64] for r in ratio], [[r >> 64] for r in ratio],
    )
    return LimbTables(
        *(u64_tensor(a, device) for a in arrays),
        log_n=log_n,
        moduli_values=tuple(m.value for m in moduli),
        inv_scale=tuple(int(s) for s in inv_scale),
        four_step=FourStepSlot(),
    )


# ---------------------------------------------------------------------------
# Four-step tables (port of seal_tpu/ntt_tables.py:317-487)
# ---------------------------------------------------------------------------

class FourStepTables(NamedTuple):
    """Constants of the four-step negacyclic NTT for a vector of k moduli.

    With the coefficients laid out as an (n1, n2) matrix ``d[r, c] =
    x[r * n2 + c]``, the forward transform is

        h[t1, c]   = (sum_r W[t1, r] d[r, c]) * T[t1, c]      (stage A)
        out[t1, t2] = sum_c F[t2, c] h[t1, c]                  (stage B)

    and equals the Harvey butterflies' bit-reversed output.  The inverse
    runs Finv (1/n2 folded in) with the twiddle Ti, then Winv (1/n1 and
    ``inv_scale`` folded in).  Matrices are (k, M, K) int64 holding u64
    values below q; twiddles are (k, n) in the (t1, c) layout, with Shoup
    quotients; per-limb constants are (k, 1).

    Each matrix is a butterfly transform, and ``<name>_roots`` (k, 2, M)
    holds its Shoup root table: operands in ``[:, 0]``, quotients in
    ``[:, 1]``.  W is the n1-point negacyclic NTT with root eta = psi^n2 and
    F the n2-point cyclic NTT with root zeta = psi^(2 n1), both in the
    bit-reversed output order of Cooley-Tukey butterflies on natural input:
    stage s (2^s blocks) reads slots [2^s, 2^(s+1)), as kernel A's forward
    table.  Winv and Finv are their Gentleman-Sande inverses, bit-reversed
    input to natural output: stage s (M / 2^(s+1) blocks) reads slots from
    1 + M - M / 2^s, each the inverse of the forward root of the same block;
    slot 0, which no stage reads, holds the scale (1/n1 times
    ``inv_scale``, or 1/n2), and the last stage's one slot, M - 1, holds its
    root times that scale, as kernel A's last inverse stage fuses 1/n.
    """

    w: torch.Tensor          # (k, n1, n1): W[t1, r]
    f: torch.Tensor          # (k, n2, n2): F[t2, c]
    winv: torch.Tensor       # (k, n1, n1): Winv[r, t1]
    finv: torch.Tensor       # (k, n2, n2): Finv[c, t2]
    tw_op: torch.Tensor      # (k, n): T[t1, c] = alpha_t1^c
    tw_qt: torch.Tensor
    twi_op: torch.Tensor     # (k, n): alpha_t1^-c
    twi_qt: torch.Tensor
    q: torch.Tensor          # (k, 1)
    ratio_lo: torch.Tensor
    ratio_hi: torch.Tensor
    w_roots: torch.Tensor    # (k, 2, n1)
    f_roots: torch.Tensor    # (k, 2, n2)
    winv_roots: torch.Tensor  # (k, 2, n1)
    finv_roots: torch.Tensor  # (k, 2, n2)
    n1: int = 0
    n2: int = 0
    log_n: int = 0
    moduli_values: tuple = ()
    inv_scale: tuple = ()


_FOUR_STEP_ARRAY_FIELDS = 15  # fields before the metadata tail


def default_split(log_n: int) -> int:
    """The JAX package's factorization rule (``ntt_tables.py:389-399``): n2
    is the larger factor up to 128, then doubled while n1 exceeds 512."""
    n = 1 << log_n
    n2 = min(128, 1 << ((log_n + 1) // 2))
    while n // n2 > 512:
        n2 *= 2
    return n2


_FOUR_STEP_HOST_CACHE = {}


def _forward_roots(log_m: int, root: int, q: int, negacyclic: bool) -> List[int]:
    """Slot 2^s + b: the root of block b at stage s of Cooley-Tukey
    butterflies, natural input, bit-reversed output.  Negacyclic (``root`` a
    primitive 2M-th root): root^brv(2^s + b), kernel A's layout.  Cyclic
    (``root`` a primitive M-th root): root^(brv_s(b) M / 2^(s+1)), the same
    network without the negacyclic factor root^(M / 2^(s+1))."""
    m_size = 1 << log_m
    out = [1] * m_size
    for s in range(log_m):
        for b in range(1 << s):
            if negacyclic:
                e = numth.reverse_bits((1 << s) + b, log_m)
            else:
                e = numth.reverse_bits(b, s) * (m_size >> (s + 1))
            out[(1 << s) + b] = pow(root, e, q)
    return out


def _inverse_roots(fwd: List[int], log_m: int, scale: int, q: int) -> List[int]:
    """The Gentleman-Sande table of the transform whose forward table is
    ``fwd``: stage s (M / 2^(s+1) blocks) reads slots from 1 + M - M / 2^s,
    each the inverse of the forward root of the same block; slot 0 holds
    ``scale`` and the last stage's slot M - 1 its root times ``scale``."""
    m_size = 1 << log_m
    out = [0] * m_size
    out[0] = scale
    for s in range(log_m):
        blocks = m_size >> (s + 1)
        offset = 1 + m_size - (m_size >> s)
        for b in range(blocks):
            out[offset + b] = numth.invert_mod(fwd[blocks + b], q)
    if log_m:
        out[m_size - 1] = out[m_size - 1] * scale % q
    return out


def _shoup_pair(values: List[int], q: int) -> List[List[int]]:
    return [values, [_shoup(v, q) for v in values]]


def _four_step_host(log_n: int, q: int, n2: int, inv_scale: int):
    """Per-modulus matrices and twiddles as Python-int lists (cached)."""
    key = (log_n, q, n2, inv_scale % q)
    hit = _FOUR_STEP_HOST_CACHE.get(key)
    if hit is not None:
        return hit
    n = 1 << log_n
    n1 = n // n2
    ln1, ln2 = n1.bit_length() - 1, n2.bit_length() - 1
    psi = cached_host_ntt_tables(log_n, Modulus(q)).root
    eta = pow(psi, n2, q)          # primitive 2*n1-th root
    zeta = pow(psi, 2 * n1, q)     # primitive n2-th root of unity
    inv_n1 = numth.invert_mod(n1, q) * (inv_scale % q) % q
    inv_n2 = numth.invert_mod(n2, q)

    def powers(base: int, start: int, count: int) -> List[int]:
        out = [0] * count
        acc = start
        for i in range(count):
            out[i] = acc
            acc = acc * base % q
        return out

    W, Winv_t, T, Ti = [], [], [], []
    for t1 in range(n1):
        e = 2 * numth.reverse_bits(t1, ln1) + 1
        w = pow(eta, e, q)
        alpha = pow(psi, e, q)
        W.append(powers(w, 1, n1))
        Winv_t.append(powers(numth.invert_mod(w, q), inv_n1, n1))   # row t1 of Winv^T
        T.extend(powers(alpha, 1, n2))
        Ti.extend(powers(numth.invert_mod(alpha, q), 1, n2))
    F, Finv_t = [], []
    for t2 in range(n2):
        z = pow(zeta, numth.reverse_bits(t2, ln2), q)
        F.append(powers(z, 1, n2))
        Finv_t.append(powers(numth.invert_mod(z, q), inv_n2, n2))  # row t2 of Finv^T
    Winv = [list(col) for col in zip(*Winv_t)]
    Finv = [list(col) for col in zip(*Finv_t)]
    w_fwd = _forward_roots(ln1, eta, q, negacyclic=True)
    f_fwd = _forward_roots(ln2, zeta, q, negacyclic=False)
    roots = (_shoup_pair(w_fwd, q), _shoup_pair(f_fwd, q),
             _shoup_pair(_inverse_roots(w_fwd, ln1, inv_n1, q), q),
             _shoup_pair(_inverse_roots(f_fwd, ln2, inv_n2, q), q))
    hit = (W, F, Winv, Finv, T, [_shoup(a, q) for a in T], Ti, [_shoup(a, q) for a in Ti], roots)
    _FOUR_STEP_HOST_CACHE[key] = hit
    return hit


def build_four_step_tables(
    log_n: int,
    moduli: Sequence[Modulus],
    n2: "int | None" = None,
    inv_scale: "Sequence[int] | None" = None,
    device=None,
) -> FourStepTables:
    """Four-step constants for a modulus vector, on ``device``.

    ``n2`` defaults to the JAX package's rule (:func:`default_split`);
    ``inv_scale`` folds a per-limb scalar into the inverse's last matrix, as
    ``build_limb_tables`` folds it into the last butterfly stage.
    """
    n = 1 << log_n
    if n2 is None:
        n2 = default_split(log_n)
    n1 = n // n2
    if n1 < 2 or n2 < 2 or n1 * n2 != n:
        raise ValueError(f"four-step NTT needs n = n1 * n2 with n1, n2 >= 2, got n={n}, n2={n2}")
    k = len(moduli)
    if inv_scale is None:
        inv_scale = [1] * k
    per_limb = [_four_step_host(log_n, m.value, n2, int(s)) for m, s in zip(moduli, inv_scale)]
    fields = [u64_tensor([limb[i] for limb in per_limb], device) for i in range(8)]
    ratio = [m.const_ratio for m in moduli]
    roots = [u64_tensor([limb[8][i] for limb in per_limb], device) for i in range(4)]
    return FourStepTables(
        *fields,
        q=u64_tensor([[m.value] for m in moduli], device),
        ratio_lo=u64_tensor([[r & _MASK64] for r in ratio], device),
        ratio_hi=u64_tensor([[r >> 64] for r in ratio], device),
        w_roots=roots[0], f_roots=roots[1], winv_roots=roots[2], finv_roots=roots[3],
        n1=n1, n2=n2, log_n=log_n,
        moduli_values=tuple(m.value for m in moduli),
        inv_scale=tuple(int(s) for s in inv_scale),
    )


class FourStepSlot:
    """The four-step constants of one :class:`LimbTables` bundle, built at
    first use and kept by the bundle, so they live and die with it.  A
    bundle cut from another (``ops/rns.slice_limbs``, ``take_limbs``) gets a
    slot that names its parent bundle and limb rows: it selects its
    constants from the parent's, which are built once."""

    __slots__ = ("tables", "parent", "rows")

    def __init__(self, parent: "LimbTables | None" = None, rows=None):
        self.tables: "FourStepTables | None" = None
        self.parent = parent
        self.rows = rows          # a slice or a list of the parent's limbs


def four_step_tables_for(t: LimbTables) -> FourStepTables:
    """The four-step constants of a butterfly table bundle, built once per
    bundle, as the JAX package's ``ops/ntt.py:_mxu_tables_for`` builds them
    once per modulus vector."""
    slot = t.four_step
    if slot.tables is not None:
        return slot.tables
    if slot.parent is not None:
        whole = four_step_tables_for(slot.parent)
        rows = slot.rows          # a slice gives views, a list copies
        ids = range(len(whole.moduli_values))[rows] if isinstance(rows, slice) else rows
        ft = FourStepTables(
            *(a[rows] for a in whole[:_FOUR_STEP_ARRAY_FIELDS]),
            n1=whole.n1, n2=whole.n2, log_n=whole.log_n,
            moduli_values=tuple(whole.moduli_values[i] for i in ids),
            inv_scale=tuple(whole.inv_scale[i] for i in ids),
        )
    else:
        ft = build_four_step_tables(t.log_n, [Modulus(v) for v in t.moduli_values],
                                    inv_scale=t.inv_scale or None, device=t.device)
    slot.tables = ft
    return ft

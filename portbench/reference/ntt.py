"""The negacyclic NTT in Microsoft SEAL's order, from the primes alone.

For a prime q = 1 mod 2n, psi is the smallest primitive 2n-th root of unity
(``NTTTables``).  The forward transform is SEAL's Cooley-Tukey loop
(``util/dwthandler.h`` ``transform_to_rev``) over the powers of psi stored
at bit-reversed indices; the inverse is its Gentleman-Sande loop
(``transform_from_rev``) over the powers of psi^-1, then a multiply by n^-1.
Each stage is one vectorised butterfly over every row and limb.  Outputs
are fully reduced, so any exact transform gives the same words.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .arith import addmod, col, minimal_primitive_root, mulmod, submod


def bit_reverse(log_n: int, device) -> torch.Tensor:
    i = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(log_n):
        r |= ((i >> b) & 1) << (log_n - 1 - b)
    return r


def _powers(root: torch.Tensor, q: torch.Tensor, n: int) -> torch.Tensor:
    """(k, n): root^0 .. root^(n-1) per limb, by doubling."""
    table = torch.ones_like(root)
    step = root
    while table.shape[-1] < n:
        table = torch.cat([table, mulmod(table, step, q)], dim=-1)
        step = mulmod(step, step, q)
    return table


class Tables:
    """NTT tables of one list of primes at degree n, on one device."""

    def __init__(self, primes: Sequence[int], n: int, device):
        self.primes = [int(p) for p in primes]
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = device
        self.q = col(self.primes, device)                                   # (k, 1)
        psi = [minimal_primitive_root(2 * n, p) for p in self.primes]
        psi_inv = [pow(r, -1, p) for r, p in zip(psi, self.primes)]
        self.inv_n = col([pow(n, -1, p) for p in self.primes], device)
        rev = bit_reverse(self.log_n, device)
        # root_powers[rev(i)] = psi^i
        fwd = torch.empty(len(self.primes), n, dtype=torch.int64, device=device)
        fwd[:, rev] = _powers(col(psi, device), self.q, n)
        self.fwd = fwd
        # inv_root_powers[rev(i - 1) + 1] = psi^-i for i >= 1
        inv_pows = _powers(col(psi_inv, device), self.q, n)                 # psi^-i, i in [0, n)
        inv = torch.ones(len(self.primes), n, dtype=torch.int64, device=device)
        inv[:, rev[: n - 1] + 1] = inv_pows[:, 1:]
        self.inv = inv

    def rows(self, lo: int, hi: int) -> "Tables":
        """The tables of primes [lo, hi)."""
        t = object.__new__(Tables)
        t.primes, t.n, t.log_n, t.device = self.primes[lo:hi], self.n, self.log_n, self.device
        t.q, t.inv_n, t.fwd, t.inv = self.q[lo:hi], self.inv_n[lo:hi], self.fwd[lo:hi], self.inv[lo:hi]
        return t

    def pick(self, index: Sequence[int]) -> "Tables":
        """The tables of the primes at ``index``, in that order."""
        idx = torch.tensor(list(index), dtype=torch.int64, device=self.device)
        t = object.__new__(Tables)
        t.primes, t.n, t.log_n, t.device = [self.primes[i] for i in index], self.n, self.log_n, self.device
        t.q, t.inv_n, t.fwd, t.inv = self.q[idx], self.inv_n[idx], self.fwd[idx], self.inv[idx]
        return t


def forward(x: torch.Tensor, t: Tables) -> torch.Tensor:
    """(..., k, n) coefficients in [0, q) -> NTT form in [0, q)."""
    n, k = t.n, len(t.primes)
    lead = x.shape[:-2]
    q = t.q.reshape(k, 1, 1)
    m = 1
    while m < n:
        gap = n // (2 * m)
        y = x.reshape(*lead, k, m, 2, gap)
        r = t.fwd[:, m:2 * m].reshape(k, m, 1)
        u, v = y[..., 0, :], mulmod(y[..., 1, :], r, q)
        x = torch.stack([addmod(u, v, q), submod(u, v, q)], dim=-2).reshape(*lead, k, n)
        m *= 2
    return x


def inverse(x: torch.Tensor, t: Tables) -> torch.Tensor:
    """(..., k, n) NTT form in [0, q) -> coefficients in [0, q)."""
    n, k = t.n, len(t.primes)
    lead = x.shape[:-2]
    q = t.q.reshape(k, 1, 1)
    m, used = n // 2, 1
    while m >= 1:
        gap = n // (2 * m)
        y = x.reshape(*lead, k, m, 2, gap)
        r = t.inv[:, used:used + m].reshape(k, m, 1)
        u, v = y[..., 0, :], y[..., 1, :]
        x = torch.stack([addmod(u, v, q), mulmod(submod(u, v, q), r, q)], dim=-2).reshape(*lead, k, n)
        used += m
        m //= 2
    return mulmod(x, t.inv_n, t.q)


def galois_ntt_index(galois_elt: int, log_n: int, device) -> torch.Tensor:
    """The NTT-domain permutation of ``GaloisTool::generate_table_ntt``:
    out[i] = in[index[i]]."""
    n = 1 << log_n
    i = torch.arange(n, 2 * n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(i)
    for b in range(log_n + 1):
        rev |= ((i >> b) & 1) << (log_n - b)
    raw = ((galois_elt * rev) >> 1) & (n - 1)
    out = torch.zeros_like(raw)
    for b in range(log_n):
        out |= ((raw >> b) & 1) << (log_n - 1 - b)
    return out


_CACHE: Dict[Tuple, Tables] = {}


def tables(primes: Sequence[int], n: int, device) -> Tables:
    key = (tuple(int(p) for p in primes), n, str(device))
    if key not in _CACHE:
        _CACHE[key] = Tables(primes, n, device)
    return _CACHE[key]

"""Key switching and the division by the last prime, as Microsoft SEAL
defines them (``evaluator.cpp`` ``switch_key_inplace`` and
``rns.cpp`` ``divide_and_round_q_last_ntt_inplace``), in exact arithmetic.

``rounding=False`` is the control: it divides by flooring instead of
rounding (it drops the ``q_last / 2`` correction), which breaks the
configuration's guarantee that every output word equals SEAL's.
"""

from __future__ import annotations

import torch

from . import ntt as NTT
from .arith import addmod, col, mulmod, reduce, submod


def _centered_mod(last: torch.Tensor, q_last: int, primes, half: int) -> torch.Tensor:
    """(..., 1, n) values in [0, q_last) with ``half`` added mod q_last, as a
    residue of (value + half mod q_last) - half mod each of ``primes``:
    (..., len(primes), n)."""
    dev = last.device
    q = col(primes, dev)
    shifted = addmod(last, torch.full_like(last, half), torch.full_like(last, q_last)) if half else last
    return submod(reduce(shifted, q), reduce(torch.full((len(primes), 1), half, dtype=torch.int64, device=dev), q), q)


def switch_key(target: torch.Tensor, target_ntt: bool, key0: torch.Tensor, key1: torch.Tensor,
               key_primes, n: int, rounding: bool = True) -> torch.Tensor:
    """The two polys to add to a ciphertext's first two when switching the key
    of ``target`` (D, n): data limbs mod key_primes[:D], in NTT form
    (CKKS) or as coefficients (BFV).  ``key0``/``key1``: (D', K, n) NTT-form
    key components over all K key primes, the last one special.  Returns
    (2, D, n) in the target's form."""
    dev = target.device
    D = target.shape[-2]
    K = len(key_primes)
    sel = list(range(D)) + [K - 1]                       # key prime of output row I
    all_t = NTT.tables(key_primes, n, dev)
    data_t = all_t.rows(0, D)
    sel_t = all_t.pick(sel)
    coeff = NTT.inverse(target, data_t) if target_ntt else target
    q_sel = col([key_primes[i] for i in sel], dev)        # (D + 1, 1)
    # decomposition: row J reduced mod every output prime, to NTT form
    dec = NTT.forward(reduce(coeff[:, None, :].expand(D, D + 1, n), q_sel), sel_t)    # (D, D + 1, n)
    out = []
    special = key_primes[K - 1]
    half = special >> 1 if rounding else 0
    inv_special = col([pow(special, -1, key_primes[j]) for j in range(D)], dev)
    q_data = q_sel[:D]
    for key in (key0, key1):
        acc = torch.zeros(D + 1, n, dtype=torch.int64, device=dev)
        for j in range(D):
            acc = addmod(acc, mulmod(dec[j], key[j, sel], q_sel), q_sel)
        last = NTT.inverse(acc[D:], all_t.rows(K - 1, K))                            # (1, n)
        fix = _centered_mod(last, special, key_primes[:D], half)                      # (D, n) coefficients
        body = acc[:D]
        if target_ntt:
            fix = NTT.forward(fix, data_t)
        else:
            body = NTT.inverse(body, data_t)
        out.append(mulmod(submod(body, fix, q_data), inv_special, q_data))
    return torch.stack(out)


def divide_round_last_ntt(data: torch.Tensor, primes, n: int, rounding: bool = True) -> torch.Tensor:
    """(size, k, n) NTT form over primes[:k] -> (size, k - 1, n): divided by
    the last prime with rounding (CKKS rescale)."""
    dev = data.device
    k = data.shape[-2]
    t = NTT.tables(primes[:k], n, dev)
    q_last = primes[k - 1]
    half = q_last >> 1 if rounding else 0
    q = t.q[: k - 1]
    inv_last = col([pow(q_last, -1, p) for p in primes[: k - 1]], dev)
    last = NTT.inverse(data[..., k - 1:, :], t.rows(k - 1, k))                       # (size, 1, n)
    fix = NTT.forward(_centered_mod(last, q_last, primes[: k - 1], half), t.rows(0, k - 1))
    return mulmod(submod(data[..., : k - 1, :], fix, q), inv_last, q)

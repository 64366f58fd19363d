"""The plain reference of a mix's program: the evaluator's operations on
one ciphertext at a time, in exact arithmetic, from the configuration's
primes and the benchmark's own inputs.

It imports nothing of the program under test.  A ciphertext is a
:class:`Ct`: (size, k, n) int64 words mod the first k data primes, its
form, its scale and its correction factor (BGV's; 1 in the other
schemes), as Microsoft SEAL keeps them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from . import behz
from . import ntt as NTT
from .arith import addmod, col, mulmod
from .keyswitch import divide_round_last_ntt, switch_key


@dataclass
class Ct:
    data: torch.Tensor          # (size, k, n)
    ntt_form: bool
    scale: float = 1.0
    correction_factor: int = 1


@dataclass
class Plain:
    data: torch.Tensor          # (k, n), NTT form
    scale: float = 1.0


@dataclass
class Key:
    data: torch.Tensor          # (2, D, K, n), NTT form


def galois_elt_from_step(step: int, n: int) -> int:
    """``GaloisTool::get_elt_from_step``: 3^step mod 2n over the n/2 slots
    of a row (step 0: the column swap 2n - 1)."""
    if step == 0:
        return 2 * n - 1
    row = n // 2
    if abs(step) >= row:
        raise ValueError("step count too large")
    e = row - abs(step) if step < 0 else step
    return pow(3, e, 2 * n)


def galois_elts_all(n: int) -> list:
    """``GaloisTool::get_elts_all``: the elements of the Galois keys that
    ``KeyGenerator::create_galois_keys()`` makes by default, the column swap
    2n - 1 and 3^(2^i) and 3^(-2^i) mod 2n for i < log2(n) - 1."""
    m = 2 * n
    pos, neg = 3, pow(3, -1, m)
    out = [m - 1]
    for _ in range(n.bit_length() - 2):
        out += [pos, neg]
        pos, neg = pos * pos % m, neg * neg % m
    return out


class Reference:
    """The evaluator's operations over one configuration."""

    def __init__(self, config: dict, device, rounding: bool = True):
        self.scheme = config["scheme"]
        self.n = int(config["poly_modulus_degree"])
        self.data_primes = [int(p) for p in config["coeff_modulus"]]
        self.key_primes = self.data_primes + [int(config["special_prime"])]
        self.t = int(config.get("plain_modulus") or 0)
        self.device = device
        self.rounding = rounding

    def _q(self, k: int) -> torch.Tensor:
        return col(self.data_primes[:k], self.device)

    def _switch(self, target: torch.Tensor, ntt_form: bool, key: Key) -> torch.Tensor:
        return switch_key(target, ntt_form, key.data[0], key.data[1], self.key_primes, self.n, self.rounding)

    # ---- operations (the evaluator's method names) ----------------------
    def multiply_plain(self, ct: Ct, plain: Plain) -> Ct:
        if not ct.ntt_form:
            raise NotImplementedError("the reference multiplies plaintexts in NTT form only")
        k = ct.data.shape[-2]
        return Ct(mulmod(ct.data, plain.data[:k], self._q(k)), True, ct.scale * plain.scale)

    def multiply(self, a: Ct, b: Ct) -> Ct:
        if a.data.shape[0] != 2 or b.data.shape[0] != 2:
            raise NotImplementedError("the reference multiplies size-2 ciphertexts")
        k = a.data.shape[-2]
        if self.scheme == "bfv":
            return Ct(behz.multiply(a.data, b.data, self.data_primes, self.n, self.t), False)
        q = self._q(k)
        x, y = a.data, b.data
        data = torch.stack([mulmod(x[0], y[0], q), addmod(mulmod(x[0], y[1], q), mulmod(x[1], y[0], q), q),
                            mulmod(x[1], y[1], q)])
        return Ct(data, True, a.scale * b.scale)

    def relinearize(self, ct: Ct, relin_keys: Key) -> Ct:
        if ct.data.shape[0] != 3:
            raise NotImplementedError("the reference relinearizes size-3 ciphertexts")
        k = ct.data.shape[-2]
        ks = self._switch(ct.data[2], ct.ntt_form, relin_keys)
        q = self._q(k)
        return Ct(addmod(ct.data[:2], ks, q), ct.ntt_form, ct.scale)

    def rescale_to_next(self, ct: Ct) -> Ct:
        k = ct.data.shape[-2]
        data = divide_round_last_ntt(ct.data, self.data_primes, self.n, self.rounding)
        return Ct(data, True, ct.scale / self.data_primes[k - 1])

    def rotate_vector(self, ct: Ct, steps: int, galois_keys: Dict[int, Key]) -> Ct:
        if self.scheme != "ckks" or ct.data.shape[0] != 2:
            raise NotImplementedError("the reference rotates size-2 CKKS ciphertexts")
        elt = galois_elt_from_step(steps, self.n)
        k = ct.data.shape[-2]
        g = ct.data[..., NTT.galois_ntt_index(elt, self.n.bit_length() - 1, self.device)]
        ks = self._switch(g[1], True, galois_keys[elt])
        return Ct(torch.stack([addmod(g[0], ks[0], self._q(k)), ks[1]]), True, ct.scale)

    def op(self, name: str) -> Callable:
        if name.startswith("_") or not hasattr(self, name):
            raise NotImplementedError(f"the reference has no operation {name}")
        return getattr(self, name)

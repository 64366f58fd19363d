"""The benchmark's inputs, made on the device from the run's seed.

Every input is a tensor of uniform residues: word [..., i, j] of a stream is
the splitmix64 output (Steele, Lea and Flood, 2014) at that position,
reduced mod the i-th prime.  This is the generator of
``seal_tpu_torch/golden.py`` (``splitmix64``, ``_residues``), frozen here and
computed in int64 with wrapping arithmetic so that it runs on the card in a
few large calls.  Under RLWE a ciphertext or a key-switching key is
indistinguishable from uniform residues, and the evaluator does the same
work on either.

Each input has a stream of its own, seeded by a 64-bit hash of the run's
seed and the input's label, so one seed gives the same inputs everywhere.
A client's key set is one stream, made in chunks; any one of its keys can
be made alone from its offset in the stream.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import torch

_U64 = 1 << 64


def _signed(v: int) -> int:
    return v - _U64 if v >= 1 << 63 else v


_GAMMA = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the u64 bits held in int64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(seed: int, count: int, device, start: int = 0) -> torch.Tensor:
    """Outputs ``start`` .. ``start + count - 1`` of splitmix64 started at
    ``seed``, as the int64 tensor with the same bits."""
    z = torch.arange(start + 1, start + count + 1, dtype=torch.int64, device=device) * _GAMMA + _signed(seed % _U64)
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def umod(z: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """The u64 held in ``z`` (..., k, n) mod moduli[i] along the limb axis."""
    q = torch.tensor([int(m) for m in moduli], dtype=torch.int64, device=z.device).reshape(-1, 1)
    top = torch.tensor([(1 << 63) % int(m) for m in moduli], dtype=torch.int64, device=z.device).reshape(-1, 1)
    low = torch.remainder(z & ((1 << 63) - 1), q)
    return torch.remainder(low + (z < 0).long() * top, q)


def residues(seed: int, moduli: Sequence[int], lead: Tuple[int, ...], n: int, device,
             start: int = 0) -> torch.Tensor:
    """(*lead, k, n) int64, element [..., i, :] uniform mod moduli[i], from
    output ``start`` of the stream on."""
    k = len(moduli)
    count = k * n
    for d in lead:
        count *= d
    return umod(splitmix64(seed, count, device, start).reshape(*lead, k, n), moduli)


def stream_seed(seed: int, label: str) -> int:
    """The 64-bit seed of input ``label`` in a run seeded with ``seed``."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}/{label}".encode()).digest()[:8], "little")


class Inputs:
    """The inputs of one cell and seed: each client's request ciphertexts
    and key-switching keys, and a plaintext every client shares, all at the
    first level of the configuration's chain.  The program and the
    reference each call this for their own copy."""

    # the most words one chunk of a key set takes, so that making a client's
    # keys needs little memory beyond the keys themselves
    CHUNK_WORDS = 1 << 25

    def __init__(self, config: dict, seed: int, device):
        self.seed = int(seed)
        self.n = int(config["poly_modulus_degree"])
        self.data_primes = [int(p) for p in config["coeff_modulus"]]
        self.key_primes = self.data_primes + [int(config["special_prime"])]
        self.device = device

    def ciphertexts(self, name: str, client: int, count: int) -> torch.Tensor:
        """(count, 2, k, n): request input ``name`` of each of the ``count``
        requests that client ``client`` sends in one call."""
        return residues(stream_seed(self.seed, f"{name}/{client}"), self.data_primes, (count, 2), self.n, self.device)

    def plaintext(self, name: str) -> torch.Tensor:
        """(k, n) NTT-form plaintext data."""
        return residues(stream_seed(self.seed, name), self.data_primes, (), self.n, self.device)

    def _key_shape(self) -> Tuple[Tuple[int, int], int]:
        D = len(self.data_primes)
        return (2, D), 2 * D * len(self.key_primes) * self.n

    def key_set(self, name: str, client: int, count: int) -> torch.Tensor:
        """(count, 2, D, K, n): client ``client``'s ``count`` keys of the set
        ``name``, each a key-switching key's two components over the D data
        primes' decomposition rows and the K key primes."""
        lead, words = self._key_shape()
        out = torch.empty((count, *lead, len(self.key_primes), self.n), dtype=torch.int64, device=self.device)
        step = max(1, self.CHUNK_WORDS // words)
        seed = stream_seed(self.seed, f"{name}/{client}")
        for j in range(0, count, step):
            m = min(step, count - j)
            out[j:j + m] = residues(seed, self.key_primes, (m, *lead), self.n, self.device, start=j * words)
        return out

    def key(self, name: str, client: int, index: int) -> torch.Tensor:
        """(2, D, K, n): key ``index`` of ``key_set(name, client, ...)``, made alone."""
        lead, words = self._key_shape()
        seed = stream_seed(self.seed, f"{name}/{client}")
        return residues(seed, self.key_primes, lead, self.n, self.device, start=index * words)

"""Carry state across from the JAX package, as numpy uint64 arrays.

The JAX package holds a u64 array as a (lo, hi) pair of uint32 arrays;
``seal_tpu.ops.u64.to_np_u64`` joins it into one numpy uint64 array, and
the functions here turn such arrays into the port's objects and back.  A
seed (the ``seed_info`` of a seeded ciphertext, each of a key's ``seeds``)
travels as its settings, a (PRNG type, 8 seed words) pair, or as any object
with ``prng_type`` and ``seed`` attributes, such as the JAX package's
``UniformRandomGeneratorInfo``.  The port itself never imports the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import Ciphertext, GaloisKeys, KSwitchKeys, Plaintext, PublicKey, RelinKeys, SecretKey
from .ntt_tables import u64_tensor
from .params import ParmsId
from .random import PRNGType, UniformRandomGeneratorFactory, UniformRandomGeneratorInfo


def u64_from_numpy(array: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits on ``device``."""
    if np.asarray(array).dtype != np.uint64:
        raise ValueError(f"expected a uint64 array, got {np.asarray(array).dtype}")
    return u64_tensor(array, device)


def u64_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bits."""
    return tensor.detach().cpu().contiguous().numpy().view(np.uint64)


def seed_info_from_settings(seed) -> Optional[UniformRandomGeneratorInfo]:
    """A (PRNG type, seed words) pair, or an object with ``prng_type`` and
    ``seed``, as the port's UniformRandomGeneratorInfo; None stays None."""
    if seed is None:
        return None
    prng_type, words = (seed.prng_type, seed.seed) if hasattr(seed, "seed") else seed
    return UniformRandomGeneratorInfo(PRNGType(int(prng_type)), tuple(int(w) for w in words))


def ciphertext_from_numpy(data: np.ndarray, parms_id: ParmsId, is_ntt_form: bool, scale: float,
                          device, correction_factor: int = 1, seed_info=None) -> Ciphertext:
    """(size, k, n) uint64 data plus metadata -> Ciphertext on ``device``;
    ``seed_info`` (see :func:`seed_info_from_settings`) for a seeded one."""
    if np.ndim(data) != 3:
        raise ValueError("ciphertext data must have shape (size, k, n)")
    ct = Ciphertext(u64_from_numpy(data, device), tuple(parms_id), bool(is_ntt_form),
                    float(scale), int(correction_factor))
    ct.seed_info = seed_info_from_settings(seed_info)
    return ct


def ciphertext_to_numpy(ct: Ciphertext) -> Tuple[np.ndarray, ParmsId, bool, float, int]:
    """The inverse of :func:`ciphertext_from_numpy`: (data, parms_id,
    is_ntt_form, scale, correction_factor)."""
    return u64_to_numpy(ct.data), ct.parms_id, ct.is_ntt_form, ct.scale, ct.correction_factor


KeyList = List[Optional[Tuple[np.ndarray, np.ndarray]]]


def _kswitch_keys_from_numpy(out: KSwitchKeys, keys: Sequence, parms_id: ParmsId, device) -> KSwitchKeys:
    out.parms_id = tuple(parms_id)
    for entry in keys:
        if entry is None:
            out.keys.append(None)
            continue
        c0, c1, *seeds = entry
        if np.shape(c0) != np.shape(c1) or np.ndim(c0) != 3:
            raise ValueError("key components must both have shape (D, k_key, n)")
        seeds = seeds[0] if seeds else None
        out.keys.append({"c0": u64_from_numpy(c0, device), "c1": u64_from_numpy(c1, device),
                         "seeds": None if seeds is None else [seed_info_from_settings(x) for x in seeds]})
    return out


def _kswitch_keys_to_numpy(keys: KSwitchKeys) -> Tuple[KeyList, ParmsId]:
    return [None if k is None else (u64_to_numpy(k["c0"]), u64_to_numpy(k["c1"])) for k in keys.keys], keys.parms_id


def relin_keys_from_numpy(keys: Sequence, parms_id: ParmsId, device) -> RelinKeys:
    """Per key power (index = power - 2): None or (c0, c1), each (D, k_key,
    n), or (c0, c1, seeds) with one seed per row for a seeded key."""
    return _kswitch_keys_from_numpy(RelinKeys(), keys, parms_id, device)


def relin_keys_to_numpy(rk: RelinKeys) -> Tuple[KeyList, ParmsId]:
    return _kswitch_keys_to_numpy(rk)


def galois_keys_from_numpy(keys: Sequence, parms_id: ParmsId, device) -> GaloisKeys:
    """Per Galois element (index = (elt - 1) / 2, n entries as the wire
    format has them): None, (c0, c1) or (c0, c1, seeds), as for
    :func:`relin_keys_from_numpy`."""
    return _kswitch_keys_from_numpy(GaloisKeys(), keys, parms_id, device)


def galois_keys_to_numpy(gk: GaloisKeys) -> Tuple[KeyList, ParmsId]:
    return _kswitch_keys_to_numpy(gk)


def secret_key_from_numpy(data: np.ndarray, parms_id: ParmsId, device) -> SecretKey:
    """(k_key, n) uint64 NTT-form secret -> SecretKey on ``device``."""
    if np.ndim(data) != 2:
        raise ValueError("secret key data must have shape (k_key, n)")
    return SecretKey(u64_from_numpy(data, device), tuple(parms_id))


def secret_key_to_numpy(sk: SecretKey) -> Tuple[np.ndarray, ParmsId]:
    return u64_to_numpy(sk.data), sk.parms_id


def public_key_from_numpy(data: np.ndarray, parms_id: ParmsId, device) -> PublicKey:
    """(2, k_key, n) uint64 NTT-form encryption of zero -> PublicKey."""
    return PublicKey(ciphertext_from_numpy(data, parms_id, True, 1.0, device))


def public_key_to_numpy(pk: PublicKey) -> Tuple[np.ndarray, ParmsId]:
    return u64_to_numpy(pk.data.data), pk.parms_id


def plaintext_from_numpy(data: np.ndarray, parms_id: ParmsId, scale: float, device) -> Plaintext:
    """(k, n) uint64 NTT-form RNS plaintext plus its level and scale."""
    if np.ndim(data) != 2:
        raise ValueError("plaintext data must have shape (k, n)")
    p = Plaintext()
    p.parms_id = tuple(parms_id)
    p.scale = float(scale)
    p.rns_data = u64_from_numpy(data, device)
    return p


def plaintext_to_numpy(p: Plaintext) -> Tuple[np.ndarray, ParmsId, float]:
    return u64_to_numpy(p.rns_data), p.parms_id, p.scale


def factory_to_settings(factory: UniformRandomGeneratorFactory) -> Tuple[int, Optional[Tuple[int, ...]]]:
    """A PRNG factory's (type, default seed); the JAX package's factory has
    the same two attributes."""
    return int(factory.prng_type), factory.default_seed


def factory_from_settings(prng_type: int, default_seed: Optional[Sequence[int]]) -> UniformRandomGeneratorFactory:
    return UniformRandomGeneratorFactory(PRNGType(int(prng_type)),
                                         None if default_seed is None else tuple(int(s) for s in default_seed))

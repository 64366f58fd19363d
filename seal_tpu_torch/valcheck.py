"""Validity checks of data objects against a context.

Port of ``seal_tpu/valcheck.py`` (counterpart of ``valcheck.{h,cpp}``), in
layers: metadata (the level is in the context; sizes, levels and NTT flags
agree), then data bounds (every coefficient below its modulus).  The
untrusted-load path (``serialization.py``) runs the metadata check before it
builds a tensor; the data check runs on the tensor's device and reads one
flag back.

The port holds u64 residues as int64 tensors, so a residue of 2^63 or more
reads as negative: the bound check rejects a negative value as well as one
at or above its modulus, which is the JAX package's unsigned comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import Ciphertext, Plaintext, PublicKey, SecretKey
from .modulus import CIPHERTEXT_SIZE_MAX, CIPHERTEXT_SIZE_MIN
from .ops.rns import _c


def is_metadata_valid_ct(context, parms_id, size, degree, k, allow_key_level=False) -> bool:
    """cf. ``is_metadata_valid_for(Ciphertext)`` (valcheck.cpp)."""
    cd = context.get_context_data(parms_id)
    if cd is None:
        return False
    if not allow_key_level and parms_id == context.key_parms_id and context.using_keyswitching:
        return False
    parms = cd.parms
    return (degree == parms.poly_modulus_degree and k == len(parms.coeff_modulus)
            and CIPHERTEXT_SIZE_MIN <= size <= CIPHERTEXT_SIZE_MAX)


def is_metadata_valid_for(obj, context, allow_pure_key_levels: bool = False) -> bool:
    if isinstance(obj, Ciphertext):
        if obj.data is None:
            return False
        return is_metadata_valid_ct(context, obj.parms_id, obj.size, obj.poly_modulus_degree,
                                    obj.coeff_modulus_size, allow_pure_key_levels)
    if isinstance(obj, Plaintext):
        if obj.is_ntt_form:
            cd = context.get_context_data(obj.parms_id)
            if cd is None:
                return False
            shape = (len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree)
            return obj.rns_data is not None and tuple(obj.rns_data.shape) == shape
        return len(obj.coeff_data) <= context.first_context_data().parms.poly_modulus_degree
    if isinstance(obj, SecretKey):
        return obj.parms_id == context.key_parms_id and obj.data is not None
    if isinstance(obj, PublicKey):
        ct = obj.data
        return (ct.parms_id == context.key_parms_id and ct.is_ntt_form
                and is_metadata_valid_ct(context, ct.parms_id, ct.size, ct.poly_modulus_degree,
                                         ct.coeff_modulus_size, allow_key_level=True))
    return False


def _residues_below(data: torch.Tensor, moduli) -> bool:
    """Every residue of (..., k, n) ``data`` lies in [0, q_i) as a u64; one
    comparison on the tensor's device, one flag read back.  Data with
    another number of limbs is not valid."""
    if data.shape[-2] != len(moduli):
        return False
    q = _c(moduli, data.device)                          # (k, 1)
    return not bool(((data < 0) | (data >= q)).any())


def is_data_valid_for(obj, context) -> bool:
    """Coefficient bounds (the untrusted-load path)."""
    if isinstance(obj, Ciphertext):
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        data = obj.data.unshard() if hasattr(obj.data, "unshard") else obj.data
        return _residues_below(data, cd.coeff_modulus_values)
    if isinstance(obj, Plaintext):
        if obj.is_ntt_form:
            cd = context.get_context_data(obj.parms_id)
            if cd is None:
                return False
            return _residues_below(obj.rns_data, cd.coeff_modulus_values)
        t = context.first_context_data().parms.plain_modulus.value
        return t == 0 or not (np.asarray(obj.coeff_data, dtype=np.uint64) >= np.uint64(t)).any()
    return True


def is_valid_for(obj, context) -> bool:
    return is_metadata_valid_for(obj, context) and is_data_valid_for(obj, context)

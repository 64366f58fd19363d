"""Ciphertexts and key-switching keys.

Port of the server-side containers of ``seal_tpu/data.py`` (counterparts of
``ciphertext.h`` / ``kswitchkeys.h`` / ``relinkeys.h``): a ciphertext is one
int64 tensor of shape (size, k, n), layout [poly][rns_limb][coeff] as in
``ciphertext.h:728-742``, plus host metadata; key-switching keys are
stacked over the decomposition axis, each component (D, k_key, n).
Plaintexts and the secret and public keys arrive with the client slice.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .params import ParmsId, PARMS_ID_ZERO


class Ciphertext:
    """RNS ciphertext: int64 (size, k, n) + metadata (cf. ``ciphertext.h``)."""

    def __init__(
        self,
        data: Optional[torch.Tensor] = None,
        parms_id: ParmsId = PARMS_ID_ZERO,
        is_ntt_form: bool = False,
        scale: float = 1.0,
        correction_factor: int = 1,
    ):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self.correction_factor = correction_factor

    @property
    def size(self) -> int:
        return 0 if self.data is None else int(self.data.shape[0])

    def poly(self, j: int) -> torch.Tensor:
        return self.data[j]

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale, self.correction_factor)

    def is_transparent(self) -> bool:
        """True if every poly beyond c0 is zero (cf. ``ciphertext.h:451``).

        Reads one flag back from the device, which waits for the data.
        """
        if self.size < 2:
            return True
        return not bool(torch.any(self.data[1:] != 0))


class KSwitchKeys:
    """Key-switching keys, stacked for the contraction.

    ``keys[index]`` is None or a dict with 'c0', 'c1': int64 tensors of
    shape (num_decomp, k_key, n), the two components of each
    decomposition-limb encryption, NTT form (cf. ``kswitchkeys.h:340``).
    """

    def __init__(self):
        self.parms_id: ParmsId = PARMS_ID_ZERO
        self.keys: List[Optional[dict]] = []


class RelinKeys(KSwitchKeys):
    """Relinearization keys: index = key_power - 2 (``relinkeys.h:58``)."""

    @staticmethod
    def get_index(key_power: int) -> int:
        if key_power < 2:
            raise ValueError("key_power cannot be less than 2")
        return key_power - 2

    def has_key(self, key_power: int) -> bool:
        i = self.get_index(key_power)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, key_power: int) -> dict:
        return self.keys[self.get_index(key_power)]

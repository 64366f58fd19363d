"""Evaluator: the CKKS server path (multiply, relinearize, rescale).

Port of the CKKS part of ``seal_tpu/evaluator.py`` (counterpart of
``evaluator.{h,cpp}``).  Ring arithmetic runs on the context's device;
metadata (levels, scales) is tracked on the host.  Ciphertexts are
immutable: every op returns a new Ciphertext.  There is no jit cache: the
ops run eagerly, and the constants each level needs are built once and
kept in ``self._plans``.

The ring bodies (the convolution and the key switch) live in
``ckks_bodies.py``, their mesh versions in ``parallel/sharded.py``.  On the
card the two NTT sites and the key-switch contraction launch the
hand-written kernels (``ops/cuda_ntt.py``, ``ops/cuda_switch_key.py``);
the convolution, the key-switch tail and the rescale's subtract-and-scale
are elementwise mod-q arithmetic in plain PyTorch.  Inside
``ops.ntt.plain_on_card()`` the plain PyTorch versions run on the card as
well, to check the kernels.

BFV and BGV, rotations and the rest of the evaluator surface raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import torch

from .ckks_bodies import KeySwitchPlan, convolve, key_switch_contract, key_switch_tail
from .context import ContextData, SealContext
from .data import Ciphertext, KSwitchKeys, RelinKeys
from .params import SchemeType, not_ported
from .parallel import sharded
from .parallel.mesh import ShardedTensor, shard, shard_kswitch_key
from .ops import rns as R


def are_same_scale(scale1: float, scale2: float) -> bool:
    """Reference semantics (``util::are_close``, common.h:574-578 via
    ``are_same_scale``, evaluator.cpp:23-27): machine-epsilon-relative
    closeness."""
    scale_factor = max(abs(scale1), abs(scale2), 1.0)
    return abs(scale1 - scale2) < sys.float_info.epsilon * scale_factor


def _is_scale_within_bounds(scale: float, cd: ContextData) -> bool:
    """Mirrors the reference's is_scale_within_bounds (evaluator.cpp:29-48):
    scale must be a positive *normal* double below the modulus bit bound."""
    scheme = cd.parms.scheme
    scale_bit_count_bound = -1
    if scheme == SchemeType.BFV or scheme == SchemeType.BGV:
        scale_bit_count_bound = cd.parms.plain_modulus.bit_count
    elif scheme == SchemeType.CKKS:
        scale_bit_count_bound = cd.total_coeff_modulus_bit_count
    if scale <= 0 or not math.isfinite(scale) or scale < sys.float_info.min:
        return False
    return not (math.floor(math.log2(scale)) >= scale_bit_count_bound)


class Evaluator:
    def __init__(self, context: SealContext, mesh=None):
        """``mesh`` (an ``HEMesh``, ``parallel/mesh.py``) makes the evaluator
        mesh-aware: ciphertexts and keys placed with :meth:`shard` and
        :meth:`shard_keys` have their RNS limbs split over the mesh's limb
        axis, and the ops then run on every rank's limbs, with the
        key-switch sum and the rescale's last limb exchanged between the
        ranks (``parallel/sharded.py``).  Without a mesh, or on tensors that
        are not sharded, the ops run on one device; both give the same bits.
        """
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self.hem = mesh
        self._plans: Dict[tuple, KeySwitchPlan] = {}

    # ------------------------------------------------------------------
    # mesh placement (no-ops without a mesh)
    # ------------------------------------------------------------------
    def shard(self, ct: Ciphertext) -> Ciphertext:
        """Place a ciphertext's RNS limbs over the mesh's limb axis."""
        if self.hem is None:
            return ct
        out = ct.copy()
        out.data = shard(self.hem.mesh, ct.data, self.hem.ct_spec())
        return out

    def shard_keys(self, keys: KSwitchKeys) -> KSwitchKeys:
        """Place key-switch keys (decomposition axis) over the mesh's limb
        axis, or on every rank with ``replicate_keys``, once, ahead of the
        op stream."""
        if self.hem is None:
            return keys
        out = type(keys)()
        out.parms_id = keys.parms_id
        out.keys = [None if entry is None else shard_kswitch_key(self.hem, entry) for entry in keys.keys]
        return out

    # ------------------------------------------------------------------
    # validation helpers
    # ------------------------------------------------------------------
    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        if ct.size < 2:
            raise ValueError("ciphertext is empty or invalid")
        if not isinstance(ct.data, ShardedTensor) and ct.data.device != self.context.device:
            raise ValueError(f"ciphertext lies on {ct.data.device}, the context on {self.context.device}")
        return cd

    @staticmethod
    def _check_transparent(ct: Ciphertext):
        """The reference's SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT default (ON);
        reads one flag back from the device."""
        if ct.is_transparent():
            raise ValueError("result ciphertext is transparent")

    # ------------------------------------------------------------------
    # multiply
    # ------------------------------------------------------------------
    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        if ct1.parms_id != ct2.parms_id:
            raise ValueError("encrypted1 and encrypted2 parameter mismatch")
        scheme = self.context.first_context_data().parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        out = self._ckks_multiply(ct1, ct2)
        self._check_transparent(out)
        return out

    def _ckks_multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        if not (ct1.is_ntt_form and ct2.is_ntt_form):
            raise ValueError("encrypted1 and encrypted2 must be in NTT form")
        cd = self._cd(ct1)
        self._cd(ct2)
        out = ct1.copy()
        if isinstance(ct1.data, ShardedTensor) or isinstance(ct2.data, ShardedTensor):
            out.data = sharded.multiply(self._plan, cd, ct1.data, ct2.data)
        else:
            out.data = convolve(ct1.data, ct2.data, cd.limb_tables())
        out.scale = ct1.scale * ct2.scale
        if not _is_scale_within_bounds(out.scale, cd):
            raise ValueError("scale out of bounds")
        return out

    # ------------------------------------------------------------------
    # key switching core (evaluator.cpp:2561-2867)
    # ------------------------------------------------------------------
    def _plan(self, cd: ContextData, device=None) -> KeySwitchPlan:
        device = cd.device if device is None else torch.device(device)
        plan = self._plans.get((cd.parms_id, device))
        if plan is None:
            plan = KeySwitchPlan(self.context, cd, device)
            self._plans[(cd.parms_id, device)] = plan
        return plan

    def _switch_key(self, ct: Ciphertext, target: int, key: dict) -> Ciphertext:
        """Returns polys [0, target) of ct with the key switch of poly
        ``target`` (one RNS polynomial in the ciphertext's domain) added
        into polys 0 and 1."""
        cd = self._cd(ct)
        scheme = cd.parms.scheme
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not ct.is_ntt_form:
            raise ValueError(f"{scheme.name} encrypted must be in NTT form")
        if not self.context.using_keyswitching:
            raise ValueError("keyswitching is not supported by the context")
        D = len(cd.parms.coeff_modulus)
        if key is None or key["c0"].shape[0] < D:
            raise ValueError("key-switching keys are invalid for encryption parameters")
        out = ct.copy()
        if isinstance(ct.data, ShardedTensor):
            out.data = sharded.switch_key(self._plan, cd, ct.data, target, key)
        else:
            out.data = self._switch_key_body(cd, target, ct.data, ct.data[target], key["c0"], key["c1"])
        return out

    def _switch_key_body(self, cd: ContextData, ct_size: int, ct_data: torch.Tensor,
                         target: torch.Tensor, key_c0: torch.Tensor, key_c1: torch.Tensor) -> torch.Tensor:
        if cd.parms.scheme != SchemeType.CKKS:
            raise not_ported(cd.parms.scheme)
        plan = self._plan(cd)
        D = plan.D
        prod = key_switch_contract(plan, target, key_c0[:D], key_c1[:D], 0, D)  # (2, Rn, n) < q_i
        return key_switch_tail(plan, prod, ct_data[..., :ct_size, :, :], 0, D)

    # ------------------------------------------------------------------
    # relinearize
    # ------------------------------------------------------------------
    def relinearize(self, ct: Ciphertext, relin_keys: RelinKeys, destination_size: int = 2) -> Ciphertext:
        if relin_keys.parms_id != self.context.key_parms_id:
            raise ValueError("relin_keys is not valid for encryption parameters")
        if not (2 <= destination_size <= ct.size):
            raise ValueError("destination_size must be in [2, encrypted.size()]")
        if destination_size == ct.size:
            return ct
        out = ct
        for _ in range(ct.size - destination_size):
            # key for secret power = index of the removed polynomial
            if not relin_keys.has_key(out.size - 1):
                raise ValueError("relin_keys is missing required key")
            out = self._switch_key(out, out.size - 1, relin_keys.key(out.size - 1))
        self._check_transparent(out)
        return out

    # ------------------------------------------------------------------
    # rescaling
    # ------------------------------------------------------------------
    def _mod_switch_scale_to_next(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        scheme = cd.parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        if not ct.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        # both the current and the destination scale must stay normal and
        # in bounds (evaluator.cpp:1232-1238)
        if not _is_scale_within_bounds(ct.scale, cd) or not _is_scale_within_bounds(
            ct.scale / cd.coeff_modulus_values[-1], next_cd
        ):
            raise ValueError("scale out of bounds")
        if isinstance(ct.data, ShardedTensor):
            data = sharded.rescale(cd, ct.data)
        else:
            data = R.divide_and_round_q_last_ntt(ct.data, cd.rns_tool, cd.limb_tables())
        return Ciphertext(
            data=data,
            parms_id=next_cd.parms_id,
            is_ntt_form=True,
            scale=ct.scale / cd.coeff_modulus_values[-1],
            correction_factor=ct.correction_factor,
        )

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        scheme = self.context.first_context_data().parms.scheme
        if scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        out = self._mod_switch_scale_to_next(ct)
        self._check_transparent(out)
        return out

"""Batched evaluator over ciphertext batches, on one device or a mesh.

Port of ``seal_tpu/parallel/batch.py``.  A :class:`CiphertextBatch` holds
B ciphertexts with shared metadata as one (B, size, k, n) tensor; the ops
run the evaluator's bodies on the whole batch at once (the JAX package
vmaps them), so one set of kernel launches serves B requests.  On a mesh
(``parallel/mesh.py``) the batch is split over the ``data`` (and ``host``)
axes and the RNS limbs over the ``limb`` axis, and each rank runs the same
bodies on its own ciphertexts and limbs (``parallel/sharded.py``; kernel B
takes the batch on its grid's second axis).

Every result equals the single-device evaluator's bit for bit, for all
three schemes on one device or a mesh (BFV: the BEHZ multiply of
``bfv_bodies.py``, the key switch on coefficient form; BGV: the NTT-domain
convolution, the key switch with BGV's tail, the mod-t switch, one
correction factor per batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from ..ckks_bodies import galois
from ..context import ContextData, SealContext
from ..data import Ciphertext, GaloisKeys, Plaintext, RelinKeys
from ..evaluator import (Evaluator, _is_scale_within_bounds, add_sub_body, add_sub_plain, are_same_scale,
                         bfv_product, bgv_switched_factor, drop_limbs, galois_tables, multiply_plain_normal_body,
                         multiply_tree, ntt_product, plain_term, rotate_by_steps, switch_last_prime)
from ..ops import ntt as NTT
from ..ops import u64 as U
from ..params import ParmsId, SchemeType
from . import sharded
from .mesh import HEMesh, ShardedTensor, shard_batch

Data = Union[torch.Tensor, ShardedTensor]


@dataclass
class CiphertextBatch:
    """B ciphertexts with identical metadata, stacked on a leading axis:
    ``data`` is (B, size, k, n), a tensor or a ShardedTensor."""

    data: Data
    parms_id: ParmsId
    is_ntt_form: bool
    scale: float = 1.0
    correction_factor: int = 1

    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])

    @property
    def size(self) -> int:
        return int(self.data.shape[1])

    @staticmethod
    def from_ciphertexts(cts: Sequence[Ciphertext]) -> "CiphertextBatch":
        c0 = cts[0]
        for c in cts[1:]:
            if c.parms_id != c0.parms_id or c.is_ntt_form != c0.is_ntt_form or c.size != c0.size:
                raise ValueError("all ciphertexts in a batch must share metadata")
        return CiphertextBatch(torch.stack([c.data for c in cts]), c0.parms_id, c0.is_ntt_form, c0.scale,
                               c0.correction_factor)

    def unshard(self) -> "CiphertextBatch":
        """The batch as one tensor on rank 0's device."""
        if not isinstance(self.data, ShardedTensor):
            return self
        return CiphertextBatch(self.data.unshard(), self.parms_id, self.is_ntt_form, self.scale,
                               self.correction_factor)

    def __getitem__(self, i: int) -> Ciphertext:
        return Ciphertext(data=self.unshard().data[i], parms_id=self.parms_id, is_ntt_form=self.is_ntt_form,
                          scale=self.scale, correction_factor=self.correction_factor)


class BatchEvaluator:
    """Evaluator ops over ciphertext batches, on one device or a mesh."""

    def __init__(self, context: SealContext, hem: Optional[HEMesh] = None):
        self.context = context
        self.ev = Evaluator(context, mesh=hem)
        self.hem = hem

    def shard(self, batch: CiphertextBatch) -> CiphertextBatch:
        if self.hem is None:
            return batch
        return CiphertextBatch(shard_batch(self.hem, batch.data), batch.parms_id, batch.is_ntt_form, batch.scale,
                               batch.correction_factor)

    def _cd(self, batch: CiphertextBatch) -> ContextData:
        cd = self.context.get_context_data(batch.parms_id)
        if cd is None:
            raise ValueError("ciphertexts are not valid for encryption parameters")
        return cd

    @staticmethod
    def _check_form(batch: CiphertextBatch, cd: ContextData) -> None:
        """The form a key switch needs (switch_key_inplace, evaluator.cpp:2600-2611)."""
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and batch.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not batch.is_ntt_form:
            raise ValueError(f"{scheme.name} encrypted must be in NTT form")

    def _check_key(self, keys) -> None:
        """Key validity rails mirroring Evaluator._switch_key / relinearize
        (evaluator.cpp:2572-2611)."""
        if keys.parms_id != self.context.key_parms_id:
            raise ValueError("keys are not valid for encryption parameters")
        if not self.context.using_keyswitching:
            raise ValueError("keyswitching is not supported by the context")

    @staticmethod
    def _check_key_limbs(key: dict, cd: ContextData) -> None:
        D = len(cd.parms.coeff_modulus)
        if key is None or key["c0"].shape[0] < D:
            raise ValueError("key-switching keys are invalid for encryption parameters")

    def multiply(self, b1: CiphertextBatch, b2: CiphertextBatch) -> CiphertextBatch:
        if b1.parms_id != b2.parms_id:
            raise ValueError("parameter mismatch")
        cd = self._cd(b1)
        if cd.parms.scheme == SchemeType.BFV:
            if b1.is_ntt_form or b2.is_ntt_form:
                raise ValueError("BFV operands cannot be in NTT form")
            return self._like(b1, bfv_product(cd, b1.data, b2.data))
        if not (b1.is_ntt_form and b2.is_ntt_form):
            raise ValueError(f"{cd.parms.scheme.name} operands must be in NTT form")
        if cd.parms.scheme == SchemeType.BGV:
            factor = b1.correction_factor * b2.correction_factor % cd.parms.plain_modulus.value
            return self._like(b1, ntt_product(self.ev._plan, cd, b1.data, b2.data), correction_factor=factor)
        out_scale = b1.scale * b2.scale
        if not _is_scale_within_bounds(out_scale, cd):
            raise ValueError("scale out of bounds")
        return self._like(b1, ntt_product(self.ev._plan, cd, b1.data, b2.data), scale=out_scale)

    def square(self, batch: CiphertextBatch) -> CiphertextBatch:
        return self.multiply(batch, batch)

    def relinearize(self, batch: CiphertextBatch, relin_keys: RelinKeys) -> CiphertextBatch:
        cd = self._cd(batch)
        self._check_key(relin_keys)
        if batch.size != 3:
            raise ValueError("batched relinearize currently supports size-3 inputs")
        self._check_form(batch, cd)
        key = relin_keys.key(2)
        self._check_key_limbs(key, cd)
        if isinstance(batch.data, ShardedTensor):
            data = sharded.switch_key(self.ev._plan, cd, batch.data, 2, key)
        else:
            data = self.ev._switch_key_body(cd, 2, batch.data, batch.data[:, 2], key["c0"], key["c1"])
        return CiphertextBatch(data, batch.parms_id, batch.is_ntt_form, batch.scale, batch.correction_factor)

    def rescale_to_next(self, batch: CiphertextBatch) -> CiphertextBatch:
        cd = self._cd(batch)
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        if not batch.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        return self._like(batch, switch_last_prime(cd, batch.data), parms_id=next_cd.parms_id,
                          scale=batch.scale / cd.coeff_modulus_values[-1])

    def add(self, b1: CiphertextBatch, b2: CiphertextBatch) -> CiphertextBatch:
        return self._add_sub(b1, b2, True)

    def sub(self, b1: CiphertextBatch, b2: CiphertextBatch) -> CiphertextBatch:
        return self._add_sub(b1, b2, False)

    def _add_sub(self, b1: CiphertextBatch, b2: CiphertextBatch, is_add: bool) -> CiphertextBatch:
        if b1.parms_id != b2.parms_id:
            raise ValueError("parameter mismatch")
        if b1.is_ntt_form != b2.is_ntt_form:
            raise ValueError("NTT form mismatch")
        if not are_same_scale(b1.scale, b2.scale):
            raise ValueError("scale mismatch")
        cd = self._cd(b1)
        factor, body = add_sub_body(cd, b1.correction_factor, b2.correction_factor, is_add)
        return self._like(b1, self.ev._elementwise(cd, b1.data, body, b2.data), correction_factor=factor)

    def negate(self, batch: CiphertextBatch) -> CiphertextBatch:
        cd = self._cd(batch)
        data = self.ev._elementwise(cd, batch.data, lambda x, _, t: U.neg_mod(x, t.q))
        return CiphertextBatch(data, batch.parms_id, batch.is_ntt_form, batch.scale, batch.correction_factor)

    def _like(self, batch: CiphertextBatch, data: Data, **changes) -> CiphertextBatch:
        fields = dict(parms_id=batch.parms_id, is_ntt_form=batch.is_ntt_form, scale=batch.scale,
                      correction_factor=batch.correction_factor)
        fields.update(changes)
        return CiphertextBatch(data, **fields)

    # -- level management --------------------------------------------------
    def mod_switch_to_next(self, batch: CiphertextBatch) -> CiphertextBatch:
        """The evaluator's mod_switch_to_next over the batch: CKKS drops the
        last limb, BFV divides and rounds by it on the coefficients, BGV
        switches it away mod t in the NTT domain (every ciphertext and poly
        of the batch, or of a rank's share of it, in one call)."""
        cd = self._cd(batch)
        if cd.parms.scheme == SchemeType.CKKS:
            return self.mod_reduce_to_next(batch)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        self._check_form(batch, cd)
        factor = batch.correction_factor
        if cd.parms.scheme == SchemeType.BGV:
            factor = bgv_switched_factor(cd, factor)
        return self._like(batch, switch_last_prime(cd, batch.data), parms_id=next_cd.parms_id,
                          correction_factor=factor)

    def mod_reduce_to_next(self, batch: CiphertextBatch) -> CiphertextBatch:
        """Drop the last limb (mod_reduce_to_next, evaluator.cpp:1597-1648)."""
        cd = self._cd(batch)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        if cd.parms.scheme == SchemeType.CKKS and not _is_scale_within_bounds(batch.scale, next_cd):
            raise ValueError("scale out of bounds")
        return self._like(batch, drop_limbs(batch.data, len(next_cd.parms.coeff_modulus)),
                          parms_id=next_cd.parms_id)

    # -- rotations ---------------------------------------------------------
    def apply_galois(self, batch: CiphertextBatch, galois_elt: int, galois_keys: GaloisKeys) -> CiphertextBatch:
        """Galois permutation and key switch over the whole batch: one
        gather, and one launch of kernel B for all of it."""
        cd = self._cd(batch)
        if batch.size != 2:
            raise ValueError("batched apply_galois requires size-2 ciphertexts")
        if not galois_keys.has_key(galois_elt):
            raise ValueError("Galois key not present")
        self._check_key(galois_keys)
        key = galois_keys.key(galois_elt)
        self._check_key_limbs(key, cd)
        self._check_form(batch, cd)
        if isinstance(batch.data, ShardedTensor):
            data = sharded.galois(self.ev._plan, cd, batch.data, galois_elt, key)
        else:
            data = galois(self.ev._plan(cd), batch.data, galois_tables(cd, galois_elt, batch.data.device),
                          key["c0"], key["c1"])
        return self._like(batch, data)

    def _rows_columns_scheme(self):
        if self.context.first_context_data().parms.scheme not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")

    def rotate_rows(self, batch: CiphertextBatch, steps: int, galois_keys: GaloisKeys) -> CiphertextBatch:
        self._rows_columns_scheme()
        return rotate_by_steps(self.apply_galois, self._cd(batch).galois_tool, batch, steps, galois_keys)

    def rotate_columns(self, batch: CiphertextBatch, galois_keys: GaloisKeys) -> CiphertextBatch:
        self._rows_columns_scheme()
        return self.apply_galois(batch, 2 * self._cd(batch).parms.poly_modulus_degree - 1, galois_keys)

    def rotate_vector(self, batch: CiphertextBatch, steps: int, galois_keys: GaloisKeys) -> CiphertextBatch:
        if self.context.first_context_data().parms.scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        return rotate_by_steps(self.apply_galois, self._cd(batch).galois_tool, batch, steps, galois_keys)

    # -- plaintext ops -----------------------------------------------------
    def multiply_plain(self, batch: CiphertextBatch, plain: Plaintext) -> CiphertextBatch:
        """multiply_plain over the batch on all four branches of the
        evaluator's; a plaintext is lifted or transformed once for the batch."""
        self._cd(batch)
        if batch.is_ntt_form and plain.is_ntt_form:
            return self._multiply_plain_ntt(batch, plain)
        if not batch.is_ntt_form and not plain.is_ntt_form:
            cd = self._cd(batch)
            scale = self._plain_scale(batch, plain, cd)
            return self._like(batch, self.ev._limbwise(cd, batch.data, multiply_plain_normal_body(cd, plain)),
                              scale=scale)
        if batch.is_ntt_form:
            return self._multiply_plain_ntt(batch, self.ev.transform_plain_to_ntt(plain, batch.parms_id))
        return self.transform_from_ntt(self._multiply_plain_ntt(self.transform_to_ntt(batch), plain))

    @staticmethod
    def _plain_scale(batch: CiphertextBatch, plain: Plaintext, cd: ContextData) -> float:
        scale = batch.scale * plain.scale
        if not _is_scale_within_bounds(scale, cd):
            raise ValueError("scale out of bounds")
        return scale

    def _multiply_plain_ntt(self, batch: CiphertextBatch, plain: Plaintext) -> CiphertextBatch:
        if batch.parms_id != plain.parms_id:
            raise ValueError("parameter mismatch")
        cd = self._cd(batch)
        scale = self._plain_scale(batch, plain, cd)
        data = self.ev._limbwise(cd, batch.data, lambda x, t, lo, hi: U.mul_mod(
            x, plain.rns_data[lo:hi].to(x.device), t.q, t.ratio_lo, t.ratio_hi))
        return self._like(batch, data, scale=scale)

    def add_plain(self, batch: CiphertextBatch, plain: Plaintext) -> CiphertextBatch:
        return self._add_sub_plain(batch, plain, True)

    def sub_plain(self, batch: CiphertextBatch, plain: Plaintext) -> CiphertextBatch:
        return self._add_sub_plain(batch, plain, False)

    def _add_sub_plain(self, batch: CiphertextBatch, plain: Plaintext, is_add: bool) -> CiphertextBatch:
        cd = self._cd(batch)
        term = plain_term(batch, plain, cd)
        data = self.ev._limbwise(cd, batch.data, lambda x, t, lo, hi: add_sub_plain(
            x, term[lo:hi].to(x.device), t.q, is_add))
        return self._like(batch, data)

    # -- NTT transforms ----------------------------------------------------
    def transform_to_ntt(self, batch: CiphertextBatch) -> CiphertextBatch:
        if batch.is_ntt_form:
            raise ValueError("encrypted is already in NTT form")
        cd = self._cd(batch)
        return self._like(batch, self.ev._limbwise(cd, batch.data, lambda x, t, lo, hi: NTT.forward(x, t)),
                          is_ntt_form=True)

    def transform_from_ntt(self, batch: CiphertextBatch) -> CiphertextBatch:
        if not batch.is_ntt_form:
            raise ValueError("encrypted is not in NTT form")
        cd = self._cd(batch)
        return self._like(batch, self.ev._limbwise(cd, batch.data, lambda x, t, lo, hi: NTT.inverse(x, t)),
                          is_ntt_form=False)

    def multiply_many(self, batches: Sequence[CiphertextBatch], relin_keys: RelinKeys) -> CiphertextBatch:
        """Binary-tree product over batches, relinearizing after each
        multiply (BFV and BGV; evaluator.cpp:1649-1724)."""
        return multiply_tree(self, batches, relin_keys)

"""Batched evaluator over ciphertext batches, on one device or a mesh.

Port of ``seal_tpu/parallel/batch.py``.  A :class:`CiphertextBatch` holds
B ciphertexts with shared metadata as one (B, size, k, n) tensor; the ops
run the evaluator's bodies on the whole batch at once (the JAX package
vmaps them), so one set of kernel launches serves B requests.  On a mesh
(``parallel/mesh.py``) the batch is split over the ``data`` (and ``host``)
axes and the RNS limbs over the ``limb`` axis, and each rank runs the same
bodies on its own ciphertexts and limbs (``parallel/sharded.py``; kernel B
takes the batch on its grid's second axis).

Every result equals the single-device evaluator's bit for bit.  Other
methods raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from ..ckks_bodies import convolve
from ..context import ContextData, SealContext
from ..data import Ciphertext, RelinKeys
from ..evaluator import Evaluator, _is_scale_within_bounds, are_same_scale
from ..ops import rns as R
from ..ops import u64 as U
from ..params import ParmsId, SchemeType, not_ported
from . import sharded
from .mesh import HEMesh, ShardedTensor, shard_batch

Data = Union[torch.Tensor, ShardedTensor]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1, item {item})")


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
        if cd.parms.scheme != SchemeType.CKKS:
            raise not_ported(cd.parms.scheme)
        return cd

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

    def _elementwise(self, cd: ContextData, data: Data, fn, other: Optional[Data] = None) -> Data:
        """fn(x, y, q) on the batch's limbs (y None for a unary op)."""
        if isinstance(data, ShardedTensor) or isinstance(other, ShardedTensor):
            return sharded.elementwise(self.ev._plan, cd, data, fn, other)
        return fn(data, other, cd.limb_tables().q)

    def multiply(self, b1: CiphertextBatch, b2: CiphertextBatch) -> CiphertextBatch:
        if b1.parms_id != b2.parms_id:
            raise ValueError("parameter mismatch")
        cd = self._cd(b1)
        if not (b1.is_ntt_form and b2.is_ntt_form):
            raise ValueError("CKKS operands must be in NTT form")
        out_scale = b1.scale * b2.scale
        if not _is_scale_within_bounds(out_scale, cd):
            raise ValueError("scale out of bounds")
        if isinstance(b1.data, ShardedTensor) or isinstance(b2.data, ShardedTensor):
            data = sharded.multiply(self.ev._plan, cd, b1.data, b2.data)
        else:
            data = convolve(b1.data, b2.data, cd.limb_tables())
        return CiphertextBatch(data, b1.parms_id, b1.is_ntt_form, out_scale, b1.correction_factor)

    def square(self, batch: CiphertextBatch) -> CiphertextBatch:
        return self.multiply(batch, batch)

    def relinearize(self, batch: CiphertextBatch, relin_keys: RelinKeys) -> CiphertextBatch:
        cd = self._cd(batch)
        self._check_key(relin_keys)
        if batch.size != 3:
            raise ValueError("batched relinearize currently supports size-3 inputs")
        if not batch.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        key = relin_keys.key(2)
        self._check_key_limbs(key, cd)
        if isinstance(batch.data, ShardedTensor):
            data = sharded.switch_key(self.ev._plan, cd, batch.data, 2, key)
        else:
            data = self.ev._switch_key_body(cd, 2, batch.data, batch.data[:, 2], key["c0"], key["c1"])
        return CiphertextBatch(data, batch.parms_id, batch.is_ntt_form, batch.scale, batch.correction_factor)

    def rescale_to_next(self, batch: CiphertextBatch) -> CiphertextBatch:
        cd = self._cd(batch)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        if not batch.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        if isinstance(batch.data, ShardedTensor):
            data = sharded.rescale(cd, batch.data)
        else:
            data = R.divide_and_round_q_last_ntt(batch.data, cd.rns_tool, cd.limb_tables())
        return CiphertextBatch(data, next_cd.parms_id, batch.is_ntt_form,
                               batch.scale / cd.coeff_modulus_values[-1], batch.correction_factor)

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

        def combine(x, y, q):
            pad = x.shape[-3] - y.shape[-3]
            if pad:     # the shorter operand's missing polys are zero
                zeros = lambda a, p: a.new_zeros(a.shape[:-3] + (p,) + a.shape[-2:])
                x, y = (x, torch.cat([y, zeros(y, pad)], dim=-3)) if pad > 0 else \
                    (torch.cat([x, zeros(x, -pad)], dim=-3), y)
            return U.add_mod(x, y, q) if is_add else U.sub_mod(x, y, q)

        data = self._elementwise(cd, b1.data, combine, b2.data)
        return CiphertextBatch(data, b1.parms_id, b1.is_ntt_form, b1.scale, b1.correction_factor)

    def negate(self, batch: CiphertextBatch) -> CiphertextBatch:
        cd = self._cd(batch)
        data = self._elementwise(cd, batch.data, lambda x, _, q: U.neg_mod(x, q))
        return CiphertextBatch(data, batch.parms_id, batch.is_ntt_form, batch.scale, batch.correction_factor)

    # -- not ported yet ---------------------------------------------------
    def mod_switch_to_next(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.mod_switch_to_next", 8)

    def mod_reduce_to_next(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.mod_reduce_to_next", 8)

    def apply_galois(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.apply_galois (Galois keys)", 8)

    def rotate_rows(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.rotate_rows", 8)

    def rotate_columns(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.rotate_columns", 8)

    def rotate_vector(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.rotate_vector", 8)

    def multiply_plain(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.multiply_plain", 8)

    def add_plain(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.add_plain", 8)

    def sub_plain(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.sub_plain", 8)

    def transform_to_ntt(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.transform_to_ntt", 8)

    def transform_from_ntt(self, batch, *args, **kwargs):
        raise _unported("BatchEvaluator.transform_from_ntt", 8)

    def multiply_many(self, batches, *args, **kwargs):
        raise _unported("BatchEvaluator.multiply_many (BFV and BGV only)", 9)

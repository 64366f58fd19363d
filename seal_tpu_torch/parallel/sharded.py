"""The mesh bodies of the CKKS server ops, on sharded (..., size, k, n) data.
Data split over a mesh (``parallel/mesh.py``) has its RNS limbs (axis -2)
split over the limb axis and, for batches, its leading axis over the data
(and host) axes.  Each rank runs the single-device bodies
(``ckks_bodies.py``) on its own ciphertexts and limbs:

* multiply, add, sub, negate: per limb, no exchange;
* key switch: each rank inverse-NTTs its limbs of the target (kernel A),
  contracts its own decomposition rows with kernel B (row offset), the limb
  group gathers and adds the partial sums mod q
  (``shard_ops.gather_add_mod``), and each rank runs the CKKS tail on its
  own output limbs;
* rescale: the rank that holds the last limb broadcasts it to its limb
  group, each rank rescales its own limbs, and the limbs are re-split as
  ``torch.tensor_split`` splits the new count;
* Galois automorphism: each rank permutes its own limbs (the permutation
  acts on the coefficient axis, which no rank splits), then the key switch
  of the permuted c1 as above.

Every result equals the single-device body's bit for bit.  ``plan_for(cd,
device)`` gives the key-switch constants of a level on a device; the
evaluators pass their cache of them.  Both ``Evaluator(mesh=...)`` and
``parallel/batch.BatchEvaluator`` run these bodies.  BFV and BGV data on a
mesh is not ported yet (:func:`mesh_not_ported`, ROADMAP.md item 13).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..ckks_bodies import KeySwitchPlan, convolve, key_switch_contract, key_switch_tail
from ..context import ContextData
from ..ops import rns as R
from ..ops.poly import apply_galois_ntt
from ..params import SchemeType
from .collectives import broadcast, gather_range
from .mesh import ShardedTensor, split_bounds
from .shard_ops import gather_add_mod

PlanFor = Callable[[ContextData, torch.device], KeySwitchPlan]


def mesh_not_ported(scheme: SchemeType) -> NotImplementedError:
    """The error for BFV or BGV data sharded over a mesh: the BEHZ
    multiply's base conversions and BGV's mod-t corrections read every q
    limb or the last one, and this layer has no exchange for them yet."""
    return NotImplementedError(f"{scheme.name} on a mesh is not ported yet (ROADMAP.md queue 1, item 13)")


def _limb_groups(st: ShardedTensor) -> List[List[int]]:
    """The groups of ranks that split the limbs of the same ciphertexts."""
    return st.mesh.groups(st.spec.axes(st.ndim - 2))


def _pair(d1, d2):
    if not (isinstance(d1, ShardedTensor) and isinstance(d2, ShardedTensor)):
        raise ValueError("shard both operands over the mesh, or neither")
    if d1.mesh is not d2.mesh or d1.spec != d2.spec or d1.shape[:-3] != d2.shape[:-3] or \
            d1.shape[-2:] != d2.shape[-2:]:
        raise ValueError(f"operands must be sharded alike: {d1} and {d2}")
    return d1, d2


def multiply(plan_for: PlanFor, cd: ContextData, d1, d2) -> ShardedTensor:
    """The dyadic convolution on every rank's limbs."""
    d1, d2 = _pair(d1, d2)
    shards = []
    for r in range(d1.mesh.size):
        lo, hi = d1.block(r, -2)
        shards.append(convolve(d1.shards[r], d2.shards[r], plan_for(cd, d1.mesh.device(r)).level(lo, hi)))
    shape = list(d1.shape)
    shape[-3] = d1.shape[-3] + d2.shape[-3] - 1
    return d1.replace(shards, shape)


def elementwise(plan_for: PlanFor, cd: ContextData, data, fn, other=None) -> ShardedTensor:
    """fn(x, y, q) on every rank's limbs (y None for a unary op)."""
    if other is not None:
        data, other = _pair(data, other)
    shards = []
    for r in range(data.mesh.size):
        lo, hi = data.block(r, -2)
        q = plan_for(cd, data.mesh.device(r)).level(lo, hi).q
        shards.append(fn(data.shards[r], None if other is None else other.shards[r], q))
    shape = list(data.shape)
    if other is not None:
        shape[-3] = max(data.shape[-3], other.shape[-3])
    return data.replace(shards, shape)


def limbwise(plan_for: PlanFor, cd: ContextData, data: ShardedTensor, fn) -> ShardedTensor:
    """fn(x, t, lo, hi) on every rank's limbs [lo, hi) of the level, with
    ``t`` the level's tables of those limbs; the shape stays."""
    shards = []
    for r in range(data.mesh.size):
        lo, hi = data.block(r, -2)
        shards.append(fn(data.shards[r], plan_for(cd, data.mesh.device(r)).level(lo, hi), lo, hi))
    return data.replace(shards)


def drop_limbs(data: ShardedTensor, k_next: int) -> ShardedTensor:
    """The first ``k_next`` limbs of sharded (..., k, n) data, split over
    the limb axis as ``torch.tensor_split`` splits ``k_next``."""
    mesh = data.mesh
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in _limb_groups(data):
        ranges = [data.block(g, -2) for g in group]
        have = [(lo, max(lo, min(hi, k_next))) for lo, hi in ranges]
        pieces = [data.shards[g][..., :b - a, :] for g, (a, b) in zip(group, have)]
        for g, want in zip(group, split_bounds(k_next, len(group))):
            out[g] = gather_range(pieces, have, *want, -2, mesh.device(g)).contiguous()
    shape = list(data.shape)
    shape[-2] = k_next
    return data.replace(out, shape)


def _key_rows(component, data: ShardedTensor, rank: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a key component (D', k_key, n) for ``rank``: a view
    of its own shard where it holds them, else gathered from its group."""
    device = data.mesh.device(rank)
    if not isinstance(component, ShardedTensor):
        return component[lo:hi].to(device)
    if component.mesh is not data.mesh:
        raise ValueError("the key is sharded over another mesh than the ciphertexts")
    axes = component.spec.axes(0)
    group = component.mesh.group(rank, axes) if axes else [rank]
    return gather_range([component.shards[g] for g in group], [component.block(g, 0) for g in group],
                        lo, hi, 0, device)


Target = Union[int, ShardedTensor]


def _target(data: ShardedTensor, target: Target, rank: int) -> torch.Tensor:
    """Rank ``rank``'s limbs of the poly to switch: poly ``target`` of the
    data, or the one poly of a (..., 1, k, n) ShardedTensor sharded alike."""
    if isinstance(target, ShardedTensor):
        return target.shards[rank][..., 0, :, :]
    return data.shards[rank][..., target, :, :]


def contract(plan_for: PlanFor, cd: ContextData, data: ShardedTensor, target: Target,
             key: dict) -> List[torch.Tensor]:
    """The key-switch sum of the target poly (an index into the data, or a
    ShardedTensor of its own), (..., 2, Rn, n) < q_i, on every rank: each
    rank's own decomposition rows on kernel B, then the limb group's
    gather-add mod q, so every rank of a group holds the same sum."""
    mesh = data.mesh
    partials = []
    for r in range(mesh.size):
        lo, hi = data.block(r, -2)
        plan = plan_for(cd, mesh.device(r))
        local = data.shards[r]
        if lo == hi:
            partials.append(torch.zeros(local.shape[:-3] + (2, plan.D + 1, local.shape[-1]),
                                        dtype=local.dtype, device=local.device))
            continue
        partials.append(key_switch_contract(plan, _target(data, target, r), _key_rows(key["c0"], data, r, lo, hi),
                                            _key_rows(key["c1"], data, r, lo, hi), lo, hi))
    totals: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in _limb_groups(data):
        qs = [plan_for(cd, mesh.device(g)).sel_tables.q for g in group]
        for g, total in zip(group, gather_add_mod([partials[g] for g in group], qs)):
            totals[g] = total
    return totals


def switch_key(plan_for: PlanFor, cd: ContextData, data: ShardedTensor, target: Target,
               key: dict) -> ShardedTensor:
    """Key-switch a poly of sharded (..., size, k, n) data away.  With an
    index ``target``, returns polys [0, target) with the switched pair added
    into 0 and 1.  With a ShardedTensor ``target`` (..., 1, k, n), the poly
    switched is that one and ``data`` is the size-1 (c0) part: returns
    (c0, 0) plus the switched pair.  The key's components may be sharded
    (over the same mesh) or whole."""
    if cd.parms.scheme != SchemeType.CKKS:
        raise mesh_not_ported(cd.parms.scheme)
    totals = contract(plan_for, cd, data, target, key)
    size = 2 if isinstance(target, ShardedTensor) else target
    shards = []
    for r in range(data.mesh.size):
        lo, hi = data.block(r, -2)
        local = data.shards[r] if isinstance(target, ShardedTensor) else data.shards[r][..., :target, :, :]
        if lo == hi:
            shards.append(local.new_zeros(local.shape[:-3] + (size,) + local.shape[-2:]))
        else:
            shards.append(key_switch_tail(plan_for(cd, data.mesh.device(r)), totals[r], local, lo, hi))
    shape = list(data.shape)
    shape[-3] = size
    return data.replace(shards, shape)


def galois(plan_for: PlanFor, cd: ContextData, data: ShardedTensor, galois_elt: int, key: dict) -> ShardedTensor:
    """The Galois automorphism of sharded NTT-form (..., 2, k, n) data and
    the key switch of its permuted c1: each rank gathers its own limbs of
    both polys, then :func:`switch_key` with the permuted c1 as the target."""
    tool = cd.galois_tool
    perm = [apply_galois_ntt(d, tool.ntt_index(galois_elt, d.device)) for d in data.shards]
    one = list(data.shape)
    one[-3] = 1
    c0 = data.replace([p[..., :1, :, :] for p in perm], one)
    c1 = data.replace([p[..., 1:, :, :] for p in perm], one)
    return switch_key(plan_for, cd, c0, c1, key)


def rescale(cd: ContextData, data: ShardedTensor) -> ShardedTensor:
    """Divide-and-round by the last prime on sharded (..., size, k, n) data;
    the result is split over the limb axis as ``torch.tensor_split`` splits
    k - 1 limbs."""
    mesh = data.mesh
    k = data.shape[-2]
    tool = cd.rns_tool
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in _limb_groups(data):
        ranges = [data.block(g, -2) for g in group]
        owner = next(i for i, (lo, hi) in enumerate(ranges) if lo <= k - 1 < hi)
        olo = ranges[owner][0]
        sources = [data.shards[g] for g in group]
        sources[owner] = sources[owner][..., k - 1 - olo:k - olo, :]
        lasts = broadcast(sources, owner)
        pieces, have = [], []
        for g, (lo, hi), last in zip(group, ranges, lasts):
            top = min(hi, k - 1)
            local = data.shards[g]
            if top > lo:
                pieces.append(R.divide_and_round_q_last_ntt_limbs(
                    local[..., :top - lo, :], last, lo, tool, cd.limb_tables(mesh.device(g))))
            else:
                pieces.append(local[..., :0, :])
            have.append((lo, max(lo, top)))
        for g, want in zip(group, split_bounds(k - 1, len(group))):
            out[g] = gather_range(pieces, have, *want, -2, mesh.device(g))
    shape = list(data.shape)
    shape[-2] = k - 1
    return data.replace(out, shape)

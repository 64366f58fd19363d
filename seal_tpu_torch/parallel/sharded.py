"""The mesh bodies of the server ops of all three schemes, on sharded
(..., size, k, n) data.  Data split over a mesh (``parallel/mesh.py``) has
its RNS limbs (axis -2) split over the limb axis and, for batches, its
leading axis over the data (and host) axes.  Each rank runs the
single-device bodies (``ckks_bodies.py``, ``bfv_bodies.py``) on its own
ciphertexts and limbs:

* CKKS's and BGV's multiply, add, sub, negate, the plain ops and the
  transforms: per limb, no exchange;
* BFV's BEHZ multiply: each rank converts its own q limbs to Bsk U
  {m_tilde}, the limb group adds the partial sums mod p
  (``shard_ops.gather_add_mod``), each rank transforms, convolves and
  inverse-transforms its q limbs and the whole Bsk part (kernel A), the
  group adds the floor's partial conversions q -> Bsk the same way, and
  each rank converts Bsk back to its own q limbs;
* key switch (either form): each rank inverse-NTTs its limbs of an
  NTT-form target (kernel A), contracts its own decomposition rows with
  kernel B (row offset), the limb group gathers and adds the partial sums
  mod q, and each rank runs the scheme's tail on its own output limbs;
* the switches by the last prime (the CKKS rescale, BFV's divide-and-round,
  BGV's mod-t switch): the rank that holds the last limb broadcasts it to
  its limb group, each rank switches its own limbs, and the limbs are
  re-split as ``torch.tensor_split`` splits the new count;
* Galois automorphism: each rank permutes its own limbs (the permutation
  acts on the coefficient axis, which no rank splits; BFV's negates by
  the rank's moduli), then the key switch of the permuted c1 as above.

Every result equals the single-device body's bit for bit.  ``plan_for(cd,
device)`` gives the key-switch constants of a level on a device; the
evaluators pass their cache of them.  Both ``Evaluator(mesh=...)`` and
``parallel/batch.BatchEvaluator`` run these bodies.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from .. import bfv_bodies
from ..ckks_bodies import KeySwitchPlan, convolve, key_switch_contract, key_switch_tail
from ..context import ContextData
from ..ntt_tables import LimbTables
from ..ops import rns as R
from ..ops.poly import apply_galois_coeff, apply_galois_ntt
from ..params import SchemeType
from .collectives import broadcast, gather_range
from .mesh import ShardedTensor, split_bounds
from .shard_ops import gather_add_mod

PlanFor = Callable[[ContextData, torch.device], KeySwitchPlan]


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
    """fn(x, y, t) on every rank's limbs, with ``t`` the level's tables of
    them (y None for a unary op)."""
    if other is not None:
        data, other = _pair(data, other)
    shards = []
    for r in range(data.mesh.size):
        lo, hi = data.block(r, -2)
        t = plan_for(cd, data.mesh.device(r)).level(lo, hi)
        shards.append(fn(data.shards[r], None if other is None else other.shards[r], t))
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


def _group_sums(data: ShardedTensor, partials: List[torch.Tensor], moduli) -> List[torch.Tensor]:
    """Every rank's partial sums added mod p over its limb group, each rank
    getting the total; ``moduli(device)`` gives the (k_out, 1) moduli."""
    totals: List[Optional[torch.Tensor]] = [None] * data.mesh.size
    for group in _limb_groups(data):
        qs = [moduli(data.mesh.device(g)) for g in group]
        for g, total in zip(group, gather_add_mod([partials[g] for g in group], qs)):
            totals[g] = total
    return totals


def _behz_tables(cd: ContextData, device, lo: int, hi: int) -> LimbTables:
    """The BEHZ bundle of a rank that holds q limbs [lo, hi): those limbs
    and the whole of Bsk, cut from ``ContextData.behz_limb_tables`` once
    per device and range."""
    whole = cd.behz_limb_tables(device)
    k = len(cd.coeff_modulus_values)
    if (lo, hi) == (0, k):
        return whole
    return cd._cached_tables(f"behz[{lo}:{hi}]", device, lambda dev: R.take_limbs(
        whole, [*range(lo, hi), *range(k, whole.q.shape[0])]))


def bfv_multiply(cd: ContextData, d1, d2) -> ShardedTensor:
    """BFV's BEHZ product of sharded coefficient-form data, with two
    exchanges over each limb group: the partial conversions q -> Bsk U
    {m_tilde} of the extension and q -> Bsk of the floor, added mod p.
    Passing the same data twice squares it."""
    d1, d2 = _pair(d1, d2)
    mesh, tool = d1.mesh, cd.rns_tool
    s1, s_out = d1.shape[-3], d1.shape[-3] + d2.shape[-3] - 1
    ranges = [d1.block(r, -2) for r in range(mesh.size)]
    xs = [bfv_bodies.operands(d1.shards[r], d2.shards[r]) for r in range(mesh.size)]
    ext = _group_sums(d1, [R.fastbconv_m_tilde(x, tool, lo) for x, (lo, _) in zip(xs, ranges)],
                      lambda dev: R.convert_moduli(tool.conv_q_to_Bsk_m_tilde_scaled, dev))
    zs, partials = [], []
    for r, (lo, hi) in enumerate(ranges):
        x = xs[r]
        if lo == hi:
            zs.append(None)
            partials.append(x.new_zeros(x.shape[:-3] + (s_out, tool.base_Bsk.size, x.shape[-1])))
            continue
        z = bfv_bodies.product(x, ext[r], s1, d2 is d1, tool, _behz_tables(cd, mesh.device(r), lo, hi))
        zs.append(z)
        partials.append(R.fast_convert_array(z[..., :hi - lo, :], tool.conv_q_to_Bsk, lo))
    floors = _group_sums(d1, partials, lambda dev: R.convert_moduli(tool.conv_q_to_Bsk, dev))
    shards = []
    for r, (lo, hi) in enumerate(ranges):
        if zs[r] is None:
            x = xs[r]
            shards.append(x.new_zeros(x.shape[:-3] + (s_out, 0, x.shape[-1])))
        else:
            shards.append(bfv_bodies.floor_sk(zs[r], hi - lo, floors[r], tool, lo))
    shape = list(d1.shape)
    shape[-3] = s_out
    return d1.replace(shards, shape)


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
    return _group_sums(data, partials, lambda dev: plan_for(cd, dev).sel_tables.q)


def switch_key(plan_for: PlanFor, cd: ContextData, data: ShardedTensor, target: Target,
               key: dict) -> ShardedTensor:
    """Key-switch a poly of sharded (..., size, k, n) data away.  With an
    index ``target``, returns polys [0, target) with the switched pair added
    into 0 and 1.  With a ShardedTensor ``target`` (..., 1, k, n), the poly
    switched is that one and ``data`` is the size-1 (c0) part: returns
    (c0, 0) plus the switched pair.  The key's components may be sharded
    (over the same mesh) or whole."""
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
    """The Galois automorphism of sharded (..., 2, k, n) data and the key
    switch of its permuted c1: each rank gathers its own limbs of both
    polys (NTT form for CKKS and BGV; coefficient form for BFV, negated
    where flagged mod the rank's moduli), then :func:`switch_key` with the
    permuted c1 as the target."""
    tool = cd.galois_tool
    perm = []
    for r, d in enumerate(data.shards):
        if cd.parms.scheme == SchemeType.BFV:
            lo, hi = data.block(r, -2)
            q = plan_for(cd, d.device).level(lo, hi).q
            perm.append(apply_galois_coeff(d, *tool.coeff_index(galois_elt, d.device), q))
        else:
            perm.append(apply_galois_ntt(d, tool.ntt_index(galois_elt, d.device)))
    one = list(data.shape)
    one[-3] = 1
    c0 = data.replace([p[..., :1, :, :] for p in perm], one)
    c1 = data.replace([p[..., 1:, :, :] for p in perm], one)
    return switch_key(plan_for, cd, c0, c1, key)


def _last_limb_body(cd: ContextData):
    """fn(rest, last, lo, device): the scheme's switch by the last prime on
    a rank's limbs [lo, lo + rest.shape[-2]) with the broadcast last limb:
    the CKKS rescale and BGV's mod-t switch in the NTT domain, BFV's
    divide-and-round on the coefficients."""
    tool, scheme = cd.rns_tool, cd.parms.scheme
    if scheme == SchemeType.BFV:
        return lambda rest, last, lo, dev: R.divide_and_round_q_last_limbs(rest, last, lo, tool)
    body = R.mod_t_and_divide_q_last_ntt_limbs if scheme == SchemeType.BGV else R.divide_and_round_q_last_ntt_limbs
    return lambda rest, last, lo, dev: body(rest, last, lo, tool, cd.limb_tables(dev))


def mod_switch(cd: ContextData, data: ShardedTensor) -> ShardedTensor:
    """Switch sharded (..., size, k, n) data at ``cd``'s level to the next
    by its last prime, in the scheme's way (:func:`_last_limb_body`); the
    result is split over the limb axis as ``torch.tensor_split`` splits
    k - 1 limbs.  BGV's correction factor stays with the caller."""
    mesh = data.mesh
    k = data.shape[-2]
    body = _last_limb_body(cd)
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
                pieces.append(body(local[..., :top - lo, :], last, lo, mesh.device(g)))
            else:
                pieces.append(local[..., :0, :])
            have.append((lo, max(lo, top)))
        for g, want in zip(group, split_bounds(k - 1, len(group))):
            out[g] = gather_range(pieces, have, *want, -2, mesh.device(g))
    shape = list(data.shape)
    shape[-2] = k - 1
    return data.replace(out, shape)

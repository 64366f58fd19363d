"""Device meshes and sharded tensors: the multi-device layer's placement.

Port of ``seal_tpu/parallel/mesh.py``.  The JAX package runs one program
over a named ``jax.sharding.Mesh`` (``shard_map`` and GSPMD are
single-controller: one process drives every device).  The port works the
same way, with no ``torch.distributed``:

* a :class:`DeviceMesh` is an array of ``torch.device``\\ s with named axes,
  one entry per *rank* (one logical device of the mesh).  A device may
  appear more than once, so ``["cuda:0"] * 8`` or ``["cpu"] * 8`` is an
  8-rank mesh on one card or on the CPU, the counterpart of JAX's 8
  virtual CPU devices;
* a :class:`ShardedTensor` holds one local tensor per rank and the
  :class:`PartitionSpec` that says which dimension is split over which
  mesh axes;
* ops run the single-device bodies on each rank's local tensor, and the
  collectives (``parallel/collectives.py``) are explicit functions over the
  ranks' tensors.

Axes, as in the JAX package: ``host`` (optional, outermost) and ``data``
split independent ciphertexts; ``limb`` splits RNS limbs, whose per-limb
NTT and dyadic work needs no communication (the key-switch contraction and
the rescale's last limb do, ``parallel/batch.py``).  A split that does not
divide evenly is cut the way ``torch.tensor_split`` cuts it: after a
rescale, 3 limbs over a limb axis of 2 become 2 + 1.  The ``host`` axis is
structure only: every rank is driven by this one process.

Key placement: key-switch keys are either split over the limb axis along
their decomposition axis or, with ``replicate_keys=True``, held whole by
every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """Which mesh axes split each dimension of a tensor, as in
    ``jax.sharding.PartitionSpec``: one entry per leading dimension, each
    None (replicated), an axis name, or a tuple of axis names (major
    first).  Dimensions past the entries are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def axes(self, dim: int) -> Tuple[str, ...]:
        part = self[dim] if dim < len(self) else None
        if part is None:
            return ()
        return (part,) if isinstance(part, str) else tuple(part)


def split_bounds(length: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each part when ``length`` is cut into ``parts`` the way
    ``torch.tensor_split`` cuts it: the first ``length % parts`` parts are
    one longer."""
    base, extra = divmod(length, parts)
    bounds = []
    lo = 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        raise ValueError("name the card of every rank, e.g. 'cuda:0'")
    return d


class DeviceMesh:
    """An array of torch devices with named axes; rank r is the r-th entry
    in row-major order (the counterpart of ``jax.sharding.Mesh``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} axis names, got {self.axis_names}")
        flat = [_device(d) for d in arr.ravel()]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.ravel()[:] = flat
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, rank: int) -> torch.device:
        return self.devices.ravel()[rank]

    def coords(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(rank, self.devices.shape))))

    def group(self, rank: int, axes) -> List[int]:
        """The ranks that differ from ``rank`` only along ``axes`` (a name or
        a tuple of names, major first), in the order of those axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        base = self.coords(rank)
        out = []
        for idx in np.ndindex(*(self.shape[a] for a in axes)):
            c = dict(base)
            c.update(zip(axes, idx))
            out.append(int(np.ravel_multi_index(tuple(c[a] for a in self.axis_names), self.devices.shape)))
        return out

    def groups(self, axes) -> List[List[int]]:
        """Every group along ``axes`` once, each as :meth:`group` orders it."""
        seen, out = set(), []
        for r in range(self.size):
            g = self.group(r, axes)
            if g[0] not in seen:
                seen.add(g[0])
                out.append(g)
        return out


class ShardedTensor:
    """A tensor split over a mesh: one local tensor per rank.

    ``shards[r]`` lies on ``mesh.device(r)`` and holds the block of the
    global tensor of shape ``shape`` that ``spec`` gives rank r; ranks that
    differ only along axes the spec does not name hold the same block.
    """

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec, shape: Sequence[int], shards: Sequence[torch.Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} ranks")
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        self.shape = tuple(int(s) for s in shape)
        self.shards = list(shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def block(self, rank: int, dim: int) -> Tuple[int, int]:
        """[lo, hi) of dimension ``dim`` that rank ``rank`` holds."""
        dim %= self.ndim
        axes = self.spec.axes(dim)
        if not axes:
            return 0, self.shape[dim]
        coords = self.mesh.coords(rank)
        idx, parts = 0, 1
        for a in axes:
            idx = idx * self.mesh.shape[a] + coords[a]
            parts *= self.mesh.shape[a]
        return split_bounds(self.shape[dim], parts)[idx]

    def index(self, rank: int) -> Tuple[slice, ...]:
        return tuple(slice(*self.block(rank, d)) for d in range(self.ndim))

    def replace(self, shards: Sequence[torch.Tensor], shape: Optional[Sequence[int]] = None) -> "ShardedTensor":
        """The same mesh and spec over new local tensors."""
        return ShardedTensor(self.mesh, self.spec, self.shape if shape is None else shape, shards)

    def unshard(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: rank 0's)."""
        device = self.shards[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        used = {a for d in range(self.ndim) for a in self.spec.axes(d)}
        for r in range(self.mesh.size):
            if all(c == 0 for a, c in self.mesh.coords(r).items() if a not in used):
                out[self.index(r)] = self.shards[r]
        return out

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, spec={self.spec!r}, mesh={self.mesh.shape})"


def shard(mesh: DeviceMesh, x: torch.Tensor, spec: PartitionSpec) -> ShardedTensor:
    """Split ``x`` over ``mesh`` by ``spec``: rank r gets its block on its device."""
    for d in range(len(spec)):
        for a in PartitionSpec(*spec).axes(d):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which the mesh {mesh.shape} lacks")
    st = ShardedTensor(mesh, spec, x.shape, [x] * mesh.size)
    st.shards = [x[st.index(r)].contiguous().to(mesh.device(r)) for r in range(mesh.size)]
    return st


@dataclass(frozen=True)
class HEMesh:
    """A device mesh with (host?, batch, limb) axes."""

    mesh: DeviceMesh
    batch_axis: str = "data"
    limb_axis: str = "limb"
    host_axis: Optional[str] = None
    replicate_keys: bool = False

    @property
    def batch_size(self) -> int:
        b = self.mesh.shape[self.batch_axis]
        if self.host_axis:
            b *= self.mesh.shape[self.host_axis]
        return b

    @property
    def limb_size(self) -> int:
        return self.mesh.shape[self.limb_axis]

    @property
    def host_size(self) -> int:
        return self.mesh.shape[self.host_axis] if self.host_axis else 1

    def _batch_axes(self):
        if self.host_axis:
            return (self.host_axis, self.batch_axis)
        return self.batch_axis

    def ct_batch_spec(self) -> PartitionSpec:
        """(batch, size, k, n) ciphertext batches: batch over host x data."""
        return PartitionSpec(self._batch_axes(), None, self.limb_axis, None)

    def ct_spec(self) -> PartitionSpec:
        """(size, k, n) single ciphertexts: limbs split."""
        return PartitionSpec(None, self.limb_axis, None)

    def key_spec(self) -> PartitionSpec:
        """(D, k_key, n) key-switch keys: decomposition axis split, or
        whole on every rank when ``replicate_keys``."""
        if self.replicate_keys:
            return PartitionSpec()
        return PartitionSpec(self.limb_axis, None, None)


def make_mesh(
    n_devices: Optional[int] = None,
    limb_parallel: int = 1,
    hosts: int = 1,
    replicate_keys: bool = False,
    devices: Optional[Sequence] = None,
) -> HEMesh:
    """Build a (data, limb) or (host, data, limb) mesh of ``n_devices`` ranks.

    Without ``devices`` the ranks are the machine's cards, one each, and a
    machine with fewer cards than ``n_devices`` raises.  ``devices`` lists
    the device of each rank explicitly and may repeat one, e.g.
    ``["cuda:0"] * 8`` or ``["cpu"] * 8``.  ``hosts > 1`` adds the outermost
    axis; it is structure only here, since one process drives every rank.
    """
    if devices is None:
        available = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is None:
            n_devices = len(available)
        if n_devices > len(available) or n_devices < 1:
            raise ValueError(
                f"a mesh of {n_devices} ranks needs {n_devices} cards and this machine has "
                f"{len(available)}; pass devices=[...] to place several ranks on one device"
            )
    else:
        available = [_device(d) for d in devices]
        if n_devices is None:
            n_devices = len(available)
        if not 1 <= n_devices <= len(available):
            raise ValueError(f"a mesh of {n_devices} ranks needs as many devices, {len(available)} were given")
    if n_devices % (limb_parallel * hosts):
        raise ValueError("n_devices must be divisible by hosts * limb_parallel")
    chosen = np.empty(n_devices, dtype=object)
    chosen[:] = available[:n_devices]
    if hosts > 1:
        arr = chosen.reshape(hosts, n_devices // (hosts * limb_parallel), limb_parallel)
        return HEMesh(DeviceMesh(arr, ("host", "data", "limb")), host_axis="host", replicate_keys=replicate_keys)
    arr = chosen.reshape(n_devices // limb_parallel, limb_parallel)
    return HEMesh(DeviceMesh(arr, ("data", "limb")), replicate_keys=replicate_keys)


def shard_batch(hem: HEMesh, ct_batch_data: torch.Tensor) -> ShardedTensor:
    """Place a batched ciphertext tensor (B, size, k, n) on the mesh."""
    return shard(hem.mesh, ct_batch_data, hem.ct_batch_spec())


def shard_kswitch_key(hem: HEMesh, key: dict) -> dict:
    """Place a key-switch key's two (D, k_key, n) components on the mesh."""
    return {"c0": shard(hem.mesh, key["c0"], hem.key_spec()),
            "c1": shard(hem.mesh, key["c1"], hem.key_spec())}


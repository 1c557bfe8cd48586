"""``ShardedTensor``: a tensor laid out on a mesh of virtual devices.

The JAX package checkpoints ``jax.Array``s placed under a
``NamedSharding``: one array object that holds every device's shard, read
through ``addressable_shards`` by the planner and rebuilt by the restore
from one buffer per shard. :class:`ShardedTensor` is that object for the
port: the global shape and dtype, the :class:`~repro_torch.launch.mesh.
Mesh`, the spec (a plain tuple, one entry a dimension: ``None``, an axis
name, or a tuple of axis names, major first), and every virtual device's
shard as ``(device, index, data)``.

It is not a DTensor. PyTorch's DTensor is multi-controller: each process
holds only its own rank's shard, and building one needs a process group
of one process a device. The checkpoint planner, like the JAX package's,
runs in one process and reads every device's shard at once (the replica
deduplication and the balanced writer assignment see the whole layout),
so the port keeps its own single-controller counterpart.

Each unique region is one contiguous tensor on the mesh's device, as a
JAX shard's buffer is; the replicas of a region share that one tensor.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.tree import flatten_with_path
from repro_torch.launch.mesh import Mesh

Region = Tuple[Tuple[int, int], ...]
Spec = Tuple[Any, ...]


class Shard(NamedTuple):
    """One virtual device's shard: its id, its index into the global
    tensor (one slice a dimension) and its data."""

    device: int
    index: Tuple[slice, ...]
    data: torch.Tensor


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_indices(global_shape: Sequence[int], mesh: Mesh, spec: Spec
                 ) -> Dict[int, Tuple[slice, ...]]:
    """Virtual device id -> its index (slices), as ``NamedSharding.
    addressable_devices_indices_map``: a dimension split over axes
    ``(a, b)`` takes block ``coord(a) * size(b) + coord(b)``; a dimension
    left whole is ``slice(None)``. Every split must divide its dimension."""
    shape = tuple(int(d) for d in global_shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    sizes = mesh.shape
    for dim, entry in zip(shape, spec):
        for a in _axes(entry):
            if a not in sizes:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{mesh.axis_names}")
        n = math.prod(sizes[a] for a in _axes(entry))
        if dim % n:
            raise ValueError(f"spec {spec}: dimension {dim} of {shape} "
                             f"does not split into {n} blocks")
    out: Dict[int, Tuple[slice, ...]] = {}
    for dev in mesh.devices.reshape(-1).tolist():
        coord = mesh.coords(dev)
        index = []
        for dim, entry in zip(shape, spec):
            axes = _axes(entry)
            if not axes:
                index.append(slice(None))
                continue
            block = 0
            for a in axes:
                block = block * sizes[a] + coord[a]
            width = dim // math.prod(sizes[a] for a in axes)
            index.append(slice(block * width, (block + 1) * width))
        out[dev] = tuple(index)
    return out


def _region(index: Tuple[slice, ...], shape: Tuple[int, ...]) -> Region:
    return tuple((0 if s.start is None else s.start,
                  d if s.stop is None else s.stop)
                 for s, d in zip(index, shape))


class ShardedTensor:
    """A tensor of ``global_shape`` and ``dtype`` laid out on ``mesh`` by
    ``spec``. ``regions`` maps each unique region (``((lo, hi), ...)``)
    to its contiguous tensor on ``mesh.device``."""

    def __init__(self, global_shape: Sequence[int], dtype: torch.dtype,
                 mesh: Mesh, spec: Spec, regions: Dict[Region, torch.Tensor]):
        self.shape = torch.Size(int(d) for d in global_shape)
        self.dtype = dtype
        self.mesh = mesh
        self.spec = tuple(spec)
        self._indices = spec_indices(self.shape, mesh, self.spec)
        self._shards: List[Shard] = []
        for dev, index in self._indices.items():
            region = _region(index, tuple(self.shape))
            t = regions.get(region)
            want = tuple(hi - lo for lo, hi in region)
            if t is None:
                raise ValueError(f"no tensor for region {region} of "
                                 f"device {dev}")
            if tuple(t.shape) != want or t.dtype != dtype \
                    or t.device != mesh.device or not t.is_contiguous():
                raise ValueError(
                    f"region {region}: got a {t.dtype}{tuple(t.shape)} on "
                    f"{t.device} (contiguous {t.is_contiguous()}), want a "
                    f"contiguous {dtype}{want} on {mesh.device}")
            self._shards.append(Shard(dev, index, t))

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def addressable_shards(self) -> List[Shard]:
        """Every virtual device's shard, in device-id order (the JAX
        array's ``addressable_shards``)."""
        return list(self._shards)

    def devices_indices_map(self) -> Dict[int, Tuple[slice, ...]]:
        """Virtual device id -> index (``addressable_devices_indices_map``
        of the JAX sharding)."""
        return dict(self._indices)

    def unique_shards(self) -> Iterator[Tuple[Region, torch.Tensor]]:
        """``(region, tensor)`` once a unique region, in device-id order."""
        seen = set()
        for s in self._shards:
            region = _region(s.index, tuple(self.shape))
            if region not in seen:
                seen.add(region)
                yield region, s.data

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.dtype}{tuple(self.shape)}, "
                f"spec={self.spec}, {self.mesh})")


def _spec_at(specs: Any, path: Tuple) -> Spec:
    """The spec at ``path`` of ``specs``: a tree whose leaves are plain
    tuples, so it is walked by the state tree's path, not flattened."""
    node = specs
    for key in path:
        node = getattr(node, key) if hasattr(node, "_fields") \
            else node[key]
    return tuple(node)


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """``tree`` with every tensor leaf laid out on ``mesh`` by its spec in
    ``specs`` (a tree of the same structure whose leaves are plain tuples):
    each unique region copied once into a contiguous tensor on
    ``mesh.device`` (``jax.device_put`` under a ``NamedSharding``). Other
    leaves stay as they are."""
    flat, unflatten = flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        spec = _spec_at(specs, path)
        shape = tuple(leaf.shape)
        regions: Dict[Region, torch.Tensor] = {}
        for index in spec_indices(shape, mesh, spec).values():
            region = _region(index, shape)
            if region not in regions:
                regions[region] = leaf.detach()[index].to(
                    mesh.device, copy=True,
                    memory_format=torch.contiguous_format)
        out.append(ShardedTensor(shape, leaf.dtype, mesh, spec, regions))
    return unflatten(out)


def _unshard_leaf(x: Any) -> Any:
    if not isinstance(x, ShardedTensor):
        return x
    out = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
    for region, t in x.unique_shards():
        out[tuple(slice(lo, hi) for lo, hi in region)] = t
    return out


def unshard(x: Any) -> Any:
    """Every :class:`ShardedTensor` in ``x`` (a leaf or a tree) gathered
    into one tensor on its mesh's device; other leaves as they are."""
    flat, unflatten = flatten_with_path(x)
    return unflatten([_unshard_leaf(leaf) for _p, leaf in flat])

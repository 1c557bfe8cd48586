"""Shard planning: map a state pytree onto per-rank files.

Reproduces the checkpoint composition of Fig 1(c,d): every device ("rank")
owns the shards resident on it; replicated shards would be written once
each, balanced over their replica group by byte count
(:func:`assign_replica_writers`). A
:class:`~repro_torch.sharding.ShardedTensor` leaf gives one shard per
virtual device of its mesh, read exactly as the JAX package reads a
``jax.Array``'s ``addressable_shards`` (replicas deduplicated, writers
balanced, the owning rank the virtual device id); a plain torch tensor is
one shard owned by its device's index. A ``DTensor`` leaf (one rank of a
``torch.distributed`` group, :mod:`repro_torch.sharding.context`) is laid
out the same way: every rank of its mesh is the virtual device of the
same id, the replicas and writers come out of the same rule on every
rank, and only this rank's own shard carries data (its local tensor);
another rank's record names its shard and holds ``None``. The shard
boundaries are whatever the training layout dictates — the planner never
reshards (paper §IV-C).

Leaf paths, tensor names (``"{group}/{path}@[lo:hi,...]"``) and dtype
names (numpy-style, ``"bfloat16"`` included) match the JAX package's
exactly, so either package restores the other's files.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.context import is_dtensor
from repro_torch.sharding.sharded import ShardedTensor

from . import dtypes
from .tree import flatten_with_path, path_str


@dataclasses.dataclass
class ShardRecord:
    """One device shard of one pytree leaf, assigned to an owning rank.

    ``domain`` is the leaf's state-domain name (the first component of its
    state path — ``"model"`` for ``state/model/...``); ``route`` is the
    :class:`~repro_torch.core.registry.ProviderRoute` resolved by the manager's
    registry at plan time (``None`` → the engine's adaptive default).
    Routes ride the record so every consumer — the single-writer engine
    and each rank lane of a multi-writer coordinator — honors the same
    per-domain provider decision without re-consulting the registry.
    """

    leaf_path: str
    tensor_name: str            # unique name within the rank file
    rank: int                   # owning device id
    index: Tuple[Tuple[int, int], ...]
    global_shape: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    data: Any                   # torch tensor or numpy array
    device_resident: bool
    domain: str = "state"
    route: Optional[Any] = None  # ProviderRoute | None


def normalize_index(index, shape) -> Tuple[Tuple[int, int], ...]:
    """Convert a shard's tuple-of-slices index into ((start, stop), ...)."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


def assign_replica_writers(
        shards: Sequence[Tuple[Any, int, Dict[int, Any]]],
        initial_load: Optional[Dict[int, int]] = None,
) -> Dict[Any, int]:
    """Pick one writer per replicated shard, balanced within replica groups.

    ``shards`` is ``(key, nbytes, {device_id: data})`` per unique shard;
    the returned map is ``key -> owning device id``. Shards sharing the
    same replica group (identical candidate device set) are spread over
    that group greedily by byte count, largest first, onto the
    least-loaded member (ties to the lowest device id) — so within every
    group no device carries more than ⌈group bytes / group size⌉ plus one
    shard of the group's bytes, and each shard gets exactly one writer.

    ``initial_load`` seeds the per-device byte counters (default 0): the
    coordinator's dead-rank reassignment reuses this balance to spread an
    evicted writer's shard slice over *already-loaded* survivors, so the
    extra bytes land on the least-loaded lanes instead of stacking onto
    one.
    """
    by_group: Dict[Tuple[int, ...], List[Tuple[int, Any]]] = {}
    for key, nbytes, replicas in shards:
        by_group.setdefault(tuple(sorted(replicas)), []).append((nbytes, key))
    owners: Dict[Any, int] = {}
    for devices, members in by_group.items():
        load = {d: int((initial_load or {}).get(d, 0)) for d in devices}
        # sort by descending size, then key, for a deterministic plan
        for nbytes, key in sorted(members, key=lambda m: (-m[0], str(m[1]))):
            dev = min(devices, key=lambda d: (load[d], d))
            owners[key] = dev
            load[dev] += nbytes
    return owners


def state_domain(path_str: str, group: str) -> str:
    """State-domain name of a leaf: the first component of its path within
    the tree (``"model"`` for a leaf under ``{"model": ...}``), or the
    group itself for a bare (single-leaf / non-mapping-rooted) tree."""
    head = path_str.split("/", 1)[0]
    return head or group


def plan_shards(tree, group: str, registry=None
                ) -> Tuple[List[ShardRecord], Dict[str, Any]]:
    """Flatten ``tree``; return shard records for arrays + dict of host objects.

    A :class:`~repro_torch.sharding.ShardedTensor` leaf gives one device
    shard per virtual device (owned by that device's id); replicated
    shards are deduplicated, each unique shard written exactly once, with
    writers balanced across replica groups by byte count (see
    :func:`assign_replica_writers`). A ``torch.Tensor`` leaf is one device
    shard (owned by ``tensor.device.index or 0``). Device shards are staged
    into the host cache by the engine; a numpy array is host-resident and
    streams from its own buffer; anything else is an object leaf. With ``registry`` (a
    :class:`~repro_torch.core.registry.StateProviderRegistry`) every leaf is
    routed through the ordered rules here, at plan time, and tensor shards
    carry their resolved route on the record.
    """
    records: List[ShardRecord] = []
    objects: Dict[str, Any] = {}
    replicas: Dict[Tuple[str, Tuple], Dict[int, Any]] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    dtype_names: Dict[str, str] = {}
    domains: Dict[str, str] = {}
    for path, leaf in flatten_with_path(tree)[0]:
        p = path_str(path)
        pstr = f"{group}/{p}"
        domain = state_domain(p, group)
        if is_dtensor(leaf):
            shapes[pstr] = tuple(leaf.shape)
            dtype_names[pstr] = dtypes.BY_TORCH[leaf.dtype].name
            domains[pstr] = domain
            for dev, idx, data in _dtensor_shards(leaf):
                replicas.setdefault((pstr, idx), {})[dev] = data
        elif isinstance(leaf, ShardedTensor):
            shapes[pstr] = tuple(leaf.shape)
            dtype_names[pstr] = dtypes.BY_TORCH[leaf.dtype].name
            domains[pstr] = domain
            for shard in leaf.addressable_shards:
                idx = normalize_index(shard.index, leaf.shape)
                replicas.setdefault((pstr, idx), {})[shard.device] = \
                    shard.data
        elif isinstance(leaf, torch.Tensor):
            shapes[pstr] = tuple(leaf.shape)
            dtype_names[pstr] = dtypes.of_tensor(leaf).name
            domains[pstr] = domain
            idx = tuple((0, d) for d in leaf.shape)
            replicas.setdefault((pstr, idx), {})[leaf.device.index or 0] = \
                leaf
        elif isinstance(leaf, np.ndarray):
            idx = tuple((0, d) for d in leaf.shape)
            suffix = ",".join(f"{a}:{b}" for a, b in idx)
            name = dtypes.of_array(leaf).name
            route = None
            if registry is not None:
                route = registry.route(
                    domain=domain, path=pstr, dtype=name,
                    nbytes=int(leaf.nbytes), kind="tensor")
            records.append(ShardRecord(
                leaf_path=pstr, tensor_name=f"{pstr}@[{suffix}]",
                rank=0, index=idx, global_shape=tuple(leaf.shape),
                shape=tuple(leaf.shape), dtype=name,
                nbytes=int(leaf.nbytes), data=leaf, device_resident=False,
                domain=domain, route=route))
        else:
            objects[pstr] = leaf
            if registry is not None:
                # objects always stream through ObjectStateProvider; the
                # routing pass exists for validation — strict registries
                # surface unmatched/mis-routed leaves by state path here
                registry.route(domain=domain, path=pstr, dtype=None,
                               nbytes=None, kind="object")
    if replicas:
        shard_meta = []
        for (pstr, idx), by_dev in replicas.items():
            shape = tuple(b - a for a, b in idx)
            itemsize = dtypes.lookup(dtype_names[pstr]).itemsize
            nbytes = int(np.prod(shape)) * itemsize if shape else itemsize
            shard_meta.append(((pstr, idx), int(nbytes), by_dev))
        owners = assign_replica_writers(shard_meta)
        for (pstr, idx), nbytes, by_dev in shard_meta:
            dev_id = owners[(pstr, idx)]
            shape = tuple(b - a for a, b in idx)
            suffix = ",".join(f"{a}:{b}" for a, b in idx)
            route = None
            if registry is not None:
                route = registry.route(
                    domain=domains[pstr], path=pstr,
                    dtype=dtype_names[pstr], nbytes=nbytes, kind="tensor")
            records.append(ShardRecord(
                leaf_path=pstr,
                tensor_name=f"{pstr}@[{suffix}]",
                rank=dev_id, index=idx,
                global_shape=shapes[pstr],
                shape=shape, dtype=dtype_names[pstr], nbytes=nbytes,
                data=by_dev[dev_id], device_resident=True,
                domain=domains[pstr], route=route))
    return records, objects


def _dtensor_shards(leaf):
    """``(rank, region, data)`` for every rank of a ``DTensor``'s mesh:
    its region by the virtual device of that id, the data this rank's
    local tensor (contiguous) and ``None`` for every other rank."""
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.sharding.partition import spec_of
    from repro_torch.sharding.sharded import spec_indices
    mesh = leaf.device_mesh
    me = torch.distributed.get_rank()
    local = leaf.to_local()
    if not local.is_contiguous():
        local = local.contiguous()
    spec = spec_of(leaf.placements, mesh, leaf.ndim)
    shape = tuple(leaf.shape)
    for dev, index in spec_indices(shape, virtual_mesh(mesh), spec).items():
        yield dev, normalize_index(index, shape), \
            (local if dev == me else None)


def group_by_rank(records: Sequence[ShardRecord]
                  ) -> Dict[int, List[ShardRecord]]:
    by_rank: Dict[int, List[ShardRecord]] = {}
    for r in records:
        by_rank.setdefault(r.rank, []).append(r)
    return by_rank

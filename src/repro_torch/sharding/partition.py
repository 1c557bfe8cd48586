"""Parameter and optimizer partition rules (``repro.sharding.partition``).

Two modes (``cfg.sharding_mode``):

* ``"2d"`` (the default, beyond the paper): every large matrix is sharded
  on *both* mesh axes (FSDP x TP hybrid); optimizer state inherits the
  param spec.
* ``"tp_zero1"`` (the paper's layout): params are TP-sharded over
  ``model`` and replicated over ``data`` (Megatron/DeepSpeed); optimizer
  state is additionally sharded over ``data`` — DeepSpeed ZeRO stage 1,
  the paper's evaluation setup (Table II).

Rules match on the leaf's key name; scan-stacked params (under
``groups``) get a leading ``None``. A spec is a plain tuple with one entry
a dimension: ``None``, an axis name, or a tuple of axis names. The rules
and their outcomes are the JAX package's, entry for entry.

:func:`placements_for` turns a spec into ``DTensor`` placements on a
``DeviceMesh``, and :func:`distribute_tree` lays a tree out as
``DTensor``s (the reference's ``shardings_for`` plus ``jax.device_put``):
each rank keeps the region :func:`~repro_torch.sharding.sharded.
spec_indices` gives its id, so a ``DTensor``'s local tensor holds what a
:class:`~repro_torch.sharding.ShardedTensor`'s shard of that id holds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import flatten_with_path
from repro_torch.launch.mesh import Mesh, virtual_mesh

from .context import axis_names

# name -> (spec for 2d mode, spec for tp_zero1 mode)
_RULES: Dict[str, Tuple[Tuple, Tuple]] = {
    # embeddings
    "embed": (("model", "data"), ("model", None)),
    "head": (("data", "model"), (None, "model")),
    # attention
    "wq": (("data", "model"), (None, "model")),
    "wk": (("data", "model"), (None, "model")),
    "wv": (("data", "model"), (None, "model")),
    "wo": (("model", "data"), ("model", None)),
    # ffn
    "w_gate": (("data", "model"), (None, "model")),
    "w_up": (("data", "model"), (None, "model")),
    "w_down": (("model", "data"), ("model", None)),
    # moe (leading expert dim -> expert parallelism over 'model')
    "router": ((None, None), (None, None)),
    # rwkv
    "wg": (("data", "model"), (None, "model")),
    "wr": (("data", "model"), (None, "model")),
    "w_in": (("data", "model"), (None, "model")),
    "w_out": (("model", "data"), ("model", None)),
    "w_r": (("data", "model"), (None, "model")),
    "mix_w1": (("data", None), (None, None)),
    "w_a": (("data", "model"), (None, "model")),
    "w_b": ((None, "model"), (None, "model")),
    # rg-lru
    "w_gate_branch": (("data", "model"), (None, "model")),
    "w_rec_in": (("data", "model"), (None, "model")),
    "w_x": (("data", "model"), (None, "model")),
    "conv_w": ((None, "model"), (None, "model")),
}

_MOE_RULES: Dict[str, Tuple[Tuple, Tuple]] = {
    # (E, d, f) / (E, f, d): experts over 'model', inner dim over 'data'
    "w_gate": (("model", "data", None), ("model", None, None)),
    "w_up": (("model", "data", None), ("model", None, None)),
    "w_down": (("model", "data", None), ("model", None, None)),
}


def _spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], mode: str
              ) -> Tuple:
    name = path[-1]
    if mode == "fsdp":
        # pure ZeRO-3/FSDP: no tensor parallelism — shard the first
        # shardable dim of every sizeable matrix over the whole mesh
        if len(shape) >= 2:
            return (("data", "model"),) + (None,) * (len(shape) - 1)
        if len(shape) == 1 and shape[0] >= 4096:
            return (("data", "model"),)
        return (None,) * len(shape)
    in_moe = "moe" in path and "shared" not in path
    col = 0 if mode == "2d" else 1
    rules = _MOE_RULES if (in_moe and name in _MOE_RULES) else _RULES
    if name in rules and len(rules[name][col]) == len(shape):
        return rules[name][col]
    return (None,) * len(shape)  # norms, biases, scalars: replicated


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(e) for e in path)


def _divisible(spec: Tuple, shape: Tuple[int, ...], mesh: Mesh) -> Tuple:
    """Drop axis assignments that don't divide the dim (clean replication
    for small or awkward dims)."""
    sizes = mesh.shape
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes.get(a, 1) for a in axes)
        out.append(entry if dim % n == 0 and dim >= n else None)
    return tuple(out)


def _map_with_path(fn, tree: Any) -> Any:
    flat, unflatten = flatten_with_path(tree)
    return unflatten([fn(p, leaf) for p, leaf in flat])


def _param_spec(cfg, path, leaf, mesh: Mesh) -> Tuple:
    names = _path_names(path)
    shape = tuple(leaf.shape)
    stacked = "groups" in names
    base_shape = shape[1:] if stacked else shape
    s = _spec_for(names, base_shape, cfg.sharding_mode)
    s = _divisible(s, base_shape, mesh)
    return (None,) + s if stacked else s


def param_pspecs(cfg, params: Any, mesh: Mesh) -> Any:
    """Spec tree matching ``params`` (a leaf under ``groups`` has one extra
    leading layer dim -> ``None``)."""
    return _map_with_path(lambda p, leaf: _param_spec(cfg, p, leaf, mesh),
                          params)


def opt_pspecs(cfg, params: Any, mesh: Mesh) -> Dict[str, Any]:
    """Optimizer-state specs. ``tp_zero1``: the first replicated dim of
    each master/m/v leaf that ``data`` divides goes over ``data`` (ZeRO-1).
    ``2d``: the params' specs. The step counter is replicated."""
    if cfg.sharding_mode != "tp_zero1":
        ps = param_pspecs(cfg, params, mesh)
        return {"master": ps, "m": ps, "v": ps, "count": ()}
    dp = mesh.shape.get("data", 1)

    def shard_over_data(path, leaf) -> Tuple:
        spec = _param_spec(cfg, path, leaf, mesh)
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (dim, e) in enumerate(zip(leaf.shape, entries)):
            if e is None and dim % dp == 0 and dim >= dp:
                entries[i] = "data"
                break
        return tuple(entries)

    zp = _map_with_path(shard_over_data, params)
    return {"master": zp, "m": zp, "v": zp, "count": ()}


def cache_pspecs(cfg, caches_template: Any, mesh: Mesh, *,
                 long_context: bool) -> Any:
    """Decode-cache specs. Batch over ('pod', 'data') normally; for
    ``long_context`` (batch 1) the KV sequence dim is sharded over 'data'
    (context parallelism). Head/feature dims go over 'model' when
    divisible."""
    names = set(mesh.axis_names)
    sizes = mesh.shape
    baxes = tuple(a for a in ("pod", "data") if a in names)
    nb = math.prod(sizes[a] for a in baxes) if baxes else 1
    mp = sizes.get("model", 1)
    dp = sizes.get("data", 1)

    def spec(path, leaf) -> Tuple:
        shape = tuple(leaf.shape)  # (count, B, ...)
        name = _path_names(path)[-1]
        s = [None] * len(shape)
        B = shape[1]
        if not long_context and baxes and B % nb == 0 and B >= nb:
            s[1] = baxes if len(baxes) > 1 else baxes[0]
        if name in ("k", "v") and len(shape) == 5:
            # (count, B, T, KV, hd)
            if long_context and "data" in names and shape[2] % dp == 0:
                s[2] = "data"
            elif getattr(cfg, "decode_kv_seq_shard", False) \
                    and "model" in names and shape[2] % mp == 0:
                s[2] = "model"
            elif shape[3] % mp == 0 and shape[3] >= mp:
                s[3] = "model"
            elif shape[4] % mp == 0 and shape[4] >= mp:
                s[4] = "model"
        elif name in ("mk", "mv") and len(shape) == 5:
            if shape[3] % mp == 0 and shape[3] >= mp:
                s[3] = "model"
        elif name == "S" and len(shape) == 5:   # (count, B, H, hs, hs)
            if shape[2] % mp == 0 and shape[2] >= mp:
                s[2] = "model"
        elif name in ("h", "x_t", "x_c") and len(shape) == 3:
            if shape[2] % mp == 0 and shape[2] >= mp:
                s[2] = "model"
        elif name == "conv" and len(shape) == 4:
            if shape[3] % mp == 0 and shape[3] >= mp:
                s[3] = "model"
        return tuple(s)

    return _map_with_path(spec, caches_template)


def batch_pspecs(cfg, shape_kind: str, batch_template: Dict[str, Any],
                 mesh: Mesh) -> Dict[str, Tuple]:
    """Input batch specs: the batch dim over ('pod', 'data') when
    divisible (plus 'model' in fsdp mode — the whole mesh is one data
    parallel domain)."""
    names = set(mesh.axis_names)
    axes = ("pod", "data", "model") if cfg.sharding_mode == "fsdp" \
        else ("pod", "data")
    baxes = tuple(a for a in axes if a in names)
    sizes = mesh.shape
    n = math.prod(sizes[a] for a in baxes) if baxes else 1

    def spec(v) -> Tuple:
        b = v.shape[0]
        first = baxes if (baxes and b % n == 0 and b >= n) else None
        if isinstance(first, tuple) and len(first) == 1:
            first = first[0]
        return (first,) + (None,) * (len(v.shape) - 1)

    return {k: spec(v) for k, v in batch_template.items()}


def placements_for(spec, device_mesh) -> Tuple:
    """``DTensor`` placements of ``spec`` on ``device_mesh`` (anything
    with ``axis_names`` or ``mesh_dim_names``): ``Shard(i)`` on every mesh
    dimension that splits tensor dimension ``i``, ``Replicate()`` on the
    rest. A tuple of axes must be in the mesh's axis order (JAX splits
    major to minor, a ``DTensor`` in mesh order); an axis the mesh lacks
    or one used twice raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(device_mesh)
    out = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            if a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            seen.add(a)
            pos.append(names.index(a))
        if pos != sorted(pos):
            raise ValueError(
                f"spec {spec}: axes {axes} of dimension {dim} are not in "
                f"the mesh's order {names}; a DTensor splits a dimension "
                f"over mesh dimensions in mesh order only")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def spec_of(placements, device_mesh, ndim: int) -> Tuple:
    """The spec a ``DTensor``'s ``placements`` give (the inverse of
    :func:`placements_for`): each ``Shard(i)`` puts its mesh axis on
    dimension ``i``, in mesh order. A ``Partial`` placement (a sum not
    yet reduced) has no spec and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(device_mesh)
    entries = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            entries[p.dim % max(ndim, 1)].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} on mesh axis {name!r} has no "
                             f"spec (reduce it first)")
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def local_region(shape: Tuple[int, ...], spec, device_mesh,
                 rank: int) -> Tuple[slice, ...]:
    """The index (one slice a dimension) of rank ``rank``'s shard of a
    ``shape`` tensor laid out by ``spec``: its virtual device id is its
    rank (:func:`~repro_torch.launch.mesh.virtual_mesh`)."""
    from .sharded import spec_indices
    return spec_indices(shape, virtual_mesh(device_mesh), spec)[rank]


def local_index(t) -> Tuple[slice, ...]:
    """The index of this rank's shard of ``DTensor`` ``t``: its region
    by its placements (:func:`spec_of`, :func:`local_region`)."""
    mesh = t.device_mesh
    return local_region(tuple(t.shape), spec_of(t.placements, mesh, t.ndim),
                        mesh, torch.distributed.get_rank())


def distribute_tree(tree: Any, specs: Any, device_mesh) -> Any:
    """``tree`` with every tensor leaf a ``DTensor`` on ``device_mesh``
    laid out by its spec in ``specs`` (a tree of the same structure whose
    leaves are plain tuples). Every rank passes the same full tree; each
    keeps a contiguous copy of its own region on the mesh's device and
    builds the ``DTensor`` from it (``DTensor.from_local``; no collective).
    A leaf's ``requires_grad`` carries over. Other leaves stay as they
    are."""
    from torch.distributed.tensor import DTensor

    from .sharded import _spec_at
    rank = torch.distributed.get_rank()
    device = mesh_device(device_mesh)
    flat, unflatten = flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        spec = _spec_at(specs, path)
        shape = tuple(leaf.shape)
        index = local_region(shape, spec, device_mesh, rank)
        local = leaf.detach()[index].to(device, copy=True,
                                        memory_format=torch.contiguous_format)
        d = DTensor.from_local(local, device_mesh,
                               placements_for(spec, device_mesh),
                               run_check=False, shape=torch.Size(shape),
                               stride=torch.empty(shape,
                                                  device="meta").stride())
        out.append(d.requires_grad_(leaf.requires_grad))
    return unflatten(out)


def mesh_device(device_mesh) -> torch.device:
    """The device this rank's shards live on: the current card of a
    ``cuda`` mesh, else the CPU."""
    if device_mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_mesh.device_type)

"""Ambient-mesh sharding context (port of ``repro/sharding/context.py``).

The model code expresses activation constraints against *logical* axes
(``"pod"``, ``"data"``, ``"model"``, ``"seq"``). A caller that runs the
model sharded activates a ``torch.distributed`` ``DeviceMesh`` through
:func:`activate`; when no mesh is active (one process, one device)
:func:`constrain` is the identity, so the same model code runs
everywhere.

Under an active mesh the model's tensors are ``DTensor``s and
:func:`constrain` redistributes one to the placements its resolved spec
gives (``x.redistribute``), where the JAX package puts a
``with_sharding_constraint`` for XLA. While a mesh is active, a plain
tensor that meets a ``DTensor`` in an operator (a mask, the positions,
RoPE's frequencies: constants each rank builds alike) counts as
replicated (``implicit_replication``).

A spec is a plain tuple, one entry a tensor dimension: ``None``, an axis
name, or a tuple of axis names, major first. JAX splits a dimension over
a tuple of axes major to minor; a ``DTensor`` shards one dimension over
several mesh dimensions in the mesh's order, so a tuple that is not in
the mesh's axis order has no ``DTensor`` layout and raises.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence, Tuple

_state = threading.local()

Spec = Tuple[Any, ...]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a rank's shard of a tensor laid out
    on a ``DeviceMesh``)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def active_mesh():
    """The ``DeviceMesh`` :func:`activate` made current on this thread,
    or ``None``."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activate(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or ``None`` for none) the active
    mesh of this thread; the previous one comes back on exit."""
    prev = active_mesh()
    _state.mesh = mesh
    try:
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
        else:
            yield None
    finally:
        _state.mesh = prev


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: ``axis_names`` (the port's virtual
    :class:`~repro_torch.launch.mesh.Mesh`, or any object that has them)
    or a ``DeviceMesh``'s ``mesh_dim_names``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def _resolve(spec: Sequence, mesh) -> Optional[Spec]:
    """Map logical axes onto the mesh: drop axis names the mesh does not
    have, map ``seq`` to the configured physical axis (context parallelism
    for batch-1 decode), expand ``data`` to the batch axes (fsdp), and
    never use one physical axis twice. Returns ``None`` when nothing
    survives (skip the constraint; do not force replication)."""
    names = set(axis_names(mesh))
    used = set()
    out = []
    any_axis = False
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        expanded = []
        for a in axes:
            ba = getattr(_state, "batch_axes", None)
            if a == "data" and ba:
                expanded.extend(ba)   # fsdp: batch spans extra axes
            else:
                expanded.append(a)
        mapped = []
        for a in expanded:
            if a == "seq":
                a = getattr(_state, "seq_axis", None)
                if a is None:
                    continue
            if a in names and a not in used:
                mapped.append(a)
                used.add(a)
        if not mapped:
            out.append(None)
        elif len(mapped) == 1:
            out.append(mapped[0])
            any_axis = True
        else:
            out.append(tuple(mapped))
            any_axis = True
    return tuple(out) if any_axis else None


def set_seq_axis(axis: Optional[str]) -> None:
    """Map the logical ``seq`` axis onto a physical mesh axis (or
    disable it with ``None``)."""
    _state.seq_axis = axis


def set_batch_axes(axes) -> None:
    """Expand the logical ``data`` (batch) axis onto extra physical axes,
    e.g. ``("data", "model")`` for pure-FSDP runs where the whole mesh is
    one data-parallel domain."""
    _state.batch_axes = tuple(axes) if axes else None


def seq_axis_active() -> bool:
    return getattr(_state, "seq_axis", None) is not None


def _divisible(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """``spec`` with every dimension its axes do not split evenly left
    whole: GSPMD pads such a dimension, and a ``DTensor``'s uneven shards
    (a batch of 1 over 2 ranks leaves one rank none) break the views that
    follow. The values are the same either way; only the layout differs."""
    sizes = dict(zip(axis_names(mesh), mesh.mesh.shape))
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(entry if dim % n == 0 else None)
    return tuple(out)


def constrain(x, spec: Sequence):
    """``x`` laid out by ``spec`` on the active mesh: ``x`` itself when no
    mesh is active or the spec resolves to nothing, else
    ``x.redistribute`` to the resolved placements (``x`` must then be a
    ``DTensor`` on that mesh; a dimension the axes do not divide stays
    whole)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    resolved = _resolve(spec, mesh)
    if resolved is None:
        return x
    from .partition import placements_for
    if not is_dtensor(x):
        raise TypeError(f"constrain under an active mesh needs a DTensor, "
                        f"got a {type(x).__name__} of shape "
                        f"{tuple(x.shape)}")
    resolved = _divisible(resolved, x.shape, mesh)
    return x.redistribute(mesh, placements_for(resolved, mesh))

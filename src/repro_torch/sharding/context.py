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

``constrain`` runs after ``DTensor``'s per-operator strategy has chosen
how to compute ``x``; ``with_sharding_constraint`` is a hint GSPMD
carries back into the product that makes ``x``. So the model lays each
weight product out before it runs, as GSPMD lays it out
(:func:`column_parallel`, :func:`row_parallel`: Megatron's pair, the
weight gathered over its FSDP axes only), and each product runs on the
``model`` shard the partition rules give its weight.

Where ``DTensor`` has no rule for a computation, or one that PyTorch
2.11 refuses, the model runs it on each rank's local shards
(:func:`on_local_shards`: attention and decode attention, the RG-LRU's
scan, RWKV6's WKV, the MoE's experts) or makes a split dimension whole
first (:func:`unsplit`, :func:`unflatten_last`). A local computation
whose result is a sum or a maximum over ranks (the experts split over
``model``, a softmax over keys split over ranks) reduces it with
:func:`reduce_local`. :func:`current` carries this thread's settings
into an activation checkpoint's recompute.

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

import torch

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


@contextlib.contextmanager
def _reinstate(mesh, seq_axis, batch_axes):
    prev = (active_mesh(), getattr(_state, "seq_axis", None),
            getattr(_state, "batch_axes", None))
    _state.mesh, _state.seq_axis, _state.batch_axes = \
        mesh, seq_axis, batch_axes
    dispatcher = None
    if mesh is not None:
        from torch.distributed.tensor import DTensor
        dispatcher = DTensor._op_dispatcher
        allowed = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        _state.mesh, _state.seq_axis, _state.batch_axes = prev
        if dispatcher is not None:
            dispatcher._allow_implicit_replication = allowed


def current():
    """A context manager that puts this thread's settings (the active
    mesh with its implicit replication, the ``seq`` axis, the batch axes)
    in force wherever it is entered, and the previous ones back after:
    an activation checkpoint's recompute runs the forward again in
    autograd's thread, which on a card is not the caller's."""
    return _reinstate(active_mesh(), getattr(_state, "seq_axis", None),
                      getattr(_state, "batch_axes", None))


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
    from repro_torch.launch.mesh import mesh_ranks
    sizes = dict(zip(axis_names(mesh), mesh_ranks(mesh).shape))
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


def as_dtensor(x, mesh):
    """``x`` as a ``DTensor`` on ``mesh``: a plain tensor (a constant every
    rank builds alike) counts as replicated, as under
    ``implicit_replication``."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def column_parallel(x, w, b=None):
    """``x @ w`` (+ ``b``) for a weight ``w`` (K, N) whose output columns
    the partition rules split over ``model`` (``wq``, ``w_up``, the
    head, ...), laid out as GSPMD lays the product out (Megatron's
    column-parallel product): the weight is gathered over every mesh axis
    but the ones that split its columns (the FSDP unshard; in
    ``tp_zero1`` nothing moves), ``x`` is made whole over those (an
    all-gather of a sequence-parallel residual) and keeps its batch
    split, and the product runs on the local blocks: the result is split
    on its last dimension as ``w``'s columns are, on its batch as ``x``'s
    rows are. A mesh axis that splits ``x``'s batch (every axis in
    ``fsdp``) takes the weight whole. In the promoted dtype of ``x`` and
    ``w``, as ``jnp.matmul``. With no mesh active, or a weight that is
    not a ``DTensor``, the plain product."""
    dt = torch.promote_types(x.dtype, w.dtype)
    mesh = active_mesh()
    if mesh is None or not is_dtensor(w):
        y = x.to(dt) @ w.to(dt)
        return y if b is None else y + b
    from torch.distributed.tensor import Replicate, Shard
    x = reduced(as_dtensor(x, mesh))
    nd, last = x.ndim, x.ndim - 1
    wt, xt = [], []
    for pw, px in zip(w.placements, x.placements):
        if isinstance(px, Shard) and px.dim % nd == 0:   # x's batch split
            wt.append(Replicate())
            xt.append(px)
        elif isinstance(pw, Shard) and pw.dim % w.ndim == 1:
            wt.append(pw)
            xt.append(Replicate())
        else:
            wt.append(Replicate())
            xt.append(Replicate() if isinstance(px, Shard)
                      and px.dim % nd == last else px)
    y = x.redistribute(mesh, xt).to(dt) @ w.to(dt).redistribute(mesh, wt)
    return y if b is None else y + b


def row_parallel(x, w, out_spec: Sequence, b=None):
    """``x @ w`` (+ ``b``) for a weight ``w`` (K, N) whose input rows the
    partition rules split over ``model`` (``wo``, ``w_down``, ...): the
    row-parallel half of Megatron's pair. ``x`` is split on its last
    dimension as ``w``'s rows are (a column-parallel result already is,
    a replicated one is sliced), the weight gathered over the other axes
    (the FSDP unshard), and each rank's product is a partial sum over the
    axes that split K, reduced once to ``out_spec`` (logical axes): an
    all-reduce where it leaves N whole and the sequence unsplit, a
    reduce-scatter where it splits one of them (Megatron sequence
    parallelism). The bias is added after the reduction. A mesh axis that
    splits another dimension of ``x`` (the batch; the sequence, as
    Ulysses' exit constraint leaves it) takes the weight whole. Promoted
    dtype and the unsharded case as :func:`column_parallel`."""
    dt = torch.promote_types(x.dtype, w.dtype)
    mesh = active_mesh()
    if mesh is None or not is_dtensor(w):
        y = x.to(dt) @ w.to(dt)
        return y if b is None else y + b
    from torch.distributed.tensor import Replicate, Shard

    from .partition import placements_for
    x = reduced(as_dtensor(x, mesh))
    nd, last = x.ndim, x.ndim - 1
    wt, xt = [], []
    for pw, px in zip(w.placements, x.placements):
        k_split = (isinstance(pw, Shard) and pw.dim % w.ndim == 0) or \
            (isinstance(px, Shard) and px.dim % nd == last)
        if isinstance(px, Shard) and px.dim % nd != last:
            wt.append(Replicate())
            xt.append(px)
        elif k_split:
            wt.append(Shard(0))
            xt.append(Shard(last))
        else:
            wt.append(Replicate())
            xt.append(px)
    x, w = x.redistribute(mesh, xt).to(dt), w.to(dt)
    if any(isinstance(p, Shard) and 0 < p.dim % nd < last for p in xt):
        # a sequence-split x: the product on the local blocks, the weight
        # whole (PyTorch 2.11's DTensor refuses the matmul's flatten of a
        # split sequence)
        from .partition import spec_of
        spec = spec_of(xt, mesh, nd)
        y = on_local_shards(torch.matmul, (x, w), (spec, (None, None)),
                            (spec[:-1] + (None,),), shared=(1,))
    else:
        y = x @ w.redistribute(mesh, wt)
    resolved = _divisible(_resolve(out_spec, mesh) or (None,) * y.ndim,
                          y.shape, mesh)
    y = y.redistribute(mesh, placements_for(resolved, mesh))
    return y if b is None else y + b


def unsplit(x, dims: Sequence[int]):
    """``x`` with no mesh axis splitting any of ``dims``: a ``DTensor``
    sharded on one of them is redistributed (that mesh axis replicated,
    every other placement kept), anything else comes back as it is. For
    the views and slices ``DTensor`` has no rule for on a split dimension
    (an unflatten the axis does not divide, a slot write); not one of the
    reference's activation constraints, which :func:`constrain` makes."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [d % x.ndim for d in dims]
    placements = [Replicate() if isinstance(p, Shard)
                  and p.dim % x.ndim in want else p for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def reduced(x):
    """``x`` with every pending sum (a ``Partial`` placement) reduced
    (that mesh axis replicated, every other placement kept); anything
    else comes back as it is. For an elementwise operator whose other
    operand is split where ``x`` is partial: PyTorch 2.11's ``DTensor``
    cannot redistribute a split operand to a partial one."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    placements = [Replicate() if p.is_partial() else p
                  for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def unflatten_last(x, *shape: int):
    """x (..., prod(shape)) viewed as (..., *shape). A ``DTensor``
    unflattens a split dimension only where the split divides
    ``shape[0]`` (GSPMD pads instead); otherwise the dimension is made
    whole first (:func:`unsplit`)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        from repro_torch.launch.mesh import mesh_ranks
        n = 1
        for size, p in zip(mesh_ranks(x.device_mesh).shape, x.placements):
            if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1:
                n *= size
        if shape[0] % n:
            x = unsplit(x, (-1,))
    return x.reshape(tuple(x.shape[:-1]) + tuple(shape))


def local_spec(spec: Sequence, shape: Sequence[int]) -> Spec:
    """``spec`` (logical axes) resolved on the active mesh, each dimension
    the axes do not divide left whole; all ``None`` when nothing
    survives."""
    mesh = active_mesh()
    return _divisible(_resolve(spec, mesh) or (None,) * len(shape), shape,
                      mesh)


class _ReduceLocal(torch.autograd.Function):
    """A rank's local tensor reduced over mesh dimensions, through
    ``DTensor``'s own collective (a ``Partial`` redistributed to
    ``Replicate``). The sum's backward is the identity: each rank's part
    of a sum gets the whole gradient of the replicated result (which
    arrives whole, the result being replicated). A maximum is not
    differentiated."""

    @staticmethod
    def forward(ctx, x, mesh, dims, op):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        ctx.op = op
        rep = [Replicate()] * mesh.ndim
        part = [Partial(op) if i in dims else p for i, p in enumerate(rep)]
        return DTensor.from_local(x, mesh, part, run_check=False) \
            .redistribute(mesh, rep).to_local()

    @staticmethod
    def backward(ctx, g):
        if ctx.op != "sum":
            raise RuntimeError(f"reduce_local: no gradient for {ctx.op!r}")
        return g, None, None, None


def reduce_local(x: torch.Tensor, dims: Sequence[int],
                 op: str = "sum") -> torch.Tensor:
    """``x``, a rank's local tensor inside :func:`on_local_shards`,
    reduced (``"sum"`` or ``"max"``) over the active mesh's dimensions
    ``dims`` (indices) and replicated over them; ``x`` itself when
    ``dims`` is empty. The sum is differentiable."""
    if not dims:
        return x
    return _ReduceLocal.apply(x, active_mesh(), tuple(dims), op)


def split_dims(x, dim: int) -> Tuple[int, ...]:
    """The mesh dimensions (indices) that split dimension ``dim`` of
    ``DTensor`` ``x``."""
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim)


def split_dims_of(entry) -> Tuple[int, ...]:
    """The active mesh's dimensions (indices) of one resolved spec entry
    (``None``, an axis name or a tuple of them)."""
    axes = () if entry is None else \
        entry if isinstance(entry, tuple) else (entry,)
    names = axis_names(active_mesh())
    return tuple(names.index(a) for a in axes)


def _dense_strides(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= max(size, 1)
    return tuple(reversed(out))


class _ContiguousGrad(torch.autograd.Function):
    """The identity whose backward makes the gradient contiguous. On the
    way into a ``local_map`` body a ``DTensor``'s gradient is the local
    tensor of whatever layout the redistribution left (a ``sum``'s is
    expanded, stride 0), and on the way out the redistribution views the
    local gradient; either fails on a layout a view cannot take. A
    contiguous tensor comes out with the dense strides of its shape: a
    size-1 dimension's stride is arbitrary (a fake tensor's can differ
    from a real one's), and the ``DTensor`` made of a local output takes
    its strides from it, which decide how a later ``matmul`` runs."""

    @staticmethod
    def forward(ctx, x):
        if x.is_contiguous():
            return x.as_strided(x.shape, _dense_strides(x.shape))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_local_shards(fn, args: Sequence, in_specs: Sequence,
                    out_specs: Sequence, shared: Sequence[int] = (),
                    partial: Optional[dict] = None):
    """``fn(*args)`` on each rank's local shards of ``DTensor`` arguments,
    by ``local_map``, for a computation that is local along the split
    dimensions (the batch, heads, channels): each tensor argument is
    redistributed to its resolved spec in ``in_specs`` first (``None``
    for an argument that is not a tensor), each output comes back laid
    out by its spec in ``out_specs``. ``shared``: the positions of
    arguments every local row uses (a parameter), whose gradient on a
    rank is a partial sum over each mesh axis the first output is split
    on and they are not. ``partial``: argument position -> the mesh
    dimensions (indices) over which its gradient on a rank is a partial
    sum (an input every rank takes whole into a sum ``fn`` splits over
    those dimensions and completes with :func:`reduce_local`). Gradients
    cross the boundary contiguous. With no ``DTensor`` among ``args``,
    ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from .partition import placements_for
    mesh = active_mesh()

    def place(spec):
        # one list of placements a tensor (a tuple reads as one a value)
        return None if spec is None else list(placements_for(spec, mesh))

    def local(*xs):
        xs = [_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
              else x for x in xs]
        out = fn(*xs)
        if isinstance(out, torch.Tensor):
            return _ContiguousGrad.apply(out)
        return tuple(_ContiguousGrad.apply(o) for o in out)

    ins = [place(s) for s in in_specs]
    split = place(out_specs[0])
    grads = [[Partial() if p.is_replicate() and not q.is_replicate()
              else p for p, q in zip(ins[i], split)] if i in shared
             else ins[i] for i in range(len(ins))]
    for i, dims in (partial or {}).items():
        grads[i] = [Partial() if d in dims else p
                    for d, p in enumerate(grads[i])]
    outs = [place(s) for s in out_specs]
    return local_map(local, out_placements=tuple(outs) if len(outs) > 1
                     else outs[0], in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)

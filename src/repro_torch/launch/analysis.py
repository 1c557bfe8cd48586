"""Traced-step analysis: FLOPs, bytes, collectives, memory and the
roofline (port of ``repro/launch/analysis.py``).

The reference derives its roofline from XLA's compiled per-device HLO
(``cost_analysis``, ``memory_analysis`` and collective bytes parsed from
the HLO text). The port has no compiler between the step and the card, so
it counts a step traced on fake tensors (``torch._subclasses.
FakeTensorMode``: shapes and dtypes, no data, no card) instead, with one
dispatch mode, :class:`TraceCounter`. On a mesh of several devices the
step runs on ``DTensor``s over a fake process group
(:mod:`repro_torch.launch.dryrun`), and the counter sees one rank's
*local* program: a ``DTensor`` operator is passed on to ``DTensor``
(the mode returns ``NotImplemented``), which runs it as operators on the
local shards and collectives, and those the counter counts. So every
figure is rank 0's, as the reference's are one device's:

- **FLOPs** by ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention; the attention kernel's operator
  registers its own, :func:`repro_torch.kernels.flash_attention.
  flash_flop`), on the local shapes; the mode decomposes what it has no
  formula for as ``FlopCounterMode`` does, so an unsharded trace counts
  what ``FlopCounterMode`` counts. Elementwise work is not counted, as
  XLA's ``flops`` counts it only in part. ``FlopCounterMode`` itself
  cannot wrap a ``DTensor`` program: it would count the global shapes.
- **Bytes accessed**: every operator's tensor inputs and outputs (views
  move nothing and are skipped). Like XLA's "bytes accessed" this is an
  upper bound: an input read by two operators counts twice.
- **Collectives**: the ``_c10d_functional`` operators ``DTensor``'s
  redistributions issue, by the reference's kinds
  (``all_gather_into_tensor`` all-gather, ``all_reduce`` all-reduce,
  ``reduce_scatter_tensor`` reduce-scatter, ``all_to_all_single``
  all-to-all; coalesced and in-place forms under the same kind), and
  ``_dtensor.shard_dim_alltoall`` (the all-to-all by which a ``DTensor``
  on a ``cuda`` mesh moves a split to another dimension; on a ``cpu``
  mesh it takes an all-gather instead) as an all-to-all, each
  counted with its result's bytes, as the reference sums result shapes.
  ``wait_tensor`` is not counted, as the reference skips ``-done``.
- **Temp bytes**: the peak of live storage the step allocates beyond its
  arguments, followed by weak references to each output's storage.
- **The op profile** (opt-in, ``record_ops``): one :class:`OpRecord` an
  operator the counter counts, in trace order: the operator, a name (its
  own and its index), its kind, its local result's bytes and its type
  string in the reference's HLO form (``bf16[2,4096,2048]``). It is the
  counterpart of the compiled HLO's instruction list that
  ``scripts/hlo_top_ops.py`` reads; :func:`op_profile` totals it by
  kind. Views and DTensor's bookkeeping are left out, as from every
  other figure, and so are a fake tensor's device queries and a
  collective's ``wait_tensor``.

``DTensor`` also runs operators no device runs: its sharding
propagation learns an operator's output shape the first time it meets a
layout by running it on fake tensors at global shapes (cached
afterwards), and it works out a strided shard's size and offsets with
small index tensors on the host. The counter leaves out, and runs
unfaked, every operator dispatched from those (:func:`bookkeeping`), so
a cold trace counts what a warm one does, and a trace what a real rank
does.

The terms are those of the reference::

    compute term    = FLOPs(per device) / peak FLOP/s
    memory term     = bytes(per device) / HBM bandwidth
    collective term = collective bytes(per device) / link bandwidth

with the card's rates (:mod:`repro_torch.launch.mesh`; NVLink for the
link). The reference's HLO-text parsers (``shape_bytes``,
``collective_bytes``) have no counterpart: there is no HLO text.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .mesh import HBM_BW, HW_NAME, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: ``_c10d_functional`` operator name prefix -> the reference's kind
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"))
COLLECTIVES_NOTE = ("rank 0's local program: the _c10d_functional "
                    "collectives DTensor's redistributions issue, each with "
                    "its result's bytes; collective-permute stays 0, as "
                    "DTensor emits none")
#: DTensor's host bookkeeping: the sharding propagation's source files,
#: and the function that works out a shard's size and offsets
BOOKKEEPING_FILES = ("_sharding_prop.py", "_decompositions.py")
BOOKKEEPING_FUNCTIONS = ("local_shard_size_and_offset",)
#: size and stride queries ``FlopCounterMode`` passes on uncounted
_QUERIES = {getattr(torch.ops.aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim") if hasattr(torch.ops.aten, n)} \
    | {torch.ops.aten.is_contiguous.memory_format,
       torch.ops.prim.layout.default}


#: the reference's HLO element type names
_HLO_DTYPES = {torch.bool: "pred", torch.int8: "s8", torch.int16: "s16",
               torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
               torch.uint16: "u16", torch.uint32: "u32",
               torch.uint64: "u64", torch.float16: "f16",
               torch.bfloat16: "bf16", torch.float32: "f32",
               torch.float64: "f64", torch.complex64: "c64",
               torch.complex128: "c128"}


#: left out of the op records: a fake tensor's device query (it reaches
#: the mode, a real tensor's does not) and a collective's wait (a real
#: rank waits, a fake group's collective is done at once; the reference
#: skips the ``-done`` half too)
_UNRECORDED = {torch.ops.prim.device.default,
               torch.ops._c10d_functional.wait_tensor.default}


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def nbytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard, or ``t`` itself."""
    return getattr(t, "_local_tensor", t)


def local_nbytes(tree: Any) -> int:
    """Bytes this rank holds of every tensor in ``tree`` (a ``DTensor``'s
    local shard)."""
    return nbytes([local(t) for t in _tensors(tree)])


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


def bookkeeping() -> bool:
    """Whether the operator being dispatched is DTensor's host
    bookkeeping: called from a frame of :data:`BOOKKEEPING_FILES` within
    torch's ``distributed/tensor``, or of a function of
    :data:`BOOKKEEPING_FUNCTIONS`."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            return False
        code = f.f_code
        if code.co_name in BOOKKEEPING_FUNCTIONS or (
                code.co_filename.endswith(BOOKKEEPING_FILES)
                and "tensor" in code.co_filename):
            return True
        f = f.f_back
    return False


def type_string(tree: Any) -> str:
    """The tensors of ``tree`` as the reference's HLO types:
    ``bf16[2,4096,2048]``, a tuple of them in parentheses."""
    parts = [f"{_HLO_DTYPES.get(t.dtype, str(t.dtype)[6:])}"
             f"[{','.join(str(n) for n in t.shape)}]"
             for t in _tensors(tree)]
    return parts[0] if len(parts) == 1 else f"({', '.join(parts)})"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One counted operator of a trace: ``op`` its overload
    (``aten.mm.default``), ``name`` its name and index in trace order
    (``mm.17``), ``kind`` its operator without the overload
    (``aten.mm``, ``_c10d_functional.all_gather_into_tensor``), ``bytes``
    its local result's bytes, ``type`` their HLO type string."""

    op: str
    name: str
    kind: str
    bytes: int
    type: str


def op_profile(ops: Iterable[OpRecord]) -> Dict[str, List[int]]:
    """Operator kind -> ``[count, result bytes]`` over ``ops``."""
    out: Dict[str, List[int]] = {}
    for o in ops:
        entry = out.setdefault(o.kind, [0, 0])
        entry[0] += 1
        entry[1] += o.bytes
    return out


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a ``_c10d_functional`` collective (or of
    ``_dtensor.shard_dim_alltoall``, the all-to-all ``DTensor`` runs
    itself to move a split from one dimension to another), or ``None``
    (another operator, ``wait_tensor``)."""
    if func.namespace == "_dtensor" and func._opname == "shard_dim_alltoall":
        return "all-to-all"
    if func.namespace != "_c10d_functional":
        return None
    name = func._opname
    for prefix, kind in _KIND_OF:
        if name.startswith(prefix):
            return kind
    return None


class TraceCounter(TorchDispatchMode):
    """Counts a program's FLOPs, bytes accessed and collectives on plain
    (local) tensors and follows the storage its operators allocate:
    ``peak_temp_bytes`` is the most that was live at once beyond the
    storages of ``arguments`` (a ``DTensor``'s local shard). Works on
    fake and on real tensors alike, so a real rank's step is counted as
    its trace is. ``fake_mode``: the fake-tensor mode a trace's operators
    run under (entered for each counted operator, so a factory makes a
    fake tensor). It stays off the mode stack between operators, so
    DTensor's bookkeeping computes on real index tensors and makes its
    own fake tensors, as it does in a real run. ``record_ops``: keep
    :attr:`ops`, one :class:`OpRecord` a counted operator (else
    ``None``)."""

    def __init__(self, arguments: Any, fake_mode=None,
                 record_ops: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.ops: Optional[List[OpRecord]] = [] if record_ops else None
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self.collective_bytes = {k: 0 for k in _COLLECTIVES}
        self.collective_counts = {k: 0 for k in _COLLECTIVES}
        self._dtensor = _dtensor_type()
        self._known: Set[int] = {_storage_key(local(t))
                                 for t in _tensors(arguments)}
        self._refs: Dict[int, Any] = {}

    def _freed(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self._known.discard(key)
        self.live_bytes -= n

    def profile(self) -> Dict[str, List[int]]:
        """:func:`op_profile` of :attr:`ops`."""
        return op_profile(self.ops)

    def collectives(self) -> Dict[str, Any]:
        """The reference's ``collective_bytes`` record: bytes a device,
        bytes and counts by kind."""
        return {"bytes_per_device": sum(self.collective_bytes.values()),
                "by_kind": dict(self.collective_bytes),
                "counts": dict(self.collective_counts)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES or (self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types)):
            return NotImplemented   # DTensor runs it on the local shards
        if bookkeeping():
            return func(*args, **kwargs)
        if func not in flop_registry \
                and func is not torch.ops.prim.device.default:
            # FlopCounterMode's rule: count a decomposition's parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if self.fake_mode is None:
            out = func(*args, **kwargs)
        else:
            with self.fake_mode:
                out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        self.bytes_accessed += nbytes((args, kwargs)) + nbytes(out)
        if self.ops is not None and func not in _UNRECORDED:
            self.ops.append(OpRecord(
                str(func), f"{func._opname}.{len(self.ops)}",
                f"{func.namespace}.{func._opname}", nbytes(out),
                type_string(out)))
        kind = collective_kind(func)
        if kind is not None:
            self.collective_bytes[kind] += nbytes(out)
            self.collective_counts[kind] += 1
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known.add(key)
            self._refs[key] = weakref.ref(
                st, lambda _r, key=key, n=n: self._freed(key, n))
            self.live_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes,
                                       self.live_bytes)
        return out


@dataclasses.dataclass
class Traced:
    """What one traced call of a step gives: its outputs (fake tensors,
    ``DTensor``s on a mesh), rank 0's FLOPs, bytes accessed, peak temp
    bytes and collectives, the trace's seconds, and with ``record_ops``
    its counted operators (:class:`OpRecord`, in trace order; else
    ``None``)."""

    outputs: Any
    flops: int
    bytes_accessed: int
    peak_temp_bytes: int
    collectives: Dict[str, Any]
    trace_s: float
    ops: Optional[List[OpRecord]] = None


def trace_step(step: Callable, args: tuple, mode,
               record_ops: bool = False) -> Traced:
    """Call ``step(*args)`` once on the fake tensors of ``mode`` that
    ``args`` holds, counting with :class:`TraceCounter` (keeping each
    counted operator's record with ``record_ops``)."""
    t0 = time.perf_counter()
    counter = TraceCounter(args, fake_mode=mode, record_ops=record_ops)
    with counter:
        outputs = step(*args)
    return Traced(outputs, counter.flops, counter.bytes_accessed,
                  counter.peak_temp_bytes, counter.collectives(),
                  time.perf_counter() - t0, counter.ops)


def roofline(traced: Traced, *, n_devices: int, model_flops_global: float,
             memory: Dict[str, int]) -> Dict[str, Any]:
    """The reference's roofline record for a traced step. FLOPs, bytes
    and collectives are one device's (the local program's); ``memory``
    holds the per-device ``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``alias_size_in_bytes`` and
    ``temp_size_in_bytes``."""
    flops_dev = float(traced.flops)
    bytes_dev = float(traced.bytes_accessed)
    coll = dict(traced.collectives, note=COLLECTIVES_NOTE)
    terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll["bytes_per_device"] / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    # the least HBM traffic: live arguments read once, outputs written
    # once (outputs that alias an argument counted once)
    lb_bytes = (memory["argument_size_in_bytes"]
                + memory["output_size_in_bytes"]
                - memory["alias_size_in_bytes"])
    terms["memory_lb_s"] = max(lb_bytes, 0) / HBM_BW
    traced_flops_global = flops_dev * n_devices
    return {
        "per_device": {"flops": flops_dev, "bytes": bytes_dev,
                       "collective_bytes": coll["bytes_per_device"]},
        "collectives": coll,
        "terms": terms,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "model_flops_global": model_flops_global,
        "traced_flops_global": traced_flops_global,
        "useful_flops_ratio": (model_flops_global / traced_flops_global
                               if traced_flops_global else 0.0),
        "memory": dict(memory),
        "hw": {"peak_flops": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
               "link_bw": NVLINK_BW, "n_devices": n_devices,
               "card": HW_NAME},
    }

"""Traced-step analysis: FLOPs, bytes, memory and the roofline (port of
``repro/launch/analysis.py``).

The reference derives its roofline from XLA's compiled HLO
(``cost_analysis``, ``memory_analysis`` and collective bytes parsed from
the HLO text). The port has no compiler between the step and the card, so
it counts a step traced once on fake tensors
(``torch._subclasses.FakeTensorMode``: shapes and dtypes, no data, no
card) instead:

- **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode``, which
  counts matrix products, convolutions and attention by formula; the
  attention kernel's operator registers its own
  (:func:`repro_torch.kernels.flash_attention.flash_flop`). Elementwise
  work is not counted, as XLA's ``flops`` counts it only in part.
- **Bytes accessed** come from :class:`TraceCounter`, a dispatch mode
  that adds up every operator's tensor inputs and outputs (views move
  nothing and are skipped). Like XLA's "bytes accessed" this is an upper
  bound: an input read by two operators counts twice.
- **Temp bytes** are the peak of live storage the step allocates beyond
  its arguments, followed by weak references to each output's storage.

The terms are those of the reference::

    compute term    = FLOPs(per device) / peak FLOP/s
    memory term     = bytes(per device) / HBM bandwidth
    collective term = collective bytes(per device) / link bandwidth

with the card's rates (:mod:`repro_torch.launch.mesh`). The collective
term is zero: the port runs its model sharded over a ``DeviceMesh`` of
ranks, but the dry run still traces one logical device, whose step
program holds no collective (counting the sharded trace's is the next
slice, ``ROADMAP.md``), so ``collectives`` keeps the reference's kinds at
zero and says why. The
reference's HLO-text parsers (``shape_bytes``, ``collective_bytes``) have
no counterpart: there is no HLO text.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .mesh import HBM_BW, HW_NAME, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
COLLECTIVES_NOTE = ("the dry run traces one logical device, so its step "
                    "program holds no collective; the sharded trace's "
                    "collective term is the next slice")


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def nbytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class TraceCounter(TorchDispatchMode):
    """Adds up each operator's tensor input and output bytes
    (``bytes_accessed``) and follows the storage the operators allocate:
    ``peak_temp_bytes`` is the most that was live at once beyond the
    storages in ``arguments``."""

    def __init__(self, arguments: Any):
        super().__init__()
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._known: Set[int] = {_storage_key(t) for t in _tensors(arguments)}
        self._refs: Dict[int, Any] = {}

    def _freed(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self._known.discard(key)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        self.bytes_accessed += nbytes((args, kwargs)) + nbytes(out)
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
    """What one traced call of a step gives: its outputs (fake tensors),
    FLOPs, bytes accessed, peak temp bytes and the trace's seconds."""

    outputs: Any
    flops: int
    bytes_accessed: int
    peak_temp_bytes: int
    trace_s: float


def trace_step(step: Callable, args: tuple, mode) -> Traced:
    """Call ``step(*args)`` once under the fake-tensor ``mode`` (whose
    tensors ``args`` holds), counting FLOPs, bytes and temp storage."""
    t0 = time.perf_counter()
    counter = TraceCounter(args)
    with mode, counter, FlopCounterMode(display=False) as flops:
        outputs = step(*args)
    return Traced(outputs, flops.get_total_flops(), counter.bytes_accessed,
                  counter.peak_temp_bytes, time.perf_counter() - t0)


def roofline(traced: Traced, *, n_devices: int, model_flops_global: float,
             memory: Dict[str, int]) -> Dict[str, Any]:
    """The reference's roofline record for a traced step. FLOPs and bytes
    are the traced totals spread evenly over ``n_devices``; ``memory``
    holds the per-device ``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``alias_size_in_bytes`` and
    ``temp_size_in_bytes``."""
    flops_dev = traced.flops / n_devices
    bytes_dev = traced.bytes_accessed / n_devices
    coll = {"bytes_per_device": 0,
            "by_kind": {k: 0 for k in _COLLECTIVES},
            "counts": {k: 0 for k in _COLLECTIVES},
            "note": COLLECTIVES_NOTE}
    terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    # the least HBM traffic: live arguments read once, outputs written
    # once (outputs that alias an argument counted once)
    lb_bytes = (memory["argument_size_in_bytes"]
                + memory["output_size_in_bytes"]
                - memory["alias_size_in_bytes"])
    terms["memory_lb_s"] = max(lb_bytes, 0) / HBM_BW
    traced_flops_global = float(traced.flops)
    return {
        "per_device": {"flops": flops_dev, "bytes": bytes_dev,
                       "collective_bytes": 0},
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

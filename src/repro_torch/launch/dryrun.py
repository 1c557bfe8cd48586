"""Dry run: trace every (arch x input shape x mesh) step on fake tensors
and emit the roofline record (port of ``repro/launch/dryrun.py``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch llama3.2-1b --shape train_4k [--multi-pod] \\
        [--mode 2d|tp_zero1|fsdp] [--no-donate] [--out record.json] \\
        [--set KEY=VALUE ...]

It needs no card and runs the same with or without one. The reference
lowers and compiles a jitted step against 512 placeholder host devices
(its ``XLA_FLAGS`` preamble) with sharded ``in_shardings``; the port has
no compiler to ask, so:

- The step's inputs are **fake CUDA tensors** (``FakeTensorMode``: shapes
  and dtypes, nothing allocated) built from the templates:
  ``models.model.param_shapes``, ``optim.adamw.init_opt_state``,
  ``serving.engine.cache_template`` and :func:`batch_template`. A fake
  tensor's device is a label: the step runs the same operators on it
  whatever it says. PyTorch built without CUDA cannot index a fake CUDA
  tensor (its device guard needs CUDA), so there the fake tensors say
  ``cpu`` (:func:`template_device`; the record's ``fake_device``).
- The **mesh** is the production mesh (16 x 16, or 2 x 16 x 16 with
  ``--multi-pod``); ``REPRO_DRYRUN_MESH`` (e.g. ``"4,4"``) sets a small
  one, as in the reference. On a mesh of several devices the step is
  **traced sharded**, as one rank of a run: a fake process group of the
  mesh's size (``torch.distributed``'s ``fake`` backend: no process
  a rank, no communication) holds a ``DeviceMesh`` of the fake tensors'
  device type; the inputs are laid out by the partition specs
  (:mod:`repro_torch.sharding.partition`: ``param_pspecs``,
  ``opt_pspecs``, ``batch_pspecs``, ``cache_pspecs``) as ``DTensor``s
  (``distribute_tree``, rank 0's shards), and the step runs under
  ``sharding.context.activate``, with the ``seq`` axis on ``data`` for
  long-context decode and the batch over ``("data", "model")`` in
  ``fsdp``, as the reference sets them. :mod:`.analysis` counts rank 0's
  local program: its FLOPs, bytes, collectives and temp storage. A mesh
  of one device traces the plain step, with no group and no collective.
  The reference's ``lower_s`` and ``compile_s`` are one ``trace_s``.
- **The process group.** The dry run owns the default group while it
  traces and destroys it on the way out, also on an error; a process
  that already has a default group (a rank of a run) cannot trace a
  sharded step and gets a ``RuntimeError``. One dry run at a time in a
  process.
- **Per-device numbers** are rank 0's: argument bytes are its shards of
  params, optimizer state or decode cache, and batch (what that rank
  checkpoints); outputs that alias an argument (the in-place AdamW
  update, the decode cache written in place) count that share, and
  ``--no-donate`` reports no alias, as the reference does without
  donation.
- ``remat`` is the config's (on by default, as in the reference; ``--set
  remat=false`` keeps every activation). The reference's
  ``analysis_unroll`` has no counterpart: the port's layer loop is
  always unrolled.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import dtypes
from repro_torch.core.tree import leaves, map_leaves
from repro_torch.launch import analysis
from repro_torch.launch.mesh import Mesh, make_abstract_mesh, \
    make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.serving.engine import cache_template, make_decode_step, \
    make_prefill_step
from repro_torch.sharding import context as shctx
from repro_torch.sharding.partition import (batch_pspecs, cache_pspecs,
                                            distribute_tree, opt_pspecs,
                                            param_pspecs)
from repro_torch.training.loop import make_train_step

#: a decode longer than this is long-context (the reference's threshold)
LONG_CONTEXT_SEQ = 100_000


def template_device() -> torch.device:
    """The fake tensors' device: ``cuda`` where PyTorch is built with
    CUDA (a card need not be there), else ``cpu``."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_template(cfg, shape, make_leaf: Optional[Callable] = None
                   ) -> Dict[str, torch.Tensor]:
    """Stand-ins (``meta`` tensors, or ``make_leaf(shape, dtype)``) for
    every model input: ``tokens`` (B, S) int32, (B, S, K) with codebooks,
    one token a sequence for decode; fp32 ``prefix_embeds`` and
    ``memory_embeds`` where the config has them, except in decode."""
    make_leaf = make_leaf or _meta
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    tshape = (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    t = {"tokens": make_leaf(tshape, torch.int32)}
    if cfg.n_prefix_embeds and shape.kind != "decode":
        t["prefix_embeds"] = make_leaf(
            (B, cfg.n_prefix_embeds, cfg.d_model), torch.float32)
    if cfg.n_memory_embeds and shape.kind != "decode":
        t["memory_embeds"] = make_leaf(
            (B, cfg.n_memory_embeds, cfg.d_model), torch.float32)
    return t


def input_specs(cfg, shape, mesh: Mesh, mode: FakeTensorMode
                ) -> Tuple[Tuple, Tuple, Dict[str, Any]]:
    """``(args, specs, meta)`` of the step this shape traces: ``args``
    fake tensors on :func:`template_device` made under ``mode`` (params,
    then the optimizer state and batch, the batch, or the tokens, decode
    caches and position), ``specs`` their partition specs on ``mesh``
    (``None`` for the position), ``meta`` the step's kind."""
    device = template_device()

    def fake(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    with mode:
        params = map_leaves(
            lambda s: fake(s.shape, dtypes.lookup(s.dtype).torch),
            M.param_shapes(cfg))
        batch = batch_template(cfg, shape, fake)
    pspec = param_pspecs(cfg, params, mesh)
    bspec = batch_pspecs(cfg, shape.kind, batch, mesh)
    if shape.kind == "train":
        with mode:
            params = map_leaves(lambda t: t.requires_grad_(True), params)
            opt = init_opt_state(params)
        ospec = opt_pspecs(cfg, params, mesh)
        return ((params, opt, batch), (pspec, ospec, bspec),
                {"step": "train"})
    if shape.kind == "prefill":
        return (params, batch), (pspec, bspec), {"step": "prefill"}
    # decode: one new token against a seq_len-deep cache
    long_ctx = shape.seq_len > LONG_CONTEXT_SEQ
    with mode:
        caches = cache_template(cfg, shape.global_batch, shape.seq_len,
                                make_leaf=fake)
    cspec = cache_pspecs(cfg, caches, mesh, long_context=long_ctx)
    args = (params, batch["tokens"], caches, shape.seq_len - 1)
    return (args, (pspec, bspec["tokens"], cspec, None),
            {"step": "decode", "long_context": long_ctx})


def model_flops_global(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active
    params."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token a seq


def _storages(tree: Any) -> set:
    return {analysis.local(t).untyped_storage()._cdata for t in leaves(tree)
            if isinstance(t, torch.Tensor)}


@contextlib.contextmanager
def fake_process_group(world: int):
    """The default process group, a fake one of ``world`` ranks with this
    process as rank 0 (``torch.distributed``'s ``fake`` backend: every
    collective returns at once and moves nothing), destroyed on the way
    out. Raises ``RuntimeError`` when a default group exists already."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            "the sharded dry run traces on a fake process group of its own, "
            "and this process already has a default process group (a rank "
            "of a run?): run the dry run in a process without one")
    # registers the ``fake`` backend where PyTorch does not build it in
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _mesh_axes(shape, mode: str):
    """The reference's settings for the trace: the logical ``seq`` axis on
    ``data`` for long-context decode, the batch over ``("data",
    "model")`` in ``fsdp``; both cleared on the way out."""
    long_ctx = shape.kind == "decode" and shape.seq_len > LONG_CONTEXT_SEQ
    shctx.set_seq_axis("data" if long_ctx else None)
    shctx.set_batch_axes(("data", "model") if mode == "fsdp" else None)
    try:
        yield
    finally:
        shctx.set_seq_axis(None)
        shctx.set_batch_axes(None)


def _step_for(cfg, kind: str):
    """The step of ``kind`` and the positions of its arguments it updates
    in place."""
    if kind == "train":
        return make_train_step(cfg, AdamWConfig()), (0, 1)
    if kind == "prefill":
        return make_prefill_step(cfg), ()
    return make_decode_step(cfg), (2,)


def dryrun_record(cfg, shape, mesh: Mesh, *, donate: bool = True,
                  record_ops: bool = False) -> Dict[str, Any]:
    """Trace ``cfg``'s step for ``shape`` once, sharded on ``mesh``
    when it has several devices (a fake process group of its size, owned
    for the trace), and return the record's step, ``fake_device``,
    ``trace_s``, ``roofline``, ``n_params`` and ``n_active_params``;
    with ``record_ops`` also ``ops`` (each counted operator's
    :class:`~repro_torch.launch.analysis.OpRecord` as a dict, in trace
    order) and ``op_profile`` (their kinds' counts and result bytes)."""
    mode = FakeTensorMode()
    args, specs, meta = input_specs(cfg, shape, mesh, mode)
    step, aliased = _step_for(cfg, shape.kind)
    n_dev = int(mesh.devices.size)
    if n_dev == 1:
        traced = analysis.trace_step(step, args, mode, record_ops)
        return _record(cfg, shape, meta, args, traced, aliased, n_dev,
                       donate)
    from torch.distributed.device_mesh import init_device_mesh
    with fake_process_group(n_dev), _mesh_axes(shape, cfg.sharding_mode):
        dm = init_device_mesh(template_device().type,
                              tuple(mesh.devices.shape),
                              mesh_dim_names=tuple(mesh.axis_names))
        # the fake tensors carry their mode; the mesh's rank grid is real
        args = distribute_tree(args, specs, dm)
        with shctx.activate(dm):
            traced = analysis.trace_step(step, args, mode, record_ops)
        return _record(cfg, shape, meta, args, traced, aliased, n_dev,
                       donate)


def _record(cfg, shape, meta, args, traced, aliased, n_dev: int,
            donate: bool) -> Dict[str, Any]:
    # every figure is rank 0's: its shards of the arguments, of the
    # outputs in storage of their own, and its temp storage; an output
    # that is an argument updated in place counts that argument's share
    held = [analysis.local_nbytes(a) for a in args]
    aliased_dev = sum(held[i] for i in aliased)
    arg_storage = _storages(args)
    fresh = sum(analysis.local_nbytes(t) for t in leaves(traced.outputs)
                if isinstance(t, torch.Tensor)
                and analysis.local(t).untyped_storage()._cdata
                not in arg_storage)
    memory = {"argument_size_in_bytes": sum(held),
              "output_size_in_bytes": aliased_dev + fresh,
              "alias_size_in_bytes": aliased_dev if donate else 0,
              "temp_size_in_bytes": traced.peak_temp_bytes}
    record = dict(meta)
    record["fake_device"] = template_device().type
    record["trace_s"] = traced.trace_s
    record["roofline"] = analysis.roofline(
        traced, n_devices=n_dev,
        model_flops_global=model_flops_global(cfg, shape), memory=memory)
    record["n_params"] = cfg.n_params()
    record["n_active_params"] = cfg.n_active_params()
    if traced.ops is not None:
        record["ops"] = [dataclasses.asdict(o) for o in traced.ops]
        record["op_profile"] = analysis.op_profile(traced.ops)
    return record


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               mode: str = "2d", donate: bool = True,
               overrides: Optional[Dict[str, Any]] = None,
               verbose: bool = True,
               record_ops: bool = False) -> Dict[str, Any]:
    """The reference's ``run_dryrun``: one (arch x shape x mesh) record,
    or the skip record of ``long_500k`` on a config that is not
    ``long_context_ok``; ``record_ops`` as :func:`dryrun_record`'s."""
    shape = INPUT_SHAPES[shape_name]
    kvb = min(4096, max(1024, shape.seq_len // 8))
    kw = {"sharding_mode": mode, "attn_kv_block": kvb}
    kw.update(overrides or {})
    cfg = get_config(arch)
    unknown = sorted(set(kw) - {f.name for f in dataclasses.fields(cfg)})
    if unknown:
        raise ValueError(
            f"the port's ModelConfig has no field {unknown}: it carries no "
            f"mesh field, and no analysis_unroll (its layer loop is always "
            f"unrolled)")
    cfg = dataclasses.replace(cfg, **kw)
    if shape.kind == "decode" and shape.seq_len > LONG_CONTEXT_SEQ \
            and not cfg.long_context_ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "pure full-attention architecture; long_500k "
                          "requires sub-quadratic attention (DESIGN.md §4)"}
    debug_mesh = os.environ.get("REPRO_DRYRUN_MESH")
    if debug_mesh:  # e.g. "4,4" or "2,4,4": small-scale debugging only
        dims = tuple(int(x) for x in debug_mesh.split(","))
        axes = ("pod", "data", "model")[-len(dims):]
        mesh = make_abstract_mesh(dims, axes)
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mode": mode,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "axes": list(mesh.axis_names), "n_devices": int(mesh.devices.size),
        "overrides": dict(overrides or {}),
    }
    record.update(dryrun_record(cfg, shape, mesh, donate=donate,
                                record_ops=record_ops))
    if verbose:
        roof = record["roofline"]
        print(f"[{arch} x {shape_name} x {record['mesh']}] "
              f"trace={record['trace_s']:.1f}s")
        print("  memory:", json.dumps(roof["memory"]))
        print("  terms:", json.dumps(roof["terms"]))
        print("  dominant:", roof["dominant"],
              f"useful_flops_ratio={roof['useful_flops_ratio']:.3f}")
    return record


def _parse_value(v: str) -> Any:
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="2d",
                    choices=["2d", "tp_zero1", "fsdp"])
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="ModelConfig override, e.g. --set "
                         "attn_kv_block=2048 --set remat=false "
                         "(repeatable)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _parse_value(v)
    rec = run_dryrun(args.arch, args.shape, multi_pod=args.multi_pod,
                     mode=args.mode, donate=not args.no_donate,
                     overrides=overrides)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
        print("wrote", args.out)
    if rec.get("skipped"):
        print(f"SKIPPED: {rec['reason']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

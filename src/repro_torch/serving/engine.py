"""Serving: restore a training checkpoint's parameters, prefill a prompt
batch, decode greedily (port of ``repro/serving/engine.py`` for every
block type: ``full``, ``window`` and ``chunked`` self-attention, ``xattn``
blocks with a conditioning memory, the MoE ones, the RG-LRU's ``rec`` and
RWKV6's ``rwkv``; parallel codebooks and the prefix-LM's patch prefix).

``prefill_step`` consumes a full prompt and returns (last-token logits,
decode caches); ``decode_step`` consumes one token and the caches.
PyTorch runs eagerly, so the steps are plain functions where the JAX
package jits them, and they run under ``torch.no_grad()``. Everything
stays on the device of the params: on a card a prompt longer than 2,048
tokens goes through the flash-attention kernel, decode through the direct
attention path over a linear cache (``full``) or a ring (``window``,
``chunked``), the recurrent blocks by one step of their recurrence from
the carried state. Cache templates are ``meta`` tensors, PyTorch's
shape-and-dtype stand-ins for ``jax.ShapeDtypeStruct``.

Under an active mesh (:mod:`repro_torch.sharding.context`) with
``DTensor`` params and prompt, the prefill lays its caches out by
:func:`~repro_torch.sharding.partition.cache_pspecs` (the batch over the
batch axes, or for a long-context batch-1 prompt the KV sequence over
``data`` once ``set_seq_axis("data")`` maps the ``seq`` axis; the KV
sequence over ``model`` under ``decode_kv_seq_shard``), and decode writes
each new slot into the rank that holds it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import dtypes
from repro_torch.core.checkpoint import restore_from_repository
from repro_torch.core.restore import RestoreEngine, RestoreStats
from repro_torch.core.tree import leaves
from repro_torch.fleet import FleetFabric
from repro_torch.models import model as M
from repro_torch.models.model import ATTN_TYPES, attn_kind
from repro_torch.sharding import context as shctx
from repro_torch.storage.repository import CheckpointRepository


def _device_of(tree: Any) -> torch.device:
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("the params template holds no tensor")


def load_params_for_serving(directory: str, params_template: Any,
                            step: Optional[int] = None,
                            threads: Optional[int] = None,
                            throttle_mbps: Optional[float] = None,
                            repository: Optional[CheckpointRepository] = None,
                            fleet: Optional[Any] = None
                            ) -> Tuple[Any, RestoreStats]:
    """Restore *model parameters only* from a training checkpoint.

    Serving needs no optimizer state, so this restores the ``model``
    sub-tree alone through the manager's selective-restore path
    (:func:`repro_torch.core.checkpoint.restore_from_repository` with
    ``domains=("model",)``): only the parameters' byte ranges are read
    from the (much larger) training checkpoint, a delta step replays its
    chain after verifying it, and ``step=None`` takes the newest committed
    step that restores. The params come back on the device of
    ``params_template``'s tensors (their shapes and dtypes must match the
    saved ones), and the chain verify and fold run there too. Any
    engine's format restores; ``throttle_mbps`` emulates per-stream
    storage bandwidth on the reads (:class:`RestoreEngine`).

    Step resolution goes through the checkpoint repository: only
    *committed* steps are eligible, and a step evicted from the local tier
    is re-hydrated from the first remote tier holding a complete copy.
    Pass ``repository`` (the port's :class:`CheckpointRepository`,
    configured with the training job's remote tiers) to serve from remote
    storage; otherwise a local-tier view of ``directory`` is used.

    ``fleet`` attaches a :class:`~repro_torch.fleet.FleetFabric` to the
    repository for the fleet warm-start path: concurrent replicas loading
    the same step share one remote read per object through the fabric's
    read-through cache and peer slice exchange, and replicas already
    holding the step's chain prefix pull only the delta chain. The fabric
    stays attached (it is shared, idempotent state); pass
    ``repository.attach_fleet(None)`` to detach. A repository or fabric
    of another package (the JAX one) is refused.

    Returns ``(params, stats)``; ``stats.bytes_read`` shows the sub-tree
    effect.
    """
    device = _device_of(params_template)
    repo = repository
    if repo is None:
        repo = CheckpointRepository(directory, device=device,
                                    auto_cascade=False, auto_gc=False)
    elif not isinstance(repo, CheckpointRepository):
        raise TypeError(
            f"repository={type(repo).__name__}: pass the port's "
            f"repro_torch CheckpointRepository")
    if fleet is not None:
        if not isinstance(fleet, FleetFabric):
            raise TypeError(
                f"fleet={type(fleet).__name__}: pass the port's "
                f"repro_torch FleetFabric")
        repo.attach_fleet(fleet)
    engine = RestoreEngine(device, threads=threads,
                           throttle_mbps=throttle_mbps)
    tree, stats, _step = restore_from_repository(
        repo, {"model": params_template}, step=step, engine=engine,
        domains=("model",))
    return tree["model"], stats


def make_prefill_step(cfg) -> Callable:
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, caches = M.forward(cfg, params, batch,
                                       collect_caches=True)
            if shctx.active_mesh() is not None:
                caches = lay_out_caches(cfg, caches, shctx.active_mesh())
        return logits[:, -1:, :], caches
    return prefill_step


def lay_out_caches(cfg, caches, device_mesh):
    """``DTensor`` caches redistributed to the layout
    :func:`~repro_torch.sharding.partition.cache_pspecs` gives them on
    ``device_mesh`` (the reference places its caches by the same specs),
    long-context when the ``seq`` axis is mapped."""
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.sharding.partition import cache_pspecs, placements_for
    from repro_torch.sharding.sharded import _spec_at
    specs = cache_pspecs(cfg, caches, virtual_mesh(device_mesh),
                         long_context=shctx.seq_axis_active())
    flat, unflatten = flatten_with_path(caches)
    return unflatten([
        leaf.redistribute(device_mesh,
                          placements_for(_spec_at(specs, path), device_mesh))
        for path, leaf in flat])


def make_decode_step(cfg) -> Callable:
    def decode_step(params, tokens, caches, pos):
        with torch.no_grad():
            return M.decode(cfg, params, {"tokens": tokens}, caches, pos)
    return decode_step


# ---------------------------------------------------------------- templates
def _cache_entry_shapes(cfg, btype: str, batch: int, seq_len: int
                        ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of one layer's decode cache (without the stack
    dimension): ``k``, ``v`` of ``seq_len`` slots, or of the window or
    chunk where that is shorter, and for ``xattn`` the memory's ``mk``,
    ``mv``; for ``rec`` the fp32 state ``h`` and the convolution's last
    ``conv_width - 1`` inputs; for ``rwkv`` the token-shift carries
    ``x_t``, ``x_c`` and the fp32 WKV state ``S``."""
    dt = dtypes.lookup(cfg.dtype).torch
    f32 = torch.float32
    if btype == "rec":
        return {"h": ((batch, cfg.d_rnn), f32),
                "conv": ((batch, cfg.conv_width - 1, cfg.d_rnn), dt)}
    if btype == "rwkv":
        hs = cfg.rwkv_head_size
        H = cfg.d_model // hs
        return {"x_t": ((batch, cfg.d_model), dt),
                "S": ((batch, H, hs, hs), f32),
                "x_c": ((batch, cfg.d_model), dt)}
    if btype not in ATTN_TYPES:
        raise ValueError(btype)
    kind = attn_kind(btype)
    T = seq_len
    if kind == "window":
        T = min(cfg.window, seq_len)
    elif kind == "chunked":
        T = min(cfg.chunk, seq_len)
    shape = (batch, T, cfg.n_kv_heads, cfg.hd)
    e = {"k": (shape, dt), "v": (shape, dt)}
    if btype == "xattn":
        mem = (batch, cfg.n_memory_embeds, cfg.n_kv_heads, cfg.hd)
        e["mk"] = (mem, dt)
        e["mv"] = (mem, dt)
    return e


def cache_template(cfg, batch: int, seq_len: int,
                   make_leaf: Optional[Callable] = None) -> Tuple:
    """The caches' tree of ``meta`` tensors (or of ``make_leaf(shape,
    dtype)``), stacked over each group's repeat count."""
    if make_leaf is None:
        def make_leaf(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
    groups = []
    for pattern, count in cfg.layer_groups:
        per_pos = []
        for btype in pattern:
            entries = _cache_entry_shapes(cfg, btype, batch, seq_len)
            per_pos.append({k: make_leaf((count,) + shape, dt)
                            for k, (shape, dt) in entries.items()})
        groups.append(tuple(per_pos))
    return tuple(groups)


def zero_caches(cfg, batch: int, seq_len: int,
                device: torch.device = "cuda") -> Tuple:
    return cache_template(
        cfg, batch, seq_len,
        make_leaf=lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                device=device))


def greedy_generate(cfg, params, prompt_batch: Dict[str, torch.Tensor],
                    n_new: int) -> torch.Tensor:
    """Prefill ``prompt_batch`` (``tokens`` (B, S), or (B, S, K) with
    codebooks, ``memory_embeds`` where the config has a memory and
    ``prefix_embeds`` where it is a prefix-LM) and decode ``n_new`` tokens
    greedily (argmax of the fp32 last-position logits); returns them as
    (B, n_new) int32, or (B, n_new, K). A full cache has ``n_new`` slots
    after the prompt (``max_decode_len``); token ``i`` is decoded at
    position ``S + n_prefix_embeds + i``. As in the reference, the loop
    decodes once more after the last token it returns."""
    cfg = dataclasses.replace(cfg, max_decode_len=n_new)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    logits, caches = prefill(params, prompt_batch)
    B, S = prompt_batch["tokens"].shape[:2]
    S += cfg.n_prefix_embeds  # the prefix-LM's patch positions

    def next_tokens(logits):
        last = torch.argmax(logits[:, -1].to(torch.float32), dim=-1) \
            .to(torch.int32)
        if cfg.n_codebooks:
            return last.reshape(B, 1, cfg.n_codebooks)
        return last.reshape(B, 1)

    out = []
    nxt = next_tokens(logits)
    for i in range(n_new):
        out.append(nxt)
        logits, caches = decode(params, nxt, caches, S + i)
        nxt = next_tokens(logits)
    return torch.cat(out, dim=1)

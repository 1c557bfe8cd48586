"""The attention-family models: parameter trees, forward, decode and loss
(port of ``repro/models/model.py`` for the ``full``, ``window``,
``chunked`` and ``xattn`` block types).

:func:`param_shapes` reproduces the tree of ``init_params`` exactly —
``{"embed": {"embed"[, "head"]}, "ln_f": norm, "groups": ((stacked block,
...), ...)}`` with each block ``{"attn": {wq, wk, wv, wo[, bq, bk, bv,
bo]}, "ffn": {w_up, w_down[, w_gate][, b_up, b_down]}, "ln1": norm,
"ln2": norm}`` (plus ``"lnx"`` and ``"xattn"`` for ``xattn`` blocks)
stacked over the group's repeat count, a norm being ``{scale[, bias]}``
— so state built here checkpoints under the same tensor names as the
JAX package's. Matrices and projection biases are in ``cfg.dtype``
(bf16), norm scales and biases in fp32. The MoE, recurrent and RWKV
block types and the prefix-LM are refused (they come with hd 256 and
new block types in a later slice).

:func:`forward` runs the stacked groups with a Python loop over the
repeat index where the JAX package scans, slicing each stacked leaf, so
the parameters keep their tree and the names the checkpoint resolves.
With ``collect_caches`` it also returns the decode caches that
:func:`decode` reads and writes, in the JAX package's cache tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import dtypes
from repro_torch.core.tree import map_leaves

from . import layers

#: the block types the port runs (the reference's ``ATTN_TYPES`` without
#: the ``*_moe`` ones)
ATTN_TYPES = ("full", "window", "chunked", "xattn")


def attn_kind(btype: str) -> str:
    """The self-attention mask of a block type."""
    return btype.split("_")[0] if btype != "xattn" else "full"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape, dtype name, and how it starts:
    ``init="normal"`` times ``scale``, or ``"ones"`` (norm scales) or
    ``"zeros"`` (biases)."""

    shape: Tuple[int, ...]
    dtype: str
    scale: float = 0.0
    init: str = "normal"


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    if cfg.n_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name}: the prefix-LM (n_prefix_embeds="
            f"{cfg.n_prefix_embeds}) is not yet ported (slice 14, with "
            f"hd 256)")
    for pattern, _count in cfg.layer_groups:
        for btype in pattern:
            if btype not in ATTN_TYPES:
                raise NotImplementedError(
                    f"{cfg.name}: block type {btype!r} is not yet ported "
                    f"(slice 14)")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"{cfg.name}: norm {cfg.norm!r}")


def _norm(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    d = (cfg.d_model,)
    p = {"scale": ParamSpec(c + d, "float32", init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = ParamSpec(c + d, "float32", init="zeros")
    return p


def _attention(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    dt = cfg.dtype
    p = {"wq": ParamSpec(c + (d, H * hd), dt, s),
         "wk": ParamSpec(c + (d, KV * hd), dt, s),
         "wv": ParamSpec(c + (d, KV * hd), dt, s),
         "wo": ParamSpec(c + (H * hd, d), dt,
                         s / math.sqrt(2 * cfg.n_layers))}
    if cfg.use_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd),
                        ("bo", d)):
            p[name] = ParamSpec(c + (n,), dt, init="zeros")
    return p


def _ffn(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    s_in = 1.0 / math.sqrt(d)
    p = {"w_up": ParamSpec(c + (d, f), dt, s_in),
         "w_down": ParamSpec(c + (f, d), dt, 1.0 / math.sqrt(f)
                             / math.sqrt(2 * cfg.n_layers))}
    if cfg.act != "gelu_mlp":  # gated variants
        p["w_gate"] = ParamSpec(c + (d, f), dt, s_in)
    if cfg.use_bias:
        p["b_up"] = ParamSpec(c + (f,), dt, init="zeros")
        p["b_down"] = ParamSpec(c + (d,), dt, init="zeros")
    return p


def _block(cfg, btype: str, count: int) -> Dict[str, Any]:
    c = (count,)
    p = {"attn": _attention(cfg, c), "ffn": _ffn(cfg, c),
         "ln1": _norm(cfg, c), "ln2": _norm(cfg, c)}
    if btype == "xattn":
        p["lnx"] = _norm(cfg, c)
        p["xattn"] = _attention(cfg, c)
    return p


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree with :class:`ParamSpec` leaves."""
    check_supported(cfg)
    n_out = (cfg.n_codebooks or 1) * cfg.vocab
    embed = {"embed": ParamSpec((n_out, cfg.d_model), cfg.dtype, 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, n_out), cfg.dtype, 0.02)
    groups = tuple(tuple(_block(cfg, btype, count) for btype in pattern)
                   for pattern, count in cfg.layer_groups)
    return {"embed": embed, "ln_f": _norm(cfg, ()), "groups": groups}


def init_params(cfg, generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Random parameters from ``generator`` (normal * scale, cast to the
    leaf dtype; norm scales ones, biases zeros), made on ``device``.
    Different numbers than JAX's for the same seed; tests that compare the
    packages feed both the same numpy state through
    :mod:`repro_torch.convert`."""
    def make(spec: ParamSpec) -> torch.Tensor:
        dt = dtypes.lookup(spec.dtype).torch
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        x = torch.randn(spec.shape, generator=generator, device=device)
        return x.mul_(spec.scale).to(dt)
    return map_leaves(make, param_shapes(cfg))


# ------------------------------------------------------------------ forward
def block_forward(cfg, btype: str, p: Dict[str, Any], x: torch.Tensor, *,
                  positions: torch.Tensor, memory: Optional[torch.Tensor],
                  collect_cache: bool):
    """One block: pre-norm self-attention under the block's mask, for
    ``xattn`` pre-norm cross-attention to ``memory``, then the pre-norm
    FFN, each added to the residual in ``x.dtype``. Returns ``(x,
    cache)``, the cache ``None`` unless ``collect_cache``."""
    h = layers.apply_norm(p["ln1"], x)
    a, (k, v) = layers.attention(cfg, p["attn"], h, positions=positions,
                                 kind=attn_kind(btype))
    x = x + a.to(x.dtype)
    if btype == "xattn":
        hx = layers.apply_norm(p["lnx"], x)
        mk, mv = layers.memory_kv(cfg, p["xattn"], memory)
        x = x + layers.cross_attention(cfg, p["xattn"], hx, mk,
                                       mv).to(x.dtype)
    h2 = layers.apply_norm(p["ln2"], x)
    x = x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype)
    cache = None
    if collect_cache:
        cache = _cache_from_kv(cfg, btype, k, v)
        if btype == "xattn":
            cache["mk"], cache["mv"] = mk, mv
    return x, cache


def _cache_from_kv(cfg, btype: str, k: torch.Tensor,
                   v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The decode cache of a block from its prefill K/V (B, S, KV, hd).

    ``full``: the prompt's positions then ``cfg.max_decode_len`` empty
    slots for the tokens generated after it. ``window``: a ring of
    ``cfg.window`` slots holding the last ``window`` positions at slots
    ``pos % window``. ``chunked``: a ring of ``cfg.chunk`` slots holding
    the current (possibly empty) partial chunk at slots ``[0, S %
    chunk)``. A prompt shorter than the ring is padded."""
    B, S = k.shape[0], k.shape[1]
    kind = attn_kind(btype)
    pad = torch.nn.functional.pad
    if kind == "full":
        if cfg.max_decode_len:
            tail = (0, 0, 0, 0, 0, cfg.max_decode_len)
            return {"k": pad(k, tail), "v": pad(v, tail)}
        return {"k": k, "v": v}
    T = cfg.window if kind == "window" else cfg.chunk
    if S <= T:
        return {"k": pad(k, (0, 0, 0, 0, 0, T - S)),
                "v": pad(v, (0, 0, 0, 0, 0, T - S))}
    ck = torch.zeros((B, T) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    cv = torch.zeros_like(ck)
    if kind == "window":
        slots = torch.arange(S - T, S, device=k.device) % T
        ck[:, slots] = k[:, -T:]
        cv[:, slots] = v[:, -T:]
    else:
        r = S % T
        if r:
            ck[:, :r] = k[:, -r:]
            cv[:, :r] = v[:, -r:]
    return {"k": ck, "v": cv}


def _embed(cfg, params: Dict[str, Any],
           tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times ``sqrt(d_model)`` in the working dtype."""
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def _embed_inputs(cfg, params: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(x, memory)``: the prompt's embeddings (:func:`_embed`), and the
    conditioning memory (``memory_embeds`` cast to their dtype) of a
    config with ``n_memory_embeds``, else ``None``."""
    x = _embed(cfg, params, batch["tokens"])
    memory = None
    if cfg.n_memory_embeds:
        memory = batch["memory_embeds"].to(x.dtype)
    return x, memory


def forward(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            *, collect_caches: bool = False):
    """Full-sequence forward; returns the logits (B, S, vocab) (B, S, K,
    vocab with codebooks), or ``(logits, caches)`` with
    ``collect_caches``: the decode caches in the JAX package's tree, one
    tuple per layer group of one dict per pattern position (``k``, ``v``,
    and ``mk``, ``mv`` for ``xattn``), each leaf stacked over the group's
    repeat index."""
    check_supported(cfg)
    x, memory = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = layers.positions_for(B, S, x.device)
    caches = []
    for (pattern, count), stacked in zip(cfg.layer_groups,
                                         params["groups"]):
        per_pos = [[] for _ in pattern]
        for i in range(count):
            for j, (btype, pp) in enumerate(zip(pattern, stacked)):
                x, cache = block_forward(
                    cfg, btype, map_leaves(lambda t: t[i], pp), x,
                    positions=positions, memory=memory,
                    collect_cache=collect_caches)
                per_pos[j].append(cache)
        if collect_caches:
            caches.append(tuple(
                {key: torch.stack([c[key] for c in cs]) for key in cs[0]}
                for cs in per_pos))
    x = layers.apply_norm(params["ln_f"], x)
    logits = layers.logits_from_hidden(cfg, params["embed"], x)
    return (logits, tuple(caches)) if collect_caches else logits


def block_decode(cfg, btype: str, p: Dict[str, Any], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    """One block on one token at ``pos``; the cache's k and v are written
    in place (:func:`layers.decode_attention`, a ring for ``window`` and
    ``chunked``), so only x comes back. ``xattn`` reads the memory's K/V
    from the cache."""
    h = layers.apply_norm(p["ln1"], x)
    a, _k, _v = layers.decode_attention(cfg, p["attn"], h, cache["k"],
                                        cache["v"], pos,
                                        mode=attn_kind(btype))
    x = x + a.to(x.dtype)
    if btype == "xattn":
        hx = layers.apply_norm(p["lnx"], x)
        x = x + layers.cross_attention(cfg, p["xattn"], hx, cache["mk"],
                                       cache["mv"]).to(x.dtype)
    h2 = layers.apply_norm(p["ln2"], x)
    return x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def decode(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
           caches, pos: int):
    """One-token decode. ``batch["tokens"]``: (B, 1), or (B, 1, K) with
    codebooks. Returns ``(logits, caches)``; each layer's cache slice is
    written in place, so the stacked cache tensors that come back are the
    ones passed in."""
    check_supported(cfg)
    x = _embed(cfg, params, batch["tokens"])
    for (pattern, count), stacked, gcache in zip(
            cfg.layer_groups, params["groups"], caches):
        for i in range(count):
            for btype, pp, cc in zip(pattern, stacked, gcache):
                x = block_decode(cfg, btype, map_leaves(lambda t: t[i], pp),
                                 x, {key: t[i] for key, t in cc.items()},
                                 pos)
    x = layers.apply_norm(params["ln_f"], x)
    return layers.logits_from_hidden(cfg, params["embed"], x), caches


def loss_fn(cfg, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy: ``logsumexp`` over fp32 logits of the
    positions ``[:-1]`` minus the gold logit, averaged (over every
    codebook too)."""
    logits = forward(cfg, params, batch)
    tgt = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return (logz - gold).mean()

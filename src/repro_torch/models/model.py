"""The dense models: parameter trees, forward and loss (port of the dense
half of ``repro/models/model.py``).

:func:`param_shapes` reproduces the tree of ``init_params`` exactly —
``{"embed": {"embed"}, "ln_f": {"scale"}, "groups": ((stacked block, ...),
...)}`` with each block ``{"attn": {wq, wk, wv, wo}, "ffn": {w_up, w_down,
w_gate}, "ln1": {scale}, "ln2": {scale}}`` stacked over the group's
repeat count — so state built here checkpoints under the same tensor
names as the JAX package's. Matrices are in ``cfg.dtype`` (bf16), norm
scales in fp32.

:func:`forward` runs the stacked groups with a Python loop over the
repeat index where the JAX package scans, slicing each stacked leaf, so
the parameters keep their tree and the names the checkpoint resolves.
With ``collect_caches`` it also returns the decode caches that
:func:`decode` reads and writes, in the JAX package's cache tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import dtypes
from repro_torch.core.tree import map_leaves

from . import layers


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape, dtype name, and init scale (0 marks a
    norm scale, initialised to ones)."""

    shape: Tuple[int, ...]
    dtype: str
    scale: float


def _block(cfg, count: int) -> Dict[str, Any]:
    if cfg.norm != "rmsnorm" or cfg.use_bias or cfg.act == "gelu_mlp":
        raise NotImplementedError(
            f"{cfg.name}: only bias-free rmsnorm gated-FFN blocks are ported")
    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    s = 1.0 / math.sqrt(d)
    out_s = 1.0 / math.sqrt(2 * cfg.n_layers)
    dt = cfg.dtype
    c = (count,)
    return {
        "attn": {"wq": ParamSpec(c + (d, H * hd), dt, s),
                 "wk": ParamSpec(c + (d, KV * hd), dt, s),
                 "wv": ParamSpec(c + (d, KV * hd), dt, s),
                 "wo": ParamSpec(c + (H * hd, d), dt, s * out_s)},
        "ffn": {"w_up": ParamSpec(c + (d, f), dt, s),
                "w_down": ParamSpec(c + (f, d), dt,
                                     out_s / math.sqrt(f)),
                "w_gate": ParamSpec(c + (d, f), dt, s)},
        "ln1": {"scale": ParamSpec(c + (d,), "float32", 0.0)},
        "ln2": {"scale": ParamSpec(c + (d,), "float32", 0.0)},
    }


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree with :class:`ParamSpec` leaves."""
    embed = {"embed": ParamSpec((cfg.vocab, cfg.d_model), cfg.dtype, 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, cfg.vocab), cfg.dtype,
                                  0.02)
    groups = []
    for pattern, count in cfg.layer_groups:
        for btype in pattern:
            if btype != "full":
                raise NotImplementedError(
                    f"{cfg.name}: block type {btype!r} is not yet ported")
        groups.append(tuple(_block(cfg, count) for _ in pattern))
    return {"embed": embed,
            "ln_f": {"scale": ParamSpec((cfg.d_model,), "float32", 0.0)},
            "groups": tuple(groups)}


def init_params(cfg, generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Random parameters from ``generator`` (normal * scale, cast to the
    leaf dtype), made on ``device``. Different numbers than JAX's for the
    same seed; tests that compare the packages feed both the same numpy
    state through :mod:`repro_torch.convert`."""
    def make(spec: ParamSpec) -> torch.Tensor:
        dt = dtypes.lookup(spec.dtype).torch
        if spec.scale == 0.0:
            return torch.ones(spec.shape, dtype=dt, device=device)
        x = torch.randn(spec.shape, generator=generator, device=device)
        return x.mul_(spec.scale).to(dt)
    return map_leaves(make, param_shapes(cfg))


# ------------------------------------------------------------------ forward
def block_forward(cfg, p: Dict[str, Any], x: torch.Tensor, *,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One ``full`` block: pre-norm attention then pre-norm FFN, each added
    to the residual in ``x.dtype``. Returns ``(x, (k, v))``."""
    h = layers.apply_norm(p["ln1"], x)
    a, kv = layers.attention(cfg, p["attn"], h, positions=positions)
    x = x + a.to(x.dtype)
    h2 = layers.apply_norm(p["ln2"], x)
    return x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype), kv


def _cache_from_kv(cfg, k: torch.Tensor,
                   v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The decode cache of a ``full`` block from its prefill K/V, with
    ``cfg.max_decode_len`` empty slots after the prompt for the tokens
    generated after it."""
    if cfg.max_decode_len:
        pad = (0, 0, 0, 0, 0, cfg.max_decode_len)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}
    return {"k": k, "v": v}


def _check_full(cfg, pattern) -> None:
    if any(btype != "full" for btype in pattern):
        raise NotImplementedError(
            f"{cfg.name}: block types {pattern} are not yet ported")


def _embed_inputs(cfg, params: Dict[str, Any],
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times ``sqrt(d_model)`` in the working dtype."""
    x = layers.embed_tokens(params["embed"], tokens)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def forward(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            *, collect_caches: bool = False):
    """Full-sequence forward; returns the logits (B, S, vocab), or
    ``(logits, caches)`` with ``collect_caches``: the decode caches in the
    JAX package's tree, one tuple per layer group of one ``{"k", "v"}``
    dict per pattern position, each leaf stacked over the group's repeat
    index, ``(count, B, S + max_decode_len, KV, hd)``."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    positions = layers.positions_for(B, S, x.device)
    caches = []
    for (pattern, count), stacked in zip(cfg.layer_groups,
                                         params["groups"]):
        _check_full(cfg, pattern)
        per_pos = [[] for _ in pattern]
        for i in range(count):
            for j, pp in enumerate(stacked):
                x, (k, v) = block_forward(
                    cfg, map_leaves(lambda t: t[i], pp), x,
                    positions=positions)
                if collect_caches:
                    per_pos[j].append(_cache_from_kv(cfg, k, v))
        if collect_caches:
            caches.append(tuple(
                {key: torch.stack([c[key] for c in cs]) for key in ("k", "v")}
                for cs in per_pos))
    x = layers.apply_norm(params["ln_f"], x)
    logits = layers.logits_from_hidden(cfg, params["embed"], x)
    return (logits, tuple(caches)) if collect_caches else logits


def block_decode(cfg, p: Dict[str, Any], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    """One ``full`` block on one token at ``pos``; the cache's k and v are
    written in place (:func:`layers.decode_attention`), so only x comes
    back."""
    h = layers.apply_norm(p["ln1"], x)
    a, _k, _v = layers.decode_attention(cfg, p["attn"], h, cache["k"],
                                        cache["v"], pos)
    x = x + a.to(x.dtype)
    h2 = layers.apply_norm(p["ln2"], x)
    return x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def decode(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
           caches, pos: int):
    """One-token decode. ``batch["tokens"]``: (B, 1). Returns ``(logits,
    caches)``; each layer's cache slice is written in place, so the
    stacked cache tensors that come back are the ones passed in."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    for (pattern, count), stacked, gcache in zip(
            cfg.layer_groups, params["groups"], caches):
        _check_full(cfg, pattern)
        for i in range(count):
            for pp, cc in zip(stacked, gcache):
                x = block_decode(cfg, map_leaves(lambda t: t[i], pp), x,
                                 {key: cc[key][i] for key in ("k", "v")},
                                 pos)
    x = layers.apply_norm(params["ln_f"], x)
    return layers.logits_from_hidden(cfg, params["embed"], x), caches


def loss_fn(cfg, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy: ``logsumexp`` over fp32 logits of the
    positions ``[:-1]`` minus the gold logit, averaged."""
    logits = forward(cfg, params, batch)
    tgt = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return (logz - gold).mean()

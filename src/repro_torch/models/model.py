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
                  positions: torch.Tensor) -> torch.Tensor:
    """One ``full`` block: pre-norm attention then pre-norm FFN, each added
    to the residual in ``x.dtype``."""
    h = layers.apply_norm(p["ln1"], x)
    x = x + layers.attention(cfg, p["attn"], h,
                             positions=positions).to(x.dtype)
    h2 = layers.apply_norm(p["ln2"], x)
    return x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def _embed_inputs(cfg, params: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings times ``sqrt(d_model)`` in the working dtype."""
    x = layers.embed_tokens(params["embed"], batch["tokens"])
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def forward(cfg, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward; returns the logits (B, S, vocab)."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = layers.positions_for(B, S, x.device)
    for (pattern, count), stacked in zip(cfg.layer_groups,
                                         params["groups"]):
        if any(btype != "full" for btype in pattern):
            raise NotImplementedError(
                f"{cfg.name}: block types {pattern} are not yet ported")
        for i in range(count):
            for pp in stacked:
                x = block_forward(cfg, map_leaves(lambda t: t[i], pp), x,
                                  positions=positions)
    x = layers.apply_norm(params["ln_f"], x)
    return layers.logits_from_hidden(cfg, params["embed"], x)


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

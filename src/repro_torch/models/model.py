"""Parameter trees of the dense models (port of the init half of
``repro/models/model.py``; the forward pass comes with the training loop).

:func:`param_shapes` reproduces the tree of ``init_params`` exactly —
``{"embed": {"embed"}, "ln_f": {"scale"}, "groups": ((stacked block, ...),
...)}`` with each block ``{"attn": {wq, wk, wv, wo}, "ffn": {w_up, w_down,
w_gate}, "ln1": {scale}, "ln2": {scale}}`` stacked over the group's
repeat count — so state built here checkpoints under the same tensor
names as the JAX package's. Matrices are in ``cfg.dtype`` (bf16), norm
scales in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import dtypes
from repro_torch.core.tree import map_leaves


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

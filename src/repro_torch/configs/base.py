"""The dense-transformer subset of ``repro/configs/base.py``'s
``ModelConfig``: the fields that decide the parameter tree (and so the
checkpointed state) and those the dense forward reads (``rope_theta``,
``tie_embeddings``, ``norm``, ``act``, ``dtype``), the two the
serving path reads (``attn_kv_block``, ``max_decode_len``) and the one
the partition rules read (``sharding_mode``); none of the remat or
analysis flags."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

LayerGroups = Tuple[Tuple[Tuple[str, ...], int], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    layer_groups: LayerGroups
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (gated) | gelu (gated) | gelu_mlp
    source: str = ""
    dtype: str = "bfloat16"
    sharding_mode: str = "2d"        # "2d" (beyond-paper) | "tp_zero1" (paper)
    attn_kv_block: int = 1024        # KV block size for blocked attention
    max_decode_len: int = 0          # decode-cache headroom after prefill

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def uniform_groups(block: str, n_layers: int) -> LayerGroups:
    """All layers identical: one scan group."""
    return (((block,), n_layers),)


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """``repro.configs.base.smoke_variant`` for dense configs: 2 layers,
    d_model <= 256, 4 heads (2 KV heads when grouped), d_ff <= 512,
    vocab <= 512."""
    heads = 4 if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, heads) or (1 if heads else 0)
    if heads and cfg.n_kv_heads > 1:
        kv = 2
    types = []
    for pattern, _count in cfg.layer_groups:
        for t in pattern:
            if t not in types:
                types.append(t)
    pattern = tuple(types[:2]) if len(types) >= 2 \
        else (cfg.layer_groups[0][0][0],) * 2
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=len(pattern),
        d_model=min(cfg.d_model, 256), n_heads=heads, n_kv_heads=kv,
        head_dim=0, d_ff=min(cfg.d_ff, 512), vocab=min(cfg.vocab, 512),
        layer_groups=((pattern, 1),))

"""The port's copy of ``repro/configs/base.py``'s ``ModelConfig``: the
fields that decide the parameter tree (and so the checkpointed state) and
those the forward reads (``rope_theta``, ``window``, ``chunk``,
``use_bias``, ``tie_embeddings``, ``norm``, ``act``, the MoE fields, the
RWKV6 and RG-LRU fields, the modality stubs ``n_prefix_embeds``,
``n_memory_embeds`` and ``n_codebooks``, ``dtype``), the two the serving
path reads (``attn_kv_block``, ``max_decode_len``) and the one the
partition rules read (``sharding_mode``), and ``long_context_ok``, which
the dry run reads, the three mesh fields the sharded model reads
(``decode_kv_seq_shard``, ``ulysses_attention``,
``seq_parallel_residual``: activation constraints that only act under an
active mesh, :mod:`repro_torch.sharding.context`), and ``remat``: each
repeat of a layer group's pattern runs under activation checkpointing
in training (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body). The reference's
``analysis_unroll`` is left out: the port runs its layers in a Python
loop, always unrolled, so there is nothing to unroll. Block types:
``full``, ``window`` (sliding-window causal), ``chunked`` (block-local
causal), ``xattn`` (full self-attention plus cross-attention to a
conditioning memory), ``*_moe`` (the same attention, the FFN replaced by
a mixture of experts), ``rec`` (the RG-LRU block of Griffin) and
``rwkv`` (RWKV6 time-mix and channel-mix); a config with
``n_prefix_embeds`` is a prefix-LM (its patch prefix attends both
ways)."""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Dict, Tuple

LayerGroups = Tuple[Tuple[Tuple[str, ...], int], ...]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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
    window: int = 0                  # sliding-window size for "window" blocks
    chunk: int = 0                   # chunk size for "chunked" blocks
    use_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu | relu_sq (gated) | gelu_mlp
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 256        # tokens per dispatch group
    shared_expert: bool = False
    router_aux_coef: float = 0.01
    # --- recurrent (rwkv / rg-lru) ---
    rwkv_head_size: int = 64
    rwkv_chunk: int = 16
    rwkv_decay_lora: int = 64
    lru_width: int = 0               # 0 -> d_model
    conv_width: int = 4
    n_prefix_embeds: int = 0         # vlm: patch embeds prepended
    n_memory_embeds: int = 0         # audio: cross-attention memory length
    n_codebooks: int = 0             # audio: parallel codebook streams
    source: str = ""
    dtype: str = "bfloat16"
    sharding_mode: str = "2d"        # "2d" (beyond-paper) | "tp_zero1" (paper)
    attn_kv_block: int = 1024        # KV block size for blocked attention
    # beyond-paper: shard the decode KV cache on the sequence dim over
    # 'model' (heads and hd stay whole)
    decode_kv_seq_shard: bool = False
    # beyond-paper: DeepSpeed-Ulysses sequence-parallel attention — q, k, v
    # enter attention sequence-sharded over 'model'
    ulysses_attention: bool = False
    # beyond-paper: Megatron sequence parallelism — the residual stream
    # stays sequence-sharded over 'model' between blocks
    seq_parallel_residual: bool = False
    max_decode_len: int = 0          # decode-cache headroom after prefill
    # recompute each repeat of a layer group in the backward pass
    remat: bool = True
    long_context_ok: bool = False    # may run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def d_rnn(self) -> int:
        return self.lru_width or self.d_model

    def n_params(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def uniform_groups(block: str, n_layers: int) -> LayerGroups:
    """All layers identical: one scan group."""
    return (((block,), n_layers),)


def pattern_groups(pattern: Tuple[str, ...], n_layers: int) -> LayerGroups:
    """Repeat ``pattern``; a remainder prefix of the pattern becomes a
    second group (gemma3: 62 = 10 x (5 window + 1 full) + 2 window)."""
    reps, rem = divmod(n_layers, len(pattern))
    groups: LayerGroups = ()
    if reps:
        groups += ((tuple(pattern), reps),)
    if rem:
        groups += ((tuple(pattern[:rem]), 1),)
    return groups


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_configs() -> Tuple[str, ...]:
    """The names of every config module of this package, sorted."""
    from repro_torch import configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name != "base":
            importlib.import_module(f"repro_torch.configs.{m.name}")
    return tuple(sorted(_REGISTRY))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """``repro.configs.base.smoke_variant``: 2 layers keeping the first
    two block types of the config, d_model <= 256, 4 heads (2 KV heads
    when grouped), d_ff <= 512, vocab <= 512, at most 4 experts and top
    2 with dispatch groups of 16, window and chunk <= 16, the RG-LRU at
    d_model, RWKV6 chunks of 4, at most 4 prefix and memory embeddings;
    codebooks as they are; no remat."""
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
        layer_groups=((pattern, 1),),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        chunk=min(cfg.chunk, 16) if cfg.chunk else 0,
        lru_width=0, moe_group_size=16,
        n_prefix_embeds=min(cfg.n_prefix_embeds, 4),
        n_memory_embeds=min(cfg.n_memory_embeds, 4), rwkv_chunk=4,
        remat=False)

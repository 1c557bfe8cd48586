"""Gemma3-27B: 5:1 local(1024):global attention, 128k context, GQA.
[hf:google/gemma-3-1b-pt]"""
from .base import ModelConfig, register, pattern_groups

register(ModelConfig(
    name="gemma3-27b", arch_type="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262_144,
    layer_groups=pattern_groups(
        ("window",) * 5 + ("full",), 62),
    window=1024, rope_theta=1_000_000.0,
    head_dim=128,  # gemma3 uses explicit head_dim 128 (32*128 != d_model)
    tie_embeddings=True, norm="rmsnorm", act="gelu",
    source="hf:google/gemma-3-1b-pt",
    long_context_ok=True,  # 5/6 sliding window; global layers decode O(S)
))

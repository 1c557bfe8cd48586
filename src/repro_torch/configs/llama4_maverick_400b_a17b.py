"""Llama-4 Maverick 400B-A17B: interleaved MoE (128 experts top-1 + shared
expert on alternating layers), chunked local attention (8192) on 3/4 layers
with full ("NoPE") attention every 4th layer, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ModelConfig, register, pattern_groups

register(ModelConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202_048,
    # alternating dense/MoE FFN; every 4th layer full attention:
    # pattern of 4: (chunked+dense, chunked+moe, chunked+dense, full+moe)
    layer_groups=pattern_groups(
        ("chunked", "chunked_moe", "chunked", "full_moe"), 48),
    chunk=8192, rope_theta=500_000.0,
    n_experts=128, top_k=1, shared_expert=True,
    norm="rmsnorm", act="silu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    long_context_ok=True,  # chunked attention on 3/4 of layers
))

"""Llama-3.2-1B: small dense llama3, GQA. [hf:meta-llama/Llama-3.2-1B]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="llama3.2-1b", arch_type="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128_256,
    layer_groups=uniform_groups("full", 16),
    rope_theta=500_000.0,
    tie_embeddings=True, norm="rmsnorm", act="silu",
    source="hf:meta-llama/Llama-3.2-1B",
    long_context_ok=False,  # pure full attention -> long_500k skipped
))

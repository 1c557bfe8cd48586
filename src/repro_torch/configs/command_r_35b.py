"""Command-R 35B: dense GQA, no-bias, parallel-block-style large FFN.
[hf:CohereForAI/c4ai-command-r-v01]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="command-r-35b", arch_type="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256_000,
    layer_groups=uniform_groups("full", 40),
    rope_theta=8_000_000.0,
    use_bias=False, tie_embeddings=True, norm="layernorm", act="silu",
    source="hf:CohereForAI/c4ai-command-r-v01",
    long_context_ok=False,  # pure full attention -> long_500k skipped
))

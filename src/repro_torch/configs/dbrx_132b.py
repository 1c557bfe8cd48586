"""DBRX-132B: fine-grained MoE, 16 experts top-4, GQA. [hf:databricks/dbrx-base]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="dbrx-132b", arch_type="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    layer_groups=uniform_groups("full_moe", 40),
    n_experts=16, top_k=4,
    rope_theta=500_000.0, norm="layernorm", act="silu",
    source="hf:databricks/dbrx-base",
    long_context_ok=False,  # pure full attention -> long_500k skipped
))

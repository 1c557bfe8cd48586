"""PaliGemma-3B: SigLIP vision tower (STUB: precomputed patch embeddings) +
Gemma decoder with prefix-LM masking over the image prefix. [arXiv:2407.07726]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="paligemma-3b", arch_type="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257_216,
    layer_groups=uniform_groups("full", 18),
    head_dim=256, rope_theta=10_000.0,
    tie_embeddings=True, norm="rmsnorm", act="gelu",
    n_prefix_embeds=256,  # SigLIP 224px/14 -> 256 patches (stubbed)
    source="arXiv:2407.07726",
    long_context_ok=False,  # full attention -> long_500k skipped
))

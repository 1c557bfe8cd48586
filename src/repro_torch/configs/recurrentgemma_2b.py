"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 2 rec : 1 attn.
[arXiv:2402.19427]"""
from .base import ModelConfig, register, pattern_groups

register(ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256_000,
    # 26 = 8*(rec,rec,window) + (rec,rec)
    layer_groups=pattern_groups(("rec", "rec", "window"), 26),
    window=2048, rope_theta=10_000.0,
    tie_embeddings=True, norm="rmsnorm", act="gelu",
    lru_width=2560, conv_width=4,
    source="arXiv:2402.19427",
    long_context_ok=True,  # recurrent + local attention
))

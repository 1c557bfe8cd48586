"""StarCoder2-7B: dense GQA, RoPE, native 4k sliding window. [arXiv:2402.19173]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="starcoder2-7b", arch_type="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    layer_groups=uniform_groups("window", 32),
    window=4096, rope_theta=1_000_000.0,
    use_bias=True, norm="layernorm", act="gelu_mlp",
    source="arXiv:2402.19173",
    long_context_ok=True,  # sliding-window attention
))

"""RWKV6 (Finch) 7B: attention-free, data-dependent decay. [arXiv:2404.05892]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="rwkv6-7b", arch_type="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab=65536,
    layer_groups=uniform_groups("rwkv", 32),
    rwkv_head_size=64, rwkv_chunk=16, rwkv_decay_lora=64,
    norm="layernorm", act="relu_sq",  # rwkv channel-mix uses relu^2
    source="arXiv:2404.05892",
    long_context_ok=True,  # O(1) recurrent state
))

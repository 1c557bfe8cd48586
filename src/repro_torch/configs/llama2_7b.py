"""Llama-2-7B: the paper's own evaluation model family (Table II).
Used by the checkpointing benchmarks to mirror the paper's setup.
[arXiv:2307.09288]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="llama2-7b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32_000,
    layer_groups=uniform_groups("full", 32),
    rope_theta=10_000.0, norm="rmsnorm", act="silu",
    source="arXiv:2307.09288 (paper Table II)",
    long_context_ok=False,
))

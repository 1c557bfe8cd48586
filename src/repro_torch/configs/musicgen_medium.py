"""MusicGen-medium: decoder-only over EnCodec tokens (4 codebooks), with
cross-attention to text-conditioning memory. Frontend (EnCodec) is a stub:
the batch supplies precomputed conditioning embeddings
(``memory_embeds``).
[arXiv:2306.05284]"""
from .base import ModelConfig, register, uniform_groups

register(ModelConfig(
    name="musicgen-medium", arch_type="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    layer_groups=uniform_groups("xattn", 48),
    rope_theta=10_000.0, norm="layernorm", act="gelu_mlp",
    use_bias=True,
    n_codebooks=4, n_memory_embeds=64,
    source="arXiv:2306.05284",
    long_context_ok=False,  # full attention decoder -> long_500k skipped
))

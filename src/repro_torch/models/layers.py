"""Dense-transformer layers as plain functions on tensors (port of the
dense half of ``repro/models/layers.py``): rmsnorm, RoPE, the causal mask,
GQA attention on the direct and the blocked path, single-token decode
attention over a KV cache, the gated FFN, embedding and tied logits.
Parameters are dicts of tensors in the JAX package's tree; autograd gives
the backward of every path but the blocked one.

Cast points are the reference's. Norms and RoPE compute in fp32 and cast
back to the input dtype. On the direct path (and in decode) attention
logits are scaled in the working dtype, then softmaxed in fp32 under a
``-1e30`` mask and cast to ``v``'s dtype; on the blocked path q is scaled
in fp32 before the product (:mod:`repro_torch.kernels.flash_attention`).
A Python scalar that JAX applies to a bf16 array is cast to bf16 first
(weak typing), so it is applied here as a 0-d tensor of the working dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops

#: the longest sequence on the direct (materialised-logits) attention
#: path; longer ones take the blocked online-softmax path
DIRECT_SDPA_MAX_SEQ = 2048


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as JAX applies a Python scalar to ``like``: in its dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------- norms
def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope_frequencies(hd: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Rotates in fp32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- masks
def make_mask(seq_len: int, device: torch.device) -> torch.Tensor:
    """(S, S) causal mask (``kind="full"``, no prefix)."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    return j <= i


# ----------------------------------------------------------------- attention
def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd); GQA by grouping heads."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg, k) \
        / _scalar(math.sqrt(hd), q)
    logits = logits.to(torch.float32).masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkh->bskrh", probs, v)
    return out.reshape(B, S, H * hd)


def blocked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kind: str = "full", window: int = 0, chunk: int = 0,
                 kv_block: int = 1024) -> torch.Tensor:
    """Flash-style attention (port of ``repro.models.layers.blocked_sdpa``,
    forward only): an online softmax over KV blocks that never holds the
    (S, S) logits, through :func:`repro_torch.kernels.ops.flash_attention`
    — the hand-written kernel on a card, its plain version on the CPU. The
    reference's padding of S to a multiple of ``kv_block`` lives in the
    plain version; the kernel masks the ragged tail instead, and both give
    the same rows. Under grad it raises: the backward is not yet ported."""
    kvb = min(kv_block, q.shape[1])
    return ops.flash_attention(q, k, v, kind=kind, window=window,
                               chunk=chunk, kv_block=kvb)


def full_seq_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kv_block: int = 1024) -> torch.Tensor:
    """Causal self-attention over the whole sequence: the direct masked
    path up to :data:`DIRECT_SDPA_MAX_SEQ` tokens, the blocked path
    beyond."""
    S = q.shape[1]
    if S <= DIRECT_SDPA_MAX_SEQ:
        return _sdpa(q, k, v, make_mask(S, q.device))
    return blocked_sdpa(q, k, v, kv_block=kv_block)


def project_qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k and v (B,S,KV,hd) of x (B,S,d), q and k rotated at
    ``positions`` (B,S)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (train / prefill). x: (B,S,d).
    Returns ``(out, (k, v))`` with k after RoPE, for the decode cache."""
    q, k, v = project_qkv(cfg, p, x, positions)
    out = full_seq_sdpa(q, k, v, kv_block=cfg.attn_kv_block)
    return out @ p["wo"], (k, v)


def decode_attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode over a ``full`` cache (port of
    ``repro.models.layers.decode_attention`` with ``mode="full"``).
    x: (B,1,d); cache_k/v: (B,T,KV,hd) holding absolute positions
    ``0..T-1``; ``pos`` is the new token's position.

    The new token's k and v (after RoPE at ``pos``) are written into slot
    ``pos`` of ``cache_k`` and ``cache_v`` **in place**, where JAX's
    ``dynamic_update_slice`` returns updated copies; the same tensors come
    back. A ``pos`` outside the cache raises (``dynamic_update_slice``
    would clamp it). Attention is the direct path under the validity mask
    ``idx <= pos`` over the cache."""
    T = cache_k.shape[1]
    if not 0 <= pos < T:
        raise ValueError(f"decode position {pos} outside the cache's {T} "
                         f"slots")
    posv = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k, v = project_qkv(cfg, p, x, posv)
    cache_k[:, pos:pos + 1] = k
    cache_v[:, pos:pos + 1] = v
    valid = torch.arange(T, device=x.device) <= pos
    out = _sdpa(q, cache_k, cache_v, valid)
    return out @ p["wo"], cache_k, cache_v


# ----------------------------------------------------------------------- ffn
def apply_ffn(cfg, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """Gated FFN: ``act(x @ w_gate) * (x @ w_up) @ w_down``."""
    up = x @ p["w_up"]
    gate = x @ p["w_gate"]
    if cfg.act == "silu":
        h = torch.nn.functional.silu(gate) * up
    elif cfg.act == "gelu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * up
    else:
        raise NotImplementedError(f"activation {cfg.act!r} is not ported")
    return h @ p["w_down"]


# ----------------------------------------------------------------- embedding
def embed_tokens(p: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,S) int -> (B,S,d)."""
    return p["embed"][tokens.long()]


def logits_from_hidden(cfg, p: Dict[str, torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["head"]


def positions_for(batch: int, seq_len: int,
                  device: torch.device) -> torch.Tensor:
    """(B, S) token positions."""
    return torch.arange(seq_len, device=device).expand(batch, seq_len)


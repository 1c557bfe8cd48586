"""Attention-family layers as plain functions on tensors (port of
``repro/models/layers.py``): rmsnorm and layernorm, RoPE, the ``full`` /
``window`` / ``chunked`` masks and the prefix-LM's bidirectional prefix,
GQA attention on the direct and the blocked path, single-token decode
attention over a linear or ring cache, cross-attention to a
conditioning memory, the gated FFNs and ``gelu_mlp``, with the optional
projection and FFN biases, and embeddings and logits with parallel
codebooks. Parameters are dicts of tensors in the JAX package's tree;
autograd gives the backward of every path, the blocked one through
:class:`_Flash`.

Cast points are the reference's. Norms and RoPE compute in fp32 and cast
back to the input dtype. On the direct path (and in decode and
cross-attention) attention logits are scaled in the working dtype, then
softmaxed in fp32 under a ``-1e30`` mask and cast to ``v``'s dtype; on
the blocked path q is scaled in fp32 before the product
(:mod:`repro_torch.kernels.flash_attention`). A Python scalar that JAX
applies to a bf16 array is cast to bf16 first (weak typing), so it is
applied here as a 0-d tensor of the working dtype.

Under an active mesh (:mod:`repro_torch.sharding.context`) the tensors
are ``DTensor``s and the reference's activation constraints apply: the
Ulysses entry and exit of attention, the decode cache's layout and the
FFN's hidden layer. Every weight product runs on its ``model`` shard:
q, k, v, the gate and up projections and the logits column-parallel
(the logits split over the vocabulary), the attention's output and the
FFN's down projection row-parallel
(:func:`repro_torch.sharding.context.column_parallel`,
``row_parallel``). The self-attention core runs on each rank's local
q, k and v (:func:`_on_local_shards`): batch over the batch axes, heads
over ``model`` when the KV heads divide, so every q head's KV head is
local; the kernel launches on the local shard and nothing gathers the
heads. A decode step writes its cache slot into the local block of the
rank that holds it (:func:`_write_slot`) and attends on each rank's
local block of the cache (:func:`_decode_on_local_shards`), the softmax
completed over the ranks that split the slots.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.kernels.flash_attention import allowed as _allowed
from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import constrain

#: the batch dimension's logical axes
BATCH = ("pod", "data")

#: the longest sequence on the direct (materialised-logits) attention
#: path; longer ones take the blocked online-softmax path
DIRECT_SDPA_MAX_SEQ = 2048


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as JAX applies a Python scalar to ``like``: in its dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------- norms
def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """In fp32, cast back to ``x.dtype``: layernorm (population variance,
    as ``jnp.var``) when ``p`` holds a bias, else RMSNorm."""
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
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
def make_mask(seq_len: int, device: torch.device, kind: str = "full", *,
              window: int = 0, chunk: int = 0,
              n_prefix: int = 0) -> torch.Tensor:
    """(S, S) boolean mask of ``kind`` (``full``, ``window`` or
    ``chunked``); the first ``n_prefix`` positions also see each other
    (prefix-LM, PaliGemma)."""
    if kind not in ("full", "window", "chunked"):
        raise ValueError(kind)
    if (kind == "window" and window <= 0) or (kind == "chunked"
                                              and chunk <= 0):
        raise ValueError(f"kind={kind!r} needs a positive size")
    pos = torch.arange(seq_len, device=device)
    return _allowed(pos, pos, kind, window, chunk, n_prefix)


# ----------------------------------------------------------------- attention
def residual_spec(cfg, seq_len: int):
    """The residual stream's layout (logical axes) that a row-parallel
    product reduces onto: sequence-split over ``model`` under Megatron
    sequence parallelism (the reference's ``sp_spec``, model.py:243-253),
    else the batch split alone."""
    if cfg.seq_parallel_residual and seq_len % 128 == 0:
        return (BATCH, "model", None)
    return (BATCH, None, None)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor],
          split: Tuple[int, ...] = ()) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd); GQA by grouping heads; ``mask``
    broadcasts over (S, T), or ``None`` for none. ``split``: inside
    :func:`repro_torch.sharding.context.on_local_shards`, the active
    mesh's dimensions that split the keys among the ranks (the decode
    cache's slots); the softmax's maximum and sum and the product with v
    are then completed over them
    (:func:`repro_torch.sharding.context.reduce_local`)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg, k) \
        / _scalar(math.sqrt(hd), q)
    logits = logits.to(torch.float32)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    if split:
        top = shctx.reduce_local(logits.amax(-1, keepdim=True), split, "max")
        e = torch.exp(logits - top)
        probs = e / shctx.reduce_local(e.sum(-1, keepdim=True), split)
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkh->bskrh", probs.to(v.dtype), v)
    return shctx.reduce_local(out, split).reshape(B, S, H * hd)


def _query_rows(lo: int, hi: int, S: int, kind: str, window: int,
                chunk: int, n_prefix: int = 0) -> Tuple[int, int]:
    """The query rows ``[r0, r1)`` that may see some key in ``[lo, hi)``;
    every other row's probabilities there are 0. A key below
    ``n_prefix`` is also seen by every row of the prefix."""
    r1 = S
    if kind == "window":
        r1 = min(S, hi - 1 + window)
    elif kind == "chunked":
        r1 = min(S, ((hi - 1) // chunk + 1) * chunk)
    r0 = lo
    if lo < n_prefix:
        r0, r1 = 0, max(r1, min(n_prefix, S))
    return r0, max(r0, r1)


def _flash_bwd(q, k, v, out, m, l, dout, kind: str, window: int,
               chunk: int, kv_block: int, n_prefix: int = 0):
    """Port of the reference's ``_flash_bwd`` (``repro/models/layers.py:
    194-231``) in plain PyTorch, outside any kernel as the reference runs
    it in XLA: blockwise over ``kv_block`` keys, P recomputed from the
    forward's row stats ``m`` and ``l``, ``D = sum(dout * out)``,
    ``ds = p * (dp - D)``; nothing (S, T) is held. A key block touches
    only the query rows that may see it (:func:`_query_rows`), and the
    ragged last block is cut, not padded: rows and keys past S carry no
    gradient in the reference either. Returns ``(dq, dk, dv)`` in the
    inputs' dtypes, dq through the ``1/sqrt(hd)`` the reference applies
    to q in fp32."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    qs = q.reshape(B, S, KV, rep, hd).to(f32) * scale
    do = dout.reshape(B, S, KV, rep, hd).to(f32)
    o = out.reshape(B, S, KV, rep, hd).to(f32)
    m = m.reshape(B, S, KV, rep)
    linv = 1.0 / (l.reshape(B, S, KV, rep) + 1e-30)
    D = torch.sum(do * o, dim=-1)
    dq = torch.zeros_like(qs)
    dk = torch.zeros((B, T, KV, hd), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for lo in range(0, T, kv_block):
        hi = min(lo + kv_block, T)
        r0, r1 = _query_rows(lo, hi, S, kind, window, chunk, n_prefix)
        if r0 >= r1:
            continue
        k_j, v_j = k[:, lo:hi].to(f32), v[:, lo:hi].to(f32)
        q_i, do_i = qs[:, r0:r1], do[:, r0:r1]
        allow = _allowed(torch.arange(r0, r1, device=q.device),
                         torch.arange(lo, hi, device=q.device), kind,
                         window, chunk, n_prefix)[None, :, None, None, :]
        logits = torch.einsum("bskrh,btkh->bskrt", q_i, k_j)
        p = torch.exp(logits - m[:, r0:r1, ..., None]) \
            * linv[:, r0:r1, ..., None]
        p = torch.where(allow, p, 0.0)
        dv[:, lo:hi] = torch.einsum("bskrt,bskrh->btkh", p, do_i)
        dp = torch.einsum("bskrh,btkh->bskrt", do_i, v_j)
        ds = p * (dp - D[:, r0:r1, ..., None])
        dq[:, r0:r1] += torch.einsum("bskrt,btkh->bskrh", ds, k_j)
        dk[:, lo:hi] = torch.einsum("bskrt,bskrh->btkh", ds, q_i)
    return ((dq * scale).reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The blocked attention with its backward (port of the reference's
    ``_flash`` ``custom_vjp``). The forward is
    :func:`repro_torch.kernels.ops.flash_attention` with its row stats
    (the hand-written kernel on a card, its plain version on the CPU);
    ``q, k, v, out, m, l`` are saved and :func:`_flash_bwd` recomputes
    the probabilities from them. ``n_prefix`` (last, 0 when left out)
    is the prefix-LM's prefix."""

    @staticmethod
    def forward(ctx, q, k, v, kind: str, window: int, chunk: int,
                kv_block: int, n_prefix: int = 0):
        out, m, l = ops.flash_attention(q, k, v, kind=kind, window=window,
                                        chunk=chunk, n_prefix=n_prefix,
                                        kv_block=kv_block, return_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.mask = (kind, window, chunk, kv_block, n_prefix)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, m, l, dout, *ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def blocked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kind: str = "full", window: int = 0, chunk: int = 0,
                 n_prefix: int = 0, kv_block: int = 1024) -> torch.Tensor:
    """Flash-style attention (port of ``repro.models.layers.blocked_sdpa``):
    an online softmax over KV blocks that never holds the (S, S) logits,
    through :func:`repro_torch.kernels.ops.flash_attention` — the
    hand-written kernel on a card, its plain version on the CPU. The
    reference's padding of S to a multiple of ``kv_block`` lives in the
    plain version; the kernel masks the ragged tail instead, and both give
    the same rows. Under grad it goes through :class:`_Flash`, whose
    backward is the reference's."""
    kvb = min(kv_block, q.shape[1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, kind, window, chunk, kvb, n_prefix)
    return ops.flash_attention(q, k, v, kind=kind, window=window,
                               chunk=chunk, n_prefix=n_prefix, kv_block=kvb)


def full_seq_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kind: str = "full", window: int = 0, chunk: int = 0,
                  n_prefix: int = 0, kv_block: int = 1024) -> torch.Tensor:
    """Causal self-attention over the whole sequence with the ``kind``
    mask (and the bidirectional prefix of ``n_prefix`` positions): the
    direct masked path up to :data:`DIRECT_SDPA_MAX_SEQ` tokens, the
    blocked path beyond. ``DTensor`` inputs run on their local shards
    (:func:`_on_local_shards`)."""
    if shctx.is_dtensor(q):
        return _on_local_shards(
            functools.partial(full_seq_sdpa, kind=kind, window=window,
                              chunk=chunk, n_prefix=n_prefix,
                              kv_block=kv_block), q, k, v)
    S = q.shape[1]
    if S <= DIRECT_SDPA_MAX_SEQ:
        return _sdpa(q, k, v, make_mask(S, q.device, kind, window=window,
                                        chunk=chunk, n_prefix=n_prefix))
    return blocked_sdpa(q, k, v, kind=kind, window=window, chunk=chunk,
                        n_prefix=n_prefix, kv_block=kv_block)


def _on_local_shards(fn, q, k, v):
    """``fn(q, k, v)`` (an attention core: q (B,S,H,hd), k/v (B,T,KV,hd)
    -> (B,S,H*hd)) on each rank's local shards of ``DTensor`` inputs
    (:func:`repro_torch.sharding.context.on_local_shards`): the batch
    over the batch axes, and the heads over ``model`` when the KV heads
    divide by its size (each local q head's KV head is then local), else
    whole. The inputs are redistributed to that layout first (from
    Ulysses' sequence-sharded layout: the all-to-all); the output comes
    back with the same layout on its heads (the flattened ``H * hd``,
    heads major). Autograd goes through it, so :class:`_Flash`'s
    backward runs on the local shards too.

    Where ``model`` divides the q heads but not the KV heads (more
    tensor-parallel ranks than KV heads), the q heads are split and the
    KV heads taken whole, each rank keeping the KV heads its q heads
    read (Megatron's replicated KV heads): the attention is not repeated
    on every rank. Each rank's gradient of k and v is then a partial sum
    over ``model``."""
    spec = (BATCH, None, "model", None)
    kv_spec = shctx.local_spec(spec, k.shape)
    q_spec = shctx.local_spec(spec, q.shape)
    heads = _local_kv_heads(q, q_spec, k.shape[2]) \
        if kv_spec[2] is None else None
    if heads is None:
        return shctx.on_local_shards(fn, (q, k, v), (kv_spec,) * 3,
                                     (kv_spec[:3],))
    a, b = heads
    dims = shctx.split_dims_of(q_spec[2])
    return shctx.on_local_shards(
        lambda q, k, v: fn(q, k[:, :, a:b], v[:, :, a:b]), (q, k, v),
        (q_spec, kv_spec, kv_spec), (q_spec[:3],),
        partial={1: dims, 2: dims})


def _local_kv_heads(q, q_spec, n_kv: int) -> Optional[Tuple[int, int]]:
    """The KV heads ``[a, b)`` that this rank's q heads read when
    ``q_spec`` splits q's heads (dimension 2) and the KV heads are
    whole, if each rank's q heads are whole groups of one or more KV
    heads, or one KV head's group split evenly; else ``None``."""
    if q_spec[2] is None:
        return None
    from repro_torch.sharding.partition import local_region
    mesh = shctx.active_mesh()
    lo, hi = local_region(tuple(q.shape), q_spec, mesh,
                          torch.distributed.get_rank())[2].indices(
                              q.shape[2])[:2]
    rep, n = q.shape[2] // n_kv, hi - lo
    if rep % n and n % rep:
        return None
    return lo // rep, (hi - 1) // rep + 1


def project_qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k and v (B,S,KV,hd) of x (B,S,d), with the biases
    where the params hold them, q and k rotated at ``positions`` (B,S)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    col = shctx.column_parallel
    q = shctx.unflatten_last(col(x, p["wq"], p.get("bq")), H, hd)
    k = shctx.unflatten_last(col(x, p["wk"], p.get("bk")), KV, hd)
    v = shctx.unflatten_last(col(x, p["wv"], p.get("bv")), KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
              positions: torch.Tensor, kind: str = "full",
              n_prefix: int = 0
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (train / prefill) under the ``kind``
    mask (``cfg.window``, ``cfg.chunk``), the first ``n_prefix``
    positions also seeing each other. x: (B,S,d). Returns ``(out, (k,
    v))`` with k after RoPE, for the decode cache."""
    q, k, v = project_qkv(cfg, p, x, positions)
    ulysses = cfg.ulysses_attention and x.shape[1] % 128 == 0
    if ulysses:
        # Ulysses sequence parallelism (reference layers.py:290-298): q,
        # k, v enter attention sequence-sharded over 'model'; the local
        # attention's head layout then takes them by an all-to-all
        seq_spec = (BATCH, "model", None, None)
        q = constrain(q, seq_spec)
        k = constrain(k, seq_spec)
        v = constrain(v, seq_spec)
    out = full_seq_sdpa(q, k, v, kind=kind, window=cfg.window,
                        chunk=cfg.chunk, n_prefix=n_prefix,
                        kv_block=cfg.attn_kv_block)
    if ulysses:
        out = constrain(out, (BATCH, "model", None))
    return shctx.row_parallel(out, p["wo"], residual_spec(cfg, x.shape[1]),
                              p.get("bo")), (k, v)


def decode_attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, mode: str = "full"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode (port of ``repro.models.layers.
    decode_attention``). x: (B,1,d); cache_k/v: (B,T,KV,hd); ``pos`` is
    the new token's absolute position.

    ``mode="full"``: the cache holds positions ``0..T-1`` and the token
    goes to slot ``pos`` (outside the cache it raises, where
    ``dynamic_update_slice`` would clamp it). ``"window"`` / ``"chunked"``:
    the cache is a ring of T slots (the window or the chunk) and the token
    goes to slot ``pos % T``; keys are rotated before they are stored, so
    RoPE stays exact, and the softmax does not care about their order.
    The slot is written **in place**, where JAX's
    ``dynamic_update_slice`` returns updated copies; the same tensors
    come back. Attention is the direct path under the validity mask:
    ``idx <= pos`` (full), ``idx < min(pos + 1, T)`` (window),
    ``idx <= pos % T`` (chunked: the ring restarts at each chunk)."""
    T = cache_k.shape[1]
    if mode == "full":
        if not 0 <= pos < T:
            raise ValueError(f"decode position {pos} outside the cache's "
                             f"{T} slots")
        slot = pos
    elif mode in ("window", "chunked"):
        slot = pos % T
    else:
        raise ValueError(mode)
    posv = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k, v = project_qkv(cfg, p, x, posv)
    _write_slot(cache_k, slot, k)
    _write_slot(cache_v, slot, v)
    # the cache's layout for the attention (reference layers.py:332-342);
    # the tensors written in place are the ones that come back
    if shctx.seq_axis_active():
        cache_spec = (None, "seq", None, None)   # context parallelism (B 1)
    elif cfg.decode_kv_seq_shard and T % 128 == 0:
        cache_spec = (BATCH, "model", None, None)
    else:
        cache_spec = (BATCH, None, None, None)
    ck = constrain(cache_k, cache_spec)
    cv = constrain(cache_v, cache_spec)
    if shctx.is_dtensor(ck):
        out = _decode_on_local_shards(q, ck, cv, pos, mode)
    else:
        out = _sdpa(q, ck, cv, _decode_valid(
            torch.arange(T, device=x.device), T, pos, mode))
    return shctx.row_parallel(out, p["wo"], (BATCH, None, None),
                              p.get("bo")), cache_k, cache_v


def _decode_valid(idx: torch.Tensor, T: int, pos: int,
                  mode: str) -> torch.Tensor:
    """Which of the cache slots ``idx`` (of ``T``) hold a position the
    token at ``pos`` attends to."""
    if mode == "window":
        return idx < min(pos + 1, T)
    if mode == "chunked":
        return idx <= pos % T
    return idx <= pos


def _decode_on_local_shards(q: torch.Tensor, ck: torch.Tensor,
                            cv: torch.Tensor, pos: int,
                            mode: str) -> torch.Tensor:
    """The decode attention core on each rank's local shards of a
    ``DTensor`` cache laid out by :func:`decode_attention`'s constraint:
    q takes the cache's batch and head layout; a rank's keys are its
    block of slots, its validity mask starts at the block's first slot,
    and where the slots are split among ranks (``decode_kv_seq_shard``,
    long context) :func:`_sdpa` completes the softmax over them. PyTorch
    2.11's ``DTensor`` refuses the einsum's flattening of q's heads split
    over ``model``; here nothing is flattened on a split dimension."""
    from repro_torch.sharding.partition import local_index, spec_of
    spec = spec_of(ck.placements, ck.device_mesh, ck.ndim)
    T = ck.shape[1]
    lo = local_index(ck)[1].start or 0
    split = shctx.split_dims(ck, 1)

    def local(q, k, v):
        idx = torch.arange(lo, lo + k.shape[1], device=q.device)
        return _sdpa(q, k, v, _decode_valid(idx, T, pos, mode), split)
    return shctx.on_local_shards(
        local, (q, ck, cv), ((spec[0], None, spec[2], None), spec, spec),
        ((spec[0], None, spec[2]),))


def _write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place (new: (B, 1, ...)). On a
    ``DTensor`` cache the write is per shard by construction: ``new`` is
    laid out as the cache with its slot dimension whole, and the rank
    whose block of slots holds ``slot`` writes it into its local tensor
    (``DTensor`` has no sharding rule for a slice assignment)."""
    if not shctx.is_dtensor(cache):
        cache[:, slot:slot + 1] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.partition import local_index
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == 1
                 else pl for pl in cache.placements)
    local_new = new.redistribute(cache.device_mesh, want).to_local()
    index = local_index(cache)
    lo = index[1].start or 0
    hi = cache.shape[1] if index[1].stop is None else index[1].stop
    if lo <= slot < hi:
        cache.to_local()[:, slot - lo:slot - lo + 1] = local_new


def cross_attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    mem_k: torch.Tensor, mem_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B,S,d) to precomputed memory K/V
    (B,M,KV,hd): no mask, no RoPE. ``DTensor`` inputs run on their local
    shards (:func:`_on_local_shards`)."""
    q = shctx.unflatten_last(shctx.column_parallel(x, p["wq"], p.get("bq")),
                             cfg.n_heads, cfg.hd)
    if shctx.is_dtensor(q):
        out = _on_local_shards(functools.partial(_sdpa, mask=None), q,
                               mem_k, mem_v)
    else:
        out = _sdpa(q, mem_k, mem_v, None)
    return shctx.row_parallel(out, p["wo"], residual_spec(cfg, x.shape[1]),
                              p.get("bo"))


def memory_kv(cfg, p: Dict[str, torch.Tensor], memory: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conditioning memory (B,M,d) projected to K/V once (prefill)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    col = shctx.column_parallel
    k = shctx.unflatten_last(col(memory, p["wk"], p.get("bk")), KV, hd)
    v = shctx.unflatten_last(col(memory, p["wv"], p.get("bv")), KV, hd)
    return k, v


# ----------------------------------------------------------------------- ffn
def apply_ffn(cfg, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """``gelu_mlp``: ``gelu(x @ w_up + b_up) @ w_down + b_down``; the
    gated ones: ``act(x @ w_gate) * (x @ w_up) @ w_down`` with ``silu``,
    ``gelu`` (tanh form, as ``jax.nn.gelu``) or ``relu_sq``."""
    up = shctx.column_parallel(x, p["w_up"], p.get("b_up"))
    gelu = torch.nn.functional.gelu
    if cfg.act == "gelu_mlp":
        h = gelu(up, approximate="tanh")
    else:
        gate = shctx.column_parallel(x, p["w_gate"])
        if cfg.act == "silu":
            h = torch.nn.functional.silu(gate) * up
        elif cfg.act == "gelu":
            h = gelu(gate, approximate="tanh") * up
        elif cfg.act == "relu_sq":
            h = torch.square(torch.relu(gate)) * up
        else:
            raise ValueError(cfg.act)
    h = constrain(h, (BATCH, None, "model"))  # reference layers.py:404
    return shctx.row_parallel(h, p["w_down"], residual_spec(cfg, x.shape[1]),
                              p.get("b_down"))


# ----------------------------------------------------------------- embedding
def embed_tokens(cfg, p: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,S) int, or (B,S,K) with ``cfg.n_codebooks`` K: codebook
    c's token t is row ``c * vocab + t`` and the K rows are summed ->
    (B,S,d). A ``DTensor`` table is looked up on each rank's local block
    (:func:`_lookup_on_local_shards`)."""
    tokens = tokens.long()
    table = p["embed"]
    if cfg.n_codebooks:
        offs = torch.arange(cfg.n_codebooks, device=tokens.device) \
            * cfg.vocab
        tokens = tokens + offs
    rows = _lookup_on_local_shards(table, tokens) \
        if shctx.is_dtensor(table) else table[tokens]
    return rows.sum(dim=2) if cfg.n_codebooks else rows


def _lookup_on_local_shards(table: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a ``DTensor`` table (V, d) (the reference's
    lookup, layers.py:422-428) on each rank's local block, the ids split
    as the batch is: along a mesh axis that splits the batch the table
    is gathered (the FSDP unshard), along one that splits the
    vocabulary and not the batch the lookup is vocabulary-parallel (each
    rank reads the ids its rows hold, zero for the rest, and the reads
    are summed over those ranks,
    :func:`repro_torch.sharding.context.reduce_local`), and columns split
    along any other axis are gathered after the read. The result keeps
    the ids' batch split: no rank reads the whole batch. A rank's
    gradient is its own block's, a partial sum over the batch's axes.
    ``DTensor``'s own rules give a masked partial sum whose reduction
    breaks on a batch-sharded index, and PyTorch 2.11's rule for the
    lookup's backward (``index_put``) fails on a split table."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.partition import local_region, spec_of
    mesh = table.device_mesh
    ids = shctx.reduced(shctx.as_dtensor(ids, mesh))
    want = []
    for pt, pi in zip(table.placements, ids.placements):
        if isinstance(pi, Shard):
            want.append(Replicate())
        else:
            want.append(pt if isinstance(pt, Shard) else Replicate())
    spec = spec_of(want, mesh, 2)
    ids_spec = spec_of(ids.placements, mesh, ids.ndim)
    lo = local_region(tuple(table.shape), spec, mesh,
                      torch.distributed.get_rank())[0].start or 0
    vocab_dims = shctx.split_dims_of(spec[0])

    def local(t, i):
        inside = (i >= lo) & (i < lo + t.shape[0])
        rows = t[torch.where(inside, i - lo, 0)]
        rows = torch.where(inside[..., None], rows, 0)
        return shctx.reduce_local(rows, vocab_dims)
    rows = shctx.on_local_shards(local, (table, ids), (spec, ids_spec),
                                 (ids_spec + (spec[1],),), shared=(0,))
    return shctx.unsplit(rows, (-1,))


def logits_from_hidden(cfg, p: Dict[str, torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """(B,S,vocab), or (B,S,K,vocab) with codebooks."""
    logits = shctx.column_parallel(
        x, p["embed"].T if cfg.tie_embeddings else p["head"])
    if cfg.n_codebooks:
        logits = shctx.unflatten_last(logits, cfg.n_codebooks, cfg.vocab)
    return logits


def positions_for(batch: int, seq_len: int,
                  device: torch.device) -> torch.Tensor:
    """(B, S) token positions."""
    return torch.arange(seq_len, device=device).expand(batch, seq_len)

"""RWKV6 "Finch" block: data-dependent decay linear recurrence (port of
``repro/models/rwkv6.py``). [arXiv:2404.05892]

The WKV6 recurrence per head (state S ∈ R^{dk×dv}):

    o_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   w_t = exp(-exp(x_w,t)) ∈ (0,1)

Training and prefill from a zero state use the reference's chunked
parallel form (:func:`chunked_wkv6`): within a chunk of C steps the
contributions are (C×C) products with pairwise log-decay factors, and the
carried state goes from chunk to chunk in a loop. Per-step log-decays are
clamped at ``LOG_DECAY_CLAMP`` so the intra-chunk ``exp`` stays inside
fp32 range, the reference's documented deviation from RWKV's own CUDA
kernel, kept here. :func:`reference_wkv6` is the exact stepwise form:
the oracle of the tests, and the decode step. The reference has no Pallas
kernel for WKV, so neither has the port; both run in plain PyTorch.

Cast points are the reference's, where JAX promotes a bf16 array meeting
an fp32 one to fp32: the token-shift mixes are fp32 (``mix_base`` is), so
the projections, the decays and the WKV run in fp32; the group norm's
output goes back to the input dtype before the gate, and the block's
output is fp32 (the caller casts it into the residual).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding import context as shctx

from . import layers

#: ``x @ w`` in the promoted dtype of the two, as ``jnp.matmul``; on a mesh
#: column-parallel
_col = shctx.column_parallel

LOG_DECAY_CLAMP = -5.0  # e^-5/step ≈ 0.0067: effectively zero in a chunk
MIX_LORA = 32


# --------------------------------------------------------------------- wkv6
def _group_norm_heads(x: torch.Tensor, scale: torch.Tensor, H: int,
                      eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the output (RWKV's ln_x). x: (B, T, d)."""
    B, T, d = x.shape
    xs = shctx.unflatten_last(x, H, d // H).to(torch.float32)
    mu = xs.mean(-1, keepdim=True)
    var = xs.var(-1, keepdim=True, unbiased=False)
    xs = (xs - mu) * torch.rsqrt(var + eps)
    return (xs.reshape(B, T, d) * scale).to(x.dtype)


def chunked_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6 from a zero state. r, k, v, lw: (B, T, H, hs)
    (lw the log-decays, <= 0); u: (H, hs). Returns ``(out (B, T, H, hs),
    final state (B, H, hs, hs))``, fp32. ``T % chunk == 0`` is required,
    as in the reference."""
    B, T, H, hs = r.shape
    C = chunk
    assert T % C == 0, f"T={T} must be divisible by chunk={C}"
    assert C * (-LOG_DECAY_CLAMP) < 88.0, "intra-chunk exp() would overflow"
    N = T // C
    f32 = torch.float32

    def to_chunks(a):  # (N, B, H, C, hs)
        return a.to(f32).reshape(B, N, C, H, hs).permute(1, 0, 3, 2, 4)
    r_s, k_s, v_s = to_chunks(r), to_chunks(k), to_chunks(v)
    lw_s = to_chunks(torch.clamp(lw.to(f32), LOG_DECAY_CLAMP, 0.0))
    uf = u.to(f32)
    idx = torch.arange(C, device=r.device)
    strict = idx[:, None] > idx[None, :]
    S = torch.zeros((B, H, hs, hs), dtype=f32, device=r.device)
    outs = []
    for n in range(N):
        r_c, k_c, v_c, lw_c = r_s[n], k_s[n], v_s[n], lw_s[n]  # (B,H,C,hs)
        cum = torch.cumsum(lw_c, dim=2)                # Σ_{u<=t}
        ex = cum - lw_c                                # Σ_{u<t}
        total = cum[:, :, -1, :]                       # (B, H, hs)
        q_t = r_c * torch.exp(ex)
        k_t = k_c * torch.exp(-cum)
        scores = torch.einsum("bhci,bhdi->bhcd", q_t, k_t)
        scores = torch.where(strict, scores, 0.0)
        diag = torch.einsum("bhci,hi,bhci->bhc", r_c, uf, k_c)
        intra = torch.einsum("bhcd,bhdj->bhcj", scores, v_c) \
            + diag[..., None] * v_c
        inter = torch.einsum("bhci,bhij->bhcj", q_t, S)
        k_state = k_c * torch.exp(total[:, :, None, :] - cum)
        S = S * torch.exp(total)[..., :, None] \
            + torch.einsum("bhci,bhcj->bhij", k_state, v_c)
        outs.append(intra + inter)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, hs)
    return out, S


def reference_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lw: torch.Tensor, u: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact stepwise recurrence (the tests' oracle and the decode
    path); shapes as :func:`chunked_wkv6`, from ``initial_state`` (B, H,
    hs, hs) or zeros."""
    B, T, H, hs = r.shape
    f32 = torch.float32
    r, k, v = (a.to(f32).transpose(1, 2) for a in (r, k, v))  # (B,H,T,hs)
    lw = torch.clamp(lw.to(f32), LOG_DECAY_CLAMP, 0.0).transpose(1, 2)
    S = initial_state.to(f32) if initial_state is not None \
        else torch.zeros((B, H, hs, hs), dtype=f32, device=r.device)
    uf = u.to(f32)[None, :, :, None]
    outs = []
    for t in range(T):
        r_t, k_t, v_t = r[:, :, t], k[:, :, t], v[:, :, t]     # (B, H, hs)
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, S + uf * kv))
        S = torch.exp(lw[:, :, t])[..., :, None] * S + kv
    out = torch.stack(outs, dim=1)                             # (B,T,H,hs)
    return out.reshape(B, T, H, hs), S


def _wkv(r, k, v, lw, u, state, chunk: Optional[int]):
    """:func:`chunked_wkv6` at ``chunk``, or with ``chunk`` ``None`` the
    stepwise :func:`reference_wkv6` from ``state``. On ``DTensor``s each
    rank runs the recurrence on its local heads of its batch rows (it
    mixes neither), the sequence whole:
    :func:`repro_torch.sharding.context.on_local_shards`."""
    def core(r, k, v, lw, u, state):
        if chunk is None:
            return reference_wkv6(r, k, v, lw, u, initial_state=state)
        return chunked_wkv6(r, k, v, lw, u, chunk)
    if not shctx.is_dtensor(r):
        return core(r, k, v, lw, u, state)
    heads = shctx.local_spec((("pod", "data"), None, "model", None),
                             r.shape)
    st = (heads[0], heads[2], None, None)
    return shctx.on_local_shards(
        core, (r, k, v, lw, u, state),
        (heads,) * 4 + ((heads[2], None), None if state is None else st),
        (heads, st), shared=(4,))


# ----------------------------------------------------------------- the block
def _ddlerp(p: Dict[str, torch.Tensor], x: torch.Tensor,
            x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token-shift mixing (Finch): 5 mixed variants of x,
    (B, T, 5, d) fp32."""
    delta = x_prev - x
    base = x + delta * p["mix_base"][0]          # seed mix (uses target 0)
    lora = shctx.unflatten_last(torch.tanh(_col(base, p["mix_w1"])), 5,
                                MIX_LORA)
    dyn = torch.einsum("btki,kid->btkd", lora, p["mix_w2"].to(lora.dtype))
    mixes = p["mix_base"][None, None] + dyn      # (B, T, 5, d)
    return x[:, :, None, :] + delta[:, :, None, :] * mixes


def time_mix(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
             x_prev_last: torch.Tensor, state: Optional[torch.Tensor], *,
             decode: bool = False
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The RWKV6 attention analogue. x: (B, T, d); ``x_prev_last`` (B, d):
    the previous segment's last input (the token-shift carry); ``state``:
    (B, H, hs, hs) WKV state or ``None``. Returns ``(out, (x[:, -1],
    S))``. The chunked form runs from a zero state at ``T % rwkv_chunk ==
    0``, the stepwise one otherwise and in decode."""
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    x_prev = torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)
    m = _ddlerp(p, x, x_prev)
    xr, xw, xk, xv, xg = (m[:, :, i, :] for i in range(5))
    r = shctx.unflatten_last(_col(xr, p["wr"]), H, hs)
    kk = shctx.unflatten_last(_col(xk, p["wk"]), H, hs)
    vv = shctx.unflatten_last(_col(xv, p["wv"]), H, hs)
    g = torch.nn.functional.silu(_col(xg, p["wg"]))
    lw = -torch.exp(p["w0"] + _col(torch.tanh(_col(xw, p["w_a"])),
                                   p["w_b"]))
    lw = shctx.unflatten_last(lw, H, hs)
    stepwise = decode or state is not None or T % cfg.rwkv_chunk != 0
    wkv, S = _wkv(r, kk, vv, lw, p["u"], state,
                  None if stepwise else cfg.rwkv_chunk)
    out = _group_norm_heads(wkv.reshape(B, T, d).to(x.dtype),
                            p["ln_x_scale"], H)
    out = shctx.row_parallel(out * g, p["wo"],
                             layers.residual_spec(cfg, T))
    return out, (x[:, -1, :], S.to(torch.float32))


def channel_mix(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                x_prev_last: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 FFN analogue: token-shifted ``relu(x W_in)^2 W_out``
    gated by ``sigmoid(x W_r)``. Returns ``(out, x[:, -1])``."""
    x_prev = torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)
    delta = x_prev - x
    xk = x + delta * p["mix_k"]
    xr = x + delta * p["mix_r"]
    k = torch.square(torch.relu(_col(xk, p["w_in"])))
    r = torch.sigmoid(_col(xr, p["w_r"]))
    # reduced onto r's layout (its channels over 'model') and the gated
    # product made whole over them, the residual's layout: a
    # reduce-scatter and an all-gather, an all-reduce's bytes
    out = shctx.row_parallel(k, p["w_out"],
                             (layers.BATCH, None, "model"))
    return shctx.unsplit(r * out, (-1,)), x[:, -1, :]

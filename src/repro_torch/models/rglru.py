"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro/models/rglru.py``). [arXiv:2402.19427]

    r_t = σ(x_t W_a + b_a)            (recurrence gate)
    i_t = σ(x_t W_x + b_x)            (input gate)
    a_t = exp(-c · softplus(Λ) · r_t) (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

The recurrence is elementwise-diagonal. The reference scans it with
``jax.lax.associative_scan``; here a log-depth scan in plain PyTorch
(:func:`linear_scan`: ceil(log2 T) elementwise passes over the whole
sequence) does the same in another order of sums, so ``h`` agrees in
fp32 to rounding, not bit for bit. The reference has no Pallas kernel for
it, so neither has the port. Decode is a single step with the carried
``h`` and the convolution's last ``W - 1`` inputs. The block follows
Griffin: (norm → [gelu gate ‖ conv1d → RG-LRU] → merge → out-proj) with
the residual, then a gated-MLP sub-block that the caller applies. Cast
points are the reference's: the gates and the scan in fp32, ``h`` back
in the input dtype, the carried ``h`` fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding import context as shctx

from . import layers

C_FACTOR = 8.0


def causal_conv1d(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  conv_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution of width W over x (B, T, dr).
    ``conv_state`` (B, W-1, dr) holds the previous segment's last inputs
    (zeros when ``None``, made like x, so a ``DTensor`` keeps x's
    layout); returns ``(y, new_conv_state)``."""
    W = p["conv_w"].shape[0]
    T = x.shape[1]
    if conv_state is None:
        conv_state = torch.zeros_like(x[:, :1]).expand(-1, W - 1, -1)
    xp = torch.cat([conv_state, x], dim=1)             # (B, T+W-1, dr)
    y = 0
    for i in range(W):
        y = y + xp[:, i:i + T, :] * p["conv_w"][i]
    new_state = xp[:, -(W - 1):, :] if W > 1 else conv_state
    return y + p["conv_b"], new_state


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along dim 1 from ``h_{-1} = 0``, by
    the log-depth (Hillis-Steele) scan of the pairs ``(a, b)`` under
    ``(a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2)``, the reference's
    ``combine``."""
    T = a.shape[1]
    shift = 1
    while shift < T:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rg_lru(p: Dict[str, torch.Tensor], u: torch.Tensor,
           h0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, T, dr) gated inputs; h0: (B, dr) carried state. Returns
    ``(y in u's dtype, h_last fp32)``."""
    f32 = torch.float32
    uf = u.to(f32)
    r = torch.sigmoid(shctx.column_parallel(uf, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(shctx.column_parallel(uf, p["w_x"]) + p["b_x"])
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    log_a = -C_FACTOR * softplus * r                    # (B, T, dr) <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    if h0 is not None:
        # the carried state folded in as a virtual step 0: b_0 += a_0 h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(f32)[:, None], b[:, 1:]],
                      dim=1)
    h = _scan(a, b)
    return h.to(u.dtype), h[:, -1, :]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`linear_scan`; on ``DTensor``s each rank scans its local
    channels of its batch rows (the recurrence is diagonal), the sequence
    whole: :func:`repro_torch.sharding.context.on_local_shards`."""
    if not shctx.is_dtensor(a):
        return linear_scan(a, b)
    spec = shctx.local_spec((("pod", "data"), None, "model"), a.shape)
    return shctx.on_local_shards(linear_scan, (a, b), (spec, spec), (spec,))


def apply_rglru_block(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                      state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """x: (B, T, d); ``state``: ``None`` or ``(h (B, dr) fp32, conv (B,
    W-1, dr))``. Returns ``(out (B, T, d), (h_last, conv))``."""
    gate = torch.nn.functional.gelu(
        shctx.column_parallel(x, p["w_gate_branch"]), approximate="tanh")
    u = shctx.column_parallel(x, p["w_rec_in"])
    h0 = conv_state = None
    if state is not None:
        h0, conv_state = state
    u, new_conv = causal_conv1d(p, u, conv_state)
    rec, h_last = rg_lru(p, u, h0)
    out = shctx.row_parallel(gate * rec, p["w_out"],
                             layers.residual_spec(cfg, x.shape[1]))
    return out, (h_last.to(torch.float32), new_conv)

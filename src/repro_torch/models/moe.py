"""Mixture-of-Experts FFN with capacity-based dispatch, GShard-style (port
of ``repro/models/moe.py``).

Tokens are split into groups of ``cfg.moe_group_size``; within a group a
top-k router assigns each token to experts up to a capacity ``C =
ceil(group * top_k * capacity_factor / E)``, in token order. Dispatch and
combine are dense one-hot products, as in the reference, whose expert
products run in XLA outside any Pallas kernel: here they are
``torch.einsum`` calls. The router, its softmax and the Switch-style
load-balance loss are fp32; the expert products run in the input dtype.

``jax.lax.top_k`` breaks ties toward the lower expert index; so does the
stable descending sort that :func:`route` takes the top k from
(``torch.topk`` on a card promises no order among equal values).

Under an active mesh the reference's three constraints apply (the groups
over the batch axes, the expert inputs and outputs over ``model``). The
router runs on each rank's local groups (:func:`_route_on_local_groups`):
routing is per group by construction, and ``DTensor`` has no sharding
rule for its sort, one-hots and cumsum. The experts run on each rank's
local shards laid out by the expert constraint
(:func:`_experts_on_local_shards`): its experts for its groups, the
combine summed over the expert axes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import constrain

from . import layers


def capacity(cfg, group: int) -> int:
    c = math.ceil(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 1)


def top_k(cfg, p: Dict[str, torch.Tensor], x_grouped: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router's probabilities (G, S, E), fp32, and each token's top
    ``k`` experts (G, S, K), ties toward the lower index."""
    logits = x_grouped.to(torch.float32) @ p["router"]          # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    _vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, idx[..., :cfg.top_k]


def route(cfg, p: Dict[str, torch.Tensor], x_grouped: torch.Tensor,
          topk_idx: torch.Tensor = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_grouped: (G, S, d) -> dispatch (G, S, E, C), combine (G, S, E,
    C), aux loss; all fp32. ``topk_idx`` (G, S, K): the experts each
    token goes to, given (their probabilities still weigh them), where a
    comparison must route as another run did; else the router's top k."""
    G, S, _d = x_grouped.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    f32 = torch.float32
    probs, top = top_k(cfg, p, x_grouped)
    if topk_idx is None:
        topk_idx = top
    gate_vals = torch.gather(probs, -1, topk_idx)               # (G,S,K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    one_hot = torch.nn.functional.one_hot
    # expert assignment one-hots: (G, S, K, E)
    assign = one_hot(topk_idx, E).to(f32)
    # position of each (token, k) within its expert's queue
    flat = assign.reshape(G, S * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(G, S, K, E)
    assign = assign * (pos_in_expert < C)
    pos = torch.einsum("gske->gsk", pos_in_expert * assign).long()
    cap_onehot = one_hot(pos, C).to(f32)                        # (G,S,K,C)
    disp = torch.einsum("gske,gskc->gsec", assign, cap_onehot)
    comb = torch.einsum("gske,gskc,gsk->gsec", assign, cap_onehot,
                        gate_vals)
    # Switch-style load-balance auxiliary loss
    density = assign.sum(2).mean(1)                             # (G, E)
    router_prob = probs.mean(1)                                 # (G, E)
    aux = (density * router_prob).sum(-1).mean() * (E ** 2) / K
    return disp, comb, aux


def apply_moe(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ``(out, aux_loss)``; the shared expert (a gated FFN)
    added where the config has one."""
    B, S, d = x.shape
    tokens = B * S
    gs = min(cfg.moe_group_size, tokens)
    G = max(tokens // gs, 1)
    gs = tokens // G
    xg = x.reshape(G, gs, d)
    xg = constrain(xg, (layers.BATCH, None, None))   # reference moe.py:86
    if shctx.is_dtensor(xg):
        disp, comb, aux = _route_on_local_groups(cfg, p, xg)
        out = _experts_on_local_shards(cfg, p, disp, comb, xg)
    else:
        disp, comb, aux = route(cfg, p, xg)
        out = _experts(cfg, p["w_gate"], p["w_up"], p["w_down"], disp, comb,
                       xg)
    out = out.reshape(B, S, d)
    if cfg.shared_expert:
        out = out + layers.apply_ffn(cfg, p["shared"], x)
    return out, aux.to(torch.float32)


def _experts(cfg, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, disp: torch.Tensor, comb: torch.Tensor,
             xg: torch.Tensor) -> torch.Tensor:
    """Dispatch (G, S, E, C) x (G, S, d) -> expert inputs (E, G, C, d),
    the gated expert FFN, and the combine back to (G, S, d), in the input
    dtype. Unsharded the reference's two constraints on the expert inputs
    and outputs are the identity; on a mesh this runs on each rank's
    local shards, which are laid out by them
    (:func:`_experts_on_local_shards`)."""
    dt = xg.dtype
    expert_in = torch.einsum("gsec,gsd->egcd", disp.to(dt), xg)
    h = torch.einsum("egcd,edf->egcf", expert_in, w_gate)
    u = torch.einsum("egcd,edf->egcf", expert_in, w_up)
    if cfg.act == "gelu":
        h = torch.nn.functional.gelu(h, approximate="tanh") * u
    else:
        h = torch.nn.functional.silu(h) * u
    expert_out = torch.einsum("egcf,efd->egcd", h, w_down)
    return torch.einsum("gsec,egcd->gsd", comb.to(dt), expert_out)


def _experts_on_local_shards(cfg, p: Dict[str, torch.Tensor],
                             disp: torch.Tensor, comb: torch.Tensor,
                             xg: torch.Tensor) -> torch.Tensor:
    """:func:`_experts` on each rank's local shards, laid out by the
    reference's constraint on the expert inputs and outputs (``("model",
    BATCH, None, None)``, moe.py:88 and :98): the experts over the axes
    of its first entry, the groups over those of its second. A rank
    takes its groups' tokens whole, its experts' columns of the dispatch
    and combine tensors and its experts' weights whole (gathered over
    the other axes, as the reference's FSDP layout gathers them), and
    its combine is a partial sum over the expert axes, completed by
    :func:`repro_torch.sharding.context.reduce_local`. PyTorch 2.11's
    ``DTensor`` refuses the einsums' flattening of an expert dimension
    split over ``model``; here nothing is flattened on a split
    dimension."""
    E, C = disp.shape[2], disp.shape[3]
    spec = shctx.local_spec(("model", layers.BATCH, None, None),
                            (E, xg.shape[0], C, xg.shape[2]))
    e_axes, g_axes = spec[0], spec[1]
    e_dims = shctx.split_dims_of(e_axes)
    tokens = (g_axes, None, None)
    cols = (g_axes, None, e_axes, None)
    weights = (e_axes, None, None)

    def local(disp, comb, x, w_gate, w_up, w_down):
        out = _experts(cfg, w_gate, w_up, w_down, disp, comb, x)
        return shctx.reduce_local(out, e_dims)
    return shctx.on_local_shards(
        local, (disp, comb, xg, p["w_gate"], p["w_up"], p["w_down"]),
        (cols, cols, tokens, weights, weights, weights), (tokens,),
        shared=(3, 4, 5), partial={2: e_dims})


def _route_on_local_groups(cfg, p: Dict[str, torch.Tensor],
                           xg: torch.Tensor):
    """:func:`route` on each rank's local groups of a ``DTensor`` ``xg``
    (G, S, d) (:func:`repro_torch.sharding.context.on_local_shards`): the
    groups over the batch axes when they divide (else every rank routes
    them all), the router whole, its gradient on a rank a partial sum
    over the axes the groups are split on. The aux loss is the mean over
    groups: the local means summed over those axes
    (:func:`repro_torch.sharding.context.reduce_local`, whose backward
    hands each rank the whole gradient) over their number of ranks."""
    mesh = shctx.active_mesh()
    spec = shctx.local_spec((layers.BATCH, None, None), xg.shape)
    dims = shctx.split_dims_of(spec[0])
    n = math.prod(mesh.size(i) for i in dims)

    def local(router, x):
        disp, comb, aux = route(cfg, {"router": router}, x)
        return disp, comb, shctx.reduce_local(aux, dims) / n
    return shctx.on_local_shards(local, (p["router"], xg),
                                 ((None, None), spec),
                                 (spec + (None,), spec + (None,), ()),
                                 shared=(0,))

"""The plain reference: a training step of the benchmark's configurations
in float32 PyTorch, with its AdamW, written from the configuration files
alone. It imports nothing of the program and nothing of JAX, and takes
nothing the program made: the harness hands it the same seeded weights
and batches it hands the program.

The model is a decoder of pre-norm blocks: ``full`` and ``window``
(causal self-attention, the window counting the query itself) and
``xattn`` (full self-attention, then cross-attention to a conditioning
memory), each followed by the FFN; token embeddings (the codebooks'
rows summed) times ``sqrt(d_model)``; a final norm and an untied head.
Self-attention rotates q and k after their biases (RoPE, the two halves
of each head rotated as a pair); cross-attention has no rotation and no
mask. Layernorm uses the population variance and ``eps = 1e-6``, the FFN
``gelu`` in its tanh form. The loss is the next-token cross-entropy over
every position but the last, averaged over the batch, the positions and
the codebooks.

``mm`` is every weight product (the projections, the FFN and the head):
:func:`matmul` in float32, or :func:`fp8_matmul`, the same products with
both operands rounded to float8 (e4m3, one scale a tensor): the control
that a lower precision than the configuration's bfloat16 has to fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch

F32 = torch.float32
#: query rows a block of the attention (the logits are never held whole)
ATTN_BLOCK = 1024
LN_EPS = 1e-6


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Float32 products without TF32 inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    at 448); the gradient passes through unchanged."""
    with torch.no_grad():
        s = 448.0 / t.abs().amax().clamp_min(1e-30)
        q = (t * s).to(torch.float8_e4m3fn).to(F32) / s
    return t + (q - t).detach()


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x) @ _fp8(w)


def _norm(p: Dict[str, torch.Tensor], pre: str, x: torch.Tensor
          ) -> torch.Tensor:
    scale = p[pre + "/scale"]
    bias = p.get(pre + "/bias")
    if bias is None:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + LN_EPS) \
            * scale
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _linear(p, pre: str, name: str, bias: str, x, mm) -> torch.Tensor:
    y = mm(x, p[f"{pre}/{name}"])
    b = p.get(f"{pre}/{bias}")
    return y if b is None else y + b


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], n, -1)


def _attend(q, k, v, kind: str, window: int) -> torch.Tensor:
    """q (B,S,H,hd), k and v (B,T,KV,hd) -> (B,S,H*hd); ``kind`` ``none``
    (cross-attention), ``full`` (causal) or ``window``; in blocks of
    :data:`ATTN_BLOCK` query rows, each over the keys it may see."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    outs = []
    for q0 in range(0, S, ATTN_BLOCK):
        q1 = min(S, q0 + ATTN_BLOCK)
        if kind == "none":
            k0, k1 = 0, T
        else:
            k0 = max(0, q0 - window + 1) if kind == "window" else 0
            k1 = q1
        s = q[:, :, q0:q1] @ k[:, :, k0:k1].transpose(-1, -2) \
            / math.sqrt(hd)
        if kind != "none":
            i = torch.arange(q0, q1, device=q.device)[:, None]
            j = torch.arange(k0, k1, device=q.device)[None, :]
            allow = j <= i
            if kind == "window":
                allow = allow & (j > i - window)
            s = s.masked_fill(~allow, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, :, k0:k1])
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)


def _ffn(cfg, p, pre: str, x, mm) -> torch.Tensor:
    up = _linear(p, pre, "w_up", "b_up", x, mm)
    if cfg["act"] == "gelu_mlp":
        h = torch.nn.functional.gelu(up, approximate="tanh")
    elif cfg["act"] == "silu":
        h = torch.nn.functional.silu(mm(x, p[pre + "/w_gate"])) * up
    else:
        raise ValueError(f"the reference has no activation {cfg['act']!r}")
    return _linear(p, pre, "w_down", "b_down", h, mm)


def forward_logits(cfg, p: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   mm: Callable = matmul) -> torch.Tensor:
    """The logits (B, S, vocab), or (B, S, K, vocab) with K codebooks;
    ``p`` maps each parameter's path (``groups/<g>/<j>/attn/wq``, stacked
    over the group's repeats) to a float32 tensor."""
    d, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    K, V = cfg.get("n_codebooks", 0), cfg["vocab"]
    tokens = batch["tokens"].long()
    if K:
        tokens = tokens + torch.arange(K, device=tokens.device) * V
        x = p["embed/embed"][tokens].sum(dim=2)
    else:
        x = p["embed/embed"][tokens]
    x = x * math.sqrt(d)
    memory = batch.get("memory_embeds")
    kinds = []
    for g, (pattern, count) in enumerate(cfg["layer_groups"]):
        for i in range(count):
            for j, btype in enumerate(pattern):
                kinds.append((f"groups/{g}/{j}", i, btype))
    for pre, i, btype in kinds:
        if btype not in ("full", "window", "xattn"):
            raise ValueError(f"the reference has no block {btype!r}")
        lp = {k[len(pre) + 1:]: t[i] for k, t in p.items()
              if k.startswith(pre + "/")}
        h = _norm(lp, "ln1", x)
        q = _heads(_linear(lp, "attn", "wq", "bq", h, mm), H)
        k = _heads(_linear(lp, "attn", "wk", "bk", h, mm), KV)
        v = _heads(_linear(lp, "attn", "wv", "bv", h, mm), KV)
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        kind = "window" if btype == "window" else "full"
        a = _attend(q, k, v, kind, cfg.get("window", 0))
        x = x + _linear(lp, "attn", "wo", "bo", a, mm)
        if btype == "xattn":
            hx = _norm(lp, "lnx", x)
            q = _heads(_linear(lp, "xattn", "wq", "bq", hx, mm), H)
            mk = _heads(_linear(lp, "xattn", "wk", "bk", memory, mm), KV)
            mv = _heads(_linear(lp, "xattn", "wv", "bv", memory, mm), KV)
            a = _attend(q, mk, mv, "none", 0)
            x = x + _linear(lp, "xattn", "wo", "bo", a, mm)
        x = x + _ffn(cfg, lp, "ffn", _norm(lp, "ln2", x), mm)
    x = _norm(p, "ln_f", x)
    logits = mm(x, p["embed/head"])
    if K:
        logits = logits.reshape(*logits.shape[:-1], K, V)
    return logits


def loss_fn(cfg, p, batch, mm: Callable = matmul,
            half_batch: bool = False) -> torch.Tensor:
    """The mean next-token cross-entropy. ``half_batch``: a planted fault,
    the mean over the first half of the batch (of the positions where the
    batch is one row) with the rest left out."""
    logits = forward_logits(cfg, p, batch, mm)
    lg = logits[:, :-1]
    tgt = batch["tokens"][:, 1:].long()
    ce = torch.logsumexp(lg, dim=-1) \
        - torch.gather(lg, -1, tgt[..., None])[..., 0]
    if half_batch:
        B, S = ce.shape[0], ce.shape[1]
        ce = ce[:B // 2] if B > 1 else ce[:, :S // 2]
    return ce.mean()


def _adamw(hp: Dict[str, float], w: Dict[str, torch.Tensor],
           grads: Sequence[torch.Tensor], m: Dict[str, torch.Tensor],
           v: Dict[str, torch.Tensor], n: int
           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """AdamW's ``n``-th update of ``w``, ``m`` and ``v`` in place, the
    gradients clipped to a global norm of ``hp["grad_clip"]`` first.
    Returns each leaf's gradient as the optimizer takes it (clipped) and
    its norm before the clip."""
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(hp["grad_clip"] / (gn + 1e-9), max=1.0)
    b1c = 1.0 - hp["b1"] ** n
    b2c = 1.0 - hp["b2"] ** n
    taken: Dict[str, torch.Tensor] = {}
    raw: Dict[str, float] = {}
    for (k, t), g in zip(w.items(), grads):
        raw[k] = float(torch.linalg.vector_norm(g))
        g = g * scale
        taken[k] = g
        m[k].mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
        v[k].mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
        t.sub_(hp["lr"] * ((m[k] / b1c) / (torch.sqrt(v[k] / b2c)
                                           + hp["eps"])
                           + hp["weight_decay"] * t))
    return taken, raw


def train_steps(cfg, hp: Dict[str, float], params0: Dict[str, torch.Tensor],
                batches: Sequence[Dict[str, torch.Tensor]],
                mm: Callable = matmul, half_batch: bool = False
                ) -> Dict[str, object]:
    """``len(batches)`` AdamW steps from ``params0`` (float32 copies are
    made; ``params0`` is not changed). Returns ``losses`` (each step's
    loss), ``grad1`` (each leaf's norm of the first gradient as the
    optimizer takes it, after the global-norm clip), ``grad1_t`` (that
    gradient itself), ``grad1_raw`` (its norms before the clip) and
    ``change`` (each leaf's norm of its change after the last step)."""
    with exact_fp32():
        w = {k: t.detach().to(F32).clone().requires_grad_(True)
             for k, t in params0.items()}
        m = {k: torch.zeros_like(t) for k, t in w.items()}
        v = {k: torch.zeros_like(t) for k, t in w.items()}
        losses: List[float] = []
        out: Dict[str, object] = {}
        for n, batch in enumerate(batches, start=1):
            loss = loss_fn(cfg, w, batch, mm, half_batch)
            grads = torch.autograd.grad(loss, list(w.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                taken, raw = _adamw(hp, w, grads, m, v, n)
            if n == 1:
                out = {"grad1": {k: float(torch.linalg.vector_norm(g))
                                 for k, g in taken.items()},
                       "grad1_t": taken, "grad1_raw": raw}
            del grads, taken
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(
                t - params0[k].to(F32))) for k, t in w.items()}
    return {"losses": losses, **out, "change": change}


def step_from(cfg, hp: Dict[str, float], state: Dict[str, Dict[str,
              torch.Tensor]], n: int, batch: Dict[str, torch.Tensor],
              mm: Callable = matmul, half_batch: bool = False
              ) -> Dict[str, object]:
    """The ``n``-th AdamW step from a training state handed in:
    ``state["params"]`` (the working weights the forward reads),
    ``["master"]``, ``["m"]`` and ``["v"]`` (the optimizer's), each a
    leaf by path; none is changed. The forward and backward run in
    float32 on the working weights, the update on the master weights.
    Returns ``loss``, ``grad_t`` (each leaf's gradient as the optimizer
    takes it), ``grad_raw`` (its norms before the clip) and ``change``
    (each leaf's norm of its master weight's change)."""
    with exact_fp32():
        w = {k: t.detach().to(F32).requires_grad_(True)
             for k, t in state["params"].items()}
        loss = loss_fn(cfg, w, batch, mm, half_batch)
        grads = torch.autograd.grad(loss, list(w.values()))
        del w
        with torch.no_grad():
            master = {k: state["master"][k].to(F32).clone()
                      for k in state["params"]}
            m = {k: state["m"][k].to(F32).clone() for k in master}
            v = {k: state["v"][k].to(F32).clone() for k in master}
            taken, raw = _adamw(hp, master, grads, m, v, n)
            del grads, m, v
            change = {k: float(torch.linalg.vector_norm(
                t - state["master"][k].to(F32))) for k, t in master.items()}
    return {"loss": float(loss.detach()), "grad_t": taken,
            "grad_raw": raw, "change": change}

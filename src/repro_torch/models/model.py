"""The model zoo: parameter trees, forward, decode and loss (port of
``repro/models/model.py`` for every block type: ``full``, ``window``,
``chunked``, ``xattn``, the ``*_moe`` ones, ``rec`` and ``rwkv``, and the
prefix-LM).

:func:`param_shapes` reproduces the tree of ``init_params`` exactly —
``{"embed": {"embed"[, "head"]}, "ln_f": norm, "groups": ((stacked block,
...), ...)}`` with each block ``{"ln1": norm, "ln2": norm}`` and, by
type, ``"attn": {wq, wk, wv, wo[, bq, bk, bv, bo]}`` with ``"ffn":
{w_up, w_down[, w_gate][, b_up, b_down]}`` (plus ``"lnx"`` and
``"xattn"`` for ``xattn``) or ``"moe": {router, w_gate, w_up, w_down[,
shared]}`` (``*_moe``); ``"rec"`` (the RG-LRU) and ``"ffn"`` (``rec``);
``"tmix"`` and ``"cmix"`` (``rwkv``), stacked over the group's repeat
count, a norm being ``{scale[, bias]}`` — so state built here
checkpoints under the same tensor names as the JAX package's. Matrices
and projection biases are in ``cfg.dtype`` (bf16); norm scales and
biases, the router, the RG-LRU's gate biases and decay, and RWKV6's
mixes, decay base, bonus and group-norm scale in fp32, as there.

:func:`forward` runs the stacked groups with a Python loop over the
repeat index where the JAX package scans, slicing each stacked leaf, so
the parameters keep their tree and the names the checkpoint resolves.
With ``collect_caches`` it also returns the decode caches that
:func:`decode` reads and writes, in the JAX package's cache tree;
:func:`forward_aux` also returns the MoE layers' summed aux loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import dtypes
from repro_torch.core.tree import flatten_with_path, map_leaves
from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import constrain

from . import layers, moe, rglru, rwkv6

#: the block types with self-attention (the reference's ``ATTN_TYPES``)
ATTN_TYPES = ("full", "window", "chunked", "full_moe", "window_moe",
              "chunked_moe", "xattn")
#: every block type
BLOCK_TYPES = ATTN_TYPES + ("rec", "rwkv")


def attn_kind(btype: str) -> str:
    """The self-attention mask of a block type."""
    return btype.split("_")[0] if btype != "xattn" else "full"


def is_moe(btype: str) -> bool:
    return btype.endswith("_moe")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape, dtype name, and how it starts:
    ``init="normal"`` or ``"uniform"`` (on [0, 1)) times ``scale`` plus
    ``offset``, or ``"ones"`` (norm scales) or ``"zeros"`` (biases)."""

    shape: Tuple[int, ...]
    dtype: str
    scale: float = 0.0
    init: str = "normal"
    offset: float = 0.0


def check_supported(cfg) -> None:
    """Raise for a block type or norm the reference does not run either."""
    for pattern, _count in cfg.layer_groups:
        for btype in pattern:
            if btype not in BLOCK_TYPES:
                raise ValueError(f"{cfg.name}: block type {btype!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"{cfg.name}: norm {cfg.norm!r}")


def _norm(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    d = (cfg.d_model,)
    p = {"scale": ParamSpec(c + d, "float32", init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = ParamSpec(c + d, "float32", init="zeros")
    return p


def _attention(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    dt = cfg.dtype
    p = {"wq": ParamSpec(c + (d, H * hd), dt, s),
         "wk": ParamSpec(c + (d, KV * hd), dt, s),
         "wv": ParamSpec(c + (d, KV * hd), dt, s),
         "wo": ParamSpec(c + (H * hd, d), dt,
                         s / math.sqrt(2 * cfg.n_layers))}
    if cfg.use_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd),
                        ("bo", d)):
            p[name] = ParamSpec(c + (n,), dt, init="zeros")
    return p


def _ffn(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    s_in = 1.0 / math.sqrt(d)
    p = {"w_up": ParamSpec(c + (d, f), dt, s_in),
         "w_down": ParamSpec(c + (f, d), dt, 1.0 / math.sqrt(f)
                             / math.sqrt(2 * cfg.n_layers))}
    if cfg.act != "gelu_mlp":  # gated variants
        p["w_gate"] = ParamSpec(c + (d, f), dt, s_in)
    if cfg.use_bias:
        p["b_up"] = ParamSpec(c + (f,), dt, init="zeros")
        p["b_down"] = ParamSpec(c + (d,), dt, init="zeros")
    return p


def _moe(cfg, c: Tuple[int, ...]) -> Dict[str, Any]:
    """``repro.models.moe.init_moe``'s tree."""
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.n_layers)
    p = {"router": ParamSpec(c + (d, E), "float32", s_in),
         "w_gate": ParamSpec(c + (E, d, f), dt, s_in),
         "w_up": ParamSpec(c + (E, d, f), dt, s_in),
         "w_down": ParamSpec(c + (E, f, d), dt, s_out)}
    if cfg.shared_expert:
        p["shared"] = _ffn(cfg, c)
    return p


def _rglru(cfg, c: Tuple[int, ...]) -> Dict[str, ParamSpec]:
    """``repro.models.rglru.init_rglru_block``'s tree."""
    d, dr, dt = cfg.d_model, cfg.d_rnn, cfg.dtype
    s, sr = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dr)
    return {"w_gate_branch": ParamSpec(c + (d, dr), dt, s),
            "w_rec_in": ParamSpec(c + (d, dr), dt, s),
            "conv_w": ParamSpec(c + (cfg.conv_width, dr), dt, 0.1),
            "conv_b": ParamSpec(c + (dr,), dt, init="zeros"),
            "lam": ParamSpec(c + (dr,), "float32", 3.5, "uniform", 0.5),
            "w_a": ParamSpec(c + (dr, dr), dt, sr),
            "b_a": ParamSpec(c + (dr,), "float32", init="zeros"),
            "w_x": ParamSpec(c + (dr, dr), dt, sr),
            "b_x": ParamSpec(c + (dr,), "float32", init="zeros"),
            "w_out": ParamSpec(c + (dr, d), dt,
                               sr / math.sqrt(2 * cfg.n_layers))}


def _rwkv(cfg, c: Tuple[int, ...]) -> Dict[str, Dict[str, ParamSpec]]:
    """``repro.models.rwkv6.init_rwkv`` and ``init_channel_mix``'s
    trees."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    H, hs, lora = d // cfg.rwkv_head_size, cfg.rwkv_head_size, \
        cfg.rwkv_decay_lora
    s, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(2 * cfg.n_layers)
    f32 = "float32"
    tmix = {"mix_base": ParamSpec(c + (5, d), f32, 0.5, "uniform"),
            "mix_w1": ParamSpec(c + (d, 5 * rwkv6.MIX_LORA), dt, s),
            "mix_w2": ParamSpec(c + (5, rwkv6.MIX_LORA, d), dt, 0.01),
            "w0": ParamSpec(c + (d,), f32, 0.5, offset=-0.6),
            "w_a": ParamSpec(c + (d, lora), dt, s),
            "w_b": ParamSpec(c + (lora, d), dt, 0.01),
            "u": ParamSpec(c + (H, hs), f32, 0.1),
            "wr": ParamSpec(c + (d, d), dt, s),
            "wk": ParamSpec(c + (d, d), dt, s),
            "wv": ParamSpec(c + (d, d), dt, s),
            "wg": ParamSpec(c + (d, d), dt, s),
            "wo": ParamSpec(c + (d, d), dt, s * s_out),
            "ln_x_scale": ParamSpec(c + (d,), f32, init="ones")}
    cmix = {"mix_k": ParamSpec(c + (d,), f32, 0.5, "uniform"),
            "mix_r": ParamSpec(c + (d,), f32, 0.5, "uniform"),
            "w_in": ParamSpec(c + (d, f), dt, s),
            "w_out": ParamSpec(c + (f, d), dt, s_out / math.sqrt(f)),
            "w_r": ParamSpec(c + (d, d), dt, s)}
    return {"tmix": tmix, "cmix": cmix}


def _block(cfg, btype: str, count: int) -> Dict[str, Any]:
    c = (count,)
    p: Dict[str, Any] = {"ln1": _norm(cfg, c), "ln2": _norm(cfg, c)}
    if btype in ATTN_TYPES:
        p["attn"] = _attention(cfg, c)
        if btype == "xattn":
            p["lnx"] = _norm(cfg, c)
            p["xattn"] = _attention(cfg, c)
        if is_moe(btype):
            p["moe"] = _moe(cfg, c)
        else:
            p["ffn"] = _ffn(cfg, c)
    elif btype == "rec":
        p["rec"] = _rglru(cfg, c)
        p["ffn"] = _ffn(cfg, c)
    else:
        p.update(_rwkv(cfg, c))
    return p


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree with :class:`ParamSpec` leaves."""
    check_supported(cfg)
    n_out = (cfg.n_codebooks or 1) * cfg.vocab
    embed = {"embed": ParamSpec((n_out, cfg.d_model), cfg.dtype, 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, n_out), cfg.dtype, 0.02)
    groups = tuple(tuple(_block(cfg, btype, count) for btype in pattern)
                   for pattern, count in cfg.layer_groups)
    return {"embed": embed, "ln_f": _norm(cfg, ()), "groups": groups}


#: a leaf of more elements than this is drawn in flat pieces of this
#: many, each cast into the leaf before the next is drawn, so no leaf's
#: whole fp32 draw stands beside it (llama4-maverick's (128, 5,120,
#: 8,192) expert weights would take 21.5 GB of fp32 each)
DRAW_PIECE_ELEMS = 1 << 28


def init_params(cfg, generator: torch.Generator, device: torch.device,
                place: Optional[Callable] = None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (normal * scale, cast to the
    leaf dtype; norm scales ones, biases zeros), made on ``device``.
    Different numbers than JAX's for the same seed; tests that compare the
    packages feed both the same numpy state through
    :mod:`repro_torch.convert`. A leaf past :data:`DRAW_PIECE_ELEMS`
    elements is drawn in pieces. ``place(path, leaf)``: what to keep of each
    leaf as it is made (a rank's shard, so the whole tree is never held
    at once); the draws are the same."""
    def make(spec: ParamSpec) -> torch.Tensor:
        dt = dtypes.lookup(spec.dtype).torch
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        draw = torch.rand if spec.init == "uniform" else torch.randn
        n = math.prod(spec.shape)
        if n <= DRAW_PIECE_ELEMS:
            x = draw(spec.shape, generator=generator, device=device)
            return x.mul_(spec.scale).add_(spec.offset).to(dt)
        out = torch.empty(spec.shape, dtype=dt, device=device)
        flat = out.view(-1)
        for lo in range(0, n, DRAW_PIECE_ELEMS):
            x = draw((min(DRAW_PIECE_ELEMS, n - lo),), generator=generator,
                     device=device)
            flat[lo:lo + x.numel()] = x.mul_(spec.scale).add_(spec.offset)
        return out
    if place is None:
        return map_leaves(make, param_shapes(cfg))
    flat, unflatten = flatten_with_path(param_shapes(cfg))
    return unflatten([place(path, make(spec)) for path, spec in flat])


# ------------------------------------------------------------------ forward
def block_forward(cfg, btype: str, p: Dict[str, Any], x: torch.Tensor, *,
                  positions: torch.Tensor, n_prefix: int,
                  memory: Optional[torch.Tensor], collect_cache: bool):
    """One block on the whole sequence. Attention blocks: pre-norm
    self-attention under the block's mask (and the prefix), for ``xattn``
    pre-norm cross-attention to ``memory``, then the pre-norm FFN or MoE;
    ``rec``: the pre-norm RG-LRU block, then the FFN; ``rwkv``: pre-norm
    time-mix and channel-mix from a zero carry. Each is added to the
    residual in ``x.dtype``. Returns ``(x, cache, aux)``, the cache
    ``None`` unless ``collect_cache``, aux the MoE loss (0 elsewhere)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if btype in ATTN_TYPES:
        h = layers.apply_norm(p["ln1"], x)
        a, (k, v) = layers.attention(cfg, p["attn"], h, positions=positions,
                                     kind=attn_kind(btype),
                                     n_prefix=n_prefix)
        x = x + a.to(x.dtype)
        if btype == "xattn":
            hx = layers.apply_norm(p["lnx"], x)
            mk, mv = layers.memory_kv(cfg, p["xattn"], memory)
            x = x + layers.cross_attention(cfg, p["xattn"], hx, mk,
                                           mv).to(x.dtype)
        h2 = layers.apply_norm(p["ln2"], x)
        if is_moe(btype):
            f, aux = moe.apply_moe(cfg, p["moe"], h2)
        else:
            f = layers.apply_ffn(cfg, p["ffn"], h2)
        x = x + f.to(x.dtype)
        if collect_cache:
            cache = _cache_from_kv(cfg, btype, k, v)
            if btype == "xattn":
                cache["mk"], cache["mv"] = mk, mv
    elif btype == "rec":
        h = layers.apply_norm(p["ln1"], x)
        r, (h_last, conv) = rglru.apply_rglru_block(cfg, p["rec"], h)
        x = x + r.to(x.dtype)
        h2 = layers.apply_norm(p["ln2"], x)
        x = x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype)
        if collect_cache:
            cache = {"h": h_last, "conv": conv}
    else:  # rwkv
        h = layers.apply_norm(p["ln1"], x)
        zero_last = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                                device=x.device)
        t, (_x_t, S) = rwkv6.time_mix(cfg, p["tmix"], h, zero_last, None)
        x = x + t.to(x.dtype)
        h2 = layers.apply_norm(p["ln2"], x)
        c, _x_c = rwkv6.channel_mix(cfg, p["cmix"], h2, zero_last)
        x = x + c.to(x.dtype)
        if collect_cache:
            # the normed inputs' last token carries the token shift
            cache = {"x_t": h[:, -1, :], "S": S, "x_c": h2[:, -1, :]}
    return x, cache, aux


def _cache_from_kv(cfg, btype: str, k: torch.Tensor,
                   v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The decode cache of a block from its prefill K/V (B, S, KV, hd).

    ``full``: the prompt's positions then ``cfg.max_decode_len`` empty
    slots for the tokens generated after it. ``window``: a ring of
    ``cfg.window`` slots holding the last ``window`` positions at slots
    ``pos % window``. ``chunked``: a ring of ``cfg.chunk`` slots holding
    the current (possibly empty) partial chunk at slots ``[0, S %
    chunk)``. A prompt shorter than the ring is padded. The ring is built
    from slices of k and v joined along S (no slot-indexed write), so a
    ``DTensor`` keeps its layout through it."""
    S = k.shape[1]
    kind = attn_kind(btype)
    pad = _pad_slots
    if kind == "full":
        if cfg.max_decode_len:
            tail = (0, 0, 0, 0, 0, cfg.max_decode_len)
            return {"k": pad(k, tail), "v": pad(v, tail)}
        return {"k": k, "v": v}
    T = cfg.window if kind == "window" else cfg.chunk
    if S <= T:
        return {"k": pad(k, (0, 0, 0, 0, 0, T - S)),
                "v": pad(v, (0, 0, 0, 0, 0, T - S))}
    r = S % T
    if kind == "window":
        # position p in slot p % T: the last r positions fill slots
        # [0, r), the T - r before them slots [r, T)
        def ring(t):
            if not r:
                return t[:, S - T:]
            return torch.cat([t[:, S - r:], t[:, S - T:S - r]], dim=1)
    else:
        # the current partial chunk in slots [0, r), the rest empty
        def ring(t):
            if not r:
                return torch.zeros_like(t[:, :T])
            return pad(t[:, S - r:], (0, 0, 0, 0, 0, T - r))
    return {"k": ring(k), "v": ring(v)}


def _pad_slots(t: torch.Tensor, pad: Tuple[int, ...]) -> torch.Tensor:
    """``torch.nn.functional.pad`` of a (B, S, ...) cache tensor along S
    (``pad`` ends with ``(0, n)``). A ``DTensor`` is padded on its local
    shard, S whole there (PyTorch 2.11's sharding rule for ``pad`` fails
    on a sharded tensor): zeros added to every shard of a partial sum
    still sum to zeros."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return torch.nn.functional.pad(t, pad)
    t = shctx.unsplit(t, (1,))
    mesh = t.device_mesh
    local = torch.nn.functional.pad(t.to_local(), pad)
    shape = list(t.shape)
    shape[1] += pad[-1]
    return DTensor.from_local(local, mesh, t.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=local.new_empty(shape,
                                                     device="meta").stride())


def _embed(cfg, params: Dict[str, Any],
           tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times ``sqrt(d_model)`` in the working dtype."""
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def _embed_inputs(cfg, params: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """``(x, n_prefix, memory)``: the prompt's embeddings (:func:`_embed`)
    after the prefix-LM's ``prefix_embeds`` (cast to their dtype) where
    the config has ``n_prefix_embeds``, that count (else 0), and the
    conditioning memory (``memory_embeds`` cast likewise) of a config
    with ``n_memory_embeds``, else ``None``."""
    x = _embed(cfg, params, batch["tokens"])
    n_prefix = 0
    memory = None
    if cfg.n_prefix_embeds:
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
        n_prefix = cfg.n_prefix_embeds
    if cfg.n_memory_embeds:
        memory = batch["memory_embeds"].to(x.dtype)
    x = constrain(x, (layers.BATCH, None, None))  # reference model.py:218
    return x, n_prefix, memory


def _repeat(cfg, pattern, ps, x, aux_total, positions, n_prefix, memory,
            collect_caches, sp_spec):
    """One repeat of a layer group's pattern (the reference's scan body):
    ``(x, aux_total, caches)`` after its blocks, the residual stream
    constrained before and after it under ``sp_spec``."""
    if sp_spec is not None:
        x = constrain(x, sp_spec)
    caches = []
    for btype, pp in zip(pattern, ps):
        x, cache, aux = block_forward(
            cfg, btype, pp, x, positions=positions, n_prefix=n_prefix,
            memory=memory, collect_cache=collect_caches)
        aux_total = aux_total + aux
        caches.append(cache)
    if sp_spec is not None:
        x = constrain(x, sp_spec)
    return x, aux_total, caches


def forward_aux(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                *, collect_caches: bool = False):
    """The reference's ``forward``: ``(logits, aux, caches)``, the logits
    (B, S, vocab) (B, S, K, vocab with codebooks; S counts the prefix),
    the MoE layers' summed aux loss (fp32, 0 without MoE), and with
    ``collect_caches`` the decode caches in the JAX package's tree (else
    ``None``): one tuple per layer group of one dict per pattern position
    (``k``, ``v``, and ``mk``, ``mv`` for ``xattn``; ``h``, ``conv`` for
    ``rec``; ``x_t``, ``S``, ``x_c`` for ``rwkv``), each leaf stacked over
    the group's repeat index. With ``cfg.remat`` and grad enabled each
    repeat runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward pass, the gradients the
    same bit for bit; prefill and decode (no grad) are unchanged."""
    check_supported(cfg)
    x, n_prefix, memory = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    # one row, broadcast over the batch: a DTensor's shape is global, so
    # (B, S) would make every rank rotate the whole batch's positions
    positions = layers.positions_for(1, S, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    # Megatron sequence parallelism (reference model.py:243-253): the
    # residual stream is sequence-sharded over 'model' at the start and
    # the end of each repeat of a group's pattern
    sp_spec = (layers.BATCH, "model", None) \
        if cfg.seq_parallel_residual and S % 128 == 0 else None
    # the reference's ``jax.checkpoint`` of its scan body (model.py:256):
    # a repeat's activations are recomputed in the backward pass
    remat = cfg.remat and torch.is_grad_enabled()
    for (pattern, count), stacked in zip(cfg.layer_groups,
                                         params["groups"]):
        per_pos = [[] for _ in pattern]
        for i in range(count):
            ps = [map_leaves(lambda t: t[i], pp) for pp in stacked]
            args = (cfg, pattern, ps, x, aux_total, positions, n_prefix,
                    memory, collect_caches, sp_spec)
            if remat:
                # the recompute runs where autograd runs it (on a card,
                # a thread of its own) under this thread's mesh
                x, aux_total, cs = torch.utils.checkpoint.checkpoint(
                    _repeat, *args, use_reentrant=False,
                    preserve_rng_state=False, context_fn=lambda: (
                        contextlib.nullcontext(), shctx.current()))
            else:
                x, aux_total, cs = _repeat(*args)
            for j, cache in enumerate(cs):
                per_pos[j].append(cache)
        if collect_caches:
            caches.append(tuple(
                {key: torch.stack([c[key] for c in cs]) for key in cs[0]}
                for cs in per_pos))
    x = layers.apply_norm(params["ln_f"], x)
    logits = layers.logits_from_hidden(cfg, params["embed"], x)
    return logits, aux_total, (tuple(caches) if collect_caches else None)


def forward(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            *, collect_caches: bool = False):
    """:func:`forward_aux` without the aux: the logits, or ``(logits,
    caches)`` with ``collect_caches``."""
    logits, _aux, caches = forward_aux(cfg, params, batch,
                                       collect_caches=collect_caches)
    return (logits, caches) if collect_caches else logits


def block_decode(cfg, btype: str, p: Dict[str, Any], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    """One block on one token at ``pos``; its cache is written in place,
    so only x comes back. Attention blocks write k and v
    (:func:`layers.decode_attention`, a ring for ``window`` and
    ``chunked``; ``xattn`` reads the memory's K/V from the cache), ``rec``
    its ``h`` and ``conv``, ``rwkv`` its ``x_t``, ``S`` and ``x_c``, where
    the reference returns updated copies."""
    h = layers.apply_norm(p["ln1"], x)
    if btype in ATTN_TYPES:
        a, _k, _v = layers.decode_attention(cfg, p["attn"], h, cache["k"],
                                            cache["v"], pos,
                                            mode=attn_kind(btype))
        x = x + a.to(x.dtype)
        if btype == "xattn":
            hx = layers.apply_norm(p["lnx"], x)
            x = x + layers.cross_attention(cfg, p["xattn"], hx, cache["mk"],
                                           cache["mv"]).to(x.dtype)
        h2 = layers.apply_norm(p["ln2"], x)
        if is_moe(btype):
            f, _aux = moe.apply_moe(cfg, p["moe"], h2)
        else:
            f = layers.apply_ffn(cfg, p["ffn"], h2)
        return x + f.to(x.dtype)
    if btype == "rec":
        r, (h_last, conv) = rglru.apply_rglru_block(
            cfg, p["rec"], h, state=(cache["h"], cache["conv"]))
        cache["h"].copy_(h_last)
        cache["conv"].copy_(conv)
        x = x + r.to(x.dtype)
        h2 = layers.apply_norm(p["ln2"], x)
        return x + layers.apply_ffn(cfg, p["ffn"], h2).to(x.dtype)
    # the residual adds on reduced operands: PyTorch 2.11's DTensor cannot
    # turn the cache-sharded carry's layout into a pending sum's
    t, (x_t, S) = rwkv6.time_mix(cfg, p["tmix"], h, cache["x_t"],
                                 cache["S"], decode=True)
    x = shctx.reduced(x) + shctx.reduced(t).to(x.dtype)
    h2 = layers.apply_norm(p["ln2"], x)
    c, x_c = rwkv6.channel_mix(cfg, p["cmix"], h2, cache["x_c"])
    cache["x_t"].copy_(x_t)
    cache["S"].copy_(S)
    cache["x_c"].copy_(x_c)
    return shctx.reduced(x) + shctx.reduced(c).to(x.dtype)


def decode(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
           caches, pos: int):
    """One-token decode. ``batch["tokens"]``: (B, 1), or (B, 1, K) with
    codebooks; ``pos`` counts the prefix-LM's prefix. Returns ``(logits,
    caches)``; each layer's cache slice is written in place, so the
    stacked cache tensors that come back are the ones passed in."""
    check_supported(cfg)
    x = _embed(cfg, params, batch["tokens"])
    for (pattern, count), stacked, gcache in zip(
            cfg.layer_groups, params["groups"], caches):
        for i in range(count):
            for btype, pp, cc in zip(pattern, stacked, gcache):
                x = block_decode(cfg, btype, map_leaves(lambda t: t[i], pp),
                                 x, {key: t[i] for key, t in cc.items()},
                                 pos)
    x = layers.apply_norm(params["ln_f"], x)
    return layers.logits_from_hidden(cfg, params["embed"], x), caches


def loss_fn(cfg, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy: ``logsumexp`` over fp32 logits of the
    text positions ``[:-1]`` (the prefix-LM's prefix is not scored) minus
    the gold logit, averaged (over every codebook too), plus
    ``router_aux_coef`` times the MoE aux loss."""
    logits, aux, _caches = forward_aux(cfg, params, batch)
    if cfg.n_prefix_embeds:
        logits = logits[:, cfg.n_prefix_embeds:]
    tgt = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    if shctx.is_dtensor(lg):
        ce = _mean_ce_on_local_shards(lg, tgt)
    else:
        ce = _token_ce(lg, tgt).mean()
    return ce + cfg.router_aux_coef * aux


def _token_ce(lg: torch.Tensor, tgt: torch.Tensor, lo: int = 0,
              vocab_dims: Tuple[int, ...] = ()) -> torch.Tensor:
    """Each token's ``logsumexp(lg) - lg[tgt]`` over the last dimension.
    Inside :func:`repro_torch.sharding.context.on_local_shards`, ``lg``
    is a rank's block of the vocabulary starting at ``lo``, split among
    the ranks of the mesh dimensions ``vocab_dims``: the maximum and the
    sum of the ``logsumexp`` and the gold logit (read by the rank whose
    block holds it, zero elsewhere) are completed over them
    (:func:`repro_torch.sharding.context.reduce_local`). The maximum only
    shifts the exponentials, so it carries no gradient."""
    if not vocab_dims:
        logz = torch.logsumexp(lg, dim=-1)
        return logz - torch.gather(lg, -1, tgt[..., None])[..., 0]
    top = shctx.reduce_local(lg.detach().amax(-1), vocab_dims, "max")
    total = shctx.reduce_local(torch.exp(lg - top[..., None]).sum(-1),
                               vocab_dims)
    inside = (tgt >= lo) & (tgt < lo + lg.shape[-1])
    gold = torch.gather(lg, -1, torch.where(inside, tgt - lo, 0)[..., None])
    gold = shctx.reduce_local(torch.where(inside, gold[..., 0], 0.0),
                              vocab_dims)
    return top + torch.log(total) - gold


def _mean_ce_on_local_shards(lg: torch.Tensor,
                             tgt: torch.Tensor) -> torch.Tensor:
    """The mean of :func:`_token_ce` over every token of ``DTensor``
    logits, on each rank's local shards and vocabulary-parallel: the
    logits stay as the head's column-parallel product laid them out (the
    vocabulary over ``model``, the batch over the batch axes), the
    targets take the logits' layout on the leading dimensions, each rank
    sums its tokens' losses and the sums are added over the ranks that
    split the tokens (:func:`repro_torch.sharding.context.reduce_local`).
    Nothing gathers the vocabulary or the batch, in the backward either
    (``DTensor``'s own mean hands every rank the whole batch's
    gradient)."""
    from repro_torch.sharding.partition import local_index, spec_of
    lg = shctx.reduced(lg)
    spec = spec_of(lg.placements, lg.device_mesh, lg.ndim)
    lo = local_index(lg)[-1].start or 0
    vocab = shctx.split_dims(lg, -1)
    tokens = tuple(d for i in range(lg.ndim - 1)
                   for d in shctx.split_dims(lg, i))
    n = tgt.numel()

    def local(a, t):
        return shctx.reduce_local(_token_ce(a, t, lo, vocab).sum(),
                                  tokens) / n
    return shctx.on_local_shards(local, (lg, tgt), (spec, spec[:-1]),
                                 ((),))


# --------------------------------------------------------------- accounting
def count_params_analytic(cfg, active_only: bool = False) -> int:
    """The reference's parameter count from the config alone (norms,
    attention, ``xattn``, MoE — ``top_k`` experts when ``active_only`` —
    ``rec``, ``rwkv`` and codebooks), the ``N`` of the dry run's
    ``6·N·D``. It leaves out the projection biases and the recurrent
    blocks' per-channel vectors that :func:`param_shapes` holds, so it
    lies a little under the tree's size."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_emb = cfg.n_codebooks or 1
    total = n_emb * V * d
    if not cfg.tie_embeddings:
        total += d * n_emb * V

    def ffn_params():
        mats = 2 if cfg.act == "gelu_mlp" else 3
        return mats * d * f

    def attn_params():
        return d * H * hd + 2 * d * KV * hd + H * hd * d

    for pattern, count in cfg.layer_groups:
        for btype in pattern:
            n = 2 * d  # norms
            if btype in ATTN_TYPES:
                n += attn_params()
                if btype == "xattn":
                    n += attn_params() + d
                if is_moe(btype):
                    E = cfg.top_k if active_only else cfg.n_experts
                    n += E * 3 * d * f + d * cfg.n_experts
                    if cfg.shared_expert:
                        n += ffn_params()
                else:
                    n += ffn_params()
            elif btype == "rec":
                dr = cfg.d_rnn
                n += 2 * d * dr + 2 * dr * dr + dr * d + cfg.conv_width * dr
                n += ffn_params()
            elif btype == "rwkv":
                n += 5 * d * d + d * (5 * rwkv6.MIX_LORA) \
                    + 5 * rwkv6.MIX_LORA * d + 2 * d * cfg.rwkv_decay_lora
                n += 2 * d * f + d * d  # channel mix
            total += n * count
    return int(total)

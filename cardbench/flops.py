"""The benchmark's arithmetic of operations and bytes, and the table of
peaks (``peaks.json``): what a step or a kernel must do at its shapes,
whatever the program does to get there."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``)."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in {PEAKS_FILE}")
    return table[kind]


def attn_pairs(S: int, kind: str = "full", window: int = 0) -> int:
    """Visible (query, key) pairs of S causal queries: every key up to
    the query, or the last ``window`` of them (the query included)."""
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if kind == "window" \
        else np.zeros_like(i)
    return int((i + 1 - lo).sum())


def attn_flop(B: int, S: int, H: int, hd: int, kind: str = "full",
              window: int = 0) -> int:
    """Forward FLOP of an attention core's two products (``Q K^T`` and
    ``P V``) over the pairs its mask lets through: ``4 hd`` a pair and
    head."""
    return 4 * hd * B * H * attn_pairs(S, kind, window)


def step_flop(cfg: Dict[str, Any], B: int, S: int) -> int:
    """Model FLOP of one training step: the forward's products times 3
    (the backward's two products a forward one), no recomputation; the
    weight products, each attention core over what its mask allows, the
    cross-attention over the memory and the head. Norms, biases,
    softmax and the optimizer are left out."""
    d, H, KV, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["d_ff"]
    hd = cfg.get("head_dim") or d // H
    M = cfg.get("n_memory_embeds", 0)
    n_out = (cfg.get("n_codebooks") or 1) * cfg["vocab"]
    mats = 2 if cfg["act"] == "gelu_mlp" else 3
    T = B * S
    fwd = 2 * T * d * n_out
    for pattern, count in cfg["layer_groups"]:
        for btype in pattern:
            kind = "window" if btype == "window" else "full"
            layer = 2 * T * d * (H * hd + 2 * KV * hd) + 2 * T * H * hd * d
            layer += attn_flop(B, S, H, hd, kind, cfg.get("window", 0))
            if btype == "xattn":
                layer += 2 * T * d * H * hd + 2 * B * M * d * 2 * KV * hd
                layer += 4 * hd * B * H * S * M + 2 * T * H * hd * d
            layer += 2 * T * d * f * mats
            fwd += layer * count
    return 3 * fwd

"""The benchmark's arithmetic against counts by hand at small sizes."""

import numpy as np
import pytest

from cardbench import flops, window


@pytest.mark.parametrize("S,kind,win,pairs", [
    (4, "full", 0, 10), (4, "window", 2, 7), (5, "window", 5, 15),
    (1, "full", 0, 1), (6, "window", 1, 6)])
def test_attn_pairs(S, kind, win, pairs):
    assert flops.attn_pairs(S, kind, win) == pairs
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    mask = j <= i
    if kind == "window":
        mask &= j > i - win
    assert int(mask.sum()) == pairs


def test_step_flop_by_hand():
    # one window layer: d 8, 2 heads of 4, 1 KV head, FFN 16, vocab 10
    cfg = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "d_ff": 16,
           "vocab": 10, "act": "gelu_mlp", "window": 2,
           "layer_groups": [[["window"], 1]]}
    B, S = 3, 4
    T = B * S
    proj = 2 * T * 8 * (8 + 2 * 4) + 2 * T * 8 * 8
    core = 4 * 4 * B * 2 * 7
    ffn = 2 * T * 8 * 16 * 2
    head = 2 * T * 8 * 10
    assert flops.step_flop(cfg, B, S) == 3 * (proj + core + ffn + head)


def test_step_flop_xattn_codebooks():
    cfg = {"d_model": 8, "n_heads": 2, "n_kv_heads": 2, "d_ff": 16,
           "vocab": 10, "n_codebooks": 4, "n_memory_embeds": 3,
           "act": "gelu_mlp", "layer_groups": [[["xattn"], 2]]}
    B, S = 2, 5
    T = B * S
    self_attn = 2 * T * 8 * 24 + 2 * T * 8 * 8 + 4 * 4 * B * 2 * 15
    cross = 2 * T * 8 * 8 + 2 * B * 3 * 8 * 16 + 4 * 4 * B * 2 * S * 3 \
        + 2 * T * 8 * 8
    ffn = 2 * T * 8 * 16 * 2
    head = 2 * T * 8 * 40
    assert flops.step_flop(cfg, B, S) == 3 * (2 * (self_attn + cross + ffn)
                                              + head)


def test_peaks_table():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flop_per_s"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peaks("cpu")


@pytest.mark.parametrize("iv,busy,gaps", [
    ([(1, 3), (2, 5), (7, 8)], 5, [(0, 1), (5, 7), (8, 10)]),
    ([(0, 10)], 10, []),
    ([], 0, [(0, 10)])])
def test_busy_union(iv, busy, gaps):
    got_busy, got_gaps = window._union(iv, 0, 10)
    assert got_busy == busy and got_gaps == gaps


def test_kernel_seconds_counts_each_kernel_once():
    kernels = {"void xor_checksum_segments_kernel<8>(...)": [3, 0.5],
               "void checksum_segments_kernel<8>(...)": [2, 0.25],
               "flash_fwd_bf16<128>": [4, 2.0]}
    n, s = window.kernel_seconds(kernels, "checksum_segments_kernel",
                                 "xor_checksum_kernel")
    assert (n, s) == (5, 0.75)

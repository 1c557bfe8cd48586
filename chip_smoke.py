#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. Device: the card's name, the device count, and its name and power limit
   as ``nvidia-smi`` reports them. No card: exit non-zero, print no result.
   TF32 is off for matrix products and cuDNN, and cuBLAS gets a fixed
   workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``) so identical inputs give
   identical losses.
2. Build: the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   (into ``build/repro_torch/``), timed.
3. Kernels: each of the six kernels against its plain PyTorch version on
   the card, at odd sizes and at the main path's shapes — the five
   checkpoint kernels bit-identical, flash attention within 2e-5 (fp32)
   and 2e-2 (bf16) for the ``full``, ``window`` and ``chunked`` masks at
   S 1, 257 and 2,100 with 32/8 and 4/4 heads — then timed with CUDA
   events beside its plain version, its bound, and a library yardstick
   where one PyTorch call computes the same function (``torch.bitwise_xor``
   for ``delta_xor``, ``scaled_dot_product_attention`` for flash attention,
   timed here only; the port never calls it).
4. Checkpoint path (slice 1): llama3.2-1b at full width (d_model 2048,
   d_ff 8192, vocab 128,256, 32/8 heads, tied embeddings) cut to 2 layers:
   384.3 M params, bf16 params plus fp32 master/m/v, about 5.4 GB per save,
   made on the card from a seeded generator. Three steps of the two-phase
   loop (seeded gradients on the card; ``wait_for_capture``; in-place
   AdamW; ``save``) under ``DeltaPolicy(keyframe_every=3)`` give a keyframe
   and two deltas; then step 3 (chain verify + XOR fold) and step 1 restore
   onto the card and must equal the saved states bit for bit.
5. Training path (slice 2): the same model trained by ``Trainer`` (forward,
   backward, ``wait_for_capture``, in-place AdamW, ``save``) on batches of
   4 x 2048 tokens for 6 steps, saving at 2 (keyframe), 4 and 6 (deltas)
   with params delta-routed and fp32 optimizer state quantized to int8;
   then a fresh manager and trainer resume step 6: params bit for bit,
   master/m/v equal to the plain int8 round trip of the saved leaves, and
   one more step from each trainer gives the same loss.
6. Serving path (slice 3), on phase 5's checkpoints: ``load_params_for_
   serving`` restores the params of step 6 (chain 2, 4, 6) onto the card,
   bit for bit, reading fewer bytes than phase 5's full resume; then
   ``greedy_generate`` prefills 2 seeded prompts of 4,096 tokens (past
   2,048: the flash-attention kernel, once per layer) and decodes 32
   tokens, twice, with the same tokens both times; then three timed runs
   of the prefill and decode steps, one prefill and one decode step under
   ``torch.profiler``, and layer 0's real q/k/v through the kernel and its
   plain version.
   Kernel launch counts are zeroed just before each of phases 4, 5 and 6
   and read just after; each kernel of the phase must have run.
7. Report: a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
#: H100 SXM device memory (data sheet). The u32 kernels do a few integer
#: operations per 4-byte word and the int8 pair about twenty fp32
#: operations per value (against 67 TFLOP/s), so the bound of those five
#: is the bytes they move.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core peak (data sheet): flash attention's
#: products are bf16 at the serving shape
BF16_FLOP_PER_S = 989e12
HOST_CACHE_BYTES = 12 << 30
#: words per call on the main path: 4 MiB chunks for the encode and the
#: file checksums, 64 MiB pieces for the restore fold
MAIN_WORDS = {"checksum_u32": 1 << 20, "xor_checksum_u32": 1 << 20,
              "delta_xor": 1 << 24}
#: quantization rows per call on the main path: one 4 MiB chunk
MAIN_ROWS = 4096
#: the training phase: tokens per batch row (the longest sequence on the
#: direct attention path), batch rows, steps and the save interval
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_INTERVAL = 2048, 4, 6, 2
#: the serving phase: prompts, prompt tokens (past the 2,048 of the
#: direct attention path) and new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 4096, 32
#: flash attention at odd sizes: sequence lengths, (H, KV) heads, masks
FLASH_SEQS = (1, 257, 2100)
FLASH_HEADS = ((32, 8), (4, 4))
FLASH_KINDS = (("full", 0, 0), ("window", 200, 0), ("chunked", 0, 192))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SOURCES = {k: "src/repro_torch/kernels/csrc/ckpt_kernels.cu"
           for k in ("checksum_u32", "xor_checksum_u32", "delta_xor",
                     "quantize_checksum_int8", "dequantize_checksum_int8")}
SOURCES["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {"checksum_u32": "src/repro/kernels/checksum.py:43",
            "xor_checksum_u32": "src/repro/kernels/fused.py:78",
            "delta_xor": "src/repro/kernels/delta.py:30",
            "quantize_checksum_int8": "src/repro/kernels/fused.py:169",
            "dequantize_checksum_int8": "src/repro/kernels/fused.py:201",
            "flash_attention": "src/repro/kernels/flash_attention.py:80"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- kernels
def _kernels():
    """Each kernel's launch counter, by name."""
    from repro_torch.kernels import (checksum, delta, flash_attention, fused,
                                     quantize)
    return {"checksum_u32": checksum.KERNEL,
            "xor_checksum_u32": fused.KERNEL, "delta_xor": delta.KERNEL,
            "quantize_checksum_int8": quantize.QUANT_KERNEL,
            "dequantize_checksum_int8": quantize.DEQUANT_KERNEL,
            "flash_attention": flash_attention.KERNEL}


def _zero_launches() -> None:
    for k in _kernels().values():
        k.launches = 0


def _launches() -> dict:
    return {name: k.launches for name, k in _kernels().items()}


def _random_words(n: int, gen):
    import torch
    return torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                         device="cuda", generator=gen)


def _calls(name: str, a, b):
    """(kernel call, plain call, compare) for one kernel on inputs a, b."""
    import torch
    from repro_torch.kernels import checksum, delta, fused
    mask = checksum.U32_MASK
    if name == "checksum_u32":
        def cmp():
            got = int(checksum.checksum_cuda(a).item()) & mask
            return abs(got - checksum.checksum_plain(a))
        return (lambda: checksum.checksum_cuda(a),
                lambda: checksum.checksum_plain(a), cmp)
    if name == "xor_checksum_u32":
        def cmp():
            d, dig = fused.xor_checksum_cuda(a, b)
            dp, digp = fused.xor_checksum_plain(a, b)
            err = (d.to(torch.int64) - dp.to(torch.int64)).abs().max()
            return max(int(err.item()), abs((int(dig.item()) & mask) - digp))
        return (lambda: fused.xor_checksum_cuda(a, b),
                lambda: fused.xor_checksum_plain(a, b), cmp)

    def cmp():
        d = delta.delta_xor_cuda(a, b)
        dp = delta.delta_xor_plain(a, b)
        return int((d.to(torch.int64) - dp.to(torch.int64)).abs().max()
                   .item())
    return (lambda: delta.delta_xor_cuda(a, b),
            lambda: delta.delta_xor_plain(a, b), cmp)


def _time_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernels():
    """Parity at odd sizes and at the main path's shape, then times. The
    launches made here are not counted: counts are zeroed before each
    path."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {}
    for name in ("checksum_u32", "xor_checksum_u32", "delta_xor"):
        n_main = MAIN_WORDS[name]
        worst = 0
        for n in (1, 3, 65_537, n_main):
            a, b = _random_words(n, gen), _random_words(n, gen)
            err = _calls(name, a, b)[2]()
            torch.cuda.synchronize()
            if err != 0:
                fail(f"{name} disagrees with its plain version at {n} "
                     f"words: max |diff| {err}")
            worst = max(worst, err)
        a, b = _random_words(n_main, gen), _random_words(n_main, gen)
        kern, plain, _ = _calls(name, a, b)
        reps = 200 if n_main <= (1 << 20) else 30
        ms = _time_ms(kern, reps)
        plain_ms = _time_ms(plain, max(5, reps // 10))
        library_ms = None
        if name == "delta_xor":
            library_ms = _time_ms(lambda: torch.bitwise_xor(a, b), reps)
        # each input read once, each output written once: 4N for the
        # digest, 12N for the XOR kernels
        nbytes = (4 if name == "checksum_u32" else 12) * n_main
        rows[name] = {
            "name": name, "words": n_main, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": library_ms}
        log(f"kernel {name}: bit-identical at 1, 3, 65537, {n_main} words; "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.4f} ms"
            + (f", torch.bitwise_xor {library_ms:.4f} ms)"
               if library_ms is not None else ")"))
    rows.update(check_int8_kernels(gen))
    rows.update(check_flash_kernel(gen))
    return rows


def _int8_rows(n_rows: int, gen):
    """Seeded fp32 rows (normal, times 10) with the edge rows of the int8
    math in front: an all-zero row (scale 1.0); a row of amax 127 (scale
    exactly 1.0) holding the half steps +-0.5, +-2.5, +-3.5, +-126.5; a
    row with subnormals among normal values."""
    import torch
    x = torch.randn((n_rows, 256), generator=gen, device="cuda") * 10
    edges = [torch.zeros(256), torch.zeros(256), x[-1].cpu()]
    edges[1][:10] = torch.tensor([127, -127, 0.5, -0.5, 2.5, -2.5, 3.5,
                                  -3.5, 126.5, -126.5])
    edges[2][:3] = torch.tensor([1e-40, -3e-39, 1e-45])
    for i, e in enumerate(edges[:n_rows]):
        x[i] = e.cuda()
    return x


def check_int8_kernels(gen) -> dict:
    """The fused int8 encode and decode against their plain versions:
    payload body, digest and decoded values bit for bit at 1, 3, 257 rows
    and at a 4 MiB chunk's 4,096 rows; then timed at 4,096 rows. No single
    PyTorch call quantizes with a digest, so there is no library time."""
    import torch
    from repro_torch.kernels import checksum, quantize as tq
    mask = checksum.U32_MASK
    for n_rows in (1, 3, 257, MAIN_ROWS):
        x = _int8_rows(n_rows, gen)
        body, dig = tq.quantize_checksum_cuda(x)
        pbody, pdig = tq.quantize_checksum_plain(x)
        out, odig = tq.dequantize_checksum_cuda(body, n_rows)
        pout, podig = tq.dequantize_checksum_plain(body, n_rows)
        torch.cuda.synchronize()
        if not torch.equal(body, pbody) or (int(dig.item()) & mask) != pdig:
            fail(f"quantize_checksum_int8 disagrees with its plain version "
                 f"at {n_rows} rows")
        if not torch.equal(out.view(torch.int32), pout.view(torch.int32)) \
                or (int(odig.item()) & mask) != podig or podig != pdig:
            fail(f"dequantize_checksum_int8 disagrees with its plain "
                 f"version at {n_rows} rows")
    x = torch.randn((MAIN_ROWS, 256), generator=gen, device="cuda")
    body, _ = tq.quantize_checksum_cuda(x)
    calls = {
        "quantize_checksum_int8": (
            lambda: tq.quantize_checksum_cuda(x),
            lambda: tq.quantize_checksum_plain(x)),
        "dequantize_checksum_int8": (
            lambda: tq.dequantize_checksum_cuda(body, MAIN_ROWS),
            lambda: tq.dequantize_checksum_plain(body, MAIN_ROWS))}
    # 4 bytes in and 1 + 4/256 out per value, or the reverse
    nbytes = MAIN_ROWS * (256 * 4 + tq.body_nbytes(1))
    rows = {}
    for name, (kern, plain) in calls.items():
        ms = _time_ms(kern, 200)
        plain_ms = _time_ms(plain, 20)
        rows[name] = {
            "name": name, "rows": MAIN_ROWS, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}
        log(f"kernel {name}: bit-identical at 1, 3, 257, {MAIN_ROWS} rows; "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.5f} ms)")
    return rows


def _flash_err(got, want, tol: float) -> float:
    """Largest ``|got - want|``, or ``inf`` where ``got`` is not finite or
    lies past ``tol + tol * |want|`` (``assert_allclose`` with ``atol =
    rtol = tol``, as ``tests/test_kernels.py`` holds the Pallas kernel)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) \
            or bool((diff > tol + tol * w.abs()).any()):
        return math.inf
    return float(diff.max())


def flash_bound_ms(B: int, S: int, H: int, KV: int, hd: int,
                   itemsize: int) -> tuple:
    """(bound ms, bound_by) of causal ``full`` attention: ``4 * hd``
    FLOP per visible (query, key) pair, ``S (S + 1) / 2`` pairs per (b, h),
    against the bf16 tensor-core peak; q, k, v read once and the output
    written once against the memory rate."""
    flop = 4 * hd * B * H * S * (S + 1) // 2
    nbytes = itemsize * B * S * hd * (2 * H + 2 * KV)
    t_ops, t_bytes = flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_flash_kernel(gen) -> dict:
    """Flash attention against its plain version at odd sizes (every mask,
    both dtypes, 32/8 and 4/4 heads) and at the serving shape (B 2,
    S 4,096, 32/8 heads, hd 64, bf16, ``full``); then timed there beside
    the plain version, the bound, and PyTorch's
    ``scaled_dot_product_attention`` (causal, GQA) as the library time."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, hd = SERVE_BATCH, 64
    worst = 0.0
    cases = [(B, S, H, KV, dt, kind) for S in FLASH_SEQS
             for H, KV in FLASH_HEADS for dt in ("float32", "bfloat16")
             for kind in FLASH_KINDS]
    cases.append((B, SERVE_PROMPT, 32, 8, "bfloat16", FLASH_KINDS[0]))
    for B_, S, H, KV, dt, (kind, window, chunk) in cases:
        tdt = getattr(torch, dt)
        q = torch.randn(B_, S, H, hd, device="cuda", generator=gen).to(tdt)
        k = torch.randn(B_, S, KV, hd, device="cuda", generator=gen).to(tdt)
        v = torch.randn(B_, S, KV, hd, device="cuda", generator=gen).to(tdt)
        got = fa.flash_attention_cuda(q, k, v, kind=kind, window=window,
                                      chunk=chunk)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                        chunk=chunk)
        torch.cuda.synchronize()
        err = _flash_err(got, want, FLASH_TOL[dt])
        if got.shape != want.shape or got.dtype != q.dtype \
                or not math.isfinite(err):
            fail(f"flash_attention disagrees with its plain version at "
                 f"B {B_} S {S} heads {H}/{KV} {dt} {kind}: max |diff| "
                 f"{float((got.float() - want.float()).abs().max())!r}")
        worst = max(worst, err)
    S, H, KV = SERVE_PROMPT, 32, 8
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen) \
        .to(torch.bfloat16)
    k = torch.randn(B, S, KV, hd, device="cuda", generator=gen) \
        .to(torch.bfloat16)
    v = torch.randn(B, S, KV, hd, device="cuda", generator=gen) \
        .to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = _time_ms(lambda: fa.flash_attention_cuda(q, k, v), 50)
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v), 5)
    library_ms = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    bound_ms, bound_by = flash_bound_ms(B, S, H, KV, hd, 2)
    log(f"kernel flash_attention: within {FLASH_TOL} of its plain version "
        f"at S {FLASH_SEQS} and {SERVE_PROMPT}, heads {FLASH_HEADS}, masks "
        f"{[k[0] for k in FLASH_KINDS]}, fp32 and bf16 (max |diff| "
        f"{worst:.3g}); at B {B} S {S} heads {H}/{KV} hd {hd} bf16 causal: "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, scaled_dot_product_attention {library_ms:.4f} ms)")
    return {"flash_attention": {
        "name": "flash_attention", "shape": [B, S, H, KV, hd],
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}}


# ----------------------------------------------------------- main path
def _mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def _tensors(tree):
    import torch
    from repro_torch.core.tree import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _assert_equal(got, want: list, what: str) -> None:
    """Every tensor leaf of ``got`` equals ``want`` (in leaf order) bit for
    bit, on the same device, with the same dtype and shape."""
    import torch
    g, w = _tensors(got), want
    if len(g) != len(w):
        fail(f"{what}: {len(g)} tensor leaves restored, {len(w)} saved")
    for i, (a, b) in enumerate(zip(g, w)):
        if a.device != b.device or a.dtype != b.dtype \
                or a.shape != b.shape or not torch.equal(a, b):
            fail(f"{what}: leaf {i} differs ({a.dtype}{tuple(a.shape)}@"
                 f"{a.device} vs {b.dtype}{tuple(b.shape)}@{b.device})")


def run_main_path(device: str, cfg, workdir: str, host_cache_bytes: int,
                  flush_threads: int) -> dict:
    """Three steps of the two-phase loop with saves K, delta, delta; then
    restore steps 3 and 1 onto ``device`` and compare bit for bit."""
    import torch
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  DeltaPolicy, EnginePolicy)
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         init_opt_state)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, device)
    opt = init_opt_state(params)
    flat, unflatten = flatten_with_path(params)
    hp = AdamWConfig()

    def state(step: int) -> dict:
        return {"model": params, "optimizer": opt,
                "meta": {"step": step, "arch": cfg.name,
                         "rng": {"seed": SEED}}}

    n_params = sum(t.numel() for _p, t in flat)
    state_bytes = sum(t.numel() * t.element_size() for t in _tensors(state(0)))
    log(f"state: {cfg.name} d_model {cfg.d_model} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab} heads {cfg.n_heads}/{cfg.n_kv_heads} layers "
        f"{cfg.n_layers}: {n_params} params, {state_bytes} bytes per save")
    policy = CheckpointPolicy(
        engine=EnginePolicy(host_cache_bytes=host_cache_bytes,
                            flush_threads=flush_threads),
        delta=DeltaPolicy(keyframe_every=3))
    mgr = CheckpointManager.from_policy(workdir, policy, device=device)
    report = {"n_params": n_params, "state_bytes": state_bytes, "steps": []}
    try:
        futures = []
        step1 = None
        stall = 0.0
        for step in (1, 2, 3):
            grads = unflatten([
                (torch.randn(t.shape, generator=gen, device=device)
                 * 1e-2).to(t.dtype) for _p, t in flat])
            stall = mgr.wait_for_capture()
            if futures:
                futures[-1][1]["capture_stall_s"] = stall
            apply_updates(params, opt, grads, hp)
            del grads
            t0 = time.perf_counter()
            fut = mgr.save(step, state(step))
            row = {"step": step, "prologue_s": time.perf_counter() - t0}
            futures.append((fut, row))
            if step == 1:
                step1 = [t.clone() for t in _tensors(state(1))]
        futures[-1][1]["capture_stall_s"] = mgr.wait_for_capture()
        mgr.wait_for_persist()
        mgr.wait_for_commit()
        if mgr.commit_errors:
            fail(f"commit errors: {mgr.commit_errors}")
        for fut, row in futures:
            st = fut.stats
            man = mgr.repository.manifest(fut.step)
            row.update(kind=("keyframe" if st.extra["delta"]["keyframe"]
                             else "delta"),
                       persist_s=st.persist_latency_s,
                       commit_s=st.commit_latency_s,
                       bytes_written=man.total_bytes)
            report["steps"].append(row)
            log(f"save step {row['step']} ({row['kind']}): prologue "
                f"{row['prologue_s']:.4f} s, capture stall "
                f"{row['capture_stall_s']:.4f} s, persist "
                f"{row['persist_s']:.3f} s, commit {row['commit_s']:.3f} s, "
                f"{row['bytes_written']} bytes written")
        report["launches_save"] = _launches()
        for step, want in ((3, _tensors(state(3))), (1, step1)):
            before = _launches()
            t0 = time.perf_counter()
            out = mgr.restore(state(0), step=step)
            if device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            st = mgr.last_restore_stats
            _assert_equal(out, want, f"restore of step {step}")
            if out["meta"]["step"] != step:
                fail(f"restore of step {step} carried meta step "
                     f"{out['meta']['step']}")
            row = {"step": step, "total_s": secs, "verify_s": st.verify_s,
                   "read_s": st.read_s, "fold_s": st.fold_s,
                   "assemble_s": st.assemble_s, "bytes_read": st.bytes_read,
                   "launches": {k: n - before[k]
                                for k, n in _launches().items()}}
            report.setdefault("restores", []).append(row)
            log(f"restore step {step}: {secs:.3f} s (verify "
                f"{st.verify_s:.3f} s, read {st.read_s:.3f} s, fold "
                f"{st.fold_s:.3f} s, assemble {st.assemble_s:.3f} s), "
                f"{st.bytes_read} bytes read, bit-exact")
            del out
        for s in (1, 2, 3):
            res = mgr.repository.verify_step(s, check_checksums=False)
            if not res.ok:
                fail(f"step {s} incomplete on disk: {res.problems}")
        report["pinned_bytes"] = mgr.engine.host_cache.capacity \
            if mgr.engine.host_cache.pinned else 0
    finally:
        mgr.close()
    return report


def _mixed_policy(host_cache_bytes: int, flush_threads: int):
    """The README's policy: params delta-routed under a keyframe every 3
    saves, fp32 optimizer state quantized to int8."""
    from repro_torch.core import (CheckpointPolicy, DeltaPolicy,
                                  EnginePolicy, StateProviderRegistry)
    return CheckpointPolicy(
        engine=EnginePolicy(host_cache_bytes=host_cache_bytes,
                            flush_threads=flush_threads),
        delta=DeltaPolicy(keyframe_every=3),
        providers=(StateProviderRegistry()
                   .add_rule(provider="quantized", domain="optimizer",
                             dtype="float32")
                   .add_rule(provider="auto")))


def _int8_error_bound(amax):
    """How far an int8 round trip may move a value of a row whose largest
    magnitude is ``amax``: half a quantization step (``amax / 254``), plus
    the fp32 rounding of the scale, the quotient and the product (at most
    ``2 * 2^-24 * amax``, taken as ``2^-22 * amax``), plus the whole value
    in a row the reference flushes (a scale below the least normal float,
    so ``amax < 127 * 2^-126``)."""
    return amax / 254 + amax * 2.0 ** -22 + 127 * 2.0 ** -126


def _check_int8_round_trip(got, saved, what: str) -> None:
    """``got`` is bit for bit the plain dequantize of the plain quantize of
    ``saved`` (rows of 256 from the leaf's first value, the tail padded
    with zeros as the codec pads it), computed on ``saved``'s device, and
    lies within :func:`_int8_error_bound` of ``saved``."""
    import torch
    from repro_torch.kernels import quantize as tq
    x = saved.reshape(-1)
    pad = (-x.numel()) % tq.ROW_ELEMS
    rows = torch.cat([x, x.new_zeros(pad)]).reshape(-1, tq.ROW_ELEMS)
    body, _ = tq.quantize_checksum_plain(rows)
    want, _ = tq.dequantize_checksum_plain(body, rows.shape[0])
    want = want.reshape(-1)[:x.numel()]
    g = got.reshape(-1)
    if got.device != saved.device or got.dtype != torch.float32 \
            or not torch.equal(g.view(torch.int32), want.view(torch.int32)):
        fail(f"{what}: restored values are not the int8 round trip of the "
             f"saved ones")
    amax = rows.abs().amax(dim=1).repeat_interleave(tq.ROW_ELEMS)
    amax = amax[:x.numel()].double()
    err = (g.double() - x.double()).abs()
    excess = err - _int8_error_bound(amax)
    if bool((excess > 0).any()):
        i = int(excess.argmax())
        fail(f"{what}: value {i} moved by {float(err[i])!r}, more than "
             f"half a quantization step of its row (amax "
             f"{float(amax[i])!r})")


def run_train_path(device: str, cfg, workdir: str, host_cache_bytes: int,
                   flush_threads: int, batch: int, seq_len: int,
                   steps: int = TRAIN_STEPS,
                   interval: int = TRAIN_INTERVAL) -> tuple:
    """Train ``steps`` steps saving every ``interval`` under the mixed
    policy, resume the last step with a fresh manager and trainer, check
    the restored state, and take one more step from each trainer. Returns
    ``(report, host copies of the last saved step's param leaves)``."""
    import torch
    from repro_torch.core import CheckpointManager
    from repro_torch.core.tree import leaves
    from repro_torch.obs import trace as obs
    from repro_torch.training.loop import Trainer

    class RecordingManager(CheckpointManager):
        """The manager, keeping each save's future for the report."""

        def save(self, step, state, blocking=False):
            fut = super().save(step, state, blocking)
            self.futures.append(fut)
            return fut

    policy = _mixed_policy(host_cache_bytes, flush_threads)
    mgr = RecordingManager.from_policy(workdir, policy, device=device)
    mgr.futures = []
    report = {"batch": batch, "seq_len": seq_len, "steps": []}
    try:
        tr = Trainer(cfg, batch=batch, seq_len=seq_len, manager=mgr,
                     seed=SEED, device=device)
        with obs.tracing() as tracer:
            t0 = time.perf_counter()
            records = tr.run(steps, ckpt_interval=interval)
            report["run_s"] = time.perf_counter() - t0
        report["exit_drain_s"] = tr.exit_drain_s
        report["quantize_launches_per_save"] = \
            _launches()["quantize_checksum_int8"] / len(mgr.futures)
        spans = {e["args"]["step"]: e
                 for e in tracer.spans("train.iteration")}
        for r in records:
            sp = spans[r.step]
            # a save is in flight from its request until it persisted
            inflight = [f.step for f in mgr.futures if f.step < r.step
                        and f.stats.t_request < sp["t1"]
                        and f.stats.t_persisted > sp["t0"]]
            if not math.isfinite(r.loss):
                fail(f"train step {r.step}: loss {r.loss}")
            report["steps"].append({
                "step": r.step, "loss": r.loss, "iter_s": r.iter_s,
                "grad_s": r.grad_s, "stall_s": r.ckpt_stall_s,
                "prologue_s": r.prologue_s, "saved": r.ckpt_requested,
                "saves_in_flight": inflight})
            log(f"train step {r.step}: loss {r.loss:.6f}, iteration "
                f"{r.iter_s:.4f} s, forward+backward {r.grad_s:.4f} s, "
                f"stall {r.ckpt_stall_s:.4f} s (prologue "
                f"{r.prologue_s:.4f} s), saves in flight {inflight}")
        if mgr.commit_errors:
            fail(f"commit errors: {mgr.commit_errors}")
        report["saves"] = []
        for fut in mgr.futures:
            st = fut.stats
            row = {"step": fut.step,
                   "kind": ("keyframe" if st.extra["delta"]["keyframe"]
                            else "delta"),
                   "prologue_s": st.blocking_s,
                   "capture_s": st.capture_latency_s,
                   "persist_s": st.persist_latency_s,
                   "commit_s": st.commit_latency_s,
                   "bytes_written":
                       mgr.repository.manifest(fut.step).total_bytes,
                   "codecs": st.extra.get("domains")}
            report["saves"].append(row)
            log(f"save step {row['step']} ({row['kind']}): prologue "
                f"{row['prologue_s']:.4f} s, capture {row['capture_s']:.3f}"
                f" s, persist {row['persist_s']:.3f} s, commit "
                f"{row['commit_s']:.3f} s, {row['bytes_written']} bytes "
                f"written")
        # the first trainer goes on without its manager; free its pinned
        # cache before the second one pins its own
        tr.manager = None
    finally:
        mgr.close()
    del mgr
    gc.collect()

    mgr2 = CheckpointManager.from_policy(workdir, policy, device=device)
    try:
        tr2 = Trainer(cfg, batch=batch, seq_len=seq_len, manager=mgr2,
                      seed=SEED + 1, device=device)
        before = _launches()
        t0 = time.perf_counter()
        step = tr2.resume(step=steps)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = tr2.last_resume_stats
        if step != steps or tr2.pipeline.state != tr.pipeline.state:
            fail(f"resume gave step {step}, data cursor "
                 f"{tr2.pipeline.state}; saved {steps}, "
                 f"{tr.pipeline.state}")
        for i, (a, b) in enumerate(zip(leaves(tr2.params),
                                       leaves(tr.params))):
            if a.device != b.device or a.dtype != b.dtype \
                    or not torch.equal(a, b) or not a.requires_grad:
                fail(f"resume: param leaf {i} is not the saved one")
        if not torch.equal(tr2.opt_state["count"], tr.opt_state["count"]):
            fail("resume: the optimizer step count differs")
        for key in ("master", "m", "v"):
            for i, (a, b) in enumerate(zip(leaves(tr2.opt_state[key]),
                                           leaves(tr.opt_state[key]))):
                _check_int8_round_trip(a, b, f"resume: {key} leaf {i}")
        report["restore"] = {
            "step": step, "total_s": secs, "verify_s": st.verify_s,
            "read_s": st.read_s, "fold_s": st.fold_s,
            "assemble_s": st.assemble_s, "bytes_read": st.bytes_read,
            "launches": {k: n - before[k] for k, n in _launches().items()}}
        log(f"resume step {step}: {secs:.3f} s (verify {st.verify_s:.3f} s,"
            f" read {st.read_s:.3f} s, fold {st.fold_s:.3f} s, assemble "
            f"{st.assemble_s:.3f} s), {st.bytes_read} bytes read; params "
            f"bit-exact, master/m/v the int8 round trip of the saved state")
        # the params of the last save, kept on the host for the serving
        # phase: the step below changes them
        saved_params = [t.detach().to("cpu", copy=True)
                        for t in leaves(tr.params)]
        # one more step from each: the loss reads only the params and the
        # data cursor, both restored exactly
        after = [t.run(1)[-1] for t in (tr, tr2)]
    finally:
        mgr2.close()
    a, b = after[0].loss, after[1].loss
    rel = abs(a - b) / abs(a)
    report["next_step"] = {"step": after[0].step, "loss": a,
                           "resumed_loss": b, "bit_identical": a == b,
                           "rel_diff": rel,
                           "grad_s": [r.grad_s for r in after]}
    if not (math.isfinite(a) and rel <= 1e-6):
        fail(f"step {after[0].step} after resume: loss {b!r}, the "
             f"uninterrupted trainer's {a!r}")
    log(f"step {after[0].step} from both trainers: loss {a!r} and {b!r} "
        f"({'bit-identical' if a == b else f'relative difference {rel}'}); "
        f"forward+backward {after[0].grad_s:.4f} s and "
        f"{after[1].grad_s:.4f} s with no save in flight")
    return report, saved_params


def _profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time up to a
    synchronize (profiler on), the device's busy time (the sum of the
    self time of every device-side event — kernels, copies, fills — on one
    stream, so nothing overlaps) and the ``top`` device events by time, as
    ``[name, ms, calls]``. Host-side operators are left out: their device
    time is their kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    if not events:
        fail("torch.profiler recorded no device time on the card")
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in events[:top]]}


def run_serve_path(device: str, cfg, workdir: str, step: int, saved: list,
                   full_restore_bytes: int, batch: int, prompt_len: int,
                   n_new: int) -> dict:
    """Serve from the training checkpoint of ``step`` in ``workdir``:
    restore its params (``model`` domain only) onto ``device`` and hold
    them against ``saved`` bit for bit and their bytes read below
    ``full_restore_bytes``; generate ``n_new`` tokens greedily from
    ``batch`` seeded prompts of ``prompt_len`` tokens twice (same tokens
    both times), counting the attention kernel's launches over one run.
    The launch counts of the whole phase are read right after; the timed
    run and the kernel check on layer 0's q/k/v come after that."""
    import torch
    from repro_torch.core import dtypes
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.serving import engine

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    template = map_leaves(
        lambda spec: torch.empty(spec.shape, device=device,
                                 dtype=dtypes.lookup(spec.dtype).torch),
        M.param_shapes(cfg))
    t0 = time.perf_counter()
    params, st = engine.load_params_for_serving(workdir, template, step=step)
    sync()
    secs = time.perf_counter() - t0
    got = leaves(params)
    if len(got) != len(saved):
        fail(f"serving restore: {len(got)} param leaves, {len(saved)} saved")
    for i, (a, b) in enumerate(zip(got, saved)):
        if a.device.type != device or a.dtype != b.dtype \
                or not torch.equal(a.cpu(), b):
            fail(f"serving restore: param leaf {i} is not step {step}'s")
    if not 0 < st.bytes_read < full_restore_bytes:
        fail(f"serving restore read {st.bytes_read} bytes, not fewer than "
             f"the full resume's {full_restore_bytes}")
    report = {"restore": {
        "step": step, "total_s": secs, "verify_s": st.verify_s,
        "read_s": st.read_s, "fold_s": st.fold_s,
        "assemble_s": st.assemble_s, "bytes_read": st.bytes_read,
        "full_resume_bytes_read": full_restore_bytes}}
    log(f"serving restore of step {step} (params only): {secs:.3f} s "
        f"(verify {st.verify_s:.3f} s, read {st.read_s:.3f} s, fold "
        f"{st.fold_s:.3f} s, assemble {st.assemble_s:.3f} s), "
        f"{st.bytes_read} bytes read (full resume {full_restore_bytes}); "
        f"bit-exact")

    gen = torch.Generator().manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           dtype=torch.int32).to(device)
    prompt = {"tokens": tokens}
    runs = []
    for _ in range(2):
        before = fa.KERNEL.launches
        t0 = time.perf_counter()
        out = engine.greedy_generate(cfg, params, prompt, n_new)
        sync()
        runs.append((out, time.perf_counter() - t0,
                     fa.KERNEL.launches - before))
    (out, gen_s, n_flash), (out2, _s, _n) = runs
    report["launches"] = _launches()
    if out.shape != (batch, n_new) or out.device.type != device \
            or bool(((out < 0) | (out >= cfg.vocab)).any()):
        fail(f"greedy_generate gave {out.dtype}{tuple(out.shape)} on "
             f"{out.device} with tokens outside the vocabulary")
    if not torch.equal(out, out2):
        fail("greedy_generate gave other tokens the second time")
    want_flash = cfg.n_layers if on_card else 0
    if n_flash != want_flash:
        fail(f"one greedy_generate launched flash attention {n_flash} "
             f"times, not {want_flash} (one per layer in the prefill; "
             f"decode takes the direct path)")

    # the same steps, timed on the host clock up to a synchronize: one
    # prefill, then n_new decode steps, three times
    cfg_n = dataclasses.replace(cfg, max_decode_len=n_new)
    prefill = engine.make_prefill_step(cfg_n)
    decode = engine.make_decode_step(cfg_n)

    def next_token(logits):
        return torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]

    def timed_generate():
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompt)
        sync()
        t1 = time.perf_counter()
        toks = []
        for i in range(n_new):
            toks.append(next_token(logits))
            logits, caches = decode(params, toks[-1], caches, prompt_len + i)
        sync()
        if not torch.equal(torch.cat(toks, 1), out):
            fail("the timed prefill and decode steps gave other tokens than "
                 "greedy_generate")
        return t1 - t0, time.perf_counter() - t1

    times = [timed_generate() for _ in range(3)]
    prefill_s = min(t[0] for t in times)
    decode_s = min(t[1] for t in times)
    report.update(
        tokens=out.cpu().tolist(), generate_s=[r[1] for r in runs],
        flash_launches_per_generate=n_flash,
        prefill_ms=[t[0] * 1e3 for t in times],
        decode_ms_per_step=[t[1] * 1e3 / n_new for t in times],
        decode_tokens_per_s=batch * n_new / decode_s,
        generate_tokens_per_s=batch * n_new / min(r[1] for r in runs))
    log(f"serving: {batch} prompts x {prompt_len} tokens, {n_new} new "
        f"tokens, the same twice; greedy_generate "
        f"{', '.join(f'{r[1]:.3f}' for r in runs)} s (best "
        f"{report['generate_tokens_per_s']:.1f} tokens/s), flash launches "
        f"per greedy_generate {n_flash}; timed x3: prefill "
        f"{', '.join(f'{t:.2f}' for t in report['prefill_ms'])} ms, decode "
        f"{', '.join(f'{t:.3f}' for t in report['decode_ms_per_step'])} ms "
        f"per step of {batch} tokens (best "
        f"{report['decode_tokens_per_s']:.1f} tokens/s)")
    if on_card:
        logits, caches = prefill(params, prompt)
        nxt = next_token(logits)
        report["profile"] = {
            "prefill": _profile(lambda: prefill(params, prompt)),
            "decode": _profile(lambda: decode(params, nxt, caches,
                                              prompt_len))}
        for name, prof in report["profile"].items():
            log(f"profile of one {name} step: wall {prof['wall_ms']:.2f} "
                f"ms, device busy {prof['device_ms']:.2f} ms; top kernels "
                f"(ms, calls): {json.dumps(prof['top'])}")
        del logits, caches

    # layer 0's real q/k/v through the kernel and its plain version
    with torch.no_grad():
        p0 = map_leaves(lambda t: t[0], params["groups"][0][0])
        x = M._embed_inputs(cfg, params, tokens)
        h = layers.apply_norm(p0["ln1"], x)
        q, k, v = layers.project_qkv(
            cfg, p0["attn"], h, layers.positions_for(batch, prompt_len,
                                                     x.device))
        want = fa.flash_attention_plain(q, k, v, kv_block=cfg.attn_kv_block)
        got = (fa.flash_attention_cuda(q, k, v) if on_card else want)
        sync()
    err = _flash_err(got, want, FLASH_TOL["bfloat16"])
    if not math.isfinite(err):
        fail("flash_attention disagrees with its plain version on layer "
             "0's q/k/v of the served prompts")
    report["layer0_max_abs_err"] = err
    log(f"layer 0's q/k/v {tuple(q.shape)}/{tuple(k.shape)}: kernel within "
        f"{FLASH_TOL['bfloat16']} of the plain version (max |diff| "
        f"{err:.3g})")
    return report


def main() -> None:
    # before CUDA starts: cuBLAS picks its workspace once per handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs import get_config, uniform_groups
        from repro_torch.kernels import build
    except ImportError as exc:
        fail(f"the repro_torch package is not next to this script: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}; TF32 off; "
        f"CUBLAS_WORKSPACE_CONFIG={os.environ['CUBLAS_WORKSPACE_CONFIG']}")

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    rows = check_kernels()

    need = HOST_CACHE_BYTES + (16 << 30)
    avail = _mem_available_bytes()
    if avail < need:
        fail(f"host memory: {avail / 2**30:.1f} GiB available, the main "
             f"path needs {need / 2**30:.0f} GiB (a 12 GiB pinned host "
             f"cache plus restore buffers)")
    cfg = get_config("llama3.2-1b", n_layers=2,
                     layer_groups=uniform_groups("full", 2))
    workdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")

    # -- phase 4: the checkpoint path of slice 1 --------------------------
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_main_path("cuda", cfg, workdir, HOST_CACHE_BYTES,
                               flush_threads=8)
        launches = _launches()
        main_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for k in ("checksum_u32", "xor_checksum_u32", "delta_xor"):
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the checkpoint path")
    log(f"checkpoint path: {main_s:.1f} s; launches {json.dumps(launches)} "
        f"(saves {json.dumps(report['launches_save'])}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
        f"pinned host cache {report['pinned_bytes']} bytes")
    log("report " + json.dumps(report))
    del report
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 5 and 6: training (slice 2), then serving from its
    # checkpoints (slice 3) before they are removed ------------------------
    path_launches = {"checkpoint": launches}
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report, saved_params = run_train_path(
            "cuda", cfg, workdir, HOST_CACHE_BYTES, flush_threads=8,
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        launches = path_launches["training"] = _launches()
        train_s = time.perf_counter() - t0
        for k, n in launches.items():
            if n == 0 and k != "flash_attention":
                fail(f"kernel {k} was never launched on the training path")
        log(f"training path: {train_s:.1f} s; launches "
            f"{json.dumps(launches)}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes")
        log("train report " + json.dumps(report))
        full_resume_bytes = report["restore"]["bytes_read"]
        del report
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_serve_path("cuda", cfg, workdir, TRAIN_STEPS,
                                saved_params, full_resume_bytes,
                                batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                                n_new=SERVE_NEW)
        launches = path_launches["serving"] = report["launches"]
        serve_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for k in ("checksum_u32", "delta_xor", "flash_attention"):
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the serving path")
    log(f"serving path: {serve_s:.1f} s; launches {json.dumps(launches)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log("serve report " + json.dumps(report))

    # launches: summed over the three paths, each counted from zero
    line = {"kernels": [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k],
        "launches": sum(p[k] for p in path_launches.values()),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k, r in rows.items()]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()

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
   (into ``build/repro_torch/``), timed; then what was compiled for the
   attention kernels: ptxas' registers and spills, and the count of
   ``wgmma`` (HGMMA), TMA (UTMALDG, UTMASTG), mbarrier (SYNCS),
   ``mma.sync`` (HMMA) and SFU exponential instructions in their SASS
   (``cuobjdump -sass``); the bf16 kernel must have ``wgmma`` and TMA
   loads and no ``mma.sync``.
3. Kernels: each of the eleven kernels against its plain PyTorch version
   on the card, at odd sizes and at the main path's shapes — the ten
   checkpoint and reduction kernels bit-identical (the reduction kernels
   with NaN, inf, subnormal and tie values in their inputs; ``delta_xor``
   also at 4 and 5 words, around a block's tile, with a partial last tile
   and on words at a 4-byte offset; the downcast also at (256, 768) and,
   through its flat entry, at lengths with a partial tile), flash
   attention within 2e-5 (fp32) and 2e-2 (bf16) for the ``full``,
   ``window`` (200, and 32: narrower than a tile) and ``chunked`` (192:
   across tiles) masks at S 1, 127, 128, 129, 257 and 2,100, and 300
   queries over 200 keys, with 32/8 and 4/4 heads, at hd 64, 128 and
   256, and with the prefix-LM's prefix of 256 (``full`` and ``window``
   200 at S 2,100 and 300 over 200, every hd); its row stats within 1e-3
   and ``layers._Flash``'s gradients (relative L2 error, 1e-4 fp32, 2e-2
   bf16) against the plain version's, also at phase 11b's shape; each
   timed attention shape held against the plain version first (hd 64 at
   phase 6's, hd 128 at phase 11a's, hd 256 at 12a's and 12b's) — then
   timed with CUDA
   events beside its plain version, its bound (flash attention also as
   TFLOP/s and its share of the bound), and a library yardstick where one
   PyTorch call computes the
   same function (``torch.bitwise_xor`` for ``delta_xor``,
   ``scaled_dot_product_attention`` for flash attention,
   ``x.to(torch.bfloat16)`` for the downcast, ``torch.mul`` for
   ``dequantize_int8``, ``torch.sub`` for ``delta_f32``; timed here only,
   the port never calls them; a kernel and its library call are timed in
   turns, library, kernel, kernel, library, each after an untimed turn of
   the same call). ``delta_xor``, ``delta_f32``, the downcast and their
   library calls are also timed on the device alone (``torch.profiler``:
   the kernels' own time, no host time between launches). The digest
   ``checksum_u32`` is checked in one segment and in segments (every case
   of ``variants.CHECKSUM_CASES``: none, short last segments, trailing
   words, the 64 MiB piece) and timed, wrapper and device, at one 4 MiB
   chunk and at one 64 MiB piece of 16 chunks (``file_checksum``'s call);
   a 4 MiB call must show one device record under the profiler, the
   kernel's, and no fill. The fused XOR digest likewise: its one-segment
   entry at ``variants.XOR_SIZES`` words, its segmented one at every
   layout of ``variants.XOR_CASES`` (no words, short last segments, byte
   tails of 1 and 3 bytes, 4, 5, 16 and 17 segments, the 64 MiB piece) and
   at a 4-byte offset, one device record a 4 MiB call, timed at a 4 MiB
   chunk, the delta provider's 32 MiB piece of 8 chunks and a 64 MiB
   piece of 16. The fused int8 pair likewise: its one-segment
   entries at 1, 3, 257 and 4,096 rows, its segmented ones at every
   layout of ``variants.INT8_CASES`` (tensors under one row, ragged
   tails, 1-row and short segments, 16, 17 and 32 segments, the 64 MiB
   piece) with NaN, inf, subnormal, zero and tie rows in the first and
   last segment, one device record a 4 MiB call, timed at a 4 MiB chunk
   and a 64 MiB piece of 16 chunks.
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
7. Offline reduction path (slice 4): the same model's state at one layer
   (full width) made on the card from a seeded generator, two in-place
   AdamW steps on seeded gradients, each followed by saves of two
   ``DifferentialCheckpointer`` streams (keyframe every 3: K, delta):
   ``quant="bf16"`` of the fp32 master (stacked leaves folded to 2-D) and
   ``quant="int8"`` of the fp32 first moment (each leaf as rows of 256);
   then steps 1-2 restore and must equal, bit for bit, the working arrays
   the plain versions give on the card; then the ``dequantize_int8``
   kernel on step 2's restored q is within one scale of the saved
   moment.
8. Engines (slice 10): the four engines the paper compares, in its order
   (``sync``, ``snapshot``, ``datastates-old``, ``datastates``), each from
   the same seed under a raw policy (the baselines refuse delta and
   quantized routes): ``Trainer`` at 4 x 2048 tokens takes 3 steps saving
   at 2 and waits for the commit; a fresh manager verifies step 2 (every
   file hashed on the card) and a fresh trainer resumes it: params and
   optimizer state equal, bit for bit, device copies taken as the save
   was requested and the first mode's, and step 3's loss equals the
   first trainer's bit for bit. Each mode's directory is removed after
   its check. One ``engines`` JSON line: per mode the stall per save,
   step 3's iteration beside the save and alone, persist and commit
   times, bytes and files written, restore time (the verify, and the
   resume: index, reads, assembly), bytes read and ``checksum_u32``
   launches at save and commit and at restore (verify and resume).
   Kernel launch counts are zeroed just before each of phases 4, 5, 6,
   10 (run right after 6), 7, 8, 9a, 9b, 11a, 11b, 12a, 12b, 12c, 13 and
   14
   and read just after; each
   kernel of the phase must have run. Phases
   4-6 log the digest's launches and each restore's chain-verify time;
   phases 4-5 the XOR digest's launches, the ``encode.delta`` span time
   and span count of each delta save, the persist times and the peak
   device memory; phase 5 also the int8 pair's launches, the
   ``encode.int8`` span time a save and the resume's read time.
9. Multi-rank saves (slice 11), at the same width. (a) Phase 4's path
   through four writer ranks of the thread runtime in two nodes of the
   commit tree (``DistPolicy(world=4, node_size=2)``; the state's plain
   tensors all on one card take ``partition_records``' byte balance):
   saves K, delta, delta; each step must hold four rank files, four rank
   manifests and two node manifests; a fresh world-1 manager restores
   steps 3 and 1 bit for bit; per save the stall, persist and commit
   times, each rank's bytes and persist time and the max/min bytes.
   (b) A ``Trainer`` takes 2 steps; its state, laid out ``tp_zero1`` on a
   (data 2 x model 4) mesh of virtual devices by ``shard_tree``, is saved
   raw by four spawned writer processes on the card (after a tiny step-0
   save that waits out their start-up): every rank writes and votes,
   bytes written equal the state's unique bytes; the parent then
   consolidates the step's four rank files into two aggregates
   (``consolidate_step_dir(group=2)``, originals removed; logs its
   seconds, bytes read and written, files before and after); a fresh
   world-1 manager restores the aggregates onto a (data 4 x model 2)
   mesh and, through a fresh trainer, onto unsharded tensors, both bit
   for bit, and the resumed trainer's next loss equals the uninterrupted
   one bit for bit. Logs the ship time (device-to-host copy and pipe),
   stall, persist and commit, and the children's peak device memory.
10. Tiers and the fleet fabric (slice 12), run right after phase 6 on
   phase 5's steps 2, 4 and 6 (keyframe, delta, delta; about 4.18 GB)
   before they are removed, with one ``ObjectStoreBackend`` tier of no
   modelled latency or bandwidth (every time is the host's own work),
   under ``build/chip_smoke_tiers/``. (a) ``cascade_step(6)`` ships the
   chain whole: the tier must hold steps 2, 4 and 6, each catalog object
   visible after its data objects, its data bytes those of the local
   files. (b) A fresh ``CheckpointManager`` on an empty root with that
   tier, and a fresh ``Trainer``, resume the newest step: each chain
   member fetched from the tier and admitted by ``admit_fetched_step``'s
   digests on the card, the state bit for bit phase 5's resumed state,
   step 7's loss bit-equal to phase 5's; ``checksum_u32``, ``delta_xor``
   and ``dequantize_checksum_int8`` must have run. (c) Two serving
   replicas (threads), one on each of two empty host roots (four, two a
   root, took the smoke over its time; two replicas sharing a root run in
   ``tests/test_torch_fleet.py`` on the card), call
   ``load_params_for_serving(step=6, fleet=...)`` at once through one
   ``FleetFabric(device="cuda")``: params bit for bit
   step 6's, the store's bytes out at most 1.25 x the chain, each root
   admitting each step once, the fabric's ledger in each root; fails
   first if the host has under 24 GiB available. (d) ``python -m
   repro_torch.storage.cli --root <host 0> verify`` exits 0 (digests on
   the card) and ``stats --fleet`` prints the ledger's replica count for
   step 6. One ``tiers report`` JSON line: each cascade event's bytes and
   seconds, the resume's fetch, admission, verify and restore seconds,
   remote, peer and cache bytes, each replica's seconds, launches.
11. The attention-family model zoo (slice 13), under
   ``build/chip_smoke_zoo/``. (a) gemma3-27b at full width cut to 2
   layers (1 ``window`` + 1 ``full``): saved once, restored by
   ``load_params_for_serving`` bit for bit, ``greedy_generate`` of 2 x
   4,096 tokens for 32 twice (the same tokens; two hd-128 launches a
   prefill by mask, none in decode; each decode step writes ring slot
   ``pos % 1024`` alone), and one more prefill whose every layer's real
   q, k, v go through the kernel and the plain version. (b) musicgen-
   medium at full width cut to 4 layers trained at 2 x 4,096 tokens
   through the kernel with row stats and ``layers._Flash``: 3 steps
   saving at 2, a bit-exact resume, step 3's loss bit-equal. One ``zoo
   report`` JSON line.
12. The rest of the zoo (slice 14), at full width, under
   ``build/chip_smoke_zoo/``. (a) recurrentgemma-2b cut to 3 layers (rec,
   rec, window 2,048; hd 256) and (b) paligemma-3b cut to 2 layers (the
   prefix-LM: 256 patch embeddings before 3,840 tokens; hd 256) as 11a:
   one save, a bit-exact restore, ``greedy_generate`` of 2 prompts for 32
   tokens twice (the same tokens; a prefill launches ``{256/window: 1}``
   and ``{256/full/prefix: 2}``), each decode step writing ring slot
   ``pos % 2048`` alone and shifting each ``rec`` layer's convolution
   window by one, the ``rec`` state after decode within a relative L2
   error of 2e-2 of a prefill over the same tokens, every attention
   layer's real q, k, v through the kernel and the plain version. (c)
   dbrx-132b (MoE, 16 experts top 4) and rwkv6-7b, 1 layer each, from
   seeded params without a save: ``greedy_generate`` of 2 x 4,096 tokens
   for 32 twice, the same tokens (dbrx's prefill ``{128/full: 1}``), and
   rwkv's prefill of 4,080 tokens and 16 decode steps within a relative
   L2 error of 2e-2 of its 4,096-token forward. One ``zoo rest report``
   JSON line.
13. The dry run against the card (slice 15), last: phase 6's prefill and
   a training step (``make_train_step``) of llama3.2-1b at full width, 2
   layers, at 2 x 4,096 tokens (past the 2,048 of the direct attention
   path, so both run the attention kernel), each traced by
   ``repro_torch.launch.dryrun`` on fake CUDA tensors on a (1, 1) mesh,
   then run for real from seeded params: a warm-up, one run under
   ``FlopCounterMode`` and three timed with CUDA events. Fails unless
   the traced FLOPs equal the counted ones and the dry run's argument
   bytes equal the real arguments' bytes, both exactly, and the kernel
   launched in both steps; logs the predicted temp bytes beside the peak
   device memory beyond the arguments, the step time beside the dry
   run's bound, and one ``run_dryrun("gemma3-27b", "prefill_32k")``
   record's trace time and terms. One ``dryrun report`` JSON line.
14. The examples (slice 16), after phase 13, each under
   ``build/chip_smoke_examples/<name>/``: the six ``examples/torch``
   programs a user runs first, in process on the card through their
   public entry points at their smallest setting — ``quickstart``,
   ``differential_checkpointing``, ``elastic_resume`` and
   ``serve_restore`` as they are, ``train_100m --fast --steps 5
   --ckpt-interval 3`` (one save before the crash, the resume, two
   steps), and ``engine_comparison.run_engine`` at 1 step for each of
   the four engines. Fails if a ``main`` does not return 0 or
   a gate of its own fails (bit-exact chain restore, equal resumed
   losses, the model-only resume's bytes, the flipped mesh's shards, the
   completions' shape, every engine's steps committed), if
   ``checksum_u32`` never launched, or if the differential example
   launched no ``xor_checksum_u32`` or ``delta_xor``. One ``examples
   report`` JSON line: each example's seconds, launches and gate line.
15. Report: a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
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
#: the process ranks' pinned caches in all (their shards arrive in host
#: memory, so the cache stages nothing)
DIST_PROCESS_CACHE_BYTES = 4 << 30
#: words per call on the main path: 64 MiB pieces for the restore fold
#: (the digest's chunks and pieces are ``variants.CHUNK_WORDS`` and
#: ``PIECE_WORDS``, the XOR digest's ``variants.XOR_CALLS``)
MAIN_WORDS = {"delta_xor": 1 << 24}
#: quantization rows per call on the main path: one 4 MiB chunk
MAIN_ROWS = 4096
#: the training phase: tokens per batch row (the longest sequence on the
#: direct attention path), batch rows, steps and the save interval
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_INTERVAL = 2048, 4, 6, 2
#: the engines phase: the four engines the paper compares, in its order
#: (``benchmarks/common.py``), each training this many steps with a save
#: at the second
ENGINE_ORDER = ("sync", "snapshot", "datastates-old", "datastates")
ENGINE_STEPS, ENGINE_SAVE_AT = 3, 2
#: the multi-rank phase: writer ranks, ranks a node of the commit tree,
#: and the steps its trainer takes before the process ranks' save
DIST_WORLD, DIST_NODE_SIZE, DIST_TRAIN_STEPS = 4, 2, 2
#: phase 9b consolidates its committed step's four rank files this many
#: to an aggregate before the restores read it
CONSOLIDATE_GROUP = 2
#: the tiers phase: serving replicas warm-starting at once (two: four
#: took the smoke over its time), hosts they share (one local root a
#: host), the most the object store may serve
#: them as a multiple of the chain's bytes (``tests/test_fleet.py``'s
#: bound), the host memory it asks for, and the pinned cache of its
#: resume-only manager
TIER_REPLICAS, TIER_HOSTS, TIER_MAX_AMPLIFICATION = 2, 2, 1.25
TIER_MIN_AVAIL_BYTES = 24 << 30
TIER_RESUME_CACHE_BYTES = 256 << 20
#: the serving phase: prompts, prompt tokens (past the 2,048 of the
#: direct attention path) and new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 4096, 32
#: the dry-run phase: timed real runs of each step, and the config and
#: shape of its one CLI-equivalent record at full depth
DRYRUN_TIMED = 3
DRYRUN_CLI = ("gemma3-27b", "prefill_32k")
#: the checkpoint phase and its path through the thread ranks (9a) run
#: at this depth; the training, serving, engines, process-rank and tiers
#: phases at 2 layers (phase 10 reads phase 5's chain)
CKPT_LAYERS = 1
#: the zoo phase: gemma3-27b served at 2 layers (one ``window``, one
#: ``full``: both masks, the ring's wrap and the per-layer check at a
#: third of its pattern's bytes), musicgen-medium trained at 4 layers on
#: batches of 2 x 4,096 tokens (past the 2,048 of the direct attention
#: path)
ZOO_SERVE_PATTERN, ZOO_TRAIN_LAYERS = ("window", "full"), 4
ZOO_TRAIN_BATCH, ZOO_TRAIN_SEQ = 2, 4096
#: the rest of the zoo (phase 12), each at full width cut in depth:
#: recurrentgemma-2b at one repetition of its (rec, rec, window) pattern,
#: paligemma-3b at 2 layers with its 256-patch prefix (3,840 tokens after
#: it), dbrx-132b and rwkv6-7b at 1 layer each; rwkv's decode continues a
#: prefill of 4,080 tokens for 16 steps fed the next given tokens
ZOO12_PATTERNS = {"recurrentgemma-2b": ("rec", "rec", "window"),
                  "paligemma-3b": ("full", "full"),
                  "dbrx-132b": ("full_moe",), "rwkv6-7b": ("rwkv",)}
RWKV_TAIL = 16
#: rwkv's last logits after prefill + decode against a forward over the
#: whole sequence: relative L2 error (bf16: the chunked and the stepwise
#: WKV round to bf16 at other points; ``tests/test_torch_model_zoo_
#: recurrent.py`` holds the same bound on the CPU)
RWKV_TAIL_REL_L2 = 2e-2
#: flash attention at odd sizes: (queries, keys) — one short of, on and
#: past the bf16 kernel's 128-row tiles, fewer keys than queries — (H, KV)
#: heads, and masks: a window narrower than a tile, chunks across tiles
FLASH_SEQS = ((1, 1), (127, 127), (128, 128), (129, 129), (257, 257),
              (300, 200), (2100, 2100))
FLASH_HEADS = ((32, 8), (4, 4))
FLASH_KINDS = (("full", 0, 0), ("window", 200, 0), ("window", 32, 0),
               ("chunked", 0, 192))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the head widths the attention kernel is built for, and gemma3's window
FLASH_HDS = (64, 128, 256)
ZOO_WINDOW = 1024
#: the prefix-LM's prefix (paligemma's 256 patches) at odd sizes: (S, T),
#: each under ``full`` and ``window`` 200 at every head width
FLASH_PREFIX, FLASH_PREFIX_SEQS = 256, ((2100, 2100), (300, 200))
#: phase 12's attention shapes at hd 256: 12a recurrentgemma-2b's window
#: layer (10/1 heads, window 2,048) and 12b paligemma-3b's prefix-LM (8/1
#: heads, ``full`` with the 256-patch prefix), B 2 x S 4,096 each
ZOO12A_HEADS, ZOO12A_WINDOW = (10, 1), 2048
ZOO12B_HEADS = (8, 1)
#: the reduction kernels at the reducer's shapes: llama3.2-1b's embedding
#: (128,256 x 2,048 fp32) for the downcast, the same leaf as rows of 256
#: for the int8 pair, and delta_xor's fold piece for the two u32/f32 ones
DOWNCAST_SHAPE = (128_256, 2048)
INT8_ROWS = 128_256 * 2048 // 256
#: the reducer phase: keyframe every 3 saves, so steps 1-2 save K, delta
#: (two steps, not three, since phase 12: the smoke's time; the CPU tests
#: keep the longer chain)
REDUCE_STEPS, REDUCE_KEYFRAME_EVERY = 2, 3
#: the reducer phase's depth (full width)
REDUCE_LAYERS = 1
#: the examples phase: ``train_100m``'s flags and the steps
#: ``engine_comparison.run_engine`` takes for each engine, both cut from
#: 6 and 2 for the smoke's time (5 steps is the least that saves once
#: before ``train_100m``'s crash at two thirds; PERF.md, phase 14)
EXAMPLES_TRAIN_100M = ("--fast", "--steps", "5", "--ckpt-interval", "3")
EXAMPLES_ENGINE_STEPS = 1
SOURCES = {k: "src/repro_torch/kernels/csrc/ckpt_kernels.cu"
           for k in ("checksum_u32", "xor_checksum_u32", "delta_xor",
                     "quantize_checksum_int8", "dequantize_checksum_int8",
                     "xor_fold_checksum_u32", "quantize_int8",
                     "dequantize_int8", "downcast_bf16", "delta_f32")}
SOURCES["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {"checksum_u32": "src/repro/kernels/checksum.py:43",
            "xor_checksum_u32": "src/repro/kernels/fused.py:78",
            "delta_xor": "src/repro/kernels/delta.py:30",
            "quantize_checksum_int8": "src/repro/kernels/fused.py:169",
            "dequantize_checksum_int8": "src/repro/kernels/fused.py:201",
            "flash_attention": "src/repro/kernels/flash_attention.py:80",
            "xor_fold_checksum_u32": "src/repro/kernels/fused.py:106",
            "quantize_int8": "src/repro/kernels/quantize.py:52",
            "dequantize_int8": "src/repro/kernels/quantize.py:74",
            "downcast_bf16": "src/repro/kernels/quantize.py:28",
            "delta_f32": "src/repro/kernels/delta.py:50"}
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
            "flash_attention": flash_attention.KERNEL,
            "xor_fold_checksum_u32": fused.FOLD_KERNEL,
            "quantize_int8": quantize.QUANT_INT8_KERNEL,
            "dequantize_int8": quantize.DEQUANT_INT8_KERNEL,
            "downcast_bf16": quantize.DOWNCAST_BF16_KERNEL,
            "delta_f32": delta.F32_KERNEL}


def _zero_launches() -> None:
    from repro_torch.kernels import flash_attention
    for k in _kernels().values():
        k.launches = 0
    flash_attention.LAUNCHES_BY.clear()


def _launches() -> dict:
    return {name: k.launches for name, k in _kernels().items()}


def _random_words(n: int, gen):
    import torch
    return torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                         device="cuda", generator=gen)


def _calls(a, b):
    """(kernel call, plain call, compare) of ``delta_xor`` on a, b."""
    import torch
    from repro_torch.kernels import delta

    def cmp():
        d = delta.delta_xor_cuda(a, b)
        dp = delta.delta_xor_plain(a, b)
        return int((d.to(torch.int64) - dp.to(torch.int64)).abs().max()
                   .item())
    return (lambda: delta.delta_xor_cuda(a, b),
            lambda: delta.delta_xor_plain(a, b), cmp)


def _xor_sizes(n_main: int) -> tuple:
    """``delta_xor``'s parity lengths: 1 to 5 words, one short of, on and
    one past a block's tile, a length whose last tile is partial (and a
    word tail), an odd length, and the main path's."""
    from repro_torch.kernels import delta
    t = delta.TILE_WORDS
    return (1, 3, 4, 5, t - 1, t, t + 1, 10 * t + t // 4 + 3, 65_537, n_main)


def _device_ms(fn, reps: int) -> float:
    """The device's own time of one call (``torch.profiler``)."""
    import torch
    from repro_torch.kernels import variants
    return variants.device_ms(torch, fn, reps)


def _time_turns(kern, lib, reps: int, clock=None) -> tuple:
    """``(kernel, library)`` ms per call, timed in turns: library, kernel,
    kernel, library, each the mean of its two turns, and each turn right
    after an untimed turn of the same call. What ran just before moves a
    kernel's time on the card (the first calls after set-up run a few per
    cent slow; ``delta_xor`` runs about 2 % slow right after a 0.5 GB
    downcast written with plain stores), so neither is timed after the
    other."""
    clock = clock or _time_ms

    def turn(fn):
        _time_ms(fn, reps)
        return clock(fn, reps)
    lib_1, kern_1, kern_2, lib_2 = (turn(fn) for fn in (lib, kern, kern, lib))
    return (kern_1 + kern_2) / 2, (lib_1 + lib_2) / 2


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
    rows = check_checksum_kernel(gen)
    rows.update(check_xor_kernel(gen))
    name, n_main = "delta_xor", MAIN_WORDS["delta_xor"]
    sizes = _xor_sizes(n_main)
    worst = 0
    for n in sizes:
        a, b = _random_words(n, gen), _random_words(n, gen)
        err = _calls(a, b)[2]()
        torch.cuda.synchronize()
        if err != 0:
            fail(f"{name} disagrees with its plain version at {n} words: "
                 f"max |diff| {err}")
        worst = max(worst, err)
    # sliced at a 4-byte offset, so the wrapper's `aligned` clones
    a, b = _random_words(4098, gen)[1:], _random_words(4098, gen)[1:]
    if a.data_ptr() % 16 == 0 or _calls(a, b)[2]() != 0:
        fail("delta_xor disagrees with its plain version on words at a "
             "4-byte offset")
    a, b = _random_words(n_main, gen), _random_words(n_main, gen)
    kern, plain, _ = _calls(a, b)
    reps = 30
    lib = lambda: torch.bitwise_xor(a, b)  # noqa: E731
    ms, library_ms = _time_turns(kern, lib, reps)
    dev, lib_dev = _time_turns(kern, lib, reps, _device_ms)
    plain_ms = _time_ms(plain, max(5, reps // 10))
    # each input read once, each output written once: 12N
    rows[name] = {
        "name": name, "words": n_main, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 12 * n_main / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": library_ms, "device_ms": dev,
        "library_device_ms": lib_dev}
    log(f"kernel {name}: bit-identical at {', '.join(map(str, sizes))} "
        f"words and at a 4-byte offset; {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms, "
        f"torch.bitwise_xor {library_ms:.4f} ms; device alone {dev:.4f} "
        f"ms, torch.bitwise_xor {lib_dev:.4f} ms)")
    rows.update(check_int8_kernels(gen))
    rows.update(check_flash_kernel(gen))
    rows.update(check_reduction_kernels(gen))
    return rows


def _device_record_names(fn, reps: int = 20) -> set:
    """Names of the device events ``torch.profiler`` records over ``reps``
    calls of ``fn`` (kernels, copies, fills)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def check_checksum_kernel(gen) -> dict:
    """The digest against its plain version in one segment
    (``variants.CHECKSUM_SIZES``) and in segments
    (``variants.CHECKSUM_CASES``, and at a 4-byte offset), then timed:
    one 4 MiB chunk through ``checksum_cuda`` (``host_checksum``'s call)
    and one 64 MiB piece of 16 chunks through ``checksum_segments_cuda``
    (``file_checksum``'s call), wrapper and device time, beside the plain
    version and the bound (4 bytes a word over the memory rate). No
    PyTorch call computes the digest. The row's ``ms`` is the piece's."""
    import torch
    from repro_torch.kernels import checksum as tc
    from repro_torch.kernels import variants
    bad = variants.checksum_disagreement(torch)
    if bad is not None:
        fail(f"checksum_u32 disagrees with its plain version: {bad}")
    chunk_words, piece_words = variants.CHUNK_WORDS, variants.PIECE_WORDS
    piece = _random_words(piece_words, gen)
    chunk = piece[:chunk_words]
    out = torch.empty(16, dtype=torch.int32, device="cuda")
    calls = {"chunk": (lambda: tc.checksum_cuda(chunk),
                       lambda: tc.checksum_plain(chunk), 200),
             "piece": (lambda: tc.checksum_segments_cuda(
                           piece, chunk_words, out),
                       lambda: tc.checksum_segments_plain(
                           piece, chunk_words), 100)}
    names = _device_record_names(calls["chunk"][0])
    if len(names) != 1 or "checksum_segments_kernel" not in next(iter(names)):
        fail(f"a 4 MiB checksum_u32 call recorded the device events "
             f"{sorted(names)}, not the digest kernel alone")
    t = {}
    for k, (kern, plain, reps) in calls.items():
        t[k] = {"ms": _time_ms(kern, reps), "device_ms": _device_ms(kern, 20),
                "plain_ms": _time_ms(plain, 5),
                "bound_ms": 4 * (piece_words if k == "piece"
                                 else chunk_words) / HBM_BYTES_PER_S * 1e3}
    c, p = t["chunk"], t["piece"]
    log(f"kernel checksum_u32: bit-identical at "
        f"{', '.join(map(str, variants.CHECKSUM_SIZES))} words, in segments "
        f"at (words, words a segment) {variants.CHECKSUM_CASES} and at a "
        f"4-byte offset; one device record a call ({next(iter(names))}); "
        f"4 MiB chunk {c['ms']:.4f} ms, device {c['device_ms']:.4f} ms "
        f"(plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms); "
        f"64 MiB piece of 16 chunks {p['ms']:.4f} ms, device "
        f"{p['device_ms']:.4f} ms, {p['bound_ms'] / p['device_ms']:.3f} of "
        f"the bound (plain {p['plain_ms']:.4f} ms, bound "
        f"{p['bound_ms']:.5f} ms)")
    return {"checksum_u32": {
        "name": "checksum_u32", "words": piece_words,
        "seg_words": chunk_words, "max_abs_err": 0, "ms": p["ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "device_ms": p["device_ms"],
        **{f"chunk_{k}": v for k, v in c.items()}}}


def check_xor_kernel(gen) -> dict:
    """The fused XOR digest against its plain versions
    (``variants.xor_disagreement``: the one-segment entry at
    ``variants.XOR_SIZES`` words, the segmented one at every
    ``variants.XOR_CASES`` layout and at a 4-byte offset, deltas and each
    segment's digest bit for bit); one device record a 4 MiB call, the
    kernel (no fill); then timed at one 4 MiB chunk, the delta provider's
    piece of 8 chunks and a 64 MiB piece of 16 (``variants.XOR_CALLS``),
    wrapper and device, beside the plain version and the bound (12 bytes
    a word over the memory rate). No PyTorch call computes the XOR with a
    digest. The row's ``ms`` is the provider's piece's."""
    import torch
    from repro_torch.kernels import variants
    bad = variants.xor_disagreement(torch)
    if bad is not None:
        fail(f"xor_checksum_u32 disagrees with its plain version: {bad}")
    calls, _ = variants.xor_calls(torch, gen)
    names = _device_record_names(calls["chunk"][0])
    if len(names) != 1 \
            or "xor_checksum_segments_kernel" not in next(iter(names)):
        fail(f"a 4 MiB xor_checksum_u32 call recorded the device events "
             f"{sorted(names)}, not the kernel alone")
    t = {}
    for k, (kern, plain) in calls.items():
        n_bytes, n_segs = variants.XOR_CALLS[k]
        t[k] = {"ms": _time_ms(kern, 200 if n_segs == 1 else 100),
                "device_ms": _device_ms(kern, 20),
                "plain_ms": _time_ms(plain, 5),
                "bound_ms": variants.xor_bound_ms(n_bytes)}
    desc = {"chunk": "4 MiB chunk", "piece": "32 MiB piece of 8 chunks",
            "piece64": "64 MiB piece of 16 chunks"}
    log("kernel xor_checksum_u32: bit-identical at "
        f"{', '.join(map(str, variants.XOR_SIZES))} words, in segments at "
        f"(bytes, bytes a segment) {variants.XOR_CASES} and at a 4-byte "
        f"offset; one device record a call ({next(iter(names))}); "
        + "; ".join(
            f"{desc[k]} {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms, "
            f"{v['bound_ms'] / v['device_ms']:.3f} of the bound (plain "
            f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.5f} ms)"
            for k, v in t.items()))
    p = t["piece"]
    return {"xor_checksum_u32": {
        "name": "xor_checksum_u32", "bytes": variants.XOR_CALLS["piece"][0],
        "segments": variants.XOR_CALLS["piece"][1], "max_abs_err": 0,
        "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "device_ms": p["device_ms"],
        **{f"{size}_{k}": v for size in ("chunk", "piece64")
           for k, v in t[size].items()}}}


def check_int8_kernels(gen) -> dict:
    """The fused int8 encode and decode against their plain versions
    (``variants.int8_disagreement``: the one-segment entries at
    ``variants.INT8_ROWS`` rows, the segmented ones at every
    ``variants.INT8_CASES`` layout, payloads, digests and decoded rows bit
    for bit, with NaN, inf, subnormal, zero and tie rows in the first and
    the last segment); one device record a 4 MiB call of each entry (the
    kernel: no fill); then timed at one 4 MiB chunk and at one 64 MiB
    piece of 16 chunks, wrapper and device, beside the plain version and
    the bound (the valid raw bytes and the payloads over the memory rate).
    No single PyTorch call quantizes with a digest, so there is no library
    time. Each row's ``ms`` is the piece's."""
    import torch
    from repro_torch.kernels import quantize as tq
    from repro_torch.kernels import variants
    bad = variants.int8_disagreement(torch)
    if bad is not None:
        fail(f"the fused int8 pair disagrees with its plain versions: {bad}")
    calls, _ = variants.int8_calls(torch, gen)
    x = torch.randn((MAIN_ROWS, 256), generator=gen, device="cuda")
    body, _ = tq.quantize_checksum_cuda(x)
    one_segment = {
        "quantize_checksum_int8": lambda: tq.quantize_checksum_cuda(x),
        "dequantize_checksum_int8":
            lambda: tq.dequantize_checksum_cuda(body, MAIN_ROWS)}
    kernel_name = {"quantize_checksum_int8": "quantize_segments_kernel",
                   "dequantize_checksum_int8": "dequantize_segments_kernel"}
    rows = {}
    for name in ("quantize_checksum_int8", "dequantize_checksum_int8"):
        for fn in (calls[name, "chunk"][0], one_segment[name]):
            names = _device_record_names(fn)
            if len(names) != 1 or kernel_name[name] not in next(iter(names)):
                fail(f"a 4 MiB {name} call recorded the device events "
                     f"{sorted(names)}, not the kernel alone")
        t = {}
        for size, sizes, reps in (("chunk", variants.INT8_CHUNK, 200),
                                  ("piece", variants.INT8_PIECE, 100)):
            kern, plain = calls[name, size]
            t[size] = {"ms": _time_ms(kern, reps),
                       "device_ms": _device_ms(kern, 20),
                       "plain_ms": _time_ms(plain, 5),
                       "bound_ms": variants.int8_bound_ms(sizes)}
        c, p = t["chunk"], t["piece"]
        rows[name] = {
            "name": name, "rows": 16 * MAIN_ROWS, "segments": 16,
            "max_abs_err": 0, "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": p["device_ms"],
            **{f"chunk_{k}": v for k, v in c.items()}}
        log(f"kernel {name}: bit-identical at {variants.INT8_ROWS} rows "
            f"(one segment) and in segments at the chunk sizes "
            f"{[sorted(set(z)) for z in variants.INT8_CASES]}; one device "
            f"record a 4 MiB call; 4 MiB chunk {c['ms']:.4f} ms, device "
            f"{c['device_ms']:.4f} ms (plain {c['plain_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.5f} ms); 64 MiB piece of 16 chunks "
            f"{p['ms']:.4f} ms, device {p['device_ms']:.4f} ms, "
            f"{p['bound_ms'] / p['device_ms']:.3f} of the bound (plain "
            f"{p['plain_ms']:.4f} ms, bound {p['bound_ms']:.5f} ms)")
    return rows


def _edge_values(device: str):
    """``quantize.EDGE_BITS`` as a float32 tensor on ``device``."""
    from repro_torch.kernels import quantize
    return quantize.edge_values(device)


def _place(x, values, at: int = 0) -> None:
    """Write as many of ``values`` as fit into flat ``x`` from ``at``."""
    k = max(0, min(values.numel(), x.numel() - at))
    x.view(-1)[at:at + k] = values[:k]


def _same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def _reduction_calls(gen, downcast_shape, n_rows: int, n_words: int,
                     device: str = "cuda"):
    """(kernel call, plain call, library call or None) of the five
    reduction kernels on seeded inputs with ``quantize.EDGE_BITS`` placed in
    them. The int8 rows: row 0 zero (scale 1.0), row 1 every edge value (a
    NaN in a row makes its scale 1.0, as in the reference), row 2 the
    non-NaN ones (an inf scale), row 3 the finite ones; the dequantize's
    q is the plain quantize of those rows, its scales from row 1 on the
    edge values; the two elementwise kernels pair each edge value with
    others."""
    import torch
    from repro_torch.kernels import delta, fused, quantize as tq
    edge = _edge_values(device)
    x = torch.randn(downcast_shape, generator=gen, device=device) * 100
    _place(x, edge)
    _place(x, edge, x.numel() - edge.numel())
    rows = torch.randn((n_rows, 256), generator=gen, device=device) * 10
    rows[0] = 0
    _place(rows[1], edge)
    _place(rows[2], edge[~torch.isnan(edge)])
    _place(rows[3], edge[torch.isfinite(edge)])
    q, scales = tq.quantize_int8_plain(rows)
    _place(scales, edge, 1)
    a = torch.randn(n_words, generator=gen, device=device)
    b = a + torch.randn(n_words, generator=gen, device=device) * 1e-3
    k = edge.numel()
    _place(a, edge)
    _place(b, edge.roll(5))
    _place(a, edge.roll(11), k)
    _place(b, edge, k)
    wa, wb = a.view(torch.int32), b.view(torch.int32)
    return {
        "downcast_bf16": (lambda: tq.downcast_bf16_cuda(x),
                          lambda: tq.downcast_bf16_plain(x),
                          lambda: x.to(torch.bfloat16)),
        "quantize_int8": (lambda: tq.quantize_int8_cuda(rows),
                          lambda: tq.quantize_int8_plain(rows), None),
        "dequantize_int8": (lambda: tq.dequantize_int8_cuda(q, scales),
                            lambda: tq.dequantize_int8_plain(q, scales),
                            lambda: torch.mul(q, scales)),
        "delta_f32": (lambda: delta.delta_f32_cuda(a, b),
                      lambda: delta.delta_f32_plain(a, b),
                      lambda: torch.sub(a, b)),
        "xor_fold_checksum_u32": (
            lambda: fused.xor_fold_checksum_cuda(wa, wb),
            lambda: fused.xor_fold_checksum_plain(wa, wb), None)}


def _reduction_agree(name: str, got, want) -> bool:
    from repro_torch.kernels import checksum
    if name == "xor_fold_checksum_u32":
        return _same_bits(got[0], want[0]) \
            and (int(got[1].item()) & checksum.U32_MASK) == want[1]
    if name == "quantize_int8":
        return _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    return _same_bits(got, want)


def check_reduction_kernels(gen) -> dict:
    """The five kernels of the offline reduction path against their plain
    versions, bit for bit, with the NaN, inf, subnormal and tie values of
    ``quantize.EDGE_BITS`` in every input (and a zero row for the int8 pair),
    at small sizes and at the reducer's shapes; then timed there beside
    the plain version, the bound (bytes over the memory rate: a few
    operations a value) and the library call where one computes the same
    function (``x.to(torch.bfloat16)``, ``torch.mul(q, scales)``,
    ``torch.sub``; ``quantize_int8`` and the fold's digest have none)."""
    import torch
    for shape, n_rows, n_words in (((256, 256), 256, 1), ((512, 768), 768, 3),
                                   ((256, 768), 256, 4),
                                   ((256, 256), 256, 65_537),
                                   (DOWNCAST_SHAPE, INT8_ROWS,
                                    MAIN_WORDS["delta_xor"])):
        calls = _reduction_calls(gen, shape, n_rows, n_words)
        for name, (kern, plain, _lib) in calls.items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if not _reduction_agree(name, got, want):
                fail(f"{name} disagrees with its plain version at "
                     f"{shape} / {n_rows} rows / {n_words} words")
            del got, want
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    _check_downcast_flat(gen)
    n_values = DOWNCAST_SHAPE[0] * DOWNCAST_SHAPE[1]
    n_words = MAIN_WORDS["delta_xor"]
    nbytes = {"downcast_bf16": 6 * n_values,
              "quantize_int8": INT8_ROWS * (1024 + 256 + 4),
              "dequantize_int8": INT8_ROWS * (1024 + 256 + 4),
              "delta_f32": 12 * n_words, "xor_fold_checksum_u32": 12 * n_words}
    calls = _reduction_calls(gen, DOWNCAST_SHAPE, INT8_ROWS, n_words)
    rows = {}
    for name, (kern, plain, lib) in calls.items():
        big = name in ("downcast_bf16", "quantize_int8", "dequantize_int8")
        reps = 50 if big else 30
        if lib:
            ms, library_ms = _time_turns(kern, lib, reps)
        else:
            ms, library_ms = _time_ms(kern, reps), None
        device = {}
        if name in ("downcast_bf16", "delta_f32"):
            dev, lib_dev = _time_turns(kern, lib, reps, _device_ms)
            device = {"device_ms": dev, "library_device_ms": lib_dev}
        plain_ms = _time_ms(plain, 3 if big else 5)
        rows[name] = {
            "name": name, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms, **device}
        log(f"kernel {name}: bit-identical to its plain version with NaN, "
            f"inf, subnormal and tie inputs; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms"
            + (f", library {library_ms:.4f} ms" if lib else "")
            + (f"; device alone {device['device_ms']:.4f} ms, library "
               f"{device['library_device_ms']:.4f} ms" if device else "")
            + ")")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _check_downcast_flat(gen) -> None:
    """The downcast through its flat entry at lengths no (R, C) of its
    shape contract gives (those are multiples of 65,536 values, so of the
    kernel's tile): 1 to 5 values, one short of and one past a tile, and a
    partial last tile with a tail, with the edge values at both ends."""
    import torch
    from repro_torch.kernels import delta, quantize as tq
    t = delta.TILE_WORDS
    edge = _edge_values("cuda")
    for n in (1, 3, 4, 5, t - 1, t + 1, 10 * t + t // 4 + 3):
        x = torch.randn(n, generator=gen, device="cuda") * 100
        _place(x, edge)
        _place(x, edge, max(0, n - edge.numel()))
        if not _same_bits(tq.downcast_bf16_words_cuda(x),
                          tq.downcast_bf16_words_plain(x)):
            fail(f"downcast_bf16 disagrees with its plain version at {n} "
                 f"flat values")
    torch.cuda.synchronize()


def _flash_err(got, want, tol: float) -> float:
    """Largest ``|got - want|``, or ``inf`` where ``got`` is not finite or
    lies past ``tol + tol * |want|`` (``assert_allclose`` with ``atol =
    rtol = tol``, as ``tests/test_kernels.py`` holds the Pallas kernel)."""
    import torch
    g, w = got.detach().float(), want.detach().float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) \
            or bool((diff > tol + tol * w.abs()).any()):
        return math.inf
    return float(diff.max())


def flash_bound_ms(B: int, S: int, H: int, KV: int, hd: int,
                   itemsize: int, window: int = 0,
                   n_prefix: int = 0) -> tuple:
    """(bound ms, bound_by) of causal attention: its FLOP
    (``flash_attention.flash_flop``, the attention operator's FLOP formula)
    against the bf16 tensor-core peak; q, k, v read once and the output
    written once against the memory rate."""
    from repro_torch.kernels.flash_attention import flash_flop
    flop = flash_flop(B, S, H, hd, window, n_prefix)
    nbytes = itemsize * B * S * hd * (2 * H + 2 * KV)
    t_ops, t_bytes = flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check_flash_stats(gen) -> float:
    """The kernel's row stats against the plain version's, at hd 64, 128
    and 256, both dtypes, every mask, at (S, T) 300 and 2,100 with 32/8
    heads,
    and at 11b's shape (B 2, S 4,096, 24/24 heads, hd 64, bf16,
    ``full``); the output equal to the call without stats. Returns the
    largest ``|m|`` error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    cases = [(2, S, 32, 8, hd, dt, mask) for hd in FLASH_HDS
             for dt in ("float32", "bfloat16") for S in (300, 2100)
             for mask in FLASH_KINDS]
    cases.append((ZOO_TRAIN_BATCH, ZOO_TRAIN_SEQ, 24, 24, 64, "bfloat16",
                  FLASH_KINDS[0]))
    worst = 0.0
    for B, S, H, KV, hd, dt, (kind, window, chunk) in cases:
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn(B, S, h, hd, device="cuda",
                               generator=gen).to(tdt) for h in (H, KV, KV))
        out, m, l = fa.flash_attention_cuda(
            q, k, v, kind=kind, window=window, chunk=chunk,
            return_stats=True)
        _o, wm, wl = fa.flash_attention_plain(
            q, k, v, kind=kind, window=window, chunk=chunk,
            return_stats=True)
        plain_out = fa.flash_attention_cuda(
            q, k, v, kind=kind, window=window, chunk=chunk)
        torch.cuda.synchronize()
        dm, dl = (m - wm).abs(), (l - wl).abs()
        if not torch.equal(out, plain_out) \
                or bool((dm > 1e-3 + 1e-4 * wm.abs()).any()) \
                or bool((dl > 1e-3 + 1e-3 * wl.abs()).any()):
            fail(f"flash_attention's row stats disagree with the plain "
                 f"version's at B {B} S {S} heads {H}/{KV} hd {hd} {dt} "
                 f"{kind}: max |dm| {float(dm.max())!r}, max |dl| "
                 f"{float(dl.max())!r}")
        worst = max(worst, float(dm.max()))
    return worst


#: ``layers._Flash``'s gradients against autograd through the plain
#: version: relative L2 error a gradient (``tests/test_torch_flash_
#: backward.py``'s card test holds them so); the output is held
#: elementwise at :data:`FLASH_TOL`
GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-2}


def _rel_l2(got, want) -> float:
    import torch
    g, w = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    return float((g - w).norm() / w.norm())


def _check_flash_backward(gen) -> float:
    """``layers._Flash`` (the kernel's forward with stats, the ported
    backward) against autograd through the plain version: the output
    within :data:`FLASH_TOL` and dq, dk, dv within :data:`GRAD_REL_L2`,
    at S 2,100 with ``kv_block`` 1,024, 32/8 heads, ``full`` and
    ``window`` 200, hd 64, 128 and 256, both dtypes, and at 11b's shape
    (B 2,
    S 4,096, 24/24 heads, hd 64, bf16, ``full``). Returns the largest
    relative L2 error of a gradient."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    cases = [(1, 2100, 32, 8, hd, dt, kind, window) for hd in FLASH_HDS
             for dt in ("float32", "bfloat16")
             for kind, window in (("full", 0), ("window", 200))]
    cases.append((ZOO_TRAIN_BATCH, ZOO_TRAIN_SEQ, 24, 24, 64, "bfloat16",
                  "full", 0))
    worst = 0.0
    for B, S, H, KV, hd, dt, kind, window in cases:
        tdt = getattr(torch, dt)
        ins = [torch.randn(B, S, h, hd, device="cuda", generator=gen).to(tdt)
               for h in (H, KV, KV)]
        dout = torch.randn(B, S, H * hd, device="cuda", generator=gen) \
            .to(tdt)
        q, k, v = (t.clone().requires_grad_(True) for t in ins)
        out = layers._Flash.apply(q, k, v, kind, window, 0, 1024)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        pq, pk, pv = (t.clone().requires_grad_(True) for t in ins)
        want = fa.flash_attention_plain(pq, pk, pv, kind=kind, window=window,
                                        kv_block=1024)
        wgrads = torch.autograd.grad(want, (pq, pk, pv), dout)
        torch.cuda.synchronize()
        out_err = _flash_err(out, want, FLASH_TOL[dt])
        errs = [_rel_l2(g, w) for g, w in zip(grads, wgrads)]
        if not math.isfinite(out_err) \
                or not all(e < GRAD_REL_L2[dt] for e in errs):
            fail(f"layers._Flash disagrees with autograd through the plain "
                 f"version at B {B} S {S} heads {H}/{KV} hd {hd} {dt} "
                 f"{kind}: out within {FLASH_TOL[dt]}: "
                 f"{math.isfinite(out_err)}; relative L2 error of dq, dk, "
                 f"dv {errs} (limit {GRAD_REL_L2[dt]})")
        worst = max(worst, *errs)
        del ins, dout, q, k, v, out, grads, pq, pk, pv, want, wgrads
    return worst


def check_flash_kernel(gen) -> dict:
    """Flash attention against its plain version at odd sizes (every mask,
    both dtypes, 32/8 and 4/4 heads, hd 64, 128 and 256), with the
    prefix-LM's prefix of 256 at (S, T) 2,100 and 300 over 200 (``full``
    and ``window`` 200, 32/8 heads, every hd, both dtypes); its row stats
    and ``layers._Flash``'s gradients against the plain version's; then,
    each held against the plain version first, timed at the serving shape
    (B 2, S 4,096, 32/8 heads, hd 64, bf16, ``full``) beside the plain
    version, the bound, and PyTorch's ``scaled_dot_product_attention``
    (causal, GQA) as the library time, at hd 128 at phase 11a's shape (B
    2, S 4,096, 32/16 heads; ``full`` and ``window`` 1,024) beside SDPA
    (``is_causal``, and the window's boolean mask), and at hd 256 at
    phase 12a's (10/1 heads, ``window`` 2,048) and 12b's (8/1 heads,
    ``full`` with a prefix of 256: SDPA with the boolean mask, and causal
    SDPA at the same shape beside it)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    B = SERVE_BATCH
    worst = 0.0
    cases = [(B, S, T, H, KV, hd, dt, kind, 0) for hd in FLASH_HDS
             for S, T in FLASH_SEQS for H, KV in FLASH_HEADS
             for dt in ("float32", "bfloat16") for kind in FLASH_KINDS]
    cases += [(B, S, T, 32, 8, hd, dt, kind, FLASH_PREFIX)
              for hd in FLASH_HDS for S, T in FLASH_PREFIX_SEQS
              for dt in ("float32", "bfloat16") for kind in FLASH_KINDS[:2]]
    for B_, S, T, H, KV, hd, dt, (kind, window, chunk), n_prefix in cases:
        tdt = getattr(torch, dt)
        q = torch.randn(B_, S, H, hd, device="cuda", generator=gen).to(tdt)
        k = torch.randn(B_, T, KV, hd, device="cuda", generator=gen).to(tdt)
        v = torch.randn(B_, T, KV, hd, device="cuda", generator=gen).to(tdt)
        got = fa.flash_attention_cuda(q, k, v, kind=kind, window=window,
                                      chunk=chunk, n_prefix=n_prefix)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                        chunk=chunk, n_prefix=n_prefix)
        torch.cuda.synchronize()
        err = _flash_err(got, want, FLASH_TOL[dt])
        if got.shape != want.shape or got.dtype != q.dtype \
                or not math.isfinite(err):
            fail(f"flash_attention disagrees with its plain version at "
                 f"B {B_} S {S} T {T} heads {H}/{KV} hd {hd} {dt} {kind} "
                 f"(window {window}, chunk {chunk}, n_prefix {n_prefix}): "
                 f"max |diff| "
                 f"{float((got.float() - want.float()).abs().max())!r}")
        worst = max(worst, err)
    stats_err = _check_flash_stats(gen)
    grad_err = _check_flash_backward(gen)

    def timed(S, H, KV, hd, window, n_prefix=0):
        """Times at (B, S, H/KV, hd, bf16, causal or ``window``, with the
        prefix), after the kernel's output there is held against the
        plain version's."""
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        k = torch.randn(B, S, KV, hd, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        v = torch.randn(B, S, KV, hd, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        kind = "window" if window else "full"
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        causal = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                              enable_gqa=True)
        lib = causal
        if window or n_prefix:
            mask = fa.allowed(torch.arange(S, device="cuda"),
                              torch.arange(S, device="cuda"), kind, window,
                              0, n_prefix)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                               enable_gqa=True)
        kern = lambda: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, kind=kind, window=window, n_prefix=n_prefix)
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q, k, v, kind=kind, window=window, n_prefix=n_prefix)
        err = _flash_err(kern(), plain(), FLASH_TOL["bfloat16"])
        if not math.isfinite(err):
            fail(f"flash_attention disagrees with its plain version at B "
                 f"{B} S {S} heads {H}/{KV} hd {hd} bf16 {kind} (window "
                 f"{window}, n_prefix {n_prefix})")
        ms, library_ms = _time_turns(kern, lib, 50)
        plain_ms = _time_ms(plain, 5)
        bound_ms, bound_by = flash_bound_ms(B, S, H, KV, hd, 2, window,
                                            n_prefix)
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": fa.flash_flop(B, S, H, hd, window, n_prefix)
               / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms,
               "max_abs_err": err}
        if n_prefix:
            _ms, row["library_causal_ms"] = _time_turns(kern, causal, 50)
        return row

    S = SERVE_PROMPT
    row = timed(S, 32, 8, 64, 0)
    worst = max(worst, row.pop("max_abs_err"))
    log(f"kernel flash_attention at B {B} S {S} heads 32/8 hd 64 bf16 "
        f"causal: {row['ms']:.4f} ms, {row['tflops']:.1f} TFLOP/s, "
        f"{row['bound_share']:.3f} of the bound (plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']}, scaled_dot_product_attention "
        f"{row['library_ms']:.4f} ms)")
    for window in (0, ZOO_WINDOW):
        r = timed(S, 32, 16, 128, window)
        worst = max(worst, r["max_abs_err"])
        tag = f"hd128_window{window}" if window else "hd128"
        row.update({f"{tag}_{k}": r[k] for k in r})
        log(f"kernel flash_attention at B {B} S {S} heads 32/16 hd 128 bf16 "
            f"{'window ' + str(window) if window else 'causal'}: within "
            f"{FLASH_TOL['bfloat16']} of the plain version (max |diff| "
            f"{r['max_abs_err']:.3g}); {r['ms']:.4f} ms, "
            f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the "
            f"bound (plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}, scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms)")
    for tag, (H, KV), window, n_prefix in (
            ("hd256_window2048", ZOO12A_HEADS, ZOO12A_WINDOW, 0),
            ("hd256_prefix256", ZOO12B_HEADS, 0, FLASH_PREFIX)):
        r = timed(S, H, KV, 256, window, n_prefix)
        worst = max(worst, r["max_abs_err"])
        row.update({f"{tag}_{k}": r[k] for k in r})
        log(f"kernel flash_attention at B {B} S {S} heads {H}/{KV} hd 256 "
            f"bf16 {'window ' + str(window) if window else 'causal'}"
            f"{', prefix ' + str(n_prefix) if n_prefix else ''}: within "
            f"{FLASH_TOL['bfloat16']} of the plain version (max |diff| "
            f"{r['max_abs_err']:.3g}); {r['ms']:.4f} ms, "
            f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the "
            f"bound (plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}, scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms"
            + (f", causal SDPA at that shape {r['library_causal_ms']:.4f} ms"
               if n_prefix else "") + ")")
    log(f"kernel flash_attention: within {FLASH_TOL} of its plain version "
        f"at (S, T) {FLASH_SEQS} and {SERVE_PROMPT}, heads {FLASH_HEADS}, "
        f"hd {FLASH_HDS}, masks {FLASH_KINDS}, fp32 and bf16, with a prefix "
        f"of {FLASH_PREFIX} at (S, T) {FLASH_PREFIX_SEQS}, and at B {B} "
        f"S {S} 32/16 hd 128 causal and window {ZOO_WINDOW}, hd 256 10/1 "
        f"window {ZOO12A_WINDOW} and 8/1 prefix {FLASH_PREFIX} (max |diff| "
        f"{worst:.3g}); row stats within 1e-3, also at B {ZOO_TRAIN_BATCH} "
        f"S {ZOO_TRAIN_SEQ} 24/24 hd 64 (max |dm| {stats_err:.3g}); "
        f"layers._Flash's dq, dk, dv within a relative L2 error of "
        f"{GRAD_REL_L2} of autograd through the plain version, also at "
        f"that shape (largest {grad_err:.3g})")
    row.update(name="flash_attention", shape=[B, S, 32, 8, 64],
               max_abs_err=worst, stats_max_abs_err=stats_err,
               grad_max_rel_l2=grad_err)
    return {"flash_attention": row}


#: SASS opcodes counted in the attention kernels: wgmma (HGMMA), TMA loads
#: and stores (UTMALDG, UTMASTG), mbarrier operations (SYNCS), mma.sync
#: (HMMA) and the SFU's exponentials
FLASH_SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA", "MUFU.EX2")


def _flash_kernel_name(text: str):
    """``flash_fwd_bf16<128>``-style name of the attention kernel whose
    mangled name is in ``text`` (a template on the head width), or
    ``None``."""
    import re
    m = re.search(r"flash_fwd_([a-z0-9]+?)(?:ILi(\d+)E)?(?:E|v|'|\s|$)",
                  text)
    if not m:
        return None
    return f"flash_fwd_{m.group(1)}" + (f"<{m.group(2)}>" if m.group(2)
                                        else "")


def describe_flash_build(lib) -> None:
    """Log what was compiled for ``flash_fwd_*``: ptxas' registers,
    barriers, static shared memory, stack and spills (the ``-Xptxas -v``
    report the build keeps; the bf16 kernel's ring is dynamic shared
    memory, which ptxas does not see),
    and the count of each of :data:`FLASH_SASS_OPS` in each kernel's SASS
    (``cuobjdump -sass``). Fails if the bf16 kernel has no ``wgmma`` or no
    TMA load in its SASS, or ``mma.sync``."""
    import re
    from repro_torch.kernels import build
    name = None
    for line in build.ptxas_report(lib).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S*flash_fwd_\w+?)(?:E|')", line)
        if m:
            name = _flash_kernel_name(line)
            continue
        if name and re.search(r"registers|spill|warning|C75", line):
            log(f"ptxas {name}: {line.strip()}")
        if "Compile time" in line:
            name = None
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("cuobjdump not found: the SASS of flash_fwd_* is not counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for body in sass.split("Function : ")[1:]:
        kernel = _flash_kernel_name(body.split("\n", 1)[0])
        if not kernel:
            continue
        counts = {op: len(re.findall(r"\b" + re.escape(op) + r"[ .]", body))
                  for op in FLASH_SASS_OPS}
        log(f"sass {kernel}: {json.dumps(counts)}")
        if kernel.startswith("flash_fwd_bf16") and (
                not counts["HGMMA"] or not counts["UTMALDG"]
                or counts["HMMA"]):
            fail(f"{kernel} is not the wgmma/TMA kernel: {counts}")


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


def _encode_per_save(spans: list, n_saves: int) -> list:
    """Each save's ``{"s", "spans", "bytes"}`` of the ``encode.delta``
    spans of ``n_saves`` delta saves: they stream one after the other (a
    delta save waits for the last one's streams to end) and encode the
    same tensors, so the spans in time order fall into runs of equal
    bytes."""
    spans = sorted(spans, key=lambda e: e["t0"])
    per_save = sum(e["args"]["bytes"] for e in spans) // max(1, n_saves)
    saves, group = [], []
    for e in spans:
        group.append(e)
        if sum(g["args"]["bytes"] for g in group) >= per_save:
            saves.append(group)
            group = []
    return [{"s": sum(e["t1"] - e["t0"] for e in g), "spans": len(g),
             "bytes": sum(e["args"]["bytes"] for e in g)} for g in saves]


def _encode_text(saves: list) -> str:
    return ", ".join(f"{e['s']:.3f} s ({e['spans']} spans, {e['bytes']} "
                     f"bytes)" for e in saves)


def run_main_path(device: str, cfg, workdir: str, host_cache_bytes: int,
                  flush_threads: int, dist=None) -> dict:
    """Three steps of the two-phase loop with saves K, delta, delta; then
    restore steps 3 and 1 onto ``device`` and compare bit for bit. The
    saves run under tracing, for the ``encode.delta`` time of each.

    With ``dist`` (a ``DistPolicy``) the saves go through its writer ranks
    (:func:`_rank_report` reads each step's votes and each rank's spans),
    and a fresh world-1 manager restores."""
    import torch
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  DeltaPolicy, DistPolicy, EnginePolicy)
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.models.model import init_params
    from repro_torch.obs import trace as obs
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
        dist=dist or DistPolicy(), delta=DeltaPolicy(keyframe_every=3))
    mgr = CheckpointManager.from_policy(workdir, policy, device=device)
    report = {"n_params": n_params, "state_bytes": state_bytes, "steps": []}
    try:
        futures = []
        step1 = None
        stall = 0.0
        with obs.tracing() as tracer:
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
        report["encode_delta"] = _encode_per_save(
            tracer.spans("encode.delta"),
            sum(r["kind"] == "delta" for r in report["steps"]))
        report["span_s"] = _span_seconds(tracer)
        if dist is None:
            report["pinned_bytes"] = mgr.engine.host_cache.capacity \
                if mgr.engine.host_cache.pinned else 0
        else:
            report["ranks"] = _rank_report(workdir, tracer, report["steps"])
            report["pinned_bytes"] = sum(
                rt.host_cache.capacity for rt in mgr.coordinator.ranks
                if rt.host_cache.pinned)
            # restores through a fresh world-1 manager (a small engine:
            # a restore stages nothing)
            mgr.close()
            mgr = CheckpointManager.from_policy(workdir, CheckpointPolicy(
                engine=EnginePolicy(host_cache_bytes=64 << 20,
                                    flush_threads=1)), device=device)
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
    finally:
        mgr.close()
    return report


def _span_seconds(tracer) -> dict:
    """Thread-seconds of the save lanes' spans over a run, by name (the
    lanes overlap, so the sums exceed the wall time)."""
    out: dict = {}
    for e in tracer.spans():
        if e["name"].split(".")[0] in ("flush", "encode", "file", "produce",
                                       "host_cache", "rank", "vote", "node"):
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return out


def _rank_report(workdir: str, tracer, steps: list) -> list:
    """Per save of a multi-rank run: each rank's bytes on disk (its file,
    from its vote), its persist time (its ``rank.capture_wait`` span's
    start to its ``rank.persist_wait`` span's end: its engine's staging,
    encode and flush), the files and votes in the step. Fails unless every
    rank of the world wrote a file and voted and every node voted."""
    from repro_torch.storage.manifest import (read_node_manifests,
                                              read_rank_manifests)
    t0 = {(e["args"]["step"], e["args"]["rank"]): e["t0"]
          for e in tracer.spans("rank.capture_wait")}
    t1 = {(e["args"]["step"], e["args"]["rank"]): e["t1"]
          for e in tracer.spans("rank.persist_wait")}
    out = []
    for row in steps:
        step = row["step"]
        sdir = os.path.join(workdir, f"global_step{step}")
        votes, nodes = read_rank_manifests(sdir), read_node_manifests(sdir)
        files = sorted(n for n in os.listdir(sdir) if n.endswith(".dsllm"))
        if sorted(votes) != list(range(DIST_WORLD)) \
                or len(files) != DIST_WORLD \
                or len(nodes) != DIST_WORLD // DIST_NODE_SIZE:
            fail(f"step {step}: {len(files)} rank files, votes of ranks "
                 f"{sorted(votes)}, node manifests {sorted(nodes)}")
        nbytes = {r: sum(f.nbytes for f in v.files) for r, v in votes.items()}
        out.append({"step": step, "rank_files": len(files),
                    "rank_manifests": len(votes), "node_manifests": len(nodes),
                    "rank_bytes": nbytes,
                    "rank_persist_s": {r: t1[step, r] - t0[step, r]
                                       for r in votes},
                    "max_min_bytes": max(nbytes.values())
                    / max(1, min(nbytes.values()))})
    return out


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
    ``(report, host copies of the last saved step's param leaves,
    {"state": device copies of the resumed state's tensors, "data_state":
    its data cursor})``."""
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
        # the int8 encode of each save: one span a piece (a chunk before
        # the pieces), from the enqueue of its upload to its read-back
        enc = tracer.spans("encode.int8")
        report["encode_int8"] = {
            "spans": len(enc), "bytes": sum(e["args"]["bytes"] for e in enc),
            "s": sum(e["t1"] - e["t0"] for e in enc),
            "s_per_save": sum(e["t1"] - e["t0"] for e in enc)
            / len(mgr.futures)}
        report["encode_delta"] = _encode_per_save(
            tracer.spans("encode.delta"),
            sum(not f.stats.extra["delta"]["keyframe"] for f in mgr.futures))
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
        # phase, and the resumed state on the device for the tiers phase:
        # the step below changes them
        saved_params = [t.detach().to("cpu", copy=True)
                        for t in leaves(tr.params)]
        resumed = {"state": [t.detach().clone() for t in
                             _tensors((tr2.params, tr2.opt_state))],
                   "data_state": tr2.pipeline.state}
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
    return report, saved_params, resumed


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
        x, _n, _mem = M._embed_inputs(cfg, params, {"tokens": tokens})
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


def _recording_store():
    """An ``ObjectStoreBackend`` with no modelled latency or bandwidth
    (every time phase 10 reports is the host's own work) that records, in
    ``visible``, the order in which objects become visible (a ``put``, or
    a multipart upload's completion)."""
    from repro_torch.storage import ObjectStoreBackend

    class Recording(ObjectStoreBackend):
        def __init__(self):
            super().__init__(latency_s=0.0, bandwidth_mbps=None)
            self.visible = []

        def put(self, key, data):
            super().put(key, data)
            self.visible.append(key)

        def complete_multipart(self, upload_id):
            key = self._uploads[upload_id][0]
            super().complete_multipart(upload_id)
            self.visible.append(key)

    return Recording()


def _timed_calls(obj, name: str, calls: list) -> None:
    """Wrap ``obj.name`` so each call appends ``(positional arguments,
    seconds)`` to ``calls``."""
    fn = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            calls.append((args, time.perf_counter() - t0))
    setattr(obj, name, timed)


def _launch_diff(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches().items()}


def run_tiers_path(device: str, cfg, workdir: str, tierdir: str,
                   steps: list, resumed: dict, next_loss: float,
                   saved_params: list, batch: int, seq_len: int,
                   replicas: int = TIER_REPLICAS,
                   hosts: int = TIER_HOSTS) -> dict:
    """Phase 10 on phase 5's committed ``steps`` in ``workdir`` (a
    keyframe and its deltas): (a) cascade the newest step, and with it its
    chain, to one object-store tier; (b) a fresh manager and trainer on an
    empty root resume the newest step from that tier, bit for bit against
    phase 5's resumed state ``resumed``, and step 7's loss equals
    ``next_loss``; (c) ``replicas`` serving replicas on ``hosts`` empty
    roots warm-start the newest step's params through one
    ``FleetFabric``, each bit for bit against ``saved_params``, the
    store's bytes out at most ``TIER_MAX_AMPLIFICATION`` times the chain,
    one admission per root and step; (d) the port's CLI verifies host 0's
    root and prints its fleet ledger, in a process of its own. Returns
    the report."""
    import threading

    import torch
    from repro_torch.core import CheckpointManager, StoragePolicy, dtypes
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.fleet import FLEET_STATS_KEY, FleetFabric
    from repro_torch.models import model as M
    from repro_torch.serving import engine
    from repro_torch.storage import CheckpointRepository, Tier
    from repro_torch.storage.repository import catalog_key, data_key
    from repro_torch.training.loop import Trainer

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    report = {"replicas": replicas, "hosts": hosts}
    newest = steps[-1]
    remote = _recording_store()
    tier = Tier("object", remote)
    t_phase = time.perf_counter()

    # -- 10a: cascade ------------------------------------------------------
    before = _launches()
    repo = CheckpointRepository(workdir, [tier], device=device,
                                auto_cascade=False)
    try:
        t0 = time.perf_counter()
        repo.cascade_step(newest)
        cascade_s = time.perf_counter() - t0
        chain = repo.chain_steps(newest, strict=True)
        local_bytes = {s: sum(
            os.path.getsize(os.path.join(repo.step_dir(s), fe.name))
            for fe in repo.manifest(s).files) for s in chain}
        files = {s: [fe.name for fe in repo.manifest(s).files]
                 for s in chain}
        events = [{"step": e.step, "bytes": e.nbytes, "s": e.seconds}
                  for e in repo.cascade_log]
    finally:
        repo.close()
    if chain != steps or repo.tier_steps(tier) != steps:
        fail(f"cascade of step {newest}: chain {chain}, tier holds "
             f"{repo.tier_steps(tier)}; want {steps}")
    for s in steps:
        at = remote.visible.index(catalog_key(s))
        late = [n for n in files[s]
                if remote.visible.index(data_key(s, n)) > at]
        if late:
            fail(f"cascade: step {s}'s catalog object landed before {late}")
    tier_bytes = sum(remote.size(k) for k in remote.list()
                     if not k.startswith(".catalog/"))
    chain_bytes = sum(local_bytes.values())
    if tier_bytes != chain_bytes:
        fail(f"cascade: the tier holds {tier_bytes} data bytes, the local "
             f"chain {chain_bytes}")
    report["cascade"] = {"s": cascade_s, "events": events,
                         "chain_bytes": chain_bytes,
                         "visible_order": remote.visible,
                         "launches": _launch_diff(before)}
    log(f"tiers 10a cascade of step {newest}: {cascade_s:.3f} s, "
        + ", ".join(f"step {e['step']} {e['bytes']} bytes in "
                    f"{e['s']:.3f} s" for e in events)
        + f"; the tier holds {steps} ({tier_bytes} bytes), each catalog "
        f"object after its data")

    # -- 10b: resume on a fresh host ---------------------------------------
    before = _launches()
    policy = _mixed_policy(TIER_RESUME_CACHE_BYTES, 2).replace(
        storage=StoragePolicy(tiers=(tier,)))
    fresh = os.path.join(tierdir, "fresh")
    mgr = CheckpointManager.from_policy(fresh, policy, device=device)
    fetches, admits = [], []
    _timed_calls(mgr.repository, "_fetch_from_tier", fetches)
    _timed_calls(mgr.repository, "admit_fetched_step", admits)
    try:
        tr = Trainer(cfg, batch=batch, seq_len=seq_len, manager=mgr,
                     seed=SEED + 3, device=device)
        out0 = remote.stats["bytes_out"]
        t0 = time.perf_counter()
        step = tr.resume()
        sync()
        resume_s = time.perf_counter() - t0
        fetched_bytes = remote.stats["bytes_out"] - out0
        st = tr.last_resume_stats
        fetched = sorted(args[1] for args, _t in fetches)
        if step != newest or fetched != steps \
                or mgr.repository.local_steps() != steps:
            fail(f"fresh-host resume: step {step}, fetched {fetched}, "
                 f"admitted {mgr.repository.local_steps()}; want "
                 f"{newest} from the tier's {steps}")
        if tr.pipeline.state != resumed["data_state"]:
            fail(f"fresh-host resume: data cursor {tr.pipeline.state}, "
                 f"phase 5's {resumed['data_state']}")
        _assert_equal((tr.params, tr.opt_state), resumed["state"],
                      "fresh-host resume against phase 5's resume")
        launches_b = _launch_diff(before)
        rec = tr.run(1)[-1]
        tr.manager = None
    finally:
        mgr.close()
    if rec.loss != next_loss:
        fail(f"step {rec.step} after the fresh-host resume: loss "
             f"{rec.loss!r}, phase 5's {next_loss!r}")
    fetch_s = sum(t for _a, t in fetches)
    admit_s = sum(t for _a, t in admits)
    report["resume"] = {
        "step": step, "total_s": resume_s, "fetch_s": fetch_s - admit_s,
        "admit_s": admit_s, "verify_s": st.verify_s, "read_s": st.read_s,
        "fold_s": st.fold_s, "assemble_s": st.assemble_s,
        "restore_s": resume_s - fetch_s, "bytes_fetched": fetched_bytes,
        "bytes_read": st.bytes_read, "next_loss": rec.loss,
        "launches": launches_b}
    for k in ("checksum_u32", "delta_xor", "dequantize_checksum_int8"):
        if on_card and launches_b[k] == 0:
            fail(f"kernel {k} was never launched in the fresh-host resume")
    log(f"tiers 10b fresh-host resume of step {step}: {resume_s:.3f} s "
        f"(fetch {fetch_s - admit_s:.3f} s, admission digests "
        f"{admit_s:.3f} s, restore {resume_s - fetch_s:.3f} s: verify "
        f"{st.verify_s:.3f} s, read {st.read_s:.3f} s, fold "
        f"{st.fold_s:.3f} s), {fetched_bytes} bytes from the tier; state "
        f"bit-exact to phase 5's resume; step {rec.step}'s loss "
        f"{rec.loss!r}, phase 5's {next_loss!r}; launches "
        f"{json.dumps(launches_b)}")
    del tr, mgr, resumed["state"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- 10c: fleet warm-start ---------------------------------------------
    avail = _mem_available_bytes()
    log(f"tiers 10c: {avail / 2**30:.1f} GiB of host memory available")
    if avail < TIER_MIN_AVAIL_BYTES:
        fail(f"host memory: {avail / 2**30:.1f} GiB available, the fleet "
             f"warm-start needs {TIER_MIN_AVAIL_BYTES / 2**30:.0f} GiB (the "
             f"store's chain plus each replica's assembled files)")
    before = _launches()
    fabric = FleetFabric(device=device)
    roots = [os.path.join(tierdir, f"host{h}") for h in range(hosts)]
    repos = [CheckpointRepository(r, [tier], device=device,
                                  auto_cascade=False, auto_gc=False)
             for r in roots]
    admitted = {r.root: [] for r in repos}
    for r in repos:
        _timed_calls(r, "admit_fetched_step", admitted[r.root])
    template = map_leaves(
        lambda spec: torch.empty(spec.shape, device=device,
                                 dtype=dtypes.lookup(spec.dtype).torch),
        M.param_shapes(cfg))
    start = threading.Barrier(replicas, timeout=600)
    results, errors = {}, []

    def replica(i: int) -> None:
        try:
            repo = repos[i % hosts]
            start.wait()
            t0 = time.perf_counter()
            params, _st = engine.load_params_for_serving(
                repo.root, template, step=newest, repository=repo,
                fleet=fabric)
            sync()
            secs = time.perf_counter() - t0
            got = leaves(params)
            same = len(got) == len(saved_params) and all(
                a.device.type == device and a.dtype == b.dtype
                and torch.equal(a.cpu(), b)
                for a, b in zip(got, saved_params))
            results[i] = {"host": i % hosts, "s": secs, "bit_exact": same}
        except BaseException as exc:  # noqa: BLE001 — failed below
            errors.append((i, repr(exc)))

    out0 = remote.stats["bytes_out"]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=replica, args=(i,), name=f"rep{i}")
               for i in range(replicas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fleet_s = time.perf_counter() - t0
    bytes_out = remote.stats["bytes_out"] - out0
    launches_c = _launch_diff(before)
    if errors:
        fail(f"fleet warm-start: replicas failed: {errors}")
    if sorted(results) != list(range(replicas)) \
            or not all(r["bit_exact"] for r in results.values()):
        fail(f"fleet warm-start: params not bit-exact to step {newest}'s: "
             f"{results}")
    if bytes_out > TIER_MAX_AMPLIFICATION * chain_bytes:
        fail(f"fleet warm-start: the store served {bytes_out} bytes, over "
             f"{TIER_MAX_AMPLIFICATION} x the chain's {chain_bytes}")
    admissions = {os.path.basename(r): sorted(args[0] for args, _t in calls)
                  for r, calls in admitted.items()}
    if any(a != steps for a in admissions.values()) \
            or any(r.local_steps() != steps for r in repos):
        fail(f"fleet warm-start: admissions {admissions}; want each of "
             f"{steps} once a root")
    for r in repos:  # the ledger with every replica counted
        fabric.persist(r)
        if not os.path.isfile(os.path.join(r.root, FLEET_STATS_KEY)):
            fail(f"fleet warm-start: no ledger in {r.root}")
    stats = fabric.step_stats()
    report["fleet"] = {
        "s": fleet_s, "store_bytes_out": bytes_out,
        "amplification": bytes_out / chain_bytes,
        "remote_bytes": sum(v["remote_bytes"] for v in stats.values()),
        "peer_bytes": sum(v["peer_bytes"] for v in stats.values()),
        "cache_hits": sum(v["cache_hits"] for v in stats.values()),
        "cache": fabric.cache.snapshot(),
        "steps": {str(s): v for s, v in sorted(stats.items())},
        "replica_s": [results[i]["s"] for i in range(replicas)],
        "admit_s": {os.path.basename(r): [t for _a, t in calls]
                    for r, calls in admitted.items()},
        "launches": launches_c}
    log(f"tiers 10c fleet warm-start: {replicas} replicas on {hosts} hosts "
        f"in {fleet_s:.3f} s (replicas "
        + ", ".join(f"{results[i]['s']:.3f}" for i in range(replicas))
        + f" s); the store served {bytes_out} bytes "
        f"({bytes_out / chain_bytes:.4f} x the chain); remote "
        f"{report['fleet']['remote_bytes']}, peer "
        f"{report['fleet']['peer_bytes']}, cache hits "
        f"{report['fleet']['cache_hits']}; admissions a root and step: 1; "
        f"params bit-exact; launches {json.dumps(launches_c)}")
    for r in repos:
        r.close()
    del template
    gc.collect()

    # -- 10d: the port's CLI in a process of its own -----------------------
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = [sys.executable, "-m", "repro_torch.storage.cli", "--root",
           roots[0], "--device", device]
    t0 = time.perf_counter()
    verify = subprocess.run(cli + ["verify"], capture_output=True,
                            text=True, env=env, cwd=ROOT, timeout=600)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = subprocess.run(cli + ["stats", "--fleet"], capture_output=True,
                           text=True, env=env, cwd=ROOT, timeout=600)
    stats_s = time.perf_counter() - t0
    if verify.returncode != 0 or verify.stdout.count(
            "checksums verified") != len(steps):
        fail(f"storage.cli verify on {roots[0]}: exit {verify.returncode}"
             f"\n{verify.stdout}{verify.stderr}")
    with open(os.path.join(roots[0], FLEET_STATS_KEY)) as f:
        want = json.load(f)["steps"][str(newest)]["replicas"]
    line = [ln for ln in fleet.stdout.splitlines()
            if ln.startswith(f"step {newest:>10}")]
    if fleet.returncode != 0 or len(line) != 1 \
            or f"replicas={want:<4}" not in line[0] or want != replicas:
        fail(f"storage.cli stats --fleet on {roots[0]}: exit "
             f"{fleet.returncode}, want replicas={replicas} for step "
             f"{newest}\n{fleet.stdout}{fleet.stderr}")
    report["cli"] = {"verify_s": verify_s, "stats_s": stats_s,
                     "verify": verify.stdout.splitlines(),
                     "stats_fleet": fleet.stdout.splitlines()}
    log(f"tiers 10d: storage.cli verify exit 0 in {verify_s:.3f} s "
        f"({len(steps)} steps, checksums on {device}); stats --fleet in "
        f"{stats_s:.3f} s: {line[0].strip()}")
    report["s"] = time.perf_counter() - t_phase
    return report


def _engine_mode(mode: str, device: str, cfg, workdir: str,
                 host_cache_bytes: int, flush_threads: int, batch: int,
                 seq_len: int, reference) -> tuple:
    """One engine of the four: a ``Trainer`` takes 3 steps saving at 2
    under a raw policy, then a fresh manager verifies step 2 and a fresh
    trainer resumes it and takes step 3. Restored state must equal the
    device copies taken as the save was requested (and ``reference``, the
    first mode's copies, if given), step 3's loss the first
    trainer's bit for bit. Returns ``(row, the copies)``: the restored
    state equals them, and the step after resume changes it in place."""
    import torch
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  EnginePolicy)
    from repro_torch.training.loop import Trainer

    class CopyingManager(CheckpointManager):
        """The manager, keeping each save's future and a device copy of
        its state taken before the save's own clock starts."""

        def save(self, step, state, blocking=False):
            self.copies = [t.detach().clone() for t in _tensors(state)]
            fut = super().save(step, state, blocking)
            self.futures.append(fut)
            return fut

    policy = CheckpointPolicy(engine=EnginePolicy(
        mode=mode, host_cache_bytes=host_cache_bytes,
        flush_threads=flush_threads))
    mdir = os.path.join(workdir, mode)
    mgr = CopyingManager.from_policy(mdir, policy, device=device)
    mgr.futures = []
    l0 = _launches()
    try:
        tr = Trainer(cfg, batch=batch, seq_len=seq_len, manager=mgr,
                     seed=SEED, device=device)
        recs = tr.run(ENGINE_STEPS, ckpt_interval=ENGINE_SAVE_AT)
        l1 = _launches()
        if mgr.commit_errors:
            fail(f"engine {mode}: commit errors {mgr.commit_errors}")
        fut, = mgr.futures
        manifest = mgr.repository.manifest(fut.step)
        saved, last, drain_s = mgr.copies, recs[-1], tr.exit_drain_s
    finally:
        mgr.close()
    tr.manager = None
    del mgr, tr
    gc.collect()

    mgr2 = CheckpointManager.from_policy(mdir, policy, device=device)
    try:
        l2 = _launches()
        t0 = time.perf_counter()
        res = mgr2.repository.verify_step(fut.step)
        verify_s = time.perf_counter() - t0
        if not res.ok:
            fail(f"engine {mode}: step {fut.step} fails verify: "
                 f"{res.problems}")
        tr2 = Trainer(cfg, batch=batch, seq_len=seq_len, manager=mgr2,
                      seed=SEED + 1, device=device)
        t0 = time.perf_counter()
        step = tr2.resume(step=fut.step)
        if device == "cuda":
            torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        l3 = _launches()
        st = tr2.last_resume_stats
        if step != fut.step:
            fail(f"engine {mode}: resume gave step {step}")
        _assert_equal(tr2.state(), saved, f"engine {mode}: resume")
        if reference is not None:
            _assert_equal(tr2.state(), reference,
                          f"engine {mode}: resume against the first mode")
        again = tr2.run(1)[-1]
    finally:
        mgr2.close()
    if not (math.isfinite(last.loss) and again.loss == last.loss):
        fail(f"engine {mode}: step {last.step} after resume: loss "
             f"{again.loss!r}, the first trainer's {last.loss!r}")
    st_f = fut.stats
    row = {
        "mode": mode,
        # the save's own prologue plus the capture barrier before step
        # 3's update (the end-of-run drain is not a stall of the save)
        "stall_s": st_f.blocking_s + last.ckpt_stall_s - drain_s,
        "barrier_s": last.ckpt_stall_s - drain_s, "drain_s": drain_s,
        "prologue_s": st_f.blocking_s,
        "capture_s": st_f.capture_latency_s,
        "iter_beside_save_s": last.iter_s,
        "grad_beside_save_s": last.grad_s,
        "iter_alone_s": again.iter_s, "grad_alone_s": again.grad_s,
        "iter_first_s": recs[0].iter_s,
        "persist_s": st_f.persist_latency_s,
        "commit_s": st_f.commit_latency_s,
        "commit_build_s": st_f.commit_s,
        "serialize_s": st_f.serialize_s, "stage_s": st_f.stage_s,
        "bytes_written": manifest.total_bytes,
        "files_written": len(manifest.files),
        # the restore: the step's files hashed again, then the resume
        # (index — a sync step's whole-graph unpickle —, plan, ranged
        # reads, assembly onto the card)
        "restore_s": verify_s + resume_s, "verify_s": verify_s,
        "resume_s": resume_s, "index_s": st.index_s, "read_s": st.read_s,
        "assemble_s": st.assemble_s,
        "bytes_read": st.bytes_read, "n_ranges": st.n_ranges,
        "checksum_launches_save": l1["checksum_u32"] - l0["checksum_u32"],
        "checksum_launches_restore":
            l3["checksum_u32"] - l2["checksum_u32"],
        "loss": last.loss, "resumed_loss": again.loss}
    log(f"engine {mode}: stall {row['stall_s']:.4f} s (prologue "
        f"{row['prologue_s']:.4f} s); step {last.step} {last.iter_s:.4f} s "
        f"beside the save, {again.iter_s:.4f} s alone; persist "
        f"{row['persist_s']:.3f} s, commit {row['commit_s']:.3f} s; "
        f"{row['bytes_written']} bytes in {row['files_written']} files; "
        f"restore {row['restore_s']:.3f} s (verify {verify_s:.3f} s, resume "
        f"{resume_s:.3f} s: index {st.index_s:.3f} s, read {st.read_s:.3f} "
        f"s), {st.bytes_read} bytes read; checksum_u32 "
        f"{row['checksum_launches_save']} launches at save and commit, "
        f"{row['checksum_launches_restore']} at restore; step "
        f"{last.step}'s loss {last.loss!r} from both trainers")
    return row, saved


def run_engines_path(device: str, cfg, workdir: str, host_cache_bytes: int,
                     flush_threads: int, batch: int, seq_len: int) -> list:
    """The four engines the paper compares, one after the other from the
    same seed (:func:`_engine_mode`); each mode's directory is removed
    after its check. Every mode's restored state must equal the first
    mode's (its copies at the save, which its restore equalled) bit for
    bit. Returns one row a mode."""
    rows, reference = [], None
    for mode in ENGINE_ORDER:
        try:
            row, saved = _engine_mode(
                mode, device, cfg, workdir, host_cache_bytes, flush_threads,
                batch, seq_len, reference)
        finally:
            shutil.rmtree(os.path.join(workdir, mode), ignore_errors=True)
        if reference is None:
            reference = saved
        del saved
        rows.append(row)
        gc.collect()
        if device == "cuda":
            import torch
            torch.cuda.empty_cache()
    return rows


def run_dist_process_path(device: str, cfg, workdir: str,
                          host_cache_bytes: int, flush_threads: int,
                          batch: int, seq_len: int) -> dict:
    """Phase 9b: a ``Trainer`` takes :data:`DIST_TRAIN_STEPS` steps; its
    state, laid out ``tp_zero1`` on a (data 2 x model 4) mesh of virtual
    devices by ``shard_tree``, is saved once, raw, by four spawned writer
    ranks on the card (after a tiny step-0 save that waits out their
    start-up). Bytes written must equal the state's unique bytes (params
    replicated over ``data`` written once), every rank must write and
    vote. A fresh world-1 manager then restores the step onto a (data 4 x
    model 2) mesh and, through a fresh trainer, onto its unsharded
    tensors, both bit for bit; the resumed trainer's next step must give
    the uninterrupted trainer's loss bit for bit."""
    import dataclasses

    import torch
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  DistPolicy, EnginePolicy)
    from repro_torch.core.tree import map_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import trace as obs
    from repro_torch.sharding import (opt_pspecs, param_pspecs, shard_tree,
                                      unshard)
    from repro_torch.training.loop import Trainer

    cfg = dataclasses.replace(cfg, sharding_mode="tp_zero1")

    def specs(tree, mesh):
        return {"model": param_pspecs(cfg, tree["model"], mesh),
                "optimizer": opt_pspecs(cfg, tree["model"], mesh)}

    tr = Trainer(cfg, batch=batch, seq_len=seq_len, seed=SEED, device=device)
    tr.run(DIST_TRAIN_STEPS)
    step = tr.step
    log(f"process ranks: trained {step} steps")
    saved_tree = map_leaves(lambda x: x.detach().clone()
                            if isinstance(x, torch.Tensor) else x, tr.state())
    saved = _tensors(saved_tree)
    unique = sum(t.numel() * t.element_size() for t in saved)
    mesh_a = make_mesh((2, 4), ("data", "model"), device)
    sharded = shard_tree(tr.state(), specs(tr.state(), mesh_a), mesh_a)
    policy = CheckpointPolicy(
        engine=EnginePolicy(host_cache_bytes=host_cache_bytes,
                            flush_threads=flush_threads),
        dist=DistPolicy(world=DIST_WORLD, node_size=DIST_NODE_SIZE,
                        runtime="process"))
    t0 = time.perf_counter()
    mgr = CheckpointManager.from_policy(workdir, policy, device=device)
    try:
        mgr.save(0, {"warm": torch.zeros(4, device=device)}, blocking=True)
        start_s = time.perf_counter() - t0
        log(f"process ranks: started and saved step 0 in {start_s:.3f} s")
        with obs.tracing() as tracer:
            t0 = time.perf_counter()
            fut = mgr.save(step, sharded)
            prologue_s = time.perf_counter() - t0
            stall_s = mgr.wait_for_capture()
            fut.wait_persisted()
            mgr.wait_for_commit(step)
        if mgr.commit_errors:
            fail(f"process ranks: commit errors {mgr.commit_errors}")
        meta = mgr.repository.manifest(step).meta
        man = mgr.repository.manifest(step)
    finally:
        mgr.close()
    st = fut.stats
    peak = st.extra.get("device_peak_bytes", {})
    on_card = sorted(peak) == list(range(DIST_WORLD))
    if meta.get("world") != DIST_WORLD or "writers" in meta \
            or on_card != (device == "cuda"):
        fail(f"process ranks: world {meta.get('world')}, writers "
             f"{meta.get('writers', 'all')}, ranks that reported from the "
             f"card {sorted(peak)}")
    if st.bytes_tensors != unique:
        fail(f"process ranks wrote {st.bytes_tensors} tensor bytes, the "
             f"state holds {unique} unique bytes")
    ships = tracer.spans("rank.ship")
    log(f"process ranks: saved step {step}")
    del sharded
    again = tr.run(1)[-1]
    tr = None
    gc.collect()
    consolidation = _consolidate_step(device, workdir, step)

    rpolicy = CheckpointPolicy(engine=EnginePolicy(
        host_cache_bytes=64 << 20, flush_threads=1))
    rmgr = CheckpointManager.from_policy(workdir, rpolicy, device=device)
    try:
        mesh_b = make_mesh((4, 2), ("data", "model"), device)
        zeros = map_leaves(lambda x: torch.zeros_like(x)
                           if isinstance(x, torch.Tensor) else x, saved_tree)
        template = shard_tree(zeros, specs(zeros, mesh_b), mesh_b)
        del zeros
        t0 = time.perf_counter()
        got = rmgr.restore(template, step=step)
        if device == "cuda":
            torch.cuda.synchronize()
        elastic_s = time.perf_counter() - t0
        if got["optimizer"]["m"]["embed"]["embed"].mesh != mesh_b:
            fail("the elastic restore did not land on the (4 x 2) mesh")
        _assert_equal(unshard(got), saved, "restore onto the (4 x 2) mesh")
        del got, template
        gc.collect()
        tr2 = Trainer(cfg, batch=batch, seq_len=seq_len, manager=rmgr,
                      seed=SEED + 1, device=device)
        t0 = time.perf_counter()
        if tr2.resume(step=step) != step:
            fail("the resume from the world-4 step gave another step")
        if device == "cuda":
            torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        _assert_equal(tr2.state(), saved, "resume onto unsharded tensors")
        again2 = tr2.run(1)[-1]
    finally:
        rmgr.close()
    if not (math.isfinite(again.loss) and again2.loss == again.loss):
        fail(f"step {again.step} after the elastic resume: loss "
             f"{again2.loss!r}, the uninterrupted trainer's {again.loss!r}")
    return {"world": DIST_WORLD, "node_size": DIST_NODE_SIZE,
            "start_s": start_s, "prologue_s": prologue_s, "stall_s": stall_s,
            "ship_s": {e["args"]["rank"]: e["dur"] for e in ships},
            "ship_bytes": st.bytes_tensors,
            "persist_s": st.persist_latency_s,
            "commit_s": st.commit_latency_s, "commit_build_s": st.commit_s,
            "bytes_written": man.total_bytes, "unique_bytes": unique,
            "files": len(man.files), "child_peak_bytes": peak,
            "child_launches": st.extra.get("kernel_launches", {}),
            "elastic_restore_s": elastic_s, "resume_s": resume_s,
            "loss": again.loss, "resumed_loss": again2.loss,
            "consolidation": consolidation}


def _consolidate_step(device: str, workdir: str, step: int) -> dict:
    """Phase 9b's offline consolidation: the committed step's rank files
    merged :data:`CONSOLIDATE_GROUP` to an aggregate, the originals
    removed, before the restores read it. Fails unless every rank file
    went into an aggregate. The step is raw (the process ranks' policy
    routes nothing to the delta provider), so nothing in it is refused."""
    import glob

    from repro_torch.core import step_dir
    from repro_torch.core.consolidate import consolidate_step_dir, file_count
    sdir = step_dir(workdir, step)
    ranks = sorted(glob.glob(os.path.join(sdir, "rank*.dsllm")))
    bytes_read = sum(os.path.getsize(p) for p in ranks)
    files_before = file_count(sdir)
    t0 = time.perf_counter()
    written = consolidate_step_dir(sdir, group=CONSOLIDATE_GROUP,
                                   remove_originals=True, device=device)
    secs = time.perf_counter() - t0
    files_after = file_count(sdir)
    want = -(-len(ranks) // CONSOLIDATE_GROUP)
    if len(ranks) != DIST_WORLD or len(written) != want \
            or files_after != want \
            or glob.glob(os.path.join(sdir, "rank*.dsllm")):
        fail(f"consolidation of step {step}: {len(ranks)} rank files into "
             f"{len(written)} aggregates, {files_after} files left")
    out = {"s": secs, "bytes_read": bytes_read,
           "bytes_written": sum(os.path.getsize(p) for p in written),
           "files_before": files_before, "files_after": files_after,
           "group": CONSOLIDATE_GROUP, "encoding": "raw"}
    log(f"process ranks: consolidated step {step} in {secs:.3f} s: "
        f"{files_before} rank files ({bytes_read} bytes read) into "
        f"{files_after} aggregates ({out['bytes_written']} bytes written), "
        f"group {CONSOLIDATE_GROUP}; raw tensors, no delta-encoded one to "
        f"refuse")
    return out


def _fold_2d(t):
    """A stacked leaf ``(count, rows, cols)`` as ``(count * rows, cols)``;
    1-D and 2-D leaves as they are."""
    return t.reshape(-1, t.shape[-1]) if t.dim() > 2 else t


def _rows_256(t):
    """A leaf as rows of 256 values."""
    return t.reshape(-1, 256)


def _plain_work(t, quant: str):
    """The working array the reducer keeps for ``t`` (``encode_tensor``'s
    choice of quantizer, made by the kernels' plain versions on ``t``'s
    device), as a host array."""
    import torch
    from repro_torch.core.dtypes import host_copy
    from repro_torch.kernels import quantize as tq
    rows = t.dtype == torch.float32 and t.dim() == 2 \
        and t.shape[0] % tq.TILE == 0
    if quant == "bf16" and rows and t.shape[1] % tq.TILE == 0:
        return host_copy(tq.downcast_bf16_plain(t))
    if quant == "int8" and rows and t.shape[1] == tq.ROW_ELEMS:
        return host_copy(tq.quantize_int8_plain(t)[0])
    return host_copy(t)


def run_reduction_path(device: str, cfg, workdir: str,
                       steps: int = REDUCE_STEPS) -> dict:
    """The offline reduction path (slice 4): ``steps`` in-place AdamW steps
    on seeded gradients, each followed by a save of two offline
    checkpointers (keyframe every 3: K, delta[, delta]).
    ``quant="bf16"`` saves the fp32 master with stacked leaves folded to
    ``(count * rows, cols)``; ``quant="int8"`` saves the fp32 first moment
    with every leaf viewed as rows of 256. Without the fold no llama leaf
    meets the reference's 2-D shape test (``repro/core/reduction.py:84``,
    ``:87``) and nothing would be quantized; the norm scales still fall
    back to raw, as in the reference. Then steps 1..``steps`` restore and
    must equal, bit for bit, the working arrays the plain versions give on
    ``device`` for that step's saved state; then the ``dequantize_int8``
    kernel on the last step's restored q and stored scales must be within
    one scale of the saved moment (``tests/test_reduction.py:40-51``)."""
    import numpy as np
    import torch
    from repro_torch.core import reduction as R
    from repro_torch.core.tree import flatten_with_path, keystr, map_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         init_opt_state)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    params = init_params(cfg, gen, device)
    opt = init_opt_state(params)
    flat, unflatten = flatten_with_path(params)
    hp = AdamWConfig()
    views = {"bf16": lambda: map_leaves(_fold_2d, opt["master"]),
             "int8": lambda: map_leaves(_rows_256, opt["m"])}
    ckpts = {q: R.DifferentialCheckpointer(
        os.path.join(workdir, q), keyframe_every=REDUCE_KEYFRAME_EVERY,
        quant=q, device=device) for q in views}
    want = {q: [] for q in views}
    report = {"saves": [], "restores": []}
    last = None
    for step in range(1, steps + 1):
        grads = unflatten([
            (torch.randn(t.shape, generator=gen, device=device)
             * 1e-2).to(t.dtype) for _p, t in flat])
        apply_updates(params, opt, grads, hp)
        del grads
        for quant, view in views.items():
            tree = view()
            t0 = time.perf_counter()
            info = ckpts[quant].save(step, tree)
            secs = time.perf_counter() - t0
            want[quant].append({keystr(p): _plain_work(t, quant)
                                for p, t in flatten_with_path(tree)[0]})
            row = {"step": step, "quant": quant, "s": secs,
                   "keyframe": info["keyframe"],
                   "raw_bytes": info["raw_bytes"],
                   "compressed_bytes": info["compressed_bytes"],
                   "ratio": info["ratio"],
                   "working_bytes": sum(a.nbytes for a in
                                        want[quant][-1].values())}
            report["saves"].append(row)
            log(f"reducer save step {step} ({quant}, "
                f"{'keyframe' if row['keyframe'] else 'delta'}): "
                f"{secs:.3f} s, {row['raw_bytes']} raw bytes, "
                f"{row['working_bytes']} working bytes, "
                f"{row['compressed_bytes']} compressed (ratio "
                f"{row['ratio']:.3f})")
            if info["keyframe"] != (step % REDUCE_KEYFRAME_EVERY == 1):
                fail(f"reducer step {step} ({quant}): keyframe "
                     f"{info['keyframe']}")
    for quant, ck in ckpts.items():
        for step in range(1, steps + 1):
            t0 = time.perf_counter()
            got = ck.restore(step)
            secs = time.perf_counter() - t0
            expect = want[quant][step - 1]
            if list(got) != list(expect):
                fail(f"reducer restore of step {step} ({quant}): names "
                     f"{list(got)} against {list(expect)}")
            for name, w in expect.items():
                g = got[name]
                if g.shape != w.shape or g.dtype != w.dtype \
                        or not np.array_equal(g.reshape(-1).view(np.uint8),
                                              w.reshape(-1).view(np.uint8)):
                    fail(f"reducer restore of step {step} ({quant}): "
                         f"{name} is not the saved working array")
            report["restores"].append({"step": step, "quant": quant,
                                       "s": secs})
            log(f"reducer restore step {step} ({quant}): {secs:.3f} s, "
                f"bit-exact")
            if step == steps and quant == "int8":
                last = got
            del got
    rec = R.load_record(os.path.join(ckpts["int8"].directory,
                                     f"diff_{steps:08d}.pkl"))
    moments = {keystr(p): t
               for p, t in flatten_with_path(views["int8"]())[0]}
    worst = 0.0
    n_deq = 0
    for name, enc in rec["tensors"].items():
        if enc.quant != "int8":
            continue
        scales = torch.from_numpy(np.frombuffer(
            R._decompress(enc.scales), np.float32).copy()) \
            .reshape(-1, 1).to(device)
        q = torch.from_numpy(last[name]).to(device)
        out = ops.dequantize_int8(q, scales)
        err = (out - moments[name]).abs()
        if not bool((err <= scales).all()):
            fail(f"reducer: dequantized {name} of step {steps} is more "
                 f"than one scale from the saved moment")
        worst = max(worst, float((err / scales).max()))
        n_deq += 1
    sync()
    report.update(dequantized_leaves=n_deq, worst_err_over_scale=worst)
    log(f"reducer: dequantize_int8 of step {steps}'s {n_deq} int8 leaves "
        f"within one scale of the saved first moment (worst "
        f"{worst:.4f} of a scale)")
    return report


# ------------------------------------------------------------ model zoo
def _zoo_cfg(name: str, n_layers: int, pattern: tuple):
    """``name``'s config at full width, cut to ``n_layers`` layers of
    repetitions of ``pattern``."""
    from repro_torch.configs import get_config
    return get_config(name, n_layers=n_layers,
                      layer_groups=((pattern, n_layers // len(pattern)),))


def _n_params(cfg) -> int:
    from repro_torch.core.tree import leaves
    from repro_torch.models import model as M
    return sum(math.prod(s.shape) for s in leaves(M.param_shapes(cfg)))


def _launch_name(hd: int, kind: str, prefix: bool, stats: bool) -> str:
    """``hd/kind[/prefix][/stats]``: a key of
    ``flash_attention.LAUNCHES_BY`` as the zoo phases log it."""
    return f"{hd}/{kind}" + ("/prefix" if prefix else "") \
        + ("/stats" if stats else "")


def _flash_by_kind(before) -> dict:
    """The attention kernel's launches by :func:`_launch_name` since
    ``before`` (a copy of ``flash_attention.LAUNCHES_BY``)."""
    from repro_torch.kernels import flash_attention as fa
    return {_launch_name(*key): n - before[key]
            for key, n in fa.LAUNCHES_BY.items() if n != before[key]}


def _prefill_launches(cfg) -> dict:
    """The kernel's launches one prefill past 2,048 tokens makes: one an
    attention layer, by its mask and the prefix."""
    from repro_torch.models import model as M
    want = collections.Counter()
    for pattern, count in cfg.layer_groups:
        for b in pattern:
            if b in M.ATTN_TYPES:
                want[_launch_name(cfg.hd, M.attn_kind(b),
                                  bool(cfg.n_prefix_embeds), False)] += count
    return dict(want)


def _zoo_prompt(cfg, device: str, batch: int, prompt_len: int) -> dict:
    """Seeded prompt tokens, and the prefix-LM's patch embeddings (fp32,
    as the data pipeline draws them) where the config has them."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 12)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                      generator=gen,
                                      dtype=torch.int32).to(device)}
    if cfg.n_prefix_embeds:
        prompt["prefix_embeds"] = torch.randn(
            batch, cfg.n_prefix_embeds, cfg.d_model, generator=gen).to(device)
    return prompt


def run_zoo_serve_path(device: str, cfg, workdir: str, batch: int,
                       prompt_len: int, n_new: int) -> dict:
    """11a, 12a and 12b: ``cfg`` (gemma3-27b: window and full blocks;
    recurrentgemma-2b: RG-LRU and window blocks; paligemma-3b: the
    prefix-LM) served from a checkpoint. Params made on ``device`` from a
    seeded generator are saved once as ``{"model": params}`` (datastates
    engine, raw policy) and restored by ``load_params_for_serving``, bit
    for bit; then ``greedy_generate`` runs ``batch`` seeded prompts of
    ``prompt_len`` tokens (after the config's patch prefix, where it has
    one) for ``n_new`` tokens twice (the same tokens), each prefill
    launching the kernel once an attention layer with the layer's mask
    and the prefix at ``cfg.hd`` and no decode step launching it; then
    the steps again by hand, where every decode step must write slot
    ``pos % window`` of each window layer's ring and nothing else of it
    and shift every ``rec`` layer's ``conv`` by one input, and the ``rec``
    layers' state after them must match a prefill over the same tokens
    (:func:`_rec_state_errs`)."""
    import torch
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  EnginePolicy)
    from repro_torch.core import dtypes
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serving import engine

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    params = M.init_params(cfg, gen, device)
    saved = [t.clone() for t in leaves(params)]
    policy = CheckpointPolicy(engine=EnginePolicy(
        host_cache_bytes=HOST_CACHE_BYTES, flush_threads=8))
    mgr = CheckpointManager.from_policy(workdir, policy, device=device)
    try:
        t0 = time.perf_counter()
        fut = mgr.save(1, {"model": params})
        mgr.wait_for_persist()
        mgr.wait_for_commit()
        save_s = time.perf_counter() - t0
        if mgr.commit_errors:
            fail(f"zoo serving: commit errors {mgr.commit_errors}")
    finally:
        mgr.close()
    del params
    gc.collect()
    template = map_leaves(
        lambda spec: torch.empty(spec.shape, device=device,
                                 dtype=dtypes.lookup(spec.dtype).torch),
        M.param_shapes(cfg))
    t0 = time.perf_counter()
    params, st = engine.load_params_for_serving(workdir, template, step=1)
    sync()
    restore_s = time.perf_counter() - t0
    del template
    _assert_equal(params, saved, "zoo serving: restore")
    del saved
    gc.collect()

    want = _prefill_launches(cfg) if on_card else {}
    prompt = _zoo_prompt(cfg, device, batch, prompt_len)
    runs = []
    for _ in range(2):
        before = collections.Counter(fa.LAUNCHES_BY)
        t0 = time.perf_counter()
        out = engine.greedy_generate(cfg, params, prompt, n_new)
        sync()
        runs.append((out, time.perf_counter() - t0, _flash_by_kind(before)))
    (out, _s, by_kind), (out2, _s2, by_kind2) = runs
    if out.shape != (batch, n_new) or bool(((out < 0)
                                            | (out >= cfg.vocab)).any()):
        fail(f"zoo serving: greedy_generate gave {tuple(out.shape)} with "
             f"tokens outside the vocabulary")
    if not torch.equal(out, out2):
        fail("zoo serving: greedy_generate gave other tokens the second "
             "time")
    if by_kind != want or by_kind2 != want:
        fail(f"zoo serving: a greedy_generate launched the attention "
             f"kernel {by_kind} / {by_kind2}, not {want} (once a layer in "
             f"the prefill, by the layer's mask; none in decode)")

    # the steps by hand: prefill, then each decode step writes one ring
    # slot of every window layer
    cfg_n = dataclasses.replace(cfg, max_decode_len=n_new)
    prefill = engine.make_prefill_step(cfg_n)
    decode = engine.make_decode_step(cfg_n)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    sync()
    prefill_s = time.perf_counter() - t0
    rings = [c for (pattern, _n), group in zip(cfg.layer_groups, caches)
             for b, c in zip(pattern, group) if b == "window"]
    recs = [c for (pattern, _n), group in zip(cfg.layer_groups, caches)
            for b, c in zip(pattern, group) if b == "rec"]
    toks, decode_s, wraps = [], 0.0, 0
    for i in range(n_new):
        pos = prompt_len + cfg.n_prefix_embeds + i
        toks.append(torch.argmax(logits[:, -1].float(), -1)
                    .to(torch.int32)[:, None])
        before = [(c["k"].clone(), c["v"].clone()) for c in rings]
        rec_before = [(c["h"].clone(), c["conv"].clone()) for c in recs]
        t0 = time.perf_counter()
        logits, caches = decode(params, toks[-1], caches, pos)
        sync()
        decode_s += time.perf_counter() - t0
        slot = pos % cfg.window if rings else pos
        wraps += slot < pos
        for c, (k0, v0) in zip(rings, before):
            for new, old in ((c["k"], k0), (c["v"], v0)):
                changed = (new != old).flatten(3).any(-1).any(0).any(0)
                if changed.nonzero().flatten().tolist() != [slot]:
                    fail(f"zoo serving: decode at position {pos} changed "
                         f"ring slots {changed.nonzero().flatten().tolist()}"
                         f", not [{slot}]")
        for c, (_h0, conv0) in zip(recs, rec_before):
            # the convolution's window of the last W - 1 inputs shifts by
            # one (a repeated token may leave h and the values as they
            # were: greedy decoding can settle on one token)
            shifted = (c["conv"][:, :, :-1] == conv0[:, :, 1:]) \
                .flatten(1).all(-1)
            if not bool(shifted.all()):
                fail(f"zoo serving: decode at position {pos}: rec layers' "
                     f"conv shifted by one {shifted.tolist()}")
    rec_errs = _rec_state_errs(cfg, prefill, params, prompt, toks, recs) \
        if recs else []
    if not torch.equal(torch.cat(toks, 1), out):
        fail("zoo serving: the prefill and decode steps gave other tokens "
             "than greedy_generate")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del logits, caches
    layer_errs = _zoo_layer_flash_errs(cfg, prefill, params, prompt) \
        if on_card else []
    report = {
        "config": cfg.name, "layers": cfg.n_layers,
        "pattern": [list(p) for p, _n in cfg.layer_groups],
        "window": cfg.window, "hd": cfg.hd,
        "n_prefix": cfg.n_prefix_embeds, "params": _n_params(cfg),
        "bytes": st.bytes_read, "save_s": save_s,
        "save_persist_s": fut.stats.persist_latency_s,
        "restore_s": restore_s, "restore_verify_s": st.verify_s,
        "restore_read_s": st.read_s, "prefill_s": prefill_s,
        "decode_s_per_token": decode_s / n_new,
        "generate_s": [r[1] for r in runs], "flash_by_kind": by_kind,
        "ring_wraps": wraps, "rec_state_rel_l2": rec_errs,
        "layer_max_abs_err": layer_errs,
        "tokens": out.cpu().tolist()}
    if on_card:
        report["max_memory_allocated"] = peak
    log(f"zoo serving ({cfg.name}, {cfg.n_layers} layers, "
        f"{report['params']} params): save {save_s:.2f} s, restore "
        f"{restore_s:.2f} s ({st.bytes_read} bytes, bit-exact), prefill of "
        f"{batch} x ({cfg.n_prefix_embeds} + {prompt_len}) "
        f"{prefill_s:.3f} s, decode "
        f"{report['decode_s_per_token'] * 1e3:.2f} ms a token; the same "
        f"{n_new} tokens twice; kernel launches a prefill {by_kind}; "
        + (f"{wraps} decode steps past the ring's first wrap, each writing "
           f"slot pos % {cfg.window} alone; " if rings else "")
        + (f"every step shifted each of {len(recs)} rec layers' conv, "
           f"and (h, conv) after the steps within a relative L2 error of "
           f"{REC_STATE_REL_L2} of a prefill over the same tokens "
           f"{rec_errs}; " if recs else "")
        + f"every attention layer's real q/k/v through the kernel within "
        f"{FLASH_TOL['bfloat16']} of the plain version (max |diff| by "
        f"layer {layer_errs})")
    return report


#: the ``rec`` layers' state after decode steps against a prefill over
#: the same tokens: relative L2 error (bf16 projections at other shapes,
#: the log-depth scan against the stepwise recurrence)
REC_STATE_REL_L2 = 2e-2


def _rec_state_errs(cfg, prefill, params, prompt, toks, recs) -> list:
    """Each ``rec`` layer's ``h`` and ``conv`` after the decode steps
    against a prefill over the prompt and the tokens fed to them, by
    relative L2 error (within :data:`REC_STATE_REL_L2`): the decode
    steps continue the prefill's recurrence."""
    import torch
    longer = dict(prompt, tokens=torch.cat([prompt["tokens"]] + toks, 1))
    _logits, caches = prefill(params, longer)
    want = [c for (pattern, _n), group in zip(cfg.layer_groups, caches)
            for b, c in zip(pattern, group) if b == "rec"]
    errs = [(_rel_l2(c["h"], w["h"]), _rel_l2(c["conv"], w["conv"]))
            for c, w in zip(recs, want)]
    if not all(e < REC_STATE_REL_L2 for pair in errs for e in pair):
        fail(f"zoo serving: the rec layers' (h, conv) after decode stand "
             f"at relative L2 errors {errs} from a prefill over the same "
             f"tokens (limit {REC_STATE_REL_L2})")
    return errs


def _zoo_layer_flash_errs(cfg, prefill, params, prompt) -> list:
    """One more prefill with every launch of the attention kernel
    recorded: each attention layer's real q, k, v (and mask) through the
    plain version too, within ``FLASH_TOL["bfloat16"]``; fails unless the
    prefill launched the kernel once an attention layer, with the layer's
    mask and the prefix. Returns each layer's largest difference."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    kinds = [M.attn_kind(b) for pattern, count in cfg.layer_groups
             for _ in range(count) for b in pattern if b in M.ATTN_TYPES]
    seen = []
    launch = fa.flash_attention_cuda

    def recording(q, k, v, **kw):
        got = launch(q, k, v, **kw)
        seen.append((q, k, v, kw, got))
        return got
    fa.flash_attention_cuda = recording
    try:
        with torch.no_grad():
            logits, caches = prefill(params, prompt)
    finally:
        fa.flash_attention_cuda = launch
    del logits, caches
    masks = [(kw["kind"], kw["window"], kw["n_prefix"])
             for *_qkv, kw, _g in seen]
    if masks != [(b, cfg.window, cfg.n_prefix_embeds) for b in kinds]:
        fail(f"zoo serving: the prefill launched the attention kernel with "
             f"(mask, window, prefix) {masks}, not the layers' {kinds} at "
             f"window {cfg.window}, prefix {cfg.n_prefix_embeds}")
    errs = []
    for i, (q, k, v, kw, got) in enumerate(seen):
        with torch.no_grad():
            want = fa.flash_attention_plain(
                q, k, v, kv_block=cfg.attn_kv_block, **kw)
        torch.cuda.synchronize()
        err = _flash_err(got, want, FLASH_TOL["bfloat16"])
        if not math.isfinite(err):
            fail(f"zoo serving: flash_attention disagrees with its plain "
                 f"version on layer {i}'s q/k/v {tuple(q.shape)}/"
                 f"{tuple(k.shape)} ({kw}): max |diff| "
                 f"{float((got.float() - want.float()).abs().max())!r}")
        errs.append(err)
        del want
    return errs


def run_zoo_train_path(device: str, cfg, workdir: str, batch: int,
                       seq_len: int) -> dict:
    """11b: ``cfg`` (musicgen-medium: codebooks, memory, ``xattn``,
    layernorm, biases, ``gelu_mlp``) trained past 2,048 tokens through
    the kernel's forward with row stats and the ported backward:
    phase 8's check of one engine (``datastates``, raw policy: 3 steps
    saving at 2, a fresh manager verifies and a fresh trainer resumes
    step 2 bit for bit, step 3's loss bit-equal), with every step
    launching the kernel once a layer with stats and nothing else."""
    from repro_torch.kernels import flash_attention as fa
    before = collections.Counter(fa.LAUNCHES_BY)
    t0 = time.perf_counter()
    row, _copies = _engine_mode("datastates", device, cfg, workdir,
                                HOST_CACHE_BYTES, 8, batch, seq_len, None)
    by_kind = _flash_by_kind(before)
    steps = ENGINE_STEPS + 1     # three, then one after the resume
    want = {f"{cfg.hd}/full/stats": steps * cfg.n_layers} \
        if device == "cuda" else {}
    if by_kind != want:
        fail(f"zoo training: the attention kernel ran {by_kind} over "
             f"{steps} steps, not {want} (once a layer and step, with "
             f"stats, under grad)")
    if not math.isfinite(row["loss"]):
        fail(f"zoo training: loss {row['loss']!r}")
    row.update(config=cfg.name, layers=cfg.n_layers, params=_n_params(cfg),
               flash_by_kind=by_kind, s=time.perf_counter() - t0)
    log(f"zoo training ({cfg.name}, {cfg.n_layers} layers, "
        f"{row['params']} params, {batch} x {seq_len} tokens): "
        f"{row['s']:.1f} s; step 3's loss {row['loss']!r} before and after "
        f"the resume; kernel launches {by_kind}")
    return row


def run_zoo_generate_path(device: str, cfg, batch: int, prompt_len: int,
                          n_new: int) -> dict:
    """12c: ``cfg`` (dbrx-132b: MoE; rwkv6-7b: RWKV6) from params made on
    ``device`` from a seeded generator, without a save (their checkpoints
    cross between the packages in the CPU tests): ``greedy_generate`` of
    ``batch`` seeded prompts of ``prompt_len`` tokens for ``n_new``
    twice, the same tokens, each prefill launching the kernel once an
    attention layer by its mask and no decode step launching it. A config
    with ``rwkv`` blocks also decodes on from a prefill of ``prompt_len -
    RWKV_TAIL`` tokens, fed the next given tokens, to last logits within
    :data:`RWKV_TAIL_REL_L2` (relative L2 error) of a forward over all
    ``prompt_len``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serving import engine

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device)
    sync()
    init_s = time.perf_counter() - t0
    want = _prefill_launches(cfg) if on_card else {}
    prompt = _zoo_prompt(cfg, device, batch, prompt_len)
    runs = []
    for _ in range(2):
        before = collections.Counter(fa.LAUNCHES_BY)
        t0 = time.perf_counter()
        out = engine.greedy_generate(cfg, params, prompt, n_new)
        sync()
        runs.append((out, time.perf_counter() - t0, _flash_by_kind(before)))
    (out, _s, by_kind), (out2, _s2, by_kind2) = runs
    if out.shape != (batch, n_new) or bool(((out < 0)
                                            | (out >= cfg.vocab)).any()):
        fail(f"zoo generation ({cfg.name}): greedy_generate gave "
             f"{tuple(out.shape)} with tokens outside the vocabulary")
    if not torch.equal(out, out2):
        fail(f"zoo generation ({cfg.name}): greedy_generate gave other "
             f"tokens the second time")
    if by_kind != want or by_kind2 != want:
        fail(f"zoo generation ({cfg.name}): a greedy_generate launched the "
             f"attention kernel {by_kind} / {by_kind2}, not {want}")
    prefill = engine.make_prefill_step(cfg)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    sync()
    prefill_s = time.perf_counter() - t0
    del logits, caches
    report = {"config": cfg.name, "layers": cfg.n_layers,
              "pattern": [list(p) for p, _n in cfg.layer_groups],
              "params": _n_params(cfg), "init_s": init_s,
              "prefill_s": prefill_s, "generate_s": [r[1] for r in runs],
              "flash_by_kind": by_kind, "tokens": out.cpu().tolist()}
    tail = ""
    if any(b == "rwkv" for p, _n in cfg.layer_groups for b in p):
        tokens = prompt["tokens"]
        cut = prompt_len - RWKV_TAIL
        t0 = time.perf_counter()
        with torch.no_grad():
            whole = M.forward(cfg, params, {"tokens": tokens})[:, -1] \
                .float()
            _l, caches = M.forward(cfg, params, {"tokens": tokens[:, :cut]},
                                   collect_caches=True)
            for pos in range(cut, prompt_len):
                logits, caches = M.decode(
                    cfg, params, {"tokens": tokens[:, pos:pos + 1]}, caches,
                    pos)
        sync()
        err = _rel_l2(logits[:, -1], whole)
        if not err < RWKV_TAIL_REL_L2:
            fail(f"zoo generation ({cfg.name}): a prefill of {cut} tokens "
                 f"and {RWKV_TAIL} decode steps gave last logits at a "
                 f"relative L2 error of {err!r} from a forward over "
                 f"{prompt_len} (limit {RWKV_TAIL_REL_L2})")
        report.update(tail_rel_l2=err, tail_s=time.perf_counter() - t0)
        tail = (f"; a prefill of {cut} tokens and {RWKV_TAIL} decode steps "
                f"within a relative L2 error of {err:.3g} of the "
                f"{prompt_len}-token forward")
        del whole, logits, caches
    if on_card:
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"zoo generation ({cfg.name}, {cfg.n_layers} layers, "
        f"{report['params']} params, seeded on {device} in {init_s:.2f} s): "
        f"prefill of {batch} x {prompt_len} {prefill_s:.3f} s, "
        f"greedy_generate of {n_new} tokens "
        f"{', '.join(f'{r[1]:.2f}' for r in runs)} s, the same tokens "
        f"twice; kernel launches a prefill {by_kind}{tail}")
    del params
    return report


def run_zoo_rest_phase(path_launches: dict) -> dict:
    """Phase 12 on the card, the rest of the zoo at full width: 12a
    recurrentgemma-2b and 12b paligemma-3b served from a checkpoint
    (:func:`run_zoo_serve_path`), 12c dbrx-132b and rwkv6-7b generating
    from seeded params (:func:`run_zoo_generate_path`); each part with
    the launch counts zeroed just before and read into ``path_launches``
    just after."""
    import torch
    report = {}
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")

    def cfg(name):
        pattern = ZOO12_PATTERNS[name]
        return _zoo_cfg(name, len(pattern), pattern)

    def generate():
        return {name: run_zoo_generate_path("cuda", cfg(name), SERVE_BATCH,
                                            SERVE_PROMPT, SERVE_NEW)
                for name in ("dbrx-132b", "rwkv6-7b")}
    for key, run in (
            ("recurrent", lambda: run_zoo_serve_path(
                "cuda", cfg("recurrentgemma-2b"),
                os.path.join(zoo_dir, "rec"), SERVE_BATCH, SERVE_PROMPT,
                SERVE_NEW)),
            ("prefix_lm", lambda: run_zoo_serve_path(
                "cuda", cfg("paligemma-3b"), os.path.join(zoo_dir, "vlm"),
                SERVE_BATCH, SERVE_PROMPT - FLASH_PREFIX, SERVE_NEW)),
            ("generate", generate)):
        shutil.rmtree(zoo_dir, ignore_errors=True)
        try:
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            t0 = time.perf_counter()
            report[key] = run()
            report[key]["launches"] = path_launches[f"zoo_{key}"] = \
                _launches()
            report[key]["phase_s"] = time.perf_counter() - t0
            report[key]["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated()
        finally:
            shutil.rmtree(zoo_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    for key, k in (("recurrent", "checksum_u32"),
                   ("recurrent", "flash_attention"),
                   ("prefix_lm", "checksum_u32"),
                   ("prefix_lm", "flash_attention"),
                   ("generate", "flash_attention")):
        if report[key]["launches"][k] == 0:
            fail(f"kernel {k} was never launched on the zoo {key} path")
    log(f"zoo path, the rest: 12a {report['recurrent']['phase_s']:.1f} s, "
        f"12b {report['prefix_lm']['phase_s']:.1f} s, 12c "
        f"{report['generate']['phase_s']:.1f} s")
    return report


def run_zoo_phase(path_launches: dict) -> dict:
    """Phase 11 on the card: 11a and 11b, each with the launch counts
    zeroed just before and read into ``path_launches`` just after."""
    import torch
    report = {}
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")
    for key, run in (
            ("serving", lambda: run_zoo_serve_path(
                "cuda", _zoo_cfg("gemma3-27b", len(ZOO_SERVE_PATTERN),
                                 ZOO_SERVE_PATTERN),
                os.path.join(zoo_dir, "serve"), SERVE_BATCH, SERVE_PROMPT,
                SERVE_NEW)),
            ("training", lambda: run_zoo_train_path(
                "cuda", _zoo_cfg("musicgen-medium", ZOO_TRAIN_LAYERS,
                                 ("xattn",)),
                os.path.join(zoo_dir, "train"), ZOO_TRAIN_BATCH,
                ZOO_TRAIN_SEQ))):
        shutil.rmtree(zoo_dir, ignore_errors=True)
        try:
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            t0 = time.perf_counter()
            report[key] = run()
            report[key]["launches"] = path_launches[f"zoo_{key}"] = \
                _launches()
            report[key]["phase_s"] = time.perf_counter() - t0
            report[key]["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated()
        finally:
            shutil.rmtree(zoo_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    for key, k in (("serving", "checksum_u32"), ("serving", "flash_attention"),
                   ("training", "checksum_u32"),
                   ("training", "flash_attention")):
        if report[key]["launches"][k] == 0:
            fail(f"kernel {k} was never launched on the zoo {key} path")
    log(f"zoo path: 11a {report['serving']['phase_s']:.1f} s, 11b "
        f"{report['training']['phase_s']:.1f} s")
    return report


def run_dist_phase(cfg, thread_cfg, path_launches: dict) -> None:
    """Phase 9 on the card: 9a (:func:`run_main_path` through four thread
    ranks, at ``thread_cfg``, phase 4's config) and 9b
    (:func:`run_dist_process_path`, at ``cfg``), each with the launch
    counts zeroed just before and read into ``path_launches`` just after;
    fails unless each ran its kernels."""
    import torch
    from repro_torch.core import DistPolicy
    dist_dir = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(dist_dir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_main_path(
            "cuda", thread_cfg, dist_dir, HOST_CACHE_BYTES,
            flush_threads=8,
            dist=DistPolicy(world=DIST_WORLD, node_size=DIST_NODE_SIZE))
        launches = path_launches["dist_thread"] = _launches()
        thread_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(dist_dir, ignore_errors=True)
    for k in ("checksum_u32", "xor_checksum_u32", "delta_xor"):
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the thread ranks' path")
    log(f"multi-rank thread path: {thread_s:.1f} s; world {DIST_WORLD}, "
        f"node_size {DIST_NODE_SIZE}; launches {json.dumps(launches)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
        f"pinned host caches {report['pinned_bytes']} bytes")
    for row, ranks in zip(report["steps"], report["ranks"]):
        log(f"multi-rank save step {row['step']} ({row['kind']}): stall "
            f"{row['capture_stall_s']:.4f} s (prologue "
            f"{row['prologue_s']:.4f} s), persist {row['persist_s']:.3f} s, "
            f"commit {row['commit_s']:.3f} s; {ranks['rank_files']} rank "
            f"files, {ranks['rank_manifests']} rank manifests, "
            f"{ranks['node_manifests']} node manifests; rank bytes "
            + ", ".join(f"{r}: {b}" for r, b in ranks["rank_bytes"].items())
            + f" (max/min {ranks['max_min_bytes']:.4f}); rank persist "
            + ", ".join(f"{r}: {t:.3f}"
                        for r, t in ranks["rank_persist_s"].items()) + " s")
    log("dist thread report " + json.dumps(report))
    del report
    gc.collect()
    torch.cuda.empty_cache()

    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_dist_process_path(
            "cuda", cfg, dist_dir, DIST_PROCESS_CACHE_BYTES, flush_threads=8,
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        parent = _launches()
        process_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(dist_dir, ignore_errors=True)
    # the ranks' own launches in the timed save, counted in each child
    names = {k.symbol: name for name, k in _kernels().items()}
    child = {r: {names[s]: n for s, n in counts.items() if s in names}
             for r, counts in report["child_launches"].items()}
    launches = path_launches["dist_process"] = {
        k: parent[k] + sum(c.get(k, 0) for c in child.values())
        for k in parent}
    if parent["checksum_u32"] == 0:
        fail("kernel checksum_u32 was never launched by the process ranks' "
             "parent (restores, commit)")
    if sorted(child) != list(range(DIST_WORLD)) \
            or any(c.get("checksum_u32", 0) == 0 for c in child.values()):
        fail("kernel checksum_u32 was not launched by every process rank: "
             + json.dumps({r: c.get("checksum_u32", 0)
                           for r, c in child.items()}))
    log(f"multi-rank process path: {process_s:.1f} s; children start "
        f"{report['start_s']:.3f} s; ship "
        + ", ".join(f"{r}: {t:.3f}" for r, t in report["ship_s"].items())
        + f" s ({report['ship_bytes']} bytes); stall "
        f"{report['stall_s']:.4f} s; persist {report['persist_s']:.3f} s; "
        f"commit {report['commit_s']:.3f} s; {report['bytes_written']} "
        f"bytes in {report['files']} files, {report['unique_bytes']} unique "
        f"tensor bytes; children's peak device memory "
        + ", ".join(f"{r}: {b}" for r, b in
                    report["child_peak_bytes"].items())
        + f" bytes; consolidated into "
        f"{report['consolidation']['files_after']} aggregates in "
        f"{report['consolidation']['s']:.3f} s; restore of the aggregates "
        f"onto (4 x 2) {report['elastic_restore_s']:.3f} "
        f"s, resume {report['resume_s']:.3f} s, bit-exact; step "
        f"{DIST_TRAIN_STEPS + 1}'s loss {report['loss']!r} from both "
        f"trainers; launches {json.dumps(launches)} (the ranks' checksum_u32 "
        + ", ".join(f"{r}: {c.get('checksum_u32', 0)}"
                    for r, c in child.items())
        + f"); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log("dist process report " + json.dumps(report))
    del report
    gc.collect()
    torch.cuda.empty_cache()



def _timed_steps(device: str, fn, reps: int) -> float:
    """Mean seconds of ``reps`` calls of ``fn`` (CUDA events on a card)."""
    import torch
    if device != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    ev1.synchronize()
    return ev0.elapsed_time(ev1) / 1e3 / reps


def run_dryrun_path(device: str, cfg, batch: int, seq_len: int) -> dict:
    """Phase 13: the dry run (``repro_torch.launch.dryrun``) against the
    card. Each of two steps of ``cfg`` at ``batch`` x ``seq_len`` tokens,
    phase 6's prefill and a training step (``make_train_step``), is
    traced on fake tensors on a (1, 1) mesh, then run for real from
    seeded params: once to warm up, once under ``FlopCounterMode``, and
    :data:`DRYRUN_TIMED` times timed. Fails unless the traced FLOPs equal
    the counted FLOPs exactly, the dry run's argument bytes equal the real
    arguments' bytes exactly, and the attention kernel launched in each
    real step. Logs, with no gate, the predicted temp bytes against the
    peak device memory beyond the arguments, and the step time against
    the dry run's bound. Then one CLI-equivalent record of
    :data:`DRYRUN_CLI` at full depth on the production mesh."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving.engine import make_prefill_step
    from repro_torch.training.loop import make_train_step

    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    on_card = device == "cuda"
    out = {}
    for kind in ("prefill", "train"):
        shape = InputShape(f"{kind}_{batch}x{seq_len}", seq_len, batch, kind)
        rec = dryrun.dryrun_record(cfg, shape, mesh)
        roof = rec["roofline"]
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = M.init_params(cfg, gen, torch.device(device))
        tokens = torch.randint(0, cfg.vocab, (batch, seq_len),
                               dtype=torch.int32, device=device,
                               generator=gen)
        if kind == "train":
            params = map_leaves(lambda t: t.requires_grad_(True), params)
            args = (params, init_opt_state(params), {"tokens": tokens})
            step = make_train_step(cfg, AdamWConfig())
        else:
            args = (params, {"tokens": tokens})
            step = make_prefill_step(cfg)
        arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args))
        step(*args)  # warm-up
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        launches0 = fa.KERNEL.launches
        with FlopCounterMode(display=False) as fc:
            step(*args)
        counted = fc.get_total_flops()
        peak_temp = (torch.cuda.max_memory_allocated() - base) \
            if on_card else None
        step_s = _timed_steps(device, lambda: step(*args), DRYRUN_TIMED)
        launched = fa.KERNEL.launches - launches0
        if counted != roof["traced_flops_global"]:
            fail(f"dry run {kind}: traced {roof['traced_flops_global']!r} "
                 f"FLOPs, the real step counted {counted}")
        if arg_bytes != roof["memory"]["argument_size_in_bytes"]:
            fail(f"dry run {kind}: argument_size_in_bytes "
                 f"{roof['memory']['argument_size_in_bytes']}, the real "
                 f"arguments hold {arg_bytes} bytes")
        if on_card and launched < 1 + DRYRUN_TIMED:
            fail(f"dry run {kind}: the attention kernel launched {launched} "
                 f"times in {1 + DRYRUN_TIMED} real steps")
        out[kind] = {
            "fake_device": rec["fake_device"], "trace_s": rec["trace_s"],
            "flops": counted, "argument_bytes": arg_bytes,
            "predicted_temp_bytes": roof["memory"]["temp_size_in_bytes"],
            "peak_temp_bytes": peak_temp, "step_s": step_s,
            "bound_s": roof["bound_s"], "dominant": roof["dominant"],
            "terms": roof["terms"], "step_over_bound": step_s
            / roof["bound_s"], "flash_launches": launched}
        log(f"dry run {kind} at {batch} x {seq_len} tokens: traced on fake "
            f"{rec['fake_device']} tensors in {rec['trace_s']:.3f} s; "
            f"FLOPs {counted} traced and counted; argument bytes {arg_bytes} "
            f"predicted and real; temp bytes predicted "
            f"{roof['memory']['temp_size_in_bytes']}, peak beyond the "
            f"arguments {peak_temp}; step {step_s * 1e3:.3f} ms against a "
            f"bound of {roof['bound_s'] * 1e3:.3f} ms "
            f"({out[kind]['step_over_bound']:.3f}x, {roof['dominant']}); "
            f"attention kernel launches {launched}")
        del args, params, step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    rec = dryrun.run_dryrun(*DRYRUN_CLI, verbose=False)
    out["cli"] = {"arch": DRYRUN_CLI[0], "shape": DRYRUN_CLI[1],
                  "trace_s": rec["trace_s"],
                  "terms": rec["roofline"]["terms"],
                  "dominant": rec["roofline"]["dominant"],
                  "memory": rec["roofline"]["memory"]}
    log(f"dry run {DRYRUN_CLI[0]} x {DRYRUN_CLI[1]} x {rec['mesh']}: traced "
        f"in {rec['trace_s']:.3f} s; terms "
        f"{json.dumps(rec['roofline']['terms'])}; dominant "
        f"{rec['roofline']['dominant']}")
    return out


def run_dryrun_phase(cfg, path_launches: dict) -> dict:
    """Phase 13 on the card, last, with the launch counts zeroed just
    before and read into ``path_launches`` just after."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    report = run_dryrun_path("cuda", cfg, SERVE_BATCH, SERVE_PROMPT)
    launches = path_launches["dryrun"] = _launches()
    report["phase_s"] = time.perf_counter() - t0
    if launches["flash_attention"] == 0:
        fail("kernel flash_attention was never launched on the dry run's "
             "path")
    report["launches"] = launches
    log(f"dry run path: {report['phase_s']:.1f} s; launches "
        f"{json.dumps(launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _example(name: str):
    """``examples/torch/<name>.py`` loaded as a module."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_captured(fn) -> tuple:
    """``(fn(), stdout lines)``: what ``fn`` prints is kept and echoed
    indented, also when it raises."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"  | {line}")
    return out, lines


def _gate_line(lines: list, what: str) -> str:
    for line in reversed(lines):
        if "✓" in line:
            return line.strip()
    fail(f"example {what} printed no gate line")


def run_examples_path(device: str, workroot: str) -> dict:
    """Phase 14: each ``examples/torch`` program's public entry point on
    ``device``, each under ``workroot/<name>/`` (made and removed here).
    Returns each example's seconds, launches and the line it printed for
    its gate; any ``main`` that does not return 0 fails the run, and a
    gate that fails raises out of it."""
    report = {}
    names = ("quickstart", "differential_checkpointing", "elastic_resume",
             "serve_restore", "train_100m", "engine_comparison")
    for name in names:
        mod = _example(name)
        wd = os.path.join(workroot, name)
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
        before = _launches()
        t0 = time.perf_counter()
        log(f"example {name}:")
        argv = ["--device", device]
        if name == "train_100m":
            argv += list(EXAMPLES_TRAIN_100M) + [
                "--ckpt-dir", os.path.join(wd, "ckpt")]
        else:
            argv += ["--workdir", wd]
        if name == "engine_comparison":
            # main runs run_engine(mode, steps, device) for each engine
            argv += ["--steps", str(EXAMPLES_ENGINE_STEPS)]
        try:
            rc, lines = _run_captured(lambda: mod.main(argv))
            # engine_comparison's gate is its last line, the speedup
            gate = lines[-1].strip() if name == "engine_comparison" \
                else _gate_line(lines, name)
        finally:
            shutil.rmtree(wd, ignore_errors=True)
        if rc != 0:
            fail(f"example {name} returned {rc}")
        report[name] = {"s": time.perf_counter() - t0,
                        "launches": _launch_diff(before), "gate": gate}
    return report


def run_examples_phase(path_launches: dict) -> dict:
    """Phase 14 on the card, with the launch counts zeroed just before and
    read into ``path_launches`` just after."""
    import torch
    workroot = os.path.join(ROOT, "build", "chip_smoke_examples")
    shutil.rmtree(workroot, ignore_errors=True)
    _zero_launches()
    t0 = time.perf_counter()
    try:
        report = run_examples_path("cuda", workroot)
    finally:
        shutil.rmtree(workroot, ignore_errors=True)
    launches = path_launches["examples"] = _launches()
    phase_s = time.perf_counter() - t0
    if launches["checksum_u32"] == 0:
        fail("kernel checksum_u32 was never launched on the examples path")
    diff = report["differential_checkpointing"]["launches"]
    for k in ("xor_checksum_u32", "delta_xor"):
        if diff[k] == 0:
            fail(f"kernel {k} was never launched by the differential "
                 f"example")
    log(f"examples path: {phase_s:.1f} s ("
        + ", ".join(f"{k} {r['s']:.1f} s" for k, r in report.items())
        + f"); launches {json.dumps(launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase_s": phase_s, "launches": launches, "examples": report}


def main() -> None:
    t_start = time.perf_counter()
    # the examples print non-ASCII marks (✓, →); never fail on a narrow
    # locale's stdout
    sys.stdout.reconfigure(errors="backslashreplace")
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
    describe_flash_build(lib)

    rows = check_kernels()

    need = HOST_CACHE_BYTES + (16 << 30)
    avail = _mem_available_bytes()
    if avail < need:
        fail(f"host memory: {avail / 2**30:.1f} GiB available, the main "
             f"path needs {need / 2**30:.0f} GiB (a 12 GiB pinned host "
             f"cache plus restore buffers)")
    cfg = get_config("llama3.2-1b", n_layers=2,
                     layer_groups=uniform_groups("full", 2))
    # phases 4 and 9a check the save and restore's structure, not depth
    ckpt_cfg = get_config("llama3.2-1b", n_layers=CKPT_LAYERS,
                          layer_groups=uniform_groups("full", CKPT_LAYERS))
    workdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")

    # -- phase 4: the checkpoint path of slice 1 --------------------------
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_main_path("cuda", ckpt_cfg, workdir, HOST_CACHE_BYTES,
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
    persist = ", ".join(f"{r['persist_s']:.3f}" for r in report["steps"])
    log(f"checkpoint path delta encode: xor_checksum_u32 "
        f"{launches['xor_checksum_u32']} launches (saves "
        f"{report['launches_save']['xor_checksum_u32']}); encode.delta a "
        f"delta save {_encode_text(report['encode_delta'])}; persist "
        f"{persist} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log(f"checkpoint path digest: checksum_u32 {launches['checksum_u32']} "
        f"launches (saves {report['launches_save']['checksum_u32']}; "
        + "; ".join(f"restore of step {r['step']} "
                    f"{r['launches']['checksum_u32']}, verify_s "
                    f"{r['verify_s']:.3f}" for r in report["restores"])
        + ")")
    log("report " + json.dumps(report))
    del report
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 5, 6 and 10: training (slice 2), then serving from its
    # checkpoints (slice 3) and the tiers and fleet on them (slice 12)
    # before they are removed ---------------------------------------------
    path_launches = {"checkpoint": launches}
    tierdir = os.path.join(ROOT, "build", "chip_smoke_tiers")
    shutil.rmtree(tierdir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report, saved_params, resumed = run_train_path(
            "cuda", cfg, workdir, HOST_CACHE_BYTES, flush_threads=8,
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        launches = path_launches["training"] = _launches()
        train_s = time.perf_counter() - t0
        for k in ("checksum_u32", "xor_checksum_u32", "delta_xor",
                  "quantize_checksum_int8", "dequantize_checksum_int8"):
            if launches[k] == 0:
                fail(f"kernel {k} was never launched on the training path")
        log(f"training path: {train_s:.1f} s; launches "
            f"{json.dumps(launches)}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes")
        enc = report["encode_int8"]
        log(f"training path int8: quantize_checksum_int8 "
            f"{launches['quantize_checksum_int8']} launches, "
            f"dequantize_checksum_int8 "
            f"{launches['dequantize_checksum_int8']} (resume "
            f"{report['restore']['launches']['dequantize_checksum_int8']}); "
            f"encode.int8 {enc['s_per_save']:.3f} s a save ({enc['spans']} "
            f"spans, {enc['bytes']} bytes in all); resume read_s "
            f"{report['restore']['read_s']:.3f}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes")
        log(f"training path delta encode: xor_checksum_u32 "
            f"{launches['xor_checksum_u32']} launches; encode.delta a delta "
            f"save {_encode_text(report['encode_delta'])}; persist "
            + ", ".join(f"{r['persist_s']:.3f}" for r in report["saves"])
            + f" s; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes")
        log(f"training path digest: checksum_u32 {launches['checksum_u32']} "
            f"launches (resume of step {report['restore']['step']} "
            f"{report['restore']['launches']['checksum_u32']}, verify_s "
            f"{report['restore']['verify_s']:.3f})")
        log("train report " + json.dumps(report))
        full_resume_bytes = report["restore"]["bytes_read"]
        next_loss = report["next_step"]["loss"]
        saved_steps = [r["step"] for r in report["saves"]]
        del report
        gc.collect()
        torch.cuda.empty_cache()

        # phase 6's peak device memory holds the resumed state's copies
        # (5.4 GB) that phase 10 checks against
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_serve_path("cuda", cfg, workdir, TRAIN_STEPS,
                                saved_params, full_resume_bytes,
                                batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                                n_new=SERVE_NEW)
        launches = path_launches["serving"] = report["launches"]
        serve_s = time.perf_counter() - t0
        for k in ("checksum_u32", "delta_xor", "flash_attention"):
            if launches[k] == 0:
                fail(f"kernel {k} was never launched on the serving path")
        log(f"serving path: {serve_s:.1f} s; launches "
            f"{json.dumps(launches)}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes")
        log(f"serving path digest: checksum_u32 {launches['checksum_u32']} "
            f"launches; params restore verify_s "
            f"{report['restore']['verify_s']:.3f}")
        log("serve report " + json.dumps(report))
        del report
        gc.collect()
        torch.cuda.empty_cache()

        # -- phase 10: tiers and the fleet fabric (slice 12) -------------
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_tiers_path("cuda", cfg, workdir, tierdir, saved_steps,
                                resumed, next_loss, saved_params,
                                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        launches = path_launches["tiers"] = _launches()
        tiers_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(tierdir, ignore_errors=True)
    for k in ("checksum_u32", "delta_xor", "dequantize_checksum_int8"):
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the tiers path")
    report["launches"] = launches
    log(f"tiers path: {tiers_s:.1f} s (10a {report['cascade']['s']:.1f} s, "
        f"10b {report['resume']['total_s']:.1f} s, 10c "
        f"{report['fleet']['s']:.1f} s, 10d "
        f"{report['cli']['verify_s'] + report['cli']['stats_s']:.1f} s); "
        f"launches {json.dumps(launches)}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log("tiers report " + json.dumps(report))
    del report, resumed, saved_params
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 7: the offline reduction path (slice 4) --------------------
    reduce_dir = os.path.join(ROOT, "build", "chip_smoke_reduce")
    # one layer: the run's time goes to phase 9 (PERF.md)
    reduce_cfg = get_config("llama3.2-1b", n_layers=REDUCE_LAYERS,
                            layer_groups=uniform_groups("full",
                                                        REDUCE_LAYERS))
    shutil.rmtree(reduce_dir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        report = run_reduction_path("cuda", reduce_cfg, reduce_dir)
        launches = path_launches["reduction"] = _launches()
        reduce_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(reduce_dir, ignore_errors=True)
    for k in ("checksum_u32", "downcast_bf16", "quantize_int8", "delta_xor",
              "dequantize_int8"):
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the reduction path")
    log(f"reduction path: {reduce_s:.1f} s; launches "
        f"{json.dumps(launches)}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log("reduce report " + json.dumps(report))
    del report
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 8: the four engines the paper compares (slice 10) ----------
    engines_dir = os.path.join(ROOT, "build", "chip_smoke_engines")
    shutil.rmtree(engines_dir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        rows_engines = run_engines_path(
            "cuda", cfg, engines_dir, HOST_CACHE_BYTES, flush_threads=8,
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        launches = path_launches["engines"] = _launches()
        engines_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(engines_dir, ignore_errors=True)
    if launches["checksum_u32"] == 0:
        fail("kernel checksum_u32 was never launched on the engines path")
    log(f"engines path: {engines_s:.1f} s; launches {json.dumps(launches)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(json.dumps({"engines": rows_engines, "seconds": engines_s,
                    "launches": launches}))

    # -- phase 9: multi-rank saves (slice 11) ------------------------------
    run_dist_phase(cfg, ckpt_cfg, path_launches)

    # -- phase 11: the attention-family model zoo (slice 13) --------------
    log("zoo report " + json.dumps(run_zoo_phase(path_launches)))

    # -- phase 12: the rest of the zoo (slice 14) --------------------------
    log("zoo rest report " + json.dumps(run_zoo_rest_phase(path_launches)))

    # -- phase 13: the dry run against the card (slice 15) ----------------
    log("dryrun report " + json.dumps(run_dryrun_phase(cfg, path_launches)))

    # -- phase 14: the examples (slice 16) --------------------------------
    log("examples report " + json.dumps(run_examples_phase(path_launches)))

    log(f"smoke: {time.perf_counter() - t_start:.1f} s from start to the "
        f"end of every phase (1-14; phase 10 runs after 6)")
    # launches: summed over the paths, each counted from zero
    line = {"kernels": [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k],
        "launches": sum(p[k] for p in path_launches.values()),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **{x: r[x] for x in ("tflops", "bound_share", "device_ms",
                             "library_device_ms", "chunk_ms",
                             "chunk_device_ms", "chunk_plain_ms",
                             "chunk_bound_ms", "piece64_ms",
                             "piece64_device_ms", "piece64_plain_ms",
                             "piece64_bound_ms", "stats_max_abs_err",
                             "grad_max_rel_l2") if x in r},
        **{x: v for x, v in r.items() if x.startswith(("hd128", "hd256"))}}
        for k, r in rows.items()]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()

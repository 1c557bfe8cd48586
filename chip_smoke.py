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
   phase 6's, hd 128 at phase 11a's and 12d's, hd 256 at 12a's and
   12b's) — then
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
   made on the card from a seeded generator. Two steps of the two-phase
   loop (seeded gradients on the card; ``wait_for_capture``; in-place
   AdamW; ``save``) under ``DeltaPolicy(keyframe_every=3)`` give a keyframe
   and a delta (once a second delta too, cut for the smoke's time);
   then step 2 (chain verify + XOR fold) and step 1 restore onto the card
   and must equal the saved states bit for bit.
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
   ``quant="int8"`` of the fp32 first moment (each leaf as rows of 256),
   both without the embedding table (cut for the smoke's time);
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
   10 (run right after 6), 7, 8, 9a, 9b, 11a, 11b, 12a, 12b, 12c, each
   case of 12d and 12e, 13 and 14
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
   JSON line. (d) llama4-maverick-400b-a17b at full width cut to its
   first two layers (``chunked``, ``chunked_moe``: chunks of 8,192, 40/8
   heads at hd 128, top-1 of 128 experts with the shared expert, an
   untied head of 202,048 columns; 18.55 G params, 37.1 GB, seeded on
   the card): ``greedy_generate`` of 2 x 8,448 tokens for 32 twice (the
   same tokens; ``{128/chunked: 2}`` a prefill, none in decode), the
   steps by hand (each decode step writes chunk-ring slot ``pos % 8192``
   alone, the same tokens), the prefill's MoE layer's dispatch (at most
   one slot a token, at most C = 3 tokens an expert a group; 64 seeded
   tokens and up to 16 dropped ones within a relative L2 error of 2e-2
   of their expert computed alone in fp32 plus the shared expert), every
   layer's real q, k, v through the kernel and the plain version; then
   its one ``chunked`` layer alone: a prefill of 8,176 tokens and 32
   decode steps across position 8,192, the logits at 8,191, 8,192 and
   8,207 within a relative L2 error of 2e-2 of a forward over the same
   tokens. (e) starcoder2-7b (1 ``window`` layer, prompts of 4,352 past
   its 4,096 window) and llama2-7b (2 ``full`` layers, MHA) as (a), and
   command-r-35b (1 ``full`` layer, a tied 256,000 vocabulary) as (c).
   One ``zoo last report`` JSON line with the card's name and power
   limit.
13. The dry run against the card (slice 15), last: phase 6's prefill and
   a training step (``make_train_step``) of llama3.2-1b at full width, 2
   layers, at 2 x 4,096 tokens (past the 2,048 of the direct attention
   path, so both run the attention kernel), each traced by
   ``repro_torch.launch.dryrun`` on fake CUDA tensors on a (1, 1) mesh,
   then run for real from seeded params: a warm-up, one run under
   ``FlopCounterMode``, one under the dry run's counter recording its
   operators, and three timed with CUDA events. Fails unless the traced
   FLOPs equal the counted ones, the real step's per-kind op profile
   (each operator kind's count and result bytes) equals the trace's and
   the dry run's argument bytes equal the real arguments' bytes, all
   exactly, and the kernel launched in both steps; logs the predicted
   temp bytes beside the peak device memory beyond the arguments, the
   step time beside the dry run's bound, and one
   ``run_dryrun("gemma3-27b", "prefill_32k")`` record's trace time and
   terms. Then phase 15's ranks start spawning (after the timed steps),
   and phase 15's steps are traced on a fake (2, 2) mesh: the 2d step,
   prefill and decode step, and each of :data:`SHARD_MODES`' steps. One
   ``dryrun report`` JSON line.
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
15. Sharded model compute (slice 17), last: four ranks spawned on the one
   card (``repro_torch.launch.spmd``; spawned and set up on a thread of
   their own while phase 13's sharded traces and phase 14 run), one
   ``torch.distributed`` group over gloo (NCCL refuses two ranks on one
   GPU; the collectives' bytes move through staging buffers on the card
   that the ranks share, ``sharding/gloo_cuda.py``), as a ``(data 2, model
   2)`` ``DeviceMesh`` in ``2d`` mode. Every rank builds llama3.2-1b at
   full width, cut to 2 layers, from the seed and lays its params,
   AdamW state and a batch of 4 x 512 tokens out as ``DTensor``s; one
   sharded train step, its loss and gathered params held against the same
   step run unsharded in this process (loss within 4 and params within 2
   bf16 units of 2^-8, relative); each rank saves its shards
   (``DistPolicy(group=True)``) once blocking and once lazily beside the
   next step, the capture barrier before its in-place update; this
   process restores the lazily saved step at world 1 on the card,
   bit-exact to the gathered state; the ranks restore it elastically onto
   a ``(1, 4)`` mesh; and they prefill 2 prompts of 2,304 tokens (past
   the direct path's 2,048, so the attention kernel runs on each rank's
   local heads) from seeded serving params and decode 8 steps on the
   ``DTensor`` caches, then a ``decode_kv_seq_shard`` prefill (the slots
   over ``model``) and a long-context one (batch 1, the slots over
   ``data``) decode 4 steps each (slice 19), every step teacher-forced
   with the greedy tokens of the same decode run unsharded in this
   process: every logits within :data:`SHARD_LOGIT_RTOL` relative L2,
   every rank's first k cache as ``cache_pspecs`` lays it out. Each
   rank's step, 2d prefill and first decode step are counted by the dry
   run's counter and equal the fake (2, 2) trace in FLOPs, collectives
   and the per-kind op profile. Then gradient passes of
   recurrentgemma-2b, rwkv6-7b and dbrx-132b's MoE (slice 19; the
   unsharded pass routed as the ranks did) at full width against the
   same passes unsharded. Between the two, the other partition modes
   and sequence-parallel flags (slice 21, :data:`SHARD_MODES`):
   ``fsdp``, ``2d`` with Ulysses attention, ``2d`` with the
   sequence-parallel residual and ``tp_zero1``, each from the seeded
   state laid out again in the mode, its train step held as the 2d step
   is, counted equal to its own fake trace (traced in phase 13), a
   prefill of 2 x 2,304 tokens against the same prefill unsharded (but
   ``tp_zero1``, which prefills its decode); Ulysses' collectives must
   hold all-to-alls, the sequence-parallel residual's more
   reduce-scatters than the 2d step's; ``tp_zero1``'s state saved
   lazily, restored at world 1 and onto the 2d layout bit-exactly, its
   prefill and 4 decode steps against the unsharded decode. Fails unless
   every rank launched ``flash_attention`` (in every mode) and
   ``checksum_u32``; one rank's local attention is held against its
   plain version. One ``sharded
   report`` JSON line (step time, save stall and persist, bytes by rank,
   restore times, the decode cases, the modes, the zoo passes, launches
   by rank) and one ``sharded modes`` line.
16. Report: a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
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
#: the checkpoint phase's saves (K, delta; once K, delta, delta, cut for
#: the smoke's time: each delta save took about 32 s of phase 4's 119.5 s
#: and of 9a's 127.6 s on the H100, PERF.md)
MAIN_SAVES = 2
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
#: the zoo's last configs (phases 12d and 12e), at full width cut in
#: depth. 12d: llama4-maverick at the first two layers of its pattern
#: (chunked attention with a dense FFN, then with top-1 of 128 experts
#: and the shared expert; 18.55 G params, 37.1 GB bf16), prompts of one
#: chunk and 256 tokens (so the kernel skips the tiles before a query's
#: chunk, and the decode ring starts with a 256-token partial chunk);
#: then its one ``chunked`` layer alone (4.52 GB): a prefill of
#: ``RING_PREFILL`` tokens and ``RING_STEPS`` decode steps fed the next
#: given tokens, across position 8,192 where the ring restarts, held
#: against a forward over the same tokens within ``RING_REL_L2``
#: (relative L2 error, as rwkv's tail)
LLAMA4, LLAMA4_PATTERN = "llama4-maverick-400b-a17b", ("chunked",
                                                       "chunked_moe")
LLAMA4_PROMPT = 8192 + 256
#: its attention shape, which phase 3 times: 40/8 heads, chunks of 8,192
LLAMA4_HEADS, LLAMA4_CHUNK = (40, 8), 8192
RING_PREFILL, RING_STEPS, RING_REL_L2 = 8192 - 16, 32, RWKV_TAIL_REL_L2
#: 12d's dispatch check: tokens of one prefill's MoE layer held against
#: the expert each was dispatched to, computed alone in fp32, plus the
#: shared expert (relative L2 error a token): this many seeded tokens,
#: and up to ``DISPATCH_DROPPED`` tokens that found their expert full
DISPATCH_TOKENS, DISPATCH_DROPPED, DISPATCH_REL_L2 = 64, 16, 2e-2
#: 12e: the three dense configs, one repetition of their pattern each
#: (llama2-7b two ``full`` layers), and their prompts: starcoder2's past
#: its 4,096 window, so the kernel's window mask skips tiles and the
#: decode ring wraps
ZOO12E_PATTERNS = {"starcoder2-7b": ("window",),
                   "llama2-7b": ("full", "full"),
                   "command-r-35b": ("full",)}
ZOO12E_PROMPTS = {"starcoder2-7b": 4096 + 256, "llama2-7b": SERVE_PROMPT,
                  "command-r-35b": SERVE_PROMPT}
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
#: the state subtree the reducers leave out, cut for the
#: smoke's time: the (128,256 x 2,048) embedding table, 1.05 GB of the
#: 1.29 GB fp32 master (and first moment) at one layer, whose keyframe
#: took most of phase 7's 126-153 s; every other leaf is reduced at its
#: full width, through the same folds and kernels
REDUCE_SKIP = "embed"
#: the examples phase: ``train_100m``'s flags and the steps
#: ``engine_comparison.run_engine`` takes for each engine, both cut from
#: 6 and 2 for the smoke's time (5 steps is the least that saves once
#: before ``train_100m``'s crash at two thirds; PERF.md, phase 14)
EXAMPLES_TRAIN_100M = ("--fast", "--steps", "5", "--ckpt-interval", "3")
EXAMPLES_ENGINE_STEPS = 1
#: the sharded phase (slice 17): the mesh of ranks on the one card, the
#: train step's batch rows and tokens (4 x 512: the direct
#: attention path), the gradient pass's and the sharded prefill's rows
#: and tokens (past the 2,048 of the direct path, so the kernel runs on
#: the local heads, under grad with its backward there too), the ranks'
#: pinned caches each
SHARD_DIMS, SHARD_AXES = (2, 2), ("data", "model")
SHARD_ELASTIC_DIMS = (1, 4)
SHARD_BATCH, SHARD_SEQ = 4, 512
#: the most a rank's counted step or prefill FLOPs may be over a world-th
#: of the same step counted unsharded
SHARD_WORK_MAX = 1.10
SHARD_GRAD_BATCH, SHARD_GRAD_SEQ = 2, 2304
SHARD_PREFILL_BATCH, SHARD_PREFILL_SEQ = 2, 2304
#: the decode headroom of the sharded prefill's caches
SHARD_DECODE_LEN = 16
SHARD_CACHE_BYTES = 2 << 30
#: phase 15's sharded decode (slice 19), from seeded params: the 2d
#: prefill's caches decoded this many steps (8 until slice 21, cut for the
#: smoke's time), then a ``decode_kv_seq_shard``
#: prefill (batch 2) and a long-context one (batch 1, the ``seq`` axis on
#: ``data``) of the same length decoded this many steps each, every step
#: teacher-forced with the unsharded decode's greedy tokens. The kv
#: case's cache holds the prompt and its headroom up to a multiple of
#: this many slots: the reference shards the slots over ``model`` only
#: then (``T % 128 == 0``)
SHARD_DECODE_STEPS, SHARD_CASE_STEPS = 4, 4
SHARD_KV_ALIGN = 128
#: phase 15's other partition modes and sequence-parallel flags (slice
#: 21), after the 2d cases: name -> config overrides. Each lays the
#: seeded state out again in its mode and runs the train step, held
#: against the same unsharded step. ``tp_zero1``, the paper's layout,
#: also saves beside its next step, restores at world 1 and onto the 2d
#: layout, and prefills and decodes :data:`SHARD_CASE_STEPS` steps
#: from the serving params; every other mode prefills the gradient
#: pass's 2 x 2,304 tokens from the seeded params before its step (the
#: kernel on the local heads), against the same prefill unsharded.
#: ``tp_zero1`` runs last, so its save persists beside its own decode,
#: not beside another mode's timed step
SHARD_MODES = {"fsdp": {"sharding_mode": "fsdp"},
               "ulysses": {"ulysses_attention": True},
               "seq_parallel": {"seq_parallel_residual": True},
               "tp_zero1": {"sharding_mode": "tp_zero1"}}
#: phase 15's gradient passes of the rest of the zoo (slice 18; dbrx's
#: MoE since slice 19), at full width on the ranks against the same pass
#: unsharded in this process: the configs cut to one repetition of their
#: pattern, at this many rows and tokens; the MoE at 2 x 256 tokens, two
#: of dbrx's 256-token groups, so its groups split over ``data`` (at 2 x
#: 128 the one group is whole on every rank)
SHARD_ZOO_PATTERNS = {"recurrentgemma-2b": ("rec", "rec", "window"),
                      "rwkv6-7b": ("rwkv",), "dbrx-132b": ("full_moe",)}
SHARD_ZOO_BATCH, SHARD_ZOO_SEQ = 2, 128
SHARD_MOE_BATCH, SHARD_MOE_SEQ = 2, 256
#: bf16's unit roundoff: the sharded step adds its partial sums in other
#: orders than the unsharded one, so its loss and the gradients' global
#: norm lie within a few units, each bf16 param within one unit (a
#: last-bit flip of the cast), and the gradients, after a chain of bf16
#: roundings, within five (2e-2, the model tests' bound) over the tree
BF16_U = 2.0 ** -8
SHARD_LOSS_RTOL, SHARD_PARAM_RTOL = 4 * BF16_U, 2 * BF16_U
SHARD_GRAD_RTOL = 5 * BF16_U
#: the sharded decode's logits (prefill's last and each step's) against
#: the unsharded decode's, by relative L2 error: bf16 logits after two
#: layers whose partial sums and softmax add in other orders lie within
#: a few units (1.1e-2 at the smoke config on the CPU, whose bf16
#: products round more often than the card's); a wrong slot, mask or
#: softmax reads O(1)
SHARD_LOGIT_RTOL = 8 * BF16_U
#: the update the step applied (the fp32 master after less before)
#: against the unsharded one's. AdamW's first step moves each element
#: by ``lr`` times the sign of its gradient (``|g| >> eps``), so an
#: element whose gradient lies within the rounding noise of zero flips:
#: a share f of flips reads 2 sqrt(f). A step that leaves the params as
#: they were reads 1; the limit lies between
SHARD_UPDATE_RTOL = 0.5
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
                   itemsize: int, window: int = 0, n_prefix: int = 0,
                   kind: str = None, chunk: int = 0) -> tuple:
    """(bound ms, bound_by) of causal attention under the ``kind`` mask
    (``full``, or ``window`` where ``window`` is set) with its window or
    chunk: its FLOP (``flash_attention.flash_flop``, the attention
    operator's FLOP formula) against the bf16 tensor-core peak; q, k, v
    read once and the output written once against the memory rate."""
    from repro_torch.kernels.flash_attention import flash_flop
    flop = flash_flop(B, S, H, hd, window, n_prefix, kind=kind, chunk=chunk)
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
    SDPA at the same shape beside it), and at 12d's (B 2, S 8,448, 40/8
    heads, hd 128, ``chunked`` 8,192: SDPA with the boolean chunk mask,
    and causal SDPA)."""
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

    def timed(S, H, KV, hd, window, n_prefix=0, kind=None, chunk=0,
              reps=50):
        """Times at (B, S, H/KV, hd, bf16, causal, ``window`` or ``kind``
        with its chunk, with the prefix), after the kernel's output there
        is held against the plain version's; beside a masked SDPA, causal
        SDPA too."""
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        k = torch.randn(B, S, KV, hd, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        v = torch.randn(B, S, KV, hd, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        kind = kind or ("window" if window else "full")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        causal = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                              enable_gqa=True)
        lib = causal
        if kind != "full" or n_prefix:
            mask = fa.allowed(torch.arange(S, device="cuda"),
                              torch.arange(S, device="cuda"), kind, window,
                              chunk, n_prefix)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                               enable_gqa=True)
        kern = lambda: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, kind=kind, window=window, chunk=chunk,
            n_prefix=n_prefix)
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q, k, v, kind=kind, window=window, chunk=chunk,
            n_prefix=n_prefix)
        err = _flash_err(kern(), plain(), FLASH_TOL["bfloat16"])
        if not math.isfinite(err):
            fail(f"flash_attention disagrees with its plain version at B "
                 f"{B} S {S} heads {H}/{KV} hd {hd} bf16 {kind} (window "
                 f"{window}, chunk {chunk}, n_prefix {n_prefix})")
        ms, library_ms = _time_turns(kern, lib, reps)
        plain_ms = _time_ms(plain, max(1, reps // 10))
        bound_ms, bound_by = flash_bound_ms(B, S, H, KV, hd, 2, window,
                                            n_prefix, kind, chunk)
        flop = fa.flash_flop(B, S, H, hd, window, n_prefix, kind=kind,
                             chunk=chunk)
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flop / (ms * 1e-3) / 1e12,
               "bound_share": bound_ms / ms, "max_abs_err": err}
        if n_prefix or kind == "chunked":
            _ms, row["library_causal_ms"] = _time_turns(kern, causal, reps)
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
    # 12d's attention shape: llama4-maverick's chunked layers at one chunk
    # and 256 tokens (GQA 40/8; the kernel skips the tiles before a
    # query's chunk)
    r = timed(LLAMA4_PROMPT, *LLAMA4_HEADS, 128, 0, kind="chunked",
              chunk=LLAMA4_CHUNK, reps=10)
    worst = max(worst, r["max_abs_err"])
    row.update({f"hd128_chunked{LLAMA4_CHUNK}_{k}": r[k] for k in r})
    log(f"kernel flash_attention at B {B} S {LLAMA4_PROMPT} heads "
        f"{LLAMA4_HEADS[0]}/{LLAMA4_HEADS[1]} hd 128 bf16 chunked "
        f"{LLAMA4_CHUNK}: within {FLASH_TOL['bfloat16']} of the plain "
        f"version (max |diff| {r['max_abs_err']:.3g}); {r['ms']:.4f} ms, "
        f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the bound "
        f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}, scaled_dot_product_attention with the chunk "
        f"mask {r['library_ms']:.4f} ms, causal SDPA at that shape "
        f"{r['library_causal_ms']:.4f} ms)")
    log(f"kernel flash_attention: within {FLASH_TOL} of its plain version "
        f"at (S, T) {FLASH_SEQS} and {SERVE_PROMPT}, heads {FLASH_HEADS}, "
        f"hd {FLASH_HDS}, masks {FLASH_KINDS}, fp32 and bf16, with a prefix "
        f"of {FLASH_PREFIX} at (S, T) {FLASH_PREFIX_SEQS}, and at B {B} "
        f"S {S} 32/16 hd 128 causal and window {ZOO_WINDOW}, hd 256 10/1 "
        f"window {ZOO12A_WINDOW} and 8/1 prefix {FLASH_PREFIX}, S "
        f"{LLAMA4_PROMPT} {LLAMA4_HEADS[0]}/{LLAMA4_HEADS[1]} hd 128 chunked "
        f"{LLAMA4_CHUNK} (max |diff| "
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


def _rss_bytes() -> int:
    """This process's resident set (its pinned host memory included)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _release_pinned() -> None:
    """Hand back the pinned host blocks that PyTorch's host allocator
    keeps for reuse once they are free (this process's earlier phases'
    staging), before phase 15's four ranks share the host."""
    import torch
    torch.cuda.synchronize()
    torch._C._host_emptyCache()


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
    """:data:`MAIN_SAVES` steps of the two-phase loop with saves K, delta;
    then restore the last step and step 1 onto ``device`` and compare
    bit for bit. The
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
            for step in range(1, MAIN_SAVES + 1):
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
        for step, want in ((MAIN_SAVES, _tensors(state(MAIN_SAVES))),
                           (1, step1)):
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
        for s in range(1, MAIN_SAVES + 1):
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
    def subtree(tree):
        return {k: v for k, v in tree.items() if k != REDUCE_SKIP}

    views = {"bf16": lambda: map_leaves(_fold_2d, subtree(opt["master"])),
             "int8": lambda: map_leaves(_rows_256, subtree(opt["m"]))}
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


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _greedy_twice(cfg, params, prompt, n_new: int, device: str,
                  what: str) -> tuple:
    """``greedy_generate`` of ``prompt`` for ``n_new`` tokens twice: the
    same tokens, all inside the vocabulary, each prefill launching the
    kernel once an attention layer by its mask and the prefix
    (:func:`_prefill_launches`; on the card) and no decode step launching
    it. Returns ``(tokens, [seconds of each run], launches by kind)``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import engine
    want = _prefill_launches(cfg) if device == "cuda" else {}
    runs = []
    for _ in range(2):
        before = collections.Counter(fa.LAUNCHES_BY)
        t0 = time.perf_counter()
        out = engine.greedy_generate(cfg, params, prompt, n_new)
        _sync(device)
        runs.append((out, time.perf_counter() - t0, _flash_by_kind(before)))
    (out, _s, by_kind), (out2, _s2, by_kind2) = runs
    if out.shape != (prompt["tokens"].shape[0], n_new) \
            or bool(((out < 0) | (out >= cfg.vocab)).any()):
        fail(f"{what} ({cfg.name}): greedy_generate gave "
             f"{tuple(out.shape)} with tokens outside the vocabulary")
    if not torch.equal(out, out2):
        fail(f"{what} ({cfg.name}): greedy_generate gave other tokens the "
             f"second time")
    if by_kind != want or by_kind2 != want:
        fail(f"{what} ({cfg.name}): a greedy_generate launched the "
             f"attention kernel {by_kind} / {by_kind2}, not {want} (once a "
             f"layer in the prefill, by the layer's mask; none in decode)")
    return out, [r[1] for r in runs], by_kind


def _ring_len(cfg, btype: str) -> int:
    """The slots of a ``window`` (the window) or ``chunked`` (the chunk)
    layer's decode ring; 0 for a layer without one."""
    from repro_torch.models import model as M
    if btype not in M.ATTN_TYPES:
        return 0
    return {"window": cfg.window, "chunked": cfg.chunk}.get(
        M.attn_kind(btype), 0)


def _steps_by_hand(cfg, params, prompt, prompt_len: int, n_new: int,
                   device: str, want, what: str,
                   prefill_ctx=contextlib.nullcontext) -> dict:
    """The prefill (under ``prefill_ctx()``), then ``n_new`` greedy decode
    steps by hand: every step must write slot ``pos % T`` of each ring (a
    ``window`` layer's of T = the window slots, a ``chunked`` layer's of T
    = the chunk, which restarts at each chunk) and nothing else of it,
    and shift every ``rec`` layer's ``conv`` by one input; the tokens
    must equal ``want`` (``greedy_generate``'s). Returns the prefill
    step, its seconds, the decode's seconds in all, the tokens fed to
    each step, the ring slots written, the steps whose slot lay below
    their position (past a ring's first wrap or restart), the rings and
    the ``rec`` caches after the steps."""
    import torch
    from repro_torch.serving import engine
    cfg_n = dataclasses.replace(cfg, max_decode_len=n_new)
    prefill = engine.make_prefill_step(cfg_n)
    decode = engine.make_decode_step(cfg_n)
    t0 = time.perf_counter()
    with prefill_ctx():
        logits, caches = prefill(params, prompt)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    blocks = [(b, c) for (pattern, _n), group in zip(cfg.layer_groups, caches)
              for b, c in zip(pattern, group)]
    rings = [(c, _ring_len(cfg, b)) for b, c in blocks if _ring_len(cfg, b)]
    recs = [c for b, c in blocks if b == "rec"]
    toks, slots, decode_s, wraps = [], [], 0.0, 0
    for i in range(n_new):
        pos = prompt_len + cfg.n_prefix_embeds + i
        toks.append(torch.argmax(logits[:, -1].float(), -1)
                    .to(torch.int32)[:, None])
        before = [(c["k"].clone(), c["v"].clone()) for c, _T in rings]
        rec_before = [c["conv"].clone() for c in recs]
        t0 = time.perf_counter()
        logits, caches = decode(params, toks[-1], caches, pos)
        _sync(device)
        decode_s += time.perf_counter() - t0
        slot = {pos % T for _c, T in rings}
        slots.append(sorted(slot))
        wraps += bool(rings) and max(slot) < pos
        for (c, T), (k0, v0) in zip(rings, before):
            for new, old in ((c["k"], k0), (c["v"], v0)):
                changed = (new != old).flatten(3).any(-1).any(0).any(0)
                if changed.nonzero().flatten().tolist() != [pos % T]:
                    fail(f"{what} ({cfg.name}): decode at position {pos} "
                         f"changed ring slots "
                         f"{changed.nonzero().flatten().tolist()}, not "
                         f"[{pos % T}] of {T}")
        for c, conv0 in zip(recs, rec_before):
            # the convolution's window of the last W - 1 inputs shifts by
            # one (a repeated token may leave h and the values as they
            # were: greedy decoding can settle on one token)
            shifted = (c["conv"][:, :, :-1] == conv0[:, :, 1:]) \
                .flatten(1).all(-1)
            if not bool(shifted.all()):
                fail(f"{what} ({cfg.name}): decode at position {pos}: rec "
                     f"layers' conv shifted by one {shifted.tolist()}")
    del logits
    if not torch.equal(torch.cat(toks, 1), want):
        fail(f"{what} ({cfg.name}): the prefill and decode steps gave "
             f"other tokens than greedy_generate")
    return {"prefill": prefill, "prefill_s": prefill_s, "decode_s": decode_s,
            "toks": toks, "slots": slots, "wraps": wraps,
            "rings": [c for c, _T in rings], "recs": recs}


def run_zoo_serve_path(device: str, cfg, workdir: str, batch: int,
                       prompt_len: int, n_new: int) -> dict:
    """11a, 12a, 12b and 12e: ``cfg`` (gemma3-27b: window and full
    blocks; recurrentgemma-2b: RG-LRU and window blocks; paligemma-3b:
    the prefix-LM; starcoder2-7b: a window layer with biases, layernorm
    and ``gelu_mlp``; llama2-7b: full MHA layers) served from a
    checkpoint. Params made on ``device`` from a
    seeded generator are saved once as ``{"model": params}`` (datastates
    engine, raw policy) and restored by ``load_params_for_serving``, bit
    for bit; then ``greedy_generate`` runs ``batch`` seeded prompts of
    ``prompt_len`` tokens (after the config's patch prefix, where it has
    one) for ``n_new`` tokens twice (the same tokens), each prefill
    launching the kernel once an attention layer with the layer's mask
    and the prefix at ``cfg.hd`` and no decode step launching it
    (:func:`_greedy_twice`); then the steps again by hand
    (:func:`_steps_by_hand`: each decode step writes one slot of each
    ring), and the ``rec`` layers' state after them must match a prefill
    over the same tokens (:func:`_rec_state_errs`)."""
    import torch
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  EnginePolicy)
    from repro_torch.core import dtypes
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.models import model as M
    from repro_torch.serving import engine

    on_card = device == "cuda"
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
    _sync(device)
    restore_s = time.perf_counter() - t0
    del template
    _assert_equal(params, saved, "zoo serving: restore")
    del saved
    gc.collect()

    prompt = _zoo_prompt(cfg, device, batch, prompt_len)
    out, runs, by_kind = _greedy_twice(cfg, params, prompt, n_new, device,
                                       "zoo serving")
    hand = _steps_by_hand(cfg, params, prompt, prompt_len, n_new, device,
                          out, "zoo serving")
    prefill, recs = hand["prefill"], hand["recs"]
    prefill_s, wraps = hand["prefill_s"], hand["wraps"]
    rec_errs = _rec_state_errs(cfg, prefill, params, prompt, hand["toks"],
                               recs) if recs else []
    peak = torch.cuda.max_memory_allocated() if on_card else None
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
        "decode_s_per_token": hand["decode_s"] / n_new,
        "generate_s": runs, "flash_by_kind": by_kind,
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
           f"slot pos % {cfg.window} alone; " if hand["rings"] else "")
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
    mask (its window or chunk) and the prefix. Returns each layer's
    largest difference."""
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
    masks = [(kw["kind"], kw["window"], kw["chunk"], kw["n_prefix"])
             for *_qkv, kw, _g in seen]
    if masks != [(b, cfg.window, cfg.chunk, cfg.n_prefix_embeds)
                 for b in kinds]:
        fail(f"zoo ({cfg.name}): the prefill launched the attention kernel "
             f"with (mask, window, chunk, prefix) {masks}, not the layers' "
             f"{kinds} at window {cfg.window}, chunk {cfg.chunk}, prefix "
             f"{cfg.n_prefix_embeds}")
    errs = []
    for i, (q, k, v, kw, got) in enumerate(seen):
        with torch.no_grad():
            want = fa.flash_attention_plain(
                q, k, v, kv_block=cfg.attn_kv_block, **kw)
        torch.cuda.synchronize()
        err = _flash_err(got, want, FLASH_TOL["bfloat16"])
        if not math.isfinite(err):
            fail(f"zoo ({cfg.name}): flash_attention disagrees with its "
                 f"plain version on layer {i}'s q/k/v {tuple(q.shape)}/"
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
    launching the kernel once a layer with stats and nothing else, and
    once more a layer under ``cfg.remat`` (the recompute in the
    backward pass)."""
    from repro_torch.kernels import flash_attention as fa
    before = collections.Counter(fa.LAUNCHES_BY)
    t0 = time.perf_counter()
    row, _copies = _engine_mode("datastates", device, cfg, workdir,
                                HOST_CACHE_BYTES, 8, batch, seq_len, None)
    by_kind = _flash_by_kind(before)
    steps = ENGINE_STEPS + 1     # three, then one after the resume
    runs = 2 if cfg.remat else 1
    want = {f"{cfg.hd}/full/stats": steps * cfg.n_layers * runs} \
        if device == "cuda" else {}
    if by_kind != want:
        fail(f"zoo training: the attention kernel ran {by_kind} over "
             f"{steps} steps, not {want} ({runs} a layer and step, with "
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
                          n_new: int, what: str = "zoo generation",
                          by_hand=None) -> dict:
    """12c, 12d (through :func:`run_llama4_path`) and 12e: ``cfg``
    (dbrx-132b: MoE; rwkv6-7b: RWKV6; llama4-maverick; command-r-35b: a
    ``full`` layer at d_model 8,192 with a tied 256,000 vocabulary) from
    params made on ``device`` from a seeded generator, without a save
    (their checkpoints cross between the packages in the CPU tests):
    ``greedy_generate`` of ``batch`` seeded prompts of ``prompt_len``
    tokens for ``n_new`` twice (:func:`_greedy_twice`), then one prefill
    timed alone, or instead ``by_hand(params, prompt, tokens)``, which
    returns ``(prefill step, its seconds, report fields, log text)``;
    then on the card every attention layer's real q, k, v through the
    kernel against the plain version (:func:`_zoo_layer_flash_errs`). A
    config with ``rwkv`` blocks also decodes on from a prefill of
    ``prompt_len - RWKV_TAIL`` tokens, fed the next given tokens, to last
    logits within :data:`RWKV_TAIL_REL_L2` (relative L2 error) of a
    forward over all ``prompt_len``."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import engine

    on_card = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device)
    _sync(device)
    init_s = time.perf_counter() - t0
    prompt = _zoo_prompt(cfg, device, batch, prompt_len)
    out, runs, by_kind = _greedy_twice(cfg, params, prompt, n_new, device,
                                       what)
    if by_hand is None:
        prefill = engine.make_prefill_step(cfg)
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompt)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        del logits, caches
        fields, said = {}, ""
    else:
        prefill, prefill_s, fields, said = by_hand(params, prompt, out)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    layer_errs = _zoo_layer_flash_errs(cfg, prefill, params, prompt) \
        if on_card else []
    report = {"config": cfg.name, "layers": cfg.n_layers,
              "pattern": [list(p) for p, _n in cfg.layer_groups],
              "hd": cfg.hd, "heads": [cfg.n_heads, cfg.n_kv_heads],
              "params": _n_params(cfg), "init_s": init_s,
              "prefill_s": prefill_s, "generate_s": runs,
              "flash_by_kind": by_kind, "layer_max_abs_err": layer_errs,
              "tokens": out.cpu().tolist(), **fields}
    if on_card:
        report["max_memory_allocated_generate"] = peak
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
        _sync(device)
        err = _rel_l2(logits[:, -1], whole)
        if not err < RWKV_TAIL_REL_L2:
            fail(f"{what} ({cfg.name}): a prefill of {cut} tokens "
                 f"and {RWKV_TAIL} decode steps gave last logits at a "
                 f"relative L2 error of {err!r} from a forward over "
                 f"{prompt_len} (limit {RWKV_TAIL_REL_L2})")
        report.update(tail_rel_l2=err, tail_s=time.perf_counter() - t0)
        said += (f"; a prefill of {cut} tokens and {RWKV_TAIL} decode steps "
                 f"within a relative L2 error of {err:.3g} of the "
                 f"{prompt_len}-token forward")
        del whole, logits, caches
    log(f"{what} ({cfg.name}, {cfg.n_layers} layers {report['pattern']}, "
        f"{report['params']} params, seeded on {device} in {init_s:.2f} s): "
        f"greedy_generate of {batch} x {prompt_len} for {n_new} tokens "
        f"{', '.join(f'{r:.2f}' for r in runs)} s, the same tokens twice; "
        f"kernel launches a prefill {by_kind}; prefill {prefill_s:.3f} s"
        f"{said}; every attention layer's real q/k/v through the kernel "
        f"within {FLASH_TOL['bfloat16']} of the plain version (max |diff| "
        f"by layer {layer_errs})")
    del params
    return report


def run_zoo_rest_phase(path_launches: dict) -> dict:
    """Phase 12 on the card, the rest of the zoo at full width: 12a
    recurrentgemma-2b and 12b paligemma-3b served from a checkpoint
    (:func:`run_zoo_serve_path`), 12c dbrx-132b and rwkv6-7b generating
    from seeded params (:func:`run_zoo_generate_path`); each part with
    the launch counts zeroed just before and read into ``path_launches``
    just after."""
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")

    def cfg(name):
        pattern = ZOO12_PATTERNS[name]
        return _zoo_cfg(name, len(pattern), pattern)

    def generate():
        return {name: run_zoo_generate_path("cuda", cfg(name), SERVE_BATCH,
                                            SERVE_PROMPT, SERVE_NEW)
                for name in ("dbrx-132b", "rwkv6-7b")}
    report = _run_zoo_cases((
        ("recurrent", lambda: run_zoo_serve_path(
            "cuda", cfg("recurrentgemma-2b"), os.path.join(zoo_dir, "rec"),
            SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)),
        ("prefix_lm", lambda: run_zoo_serve_path(
            "cuda", cfg("paligemma-3b"), os.path.join(zoo_dir, "vlm"),
            SERVE_BATCH, SERVE_PROMPT - FLASH_PREFIX, SERVE_NEW)),
        ("generate", generate)), path_launches,
        (("recurrent", "checksum_u32"), ("recurrent", "flash_attention"),
         ("prefix_lm", "checksum_u32"), ("prefix_lm", "flash_attention"),
         ("generate", "flash_attention")))
    log(f"zoo path, the rest: 12a {report['recurrent']['phase_s']:.1f} s, "
        f"12b {report['prefix_lm']['phase_s']:.1f} s, 12c "
        f"{report['generate']['phase_s']:.1f} s")
    return report


def _run_zoo_cases(cases: tuple, path_launches: dict,
                   need: tuple) -> dict:
    """Each ``(key, run)`` of ``cases`` on the card under
    ``build/chip_smoke_zoo/`` (removed before and after it): the launch
    counts zeroed and the peak device memory reset just before, the
    counts read into ``path_launches["zoo_<key>"]`` just after, the
    allocator's cache emptied between cases. Fails unless each ``(key,
    kernel)`` of ``need`` launched. Returns each case's report with its
    ``launches``, ``phase_s`` and ``max_memory_allocated``."""
    import torch
    report = {}
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")
    for key, run in cases:
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
    for key, k in need:
        if report[key]["launches"][k] == 0:
            fail(f"kernel {k} was never launched on the zoo {key} path")
    return report


def run_zoo_phase(path_launches: dict) -> dict:
    """Phase 11 on the card: 11a and 11b, each with the launch counts
    zeroed just before and read into ``path_launches`` just after."""
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")
    report = _run_zoo_cases((
        ("serving", lambda: run_zoo_serve_path(
            "cuda", _zoo_cfg("gemma3-27b", len(ZOO_SERVE_PATTERN),
                             ZOO_SERVE_PATTERN),
            os.path.join(zoo_dir, "serve"), SERVE_BATCH, SERVE_PROMPT,
            SERVE_NEW)),
        ("training", lambda: run_zoo_train_path(
            "cuda", _zoo_cfg("musicgen-medium", ZOO_TRAIN_LAYERS,
                             ("xattn",)),
            os.path.join(zoo_dir, "train"), ZOO_TRAIN_BATCH,
            ZOO_TRAIN_SEQ))), path_launches,
        (("serving", "checksum_u32"), ("serving", "flash_attention"),
         ("training", "checksum_u32"), ("training", "flash_attention")))
    log(f"zoo path: 11a {report['serving']['phase_s']:.1f} s, 11b "
        f"{report['training']['phase_s']:.1f} s")
    return report


@contextlib.contextmanager
def _recording_moe(seen: list):
    """Record every MoE layer's call while in the block: ``route``'s
    dispatch and combine (G, S, E, C) and ``apply_moe``'s params, input
    and output (the shared expert's included), a dict a call appended to
    ``seen``."""
    from repro_torch.models import moe
    apply, route = moe.apply_moe, moe.route

    def recording_route(cfg, p, xg, topk_idx=None):
        got = route(cfg, p, xg, topk_idx)
        seen.append({"disp": got[0], "comb": got[1]})
        return got

    def recording_apply(cfg, p, x):
        out, aux = apply(cfg, p, x)
        seen[-1].update(p=p, x=x, out=out)
        return out, aux
    moe.route, moe.apply_moe = recording_route, recording_apply
    try:
        yield seen
    finally:
        moe.route, moe.apply_moe = route, apply


def dispatch_check(cfg, rec: dict) -> dict:
    """12d's dispatch check of one MoE layer's call recorded by
    :func:`_recording_moe`. ``route``'s dispatch must give each token at
    most ``top_k`` slots, each (expert, slot) at most one token, and so
    no expert more than ``C = moe.capacity`` tokens in any group. For
    :data:`DISPATCH_TOKENS` seeded tokens and up to
    :data:`DISPATCH_DROPPED` tokens that found their experts full, the
    layer's output must lie within
    :data:`DISPATCH_REL_L2` (relative L2 error, a token) of the experts
    the token was dispatched to, each gated FFN computed alone in fp32
    and weighed by its combine value, plus the shared expert's: a
    dropped token's output is the shared expert's alone. Returns the
    measures, with ``problems``, the list of what failed."""
    import torch
    from repro_torch.models import layers, moe
    disp, comb, p, x, out = (rec[k] for k in ("disp", "comb", "p", "x",
                                              "out"))
    G, S, E, C = disp.shape
    d = x.shape[-1]
    problems = []
    per_token = disp.sum((2, 3)).flatten()
    if C != moe.capacity(cfg, S):
        problems.append(f"capacity {C}, not {moe.capacity(cfg, S)}")
    if bool((per_token > cfg.top_k).any()):
        problems.append(f"a token took {int(per_token.max())} slots, more "
                        f"than top {cfg.top_k}")
    if bool((disp.sum(1) > 1).any()):
        problems.append("an expert's slot took more than one token")
    if bool((disp.sum((1, 3)) > C).any()):
        problems.append(f"an expert took more than {C} tokens in a group")
    kept = per_token > 0
    dropped = (~kept).nonzero().flatten()
    gen = torch.Generator().manual_seed(SEED + 15)
    picked = torch.cat([
        torch.randperm(G * S, generator=gen)[:DISPATCH_TOKENS]
        .to(disp.device), dropped[:DISPATCH_DROPPED]]).unique()
    xs = x.reshape(G * S, d)[picked].float()[:, None]          # (n, 1, d)
    want = torch.zeros_like(xs)
    if cfg.shared_expert:
        shared = {k: v.float() for k, v in p["shared"].items()}
        want = layers.apply_ffn(cfg, shared, xs)
        del shared
    gates = comb.reshape(G * S, E, C)[picked].sum(-1)           # (n, E)
    rows, experts = disp.reshape(G * S, E, C)[picked].sum(-1) \
        .nonzero(as_tuple=True)
    for e in experts.unique().tolist():
        sel = rows[experts == e]
        w = {k: p[k][e].float() for k in ("w_gate", "w_up", "w_down")}
        want[sel] += gates[sel, e][:, None, None] \
            * layers.apply_ffn(cfg, w, xs[sel])
        del w
    got = out.reshape(G * S, d)[picked].float()
    errs = (got - want[:, 0]).norm(dim=-1) / want[:, 0].norm(dim=-1)
    errs = torch.where(torch.isfinite(got).all(-1), errs, math.inf)
    was_kept = kept[picked]
    worst = {"kept": float(errs[was_kept].max()) if bool(was_kept.any())
             else None,
             "dropped": float(errs[~was_kept].max())
             if bool((~was_kept).any()) else None}
    for what, e in worst.items():
        if e is not None and not e < DISPATCH_REL_L2:
            problems.append(f"a {what} token's output stands at a relative "
                            f"L2 error of {e!r} from its experts computed "
                            f"alone (limit {DISPATCH_REL_L2})")
    return {"groups": G, "group_tokens": S, "experts": E, "capacity": C,
            "tokens": G * S, "dropped": int(dropped.numel()),
            "dropped_share": float(dropped.numel()) / (G * S),
            "checked": int(picked.numel()),
            "checked_dropped": int((~was_kept).sum()),
            "kept_rel_l2_max": worst["kept"],
            "dropped_rel_l2_max": worst["dropped"], "problems": problems}


def _weight_bytes(cfg) -> tuple:
    """``(expert bytes, decode bytes, all bytes)`` of ``cfg``'s params: the
    routed experts' weights, which a decode step's capacity dispatch
    reads whole (every expert's slots, empty or not); every weight a
    decode step reads (all but the embedding table, of which it reads two
    rows; a tied table is the head, read whole); and all of them."""
    from repro_torch.core import dtypes
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.models import model as M
    expert = decode = total = 0
    for path, spec in flatten_with_path(M.param_shapes(cfg))[0]:
        names = [str(k) for k in path]
        n = math.prod(spec.shape) * dtypes.lookup(spec.dtype).torch.itemsize
        total += n
        if names[-2:] == ["embed", "embed"] and not cfg.tie_embeddings:
            continue
        decode += n
        if "moe" in names and "shared" not in names \
                and names[-1] in ("w_gate", "w_up", "w_down"):
            expert += n
    return expert, decode, total


def run_llama4_path(device: str, cfg, batch: int, prompt_len: int,
                    n_new: int) -> dict:
    """12d: ``cfg`` (llama4-maverick: ``chunked`` attention, top-1 of 128
    experts with the shared expert, an untied head) through
    :func:`run_zoo_generate_path`, with the steps by hand
    (:func:`_steps_by_hand`: each decode step writes slot ``pos % chunk``
    of each chunk ring alone) in place of its timed prefill, the
    prefill's MoE layers recorded and the first held by
    :func:`dispatch_check`. Reports the decode's time a token beside its
    byte bound: the expert weights each step reads."""
    what = "zoo llama4"

    def by_hand(params, prompt, out):
        seen = []
        hand = _steps_by_hand(cfg, params, prompt, prompt_len, n_new, device,
                              out, what, lambda: _recording_moe(seen))
        if not seen:
            fail(f"{what}: the prefill ran no MoE layer")
        dispatch = dispatch_check(cfg, seen[0])
        if dispatch["problems"]:
            fail(f"{what}: dispatch at {cfg.n_experts} experts: "
                 f"{dispatch['problems']}")
        expert_bytes, weight_bytes, all_bytes = _weight_bytes(cfg)
        decode_ms = hand["decode_s"] / n_new * 1e3
        fields = {
            "chunk": cfg.chunk, "bytes": all_bytes,
            "decode_ms_per_token": decode_ms,
            "decode_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_weights_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
            "expert_bytes": expert_bytes,
            "ring_slots": [hand["slots"][0], hand["slots"][-1]],
            "dispatch": dispatch}
        said = (
            f"; {all_bytes} bytes of params; decode {decode_ms:.2f} ms a "
            f"token (bound "
            f"{fields['decode_bound_ms']:.2f} ms: {expert_bytes} bytes of "
            f"experts at {HBM_BYTES_PER_S:.3g} B/s; every weight "
            f"{fields['decode_weights_bound_ms']:.2f} ms), each step "
            f"writing chunk-ring slot pos % {cfg.chunk} alone (slots "
            f"{hand['slots'][0]}..{hand['slots'][-1]}); dispatch at "
            f"{dispatch['experts']} experts, capacity {dispatch['capacity']} "
            f"a group of {dispatch['group_tokens']} ({dispatch['groups']} "
            f"groups): {dispatch['dropped']} of {dispatch['tokens']} tokens "
            f"dropped ({dispatch['dropped_share']:.4f}); "
            f"{dispatch['checked']} tokens ({dispatch['checked_dropped']} "
            f"dropped) within relative L2 {dispatch['kept_rel_l2_max']!r} "
            f"(kept) / {dispatch['dropped_rel_l2_max']!r} (dropped) of their "
            f"experts alone plus the shared expert")
        return hand["prefill"], hand["prefill_s"], fields, said
    return run_zoo_generate_path(device, cfg, batch, prompt_len, n_new, what,
                                 by_hand)


def chunk_ring_errs(device: str, cfg, batch: int, prefill_len: int,
                    n_steps: int, decode_cfg=None) -> dict:
    """``cfg``'s params and ``batch`` x (``prefill_len + n_steps``) tokens
    seeded on ``device``; a forward over all the tokens, then a prefill of
    the first ``prefill_len`` and ``n_steps`` decode steps fed the next
    given tokens (decoded as ``decode_cfg`` where given, on the same
    params and caches). Returns ``{position: relative L2 error}`` of each
    step's logits from the forward's at that position."""
    import torch
    from repro_torch.models import model as M
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    params = M.init_params(cfg, gen, device)
    tokens = torch.randint(
        0, cfg.vocab, (batch, prefill_len + n_steps),
        generator=torch.Generator().manual_seed(SEED + 14),
        dtype=torch.int32).to(device)
    errs = {}
    with torch.no_grad():
        whole = M.forward(cfg, params, {"tokens": tokens})
        want = whole[:, prefill_len:].float()
        del whole
        _l, caches = M.forward(cfg, params,
                               {"tokens": tokens[:, :prefill_len]},
                               collect_caches=True)
        del _l
        for pos in range(prefill_len, prefill_len + n_steps):
            logits, caches = M.decode(decode_cfg or cfg, params,
                                      {"tokens": tokens[:, pos:pos + 1]},
                                      caches, pos)
            errs[pos] = _rel_l2(logits[:, -1], want[:, pos - prefill_len])
    return errs


def ring_positions(cfg, prefill_len: int, n_steps: int) -> tuple:
    """The decode positions 12d's ring check holds: the last of the
    prefill's chunk, the first of the next (where the ring restarts) and
    the last step's."""
    boundary = (prefill_len // cfg.chunk + 1) * cfg.chunk
    return boundary - 1, boundary, prefill_len + n_steps - 1


def run_chunk_ring_path(device: str, cfg, batch: int, prefill_len: int,
                        n_steps: int) -> dict:
    """12d's chunk ring: ``cfg`` cut to ``chunked`` layers alone (no MoE,
    whose capacity routes a forward's groups and a decode step's tokens
    differently) decoded across a chunk boundary
    (:func:`chunk_ring_errs`); at :func:`ring_positions` the decode's
    logits within :data:`RING_REL_L2` of the forward's, whose prefill
    runs the kernel's chunked mask (on the card: once a layer in the
    forward and once in the prefill). A ring that kept the last chunk's
    keys would attend them at the boundary."""
    from repro_torch.kernels import flash_attention as fa
    before = collections.Counter(fa.LAUNCHES_BY)
    t0 = time.perf_counter()
    errs = chunk_ring_errs(device, cfg, batch, prefill_len, n_steps)
    _sync(device)
    s = time.perf_counter() - t0
    by_kind = _flash_by_kind(before)
    want = {k: 2 * n for k, n in _prefill_launches(cfg).items()} \
        if device == "cuda" else {}
    if by_kind != want:
        fail(f"zoo chunk ring ({cfg.name}): the forward and the prefill "
             f"launched the attention kernel {by_kind}, not {want}")
    held = {p: errs[p] for p in ring_positions(cfg, prefill_len, n_steps)}
    if not prefill_len < min(held) < max(held) \
            or not all(e < RING_REL_L2 for e in held.values()):
        fail(f"zoo chunk ring ({cfg.name}): decode logits after a prefill "
             f"of {prefill_len} tokens at relative L2 errors {held} from "
             f"the forward's (limit {RING_REL_L2}; the decode must cross "
             f"a chunk boundary)")
    log(f"zoo chunk ring ({cfg.name}, {cfg.n_layers} layer "
        f"{[list(p) for p, _n in cfg.layer_groups]}, chunk {cfg.chunk}): "
        f"prefill of {batch} x {prefill_len} and {n_steps} decode steps "
        f"across position {sorted(held)[1]} in {s:.2f} s; logits at "
        f"positions {sorted(held)} within a relative L2 error of "
        f"{max(held.values()):.3g} of a {prefill_len + n_steps}-token "
        f"forward (every step {max(errs.values()):.3g}; limit "
        f"{RING_REL_L2}); kernel launches {by_kind}")
    return {"config": cfg.name, "layers": cfg.n_layers, "chunk": cfg.chunk,
            "prefill": prefill_len, "steps": n_steps,
            "held_rel_l2": {str(p): e for p, e in held.items()},
            "rel_l2": {str(p): e for p, e in errs.items()},
            "flash_by_kind": by_kind, "s": s}


def run_zoo_last_phase(path_launches: dict) -> dict:
    """Phases 12d and 12e on the card, the zoo's last configs at full
    width: 12d llama4-maverick (:func:`run_llama4_path`) and its one
    ``chunked`` layer's ring (:func:`run_chunk_ring_path`); 12e
    starcoder2-7b and llama2-7b served from a checkpoint
    (:func:`run_zoo_serve_path`) and command-r-35b generating from seeded
    params (:func:`run_zoo_generate_path`); each with the launch counts
    zeroed just before and read into ``path_launches`` just after."""
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")

    def cfg(name):
        pattern = ZOO12E_PATTERNS[name]
        return _zoo_cfg(name, len(pattern), pattern)

    def serve(name, sub):
        return lambda: run_zoo_serve_path(
            "cuda", cfg(name), os.path.join(zoo_dir, sub), SERVE_BATCH,
            ZOO12E_PROMPTS[name], SERVE_NEW)
    report = _run_zoo_cases((
        ("llama4", lambda: run_llama4_path(
            "cuda", _zoo_cfg(LLAMA4, len(LLAMA4_PATTERN), LLAMA4_PATTERN),
            SERVE_BATCH, LLAMA4_PROMPT, SERVE_NEW)),
        ("chunk_ring", lambda: run_chunk_ring_path(
            "cuda", _zoo_cfg(LLAMA4, 1, ("chunked",)), SERVE_BATCH,
            RING_PREFILL, RING_STEPS)),
        ("starcoder2", serve("starcoder2-7b", "sc2")),
        ("llama2", serve("llama2-7b", "llama2")),
        ("command_r", lambda: run_zoo_generate_path(
            "cuda", cfg("command-r-35b"), SERVE_BATCH,
            ZOO12E_PROMPTS["command-r-35b"], SERVE_NEW))), path_launches,
        tuple((key, "flash_attention") for key in (
            "llama4", "chunk_ring", "starcoder2", "llama2", "command_r"))
        + (("starcoder2", "checksum_u32"), ("llama2", "checksum_u32")))
    log("zoo path, the last: "
        + ", ".join(f"{key} {r['phase_s']:.1f} s (max_memory_allocated "
                    f"{r['max_memory_allocated']})"
                    for key, r in report.items()))
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


def run_dryrun_path(device: str, cfg, batch: int, seq_len: int,
                    card: str = "") -> dict:
    """Phase 13: the dry run (``repro_torch.launch.dryrun``) against the
    card. Each of three steps of ``cfg`` at ``batch`` x ``seq_len``
    tokens, phase 6's prefill and a training step (``make_train_step``)
    with ``remat`` on (the config's default) and off, is traced on fake
    tensors on a (1, 1) mesh, then run for real from seeded params: the
    gradients once, then the step once to warm up, once under
    ``FlopCounterMode``, once under the dry run's counter recording its
    operators, and :data:`DRYRUN_TIMED` times timed. Fails unless the
    traced FLOPs equal the counted FLOPs exactly, the real step's per-kind
    op profile equals the trace's, the dry run's
    argument bytes equal the real arguments' bytes exactly, the attention
    kernel launched in each real step, the remat step launched it once
    more a layer and a step (the recompute), and the two training steps'
    gradients agree within one bf16 unit of relative L2 error (logged:
    whether they are bit-equal). Logs, with no gate, the predicted temp
    bytes against the peak device memory beyond the arguments, and the
    step time against the dry run's bound. Then one CLI-equivalent
    record of :data:`DRYRUN_CLI` at full depth on the production mesh.
    ``card`` (the card's name and power limit) ends every line logged."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving.engine import make_prefill_step
    from repro_torch.training.loop import _loss_and_grads, make_train_step

    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    on_card = device == "cuda"
    tail = f" ({card})" if card else ""
    out = {}
    grads = {}
    steps = (("prefill", cfg), ("train", dataclasses.replace(cfg, remat=True)),
             ("train_no_remat", dataclasses.replace(cfg, remat=False)))
    for name, c in steps:
        kind = name.split("_")[0]
        shape = InputShape(f"{kind}_{batch}x{seq_len}", seq_len, batch, kind)
        rec = dryrun.dryrun_record(c, shape, mesh, record_ops=True)
        roof = rec["roofline"]
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = M.init_params(c, gen, torch.device(device))
        tokens = torch.randint(0, c.vocab, (batch, seq_len),
                               dtype=torch.int32, device=device,
                               generator=gen)
        if kind == "train":
            params = map_leaves(lambda t: t.requires_grad_(True), params)
            _loss, g = _loss_and_grads(c, params, {"tokens": tokens})
            grads[name] = leaves(g)
            del g
            args = (params, init_opt_state(params), {"tokens": tokens})
            step = make_train_step(c, AdamWConfig())
        else:
            args = (params, {"tokens": tokens})
            step = make_prefill_step(c)
        arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args))
        launches0 = fa.KERNEL.launches
        step(*args)  # warm-up
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            step(*args)
        counted = fc.get_total_flops()
        peak_temp = (torch.cuda.max_memory_allocated() - base) \
            if on_card else None
        # the same step under the dry run's counter, recording its
        # operators: the per-kind op profile the trace predicts
        profiler = TraceCounter(args, record_ops=True)
        with profiler:
            step(*args)
        profile = profiler.profile()
        del profiler
        step_s = _timed_steps(device, lambda: step(*args), DRYRUN_TIMED)
        launched = fa.KERNEL.launches - launches0
        if counted != roof["traced_flops_global"]:
            fail(f"dry run {name}: traced {roof['traced_flops_global']!r} "
                 f"FLOPs, the real step counted {counted}")
        if arg_bytes != roof["memory"]["argument_size_in_bytes"]:
            fail(f"dry run {name}: argument_size_in_bytes "
                 f"{roof['memory']['argument_size_in_bytes']}, the real "
                 f"arguments hold {arg_bytes} bytes")
        if profile != rec["op_profile"]:
            diff = {k: (profile.get(k), rec["op_profile"].get(k))
                    for k in set(profile) | set(rec["op_profile"])
                    if profile.get(k) != rec["op_profile"].get(k)}
            fail(f"dry run {name}: the real step's op profile differs from "
                 f"the trace's in (real, traced) {json.dumps(diff)}")
        if on_card and launched < 3 + DRYRUN_TIMED:
            fail(f"dry run {name}: the attention kernel launched {launched} "
                 f"times in {3 + DRYRUN_TIMED} real steps")
        out[name] = {
            "fake_device": rec["fake_device"], "trace_s": rec["trace_s"],
            "flops": counted, "argument_bytes": arg_bytes,
            "predicted_temp_bytes": roof["memory"]["temp_size_in_bytes"],
            "peak_temp_bytes": peak_temp, "step_s": step_s,
            "bound_s": roof["bound_s"], "dominant": roof["dominant"],
            "terms": roof["terms"], "step_over_bound": step_s
            / roof["bound_s"], "flash_launches": launched,
            "op_kinds": len(profile),
            "op_count": sum(n for n, _b in profile.values()),
            "op_result_bytes": sum(b for _n, b in profile.values())}
        log(f"dry run {name} at {batch} x {seq_len} tokens: traced on fake "
            f"{rec['fake_device']} tensors in {rec['trace_s']:.3f} s; "
            f"FLOPs {counted} traced and counted; argument bytes {arg_bytes} "
            f"predicted and real; temp bytes predicted "
            f"{roof['memory']['temp_size_in_bytes']}, peak beyond the "
            f"arguments {peak_temp}; step {step_s * 1e3:.3f} ms against a "
            f"bound of {roof['bound_s'] * 1e3:.3f} ms "
            f"({out[name]['step_over_bound']:.3f}x, {roof['dominant']}); "
            f"attention kernel launches {launched}; op profile "
            f"{out[name]['op_count']} operators of {len(profile)} kinds, "
            f"{out[name]['op_result_bytes']} result bytes, traced and "
            f"run{tail}")
        del args, params, step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    # remat: the recompute re-runs each layer's attention forward in every
    # step's backward (the warm-up, the counted and the timed steps); the
    # gradients are the same arithmetic
    extra = out["train"]["flash_launches"] \
        - out["train_no_remat"]["flash_launches"]
    if on_card and extra != cfg.n_layers * (3 + DRYRUN_TIMED):
        fail(f"dry run remat: the attention kernel launched {extra} times "
             f"more with remat, the recompute is "
             f"{cfg.n_layers * (3 + DRYRUN_TIMED)}")
    num = den = 0.0
    same = True
    for a, b in zip(grads["train"], grads["train_no_remat"]):
        same = same and torch.equal(a, b)
        a, b = a.double(), b.double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    del grads
    rel = math.sqrt(num / den)
    out["remat"] = {"extra_flash_launches": extra, "grad_rel_l2": rel,
                    "grad_bit_equal": same, "rtol": BF16_U}
    if not rel <= BF16_U:
        fail(f"dry run remat: gradients with remat on and off differ by "
             f"{rel} relative L2 (limit one bf16 unit, {BF16_U})")
    log(f"dry run remat: {extra} more attention launches with remat; "
        f"gradients on and off: relative L2 {rel:.3e} (limit {BF16_U:.3e}), "
        f"bit-equal {same}; peak temp bytes beyond the arguments "
        f"{out['train']['peak_temp_bytes']} with remat (predicted "
        f"{out['train']['predicted_temp_bytes']}), "
        f"{out['train_no_remat']['peak_temp_bytes']} without (predicted "
        f"{out['train_no_remat']['predicted_temp_bytes']}){tail}")
    rec = dryrun.run_dryrun(*DRYRUN_CLI, verbose=False)
    out["cli"] = {"arch": DRYRUN_CLI[0], "shape": DRYRUN_CLI[1],
                  "trace_s": rec["trace_s"],
                  "terms": rec["roofline"]["terms"],
                  "dominant": rec["roofline"]["dominant"],
                  "memory": rec["roofline"]["memory"]}
    log(f"dry run {DRYRUN_CLI[0]} x {DRYRUN_CLI[1]} x {rec['mesh']}: traced "
        f"in {rec['trace_s']:.3f} s; terms "
        f"{json.dumps(rec['roofline']['terms'])}; dominant "
        f"{rec['roofline']['dominant']}{tail}")
    return out


def _trace(cfg, kinds: tuple, batch: int, seq: int, prefill_batch: int,
           prefill_len: int) -> dict:
    """``cfg``'s steps of ``kinds`` traced by the dry run on a fake (2, 2)
    mesh in this process, which holds no process group before or after:
    by kind, what :func:`_counted` reads of a real rank (FLOPs,
    collectives and the per-kind op profile), the collective term and
    the trace's seconds."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    mesh = make_abstract_mesh(SHARD_DIMS, SHARD_AXES)
    out = {}
    for kind in kinds:
        b, n = {"train": (batch, seq),
                "prefill": (prefill_batch, prefill_len),
                "decode": (prefill_batch,
                           prefill_len + SHARD_DECODE_LEN)}[kind]
        c = cfg if kind == "train" else \
            dataclasses.replace(cfg, max_decode_len=SHARD_DECODE_LEN)
        rec = dryrun.dryrun_record(c, InputShape(kind, n, b, kind), mesh,
                                   record_ops=True)
        if dist.is_initialized():
            fail("the sharded trace left a process group behind")
        roof = rec["roofline"]
        out[kind] = {"flops": roof["per_device"]["flops"],
                     "collectives": {k: roof["collectives"][k] for k in (
                         "bytes_per_device", "by_kind", "counts")},
                     "profile": rec["op_profile"],
                     "collective_s": roof["terms"]["collective_s"],
                     "bound_s": roof["bound_s"],
                     "dominant": roof["dominant"],
                     "trace_s": rec["trace_s"]}
    return out


def trace_sharded_steps(cfg, batch: int, seq: int, prefill_batch: int,
                        prefill_len: int) -> dict:
    """Phase 15's ``2d`` train step (``batch`` x ``seq``), prefill
    (``prefill_batch`` x ``prefill_len``, :data:`SHARD_DECODE_LEN` of
    decode headroom) and decode step (a token a row against that cache),
    by :func:`_trace`."""
    import dataclasses
    return _trace(dataclasses.replace(cfg, sharding_mode="2d"),
                  ("train", "prefill", "decode"), batch, seq,
                  prefill_batch, prefill_len)


def trace_sharded_modes(cfg, batch: int, seq: int, prefill_batch: int,
                        prefill_len: int) -> dict:
    """:func:`trace_sharded_steps` for each of :data:`SHARD_MODES`: its
    train step, and ``tp_zero1``'s prefill and decode step."""
    import dataclasses
    return {name: _trace(dataclasses.replace(cfg, **{"sharding_mode": "2d",
                                                     **kw}),
                         ("train", "prefill", "decode")
                         if name == "tp_zero1" else ("train",),
                         batch, seq, prefill_batch, prefill_len)
            for name, kw in SHARD_MODES.items()}


def run_dryrun_phase(cfg, path_launches: dict, card: str = "",
                     start=None) -> dict:
    """Phase 13 on the card, with the launch counts zeroed just before and
    read into ``path_launches`` just after; ``card`` ends every line
    logged. ``start`` (no arguments) is called once the timed steps are
    done, before phase 15's steps are traced sharded (it starts phase
    15's ranks, which then do not run beside the timed steps)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    report = run_dryrun_path("cuda", cfg, SERVE_BATCH, SERVE_PROMPT, card)
    launches = path_launches["dryrun"] = _launches()
    if launches["flash_attention"] == 0:
        fail("kernel flash_attention was never launched on the dry run's "
             "path")
    report["launches"] = launches
    if start is not None:
        start()
    # phase 15's 2d step, prefill and decode step and every mode's step
    # traced sharded, while its ranks spawn
    t1 = time.perf_counter()
    traced = report["sharded_trace"] = trace_sharded_steps(
        cfg, SHARD_BATCH, SHARD_SEQ, SHARD_PREFILL_BATCH, SHARD_PREFILL_SEQ)
    traced["modes"] = trace_sharded_modes(
        cfg, SHARD_BATCH, SHARD_SEQ, SHARD_PREFILL_BATCH, SHARD_PREFILL_SEQ)
    report["sharded_trace_s"] = time.perf_counter() - t1
    report["phase_s"] = time.perf_counter() - t0
    log(f"dry run path: {report['phase_s']:.1f} s (the sharded traces of "
        f"phase 15's 2d step, prefill and decode and of its other modes' "
        f"steps {report['sharded_trace_s']:.1f} s, beside its ranks' "
        f"spawn); launches {json.dumps(launches)} ({card})")
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


# ------------------------------------------- phase 15: sharded compute
#: one rank's state between the calls of the sharded phase
_SHARD: dict = {}


def _shard_tokens(cfg, device: str, batch: int, seq: int, seed: int):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=device, dtype=torch.int32)


def _shard_rank_setup(cfg, device: str, batch: int, seq: int,
                      grad_batch: int, grad_seq: int) -> dict:
    """This rank's mesh, and :func:`_shard_rank_layout` of ``cfg``."""
    import torch
    from repro_torch.launch.mesh import make_device_mesh
    dm = make_device_mesh(SHARD_DIMS, SHARD_AXES, device)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    _SHARD.clear()
    _SHARD.update(base_cfg=cfg, mesh=dm, device=dev,
                  shapes=(batch, seq, grad_batch, grad_seq))
    return _shard_rank_layout(cfg)


def _shard_rank_layout(cfg) -> dict:
    """The params, AdamW state and the two batches (the step's, the
    gradient pass's) built from the seed and laid out as DTensors by
    ``cfg``'s partition rules, in place of what this rank held: every
    mode starts from the same state, whatever an earlier one's step
    updated in place."""
    import torch
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                opt_pspecs, param_pspecs)
    dm, dev = _SHARD["mesh"], _SHARD["device"]
    batch, seq, grad_batch, grad_seq = _SHARD["shapes"]
    for k in ("params", "opt", "batch", "grad_batch"):
        _SHARD.pop(k, None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    vm = virtual_mesh(dm)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    opt = init_opt_state(params)
    batch_t = {"tokens": _shard_tokens(cfg, dev, batch, seq, SEED + 1)}
    grad_t = {"tokens": _shard_tokens(cfg, dev, grad_batch, grad_seq,
                                      SEED + 3)}
    _SHARD.update(
        cfg=cfg,
        params=distribute_tree(map_leaves(lambda t: t.requires_grad_(True),
                                          params),
                               param_pspecs(cfg, params, vm), dm),
        opt=distribute_tree(opt, opt_pspecs(cfg, params, vm), dm),
        batch=distribute_tree(batch_t, batch_pspecs(cfg, "train", batch_t,
                                                    vm), dm),
        grad_batch=distribute_tree(grad_t, batch_pspecs(cfg, "train",
                                                        grad_t, vm), dm))
    del params, opt, batch_t, grad_t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"local_bytes": sum(t.to_local().numel()
                               * t.to_local().element_size()
                               for t in leaves({"p": _SHARD["params"],
                                                "o": _SHARD["opt"]}))}


@contextlib.contextmanager
def _computing():
    """The mesh active, and in ``fsdp`` the batch over both axes (as the
    reference's dry run sets it), for this rank's compute."""
    from repro_torch.sharding import context as shctx
    shctx.set_batch_axes(("data", "model")
                         if _SHARD["cfg"].sharding_mode == "fsdp" else None)
    try:
        with shctx.activate(_SHARD["mesh"]):
            yield
    finally:
        shctx.set_batch_axes(None)


def _shard_sync() -> None:
    import torch
    import torch.distributed as dist
    if _SHARD["device"].type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _shard_rank_step(grad_pass: bool = True) -> dict:
    """With ``grad_pass`` (the 2d case: the phase's main path starts here,
    the launch counts zeroed just before) the gradient pass at the long
    batch (attention through the kernel and its backward on the local
    heads), then one train step (loss and gradients, then AdamW in
    place), both from the seeded params as :func:`_shard_rank_layout`
    laid them out. Keeps, for :func:`_shard_rank_errs`, this rank's own
    regions of the long batch's gradients, of the step's update to the
    fp32 master, of the first moment and of the params before and after."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         global_norm)
    from repro_torch.training.loop import _loss_and_grads
    params, opt = _SHARD["params"], _SHARD["opt"]

    def own(ts):
        return [(_owned_region(t), t.to_local().detach()) for t in ts]

    out, cmp = {}, {}
    if grad_pass:
        _zero_launches()
        _shard_sync()
        t0 = time.perf_counter()
        with _computing():
            loss2, grads2 = _loss_and_grads(_SHARD["cfg"], params,
                                            _SHARD["grad_batch"])
            out["grad2_norm"] = float(global_norm(grads2).full_tensor())
            out["grad_loss"] = float(loss2.full_tensor())
            grads2 = [g if g.placements == p.placements
                      else g.redistribute(p.device_mesh, p.placements)
                      for g, p in zip(leaves(grads2), leaves(params))]
        _shard_sync()
        out["grad_s"] = time.perf_counter() - t0
        out["flash_in_grad"] = _launches()["flash_attention"]
        cmp["grads2"] = own(grads2)
        del grads2
    out["rss"] = [_rss_bytes()]  # host memory before and after the step
    cmp["params_before"] = [(i, t.clone()) for i, t in own(leaves(params))]
    master_before = [t.to_local().clone() for t in leaves(opt["master"])]
    _shard_sync()
    t0 = time.perf_counter()
    # the train step (``make_train_step``'s two halves) under the dry
    # run's counter: this rank's FLOPs and collectives, for the trace
    counter = TraceCounter((params, opt, _SHARD["batch"]), record_ops=True)
    with _computing():
        with counter:
            loss, grads = _loss_and_grads(_SHARD["cfg"], params,
                                          _SHARD["batch"])
            apply_updates(params, opt, grads, AdamWConfig())
        out["grad_norm"] = float(global_norm(grads).full_tensor())
        out["loss"] = float(loss.full_tensor())
    _shard_sync()
    out["step_s"] = time.perf_counter() - t0
    out["rss"].append(_rss_bytes())
    cmp["delta"] = [(i, t - b) for (i, t), b in
                    zip(own(leaves(opt["master"])), master_before)]
    cmp["m"] = own(leaves(opt["m"]))
    cmp["params"] = own(leaves(params))
    _SHARD["cmp"] = cmp
    out.update(counted=_counted(counter), peak_bytes=counter.peak_temp_bytes)
    return out


def _shard_rank_prefill() -> dict:
    """The prefill of the gradient pass's batch from the params as
    :func:`_shard_rank_layout` laid them out, before the step updates
    them (the kernel on the local heads): rank 0's logits on the host
    (fp32), the seconds and the case's ``flash_attention`` launches."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.serving.engine import make_prefill_step
    cfg = dataclasses.replace(_SHARD["cfg"], max_decode_len=SHARD_DECODE_LEN)
    before = _launches()["flash_attention"]
    _shard_sync()
    t0 = time.perf_counter()
    with _computing(), torch.no_grad():
        logits, caches = make_prefill_step(cfg)(_SHARD["params"],
                                                _SHARD["grad_batch"])
        logits = logits.full_tensor().float().cpu()
    _shard_sync()
    del caches
    return {"prefill_s": time.perf_counter() - t0,
            "flash": _launches()["flash_attention"] - before,
            "finite": bool(torch.isfinite(logits).all()),
            "logits": logits if dist.get_rank() == 0 else None}


def _counted(counter) -> dict:
    """What :func:`repro_torch.launch.dryrun`'s record holds of a step:
    the FLOPs a device, its collectives and its per-kind op profile
    (``counter`` records its operators)."""
    coll = counter.collectives()
    return {"flops": float(counter.flops),
            "collectives": {k: coll[k] for k in ("bytes_per_device",
                                                 "by_kind", "counts")},
            "profile": counter.profile()}


def _owned_region(t):
    """The index of this rank's shard of DTensor ``t``, or ``None`` when
    another rank of its replica group counts it (the rank whose mesh
    coordinate is 0 along every axis ``t`` is replicated over)."""
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding.partition import local_index
    coord = t.device_mesh.get_coordinate()
    if any(isinstance(p, Replicate) and c for p, c in zip(t.placements,
                                                          coord)):
        return None
    return local_index(t)


#: what the ranks hold against the unsharded run: (this rank's kept
#: name, the unsharded run's); ``params_before`` is the control, a step
#: that left the params as they were
SHARD_CMP = (("grads2", "grads2"), ("delta", "delta"), ("m", "m"),
             ("params", "params"), ("params_before", "params"))


def _shard_rank_errs(ref: dict) -> dict:
    """For each pair of :data:`SHARD_CMP`, ``(sum of squared differences,
    sum of squares)`` of this rank's own regions kept by
    :func:`_shard_rank_step` against the unsharded run's ``ref`` (whole
    tensors, on a card by CUDA IPC handle); each region is counted on
    one rank."""
    out = {}
    for name, ref_name in SHARD_CMP:
        if name not in _SHARD["cmp"]:
            continue   # no gradient pass in this case
        num = den = 0.0
        for (index, g), w in zip(_SHARD["cmp"][name], ref[ref_name]):
            if index is None:
                continue
            a, b = _sq_err(g, w[index])
            num += a
            den += b
        out[name] = (num, den)
    _SHARD.pop("cmp")
    return out


def _sq_err(got, want) -> tuple:
    """``(sum of squared differences, sum of squares)`` of two tensors of
    one shape in fp64, 2**24 elements at a time (four ranks' fp64 copies
    of a full-width expert weight at once would not fit beside the
    state)."""
    got, want = got.reshape(-1), want.reshape(-1)
    num = den = 0.0
    for i in range(0, got.numel(), 1 << 24):
        g = got[i:i + (1 << 24)].double()
        w = want[i:i + (1 << 24)].double()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return num, den


def _shard_rank_snapshot() -> None:
    """A copy of this rank's shards, the state the lazy save writes, each
    with its region (the index of the whole tensor it holds)."""
    from repro_torch.core.tree import flatten_with_path, path_str
    from repro_torch.sharding.partition import local_index
    _SHARD["snapshot"] = [
        (path_str(path), local_index(t), t.to_local().detach().clone())
        for path, t in flatten_with_path({"model": _SHARD["params"],
                                          "optimizer": _SHARD["opt"]})[0]]


def _shard_rank_check_restore(restored: list) -> list:
    """Every leaf of the world-1 restore (whole tensors, on a card by CUDA
    IPC handle) against this rank's snapshot of its shard of it and
    against the region of it this rank's elastic restore
    (:func:`_shard_rank_elastic`) holds, bit for bit: the paths of those
    that differ, ``elastic:`` before the second kind."""
    import torch
    from repro_torch.core.tree import flatten_with_path, path_str
    from repro_torch.sharding.partition import local_index
    bad = [path for (path, index, snap), got in zip(_SHARD.pop("snapshot"),
                                                    restored)
           if not torch.equal(got[index], snap)]
    flat = flatten_with_path(_SHARD.pop("elastic"))[0]
    bad += [f"elastic:{path_str(path)}" for (path, t), got in zip(flat,
                                                                  restored)
            if not torch.equal(t.to_local(), got[local_index(t)])]
    if _SHARD["device"].type == "cuda":
        torch.cuda.empty_cache()
    return bad


def _shard_manager(root: str):
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  DistPolicy, EnginePolicy)
    return CheckpointManager.from_policy(root, CheckpointPolicy(
        engine=EnginePolicy(host_cache_bytes=SHARD_CACHE_BYTES,
                            flush_threads=2),
        dist=DistPolicy(group=True)), device=_SHARD["device"])


def _shard_state(step: int) -> dict:
    return {"model": _SHARD["params"], "optimizer": _SHARD["opt"],
            "meta": {"step": step, "arch": _SHARD["cfg"].name}}


def _shard_rank_save(root: str, blocking: bool) -> dict:
    """Step 1 saved blocking (left out without ``blocking``); step 2 saved
    lazily while the next step's forward and backward run, the capture
    barrier before its in-place update; its commit is waited for later
    (:func:`_shard_rank_commit`), while this rank works on. A manager
    this rank held before is closed first."""
    from repro_torch.optim.adamw import AdamWConfig, apply_updates
    from repro_torch.training.loop import _loss_and_grads
    out = {}
    _shard_rank_close_manager()
    mgr = _shard_manager(root)
    _SHARD["manager"] = mgr
    _shard_sync()
    if blocking:
        t0 = time.perf_counter()
        fut = mgr.save(1, _shard_state(1), blocking=True)
        out["blocking"] = {"save_s": time.perf_counter() - t0,
                           "persist_s": fut.stats.persist_latency_s}
    _shard_rank_snapshot()
    t0 = time.perf_counter()
    _SHARD["save"] = (root, (1, 2) if blocking else (2,),
                      mgr.save(2, _shard_state(2)))
    prologue = time.perf_counter() - t0
    with _computing():
        _loss, grads = _loss_and_grads(_SHARD["cfg"], _SHARD["params"],
                                       _SHARD["batch"])
        stall = mgr.wait_for_capture()
        apply_updates(_SHARD["params"], _SHARD["opt"], grads, AdamWConfig())
    _shard_sync()
    out["lazy"] = {"prologue_s": prologue, "capture_stall_s": stall,
                   "step_with_save_s": time.perf_counter() - t0}
    return out


def _shard_rank_commit() -> dict:
    """Waits for :func:`_shard_rank_save`'s lazy save to commit: its
    persist seconds, and this rank's file bytes by step."""
    import torch.distributed as dist
    from repro_torch.core.baselines import rank_file
    root, steps, fut = _SHARD.pop("save")
    mgr = _SHARD["manager"]
    t0 = time.perf_counter()
    mgr.wait_for_commit(2)
    if mgr.commit_errors:
        raise RuntimeError(f"commit errors: {mgr.commit_errors}")
    return {"persist_s": fut.stats.persist_latency_s,
            "commit_wait_s": time.perf_counter() - t0,
            "file_bytes": {step: os.path.getsize(rank_file(os.path.join(
                root, f"global_step{step}"), dist.get_rank()))
                for step in steps}}


def _shard_rank_close_manager() -> None:
    mgr = _SHARD.pop("manager", None)
    if mgr is not None:
        mgr.close()


def _shard_rank_elastic(root: str, dims: tuple, mode: str = None) -> dict:
    """Step 2 restored onto a ``dims`` mesh (this rank's own mesh when it
    is :data:`SHARD_DIMS`): DTensor templates laid out there by the rules
    of ``mode`` (``None``: the state's own), each rank reading its own
    region; kept for :func:`_shard_rank_check_restore`."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.mesh import make_device_mesh, virtual_mesh
    from repro_torch.sharding.partition import (local_region, opt_pspecs,
                                                param_pspecs,
                                                placements_for)
    from repro_torch.sharding.sharded import _spec_at
    cfg = _SHARD["cfg"] if mode is None \
        else dataclasses.replace(_SHARD["cfg"], sharding_mode=mode)
    dm = _SHARD["mesh"] if tuple(dims) == SHARD_DIMS else \
        make_device_mesh(dims, SHARD_AXES, _SHARD["device"].type)
    vm = virtual_mesh(dm)
    specs = {"model": param_pspecs(cfg, _SHARD["params"], vm),
             "optimizer": opt_pspecs(cfg, _SHARD["params"], vm)}
    flat, unflatten = flatten_with_path({"model": _SHARD["params"],
                                         "optimizer": _SHARD["opt"]})
    tpl = []
    for path, t in flat:
        spec = _spec_at(specs, path)
        index = local_region(tuple(t.shape), spec, dm, dist.get_rank())
        shape = [len(range(*s.indices(n))) for s, n in zip(index, t.shape)]
        tpl.append(DTensor.from_local(
            torch.empty(shape, dtype=t.dtype, device=_SHARD["device"]), dm,
            placements_for(spec, dm), run_check=False, shape=t.shape,
            stride=t.stride()))
    tree = unflatten(tpl)
    tree["meta"] = {"step": 0, "arch": ""}
    _shard_sync()
    t0 = time.perf_counter()
    got = _SHARD["manager"].restore(tree, step=2)
    _shard_sync()
    restore_s = time.perf_counter() - t0
    _SHARD["elastic"] = {"model": got["model"],
                         "optimizer": got["optimizer"]}
    return {"restore_s": restore_s, "meta": got["meta"],
            "rank": dist.get_rank(),
            "local_embed": tuple(got["model"]["embed"]["embed"]
                                 .to_local().shape)}


#: the seeds of phase 15's serving params and of its prompts (batch 2,
#: then the long-context batch 1)
SHARD_SERVE_SEED, SHARD_PROMPT_SEED, SHARD_LONG_SEED = SEED + 5, SEED + 2, \
    SEED + 6


def _init_sharded(cfg, seed: int, dm):
    """``init_params(cfg)`` from ``seed`` laid out by ``param_pspecs`` on
    ``dm``, a leaf at a time: this rank makes each leaf whole (the draws
    ``init_params`` makes) and keeps its region, so it never holds the
    whole tree (dbrx's one layer is 8.98 GB). The ranks take turns, each
    handing its whole leaves back to the card before the next starts:
    four ranks drawing a full-width expert weight at once (fp32, 3.94
    GiB each) do not fit beside the state on one card."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.sharding.partition import (distribute_tree,
                                                mesh_device, param_pspecs)
    from repro_torch.sharding.sharded import _spec_at
    dev = mesh_device(dm)
    specs = param_pspecs(cfg, param_shapes(cfg), virtual_mesh(dm))

    def place(path, leaf):
        return distribute_tree({"x": leaf}, {"x": _spec_at(specs, path)},
                               dm)["x"]
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            out = init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed), dev, place=place)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        _shard_sync()
    return out


def _serve_cfg(decode_len: int, **kw):
    """The phase's model laid out ``2d`` unless ``kw`` says otherwise."""
    import dataclasses
    return dataclasses.replace(_SHARD["base_cfg"], **{
        "sharding_mode": "2d", "max_decode_len": decode_len, **kw})


def _kv_decode_len(prompt_len: int) -> int:
    """The ``decode_kv_seq_shard`` case's headroom: the cache's slots up
    to the next multiple of :data:`SHARD_KV_ALIGN` past the prompt."""
    return SHARD_KV_ALIGN - prompt_len % SHARD_KV_ALIGN


def _decode_cases(batch: int, prompt_len: int) -> dict:
    """Phase 15's decode cases: name -> (config overrides, decode
    headroom, batch, prompt seed, the ``seq`` axis, steps)."""
    return {"2d": ({}, SHARD_DECODE_LEN, batch, SHARD_PROMPT_SEED, None,
                   SHARD_DECODE_STEPS),
            "decode_kv_seq_shard": ({"decode_kv_seq_shard": True},
                                    _kv_decode_len(prompt_len), batch,
                                    SHARD_PROMPT_SEED, None,
                                    SHARD_CASE_STEPS),
            "long_context": ({}, SHARD_DECODE_LEN, 1, SHARD_LONG_SEED,
                             "data", SHARD_CASE_STEPS),
            "tp_zero1": ({"sharding_mode": "tp_zero1"}, SHARD_DECODE_LEN,
                         batch, SHARD_PROMPT_SEED, None,
                         SHARD_CASE_STEPS)}


def _expected_local_cache(case: str, batch: int, slots: int, cfg) -> tuple:
    """The first group's k as each rank holds it, by ``cache_pspecs``:
    (repeats, B, T, KV, hd) with the batch over ``data`` and the KV heads
    over ``model`` (2d, and tp_zero1: the caches' layout does not depend
    on the params'), the slots over ``model`` (kv), or for batch 1 the
    slots over ``data`` (long context)."""
    n, KV, hd = cfg.layer_groups[0][1], cfg.n_kv_heads, cfg.hd
    return {"2d": (n, batch // 2, slots, KV // 2, hd),
            "tp_zero1": (n, batch // 2, slots, KV // 2, hd),
            "decode_kv_seq_shard": (n, batch // 2, slots // 2, KV, hd),
            "long_context": (n, 1, slots // 2, KV, hd)}[case]


def _decode_reference(cfg, device: str, batch: int, prompt_len: int,
                      seed: int, n: int, count: dict = None) -> tuple:
    """The unsharded prefill of the seeded prompt and ``n`` greedy decode
    steps from the seeded serving params, in this process: the tokens
    (B, n) and every logits (the prefill's last, then each step's), on
    the host in fp32, and the seconds. With ``count`` (a dict) the
    prefill and the first decode step run under the dry run's counter,
    their FLOPs and peak bytes put in it under ``prefill`` and
    ``decode``."""
    import torch
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_step)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        SHARD_SERVE_SEED), device)
    prompt = {"tokens": _shard_tokens(cfg, device, batch, prompt_len, seed)}

    def counted(kind, args):
        if count is None:
            return contextlib.nullcontext()
        counter = count[kind] = TraceCounter(args)
        return counter
    t0 = time.perf_counter()
    with torch.no_grad():
        with counted("prefill", (params, prompt)):
            logits, caches = make_prefill_step(cfg)(params, prompt)
        decode = make_decode_step(cfg)
        out, toks = [logits.float().cpu()], []
        for i in range(n):
            nxt = torch.argmax(logits[:, -1].float(), dim=-1) \
                .to(torch.int32).reshape(batch, 1)
            toks.append(nxt)
            with counted("decode", (params, nxt, caches)) if i == 0 \
                    else contextlib.nullcontext():
                logits, caches = decode(params, nxt, caches, prompt_len + i)
            out.append(logits.float().cpu())
    seconds = time.perf_counter() - t0
    for kind, counter in (count or {}).items():
        count[kind] = {"flops": float(counter.flops),
                       "peak_bytes": counter.peak_temp_bytes}
    return torch.cat(toks, dim=1).cpu(), out, seconds


def _shard_rank_decode(case: str, batch: int, prompt_len: int,
                       steps) -> dict:
    """One of :func:`_decode_cases` on the mesh from the seeded serving
    params laid out in the case's mode: the sharded prefill (caches laid
    out by ``cache_pspecs``), then a decode step a column of ``steps``
    (B, n) on its ``DTensor`` caches. In ``2d`` and ``tp_zero1`` the
    prefill and the first decode step run under the dry run's counter;
    in ``2d`` rank 0 keeps the first local attention call's q, k, v for
    :func:`_shard_rank_local_flash`. Returns rank 0's logits on the host
    (fp32), the first layer's k as this rank holds it, the seconds, the
    case's ``flash_attention`` launches and the launch counts so far."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_step)
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import batch_pspecs, distribute_tree
    kw, decode_len, batch, seed, seq_axis, n = _decode_cases(
        batch, prompt_len)[case]
    cfg = _serve_cfg(decode_len, **kw)
    dm, dev = _SHARD["mesh"], _SHARD["device"]
    vm = virtual_mesh(dm)
    if _SHARD.get("serve_mode") != cfg.sharding_mode:
        _shard_rank_drop_serving()
        _SHARD["serve_params"] = _init_sharded(cfg, SHARD_SERVE_SEED, dm)
        _SHARD["serve_mode"] = cfg.sharding_mode
    params = _SHARD["serve_params"]
    flash_before = _launches()["flash_attention"]
    prompt = {"tokens": _shard_tokens(cfg, dev, batch, prompt_len, seed)}
    b = distribute_tree(prompt, batch_pspecs(cfg, "prefill", prompt, vm), dm)
    cols = [{"t": steps[:, i:i + 1].contiguous().to(dev)} for i in range(n)]
    cols = [distribute_tree(c, batch_pspecs(cfg, "decode", c, vm), dm)["t"]
            for c in cols]
    counted = case in ("2d", "tp_zero1")
    calls = []
    orig = fa.flash_attention_cuda

    def record(q, k, v, **kw):
        if not calls and case == "2d":
            calls.append((q.clone(), k.clone(), v.clone(), dict(kw)))
        return orig(q, k, v, **kw)

    out = {"logits": []}
    fa.flash_attention_cuda = record
    shctx.set_seq_axis(seq_axis)
    _shard_sync()
    t0 = time.perf_counter()
    try:
        with shctx.activate(dm), torch.no_grad():
            counter = TraceCounter((params, b), record_ops=True)
            with counter if counted else contextlib.nullcontext():
                logits, caches = make_prefill_step(cfg)(params, b)
            out["logits"].append(logits.full_tensor().float().cpu())
            _shard_sync()
            out["prefill_s"] = time.perf_counter() - t0
            if counted:
                out["counted_prefill"] = _counted(counter)
            decode = make_decode_step(cfg)
            t0 = time.perf_counter()
            for i in range(n):
                counter = TraceCounter((params, cols[i], caches),
                                       record_ops=True)
                with counter if counted and i == 0 \
                        else contextlib.nullcontext():
                    logits, caches = decode(params, cols[i], caches,
                                            prompt_len + i)
                if counted and i == 0:
                    out["counted_decode"] = _counted(counter)
                out["logits"].append(logits.full_tensor().float().cpu())
            _shard_sync()
            out["decode_s"] = time.perf_counter() - t0
    finally:
        fa.flash_attention_cuda = orig
        shctx.set_seq_axis(None)
    k = caches[0][0]["k"]
    out["cache"] = (str(k.placements), tuple(k.to_local().shape))
    out["slots"] = k.shape[2]
    out["finite"] = all(bool(torch.isfinite(x).all()) for x in out["logits"])
    out["launches"] = _launches()
    out["flash"] = out["launches"]["flash_attention"] - flash_before
    if dist.get_rank():
        out.pop("logits")
    elif calls:
        _SHARD["flash_call"] = calls[0]
    del caches
    return out


def _shard_rank_local_flash():
    """Rank 0's first local attention call of the 2d prefill held against
    the plain version on the same local q, k, v (after the main path's
    launch counts are read: this launch is a check's)."""
    from repro_torch.kernels import flash_attention as fa
    call = _SHARD.pop("flash_call", None)
    if call is None:
        return None
    q, k, v, kw = call
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    return {"shape": [tuple(q.shape), tuple(k.shape)],
            "max_abs_err": _flash_err(got, want, FLASH_TOL["bfloat16"])}


def _shard_rank_drop_serving() -> None:
    _SHARD.pop("serve_params", None)
    _SHARD.pop("serve_mode", None)
    if _SHARD["device"].type == "cuda":
        import torch
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _moe_routing(forced=None):
    """``repro_torch.models.moe.route`` patched for the MoE pass: with
    ``forced`` (G, S, K) every call routes each token to those experts
    (the teacher-forced reference); either way each call's own top-k
    experts (the router's choice) are kept, on the host, in the list
    this yields."""
    from repro_torch.models import moe
    orig = moe.route
    seen = []

    def route(cfg, p, x, topk_idx=None):
        seen.append(moe.top_k(cfg, p, x)[1].cpu())
        if forced is not None:
            topk_idx = forced.to(x.device)
        return orig(cfg, p, x, topk_idx)
    moe.route = route
    try:
        yield seen
    finally:
        moe.route = orig


def _shard_rank_zoo_grads(cfg) -> dict:
    """A gradient pass of ``cfg`` on the mesh from the seeded params, laid
    out ``2d``; the gradients are kept for :func:`_shard_rank_zoo_errs`.
    Returns the loss, the seconds, the peak device memory and for a MoE
    the experts the router chose for this rank's groups: ``(index of its
    first group, (G_local, S, K))``."""
    import torch
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import batch_pspecs, distribute_tree
    from repro_torch.training.loop import _loss_and_grads
    dm, dev = _SHARD["mesh"], _SHARD["device"]
    vm = virtual_mesh(dm)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dp = map_leaves(lambda t: t.requires_grad_(True),
                    _init_sharded(cfg, SEED, dm))
    batch = {"tokens": _shard_tokens(cfg, dev, *_zoo_tokens(cfg), SEED + 4)}
    db = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm), dm)
    _shard_sync()
    t0 = time.perf_counter()
    with shctx.activate(dm), _moe_routing() as seen:
        loss, grads = _loss_and_grads(cfg, dp, db)
        loss = float(loss.full_tensor())
        grads = [g if g.placements == p.placements
                 else g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(leaves(grads), leaves(dp))]
    _shard_sync()
    out = {"grad_s": time.perf_counter() - t0, "loss": loss,
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None, "routes": None}
    if seen:
        # the groups split over ``data`` (mesh dimension 0) where they
        # divide; the recompute routes them again, the same
        local = seen[0]
        out["routes"] = (dm.get_coordinate()[0] * local.shape[0], local)
    del dp
    _SHARD["zoo_grads"] = grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _shard_rank_zoo_errs(ref: list) -> tuple:
    """``(sum of squared differences, sum of squares)`` of this rank's own
    regions of the kept gradients against the unsharded pass's ``ref``
    (whole tensors, on a card by CUDA IPC handle)."""
    import torch
    grads = _SHARD.pop("zoo_grads")
    num = den = 0.0
    for g, w in zip(grads, ref):
        index = _owned_region(g)
        if index is None:
            continue
        a, b = _sq_err(g.to_local(), w[index])
        num += a
        den += b
    del grads
    if _SHARD["device"].type == "cuda":
        torch.cuda.empty_cache()
    return num, den


def _zoo_reference_grads(cfg, device: str, routes=None) -> tuple:
    """:func:`_shard_rank_zoo_grads`' pass unsharded in this process, a
    MoE's tokens routed to the experts ``routes`` (G, S, K) gives: the
    loss, the gradients (whole tensors), the seconds and the experts its
    own router chose (``None`` without a MoE)."""
    import torch
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.models.model import init_params
    from repro_torch.training.loop import _loss_and_grads
    params = map_leaves(lambda t: t.requires_grad_(True), init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device))
    t0 = time.perf_counter()
    with _moe_routing(routes) as seen:
        loss, grads = _loss_and_grads(cfg, params, {"tokens": _shard_tokens(
            cfg, device, *_zoo_tokens(cfg), SEED + 4)})
    return (float(loss), leaves(grads), time.perf_counter() - t0,
            seen[0] if seen else None)


def _zoo_tokens(cfg) -> tuple:
    """The rows and tokens of a zoo gradient pass: the MoE's
    :data:`SHARD_MOE_BATCH` x :data:`SHARD_MOE_SEQ`, else
    :data:`SHARD_ZOO_BATCH` x :data:`SHARD_ZOO_SEQ`."""
    if cfg.arch_type == "moe":
        return SHARD_MOE_BATCH, SHARD_MOE_SEQ
    return SHARD_ZOO_BATCH, SHARD_ZOO_SEQ


def _shard_rank_close() -> None:
    _shard_rank_close_manager()
    _SHARD.clear()


def start_sharded_ranks(device: str, cfg, batch: int, seq: int,
                        grad_batch: int, grad_seq: int) -> tuple:
    """Phase 15's ranks spawned and set up (imports, the card, the mesh,
    the seeded state laid out): ``(group, {"spawn_s", "setup_s",
    "local_bytes"})``. The smoke runs it on a thread of its own while
    phase 14 runs."""
    from repro_torch.launch.spmd import SpmdGroup
    t0 = time.perf_counter()
    group = SpmdGroup(math.prod(SHARD_DIMS), device=device,
                      threads=None if device == "cuda" else 1,
                      timeout_s=600)
    info = {"spawn_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    try:
        setup = group.run(_shard_rank_setup, cfg, device, batch, seq,
                          grad_batch, grad_seq)
    except BaseException:
        group.close(force=True)
        raise
    info["setup_s"] = time.perf_counter() - t0
    info["local_bytes"] = [r["local_bytes"] for r in setup]
    return group, info


def _unsharded_reference(device: str, cfg, batch: int, seq: int,
                         grad_batch: int, grad_seq: int) -> dict:
    """The ranks' gradient pass and train step run unsharded in this
    process from the same seeded params: the losses, the gradients'
    global norms and the whole tensors :data:`SHARD_CMP` names; and the
    prefill of the gradient pass's batch (``prefill_logits``, on the
    host in fp32), which the modes of :data:`SHARD_MODES` but
    ``tp_zero1`` run."""
    import dataclasses

    import torch
    from repro_torch.core.tree import leaves, map_leaves
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         global_norm, init_opt_state)
    from repro_torch.serving.engine import make_prefill_step
    from repro_torch.training.loop import _loss_and_grads
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = map_leaves(lambda t: t.requires_grad_(True),
                        init_params(cfg, gen, device))
    opt = init_opt_state(params)
    grad_tokens = {"tokens": _shard_tokens(cfg, device, grad_batch,
                                           grad_seq, SEED + 3)}
    with torch.no_grad():
        logits, _caches = make_prefill_step(dataclasses.replace(
            cfg, max_decode_len=SHARD_DECODE_LEN))(params, grad_tokens)
    out = {"prefill_logits": logits.float().cpu()}
    del logits, _caches
    t0 = time.perf_counter()
    loss2, grads2 = _loss_and_grads(cfg, params, grad_tokens)
    out.update(grad_loss=float(loss2), grad2_norm=float(global_norm(grads2)),
               grads2=leaves(grads2))
    out["grad_s"] = time.perf_counter() - t0
    master_before = [t.clone() for t in leaves(opt["master"])]
    tokens = {"tokens": _shard_tokens(cfg, device, batch, seq, SEED + 1)}
    # the step under the dry run's counter, as each rank counts its own:
    # the work the ranks divide among them
    counter = TraceCounter((params, opt, tokens))
    t0 = time.perf_counter()
    with counter:
        loss, grads = _loss_and_grads(cfg, params, tokens)
        apply_updates(params, opt, grads, AdamWConfig())
    out["grad_norm"] = float(global_norm(grads))
    out["loss"] = float(loss)
    out["step_s"] = time.perf_counter() - t0
    out["counted"] = {"flops": float(counter.flops),
                      "peak_bytes": counter.peak_temp_bytes}
    out["delta"] = [t - b for t, b in zip(leaves(opt["master"]),
                                          master_before)]
    out["m"] = leaves(opt["m"])
    out["params"] = [t.detach() for t in leaves(params)]
    return out


def run_sharded_path(device: str, cfg, workdir: str, batch: int, seq: int,
                     grad_batch: int, grad_seq: int, prefill_batch: int,
                     prefill_len: int, started: tuple = None,
                     traced: dict = None, zoo: dict = None) -> dict:
    """Phase 15 on ``device`` (the CPU rehearses it at a smoke config):
    the unsharded gradient pass and step here, then the four ranks'
    sharded ones laid out ``2d``, saves and restores; this process
    restores the lazily saved step at world 1. Then the 2d decode cases
    (:func:`_sharded_decode`: the 2d prefill and decode,
    ``decode_kv_seq_shard``, long context) against the unsharded decode
    here, then :data:`SHARD_MODES` (:func:`_sharded_modes`: each mode's
    step against the same unsharded one; ``tp_zero1``'s save, restores and
    decode). Each rank counts its steps, its 2d and tp_zero1 prefill and
    first decode step with the dry run's counter, held exactly against
    ``traced`` (:func:`trace_sharded_steps`' record, traced here when
    ``None``). Then the ranks' gradient passes of ``zoo`` (name ->
    config; ``None``: :data:`SHARD_ZOO_PATTERNS` at full width) against
    the same passes unsharded here. ``started`` is
    :func:`start_sharded_ranks`' result (started here when ``None``).
    Fails on a mismatch; returns the report with every rank's
    launches."""
    import torch

    report = {}
    if traced is None:
        traced = trace_sharded_steps(cfg, batch, seq, prefill_batch,
                                     prefill_len)
        traced["modes"] = trace_sharded_modes(cfg, batch, seq, prefill_batch,
                                              prefill_len)
    report["traced"] = traced
    ref = _unsharded_reference(device, cfg, batch, seq, grad_batch,
                               grad_seq)
    report["unsharded_step_s"] = ref.pop("step_s")
    ref_counted = ref.pop("counted")
    report["unsharded_grad_s"] = ref.pop("grad_s")
    if device == "cuda":
        torch.cuda.empty_cache()

    world = math.prod(SHARD_DIMS)
    group, info = started or start_sharded_ranks(device, cfg, batch, seq,
                                                 grad_batch, grad_seq)
    report.update(info)
    with group:
        steps = group.run(_shard_rank_step)
        for k in ("step_s", "grad_s", "flash_in_grad", "rss"):
            report[k] = [r[k] for r in steps]
        _check_counted("train", [r["counted"] for r in steps],
                       traced["train"])
        report.update(_hold_step("sharded step", group, steps, ref))
        report["grad_norm"]["sum_over_data_control"] = abs(
            2 * report["grad_norm"]["sharded"] - ref["grad_norm"]) \
            / ref["grad_norm"]
        # saved beside the next step; committed and restored after the
        # decode cases, which the ranks run meanwhile
        saves = group.run(_shard_rank_save, workdir, True)
        refs = {}
        report["decode"] = _sharded_decode(
            device, cfg, group, prefill_batch, prefill_len,
            ("2d", "decode_kv_seq_shard", "long_context"), refs)
        pre = report["decode"].pop("ranks")["2d"]
        unsharded = report["decode"].pop("unsharded_counted")
        report["decode"].pop("launches_by_rank")
        log("sharded decode: " + "; ".join(
            f"{k} logits rel L2 max {max(v['rel_l2']):.3e}, k "
            f"{v['local_k'][0]}" for k, v in report["decode"].items()))
        group.run(_shard_rank_drop_serving)
        _check_counted("prefill", [r["counted_prefill"] for r in pre],
                       traced["prefill"])
        _check_counted("decode", [r["counted_decode"] for r in pre],
                       traced["decode"])
        report["work"] = _sharded_work(world, steps, pre, ref_counted,
                                       unsharded)
        report.update(_sharded_save_restore(device, cfg, group, workdir,
                                            SHARD_ELASTIC_DIMS, None, saves))
        report["modes"] = _sharded_modes(
            device, cfg, group, os.path.join(workdir, "modes"), ref,
            ref_counted, unsharded, refs, traced["modes"],
            traced["train"]["collectives"]["counts"], prefill_batch,
            prefill_len)
        report["launches_by_rank"] = report["modes"].pop("launches_by_rank")
        # a check's launch, after the main path's counts were read
        report["local_flash"] = group.run(_shard_rank_local_flash)[0]
        del ref, refs
        if device == "cuda":
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
        report["zoo"] = _sharded_zoo_grads(device, group, zoo or {
            name: _zoo_cfg(name, len(p), p)
            for name, p in SHARD_ZOO_PATTERNS.items()})
        group.run(_shard_rank_close)
    report["prefill"] = [{k: v for k, v in r.items()
                          if k not in ("launches", "counted_prefill",
                                       "counted_decode")}
                         for r in pre]
    return report


def _hold_step(what: str, group, steps: list, ref: dict) -> dict:
    """The ranks' step (and gradient pass, where they ran one) against the
    unsharded run's ``ref``: the loss and the gradients' global norm,
    alike on every rank, within :data:`SHARD_LOSS_RTOL`; each rank's own
    regions (:func:`_shard_rank_errs`) of the gradients and the first
    moment within :data:`SHARD_GRAD_RTOL`, of the update within
    :data:`SHARD_UPDATE_RTOL`, of the params within
    :data:`SHARD_PARAM_RTOL` (``params_before`` is logged, the control: a
    step that left the params as they were reads 1 on the update)."""
    import torch
    out = {}
    # the scalars: every rank holds the same; the gradients' global norm
    # sees their scale, which AdamW's clipped, normalised first step does
    # not (a sum over ``data`` for its mean reads 1 in 2d)
    for k in ("loss", "grad_loss", "grad_norm", "grad2_norm"):
        if k not in steps[0]:
            continue
        got = {r[k] for r in steps}
        if len(got) != 1:
            fail(f"{what}: the ranks disagree on the {k}: {got}")
        got = got.pop()
        err = abs(got - ref[k]) / abs(ref[k])
        out[k] = {"sharded": got, "unsharded": ref[k], "rel_err": err,
                  "rtol": SHARD_LOSS_RTOL}
        if not math.isfinite(got) or not err <= SHARD_LOSS_RTOL:
            fail(f"{what}: {k} {got} against {ref[k]} unsharded (rtol "
                 f"{SHARD_LOSS_RTOL})")
    cmp = [(n, k) for n, k in SHARD_CMP
           if n != "grads2" or "grad_loss" in steps[0]]
    import torch.multiprocessing  # noqa: F401 — CUDA tensors by handle
    errs = group.run(_shard_rank_errs, {k: ref[k] for _n, k in cmp})
    if torch.cuda.is_available():
        torch.cuda.ipc_collect()
    rel = out["rel_l2"] = {
        name: math.sqrt(sum(e[name][0] for e in errs)
                        / sum(e[name][1] for e in errs))
        for name, _k in cmp}
    limits = out["rel_l2_rtol"] = {
        name: rtol for name, rtol in (
            ("grads2", SHARD_GRAD_RTOL), ("m", SHARD_GRAD_RTOL),
            ("delta", SHARD_UPDATE_RTOL), ("params", SHARD_PARAM_RTOL))
        if name in rel}
    for name, rtol in limits.items():
        if not rel[name] <= rtol:
            fail(f"{what}: {name}'s relative L2 error {rel[name]} against "
                 f"the unsharded run past {rtol}")
    return out


def _sharded_save_restore(device: str, cfg, group, root: str,
                          dims: tuple, mode: str, saves: list) -> dict:
    """The ranks' save under ``root`` (:func:`_shard_rank_save`, whose
    results ``saves`` are) committed, then step 2 restored by the ranks
    onto a ``dims`` mesh laid out by ``mode``'s rules (``None``: the
    state's own) while this process restores it at world 1; the world-1
    restore must equal, bit for bit, every rank's shard as the lazy save
    found it and every rank's elastic restore. Fails unless the rank
    files' bytes sum to the state's unique bytes (a leaf replicated over
    ranks written once)."""
    import torch
    from repro_torch.core import CheckpointManager
    from repro_torch.core.layout import FileReader
    from repro_torch.core.tree import leaves
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import init_opt_state
    for s, c in zip(saves, group.run(_shard_rank_commit)):
        s.update(c)
    out = {"saves": saves}
    tpl = {"model": init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)}
    tpl["optimizer"] = init_opt_state(tpl["model"])
    tpl["meta"] = {"step": 0, "arch": ""}
    group.start(_shard_rank_elastic, root, dims, mode)
    try:
        t0 = time.perf_counter()
        with CheckpointManager.from_policy(root, device=device) as mgr:
            got = mgr.restore(tpl, step=2)
        out["world1_restore_s"] = time.perf_counter() - t0
    finally:
        elastic = group.results()
    out["elastic"] = elastic
    if got["meta"]["step"] != 2 or any(r["meta"]["step"] != 2
                                       for r in elastic):
        fail(f"sharded save: restored meta {got['meta']}, onto {dims} "
             f"{[r['meta'] for r in elastic]}")
    restored = leaves({"model": got["model"], "optimizer": got["optimizer"]})
    del got, tpl
    bad = group.run(_shard_rank_check_restore, restored)
    if any(bad):
        fail(f"sharded save: the world-1 restore differs from the ranks' "
             f"shards or their restore onto {dims} ({mode or 'same'} "
             f"layout), by rank: {bad}")
    # bytes by rank: the unique shards, each written once
    sdir = os.path.join(root, "global_step2")
    rank_bytes = [sum(e.nbytes for e in FileReader(os.path.join(
        sdir, f"rank{r:05d}.dsllm")).tensors.values())
        for r in range(group.world)]
    unique = sum(t.numel() * t.element_size() for t in restored)
    out["bytes"] = {"by_rank": rank_bytes, "sum": sum(rank_bytes),
                    "unique": unique}
    del restored
    if device == "cuda":
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    if sum(rank_bytes) != unique:
        fail(f"sharded save: rank bytes {rank_bytes} sum to "
             f"{sum(rank_bytes)}, the unique shards are {unique}")
    return out


def _sharded_modes(device: str, cfg, group, workdir: str, ref: dict,
                   ref_counted: dict, serve_ref: dict, refs: dict,
                   traced: dict, plain_counts: dict, batch: int,
                   prompt_len: int) -> dict:
    """:data:`SHARD_MODES` on the ranks, in turn: the seeded state laid
    out again in the mode (:func:`_shard_rank_layout`), its prefill of
    the gradient pass's batch (:func:`_shard_rank_prefill`; but
    ``tp_zero1``) within :data:`SHARD_LOGIT_RTOL` of the unsharded
    prefill in ``ref``, and its train step, held as the 2d step is
    (:func:`_hold_step` against the same unsharded run ``ref``; the
    counted step equal to the mode's fake (2, 2) trace in ``traced``; its
    FLOPs within :data:`SHARD_WORK_MAX` of a world-th of the unsharded
    step's ``ref_counted``). Ulysses' counted collectives must hold more
    all-to-alls than the 2d step's ``plain_counts`` (on a cpu mesh more
    all-gathers), the sequence-parallel residual's more reduce-scatters.
    ``tp_zero1`` also saves
    under ``workdir`` lazily beside its next step, prefills and decodes
    against the unsharded decode in ``refs`` (its counted prefill and
    decode step equal to the trace, the prefill within
    :data:`SHARD_WORK_MAX` of the unsharded ``serve_ref``); after the
    last mode its save is committed and restored
    (:func:`_sharded_save_restore`: at world 1 and onto the 2d (2, 2)
    layout). Every rank must launch ``flash_attention`` in every mode's
    prefill. Returns by mode the report, and ``launches_by_rank`` at the
    end (the main path's)."""
    import dataclasses

    import torch
    world = math.prod(SHARD_DIMS)
    out = {}
    for name, kw in SHARD_MODES.items():
        c = dataclasses.replace(cfg, **{"sharding_mode": "2d", **kw})
        t0 = time.perf_counter()
        layout = group.run(_shard_rank_layout, c)
        case = {"layout_s": time.perf_counter() - t0,
                "local_bytes": [r["local_bytes"] for r in layout]}
        if name != "tp_zero1":
            pre = group.run(_shard_rank_prefill)
            err = _rel_l2(pre[0]["logits"], ref["prefill_logits"])
            case.update(prefill_s=[r["prefill_s"] for r in pre],
                        prefill_rel_l2=err, prefill_rtol=SHARD_LOGIT_RTOL,
                        prefill_flash=[r["flash"] for r in pre])
            if not all(r["finite"] for r in pre) \
                    or not err <= SHARD_LOGIT_RTOL:
                fail(f"sharded {name} prefill: logits' relative L2 error "
                     f"{err} against the unsharded prefill (rtol "
                     f"{SHARD_LOGIT_RTOL}), finite by rank "
                     f"{[r['finite'] for r in pre]}")
            if device == "cuda" and not all(case["prefill_flash"]):
                fail(f"sharded {name} prefill: flash_attention launches "
                     f"by rank {case['prefill_flash']}")
        steps = group.run(_shard_rank_step, False)
        what = f"sharded {name} step"
        _check_counted(f"{name} train", [r["counted"] for r in steps],
                       traced[name]["train"])
        case.update({k: [r[k] for r in steps]
                     for k in ("step_s", "peak_bytes")})
        case.update(_hold_step(what, group, steps, ref))
        coll = [r["counted"]["collectives"] for r in steps]
        case["work"] = [r["counted"]["flops"] / (ref_counted["flops"] / world)
                        for r in steps]
        case["collective_counts"] = coll[0]["counts"]
        for kind in ("all-gather", "all-to-all", "reduce-scatter"):
            case[f"{kind}_bytes"] = [x["by_kind"][kind] for x in coll]
        if not max(case["work"]) <= SHARD_WORK_MAX:
            fail(f"{what}: each rank's FLOPs over a {world}th of the "
                 f"unsharded step's read {case['work']}, past "
                 f"{SHARD_WORK_MAX}")
        # each flag's path shows in its collectives: Ulysses' exchange of
        # sequence for heads is an all-to-all on a card (a ``DTensor`` on
        # a cpu mesh takes an all-gather instead); the sequence-parallel
        # residual's row products reduce-scatter where 2d's all-reduce
        kind = {"ulysses": "all-to-all" if device == "cuda" else "all-gather",
                "seq_parallel": "reduce-scatter"}.get(name)
        if kind and not all(x["counts"][kind] > plain_counts[kind]
                            for x in coll):
            fail(f"{what}: counted collectives {[x['counts'] for x in coll]}"
                 f", {kind} no more than the 2d step's {plain_counts[kind]}:"
                 f" the flag's path did not run")
        if name == "tp_zero1":
            # saved lazily beside the next step; committed, restored and
            # checked after its decode, which the ranks run meanwhile
            case["saves"] = group.run(_shard_rank_save,
                                      os.path.join(workdir, name), False)
            dec = _sharded_decode(device, cfg, group, batch, prompt_len,
                                  (name,), refs)
            ranks = dec["ranks"][name]
            group.run(_shard_rank_drop_serving)
            _check_counted(f"{name} prefill",
                           [r["counted_prefill"] for r in ranks],
                           traced[name]["prefill"])
            _check_counted(f"{name} decode",
                           [r["counted_decode"] for r in ranks],
                           traced[name]["decode"])
            case["decode"] = dec[name]
            for kind in ("prefill", "decode"):
                case["decode"][f"{kind}_work"] = [
                    r[f"counted_{kind}"]["flops"]
                    / (serve_ref[kind]["flops"] / world) for r in ranks]
            case["decode"]["decode_all_gather_bytes"] = [
                r["counted_decode"]["collectives"]["by_kind"]["all-gather"]
                for r in ranks]
            if not max(case["decode"]["prefill_work"]) <= SHARD_WORK_MAX:
                fail(f"sharded {name} prefill: each rank's FLOPs over a "
                     f"{world}th of the unsharded prefill's read "
                     f"{case['decode']['prefill_work']}, past "
                     f"{SHARD_WORK_MAX}")
        out[name] = case
        if device == "cuda":
            torch.cuda.empty_cache()
    zero1 = out["tp_zero1"]
    t0 = time.perf_counter()
    zero1.update(_sharded_save_restore(
        device, cfg, group, os.path.join(workdir, "tp_zero1"), SHARD_DIMS,
        "2d", zero1["saves"]))
    zero1["check_s"] = time.perf_counter() - t0
    # the main path ends here: the launch counts by rank
    out["launches_by_rank"] = group.run(_launches)
    return out


def _sharded_decode(device: str, cfg, group, batch: int,
                    prompt_len: int, cases: tuple, refs: dict) -> dict:
    """Phase 15's decode ``cases`` (of :func:`_decode_cases`): for each,
    the unsharded prefill and greedy decode in this process (kept in
    ``refs`` by prompt and headroom: a later case of the same prompt in
    another layout takes the first of its tokens and logits), then the
    ranks' sharded prefill and decode teacher-forced with its tokens.
    Fails unless every logits lies within :data:`SHARD_LOGIT_RTOL`
    relative L2 error of the unsharded decode's, every rank's first k
    cache is laid out as :func:`_expected_local_cache` says and every
    rank launched ``flash_attention`` in the case; logs (no gate) the
    share of steps whose argmax agrees. Returns by case the errors, the
    layout and the seconds, the launch counts by rank after the last case
    and ``ranks``, each counted case's rank reports, with
    ``unsharded_counted``, the unsharded prefill's and first decode
    step's FLOPs."""
    import dataclasses

    import torch
    out = {"ranks": {}}
    for case in cases:
        kw, decode_len, rows, seed, _axis, n = _decode_cases(
            batch, prompt_len)[case]
        c = dataclasses.replace(cfg, **{"sharding_mode": "2d",
                                        "max_decode_len": decode_len, **kw})
        key = (decode_len, rows, seed)
        if key not in refs:
            count = {} if case == "2d" else None
            refs[key] = _decode_reference(c, device, rows, prompt_len, seed,
                                          n, count) + (count,)
            if device == "cuda":
                torch.cuda.empty_cache()
        steps, want, ref_s, count = refs[key]
        if steps.shape[1] < n:
            fail(f"sharded decode {case}: {n} steps against an unsharded "
                 f"decode of {steps.shape[1]}")
        steps, want = steps[:, :n], want[:n + 1]
        ranks = group.run(_shard_rank_decode, case, batch, prompt_len, steps)
        got = ranks[0]["logits"]
        errs = [_rel_l2(g, w) for g, w in zip(got, want)]
        agree = [bool(torch.equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1)))
                 for g, w in zip(got, want)]
        slots = ranks[0]["slots"]
        local = _expected_local_cache(case, rows, slots, c)
        out[case] = {"steps": n, "batch": rows, "slots": slots,
                     "rel_l2": errs, "rtol": SHARD_LOGIT_RTOL,
                     "argmax_agree": sum(agree) / len(agree),
                     "cache": ranks[0]["cache"],
                     "local_k": [r["cache"][1] for r in ranks],
                     "prefill_s": [r["prefill_s"] for r in ranks],
                     "decode_s": [r["decode_s"] for r in ranks],
                     "unsharded_s": ref_s}
        if len(got) != n + 1 or not all(r["finite"] for r in ranks):
            fail(f"sharded decode {case}: {len(got)} logits for {n} steps, "
                 f"finite by rank {[r['finite'] for r in ranks]}")
        if not max(errs) <= SHARD_LOGIT_RTOL:
            fail(f"sharded decode {case}: logits' relative L2 error by step "
                 f"{errs} against the unsharded decode (rtol "
                 f"{SHARD_LOGIT_RTOL})")
        for r, rank in enumerate(ranks):
            if rank["cache"][1] != local:
                fail(f"sharded decode {case}: rank {r} holds k "
                     f"{rank['cache']}, the layout gives {local}")
            if device == "cuda" and rank["flash"] == 0:
                fail(f"sharded decode {case}: rank {r} never launched "
                     f"flash_attention")
        out[case]["flash_by_rank"] = [r["flash"] for r in ranks]
        if "counted_prefill" in ranks[0]:
            out["ranks"][case] = [{k: v for k, v in r.items()
                                   if k != "logits"} for r in ranks]
            out["unsharded_counted"] = count
        out["launches_by_rank"] = [r["launches"] for r in ranks]
    return out


def _sharded_work(world: int, steps: list, pre: list, step_ref: dict,
                  serve_ref: dict) -> dict:
    """Each rank's counted FLOPs of the step, the 2d prefill and its first
    decode step over a ``world``-th of the same step counted unsharded
    (the reference's sharded program reads 1.00 on the step: GSPMD splits
    every product over the mesh), the step's all-gather bytes, peak bytes
    (the counter's live storage beyond the arguments) and seconds a rank,
    and the unsharded step's peak. Fails where the step or the prefill
    reads over :data:`SHARD_WORK_MAX`; decode has no gate."""
    out = {}
    for kind, ranks, ref in (
            ("step", [r["counted"] for r in steps], step_ref),
            ("prefill", [r["counted_prefill"] for r in pre],
             serve_ref["prefill"]),
            ("decode", [r["counted_decode"] for r in pre],
             serve_ref["decode"])):
        out[kind] = [r["flops"] / (ref["flops"] / world) for r in ranks]
        if kind != "decode" and not max(out[kind]) <= SHARD_WORK_MAX:
            fail(f"sharded work: each rank's {kind} FLOPs over a {world}th "
                 f"of the unsharded {kind}'s read {out[kind]}, past "
                 f"{SHARD_WORK_MAX}: the ranks repeat work the mesh should "
                 f"split")
    out["all_gather_bytes"] = [r["counted"]["collectives"]["by_kind"][
        "all-gather"] for r in steps]
    out["peak_bytes"] = [r["peak_bytes"] for r in steps]
    out["unsharded_peak_bytes"] = step_ref["peak_bytes"]
    out["step_s"] = [r["step_s"] for r in steps]
    return out


def _check_counted(kind: str, ranks: list, traced: dict) -> None:
    """Every rank's counted FLOPs, collectives (counts and bytes by kind)
    and per-kind op profile against the fake trace's, exactly."""
    want = {k: traced[k] for k in ("flops", "collectives", "profile")}
    for r, got in enumerate(ranks):
        if got != want:
            diff = {k: (got["profile"].get(k), want["profile"].get(k))
                    for k in set(got["profile"]) | set(want["profile"])
                    if got["profile"].get(k) != want["profile"].get(k)}
            keys = ("flops", "collectives")
            fail(f"sharded {kind}: rank {r} counted "
                 f"{json.dumps({k: got[k] for k in keys})}, the fake (2, 2) "
                 f"trace {json.dumps({k: want[k] for k in keys})}; op kinds "
                 f"that differ (rank, trace): {json.dumps(diff)}")


def _sharded_zoo_grads(device: str, group, cfgs: dict) -> dict:
    """The ranks' gradient passes of each config of ``cfgs`` against the
    same passes unsharded here, by relative L2 error over the whole tree
    (:data:`SHARD_GRAD_RTOL`); every rank must reach the end. A MoE's
    router picks its experts by a top-k, which a last-bit difference in
    its input flips, so the unsharded pass is teacher-forced: it routes
    each token to the experts the ranks' router chose (their
    probabilities still weigh them and carry the router's gradient), as
    the decode is teacher-forced with greedy tokens; the share of tokens
    for which its own router chose the same is logged, no gate."""
    import torch
    out = {}
    for name, cfg in cfgs.items():
        ranks = group.run(_shard_rank_zoo_grads, cfg)
        if len(ranks) != math.prod(SHARD_DIMS):
            fail(f"sharded {name}: {len(ranks)} ranks reached the end")
        routes = _gather_routes(name, [r["routes"] for r in ranks])
        loss, ref, ref_s, own = _zoo_reference_grads(cfg, device, routes)
        if device == "cuda":
            torch.cuda.empty_cache()
        errs = group.run(_shard_rank_zoo_errs, ref)
        del ref
        if device == "cuda":
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
        rel = math.sqrt(sum(e[0] for e in errs) / sum(e[1] for e in errs))
        losses = {r["loss"] for r in ranks}
        out[name] = {"rel_l2": rel, "rtol": SHARD_GRAD_RTOL,
                     "pattern": cfg.layer_groups[0][0],
                     "tokens": _zoo_tokens(cfg),
                     "loss": sorted(losses), "unsharded_loss": loss,
                     "grad_s": [r["grad_s"] for r in ranks],
                     "peak_bytes": [r["peak_bytes"] for r in ranks],
                     "unsharded_grad_s": ref_s}
        if routes is not None:
            same = (own.sort(-1).values == routes.sort(-1).values).all(-1)
            out[name]["routes_agree"] = float(same.double().mean())
        if not rel <= SHARD_GRAD_RTOL or len(losses) != 1:
            fail(f"sharded {name}: gradients' relative L2 error {rel} "
                 f"against the unsharded pass (rtol {SHARD_GRAD_RTOL}), "
                 f"losses {sorted(losses)}")
    return out


def _gather_routes(name: str, ranks: list):
    """The experts the ranks' router chose, (G, S, K), from each rank's
    ``(first group, local choice)`` (``None`` without a MoE); fails where
    two ranks routed the same group differently."""
    import torch
    if ranks[0] is None:
        return None
    n = max(first + local.shape[0] for first, local in ranks)
    full = torch.full((n,) + tuple(ranks[0][1].shape[1:]), -1,
                      dtype=ranks[0][1].dtype)
    for r, (first, local) in enumerate(ranks):
        block = full[first:first + local.shape[0]]
        if (block >= 0).any() and not torch.equal(block, local):
            fail(f"sharded {name}: rank {r} routed its groups unlike "
                 f"another rank holding them")
        block.copy_(local)
    routed = int((full >= 0).all(-1).all(-1).sum())
    if routed != n:
        fail(f"sharded {name}: the ranks routed {routed} of {n} groups")
    return full


def run_sharded_phase(cfg, path_launches: dict, card: str,
                      started=None, traced: dict = None) -> dict:
    """Phase 15 on the card; each rank zeroes its counts just before the
    main path (the step) and reads them just after (the last decode
    case); the sum over the ranks goes into ``path_launches``. ``card``
    (the card's name and power limit as ``nvidia-smi`` gives them) ends
    every line it logs. ``started``: a future of
    :func:`start_sharded_ranks` (``None``: start them here); ``traced``:
    phase 13's :func:`trace_sharded_steps` (``None``: trace here)."""
    import torch
    workdir = os.path.join(ROOT, "build", "chip_smoke_sharded")
    shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    # the four ranks share the card with this process: what earlier
    # phases left cached goes back first
    torch.cuda.empty_cache()
    host = {"rss": _rss_bytes(), "available": _mem_available_bytes()}
    _release_pinned()
    host.update(rss_released=_rss_bytes(),
                available_released=_mem_available_bytes())
    t0 = time.perf_counter()
    try:
        if started is not None:
            try:
                started = started.result()
            except BaseException as exc:  # noqa: BLE001 — the phase fails
                fail(f"sharded ranks did not start: {exc!r}")
        report = run_sharded_path("cuda", cfg, workdir, SHARD_BATCH,
                                  SHARD_SEQ, SHARD_GRAD_BATCH,
                                  SHARD_GRAD_SEQ, SHARD_PREFILL_BATCH,
                                  SHARD_PREFILL_SEQ, started, traced)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t0
    report["host_bytes"] = host
    by_rank = report["launches_by_rank"]
    for r, launches in enumerate(by_rank):
        for k in ("flash_attention", "checksum_u32"):
            if launches[k] == 0:
                fail(f"kernel {k} was never launched by rank {r} on the "
                     f"sharded path")
    for r, n in enumerate(report["flash_in_grad"]):
        if n == 0:
            fail(f"kernel flash_attention was never launched by rank {r} "
                 f"in the sharded gradient pass")
    path_launches["sharded"] = {k: sum(l[k] for l in by_rank)
                                for k in by_rank[0]}
    local = [report["local_flash"]] if report["local_flash"] else []
    if not local or not math.isfinite(local[0]["max_abs_err"]):
        fail(f"sharded prefill: rank 0's local attention against its "
             f"plain version: {local}")
    log(f"sharded path: {report['phase_s']:.1f} s after the ranks' spawn "
        f"{report['spawn_s']:.1f} s and setup {report['setup_s']:.1f} s "
        f"(those beside phase 13's traces and phase 14); "
        f"step by rank " + ", ".join(f"{s:.3f}" for s in report["step_s"])
        + f" s (unsharded {report['unsharded_step_s']:.3f} s); gradient "
        f"pass at {SHARD_GRAD_BATCH} x {SHARD_GRAD_SEQ} by rank " + ", ".join(
            f"{s:.3f}" for s in report["grad_s"])
        + f" s (unsharded {report['unsharded_grad_s']:.3f} s), its "
        f"flash_attention launches by rank {report['flash_in_grad']}; "
        + "; ".join(f"{k} {report[k]['sharded']:.6f} vs "
                    f"{report[k]['unsharded']:.6f} (rel "
                    f"{report[k]['rel_err']:.3e}, rtol "
                    f"{report[k]['rtol']:.3e})"
                    for k in ("loss", "grad_loss", "grad_norm", "grad2_norm"))
        + f"; grad norm's sum-over-data control "
        f"{report['grad_norm']['sum_over_data_control']:.3e}; rel L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in report["rel_l2"].items())
        + f" (rtol grads2 and m {SHARD_GRAD_RTOL:.3e}, delta "
        f"{SHARD_UPDATE_RTOL}, params {SHARD_PARAM_RTOL:.3e}; params_before"
        f" is the unchanged-step control, which reads 1 on delta) ({card})")
    tr = report["traced"]
    log("sharded collectives, counted by each rank's dry-run counter and "
        "equal on every rank to the fake (2, 2) trace: " + "; ".join(
            f"{k}: FLOPs {tr[k]['flops']:.6g} a device, counts "
            f"{json.dumps(tr[k]['collectives']['counts'])}, bytes "
            f"{json.dumps(tr[k]['collectives']['by_kind'])}, collective "
            f"term {tr[k]['collective_s'] * 1e3:.4f} ms (bound "
            f"{tr[k]['bound_s'] * 1e3:.4f} ms, {tr[k]['dominant']}; traced "
            f"in {tr[k]['trace_s']:.2f} s; {len(tr[k]['profile'])} op "
            f"kinds)" for k in ("train", "prefill", "decode"))
        + "; the step took " + ", ".join(f"{x:.3f}" for x in
                                         report["step_s"])
        + " s by rank, the prefill " + ", ".join(
            f"{r['prefill_s']:.3f}" for r in report["prefill"])
        + f" s ({card})")
    work = report["work"]
    log("sharded work: each rank's counted FLOPs over a quarter of the "
        "unsharded count (1.00 when the mesh splits every product; gate "
        f"{SHARD_WORK_MAX} on the step and the prefill, none on decode): "
        + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in work[k])
                    for k in ("step", "prefill", "decode"))
        + f" by rank; the step's all-gather bytes a rank "
        f"{work['all_gather_bytes']}, peak bytes a rank {work['peak_bytes']}"
        f" (unsharded {work['unsharded_peak_bytes']}), seconds a rank "
        + ", ".join(f"{x:.3f}" for x in work["step_s"]) + f" ({card})")
    log("sharded decode against the unsharded decode, teacher-forced with "
        "its greedy tokens: " + "; ".join(
            f"{k} (batch {v['batch']}, {v['slots']} slots, k {v['cache'][0]}"
            f" local {v['local_k'][0]}): {v['steps']} steps, logits rel L2 "
            f"max {max(v['rel_l2']):.3e} (rtol {v['rtol']:.3e}; by step "
            + ", ".join(f"{e:.2e}" for e in v["rel_l2"])
            + f"), argmax agrees on {v['argmax_agree']:.3f} (no gate); "
            f"prefill " + ", ".join(f"{x:.3f}" for x in v["prefill_s"])
            + " s and decode " + ", ".join(f"{x:.3f}" for x in v["decode_s"])
            + f" s by rank (unsharded prefill and decode "
            f"{v['unsharded_s']:.3f} s)" for k, v in report["decode"].items())
        + f" ({card})")
    log("sharded modes " + json.dumps(report["modes"]) + f" ({card})")
    log("sharded zoo gradient passes: " + "; ".join(
            f"{k} ({'/'.join(v['pattern'])}, {v['tokens'][0]} x "
            f"{v['tokens'][1]} tokens) rel L2 "
            f"{v['rel_l2']:.3e} (rtol {v['rtol']:.3e}), loss "
            f"{v['loss'][0]:.6f} vs {v['unsharded_loss']:.6f} unsharded, "
            "pass " + ", ".join(f"{x:.3f}" for x in v["grad_s"])
            + f" s by rank (unsharded {v['unsharded_grad_s']:.3f} s), "
            f"peak device bytes by rank {v['peak_bytes']}"
            + (f", the unsharded router's own choice agrees on "
               f"{v['routes_agree']:.4f} of the tokens (no gate; the pass "
               f"routes as the ranks did)" if "routes_agree" in v else "")
            for k, v in report["zoo"].items()) + f" ({card})")
    log(f"sharded host memory (GiB): this process resident "
        f"{host['rss'] / 2**30:.1f}, {host['rss_released'] / 2**30:.1f} "
        f"once its pinned cache went back (host available "
        f"{host['available'] / 2**30:.1f}, then "
        f"{host['available_released'] / 2**30:.1f}); each rank resident "
        f"after the gradient pass and after the step: " + "; ".join(
            "/".join(f"{b / 2**30:.1f}" for b in r) for r in report["rss"])
        + f" ({card})")
    log("sharded launches by rank: " + "; ".join(
        f"rank {r}: flash_attention {l['flash_attention']}, checksum_u32 "
        f"{l['checksum_u32']}" for r, l in enumerate(by_rank))
        + f"; rank 0's local attention {local[0]['shape']} max |diff| "
        f"{local[0]['max_abs_err']:.3e} (tol {FLASH_TOL['bfloat16']}) "
        f"({card})")
    log("sharded saves by rank: " + "; ".join(
        f"rank {r}: blocking {s['blocking']['save_s']:.3f} s (persist "
        f"{s['blocking']['persist_s']:.3f}), lazy prologue "
        f"{s['lazy']['prologue_s']:.3f} s, capture stall "
        f"{s['lazy']['capture_stall_s']:.3f} s, persist "
        f"{s['persist_s']:.3f} s" for r, s in
        enumerate(report["saves"]))
        + f"; bytes by rank {report['bytes']['by_rank']} (sum "
        f"{report['bytes']['sum']} = unique {report['bytes']['unique']}); "
        f"world-1 restore {report['world1_restore_s']:.3f} s; elastic "
        f"(1 x 4) restore by rank " + ", ".join(
            f"{r['restore_s']:.3f}" for r in report["elastic"])
        + f" s ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    return report


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

    # -- phases 12d and 12e: the zoo's last configs (slice 22) ------------
    log("zoo last report " + json.dumps(run_zoo_last_phase(path_launches))
        + f" ({smi})")

    # phase 15's four ranks spawn and set up (about 26 s of imports, CUDA
    # start-up and their seeded state) on a thread of their own once phase
    # 13's steps are timed, while its sharded traces and phase 14 run
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(1)
    started = []

    def start() -> None:
        _release_pinned()
        started.append(pool.submit(start_sharded_ranks, "cuda", cfg,
                                   SHARD_BATCH, SHARD_SEQ, SHARD_GRAD_BATCH,
                                   SHARD_GRAD_SEQ))

    # -- phase 13: the dry run against the card (slices 15, 18) -----------
    dry = run_dryrun_phase(cfg, path_launches, smi, start)
    log("dryrun report " + json.dumps(dry))

    # -- phase 14: the examples (slice 16) --------------------------------
    log("examples report " + json.dumps(run_examples_phase(path_launches)))

    # -- phase 15: sharded model compute (slices 17-21) -------------------
    log(f"sharded report " + json.dumps(run_sharded_phase(
        cfg, path_launches, smi, started[0], dry["sharded_trace"]))
        + f" ({smi})")
    pool.shutdown()

    log(f"smoke: {time.perf_counter() - t_start:.1f} s from start to the "
        f"end of every phase (1-15; phase 10 runs after 6)")
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

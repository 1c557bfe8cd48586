"""Build variants of a kernel source and time them on the card.

    python -m repro_torch.kernels.variants [variants.json]
    python -m repro_torch.kernels.variants stream [variants.json]
    python -m repro_torch.kernels.variants checksum [variants.json]
    python -m repro_torch.kernels.variants int8 [variants.json]
    python -m repro_torch.kernels.variants int8path CHECKOUT [CHECKOUT ...]
    python -m repro_torch.kernels.variants xor [variants.json]
    python -m repro_torch.kernels.variants deltapath CHECKOUT[:SHARE] ...
    python -m repro_torch.kernels.variants attnpath CHECKOUT [CHECKOUT ...]

A variant is a list of ``[old, new]`` text substitutions applied to one
source under ``csrc/`` (each ``old`` must occur in it). Each variant is
built into a library of its own under ``build/repro_torch/variants/``
with the flags of :mod:`.build`, its ptxas lines are printed, its output
is held against the plain version, and then every variant that agrees
(and every one whose name starts with ``x_``: an ablation that removes
work and cannot agree) is timed in alternating rounds beside one PyTorch
call that computes the same function. The SM clock is sampled with
``nvidia-smi`` while the rounds run. The last line is a JSON object of
the times (ms) per variant. Times are comparable only within one run.

Attention (the default): variants of ``csrc/flash_attention.cu``, checked
against :func:`.flash_attention.flash_attention_plain` at a few bf16
shapes (hd 64 and 128) and timed with CUDA events at the serving shape
(B 2, S 4,096, 32/8 heads, hd 64, causal) and at gemma3-27b's (32/16
heads, hd 128; keys ``hd128_...``), each beside
``scaled_dot_product_attention``.
Without a file it runs :data:`ABLATIONS`: the shipped kernel, two
consumer warpgroups at hd 64, two ring stages at hd 64 and three at hd
128, the epilogue without its row-stats code (``no_row_stats``), the
softmax's exponentials held ahead of the P V wait (``p_before_wait``,
``volatile_ex2``), and the same kernel with one part of its work
removed at a time, to show which part holds it back.

``stream``: variants of ``csrc/ckpt_kernels.cu``'s streaming core
(``ckpt_delta_xor``, ``ckpt_downcast_bf16``, ``ckpt_delta_f32``), checked
bit for bit against ``delta_xor_plain``, the plain downcast and
``delta_f32_plain`` at lengths around every variant's tile (with
:data:`.quantize.EDGE_BITS` in the inputs, and an input sliced at a
4-byte offset) and at the main path's shapes, then timed there:
``delta_xor`` at 16,777,216 words beside ``torch.bitwise_xor``,
``delta_f32`` at as many values beside ``torch.sub``, ``downcast_bf16``
at 128,256 x 2,048 fp32 beside ``x.to(torch.bfloat16)``. Each is timed
twice: the wrapper, back to back under CUDA events, and the device alone,
the kernels' own time under ``torch.profiler`` (:func:`device_ms`).
Without a file it runs :data:`STREAM_ABLATIONS`: ``loop``, the
grid-stride loop the three kernels ran before the core (one load in
flight a thread, a grid of at most 132 x 8 blocks); 1, 2, 4 and 8 loads
in flight per thread and input; 256 threads a block against 512; each
kind of cache hint; a grid-stride loop over 132 x 4 blocks against one
pass; and design (B), bulk copies through shared memory. The summary
gives the median of the rounds.

``checksum``: variants of the segmented digest (``ckpt_checksum_u32``,
``ckpt_checksum_u32_segments``), checked bit for bit against the plain
versions at :data:`CHECKSUM_SIZES` (one segment) and
:data:`CHECKSUM_CASES` (segments), then timed as ``stream`` times, at one
4 MiB chunk and at one 64 MiB piece of 16 chunks. No PyTorch call
computes the digest. Without a file it runs :data:`CHECKSUM_ABLATIONS`:
clusters of 16 blocks against 8, 2 and 8 loads in flight a thread
against 4, and ``atomic_loop``, the design it replaced (per segment one
launch of a grid-stride loop with an atomic a block, after a memset of
the digests).

``int8``: variants of the segmented int8 pair
(``ckpt_quantize_checksum_int8_segments``,
``ckpt_dequantize_checksum_int8_segments`` and their one-segment entries),
checked bit for bit against the plain versions (payloads, digests and
decoded rows) at :data:`INT8_CASES`, with :data:`.quantize.EDGE_BITS`,
an all-zero row and a row of rounding ties in the first and the last
segment, and the one-segment entries at :data:`INT8_ROWS`; then timed as
``checksum`` times, at one 4 MiB chunk (4,096 rows) and one 64 MiB piece
of 16 chunks. No PyTorch call quantizes with a digest. Without a file it
runs :data:`INT8_ABLATIONS`: the encode with 2 and 4 rows a warp in
flight against 1, the decode with 1 and 4 against 2, 256 and 1,024
threads a block against 512, encode clusters of 8 blocks
against 16 and decode clusters of 16 against 8, ``tail_inline`` (the
loader of a row the valid bytes cut, inlined into the row loop), and
``atomic_loop``, the design it replaced (a memset of the digests, then
per segment one launch of a grid-stride loop, one warp a row, one atomic
a block).

``int8path``: the int8q save and resume path end to end, for checkouts
of this repository (directories holding ``chip_smoke.py`` and
``src/repro_torch``; another commit goes there through ``git archive``)
in turns, each run in a process of its own that imports only that
checkout: ``chip_smoke.py``'s training phase (6 steps of llama3.2-1b at
full width, 2 layers, saves at 2, 4 and 6 with the fp32 optimizer state
quantized to int8, then the resume of step 6). A line ``int8path`` with
a JSON object per run: the phase's wall time, the summed ``encode.int8``
span time a save, the resume's read time, the peak device memory and
the int8 pair's launches.

``xor``: variants of the segmented XOR digest (``ckpt_xor_checksum_u32``,
``ckpt_xor_checksum_u32_segments``), checked bit for bit (deltas and each
segment's digest) against the plain versions at :data:`XOR_SIZES` (one
segment) and :data:`XOR_CASES` (segments, byte tails), then timed as
``checksum`` times at one 4 MiB chunk, the delta provider's piece of 8
chunks and a 64 MiB piece of 16. No PyTorch call computes the XOR with a
digest. Without a file it runs :data:`XOR_ABLATIONS`: clusters a launch
aims at (1 a segment, 8, 32 against 16), clusters of 16 blocks against 8,
1 and 4 loads in flight a thread and input against 2, and
``atomic_loop``, the design it replaced (a memset of the digests, then
per segment one launch of the grid-stride loop with an atomic a block).

``attnpath``: the attention kernel of checkouts of this repository
(directories holding ``src/repro_torch``) in turns, the order given and
then reversed, each in a process of its own that imports only that
checkout, builds its library and times its ``flash_attention_cuda`` at
:data:`SERVE` (hd 64, bf16, causal) and :data:`SERVE_128` (hd 128) as
``attention_main`` times a
variant: :data:`ROUNDS` rounds of :data:`REPS` back-to-back calls under
CUDA events, each round beside ``scaled_dot_product_attention``, then
the kernel's device time under ``torch.profiler``. A line ``attnpath``
with a JSON object per run and head width, and the run's ptxas lines of
the bf16 body.

``deltapath``: the checkpoint phase of ``chip_smoke.py`` (K, Δ, Δ saves of
llama3.2-1b at full width, 2 layers, then the restores of steps 3 and 1)
for checkouts of this repository in turns, as ``int8path`` runs them,
each in a process of its own. ``CHECKOUT:SHARE`` sets the delta
provider's ``DELTA_BUDGET_SHARE`` there first (a piece takes at most
1/SHARE of the encode budget: 2, 4 or 8 gives 8, 4 or 2 chunks of
4 MiB). A line ``deltapath`` with a JSON object per run: the
``encode.delta`` span time and span count of each delta save, its persist
time, the phase's wall time, the launches of the XOR digest,
``delta_xor`` and the digest, and the peak device memory.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

from . import build

EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
QK = "    wgmma_qk(s, dq + hq + 2 * (kk % 4), dk + hk + 2 * (kk % 4), kk);"
PV = "      wgmma_pv(o[h], pa[c], dvh + 128 * c);"
SOFTMAX_FIRST = (
    "      online_softmax(s, (t0 + first) * kTileK, t, whole(first), "
    "p.scale_log2,\n                     r, al_a, al_b);")
SOFTMAX_NEXT = (
    "        online_softmax(s, (t0 + it) * kTileK, t, whole(it), "
    "p.scale_log2, r,\n                       al_a, al_b);")
PACK = "pack_p(pa, s);"
KV_LOADS = """        mbar_expect_tx(bar_k + 8 * s, kTileBytes);
        tma_load_tile<HD>(base + kSmemK + s * kTileBytes, C::kHalfBytes,
                          &tm_k, bar_k + 8 * s, kvh, jb, b);
        mbar_expect_tx(bar_v + 8 * s, kTileBytes);
        tma_load_tile<HD>(base + kSmemV + s * kTileBytes, C::kHalfBytes,
                          &tm_v, bar_v + 8 * s, kvh, jb, b);"""
NO_EX2 = [[EX2, "  y = x;"]]
NO_PRODUCTS = [[QK, "    ;"], [PV, "      ;"]]
NO_SOFTMAX = [[SOFTMAX_FIRST, "al_a = al_b = 1.f;"],
              [SOFTMAX_NEXT, "al_a = al_b = 1.f;"], [PACK, ";"]]
NO_KV_LOADS = [[KV_LOADS, "        mbar_arrive(bar_k + 8 * s);\n"
                          "        mbar_arrive(bar_v + 8 * s);"]]
STATS_STORE = """      if (t == 0) {
        store_stats(p, b, h, ia, r.m_a, l_a);
        store_stats(p, b, h, ia + 8, r.m_b, l_b);
      }
"""
ATTENTION = "flash_attention.cu"
STREAM = "ckpt_kernels.cu"

#: the shipped kernel and ablations of it
ABLATIONS = {
    "kernel": [],
    "two_consumers": [["kConsumers = HD == 64 ? 3 : 2;",
                       "kConsumers = 2;"]],
    "two_stages": [["kStages = HD == 64 ? 3 : 2;", "kStages = 2;"]],
    # three stages at hd 128 too (at hd 256 they pass a CTA's shared
    # memory)
    "three_stages": [["kStages = HD == 64 ? 3 : 2;",
                      "kStages = HD == 256 ? 2 : 3;"]],
    "no_row_stats": [[STATS_STORE, ""]],
    # the softmax's exponentials kept ahead of the P V wait (the compiler
    # may sink them past it): by a hold on p, or by volatile ex2
    "p_before_wait": [[SOFTMAX_NEXT, SOFTMAX_NEXT + "\n        hold(s);"]],
    "volatile_ex2": [['  asm("ex2.', '  asm volatile("ex2.']],
    "x_no_ex2": NO_EX2,
    "x_no_products": NO_PRODUCTS,
    "x_no_softmax": NO_SOFTMAX,
    "x_loads_only": NO_PRODUCTS + NO_SOFTMAX,
    "x_nothing": NO_PRODUCTS + NO_SOFTMAX + NO_KV_LOADS,
}
#: bf16 (B, S, T, H, KV, kind, window, chunk, hd) each variant must agree
#: at
CHECKS = ((1, 128, 128, 1, 1, "full", 0, 0, 64),
          (2, 129, 129, 4, 2, "full", 0, 0, 64),
          (2, 300, 200, 32, 8, "window", 32, 0, 64),
          (2, 2100, 2100, 32, 8, "chunked", 0, 192, 64),
          (2, 4096, 4096, 32, 8, "full", 0, 0, 64),
          (2, 300, 200, 32, 16, "window", 32, 0, 128),
          (2, 4096, 4096, 32, 16, "full", 0, 0, 128),
          (2, 4096, 4096, 32, 16, "window", 1024, 0, 128),
          (2, 300, 200, 10, 1, "window", 32, 0, 256),
          (2, 4096, 4096, 8, 1, "full", 0, 0, 256))
SERVE = (2, 4096, 32, 8)  # B, S, H, KV
#: gemma3-27b's prefill (B, S, H, KV) at hd 128, causal, where each
#: variant is timed too
SERVE_128 = (2, 4096, 32, 16)
ROUNDS, REPS = 2, 300


def variant_source(subs, source: str = ATTENTION) -> str:
    """The source ``csrc/<source>`` with the substitutions applied."""
    text = (build.CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"not in {source}: {old!r}")
        text = text.replace(old, new)
    return text


def _build(name: str, subs, source: str = ATTENTION,
           entries=("flash_fwd_bf16",)):
    """(ctypes library, ptxas lines of the kernels whose mangled names
    hold one of ``entries``: registers, spills and performance notes such
    as serialised wgmma) of one variant."""
    root = build.BUILD_DIR / "variants" / \
        ("stream" if source == STREAM else "") / name
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for src in build.SOURCES:
        (csrc / src.name).write_text(
            variant_source(subs, source) if src.name == source
            else src.read_text())
    saved = build.CSRC, build.SOURCES, build.BUILD_DIR, build._lib
    try:
        build.CSRC = csrc
        build.SOURCES = tuple(csrc / s.name for s in saved[1])
        build.BUILD_DIR = root / "lib"
        build._lib = None
        lib_path = build.build()
        lib = build.library()
    finally:
        build.CSRC, build.SOURCES, build.BUILD_DIR, build._lib = saved
    lines, on = [], False
    for line in build.ptxas_report(lib_path).read_text().splitlines():
        if "Compiling entry" in line:
            on = any(e in line for e in entries)
        elif on and any(x in line for x in ("registers", "spill", "C75")):
            lines.append(line.strip())
    return lib, lines


def _agrees(torch, fa, case) -> float:
    B, S, T, H, KV, kind, window, chunk, hd = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S * 7 + T)
    q, k, v = (torch.randn(B, n, h, hd, device="cuda", generator=gen)
               .to(torch.bfloat16) for n, h in ((S, H), (T, KV), (T, KV)))
    got = fa.flash_attention_cuda(q, k, v, kind=kind, window=window,
                                  chunk=chunk).float()
    want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                    chunk=chunk).float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) \
            or bool((diff > 2e-2 + 2e-2 * want.abs()).any()):
        return float("inf")
    return float(diff.max())


def _time_ms(torch, fn, reps: int = REPS) -> float:
    """One call of ``fn`` over ``reps`` back-to-back calls, CUDA events."""
    for _ in range(5):
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


def device_ms(torch, fn, reps: int, tries: int = 3, per_call: int = 1
              ) -> float:
    """Device time of one call of ``fn``, which must launch ``per_call``
    device operations a call: ``per_call`` times the mean self time of the
    device events (kernels, copies, fills) that ``torch.profiler`` records
    over ``reps`` back-to-back calls. Host time between launches is left
    out. The profiler can drop records, so the mean is over the records it
    kept (dividing by ``reps`` would read low); a session that kept none
    is run again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n:
            return sum(e.self_device_time_total for e in events) / n \
                * per_call / 1e3
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{tries} sessions")


def _smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _sample_clocks():
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)


def _print_clocks(clocks) -> None:
    clocks.terminate()
    mhz = [float(x) for x in clocks.communicate()[0].split() if x]
    print(f"clocks.sm MHz {min(mhz, default=0)}-{max(mhz, default=0)}",
          flush=True)


def attention_main(args) -> None:
    import torch

    from . import flash_attention as fa
    variants = json.loads(Path(args[0]).read_text()) if args else ABLATIONS
    print(_smi_line(), flush=True)
    libs = {}
    for name, subs in variants.items():
        lib, ptxas = _build(name, subs)
        build._lib = lib
        errs = [_agrees(torch, fa, case) for case in CHECKS]
        print(f"{name}: {' | '.join(ptxas)}; max |diff| {errs}", flush=True)
        if name.startswith("x_") or max(errs) < float("inf"):
            libs[name] = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    calls = {}  # tag -> (q, k, v, SDPA's q, k, v)
    for tag, (B, S, H, KV), hd in (("", SERVE, 64), ("hd128_", SERVE_128,
                                                      128)):
        q, k, v = (torch.randn(B, S, h, hd, device="cuda", generator=gen)
                   .to(torch.bfloat16) for h in (H, KV, KV))
        calls[tag] = (q, k, v, *(x.transpose(1, 2) for x in (q, k, v)))
    clocks = _sample_clocks()
    times = {f"{tag}{name}": [] for tag in calls for name in [*libs, "sdpa"]}
    try:
        for _ in range(ROUNDS):
            for tag, (q, k, v, qt, kt, vt) in calls.items():
                for name, lib in libs.items():
                    build._lib = lib
                    times[tag + name].append(_time_ms(
                        torch, lambda: fa.flash_attention_cuda(q, k, v)))
                times[tag + "sdpa"].append(_time_ms(
                    torch,
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)))
    finally:
        build._lib = None
        _print_clocks(clocks)
    print(json.dumps(times), flush=True)


# ------------------------------------------------------- streaming core
_HINTS = "constexpr int kStreamHints = 1;"
_VECS = "constexpr int kStreamVecs = 2;"
_THREADS = "constexpr int kStreamThreads = 512;"
_TMA = "constexpr bool kStreamTma = false;"
_TMA_ON = [[_TMA, "constexpr bool kStreamTma = true;"]]
#: the kernels the streaming core replaced (one 16-byte load in flight per
#: thread, a grid-stride loop over at most 132 x 8 blocks, 64-bit indices,
#: no cache hints), put back in its place
LOOP_KERNELS = """
__global__ void __launch_bounds__(kThreads)
loop_xor_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 int64_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b);
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out);
  for (int64_t j = tid; j < n4; j += stride) {
    const uint4 u = a4[j];
    const uint4 v = b4[j];
    o4[j] = make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride) out[i] = a[i] ^ b[i];
}

__global__ void __launch_bounds__(kThreads)
loop_downcast_kernel(const uint32_t* __restrict__ x, int64_t n,
                      uint16_t* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const uint4* __restrict__ x4 = reinterpret_cast<const uint4*>(x);
  uint2* __restrict__ o2 = reinterpret_cast<uint2*>(out);
  for (int64_t j = tid; j < n4; j += stride) {
    const uint4 v = x4[j];
    o2[j] = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                       bf16_bits(v.z) | (bf16_bits(v.w) << 16));
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride)
    out[i] = static_cast<uint16_t>(bf16_bits(x[i]));
}

__global__ void __launch_bounds__(kThreads)
loop_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int64_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const float4* __restrict__ a4 = reinterpret_cast<const float4*>(a);
  const float4* __restrict__ b4 = reinterpret_cast<const float4*>(b);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
  for (int64_t j = tid; j < n4; j += stride) {
    const float4 u = a4[j];
    const float4 v = b4[j];
    o4[j] = make_float4(sub_flushed(u.x, v.x), sub_flushed(u.y, v.y),
                        sub_flushed(u.z, v.z), sub_flushed(u.w, v.w));
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride)
    out[i] = sub_flushed(a[i], b[i]);
}

}  // namespace
"""
LOOP = [
    ["}  // namespace\n", LOOP_KERNELS],
    ["  return launch_stream<XorOp>(a, b, out, n, stream);",
     "  loop_xor_kernel<<<blocks_for(n), kThreads, 0,\n"
     "                     static_cast<cudaStream_t>(stream)>>>(\n"
     "      static_cast<const uint32_t*>(a),\n"
     "      static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out),"
     " n);\n"
     "  return static_cast<int>(cudaGetLastError());"],
    ["  return launch_stream<Bf16Op>(x, nullptr, out, n, stream);",
     "  loop_downcast_kernel<<<blocks_for(n), kThreads, 0,\n"
     "                          static_cast<cudaStream_t>(stream)>>>(\n"
     "      static_cast<const uint32_t*>(x), n,\n"
     "      static_cast<uint16_t*>(out));\n"
     "  return static_cast<int>(cudaGetLastError());"],
    ["  return launch_stream<F32SubOp>(a, b, out, n, stream);",
     "  loop_f32_kernel<<<blocks_for(n), kThreads, 0,\n"
     "                     static_cast<cudaStream_t>(stream)>>>(\n"
     "      static_cast<const float*>(a), static_cast<const float*>(b),\n"
     "      static_cast<float*>(out), n);\n"
     "  return static_cast<int>(cudaGetLastError());"]]
#: the shipped streaming core, the loop it replaced, and variants of the
#: core
STREAM_ABLATIONS = {
    "stream": [],
    "loop": LOOP,
    "vecs1": [[_VECS, "constexpr int kStreamVecs = 1;"]],
    "vecs4": [[_VECS, "constexpr int kStreamVecs = 4;"]],
    "vecs8": [[_VECS, "constexpr int kStreamVecs = 8;"]],
    "threads256": [[_THREADS, "constexpr int kStreamThreads = 256;"]],
    "no_hints": [[_HINTS, "constexpr int kStreamHints = 0;"]],
    "ldcs_stcs": [[_HINTS, "constexpr int kStreamHints = 2;"]],
    "l2_prefetch": [[_HINTS, "constexpr int kStreamHints = 3;"]],
    "grid_stride": [["constexpr int kStreamBlocksPerSm = 0;",
                     "constexpr int kStreamBlocksPerSm = 4;"]],
    "tma": _TMA_ON,
    "tma_3stages": _TMA_ON + [["constexpr int kTmaStages = 4;",
                               "constexpr int kTmaStages = 3;"]],
    "tma_tile1024": _TMA_ON + [["constexpr int kTmaTileVecs = 512;",
                                "constexpr int kTmaTileVecs = 1024;"]],
}
#: word counts the stream variants must agree at: 1-5, one short of, on
#: and one past every variant's tile (1,024 to 8,192 words), a length
#: whose last tile is partial, an odd one, and the fold piece
STREAM_SIZES = (1, 3, 4, 5, 1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096,
                4097, 8191, 8192, 8193, 10 * 4096 + 1030, 65_537, 1 << 24)
#: the main path's shapes: the fold piece and llama3.2-1b's embedding
XOR_WORDS, DOWNCAST_SHAPE = 1 << 24, (128_256, 2048)
STREAM_ROUNDS, STREAM_REPS, DEVICE_REPS = 3, 100, 20
HBM_BYTES_PER_S = 3.35e12


def _stream_inputs(torch, tq, n: int, gen):
    """Two seeded word tensors of length ``n`` with :data:`EDGE_BITS` in
    front of the first and, rolled, of the second."""
    a, b = (torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                          device="cuda", generator=gen) for _ in range(2))
    edge = tq.edge_values("cuda").view(torch.int32)
    k = min(n, edge.numel())
    a[:k] = edge[:k]
    b[:k] = edge.roll(5)[:k]
    return a, b


def stream_disagreement(torch):
    """None if the loaded library's ``delta_xor`` and ``downcast_bf16``
    give the plain versions' bits at every check, else where not."""
    from . import delta, quantize as tq
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def same(x, y):
        return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.view(torch.int16 if x.element_size() == 2 else torch.int32),
            y.view(torch.int16 if y.element_size() == 2 else torch.int32))

    for n in STREAM_SIZES:
        a, b = _stream_inputs(torch, tq, n, gen)
        if not same(delta.delta_xor_cuda(a, b), delta.delta_xor_plain(a, b)):
            return f"delta_xor at {n} words"
        x, y = a.view(torch.float32), b.view(torch.float32)
        if not same(tq.downcast_bf16_words_cuda(x),
                    tq.downcast_bf16_words_plain(x)):
            return f"downcast_bf16 at {n} words"
        if not same(delta.delta_f32_cuda(x, y), delta.delta_f32_plain(x, y)):
            return f"delta_f32 at {n} values"
    # sliced at a 4-byte offset: the wrappers clone to 16-byte alignment
    a, b = _stream_inputs(torch, tq, 4097 + 1, gen)
    a, b = a[1:], b[1:]
    if not same(delta.delta_xor_cuda(a, b), delta.delta_xor_plain(a, b)):
        return "delta_xor at a 4-byte offset"
    x, y = a.view(torch.float32), b.view(torch.float32)
    if not same(delta.delta_f32_cuda(x, y), delta.delta_f32_plain(x, y)):
        return "delta_f32 at a 4-byte offset"
    if not same(tq.downcast_bf16_words_cuda(a.view(torch.float32)),
                tq.downcast_bf16_words_plain(a.view(torch.float32))):
        return "downcast_bf16 at a 4-byte offset"
    for shape in ((256, 256), (256, 768), DOWNCAST_SHAPE):
        x = torch.randn(shape, device="cuda", generator=gen) * 100
        edge = tq.edge_values("cuda")
        x.view(-1)[:edge.numel()] = edge
        x.view(-1)[-edge.numel():] = edge
        if not same(tq.downcast_bf16_cuda(x), tq.downcast_bf16_plain(x)):
            return f"downcast_bf16 at {shape}"
        del x
    torch.cuda.synchronize()
    return None


def stream_main(args) -> None:
    import torch

    from . import delta, quantize as tq
    variants = json.loads(Path(args[0]).read_text()) if args \
        else STREAM_ABLATIONS
    print(_smi_line(), flush=True)
    libs = {}
    for name, subs in variants.items():
        try:
            lib, ptxas = _build(name, subs, STREAM, ("stream_kernel",
                                                     "stream_tma_kernel",
                                                     "loop_"))
        except build.KernelBuildError as exc:
            print(f"{name}: BUILD FAILED\n{exc}", flush=True)
            continue
        build._lib = lib
        bad = stream_disagreement(torch)
        print(f"{name}: {' | '.join(ptxas)}; "
              f"{'bit-identical' if bad is None else 'DIFFERS: ' + bad}",
              flush=True)
        if name.startswith("x_") or bad is None:
            libs[name] = lib
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    a, b = _stream_inputs(torch, tq, XOR_WORDS, gen)
    x = torch.randn(DOWNCAST_SHAPE, device="cuda", generator=gen) * 100
    fa, fb = a.view(torch.float32), b.view(torch.float32)
    calls = {"downcast_bf16": (lambda: tq.downcast_bf16_cuda(x),
                               lambda: x.to(torch.bfloat16)),
             "delta_xor": (lambda: delta.delta_xor_cuda(a, b),
                           lambda: torch.bitwise_xor(a, b)),
             "delta_f32": (lambda: delta.delta_f32_cuda(fa, fb),
                           lambda: torch.sub(fa, fb))}
    bound = {"delta_xor": 12 * XOR_WORDS / HBM_BYTES_PER_S * 1e3,
             "delta_f32": 12 * XOR_WORDS / HBM_BYTES_PER_S * 1e3,
             "downcast_bf16": 6 * x.numel() / HBM_BYTES_PER_S * 1e3}
    names = [*libs, "library"]
    times = {k: {n: {"ms": [], "device_ms": []} for n in names}
             for k in calls}
    build._lib = None
    shipped = build.library()
    clocks = _sample_clocks()
    try:
        for _ in range(STREAM_ROUNDS):
            for name in names:
                # A stream's time depends on what ran before it: one with
                # evict-first stores runs about 2 % slow for tens of ms
                # after another that wrote with plain stores. So every
                # entry is timed after the same work, the shipped core's
                # two calls, untimed.
                build._lib = shipped
                for kern, _ in calls.values():
                    _time_ms(torch, kern, STREAM_REPS)
                build._lib = libs.get(name)
                for k, (kern, lib_call) in calls.items():
                    fn = lib_call if name == "library" else kern
                    t = times[k][name]
                    t["ms"].append(_time_ms(torch, fn, STREAM_REPS))
                    t["device_ms"].append(device_ms(torch, fn, DEVICE_REPS))
    finally:
        build._lib = None
        _print_clocks(clocks)
    for k in calls:
        print(f"{k} (bound {bound[k]:.4f} ms; median of {STREAM_ROUNDS} "
              f"rounds; ms wrapper / device, share of the bound by device "
              f"time):", flush=True)
        for name in names:
            t = times[k][name]
            dev = statistics.median(t["device_ms"])
            print(f"  {name:14s} {statistics.median(t['ms']):.4f} / "
                  f"{dev:.4f}  {bound[k] / dev:.3f}", flush=True)
    print(json.dumps({"bound_ms": bound, "times": times}), flush=True)


# ---------------------------------------------------- segmented digest
_CLUSTER = "constexpr int kSumCluster = 8;"
_SUM_VECS = "constexpr int kSumVecs = 4;"
#: the digest the segmented one replaced (a grid-stride loop over at most
#: 132 x 8 blocks of 256 threads, one 16-byte load in flight a thread, a
#: 64-bit modulo a vector, one atomicAdd a block into a zeroed word), put
#: back in its place: a memset of the digests, as the wrapper's
#: torch.zeros did, then one launch a segment, as the loop over chunks did
ATOMIC_KERNELS = """__global__ void __launch_bounds__(kThreads)
atomic_checksum_kernel(const uint32_t* __restrict__ x, int64_t n,
                       uint32_t* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const uint4* __restrict__ x4 = reinterpret_cast<const uint4*>(x);
  uint32_t acc = 0u;
  for (int64_t j = tid; j < n4; j += stride) acc += weigh4(x4[j], j << 2);
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride)
    acc += weigh1(x[i], i);
  block_fold(acc, out);
}

int launch_atomic_checksum(const void* x, int64_t n, int64_t seg_words,
                           int64_t n_segs, void* out, cudaStream_t st) {
  const cudaError_t rc = cudaMemsetAsync(out, 0, 4 * n_segs, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const uint32_t* w = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  for (int64_t s = 0; s < n_segs; ++s) {
    const int64_t lo = s * seg_words;
    const int64_t len = n - lo < seg_words ? n - lo : seg_words;
    atomic_checksum_kernel<<<blocks_for(len), kThreads, 0, st>>>(
        w + lo, len, o + s);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_checksum("""
ATOMIC = [
    ["int launch_checksum(", ATOMIC_KERNELS],
    ["  return launch_cluster_checksum(x, n, seg_words, n_segs, out,\n"
     "                                 static_cast<cudaStream_t>(stream));",
     "  return launch_atomic_checksum(x, n, seg_words, n_segs, out,\n"
     "                                static_cast<cudaStream_t>(stream));"]]
#: the digest in clusters of 16 blocks, past the portable 8 (the launch
#: allows the size)
CLUSTER16 = [[_CLUSTER, "constexpr int kSumCluster = 16;"]]
#: the shipped digest (clusters of 8 blocks, 4 loads in flight a thread),
#: variants of it, and the design it replaced
CHECKSUM_ABLATIONS = {
    "checksum": [],
    "cluster16": CLUSTER16,
    "vecs2": [[_SUM_VECS, "constexpr int kSumVecs = 2;"]],
    "cluster16_vecs2": CLUSTER16 + [
        [_SUM_VECS, "constexpr int kSumVecs = 2;"]],
    "vecs8": [[_SUM_VECS, "constexpr int kSumVecs = 8;"]],
    "atomic_loop": ATOMIC,
}
#: one-segment lengths the digest must agree at: 1-5 words, a block's tile
#: (8,192 words at 512 threads x 4 vectors) less, on and past it, past a
#: cluster's trip (65,536 words at 8 blocks, 131,072 at 16), and the main
#: path's chunk
CHECKSUM_SIZES = (1, 3, 4, 5, 8191, 8192, 8193, 65_537, 131_075, 1 << 20)
#: (words, words a segment): none; fewer words than a segment; one whole
#: segment; a last segment shorter than a block's tile, with 3 trailing
#: words; the main path's piece of 16 chunks, and 17 with a short last;
#: 17 segments whose last is one word; segments one vector past a block's
#: tile and past a cluster's trip at 16 blocks, with short last segments
CHECKSUM_CASES = ((0, 1 << 20), (3, 1 << 20), (1003, 1 << 20),
                  (1 << 20, 1 << 20), ((1 << 20) + 103, 1 << 20),
                  (16 << 20, 1 << 20), ((16 << 20) + 1027, 1 << 20),
                  (65_537, 4_096), (3 * 8_196 + 2, 8_196),
                  (10 * 131_072 + 8_191, 131_076))
#: the main path's calls: one 4 MiB chunk, one 64 MiB piece of 16 chunks
CHUNK_WORDS, PIECE_WORDS = 1 << 20, 16 << 20


def checksum_disagreement(torch):
    """None if the loaded library's digest gives the plain versions'
    digests at every check, else where not."""
    from . import checksum as tc
    from . import quantize as tq
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for n in CHECKSUM_SIZES:
        w, _ = _stream_inputs(torch, tq, n, gen)
        got = int(tc.checksum_cuda(w).item()) & tc.U32_MASK
        if got != tc.checksum_plain(w):
            return f"checksum_u32 at {n} words"
    for n, seg in CHECKSUM_CASES:
        w, _ = _stream_inputs(torch, tq, n, gen)
        if not torch.equal(tc.checksum_segments_cuda(w, seg),
                           tc.checksum_segments_plain(w, seg)):
            return f"checksum_u32 at {n} words in segments of {seg}"
    # sliced at a 4-byte offset: the wrapper clones to 16-byte alignment
    w, _ = _stream_inputs(torch, tq, 65_538, gen)
    if not torch.equal(tc.checksum_segments_cuda(w[1:], 4_096),
                       tc.checksum_segments_plain(w[1:], 4_096)):
        return "checksum_u32 at a 4-byte offset"
    torch.cuda.synchronize()
    return None


def checksum_main(args) -> None:
    import torch

    from . import checksum as tc
    from . import quantize as tq
    variants = json.loads(Path(args[0]).read_text()) if args \
        else CHECKSUM_ABLATIONS
    print(_smi_line(), flush=True)
    libs = {}
    for name, subs in variants.items():
        try:
            lib, ptxas = _build(name, subs, STREAM,
                                ("checksum_segments_kernel",
                                 "atomic_checksum_kernel"))
        except build.KernelBuildError as exc:
            print(f"{name}: BUILD FAILED\n{exc}", flush=True)
            continue
        build._lib = lib
        try:
            bad = checksum_disagreement(torch)
        except RuntimeError as exc:   # a launch the card refused
            bad = f"launch failed: {exc}"
        print(f"{name}: {' | '.join(ptxas)}; "
              f"{'bit-identical' if bad is None else 'DIFFERS: ' + bad}",
              flush=True)
        if name.startswith("x_") or bad is None:
            libs[name] = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    piece, _ = _stream_inputs(torch, tq, PIECE_WORDS, gen)
    chunk = piece[:CHUNK_WORDS]
    out = torch.empty(16, dtype=torch.int32, device="cuda")
    calls = {"chunk": lambda: tc.checksum_cuda(chunk, out[:1]),
             "piece": lambda: tc.checksum_segments_cuda(piece, CHUNK_WORDS,
                                                        out)}
    # device operations a call: the atomic loop adds a memset and launches
    # once a segment
    per_call = {"chunk": 2, "piece": 17}
    bound = {k: 4 * n / HBM_BYTES_PER_S * 1e3
             for k, n in (("chunk", CHUNK_WORDS), ("piece", PIECE_WORDS))}
    times = {k: {n: {"ms": [], "device_ms": []} for n in libs}
             for k in calls}
    build._lib = None
    shipped = build.library()
    clocks = _sample_clocks()
    try:
        for _ in range(STREAM_ROUNDS):
            for name, lib in libs.items():
                build._lib = shipped
                for fn in calls.values():
                    _time_ms(torch, fn, STREAM_REPS)
                build._lib = lib
                ops = per_call if name == "atomic_loop" else {}
                for k, fn in calls.items():
                    t = times[k][name]
                    t["ms"].append(_time_ms(torch, fn, STREAM_REPS))
                    t["device_ms"].append(device_ms(
                        torch, fn, DEVICE_REPS, per_call=ops.get(k, 1)))
    finally:
        build._lib = None
        _print_clocks(clocks)
    for k in calls:
        print(f"checksum_u32 {k} (bound {bound[k]:.5f} ms; median of "
              f"{STREAM_ROUNDS} rounds; ms wrapper / device, share of the "
              f"bound by device time):", flush=True)
        for name in libs:
            t = times[k][name]
            dev = statistics.median(t["device_ms"])
            print(f"  {name:14s} {statistics.median(t['ms']):.4f} / "
                  f"{dev:.4f}  {bound[k] / dev:.3f}", flush=True)
    print(json.dumps({"bound_ms": bound, "times": times}), flush=True)


# ------------------------------------------------- segmented int8 pair
_QROWS = "constexpr int kQuantRows = 1;"
_DQROWS = "constexpr int kDequantRows = 2;"
_QTHREADS = "constexpr int kQuantThreads = 512;"
_QCLUSTER = "constexpr int kQuantCluster = 16;"
_DQCLUSTER = "constexpr int kDequantCluster = 8;"
_INT8_MARK = "// The segment table checked and passed by value"
#: the int8 design the segmented one replaced (per segment one launch of a
#: grid-stride loop over at most 132 x 8 blocks of 256 threads, one warp a
#: row, plain loads and stores, one atomicAdd a block into a zeroed word),
#: put back in its place after a memset of the digests, as the wrapper's
#: torch.zeros and the loop over chunks did; it reads and writes the
#: segmented layout, so it is checked as the shipped kernels are
ATOMIC_INT8_KERNELS = """template <bool kEncode>
__global__ void __launch_bounds__(kThreads)
atomic_int8_kernel(const uint8_t* __restrict__ src, int64_t valid,
                   void* __restrict__ dst, uint32_t* __restrict__ dig,
                   int s, int64_t r0, uint32_t n, int header) {
  const int64_t hdr = header ? kHeaderBytes : 0;
  const int64_t pay_off = hdr * s + kPayloadRowBytes * r0;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  uint32_t acc = 0u;
  if constexpr (kEncode) {
    uint8_t* pay = static_cast<uint8_t*>(dst) + pay_off;
    float* scales = reinterpret_cast<float*>(pay + hdr);
    uint32_t* qw = reinterpret_cast<uint32_t*>(scales + n);
    const int64_t left = valid - kRowBytes * r0;
    for (int64_t r = warp; r < n; r += n_warps) {
      float4 a, b;
      load_row(src + kRowBytes * r0, r, left, lane, &a, &b);
      uint32_t wa, wb;
      const float scale = quantize_vals(a, b, &wa, &wb);
      qw[r * kRowWords + lane] = wa;
      qw[r * kRowWords + 32 + lane] = wb;
      const uint32_t i0 = kPayloadHeaderWords + n + r * kRowWords;
      acc += weigh_at(wa, i0 + lane) + weigh_at(wb, i0 + 32 + lane);
      if (lane == 0) {
        scales[r] = scale;
        acc += weigh_at(__float_as_uint(scale), kPayloadHeaderWords + r);
      }
    }
    if (header && blockIdx.x == 0 && threadIdx.x == 0) {
      const int64_t rows_bytes = kRowBytes * n;
      const uint32_t raw = left < rows_bytes ? left : rows_bytes;
      uint32_t* h = reinterpret_cast<uint32_t*>(pay);
      h[0] = n;
      h[1] = raw;
      acc += header_terms(n, raw);
    }
  } else {
    const uint8_t* pay = src + pay_off;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(pay + hdr);
    const uint32_t* qw = sw + n;
    float* orows = static_cast<float*>(dst) + int64_t{kRowElems} * r0;
    for (int64_t r = warp; r < n; r += n_warps) {
      const uint32_t sb = sw[r];
      const uint32_t wa = qw[r * kRowWords + lane];
      const uint32_t wb = qw[r * kRowWords + 32 + lane];
      float4* orow = reinterpret_cast<float4*>(orows + r * kRowElems);
      orow[lane] = dequant4(wa, __uint_as_float(sb));
      orow[32 + lane] = dequant4(wb, __uint_as_float(sb));
      const uint32_t i0 = kPayloadHeaderWords + n + r * kRowWords;
      acc += weigh_at(wa, i0 + lane) + weigh_at(wb, i0 + 32 + lane);
      if (lane == 0) acc += weigh_at(sb, kPayloadHeaderWords + r);
    }
    if (header && blockIdx.x == 0 && threadIdx.x == 0) {
      const uint32_t* h = reinterpret_cast<const uint32_t*>(pay);
      acc += header_terms(h[0], h[1]);
    }
  }
  block_fold(acc, dig + s);
}

template <bool kEncode>
int launch_int8_atomic(const void* src, int64_t valid, const SegRows& t,
                       void* dst, void* dig, int header, cudaStream_t st) {
  const cudaError_t rc = cudaMemsetAsync(dig, 0, 4 * t.n, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int s = 0; s < t.n; ++s) {
    const uint32_t n = t.start[s + 1] - t.start[s];
    atomic_int8_kernel<kEncode><<<row_blocks_for(n), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(src), valid, dst,
        static_cast<uint32_t*>(dig), s, t.start[s], n, header);
  }
  return static_cast<int>(cudaGetLastError());
}

""" + _INT8_MARK
ATOMIC_INT8 = [
    [_INT8_MARK, ATOMIC_INT8_KERNELS],
    ["  return launch_int8_clusters<kEncode>(src, valid, t, dst, dig, header,",
     "  return launch_int8_atomic<kEncode>(src, valid, t, dst, dig, header,"]]
#: the shipped pair (512 threads; the encode 1 row a warp in flight and
#: clusters of 16 blocks, the decode 2 rows and clusters of 8), variants
#: of it, and the design it replaced
INT8_ABLATIONS = {
    "int8": [],
    "encode_rows2": [[_QROWS, "constexpr int kQuantRows = 2;"]],
    "encode_rows4": [[_QROWS, "constexpr int kQuantRows = 4;"]],
    "decode_rows1": [[_DQROWS, "constexpr int kDequantRows = 1;"]],
    "decode_rows4": [[_DQROWS, "constexpr int kDequantRows = 4;"]],
    "threads256": [[_QTHREADS, "constexpr int kQuantThreads = 256;"]],
    "threads1024": [[_QTHREADS, "constexpr int kQuantThreads = 1024;"]],
    "encode_cluster8": [[_QCLUSTER, "constexpr int kQuantCluster = 8;"]],
    "decode_cluster16": [[_DQCLUSTER,
                          "constexpr int kDequantCluster = 16;"]],
    "tail_inline": [["__device__ __noinline__ RowPair load_cut_row(",
                     "__device__ __forceinline__ RowPair load_cut_row("]],
    "atomic_loop": ATOMIC_INT8,
}
#: rows of the one-segment entries' checks
INT8_ROWS = (1, 3, 257, 4096)
#: chunks' raw bytes of each piece the pair must agree at: a tensor of
#: 4 bytes, of 1,020 and of 1,022 (not whole words), one short row; one
#: row; one 4 MiB chunk; the 64 MiB piece of 16 chunks; 16 chunks and a
#: 1-row seventeenth; 16 with a ragged last; segments shorter than a
#: cluster's share of rows (3, 1, 5, 2 rows); unequal sizes from a table
#: with a ragged last; 32 segments, the most one launch takes
INT8_CASES = ((4,), (1020,), (1022,), (1024,), (4 << 20,),
              (4 << 20,) * 16, (4 << 20,) * 16 + (1024,),
              (4 << 20,) * 15 + ((4 << 20) - 1000,),
              (3 * 1024, 1024, 5 * 1024, 2 * 1024 - 12),
              (7 * 1024, 300 * 1024, 1024, 4097 * 1024, 64 * 1024 - 36),
              tuple(1024 * (1 + 37 * k % 11) for k in range(31)) + (520,))
#: the main path's calls: one 4 MiB chunk, one 64 MiB piece of 16 chunks
INT8_CHUNK, INT8_PIECE = (4 << 20,), (4 << 20,) * 16


def int8_layout(sizes):
    """``(row_starts, valid_bytes)`` of a piece of chunks of ``sizes`` raw
    bytes, every one but the last a whole number of rows."""
    from . import quantize as tq
    starts, pos = [0], 0
    for n in sizes:
        pos += n
        starts.append(-(-pos // tq.ROW_BYTES))
    return starts, pos


def int8_inputs(torch, sizes, gen):
    """Seeded raw fp32 bytes of a piece of chunks of ``sizes`` (normal,
    times 10), with :data:`.quantize.EDGE_BITS`, an all-zero row and a row
    of rounding ties (amax 127, so the scale is 1.0: +-0.5, +-2.5, +-3.5,
    +-126.5) in the first and in the last segment, rows permitting."""
    from . import quantize as tq
    starts, valid = int8_layout(sizes)
    x = torch.randn(starts[-1] * tq.ROW_ELEMS, device="cuda",
                    generator=gen) * 10
    rows = x.view(-1, tq.ROW_ELEMS)
    edge = tq.edge_values("cuda")
    ties = torch.tensor([127, -127, 0.5, -0.5, 2.5, -2.5, 3.5, -3.5, 126.5,
                         -126.5], device="cuda")
    for r0, r1 in {(starts[0], starts[1]), (starts[-2], starts[-1])}:
        rows[r0, :edge.numel()] = edge
        if r1 - r0 >= 3:
            rows[r0 + 1] = 0
            rows[r0 + 2] = 0
            rows[r0 + 2, :ties.numel()] = ties
    return x.view(torch.uint8)[:valid], starts, valid


def int8_disagreement(torch):
    """None if the loaded library's int8 pair gives the plain versions'
    payloads, digests and rows at every check, else where not."""
    from . import quantize as tq
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)

    def same(a, b):
        return a.shape == b.shape and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
    for n_rows in INT8_ROWS:
        x, _, _ = int8_inputs(torch, (n_rows * tq.ROW_BYTES,), gen)
        x = x.view(torch.float32).view(-1, tq.ROW_ELEMS)
        body, dig = tq.quantize_checksum_cuda(x)
        pbody, pdig = tq.quantize_checksum_plain(x)
        out, odig = tq.dequantize_checksum_cuda(body, n_rows)
        pout, podig = tq.dequantize_checksum_plain(body, n_rows)
        if not same(body, pbody) or int(dig.item()) & tq.U32_MASK != pdig:
            return f"quantize_checksum_int8 at {n_rows} rows"
        if not same(out, pout) or int(odig.item()) & tq.U32_MASK != podig:
            return f"dequantize_checksum_int8 at {n_rows} rows"
    for sizes in INT8_CASES:
        what = f"{len(sizes)} segments of {sorted(set(sizes))} bytes"
        x, starts, valid = int8_inputs(torch, sizes, gen)
        pay, dig = tq.quantize_checksum_segments_cuda(x, valid, starts)
        ppay, pdig = tq.quantize_checksum_segments_plain(x, valid, starts)
        if not same(pay, ppay) or not same(dig, pdig):
            return f"quantize_checksum_int8 at {what}"
        out, odig = tq.dequantize_checksum_segments_cuda(pay, starts)
        pout, podig = tq.dequantize_checksum_segments_plain(pay, starts)
        if not same(out, pout) or not same(odig, podig) \
                or not same(odig, dig):
            return f"dequantize_checksum_int8 at {what}"
    torch.cuda.synchronize()
    return None


def int8_bound_ms(sizes) -> float:
    """Bytes the pair moves over the memory rate: the valid raw bytes and
    the payloads (one read, the other written)."""
    from . import quantize as tq
    starts, valid = int8_layout(sizes)
    return (valid + tq.segment_offsets(starts)[-1]) / HBM_BYTES_PER_S * 1e3


def int8_calls(torch, gen):
    """``{(kernel, size): (wrapper call, plain call)}`` at the main path's
    chunk and piece, the wrappers into preallocated outputs, and the
    device operations a call of the atomic loop makes (a memset, a launch
    a segment)."""
    from . import quantize as tq
    x, starts, valid = int8_inputs(torch, INT8_PIECE, gen)
    pay, dig = tq.quantize_checksum_segments_cuda(x, valid, starts)
    rows = torch.empty((starts[-1], tq.ROW_ELEMS), device="cuda")
    calls, per_call = {}, {}
    for size, sizes in (("chunk", INT8_CHUNK), ("piece", INT8_PIECE)):
        st, v = int8_layout(sizes)
        n = tq.segment_offsets(st)[-1]
        p, d, r, xv = pay[:n], dig[:len(sizes)], rows[:st[-1]], x[:v]
        calls["quantize_checksum_int8", size] = (
            lambda xv=xv, v=v, st=st, p=p, d=d:
            tq.quantize_checksum_segments_cuda(xv, v, st, p, d),
            lambda xv=xv, v=v, st=st:
            tq.quantize_checksum_segments_plain(xv, v, st))
        calls["dequantize_checksum_int8", size] = (
            lambda st=st, p=p, d=d, r=r:
            tq.dequantize_checksum_segments_cuda(p, st, r, d),
            lambda st=st, p=p: tq.dequantize_checksum_segments_plain(p, st))
        per_call[size] = 1 + len(sizes)
    return calls, per_call


def int8_main(args) -> None:
    import torch

    variants = json.loads(Path(args[0]).read_text()) if args \
        else INT8_ABLATIONS
    print(_smi_line(), flush=True)
    libs = {}
    for name, subs in variants.items():
        try:
            lib, ptxas = _build(name, subs, STREAM,
                                ("quantize_segments_kernel",
                                 "dequantize_segments_kernel",
                                 "atomic_int8_kernel"))
        except build.KernelBuildError as exc:
            print(f"{name}: BUILD FAILED\n{exc}", flush=True)
            continue
        build._lib = lib
        try:
            bad = int8_disagreement(torch)
        except RuntimeError as exc:   # a launch the card refused
            bad = f"launch failed: {exc}"
        print(f"{name}: {' | '.join(ptxas)}; "
              f"{'bit-identical' if bad is None else 'DIFFERS: ' + bad}",
              flush=True)
        if name.startswith("x_") or bad is None:
            libs[name] = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    calls, per_call = int8_calls(torch, gen)
    bound = {size: int8_bound_ms(sizes) for size, sizes in
             (("chunk", INT8_CHUNK), ("piece", INT8_PIECE))}
    times = {f"{k} {size}": {n: {"ms": [], "device_ms": []} for n in libs}
             for k, size in calls}
    build._lib = None
    shipped = build.library()
    clocks = _sample_clocks()
    try:
        for _ in range(STREAM_ROUNDS):
            for name, lib in libs.items():
                build._lib = shipped
                for fn, _plain in calls.values():
                    _time_ms(torch, fn, STREAM_REPS)
                build._lib = lib
                for (k, size), (fn, _plain) in calls.items():
                    t = times[f"{k} {size}"][name]
                    t["ms"].append(_time_ms(torch, fn, STREAM_REPS))
                    try:
                        dev = device_ms(
                            torch, fn, DEVICE_REPS,
                            per_call=per_call[size] if name == "atomic_loop"
                            else 1)
                    except RuntimeError as exc:  # the profiler kept nothing
                        print(f"{name} {k} {size}: {exc}", flush=True)
                        dev = float("nan")
                    t["device_ms"].append(dev)
    finally:
        build._lib = None
        _print_clocks(clocks)
    for key in times:
        b = bound[key.split()[1]]
        print(f"{key} (bound {b:.5f} ms; median of {STREAM_ROUNDS} rounds; "
              f"ms wrapper / device, share of the bound by device time):",
              flush=True)
        for name in libs:
            t = times[key][name]
            kept = [x for x in t["device_ms"] if x == x]
            dev = statistics.median(kept) if kept else float("nan")
            print(f"  {name:14s} {statistics.median(t['ms']):.4f} / "
                  f"{dev:.4f}  {b / dev:.3f}", flush=True)
    print(json.dumps({"bound_ms": bound, "times": times}), flush=True)


# ------------------------------------------------------- int8 path
#: one run of ``int8path``, in the checkout it is started in
INT8_PATH_RUN = """
import contextlib, json, os, shutil, sys, time
root = os.getcwd()
sys.path[:0] = [os.path.join(root, "src"), root]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config, uniform_groups
from repro_torch.kernels import build
from repro_torch.obs import trace as obs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.library()
kept = []
tracing = obs.tracing

@contextlib.contextmanager
def keep(*a, **k):
    with tracing(*a, **k) as t:
        yield t
    kept.append(t)

obs.tracing = keep
cfg = get_config("llama3.2-1b", n_layers=2,
                 layer_groups=uniform_groups("full", 2))
workdir = os.path.join(root, "build", "int8path_ckpt")
shutil.rmtree(workdir, ignore_errors=True)
torch.cuda.reset_peak_memory_stats()
cs._zero_launches()
t0 = time.perf_counter()
try:
    # the report first: a checkout's run_train_path returns two or three
    report = cs.run_train_path("cuda", cfg, workdir, cs.HOST_CACHE_BYTES,
                               8, batch=cs.TRAIN_BATCH,
                               seq_len=cs.TRAIN_SEQ)[0]
finally:
    shutil.rmtree(workdir, ignore_errors=True)
wall = time.perf_counter() - t0
enc = kept[0].spans("encode.int8")
n = cs._launches()
print("int8path " + json.dumps({
    "checkout": root, "phase_s": wall, "run_s": report["run_s"],
    "encode_int8_s_per_save": sum(e["t1"] - e["t0"] for e in enc)
    / len(report["saves"]), "encode_int8_spans": len(enc),
    "persist_s": [r["persist_s"] for r in report["saves"]],
    "resume_s": report["restore"]["total_s"],
    "read_s": report["restore"]["read_s"],
    "max_memory_allocated": torch.cuda.max_memory_allocated(),
    "launches": {k: n[k] for k in ("quantize_checksum_int8",
                                   "dequantize_checksum_int8")},
    "resume_launches": {k: report["restore"]["launches"][k] for k in (
        "quantize_checksum_int8", "dequantize_checksum_int8")}}),
    flush=True)
"""


def int8path_main(args) -> None:
    """Each checkout's run in turns: the order given, then reversed."""
    if not args:
        sys.exit("int8path: name one or more checkouts")
    print(_smi_line(), flush=True)
    for checkout in [*args, *reversed(args)]:
        proc = subprocess.run([sys.executable, "-c", INT8_PATH_RUN],
                              cwd=checkout, capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith(("int8path ", "resume ", "save "))]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0:
            print(f"int8path: {checkout} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-4000:]}", flush=True)


# ---------------------------------------------- segmented XOR digest
_XCLUSTER = "constexpr int kXorCluster = 8;"
_XVECS = "constexpr int kXorVecs = 2;"
_XLAUNCH = "constexpr int64_t kXorLaunchClusters = 16;"
_XOR_LAUNCH = ("  return launch_xor_clusters(a, b, out, n, seg_words, n_segs, "
               "part,\n                             "
               "static_cast<cudaStream_t>(stream));")
#: the XOR digest the segmented one replaced (a grid-stride loop over at
#: most 132 x 8 blocks of 256 threads, 64-bit positions, one atomicAdd a
#: block into a zeroed word), put back in its place: a memset of the
#: partials, as the wrapper's torch.zeros did, then one launch a segment,
#: as the loop over chunks did
ATOMIC_XOR = [[_XOR_LAUNCH, """\
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      cudaMemsetAsync(part, 0, 4 * kXorMaxGroups * n_segs, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int64_t s = 0; s < n_segs; ++s) {
    const int64_t lo = s * seg_words;
    const int64_t len = n - lo < seg_words ? n - lo : seg_words;
    xor_checksum_kernel<false><<<blocks_for(len), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(a) + lo,
        static_cast<const uint32_t*>(b) + lo,
        static_cast<uint32_t*>(out) + lo, len,
        static_cast<uint32_t*>(part) + s * kXorMaxGroups);
  }
  return static_cast<int>(cudaGetLastError());"""]]


def _xlaunch(k: int):
    return [[_XLAUNCH, f"constexpr int64_t kXorLaunchClusters = {k};"]]


#: the shipped XOR digest (16 clusters of 8 blocks a launch, 2 loads in
#: flight a thread and input), variants of it, and the design it replaced
XOR_ABLATIONS = {
    "xor": [],
    "one_cluster_a_segment": _xlaunch(1),
    "launch8": _xlaunch(8),
    "launch32": _xlaunch(32),
    "cluster16": [[_XCLUSTER, "constexpr int kXorCluster = 16;"]],
    "cluster16_launch8": [[_XCLUSTER, "constexpr int kXorCluster = 16;"]]
    + _xlaunch(8),
    "vecs1": [[_XVECS, "constexpr int kXorVecs = 1;"]],
    "vecs4": [[_XVECS, "constexpr int kXorVecs = 4;"]],
    "atomic_loop": ATOMIC_XOR,
}
#: one-segment lengths (words) the XOR digest must agree at: 1-5 words, a
#: block's tile (4,096 words) less, on and past it, past a cluster's trip
#: (32,768 words), and the main path's chunk with and without a tail
XOR_SIZES = (1, 3, 4, 5, 4095, 4096, 4097, 32_769, 65_537, 1 << 20,
             (1 << 20) + 3)
#: the delta path's chunk (the engine's 4 MiB)
XOR_CHUNK = 4 << 20
#: (bytes, bytes a segment) the XOR digest must agree at, the bytes
#: zero-padded to a whole word as the codec pads them: none; one segment;
#: a short last segment; byte tails of 1 and 3 bytes; 4 segments, and 5
#: with a short fifth; the delta path's piece of 8 chunks; 16 segments,
#: and 17 whose
#: last is one word; segments of 4 MiB and 48 bytes, whose clusters end
#: in partial tiles; the 64 MiB piece of 16 chunks (:data:`XOR_CARD_ONLY`)
XOR_CASES = ((0, XOR_CHUNK), (XOR_CHUNK, XOR_CHUNK),
             (3 * 16_384 + 1000, 16_384), (2 * 16_384 + 401, 16_384),
             (2 * 16_384 + 403, 16_384), (4 * XOR_CHUNK, XOR_CHUNK),
             (4 * XOR_CHUNK + 5000, XOR_CHUNK), (8 * XOR_CHUNK, XOR_CHUNK),
             (16 * 65_536, 65_536),
             (16 * 65_536 + 4, 65_536),
             (2 * (XOR_CHUNK + 48) + 4099, XOR_CHUNK + 48),
             (16 * XOR_CHUNK, XOR_CHUNK))
#: the cases the CPU tests leave to the card
XOR_CARD_ONLY = ((16 * XOR_CHUNK, XOR_CHUNK),)
#: the main path's calls: one 4 MiB chunk, the delta provider's piece of
#: 8 chunks, a 64 MiB piece of 16 (bytes, segments)
XOR_CALLS = {"chunk": (XOR_CHUNK, 1), "piece": (8 * XOR_CHUNK, 8),
             "piece64": (16 * XOR_CHUNK, 16)}


def xor_inputs(torch, n_bytes: int, gen):
    """Two seeded int32 word tensors on the card holding ``n_bytes`` bytes
    each, with :data:`.quantize.EDGE_BITS` in front, the byte tail
    zero-padded to a whole word."""
    from . import checksum as tc
    from . import quantize as tq
    a, b = _stream_inputs(torch, tq, -(-n_bytes // 4), gen)
    return (tc.as_words(a.view(torch.uint8)[:n_bytes]),
            tc.as_words(b.view(torch.uint8)[:n_bytes]))


def xor_disagreement(torch):
    """None if the loaded library's XOR digest gives the plain versions'
    deltas and digests at every check, else where not."""
    from . import fused as tf
    from . import quantize as tq
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)

    def same(got, want):
        return torch.equal(got[0], want[0]) and (
            tf.segment_digests(got[1]).tolist()
            == tf.segment_digests(want[1]).tolist())
    for n in XOR_SIZES:
        a, b = _stream_inputs(torch, tq, n, gen)
        if not same(tf.xor_checksum_cuda(a, b),
                    tf.xor_checksum_segments_plain(a, b, -(-n // 4) * 4)):
            return f"xor_checksum_u32 at {n} words"
    for n_bytes, seg_bytes in XOR_CASES:
        a, b = xor_inputs(torch, n_bytes, gen)
        seg = seg_bytes // 4
        if not same(tf.xor_checksum_segments_cuda(a, b, seg),
                    tf.xor_checksum_segments_plain(a, b, seg)):
            return f"xor_checksum_u32 at {n_bytes} bytes in {seg_bytes}"
    # sliced at a 4-byte offset: the wrapper clones to 16-byte alignment
    a, b = _stream_inputs(torch, tq, 65_538, gen)
    if not same(tf.xor_checksum_segments_cuda(a[1:], b[1:], 4_096),
                tf.xor_checksum_segments_plain(a[1:], b[1:], 4_096)):
        return "xor_checksum_u32 at a 4-byte offset"
    torch.cuda.synchronize()
    return None


def xor_bound_ms(n_bytes: int) -> float:
    """Two inputs read and one output written over the memory rate."""
    return 3 * n_bytes / HBM_BYTES_PER_S * 1e3


def xor_calls(torch, gen):
    """``{size: (wrapper call, plain call)}`` at :data:`XOR_CALLS`, the
    wrappers into preallocated outputs, and the device operations a call
    of the atomic loop makes (a memset, a launch a segment)."""
    from . import fused as tf
    from . import quantize as tq
    a, b = _stream_inputs(torch, tq, XOR_CALLS["piece64"][0] // 4, gen)
    out = torch.empty_like(a)
    dig = torch.empty((16, tf.MAX_GROUPS), dtype=torch.int32, device="cuda")
    seg = XOR_CHUNK // 4
    calls, per_call = {}, {}
    for size, (n_bytes, n_segs) in XOR_CALLS.items():
        n = n_bytes // 4
        x, y, o, d = a[:n], b[:n], out[:n], dig[:n_segs]
        if n_segs == 1:
            calls[size] = (lambda x=x, y=y, o=o, d=d:
                           tf.xor_checksum_cuda(x, y, o, d),
                           lambda x=x, y=y: tf.xor_checksum_plain(x, y))
        else:
            calls[size] = (lambda x=x, y=y, o=o, d=d:
                           tf.xor_checksum_segments_cuda(x, y, seg, o, d),
                           lambda x=x, y=y:
                           tf.xor_checksum_segments_plain(x, y, seg))
        per_call[size] = 1 + n_segs
    return calls, per_call


def xor_main(args) -> None:
    import torch

    variants = json.loads(Path(args[0]).read_text()) if args \
        else XOR_ABLATIONS
    print(_smi_line(), flush=True)
    libs = {}
    for name, subs in variants.items():
        try:
            lib, ptxas = _build(name, subs, STREAM,
                                ("xor_checksum_segments_kernel",
                                 "xor_checksum_kernel"))
        except build.KernelBuildError as exc:
            print(f"{name}: BUILD FAILED\n{exc}", flush=True)
            continue
        build._lib = lib
        try:
            bad = xor_disagreement(torch)
        except RuntimeError as exc:   # a launch the card refused
            bad = f"launch failed: {exc}"
        print(f"{name}: {' | '.join(ptxas)}; "
              f"{'bit-identical' if bad is None else 'DIFFERS: ' + bad}",
              flush=True)
        if name.startswith("x_") or bad is None:
            libs[name] = lib
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    calls, per_call = xor_calls(torch, gen)
    bound = {k: xor_bound_ms(n) for k, (n, _s) in XOR_CALLS.items()}
    times = {k: {n: {"ms": [], "device_ms": []} for n in libs}
             for k in calls}
    build._lib = None
    shipped = build.library()
    clocks = _sample_clocks()
    try:
        for _ in range(STREAM_ROUNDS):
            for name, lib in libs.items():
                build._lib = shipped
                for fn, _plain in calls.values():
                    _time_ms(torch, fn, STREAM_REPS)
                build._lib = lib
                for k, (fn, _plain) in calls.items():
                    t = times[k][name]
                    t["ms"].append(_time_ms(torch, fn, STREAM_REPS))
                    try:
                        dev = device_ms(
                            torch, fn, DEVICE_REPS,
                            per_call=per_call[k] if name == "atomic_loop"
                            else 1)
                    except RuntimeError as exc:  # the profiler kept nothing
                        print(f"{name} {k}: {exc}", flush=True)
                        dev = float("nan")
                    t["device_ms"].append(dev)
    finally:
        build._lib = None
        _print_clocks(clocks)
    for k in calls:
        print(f"xor_checksum_u32 {k} (bound {bound[k]:.5f} ms; median of "
              f"{STREAM_ROUNDS} rounds; ms wrapper / device, share of the "
              f"bound by device time):", flush=True)
        for name in libs:
            t = times[k][name]
            kept = [x for x in t["device_ms"] if x == x]
            dev = statistics.median(kept) if kept else float("nan")
            print(f"  {name:22s} {statistics.median(t['ms']):.4f} / "
                  f"{dev:.4f}  {bound[k] / dev:.3f}", flush=True)
    print(json.dumps({"bound_ms": bound, "times": times}), flush=True)


# ------------------------------------------------------- delta path
#: one run of ``deltapath``, in the checkout it is started in; its one
#: argument, if not empty, is the delta provider's DELTA_BUDGET_SHARE
DELTA_PATH_RUN = """
import contextlib, json, os, shutil, sys, time
root = os.getcwd()
sys.path[:0] = [os.path.join(root, "src"), root]
share = sys.argv[1] if len(sys.argv) > 1 else ""
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config, uniform_groups
from repro_torch.core import state_provider
from repro_torch.kernels import build
from repro_torch.obs import trace as obs
if share:
    state_provider.DELTA_BUDGET_SHARE = int(share)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.library()
kept = []
tracing = obs.tracing

@contextlib.contextmanager
def keep(*a, **k):
    with tracing(*a, **k) as t:
        yield t
    kept.append(t)

obs.tracing = keep
cfg = get_config("llama3.2-1b", n_layers=2,
                 layer_groups=uniform_groups("full", 2))
workdir = os.path.join(root, "build", "deltapath_ckpt")
shutil.rmtree(workdir, ignore_errors=True)
torch.cuda.reset_peak_memory_stats()
cs._zero_launches()
t0 = time.perf_counter()
try:
    with tracing() as outer:
        report = cs.run_main_path("cuda", cfg, workdir, cs.HOST_CACHE_BYTES,
                                  8)
finally:
    shutil.rmtree(workdir, ignore_errors=True)
wall = time.perf_counter() - t0
# the delta saves stream one after the other (each waits for the last
# one's streams to end) and encode the same tensors, so the spans in time
# order fall into saves of equal bytes
spans = sorted((e for t in [outer, *kept] for e in t.spans("encode.delta")),
               key=lambda e: e["t0"])
deltas = [r for r in report["steps"] if r["kind"] == "delta"]
per_save = sum(e["args"]["bytes"] for e in spans) // max(1, len(deltas))
saves, group, nbytes = [], [], 0
for e in spans:
    group.append(e)
    nbytes += e["args"]["bytes"]
    if nbytes >= per_save:
        saves.append(group)
        group, nbytes = [], 0
n = cs._launches()
names = ("xor_checksum_u32", "delta_xor", "checksum_u32")
print("deltapath " + json.dumps({
    "checkout": root, "share": share, "phase_s": wall,
    "encode_delta_s": [sum(e["t1"] - e["t0"] for e in g) for g in saves],
    "encode_delta_spans": [len(g) for g in saves],
    "persist_s": [r["persist_s"] for r in report["steps"]],
    "prologue_s": [r["prologue_s"] for r in report["steps"]],
    "restore_s": [r["total_s"] for r in report["restores"]],
    "max_memory_allocated": torch.cuda.max_memory_allocated(),
    "launches": {k: n[k] for k in names},
    "save_launches": {k: report["launches_save"][k] for k in names}}),
    flush=True)
"""


def deltapath_main(args) -> None:
    """Each checkout's run in turns: the order given, then reversed."""
    if not args:
        sys.exit("deltapath: name one or more checkouts")
    print(_smi_line(), flush=True)
    for arg in [*args, *reversed(args)]:
        checkout, _, share = arg.partition(":")
        proc = subprocess.run([sys.executable, "-c", DELTA_PATH_RUN, share],
                              cwd=checkout, capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith(("deltapath ", "restore ", "save "))]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0:
            print(f"deltapath: {arg} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-4000:]}", flush=True)


# ------------------------------------- the attention kernel by checkout
ATTN_PATH_RUN = """
import json, os, sys
root = os.getcwd()
sys.path.insert(0, os.path.join(root, "src"))
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
lib = build.build()
build.library()
ptxas, on = [], False
for line in build.ptxas_report(lib).read_text().splitlines():
    if "Compiling entry" in line:
        on = "flash_fwd_bf16" in line
    elif on and any(x in line for x in ("registers", "spill")):
        ptxas.append(line.strip())

def time_ms(fn, reps):
    for _ in range(5):
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

for (B, S, H, KV), hd in ((%(serve)r, 64), (%(serve_128)r, 128)):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = (torch.randn(B, S, h, hd, device="cuda", generator=gen)
               .to(torch.bfloat16) for h in (H, KV, KV))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kern = lambda: fa.flash_attention_cuda(q, k, v)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    want = fa.flash_attention_plain(q, k, v).float()
    err = float((kern().float() - want).abs().max())
    del want
    times = {"kernel": [], "sdpa": []}
    for _ in range(%(rounds)d):
        times["kernel"].append(time_ms(kern, %(reps)d))
        times["sdpa"].append(time_ms(sdpa, %(reps)d))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            kern()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    n = sum(e.count for e in dev)
    print("attnpath " + json.dumps({
        "checkout": root, "hd": hd, "max_abs_err": err,
        "ms": times["kernel"], "sdpa_ms": times["sdpa"],
        "device_ms": sum(e.self_device_time_total for e in dev) / n / 1e3
        if n else None, "ptxas": ptxas}), flush=True)
    del q, k, v, qt, kt, vt
"""


def attnpath_main(args) -> None:
    """Each checkout's attention kernel in turns: the order given, then
    reversed."""
    if not args:
        sys.exit("attnpath: name one or more checkouts")
    print(_smi_line(), flush=True)
    run = ATTN_PATH_RUN % {"serve": SERVE, "serve_128": SERVE_128,
                           "rounds": ROUNDS, "reps": REPS}
    for checkout in [*args, *reversed(args)]:
        proc = subprocess.run([sys.executable, "-c", run], cwd=checkout,
                              capture_output=True, text=True)
        print("\n".join(x for x in proc.stdout.splitlines()
                        if x.startswith("attnpath ")), flush=True)
        if proc.returncode != 0:
            print(f"attnpath: {checkout} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-4000:]}", flush=True)


def main(argv) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("variants: needs a CUDA card")
    args = argv[1:]
    if args and args[0] == "stream":
        stream_main(args[1:])
    elif args and args[0] == "checksum":
        checksum_main(args[1:])
    elif args and args[0] == "int8":
        int8_main(args[1:])
    elif args and args[0] == "int8path":
        int8path_main(args[1:])
    elif args and args[0] == "xor":
        xor_main(args[1:])
    elif args and args[0] == "deltapath":
        deltapath_main(args[1:])
    elif args and args[0] == "attnpath":
        attnpath_main(args[1:])
    else:
        attention_main(args)


if __name__ == "__main__":
    main(sys.argv)

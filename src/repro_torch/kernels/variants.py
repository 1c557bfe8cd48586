"""Build variants of a kernel source and time them on the card.

    python -m repro_torch.kernels.variants [variants.json]
    python -m repro_torch.kernels.variants stream [variants.json]

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
shapes and timed with CUDA events at the serving shape (B 2, S 4,096,
32/8 heads, hd 64, causal) beside ``scaled_dot_product_attention``.
Without a file it runs :data:`ABLATIONS`: the shipped kernel, and the
same kernel with one part of its work removed at a time, to show which
part holds it back.

``stream``: variants of ``csrc/ckpt_kernels.cu``'s streaming core
(``ckpt_delta_xor``, ``ckpt_downcast_bf16``), checked bit for bit against
``delta_xor_plain`` and the plain downcast at lengths around every
variant's tile (with :data:`.quantize.EDGE_BITS` in the inputs, and an
input sliced at a 4-byte offset) and at the main path's shapes, then timed
there: ``delta_xor`` at 16,777,216 words beside ``torch.bitwise_xor``,
``downcast_bf16`` at 128,256 x 2,048 fp32 beside ``x.to(torch.bfloat16)``.
Each is timed twice: the wrapper, back to back under CUDA events, and the
device alone, the kernels' own time under ``torch.profiler``
(:func:`device_ms`). Without a file it runs :data:`STREAM_ABLATIONS`:
``loop``, the grid-stride loop the two kernels ran before the core (one
load in flight a thread, a grid of at most 132 x 8 blocks); 1, 2, 4 and
8 loads in flight per thread and input; 256 threads a block against 512;
each kind of cache hint; a grid-stride loop over 132 x 4 blocks against
one pass; and design (B), bulk copies through shared memory. The summary
gives the median of the rounds.
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
QK = "    wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk);"
PV = "  for (int c = 0; c < 8; ++c) wgmma_pv(o, pa[c], dv + 128 * c);"
SOFTMAX_FIRST = (
    "      online_softmax(s, (t0 + first) * kTileK, t, whole(first), "
    "p.scale_log2,\n                     r, al_a, al_b);")
SOFTMAX_NEXT = (
    "        online_softmax(s, (t0 + it) * kTileK, t, whole(it), "
    "p.scale_log2, r,\n                       al_a, al_b);")
PACK = "pack_p(pa, s);"
KV_LOADS = """        mbar_expect_tx(bar_k + 8 * s, kTileBytes);
        tma_load(base + kSmemK + s * kTileBytes, &tm_k, bar_k + 8 * s, kvh,
                 jb, b);
        mbar_expect_tx(bar_v + 8 * s, kTileBytes);
        tma_load(base + kSmemV + s * kTileBytes, &tm_v, bar_v + 8 * s, kvh,
                 jb, b);"""
NO_EX2 = [[EX2, "  y = x;"]]
NO_PRODUCTS = [[QK, "    ;"], [PV, "  ;"]]
NO_SOFTMAX = [[SOFTMAX_FIRST, "al_a = al_b = 1.f;"],
              [SOFTMAX_NEXT, "al_a = al_b = 1.f;"], [PACK, ";"]]
NO_KV_LOADS = [[KV_LOADS, "        mbar_arrive(bar_k + 8 * s);\n"
                          "        mbar_arrive(bar_v + 8 * s);"]]
ATTENTION = "flash_attention.cu"
STREAM = "ckpt_kernels.cu"

#: the shipped kernel and ablations of it
ABLATIONS = {
    "kernel": [],
    "two_consumers": [["constexpr int kConsumers = 3;",
                       "constexpr int kConsumers = 2;"]],
    "three_stages": [["constexpr int kStages = 2;",
                      "constexpr int kStages = 3;"]],
    "x_no_ex2": NO_EX2,
    "x_no_products": NO_PRODUCTS,
    "x_no_softmax": NO_SOFTMAX,
    "x_loads_only": NO_PRODUCTS + NO_SOFTMAX,
    "x_nothing": NO_PRODUCTS + NO_SOFTMAX + NO_KV_LOADS,
}
#: bf16 (B, S, T, H, KV, kind, window, chunk) each variant must agree at
CHECKS = ((1, 128, 128, 1, 1, "full", 0, 0), (2, 129, 129, 4, 2, "full", 0, 0),
          (2, 300, 200, 32, 8, "window", 32, 0),
          (2, 2100, 2100, 32, 8, "chunked", 0, 192),
          (2, 4096, 4096, 32, 8, "full", 0, 0))
SERVE = (2, 4096, 32, 8)  # B, S, H, KV
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
    B, S, T, H, KV, kind, window, chunk = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S * 7 + T)
    q, k, v = (torch.randn(B, n, h, 64, device="cuda", generator=gen)
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


def device_ms(torch, fn, reps: int, tries: int = 3) -> float:
    """Device time of one call of ``fn``, which must launch one device
    operation a call: the mean self time of the device events (kernels,
    copies, fills) that ``torch.profiler`` records over ``reps``
    back-to-back calls. Host time between launches is left out. The
    profiler can drop records, so the mean is over the records it kept
    (dividing by ``reps`` would read low); a session that kept none is
    run again, up to ``tries`` times."""
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
            return sum(e.self_device_time_total for e in events) / n / 1e3
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
    B, S, H, KV = SERVE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = (torch.randn(B, S, h, 64, device="cuda", generator=gen)
               .to(torch.bfloat16) for h in (H, KV, KV))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    clocks = _sample_clocks()
    times = {name: [] for name in [*libs, "sdpa"]}
    try:
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                build._lib = lib
                times[name].append(_time_ms(
                    torch, lambda: fa.flash_attention_cuda(q, k, v)))
            times["sdpa"].append(_time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
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
        x = a.view(torch.float32)
        if not same(tq.downcast_bf16_words_cuda(x),
                    tq.downcast_bf16_words_plain(x)):
            return f"downcast_bf16 at {n} words"
    # sliced at a 4-byte offset: the wrappers clone to 16-byte alignment
    a, b = _stream_inputs(torch, tq, 4097 + 1, gen)
    a, b = a[1:], b[1:]
    if not same(delta.delta_xor_cuda(a, b), delta.delta_xor_plain(a, b)):
        return "delta_xor at a 4-byte offset"
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
    calls = {"downcast_bf16": (lambda: tq.downcast_bf16_cuda(x),
                               lambda: x.to(torch.bfloat16)),
             "delta_xor": (lambda: delta.delta_xor_cuda(a, b),
                           lambda: torch.bitwise_xor(a, b))}
    bound = {"delta_xor": 12 * XOR_WORDS / HBM_BYTES_PER_S * 1e3,
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


def main(argv) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("variants: needs a CUDA card")
    args = argv[1:]
    if args and args[0] == "stream":
        stream_main(args[1:])
    else:
        attention_main(args)


if __name__ == "__main__":
    main(sys.argv)

"""Build variants of the attention kernel's source and time them on the card.

    python -m repro_torch.kernels.variants [variants.json]

A variant is a list of ``[old, new]`` text substitutions applied to
``csrc/flash_attention.cu`` (each ``old`` must occur in the source). Each
variant is built into a library of its own under
``build/repro_torch/variants/<name>/`` with the flags of :mod:`.build`,
its ``flash_fwd_bf16`` ptxas lines are printed, its output is held against
:func:`.flash_attention.flash_attention_plain` at a few bf16 shapes, and
then every variant that agrees (and every one whose name starts with
``x_``: an ablation that removes work and cannot agree) is timed at the
serving shape (B 2, S 4,096, 32/8 heads, hd 64, causal) with CUDA events,
in alternating rounds beside ``scaled_dot_product_attention``. The SM
clock is sampled with ``nvidia-smi`` while the rounds run. The last line
is a JSON object of the times (ms) per variant.

Without a file it runs :data:`ABLATIONS`: the shipped kernel, and the
same kernel with one part of its work removed at a time, to show which
part holds it back. Times are comparable only within one run.
"""

from __future__ import annotations

import json
import shutil
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


def variant_source(subs) -> str:
    """The attention kernel's source with the substitutions applied."""
    text = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"not in flash_attention.cu: {old!r}")
        text = text.replace(old, new)
    return text


def _build(name: str, subs):
    """(ctypes library, ptxas lines of flash_fwd_bf16: registers, spills
    and performance notes such as serialised wgmma) of one variant."""
    root = build.BUILD_DIR / "variants" / name
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for src in build.SOURCES:
        (csrc / src.name).write_text(
            variant_source(subs) if src.name == "flash_attention.cu"
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
            on = "flash_fwd_bf16" in line
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


def _time_ms(torch, fn) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / REPS


def main(argv) -> None:
    import torch

    from . import flash_attention as fa
    if not torch.cuda.is_available():
        sys.exit("variants: needs a CUDA card")
    variants = json.loads(Path(argv[1]).read_text()) if len(argv) > 1 \
        else ABLATIONS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
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
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
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
        clocks.terminate()
        mhz = [float(x) for x in clocks.communicate()[0].split() if x]
    print(f"clocks.sm MHz {min(mhz, default=0)}-{max(mhz, default=0)}",
          flush=True)
    print(json.dumps(times), flush=True)


if __name__ == "__main__":
    main(sys.argv)

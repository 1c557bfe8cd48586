#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. Device: the card's name, the device count, and its name and power limit
   as ``nvidia-smi`` reports them. No card: exit non-zero, print no result.
2. Build: the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   (into ``build/repro_torch/``), timed.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   odd sizes and at the main path's shapes — results must be bit-identical
   — then timed with CUDA events beside its plain version, its bound, and
   (for ``delta_xor``) ``torch.bitwise_xor`` as the library yardstick.
4. Main path: llama3.2-1b at full width (d_model 2048, d_ff 8192, vocab
   128,256, 32/8 heads, tied embeddings) cut to 2 layers: 384.3 M params,
   bf16 params plus fp32 master/m/v, about 5.4 GB per save, made on the card
   from a seeded generator. Three steps of the two-phase loop (seeded
   gradients on the card; ``wait_for_capture``; in-place AdamW; ``save``)
   under ``DeltaPolicy(keyframe_every=3)`` give a keyframe and two deltas;
   then step 3 (chain verify + XOR fold) and step 1 restore onto the card and
   must equal the saved states bit for bit. Kernel launch counts are zeroed
   just before this phase and read just after; each kernel must have run.
5. Report: a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
#: H100 SXM device memory (data sheet). The three kernels do a few integer
#: operations per 4-byte word, so their bound is the bytes they move.
HBM_BYTES_PER_S = 3.35e12
HOST_CACHE_BYTES = 12 << 30
#: words per call on the main path: 4 MiB chunks for the encode and the
#: file checksums, 64 MiB pieces for the restore fold
MAIN_WORDS = {"checksum_u32": 1 << 20, "xor_checksum_u32": 1 << 20,
              "delta_xor": 1 << 24}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- kernels
def _kernels():
    from repro_torch.kernels import checksum, delta, fused
    return {"checksum_u32": checksum, "xor_checksum_u32": fused,
            "delta_xor": delta}


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
    launches made here are not counted: counts are zeroed before the main
    path."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {}
    for name in _kernels():
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
    return rows


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
        report["launches_save"] = {k: m.KERNEL.launches
                                   for k, m in _kernels().items()}
        for step, want in ((3, _tensors(state(3))), (1, step1)):
            before = {k: m.KERNEL.launches for k, m in _kernels().items()}
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
                   "launches": {k: m.KERNEL.launches - before[k]
                                for k, m in _kernels().items()}}
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


def main() -> None:
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

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

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
    shutil.rmtree(workdir, ignore_errors=True)
    kernels = _kernels()
    try:
        torch.cuda.reset_peak_memory_stats()
        for m in kernels.values():
            m.KERNEL.launches = 0
        t0 = time.perf_counter()
        report = run_main_path("cuda", cfg, workdir, HOST_CACHE_BYTES,
                               flush_threads=8)
        launches = {k: m.KERNEL.launches for k, m in kernels.items()}
        main_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for k, n in launches.items():
        if n == 0:
            fail(f"kernel {k} was never launched on the main path")
    log(f"main path: {main_s:.1f} s; launches {json.dumps(launches)} "
        f"(saves {json.dumps(report['launches_save'])}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
        f"pinned host cache {report['pinned_bytes']} bytes")
    log("report " + json.dumps(report))

    source = "src/repro_torch/kernels/csrc/ckpt_kernels.cu"
    replaces = {"checksum_u32": "src/repro/kernels/checksum.py:43",
                "xor_checksum_u32": "src/repro/kernels/fused.py:78",
                "delta_xor": "src/repro/kernels/delta.py:30"}
    line = {"kernels": [{
        "name": k, "route": "cuda", "source": source,
        "replaces": replaces[k], "launches": launches[k],
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

"""The harness's core: a cell's set-up, its window, its end-to-end
arithmetic, the comparison and the result line.

Set-up builds the cell's configuration (``configs/<config>.json`` over
the program's registered one), a ``CheckpointManager`` from the traffic
mix's policy and a ``Trainer`` built on the benchmark's weights, hands
it the benchmark's batches (:mod:`cardbench.data`), warms the save path
with a small state on a manager of its own, and drives the trainer's
first three steps through the window's own call, ``Trainer.run``. From
their step time it fixes the window: ``n`` steps that fill about
``--seconds``, and an interval ``K`` that puts a mix's saves at a
quarter, a half and three quarters of it. The window is one call,
``Trainer.run(n, ckpt_interval=K)``; it returns once every save it
requested has persisted and committed. Inside it, :class:`Snapshots`
copies the state at each save and around the step after the last one
(``3K + 1``) as the trainer fetches a batch, outside the save's time.
Then the saves are read back against those copies, and the reference
follows the first three steps from the seed and step ``3K + 1`` from
the program's state before it (:mod:`cardbench.check`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, data, reference
from .window import Window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the first steps, driven in set-up, that the reference follows
FIRST_STEPS = 3
#: what the first steps are judged by (:func:`check.training_numbers`)
TRAINING_NUMBERS = ("loss_gap", "grad_gap", "grad_err", "update_gap")
#: what the window's step after its last save (or at three quarters of
#: it) is judged by (:func:`check.window_numbers`)
WINDOW_NUMBERS = ("win_loss_gap", "win_grad_err", "win_update_gap")
#: a run's saves fall at these shares of the window
SAVE_SHARES = 4
#: top-level module names no run may have loaded (the JAX package is
#: ``repro``; the port, ``repro_torch``, shares its first letters only)
BANNED = ("jax", "jaxlib", "flax", "repro")
#: the configuration keys a config file may set, over the program's
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "layer_groups", "head_dim", "rope_theta", "window",
              "chunk", "use_bias", "tie_embeddings", "norm", "act",
              "n_codebooks", "n_memory_embeds", "n_prefix_embeds", "dtype",
              "remat", "attn_kv_block")


# ------------------------------------------------------------------- specs
def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def check_name(name: str) -> str:
    """A name of a config, traffic mix, cell or metric: a letter, digit
    or ``_`` first, then at most 63 of letters, digits, ``_``, ``.``
    and ``-``."""
    ok = 0 < len(name) <= 64 and (name[0].isascii() and (
        name[0].isalnum() or name[0] == "_")) and all(
        c.isascii() and (c.isalnum() or c in "_.-") for c in name)
    if not ok:
        raise ValueError(f"bad name {name!r}")
    return name


def cell_spec(workload: str, bench: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic mix and limits loaded, and the metrics it reports: the
    end-to-end and per-layer entries that list it (or list no cell)."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = dict(cells[check_name(workload)])
    cfgs = {c["name"]: c for c in bench["configs"]}
    cell["cfg"] = load_json(ROOT, cfgs[check_name(cell["config"])]["file"])
    cell["traffic_spec"] = load_json(HERE, "traffic",
                                     check_name(cell["traffic"]) + ".json")
    cell["limits"] = check.limits(workload)

    def mine(m):
        return workload in m.get("workloads", [workload])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if mine(m)]
    return cell


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", check_name(name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------- program
def program_config(cfgd: Dict[str, Any]):
    """The program's configuration: its registered ``program_config``
    with every key the file sets."""
    from repro_torch.configs.base import get_config
    over = {k: cfgd[k] for k in MODEL_KEYS if k in cfgd}
    if "layer_groups" in over:
        over["layer_groups"] = tuple((tuple(p), int(c))
                                     for p, c in over["layer_groups"])
    return dataclasses.replace(get_config(cfgd["program_config"]),
                               name=cfgd["name"], **over)


def policy(spec: Dict[str, Any]):
    """A ``CheckpointPolicy`` from a traffic mix's ``checkpoint`` entry:
    ``engine`` (``EnginePolicy``'s fields), ``delta`` (``DeltaPolicy``'s,
    or null) and ``providers`` (rules of a ``StateProviderRegistry``, or
    null for the default routing)."""
    from repro_torch.core import (CheckpointPolicy, DeltaPolicy,
                                  EnginePolicy, StateProviderRegistry)
    kw: Dict[str, Any] = {"engine": EnginePolicy(**spec.get("engine", {}))}
    if spec.get("delta") is not None:
        kw["delta"] = DeltaPolicy(**spec["delta"])
    if spec.get("providers") is not None:
        reg = StateProviderRegistry()
        for rule in spec["providers"]:
            reg = reg.add_rule(**rule)
        kw["providers"] = reg
    return CheckpointPolicy(**kw)


class Recorder:
    """The manager as the trainer sees it: every save's future kept, and
    the state each save was handed (no copy: :class:`Snapshots` copies
    it as the next step fetches its batch, outside the save's time)."""

    def __init__(self, manager):
        self.manager = manager
        self.futures: List[Any] = []
        self.handed: Dict[int, Dict[str, Any]] = {}

    def __getattr__(self, name):
        return getattr(self.manager, name)

    def save(self, step, state, blocking=False):
        self.handed[step] = state
        fut = self.manager.save(step, state, blocking)
        self.futures.append(fut)
        return fut


class Snapshots:
    """Copies of the trainer's state at chosen steps, taken on its device
    as the trainer fetches the batch of the step that follows: after the
    step's update and before the next one, and outside the manager's
    save, which the trainer times as its stall. The trainer updates its
    tensors in place, so the tensors found in set-up are the ones each
    save is handed. The buffers are allocated in set-up, one a dtype a
    step, and filled by one ``torch._foreach_copy_`` a dtype, run once in
    set-up so that its kernels are loaded there; each copy's host and
    device time is kept (:meth:`costs`), so that it can be told apart
    from the program's."""

    def __init__(self, trainer, rec: Recorder, steps: List[int], device):
        self.rec = rec
        self.on_card = torch.device(device).type == "cuda"
        tensors = [(p, t.detach()) for p, t in
                   data.flatten(trainer.state(), "state")
                   if isinstance(t, torch.Tensor)]
        sizes: Dict[torch.dtype, int] = {}
        for _p, t in tensors:
            sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
        self.views: Dict[int, Dict[str, torch.Tensor]] = {}
        self.groups: Dict[int, List[Tuple[list, list]]] = {}
        self.nbytes = 0
        for step in steps:
            bufs = {dt: torch.empty(n, dtype=dt, device=device)
                    for dt, n in sizes.items()}
            self.nbytes += sum(b.numel() * b.element_size()
                               for b in bufs.values())
            pos = dict.fromkeys(bufs, 0)
            groups = {dt: ([], []) for dt in bufs}
            views = {}
            for p, t in tensors:
                n = t.numel()
                views[p] = bufs[t.dtype][pos[t.dtype]:pos[t.dtype] + n] \
                    .view(t.shape)
                pos[t.dtype] += n
                groups[t.dtype][0].append(views[p])
                groups[t.dtype][1].append(t)
            self.views[step] = views
            self.groups[step] = list(groups.values())
        self.taken: List[int] = []
        self._costs: List[Tuple[int, float, Any, Any]] = []
        if steps:
            self._copy(steps[0])

    def _copy(self, step: int) -> None:
        with torch.no_grad():
            for dst, src in self.groups[step]:
                torch._foreach_copy_(dst, src)

    def __call__(self, step: int) -> None:
        """The pipeline's hook (``Batches.on_fetch``): ``step`` updates
        done."""
        if step not in self.groups or step in self.taken:
            return
        t0 = time.perf_counter()
        ev = (None, None)
        if self.on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        self._copy(step)
        if self.on_card:
            ev[1].record()
        self._costs.append((step, time.perf_counter() - t0, *ev))
        self.taken.append(step)

    def for_save(self, step: int) -> Dict[str, Any]:
        """The copy at ``step`` as :func:`check.save_numbers` takes it:
        each tensor's bytes, and the objects of the state the save was
        handed (built afresh for each save, so as they were then)."""
        return {"step": step,
                "leaves": {p: t.reshape(-1).view(torch.uint8)
                           for p, t in self.views[step].items()},
                "objects": {p: v for p, v in
                            data.flatten(self.rec.handed[step], "state")
                            if not isinstance(v, torch.Tensor)}}

    def training_state(self, step: int) -> Dict[str, Dict[str, Any]]:
        """The copy at ``step`` by the parameters' paths: ``params``,
        ``master``, ``m`` and ``v``, each leaf in its shape."""
        views = self.views[step]
        return {part: {p[len(pre):]: t for p, t in views.items()
                       if p.startswith(pre)}
                for part, pre in (("params", "state/model/"),
                                  ("master", "state/optimizer/master/"),
                                  ("m", "state/optimizer/m/"),
                                  ("v", "state/optimizer/v/"))}

    def keep_only(self, step: int) -> None:
        """Free every copy but ``step``'s."""
        self.views = {step: self.views[step]}
        self.groups = {}

    def costs(self) -> List[Tuple[int, float, float]]:
        """``(step, host ms, device ms)`` of each copy taken."""
        if self.on_card:
            torch.cuda.synchronize()
        return [(s, 1e3 * h, a.elapsed_time(b) if a is not None else 0.0)
                for s, h, a, b in self._costs]


def _warm_save_path(spec: Dict[str, Any], root: str, device) -> None:
    """Two saves of a small state through a manager of the cell's policy
    (a small host cache), so the save path's kernels and lanes have run
    once before the window."""
    from repro_torch.core import CheckpointManager
    pol = policy(spec)
    pol = pol.replace(engine=dataclasses.replace(pol.engine,
                                                 host_cache_bytes=64 << 20))
    mgr = CheckpointManager.from_policy(os.path.join(root, "warm"), pol,
                                        device=device)
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        state = {"model": {"w": torch.randn(1 << 20, generator=gen,
                                            device=device)
                           .to(torch.bfloat16)},
                 "optimizer": {"m": torch.randn(1 << 20, generator=gen,
                                                device=device),
                               "count": torch.zeros((), dtype=torch.int32,
                                                    device=device)},
                 "meta": {"step": 0}}
        for step in (1, 2):
            state["model"]["w"].add_(1)
            state["optimizer"]["m"].add_(1)
            mgr.save(step, state)
            mgr.wait_for_capture()
        mgr.wait_for_persist()
        mgr.wait_for_commit()
    finally:
        mgr.close()
    shutil.rmtree(os.path.join(root, "warm"), ignore_errors=True)


def _leaf_norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(t.detach().float())) * scale
            for p, t in data.flatten(tree)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bytes_written() -> int:
    """This process's bytes sent to storage so far (Linux)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, fs in os.walk(root) for f in fs)


# -------------------------------------------------------------------- cell
def param_specs(cfg) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """``(path, shape, dtype)`` of each parameter the program's model
    takes."""
    from repro_torch.models import model as M
    return [(p, tuple(s.shape), _dtype(s.dtype))
            for p, s in data.flatten(M.param_shapes(cfg))]


@contextlib.contextmanager
def _weights_of(tree):
    """While the trainer is built, the program's model takes ``tree`` for
    its weights in place of a draw of its own, so that the trainer and
    its optimizer state are built once, from the benchmark's weights."""
    from repro_torch.models import model as M
    draw = M.init_params
    M.init_params = lambda *_a, **_k: tree
    try:
        yield
    finally:
        M.init_params = draw


def build(cell: Dict[str, Any], seed: int, device, root: str,
          prepare: Optional[Callable] = None,
          mark: Callable[[str], None] = lambda _name: None):
    """The cell's manager (behind a :class:`Recorder`) and trainer, the
    trainer holding the benchmark's weights and batches; then the first
    steps, through ``Trainer.run``. Returns ``(trainer, recorder,
    readings)``, the readings the comparison takes of the first steps.
    ``mark(name)`` is called as each part of it ends."""
    from repro_torch.core import CheckpointManager
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.loop import Trainer

    cfgd, tr = cell["cfg"], cell["traffic_spec"]
    cfg = program_config(cfgd)
    hp = AdamWConfig(**tr["adamw"])
    mgr = CheckpointManager.from_policy(os.path.join(root, "ckpt"),
                                        policy(tr["checkpoint"]),
                                        device=device)
    rec = Recorder(mgr)
    mark("manager")
    specs = param_specs(cfg)
    with _weights_of(data.rebuild(M.param_shapes(cfg),
                                  data.draw_weights(specs, seed, device))):
        trainer = Trainer(cfg, batch=tr["batch"], seq_len=tr["seq_len"],
                          hp=hp, manager=rec, seed=seed, device=device)
    trainer.pipeline = data.Batches(cfgd, tr["batch"], tr["seq_len"], seed)
    mark("trainer")
    if prepare is not None:
        prepare(trainer)
    trainer.run(1)
    grad1 = _leaf_norms(trainer.opt_state["m"], 1.0 / (1.0 - hp.b1))
    # the first gradient as the optimizer took it, kept on the host until
    # the reference runs
    grad1_t = {p: (t.detach() / (1.0 - hp.b1)).to("cpu")
               for p, t in data.flatten(trainer.opt_state["m"])}
    first = trainer.run(FIRST_STEPS - 1)
    with torch.no_grad():
        w0 = data.draw_weights(specs, seed, device)
        master = dict(data.flatten(trainer.opt_state["master"]))
        change = {p: float(torch.linalg.vector_norm(
            master[p] - w0[p].float())) for p in w0}
        del w0, master
    mark("first steps")
    return trainer, rec, {"losses": [r.loss for r in first[:FIRST_STEPS]],
                          "grad1": grad1, "grad1_t": grad1_t,
                          "change": change}


def release(trainer, rec, device) -> None:
    """Free the program's state, so that the reference runs alone."""
    rec.handed.clear()
    trainer.params = trainer.opt_state = None
    rec.manager.close()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def window_step(snaps: Snapshots, records, step: int, b1: float
                ) -> Dict[str, Any]:
    """The program's window step ``step + 1`` from its copies before and
    after it: its recorded ``loss``, ``grad_t`` (each leaf's gradient as
    the optimizer took it, from the two first moments) and ``change``
    (each leaf's norm of its master weight's change)."""
    a, b = snaps.training_state(step), snaps.training_state(step + 1)
    loss = next((r.loss for r in records if r.step == step + 1),
                float("nan"))
    with torch.no_grad():
        grad_t = {p: (b["m"][p] - b1 * a["m"][p]) / (1.0 - b1)
                  for p in a["m"]}
        change = {p: float(torch.linalg.vector_norm(
            b["master"][p] - a["master"][p])) for p in a["master"]}
    return {"loss": loss, "grad_t": grad_t, "change": change}


def run_cell(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
             device, t_start: float, prepare: Optional[Callable] = None,
             in_window: Optional[Callable] = None,
             keep: bool = False) -> Dict[str, Any]:
    """One run of ``cell`` (:func:`cell_spec`'s). ``prepare(trainer)``
    runs before the first step and ``in_window(trainer)`` before the
    window (a test plants a fault there). Returns the result line's
    fields and ``log`` (lines for standard error); with ``keep``, also
    ``internals``, what the comparison read of both sides."""
    tr = cell["traffic_spec"]
    B, S = tr["batch"], tr["seq_len"]
    saves = int(tr.get("saves", 0))
    on_card = torch.device(device).type == "cuda"
    marks = [("start", t_start)]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))
    mark("imports")
    io0 = _bytes_written()
    if on_card:
        from repro_torch.kernels import build as kernels
        kernels.library()
        mark("kernels")
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        mark("cuda context")
    root = tempfile.mkdtemp(prefix="cardbench-")
    log: List[str] = []
    try:
        if saves:
            _warm_save_path(tr["checkpoint"], root, device)
            mark("warm saves")
        trainer, rec, prog = build(cell, seed, device, root, prepare, mark)
        s0 = trainer.step
        # the quicker warm step: one slowed by the host would shorten the
        # window
        t_step = min(r.iter_s for r in trainer.records[1:FIRST_STEPS])
        n_want = max(8, round(seconds / t_step))
        # saves at a quarter, a half and three quarters of the window;
        # the window step held against the reference follows the last
        K = max(s0 + 1, round((s0 + 1 + n_want) / SAVE_SHARES))
        n = SAVE_SHARES * K - 1 - s0
        save_steps = [i * K for i in range(1, SAVE_SHARES)] if saves else []
        j = (SAVE_SHARES - 1) * K
        peak0 = torch.cuda.max_memory_allocated() if on_card else 0
        snaps = Snapshots(trainer, rec, sorted({*save_steps, j, j + 1}),
                          device)
        trainer.pipeline.on_fetch = snaps
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        if in_window is not None:
            in_window(trainer)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        mark("snapshot buffers")
        log.append("set-up: " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
            + f"; first steps {[round(r.iter_s, 4) for r in trainer.records]}"
            f" s")

        with Window(trace and on_card) as win:
            trainer.run(n, ckpt_interval=K if saves else 0)
        recs = trainer.records[s0:]
        # the program's peak: the benchmark's copies are left out
        peak = max(peak0, torch.cuda.max_memory_allocated() - snaps.nbytes) \
            if on_card else 0
        summary = win.summary() if win.trace else None
        futures = rec.futures
        ckpt = os.path.join(root, "ckpt")
        written = _dir_bytes(ckpt)
        ctx = types.SimpleNamespace(
            cfg=cell["cfg"], traffic=tr, records=recs, window_s=win.seconds,
            tokens=len(recs) * B * S, futures=futures, setup_s=setup_s,
            exit_drain_s=trainer.exit_drain_s, summary=summary,
            ckpt_root=ckpt, written_bytes=written,
            kind=torch.cuda.get_device_name() if on_card else "cpu")
        metrics = {}
        for m in (cell["per_layer"] if trace else cell["end_to_end"]):
            value = metric_reader(m["name"])(ctx) if trace \
                else END_TO_END[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        numbers: Dict[str, float] = {}
        if saves:
            handed = [s for s in save_steps
                      if s in rec.handed and s in snaps.taken]
            sv = check.save_numbers(ckpt, [snaps.for_save(s)
                                           for s in handed], device)
            numbers.update({k: v for k, v in sv.items() if k != "notes"})
            numbers["saves_missing"] += saves - len(handed)
            log += [f"save check: {note}" for note in sv["notes"]]
        log.append(f"written: {written} bytes in {len(futures)} saves "
                   f"({_bytes_written() - io0} bytes to storage by this "
                   f"process)")
        iters = [r.iter_s for r in recs]
        log.append(
            f"window: {len(recs)} steps, slowest {max(iters):.4f} s, median "
            f"{float(np.median(iters)):.4f} s; stall "
            f"{sum(r.ckpt_stall_s for r in recs):.4f} s with the exit drain "
            f"{trainer.exit_drain_s:.4f} s; saves at {save_steps}, persist "
            f"{[round(f.stats.persist_latency_s, 3) for f in futures]} s, "
            f"blocking {[round(f.stats.blocking_s, 4) for f in futures]} s")
        log.append(f"snapshots ({snaps.nbytes} bytes, left out of the peak):"
                   f" (step, host ms, device ms) "
                   f"{[tuple(round(x, 3) for x in c) for c in snaps.costs()]}")
        ws_prog = window_step(snaps, trainer.records, j,
                              float(tr["adamw"]["b1"]))
        release(trainer, rec, device)
        del trainer, rec
        snaps.keep_only(j)
        t_ref = time.perf_counter()
        ref = reference_steps(cell, seed, device)
        tn = check.training_numbers(prog, ref)
        ws_state = snaps.training_state(j)
        ws_ref = reference.step_from(
            cell["cfg"], tr["adamw"], ws_state, j + 1,
            data.Batches(cell["cfg"], B, S, seed).at(j, device))
        wn = check.window_numbers(ws_prog, ws_ref)
        log.append(f"reference: {time.perf_counter() - t_ref:.3f} s; save "
                   f"check and release before it "
                   f"{t_ref - win.t1:.3f} s")
        numbers.update({k: tn[k] for k in TRAINING_NUMBERS})
        numbers.update({k: wn[k] for k in WINDOW_NUMBERS})
        log.append(f"worst leaves: {tn['worst']}; window step {j + 1}: "
                   f"{wn['worst']}; left out of update_gap: "
                   f"{tn['left_out']}, of win_update_gap: {wn['left_out']}")
        correct, rows = check.judge(numbers, cell["limits"])
        out = {"correct": correct, "attempted": len(recs) + len(futures),
               "failed": int(numbers.get("saves_missing", 0)),
               "metrics": metrics,
               "device": {"platform": "gpu" if on_card else "cpu",
                          "kind": ctx.kind, "count": 1,
                          "memory_peak_bytes": int(peak)},
               "steps": len(recs), "interval": K, "setup_s": setup_s,
               "window_s": win.seconds, "rows": rows, "log": log}
        if summary is not None:
            out["device"]["busy_s"] = summary["busy_s"]
            out["device"]["window_s"] = win.seconds
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
        if keep:
            out["internals"] = {"prog": prog, "ref": ref, "ws_prog": ws_prog,
                                "ws_ref": ws_ref, "ws_state": ws_state,
                                "ws_n": j + 1, "ws_batch": j}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def reference_steps(cell: Dict[str, Any], seed: int, device,
                    mm: Callable = reference.matmul,
                    half_batch: bool = False) -> Dict[str, Any]:
    """The reference over the cell's first steps, from the same weights
    and batches (drawn again from the seed)."""
    cfgd, tr = cell["cfg"], cell["traffic_spec"]
    w0 = data.draw_weights(param_specs(program_config(cfgd)), seed, device)
    feed = data.Batches(cfgd, tr["batch"], tr["seq_len"], seed)
    batches = [feed.at(i, device) for i in range(FIRST_STEPS)]
    return reference.train_steps(cfgd, tr["adamw"], w0, batches, mm,
                                 half_batch)


# --------------------------------------------------------- end to end
END_TO_END: Dict[str, Callable] = {
    "train_tokens_per_s": lambda c: c.tokens / c.window_s,
    # the same rate in the cells whose step the host's launches hold,
    # under a bound of their own
    "train_tokens_per_s.hostbound": lambda c: c.tokens / c.window_s,
    "step_ms_p95": lambda c: 1000.0 * float(np.percentile(
        [r.iter_s for r in c.records], 95)),
    "setup_s": lambda c: c.setup_s,
}


# ------------------------------------------------------------------ main
def loaded_banned() -> List[str]:
    """The modules loaded whose whole top-level name is banned."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in BANNED})


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def result_line(out: Dict[str, Any]) -> Dict[str, Any]:
    """The result's line: the driver's keys, then ``checks`` (each number
    compared, with its limit) last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out["rows"]}
    return line


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="cardbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell_spec(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    bad = loaded_banned()
    if bad:
        print(f"cardbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 5
    for line in out["log"]:
        print(line, file=sys.stderr)
    print(f"card: {_card_line()}; steps {out['steps']}, interval "
          f"{out['interval']}, window {out['window_s']!r} s",
          file=sys.stderr)
    for name, v, lim in out["rows"]:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    line = result_line(out)
    print(json.dumps(line))
    return 0

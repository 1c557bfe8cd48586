"""The port's examples (``examples/torch/``), each through its ``main``
with ``--device cpu`` at its smallest setting, gated on what it prints,
and held on structure against the JAX package's examples and manager.

Parameters differ between the packages for the same seed, so losses are
not compared across packages: the differential example's chain (keyframe,
base step, depth of each step) is the reference manager's for the same
policy and six saves, the quickstart's domain routing is what the
reference commits for the same policy and state structure, and the
elastic example's per-device shard shapes are what the reference's
``examples/elastic_resume.py`` prints on 8 forced CPU devices.
"""

import ast
import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
from conftest import run_in_subprocess  # noqa: E402

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import to_numpy_state  # noqa: E402
from repro_torch.training.loop import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, capsys) -> str:
    assert _example(name).main(argv) == 0
    return capsys.readouterr().out


def _after(text: str, prefix: str):
    """The Python literal printed after ``prefix`` on its line."""
    for line in text.splitlines():
        if prefix in line:
            return ast.literal_eval(line.split(prefix, 1)[1].strip())
    raise AssertionError(f"no line with {prefix!r} in:\n{text}")


def test_quickstart_gates_and_routing_match_reference(tmp_path, capsys):
    out = _run("quickstart", ["--device", "cpu", "--workdir",
                              str(tmp_path)], capsys)
    assert "resumed at step 6" in out
    assert "restored trainer reproduces the original trajectory ✓" in out
    got = _after(out, "domain routing on disk:")
    assert got == {"model": ["tensor"], "optimizer": ["tensor"],
                   "meta": ["object"]}
    # the reference's routing of the same policy and state structure
    cfg = smoke_variant(get_config("llama3.2-1b"))
    state = to_numpy_state(Trainer(cfg, batch=4, seq_len=64,
                                   device="cpu").state())
    policy = J.CheckpointPolicy(
        engine=J.EnginePolicy(mode="datastates", host_cache_bytes=256 << 20),
        providers=(J.StateProviderRegistry()
                   .add_rule(provider="tensor", domain="model")
                   .add_rule(provider="auto")))
    jm = J.CheckpointManager.from_policy(str(tmp_path / "ref"), policy)
    try:
        jm.save(6, state, blocking=True)
        jm.wait_for_commit()
        man = jm.repository.manifest(6)
    finally:
        jm.close()
    assert got == {d: v["providers"] for d, v in man.meta["domains"].items()}
    assert os.listdir(tmp_path) == ["ref"]  # the example's directory is gone


_STEP = re.compile(r"step (\d+): (keyframe|delta→(\d+))\s+[\d.]+ MB on disk "
                   r"\(chain depth (\d+)\)")


def test_differential_chain_matches_reference(tmp_path, capsys):
    out = _run("differential_checkpointing",
               ["--device", "cpu", "--workdir", str(tmp_path)], capsys)
    assert "differential chain restore is bit-exact ✓" in out
    assert "after keep-last-1 GC the chain survives: [5, 6]" in out
    got = [(int(step), kind == "keyframe", int(base) if base else None,
            int(depth)) for step, kind, base, depth in _STEP.findall(out)]
    assert [g[0] for g in got] == [1, 2, 3, 4, 5, 6]
    # the reference manager under the same policy, six saves
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    jm = J.CheckpointManager.from_policy(
        str(tmp_path / "ref"),
        J.CheckpointPolicy(delta=J.DeltaPolicy(keyframe_every=4)))
    want = []
    try:
        for step in range(1, 7):
            w[step] += 1.0
            jm.save(step, {"model": {"w": w.copy()}, "meta": {"step": step}},
                    blocking=True)
            jm.wait_for_commit()
            meta = jm.repository.manifest(step).meta["delta"]
            want.append((step, meta["keyframe"],
                         None if meta["keyframe"] else meta["base_step"],
                         meta["chain_depth"]))
    finally:
        jm.close()
    assert got == want


def test_elastic_shard_shapes_match_reference_example(tmp_path, capsys):
    out = _run("elastic_resume", ["--device", "cpu", "--workdir",
                                  str(tmp_path)], capsys)
    assert "saved on mesh (4, 2) (8 virtual devices on cpu)" in out
    assert "elastic resume across mesh shapes ✓" in out
    assert re.search(r"restore stats: 0\.25 MiB in \d+ ranged reads across "
                     r"8 files", out)
    got = _after(out, "per-device shard shape")
    ref = run_in_subprocess(
        "import runpy, sys\n"
        f"sys.argv = [{os.path.join(ROOT, 'examples', 'elastic_resume.py')!r}]\n"
        "try:\n"
        "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n", n_devices=8, timeout=300)
    assert "elastic resume across mesh shapes ✓" in ref
    assert got == _after(ref, "per-device shard shape") == [(64, 64)]


def test_engine_comparison_runs_all_four_engines(tmp_path, capsys):
    out = _run("engine_comparison", ["--device", "cpu", "--steps", "1",
                                     "--workdir", str(tmp_path)], capsys)
    rows = [line.split()[0] for line in out.splitlines()[1:5]]
    assert rows == ["sync", "snapshot", "datastates-old", "datastates"]
    assert "DataStates end-to-end speedup vs DeepSpeed-default:" in out
    ec = _example("engine_comparison")
    cfg = ec.small_model()
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == \
        ("llama-20m", 4, 384, 6, 2, 1024, 8192)
    assert os.listdir(tmp_path) == []


def test_serve_restore_generates_from_the_checkpoint(tmp_path, capsys):
    out = _run("serve_restore", ["--device", "cpu", "--workdir",
                                 str(tmp_path)], capsys)
    assert "trained 4 steps, checkpoint persisted" in out
    assert "served batch of 4 prompts → completions (4, 16):" in out
    assert "batched serve-from-checkpoint ✓" in out


def test_train_100m_resumes_on_the_uninterrupted_trajectory(tmp_path,
                                                             capsys):
    ckpt = tmp_path / "ckpt"
    out = _run("train_100m", ["--fast", "--steps", "5", "--device", "cpu",
                              "--ckpt-dir", str(ckpt)], capsys)
    assert "model: llama-100m  params≈74.9M" in out
    assert "phase 1: 3 steps in" in out
    assert "phase 2: resumed from step 3" in out
    assert "resumed trajectory matches uninterrupted run over 2 steps ✓" \
        in out
    args = _example("train_100m").parse_args(["--fast"])
    assert (args.seq_len, args.batch, args.ckpt_interval, args.steps,
            args.ckpt_dir, args.device) == \
        (64, 2, 3, 12, "/tmp/repro_torch_100m_ckpt", "cuda")

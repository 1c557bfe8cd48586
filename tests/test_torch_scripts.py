"""The port's scripts (``scripts/torch/``) and ``obs.metrics.
cascade_report``, on the CPU.

``ckpt_tuning.run_one`` saves a 4 MiB state; ``hillclimb.py`` traces two
variants of one (arch x shape) into a temporary directory through
``python -m repro_torch.launch.dryrun``; the port's
``experiments_report.py`` reads those records; the reference's
``scripts/roofline_report.py`` reads them as they are; and
``cascade_report`` gives the reference's dict for the same event fields.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.obs.metrics import cascade_report as jcascade_report  # noqa: E402
from repro.storage.repository import CascadeEvent as JCascadeEvent  # noqa: E402

from repro_torch.obs import cascade_report  # noqa: E402
from repro_torch.storage.repository import CascadeEvent  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "llama3.2-1b", "decode_32k"


def _script(name):
    path = os.path.join(ROOT, "scripts", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"scripts_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ckpt_tuning_run_one_on_cpu(tmp_path):
    tuning = _script("ckpt_tuning")
    state = tuning.make_state(4, "cpu")
    assert state["dev"].device.type == "cpu"
    row = tuning.run_one(state, 1, 2, "cpu", workdir=str(tmp_path))
    assert (row["chunk_mb"], row["threads"]) == (1, 2)
    assert 0 < row["blocking_s"] <= row["persist_s"]
    assert row["capture_s"] >= 0
    # 4 MiB of tensors: the host array and the tensor, 2 MiB each
    assert row["persist_tput_gbps"] == pytest.approx(
        (4 << 20) / row["persist_s"] / 1e9)
    assert os.listdir(tmp_path) == []  # its temporary directory is gone


@pytest.fixture(scope="module")
def hill_dir(tmp_path_factory):
    """Two hillclimb variants of one (arch x shape): the records' log and
    each run's printed table."""
    out = tmp_path_factory.mktemp("perf")
    env = dict(os.environ, REPRO_DRYRUN_MESH="2,2")
    tables = []
    for label, extra in (("baseline", []),
                         ("kv2048", ["--set", "attn_kv_block=2048"])):
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "torch",
                                          "hillclimb.py"),
             "--arch", ARCH, "--shape", SHAPE, "--label", label,
             "--hypothesis", f"h-{label}", "--out-dir", str(out)] + extra,
            env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        tables.append(r.stdout)
    return out, tables


def test_hillclimb_logs_and_compares_two_variants(hill_dir):
    out, tables = hill_dir
    assert sorted(os.listdir(out)) == [f"torch_{ARCH}_{SHAPE}.jsonl"]
    with open(out / f"torch_{ARCH}_{SHAPE}.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["label"] for r in recs] == ["baseline", "kv2048"]
    assert [r["hypothesis"] for r in recs] == ["h-baseline", "h-kv2048"]
    assert recs[1]["overrides"] == {"attn_kv_block": 2048}
    assert all(r["mesh"] == "2x2" and r["arch"] == ARCH for r in recs)
    assert "kv2048" not in tables[0]
    last = tables[1].splitlines()
    rows = [line for line in last if line.startswith(("baseline", "kv2048"))]
    assert len(rows) == 2 and rows[0].rstrip().endswith("+0.0%")


def test_experiments_report_reads_port_records(hill_dir, tmp_path, capsys):
    out, _ = hill_dir
    with open(out / f"torch_{ARCH}_{SHAPE}.jsonl") as f:
        rec = json.loads(f.readline())
    for pod in ("pod", "multipod"):
        with open(tmp_path / f"{ARCH}_{SHAPE}_{pod}.json", "w") as f:
            json.dump(rec, f)
    report = _script("experiments_report")
    assert report.main(["--dir", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    m = rec["roofline"]["memory"]
    gib = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
           + m["output_size_in_bytes"] - m["alias_size_in_bytes"]) / 2**30
    cell = f"✓ {rec['trace_s']:.0f}s"
    assert f"| {ARCH} | {SHAPE} | {cell} | {cell} | {gib:.2f} |" \
        in text.splitlines()
    lb_ms = rec["roofline"]["terms"]["memory_lb_s"] * 1e3
    roof = [line for line in text.splitlines()
            if line.startswith(f"| {ARCH} | {SHAPE} | ")
            and "lb-dominant" in line]
    assert len(roof) == 1 and f"| {lb_ms:,.1f} |" in roof[0]
    hbm = rec["roofline"]["hw"]["hbm_bw"]
    assert f"{hbm / 1e9:,.0f} GB/s HBM" in text
    assert "819" not in text and "v5e" not in text
    assert "**2 traces OK, 0 skips documented, 86 pending.**" in text


def test_reference_roofline_report_reads_port_records(hill_dir, tmp_path):
    """``scripts/roofline_report.py`` (the reference's, unchanged) reads a
    port record and a port skip record as they are, from the directory it
    is run in."""
    out, _ = hill_dir
    with open(out / f"torch_{ARCH}_{SHAPE}.jsonl") as f:
        rec = json.loads(f.readline())
    d = tmp_path / "experiments" / "dryrun"
    d.mkdir(parents=True)
    with open(d / f"{ARCH}_{SHAPE}_pod.json", "w") as f:
        json.dump(rec, f)
    from repro_torch.launch.dryrun import run_dryrun
    skip = run_dryrun(ARCH, "long_500k", verbose=False)
    assert skip["skipped"]
    with open(d / f"{ARCH}_long_500k_pod.json", "w") as f:
        json.dump(skip, f)
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "roofline_report.py"), "--md"], cwd=tmp_path,
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    t = rec["roofline"]["terms"]
    dom = rec["roofline"]["dominant"].replace("_s", "")
    row = [line for line in lines if line.startswith(f"| {ARCH} | {SHAPE}")]
    assert len(row) == 1
    assert f"| {dom} | {rec['roofline']['useful_flops_ratio']:.2f} |" \
        in row[0]
    assert f"{t['memory_s'] * 1e3:6.1f}ms" in row[0]
    assert any(line.startswith(f"| {ARCH} | long_500k | — | — | — | "
                               f"skipped") for line in lines)
    assert "1 compiled + 1 documented skips (pod mesh)" in r.stdout
    shutil.rmtree(d)


@pytest.mark.parametrize("fields", [
    {"step": 3, "tier": "s3", "nbytes": 1 << 20, "t_start": 1.25,
     "t_end": 2.75},
    {"step": 0, "tier": "memory", "nbytes": 0, "t_start": 5.0,
     "t_end": 5.0},
])
def test_cascade_report_matches_reference(fields):
    got = cascade_report(CascadeEvent(**fields))
    want = jcascade_report(JCascadeEvent(**fields))
    assert got == want
    assert got["kind"] == "cascade"
    assert got["phases"]["upload_s"] == fields["t_end"] - fields["t_start"]

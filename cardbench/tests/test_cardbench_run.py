"""A whole run of a cell at the CPU size: the result line's shape and
the import guard (whole top-level names: ``repro_torch`` allowed, the
JAX package ``repro`` refused)."""

import json
import os
import subprocess
import sys
import time

import pytest

from cardbench import harness
from cardbench.tests.small import small_cell


def test_result_line_shape():
    cell = small_cell("mg-ckpt-lazy")
    out = harness.run_cell(cell, 2**31 + 11, 0.3, False, "cpu",
                           time.perf_counter())
    line = json.loads(json.dumps(harness.result_line(out)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    # at the CPU's widths some small leaves' update numbers read near the
    # limits set at the chip's (attn/bk's window update up to 0.034 over
    # eight seeds, against 0.024); the verdict is its checks' own
    assert line["correct"] == all(c["value"] <= c["limit"]
                                  for c in line["checks"].values())
    assert line["failed"] == 0
    assert line["attempted"] == out["steps"] + 3
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for m in cell["end_to_end"]:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert any(x.startswith("written: ") for x in out["log"])


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.core", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.engine"], ["repro.core.engine"]),
    (["jax", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
    (["reprox", "jax_like", "myjax"], [])])
def test_import_guard(monkeypatch, names, bad):
    kept = {m: v for m, v in sys.modules.items()
            if m.split(".", 1)[0] not in harness.BANNED}
    monkeypatch.setattr(sys, "modules", {**kept, **{n: None for n in names}})
    assert harness.loaded_banned() == bad


def test_no_card_no_result():
    """On a host without a card the run exits non-zero and prints no
    result line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "mg-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""

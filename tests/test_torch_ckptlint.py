"""The port's ckptlint held against the JAX package's: the same findings
on every reference fixture, CKPT401 on PyTorch's in-place tensor methods
(``tests/fixtures/ckptlint_torch/``), the port's own clean-tree gate, its
lock tables against its lock registry, and its CLI."""

import importlib
import json
import os
import pkgutil
import re

import pytest

pytest.importorskip("torch")

from repro.analysis import linter as ref_linter  # noqa: E402
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import linter, lockorder  # noqa: E402
from repro_torch.analysis.locks import LOCK_REGISTRY  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, ".."))
FIXTURES = os.path.join(HERE, "fixtures", "ckptlint")
TORCH_FIXTURES = os.path.join(HERE, "fixtures", "ckptlint_torch")
PORT_SRC = os.path.join(REPO, "src", "repro_torch")

_EXPECT_RE = re.compile(r"EXPECT:(CKPT\d+)")


def _key(findings):
    return {(f.rule, f.path, f.line, f.col, f.suppressed) for f in findings}


@pytest.mark.parametrize("name", sorted(os.listdir(FIXTURES)))
def test_reference_fixtures_give_the_references_findings(name):
    path = os.path.join(FIXTURES, name)
    got = linter.run([path], root=REPO)
    want = ref_linter.run([path], root=REPO)
    assert _key(got[0]) == _key(want[0])
    assert _key(got[1]) == _key(want[1])
    assert [f.message for f in got[0]] == [f.message for f in want[0]]


def test_ckpt401_catches_in_place_tensor_methods():
    path = os.path.join(TORCH_FIXTURES, "snapshot_torch_violation.py")
    want = set()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            want |= {(rule, lineno) for rule in _EXPECT_RE.findall(line)}
    active, suppressed = linter.run([path], root=REPO)
    assert not suppressed
    assert {(f.rule, f.line) for f in active} == want
    assert {f.message.split(" reservation")[0] for f in active} \
        == {"in-place copy_() on", "in-place add_() on",
            "in-place zero_() on", "store into"}


def test_port_clean_tree_gate():
    """``src/repro_torch`` lints clean under the port's rules, with no
    suppression at all (growing this set is a review event)."""
    active, suppressed = linter.run([PORT_SRC], root=REPO)
    assert active == [], "\n".join(f.format() for f in active)
    assert {(f.path, f.rule) for f in suppressed} == set()


def test_no_port_file_carries_a_suppression():
    for dirpath, _dirs, files in os.walk(PORT_SRC):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    mod = linter.SourceModule(f.name, fn, f.read())
                assert mod.suppressions == {}, fn


def test_the_sanctioned_lanes_are_the_ones_that_write_reservations():
    """Without its sanctioned functions CKPT401 flags the port's engine
    exactly where it stages into the pinned cache: the device-to-host
    copies ``_launch_d2h`` enqueues and the staging lane's host copy."""
    from repro_torch.analysis import rules_snapshot
    saved = rules_snapshot.SANCTIONED_FUNCTIONS
    rules_snapshot.SANCTIONED_FUNCTIONS = set()
    try:
        active, _ = linter.run([PORT_SRC], root=REPO, select=["CKPT401"])
    finally:
        rules_snapshot.SANCTIONED_FUNCTIONS = saved
    funcs = set()
    for f in active:
        assert f.path == "src/repro_torch/core/engine.py"
        with open(os.path.join(REPO, f.path)) as src:
            lines = src.read().splitlines()[:f.line]
        funcs.add(next(re.match(r"\s*def (\w+)", ln).group(1)
                       for ln in reversed(lines)
                       if re.match(r"\s*def \w+", ln)))
    assert funcs == saved == {"_launch_d2h", "_stage_worker"}


def test_lock_tables_name_the_ports_modules_and_locks():
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    names = {d.name for d in LOCK_REGISTRY.values()}
    for lock, _guard in lockorder.ACQUIRING_METHODS.values():
        assert lock in names, lock
    for suffix in lockorder.SCOPED_SUFFIXES:
        assert os.path.isfile(os.path.join(PORT_SRC, suffix)), suffix
    declaring = {d.owner.split(".")[1] for d in LOCK_REGISTRY.values()
                 if d.owner.startswith("repro_torch.")}
    assert declaring <= {"core", "dist", "storage", "fleet", "obs"}


def test_cli_exit_codes_select_and_json(capsys, tmp_path):
    assert cli.main([FIXTURES]) == 1
    assert cli.main([os.path.join(FIXTURES, "clean_ok.py")]) == 0
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = re.findall(r"^(CKPT\d+):", out, re.M)
    assert ids == [r.id for r in linter.all_rules()]
    assert set(ids) == {"CKPT101", "CKPT102", "CKPT103", "CKPT104",
                        "CKPT201", "CKPT301", "CKPT302", "CKPT303",
                        "CKPT304", "CKPT401", "CKPT501", "CKPT502",
                        "CKPT503"}
    lockfix = os.path.join(FIXTURES, "lockorder_violation.py")
    assert cli.main(["--select", "CKPT4", lockfix]) == 0
    assert cli.main(["--select", "CKPT1", lockfix]) == 1
    capsys.readouterr()
    assert cli.main(["--format", "json", TORCH_FIXTURES]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == {"CKPT401"}
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    active, _ = linter.run([str(bad)], root=str(tmp_path))
    assert [f.rule for f in active] == ["CKPT000"]
    assert cli.main([str(bad)]) == 1
    with pytest.raises(SystemExit) as exc:
        cli.main(["--format", "xml"])
    assert exc.value.code == 2


def test_cli_defaults_to_the_port(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert cli.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().err

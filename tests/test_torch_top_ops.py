"""The dry-run counter's op records and ``scripts/torch/top_ops.py`` (the
port's counterpart of ``scripts/hlo_top_ops.py``), on the CPU.

The script traces one (arch x shape) step on a fake (2, 2) mesh and
prints the largest-result operators, the result bytes by operator kind
and the FLOPs and bytes: those two are the dry-run record's
``per_device`` figures, the per-kind totals sum to every recorded
operator's bytes, and the collectives ``DTensor`` emits appear under
their own kinds with the record's counts and bytes. On a (1, 1) mesh a
real run of the same step under the profiling counter gives the trace's
per-kind profile exactly (on the card too, in the ``gpu`` case).
"""

import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.tree import map_leaves  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.analysis import TraceCounter  # noqa: E402
from repro_torch.launch.analysis import op_profile, type_string  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.serving.engine import make_prefill_step  # noqa: E402
from repro_torch.training.loop import make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE, TOP = "llama3.2-1b", "decode_32k", 12
#: the reference's collective kinds -> the operator kind DTensor emits
COLLECTIVE_OPS = {"all-gather": "_c10d_functional.all_gather_into_tensor",
                  "all-reduce": "_c10d_functional.all_reduce",
                  "reduce-scatter": "_c10d_functional.reduce_scatter_tensor"}


def _script():
    path = os.path.join(ROOT, "scripts", "torch", "top_ops.py")
    spec = importlib.util.spec_from_file_location("scripts_torch_top_ops",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def printed():
    """The script's record and printed lines for ``ARCH`` x ``SHAPE`` on
    a fake (2, 2) mesh, and the plain dry run's record of the same."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_DRYRUN_MESH", "2,2")
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rec = _script().main(["--arch", ARCH, "--shape", SHAPE,
                                  "--top", str(TOP)])
        plain = dryrun.run_dryrun(ARCH, SHAPE, verbose=False)
    finally:
        mp.undo()
    return rec, buf.getvalue().splitlines(), plain


def _section(lines, title):
    start = next(i for i, line in enumerate(lines) if line.startswith(title))
    out = []
    for line in lines[start + 1:]:
        if not line.strip():
            break
        out.append(line)
    return out


def test_flops_and_bytes_are_the_dry_run_records(printed):
    rec, lines, plain = printed
    assert rec["mesh"] == "2x2" and "ops" not in plain
    want = plain["roofline"]["per_device"]
    assert rec["roofline"]["per_device"] == want
    last = [line for line in lines if line.startswith("cost_analysis:")]
    assert len(last) == 1
    m = re.search(r"per device: (\S+) FLOPs, (\S+) bytes", last[0])
    assert (float(m.group(1)), float(m.group(2))) \
        == (want["flops"], want["bytes"])
    assert f"flops={want['flops']:.3e} bytes={want['bytes']:.3e}" in last[0]


def test_per_kind_totals_sum_to_every_recorded_byte(printed):
    rec, lines, _plain = printed
    ops = rec["ops"]
    total = sum(o["bytes"] for o in ops)
    assert total > 0
    prof = rec["op_profile"]
    assert sum(b for _n, b in prof.values()) == total
    assert sum(n for n, _b in prof.values()) == len(ops)
    # names: the operator and its index in trace order
    assert [o["name"] for o in ops[:3]] == [
        f"{o['op'].split('.')[1]}.{i}" for i, o in enumerate(ops[:3])]
    assert all(o["kind"] == o["op"].rsplit(".", 1)[0] for o in ops)
    # no view is recorded (the counter skips views for every figure)
    assert not any(o["kind"] in ("aten.view", "aten.t", "aten.transpose",
                                 "aten.permute", "aten.expand") for o in ops)
    shown = _section(lines, "== total result bytes by op kind")
    assert len(shown) == min(15, len(prof))
    gb = [float(line.split()[0]) for line in shown]
    assert gb == sorted(gb, reverse=True)


def test_rows_sorted_at_most_top_and_collectives_under_their_kinds(printed):
    rec, lines, _plain = printed
    rows = _section(lines, "== top ops by result bytes")
    assert 0 < len(rows) <= TOP
    mb = [float(line.split()[0]) for line in rows]
    assert mb == sorted(mb, reverse=True)
    biggest = max(o["bytes"] for o in rec["ops"])
    assert mb[0] == round(biggest / 1e6, 1)
    # each row: bytes, op, name, type string in the reference's form
    assert all(re.search(r"\b(bf16|f32|s32|s64|pred)\[[0-9,]*\]", line)
               for line in rows)
    coll = rec["roofline"]["collectives"]
    prof = rec["op_profile"]
    for kind, op in COLLECTIVE_OPS.items():
        assert prof.get(op, [0, 0]) == [coll["counts"][kind],
                                        coll["by_kind"][kind]], kind
    # the decode step gathers weights and reduces row-parallel products
    # whole (all-reduce); like the reference's decode step it scatters
    # nothing (no gradient, no sequence-parallel residual)
    assert coll["counts"]["all-gather"] > 0
    assert coll["counts"]["all-reduce"] > 0
    assert coll["counts"]["reduce-scatter"] == 0


def test_type_string_is_the_references_form():
    assert type_string(torch.empty(2, 4096, 2048, dtype=torch.bfloat16,
                                   device="meta")) == "bf16[2,4096,2048]"
    assert type_string((torch.empty(3, dtype=torch.int32, device="meta"),
                        torch.empty((), device="meta"))) == "(s32[3], f32[])"


def _real_args(cfg, shape, kind, device):
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, torch.device(device))
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                           dtype=torch.int32, generator=gen, device=device)
    if kind == "train":
        params = map_leaves(lambda t: t.requires_grad_(True), params)
        return (params, init_opt_state(params), {"tokens": tokens})
    return (params, {"tokens": tokens})


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_real_step_profile_equals_the_trace(kind, device):
    """The smoke config's step past ``DIRECT_SDPA_MAX_SEQ`` (the
    attention operator on the path) traced on a (1, 1) mesh, then run for
    real under the profiling counter: the same operators by kind, with
    the same counts and result bytes."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = smoke_variant(get_config(ARCH))
    shape = InputShape("t", layers.DIRECT_SDPA_MAX_SEQ + 52, 1, kind)
    rec = dryrun.dryrun_record(cfg, shape, make_abstract_mesh(
        (1, 1), ("data", "model")), record_ops=True)
    args = _real_args(cfg, shape, kind, device)
    step = make_prefill_step(cfg) if kind == "prefill" \
        else make_train_step(cfg, AdamWConfig())
    counter = TraceCounter(args, record_ops=True)
    with counter:
        step(*args)
    assert counter.profile() == rec["op_profile"]
    assert op_profile(counter.ops) == counter.profile()
    assert "repro_torch.flash_attention_fwd" in rec["op_profile"]
    assert counter.flops == rec["roofline"]["per_device"]["flops"]

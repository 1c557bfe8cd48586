"""The port's launch tooling held against the JAX package's: the analytic
parameter counts, the input shapes, the dry run's batch templates and
model FLOPs, and the dry run itself on fake tensors.

The reference's ``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` for the
whole process when it is imported, so it is reached only in a fresh
interpreter (``conftest.run_in_subprocess``), with one forced device.
Everything else runs in this process on the CPU: the port's dry run
needs no card, and its fake tensors say ``cpu`` on a PyTorch built
without CUDA (``dryrun.template_device``).
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_in_subprocess  # noqa: E402

import repro.configs as R  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, get_config,  # noqa: E402
                                 list_configs, smoke_variant)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.tree import (flatten_with_path, leaves,  # noqa: E402
                                   map_leaves)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW,  # noqa: E402
                                     PEAK_FLOPS_BF16, make_abstract_mesh,
                                     make_production_mesh)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.serving.engine import make_prefill_step  # noqa: E402
from repro_torch.sharding.partition import (batch_pspecs,  # noqa: E402
                                            opt_pspecs, param_pspecs)
from repro_torch.sharding.sharded import spec_indices  # noqa: E402
from repro_torch.training.loop import make_train_step  # noqa: E402

ARCHS = list_configs()
RECORD_KEYS = {"arch", "shape", "mode", "mesh", "axes", "n_devices",
               "overrides", "step", "fake_device", "trace_s", "roofline",
               "n_params", "n_active_params"}
ROOFLINE_KEYS = {"per_device", "collectives", "terms", "dominant",
                 "bound_s", "model_flops_global", "traced_flops_global",
                 "useful_flops_ratio", "memory", "hw"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes"}

REFERENCE = r"""
import json, os
os.environ["REPRO_DRYRUN_DEVICES"] = "1"
from repro.launch import dryrun
from repro.configs import INPUT_SHAPES, get_config, list_configs
out = {}
for arch in list_configs():
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        bt = dryrun.batch_template(cfg, shape)
        out[arch + "|" + name] = {
            "batch": {k: [list(v.shape), str(v.dtype)] for k, v in bt.items()},
            "model_flops": dryrun.model_flops_global(cfg, shape)}
print("REF" + json.dumps(out))
"""


# ------------------------------------------------------------ param counts
@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_analytic_matches_reference(arch, active_only):
    from repro.models.model import count_params_analytic as ref_count
    cfg, ref = get_config(arch), R.get_config(arch)
    assert M.count_params_analytic(cfg, active_only) \
        == ref_count(ref, active_only)
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    assert cfg.long_context_ok == ref.long_context_ok


def test_config_list_and_input_shapes_match_reference():
    assert ARCHS == R.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in R.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_count_near_param_shapes(arch):
    """As ``tests/test_models.py`` holds the reference: within 5 % of the
    parameter tree's size, for the smoke variant and the full config."""
    for cfg in (smoke_variant(get_config(arch)), get_config(arch)):
        actual = sum(math.prod(s.shape) for s in leaves(M.param_shapes(cfg)))
        assert abs(actual - M.count_params_analytic(cfg)) / actual < 0.05


# ---------------------------------------------------- templates and FLOPs
def test_batch_templates_and_model_flops_match_reference():
    out = run_in_subprocess(REFERENCE, n_devices=1)
    ref = json.loads(out.split("REF", 1)[1])
    for arch in ARCHS:
        cfg = get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            want = ref[f"{arch}|{name}"]
            bt = dryrun.batch_template(cfg, shape)
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in bt.items()}
            assert all(v.device.type == "meta" for v in bt.values())
            assert got == want["batch"], (arch, name)
            assert dryrun.model_flops_global(cfg, shape) \
                == want["model_flops"], (arch, name)


# --------------------------------------------------------------- dry run
#: the sweep's shapes, each at its kind: a few rows of a short sequence
#: (the traced operators are what they are at any length, and DTensor
#: works out a layout once a shape; RWKV6's chunk loop takes four chunks),
#: and ``long_500k``'s decode just past the long-context threshold
SWEEP_SHAPES = {"train_4k": (64, 4), "prefill_32k": (64, 4),
                "decode_32k": (64, 4),
                "long_500k": (dryrun.LONG_CONTEXT_SEQ + 64, 1)}


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_records_every_shape(arch, monkeypatch):
    """Each config's smoke variant at all four shapes (train, prefill,
    decode, and ``long_500k``'s long-context decode) traced sharded on a
    fake (2, 2) mesh (``REPRO_DRYRUN_MESH``; the production mesh is
    ``test_dryrun_full_width_full_depth_llama_train_4k``'s): every key of
    the reference's record, the card's rates in ``hw``, rank 0's
    collectives and their term, and ``long_500k`` skipped exactly where
    the reference skips it (a config not ``long_context_ok``)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: smoke_variant(get_config(name)))
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "2,2")
    overrides = {"rwkv_chunk": 16} if get_config(arch).n_heads == 0 \
        else None
    for name, (seq, batch) in SWEEP_SHAPES.items():
        monkeypatch.setitem(INPUT_SHAPES, name, dataclasses.replace(
            INPUT_SHAPES[name], seq_len=seq, global_batch=batch))
    for name, shape in INPUT_SHAPES.items():
        rec = dryrun.run_dryrun(arch, name, verbose=False,
                                overrides=overrides)
        skip = name == "long_500k" and not R.get_config(arch).long_context_ok
        if skip:
            assert rec["skipped"] and "long_500k" in rec["reason"]
            continue
        want = RECORD_KEYS | ({"long_context"} if shape.kind == "decode"
                              else set())
        assert set(rec) == want, (arch, name)
        assert rec.get("long_context", False) == (name == "long_500k")
        roof = rec["roofline"]
        assert set(roof) == ROOFLINE_KEYS
        assert set(roof["terms"]) == {"compute_s", "memory_s",
                                      "collective_s", "memory_lb_s"}
        assert set(roof["memory"]) == MEMORY_KEYS
        assert roof["hw"]["peak_flops"] == PEAK_FLOPS_BF16 == 989e12
        assert roof["hw"]["hbm_bw"] == HBM_BW == 3.35e12
        assert roof["hw"]["link_bw"] == NVLINK_BW == 450e9
        assert rec["n_devices"] == 4 and rec["mesh"] == "2x2"
        coll = roof["collectives"]
        assert coll["bytes_per_device"] == sum(coll["by_kind"].values()) > 0
        assert sum(coll["counts"].values()) > 0
        assert roof["terms"]["collective_s"] \
            == coll["bytes_per_device"] / NVLINK_BW
        assert roof["traced_flops_global"] > 0
        assert roof["traced_flops_global"] \
            == roof["per_device"]["flops"] * 4
        assert roof["bound_s"] == roof["terms"][roof["dominant"]]
        assert rec["step"] == shape.kind
        assert roof["memory"]["argument_size_in_bytes"] > 0


def test_dryrun_full_width_full_depth_llama_train_4k():
    """The CLI's record (``--arch llama3.2-1b --shape train_4k``): the
    step traced sharded on the production 16 x 16 mesh over a fake
    process group, counted as rank 0's local program, remat on."""
    import torch.distributed as dist
    rec = dryrun.run_dryrun("llama3.2-1b", "train_4k", verbose=False)
    roof = rec["roofline"]
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert not dist.is_initialized()
    # every device does at least its share of 6·N·D (the attention, the
    # forward recompute and the work a layout repeats come on top)
    assert roof["per_device"]["flops"] > roof["model_flops_global"] / 256
    assert roof["traced_flops_global"] == roof["per_device"]["flops"] * 256
    coll = roof["collectives"]
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert coll["counts"][kind] > 0 and coll["by_kind"][kind] > 0
    assert roof["terms"]["collective_s"] > 0
    mem = roof["memory"]
    assert mem["alias_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] >= mem["alias_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0


def test_production_meshes():
    for multi_pod, dims, axes in ((False, (16, 16), ("data", "model")),
                                  (True, (2, 16, 16),
                                   ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        assert mesh.devices.shape == dims and mesh.axis_names == axes
        assert mesh.device.type == "meta"


# ------------------------------------------------ traced against real
def _real_args(cfg, shape, step_kind, gen):
    params = M.init_params(cfg, gen, torch.device("cpu"))
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     dtype=torch.int32)}
    if step_kind == "train":
        params = map_leaves(lambda t: t.requires_grad_(True), params)
        return (params, init_opt_state(params), batch)
    return (params, batch)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_traced_flops_and_argument_bytes_equal_a_real_cpu_run(kind):
    """A smoke config's step past ``DIRECT_SDPA_MAX_SEQ`` (so the
    attention operator is on the path): the FLOPs traced on fake tensors
    equal what ``FlopCounterMode`` counts when the same step runs for
    real on the CPU (the plain path), and the argument bytes equal the
    real arguments' bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = smoke_variant(get_config("llama3.2-1b"))
    seq = layers.DIRECT_SDPA_MAX_SEQ + 52
    shape = InputShape("t", seq, 1, kind)
    rec = dryrun.dryrun_record(cfg, shape,
                               make_abstract_mesh((1, 1), ("data", "model")))
    gen = torch.Generator().manual_seed(0)
    args = _real_args(cfg, shape, kind, gen)
    step = make_prefill_step(cfg) if kind == "prefill" \
        else make_train_step(cfg, AdamWConfig())
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args))
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert fc.get_total_flops() == rec["roofline"]["traced_flops_global"]
    assert fa.OP in {k for v in fc.get_flop_counts().values() for k in v}
    assert rec["roofline"]["memory"]["argument_size_in_bytes"] == arg_bytes
    # one device: no group, no collective
    assert rec["roofline"]["collectives"]["bytes_per_device"] == 0
    assert rec["roofline"]["terms"]["collective_s"] == 0.0


@pytest.mark.parametrize("mode", ["2d", "tp_zero1"])
def test_argument_bytes_per_device_on_a_2x4_mesh(mode):
    """Argument bytes per device are the largest device's share under the
    partition rules, summed from ``spec_indices`` of the specs."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), sharding_mode=mode,
                              n_layers=2,
                              layer_groups=((("full",), 2),))
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    shape = InputShape("t", 64, 8, "train")
    rec = dryrun.dryrun_record(cfg, shape, mesh)
    ptree = map_leaves(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, s.dtype), device="meta"),
        M.param_shapes(cfg))
    opt = init_opt_state(ptree)
    batch = dryrun.batch_template(cfg, shape)
    trees = ((ptree, param_pspecs(cfg, ptree, mesh)),
             (opt, opt_pspecs(cfg, ptree, mesh)),
             (batch, batch_pspecs(cfg, "train", batch, mesh)))
    per_dev = dict.fromkeys(range(8), 0)
    for tree, specs in trees:
        for path, t in flatten_with_path(tree)[0]:
            spec = specs
            for key in path:
                spec = spec[key]
            for dev, index in spec_indices(t.shape, mesh, spec).items():
                n = math.prod(len(range(*s.indices(d)))
                              for s, d in zip(index, t.shape))
                per_dev[dev] += n * t.element_size()
    assert rec["roofline"]["memory"]["argument_size_in_bytes"] \
        == max(per_dev.values())
    total = sum(t.numel() * t.element_size()
                for tree, _s in trees for t in leaves(tree))
    assert max(per_dev.values()) < total


def test_main_writes_out(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "2,2")
    out = tmp_path / "sub" / "rec.json"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--mode", "tp_zero1", "--no-donate",
                        "--set", "attn_kv_block=2048",
                        "--set", "remat=false",
                        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "2x2" and rec["mode"] == "tp_zero1"
    assert rec["overrides"] == {"attn_kv_block": 2048, "remat": False}
    assert rec["step"] == "decode" and not rec["long_context"]
    assert rec["roofline"]["memory"]["alias_size_in_bytes"] == 0
    assert rec["roofline"]["hw"]["card"] \
        == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape",
                        "long_500k"]) == 0
    assert "SKIPPED" in capsys.readouterr().out
    with pytest.raises(ValueError, match="analysis_unroll.*always "
                                         "unrolled"):
        dryrun.run_dryrun("llama3.2-1b", "train_4k",
                          overrides={"analysis_unroll": True})


# ------------------------------------------------ the attention operator
def test_flash_op_fake_outputs_and_flop_formula():
    """The operator's fake implementation gives ``_Flash`` what it needs
    (the output and fp32 row stats), a training step traces through it,
    and its FLOP formula is :func:`flash_flop`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    dev = dryrun.template_device()
    cases = [("full", 0, 0, 0, 300, 300), ("window", 64, 0, 0, 300, 300),
             ("chunked", 0, 96, 0, 300, 300), ("full", 0, 0, 40, 300, 300),
             ("full", 0, 0, 0, 300, 200)]
    with FakeTensorMode():
        for kind, window, chunk, n_prefix, S, T in cases:
            q = torch.empty(2, S, 8, 64, dtype=torch.bfloat16, device=dev)
            k = torch.empty(2, T, 2, 64, dtype=torch.bfloat16, device=dev)
            with FlopCounterMode(display=False) as fc:
                out, m, l = fa.OP(q, k, k, kind, window, chunk, n_prefix,
                                  128, True)
            assert out.shape == (2, S, 512) and out.dtype == torch.bfloat16
            assert m.shape == l.shape == (2, S, 8)
            assert m.dtype == l.dtype == torch.float32
            assert fc.get_total_flops() == fa.flash_flop(
                2, S, 8, 64, window, n_prefix, T=T, kind=kind, chunk=chunk)
            out, m, l = fa.OP(q, k, k, kind, window, chunk, n_prefix, 128,
                              False)
            assert out.shape == (2, S, 512) and m.numel() == l.numel() == 0
        q = torch.empty(1, 64, 4, 16, device=dev, requires_grad=True)
        kv = torch.empty(1, 64, 2, 16, device=dev, requires_grad=True)
        o = layers._Flash.apply(q, kv, kv, "full", 0, 0, 32, 0)
        dq, dk = torch.autograd.grad(o.sum(), (q, kv))
        assert dq.shape == q.shape and dk.shape == kv.shape


@pytest.mark.parametrize("S,T", [(7, 7), (9, 5), (5, 9), (33, 33)])
def test_flash_pairs_counts_the_visible_pairs(S, T):
    for kind, window, chunk in (("full", 0, 0), ("window", 3, 0),
                                ("chunked", 0, 4)):
        for n_prefix in (0, 3):
            mask = fa.allowed(torch.arange(S), torch.arange(T), kind,
                              window, chunk, n_prefix)
            assert fa.flash_pairs(S, window, n_prefix, T=T, kind=kind,
                                  chunk=chunk) == int(mask.sum())


def test_flash_op_on_the_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 50, 4, 16, generator=gen)
    k = torch.randn(1, 50, 2, 16, generator=gen)
    v = torch.randn(1, 50, 2, 16, generator=gen)
    out, m, l = fa.OP(q, k, v, "window", 7, 0, 3, 16, True)
    want = fa.flash_attention_plain(q, k, v, kind="window", window=7,
                                    n_prefix=3, kv_block=16,
                                    return_stats=True)
    for got, w in zip((out, m, l), want):
        assert torch.equal(got, w)
    assert np.array_equal(
        fa.OP(q, k, v, "full", 0, 0, 0, 16, False)[0].numpy(),
        fa.flash_attention_plain(q, k, v, kv_block=16).numpy())

"""The sharded dry run: a step traced on ``DTensor``s over a fake process
group, counted as rank 0's local program (``repro_torch.launch.dryrun``,
``repro_torch.launch.analysis``).

A column-parallel and a row-parallel product on a fake (2, 2) mesh are
held against their analytic local FLOPs and all-reduce bytes; the dry
run owns the default process group while it traces, leaves none behind
and refuses to trace in a process that has one; the ``seq`` axis of a
long-context decode and the batch axes of ``fsdp`` are set for the trace
and cleared after it. ``tests/test_torch_launch.py`` sweeps every
config's smoke variant over every shape on a fake (2, 2) mesh;
``tests/test_torch_sharded_compute.py`` holds the trace against the
same step run by four gloo ranks.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import context as shctx  # noqa: E402

MESH = make_abstract_mesh((2, 2), ("data", "model"))


def test_column_and_row_parallel_pair_counts_the_local_program():
    """x (B, S, d) split over ``data``, w1 (d, f) over ``model`` by
    columns, w2 (f, d) by rows: each rank multiplies its (B/2, S, d) rows
    by its f/2 columns and rows, and the partial sums over ``model`` meet
    in one all-reduce of the (B/2, S, d) fp32 result. The global FLOPs
    would be four times the local ones."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    B, S, d, f = 8, 64, 256, 512
    mode = FakeTensorMode()
    with dryrun.fake_process_group(4):
        dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
        with mode:
            x = distribute_tensor(torch.empty(B, S, d), dm,
                                  [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(d, f), dm,
                                   [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(f, d), dm,
                                   [Replicate(), Shard(0)])
        counter = analysis.TraceCounter((x, w1, w2), fake_mode=mode)
        with counter:
            y = ((x @ w1) @ w2).redistribute(dm, [Shard(0), Replicate()])
        assert tuple(y.to_local().shape) == (B // 2, S, d)
    assert not dist.is_initialized()
    local_rows = B // 2 * S
    assert counter.flops == 2 * local_rows * d * (f // 2) * 2
    coll = counter.collectives()
    assert coll["counts"] == {"all-gather": 0, "all-reduce": 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["by_kind"]["all-reduce"] == local_rows * d * 4
    assert coll["bytes_per_device"] == local_rows * d * 4


def test_dry_run_owns_the_default_group_and_refuses_a_foreign_one():
    """A sharded record leaves no process group and no sharding setting
    behind; with a default group already up (a rank of a run) it raises
    and leaves that group alone."""
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              sharding_mode="fsdp")
    shape = InputShape("t", 32, 4, "train")
    rec = dryrun.dryrun_record(cfg, shape, MESH)
    roof = rec["roofline"]
    assert not dist.is_initialized()
    assert shctx.active_mesh() is None and not shctx.seq_axis_active()
    assert shctx._state.batch_axes is None
    assert roof["collectives"]["bytes_per_device"] > 0
    assert roof["terms"]["collective_s"] == \
        roof["collectives"]["bytes_per_device"] / analysis.NVLINK_BW
    assert roof["traced_flops_global"] == roof["per_device"]["flops"] * 4
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            dryrun.dryrun_record(cfg, shape, MESH)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    # an error inside the trace still takes the fake group down
    with pytest.raises(Exception):
        dryrun.dryrun_record(dataclasses.replace(cfg, vocab=-1), shape,
                             MESH)
    assert not dist.is_initialized()


def test_long_context_decode_traces_with_the_sequence_over_data():
    """``long_500k``'s path at a reduced length: the cache's sequence is
    split over ``data`` (rank 0 holds half of it), and the ``seq`` axis
    is cleared after the trace."""
    cfg = smoke_variant(get_config("gemma3-27b"))
    assert cfg.long_context_ok
    shape = InputShape("long", dryrun.LONG_CONTEXT_SEQ + 4096, 1, "decode")
    rec = dryrun.dryrun_record(cfg, shape, MESH)
    assert rec["long_context"] and not shctx.seq_axis_active()
    roof = rec["roofline"]
    full = dryrun.dryrun_record(cfg, shape, make_abstract_mesh(
        (1, 1), ("data", "model")))
    assert roof["memory"]["argument_size_in_bytes"] < \
        full["roofline"]["memory"]["argument_size_in_bytes"]
    assert roof["collectives"]["bytes_per_device"] > 0
    assert full["roofline"]["collectives"]["bytes_per_device"] == 0
    assert full["roofline"]["terms"]["collective_s"] == 0.0

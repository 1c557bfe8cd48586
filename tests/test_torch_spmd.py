"""The rank-side bodies of the sharded tests, and the spawner's own tests.

``tests/test_torch_sharded_compute.py`` and
``tests/test_torch_sharded_checkpoint.py`` send these functions to four
spawned gloo ranks (``repro_torch.launch.spmd.SpmdGroup``). A rank
unpickles a function by importing its module, so they live here, in a
module that imports neither ``jax`` nor ``repro``: each rank imports
only PyTorch and the port.

This file's own tests hold ``SpmdGroup``: every rank's value in rank
order, ``start`` / ``results`` around the caller's work, and a rank that
raises failing the call with every rank's error and closing the group.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_numpy_state, to_numpy_state
from repro_torch.core import CheckpointManager
from repro_torch.core.policy import CheckpointPolicy, DistPolicy
from repro_torch.core.tree import (flatten_with_path, leaves, map_leaves,
                                   path_str)
from repro_torch.launch.spmd import SpmdError, SpmdGroup
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.serving import engine as TE
from repro_torch.training.loop import make_train_step


# ------------------------------------------- test_torch_sharded_compute
MESH = ((2, 2), ("data", "model"))


def _rank_mesh(cfg):
    from repro_torch.launch.mesh import make_device_mesh, virtual_mesh
    dm = make_device_mesh(*MESH, device="cpu")
    return dm, virtual_mesh(dm)


def _rank_train(cfg, params_np, tokens, matrix=("attn", "wq")):
    """One train step on the ranks: returns the loss and (rank 0) the
    gathered params, with the local shape of one matrix of the first
    block (``matrix``, its path there) and of its momentum (to see the
    layout is real)."""
    import torch.distributed as dist

    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                opt_pspecs, param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = from_numpy_state(params_np, "cpu")
    opt = init_opt_state(params)
    batch = {"tokens": torch.from_numpy(tokens)}
    shctx.set_batch_axes(("data", "model") if cfg.sharding_mode == "fsdp"
                         else None)
    try:
        dp = distribute_tree(
            map_leaves(lambda t: t.requires_grad_(True), params),
            param_pspecs(cfg, params, vm), dm)
        do = distribute_tree(opt, opt_pspecs(cfg, params, vm), dm)
        db = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm),
                             dm)
        with shctx.activate(dm):
            dp, do, loss = make_train_step(cfg, AdamWConfig())(dp, do, db)
    finally:
        shctx.set_batch_axes(None)
    wq = dp["groups"][0][0][matrix[0]][matrix[1]]
    mq = do["m"]["groups"][0][0][matrix[0]][matrix[1]]
    # the forward's ``map_leaves(lambda t: t[i], pp)`` keeps a DTensor's
    # layout: the stacked dim is never sharded, every other shifts by one
    from torch.distributed.tensor import Shard
    kept = all(type(a) is type(b) and (not isinstance(a, Shard)
                                       or a.dim == b.dim + 1)
               for a, b in zip(wq.placements, wq[0].placements))
    assert kept and not any(isinstance(p, Shard) and p.dim == 0
                            for p in wq.placements)
    full = to_numpy_state(map_leaves(lambda t: t.full_tensor().detach(),
                                     dp))
    layout = (tuple(wq.to_local().shape), tuple(mq.to_local().shape))
    return loss.full_tensor().item(), (full if dist.get_rank() == 0
                                       else None), layout


def _rank_forward(cfg, params_np, tokens):
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = from_numpy_state(params_np, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    dp = distribute_tree(params, param_pspecs(cfg, params, vm), dm)
    db = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm), dm)
    with shctx.activate(dm), torch.no_grad():
        logits, aux, _ = TM.forward_aux(cfg, dp, db)
    aux = aux.full_tensor() if hasattr(aux, "full_tensor") else aux
    return logits.full_tensor().numpy(), float(aux)


def _rank_loss_grads(cfg, params_np, batch_np):
    """``loss_fn`` and its gradients on the ranks: returns the loss and
    (rank 0) the gathered gradient tree."""
    import torch.distributed as dist

    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = map_leaves(lambda t: t.requires_grad_(True),
                        from_numpy_state(params_np, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    dp = distribute_tree(params, param_pspecs(cfg, params, vm), dm)
    db = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm), dm)
    flat, unflatten = flatten_with_path(dp)
    with shctx.activate(dm):
        loss = TM.loss_fn(cfg, dp, db)
        grads = torch.autograd.grad(loss, [leaf for _path, leaf in flat])
    full = unflatten([g.full_tensor().detach() for g in grads])
    return loss.full_tensor().item(), (to_numpy_state(full)
                                       if dist.get_rank() == 0 else None)


def _rank_decode(cfg, params_np, prompt, steps, seq_axis=None):
    """Prefill ``prompt``, then decode the tokens of ``steps`` (B, n)
    teacher-forced, the logical ``seq`` axis mapped to ``seq_axis`` (the
    long-context layout); every logits gathered, and the layout of the
    first cache's k."""
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = from_numpy_state(params_np, "cpu")
    batch = {"tokens": torch.from_numpy(prompt)}
    dp = distribute_tree(params, param_pspecs(cfg, params, vm), dm)
    db = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm), dm)
    toks = distribute_tree({"t": torch.from_numpy(steps)},
                           batch_pspecs(cfg, "decode",
                                        {"t": torch.from_numpy(steps)}, vm),
                           dm)["t"]
    out = []
    shctx.set_seq_axis(seq_axis)
    try:
        with shctx.activate(dm):
            logits, caches = TE.make_prefill_step(cfg)(dp, db)
            out.append(logits.full_tensor().numpy())
            first = caches[0][0]
            k = first["k" if "k" in first else sorted(first)[0]]
            layout = (str(k.placements), tuple(k.to_local().shape))
            decode = TE.make_decode_step(cfg)
            for i in range(steps.shape[1]):
                logits, caches = decode(dp, toks[:, i:i + 1], caches,
                                        prompt.shape[1] + i)
                out.append(logits.full_tensor().numpy())
    finally:
        shctx.set_seq_axis(None)
    return out, layout


def _rank_prefill_caches(cfg, params_np, prompt):
    """The sharded prefill of ``prompt``: its last logits and every decode
    cache, gathered, and the placements of the first cache leaf."""
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = from_numpy_state(params_np, "cpu")
    batch = {"tokens": torch.from_numpy(prompt)}
    dp = distribute_tree(params, param_pspecs(cfg, params, vm), dm)
    db = distribute_tree(batch, batch_pspecs(cfg, "prefill", batch, vm), dm)
    with shctx.activate(dm):
        logits, caches = TE.make_prefill_step(cfg)(dp, db)
    first = [t for t in caches[0][0].values()][0]
    return (logits.full_tensor().numpy(),
            to_numpy_state(map_leaves(lambda t: t.full_tensor(), caches)),
            str(first.placements))


def _rank_count(cfg, params_np, tokens, kind):
    """The ``train`` step (or ``prefill``) of ``cfg`` on the ranks under
    the dry run's counter (:class:`repro_torch.launch.analysis.
    TraceCounter`, recording its operators): this rank's FLOPs,
    collectives and per-kind op profile."""
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                opt_pspecs, param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = from_numpy_state(params_np, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    db = distribute_tree(batch, batch_pspecs(cfg, kind, batch, vm), dm)
    # fsdp: the batch over the whole mesh, as the dry run sets it
    shctx.set_batch_axes(("data", "model") if cfg.sharding_mode == "fsdp"
                         else None)
    if kind == "train":
        args = (distribute_tree(
            map_leaves(lambda t: t.requires_grad_(True), params),
            param_pspecs(cfg, params, vm), dm),
            distribute_tree(init_opt_state(params),
                            opt_pspecs(cfg, params, vm), dm), db)
        step = make_train_step(cfg, AdamWConfig())
    else:
        args = (distribute_tree(params, param_pspecs(cfg, params, vm), dm),
                db)
        step = TE.make_prefill_step(cfg)
    counter = TraceCounter(args, record_ops=True)
    try:
        with shctx.activate(dm), counter:
            step(*args)
    finally:
        shctx.set_batch_axes(None)
    return {"flops": counter.flops, "collectives": counter.collectives(),
            "profile": counter.profile()}


# ---------------------------------------- test_torch_sharded_checkpoint
AXES = ("data", "model")


SPECS = {"params": {"w": ("data", "model")}, "opt": {"m": ("data", None)},
         "repl": ()}


#: the elastic target's specs on a (1, 4) mesh
SPECS_1x4 = {"params": {"w": ("model", "data")},
             "opt": {"m": (None, "model")}, "repl": ()}


def _group_manager(root):
    return CheckpointManager.from_policy(
        root, CheckpointPolicy(dist=DistPolicy(group=True)), device="cpu")


def _tensors(tree):
    return map_leaves(lambda a: torch.from_numpy(np.array(a)), tree)


def _rank_basic(root, jroot, arrays):
    import torch.distributed as dist

    from repro_torch.core.distributed import group_by_rank, plan_shards
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.partition import distribute_tree
    dm = make_device_mesh((2, 2), AXES, device="cpu")
    state = distribute_tree(_tensors(arrays), SPECS, dm)
    state["meta"] = {"step": 3}
    out = {}
    with _group_manager(root) as mgr:
        mgr.save(3, state, blocking=True)
        same = mgr.restore(state, step=3)
        out["same"] = all(torch.equal(a.to_local(), b.to_local())
                          for (_p, a), (_q, b) in zip(
                              flatten_with_path(same)[0],
                              flatten_with_path(state)[0])
                          if isinstance(a, torch.Tensor))
        out["meta"] = same["meta"]
        dm2 = make_device_mesh((1, 4), AXES, device="cpu")
        tpl = distribute_tree(map_leaves(torch.zeros_like,
                                         _tensors(arrays)), SPECS_1x4, dm2)
        tpl["meta"] = {"step": 0}
        el = mgr.restore(tpl, step=3)
        out["elastic"] = [
            (path_str(p), bool(np.array_equal(t.full_tensor().numpy(),
                                              _at(arrays, p))),
             tuple(t.to_local().shape))
            for p, t in flatten_with_path(el)[0]
            if isinstance(t, torch.Tensor)]
        out["elastic_meta"] = el["meta"]
        out["commit_errors"] = list(mgr.commit_errors)
    # a step written by repro, restored into DTensors
    with _group_manager(jroot) as mgr:
        got = mgr.restore(state, step=5)
        out["from_repro"] = all(
            np.array_equal(t.to_local().numpy(), _local(arrays, p, dm))
            for p, t in flatten_with_path(got)[0]
            if isinstance(t, torch.Tensor))
    # ZeRO-1 over the whole mesh: a quarter of the bytes a rank
    big = distribute_tree({"m": torch.zeros(1024, 64)},
                          {"m": (("data", "model"), None)}, dm)
    records, _ = plan_shards(big, group="state")
    out["zero1_bytes"] = {r: sum(rec.nbytes for rec in recs)
                          for r, recs in group_by_rank(records).items()}
    out["rank"] = dist.get_rank()
    return out


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _local(arrays, path, dm):
    from repro_torch.sharding.partition import local_region
    import torch.distributed as dist
    a = _at(arrays, path)
    return a[local_region(a.shape, _at(SPECS, path), dm, dist.get_rank())]


def _rank_train_save(root, params, tokens):
    """tp_zero1 step, blocking save of step 1, lazy save of step 2 with
    the capture barrier before the next in-place update; both restored.
    Rank 0 returns the gathered state of both steps and the specs."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh, virtual_mesh
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                opt_pspecs, param_pspecs)
    from repro_torch.training.loop import _loss_and_grads
    from repro_torch.optim.adamw import apply_updates
    cfg = _train_cfg()
    dm = make_device_mesh((2, 2), AXES, device="cpu")
    vm = virtual_mesh(dm)
    specs = {"model": param_pspecs(cfg, params, vm),
             "optimizer": opt_pspecs(cfg, params, vm)}
    p = distribute_tree(map_leaves(lambda t: t.requires_grad_(True),
                                   params), specs["model"], dm)
    o = distribute_tree(init_opt_state(params), specs["optimizer"], dm)
    batch = {"tokens": torch.from_numpy(tokens)}
    b = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm), dm)
    hp = AdamWConfig()
    out, snaps = {}, {}
    with _group_manager(root) as mgr, shctx.activate(dm):
        for step in (1, 2, 3):
            _loss, grads = _loss_and_grads(cfg, p, b)
            mgr.wait_for_capture()  # the in-place update may overwrite
            apply_updates(p, o, grads, hp)
            state = {"model": p, "optimizer": o, "meta": {"step": step}}
            if step < 3:
                snaps[step] = map_leaves(
                    lambda t: t.full_tensor().detach().clone(),
                    {"model": p, "optimizer": o})
                mgr.save(step, state, blocking=step == 1)
        mgr.wait_for_commit()
        for step in (1, 2):
            got = mgr.restore(state, step=step)
            out[step] = all(
                torch.equal(a.full_tensor(), w) for a, w in zip(
                    [t for _p, t in flatten_with_path(
                        {"model": got["model"],
                         "optimizer": got["optimizer"]})[0]],
                    [t for _p, t in flatten_with_path(snaps[step])[0]]))
        out["commit_errors"] = list(mgr.commit_errors)
    if dist.get_rank() == 0:
        out["snaps"] = snaps
        out["specs"] = specs
    return out


def _rank_zero1_to_2d(root, cfg, params_np, tokens):
    """A ``tp_zero1`` train step of ``cfg`` on the ranks, its state saved
    blocking, then restored onto templates laid out ``2d`` on the same
    mesh (a change of partition mode on resume): whether every restored
    leaf equals the saved one bit for bit, and the local shapes of the
    first block's ``wq`` and its fp32 master in both layouts. Rank 0 also
    returns the gathered saved state."""
    import torch.distributed as dist

    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.partition import (batch_pspecs,
                                                distribute_tree,
                                                opt_pspecs, param_pspecs)
    dm, vm = _rank_mesh(cfg)
    params = from_numpy_state(params_np, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    p = distribute_tree(map_leaves(lambda t: t.requires_grad_(True),
                                   params), param_pspecs(cfg, params, vm), dm)
    o = distribute_tree(init_opt_state(params), opt_pspecs(cfg, params, vm),
                        dm)
    b = distribute_tree(batch, batch_pspecs(cfg, "train", batch, vm), dm)
    with shctx.activate(dm):
        p, o, _loss = make_train_step(cfg, AdamWConfig())(p, o, b)
    saved = {"model": p, "optimizer": o}
    want = map_leaves(lambda t: t.full_tensor().detach().clone(), saved)
    c2 = dataclasses.replace(cfg, sharding_mode="2d")
    zeros = map_leaves(torch.zeros_like, params)
    tpl = {"model": distribute_tree(zeros, param_pspecs(c2, params, vm), dm),
           "optimizer": distribute_tree(init_opt_state(zeros),
                                        opt_pspecs(c2, params, vm), dm),
           "meta": {"step": 0}}
    with _group_manager(root) as mgr:
        mgr.save(1, dict(saved, meta={"step": 1}), blocking=True)
        got = mgr.restore(tpl, step=1)
        errors = list(mgr.commit_errors)
    pairs = zip(leaves({"model": got["model"],
                        "optimizer": got["optimizer"]}), leaves(want))
    exact = all(torch.equal(g.full_tensor(), w) for g, w in pairs)

    def wq(tree):
        return tuple(tree["groups"][0][0]["attn"]["wq"].to_local().shape)
    layouts = {"tp_zero1": (wq(p), wq(o["master"])),
               "2d": (wq(got["model"]), wq(got["optimizer"]["master"]))}
    return {"exact": exact, "meta": got["meta"], "layouts": layouts,
            "commit_errors": errors,
            "saved": want if dist.get_rank() == 0 else None}


def _train_cfg():
    """``tests/test_distributed.py``'s cut of the smoke variant, at one
    layer."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    return dataclasses.replace(cfg, d_model=128, d_ff=256, vocab=256,
                               n_layers=1, layer_groups=((("full",), 1),),
                               sharding_mode="tp_zero1")


def _rank_collectives():
    """DTensor redistributions through gloo's native CPU path, then
    through :mod:`repro_torch.sharding.gloo_cuda`'s collectives
    registered for the CPU key: the same values. Also
    ``_dtensor.shard_dim_alltoall`` (Ulysses' exchange of a split
    sequence for split heads, which a ``DTensor`` on a cuda mesh runs
    and PyTorch 2.11's own version of kills a rank under gloo), called
    directly: the same values both ways, and the dry run's counter counts
    the routed one as one all-to-all. And the functional collectives
    called directly over the world (an all-to-all of uneven splits, a
    max, an all-gather, a reduce-scatter), the routed ones through
    staging buffers of a few bytes, so each moves in many chunks. Last in
    this file: the override stays installed in the group's ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding import gloo_cuda
    dm = make_device_mesh((2, 2), AXES, device="cpu")
    t = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    r = float(dist.get_rank() + 1)
    model = dm.get_group(1).group_name

    def run():
        d = distribute_tensor(t, dm, [Shard(0), Shard(1)])
        p = DTensor.from_local(torch.full((4, 4), r), dm,
                               [Partial(), Partial("avg")], run_check=False)
        x = distribute_tensor(t, dm, [Shard(2), Replicate()]) \
            .requires_grad_(True)
        (x * x).sum().backward()
        counter = TraceCounter(())
        with counter:
            a2a = torch.ops._dtensor.shard_dim_alltoall(d.to_local(), 1, 2,
                                                        model)
        return [d.redistribute(dm, [Shard(0), Shard(2)]).full_tensor(),
                d.full_tensor(),
                p.redistribute(dm, [Shard(0), Replicate()]).to_local(),
                p.redistribute(dm, [Replicate(), Replicate()]).to_local(),
                x.grad.full_tensor(), a2a] + direct(), \
            counter.collectives()["counts"]

    def direct():
        f, world = torch.ops._c10d_functional, dist.group.WORLD.group_name
        i = dist.get_rank()
        # rank i sends rank j (i + j) % 3 + 1 rows, and takes as many
        splits = [(i + j) % 3 + 1 for j in range(4)]
        rows = torch.arange(sum(splits) * 3, dtype=torch.float32) \
            .reshape(-1, 3) + 100 * i
        return [f.wait_tensor(x) for x in (
            f.all_to_all_single(rows, splits, splits, world),
            f.all_reduce(t * r, "max", world),
            f.all_gather_into_tensor(t * r, 4, world),
            f.reduce_scatter_tensor(t * r, "sum", 4, world))]

    native, _counts = run()
    gloo_cuda.STAGING_BYTES = 48
    gloo_cuda.install("CPU")
    routed, counts = run()
    # the exchange leaves this rank its rows over data, the middle
    # dimension whole and its half of the last over model
    c = dm.get_coordinate()
    want = t[c[0] * 2:(c[0] + 1) * 2, :, c[1] * 4:(c[1] + 1) * 4]
    return all(torch.equal(a, b) for a, b in zip(native, routed)) \
        and torch.equal(native[0], t) and torch.equal(routed[5], want) \
        and counts["all-to-all"] == 1 and sum(counts.values()) == 1


# ------------------------------------------------------- SpmdGroup itself
def _whoami(tag):
    import torch.distributed as dist
    return (tag, dist.get_rank(), dist.get_world_size())


def _fail_on(rank):
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} refuses")
    return dist.get_rank()


def test_spmd_group_runs_on_every_rank_and_fails_as_a_whole():
    with SpmdGroup(2, device="cpu", threads=1, timeout_s=60) as g:
        assert g.run(_whoami, "a") == [("a", 0, 2), ("a", 1, 2)]
        g.start(_whoami, "b")
        with pytest.raises(SpmdError, match="still running"):
            g.start(_whoami, "c")
        assert g.results() == [("b", 0, 2), ("b", 1, 2)]
        with pytest.raises(SpmdError, match="rank 1 refuses"):
            g.run(_fail_on, 1)
        with pytest.raises(SpmdError, match="closed"):
            g.run(_whoami, "d")

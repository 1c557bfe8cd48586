"""Sharded model compute on ``DTensor``s held against the JAX package.

One group of four spawned ranks (gloo on the CPU, one thread each) serves
every case of this file as a ``(data 2, model 2)`` ``DeviceMesh``; the
functions they run are in ``tests/test_torch_spmd.py``. Each
case builds the same JAX-initialised parameters (carried over by
``repro_torch.convert``) and the same batch in every rank, lays them out
by the partition rules (``distribute_tree``) and runs the port's own entry
point under ``sharding.context.activate``; the gathered results are held
against ``repro``'s unsharded result for the same weights and against the
port's unsharded one, in fp32:

* the llama3.2-1b smoke variant's train step in ``2d``, ``tp_zero1`` and
  ``fsdp`` (batch over both axes), starcoder2's with
  ``ulysses_attention`` at S 256, and dbrx's MoE in ``2d``: the loss and
  every updated parameter;
* llama3.2-1b's with ``ulysses_attention`` and with
  ``seq_parallel_residual`` at S 256 (the configuration the card runs
  them in);
* decode with the batch-sharded cache (in ``2d`` and ``tp_zero1``),
  with ``decode_kv_seq_shard`` over a 256-slot cache, and one
  long-context prompt with the ``seq`` axis on ``data``: the prefill's
  last logits and four teacher-forced decode steps' logits;
* the forward with ``seq_parallel_residual`` (S 128), and dbrx's MoE
  forward: logits and the MoE aux loss;
* the dry run's fake (2, 2) trace against what the ranks count, in
  ``2d``, ``tp_zero1``, ``fsdp`` and with Ulysses.

Logits and loss within 1e-5 relative L2 error, and the updated
parameters within 1e-5 relative L2 error over the whole tree (XLA, ATen
and the ranks' partial sums add in other orders). Not leaf by leaf: a
leaf whose gradient is zero in exact arithmetic (the key bias ``bk``: a
constant added to every logit of a row leaves its softmax as it is) has
a gradient of rounding noise, which AdamW's first step normalises to an
update of up to ``lr``, different in every summation order. The partition
modes and sequence-parallel flags only lay the same step out, so the
llama3.2-1b cases at one length share one reference. ``repro``'s own
tests pin that its results do not depend on the mesh, so its unsharded
result is the reference for every layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.serving import engine as JE
from repro.training import loop as jloop
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_numpy_state, to_numpy_state
from repro_torch.core.tree import leaves, map_leaves
from repro_torch.launch.spmd import SpmdGroup
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.serving import engine as TE
from repro_torch.training.loop import make_train_step
from test_torch_spmd import (_rank_count, _rank_decode, _rank_forward,
                             _rank_prefill_caches, _rank_train)

RTOL = 1e-5


@pytest.fixture(scope="module")
def group():
    with SpmdGroup(4, device="cpu", threads=1, timeout_s=300) as g:
        yield g


def _configs(name, **kw):
    jcfg = dataclasses.replace(jsmoke(jget_config(name)), dtype="float32",
                               **kw)
    cfg = dataclasses.replace(smoke_variant(get_config(name)),
                              dtype="float32", **kw)
    return jcfg, cfg


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _inputs(jcfg, B, S, seed=0):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    return jparams, params_np, tokens


# ------------------------------------------------------------ rank bodies


# ------------------------------------------------------------- references
def _jax_train(jcfg, jparams, tokens):
    jopt = jadamw.init_opt_state(jparams)
    step = jax.jit(jloop.make_train_step(jcfg, jadamw.AdamWConfig()))
    jp, _jo, jloss = step(jparams, jopt, {"tokens": jnp.asarray(tokens)})
    return float(jloss), jax.tree_util.tree_map(np.asarray, jp)


def _port_train(cfg, params_np, tokens):
    params = map_leaves(lambda t: t.requires_grad_(True),
                        from_numpy_state(params_np, "cpu"))
    opt = init_opt_state(params)
    p, _o, loss = make_train_step(cfg, AdamWConfig())(
        params, opt, {"tokens": torch.from_numpy(tokens)})
    return loss.item(), to_numpy_state(map_leaves(lambda t: t.detach(), p))


def _check_params(got, want, what):
    got, want = leaves(got), leaves(want)
    assert [g.shape for g in got] == [w.shape for w in want], what
    flat = [np.concatenate([np.ravel(a).astype(np.float64) for a in t])
            for t in (got, want)]
    assert _rel(*flat) <= RTOL, (what, _rel(*flat))


_REFERENCES = {}


def _case_inputs(name, S, **kw):
    """``(cfg, params_np, tokens)`` of a train case."""
    jcfg, cfg = _configs(name, **kw)
    return (cfg,) + _inputs(jcfg, 4, S)[1:]


#: settings that act only under a mesh: the unsharded step is the same
#: whatever they say
MESH_ONLY = ("sharding_mode", "ulysses_attention", "seq_parallel_residual")


def _references(name, S, **kw):
    """``((loss, params, what) of repro, of the port)``: the unsharded
    step, once for every partition mode and sequence-parallel flag."""
    key = (name, S, tuple(sorted((k, v) for k, v in kw.items()
                                 if k not in MESH_ONLY)))
    if key not in _REFERENCES:
        jcfg, cfg = _configs(name, **kw)
        jparams, params_np, tokens = _inputs(jcfg, 4, S)
        _REFERENCES[key] = (
            (*_jax_train(jcfg, jparams, tokens), "repro"),
            (*_port_train(cfg, params_np, tokens), "port unsharded"))
    return _REFERENCES[key]


TRAIN_CASES = {
    "2d": ("llama3.2-1b", {"sharding_mode": "2d"}, 32),
    "tp_zero1": ("llama3.2-1b", {"sharding_mode": "tp_zero1"}, 32),
    "fsdp": ("llama3.2-1b", {"sharding_mode": "fsdp"}, 32),
    "ulysses": ("starcoder2-7b", {"ulysses_attention": True}, 256),
    # the configuration the card runs Ulysses and the sequence-parallel
    # residual in (chip_smoke.py's phase 15), one reference for both
    "ulysses_llama": ("llama3.2-1b", {"ulysses_attention": True}, 256),
    "seq_parallel_residual": ("llama3.2-1b",
                              {"seq_parallel_residual": True}, 256),
    # the MoE's experts on each rank's local shards (their einsums under
    # grad), dbrx's smoke variant
    "moe_2d": ("dbrx-132b", {"sharding_mode": "2d"}, 32),
}
# the recurrent blocks (the RG-LRU's scan and RWKV6's WKV on each rank's
# local channels or heads) in the three partition modes
for _mode in ("2d", "tp_zero1", "fsdp"):
    TRAIN_CASES[f"rec_{_mode}"] = ("recurrentgemma-2b",
                                   {"sharding_mode": _mode}, 32)
    TRAIN_CASES[f"rwkv_{_mode}"] = ("rwkv6-7b", {"sharding_mode": _mode}, 32)
#: the first block's matrix whose local shape shows the layout, by config
LAYOUT_MATRIX = {"recurrentgemma-2b": ("rec", "w_rec_in"),
                 "rwkv6-7b": ("tmix", "wr"), "dbrx-132b": ("attn", "wq")}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_reference(group, case):
    name, kw, S = TRAIN_CASES[case]
    cfg, params_np, tokens = _case_inputs(name, S, **kw)
    matrix = LAYOUT_MATRIX.get(name, ("attn", "wq"))
    group.start(_rank_train, cfg, params_np, tokens, matrix)  # refs
    refs = _references(name, S, **kw)
    res = group.results()
    losses = [r[0] for r in res]
    assert len(set(losses)) == 1  # every rank holds the same loss
    got = res[0][1]
    for ref_loss, ref, what in refs:
        assert abs(losses[0] - ref_loss) <= RTOL * abs(ref_loss), what
        _check_params(got, ref, f"{case} vs {what}")
    # the layout is real: the stacked wq (1, d, H*hd) (or the recurrent
    # block's input matrix) is split in four in 2d, over model in tp_zero1
    # (its momentum also over data), over the whole mesh in fsdp
    d, hdh = params_np["groups"][0][0][matrix[0]][matrix[1]].shape[1:]
    expect = {"2d": ((1, d // 2, hdh // 2), (1, d // 2, hdh // 2)),
              "tp_zero1": ((1, d, hdh // 2), (1, d // 2, hdh // 2)),
              "fsdp": ((1, d // 4, hdh), (1, d // 4, hdh)),
              "ulysses": ((1, d // 2, hdh // 2), (1, d // 2, hdh // 2))}
    expect["ulysses_llama"] = expect["seq_parallel_residual"] = \
        expect["ulysses"]
    assert res[0][2] == expect[case.split("_", 1)[-1]
                               if name in LAYOUT_MATRIX else case]


#: decode cases: (config overrides, batch, the ``seq`` axis, the first
#: cache's k (1, B, T, KV, hd) as each rank holds it): the batch over
#: data and the KV heads over model (the cache as ``cache_pspecs`` lays
#: it out), the 256-slot cache's sequence over model and the batch over
#: data, or for one long-context prompt the sequence over data (context
#: parallelism)
DECODE_CASES = {
    "decode_2d": ({}, 4, None, (1, 2, 256, 1, 64)),
    "decode_kv_seq_shard": ({"decode_kv_seq_shard": True}, 4, None,
                            (1, 2, 128, 2, 64)),
    "long_context": ({}, 1, "data", (1, 1, 128, 2, 64)),
    # the paper's layout: the params over model, replicated over data
    # (the cache is laid out as in 2d)
    "decode_tp_zero1": ({"sharding_mode": "tp_zero1"}, 4, None,
                        (1, 2, 256, 1, 64)),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_sharded_decode_with_seq_sharded_cache(group, case):
    kw, B, seq_axis, local_k = DECODE_CASES[case]
    jcfg, cfg = _configs("llama3.2-1b", max_decode_len=4, **kw)
    jparams, params_np, prompt = _inputs(jcfg, B, 252)
    steps = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, 4)).astype(np.int32)
    group.start(_rank_decode, cfg, params_np, prompt, steps, seq_axis)
    jl, jc = JE.make_prefill_step(jcfg)(jparams,
                                        {"tokens": jnp.asarray(prompt)})
    want = [np.asarray(jl)]
    tl, tc = TE.make_prefill_step(cfg)(from_numpy_state(params_np, "cpu"),
                                       {"tokens": torch.from_numpy(prompt)})
    port = [tl.numpy()]
    tparams = from_numpy_state(params_np, "cpu")
    for i in range(steps.shape[1]):
        pos = prompt.shape[1] + i
        jl, jc = JE.make_decode_step(jcfg)(
            jparams, jnp.asarray(steps[:, i:i + 1]), jc, pos)
        want.append(np.asarray(jl))
        tl, tc = TE.make_decode_step(cfg)(
            tparams, torch.from_numpy(steps[:, i:i + 1]), tc, pos)
        port.append(tl.numpy())
    got, layout = group.results()[0]
    assert layout[1] == local_k
    for g, w, p in zip(got, want, port):
        assert _rel(g, w) <= RTOL and _rel(g, p) <= RTOL


FORWARD_CASES = {
    "seq_parallel_residual": ("llama3.2-1b",
                              {"seq_parallel_residual": True}, 128),
    "moe": ("dbrx-132b", {}, 32),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_sharded_forward_matches_reference(group, case):
    name, kw, S = FORWARD_CASES[case]
    jcfg, cfg = _configs(name, **kw)
    jparams, params_np, tokens = _inputs(jcfg, 4, S)
    group.start(_rank_forward, cfg, params_np, tokens)
    jl, jaux, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl, taux, _ = TM.forward_aux(cfg, from_numpy_state(params_np, "cpu"),
                                     {"tokens": torch.from_numpy(tokens)})
    got, aux = group.results()[0]
    assert _rel(got, np.asarray(jl)) <= RTOL
    assert _rel(got, tl.numpy()) <= RTOL
    assert _rel(aux, float(jaux)) <= RTOL and _rel(aux, float(taux)) <= RTOL
    if case == "moe":
        assert float(jaux) > 0


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-7b"])
def test_sharded_recurrent_prefill_and_decode(group, name):
    """The RG-LRU and RWKV6 blocks' prefill and three teacher-forced
    decode steps on the mesh (their states laid out by ``cache_pspecs``:
    channels or heads over ``model``), against ``repro``'s and the
    port's unsharded logits."""
    jcfg, cfg = _configs(name, max_decode_len=4)
    jparams, params_np, prompt = _inputs(jcfg, 4, 32)
    steps = np.random.default_rng(1).integers(
        0, jcfg.vocab, (4, 3)).astype(np.int32)
    group.start(_rank_decode, cfg, params_np, prompt, steps)
    jl, jc = JE.make_prefill_step(jcfg)(jparams,
                                        {"tokens": jnp.asarray(prompt)})
    want = [np.asarray(jl)]
    tparams = from_numpy_state(params_np, "cpu")
    tl, tc = TE.make_prefill_step(cfg)(tparams,
                                       {"tokens": torch.from_numpy(prompt)})
    port = [tl.numpy()]
    for i in range(steps.shape[1]):
        pos = prompt.shape[1] + i
        jl, jc = JE.make_decode_step(jcfg)(
            jparams, jnp.asarray(steps[:, i:i + 1]), jc, pos)
        want.append(np.asarray(jl))
        tl, tc = TE.make_decode_step(cfg)(
            tparams, torch.from_numpy(steps[:, i:i + 1]), tc, pos)
        port.append(tl.numpy())
    got, layout = group.results()[0]
    assert "Shard" in layout[0]
    for g, w, p in zip(got, want, port):
        assert _rel(g, w) <= RTOL and _rel(g, p) <= RTOL


#: ring caches: (config, the prompt's length past a multiple of the ring)
RING_CASES = {"window": ("gemma3-27b", 40), "chunked":
              ("llama4-maverick-400b-a17b", 40)}


@pytest.mark.parametrize("kind", sorted(RING_CASES))
def test_sharded_ring_cache_prefill(group, kind):
    """``window`` and ``chunked`` prefill write their ring caches under the
    mesh: gathered, every cache equals the unsharded prefill's (within
    1e-5 relative L2, the K/V projections add their partial sums in
    another order; the empty slots exactly zero), and the last logits
    ``repro``'s."""
    name, S = RING_CASES[kind]
    jcfg, cfg = _configs(name)
    assert any(b.split("_")[0] == kind for p, _n in cfg.layer_groups
               for b in p)
    jparams, params_np, prompt = _inputs(jcfg, 4, S)
    group.start(_rank_prefill_caches, cfg, params_np, prompt)
    try:
        jl, _jc = JE.make_prefill_step(jcfg)(
            jparams, {"tokens": jnp.asarray(prompt)})
        with torch.no_grad():
            _tl, tc = TE.make_prefill_step(cfg)(
                from_numpy_state(params_np, "cpu"),
                {"tokens": torch.from_numpy(prompt)})
    finally:
        logits, caches, placements = group.results()[0]
    assert "Shard" in placements
    assert _rel(logits, np.asarray(jl)) <= RTOL
    got, want = leaves(caches), leaves(to_numpy_state(tc))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL
        assert np.array_equal(g == 0, w == 0)


#: what chip_smoke.py's phase 15 holds each rank's counted step against
#: the fake trace in: (config, overrides, tokens); the 2d step, and
#: llama3.2-1b in the paper's layout, the batch over both axes and
#: Ulysses' exchange
COUNT_CASES = {"llama3.2-1b": ("llama3.2-1b", {}, 32),
               "recurrentgemma-2b": ("recurrentgemma-2b", {}, 32),
               "tp_zero1": ("llama3.2-1b", {"sharding_mode": "tp_zero1"}, 32),
               "fsdp": ("llama3.2-1b", {"sharding_mode": "fsdp"}, 32),
               "ulysses": ("llama3.2-1b", {"ulysses_attention": True}, 128)}


@pytest.mark.parametrize("name", list(COUNT_CASES))
def test_fake_trace_counts_what_the_ranks_run(group, name):
    """The dry run's trace of a train step on a fake (2, 2) mesh (rank
    0's local program) against the same step run by the four gloo ranks
    under the same counter: per-device FLOPs, collectives' counts and
    bytes by kind, and the per-kind op profile (every operator kind's
    count and result bytes), equal on every rank (fsdp: the batch over
    both axes on the ranks, as the dry run sets it)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    arch, kw, S = COUNT_CASES[name]
    cfg, params_np, tokens = _case_inputs(arch, S, **kw)
    group.start(_rank_count, cfg, params_np, tokens, "train")
    try:
        rec = dryrun.dryrun_record(
            cfg, InputShape("t", S, 4, "train"),
            make_abstract_mesh((2, 2), ("data", "model")), record_ops=True)
    finally:
        ranks = group.results()
    roof = rec["roofline"]
    want = {"flops": roof["per_device"]["flops"],
            "collectives": {k: roof["collectives"][k] for k in (
                "bytes_per_device", "by_kind", "counts")},
            "profile": rec["op_profile"]}
    assert want["collectives"]["bytes_per_device"] > 0
    for rank, got in enumerate(ranks):
        assert got == want, rank

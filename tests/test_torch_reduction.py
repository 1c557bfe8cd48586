"""The port's offline reducer (``repro_torch.core.reduction``) held against
the JAX package's (``repro.core.reduction``).

* ``encode_tensor``: the same numpy input through both packages gives the
  same record fields (codec, quant, dtype, shape, checksum, raw size) and
  the same decompressed payload and scales, for quant ``none``/``bf16``/
  ``int8``, raw and delta, over the dtypes of ``tests/test_reduction.py``
  plus bfloat16. One pinned exception: the reference quantizes through the
  jitted Pallas kernel, whose scales are ``amax * fl(1/127)``; the port's
  are the IEEE quotient of its fused encode and of ``ref.quantize_int8_ref``
  (the repo's 1-ulp jit convention, ``tests/test_fused_kernels.py:118``).
  Int8 scales are held to one ulp of the reference's and bit for bit to
  the oracle's; q to the reference's on every row whose scale agrees.
* ``decode_tensor`` gives the same bits in both packages, and each decodes
  the other's records.
* ``DifferentialCheckpointer``: a directory written by either package
  restores bit-exactly through the other; record names are
  ``jax.tree_util.keystr``; the restart and damaged-tail cases of
  ``tests/test_reduction.py`` hold for the port; a temp file left by a
  writer that died is invisible to both packages' restores; reading the
  reference's records imports nothing of ``repro``.
* ``device="cuda"`` on a card-less host raises. All else runs with
  ``device="cpu"``: the kernels' plain versions.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import reduction as J  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import dtypes  # noqa: E402
from repro_torch.core import reduction as T  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402
from repro_torch.storage import backend as tbackend  # noqa: E402

F32 = np.float32
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _array(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    if dt.kind in "fV" or dtype == "bfloat16":
        return rng.standard_normal(shape).astype(dt)
    return rng.integers(0, 100, size=shape).astype(dt)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """The numpy array as a CPU tensor, bytes unchanged."""
    return T._leaf_tensor(a, torch.device("cpu"))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _scale_ulps(jenc, tenc) -> np.ndarray:
    js = np.frombuffer(J._decompress(jenc.scales), np.int32)
    ts = np.frombuffer(T._decompress(tenc.scales), np.int32)
    return np.abs(js.astype(np.int64) - ts.astype(np.int64))


def _assert_same_record(jenc, tenc, x: np.ndarray, agree=None) -> None:
    """Fields equal, payload and scales equal once decompressed; for int8
    see the module docstring. ``agree`` masks the int8 rows whose payload
    bytes must agree (rows whose scales agree in every step the payload
    depends on)."""
    assert (tenc.codec, tenc.quant, tenc.dtype, tuple(tenc.shape),
            tenc.checksum, tenc.raw_nbytes) == \
        (jenc.codec, jenc.quant, jenc.dtype, tuple(jenc.shape),
         jenc.checksum, jenc.raw_nbytes)
    jp, tp = J._decompress(jenc.payload), T._decompress(tenc.payload)
    assert len(jp) == len(tp)
    if jenc.quant != "int8":
        assert tp == jp
        assert tenc.scales is None and jenc.scales is None
        return
    ts = np.frombuffer(T._decompress(tenc.scales), F32)
    _q, oracle = jref.quantize_int8_ref(x)
    np.testing.assert_array_equal(ts.view(np.uint32),
                                  np.asarray(oracle, F32).reshape(-1)
                                  .view(np.uint32))
    assert _scale_ulps(jenc, tenc).max() <= 1
    n = x.shape[0] * 256
    jq = np.frombuffer(jp, np.int8)
    tq = np.frombuffer(tp, np.int8)
    np.testing.assert_array_equal(tq[n:], jq[n:])     # the delta padding
    np.testing.assert_array_equal(tq[:n].reshape(-1, 256)[agree],
                                  jq[:n].reshape(-1, 256)[agree])


QUANT_CASES = [("none", (100, 37), "float32"),
               ("none", (17,), "float16"),
               ("none", (3, 5, 7), "int32"),
               ("none", (33,), "uint8"),
               ("none", (5, 9), "int8"),
               ("none", (), "float32"),
               ("none", (64, 3), "bfloat16"),
               ("bf16", (256, 512), "float32"),
               ("bf16", (100, 256), "float32"),     # falls back to raw
               ("int8", (512, 256), "float32"),
               ("int8", (256, 512), "float32")]     # falls back to raw


@pytest.mark.parametrize("quant,shape,dtype", QUANT_CASES)
def test_encode_decode_matches_reference(quant, shape, dtype):
    """A keyframe then a delta against its working array, in both
    packages; the delta's decode is checked against a fresh encode of the
    new value, as ``test_property_quant_delta_codec_mixes`` does."""
    x0 = _array(shape, dtype, seed=1)
    x1 = np.array(x0, copy=True)
    flat = x1.reshape(-1)
    if flat.size:
        flat[::5] += np.asarray(1, x1.dtype)
    jenc0, jw0 = J.encode_tensor(jnp.asarray(x0), quant=quant)
    tenc0, tw0 = T.encode_tensor(_tensor(x0), quant=quant)
    agree0 = _scale_ulps(jenc0, tenc0) == 0 if jenc0.quant == "int8" \
        else None
    _assert_same_record(jenc0, tenc0, x0, agree0)
    assert tenc0.codec == "raw"
    assert dtypes.host_name(tw0) == str(np.asarray(jw0).dtype)
    jdec0, tdec0 = J.decode_tensor(jenc0), T.decode_tensor(tenc0)
    assert tdec0.shape == jdec0.shape
    if jenc0.quant == "int8":
        np.testing.assert_array_equal(tdec0[agree0], jdec0[agree0])
    else:
        np.testing.assert_array_equal(_bits(tdec0), _bits(jdec0))
    # each package decodes the other's record
    np.testing.assert_array_equal(_bits(T.decode_tensor(jenc0)),
                                  _bits(jdec0))
    np.testing.assert_array_equal(_bits(J.decode_tensor(tenc0)),
                                  _bits(tdec0))

    jenc1, _ = J.encode_tensor(jnp.asarray(x1), prev=jw0, quant=quant)
    tenc1, tw1 = T.encode_tensor(_tensor(x1), prev=tw0, quant=quant)
    assert tenc1.codec == "delta-xor"
    agree = None
    if jenc1.quant == "int8":
        agree = agree0 & (_scale_ulps(jenc1, tenc1) == 0)
    _assert_same_record(jenc1, tenc1, x1, agree)
    tdec1 = T.decode_tensor(tenc1, prev=tdec0)
    np.testing.assert_array_equal(_bits(tdec1), _bits(tw1))
    np.testing.assert_array_equal(
        _bits(tdec1), _bits(T.decode_tensor(T.encode_tensor(
            _tensor(x1), quant=quant)[0])))
    np.testing.assert_array_equal(
        _bits(J.decode_tensor(tenc1, prev=tdec0)), _bits(tdec1))


def test_bf16_working_array_is_not_a_uint16_leafs():
    """The reference compares working dtypes before a delta: a bf16
    working array (uint16 storage here) must not be taken for a uint16
    leaf's, so the encode falls back to raw as the reference's does."""
    u16 = np.arange(256 * 256, dtype=np.uint16).reshape(256, 256)
    prev = u16.copy()
    x = _array((256, 256), "float32", seed=3)
    tenc, tw = T.encode_tensor(_tensor(x), prev=prev, quant="bf16")
    assert tenc.codec == "raw" and tw.dtype == np.uint16 \
        and dtypes.host_name(tw) == "bfloat16"
    tenc2, _ = T.encode_tensor(_tensor(x), prev=tw, quant="bf16")
    assert tenc2.codec == "delta-xor"
    jenc, _ = J.encode_tensor(jnp.asarray(x), prev=prev.view(np.uint16),
                              quant="bf16")
    assert jenc.codec == "raw"


def test_in_place_updates_do_not_reach_saved_bases(tmp_path):
    """Tensors are updated in place between saves (the port's AdamW does);
    the retained delta bases and the restored steps are copies, so every
    step restores as it was saved, on every route."""
    for quant in ("none", "bf16", "int8"):
        w = torch.from_numpy(_array((256, 256), "float32", seed=6))
        tree = {"w": w, "v": w[0].clone()}
        ck = T.DifferentialCheckpointer(str(tmp_path / quant), quant=quant,
                                        device="cpu")
        saved = []
        for step in range(3):
            ck.save(step, tree)
            saved.append({k: T.encode_tensor(v, quant=quant)[1]
                          for k, v in (("['v']", tree["v"]),
                                       ("['w']", tree["w"]))})
            w.mul_(1.5).add_(0.25)
            tree["v"].add_(1.0)
        for step, want in enumerate(saved):
            got = ck.restore(step)
            for name, a in want.items():
                np.testing.assert_array_equal(_bits(got[name]), _bits(a))


def test_quantized_error_is_bounded():
    """The reference's own bound (``tests/test_reduction.py:40-51``)."""
    x = _array((256, 256), "float32", seed=2)
    enc, _ = T.encode_tensor(_tensor(x), quant="int8")
    out = T.decode_tensor(enc).astype(F32)
    scales = np.frombuffer(T._decompress(enc.scales), F32).reshape(256, 1)
    assert (np.abs(out * scales - x) <= scales).all()


def _steps(quant: str):
    """Three states of a tree with quantizable, fallback, integer and
    bf16 leaves (nested dicts and tuples)."""
    a = _array((256, 256), "float32", seed=10)
    b = _array((512, 256), "float32", seed=11)
    out = []
    for i in range(3):
        out.append({"w": {"a": a + F32(0.01 * i), "b": (b * F32(1 + i),)},
                    "n": np.arange(37, dtype=np.int32) + i,
                    "h": _array((8, 16), "bfloat16", seed=20 + i),
                    "s": np.float32(i)})
    return out


@pytest.mark.parametrize("quant", ["none", "bf16", "int8"])
def test_port_directory_restores_through_reference(tmp_path, quant):
    ck = T.DifferentialCheckpointer(str(tmp_path), keyframe_every=3,
                                    quant=quant, device="cpu")
    works = []
    for step, tree in enumerate(_steps(quant)):
        info = ck.save(step, tree)
        assert info["keyframe"] == (step == 0)
        works.append({k: v.copy() for k, v in ck._prev.items()})
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(_steps(quant)[0])[0]]
    jck = J.DifferentialCheckpointer(str(tmp_path))
    for step, want in enumerate(works):
        got_t = ck.restore(step)
        got_j = jck.restore(step)
        assert list(got_t) == names and sorted(got_j) == sorted(names)
        for name in names:
            np.testing.assert_array_equal(_bits(got_t[name]),
                                          _bits(want[name]))
            np.testing.assert_array_equal(_bits(got_j[name]),
                                          _bits(want[name]))


@pytest.mark.parametrize("quant", ["none", "bf16", "int8"])
def test_reference_directory_restores_through_port(tmp_path, quant):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jck = J.DifferentialCheckpointer(str(jdir), keyframe_every=3,
                                     quant=quant)
    tck = T.DifferentialCheckpointer(str(tdir), keyframe_every=3,
                                     quant=quant, device="cpu")
    for step, tree in enumerate(_steps(quant)):
        jinfo = jck.save(step, tree)
        tinfo = tck.save(step, tree)
        assert (jinfo["keyframe"], jinfo["raw_bytes"]) == \
            (tinfo["keyframe"], tinfo["raw_bytes"])
        jrec = T.load_record(jinfo["path"])
        trec = T.load_record(tinfo["path"])
        assert list(jrec["tensors"]) == list(trec["tensors"])
        if quant != "int8":
            for name, jenc in jrec["tensors"].items():
                _assert_same_record(jenc, trec["tensors"][name], None)
    reader = T.DifferentialCheckpointer(str(jdir), device="cpu")
    for step in range(3):
        want = jck.restore(step)
        got = reader.restore(step)
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(_bits(got[name]),
                                          _bits(want[name]))


def test_record_names_are_jax_keystr_of_the_llama_tree(tmp_path):
    """The smoke llama3.2-1b parameter tree (nested dicts and tuples of
    blocks) as numpy, through both packages' checkpointers."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    tree = jax.tree_util.tree_map(
        lambda spec: np.zeros(spec.shape, F32), param_shapes(cfg),
        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "scale"))
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert "['groups'][0][0]['attn']['wq']" in want \
        and "['embed']['embed']" in want
    info = T.DifferentialCheckpointer(
        str(tmp_path / "t"), quant="bf16", device="cpu").save(0, tree)
    jinfo = J.DifferentialCheckpointer(
        str(tmp_path / "j"), quant="bf16").save(0, tree)
    assert list(T.load_record(info["path"])["tensors"]) == want
    assert list(T.load_record(jinfo["path"])["tensors"]) == want


def test_restart_continues_chain(tmp_path):
    """``tests/test_reduction.py:71-98`` for the port: a restarted
    checkpointer takes its cadence from disk and re-arms its bases."""
    t0 = {"a": np.arange(1000, dtype=F32)}
    steps = [t0]
    for _ in range(3):
        nxt = {"a": steps[-1]["a"].copy()}
        nxt["a"][::9] += 1.0
        steps.append(nxt)
    ck = T.DifferentialCheckpointer(str(tmp_path), keyframe_every=4,
                                    device="cpu")
    ck.save(0, steps[0])
    ck.save(1, steps[1])
    ck2 = T.DifferentialCheckpointer(str(tmp_path), keyframe_every=4,
                                     device="cpu")
    assert ck2._n_saves == 2
    info = ck2.save(2, steps[2])
    assert not info["keyframe"]
    rec = T.load_record(os.path.join(tmp_path, "diff_00000002.pkl"))
    assert all(e.codec == "delta-xor" for e in rec["tensors"].values())
    ck2.save(3, steps[3])
    for step, tree in enumerate(steps):
        state = T.DifferentialCheckpointer(str(tmp_path),
                                           device="cpu").restore(step)
        np.testing.assert_array_equal(state["['a']"], tree["a"])
        np.testing.assert_array_equal(
            J.DifferentialCheckpointer(str(tmp_path)).restore(step)["['a']"],
            tree["a"])


def test_restart_with_damaged_tail(tmp_path):
    """``tests/test_reduction.py:101-117`` for the port: unreadable
    records at restart force a keyframe, never a delta against nothing."""
    t0 = {"a": np.arange(512, dtype=F32)}
    ck = T.DifferentialCheckpointer(str(tmp_path), keyframe_every=4,
                                    device="cpu")
    ck.save(0, t0)
    ck.save(1, {"a": t0["a"] + 1})
    for f in sorted(os.listdir(tmp_path)):
        with open(os.path.join(tmp_path, f), "r+b") as fh:
            fh.truncate(8)
    ck2 = T.DifferentialCheckpointer(str(tmp_path), keyframe_every=4,
                                     device="cpu")
    t2 = {"a": t0["a"] + 2}
    assert ck2.save(2, t2)["keyframe"]
    np.testing.assert_array_equal(ck2.restore(2)["['a']"], t2["a"])
    with pytest.raises(ValueError, match="no keyframe"):
        ck2.restore(1)


def test_dead_writers_temp_file_is_invisible(tmp_path, monkeypatch):
    """A writer that dies between the temp file and the rename leaves the
    temp behind; neither package's restore lists it as a record (the
    reference takes any unreadable ``diff_*`` as a damaged link, which
    would drop the chain before it)."""
    ck = T.DifferentialCheckpointer(str(tmp_path), keyframe_every=4,
                                    device="cpu")
    t0 = {"a": np.arange(512, dtype=F32)}
    ck.save(0, t0)
    ck.save(1, {"a": t0["a"] + 1})

    def die(_src, _dst):
        raise OSError("writer killed before the rename")
    monkeypatch.setattr(tbackend.os, "replace", die)
    with pytest.raises(OSError):
        ck.save(2, {"a": t0["a"] + 2})
    monkeypatch.undo()
    left = sorted(os.listdir(tmp_path))
    assert len(left) == 3 and left[0].startswith(".diff_00000002.pkl.tmp-")
    want = t0["a"] + 1
    np.testing.assert_array_equal(ck.restore(2)["['a']"], want)
    np.testing.assert_array_equal(
        J.DifferentialCheckpointer(str(tmp_path)).restore(2)["['a']"], want)
    assert T.DifferentialCheckpointer(str(tmp_path),
                                      device="cpu")._n_saves == 2


def test_reading_reference_records_imports_no_repro(tmp_path):
    """A reference-written directory restores in a process where ``repro``
    and ``jax`` cannot be imported."""
    J.DifferentialCheckpointer(str(tmp_path), keyframe_every=4,
                               quant="int8").save(
        0, {"m": _array((256, 256), "float32", seed=4)})
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("repro", "jax", "jaxlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from repro_torch.core.reduction import DifferentialCheckpointer
state = DifferentialCheckpointer({str(tmp_path)!r}, device="cpu").restore(0)
print(state["['m']"].dtype, state["['m']"].shape)
assert not any(m.split(".")[0] in ("repro", "jax") for m in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["int8", "(256,", "256)"]


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="is_available"):
        T.DifferentialCheckpointer(str(tmp_path), device="cuda")
    with pytest.raises(ValueError, match="unsupported"):
        T.DifferentialCheckpointer(str(tmp_path), device="meta")


def test_port_records_pickle_the_ports_class(tmp_path):
    info = T.DifferentialCheckpointer(str(tmp_path), device="cpu").save(
        0, {"a": np.ones(4, F32)})
    with open(info["path"], "rb") as fh:
        rec = pickle.load(fh)
    assert type(rec["tensors"]["['a']"]) is T.EncodedTensor

"""The segmented XOR digest and the delta provider's pieces, held against
the JAX package.

* ``xor_checksum_segments_plain`` (what a CPU tensor dispatches to) gives
  each segment ``repro.kernels.ref.fused_xor_checksum_ref``'s delta and
  digest, and the Pallas kernel's in interpret mode, at every layout of
  ``variants.XOR_CASES`` but the 64 MiB one (the card's).
* ``DeltaStateProvider`` encodes a delta step a piece of chunks at a time:
  its chunks are ``repro.core.codecs.encode_delta_chunk`` of each chunk
  alone, in order, and its snapshot base ends equal to the staged bytes;
  a stream closed in the middle of a piece credits its budget back; a
  delta chain written in pieces restores bit-exactly through both
  packages and passes ``repro``'s verify.
* ``gpu``-marked tests hold the CUDA kernel against the plain version on
  a card; they skip inside the test on a host without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.codecs as jcodecs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.storage.repository import CheckpointRepository as JRepository

import repro_torch.core as T
from repro_torch.convert import from_numpy_state, to_numpy_state
from repro_torch.core import codecs as tcodecs
from repro_torch.core import state_provider as tsp
from repro_torch.core.state_provider import (DeltaStateProvider,
                                             EncodeBudget)
from repro_torch.kernels import build, checksum, fused, variants
from repro_torch.kernels import ops as tops
from repro_torch.obs import trace as obs

CPU_CASES = [c for c in variants.XOR_CASES if c not in variants.XOR_CARD_ONLY]


def _bytes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _u32(b: np.ndarray) -> np.ndarray:
    pad = (-b.size) % 4
    return np.concatenate([b, np.zeros(pad, np.uint8)]).view(np.uint32)


@pytest.mark.parametrize("n_bytes,seg_bytes", CPU_CASES)
def test_plain_xor_segments_match_reference(n_bytes, seg_bytes):
    """No words, one segment, a short last segment, byte tails of 1 and
    3 bytes, 4, 5, 16 and 17 segments, segments past a cluster's tiles:
    each segment's delta and digest are the reference's and the Pallas
    kernel's (interpret mode) of that segment alone, through the plain
    version and the dispatch."""
    cur, prev = _bytes(n_bytes, 1), _bytes(n_bytes, 2)
    a = checksum.as_words(torch.from_numpy(cur))
    b = checksum.as_words(torch.from_numpy(prev))
    seg = seg_bytes // 4
    for delta, partials in (fused.xor_checksum_segments_plain(a, b, seg),
                            tops.xor_checksum_segments(a, b, seg)):
        assert partials.dtype == torch.int32
        assert partials.shape == (-(-a.numel() // seg), 1)
        digs = fused.segment_digests(partials)
        d = delta.numpy().view(np.uint32)
        cu, pu = _u32(cur), _u32(prev)
        for s, lo in enumerate(range(0, cu.size, seg)):
            want, want_dig = jref.fused_xor_checksum_ref(cu[lo:lo + seg],
                                                         pu[lo:lo + seg])
            np.testing.assert_array_equal(d[lo:lo + seg], want)
            assert digs[s] == want_dig
            jd, jdig = jops.fused_xor_checksum(cu[lo:lo + seg],
                                               pu[lo:lo + seg],
                                               interpret=True)
            np.testing.assert_array_equal(np.asarray(jd)[:want.size], want)
            assert int(jdig) == want_dig
        assert d.size == cu.size


def test_xor_segments_refuse_bad_lengths():
    """Segments that are not whole 16-byte vectors or not below 2^31
    words, unequal inputs, outputs of the wrong shape, host tensors for
    the kernel: refused before any launch."""
    w = torch.zeros(16, dtype=torch.int32)
    for seg in (0, 6, -4, 1 << 31):
        with pytest.raises(ValueError, match="multiple of 4"):
            tops.xor_checksum_segments(w, w, seg)
        with pytest.raises(ValueError, match="multiple of 4"):
            fused.xor_checksum_segments_cuda(w, w, seg)
    with pytest.raises(ValueError, match="one shape"):
        tops.xor_checksum_segments(w, w[:8], 8)
    with pytest.raises(ValueError, match="cuda"):
        fused.xor_checksum_segments_cuda(w, w, 8)
    with pytest.raises(ValueError, match="cuda"):
        fused.xor_checksum_cuda(w, w)
    with pytest.raises(ValueError, match="expected contiguous int32"):
        fused._outputs(w, 2, None, torch.empty((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="16-byte"):
        tcodecs.DeltaEncodePiece(torch.zeros(40, dtype=torch.uint8),
                                 torch.zeros(40, dtype=torch.uint8), 20,
                                 True, "cpu")


def test_segment_digests_add_partials_mod_2_32():
    """A segment's digest is the sum of its partials mod 2^32, wrapping."""
    parts = torch.tensor([[-1, 1, 5], [2**31 - 1, 2**31 - 1, 3]],
                         dtype=torch.int32)
    assert fused.segment_digests(parts).tolist() == [5, 1]


def test_xor_entries_share_one_count_and_the_kernel_constants(monkeypatch):
    """Both XOR digest entries launch one kernel, so one count covers
    them; the wrappers size the partials by the kernel's kXorMaxGroups."""
    import re
    src = (build.CSRC / "ckpt_kernels.cu").read_text()
    m = re.search(r"constexpr int kXorMaxGroups = (\d+);", src)
    assert int(m.group(1)) == fused.MAX_GROUPS
    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append(name) or 0

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(build, "library", Lib)
    before = fused.KERNEL.launches
    fused.KERNEL.launch(0, 0, 0, 4, 0)
    fused.KERNEL.launch(0, 0, 0, 8, 4, 0, entry=fused.SEGMENTS_ENTRY)
    assert called == ["ckpt_xor_checksum_u32",
                      "ckpt_xor_checksum_u32_segments"]
    assert fused.KERNEL.launches - before == 2


@pytest.mark.parametrize("name", sorted(variants.XOR_ABLATIONS))
def test_xor_ablations_apply_to_the_kernel_source(name):
    """Each variant of ``python -m repro_torch.kernels.variants xor``
    edits ``ckpt_kernels.cu``; only ``xor`` is the shipped kernel, both
    XOR digest entries stay, and only ``atomic_loop`` brings back the
    grid-stride encode with its memset."""
    src = (build.CSRC / variants.STREAM).read_text()
    out = variants.variant_source(variants.XOR_ABLATIONS[name],
                                  variants.STREAM)
    assert (out == src) == (name == "xor")
    assert out.count('extern "C" int ckpt_xor_checksum_u32(') == 1
    assert out.count('extern "C" int ckpt_xor_checksum_u32_segments(') == 1
    assert ("xor_checksum_kernel<false>" in out) == (name == "atomic_loop")
    assert ("cudaMemsetAsync" in out) == (name == "atomic_loop")


# ------------------------------------------------------- delta provider
def _provider(cur: np.ndarray, prev: np.ndarray, chunk_bytes: int,
              keyframe: bool = False) -> DeltaStateProvider:
    p = DeltaStateProvider("w", prev=memoryview(prev), keyframe=keyframe,
                           dtype="uint8", shape=cur.shape, nbytes=cur.nbytes,
                           device="cpu", host_array=cur,
                           chunk_bytes=chunk_bytes)
    return p


#: (chunks, bytes a chunk, chunks a piece): 1, 4, 5 and 17 chunks of 64
#: bytes under budgets whose share is one chunk, four chunks and the
#: whole tensor; chunks of 100 bytes (not whole 16-byte vectors: one a
#: piece), a ragged last chunk
PROVIDER_CASES = [(1, 64, 1), (4, 64, 4), (5, 64, 4), (17, 64, 4),
                  (17, 64, 1), (17, 64, 1 << 20), (5, 100, 1 << 20),
                  (17, 100, 4)]


@pytest.mark.parametrize("n_chunks,chunk_bytes,piece_chunks",
                         PROVIDER_CASES)
@pytest.mark.parametrize("digests", [True, False])
def test_delta_provider_matches_reference_chunk_by_chunk(
        n_chunks, chunk_bytes, piece_chunks, digests):
    """Every chunk's payload, digest, raw range, codec and order are
    ``repro``'s ``encode_delta_chunk`` of that chunk alone; the snapshot
    base ends equal to the staged bytes; one ``encode.delta`` span a
    piece, with its chunk count; every budget reservation comes back."""
    n = n_chunks * chunk_bytes - (7 if n_chunks > 1 else 0)
    cur, prev = _bytes(n, n_chunks), _bytes(n, n_chunks + 100)
    base = prev.copy()
    p = _provider(cur, base, chunk_bytes)
    p.checksum_chunks = digests
    cap = piece_chunks * chunk_bytes * tsp.DELTA_BUDGET_SHARE
    p.encode_budget = budget = EncodeBudget(cap)
    with obs.tracing() as tracer:
        got = []
        for c in p.chunks():
            got.append(c)
            c.on_flushed()   # a flush lane writes it at once
    spans = [(lo, min(lo + chunk_bytes, n)) for lo in range(0, n, chunk_bytes)]
    assert [c.raw_range for c in got] == spans
    assert [c.last for c in got] == [False] * (len(spans) - 1) + [True]
    for c in got:
        lo, hi = c.raw_range
        want, want_dig = jcodecs.encode_delta_chunk(cur[lo:hi], prev[lo:hi],
                                                    with_digest=digests)
        assert bytes(c.data) == bytes(want) and c.digest == want_dig
        assert c.codec == "xor+zstd" and c.offset is None
    np.testing.assert_array_equal(base, cur)
    assert budget._used == 0
    pieces = list(tcodecs.piece_groups(
        spans, 1 if chunk_bytes % 16 else n, cap // tsp.DELTA_BUDGET_SHARE))
    enc = tracer.spans("encode.delta")
    assert [e["args"]["chunks"] for e in enc] == [len(x) for x in pieces]
    assert sum(e["args"]["bytes"] for e in enc) == n


def test_delta_provider_keyframe_refreshes_the_snapshot():
    """A keyframe streams raw fixed-offset chunks and copies each into the
    snapshot, so the next delta save XORs against it."""
    cur, prev = _bytes(300, 3), _bytes(300, 4)
    p = _provider(cur, prev, 64, keyframe=True)
    p.offset = 1000
    got = list(p.chunks())
    assert [c.offset for c in got] == [1000 + lo for lo in range(0, 300, 64)]
    assert b"".join(bytes(c.data) for c in got) == cur.tobytes()
    np.testing.assert_array_equal(prev, cur)


def test_delta_provider_returns_unflushed_reservations():
    """A stream closed in the middle of a piece credits back every chunk
    it never handed on (those of the next piece, started ahead, too); the
    chunks handed on keep theirs."""
    cur, prev = _bytes(40 * 64, 5), _bytes(40 * 64, 6)
    p = _provider(cur, prev.copy(), 64)
    p.encode_budget = budget = EncodeBudget(16 * 64 * tsp.DELTA_BUDGET_SHARE)
    ended = []
    p.on_stream_end = lambda: ended.append(True)
    stream = p.chunks()
    first = [next(stream) for _ in range(3)]
    stream.close()
    assert budget._used == sum(len(c.data) for c in first)
    for c in first:
        c.on_flushed()
    assert budget._used == 0 and ended == [True]


def _state(step: int):
    """A small state whose tensors span several delta pieces: an int32
    leaf, fp32 leaves (one with a ragged tail) and a 0-d count."""
    rng = np.random.default_rng(step)
    base = np.random.default_rng(0)
    w = base.standard_normal((64, 96)).astype(np.float32)
    v = base.standard_normal(5003).astype(np.float32)
    e = base.integers(-2**31, 2**31 - 1, (48, 64), dtype=np.int32)
    for x in (w, v, e):
        hit = rng.random(x.shape) < 0.3
        x[hit] = x[hit] + (step if x.dtype == np.int32 else
                           np.float32(1e-3) * step)
    return {"model": {"w": w, "e": e}, "optimizer": {"v": v,
            "count": np.array(step, np.int32)}, "meta": {"step": step}}


@pytest.mark.parametrize("chunk_bytes", [1024, 1028])
def test_port_saves_delta_pieces_both_packages_restore(
        tmp_path, monkeypatch, chunk_bytes):
    """A K, Δ, Δ chain written by the port with 1 KiB chunks in pieces of
    4 chunks (and with 1,028-byte chunks, one a piece) passes ``repro``'s
    verify, and every step restores bit for bit through ``repro`` and
    through the port."""
    monkeypatch.setattr(tsp, "DELTA_BUDGET_SHARE",
                        (64 << 20) // (4 * chunk_bytes))

    def policy(mod):
        return mod.CheckpointPolicy(
            engine=mod.EnginePolicy(host_cache_bytes=16 << 20,
                                    chunk_bytes=chunk_bytes),
            delta=mod.DeltaPolicy(keyframe_every=3))
    states = {s: _state(s) for s in (1, 2, 3)}
    tm = T.CheckpointManager.from_policy(str(tmp_path), policy(T),
                                         device="cpu")
    try:
        with obs.tracing() as tracer:
            for step in (1, 2, 3):
                tm.save(step, from_numpy_state(states[step], "cpu"))
            tm.wait_for_persist()
        tm.wait_for_commit()
        assert not tm.commit_errors
        chunks = [e["args"]["chunks"] for e in tracer.spans("encode.delta")]
        assert max(chunks) == (4 if chunk_bytes % 16 == 0 else 1)
        template = from_numpy_state(states[1], "cpu")
        for step in (3, 1, 2):
            out = to_numpy_state(tm.restore(template, step=step))
            for k in ("w", "e"):
                np.testing.assert_array_equal(out["model"][k],
                                              states[step]["model"][k])
            np.testing.assert_array_equal(out["optimizer"]["v"],
                                          states[step]["optimizer"]["v"])
    finally:
        tm.close()
    repo = JRepository(str(tmp_path))
    assert repo.chain_steps(3) == [1, 2, 3]
    for step in (1, 2, 3):
        assert repo.verify_step(step).ok
    jm = J.CheckpointManager.from_policy(str(tmp_path), policy(J))
    try:
        for step in (3, 1, 2):
            out = jm.restore(jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
                states[1]), step=step)
            for k in ("w", "e"):
                np.testing.assert_array_equal(np.asarray(out["model"][k]),
                                              states[step]["model"][k])
            np.testing.assert_array_equal(np.asarray(out["optimizer"]["v"]),
                                          states[step]["optimizer"]["v"])
    finally:
        jm.close()


# ----------------------------------------------------------------- card
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("n_bytes,seg_bytes", variants.XOR_CASES)
def test_cuda_xor_segments_match_plain(n_bytes, seg_bytes):
    """Deltas and each segment's digest bit for bit at every layout the
    tool checks, the 64 MiB piece included; one launch, none for no
    words."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n_bytes)
    a, b = variants.xor_inputs(torch, n_bytes, gen)
    before = fused.KERNEL.launches
    d, parts = tops.xor_checksum_segments(a, b, seg_bytes // 4)
    assert fused.KERNEL.launches - before == (1 if n_bytes else 0)
    pd, pparts = fused.xor_checksum_segments_plain(a, b, seg_bytes // 4)
    assert torch.equal(d, pd)
    assert fused.segment_digests(parts).tolist() == \
        fused.segment_digests(pparts).tolist()


@pytest.mark.gpu
def test_cuda_xor_checksum_is_one_device_record():
    """A 4 MiB call records one device event, the kernel: no fill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    a, b = variants.xor_inputs(torch, variants.XOR_CHUNK, gen)
    fused.xor_checksum_cuda(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fused.xor_checksum_cuda(a, b)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    assert len(names) == 1
    assert "xor_checksum_segments_kernel" in next(iter(names))


@pytest.mark.gpu
def test_cuda_xor_segments_on_two_lane_streams():
    """Two lanes encoding different pieces at once, each on its own
    stream: both come out right (the kernel keeps no state in device
    memory between launches)."""
    import threading
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    inputs = [variants.xor_inputs(torch, n, gen)
              for n in (4 * variants.XOR_CHUNK, 3 * variants.XOR_CHUNK + 9)]
    seg = variants.XOR_CHUNK // 4
    want = [fused.xor_checksum_segments_plain(a, b, seg) for a, b in inputs]
    torch.cuda.synchronize()
    got = [[], []]

    def lane(i):
        a, b = inputs[i]
        with tops.lane_stream("cuda") as stream:
            for _ in range(10):
                got[i].append(tops.xor_checksum_segments(a, b, seg))
            stream.synchronize()
    threads = [threading.Thread(target=lane, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 1):
        assert len(got[i]) == 10
        for d, parts in got[i]:
            assert torch.equal(d, want[i][0])
            assert fused.segment_digests(parts).tolist() == \
                fused.segment_digests(want[i][1]).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [1, 5, 4097, 65_537, 1 << 20])
def test_cuda_fold_kernel_matches_plain(n_words):
    """The chain-replay fold keeps its grid-stride kernel: ``base ^ delta``
    and the digest of ``delta`` bit for bit."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n_words)
    a, b = variants.xor_inputs(torch, 4 * n_words, gen)
    got, dig = fused.xor_fold_checksum_cuda(a, b)
    want, wdig = fused.xor_fold_checksum_plain(a, b)
    assert torch.equal(got, want)
    assert int(dig.item()) & checksum.U32_MASK == wdig


@pytest.mark.gpu
@pytest.mark.parametrize("n_bytes,chunk_bytes",
                         [(4 * 4096 - 3, 4096), (5 * 4096, 4096),
                          (3 * 4100 + 1, 4100), (variants.XOR_CHUNK, 1 << 20)])
def test_cuda_delta_piece_matches_cpu(n_bytes, chunk_bytes):
    """A piece encoded on the card from pinned bytes gives the CPU's
    deltas and digests, chunk by chunk."""
    _cuda_or_skip()
    cur = torch.from_numpy(_bytes(n_bytes, 7)).pin_memory()
    prev = torch.from_numpy(_bytes(n_bytes, 8)).pin_memory()
    piece = chunk_bytes if chunk_bytes % 16 else 4 * chunk_bytes
    for lo in range(0, n_bytes, piece):
        hi = min(lo + piece, n_bytes)
        got = tcodecs.DeltaEncodePiece(cur[lo:hi], prev[lo:hi], chunk_bytes,
                                       True, "cuda").result()
        want = tcodecs.DeltaEncodePiece(cur[lo:hi], prev[lo:hi],
                                        chunk_bytes, True, "cpu").result()
        assert [(bytes(d), g) for d, g in got] == \
            [(bytes(d), g) for d, g in want]

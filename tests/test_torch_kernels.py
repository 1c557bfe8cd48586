"""The port's checkpoint kernels held against the JAX package.

* Plain PyTorch versions (what a CPU tensor dispatches to) are bit-exact
  against ``repro.kernels.ref`` over the dtype x odd-size corpus of
  ``tests/test_fused_kernels.py``, and against the Pallas kernels in
  interpret mode at one and two 65,536-word blocks.
* The dispatch never falls back: a CUDA-only path raises on this host, an
  unsupported device raises, and a launch counter moves only on a
  successful launch.
* ``gpu``-marked tests hold the CUDA kernels against their plain versions
  on a card; they skip inside the test on a host without one.
"""

import re

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, checksum, delta, fused, quantize
from repro_torch.kernels import ops as tops
from repro_torch.kernels import variants


def _bytes_case(nbytes: int, dtype, seed: int) -> np.ndarray:
    """The corpus generator of tests/test_fused_kernels.py."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.floating):
        arr = rng.standard_normal(-(-nbytes // np.dtype(dtype).itemsize)) \
            .astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, info.max,
                           -(-nbytes // np.dtype(dtype).itemsize),
                           dtype=dtype, endpoint=True)
    return arr.view(np.uint8)[:nbytes].copy()


BYTE_CASES = [
    (65_536, np.float32), (70_004, np.float32),
    (12_345, np.int8), (7, np.int8),
    (4096, np.uint16),
    (99_991, np.uint32), (4, np.uint32), (1, np.uint8),
]


def _u32(b: np.ndarray) -> np.ndarray:
    pad = (-b.size) % 4
    return np.concatenate([b, np.zeros(pad, np.uint8)]).view(np.uint32)


@pytest.mark.parametrize("nbytes,dtype", BYTE_CASES)
def test_plain_checksum_matches_reference(nbytes, dtype):
    b = _bytes_case(nbytes, dtype, seed=nbytes)
    want = jref.checksum_np_bytes(b)
    assert tops.host_checksum(b, "cpu") == want
    assert checksum.checksum_plain(
        checksum.as_words(torch.from_numpy(b))) == want
    assert want == int(jref.checksum_ref(_u32(b)))


@pytest.mark.parametrize("nbytes,dtype", BYTE_CASES)
def test_plain_xor_checksum_matches_reference(nbytes, dtype):
    cur = _bytes_case(nbytes, dtype, seed=1)
    prev = _bytes_case(nbytes, dtype, seed=2)
    d_ref, dig_ref = jref.fused_xor_checksum_ref(_u32(cur), _u32(prev))
    got, dig = tops.host_xor_checksum(cur, prev, "cpu")
    assert got.dtype == np.uint8 and got.size == nbytes
    np.testing.assert_array_equal(got, d_ref.view(np.uint8)[:nbytes])
    assert dig == dig_ref


@pytest.mark.parametrize("nbytes,dtype", BYTE_CASES)
def test_plain_delta_xor_matches_reference(nbytes, dtype):
    cur = _bytes_case(nbytes, dtype, seed=3)
    prev = _bytes_case(nbytes, dtype, seed=4)
    want = np.asarray(jref.delta_xor_ref(_u32(cur), _u32(prev)))
    np.testing.assert_array_equal(tops.host_delta_xor(cur, prev, "cpu"),
                                  want.view(np.uint8)[:nbytes])


@pytest.mark.parametrize("n_words", [65_536, 65_536 + 5])
def test_plain_versions_match_pallas_interpret(n_words):
    """One and two grid blocks of the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(n_words)
    cur = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    prev = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    c = checksum.as_words(torch.from_numpy(cur.view(np.uint8).copy()))
    p = checksum.as_words(torch.from_numpy(prev.view(np.uint8).copy()))
    assert tops.checksum(c) == int(jops.tensor_checksum(cur, interpret=True))
    d, dig = tops.xor_checksum(c, p)
    jd, jdig = jops.fused_xor_checksum(cur, prev, interpret=True)
    np.testing.assert_array_equal(d.numpy().view(np.uint32),
                                  np.asarray(jd)[:n_words])
    assert dig == int(jdig)
    x = tops.delta_xor(c, p)
    np.testing.assert_array_equal(
        x.numpy().view(np.uint32),
        np.asarray(jops.delta_xor(cur, prev, interpret=True))[:n_words])


@pytest.mark.parametrize("n_words,seg_words", [
    (1024, 1024), (16 * 1024, 1024), (16 * 1024 + 5, 1024), (1003, 1024),
    (0, 1024)])
def test_plain_checksum_segments_match_reference(n_words, seg_words):
    """One segment, 16, 17 with a short last one, fewer words than a
    segment, none: each digest is the reference's of that segment alone,
    through the plain version and the dispatch, into ``out`` too."""
    words = np.random.default_rng(n_words).integers(
        0, 2**32, n_words, dtype=np.uint32)
    want = [jref.checksum_np(words[lo:lo + seg_words])
            for lo in range(0, n_words, seg_words)]
    t = torch.from_numpy(words.view(np.int32))
    out = torch.empty(len(want), dtype=torch.int32)
    for got in (checksum.checksum_segments_plain(t, seg_words),
                tops.checksum_segments(t, seg_words),
                tops.checksum_segments(t, seg_words, out=out)):
        assert got.dtype == torch.int32
        assert got.numpy().view(np.uint32).tolist() == want
    assert tops.checksum_segments(t, seg_words, out=out) is out


def test_checksum_segments_refuse_what_the_kernel_cannot_take():
    w = torch.zeros(16, dtype=torch.int32)
    for seg in (0, 6, -4, 1 << 31):
        with pytest.raises(ValueError, match="multiple of 4"):
            tops.checksum_segments(w, seg)
        with pytest.raises(ValueError, match="multiple of 4"):
            checksum.checksum_segments_cuda(w, seg)
    with pytest.raises(ValueError, match="out must be"):
        tops.checksum_segments(w, 8, out=torch.empty(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        checksum.checksum_segments_cuda(w, 8)


def test_plain_checksum_masks_products_before_summing():
    """All-ones words at 2^20 positions: unmasked int64 products would
    overflow the sum; the masked sum must match the u64 oracle."""
    words = np.full(1 << 20, 0xFFFFFFFF, np.uint32)
    got = checksum.checksum_plain(torch.from_numpy(words.view(np.int32)))
    assert got == jref.checksum_np(words)


def test_host_delta_xor_pieces_cover_the_buffer(monkeypatch):
    """The piecewise fold (one loop on every device) agrees with the
    whole-buffer XOR across piece edges that cut mid-word."""
    monkeypatch.setattr(tops, "XOR_PIECE_BYTES", 12)
    pieces = []
    plain = tops.delta_xor
    monkeypatch.setattr(tops, "delta_xor",
                        lambda a, b: pieces.append(a.numel()) or plain(a, b))
    cur, prev = _bytes_case(101, np.int8, 5), _bytes_case(101, np.int8, 6)
    want = np.bitwise_xor(cur, prev)
    np.testing.assert_array_equal(tops.host_delta_xor(cur, prev, "cpu"),
                                  want)
    assert pieces == [3] * 8 + [2]   # 8 whole pieces, then 5 bytes


def test_lane_stream_is_a_no_op_on_the_cpu():
    with tops.lane_stream("cpu") as stream:
        assert stream is None
        assert tops.host_checksum(b"abcd", "cpu") == \
            jref.checksum_np_bytes(np.frombuffer(b"abcd", np.uint8))


def test_dispatch_refuses_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        tops.checksum(t)
    with pytest.raises(ValueError):
        tops.delta_xor(torch.zeros(4, dtype=torch.int32),
                       torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        checksum.checksum_cuda(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda"):
        delta.delta_xor_cuda(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4, dtype=torch.int32))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler: the build raises and names the problem — the kernels
    are never replaced by anything else."""
    monkeypatch.setattr(build.shutil, "which", lambda _n: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _p: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    assert build.library_path().name.startswith("libckpt_kernels_")


class _FakeLib:
    def __init__(self, rc):
        self.rc = rc

    def __getattr__(self, name):
        return lambda *args: self.rc


class _FakeStream:
    cuda_stream = 0


def test_launch_counter_moves_only_on_success(monkeypatch):
    kern = build.CudaKernel("ckpt_delta_xor")
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(build, "library", lambda: _FakeLib(0))
    kern.launch(0, 0, 0, 4)
    assert kern.launches == 1
    monkeypatch.setattr(build, "library", lambda: _FakeLib(700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kern.launch(0, 0, 0, 4)
    assert kern.launches == 1


def test_both_digest_entries_count_on_one_kernel(monkeypatch):
    """The one-chunk and the segmented entry launch the same kernel, so
    one count covers both."""
    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append(name) or 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(build, "library", Lib)
    before = checksum.KERNEL.launches
    checksum.KERNEL.launch(0, 4, 0)
    checksum.KERNEL.launch(0, 8, 4, 0, entry=checksum.SEGMENTS_ENTRY)
    assert called == ["ckpt_checksum_u32", "ckpt_checksum_u32_segments"]
    assert checksum.KERNEL.launches - before == 2


def test_build_flags_are_fixed():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-O3" in flags
    assert set(build.SIGNATURES) == {"ckpt_checksum_u32",
                                     "ckpt_checksum_u32_segments",
                                     "ckpt_xor_checksum_u32",
                                     "ckpt_xor_checksum_u32_segments",
                                     "ckpt_xor_fold_checksum_u32",
                                     "ckpt_delta_xor",
                                     "ckpt_delta_f32",
                                     "ckpt_quantize_checksum_int8",
                                     "ckpt_dequantize_checksum_int8",
                                     "ckpt_quantize_checksum_int8_segments",
                                     "ckpt_dequantize_checksum_int8_segments",
                                     "ckpt_quantize_int8",
                                     "ckpt_dequantize_int8",
                                     "ckpt_downcast_bf16",
                                     "ckpt_flash_attention_fwd"}
    src = "".join(s.read_text() for s in build.SOURCES)
    for sym in build.SIGNATURES:
        assert src.count(f'extern "C" int {sym}(') == 1


def test_library_hash_covers_every_file_under_csrc(monkeypatch, tmp_path):
    """A header beside the sources, an edit to any file, or another link
    flag names another library, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.SOURCES:
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path()
    (csrc / "shared.cuh").write_text("// device code shared by sources\n")
    with_header = build.library_path()
    (csrc / "shared.cuh").write_text("// edited\n")
    edited = build.library_path()
    monkeypatch.setattr(build, "LINK_FLAGS", build.LINK_FLAGS + ("-lcuda",))
    relinked = build.library_path()
    assert len({first, with_header, edited, relinked}) == 4
    assert build.ptxas_report(first).parent == first.parent


def _edge_words(device) -> torch.Tensor:
    """``quantize.EDGE_BITS`` (NaNs, signalling NaNs, subnormals, ties) as
    int32 words."""
    return quantize.edge_values(device).view(torch.int32)


def test_tile_words_match_the_streaming_core():
    """``delta.TILE_WORDS`` (the lengths the parity checks probe) is what
    one block of the shipped streaming core takes: 4 words a vector."""
    src = (build.CSRC / "ckpt_kernels.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        return int(m.group(1))
    assert delta.TILE_WORDS == 4 * const("kStreamVecs") \
        * const("kStreamThreads")
    assert "constexpr bool kStreamTma = false;" in src
    assert "constexpr int kStreamBlocksPerSm = 0;" in src


def test_stream_kernels_share_one_core():
    """``ckpt_delta_xor``, ``ckpt_downcast_bf16`` and ``ckpt_delta_f32``
    launch the one streaming template over their per-vector operations;
    the digest, the XOR digest and the int8 pair are one cluster launch a
    call, each cluster's block sums meeting in rank 0's shared memory
    through one shared fold, with no atomic and no zeroed word, and the
    one-chunk entries are their one-segment case; only the fused
    chain-replay decode keeps the grid-stride loop. The old digest, XOR
    digest, int8 and subtraction kernels are gone."""
    src = (build.CSRC / "ckpt_kernels.cu").read_text()
    assert "return launch_stream<XorOp>(a, b, out, n, stream);" in src
    assert "return launch_stream<Bf16Op>(x, nullptr, out, n, stream);" in src
    assert "return launch_stream<F32SubOp>(a, b, out, n, stream);" in src
    assert "xor_checksum_kernel<true><<<blocks_for(n)" in src
    assert "xor_checksum_kernel<false>" not in src
    fold = src[src.index("__device__ __forceinline__ void cluster_fold("):
               src.index("checksum_segments_kernel(const")]
    for part in ("cluster.map_shared_rank(", "cluster.sync();",
                 "cudaLaunchAttributeClusterDimension",
                 "cudaLaunchKernelEx(", "*out = sum;"):
        assert part in fold
    segmented = src[src.index("checksum_segments_kernel(const"):
                    src.index("}  // namespace")]
    assert not re.search(r"\batomic\w*\s*\(", fold + segmented)
    for kernel in ("checksum_segments_kernel(const",
                   "xor_checksum_segments_kernel(const",
                   "quantize_segments_kernel(const",
                   "dequantize_segments_kernel(const"):
        body = segmented[segmented.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert "cluster_arrive();" in body and "cluster_fold<" in body
    assert "return launch_checksum(x, n, n, 1, out, stream);" in src
    assert "return launch_xor(a, b, out, n, n, 1, part, stream);" in src
    assert "cudaMemset" not in segmented
    for entry, call in (("ckpt_quantize_checksum_int8(",
                         "launch_int8<true>(x, n_rows * kRowBytes, "
                         "row_start, 1, body, dig, 0,"),
                        ("ckpt_dequantize_checksum_int8(",
                         "launch_int8<false>(body, 0, row_start, 1, out, "
                         "dig, 0, stream);")):
        body = src[src.index(f'extern "C" int {entry}'):]
        assert call in body[:body.index("\n}\n")]
    for gone in ("checksum_kernel", "delta_f32_kernel",
                 "quantize_checksum_kernel", "dequantize_checksum_kernel"):
        assert not re.search(rf"\b{gone}\b", src)
    assert "__float2bfloat16_rn(" not in src  # NaN bits differ


@pytest.mark.parametrize("name", sorted(variants.STREAM_ABLATIONS))
def test_stream_ablations_apply_to_the_kernel_source(name):
    """Each variant of ``python -m repro_torch.kernels.variants stream``
    edits ``ckpt_kernels.cu`` (the tool never times the shipped core
    unchanged under another name); only ``stream`` is the shipped one."""
    src = (build.CSRC / variants.STREAM).read_text()
    out = variants.variant_source(variants.STREAM_ABLATIONS[name],
                                  variants.STREAM)
    assert (out == src) == (name == "stream")
    assert out.count('extern "C" int ckpt_delta_xor(') == 1
    with pytest.raises(ValueError, match="not in ckpt_kernels.cu"):
        variants.variant_source([["no such text", ""]], variants.STREAM)


@pytest.mark.parametrize("name", sorted(variants.CHECKSUM_ABLATIONS))
def test_checksum_ablations_apply_to_the_kernel_source(name):
    """Each variant of ``python -m repro_torch.kernels.variants checksum``
    edits ``ckpt_kernels.cu``; only ``checksum`` is the shipped digest, and
    both digest entries stay."""
    src = (build.CSRC / variants.STREAM).read_text()
    out = variants.variant_source(variants.CHECKSUM_ABLATIONS[name],
                                  variants.STREAM)
    assert (out == src) == (name == "checksum")
    assert out.count('extern "C" int ckpt_checksum_u32(') == 1
    assert out.count('extern "C" int ckpt_checksum_u32_segments(') == 1
    # a cluster past the portable 8 blocks is allowed before its launch
    helper = out[out.index("int launch_clusters("):]
    helper = helper[:helper.index("\n}\n")]
    assert "if (cluster > 8)" in helper
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in helper


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [
    1, 3, 4, 5, delta.TILE_WORDS - 1, delta.TILE_WORDS, delta.TILE_WORDS + 1,
    10 * delta.TILE_WORDS + delta.TILE_WORDS // 4 + 3, 65_537, 1 << 20])
def test_cuda_kernels_match_plain(n_words):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(n_words)
    a = torch.randint(-2**31, 2**31 - 1, (n_words,), dtype=torch.int32,
                      device="cuda", generator=g)
    b = torch.randint(-2**31, 2**31 - 1, (n_words,), dtype=torch.int32,
                      device="cuda", generator=g)
    edge = _edge_words("cuda")
    k = min(n_words, edge.numel())
    a[:k], b[:k] = edge[:k], edge.roll(5)[:k]
    assert tops.checksum(a) == checksum.checksum_plain(a)
    d, dig = tops.xor_checksum(a, b)
    dp, digp = fused.xor_checksum_plain(a, b)
    assert torch.equal(d, dp) and dig == digp
    assert torch.equal(tops.delta_xor(a, b), delta.delta_xor_plain(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [delta.TILE_WORDS + 1, 65_537])
def test_cuda_delta_xor_matches_plain_at_a_4_byte_offset(n_words):
    """Words sliced at a 4-byte offset: the wrapper clones them to 16-byte
    alignment before the launch."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(n_words)
    a, b = (torch.randint(-2**31, 2**31 - 1, (n_words + 1,),
                          dtype=torch.int32, device="cuda", generator=g)[1:]
            for _ in range(2))
    assert a.data_ptr() % 16 != 0
    assert torch.equal(tops.delta_xor(a, b), delta.delta_xor_plain(a, b))


@pytest.mark.gpu
def test_lane_stream_leaves_the_callers_stream():
    """A lane's kernels run on a stream of their own, not the stream the
    training step computes on, and give the same answers there."""
    _cuda_or_skip()
    caller = torch.cuda.current_stream()
    cur = _bytes_case(70_003, np.float32, 9)
    with tops.lane_stream("cuda") as stream:
        assert torch.cuda.current_stream() == stream != caller
        assert tops.host_checksum(cur, "cuda") == jref.checksum_np_bytes(cur)
    assert torch.cuda.current_stream() == caller


@pytest.mark.gpu
def test_cuda_host_paths_match_reference():
    _cuda_or_skip()
    cur = _bytes_case(70_003, np.float32, 7)
    prev = _bytes_case(70_003, np.float32, 8)
    assert tops.host_checksum(cur, "cuda") == jref.checksum_np_bytes(cur)
    got, dig = tops.host_xor_checksum(cur, prev, "cuda")
    d_ref, dig_ref = jref.fused_xor_checksum_ref(_u32(cur), _u32(prev))
    np.testing.assert_array_equal(got, d_ref.view(np.uint8)[:cur.size])
    assert dig == dig_ref
    np.testing.assert_array_equal(tops.host_delta_xor(cur, prev, "cuda"),
                                  np.bitwise_xor(cur, prev))


def _words(n: int, seed: int) -> torch.Tensor:
    """Seeded int32 words on the card with the edge words in front."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                      device="cuda", generator=g)
    edge = _edge_words("cuda")
    k = min(n, edge.numel())
    w[:k] = edge[:k]
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("n_words,seg_words", variants.CHECKSUM_CASES)
def test_cuda_checksum_segments_match_plain(n_words, seg_words):
    """Segments around a block's tile and a cluster's trip, short last
    segments, trailing words, no words, and the 64 MiB piece."""
    _cuda_or_skip()
    w = _words(n_words, n_words)
    before = checksum.KERNEL.launches
    got = tops.checksum_segments(w, seg_words)
    assert checksum.KERNEL.launches - before == (1 if n_words else 0)
    assert torch.equal(got, checksum.checksum_segments_plain(w, seg_words))


@pytest.mark.gpu
def test_cuda_checksum_writes_its_word_whole():
    """Twice into the same ``out``: the same digest, so nothing is added
    into it; no words write 0 over what was there."""
    _cuda_or_skip()
    w = _words(1 << 20, 3)
    out = torch.full((1,), 12345, dtype=torch.int32, device="cuda")
    first = int(checksum.checksum_cuda(w, out).item())
    assert int(checksum.checksum_cuda(w, out).item()) == first
    assert first & checksum.U32_MASK == checksum.checksum_plain(w)
    empty = torch.empty(0, dtype=torch.int32, device="cuda")
    assert int(checksum.checksum_cuda(empty, out).item()) == 0


@pytest.mark.gpu
def test_cuda_checksum_on_two_lane_streams_at_once():
    """Two lanes digesting different pieces at the same time, each on its
    own stream: both come out right (the kernel keeps no state in device
    memory between launches)."""
    import threading
    _cuda_or_skip()
    pieces = [_words(16 << 20, seed) for seed in (5, 6)]
    want = [checksum.checksum_segments_plain(p, 1 << 20) for p in pieces]
    torch.cuda.synchronize()
    got = [[], []]

    def lane(i):
        with tops.lane_stream("cuda") as stream:
            for _ in range(20):
                got[i].append(tops.checksum_segments(pieces[i], 1 << 20))
            stream.synchronize()
    threads = [threading.Thread(target=lane, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 1):
        assert len(got[i]) == 20
        assert all(torch.equal(d, want[i]) for d in got[i])

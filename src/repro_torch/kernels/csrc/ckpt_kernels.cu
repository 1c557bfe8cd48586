// Checkpoint integrity and differential-encoding kernels for Hopper (sm_90a).
//
// Ten kernels, one plain C interface (loaded with ctypes by
// repro_torch/kernels/build.py):
//
//   kernel (replaces the function of the same name in repro/kernels/...)
//   checksum_u32              checksum.py
//   xor_checksum_u32          fused.py
//   xor_fold_checksum_u32     fused.py
//   delta_xor                 delta.py
//   quantize_checksum_int8    fused.py
//   dequantize_checksum_int8  fused.py
//   quantize_int8             quantize.py
//   dequantize_int8           quantize.py
//   downcast_bf16             quantize.py
//   delta_f32                 delta.py
//
// The int8 row math, the offline reduction's kernels, the streaming core
// (delta_xor, downcast_bf16 and delta_f32), the segmented digest
// (checksum_u32), the segmented XOR digest (xor_checksum_u32) and the
// segmented int8 pair have their own notes further down; what follows is
// about the digest itself and the fused chain-replay decode.
//
// The digest is the position-weighted sum
//     sum_i x[i] * (65599 + i mod 65521)   mod 2^32
// over the little-endian u32 words of a buffer. The Pallas kernels walk the
// input in sequential 65,536-word grid steps and carry the sum in one SMEM
// word; here blocks run in parallel and in no order, so each thread keeps a
// private u32 partial (wrap-around multiply-add is exact mod 2^32) and the
// block reduces it with warp shuffles and shared memory. Addition mod 2^32
// is associative and commutative, so the result is bit-exact in any block
// order. Zero words add nothing, so no padding to 65,536 words is needed:
// the wrapper only zero-pads the byte tail to a whole word.
//
// Bound on the card: every kernel here does a handful of integer
// operations per word and is limited by device memory: the least time is
// the bytes moved over 3.35 TB/s (the H100 SXM data sheet's HBM3 rate),
// 4N bytes for checksum_u32 and 12N bytes (two inputs read, one output
// written) for the two fused XOR kernels, N in words. At the main path's
// 4 MiB chunk the device work is a few microseconds, and what a call cost
// was on the host and around the kernel (a fill kernel to zero the output
// word, a blocking upload, a stream sync per chunk, one launch per chunk).
// So the digest, the delta-route encode (xor_checksum_u32) and the int8
// pair each take many chunks in one launch, each chunk (a segment) reduced
// inside thread-block clusters that write their sums with plain stores (no
// zeroed word, no atomic, one device function for all: cluster_fold), and
// their callers feed them pieces from pinned memory while they prepare the
// next piece (storage/manifest.py reads it from disk, the delta and the
// quantized providers stage it, the reader decompresses it). Only the
// fused chain-replay decode (xor_fold_checksum_u32, which no path
// launches) still runs a grid-stride loop capped at 132 x 8 blocks that
// folds each block's sum into a zeroed word with one atomicAdd.
//
// Where the data lives: the checkpoint path stages device state into pinned
// host memory first, and these kernels are fed that host-staged data (the
// caller copies host to device, launches, and copies back only the
// outputs, all enqueued without a wait). For the XOR encode that round
// trip over PCIe is about 3x the piece; moving the encode ahead of the
// device-to-host copy is a later change.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns the launch's error or cudaGetLastError(), so a refused
// launch is reported.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kWeightBase = 65599u;
constexpr uint32_t kWeightMod = 65521u;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint32_t next_r(uint32_t r) {
  r += 1u;
  return r == kWeightMod ? 0u : r;
}

// Weighted sum of the four words of v, whose first word's weight is
// kWeightBase + r.
__device__ __forceinline__ uint32_t weigh4_r(uint4 v, uint32_t r) {
  uint32_t s = v.x * (kWeightBase + r);
  r = next_r(r);
  s += v.y * (kWeightBase + r);
  r = next_r(r);
  s += v.z * (kWeightBase + r);
  r = next_r(r);
  s += v.w * (kWeightBase + r);
  return s;
}

// The same, with the first word at index i.
__device__ __forceinline__ uint32_t weigh4(uint4 v, int64_t i) {
  return weigh4_r(v, static_cast<uint32_t>(i % kWeightMod));
}

__device__ __forceinline__ uint32_t weigh1(uint32_t x, int64_t i) {
  return x * (kWeightBase + static_cast<uint32_t>(i % kWeightMod));
}

// The same at a 32-bit position: a 32-bit modulo by a constant (a
// multiply-high), not weigh1's 64-bit one.
__device__ __forceinline__ uint32_t weigh_at(uint32_t x, uint32_t i) {
  return x * (kWeightBase + i % kWeightMod);
}

// Block-wide sum of one u32 per thread of a kBlock-thread block; the sum
// is valid in thread 0.
template <int kBlock>
__device__ __forceinline__ uint32_t block_sum(uint32_t acc) {
  __shared__ uint32_t warp_sums[kBlock / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (kBlock / 32) ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// Block-wide sum of one u32 per thread, added to *out by one atomic.
__device__ __forceinline__ void block_fold(uint32_t acc, uint32_t* out) {
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0 && acc != 0u) atomicAdd(out, acc);
}

// out = a ^ b with the digest of the words of b, kDigestB (the fused
// chain-replay decode: base ^ delta, verifying the stored delta as it is
// applied), or of the words written (the delta-route encode as it was
// before the segmented XOR digest below; the variants tool's atomic_loop
// puts it back).
template <bool kDigestB>
__global__ void __launch_bounds__(kThreads)
xor_checksum_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, int64_t n,
                    uint32_t* __restrict__ dig) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b);
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out);
  uint32_t acc = 0u;
  for (int64_t j = tid; j < n4; j += stride) {
    const uint4 u = a4[j];
    const uint4 v = b4[j];
    const uint4 d = make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
    o4[j] = d;
    acc += weigh4(kDigestB ? v : d, j << 2);
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride) {
    const uint32_t d = a[i] ^ b[i];
    out[i] = d;
    acc += weigh1(kDigestB ? b[i] : d, i);
  }
  block_fold(acc, dig);
}

int blocks_for(int64_t n) {
  int64_t want = ((n >> 2) + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

// ------------------------------------------------------------------ int8q
// The row math of the int8 kernels: the segmented int8 pair below
// (quantize_checksum_int8, dequantize_checksum_int8) and the offline
// reduction's quantize_int8 and dequantize_int8.
//
// Rows of 256 fp32 values, each with a symmetric scale:
//     scale = amax > 0 ? amax / 127 : 1,  q = clip(rint(x / scale), +-127).
//
// Bit-exactness with jnp.round(x / scale) rests on IEEE division (the
// library is built without --use_fast_math, so `/` is correctly rounded)
// and round-half-to-even (rintf). The amax is a max of absolute values,
// exact in any order (a NaN wins, as in XLA's max). The reference computes with subnormals flushed (XLA
// on the CPU, and the TPU), so the quantizer does so explicitly: subnormal
// inputs read as zero, a scale that would be subnormal is zero (the row's
// nonzero values then store +-127), and a 0/0 quotient stores 0, as XLA's
// NaN-to-int conversion does. Dequantize is one rounded product per value.
//
// One warp handles one row: each lane holds two float4 (the row's
// elements 4l..4l+3 and 128+4l..128+4l+3, so both loads of the warp are
// contiguous 512-byte runs), the amax is a five-step __shfl_xor_sync max,
// and each lane stores its two packed q words as coalesced u32 stores.

constexpr int kRowElems = 256;
constexpr int kRowWords = kRowElems / 4;   // packed q words per row
constexpr int64_t kPayloadHeaderWords = 2;
constexpr int kWarpsPerBlock = kThreads / 32;

constexpr float kFltMin = 1.17549435e-38f;  // 2^-126, least normal float

// Subnormals read as zero (see the note above).
__device__ __forceinline__ float daz(float v) {
  return fabsf(v) < kFltMin ? 0.0f : v;
}

__device__ __forceinline__ uint32_t quant1(float v, float scale) {
  const float t = daz(v) / scale;
  if (t != t) return 0u;  // 0 / 0 in a row whose scale flushed to zero
  const float r = fminf(fmaxf(rintf(t), -127.0f), 127.0f);
  return static_cast<uint32_t>(
      static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))));
}

__device__ __forceinline__ uint32_t quant4(float4 v, float scale) {
  return quant1(v.x, scale) | (quant1(v.y, scale) << 8) |
         (quant1(v.z, scale) << 16) | (quant1(v.w, scale) << 24);
}

__device__ __forceinline__ float dequant1(uint32_t w, int lane, float scale) {
  const int8_t q = static_cast<int8_t>((w >> (8 * lane)) & 0xffu);
  return static_cast<float>(q) * scale;
}

__device__ __forceinline__ float4 dequant4(uint32_t w, float scale) {
  return make_float4(dequant1(w, 0, scale), dequant1(w, 1, scale),
                     dequant1(w, 2, scale), dequant1(w, 3, scale));
}

// The larger of a and b, or a NaN if either is one, as XLA's max: a NaN
// in a row gives it scale 1.0 (amax > 0 fails), and the NaN stores 0.
// fmaxf would drop the NaN instead.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nan_max(nan_max(fabsf(daz(v.x)), fabsf(daz(v.y))),
                 nan_max(fabsf(daz(v.z)), fabsf(daz(v.w))));
}

__device__ __forceinline__ float row_scale(float amax) {
  if (!(amax > 0.0f)) return 1.0f;
  const float s = amax / 127.0f;
  return s < kFltMin ? 0.0f : s;
}

// One warp quantizes one row from the two float4 this lane holds: its
// two packed q words and the row's scale. Every int8 encode calls it (the
// segmented kernel after loading several rows, quantize_int8 through
// quantize_row), so they cannot drift apart.
__device__ __forceinline__ float quantize_vals(float4 a, float4 b,
                                               uint32_t* wa, uint32_t* wb) {
  float m = nan_max(absmax4(a), absmax4(b));
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = row_scale(m);
  *wa = quant4(a, scale);
  *wb = quant4(b, scale);
  return scale;
}

// quantize_vals of row `row` of x, loaded by this lane.
__device__ __forceinline__ float quantize_row(const float* __restrict__ x,
                                              int64_t row, int lane,
                                              uint32_t* wa, uint32_t* wb) {
  const float4* xr = reinterpret_cast<const float4*>(x + row * kRowElems);
  return quantize_vals(xr[lane], xr[32 + lane], wa, wb);
}

int row_blocks_for(int64_t n_rows) {
  int64_t want = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (want < 1) want = 1;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

// --------------------------------------------------- offline reduction
// quantize_int8    replaces repro/kernels/quantize.py:quantize_int8
// dequantize_int8  replaces repro/kernels/quantize.py:dequantize_int8
// downcast_bf16    replaces repro/kernels/quantize.py:downcast_bf16
// delta_f32        replaces repro/kernels/delta.py:delta_f32
//
// The offline reducer's encode (core/reduction.py) quantizes 2-D fp32
// leaves to bf16 or to int8 rows, one launch per leaf. quantize_int8 is
// the fused encode's row math (quantize_row) writing q (R, 256) and the
// scales (R, 1) as two arrays, with no digest. What the reference computes
// at the edges, pinned by its Pallas kernels on the CPU:
//
// * downcast_bf16 rounds to nearest even in integer arithmetic and keeps
//   subnormals (fp32 1e-40 -> 0x0001). Every NaN becomes its sign bit OR
//   0x7fc0 (the signalling 0x7f800001 too). __float2bfloat16_rn would give
//   0x7fff for a NaN, so the kernel does not use it.
// * dequantize_int8 and delta_f32 compute with subnormals flushed to a
//   zero of the same sign, on the inputs and on the result, as XLA does on
//   the CPU and the TPU: -1 * 1e-38 gives -0.0, and 1.2e-38 - 1.5e-38
//   gives -0.0. The library is built without -ftz, so the flush is
//   explicit: a compare and a select per value. NaN and inf pass through
//   IEEE arithmetic unchanged in kind; the bits of a NaN the card makes are
//   its own (0x7fffffff), as they are for PyTorch's ops on the card.
//
// Bound on the card: a few operations a value, so device memory bounds all
// four: 6 bytes a value for the downcast (4 in, 2 out), (1024 + 4 + 256)
// bytes a row for the int8 pair, 12 bytes a value for delta_f32. The int8
// pair runs one warp a row in a grid-stride loop; the downcast and
// delta_f32 run on the streaming core below.

__device__ __forceinline__ uint32_t bf16_bits(uint32_t u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) return ((u >> 16) & 0x8000u) | 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x, int64_t n_rows,
                     uint32_t* __restrict__ qw, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = warp; row < n_rows; row += n_warps) {
    uint32_t wa, wb;
    const float scale = quantize_row(x, row, lane, &wa, &wb);
    qw[row * kRowWords + lane] = wa;
    qw[row * kRowWords + 32 + lane] = wb;
    if (lane == 0) scales[row] = scale;
  }
}

// A subnormal becomes a zero of its own sign; everything else is kept.
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float4 dequant4_flushed(uint32_t w, float scale) {
  return make_float4(flush(dequant1(w, 0, scale)),
                     flush(dequant1(w, 1, scale)),
                     flush(dequant1(w, 2, scale)),
                     flush(dequant1(w, 3, scale)));
}

__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const uint32_t* __restrict__ qw,
                       const float* __restrict__ scales, int64_t n_rows,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = warp; row < n_rows; row += n_warps) {
    const float scale = flush(scales[row]);
    const int64_t q0 = row * kRowWords;
    float4* orow = reinterpret_cast<float4*>(out + row * kRowElems);
    orow[lane] = dequant4_flushed(qw[q0 + lane], scale);
    orow[32 + lane] = dequant4_flushed(qw[q0 + 32 + lane], scale);
  }
}

__device__ __forceinline__ float sub_flushed(float a, float b) {
  return flush(flush(a) - flush(b));
}

// ------------------------------------------------------- streaming core
// delta_xor      replaces repro/kernels/delta.py:delta_xor
// downcast_bf16  replaces repro/kernels/quantize.py:downcast_bf16
// delta_f32      replaces repro/kernels/delta.py:delta_f32
//
// All three are pure streams: read 16-byte vectors, do a few operations
// on each, write. One template serves them, over the per-vector operation
// (XorOp, Bf16Op, F32SubOp below).
//
// Bound on the card: the bytes moved over 3.35 TB/s, 12 bytes a word for
// the XOR and the subtraction (two words in, one out) and 6 a value for
// the downcast (4 in, 2 out). What stood between the earlier grid-stride
// loop and that bound, and what this design does about it:
//
// * Bytes in flight. The loop issued one 16-byte load per thread, then
//   waited, computed and stored before it issued the next. Here each
//   thread issues kStreamVecs (2) independent loads per input before any
//   compute or store: 32 or 64 bytes a thread, 64 or 128 KiB an SM at
//   full occupancy. 2 to 8 loads a thread, at 256 or 512 threads a
//   block, run within about 2 % of one another, and which is fastest
//   changes from run to run; one load a thread is slower.
// * The walk through memory. A grid capped at 132 x 8 blocks walked the
//   downcast's 1 GB in about 243 trips, and the blocks drifted apart over
//   them, so the addresses in flight spread over the whole buffer. Here
//   the grid covers n in one pass, one block per tile of kStreamThreads *
//   kStreamVecs vectors (kStreamBlocksPerSm = 0), handed to SMs in
//   order as they free up: what is in flight stays one window of the
//   buffer, and only the last tile can be partial. A grid-stride loop over
//   132 x 4 blocks of this kernel is as slow for the downcast as the old
//   loop.
// * Caches. Every byte is touched once, so the loads bypass L1
//   (ld.global.nc.L1::no_allocate) and the stores are marked streaming
//   (st.global.cs, evict first), to keep the outputs from crowding the
//   50 MB L2 (kStreamHints). For the XOR the pair beats plain loads and
//   stores by about 1 %, except right after a large kernel that wrote
//   with plain stores (x.to(torch.bfloat16) of 0.5 GB), where it runs
//   about 2 % slower than plain; non-coherent loads with plain stores are
//   the slowest of all. The downcast does not move with the hints.
// * Index arithmetic: one 64-bit tile base per block, 32-bit offsets
//   inside the tile.
//
// Both kernels then run at the library's share of the bound (about 0.9
// for the XOR, 0.93 for the downcast, on an H100 SXM at 700 W): what is
// left is the card's own limit for a stream with one write to two reads,
// and for the XOR the start and end of a 0.07 ms launch. PERF.md has the
// numbers (python -m repro_torch.kernels.variants stream).
//
// Design (B), kept as a variant behind kStreamTma: persistent blocks
// stream tiles of kTmaTileVecs vectors through a kTmaStages ring in shared
// memory with 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx),
// convert in shared memory, and write each tile back with a bulk store
// (cp.async.bulk.global.shared::cta, bulk_group), waiting with
// wait_group.read before an output stage is reused. Bulk copies take
// 16-byte aligned addresses and sizes, so whole tiles go through them and
// the rest of the buffer through plain loads. It is bit-identical, and
// slower than (A) in every run, most for the downcast.
//
// Any n works: the last, partial tile checks each vector against n / 4,
// and block 0 writes the n mod 4 trailing words one at a time. Inputs and
// outputs are 16-byte aligned (the wrappers see to it) and must not alias.
// The downcast's bits are bf16_bits above, the same integer rounding as
// the plain version; nothing here converts through float. The subtraction
// is sub_flushed above, the reduction section's flush on its inputs and
// its result, so its flush bits are those of the int8 dequantize.

constexpr int kSms = 132;
constexpr int kStreamThreads = 512;
// 16-byte loads each thread issues per input before it computes
constexpr int kStreamVecs = 2;
// 0 plain loads and stores; 1 ld.global.nc.L1::no_allocate and
// st.global.cs; 2 ld.global.cs and st.global.cs; 3 as 1 with an L2::256B
// prefetch hint on the loads
constexpr int kStreamHints = 1;
// 0: one block a tile, one pass; k > 0: a grid-stride loop over at most
// 132 * k blocks
constexpr int kStreamBlocksPerSm = 0;
// design (B): bulk copies through a ring in shared memory
constexpr bool kStreamTma = false;
constexpr int kTmaStages = 4;
constexpr int kTmaTileVecs = 512;

struct XorOp {
  static constexpr int kInputs = 2;
  using Vec = uint4;      // what one 16-byte vector of each input gives
  using Word = uint32_t;  // what one word of each input gives
  __device__ static uint4 vec(uint4 a, uint4 b) {
    return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
  __device__ static uint32_t word(uint32_t a, uint32_t b) { return a ^ b; }
};

struct Bf16Op {
  static constexpr int kInputs = 1;
  using Vec = uint2;
  using Word = uint16_t;
  __device__ static uint2 vec(uint4 v, uint4) {
    return make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                      bf16_bits(v.z) | (bf16_bits(v.w) << 16));
  }
  __device__ static uint16_t word(uint32_t u, uint32_t) {
    return static_cast<uint16_t>(bf16_bits(u));
  }
};

struct F32SubOp {
  static constexpr int kInputs = 2;
  using Vec = uint4;      // the bits of four fp32 results
  using Word = uint32_t;
  __device__ static uint32_t word(uint32_t a, uint32_t b) {
    return __float_as_uint(
        sub_flushed(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint4 vec(uint4 a, uint4 b) {
    return make_uint4(word(a.x, b.x), word(a.y, b.y), word(a.z, b.z),
                      word(a.w, b.w));
  }
};

template <int kHints>
__device__ __forceinline__ uint4 stream_load(const uint4* p) {
  uint4 v;
  if constexpr (kHints == 1) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  } else if constexpr (kHints == 2) {
    v = __ldcs(p);
  } else if constexpr (kHints == 3) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  } else {
    v = *p;
  }
  return v;
}

template <int kHints, class V>
__device__ __forceinline__ void stream_store(V* p, V v) {
  if constexpr (kHints == 0) {
    *p = v;
  } else {
    __stcs(p, v);
  }
}

// The n mod 4 words after the last whole vector, by block 0.
template <class Op>
__device__ __forceinline__ void stream_words(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             typename Op::Word* __restrict__ out,
                                             int64_t n) {
  const int64_t i = (n & ~int64_t{3}) + threadIdx.x;
  if (blockIdx.x == 0 && i < n)
    out[i] = Op::word(a[i], Op::kInputs == 2 ? b[i] : 0u);
}

template <class Op, int kVecs, int kHints>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              typename Op::Word* __restrict__ out, int64_t n) {
  using Vec = typename Op::Vec;
  constexpr int kTile = kStreamThreads * kVecs;
  const int64_t n_vec = n >> 2;
  const int64_t n_tiles = (n_vec + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t base = t * kTile;
    const uint4* __restrict__ pa = reinterpret_cast<const uint4*>(a) + base;
    const uint4* __restrict__ pb =
        reinterpret_cast<const uint4*>(Op::kInputs == 2 ? b : a) + base;
    Vec* __restrict__ po = reinterpret_cast<Vec*>(out) + base;
    const int left = n_vec - base < kTile ? static_cast<int>(n_vec - base)
                                          : kTile;
    if (left == kTile) {
      uint4 va[kVecs], vb[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = u * kStreamThreads + threadIdx.x;
        va[u] = stream_load<kHints>(pa + i);
        if constexpr (Op::kInputs == 2) vb[u] = stream_load<kHints>(pb + i);
      }
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = u * kStreamThreads + threadIdx.x;
        if constexpr (Op::kInputs == 2) {
          stream_store<kHints>(po + i, Op::vec(va[u], vb[u]));
        } else {
          stream_store<kHints>(po + i, Op::vec(va[u], va[u]));
        }
      }
    } else {
      for (int i = threadIdx.x; i < left; i += kStreamThreads) {
        const uint4 x = stream_load<kHints>(pa + i);
        const uint4 y = Op::kInputs == 2 ? stream_load<kHints>(pb + i) : x;
        stream_store<kHints>(po + i, Op::vec(x, y));
      }
    }
  }
  stream_words<Op>(a, b, out, n);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <class Op>
constexpr int tma_smem_bytes() {
  return kTmaStages * (Op::kInputs * kTmaTileVecs * 16 +
                       kTmaTileVecs * static_cast<int>(sizeof(typename Op::Vec))) +
         kTmaStages * 8;
}

template <class Op>
__global__ void __launch_bounds__(kStreamThreads)
stream_tma_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b,
                  typename Op::Word* __restrict__ out, int64_t n) {
  using Vec = typename Op::Vec;
  constexpr uint32_t kIn = kTmaTileVecs * 16;
  constexpr uint32_t kOut = kTmaTileVecs * sizeof(Vec);
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_in = smem;                                    // [stage][input]
  uint8_t* s_out = smem + kTmaStages * Op::kInputs * kIn;  // [stage]
  const uint32_t full = smem_u32(s_out + kTmaStages * kOut);
  const int64_t n_vec = n >> 2;
  const int64_t n_full = n_vec / kTmaTileVecs;
  const int64_t mine = n_full > blockIdx.x
                           ? (n_full - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  const uint8_t* ga = reinterpret_cast<const uint8_t*>(a);
  const uint8_t* gb = reinterpret_cast<const uint8_t*>(b);
  uint8_t* go = reinterpret_cast<uint8_t*>(out);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0: the i-th tile of this block into stage i mod kTmaStages.
  auto issue = [&](int64_t i) {
    const int s = static_cast<int>(i % kTmaStages);
    const int64_t off = (blockIdx.x + i * gridDim.x) * kIn;
    const uint32_t bar = full + 8 * s;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(Op::kInputs * kIn)
        : "memory");
    for (int k = 0; k < Op::kInputs; ++k)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              smem_u32(s_in + (s * Op::kInputs + k) * kIn)),
          "l"((k == 0 ? ga : gb) + off), "r"(kIn), "r"(bar)
          : "memory");
  };
  if (threadIdx.x == 0)
    for (int64_t i = 0; i < kTmaStages && i < mine; ++i) issue(i);

  for (int64_t i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kTmaStages);
    mbar_wait(full + 8 * s, static_cast<uint32_t>((i / kTmaStages) & 1));
    const uint4* in_a = reinterpret_cast<const uint4*>(
        s_in + s * Op::kInputs * kIn);
    const uint4* in_b = in_a + (Op::kInputs - 1) * kTmaTileVecs;
    Vec* o = reinterpret_cast<Vec*>(s_out + s * kOut);
#pragma unroll
    for (int u = 0; u < kTmaTileVecs / kStreamThreads; ++u) {
      const int j = u * kStreamThreads + threadIdx.x;
      o[j] = Op::vec(in_a[j], in_b[j]);
    }
    // the writes above, seen by the bulk store's (async) proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile i + 1 writes the output stage of tile i + 1 - kTmaStages: at
    // most kTmaStages - 2 stores may still be reading shared memory
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kTmaStages - 2)
                   : "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              go + (blockIdx.x + i * gridDim.x) * kOut),
          "r"(smem_u32(o)), "r"(kOut)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i + kTmaStages < mine) issue(i + kTmaStages);
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // what no whole tile covers, through plain loads
  if (blockIdx.x == 0) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    Vec* o4 = reinterpret_cast<Vec*>(out);
    for (int64_t j = n_full * kTmaTileVecs + threadIdx.x; j < n_vec;
         j += kStreamThreads)
      o4[j] = Op::vec(a4[j], Op::kInputs == 2 ? b4[j] : a4[j]);
  }
  stream_words<Op>(a, b, out, n);
}

template <class Op>
int launch_stream(const void* a, const void* b, void* out, int64_t n,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* wa = static_cast<const uint32_t*>(a);
  const uint32_t* wb = static_cast<const uint32_t*>(b);
  auto* wo = static_cast<typename Op::Word*>(out);
  if constexpr (kStreamTma) {
    constexpr int smem = tma_smem_bytes<Op>();
    const cudaError_t rc = cudaFuncSetAttribute(
        stream_tma_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    // blocks an SM holds: 228 KiB less 1 KiB reserved a block, at most 8
    const int per_sm = (228 * 1024) / (smem + 1024) < 8
                           ? (228 * 1024) / (smem + 1024)
                           : 8;
    const int64_t n_full = (n >> 2) / kTmaTileVecs;
    const int64_t cap = int64_t{kSms} * (per_sm < 1 ? 1 : per_sm);
    const int64_t grid = n_full < 1 ? 1 : (n_full < cap ? n_full : cap);
    stream_tma_kernel<Op><<<static_cast<int>(grid), kStreamThreads, smem,
                            st>>>(wa, wb, wo, n);
  } else {
    constexpr int64_t kTile = int64_t{kStreamThreads} * kStreamVecs;
    int64_t grid = ((n >> 2) + kTile - 1) / kTile;
    if (kStreamBlocksPerSm > 0 && grid > int64_t{kSms} * kStreamBlocksPerSm)
      grid = int64_t{kSms} * kStreamBlocksPerSm;
    if (grid < 1) grid = 1;
    stream_kernel<Op, kStreamVecs, kStreamHints>
        <<<static_cast<int>(grid), kStreamThreads, 0, st>>>(wa, wb, wo, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ segmented digest
// checksum_u32  replaces repro/kernels/checksum.py:checksum_u32
//
// One launch digests the consecutive seg_words-word segments of a buffer
// (the last may be short) and writes one u32 per segment: the digest of
// that segment alone, its position weights restarting at 0, as
// storage/manifest.py's file_checksum digests each 4 MiB chunk of a file.
// One buffer's digest is the one-segment case.
//
// Bound on the card: 4 bytes a word over 3.35 TB/s, 0.0200 ms for a
// 64 MiB piece of 16 chunks. What the design does about it:
//
// * One cluster of kSumCluster blocks a segment, a grid of n_segs
//   clusters: 16 chunks at 8 blocks put one block on 128 of the 132 SMs
//   in one launch. Each block walks its share of the segment in tiles of
//   kSumThreads x kSumVecs vectors, issuing all kSumVecs 16-byte loads of
//   a tile (ld.global.nc.L1::no_allocate, as the streaming core) before
//   it adds. Clusters of 16 (the non-portable size) run one 4 MiB chunk
//   faster, on 16 SMs, but a 64 MiB piece 8 % slower: 256 blocks do not
//   spread evenly over 132 SMs (python -m repro_torch.kernels.variants
//   checksum; PERF.md).
// * No atomics, no zeroed output, no global scratch. Each block reduces
//   its sum with warp shuffles (block_sum), writes it into rank 0's shared
//   memory (distributed shared memory, map_shared_rank), and after a
//   cluster barrier rank 0 adds the kSumCluster sums and stores out[seg]
//   with a plain store (cluster_fold, which the int8 pair shares). The
//   flush lanes and the restore call the kernel at once on streams of
//   their own, so scratch in device memory, or a ticket counter for a
//   last-block reduction, would race between them.
// * Word positions are 32-bit inside a segment (seg_words < 2^31), so the
//   weight needs a 32-bit modulo by a constant (a multiply-high), not the
//   64-bit modulo of the fused kernels' weigh4.
//
// Cluster barriers: every thread arrives (relaxed) on entry and waits
// just before its block writes into rank 0's shared memory, so rank 0 has
// started by then; the cluster.sync() after the writes keeps rank 0 from
// reading, and every block from exiting, before all sums are in.

constexpr int kSumThreads = 512;
// 16-byte loads each thread issues per tile before it adds
constexpr int kSumVecs = 4;
// blocks a segment: 8 is the largest portable cluster (the variants
// tool's cluster16 also allows the non-portable size before launching)
constexpr int kSumCluster = 8;
constexpr int64_t kMaxSegWords = int64_t{1} << 31;

// Every thread of a cluster arrives (relaxed) on entry: the wait in
// cluster_fold then knows rank 0 has started before any block writes into
// its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The sum of one u32 per thread over a cluster of kCluster blocks of
// kBlock threads, stored by rank 0's thread 0 into *out with a plain
// store. Each block reduces its sum (block_sum) and writes it into rank
// 0's shared memory (map_shared_rank); the cluster.sync() after the writes
// keeps rank 0 from reading, and every block from exiting, before all
// sums are in. Every thread calls it, once, after cluster_arrive().
template <int kBlock, int kCluster>
__device__ __forceinline__ void cluster_fold(uint32_t acc, uint32_t* out) {
  namespace cg = cooperative_groups;
  __shared__ uint32_t cluster_sums[kCluster];
  acc = block_sum<kBlock>(acc);
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) cluster.map_shared_rank(cluster_sums, 0)[rank] = acc;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    uint32_t sum = 0u;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) sum += cluster_sums[k];
    *out = sum;
  }
}

// n_segs clusters of `cluster` blocks of `threads`, launched with the
// cluster dimension as a launch attribute. A cluster past the portable 8
// blocks (up to 16 on the H100) must be allowed for the kernel first.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int64_t n_segs, int cluster,
                    int threads, cudaStream_t st, Args... args) {
  if (cluster > 8) {
    const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_segs * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kSumThreads)
checksum_segments_kernel(const uint32_t* __restrict__ x, int64_t n,
                         int64_t seg_words, uint32_t* __restrict__ out) {
  namespace cg = cooperative_groups;
  cluster_arrive();
  const uint32_t rank = cg::this_cluster().block_rank();
  const int64_t seg = blockIdx.x / kSumCluster;
  const int64_t lo = seg * seg_words;
  const uint32_t len =
      static_cast<uint32_t>(n - lo < seg_words ? n - lo : seg_words);
  const uint32_t n_vec = len >> 2;
  const uint4* __restrict__ x4 = reinterpret_cast<const uint4*>(x + lo);
  constexpr uint32_t kTile = kSumThreads * kSumVecs;
  uint32_t acc = 0u;
  for (uint32_t t = rank * kTile; t < n_vec; t += kSumCluster * kTile) {
    if (n_vec - t >= kTile) {
      uint4 v[kSumVecs];
#pragma unroll
      for (int u = 0; u < kSumVecs; ++u)
        v[u] = stream_load<1>(x4 + t + u * kSumThreads + threadIdx.x);
#pragma unroll
      for (int u = 0; u < kSumVecs; ++u)
        acc += weigh4_r(v[u], ((t + u * kSumThreads + threadIdx.x) << 2) %
                                  kWeightMod);
    } else {
      for (uint32_t j = t + threadIdx.x; j < n_vec; j += kSumThreads)
        acc += weigh4_r(stream_load<1>(x4 + j), (j << 2) % kWeightMod);
    }
  }
  // the len mod 4 words after the last whole vector
  const uint32_t i = (n_vec << 2) + threadIdx.x;
  if (rank == 0 && i < len) acc += weigh_at(x[lo + i], i);
  cluster_fold<kSumThreads, kSumCluster>(acc, out + seg);
}

int launch_cluster_checksum(const void* x, int64_t n, int64_t seg_words,
                            int64_t n_segs, void* out, cudaStream_t st) {
  return launch_clusters(checksum_segments_kernel, n_segs, kSumCluster,
                         kSumThreads, st, static_cast<const uint32_t*>(x), n,
                         seg_words, static_cast<uint32_t*>(out));
}

int launch_checksum(const void* x, int64_t n, int64_t seg_words,
                    int64_t n_segs, void* out, void* stream) {
  if (n < 0 || seg_words < 0 || seg_words >= kMaxSegWords || n_segs < 1 ||
      n_segs > (int64_t{1} << 31) / kSumCluster - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_checksum(x, n, seg_words, n_segs, out,
                                 static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------- segmented XOR digest
// xor_checksum_u32  replaces repro/kernels/fused.py:xor_checksum_u32
//
// One launch computes out = a ^ b over the consecutive seg_words-word
// segments of two buffers (the last may be short) and the digest of each
// segment's words written, its position weights restarting at 0: the
// delta-route encode of the chunks of a piece (core/codecs.py
// DeltaEncodePiece). One buffer's encode is the one-segment case.
//
// Bound on the card: 12 bytes a word over 3.35 TB/s, 0.0300 ms for a
// 32 MiB piece of 8 chunks, 0.0601 ms for 64 MiB. What the design does
// about it:
//
// * Spread over the card whatever the piece. The delta provider's pieces
//   are few segments (8 chunks of 4 MiB), and one cluster of 8 blocks a
//   segment would leave 68 of 132 SMs idle (a piece of 4: 100; 0.51 of
//   the bound at 16 MiB against 0.84). So a segment gets `groups`
//   clusters, ceil(kXorLaunchClusters / n_segs), no more than its vectors
//   fill (one tile a block) and at most kXorMaxGroups: 16 clusters of 8
//   blocks (128 SMs) for a 4 MiB call, 2 a segment for a piece of 8, one
//   for a piece of 16 or more. 8 or 32 clusters a launch, clusters of
//   16 blocks, and 1 or 4 loads in flight ran no faster (python -m
//   repro_torch.kernels.variants xor; PERF.md). Cluster g of a segment takes its tiles
//   g, g + groups, ... (each kXorCluster x kXorThreads x kXorVecs
//   vectors), so what is in flight stays a window of the segment.
// * No atomics, no zeroed output, no global scratch. Each cluster meets
//   its blocks' sums in rank 0's shared memory (cluster_fold, shared with
//   the digest and the int8 pair) and stores one partial with a plain
//   store: part[seg * kXorMaxGroups + g]. The slots past `groups` are
//   written 0 in the same launch, so a segment's digest is the sum of its
//   kXorMaxGroups partials mod 2^32, exact in any order; the host adds
//   them after the read-back it makes anyway (fused.py). The flush lanes
//   call the kernel at once on streams of their own, so scratch in device
//   memory, or a ticket counter for a last-block reduction, would race
//   between them.
// * The streaming core's memory habits: each thread issues its kXorVecs
//   16-byte loads of both inputs (ld.global.nc.L1::no_allocate) before it
//   computes, and stores the delta streaming (st.global.cs). Word
//   positions are 32-bit inside a segment (seg_words < 2^31): weigh4_r
//   and weigh_at, a 32-bit modulo by a constant.

constexpr int kXorThreads = 512;
// 16-byte loads of each input a thread issues before it computes
constexpr int kXorVecs = 2;
// blocks a cluster (8 is the largest portable size; 16 needs the launch's
// permission, which launch_clusters asks for)
constexpr int kXorCluster = 8;
// clusters a launch aims at, spread over its segments
constexpr int64_t kXorLaunchClusters = 16;
// partial sums a segment (the wrappers' fused.MAX_GROUPS)
constexpr int kXorMaxGroups = 32;

__global__ void __launch_bounds__(kXorThreads)
xor_checksum_segments_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int64_t n,
                             int64_t seg_words, int groups,
                             uint32_t* __restrict__ part) {
  namespace cg = cooperative_groups;
  cluster_arrive();
  const uint32_t rank = cg::this_cluster().block_rank();
  const int64_t cl = blockIdx.x / kXorCluster;
  const int64_t seg = cl / groups;
  const uint32_t g = static_cast<uint32_t>(cl % groups);
  const int64_t lo = seg * seg_words;
  const uint32_t len =
      static_cast<uint32_t>(n - lo < seg_words ? n - lo : seg_words);
  const uint32_t n_vec = len >> 2;
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a + lo);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b + lo);
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out + lo);
  constexpr uint32_t kTile = kXorThreads * kXorVecs;
  const uint32_t step = static_cast<uint32_t>(groups) * kXorCluster * kTile;
  uint32_t acc = 0u;
  for (uint32_t t = (g * kXorCluster + rank) * kTile; t < n_vec; t += step) {
    if (n_vec - t >= kTile) {
      uint4 va[kXorVecs], vb[kXorVecs];
#pragma unroll
      for (int u = 0; u < kXorVecs; ++u) {
        const uint32_t j = t + u * kXorThreads + threadIdx.x;
        va[u] = stream_load<1>(a4 + j);
        vb[u] = stream_load<1>(b4 + j);
      }
#pragma unroll
      for (int u = 0; u < kXorVecs; ++u) {
        const uint32_t j = t + u * kXorThreads + threadIdx.x;
        const uint4 d = XorOp::vec(va[u], vb[u]);
        stream_store<1>(o4 + j, d);
        acc += weigh4_r(d, (j << 2) % kWeightMod);
      }
    } else {
      for (uint32_t j = t + threadIdx.x; j < n_vec; j += kXorThreads) {
        const uint4 d =
            XorOp::vec(stream_load<1>(a4 + j), stream_load<1>(b4 + j));
        stream_store<1>(o4 + j, d);
        acc += weigh4_r(d, (j << 2) % kWeightMod);
      }
    }
  }
  if (g == 0 && rank == 0) {
    // the len mod 4 words after the last whole vector
    const uint32_t i = (n_vec << 2) + threadIdx.x;
    if (i < len) {
      const uint32_t d = a[lo + i] ^ b[lo + i];
      out[lo + i] = d;
      acc += weigh_at(d, i);
    }
    // the slots of the groups this launch does not run read 0
    if (threadIdx.x >= static_cast<uint32_t>(groups) &&
        threadIdx.x < kXorMaxGroups)
      part[seg * kXorMaxGroups + threadIdx.x] = 0u;
  }
  cluster_fold<kXorThreads, kXorCluster>(acc, part + seg * kXorMaxGroups + g);
}

// Clusters a segment: kXorLaunchClusters over the launch's segments, no
// more than a segment's vectors fill at one tile a block, at most
// kXorMaxGroups, at least one.
int xor_groups(int64_t n_segs, int64_t seg_words) {
  constexpr int64_t kClusterVecs =
      int64_t{kXorCluster} * kXorThreads * kXorVecs;
  int64_t g = (kXorLaunchClusters + n_segs - 1) / n_segs;
  const int64_t fill = ((seg_words >> 2) + kClusterVecs - 1) / kClusterVecs;
  if (g > fill) g = fill;
  if (g > kXorMaxGroups) g = kXorMaxGroups;
  return static_cast<int>(g < 1 ? 1 : g);
}

int launch_xor_clusters(const void* a, const void* b, void* out, int64_t n,
                        int64_t seg_words, int64_t n_segs, void* part,
                        cudaStream_t st) {
  const int groups = xor_groups(n_segs, seg_words);
  return launch_clusters(xor_checksum_segments_kernel, n_segs * groups,
                         kXorCluster, kXorThreads, st,
                         static_cast<const uint32_t*>(a),
                         static_cast<const uint32_t*>(b),
                         static_cast<uint32_t*>(out), n, seg_words, groups,
                         static_cast<uint32_t*>(part));
}

int launch_xor(const void* a, const void* b, void* out, int64_t n,
               int64_t seg_words, int64_t n_segs, void* part, void* stream) {
  if (n < 0 || seg_words < 0 || seg_words >= kMaxSegWords || n_segs < 1 ||
      n_segs > ((int64_t{1} << 31) / kXorCluster - 1) / kXorMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_xor_clusters(a, b, out, n, seg_words, n_segs, part,
                             static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------- segmented int8 pair
// quantize_checksum_int8    replaces repro/kernels/fused.py:quantize_checksum_int8
// dequantize_checksum_int8  replaces repro/kernels/fused.py:dequantize_checksum_int8
//
// One launch encodes (or decodes) the consecutive chunks of a piece of
// one tensor, each chunk a segment of whole rows described by its row
// starts (SegRows, at most kMaxSegs segments, passed by value so the
// launch uploads nothing). The payloads lie back to back, segment s's at
// byte 8 s + 260 row_start[s], each the int8q payload of core/codecs.py:
//     u32 n_rows | u32 raw_nbytes | f32 scales[n_rows] | i8 q[n_rows * 256]
// so one device-to-host copy gives every payload of the piece. The raw
// fp32 rows lie contiguously, segment s's from row row_start[s]. The
// encode takes the piece's valid raw byte count: bytes past it (a
// tensor's ragged tail) read as +0.0, so the host pads nothing. dig[s] is
// the digest of segment s's payload words at their positions: the header
// at words 0-1, the scale of row r at 2 + r, q word w of row r (four int8
// lanes packed little-endian) at 2 + n_rows + 64 r + w; positions restart
// in each segment. With header == 0 (the one-segment entries) there is
// one segment, its payload has no header and its digest leaves the header
// words out, as the codec's body digest did.
//
// Bound on the card: about ten fp32 operations a value against 1 KiB in
// and 260 B out per row (or the reverse), so device memory bounds both:
// (1024 + 260) bytes a row over 3.35 TB/s, 0.0251 ms for a 64 MiB piece
// of 65,536 rows. What the design does about it:
//
// * One cluster a segment, a grid of n_segs clusters, where one launch a
//   chunk (4,096 rows) left the card idle between launches and cost a
//   fill and a sync each. The decode runs clusters of kDequantCluster
//   (8) blocks: a piece of 16 chunks puts one block on 128 of the 132
//   SMs, at 0.73 of the bound. The encode is bound by each SM's
//   instruction rate, not by the bytes: its row math (an IEEE division a
//   value, the clamp, the conversion, the amax's shuffles) is most of its
//   time. So it runs clusters of kQuantCluster (16, the non-portable
//   size) blocks, two blocks an SM, at 0.56 of the bound; in clusters of
//   8 it ran at 0.41 (python -m repro_torch.kernels.variants int8;
//   PERF.md).
// * Each warp issues the loads of kQuantRows (encode) or kDequantRows
//   (decode) rows, two 16-byte loads a lane a row, before it reduces
//   any; one row for the encode, whose loop is then the shortest code
//   (2 and 4 rows run 12 % slower), two for the decode (1 row 10 %
//   slower). Loads bypass L1 (ld.global.nc.L1::no_allocate) and stores
//   stream (st.global.cs), as in the streaming core.
// * No atomics, no zeroed output, no global scratch: each segment's
//   digest is met in its cluster (cluster_fold) and stored once.
// * Positions are 32-bit: a segment holds at most kMaxSegRows rows, so
//   2 + 65 n_rows stays below 2^32.
// The row math is quantize_vals and dequant4 above, unchanged.

// rows a warp loads before it reduces any: the encode's and the decode's
constexpr int kQuantRows = 1;
constexpr int kDequantRows = 2;
constexpr int kQuantThreads = 512;
// blocks a segment: the encode's and the decode's (8 is the largest
// portable cluster, 16 the H100's largest)
constexpr int kQuantCluster = 16;
constexpr int kDequantCluster = 8;
constexpr int kMaxSegs = 32;
constexpr int64_t kRowBytes = kRowElems * 4;
constexpr int64_t kPayloadRowBytes = 4 + kRowElems;  // a scale, 256 q
constexpr int64_t kHeaderBytes = 4 * kPayloadHeaderWords;
constexpr int64_t kMaxSegRows = int64_t{1} << 25;

// Segment s is rows [start[s], start[s + 1]) of the piece.
struct SegRows {
  int32_t n;
  int32_t start[kMaxSegs + 1];
};

__device__ __forceinline__ uint32_t load_nc_u32(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// The u32 word at byte `at` of x; bytes at or past `valid` read as 0.
__device__ __forceinline__ uint32_t raw_word(const uint8_t* __restrict__ x,
                                             int64_t at, int64_t valid) {
  if (at + 4 <= valid) return *reinterpret_cast<const uint32_t*>(x + at);
  uint32_t w = 0u;
  for (int k = 0; k < 4 && at + k < valid; ++k)
    w |= static_cast<uint32_t>(x[at + k]) << (8 * k);
  return w;
}

__device__ __forceinline__ float4 as_float4(uint4 u) {
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                     __uint_as_float(u.z), __uint_as_float(u.w));
}

__device__ __forceinline__ float4 raw_float4(const uint8_t* __restrict__ x,
                                             int64_t at, int64_t valid) {
  return as_float4(make_uint4(raw_word(x, at, valid),
                              raw_word(x, at + 4, valid),
                              raw_word(x, at + 8, valid),
                              raw_word(x, at + 12, valid)));
}

struct RowPair {
  float4 a, b;
};

// load_row of a row that `valid` cuts, out of line: inlined and unrolled
// into the row loop, its byte loads made the encode about 4,000
// instructions long (1,056 out of line) and 23 % slower at 64 MiB
// (python -m repro_torch.kernels.variants int8: tail_inline).
__device__ __noinline__ RowPair load_cut_row(const uint8_t* __restrict__ x,
                                            int64_t at, int64_t valid,
                                            int lane) {
  return {raw_float4(x, at + 16 * lane, valid),
          raw_float4(x, at + 512 + 16 * lane, valid)};
}

// This lane's two float4 of row `row` of x (16-byte aligned), as
// quantize_row loads them; bytes at or past `valid` read as +0.0.
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ x,
                                         int64_t row, int64_t valid,
                                         int lane, float4* a, float4* b) {
  const int64_t at = row * kRowBytes;
  if (at + kRowBytes <= valid) {
    const uint4* p = reinterpret_cast<const uint4*>(x + at);
    *a = as_float4(stream_load<1>(p + lane));
    *b = as_float4(stream_load<1>(p + 32 + lane));
  } else {
    const RowPair r = load_cut_row(x, at, valid, lane);
    *a = r.a;
    *b = r.b;
  }
}

// The digest terms of a payload's two header words.
__device__ __forceinline__ uint32_t header_terms(uint32_t n_rows,
                                                 uint32_t raw_nbytes) {
  return weigh_at(n_rows, 0) + weigh_at(raw_nbytes, 1);
}

template <int kRows>
__global__ void __launch_bounds__(kQuantThreads)
quantize_segments_kernel(const uint8_t* __restrict__ x, int64_t valid,
                         uint8_t* __restrict__ out,
                         uint32_t* __restrict__ dig, SegRows seg,
                         int header) {
  namespace cg = cooperative_groups;
  cluster_arrive();
  const uint32_t rank = cg::this_cluster().block_rank();
  const int s = blockIdx.x / kQuantCluster;
  const int64_t r0 = seg.start[s];
  const uint32_t n = static_cast<uint32_t>(seg.start[s + 1] - r0);
  const int64_t hdr = header ? kHeaderBytes : 0;
  uint8_t* pay = out + hdr * s + kPayloadRowBytes * r0;
  float* scales = reinterpret_cast<float*>(pay + hdr);
  uint32_t* qw = reinterpret_cast<uint32_t*>(scales + n);
  const uint8_t* xs = x + kRowBytes * r0;
  const int64_t left = valid - kRowBytes * r0;  // raw bytes from row r0 on
  const int lane = threadIdx.x & 31;
  constexpr uint32_t kWarps = kQuantCluster * (kQuantThreads / 32);
  const uint32_t warp = rank * (kQuantThreads / 32) + (threadIdx.x >> 5);
  uint32_t acc = 0u;
  for (uint32_t r = warp * kRows; r < n; r += kWarps * kRows) {
    float4 a[kRows], b[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      a[k] = b[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r + k < n) load_row(xs, r + k, left, lane, &a[k], &b[k]);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r + k < n) {
        uint32_t wa, wb;
        const float scale = quantize_vals(a[k], b[k], &wa, &wb);
        const uint32_t q0 = (r + k) * kRowWords;
        __stcs(qw + q0 + lane, wa);
        __stcs(qw + q0 + 32 + lane, wb);
        const uint32_t i0 = kPayloadHeaderWords + n + q0;
        acc += weigh_at(wa, i0 + lane) + weigh_at(wb, i0 + 32 + lane);
        if (lane == 0) {
          __stcs(scales + r + k, scale);
          acc += weigh_at(__float_as_uint(scale), kPayloadHeaderWords + r + k);
        }
      }
    }
  }
  if (header && rank == 0 && threadIdx.x == 0) {
    const int64_t rows_bytes = kRowBytes * n;
    const uint32_t raw =
        static_cast<uint32_t>(left < rows_bytes ? left : rows_bytes);
    uint32_t* h = reinterpret_cast<uint32_t*>(pay);
    h[0] = n;
    h[1] = raw;
    acc += header_terms(n, raw);
  }
  cluster_fold<kQuantThreads, kQuantCluster>(acc, dig + s);
}

template <int kRows>
__global__ void __launch_bounds__(kQuantThreads)
dequantize_segments_kernel(const uint8_t* __restrict__ in,
                           float* __restrict__ out,
                           uint32_t* __restrict__ dig, SegRows seg,
                           int header) {
  namespace cg = cooperative_groups;
  cluster_arrive();
  const uint32_t rank = cg::this_cluster().block_rank();
  const int s = blockIdx.x / kDequantCluster;
  const int64_t r0 = seg.start[s];
  const uint32_t n = static_cast<uint32_t>(seg.start[s + 1] - r0);
  const int64_t hdr = header ? kHeaderBytes : 0;
  const uint8_t* pay = in + hdr * s + kPayloadRowBytes * r0;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(pay + hdr);
  const uint32_t* qw = sw + n;
  float* orows = out + int64_t{kRowElems} * r0;
  const int lane = threadIdx.x & 31;
  constexpr uint32_t kWarps = kDequantCluster * (kQuantThreads / 32);
  const uint32_t warp = rank * (kQuantThreads / 32) + (threadIdx.x >> 5);
  uint32_t acc = 0u;
  for (uint32_t r = warp * kRows; r < n; r += kWarps * kRows) {
    uint32_t sb[kRows], wa[kRows], wb[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      sb[k] = wa[k] = wb[k] = 0u;
      if (r + k < n) {
        const uint32_t q0 = (r + k) * kRowWords;
        sb[k] = load_nc_u32(sw + r + k);
        wa[k] = load_nc_u32(qw + q0 + lane);
        wb[k] = load_nc_u32(qw + q0 + 32 + lane);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r + k < n) {
        const float scale = __uint_as_float(sb[k]);
        float4* orow =
            reinterpret_cast<float4*>(orows + int64_t{r + k} * kRowElems);
        __stcs(orow + lane, dequant4(wa[k], scale));
        __stcs(orow + 32 + lane, dequant4(wb[k], scale));
        const uint32_t i0 = kPayloadHeaderWords + n + (r + k) * kRowWords;
        acc += weigh_at(wa[k], i0 + lane) + weigh_at(wb[k], i0 + 32 + lane);
        if (lane == 0) acc += weigh_at(sb[k], kPayloadHeaderWords + r + k);
      }
    }
  }
  if (header && rank == 0 && threadIdx.x == 0) {
    const uint32_t* h = reinterpret_cast<const uint32_t*>(pay);
    acc += header_terms(h[0], h[1]);
  }
  cluster_fold<kQuantThreads, kDequantCluster>(acc, dig + s);
}

template <bool kEncode>
int launch_int8_clusters(const void* src, int64_t valid, const SegRows& t,
                         void* dst, void* dig, int header, cudaStream_t st) {
  if constexpr (kEncode) {
    return launch_clusters(quantize_segments_kernel<kQuantRows>, t.n,
                           kQuantCluster, kQuantThreads, st,
                           static_cast<const uint8_t*>(src), valid,
                           static_cast<uint8_t*>(dst),
                           static_cast<uint32_t*>(dig), t, header);
  } else {
    return launch_clusters(dequantize_segments_kernel<kDequantRows>, t.n,
                           kDequantCluster, kQuantThreads, st,
                           static_cast<const uint8_t*>(src),
                           static_cast<float*>(dst),
                           static_cast<uint32_t*>(dig), t, header);
  }
}

// The segment table checked and passed by value: row_start[0] == 0, rows
// increasing, at most kMaxSegRows a segment, fewer than 2^31 in all; for
// the encode, `valid` ends inside the last row. header == 0 takes one
// segment. The piece's int8 launch.
template <bool kEncode>
int launch_int8(const void* src, int64_t valid, const int64_t* row_start,
                int64_t n_segs, void* dst, void* dig, int header,
                void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_segs < 1 || n_segs > kMaxSegs || row_start == nullptr ||
      row_start[0] != 0 || (header == 0 && n_segs != 1))
    return bad;
  SegRows t = {};
  t.n = static_cast<int32_t>(n_segs);
  for (int64_t s = 1; s <= n_segs; ++s) {
    const int64_t rows = row_start[s] - row_start[s - 1];
    if (rows < 1 || rows > kMaxSegRows || row_start[s] >= (int64_t{1} << 31))
      return bad;
    t.start[s] = static_cast<int32_t>(row_start[s]);
  }
  const int64_t rows = row_start[n_segs];
  if (kEncode && (valid <= kRowBytes * (rows - 1) || valid > kRowBytes * rows))
    return bad;
  return launch_int8_clusters<kEncode>(src, valid, t, dst, dig, header,
                                       static_cast<cudaStream_t>(stream));
}

}  // namespace

// All pointers are device pointers (but the int8 pair's host row_start)
// to 16-byte aligned buffers of n u32 words unless said otherwise;
// `out`/`dig`/`part` must not alias the inputs.

// out: one u32, written whole (0 for n == 0); n < 2^31.
extern "C" int ckpt_checksum_u32(const void* x, int64_t n, void* out,
                                 void* stream) {
  return launch_checksum(x, n, n, 1, out, stream);
}

// out: u32[ceil(n_words / seg_words)], written whole; seg_words a positive
// multiple of 4 below 2^31, so every segment starts 16-byte aligned.
// n_words == 0 launches nothing.
extern "C" int ckpt_checksum_u32_segments(const void* x, int64_t n_words,
                                          int64_t seg_words, void* out,
                                          void* stream) {
  if (seg_words <= 0 || seg_words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_words == 0) return 0;
  return launch_checksum(x, n_words, seg_words,
                         (n_words + seg_words - 1) / seg_words, out, stream);
}

// out: u32[n], a ^ b; part: u32[32] (kXorMaxGroups), written whole, the
// digest of out the sum of its words mod 2^32; n < 2^31.
extern "C" int ckpt_xor_checksum_u32(const void* a, const void* b, void* out,
                                     int64_t n, void* part, void* stream) {
  return launch_xor(a, b, out, n, n, 1, part, stream);
}

// out: u32[n_words], a ^ b; part: u32[n_segs][32], n_segs =
// ceil(n_words / seg_words), written whole, segment s's digest the sum of
// row s mod 2^32; seg_words a positive multiple of 4 below 2^31, so every
// segment starts 16-byte aligned. n_words == 0 launches nothing.
extern "C" int ckpt_xor_checksum_u32_segments(const void* a, const void* b,
                                              void* out, int64_t n_words,
                                              int64_t seg_words, void* part,
                                              void* stream) {
  if (seg_words <= 0 || seg_words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_words == 0) return 0;
  return launch_xor(a, b, out, n_words, seg_words,
                    (n_words + seg_words - 1) / seg_words, part, stream);
}

// dig: one u32 the digest of delta is added into, so the caller zeroes it
// first.
extern "C" int ckpt_xor_fold_checksum_u32(const void* base, const void* delta,
                                          void* out, int64_t n, void* dig,
                                          void* stream) {
  xor_checksum_kernel<true><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(delta),
      static_cast<uint32_t*>(out), n, static_cast<uint32_t*>(dig));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ckpt_delta_xor(const void* a, const void* b, void* out,
                              int64_t n, void* stream) {
  return launch_stream<XorOp>(a, b, out, n, stream);
}

// The one-segment case of the segmented int8 pair, on a payload body (no
// header). x: 16-byte aligned f32[n_rows * 256]; body: 4-byte aligned
// u8[n_rows * 260], written whole; dig: one u32, written whole (the
// body's digest, header words left out); 1 <= n_rows <= 2^25.
extern "C" int ckpt_quantize_checksum_int8(const void* x, int64_t n_rows,
                                           void* body, void* dig,
                                           void* stream) {
  const int64_t row_start[2] = {0, n_rows};
  return launch_int8<true>(x, n_rows * kRowBytes, row_start, 1, body, dig, 0,
                           stream);
}

// body: 4-byte aligned u8[n_rows * 260]; out: 16-byte aligned
// f32[n_rows * 256]; dig: one u32; all written whole.
extern "C" int ckpt_dequantize_checksum_int8(const void* body, int64_t n_rows,
                                             void* out, void* dig,
                                             void* stream) {
  const int64_t row_start[2] = {0, n_rows};
  return launch_int8<false>(body, 0, row_start, 1, out, dig, 0, stream);
}

// One launch over the n_segs chunks of a piece (1 <= n_segs <= 32).
// row_start: host i64[n_segs + 1], 0 first, increasing (segment s is rows
// [row_start[s], row_start[s + 1])). x: 16-byte aligned, its first
// valid_bytes bytes the raw fp32 data, 256 * 4 * (row_start[n_segs] - 1)
// < valid_bytes <= 256 * 4 * row_start[n_segs]; out: 4-byte aligned
// u8[8 n_segs + 260 row_start[n_segs]], the payloads back to back;
// dig: u32[n_segs], each payload's digest. Both written whole.
extern "C" int ckpt_quantize_checksum_int8_segments(
    const void* x, int64_t valid_bytes, const void* row_start,
    int64_t n_segs, void* out, void* dig, void* stream) {
  return launch_int8<true>(x, valid_bytes,
                           static_cast<const int64_t*>(row_start), n_segs,
                           out, dig, 1, stream);
}

// The inverse: in holds the payloads as the encode writes them (4-byte
// aligned; headers as the host checked them), out: 16-byte aligned
// f32[256 row_start[n_segs]], the rows contiguously; dig as above.
extern "C" int ckpt_dequantize_checksum_int8_segments(
    const void* in, const void* row_start, int64_t n_segs, void* out,
    void* dig, void* stream) {
  return launch_int8<false>(in, 0, static_cast<const int64_t*>(row_start),
                            n_segs, out, dig, 1, stream);
}

// x: 16-byte aligned f32[n]; out: 16-byte aligned bf16[n], written whole.
extern "C" int ckpt_downcast_bf16(const void* x, int64_t n, void* out,
                                  void* stream) {
  return launch_stream<Bf16Op>(x, nullptr, out, n, stream);
}

// x: 16-byte aligned f32[n_rows * 256]; q: 4-byte aligned i8[n_rows * 256];
// scales: f32[n_rows]. Both outputs are written whole.
extern "C" int ckpt_quantize_int8(const void* x, int64_t n_rows, void* q,
                                  void* scales, void* stream) {
  quantize_int8_kernel<<<row_blocks_for(n_rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_rows, static_cast<uint32_t*>(q),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// q: 4-byte aligned i8[n_rows * 256]; scales: f32[n_rows]; out: 16-byte
// aligned f32[n_rows * 256], written whole.
extern "C" int ckpt_dequantize_int8(const void* q, const void* scales,
                                    int64_t n_rows, void* out, void* stream) {
  dequantize_int8_kernel<<<row_blocks_for(n_rows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const float*>(scales),
      n_rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: 16-byte aligned f32[n]; out must not alias the inputs.
extern "C" int ckpt_delta_f32(const void* a, const void* b, void* out,
                              int64_t n, void* stream) {
  return launch_stream<F32SubOp>(a, b, out, n, stream);
}

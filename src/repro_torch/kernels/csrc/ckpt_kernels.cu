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
// The int8 kernels, the offline reduction's kernels and the streaming core
// (delta_xor and downcast_bf16) have their own notes further down; what
// follows is about the three digest kernels.
//
// The digest is the position-weighted sum
//     sum_i x[i] * (65599 + i mod 65521)   mod 2^32
// over the little-endian u32 words of a buffer. The Pallas kernels walk the
// input in sequential 65,536-word grid steps and carry the sum in one SMEM
// word; here blocks run in parallel and in no order, so each thread keeps a
// private u32 partial (wrap-around multiply-add is exact mod 2^32), the
// block reduces it with warp shuffles and shared memory, and one
// atomicAdd per block folds it into the output word. Addition mod 2^32 is
// associative and commutative, so the result is bit-exact in any block
// order. Zero words add nothing, so no padding to 65,536 words is needed:
// the wrapper only zero-pads the byte tail to a whole word.
//
// Bound on the card: every kernel here does a handful of integer
// operations per word and is limited by device memory: the least time is
// the bytes moved over 3.35 TB/s (the H100 SXM data sheet's HBM3 rate),
// 4N bytes for checksum_u32 and 12N bytes (two inputs read, one output
// written) for the two fused XOR kernels, N in words. The digest kernels
// answer that bound with 16-byte vector loads and stores (uint4,
// neighbouring threads on neighbouring addresses), a grid-stride loop
// capped at 132 x 8 blocks, one 64-bit modulo per four words, and a single
// atomic per block, so no second pass over memory is needed. They keep
// that loop, with one load in flight per thread, rather than the
// streaming core's one-pass grid: each block ends in a reduction and an
// atomic, which a grid of thousands of blocks would multiply, and at the
// main path's 4 MiB chunks their time is the host's (wrapper, ctypes,
// allocation), not the loop's.
//
// Where the data lives: the checkpoint path stages device state into pinned
// host memory first, and these kernels are fed that host-staged data (the
// wrapper copies host to device, launches, and copies back only the
// outputs). That round trip over PCIe, about 3x the chunk for the XOR
// kernels, is the known cost of this first version; moving the encode ahead
// of the device-to-host copy is a later change.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError() so a refused launch is reported.

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

// Weighted sum of the four words of v, whose first word sits at index i.
__device__ __forceinline__ uint32_t weigh4(uint4 v, int64_t i) {
  uint32_t r = static_cast<uint32_t>(i % kWeightMod);
  uint32_t s = v.x * (kWeightBase + r);
  r = next_r(r);
  s += v.y * (kWeightBase + r);
  r = next_r(r);
  s += v.z * (kWeightBase + r);
  r = next_r(r);
  s += v.w * (kWeightBase + r);
  return s;
}

__device__ __forceinline__ uint32_t weigh1(uint32_t x, int64_t i) {
  return x * (kWeightBase + static_cast<uint32_t>(i % kWeightMod));
}

// Block-wide sum of one u32 per thread, added to *out by one atomic.
__device__ __forceinline__ void block_fold(uint32_t acc, uint32_t* out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (kThreads / 32) ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && acc != 0u) atomicAdd(out, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint32_t* __restrict__ x, int64_t n,
                uint32_t* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const uint4* __restrict__ x4 = reinterpret_cast<const uint4*>(x);
  uint32_t acc = 0u;
  for (int64_t j = tid; j < n4; j += stride) acc += weigh4(x4[j], j << 2);
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride)
    acc += weigh1(x[i], i);
  block_fold(acc, out);
}

// out = a ^ b with the digest of the words written (the delta-route
// encode), or, with kDigestB, of the words of b (the fused chain-replay
// decode: base ^ delta, verifying the stored delta as it is applied).
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
// quantize_checksum_int8    replaces repro/kernels/fused.py:quantize_checksum_int8
// dequantize_checksum_int8  replaces repro/kernels/fused.py:dequantize_checksum_int8
//
// Rows of 256 fp32 values, each with a symmetric scale:
//     scale = amax > 0 ? amax / 127 : 1,  q = clip(rint(x / scale), +-127).
// `body` is the int8q payload after its 8-byte header (core/codecs.py):
//     f32 scales[n_rows] | i8 q[n_rows * 256]
// so one device-to-host copy of `body` gives the stored payload. The digest
// covers the body's words at their payload positions: the scale of row r at
// word 2 + r, and q word w of row r (four int8 lanes packed little-endian)
// at word 2 + n_rows + 64 r + w. The two header words are added on the
// host. The Pallas kernels pad to 256-row tiles and mask padded scales;
// here only the n_rows live rows are launched, so nothing is masked.
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
// Bound on the card: a 256-float row is 1 KiB in and 260 B out (or the
// reverse), against about ten fp32 operations per value, so device memory
// bounds both kernels: (1024 + 260) bytes per row over 3.35 TB/s. The
// design answers that with one warp per row: each lane loads two float4
// (the row's elements 4l..4l+3 and 128+4l..128+4l+3, so both loads of the
// warp are contiguous 512-byte runs), the amax is a five-step
// __shfl_xor_sync max, and each lane stores its two packed q words as
// coalesced u32 stores. Warps walk rows in a grid-stride loop; the digest
// is a per-lane u32 partial folded once per block by block_fold.

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

// One warp quantizes one row: this lane's two packed q words (elements
// 4l..4l+3 and 128+4l..128+4l+3) and the row's scale. Both the fused
// encode and the plain quantize_int8 kernel call it, so the two cannot
// drift apart.
__device__ __forceinline__ float quantize_row(const float* __restrict__ x,
                                              int64_t row, int lane,
                                              uint32_t* wa, uint32_t* wb) {
  const float4* xr = reinterpret_cast<const float4*>(x + row * kRowElems);
  const float4 a = xr[lane];
  const float4 b = xr[32 + lane];
  float m = nan_max(absmax4(a), absmax4(b));
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = row_scale(m);
  *wa = quant4(a, scale);
  *wb = quant4(b, scale);
  return scale;
}

__global__ void __launch_bounds__(kThreads)
quantize_checksum_kernel(const float* __restrict__ x, int64_t n_rows,
                         uint8_t* __restrict__ body,
                         uint32_t* __restrict__ dig) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  float* __restrict__ scales = reinterpret_cast<float*>(body);
  uint32_t* __restrict__ qw = reinterpret_cast<uint32_t*>(body + 4 * n_rows);
  uint32_t acc = 0u;
  for (int64_t row = warp; row < n_rows; row += n_warps) {
    uint32_t wa, wb;
    const float scale = quantize_row(x, row, lane, &wa, &wb);
    const int64_t q0 = row * kRowWords;
    qw[q0 + lane] = wa;
    qw[q0 + 32 + lane] = wb;
    const int64_t i0 = kPayloadHeaderWords + n_rows + q0;
    acc += weigh1(wa, i0 + lane) + weigh1(wb, i0 + 32 + lane);
    if (lane == 0) {
      scales[row] = scale;
      acc += weigh1(__float_as_uint(scale), kPayloadHeaderWords + row);
    }
  }
  block_fold(acc, dig);
}

__global__ void __launch_bounds__(kThreads)
dequantize_checksum_kernel(const uint8_t* __restrict__ body, int64_t n_rows,
                           float* __restrict__ out,
                           uint32_t* __restrict__ dig) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const float* __restrict__ scales = reinterpret_cast<const float*>(body);
  const uint32_t* __restrict__ qw =
      reinterpret_cast<const uint32_t*>(body + 4 * n_rows);
  uint32_t acc = 0u;
  for (int64_t row = warp; row < n_rows; row += n_warps) {
    const float scale = scales[row];
    const int64_t q0 = row * kRowWords;
    const uint32_t wa = qw[q0 + lane];
    const uint32_t wb = qw[q0 + 32 + lane];
    float4* orow = reinterpret_cast<float4*>(out + row * kRowElems);
    orow[lane] = dequant4(wa, scale);
    orow[32 + lane] = dequant4(wb, scale);
    const int64_t i0 = kPayloadHeaderWords + n_rows + q0;
    acc += weigh1(wa, i0 + lane) + weigh1(wb, i0 + 32 + lane);
    if (lane == 0)
      acc += weigh1(__float_as_uint(scale), kPayloadHeaderWords + row);
  }
  block_fold(acc, dig);
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
// pair runs one warp a row in a grid-stride loop; delta_f32 keeps the
// digest kernels' grid-stride loop with one 16-byte load in flight per
// thread. No path launches it, and it moves to the streaming core below
// in a PR of its own. The downcast runs on the streaming core.

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

__global__ void __launch_bounds__(kThreads)
delta_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int64_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const float4* __restrict__ a4 = reinterpret_cast<const float4*>(a);
  const float4* __restrict__ b4 = reinterpret_cast<const float4*>(b);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
  for (int64_t j = tid; j < n4; j += stride) {
    const float4 u = a4[j];
    const float4 v = b4[j];
    o4[j] = make_float4(sub_flushed(u.x, v.x), sub_flushed(u.y, v.y),
                        sub_flushed(u.z, v.z), sub_flushed(u.w, v.w));
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride)
    out[i] = sub_flushed(a[i], b[i]);
}


// ------------------------------------------------------- streaming core
// delta_xor      replaces repro/kernels/delta.py:delta_xor
// downcast_bf16  replaces repro/kernels/quantize.py:downcast_bf16
//
// Both are pure streams: read 16-byte vectors, do a few integer operations
// on each, write. One template serves both, over the per-vector operation
// (XorOp, Bf16Op below).
//
// Bound on the card: the bytes moved over 3.35 TB/s, 12 bytes a word for
// the XOR (two words in, one out) and 6 a value for the downcast (4 in,
// 2 out). What stood between the earlier grid-stride loop and that bound,
// and what this design does about it:
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
// the plain version; nothing here converts through float.

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

}  // namespace

// All pointers are device pointers to 16-byte aligned buffers of n u32
// words; `out`/`dig` must not alias the inputs. `dig` and `out` of the
// checksum are accumulated into, so the caller zeroes them first.
extern "C" int ckpt_checksum_u32(const void* x, int64_t n, void* out,
                                 void* stream) {
  checksum_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ckpt_xor_checksum_u32(const void* a, const void* b, void* out,
                                     int64_t n, void* dig, void* stream) {
  xor_checksum_kernel<false><<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, static_cast<uint32_t*>(dig));
  return static_cast<int>(cudaGetLastError());
}

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

// x: 16-byte aligned f32[n_rows * 256]; body: 4-byte aligned
// u8[n_rows * 260], written whole; dig: one zeroed u32, accumulated into.
extern "C" int ckpt_quantize_checksum_int8(const void* x, int64_t n_rows,
                                           void* body, void* dig,
                                           void* stream) {
  quantize_checksum_kernel<<<row_blocks_for(n_rows), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_rows, static_cast<uint8_t*>(body),
      static_cast<uint32_t*>(dig));
  return static_cast<int>(cudaGetLastError());
}

// body: 4-byte aligned u8[n_rows * 260]; out: 16-byte aligned
// f32[n_rows * 256]; dig: one zeroed u32, accumulated into.
extern "C" int ckpt_dequantize_checksum_int8(const void* body, int64_t n_rows,
                                             void* out, void* dig,
                                             void* stream) {
  dequantize_checksum_kernel<<<row_blocks_for(n_rows), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(body), n_rows, static_cast<float*>(out),
      static_cast<uint32_t*>(dig));
  return static_cast<int>(cudaGetLastError());
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
  delta_f32_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

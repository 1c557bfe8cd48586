// Checkpoint integrity and differential-encoding kernels for Hopper (sm_90a).
//
// Five kernels, one plain C interface (loaded with ctypes by
// repro_torch/kernels/build.py):
//
//   checksum_u32              replaces repro/kernels/checksum.py:checksum_u32
//   xor_checksum_u32          replaces repro/kernels/fused.py:xor_checksum_u32
//   delta_xor                 replaces repro/kernels/delta.py:delta_xor
//   quantize_checksum_int8    replaces repro/kernels/fused.py:quantize_checksum_int8
//   dequantize_checksum_int8  replaces repro/kernels/fused.py:dequantize_checksum_int8
//
// The int8q pair has its own note further down; what follows is about the
// three u32 kernels.
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
// written) for xor_checksum_u32 and delta_xor, N in words. The design
// answers that bound with 16-byte vector loads and stores (uint4,
// neighbouring threads on neighbouring addresses), a grid-stride loop sized
// to keep every SM busy, one 64-bit modulo per four words, and a single
// atomic per block, so no second pass over memory is needed.
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
    acc += weigh4(d, j << 2);
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride) {
    const uint32_t d = a[i] ^ b[i];
    out[i] = d;
    acc += weigh1(d, i);
  }
  block_fold(acc, dig);
}

__global__ void __launch_bounds__(kThreads)
xor_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int64_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = n >> 2;
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b);
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out);
  for (int64_t j = tid; j < n4; j += stride) {
    const uint4 u = a4[j];
    const uint4 v = b4[j];
    o4[j] = make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
  }
  for (int64_t i = (n4 << 2) + tid; i < n; i += stride) out[i] = a[i] ^ b[i];
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
// exact in any order. The reference computes with subnormals flushed (XLA
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

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(daz(v.x)), fabsf(daz(v.y))),
               fmaxf(fabsf(daz(v.z)), fabsf(daz(v.w))));
}

__device__ __forceinline__ float row_scale(float amax) {
  if (!(amax > 0.0f)) return 1.0f;
  const float s = amax / 127.0f;
  return s < kFltMin ? 0.0f : s;
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
    const float4* xr = reinterpret_cast<const float4*>(x + row * kRowElems);
    const float4 a = xr[lane];
    const float4 b = xr[32 + lane];
    float m = fmaxf(absmax4(a), absmax4(b));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = row_scale(m);
    const uint32_t wa = quant4(a, scale);
    const uint32_t wb = quant4(b, scale);
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
  xor_checksum_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, static_cast<uint32_t*>(dig));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ckpt_delta_xor(const void* a, const void* b, void* out,
                              int64_t n, void* stream) {
  xor_kernel<<<blocks_for(n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
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

// Checkpoint integrity and differential-encoding kernels for Hopper (sm_90a).
//
// Three kernels, one plain C interface (loaded with ctypes by
// repro_torch/kernels/build.py):
//
//   checksum_u32      replaces repro/kernels/checksum.py:checksum_u32
//   xor_checksum_u32  replaces repro/kernels/fused.py:xor_checksum_u32
//   delta_xor         replaces repro/kernels/delta.py:delta_xor
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

// Flash-attention forward for Hopper (sm_90a), plain C interface (loaded
// with ctypes by repro_torch/kernels/build.py, built in the same library as
// ckpt_kernels.cu).
//
//   flash_attention_fwd   replaces repro/kernels/flash_attention.py:flash_attention_bh
//                         (the Pallas TPU kernel that repro.kernels.ops.flash_attention
//                         wraps, and the TPU twin of repro.models.layers.blocked_sdpa)
//
// What it computes (the plain version is flash_attention_plain in
// repro_torch/kernels/flash_attention.py): causal online-softmax attention
// with the "full", "window" and "chunked" masks. q is (B, S, H, hd), k and v
// are (B, T, KV, hd), the output is (B, S, H * hd) in q's dtype. Logits are
// scaled by 1/sqrt(hd) in fp32, masked entries read -1e30 and their
// probabilities are zeroed, the running max m, sum l and accumulator acc are
// fp32, and the output is acc / (l + 1e-30).
//
// Translation from the TPU kernel:
// - The TPU grid is (B*H, q blocks, kv blocks) with the kv axis sequential,
//   carrying m, l and acc in VMEM scratch between grid steps. Here one CTA
//   owns one (b, h, 64-query tile) and walks the kv tiles in a loop, with m,
//   l and acc in registers; CTAs run in parallel in any order. The q tiles
//   are issued last-first, so the long causal rows start first.
// - The Pallas wrapper materialises the GQA repeat (jnp.repeat over KV
//   heads); here query head h reads KV head h / (H / KV) directly.
// - The Pallas kernel asserts S % q_block == 0; here ragged S and T are
//   masked in the kernel: rows past S are computed on zeros and not
//   stored, keys past T are staged as zeros and masked.
// - KV tiles that lie wholly outside the mask of the CTA's rows (above the
//   causal diagonal, below the window, before the chunk) are skipped; in
//   the reference their contribution is exactly zero (alpha = 1, p = 0).
//
// Two bodies, one per input type:
// - bf16 (the serving path): 4 warps, 16 query rows each, with mma.sync
//   m16n8k16 bf16 tensor-core products (fp32 accumulation) for q.k^T and for
//   p.v; the probabilities are rounded to bf16 for the second product, as
//   FlashAttention-2 does. The product q.k is scaled in fp32 afterwards.
// - fp32: plain fp32 FMA on the CUDA cores (the tensor cores' TF32 keeps
//   too few digits for the 2e-5 tolerance), q pre-scaled in fp32 as the
//   reference does, 4 threads per query row.
//
// Bound on the card: attention at the serving shape (B 2, S 4,096, 32/8
// heads, hd 64, causal) does about 1.37e11 FLOP of bf16 products
// (4 * hd per visible query-key pair) against 84 MB of input and output (q,
// k, v read once, the output written once), so it is bound by the tensor
// cores' 989 TFLOP/s (0.139 ms), not by the 3.35 TB/s of device memory
// (0.025 ms). This first version stages K and V tiles with plain
// 16-byte loads and no pipelining, so it stays well above that bound;
// wgmma, TMA and a load/compute pipeline are later work.
//
// Kernels launch on the caller's stream and allocate nothing; the entry
// point returns cudaGetLastError() so a refused launch is reported.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int HD = 64;  // head width (llama3.2-1b: 2048 / 32)

enum MaskKind : int { kFull = 0, kWindow = 1, kChunked = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t S, T, H, KV;
  int64_t window, chunk;
  int kind;
  float scale;
};

// Query position i may see key position j.
__device__ __forceinline__ bool allowed(int64_t i, int64_t j,
                                        const Params& p) {
  if (j > i || j >= p.T) return false;
  if (p.kind == kWindow) return j > i - p.window;
  if (p.kind == kChunked) return (i / p.chunk) == (j / p.chunk);
  return true;
}

// The kv tiles [*t0, *t1) that hold a key some query in [q0, q1) may see.
__device__ __forceinline__ void kv_tiles(int64_t q0, int64_t q1,
                                         const Params& p, int64_t* t0,
                                         int64_t* t1) {
  const int64_t hi = q1 < p.T ? q1 : p.T;  // keys j <= q1 - 1, j < T
  int64_t lo = 0;
  if (p.kind == kWindow) {
    lo = q0 - p.window + 1;
    lo = lo > 0 ? lo : 0;
  } else if (p.kind == kChunked) {
    lo = (q0 / p.chunk) * p.chunk;
  }
  *t0 = lo / kBlockK;
  *t1 = hi > lo ? (hi + kBlockK - 1) / kBlockK : *t0;
}

__device__ __forceinline__ int64_t row_offset(int64_t b, int64_t pos,
                                              int64_t len, int64_t heads,
                                              int64_t head, int hd) {
  return ((b * len + pos) * heads + head) * hd;
}

// ------------------------------------------------------------------ fp32
// 256 threads: query row r = tid / 4 of the tile, part = tid % 4. In q.k^T a
// thread takes the keys part, part + 4, ...; in p.v the dims part, part + 4,
// ... (neighbouring parts on neighbouring shared-memory banks).
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBlockK + 1;
  constexpr int KJ = kBlockK / 4;
  constexpr int DP = HD / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;                    // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;                    // [kBlockK][LD]
  float* ps = vs + kBlockK * LD;                    // [kBlockQ][PLD]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int part = tid & 3;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int64_t q1 = q0 + kBlockQ < p.S ? q0 + kBlockQ : p.S;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / (p.H / p.KV);
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  for (int e = tid; e < kBlockQ * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    const int64_t i = q0 + r;
    qs[r * LD + d] =
        i < p.S ? q[row_offset(b, i, p.S, p.H, h, HD) + d] * p.scale : 0.f;
  }

  float acc[DP];
#pragma unroll
  for (int dd = 0; dd < DP; ++dd) acc[dd] = 0.f;
  float m = kNegInf, l = 0.f;
  const int64_t i = q0 + row;
  int64_t t0, t1;
  kv_tiles(q0, q1, p, &t0, &t1);

  for (int64_t kt = t0; kt < t1; ++kt) {
    __syncthreads();  // the previous tile's reads are done (and q staged)
    const int64_t jb = kt * kBlockK;
    for (int e = tid; e < kBlockK * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD;
      const int64_t j = jb + r;
      const bool in = j < p.T;
      const int64_t off = row_offset(b, in ? j : 0, p.T, p.KV, kvh, HD) + d;
      ks[r * LD + d] = in ? k[off] : 0.f;
      vs[r * LD + d] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float s[KJ];
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) s[jj] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[row * LD + d];
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj)
        s[jj] = fmaf(qd, ks[(part + 4 * jj) * LD + d], s[jj]);
    }
    uint32_t ok = 0;
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) {
      if (allowed(i, jb + part + 4 * jj, p)) {
        ok |= 1u << jj;
      } else {
        s[jj] = kNegInf;
      }
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) {
      const float pe = (ok >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
      rs += pe;
      ps[row * PLD + part + 4 * jj] = pe;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    m = m_new;
    __syncwarp();  // the row's four threads share their p through ps
#pragma unroll
    for (int dd = 0; dd < DP; ++dd) acc[dd] *= alpha;
    for (int jk = 0; jk < kBlockK; ++jk) {
      const float pe = ps[row * PLD + jk];
#pragma unroll
      for (int dd = 0; dd < DP; ++dd)
        acc[dd] = fmaf(pe, vs[jk * LD + part + 4 * dd], acc[dd]);
    }
  }

  if (i < p.S) {
    float* out = static_cast<float*>(p.out) + row_offset(b, i, p.S, p.H, h, HD);
#pragma unroll
    for (int dd = 0; dd < DP; ++dd) out[part + 4 * dd] = acc[dd] / (l + kTiny);
  }
}

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows x HD bf16 from global rows (pos0 + r, head) into smem rows of LD,
// zeros for pos >= len; 16-byte vectors.
template <int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t b, int64_t pos0,
                                           int64_t len, int64_t heads,
                                           int64_t head, int rows) {
  constexpr int VPR = HD / 8;
  for (int e = threadIdx.x; e < rows * VPR; e += blockDim.x) {
    const int r = e / VPR, c = e % VPR;
    const int64_t pos = pos0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < len)
      val = *reinterpret_cast<const uint4*>(
          src + row_offset(b, pos, len, heads, head, HD) + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// 128 threads = 4 warps; warp w owns query rows 16w .. 16w + 15 of the tile.
// mma fragment layout (m16n8k16): lane = 4 * g + t; a thread holds rows g
// and g + 8 of its warp's tile and columns 2t, 2t + 1 of each 8-wide slab.
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int LD = HD + 8;  // padded smem row: conflict-free fragments
  constexpr int NK = kBlockK / 8;
  constexpr int ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * LD;
  __nv_bfloat16* vs = ks + kBlockK * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int64_t q1 = q0 + kBlockQ < p.S ? q0 + kBlockQ : p.S;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / (p.H / p.KV);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);

  stage_bf16<LD>(qs, q, b, q0, p.S, p.H, h, kBlockQ);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* base = qs + kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(base + r0 * LD);
    qf[kk][1] = ld_u32(base + (r0 + 8) * LD);
    qf[kk][2] = ld_u32(base + r0 * LD + 8);
    qf[kk][3] = ld_u32(base + (r0 + 8) * LD + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int64_t i_r[2] = {q0 + r0, q0 + r0 + 8};
  int64_t t0, t1;
  kv_tiles(q0, q1, p, &t0, &t1);

  for (int64_t kt = t0; kt < t1; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int64_t jb = kt * kBlockK;
    stage_bf16<LD>(ks, k, b, jb, p.T, p.KV, kvh, kBlockK);
    stage_bf16<LD>(vs, v, b, jb, p.T, p.KV, kvh, kBlockK);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kb = ks + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_16816(s[n], qf[kk], ld_u32(kb + kk * 16), ld_u32(kb + kk * 16 + 8));
    }

    uint32_t ok = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int64_t j = jb + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * p.scale;
        if (allowed(i_r[rr], j, p)) {
          ok |= 1u << (n * 4 + e);
        } else {
          x = kNegInf;
        }
        s[n][e] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      alpha[rr] = expf(m_r[rr] - m_new);
      m_r[rr] = m_new;
      l_r[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const float pe =
            (ok >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_r[rr]) : 0.f;
        s[n][e] = pe;
        l_r[rr] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // p (the s fragments of keys 16c .. 16c + 15) is the A operand of p.v
#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) {
      const uint32_t a[4] = {pack_f32(s[2 * c][0], s[2 * c][1]),
                             pack_f32(s[2 * c][2], s[2 * c][3]),
                             pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_f32(s[2 * c + 1][2], s[2 * c + 1][3])};
      const __nv_bfloat16* vb = vs + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* col = vb + n * 8;
        mma_16816(o[n], a, pack_bf16(col[0], col[LD]),
                  pack_bf16(col[8 * LD], col[9 * LD]));
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (i_r[rr] >= p.S) continue;
    const float den = l + kTiny;
    __nv_bfloat16* dst = out + row_offset(b, i_r[rr], p.S, p.H, h, HD) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_f32(o[n][2 * rr] / den, o[n][2 * rr + 1] / den);
  }
}

cudaError_t launch(const Params& p, bool bf16, int64_t B, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((p.S + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(B));
  if (bf16) {
    const int smem = 3 * kBlockQ * (HD + 8) * 2;
    cudaError_t rc = cudaFuncSetAttribute(
        flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    flash_fwd_bf16<<<grid, 128, smem, st>>>(p);
  } else {
    const int smem = (3 * kBlockQ * (HD + 1) + kBlockQ * (kBlockK + 1)) * 4;
    cudaError_t rc = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    flash_fwd_f32<<<grid, 256, smem, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, hd), k/v: (B, T, KV, hd), out: (B, S, H * hd), all contiguous
// and 16-byte aligned, of one dtype: bf16 when is_bf16, else fp32.
// kind: 0 full, 1 window, 2 chunked. hd must be 64.
extern "C" int ckpt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, int64_t B,
                                        int64_t S, int64_t T, int64_t H,
                                        int64_t KV, int64_t hd,
                                        int64_t is_bf16, int64_t kind,
                                        int64_t window, int64_t chunk,
                                        void* stream) {
  if (B < 1 || B > 65535 || S < 1 || T < 1 || H < 1 || H > 65535 || KV < 1 ||
      H % KV != 0 || kind < kFull || kind > kChunked ||
      (kind == kChunked && chunk < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.window = window;
  p.chunk = chunk;
  p.kind = static_cast<int>(kind);
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != HD) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(p, is_bf16 != 0, B, st));
}

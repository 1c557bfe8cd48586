// Flash-attention forward for Hopper (sm_90a), plain C interface (loaded
// with ctypes by repro_torch/kernels/build.py, built in the same library as
// ckpt_kernels.cu).
//
//   ckpt_flash_attention_fwd  replaces repro/kernels/flash_attention.py:flash_attention_bh
//                             (the Pallas TPU kernel that repro.kernels.ops.flash_attention
//                             wraps, and the TPU twin of repro.models.layers.blocked_sdpa)
//
// What it computes (the plain version is flash_attention_plain in
// repro_torch/kernels/flash_attention.py): causal online-softmax attention
// with the "full", "window" and "chunked" masks, and the prefix-LM's prefix
// (the first n_prefix positions also see each other, as
// repro.models.layers._allowed has it: the TPU kernel takes no prefix, its
// twin blocked_sdpa(n_prefix=...) does). q is (B, S, H, hd), k and v
// are (B, T, KV, hd), the output is (B, S, H * hd) in q's dtype. Logits are
// scaled by 1/sqrt(hd) in fp32, masked entries read -1e30 and their
// probabilities are zeroed, the running max m, sum l and accumulator acc are
// fp32, and the output is acc / (l + 1e-30).
//
// Translation from the TPU kernel:
// - The TPU grid is (B*H, q blocks, kv blocks) with the kv axis sequential,
//   carrying m, l and acc in VMEM scratch between grid steps. Here one CTA
//   owns one (b, h, query tile) and walks the kv tiles in a loop, with m, l
//   and acc in registers; CTAs run in parallel in any order. The query
//   tiles are issued longest first, so the long causal rows start first.
// - The Pallas wrapper materialises the GQA repeat (jnp.repeat over KV
//   heads); here query head h reads KV head h / (H / KV) directly.
// - The Pallas kernel asserts S % q_block == 0; here ragged S and T are
//   handled in the kernel: rows past S are computed on zeros and not
//   stored, keys past T arrive as zeros and are masked.
// - KV tiles that lie wholly outside the mask of the CTA's rows (above the
//   causal diagonal, below the window, before the chunk) are skipped; in
//   the reference their contribution is exactly zero (alpha = 1, p = 0).
//
// Bound on the card: attention at the serving shape (B 2, S 4,096, 32/8
// heads, hd 64, causal) does about 1.37e11 FLOP of bf16 products
// (4 * hd per visible query-key pair) against 84 MB of input and output (q,
// k, v read once, the output written once), so it is bound by the tensor
// cores' 989 TFLOP/s (0.139 ms), not by the 3.35 TB/s of device memory
// (0.025 ms); at hd 128 (gemma3-27b: B 2, S 4,096, 32/16 heads) 2.75e11
// FLOP (0.278 ms) against 134 MB (0.040 ms); at hd 256 (recurrentgemma-2b:
// B 2, S 4,096, 10/1 heads, window 2,048) 1.29e11 FLOP (0.130 ms) against
// 97 MB (0.029 ms). At hd 64 the softmax's
// exponentials cost the SM as many cycles as the two products (16 a cycle
// on the SFUs against 1,024 multiply-adds a cycle on the tensor cores), so
// the design keeps several warpgroups in flight, each one's softmax beside
// the others' products; at hd 128 the products take twice as long per
// exponential and two warpgroups suffice.
//
// Head widths: both bodies are templates on hd, built for 64, 128 and 256
// (the TPU kernel takes any width; the repo's configs have hd 64, 128 and,
// recurrentgemma-2b and paligemma-3b, 256). A row of hd 128 bf16 values is
// 256 bytes, two 128-byte swizzle atoms, and at hd 256 it is four: every
// tile is kept as hd / 64 column parts ("halves" below, four at hd 256),
// each a plain 128-byte-swizzled tile of 64 columns, loaded and stored by
// its own TMA box; the wgmma descriptors step from one part to the next
// along hd every four k-steps. At hd 256 a 128-key K or V stage would be
// 64 KB, and with Q's 64 KB two stages would pass the 227 KB of a CTA, so
// the tiles are 64 keys (Q K^T as m64n64k16): Q 64 KB and two stages of K
// and V 128 KB, 192 KB in all. A consumer thread then holds O (128
// registers), S (32) and P (16) in the 240 that two consumers get.
//
// Row stats: when the caller passes m and l (fp32, (B, S, H)), each row's
// running max of the scaled logits and its sum of exponentials relative to
// it are written, as the reference's _flash_fwd_impl returns them for the
// backward (repro/models/layers.py:151-185); a row that sees no key keeps
// m = -1e30 and l = 0. Without them nothing more is stored.
//
// Two bodies, one per input type:
// - bf16 (the serving path), a warp-specialised Hopper pipeline. A CTA of
//   one producer and C consumer warpgroups (C = 3 at hd 64, 2 at hd 128)
//   owns 64 C query rows of one (b, h); CTAs are issued heads first, then
//   batch, then the query tiles longest first (C = 2 at hd 256 too):
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec)
//     and one thread issues every TMA load, Q once, then each 128-key K
//     and V tile (64-key at hd 256) into a shared-memory ring of three
//     stages at hd 64, two at hd 128 and 256. TMA writes the tiles
//     in the 128-byte swizzle (64 bf16 columns are exactly 128 bytes; a
//     wider row is loaded as 64-column halves, one box each) and
//     zero-fills rows past S and T, so ragged tails need no staging code.
//     full[stage] mbarriers carry the transaction bytes; the producer waits
//     on empty[stage] before it refills a stage.
//   * the other warpgroups are the consumers, 64 query rows each
//     (setmaxnreg.inc: 160 registers at hd 64, 240 at hd 128 and 256).
//     S = Q K^T is hd / 16 wgmma m64n128k16 (m64n64k16 at hd 256; A and B
//     K-major from the swizzled
//     tiles), scaled in fp32 afterwards with log2(e) folded in for
//     ex2.approx; the online softmax stays in registers (row max and sum
//     over a quad of lanes). The S accumulator, packed to bf16, is wgmma's
//     A fragment layout, so O += P V is eight wgmma m64n64k16 (four at hd
//     256) a 64-column half of O, with P from registers and V read MN-major
//     from its tile
//     (the transpose bit, no copy). Q K^T of tile i is issued together with
//     P V of tile i - 1, so that product runs while the warpgroup takes
//     tile i's softmax. Each consumer warp arrives on empty[stage] once its
//     P V has retired.
//   * Masks cost only where they bite: each row's visible keys are the
//     interval [lo(i), min(i, T - 1)] (lo is 0, i - window + 1 or the
//     chunk's start; a row below n_prefix sees [0, min(n_prefix, T) - 1],
//     which holds its causal interval), so a tile that every row of a
//     warpgroup sees whole
//     runs no per-element test, a tile that none of them sees is skipped,
//     and only the tiles across an edge compare each key, on 32-bit
//     positions.
//   * Epilogue: acc times the IEEE reciprocal of l + 1e-30, as bf16, into
//     the warpgroup's own rows of the Q tile (free once its last product
//     retired), in the same swizzle, then one TMA store a half, which also
//     clips rows past S; then the row stats, where asked for.
// - fp32: plain fp32 FMA on the CUDA cores (the tensor cores' TF32 keeps
//   too few digits for the 2e-5 tolerance), q pre-scaled in fp32 as the
//   reference does, 4 threads per query row, 64-query CTAs, IEEE expf and
//   division.
//
// The tensor maps are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library links no libcuda; a map that cuTensorMapEncodeTiled refuses is
// returned as an error, never sent to another body. Kernels launch on the caller's stream
// and allocate nothing; the entry point returns cudaGetLastError() so a
// refused launch is reported.

#include <cmath>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

enum MaskKind : int { kFull = 0, kWindow = 1, kChunked = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* m;  // row stats (B, S, H), or null
  float* l;
  int64_t S, T, H, KV;
  int64_t window, chunk;
  int64_t n_prefix;  // the first n_prefix positions see each other
  int kind;
  float scale;
};

// Query position i may see key position j.
__device__ __forceinline__ bool allowed(int64_t i, int64_t j,
                                        const Params& p) {
  if (j >= p.T) return false;
  if (i < p.n_prefix && j < p.n_prefix) return true;
  if (j > i) return false;
  if (p.kind == kWindow) return j > i - p.window;
  if (p.kind == kChunked) return (i / p.chunk) == (j / p.chunk);
  return true;
}

// The kv tiles [*t0, *t1) that hold a key some query in [q0, q1) may see.
__device__ __forceinline__ void kv_tiles(int64_t q0, int64_t q1,
                                         const Params& p, int64_t* t0,
                                         int64_t* t1) {
  int64_t hi = q1 < p.T ? q1 : p.T;  // keys j <= q1 - 1, j < T
  int64_t lo = 0;
  if (q0 < p.n_prefix) {  // the first row sees the whole prefix
    const int64_t np = p.n_prefix < p.T ? p.n_prefix : p.T;
    hi = hi > np ? hi : np;
  } else if (p.kind == kWindow) {
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
template <int HD>
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
    if (p.m != nullptr && part == 0) {
      p.m[(b * p.S + i) * p.H + h] = m;
      p.l[(b * p.S + i) * p.H + h] = l;
    }
  }
}

// ------------------------------------------------------------------ bf16
// The Hopper body. Tiles are kept as 64-column halves: rows of 64 bf16
// (128 bytes, one swizzle row each), 1,024-byte aligned so the 128-byte
// swizzle of TMA and of the wgmma descriptors line up.
template <int HD>
struct Tile {
  static constexpr int kConsumers = HD == 64 ? 3 : 2;  // consumer warpgroups
  static constexpr int kHalves = HD / 64;       // 64-column halves of a row
  static constexpr int kTileQ = 64 * kConsumers;  // query rows per CTA
  // keys per ring stage: 64 at hd 256, where two 128-key stages and Q
  // would not fit in one CTA's shared memory
  static constexpr int kTileK = HD == 256 ? 64 : 128;
  static constexpr int kKeySteps = kTileK / 16;   // P V k-steps a tile
  // ring stages: three at hd 64, where the templated body with two ran
  // about 11 % slower than the untemplated one it replaced (the same
  // instructions, scheduled otherwise) and a third stage took that back;
  // two at hd 128 (variants.py's three_stages ablation tries three)
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kRowBytes = 128;           // one half's row
  static constexpr int kHalfBytes = kTileK * kRowBytes;  // 16 KB
  static constexpr int kTileBytes = kHalves * kHalfBytes;  // one K or V stage
  static constexpr int kQHalfBytes = kTileQ * kRowBytes;
  static constexpr int kQBytes = kHalves * kQHalfBytes;  // Q, then the output
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kProducerRegs = 24;
  // what the producer gives up, shared among the consumers (a multiple of 8)
  static constexpr int kConsumerRegs =
      (65536 / kThreads + (65536 / kThreads - kProducerRegs) / kConsumers) /
      8 * 8;
  // shared memory from a 1,024-byte aligned base: Q, the K ring, the V
  // ring, then the barriers (q_full, k_full[], v_full[], empty[])
  static constexpr int kSmemK = kQBytes;
  static constexpr int kSmemV = kSmemK + kStages * kTileBytes;
  static constexpr int kSmemBar = kSmemV + kStages * kTileBytes;
  static constexpr int kSmemBytes = kSmemBar + (1 + 3 * kStages) * 8 + 1024;
};
static_assert(Tile<128>::kConsumerRegs == 240, "hd 128: two warpgroups");
static_assert(Tile<256>::kConsumerRegs == 240, "hd 256: two warpgroups");
static_assert(Tile<128>::kSmemBytes <= 232448, "shared memory of one CTA");
static_assert(Tile<256>::kSmemBytes <= 232448, "shared memory of one CTA");

struct TileParams {
  int S, T, H, group;  // group: query heads per KV head
  int kind, window, chunk;
  int n_prefix;  // the first n_prefix positions see each other
  int n_qtiles;
  float scale_log2;  // log2(e) / sqrt(hd)
  float* m;          // row stats (B, S, H), or null
  float* l;
};

// Query i sees keys [row_lo(i), row_hi(i)] (an empty interval when lo > hi;
// a lo below 0 reads as 0). A row below n_prefix sees the whole prefix,
// which holds its causal interval. Neither end falls as i rises.
__device__ __forceinline__ int row_lo(int i, const TileParams& p) {
  if (i < p.n_prefix) return 0;
  if (p.kind == kWindow) return i - p.window + 1;
  if (p.kind == kChunked) return (i / p.chunk) * p.chunk;
  return 0;
}

__device__ __forceinline__ int row_hi(int i, const TileParams& p) {
  const int last = i < p.n_prefix ? p.n_prefix - 1 : i;
  return last < p.T - 1 ? last : p.T - 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
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

// One box of the 4-D map (hd, heads, seq, B) at {col, head, row, b}.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(b)
      : "memory");
}

// Every 64-column half of a tile of `rows` rows (half h at dst + h * stride).
template <int HD>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, uint32_t stride,
                                              const CUtensorMap* map,
                                              uint32_t bar, int head, int row,
                                              int b) {
#pragma unroll
  for (int h = 0; h < HD / 64; ++h)
    tma_load(dst + h * stride, map, bar, 64 * h, head, row, b);
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight
// (groups retire in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across the asynchronous
// products.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int H, int N>
__device__ __forceinline__ void hold(float (&r)[H][N]) {
#pragma unroll
  for (int h = 0; h < H; ++h) hold(r[h]);
}

// d (64 x 128 fp32) = (accumulate ? d : 0) + A (64 x 16, K-major smem) *
// B (16 x 128, K-major smem: the keys' rows).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) = (accumulate ? d : 0) + A (64 x 16, K-major smem) *
// B (16 x 64, K-major smem: the keys' rows); Q K^T of a 64-key tile.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16 in registers) * B (16 x 64, MN-major
// smem: V's rows, read through the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as bf16 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout of wgmma (and of its register A operand): in warp w of a
// warpgroup, lane 4g + t holds rows 16w + g and 16w + g + 8, and in each
// 8-wide column block j the columns 8j + 2t and 8j + 2t + 1: d[4j + 0, 1]
// on the first row, d[4j + 2, 3] on the second.

// One consumer thread's two rows: the keys each sees, the running max (log2
// units) and this thread's share of the running sums.
struct Rows {
  int lo_a, hi_a, lo_b, hi_b;
  float m_a, m_b, l_a, l_b;
};

// S = Q K^T of one tile into s: hd / 16 k-steps of 16 along hd (32 bytes
// each), four a 64-column half; dq and dk step by their half's bytes.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<HD>::kTileK / 2],
                                         uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t hq = (kk / 4) * (Tile<HD>::kQHalfBytes >> 4);
    const uint64_t hk = (kk / 4) * (Tile<HD>::kHalfBytes >> 4);
    wgmma_qk(s, dq + hq + 2 * (kk % 4), dk + hk + 2 * (kk % 4), kk);
  }
  wgmma_commit();
}

// O += P V of one tile: 16 keys (2,048 bytes of a V half) a step, for each
// 64-column half of O.
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 64][32], const uint32_t (&pa)[Tile<HD>::kKeySteps][4],
    uint64_t dv) {
#pragma unroll
  for (int h = 0; h < HD / 64; ++h) {
    const uint64_t dvh = dv + h * (Tile<HD>::kHalfBytes >> 4);
#pragma unroll
    for (int c = 0; c < Tile<HD>::kKeySteps; ++c)
      wgmma_pv(o[h], pa[c], dvh + 128 * c);
  }
  wgmma_commit();
}

// The online softmax of one tile of logits s (N / 4 keys wide) at keys
// jb.. (in place: s becomes p), with the per-key mask only when `whole` is
// false. Returns the factors by which the accumulator's two rows must be
// rescaled.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], int jb, int t,
                                               bool whole, float scale_log2,
                                               Rows& r, float& al_a,
                                               float& al_b) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (!whole) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = jb + 8 * j + 2 * t + (e & 1);
        const bool ok = e < 2 ? (key >= r.lo_a && key <= r.hi_a)
                              : (key >= r.lo_b && key <= r.hi_b);
        if (!ok) s[4 * j + e] = -INFINITY;  // p = ex2(-inf) = 0
      }
    }
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  // m never falls below -1e30, so a row that sees nothing yet keeps
  // alpha = 1 and p = 0
  const float mn_a = fmaxf(r.m_a, mx_a * scale_log2);
  const float mn_b = fmaxf(r.m_b, mx_b * scale_log2);
  al_a = ex2(r.m_a - mn_a);
  al_b = ex2(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mn_a));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mn_a));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mn_b));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mn_b));
    sa0 += s[4 * j];
    sa1 += s[4 * j + 1];
    sb0 += s[4 * j + 2];
    sb1 += s[4 * j + 3];
  }
  r.l_a = r.l_a * al_a + (sa0 + sa1);
  r.l_b = r.l_b * al_b + (sb0 + sb1);
}

// Keys 16c .. 16c + 15 of p, as bf16, are the A fragment of P V's step c.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    pa[c][0] = pack_f32(s[8 * c], s[8 * c + 1]);
    pa[c][1] = pack_f32(s[8 * c + 2], s[8 * c + 3]);
    pa[c][2] = pack_f32(s[8 * c + 4], s[8 * c + 5]);
    pa[c][3] = pack_f32(s[8 * c + 6], s[8 * c + 7]);
  }
}

// A row's stats in the reference's units: m of the scaled logits (m is
// kept in log2 units here), l as it stands; a row that saw nothing keeps
// the reference's m = -1e30.
__device__ __forceinline__ void store_stats(const TileParams& p, int b, int h,
                                            int i, float m_log2, float l) {
  if (p.m == nullptr || i >= p.S) return;
  const int64_t at = (static_cast<int64_t>(b) * p.S + i) * p.H + h;
  p.m[at] = m_log2 <= kNegInf ? kNegInf : m_log2 * kLn2;
  p.l[at] = l;
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const TileParams p) {
  using C = Tile<HD>;
  constexpr int kTileQ = C::kTileQ;
  constexpr int kTileK = C::kTileK;
  constexpr int kStages = C::kStages;
  constexpr int kTileBytes = C::kTileBytes;
  constexpr int kRowBytes = C::kRowBytes;
  constexpr int kSmemK = C::kSmemK;
  constexpr int kSmemV = C::kSmemV;
  constexpr int kHalves = C::kHalves;
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t base = (smem_u32(smem_ring) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar_q = base + C::kSmemBar;
  const uint32_t bar_k = bar_q + 8;            // k_full[kStages]
  const uint32_t bar_v = bar_k + 8 * kStages;  // v_full[kStages]
  const uint32_t bar_e = bar_v + 8 * kStages;  // empty[kStages]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kTileQ;
  const int kvh = h / p.group;
  const int q_last = (q0 + kTileQ < p.S ? q0 + kTileQ : p.S) - 1;
  const int lo = max(row_lo(q0, p), 0);
  const int hi = row_hi(q_last, p);
  const int t0 = lo / kTileK;
  const int n_tiles = hi >= lo ? hi / kTileK + 1 - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, C::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
      tma_load_tile<HD>(sq, C::kQHalfBytes, &tm_q, bar_q, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_e + 8 * s, ((it / kStages) & 1) ^ 1);
        const int jb = (t0 + it) * kTileK;
        mbar_expect_tx(bar_k + 8 * s, kTileBytes);
        tma_load_tile<HD>(base + kSmemK + s * kTileBytes, C::kHalfBytes,
                          &tm_k, bar_k + 8 * s, kvh, jb, b);
        mbar_expect_tx(bar_v + 8 * s, kTileBytes);
        tma_load_tile<HD>(base + kSmemV + s * kTileBytes, C::kHalfBytes,
                          &tm_v, bar_v + 8 * s, kvh, jb, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + cw * 64;
    const int ia = r0 + warp * 16 + g;
    Rows r;
    r.lo_a = row_lo(ia, p);
    r.hi_a = row_hi(ia, p);
    r.lo_b = row_lo(ia + 8, p);
    r.hi_b = row_hi(ia + 8, p);
    r.m_a = r.m_b = kNegInf;
    r.l_a = r.l_b = 0.f;
    // keys some row of the warpgroup sees, and keys every row of it sees
    // (lo and hi do not fall as the row rises)
    const int some_lo = max(row_lo(r0, p), 0), some_hi = row_hi(r0 + 63, p);
    const int every_lo = row_lo(r0 + 63, p), every_hi = row_hi(r0, p);
    // the CTA's tiles [first, last) that this warpgroup computes; none when
    // every one of its rows lies past S
    int first = 0, last = 0;
    if (r0 < p.S && some_lo <= some_hi) {
      first = max(some_lo / kTileK - t0, 0);
      last = max(min(some_hi / kTileK + 1 - t0, n_tiles), first);
    }
    // this warpgroup's rows of Q's first half
    const uint32_t sq_rows = sq + cw * 64 * kRowBytes;
    const uint64_t dq = sw128_desc(sq_rows, 16, 1024);
    // K is K-major like Q; V is MN-major, where a half's N = 64 is one
    // swizzle atom wide and both byte offsets are the 1,024 between 8-row
    // groups
    auto k_desc = [&](int st) {
      return sw128_desc(base + kSmemK + st * kTileBytes, 16, 1024);
    };
    auto v_desc = [&](int st) {
      return sw128_desc(base + kSmemV + st * kTileBytes, 1024, 1024);
    };
    auto parity = [](int it) { return static_cast<uint32_t>(it / kStages) & 1; };
    auto whole = [&](int it) {
      const int jb = (t0 + it) * kTileK;
      return every_lo <= jb && jb + kTileK - 1 <= every_hi;
    };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * (it % kStages));
    };

    auto pass = [&](int it) {  // a tile none of this warpgroup's rows sees
      mbar_wait(bar_k + 8 * (it % kStages), parity(it));
      mbar_wait(bar_v + 8 * (it % kStages), parity(it));
      release(it);
    };

    float o[kHalves][32];
    float s[kTileK / 2];
    uint32_t pa[C::kKeySteps][4];
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTileK / 2; ++i) s[i] = 0.f;
    float al_a, al_b;
    auto rescale = [&] {
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[hh][4 * n] *= al_a;
          o[hh][4 * n + 1] *= al_a;
          o[hh][4 * n + 2] *= al_b;
          o[hh][4 * n + 3] *= al_b;
        }
    };

    mbar_wait(bar_q, 0);
    for (int it = 0; it < first; ++it) pass(it);
    if (first < last) {
      mbar_wait(bar_k + 8 * (first % kStages), parity(first));
      wgmma_fence();
      issue_qk<HD>(s, dq, k_desc(first % kStages));
      wgmma_wait<0>();
      hold(s);
      online_softmax(s, (t0 + first) * kTileK, t, whole(first), p.scale_log2,
                     r, al_a, al_b);  // o is still 0: nothing to rescale
      pack_p(pa, s);
      // Q K^T of tile it is issued with P V of tile it - 1, whose product
      // runs on while this warpgroup takes tile it's softmax
      for (int it = first + 1; it < last; ++it) {
        mbar_wait(bar_k + 8 * (it % kStages), parity(it));
        mbar_wait(bar_v + 8 * ((it - 1) % kStages), parity(it - 1));
        hold(o);
        wgmma_fence();
        issue_qk<HD>(s, dq, k_desc(it % kStages));
        issue_pv<HD>(o, pa, v_desc((it - 1) % kStages));
        wgmma_wait<1>();  // S of tile it; P V of tile it - 1 still runs
        hold(s);
        online_softmax(s, (t0 + it) * kTileK, t, whole(it), p.scale_log2, r,
                       al_a, al_b);
        wgmma_wait<0>();
        hold(o);
        release(it - 1);
        rescale();
        pack_p(pa, s);
      }
      mbar_wait(bar_v + 8 * ((last - 1) % kStages), parity(last - 1));
      hold(o);
      wgmma_fence();
      issue_pv<HD>(o, pa, v_desc((last - 1) % kStages));
      wgmma_wait<0>();
      hold(o);
      release(last - 1);
    }
    for (int it = last; it < n_tiles; ++it) pass(it);

    float l_a = r.l_a, l_b = r.l_b;
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    if (r0 < p.S) {
      const float inv_a = 1.f / (l_a + kTiny), inv_b = 1.f / (l_b + kTiny);
      const int ra = warp * 16 + g;  // rows ra and ra + 8 share ra % 8 = g
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) {
        const uint32_t rows = sq_rows + hh * C::kQHalfBytes;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const uint32_t col = static_cast<uint32_t>(((n ^ g) << 4) + 4 * t);
          const uint32_t va =
              pack_f32(o[hh][4 * n] * inv_a, o[hh][4 * n + 1] * inv_a);
          const uint32_t vb =
              pack_f32(o[hh][4 * n + 2] * inv_b, o[hh][4 * n + 3] * inv_b);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(rows + ra * kRowBytes +
                                                        col),
                       "r"(va)
                       : "memory");
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           rows + (ra + 8) * kRowBytes + col),
                       "r"(vb)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if ((ct & 127) == 0) {
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          tma_store(&tm_o, sq_rows + hh * C::kQHalfBytes, 64 * hh, h, r0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      if (t == 0) {
        store_stats(p, b, h, ia, r.m_a, l_a);
        store_stats(p, b, h, ia + 8, r.m_b, l_b);
      }
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function), looked up once through the
// runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor (B, len, heads, hd) as the 4-D map (hd, heads, len, B) with
// boxes of `rows` rows of 64 columns of one head, 128-byte swizzled; reads
// past len give zeros.
bool rows_map(CUtensorMap* map, const void* base, int64_t hd, int64_t heads,
              int64_t len, int64_t B, uint32_t rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd * 2);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row_bytes,
                                 static_cast<cuuint64_t>(heads) * row_bytes,
                                 static_cast<cuuint64_t>(len * heads) *
                                     row_bytes};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const Params& p, int64_t B, cudaStream_t st) {
  using C = Tile<HD>;
  // 32-bit positions, and the query tiles on grid.z
  constexpr int64_t kMaxLen = int64_t{1} << 30;
  const int64_t n_qtiles = (p.S + C::kTileQ - 1) / C::kTileQ;
  if (p.S > kMaxLen || p.T > kMaxLen || n_qtiles > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  if (!rows_map(&tq, p.q, HD, p.H, p.S, B, C::kTileQ) ||
      !rows_map(&tk, p.k, HD, p.KV, p.T, B, C::kTileK) ||
      !rows_map(&tv, p.v, HD, p.KV, p.T, B, C::kTileK) ||
      !rows_map(&to, p.out, HD, p.H, p.S, B, 64))
    return cudaErrorInvalidValue;
  TileParams tp;
  tp.S = static_cast<int>(p.S);
  tp.T = static_cast<int>(p.T);
  tp.H = static_cast<int>(p.H);
  tp.group = static_cast<int>(p.H / p.KV);
  tp.kind = p.kind;
  // a window <= 0 sees nothing, one past every position sees everything
  tp.window = static_cast<int>(
      p.window < 0 ? 0 : (p.window > kMaxLen ? kMaxLen : p.window));
  tp.chunk = static_cast<int>(p.chunk > kMaxLen ? kMaxLen : p.chunk);
  tp.n_prefix = static_cast<int>(p.n_prefix > kMaxLen ? kMaxLen : p.n_prefix);
  tp.n_qtiles = static_cast<int>(n_qtiles);
  tp.scale_log2 = static_cast<float>(1.4426950408889634 /
                                     std::sqrt(static_cast<double>(HD)));
  tp.m = p.m;
  tp.l = p.l;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (rc != cudaSuccess) return rc;
  // heads fastest, then batch, then the query tiles longest first
  const dim3 grid(static_cast<unsigned>(p.H), static_cast<unsigned>(B),
                  static_cast<unsigned>(n_qtiles));
  flash_fwd_bf16<HD><<<grid, C::kThreads, C::kSmemBytes, st>>>(tq, tk, tv, to,
                                                              tp);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, int64_t B, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((p.S + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(B));
  const int smem = (3 * kBlockQ * (HD + 1) + kBlockQ * (kBlockK + 1)) * 4;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  flash_fwd_f32<HD><<<grid, 256, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, hd), k/v: (B, T, KV, hd), out: (B, S, H * hd), all contiguous
// and 16-byte aligned, of one dtype: bf16 when is_bf16, else fp32; m and l
// fp32 (B, S, H) for the row stats, or both null. kind: 0 full, 1 window,
// 2 chunked; n_prefix >= 0 (0: no prefix). hd must be 64, 128 or 256.
extern "C" int ckpt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* m, void* l,
    int64_t B, int64_t S, int64_t T, int64_t H, int64_t KV, int64_t hd,
    int64_t is_bf16, int64_t kind, int64_t window, int64_t chunk,
    int64_t n_prefix, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || T < 1 || H < 1 || H > 65535 || KV < 1 ||
      H % KV != 0 || kind < kFull || kind > kChunked ||
      (kind == kChunked && chunk < 1) || (m == nullptr) != (l == nullptr) ||
      n_prefix < 0 || (hd != 64 && hd != 128 && hd != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.S = S;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.window = window;
  p.chunk = chunk;
  p.n_prefix = n_prefix;
  p.kind = static_cast<int>(kind);
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (hd == 64)
    rc = is_bf16 != 0 ? launch_bf16<64>(p, B, st) : launch_f32<64>(p, B, st);
  else if (hd == 128)
    rc = is_bf16 != 0 ? launch_bf16<128>(p, B, st) : launch_f32<128>(p, B, st);
  else
    rc = is_bf16 != 0 ? launch_bf16<256>(p, B, st) : launch_f32<256>(p, B, st);
  return static_cast<int>(rc);
}


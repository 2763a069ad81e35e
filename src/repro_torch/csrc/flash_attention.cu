// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas. Same function: blocked online-softmax attention
// with f32 running max, running sum and accumulator; masks for padded keys
// (kv_len), causal and sliding window (window > 0); tiles with no live
// (query, key) pair are skipped; scale 1/sqrt(D).
//
// What differs from the TPU kernel, for the GPU:
//   * No padding of S or D: each block masks the ragged edge itself.
//   * GQA through the index (kv head = h / (H / Hkv)); K/V are not repeated.
//   * Strided inputs: the model calls it on [B, S, H, D] views.
//   * One block owns BQ query rows of one (batch, head) and loops over the
//     K/V tiles in its own live range; nothing carries over between blocks.
//
// What bounds it: at the serving shape (B=8, H=32, Hkv=8, S=512, D=64, bf16,
// causal) the function must move 42 MB (q and o 16.8 MB each, k and v 4.2 MB
// each), 12.5 us at 3.35 TB/s; do 8.6 GFLOP of causal products, 8.7 us at
// the bf16 tensor-core peak; and take one exp2 for each of the 33.6 M live
// scores, about 8 us at 16 a clock on each of the 132 SMs (1.98 GHz). The
// three floors are close, so copies, products and the softmax must overlap.
//
// Three bodies (simt in two kernels), chosen by the caller
// (kernels/flash_attention/kernel.py):
//   * flash_fwd_wgmma (bf16; pointers 16-byte aligned, batch/seq/head
//     strides multiples of 8 elements, D a multiple of 8 up to 256: TMA's
//     rules). A block owns 128 query rows, two warpgroups of 64. Bytes: TMA
//     copies (Q once, K and V through a two-stage ring with a full mbarrier
//     a stage and tensor), issued by one thread, so no thread spends
//     registers or instructions on loads and tile j+1 lands while tile j
//     is multiplied; the tensor maps zero-fill past S and D, so ragged
//     edges need no masked loads; 128-row blocks re-read K/V from L2 half
//     as often as 64-row ones. No producer warp: its registers would keep
//     the second block off the SM at D <= 64 (measured slower). Products:
//     wgmma m64n128k16 (m64n64k16 at D > 128, whose 64-key tiles keep the
//     score tile, P and a 256-wide O in registers) for S = Q K^T with both
//     operands in 128-byte-swizzled shared memory, and m64n64k16 a 64-column
//     box of V for O += P V with P from registers and V read MN-major
//     through the descriptor's transpose bit (no copy of V^T).
//     exp: the softmax stays in the exp2 domain with the scale folded into
//     one FMA a score, masks only the tiles that hold a diagonal, the kv_len
//     edge or the window edge, and four warpgroups an SM (two blocks at
//     D <= 64) let one warpgroup's exp2 run under another's products.
//     Causal q-tiles are issued heaviest first.
//   * flash_fwd_mma (bf16, any layout, e.g. D = 100 or unaligned views, and
//     every D > 256): mma.sync m16n8k16 tensor-core products, one warp per
//     16 query rows, loads through registers. D is zero-padded to DP = 64,
//     128 or 256. At DP = 256 a warp's output accumulator alone takes 128
//     registers a thread, so its Q fragments are read from shared memory at
//     each k-step instead of being held (64 registers more would spill).
//   * flash_fwd_simt (f32, D <= 256): products in f32 FMA on the CUDA
//     cores, so an f32 call stays within f32 rounding of the reference
//     (tensor-core TF32 would not). Bound: at the training shape (the
//     serving shape in f32) 8.6 GFLOP of causal products, 128 us at the
//     67 TFLOP/s FFMA peak, against 84 MB of bytes (25 us): operations.
//     That peak is 4 FFMA warp-instructions a clock on each SM, and shared
//     memory serves one 128-byte wavefront a clock, so both products are
//     register-tiled outer products: at D <= 64 a thread holds 4 rows x 8
//     keys of S and 4 rows x 8 dims of O, and a step of four dims of QK^T
//     is 4 (broadcast) loads of Q^T and 8 of K, 16 bytes each, for 128
//     FFMAs; a key of PV is one load of P^T and two of V for 32 FFMAs.
//     A block owns 64 query rows; the threads of a row sit in one warp, so
//     its max and sum reduce by shuffles (the sum once, at the end) and
//     P^T passes through shared memory within the warp. Bytes: K and V by
//     cp.async, 16-byte copies where bases and strides allow, 4-byte ones
//     where they do not, zero fill past S and D; Q^T staged once, scaled.
//     Causal q-tiles are issued heaviest first. SCfg gives each D its
//     thread tile, stages (a two-stage ring, or V's copy under QK^T and
//     the next K's under PV) and shared-memory budget.
//   * flash_fwd_simt_sliced (f32, D > 256): a warp owns 8 query rows, a
//     lane 8 output dims of a slice.
// D > 256 (mma and simt): a block a slice of 256 output columns, scoring
// over the whole of D in chunks of 256 (see n_slices); exact and slow. The
// reference pads D to any multiple of 128; no configuration of the repo
// has a head dim above 256.
// The tensor-core bodies cast P to bf16 before the PV product, as the
// reference casts probabilities to v.dtype.
//
// C entry point flash_attention_fwd returns cudaErrorInvalidValue when the
// body asked for cannot take the call, else cudaGetLastError() after the
// launch; the Python wrapper raises on anything but 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, S, D;
  int qsb, qss, qsh;  // element strides over (batch, seq, head); dim stride 1
  int ksb, kss, ksh;
  int vsb, vss, vsh;
  int osb, oss, osh;
  int causal, window, kv_lim;
  float scale_log2;  // 1/sqrt(D) * log2(e): scores live in the exp2 domain
};

__device__ __forceinline__ bool live(const Args& a, int qi, int kj) {
  return kj < a.kv_lim && (!a.causal || kj <= qi) &&
         (a.window <= 0 || qi - kj < a.window);
}

// Key tiles [start, end) that hold a live pair for query rows [q0, q0 + bq).
__device__ __forceinline__ void kv_range(const Args& a, int q0, int bq, int bk,
                                         int* start, int* end) {
  int e = a.kv_lim;
  if (a.causal) e = min(e, q0 + bq);
  int s = 0;
  if (a.window > 0) s = max(0, q0 - a.window + 1) / bk * bk;
  *start = s;
  *end = e;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int CHUNK = 256;     // D > CHUNK: scores over chunks of D, O in slices
constexpr int W_DMAX = 256;    // the wgmma body's shared memory

// Blocks over the output's columns: one for D <= CHUNK, else one a slice
// of CHUNK columns of V and O (mma and the sliced simt body).
int n_slices(int D) { return D <= CHUNK ? 1 : (D + CHUNK - 1) / CHUNK; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// SIMT body: f32 FMA products, register-tiled, cp.async ring (D <= 256)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's latest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One configuration of the f32 body, for D <= DP (64, 128 or 256). A block
// owns BQ query rows of one (batch, head) and loops over K/V tiles of BK =
// 64 keys. Its threads form BQ / TM row groups of CG lanes: thread (rg, cg)
// holds the scores of rows TM rg + r and keys cg + CG c (r < TM, c < TN =
// BK / CG) and the outputs of rows TM rg + r and dims 4 cg + 4 CG i + u (i <
// NV, u < 4). A row group is CG lanes of one warp, so its max and sum reduce
// by shuffles and its P^T rows stay in the warp. Shared memory (floats): Q^T
// [DP][BQ] (scaled), K [STAGES][BK][KP], V [STAGES][BK][DP], P^T [BK][PP].
// Pitches of DP + 4 and BQ + 4 floats put what a warp reads or writes at
// once (K's rows cg + CG c; P^T's row groups) in distinct banks.
template <int DP_, int STAGES_, int TM_, int CG_, int BQ_>
struct SCfg {
  static constexpr int DP = DP_, STAGES = STAGES_, TM = TM_, CG = CG_, BQ = BQ_;
  static constexpr int BK = 64, THREADS = BQ / TM * CG, TN = BK / CG;
  static constexpr int NV = DP / (4 * CG);   // 4-dim chunks of O a thread
  static constexpr int QP = BQ, KP = DP + 4, VP = DP, PP = BQ + 4;
  static constexpr int q = 0;
  static constexpr int k = q + DP * QP;
  static constexpr int v = k + STAGES * BK * KP;
  static constexpr int p = v + STAGES * BK * VP;
  static constexpr int smem = 4 * (p + BK * PP);
  // blocks an SM by its 228 KB of shared memory (1 KB reserved a block);
  // the launch bound caps registers so that as many fit
  static constexpr int min_blocks = 228 * 1024 / (smem + 1024);
  static_assert(TM % 4 == 0 && 32 % CG == 0 && DP % (4 * CG) == 0 &&
                    THREADS % 32 == 0 && BQ * DP / 4 % THREADS == 0 &&
                    BK * DP / 4 % THREADS == 0 && min_blocks >= 1,
                "simt configuration");
};

// The configurations by D. DP = 64: 4 x 8 thread tiles, 128 threads, one
// stage: 66 KB, three blocks (twelve warps) an SM at up to 168 registers a
// thread; two stages (99 KB, two blocks) and 256-thread 4 x 16 tiles
// measured slower (tools/flash_variants.py). DP = 128: 4 x 16 tiles, two
// stages, 179 KB; DP = 256: one stage, 210 KB; one block an SM each.
using S64 = SCfg<64, 1, 4, 8, 64>;
using S128 = SCfg<128, 2, 4, 16, 64>;
using S256 = SCfg<256, 1, 4, 16, 64>;

// Rows [s0, s0 + BK) of one head's [S, D] slice (row stride ss) into a
// [BK][pitch] tile by cp.async; zero past S and D. vec4: 16-byte copies (a
// row's last one shortened at D), else 4-byte ones.
template <int DP, int BK, int THREADS>
__device__ __forceinline__ void copy_tile(uint32_t dst, int pitch,
                                          const float* src, int ss, int s0,
                                          int S, int D, bool vec4) {
  if (vec4) {
    // a thread copies the same 4 dims of rows r0, r0 + RS, ...
    constexpr int CH = DP / 4, RS = THREADS / CH;
    static_assert(THREADS % CH == 0 && BK % RS == 0, "copy layout");
    const int r0 = threadIdx.x / CH, d = threadIdx.x % CH * 4;
    const int dbytes = 4 * max(0, min(4, D - d));   // 0 past D
    const float* row = dbytes ? src + (size_t)(s0 + r0) * ss + d : src;
    const size_t step = dbytes ? (size_t)RS * ss : 0;
    dst += 4u * (r0 * pitch + d);
    if (s0 + BK <= S) {  // every row of the tile inside S
#pragma unroll
      for (int n = 0; n < BK / RS; ++n)
        cp_async16(dst + 4u * (n * RS * pitch), row + n * step, dbytes);
    } else {
#pragma unroll
      for (int n = 0; n < BK / RS; ++n) {
        const bool in = s0 + r0 + n * RS < S;
        cp_async16(dst + 4u * (n * RS * pitch), in ? row + n * step : src,
                   in ? dbytes : 0);
      }
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < BK * DP / THREADS; ++n) {
      const int i = threadIdx.x + n * THREADS;
      const int r = i / DP, d = i % DP, s = s0 + r;
      const bool in = s < S && d < D;
      cp_async4(dst + 4u * (r * pitch + d),
                in ? src + (size_t)s * ss + d : src, in ? 4 : 0);
    }
  }
}

// Grid (H, B, q-tiles), q-tiles from the last (the heaviest when causal).
// STAGES = 2: tile j + 1 is copied while tile j is multiplied, one block
// barrier a tile. STAGES = 1: K and V copied apart (V of tile j under its
// QK^T, K of tile j + 1 under its PV), three barriers a tile.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::min_blocks)
    flash_fwd_simt(Args a, int vec4) {
  constexpr int DP = C::DP, STAGES = C::STAGES, TM = C::TM, CG = C::CG;
  constexpr int BQ = C::BQ, BK = C::BK, TN = C::TN, NV = C::NV;
  extern __shared__ __align__(16) float s_smem[];
  float* Qs = s_smem + C::q;
  float* Ks = s_smem + C::k;
  float* Vs = s_smem + C::v;
  float* Ps = s_smem + C::p;
  const uint32_t sK = smem_u32(Ks), sV = smem_u32(Vs);

  const int tid = threadIdx.x, rg = tid / CG, cg = tid % CG;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (a.H / a.Hkv);
  const float* q = static_cast<const float*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const float* k = static_cast<const float*>(a.k) + (size_t)b * a.ksb + (size_t)hk * a.ksh;
  const float* v = static_cast<const float*>(a.v) + (size_t)b * a.vsb + (size_t)hk * a.vsh;
  float* o = static_cast<float*>(a.o) + (size_t)b * a.osb + (size_t)h * a.osh;

  int kv_start, kv_end;
  kv_range(a, q0, BQ, BK, &kv_start, &kv_end);
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + BK - 1) / BK : 0;
  auto copy_k = [&](int it) {
    copy_tile<DP, BK, C::THREADS>(sK + 4u * ((it % STAGES) * BK * C::KP), C::KP,
                                  k, a.kss, kv_start + it * BK, a.S, a.D, vec4);
  };
  auto copy_v = [&](int it) {
    copy_tile<DP, BK, C::THREADS>(sV + 4u * ((it % STAGES) * BK * C::VP), C::VP,
                                  v, a.vss, kv_start + it * BK, a.S, a.D, vec4);
  };
  if (n_tiles > 0) {
    copy_k(0);
    if (STAGES > 1) copy_v(0);
    cp_async_commit();
  }

  // Q^T, scaled into the exp2 domain, while the first tile lands: every
  // load issued before the first store
  constexpr int NQ = BQ * DP / 4 / C::THREADS;   // 4-dim pieces a thread
  float x[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int i = tid + n * C::THREADS, r = i % BQ, d = i / BQ * 4, s = q0 + r;
    x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    if (s < a.S) {
      const float* row = q + (size_t)s * a.qss + d;
      if (vec4 && d + 4 <= a.D) {
        const float4 t = *reinterpret_cast<const float4*>(row);
        x[n][0] = t.x; x[n][1] = t.y; x[n][2] = t.z; x[n][3] = t.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) x[n][u] = d + u < a.D ? row[u] : 0.f;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int i = tid + n * C::THREADS, r = i % BQ, d = i / BQ * 4;
#pragma unroll
    for (int u = 0; u < 4; ++u) Qs[(d + u) * C::QP + r] = x[n][u] * a.scale_log2;
  }

  float m[TM], l[TM], acc[TM][4 * NV];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this thread's share of the row's sum
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[r][c] = 0.f;
  }
  const float* Qr = Qs + TM * rg;
  float* Pw = Ps + TM * rg;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kv_start + it * BK;
    const float* Kt = Ks + (it % STAGES) * BK * C::KP;
    const float* Vt = Vs + (it % STAGES) * BK * C::VP;
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) visible; tile it - 1 consumed
    if constexpr (STAGES > 1) {
      if (it + 1 < n_tiles) {
        copy_k(it + 1);
        copy_v(it + 1);
      }
    } else {
      copy_v(it);
    }
    cp_async_commit();

    // S = Q K^T: TN 16-byte loads of K and TM of Q^T for 4 TM TN FFMAs
    float sc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; d += 4) {
      float qv[4][TM];  // Q^T of dims d .. d + 3
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int x = 0; x < TM; x += 4) {
          const float4 t = *reinterpret_cast<const float4*>(Qr + (d + u) * C::QP + x);
          qv[u][x] = t.x; qv[u][x + 1] = t.y; qv[u][x + 2] = t.z; qv[u][x + 3] = t.w;
        }
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float4 t = *reinterpret_cast<const float4*>(Kt + (cg + CG * c) * C::KP + d);
        const float kv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < TM; ++r) sc[r][c] = fmaf(qv[u][r], kv[u], sc[r][c]);
      }
    }

    // masks only where the tile meets the diagonal, the kv_len (or S) edge
    // or the window's far edge
    if (kt + BK > a.kv_lim || (a.causal && kt + BK - 1 > q0) ||
        (a.window > 0 && q0 + BQ - 1 - kt >= a.window)) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (!live(a, q0 + TM * rg + r, kt + cg + CG * c)) sc[r][c] = -INFINITY;
    }

    // online softmax over the row group's CG lanes; P^T into shared memory
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float mx = sc[r][0];
#pragma unroll
      for (int c = 1; c < TN; ++c) mx = fmaxf(mx, sc[r][c]);
#pragma unroll
      for (int x = 1; x < CG; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[r], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
      const float alpha = ex2(m[r] - mu);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        sc[r][c] = ex2(sc[r][c] - mu);
        l[r] += sc[r][c];
      }
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < TN; ++c)
#pragma unroll
      for (int x = 0; x < TM; x += 4)
        *reinterpret_cast<float4*>(Pw + (cg + CG * c) * C::PP + x) =
            make_float4(sc[x][c], sc[x + 1][c], sc[x + 2][c], sc[x + 3][c]);

    if constexpr (STAGES == 1) {
      __syncthreads();  // K of tile it consumed
      if (it + 1 < n_tiles) copy_k(it + 1);
      cp_async_commit();
      cp_async_wait<1>();  // V of tile it landed
      __syncthreads();
    } else {
      __syncwarp();     // the row groups' P^T rows written
    }

    // O += P V: TM / 4 + NV 16-byte loads for 4 TM NV FFMAs a key
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pr[TM];
#pragma unroll
      for (int x = 0; x < TM; x += 4) {
        const float4 t = *reinterpret_cast<const float4*>(Pw + j * C::PP + x);
        pr[x] = t.x; pr[x + 1] = t.y; pr[x + 2] = t.z; pr[x + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vt + j * C::VP + 4 * CG * i + 4 * cg);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          acc[r][4 * i] = fmaf(pr[r], vv.x, acc[r][4 * i]);
          acc[r][4 * i + 1] = fmaf(pr[r], vv.y, acc[r][4 * i + 1]);
          acc[r][4 * i + 2] = fmaf(pr[r], vv.z, acc[r][4 * i + 2]);
          acc[r][4 * i + 3] = fmaf(pr[r], vv.w, acc[r][4 * i + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int x = 1; x < CG; x <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], x);
    const int row = q0 + TM * rg + r;
    if (row >= a.S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no live key: 0
    float* orow = o + (size_t)row * a.oss;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = 4 * CG * i + 4 * cg;
      if (vec4 && d + 4 <= a.D) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[r][4 * i] * inv, acc[r][4 * i + 1] * inv,
                        acc[r][4 * i + 2] * inv, acc[r][4 * i + 3] * inv);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (d + u < a.D) orow[d + u] = acc[r][4 * i + u] * inv;
      }
    }
  }
}

// Shared memory above 48 KB needs the attribute, set on the current device
// before each launch (cheap, and right for whichever device is current).
template <class C>
cudaError_t launch_simt(const Args& a, int vec4, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_simt<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, a.B, (a.S + C::BQ - 1) / C::BQ);
  flash_fwd_simt<C><<<grid, C::THREADS, C::smem, stream>>>(a, vec4);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SIMT body past D = 256: a block a slice of CHUNK output columns
// ---------------------------------------------------------------------------

constexpr int S_BQ = 32;                 // query rows per block
constexpr int S_BK = 64;                 // keys per tile: two per lane
constexpr int S_WARPS = 4;
constexpr int S_RPW = S_BQ / S_WARPS;    // query rows per warp
constexpr int S_DCH = CHUNK / 32;        // output dims per lane

// Qs [BQ][CHUNK], Kt [CHUNK][BK+1] (transposed, padded: conflict-free both
// ways), Vs [BK][CHUNK], Ps [warps][rows][BK]: 169 KB, one block an SM.
constexpr size_t sliced_smem() {
  return sizeof(float) * (size_t)(S_BQ * CHUNK + CHUNK * (S_BK + 1) +
                                  S_BK * CHUNK + S_WARPS * S_RPW * S_BK);
}

// blockIdx.y = slice * H + head. Each block scores over the whole of D,
// restaging Q and K a chunk of CHUNK dims at a time: exact, and it repeats
// the scores once a slice (no configuration of the repo has D > 256; the
// reference pads D to any multiple of 128).
__global__ void __launch_bounds__(S_WARPS * 32) flash_fwd_simt_sliced(Args a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const int n_ch = (D + CHUNK - 1) / CHUNK;
  float* Qs = smem;
  float* Kt = Qs + S_BQ * CHUNK;
  float* Vs = Kt + CHUNK * (S_BK + 1);
  float* Ps = Vs + S_BK * CHUNK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * S_BQ, b = blockIdx.z;
  const int h = blockIdx.y % a.H;
  const int d0 = blockIdx.y / a.H * CHUNK;  // this block's columns
  const int DV = min(CHUNK, D - d0);
  const int hk = h / (a.H / a.Hkv);
  const float* q = static_cast<const float*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const float* k = static_cast<const float*>(a.k) + (size_t)b * a.ksb + (size_t)hk * a.ksh;
  const float* v = static_cast<const float*>(a.v) + (size_t)b * a.vsb + (size_t)hk * a.vsh + d0;
  float* o = static_cast<float*>(a.o) + (size_t)b * a.osb + (size_t)h * a.osh + d0;

  int kv_start, kv_end;
  kv_range(a, q0, S_BQ, S_BK, &kv_start, &kv_end);

  const int r0 = warp * S_RPW;
  float m[S_RPW], l[S_RPW], acc[S_RPW][S_DCH];
#pragma unroll
  for (int r = 0; r < S_RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < S_DCH; ++c) acc[r][c] = 0.f;
  }
  float* P = Ps + r0 * S_BK;

  for (int kt = kv_start; kt < kv_end; kt += S_BK) {
    float s0[S_RPW], s1[S_RPW];
#pragma unroll
    for (int r = 0; r < S_RPW; ++r) s0[r] = s1[r] = 0.f;
    for (int c = 0; c < n_ch; ++c) {  // the scores over chunks of D
      __syncthreads();  // previous chunk or tile consumed
      // chunk c of Q (scaled) and of K (transposed), zero past S and D
      for (int i = tid; i < S_BQ * CHUNK; i += blockDim.x) {
        const int r = i / CHUNK, d = i - r * CHUNK, s = q0 + r;
        const int dd = c * CHUNK + d;
        Qs[i] = s < a.S && dd < D ? q[(size_t)s * a.qss + dd] * a.scale_log2 : 0.f;
      }
      for (int i = tid; i < S_BK * CHUNK; i += blockDim.x) {
        const int j = i / CHUNK, d = i - j * CHUNK, s = kt + j;
        const int dd = c * CHUNK + d;
        Kt[d * (S_BK + 1) + j] = s < a.S && dd < D ? k[(size_t)s * a.kss + dd] : 0.f;
      }
      if (c == 0) {  // V's slice once
        for (int i = tid; i < S_BK * CHUNK; i += blockDim.x) {
          const int j = i / CHUNK, d = i - j * CHUNK, s = kt + j;
          Vs[i] = s < a.S && d < DV ? v[(size_t)s * a.vss + d] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < CHUNK; ++d) {
        const float k0 = Kt[d * (S_BK + 1) + lane];
        const float k1 = Kt[d * (S_BK + 1) + lane + 32];
#pragma unroll
        for (int r = 0; r < S_RPW; ++r) {
          const float qd = Qs[(r0 + r) * CHUNK + d];
          s0[r] = fmaf(qd, k0, s0[r]);
          s1[r] = fmaf(qd, k1, s1[r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < S_RPW; ++r) {
      const int qi = q0 + r0 + r;
      if (!live(a, qi, kt + lane)) s0[r] = -INFINITY;
      if (!live(a, qi, kt + lane + 32)) s1[r] = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0[r], s1[r])));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(s0[r] - m_use), p1 = exp2f(s1[r] - m_use);
      const float alpha = exp2f(m[r] - m_use);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < S_DCH; ++c) acc[r][c] *= alpha;
      P[r * S_BK + lane] = p0;
      P[r * S_BK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < S_BK; ++j) {
      float vv[S_DCH];
#pragma unroll
      for (int c = 0; c < S_DCH; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < DV ? Vs[j * CHUNK + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < S_RPW; ++r) {
        const float p = P[r * S_BK + j];
#pragma unroll
        for (int c = 0; c < S_DCH; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < S_RPW; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= a.S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no live key: 0
#pragma unroll
    for (int c = 0; c < S_DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < DV) o[(size_t)qi * a.oss + d] = acc[r][c] * inv;
    }
  }
}

cudaError_t launch_simt_sliced(const Args& a, cudaStream_t stream) {
  const size_t smem = sliced_smem();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_simt_sliced, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + S_BQ - 1) / S_BQ, a.H * n_slices(a.D), a.B);
  flash_fwd_simt_sliced<<<grid, S_WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core body: bf16 mma.sync m16n8k16, f32 accumulate
// ---------------------------------------------------------------------------

constexpr int M_BQ = 64;       // query rows per block: 16 per warp
constexpr int M_BK = 64;       // keys per tile
constexpr int M_WARPS = 4;

// Tiles are [rows][DP + 8] bf16: D zero-padded to DP (a multiple of 16, the
// mma depth), and 8 more so that the fragment loads of one warp hit 32
// distinct banks. DP = 256 takes (64 + 2 * 64) * 264 * 2 = 101,376 bytes.
template <int DP>
size_t mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(M_BQ + 2 * M_BK) * (DP + 8);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 in one register, the first in the low half (the mma's order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// The A fragment of k-step ks for query rows qr and qr + 8 of a [rows][LD]
// tile.
template <int LD>
__device__ __forceinline__ void q_frag(uint32_t f[4], const __nv_bfloat16* Qs,
                                       int qr, int ks, int t) {
  const __nv_bfloat16* p = Qs + qr * LD + ks * 16 + 2 * t;
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// Rows [r0, r0 + rows) of one head's [S, D] slice (row stride ss) into a
// [rows][DP + 8] tile; zero past S and past D. vec8: 16-byte loads.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ss,
                                          int r0, int rows, int S, int D,
                                          bool vec8) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, d = (i - r * CH) * 8, s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && d < D) {
      const __nv_bfloat16* p = src + (size_t)s * ss + d;
      if (vec8) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
        uint16_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = d + j < D ? u[j] : (uint16_t)0;
        val = make_uint4(pack_raw(e[0], e[1]), pack_raw(e[2], e[3]),
                         pack_raw(e[4], e[5]), pack_raw(e[6], e[7]));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

// CH: D > CHUNK at DP = CHUNK, in slices of the output's columns
// (blockIdx.y = slice * H + head), Q and K staged a chunk of D at a time.
template <int DP, bool CH>
__global__ void __launch_bounds__(M_WARPS * 32)
    flash_fwd_mma(Args a, int vec8) {
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  constexpr int LD = DP + 8, KS = DP / 16, DT = DP / 8, NT = M_BK / 8;
  static_assert(!CH || DP == CHUNK, "chunks of D are CHUNK wide");
  // Q's fragments live in registers up to DP = 128, else in shared memory
  constexpr bool QREG = DP <= 128;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem_raw);
  __nv_bfloat16* Ks = Qs + M_BQ * LD;
  __nv_bfloat16* Vs = Ks + M_BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * M_BQ, b = blockIdx.z;
  const int h = CH ? blockIdx.y % a.H : blockIdx.y;
  const int d0 = CH ? blockIdx.y / a.H * CHUNK : 0;  // this block's columns
  const int DV = CH ? min(CHUNK, a.D - d0) : a.D;
  const int n_ch = CH ? (a.D + CHUNK - 1) / CHUNK : 1;
  const int hk = h / (a.H / a.Hkv);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)b * a.ksb + (size_t)hk * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)b * a.vsb + (size_t)hk * a.vsh + d0;
  bf16* o = static_cast<bf16*>(a.o) + (size_t)b * a.osb + (size_t)h * a.osh + d0;

  if (!CH) {
    load_tile<DP>(Qs, q, a.qss, q0, M_BQ, a.S, a.D, vec8);
    __syncthreads();
  }

  // This warp's 16 query rows as A fragments, kept in registers (QREG).
  const int qr = warp * 16 + g;
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag<LD>(qf[ks], Qs, qr, ks, t);
  }

  int kv_start, kv_end;
  kv_range(a, q0, M_BQ, M_BK, &kv_start, &kv_end);

  // Each thread holds rows qi[0] = q0 + qr and qi[1] = qi[0] + 8; m is
  // uniform over the 4 threads of a row, l is this thread's partial sum.
  const int qi[2] = {q0 + qr, q0 + qr + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;

  for (int kt = kv_start; kt < kv_end; kt += M_BK) {
    // S = Q K^T for 16 rows x 64 keys: NT tiles of 16 x 8, a k-step at a
    // time (Q's fragment of the step read once).
    float sacc[NT][4];
    auto qk = [&]() {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qs[4];
        if constexpr (QREG) {
          qs[0] = qf[ks][0]; qs[1] = qf[ks][1];
          qs[2] = qf[ks][2]; qs[3] = qf[ks][3];
        } else {
          q_frag<LD>(qs, Qs, qr, ks, t);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* p = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
          mma_bf16(sacc[nt], qs, *reinterpret_cast<const uint32_t*>(p),
                   *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
    };
    if constexpr (CH) {  // over chunks of D; V's slice once
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
      for (int c = 0; c < n_ch; ++c) {
        const int dims = min(CHUNK, a.D - c * CHUNK);
        __syncthreads();  // previous chunk or tile consumed
        load_tile<DP>(Qs, q + c * CHUNK, a.qss, q0, M_BQ, a.S, dims, vec8);
        load_tile<DP>(Ks, k + c * CHUNK, a.kss, kt, M_BK, a.S, dims, vec8);
        if (c == 0) load_tile<DP>(Vs, v, a.vss, kt, M_BK, a.S, DV, vec8);
        __syncthreads();
        qk();
      }
    } else {
      __syncthreads();  // previous tile consumed
      load_tile<DP>(Ks, k, a.kss, kt, M_BK, a.S, a.D, vec8);
      load_tile<DP>(Vs, v, a.vss, kt, M_BK, a.S, a.D, vec8);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
      qk();
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = kt + nt * 8 + 2 * t + (e & 1);
        const float s = live(a, qi[r], key) ? sacc[nt][e] * a.scale_log2
                                            : -INFINITY;
        sacc[nt][e] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[dt][2 * r] *= alpha;
        oacc[dt][2 * r + 1] *= alpha;
      }
    }

    // O += P V, 16 keys at a time: the C fragments of two score tiles are
    // the A fragment of P.
#pragma unroll
    for (int kk = 0; kk < M_BK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[hf][e] = exp2f(sacc[2 * kk + hf][e] - m_use[e >> 1]);
          l[e >> 1] += p[hf][e];
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const uint16_t* vp = reinterpret_cast<const uint16_t*>(Vs) +
                             (kk * 16 + 2 * t) * LD + dt * 8 + g;
        mma_bf16(oacc[dt], pa, pack_raw(vp[0], vp[LD]),
                 pack_raw(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qi[r] >= a.S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no live key: 0
    bf16* orow = o + (size_t)qi[r] * a.oss;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      const float v0 = oacc[dt][2 * r] * inv, v1 = oacc[dt][2 * r + 1] * inv;
      if (vec8 && d + 1 < DV) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < DV) orow[d] = __float2bfloat16(v0);
        if (d + 1 < DV) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DP, bool CH = false>
cudaError_t launch_mma(const Args& a, int vec8, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma<DP, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem<DP>());
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + M_BQ - 1) / M_BQ, a.H * n_slices(a.D), a.B);
  flash_fwd_mma<DP, CH><<<grid, M_WARPS * 32, mma_smem<DP>(), stream>>>(a, vec8);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper body: TMA ring with mbarriers, wgmma (bf16)
// ---------------------------------------------------------------------------

constexpr int W_STAGES = 2;      // depth of the K/V ring

// One configuration of the body. NB: 64-column boxes of a row, 1 for
// D <= 64, 2 for D <= 128, 4 for D <= 256. NC: warpgroups of 64 query rows
// each; a block owns 64 NC query rows of one (batch, head), and its
// warpgroups share each K/V tile. Two blocks share an SM at D <= 64 (80 KB
// of shared memory and at most 128 registers a thread each), so one
// block's loads and epilogue run under the other's products; one block
// fills it at D = 128 (160 KB) and at D = 256 (193 KB). bk: keys a K/V
// tile, 128, or 64 at NB = 4, where the O accumulator (4 x 32 f32 a
// thread) leaves room for a 64-key score tile (32) and its P (16) only.
template <int NB, int NC>
struct WCfg {
  static constexpr int bq = 64 * NC;                 // query rows per block
  static constexpr int bk = NB == 4 ? 64 : 128;      // keys per K/V tile
  static constexpr int threads = NC * 128;
  static constexpr int min_blocks = NB == 1 ? 2 : 1; // resident per SM
  static constexpr int qbox = bq * 128;              // bytes of a box of Q
  static constexpr int kvbox = bk * 128;             // of K or V: 64 dims a row
  // Shared memory from a 1024-byte-aligned base (the 128-byte swizzle
  // repeats every 8 rows of 128 bytes): Q [NB boxes], K [stages][NB],
  // V [stages][NB], then the barriers.
  static constexpr int q = 0;
  static constexpr int k = q + NB * qbox;
  static constexpr int v = k + W_STAGES * NB * kvbox;
  static constexpr int bar = v + W_STAGES * NB * kvbox;
  static constexpr int n_bar = 1 + 2 * W_STAGES;  // q; k full, v full
  static constexpr int smem = bar + 8 * n_bar + 1024;  // + alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of the given parity to complete. A copy or arrival
// that never comes traps after some 2**32 clocks (about 2 s): the launch
// fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One box of a rank-4 map over (D, S, heads, B) into shared memory; the
// barrier counts its bytes in when they land.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s),
         "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q or K: rows of 64 dims, 128 bytes): 8-row groups 1024
// bytes apart; the leading offset is unused within the swizzle width.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return wg_desc(addr, 16, 1024);
}

// MN-major operand (V: a row per key, the 64 dims contiguous): 8-key groups
// 1024 bytes apart. The tile is one swizzle width wide (N = 64), so the
// offset between swizzle-wide column blocks is never taken; both fields
// hold the 8-key stride.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return wg_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until every committed group of this warpgroup has completed.
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous window between a wgmma and its wait.
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S[64 x 128] (+)= Q[64 x 16] K[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] V[16 x 64]: P as bf16 A fragments in registers,
// V MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A rank-4 map over (D, S, heads, B) of a [B, S, heads, D] bf16 tensor at
// the caller's element strides; boxes of 64 dims x `rows` rows, 128-byte
// swizzle; rows past S and dims past D read as zero.
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int D, int S,
                int heads, int B, int ss, int sh, int sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Grid (H, B, q-tiles); q-tiles run from the last (the heaviest when causal)
// to the first. Thread 0 issues every copy: Q once and the first W_STAGES
// K/V tiles at the start, then, once all warpgroups are done with tile j
// (a named barrier), tile j + W_STAGES into the stage tile j leaves free.
// A thread waits for a tile on the stage's full barriers, whose phase
// flips when the TMA bytes land.
template <int NB, int NC>
__global__ void __launch_bounds__(WCfg<NB, NC>::threads,
                                  WCfg<NB, NC>::min_blocks)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  using C = WCfg<NB, NC>;
  constexpr int BK = C::bk, HALVES = BK / 64;  // 64-key halves of a tile
  extern __shared__ __align__(1024) unsigned char w_smem_raw[];
  const uint32_t raw = smem_u32(w_smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* sm = w_smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t sQ = base + C::q, sK = base + C::k, sV = base + C::v;
  const uint32_t bar_q = base + C::bar;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + W_STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::bq;
  const int hk = h / (a.H / a.Hkv);
  int kv_start, kv_end;
  kv_range(a, q0, C::bq, BK, &kv_start, &kv_end);
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + BK - 1) / BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int it) {
    const int st = it % W_STAGES, kt = kv_start + it * BK;
    mbar_expect_tx(k_full(st), NB * C::kvbox);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sK + (st * NB + j) * C::kvbox, &tk, k_full(st), 64 * j, kt, hk, b);
    mbar_expect_tx(v_full(st), NB * C::kvbox);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sV + (st * NB + j) * C::kvbox, &tv, v_full(st), 64 * j, kt, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, NB * C::qbox);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sQ + j * C::qbox, &tq, bar_q, 64 * j, q0, h, b);
    for (int it = 0; it < W_STAGES && it < n_tiles; ++it) load_kv(it);
  }

  // Thread layout of a wgmma accumulator: warp wq of the warpgroup holds
  // rows 16 wq + g and 16 wq + g + 8 (g = lane / 4); element i of a thread
  // is row (i >> 1) & 1, column 8 (i >> 2) + 2 t + (i & 1) (t = lane % 4),
  // so a row lives in the 4 threads of a quad.
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int wr0 = q0 + 64 * wg;            // first query row of the warpgroup
  const int row0 = wr0 + 16 * wq + g;      // this thread's rows: row0, row0 + 8
  const uint32_t sQw = sQ + 64 * 128 * wg;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];  // row0, row0 + 8
  float s[BK / 2], o[NB][32];
  uint32_t pa[BK / 4];  // P as the bf16 A fragments of the PV product
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % W_STAGES, kt = kv_start + it * BK;
    const uint32_t par = (it / W_STAGES) & 1;
    mbar_wait(k_full(st), par);
    wg_pin(s);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_qk(s, desc_kmajor(sQw + j * C::qbox + 32 * ks),
                 desc_kmajor(sK + (st * NB + j) * C::kvbox + 32 * ks),
                 (j | ks) != 0);
    wg_commit();
    wg_wait();
    wg_pin(s);
    // Masks only the 64-key halves of the tile (half x: keys kt + 64 x ..
    // kt + 64 x + 63, elements 32 x .. 32 x + 31) where this warpgroup's
    // rows meet the diagonal, the kv_len (or S) edge, or the window's far
    // edge. Live keys of row r are kt + 2 t + c for c in [lo[r], hi[r]], c
    // the element's column offset (a constant of the unrolled loop).
    auto edge_at = [&](int k) {
      return k + 64 > a.kv_lim || (a.causal && k + 63 > wr0) ||
             (a.window > 0 && wr0 + 63 - k >= a.window);
    };
    bool edge[HALVES], any_edge = false;
#pragma unroll
    for (int x = 0; x < HALVES; ++x) {
      edge[x] = edge_at(kt + 64 * x);
      any_edge = any_edge || edge[x];
    }
    if (any_edge) {
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r, k0 = kt + 2 * t;
        hi[r] = (a.causal ? min(row, a.kv_lim - 1) : a.kv_lim - 1) - k0;
        lo[r] = a.window > 0 ? row - a.window + 1 - k0 : -1;
      }
      auto mask = [&](int i, bool window) {
        const int c = 8 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
        if (c > hi[r] || (window && c < lo[r])) s[i] = -INFINITY;
      };
      if (a.window > 0) {
#pragma unroll
        for (int x = 0; x < HALVES; ++x)
          if (edge[x]) {
#pragma unroll
            for (int i = 32 * x; i < 32 * x + 32; ++i) mask(i, true);
          }
      } else {
#pragma unroll
        for (int x = 0; x < HALVES; ++x)
          if (edge[x]) {
#pragma unroll
            for (int i = 32 * x; i < 32 * x + 32; ++i) mask(i, false);
          }
      }
    }
    // Online softmax in the exp2 domain; P rounded to bf16 for the product.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no live key in the row yet
      alpha[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = ex2(fmaf(s[i], a.scale_log2, -mu[r]));
      const float p1 = ex2(fmaf(s[i + 1], a.scale_log2, -mu[r]));
      l[r] += p0 + p1;
      pa[i >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];

    mbar_wait(v_full(st), par);
#pragma unroll
    for (int j = 0; j < NB; ++j) wg_pin(o[j]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_pv(o[j], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3],
                 desc_mnmajor(sV + (st * NB + j) * C::kvbox + 16 * 128 * kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < NB; ++j) wg_pin(o[j]);
    named_sync(1, NC * 128);  // every warpgroup is done with stage st
    if (threadIdx.x == 0 && it + W_STAGES < n_tiles) load_kv(it + W_STAGES);
  }

  // Epilogue: O / l as bf16 into this warpgroup's rows of the Q tile (same
  // swizzle, so a quad's stores hit distinct banks), then 16-byte stores
  // of whole rows, masked at S and D.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no live key: 0
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pr = 64 * wg + 16 * wq + g + 8 * r;  // row in the tile
        *reinterpret_cast<uint32_t*>(sm + C::q + j * C::qbox + pr * 128 +
                                     ((n8 ^ (pr & 7)) << 4) + 4 * t) =
            pack_bf16(o[j][4 * n8 + 2 * r] * inv[r],
                      o[j][4 * n8 + 2 * r + 1] * inv[r]);
      }
  named_sync(2 + wg, 128);
  using bf16 = __nv_bfloat16;
  bf16* ob = static_cast<bf16*>(a.o) + (size_t)b * a.osb + (size_t)h * a.osh;
  for (int c = threadIdx.x & 127; c < NB * 64 * 8; c += 128) {
    const int j = c >> 9, lr = (c >> 3) & 63, ch = c & 7;
    const int pr = 64 * wg + lr, row = q0 + pr, col = 64 * j + 8 * ch;
    if (row < a.S && col < a.D)
      *reinterpret_cast<uint4*>(ob + (size_t)row * a.oss + col) =
          *reinterpret_cast<const uint4*>(sm + C::q + j * C::qbox + pr * 128 +
                                          ((ch ^ (pr & 7)) << 4));
  }
}

template <int NB, int NC>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using C = WCfg<NB, NC>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, a.q, C::bq, a.D, a.S, a.H, a.B, a.qss, a.qsh, a.qsb) ||
      !encode_map(&tk, a.k, C::bk, a.D, a.S, a.Hkv, a.B, a.kss, a.ksh, a.ksb) ||
      !encode_map(&tv, a.v, C::bk, a.D, a.S, a.Hkv, a.B, a.vss, a.vsh, a.vsb))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<NB, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, a.B, (a.S + C::bq - 1) / C::bq);
  flash_fwd_wgmma<NB, NC><<<grid, C::threads, C::smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

enum Body { BODY_SIMT = 0, BODY_MMA = 1, BODY_WGMMA = 2 };

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Hkv,
                                   int S, int D, int qsb, int qss, int qsh,
                                   int ksb, int kss, int ksh, int vsb, int vss,
                                   int vsh, int osb, int oss, int osh,
                                   int causal, int window, int kv_len, int body,
                                   void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      kv_len < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.D = D;
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.osb = osb; a.oss = oss; a.osh = osh;
  a.causal = causal; a.window = window;
  a.kv_lim = kv_len < S ? kv_len : S;
  a.scale_log2 = LOG2E / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int strides[] = {qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, osb, oss, osh};
  bool aligned = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  if (body == BODY_SIMT) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    // 16-byte copies where every row of every operand starts aligned
    int vec4 = aligned;
    for (int s : strides) vec4 = vec4 && s % 4 == 0;
    return (int)(D <= 64    ? launch_simt<S64>(a, vec4, st)
                 : D <= 128 ? launch_simt<S128>(a, vec4, st)
                 : D <= 256 ? launch_simt<S256>(a, vec4, st)
                            : launch_simt_sliced(a, st));
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (body == BODY_MMA) {
    // 16-byte vector loads where every row of every operand starts aligned
    int vec8 = aligned && D % 8 == 0;
    for (int s : strides) vec8 = vec8 && s % 8 == 0;
    return (int)(D <= 64    ? launch_mma<64>(a, vec8, st)
                 : D <= 128 ? launch_mma<128>(a, vec8, st)
                 : D <= 256 ? launch_mma<256>(a, vec8, st)
                            : launch_mma<256, true>(a, vec8, st));
  }
  if (body != BODY_WGMMA) return (int)cudaErrorInvalidValue;
  // TMA's rules: 16-byte-aligned bases and byte strides, whole 16-byte rows
  bool takes = aligned && D % 8 == 0 && D <= W_DMAX;
  for (int s : strides) takes = takes && s > 0 && s % 8 == 0;
  if (!takes) return (int)cudaErrorInvalidValue;
  return (int)(D <= 64    ? launch_wgmma<1, 2>(a, st)
               : D <= 128 ? launch_wgmma<2, 2>(a, st)
                          : launch_wgmma<4, 2>(a, st));
}

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
// each), 12.5 us at 3.35 TB/s, and do 8.6 GFLOP of causal products, 8.7 us at
// the bf16 tensor-core peak: memory-bound, barely. So the design reads each
// q row once, each K/V tile once per BQ-row block from L2 (K/V of one head are
// shared by H/Hkv heads and BQ-row blocks), and keeps scores and
// probabilities in registers and shared memory, never in device memory.
//
// Two bodies:
//   * flash_fwd_mma (bf16, D <= 128): mma.sync m16n8k16 tensor-core products,
//     one warp per 16 query rows, P cast to bf16 before the PV product (as
//     the reference casts probabilities to v.dtype).
//   * flash_fwd_simt (f32): products in f32 FMA, so an f32 call stays within
//     f32 rounding of the reference (tensor-core TF32 would not).
//
// C entry point flash_attention_fwd returns cudaGetLastError() after the
// launch; the Python wrapper raises on anything but 0.

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

// ---------------------------------------------------------------------------
// SIMT body: f32 FMA products
// ---------------------------------------------------------------------------

constexpr int S_BQ = 32;                 // query rows per block
constexpr int S_BK = 64;                 // keys per tile: two per lane
constexpr int S_WARPS = 4;
constexpr int S_RPW = S_BQ / S_WARPS;    // query rows per warp
constexpr int DMAX = 128;
constexpr int S_DCH = DMAX / 32;         // output dims per lane

size_t simt_smem(int D) {
  // Qs [BQ][D], Kt [D][BK+1] (transposed, padded: conflict-free both ways),
  // Vs [BK][D], Ps [warps][rows][BK]
  return sizeof(float) *
         (size_t)(S_BQ * D + D * (S_BK + 1) + S_BK * D + S_WARPS * S_RPW * S_BK);
}

__global__ void __launch_bounds__(S_WARPS * 32) flash_fwd_simt(Args a) {
  extern __shared__ float smem[];
  const int D = a.D;
  float* Qs = smem;
  float* Kt = Qs + S_BQ * D;
  float* Vs = Kt + D * (S_BK + 1);
  float* Ps = Vs + S_BK * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * S_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const float* q = static_cast<const float*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const float* k = static_cast<const float*>(a.k) + (size_t)b * a.ksb + (size_t)hk * a.ksh;
  const float* v = static_cast<const float*>(a.v) + (size_t)b * a.vsb + (size_t)hk * a.vsh;
  float* o = static_cast<float*>(a.o) + (size_t)b * a.osb + (size_t)h * a.osh;

  for (int i = tid; i < S_BQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, s = q0 + r;
    Qs[i] = s < a.S ? q[(size_t)s * a.qss + d] * a.scale_log2 : 0.f;
  }

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
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = tid; i < S_BK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, s = kt + j;
      const bool in = s < a.S;
      Kt[d * (S_BK + 1) + j] = in ? k[(size_t)s * a.kss + d] : 0.f;
      Vs[i] = in ? v[(size_t)s * a.vss + d] : 0.f;
    }
    __syncthreads();

    float s0[S_RPW], s1[S_RPW];
#pragma unroll
    for (int r = 0; r < S_RPW; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = Kt[d * (S_BK + 1) + lane];
      const float k1 = Kt[d * (S_BK + 1) + lane + 32];
#pragma unroll
      for (int r = 0; r < S_RPW; ++r) {
        const float qd = Qs[(r0 + r) * D + d];
        s0[r] = fmaf(qd, k0, s0[r]);
        s1[r] = fmaf(qd, k1, s1[r]);
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
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
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
      if (d < D) o[(size_t)qi * a.oss + d] = acc[r][c] * inv;
    }
  }
}

// Shared memory above 48 KB needs the attribute, set on the current device
// before each launch (cheap, and right for whichever device is current).
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  const size_t smem = simt_smem(a.D);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + S_BQ - 1) / S_BQ, a.H, a.B);
  flash_fwd_simt<<<grid, S_WARPS * 32, smem, stream>>>(a);
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
// distinct banks.
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

template <int DP>
__global__ void __launch_bounds__(M_WARPS * 32)
    flash_fwd_mma(Args a, int vec8) {
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  constexpr int LD = DP + 8, KS = DP / 16, DT = DP / 8, NT = M_BK / 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem_raw);
  __nv_bfloat16* Ks = Qs + M_BQ * LD;
  __nv_bfloat16* Vs = Ks + M_BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * M_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)b * a.ksb + (size_t)hk * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)b * a.vsb + (size_t)hk * a.vsh;
  bf16* o = static_cast<bf16*>(a.o) + (size_t)b * a.osb + (size_t)h * a.osh;

  load_tile<DP>(Qs, q, a.qss, q0, M_BQ, a.S, a.D, vec8);
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept in registers.
  const int qr = warp * 16 + g;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* p = Qs + qr * LD + ks * 16 + 2 * t;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
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
    __syncthreads();  // previous tile consumed
    load_tile<DP>(Ks, k, a.kss, kt, M_BK, a.S, a.D, vec8);
    load_tile<DP>(Vs, v, a.vss, kt, M_BK, a.S, a.D, vec8);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: NT tiles of 16 x 8.
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* p = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(sacc[nt], qf[ks], *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 8));
      }
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
      if (vec8 && d + 1 < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < a.D) orow[d] = __float2bfloat16(v0);
        if (d + 1 < a.D) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DP>
cudaError_t launch_mma(const Args& a, int vec8, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem<DP>());
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + M_BQ - 1) / M_BQ, a.H, a.B);
  flash_fwd_mma<DP><<<grid, M_WARPS * 32, mma_smem<DP>(), stream>>>(a, vec8);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Hkv,
                                   int S, int D, int qsb, int qss, int qsh,
                                   int ksb, int kss, int ksh, int vsb, int vss,
                                   int vsh, int osb, int oss, int osh,
                                   int causal, int window, int kv_len,
                                   void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > DMAX || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
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
  if (dtype == 0) return (int)launch_simt(a, st);
  // 16-byte vector loads where every row of every operand starts aligned
  const int strides[] = {qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, osb, oss, osh, D};
  int vec8 = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int s : strides) vec8 = vec8 && s % 8 == 0;
  return (int)(D <= 64 ? launch_mma<64>(a, vec8, st)
                       : launch_mma<128>(a, vec8, st));
}

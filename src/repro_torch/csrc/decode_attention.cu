// Decode attention over a layer's KV cache for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves a decode step's attention
// (one query token over the cache) to XLA as plain dot_attention
// (src/repro/models/transformer.py), and the port ran it as plain PyTorch
// over the f32 cache: a cast of the whole cache to the model's dtype, a
// cast of k back to f32 and the einsums' layout copies, about 4.5 times
// the cache's bytes a layer a step. This kernel computes the same function
// (models/transformer.py decode_attention) reading the cache once, and only
// its valid slots.
//
// Function, for batch row b and query head h (kv head h / G, G = H / Hkv),
// with n = min(pos + 1, S) valid slots (slots 0 .. pos of a full cache; of
// a rolling buffer of S <= window slots, the slots written so far, all S
// once it has wrapped), the reference's rounding points kept:
//   k~, v~ = k, v rounded to q's dtype            (kl.to(ql.dtype))
//   s_j    = (q . k~_j in f32) * (1 / sqrt(D))
//   p_j    = exp(s_j - max s) / sum exp(s - max s), in f32, then rounded
//            to q's dtype                          (probs.to(v.dtype))
//   out    = sum_j p_j v~_j accumulated in f32, rounded once to q's dtype.
// For an f32 model every rounding is the identity.
//
// Bound on the card: bytes. A slot is 2 * D * sizeof(cache) bytes and two
// products of D a query head: at G = 6 and an f32 cache, 0.75 FLOP a byte,
// far under the card's ~20 f32 FLOP a byte. deepseek-moe-16b's layer at
// B = 32, 545 valid slots, 16 kv heads of 128 in f32 reads 286 MB: 85 us at
// 3.35 TB/s. So the design is about keeping HBM busy:
//   * a slot's row of D values is read by D / 4 threads (at most a warp)
//     in 16-byte (f32) or 8-byte (bf16) vectors, neighbouring threads on
//     neighbouring addresses; each thread keeps kUnroll rows in flight;
//   * a block takes one batch row, one kv head with 1 (MHA) or up to 8 of
//     its query heads (q in registers), and one split of the valid slots;
//     the host sizes the splits from the shapes alone so that the grid
//     holds about two waves of blocks, and each block cuts its slots from
//     pos, read on the card, so a CUDA graph replays the same launches at
//     every position and no block reads a slot past pos;
//   * a thread's partial dots of its rows and heads are summed across the
//     row's lanes by a reduce-scatter (Reduce): at 8 heads and 4 rows, 31
//     shuffles where a butterfly for each sum would take 160, which left
//     the scores pass bound by shuffles at GQA 6:1; each sum then belongs
//     to one lane, which also keeps its running (max, sum of exp);
//   * the softmax across splits keeps "normalise, then round": three
//     launches, each named decode_attn_*:
//       decode_attn_scores  s_j into a scratch [B, H, S] (f32) and, per
//                           split, its max and its sum of exp(s - max);
//       decode_attn_pv      the global max and sum from the splits', then
//                           the split's sum of p_j v~_j in f32 (to out,
//                           rounded, where there is one split); the lanes
//                           of a row compute its rows' p_j, one each, and
//                           share them by shuffles;
//       decode_attn_reduce  the splits' sums added in order, rounded.
//     The scratch is small beside the cache (1.2 MB a layer for deepseek's
//     286 MB). Every sum has a fixed order: a replay equals an eager call
//     bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // rows a thread keeps in flight

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const long long* pos;    // 0-d int64 on the card: the step's position
  void* out;               // [B, H, D] in q's dtype
  float* scores;           // [B, H, S]
  float* smax;             // [B, H, nsplit]
  float* ssum;             // [B, H, nsplit]
  float* part;             // [nsplit, B, H, D], where nsplit > 1
  long long q_b, q_h;      // strides in elements; the head dim is dense
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  int B, H, Hkv, G, S, D, nsplit, hchunks;
  float scale;
};

// A slot's row: kTpr threads, kNv 4-element vectors each.
template <int D>
struct Row {
  static constexpr int kTpr = D / 4 < 32 ? D / 4 : 32;
  static constexpr int kNv = D / (4 * kTpr);
  static constexpr int kRpw = 32 / kTpr;            // rows a warp
  static constexpr int kGroups = kWarps * kRpw;     // rows a block at once
  static_assert(kNv * 4 * kTpr == D, "D is a multiple of 4 up to 256");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T, as a float (the reference's casts)
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 4 cache values, streamed (each is read once)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(t.x << 16);
  x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16);
  x[3] = __uint_as_float(t.y & 0xffff0000u);
}

// Sums over the R lanes of a row of each of M partial values: while a lane
// holds more than one value, it keeps half of them and sends the other
// half to the lane R / 2, R / 4, ... away (a reduce-scatter: M / 2 + M / 4
// + ... shuffles in place of M log2(R)); the steps left, if any, add the
// one value left across lanes (a butterfly). Afterwards x[0 .. F) hold the
// sums of values own_index(i, lane); lanes that differ in the butterfly's
// bits hold the same sums.
template <int R, int M>
struct Reduce {
  static constexpr int kF = M >= R ? M / R : 1;
  static __device__ __forceinline__ void run(float (&x)[M], int lane) {
    int n = M;
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1) {
      if (n > 1) {
        n >>= 1;
        const bool hi = lane & o;
#pragma unroll
        for (int i = 0; i < M / 2; ++i) {
          if (i < n) {
            const float send = hi ? x[i] : x[i + n];
            const float keep = hi ? x[i + n] : x[i];
            x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
      } else {
        x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
      }
    }
  }
  static __device__ __forceinline__ int own_index(int i, int lane) {
    int n = M, at = i;
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1) {
      if (n > 1) {
        n >>= 1;
        if (lane & o) at += n;
      }
    }
    return at;
  }
  // the one lane of those that hold the same sums
  static __device__ __forceinline__ bool owner(int lane) {
    return M >= R || (lane & (R / M - 1)) == 0;
  }
};

// (m, l) pairs of a softmax's max and its sum of exp(s - m), merged.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mm)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mm));
  m = mm;
}

// The valid slots' count, and the split's share of them. Every launch
// cuts them alike: chunk = ceil(n / nsplit), split j takes [j * chunk,
// min(n, (j + 1) * chunk)), and the first ceil(n / chunk) splits hold any.
struct Split {
  int c0, c1, used;
};

__device__ __forceinline__ Split split_of(const Params& p, int j) {
  long long n = *p.pos + 1;
  n = n < 1 ? 1 : (n > p.S ? p.S : n);
  const int chunk = (int)((n + p.nsplit - 1) / p.nsplit);
  Split s;
  s.c0 = j * chunk;
  s.c1 = (int)min(n, (long long)s.c0 + chunk);
  s.used = (int)((n + chunk - 1) / chunk);
  return s;
}

// The block's batch row, kv head and query heads h0 .. h0 + ng - 1.
struct Heads {
  int b, kvh, ng, h0;
};

template <int KH>
__device__ __forceinline__ Heads heads_of(const Params& p) {
  int x = blockIdx.x;
  const int hc = x % p.hchunks;
  x /= p.hchunks;
  Heads h;
  h.kvh = x % p.Hkv;
  h.b = x / p.Hkv;
  const int g0 = hc * KH;
  h.ng = min(KH, p.G - g0);
  h.h0 = h.kvh * p.G + g0;
  return h;
}

// Scores of KH query heads (q in registers) over the split's slots, and
// the split's (max, sum of exp) of each head: a thread's partial dots of
// its kUnroll rows and KH heads are summed across the row's lanes by
// Reduce, each sum then owned by one lane, which stores it and folds it
// into its running (max, sum).
template <int D, int KH, typename KV, typename Q>
__global__ void __launch_bounds__(kThreads) decode_attn_scores(Params p) {
  using R = Row<D>;
  constexpr int M = kUnroll * KH;     // partial dots: value g * kUnroll + u
  using Red = Reduce<R::kTpr, M>;
  const Split sp = split_of(p, blockIdx.y);
  if (sp.c0 >= sp.c1) return;
  const Heads hd = heads_of<KH>(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane % R::kTpr, rg = warp * R::kRpw + lane / R::kTpr;

  float q[KH][R::kNv][4];
  const Q* qb = static_cast<const Q*>(p.q) + hd.b * p.q_b;
#pragma unroll
  for (int g = 0; g < KH; ++g)
#pragma unroll
    for (int v = 0; v < R::kNv; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[g][v][e] = g < hd.ng
            ? to_f32(qb[(hd.h0 + g) * p.q_h + (v * R::kTpr + lr) * 4 + e])
            : 0.f;

  const KV* kb = static_cast<const KV*>(p.k) + hd.b * p.k_b + hd.kvh * p.k_h;
  float* sc = p.scores + ((long long)hd.b * p.H + hd.h0) * p.S;
  float mx[Red::kF], sum[Red::kF];
#pragma unroll
  for (int i = 0; i < Red::kF; ++i) {
    mx[i] = -INFINITY;
    sum[i] = 0.f;
  }

  // the trip count is the block's, so every lane reaches each shuffle
  for (int base = sp.c0; base < sp.c1; base += kUnroll * R::kGroups) {
    float kv[kUnroll][R::kNv][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * R::kGroups + rg;
#pragma unroll
      for (int v = 0; v < R::kNv; ++v) {
        if (s < sp.c1) {
          load4(kb + s * p.k_s + (v * R::kTpr + lr) * 4, kv[u][v]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) kv[u][v][e] = 0.f;
        }
      }
    }
    float x[M];
#pragma unroll
    for (int g = 0; g < KH; ++g)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int v = 0; v < R::kNv; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d = fmaf(q[g][v][e], rnd<Q>(kv[u][v][e]), d);
        x[g * kUnroll + u] = d;
      }
    Red::run(x, lr);
    if (Red::owner(lr)) {
#pragma unroll
      for (int i = 0; i < Red::kF; ++i) {
        const int at = Red::own_index(i, lr);
        const int g = at / kUnroll;
        const int s = base + (at % kUnroll) * R::kGroups + rg;
        if (g < hd.ng && s < sp.c1) {
          const float d = x[i] * p.scale;
          sc[g * p.S + s] = d;
          if (d > mx[i]) {
            sum[i] = sum[i] * expf(mx[i] - d) + 1.f;
            mx[i] = d;
          } else {
            sum[i] += expf(d - mx[i]);
          }
        }
      }
    }
  }

  // each head's (max, sum): the owners' pairs by row group and value,
  // merged in a fixed order, a warp a head
  __shared__ float m_s[R::kGroups][M], l_s[R::kGroups][M];
  if (Red::owner(lr)) {
#pragma unroll
    for (int i = 0; i < Red::kF; ++i) {
      m_s[rg][Red::own_index(i, lr)] = mx[i];
      l_s[rg][Red::own_index(i, lr)] = sum[i];
    }
  }
  __syncthreads();
  if (warp < hd.ng) {
    float m = -INFINITY, l = 0.f;
    for (int e = lane; e < R::kGroups * kUnroll; e += 32)
      merge(m, l, m_s[e / kUnroll][warp * kUnroll + e % kUnroll],
            l_s[e / kUnroll][warp * kUnroll + e % kUnroll]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      merge(m, l, m2, l2);
    }
    if (lane == 0) {
      const long long at =
          ((long long)hd.b * p.H + hd.h0 + warp) * p.nsplit + blockIdx.y;
      p.smax[at] = m;
      p.ssum[at] = l;
    }
  }
}

// The split's sum of p_j v~_j: each iteration, the lanes of a row share
// the probabilities of its rows and heads out (one exp and one division
// each, from the scores in L2, loaded beside the rows of v), then take
// them by shuffles.
template <int D, int KH, typename KV, typename Q>
__global__ void __launch_bounds__(kThreads) decode_attn_pv(Params p) {
  using R = Row<D>;
  constexpr int M = kUnroll * KH;     // probabilities: g * kUnroll + u
  constexpr int F = M >= R::kTpr ? M / R::kTpr : 1;   // a lane's share
  const Split sp = split_of(p, blockIdx.y);
  if (sp.c0 >= sp.c1) return;
  const Heads hd = heads_of<KH>(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane % R::kTpr, rg = warp * R::kRpw + lane / R::kTpr;

  // the softmax's max and sum over every split, in split order
  __shared__ float m_s[KH], l_s[KH];
  if (threadIdx.x < hd.ng) {
    const long long at =
        ((long long)hd.b * p.H + hd.h0 + threadIdx.x) * p.nsplit;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < sp.used; ++j) m = fmaxf(m, p.smax[at + j]);
    for (int j = 0; j < sp.used; ++j)
      l += p.ssum[at + j] * expf(p.smax[at + j] - m);
    m_s[threadIdx.x] = m;
    l_s[threadIdx.x] = l;
  }
  __syncthreads();
  const float* sc = p.scores + ((long long)hd.b * p.H + hd.h0) * p.S;

  float acc[KH][R::kNv][4];
#pragma unroll
  for (int g = 0; g < KH; ++g)
#pragma unroll
    for (int v = 0; v < R::kNv; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][v][e] = 0.f;
  const KV* vb = static_cast<const KV*>(p.v) + hd.b * p.v_b + hd.kvh * p.v_h;
  for (int base = sp.c0; base < sp.c1; base += kUnroll * R::kGroups) {
    float vv[kUnroll][R::kNv][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * R::kGroups + rg;
#pragma unroll
      for (int v = 0; v < R::kNv; ++v) {
        if (s < sp.c1) {
          load4(vb + s * p.v_s + (v * R::kTpr + lr) * 4, vv[u][v]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) vv[u][v][e] = 0.f;
        }
      }
    }
    // this lane's share: probabilities lr * F .. lr * F + F - 1, p_j over
    // s_j rounded to v~'s dtype; 0 past the split or the heads
    float pr[F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int at = M >= R::kTpr ? lr * F + i : lr;
      const int g = at / kUnroll;
      const int s = base + (at % kUnroll) * R::kGroups + rg;
      pr[i] = at < M && g < hd.ng && s < sp.c1
          ? rnd<Q>(expf(sc[g * p.S + s] - m_s[g]) / l_s[g])
          : 0.f;
    }
#pragma unroll
    for (int g = 0; g < KH; ++g) {
      if (g < hd.ng) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int at = g * kUnroll + u;
          const float pg =
              __shfl_sync(0xffffffffu, pr[at % F], at / F, R::kTpr);
#pragma unroll
          for (int v = 0; v < R::kNv; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[g][v][e] = fmaf(pg, rnd<Q>(vv[u][v][e]), acc[g][v][e]);
        }
      }
    }
  }

  // the row groups' sums, added in row-group order
  __shared__ float acc_s[KH * D];
  for (int r = 0; r < R::kGroups; ++r) {
    if (rg == r) {
#pragma unroll
      for (int g = 0; g < KH; ++g) {
        if (g < hd.ng) {
#pragma unroll
          for (int v = 0; v < R::kNv; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = g * D + (v * R::kTpr + lr) * 4 + e;
              acc_s[i] = r == 0 ? acc[g][v][e] : acc_s[i] + acc[g][v][e];
            }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < hd.ng * D; i += kThreads) {
    const long long o = ((long long)hd.b * p.H + hd.h0) * D + i;
    if (p.nsplit == 1)
      store(static_cast<Q*>(p.out) + o, acc_s[i]);
    else
      p.part[(long long)blockIdx.y * p.B * p.H * D + o] = acc_s[i];
  }
}

template <typename Q>
__global__ void __launch_bounds__(kThreads) decode_attn_reduce(Params p) {
  const long long total = (long long)p.B * p.H * p.D;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int used = split_of(p, 0).used;
  float x = 0.f;
  for (int j = 0; j < used; ++j) x += p.part[j * total + i];
  store(static_cast<Q*>(p.out) + i, x);
}

template <int D, int KH, typename KV, typename Q>
int launch(const Params& p, cudaStream_t stream) {
  static_assert(KH <= kWarps, "a warp a head in the softmax's merge");
  const dim3 grid((unsigned)(p.B * p.Hkv * p.hchunks), (unsigned)p.nsplit);
  decode_attn_scores<D, KH, KV, Q><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attn_pv<D, KH, KV, Q><<<grid, kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return (int)err;
  const long long total = (long long)p.B * p.H * D;
  decode_attn_reduce<Q><<<(unsigned)((total + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KH, typename KV, typename Q>
int launch_d(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 16: return launch<16, KH, KV, Q>(p, stream);
    case 64: return launch<64, KH, KV, Q>(p, stream);
    case 128: return launch<128, KH, KV, Q>(p, stream);
    case 256: return launch<256, KH, KV, Q>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename KV, typename Q>
int launch_h(const Params& p, int heads, cudaStream_t stream) {
  return heads == 1 ? launch_d<1, KV, Q>(p, stream)
                    : launch_d<8, KV, Q>(p, stream);
}

}  // namespace

// kv_bf16, q_bf16: the cache's and q's dtype, bf16 (1) or f32 (0);
// heads: the query heads a block takes, 1 or 8. Returns the CUDA error of
// the launches (0: queued).
extern "C" int decode_attn_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* scores, void* smax, void* ssum, void* part, long long q_b,
    long long q_h, long long k_b, long long k_s, long long k_h, long long v_b,
    long long v_s, long long v_h, int B, int H, int Hkv, int S, int D,
    int nsplit, int heads, int kv_bf16, int q_bf16, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || nsplit <= 0 ||
      nsplit > 65535 || (heads != 1 && heads != 8))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.pos = static_cast<const long long*>(pos);
  p.out = out;
  p.scores = static_cast<float*>(scores);
  p.smax = static_cast<float*>(smax);
  p.ssum = static_cast<float*>(ssum);
  p.part = static_cast<float*>(part);
  p.q_b = q_b; p.q_h = q_h;
  p.k_b = k_b; p.k_s = k_s; p.k_h = k_h;
  p.v_b = v_b; p.v_s = v_s; p.v_h = v_h;
  p.B = B; p.H = H; p.Hkv = Hkv; p.G = H / Hkv; p.S = S; p.D = D;
  p.nsplit = nsplit;
  p.hchunks = (p.G + heads - 1) / heads;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return q_bf16 ? launch_h<__nv_bfloat16, __nv_bfloat16>(p, heads, st)
                  : launch_h<__nv_bfloat16, float>(p, heads, st);
  return q_bf16 ? launch_h<float, __nv_bfloat16>(p, heads, st)
                : launch_h<float, float>(p, heads, st);
}

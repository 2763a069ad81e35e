// BP32 bit-planar fixed-width unpack for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bitunpack/kernel.py:33 `bitunpack_pallas`.
// Values come in groups of 32; a width-w group is w uint32 plane words, and
// bit i of word j is bit j of value i. So value i of group g is
//   sum over j < w of ((planes[g, j] >> i) & 1) << j.
//
// Bound on the card: bytes. n values read ceil(n / 32) * w words and write
// n words. The work is a 32 x 32 bit transpose a group: the group's words,
// one a lane (row j = word j, zero for j >= w), are transposed across the
// warp in 5 butterfly stages, so lane i ends with value i and the warp
// stores the 32 values as one coalesced 128-byte write. A stage at
// distance k (16, 8, 4, 2, 1) swaps the off-diagonal k x k bit blocks of
// each pair of lanes l and l ^ k: each lane rotates its word by k (the
// lower lane right, the upper left, so the bits its partner needs sit
// where the partner keeps them), swaps it with __shfl_xor_sync, and keeps
// its own half with one masked select, (mine & keep) | (theirs & ~keep),
// one LOP3: 3 instructions and 1 shuffle a stage. (Broadcasting each
// plane word to the warp instead costs w shuffles and about 7w
// instructions a group, and is bound by instruction issue at w = 11.)
//
// The work a group, not the bytes, is what holds the kernel back (with
// every stage a shuffle and every group bounds-checked, w = 1 ran as slow
// as w = 11), so:
//   * narrow planes skip shuffles. Rows j >= w are zero, so with P the
//     power of two >= w, lane l loads row l % P (a copy of the row P, 2P ...
//     lanes below it holds), and a stage at k >= P needs nothing from its
//     partner: its partner holds the same word, and the zero rows make the
//     stage a rotate and a mask, (x rotated right by (l & k ? k : 0)) &
//     low_cols. The count of such stages (5 - log2 P) is a template
//     argument; `local_stages` in the launch is the one rule that picks it.
//   * a warp takes kGroups groups at a time and issues all their loads
//     before the first transpose, and a run of kGroups groups that lies
//     wholly inside the planes and the output is done without bounds
//     checks, at addresses a constant apart.
// The warps walk the groups grid-stride, one wave of blocks (as many as fit
// the card). Planes may be any [G, w] at any strides; the ragged end is
// masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;                    // groups a warp has in flight

// kGroups groups from g0: `src` is this lane's word of group g0 (row
// lane % P), `dst` its value of group g0. kChecked masks groups past the
// planes and values past n.
template <int kLocal, bool kChecked>
__device__ __forceinline__ void unpack_run(
    const uint32_t* __restrict__ src, long long stride_g, bool loads,
    uint32_t* __restrict__ dst, long long g0, long long groups, long long n,
    const uint32_t (&keep)[5], const int (&rot)[5]) {
  const int lane = threadIdx.x & 31;
  uint32_t x[kGroups];
#pragma unroll
  for (int u = 0; u < kGroups; ++u)
    x[u] = loads && (!kChecked || g0 + u < groups)
               ? __ldg(src + u * stride_g)
               : 0u;
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const uint32_t turned = __funnelshift_r(x[u], x[u], rot[s]);
      if (s < kLocal) {
        x[u] = turned & keep[s];
      } else {
        const uint32_t got = __shfl_xor_sync(0xFFFFFFFFu, turned, 16 >> s);
        x[u] = (x[u] & keep[s]) | (got & ~keep[s]);
      }
    }
    if (!kChecked || (g0 + u) * 32 + lane < n) dst[u * 32] = x[u];
  }
}

template <int kLocal>
__global__ void __launch_bounds__(kThreads)
bitunpack_kernel(const uint32_t* __restrict__ planes, long long groups,
                 long long stride_g, long long stride_w, int w, long long n,
                 uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = lane & (31 >> kLocal);      // P = 32 >> kLocal rows
  // per lane and stage: the rotation and the bits the lane keeps (columns
  // whose bit k equals its own); a local stage keeps the low columns
  uint32_t keep[5];
  int rot[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int k = 16 >> s;
    const uint32_t low_cols = s == 0   ? 0x0000FFFFu
                              : s == 1 ? 0x00FF00FFu
                              : s == 2 ? 0x0F0F0F0Fu
                              : s == 3 ? 0x33333333u
                                       : 0x55555555u;
    const bool upper = lane & k;
    if (s < kLocal) {
      keep[s] = low_cols;
      rot[s] = upper ? k : 0;
    } else {
      keep[s] = upper ? ~low_cols : low_cols;
      rot[s] = upper ? 32 - k : k;
    }
  }
  const bool loads = row < w;
  const long long warp = (blockIdx.x * (long long)kThreads + threadIdx.x) / 32;
  const long long step = (long long)gridDim.x * kWarps * kGroups;
  for (long long g0 = warp * kGroups; g0 < groups; g0 += step) {
    const uint32_t* src = planes + g0 * stride_g + row * stride_w;
    uint32_t* dst = out + g0 * 32 + lane;
    if ((g0 + kGroups) * 32 <= n)               // the whole run in bounds
      unpack_run<kLocal, false>(src, stride_g, loads, dst, g0, groups, n,
                                keep, rot);
    else
      unpack_run<kLocal, true>(src, stride_g, loads, dst, g0, groups, n,
                               keep, rot);
  }
}

// Stages that need no shuffle at width w: 5 - log2 of the power of two
// >= w (w = 1: 5, w = 2: 4, w <= 4: 3, w <= 8: 2, w <= 16: 1, else 0).
int local_stages(int w) {
  int p = 1, stages = 5;
  while (p < w) {
    p *= 2;
    --stages;
  }
  return stages;
}

template <int kLocal>
cudaError_t launch(const uint32_t* planes, long long groups,
                   long long stride_g, long long stride_w, int w, long long n,
                   uint32_t* out, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bitunpack_kernel<kLocal>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long needed =
      (groups + kWarps * kGroups - 1) / (kWarps * kGroups);
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(needed < wave ? needed : wave);
  bitunpack_kernel<kLocal><<<blocks, kThreads, 0, stream>>>(
      planes, groups, stride_g, stride_w, w, n, out);
  return cudaGetLastError();
}

}  // namespace

// planes: uint32 [G, w] at element strides (stride_g, stride_w), with
// G >= ceil(n / 32) and 1 <= w <= 32; out: uint32 [n], contiguous. Launches
// on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int bitunpack_launch(const uint32_t* planes, long long stride_g,
                                long long stride_w, int w, long long n,
                                uint32_t* out, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > 32) return (int)cudaErrorInvalidValue;
  const long long groups = (n + 31) / 32;
  using Launch = cudaError_t (*)(const uint32_t*, long long, long long,
                                 long long, int, long long, uint32_t*,
                                 cudaStream_t);
  static constexpr Launch kLaunch[6] = {launch<0>, launch<1>, launch<2>,
                                        launch<3>, launch<4>, launch<5>};
  return (int)kLaunch[local_stages(w)](planes, groups, stride_g, stride_w, w,
                                        n, out,
                                        static_cast<cudaStream_t>(stream));
}

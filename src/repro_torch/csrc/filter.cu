// Conjunctive range filter for Hopper (sm_90a).
//
// Replaces src/repro/kernels/filter/kernel.py:31 `range_mask_pallas`: a row
// n survives iff lo[c] <= x[c, n] <= hi[c] for every filter column c. NaN
// fails both compares, so a NaN row never survives.
//
// Bound on the card: bytes. Each row reads C floats and writes one byte,
// (4C + 1) N bytes, with one compare pair per float; no tensor-core work.
// The design only has to keep the loads wide and coalesced:
//   * one thread per 4 rows, one 16-byte float4 load per column, when the
//     rows are contiguous and every column starts 16-byte aligned
//     (`range_mask_vec4`); one thread per row on any strides otherwise
//     (`range_mask_rows`);
//   * the C loop runs inside the thread, so the mask is written once, as
//     one uchar4 (or byte) store;
//   * the ragged tail is masked here: the host pads nothing (the TPU
//     wrapper padded N to a 2048 multiple);
//   * lo/hi are C floats in device memory, read through the read-only
//     cache (every thread reads the same address: a broadcast).
// The compares are `x >= lo && x <= hi` as written. Build without
// --use_fast_math and -ftz=true: flushing subnormals to zero would make
// x = 0 pass lo = 1e-45 (the float32 form of `x > 0`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool in_range(float x, float lo, float hi) {
  return (x >= lo) & (x <= hi);
}

__global__ void __launch_bounds__(kThreads)
range_mask_vec4(const float* __restrict__ x, long long stride_c, int C,
                long long N, const float* __restrict__ lo,
                const float* __restrict__ hi, uint8_t* __restrict__ out) {
  const long long n0 = (blockIdx.x * (long long)kThreads + threadIdx.x) * 4;
  if (n0 >= N) return;
  if (n0 + 4 <= N) {
    bool k0 = true, k1 = true, k2 = true, k3 = true;
    for (int c = 0; c < C; ++c) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(x + c * stride_c + n0));
      const float l = __ldg(lo + c), h = __ldg(hi + c);
      k0 &= in_range(v.x, l, h);
      k1 &= in_range(v.y, l, h);
      k2 &= in_range(v.z, l, h);
      k3 &= in_range(v.w, l, h);
    }
    *reinterpret_cast<uchar4*>(out + n0) = make_uchar4(k0, k1, k2, k3);
    return;
  }
  for (long long n = n0; n < N; ++n) {          // the ragged tail, < 4 rows
    bool keep = true;
    for (int c = 0; c < C; ++c)
      keep &= in_range(__ldg(x + c * stride_c + n), __ldg(lo + c),
                       __ldg(hi + c));
    out[n] = keep;
  }
}

__global__ void __launch_bounds__(kThreads)
range_mask_rows(const float* __restrict__ x, long long stride_c,
                long long stride_n, int C, long long N,
                const float* __restrict__ lo, const float* __restrict__ hi,
                uint8_t* __restrict__ out) {
  const long long n = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (n >= N) return;
  bool keep = true;
  for (int c = 0; c < C; ++c)
    keep &= in_range(__ldg(x + c * stride_c + n * stride_n), __ldg(lo + c),
                     __ldg(hi + c));
  out[n] = keep;
}

}  // namespace

// x: float32 [C, N] at element strides (stride_c, stride_n); lo, hi:
// float32 [C]; out: uint8 [N], contiguous. vec4 != 0 asks for the float4
// body, which needs stride_n == 1, stride_c % 4 == 0, x 16-byte aligned
// and out 4-byte aligned (the wrapper checks). Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int range_mask_launch(const float* x, long long stride_c,
                                 long long stride_n, int C, long long N,
                                 const float* lo, const float* hi,
                                 uint8_t* out, int vec4, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const long long threads = (N + 3) / 4;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    range_mask_vec4<<<blocks, kThreads, 0, s>>>(x, stride_c, C, N, lo, hi,
                                                 out);
  } else {
    const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
    range_mask_rows<<<blocks, kThreads, 0, s>>>(x, stride_c, stride_n, C, N,
                                                 lo, hi, out);
  }
  return (int)cudaGetLastError();
}

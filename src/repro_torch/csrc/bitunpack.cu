// BP32 bit-planar fixed-width unpack for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bitunpack/kernel.py:33 `bitunpack_pallas`.
// Values come in groups of 32; a width-w group is w uint32 plane words, and
// bit i of word j is bit j of value i. So value i of group g is
//   sum over j < w of ((planes[g, j] >> i) & 1) << j.
//
// Bound on the card: bytes. n values read ceil(n / 32) * w words and write
// n words; the work is a shift, a mask and an insert per bit, far below the
// card's integer rate. The design maps one warp to one group: lane j loads
// plane word j (one coalesced load of w words), the warp broadcasts each
// word with a shuffle, and lane i assembles value i, so the store of the 32
// values is one coalesced 128-byte write. The TPU kernel's 256-group blocks
// (8192 values) are gone: the ragged end is masked here, and planes may be
// any [G, w] at any strides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps: 8 groups a block
constexpr int kGroupsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bitunpack_kernel(const uint32_t* __restrict__ planes, long long groups,
                 long long stride_g, long long stride_w, int w, long long n,
                 uint32_t* __restrict__ out) {
  const long long g =
      blockIdx.x * (long long)kGroupsPerBlock + threadIdx.x / 32;
  if (g >= groups) return;                    // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const uint32_t mine =
      lane < w ? __ldg(planes + g * stride_g + lane * stride_w) : 0u;
  uint32_t v = 0;
  for (int j = 0; j < w; ++j) {
    const uint32_t word = __shfl_sync(0xFFFFFFFFu, mine, j);
    v |= ((word >> lane) & 1u) << j;
  }
  const long long i = g * 32 + lane;
  if (i < n) out[i] = v;
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
  const long long blocks = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  bitunpack_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      planes, groups, stride_g, stride_w, w, n, out);
  return (int)cudaGetLastError();
}

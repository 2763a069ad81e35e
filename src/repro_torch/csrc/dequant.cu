// Fused per-column dequantize and cast for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dequant/kernel.py:38 `dequant_pallas`: for a
// quantized column batch q[R, C] and per-column scale[c], zero[c],
//   int8 / uint8 / int16 q:  out = cast(q * scale[c] + zero[c])
//   uint16 q (bf16 bits):    out = cast(bits_as_float(uint32(q) << 16))
// with out float32 or bfloat16. The arithmetic type is that of scale and
// zero: float32 is what the TPU kernel computes, float64 what the storage
// layer computes (core/quantization.py `dequantize`: q.f64 * scale + zero,
// then a cast to float32), and the read path has to give NumPy's bits.
//
// Bound on the card: bytes. Each element reads 1 or 2 bytes and writes 2 or
// 4, with one multiply and one add; no tensor-core work. The design is one
// thread per element, the output written in order (coalesced), q read at
// any strides (the host pads nothing: the TPU wrapper padded to 256 x 128
// tiles; the ragged edge is the bounds check below). scale and zero are
// read through the read-only cache.
//
// Exactness, which the zone maps and the reference's rows depend on:
//   * the multiply and the add are __dmul_rn/__dadd_rn (__fmul_rn/__fadd_rn
//     for float32), which nvcc never contracts into an FMA; an FMA would
//     change the float64 sum of some codes by one ulp;
//   * bf16 bits are a reinterpretation, not a conversion, so subnormals and
//     NaN payloads pass unchanged into float32 (build without
//     --use_fast_math and -ftz=true);
//   * float64 -> float32 rounds to nearest even (__double2float_rn), and
//     float32 -> bfloat16 rounds to nearest even with a NaN sent to the
//     quiet NaN with its sign (0x7FC0 | sign), as XLA and ml_dtypes do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// The q types the wrapper passes (kernels/dequant/kernel.py `_Q_TYPES`).
enum QType : int { kInt8 = 0, kUint8 = 1, kInt16 = 2, kBf16Bits = 3 };

__device__ __forceinline__ uint16_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u)                 // NaN
    return (uint16_t)(((u >> 16) & 0x8000u) | 0x7FC0u);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float affine(float q, float s, float z) {
  return __fadd_rn(__fmul_rn(q, s), z);
}

__device__ __forceinline__ float affine(double q, double s, double z) {
  return __double2float_rn(__dadd_rn(__dmul_rn(q, s), z));
}

// Q: int8_t, uint8_t, int16_t or uint16_t (bf16 bits); A: float or double;
// O: float, or uint16_t for bfloat16 bits.
template <typename Q, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const Q* __restrict__ q, long long R, long long C,
               long long stride_r, long long stride_c,
               const A* __restrict__ scale, const A* __restrict__ zero,
               O* __restrict__ out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= R * C) return;
  const long long r = C == 1 ? i : i / C;
  const long long c = i - r * C;
  const Q code = __ldg(q + r * stride_r + c * stride_c);
  float f;
  if constexpr (std::is_same_v<Q, uint16_t>)
    f = __uint_as_float((uint32_t)code << 16);
  else
    f = affine((A)code, __ldg(scale + c), __ldg(zero + c));
  if constexpr (std::is_same_v<O, float>)
    out[i] = f;
  else
    out[i] = bf16_bits(f);
}

template <typename Q, typename A, typename O>
void launch(const void* q, long long R, long long C, long long stride_r,
            long long stride_c, const void* scale, const void* zero,
            void* out, cudaStream_t s) {
  const long long n = R * C;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  dequant_kernel<Q, A, O><<<blocks, kThreads, 0, s>>>(
      static_cast<const Q*>(q), R, C, stride_r, stride_c,
      static_cast<const A*>(scale), static_cast<const A*>(zero),
      static_cast<O*>(out));
}

template <typename Q>
void launch_q(const void* q, long long R, long long C, long long stride_r,
              long long stride_c, const void* scale, const void* zero,
              int f64, void* out, int bf16_out, cudaStream_t s) {
  if (f64 && bf16_out)
    launch<Q, double, uint16_t>(q, R, C, stride_r, stride_c, scale, zero,
                                out, s);
  else if (f64)
    launch<Q, double, float>(q, R, C, stride_r, stride_c, scale, zero, out,
                             s);
  else if (bf16_out)
    launch<Q, float, uint16_t>(q, R, C, stride_r, stride_c, scale, zero,
                               out, s);
  else
    launch<Q, float, float>(q, R, C, stride_r, stride_c, scale, zero, out,
                            s);
}

}  // namespace

// q: [R, C] of q_type (0 int8, 1 uint8, 2 int16, 3 uint16 bf16 bits) at
// element strides (stride_r, stride_c); scale, zero: [C] float32 (f64 = 0)
// or float64 (f64 = 1), contiguous; out: [R, C] contiguous, float32
// (bf16_out = 0) or bfloat16 bits (bf16_out = 1). Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int dequant_launch(const void* q, int q_type, long long R,
                              long long C, long long stride_r,
                              long long stride_c, const void* scale,
                              const void* zero, int f64, void* out,
                              int bf16_out, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if ((R * C + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_type) {
    case kInt8:
      launch_q<int8_t>(q, R, C, stride_r, stride_c, scale, zero, f64, out,
                       bf16_out, s);
      break;
    case kUint8:
      launch_q<uint8_t>(q, R, C, stride_r, stride_c, scale, zero, f64, out,
                        bf16_out, s);
      break;
    case kInt16:
      launch_q<int16_t>(q, R, C, stride_r, stride_c, scale, zero, f64, out,
                        bf16_out, s);
      break;
    case kBf16Bits:
      launch_q<uint16_t>(q, R, C, stride_r, stride_c, scale, zero, f64, out,
                         bf16_out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

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
// Two entry points share the arithmetic (`value`, which calls `affine`):
//
//   dequant_launch          the TPU op's [R, C] at any strides, f32 or f64
//                           arithmetic, f32 or bf16 out: one thread per
//                           element, output written in order.
//   dequant_columns_launch  the read path's: a list of 1-D columns of any
//                           of the four code types, each with its own f64
//                           scale and zero, to float32, in one launch.
//
// Bound on the card: bytes. Each element reads 1 or 2 bytes and writes 4
// (2 for bf16 out), with one multiply and one add; no tensor-core work. A
// column costs the read path one launch's fixed ramp and tail, and at one
// 2**20-row column those cost about as much as its bytes, so the column
// list is one launch: the host packs a table of column descriptors and the
// codes into one staging buffer (one copy to the card, the table rides it
// and has no width limit), and each block takes one (column, tile) pair. A
// tile is kTileBytes of one column's codes; each thread loads kVecs 16-byte
// vectors of codes (16 int8/uint8 or 8 int16/bf16 codes each), both loads
// in flight before the first store, and its values go out as 16-byte
// float32 vectors, through shared memory so that a warp's stores are
// contiguous (`column_tile`). A warp whose vectors do not all start on 16 bytes, or
// that runs past the column's end, takes the scalar path, so a column may
// start anywhere and end anywhere: the host pads nothing (its packer aligns
// each column to 16 bytes, so only the ragged tail is scalar).
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

// One code's value: bf16 bits shifted into a float32, or the affine map in
// the arithmetic type A. Q: int8_t, uint8_t, int16_t or uint16_t (bf16
// bits); A: float or double.
template <typename Q, typename A>
__device__ __forceinline__ float value(Q code, A s, A z) {
  if constexpr (std::is_same_v<Q, uint16_t>)
    return __uint_as_float((uint32_t)code << 16);
  else
    return affine((A)code, s, z);
}

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
  A s = 0, z = 0;
  if constexpr (!std::is_same_v<Q, uint16_t>) {
    s = __ldg(scale + c);
    z = __ldg(zero + c);
  }
  const float f = value(code, s, z);
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

// ---------------------------------------------------------------------------
// The column list: one launch for many columns
// ---------------------------------------------------------------------------

constexpr int kVecs = 2;                           // 16-byte vectors a thread
constexpr long long kTileBytes = 16LL * kThreads * kVecs;   // codes of a tile

// One column of a launch, at the head of the staging buffer (64 bytes;
// kernels/dequant/staging.py DESC_DTYPE is the same layout).
struct ColumnDesc {
  long long code_offset;   // bytes from the start of the staging buffer
  long long out_offset;    // float32 elements from the start of out
  long long rows;
  long long tile_start;    // first tile of this column in the launch
  double scale, zero;      // unused for bf16 bits
  int q_type;              // QType
  int pad[3];
};
static_assert(sizeof(ColumnDesc) == 64, "ColumnDesc is 64 bytes");

union Vec {
  uint4 v;
  int8_t i8[16];
  uint8_t u8[16];
  int16_t i16[8];
  uint16_t u16[8];
};

template <typename Q>
__device__ __forceinline__ const Q* lanes(const Vec& x) {
  if constexpr (std::is_same_v<Q, int8_t>) return x.i8;
  else if constexpr (std::is_same_v<Q, uint8_t>) return x.u8;
  else if constexpr (std::is_same_v<Q, int16_t>) return x.i16;
  else return x.u16;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Elements [begin, end) of one column (at most kTileBytes of codes):
// thread t takes vectors t and t + kThreads of the tile, so each load
// instruction of a warp reads 512 contiguous bytes. A warp whose 32 vectors
// are all whole and 16-byte aligned writes their values into `stage` (its
// own 32 x V floats of shared memory) and stores them back lane by lane, so
// each store instruction too writes 512 contiguous bytes (a thread's own V
// values are 32 or 64 bytes, and storing them from registers leaves half
// or three quarters of every sector of an instruction unwritten, which
// measured 1.9x slower). Any other warp (a column's tail, or a column that
// does not start on 16 bytes) takes the scalar path.
template <typename Q>
__device__ __forceinline__ void column_tile(float4* __restrict__ stage,
                                            const Q* __restrict__ codes,
                                            float* __restrict__ out,
                                            long long begin, long long end,
                                            double s, double z) {
  constexpr int V = 16 / sizeof(Q);                    // codes a vector
  constexpr int F = V / 4;                             // float4s a vector
  const int lane = threadIdx.x & 31;
  float4* mine = stage + (threadIdx.x >> 5) * 32 * F;
  Vec raw[kVecs];
  bool whole[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = begin + (long long)(k * kThreads + threadIdx.x) * V;
    whole[k] = __all_sync(0xFFFFFFFFu, i + V <= end && aligned16(codes + i)
                                           && aligned16(out + i));
    if (whole[k]) raw[k].v = __ldg(reinterpret_cast<const uint4*>(codes + i));
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = begin + (long long)(k * kThreads + threadIdx.x) * V;
    if (whole[k]) {
      const Q* q = lanes<Q>(raw[k]);
#pragma unroll
      for (int j = 0; j < F; ++j)
        mine[lane * F + j] = make_float4(
            value(q[4 * j], s, z), value(q[4 * j + 1], s, z),
            value(q[4 * j + 2], s, z), value(q[4 * j + 3], s, z));
      __syncwarp();
      float4* run = reinterpret_cast<float4*>(out + i) - lane * F;
#pragma unroll
      for (int j = 0; j < F; ++j) run[j * 32 + lane] = mine[j * 32 + lane];
      __syncwarp();
    } else {
      const long long stop = i + V < end ? i + V : end;
      for (long long e = i; e < stop; ++e)
        out[e] = value(__ldg(codes + e), s, z);
    }
  }
}

// The last column whose first tile is at or before `tile`.
__device__ __forceinline__ int column_of(const ColumnDesc* desc, int n_cols,
                                         long long tile) {
  int lo = 0, hi = n_cols - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&desc[mid].tile_start) <= tile) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// One block a tile; the tile's column by a binary search of the
// descriptors' first tiles.
__global__ void __launch_bounds__(kThreads)
dequant_columns_kernel(const unsigned char* __restrict__ staging, int n_cols,
                       float* __restrict__ out) {
  __shared__ float4 stage[kThreads * 4];     // 32 x 16 floats a warp
  const ColumnDesc* desc = reinterpret_cast<const ColumnDesc*>(staging);
  const long long tile = blockIdx.x;
  const ColumnDesc& d = desc[column_of(desc, n_cols, tile)];
  const long long rows = __ldg(&d.rows);
  const unsigned char* codes = staging + __ldg(&d.code_offset);
  float* col = out + __ldg(&d.out_offset);
  const double s = __ldg(&d.scale), z = __ldg(&d.zero);
  const int q_type = __ldg(&d.q_type);
  const int size = q_type == kInt8 || q_type == kUint8 ? 1 : 2;
  const long long begin = (tile - __ldg(&d.tile_start)) * (kTileBytes / size);
  const long long stop = begin + kTileBytes / size;
  const long long end = stop < rows ? stop : rows;
  switch (q_type) {
    case kInt8:
      column_tile(stage, reinterpret_cast<const int8_t*>(codes), col, begin,
                  end, s, z);
      break;
    case kUint8:
      column_tile(stage, reinterpret_cast<const uint8_t*>(codes), col, begin,
                  end, s, z);
      break;
    case kInt16:
      column_tile(stage, reinterpret_cast<const int16_t*>(codes), col, begin,
                  end, s, z);
      break;
    default:                                           // kBf16Bits
      column_tile(stage, reinterpret_cast<const uint16_t*>(codes), col, begin,
                  end, s, z);
      break;
  }
}

}  // namespace

// staging: device bytes, n_cols ColumnDesc at its head (tile_start rising,
// tiles of kTileBytes of codes: ceil(rows * code size / kTileBytes) a
// column), the codes after them at their code_offset; out: float32 device
// buffer holding every column at its out_offset; n_tiles: the sum of the
// columns' tiles. Launches on `stream` and returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int dequant_columns_launch(const void* staging, int n_cols,
                                      long long n_tiles, void* out,
                                      void* stream) {
  if (n_cols <= 0 || n_tiles <= 0) return 0;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dequant_columns_kernel<<<(unsigned)n_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(staging), n_cols,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

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

// Page decode of bit-packed scalar pages for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes every page on the host
// (core/encodings/numeric.py `unpack_bits`, under `FixedBitWidth.decode`
// and `Dictionary.decode`). This kernel takes the two encodings that hold
// most of a scan's host decode time, `fixed_bit_width` and `dictionary`,
// to the card, so the host only reads the pages' frame headers, decodes the
// dictionaries (a few hundred entries) and stages the packed bytes.
//
// The pages' bitstreams are the writer's (numeric.py `pack_bits`):
// value i of a width-w page is bits i*w .. i*w+w-1 of an LSB-first
// contiguous stream. One launch decodes every device-route page of one
// `decode_group` call. The host packs one staging buffer
// (kernels/page_unpack/staging.py): a table of page descriptors
// (`PageDesc`) at its head, then each page's packed stream, its
// dictionary and its deleted rows, each at a 16-byte-aligned offset.
// Output element j of a page:
//   row   = the page's j-th kept row: with its deleted rows d_0 < d_1 < ...
//           staged as skip_i = d_i - i (the kept rows before d_i), row =
//           j + #{i : skip_i <= j}, a binary search (a deletion vector
//           costs the host and the copy 4 bytes a deleted row, not a kept
//           one), or j without deletions;
//   code  = the w bits of that row, from the 64-bit word that holds the
//           row's first bit and, when they cross it, the next word;
//   value = fixed_bit_width: the code; dictionary: dict[code], or 0 for a
//           code >= nuniq (the reserved mask entry), as `Dictionary.decode`;
//   stored as its low out_size bytes (NumPy's integer cast), at out +
//   out_offset + j * out_size.
// The output of a page may lie anywhere in `out`: the read path aims the
// BF16 and affine columns straight into the dequant kernel's staging
// (kernels/dequant/staging.py), so their codes never return to the host,
// and the other columns into a buffer that is copied back once.
//
// Bound on the card: bytes. A value reads w bits and writes out_size bytes;
// the work is two shifts, a mask, at most one dictionary load and, on a
// page with deletions, a binary search of its few deleted rows (in L1). One 2**19-row group of
// the benchmark's table is about 16 MB in and out, a few microseconds at
// 3.35 TB/s, so the launch must keep the SMs and the store path full:
//   * each thread writes whole 16-byte vectors (16 / out_size values), and
//     the threads of a warp write consecutive vectors, so every store
//     instruction of a warp writes 512 contiguous bytes. A page's output
//     starts on any multiple of out_size; its first values up to a 16-byte
//     boundary (the head) and its last values past the last whole vector
//     (the tail) are stored one at a time by the page's first block.
//   * a block takes kVecs * kThreads vectors (16 KB) of one page, so a
//     65,536-row page of int32 takes 16 blocks and a call's pages together
//     take several waves of the 132 SMs; the page of a block is a binary
//     search of the descriptors' first blocks, as in dequant.cu.
//   * the words a warp reads are contiguous (the rows of consecutive
//     values are consecutive, or rise past a few deleted ones), so the
//     loads coalesce; they go through the read-only cache (__ldg), which
//     also holds a page's dictionary and deleted rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                              // 16-byte vectors a thread
constexpr long long kBlockBytes = 16LL * kThreads * kVecs;   // output a block

// One page of a launch, at the head of the staging buffer (72 bytes;
// kernels/page_unpack/staging.py DESC_DTYPE is the same layout).
struct PageDesc {
  long long bits_offset;   // staging bytes: the packed stream, 8-byte aligned
  long long dict_offset;   // staging bytes: the dictionary's out_size entries
  long long nuniq;         // dictionary entries; -1 for fixed_bit_width
  long long skip_offset;   // staging bytes: int32 skip_i of each deleted row
  long long out_offset;    // bytes from out: value 0, a multiple of out_size
  long long rows;          // values: the page's rows less the deleted ones
  long long block_start;   // first block of this page in the launch
  int width;               // bits a code, 0..64
  int out_size;            // bytes a value: 1, 2, 4 or 8
  int n_deleted;           // entries of skip; 0: value j is row j
  int pad;
};
static_assert(sizeof(PageDesc) == 72, "PageDesc is 72 bytes");

template <int S> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint64_t; };

union Vec {
  uint4 v;
  uint8_t b[16];
  uint16_t h[8];
  uint32_t w[4];
  uint64_t d[2];
};

template <int S>
__device__ __forceinline__ typename Word<S>::T* lanes(Vec& x) {
  if constexpr (S == 1) return x.b;
  else if constexpr (S == 2) return x.h;
  else if constexpr (S == 4) return x.w;
  else return x.d;
}

// Everything a thread needs of its page, read once.
struct Page {
  const uint64_t* words;
  const unsigned char* dict;
  const int32_t* skip;           // the deleted rows, as skip_i = d_i - i
  unsigned char* out;            // value 0
  long long nuniq;
  long long rows;
  int width;
  int n_deleted;
};

// The code of `row`: bits row*w .. row*w+w-1 of the stream.
__device__ __forceinline__ uint64_t code(const Page& p, long long row) {
  const int w = p.width;
  if (w == 0) return 0;
  const unsigned long long bit = (unsigned long long)row * (unsigned)w;
  const long long k = (long long)(bit >> 6);
  const int s = (int)(bit & 63);
  uint64_t v = __ldg(p.words + k) >> s;
  if (s + w > 64) v |= __ldg(p.words + k + 1) << (64 - s);   // s > 0 here
  return w == 64 ? v : v & ((1ull << w) - 1);
}

template <int S>
__device__ __forceinline__ typename Word<S>::T value(const Page& p,
                                                     long long j) {
  using T = typename Word<S>::T;
  int lo = 0, hi = p.n_deleted;          // #{i : skip_i <= j}
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(p.skip + mid) <= j) lo = mid + 1;
    else hi = mid;
  }
  const uint64_t c = code(p, j + lo);
  if (p.nuniq < 0) return (T)c;
  return c < (unsigned long long)p.nuniq
             ? __ldg(reinterpret_cast<const T*>(p.dict) + c)
             : (T)0;
}

// Block `blk` of a page: its 16-byte vectors, and, in block 0, the head
// and the tail one value at a time.
template <int S>
__device__ __forceinline__ void page_block(const Page& p, long long blk,
                                           long long out_offset) {
  using T = typename Word<S>::T;
  constexpr int E = 16 / S;                           // values a vector
  const long long to_edge = ((16 - (out_offset & 15)) & 15) / S;
  const long long head = to_edge < p.rows ? to_edge : p.rows;
  const long long vecs = (p.rows - head) / E;
  uint4* body = reinterpret_cast<uint4*>(p.out + head * S);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long v = blk * (kBlockBytes / 16) + k * kThreads + threadIdx.x;
    if (v < vecs) {
      Vec x;
      T* lane = lanes<S>(x);
      const long long j0 = head + v * E;
#pragma unroll
      for (int e = 0; e < E; ++e) lane[e] = value<S>(p, j0 + e);
      body[v] = x.v;
    }
  }
  if (blk == 0) {
    T* out = reinterpret_cast<T*>(p.out);
    const long long tail0 = head + vecs * E;
    const long long t = threadIdx.x;
    if (t < head) out[t] = value<S>(p, t);
    if (tail0 + t < p.rows) out[tail0 + t] = value<S>(p, tail0 + t);
  }
}

// The last page whose first block is at or before `block`.
__device__ __forceinline__ int page_of(const PageDesc* desc, int n_pages,
                                       long long block) {
  int lo = 0, hi = n_pages - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&desc[mid].block_start) <= block) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
page_unpack_kernel(const unsigned char* __restrict__ staging, int n_pages,
                   unsigned char* __restrict__ out) {
  const PageDesc* desc = reinterpret_cast<const PageDesc*>(staging);
  const PageDesc& d = desc[page_of(desc, n_pages, blockIdx.x)];
  const long long out_offset = __ldg(&d.out_offset);
  Page p;
  p.words = reinterpret_cast<const uint64_t*>(staging + __ldg(&d.bits_offset));
  p.dict = staging + __ldg(&d.dict_offset);
  p.skip = reinterpret_cast<const int32_t*>(staging + __ldg(&d.skip_offset));
  p.out = out + out_offset;
  p.nuniq = __ldg(&d.nuniq);
  p.rows = __ldg(&d.rows);
  p.width = __ldg(&d.width);
  p.n_deleted = __ldg(&d.n_deleted);
  const long long blk = blockIdx.x - __ldg(&d.block_start);
  switch (__ldg(&d.out_size)) {
    case 1: page_block<1>(p, blk, out_offset); break;
    case 2: page_block<2>(p, blk, out_offset); break;
    case 4: page_block<4>(p, blk, out_offset); break;
    default: page_block<8>(p, blk, out_offset); break;
  }
}

}  // namespace

// staging: device bytes, n_pages PageDesc at its head (block_start rising:
// a page takes max(1, ceil(vectors / (kThreads * kVecs))) blocks), the
// streams, dictionaries and deleted rows after them at their offsets; out:
// device bytes, 16-byte aligned, holding every page's values at its
// out_offset; n_blocks: the sum of the pages' blocks. Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int page_unpack_launch(const void* staging, int n_pages,
                                  long long n_blocks, void* out,
                                  void* stream) {
  if (n_pages <= 0 || n_blocks <= 0) return 0;
  if (n_blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  page_unpack_kernel<<<(unsigned)n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(staging), n_pages,
      static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

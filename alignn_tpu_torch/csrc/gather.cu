// Windowed gather for graph-local indices.
//
// K8 windowed_gather replaces the TPU kernel
//   alignn_tpu/ops/pallas_gather.py `_gather_kernel` (launched by
//   `_windowed_gather_impl`, pallas_call at :229):
//     out[r] = x[idx[r]]  if idx[r] != trash and idx[r] - base(tile) < window
//            = 0          otherwise
// where trash = rows - 1, the index rows are cut into supertiles of `tile`
// rows (512, 256 or 128), and base(tile) is the minimum of the tile's real
// (non-trash) indices aligned down to 128, or 0 for an all-trash tile.
// The copy is exact: the output holds x's bits.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The function reads its index
// vector and the source rows and writes m x F elements; it does no
// arithmetic.  The rows a batch's indices reach lie in a window of at most
// 2048 rows per supertile (4 MB at F 512 in f32), a contiguous slice of x
// that the 50 MB L2 holds while the tiles that share it are copied, so the
// least traffic is the table read once plus the output written once:
// ((rows + m) * F * esize + m * 8) bytes.
//
// Design.  On the TPU the window is DMA'd into VMEM and the gather is a
// one-hot [tile, window] x [window, F] product on the MXU, with the bases
// scalar-prefetched and the window double-buffered.  None of that carries
// over: on the card a gather is a row copy.
//  - A block owns kRowsPerBlock consecutive index rows of one supertile
//    (tiles are multiples of it).  It reads the whole supertile's indices
//    and takes the min of the real ones itself (a warp shuffle reduction),
//    which gives `base`: no precomputed bases, no one-hot.
//  - Then each warp copies whole rows: lanes on neighbouring 16-byte
//    vectors (4 x f32 or 8 x bf16) of one row, up to four vectors a lane
//    loaded before any is stored, so that many loads are in flight.  The
//    row offset idx * row_stride is taken in 64 bits.  Rows outside the
//    rule get zero bits (+0.0 in both types).
//  - The output is written with streaming stores (evict-first), so that it
//    does not push the source window out of L2.
//  - A table whose rows are not 16-byte aligned is copied in units of one
//    element instead.
// Two artifacts of the TPU version are not reproduced: its product turns
// -0.0 into +0.0, and a non-finite value anywhere in a tile's window
// spreads NaN to every row of the tile (0 x inf).  On finite data without
// -0.0 the two agree bit for bit.
//
// Plain C entry point (loaded with ctypes); returns the cudaGetLastError()
// of its launch.  `ld` is x's row stride in elements, the feature axis is
// unit-stride, `esize` the element size in bytes (4 or 2), `idx` int64.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;
constexpr int kAlign = 128;
constexpr int kUnroll = 4;   // vectors a lane loads before it stores

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ uint4 zero_vec<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ unsigned int zero_vec<unsigned int>() {
  return 0u;
}
template <>
__device__ __forceinline__ unsigned short zero_vec<unsigned short>() {
  return 0;
}

// V is the copy unit: uint4 (16 bytes) when x's rows are 16-byte aligned,
// else one element (unsigned int for f32, unsigned short for bf16).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const char* __restrict__ x, long long ld_bytes,
                  long long rows, const long long* __restrict__ idx,
                  int tile, int window, char* __restrict__ out,
                  int row_vecs) {
  __shared__ long long s_lo[kWarps];
  __shared__ long long s_base;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long trash = rows - 1;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long tile0 = row0 / tile * tile;

  // base: the min of the supertile's real indices, aligned down
  long long lo = LLONG_MAX;
  for (int r = threadIdx.x; r < tile; r += kThreads) {
    const long long v = __ldg(idx + tile0 + r);
    if (v != trash && v < lo) lo = v;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const long long o = __shfl_xor_sync(0xffffffffu, lo, s);
    lo = o < lo ? o : lo;
  }
  if (lane == 0) s_lo[warp] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long m = s_lo[0];
    for (int w = 1; w < kWarps; ++w) m = s_lo[w] < m ? s_lo[w] : m;
    s_base = m >= rows ? 0 : m / kAlign * kAlign;
  }
  __syncthreads();
  const long long base = s_base;

  const long long row_bytes = (long long)row_vecs * sizeof(V);
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const long long row = row0 + r;
    const long long i = __ldg(idx + row);
    V* dst = reinterpret_cast<V*>(out + row * row_bytes);
    if (i != trash && i - base < window) {
      const V* src = reinterpret_cast<const V*>(x + i * ld_bytes);
      for (int v0 = 0; v0 < row_vecs; v0 += 32 * kUnroll) {
        V buf[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int v = v0 + k * 32 + lane;
          if (v < row_vecs) buf[k] = __ldg(src + v);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int v = v0 + k * 32 + lane;
          if (v < row_vecs) __stcs(dst + v, buf[k]);
        }
      }
    } else {
      const V z = zero_vec<V>();
      for (int v = lane; v < row_vecs; v += 32) __stcs(dst + v, z);
    }
  }
}

template <typename V>
void launch(const void* x, long long ld_bytes, long long rows,
            const long long* idx, long long m, int tile, int window,
            void* out, int row_vecs, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)(m / kRowsPerBlock);
  gather_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const char*>(x), ld_bytes, rows, idx, tile, window,
      static_cast<char*>(out), row_vecs);
}

}  // namespace

extern "C" int alignn_windowed_gather(const void* x, long long ld,
                                      long long rows, const void* idx,
                                      long long m, int tile, int window,
                                      void* out, int f, int esize,
                                      void* stream) {
  if (m <= 0 || tile <= 0 || tile % kRowsPerBlock != 0 || m % tile != 0 ||
      (esize != 4 && esize != 2) || rows <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  const long long ld_bytes = ld * esize;
  const long long row_bytes = (long long)f * esize;
  const auto* ids = static_cast<const long long*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld_bytes % 16 == 0 &&
      row_bytes % 16 == 0) {
    launch<uint4>(x, ld_bytes, rows, ids, m, tile, window, out,
                  (int)(row_bytes / 16), st);
  } else if (esize == 4) {
    launch<unsigned int>(x, ld_bytes, rows, ids, m, tile, window, out, f,
                         st);
  } else {
    launch<unsigned short>(x, ld_bytes, rows, ids, m, tile, window, out, f,
                           st);
  }
  return (int)cudaGetLastError();
}

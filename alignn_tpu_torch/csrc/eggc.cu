// Edge-gated graph convolution reductions over dst-sorted (CSR) segments.
//
// K1 eggc_gated_aggregate replaces the TPU kernel
//   alignn_tpu/ops/pallas_eggc.py `_kernel` (launched by `_pallas_forward`):
//     h[n] = sum_{e in seg(n)} sigmoid(m_e) * bh_e / (sum sigmoid(m_e) + 1e-6)
// K2 sorted_segment_sum replaces
//   alignn_tpu/ops/pallas_eggc.py `_ssum_kernel` (launched by `_ssum_pallas`):
//     out[n] = sum_{e in seg(n)} x_e
// Segment n is the contiguous row range [row_ptr[n], row_ptr[n+1]) of the
// dst-sorted edge table.  No atomics: the result is deterministic.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels are memory bound.  K1
// reads 2*E*F input elements and writes N*F; K2 reads E*F and writes N*F.
// Arithmetic is a few operations per element, far below the card's
// 67 TFLOP/s f32 rate.
//
// Design against that bound.  Segments are cut into items of at most
// kChunkRows rows (the cut is built once per batch, on the host side of
// the wrapper: `item_rows` delimits item i = [item_rows[i],
// item_rows[i+1]), `item_ptr` maps segment n to its items).  Padded
// batches send every padded row to one trash segment that can hold a
// third of all rows; cutting it keeps every block's walk short, so the
// whole card streams the input instead of one SM.
//  - Pass 1, one block per (item, feature chunk): lanes cover the feature
//    axis with 16-byte loads (4 x f32 or 8 x bf16/f16), neighbouring lanes on
//    neighbouring addresses; row groups of lanes stride over the item's
//    rows (loop unrolled so that several rows' loads are in flight);
//    sigmoid(m) lives in registers only; the row groups' f32 partials
//    meet in shared memory in a fixed order and one f32 partial per item
//    is written.
//  - Pass 2, one block per (segment, 256 features): the segment's item
//    partials are summed in item order, K1 divides, and the result is
//    written in the input dtype.  Most segments have one item, so pass 2
//    moves about N*F*4 bytes (x2 for K1) on top of the bound's traffic.
// The TPU kernel's tiling (node tiles of 128, one-hot [E,128] matmuls on
// the MXU, TE-aligned DMA bases) is not carried over.
//
// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() of its launches.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (both 16-bit types summed in f32).
// `ld_*` are row strides in elements; the feature axis must be unit-stride.
// `partial` is f32 scratch of num_items*F floats (K2) or 2*num_items*F
// (K1), allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// Two packed 16-bit elements (bf16 or f16) -> two f32 values.
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}
__device__ __forceinline__ float2 to_float2(__half2 x) {
  return __half22float2(x);
}
template <typename T>
struct Packed2;
template <>
struct Packed2<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct Packed2<__half> {
  using type = __half2;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// VEC consecutive elements at p -> f32 registers (one 16-byte load when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_float(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "f32 vectors are 4 wide");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    static_assert(VEC == 8, "bf16 and f16 vectors are 8 wide");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const auto* h = reinterpret_cast<const typename Packed2<T>::type*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = to_float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VEC f32 values to p (float4 stores when VEC is a multiple of 4).
template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ p,
                                          const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// Pass 1.  ACC accumulators per element: K2 sums x (ACC = 1); K1 sums
// sigmoid(m) * bh and sigmoid(m) (ACC = 2, GATED).  partial[a] is the
// [num_items, f] f32 plane of accumulator a.
template <typename T, int VEC, bool GATED>
__global__ void __launch_bounds__(kThreads)
    partial_kernel(const T* __restrict__ a, long long ld_a,
                   const T* __restrict__ b, long long ld_b,
                   const int* __restrict__ item_rows,
                   float* __restrict__ partial, long long plane, int f,
                   int tpr, int rows) {
  constexpr int ACC = GATED ? 2 : 1;
  extern __shared__ float smem[];  // [ACC][rows][tpr * VEC]
  const int item = blockIdx.x;
  const int lane = threadIdx.x % tpr;
  const int rg = threadIdx.x / tpr;
  const int col = (blockIdx.y * tpr + lane) * VEC;
  const bool active = rg < rows && col < f;
  const int width = tpr * VEC;

  float acc[ACC][VEC];
#pragma unroll
  for (int k = 0; k < ACC; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;
  if (active) {
    const long long hi = item_rows[item + 1];
#pragma unroll 4
    for (long long e = item_rows[item] + rg; e < hi; e += rows) {
      float av[VEC];
      load_vec<T, VEC>(a + e * ld_a + col, av);
      if constexpr (GATED) {
        float bv[VEC];
        load_vec<T, VEC>(b + e * ld_b + col, bv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float s = 1.f / (1.f + expf(-av[v]));
          acc[0][v] += s * bv[v];
          acc[1][v] += s;
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[0][v] += av[v];
      }
    }
  }
  if (rows > 1) {  // uniform over the block
    if (active) {
#pragma unroll
      for (int k = 0; k < ACC; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          smem[(k * rows + rg) * width + lane * VEC + v] = acc[k][v];
    }
    __syncthreads();
    if (active && rg == 0) {
      for (int r = 1; r < rows; ++r)
#pragma unroll
        for (int k = 0; k < ACC; ++k)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[k][v] += smem[(k * rows + r) * width + lane * VEC + v];
    }
  }
  if (active && rg == 0) {
#pragma unroll
    for (int k = 0; k < ACC; ++k)
      store_f32<VEC>(partial + k * plane + static_cast<long long>(item) * f +
                         col,
                     acc[k]);
  }
}

// Pass 2: out[n] = sum of segment n's item partials, in item order (K1:
// divided by the summed gates plus eps).  Empty segments give 0.
template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ partial, long long plane,
                  const int* __restrict__ item_ptr, T* __restrict__ out,
                  int f) {
  const int node = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= f) return;
  float num = 0.f, den = 0.f;
  for (long long i = item_ptr[node]; i < item_ptr[node + 1]; ++i) {
    num += partial[i * f + col];
    if constexpr (GATED) den += partial[plane + i * f + col];
  }
  const float h = GATED ? num / (den + kEps) : num;
  out[static_cast<long long>(node) * f + col] = from_float<T>(h);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, bool GATED>
cudaError_t reduce(const void* a, long long ld_a, const void* b,
                   long long ld_b, const int* item_rows, int num_items,
                   const int* item_ptr, float* partial, void* out, int n,
                   int f, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long plane = static_cast<long long>(num_items) * f;
  if (num_items > 0) {
    const bool wide = f % kVec == 0 && ld_a % kVec == 0 && aligned16(a) &&
                      aligned16(partial) &&
                      (!GATED || (ld_b % kVec == 0 && aligned16(b)));
    const int vec = wide ? kVec : 1;
    const int lanes = (f + vec - 1) / vec;
    const int tpr = lanes < kThreads ? lanes : kThreads;
    const int rows = kThreads / tpr;
    const dim3 grid(num_items, (lanes + tpr - 1) / tpr);
    const size_t smem =
        rows > 1 ? (GATED ? 2 : 1) * kThreads * vec * sizeof(float) : 0;
    const T* ta = static_cast<const T*>(a);
    const T* tb = static_cast<const T*>(b);
    if (wide)
      partial_kernel<T, kVec, GATED><<<grid, kThreads, smem, stream>>>(
          ta, ld_a, tb, ld_b, item_rows, partial, plane, f, tpr, rows);
    else
      partial_kernel<T, 1, GATED><<<grid, kThreads, smem, stream>>>(
          ta, ld_a, tb, ld_b, item_rows, partial, plane, f, tpr, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n, (f + kThreads - 1) / kThreads);
  finish_kernel<T, GATED><<<grid, kThreads, 0, stream>>>(
      partial, plane, item_ptr, static_cast<T*>(out), f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int alignn_eggc_gated_aggregate(
    const void* m, long long ld_m, const void* bh, long long ld_bh,
    const void* item_rows, int num_items, const void* item_ptr,
    void* partial, void* out, int n, int f, int dtype, void* stream) {
  if (n == 0 || f == 0) return cudaSuccess;
  const int* rows = static_cast<const int*>(item_rows);
  const int* ptr = static_cast<const int*>(item_ptr);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return reduce<float, true>(m, ld_m, bh, ld_bh, rows, num_items, ptr,
                               part, out, n, f, st);
  if (dtype == 1)
    return reduce<__nv_bfloat16, true>(m, ld_m, bh, ld_bh, rows, num_items,
                                       ptr, part, out, n, f, st);
  if (dtype == 2)
    return reduce<__half, true>(m, ld_m, bh, ld_bh, rows, num_items, ptr,
                                part, out, n, f, st);
  return cudaErrorInvalidValue;
}

extern "C" int alignn_sorted_segment_sum(const void* x, long long ld_x,
                                         const void* item_rows,
                                         int num_items, const void* item_ptr,
                                         void* partial, void* out, int n,
                                         int f, int dtype, void* stream) {
  if (n == 0 || f == 0) return cudaSuccess;
  const int* rows = static_cast<const int*>(item_rows);
  const int* ptr = static_cast<const int*>(item_ptr);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return reduce<float, false>(x, ld_x, nullptr, 0, rows, num_items, ptr,
                                part, out, n, f, st);
  if (dtype == 1)
    return reduce<__nv_bfloat16, false>(x, ld_x, nullptr, 0, rows, num_items,
                                        ptr, part, out, n, f, st);
  if (dtype == 2)
    return reduce<__half, false>(x, ld_x, nullptr, 0, rows, num_items, ptr,
                                 part, out, n, f, st);
  return cudaErrorInvalidValue;
}

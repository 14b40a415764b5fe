// Edge-gated graph convolution reductions over dst-sorted (CSR) segments.
//
// K1 eggc_gated_aggregate replaces the TPU kernel
//   alignn_tpu/ops/pallas_eggc.py `_kernel` (launched by `_pallas_forward`):
//     h[n] = sum_{e in seg(n)} sigmoid(m_e) * bh_e / (sum sigmoid(m_e) + 1e-6)
// K2 sorted_segment_sum replaces
//   alignn_tpu/ops/pallas_eggc.py `_ssum_kernel` (launched by `_ssum_pallas`):
//     out[n] = sum_{e in seg(n)} x_e
// Segment n is the contiguous row range [row_ptr[n], row_ptr[n+1]) of the
// dst-sorted edge table.  The result is deterministic: every sum is taken
// in a fixed order, whichever warp happens to take it.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels are memory bound.  K1
// reads 2*E*F input elements and writes N*F; K2 reads E*F and writes N*F.
// K1 does about 7 f32 operations an element, a sixth of its byte time at
// the card's 67 TFLOP/s f32 rate; tensor cores have no role.  What counts
// is enough bytes in flight on every SM and no byte moved that the bound
// does not count.
//
// Design: one launch a call, one warp a work item, no shared memory.
//  - Segments are cut into items of at most 32 rows (`item_rows`; the
//    cut, `item_ptr` and the item -> segment map `owner` are built once
//    per batch by the wrapper's `Segments`).  A warp walks its item's rows
//    in series, so the longest item bounds the kernel's tail: 128-row
//    items made the trash segment's warps the tail at the 64-cell
//    training batch.  The k-NN graphs' line-graph segments have at most
//    28 rows (512-atom Si) and 13 (that batch), so there only the trash
//    segment is cut.  Warp w takes item num_items-1-w: the trash
//    segment, whose items come last, starts first.  Blocks are 4 warps
//    (5 blocks an SM at 82-92 registers).
//  - The warp's lanes cover the feature axis with 16-byte loads (C = 8
//    elements a lane: one 16-byte vector of bf16/f16 or two of f32), in
//    column chunks of 32*C; for F < 32*C the spare lanes take row groups
//    (RG = 32/lanes) that meet through a fixed shuffle butterfly.  Each
//    lane walks its rows in order with 128 bytes of row loads in flight
//    (rows_in_flight) and sums in f32 registers; K1's sigmoid is
//    1/(1+expf(-m)) in f32 (the reciprocal correctly rounded, as the
//    division).  An item's row loads wait for its row range only; the
//    segment's pointers are read meanwhile.
//  - A segment of one item (the common case) is written by its warp
//    directly in the output dtype (K1 divided by den + 1e-6).  Only the
//    items of longer segments write f32 partials.  Their segment is
//    finished in the same launch by a two-level tree of arrival counters:
//    the last of each group of kGroup consecutive items (after a
//    __threadfence) sums the group's partials in item order; with more
//    than one group, the group sums land in the group's first partial row
//    and the last group to finish sums them in group order and writes the
//    output.  The 512-atom cell's trash segment (2,788 items) takes 32 +
//    88 ordered loads a lane, not 2,788.  The combiner sets its counter
//    back to 0, so the counters (2 * num_items ints, kept with the
//    Segments) are 0 between launches, and a CUDA graph replays the
//    kernel as it is.
//  - Empty segments: ceil(N/32) more warps each read 33 entries of
//    row_ptr and write zeros to the empty segments among their 32.
//  - Padding items (past item_ptr[N], from `with_capacity`) have owner N,
//    cover no rows and write nothing.
// The TPU kernel's tiling (node tiles of 128, one-hot [E,128] matmuls on
// the MXU, TE-aligned DMA bases) is not carried over.
//
// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() of its launch.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (both 16-bit types summed in f32).
// `ld_*` are row strides in elements; the feature axis must be unit-stride.
// `partial` is f32 scratch of num_items*F floats (K2) or 2*num_items*F
// (K1), allocated by the caller; `counters` holds 2*num_items ints that
// are 0 on entry and on exit.  One launch at a time may use a given
// `counters`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;               // warps a block, each on its own
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneBytes = 128;         // row loads in flight a lane
constexpr int kGroup = 32;              // items a level-1 combine sums
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-6f;

// What a walk over rows sums: kSum x (K2, and K2's partials); kGated
// sigmoid(m) * bh and sigmoid(m) (K1's rows); kPair two planes (K1's
// partials).
enum Mode { kSum, kGated, kPair };

template <typename T>
struct Packed2;
template <>
struct Packed2<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 unpack(type x) {
    return __bfloat1622float2(x);
  }
  static __device__ __forceinline__ type pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Packed2<__half> {
  using type = __half2;
  static __device__ __forceinline__ float2 unpack(type x) {
    return __half22float2(x);
  }
  static __device__ __forceinline__ type pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

// A lane's C elements of one row as loaded (converted only when summed,
// so that U rows in flight cost U * 16 bytes of registers a vector).
template <typename T, int C>
struct Raw {
  T x;                                   // C == 1
};
template <>
struct Raw<float, 8> {
  float4 lo, hi;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 q;
};
template <>
struct Raw<__half, 8> {
  uint4 q;
};

// CG: through L2 only (`ld.global.cg`), for partials that other warps wrote
// in this launch; otherwise the read-only path.
template <typename T, int C, bool CG>
__device__ __forceinline__ void load_raw(const T* __restrict__ p,
                                         Raw<T, C>& r) {
  if constexpr (C == 1) {
    if constexpr (CG)
      r.x = __ldcg(p);
    else
      r.x = p[0];
  } else if constexpr (std::is_same<T, float>::value) {
    const float4* q = reinterpret_cast<const float4*>(p);
    if constexpr (CG) {
      r.lo = __ldcg(q);
      r.hi = __ldcg(q + 1);
    } else {
      r.lo = __ldg(q);
      r.hi = __ldg(q + 1);
    }
  } else {
    static_assert(!CG, "partials are f32");
    r.q = __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int C>
__device__ __forceinline__ void to_floats(const Raw<T, C>& r, float* v) {
  if constexpr (C == 1) {
    v[0] = to_float(r.x);
  } else if constexpr (std::is_same<T, float>::value) {
    v[0] = r.lo.x;
    v[1] = r.lo.y;
    v[2] = r.lo.z;
    v[3] = r.lo.w;
    v[4] = r.hi.x;
    v[5] = r.hi.y;
    v[6] = r.hi.z;
    v[7] = r.hi.w;
  } else {
    const auto* h = reinterpret_cast<const typename Packed2<T>::type*>(&r.q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = Packed2<T>::unpack(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// C values to p: in T (the output) or f32 (partials, T = float).
template <typename T, int C>
__device__ __forceinline__ void store(T* __restrict__ p, const float* v) {
  if constexpr (C == 1) {
    p[0] = from_float<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 q;
    auto* h = reinterpret_cast<typename Packed2<T>::type*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = Packed2<T>::pack(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

template <int MODE>
__host__ __device__ constexpr int acc_planes() {
  return MODE == kSum ? 1 : 2;
}

// Rows in flight a lane: kLaneBytes of loads (8 rows of 16-byte vectors
// for one 16-bit table, 2 rows of two f32 tables), at least 2 rows and at
// most 16.  More would cost registers, and with them warps an SM: 256
// bytes (126-147 registers) and a 64-register cap (spills) both measured
// slower on the H100.
template <int MODE, typename T, int C>
__host__ __device__ constexpr int rows_in_flight() {
  constexpr int u = kLaneBytes / (static_cast<int>(sizeof(Raw<T, C>)) *
                                  acc_planes<MODE>());
  return u < 2 ? 2 : u > 16 ? 16 : u;
}

// Rows rg, rg + RG, ... of [0, rows): a lane's C columns at a (and b) of
// row 0, summed in row order into acc, U rows' loads issued before any is
// summed.
template <int MODE, typename T, int C, bool CG>
__device__ __forceinline__ void walk(const T* __restrict__ a, long long ld_a,
                                     const T* __restrict__ b, long long ld_b,
                                     int rows, int rg, int RG,
                                     float (&acc)[acc_planes<MODE>()][C]) {
  constexpr int U = rows_in_flight<MODE, T, C>();
  for (int r0 = rg; r0 < rows; r0 += U * RG) {
    Raw<T, C> ra[U], rb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * RG;
      if (r < rows) {
        load_raw<T, C, CG>(a + r * ld_a, ra[u]);
        if constexpr (MODE != kSum) load_raw<T, C, CG>(b + r * ld_b, rb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * RG < rows) {
        float av[C];
        to_floats<T, C>(ra[u], av);
        if constexpr (MODE == kSum) {
#pragma unroll
          for (int v = 0; v < C; ++v) acc[0][v] += av[v];
        } else {
          float bv[C];
          to_floats<T, C>(rb[u], bv);
#pragma unroll
          for (int v = 0; v < C; ++v) {
            if constexpr (MODE == kGated) {
              const float s = __frcp_rn(1.f + expf(-av[v]));
              acc[0][v] += s * bv[v];
              acc[1][v] += s;
            } else {
              acc[0][v] += av[v];
              acc[1][v] += bv[v];
            }
          }
        }
      }
    }
  }
}

// The row groups' sums meet in lane group 0 (a fixed butterfly).
template <int P, int C>
__device__ __forceinline__ void meet(float (&acc)[P][C], int tpr) {
  for (int off = tpr; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int v = 0; v < C; ++v)
        acc[k][v] += __shfl_xor_sync(kFull, acc[k][v], off);
}

// True in every lane of the warp whose arrival at `counter` is the
// `expected`-th; that warp sets the counter back to 0.  The fence before
// makes this warp's partials visible before its arrival; the one after
// orders the last warp's reads of the others' partials after it.
__device__ __forceinline__ bool last_arrival(int* counter, int expected,
                                             int lane) {
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
  }
  last = __shfl_sync(kFull, last, 0);
  if (last) __threadfence();
  return last;
}

template <typename T, int C, bool GATED>
struct Reduce {
  static constexpr int P = GATED ? 2 : 1;

  const T* a;
  long long ld_a;
  const T* b;
  long long ld_b;
  const int* item_rows;
  const int* item_ptr;
  const int* owner;
  const int* row_ptr;
  int* counters;
  float* partial;
  T* out;
  long long plane;  // num_items * f: K1's second partial plane
  int num_items, n, f, tpr, chunks;

  // Lane's column in chunk `c`, or -1 for a lane past the feature axis.
  __device__ __forceinline__ int column(int c, int lane) const {
    const int col = (c * tpr + lane % tpr) * C;
    return col < f ? col : -1;
  }

  __device__ __forceinline__ void write_out(int seg, int col,
                                            float (&acc)[P][C]) const {
    float h[C];
#pragma unroll
    for (int v = 0; v < C; ++v)
      h[v] = GATED ? acc[0][v] / (acc[1][v] + kEps) : acc[0][v];
    store<T, C>(out + static_cast<long long>(seg) * f + col, h);
  }

  __device__ __forceinline__ void write_partial(long long row, int col,
                                                float (&acc)[P][C]) const {
#pragma unroll
    for (int k = 0; k < P; ++k)
      store<float, C>(partial + k * plane + row * f + col, acc[k]);
  }

  // Sum `rows` partial rows, `stride` items apart from item `base`, into
  // the output of `seg` (seg >= 0) or into partial row `base` (seg < 0).
  __device__ __forceinline__ void combine(long long base, int rows,
                                          int stride, int seg,
                                          int lane) const {
    const int RG = 32 / tpr, rg = lane / tpr;
    const long long ld = static_cast<long long>(stride) * f;
    for (int c = 0; c < chunks; ++c) {
      const int col = column(c, lane);
      float acc[P][C] = {};
      if (col >= 0) {
        const float* p = partial + base * f + col;
        walk<GATED ? kPair : kSum, float, C, true>(p, ld, p + plane, ld,
                                                   rows, rg, RG, acc);
      }
      meet(acc, tpr);
      if (rg == 0 && col >= 0) {
        if (seg >= 0)
          write_out(seg, col, acc);
        else
          write_partial(base, col, acc);
      }
    }
  }

  __device__ __forceinline__ void item(int w, int lane) const {
    // The rows' loads wait for item_rows only, not for the segment's
    // pointers, which are read meanwhile.  A padding item of
    // `with_capacity` (owner n) covers no rows and writes nothing.
    const int i = num_items - 1 - w;
    const int seg = owner[i];
    const int lo = item_rows[i];
    const int rows = item_rows[i + 1] - lo;
    const bool real = seg < n;
    const int first = real ? item_ptr[seg] : 0;
    const int count = real ? item_ptr[seg + 1] - first : 0;
    const int RG = 32 / tpr, rg = lane / tpr;
    for (int c = 0; c < chunks; ++c) {
      const int col = column(c, lane);
      float acc[P][C] = {};
      if (col >= 0)
        walk<GATED ? kGated : kSum, T, C, false>(
            a + lo * ld_a + col, ld_a, GATED ? b + lo * ld_b + col : nullptr,
            ld_b, rows, rg, RG, acc);
      meet(acc, tpr);
      if (real && rg == 0 && col >= 0) {
        if (count == 1)
          write_out(seg, col, acc);
        else
          write_partial(i, col, acc);
      }
    }
    if (count <= 1) return;
    // level 1: the last item of each group of kGroup sums the group
    const int k0 = (i - first) / kGroup * kGroup;
    const int size = min(kGroup, count - k0);
    if (!last_arrival(counters + first + k0, size, lane)) return;
    const int groups = (count + kGroup - 1) / kGroup;
    combine(first + k0, size, 1, groups == 1 ? seg : -1, lane);
    if (groups == 1) return;
    // level 2: the last group sums the group sums, in group order
    if (!last_arrival(counters + num_items + first, groups, lane)) return;
    combine(first, groups, kGroup, seg, lane);
  }

  // Zeros to the empty segments among [32 z, 32 z + 32).
  __device__ __forceinline__ void zero_empty(int z, int lane) const {
    const int s = z * 32 + lane;
    const bool empty = s < n && row_ptr[s] == row_ptr[s + 1];
    unsigned mask = __ballot_sync(kFull, empty);
    float zeros[C] = {};
    while (mask) {
      const int seg = z * 32 + __ffs(mask) - 1;
      mask &= mask - 1;
      for (int col = lane * C; col < f; col += 32 * C)
        store<T, C>(out + static_cast<long long>(seg) * f + col, zeros);
    }
  }
};

template <typename T, int C, bool GATED>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const Reduce<T, C, GATED> r) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w < r.num_items)
    r.item(w, lane);
  else
    r.zero_empty(w - r.num_items, lane);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, int C, bool GATED>
cudaError_t launch(Reduce<T, C, GATED> r, cudaStream_t stream) {
  const int lanes = (r.f + C - 1) / C;
  r.tpr = 32;
  if (lanes < 32) {
    r.tpr = 1;
    while (r.tpr < lanes) r.tpr <<= 1;
  }
  r.chunks = (lanes + r.tpr - 1) / r.tpr;
  r.plane = static_cast<long long>(r.num_items) * r.f;
  const long long warps = static_cast<long long>(r.num_items) + (r.n + 31) / 32;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  segment_kernel<T, C, GATED><<<blocks, kThreads, 0, stream>>>(r);
  return cudaGetLastError();
}

template <typename T, bool GATED>
cudaError_t reduce(const void* a, long long ld_a, const void* b,
                   long long ld_b, const void* item_rows, int num_items,
                   const void* item_ptr, const void* owner,
                   const void* row_ptr, void* counters, void* partial,
                   void* out, int n, int f, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = f % 8 == 0 && ld_a % kVec == 0 && aligned16(a) &&
                    aligned16(out) && aligned16(partial) &&
                    (!GATED || (ld_b % kVec == 0 && aligned16(b)));
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const int* rows = static_cast<const int*>(item_rows);
  const int* ptr = static_cast<const int*>(item_ptr);
  const int* own = static_cast<const int*>(owner);
  const int* rp = static_cast<const int*>(row_ptr);
  int* cnt = static_cast<int*>(counters);
  float* part = static_cast<float*>(partial);
  T* o = static_cast<T*>(out);
  if (wide)
    return launch(Reduce<T, 8, GATED>{ta, ld_a, tb, ld_b, rows, ptr, own, rp,
                                      cnt, part, o, 0, num_items, n, f},
                  stream);
  return launch(Reduce<T, 1, GATED>{ta, ld_a, tb, ld_b, rows, ptr, own, rp,
                                    cnt, part, o, 0, num_items, n, f},
                stream);
}

}  // namespace

extern "C" int alignn_eggc_gated_aggregate(
    const void* m, long long ld_m, const void* bh, long long ld_bh,
    const void* item_rows, int num_items, const void* item_ptr,
    const void* owner, const void* row_ptr, void* counters, void* partial,
    void* out, int n, int f, int dtype, void* stream) {
  if (n == 0 || f == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return reduce<float, true>(m, ld_m, bh, ld_bh, item_rows, num_items,
                               item_ptr, owner, row_ptr, counters, partial,
                               out, n, f, st);
  if (dtype == 1)
    return reduce<__nv_bfloat16, true>(m, ld_m, bh, ld_bh, item_rows,
                                       num_items, item_ptr, owner, row_ptr,
                                       counters, partial, out, n, f, st);
  if (dtype == 2)
    return reduce<__half, true>(m, ld_m, bh, ld_bh, item_rows, num_items,
                                item_ptr, owner, row_ptr, counters, partial,
                                out, n, f, st);
  return cudaErrorInvalidValue;
}

extern "C" int alignn_sorted_segment_sum(
    const void* x, long long ld_x, const void* item_rows, int num_items,
    const void* item_ptr, const void* owner, const void* row_ptr,
    void* counters, void* partial, void* out, int n, int f, int dtype,
    void* stream) {
  if (n == 0 || f == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return reduce<float, false>(x, ld_x, nullptr, 0, item_rows, num_items,
                                item_ptr, owner, row_ptr, counters, partial,
                                out, n, f, st);
  if (dtype == 1)
    return reduce<__nv_bfloat16, false>(x, ld_x, nullptr, 0, item_rows,
                                        num_items, item_ptr, owner, row_ptr,
                                        counters, partial, out, n, f, st);
  if (dtype == 2)
    return reduce<__half, false>(x, ld_x, nullptr, 0, item_rows, num_items,
                                 item_ptr, owner, row_ptr, counters, partial,
                                 out, n, f, st);
  return cudaErrorInvalidValue;
}

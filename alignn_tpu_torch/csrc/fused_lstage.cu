// Fused dense L-stage (graph/dense.py layout): node j owns the edge rows
// [j*D, (j+1)*D) and the pair rows [j*D*D, (j+1)*D*D) in (j, t, s) order,
// s fastest.  The edge mask arrives folded into sg and dg (x - 1e9), so a
// pair is masked iff either side is and sigmoid gives exactly 0 there.
//
// K6 fused_lstage_fwd replaces the TPU kernel
//   alignn_tpu/ops/pallas_fused_lstage.py `_kernel` (launched by
//   `_pallas_fused`):
//     eg        = z W + b                    (z [N*D*D, F], W [F, F])
//     m2[j,t,s] = eg + sg[j,s] + dg[j,t]
//     h[j,t]    = sum_s sig(m2) bh[j,s] / (sum_s sig(m2) + 1e-6)
//     e_new     = z + silu(layernorm(m2))    (eps 1e-5, two-pass variance)
// K7 fused_lstage_bwd replaces `_bwd_kernel` (`_pallas_bwd`), the
// first-order VJP with cotangents de on e_new and dh on h:
//     dm2 = sig (1 - sig) (bh ginv + gh) + LN/SiLU backward of de
//     dz  = de + dm2_c W^T,  dW = z^T dm2_c,  db = sum_rows dm2
//     dsg[j,s] = sum_t dm2,  ddg[j,t] = sum_s dm2,  dbh[j,s] = sum_t sig ginv
//     dscale, dbias = row sums of dln xhat and dln
//   where dm2_c is dm2 rounded to z's dtype (a no-op in f32).
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
// both are bound by the products.  At the dense training batch (86,528 pair
// rows, F 256) K6's product is 11.3 GFLOP (0.169 ms) against 205 MB of
// tables (0.061 ms); K7 has three such products (34.0 GFLOP, 0.508 ms).
// The products must be f32 FMA, not TF32: the f32 limit against the plain
// version is 1e-5 x max|plain|.  bf16 inputs are widened to f32, where a
// bf16 x bf16 product is exact, which is what the TPU's matrix unit does.
// In bf16 the card could run the products on its tensor cores (989
// TFLOP/s), and both kernels are then bound by bytes or nearly: K6 102 MB
// (0.031 ms) at the training batch; these SIMT products are far from that.
//
// Design against that bound (first correct version):
//  - One SIMT tiled product shared by all three: a block of 256 threads
//    (16 x 16) owns a [64, F] f32 output tile, each thread a 4 x F/16
//    register tile; K runs in slices of 32 staged in shared memory (A as
//    [32][65] f32, B as [32][F] f32, read as float4).  About 10 shared
//    memory wavefronts per 64 FMAs per warp.
//  - K6: a tile is G = 64 / D whole t-groups (a t-group is D pair rows, so
//    h's sums over s and every row's LayerNorm stay in the block).  After
//    the product the tile becomes m2 in shared memory ([64][F + 4] f32, 66 KB
//    at F 256): h by (t-group, feature), LayerNorm by one warp per row, two
//    passes over the row.  m2 never reaches device memory.
//  - K7 is four launches behind one entry point.  7a: one block per node j,
//    since dsg[j,s] and dbh[j,s] sum over all D t-groups of the node; it walks
//    the node in tiles of G t-groups: recomputes eg (product 1) and m2, the
//    aggregation backward, the LayerNorm backward (one warp per row), writes
//    ddg and dz = de + dm2_c W^T (product 2, with dm2_c read from shared
//    memory), writes dm2_c to a scratch table and keeps dsg, dbh in shared
//    memory and db, dscale, dbias in registers until the node is done.  7b:
//    dW = z^T dm2_c over chunks of kDwChunkRows rows (product 3), one f32
//    partial [F, F] per chunk.  7c, 7d: the partials of dW (per chunk) and
//    of db, dscale, dbias (per node) summed in a fixed order.  No atomics: the
//    TPU kernel carried dW across its sequential grid, Hopper blocks run in
//    no order.
//  - sigmoid is 1 / (1 + exp(-x)): exactly 0 at the folded -1e9 and -2e9.
//    Masked rows of e_new are finite garbage, as in JAX.
//
// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() of its launches, kErrTile (-2) when a t-group of D rows
// exceeds the 64-row tile, or kErrSmem (-1) when a block would need more
// than 232,448 bytes of shared memory.  alignn_fused_lstage_bwd_chunks gives
// the number of dW partials K7 writes, for the caller's scratch.  dtype: 0 =
// float32, 1 = bfloat16; F is 128 or 256.  z, sg, dg, bh, de and dh take any
// row stride (`ld_*`, in elements) with a unit-stride feature axis; w and
// wt ([F, F], in z's dtype), the f32 vectors b, scale and bias, the scratch
// tables and all outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;   // rows of a product tile
constexpr int kK = 32;          // K slice of a product
constexpr int kAStride = kTileRows + 1;
constexpr float kEps = 1e-6f;
constexpr float kLnEps = 1e-5f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // opt-in limit of one H100 block
constexpr int kErrSmem = -1;
constexpr int kErrTile = -2;
constexpr long long kDwChunkRows = 1024;   // pair rows per partial of dW

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back (dm2 "cast to z's dtype").
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][c*4+v] += sum_q A(ty*4+i, q) B[q][c*64 + tx*4 + v] over one K slice,
// with A(m, q) = a[m * a_m + q * a_q] and B = bs [kK][F] in shared memory.
template <int F>
__device__ __forceinline__ void fma_slice(const float* a, int a_m, int a_q,
                                          const float* bs,
                                          float (&acc)[4][F / 16], int tx,
                                          int ty) {
#pragma unroll 4
  for (int q = 0; q < kK; ++q) {
    float av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * a_m + q * a_q];
#pragma unroll
    for (int c = 0; c < F / 64; ++c) {
      const float4 b =
          *reinterpret_cast<const float4*>(bs + q * F + c * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c * 4 + 0] = fmaf(av[i], b.x, acc[i][c * 4 + 0]);
        acc[i][c * 4 + 1] = fmaf(av[i], b.y, acc[i][c * 4 + 1]);
        acc[i][c * 4 + 2] = fmaf(av[i], b.z, acc[i][c * 4 + 2]);
        acc[i][c * 4 + 3] = fmaf(av[i], b.w, acc[i][c * 4 + 3]);
      }
    }
  }
}

template <int F>
__device__ __forceinline__ void zero(float (&acc)[4][F / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < F / 16; ++c) acc[i][c] = 0.f;
}

// as[q][m] = x[row0 + m][k0 + q] for m < rows, else 0 (A of z W).
template <typename T>
__device__ __forceinline__ void load_row_slice(const T* __restrict__ x,
                                               long long ld, long long row0,
                                               int rows, int k0, float* as) {
  for (int idx = threadIdx.x; idx < kTileRows * kK; idx += kThreads) {
    const int m = idx / kK, q = idx % kK;
    as[q * kAStride + m] =
        m < rows ? to_float(x[(row0 + m) * ld + k0 + q]) : 0.f;
  }
}

// as[q][m] = x[r0 + q][k0 + m] for r0 + q < end, else 0 (A of z^T dm2).
template <typename T>
__device__ __forceinline__ void load_col_slice(const T* __restrict__ x,
                                               long long ld, long long r0,
                                               long long end, int k0,
                                               float* as) {
  for (int idx = threadIdx.x; idx < kTileRows * kK; idx += kThreads) {
    const int q = idx / kTileRows, m = idx % kTileRows;
    as[q * kAStride + m] =
        r0 + q < end ? to_float(x[(r0 + q) * ld + k0 + m]) : 0.f;
  }
}

// bs[q][n] = x[r0 + q][n] for r0 + q < end, else 0 (a contiguous [*, F]).
template <typename T, int F>
__device__ __forceinline__ void load_b_slice(const T* __restrict__ x,
                                             long long r0, long long end,
                                             float* bs) {
  for (int idx = threadIdx.x; idx < kK * F; idx += kThreads) {
    const int q = idx / F;
    bs[idx] = r0 + q < end ? to_float(x[r0 * F + idx]) : 0.f;
  }
}

// The register tile plus b[n] -> ms [kTileRows][F + 4].
template <int F>
__device__ __forceinline__ void store_tile(const float (&acc)[4][F / 16],
                                           const float* __restrict__ b,
                                           float* ms, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < F / 64; ++c) {
      const int n = c * 64 + tx * 4;
      *reinterpret_cast<float4*>(ms + (ty * 4 + i) * (F + 4) + n) =
          make_float4(acc[i][c * 4] + b[n], acc[i][c * 4 + 1] + b[n + 1],
                      acc[i][c * 4 + 2] + b[n + 2],
                      acc[i][c * 4 + 3] + b[n + 3]);
    }
}

// ms rows r < rows of the tile starting at t-group g0: m2 = eg + sg + dg.
template <typename T, int F>
__device__ __forceinline__ void add_gates(float* ms, int rows, long long g0,
                                          int D, const T* __restrict__ sg,
                                          long long ld_sg,
                                          const T* __restrict__ dg,
                                          long long ld_dg) {
  for (int idx = threadIdx.x; idx < rows * F; idx += kThreads) {
    const int r = idx / F, n = idx % F;
    const long long g = g0 + r / D;          // edge row (j, t)
    const long long s_row = g / D * D + r % D;  // edge row (j, s)
    float x = ms[r * (F + 4) + n];
    x = x + to_float(sg[s_row * ld_sg + n]);
    x = x + to_float(dg[g * ld_dg + n]);
    ms[r * (F + 4) + n] = x;
  }
}

struct FwdArgs {
  const void *z, *w, *b, *sg, *dg, *bh, *scale, *bias;
  long long ld_z, ld_sg, ld_dg, ld_bh;
  void *e_new, *h;
};

// K6: block = G t-groups (G * D <= 64 pair rows).  Two blocks per SM (at
// most 128 registers a thread).
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2)
    fused_fwd_kernel(const T* __restrict__ z, long long ld_z,
                     const T* __restrict__ w, const float* __restrict__ b,
                     const T* __restrict__ sg, long long ld_sg,
                     const T* __restrict__ dg, long long ld_dg,
                     const T* __restrict__ bh, long long ld_bh,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ e_new,
                     T* __restrict__ h, long long groups, int D, int G) {
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                     // [kTileRows][F + 4] m2
  float* as = smem;                     // [kK][kAStride], during the product
  float* ws = smem + kK * kAStride;     // [kK][F], during the product
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g0 = static_cast<long long>(blockIdx.x) * G;
  const int gcount =
      static_cast<int>(groups - g0 < G ? groups - g0 : G);
  const int rows = gcount * D;
  const long long row0 = g0 * D;

  float acc[4][F / 16];
  zero<F>(acc);
  for (int k0 = 0; k0 < F; k0 += kK) {
    load_row_slice<T>(z, ld_z, row0, rows, k0, as);
    load_b_slice<T, F>(w, k0, F, ws);
    __syncthreads();
    fma_slice<F>(as, 1, kAStride, ws, acc, tx, ty);
    __syncthreads();
  }
  store_tile<F>(acc, b, ms, tx, ty);
  __syncthreads();
  add_gates<T, F>(ms, rows, g0, D, sg, ld_sg, dg, ld_dg);
  __syncthreads();

  // h[j,t]: one thread per (t-group, feature), sums over s in f32
  for (int idx = threadIdx.x; idx < gcount * F; idx += kThreads) {
    const int gg = idx / F, n = idx % F;
    const long long g = g0 + gg;
    const long long s0 = g / D * D;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < D; ++s) {
      const float sg_v = sigmoid(ms[(gg * D + s) * (F + 4) + n]);
      num += sg_v * to_float(bh[(s0 + s) * ld_bh + n]);
      den += sg_v;
    }
    h[g * F + n] = from_float<T>(num / (den + kEps));
  }

  // e_new = z + silu(LN(m2)): one warp per row, two passes over the row
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = ms + r * (F + 4);
    float x[F / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      x[i] = row[lane + 32 * i];
      sum += x[i];
    }
    const float mean = warp_sum(sum) / F;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < F / 32; ++i) sq += (x[i] - mean) * (x[i] - mean);
    const float rstd = 1.f / sqrtf(warp_sum(sq) / F + kLnEps);
    const long long pr = row0 + r;
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const int n = lane + 32 * i;
      const float ln = (x[i] - mean) * rstd * scale[n] + bias[n];
      e_new[pr * F + n] =
          from_float<T>(to_float(z[pr * ld_z + n]) + ln * sigmoid(ln));
    }
  }
}

struct BwdArgs {
  const void *z, *w, *wt, *b, *sg, *dg, *bh, *scale, *bias, *de, *dh;
  long long ld_z, ld_sg, ld_dg, ld_bh, ld_de, ld_dh;
  void *dz, *dsg, *ddg, *dbh;     // outputs in z's dtype
  void *dm2c;                     // scratch [N*D*D, F] in z's dtype
  float *dw_part, *vec_part;      // scratch [chunks][F][F], [N][3][F]
  float *dw, *vec;                // outputs [F][F], [3][F] (db, dscale, dbias)
};

// Shared memory of a 7a block, in floats.
template <int F>
size_t bwd_node_floats(int D, int G) {
  return static_cast<size_t>(kTileRows) * (F + 4) + kK * F +
         2 * static_cast<size_t>(D) * F + 2 * static_cast<size_t>(G) * F;
}

// 7a: one block per node j, in tiles of G t-groups.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    fused_bwd_node_kernel(BwdArgs a, int D, int G) {
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                           // [kTileRows][F + 4]
  float* as = smem;                           // [kK][kAStride], product 1
  float* ws = smem + kTileRows * (F + 4);     // [kK][F]
  float* s_dsg = ws + kK * F;                 // [D][F]
  float* s_dbh = s_dsg + D * F;               // [D][F]
  float* s_gi = s_dbh + D * F;                // [G][F] ginv
  float* s_gh = s_gi + G * F;                 // [G][F] gh
  const T* z = static_cast<const T*>(a.z);
  const T* sg = static_cast<const T*>(a.sg);
  const T* dg = static_cast<const T*>(a.dg);
  const T* bh = static_cast<const T*>(a.bh);
  const T* de = static_cast<const T*>(a.de);
  const T* dh = static_cast<const T*>(a.dh);
  const float* b = static_cast<const float*>(a.b);
  const float* scale = static_cast<const float*>(a.scale);
  const float* bias = static_cast<const float*>(a.bias);
  T* dz = static_cast<T*>(a.dz);
  T* ddg = static_cast<T*>(a.ddg);
  T* dm2c = static_cast<T*>(a.dm2c);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long j = blockIdx.x;
  const long long e0 = j * D;                  // the node's first edge row

  for (int idx = threadIdx.x; idx < D * F; idx += kThreads)
    s_dsg[idx] = s_dbh[idx] = 0.f;
  float p_db[F / 32], p_dsc[F / 32], p_dbi[F / 32];   // this warp's rows
#pragma unroll
  for (int i = 0; i < F / 32; ++i) p_db[i] = p_dsc[i] = p_dbi[i] = 0.f;
  float acc[4][F / 16];

  for (int t0 = 0; t0 < D; t0 += G) {
    const int gcount = D - t0 < G ? D - t0 : G;
    const int rows = gcount * D;
    const long long row0 = (e0 + t0) * D;

    // product 1: eg = z W + b; then m2
    zero<F>(acc);
    for (int k0 = 0; k0 < F; k0 += kK) {
      load_row_slice<T>(z, a.ld_z, row0, rows, k0, as);
      load_b_slice<T, F>(static_cast<const T*>(a.w), k0, F, ws);
      __syncthreads();
      fma_slice<F>(as, 1, kAStride, ws, acc, tx, ty);
      __syncthreads();
    }
    store_tile<F>(acc, b, ms, tx, ty);
    __syncthreads();
    add_gates<T, F>(ms, rows, e0 + t0, D, sg, a.ld_sg, dg, a.ld_dg);
    __syncthreads();

    // per (t, feature): den, h, then ginv = dh / den, gh = -dh h / den
    for (int idx = threadIdx.x; idx < gcount * F; idx += kThreads) {
      const int gg = idx / F, n = idx % F;
      float num = 0.f, den = 0.f;
      for (int s = 0; s < D; ++s) {
        const float sg_v = sigmoid(ms[(gg * D + s) * (F + 4) + n]);
        num += sg_v * to_float(bh[(e0 + s) * a.ld_bh + n]);
        den += sg_v;
      }
      den = den + kEps;
      const float hv = num / den;
      const float dhv = to_float(dh[(e0 + t0 + gg) * a.ld_dh + n]);
      s_gi[idx] = dhv / den;
      s_gh[idx] = -dhv * hv / den;
    }
    __syncthreads();
    // dbh[j,s] += sum_t sig ginv over this tile's t
    for (int idx = threadIdx.x; idx < D * F; idx += kThreads) {
      const int s = idx / F, n = idx % F;
      float acc_s = 0.f;
      for (int gg = 0; gg < gcount; ++gg)
        acc_s += sigmoid(ms[(gg * D + s) * (F + 4) + n]) * s_gi[gg * F + n];
      s_dbh[idx] += acc_s;
    }
    __syncthreads();

    // per row (one warp): dm2 = aggregation + LayerNorm/SiLU backward
    for (int r = warp; r < rows; r += kWarps) {
      float* row = ms + r * (F + 4);
      const int gg = r / D, s = r % D;
      const long long pr = row0 + r;
      float x[F / 32], xh[F / 32], dx[F / 32];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        x[i] = row[lane + 32 * i];
        sum += x[i];
      }
      const float mean = warp_sum(sum) / F;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < F / 32; ++i) sq += (x[i] - mean) * (x[i] - mean);
      const float rstd = 1.f / sqrtf(warp_sum(sq) / F + kLnEps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int n = lane + 32 * i;
        xh[i] = (x[i] - mean) * rstd;
        const float ln = xh[i] * scale[n] + bias[n];
        const float sl = sigmoid(ln);
        const float dln =
            to_float(de[pr * a.ld_de + n]) * (sl * (1.f + ln * (1.f - sl)));
        p_dsc[i] += dln * xh[i];
        p_dbi[i] += dln;
        dx[i] = dln * scale[n];
        s1 += dx[i];
        s2 += dx[i] * xh[i];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int n = lane + 32 * i;
        const float norm = rstd / F * (F * dx[i] - s1 - xh[i] * s2);
        const float sg_v = sigmoid(x[i]);
        const float agg =
            sg_v * (1.f - sg_v) *
            (to_float(bh[(e0 + s) * a.ld_bh + n]) * s_gi[gg * F + n] +
             s_gh[gg * F + n]);
        const float d = agg + norm;
        row[n] = d;
        p_db[i] += d;
      }
    }
    __syncthreads();

    // ddg[j,t] = sum_s dm2 (written); dsg[j,s] += sum_t dm2 (f32 dm2)
    for (int idx = threadIdx.x; idx < gcount * F; idx += kThreads) {
      const int gg = idx / F, n = idx % F;
      float acc_t = 0.f;
      for (int s = 0; s < D; ++s) acc_t += ms[(gg * D + s) * (F + 4) + n];
      ddg[(e0 + t0 + gg) * F + n] = from_float<T>(acc_t);
    }
    for (int idx = threadIdx.x; idx < D * F; idx += kThreads) {
      const int s = idx / F, n = idx % F;
      float acc_s = 0.f;
      for (int gg = 0; gg < gcount; ++gg)
        acc_s += ms[(gg * D + s) * (F + 4) + n];
      s_dsg[idx] += acc_s;
    }
    __syncthreads();
    // dm2 in z's dtype: in shared memory for product 2, and to the scratch
    // table for product 3
    for (int idx = threadIdx.x; idx < rows * F; idx += kThreads) {
      const int r = idx / F, n = idx % F;
      const float v = round_to<T>(ms[r * (F + 4) + n]);
      ms[r * (F + 4) + n] = v;
      dm2c[(row0 + r) * F + n] = from_float<T>(v);
    }
    __syncthreads();

    // product 2: dz = de + dm2_c W^T
    zero<F>(acc);
    for (int k0 = 0; k0 < F; k0 += kK) {
      load_b_slice<T, F>(static_cast<const T*>(a.wt), k0, F, ws);
      __syncthreads();
      fma_slice<F>(ms + k0, F + 4, 1, ws, acc, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      if (m >= rows) continue;
      const long long pr = row0 + m;
#pragma unroll
      for (int c = 0; c < F / 16; ++c) {
        const int n = (c / 4) * 64 + tx * 4 + c % 4;
        dz[pr * F + n] =
            from_float<T>(to_float(de[pr * a.ld_de + n]) + acc[i][c]);
      }
    }
    __syncthreads();
  }

  // the node's dsg and dbh rows
  T* dsg = static_cast<T*>(a.dsg);
  T* dbh = static_cast<T*>(a.dbh);
  for (int idx = threadIdx.x; idx < D * F; idx += kThreads) {
    dsg[e0 * F + idx] = from_float<T>(s_dsg[idx]);
    dbh[e0 * F + idx] = from_float<T>(s_dbh[idx]);
  }
  // db, dscale, dbias of the node: the warps' sums, added in warp order
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    const int n = lane + 32 * i;
    ms[(warp * 3 + 0) * F + n] = p_db[i];
    ms[(warp * 3 + 1) * F + n] = p_dsc[i];
    ms[(warp * 3 + 2) * F + n] = p_dbi[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * F; idx += kThreads) {
    float v = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) v += ms[wi * 3 * F + idx];
    a.vec_part[j * 3 * F + idx] = v;
  }
}

// Number of dW partials for `rows` pair rows.
long long dw_chunks(long long rows) {
  return (rows + kDwChunkRows - 1) / kDwChunkRows;
}

// 7b: dW partial of rows [c * kDwChunkRows, (c + 1) * kDwChunkRows) and W
// rows [64 kt, 64 kt + 64): block (kt, c).
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2)
    fused_bwd_dw_kernel(const T* __restrict__ z, long long ld_z,
                        const T* __restrict__ dm2c, float* __restrict__ part,
                        long long rows) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                   // [kK][kAStride]
  float* bs = smem + kK * kAStride;   // [kK][F]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kTileRows;
  const long long begin = blockIdx.y * kDwChunkRows;
  const long long end = begin + kDwChunkRows < rows ? begin + kDwChunkRows
                                                    : rows;
  float acc[4][F / 16];
  zero<F>(acc);
  for (long long r0 = begin; r0 < end; r0 += kK) {
    load_col_slice<T>(z, ld_z, r0, end, k0, as);
    load_b_slice<T, F>(dm2c, r0, end, bs);
    __syncthreads();
    fma_slice<F>(as, 1, kAStride, bs, acc, tx, ty);
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.y) * F * F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < F / 64; ++c)
      *reinterpret_cast<float4*>(out + (k0 + ty * 4 + i) * F + c * 64 +
                                 tx * 4) =
          make_float4(acc[i][c * 4], acc[i][c * 4 + 1], acc[i][c * 4 + 2],
                      acc[i][c * 4 + 3]);
}

// 7c: dW = the chunks' partials, added in chunk order; one thread each.
__global__ void __launch_bounds__(kThreads)
    sum_dw_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  int chunks, int ff) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= ff) return;
  float v = 0.f;
  for (int c = 0; c < chunks; ++c)
    v += part[static_cast<long long>(c) * ff + idx];
  dw[idx] = v;
}

// 7d: db, dscale, dbias = the nodes' partials; one warp per output, lanes
// stride the nodes, then a fixed butterfly: the same order on every run.
__global__ void __launch_bounds__(kThreads)
    sum_vec_kernel(const float* __restrict__ part, float* __restrict__ vec,
                   int nodes, int width) {
  const int out = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (out >= width) return;
  float v = 0.f;
  for (int j = lane; j < nodes; j += 32)
    v += part[static_cast<long long>(j) * width + out];
  v = warp_sum(v);
  if (lane == 0) vec[out] = v;
}

// Raises the kernel's dynamic shared memory limit where needed; kErrSmem
// where the block would need more than one H100 block may have.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return kErrSmem;
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int F>
int fwd(const FwdArgs& a, int n, int D, cudaStream_t st) {
  if (D > kTileRows) return kErrTile;   // a t-group must fit the m2 tile
  const int G = kTileRows / D;
  const long long groups = static_cast<long long>(n) * D;
  const unsigned blocks = static_cast<unsigned>((groups + G - 1) / G);
  const size_t smem = static_cast<size_t>(kTileRows) * (F + 4) * sizeof(float);
  const int err = allow_smem(fused_fwd_kernel<T, F>, smem);
  if (err != 0) return err;
  fused_fwd_kernel<T, F><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(a.z), a.ld_z, static_cast<const T*>(a.w),
      static_cast<const float*>(a.b), static_cast<const T*>(a.sg), a.ld_sg,
      static_cast<const T*>(a.dg), a.ld_dg, static_cast<const T*>(a.bh),
      a.ld_bh, static_cast<const float*>(a.scale),
      static_cast<const float*>(a.bias), static_cast<T*>(a.e_new),
      static_cast<T*>(a.h), groups, D, G);
  return cudaGetLastError();
}

template <typename T, int F>
int bwd(const BwdArgs& a, int n, int D, cudaStream_t st) {
  if (D > kTileRows) return kErrTile;
  const int G = kTileRows / D;
  const size_t smem = bwd_node_floats<F>(D, G) * sizeof(float);
  int err = allow_smem(fused_bwd_node_kernel<T, F>, smem);
  if (err != 0) return err;
  fused_bwd_node_kernel<T, F><<<n, kThreads, smem, st>>>(a, D, G);
  err = cudaGetLastError();
  if (err != 0) return err;
  const long long rows = static_cast<long long>(n) * D * D;
  const int chunks = static_cast<int>(dw_chunks(rows));
  const size_t smem_dw = (kK * kAStride + kK * F) * sizeof(float);
  fused_bwd_dw_kernel<T, F><<<dim3(F / kTileRows, chunks), kThreads, smem_dw,
                              st>>>(static_cast<const T*>(a.z), a.ld_z,
                                    static_cast<const T*>(a.dm2c), a.dw_part,
                                    rows);
  err = cudaGetLastError();
  if (err != 0) return err;
  sum_dw_kernel<<<(F * F + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.dw_part, a.dw, chunks, F * F);
  err = cudaGetLastError();
  if (err != 0) return err;
  sum_vec_kernel<<<(3 * F + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      a.vec_part, a.vec, n, 3 * F);
  return cudaGetLastError();
}

template <typename T>
int fwd_f(const FwdArgs& a, int n, int D, int f, cudaStream_t st) {
  if (f == 128) return fwd<T, 128>(a, n, D, st);
  if (f == 256) return fwd<T, 256>(a, n, D, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int bwd_f(const BwdArgs& a, int n, int D, int f, cudaStream_t st) {
  if (f == 128) return bwd<T, 128>(a, n, D, st);
  if (f == 256) return bwd<T, 256>(a, n, D, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int alignn_fused_lstage_fwd(
    const void* z, long long ld_z, const void* w, const void* b,
    const void* sg, long long ld_sg, const void* dg, long long ld_dg,
    const void* bh, long long ld_bh, const void* scale, const void* bias,
    void* e_new, void* h, int n, int D, int f, int dtype, void* stream) {
  if (n == 0 || D == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdArgs a{z,    w,     b,     sg,    dg,    bh,    scale, bias,
                  ld_z, ld_sg, ld_dg, ld_bh, e_new, h};
  if (dtype == 0) return fwd_f<float>(a, n, D, f, st);
  if (dtype == 1) return fwd_f<__nv_bfloat16>(a, n, D, f, st);
  return cudaErrorInvalidValue;
}

extern "C" int alignn_fused_lstage_bwd(
    const void* z, long long ld_z, const void* w, const void* wt,
    const void* b, const void* sg, long long ld_sg, const void* dg,
    long long ld_dg, const void* bh, long long ld_bh, const void* scale,
    const void* bias, const void* de, long long ld_de, const void* dh,
    long long ld_dh, void* dz, void* dsg, void* ddg, void* dbh, void* dm2c,
    void* dw_part, void* vec_part, void* dw, void* vec, int n, int D, int f,
    int dtype, void* stream) {
  if (n == 0 || D == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a{z,     w,     wt,    b,     sg,    dg,
                  bh,    scale, bias,  de,    dh,    ld_z,
                  ld_sg, ld_dg, ld_bh, ld_de, ld_dh, dz,
                  dsg,   ddg,   dbh,   dm2c,  static_cast<float*>(dw_part),
                  static_cast<float*>(vec_part), static_cast<float*>(dw),
                  static_cast<float*>(vec)};
  if (dtype == 0) return bwd_f<float>(a, n, D, f, st);
  if (dtype == 1) return bwd_f<__nv_bfloat16>(a, n, D, f, st);
  return cudaErrorInvalidValue;
}

extern "C" long long alignn_fused_lstage_bwd_chunks(long long rows) {
  return dw_chunks(rows);
}

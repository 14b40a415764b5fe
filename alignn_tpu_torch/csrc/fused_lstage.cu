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
// Bound on an H100 SXM (3.35 TB/s; tensor cores 495 TFLOP/s TF32, 989
// bf16): both are bound by their products.  An f32-grade product on the
// tensor cores is the 3xTF32 split (x = hi + lo, each a TF32 value; hi.hi
// + hi.lo + lo.hi accumulated in f32, lo.lo dropped): three TF32 products,
// 165 TFLOP/s of f32 products against 67 on the SIMT units.  At the dense
// training batch (86,528 pair rows, F 256) K6's product is 11.3 GFLOP:
// 0.069 ms at that rate against 205 MB of tables (0.061 ms); K7 has three
// (0.206 ms).  In bf16 the products are exact bf16 x bf16 sums in f32 (as
// on the TPU's matrix unit) at 989 TFLOP/s, and K6 is bound by its 102 MB
// of tables (0.031 ms), K7 by operations and bytes together (about 0.05).
//
// Design against that bound:
//  - Every product runs on the tensor cores with mma.sync (m16n8k8 TF32
//    for f32 operands, three per product by the split; m16n8k16 bf16 or
//    f16).
//    mma.sync and not wgmma: the epilogues (h's sums over s, LayerNorm per
//    row, the aggregation and LayerNorm backward) read the product's tile
//    by row and by t-group from shared memory, and a 64-row tile of wgmma
//    would hold all of F in one warpgroup's registers.  mma.sync's fragments
//    go to that tile directly, with eight warps on a 2 x 4 grid of 32 x F/4
//    warp tiles.
//  - Product 1 (z W) stages its whole z tile at once with cp.async into the
//    space of the m2 tile (free until the product ends); W streams through a
//    ring of K-slices of 16 in shared memory (two stages in f32, three in
//    bf16), so the next slice loads while the tensor cores work on this one.
//    W is staged in [n][k] order (from W^T for z W, from W for dm2_c W^T), so
//    bf16 fragments are single 32-bit loads; padded rows make every fragment
//    load free of bank conflicts.
//  - K6: a block is G = 64 / D whole t-groups (a t-group is D pair rows), so
//    h's sums over s and every row's LayerNorm stay in the block.  The
//    product's accumulators become m2 in shared memory ([64][F + 4] f32,
//    66.5 KB at F 256); m2 never reaches device memory.  100-105 KB of
//    shared memory a block: two blocks per SM.  Used rows 52 of 64 at D 13, 54 at
//    D 18.
//  - K7 is five launches behind one entry point.  7a: one block per tile of
//    G = min(64 / D, 16) t-groups, with K6's layout (two blocks per SM,
//    thousands of blocks): recompute eg and m2, ginv and gh per t-group, the
//    aggregation and LayerNorm backward per row (one warp per row), ddg
//    (whole t-groups), dm2_c to a scratch table, dz = de + dm2_c W^T; the
//    t-sums dsg[j,s] and dbh[j,s] of the tile's part of each node, and the
//    tile's db, dscale, dbias, go to f32 partials.  7b: dW = z^T dm2_c over
//    chunks of kDwChunkRows rows on the tensor cores (three stages), one f32
//    partial [F, F] per chunk.  7c, 7d, 7e: the partials of dW (by chunk),
//    of db, dscale, dbias (by tile) and of dsg, dbh (by the tiles that hold
//    a part of the node) summed in a fixed order.  No atomics: results are
//    the same on every run.
//  - sigmoid is 1 / (1 + exp(-x)) (a correctly rounded reciprocal): exactly
//    0 at the folded -1e9 and -2e9.  Masked rows of e_new are finite
//    garbage, as in JAX.
//  - What holds them back on the card (PERF.md): the products run well
//    below the TF32 peak on mma.sync, and the epilogues, at 16 warps per
//    SM (a 64 KB f32 m2 tile and 128 registers a thread allow two
//    blocks), do not overlap the products.
//    wgmma and a warp-specialised, persistent block are the next step.
//
// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() of its launches, kErrTile (-2) when a t-group of D rows
// exceeds the 64-row tile, or kErrSmem (-1) when a block would need more
// than 232,448 bytes of shared memory.  alignn_fused_lstage_bwd_scratch gives
// the f32 scratch K7 needs, in floats.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (handled as bf16 is, with f16 products); F
// is 128 or 256.  sg, dg, bh, de and dh take any row stride (`ld_*`, in
// elements) with a unit-stride feature axis; z too, with its base and row
// stride multiples of 16 bytes (it is staged by cp.async); w and wt ([F, F],
// in z's dtype), the f32 vectors b, scale and bias, the scratch and all
// outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 8 warps on a 2 x 4 grid of warp tiles
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;   // rows of a product tile
constexpr int kK = 16;          // K slice of a ring stage
constexpr int kMaxGroupsBwd = 16;   // K7 keeps ginv, gh of <= 16 t-groups
constexpr float kEps = 1e-6f;
constexpr float kLnEps = 1e-5f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // opt-in limit of one H100 block
constexpr int kErrSmem = -1;
constexpr int kErrTile = -2;
constexpr long long kDwChunkRows = 1024;   // pair rows per partial of dW
constexpr int kDwStages = 3;
constexpr int kDwPad = 8;   // [k][m] staging: row stride = 8 mod 32 words

// Per operand type: ring stages, the padding of a staged [row][kK] slice
// and of the f32 m2 tile's rows (chosen so fragment loads hit 32 banks).
template <typename T>
struct Tr;
template <>
struct Tr<float> {
  static constexpr int kStages = 2, kPad = 4, kMsPad = 4;
};
template <>
struct Tr<__nv_bfloat16> {
  static constexpr int kStages = 3, kPad = 8, kMsPad = 8;
};
template <>
struct Tr<__half> : Tr<__nv_bfloat16> {};

template <typename T, int F>
struct Layout {
  static constexpr int kMs = F + Tr<T>::kMsPad;   // m2 tile row stride
  static constexpr int kSt = kK + Tr<T>::kPad;     // staged row stride
  static constexpr size_t kMsBytes = sizeof(float) * kTileRows * kMs;
  static constexpr size_t kBStage = sizeof(T) * F * kSt;
  static constexpr size_t kRing = Tr<T>::kStages * kBStage;
  static constexpr size_t kFwdSmem = kMsBytes + kRing;
  // K7 reuses the ring for ginv, gh and the warps' vector partials
  static constexpr size_t kBwdAux =
      sizeof(float) * F *
      (2 * kMaxGroupsBwd > 3 * kWarps ? 2 * kMaxGroupsBwd : 3 * kWarps);
  static constexpr size_t kBwdSmem =
      kMsBytes + (kRing > kBwdAux ? kRing : kBwdAux);
  static_assert(sizeof(T) * kTileRows * kMs <= kMsBytes,
                "the z tile of product 1 lives in the m2 tile");
  // with __launch_bounds__(kThreads, 2): two blocks per SM (228 KB of
  // shared memory, 1 KB of it reserved per block)
  static_assert(2 * (kBwdSmem + 1024) <= 228 * 1024, "two blocks per SM");
};

// 1 / (1 + exp(-x)); __frcp_rn is the correctly rounded reciprocal, so
// bit for bit the IEEE division 1.f / y at a fraction of its instructions.
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + expf(-x));
}

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

// ---- cp.async ring ---------------------------------------------------------

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K-slices 0..slices-1 through a ring of S stages: issue(slice, stage)
// queues a slice's copies, compute(slice, stage) consumes it.  Group p
// always holds slice p (empty groups past the end), so wait_group<S - 1>
// at iteration s means slice s has landed.
template <int S, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int slices, Issue issue,
                                         Compute compute) {
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < slices) issue(p, p);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    const int next = s + S - 1;
    if (next < slices) issue(next, next % S);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    compute(s, s % S);
    __syncthreads();
  }
}

// dst[r][0..W) = src[(r0 + r) * ld + k0 ..] for r < valid, else 0; rows
// of dst `stride` elements apart.
template <typename T, int W = kK>
__device__ __forceinline__ void stage_rows(T* dst, int stride, int rows,
                                           const T* __restrict__ src,
                                           long long ld, long long r0,
                                           int valid, int k0) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  constexpr int kCpr = W / kVec;         // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * kCpr; idx += kThreads) {
    const int r = idx / kCpr, c = idx % kCpr;
    const bool ok = r < valid;
    cp_async16(dst + r * stride + c * kVec,
               ok ? src + (r0 + r) * ld + k0 + c * kVec : src, ok);
  }
}

// dst[q][0..width) = src[(r0 + q) * ld + c0 ..] for r0 + q < end, else 0,
// q < kK; rows of dst `stride` elements apart ([k][m] staging of dW).
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, int stride, int width,
                                           const T* __restrict__ src,
                                           long long ld, long long r0,
                                           long long end, int c0) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = width / kVec;
  for (int idx = threadIdx.x; idx < kK * cpr; idx += kThreads) {
    const int q = idx / cpr, c = idx % cpr;
    const bool ok = r0 + q < end;
    cp_async16(dst + q * stride + c * kVec,
               ok ? src + (r0 + q) * ld + c0 + c * kVec : src, ok);
  }
}

// ---- tensor-core products -------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo TF32 values (lo carries the next 11 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One m16n8k16 product of 16-bit operands T (bf16 or f16), f32 sums.
template <typename T>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// Two f32 values rounded to the 16-bit type T, a in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}
__device__ __forceinline__ uint32_t pack2(__half a, __half b) {
  return static_cast<uint32_t>(__half_as_ushort(a)) |
         (static_cast<uint32_t>(__half_as_ushort(b)) << 16);
}

// An operand X(r, k) in shared memory, r the row of the product's A (m) or
// the column of its B (n), k the depth: elem() for TF32, pair() = the
// 16-bit pair (X(r, k), X(r, k + 1)) for a product in the 16-bit type Op
// (k even).  Stored f32 values (dm2_c) are packed to Op.
template <typename T, typename Op = T>
struct RowMajor {   // X(r, k) = p[r * ld + k]
  const T* p;
  int ld;
  __device__ __forceinline__ float elem(int r, int k) const {
    return to_float(p[r * ld + k]);
  }
  __device__ __forceinline__ uint32_t pair(int r, int k) const {
    if constexpr (std::is_same<T, float>::value) {
      const float2 v = *reinterpret_cast<const float2*>(p + r * ld + k);
      return pack2<Op>(v.x, v.y);   // dm2_c: already an Op value, exact
    } else {
      return *reinterpret_cast<const uint32_t*>(p + r * ld + k);
    }
  }
};

template <typename T>
struct ColMajor {   // X(r, k) = p[k * ld + r]
  const T* p;
  int ld;
  __device__ __forceinline__ float elem(int r, int k) const {
    return to_float(p[k * ld + r]);
  }
  __device__ __forceinline__ uint32_t pair(int r, int k) const {
    return pack2(p[k * ld + r], p[(k + 1) * ld + r]);
  }
};

// acc += A B over one K slice of kK for this warp's 32 x F/4 tile: rows
// 32 wm + [0, 32), columns wn F/4 + [0, F/4).  T is the operands' type:
// f32 by the 3xTF32 split, bf16 exactly.  acc[mi][ni][c] is the element
// (32 wm + 16 mi + lane/4 + 8 (c / 2), wn F/4 + 8 ni + 2 (lane % 4) + c % 2).
template <typename T, int F, typename AX, typename BX>
__device__ __forceinline__ void mma_slice(const AX& A, const BX& B,
                                          float (&acc)[2][F / 32][4],
                                          int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wm * 32, c0 = wn * (F / 4);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < kK; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = r0 + mi * 16 + g;
        split_tf32(A.elem(r, kk + t), ah[mi][0], al[mi][0]);
        split_tf32(A.elem(r + 8, kk + t), ah[mi][1], al[mi][1]);
        split_tf32(A.elem(r, kk + t + 4), ah[mi][2], al[mi][2]);
        split_tf32(A.elem(r + 8, kk + t + 4), ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < F / 32; ++ni) {
        const int n = c0 + ni * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(B.elem(n, kk + t), bh[0], bl[0]);
        split_tf32(B.elem(n, kk + t + 4), bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {   // small terms first
          mma_tf32(acc[mi][ni], al[mi], bh);
          mma_tf32(acc[mi][ni], ah[mi], bl);
          mma_tf32(acc[mi][ni], ah[mi], bh);
        }
      }
    }
  } else {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = r0 + mi * 16 + g;
      a[mi][0] = A.pair(r, 2 * t);
      a[mi][1] = A.pair(r + 8, 2 * t);
      a[mi][2] = A.pair(r, 2 * t + 8);
      a[mi][3] = A.pair(r + 8, 2 * t + 8);
    }
#pragma unroll
    for (int ni = 0; ni < F / 32; ++ni) {
      const int n = c0 + ni * 8 + g;
      const uint32_t b[2] = {B.pair(n, 2 * t), B.pair(n, 2 * t + 8)};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_16<T>(acc[mi][ni], a[mi], b);
    }
  }
}

template <int F>
__device__ __forceinline__ void zero(float (&acc)[2][F / 32][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < F / 32; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
}

// acc = x[row0 .. row0 + 64) Bt^T, x rows valid below `rows` (zero beyond),
// Bt [F][F] row-major (B(k, n) = Bt[n][k]): the z W product of K6 and K7a.
// The whole x tile is staged at once into `as` (the m2 tile's space, free
// until the product ends, and of the m2 tile's layout), W's slices through
// the ring in `bs`.
template <typename T, int F>
__device__ __forceinline__ void product_rows(const T* __restrict__ x,
                                             long long ld, long long row0,
                                             int rows,
                                             const T* __restrict__ bt,
                                             T* as, T* bs,
                                             float (&acc)[2][F / 32][4]) {
  using L = Layout<T, F>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  zero<F>(acc);
  pipeline<Tr<T>::kStages>(
      F / kK,
      [&](int s, int stage) {
        if (s == 0)
          stage_rows<T, F>(as, L::kMs, kTileRows, x, ld, row0, rows, 0);
        stage_rows<T>(bs + stage * F * L::kSt, L::kSt, F, bt, F, 0, F,
                      s * kK);
      },
      [&](int s, int stage) {
        mma_slice<T, F>(RowMajor<T>{as + s * kK, L::kMs},
                        RowMajor<T>{bs + stage * F * L::kSt, L::kSt}, acc,
                        warp / 4, warp % 4, lane);
      });
}

// m2 = (acc + b[n]) + sg[j,s] + dg[j,t] -> ms [kTileRows][kMs] for the
// tile starting at t-group g0 (rows >= `rows`: acc + b, never read).  Every
// thread's gate loads are issued together (the loops unroll), so their
// latency is paid once.
template <typename T, int F>
__device__ __forceinline__ void store_m2(const float (&acc)[2][F / 32][4],
                                         const float* __restrict__ b,
                                         float* ms, int rows, long long g0,
                                         int D, const T* __restrict__ sg,
                                         long long ld_sg,
                                         const T* __restrict__ dg,
                                         long long ld_dg) {
  using L = Layout<T, F>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
  long long s_off[4], t_off[4];   // the rows' sg and dg offsets
  bool ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // q = 2 mi + half
    const int r = wm * 32 + (q / 2) * 16 + g + 8 * (q % 2);
    const long long et = g0 + r / D;             // edge row (j, t)
    ok[q] = r < rows;
    s_off[q] = (et / D * D + r % D) * ld_sg;     // edge row (j, s)
    t_off[q] = et * ld_dg;
  }
#pragma unroll
  for (int ni = 0; ni < F / 32; ++ni) {
    const int n = wn * (F / 4) + ni * 8 + 2 * t;
    const float b0 = b[n], b1 = b[n + 1];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = wm * 32 + (q / 2) * 16 + g + 8 * (q % 2);
      float x0 = acc[q / 2][ni][2 * (q % 2)] + b0;
      float x1 = acc[q / 2][ni][2 * (q % 2) + 1] + b1;
      if (ok[q]) {
        x0 = x0 + to_float(sg[s_off[q] + n]);
        x1 = x1 + to_float(sg[s_off[q] + n + 1]);
        x0 = x0 + to_float(dg[t_off[q] + n]);
        x1 = x1 + to_float(dg[t_off[q] + n + 1]);
      }
      *reinterpret_cast<float2*>(ms + r * L::kMs + n) = make_float2(x0, x1);
    }
  }
}

// num = sum_s sig(m2[j,t,s]) bh[j,s], den = sum_s sig(m2[j,t,s]) over the
// t-group gg of the tile (edge rows s0 .. s0 + D - 1 of its node), for
// feature n, in s order; bh's loads issued eight at a time.
template <typename T, int F>
__device__ __forceinline__ void gate_sums(const float* ms, int gg, int n,
                                          int D, const T* __restrict__ bh,
                                          long long ld_bh, long long s0,
                                          float& num, float& den) {
  constexpr int kMs = Layout<T, F>::kMs;
  num = den = 0.f;
  for (int sb = 0; sb < D; sb += 8) {
    float bv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      bv[q] = sb + q < D ? to_float(bh[(s0 + sb + q) * ld_bh + n]) : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (sb + q < D) {
        const float sg_v = sigmoid(ms[(gg * D + sb + q) * kMs + n]);
        num += sg_v * bv[q];
        den += sg_v;
      }
    }
  }
}

struct FwdArgs {
  const void *z, *w, *wt, *b, *sg, *dg, *bh, *scale, *bias;
  long long ld_z, ld_sg, ld_dg, ld_bh;
  void *e_new, *h;
};

// K6: block = G t-groups (G * D <= 64 pair rows).  Two blocks per SM.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2)
    fused_fwd_kernel(FwdArgs a, long long groups, int D, int G) {
  using L = Layout<T, F>;
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                                         // m2 tile
  T* as = reinterpret_cast<T*>(smem);                       // z tile
  T* bs = reinterpret_cast<T*>(smem + kTileRows * L::kMs);  // B ring
  const T* z = static_cast<const T*>(a.z);
  const T* bh = static_cast<const T*>(a.bh);
  const float* scale = static_cast<const float*>(a.scale);
  const float* bias = static_cast<const float*>(a.bias);
  T* e_new = static_cast<T*>(a.e_new);
  T* h = static_cast<T*>(a.h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g0 = static_cast<long long>(blockIdx.x) * G;
  const int gcount = static_cast<int>(groups - g0 < G ? groups - g0 : G);
  const int rows = gcount * D;
  const long long row0 = g0 * D;

  {
    float acc[2][F / 32][4];
    product_rows<T, F>(z, a.ld_z, row0, rows, static_cast<const T*>(a.wt),
                       as, bs, acc);
    store_m2<T, F>(acc, static_cast<const float*>(a.b), ms, rows, g0, D,
                   static_cast<const T*>(a.sg), a.ld_sg,
                   static_cast<const T*>(a.dg), a.ld_dg);
  }
  __syncthreads();

  // h[j,t]: one thread per (t-group, feature), sums over s in f32
  for (int idx = threadIdx.x; idx < gcount * F; idx += kThreads) {
    const int gg = idx / F, n = idx % F;
    const long long g = g0 + gg;
    float num, den;
    gate_sums<T, F>(ms, gg, n, D, bh, a.ld_bh, g / D * D, num, den);
    h[g * F + n] = from_float<T>(num / (den + kEps));
  }

  // e_new = z + silu(LN(m2)): one warp per row, two passes over the row
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = ms + r * L::kMs;
    const long long pr = row0 + r;
    float x[F / 32], zv[F / 32];
#pragma unroll
    for (int i = 0; i < F / 32; ++i)
      zv[i] = to_float(z[pr * a.ld_z + lane + 32 * i]);
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
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const int n = lane + 32 * i;
      const float ln = (x[i] - mean) * rstd * scale[n] + bias[n];
      e_new[pr * F + n] = from_float<T>(zv[i] + ln * sigmoid(ln));
    }
  }
}

struct BwdArgs {
  const void *z, *w, *wt, *b, *sg, *dg, *bh, *scale, *bias, *de, *dh;
  long long ld_z, ld_sg, ld_dg, ld_bh, ld_de, ld_dh;
  void *dz, *dsg, *ddg, *dbh;     // outputs in z's dtype
  void *dm2c;                     // scratch [N*D*D, F] in z's dtype
  float *dw_part, *vec_part;      // scratch [chunks][F][F], [tiles][3][F]
  float *p_dsg, *p_dbh;           // scratch [tiles][P][D][F] each
  float *dw, *vec;                // outputs [F][F], [3][F] (db, dscale, dbias)
};

// 7a: one block per tile of G t-groups (G * D <= 64 pair rows, G <= 16).
// The tile holds t-groups [g0, g0 + gcount), parts of the nodes ja ..
// ja + nodes - 1; P partial slots per tile.  Two blocks per SM.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2)
    fused_bwd_tile_kernel(BwdArgs a, long long groups, int D, int G, int P) {
  using L = Layout<T, F>;
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                              // m2, then dm2, then dm2_c
  T* as = reinterpret_cast<T*>(smem);            // z tile, product 1
  float* aux = smem + kTileRows * L::kMs;
  T* bs = reinterpret_cast<T*>(aux);             // B ring, products 1, 2
  float* s_gi = aux;                             // [G][F] ginv
  float* s_gh = aux + kMaxGroupsBwd * F;         // [G][F] gh
  float* s_vec = aux;                            // [kWarps][3][F]
  const T* z = static_cast<const T*>(a.z);
  const T* bh = static_cast<const T*>(a.bh);
  const T* de = static_cast<const T*>(a.de);
  const T* dh = static_cast<const T*>(a.dh);
  const float* scale = static_cast<const float*>(a.scale);
  const float* bias = static_cast<const float*>(a.bias);
  T* dz = static_cast<T*>(a.dz);
  T* ddg = static_cast<T*>(a.ddg);
  T* dm2c = static_cast<T*>(a.dm2c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tile = blockIdx.x;
  const long long g0 = tile * G;
  const int gcount = static_cast<int>(groups - g0 < G ? groups - g0 : G);
  const int rows = gcount * D;
  const long long row0 = g0 * D;
  const long long ja = g0 / D;
  const int nodes = static_cast<int>((g0 + gcount - 1) / D - ja) + 1;
  const long long part0 = tile * P * D * F;   // this tile's partial slots

  // product 1: eg = z W + b; then m2
  {
    float acc[2][F / 32][4];
    product_rows<T, F>(z, a.ld_z, row0, rows, static_cast<const T*>(a.wt),
                       as, bs, acc);
    store_m2<T, F>(acc, static_cast<const float*>(a.b), ms, rows, g0, D,
                   static_cast<const T*>(a.sg), a.ld_sg,
                   static_cast<const T*>(a.dg), a.ld_dg);
  }
  __syncthreads();

  // per (t, feature): den, h, then ginv = dh / den, gh = -dh h / den
  for (int idx = threadIdx.x; idx < gcount * F; idx += kThreads) {
    const int gg = idx / F, n = idx % F;
    const long long g = g0 + gg;
    const float dhv = to_float(dh[g * a.ld_dh + n]);
    float num, den;
    gate_sums<T, F>(ms, gg, n, D, bh, a.ld_bh, g / D * D, num, den);
    den = den + kEps;
    const float hv = num / den;
    s_gi[idx] = dhv / den;
    s_gh[idx] = -dhv * hv / den;
  }
  __syncthreads();
  // dbh partial: per (node slot, s, feature), sum_t sig ginv over the
  // tile's t-groups of that node, in t order
  for (int idx = threadIdx.x; idx < nodes * D * F; idx += kThreads) {
    const int slot = idx / (D * F), s = idx / F % D, n = idx % F;
    const long long j = ja + slot;
    const int lo = static_cast<int>(j * D - g0 > 0 ? j * D - g0 : 0);
    const int hi = static_cast<int>((j + 1) * D - g0 < gcount
                                        ? (j + 1) * D - g0 : gcount);
    float acc_s = 0.f;
    for (int gg = lo; gg < hi; ++gg)
      acc_s += sigmoid(ms[(gg * D + s) * L::kMs + n]) * s_gi[gg * F + n];
    a.p_dbh[part0 + idx] = acc_s;
  }
  __syncthreads();

  // per row (one warp): dm2 = aggregation + LayerNorm/SiLU backward
  float p_db[F / 32], p_dsc[F / 32], p_dbi[F / 32];   // this warp's rows
#pragma unroll
  for (int i = 0; i < F / 32; ++i) p_db[i] = p_dsc[i] = p_dbi[i] = 0.f;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = ms + r * L::kMs;
    const int gg = r / D, s = r % D;
    const long long pr = row0 + r;
    const long long s_row = (g0 + gg) / D * D + s;   // edge row (j, s)
    float x[F / 32], xh[F / 32], dx[F / 32], dev[F / 32], bhv[F / 32];
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      dev[i] = to_float(de[pr * a.ld_de + lane + 32 * i]);
      bhv[i] = to_float(bh[s_row * a.ld_bh + lane + 32 * i]);
    }
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
      const float dln = dev[i] * (sl * (1.f + ln * (1.f - sl)));
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
          (bhv[i] * s_gi[gg * F + n] +
           s_gh[gg * F + n]);
      const float d = agg + norm;
      row[n] = d;
      p_db[i] += d;
    }
  }
  __syncthreads();

  // ddg[j,t] = sum_s dm2 (whole t-groups, written); dsg partial per (node
  // slot, s) = sum_t dm2 over the tile's t-groups of that node (f32 dm2);
  // the warps' vector partials to shared memory (ginv, gh are done)
  for (int idx = threadIdx.x; idx < gcount * F; idx += kThreads) {
    const int gg = idx / F, n = idx % F;
    float acc_t = 0.f;
    for (int s = 0; s < D; ++s) acc_t += ms[(gg * D + s) * L::kMs + n];
    ddg[(g0 + gg) * F + n] = from_float<T>(acc_t);
  }
  for (int idx = threadIdx.x; idx < nodes * D * F; idx += kThreads) {
    const int slot = idx / (D * F), s = idx / F % D, n = idx % F;
    const long long j = ja + slot;
    const int lo = static_cast<int>(j * D - g0 > 0 ? j * D - g0 : 0);
    const int hi = static_cast<int>((j + 1) * D - g0 < gcount
                                        ? (j + 1) * D - g0 : gcount);
    float acc_s = 0.f;
    for (int gg = lo; gg < hi; ++gg) acc_s += ms[(gg * D + s) * L::kMs + n];
    a.p_dsg[part0 + idx] = acc_s;
  }
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    const int n = lane + 32 * i;
    s_vec[(warp * 3 + 0) * F + n] = p_db[i];
    s_vec[(warp * 3 + 1) * F + n] = p_dsc[i];
    s_vec[(warp * 3 + 2) * F + n] = p_dbi[i];
  }
  __syncthreads();
  // the tile's db, dscale, dbias: the warps' sums, added in warp order;
  // dm2 in z's dtype, in shared memory for product 2 and to the scratch
  // table for dW
  for (int idx = threadIdx.x; idx < 3 * F; idx += kThreads) {
    float v = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) v += s_vec[wi * 3 * F + idx];
    a.vec_part[tile * 3 * F + idx] = v;
  }
  for (int idx = threadIdx.x; idx < rows * F; idx += kThreads) {
    const int r = idx / F, n = idx % F;
    const float v = round_to<T>(ms[r * L::kMs + n]);
    ms[r * L::kMs + n] = v;
    dm2c[(row0 + r) * F + n] = from_float<T>(v);
  }
  __syncthreads();

  // product 2: dz = de + dm2_c W^T (B(k, n) = W[n][k]: W's rows staged)
  float acc[2][F / 32][4];
  zero<F>(acc);
  const T* w = static_cast<const T*>(a.w);
  const int wm = warp / 4, wn = warp % 4;
  pipeline<Tr<T>::kStages>(
      F / kK,
      [&](int s, int stage) {
        stage_rows<T>(bs + stage * F * L::kSt, L::kSt, F, w, F, 0, F,
                      s * kK);
      },
      [&](int s, int stage) {
        mma_slice<T, F>(RowMajor<float, T>{ms + s * kK, L::kMs},
                        RowMajor<T>{bs + stage * F * L::kSt, L::kSt}, acc,
                        wm, wn, lane);
      });
  // dz = de + acc, one m-tile at a time: its de loads first, then stores
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    float dv[F / 32][4];
#pragma unroll
    for (int ni = 0; ni < F / 32; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = wm * 32 + mi * 16 + g + 8 * (c / 2);
        const int n = wn * (F / 4) + ni * 8 + 2 * t + c % 2;
        dv[ni][c] = r < rows ? to_float(de[(row0 + r) * a.ld_de + n]) : 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < F / 32; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = wm * 32 + mi * 16 + g + 8 * (c / 2);
        const int n = wn * (F / 4) + ni * 8 + 2 * t + c % 2;
        if (r < rows)
          dz[(row0 + r) * F + n] = from_float<T>(dv[ni][c] + acc[mi][ni][c]);
      }
  }
}

// 7b: dW partial of rows [c * kDwChunkRows, (c + 1) * kDwChunkRows) and W
// rows [64 mt, 64 mt + 64): block (mt, c).  A(m, k) = z[k][m] and B(k, n) =
// dm2_c[k][n] are staged [k][m] and [k][n] through a ring of three slices.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2)
    fused_bwd_dw_kernel(const T* __restrict__ z, long long ld_z,
                        const T* __restrict__ dm2c, float* __restrict__ part,
                        long long rows) {
  constexpr int kSa = kTileRows + kDwPad;
  constexpr int kSb = F + kDwPad;
  extern __shared__ __align__(16) float smem[];
  T* as = reinterpret_cast<T*>(smem);        // [stages][kK][kSa]
  T* bs = as + kDwStages * kK * kSa;         // [stages][kK][kSb]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * kTileRows;
  const long long begin = blockIdx.y * kDwChunkRows;
  const long long end = begin + kDwChunkRows < rows ? begin + kDwChunkRows
                                                    : rows;
  float acc[2][F / 32][4];
  zero<F>(acc);
  pipeline<kDwStages>(
      static_cast<int>((end - begin + kK - 1) / kK),
      [&](int s, int stage) {
        const long long r0 = begin + static_cast<long long>(s) * kK;
        stage_cols<T>(as + stage * kK * kSa, kSa, kTileRows, z, ld_z, r0, end,
                      m0);
        stage_cols<T>(bs + stage * kK * kSb, kSb, F, dm2c, F, r0, end, 0);
      },
      [&](int, int stage) {
        mma_slice<T, F>(ColMajor<T>{as + stage * kK * kSa, kSa},
                        ColMajor<T>{bs + stage * kK * kSb, kSb}, acc, wm, wn,
                        lane);
      });
  float* out = part + static_cast<long long>(blockIdx.y) * F * F;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < F / 32; ++ni) {
      const int r = m0 + wm * 32 + mi * 16 + g;
      const int n = wn * (F / 4) + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + r * F + n) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * F + n) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
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

// 7d: db, dscale, dbias = the tiles' partials; one warp per output, lanes
// stride the tiles, then a fixed butterfly: the same order on every run.
__global__ void __launch_bounds__(kThreads)
    sum_vec_kernel(const float* __restrict__ part, float* __restrict__ vec,
                   long long tiles, int width) {
  const int out = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (out >= width) return;
  float v = 0.f;
  for (long long j = lane; j < tiles; j += 32) v += part[j * width + out];
  v = warp_sum(v);
  if (lane == 0) vec[out] = v;
}

// 7e: dsg[j,s], dbh[j,s] = the partials of the tiles that hold a part of
// node j (its t-groups j D .. j D + D - 1), added in tile order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_tsum_kernel(const float* __restrict__ p_dsg,
                    const float* __restrict__ p_dbh, T* __restrict__ dsg,
                    T* __restrict__ dbh, long long total, int D, int F,
                    int G, int P) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= total) return;
  const long long node = static_cast<long long>(D) * F;
  const long long j = idx / node, rem = idx % node;
  float v_sg = 0.f, v_bh = 0.f;
  for (long long tl = j * D / G; tl <= (j * D + D - 1) / G; ++tl) {
    const long long slot = j - tl * G / D;
    const long long at = (tl * P + slot) * node + rem;
    v_sg += p_dsg[at];
    v_bh += p_dbh[at];
  }
  dsg[idx] = from_float<T>(v_sg);
  dbh[idx] = from_float<T>(v_bh);
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

// K7's tiling: G t-groups a tile, P partial slots a tile (the most nodes
// G consecutive t-groups can touch), and the scratch it needs.
struct BwdPlan {
  int D, f, G, P;
  long long tiles, chunks;
  BwdPlan(int n, int D_, int f_) : D(D_), f(f_) {
    const int g = kTileRows / D;
    G = g < kMaxGroupsBwd ? g : kMaxGroupsBwd;
    P = (G + D - 1) / D + 1;
    tiles = (static_cast<long long>(n) * D + G - 1) / G;
    chunks = (static_cast<long long>(n) * D * D + kDwChunkRows - 1) /
             kDwChunkRows;
  }
  long long dw_floats() const { return chunks * f * f; }
  long long vec_floats() const { return tiles * 3 * f; }
  long long tsum_floats() const { return tiles * P * D * f; }
  long long scratch_floats() const {
    return dw_floats() + vec_floats() + 2 * tsum_floats();
  }
};

template <typename T, int F>
constexpr size_t dw_smem() {
  return sizeof(T) * kDwStages * kK * (kTileRows + kDwPad + F + kDwPad);
}

template <typename T, int F>
int fwd(const FwdArgs& a, int n, int D, cudaStream_t st) {
  if (D > kTileRows) return kErrTile;   // a t-group must fit the m2 tile
  const int G = kTileRows / D;
  const long long groups = static_cast<long long>(n) * D;
  const unsigned blocks = static_cast<unsigned>((groups + G - 1) / G);
  const size_t smem = Layout<T, F>::kFwdSmem;
  const int err = allow_smem(fused_fwd_kernel<T, F>, smem);
  if (err != 0) return err;
  fused_fwd_kernel<T, F><<<blocks, kThreads, smem, st>>>(a, groups, D, G);
  return cudaGetLastError();
}

template <typename T, int F>
int bwd(BwdArgs a, float* scratch, int n, int D, cudaStream_t st) {
  if (D > kTileRows) return kErrTile;
  const BwdPlan plan(n, D, F);
  a.dw_part = scratch;
  a.vec_part = a.dw_part + plan.dw_floats();
  a.p_dsg = a.vec_part + plan.vec_floats();
  a.p_dbh = a.p_dsg + plan.tsum_floats();
  const long long groups = static_cast<long long>(n) * D;
  const size_t smem = Layout<T, F>::kBwdSmem;
  int err = allow_smem(fused_bwd_tile_kernel<T, F>, smem);
  if (err != 0) return err;
  fused_bwd_tile_kernel<T, F><<<static_cast<unsigned>(plan.tiles), kThreads,
                                smem, st>>>(a, groups, D, plan.G, plan.P);
  err = cudaGetLastError();
  if (err != 0) return err;
  const size_t smem_dw = dw_smem<T, F>();
  err = allow_smem(fused_bwd_dw_kernel<T, F>, smem_dw);
  if (err != 0) return err;
  fused_bwd_dw_kernel<T, F><<<dim3(F / kTileRows,
                                   static_cast<unsigned>(plan.chunks)),
                              kThreads, smem_dw, st>>>(
      static_cast<const T*>(a.z), a.ld_z, static_cast<const T*>(a.dm2c),
      a.dw_part, groups * D);
  err = cudaGetLastError();
  if (err != 0) return err;
  sum_dw_kernel<<<(F * F + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.dw_part, a.dw, static_cast<int>(plan.chunks), F * F);
  err = cudaGetLastError();
  if (err != 0) return err;
  sum_vec_kernel<<<(3 * F + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      a.vec_part, a.vec, plan.tiles, 3 * F);
  err = cudaGetLastError();
  if (err != 0) return err;
  const long long total = groups * F;
  sum_tsum_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) /
                                             kThreads),
                       kThreads, 0, st>>>(
      a.p_dsg, a.p_dbh, static_cast<T*>(a.dsg), static_cast<T*>(a.dbh), total,
      D, F, plan.G, plan.P);
  return cudaGetLastError();
}

template <typename T>
int fwd_f(const FwdArgs& a, int n, int D, int f, cudaStream_t st) {
  if (f == 128) return fwd<T, 128>(a, n, D, st);
  if (f == 256) return fwd<T, 256>(a, n, D, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int bwd_f(const BwdArgs& a, float* scratch, int n, int D, int f,
          cudaStream_t st) {
  if (f == 128) return bwd<T, 128>(a, scratch, n, D, st);
  if (f == 256) return bwd<T, 256>(a, scratch, n, D, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int alignn_fused_lstage_fwd(
    const void* z, long long ld_z, const void* w, const void* wt,
    const void* b, const void* sg, long long ld_sg, const void* dg,
    long long ld_dg, const void* bh, long long ld_bh, const void* scale,
    const void* bias, void* e_new, void* h, int n, int D, int f, int dtype,
    void* stream) {
  if (n == 0 || D == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdArgs a{z,    w,     wt,    b,     sg,    dg,    bh,    scale,
                  bias, ld_z,  ld_sg, ld_dg, ld_bh, e_new, h};
  if (dtype == 0) return fwd_f<float>(a, n, D, f, st);
  if (dtype == 1) return fwd_f<__nv_bfloat16>(a, n, D, f, st);
  if (dtype == 2) return fwd_f<__half>(a, n, D, f, st);
  return cudaErrorInvalidValue;
}

extern "C" int alignn_fused_lstage_bwd(
    const void* z, long long ld_z, const void* w, const void* wt,
    const void* b, const void* sg, long long ld_sg, const void* dg,
    long long ld_dg, const void* bh, long long ld_bh, const void* scale,
    const void* bias, const void* de, long long ld_de, const void* dh,
    long long ld_dh, void* dz, void* dsg, void* ddg, void* dbh, void* dm2c,
    void* scratch, void* dw, void* vec, int n, int D, int f, int dtype,
    void* stream) {
  if (n == 0 || D == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.z = z; a.w = w; a.wt = wt; a.b = b; a.sg = sg; a.dg = dg; a.bh = bh;
  a.scale = scale; a.bias = bias; a.de = de; a.dh = dh;
  a.ld_z = ld_z; a.ld_sg = ld_sg; a.ld_dg = ld_dg; a.ld_bh = ld_bh;
  a.ld_de = ld_de; a.ld_dh = ld_dh;
  a.dz = dz; a.dsg = dsg; a.ddg = ddg; a.dbh = dbh; a.dm2c = dm2c;
  a.dw = static_cast<float*>(dw);
  a.vec = static_cast<float*>(vec);
  float* s = static_cast<float*>(scratch);
  if (dtype == 0) return bwd_f<float>(a, s, n, D, f, st);
  if (dtype == 1) return bwd_f<__nv_bfloat16>(a, s, n, D, f, st);
  if (dtype == 2) return bwd_f<__half>(a, s, n, D, f, st);
  return cudaErrorInvalidValue;
}

// Floats of f32 scratch K7 needs (dW, vector and t-sum partials), or
// kErrTile where D exceeds the tile.
extern "C" long long alignn_fused_lstage_bwd_scratch(int n, int D, int f) {
  if (D > kTileRows) return kErrTile;
  if (n == 0 || D == 0) return 0;
  return BwdPlan(n, D, f).scratch_floats();
}

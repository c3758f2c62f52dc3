// Flash-attention backward for Hopper (sm_90a), float32 math on the tensor
// cores: 3xTF32 wgmma fed by TMA.
//
// The gradient of K1 (csrc/flash_attention_fwd.cu) for float32 inputs at
// head dim 16, 32, 64 or 128 and bfloat16 at 16 or 32 (bfloat16 at 64 or
// 128 goes to flash_attention_bwd_sm90.cu; this kernel takes it too, for
// measurement).  In the JAX package it is mxnet_tpu/ops/flash_attention.py:
// _fa_bwd, plain jnp hung on the Pallas forward by jax.custom_vjp.  It
// computes the same function, every product and sum in float32:
//   P = softmax(scale * Q K^T  [causal: key > query gets 0 weight])
//   D_i = rowsum(dO * O)
//   dV = P^T dO;  dS = P * (dO V^T - D_i);
//   dQ = scale dS K;  dK = scale dS^T Q
// and dq, dk, dv cast to the input type.  The causal mask is top-left
// aligned (query position >= key position).  Like the sm90 backward it
// reads the forward's row log-sum-exp, lse (float32 (B*H, Tq), natural
// log), so P = exp(scale * s - lse) needs no pass to recompute the row
// statistics; the gradient is the same function.
//
// Bound on an H100 SXM at the training shape (B*H = 128, T = 1024, D = 64,
// float32, causal): the five products are 10*D operations per unmasked
// pair, 43 GFLOP, about 0.26 ms at 165 TFLOP/s (495 / 3: three TF32
// products per float32 product); q, k, v, o, dO, dq, dk and dv are 268 MB,
// about 0.080 ms at 3.35 TB/s.  Operations bound it.  This design computes
// S and dP twice (once for dK and dV, once for dQ), 14*D per pair, so its
// own floor is about 0.365 ms: the price of a result that does not depend
// on the order in which blocks run (no atomics).
//
// Design: the sm90 backward's three kernels, launched back to back on the
// caller's stream, with the float32 forward's 3xTF32 arithmetic, split pass
// and TMA ring (flash_attention_fwd.cu):
//  1. stats_kernel: each row's lse * log2 e and D_i into a float32 scratch
//     of two planes (B*H, Tp), Tp = Tq rounded up to 64 (rows past Tq hold
//     zeros, and the 1-D map over them is never smaller than a box).
//  2. dkdv_kernel: one CTA per (b*h, 64-key tile, output half).  K and V
//     stay in shared memory as hi/lo tiles; the CTA walks q-tiles of BS
//     rows (32; 16 at D = 128, for shared memory) from the key tile's
//     diagonal on.  At D = 128 each CTA sums one 64-column half of dK and
//     dV (blockIdx.z), as the sm90 backward does: both halves' running
//     sums and tile sums would not fit in 255 registers.  Each
//     raw ring stage brings a q-tile's Q and dO and its lse and D_i values.
//     With the keys as the wgmma M:
//       S^T = K Q^T and dP^T = V dO^T   (A and B from shared memory)
//       P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - D)
//       dV += P^T dO and dK += dS^T Q   (A: P^T, dS^T split in registers;
//                                        B: dO^T, Q^T from the split pass)
//  3. dq_kernel: one CTA per (b*h, 64-row q-tile).  Q and dO stay as hi/lo
//     tiles; the CTA walks key tiles of BS rows from 0 to the diagonal:
//       S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K (K^T).
// Every product is 3xTF32 (hi*lo + lo*hi + hi*hi, sm90.cuh's split); dK,
// dV and dQ sum each ring tile's products from zero and add them to their
// running sums in registers, rounded to nearest (sm90.cuh says why).  TF32
// wgmma reads K-major operands only, so the split pass of each raw stage
// writes Q and dO (or K) both as they lie and transposed, with the
// transposed tiles' rows in the order frag_tf32 gives the register A.
// The resident pair's raw tiles land in the work tiles (and, for dq at
// D = 128, the ring) before their split; where they reach the ring, the
// producer waits for the split before it fills the ring.
//
// Masking: entries above the causal diagonal, keys past Tk and query rows
// past Tq get P = 0 and dS = 0 exactly, by index.  TMA fills rows past T
// with zeros, but a padded query row has S = 0, so exp(0 - lse) would not
// vanish.  Only tiles that cross an edge pay for the index tests.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BT = 64;            // rows of the wgmma M: keys, or queries
constexpr int CONSUMERS = 128;    // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr int STATS_THREADS = 256;

template <int D>
struct Shape {
  static constexpr int BS = D == 128 ? 16 : 32;     // rows of a ring tile
  static constexpr int STAGES = D == 128 ? 1 : 2;   // raw ring depth
  static constexpr int NO = D < 64 ? D : 64;        // N of one output product
  static constexpr int HALVES = D / NO;
};

// Byte offsets from a 1024-aligned base of dynamic shared memory.  RES_*
// is the resident pair (K, V in dkdv_kernel; Q, dO in dq_kernel), ROW_*
// the ring pair's tiles as they lie, COL_* the transposed ones (both of
// the pair in dkdv_kernel, the first only in dq_kernel).
template <int D, typename T, int NCOL>
struct Layout {
  using S = Shape<D>;
  using Res = KTile<BT, D>;
  using Row = KTile<S::BS, D>;
  using Col = KTile<D, S::BS>;
  static constexpr int RAW = S::BS * D * (int)sizeof(T);  // one ring tile
  static constexpr int RES_RAW = 2 * BT * D * (int)sizeof(T);
  static constexpr int RES = 0;                         // a_hi a_lo b_hi b_lo
  static constexpr int ROW = RES + 4 * Res::BYTES;      // a_hi a_lo b_hi b_lo
  static constexpr int COL = ROW + 4 * Row::BYTES;      // NCOL x (hi, lo)
  static constexpr int RING = COL + 2 * NCOL * Col::BYTES;
  // lse2 then D_i, each plane's box on a 128-byte boundary
  static constexpr int STAT_PLANE = (S::BS * 4 + 127) / 128 * 128;
  static constexpr int STAT_BYTES = 2 * STAT_PLANE;
  static constexpr int STATS = RING + S::STAGES * 2 * RAW;
  static constexpr int FULL = STATS + S::STAGES * STAT_BYTES;
  static constexpr int EMPTY = FULL + 8 * S::STAGES;
  static constexpr int RES_BAR = EMPTY + 8 * S::STAGES;
  static constexpr int RES_FREE = RES_BAR + 8;
  static constexpr int ALLOC = RES_FREE + 8 + 1024;
  // the resident pair's raw tiles land at ROW; past RING they wait for
  // the split before the ring is filled
  static constexpr bool RES_SPILLS = ROW + RES_RAW > RING;
  static_assert(ROW + RES_RAW <= STATS, "resident raw tiles");
  static_assert(RAW % 128 == 0 && STATS % 128 == 0, "TMA destinations");
  static_assert(ALLOC <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t aligned_base(uint8_t* smem_raw) {
  return (smem_u32(smem_raw) + 1023u) & ~1023u;
}

template <int D, typename T, int NCOL>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  using L = Layout<D, T, NCOL>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Shape<D>::STAGES; ++s) {
      bar_init(base + L::FULL + 8 * s, 1);
      bar_init(base + L::EMPTY + 8 * s, CONSUMERS);
    }
    bar_init(base + L::RES_BAR, 1);
    bar_init(base + L::RES_FREE, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer thread: the resident pair (rows res_row .. res_row + 63 of
// res_a and res_b) once, then ring tiles first .. first + n - 1 of ring_a
// and ring_b (BS rows each), each into the stage its consumer frees;
// where `stats` is given, each tile's BS rows of the two planes with it
// (rows from stat_row + BS first on, the second plane `plane` values
// later).
template <int D, typename T, int NCOL>
__device__ __forceinline__ void produce(uint32_t base,
                                        const CUtensorMap* res_a,
                                        const CUtensorMap* res_b, int res_row,
                                        const CUtensorMap* ring_a,
                                        const CUtensorMap* ring_b, int first,
                                        int n, int bh,
                                        const CUtensorMap* stats = nullptr,
                                        int stat_row = 0, int plane = 0) {
  using L = Layout<D, T, NCOL>;
  constexpr int BS = Shape<D>::BS, STAGES = Shape<D>::STAGES;
  const uint32_t res_bar = base + L::RES_BAR;
  bar_expect_tx(res_bar, L::RES_RAW);
  tma_load(base + L::ROW, res_a, res_bar, 0, res_row, bh);
  tma_load(base + L::ROW + L::RES_RAW / 2, res_b, res_bar, 0, res_row, bh);
  if constexpr (L::RES_SPILLS) bar_wait(base + L::RES_FREE, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t full = base + L::FULL + 8 * s;
    if (i >= STAGES)
      bar_wait(base + L::EMPTY + 8 * s, ((i / STAGES) & 1) ^ 1);
    if (stats != nullptr) {
      bar_expect_tx(full, 2 * L::RAW + 2 * BS * 4);
      const uint32_t st = base + L::STATS + s * L::STAT_BYTES;
      const int row = stat_row + (first + i) * BS;
      tma_load_1d(st, stats, full, row);
      tma_load_1d(st + L::STAT_PLANE, stats, full, row + plane);
    } else {
      bar_expect_tx(full, 2 * L::RAW);
    }
    const uint32_t ring = base + L::RING + s * 2 * L::RAW;
    tma_load(ring, ring_a, full, 0, (first + i) * BS, bh);
    tma_load(ring + L::RAW, ring_b, full, 0, (first + i) * BS, bh);
  }
}

// The consumer's split of the resident pair's raw tiles into a_hi, a_lo,
// b_hi, b_lo; then it frees the raw tiles' space.
template <int D, typename T, int NCOL>
__device__ __forceinline__ void split_resident(uint8_t* smem, uint32_t base,
                                               int tid) {
  using L = Layout<D, T, NCOL>;
  bar_wait(base + L::RES_BAR, 0);
  const T* raw = reinterpret_cast<const T*>(smem + L::ROW);
  uint8_t* res = smem + L::RES;
  split_rows<BT, D>(raw, res, res + L::Res::BYTES, tid);
  split_rows<BT, D>(raw + BT * D, res + 2 * L::Res::BYTES,
                    res + 3 * L::Res::BYTES, tid);
  bar_arrive(base + L::RES_FREE);
  wg_sync();  // the raw tiles are read before the work tiles are written
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d = A B over the head dim, 3xTF32: A the resident pair's hi/lo tiles at
// a (KTile<64, D>), B a ring tile's at b (KTile<BS, D>).
template <int D, int N>
__device__ __forceinline__ void product_d(float (&d)[N], uint32_t a,
                                          uint32_t b) {
  using A = KTile<BT, D>;
  using B = KTile<Shape<D>::BS, D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ah = A::desc(a, kk), al = A::desc(a + A::BYTES, kk);
    const uint64_t bh = B::desc(b, kk), bl = B::desc(b + B::BYTES, kk);
    wgmma_tf32(d, ah, bl, kk > 0);
    wgmma_tf32(d, al, bh, 1);
    wgmma_tf32(d, ah, bh, 1);
  }
}

// d = A B over the ring tile's BS rows, 3xTF32, from zero: A the split
// accumulator fragments (hi, lo per k8 step), B rows NO h .. NO h + NO - 1
// of the transposed hi/lo tiles at b (KTile<D, BS>).  The caller adds d to
// its running sum in registers (round to nearest; sm90.cuh says why).
template <int D>
__device__ __forceinline__ void product_t(
    float (&d)[Shape<D>::NO / 2], const uint32_t (&ah)[Shape<D>::BS / 8][4],
    const uint32_t (&al)[Shape<D>::BS / 8][4], uint32_t b, int h) {
  using S = Shape<D>;
  using B = KTile<D, S::BS>;
#pragma unroll
  for (int j = 0; j < S::BS / 8; ++j) {
    const uint64_t bh = B::desc(b, j, S::NO * h);
    const uint64_t bl = B::desc(b + B::BYTES, j, S::NO * h);
    wgmma_tf32(d, ah[j], bl, j > 0);
    wgmma_tf32(d, al[j], bh, 1);
    wgmma_tf32(d, ah[j], bh, 1);
  }
}

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N], const float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += d[i];
}

// Writes this thread's two rows (row0 and row0 + 8, where below `rows`) of
// columns NO h .. NO h + NO - 1 of a 64 x D f32 accumulator, times mul,
// into a (rows, D) matrix of T.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&d)[Shape<D>::NO / 2],
                                           float mul, int row0, int rows,
                                           int h) {
  using S = Shape<D>;
  const int c0 = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < S::NO / 8; ++j)
      store2(out + (size_t)row * D + S::NO * h + 8 * j + c0,
             d[4 * j + 2 * r] * mul, d[4 * j + 2 * r + 1] * mul);
  }
}

// Row r of the planes is query r % tp of head r / tp.
template <int D, typename T>
__global__ void __launch_bounds__(STATS_THREADS)
stats_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ stats, int tq,
             int tp, int rows) {
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  constexpr int TPR = D / VEC;         // threads per row
  const long t = (long)blockIdx.x * STATS_THREADS + threadIdx.x;
  const long row = t / TPR;
  const long q = row % tp;
  const long src = row / tp * tq + q;  // the row in (bh, tq)
  float acc = 0.f;
  if (row < rows && q < tq) {
    const size_t off = (size_t)src * D + (t % TPR) * VEC;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const T* pa = reinterpret_cast<const T*>(&a);
    const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(to_f32(pa[i]), to_f32(pb[i]), acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && t % TPR == 0) {
    stats[row] = q < tq ? lse[src] * LOG2E : 0.f;
    stats[rows + row] = acc;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_stats,
            T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
            float scale, int causal) {
  using S = Shape<D>;
  using L = Layout<D, T, 2>;
  constexpr int BS = S::BS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;  // key tile 0 sees the most q-tiles
  const int hz = blockIdx.z;       // output columns NO hz .. NO hz + NO - 1
  const int q_first = causal ? k0 / BS : 0;
  const int n_tiles = max((tq + BS - 1) / BS - q_first, 0);
  const int tp = (tq + BT - 1) / BT * BT;  // rows of a statistics plane
  const int warp = threadIdx.x / 32;

  init_barriers<D, T, 2>(base);
  if (warp == CONSUMERS / 32) {  // the producer warp
    if (threadIdx.x % 32 == 0)
      produce<D, T, 2>(base, &tm_k, &tm_v, k0, &tm_q, &tm_do, q_first,
                       n_tiles, bh, &tm_stats, bh * tp, gridDim.x * tp);
    return;
  }

  // This thread's keys (S^T rows) are k0 + r0 and k0 + r0 + 8; of each
  // 8-column chunk j it holds queries 8 j + c0 and 8 j + c0 + 1: element e
  // is key row r0 + 8 ((e >> 1) & 1), query column 8 (e / 4) + c0 + (e & 1).
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const float scale2 = scale * LOG2E;
  float dk_acc[S::NO / 2], dv_acc[S::NO / 2];
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t k_t = base + L::RES, v_t = k_t + 2 * L::Res::BYTES;
  const uint32_t q_t = base + L::ROW, do_t = q_t + 2 * L::Row::BYTES;
  const uint32_t qt_t = base + L::COL, dot_t = qt_t + 2 * L::Col::BYTES;

  split_resident<D, T, 2>(smem, base, tid);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S::STAGES;
    const int q0 = (q_first + i) * BS;
    bar_wait(base + L::FULL + 8 * s, (i / S::STAGES) & 1);
    const T* raw = reinterpret_cast<const T*>(smem + L::RING + s * 2 * L::RAW);
    split_rows<BS, D>(raw, smem + L::ROW, smem + L::ROW + L::Row::BYTES, tid);
    split_rows<BS, D>(raw + BS * D, smem + L::ROW + 2 * L::Row::BYTES,
                      smem + L::ROW + 3 * L::Row::BYTES, tid);
    split_cols<BS, D>(raw, smem + L::COL, smem + L::COL + L::Col::BYTES, tid);
    split_cols<BS, D>(raw + BS * D, smem + L::COL + 2 * L::Col::BYTES,
                      smem + L::COL + 3 * L::Col::BYTES, tid);
    // this thread's queries' lse * log2 e and D_i, before the stage is freed
    const float* st =
        reinterpret_cast<const float*>(smem + L::STATS + s * L::STAT_BYTES);
    float lse2[BS / 4], dlt[BS / 4];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        lse2[2 * j + x] = st[8 * j + c0 + x];
        dlt[2 * j + x] = st[L::STAT_PLANE / 4 + 8 * j + c0 + x];
      }
    bar_arrive(base + L::EMPTY + 8 * s);
    fence_async_smem();
    wg_sync();

    float st_acc[BS / 2], dpt[BS / 2];
    zero(st_acc);
    zero(dpt);
    wg_fence();
    product_d<D>(st_acc, k_t, q_t);
    product_d<D>(dpt, v_t, do_t);
    wg_commit();
    wg_wait_all();
    pin(st_acc);
    pin(dpt);

    const bool edge = (causal && k0 + BT - 1 > q0) || q0 + BS > tq ||
                      k0 + BT > tk;
#pragma unroll
    for (int e = 0; e < BS / 2; ++e) {
      const int c = 2 * (e / 4) + (e & 1);  // this thread's query index
      float p = exp2f(fmaf(st_acc[e], scale2, -lse2[c]));
      if (edge) {
        const int key = k0 + r0 + 8 * ((e >> 1) & 1);
        const int q = q0 + 8 * (e / 4) + c0 + (e & 1);
        if (q >= tq || key >= tk || (causal && key > q)) p = 0.f;
      }
      st_acc[e] = p;
      dpt[e] = p * (dpt[e] - dlt[c]);
    }
    uint32_t ph[BS / 8][4], pl[BS / 8][4], dh[BS / 8][4], dl[BS / 8][4];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      frag_tf32(st_acc, j, ph[j], pl[j]);
      frag_tf32(dpt, j, dh[j], dl[j]);
    }

    float dvt[S::NO / 2], dkt[S::NO / 2];
    zero(dvt);
    zero(dkt);
    wg_fence();
    product_t<D>(dvt, ph, pl, dot_t, hz);
    product_t<D>(dkt, dh, dl, qt_t, hz);
    wg_commit();
    wg_wait_all();
    pin(dvt);
    pin(dkt);
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      pin(ph[j]);
      pin(pl[j]);
      pin(dh[j]);
      pin(dl[j]);
    }
    wg_sync();  // every warp is done with the work tiles
    add_to(dv_acc, dvt);
    add_to(dk_acc, dkt);
  }

  const size_t off = (size_t)bh * tk * D;
  store_rows<D>(dk + off, dk_acc, scale, k0 + r0, tk, hz);
  store_rows<D>(dv + off, dv_acc, 1.f, k0 + r0, tk, hz);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ stats, T* __restrict__ dq, int tq,
          int tk, float scale, int causal) {
  using S = Shape<D>;
  using L = Layout<D, T, 1>;
  constexpr int BS = S::BS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const int bh = blockIdx.x;
  // the heaviest causal q-tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int q_last = min(q0 + BT, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int n_tiles = (k_end + BS - 1) / BS;
  const int warp = threadIdx.x / 32;

  init_barriers<D, T, 1>(base);
  if (warp == CONSUMERS / 32) {  // the producer warp
    if (threadIdx.x % 32 == 0)
      produce<D, T, 1>(base, &tm_q, &tm_do, q0, &tm_k, &tm_v, 0, n_tiles,
                       bh);
    return;
  }

  // This thread's rows are q0 + r0 and q0 + r0 + 8; element e of S is row
  // r0 + 8 ((e >> 1) & 1), key column 8 (e / 4) + c0 + (e & 1).
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const float scale2 = scale * LOG2E;
  // this thread's rows of the two statistics planes (zeros past tq)
  const size_t plane = (size_t)gridDim.x * gridDim.y * BT;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)bh * gridDim.y * BT + q0 + r0 + 8 * r;
    lse2[r] = stats[row];
    dlt[r] = stats[plane + row];
  }
  float acc[S::HALVES][S::NO / 2];
#pragma unroll
  for (int h = 0; h < S::HALVES; ++h) zero(acc[h]);
  const uint32_t q_t = base + L::RES, do_t = q_t + 2 * L::Res::BYTES;
  const uint32_t k_t = base + L::ROW, v_t = k_t + 2 * L::Row::BYTES;
  const uint32_t kt_t = base + L::COL;

  split_resident<D, T, 1>(smem, base, tid);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S::STAGES;
    const int k0 = i * BS;
    bar_wait(base + L::FULL + 8 * s, (i / S::STAGES) & 1);
    const T* raw = reinterpret_cast<const T*>(smem + L::RING + s * 2 * L::RAW);
    split_rows<BS, D>(raw, smem + L::ROW, smem + L::ROW + L::Row::BYTES, tid);
    split_rows<BS, D>(raw + BS * D, smem + L::ROW + 2 * L::Row::BYTES,
                      smem + L::ROW + 3 * L::Row::BYTES, tid);
    split_cols<BS, D>(raw, smem + L::COL, smem + L::COL + L::Col::BYTES, tid);
    bar_arrive(base + L::EMPTY + 8 * s);
    fence_async_smem();
    wg_sync();

    float sc[BS / 2], dp[BS / 2];
    zero(sc);
    zero(dp);
    wg_fence();
    product_d<D>(sc, q_t, k_t);
    product_d<D>(dp, do_t, v_t);
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);

    const bool edge = (causal && k0 + BS - 1 > q0) || q0 + BT > tq ||
                      k0 + BS > tk;
#pragma unroll
    for (int e = 0; e < BS / 2; ++e) {
      const int r = (e >> 1) & 1;
      float p = exp2f(fmaf(sc[e], scale2, -lse2[r]));
      if (edge) {
        const int row = q0 + r0 + 8 * r;
        const int key = k0 + 8 * (e / 4) + c0 + (e & 1);
        if (row >= tq || key >= tk || (causal && key > row)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dlt[r]);
    }
    uint32_t dh[BS / 8][4], dl[BS / 8][4];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) frag_tf32(dp, j, dh[j], dl[j]);

    float dqt[S::HALVES][S::NO / 2];
#pragma unroll
    for (int h = 0; h < S::HALVES; ++h) zero(dqt[h]);
    wg_fence();
#pragma unroll
    for (int h = 0; h < S::HALVES; ++h) product_t<D>(dqt[h], dh, dl, kt_t, h);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < S::HALVES; ++h) pin(dqt[h]);
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      pin(dh[j]);
      pin(dl[j]);
    }
    wg_sync();  // every warp is done with the work tiles
#pragma unroll
    for (int h = 0; h < S::HALVES; ++h) add_to(acc[h], dqt[h]);
  }

#pragma unroll
  for (int h = 0; h < S::HALVES; ++h)
    store_rows<D>(dq + (size_t)bh * tq * D, acc[h], scale, q0 + r0, tq, h);
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* stats, void* dq,
                   void* dk, void* dv, int bh, int tq, int tk, float scale,
                   int causal, cudaStream_t stream) {
  using S = Shape<D>;
  constexpr bool bf16 = sizeof(T) == 2;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long rows = (long)bh * ((tq + BT - 1) / BT * BT);  // of one plane
  // resident pairs in tiles of 64 rows, ring tiles of BS rows
  CUtensorMap mq, mk, mv, mdo, mq_s, mk_s, mv_s, mdo_s, mstats;
  if (!make_map_rows(encode, &mq, q, bf16, bh, tq, D, BT) ||
      !make_map_rows(encode, &mk, k, bf16, bh, tk, D, BT) ||
      !make_map_rows(encode, &mv, v, bf16, bh, tk, D, BT) ||
      !make_map_rows(encode, &mdo, dout, bf16, bh, tq, D, BT) ||
      !make_map_rows(encode, &mq_s, q, bf16, bh, tq, D, S::BS) ||
      !make_map_rows(encode, &mk_s, k, bf16, bh, tk, D, S::BS) ||
      !make_map_rows(encode, &mv_s, v, bf16, bh, tk, D, S::BS) ||
      !make_map_rows(encode, &mdo_s, dout, bf16, bh, tq, D, S::BS) ||
      !make_map_f32(encode, &mstats, stats, 2 * rows, S::BS))
    return cudaErrorInvalidValue;
  using LKV = Layout<D, T, 2>;
  using LQ = Layout<D, T, 1>;
  static std::atomic<unsigned long long> smem_dkdv{0}, smem_dq{0};
  cudaError_t err =
      mxt_max_dynamic_smem_once(dkdv_kernel<D, T>, LKV::ALLOC, smem_dkdv);
  if (err == cudaSuccess)
    err = mxt_max_dynamic_smem_once(dq_kernel<D, T>, LQ::ALLOC, smem_dq);
  if (err != cudaSuccess) return err;

  constexpr int TPR = D / (16 / sizeof(T));
  const long blocks = (rows * TPR + STATS_THREADS - 1) / STATS_THREADS;
  stats_kernel<D, T><<<blocks, STATS_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, stats, tq,
      (tq + BT - 1) / BT * BT, (int)rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<D, T><<<dim3(bh, (tk + BT - 1) / BT, S::HALVES), THREADS,
                      LKV::ALLOC, stream>>>(mq_s, mk, mv, mdo_s, mstats,
                                static_cast<T*>(dk), static_cast<T*>(dv), tq,
                                tk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D, T><<<dim3(bh, (tq + BT - 1) / BT), THREADS, LQ::ALLOC,
                    stream>>>(mq, mk_s, mv_s, mdo, stats,
                              static_cast<T*>(dq), tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* stats, void* dq, void* dk, void* dv, int bh,
                       int tq, int tk, float scale, int causal,
                       cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, dout, lse, stats, dq, dk, dv, bh, tq, tk, scale, causal, s);
    case 32: return launch<32, T>(q, k, v, o, dout, lse, stats, dq, dk, dv, bh, tq, tk, scale, causal, s);
    case 64: return launch<64, T>(q, k, v, o, dout, lse, stats, dq, dk, dv, bh, tq, tk, scale, causal, s);
    case 128: return launch<128, T>(q, k, v, o, dout, lse, stats, dq, dk, dv, bh, tq, tk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments, in the order of mxt_flash_attention_bwd_sm90's: q, o,
// dout and dq (bh, tq, d), k, v, dk and dv (bh, tk, d), contiguous and
// 16-byte aligned; lse, the forward's float32 (bh, tq) row log-sum-exp
// (natural log); stats, a float32 scratch of 2 * bh * (tq rounded up to
// 64) values, 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16; d = 16,
// 32, 64 or 128.  Launches the three kernels on `stream` and returns the
// first launch error as a cudaError_t.
extern "C" int mxt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, void* dq, void* dk,
                                       void* dv, const void* lse, void* stats,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || (tq + BT - 1) / BT > 65535 ||
      (tk + BT - 1) / BT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, o, dout, l, st, dq, dk, dv, bh, tq,
                            tk, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, o, dout, l, st, dq, dk, dv,
                                    bh, tq, tk, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

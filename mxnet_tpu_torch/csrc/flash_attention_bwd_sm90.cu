// Flash-attention backward for Hopper (sm_90a): bfloat16 on the tensor cores.
//
// The gradient of K1 (csrc/flash_attention_fwd_sm90.cu) for bfloat16 inputs
// with head dim 64 or 128; float32, and bfloat16 at D 16 or 32, stay with
// flash_attention_bwd.cu.  In the JAX package the backward is
// mxnet_tpu/ops/flash_attention.py:_fa_bwd, plain jnp hung on the Pallas
// forward by jax.custom_vjp.  It computes the same function:
//   P = softmax(scale * Q K^T  [causal: key > query gets 0 weight])
//   D_i = rowsum(dO * O)
//   dV = P^T dO;  dS = P * (dO V^T - D_i);
//   dQ = scale dS K;  dK = scale dS^T Q
// with bf16 operands, every sum in float32, and dq, dk, dv written as bf16.
// The causal mask is top-left aligned (query position >= key position).
//
// One departure from the JAX residuals (q, k, v, o): the forward also keeps
// each row's log-sum-exp of the scaled scores, lse (float32 (B*H, Tq),
// natural log), written by the sm90 forward's epilogue, so that
// P = exp(scale * s - lse) needs no pass to recompute the row statistics.
// The gradient is the same function.
//
// Bound on an H100 SXM at the training shape (B*H = 128, T = 1024, D = 64,
// causal): the five products are 10*D operations per unmasked (query, key)
// pair, 43 GFLOP, about 0.0435 ms at 989 TFLOP/s; q, k, v, o, dO, dq, dk and
// dv are 134 MB, about 0.040 ms at 3.35 TB/s: operations bound it.  This
// design computes S and dP twice (once for dK and dV, once for dQ), 14*D per
// pair, so its own floor is about 0.061 ms.  That is the price of a result
// that does not depend on the order in which blocks run: no atomics.
//
// Design.  Three kernels, launched back to back on the caller's stream:
//  1. stats_kernel: each row's lse * log2 e and D_i = rowsum(dO * O) into
//     a float32 scratch of two planes (B*H, Tp) that the wrapper
//     allocates, Tp = Tq rounded up to 64: rows past Tq hold zeros, a
//     q-tile's 64 rows never cross into the next head, and the 1-D map
//     over them is never smaller than a box (over the unpadded rows, a
//     tiny input such as Tq = 1 made the load fault).  D / 8 threads per
//     row, 16 bytes each.
//  2. dkdv_kernel: one CTA per (b*h, 64-key tile, output half).  K and V
//     stay in shared memory; the CTA walks the 64-row q-tiles that the
//     causal mask leaves (from the key tile's own diagonal on).  Each
//     ring stage brings a q-tile's Q and dO and, by 1-D TMA loads from the
//     two planes, its 64 lse and D_i values, so the softmax reads them
//     from shared memory: loaded by each thread from device memory (16 of
//     each per q-tile) they held 32 registers and the loads' latency stood
//     in every iteration.  For each q-tile it computes, with the keys as
//     the wgmma M:
//       S^T = K Q^T and dP^T = V dO^T   (SS: A and B K-major)
//       P^T = exp2(S^T * scale log2 e - lse log2 e), dS^T = P^T (dP^T - D)
//       dV += P^T dO and dK += dS^T Q   (RS: P^T and dS^T packed in place
//                                        into bf16 A fragments, B MN-major)
//     At D = 128 each CTA accumulates one 64-column half of dK and dV
//     (blockIdx.z): both halves' 2 x 2 x 32 accumulator registers beside
//     S^T, dP^T and their fragments would leave little room under 255,
//     where a half needs the D = 64 kernel's registers and code.  The
//     price is that the two CTAs of a key tile both compute S^T and dP^T;
//     D = 128 is off the training path.
//  3. dq_kernel: one CTA per (b*h, 64-row q-tile).  Q and dO stay in shared
//     memory; the CTA walks the 64-key tiles from 0 to the diagonal:
//       S = Q K^T and dP = dO V^T (SS), dS in registers, dQ += dS K (RS).
//     Its rows' lse and D_i are read once.
// Each CTA has one consumer warpgroup (warps 0-3) and a producer warp (warp
// 4), one thread of which issues every TMA copy: the resident pair once,
// then a ring of STAGES stages with full and empty mbarriers, as in the
// forward.  Descriptors, swizzle and fragment layouts are the forward's
// (sm90.cuh).  The scores are scaled in float32, as the reference scales
// q.astype(f32).  Rounding P and dS to bf16 for the second products is the
// one rounding the reference (float32 throughout) lacks.
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

constexpr int BT = 64;            // rows of every tile: queries or keys
constexpr int STAGES = 2;         // ring depth
constexpr int CONSUMERS = 128;    // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr int STATS_THREADS = 256;

// Byte offsets from a 1024-aligned base of dynamic shared memory.  The
// resident pair is K, V in dkdv_kernel and Q, dO in dq_kernel; the ring
// holds the other pair.
template <int D>
struct Layout {
  static constexpr int TILE_BYTES = BT * D * 2;
  static constexpr int RES_A = 0;
  static constexpr int RES_B = RES_A + TILE_BYTES;
  static constexpr int RING_A = RES_B + TILE_BYTES;
  static constexpr int RING_B = RING_A + STAGES * TILE_BYTES;
  // dkdv_kernel's ring also carries each q-tile's lse * log2 e and D_i
  // (BT floats each) beside its Q and dO
  static constexpr int STATS = RING_B + STAGES * TILE_BYTES;
  static constexpr int STAT_BYTES = 2 * BT * 4;
  static constexpr int FULL = STATS + STAGES * STAT_BYTES;   // STAGES
  static constexpr int EMPTY = FULL + 8 * STAGES;            // STAGES
  static constexpr int RES_BAR = EMPTY + 8 * STAGES;         // one
  static constexpr int ALLOC = RES_BAR + 8 + 1024;           // + alignment
};

__device__ __forceinline__ uint32_t aligned_base(uint8_t* smem_raw) {
  return (smem_u32(smem_raw) + 1023u) & ~1023u;
}

// Thread 0 sets up the barriers; all threads wait for it.
template <int D>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  using L = Layout<D>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(base + L::FULL + 8 * s, 1);
      bar_init(base + L::EMPTY + 8 * s, CONSUMERS);
    }
    bar_init(base + L::RES_BAR, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer thread: the resident pair (rows res_row .. res_row + 63 of
// res_a and res_b) once, then ring tiles first .. first + n - 1 of ring_a
// and ring_b, each into the stage its consumer frees; where `stats` is
// given, each tile's 64 rows of its two planes with it (rows from
// stat_row + 64 first on, the second plane `plane` values later).
template <int D>
__device__ __forceinline__ void produce(uint32_t base,
                                        const CUtensorMap* res_a,
                                        const CUtensorMap* res_b, int res_row,
                                        const CUtensorMap* ring_a,
                                        const CUtensorMap* ring_b, int first,
                                        int n, int bh,
                                        const CUtensorMap* stats = nullptr,
                                        int stat_row = 0, int plane = 0) {
  using L = Layout<D>;
  const uint32_t res_bar = base + L::RES_BAR;
  bar_expect_tx(res_bar, 2 * L::TILE_BYTES);
  for (int h = 0; h < D / 64; ++h) {
    tma_load(base + L::RES_A + h * BT * ROW, res_a, res_bar, 64 * h, res_row,
             bh);
    tma_load(base + L::RES_B + h * BT * ROW, res_b, res_bar, 64 * h, res_row,
             bh);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t full = base + L::FULL + 8 * s;
    if (i >= STAGES)
      bar_wait(base + L::EMPTY + 8 * s, ((i / STAGES) & 1) ^ 1);
    if (stats != nullptr) {
      bar_expect_tx(full, 2 * L::TILE_BYTES + L::STAT_BYTES);
      const uint32_t st = base + L::STATS + s * L::STAT_BYTES;
      const int row = stat_row + (first + i) * BT;
      tma_load_1d(st, stats, full, row);
      tma_load_1d(st + BT * 4, stats, full, row + plane);
    } else {
      bar_expect_tx(full, 2 * L::TILE_BYTES);
    }
    for (int h = 0; h < D / 64; ++h) {
      tma_load(base + L::RING_A + s * L::TILE_BYTES + h * BT * ROW, ring_a,
               full, 64 * h, (first + i) * BT, bh);
      tma_load(base + L::RING_B + s * L::TILE_BYTES + h * BT * ROW, ring_b,
               full, 64 * h, (first + i) * BT, bh);
    }
  }
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// d = A B over the head dim, A and B both K-major 64-row tiles.
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(d, desc_kmajor(a, BT, kk), desc_kmajor(b, BT, kk), kk > 0);
}

// d += A B over the tile's 64 rows, A in registers, B 64-column box h of an
// MN-major 64-row tile.
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b, int h) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[kk], desc_mnmajor(b, BT, h, kk));
}

// Writes this thread's two rows (row0 and row0 + 8, where below `rows`) of
// a 64 x 64 f32 accumulator, times mul, into columns col0 .. col0 + 63 of a
// (rows, D) bf16 matrix.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&d)[32], float mul,
                                           int row0, int rows, int col0) {
  const int c0 = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + col0 + 8 * j +
                                         c0) =
          __floats2bfloat162_rn(d[4 * j + 2 * r] * mul,
                                d[4 * j + 2 * r + 1] * mul);
  }
}

// Row r of the planes is query r % tp of head r / tp.
template <int D>
__global__ void __launch_bounds__(STATS_THREADS)
stats_kernel(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ stats,
             int tq, int tp, int rows) {
  constexpr int TPR = D / 8;  // threads per row, 8 bf16 (16 bytes) each
  const long t = (long)blockIdx.x * STATS_THREADS + threadIdx.x;
  const long row = t / TPR;
  const long q = row % tp;
  const long src = row / tp * tq + q;  // the row in (bh, tq)
  float acc = 0.f;
  if (row < rows && q < tq) {
    const size_t off = (size_t)src * D + (t % TPR) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(pa[i]);
      const float2 fb = __bfloat1622float2(pb[i]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && t % TPR == 0) {
    stats[row] = q < tq ? lse[src] * LOG2E : 0.f;
    stats[rows + row] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_stats,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int tq, int tk, float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;  // key tile 0 sees the most q-tiles
  const int hz = blockIdx.z;       // output columns 64 hz .. 64 hz + 63
  const int q_first = causal ? k0 / BT : 0;
  const int n_tiles = max((tq + BT - 1) / BT - q_first, 0);
  const int tp = (tq + BT - 1) / BT * BT;  // rows of a statistics plane
  const int warp = threadIdx.x / 32;

  init_barriers<D>(base);
  if (warp == CONSUMERS / 32) {  // the producer warp
    if (threadIdx.x % 32 == 0)
      produce<D>(base, &tm_k, &tm_v, k0, &tm_q, &tm_do, q_first, n_tiles, bh,
                 &tm_stats, bh * tp, gridDim.x * tp);
    return;
  }

  // This thread's keys (S^T rows) are k0 + r0 and k0 + r0 + 8; of each
  // 8-column chunk j it holds queries 8 j + c0 and 8 j + c0 + 1: element e
  // is key row r0 + 8 ((e >> 1) & 1), query column 8 (e / 4) + c0 + (e & 1),
  // whose lse and D_i the stage holds at that index.
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  const float scale2 = scale * LOG2E;
  const uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  float dk_acc[32], dv_acc[32];
  zero(dk_acc);
  zero(dv_acc);

  bar_wait(base + L::RES_BAR, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int q0 = (q_first + i) * BT;
    bar_wait(base + L::FULL + 8 * s, (i / STAGES) & 1);
    const uint32_t qt = base + L::RING_A + s * L::TILE_BYTES;
    const uint32_t dot = base + L::RING_B + s * L::TILE_BYTES;
    const float* lse_t = reinterpret_cast<const float*>(
        smem + L::STATS + s * L::STAT_BYTES);
    const float* delta_t = lse_t + BT;

    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    wg_fence();
    product_ss<D>(st, base + L::RES_A, qt);
    product_ss<D>(dpt, base + L::RES_B, dot);
    wg_commit();
    wg_wait_all();
    pin(st);
    pin(dpt);

    const bool edge = (causal && k0 + BT - 1 > q0) || q0 + BT > tq ||
                      k0 + BT > tk;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 8 * (e / 4) + c0 + (e & 1);
      float p = exp2f(fmaf(st[e], scale2, -lse_t[c]));
      if (edge) {
        const int key = k0 + r0 + 8 * ((e >> 1) & 1);
        const int q = q0 + 8 * (e / 4) + c0 + (e & 1);
        if (q >= tq || key >= tk || (causal && key > q)) p = 0.f;
      }
      st[e] = p;
      dpt[e] = p * (dpt[e] - delta_t[c]);
    }
    uint32_t pa[4][4], dsa[4][4];
    pack_a(st, pa);
    pack_a(dpt, dsa);

    wg_fence();
    product_rs(dv_acc, pa, dot, hz);
    product_rs(dk_acc, dsa, qt, hz);
    wg_commit();
    wg_wait_all();
    pin(dv_acc);
    pin(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
      pin(dsa[kk]);
    }
    bar_arrive(base + L::EMPTY + 8 * s);
  }

  const size_t off = (size_t)bh * tk * D;
  store_rows<D>(dk + off, dk_acc, scale, k0 + r0, tk, 64 * hz);
  store_rows<D>(dv + off, dv_acc, 1.f, k0 + r0, tk, 64 * hz);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
          int tq, int tk, float scale, int causal) {
  using L = Layout<D>;
  constexpr int HALVES = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const int bh = blockIdx.x;
  // the heaviest causal q-tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int q_last = min(q0 + BT, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int n_tiles = (k_end + BT - 1) / BT;
  const int warp = threadIdx.x / 32;

  init_barriers<D>(base);
  if (warp == CONSUMERS / 32) {  // the producer warp
    if (threadIdx.x % 32 == 0)
      produce<D>(base, &tm_q, &tm_do, q0, &tm_k, &tm_v, 0, n_tiles, bh);
    return;
  }

  // This thread's rows are q0 + r0 and q0 + r0 + 8; element e of S is row
  // r0 + 8 ((e >> 1) & 1), key column 8 (e / 4) + c0 + (e & 1).
  const int lane = threadIdx.x % 32;
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
  float acc[HALVES][32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) zero(acc[h]);

  bar_wait(base + L::RES_BAR, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BT;
    bar_wait(base + L::FULL + 8 * s, (i / STAGES) & 1);
    const uint32_t kt = base + L::RING_A + s * L::TILE_BYTES;
    const uint32_t vt = base + L::RING_B + s * L::TILE_BYTES;

    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    wg_fence();
    product_ss<D>(sc, base + L::RES_A, kt);
    product_ss<D>(dp, base + L::RES_B, vt);
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);

    const bool edge = (causal && k0 + BT - 1 > q0) || q0 + BT > tq ||
                      k0 + BT > tk;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float p = exp2f(fmaf(sc[e], scale2, -lse2[r]));
      if (edge) {
        const int row = q0 + r0 + 8 * r;
        const int key = k0 + 8 * (e / 4) + c0 + (e & 1);
        if (row >= tq || key >= tk || (causal && key > row)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dlt[r]);
    }
    uint32_t dsa[4][4];
    pack_a(dp, dsa);

    wg_fence();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) product_rs(acc[h], dsa, kt, h);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) pin(acc[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(dsa[kk]);
    bar_arrive(base + L::EMPTY + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < HALVES; ++h)
    store_rows<D>(dq + (size_t)bh * tq * D, acc[h], scale, q0 + r0, tq,
                  64 * h);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* stats, void* dq,
                   void* dk, void* dv, int bh, int tq, int tk, float scale,
                   int causal, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long rows = (long)bh * ((tq + BT - 1) / BT * BT);  // of one plane
  CUtensorMap mq, mk, mv, mdo, mstats;
  if (!make_map(encode, &mq, q, bh, tq, D, BT) ||
      !make_map(encode, &mk, k, bh, tk, D, BT) ||
      !make_map(encode, &mv, v, bh, tk, D, BT) ||
      !make_map(encode, &mdo, dout, bh, tq, D, BT) ||
      !make_map_f32(encode, &mstats, stats, 2 * rows, BT))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_dkdv{0}, smem_dq{0};
  cudaError_t err = mxt_max_dynamic_smem_once(dkdv_kernel<D>,
                                              Layout<D>::ALLOC, smem_dkdv);
  if (err == cudaSuccess)
    err = mxt_max_dynamic_smem_once(dq_kernel<D>, Layout<D>::ALLOC, smem_dq);
  if (err != cudaSuccess) return err;

  const long blocks = (rows * (D / 8) + STATS_THREADS - 1) / STATS_THREADS;
  stats_kernel<D><<<blocks, STATS_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats, tq,
      (tq + BT - 1) / BT * BT, (int)rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(bh, (tk + BT - 1) / BT, D / 64), THREADS,
                   Layout<D>::ALLOC, stream>>>(
      mq, mk, mv, mdo, mstats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3(bh, (tq + BT - 1) / BT), THREADS, Layout<D>::ALLOC,
                 stream>>>(mq, mk, mv, mdo, stats,
                           static_cast<__nv_bfloat16*>(dq), tq, tk, scale,
                           causal);
  return cudaGetLastError();
}

}  // namespace

// The arguments of mxt_flash_attention_bwd_sm90, in the order of
// mxt_flash_attention_bwd's: q, o, dout and dq (bh, tq, d), k, v, dk and dv
// (bh, tk, d), all bf16, contiguous and 16-byte aligned; lse, the forward's
// float32 (bh, tq) row log-sum-exp (natural log); stats, a float32 scratch
// of 2 * bh * (tq rounded up to 64) values, 16-byte aligned.  Takes dtype 1
// (bfloat16) with d = 64 or 128 only.  Returns the cudaError_t.
extern "C" int mxt_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* stats, int bh, int tq, int tk, int d, float scale, int causal,
    int dtype, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || dtype != 1 ||
      (tq + BT - 1) / BT > 65535 || (tk + BT - 1) / BT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  cudaError_t err;
  switch (d) {
    case 64:
      err = launch<64>(q, k, v, o, dout, l, st, dq, dk, dv, bh, tq, tk, scale,
                       causal, s);
      break;
    case 128:
      err = launch<128>(q, k, v, o, dout, l, st, dq, dk, dv, bh, tq, tk,
                        scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

// Flash-attention forward for Hopper (sm_90a), float32 math on the tensor
// cores: 3xTF32 wgmma fed by TMA.
//
// Replaces mxnet_tpu/ops/flash_attention.py:_flash_attention, the Pallas TPU
// kernel _fa_kernel, for float32 inputs at head dim 16, 32, 64 or 128 and
// bfloat16 at 16 or 32 (bfloat16 at 64 or 128 goes to
// flash_attention_fwd_sm90.cu; this kernel takes it too, for measurement).
// It computes the same function:
//   O = softmax(scale * Q K^T  [causal: -1e30 where k > q]) V
// with an online softmax whose running max m, running sum l and accumulator
// acc stay in float32, and o = acc / max(l, 1e-30) cast to the input type.
//
// Bound on an H100 SXM at B*H = 64, T = 1024, D = 64, float32, causal: the
// two products are 4*D operations per unmasked pair, 4.3 GFLOP; a float32
// product to float32 accuracy on the tensor cores is three TF32 products,
// so 495 / 3 = 165 TFLOP/s, about 0.026 ms; q, k, v and o are 67 MB, about
// 0.020 ms at 3.35 TB/s.  Operations bound it, just; float32 FMAs on the
// CUDA cores would cap it at 67 TFLOP/s.
//
// Design:
//  * 3xTF32: each operand x is split once into hi = tf32(x) and lo =
//    tf32(x - hi) (sm90.cuh: tf32_split, truncation), and each product is
//    hi*lo + lo*hi + hi*hi into the same f32 registers.  Plain TF32 (hi*hi)
//    keeps about 3 decimal digits and would miss the reference's 1e-4 pin.
//  * One CTA owns one (b*h, q-tile of BM = 64 rows): one consumer
//    warpgroup (warps 0-3) and a producer warp (warp 4), one thread of
//    which issues every TMA copy.  K/V tiles hold BN = 32 keys, so that at
//    D <= 64 a CTA takes 97 KB of shared memory and two CTAs share an SM:
//    one's split pass and softmax overlap the other's wgmmas.  That was
//    15 % faster on the H100 than 64-key tiles with one CTA per SM
//    (PERF.md).
//  * TMA lands each tile as it lies in memory (unswizzled rows of the
//    input type, zero past T within its head): Q once, K and V into a ring
//    of STAGES raw stages with full and empty mbarriers.  The consumer's
//    split pass turns a raw stage into the f32 hi and lo tiles wgmma reads
//    (128-byte swizzled, K-major) and frees the stage at once, so the next
//    tiles' copies overlap this tile's products.  TF32 wgmma takes K-major
//    operands only (32-bit types have no transpose bit): Q and K are read
//    along D as they lie; V is transposed by the split pass (split_cols).
//  * S = Q K^T from shared memory (A and B); P stays in registers: the f32
//    accumulator is split into hi/lo A fragments (frag_tf32), whose column
//    order differs from the accumulator's, so split_cols orders V's keys to
//    match.  P V with A from registers, each k-tile's from zero, added to
//    O's accumulator by FMAs (round to nearest; sm90.cuh says why).
//  * Generic-proxy writes (the split pass) reach the wgmmas through
//    fence.proxy.async and a warpgroup barrier; a second barrier after the
//    products keeps the next split off tiles still being read.
//  * Causal k-tiles wholly above the diagonal are skipped (their weight in
//    the reference is exactly 0); keys past a ragged end get -inf.
//  * Where the caller passes `lse`, the epilogue writes each row's
//    log-sum-exp m + log l (natural log) for the backward; O is the same
//    either way.
//  * Shared memory at D = 64: Q hi/lo 32 KB, K hi/lo and V^T hi/lo 32 KB,
//    two raw stages of K and V 32 KB; Q's raw tile lands in the K/V work
//    tiles before the first split.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;            // query rows per CTA
constexpr int STAGES = 2;         // raw K/V ring depth
constexpr int CONSUMERS = 128;    // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;

// Byte offsets from a 1024-aligned base of dynamic shared memory.
template <int D, typename T>
struct Layout {
  static constexpr int BN = 32;  // keys per k-tile
  using QTile = KTile<BM, D>;   // Q: A of S, contracted over D
  using KT = KTile<BN, D>;      // K: B of S
  using VT = KTile<D, BN>;      // V^T: B of P V, contracted over keys
  static constexpr int RAW = BN * D * (int)sizeof(T);  // one raw K or V tile
  static constexpr int Q_RAW = BM * D * (int)sizeof(T);
  static constexpr int Q_HI = 0;
  static constexpr int Q_LO = Q_HI + QTile::BYTES;
  static constexpr int K_HI = Q_LO + QTile::BYTES;
  static constexpr int K_LO = K_HI + KT::BYTES;
  static constexpr int V_HI = K_LO + KT::BYTES;
  static constexpr int V_LO = V_HI + VT::BYTES;
  static constexpr int RING = V_LO + VT::BYTES;           // STAGES x (K, V)
  static constexpr int FULL = RING + STAGES * 2 * RAW;    // STAGES mbarriers
  static constexpr int EMPTY = FULL + 8 * STAGES;         // STAGES mbarriers
  static constexpr int QBAR = EMPTY + 8 * STAGES;         // one mbarrier
  static constexpr int ALLOC = QBAR + 8 + 1024;           // + room to align
  static_assert(Q_RAW <= RING - K_HI, "Q's raw tile lands in the work tiles");
  static_assert(RAW % 128 == 0, "TMA destinations are 128-byte aligned");
  static_assert(ALLOC <= 232448, "shared memory");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           T* __restrict__ o, float* __restrict__ lse,
                           int tq, int tk, float scale, int causal) {
  using L = Layout<D, T>;
  constexpr int BN = L::BN;
  constexpr int NO = D < 64 ? D : 64;   // N of one O product
  constexpr int HALVES = D / NO;        // O products per k8 step
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + L::FULL, empty = base + L::EMPTY;
  const uint32_t qbar = base + L::QBAR;

  const int bh = blockIdx.x;
  // the heaviest causal q-tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int q_last = min(q0 + BM, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int n_tiles = (k_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS);
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      bar_expect_tx(qbar, L::Q_RAW);
      tma_load(base + L::K_HI, &tm_q, qbar, 0, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) bar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        bar_expect_tx(full + 8 * s, 2 * L::RAW);
        const uint32_t ring = base + L::RING + s * 2 * L::RAW;
        tma_load(ring, &tm_k, full + 8 * s, 0, i * BN, bh);
        tma_load(ring + L::RAW, &tm_v, full + 8 * s, 0, i * BN, bh);
      }
    }
    return;
  }

  // The consumer warpgroup: rows q0 .. q0 + 63.  This thread's rows of
  // them are r0 and r0 + 8; of each 8-column chunk j of S or O it holds 4
  // elements: element 4 j + i (i < 4) is row r0 + 8 (i >> 1), column
  // 8 j + c0 + (i & 1).
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  float acc[HALVES][NO / 2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) acc[h][i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  bar_wait(qbar, 0);
  split_rows<BM, D>(reinterpret_cast<const T*>(smem + L::K_HI),
                    smem + L::Q_HI, smem + L::Q_LO, tid);
  wg_sync();  // Q's raw tile is read before the K/V work tiles are written
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BN;
    bar_wait(full + 8 * s, (i / STAGES) & 1);
    const T* raw = reinterpret_cast<const T*>(smem + L::RING + s * 2 * L::RAW);
    split_rows<BN, D>(raw, smem + L::K_HI, smem + L::K_LO, tid);
    split_cols<BN, D>(raw + BN * D, smem + L::V_HI, smem + L::V_LO, tid);
    bar_arrive(empty + 8 * s);
    fence_async_smem();
    wg_sync();

    // S = Q K^T, 3xTF32 over D / 8 k8 steps
    float sc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t qh = L::QTile::desc(base + L::Q_HI, kk);
      const uint64_t ql = L::QTile::desc(base + L::Q_LO, kk);
      const uint64_t kh = L::KT::desc(base + L::K_HI, kk);
      const uint64_t kl = L::KT::desc(base + L::K_LO, kk);
      wgmma_tf32(sc, qh, kl, kk > 0);
      wgmma_tf32(sc, ql, kh, 1);
      wgmma_tf32(sc, qh, kh, 1);
    }
    wg_commit();
    wg_wait_all();
    pin(sc);

    // scale, mask and the row max (over this thread's columns, then over
    // the four lanes that share the row)
    const bool edge = k0 + BN > tk || (causal && k0 + BN - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      float x = sc[e] * scale;
      if (edge) {
        const int key = k0 + 8 * (e / 4) + c0 + (e & 1);
        const int row = q0 + r0 + 8 * ((e >> 1) & 1);
        if (key >= tk) x = -INFINITY;
        else if (causal && key > row) x = NEG_BIG;
      }
      sc[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float corr[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      ml[r] = mx[r] * LOG2E;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const float p = exp2f(fmaf(sc[e], LOG2E, -ml[(e >> 1) & 1]));
      rs[(e >> 1) & 1] += p;
      sc[e] = p;
    }
    // P as hi and lo TF32 A fragments, one pair per k8 step of keys
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) frag_tf32(sc, j, ph[j], pl[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }

    // this tile's P V, 3xTF32 over BN / 8 k8 steps of keys from zero (V^T
    // rows NO h ..); then acc = acc * corr + P V, rounded to nearest
    float pv[HALVES][NO / 2];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int e = 0; e < NO / 2; ++e) pv[h][e] = 0.f;
    wg_fence();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const uint64_t vh = L::VT::desc(base + L::V_HI, j, NO * h);
        const uint64_t vl = L::VT::desc(base + L::V_LO, j, NO * h);
        wgmma_tf32(pv[h], ph[j], vl, j > 0);
        wgmma_tf32(pv[h], pl[j], vh, 1);
        wgmma_tf32(pv[h], ph[j], vh, 1);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) pin(pv[h]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      pin(ph[j]);
      pin(pl[j]);
    }
    wg_sync();  // every warp is done with the work tiles
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int e = 0; e < NO / 2; ++e)
        acc[h][e] = fmaf(acc[h][e], corr[(e >> 1) & 1], pv[h][e]);
  }

  T* ob = o + (size_t)bh * tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // the row's log-sum-exp of the scaled scores, natural log: m is the
    // row max of scale * s (exp2 takes it times LOG2E), l the sum of
    // exp(x - m)
    if (lse != nullptr && c0 == 0)
      lse[(size_t)bh * tq + row] = m[r] + logf(denom);
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j)
        store2(ob + (size_t)row * D + NO * h + 8 * j + c0,
               acc[h][4 * j + 2 * r] / denom,
               acc[h][4 * j + 2 * r + 1] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, float scale,
                   int causal, cudaStream_t stream) {
  using L = Layout<D, T>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr bool bf16 = sizeof(T) == 2;
  CUtensorMap mq, mk, mv;
  if (!make_map_rows(encode, &mq, q, bf16, bh, tq, D, BM) ||
      !make_map_rows(encode, &mk, k, bf16, bh, tk, D, L::BN) ||
      !make_map_rows(encode, &mv, v, bf16, bh, tk, D, L::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_fwd_kernel<D, T>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = mxt_max_dynamic_smem_once(kernel, L::ALLOC, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + BM - 1) / BM);
  kernel<<<grid, THREADS, L::ALLOC, stream>>>(mq, mk, mv, static_cast<T*>(o),
                                              lse, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, float* lse, int bh, int tq, int tk,
                       float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 32: return launch<32, T>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 64: return launch<64, T>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    case 128: return launch<128, T>(q, k, v, o, lse, bh, tq, tk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, tq, d), k and v: (bh, tk, d), o: (bh, tq, d), all contiguous and
// 16-byte aligned; lse, float32 (bh, tq) or null: where given, each row's
// log-sum-exp of the scaled, masked scores (natural log, as
// torch.logsumexp) is written there for the backward.  dtype: 0 = float32,
// 1 = bfloat16; d = 16, 32, 64 or 128.  Returns the launch's cudaError_t.
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || (tq + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, o, l, bh, tq, tk, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, o, l, bh, tq, tk, scale,
                                    causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

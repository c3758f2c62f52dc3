// Flash-attention forward for Hopper (sm_90a): bfloat16 on the tensor cores.
//
// Replaces mxnet_tpu/ops/flash_attention.py:_flash_attention, the Pallas TPU
// kernel _fa_kernel, for bfloat16 inputs with head dim 64 or 128 (float32,
// and bfloat16 at D 16 or 32, stay with flash_attention_fwd.cu).  It computes
// the reference's function:
//   O = softmax(scale * Q K^T  [causal: -1e30 where k > q]) V
// with the online softmax's running max m, sum l and accumulator acc in
// float32 and o = acc / max(l, 1e-30) cast to bf16.  Keys past a ragged end
// get -inf (exactly zero weight); causal k-tiles wholly above the diagonal
// are skipped (their weight in the reference is exactly 0); the heaviest
// causal q-tiles are scheduled first.
//
// Bound on an H100 SXM at the scoring shape (B*H = 64, T = 1024, D = 64,
// causal): 8.6 GFLOP is about 9 us at 989 TFLOP/s and the 33.6 MB of q, k,
// v and o about 10 us at 3.35 TB/s, so bytes bound it; both products must
// run on the tensor cores to get near it.
//
// Design:
//  * One CTA owns one (b*h, q-tile of BM = 64 rows).  One consumer
//    warpgroup (warps 0-3) does the math; warp 4 is the producer, one
//    thread of which issues every copy.  K/V tiles hold BN = 128 keys: 64
//    keys per tile and a second consumer warpgroup were both slower on the
//    H100 (PERF.md).
//  * Copies are TMA loads over 3-D tensor maps (D, T, B*H), so a tile that
//    runs past T is zero-filled within its own head.  Q is loaded once; K
//    and V tiles of BN keys go into a ring of STAGES buffers with full and
//    empty mbarriers, so the next tile's copy overlaps this tile's math.
//    The mbarrier phase of tile i is (i / STAGES) & 1.
//  * Swizzle agreement: every tile is stored with the 128-byte swizzle,
//    written by TMA and read by wgmma through descriptors of the same mode
//    (sm90.cuh, shared with the backward).
//  * S = Q K^T by wgmma m64n64k16 from shared memory, f32 accumulate.  Q
//    (64 x D) and K (BN x D) are both K-major: no transpose.  A k16 step
//    moves the descriptor 32 bytes along the swizzled row.
//  * The scale is applied to S in float32, as the reference scales
//    q.astype(f32); exp(x - m) is exp2f((x - m) * log2 e).
//  * Fragment layout: the f32 accumulator of S (per warp, rows lane/4 and
//    lane/4 + 8, column pairs 2 * (lane % 4) of each 8-column chunk) is the
//    register A-fragment layout of a bf16 m64k16 wgmma, so P is packed in
//    place into bf16 pairs and O += P V runs with A from registers.  V
//    (BN x D, D contiguous) is the MN-major B operand: the transpose bit.
//    Rounding P to bf16 is the one rounding the reference (an f32 p @ v)
//    lacks; l sums the unrounded f32 p.
//  * Ordering: wgmma.fence before each batch (its registers were written),
//    commit_group, wait_group 0, and an empty asm that pins the registers
//    the async product reads or writes until after the wait.  The consumer
//    frees a stage only after the P V product that reads its V is done.
//  * Row statistics: where the caller passes `lse`, the epilogue writes
//    each row's log-sum-exp m + log l (natural log) for the backward
//    (flash_attention_bwd_sm90.cu), from the lanes that hold column 0 of
//    the row; with lse null it writes nothing, and O is the same either way.
//  * The tensor maps are encoded on the host for each call (the pointers
//    change) by cuTensorMapEncodeTiled, looked up at run time with
//    cudaGetDriverEntryPoint, so the library needs no -lcuda; they reach
//    the kernel as __grid_constant__ parameters.
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
constexpr int BN = 128;           // keys per k-tile
constexpr int SB = BN / 64;       // 64-key blocks of S, one wgmma N each
constexpr int STAGES = 2;         // K/V ring depth
constexpr int CONSUMERS = 128;    // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;

// Byte offsets from a 1024-aligned base of dynamic shared memory.
template <int D>
struct Layout {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + STAGES * TILE_BYTES;
  static constexpr int FULL = V + STAGES * TILE_BYTES;  // STAGES mbarriers
  static constexpr int EMPTY = FULL + 8 * STAGES;       // STAGES mbarriers
  static constexpr int QBAR = EMPTY + 8 * STAGES;       // one mbarrier
  static constexpr int ALLOC = QBAR + 8 + 1024;         // + room to align
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int tq, int tk,
                                float scale, int causal) {
  using L = Layout<D>;
  constexpr int HALVES = D / 64;  // 64-column boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q, sk = base + L::K, sv = base + L::V;
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
      bar_expect_tx(qbar, L::Q_BYTES);
      for (int h = 0; h < HALVES; ++h)
        tma_load(sq + h * BM * ROW, &tm_q, qbar, 64 * h, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) bar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        bar_expect_tx(full + 8 * s, 2 * L::TILE_BYTES);
        const uint32_t kt = sk + s * L::TILE_BYTES;
        const uint32_t vt = sv + s * L::TILE_BYTES;
        for (int h = 0; h < HALVES; ++h) {
          tma_load(kt + h * BN * ROW, &tm_k, full + 8 * s, 64 * h, i * BN, bh);
          tma_load(vt + h * BN * ROW, &tm_v, full + 8 * s, 64 * h, i * BN, bh);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: rows q0 .. q0 + 63.  This thread's rows of
  // them are r0 and r0 + 8; of each 8-column chunk j of S or O it holds 4
  // elements: element 4 j + i (i < 4) is row r0 + 8 (i >> 1), column
  // 8 j + c0 + (i & 1).  Tiles wholly above the causal diagonal are past
  // k_end and never loaded.
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  float acc[HALVES][32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  bar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BN;
    bar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t kt = sk + s * L::TILE_BYTES;
    const uint32_t vt = sv + s * L::TILE_BYTES;

    // S = Q K^T: k16 step kk is 32 bytes into the swizzled rows of
    // 64-column box kk / 4; block b of S takes keys 64 b .. 64 b + 63
    float sc[SB][32];
#pragma unroll
    for (int b = 0; b < SB; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[b][e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint64_t da = desc_sw128(sq + (kk / 4) * BM * ROW + col, 16, ATOM);
#pragma unroll
      for (int b = 0; b < SB; ++b)
        wgmma_ss(sc[b], da,
                 desc_sw128(kt + (kk / 4) * BN * ROW + b * 64 * ROW + col, 16,
                            ATOM),
                 kk > 0);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int b = 0; b < SB; ++b) pin(sc[b]);

    // scale, mask and the row max (over this thread's columns, then over
    // the four lanes that share the row)
    const bool edge = k0 + BN > tk || (causal && k0 + BN - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int b = 0; b < SB; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float x = sc[b][e] * scale;
        if (edge) {
          const int key = k0 + 64 * b + 8 * (e / 4) + c0 + (e & 1);
          const int row = q0 + r0 + 8 * ((e >> 1) & 1);
          if (key >= tk) x = -INFINITY;
          else if (causal && key > row) x = NEG_BIG;
        }
        sc[b][e] = x;
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
    for (int b = 0; b < SB; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = exp2f(fmaf(sc[b][e], LOG2E, -ml[(e >> 1) & 1]));
        rs[(e >> 1) & 1] += p;
        sc[b][e] = p;
      }
    // P as bf16 A fragments: k16 step kk takes 8-column chunks 2 kk and
    // 2 kk + 1 of the keys
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sc[kk / 4][8 * (kk % 4) + 2 * x],
                              sc[kk / 4][8 * (kk % 4) + 2 * x + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[h][e] *= corr[(e >> 1) & 1];

    // O += P V: k16 step kk reads keys 16 kk .. 16 kk + 15 of V, two
    // 8-key swizzle atoms apart
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        wgmma_rs(acc[h], pa[kk],
                 desc_sw128(vt + h * BN * ROW + kk * 2 * ATOM, ATOM, ATOM));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) pin(acc[h]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pin(pa[kk]);
    bar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* ob = o + (size_t)bh * tq * D;
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
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[h][4 * j + 2 * r] / denom, acc[h][4 * j + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (size_t)row * D + 64 * h + 8 * j + c0) = v;
      }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, float scale,
                   int causal, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, bh, tq, D, BM) ||
      !make_map(encode, &mk, k, bh, tk, D, BN) ||
      !make_map(encode, &mv, v, bh, tk, D, BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_fwd_sm90_kernel<D>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = mxt_max_dynamic_smem_once(kernel, Layout<D>::ALLOC,
                                              smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + BM - 1) / BM);
  kernel<<<grid, THREADS, Layout<D>::ALLOC, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, tq, tk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// The arguments of mxt_flash_attention_fwd: q (bh, tq, d), k and v
// (bh, tk, d), o (bh, tq, d), contiguous and 16-byte aligned, and lse,
// float32 (bh, tq) or null: where given, each row's log-sum-exp of the
// scaled, masked scores (natural log, as torch.logsumexp) is written there
// for the backward (flash_attention_bwd_sm90.cu).  Takes dtype 1 (bfloat16)
// with d = 64 or 128 only.  Returns the cudaError_t.
extern "C" int mxt_flash_attention_fwd_sm90(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int bh, int tq, int tk, int d,
                                            float scale, int causal,
                                            int dtype, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || dtype != 1 ||
      (tq + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (d) {
    case 64: err = launch<64>(q, k, v, o, l, bh, tq, tk, scale, causal, s); break;
    case 128: err = launch<128>(q, k, v, o, l, bh, tq, tk, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

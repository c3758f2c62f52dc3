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
//    written by TMA (CU_TENSOR_MAP_SWIZZLE_128B) and read by wgmma through
//    descriptors of the same mode.  A row of 64 bf16 is exactly 128 bytes;
//    D = 128 is two 64-column boxes, stored one after the other.  Every
//    tile starts on a 1024-byte boundary (one 8-row swizzle atom).
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

namespace {

constexpr int BM = 64;            // query rows per CTA
constexpr int BN = 128;           // keys per k-tile
constexpr int SB = BN / 64;       // 64-key blocks of S, one wgmma N each
constexpr int STAGES = 2;         // K/V ring depth
constexpr int CONSUMERS = 128;    // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr int ROW = 128;          // bytes in one swizzled row: 64 bf16
constexpr int ATOM = 8 * ROW;     // one 8-row swizzle atom
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int t0,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
         "r"(t0), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from touching registers an async wgmma still owns.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

#define MXT_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])

#define MXT_D32_OPERANDS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      MXT_D32_OPERANDS ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXT_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      MXT_D32_OPERANDS ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MXT_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ o, int tq, int tk,
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous (bh, t, d) bf16 tensor, read in boxes of
// 64 columns x `rows` rows of one head, 128-byte swizzled, zero past t.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh,
              int t, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int tq, int tk, float scale, int causal,
                   cudaStream_t stream) {
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
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), tq, tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The arguments of mxt_flash_attention_fwd: q (bh, tq, d), k and v
// (bh, tk, d), o (bh, tq, d), contiguous and 16-byte aligned.  Takes
// dtype 1 (bfloat16) with d = 64 or 128 only.  Returns the cudaError_t.
extern "C" int mxt_flash_attention_fwd_sm90(const void* q, const void* k,
                                            const void* v, void* o, int bh,
                                            int tq, int tk, int d, float scale,
                                            int causal, int dtype,
                                            void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || dtype != 1 ||
      (tq + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 64: err = launch<64>(q, k, v, o, bh, tq, tk, scale, causal, s); break;
    case 128: err = launch<128>(q, k, v, o, bh, tq, tk, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

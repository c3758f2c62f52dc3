// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA loads over 3-D tensor maps, wgmma descriptors for the
// 128-byte swizzle and the two m64n64k16 bf16 products the bf16 kernels
// issue (flash_attention_fwd_sm90.cu, flash_attention_bwd_sm90.cu); below
// them the TF32 split, tiles and products of the float32 kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Swizzle agreement: every tile is stored with the 128-byte swizzle, written
// by TMA (CU_TENSOR_MAP_SWIZZLE_128B) and read by wgmma through descriptors
// of the same mode.  A row of 64 bf16 is exactly 128 bytes; a head dim of
// 128 is two 64-column boxes stored one after the other.  Every tile starts
// on a 1024-byte boundary (one 8-row swizzle atom).  A tile of R rows x 64
// columns is read two ways:
//  * K-major (the contraction runs along the row, as Q and K in Q K^T):
//    a k16 step is 32 bytes into the swizzled rows; leading byte offset 16
//    (unused), stride byte offset ATOM between 8-row groups.
//  * MN-major (the contraction runs down the rows, as V in P V): a k16
//    step is 16 rows, two atoms; leading byte offset ATOM (the next 64
//    columns, unused at N = 64), stride byte offset ATOM between the two
//    8-row groups of the step.  The product's transpose bit is set.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int ROW = 128;          // bytes in one swizzled row: 64 bf16
constexpr int ATOM = 8 * ROW;     // one 8-row swizzle atom
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

// A 1-D TMA load of one box of a rank-1 map, from element i0.
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int i0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(i0)
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

// k16 step kk of a K-major tile of `rows` rows at `tile`.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int kk) {
  return desc_sw128(tile + (kk / 4) * rows * ROW + (kk % 4) * 32, 16, ATOM);
}

// k16 step kk (rows 16 kk .. 16 kk + 15) of 64-column box h of an MN-major
// tile of `rows` rows at `tile`.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int h, int kk) {
  return desc_sw128(tile + h * rows * ROW + kk * 2 * ATOM, ATOM, ATOM);
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
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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

// The f32 accumulator of a 64 x 64 product (per warp, rows lane/4 and
// lane/4 + 8, column pairs 2 * (lane % 4) of each 8-column chunk) is the
// register A-fragment layout of a bf16 m64k16 wgmma: k16 step kk of the
// next product takes 8-column chunks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// ---------------------------------------------------------------------------
// TF32 (the float32 flash kernels, flash_attention_fwd.cu and
// flash_attention_bwd.cu): every float32 product is three TF32 wgmmas,
// a_hi b_hi + a_hi b_lo + a_lo b_hi, summed in the same f32 accumulator.
//
// The split, here and nowhere else: hi keeps x's sign, exponent and top 10
// mantissa bits (the low 13 bits cleared: truncation), lo = x - hi (exact
// in f32) truncated the same way.  Both are exact TF32 values, so the
// tensor cores see them unchanged and each product of two is exact in f32.
// The omitted lo * lo and the truncation of lo are below 2^-20 of |a b|.
//
// Accumulation: chained over all 384 wgmmas of a T = 1024 row into one
// accumulator, the tensor cores' float32 sums left the forward's O about
// 1e-5 of its largest value off, and 12 layers of it put a net's logits
// 1.1e-4 off the dense net's, on the H100 (PERF.md): more than the
// split's own error, as if each sum rounded toward zero.  So the kernels
// sum one tile's products (at most 24 chained wgmmas) from zero and add
// the tile into a register accumulator with round-to-nearest FMAs, which
// took those two errors to 4e-6 and 1.9e-5.
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_trunc(x);
  lo = tf32_trunc(x - hi);
}

// A K-major float32 tile of R rows (the product's M or N) and KW values of
// the contraction per row, as wgmma reads it: KW = 16 is one 64-byte
// swizzled row (8-row atoms of 512 bytes); KW a multiple of 32 is KW / 32
// boxes of 128-byte swizzled rows stored one after the other (8-row atoms
// of 1024 bytes), as the bf16 tiles above.  A k8 step of TF32 is 32 bytes
// into the row, the depth of a bf16 k16 step.  Tiles start 1024-aligned.
template <int R, int KW>
struct KTile {
  static_assert(R % 8 == 0 && (KW == 16 || KW % 32 == 0), "tile shape");
  static constexpr int SPAN = KW == 16 ? 64 : 128;  // bytes of a swizzled row
  static constexpr int BOX = SPAN / 4;              // values per row of a box
  static constexpr int BYTES = R * KW * 4;
  // Byte offset of the 16-byte chunk that holds (r, k .. k + 3), k % 4 == 0:
  // the chunk index is XORed with the row's phase in its atom.
  static __device__ __forceinline__ int off(int r, int k) {
    const int phase = SPAN == 128 ? (r & 7) : ((r >> 1) & 3);
    return (k / BOX) * R * SPAN + r * SPAN +
           ((((k % BOX) >> 2) ^ phase) << 4);
  }
  // Descriptor of k8 step kk for rows row0 .. (row0 % 8 == 0): leading
  // byte offset 16 (unused), stride byte offset one atom.
  static __device__ __forceinline__ uint64_t desc(uint32_t tile, int kk,
                                                  int row0 = 0) {
    const int k = 8 * kk;
    const uint32_t addr =
        tile + (k / BOX) * R * SPAN + row0 * SPAN + (k % BOX) * 4;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(8 * SPAN >> 4) << 32) |
           ((SPAN == 128 ? 1ull : 2ull) << 62);
  }
};

#define MXT_D16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define MXT_D8(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7])

// d (64 x N, f32) (+)= A (64 x 8) B (8 x N), TF32, A and B K-major in
// shared memory; accumulate = 0 overwrites d.  N = 64, 32, 16: 32, 16, 8
// accumulator registers.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      MXT_D32_OPERANDS ", %32, %33, p, 1, 1;\n}\n"
      : MXT_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : MXT_D16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : MXT_D8(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) (+)= A (64 x 8, TF32 in registers) B (8 x N), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      MXT_D32_OPERANDS ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MXT_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : MXT_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : MXT_D8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// k8 step j of a 64 x N f32 accumulator s as the TF32 A operand, split
// into hi and lo.  The accumulator gives this thread columns 8 j + 2 t and
// 8 j + 2 t + 1 (t = lane % 4) of rows g and g + 8 (g = lane / 4); a TF32
// A fragment takes columns t and t + 4 of the same rows (a0: (g, t), a1:
// (g + 8, t), a2: (g, t + 4), a3: (g + 8, t + 4)).  So A's column c of the
// step is the accumulator's column 8 j + sigma(c), sigma = (0, 2, 4, 6, 1,
// 3, 5, 7), and the B tile orders its contraction rows the same way
// (split_cols in the kernels): the sum runs over the same pairs.
template <int N>
__device__ __forceinline__ void frag_tf32(const float (&s)[N], int j,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float v[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    float h, l;
    tf32_split(v[x], h, l);
    hi[x] = __float_as_uint(h);
    lo[x] = __float_as_uint(l);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Stores two neighbouring output values, converted to T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float4 split4(const float (&x)[4], float4& lo) {
  float4 hi;
  tf32_split(x[0], hi.x, lo.x);
  tf32_split(x[1], hi.y, lo.y);
  tf32_split(x[2], hi.z, lo.z);
  tf32_split(x[3], hi.w, lo.w);
  return hi;
}

// The split pass of the float32 kernels, run by the 128 threads of the
// consumer warpgroup (tid 0 .. 127) on a tile as TMA landed it: ROWS x D
// values of T, row-major.
//
// split_rows: the hi and lo KTile<ROWS, D> of the tile itself, for a
// product that contracts along its rows (Q and K in Q K^T).
template <int ROWS, int D, typename T>
__device__ __forceinline__ void split_rows(const T* raw, uint8_t* hi,
                                           uint8_t* lo, int tid) {
  using Tile = KTile<ROWS, D>;
#pragma unroll 4
  for (int g = tid; g < ROWS * D / 4; g += 128) {
    const int r = g / (D / 4), k = (g % (D / 4)) * 4;
    float x[4];
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(raw + r * D + k);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(raw + r * D + k);
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(b[i]);
    }
    float4 l;
    const float4 h = split4(x, l);
    *reinterpret_cast<float4*>(hi + Tile::off(r, k)) = h;
    *reinterpret_cast<float4*>(lo + Tile::off(r, k)) = l;
  }
}

// split_cols: the hi and lo KTile<D, ROWS> of the tile's transpose, for a
// product that contracts down its rows (V in P V) with A from registers:
// within each group of 8 rows, contraction position c holds row sigma(c),
// sigma = (0, 2, 4, 6, 1, 3, 5, 7), to match frag_tf32.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void split_cols(const T* raw, uint8_t* hi,
                                           uint8_t* lo, int tid) {
  using Tile = KTile<D, ROWS>;
#pragma unroll 2
  for (int g = tid; g < D * (ROWS / 8); g += 128) {
    const int d = g % D, r0 = (g / D) * 8;
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = to_f32(raw[(r0 + i) * D + d]);
    const float even[4] = {x[0], x[2], x[4], x[6]};
    const float odd[4] = {x[1], x[3], x[5], x[7]};
    float4 l;
    float4 h = split4(even, l);
    *reinterpret_cast<float4*>(hi + Tile::off(d, r0)) = h;
    *reinterpret_cast<float4*>(lo + Tile::off(d, r0)) = l;
    h = split4(odd, l);
    *reinterpret_cast<float4*>(hi + Tile::off(d, r0 + 4)) = h;
    *reinterpret_cast<float4*>(lo + Tile::off(d, r0 + 4)) = l;
  }
}

// Orders the consumer warpgroup's generic-proxy writes to shared memory
// before the wgmmas (async proxy) that read them, and syncs the
// warpgroup's 128 threads on named barrier 1 (the producer warp is not in
// it).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so that the library needs
// no -lcuda.
inline EncodeTiled encode_tiled() {
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
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int bh, int t, int d, int rows) {
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

// A 3-D map over a contiguous (bh, t, d) float32 or bf16 tensor, read in
// boxes of all d columns x `rows` rows of one head, unswizzled (row-major
// as in memory), zero past t.
inline bool make_map_rows(EncodeTiled encode, CUtensorMap* map,
                          const void* ptr, bool bf16, int bh, int t, int d,
                          int rows) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * es, (cuuint64_t)t * d * es};
  const cuuint32_t box[3] = {(cuuint32_t)d, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over n contiguous float32 values, read in boxes of `box`
// values, zero past n.
inline bool make_map_f32(EncodeTiled encode, CUtensorMap* map,
                         const float* ptr, long n, int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem_strides[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(ptr), dims, strides, boxes, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

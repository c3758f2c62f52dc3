// Kernel N: greedy non-maximum suppression over score-sorted boxes.
//
// Replaces the sequential lax.fori_loop bodies of the JAX package's
// _multibox_detection (mxnet_tpu/ops/contrib.py:277-289: corner IoU, per
// class unless force_suppress) and _proposal (:370-389: pixel IoU with +1
// widths, class-blind).  Neither is a Pallas kernel; the loop runs one
// iteration per box, which in PyTorch is several launches per box (8,732
// boxes a sample at SSD-300's anchors, 6,000 a Proposal image).
//
// Input: B samples of K boxes already sorted by descending score (x1, y1,
// x2, y2 float32), their class ids (float32, read with class_aware) and the
// boxes alive before suppression.  Output: the boxes alive after it.  The
// loop's rule: box i, if still alive when its turn comes, kills every later
// box j > i of the same class (any class without class_aware) whose IoU
// with it exceeds the threshold.
//
// Design: the classic bitmask formulation, which gives the loop's keep set
// exactly.  nms_mask_kernel fills, for every row i, a bit for each later
// column j that i would suppress (K x ceil(K/64) words a sample, 64x64 box
// pairs a block, the column boxes staged in shared memory).  nms_reduce_kernel
// then walks the rows in order, one block a sample: per tile of 64 rows one
// thread resolves the tile's own rows serially from the diagonal words, and
// the block ORs the kept rows' words into the removed set for every later
// tile in parallel.  The IoU is rounded op by op as the plain version's
// separate tensor ops round it (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn: no contraction into an FMA), so the keep set is bitwise the
// plain version's.
//
// Bound: the K^2/2 pair IoUs (about 10 operations each) at the card's
// float32 rate, against the bytes of the boxes, ids and masks read once;
// the mask itself (K^2/8 bytes a sample) is written and read once more.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kReduceThreads = 128;

__device__ __forceinline__ float box_iou(const float* a, const float* b,
                                         bool pixel) {
  const float ix1 = fmaxf(a[0], b[0]);
  const float iy1 = fmaxf(a[1], b[1]);
  const float ix2 = fminf(a[2], b[2]);
  const float iy2 = fminf(a[3], b[3]);
  float iw, ih, area_a, area_b;
  if (pixel) {
    // proposal.cc's integer-pixel convention: a width is x2 - x1 + 1
    iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), 1.0f), 0.0f);
    ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), 1.0f), 0.0f);
    area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.0f),
                       __fadd_rn(__fsub_rn(a[3], a[1]), 1.0f));
    area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                       __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
  } else {
    iw = fmaxf(__fsub_rn(ix2, ix1), 0.0f);
    ih = fmaxf(__fsub_rn(iy2, iy1), 0.0f);
    area_a = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.0f),
                       fmaxf(__fsub_rn(a[3], a[1]), 0.0f));
    area_b = __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.0f),
                       fmaxf(__fsub_rn(b[3], b[1]), 0.0f));
  }
  const float inter = __fmul_rn(iw, ih);
  const float den = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-10f);
  return __fdiv_rn(inter, den);
}

// grid (words, words, B), 64 threads: block (col tile, row tile) writes the
// word `col tile` of each row of `row tile`; tiles left of the diagonal
// hold no later column and are skipped (never read).
__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const float* __restrict__ cls,
                                unsigned long long* __restrict__ mask, int K,
                                int words, float threshold, int pixel,
                                int class_aware) {
  const int col_tile = blockIdx.x, row_tile = blockIdx.y, b = blockIdx.z;
  if (col_tile < row_tile) return;
  __shared__ float cbox[kTile * 4];
  __shared__ float ccls[kTile];
  const int col0 = col_tile * kTile;
  const int ncols = min(kTile, K - col0);
  const float* bb = boxes + static_cast<size_t>(b) * K * 4;
  if (threadIdx.x < ncols) {
    const int j = col0 + threadIdx.x;
    for (int q = 0; q < 4; ++q) cbox[threadIdx.x * 4 + q] = bb[j * 4 + q];
    ccls[threadIdx.x] = class_aware ? cls[static_cast<size_t>(b) * K + j]
                                    : 0.0f;
  }
  __syncthreads();
  const int i = row_tile * kTile + threadIdx.x;
  if (i >= K) return;
  float a[4];
  for (int q = 0; q < 4; ++q) a[q] = bb[i * 4 + q];
  const float ci = class_aware ? cls[static_cast<size_t>(b) * K + i] : 0.0f;
  unsigned long long bits = 0;
  const int start = col_tile == row_tile ? threadIdx.x + 1 : 0;
  for (int t = start; t < ncols; ++t) {
    if (class_aware && ccls[t] != ci) continue;
    if (box_iou(a, &cbox[t * 4], pixel != 0) > threshold) bits |= 1ull << t;
  }
  mask[(static_cast<size_t>(b) * K + i) * words + col_tile] = bits;
}

// one block a sample: the rows in order, 64 at a time
__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ alive_in,
                                  uint8_t* __restrict__ alive_out, int K,
                                  int words) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned long long kept_rows;
  const int b = blockIdx.x;
  const unsigned long long* m = mask + static_cast<size_t>(b) * K * words;
  const uint8_t* in = alive_in + static_cast<size_t>(b) * K;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long bits = 0;
    for (int t = 0; t < kTile; ++t) {
      const int j = w * kTile + t;
      if (j < K && !in[j]) bits |= 1ull << t;
    }
    removed[w] = bits;
  }
  for (int c = 0; c < words; ++c) {
    const int i0 = c * kTile;
    const int n = min(kTile, K - i0);
    if (threadIdx.x < n)
      diag[threadIdx.x] = m[static_cast<size_t>(i0 + threadIdx.x) * words + c];
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long word = removed[c], rows = 0;
      for (int t = 0; t < n; ++t) {
        if (!((word >> t) & 1ull)) {
          rows |= 1ull << t;
          word |= diag[t];
        }
      }
      removed[c] = word;
      kept_rows = rows;
    }
    __syncthreads();
    const unsigned long long rows = kept_rows;
    for (int w = c + 1 + threadIdx.x; w < words; w += blockDim.x) {
      unsigned long long acc = removed[w];
      for (unsigned long long r = rows; r; r &= r - 1) {
        const int t = __ffsll(static_cast<long long>(r)) - 1;
        acc |= m[static_cast<size_t>(i0 + t) * words + w];
      }
      removed[w] = acc;
    }
    __syncthreads();
  }
  uint8_t* out = alive_out + static_cast<size_t>(b) * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    out[j] = ((removed[j / kTile] >> (j % kTile)) & 1ull) ? 0 : 1;
}

}  // namespace

// boxes (B, K, 4) f32, cls (B, K) f32 (unused without class_aware),
// alive_in / alive_out (B, K) uint8, mask scratch (B, K, ceil(K/64)) words.
extern "C" int mxt_nms(const void* boxes, const void* cls, const void* alive_in,
                       void* alive_out, void* mask, int B, int K,
                       float threshold, int pixel, int class_aware,
                       void* stream) {
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + kTile - 1) / kTile;
  const dim3 grid(words, words, B);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(cls),
      static_cast<unsigned long long*>(mask), K, words, threshold, pixel,
      class_aware);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long);
  nms_reduce_kernel<<<B, kReduceThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(alive_in), static_cast<uint8_t*>(alive_out),
      K, words);
  return static_cast<int>(cudaGetLastError());
}

MXT_DEFINE_ERROR_STRING

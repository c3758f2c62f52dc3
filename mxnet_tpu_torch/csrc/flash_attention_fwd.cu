// Flash-attention forward for Hopper (sm_90a), float32 math.
//
// Replaces mxnet_tpu/ops/flash_attention.py:_flash_attention, the Pallas TPU
// kernel _fa_kernel.  It computes the same function:
//   O = softmax(scale * Q K^T  [causal: -1e30 where k > q]) V
// with an online softmax whose running max m, running sum l and accumulator
// acc stay in float32, and o = acc / max(l, 1e-30) cast to the input type.
//
// Bound on an H100 SXM at the serving shape (B*H = 64, T = 1024, D = 64,
// bf16, causal): 4*B*H*T^2*D/2 = 8.6 GFLOP, about 9 us at 989 TFLOP/s on the
// tensor cores; q, k, v and o are 33.6 MB, about 10 us at 3.35 TB/s.  So the
// function is bound by bytes.  This first kernel does its products with
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), which puts its own
// ceiling near 130 us; wgmma, TMA and warp specialisation are later work.
//
// Design, versus the TPU kernel:
//  * The TPU grid (B*H, q-blocks, k-blocks) walks k-blocks in order and
//    carries m/l/acc in VMEM scratch.  Here one thread block owns one
//    (b*h, 64-row q-tile) and loops over the k-tiles itself, so nothing is
//    carried between blocks.
//  * Q (pre-scaled) and each K tile are stored transposed in shared memory,
//    V row-major, so every inner-loop read is a float4.  256 threads form a
//    16 x 16 grid; each thread owns a 4 x 4 block of the 64 x 64 score tile
//    and the matching 4 rows x D/16 columns of acc, in registers.  A row's
//    max and sum are reduced over its 16 threads with warp shuffles.
//  * Causal k-tiles that lie wholly above the diagonal are skipped: in the
//    reference their p is exp(-1e30 - m) = 0 and their correction is 1.
//  * Keys past the end of a ragged last tile get -inf (exactly 0 weight);
//    causal masking uses -1e30, as the reference does.
//  * The op's block_q/block_k only decide whether the kernel is used (the
//    divisibility rule); the kernel's own tiles are 64 x 64 for every shape.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per k-tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int PS = BM + 4;    // row stride of the transposed P tile
constexpr float NEG_BIG = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(h[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// Reads N consecutive floats from shared memory with the widest loads the
// count allows (the address is N-float aligned by construction).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// Stages rows [row0, row0 + ROWS) of one (b*h) slice, transposed, into
// dst[d * ROWS + row], times `mul`.  Consecutive threads take consecutive
// rows so that the transposed shared-memory writes do not collide.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 int row0, int nrows,
                                                 float mul, float* dst) {
  for (int g = threadIdx.x; g < ROWS * (D / 4); g += THREADS) {
    const int row = g % ROWS;
    const int c = (g / ROWS) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + row < nrows) Io<T>::load4(src + (size_t)(row0 + row) * D + c, vals);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c + i) * ROWS + row] = vals[i] * mul;
  }
}

// Stages rows [row0, row0 + BN) row-major into dst[row * D + d].
template <int D, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int row0,
                                           int nrows, float* dst) {
  for (int g = threadIdx.x; g < BN * (D / 4); g += THREADS) {
    const int row = g / (D / 4);
    const int c = (g % (D / 4)) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + row < nrows) Io<T>::load4(src + (size_t)(row0 + row) * D + c, vals);
    *reinterpret_cast<float4*>(dst + row * D + c) =
        make_float4(vals[0], vals[1], vals[2], vals[3]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int tq,
                           int tk, float scale, int causal) {
  constexpr int CW = D / 16;  // acc columns per thread
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* qs_t = smem;              // [D][BM], pre-scaled
  float* ks_t = qs_t + D * BM;     // [D][BN]
  float* vs = ks_t + D * BN;       // [BN][D]
  float* ps_t = vs + BN * D;       // [BN][PS]

  const int bh = blockIdx.x;
  // the heaviest causal q-tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  stage_transposed<D, BM>(qb, q0, tq, scale, qs_t);

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BM, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_transposed<D, BN>(kb, k0, tk, 1.f, ks_t);
    stage_rows<D>(vb, k0, tk, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kv[4];
      lds<4>(qs_t + d * BM + ty * 4, qa);
      lds<4>(ks_t + d * BN + tx * 4, kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

    if (k0 + BN > tk || (causal && k0 + BN - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + tx * 4 + j;
          if (kp >= tk) s[i][j] = -INFINITY;
          else if (causal && kp > q0 + ty * 4 + i) s[i][j] = NEG_BIG;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps_t + (tx * 4 + j) * PS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float p[4], vv[CW];
      lds<4>(ps_t + kk * PS + ty * 4, p);
      lds<CW>(vs + kk * D + tx * CW, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + (size_t)bh * tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c)
      Io<T>::store(ob + (size_t)qp * D + tx * CW + c, acc[i][c] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int tq, int tk, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(D * BM + D * BN + BN * D + BN * PS);
  auto kernel = flash_attention_fwd_kernel<D, T>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = mxt_max_dynamic_smem_once(kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int bh, int tq, int tk, float scale,
                       int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, bh, tq, tk, scale, causal, stream);
    case 32: return launch<32, T>(q, k, v, o, bh, tq, tk, scale, causal, stream);
    case 64: return launch<64, T>(q, k, v, o, bh, tq, tk, scale, causal, stream);
    case 128: return launch<128, T>(q, k, v, o, bh, tq, tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, tq, d), k and v: (bh, tk, d), o: (bh, tq, d), all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       int dtype, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || (tq + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, o, bh, tq, tk, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, o, bh, tq, tk, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

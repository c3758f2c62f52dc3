// Flash-attention backward for Hopper (sm_90a), float32 math.
//
// The gradient of K1 (csrc/flash_attention_fwd*.cu).  In the JAX package it
// is mxnet_tpu/ops/flash_attention.py:_fa_bwd, a blockwise-recompute
// backward in plain jnp hung on the Pallas forward by jax.custom_vjp; its
// residuals are q, k, v and o only.  It computes the same function, with
// every product and sum in float32 and the results cast to the input type:
//   P = softmax(scale * Q K^T  [causal: key > query masked to 0 weight])
//   D_i = rowsum(dO * O)
//   dV = P^T dO;  dS = P * (dO V^T - D_i);  dQ = dS K * scale;
//   dK = dS^T Q * scale
// The causal mask is top-left aligned (query position >= key position), as
// the reference's.
//
// Bound on an H100 SXM at the training shape (B*H = 128, T = 1024, D = 64,
// bf16, causal): the five products are 10*D operations per unmasked
// (query, key) pair, 43 GFLOP, about 0.043 ms at 989 TFLOP/s; q, k, v, o,
// dO, dq, dk and dv are 134 MB, about 0.040 ms at 3.35 TB/s.  So the
// function is bound by operations, just.  This first kernel does its
// products with float32 FMAs on the CUDA cores (67 TFLOP/s peak) and
// recomputes S three times and dO V^T twice, which puts its own ceiling
// near 1.2 ms; wgmma, TMA and a fused dQ pass are later work.
//
// Design.  Two kernels, launched back to back on the caller's stream, with
// no atomics, so that the result does not depend on the order in which
// blocks run:
//  1. dq_kernel, one block per (b*h, 64-row q-tile): D_i from dO and O;
//     a first pass over the k-tiles the causal mask leaves recomputes the
//     row log-sum-exp (the forward keeps no statistics: the JAX residuals
//     are q, k, v, o, so neither forward kernel changes); a second pass
//     accumulates dQ in registers.  The row statistics go to a float32
//     scratch (lse, delta) that the wrapper allocates.
//  2. dkdv_kernel, one block per (b*h, 64-key k-tile): loops over the
//     q-tiles that see its keys and accumulates dK and dV in registers.
// 256 threads form a 16 x 16 grid; each thread owns a 4 x 4 block of the
// 64 x 64 score tile and 4 rows x D/16 columns of its accumulators.  Tiles
// that a product reads along its inner dimension are stored transposed in
// shared memory, so every inner-loop read is a float4 (Q, K and dO are kept
// in both layouts where two products read them differently).  P and dS
// pass between threads through one shared 64 x 64 tile.  Entries past a
// ragged end or above the causal diagonal get exactly 0 weight, as
// exp(-1e30 - m) gives in the reference.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int PS = 68;        // row stride of the shared P / dS tile
constexpr float NEG_BIG = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void load4(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
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

// N consecutive floats from shared memory, with the widest loads the count
// allows (the address is N-float aligned by construction).
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

// Stages rows [row0, row0 + ROWS) of one (b*h) slice, times `mul`, into
// dst_t[d * ROWS + row] (transposed) and/or dst_r[row * D + d] (row-major);
// either may be null.  Rows past `nrows` are zeros.  Consecutive threads
// take consecutive rows so that the transposed writes do not collide.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int nrows, float mul, float* dst_t,
                                      float* dst_r) {
  for (int g = threadIdx.x; g < ROWS * (D / 4); g += THREADS) {
    const int row = g % ROWS;
    const int c = (g / ROWS) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + row < nrows) Io<T>::load4(src + (size_t)(row0 + row) * D + c, vals);
#pragma unroll
    for (int i = 0; i < 4; ++i) vals[i] *= mul;
    if (dst_t != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dst_t[(c + i) * ROWS + row] = vals[i];
    }
    if (dst_r != nullptr)
      *reinterpret_cast<float4*>(dst_r + row * D + c) =
          make_float4(vals[0], vals[1], vals[2], vals[3]);
  }
}

// out[i][j] = sum_d a_t[d][a0 + i] * b_t[d][b0 + j] over two transposed
// tiles (a_t with AR rows, b_t with BR rows): one 4 x 4 block of a product.
template <int D, int AR, int BR>
__device__ __forceinline__ void block_product(const float* a_t, int a0,
                                              const float* b_t, int b0,
                                              float (&out)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
    lds<4>(a_t + d * AR + a0, a);
    lds<4>(b_t + d * BR + b0, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// acc[i][c] += sum_r tile[r][r0 + i] * rows[r][c0 + c] over the 64 rows of a
// shared [64][PS] tile and a row-major [64][D] tile.
template <int D>
__device__ __forceinline__ void accumulate(const float* tile, int r0,
                                           const float* rows, int c0,
                                           float (&acc)[4][D / 16]) {
  constexpr int CW = D / 16;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float p[4], x[CW];
    lds<4>(tile + r * PS + r0, p);
    lds<CW>(rows + r * D + c0, x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p[i], x[c], acc[i][c]);
  }
}

// Writes a thread's 4 x 4 block v[i][j] to tile[(c0 + j) * PS + r0 + i]:
// the block transposed, one float4 per j.
__device__ __forceinline__ void put_transposed(float* tile, int r0, int c0,
                                               const float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(tile + (c0 + j) * PS + r0) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse_out, float* __restrict__ delta_out, int tq,
          int tk, float scale, int causal) {
  constexpr int CW = D / 16;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* qs_t = smem;               // [D][BM], Q^T * scale
  float* dos_t = qs_t + D * BM;     // [D][BM], dO^T
  float* ks_t = dos_t + D * BM;     // [D][BN], K^T
  float* kr = ks_t + D * BN;        // [BN][D], K
  float* vs_t = kr + BN * D;        // [D][BN], V^T
  float* dss = vs_t + D * BN;       // [BN][PS], dS^T

  const int bh = blockIdx.x;
  // the heaviest causal q-tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t qoff = (size_t)bh * tq * D;
  const size_t koff = (size_t)bh * tk * D;
  const T* kb = k + koff;
  const T* vb = v + koff;

  stage<D, BM>(q + qoff, q0, tq, scale, qs_t, nullptr);
  stage<D, BM>(dout + qoff, q0, tq, 1.f, dos_t, nullptr);

  // D_i for this thread's 4 rows: its CW columns, then the row's 16 threads
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    float s = 0.f;
    if (qp < tq) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const size_t at = qoff + (size_t)qp * D + tx * CW + c;
        s = fmaf(Io<T>::load(dout + at), Io<T>::load(o + at), s);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    delta[i] = s;
  }

  const int q_last = min(q0 + BM, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;

  // pass 1: the row log-sum-exp over the keys the mask leaves
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K is no longer read
    stage<D, BN>(kb, k0, tk, 1.f, ks_t, nullptr);
    __syncthreads();
    float s[4][4];
    block_product<D, BM, BN>(qs_t, ty * 4, ks_t, tx * 4, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        if (kp >= tk) s[i][j] = -INFINITY;
        else if (causal && kp > q0 + ty * 4 + i) s[i][j] = NEG_BIG;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = m[i] + logf(l[i]);
    const int qp = q0 + ty * 4 + i;
    if (tx == 0 && qp < tq) {
      lse_out[(size_t)bh * tq + qp] = lse[i];
      delta_out[(size_t)bh * tq + qp] = delta[i];
    }
  }

  // pass 2: dQ = dS K * scale, with dS = P * (dO V^T - D_i)
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    stage<D, BN>(kb, k0, tk, 1.f, ks_t, kr);
    stage<D, BN>(vb, k0, tk, 1.f, vs_t, nullptr);
    __syncthreads();
    float s[4][4], dp[4][4];
    block_product<D, BM, BN>(qs_t, ty * 4, ks_t, tx * 4, s);
    block_product<D, BM, BN>(dos_t, ty * 4, vs_t, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool off = kp >= tk || (causal && kp > q0 + ty * 4 + i);
        const float p = off ? 0.f : expf(s[i][j] - lse[i]);
        s[i][j] = p * (dp[i][j] - delta[i]);
      }
    put_transposed(dss, ty * 4, tx * 4, s);
    __syncthreads();
    accumulate<D>(dss, ty * 4, kr, tx * CW, acc);
  }

  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= tq) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      Io<T>::store(dqb + (size_t)qp * D + tx * CW + c, acc[i][c] * scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
            float scale, int causal) {
  constexpr int CW = D / 16;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* ks_t = smem;               // [D][BN], K^T
  float* vs_t = ks_t + D * BN;      // [D][BN], V^T
  float* qs_t = vs_t + D * BN;      // [D][BM], Q^T * scale
  float* qr = qs_t + D * BM;        // [BM][D], Q * scale
  float* dos_t = qr + BM * D;       // [D][BM], dO^T
  float* dor = dos_t + D * BM;      // [BM][D], dO
  float* ps = dor + BM * D;         // [BM][PS], P, then dS
  float* lse_s = ps + BM * PS;      // [BM]
  float* delta_s = lse_s + BM;      // [BM]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;   // causal: the first k-tiles are heaviest
  const int tx = threadIdx.x % 16;  // this thread's queries: tx * 4 + j
  const int ty = threadIdx.x / 16;  // this thread's keys: ty * 4 + i
  const size_t qoff = (size_t)bh * tq * D;
  const size_t koff = (size_t)bh * tk * D;
  const T* qb = q + qoff;
  const T* dob = dout + qoff;

  stage<D, BN>(k + koff, k0, tk, 1.f, ks_t, nullptr);
  stage<D, BN>(v + koff, k0, tk, 1.f, vs_t, nullptr);

  float dka[4][CW], dva[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dka[i][c] = dva[i][c] = 0.f;

  // causal: queries before k0 see none of these keys
  for (int q0 = causal ? (k0 / BM) * BM : 0; q0 < tq; q0 += BM) {
    __syncthreads();  // the previous q-tile and P / dS are no longer read
    stage<D, BM>(qb, q0, tq, scale, qs_t, qr);
    stage<D, BM>(dob, q0, tq, 1.f, dos_t, dor);
    if (threadIdx.x < BM) {
      const int qp = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qp < tq ? lse[(size_t)bh * tq + qp] : 0.f;
      delta_s[threadIdx.x] = qp < tq ? delta[(size_t)bh * tq + qp] : 0.f;
    }
    __syncthreads();
    // st[i][j] = S[query tx*4+j][key ty*4+i], likewise dpt = (dO V^T)^T
    float st[4][4], dpt[4][4], dst[4][4];
    block_product<D, BN, BM>(ks_t, ty * 4, qs_t, tx * 4, st);
    block_product<D, BN, BM>(vs_t, ty * 4, dos_t, tx * 4, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + ty * 4 + i;
        const int qp = q0 + tx * 4 + j;
        const bool off = qp >= tq || kp >= tk || (causal && kp > qp);
        const float p = off ? 0.f : expf(st[i][j] - lse_s[tx * 4 + j]);
        st[i][j] = p;
        dst[i][j] = p * (dpt[i][j] - delta_s[tx * 4 + j]);
      }
    put_transposed(ps, ty * 4, tx * 4, st);   // ps[query][key] = P
    __syncthreads();
    accumulate<D>(ps, ty * 4, dor, tx * CW, dva);     // dV += P^T dO
    __syncthreads();
    put_transposed(ps, ty * 4, tx * 4, dst);  // ps[query][key] = dS
    __syncthreads();
    accumulate<D>(ps, ty * 4, qr, tx * CW, dka);      // dK += dS^T Q scale
  }

  T* dkb = dk + koff;
  T* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= tk) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      Io<T>::store(dkb + (size_t)kp * D + tx * CW + c, dka[i][c]);
      Io<T>::store(dvb + (size_t)kp * D + tx * CW + c, dva[i][c]);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int bh, int tq,
                   int tk, float scale, int causal, cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (size_t)(2 * D * BM + 3 * D * BN + BN * PS);
  const size_t smem_dkdv =
      sizeof(float) * (size_t)(2 * D * BN + 4 * D * BM + BM * PS + 2 * BM);
  auto k_dq = dq_kernel<D, T>;
  auto k_dkdv = dkdv_kernel<D, T>;
  static std::atomic<unsigned long long> dq_set{0}, dkdv_set{0};
  cudaError_t err = mxt_max_dynamic_smem_once(k_dq, (int)smem_dq, dq_set);
  if (err != cudaSuccess) return err;
  err = mxt_max_dynamic_smem_once(k_dkdv, (int)smem_dkdv, dkdv_set);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  k_dq<<<dim3(bh, (tq + BM - 1) / BM), THREADS, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse,
      delta, tq, tk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<dim3(bh, (tk + BN - 1) / BN), THREADS, smem_dkdv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta, int bh, int tq,
                       int tk, float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, tq, tk, scale, causal, s);
    case 32: return launch<32, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, tq, tk, scale, causal, s);
    case 64: return launch<64, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, tq, tk, scale, causal, s);
    case 128: return launch<128, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, tq, tk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (bh, tq, d); k, v, dk, dv: (bh, tk, d); lse and delta:
// (bh, tq) float32 scratch; all contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  Launches the two kernels on `stream` and returns the first
// launch error as a cudaError_t.
extern "C" int mxt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* delta,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || (tq + BM - 1) / BM > 65535 ||
      (tk + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, o, dout, dq, dk, dv, lse_f, delta_f,
                            bh, tq, tk, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, lse_f,
                                    delta_f, bh, tq, tk, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

MXT_DEFINE_ERROR_STRING

// Kernel R: ROI max pooling, forward and backward (float32 and bfloat16).
//
// Replaces _roi_pooling, mxnet_tpu/ops/vision.py:21-57 (plain jnp, not
// Pallas), and the VJP JAX derives for it.  The JAX formula computes every
// bin as a masked max over the whole feature map, an intermediate of
// R * ph * pw * C * H * W values: at Faster R-CNN's width (128 ROIs, 512
// channels, a 37x62 map, 7x7 bins) that is 7.4e9, which no card holds.
//
// The ROIs come in as integer feature-map coordinates (batch index, x1, y1,
// x2, y2), rounded by the wrapper exactly as the JAX op rounds them.  A bin
// (i, j) of a ROI covers rows [y1 + floor(i*rh/ph), y1 + ceil((i+1)*rh/ph))
// and columns likewise, clipped to the map; neighbouring bins may share a
// row or column.
//
// Forward (roi_pool_fwd_kernel): one thread an output (r, c, i, j), which
// reads its bin twice: its max, then the count of elements equal to it.
// A bin that is empty, or whose max is not finite, gives 0 and a count of
// 0 (jnp.where(isfinite(val), val, 0)).
//
// Backward (roi_pool_bwd_kernel): the gradient of jnp.max splits a bin's
// output gradient evenly among its tied maxima (g / count), and feature
// maps after a ReLU are full of tied zeros, so the split decides it.  The
// backward is a gather: one thread a data element (n, c, h, w) walks the
// ROIs and the bins that cover it, in the order (r, i, j), and adds g /
// count where the element equals the bin's max.  No atomics: each element
// has one writer and one order of summation, the plain version's, so the
// result is bitwise the plain version's and the same on every run.
//
// Bound: bytes.  The forward reads the map once and writes the output and
// the counts; the backward reads the map, the output, the counts and the
// output gradient once and writes the map's gradient.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

struct Roi {
  int b, x1, y1, rh, rw;
};

__device__ __forceinline__ Roi load_roi(const int* __restrict__ coords,
                                        int r) {
  const int* c = coords + r * 5;
  Roi roi;
  roi.b = c[0];
  roi.x1 = c[1];
  roi.y1 = c[2];
  roi.rw = max(c[3] - c[1] + 1, 1);
  roi.rh = max(c[4] - c[2] + 1, 1);
  return roi;
}

template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ data,
                                    const int* __restrict__ coords,
                                    T* __restrict__ out,
                                    int* __restrict__ count, int C, int H,
                                    int W, int R, int ph, int pw) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t total = static_cast<size_t>(R) * C * ph * pw;
  if (idx >= total) return;
  const int j = idx % pw;
  const int i = (idx / pw) % ph;
  const int c = (idx / (static_cast<size_t>(pw) * ph)) % C;
  const int r = idx / (static_cast<size_t>(pw) * ph * C);
  const Roi roi = load_roi(coords, r);
  const int hs = max(roi.y1 + (i * roi.rh) / ph, 0);
  const int he = min(roi.y1 + ((i + 1) * roi.rh + ph - 1) / ph, H);
  const int ws = max(roi.x1 + (j * roi.rw) / pw, 0);
  const int we = min(roi.x1 + ((j + 1) * roi.rw + pw - 1) / pw, W);
  const T* plane = data + (static_cast<size_t>(roi.b) * C + c) * H * W;
  float m = -INFINITY;
  for (int h = hs; h < he; ++h)
    for (int w = ws; w < we; ++w) {
      const float v = load_f(plane, static_cast<size_t>(h) * W + w);
      if (v > m || v != v) m = v;  // a NaN stays, as in amax
    }
  int n = 0;
  const bool finite = isfinite(m);
  if (finite)
    for (int h = hs; h < he; ++h)
      for (int w = ws; w < we; ++w)
        n += load_f(plane, static_cast<size_t>(h) * W + w) == m;
  store_f(out, idx, finite ? m : 0.0f);
  count[idx] = n;
}

template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ data,
                                    const int* __restrict__ coords,
                                    const T* __restrict__ out,
                                    const int* __restrict__ count,
                                    const T* __restrict__ gout,
                                    T* __restrict__ gdata, int N, int C,
                                    int H, int W, int R, int ph, int pw) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t total = static_cast<size_t>(N) * C * H * W;
  if (idx >= total) return;
  const int w = idx % W;
  const int h = (idx / W) % H;
  const int c = (idx / (static_cast<size_t>(W) * H)) % C;
  const int n = idx / (static_cast<size_t>(W) * H * C);
  const float x = load_f(data, idx);
  float acc = 0.0f;
  for (int r = 0; r < R; ++r) {
    const Roi roi = load_roi(coords, r);
    if (roi.b != n || h < roi.y1 || h >= roi.y1 + roi.rh || w < roi.x1 ||
        w >= roi.x1 + roi.rw)
      continue;
    for (int i = 0; i < ph; ++i) {
      const int hs = roi.y1 + (i * roi.rh) / ph;
      const int he = roi.y1 + ((i + 1) * roi.rh + ph - 1) / ph;
      if (h < hs || h >= he) continue;
      for (int j = 0; j < pw; ++j) {
        const int ws = roi.x1 + (j * roi.rw) / pw;
        const int we = roi.x1 + ((j + 1) * roi.rw + pw - 1) / pw;
        if (w < ws || w >= we) continue;
        const size_t o = ((static_cast<size_t>(r) * C + c) * ph + i) * pw + j;
        const int k = count[o];
        if (k > 0 && x == load_f(out, o))
          acc = __fadd_rn(acc, __fdiv_rn(load_f(gout, o),
                                         static_cast<float>(k)));
      }
    }
  }
  store_f(gdata, idx, acc);
}

template <typename T>
int launch_fwd(const void* data, const void* coords, void* out, void* count,
               int N, int C, int H, int W, int R, int ph, int pw,
               cudaStream_t s) {
  const size_t total = static_cast<size_t>(R) * C * ph * pw;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  roi_pool_fwd_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const int*>(coords),
      static_cast<T*>(out), static_cast<int*>(count), C, H, W, R, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* data, const void* coords, const void* out,
               const void* count, const void* gout, void* gdata, int N, int C,
               int H, int W, int R, int ph, int pw, cudaStream_t s) {
  const size_t total = static_cast<size_t>(N) * C * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  roi_pool_bwd_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const int*>(coords),
      static_cast<const T*>(out), static_cast<const int*>(count),
      static_cast<const T*>(gout), static_cast<T*>(gdata), N, C, H, W, R, ph,
      pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data (N, C, H, W), coords (R, 5) int32, out (R, C, ph, pw) in data's type,
// count (R, C, ph, pw) int32; bf16 = 1 for bfloat16 tensors, 0 for float32.
extern "C" int mxt_roi_pool_fwd(const void* data, const void* coords,
                                void* out, void* count, int N, int C, int H,
                                int W, int R, int ph, int pw, int bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(data, coords, out, count, N, C, H,
                                          W, R, ph, pw, s)
              : launch_fwd<float>(data, coords, out, count, N, C, H, W, R,
                                  ph, pw, s);
}

// gout (R, C, ph, pw) and gdata (N, C, H, W) in data's type; every element
// of gdata is written.
extern "C" int mxt_roi_pool_bwd(const void* data, const void* coords,
                                const void* out, const void* count,
                                const void* gout, void* gdata, int N, int C,
                                int H, int W, int R, int ph, int pw, int bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(data, coords, out, count, gout,
                                          gdata, N, C, H, W, R, ph, pw, s)
              : launch_bwd<float>(data, coords, out, count, gout, gdata, N,
                                  C, H, W, R, ph, pw, s);
}

MXT_DEFINE_ERROR_STRING

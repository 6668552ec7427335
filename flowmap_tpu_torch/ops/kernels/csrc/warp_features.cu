// Bounded-radius bilinear feature warp (any column, rows within a window),
// forward and feature gradient.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/warp_kernel.py
// (warp_features; forward pallas_call at :290, feature-gradient at :334).
//
// Semantics: F.grid_sample(zeros padding, align_corners=False) of each
// output pixel (i, j) at grid[i, j], with the TPU kernel's vertical window: a
// bilinear corner is used only when its row lies in [i - radius,
// i + radius + 1] and in the image, and its column lies in the image. A
// corner outside the window is dropped, as the TPU kernel drops it (no
// window slot matches it); within the radius the result is the unbounded
// warp's. The grid carries no gradient.
//
// The TPU kernel copies each block's row window into fast memory and builds
// one-hot column matrices for the matrix unit, because the TPU has no
// gather; its NHWC transposes and channel padding to 128 serve that copy.
// Here the forward is a direct gather of the (at most) four corners from
// NHWC features, one thread per (output pixel, 16-byte channel vector). The
// rounding points are the TPU kernel's: the column weight is rounded to the
// feature type before the product, the row weight and both sums stay in f32,
// and the result is rounded once.
//
// The backward scatters: each thread folds the row weight into its output
// pixel's cotangent, rounds that to the feature type (as the TPU kernel
// does), and adds weight * cotangent to the four corners of an f32 scratch
// with atomicAdd, four channels at a time (Hopper's float4 atomic); the
// caller casts the scratch to the feature type. Columns
// are unbounded, so an input pixel's contributors cannot be enumerated from
// a small window as in shift_warp.cu. The order of the atomic adds, and with
// it the last bits of the f32 sums, varies from run to run.
//
// Bound: bytes (features or cotangent, grid and result once each; the
// backward also clears, fills and casts the f32 scratch). Compiled with
// --fmad=false so that the f32 products and sums round as the plain PyTorch
// version's do.

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;

// The two candidate rows and columns of one output pixel: index, weight and
// whether the corner is used.
struct Taps {
  int yi[2], xi[2];
  float wy[2], wx[2];
  bool use_y[2], use_x[2];
};

template <typename T>
__device__ __forceinline__ Taps taps_of(const float* grid, int i, int h, int w,
                                        int radius) {
  const float x = unnormalize(grid[0], w);
  const float y = unnormalize(grid[1], h);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float tx = x - x0;
  const float ty = y - y0;
  // Clamped before the conversion: a far-off (or NaN) coordinate stays out of
  // range without overflowing the int.
  const int x0i = (int)fminf(fmaxf(x0, -2.0f), (float)w);
  const int y0i = (int)fminf(fmaxf(y0, -2.0f), (float)h);
  Taps t;
  t.wy[0] = 1.0f - ty;
  t.wy[1] = ty;
  t.wx[0] = Pack<T>::round(1.0f - tx);
  t.wx[1] = Pack<T>::round(tx);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    t.yi[a] = y0i + a;
    t.xi[a] = x0i + a;
    const int dy = t.yi[a] - i;
    t.use_y[a] = t.yi[a] >= 0 && t.yi[a] < h && dy >= -radius && dy <= radius + 1;
    t.use_x[a] = t.xi[a] >= 0 && t.xi[a] < w;
  }
  return t;
}

// in: (n, h, w, c); grid: (n, h, wg, 2); out: (n, h, wg, c).
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_features_fwd_kernel(const T* __restrict__ in, const float* __restrict__ grid,
                         T* __restrict__ out, int h, int w, int wg, int c,
                         int radius, long long total) {
  using P = Pack<T>;
  constexpr int V = P::kN;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int vecs = c / V;
  const int cv = (int)(idx % vecs);
  const long long pix = idx / vecs;  // (frame, i, j) over the grid
  const int i = (int)((pix / wg) % h);
  const long long frame = pix / ((long long)wg * h);
  const Taps t = taps_of<T>(grid + pix * 2, i, h, w, radius);

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!t.use_y[a]) continue;
    float row[V];
#pragma unroll
    for (int k = 0; k < V; ++k) row[k] = 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!t.use_x[b]) continue;
      float v[V];
      P::load(in + ((frame * h + t.yi[a]) * w + t.xi[b]) * c + cv * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) row[k] = row[k] + t.wx[b] * v[k];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] + t.wy[a] * row[k];
  }
  P::store(out + pix * c + cv * V, acc);
}

// g: (n, h, wg, c) in the feature type; d_in: (n, h, w, c) f32, zero on entry.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_features_bwd_kernel(const T* __restrict__ g, const float* __restrict__ grid,
                         float* __restrict__ d_in, int h, int w, int wg, int c,
                         int radius, long long total) {
  using P = Pack<T>;
  constexpr int V = P::kN;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int vecs = c / V;
  const int cv = (int)(idx % vecs);
  const long long pix = idx / vecs;
  const int i = (int)((pix / wg) % h);
  const long long frame = pix / ((long long)wg * h);
  const Taps t = taps_of<T>(grid + pix * 2, i, h, w, radius);

  float gv[V];
  P::load(g + pix * c + cv * V, gv);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!t.use_y[a]) continue;
    float gw[V];
#pragma unroll
    for (int k = 0; k < V; ++k) gw[k] = P::round(t.wy[a] * gv[k]);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!t.use_x[b]) continue;
      // Four channels per atomic (sm_90's float4 atomicAdd): 16-byte
      // aligned, since c and cv * V are multiples of 4.
      float4* dst = reinterpret_cast<float4*>(
          d_in + ((frame * h + t.yi[a]) * w + t.xi[b]) * c + cv * V);
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        atomicAdd(dst + k / 4, make_float4(t.wx[b] * gw[k], t.wx[b] * gw[k + 1],
                                           t.wx[b] * gw[k + 2], t.wx[b] * gw[k + 3]));
      }
    }
  }
}

template <typename T>
int launch(bool backward, const void* src, const void* grid, void* dst, int n,
           int h, int w, int wg, int c, int radius, cudaStream_t stream) {
  const long long total = (long long)n * h * wg * (c / Pack<T>::kN);
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (backward) {
    warp_features_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(grid),
        static_cast<float*>(dst), h, w, wg, c, radius, total);
  } else {
    warp_features_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(grid),
        static_cast<T*>(dst), h, w, wg, c, radius, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (c % 4 == 0), 1 = bfloat16 (c % 8 == 0).
// input: (n, h, w, c); grid: (n, h, wg, 2) float32 in [-1, 1]; out: (n, h, wg, c).
int warp_features_fwd(const void* input, const void* grid, void* out, int n,
                      int h, int w, int wg, int c, int radius, int dtype,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch<__nv_bfloat16>(false, input, grid, out, n, h, w, wg, c, radius, s)
             : launch<float>(false, input, grid, out, n, h, w, wg, c, radius, s);
}

// g: (n, h, wg, c) in the feature type; d_input: (n, h, w, c) float32, zero
// on entry, whatever the feature type.
int warp_features_bwd(const void* g, const void* grid, void* d_input, int n,
                      int h, int w, int wg, int c, int radius, int dtype,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch<__nv_bfloat16>(true, g, grid, d_input, n, h, w, wg, c, radius, s)
             : launch<float>(true, g, grid, d_input, n, h, w, wg, c, radius, s);
}

}  // extern "C"

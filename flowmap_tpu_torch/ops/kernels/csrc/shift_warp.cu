// Small-radius bilinear displacement warp of NHWC features, and its backward.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/shift_warp.py
// (warp_shifts_tpu; forward pallas_call at :243, backward at :275).
//
// Semantics: F.grid_sample(zeros padding, align_corners=False) restricted to
// the (2ry+2) x (2rx+2) tap window of the plain stencil
// (flowmap_tpu_torch/ops/warp.py): a bilinear corner is used only when its
// offset from the output pixel lies in [-ry, ry+1] x [-rx, rx+1] and it lies
// in the image. The TPU kernel walks the whole window with one-hot weights;
// on Hopper the forward is a plain gather of the (at most) four corners.
//
// The backward is the transposed stencil written as a GATHER: each input
// pixel (u, v) sums, over the output pixels (u - sy, v - sx) of its window,
// the weight with which that output pixel's bilinear corners hit (u, v),
// times the output cotangent. Deterministic, no atomics.
//
// Numerics match the plain stencil bit for bit: the same f32 operations in
// the same order (compiled with --fmad=false), the forward's corner weight
// rounded to the feature type before the product, as the stencil does, and
// f32 accumulation over corners in the stencil's tap order.
//
// Layout: one thread per (pixel, 16-byte channel vector): 8 bf16 or 4 f32
// channels, channel vector fastest, so a warp's loads are contiguous.
// Bound: bytes (features and grid read once, output written once).

#include "warp_common.cuh"

namespace {

struct Params {
  float ox, tx, oy, ty;  // floor-corner offsets (integer-valued) and fractions
};

__device__ __forceinline__ Params sample_params(const float* grid, int i, int j,
                                                int h, int w) {
  const float gx = grid[0];
  const float gy = grid[1];
  const float x = unnormalize(gx, w);
  const float y = unnormalize(gy, h);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Params p;
  p.ox = x0 - (float)j;
  p.tx = x - x0;
  p.oy = y0 - (float)i;
  p.ty = y - y0;
  return p;
}

__device__ __forceinline__ float hit(float d) { return fmaxf(1.0f - fabsf(d), 0.0f); }

// The stencil's per-tap weight along one axis.
__device__ __forceinline__ float tap_weight(float o, float t, int s) {
  const float d = o - (float)s;
  return (1.0f - t) * hit(d) + t * hit(d + 1.0f);
}

__device__ __forceinline__ int offset_of(float o) {
  return (int)fminf(fmaxf(o, -1.0e6f), 1.0e6f);
}

template <typename T>
__global__ void shift_warp_fwd_kernel(const T* __restrict__ in,
                                      const float* __restrict__ grid,
                                      T* __restrict__ out, int n, int h, int w,
                                      int c, int ry, int rx) {
  using P = Pack<T>;
  constexpr int V = P::kN;
  const int cg_count = c / V;
  const long long total = (long long)n * h * w * cg_count;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cg = (int)(idx % cg_count);
  const long long pix = idx / cg_count;
  const int j = (int)(pix % w);
  const int i = (int)((pix / w) % h);
  const long long frame = pix / ((long long)w * h);

  const Params p = sample_params(grid + pix * 2, i, j, h, w);
  const int oy = offset_of(p.oy);
  const int ox = offset_of(p.ox);
  // Corner weights exactly as the stencil forms them: wy * wx in f32.
  const float wy[2] = {1.0f - p.ty, p.ty};
  const float wx[2] = {1.0f - p.tx, p.tx};

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int sy = oy + a;
    const int yi = i + sy;
    if (sy < -ry || sy > ry + 1 || yi < 0 || yi >= h) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int sx = ox + b;
      const int xi = j + sx;
      if (sx < -rx || sx > rx + 1 || xi < 0 || xi >= w) continue;
      const float wt = P::round(wy[a] * wx[b]);
      float v[V];
      P::load(in + ((frame * h + yi) * w + xi) * c + cg * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = acc[k] + P::round(wt * v[k]);
    }
  }
  P::store(out + pix * c + cg * V, acc);
}

template <typename T>
__global__ void shift_warp_bwd_kernel(const T* __restrict__ g,
                                      const float* __restrict__ grid,
                                      T* __restrict__ d_in, int n, int h, int w,
                                      int c, int ry, int rx) {
  using P = Pack<T>;
  constexpr int V = P::kN;
  const int cg_count = c / V;
  const long long total = (long long)n * h * w * cg_count;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cg = (int)(idx % cg_count);
  const long long pix = idx / cg_count;
  const int v = (int)(pix % w);
  const int u = (int)((pix / w) % h);
  const long long frame = pix / ((long long)w * h);

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  for (int sy = -ry; sy <= ry + 1; ++sy) {
    const int i = u - sy;  // output row whose tap sy lands on row u
    if (i < 0 || i >= h) continue;
    for (int sx = -rx; sx <= rx + 1; ++sx) {
      const int j = v - sx;
      if (j < 0 || j >= w) continue;
      const long long opix = (frame * h + i) * w + j;
      const Params p = sample_params(grid + opix * 2, i, j, h, w);
      const float wt = tap_weight(p.oy, p.ty, sy) * tap_weight(p.ox, p.tx, sx);
      if (wt == 0.0f) continue;
      float gv[V];
      P::load(g + opix * c + cg * V, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = acc[k] + wt * gv[k];
    }
  }
  P::store(d_in + pix * c + cg * V, acc);
}

constexpr int kThreads = 256;

template <typename T>
int launch(bool backward, const void* src, const void* grid, void* dst, int n,
           int h, int w, int c, int ry, int rx, cudaStream_t stream) {
  const long long total = (long long)n * h * w * (c / Pack<T>::kN);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (blocks == 0) return 0;
  if (backward) {
    shift_warp_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(grid),
        static_cast<T*>(dst), n, h, w, c, ry, rx);
  } else {
    shift_warp_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(grid),
        static_cast<T*>(dst), n, h, w, c, ry, rx);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (c % 4 == 0), 1 = bfloat16 (c % 8 == 0).
// input/out: (n, h, w, c); grid: (n, h, w, 2) float32 in [-1, 1].
int shift_warp_fwd(const void* input, const void* grid, void* out, int n,
                   int h, int w, int c, int ry, int rx, int dtype,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch<__nv_bfloat16>(false, input, grid, out, n, h, w, c, ry, rx, s)
             : launch<float>(false, input, grid, out, n, h, w, c, ry, rx, s);
}

// g/d_input: (n, h, w, c) in the features' type.
int shift_warp_bwd(const void* g, const void* grid, void* d_input, int n,
                   int h, int w, int c, int ry, int rx, int dtype,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch<__nv_bfloat16>(true, g, grid, d_input, n, h, w, c, ry, rx, s)
             : launch<float>(true, g, grid, d_input, n, h, w, c, ry, rx, s);
}

}  // extern "C"

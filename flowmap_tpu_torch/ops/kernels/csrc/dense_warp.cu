// Dense bilinear image warp at unbounded pixel coordinates, forward only.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/dense_warp.py
// (dense_warp_bilinear_planar; its pallas_call at :200).
//
// Semantics: out[n, ch, i, j] is the bilinear sample of image[n, ch] at the
// pixel coordinate (px[n, i, j], py[n, i, j]) (align_corners=False: pixel
// centres at integers). "zeros" drops a corner outside the image, "border"
// clamps its index into it; where both clamped corners of an axis coincide
// their weights (1 - t) + t count as 1, which is what the TPU kernel's sum of
// two one-hot rows gives after its rounding. Rounding points are the TPU
// kernel's: the image and the two x weights are in the compute type T
// (float32 or bfloat16), the products and the x sum are f32, the y weights
// and the y sum are f32, the output is f32.
//
// The TPU kernel multiplies by one-hot weight matrices built in fast memory
// because the TPU has no gather. Here it is a gather: one thread per output
// pixel reads its coordinates once and, for every channel, the (at most)
// four corners from the image's native (c, h, w) planes. A block covers a
// tile of 32 x 8 output pixels, so that under a smooth displacement field
// the rows its threads read overlap and are served from the SM's cache.
// Coordinates far outside the image are clamped as floats before the
// conversion to int, so the conversion never overflows.
//
// Bound: bytes (coordinates, image and result once each). Compiled with
// --fmad=false so that the f32 products and sums round as the plain PyTorch
// version's do.

#include "warp_common.cuh"

namespace {

constexpr int kTileW = 32;  // output pixels of a block: 32 columns x 8 rows
constexpr int kTileH = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One axis of one output pixel: the two corner indices, their weights and
// whether each corner is read.
struct Axis {
  int i[2];
  float w[2];
  bool use[2];
};

template <typename T, bool kBorder, bool kRoundWeights>
__device__ __forceinline__ Axis axis_of(float coord, int size) {
  const float c0 = floorf(coord);
  const float t = coord - c0;
  // Clamped before the conversion: -2 and `size` are as far outside as any
  // coordinate (both corners dropped, or both clamped to one edge).
  const int i0 = (int)fminf(fmaxf(c0, -2.0f), (float)size);
  Axis a;
  a.w[0] = 1.0f - t;
  a.w[1] = t;
  if (kRoundWeights) {
    a.w[0] = Pack<T>::round(a.w[0]);
    a.w[1] = Pack<T>::round(a.w[1]);
  }
  if (kBorder) {
    a.i[0] = min(max(i0, 0), size - 1);
    a.i[1] = min(max(i0 + 1, 0), size - 1);
    a.use[0] = true;
    a.use[1] = a.i[1] != a.i[0];
    if (!a.use[1]) a.w[0] = 1.0f;
  } else {
    a.i[0] = i0;
    a.i[1] = i0 + 1;
    a.use[0] = a.i[0] >= 0 && a.i[0] < size;
    a.use[1] = a.i[1] >= 0 && a.i[1] < size;
  }
  return a;
}

// image: (n, c, h, w) of T; px, py: (n, hg, wg) f32; out: (n, c, hg, wg) f32.
// grid = (ceil(wg / 32), ceil(hg / 8), n).
template <typename T, bool kBorder>
__global__ void __launch_bounds__(kTileW * kTileH)
dense_warp_kernel(const T* __restrict__ image, const float* __restrict__ px,
                  const float* __restrict__ py, float* __restrict__ out, int c,
                  int h, int w, int hg, int wg) {
  const int j = blockIdx.x * kTileW + threadIdx.x;
  const int i = blockIdx.y * kTileH + threadIdx.y;
  if (i >= hg || j >= wg) return;
  const long long frame = blockIdx.z;
  const long long grid_px = (long long)hg * wg;
  const long long pix = (long long)i * wg + j;
  const Axis ax = axis_of<T, kBorder, true>(px[frame * grid_px + pix], w);
  const Axis ay = axis_of<T, kBorder, false>(py[frame * grid_px + pix], h);
  const long long plane = (long long)h * w;
  const T* src = image + frame * c * plane;
  float* dst = out + frame * c * grid_px + pix;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (!ay.use[a]) continue;
      const T* row = src + ch * plane + (long long)ay.i[a] * w;
      float line = 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (!ax.use[b]) continue;
        line = line + to_float(row[ax.i[b]]) * ax.w[b];
      }
      acc = acc + line * ay.w[a];
    }
    dst[ch * grid_px] = acc;
  }
}

template <typename T>
int launch(const void* image, const void* px, const void* py, void* out, int n,
           int c, int h, int w, int hg, int wg, int border, cudaStream_t stream) {
  if (n == 0 || c == 0 || hg == 0 || wg == 0) return 0;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((unsigned)((wg + kTileW - 1) / kTileW), (unsigned)((hg + kTileH - 1) / kTileH),
                  (unsigned)n);
  const T* img = static_cast<const T*>(image);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  float* o = static_cast<float*>(out);
  if (border) {
    dense_warp_kernel<T, true><<<grid, block, 0, stream>>>(img, x, y, o, c, h, w, hg, wg);
  } else {
    dense_warp_kernel<T, false><<<grid, block, 0, stream>>>(img, x, y, o, c, h, w, hg, wg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 image, 1 = bfloat16 image. border: 0 = zeros, 1 = border.
// image: (n, c, h, w); px, py: (n, hg, wg) float32 pixel coordinates;
// out: (n, c, hg, wg) float32. n and hg / 8 must fit a grid dimension (65535).
int dense_warp_fwd(const void* image, const void* px, const void* py, void* out,
                   int n, int c, int h, int w, int hg, int wg, int border,
                   int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch<__nv_bfloat16>(image, px, py, out, n, c, h, w, hg, wg, border, s)
             : launch<float>(image, px, py, out, n, c, h, w, hg, wg, border, s);
}

}  // extern "C"

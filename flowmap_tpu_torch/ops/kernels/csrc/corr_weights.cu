// Fused full-resolution correspondence weights (kernel H): x2 bilinear
// upsample, bilinear warp of the earlier frame, static upsample of the later
// frame, the weight MLP, sigmoid and the clip at 1e-4, from native-resolution
// features; forward and backward.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/corr_weights.py
// (corr_weights; forward pallas_call at :468, backward at :944).
//
// Semantics, for pair i (frames i and i + 1), full-resolution pixel (y, x)
// and its sample position (sx, sy) = unnormalize(grid[i, y, x]):
//   U_f = the x2 upsample of frame f (align_corners=False, edge clamp);
//   warped = sum of U_i at the four bilinear corners (qy, qx) of (sx, sy),
//            a corner used only inside the image and with qy - y in
//            [-radius, radius + 1] (outside that window it is dropped, as
//            the warp-features kernel drops it);
//   later  = U_{i+1}[y, x];
//   out    = max(sigmoid(MLP([round_T(warped) | round_T(later)])), 1e-4),
// the MLP of mlp_core.cuh with its first layer already divided by 20 (the
// wrapper folds /20 into W0 in f32 and rounds it to T, as the TPU kernel's
// _pack_mlp does). The grid is frozen optical flow: no gradient.
//
// The TPU kernel builds one-hot interpolation matrices and contracts native
// row windows on the matrix unit, because the TPU has no gather. Here the
// upsample composed with the warp is at most 3 native taps per axis, with
// weights that are arithmetic in the sample position: a thread gathers the
// (at most) 9 native vectors of 16 bytes, sums them in f32 and writes the
// rounded result into the MLP's input tile in shared memory. No
// full-resolution feature map exists in device memory.
//
// Backward: the block recomputes its tile's forward, runs the MLP backward on
// the tensor cores (mlp_core.cuh), and scatters the input cotangents through
// the transposed interpolation with f32 atomicAdd, four channels an atomic,
// into a zeroed (f, hn, wn, 64) f32 buffer: the earlier half into frame i,
// the later half into frame i + 1, so frame f's gradient is the earlier
// branch of pair f plus the later branch of pair f - 1. Columns are
// unbounded, so a gather over native pixels has no small window to walk;
// the order of the atomic adds, and so the last bits of the feature
// gradient, varies from run to run. The parameter gradients are block
// partials summed in a fixed order (reduce_partials).
//
// Bound: operations (~49 kFLOP of MLP a full-resolution pixel against ~260
// bytes of native features per four pixels).

#include <climits>

#include "mlp_core.cuh"

namespace {

using namespace mlp;

__device__ __forceinline__ int floordiv2(int q) { return q >= 0 ? q / 2 : -((1 - q) / 2); }

// Native taps along one axis of a bilinear sample at full-resolution
// coordinate `coord` of the x2-upsampled field: 3 slots from native index
// base, weights in f32 (zero for unused slots). A full-resolution corner q
// is used when 0 <= q < size and, for rows, lo <= q <= hi.
struct Axis {
  int idx[3];
  float wt[3];
};

__device__ __forceinline__ void expand(int q, float wq, int base, float (&wt)[3]) {
  // Full index q samples native position q / 2 - 0.25: even q = 2m blends
  // 0.25 F[m - 1] + 0.75 F[m]; odd q = 2m + 1 blends 0.75 F[m] + 0.25 F[m + 1].
  const int par = q - 2 * floordiv2(q);
  const int slot = floordiv2(q) - 1 + par - base;
  const float t = par ? 0.25f : 0.75f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s == slot) wt[s] += wq * (1.0f - t);
    if (s == slot + 1) wt[s] += wq * t;
  }
}

__device__ __forceinline__ Axis sample_axis(float coord, int size, int native, int lo, int hi) {
  Axis a;
  // Clamped before the conversion: far-off coordinates stay out of range.
  const float c0 = floorf(coord);
  const float t = coord - c0;
  const int q0 = (int)fminf(fmaxf(c0, -4.0f), (float)size + 2.0f);
  const int base = floordiv2(q0) - 1;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    a.wt[s] = 0.0f;
    a.idx[s] = min(max(base + s, 0), native - 1);
  }
  if (q0 >= 0 && q0 < size && q0 >= lo && q0 <= hi) expand(q0, 1.0f - t, base, a.wt);
  const int q1 = q0 + 1;
  if (q1 >= 0 && q1 < size && q1 >= lo && q1 <= hi) expand(q1, t, base, a.wt);
  return a;
}

// The static upsample at full-resolution index q: 2 native taps.
__device__ __forceinline__ void static_axis(int q, int native, int (&idx)[2], float (&wt)[2]) {
  const int par = q & 1;
  const int i0 = q / 2 - 1 + par;
  const float t = par ? 0.25f : 0.75f;
  idx[0] = min(max(i0, 0), native - 1);
  idx[1] = min(max(i0 + 1, 0), native - 1);
  wt[0] = 1.0f - t;
  wt[1] = t;
}

struct Geometry {
  int n, hn, wn, h, w, radius;
  long long total;  // n * h * w output pixels
};

struct PixelTaps {
  Axis ay, ax;        // earlier frame (warp)
  int ly[2], lx[2];   // later frame (static)
  float lwy[2], lwx[2];
  long long frame;    // pair index i
};

__device__ __forceinline__ PixelTaps taps_of(const float* __restrict__ grid, long long pix,
                                             const Geometry& g) {
  PixelTaps t;
  const long long hw = (long long)g.h * g.w;
  t.frame = pix / hw;
  const int rem = (int)(pix - t.frame * hw);
  const int y = rem / g.w, x = rem % g.w;
  const float gx = grid[pix * 2], gy = grid[pix * 2 + 1];
  const float sx = ((gx + 1.0f) * (float)g.w - 1.0f) * 0.5f;
  const float sy = ((gy + 1.0f) * (float)g.h - 1.0f) * 0.5f;
  t.ax = sample_axis(sx, g.w, g.wn, INT_MIN / 2, INT_MAX / 2);
  t.ay = sample_axis(sy, g.h, g.hn, y - g.radius, y + g.radius + 1);
  static_axis(y, g.hn, t.ly, t.lwy);
  static_axis(x, g.wn, t.lx, t.lwx);
  return t;
}

// Fill s.in with the tile's [round_T(warped) | round_T(later)] rows.
template <typename T>
__device__ void load_inputs(const Smem<T>& s, const T* __restrict__ feat,
                            const float* __restrict__ grid, const Geometry& g, long long p0) {
  constexpr int V = 16 / sizeof(T), BM = Smem<T>::BM, LW = Smem<T>::LW;
  constexpr int VPH = kC / V;  // vectors a half row
  for (int e = threadIdx.x; e < BM * 2 * VPH; e += kThreads) {
    const int r = e / (2 * VPH), v = e % (2 * VPH);
    const bool later = v >= VPH;
    const int c = (v % VPH) * V;
    const long long pix = p0 + r;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    if (pix < g.total) {
      const PixelTaps t = taps_of(grid, pix, g);
      const long long fr = t.frame + (later ? 1 : 0);
      const T* base = feat + fr * g.hn * g.wn * kC + c;
      if (!later) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (t.ay.wt[a] == 0.0f) continue;
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (t.ax.wt[b] == 0.0f) continue;
            const float wgt = t.ay.wt[a] * t.ax.wt[b];
            float f[V];
            load_vec(base + ((long long)t.ay.idx[a] * g.wn + t.ax.idx[b]) * kC, f);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += wgt * f[k];
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float wgt = t.lwy[a] * t.lwx[b];
            float f[V];
            load_vec(base + ((long long)t.ly[a] * g.wn + t.lx[b]) * kC, f);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += wgt * f[k];
          }
      }
    }
    T* dst = s.in + r * LW + (later ? kC : 0) + c;
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = fromf<T>(acc[k]);
  }
}

__device__ __forceinline__ float sigmoid(float y) { return 1.0f / (1.0f + expf(-y)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_weights_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ grid,
                        const T* __restrict__ w0, const float* __restrict__ b0,
                        const T* __restrict__ w1, const float* __restrict__ b1,
                        const T* __restrict__ w2, const float* __restrict__ b2,
                        float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = Smem<T>::BM;
  const Smem<T> s = Smem<T>::carve(smem, false);
  stage_params(s, w0, b0, w1, b1, w2);
  const float bias2 = b2[0];
  const long long ntiles = (g.total + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BM;
    __syncthreads();
    load_inputs(s, feat, grid, g, p0);
    __syncthreads();
    forward_tile(s);
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      if (p0 + r < g.total) out[p0 + r] = fmaxf(sigmoid(logit(s, r, bias2)), 1e-4f);
    }
  }
}

// d_feat: (f, hn, wn, 64) f32, zero on entry.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
corr_weights_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ grid,
                        const T* __restrict__ w0, const float* __restrict__ b0,
                        const T* __restrict__ w1, const float* __restrict__ b1,
                        const T* __restrict__ w2, const float* __restrict__ b2,
                        const float* __restrict__ gout, float* __restrict__ d_feat,
                        float* __restrict__ partial, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = Smem<T>::BM, LW = Smem<T>::LW, V = 16 / sizeof(T);
  constexpr int VPH = kC / V;
  const Smem<T> s = Smem<T>::carve(smem, true);
  stage_params(s, w0, b0, w1, b1, w2);
  const float bias2 = b2[0];
  GradAcc acc;
  zero(acc);
  const long long ntiles = (g.total + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BM;
    __syncthreads();
    load_inputs(s, feat, grid, g, p0);
    __syncthreads();
    forward_tile(s);
    // d logit through the clip (passes where sigmoid >= 1e-4) and sigmoid.
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      float d = 0.0f;
      if (p0 + r < g.total) {
        const float sg = sigmoid(logit(s, r, bias2));
        d = sg >= 1e-4f ? gout[p0 + r] * (1.0f - sg) * sg : 0.0f;
      }
      s.dy[r] = d;
    }
    __syncthreads();
    backward_tile(s, acc);
    // s.in is free now: it takes the input cotangents, exact in T.
    backward_input(s, [&](int r, int c, T v) { s.in[r * LW + c] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < BM * 2 * VPH; e += kThreads) {
      const int r = e / (2 * VPH), v = e % (2 * VPH);
      const long long pix = p0 + r;
      if (pix >= g.total) continue;
      const bool later = v >= VPH;
      const int c = (v % VPH) * V;
      float d[V];
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = tof(s.in[r * LW + (later ? kC : 0) + c + k]);
      const PixelTaps t = taps_of(grid, pix, g);
      float* base = d_feat + (t.frame + (later ? 1 : 0)) * g.hn * g.wn * kC + c;
      auto scatter = [&](int iy, int ix, float wgt) {
        float4* dst = reinterpret_cast<float4*>(base + ((long long)iy * g.wn + ix) * kC);
#pragma unroll
        for (int k = 0; k < V; k += 4) {
          atomicAdd(dst + k / 4, make_float4(wgt * d[k], wgt * d[k + 1], wgt * d[k + 2],
                                             wgt * d[k + 3]));
        }
      };
      if (!later) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (t.ay.wt[a] == 0.0f) continue;
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (t.ax.wt[b] == 0.0f) continue;
            scatter(t.ay.idx[a], t.ax.idx[b], t.ay.wt[a] * t.ax.wt[b]);
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) scatter(t.ly[a], t.lx[b], t.lwy[a] * t.lwx[b]);
      }
    }
  }
  write_partial(acc, partial);
}

template <typename T>
int launch(bool backward, const void* feat, const void* grid, const void* w0, const void* b0,
           const void* w1, const void* b1, const void* w2, const void* b2, const void* gout,
           void* out, void* partial, const Geometry& g, int blocks, cudaStream_t stream) {
  const size_t bytes = Smem<T>::bytes(backward);
  const T* f = static_cast<const T*>(feat);
  const float* gr = static_cast<const float*>(grid);
  const T* pw0 = static_cast<const T*>(w0);
  const T* pw1 = static_cast<const T*>(w1);
  const T* pw2 = static_cast<const T*>(w2);
  const float* pb0 = static_cast<const float*>(b0);
  const float* pb1 = static_cast<const float*>(b1);
  const float* pb2 = static_cast<const float*>(b2);
  cudaError_t err;
  if (backward) {
    err = cudaFuncSetAttribute(corr_weights_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    corr_weights_bwd_kernel<T><<<blocks, kThreads, bytes, stream>>>(
        f, gr, pw0, pb0, pw1, pb1, pw2, pb2, static_cast<const float*>(gout),
        static_cast<float*>(out), static_cast<float*>(partial), g);
  } else {
    err = cudaFuncSetAttribute(corr_weights_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    corr_weights_fwd_kernel<T><<<blocks, kThreads, bytes, stream>>>(
        f, gr, pw0, pb0, pw1, pb1, pw2, pb2, static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int corr_weights_tile(int dtype) { return dtype == 1 ? Tile<bf16>::BM : Tile<float>::BM; }

int corr_weights_partial_len() { return kPartial; }

// dtype: 0 = float32, 1 = bfloat16 (features, w0, w1, w2); b0, b1, b2, grid
// and the weights are float32. features: (n + 1, hn, wn, 64); grid:
// (n, 2 hn, 2 wn, 2) in [-1, 1]; out: (n, 2 hn, 2 wn). w0 (128, 128) is the
// first layer already divided by 20.
int corr_weights_fwd(const void* feat, const void* grid, const void* w0, const void* b0,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     void* out, int n, int hn, int wn, int radius, int blocks, int dtype,
                     void* stream) {
  const Geometry g{n, hn, wn, 2 * hn, 2 * wn, radius, (long long)n * 4 * hn * wn};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(false, feat, grid, w0, b0, w1, b1, w2, b2, nullptr, out,
                                   nullptr, g, blocks, s)
                    : launch<float>(false, feat, grid, w0, b0, w1, b1, w2, b2, nullptr, out,
                                    nullptr, g, blocks, s);
}

// gout: (n, 2 hn, 2 wn) float32; d_feat: (n + 1, hn, wn, 64) float32, zero
// on entry; partial: (blocks, corr_weights_partial_len()) float32.
int corr_weights_bwd(const void* feat, const void* grid, const void* w0, const void* b0,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gout, void* d_feat, void* partial, int n, int hn, int wn,
                     int radius, int blocks, int dtype, void* stream) {
  const Geometry g{n, hn, wn, 2 * hn, 2 * wn, radius, (long long)n * 4 * hn * wn};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(true, feat, grid, w0, b0, w1, b1, w2, b2, gout, d_feat,
                                   partial, g, blocks, s)
                    : launch<float>(true, feat, grid, w0, b0, w1, b1, w2, b2, gout, d_feat,
                                    partial, g, blocks, s);
}

int corr_weights_reduce(const void* partial, void* out, int nparts, void* stream) {
  return launch_reduce(partial, out, nparts, (cudaStream_t)stream);
}

}  // extern "C"

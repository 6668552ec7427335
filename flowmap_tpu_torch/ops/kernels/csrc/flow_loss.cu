// Dense flow-reprojection loss (huber mapping), forward and analytic backward.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/flow_loss.py
// (flow_loss_pallas, forward pallas_call at :138, backward at :162).
//
// Per adjacent pair the caller folds K_target @ (E_target^-1 E_source)[:3]
// into one 3x4 matrix M (rows 0-1 carry K; row 2 is the relative transform's
// z row). Per source pixel:
//   (u_, v_, z_) = M [x y z 1],  den = z_ + 1e-5,  q = (u_, v_) / den,
//   u = nan ? 0 : clamp(q, +-1e8),  delta = (u - (xy + flow)) * (sx, sy),
//   loss += huber(|delta|) / d * mask.
// Both directions read the surface of the same source frame, so one block
// walks a pixel tile of ONE frame and evaluates the forward-direction pair
// (frame -> frame + 1) and the backward-direction pair (frame -> frame - 1)
// from a single read of the surface. d_surfaces is written once per pixel
// (no atomics); the loss and the 12 d_M sums per pair are reduced within the
// block in a fixed order and written as per-block partials that the caller
// sums, so results are deterministic.
//
// Bound: bytes. Per pixel the forward reads xyz (12 B) once and, per
// direction, flow (8 B) and mask (4 B); the backward also writes d_xyz (12 B).
// ~40 flops per pixel and direction are far below the card's rate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr float kInf = 1e8f;
constexpr float kNormEps = 1e-24f;
constexpr int kThreads = 256;

struct Term {
  float loss;
  float d_u_, d_v_, d_z_;  // cotangents of the three rows of M [x y z 1]
};

__device__ __forceinline__ float clip_nan(float q) {
  return isnan(q) ? 0.f : fminf(fmaxf(q, -kInf), kInf);
}

// One direction at one pixel. m: 12 floats, row-major 3x4.
template <bool kGrad>
__device__ __forceinline__ Term pixel_term(const float* m, float x, float y,
                                           float z, float gt_u, float gt_v,
                                           float mask, float sx, float sy,
                                           float delta) {
  float u_ = m[0] * x + m[1] * y + m[2] * z + m[3];
  float v_ = m[4] * x + m[5] * y + m[6] * z + m[7];
  float z_ = m[8] * x + m[9] * y + m[10] * z + m[11];
  float den = z_ + kEps;
  float qu = u_ / den;
  float qv = v_ / den;
  float u = clip_nan(qu);
  float v = clip_nan(qv);
  float du = (u - gt_u) * sx;
  float dv = (v - gt_v) * sy;
  float norm = sqrtf(du * du + dv * dv + kNormEps);
  Term t;
  float mapped = norm < delta ? 0.5f * norm * norm : delta * (norm - 0.5f * delta);
  t.loss = mapped / delta * mask;
  if constexpr (kGrad) {
    float dnorm = mask * (norm < delta ? norm : delta) / delta;
    float scale = dnorm / norm;
    float d_u = scale * du * sx;
    float d_v = scale * dv * sy;
    // Pass the gradient where the quotient is finite (the kernel being
    // replaced gates on q - q == 0).
    float d_qu = (qu - qu == 0.f) ? d_u : 0.f;
    float d_qv = (qv - qv == 0.f) ? d_v : 0.f;
    t.d_u_ = d_qu / den;
    t.d_v_ = d_qv / den;
    t.d_z_ = -(qu * d_qu + qv * d_qv) / den;
  } else {
    t.d_u_ = t.d_v_ = t.d_z_ = 0.f;
  }
  return t;
}

// Block-wide sum of kN values per thread, deterministic order. Results are
// valid in thread 0.
template <int kN>
__device__ __forceinline__ void block_sum(float (&v)[kN], float (*scratch)[kN]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kN; ++k) scratch[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < kN; ++k) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += scratch[w][k];
      v[k] = s;
    }
  }
}

struct Args {
  const float* surf;      // (F, H, W, 3)
  const float* m_fwd;     // (F-1, 3, 4)
  const float* m_bwd;     // (F-1, 3, 4)
  const float* flow_fwd;  // (F-1, H, W, 2)
  const float* flow_bwd;  // (F-1, H, W, 2)
  const float* mask_fwd;  // (F-1, H, W)
  const float* mask_bwd;  // (F-1, H, W)
  int F, H, W;
  float sx, sy, delta;
};

template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
flow_loss_kernel(Args a, int pix_per_block, float* partial, const float* g,
                 float* d_surf) {
  // partial: (F, gridDim.x, kN) with kN = 1 (forward) or 24 (backward).
  constexpr int kN = kGrad ? 24 : 1;
  __shared__ float scratch[kThreads / 32][kN];
  __shared__ float m_s[24];
  const int fr = blockIdx.y;
  const int hw = a.H * a.W;
  const bool has_fwd = fr < a.F - 1;  // pair fr, source frame fr
  const bool has_bwd = fr >= 1;       // pair fr - 1, source frame fr
  if (threadIdx.x < 12) {
    m_s[threadIdx.x] = has_fwd ? a.m_fwd[fr * 12 + threadIdx.x] : 0.f;
    m_s[12 + threadIdx.x] = has_bwd ? a.m_bwd[(fr - 1) * 12 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  const float gscale = kGrad ? g[0] : 1.f;

  float acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.f;

  const int p0 = blockIdx.x * pix_per_block;
  const int p1 = min(p0 + pix_per_block, hw);
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const int i = p / a.W;
    const int j = p - i * a.W;
    const float* s = a.surf + ((size_t)fr * hw + p) * 3;
    const float x = s[0], y = s[1], z = s[2];
    const float gx = ((float)j + 0.5f) / (float)a.W;
    const float gy = ((float)i + 0.5f) / (float)a.H;
    float dx = 0.f, dy = 0.f, dz = 0.f;
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      const bool has = dir == 0 ? has_fwd : has_bwd;
      if (!has) continue;
      const int pair = dir == 0 ? fr : fr - 1;
      const float* flow = (dir == 0 ? a.flow_fwd : a.flow_bwd) +
                          ((size_t)pair * hw + p) * 2;
      const float mask = (dir == 0 ? a.mask_fwd : a.mask_bwd)[(size_t)pair * hw + p];
      const float* m = m_s + 12 * dir;
      Term t = pixel_term<kGrad>(m, x, y, z, gx + flow[0], gy + flow[1], mask,
                                 a.sx, a.sy, a.delta);
      if constexpr (!kGrad) {
        acc[0] += t.loss;
      } else {
        dx += m[0] * t.d_u_ + m[4] * t.d_v_ + m[8] * t.d_z_;
        dy += m[1] * t.d_u_ + m[5] * t.d_v_ + m[9] * t.d_z_;
        dz += m[2] * t.d_u_ + m[6] * t.d_v_ + m[10] * t.d_z_;
        const float rows[3] = {t.d_u_, t.d_v_, t.d_z_};
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          acc[12 * dir + 4 * r + 0] += rows[r] * x;
          acc[12 * dir + 4 * r + 1] += rows[r] * y;
          acc[12 * dir + 4 * r + 2] += rows[r] * z;
          acc[12 * dir + 4 * r + 3] += rows[r];
        }
      }
    }
    if constexpr (kGrad) {
      float* ds = d_surf + ((size_t)fr * hw + p) * 3;
      ds[0] = dx * gscale;
      ds[1] = dy * gscale;
      ds[2] = dz * gscale;
    }
  }
  block_sum<kN>(acc, scratch);
  if (threadIdx.x == 0) {
    float* out = partial + ((size_t)fr * gridDim.x + blockIdx.x) * kN;
    for (int k = 0; k < kN; ++k) out[k] = acc[k];
  }
}

Args make_args(const void* surf, const void* m_fwd, const void* m_bwd,
               const void* flow_fwd, const void* flow_bwd, const void* mask_fwd,
               const void* mask_bwd, int F, int H, int W, float sx, float sy,
               float delta) {
  Args a;
  a.surf = static_cast<const float*>(surf);
  a.m_fwd = static_cast<const float*>(m_fwd);
  a.m_bwd = static_cast<const float*>(m_bwd);
  a.flow_fwd = static_cast<const float*>(flow_fwd);
  a.flow_bwd = static_cast<const float*>(flow_bwd);
  a.mask_fwd = static_cast<const float*>(mask_fwd);
  a.mask_bwd = static_cast<const float*>(mask_bwd);
  a.F = F;
  a.H = H;
  a.W = W;
  a.sx = sx;
  a.sy = sy;
  a.delta = delta;
  return a;
}

}  // namespace

extern "C" {

// Number of pixel tiles per frame (the partials' middle dimension).
int flow_loss_num_tiles(int H, int W, int pix_per_block) {
  return (H * W + pix_per_block - 1) / pix_per_block;
}

// partial: (F, tiles) per-block loss sums.
int flow_loss_fwd(const void* surf, const void* m_fwd, const void* m_bwd,
                  const void* flow_fwd, const void* flow_bwd,
                  const void* mask_fwd, const void* mask_bwd, int F, int H,
                  int W, float sx, float sy, float delta, int pix_per_block,
                  void* partial, void* stream) {
  Args a = make_args(surf, m_fwd, m_bwd, flow_fwd, flow_bwd, mask_fwd,
                     mask_bwd, F, H, W, sx, sy, delta);
  dim3 grid(flow_loss_num_tiles(H, W, pix_per_block), F);
  flow_loss_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, pix_per_block, static_cast<float*>(partial), nullptr, nullptr);
  return (int)cudaGetLastError();
}

// partial: (F, tiles, 24): [0:12] d_M of pair `frame` (forward direction),
// [12:24] d_M of pair `frame - 1` (backward direction), before scaling by g.
// d_surf: (F, H, W, 3), already scaled by the upstream gradient g[0].
int flow_loss_bwd(const void* surf, const void* m_fwd, const void* m_bwd,
                  const void* flow_fwd, const void* flow_bwd,
                  const void* mask_fwd, const void* mask_bwd, int F, int H,
                  int W, float sx, float sy, float delta, int pix_per_block,
                  const void* g, void* partial, void* d_surf, void* stream) {
  Args a = make_args(surf, m_fwd, m_bwd, flow_fwd, flow_bwd, mask_fwd,
                     mask_bwd, F, H, W, sx, sy, delta);
  dim3 grid(flow_loss_num_tiles(H, W, pix_per_block), F);
  flow_loss_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, pix_per_block, static_cast<float*>(partial),
      static_cast<const float*>(g), static_cast<float*>(d_surf));
  return (int)cudaGetLastError();
}

}  // extern "C"

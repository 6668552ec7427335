// Packed tracking loss: surface sampling at track points and the all-pairs
// reprojection loss, each with its backward.
//
// Replaces the Pallas TPU kernels of flowmap_tpu/ops/pallas/track_loss.py
// (track_loss_pallas; pallas_calls at :293 sample forward, :323 sample
// backward, :358 pair-loss forward, :395 pair-loss backward).
//
// The TPU kernels sample with one-hot matmuls, sort the (segment, frame)
// pairs by video frame so that output blocks are revisited consecutively, and
// pad every axis to the (8, 128) tiling, because the TPU has neither a gather
// nor atomics. Hopper has both, so here:
//
// * sample forward: one thread per (segment, window slot, point) gathers the
//   four border-clamped bilinear corners of the three surface channels from
//   frame starts[segment] + slot.
// * sample backward: the same thread scatters d_xyz to those four corners with
//   f32 atomicAdd into a zero-initialised d_surface. Several points of one
//   pair and up to nine segments covering one frame can hit one pixel, so the
//   order of those sums, and with it the last bits of d_surface, varies from
//   run to run. Points whose cotangent is exactly zero (invisible, padding)
//   are skipped.
// * pair loss: one block per (segment, source frame, tile of 512 points). The
//   block keeps the l projection matrices M[segment, source, :] in shared
//   memory; a thread owns up to four points and loops over the l targets:
//     (u_, v_, z_) = M [x y z 1],  den = z_ + 1e-5,  q = (u_, v_) / den,
//     u = nan ? 0 : clamp(q, +-1e8),  d = (u - gt) * (sx, sy),
//     norm = sqrt(|d|^2 + 1e-24),  huber(norm) / delta,
//     mask = vis[target] * vis[source] * source_in * target_in(u, v).
//   Forward: per-block (loss, valid) partials, summed by the caller.
//   Backward: the forward recomputed, then the analytic VJP with the
//   q - q == 0 gate. d_xyz sums over targets in the owning thread's registers;
//   the 12 d_M sums per target are reduced over the block's points in a fixed
//   order (warp shuffles, then warps in order) and written as per-tile
//   partials that the caller sums. Both are deterministic.
//
// Bound: bytes for the sampling (xy, the touched texels and xyz; the backward
// also clears and writes d_surface), operations for the pair loss (~60 per
// pair-point forward, ~150 backward, against 16 bytes of xy, vis and xyz per
// point and source frame). Compiled with --fmad=false so that the elementwise
// arithmetic rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr float kInf = 1e8f;
constexpr float kNormEps = 1e-24f;

constexpr int kSampleThreads = 256;
constexpr int kPairThreads = 128;
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kPointsPerThread = 4;
constexpr int kPointsPerBlock = kPairThreads * kPointsPerThread;

// The four border-clamped corners of a bilinear sample (pixel offsets inside
// one frame) and the fractions. Both corners of an axis are clamped, so a
// point outside the frame reads the edge and its corners may coincide.
struct Corners {
  int i00, i01, i10, i11;
  float tx, ty;
};

__device__ __forceinline__ Corners corners_of(float xn, float yn, int h, int w) {
  const float x = xn * (float)w - 0.5f;
  const float y = yn * (float)h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float xmax = (float)(w - 1);
  const float ymax = (float)(h - 1);
  const int x0c = (int)fminf(fmaxf(x0, 0.f), xmax);
  const int x1c = (int)fminf(fmaxf(x0 + 1.f, 0.f), xmax);
  const int y0c = (int)fminf(fmaxf(y0, 0.f), ymax);
  const int y1c = (int)fminf(fmaxf(y0 + 1.f, 0.f), ymax);
  Corners c;
  c.i00 = y0c * w + x0c;
  c.i01 = y0c * w + x1c;
  c.i10 = y1c * w + x0c;
  c.i11 = y1c * w + x1c;
  c.tx = x - x0;
  c.ty = y - y0;
  return c;
}

__device__ __forceinline__ int frame_of(const int* starts, int seg, int slot, int f) {
  return min(max(starts[seg] + slot, 0), f - 1);
}

// xy: (s, l, p, 2); xyz: (s, l, p, 3); surf: (f, h, w, 3).
__global__ void __launch_bounds__(kSampleThreads)
track_sample_fwd_kernel(const float* __restrict__ surf,
                        const float* __restrict__ xy,
                        const int* __restrict__ starts, float* __restrict__ xyz,
                        int f, int h, int w, int l, int p, long long total) {
  const long long idx = (long long)blockIdx.x * kSampleThreads + threadIdx.x;
  if (idx >= total) return;
  const long long pair = idx / p;
  const int slot = (int)(pair % l);
  const int seg = (int)(pair / l);
  const float2 q = reinterpret_cast<const float2*>(xy)[idx];
  const Corners c = corners_of(q.x, q.y, h, w);
  const float* base = surf + (size_t)frame_of(starts, seg, slot, f) * h * w * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = base[c.i00 * 3 + k] * (1.f - c.tx) + base[c.i01 * 3 + k] * c.tx;
    const float bot = base[c.i10 * 3 + k] * (1.f - c.tx) + base[c.i11 * 3 + k] * c.tx;
    xyz[idx * 3 + k] = top * (1.f - c.ty) + bot * c.ty;
  }
}

// d_surf: (f, h, w, 3), zero on entry.
__global__ void __launch_bounds__(kSampleThreads)
track_sample_bwd_kernel(const float* __restrict__ xy,
                        const int* __restrict__ starts,
                        const float* __restrict__ d_xyz,
                        float* __restrict__ d_surf, int f, int h, int w, int l,
                        int p, long long total) {
  const long long idx = (long long)blockIdx.x * kSampleThreads + threadIdx.x;
  if (idx >= total) return;
  const float d[3] = {d_xyz[idx * 3], d_xyz[idx * 3 + 1], d_xyz[idx * 3 + 2]};
  if (d[0] == 0.f && d[1] == 0.f && d[2] == 0.f) return;
  const long long pair = idx / p;
  const int slot = (int)(pair % l);
  const int seg = (int)(pair / l);
  const float2 q = reinterpret_cast<const float2*>(xy)[idx];
  const Corners c = corners_of(q.x, q.y, h, w);
  float* base = d_surf + (size_t)frame_of(starts, seg, slot, f) * h * w * 3;
  const float w00 = (1.f - c.ty) * (1.f - c.tx);
  const float w01 = (1.f - c.ty) * c.tx;
  const float w10 = c.ty * (1.f - c.tx);
  const float w11 = c.ty * c.tx;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    atomicAdd(base + c.i00 * 3 + k, w00 * d[k]);
    atomicAdd(base + c.i01 * 3 + k, w01 * d[k]);
    atomicAdd(base + c.i10 * 3 + k, w10 * d[k]);
    atomicAdd(base + c.i11 * 3 + k, w11 * d[k]);
  }
}

__device__ __forceinline__ float clip_nan(float q) {
  return isnan(q) ? 0.f : fminf(fmaxf(q, -kInf), kInf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct PairArgs {
  const float* xyz;    // (s, l, p, 3) sampled source points
  const float* m;      // (s, l, l, 12) M[seg, source, target], row-major 3x4
  const float* xy;     // (s, l, p, 2) tracked locations (the target's is the GT)
  const uint8_t* vis;  // (s, l, p)
  int l, p;
  float sx, sy, delta;
};

// Shared memory: l * 12 floats of M, then the reduction scratch:
// kPairWarps * 2 floats forward, kPairWarps * l * 12 backward.
// Forward: out is (s, l, tiles, 2). Backward: out is (s, l, tiles, l, 12),
// d_xyz is (s, l, p, 3); both already scaled by the upstream gradient g[0].
template <bool kGrad>
__global__ void __launch_bounds__(kPairThreads)
track_pair_kernel(PairArgs a, const float* __restrict__ g,
                  float* __restrict__ out, float* __restrict__ d_xyz) {
  extern __shared__ float smem[];
  float* m_s = smem;
  float* red = smem + a.l * 12;
  const int l = a.l, p = a.p;
  const int tile = blockIdx.x, src = blockIdx.y, seg = blockIdx.z;
  const int tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t src_row = (size_t)seg * l + src;

  const float* m_src = a.m + src_row * l * 12;
  for (int i = threadIdx.x; i < l * 12; i += kPairThreads) m_s[i] = m_src[i];
  __syncthreads();

  float x[kPointsPerThread], y[kPointsPerThread], z[kPointsPerThread];
  float src_mask[kPointsPerThread];
  float dx[kPointsPerThread], dy[kPointsPerThread], dz[kPointsPerThread];
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const int pt = tile * kPointsPerBlock + k * kPairThreads + threadIdx.x;
    x[k] = y[k] = z[k] = src_mask[k] = 0.f;
    dx[k] = dy[k] = dz[k] = 0.f;
    if (pt < p) {
      const size_t at = src_row * p + pt;
      x[k] = a.xyz[at * 3];
      y[k] = a.xyz[at * 3 + 1];
      z[k] = a.xyz[at * 3 + 2];
      const float2 q = reinterpret_cast<const float2*>(a.xy)[at];
      const bool inside = q.x >= 0.f && q.x < 1.f && q.y >= 0.f && q.y < 1.f;
      src_mask[k] = (a.vis[at] != 0 && inside) ? 1.f : 0.f;
    }
  }

  float loss = 0.f, valid = 0.f;
  for (int tgt = 0; tgt < l; ++tgt) {
    const float* m = m_s + tgt * 12;
    const size_t tgt_row = (size_t)seg * l + tgt;
    float acc[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      const int pt = tile * kPointsPerBlock + k * kPairThreads + threadIdx.x;
      if (pt >= p) continue;
      const float2 gt = reinterpret_cast<const float2*>(a.xy)[tgt_row * p + pt];
      const float v_tgt = a.vis[tgt_row * p + pt] != 0 ? 1.f : 0.f;
      const float u_ = m[0] * x[k] + m[1] * y[k] + m[2] * z[k] + m[3];
      const float v_ = m[4] * x[k] + m[5] * y[k] + m[6] * z[k] + m[7];
      const float z_ = m[8] * x[k] + m[9] * y[k] + m[10] * z[k] + m[11];
      const float den = z_ + kEps;
      const float qu = u_ / den;
      const float qv = v_ / den;
      const float u = clip_nan(qu);
      const float v = clip_nan(qv);
      const float du = (u - gt.x) * a.sx;
      const float dv = (v - gt.y) * a.sy;
      const float norm = sqrtf(du * du + dv * dv + kNormEps);
      const bool target_in = u >= 0.f && u < 1.f && v >= 0.f && v < 1.f;
      const float mask = v_tgt * src_mask[k] * (target_in ? 1.f : 0.f);
      if constexpr (!kGrad) {
        const float mapped =
            (norm < a.delta ? 0.5f * norm * norm : a.delta * (norm - 0.5f * a.delta)) /
            a.delta;
        loss += mapped * mask;
        valid += mask;
      } else {
        const float dnorm = mask * (norm < a.delta ? norm : a.delta) / a.delta;
        const float scale = dnorm / norm;
        const float d_u = scale * du * a.sx;
        const float d_v = scale * dv * a.sy;
        // nan_to_num passes the gradient only where the quotient is finite.
        const float d_qu = (qu - qu == 0.f) ? d_u : 0.f;
        const float d_qv = (qv - qv == 0.f) ? d_v : 0.f;
        const float rows[3] = {d_qu / den, d_qv / den, -(qu * d_qu + qv * d_qv) / den};
        dx[k] += m[0] * rows[0] + m[4] * rows[1] + m[8] * rows[2];
        dy[k] += m[1] * rows[0] + m[5] * rows[1] + m[9] * rows[2];
        dz[k] += m[2] * rows[0] + m[6] * rows[1] + m[10] * rows[2];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          acc[4 * r + 0] += rows[r] * x[k];
          acc[4 * r + 1] += rows[r] * y[k];
          acc[4 * r + 2] += rows[r] * z[k];
          acc[4 * r + 3] += rows[r];
        }
      }
    }
    if constexpr (kGrad) {
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) red[((size_t)warp * l + tgt) * 12 + i] = s;
      }
    }
  }

  if constexpr (!kGrad) {
    loss = warp_sum(loss);
    valid = warp_sum(valid);
    if (lane == 0) {
      red[warp * 2] = loss;
      red[warp * 2 + 1] = valid;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      float s = 0.f;
      for (int wi = 0; wi < kPairWarps; ++wi) s += red[wi * 2 + threadIdx.x];
      out[(src_row * tiles + tile) * 2 + threadIdx.x] = s;
    }
  } else {
    const float gscale = g[0];
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      const int pt = tile * kPointsPerBlock + k * kPairThreads + threadIdx.x;
      if (pt >= p) continue;
      float* d = d_xyz + (src_row * p + pt) * 3;
      d[0] = dx[k] * gscale;
      d[1] = dy[k] * gscale;
      d[2] = dz[k] * gscale;
    }
    __syncthreads();
    float* dm = out + (src_row * tiles + tile) * l * 12;
    for (int i = threadIdx.x; i < l * 12; i += kPairThreads) {
      float s = 0.f;
      for (int wi = 0; wi < kPairWarps; ++wi) s += red[(size_t)wi * l * 12 + i];
      dm[i] = s * gscale;
    }
  }
}

PairArgs pair_args(const void* xyz, const void* m, const void* xy,
                   const void* vis, int l, int p, float sx, float sy,
                   float delta) {
  PairArgs a;
  a.xyz = static_cast<const float*>(xyz);
  a.m = static_cast<const float*>(m);
  a.xy = static_cast<const float*>(xy);
  a.vis = static_cast<const uint8_t*>(vis);
  a.l = l;
  a.p = p;
  a.sx = sx;
  a.sy = sy;
  a.delta = delta;
  return a;
}

unsigned sample_blocks(long long total) {
  return (unsigned)((total + kSampleThreads - 1) / kSampleThreads);
}

}  // namespace

extern "C" {

// Points per block of the pair-loss kernels: the partials' tile count is
// ceil(p / this).
int track_loss_points_per_block() { return kPointsPerBlock; }

// Dynamic shared memory of the pair-loss kernels for a window of l frames.
int track_loss_pair_smem_bytes(int l, int backward) {
  return (int)sizeof(float) * (l * 12 + (backward ? kPairWarps * l * 12 : kPairWarps * 2));
}

int track_sample_fwd(const void* surf, const void* xy, const void* starts,
                     void* xyz, int f, int h, int w, int s, int l, int p,
                     void* stream) {
  const long long total = (long long)s * l * p;
  if (total == 0) return 0;
  track_sample_fwd_kernel<<<sample_blocks(total), kSampleThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(surf), static_cast<const float*>(xy),
      static_cast<const int*>(starts), static_cast<float*>(xyz), f, h, w, l, p, total);
  return (int)cudaGetLastError();
}

int track_sample_bwd(const void* xy, const void* starts, const void* d_xyz,
                     void* d_surf, int f, int h, int w, int s, int l, int p,
                     void* stream) {
  const long long total = (long long)s * l * p;
  if (total == 0) return 0;
  track_sample_bwd_kernel<<<sample_blocks(total), kSampleThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(xy), static_cast<const int*>(starts),
      static_cast<const float*>(d_xyz), static_cast<float*>(d_surf), f, h, w, l, p, total);
  return (int)cudaGetLastError();
}

// partial: (s, l, tiles, 2) per-block (loss, valid) sums.
int track_pair_fwd(const void* xyz, const void* m, const void* xy,
                   const void* vis, int s, int l, int p, float sx, float sy,
                   float delta, void* partial, void* stream) {
  if (s == 0 || l == 0 || p == 0) return 0;
  const dim3 grid((p + kPointsPerBlock - 1) / kPointsPerBlock, l, s);
  track_pair_kernel<false><<<grid, kPairThreads, track_loss_pair_smem_bytes(l, 0),
                             (cudaStream_t)stream>>>(
      pair_args(xyz, m, xy, vis, l, p, sx, sy, delta), nullptr,
      static_cast<float*>(partial), nullptr);
  return (int)cudaGetLastError();
}

// g: the upstream gradient of the loss sum (one float on the device).
// dm_partial: (s, l, tiles, l, 12); d_xyz: (s, l, p, 3).
int track_pair_bwd(const void* xyz, const void* m, const void* xy,
                   const void* vis, int s, int l, int p, float sx, float sy,
                   float delta, const void* g, void* dm_partial, void* d_xyz,
                   void* stream) {
  if (s == 0 || l == 0 || p == 0) return 0;
  const dim3 grid((p + kPointsPerBlock - 1) / kPointsPerBlock, l, s);
  track_pair_kernel<true><<<grid, kPairThreads, track_loss_pair_smem_bytes(l, 1),
                            (cudaStream_t)stream>>>(
      pair_args(xyz, m, xy, vis, l, p, sx, sy, delta),
      static_cast<const float*>(g), static_cast<float*>(dm_partial),
      static_cast<float*>(d_xyz));
  return (int)cudaGetLastError();
}

}  // extern "C"

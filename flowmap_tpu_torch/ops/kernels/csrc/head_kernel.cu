// MiDaS head interior: conv1 (3x3, 64->32) then the parity-phase conv
// (3x3, 32->4*32) with relu and the per-phase 1x1 projection, and the
// backward to the features and every weight.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/head_kernel.py
// (head_interior; forward pallas_call at :245, backward at :278 and :295).
//
//   z  = conv1(x) + b1                       (SAME zero padding)
//   ph = conv_kp(z)                          (SAME zero padding of z)
//   y4[j] = sum_o relu(ph[32j + o] + b2[o]) * w3[o] + b3,   j = 2p + q
//
// Border rows/columns of y4 are not valid (conv_kp sees zero padding where
// the real head sees the upsample's edge clamp); the caller splices exact
// strips over them, so their cotangents arrive as zeros.
//
// Two sets of kernels, all f32 accumulation, no atomics. The f32 set below
// runs on the CUDA cores (the compute_dtype="float32" configuration); the
// bf16 set further down (the main path) runs every product on the tensor
// cores with mma.sync. Each set has:
// - conv3x3: direct 3x3 SAME convolution, one thread per output pixel of a
//   16x16 tile, 32 output channels per pass held in registers; the input
//   halo tile is staged in shared memory 16 channels at a time and the
//   weights ([tap][cin][cout], cout fastest) are read as warp-uniform
//   float4 loads. Serves conv1 forward and, with flipped transposed
//   weights, both transposed convolutions of the backward.
// - head_tail: the phase conv + relu + projection for a 16x16 tile with z's
//   halo in shared memory, so the 128-channel phase tensor never reaches
//   device memory in the forward. Its backward variant recomputes the
//   phases, writes d_phases and per-block partials of dw3 / db3.
// - wgrad: weight gradients as a GEMM per tap, dW_tap = A . shift(B)^T over
//   all pixels, register-tiled; each block reduces one pixel chunk and
//   writes a partial that the caller sums (second pass), plus the bias
//   partial (row sums of A) in the centre-tap blocks.
// Bound: operations (~149 GFLOP forward at the main path's shape; the bytes
// are ~194 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;          // output tile edge (pixels)
constexpr int kHalo = kTile + 2;   // with the 3x3 halo
constexpr int kThreads = kTile * kTile;
constexpr int kOcb = 32;           // output channels per register pass
constexpr int kIcb = 16;           // input channels per shared-memory stage

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 32 consecutive f32 weights as 8 warp-uniform float4 loads, FMA'd with v.
__device__ __forceinline__ void fma32(float (&acc)[kOcb], const float* wrow, float v) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int q = 0; q < kOcb / 4; ++q) {
    const float4 wv = __ldg(w4 + q);
    acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
  }
}

// Stage channels [c0, c0 + nc) of the halo tile of `in` (one frame) into
// s[nc][kHalo][kHalo], zero outside the image.
template <typename T>
__device__ __forceinline__ void stage_halo(float* s, const T* in, int c0, int nc,
                                           int h, int w, int y0, int x0) {
  const int count = nc * kHalo * kHalo;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int ci = e / (kHalo * kHalo);
    const int r = (e / kHalo) % kHalo;
    const int col = e % kHalo;
    const int y = y0 + r - 1;
    const int x = x0 + col - 1;
    float v = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < w)
      v = ld(in + ((size_t)(c0 + ci) * h + y) * w + x);
    s[e] = v;
  }
}

// out[n, o] = sum_{i, a, b} W[a][b][i][o] * in[n, i, y + a - 1, x + b - 1] (+ bias[o])
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const Tin* __restrict__ in, const float* __restrict__ wts,
               const float* __restrict__ bias, Tout* __restrict__ out, int cin,
               int cout, int h, int w) {
  __shared__ float s[kIcb * kHalo * kHalo];
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int frame = blockIdx.z;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const Tin* in_f = in + (size_t)frame * cin * h * w;
  for (int og = 0; og < cout; og += kOcb) {
    float acc[kOcb];
#pragma unroll
    for (int o = 0; o < kOcb; ++o) acc[o] = bias ? bias[og + o] : 0.f;
    for (int c0 = 0; c0 < cin; c0 += kIcb) {
      __syncthreads();
      stage_halo(s, in_f, c0, kIcb, h, w, y0, x0);
      __syncthreads();
      for (int ci = 0; ci < kIcb; ++ci) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const float v = s[(ci * kHalo + ty + a) * kHalo + tx + b];
            fma32(acc, wts + ((size_t)(a * 3 + b) * cin + c0 + ci) * cout + og, v);
          }
        }
      }
    }
    if (x < w && y < h) {
      Tout* o_ptr = out + ((size_t)frame * cout + og) * h * w + (size_t)y * w + x;
#pragma unroll
      for (int o = 0; o < kOcb; ++o) st(o_ptr + (size_t)o * h * w, acc[o]);
    }
  }
}

// The four phases of one pixel: acc = conv_kp(z) for phase j, 32 channels.
__device__ __forceinline__ void phase_conv(float (&acc)[kOcb], const float* zs,
                                           const float* __restrict__ kp, int j,
                                           int tx, int ty) {
#pragma unroll
  for (int o = 0; o < kOcb; ++o) acc[o] = 0.f;
  for (int ci = 0; ci < 32; ++ci) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float v = zs[(ci * kHalo + ty + a) * kHalo + tx + b];
        fma32(acc, kp + ((size_t)(a * 3 + b) * 32 + ci) * 128 + 32 * j, v);
      }
    }
  }
}

template <typename Tz, bool kGrad>
__global__ void __launch_bounds__(kThreads)
head_tail_kernel(const Tz* __restrict__ z, const float* __restrict__ kp,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, const float* __restrict__ g,
                 float* __restrict__ y4, float* __restrict__ dph,
                 float* __restrict__ partial, int h, int w) {
  __shared__ float zs[32 * kHalo * kHalo];
  __shared__ float red[kThreads / 32][33];
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int frame = blockIdx.z;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = x < w && y < h;
  const size_t hw = (size_t)h * w;
  stage_halo(zs, z + (size_t)frame * 32 * hw, 0, 32, h, w, y0, x0);
  __syncthreads();

  float dw3[32];
  float db3 = 0.f;
#pragma unroll
  for (int o = 0; o < 32; ++o) dw3[o] = 0.f;
  const float bias3 = b3[0];
  for (int j = 0; j < 4; ++j) {
    float acc[kOcb];
    phase_conv(acc, zs, kp, j, tx, ty);
    if constexpr (!kGrad) {
      float yv = bias3;
#pragma unroll
      for (int o = 0; o < kOcb; ++o) yv += fmaxf(acc[o] + b2[o], 0.f) * w3[o];
      if (inside) y4[((size_t)frame * 4 + j) * hw + (size_t)y * w + x] = yv;
    } else {
      if (inside) {
        const float gj = g[((size_t)frame * 4 + j) * hw + (size_t)y * w + x];
        db3 += gj;
        float* d_ptr = dph + ((size_t)frame * 128 + 32 * j) * hw + (size_t)y * w + x;
#pragma unroll
        for (int o = 0; o < kOcb; ++o) {
          const float t = fmaxf(acc[o] + b2[o], 0.f);
          dw3[o] += gj * t;
          d_ptr[(size_t)o * hw] = t > 0.f ? gj * w3[o] : 0.f;
        }
      }
    }
  }
  if constexpr (!kGrad) return;

  // Deterministic block reduction of dw3 (32) and db3 (1).
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float vals[33];
#pragma unroll
  for (int o = 0; o < 32; ++o) vals[o] = dw3[o];
  vals[32] = db3;
#pragma unroll
  for (int k = 0; k < 33; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      vals[k] += __shfl_down_sync(0xffffffffu, vals[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 33; ++k) red[warp][k] = vals[k];
  }
  __syncthreads();
  if (threadIdx.x < 33) {
    float s = 0.f;
    for (int wi = 0; wi < kThreads / 32; ++wi) s += red[wi][threadIdx.x];
    const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[(size_t)block * 33 + threadIdx.x] = s;
  }
}

// Weight-gradient GEMM per tap over a chunk of pixels:
//   pw[chunk][tap][ca][cb] = sum_p A[p, ca] * B[shift_tap(p), cb]
//   pb[chunk][ca]          = sum_p A[p, ca]   (centre-tap blocks)
constexpr int kKt = 32;  // pixels per shared-memory stage

template <typename Tb, int CA, int CB, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ A, const Tb* __restrict__ B, int n,
             int h, int w, int chunk, float* __restrict__ pw,
             float* __restrict__ pb) {
  static_assert((CA / TM) * (CB / TN) == kThreads, "thread tile");
  // +1 padding: the staging stores walk k fastest.
  __shared__ float as[kKt][CA + 1];
  __shared__ float bs[kKt][CB + 1];
  const int tap = blockIdx.y;
  const int da = tap / 3 - 1;
  const int db = tap % 3 - 1;
  const int tcol = threadIdx.x % (CB / TN);
  const int trow = threadIdx.x / (CB / TN);
  const size_t hw = (size_t)h * w;
  const long long total = (long long)n * hw;
  const long long p_begin = (long long)blockIdx.x * chunk;
  const long long p_end = min(p_begin + chunk, total);
  const bool do_bias = tap == 4 && tcol == 0;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;
  float bacc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) bacc[m] = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += kKt) {
    __syncthreads();
    for (int e = threadIdx.x; e < CA * kKt; e += kThreads) {
      const int k = e % kKt;
      const int ca = e / kKt;
      const long long p = p0 + k;
      float v = 0.f;
      if (p < p_end) {
        const long long fr = p / hw;
        const size_t yx = (size_t)(p - fr * hw);
        v = A[((size_t)fr * CA + ca) * hw + yx];
      }
      as[k][ca] = v;
    }
    for (int e = threadIdx.x; e < CB * kKt; e += kThreads) {
      const int k = e % kKt;
      const int cb = e / kKt;
      const long long p = p0 + k;
      float v = 0.f;
      if (p < p_end) {
        const long long fr = p / hw;
        const int yx = (int)(p - fr * hw);
        const int y = yx / w + da;
        const int x = yx % w + db;
        if (y >= 0 && y < h && x >= 0 && x < w)
          v = ld(B + ((size_t)fr * CB + cb) * hw + (size_t)y * w + x);
      }
      bs[k][cb] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKt; ++k) {
      float af[TM], bf[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) af[m] = as[k][trow * TM + m];
#pragma unroll
      for (int q = 0; q < TN; ++q) bf[q] = bs[k][tcol * TN + q];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        if (do_bias) bacc[m] += af[m];
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(af[m], bf[q], acc[m][q]);
      }
    }
  }
  float* out = pw + ((size_t)blockIdx.x * 9 + tap) * CA * CB;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q)
      out[(size_t)(trow * TM + m) * CB + tcol * TN + q] = acc[m][q];
  if (do_bias) {
#pragma unroll
    for (int m = 0; m < TM; ++m) pb[(size_t)blockIdx.x * CA + trow * TM + m] = bacc[m];
  }
}

dim3 tile_grid(int n, int h, int w) {
  return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
}

template <typename Tin, typename Tout>
void launch_conv(const void* in, const void* wts, const void* bias, void* out,
                 int n, int cin, int cout, int h, int w, cudaStream_t s) {
  conv3x3_kernel<Tin, Tout><<<tile_grid(n, h, w), kThreads, 0, s>>>(
      static_cast<const Tin*>(in), static_cast<const float*>(wts),
      static_cast<const float*>(bias), static_cast<Tout*>(out), cin, cout, h, w);
}

template <typename Tz, bool kGrad>
void launch_tail(const void* z, const void* kp, const void* b2, const void* w3,
                 const void* b3, const void* g, void* y4, void* dph,
                 void* partial, int n, int h, int w, cudaStream_t s) {
  head_tail_kernel<Tz, kGrad><<<tile_grid(n, h, w), kThreads, 0, s>>>(
      static_cast<const Tz*>(z), static_cast<const float*>(kp),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(g),
      static_cast<float*>(y4), static_cast<float*>(dph),
      static_cast<float*>(partial), h, w);
}

template <typename Tb, int CA, int CB, int TM, int TN>
void launch_wgrad(const void* a, const void* b, int n, int h, int w,
                  int chunks, int chunk, void* pw, void* pb, cudaStream_t s) {
  wgrad_kernel<Tb, CA, CB, TM, TN><<<dim3(chunks, 9), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const Tb*>(b), n, h, w, chunk,
      static_cast<float*>(pw), static_cast<float*>(pb));
}


// ---------------------------------------------------------------------------
// bf16 path on the tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate).
// Same three roles as above. Intermediates (z, d_phases, dz) are bf16, as the
// TPU kernel keeps them in its compute dtype.
// Fragment layout (PTX ISA, m16n8k16 .bf16): lane = 4 * gid + tig;
//   A (16x16, row-major): a[0] (gid, 2tig..+1), a[1] (gid+8, 2tig..),
//                         a[2] (gid, 2tig+8..), a[3] (gid+8, 2tig+8..)
//   B (16x8, k-major):    b[0] (k = 2tig..+1, n = gid), b[1] (k = 2tig+8.., n = gid)
//   C (16x8, f32):        c[0..1] (gid, 2tig..+1), c[2..3] (gid+8, 2tig..+1)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage [rows][CIN] bf16 weights (global, contiguous) into shared memory rows
// of stride CS, 16 bytes at a time.
template <int CIN, int CS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows) {
  constexpr int VPR = CIN / 8;
  for (int e = threadIdx.x; e < rows * VPR; e += kThreads) {
    const int row = e / VPR, v = e % VPR;
    *reinterpret_cast<uint4*>(dst + row * CS + v * 8) =
        reinterpret_cast<const uint4*>(src + (size_t)row * CIN)[v];
  }
}

// Stage the (HH x HW) halo tile of all CIN channels of one NCHW frame into
// dst[pixel][CS] (channels fastest), zero outside the image.
template <int CIN, int CS, int HH, int HW>
__device__ __forceinline__ void stage_pixels(bf16* dst, const bf16* in, int h, int w,
                                             int y0, int x0) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < CIN * HH * HW; e += kThreads) {
    const int ch = e / (HH * HW), pix = e % (HH * HW);
    const int y = y0 + pix / HW - 1, x = x0 + pix % HW - 1;
    bf16 v = zero;
    if (y >= 0 && y < h && x >= 0 && x < w) v = in[((size_t)ch * h + y) * w + x];
    dst[pix * CS + ch] = v;
  }
}

// One 16-pixel row segment x K=16 channels of tap (dy, dx) as an A fragment.
template <int CS, int HW>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s_in, int row,
                                       int dx, int kc, int gid, int tig) {
  const bf16* p0 = s_in + (row * HW + gid + dx) * CS + kc + 2 * tig;
  const bf16* p1 = p0 + 8 * CS;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// out[n, o, y, x] = sum_{tap, i} W[tap][o][i] * in[n, i, y + dy - 1, x + dx - 1] (+ bias)
// 16x16 output pixels per block; warp w computes rows 2w, 2w+1, all COUT.
template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wts,
                   const float* __restrict__ bias, bf16* __restrict__ out, int h, int w) {
  constexpr int CS = CIN + 8, HH = kTile + 2, HW = kTile + 2, NT = COUT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_in + HH * HW * CS;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile, frame = blockIdx.z;
  stage_rows<CIN, CS>(s_w, wts, 9 * COUT);
  stage_pixels<CIN, CS, HH, HW>(s_in, in + (size_t)frame * CIN * h * w, h, w, y0, x0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < CIN; kc += 16) {
      uint32_t a[2][4];
      load_a<CS, HW>(a[0], s_in, 2 * warp + dy, dx, kc, gid, tig);
      load_a<CS, HW>(a[1], s_in, 2 * warp + 1 + dy, dx, kc, gid, tig);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const bf16* wp = s_w + (tap * COUT + t * 8 + gid) * CS + kc + 2 * tig;
        const uint32_t b0 = ld32(wp), b1 = ld32(wp + 8);
        mma16816(acc[0][t], a[0], b0, b1);
        mma16816(acc[1][t], a[1], b0, b1);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = y0 + 2 * warp + m;
    if (y >= h) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = x0 + gid + 8 * half;
        if (x >= w) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = t * 8 + 2 * tig + e;
          const float v = acc[m][t][2 * half + e] + (bias ? bias[c] : 0.f);
          out[(((size_t)frame * COUT + c) * h + y) * w + x] = __float2bfloat16(v);
        }
      }
    }
  }
}

// Phase conv (32 -> 128 on the tensor cores), relu, projection; 8x16 pixels
// per block, warp w computes row w. The backward variant writes d_phases
// (bf16) and per-block [dw3 (32), db3] partials.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
head_tail_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ kp,
                     const float* __restrict__ b2, const float* __restrict__ w3,
                     const float* __restrict__ b3, const float* __restrict__ g,
                     float* __restrict__ y4, bf16* __restrict__ dph,
                     float* __restrict__ partial, int h, int w) {
  constexpr int TH = 8, CIN = 32, CS = CIN + 8, HH = TH + 2, HW = kTile + 2, NT = 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_in + HH * HW * CS;
  __shared__ float red[kThreads / 32][33];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * TH, frame = blockIdx.z;
  const size_t hw = (size_t)h * w;
  stage_rows<CIN, CS>(s_w, kp, 9 * 128);
  stage_pixels<CIN, CS, HH, HW>(s_in, z + (size_t)frame * CIN * hw, h, w, y0, x0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < CIN; kc += 16) {
      uint32_t a[4];
      load_a<CS, HW>(a, s_in, warp + dy, dx, kc, gid, tig);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const bf16* wp = s_w + (tap * 128 + t * 8 + gid) * CS + kc + 2 * tig;
        mma16816(acc[t], a, ld32(wp), ld32(wp + 8));
      }
    }
  }

  const int y = y0 + warp;
  const int xs[2] = {x0 + gid, x0 + gid + 8};
  const bool ok[2] = {y < h && xs[0] < w, y < h && xs[1] < w};
  if constexpr (!kGrad) {
    const float bias3 = b3[0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = q * 8 + 2 * tig + e;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            s[half] += fmaxf(acc[4 * j + q][2 * half + e] + b2[c], 0.f) * w3[c];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
        if (tig == 0 && ok[half])
          y4[(((size_t)frame * 4 + j) * h + y) * w + xs[half]] = s[half] + bias3;
      }
    }
  } else {
    float dw3[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) dw3[k] = 0.f;
    float db3 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float gj[2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        gj[half] = ok[half] ? g[(((size_t)frame * 4 + j) * h + y) * w + xs[half]] : 0.f;
      if (tig == 0) db3 += gj[0] + gj[1];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = q * 8 + 2 * tig + e;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float t = fmaxf(acc[4 * j + q][2 * half + e] + b2[c], 0.f);
            dw3[2 * q + e] += gj[half] * t;
            if (ok[half])
              dph[(((size_t)frame * 128 + 32 * j + c) * h + y) * w + xs[half]] =
                  __float2bfloat16(t > 0.f ? gj[half] * w3[c] : 0.f);
          }
        }
    }
    // Deterministic reduction: over the 8 lanes sharing tig, then warps.
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        dw3[k] += __shfl_xor_sync(0xffffffffu, dw3[k], off);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) db3 += __shfl_xor_sync(0xffffffffu, db3, off);
    if (gid == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) red[warp][q * 8 + 2 * tig + e] = dw3[2 * q + e];
    }
    if (lane == 0) red[warp][32] = db3;
    __syncthreads();
    if (threadIdx.x < 33) {
      float s = 0.f;
      for (int wi = 0; wi < kThreads / 32; ++wi) s += red[wi][threadIdx.x];
      const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      partial[(size_t)block * 33 + threadIdx.x] = s;
    }
  }
}

// Weight-gradient GEMMs on the tensor cores (M = CA, N = CB, K = pixels):
//   dW[tap] = sum_p A[p] B[p + (da, db)]^T.
// A block takes the three taps of one row offset da and a range of `segs`
// 16-pixel row segments, two per shared-memory stage. A is staged once
// (16-byte loads where rows allow) and B three times, shifted by db = -1,
// 0, +1, so every fragment load is an aligned 32-bit word. Index math is per
// segment, not per element. Per-chunk partials as wgrad_kernel.
template <int CA, int CB>
__global__ void __launch_bounds__(kThreads)
wgrad_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int n, int h,
                 int w, int segs, float* __restrict__ pw, float* __restrict__ pb) {
  constexpr int KS = kKt + 8, NTT = CB / 8, TILES = (CA / 16) * NTT / (kThreads / 32);
  static_assert(TILES >= 1 && kKt == 32, "tiles per warp; two segments per stage");
  __shared__ __align__(16) bf16 as[CA][KS];
  __shared__ __align__(16) bf16 bs[3][CB][KS];
  const int da = (int)blockIdx.y - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t hw = (size_t)h * w;
  const int spr = (w + 15) / 16;  // segments per row
  const int s_begin = blockIdx.x * segs;
  const int s_end = min(s_begin + segs, n * h * spr);
  const bool do_bias = da == 0 && threadIdx.x < CA;
  const bool vec_rows = w % 8 == 0;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[3][TILES][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;
  float bacc = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += 2) {
    // Frame (-1: none), row and first column of the stage's two segments.
    int fr[2], yy[2], xs[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sj = s0 + j;
      const int r = sj % (h * spr);
      fr[j] = sj < s_end ? sj / (h * spr) : -1;
      yy[j] = r / spr;
      xs[j] = (r % spr) * 16;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < CA * 4; e += kThreads) {
      // One half segment (8 pixels) of one channel.
      const int ca = e >> 2, j = (e >> 1) & 1, q = e & 1;
      const int x = xs[j] + 8 * q;
      bf16* dst = &as[ca][16 * j + 8 * q];
      const bf16* src = A + ((size_t)fr[j] * CA + ca) * hw + (size_t)yy[j] * w + x;
      if (fr[j] >= 0 && vec_rows && x + 8 <= w) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = (fr[j] >= 0 && x + k < w) ? src[k] : zero;
      }
    }
    for (int e = threadIdx.x; e < CB * kKt; e += kThreads) {
      const int k = e & (kKt - 1), cb = e / kKt, j = k >> 4;
      const int x0 = xs[j] + (k & 15), y = yy[j] + da;
      const bool row_ok = fr[j] >= 0 && x0 < w && y >= 0 && y < h;
      const bf16* src = B + ((size_t)fr[j] * CB + cb) * hw + (size_t)y * w + x0;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int x = x0 + t - 1;
        bs[t][cb][k] = (row_ok && x >= 0 && x < w) ? src[t - 1] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKt; ks += 16) {
#pragma unroll
      for (int i = 0; i < TILES; ++i) {
        const int tile = warp * TILES + i, mt = tile / NTT, nt = tile % NTT;
        uint32_t a[4];
        const bf16* ap = &as[mt * 16 + gid][ks + 2 * tig];
        a[0] = ld32(ap);
        a[1] = ld32(ap + 8 * KS);
        a[2] = ld32(ap + 8);
        a[3] = ld32(ap + 8 * KS + 8);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const bf16* bp = &bs[t][nt * 8 + gid][ks + 2 * tig];
          mma16816(acc[t][i], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
    if (do_bias) {
      for (int k = 0; k < kKt; ++k) bacc += __bfloat162float(as[threadIdx.x][k]);
    }
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* out = pw + ((size_t)blockIdx.x * 9 + (da + 1) * 3 + t) * CA * CB;
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const int tile = warp * TILES + i, mt = tile / NTT, nt = tile % NTT;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(size_t)(mt * 16 + gid + 8 * half) * CB + nt * 8 + 2 * tig + e] =
              acc[t][i][2 * half + e];
    }
  }
  if (do_bias) pb[(size_t)blockIdx.x * CA + threadIdx.x] = bacc;
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int CIN, int COUT>
int launch_conv_mma(const void* in, const void* wts, const void* bias, void* out, int n,
                    int h, int w, cudaStream_t s) {
  constexpr size_t smem = ((kTile + 2) * (kTile + 2) + 9 * COUT) * (CIN + 8) * sizeof(bf16);
  auto kernel = conv3x3_mma_kernel<CIN, COUT>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<tile_grid(n, h, w), kThreads, smem, s>>>(
      static_cast<const bf16*>(in), static_cast<const bf16*>(wts),
      static_cast<const float*>(bias), static_cast<bf16*>(out), h, w);
  return (int)cudaGetLastError();
}

dim3 tail_grid(int n, int h, int w) {
  return dim3((w + kTile - 1) / kTile, (h + 7) / 8, n);
}

template <bool kGrad>
int launch_tail_mma(const void* z, const void* kp, const void* b2, const void* w3,
                    const void* b3, const void* g, void* y4, void* dph, void* partial,
                    int n, int h, int w, cudaStream_t s) {
  constexpr size_t smem = (10 * (kTile + 2) + 9 * 128) * 40 * sizeof(bf16);
  auto kernel = head_tail_mma_kernel<kGrad>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<tail_grid(n, h, w), kThreads, smem, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(kp),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(g),
      static_cast<float*>(y4), static_cast<bf16*>(dph), static_cast<float*>(partial), h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Weights are float32
// [3][3][cin][cout]; bias may be null. cin % 16 == 0, cout % 32 == 0.
int head_conv3x3(const void* in, int in_dtype, const void* wts,
                 const void* bias, void* out, int out_dtype, int n, int cin,
                 int cout, int h, int w, void* stream) {
  if (cin % kIcb != 0 || cout % kOcb != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    launch_conv<float, float>(in, wts, bias, out, n, cin, cout, h, w, s);
  else if (in_dtype == 1 && out_dtype == 1)
    launch_conv<__nv_bfloat16, __nv_bfloat16>(in, wts, bias, out, n, cin, cout, h, w, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch_conv<float, __nv_bfloat16>(in, wts, bias, out, n, cin, cout, h, w, s);
  else
    launch_conv<__nv_bfloat16, float>(in, wts, bias, out, n, cin, cout, h, w, s);
  return (int)cudaGetLastError();
}

int head_num_tiles(int n, int h, int w) {
  dim3 g = tile_grid(n, h, w);
  return (int)(g.x * g.y * g.z);
}

// z: (n, 32, h, w); kp: f32 [3][3][32][128]; b2, w3: (32,); b3: (1,);
// y4: (n, 4, h, w) f32.
int head_tail_fwd(const void* z, int z_dtype, const void* kp, const void* b2,
                  const void* w3, const void* b3, void* y4, int n, int h,
                  int w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (z_dtype == 1)
    launch_tail<__nv_bfloat16, false>(z, kp, b2, w3, b3, nullptr, y4, nullptr, nullptr, n, h, w, s);
  else
    launch_tail<float, false>(z, kp, b2, w3, b3, nullptr, y4, nullptr, nullptr, n, h, w, s);
  return (int)cudaGetLastError();
}

// g: (n, 4, h, w) f32; dph: (n, 128, h, w) f32; partial: (tiles, 33) f32
// holding per-block [dw3 (32), db3].
int head_tail_bwd(const void* z, int z_dtype, const void* kp, const void* b2,
                  const void* w3, const void* b3, const void* g, void* dph,
                  void* partial, int n, int h, int w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (z_dtype == 1)
    launch_tail<__nv_bfloat16, true>(z, kp, b2, w3, b3, g, nullptr, dph, partial, n, h, w, s);
  else
    launch_tail<float, true>(z, kp, b2, w3, b3, g, nullptr, dph, partial, n, h, w, s);
  return (int)cudaGetLastError();
}

// kind 0: A = d_phases (n, 128, h, w) f32, B = z (n, 32, h, w);
// kind 1: A = dz (n, 32, h, w) f32,       B = x (n, 64, h, w).
// pw: (chunks, 9, CA, CB); pb: (chunks, CA), written by the centre tap.
int head_wgrad(int kind, const void* a, const void* b, int b_dtype, int n,
               int h, int w, int chunks, int chunk, void* pw, void* pb,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) {
    if (b_dtype == 1)
      launch_wgrad<__nv_bfloat16, 128, 32, 4, 4>(a, b, n, h, w, chunks, chunk, pw, pb, s);
    else
      launch_wgrad<float, 128, 32, 4, 4>(a, b, n, h, w, chunks, chunk, pw, pb, s);
  } else {
    if (b_dtype == 1)
      launch_wgrad<__nv_bfloat16, 32, 64, 2, 4>(a, b, n, h, w, chunks, chunk, pw, pb, s);
    else
      launch_wgrad<float, 32, 64, 2, 4>(a, b, n, h, w, chunks, chunk, pw, pb, s);
  }
  return (int)cudaGetLastError();
}

// ---- bf16 tensor-core entry points (see the mma kernels above) ----

// wts: bf16 [3][3][cout][cin]; (cin, cout) in {(64, 32), (128, 32), (32, 64)};
// in/out bf16 NCHW; bias f32 or null.
int head_conv3x3_mma(const void* in, const void* wts, const void* bias, void* out, int n,
                     int cin, int cout, int h, int w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cin == 64 && cout == 32) return launch_conv_mma<64, 32>(in, wts, bias, out, n, h, w, s);
  if (cin == 128 && cout == 32) return launch_conv_mma<128, 32>(in, wts, bias, out, n, h, w, s);
  if (cin == 32 && cout == 64) return launch_conv_mma<32, 64>(in, wts, bias, out, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

int head_tail_mma_num_tiles(int n, int h, int w) {
  dim3 g = tail_grid(n, h, w);
  return (int)(g.x * g.y * g.z);
}

// z bf16 (n, 32, h, w); kp bf16 [3][3][128][32]; y4 f32 (n, 4, h, w).
int head_tail_mma_fwd(const void* z, const void* kp, const void* b2, const void* w3,
                      const void* b3, void* y4, int n, int h, int w, void* stream) {
  return launch_tail_mma<false>(z, kp, b2, w3, b3, nullptr, y4, nullptr, nullptr, n, h, w,
                                (cudaStream_t)stream);
}

// g f32 (n, 4, h, w); dph bf16 (n, 128, h, w); partial f32 (tiles, 33).
int head_tail_mma_bwd(const void* z, const void* kp, const void* b2, const void* w3,
                      const void* b3, const void* g, void* dph, void* partial, int n,
                      int h, int w, void* stream) {
  return launch_tail_mma<true>(z, kp, b2, w3, b3, g, nullptr, dph, partial, n, h, w,
                               (cudaStream_t)stream);
}

// kind 0: A = d_phases (n, 128, h, w), B = z (n, 32, h, w); kind 1: A = dz
// (n, 32, h, w), B = x (n, 64, h, w); all bf16. Each of the `chunks` blocks
// per tap reduces `segs` (even) 16-pixel row segments, of which there are
// n * h * ceil(w / 16). Outputs as head_wgrad.
int head_wgrad_mma(int kind, const void* a, const void* b, int n, int h, int w, int chunks,
                   int segs, void* pw, void* pb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(chunks, 3);  // one block per chunk and row offset
  if (kind == 0)
    wgrad_mma_kernel<128, 32><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), n, h, w, segs,
        static_cast<float*>(pw), static_cast<float*>(pb));
  else
    wgrad_mma_kernel<32, 64><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), n, h, w, segs,
        static_cast<float*>(pw), static_cast<float*>(pb));
  return (int)cudaGetLastError();
}

}  // extern "C"

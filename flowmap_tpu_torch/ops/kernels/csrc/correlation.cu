// Fused softmax expectation: out = softmax(q k^T / sqrt(c) [+ bias]) @ values,
// forward only, the (L, L) scores never in device memory.
//
// Replaces the Pallas TPU kernels of flowmap_tpu/ops/pallas/correlation.py
// (softmax_expectation and global_correlation_expectation; pallas_calls at
// :116 without bias and :134 with it).
//
// The TPU kernel gives each program a block of queries and the WHOLE key set
// in fast memory (megabytes), so its softmax is one pass over a full row. A
// Hopper SM has 227 KB of shared memory, so this kernel is organised anew,
// flash-attention style: one block of 256 threads owns 64 queries of one
// batch element and walks the keys in tiles of 64 through shared memory,
// keeping a running row maximum, a running row sum and a running (64, d)
// result in registers, rescaled whenever the maximum rises (online softmax).
// Both products are computed here on the CUDA cores with f32 accumulation:
//
//   scores: each thread owns a 4 x 4 tile (4 queries, 4 keys); the query and
//           key tiles lie in shared memory with a padded row stride so that
//           the 16-byte loads along c are free of bank conflicts;
//   p @ v:  d = 64 or 128: the probabilities go through shared memory (over
//           the key tile, which is dead by then) and each thread owns 4
//           queries x d/16 value columns; d <= 8: each thread multiplies its
//           own 4 x 4 probabilities with the values of its 4 keys and the 16
//           threads of a query row add their partial results once, after the
//           last key tile.
//
// Any length L: queries past L are computed on zeros and not stored, keys
// past L score -inf; no padded copies exist. The bias is (groups, L, L) f32
// and batch element b reads group b % groups, so a mask shared by every
// image is never tiled to the batch. A row whose scores are all -inf so far
// keeps a zero sum instead of a NaN rescale. q and k are float32 or bfloat16
// (converted on the way into shared memory); values, bias and out are f32.
//
// Bound: operations, 2 L^2 (c + d) a batch element at the f32 rate of the
// CUDA cores. Shared-memory bandwidth (one 16-byte load per 8 multiply-adds
// in the score product) keeps a CUDA-core version below that rate.

#include <math.h>

#include "warp_common.cuh"

namespace {

constexpr int kBM = 64;       // queries per block
constexpr int kBN = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16: ty owns 4 queries, tx 4 keys
constexpr int kPS = kBN + 4;  // row stride of the probabilities

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C, int D>
constexpr int smem_floats() {
  return kBM * (C + 4) + kBN * cmax(C + 4, kPS) + kBN * D;
}

// Rows [0, valid) of a (rows, C) global tile of T into shared memory as f32
// with row stride C + 4, scaled; rows from `valid` to 64 are zero.
template <typename T, int C>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int valid,
                                          float scale, float* __restrict__ dst) {
  constexpr int V = Pack<T>::kN;
  constexpr int kVecs = C / V;
  for (int idx = threadIdx.x; idx < 64 * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int cv = idx - r * kVecs;
    float v[V];
    if (r < valid) {
      Pack<T>::load(src + (size_t)r * C + cv * V, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.0f;
    }
    float* out = dst + r * (C + 4) + cv * V;
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(out + k) =
          make_float4(v[k] * scale, v[k + 1] * scale, v[k + 2] * scale, v[k + 3] * scale);
    }
  }
}

// q, k: (batch, L, C) of T; v: (batch, L, D) f32; bias: (groups, L, L) f32 or
// null; out: (batch, L, D) f32. grid = (ceil(L / 64), batch).
template <typename T, int C, int D>
__global__ void __launch_bounds__(kThreads, 2)
softmax_expectation_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           float* __restrict__ out, int L, int groups, float scale) {
  static_assert(C % 8 == 0, "c must be a multiple of 8");
  static_assert(D <= 8 || D % 64 == 0, "d must be at most 8 or a multiple of 64");
  constexpr bool kSmallD = D <= 8;
  constexpr int QS = C + 4;
  constexpr int kCols = kSmallD ? D : D / 16;  // accumulators per query row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBM * QS;  // the probabilities alias it after the scores
  float* Vs = Ks + kBN * cmax(QS, kPS);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)b * L;
  const float* bias_b = bias ? bias + (size_t)(b % groups) * L * L : nullptr;

  load_tile<T, C>(q + (base + q0) * C, min(kBM, L - q0), scale, Qs);

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) o[i][e] = 0.0f;
  }

  for (int j0 = 0; j0 < L; j0 += kBN) {
    const int valid = min(kBN, L - j0);
    __syncthreads();  // the previous tile's keys, probabilities and values are read
    load_tile<T, C>(k + (base + j0) * C, valid, 1.0f, Ks);
    if constexpr (kSmallD) {
      for (int idx = threadIdx.x; idx < kBN * D; idx += kThreads) {
        Vs[idx] = idx < valid * D ? v[(base + j0) * D + idx] : 0.0f;
      }
    } else {
      for (int idx = threadIdx.x; idx < kBN * (D / 4); idx += kThreads) {
        const int r = idx / (D / 4);
        float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < valid) val = reinterpret_cast<const float4*>(v + (base + j0) * D)[idx];
        reinterpret_cast<float4*>(Vs)[idx] = val;
      }
    }
    __syncthreads();

    // Scores of queries ty * 4 + i against keys tx + 16 * j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c0 = 0; c0 < C; c0 += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * QS + c0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }

    // Bias, the mask of keys past L, and the online softmax of this tile.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tx + 16 * j;
        if (col >= L) {
          s[i][j] = -INFINITY;
        } else if (bias_b != nullptr && row < L) {
          s[i][j] += bias_b[(size_t)row * L + col];
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) o[i][e] *= alpha;
    }

    if constexpr (kSmallD) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float vv[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) vv[e] = Vs[(tx + 16 * j) * D + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kCols; ++e) o[i][e] += s[i][j] * vv[e];
      }
    } else {
      __syncthreads();  // every warp is done with the key tile
      float* Ps = Ks;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kPS + tx + 16 * j] = s[i][j];
      __syncwarp();  // a query row's 16 threads lie in one warp
#pragma unroll 2
      for (int kk = 0; kk < kBN; kk += 4) {
        float4 pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pr[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPS + kk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int g = 0; g < kCols / 4; ++g) {
            const float4 vv =
                *reinterpret_cast<const float4*>(Vs + (kk + t) * D + g * 64 + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = t == 0 ? pr[i].x : t == 1 ? pr[i].y : t == 2 ? pr[i].z : pr[i].w;
              o[i][g * 4 + 0] += p * vv.x;
              o[i][g * 4 + 1] += p * vv.y;
              o[i][g * 4 + 2] += p * vv.z;
              o[i][g * 4 + 3] += p * vv.w;
            }
          }
        }
      }
    }
  }

  // The row sums (and, for a small d, the results) are partial per thread.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      if constexpr (kSmallD) {
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          o[i][e] += __shfl_xor_sync(0xffffffffu, o[i][e], off);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    const float inv = 1.0f / l[i];
    float* dst = out + (base + row) * D;
    if constexpr (kSmallD) {
      if (tx == 0) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) dst[e] = o[i][e] * inv;
      }
    } else {
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        *reinterpret_cast<float4*>(dst + g * 64 + tx * 4) =
            make_float4(o[i][g * 4] * inv, o[i][g * 4 + 1] * inv, o[i][g * 4 + 2] * inv,
                        o[i][g * 4 + 3] * inv);
      }
    }
  }
}

template <typename T, int C, int D>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           int batch, int L, int groups, cudaStream_t stream) {
  if (batch == 0 || L == 0) return 0;
  constexpr int kBytes = smem_floats<C, D>() * (int)sizeof(float);
  auto kernel = softmax_expectation_kernel<T, C, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((L + kBM - 1) / kBM), (unsigned)batch);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), L, groups,
      1.0f / sqrtf((float)C));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             int batch, int L, int c, int d, int groups, cudaStream_t s) {
  if (c == 128 && d == 128) return launch<T, 128, 128>(q, k, v, bias, out, batch, L, groups, s);
  if (c == 128 && d == 2) return launch<T, 128, 2>(q, k, v, bias, out, batch, L, groups, s);
  if (c == 16 && d == 8) return launch<T, 16, 8>(q, k, v, bias, out, batch, L, groups, s);
  if (c == 16 && d == 2) return launch<T, 16, 2>(q, k, v, bias, out, batch, L, groups, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype of q and k: 0 = float32, 1 = bfloat16; values, bias and out float32.
// q, k: (batch, L, c); values: (batch, L, d); bias: (groups, L, L) or null,
// batch element b reading group b % groups; out: (batch, L, d).
// Returns -1 for a (c, d) pair that is not compiled in.
int softmax_expectation_fwd(const void* q, const void* k, const void* values,
                            const void* bias, void* out, int batch, int L, int c,
                            int d, int groups, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? dispatch<__nv_bfloat16>(q, k, values, bias, out, batch, L, c, d, groups, s)
             : dispatch<float>(q, k, values, bias, out, batch, L, c, d, groups, s);
}

}  // extern "C"

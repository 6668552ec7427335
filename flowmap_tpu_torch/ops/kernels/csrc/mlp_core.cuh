// The correspondence-weight MLP on the tensor cores, shared by the fused
// weight-MLP kernel (weight_mlp.cu, I) and the fused full-resolution weight
// kernel (corr_weights.cu, H).
//
// Per pixel, widths 64 + 64 -> 128 -> 64 -> 1 (nn.Linear layout, (out, in)):
//   z0 = in W0^T + b0        in = [a | l], 128 wide, in the input type T
//   x0 = round_T(relu(z0))
//   z1 = x0 W1^T + b1        x1 = relu(z1), kept in f32
//   y  = x1 . w2 + b2
// and its backward, with the rounding points of the TPU weight-MLP kernel
// (flowmap_tpu/ops/pallas/weight_mlp.py:_fwd_T, _bwd_kernel):
//   dz1 = (x1 > 0) * w2 * dy                 f32, rounded to T for products
//   dz0 = (x0 > 0) * (round_T(dz1) W1)       f32, rounded to T for products
//   d_in = round_T(round_T(dz0) W0)
//   dW0 = round_T(dz0)^T in,  dW1 = round_T(dz1)^T x0,  dw2 = x1^T dy
//   db0 = sum dz0,  db1 = sum dz1,  db2 = sum dy   (f32, unrounded)
//
// Every product runs in the block's own body on mma.sync: m16n8k16 with bf16
// operands for T = bfloat16, and for T = float m16n8k8 in TF32 with the
// operands split into a high and a low TF32 part (three products: about f32
// accuracy). One code path serves both types; only the fragment loads differ.
// Operands sit in shared memory; an accessor functor returns element (row, k)
// as f32, and the fragment loader rounds it to the operand type.
//
// A block handles tiles of BM pixels (64 for bf16, 32 for f32) with 8 warps.
// Output tiles of 16 rows x 32 columns ("units") are spread over the warps.
// Parameter gradients of a block are summed over its tiles in registers
// (dW0, dW1: each warp owns fixed units) and per thread (bias sums), written
// once as the block's partial, and the partials are summed in a fixed order
// by reduce_partials: no atomics, the same bits on every run for a given
// grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mlp {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kC = 64;      // channels of each input half
constexpr int kIn = 128;    // first layer's input width
constexpr int kD0 = 128;    // hidden widths
constexpr int kD1 = 64;

// Partial layout of one block's parameter gradients (f32).
constexpr int kOffW0 = 0;                       // (128, 128)
constexpr int kOffW1 = kOffW0 + kD0 * kIn;      // (64, 128)
constexpr int kOffB0 = kOffW1 + kD1 * kD0;      // 128
constexpr int kOffB1 = kOffB0 + kD0;            // 64
constexpr int kOffW2 = kOffB1 + kD1;            // 64
constexpr int kOffB2 = kOffW2 + kD1;            // 1
constexpr int kPartial = kOffB2 + 8;

template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int BM = 64;
  static constexpr int PAD = 8;
};
template <>
struct Tile<float> {
  static constexpr int BM = 32;
  static constexpr int PAD = 4;
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T fromf(float x);
template <>
__device__ __forceinline__ float fromf<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 fromf<bf16>(float x) { return __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// Fragments. Lane = 4 * gid + tig. C (16x8 f32): c[0..1] (gid, 2tig..+1),
// c[2..3] (gid+8, 2tig..+1), for both shapes.
// m16n8k16 bf16: A a[0] (gid, 2tig..+1), a[1] (gid+8, ..), a[2] (gid, 2tig+8..),
//   a[3] (gid+8, 2tig+8..); B b[0] (k 2tig..+1, n gid), b[1] (k 2tig+8.., n gid).
// m16n8k8 tf32: A a[0] (gid, tig), a[1] (gid+8, tig), a[2] (gid, tig+4),
//   a[3] (gid+8, tig+4); B b[0] (k tig, n gid), b[1] (k tig+4, n gid).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A(16 x K) B_j(K x 8)^T for NT n-tiles of 8 columns. A(r, k): row
// r in [0, 16) of the unit; B(n, k): column n in [0, 8 NT). K is a multiple
// of 16 (bf16) or 8 (f32).
template <typename T, int NT, typename FA, typename FB>
__device__ __forceinline__ void unit_mma(float (&acc)[NT][4], const FA& A, const FB& B,
                                         int K) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int k = 0; k < K; k += 16) {
      const int ka = k + 2 * tig;
      uint32_t a[4];
      a[0] = pack_bf16(A(gid, ka), A(gid, ka + 1));
      a[1] = pack_bf16(A(gid + 8, ka), A(gid + 8, ka + 1));
      a[2] = pack_bf16(A(gid, ka + 8), A(gid, ka + 9));
      a[3] = pack_bf16(A(gid + 8, ka + 8), A(gid + 8, ka + 9));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + gid;
        mma_bf16(acc[j], a, pack_bf16(B(n, ka), B(n, ka + 1)),
                 pack_bf16(B(n, ka + 8), B(n, ka + 9)));
      }
    }
  } else {
    for (int k = 0; k < K; k += 8) {
      const int ka = k + tig;
      uint32_t ah[4], al[4];
      split_tf32(A(gid, ka), ah[0], al[0]);
      split_tf32(A(gid + 8, ka), ah[1], al[1]);
      split_tf32(A(gid, ka + 4), ah[2], al[2]);
      split_tf32(A(gid + 8, ka + 4), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + gid;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(B(n, ka), bh0, bl0);
        split_tf32(B(n, ka + 4), bh1, bl1);
        mma_tf32(acc[j], al, bh0, bh1);
        mma_tf32(acc[j], ah, bl0, bl1);
        mma_tf32(acc[j], ah, bh0, bh1);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// Calls f(row, col, value) for the unit's accumulators (row, col relative).
template <int NT, typename F>
__device__ __forceinline__ void for_each(const float (&acc)[NT][4], const F& f) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(gid + (e >> 1) * 8, 8 * j + 2 * tig + (e & 1), acc[j][e]);
}

// ---------------------------------------------------------------------------
// Shared memory.
// ---------------------------------------------------------------------------

template <typename T>
struct Smem {
  static constexpr int BM = Tile<T>::BM;
  static constexpr int LW = kIn + Tile<T>::PAD;  // rows of 128 T values
  static constexpr int LX1 = kD1 + 4;              // rows of 64 f32 values
  static constexpr int LZ0 = kD0 + 4;              // rows of 128 f32 values
  T* w0;      // (128, LW)
  T* w1;      // (64, LW)
  T* in;      // (BM, LW)
  T* x0;      // (BM, LW)
  float* x1;  // (BM, LX1)
  float* dz1; // (BM, LX1)  backward only
  float* dz0; // (BM, LZ0)  backward only
  float* dy;  // (BM)
  float* b0;  // 128
  float* b1;  // 64
  float* w2;  // 64

  static constexpr size_t bytes(bool backward) {
    return sizeof(T) * (size_t)(kD0 + kD1 + 2 * BM) * LW +
           sizeof(float) * ((size_t)BM * LX1 +
                            (backward ? (size_t)BM * LX1 + (size_t)BM * LZ0 : 0) + BM +
                            kD0 + 2 * kD1);
  }

  __device__ static Smem carve(unsigned char* base, bool backward) {
    Smem s;
    T* t = reinterpret_cast<T*>(base);
    s.w0 = t;
    s.w1 = s.w0 + kD0 * LW;
    s.in = s.w1 + kD1 * LW;
    s.x0 = s.in + BM * LW;
    float* f = reinterpret_cast<float*>(s.x0 + BM * LW);
    s.x1 = f;
    f += BM * LX1;
    if (backward) {
      s.dz1 = f;
      f += BM * LX1;
      s.dz0 = f;
      f += BM * LZ0;
    } else {
      s.dz1 = s.dz0 = nullptr;
    }
    s.dy = f;
    s.b0 = s.dy + BM;
    s.b1 = s.b0 + kD0;
    s.w2 = s.b1 + kD1;
    return s;
  }
};

// Copy the parameters into shared memory (w0 (128, 128), w1 (64, 128) and
// w2 (1, 64) in T; b0, b1 f32).
template <typename T>
__device__ void stage_params(const Smem<T>& s, const T* __restrict__ w0,
                             const float* __restrict__ b0, const T* __restrict__ w1,
                             const float* __restrict__ b1, const T* __restrict__ w2) {
  constexpr int LW = Smem<T>::LW;
  for (int e = threadIdx.x; e < (kD0 + kD1) * kIn; e += kThreads) {
    const int r = e / kIn, c = e % kIn;
    if (r < kD0) {
      s.w0[r * LW + c] = w0[e];
    } else {
      s.w1[(r - kD0) * LW + c] = w1[e - kD0 * kIn];
    }
  }
  for (int e = threadIdx.x; e < kD0; e += kThreads) s.b0[e] = b0[e];
  for (int e = threadIdx.x; e < kD1; e += kThreads) {
    s.b1[e] = b1[e];
    s.w2[e] = tof(w2[e]);
  }
}

// From s.in (BM, 128): s.x0 = round_T(relu(in W0^T + b0)), s.x1 =
// relu(x0 W1^T + b1) in f32. Starts after a barrier that published s.in and
// ends with one.
template <typename T>
__device__ void forward_tile(const Smem<T>& s) {
  constexpr int BM = Smem<T>::BM, LW = Smem<T>::LW, LX1 = Smem<T>::LX1;
  const int warp = threadIdx.x >> 5;
  for (int u = warp; u < (BM / 16) * (kD0 / 32); u += kWarps) {
    const int m0 = (u / (kD0 / 32)) * 16, n0 = (u % (kD0 / 32)) * 32;
    float acc[4][4];
    zero(acc);
    unit_mma<T>(acc, [&](int r, int k) { return tof(s.in[(m0 + r) * LW + k]); },
                [&](int n, int k) { return tof(s.w0[(n0 + n) * LW + k]); }, kIn);
    for_each(acc, [&](int r, int c, float v) {
      s.x0[(m0 + r) * LW + n0 + c] = fromf<T>(fmaxf(v + s.b0[n0 + c], 0.0f));
    });
  }
  __syncthreads();
  for (int u = warp; u < (BM / 16) * (kD1 / 32); u += kWarps) {
    const int m0 = (u / (kD1 / 32)) * 16, n0 = (u % (kD1 / 32)) * 32;
    float acc[4][4];
    zero(acc);
    unit_mma<T>(acc, [&](int r, int k) { return tof(s.x0[(m0 + r) * LW + k]); },
                [&](int n, int k) { return tof(s.w1[(n0 + n) * LW + k]); }, kD0);
    for_each(acc, [&](int r, int c, float v) {
      s.x1[(m0 + r) * LX1 + n0 + c] = fmaxf(v + s.b1[n0 + c], 0.0f);
    });
  }
  __syncthreads();
}

// The logit of tile row r: x1[r] . w2 + b2, summed in column order.
template <typename T>
__device__ __forceinline__ float logit(const Smem<T>& s, int r, float b2) {
  float acc = 0.0f;
  const float* x1 = s.x1 + r * Smem<T>::LX1;
#pragma unroll 8
  for (int k = 0; k < kD1; ++k) acc += x1[k] * s.w2[k];
  return acc + b2;
}

// Parameter-gradient accumulators of one thread, carried over a block's tiles.
struct GradAcc {
  float w0[4][4][4];  // 4 units of dW0 (32 units over 8 warps)
  float w1[2][4][4];  // 2 units of dW1 (16 units over 8 warps)
  float col;          // thread t: db0[t] (t < 128), db1 (t < 192), dw2 (else)
  float b2;           // thread 0: db2
};

__device__ __forceinline__ void zero(GradAcc& g) {
#pragma unroll
  for (int i = 0; i < 4; ++i) zero(g.w0[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) zero(g.w1[i]);
  g.col = 0.0f;
  g.b2 = 0.0f;
}

// The backward of one tile, after forward_tile and with s.dy (BM) set and
// published. Leaves dz0 in s.dz0, adds the tile's parameter gradients to g,
// and ends with a barrier; the caller then takes d_in from backward_input.
template <typename T>
__device__ void backward_tile(const Smem<T>& s, GradAcc& g) {
  constexpr int BM = Smem<T>::BM, LW = Smem<T>::LW, LX1 = Smem<T>::LX1,
                LZ0 = Smem<T>::LZ0;
  const int warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < BM * kD1; e += kThreads) {
    const int r = e / kD1, k = e % kD1;
    s.dz1[r * LX1 + k] = s.x1[r * LX1 + k] > 0.0f ? s.w2[k] * s.dy[r] : 0.0f;
  }
  __syncthreads();
  // dz0 = (x0 > 0) * (round_T(dz1) W1): B(n = j, k) = W1[k][j].
  for (int u = warp; u < (BM / 16) * (kD0 / 32); u += kWarps) {
    const int m0 = (u / (kD0 / 32)) * 16, n0 = (u % (kD0 / 32)) * 32;
    float acc[4][4];
    zero(acc);
    unit_mma<T>(acc, [&](int r, int k) { return s.dz1[(m0 + r) * LX1 + k]; },
                [&](int n, int k) { return tof(s.w1[k * LW + n0 + n]); }, kD1);
    for_each(acc, [&](int r, int c, float v) {
      const int row = m0 + r, col = n0 + c;
      s.dz0[row * LZ0 + col] = tof(s.x0[row * LW + col]) > 0.0f ? v : 0.0f;
    });
  }
  __syncthreads();
  // dW0 += round_T(dz0)^T in: unit (k_out tile mt, input group ng).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = warp + kWarps * i;
    const int m0 = (u / 4) * 16, n0 = (u % 4) * 32;
    unit_mma<T>(g.w0[i], [&](int r, int k) { return s.dz0[k * LZ0 + m0 + r]; },
                [&](int n, int k) { return tof(s.in[k * LW + n0 + n]); }, BM);
  }
  // dW1 += round_T(dz1)^T x0.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = warp + kWarps * i;
    const int m0 = (u / 4) * 16, n0 = (u % 4) * 32;
    unit_mma<T>(g.w1[i], [&](int r, int k) { return s.dz1[k * LX1 + m0 + r]; },
                [&](int n, int k) { return tof(s.x0[k * LW + n0 + n]); }, BM);
  }
  const int t = threadIdx.x;
  if (t < kD0) {
    for (int r = 0; r < BM; ++r) g.col += s.dz0[r * LZ0 + t];
  } else if (t < kD0 + kD1) {
    for (int r = 0; r < BM; ++r) g.col += s.dz1[r * LX1 + t - kD0];
  } else {
    for (int r = 0; r < BM; ++r) g.col += s.x1[r * LX1 + t - kD0 - kD1] * s.dy[r];
  }
  if (t == 0) {
    for (int r = 0; r < BM; ++r) g.b2 += s.dy[r];
  }
  __syncthreads();
}

// d_in = round_T(round_T(dz0) W0) of the tile: f(row, col, value) for each
// of the (BM, 128) values, value already rounded to T. B(n = c, k) = W0[k][c].
template <typename T, typename F>
__device__ void backward_input(const Smem<T>& s, const F& f) {
  constexpr int BM = Smem<T>::BM, LW = Smem<T>::LW, LZ0 = Smem<T>::LZ0;
  const int warp = threadIdx.x >> 5;
  for (int u = warp; u < (BM / 16) * (kIn / 32); u += kWarps) {
    const int m0 = (u / (kIn / 32)) * 16, n0 = (u % (kIn / 32)) * 32;
    float acc[4][4];
    zero(acc);
    unit_mma<T>(acc, [&](int r, int k) { return s.dz0[(m0 + r) * LZ0 + k]; },
                [&](int n, int k) { return tof(s.w0[k * LW + n0 + n]); }, kD0);
    for_each(acc, [&](int r, int c, float v) { f(m0 + r, n0 + c, fromf<T>(v)); });
  }
}

// Write the block's accumulated parameter gradients as its partial.
__device__ void write_partial(const GradAcc& g, float* __restrict__ partial) {
  float* p = partial + (size_t)blockIdx.x * kPartial;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = warp + kWarps * i;
    const int m0 = (u / 4) * 16, n0 = (u % 4) * 32;
    for_each(g.w0[i], [&](int r, int c, float v) { p[kOffW0 + (m0 + r) * kIn + n0 + c] = v; });
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = warp + kWarps * i;
    const int m0 = (u / 4) * 16, n0 = (u % 4) * 32;
    for_each(g.w1[i], [&](int r, int c, float v) { p[kOffW1 + (m0 + r) * kD0 + n0 + c] = v; });
  }
  // db0, db1, dw2 are contiguous from kOffB0: thread t writes entry t.
  p[kOffB0 + threadIdx.x] = g.col;
  if (threadIdx.x == 0) p[kOffB2] = g.b2;
}

// out[e] = sum over blocks g = 0, 1, ... of partial[g][e], in that order.
__global__ void reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                                int nparts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kOffB2 + 1) return;
  float acc = 0.0f;
  for (int g = 0; g < nparts; ++g) acc += partial[(size_t)g * kPartial + e];
  out[e] = acc;
}

inline int launch_reduce(const void* partial, void* out, int nparts, cudaStream_t stream) {
  const int len = kOffB2 + 1;
  reduce_partials<<<(len + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nparts);
  return (int)cudaGetLastError();
}

// Load the 16-byte vector v (of 16 / sizeof(T) values) as f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  uint4 q = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = tof(e[k]);
}

}  // namespace mlp

// Fused correspondence-weight MLP (kernel I): logits = MLP([wa | la]) per
// pixel, forward and backward, with every product on the tensor cores.
//
// Replaces the Pallas TPU kernel flowmap_tpu/ops/pallas/weight_mlp.py
// (weight_mlp; forward pallas_call at :158, backward at :182). The TPU kernel
// keeps the 128- and 64-wide intermediates in VMEM and writes only the
// logits; here they live in shared memory (mlp_core.cuh), and a block walks
// over tiles of pixels with the parameters staged once.
//
// Bound: bytes. The forward reads wa and la (128 values a pixel) and writes
// one f32; at 1.3 M pixels that is ~1000 FLOP for every 260 bytes in bf16,
// under the card's ~295 FLOP per byte. The backward reads them again with
// the cotangent and writes dwa and dla. The design keeps every intermediate
// out of device memory and reads each input once; the parameter gradients
// leave a block once, as a partial that reduce_partials sums in a fixed order.
//
// A pixel count that is not a multiple of the tile is handled by zero rows:
// they are computed and never stored, and a zero cotangent gives them no
// share of the parameter gradients.

#include "mlp_core.cuh"

namespace {

using namespace mlp;

// Load tile rows [p0, p0 + BM) of [wa | la] into s.in (zeros past p).
template <typename T>
__device__ void load_inputs(const Smem<T>& s, const T* __restrict__ wa,
                            const T* __restrict__ la, int p0, int p) {
  constexpr int V = 16 / sizeof(T), BM = Smem<T>::BM, LW = Smem<T>::LW;
  constexpr int VPR = kIn / V;  // vectors a row
  for (int e = threadIdx.x; e < BM * VPR; e += kThreads) {
    const int r = e / VPR, v = e % VPR, c = v * V;
    const int pix = p0 + r;
    uint4 q = make_uint4(0, 0, 0, 0);
    if (pix < p) {
      const T* src = c < kC ? wa + (size_t)pix * kC + c : la + (size_t)pix * kC + c - kC;
      q = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(s.in + r * LW + c) = q;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
weight_mlp_fwd_kernel(const T* __restrict__ wa, const T* __restrict__ la,
                      const T* __restrict__ w0, const float* __restrict__ b0,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      float* __restrict__ out, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = Smem<T>::BM;
  const Smem<T> s = Smem<T>::carve(smem, false);
  stage_params(s, w0, b0, w1, b1, w2);
  const float bias2 = b2[0];
  const int ntiles = (p + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * BM;
    __syncthreads();
    load_inputs(s, wa, la, p0, p);
    __syncthreads();
    forward_tile(s);
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      if (p0 + r < p) out[p0 + r] = logit(s, r, bias2);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
weight_mlp_bwd_kernel(const T* __restrict__ wa, const T* __restrict__ la,
                      const T* __restrict__ w0, const float* __restrict__ b0,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ dy,
                      T* __restrict__ dwa, T* __restrict__ dla,
                      float* __restrict__ partial, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = Smem<T>::BM;
  const Smem<T> s = Smem<T>::carve(smem, true);
  stage_params(s, w0, b0, w1, b1, w2);
  GradAcc g;
  zero(g);
  const int ntiles = (p + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * BM;
    __syncthreads();
    load_inputs(s, wa, la, p0, p);
    for (int r = threadIdx.x; r < BM; r += kThreads) s.dy[r] = p0 + r < p ? dy[p0 + r] : 0.0f;
    __syncthreads();
    forward_tile(s);
    backward_tile(s, g);
    backward_input(s, [&](int r, int c, T v) {
      const int pix = p0 + r;
      if (pix >= p) return;
      if (c < kC) {
        dwa[(size_t)pix * kC + c] = v;
      } else {
        dla[(size_t)pix * kC + c - kC] = v;
      }
    });
  }
  write_partial(g, partial);
}

template <typename T>
int launch_fwd(const void* wa, const void* la, const void* w0, const void* b0,
               const void* w1, const void* b1, const void* w2, const void* b2, void* out,
               int p, int blocks, cudaStream_t stream) {
  const size_t bytes = Smem<T>::bytes(false);
  cudaError_t err = cudaFuncSetAttribute(weight_mlp_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  weight_mlp_fwd_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(wa), static_cast<const T*>(la), static_cast<const T*>(w0),
      static_cast<const float*>(b0), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* wa, const void* la, const void* w0, const void* b0,
               const void* w1, const void* b1, const void* w2, const void* dy, void* dwa,
               void* dla, void* partial, int p, int blocks, cudaStream_t stream) {
  const size_t bytes = Smem<T>::bytes(true);
  cudaError_t err = cudaFuncSetAttribute(weight_mlp_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  weight_mlp_bwd_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(wa), static_cast<const T*>(la), static_cast<const T*>(w0),
      static_cast<const float*>(b0), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(dy), static_cast<T*>(dwa), static_cast<T*>(dla),
      static_cast<float*>(partial), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels a tile: the wrapper sizes grids and partial buffers from it.
int weight_mlp_tile(int dtype) { return dtype == 1 ? Tile<bf16>::BM : Tile<float>::BM; }

// Floats in one block's partial of the parameter gradients.
int weight_mlp_partial_len() { return kPartial; }

// dtype: 0 = float32, 1 = bfloat16 (wa, la, w0, w1, w2); b0, b1, b2 and the
// logits are float32. wa, la: (p, 64); w0: (128, 128); w1: (64, 128);
// w2: (1, 64). `blocks` persistent blocks walk over the tiles.
int weight_mlp_fwd(const void* wa, const void* la, const void* w0, const void* b0,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int p, int blocks, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_fwd<bf16>(wa, la, w0, b0, w1, b1, w2, b2, out, p, blocks, s)
                    : launch_fwd<float>(wa, la, w0, b0, w1, b1, w2, b2, out, p, blocks, s);
}

// dy: (p,) float32. dwa, dla: (p, 64) in the input type; partial: (blocks,
// weight_mlp_partial_len()) float32, filled by the call (no clearing needed).
int weight_mlp_bwd(const void* wa, const void* la, const void* w0, const void* b0,
                   const void* w1, const void* b1, const void* w2, const void* dy,
                   void* dwa, void* dla, void* partial, int p, int blocks, int dtype,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch_bwd<bf16>(wa, la, w0, b0, w1, b1, w2, dy, dwa, dla, partial, p, blocks, s)
             : launch_bwd<float>(wa, la, w0, b0, w1, b1, w2, dy, dwa, dla, partial, p, blocks, s);
}

// out (128*128 + 64*128 + 128 + 64 + 64 + 1 floats: dW0, dW1, db0, db1, dw2,
// db2) = the sum of `nparts` partials, in block order.
int weight_mlp_reduce(const void* partial, void* out, int nparts, void* stream) {
  return launch_reduce(partial, out, nparts, (cudaStream_t)stream);
}

}  // extern "C"

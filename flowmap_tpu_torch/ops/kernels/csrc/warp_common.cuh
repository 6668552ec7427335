// Shared by the feature-warp kernels (shift_warp.cu, warp_features.cu): the
// 16-byte channel vector of a feature type and grid_sample's pixel
// coordinates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One thread moves 16 bytes of channels: 4 float or 8 bfloat16, computed on
// in f32. `round` rounds an f32 value to the feature type and back.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  static __device__ void load(const float* p, float (&v)[4]) {
    float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ float round(float x) { return x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(b[k]);
  }
  static __device__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = __float2bfloat16(v[k]);
    *reinterpret_cast<uint4*>(p) = q;
  }
  static __device__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// A grid value in [-1, 1] as a pixel coordinate (align_corners=False).
__device__ __forceinline__ float unnormalize(float g, int size) {
  return ((g + 1.0f) * (float)size - 1.0f) * 0.5f;
}

// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel of this directory is built by nvcc into its own shared
// library with a plain C interface (see univs_tpu_torch/ops/kernels.py)
// and loaded with ctypes.  Conventions shared by all of them:
//   - a launch function returns cudaGetLastError() as an int; the Python
//     wrapper raises when it is not 0;
//   - launches go to the stream the caller passes (PyTorch's current
//     stream); nothing is allocated and nothing synchronises;
//   - dtype code 0 = float32, 1 = bfloat16; accumulation is float32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace univs {

struct Levels {
  int L;
  int h[4];
  int w[4];
  int start[4];
};

inline Levels make_levels(int L, const int* shapes) {
  Levels lv;
  lv.L = L;
  int s = 0;
  for (int l = 0; l < 4; ++l) {
    lv.h[l] = l < L ? shapes[2 * l] : 1;
    lv.w[l] = l < L ? shapes[2 * l + 1] : 1;
    lv.start[l] = s;
    if (l < L) s += lv.h[l] * lv.w[l];
  }
  return lv;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a product in T would see.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// The bilinear weight of integer coordinate i for a sample at c,
// max(1 - |i - c|, 0), each step rounded on its own (nvcc would otherwise
// be free to contract); the tent kernels D, E and F share it.
__device__ __forceinline__ float tent(float i, float c) {
  return fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(i, c))), 0.f);
}

// four consecutive elements (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(q[0]);
  float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace univs

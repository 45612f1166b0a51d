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

#include <cstdint>

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

// ---------------------------------------------------------------------------
// bf16 tensor-core tiles: mma.sync m16n8k16 (bf16 in, float32 accumulate)
// and its fragment loaders (kernel B).  g = lane / 4 is the
// fragment's row group and t = lane % 4 the thread in the group.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_smem32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of MT 16-row m-tiles at k-offset k0 from a row-major bf16
// tile in shared memory with row stride `stride` (m16n8k16 "row" layout).
template <int MT>
__device__ __forceinline__ void load_a(uint32_t (&af)[MT][4], const __nv_bfloat16* tile,
                                       int stride, int k0, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* p = tile + (mt * 16 + g) * stride + k0 + 2 * t;
    af[mt][0] = ld_smem32(p);
    af[mt][1] = ld_smem32(p + 8 * stride);
    af[mt][2] = ld_smem32(p + 8);
    af[mt][3] = ld_smem32(p + 8 * stride + 8);
  }
}

// B fragments of NT 8-column n-tiles at k-offset k0 from shared memory:
// column n of B is row n of an [out, in] weight, so a fragment's k pairs
// are contiguous.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&bf)[NT][2], const __nv_bfloat16* w, int ldw,
                                       int n0, int k0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat16* p = w + (size_t)(n0 + nt * 8 + g) * ldw + k0 + 2 * t;
    bf[nt][0] = ld_smem32(p);
    bf[nt][1] = ld_smem32(p + 8);
  }
}

// 16 bytes global -> shared without registers; src_bytes < 16 fills the
// rest with zeros (0: a zero row past a ragged edge).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace univs

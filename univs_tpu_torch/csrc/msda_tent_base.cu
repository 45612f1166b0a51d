// Kernel D: the base tent kernel's law, all levels in one launch, over a
// float32 / bfloat16 value or its int8 slab.
//
// Replaces the Pallas kernel univs_tpu/ops/deformable_attention.py:276
// _tent_kernel (pallas_call :383, entry _msda_tent_level), which the JAX
// package reaches through ms_deform_attn(impl='tent-int8') and
// ms_deform_attn_tent(level_impl='base').  It computes the same bilinear
// sum as kernel A (msda_sample.cu),
//   out[n, q, m, :] = sum_l dq_l * sum_p sum_j p2_j,
// but with the TPU kernel's rounding points, so that it agrees with the
// JAX package to float32 summation order:
//   tx_i = max(1 - |i - x|, 0) * wa               (f32; i in {floor(x), floor(x)+1}
//                                                  inside [0, W), else no tap)
//   int8 mode:  mq_i = rint(tx_i * 127) (two f32 roundings, half to even),
//               t1_j = float(sum_i mq_i * q[j, i, d])  (exact in int32)
//   dtype mode: t1_j = sum_i T(tx_i) * v[j, i, d]  (f32 accumulation)
//   p2_j = T(max(1 - |j - y|, 0) * t1_j)           (T: the slab's dtype, never int8)
//   dq_l = scale_l / 127 / 127 per (frame, head, level) in int8 mode, applied
//          after the point sum; levels summed in f32 from 0, then cast to T.
// Every step is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn): nvcc would otherwise contract a*b+c into one FMA.
//
// The TPU kernel's d-major [W, D*H] slab and the 0/1 grouping matmul G
// exist for the MXU (Mosaic cannot lane-split a reshape); on Hopper the
// tent is non-zero at two columns and two rows only, so this is a gather
// like kernel A: one warp per (frame, query, head), one lane per channel
// (32/D items a warp when D < 32), four predicated corner loads per sample.
// The quantisation of the slab stays outside, in PyTorch, as the JAX
// package does it in XLA.
//
// Bound on the H100: compulsory traffic is value (1 byte an element as
// int8) + rows + output; as for kernel A the real limit is the corner
// gathers served from L2.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace univs {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T, bool Q8>
__global__ void __launch_bounds__(256)
msda_tent_base_kernel(const void* __restrict__ value_,   // [N, S, M, D] T, or int8 (Q8)
                      const float* __restrict__ dequant,  // [N, M, L] (Q8 only)
                      const float* __restrict__ loc,      // [N, Lq, M, L, P, 3]
                      T* __restrict__ out,                // [N, Lq, M, D]
                      int N, int S, int Lq, int M, int D, int P, Levels lv) {
  using V = typename std::conditional<Q8, int8_t, T>::type;
  const V* value = static_cast<const V*>(value_);
  const int lanes_per_item = D < 32 ? D : 32;
  const int items_per_warp = 32 / lanes_per_item;
  const int lane = threadIdx.x & 31;
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long item = warp * items_per_warp + lane / lanes_per_item;  // (n*Lq + q)*M + m
  const long total = (long)N * Lq * M;
  if (item >= total) return;
  const int dl = lane % lanes_per_item;
  const int m = (int)(item % M);
  const int n = (int)(item / ((long)M * Lq));
  const int LP = lv.L * P;
  const float* smp = loc + item * LP * 3;
  const size_t pix = (size_t)M * D;  // elements between neighbouring pixels

  for (int d = dl; d < D; d += lanes_per_item) {
    float acc = 0.f;
    for (int l = 0; l < lv.L; ++l) {
      const int H = lv.h[l], W = lv.w[l];
      const V* vl = value + ((size_t)n * S + lv.start[l]) * pix + (size_t)m * D + d;
      float acc_l = 0.f;
      for (int p = 0; p < P; ++p) {
        const float* s = smp + (l * P + p) * 3;
        const float x = s[0], y = s[1], wa = s[2];
        // clamp before the int cast: a clamped tap lies outside the level
        const int x0 = (int)fminf(fmaxf(floorf(x), -2.f), (float)W);
        const int y0 = (int)fminf(fmaxf(floorf(y), -2.f), (float)H);
        const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
        const float tx0 = vx0 ? __fmul_rn(tent((float)x0, x), wa) : 0.f;
        const float tx1 = vx1 ? __fmul_rn(tent((float)(x0 + 1), x), wa) : 0.f;
        int mq0 = 0, mq1 = 0;
        float w0 = 0.f, w1 = 0.f;
        if constexpr (Q8) {
          mq0 = (int)rintf(__fmul_rn(tx0, 127.f));
          mq1 = (int)rintf(__fmul_rn(tx1, 127.f));
        } else {
          w0 = round_to<T>(tx0);
          w1 = round_to<T>(tx1);
        }
        float row = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int j = y0 + k;
          if (j < 0 || j >= H) continue;
          const V* vr = vl + (size_t)j * W * pix;
          float t1;
          if constexpr (Q8) {
            const int a = vx0 ? (int)vr[(size_t)x0 * pix] : 0;
            const int b = vx1 ? (int)vr[(size_t)(x0 + 1) * pix] : 0;
            t1 = (float)(mq0 * a + mq1 * b);
          } else {
            const float a = vx0 ? load_f32(vr + (size_t)x0 * pix) : 0.f;
            const float b = vx1 ? load_f32(vr + (size_t)(x0 + 1) * pix) : 0.f;
            t1 = __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
          }
          const float p2 = round_to<T>(__fmul_rn(tent((float)j, y), t1));
          row = __fadd_rn(row, p2);
        }
        acc_l = __fadd_rn(acc_l, row);
      }
      if constexpr (Q8) acc_l = __fmul_rn(acc_l, dequant[((size_t)n * M + m) * lv.L + l]);
      acc = __fadd_rn(acc, acc_l);
    }
    out[item * D + d] = from_f32<T>(acc);
  }
}

template <typename T, bool Q8>
int launch(const void* value, const float* dequant, const void* loc, void* out, int N, int S,
           int Lq, int M, int D, int P, int L, const int* shapes, cudaStream_t stream) {
  if (L < 1 || L > 4 || D < 1 || (D < 32 ? 32 % D : D % 32) != 0)
    return (int)cudaErrorInvalidValue;
  if (Q8 && dequant == nullptr) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, shapes);
  const int items_per_warp = D < 32 ? 32 / D : 1;
  const long warps = ((long)N * Lq * M + items_per_warp - 1) / items_per_warp;
  const int threads = 256;
  const long blocks = (warps * 32 + threads - 1) / threads;
  msda_tent_base_kernel<T, Q8><<<(unsigned)blocks, threads, 0, stream>>>(
      value, dequant, (const float*)loc, (T*)out, N, S, Lq, M, D, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace univs

// dtype: the slab's (and output's) type, 0 = float32, 1 = bfloat16.
// int8: 1 when value is the int8 slab and dequant [N, M, L] is given.
extern "C" int msda_tent_base_launch(int dtype, int int8, const void* value, const void* dequant,
                                     const void* loc, void* out, int N, int S, int Lq, int M,
                                     int D, int P, int L, const int* shapes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* dq = (const float*)dequant;
  if (dtype == 0 && !int8)
    return univs::launch<float, false>(value, dq, loc, out, N, S, Lq, M, D, P, L, shapes, s);
  if (dtype == 0 && int8)
    return univs::launch<float, true>(value, dq, loc, out, N, S, Lq, M, D, P, L, shapes, s);
  if (dtype == 1 && !int8)
    return univs::launch<__nv_bfloat16, false>(value, dq, loc, out, N, S, Lq, M, D, P, L,
                                               shapes, s);
  if (dtype == 1 && int8)
    return univs::launch<__nv_bfloat16, true>(value, dq, loc, out, N, S, Lq, M, D, P, L,
                                              shapes, s);
  return (int)cudaErrorInvalidValue;
}

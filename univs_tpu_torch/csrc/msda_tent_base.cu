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
//                                                  inside [0, W), else 0)
//   int8 mode:  mq_i = rint(tx_i * 127) (two f32 roundings, half to even),
//               t1_j = float(sum_i mq_i * q[j, i, d])  (exact in int32)
//   dtype mode: t1_j = sum_i T(tx_i) * v[j, i, d]  (f32 accumulation)
//   p2_j = T(max(1 - |j - y|, 0) * t1_j)           (T: the slab's dtype, never int8;
//                                                   0 for a row outside [0, H))
//   dq_l = scale_l / 127 / 127 per (frame, head, level) in int8 mode, applied
//          after the point sum; levels summed in f32 from 0, then cast to T.
// Every step is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn): nvcc would otherwise contract a*b+c into one FMA.
//
// The TPU kernel's d-major [W, D*H] slab and the 0/1 grouping matmul G
// exist for the MXU (Mosaic cannot lane-split a reshape); on Hopper the
// tent is non-zero at two columns and two rows only, so this is a gather
// with kernel A's design: a group of lanes serves one (frame, query,
// head), each lane one piece of the head's channels, min(16, D) bytes of
// the int8 slab or min(32, D * size) bytes of a value (D = 32: 2 lanes of
// 16 channels in both modes; a head wider than 32 pieces loops a warp
// over them).  Each lane computes a sample's floor, clamps, validity,
// tents and their rounding (or int8 quantisation) once for its piece,
// reads the four corners as independent wide loads (an outside corner
// reads a clamped address at weight 0, the plain version's gather, so no
// load waits on a branch) and keeps the per-channel steps in the law's
// order.  In int8 mode the two columns' products and their sum take one
// dp2a a channel (the taps as int16, exact in int32), and a row outside
// the level is weighted 0, as exact as dropping it; two rows' p2 are
// rounded by one bf16x2 conversion.  The L*P sample loop is unrolled for
// the model's (3, 4) at pieces of 16 bytes or more and runs at run time
// elsewhere.  The quantisation of the slab stays outside, in PyTorch, as
// the JAX package does it in XLA.
//
// Bound on the H100: compulsory traffic is value (1 byte an element as
// int8) + rows + output.  The corner gathers are served from L1 and L2
// (the model's samples cluster around their query); at D = 32 the
// per-channel steps, each rounded on its own and never fused into an FMA,
// are the larger cost.
#include <cstdint>
#include <type_traits>

#include "tent_gather.cuh"

namespace univs {

// One sample of a level for a lane's NE channels: vl points at the lane's
// piece of pixel 0 of the head, pix = bytes between neighbouring pixels.
template <typename T, bool Q8, int VB, int NE>
__device__ __forceinline__ void tent_sample(float (&acc)[NE], const char* __restrict__ vl,
                                            size_t pix, int H, int W, float x, float y,
                                            float wa) {
  using V = std::conditional_t<Q8, int8_t, T>;
  // clamp before the int cast: a clamped tap lies outside the level
  const int x0 = (int)fminf(fmaxf(floorf(x), -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(floorf(y), -2.f), (float)H);
  const bool vx0 = (unsigned)x0 < (unsigned)W, vx1 = (unsigned)(x0 + 1) < (unsigned)W;
  const bool vy0 = (unsigned)y0 < (unsigned)H, vy1 = (unsigned)(y0 + 1) < (unsigned)H;
  // an outside corner reads an in-level address at weight 0
  const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
  const int ya = min(max(y0, 0), H - 1) * W, yb = min(max(y0 + 1, 0), H - 1) * W;
  const Piece<VB> c00 = ld_piece<VB>(vl + (size_t)(ya + xa) * pix);
  const Piece<VB> c01 = ld_piece<VB>(vl + (size_t)(ya + xb) * pix);
  const Piece<VB> c10 = ld_piece<VB>(vl + (size_t)(yb + xa) * pix);
  const Piece<VB> c11 = ld_piece<VB>(vl + (size_t)(yb + xb) * pix);
  const float tx0 = vx0 ? __fmul_rn(tent((float)x0, x), wa) : 0.f;
  const float tx1 = vx1 ? __fmul_rn(tent((float)(x0 + 1), x), wa) : 0.f;
  if constexpr (Q8) {
    // t1 is an exact integer, so a row outside the level may be weighted 0
    // instead of dropped: its p2 is a zero as well
    const float ty0 = vy0 ? tent((float)y0, y) : 0.f;
    const float ty1 = vy1 ? tent((float)(y0 + 1), y) : 0.f;
    const int mq0 = (int)rintf(__fmul_rn(tx0, 127.f));
    const int mq1 = (int)rintf(__fmul_rn(tx1, 127.f));
    float t1a[NE], t1b[NE];
    if (VB >= 4 && mq0 == (short)mq0 && mq1 == (short)mq1) {
      // mq0 * a + mq1 * b for two channels a dp2a: the taps as int16
      // halves, the two columns' int8 channels interleaved
      const int mq = (mq0 & 0xffff) | (mq1 << 16);
#pragma unroll
      for (int i = 0; i < (VB >= 4 ? VB / 4 : 0); ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned sel = h ? 0x7362u : 0x5140u;  // bytes 2h, 2h + 1 of both
          const int a = (int)__byte_perm(c00.w[i], c01.w[i], sel);
          const int b = (int)__byte_perm(c10.w[i], c11.w[i], sel);
          t1a[4 * i + 2 * h] = (float)__dp2a_lo(mq, a, 0);
          t1a[4 * i + 2 * h + 1] = (float)__dp2a_hi(mq, a, 0);
          t1b[4 * i + 2 * h] = (float)__dp2a_lo(mq, b, 0);
          t1b[4 * i + 2 * h + 1] = (float)__dp2a_hi(mq, b, 0);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        t1a[k] = (float)(mq0 * elem<V>(c00, k) + mq1 * elem<V>(c01, k));
        t1b[k] = (float)(mq0 * elem<V>(c10, k) + mq1 * elem<V>(c11, k));
      }
    }
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      float p2a = __fmul_rn(ty0, t1a[k]), p2b = __fmul_rn(ty1, t1b[k]);
      round2_to<T>(p2a, p2b);
      acc[k] = __fadd_rn(acc[k], __fadd_rn(p2a, p2b));
    }
  } else {
    const float ty0 = tent((float)y0, y), ty1 = tent((float)(y0 + 1), y);
    const float w0 = round_to<T>(tx0), w1 = round_to<T>(tx1);
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const float t1a =
          __fadd_rn(__fmul_rn(w0, elem<V>(c00, k)), __fmul_rn(w1, elem<V>(c01, k)));
      const float t1b =
          __fadd_rn(__fmul_rn(w0, elem<V>(c10, k)), __fmul_rn(w1, elem<V>(c11, k)));
      float p2a = __fmul_rn(ty0, t1a), p2b = __fmul_rn(ty1, t1b);
      round2_rows<T>(p2a, p2b, vy0, vy1);
      acc[k] = __fadd_rn(acc[k], __fadd_rn(p2a, p2b));
    }
  }
}

// G lanes per (frame, query, head), `pieces` pieces of VB bytes a head;
// kL > 0: L = kL and P = kP at compile time, kL == 0: at run time.
template <typename T, bool Q8, int VB, int kL, int kP>
__global__ void __launch_bounds__(256, 2)
msda_tent_base_kernel(const void* __restrict__ value_,   // [N, S, M, D] T, or int8 (Q8)
                      const float* __restrict__ dequant,  // [N, M, L] (Q8 only)
                      const float* __restrict__ loc,      // [N, Lq, M, L, P, 3]
                      T* __restrict__ out,                // [N, Lq, M, D]
                      int N, int S, int Lq, int M, int D, int P, int G, int pieces,
                      Levels lv) {
  using V = std::conditional_t<Q8, int8_t, T>;
  constexpr int NE = VB / sizeof(V);
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long item = tid / G;  // (n*Lq + q)*M + m
  if (item >= (long)N * Lq * M) return;
  const int gl = (int)(tid - item * G);
  const int m = (int)(item % M);
  const int n = (int)(item / ((long)M * Lq));
  const size_t pix = (size_t)M * D * sizeof(V);  // bytes between neighbouring pixels
  const char* vhead =
      static_cast<const char*>(value_) + ((size_t)n * S * M + m) * D * sizeof(V);
  const float* dq = Q8 ? dequant + ((size_t)n * M + m) * lv.L : nullptr;

  for (int pc = gl; pc < pieces; pc += G) {
    const char* vp = vhead + (size_t)pc * VB;
    float acc[NE];
#pragma unroll
    for (int k = 0; k < NE; ++k) acc[k] = 0.f;
    if constexpr (kL > 0) {
      constexpr int R = 3 * kP;  // floats of one level's samples
      static_assert(R % 4 == 0, "a level's samples as 16-byte loads");
      const float* smp = loc + item * (kL * R);
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        float s[R];
#pragma unroll
        for (int k = 0; k < R / 4; ++k) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(smp + l * R) + k);
          s[4 * k] = f.x;
          s[4 * k + 1] = f.y;
          s[4 * k + 2] = f.z;
          s[4 * k + 3] = f.w;
        }
        const char* vl = vp + (size_t)lv.start[l] * pix;
        float acc_l[NE];
#pragma unroll
        for (int k = 0; k < NE; ++k) acc_l[k] = 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p)
          tent_sample<T, Q8, VB, NE>(acc_l, vl, pix, lv.h[l], lv.w[l], s[3 * p],
                                     s[3 * p + 1], s[3 * p + 2]);
        const float d = Q8 ? __ldg(dq + l) : 1.f;
#pragma unroll
        for (int k = 0; k < NE; ++k)
          acc[k] = __fadd_rn(acc[k], Q8 ? __fmul_rn(acc_l[k], d) : acc_l[k]);
      }
    } else {
      const float* smp = loc + item * (lv.L * P * 3);
      for (int l = 0; l < lv.L; ++l) {
        const char* vl = vp + (size_t)lv.start[l] * pix;
        float acc_l[NE];
#pragma unroll
        for (int k = 0; k < NE; ++k) acc_l[k] = 0.f;
        for (int p = 0; p < P; ++p, smp += 3)
          tent_sample<T, Q8, VB, NE>(acc_l, vl, pix, lv.h[l], lv.w[l], __ldg(smp),
                                     __ldg(smp + 1), __ldg(smp + 2));
        const float d = Q8 ? __ldg(dq + l) : 1.f;
#pragma unroll
        for (int k = 0; k < NE; ++k)
          acc[k] = __fadd_rn(acc[k], Q8 ? __fmul_rn(acc_l[k], d) : acc_l[k]);
      }
    }
    store_piece<T, NE>(out + item * D + (size_t)pc * NE, acc);
  }
}

template <typename T, bool Q8, int VB>
int launch_vb(const void* value, const float* dequant, const void* loc, void* out, int N, int S,
              int Lq, int M, int D, int P, const Levels& lv, cudaStream_t stream) {
  using V = std::conditional_t<Q8, int8_t, T>;
  const int pieces = D * (int)sizeof(V) / VB, G = group_lanes(pieces);
  const long threads_total = (long)N * Lq * M * G;
  const int threads = 256;
  const long blocks = (threads_total + threads - 1) / threads;
  if (blocks == 0) return (int)cudaGetLastError();
  // the unrolled body reads a level's samples as 16-byte loads
  if constexpr (VB >= 16) {
    if (lv.L == 3 && P == 4 && ((uintptr_t)loc & 15) == 0) {
      msda_tent_base_kernel<T, Q8, VB, 3, 4><<<(unsigned)blocks, threads, 0, stream>>>(
          value, dequant, (const float*)loc, (T*)out, N, S, Lq, M, D, P, G, pieces, lv);
      return (int)cudaGetLastError();
    }
  }
  msda_tent_base_kernel<T, Q8, VB, 0, 0><<<(unsigned)blocks, threads, 0, stream>>>(
      value, dequant, (const float*)loc, (T*)out, N, S, Lq, M, D, P, G, pieces, lv);
  return (int)cudaGetLastError();
}

template <typename T, bool Q8>
int launch(const void* value, const float* dequant, const void* loc, void* out, int N, int S,
           int Lq, int M, int D, int P, int L, const int* shapes, cudaStream_t stream) {
  using V = std::conditional_t<Q8, int8_t, T>;
  if (L < 1 || L > 4 || !tent_head_ok(D)) return (int)cudaErrorInvalidValue;
  if (Q8 && dequant == nullptr) return (int)cudaErrorInvalidValue;
  // a lane's piece: min(kPiece, D * size) bytes of the value, read as
  // loads of up to 16 bytes at addresses of their size, as are its results
  const int bytes = D * (int)sizeof(V), cap = Q8 ? 16 : 32, vb = bytes < cap ? bytes : cap;
  const int ob = vb / (int)sizeof(V) * (int)sizeof(T);
  if ((uintptr_t)value % (vb < 16 ? vb : 16) || (uintptr_t)out % (ob < 16 ? ob : 16))
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, shapes);
  switch (vb) {
    case 32:
      if constexpr (!Q8)
        return launch_vb<T, Q8, 32>(value, dequant, loc, out, N, S, Lq, M, D, P, lv, stream);
      break;
    case 16:
      return launch_vb<T, Q8, 16>(value, dequant, loc, out, N, S, Lq, M, D, P, lv, stream);
    case 8:
      return launch_vb<T, Q8, 8>(value, dequant, loc, out, N, S, Lq, M, D, P, lv, stream);
    case 4:
      if constexpr (sizeof(V) <= 4)
        return launch_vb<T, Q8, 4>(value, dequant, loc, out, N, S, Lq, M, D, P, lv, stream);
      break;
    case 2:
      if constexpr (sizeof(V) <= 2)
        return launch_vb<T, Q8, 2>(value, dequant, loc, out, N, S, Lq, M, D, P, lv, stream);
      break;
    case 1:
      if constexpr (sizeof(V) == 1)
        return launch_vb<T, Q8, 1>(value, dequant, loc, out, N, S, Lq, M, D, P, lv, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
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

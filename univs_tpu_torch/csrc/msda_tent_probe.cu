// Kernel F: the separable-tent probe laws, one gather per sample row.
//
// Replaces three Pallas probes of tools/ (the TPU's record of separable
// x-then-y tent formulations of the MSDA bilinear sum):
//   probe_tent_kernel.py:42   tent_kernel     (pallas_call :82,  entry msda_tent)
//   probe_tent_variants.py:43 make_kernel     (pallas_call :150, entry run_level)
//   probe_tent_v5.py:64       make_exp_kernel (pallas_call :163, entry run_exp)
// Over one level H x W, per sample row r (pixel coordinates x, y and
// attention weight wa), head m and channel d:
//   mx_i = R(tent(i - x) * wa)            (tent_kernel: no wa)
//   t1_j = sum_i mx_i * V[j, i, d]        f32; R(t1_j) under kRoundT1
//   ty_j = tent(j - y)                    f32; R(ty_j) under kRoundTy
//   p2_j = R(ty_j * t1_j)
//   row  = sum_j p2_j                     f32; R(row) under kRoundRow
//   out[n, g, m, d] = sum of row over the G consecutive rows of group g
//                     (f32, rows ascending; G = 1 for tent_kernel, P else)
// R rounds to the rounding type: the slab's dtype (tent_kernel,
// make_exp_kernel) or bfloat16 whatever the slab's dtype (make_kernel
// hard-codes bf16 for mx, G, Gp and p2).  The probes' laws are flag sets
// (univs_tpu_torch/ops/msda_probes.py:PROBE_LAWS).  Every step is an
// explicitly rounded intrinsic, so the kernel agrees with its plain
// version to the bit.
//
// The TPU kernels evaluate the tents densely over [rows, W] and
// [rows, D*H] planes and contract them on the MXU (Mosaic cannot gather);
// a tent is non-zero at two columns and two rows only, so on Hopper this
// is a gather like kernels A and D: one warp per (frame, group, head), one
// lane per channel (32/D groups a warp when D < 32), four predicated
// corner loads per sample.  Dropping the zero taps is exact: a zero term
// adds nothing to an f32 sum.  The slab is read in its probe's layout,
// [N, M, W, D*H] d-major (element (i; d*H + j)) or [N, M, W, H*D] j-major
// (element (i; j*D + d)): a corner read is then one coalesced segment
// (j-major) or D strided elements (d-major).
//
// Bound on the H100: compulsory traffic is slab + rows + output; as for
// kernels A and D the real limit is the corner gathers served from L2.
#include "common.cuh"

namespace univs {

enum : int { kWa = 1, kRoundT1 = 2, kRoundTy = 4, kRoundRow = 8 };

template <typename T, typename R>
__global__ void __launch_bounds__(256)
msda_tent_probe_kernel(const T* __restrict__ slab,     // [N, M, W, H*D], see strides
                       const float* __restrict__ xs,   // [N, Rr, M]
                       const float* __restrict__ ys,   // [N, Rr, M]
                       const float* __restrict__ was,  // [N, Rr, M] (kWa only)
                       float* __restrict__ out,        // [N, Rr / G, M, D]
                       int N, int Rr, int M, int H, int W, int D, int G, int sd, int sj,
                       int flags) {
  const int lanes_per_item = D < 32 ? D : 32;
  const int items_per_warp = 32 / lanes_per_item;
  const int lane = threadIdx.x & 31;
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long item = warp * items_per_warp + lane / lanes_per_item;  // (n*NG + g)*M + m
  const int NG = Rr / G;
  const long total = (long)N * NG * M;
  if (item >= total) return;
  const int dl = lane % lanes_per_item;
  const int m = (int)(item % M);
  const int g = (int)((item / M) % NG);
  const int n = (int)(item / ((long)M * NG));
  const size_t col = (size_t)H * D;  // elements between neighbouring columns i
  const T* vb = slab + ((size_t)n * M + m) * W * col;
  const bool use_wa = flags & kWa;

  for (int d = dl; d < D; d += lanes_per_item) {
    const T* vd = vb + (size_t)d * sd;
    float acc = 0.f;
    for (int k = 0; k < G; ++k) {
      const size_t ri = ((size_t)n * Rr + (size_t)g * G + k) * M + m;
      const float x = xs[ri], y = ys[ri];
      // clamp before the int cast: a clamped tap lies outside the level
      const int x0 = (int)fminf(fmaxf(floorf(x), -2.f), (float)W);
      const int y0 = (int)fminf(fmaxf(floorf(y), -2.f), (float)H);
      const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      float tx0 = tent((float)x0, x), tx1 = tent((float)(x0 + 1), x);
      if (use_wa) {
        const float wa = was[ri];
        tx0 = __fmul_rn(tx0, wa);
        tx1 = __fmul_rn(tx1, wa);
      }
      const float w0 = vx0 ? round_to<R>(tx0) : 0.f;
      const float w1 = vx1 ? round_to<R>(tx1) : 0.f;
      float row = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = y0 + kk;
        if (j < 0 || j >= H) continue;
        const T* vr = vd + (size_t)j * sj;
        const float a = vx0 ? to_f32(vr[(size_t)x0 * col]) : 0.f;
        const float b = vx1 ? to_f32(vr[(size_t)(x0 + 1) * col]) : 0.f;
        float t1 = __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
        if (flags & kRoundT1) t1 = round_to<R>(t1);
        float ty = tent((float)j, y);
        if (flags & kRoundTy) ty = round_to<R>(ty);
        row = __fadd_rn(row, round_to<R>(__fmul_rn(ty, t1)));
      }
      if (flags & kRoundRow) row = round_to<R>(row);
      acc = __fadd_rn(acc, row);
    }
    out[item * D + d] = acc;
  }
}

template <typename T, typename R>
int launch(const void* slab, const void* xs, const void* ys, const void* was, void* out, int N,
           int Rr, int M, int H, int W, int D, int G, int dmajor, int flags,
           cudaStream_t stream) {
  if (D < 1 || (D < 32 ? 32 % D : D % 32) != 0 || G < 1 || Rr % G != 0 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  if ((flags & kWa) && was == nullptr) return (int)cudaErrorInvalidValue;
  const int sd = dmajor ? H : 1, sj = dmajor ? 1 : D;
  const int items_per_warp = D < 32 ? 32 / D : 1;
  const long warps = ((long)N * (Rr / G) * M + items_per_warp - 1) / items_per_warp;
  const int threads = 256;
  const long blocks = (warps * 32 + threads - 1) / threads;
  msda_tent_probe_kernel<T, R><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)slab, (const float*)xs, (const float*)ys, (const float*)was, (float*)out, N, Rr,
      M, H, W, D, G, sd, sj, flags);
  return (int)cudaGetLastError();
}

}  // namespace univs

// dtype: the slab's type, 0 = float32, 1 = bfloat16; round_bf16: 1 rounds
// to bfloat16 whatever the slab's type, 0 to the slab's type; dmajor: 1 for
// the [N, M, W, D*H] slab, 0 for [N, M, W, H*D]; flags: kWa | kRoundT1 |
// kRoundTy | kRoundRow.  The output is float32 [N, R / G, M, D].
extern "C" int msda_tent_probe_launch(int dtype, int round_bf16, const void* slab,
                                      const void* xs, const void* ys, const void* was,
                                      void* out, int N, int R, int M, int H, int W, int D,
                                      int G, int dmajor, int flags, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && !round_bf16)
    return univs::launch<float, float>(slab, xs, ys, was, out, N, R, M, H, W, D, G, dmajor,
                                       flags, s);
  if (dtype == 0 && round_bf16)
    return univs::launch<float, __nv_bfloat16>(slab, xs, ys, was, out, N, R, M, H, W, D, G,
                                               dmajor, flags, s);
  if (dtype == 1)
    return univs::launch<__nv_bfloat16, __nv_bfloat16>(slab, xs, ys, was, out, N, R, M, H, W,
                                                       D, G, dmajor, flags, s);
  return (int)cudaErrorInvalidValue;
}

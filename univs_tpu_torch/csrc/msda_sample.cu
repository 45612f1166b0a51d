// Kernel A: multi-scale deformable-attention sampling, all levels in one launch.
//
// Replaces the Pallas tent kernels of univs_tpu/ops/deformable_attention.py:
//   _tent2d_kernel   (:411, pallas_call :459) — levels with H*W <= 1024;
//   _tent_win_kernel (:490, pallas_call :607) — the 1/16 and 1/8 levels.
// Both compute the same contract, which is what this kernel computes:
//   out[n, q, m, :] = sum_{l, p} w * bilinear(V_l[n, :, m, :], x, y)
// with grid_sample semantics (align_corners=False, zero padding: a corner
// outside the level contributes 0) and float32 accumulation.  (x, y) are
// pixel coordinates (loc * size - 0.5) and w the softmaxed attention
// weight, as written by kernel B (msda_rows.cu) in the layout
// loc[N, Lq, M, L, P, 3].
//
// The tent-matmul formulation on the TPU answered a TPU limit (gathers are
// issue-bound there).  On Hopper a gather is cheap, so this is the
// reference's im2col design: one warp per (frame, query, head) with one
// lane per channel d (D = 32 at full width: a corner read is one coalesced
// 64-byte bf16 segment); for D < 32 a warp serves 32/D (q, m) items.  Each
// lane walks the L*P samples, predicates its four corner loads, and
// accumulates in float32.
//
// Bound on the H100: compulsory traffic is value + rows + output (~27 MB
// per frame at full width, ~8 us at 3.35 TB/s); the real limit is the
// corner gathers served from L2 (~1.2 M samples x 4 corners x 64 B per
// frame and layer), which the per-(q, m) warp mapping keeps coalesced.
#include "common.cuh"

namespace univs {

template <typename T>
__global__ void __launch_bounds__(256)
msda_sample_kernel(const T* __restrict__ value,   // [N, S, M, D]
                   const float* __restrict__ loc,  // [N, Lq, M, L, P, 3]
                   T* __restrict__ out,            // [N, Lq, M, D]
                   int N, int S, int Lq, int M, int D, int P, Levels lv) {
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
      const T* vl = value + ((size_t)n * S + lv.start[l]) * pix + (size_t)m * D + d;
      for (int p = 0; p < P; ++p) {
        const float* s = smp + (l * P + p) * 3;
        const float x = s[0], y = s[1], wa = s[2];
        // clamp before the int cast (far-outside coords stay outside)
        const float x0f = fminf(fmaxf(floorf(x), -2.f), (float)W);
        const float y0f = fminf(fmaxf(floorf(y), -2.f), (float)H);
        const float fx = x - floorf(x), fy = y - floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
        const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
        const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
        const float v00 = (vy0 && vx0) ? to_f32(vl[((size_t)y0 * W + x0) * pix]) : 0.f;
        const float v01 = (vy0 && vx1) ? to_f32(vl[((size_t)y0 * W + x1) * pix]) : 0.f;
        const float v10 = (vy1 && vx0) ? to_f32(vl[((size_t)y1 * W + x0) * pix]) : 0.f;
        const float v11 = (vy1 && vx1) ? to_f32(vl[((size_t)y1 * W + x1) * pix]) : 0.f;
        acc += wa * ((1.f - fy) * ((1.f - fx) * v00 + fx * v01) +
                     fy * ((1.f - fx) * v10 + fx * v11));
      }
    }
    out[item * D + d] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* value, const void* loc, void* out, int N, int S, int Lq,
           int M, int D, int P, int L, const int* shapes, cudaStream_t stream) {
  if (L < 1 || L > 4 || D < 1 || (D < 32 ? 32 % D : D % 32) != 0)
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, shapes);
  const int items_per_warp = D < 32 ? 32 / D : 1;
  const long warps = ((long)N * Lq * M + items_per_warp - 1) / items_per_warp;
  const int threads = 256;
  const long blocks = (warps * 32 + threads - 1) / threads;
  msda_sample_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)value, (const float*)loc, (T*)out, N, S, Lq, M, D, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace univs

extern "C" int msda_sample_launch(int dtype, const void* value, const void* loc, void* out,
                                  int N, int S, int Lq, int M, int D, int P, int L,
                                  const int* shapes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return univs::launch<float>(value, loc, out, N, S, Lq, M, D, P, L, shapes, s);
  if (dtype == 1)
    return univs::launch<__nv_bfloat16>(value, loc, out, N, S, Lq, M, D, P, L, shapes, s);
  return (int)cudaErrorInvalidValue;
}

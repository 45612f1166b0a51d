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
// issue-bound there).  On Hopper a gather is cheap (the probes' kernels E
// and F measured it), so this is the reference's im2col design with wide
// loads: a group of G lanes serves one (frame, query, head), each lane 16
// bytes of the head's D channels (G = D * sizeof(T) / 16: 4 lanes for bf16
// D = 32, so a warp serves 8 heads at once).  The group computes each
// sample's floor, clamps, validity and four corner addresses once for all
// D channels, issues the four corner reads as independent 16-byte loads
// (a corner outside the level reads a clamped address at weight 0, so no
// load waits on a branch), and accumulates its 4 or 8 channels in
// float32.  The L*P sample loop is unrolled at compile time for the
// shapes the model and the probes use (L=3, P=4 and L=1, P=4), so several
// samples' loads are in flight per lane; other shapes loop at run time.
// The group then stores its 16 bytes of the output.
//
// Bound on the H100: compulsory traffic is value + rows + output (~27 MB
// per frame at full width, ~8 us at 3.35 TB/s); the real limit is the
// corner gathers served from L2 (~1.2 M samples x 4 corners x 64 B per
// frame and layer).
#include "common.cuh"

namespace univs {

// 16 bytes of T as float32: 8 bf16 or 4 float
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = __bfloat1622float2(h[k]);
    f[2 * k] = a.x;
    f[2 * k + 1] = a.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One bilinear sample of a level: vl points at this lane's 16 bytes of
// pixel 0 of the head, pix = elements between neighbouring pixels.
template <typename T, int VEC>
__device__ __forceinline__ void sample(float (&acc)[VEC], const T* __restrict__ vl, int pix,
                                       int H, int W, float x, float y, float wa) {
  const float xf = floorf(x), yf = floorf(y);
  const float fx = x - xf, fy = y - yf;
  // clamp before the int cast (far-outside coords stay outside)
  const int x0 = (int)fminf(fmaxf(xf, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(yf, -2.f), (float)H);
  const bool vx0 = (unsigned)x0 < (unsigned)W, vx1 = (unsigned)(x0 + 1) < (unsigned)W;
  const bool vy0 = (unsigned)y0 < (unsigned)H, vy1 = (unsigned)(y0 + 1) < (unsigned)H;
  // an outside corner reads an in-level address at weight 0
  const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
  const int ya = min(max(y0, 0), H - 1) * W, yb = min(max(y0 + 1, 0), H - 1) * W;
  const uint4 c00 = ldg16(vl + (ya + xa) * pix);
  const uint4 c01 = ldg16(vl + (ya + xb) * pix);
  const uint4 c10 = ldg16(vl + (yb + xa) * pix);
  const uint4 c11 = ldg16(vl + (yb + xb) * pix);
  // corner weight (wx * wy) * w, the plain law's order
  const float w00 = (vy0 && vx0) ? (1.f - fx) * (1.f - fy) * wa : 0.f;
  const float w01 = (vy0 && vx1) ? fx * (1.f - fy) * wa : 0.f;
  const float w10 = (vy1 && vx0) ? (1.f - fx) * fy * wa : 0.f;
  const float w11 = (vy1 && vx1) ? fx * fy * wa : 0.f;
  float v[VEC];
  unpack16(c00, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w00, v[i], acc[i]);
  unpack16(c01, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w01, v[i], acc[i]);
  unpack16(c10, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w10, v[i], acc[i]);
  unpack16(c11, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w11, v[i], acc[i]);
}

// G lanes per (frame, query, head); kL > 0: L = kL and P = kP at compile
// time, kL == 0: L and P at run time.
template <typename T, int G, int kL, int kP>
__global__ void __launch_bounds__(256, 3)
msda_sample_kernel(const T* __restrict__ value,   // [N, S, M, D]
                   const float* __restrict__ loc,  // [N, Lq, M, L, P, 3]
                   T* __restrict__ out,            // [N, Lq, M, D]
                   int N, int S, int Lq, int M, int P, Levels lv) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int D = G * VEC;
  const long item = ((long)blockIdx.x * blockDim.x + threadIdx.x) / G;  // (n*Lq + q)*M + m
  if (item >= (long)N * Lq * M) return;
  const int gl = threadIdx.x % G;
  const int m = (int)(item % M);
  const int n = (int)(item / ((long)M * Lq));
  const int pix = M * D;  // elements between neighbouring pixels
  const T* vhead = value + (size_t)n * S * pix + m * D + gl * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  if constexpr (kL > 0) {
    constexpr int R = 3 * kP;  // floats of one level's samples
    const float* smp = loc + item * (kL * R);
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      float s[R];
      if constexpr (R % 4 == 0) {  // a level's samples as 16-byte loads
#pragma unroll
        for (int k = 0; k < R / 4; ++k) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(smp + l * R) + k);
          s[4 * k] = f.x;
          s[4 * k + 1] = f.y;
          s[4 * k + 2] = f.z;
          s[4 * k + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) s[k] = __ldg(smp + l * R + k);
      }
      const T* vl = vhead + (size_t)lv.start[l] * pix;
#pragma unroll
      for (int p = 0; p < kP; ++p)
        sample<T, VEC>(acc, vl, pix, lv.h[l], lv.w[l], s[3 * p], s[3 * p + 1], s[3 * p + 2]);
    }
  } else {
    const float* smp = loc + item * (lv.L * P * 3);
    for (int l = 0; l < lv.L; ++l) {
      const T* vl = vhead + (size_t)lv.start[l] * pix;
      const int H = lv.h[l], W = lv.w[l];
      for (int p = 0; p < P; ++p, smp += 3)
        sample<T, VEC>(acc, vl, pix, H, W, __ldg(smp), __ldg(smp + 1), __ldg(smp + 2));
    }
  }
  *reinterpret_cast<uint4*>(out + item * D + gl * VEC) = pack16(acc);
}

template <typename T, int G, int kL, int kP>
int launch_g(const void* value, const void* loc, void* out, int N, int S, int Lq, int M, int P,
             const Levels& lv, cudaStream_t stream) {
  const long threads_total = (long)N * Lq * M * G;
  const int threads = 256;
  const long blocks = (threads_total + threads - 1) / threads;
  if (blocks > 0)
    msda_sample_kernel<T, G, kL, kP><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)value, (const float*)loc, (T*)out, N, S, Lq, M, P, lv);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_shape(const void* value, const void* loc, void* out, int N, int S, int Lq, int M,
                 int P, const Levels& lv, cudaStream_t stream) {
  if (lv.L == 3 && P == 4)
    return launch_g<T, G, 3, 4>(value, loc, out, N, S, Lq, M, P, lv, stream);
  if (lv.L == 1 && P == 4)
    return launch_g<T, G, 1, 4>(value, loc, out, N, S, Lq, M, P, lv, stream);
  return launch_g<T, G, 0, 0>(value, loc, out, N, S, Lq, M, P, lv, stream);
}

template <typename T>
int launch(const void* value, const void* loc, void* out, int N, int S, int Lq, int M, int D,
           int P, int L, const int* shapes, cudaStream_t stream) {
  // a head's channels must be whole 16-byte pieces: 1, 2, 4 or 8 lanes of them
  const int bytes = D * (int)sizeof(T);
  if (L < 1 || L > 4 || D < 1 || bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if ((long)S * M * D >= (1L << 31)) return (int)cudaErrorInvalidValue;  // int pixel offsets
  if (((uintptr_t)value | (uintptr_t)loc | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, shapes);
  switch (bytes / 16) {
    case 1: return launch_shape<T, 1>(value, loc, out, N, S, Lq, M, P, lv, stream);
    case 2: return launch_shape<T, 2>(value, loc, out, N, S, Lq, M, P, lv, stream);
    case 4: return launch_shape<T, 4>(value, loc, out, N, S, Lq, M, P, lv, stream);
    case 8: return launch_shape<T, 8>(value, loc, out, N, S, Lq, M, P, lv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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

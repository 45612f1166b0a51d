// Kernel E: the point-summed tent plane times the value, on tensor cores.
//
// Replaces four Pallas probes of tools/ (the TPU's record of dense tent
// planes on the matrix unit):
//   probe_tent_psum.py:59   _psum2d_kernel      (pallas_call :88,  entry msda_psum2d)
//   probe_tent_psum.py:105  _psum2d_win_kernel  (pallas_call :178, entry msda_psum2d_win)
//   probe_tent_outer.py:39  _outer2d_kernel     (pallas_call :75,  entry msda_outer2d)
//   probe_tent_outer.py:92  _outer2d_win_kernel (pallas_call :174, entry msda_outer2d_win)
// Per (frame n, head m), over one level H x W (pixel s = j*W + i), query
// rows [N, Qp, 3*M*P] (lanes x = m*P+p, y = M*P + m*P+p, wa = 2*M*P +
// m*P+p) and the raster slab V [N, M, S, D]:
//   psum:   A[q, s] = T( sum_p tent(i - x_p) * (tent(j - y_p) * wa_p) )
//   outer:  A[q, s] = T( sum_p (tent(i - x_p) * wa_p) * T(tent(j - y_p)) )
//   out[n, q, m, :] = sum_s A[q, s] * V[n, m, s, :]   (f32 accumulation)
// with the point sums in f32, p ascending, and T the slab's dtype.  With a
// window meta [N, Qp / subq, M, 2] = (ystart, ok) a block whose query chunk
// hits takes the K range of rows ystart .. ystart + Hw, else the whole
// level; the window holds every non-zero entry of its chunk, so the result
// does not depend on it.
//
// Design: one block per (64-query tile, head, frame), four warps.  A loop
// over K chunks of 64 pixels: the threads build the plane tile [64 q, 64 s]
// (two threads a query, each 32 pixels) from the query's taps kept in
// registers, round it to T into shared memory beside the value chunk, and
// multiply: bf16 with mma.sync m16n8k16 (f32 accumulators, each warp one
// 16-row m-tile across the D/8 n-tiles), float32 with an FMA loop.  An
// entry is evaluated from the two non-zero columns and rows of each point's
// tents: tent(i - x) is exactly 0 at every other integer i, and a zero term
// adds nothing to the f32 sum, so every entry is bit-identical to the dense
// evaluation; every entry of the dense plane is still visited, which is the
// probe's question (does a dense plane on the matrix unit beat the gather,
// kernel A?).  No all-zero chunk is skipped.
//
// Bound on the H100: the function's compulsory work is slab + rows +
// output bytes and 2*N*Q*M*P*4*D f32 operations (what kernel A does); the
// plane formulation adds 2*N*M*Qp*S*D tensor flops and ~10 operations per
// point and plane entry to build it, which is what limits this kernel.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace univs {

constexpr int kBQ = 64;       // queries per block: 4 warps x one 16-row m-tile
constexpr int kKC = 64;       // pixels per K chunk: 4 k-steps of 16
constexpr int kThreads = 128;
constexpr int kPMax = 4;      // sampling points of a query (P <= 4)
constexpr int kDMax = 64;     // channels (D % 8 == 0, D <= 64)
constexpr int kAS = kKC + 8;  // row stride (elements) of the plane tile and of V^T

// eight plane entries rounded to the tile's type
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, bool OUTER>
__global__ void __launch_bounds__(kThreads)
msda_tent_plane_kernel(const float* __restrict__ rows,  // [N, Qp, 3*M*P]
                       const T* __restrict__ slab,      // [N, M, S, D]
                       const int* __restrict__ meta,    // [N, Qp / subq, M, 2] or null
                       float* __restrict__ out,         // [N, RQ, M, D]
                       int Qp, int RQ, int M, int P, int H, int W, int D, int subq, int Hw) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) T a_s[kBQ * kAS];                         // plane tile [q][k]
  __shared__ __align__(16) T v_s[kMma ? kDMax * kAS : kKC * kDMax];  // V^T [d][k], or V [k][d]
  const int n = blockIdx.z, m = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int S = H * W;
  int kbeg = 0, kend = S;
  if (meta != nullptr) {
    const int* mt = meta + (((size_t)n * (Qp / subq) + q0 / subq) * M + m) * 2;
    if (mt[1]) {
      kbeg = mt[0] * W;
      kend = min(S, (mt[0] + Hw) * W);
    }
  }

  // this thread's query (two threads a query) and the taps of its points:
  // the plane term of pixel (i, j) is ax[i - x0] * ay[j - y0] when both
  // offsets are 0 or 1, else 0
  const int tq = threadIdx.x >> 1, half = threadIdx.x & 1;
  const float* r = rows + ((size_t)n * Qp + q0 + tq) * 3 * M * P + m * P;
  int x0[kPMax], y0[kPMax];
  float ax0[kPMax], ax1[kPMax], ay0[kPMax], ay1[kPMax];
#pragma unroll
  for (int p = 0; p < kPMax; ++p) {
    x0[p] = y0[p] = -4;  // matches no pixel
    ax0[p] = ax1[p] = ay0[p] = ay1[p] = 0.f;
    if (p < P) {
      const float x = r[p], y = r[M * P + p], wa = r[2 * M * P + p];
      // clamp before the int cast: a clamped tap lies outside the level
      x0[p] = (int)fminf(fmaxf(floorf(x), -2.f), (float)W);
      y0[p] = (int)fminf(fmaxf(floorf(y), -2.f), (float)H);
      const float tx0 = tent((float)x0[p], x), tx1 = tent((float)(x0[p] + 1), x);
      const float ty0 = tent((float)y0[p], y), ty1 = tent((float)(y0[p] + 1), y);
      if (OUTER) {
        ax0[p] = __fmul_rn(tx0, wa);
        ax1[p] = __fmul_rn(tx1, wa);
        ay0[p] = round_to<T>(ty0);
        ay1[p] = round_to<T>(ty1);
      } else {
        ax0[p] = tx0;
        ax1[p] = tx1;
        ay0[p] = __fmul_rn(ty0, wa);
        ay1[p] = __fmul_rn(ty1, wa);
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / thread in group
  const int ntiles = D / 8, dh = D / 2, d0 = half * dh;
  float acc[kDMax / 8][4];  // mma: rows warp*16 + g (+8) of the D/8 n-tiles
  float accf[kDMax / 2];    // FMA: query tq, channels [d0, d0 + D/2)
#pragma unroll
  for (int k = 0; k < kDMax / 8; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
#pragma unroll
  for (int k = 0; k < kDMax / 2; ++k) accf[k] = 0.f;
  const T* vbase = slab + ((size_t)n * M + m) * S * D;

  for (int kc = kbeg; kc < kend; kc += kKC) {
    // the plane tile: this thread's 32 pixels of row tq, zero past kend
    {
      const int s0 = kc + half * 32;
      int j = s0 / W, i = s0 - j * W;
      T* dst = a_s + tq * kAS + half * 32;
#pragma unroll 1
      for (int e0 = 0; e0 < 32; e0 += 8) {
        float v8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a = 0.f;
          if (s0 + e0 + e < kend) {
#pragma unroll
            for (int p = 0; p < kPMax; ++p) {
              const int di = i - x0[p], dj = j - y0[p];
              if ((unsigned)di < 2u && (unsigned)dj < 2u)
                a = __fadd_rn(a, __fmul_rn(di ? ax1[p] : ax0[p], dj ? ay1[p] : ay0[p]));
            }
          }
          v8[e] = a;
          if (++i == W) {
            i = 0;
            ++j;
          }
        }
        store8(dst + e0, v8);
      }
    }
    // the value chunk, zero past kend
    if constexpr (kMma) {
      for (int idx = threadIdx.x; idx < kKC * D / 8; idx += kThreads) {
        const int k = idx * 8 / D, c = idx * 8 % D;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (kc + k < kend)
          raw = __ldg(reinterpret_cast<const uint4*>(vbase + (size_t)(kc + k) * D + c));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) v_s[(c + u) * kAS + k] = e[u];
      }
    } else {
      for (int idx = threadIdx.x; idx < kKC * D / 4; idx += kThreads) {
        const int k = idx * 4 / D, c = idx * 4 % D;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kc + k < kend)
          x = __ldg(reinterpret_cast<const float4*>(vbase + (size_t)(kc + k) * D + c));
        *reinterpret_cast<float4*>(v_s + k * kDMax + c) = x;
      }
    }
    __syncthreads();
    // the product of the tile with the chunk
    if constexpr (kMma) {
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        uint32_t af[4];
        const __nv_bfloat16* pa = a_s + (warp * 16 + g) * kAS + ks + 2 * t;
        af[0] = ld_smem32(pa);
        af[1] = ld_smem32(pa + 8 * kAS);
        af[2] = ld_smem32(pa + 8);
        af[3] = ld_smem32(pa + 8 * kAS + 8);
#pragma unroll
        for (int nt = 0; nt < kDMax / 8; ++nt) {
          if (nt < ntiles) {
            const __nv_bfloat16* pb = v_s + (nt * 8 + g) * kAS + ks + 2 * t;
            const uint32_t bf[2] = {ld_smem32(pb), ld_smem32(pb + 8)};
            mma_bf16_16816(acc[nt], af, bf);
          }
        }
      }
    } else {
      const float* arow = a_s + tq * kAS;
      for (int k = 0; k < kKC; ++k) {
        const float a = arow[k];
        const float* vr = v_s + k * kDMax + d0;
#pragma unroll
        for (int dd = 0; dd < kDMax / 2; ++dd)
          if (dd < dh) accf[dd] = fmaf(a, vr[dd], accf[dd]);
      }
    }
    __syncthreads();  // the next chunk overwrites both tiles
  }

  const size_t qs = (size_t)M * D;  // elements between neighbouring queries
  float* ob = out + (size_t)n * RQ * qs + (size_t)m * D;
  if constexpr (kMma) {
    const int qa = q0 + warp * 16 + g, qb = qa + 8;
#pragma unroll
    for (int nt = 0; nt < kDMax / 8; ++nt) {
      if (nt >= ntiles) continue;
      const int c = nt * 8 + 2 * t;
      if (qa < RQ)
        *reinterpret_cast<float2*>(ob + qa * qs + c) = make_float2(acc[nt][0], acc[nt][1]);
      if (qb < RQ)
        *reinterpret_cast<float2*>(ob + qb * qs + c) = make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
    const int q = q0 + tq;
    if (q < RQ) {
#pragma unroll
      for (int dd = 0; dd < kDMax / 2; ++dd)
        if (dd < dh) ob[q * qs + d0 + dd] = accf[dd];
    }
  }
}

template <typename T, bool OUTER>
int launch(const void* slab, const void* rows, const void* meta, void* out, int N, int Qp,
           int RQ, int M, int P, int H, int W, int D, int subq, int Hw, cudaStream_t stream) {
  const dim3 grid(Qp / kBQ, M, N);
  msda_tent_plane_kernel<T, OUTER><<<grid, kThreads, 0, stream>>>(
      (const float*)rows, (const T*)slab, (const int*)meta, (float*)out, Qp, RQ, M, P, H, W, D,
      subq, Hw);
  return (int)cudaGetLastError();
}

}  // namespace univs

// dtype: the slab's type, 0 = float32, 1 = bfloat16; outer: 0 = psum, 1 =
// outer; meta: int32 [N, Qp / subq, M, 2] (ystart, ok), or null for the
// whole level.  The output is float32 [N, RQ, M, D].
extern "C" int msda_tent_plane_launch(int dtype, int outer, const void* slab, const void* rows,
                                      const void* meta, void* out, int N, int Qp, int RQ, int M,
                                      int P, int H, int W, int D, int subq, int Hw,
                                      void* stream) {
  using univs::kBQ;
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || M < 1 || Qp < kBQ || Qp % kBQ != 0 || RQ < 1 || RQ > Qp || P < 1 ||
      P > univs::kPMax || H < 1 || W < 1 || D < 8 || D % 8 != 0 || D > univs::kDMax)
    return (int)cudaErrorInvalidValue;
  if (meta != nullptr && (subq < kBQ || subq % kBQ != 0 || Qp % subq != 0 || Hw < 1 || Hw > H))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !outer)
    return univs::launch<float, false>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq,
                                       Hw, s);
  if (dtype == 0 && outer)
    return univs::launch<float, true>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw,
                                      s);
  if (dtype == 1 && !outer)
    return univs::launch<__nv_bfloat16, false>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D,
                                               subq, Hw, s);
  if (dtype == 1 && outer)
    return univs::launch<__nv_bfloat16, true>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D,
                                              subq, Hw, s);
  return (int)cudaErrorInvalidValue;
}

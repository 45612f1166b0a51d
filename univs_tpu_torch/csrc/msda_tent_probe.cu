// Kernel F: the separable-tent probe laws, one gather per sample row.
//
// Replaces three Pallas probes of tools/ (the TPU's record of separable
// x-then-y tent formulations of the MSDA bilinear sum):
//   probe_tent_kernel.py:42   tent_kernel     (pallas_call :82,  entry msda_tent)
//   probe_tent_variants.py:43 make_kernel     (pallas_call :150, entry run_level)
//   probe_tent_v5.py:64       make_exp_kernel (pallas_call :163, entry run_exp)
// Over one level H x W, per sample row r (pixel coordinates x, y and
// attention weight wa), head m and channel d:
//   mx_i = R(tent(i - x) * wa)            (tent_kernel: no wa; 0 outside [0, W))
//   t1_j = sum_i mx_i * V[j, i, d]        f32; R(t1_j) under kRoundT1
//   ty_j = tent(j - y)                    f32; R(ty_j) under kRoundTy
//   p2_j = R(ty_j * t1_j)                 (0 for a row outside [0, H))
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
// is a gather with kernel A's design: a group of lanes serves one (frame,
// group of rows, head), each lane a few of the head's channels, and it
// computes each sample's floor, clamps, validity, tents, wa and their
// rounding once for all of them.  An outside column or row is read at a
// clamped address with weight 0 (the plain version's gather), so no load
// waits on a branch.  The slab is read in its probe's layout:
//   j-major [N, M, W, H*D], element (i; j*D + d): the channels of a corner
//     are contiguous, so a lane owns a piece of min(16, D * size) bytes
//     and reads each of the four corners as one load;
//   d-major [N, M, W, D*H], element (i; d*H + j): the two rows of a
//     channel are neighbours, so a lane owns min(D, 4) channels and reads
//     the pair (j, j + 1) of each channel and column from one aligned
//     8-byte word (a second load only when the pair straddles two words).
//
// Bound on the H100: compulsory traffic is slab + rows + output.  The
// probes draw their samples uniformly over the level, so nearly every
// corner read is a 32-byte sector from L2 (two per corner j-major; one a
// channel and column d-major, of which a sample uses 4 bytes): the sector
// traffic, not the arithmetic, holds both layouts.
#include "tent_gather.cuh"

namespace univs {

enum : int { kWa = 1, kRoundT1 = 2, kRoundTy = 4, kRoundRow = 8 };

// Elements p[0] and p[1] of a d-major column (rows jj and jj + 1 of one
// channel) from the aligned 8-byte word holding p[0]; the word after it
// is read only when the pair straddles the two (`two` = 0: p[1] is not
// needed and may lie past the slab).
__device__ __forceinline__ void ld_pair(const float* p, bool two, float& v0, float& v1) {
  const uintptr_t a = (uintptr_t)p, base = a & ~(uintptr_t)7;
  const bool odd = (a >> 2) & 1;
  const float2 w = __ldg(reinterpret_cast<const float2*>(base));
  const float e = (odd && two) ? __ldg(reinterpret_cast<const float*>(base + 8)) : 0.f;
  v0 = odd ? w.y : w.x;
  v1 = odd ? e : w.y;
}
__device__ __forceinline__ void ld_pair(const __nv_bfloat16* p, bool two, float& v0, float& v1) {
  const uintptr_t a = (uintptr_t)p, base = a & ~(uintptr_t)7;
  const int k = (int)(a >> 1) & 3;  // p[0]'s place in the word
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(base));
  const uint32_t e =
      (k == 3 && two) ? __ldg(reinterpret_cast<const unsigned int*>(base + 8)) : 0u;
  const uint32_t lo = (k & 2) ? w.y : w.x, hi = (k & 2) ? e : w.y;
  const uint32_t u = __funnelshift_r(lo, hi, (k & 1) * 16);
  v0 = __uint_as_float(u << 16);
  v1 = __uint_as_float(u & 0xffff0000u);
}

// GL lanes per (frame, group, head), `pieces` pieces of NE channels a
// head; d-major (DMAJOR) or j-major slab.
template <typename T, typename R, int NE, bool DMAJOR>
__global__ void __launch_bounds__(256, 3)
msda_tent_probe_kernel(const T* __restrict__ slab,     // [N, M, W, H*D]
                       const float* __restrict__ xs,   // [N, Rr, M]
                       const float* __restrict__ ys,   // [N, Rr, M]
                       const float* __restrict__ was,  // [N, Rr, M] (kWa only)
                       float* __restrict__ out,        // [N, Rr / G, M, D]
                       int N, int Rr, int M, int H, int W, int D, int G, int GL, int pieces,
                       int flags) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long item = tid / GL;  // (n*NG + g)*M + m
  const int NG = Rr / G;
  if (item >= (long)N * NG * M) return;
  const int gl = (int)(tid - item * GL);
  const int m = (int)(item % M);
  const int g = (int)((item / M) % NG);
  const int n = (int)(item / ((long)M * NG));
  const size_t col = (size_t)H * D;  // elements between neighbouring columns i
  const T* vb = slab + ((size_t)n * M + m) * W * col;
  const bool use_wa = flags & kWa, r_t1 = flags & kRoundT1, r_ty = flags & kRoundTy,
             r_row = flags & kRoundRow, two = H > 1;

  for (int pc = gl; pc < pieces; pc += GL) {
    const int d0 = pc * NE;
    float acc[NE];
#pragma unroll
    for (int c = 0; c < NE; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < G; ++k) {
      const size_t ri = ((size_t)n * Rr + (size_t)g * G + k) * M + m;
      const float x = __ldg(xs + ri), y = __ldg(ys + ri);
      // clamp before the int cast: a clamped tap lies outside the level
      const int x0 = (int)fminf(fmaxf(floorf(x), -2.f), (float)W);
      const int y0 = (int)fminf(fmaxf(floorf(y), -2.f), (float)H);
      const bool vx0 = (unsigned)x0 < (unsigned)W, vx1 = (unsigned)(x0 + 1) < (unsigned)W;
      const bool vy0 = (unsigned)y0 < (unsigned)H, vy1 = (unsigned)(y0 + 1) < (unsigned)H;
      const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
      // v[row][column][channel]: rows y0, y0 + 1; columns xa, xb
      float v[2][2][NE];
      if constexpr (DMAJOR) {
        // the pair (jj, jj + 1) holds every row of [0, H) that the sample
        // touches; a row clamped into it takes the pair's other element
        const int jj = max(min(y0, H - 2), 0);
        const bool swap = y0 != jj;
        const T* ca = vb + (size_t)xa * col + (size_t)d0 * H + jj;
        const T* cb = vb + (size_t)xb * col + (size_t)d0 * H + jj;
#pragma unroll
        for (int c = 0; c < NE; ++c) {
          float p, q;
          ld_pair(ca + (size_t)c * H, two, p, q);
          v[0][0][c] = swap ? q : p;
          v[1][0][c] = swap ? p : q;
          ld_pair(cb + (size_t)c * H, two, p, q);
          v[0][1][c] = swap ? q : p;
          v[1][1][c] = swap ? p : q;
        }
      } else {
        constexpr int VB = NE * sizeof(T);
        const int ya = min(max(y0, 0), H - 1), yb = min(max(y0 + 1, 0), H - 1);
        const T* c0 = vb + d0;
        const Piece<VB> c00 = ld_piece<VB>(c0 + ((size_t)xa * H + ya) * D);
        const Piece<VB> c01 = ld_piece<VB>(c0 + ((size_t)xb * H + ya) * D);
        const Piece<VB> c10 = ld_piece<VB>(c0 + ((size_t)xa * H + yb) * D);
        const Piece<VB> c11 = ld_piece<VB>(c0 + ((size_t)xb * H + yb) * D);
#pragma unroll
        for (int c = 0; c < NE; ++c) {
          v[0][0][c] = elem<T>(c00, c);
          v[0][1][c] = elem<T>(c01, c);
          v[1][0][c] = elem<T>(c10, c);
          v[1][1][c] = elem<T>(c11, c);
        }
      }
      float tx0 = tent((float)x0, x), tx1 = tent((float)(x0 + 1), x);
      if (use_wa) {
        const float wa = __ldg(was + ri);
        tx0 = __fmul_rn(tx0, wa);
        tx1 = __fmul_rn(tx1, wa);
      }
      const float w0 = vx0 ? round_to<R>(tx0) : 0.f;
      const float w1 = vx1 ? round_to<R>(tx1) : 0.f;
      float ty0 = tent((float)y0, y), ty1 = tent((float)(y0 + 1), y);
      if (r_ty) round2_to<R>(ty0, ty1);
      float t1[2][NE];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < NE; ++c)
          t1[r][c] = __fadd_rn(__fmul_rn(w0, v[r][0][c]), __fmul_rn(w1, v[r][1][c]));
      if (r_t1) {
#pragma unroll
        for (int c = 0; c < NE; ++c) round2_to<R>(t1[0][c], t1[1][c]);
      }
      float row[NE];
#pragma unroll
      for (int c = 0; c < NE; ++c) {
        float p2a = __fmul_rn(ty0, t1[0][c]), p2b = __fmul_rn(ty1, t1[1][c]);
        round2_rows<R>(p2a, p2b, vy0, vy1);
        row[c] = __fadd_rn(p2a, p2b);
      }
      if (r_row) {
#pragma unroll
        for (int c = 0; c + 1 < NE; c += 2) round2_to<R>(row[c], row[c + 1]);
        if (NE % 2) row[NE - 1] = round_to<R>(row[NE - 1]);
      }
#pragma unroll
      for (int c = 0; c < NE; ++c) acc[c] = __fadd_rn(acc[c], row[c]);
    }
    store_piece<float, NE>(out + item * D + d0, acc);
  }
}

template <typename T, typename R, int NE, bool DMAJOR>
int launch_ne(const T* slab, const float* xs, const float* ys, const float* was, float* out,
              int N, int Rr, int M, int H, int W, int D, int G, int flags,
              cudaStream_t stream) {
  const int pieces = D / NE, GL = group_lanes(pieces);
  const long threads_total = (long)N * (Rr / G) * M * GL;
  const int threads = 256;
  const long blocks = (threads_total + threads - 1) / threads;
  if (blocks > 0)
    msda_tent_probe_kernel<T, R, NE, DMAJOR><<<(unsigned)blocks, threads, 0, stream>>>(
        slab, xs, ys, was, out, N, Rr, M, H, W, D, G, GL, pieces, flags);
  return (int)cudaGetLastError();
}

template <typename T, typename R>
int launch(const void* slab_, const void* xs, const void* ys, const void* was_, void* out_,
           int N, int Rr, int M, int H, int W, int D, int G, int dmajor, int flags,
           cudaStream_t stream) {
  if (!tent_head_ok(D) || G < 1 || Rr % G != 0 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  if ((flags & kWa) && was_ == nullptr) return (int)cudaErrorInvalidValue;
  const T* slab = (const T*)slab_;
  const float *x = (const float*)xs, *y = (const float*)ys, *wa = (const float*)was_;
  float* out = (float*)out_;
  if (dmajor) {
    // min(D, 4) channels a lane; results stored as one piece of NE floats
    const int ne = D < 4 ? D : 4;
    if ((uintptr_t)out % (4 * ne)) return (int)cudaErrorInvalidValue;
    if (ne == 4) return launch_ne<T, R, 4, true>(slab, x, y, wa, out, N, Rr, M, H, W, D, G,
                                                 flags, stream);
    if (ne == 2) return launch_ne<T, R, 2, true>(slab, x, y, wa, out, N, Rr, M, H, W, D, G,
                                                 flags, stream);
    return launch_ne<T, R, 1, true>(slab, x, y, wa, out, N, Rr, M, H, W, D, G, flags, stream);
  }
  // j-major: a piece of min(16, D * size) bytes at an address of its size
  const int bytes = D * (int)sizeof(T), vb = bytes < 16 ? bytes : 16;
  const int ne = vb / (int)sizeof(T), oa = 4 * ne < 16 ? 4 * ne : 16;
  if ((uintptr_t)slab % vb || (uintptr_t)out % oa) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (ne == 8) return launch_ne<T, R, 8, false>(slab, x, y, wa, out, N, Rr, M, H, W, D, G,
                                                  flags, stream);
  }
  if (ne == 4) return launch_ne<T, R, 4, false>(slab, x, y, wa, out, N, Rr, M, H, W, D, G,
                                                flags, stream);
  if (ne == 2) return launch_ne<T, R, 2, false>(slab, x, y, wa, out, N, Rr, M, H, W, D, G,
                                                flags, stream);
  if (ne == 1) return launch_ne<T, R, 1, false>(slab, x, y, wa, out, N, Rr, M, H, W, D, G,
                                                flags, stream);
  return (int)cudaErrorInvalidValue;
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

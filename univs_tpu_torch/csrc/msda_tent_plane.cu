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
// Footprints.  A point's tents are non-zero only at columns x0, x0 + 1
// and rows y0, y0 + 1 (tent(i - x) is exactly 0 at every other integer
// i), so a query's plane row holds at most 4P non-zero entries.  Once per
// block each query's row is built as its footprint: the (pixel, term)
// pairs inside the level and the K range, coincident pixels of two points
// summed in p order from 0 (the dense sum adds exact zeros elsewhere, so
// every entry is bit-identical to it), sorted by pixel, rounded to T once,
// with an end mark.  The tests rebuild this law on the CPU
// (tests/test_torch_tent_plane.py).
//
// bfloat16 (the probes' case): A from registers, `wgmma` m64nNk16 (N = D
// rounded up to 8, 16, 32 or 64), V by TMA.  A block takes 256 queries
// (fewer when a window chunk is smaller) of one (frame, head): four
// consumer warpgroups of one 64-query tile each, and one producer thread
// that streams V chunks of 64 pixels [64, N] by TMA through a ring of
// eight stages on mbarriers, untransposed (V is N-major: the product reads
// it as a transposed B; rows past the level and channels past D arrive as
// zeros).  For each k-step of 16 pixels a consumer thread sets its A
// fragment to zero and walks a forward-only pointer through the
// footprints of its two rows, placing the few pairs that fall in the
// step; a chunk's fragments are built while its V chunk is in flight.
// Every entry of the plane, over the whole level or the window's rows,
// goes through the tensor cores (no all-zero step is skipped: that is the
// probe's question, does a dense plane on the matrix unit beat the
// gather, kernel A).  Tiles whose queries all lie at or past RQ are not
// computed (no block is launched for them, and a straddling block's
// warpgroups past RQ return at once).
//
// float32: the plane tile [64 q, 64 s] zeroed and filled from the same
// footprints in shared memory beside the value chunk, and an FMA loop
// (TF32 would break the float32 law).
//
// Bound on the H100: the function's compulsory work is slab + rows +
// output bytes and 2*N*Q*M*P*4*D f32 operations (what kernel A does); the
// plane formulation adds 2*N*M*RQ*S*D tensor flops (the plane bound, 0.31
// ms for the probes' whole 1/8 level).  This kernel stays ~3.5x above it:
// the footprint walks and the m64n32k16 products (serialised by ptxas
// under the ~56 registers a thread that two blocks an SM leave) overlap
// only in part, and each block builds its footprints and streams its
// head's whole K range of V from L2 (timing-only variants:
// univs_tpu_torch/tools/plane_variants.py, PERF.md section 6).
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace univs {

constexpr int kPMax = 4;             // sampling points of a query (P <= 4)
constexpr int kDMax = 64;            // channels (D % 8 == 0, D <= 64)
constexpr int kList = 4 * kPMax + 1;  // a footprint's pairs and its end mark
constexpr int kEndPix = INT_MAX;     // the end mark's pixel

// the bits of an entry rounded to T: bf16 in the low half, or float32
__device__ __forceinline__ uint32_t entry_bits(float v, __nv_bfloat16*) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t entry_bits(float v, float*) { return __float_as_uint(v); }

// Query row r's footprint over [kbeg, kend) into `list` (kList pairs of
// (pixel, T bits), sorted by pixel, closed by kEndPix).
template <typename T, bool OUTER>
__device__ void build_footprint(uint2* list, const float* r, int M, int P, int H, int W,
                                int kbeg, int kend) {
  int cnt = 0;
  for (int p = 0; p < P; ++p) {
    const float x = r[p], y = r[M * P + p], wa = r[2 * M * P + p];
    // clamp before the int cast: a clamped tap lies outside the level
    const int x0 = (int)fminf(fmaxf(floorf(x), -2.f), (float)W);
    const int y0 = (int)fminf(fmaxf(floorf(y), -2.f), (float)H);
    const float tx[2] = {tent((float)x0, x), tent((float)(x0 + 1), x)};
    const float ty[2] = {tent((float)y0, y), tent((float)(y0 + 1), y)};
    float ax[2], ay[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ax[e] = OUTER ? __fmul_rn(tx[e], wa) : tx[e];
      ay[e] = OUTER ? round_to<T>(ty[e]) : __fmul_rn(ty[e], wa);
    }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int j = y0 + dy;
      if (j < 0 || j >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int i = x0 + dx;
        const int s = j * W + i;
        if (i < 0 || i >= W || s < kbeg || s >= kend) continue;
        const float term = __fmul_rn(ax[dx], ay[dy]);
        int pos = cnt;
        while (pos > 0 && (int)list[pos - 1].x > s) --pos;
        if (pos > 0 && (int)list[pos - 1].x == s) {
          list[pos - 1].y = __float_as_uint(__fadd_rn(__uint_as_float(list[pos - 1].y), term));
        } else {
          for (int k = cnt; k > pos; --k) list[k] = list[k - 1];
          list[pos] = make_uint2((uint32_t)s, __float_as_uint(__fadd_rn(0.f, term)));
          ++cnt;
        }
      }
    }
  }
  for (int k = 0; k < cnt; ++k)
    list[k].y = entry_bits(__uint_as_float(list[k].y), static_cast<T*>(nullptr));
  list[cnt] = make_uint2((uint32_t)kEndPix, 0u);
}

// the K range of a block: the window of its query chunk where it hits,
// else the whole level
__device__ __forceinline__ void k_range(const int* meta, int n, int m, int q0, int Qp, int M,
                                        int S, int W, int subq, int Hw, int& kbeg, int& kend) {
  kbeg = 0;
  kend = S;
  if (meta != nullptr) {
    const int* mt = meta + (((size_t)n * (Qp / subq) + q0 / subq) * M + m) * 2;
    if (mt[1]) {
      kbeg = mt[0] * W;
      kend = min(S, (mt[0] + Hw) * W);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma with A from registers, V by TMA
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 256;                 // queries per block
constexpr int kTcWG = kTcBQ / 64;          // consumer warpgroups, one 64-query tile each
constexpr int kTcKC = 64;                  // pixels per V chunk (TMA box rows)
constexpr int kTcKS = kTcKC / 16;          // k-steps per chunk
constexpr int kTcStages = 8;
constexpr int kTcThreads = kTcWG * 128 + 32;  // the consumers, then the producer warp

template <int DP>
__host__ __device__ constexpr int tc_stage_bytes() {
  return kTcKC * DP * 2;
}
template <int DP>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)kTcStages * tc_stage_bytes<DP>() + sizeof(uint2) * kTcBQ * kList +
         2 * kTcStages * sizeof(uint64_t);
}

// The pairs of one footprint row that fall in the k-step [k0, k0 + 16),
// placed in this thread's fragment words: lo = columns (2t, 2t + 1), hi =
// columns (2t + 8, 2t + 9); cur is the row's next pair and moves on.
__device__ __forceinline__ void take_pairs(const uint2* list, int& idx, uint2& cur, int k0,
                                           int t, uint32_t& lo, uint32_t& hi) {
  do {
    const int c = (int)cur.x - k0;
    if (((c >> 1) & 3) == t) {
      const uint32_t b = cur.y << ((c & 1) * 16);
      if (c & 8)
        hi |= b;
      else
        lo |= b;
    }
    cur = list[++idx];
  } while ((int)cur.x < k0 + 16);
}

template <bool OUTER, int DP>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 1 : 2)
plane_wgmma_kernel(const __grid_constant__ CUtensorMap vmap,  // V [N*M, S, D], boxes [1, 64, DP]
                   const float* __restrict__ rows,            // [N, Qp, 3*M*P]
                   const int* __restrict__ meta,              // [N, Qp / subq, M, 2] or null
                   float* __restrict__ out,                   // [N, RQ, M, D]
                   int Qp, int RQ, int M, int P, int H, int W, int D, int subq, int Hw, int bq) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint2* lists = reinterpret_cast<uint2*>(ring + kTcStages * tc_stage_bytes<DP>());
  uint64_t* full = reinterpret_cast<uint64_t*>(lists + kTcBQ * kList);
  uint64_t* empty = full + kTcStages;

  const int n = blockIdx.z, m = blockIdx.y, q0 = blockIdx.x * bq;
  const int S = H * W;
  int kbeg, kend;
  k_range(meta, n, m, q0, Qp, M, S, W, subq, Hw, kbeg, kend);
  // the tiles with a query below RQ (q0 < RQ, Qp % 64 == 0: their rows exist)
  const int ntile = (min(bq, RQ - q0) + 63) / 64;

  if (threadIdx.x < ntile * 64)
    build_footprint<__nv_bfloat16, OUTER>(
        lists + threadIdx.x * kList,
        rows + ((size_t)n * Qp + q0 + threadIdx.x) * 3 * M * P + m * P, M, P, H, W, kbeg, kend);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * ntile);  // one arrival per active consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int nch = (kend - kbeg + kTcKC - 1) / kTcKC;
  const int wg = threadIdx.x / 128;
  if (wg == kTcWG) {
    // ---- producer: the V chunks of [kbeg, kend), rows past S as zeros
    if (threadIdx.x == kTcWG * 128) {
      for (int it = 0; it < nch; ++it) {
        const int s = it % kTcStages;
        sm90::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], tc_stage_bytes<DP>());
        sm90::tma_load_3d(ring + s * tc_stage_bytes<DP>(), &vmap, &full[s], 0,
                          kbeg + it * kTcKC, n * M + m);
      }
    }
    return;
  }
  if (wg >= ntile) return;

  // ---- consumers: tile wg, rows g and g + 8 (h = 0, 1) of each warp's 16
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint2* lrow = lists + (wg * 64 + warp * 16 + g) * kList;  // row h at + 8 h kList
  int idx[2] = {0, 8 * kList};
  uint2 cur[2] = {lrow[idx[0]], lrow[idx[1]]};
  float acc[DP / 2];
#pragma unroll
  for (int k = 0; k < DP / 2; ++k) acc[k] = 0.f;

  for (int it = 0; it < nch; ++it) {
    const int s = it % kTcStages;
    const int kc = kbeg + it * kTcKC;
    // the chunk's A fragments, while its V chunk is in flight
    uint32_t af[kTcKS][4];
#pragma unroll
    for (int ks = 0; ks < kTcKS; ++ks) {
      const int k0 = kc + ks * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t lo = 0u, hi = 0u;
        if ((int)cur[h].x < k0 + 16) take_pairs(lrow, idx[h], cur[h], k0, t, lo, hi);
        af[ks][h] = lo;
        af[ks][h + 2] = hi;
      }
    }
    sm90::mbar_wait(&full[s], (it / kTcStages) & 1);
    sm90::wgmma_fence();
    sm90::fence_regs(acc);
    const unsigned char* vs = ring + s * tc_stage_bytes<DP>();
#pragma unroll
    for (int ks = 0; ks < kTcKS; ++ks)
      sm90::wgmma_m64nNk16_rs_tb<DP>(acc, af[ks], sm90::desc_nmajor<DP>(vs + ks * 16 * DP * 2));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kTcKS; ++ks) sm90::fence_regs(af[ks]);
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  const size_t qs = (size_t)M * D;  // elements between neighbouring queries
  float* ob = out + (size_t)n * RQ * qs + (size_t)m * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + wg * 64 + warp * 16 + g + 8 * h;
    if (q >= RQ) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<float2*>(ob + q * qs + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// queries per block: 256, or the largest of 192, 128 and 64 that divides
// a window's chunk, so that a block's queries share one window
inline int tc_block_queries(bool window, int subq) {
  if (!window) return kTcBQ;
  for (int bq = kTcBQ; bq > 64; bq -= 64)
    if (subq % bq == 0) return bq;
  return 64;
}

template <bool OUTER, int DP>
int launch_wgmma(const void* slab, const void* rows, const void* meta, void* out, int N, int Qp,
                 int RQ, int M, int P, int H, int W, int D, int subq, int Hw,
                 cudaStream_t stream) {
  CUtensorMap vmap;
  const int err = sm90::encode_bf16<3>(
      &vmap, slab, {(cuuint64_t)D, (cuuint64_t)H * W, (cuuint64_t)N * M},
      {(cuuint32_t)DP, (cuuint32_t)kTcKC, 1u}, sm90::nmajor_swizzle(DP));
  if (err != 0) return err;
  auto kern = plane_wgmma_kernel<OUTER, DP>;
  constexpr size_t smem = tc_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bq = tc_block_queries(meta != nullptr, subq);
  const dim3 grid((RQ + bq - 1) / bq, M, N);
  kern<<<grid, kTcThreads, smem, stream>>>(vmap, (const float*)rows, (const int*)meta,
                                            (float*)out, Qp, RQ, M, P, H, W, D, subq, Hw, bq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the plane tile in shared memory, FMA products
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // queries per block
constexpr int kKC = 64;       // pixels per K chunk
constexpr int kThreads = 128;  // two threads a query
constexpr int kAS = kKC + 4;  // row stride (elements) of the plane tile: 16-byte rows, no conflicts

// DP: D rounded up to 8, 16, 32 or 64 (the value chunk holds zeros past D)
template <bool OUTER, int DP>
__global__ void __launch_bounds__(kThreads)
plane_fma_kernel(const float* __restrict__ rows,  // [N, Qp, 3*M*P]
                 const float* __restrict__ slab,  // [N, M, S, D]
                 const int* __restrict__ meta,    // [N, Qp / subq, M, 2] or null
                 float* __restrict__ out,         // [N, RQ, M, D]
                 int Qp, int RQ, int M, int P, int H, int W, int D, int subq, int Hw) {
  constexpr int DH = DP / 2;  // channels a thread
  __shared__ __align__(16) float a_s[kBQ * kAS];  // plane tile [q][k]
  __shared__ __align__(16) float v_s[kKC * DP];   // V [k][d]
  __shared__ uint2 lists[kBQ * kList];
  const int n = blockIdx.z, m = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int S = H * W;
  int kbeg, kend;
  k_range(meta, n, m, q0, Qp, M, S, W, subq, Hw, kbeg, kend);
  if (threadIdx.x < kBQ)
    build_footprint<float, OUTER>(lists + threadIdx.x * kList,
                                  rows + ((size_t)n * Qp + q0 + threadIdx.x) * 3 * M * P + m * P,
                                  M, P, H, W, kbeg, kend);
  __syncthreads();

  // this thread's query (two threads a query), half of each chunk's
  // entries and half of the channels
  const int tq = threadIdx.x >> 1, half = threadIdx.x & 1;
  const uint2* lst = lists + tq * kList;
  int idx = 0;
  uint2 cur = lst[0];
  float acc[DH];
#pragma unroll
  for (int k = 0; k < DH; ++k) acc[k] = 0.f;
  const float* vbase = slab + ((size_t)n * M + m) * S * D;

  for (int kc = kbeg; kc < kend; kc += kKC) {
    // this thread's 32 entries of row tq: zeros, then its pairs
    {
      float* dst = a_s + tq * kAS + half * 32;
#pragma unroll
      for (int e = 0; e < 32; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      const int lo = kc + half * 32;
      while ((int)cur.x < lo + 32) {
        if ((int)cur.x >= lo) dst[(int)cur.x - lo] = __uint_as_float(cur.y);
        cur = lst[++idx];
      }
    }
    // the value chunk, zero past kend and past D
    for (int i = threadIdx.x; i < kKC * DP / 4; i += kThreads) {
      const int k = i / (DP / 4), c = i % (DP / 4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kc + k < kend && c < D)
        x = __ldg(reinterpret_cast<const float4*>(vbase + (size_t)(kc + k) * D + c));
      *reinterpret_cast<float4*>(v_s + k * DP + c) = x;
    }
    __syncthreads();
    const float* arow = a_s + tq * kAS;
    const float* vcol = v_s + half * DH;
#pragma unroll 2
    for (int k4 = 0; k4 < kKC; k4 += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(arow + k4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = vcol + (k4 + u) * DP;
#pragma unroll
        for (int dd = 0; dd < DH; dd += 4) {
          const float4 v = *reinterpret_cast<const float4*>(vr + dd);
          acc[dd] = fmaf(a[u], v.x, acc[dd]);
          acc[dd + 1] = fmaf(a[u], v.y, acc[dd + 1]);
          acc[dd + 2] = fmaf(a[u], v.z, acc[dd + 2]);
          acc[dd + 3] = fmaf(a[u], v.w, acc[dd + 3]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites both tiles
  }

  const size_t qs = (size_t)M * D;
  float* ob = out + (size_t)n * RQ * qs + (size_t)m * D;
  const int q = q0 + tq;
  if (q < RQ) {
#pragma unroll
    for (int dd = 0; dd < DH; ++dd)
      if (half * DH + dd < D) ob[q * qs + half * DH + dd] = acc[dd];
  }
}

template <bool OUTER, int DP>
int launch_fma(const void* slab, const void* rows, const void* meta, void* out, int N, int Qp,
               int RQ, int M, int P, int H, int W, int D, int subq, int Hw, cudaStream_t stream) {
  const dim3 grid((RQ + kBQ - 1) / kBQ, M, N);
  plane_fma_kernel<OUTER, DP><<<grid, kThreads, 0, stream>>>(
      (const float*)rows, (const float*)slab, (const int*)meta, (float*)out, Qp, RQ, M, P, H, W,
      D, subq, Hw);
  return (int)cudaGetLastError();
}

// the launch of a body for D rounded up to DP = 8, 16, 32 or 64
template <bool OUTER, bool BF16>
int launch(const void* slab, const void* rows, const void* meta, void* out, int N, int Qp, int RQ,
           int M, int P, int H, int W, int D, int subq, int Hw, cudaStream_t stream) {
  auto go = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (BF16)
      return launch_wgmma<OUTER, DP>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw,
                                     stream);
    else
      return launch_fma<OUTER, DP>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw,
                                   stream);
  };
  if (D <= 8) return go(std::integral_constant<int, 8>());
  if (D <= 16) return go(std::integral_constant<int, 16>());
  if (D <= 32) return go(std::integral_constant<int, 32>());
  return go(std::integral_constant<int, 64>());
}

}  // namespace univs

// body: 0 = fma (a float32 slab), 1 = wgmma (a bfloat16 slab); dtype: the
// slab's type, 0 = float32, 1 = bfloat16; outer: 0 = psum, 1 = outer;
// meta: int32 [N, Qp / subq, M, 2] (ystart, ok), or null for the whole
// level.  The output is float32 [N, RQ, M, D].  A body that does not fit
// the slab's type returns cudaErrorInvalidValue.
extern "C" int msda_tent_plane_launch(int body, int dtype, int outer, const void* slab,
                                      const void* rows, const void* meta, void* out, int N,
                                      int Qp, int RQ, int M, int P, int H, int W, int D, int subq,
                                      int Hw, void* stream) {
  constexpr int kQ = univs::kBQ;  // 64: the query granule of both bodies
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || M < 1 || Qp < kQ || Qp % kQ != 0 || RQ < 1 || RQ > Qp || P < 1 ||
      P > univs::kPMax || H < 1 || W < 1 || D < 8 || D % 8 != 0 || D > univs::kDMax)
    return (int)cudaErrorInvalidValue;
  if (meta != nullptr && (subq < kQ || subq % kQ != 0 || Qp % subq != 0 || Hw < 1 || Hw > H))
    return (int)cudaErrorInvalidValue;
  if (body != dtype || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !outer)
    return univs::launch<false, false>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw,
                                       s);
  if (dtype == 0)
    return univs::launch<true, false>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw,
                                      s);
  if (!outer)
    return univs::launch<false, true>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw,
                                      s);
  return univs::launch<true, true>(slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw, s);
}

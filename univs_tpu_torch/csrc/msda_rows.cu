// Kernel B: sampling rows for the deformable attention (offsets, weights,
// coordinates) straight from the query tokens.
//
// Replaces univs_tpu/ops/msda_rows.py:_row_kernel (:39, pallas_call :154,
// entry fused_sampling_rows / op msda_sample_fused).  Per query it computes
//   offsets = q @ Wo + bo        (C -> M*L*P*2)
//   logits  = q @ Wa + ba        (C -> M*L*P), softmax per head over L*P
//   x = ref_x * W_l + off_x - 0.5,  y = ref_y * H_l + off_y - 0.5
// with the reference point rebuilt from the query index (the static
// pixel-centre grid of the query's own level), and writes (x, y, w) as
// loc[N, Lq, M, L, P, 3] float32 — the layout kernel A reads: one
// contiguous 12-sample run per (query, head).  The TPU's lane-packed,
// point-minor [N, Rp, L*3M] layout and its inert pad rows exist only for
// the tent kernels and are not reproduced.
//
// The weights come in nn.Linear's layout, Wo [M*L*P*2, C] and Wa [M*L*P,
// C] (the reduction axis contiguous).  Products see the inputs in the
// compute dtype; accumulation is float32; biases are float32.
//
// Bound on the H100: compulsory traffic is q in plus rows out (~21 MB per
// frame at full width, ~6 us at 3.35 TB/s); the 1.9 GFLOP per frame of
// projections take ~2 us at the bf16 tensor-core peak.  Two bodies:
//  - bf16 at the full-width head geometry (M=8, L=3, P=4: 288 projection
//    columns, the main path) with C % 32 == 0: a tiled product on the
//    tensor cores.  A block takes 64 queries (the frames' queries
//    flattened, so only the last tile is ragged) and 8 warps; the query
//    tile and 32-deep K chunks of both weights are staged in shared memory
//    by cp.async, double-buffered, and every warp multiplies 32 rows by 72
//    columns with mma.sync m16n8k16 (float32 accumulators in registers).
//    The epilogue adds the biases into a float32 [64][288] tile in shared
//    memory (over the stages), takes the softmax per (query, head) in
//    place, and writes the block's rows — one contiguous run of 64 x 288
//    floats — with coalesced 16-byte stores, each computed from the tile
//    as it is stored.  The weights (147 KB) stay in L2 across blocks.
//  - every other case (float32; other head geometries, such as the tiny
//    test config): a block takes 32 queries, stages them in shared memory
//    as float32, and each thread owns one output column, keeping 32
//    float32 accumulators in registers (FMA on the CUDA cores).
#include "common.cuh"

namespace univs {

// ---------------------------------------------------------------------------
// FMA body (float32, and bf16 at head geometries the mma tile does not fit)
// ---------------------------------------------------------------------------

constexpr int kRowsBQ = 32;

template <typename T, int BQ>
__global__ void msda_rows_kernel(const T* __restrict__ q,      // [N, Lq, C]
                                 const T* __restrict__ wo,     // [Do, C]
                                 const float* __restrict__ bo, // [Do]
                                 const T* __restrict__ wa,     // [Da, C]
                                 const float* __restrict__ ba, // [Da]
                                 float* __restrict__ loc,      // [N, Lq, M, L, P, 3]
                                 int N, int Lq, int C, int M, int P, Levels lv) {
  extern __shared__ float smem[];
  const int L = lv.L;
  const int LP = L * P;
  const int Da = M * LP, Do = 2 * Da, NC = Do + Da;
  float* q_s = smem;           // [BQ][C]
  float* o_s = smem + BQ * C;  // [BQ][NC]

  const int per_frame = (Lq + BQ - 1) / BQ;
  const int n = blockIdx.x / per_frame;
  const int q0 = (blockIdx.x % per_frame) * BQ;

  for (int i = threadIdx.x; i < BQ * C; i += blockDim.x) {
    const int b = i / C, c = i % C, qi = q0 + b;
    q_s[i] = qi < Lq ? to_f32(q[((size_t)n * Lq + qi) * C + c]) : 0.f;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < NC; j += blockDim.x) {
    const bool is_off = j < Do;
    const T* wrow = is_off ? wo + (size_t)j * C : wa + (size_t)(j - Do) * C;
    float acc[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = 0.f;
    for (int k = 0; k < C; ++k) {
      const float w = to_f32(wrow[k]);
#pragma unroll
      for (int b = 0; b < BQ; ++b) acc[b] += q_s[b * C + k] * w;
    }
    const float bias = is_off ? bo[j] : ba[j - Do];
#pragma unroll
    for (int b = 0; b < BQ; ++b) o_s[b * NC + j] = acc[b] + bias;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * M; i += blockDim.x) {
    const int b = i / M, m = i % M, qi = q0 + b;
    if (qi >= Lq) continue;
    int lq = 0;
    for (int l = 1; l < L; ++l)
      if (qi >= lv.start[l]) lq = l;
    const int s = qi - lv.start[lq];
    const float ref_x = ((float)(s % lv.w[lq]) + 0.5f) / (float)lv.w[lq];
    const float ref_y = ((float)(s / lv.w[lq]) + 0.5f) / (float)lv.h[lq];
    const float* logit = o_s + b * NC + Do + m * LP;
    const float* off = o_s + b * NC + m * LP * 2;
    float mx = -INFINITY;
    for (int t = 0; t < LP; ++t) mx = fmaxf(mx, logit[t]);
    float sum = 0.f;
    for (int t = 0; t < LP; ++t) sum += expf(logit[t] - mx);
    float* dst = loc + (((size_t)n * Lq + qi) * M + m) * LP * 3;
    for (int l = 0; l < L; ++l) {
      for (int p = 0; p < P; ++p) {
        const int t = l * P + p;
        dst[3 * t + 0] = ref_x * (float)lv.w[l] + off[2 * t + 0] - 0.5f;
        dst[3 * t + 1] = ref_y * (float)lv.h[l] + off[2 * t + 1] - 0.5f;
        dst[3 * t + 2] = expf(logit[t] - mx) / sum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core body (bf16, M=8, L=3, P=4, C % 32 == 0)
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;        // queries per block: 2 warp rows x 2 m-tiles of 16
constexpr int kMmaKC = 32;        // K chunk per stage: 2 k-steps of 16
constexpr int kMmaQS = kMmaKC + 8;  // bf16 row stride of a stage: conflict-free fragments
constexpr int kMmaThreads = 256;  // 8 warps: 2 (rows) x 4 (column quarters)

template <int M, int L, int P>
struct RowsGeo {
  static constexpr int LP = L * P, Da = M * LP, Do = 2 * Da, NC = Do + Da;
  static constexpr int NTW = NC / 32;      // 8-column n-tiles per warp
  static constexpr int PS = NC + 8;        // float32 row stride of the result tile
  static constexpr int kStage = (kMmaBQ + NC) * kMmaQS;  // bf16 elements per stage
  static constexpr size_t kSmem =
      2 * kStage * sizeof(__nv_bfloat16) > kMmaBQ * PS * sizeof(float)
          ? 2 * kStage * sizeof(__nv_bfloat16)
          : kMmaBQ * PS * sizeof(float);
  static_assert(NC % 32 == 0, "the column quarters must be whole n-tiles");
};

template <int M, int L, int P>
__global__ void __launch_bounds__(kMmaThreads, 2)
msda_rows_mma_kernel(const __nv_bfloat16* __restrict__ q,   // [rows, C]
                     const __nv_bfloat16* __restrict__ wo,  // [Do, C]
                     const float* __restrict__ bo,
                     const __nv_bfloat16* __restrict__ wa,  // [Da, C]
                     const float* __restrict__ ba,
                     float* __restrict__ loc,               // [rows, NC]
                     int rows, int Lq, int C, Levels lv) {
  using G = RowsGeo<M, L, P>;
  constexpr int LP = G::LP, Do = G::Do, NC = G::NC, NTW = G::NTW, PS = G::PS;
  constexpr int BQ = kMmaBQ, KC = kMmaKC, QS = kMmaQS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 x (q [BQ][QS], w [NC][QS])
  float* res = reinterpret_cast<float*>(smem_raw);  // [BQ][PS] after the product
  __shared__ float ref_s[BQ][2];                    // the tile's reference points (x, y)
  __shared__ float size_s[L][2];                    // level sizes (W, H)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const long r0 = (long)blockIdx.x * BQ;

  // one stage: the tile's queries and both weights at k-columns [k0, k0+KC)
  auto load_stage = [&](int s, int k0) {
    __nv_bfloat16* qs = stages + s * G::kStage;
    __nv_bfloat16* ws = qs + BQ * QS;
    constexpr int PIECES = KC / 8;  // 16-byte pieces per row
    for (int i = tid; i < (BQ + NC) * PIECES; i += kMmaThreads) {
      const int row = i / PIECES, col = (i % PIECES) * 8;
      if (row < BQ) {
        const long gr = r0 + row;
        const bool in = gr < rows;  // past the ragged edge: a zero row
        cp_async16(qs + row * QS + col, q + (size_t)(in ? gr : 0) * C + k0 + col, in ? 16 : 0);
      } else {
        const int j = row - BQ;
        const __nv_bfloat16* src = j < Do ? wo + (size_t)j * C : wa + (size_t)(j - Do) * C;
        cp_async16(ws + j * QS + col, src + k0 + col, 16);
      }
    }
    cp_async_commit();
  };

  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nK = C / KC;
  load_stage(0, 0);
  for (int kc = 0; kc < nK; ++kc) {
    if (kc + 1 < nK) {
      load_stage((kc + 1) & 1, (kc + 1) * KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = stages + (kc & 1) * G::kStage;
    const __nv_bfloat16* ws = qs + BQ * QS;
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 16) {
      uint32_t af[2][4], bf[NTW][2];
      load_a<2>(af, qs + wm * 32 * QS, QS, k0, g, t);
      load_b<NTW>(bf, ws, QS, wn * NTW * 8, k0, g, t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();  // the next load overwrites this stage
  }

  // products + biases -> res (over the stages: every warp is past its last read)
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = (wn * NTW + nt) * 8 + 2 * t;  // an n-tile lies on one side of Do
    const float bx = col < Do ? bo[col] : ba[col - Do];
    const float by = col < Do ? bo[col + 1] : ba[col + 1 - Do];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm * 32 + mt * 16 + g;
      *reinterpret_cast<float2*>(res + row * PS + col) =
          make_float2(acc[mt][nt][0] + bx, acc[mt][nt][1] + by);
      *reinterpret_cast<float2*>(res + (row + 8) * PS + col) =
          make_float2(acc[mt][nt][2] + bx, acc[mt][nt][3] + by);
    }
  }
  if (tid < BQ && r0 + tid < rows) {
    const int qi = (int)((r0 + tid) % Lq);
    int s = qi, w = lv.w[0], h = lv.h[0];
#pragma unroll
    for (int l = 1; l < L; ++l)
      if (qi >= lv.start[l]) {
        s = qi - lv.start[l];
        w = lv.w[l];
        h = lv.h[l];
      }
    ref_s[tid][0] = ((float)(s % w) + 0.5f) / (float)w;
    ref_s[tid][1] = ((float)(s / w) + 0.5f) / (float)h;
  }
  if (tid == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      size_s[l][0] = (float)lv.w[l];
      size_s[l][1] = (float)lv.h[l];
    }
  }
  __syncthreads();

  // softmax per (query, head) over its L*P logits, in place
  for (int i = tid; i < BQ * M; i += kMmaThreads) {
    float* lg = res + (i / M) * PS + Do + (i % M) * LP;
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < LP; ++k) mx = fmaxf(mx, lg[k]);
    float e[LP], sum = 0.f;
#pragma unroll
    for (int k = 0; k < LP; ++k) {
      e[k] = expf(lg[k] - mx);
      sum += e[k];
    }
#pragma unroll
    for (int k = 0; k < LP; ++k) lg[k] = e[k] / sum;
  }
  __syncthreads();

  // the block's rows: one contiguous run of nrows x NC floats, 16 bytes a store
  const int nrows = rows - r0 < BQ ? (int)(rows - r0) : BQ;
  float4* dst = reinterpret_cast<float4*>(loc + (size_t)r0 * NC);
  constexpr int V4 = NC / 4;
  for (int f = tid; f < nrows * V4; f += kMmaThreads) {
    const int r = f / V4, o0 = (f % V4) * 4;
    const float* pr = res + r * PS;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + e;  // (m, l*P + p, component)
      const int m = o / (3 * LP), k = (o % (3 * LP)) / 3, c = o % 3;
      v[e] = c == 2 ? pr[Do + m * LP + k]
                    : ref_s[r][c] * size_s[k / P][c] + pr[m * 2 * LP + 2 * k + c] - 0.5f;
    }
    dst[f] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------

template <typename T>
int launch_fma(const void* q, const void* wo, const void* bo, const void* wa, const void* ba,
               void* loc, int N, int Lq, int C, int M, int P, const Levels& lv,
               cudaStream_t stream) {
  constexpr int BQ = kRowsBQ;
  const int NC = 3 * M * lv.L * P;
  const size_t smem = sizeof(float) * (size_t)BQ * (C + NC);
  if (smem > 227 * 1024 || NC > 1024) return (int)cudaErrorInvalidValue;
  auto kern = msda_rows_kernel<T, BQ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = ((NC + 31) / 32) * 32;
  const long blocks = (long)N * ((Lq + BQ - 1) / BQ);
  kern<<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)q, (const T*)wo, (const float*)bo, (const T*)wa, (const float*)ba,
      (float*)loc, N, Lq, C, M, P, lv);
  return (int)cudaGetLastError();
}

template <int M, int L, int P>
int launch_mma(const void* q, const void* wo, const void* bo, const void* wa, const void* ba,
               void* loc, int N, int Lq, int C, const Levels& lv, cudaStream_t stream) {
  using G = RowsGeo<M, L, P>;
  auto kern = msda_rows_mma_kernel<M, L, P>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)G::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int rows = N * Lq;
  const int blocks = (rows + kMmaBQ - 1) / kMmaBQ;
  if (blocks > 0)
    kern<<<blocks, kMmaThreads, G::kSmem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)wo, (const float*)bo,
        (const __nv_bfloat16*)wa, (const float*)ba, (float*)loc, rows, Lq, C, lv);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace univs

extern "C" int msda_rows_launch(int dtype, const void* q, const void* wo, const void* bo,
                                const void* wa, const void* ba, void* loc, int N, int Lq,
                                int C, int M, int P, int L, const int* shapes,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L < 1 || L > 4) return (int)cudaErrorInvalidValue;
  const univs::Levels lv = univs::make_levels(L, shapes);
  if (dtype == 1 && M == 8 && L == 3 && P == 4 && C % univs::kMmaKC == 0 &&
      univs::aligned16(q) && univs::aligned16(wo) && univs::aligned16(wa) &&
      univs::aligned16(loc))
    return univs::launch_mma<8, 3, 4>(q, wo, bo, wa, ba, loc, N, Lq, C, lv, s);
  if (dtype == 0)
    return univs::launch_fma<float>(q, wo, bo, wa, ba, loc, N, Lq, C, M, P, lv, s);
  if (dtype == 1)
    return univs::launch_fma<__nv_bfloat16>(q, wo, bo, wa, ba, loc, N, Lq, C, M, P, lv, s);
  return (int)cudaErrorInvalidValue;
}

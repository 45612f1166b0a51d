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
// The 288 projections per query are computed here, in the kernel body,
// as the TPU kernel does on its MXU: a block takes BQ queries, stages
// them in shared memory as float32, and each thread owns one output
// column, reading that column of the (transposed, [C, out]) weight with
// coalesced loads and keeping BQ float32 accumulators in registers.
// Products see the inputs in the compute dtype; accumulation is float32;
// biases are float32.
//
// Bound on the H100: compulsory traffic is q in plus rows out (~21 MB per
// frame at full width, ~6 us at 3.35 TB/s); 1.9 GFLOP per frame of
// projections is far below the tensor-core roofline.  This first version
// runs the projections on the CUDA cores (plain FMA), so it is compute-
// bound well above that figure; mma.sync / wgmma is later work.
#include "common.cuh"

namespace univs {

constexpr int kRowsBQ = 32;

template <typename T, int BQ>
__global__ void msda_rows_kernel(const T* __restrict__ q,      // [N, Lq, C]
                                 const T* __restrict__ wo_t,   // [C, Do]
                                 const float* __restrict__ bo, // [Do]
                                 const T* __restrict__ wa_t,   // [C, Da]
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
    const T* wcol = is_off ? wo_t + j : wa_t + (j - Do);
    const int stride = is_off ? Do : Da;
    float acc[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = 0.f;
    for (int k = 0; k < C; ++k) {
      const float w = to_f32(wcol[(size_t)k * stride]);
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

template <typename T>
int launch(const void* q, const void* wo_t, const void* bo, const void* wa_t,
           const void* ba, void* loc, int N, int Lq, int C, int M, int P, int L,
           const int* shapes, cudaStream_t stream) {
  if (L < 1 || L > 4) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, shapes);
  constexpr int BQ = kRowsBQ;
  const int NC = 3 * M * L * P;
  const size_t smem = sizeof(float) * (size_t)BQ * (C + NC);
  if (smem > 227 * 1024 || NC > 1024) return (int)cudaErrorInvalidValue;
  auto kern = msda_rows_kernel<T, BQ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = ((NC + 31) / 32) * 32;
  const long blocks = (long)N * ((Lq + BQ - 1) / BQ);
  kern<<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)q, (const T*)wo_t, (const float*)bo, (const T*)wa_t, (const float*)ba,
      (float*)loc, N, Lq, C, M, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace univs

extern "C" int msda_rows_launch(int dtype, const void* q, const void* wo_t, const void* bo,
                                const void* wa_t, const void* ba, void* loc, int N, int Lq,
                                int C, int M, int P, int L, const int* shapes,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return univs::launch<float>(q, wo_t, bo, wa_t, ba, loc, N, Lq, C, M, P, L, shapes, s);
  if (dtype == 1)
    return univs::launch<__nv_bfloat16>(q, wo_t, bo, wa_t, ba, loc, N, Lq, C, M, P, L,
                                        shapes, s);
  return (int)cudaErrorInvalidValue;
}

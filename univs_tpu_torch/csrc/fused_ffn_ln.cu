// Kernel C: fused residual + LayerNorm + FFN + residual + LayerNorm, the
// tail of every deformable encoder layer.
//
// Replaces univs_tpu/ops/fused_mlp.py:_kernel (:27, pallas_call :83,
// entry fused_ffn_ln):
//   u   = LN1(src + attn_out)                 (statistics in float32)
//   out = LN2(u + W2 relu(W1 u + b1) + b2)
// The products see u and the hidden activation rounded to the layer dtype
// (as the TPU kernel casts them before its dots) and accumulate in
// float32; the residual uses u in float32.  Weights come in nn.Linear's
// layout: W1 [F, C], W2 [C, F] ([out, in], the reduction axis contiguous).
//
// Bound on the H100: ~13.2 GFLOP per frame at full width (12,600 tokens,
// C=256, F=1024), ~13 us at the bf16 tensor-core peak of 989 TFLOP/s;
// compulsory traffic is only src, attn_out and out (~19 MB per frame).
// The hidden activation (~26 MB per frame in bf16) never reaches device
// memory.
//
// Two bodies:
//  - bf16 with C == 256 and F % 256 == 0 (the main path): tensor cores via
//    mma.sync m16n8k16 (bf16 in, float32 accumulate).  A block takes 64
//    tokens and 8 warps.  u (float32, for the residual and LN2) and u in
//    bf16 (the A operand) live in shared memory; the hidden activation is
//    streamed through shared memory in 256-column chunks: per chunk every
//    warp computes 32 hidden columns of relu(u W1 + b1) for all 64 tokens,
//    rounds them to bf16 into the chunk buffer, and then adds the chunk's
//    share of hidden · W2 into its 64 x 32 output tile, which stays in
//    registers across the chunks.  B fragments are read straight from the
//    weights (L2-resident, 1 MB in all) with the next k-step's fragments
//    loaded while the current one multiplies.  133 KB of shared memory,
//    one block per SM.
//  - every other case (float32; widths the tile does not fit, such as the
//    tiny test config): FMA loops on the CUDA cores over 32-token blocks,
//    the whole hidden row block (32 x F) in shared memory in the layer
//    dtype.
#include "common.cuh"

namespace univs {

__device__ __forceinline__ void ln_rows_inplace(float* rows, int nrows, int C, int stride,
                                                const float* __restrict__ g,
                                                const float* __restrict__ c, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nwarps) {
    float* z = rows + (size_t)r * stride;
    float s = 0.f;
    for (int i = lane; i < C; i += 32) s += z[i];
    const float mu = warp_sum(s) / (float)C;
    float v = 0.f;
    for (int i = lane; i < C; i += 32) {
      const float d = z[i] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / (float)C + eps);
    for (int i = lane; i < C; i += 32) z[i] = (z[i] - mu) * rstd * g[i] + c[i];
  }
}

// u = LN1(x + a) for rows [t0, t0 + nrows) into u_s (row stride C); pad
// rows beyond ntok are zero before the norm.
template <typename T>
__device__ __forceinline__ void load_ln1(const T* __restrict__ x, const T* __restrict__ a,
                                         float* u_s, int t0, int nrows, int ntok, int C,
                                         const float* __restrict__ g1,
                                         const float* __restrict__ c1, float eps) {
  for (int i = threadIdx.x; i < nrows * C; i += blockDim.x) {
    const int t = t0 + i / C;
    const size_t gi = (size_t)t * C + (i % C);
    u_s[i] = t < ntok ? to_f32(x[gi]) + to_f32(a[gi]) : 0.f;
  }
  __syncthreads();
  ln_rows_inplace(u_s, nrows, C, C, g1, c1, eps);
  __syncthreads();
}

// LN2 over z in u_s and the single write of the layer output.
template <typename T>
__device__ __forceinline__ void ln2_store(float* u_s, T* __restrict__ out, int t0, int nrows,
                                          int ntok, int C, const float* __restrict__ g2,
                                          const float* __restrict__ c2, float eps) {
  __syncthreads();
  ln_rows_inplace(u_s, nrows, C, C, g2, c2, eps);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * C; i += blockDim.x) {
    const int t = t0 + i / C;
    if (t < ntok) out[(size_t)t * C + (i % C)] = from_f32<T>(u_s[i]);
  }
}

// ---------------------------------------------------------------------------
// FMA body (float32, and bf16 at widths the tensor-core tile does not fit)
// ---------------------------------------------------------------------------

constexpr int kFmaBT = 32;

template <typename T, int BT>
__global__ void __launch_bounds__(256)
ffn_fma_kernel(const T* __restrict__ x, const T* __restrict__ a, const float* __restrict__ g1,
               const float* __restrict__ c1, const T* __restrict__ w1,  // [F, C]
               const float* __restrict__ b1, const T* __restrict__ w2,  // [C, F]
               const float* __restrict__ b2, const float* __restrict__ g2,
               const float* __restrict__ c2, T* __restrict__ out, int ntok, int C, int F,
               float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_s = reinterpret_cast<float*>(smem_raw);  // [BT][C] float32 u, then z
  float* ur_s = u_s + BT * C;                       // [BT][C] u rounded to T
  T* h_s = reinterpret_cast<T*>(ur_s + BT * C);     // [BT][F] hidden, layer dtype
  const int t0 = blockIdx.x * BT;

  load_ln1(x, a, u_s, t0, BT, ntok, C, g1, c1, eps);
  for (int i = threadIdx.x; i < BT * C; i += blockDim.x) ur_s[i] = round_to<T>(u_s[i]);
  __syncthreads();

  // hidden = relu(u W1 + b1): thread f walks row f of W1 (contiguous in k)
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    const T* wrow = w1 + (size_t)f * C;
    for (int k = 0; k < C; k += 4) {
      const float4 w = load4(wrow + k);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 u = load4(ur_s + b * C + k);
        acc[b] += u.x * w.x + u.y * w.y + u.z * w.z + u.w * w.w;
      }
    }
    const float bias = b1[f];
#pragma unroll
    for (int b = 0; b < BT; ++b) h_s[b * F + f] = from_f32<T>(fmaxf(acc[b] + bias, 0.f));
  }
  __syncthreads();

  // z = u + hidden W2 + b2, written over the u tile (column c is one thread's)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    const T* wrow = w2 + (size_t)c * F;
    for (int k = 0; k < F; k += 4) {
      const float4 w = load4(wrow + k);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 h = load4(h_s + b * F + k);
        acc[b] += h.x * w.x + h.y * w.y + h.z * w.z + h.w * w.w;
      }
    }
    const float bias = b2[c];
#pragma unroll
    for (int b = 0; b < BT; ++b) u_s[b * C + c] += acc[b] + bias;
  }
  ln2_store(u_s, out, t0, BT, ntok, C, g2, c2, eps);
}

// ---------------------------------------------------------------------------
// tensor-core body (bf16, C == 256)
// ---------------------------------------------------------------------------

constexpr int kMmaC = 256;   // model width the tile is built for: 8 warps x 32 columns
constexpr int kMmaBT = 64;   // tokens per block: 4 m-tiles of 16
constexpr int kMmaNCH = 256; // hidden columns per chunk: 8 warps x 32
constexpr int kPad = 8;      // bf16 row padding: conflict-free fragment loads
constexpr int kStride = 256 + kPad;

// acc[4 m-tiles][4 n-tiles] += A[64 x K] (shared, bf16) * W[n0.., k_base..]^T,
// B fragments read straight from the weight in global memory
__device__ __forceinline__ void mma_tile(float (&acc)[4][4][4], const __nv_bfloat16* a_tile,
                                         const __nv_bfloat16* w, int ldw, int n0, int k_base,
                                         int K, int g, int t) {
  uint32_t bcur[4][2], bnext[4][2];
  load_b<4, false>(bcur, w, ldw, n0, k_base, g, t);
  for (int k0 = 0; k0 < K; k0 += 16) {
    if (k0 + 16 < K) load_b<4, false>(bnext, w, ldw, n0, k_base + k0 + 16, g, t);
    uint32_t af[4][4];
    load_a<4>(af, a_tile, kStride, k0, g, t);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bcur[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      bcur[nt][0] = bnext[nt][0];
      bcur[nt][1] = bnext[nt][1];
    }
  }
}

__global__ void __launch_bounds__(256, 1)
ffn_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
               const float* __restrict__ g1, const float* __restrict__ c1,
               const __nv_bfloat16* __restrict__ w1,  // [F, 256]
               const float* __restrict__ b1,
               const __nv_bfloat16* __restrict__ w2,  // [256, F]
               const float* __restrict__ b2, const float* __restrict__ g2,
               const float* __restrict__ c2, __nv_bfloat16* __restrict__ out, int ntok, int F,
               float eps) {
  constexpr int C = kMmaC, BT = kMmaBT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_s = reinterpret_cast<float*>(smem_raw);                   // [BT][C] f32 u, then z
  __nv_bfloat16* ua_s = reinterpret_cast<__nv_bfloat16*>(u_s + BT * C);  // [BT][kStride] u in bf16
  __nv_bfloat16* h_s = ua_s + BT * kStride;                          // [BT][kStride] hidden chunk
  const int t0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / thread-in-group

  load_ln1(x, a, u_s, t0, BT, ntok, C, g1, c1, eps);
  for (int i = threadIdx.x; i < BT * C; i += blockDim.x)
    ua_s[(i / C) * kStride + (i % C)] = __float2bfloat16_rn(u_s[i]);
  __syncthreads();

  float acc2[4][4][4];  // this warp's 64 x 32 output tile, columns [warp*32, +32)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mt][nt][e] = 0.f;

  for (int ch = 0; ch < F; ch += kMmaNCH) {
    // hidden columns [ch + warp*32, +32) = relu(u W1 + b1), rounded to bf16
    float acc1[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = 0.f;
    mma_tile(acc1, ua_s, w1, C, ch + warp * 32, 0, C, g, t);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp * 32 + nt * 8 + 2 * t;  // within the chunk
        const float bx = b1[ch + col], by = b1[ch + col + 1];
        const int r0 = mt * 16 + g;
        *reinterpret_cast<__nv_bfloat162*>(h_s + r0 * kStride + col) = __floats2bfloat162_rn(
            fmaxf(acc1[mt][nt][0] + bx, 0.f), fmaxf(acc1[mt][nt][1] + by, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(h_s + (r0 + 8) * kStride + col) =
            __floats2bfloat162_rn(fmaxf(acc1[mt][nt][2] + bx, 0.f),
                                  fmaxf(acc1[mt][nt][3] + by, 0.f));
      }
    }
    __syncthreads();
    // output columns [warp*32, +32) += hidden chunk · W2[:, ch:ch+256]^T
    mma_tile(acc2, h_s, w2, F, warp * 32, ch, kMmaNCH, g, t);
    __syncthreads();  // the next chunk overwrites h_s
  }

  // z = u + y2 + b2 over the u tile (each element has one owner)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = warp * 32 + nt * 8 + 2 * t;
      const int r0 = mt * 16 + g;
      const float bx = b2[col], by = b2[col + 1];
      u_s[r0 * C + col] += acc2[mt][nt][0] + bx;
      u_s[r0 * C + col + 1] += acc2[mt][nt][1] + by;
      u_s[(r0 + 8) * C + col] += acc2[mt][nt][2] + bx;
      u_s[(r0 + 8) * C + col + 1] += acc2[mt][nt][3] + by;
    }
  }
  ln2_store(u_s, out, t0, BT, ntok, C, g2, c2, eps);
}

// ---------------------------------------------------------------------------

template <typename T>
int launch_fma(const void* x, const void* a, const void* g1, const void* c1, const void* w1,
               const void* b1, const void* w2, const void* b2, const void* g2, const void* c2,
               void* out, int ntok, int C, int F, float eps, cudaStream_t stream) {
  constexpr int BT = kFmaBT;
  const size_t smem = 2 * sizeof(float) * (size_t)BT * C + sizeof(T) * (size_t)BT * F;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = ffn_fma_kernel<T, BT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (ntok + BT - 1) / BT;
  kern<<<blocks, 256, smem, stream>>>(
      (const T*)x, (const T*)a, (const float*)g1, (const float*)c1, (const T*)w1,
      (const float*)b1, (const T*)w2, (const float*)b2, (const float*)g2, (const float*)c2,
      (T*)out, ntok, C, F, eps);
  return (int)cudaGetLastError();
}

int launch_mma(const void* x, const void* a, const void* g1, const void* c1, const void* w1,
               const void* b1, const void* w2, const void* b2, const void* g2, const void* c2,
               void* out, int ntok, int F, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kMmaBT * kMmaC + 2 * sizeof(__nv_bfloat16) * kMmaBT * kStride;
  cudaError_t e = cudaFuncSetAttribute(ffn_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (ntok + kMmaBT - 1) / kMmaBT;
  ffn_mma_kernel<<<blocks, 256, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)a, (const float*)g1, (const float*)c1,
      (const __nv_bfloat16*)w1, (const float*)b1, (const __nv_bfloat16*)w2, (const float*)b2,
      (const float*)g2, (const float*)c2, (__nv_bfloat16*)out, ntok, F, eps);
  return (int)cudaGetLastError();
}

}  // namespace univs

extern "C" int fused_ffn_ln_launch(int dtype, const void* x, const void* a, const void* g1,
                                   const void* c1, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* g2,
                                   const void* c2, void* out, int ntok, int C, int F,
                                   float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 != 0 || F % 4 != 0 || ntok < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && C == univs::kMmaC && F % univs::kMmaNCH == 0)
    return univs::launch_mma(x, a, g1, c1, w1, b1, w2, b2, g2, c2, out, ntok, F, eps, s);
  if (dtype == 0)
    return univs::launch_fma<float>(x, a, g1, c1, w1, b1, w2, b2, g2, c2, out, ntok, C, F,
                                    eps, s);
  if (dtype == 1)
    return univs::launch_fma<__nv_bfloat16>(x, a, g1, c1, w1, b1, w2, b2, g2, c2, out, ntok,
                                            C, F, eps, s);
  return (int)cudaErrorInvalidValue;
}

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
// Bound on the H100: operations.  4·C·F flop a token, ~13.2 GFLOP per
// frame at full width (12,600 tokens, C=256, F=1024), ~13 us at the bf16
// tensor-core peak of 989 TFLOP/s; the compulsory traffic is only src,
// attn_out and out (~19 MB per frame).  The hidden activation (~26 MB per
// frame in bf16) never reaches device memory.
//
// Two bodies; the caller names one and a launch refuses a body that does
// not fit (it never picks another):
//  - wgmma (bf16, C == 256, F % 64 == 0: every launch of the model paths).
//    Persistent and warp-specialised: one block of 384 threads per SM walks
//    128-token tiles.  Warpgroups 0 and 1 each own 64 tokens; warpgroup 2's
//    first thread is the producer.  Per hidden chunk of 64 columns:
//      GEMM1  wgmma m64n64k16, A = u (bf16, shared, 128-byte swizzle),
//             B = the W1 chunk (shared), 32 float32 accumulators a thread;
//      b1 and relu in registers, the accumulators rounded to bf16 straight
//             into wgmma's A-operand fragments (the m64 accumulator layout
//             is the A register layout): the hidden activation touches
//             neither shared nor device memory;
//      GEMM2  wgmma m64n256k16, A from those registers, B = the W2 chunk,
//             into the warpgroup's 64 x 256 float32 output tile (128
//             registers a thread), which starts as u + b2 (the residual).
//    The weights stream through two rings of two 32 KB stages (W1 chunks
//    and W2 chunks) by TMA in the 128-byte swizzle, each stage's arrival
//    and release tracked by mbarriers; no weight fragment is read from
//    global memory inside the product loop.  Each warpgroup starts GEMM2 of
//    chunk j and GEMM1 of chunk j + 1 together and waits once; the two
//    warpgroups share the tensor cores, so one's relu / rounding can run
//    beside the other's products.  (Keeping GEMM2 in flight across the
//    next chunk's rounding, with two fragment sets, measured slower: ptxas
//    serialises the wgmmas and spills.)  LN1 is fused into the
//    prologue (16-byte coalesced loads, a 4 x 4 exchange inside each quad
//    into the accumulator layout, two-pass float32 statistics over the
//    quad); LN2 runs on the accumulators (a row lies in one quad: a local
//    sum and two shuffles) and the output leaves through the same exchange
//    as 16-byte stores, the ragged last tile masked.  setmaxnreg gives the
//    consumers 232 registers and the producer 40.  Shared memory: u tiles
//    64 KB + 4 weight stages 128 KB + the vectors.  The weights (1 MB) are
//    read from L2 once per 128-token tile (~2.95 GB per 30-frame launch);
//    one CTA per SM, no cluster: each chunk is fetched by its own CTA.
//  - fma (float32; widths the tile does not fit, such as the tiny test
//    config): FMA loops on the CUDA cores over 32-token blocks, the whole
//    hidden row block (32 x F) in shared memory in the layer dtype.
#include "common.cuh"
#include "hopper.cuh"

#include <mutex>

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

  // u = LN1(x + a); pad rows beyond ntok are zero before the norm
  for (int i = threadIdx.x; i < BT * C; i += blockDim.x) {
    const int t = t0 + i / C;
    const size_t gi = (size_t)t * C + (i % C);
    u_s[i] = t < ntok ? to_f32(x[gi]) + to_f32(a[gi]) : 0.f;
  }
  __syncthreads();
  ln_rows_inplace(u_s, BT, C, C, g1, c1, eps);
  __syncthreads();
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

  // LN2 and the single write of the layer output
  __syncthreads();
  ln_rows_inplace(u_s, BT, C, C, g2, c2, eps);
  __syncthreads();
  for (int i = threadIdx.x; i < BT * C; i += blockDim.x) {
    const int t = t0 + i / C;
    if (t < ntok) out[(size_t)t * C + (i % C)] = from_f32<T>(u_s[i]);
  }
}

// ---------------------------------------------------------------------------
// wgmma body (bf16, C == 256)
// ---------------------------------------------------------------------------

constexpr int kWgC = 256;                     // model width the tile is built for
constexpr int kWgTok = 128;                   // tokens per tile: 2 warpgroups x 64
constexpr int kWgFC = 64;                     // hidden columns per chunk
constexpr int kWgThreads = 384;               // 2 consumer warpgroups + the producer's
constexpr int kUTile = 64 * kWgC * 2;         // one warpgroup's u tile in bf16: 32 KB
constexpr int kKBlock = 64 * 128;             // 64 rows x 128 B: one swizzle-wide K block
constexpr int kW1Stage = kWgFC * kWgC * 2;    // W1 chunk [64, 256]: 32 KB
constexpr int kW2Stage = kWgC * kWgFC * 2;    // W2 chunk [256, 64]: 32 KB
constexpr int kOffW1 = 2 * kUTile;            // shared-memory layout (1024-byte aligned)
constexpr int kOffW2 = kOffW1 + 2 * kW1Stage;
constexpr int kOffVec = kOffW2 + 2 * kW2Stage;  // g1 c1 b2 g2 c2 [256] each, b1 [F]

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// 4 x 4 exchange of 32-bit words inside a quad: r[j] of thread t becomes
// r[t] of thread j.  A row's 16-byte piece (thread t: columns of n-tile
// 4k + t) <-> the accumulator layout (thread t: column pair t of n-tiles
// 4k .. 4k + 3); indices stay compile-time, the lane picks by selects.
__device__ __forceinline__ void quad_transpose(uint32_t (&r)[4], int t) {
  const bool odd = t & 1, hi = t & 2;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, odd ? r[2 * m] : r[2 * m + 1], 1);
    if (odd) r[2 * m] = recv; else r[2 * m + 1] = recv;
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, hi ? r[m] : r[m + 2], 2);
    if (hi) r[m] = recv; else r[m + 2] = recv;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// LayerNorm of the two rows a thread holds in the m64n256 accumulator
// layout (v[4i + 2h + e]: row g + 8h, column 8i + 2t + e), in place;
// statistics in float32, two-pass, over the quad that holds the row
__device__ __forceinline__ void ln_acc(float (&v)[128], const float* g, const float* c, float eps,
                                       int t) {
  float mu[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s += v[4 * i + 2 * h] + v[4 * i + 2 * h + 1];
    mu[h] = quad_sum(s) / (float)kWgC;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d0 = v[4 * i + 2 * h] - mu[h], d1 = v[4 * i + 2 * h + 1] - mu[h];
      q += d0 * d0 + d1 * d1;
    }
    rstd[h] = rsqrtf(quad_sum(q) / (float)kWgC + eps);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 gg = *reinterpret_cast<const float2*>(g + 8 * i + 2 * t);
    const float2 cc = *reinterpret_cast<const float2*>(c + 8 * i + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[4 * i + 2 * h] = (v[4 * i + 2 * h] - mu[h]) * rstd[h] * gg.x + cc.x;
      v[4 * i + 2 * h + 1] = (v[4 * i + 2 * h + 1] - mu[h]) * rstd[h] * gg.y + cc.y;
    }
  }
}

// h[64 tokens x 64 hidden] = u_tile · W1_chunk^T, 16 k-steps of 16
__device__ __forceinline__ void gemm1(float (&h)[32], const unsigned char* u_tile,
                                      const unsigned char* w1_stage) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kWgC / 16; ++ks) {
    const int off = (ks / 4) * kKBlock + (ks % 4) * 32;
    sm90::wgmma_m64n64k16_ss(h, sm90::desc_sw128(u_tile + off), sm90::desc_sw128(w1_stage + off),
                             ks > 0);
  }
  sm90::wgmma_commit();
}

// relu(h + b1) rounded to bf16 as GEMM2's A fragments: k-step ks covers
// the chunk's hidden columns 16ks .. 16ks + 15 (n-tiles 2ks, 2ks + 1)
__device__ __forceinline__ void hidden_frags(uint32_t (&af)[4][4], const float (&h)[32],
                                             const float* b1c, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * ks + e;
      const float2 bb = *reinterpret_cast<const float2*>(b1c + 8 * i + 2 * t);
      af[ks][2 * e] = pack_bf16(fmaxf(h[4 * i] + bb.x, 0.f), fmaxf(h[4 * i + 1] + bb.y, 0.f));
      af[ks][2 * e + 1] =
          pack_bf16(fmaxf(h[4 * i + 2] + bb.x, 0.f), fmaxf(h[4 * i + 3] + bb.y, 0.f));
    }
  }
}

// acc[64 tokens x 256] += relu-hidden chunk (registers) · W2_chunk^T
__device__ __forceinline__ void gemm2(float (&acc)[128], uint32_t (&af)[4][4],
                                      const unsigned char* w2_stage) {
  sm90::wgmma_fence();
  sm90::fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    sm90::wgmma_m64n256k16_rs(acc, af[ks], sm90::desc_sw128(w2_stage + ks * 32));
  sm90::wgmma_commit();
}

__global__ void __launch_bounds__(kWgThreads, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,  // W1 [F, 256], boxes [64, 64]
                 const __grid_constant__ CUtensorMap w2_map,  // W2 [256, F], boxes [256, 64]
                 const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                 const float* __restrict__ g1, const float* __restrict__ c1,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 const float* __restrict__ g2, const float* __restrict__ c2,
                 __nv_bfloat16* __restrict__ out, int ntok, int F, float eps) {
  constexpr int C = kWgC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* vec = reinterpret_cast<float*>(smem + kOffVec);
  float *g1_s = vec, *c1_s = vec + C, *b2_s = vec + 2 * C, *g2_s = vec + 3 * C,
        *c2_s = vec + 4 * C, *b1_s = vec + 5 * C;
  uint64_t* bars = reinterpret_cast<uint64_t*>(b1_s + F);  // F % 64 == 0: 8-byte aligned
  uint64_t *full1 = bars, *empty1 = bars + 2, *full2 = bars + 4, *empty2 = bars + 6;

  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    g1_s[i] = g1[i];
    c1_s[i] = c1[i];
    b2_s[i] = b2[i];
    g2_s[i] = g2[i];
    c2_s[i] = c2[i];
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) b1_s[i] = b1[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&full1[s], 1);
      sm90::mbar_init(&full2[s], 1);
      sm90::mbar_init(&empty1[s], 8);  // one arrival per consumer warp
      sm90::mbar_init(&empty2[s], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int nch = F / kWgFC;
  const int ntiles = (ntok + kWgTok - 1) / kWgTok;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: W1 and W2 chunks, in the order the consumers take them
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      uint32_t n = 0;  // chunks requested
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        for (int j = 0; j < nch; ++j, ++n) {
          const int s = n & 1;
          const uint32_t ph = (n >> 1) & 1;
          sm90::mbar_wait(&empty1[s], ph ^ 1);
          sm90::mbar_arrive_expect_tx(&full1[s], kW1Stage);
          for (int kb = 0; kb < C / 64; ++kb)
            sm90::tma_load_2d(smem + kOffW1 + s * kW1Stage + kb * kKBlock, &w1_map, &full1[s],
                              kb * 64, j * kWgFC);
          sm90::mbar_wait(&empty2[s], ph ^ 1);
          sm90::mbar_arrive_expect_tx(&full2[s], kW2Stage);
          sm90::tma_load_2d(smem + kOffW2 + s * kW2Stage, &w2_map, &full2[s], j * kWgFC, 0);
        }
      }
    }
  } else {
    // ---- consumers: 64 tokens each
    sm90::reg_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int lr = warp * 16 + g;  // local rows lr and lr + 8 of the warpgroup's 64
    unsigned char* u_tile = smem + wg * kUTile;
    float acc[128];  // output tile: u + b2, then + hidden · W2^T, then LN2
    float h[32];     // hidden chunk
    uint32_t n = 0;  // chunks consumed

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row[2] = {tile * kWgTok + wg * 64 + lr, tile * kWgTok + wg * 64 + lr + 8};

      // LN1 prologue: src + attn in float32 into the accumulator layout
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool in = row[hh] < ntok;
          const size_t off = (size_t)(in ? row[hh] : 0) * C + 8 * (4 * k + t);
          uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + off));
          uint4 av = __ldg(reinterpret_cast<const uint4*>(a + off));
          uint32_t xr[4] = {xv.x, xv.y, xv.z, xv.w}, ar[4] = {av.x, av.y, av.z, av.w};
          quad_transpose(xr, t);
          quad_transpose(ar, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 xf = unpack_bf16(xr[q]), af = unpack_bf16(ar[q]);
            acc[4 * (4 * k + q) + 2 * hh] = in ? xf.x + af.x : 0.f;
            acc[4 * (4 * k + q) + 2 * hh + 1] = in ? xf.y + af.y : 0.f;
          }
        }
      }
      ln_acc(acc, g1_s, c1_s, eps, t);  // acc = u (float32)

      // u in bf16 -> this warpgroup's A tile (K blocks of 64, 128-byte
      // swizzle: the 16-byte piece p of row r lies at p ^ (r % 8)), once the
      // previous tile's products have finished reading it
      sm90::named_sync(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = lr + 8 * hh;
          const int off = (i / 8) * kKBlock + r * 128 + (((i % 8) ^ (r % 8)) * 16) + 4 * t;
          *reinterpret_cast<uint32_t*>(u_tile + off) =
              pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(b2_s + 8 * i + 2 * t);
        acc[4 * i] += bb.x;
        acc[4 * i + 1] += bb.y;
        acc[4 * i + 2] += bb.x;
        acc[4 * i + 3] += bb.y;
      }
      sm90::fence_proxy_async();
      sm90::named_sync(1 + wg, 128);

      // GEMM1 of chunk 0
      {
        const int s = n & 1;
        sm90::mbar_wait(&full1[s], (n >> 1) & 1);
        gemm1(h, u_tile, smem + kOffW1 + s * kW1Stage);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(h);
        if (lane == 0) sm90::mbar_arrive(&empty1[s]);
      }
      for (int j = 0; j < nch; ++j, ++n) {
        const int s = n & 1;
        uint32_t af[4][4];
        hidden_frags(af, h, b1_s + j * kWgFC, t);
        // GEMM2 of chunk j, then GEMM1 of chunk j + 1 behind it
        sm90::mbar_wait(&full2[s], (n >> 1) & 1);
        gemm2(acc, af, smem + kOffW2 + s * kW2Stage);
        const int s1 = (n + 1) & 1;
        if (j + 1 < nch) {
          sm90::mbar_wait(&full1[s1], ((n + 1) >> 1) & 1);
          gemm1(h, u_tile, smem + kOffW1 + s1 * kW1Stage);
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(h);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) sm90::fence_regs(af[ks]);
        if (lane == 0) {
          sm90::mbar_arrive(&empty2[s]);
          if (j + 1 < nch) sm90::mbar_arrive(&empty1[s1]);
        }
      }
      sm90::fence_regs(acc);

      // LN2 on the accumulators; out in bf16 as 16-byte stores
      ln_acc(acc, g2_s, c2_s, eps, t);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t r[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            r[q] = pack_bf16(acc[4 * (4 * k + q) + 2 * hh], acc[4 * (4 * k + q) + 2 * hh + 1]);
          quad_transpose(r, t);
          if (row[hh] < ntok)
            *reinterpret_cast<uint4*>(out + (size_t)row[hh] * C + 8 * (4 * k + t)) =
                make_uint4(r[0], r[1], r[2], r[3]);
        }
      }
    }
  }
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

// The two weights' tensor maps, encoded once per (W1, W2, F): a map holds
// only the address, the shape and the box, so a hit is the same map.
struct WeightMaps {
  const void* w1;
  const void* w2;
  int F;
  CUtensorMap m1, m2;
};

int weight_maps(const void* w1, const void* w2, int F, CUtensorMap* m1, CUtensorMap* m2) {
  static std::mutex mu;
  static WeightMaps cache[8];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].w1 == w1 && cache[i].w2 == w2 && cache[i].F == F) {
      *m1 = cache[i].m1;
      *m2 = cache[i].m2;
      return 0;
    }
  }
  WeightMaps e{w1, w2, F, {}, {}};
  int err = sm90::encode_bf16_sw128(&e.m1, w1, kWgC, F, 64, kWgFC);
  if (err == 0) err = sm90::encode_bf16_sw128(&e.m2, w2, F, kWgC, kWgFC, kWgC);
  if (err != 0) return err;
  cache[next] = e;
  next = (next + 1) % 8;
  if (used < 8) ++used;
  *m1 = e.m1;
  *m2 = e.m2;
  return 0;
}

int launch_wgmma(const void* x, const void* a, const void* g1, const void* c1, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* g2, const void* c2,
                 void* out, int ntok, int C, int F, float eps, cudaStream_t stream) {
  if (C != kWgC || F <= 0 || F % kWgFC != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + kOffVec + sizeof(float) * (5 * kWgC + (size_t)F) + 8 * sizeof(uint64_t);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap m1, m2;
  int err = weight_maps(w1, w2, F, &m1, &m2);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(ffn_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int ntiles = (ntok + kWgTok - 1) / kWgTok;
  const int blocks = ntiles < sms ? (ntiles > 0 ? ntiles : 1) : sms;
  ffn_wgmma_kernel<<<blocks, kWgThreads, smem, stream>>>(
      m1, m2, (const __nv_bfloat16*)x, (const __nv_bfloat16*)a, (const float*)g1,
      (const float*)c1, (const float*)b1, (const float*)b2, (const float*)g2, (const float*)c2,
      (__nv_bfloat16*)out, ntok, F, eps);
  return (int)cudaGetLastError();
}

}  // namespace univs

// body: 0 = fma, 1 = wgmma (bf16, C == 256, F % 64 == 0); a body that
// does not fit the arguments returns cudaErrorInvalidValue
extern "C" int fused_ffn_ln_launch(int body, int dtype, const void* x, const void* a,
                                   const void* g1, const void* c1, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   const void* g2, const void* c2, void* out, int ntok, int C,
                                   int F, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 != 0 || F % 4 != 0 || ntok < 0) return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return univs::launch_wgmma(x, a, g1, c1, w1, b1, w2, b2, g2, c2, out, ntok, C, F, eps, s);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return univs::launch_fma<float>(x, a, g1, c1, w1, b1, w2, b2, g2, c2, out, ntok, C, F,
                                    eps, s);
  if (dtype == 1)
    return univs::launch_fma<__nv_bfloat16>(x, a, g1, c1, w1, b1, w2, b2, g2, c2, out, ntok,
                                            C, F, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Hopper (sm_90a) building blocks for warp-specialised kernels: mbarriers,
// TMA tile loads, wgmma shared-memory descriptors and products, register
// reallocation between warpgroups, and the host-side tensor-map encoder
// (cuTensorMapEncodeTiled of libcuda, fetched through the runtime so that
// the library links against the runtime alone).  Kernels C and E use them.
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

namespace univs {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers (phase parity: a wait on parity p passes once the phase of
// parity p has completed; a fresh barrier is in phase 0, so a wait on 1
// passes at once)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA, proxies, named barriers, register reallocation
// ---------------------------------------------------------------------------

// a 2-D tile of `map` at element coordinates (c0 inner, c1 outer) into
// shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a 3-D box of `map` at element coordinates (c0 innermost .. c2) into
// shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma (bf16 in, float32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the start / wait points
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Descriptor of a K-major bf16 operand in the 128-byte swizzle, as TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 elements (128 B),
// 8-row atoms of 1024 B (stride byte offset), atoms 1024-byte aligned.  A
// k-step of 16 elements inside the atom is a start address 32 B further.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define UNIVS_F8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : UNIVS_F8(d, 0), UNIVS_F8(d, 8), UNIVS_F8(d, 16), UNIVS_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 256] += A[64 x 16] B[16 x 256], A from registers (the m64k16
// fragment: a[0] rows g, a[1] rows g + 8, a[2] / a[3] the same 8 columns
// further), B from shared memory
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : UNIVS_F8(d, 0), UNIVS_F8(d, 8), UNIVS_F8(d, 16), UNIVS_F8(d, 24), UNIVS_F8(d, 32),
        UNIVS_F8(d, 40), UNIVS_F8(d, 48), UNIVS_F8(d, 56), UNIVS_F8(d, 64), UNIVS_F8(d, 72),
        UNIVS_F8(d, 80), UNIVS_F8(d, 88), UNIVS_F8(d, 96), UNIVS_F8(d, 104), UNIVS_F8(d, 112),
        UNIVS_F8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Descriptor of an N-major bf16 B operand of width N (8, 16, 32 or 64):
// K rows of N contiguous elements (2N bytes), as TMA writes a box [K, N]
// with the swizzle of the row's width (128, 64 or 32 B; none for 16 B).
// Swizzled: 8-row atoms of 16N bytes, the next 8 rows of K one atom
// further (stride byte offset), a single atom across N.  Unswizzled: core
// matrices of 8 rows x 16 B, the next 8 rows of K 128 B further (leading
// byte offset).  A k-step of 16 rows is a start address 32N bytes further.
template <int N>
__device__ __forceinline__ uint64_t desc_nmajor(const void* p) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "N-major B: N = 8, 16, 32 or 64");
  constexpr uint64_t layout = N == 64 ? 1 : N == 32 ? 2 : N == 16 ? 3 : 0;
  constexpr uint64_t group = 16 * N;  // bytes of 8 rows of K
  const uint64_t addr = smem_u32(p);
  // the stride between 8-row groups of K; the other offset (between atoms
  // or core matrices across N) is not used at these widths
  const uint64_t lbo = N == 8 ? group : 16, sbo = N == 8 ? 16 : group;
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (layout << 62);
}

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (the m64k16
// fragment, as for wgmma_m64n256k16_rs), B N-major in shared memory
// (desc_nmajor<N>, transposed B); N = 8, 16, 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                                     uint64_t db);

#define UNIVS_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs_tb<8>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : UNIVS_F4(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs_tb<16>(float (&d)[8], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : UNIVS_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs_tb<32>(float (&d)[16], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : UNIVS_F8(d, 0), UNIVS_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : UNIVS_F8(d, 0), UNIVS_F8(d, 8), UNIVS_F8(d, 16), UNIVS_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef UNIVS_F4
#undef UNIVS_F8

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// map of a contiguous bf16 tensor of rank R (dims[0] innermost) read in
// boxes `box` with the swizzle `sw`; a box past the tensor's end is filled
// with zeros; returns a cudaError_t as int
template <int R>
inline int encode_bf16(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
                       const cuuint32_t (&box)[R], CUtensorMapSwizzle sw) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t strides[R - 1];
  cuuint32_t elem[R];
  cuuint64_t stride = 2;
  for (int i = 0; i < R; ++i) {
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
    elem[i] = 1;
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// map of a row-major bf16 matrix [outer, inner] read in boxes of
// [box_outer, box_inner] with the 128-byte swizzle (box_inner * 2 <= 128)
inline int encode_bf16_sw128(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                             uint32_t box_inner, uint32_t box_outer) {
  return encode_bf16<2>(map, base, {inner, outer}, {box_inner, box_outer},
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// the swizzle TMA must write for desc_nmajor<N>: that of a row of 2N bytes
// (128, 64 or 32 B; none for 16 B)
constexpr CUtensorMapSwizzle nmajor_swizzle(int N) {
  return N == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
         : N == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
         : N == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : CU_TENSOR_MAP_SWIZZLE_NONE;
}

}  // namespace sm90
}  // namespace univs

// Wide gathers for the tent kernels D (msda_tent_base.cu) and F
// (msda_tent_probe.cu): a lane's piece of a head's channels read as one
// load of VB bytes (1, 2, 4, 8 or 16) and held as 32-bit words, the
// elements taken out of it exactly (int8, bfloat16 or float), and the
// lane's float32 results stored as one piece of the output.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace univs {

template <int VB>
struct Piece {
  uint32_t w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Piece<VB> ld_piece(const void* p) {
  Piece<VB> r;
  if constexpr (VB == 32) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
    r.w[4] = v.x;
    r.w[5] = v.y;
    r.w[6] = v.z;
    r.w[7] = v.w;
  } else if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VB == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    static_assert(VB == 1, "a piece is 1, 2, 4, 8, 16 or 32 bytes");
    r.w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  return r;
}

// element k of a piece of V: an int for int8, else its float32 value
template <typename V, int VB>
__device__ __forceinline__ auto elem(const Piece<VB>& p, int k) {
  if constexpr (std::is_same<V, int8_t>::value) {
    return (int)(int8_t)(p.w[k >> 2] >> (8 * (k & 3)));
  } else if constexpr (std::is_same<V, __nv_bfloat16>::value) {
    const uint32_t w = p.w[k >> 1];
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(p.w[k]);
  }
}

// a and b rounded to T and back, as round_to<T> does each (bfloat16: one
// conversion for the pair)
template <typename T>
__device__ __forceinline__ void round2_to(float& a, float& b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
  } else {
    a = round_to<T>(a);
    b = round_to<T>(b);
  }
}

// The same for the two rows of a sample, each kept only if its row lies
// inside the level (else +0, as the law drops it); bfloat16 masks the
// pair while it unpacks it.
template <typename T>
__device__ __forceinline__ void round2_rows(float& a, float& b, bool va, bool vb) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    a = __uint_as_float(__byte_perm(u, 0u, va ? 0x1044u : 0x4444u));
    b = __uint_as_float(u & (vb ? 0xffff0000u : 0u));
  } else {
    a = va ? round_to<T>(a) : 0.f;
    b = vb ? round_to<T>(b) : 0.f;
  }
}

// NE results as T at out (aligned to NE * sizeof(T) bytes)
template <typename T, int NE>
__device__ __forceinline__ void store_piece(T* out, const float (&v)[NE]) {
  if constexpr (NE * sizeof(T) < 4) {
    out[0] = from_f32<T>(v[0]);
  } else {
    constexpr int NW = NE * (int)sizeof(T) / 4;
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        w[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    if constexpr (NW % 4 == 0) {
#pragma unroll
      for (int c = 0; c < NW / 4; ++c)
        reinterpret_cast<uint4*>(o)[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2],
                                                    w[4 * c + 3]);
    } else if constexpr (NW == 2) {
      *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
    } else {
      o[0] = w[0];
    }
  }
}

// The head sizes the tent kernels take: a divisor or a multiple of 32.
__host__ __device__ inline bool tent_head_ok(int D) {
  return D >= 1 && (D < 32 ? 32 % D : D % 32) == 0;
}

// Lanes a (frame, query, head) item takes for `pieces` pieces: all of
// them up to a warp, else a warp that loops over them.
__host__ __device__ inline int group_lanes(int pieces) { return pieces < 32 ? pieces : 32; }

}  // namespace univs

// Channel vectors of a channels_last tensor, shared by bn_relu.cu and
// bn_train.cu: V channels of one pixel (V = 4 fp32 or 8 bf16, 16 bytes; or
// V = 1 on the scalar route), loaded and stored in one access and handled
// as fp32 values, and the per-channel fp32 vectors beside them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// V elements of T, loaded and stored in one access, as fp32 values
template <typename T, int V>
struct Lanes;

template <>
struct Lanes<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[1]) { f[0] = r; }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) { return f[0]; }
};

template <>
struct Lanes<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) {
    return __float2bfloat16_rn(f[0]);
  }
};

template <>
struct Lanes<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Lanes<__nv_bfloat16, 8> {
  using Raw = uint4;
  // bf16 is the upper half of an fp32: exact
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[8]) {
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
    f[4] = __uint_as_float(r.z << 16);
    f[5] = __uint_as_float(r.z & 0xffff0000u);
    f[6] = __uint_as_float(r.w << 16);
    f[7] = __uint_as_float(r.w & 0xffff0000u);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[8]) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                      pack_bf16x2(f[6], f[7]));
  }
};

// V values of a float [C] array from channel c on: 16-byte loads where the
// array starts on a 16-byte address (c is then a multiple of 4)
template <int V>
__device__ __forceinline__ void load_stats(const float* __restrict__ p, int c, bool vec,
                                           float (&f)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p + c + j));
        f[j] = q.x;
        f[j + 1] = q.y;
        f[j + 2] = q.z;
        f[j + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = __ldg(p + c + j);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

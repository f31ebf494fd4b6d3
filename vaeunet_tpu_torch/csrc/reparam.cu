// Standard-normal noise and the fused VAE reparameterization for Hopper.
//
// Replaces vaeunet_tpu/ops/pallas/reparam.py: normal_pallas (the noise
// kernel behind ops/sampling.py::gaussian_like) and reparameterize_pallas
// (z = mu + eps * exp(0.5 * logvar) * T with eps drawn in the kernel).
//
// The TPU kernels draw bits from the TPU's hardware PRNG; Hopper has none,
// so the stream is a counter-based Philox4x32-10 written out below, with
// key = the 64-bit seed the wrapper draws from a torch.Generator.  One
// Philox call makes four consecutive elements: counter k = i >> 2 (in the
// low 64 bits) gives words (x, y, z, w), and Box-Muller turns each word pair
// into both of its normals, r cos t and r sin t with r = sqrt(-2 ln u1),
// t = 2 pi u2: (x, y) -> elements 4k, 4k + 1; (z, w) -> 4k + 2, 4k + 3.
// Bits map to uniforms as reparam.py:43-44 does (u1 = (b1 >> 8) * 2^-24 +
// 2^-25 is never 0; u2 = (b2 >> 8) * 2^-24).  Element i depends on its index
// only, so a draw is a prefix of any longer draw of the same seed.
//
// Bound on this card: bytes.  The noise kernel writes 4 bytes per element
// and reads nothing (12.58 M elements at the augmentation's [16,512,512,3]:
// 0.015 ms at 3.35 TB/s); the fused kernel reads 8 and writes 4.  The
// design meets it by sharing the arithmetic: a Philox call (10 rounds,
// about 100 integer operations) serves 4 elements, and one logf, one sqrtf
// and one sincosf serve 2, about 53 operations an element in all, which
// puts the operations term (0.010 ms) under the bytes term.  Each thread
// writes its 4 elements with one 16-byte store (a masked scalar tail where
// the count or the base is not a multiple of 4), and a grid of one wave of
// resident blocks walks the Philox calls in a grid-stride loop.
// The arithmetic is written with explicit _rn intrinsics so that no
// multiply-add is contracted and the plain PyTorch version
// (ops/pallas/reparam.py) reproduces it up to the ulps of
// logf/sincosf/expf.  Neither kernel has a backward: training draws eps with
// the noise kernel and keeps z = mu + eps * std in differentiable torch, and
// the fused kernel's wrapper raises if autograd would need one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
// one wave: 132 SMs x 8 blocks of 256 threads (2048 threads an SM)
constexpr int64_t kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kPhiloxW0;
    k.y += kPhiloxW1;
  }
  return c;
}

// both normals of one word pair: (r cos t, r sin t)
__device__ __forceinline__ float2 box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(b1 >> 8), 5.9604644775390625e-08f),
                             2.98023223876953125e-08f);
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), 5.9604644775390625e-08f);
  const float radius = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincosf(__fmul_rn(6.283185307179586f, u2), &s, &c);
  return make_float2(__fmul_rn(radius, c), __fmul_rn(radius, s));
}

// elements 4k .. 4k + 3 of the stream
__device__ __forceinline__ float4 normal4_at(int64_t k, uint2 key) {
  const uint64_t u = static_cast<uint64_t>(k);
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(u), static_cast<uint32_t>(u >> 32), 0u, 0u), key);
  const float2 a = box_muller(r.x, r.y);
  const float2 b = box_muller(r.z, r.w);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
normal_kernel(float* __restrict__ out, int64_t n, uint2 key) {
  const int64_t calls = (n + 3) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; k < calls;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = normal4_at(k, key);
    const int64_t i = k << 2;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<float4*>(out + i) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) out[i + j] = lane_of(v, j);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
reparam_kernel(const float* __restrict__ mu, const float* __restrict__ logvar,
               float temperature, float* __restrict__ z, int64_t n, uint2 key) {
  const int64_t calls = (n + 3) >> 2;
  for (int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; k < calls;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 eps = normal4_at(k, key);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = (k << 2) + j;
      if (i < n) {
        const float std = __fmul_rn(expf(__fmul_rn(0.5f, logvar[i])), temperature);
        z[i] = __fadd_rn(mu[i], __fmul_rn(lane_of(eps, j), std));
      }
    }
  }
}

unsigned int blocks_for(int64_t n) {
  const int64_t calls = (n + 3) / 4;
  const int64_t b = (calls + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

uint2 key_of(uint64_t seed) {
  return make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

}  // namespace

extern "C" {

int vaeunet_normal(float* out, int64_t n, uint64_t seed, void* stream) {
  normal_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, key_of(seed));
  return static_cast<int>(cudaGetLastError());
}

int vaeunet_reparam(const float* mu, const float* logvar, float temperature, float* z, int64_t n,
                    uint64_t seed, void* stream) {
  reparam_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, logvar, temperature, z, n, key_of(seed));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

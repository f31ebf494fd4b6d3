// Standard-normal noise and the fused VAE reparameterization for Hopper.
//
// Replaces vaeunet_tpu/ops/pallas/reparam.py: normal_pallas (the noise
// kernel behind ops/sampling.py::gaussian_like) and reparameterize_pallas
// (z = mu + eps * exp(0.5 * logvar) * T with eps drawn in the kernel).
//
// The TPU kernels draw bits from the TPU's hardware PRNG; Hopper has none,
// so each element draws from a counter-based Philox4x32-10 stream written
// out below: counter = element index, key = the 64-bit seed the wrapper
// draws from a torch.Generator.  Bits map to uniforms exactly as
// reparam.py:43-44 does (u1 = (b1 >> 8) * 2^-24 + 2^-25 is never 0) and
// to a normal by Box-Muller, z = sqrt(-2 ln u1) * cos(2 pi u2).
//
// Bound on this card: bytes.  The noise kernel writes 4 bytes per element
// and reads nothing; the fused kernel reads 8 and writes 4.  Philox is ~40
// integer operations per element, far below the card's integer rate for
// these sizes, so one thread per element in a grid-stride loop is enough.
// The arithmetic is written with explicit _rn intrinsics so that no
// multiply-add is contracted and the plain PyTorch version
// (ops/pallas/reparam.py) reproduces it up to the ulps of logf/cosf/expf.
// Neither kernel has a backward: training draws eps with the noise kernel
// and keeps z = mu + eps * std in differentiable torch, and the fused
// kernel's wrapper raises if autograd would need one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

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

__device__ __forceinline__ float normal_at(int64_t i, uint2 key) {
  const uint64_t u = static_cast<uint64_t>(i);
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(u), static_cast<uint32_t>(u >> 32), 0u, 0u), key);
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(r.x >> 8), 5.9604644775390625e-08f),
                             2.98023223876953125e-08f);
  const float u2 = __fmul_rn(static_cast<float>(r.y >> 8), 5.9604644775390625e-08f);
  const float radius = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(radius, cosf(__fmul_rn(6.283185307179586f, u2)));
}

__global__ void normal_kernel(float* __restrict__ out, int64_t n, uint2 key) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    out[i] = normal_at(i, key);
  }
}

__global__ void reparam_kernel(const float* __restrict__ mu, const float* __restrict__ logvar,
                               float temperature, float* __restrict__ z, int64_t n, uint2 key) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float std = __fmul_rn(expf(__fmul_rn(0.5f, logvar[i])), temperature);
    z[i] = __fadd_rn(mu[i], __fmul_rn(normal_at(i, key), std));
  }
}

unsigned int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
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

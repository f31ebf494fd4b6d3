// Eval-mode BatchNorm + ReLU over a channels_last tensor, for Hopper.
//
// Replaces vaeunet_tpu/ops/pallas/bn_relu.py::fused_bn_relu.  The wrapper
// (ops/pallas/bn_relu.py) folds the running statistics in fp32 exactly as
// the TPU kernel does, a = scale * rsqrt(var + eps) and b = bias - mean * a,
// and this kernel applies y = max(x * a + b, 0) per channel.
//
// Bound on this card: bytes, 2 x tensor bytes / 3.35 TB/s (each element is
// read once and written once; a and b are C floats that stay in L1).  The
// TPU kernel streamed (rows, C) tiles through VMEM; here a channels_last
// tensor is already a flat [N*H*W, C] array, so the kernel is one
// grid-stride pass with channel = index mod C, using 16-byte float4 loads
// and stores when C % 4 == 0.  The product and the sum are rounded
// separately (__fmul_rn, __fadd_rn) so that the plain PyTorch version
// gives the same bits.  bf16 inputs are computed in fp32 and rounded once
// on store, as the TPU kernel does.  There is no backward: the kernel is
// for eval mode, and its wrapper raises if autograd would need one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ float bn_relu1(float x, float a, float b) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return v < 0.0f ? 0.0f : v;  // propagates NaN like torch.relu
}

__global__ void bn_relu_f32_vec4(const float4* __restrict__ x, const float* __restrict__ a,
                                 const float* __restrict__ b, float4* __restrict__ y,
                                 int64_t n4, int c) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>((i * 4) % c);
    const float4 v = x[i];
    float4 r;
    r.x = bn_relu1(v.x, a[ch], b[ch]);
    r.y = bn_relu1(v.y, a[ch + 1], b[ch + 1]);
    r.z = bn_relu1(v.z, a[ch + 2], b[ch + 2]);
    r.w = bn_relu1(v.w, a[ch + 3], b[ch + 3]);
    y[i] = r;
  }
}

__global__ void bn_relu_f32(const float* __restrict__ x, const float* __restrict__ a,
                            const float* __restrict__ b, float* __restrict__ y, int64_t n, int c) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % c);
    y[i] = bn_relu1(x[i], a[ch], b[ch]);
  }
}

__global__ void bn_relu_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                             const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int64_t n,
                             int c) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % c);
    y[i] = __float2bfloat16_rn(bn_relu1(__bfloat162float(x[i]), a[ch], b[ch]));
  }
}

unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

int vaeunet_bn_relu_f32(const float* x, const float* a, const float* b, float* y, int64_t n, int c,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (c % 4 == 0 && aligned) {
    const int64_t n4 = n / 4;  // n is a multiple of c, hence of 4
    bn_relu_f32_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), a, b, reinterpret_cast<float4*>(y), n4, c);
  } else {
    bn_relu_f32<<<blocks_for(n), kThreads, 0, s>>>(x, a, b, y, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

int vaeunet_bn_relu_bf16(const void* x, const float* a, const float* b, void* y, int64_t n, int c,
                         void* stream) {
  bn_relu_bf16<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), a, b, static_cast<__nv_bfloat16*>(y), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

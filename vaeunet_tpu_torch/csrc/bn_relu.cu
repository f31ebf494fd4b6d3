// Eval-mode BatchNorm + ReLU over a channels_last tensor, for Hopper.
//
// Replaces vaeunet_tpu/ops/pallas/bn_relu.py::fused_bn_relu: y = max(x * a +
// b, 0) per channel, with the running statistics folded in fp32 exactly as
// the TPU kernel folds them, a = scale * rsqrt(var + eps) and b = bias -
// mean * a.  bf16 inputs are computed in fp32 and rounded once on store, as
// the TPU kernel does.  There is no backward: the kernel is for eval mode,
// and its wrapper raises if autograd would need one.
//
// Bound on this card: bytes, 2 x tensor bytes / 3.35 TB/s (each element is
// read once and written once; the four [C] statistics stay in L1 and L2).
//
// The fold is inside the kernel.  The first design took (a, b) from the
// wrapper, which computed them with five small torch ops on every call: six
// launches a call, where the call is 2.5 us of work at the narrow decoder
// shapes.  Here each thread folds the channels it owns once, into registers,
// with the rounding steps of the torch ops the plain version is held to on
// the card: __fadd_rn for var + eps, rsqrtf (what torch's CUDA rsqrt calls
// for float), __fmul_rn for scale * r and mean * a, __fsub_rn for bias - m.
// The intrinsics are never contracted into an FMA, so the bits are torch's.
//
// The TPU kernel streamed (rows, C) tiles through VMEM.  A channels_last
// tensor is a flat [rows, C] array, rows = N * H * W, so a block is
// block_x channel vectors (V = 4 fp32 or 8 bf16 channels, 16 bytes) by
// block_y rows: a thread's channel vector is fixed, and it walks rows
// kRowsInFlight at a time, all loads issued before the first store, with no
// division or modulo in the loop.  Where C / V exceeds the block's width
// (C = 2048 on the resnet50 path), blockIdx.y takes the channel chunks.  The
// block covers block_y x kRowsInFlight neighbouring rows, one contiguous run
// of memory, and the grid is sized for the tensor (a grid-stride loop covers
// what a grid of 2^31 - 1 blocks cannot).
//
// Two routes, planned on the host from the shape and the addresses alone
// (ops/pallas/bn_relu.py::plan), never as a fallback after a failed launch:
// the vector route (C a multiple of V, x and y on 16-byte addresses) and the
// scalar route (V = 1, one 2- or 4-byte element a thread a row) for every
// other tensor, such as a ragged C or a view off a 16-byte address.  Both
// do the same arithmetic.  The entries check the plan and return
// cudaErrorInvalidValue for one they cannot launch.

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;       // the most a plan's block may hold
constexpr int kRowsInFlight = 4;    // loads a thread issues before its first store

__device__ __forceinline__ float bn_relu1(float x, float a, float b) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return v < 0.0f ? 0.0f : v;  // propagates NaN like torch.relu
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_kernel(const typename Lanes<T, V>::Raw* __restrict__ x,
               typename Lanes<T, V>::Raw* __restrict__ y, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ mean,
               const float* __restrict__ var, float eps, int64_t rows, int vecs,
               bool vec_stats) {
  using L = Lanes<T, V>;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;     // this thread's channel vector
  if (v >= vecs) return;

  // the fold of this thread's V channels, once
  float a[V], b[V], s[V], m[V];
  load_stats<V>(scale, v * V, vec_stats, s);
  load_stats<V>(var, v * V, vec_stats, a);
  load_stats<V>(bias, v * V, vec_stats, b);
  load_stats<V>(mean, v * V, vec_stats, m);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = __fmul_rn(s[j], rsqrtf(__fadd_rn(a[j], eps)));
    b[j] = __fsub_rn(b[j], __fmul_rn(m[j], a[j]));
  }

  const int64_t by = blockDim.y;
  const int64_t step = static_cast<int64_t>(gridDim.x) * by * kRowsInFlight;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * by * kRowsInFlight + threadIdx.y;
       r0 < rows; r0 += step) {
    typename L::Raw in[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * by;
      if (r < rows) in[u] = x[r * vecs + v];
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * by;
      if (r >= rows) break;
      float f[V];
      L::unpack(in[u], f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = bn_relu1(f[j], a[j], b[j]);
      y[r * vecs + v] = L::pack(f);
    }
  }
}

// Launch the plan made on the host: `vec` channels a thread (V), a block of
// block_x vectors by block_y rows, grid_x row groups by grid_y channel chunks.
template <typename T, int kVec>
int launch(const T* x, T* y, const float* scale, const float* bias, const float* mean,
           const float* var, float eps, int64_t rows, int c, int vec, int block_x, int block_y,
           int grid_x, int grid_y, void* stream) {
  if (rows <= 0 || c <= 0 || block_x <= 0 || block_y <= 0 || block_x * block_y > kThreads ||
      grid_x <= 0 || grid_y <= 0 || grid_y > 65535 || (vec != 1 && vec != kVec) ||
      c % vec != 0 || static_cast<int64_t>(block_x) * grid_y < c / vec ||
      (vec != 1 && !(aligned16(x) && aligned16(y))))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(grid_x), static_cast<unsigned int>(grid_y));
  const dim3 block(static_cast<unsigned int>(block_x), static_cast<unsigned int>(block_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 1) {
    bn_relu_kernel<T, 1><<<grid, block, 0, s>>>(x, y, scale, bias, mean, var, eps, rows, c,
                                                 false);
  } else {
    using Raw = typename Lanes<T, kVec>::Raw;
    const bool vec_stats = aligned16(scale) && aligned16(bias) && aligned16(mean) &&
                           aligned16(var);
    bn_relu_kernel<T, kVec><<<grid, block, 0, s>>>(
        reinterpret_cast<const Raw*>(x), reinterpret_cast<Raw*>(y), scale, bias, mean, var, eps,
        rows, c / kVec, vec_stats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and y [rows, c] (a channels_last tensor), scale / bias / mean / var
// float32 [c]; returns a cudaError_t: 0, the launch's, or that of a refused plan.
int vaeunet_bn_relu_f32(const float* x, float* y, const float* scale, const float* bias,
                        const float* mean, const float* var, float eps, int64_t rows, int c,
                        int vec, int block_x, int block_y, int grid_x, int grid_y, void* stream) {
  return launch<float, 4>(x, y, scale, bias, mean, var, eps, rows, c, vec, block_x, block_y,
                          grid_x, grid_y, stream);
}

int vaeunet_bn_relu_bf16(const void* x, void* y, const float* scale, const float* bias,
                         const float* mean, const float* var, float eps, int64_t rows, int c,
                         int vec, int block_x, int block_y, int grid_x, int grid_y,
                         void* stream) {
  return launch<__nv_bfloat16, 8>(static_cast<const __nv_bfloat16*>(x),
                                  static_cast<__nv_bfloat16*>(y), scale, bias, mean, var, eps,
                                  rows, c, vec, block_x, block_y, grid_x, grid_y, stream);
}

}  // extern "C"

// One optimizer step over a list of float32 tensors, for Hopper: clip by
// global norm (optax's clip_by_global_norm) then AdamW, in two launches.
//
// Replaces no Pallas kernel: the JAX package leaves optax's clip and adamw
// to XLA, which fuses them into a few loops.  In the port the same math ran
// as torch ops: seven aten calls a tensor for the clip (its square, sum,
// the running add, the division, the product, where, copy_) and torch's
// foreach AdamW, about nine `_foreach_*` ops each split into several
// multi_tensor_apply launches: ~1,450-1,800 launches a step for the
// VAE-UNets, most of the training step's host time.
//
//   norm      ||g|| = sqrt(sum over every tensor of g^2): each block sums the
//             squares of its chunks in fp32 and writes one partial; the block
//             that takes the last ticket sums the partials in a fixed order,
//             writes sqrt into `norm` and resets the ticket.  No atomics on
//             values: the result repeats bit for bit from run to run.
//   update    g' = g where norm < max_norm, else g / norm * max_norm (written
//             back into g then, so .grad holds the clipped gradient as after
//             the torch path); then torch's AdamW on g', in the order and with
//             the roundings of torch's CUDA foreach ops (_multi_tensor_adam):
//               p  = p * (1 - lr wd)                        _foreach_mul_
//               m  = fma(1 - b1, g' - m, m)                  _foreach_lerp_ (b1 > 0.5)
//               v  = v * b2, then fma(1 - b2, g' g', v)       _foreach_mul_, _addcmul_
//               d  = sqrt(v) / sqrt(bc2) + eps               _sqrt, _div_, _add_
//               p  = fma(-(lr / bc1), m / d, p)              _foreach_addcdiv_
//             every step an IEEE rounding of its own (__fmul_rn, __fdiv_rn,
//             __fsqrt_rn, ...), the fused ones where torch's kernels fuse, so
//             nvcc contracts nothing else.  The host passes the scalars as
//             torch rounds them: 1 - lr wd, bc1 and bc2 made in double from
//             the step count, then rounded to fp32.
//
// The tensor table: a launch takes up to kMaxTensors tensors as a kernel
// parameter (__grid_constant__, read from the constant bank; CUDA >= 12.1
// allows 32,764 bytes of parameters): each tensor's pointers, its elements,
// its first chunk (kChunk elements a chunk) and its two bias-correction
// scalars.  A block walks the chunks blockIdx.x, + gridDim.x, ... and finds
// a chunk's tensor by a binary search over the first chunks.  The port's
// models have 104 to 263 parameter tensors; the entries refuse more than
// kMaxTensors.
//
// Bound on this card: bytes.  The least a step moves is g read twice (the
// norm, then the update), p, m and v read and written: 32 bytes an element
// (and 4 more where it clips, g written back) at 3.35 TB/s; ~0.29 ms for
// the resnet34 VAE-UNet's 30.5 M parameters.  The design keeps to that:
// one pass over g for the norm, one over g, p, m and v for the update, every
// intermediate in registers; 16-byte loads and stores where the four
// tensors sit on 16-byte addresses (a chunk starts on a multiple of 4
// elements), a scalar tail for a ragged numel; blocks enough to fill the
// SMs (the host sizes the grid: a few blocks an SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // a block
constexpr int kChunk = 16384;        // elements a chunk: 16 vectors of 4 a thread
constexpr int kMaxTensors = 512;     // tensors a launch's table holds

// the norm's table: 10,248 bytes
struct NormTable {
  const float* g[kMaxTensors];
  int64_t n[kMaxTensors];
  int chunk0[kMaxTensors + 1];       // each tensor's first chunk; [count] = the chunks
  int count;
};

// the update's table: 26,632 bytes
struct UpdateTable {
  float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  int64_t n[kMaxTensors];
  int chunk0[kMaxTensors + 1];
  float step_size[kMaxTensors];      // -(lr / bc1)
  float bc2_sqrt[kMaxTensors];       // sqrt(bc2)
  int count;
};

// AdamW's scalars, rounded to fp32 on the host as torch rounds a Python
// scalar into a float tensor's op
struct Hyper {
  float decay;      // 1 - lr wd
  float w1;         // 1 - b1, the lerp's weight
  float beta2;
  float c2;         // 1 - b2
  float eps;
  float max_norm;
};

// the last k with chunk0[k] <= c (a tensor of no chunks is passed over)
__device__ __forceinline__ int find_tensor(const int* chunk0, int count, int c) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk0[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Sums v over the block in a fixed order (shuffles down within each warp,
// then the warps' sums in warp 0); thread 0 holds the result.  `red` holds
// kThreads / 32 floats; the caller syncs before reusing it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Pass 1: the global norm.  Thread t of a block takes vectors t, t + 256, ...
// of each of its chunks into four lane sums (fma(x, x, s)), a ragged tail's
// elements (one a thread) and an unaligned tensor's elements into lane 0;
// its sum is (s0 + s1) + (s2 + s3).
__global__ void __launch_bounds__(kThreads)
clip_adamw_norm_kernel(const __grid_constant__ NormTable t, float* partial,
                       unsigned int* ticket, float* norm) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  const int chunks = t.chunk0[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int k = find_tensor(t.chunk0, t.count, c);
    const int64_t base = static_cast<int64_t>(c - t.chunk0[k]) * kChunk;
    const int len = static_cast<int>(min(static_cast<int64_t>(kChunk), t.n[k] - base));
    const float* g = t.g[k] + base;
    if (aligned16(t.g[k])) {
      const int vecs = len >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int i = threadIdx.x; i < vecs; i += kThreads) {
        const float4 x = g4[i];
        s0 = __fmaf_rn(x.x, x.x, s0);
        s1 = __fmaf_rn(x.y, x.y, s1);
        s2 = __fmaf_rn(x.z, x.z, s2);
        s3 = __fmaf_rn(x.w, x.w, s3);
      }
      const int i = (vecs << 2) + threadIdx.x;
      if (i < len) s0 = __fmaf_rn(g[i], g[i], s0);
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads) s0 = __fmaf_rn(g[i], g[i], s0);
    }
  }
  const float sum = block_sum(__fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3)), red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = sum;
    __threadfence();       // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: thread t adds partials t, t + 256, ... in turn
  float acc = 0.0f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    acc = __fadd_rn(acc, __ldcg(partial + i));
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    *norm = __fsqrt_rn(total);
    *ticket = 0;
  }
}

// torch's lerp(self, end, weight) as its CUDA kernels compute it
__device__ __forceinline__ float lerp(float self, float end, float w) {
  const float diff = __fsub_rn(end, self);
  return fabsf(w) < 0.5f ? __fmaf_rn(w, diff, self)
                         : __fmaf_rn(-diff, __fsub_rn(1.0f, w), end);
}

// One element: the clip, then AdamW (the file's comment).
__device__ __forceinline__ void update1(float& g, float& p, float& m, float& v, float norm,
                                        bool clip, float step_size, float bc2_sqrt,
                                        const Hyper& h) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
  p = __fmul_rn(p, h.decay);
  m = lerp(m, g, h.w1);
  v = __fmaf_rn(h.c2, __fmul_rn(g, g), __fmul_rn(v, h.beta2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2_sqrt), h.eps);
  p = __fmaf_rn(step_size, __fdiv_rn(m, d), p);
}

// Pass 2: the clip and AdamW, element by element, on the norm's chunk map.
__global__ void __launch_bounds__(kThreads)
clip_adamw_update_kernel(const __grid_constant__ UpdateTable t, const float* __restrict__ norm_in,
                         Hyper h) {
  const float norm = *norm_in;
  const bool clip = !(norm < h.max_norm);     // torch.where(norm < max_norm, g, ...)
  const int chunks = t.chunk0[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int k = find_tensor(t.chunk0, t.count, c);
    const int64_t base = static_cast<int64_t>(c - t.chunk0[k]) * kChunk;
    const int len = static_cast<int>(min(static_cast<int64_t>(kChunk), t.n[k] - base));
    float* g = t.g[k] + base;
    float* p = t.p[k] + base;
    float* m = t.m[k] + base;
    float* v = t.v[k] + base;
    const float ss = t.step_size[k], bs = t.bc2_sqrt[k];
    int done = 0;
    if (aligned16(t.g[k]) && aligned16(t.p[k]) && aligned16(t.m[k]) && aligned16(t.v[k])) {
      const int vecs = len >> 2;
      float4* g4 = reinterpret_cast<float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (int i = threadIdx.x; i < vecs; i += kThreads) {
        float4 gv = g4[i], pv = p4[i], mv = m4[i], vv = v4[i];
        update1(gv.x, pv.x, mv.x, vv.x, norm, clip, ss, bs, h);
        update1(gv.y, pv.y, mv.y, vv.y, norm, clip, ss, bs, h);
        update1(gv.z, pv.z, mv.z, vv.z, norm, clip, ss, bs, h);
        update1(gv.w, pv.w, mv.w, vv.w, norm, clip, ss, bs, h);
        p4[i] = pv;
        m4[i] = mv;
        v4[i] = vv;
        if (clip) g4[i] = gv;
      }
      done = vecs << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) {
      float gs = g[i], ps = p[i], ms = m[i], vs = v[i];
      update1(gs, ps, ms, vs, norm, clip, ss, bs, h);
      p[i] = ps;
      m[i] = ms;
      v[i] = vs;
      if (clip) g[i] = gs;
    }
  }
}

// The host's table (int64 rows of `count`: g, p, m, v, numel) into a
// launch's: its chunk map -> the chunks, or -1 for a table the map cannot
// take.
template <typename Table>
int fill_map(Table& t, const int64_t* table, int count) {
  if (count <= 0 || count > kMaxTensors) return -1;
  t.count = count;
  t.chunk0[0] = 0;
  int64_t chunks = 0;
  for (int k = 0; k < count; ++k) {
    const int64_t n = table[4 * count + k];
    if (n < 0) return -1;
    t.n[k] = n;
    chunks += (n + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffff) return -1;
    t.chunk0[k + 1] = static_cast<int>(chunks);
  }
  return static_cast<int>(chunks);
}

int grid_of(int chunks, int blocks) { return chunks < 1 ? 1 : (chunks < blocks ? chunks : blocks); }

}  // namespace

extern "C" {

// table: int64 rows of `count` (at most 512): g, p, m, v (addresses of
// float32 tensors, dense, of one layout each), numel.  partial: float32
// scratch of at least `blocks`; ticket: one uint32, zero between launches
// (the last block resets it); norm: one float32, written.  blocks: the most
// blocks of the launch.  Returns a cudaError_t.
int vaeunet_clip_adamw_norm(const int64_t* table, int count, float* partial,
                            unsigned int* ticket, float* norm, int blocks, void* stream) {
  NormTable t;
  const int chunks = fill_map(t, table, count);
  if (chunks < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < count; ++k) t.g[k] = reinterpret_cast<const float*>(table[k]);
  clip_adamw_norm_kernel<<<grid_of(chunks, blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t, partial, ticket, norm);
  return static_cast<int>(cudaGetLastError());
}

// table as above; scalars: float32 rows of `count`: -(lr / bc1), sqrt(bc2);
// norm: the norm launch's; then AdamW's scalars and max_norm.
int vaeunet_clip_adamw_update(const int64_t* table, const float* scalars, int count,
                              const float* norm, float decay, float w1, float beta2, float c2,
                              float eps, float max_norm, int blocks, void* stream) {
  UpdateTable t;
  const int chunks = fill_map(t, table, count);
  if (chunks < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < count; ++k) {
    t.g[k] = reinterpret_cast<float*>(table[k]);
    t.p[k] = reinterpret_cast<float*>(table[count + k]);
    t.m[k] = reinterpret_cast<float*>(table[2 * count + k]);
    t.v[k] = reinterpret_cast<float*>(table[3 * count + k]);
    t.step_size[k] = scalars[k];
    t.bc2_sqrt[k] = scalars[count + k];
  }
  clip_adamw_update_kernel<<<grid_of(chunks, blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(t, norm,
                                                                  Hyper{decay, w1, beta2, c2,
                                                                        eps, max_norm});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

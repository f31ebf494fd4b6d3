// 3x3, pad 1, stride 1, bias-free convolution of a channels_last tensor that
// also returns the per-channel sum and sum of squares of its output, for
// Hopper.
//
// Replaces vaeunet_tpu/ops/pallas/conv_bn_stats.py::conv3x3_bn_stats (its
// _kernel and _conv3x3_stats_fwd).  The TPU kernel walks a sequential grid
// of (batch, row tile) cells, does 9 shifted [TH*W, Ci] x [Ci, Co] MXU dots
// per cell and carries the two moments in one revisited (8, Co) block.  On
// this card blocks run in parallel and in no order, so nothing carries
// across the grid: each block writes its partial moments to a row of a
// [n_tiles, Co] scratch, and a second kernel (reduce_partials_kernel)
// reduces the rows of each channel in a fixed order.  The moments are
// therefore deterministic and need no atomics.
//
// conv3x3_stats_kernel: one block computes an output tile of TH x TW pixels
// of one image by TCO output channels.  For each chunk of TCI input
// channels it stages the (TH+2) x (TW+2) x TCI input patch, halo included
// and zero outside the image (the padding), and the 3 x 3 x TCI x TCO weight
// slice in shared memory, both as fp32, then every thread accumulates 4
// pixels x 8 channels in registers with fp32 FMAs.  Pixels outside H x W and
// channels beyond Co are masked on the way out, so the moments cover only
// the valid output; that replaces the TPU wrapper's row-padding branch
// (conv_bn_stats.py:100-107).  The moments are taken from the fp32
// accumulators before y is rounded to its type, as the TPU kernel takes
// them (conv_bn_stats.py:56-60).  Any Ci and Co work: a ragged chunk or
// tile is zero-filled.
//
// Bound on this card: operations, 2 * B*H*W*Ci*Co*9 over the tensor-core
// peak of the input type (989 TFLOP/s bf16, and fp32 has no tensor-core
// path here: 67 TFLOP/s), far above the bytes term at the step's shapes.
// This first kernel runs on the fp32 SIMT pipes for both types, and its
// inner loop does 12 shared-memory loads per 32 FMAs, so it is bound by
// shared-memory bandwidth well below either peak; mma.sync or wgmma tiles
// are the later work that would close the gap.
//
// Weights come in HWIO order ([3][3][Ci][Co], Co fastest), which the
// wrapper makes from PyTorch's OIHW.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;             // output rows per tile
constexpr int kTW = 16;            // output columns per tile
constexpr int kTCI = 8;            // input channels per shared-memory chunk
constexpr int kTCO = 64;           // output channels per tile
constexpr int kThreads = 256;
constexpr int kPH = kTH + 2;
constexpr int kPW = kTW + 2;
constexpr int kPatch = kPH * kPW * kTCI;       // 1440 floats
constexpr int kWeights = 9 * kTCI * kTCO;      // 4608 floats
constexpr int kPix = 4;                        // pixels per thread: one row, columns pc + 4p
constexpr int kCo = 8;                         // channels per thread: cg + 8j
constexpr int kPixGroups = kThreads / (kTCO / kCo);   // 32
constexpr int kReduceLanes = 32;               // rows reduced side by side per channel

static_assert(kPixGroups * kPix == kTH * kTW, "tile and thread map disagree");
static_assert(2 * kPixGroups * kTCO <= kPatch + kWeights, "moment scratch must fit");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                     float* __restrict__ part_s, float* __restrict__ part_q, int H, int W,
                     int Ci, int Co, int tiles_h, int tiles_w) {
  __shared__ float smem[kPatch + kWeights];
  float* xs = smem;             // [kPH][kPW][kTCI]
  float* ws = smem + kPatch;    // [9][kTCI][kTCO]

  const int tile = blockIdx.x;
  const int tw_i = tile % tiles_w;
  const int th_i = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  const int h0 = th_i * kTH;
  const int w0 = tw_i * kTW;
  const int co0 = blockIdx.y * kTCO;

  const int t = threadIdx.x;
  const int cg = t % (kTCO / kCo);   // channels cg + 8j
  const int pg = t / (kTCO / kCo);   // pixel group 0..31
  const int pr = pg / 4;             // tile row
  const int pc = pg % 4;             // tile columns pc + 4p

  float acc[kPix][kCo];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[p][j] = 0.0f;

  const int64_t x_img = static_cast<int64_t>(b) * H * W * Ci;
  for (int ci0 = 0; ci0 < Ci; ci0 += kTCI) {
    for (int i = t; i < kPatch; i += kThreads) {
      const int ci = i % kTCI;
      const int pix = i / kTCI;
      const int hh = h0 - 1 + pix / kPW;
      const int ww = w0 - 1 + pix % kPW;
      const int cc = ci0 + ci;
      float v = 0.0f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc < Ci)
        v = to_f(x[x_img + (static_cast<int64_t>(hh) * W + ww) * Ci + cc]);
      xs[i] = v;
    }
    for (int i = t; i < kWeights; i += kThreads) {
      const int co = i % kTCO;
      const int r = i / kTCO;
      const int ci = r % kTCI;
      const int k = r / kTCI;
      const int cc = ci0 + ci;
      const int oc = co0 + co;
      float v = 0.0f;
      if (cc < Ci && oc < Co) v = to_f(w[(static_cast<int64_t>(k) * Ci + cc) * Co + oc]);
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < kTCI; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float a[kPix];
          float bw[kCo];
#pragma unroll
          for (int p = 0; p < kPix; ++p)
            a[p] = xs[((pr + ky) * kPW + pc + 4 * p + kx) * kTCI + ci];
#pragma unroll
          for (int j = 0; j < kCo; ++j) bw[j] = ws[((ky * 3 + kx) * kTCI + ci) * kTCO + cg + 8 * j];
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int j = 0; j < kCo; ++j) acc[p][j] = fmaf(a[p], bw[j], acc[p][j]);
        }
      }
    }
    __syncthreads();
  }

  // write y; this thread's moments over its valid pixels, from fp32
  float ls[kCo];
  float lq[kCo];
#pragma unroll
  for (int j = 0; j < kCo; ++j) {
    ls[j] = 0.0f;
    lq[j] = 0.0f;
  }
  const int hh = h0 + pr;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int ww = w0 + pc + 4 * p;
    if (hh < H && ww < W) {
      const int64_t base = ((static_cast<int64_t>(b) * H + hh) * W + ww) * Co;
#pragma unroll
      for (int j = 0; j < kCo; ++j) {
        const int oc = co0 + cg + 8 * j;
        if (oc < Co) {
          const float v = acc[p][j];
          put(y, base + oc, v);
          ls[j] += v;
          lq[j] += v * v;
        }
      }
    }
  }
  // the block's moments: the 32 pixel groups of each channel, in order
  float* red_s = smem;                       // [kPixGroups][kTCO]
  float* red_q = smem + kPixGroups * kTCO;   // [kPixGroups][kTCO]
#pragma unroll
  for (int j = 0; j < kCo; ++j) {
    red_s[pg * kTCO + cg + 8 * j] = ls[j];
    red_q[pg * kTCO + cg + 8 * j] = lq[j];
  }
  __syncthreads();
  if (t < 2 * kTCO) {
    const int co = t % kTCO;
    const float* red = t < kTCO ? red_s : red_q;
    float v = 0.0f;
    for (int g = 0; g < kPixGroups; ++g) v += red[g * kTCO + co];
    if (co0 + co < Co) {
      float* part = t < kTCO ? part_s : part_q;
      part[static_cast<int64_t>(tile) * Co + co0 + co] = v;
    }
  }
}

// out[c] = sum over rows r of part[r][c], in a fixed order: lane l of
// channel c sums rows l, l + 32, ... in turn, then the 32 lane sums are
// added in lane order.  blockIdx.y picks the sums (0) or the squares (1).
__global__ void __launch_bounds__(kReduceLanes * 32)
reduce_partials_kernel(const float* __restrict__ part_s, const float* __restrict__ part_q,
                       float* __restrict__ s, float* __restrict__ q, int rows, int Co) {
  __shared__ float lanes[kReduceLanes][33];
  const float* part = blockIdx.y == 0 ? part_s : part_q;
  float* out = blockIdx.y == 0 ? s : q;
  const int cx = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float v = 0.0f;
  if (c < Co)
    for (int r = lane; r < rows; r += kReduceLanes) v += part[static_cast<int64_t>(r) * Co + c];
  lanes[lane][cx] = v;
  __syncthreads();
  if (lane == 0 && c < Co) {
    float total = 0.0f;
    for (int l = 0; l < kReduceLanes; ++l) total += lanes[l][cx];
    out[c] = total;
  }
}

// `tiles` is the row count of the scratch the wrapper allocated; it must
// equal the grid's tile count, or nothing is launched.
template <typename T>
int launch(const T* x, const T* w, T* y, float* part_s, float* part_q, float* s, float* q, int B,
           int H, int W, int Ci, int Co, int tiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = (W + kTW - 1) / kTW;
  if (tiles != B * tiles_h * tiles_w) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>((Co + kTCO - 1) / kTCO));
  conv3x3_stats_kernel<T><<<grid, kThreads, 0, st>>>(x, w, y, part_s, part_q, H, W, Ci, Co,
                                                     tiles_h, tiles_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid(static_cast<unsigned int>((Co + 31) / 32), 2);
  reduce_partials_kernel<<<rgrid, kReduceLanes * 32, 0, st>>>(part_s, part_q, s, q, tiles, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vaeunet_conv3x3_stats_f32(const float* x, const float* w, float* y, float* part_s,
                              float* part_q, float* s, float* q, int B, int H, int W, int Ci,
                              int Co, int tiles, void* stream) {
  return launch(x, w, y, part_s, part_q, s, q, B, H, W, Ci, Co, tiles, stream);
}

int vaeunet_conv3x3_stats_bf16(const void* x, const void* w, void* y, float* part_s,
                               float* part_q, float* s, float* q, int B, int H, int W, int Ci,
                               int Co, int tiles, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                static_cast<__nv_bfloat16*>(y), part_s, part_q, s, q, B, H, W, Ci, Co, tiles,
                stream);
}

}  // extern "C"

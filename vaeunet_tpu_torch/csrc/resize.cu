// Bilinear resize of a channels_last tensor along H and W, for Hopper.
//
// Replaces vaeunet_tpu/ops/pallas/resize_mm.py::resize_h and ::resize_w
// (forward).  The TPU kernels multiply by the dense [out, in] interpolation
// matrix on the MXU, one axis per kernel.  That matrix has two nonzeros per
// row, so on this card the same function is a gather of four neighbours
// and a blend, both axes in one pass: one thread per output element of the
// physical [B, OH, OW, C] array, channel fastest, so neighbouring threads
// read and write neighbouring addresses.
//
// Bound on this card: bytes, (input + output bytes) / 3.35 TB/s.  Each
// input element is read by up to four outputs of an upsample, which the
// L1/L2 caches absorb.  The per-axis tables (i0, i1, lambda) come from the
// host, computed in fp32 by ops/pallas/resize_mm.py::_source_coords, so the
// coordinates match the JAX package bit for bit.  The blend keeps W
// innermost, (1-lh)*((1-lw)*v00 + lw*v01) + lh*((1-lw)*v10 + lw*v11), with
// every product and sum rounded on its own (_rn intrinsics), which is the
// order of the JAX CPU path (resize.py:370-381,405-406) and of the plain
// PyTorch version.  An axis that is not resized gets the identity table
// (i0 = i1 = k, lambda = 0).  bf16 is blended in fp32 and rounded once.
//
// Grid: blockIdx.y walks the B*OH output rows; x-blocks cover one row's
// OW*C elements, so the only divisions per element are by C, in 32 bits.
//
// Backward (resize_bilinear_bwd_kernel) replaces the VJP of the same TPU
// kernels (resize_mm.py::_make_op, resize_h_op / resize_w_op), which runs the
// forward kernel again with the transposed [in, out] matrix.  Here gx = M^T g
// is a gather over transposed tables in CSR form: for each input row (and
// column), the list of (output index, weight) pairs that read it, built on
// the host by ops/pallas/resize_mm.py::transpose_table.  One thread owns one
// gx element of the physical [B, H, W, C] array and sums its pairs in list
// order, so there are no atomics and the result is deterministic.  The sum
// is H^T first (inner loop over the row pairs), then W^T (outer loop over
// the column pairs), each product and sum rounded on its own: the order of
// the plain version's two index_add_ passes.  With align_corners=False a
// clamped edge has i0 == i1, so one input appears twice in a row's list;
// the list keeps both entries.  A downsample (out < in) leaves some inputs
// with an empty list: their gradient is 0.
//
// Bound on this card: bytes, (g bytes + gx bytes) / 3.35 TB/s.  Each g
// element is read by the up to 4 inputs whose pairs name it; the caches
// absorb the repeats.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lerp_rn(float lo, float hi, float lam) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, lam), lo), __fmul_rn(lam, hi));
}

template <typename T>
__global__ void resize_bilinear_kernel(const T* __restrict__ x, T* __restrict__ y,
                                       const int* __restrict__ h0, const int* __restrict__ h1,
                                       const float* __restrict__ lh, const int* __restrict__ w0,
                                       const int* __restrict__ w1, const float* __restrict__ lw,
                                       int rows, int H, int W, int C, int OH, int OW) {
  const int row_len = OW * C;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int b = r / OH;
    const int oh = r - b * OH;
    const float ah = lh[oh];
    const int64_t top = (static_cast<int64_t>(b) * H + h0[oh]) * W * C;
    const int64_t bot = (static_cast<int64_t>(b) * H + h1[oh]) * W * C;
    const int64_t out_row = static_cast<int64_t>(r) * row_len;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < row_len; j += gridDim.x * blockDim.x) {
      const int ow = j / C;
      const int c = j - ow * C;
      const int64_t left = static_cast<int64_t>(w0[ow]) * C + c;
      const int64_t right = static_cast<int64_t>(w1[ow]) * C + c;
      const float aw = lw[ow];
      const float t0 = lerp_rn(load(x, top + left), load(x, top + right), aw);
      const float t1 = lerp_rn(load(x, bot + left), load(x, bot + right), aw);
      store(y, out_row + j, lerp_rn(t0, t1, ah));
    }
  }
}

template <typename T>
int launch(const T* x, T* y, const int* h0, const int* h1, const float* lh, const int* w0,
           const int* w1, const float* lw, int B, int H, int W, int C, int OH, int OW,
           void* stream) {
  const int rows = B * OH;
  const int64_t row_len = static_cast<int64_t>(OW) * C;
  int64_t bx = (row_len + kThreads - 1) / kThreads;
  if (bx > 1024) bx = 1024;
  const dim3 grid(static_cast<unsigned int>(bx), static_cast<unsigned int>(rows < 65535 ? rows : 65535));
  resize_bilinear_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, h0, h1, lh, w0, w1, lw, rows, H, W, C, OH, OW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void resize_bilinear_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                           const int* __restrict__ hptr,
                                           const int* __restrict__ hidx,
                                           const float* __restrict__ hwt,
                                           const int* __restrict__ wptr,
                                           const int* __restrict__ widx,
                                           const float* __restrict__ wwt, int rows, int H,
                                           int W, int C, int OH, int OW) {
  const int row_len = W * C;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int b = r / H;
    const int h = r - b * H;
    const int hb = hptr[h];
    const int he = hptr[h + 1];
    const int64_t g_batch = static_cast<int64_t>(b) * OH * OW * C;
    const int64_t out_row = static_cast<int64_t>(r) * row_len;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < row_len; j += gridDim.x * blockDim.x) {
      const int w = j / C;
      const int c = j - w * C;
      float acc = 0.0f;
      for (int k = wptr[w]; k < wptr[w + 1]; ++k) {
        const int64_t col = static_cast<int64_t>(widx[k]) * C + c;
        float t = 0.0f;
        for (int m = hb; m < he; ++m) {
          const int64_t at = g_batch + static_cast<int64_t>(hidx[m]) * OW * C + col;
          t = __fadd_rn(t, __fmul_rn(hwt[m], load(g, at)));
        }
        acc = __fadd_rn(acc, __fmul_rn(wwt[k], t));
      }
      store(gx, out_row + j, acc);
    }
  }
}

template <typename T>
int launch_bwd(const T* g, T* gx, const int* hptr, const int* hidx, const float* hwt,
               const int* wptr, const int* widx, const float* wwt, int B, int H, int W, int C,
               int OH, int OW, void* stream) {
  const int rows = B * H;
  const int64_t row_len = static_cast<int64_t>(W) * C;
  int64_t bx = (row_len + kThreads - 1) / kThreads;
  if (bx > 1024) bx = 1024;
  const dim3 grid(static_cast<unsigned int>(bx), static_cast<unsigned int>(rows < 65535 ? rows : 65535));
  resize_bilinear_bwd_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, gx, hptr, hidx, hwt, wptr, widx, wwt, rows, H, W, C, OH, OW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vaeunet_resize_f32(const float* x, float* y, const int* h0, const int* h1, const float* lh,
                       const int* w0, const int* w1, const float* lw, int B, int H, int W, int C,
                       int OH, int OW, void* stream) {
  return launch(x, y, h0, h1, lh, w0, w1, lw, B, H, W, C, OH, OW, stream);
}

int vaeunet_resize_bf16(const void* x, void* y, const int* h0, const int* h1, const float* lh,
                        const int* w0, const int* w1, const float* lw, int B, int H, int W, int C,
                        int OH, int OW, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), h0, h1, lh,
                w0, w1, lw, B, H, W, C, OH, OW, stream);
}

int vaeunet_resize_bwd_f32(const float* g, float* gx, const int* hptr, const int* hidx,
                           const float* hwt, const int* wptr, const int* widx, const float* wwt,
                           int B, int H, int W, int C, int OH, int OW, void* stream) {
  return launch_bwd(g, gx, hptr, hidx, hwt, wptr, widx, wwt, B, H, W, C, OH, OW, stream);
}

int vaeunet_resize_bwd_bf16(const void* g, void* gx, const int* hptr, const int* hidx,
                            const float* hwt, const int* wptr, const int* widx, const float* wwt,
                            int B, int H, int W, int C, int OH, int OW, void* stream) {
  return launch_bwd(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx), hptr,
                    hidx, hwt, wptr, widx, wwt, B, H, W, C, OH, OW, stream);
}

}  // extern "C"

// Bilinear resize of a channels_last tensor along H and W, and its gradient,
// for Hopper.
//
// Forward: replaces vaeunet_tpu/ops/pallas/resize_mm.py::resize_h and
// ::resize_w.  The TPU kernels multiply by the dense [out, in] interpolation
// matrix on the MXU, one axis per kernel.  That matrix has two nonzeros per
// row, so on this card the same function is a gather of four neighbours and
// a blend, both axes in one pass.  Backward: replaces the VJP of the same
// kernels (resize_mm.py::_make_op, resize_h_op / resize_w_op), which runs
// the forward kernel again with the transposed [in, out] matrix; here
// gx = M^T g is a gather over the transposed tables in CSR form (for each
// input row and column, the (output index, weight) pairs that read it, from
// ops/pallas/resize_mm.py::transpose_table).  No atomics; the result is
// deterministic.
//
// Bound on this card: bytes, (input + output bytes) / 3.35 TB/s, both ways.
//
// Arithmetic (every route, bit for bit the same).  The per-axis tables
// (i0, i1, lambda) come from the host in fp32 (resize_mm.py::_source_coords),
// so the coordinates match the JAX package.  The forward blends W first,
// (1-lh)*((1-lw)*v00 + lw*v01) + lh*((1-lw)*v10 + lw*v11), every product and
// sum rounded on its own (_rn intrinsics): the order of the JAX CPU path
// (resize.py:370-381,405-406) and of the plain PyTorch version.  The backward
// sums H^T first (a row's pairs in list order), then W^T (a column's pairs
// in list order), each product and sum rounded on its own, from 0: the order
// of the plain version's two index_add_ passes.  An axis that is not resized
// has the identity table.  With align_corners=False a clamped edge has
// i0 == i1, so an input appears twice in a list, and stays twice.  A
// downsample leaves some inputs with an empty list: their gradient is 0.
// bf16 is blended and summed in fp32 and rounded once.
//
// Three routes, chosen on the host from the shape alone
// (resize_mm.py::plan_forward / plan_backward), never after a failed launch:
//
// tiled (resize_tiled_kernel, resize_bwd_tiled_kernel): a pixel's channels
//   are a whole number of 16-byte vectors and both tensors start on 16-byte
//   addresses.  The one-element-per-thread design this replaces ran at 21 %
//   (forward) and 13 % (backward) of the bound at the main shapes: a thread
//   made one 2- or 4-byte element with a division by C, three (forward) or
//   up to 16 + 20 (backward) scalar loads, and the inner blend / sum of a row
//   was recomputed by every output row (input column) that reads it.  Here a
//   block owns a tile of the result, 2^th rows x 2^tw columns, and a chunk
//   of 2^lanes vectors of the channels; a thread moves 16 bytes at a time,
//   its lane fixed, so the only divisions are per block and one per staged
//   pixel.  Three stages, a __syncthreads between them:
//     A  the source span the tile's tables name (per-tile (first, count)
//        from the host: forward_spans / backward_spans) goes from HBM into
//        shared memory once, with cp.async, 16 bytes a thread, and the
//        tile's table entries beside it, indices made relative to the span;
//     B  the inner axis once per (row, column, vector) into an fp32 buffer
//        in shared memory: forward t[h, ow] = lerp(x[h, w0], x[h, w1], lw)
//        over the span's rows; backward t[h, ow] = sum_m hwt[m] g[hidx[m], ow]
//        over the span's columns;
//     C  the outer axis from that buffer: forward y[oh, ow] = lerp(t[h0],
//        t[h1], lh); backward gx[h, w] = sum_k wwt[k] t[h, widx[k]]; rounded
//        once to the tensor's type and stored 16 bytes a thread, a pixel's
//        lanes on neighbouring addresses.
//   Rows, columns and lanes past the edge are masked.  bf16 keeps the fp32
//   buffer as two planes of float4, so every shared-memory access is a
//   conflict-free 16 bytes a thread.  Shared memory is dynamic, sized on the
//   host (resize_mm.py::tiled_smem_bytes mirrors the layout here), and may
//   pass 48 KB: the launch raises the kernel's limit first and returns that
//   call's error like a launch error.
//
// row (resize_row_kernel): C = 1, in the path the logits
//   resize, where an NHWC row is contiguous along W; the output row is a
//   whole number of 16-byte vectors and both tensors start on 16-byte
//   addresses.  The tensors are small (10.5 MB at the path's shapes, inside
//   the 50 MB L2), so instructions and launch latency set the time, not HBM:
//   the scalar kernel spent three table loads, four source loads, three
//   blends and a 2- or 4-byte store on every output, ran at 0.3-0.6 TB/s and
//   lost to F.interpolate.  Here the tiled kernel's three stages run with W
//   in the role the channels had.  A block owns 2^th output rows x 2^tw
//   vectors of 4 (fp32) or 8 (bf16) neighbouring output columns of one image:
//     A  the source span into shared memory, its first column rounded down
//        to a vector so that cp.async can copy 16 bytes a thread (W a whole
//        number of vectors; else element by element), a row every `pitch`
//        elements; table entries relative to the span;
//     B  the W blend once per (span row, output column) into the fp32
//        buffer, a thread making one vector of neighbouring outputs from
//        vector loads of the tables;
//     C  the H blend from that buffer, rounded once, one 16-byte store a
//        thread.
//   About 1.5 blends an output instead of 3, no division per element, and a
//   quarter or an eighth of the store instructions
//   (resize_mm.py::row_smem_bytes mirrors the layout).
//
// row, backward (resize_row_bwd_kernel): the logits' gradient, C = 1, gx's
//   row a whole number of 16-byte vectors, both tensors on 16-byte
//   addresses.  The scalar kernel ran it at 11 % of the bound: per gx
//   element it walked both lists and loaded every g value that both name,
//   up to 16 + 20 scalar loads with a division by C, and every gx column
//   that shares a g row summed that row's H^T pairs again.  A block owns
//   2^th gx rows x 2^tw vectors of neighbouring gx columns of one image:
//     A  the g span its lists name (backward_spans) into shared memory with
//        cp.async, its first column rounded down to a vector, a row every
//        `pitch` elements, and the tile's lists beside it with 4-byte
//        cp.async: every copy of the block in flight at once (a loop of
//        loads and stores would wait out one round trip a pass, and the
//        block's latency, not the bytes, sets this kernel's time);
//     B  t[r, col] = sum_m hwt[m] g[hidx[m], col] once per (gx row, staged
//        column) into an fp32 buffer, a thread making one vector of
//        neighbouring columns from 16-byte loads;
//     C  gx[r, w] = sum_k wwt[k] t[r, widx[k]]: a thread takes one column
//        and kRowBwdRows rows, so neighbouring threads read neighbouring
//        list heads and each pair is read once for all its rows, rounded
//        once into the tile's gx in shared memory;
//     D  the tile out, one 16-byte store a thread.
//   Both sums run in list order from 0, so the bits are the scalar
//   kernel's (resize_mm.py::row_bwd_smem_bytes mirrors the layout).
//
// scalar (resize_bilinear_kernel, resize_bilinear_bwd_kernel): every other
//   shape (C = 3, a bf16 C = 4, a result row off a vector, a tensor off a
//   16-byte address), and the yardstick the other routes are held against
//   bit for bit.  One thread per element of the
//   physical [B, OH, OW, C] (backward: [B, H, W, C]) array, channel fastest,
//   reading through the caches.  Grid: blockIdx.y walks the rows, x-blocks
//   cover one row, so the only divisions per element are by C.


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

// ----- the tiled route ------------------------------------------------------

constexpr int kTiledThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes of T as fp32 values: kPlanes float4
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static constexpr int kPlanes = 1;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static constexpr int kPlanes = 2;
  // bf16 is the upper half of an fp32: exact
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
    f[4] = __uint_as_float(v.z << 16);
    f[5] = __uint_as_float(v.z & 0xffff0000u);
    f[6] = __uint_as_float(v.w << 16);
    f[7] = __uint_as_float(v.w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                      pack_bf16x2(f[6], f[7]));
  }
};

// fp32 values to and from the planes of the shared-memory buffer
template <int N>
__device__ __forceinline__ void store_planes(float4* t, int plane, int at, const float (&f)[N]) {
#pragma unroll
  for (int p = 0; p < N / 4; ++p)
    t[p * plane + at] = make_float4(f[4 * p], f[4 * p + 1], f[4 * p + 2], f[4 * p + 3]);
}

template <int N>
__device__ __forceinline__ void load_planes(const float4* t, int plane, int at, float (&f)[N]) {
#pragma unroll
  for (int p = 0; p < N / 4; ++p) {
    const float4 v = t[p * plane + at];
    f[4 * p] = v.x;
    f[4 * p + 1] = v.y;
    f[4 * p + 2] = v.z;
    f[4 * p + 3] = v.w;
  }
}

struct Tile {
  int B, H, W, C, OH, OW;        // x (gx) is [B, H, W, C], y (g) is [B, OH, OW, C]
  int th, tw, lanes;             // log2 of the tile's rows, columns, channel vectors
  int tiles_h, tiles_w, chunks;
  int nnz_h, nnz_w;              // backward: room for a tile's pairs
};

// which tile, chunk and batch entry this block owns
struct Block {
  int chunk, tile_w, tile_h, b;
  __device__ __forceinline__ explicit Block(const Tile& a) {
    unsigned int blk = blockIdx.x;
    chunk = blk % a.chunks;
    blk /= a.chunks;
    tile_w = blk % a.tiles_w;
    blk /= a.tiles_w;
    tile_h = blk % a.tiles_h;
    b = blk / a.tiles_h;
  }
};

// Stage A: rows [r0, r0 + nr) x columns [c0, c0 + nc) of one batch entry's
// [rows, cols, C] array, this thread's lane of each pixel, into span[pixel][lane]
template <typename T>
__device__ __forceinline__ void stage_span(uint4* span, const T* __restrict__ src, int cols,
                                           int C, int r0, int nr, int c0, int nc, int lanes,
                                           int lane) {
  const int n = nr * nc;
  for (int p = threadIdx.x >> lanes; p < n; p += kTiledThreads >> lanes) {
    const int r = p / nc;
    const int col = p - r * nc;
    cp_async16(span + (p << lanes) + lane,
               src + (static_cast<int64_t>(r0 + r) * cols + c0 + col) * C);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
resize_tiled_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ h0,
                    const int* __restrict__ h1, const float* __restrict__ lh,
                    const int* __restrict__ w0, const int* __restrict__ w1,
                    const float* __restrict__ lw, const int* __restrict__ hspan,
                    const int* __restrict__ wspan, const Tile a) {
  using V = Vec<T>;
  extern __shared__ uint4 smem[];
  const Block blk(a);
  const int TH = 1 << a.th, TW = 1 << a.tw;
  const int oh_a = blk.tile_h << a.th, ow_a = blk.tile_w << a.tw;
  const int h_lo = hspan[2 * blk.tile_h], sh = hspan[2 * blk.tile_h + 1];
  const int w_lo = wspan[2 * blk.tile_w], sw = wspan[2 * blk.tile_w + 1];

  // shared memory: the tile's tables | the span of x | t, fp32
  int* s_h0 = reinterpret_cast<int*>(smem);
  int* s_h1 = s_h0 + TH;
  float* s_lh = reinterpret_cast<float*>(s_h1 + TH);
  int* s_w0 = reinterpret_cast<int*>(s_lh + TH);
  int* s_w1 = s_w0 + TW;
  float* s_lw = reinterpret_cast<float*>(s_w1 + TW);
  uint4* xs = smem + (12 * (TH + TW) + 15) / 16;
  float4* ts = reinterpret_cast<float4*>(xs + ((sh * sw) << a.lanes));
  const int plane = (sh << a.tw) << a.lanes;

  for (int i = threadIdx.x; i < TH; i += kTiledThreads) {
    const int oh = min(oh_a + i, a.OH - 1);      // rows past the edge repeat the last one
    s_h0[i] = h0[oh] - h_lo;
    s_h1[i] = h1[oh] - h_lo;
    s_lh[i] = lh[oh];
  }
  for (int i = threadIdx.x; i < TW; i += kTiledThreads) {
    const int ow = min(ow_a + i, a.OW - 1);
    s_w0[i] = w0[ow] - w_lo;
    s_w1[i] = w1[ow] - w_lo;
    s_lw[i] = lw[ow];
  }

  const int lane = threadIdx.x & ((1 << a.lanes) - 1);
  const int c = (((blk.chunk << a.lanes) | lane)) * V::kN;
  const bool lane_ok = c < a.C;
  const int first = threadIdx.x >> a.lanes;
  const int step = kTiledThreads >> a.lanes;

  if (lane_ok)
    stage_span(xs, x + static_cast<int64_t>(blk.b) * a.H * a.W * a.C + c, a.W, a.C, h_lo, sh,
               w_lo, sw, a.lanes, lane);
  cp_async_wait_all();
  __syncthreads();

  if (lane_ok) {
    // B: t[r, ow] = lerp(x[r, w0[ow]], x[r, w1[ow]], lw[ow]) for the span's rows
    const int n = sh << a.tw;
#pragma unroll 2
    for (int q = first; q < n; q += step) {
      const int ow = q & (TW - 1);
      const int r = q >> a.tw;
      const float lam = s_lw[ow];
      const float one_m = __fsub_rn(1.0f, lam);
      float lo[V::kN], hi[V::kN], t[V::kN];
      V::unpack(xs[((r * sw + s_w0[ow]) << a.lanes) + lane], lo);
      V::unpack(xs[((r * sw + s_w1[ow]) << a.lanes) + lane], hi);
#pragma unroll
      for (int j = 0; j < V::kN; ++j)
        t[j] = __fadd_rn(__fmul_rn(one_m, lo[j]), __fmul_rn(lam, hi[j]));
      store_planes<V::kN>(ts, plane, (q << a.lanes) + lane, t);
    }
  }
  __syncthreads();

  if (lane_ok) {
    // C: y[oh, ow] = lerp(t[h0[oh], ow], t[h1[oh], ow], lh[oh])
    T* yb = y + static_cast<int64_t>(blk.b) * a.OH * a.OW * a.C + c;
    const int n = TH << a.tw;
#pragma unroll 2
    for (int q = first; q < n; q += step) {
      const int ow = q & (TW - 1);
      const int r = q >> a.tw;
      if (oh_a + r >= a.OH || ow_a + ow >= a.OW) continue;
      const float lam = s_lh[r];
      const float one_m = __fsub_rn(1.0f, lam);
      float lo[V::kN], hi[V::kN], out[V::kN];
      load_planes<V::kN>(ts, plane, ((((s_h0[r] << a.tw) + ow)) << a.lanes) + lane, lo);
      load_planes<V::kN>(ts, plane, ((((s_h1[r] << a.tw) + ow)) << a.lanes) + lane, hi);
#pragma unroll
      for (int j = 0; j < V::kN; ++j)
        out[j] = __fadd_rn(__fmul_rn(one_m, lo[j]), __fmul_rn(lam, hi[j]));
      *reinterpret_cast<uint4*>(yb + (static_cast<int64_t>(oh_a + r) * a.OW + ow_a + ow) * a.C) =
          V::pack(out);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
resize_bwd_tiled_kernel(const T* __restrict__ g, T* __restrict__ gx,
                        const int* __restrict__ hptr, const int* __restrict__ hidx,
                        const float* __restrict__ hwt, const int* __restrict__ wptr,
                        const int* __restrict__ widx, const float* __restrict__ wwt,
                        const int* __restrict__ hspan, const int* __restrict__ wspan,
                        const Tile a) {
  using V = Vec<T>;
  extern __shared__ uint4 smem[];
  const Block blk(a);
  const int TH = 1 << a.th, TW = 1 << a.tw;
  const int h_a = blk.tile_h << a.th, w_a = blk.tile_w << a.tw;
  const int oh_lo = hspan[2 * blk.tile_h], sh = hspan[2 * blk.tile_h + 1];
  const int ow_lo = wspan[2 * blk.tile_w], sw = wspan[2 * blk.tile_w + 1];
  // the tile's pairs: [m_a, m_b) of the row lists, [k_a, k_b) of the column lists
  const int m_a = hptr[h_a], m_b = hptr[min(h_a + TH, a.H)];
  const int k_a = wptr[w_a], k_b = wptr[min(w_a + TW, a.W)];

  // shared memory: the tile's lists | the span of g | t, fp32
  int* s_hptr = reinterpret_cast<int*>(smem);      // [TH + 1], relative to m_a
  int* s_wptr = s_hptr + TH + 1;                   // [TW + 1], relative to k_a
  int* s_hidx = s_wptr + TW + 1;                   // [nnz_h], relative to oh_lo
  int* s_widx = s_hidx + a.nnz_h;                  // [nnz_w], relative to ow_lo
  float* s_hwt = reinterpret_cast<float*>(s_widx + a.nnz_w);
  float* s_wwt = s_hwt + a.nnz_h;
  uint4* gs = smem + (4 * (TH + 1 + TW + 1 + 2 * (a.nnz_h + a.nnz_w)) + 15) / 16;
  float4* ts = reinterpret_cast<float4*>(gs + ((sh * sw) << a.lanes));
  const int plane = (sw << a.th) << a.lanes;

  // rows and columns past the edge get empty lists
  for (int i = threadIdx.x; i <= TH; i += kTiledThreads) s_hptr[i] = hptr[min(h_a + i, a.H)] - m_a;
  for (int i = threadIdx.x; i <= TW; i += kTiledThreads) s_wptr[i] = wptr[min(w_a + i, a.W)] - k_a;
  for (int i = threadIdx.x; i < m_b - m_a; i += kTiledThreads) {
    s_hidx[i] = hidx[m_a + i] - oh_lo;
    s_hwt[i] = hwt[m_a + i];
  }
  for (int i = threadIdx.x; i < k_b - k_a; i += kTiledThreads) {
    s_widx[i] = widx[k_a + i] - ow_lo;
    s_wwt[i] = wwt[k_a + i];
  }

  const int lane = threadIdx.x & ((1 << a.lanes) - 1);
  const int c = (((blk.chunk << a.lanes) | lane)) * V::kN;
  const bool lane_ok = c < a.C;
  const int first = threadIdx.x >> a.lanes;
  const int step = kTiledThreads >> a.lanes;

  if (lane_ok)
    stage_span(gs, g + static_cast<int64_t>(blk.b) * a.OH * a.OW * a.C + c, a.OW, a.C, oh_lo, sh,
               ow_lo, sw, a.lanes, lane);
  cp_async_wait_all();
  __syncthreads();

  if (lane_ok) {
    // B: t[r, ow] = sum over row r's pairs of hwt * g[hidx, ow], for the span's columns
    const int n = sw << a.th;
    for (int q = first; q < n; q += step) {
      const int r = q / sw;
      const int ow = q - r * sw;
      float t[V::kN];
#pragma unroll
      for (int j = 0; j < V::kN; ++j) t[j] = 0.0f;
      for (int m = s_hptr[r]; m < s_hptr[r + 1]; ++m) {
        const float wt = s_hwt[m];
        float v[V::kN];
        V::unpack(gs[((s_hidx[m] * sw + ow) << a.lanes) + lane], v);
#pragma unroll
        for (int j = 0; j < V::kN; ++j) t[j] = __fadd_rn(t[j], __fmul_rn(wt, v[j]));
      }
      store_planes<V::kN>(ts, plane, (q << a.lanes) + lane, t);
    }
  }
  __syncthreads();

  if (lane_ok) {
    // C: gx[h, w] = sum over column w's pairs of wwt * t[h, widx]
    T* gxb = gx + static_cast<int64_t>(blk.b) * a.H * a.W * a.C + c;
    const int n = TH << a.tw;
    for (int q = first; q < n; q += step) {
      const int w = q & (TW - 1);
      const int r = q >> a.tw;
      if (h_a + r >= a.H || w_a + w >= a.W) continue;
      float acc[V::kN];
#pragma unroll
      for (int j = 0; j < V::kN; ++j) acc[j] = 0.0f;
      for (int k = s_wptr[w]; k < s_wptr[w + 1]; ++k) {
        const float wt = s_wwt[k];
        float v[V::kN];
        load_planes<V::kN>(ts, plane, ((r * sw + s_widx[k]) << a.lanes) + lane, v);
#pragma unroll
        for (int j = 0; j < V::kN; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wt, v[j]));
      }
      *reinterpret_cast<uint4*>(gxb + (static_cast<int64_t>(h_a + r) * a.W + w_a + w) * a.C) =
          V::pack(acc);
    }
  }
}

// ----- the row route: C = 1, vectors along W ----------------------------------

struct RowTile {
  int B, H, W, OH, OW;
  int th, tw;                    // log2 of the tile's rows and of its vectors along W
  int pitch;                     // elements of a staged row: a whole number of vectors
  int tiles_h, tiles_w;
};

// 16 bytes of a shared-memory table
__device__ __forceinline__ void load4(const int* p, int (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Block = 2^th output rows x 2^tw vectors of Vec<T>::kN neighbouring output
// columns of one image.  `vec_in`: W is a whole number of vectors and x
// starts on a 16-byte address, so stage A may copy 16 bytes a thread.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
resize_row_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ h0,
                  const int* __restrict__ h1, const float* __restrict__ lh,
                  const int* __restrict__ w0, const int* __restrict__ w1,
                  const float* __restrict__ lw, const int* __restrict__ hspan,
                  const int* __restrict__ wspan, const RowTile a, const bool vec_in) {
  using V = Vec<T>;
  extern __shared__ uint4 smem[];
  unsigned int blk = blockIdx.x;
  const int tile_w = blk % a.tiles_w;
  blk /= a.tiles_w;
  const int tile_h = blk % a.tiles_h;
  const int b = blk / a.tiles_h;
  const int TH = 1 << a.th, TWV = 1 << a.tw, TWC = TWV * V::kN;
  const int oh_a = tile_h << a.th, ow_a = tile_w * TWC;
  const int h_lo = hspan[2 * tile_h], sh = hspan[2 * tile_h + 1];
  const int w_hi = wspan[2 * tile_w] + wspan[2 * tile_w + 1];
  const int w_lo = wspan[2 * tile_w] & ~(V::kN - 1);      // rounded down to a vector

  // shared memory: the W tables, the H tables | the span of x [sh][pitch] | t, fp32
  int* s_w0 = reinterpret_cast<int*>(smem);
  int* s_w1 = s_w0 + TWC;
  float* s_lw = reinterpret_cast<float*>(s_w1 + TWC);
  int* s_h0 = reinterpret_cast<int*>(s_lw + TWC);
  int* s_h1 = s_h0 + TH;
  float* s_lh = reinterpret_cast<float*>(s_h1 + TH);
  uint4* xs_v = smem + (12 * (TH + TWC) + 15) / 16;
  T* xs = reinterpret_cast<T*>(xs_v);
  float4* ts = reinterpret_cast<float4*>(
      xs_v + (sh * a.pitch * static_cast<int>(sizeof(T)) + 15) / 16);
  const int plane = sh << a.tw;

  for (int i = threadIdx.x; i < TWC; i += kTiledThreads) {
    const int ow = min(ow_a + i, a.OW - 1);      // columns past the edge repeat the last one
    s_w0[i] = w0[ow] - w_lo;
    s_w1[i] = w1[ow] - w_lo;
    s_lw[i] = lw[ow];
  }
  for (int i = threadIdx.x; i < TH; i += kTiledThreads) {
    const int oh = min(oh_a + i, a.OH - 1);
    s_h0[i] = h0[oh] - h_lo;
    s_h1[i] = h1[oh] - h_lo;
    s_lh[i] = lh[oh];
  }

  // A: rows [h_lo, h_lo + sh) x columns [w_lo, w_hi) of x
  const T* xb = x + static_cast<int64_t>(b) * a.H * a.W;
  if (vec_in) {
    const int nv = (w_hi - w_lo + V::kN - 1) / V::kN;
    for (int i = threadIdx.x; i < sh * nv; i += kTiledThreads) {
      const int r = i / nv;
      const int v = i - r * nv;
      cp_async16(xs + r * a.pitch + v * V::kN,
                 xb + static_cast<int64_t>(h_lo + r) * a.W + w_lo + v * V::kN);
    }
  } else {
    const int n = w_hi - w_lo;
    for (int i = threadIdx.x; i < sh * n; i += kTiledThreads) {
      const int r = i / n;
      const int c = i - r * n;
      xs[r * a.pitch + c] = xb[static_cast<int64_t>(h_lo + r) * a.W + w_lo + c];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // B: t[r, ow] = lerp(x[r, w0[ow]], x[r, w1[ow]], lw[ow]) for the span's rows
  for (int q = threadIdx.x; q < plane; q += kTiledThreads) {
    const int v = q & (TWV - 1);
    const int r = q >> a.tw;
    const T* row = xs + r * a.pitch;
    float t[V::kN];
#pragma unroll
    for (int g = 0; g < V::kN; g += 4) {
      int i0[4], i1[4];
      float lam[4];
      load4(s_w0 + v * V::kN + g, i0);
      load4(s_w1 + v * V::kN + g, i1);
      load4(s_lw + v * V::kN + g, lam);
#pragma unroll
      for (int j = 0; j < 4; ++j) t[g + j] = lerp_rn(load(row, i0[j]), load(row, i1[j]), lam[j]);
    }
    store_planes<V::kN>(ts, plane, q, t);
  }
  __syncthreads();

  // C: y[oh, ow] = lerp(t[h0[oh], ow], t[h1[oh], ow], lh[oh]), 16 bytes a store
  T* yb = y + static_cast<int64_t>(b) * a.OH * a.OW;
  const int n = TH << a.tw;
  for (int q = threadIdx.x; q < n; q += kTiledThreads) {
    const int v = q & (TWV - 1);
    const int r = q >> a.tw;
    const int oh = oh_a + r;
    const int ow = ow_a + v * V::kN;
    if (oh >= a.OH || ow >= a.OW) continue;       // OW is whole vectors: all of it or none
    const float lam = s_lh[r];
    const float one_m = __fsub_rn(1.0f, lam);
    float lo[V::kN], hi[V::kN], out[V::kN];
    load_planes<V::kN>(ts, plane, (s_h0[r] << a.tw) + v, lo);
    load_planes<V::kN>(ts, plane, (s_h1[r] << a.tw) + v, hi);
#pragma unroll
    for (int j = 0; j < V::kN; ++j)
      out[j] = __fadd_rn(__fmul_rn(one_m, lo[j]), __fmul_rn(lam, hi[j]));
    *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(oh) * a.OW + ow) = V::pack(out);
  }
}

// ----- the row route of the gradient: C = 1, vectors along W -----------------

struct RowBwdTile {
  int B, H, W, OH, OW;           // gx [B, H, W], g [B, OH, OW]
  int th, tw;                    // log2 of the tile's gx rows and of its vectors along W
  int pitch;                     // elements of a staged g row and of a t row: whole vectors
  int nnz_h, nnz_w;              // room for a tile's pairs
  int tiles_h, tiles_w;
};

constexpr int kRowBwdRows = 4;   // stage C: the rows a thread sums a column's list into

// Block = 2^th gx rows x 2^tw vectors of Vec<T>::kN neighbouring gx columns
// of one image.  `vec_in`: OW is a whole number of vectors and g starts on a
// 16-byte address, so stage A may copy 16 bytes a thread.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
resize_row_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx, const int* __restrict__ hptr,
                      const int* __restrict__ hidx, const float* __restrict__ hwt,
                      const int* __restrict__ wptr, const int* __restrict__ widx,
                      const float* __restrict__ wwt, const int* __restrict__ hspan,
                      const int* __restrict__ wspan, const RowBwdTile a, const bool vec_in) {
  using V = Vec<T>;
  extern __shared__ uint4 smem[];
  unsigned int blk = blockIdx.x;
  const int tile_w = blk % a.tiles_w;
  blk /= a.tiles_w;
  const int tile_h = blk % a.tiles_h;
  const int b = blk / a.tiles_h;
  const int TH = 1 << a.th, TWV = 1 << a.tw, TWC = TWV * V::kN;
  const int h_a = tile_h << a.th, w_a = tile_w * TWC;
  // the tile's pairs: [m_a, m_b) of the row lists, [k_a, k_b) of the column lists
  const int m_a = hptr[h_a], m_b = hptr[min(h_a + TH, a.H)];
  const int k_a = wptr[w_a], k_b = wptr[min(w_a + TWC, a.W)];
  const int oh_lo = hspan[2 * tile_h], sh = hspan[2 * tile_h + 1];
  const int ow_hi = wspan[2 * tile_w] + wspan[2 * tile_w + 1];
  const int ow_lo = wspan[2 * tile_w] & ~(V::kN - 1);      // rounded down to a vector
  const int nv = (ow_hi - ow_lo + V::kN - 1) / V::kN;       // staged vectors a row; 0: none read

  // shared memory: the tile's lists as they are in the tables (a pointer less
  // m_a / k_a and an index less oh_lo / ow_lo where it is read) | the span of
  // g [sh][pitch] | t [TH][pitch], fp32 | the tile's gx [TH][TWC], rounded
  int* s_hptr = reinterpret_cast<int*>(smem);      // [TH + 1]
  int* s_wptr = s_hptr + TH + 1;                   // [TWC + 1]
  int* s_hidx = s_wptr + TWC + 1;                  // [nnz_h]
  int* s_widx = s_hidx + a.nnz_h;                  // [nnz_w]
  float* s_hwt = reinterpret_cast<float*>(s_widx + a.nnz_w);
  float* s_wwt = s_hwt + a.nnz_h;
  uint4* gs_v = smem + (4 * (TH + 1 + TWC + 1 + 2 * (a.nnz_h + a.nnz_w)) + 15) / 16;
  T* gs = reinterpret_cast<T*>(gs_v);
  float* ts = reinterpret_cast<float*>(gs_v + (sh * a.pitch * static_cast<int>(sizeof(T)) + 15) / 16);
  T* out = reinterpret_cast<T*>(ts + TH * a.pitch);

  // A: rows [oh_lo, oh_lo + sh) x columns [ow_lo, ow_hi) of g, and the lists,
  // all with cp.async, so that every copy of the block is in flight at once;
  // rows and columns past the edge get empty lists
  const T* gb = g + static_cast<int64_t>(b) * a.OH * a.OW;
  if (vec_in) {
    for (int i = threadIdx.x; i < sh * nv; i += kTiledThreads) {
      const int r = i / nv;
      const int v = i - r * nv;
      cp_async16(gs + r * a.pitch + v * V::kN,
                 gb + static_cast<int64_t>(oh_lo + r) * a.OW + ow_lo + v * V::kN);
    }
  } else {
    const int n = ow_hi - ow_lo;
    for (int i = threadIdx.x; i < sh * n; i += kTiledThreads) {
      const int r = i / n;
      const int c = i - r * n;
      gs[r * a.pitch + c] = gb[static_cast<int64_t>(oh_lo + r) * a.OW + ow_lo + c];
    }
  }
  for (int i = threadIdx.x; i <= TH; i += kTiledThreads) cp_async4(s_hptr + i, hptr + min(h_a + i, a.H));
  for (int i = threadIdx.x; i <= TWC; i += kTiledThreads) cp_async4(s_wptr + i, wptr + min(w_a + i, a.W));
  for (int i = threadIdx.x; i < m_b - m_a; i += kTiledThreads) {
    cp_async4(s_hidx + i, hidx + m_a + i);
    cp_async4(s_hwt + i, hwt + m_a + i);
  }
  for (int i = threadIdx.x; i < k_b - k_a; i += kTiledThreads) {
    cp_async4(s_widx + i, widx + k_a + i);
    cp_async4(s_wwt + i, wwt + k_a + i);
  }
  cp_async_wait_all();
  __syncthreads();

  // B: t[r, col] = sum over row r's pairs of hwt * g[hidx, col], in list order
  // from 0; a thread makes one vector of neighbouring columns from 16-byte loads
  for (int q = threadIdx.x; q < TH * nv; q += kTiledThreads) {
    const int r = q / nv;
    const int v = q - r * nv;
    float t[V::kN];
#pragma unroll
    for (int j = 0; j < V::kN; ++j) t[j] = 0.0f;
    for (int m = s_hptr[r] - m_a; m < s_hptr[r + 1] - m_a; ++m) {
      const float wt = s_hwt[m];
      float gv[V::kN];
      V::unpack(*reinterpret_cast<const uint4*>(gs + (s_hidx[m] - oh_lo) * a.pitch + v * V::kN),
                gv);
#pragma unroll
      for (int j = 0; j < V::kN; ++j) t[j] = __fadd_rn(t[j], __fmul_rn(wt, gv[j]));
    }
    float4* dst = reinterpret_cast<float4*>(ts + r * a.pitch + v * V::kN);
#pragma unroll
    for (int p = 0; p < V::kN / 4; ++p)
      dst[p] = make_float4(t[4 * p], t[4 * p + 1], t[4 * p + 2], t[4 * p + 3]);
  }
  __syncthreads();

  // C: gx[h, w] = sum over column w's pairs of wwt * t[h, widx], in list order
  // from 0, rounded once.  A thread takes one column and kRowBwdRows rows:
  // neighbouring threads read neighbouring list heads, and each pair is read
  // once for all its rows.
  for (int q = threadIdx.x; q < TWC * ((TH + kRowBwdRows - 1) / kRowBwdRows);
       q += kTiledThreads) {
    const int w = q & (TWC - 1);
    const int r0 = (q / TWC) * kRowBwdRows;
    float acc[kRowBwdRows];
#pragma unroll
    for (int i = 0; i < kRowBwdRows; ++i) acc[i] = 0.0f;
    for (int k = s_wptr[w] - k_a; k < s_wptr[w + 1] - k_a; ++k) {
      const float wt = s_wwt[k];
      const float* col = ts + r0 * a.pitch + s_widx[k] - ow_lo;
#pragma unroll
      for (int i = 0; i < kRowBwdRows; ++i)
        if (r0 + i < TH) acc[i] = __fadd_rn(acc[i], __fmul_rn(wt, col[i * a.pitch]));
    }
#pragma unroll
    for (int i = 0; i < kRowBwdRows; ++i)
      if (r0 + i < TH) store(out, (r0 + i) * TWC + w, acc[i]);
  }
  __syncthreads();

  // D: the tile's gx rows, 16 bytes a thread (W is whole vectors: all of a
  // vector or none of it is inside)
  T* gxb = gx + static_cast<int64_t>(b) * a.H * a.W;
  for (int q = threadIdx.x; q < (TH << a.tw); q += kTiledThreads) {
    const int v = q & (TWV - 1);
    const int r = q >> a.tw;
    const int h = h_a + r;
    const int w = w_a + v * V::kN;
    if (h >= a.H || w >= a.W) continue;
    *reinterpret_cast<uint4*>(gxb + static_cast<int64_t>(h) * a.W + w) =
        *reinterpret_cast<const uint4*>(out + r * TWC + v * V::kN);
  }
}

// the grid of a tiled launch; false if the arguments cannot be launched
inline bool tiled_grid(Tile* a, int rows, int cols, int vec, int smem_bytes, unsigned int* grid) {
  if (a->th < 0 || a->tw < 0 || a->lanes < 0 || a->lanes > 8 || a->th > 16 || a->tw > 16 ||
      smem_bytes <= 0 || a->C % vec != 0)
    return false;
  a->tiles_h = (rows + (1 << a->th) - 1) >> a->th;
  a->tiles_w = (cols + (1 << a->tw) - 1) >> a->tw;
  a->chunks = (a->C / vec + (1 << a->lanes) - 1) >> a->lanes;
  const int64_t blocks = static_cast<int64_t>(a->chunks) * a->tiles_w * a->tiles_h * a->B;
  if (blocks <= 0 || blocks > 2147483647LL) return false;
  *grid = static_cast<unsigned int>(blocks);
  return true;
}

// dynamic shared memory above 48 KB has to be allowed per kernel (below, the
// call is skipped: it is host time on every launch); a refusal is returned
// like a launch error, and taken off the runtime's last-error slot so that
// the next launch's check does not find it
template <typename K>
bool raise_smem_limit(K kernel, int smem_bytes, int* err) {
  *err = 0;
  if (smem_bytes <= 48 * 1024) return true;
  *err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (*err != 0) cudaGetLastError();
  return *err == 0;
}

template <typename T>
int launch_tiled(const T* x, T* y, const int* h0, const int* h1, const float* lh, const int* w0,
                 const int* w1, const float* lw, const int* hspan, const int* wspan, Tile a,
                 int smem_bytes, void* stream) {
  unsigned int grid;
  int err;
  if (!tiled_grid(&a, a.OH, a.OW, Vec<T>::kN, smem_bytes, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!raise_smem_limit(resize_tiled_kernel<T>, smem_bytes, &err)) return err;
  resize_tiled_kernel<T><<<grid, kTiledThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, h0, h1, lh, w0, w1, lw, hspan, wspan, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_tiled(const T* g, T* gx, const int* hptr, const int* hidx, const float* hwt,
                     const int* wptr, const int* widx, const float* wwt, const int* hspan,
                     const int* wspan, Tile a, int smem_bytes, void* stream) {
  unsigned int grid;
  int err;
  if (a.nnz_h < 0 || a.nnz_w < 0 || !tiled_grid(&a, a.H, a.W, Vec<T>::kN, smem_bytes, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!raise_smem_limit(resize_bwd_tiled_kernel<T>, smem_bytes, &err)) return err;
  resize_bwd_tiled_kernel<T>
      <<<grid, kTiledThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
          g, gx, hptr, hidx, hwt, wptr, widx, wwt, hspan, wspan, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_row(const T* x, T* y, const int* h0, const int* h1, const float* lh, const int* w0,
               const int* w1, const float* lw, const int* hspan, const int* wspan, RowTile a, int C,
               int smem_bytes, void* stream) {
  constexpr int kN = Vec<T>::kN;
  if (C != 1 || a.th < 0 || a.tw < 0 || a.th > 16 || a.tw > 16 || smem_bytes <= 0 ||
      a.pitch <= 0 || a.pitch % kN != 0 || a.OW % kN != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles_h = (a.OH + (1 << a.th) - 1) >> a.th;
  a.tiles_w = (a.OW / kN + (1 << a.tw) - 1) >> a.tw;
  const int64_t blocks = static_cast<int64_t>(a.tiles_w) * a.tiles_h * a.B;
  if (blocks <= 0 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (!raise_smem_limit(resize_row_kernel<T>, smem_bytes, &err)) return err;
  const bool vec_in = a.W % kN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  resize_row_kernel<T><<<static_cast<unsigned int>(blocks), kTiledThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(x, y, h0, h1, lh, w0, w1, lw, hspan,
                                                              wspan, a, vec_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_row_bwd(const T* g, T* gx, const int* hptr, const int* hidx, const float* hwt,
                   const int* wptr, const int* widx, const float* wwt, const int* hspan,
                   const int* wspan, RowBwdTile a, int C, int smem_bytes, void* stream) {
  constexpr int kN = Vec<T>::kN;
  if (C != 1 || a.th < 0 || a.tw < 0 || a.th > 16 || a.tw > 16 || smem_bytes <= 0 ||
      a.pitch <= 0 || a.pitch % kN != 0 || a.W % kN != 0 || a.nnz_h < 0 || a.nnz_w < 0 ||
      reinterpret_cast<uintptr_t>(gx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles_h = (a.H + (1 << a.th) - 1) >> a.th;
  a.tiles_w = (a.W / kN + (1 << a.tw) - 1) >> a.tw;
  const int64_t blocks = static_cast<int64_t>(a.tiles_w) * a.tiles_h * a.B;
  if (blocks <= 0 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (!raise_smem_limit(resize_row_bwd_kernel<T>, smem_bytes, &err)) return err;
  const bool vec_in = a.OW % kN == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  resize_row_bwd_kernel<T><<<static_cast<unsigned int>(blocks), kTiledThreads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      g, gx, hptr, hidx, hwt, wptr, widx, wwt, hspan, wspan, a, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t: 0, the launch's error, or that of a
// refused argument or of raising the kernel's shared-memory limit.

#define TILE_ARGS(nnz_h, nnz_w) Tile{B, H, W, C, OH, OW, th, tw, lanes, 0, 0, 0, nnz_h, nnz_w}

int vaeunet_resize_f32(const float* x, float* y, const int* h0, const int* h1, const float* lh,
                       const int* w0, const int* w1, const float* lw, const int* hspan,
                       const int* wspan, int B, int H, int W, int C, int OH, int OW, int th,
                       int tw, int lanes, int smem_bytes, void* stream) {
  return launch_tiled(x, y, h0, h1, lh, w0, w1, lw, hspan, wspan, TILE_ARGS(0, 0), smem_bytes,
                      stream);
}

int vaeunet_resize_bf16(const void* x, void* y, const int* h0, const int* h1, const float* lh,
                        const int* w0, const int* w1, const float* lw, const int* hspan,
                        const int* wspan, int B, int H, int W, int C, int OH, int OW, int th,
                        int tw, int lanes, int smem_bytes, void* stream) {
  return launch_tiled(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), h0,
                      h1, lh, w0, w1, lw, hspan, wspan, TILE_ARGS(0, 0), smem_bytes, stream);
}

int vaeunet_resize_bwd_f32(const float* g, float* gx, const int* hptr, const int* hidx,
                           const float* hwt, const int* wptr, const int* widx, const float* wwt,
                           const int* hspan, const int* wspan, int B, int H, int W, int C,
                           int OH, int OW, int th, int tw, int lanes, int nnz_h, int nnz_w,
                           int smem_bytes, void* stream) {
  return launch_bwd_tiled(g, gx, hptr, hidx, hwt, wptr, widx, wwt, hspan, wspan,
                          TILE_ARGS(nnz_h, nnz_w), smem_bytes, stream);
}

int vaeunet_resize_bwd_bf16(const void* g, void* gx, const int* hptr, const int* hidx,
                            const float* hwt, const int* wptr, const int* widx,
                            const float* wwt, const int* hspan, const int* wspan, int B, int H,
                            int W, int C, int OH, int OW, int th, int tw, int lanes, int nnz_h,
                            int nnz_w, int smem_bytes, void* stream) {
  return launch_bwd_tiled(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx),
                          hptr, hidx, hwt, wptr, widx, wwt, hspan, wspan,
                          TILE_ARGS(nnz_h, nnz_w), smem_bytes, stream);
}

#undef TILE_ARGS

// C must be 1; `tw` counts vectors (4 fp32 or 8 bf16 output columns), `pitch`
// elements of a staged row.
int vaeunet_resize_row_f32(const float* x, float* y, const int* h0, const int* h1,
                           const float* lh, const int* w0, const int* w1, const float* lw,
                           const int* hspan, const int* wspan, int B, int H, int W, int C, int OH,
                           int OW, int th, int tw, int pitch, int smem_bytes, void* stream) {
  return launch_row(x, y, h0, h1, lh, w0, w1, lw, hspan, wspan,
                    RowTile{B, H, W, OH, OW, th, tw, pitch, 0, 0}, C, smem_bytes, stream);
}

int vaeunet_resize_row_bf16(const void* x, void* y, const int* h0, const int* h1, const float* lh,
                            const int* w0, const int* w1, const float* lw, const int* hspan,
                            const int* wspan, int B, int H, int W, int C, int OH, int OW, int th,
                            int tw, int pitch, int smem_bytes, void* stream) {
  return launch_row(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), h0, h1,
                    lh, w0, w1, lw, hspan, wspan, RowTile{B, H, W, OH, OW, th, tw, pitch, 0, 0}, C,
                    smem_bytes, stream);
}

// C must be 1; `tw` counts vectors (4 fp32 or 8 bf16 gx columns), `pitch`
// elements of a staged g row.
int vaeunet_resize_row_bwd_f32(const float* g, float* gx, const int* hptr, const int* hidx,
                               const float* hwt, const int* wptr, const int* widx,
                               const float* wwt, const int* hspan, const int* wspan, int B, int H,
                               int W, int C, int OH, int OW, int th, int tw, int pitch, int nnz_h,
                               int nnz_w, int smem_bytes, void* stream) {
  return launch_row_bwd(g, gx, hptr, hidx, hwt, wptr, widx, wwt, hspan, wspan,
                        RowBwdTile{B, H, W, OH, OW, th, tw, pitch, nnz_h, nnz_w, 0, 0}, C,
                        smem_bytes, stream);
}

int vaeunet_resize_row_bwd_bf16(const void* g, void* gx, const int* hptr, const int* hidx,
                                const float* hwt, const int* wptr, const int* widx,
                                const float* wwt, const int* hspan, const int* wspan, int B,
                                int H, int W, int C, int OH, int OW, int th, int tw, int pitch,
                                int nnz_h, int nnz_w, int smem_bytes, void* stream) {
  return launch_row_bwd(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx),
                        hptr, hidx, hwt, wptr, widx, wwt, hspan, wspan,
                        RowBwdTile{B, H, W, OH, OW, th, tw, pitch, nnz_h, nnz_w, 0, 0}, C,
                        smem_bytes, stream);
}

int vaeunet_resize_scalar_f32(const float* x, float* y, const int* h0, const int* h1, const float* lh,
                       const int* w0, const int* w1, const float* lw, int B, int H, int W, int C,
                       int OH, int OW, void* stream) {
  return launch(x, y, h0, h1, lh, w0, w1, lw, B, H, W, C, OH, OW, stream);
}

int vaeunet_resize_scalar_bf16(const void* x, void* y, const int* h0, const int* h1, const float* lh,
                        const int* w0, const int* w1, const float* lw, int B, int H, int W, int C,
                        int OH, int OW, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), h0, h1, lh,
                w0, w1, lw, B, H, W, C, OH, OW, stream);
}

int vaeunet_resize_bwd_scalar_f32(const float* g, float* gx, const int* hptr, const int* hidx,
                           const float* hwt, const int* wptr, const int* widx, const float* wwt,
                           int B, int H, int W, int C, int OH, int OW, void* stream) {
  return launch_bwd(g, gx, hptr, hidx, hwt, wptr, widx, wwt, B, H, W, C, OH, OW, stream);
}

int vaeunet_resize_bwd_scalar_bf16(const void* g, void* gx, const int* hptr, const int* hidx,
                            const float* hwt, const int* wptr, const int* widx, const float* wwt,
                            int B, int H, int W, int C, int OH, int OW, void* stream) {
  return launch_bwd(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx), hptr,
                    hidx, hwt, wptr, widx, wwt, B, H, W, C, OH, OW, stream);
}

}  // extern "C"

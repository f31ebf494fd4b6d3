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
// therefore deterministic and need no atomics.  The fp32 and the wgmma
// kernels cover an output tile of kTH x kTW = 8 x 16 pixels of one image per
// block, the Ci <= 8 kernel one of kSTH x kSTW = 4 x 64; the scratch has one
// row per tile of the kernel that runs.
//
// Pixels outside H x W and channels beyond Co are masked on the way out, so
// the moments cover only the valid output; that replaces the TPU wrapper's
// row-padding branch (conv_bn_stats.py:100-107).  The moments are taken from
// the fp32 accumulators before y is rounded to its type, as the TPU kernel
// takes them (conv_bn_stats.py:56-60).
//
// Bound on this card: operations, 2 * B*H*W*Ci*Co*9 over the peak of the
// input type (989 TFLOP/s on the bf16 tensor cores; 67 TFLOP/s on the fp32
// pipes), far above the bytes term at the training step's shapes.
//
// bf16: conv3x3_stats_wgmma_kernel, an implicit GEMM on the tensor cores
// with M = the tile's 128 pixels, N = BN output channels (64 when Co <= 64,
// else 128) and K = 9 taps x Ci in steps of 64 channels.  Each K step is one
// (channel chunk, kx) pair.  One producer warp loads, by TMA with 128-byte
// swizzle, the step's input patch (a box of 64 channels x 16 columns x 10
// rows of x, at column w0 + kx - 1 and row h0 - 1) and the three weight
// slices (ky = 0, 1, 2) of that kx; the three ky windows of the patch are its
// rows ky .. ky + 7, 2 KB apart, so one patch serves three taps.  TMA fills
// everything outside x with zeros: that is the convolution's padding, the
// negative coordinates included, and the ragged last channel chunk, so
// there is no halo staging and no padded copy of x.  Two consumer
// warpgroups (output rows 0-3 and 4-7) issue wgmma.m64nBNk16 from shared
// memory, 12 per step, over a ring of stages guarded by mbarriers.  The
// epilogue stores y as bf16 from the fp32 accumulators and reduces each
// column's moments over the thread's rows, then a fixed __shfl_xor tree,
// then the 8 warps in order through shared memory.
//
// bf16 with Ci <= 8 (the plain UNet's first conv, Ci = 3):
// conv3x3_stats_ci8_kernel.  There the wgmma kernel would load a 64-channel
// box for 8 real channels (x zero-padded to 8 by a copy first), multiply
// 61 zero channels of 64 and pay its per-tile cost (TMA round trip, barrier
// ring, epilogue) on 8 x 16 pixels of little work; its bound is the y write
// (B*H*W*Co*2 bytes: 0.16 ms at [16,3,512,512]->64), not the operations.
// So a block owns a 4 x 64 pixel tile and 64 output channels, loads the
// (4+2) x (64+2) halo of the Ci real channels once into shared memory (zero
// outside x: the padding), and multiplies the implicit im2col [256 pixels,
// K] by the weights [K, 64] with mma.sync m16n8k16 on the tensor cores,
// K = 9 * Ci in the order tap * Ci + c (tap = ky * 3 + kx), padded with zero
// weights to a multiple of 16 (Ci = 3: 27 -> 32, two K steps).  Each warp
// owns 32 pixels of one tile row, gathers its A fragments from the halo and
// reads its B fragments from the staged weights.  y leaves through shared
// memory as 16-byte stores, a warp writing whole 128-byte pixels of 64
// channels side by side; the moments are taken from the fp32 accumulators
// before rounding, summed over the 8 lanes of a column in a fixed butterfly
// and the 8 warps in order into the tile's scratch row.  Ci is a template
// parameter (1 .. 8), so the K map is compile-time; Co must be a multiple
// of 8 (the C entry refuses any other).
//
// fp32: conv3x3_stats_f32_kernel, a register-tiled SIMT kernel with true fp32
// products and sums (FMA; no TF32, no tensor cores: this route is what holds
// the card against the CPU to 1e-5, and what TrainConfig.amp = False trains
// with).  Its bound is the 67 TFLOP/s of the fp32 pipes.  An SM starts four
// FMA warp-instructions a clock but only one shared-memory one, so the
// design is about FMAs per shared-memory load and about never waiting on
// global memory:
//   - a block is 128 threads for the tile's 128 pixels x 64 output channels;
//     a thread owns 8 neighbouring columns of one output row x 8 channels
//     (two runs of 4: cg*4.. and 32 + cg*4..), 64 accumulators;
//   - shared memory holds, per stage, the (8+2) x (16+2) input patch of a
//     chunk of kF32Chunk input channels, channel fastest, and the chunk's
//     9 x kF32Chunk x 64 weights, output channel fastest.  Every load in the
//     inner loop is 16 bytes (LDS.128): 10 loads fetch four input channels of
//     the thread's 10 input columns of one patch row, which serve its 8
//     outputs x 3 kx taps from registers, and 2 loads fetch the 8 weights of
//     one (tap, input channel): 34 loads for 768 FMAs.  The 8 threads that
//     share a pixel group read one address (a broadcast); the 4 pixel groups
//     of a warp are 4 patch rows, which the row pitch (+4 floats) puts on
//     disjoint banks; the 8 channel groups read 128 contiguous bytes;
//   - a ring of kF32Stages stages filled by cp.async, 16 bytes a thread
//     where Ci is a multiple of 4 and x starts on a 16-byte address, else 4
//     bytes; the padding, the pixels outside x and the channels past Ci are
//     the copy's zero fill.  The loads of chunk k + kF32Stages - 1 run under
//     the FMAs of chunk k, one __syncthreads a chunk;
//   - y leaves as 16-byte stores, a pixel's channels on neighbouring
//     addresses (scalar where Co is not a multiple of 4); the moments go
//     thread rows first, then the 16 pixel groups of each channel in order
//     through shared memory into the tile's scratch row.
//
// Weights: fp32 [9][ci_pad][co_pad] with tap = ky * 3 + kx, Co fastest, zero
// beyond Ci and Co (ci_pad a multiple of the chunk, co_pad of the block's 64
// channels, so the weight copies need no guard); bf16 K-major [9][Co][Ci]
// with tap = kx * 3 + ky and Ci a multiple of 8 (TMA needs 16-byte strides);
// bf16 with Ci <= 8: [Co][K padded to 16], k = (ky * 3 + kx) * Ci + c, zero
// past 9 * Ci.  The wrapper makes all three from PyTorch's OIHW, and
// zero-pads the channels of a bf16 x for the wgmma kernel where Ci (> 8) is
// not a multiple of 8.
//
// The TMA descriptors are encoded on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;             // output rows per tile
constexpr int kTW = 16;            // output columns per tile

// ----- fp32: SIMT, register-tiled -------------------------------------------

constexpr int kF32Chunk = 8;                     // input channels per stage
constexpr int kF32Stages = 3;                    // stages of the cp.async ring
constexpr int kF32BlocksPerSm = 2;               // __launch_bounds__'s blocks an SM
constexpr int kF32BN = 64;                       // output channels per block
constexpr int kF32Threads = 2 * kF32BN;          // 16 pixel groups x 8 channel groups
constexpr int kPH = kTH + 2;                     // staged patch: 10 rows
constexpr int kPW = kTW + 2;                     //               18 columns
// floats per staged patch row: 4 more than its pixels hold, so that the four
// rows a warp's pixel groups read start on disjoint banks
constexpr int kXRow = kPW * kF32Chunk + 4;
constexpr int kXFloats = kPH * kXRow;
constexpr int kWFloats = 9 * kF32Chunk * kF32BN;
constexpr int kStageFloats = kXFloats + kWFloats;
constexpr int kF32Smem = kF32Stages * kStageFloats * 4;
constexpr int kPixGroups = kF32Threads / (kF32BN / 8);   // 16
constexpr int kReduceLanes = 32;                 // rows reduced side by side per channel

static_assert(kF32Chunk % 4 == 0 && kF32Chunk <= 32, "a chunk is whole 16-byte vectors");
static_assert(kF32Stages >= 2, "the ring needs a stage to fill while one is read");
static_assert(kPixGroups * 8 == kTH * kTW, "tile and thread map disagree");
static_assert(2 * kPixGroups * kF32BN <= kF32Stages * kStageFloats, "moment scratch must fit");
static_assert(kF32Smem <= 232448, "over the card's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies `valid ? 16 : 0` bytes and fills the rest of the 16 with zeros
__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once at most N of the newest groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: the patch of input channels [ci0, ci0 + kF32Chunk) around the
// tile at (h0, w0) into xs[row][column][channel], zero outside x and past
// Ci, and the chunk's weights into ws[tap][channel][output channel].  Every
// divisor is a compile-time constant.
template <bool VEC>
__device__ __forceinline__ void stage_chunk(float* xs, float* ws, const float* __restrict__ x_img,
                                            const float* __restrict__ w, int H, int W, int Ci,
                                            int ci_pad, int co_pad, int h0, int w0, int ci0,
                                            int co0) {
  const int t = threadIdx.x;
  constexpr int kPer = VEC ? 4 : 1;                  // channels a copy moves
  constexpr int kCV = kF32Chunk / kPer;              // copies per pixel
  for (int i = t; i < kPH * kPW * kCV; i += kF32Threads) {
    const int cv = i % kCV;
    const int p = i / kCV;
    const int pr = p / kPW;
    const int pc = p % kPW;
    const int hh = h0 - 1 + pr;
    const int ww = w0 - 1 + pc;
    const int cc = ci0 + cv * kPer;
    const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && cc < Ci;
    const float* src = ok ? x_img + (static_cast<int64_t>(hh) * W + ww) * Ci + cc : x_img;
    float* dst = xs + pr * kXRow + pc * kF32Chunk + cv * kPer;
    if (VEC) {
      cp_async_16(dst, src, ok);
    } else {
      cp_async_4(dst, src, ok);
    }
  }
  constexpr int kRowVecs = kF32BN / 4;
  for (int i = t; i < 9 * kF32Chunk * kRowVecs; i += kF32Threads) {
    const int v = i % kRowVecs;
    const int r = i / kRowVecs;                      // tap * kF32Chunk + channel
    const int tap = r / kF32Chunk;
    const int ci = r % kF32Chunk;
    cp_async_16(ws + r * kF32BN + v * 4,
                w + (static_cast<int64_t>(tap) * ci_pad + ci0 + ci) * co_pad + co0 + v * 4, true);
  }
}

// Block = one 8 x 16 pixel tile of one image x 64 output channels
// (blockIdx.x = tile * n_blocks + channel block).  Thread t: channel group
// cg = t % 8 (channels cg*4 .. +3 and 32 + cg*4 .. +3), pixel group pg = t / 8
// = one tile row and 8 neighbouring columns of it; the 4 pixel groups of a
// warp are 4 rows of the same columns.
template <bool VEC>
__global__ void __launch_bounds__(kF32Threads, kF32BlocksPerSm)
conv3x3_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ y, float* __restrict__ part_s,
                         float* __restrict__ part_q, int H, int W, int Ci, int Co, int ci_pad,
                         int co_pad, int tiles_h, int tiles_w, int n_blocks) {
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);

  const int nb = blockIdx.x % n_blocks;
  const int tile = blockIdx.x / n_blocks;
  const int tw_i = tile % tiles_w;
  const int th_i = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  const int h0 = th_i * kTH;
  const int w0 = tw_i * kTW;
  const int co0 = nb * kF32BN;

  const int t = threadIdx.x;
  const int cg = t % (kF32BN / 8);
  const int pg = t / (kF32BN / 8);
  const int pr = (pg & 3) + ((pg >> 3) << 2);      // tile row
  const int pc0 = ((pg >> 2) & 1) * 8;             // first of the 8 tile columns

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;

  const float* x_img = x + static_cast<int64_t>(b) * H * W * Ci;
  const int n_chunks = (Ci + kF32Chunk - 1) / kF32Chunk;

  // fill all but one stage; a group is committed per chunk even when it is
  // empty, so that the wait below always counts the same number of groups
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < n_chunks)
      stage_chunk<VEC>(smem + s * kStageFloats, smem + s * kStageFloats + kXFloats, x_img, w, H, W,
                       Ci, ci_pad, co_pad, h0, w0, s * kF32Chunk, co0);
    cp_async_commit();
  }
  int slot = 0;                    // the stage chunk k is read from
  int fill = kF32Stages - 1;       // the stage chunk k + kF32Stages - 1 goes into
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<kF32Stages - 2>();     // chunk k has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and chunk k - 1 has been read
    const int nk = k + kF32Stages - 1;
    if (nk < n_chunks)
      stage_chunk<VEC>(smem + fill * kStageFloats, smem + fill * kStageFloats + kXFloats, x_img, w,
                       H, W, Ci, ci_pad, co_pad, h0, w0, nk * kF32Chunk, co0);
    cp_async_commit();

    const float* xrow = smem + slot * kStageFloats + pr * kXRow + pc0 * kF32Chunk;
    const float* wcol = smem + slot * kStageFloats + kXFloats + cg * 4;
#pragma unroll 1
    for (int c4 = 0; c4 < kF32Chunk; c4 += 4) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // four input channels of the 10 patch columns under this thread's 8 outputs
        float xa[10][4];
#pragma unroll
        for (int j = 0; j < 10; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(xrow + ky * kXRow + j * kF32Chunk + c4);
          xa[j][0] = v.x;
          xa[j][1] = v.y;
          xa[j][2] = v.z;
          xa[j][3] = v.w;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wp = wcol + ((ky * 3 + kx) * kF32Chunk + c4 + cc) * kF32BN;
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + kF32BN / 2);
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const float a = xa[p + kx][cc];
              acc[p][0] = fmaf(a, wa.x, acc[p][0]);
              acc[p][1] = fmaf(a, wa.y, acc[p][1]);
              acc[p][2] = fmaf(a, wa.z, acc[p][2]);
              acc[p][3] = fmaf(a, wa.w, acc[p][3]);
              acc[p][4] = fmaf(a, wb.x, acc[p][4]);
              acc[p][5] = fmaf(a, wb.y, acc[p][5]);
              acc[p][6] = fmaf(a, wb.z, acc[p][6]);
              acc[p][7] = fmaf(a, wb.w, acc[p][7]);
            }
          }
        }
      }
    }
    slot = slot + 1 == kF32Stages ? 0 : slot + 1;
    fill = fill + 1 == kF32Stages ? 0 : fill + 1;
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free: the moments go through it

  // y, 16 bytes a store, and this thread's moments over its valid pixels.
  // Channels past Co have zero weights, so their accumulators are 0.
  float ls[8];
  float lq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ls[j] = 0.0f;
    lq[j] = 0.0f;
  }
  const int hh = h0 + pr;
  const bool vec_out = Co % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ww = w0 + pc0 + p;
    if (hh < H && ww < W) {
      float* yp = y + ((static_cast<int64_t>(b) * H + hh) * W + ww) * Co;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int oc = co0 + half * (kF32BN / 2) + cg * 4;
        if (vec_out && oc + 3 < Co) {
          *reinterpret_cast<float4*>(yp + oc) = make_float4(
              acc[p][4 * half], acc[p][4 * half + 1], acc[p][4 * half + 2], acc[p][4 * half + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (oc + e < Co) yp[oc + e] = acc[p][4 * half + e];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ls[j] += acc[p][j];
        lq[j] += acc[p][j] * acc[p][j];
      }
    }
  }
  // the block's moments: the 16 pixel groups of each channel, in order
  float* red_s = smem;                            // [kPixGroups][kF32BN]
  float* red_q = smem + kPixGroups * kF32BN;      // [kPixGroups][kF32BN]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = pg * kF32BN + half * (kF32BN / 2) + cg * 4;
    *reinterpret_cast<float4*>(red_s + c) =
        make_float4(ls[4 * half], ls[4 * half + 1], ls[4 * half + 2], ls[4 * half + 3]);
    *reinterpret_cast<float4*>(red_q + c) =
        make_float4(lq[4 * half], lq[4 * half + 1], lq[4 * half + 2], lq[4 * half + 3]);
  }
  __syncthreads();
  {
    const int co = t % kF32BN;
    const float* red = t < kF32BN ? red_s : red_q;
    float v = 0.0f;
#pragma unroll
    for (int g = 0; g < kPixGroups; ++g) v += red[g * kF32BN + co];
    if (co0 + co < Co) {
      float* part = t < kF32BN ? part_s : part_q;
      part[static_cast<int64_t>(tile) * Co + co0 + co] = v;
    }
  }
}

// ----- bf16: TMA + wgmma ----------------------------------------------------

constexpr int kTcThreads = 288;                  // warps 0-7: two consumer warpgroups; warp 8: producer
constexpr int kChunk = 64;                       // input channels per K step: one 128-byte row
constexpr int kRowBytes = kChunk * 2;
constexpr int kPatchPixels = (kTH + 2) * kTW;    // 10 rows of 16 columns
constexpr int kABytes = kPatchPixels * kRowBytes;   // 20480

template <int BN>
struct TcConfig {
  // BN 64: two blocks of 2 stages on an SM, so one block's epilogue and
  // pipeline fill overlap the other's steps (the Ci = 64 layers have only 3
  // K steps).  BN 128: 145 registers a thread allow one block, of 3 stages.
  static constexpr int kStages = BN == 64 ? 2 : 3;
  static constexpr int kBlocksPerSm = BN == 64 ? 2 : 1;
  static constexpr int kBBytes = 3 * BN * kRowBytes;       // ky = 0, 1, 2
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRedFloats = 8 * BN;                // [warp][column], per moment
  // 1 KB of slack to align the ring to the 1024-byte swizzle atom
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kRedFloats * 4 + 16 * kStages;
  static_assert(kStageBytes % 1024 == 0, "stages must stay on 1024-byte swizzle atoms");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed; a wait of more
// than ~10 s (a pipeline fault) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused.  A K
// step of 16 bf16 inside the row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_m64n64(d, da, db);
  } else {
    wgmma_m64n128(d, da, db);
  }
}

// Block = one 8 x 16 pixel tile of one image x BN output channels
// (blockIdx.x = tile * n_blocks + channel block).  Accumulator layout of
// wgmma m64nBN: warp q of a warpgroup holds its rows 16q .. 16q + 15, lane l
// rows 16q + l/4 and 16q + l/4 + 8, and d[4j + 2i + e] is (row + 8i, column
// 8j + 2(l%4) + e).  A warpgroup's 64 rows are 4 image rows of 16 pixels, so
// warp q of warpgroup g owns tile row 4g + q and lane l its columns l/4 and
// l/4 + 8.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, TcConfig<BN>::kBlocksPerSm)
conv3x3_stats_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           __nv_bfloat16* __restrict__ y, float* __restrict__ part_s,
                           float* __restrict__ part_q, int H, int W, int Co, int n_chunks,
                           int tiles_h, int tiles_w, int n_blocks) {
  using Cfg = TcConfig<BN>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* red_s = reinterpret_cast<float*>(smem_raw + (ring - raw) + kStages * Cfg::kStageBytes);
  float* red_q = red_s + Cfg::kRedFloats;
  const uint32_t full0 = ring + kStages * Cfg::kStageBytes + 2 * Cfg::kRedFloats * 4;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int nb = blockIdx.x % n_blocks;
  const int tile = blockIdx.x / n_blocks;
  const int tw_i = tile % tiles_w;
  const int th_i = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  const int h0 = th_i * kTH;
  const int w0 = tw_i * kTW;
  const int co0 = nb * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int steps = 3 * n_chunks;     // (chunk, kx) pairs

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);      // the producer's arrive, plus the TMA bytes
      mbar_init(empty0 + 8 * s, 2);     // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int k = 0; k < steps; ++k) {
        const int s = k % kStages;
        mbar_wait(empty0 + 8 * s, ((k / kStages) & 1) ^ 1);
        const int chunk = k / 3;
        const int kx = k % 3;
        const uint32_t a = ring + s * Cfg::kStageBytes;
        mbar_arrive_expect_tx(full0 + 8 * s, Cfg::kStageBytes);
        tma_load_4d(a, &x_map, full0 + 8 * s, chunk * kChunk, w0 + kx - 1, h0 - 1, b);
        tma_load_3d(a + kABytes, &w_map, full0 + 8 * s, chunk * kChunk, co0, 3 * kx);
      }
    }
    return;
  }

  // consumers
  const int g = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int k = 0; k < steps; ++k) {
    const int s = k % kStages;
    mbar_wait(full0 + 8 * s, (k / kStages) & 1);
    const uint32_t a = ring + s * Cfg::kStageBytes + g * 4 * kTW * kRowBytes;
    const uint32_t bw = ring + s * Cfg::kStageBytes + kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_step<BN>(acc, sw128_desc(a + ky * kTW * kRowBytes + kk * 32),
                       sw128_desc(bw + ky * BN * kRowBytes + kk * 32));
    wgmma_commit();
    fence_regs(acc);
    if (k > 0) {
      // step k - 1 has finished reading its stage
      wgmma_wait<1>();
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * ((k - 1) % kStages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: y from the fp32 accumulators, then the moments of valid pixels
  const int q = warp % 4;
  const int hh = h0 + 4 * g + q;
  const int c0 = w0 + lane / 4;
  const bool v0 = hh < H && c0 < W;
  const bool v1 = hh < H && c0 + 8 < W;
  const int64_t pix0 = (static_cast<int64_t>(b) * H + hh) * W + c0;
  __nv_bfloat16* y0 = y + pix0 * Co;
  __nv_bfloat16* y1 = y + (pix0 + 8) * Co;
  const bool pairs = Co % 2 == 0;
  float ls[BN / 4];
  float lq[BN / 4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = co0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = v0 ? acc[4 * j + e] : 0.0f;
      const float a1 = v1 ? acc[4 * j + 2 + e] : 0.0f;
      ls[2 * j + e] = a0 + a1;
      lq[2 * j + e] = a0 * a0 + a1 * a1;
    }
    if (pairs) {
      if (co < Co) {
        if (v0)
          *reinterpret_cast<__nv_bfloat162*>(y0 + co) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (v1)
          *reinterpret_cast<__nv_bfloat162*>(y1 + co) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (co + e < Co) {
          if (v0) y0[co + e] = __float2bfloat16_rn(acc[4 * j + e]);
          if (v1) y1[co + e] = __float2bfloat16_rn(acc[4 * j + 2 + e]);
        }
      }
    }
  }
  // the 8 lanes that share a column, in a fixed butterfly
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], m);
      lq[i] += __shfl_xor_sync(0xffffffffu, lq[i], m);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red_s[warp * BN + 8 * j + 2 * lane + e] = ls[2 * j + e];
        red_q[warp * BN + 8 * j + 2 * lane + e] = lq[2 * j + e];
      }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");     // the consumer warps only
  // the 8 warps of each column, in order
  const int t = threadIdx.x;
  if (t < 2 * BN) {
    const int col = t % BN;
    const float* red = t < BN ? red_s : red_q;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) v += red[w * BN + col];
    if (co0 + col < Co) {
      float* part = t < BN ? part_s : part_q;
      part[static_cast<int64_t>(tile) * Co + co0 + col] = v;
    }
  }
}

// ----- bf16, Ci <= 8: implicit im2col on mma.sync ---------------------------

constexpr int kSTH = 4;                          // output rows per tile
constexpr int kSTW = 64;                         // output columns per tile
constexpr int kSThreads = 256;                   // warp w: tile row w / 2, columns (w % 2) * 32 ..
constexpr int kSBN = 64;                         // output channels per block
constexpr int kSOutPitch = kSBN * 2 + 16;        // bytes of a staged output pixel (+4 banks)

template <int CI>
struct SmallCi {
  static_assert(CI >= 1 && CI <= 8, "the route takes 1 .. 8 input channels");
  static constexpr int kK = 9 * CI;                        // taps x channels
  static constexpr int kKP = (kK + 15) / 16 * 16;          // padded to whole K steps
  static constexpr int kSteps = kKP / 16;
  static constexpr int kHaloRow = (kSTW + 2) * CI;         // bf16 a halo row
  static constexpr int kHalo = (kSTH + 2) * kHaloRow;
  static constexpr int kHaloBytes = (kHalo * 2 + 15) / 16 * 16;
  static constexpr int kRowWords = kKP / 2;                // 32-bit words of a weight row
  static constexpr int kPitchWords = kRowWords + 4;        // +4 banks: conflict-free B loads
  static constexpr int kWBytes = kSBN * kPitchWords * 4;
  static constexpr int kStageBytes = 16 * kSOutPitch;      // one warp's m16 tile of y
  static constexpr int kSmem = kHaloBytes + kWBytes + 8 * kStageBytes + 2 * 8 * kSBN * 4;
  static_assert(kSmem <= 48 * 1024, "static shared memory limit");
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block = one 4 x 64 pixel tile of one image (blockIdx.x) x 64 output
// channels (blockIdx.y).  Fragments of mma m16n8k16 (lane l, g = l / 4,
// tg = l % 4): A rows g and g + 8 (pixels), columns 2tg, 2tg + 1 and
// 8 + 2tg, 9 + 2tg (K); B column g (output channel), rows 2tg, 2tg + 1 and
// 8 + 2tg, 9 + 2tg; D rows g and g + 8, columns 2tg and 2tg + 1.
template <int CI>
__global__ void __launch_bounds__(kSThreads)
conv3x3_stats_ci8_kernel(const uint16_t* __restrict__ x, const uint32_t* __restrict__ w,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ part_s,
                         float* __restrict__ part_q, int H, int W, int Co, int tiles_h,
                         int tiles_w) {
  using C = SmallCi<CI>;
  __shared__ __align__(16) uint8_t smem_ci8[C::kSmem];
  uint16_t* halo = reinterpret_cast<uint16_t*>(smem_ci8);
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem_ci8 + C::kHaloBytes);
  uint8_t* stage = smem_ci8 + C::kHaloBytes + C::kWBytes;
  float* red_s = reinterpret_cast<float*>(stage + 8 * C::kStageBytes);
  float* red_q = red_s + 8 * kSBN;

  const int tile = blockIdx.x;
  const int tw_i = tile % tiles_w;
  const int th_i = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  const int h0 = th_i * kSTH;
  const int w0 = tw_i * kSTW;
  const int co0 = blockIdx.y * kSBN;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;

  // the halo: rows h0 - 1 .. h0 + kSTH, columns w0 - 1 .. w0 + kSTW, each row
  // one contiguous run of x; zero outside x
  const uint16_t* xb = x + static_cast<int64_t>(b) * H * W * CI;
  for (int i = t; i < C::kHalo; i += kSThreads) {
    const int r = i / C::kHaloRow;
    const int e = i - r * C::kHaloRow;
    const int hh = h0 - 1 + r;
    const int ww = w0 - 1 + e / CI;
    uint16_t v = 0;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = xb[(static_cast<int64_t>(hh) * W + w0 - 1) * CI + e];
    halo[i] = v;
  }
  // the block's 64 weight rows (zero past Co)
  for (int i = t; i < kSBN * C::kRowWords; i += kSThreads) {
    const int n = i / C::kRowWords;
    const int kw = i - n * C::kRowWords;
    ws[n * C::kPitchWords + kw] =
        co0 + n < Co ? w[static_cast<int64_t>(co0 + n) * C::kRowWords + kw] : 0u;
  }
  __syncthreads();

  const int g = lane >> 2;
  const int tg = lane & 3;
  const int row = warp >> 1;                 // tile row of the warp
  const int colw = (warp & 1) * 32;          // its first tile column
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < C::kSteps; ++s) {
    // this lane's four K indices of the step and their halo offsets
    int off[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = s * 16 + (j >> 1) * 8 + 2 * tg + (j & 1);
      const int tap = k / CI;
      const int c = k - tap * CI;
      const int ky = tap / 3;
      ok[j] = k < C::kK;
      off[j] = ky * C::kHaloRow + (tap - 3 * ky) * CI + c;
    }
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const uint16_t* px = halo + row * C::kHaloRow + (colw + 16 * m + g + 8 * hr) * CI;
        uint32_t e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = ok[j] ? px[off[j]] : 0u;
        a[m][hr] = e[0] | (e[1] << 16);          // K 2tg, 2tg + 1
        a[m][2 + hr] = e[2] | (e[3] << 16);      // K 8 + 2tg, 9 + 2tg
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* wr = ws + (8 * j + g) * C::kPitchWords + 8 * s + tg;
      const uint32_t b0 = wr[0];
      const uint32_t b1 = wr[4];
      mma_bf16_16816(acc[0][j], a[0], b0, b1);
      mma_bf16_16816(acc[1][j], a[1], b0, b1);
    }
  }

  // epilogue: the moments of valid pixels from the fp32 accumulators
  const int hh = h0 + row;
  float ls[8][2];
  float lq[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ls[j][e] = 0.0f;
      lq[j][e] = 0.0f;
    }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int col = w0 + colw + 16 * m + g + 8 * hr;
      if (hh < H && col < W) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[m][j][2 * hr + e];
            ls[j][e] += v;
            lq[j][e] += v * v;
          }
      }
    }
  // the 8 lanes of a column, in a fixed butterfly
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int msk = 4; msk < 32; msk <<= 1) {
        ls[j][e] += __shfl_xor_sync(0xffffffffu, ls[j][e], msk);
        lq[j][e] += __shfl_xor_sync(0xffffffffu, lq[j][e], msk);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red_s[warp * kSBN + 8 * j + 2 * tg + e] = ls[j][e];
        red_q[warp * kSBN + 8 * j + 2 * tg + e] = lq[j][e];
      }
  }
  // y, one m16 tile at a time through the warp's stage: bf16 pairs in, then
  // 16 bytes a lane out, 8 lanes a pixel (its 64 channels, 128 bytes)
  uint8_t* st = stage + warp * C::kStageBytes;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(st + (g + 8 * hr) * kSOutPitch + (8 * j + 2 * tg) * 2) =
            __floats2bfloat162_rn(acc[m][j][2 * hr], acc[m][j][2 * hr + 1]);
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int p = it * 4 + lane / 8;          // pixel of the m16 tile
      const int ch = lane % 8;                  // its 8-channel chunk
      const int col = w0 + colw + 16 * m + p;
      if (hh < H && col < W && co0 + 8 * ch < Co)
        *reinterpret_cast<uint4*>(y + ((static_cast<int64_t>(b) * H + hh) * W + col) * Co + co0 +
                                  8 * ch) =
            *reinterpret_cast<const uint4*>(st + p * kSOutPitch + ch * 16);
    }
    __syncwarp();
  }
  __syncthreads();
  // the 8 warps of each column, in order, into the tile's scratch row
  if (t < 2 * kSBN) {
    const int col = t % kSBN;
    const float* red = t < kSBN ? red_s : red_q;
    float v = 0.0f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) v += red[w8 * kSBN + col];
    if (co0 + col < Co) {
      float* part = t < kSBN ? part_s : part_q;
      part[static_cast<int64_t>(tile) * Co + co0 + col] = v;
    }
  }
}

template <int CI>
int launch_ci8(const void* x, const void* w, void* y, float* part_s, float* part_q, int H, int W,
               int Co, int tiles, int tiles_h, int tiles_w, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>((Co + kSBN - 1) / kSBN));
  conv3x3_stats_ci8_kernel<CI><<<grid, kSThreads, 0, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<__nv_bfloat16*>(y), part_s, part_q, H, W, Co, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
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

int reduce_partials(float* part_s, float* part_q, float* s, float* q, int tiles, int Co,
                    cudaStream_t st) {
  const dim3 rgrid(static_cast<unsigned int>((Co + 31) / 32), 2);
  reduce_partials_kernel<<<rgrid, kReduceLanes * 32, 0, st>>>(part_s, part_q, s, q, tiles, Co);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool encode_bf16(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc != nullptr &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, void* y, float* part_s, float* part_q, int B,
                 int H, int W, int Ci, int Co, int tiles, int tiles_h, int tiles_w,
                 cudaStream_t st) {
  using Cfg = TcConfig<BN>;
  const uint64_t ci = static_cast<uint64_t>(Ci);
  CUtensorMap x_map, w_map;
  // x as NHWC [B][H][W][Ci], innermost first; box 64 ch x 16 w x 10 h x 1 image
  const cuuint64_t x_dims[4] = {ci, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {ci * 2, ci * 2 * W, ci * 2 * W * H};
  const cuuint32_t x_box[4] = {kChunk, kTW, kTH + 2, 1};
  // w as [9][Co][Ci]; box 64 ch x BN out channels x 3 taps
  const cuuint64_t w_dims[3] = {ci, static_cast<cuuint64_t>(Co), 9};
  const cuuint64_t w_strides[2] = {ci * 2, ci * 2 * Co};
  const cuuint32_t w_box[3] = {kChunk, BN, 3};
  if (!encode_bf16(&x_map, x, 4, x_dims, x_strides, x_box) ||
      !encode_bf16(&w_map, w, 3, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_stats_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (Co + BN - 1) / BN;
  const unsigned int grid = static_cast<unsigned int>(tiles) * n_blocks;
  conv3x3_stats_wgmma_kernel<BN><<<grid, kTcThreads, Cfg::kSmem, st>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(y), part_s, part_q, H, W, Co,
      (Ci + kChunk - 1) / kChunk, tiles_h, tiles_w, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `tiles` is the row count of the scratch the wrapper allocated; it must
// equal the grid's tile count, or nothing is launched.

// x: NHWC fp32; w: [9][ci_pad][co_pad] fp32 on a 16-byte address, tap =
// ky * 3 + kx, zero beyond Ci and Co, ci_pad a multiple of the kernel's chunk
// and co_pad of its 64 channels a block.
int vaeunet_conv3x3_stats_f32(const float* x, const float* w, float* y, float* part_s,
                              float* part_q, float* s, float* q, int B, int H, int W, int Ci,
                              int Co, int ci_pad, int co_pad, int tiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int n_blocks = (Co + kF32BN - 1) / kF32BN;
  if (tiles != B * tiles_h * tiles_w || ci_pad < Ci || ci_pad % kF32Chunk != 0 ||
      co_pad < n_blocks * kF32BN || co_pad % 4 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      static_cast<int64_t>(tiles) * n_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto kernel = vec ? conv3x3_stats_f32_kernel<true> : conv3x3_stats_f32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) {
    cudaGetLastError();      // off the runtime's last-error slot
    return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(tiles) * n_blocks, kF32Threads, kF32Smem, st>>>(
      x, w, y, part_s, part_q, H, W, Ci, Co, ci_pad, co_pad, tiles_h, tiles_w, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_partials(part_s, part_q, s, q, tiles, Co, st);
}

// x: NHWC bf16 with Ci % 8 == 0 and a 16-byte-aligned base; w: [9][Co][Ci]
// bf16, tap = kx * 3 + ky.
int vaeunet_conv3x3_stats_bf16_wgmma(const void* x, const void* w, void* y, float* part_s,
                                     float* part_q, float* s, float* q, int B, int H, int W,
                                     int Ci, int Co, int tiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kTH - 1) / kTH;
  const int tiles_w = (W + kTW - 1) / kTW;
  if (tiles != B * tiles_h * tiles_w || Ci % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = Co <= 64
                     ? launch_wgmma<64>(x, w, y, part_s, part_q, B, H, W, Ci, Co, tiles, tiles_h,
                                        tiles_w, st)
                     : launch_wgmma<128>(x, w, y, part_s, part_q, B, H, W, Ci, Co, tiles,
                                         tiles_h, tiles_w, st);
  if (rc != 0) return rc;
  return reduce_partials(part_s, part_q, s, q, tiles, Co, st);
}

// x: NHWC bf16 with 1 <= Ci <= 8 (2-byte aligned); w: [Co][K padded to 16]
// bf16 on a 4-byte address, k = (ky * 3 + kx) * Ci + c, zero past 9 * Ci;
// y on a 16-byte address; Co a multiple of 8 (any other is refused).
int vaeunet_conv3x3_stats_bf16_ci8(const void* x, const void* w, void* y, float* part_s,
                                   float* part_q, float* s, float* q, int B, int H, int W, int Ci,
                                   int Co, int tiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kSTH - 1) / kSTH;
  const int tiles_w = (W + kSTW - 1) / kSTW;
  if (tiles != B * tiles_h * tiles_w || Ci < 1 || Ci > 8 || Co < 8 || Co % 8 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  switch (Ci) {
    case 1: rc = launch_ci8<1>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    case 2: rc = launch_ci8<2>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    case 3: rc = launch_ci8<3>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    case 4: rc = launch_ci8<4>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    case 5: rc = launch_ci8<5>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    case 6: rc = launch_ci8<6>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    case 7: rc = launch_ci8<7>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
    default: rc = launch_ci8<8>(x, w, y, part_s, part_q, H, W, Co, tiles, tiles_h, tiles_w, st); break;
  }
  if (rc != 0) return rc;
  return reduce_partials(part_s, part_q, s, q, tiles, Co, st);
}

}  // extern "C"

// Training-mode BatchNorm (+ ReLU, or SiLU in the bn_batch_ family) of a
// channels_last tensor from its per-channel moments, forward and backward, for
// Hopper.
//
// Replaces no Pallas kernel: the JAX package leaves the normalization after
// its conv + moments kernel to XLA, which fuses it into the surrounding
// elementwise work.  In the port the same math ran as ~50 small torch kernels
// a site, forward and backward, most of them fp32 broadcasts over the whole
// activation (ops/layers.py::BatchNorm.forward_moments, F.relu, their autograd
// and the fold of the moments' cotangents).  These kernels are that math:
//
//   forward   out = relu?(round((y - mean) * inv + bias)), with mean = s / n,
//             var = max(q / n - mean^2, 0), inv = rsqrt(var + eps) * weight
//             folded per channel inside the kernel, and the running
//             statistics moved by one designated block;
//   backward  g' = g masked where out <= 0 (relu), A = sum g',
//             B = sum g' (y - mean) per channel, then
//             dy = inv g' + k0 + k1 (y - mean) with k0 = -inv A / n and
//             k1 = 2 dvar' / n (dvar' the variance's cotangent through rsqrt
//             and the clamp): the paths through s and q are folded in, so the
//             conv's backward takes dy as it is.  dweight = B rsqrt(var + eps),
//             dbias = A.
//
// Bound on this card: bytes.  The least a site moves is y in and out out
// (forward), g and y in and dy out (backward): 5 x tensor bytes / 3.35 TB/s.
// The design keeps to that: every fp32 intermediate of the torch path stays
// in registers; each thread owns one 16-byte channel vector (V = 8 bf16 or 4
// fp32 channels) and walks rows kRowsInFlight at a time with all loads issued
// before the first store, as bn_relu.cu does; the per-channel fold is done
// once a thread, in registers.  The backward needs its two sums before it can
// write dy, so it reads g and y twice (7 passes where the bound counts 5);
// the sums pass runs on a grid of a few blocks an SM and writes one row of
// partial sums a block, and the block that takes the last ticket sums those
// rows in a fixed order: deterministic, with no atomics on values.
//
// The forward's bits are torch's: each product and sum of the fold and of
// the normalization is rounded as the torch op rounds it (__fmul_rn,
// __fsub_rn, __fadd_rn, never contracted), a division by the host scalar n
// is torch's product with the reciprocal rounded in fp32 (inv_n, made on the
// host), rsqrtf is what torch's CUDA rsqrt calls, the output is rounded once
// to y's type and the ReLU is torch's clamp_min on the rounded value.  The
// running statistics take x * (1 - m) rounded, then torch's add with alpha,
// self + alpha * other, which nvcc contracts into one fma.  The backward
// recomputes out with the same steps, so its mask is the forward's.
//
// The bn_batch_ family does the same for a tensor that comes without its
// moments (every training BN outside the fused 3x3 sites: after a 1x1 or
// strided conv, the latent projections, the attention gates):
// bn_batch_moments_kernel reads x once for its fp32 per-channel sum s and
// sum of squares q, on the backward's sums structure (a partial row a
// block, the last ticket adding the rows in a fixed order: deterministic,
// no atomics on values), and the normalisation and the two-pass backward
// are the kernels above under their own names, so the trace tells the two
// families apart.  The forward entry launches moments then normalisation,
// the backward entry sums then dy: one host call each way.  A site moves 8
// passes (moments 1, forward 2, backward 5) where torch's BN moved ~7 and
// a ReLU beside it 4 more.
//
// The activation is a template parameter of every kernel (Act: identity,
// ReLU, SiLU).  SiLU, which only the bn_batch_ family instantiates (the
// EfficientNet encoder's BN + SiLU sites), is torch's: out = z / (1 + exp(-z))
// on the rounded normalised z, rounded again to the tensor's type; its backward
// recomputes z from x and the moments, as the ReLU's mask is recomputed, and
// takes g' = g s (1 + z (1 - s)), s = 1 / (1 + exp(-z)), in fp32 (torch's
// silu_backward, without rounding g' to the tensor's type).
//
// Routes and blocks are planned on the host (ops/pallas/bn_train.py::plan,
// on bn_relu's plan), never as a fallback: the vector route (C a multiple
// of V, the tensors on 16-byte addresses) and the scalar route (V = 1) for
// every other tensor.  The entries return cudaErrorInvalidValue for a plan
// they cannot launch.

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;       // the most a plan's block may hold
constexpr int kRowsInFlight = 4;    // rows a thread loads before its first store
constexpr int kMaxVec = 8;

// the scalars of the fold and of the running statistics' update, rounded
// to fp32 on the host as torch rounds a host scalar
struct Params {
  float inv_n;      // 1 / n, rounded
  float eps;
  float momentum;   // m
  float keep;       // 1 - m
  float unbias;     // n / (n - 1)
};

__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// the activation after the normalisation
enum Act : int { kIdentity = 0, kRelu = 1, kSilu = 2 };

// torch's sigmoid of the SiLU, forward and backward: 1 / (1 + exp(-z))
__device__ __forceinline__ float sigmoid_of(float z) { return 1.0f / (1.0f + expf(-z)); }

template <Act kAct>
__device__ __forceinline__ float activate(float v) {
  if constexpr (kAct == kRelu) return clamp_min0(v);
  else if constexpr (kAct == kSilu) return v / (1.0f + expf(-v));
  else return v;
}

template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one channel's fold: mean, the unclamped and clamped variance, rsqrt(var + eps)
struct Fold {
  float mean, var_raw, var, r;
};

__device__ __forceinline__ Fold fold1(float s, float q, const Params& p) {
  Fold f;
  f.mean = __fmul_rn(s, p.inv_n);
  f.var_raw = __fsub_rn(__fmul_rn(q, p.inv_n), __fmul_rn(f.mean, f.mean));
  f.var = clamp_min0(f.var_raw);
  f.r = rsqrtf(__fadd_rn(f.var, p.eps));
  return f;
}

// the forward's output of one element, rounded to T, before the ReLU
template <typename T>
__device__ __forceinline__ float normalized(float yc, float inv, float bias) {
  return round_to<T>(__fadd_rn(__fmul_rn(yc, inv), bias));
}

// torch's x.mul_(1 - m).add_(t, alpha=m)
__device__ __forceinline__ float running(float x, float t, const Params& p) {
  return fmaf(p.momentum, t, __fmul_rn(x, p.keep));
}

// The per-channel vectors of V channels from channel c on.
template <int V>
struct Channels {
  float mean[V], inv[V], bias[V];

  __device__ __forceinline__ void load(const float* s, const float* q, const float* w,
                                       const float* b, int c, bool vec, const Params& p) {
    float sv[V], qv[V], wv[V];
    load_stats<V>(s, c, vec, sv);
    load_stats<V>(q, c, vec, qv);
    load_stats<V>(w, c, vec, wv);
    load_stats<V>(b, c, vec, bias);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const Fold f = fold1(sv[j], qv[j], p);
      mean[j] = f.mean;
      inv[j] = __fmul_rn(f.r, wv[j]);
    }
  }
};

// The forward of one block's rows: out = act(normalized), and the running
// statistics moved by the first row of blocks.
template <typename T, int V, Act kAct>
__device__ __forceinline__ void normalize_rows(
    const typename Lanes<T, V>::Raw* __restrict__ y, typename Lanes<T, V>::Raw* __restrict__ out,
    const float* __restrict__ s, const float* __restrict__ q, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ run_mean, float* __restrict__ run_var,
    long long* __restrict__ count, const Params& p, int64_t rows, int vecs, bool vec_stats,
    bool update) {
  using L = Lanes<T, V>;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;     // this thread's channel vector
  if (v >= vecs) return;
  Channels<V> ch;
  ch.load(s, q, w, b, v * V, vec_stats, p);

  if (update && blockIdx.x == 0 && threadIdx.y == 0) {     // one row of threads a channel chunk
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = v * V + j;
      const Fold f = fold1(s[c], q[c], p);
      run_mean[c] = running(run_mean[c], f.mean, p);
      run_var[c] = running(run_var[c], __fmul_rn(f.var, p.unbias), p);
    }
    if (v == 0) *count += 1;
  }

  const int64_t by = blockDim.y;
  const int64_t step = static_cast<int64_t>(gridDim.x) * by * kRowsInFlight;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * by * kRowsInFlight + threadIdx.y;
       r0 < rows; r0 += step) {
    typename L::Raw in[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * by;
      if (r < rows) in[u] = y[r * vecs + v];
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * by;
      if (r >= rows) break;
      float f[V];
      L::unpack(in[u], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = activate<kAct>(normalized<T>(__fsub_rn(f[j], ch.mean[j]), ch.inv[j], ch.bias[j]));
      }
      out[r * vecs + v] = L::pack(f);
    }
  }
}

template <typename T, int V, Act kAct>
__global__ void __launch_bounds__(kThreads)
bn_train_fwd_kernel(const typename Lanes<T, V>::Raw* __restrict__ y,
                    typename Lanes<T, V>::Raw* __restrict__ out, const float* __restrict__ s,
                    const float* __restrict__ q, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ run_mean,
                    float* __restrict__ run_var, long long* __restrict__ count, Params p,
                    int64_t rows, int vecs, bool vec_stats, bool update) {
  normalize_rows<T, V, kAct>(y, out, s, q, w, b, run_mean, run_var, count, p, rows, vecs,
                              vec_stats, update);
}

template <typename T, int V, Act kAct>
__global__ void __launch_bounds__(kThreads)
bn_batch_fwd_kernel(const typename Lanes<T, V>::Raw* __restrict__ y,
                    typename Lanes<T, V>::Raw* __restrict__ out, const float* __restrict__ s,
                    const float* __restrict__ q, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ run_mean,
                    float* __restrict__ run_var, long long* __restrict__ count, Params p,
                    int64_t rows, int vecs, bool vec_stats, bool update) {
  normalize_rows<T, V, kAct>(y, out, s, q, w, b, run_mean, run_var, count, p, rows, vecs,
                              vec_stats, update);
}

// g' of one element, the output's cotangent through the activation: g where
// the forward's output is kept by the ReLU (torch's threshold_backward: 0
// where out <= 0); g s (1 + z (1 - s)) through the SiLU (torch's silu_backward)
template <typename T, Act kAct>
__device__ __forceinline__ float masked(float g, float yc, float inv, float bias) {
  if constexpr (kAct == kIdentity) return g;
  const float z = normalized<T>(yc, inv, bias);
  if constexpr (kAct == kRelu) {
    return z <= 0.0f ? 0.0f : g;
  } else {
    const float sg = sigmoid_of(z);
    return g * sg * (1.0f + z * (1.0f - sg));
  }
}

// Sums the block's [block_y][block_x * V] values of `red` over its rows, in
// a fixed order; row 0 holds the result.
template <int V>
__device__ __forceinline__ void sum_rows(float (*red)[kThreads * kMaxVec], int t, int ty,
                                         int bx, int by) {
  int half = 1;
  while (half < by) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (ty < half && ty + half < by) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][t * V + j] += red[0][(t + half * bx) * V + j];
        red[1][t * V + j] += red[1][(t + half * bx) * V + j];
      }
    }
    __syncthreads();
  }
}

// Two per-channel sums over every row, for the thread's V channels (sa,
// sb): the block adds its rows of threads in a fixed order into one partial
// row of [gridDim.x][2][C]; the block that takes the last ticket of its
// channel chunk adds the partial rows in a fixed order and resets the
// ticket.  Returns true in that block alone, where the threads of row 0
// then hold the chunk's totals in sa, sb.
template <int V>
__device__ __forceinline__ bool chunk_totals(float (&sa)[V], float (&sb)[V], float* partial,
                                             unsigned int* tickets, int v, bool live, int c) {
  __shared__ float red[2][kThreads * kMaxVec];
  __shared__ bool last;
  const int bx = blockDim.x, by = blockDim.y, ty = threadIdx.y;
  const int t = ty * bx + threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][t * V + j] = sa[j];
    red[1][t * V + j] = sb[j];
  }
  __syncthreads();
  sum_rows<V>(red, t, ty, bx, by);
  if (ty == 0 && live) {
    float* row = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      row[v * V + j] = red[0][t * V + j];
      row[c + v * V + j] = red[1][t * V + j];
    }
  }
  __threadfence();        // the partial row is visible before the ticket is taken
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;

  // the chunk's last block: its rows of threads take the partial rows in turn
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.0f;
  if (live) {
    for (int pr = ty; pr < static_cast<int>(gridDim.x); pr += by) {
      const float* row = partial + static_cast<int64_t>(pr) * 2 * c;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sa[j] += __ldcg(row + v * V + j);
        sb[j] += __ldcg(row + c + v * V + j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][t * V + j] = sa[j];
    red[1][t * V + j] = sb[j];
  }
  __syncthreads();
  sum_rows<V>(red, t, ty, bx, by);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sa[j] = red[0][t * V + j];
    sb[j] = red[1][t * V + j];
  }
  if (t == 0) tickets[blockIdx.y] = 0;
  return true;
}

// Pass 1 of the backward: A and B a channel, summed by chunk_totals; the
// last block of a chunk writes its k0, k1 (coef [2][C]), dweight and dbias.
template <typename T, int V, Act kAct>
__device__ __forceinline__ void backward_sums(
    const typename Lanes<T, V>::Raw* __restrict__ g, const typename Lanes<T, V>::Raw* __restrict__ y,
    const float* __restrict__ s, const float* __restrict__ q, const float* __restrict__ w,
    const float* __restrict__ b, const Params& p, int64_t rows, int vecs, bool vec_stats,
    float* partial, unsigned int* tickets, float* __restrict__ coef, float* __restrict__ dw,
    float* __restrict__ db) {
  using L = Lanes<T, V>;
  const int by = blockDim.y, ty = threadIdx.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = v < vecs;
  const int c = vecs * V;

  float sa[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.0f;
  if (live) {
    Channels<V> ch;
    ch.load(s, q, w, b, v * V, vec_stats, p);
    const int64_t step = static_cast<int64_t>(gridDim.x) * by * kRowsInFlight;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * by * kRowsInFlight + ty; r0 < rows;
         r0 += step) {
      typename L::Raw gin[kRowsInFlight], yin[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * by;
        if (r < rows) {
          gin[u] = g[r * vecs + v];
          yin[u] = y[r * vecs + v];
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (r0 + u * by >= rows) break;
        float gf[V], yf[V];
        L::unpack(gin[u], gf);
        L::unpack(yin[u], yf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float yc = __fsub_rn(yf[j], ch.mean[j]);
          const float gp = masked<T, kAct>(gf[j], yc, ch.inv[j], ch.bias[j]);
          sa[j] += gp;
          sb[j] = fmaf(gp, yc, sb[j]);
        }
      }
    }
  }
  if (!chunk_totals<V>(sa, sb, partial, tickets, v, live, c)) return;
  if (ty == 0 && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int k = v * V + j;
      const float a = sa[j], bsum = sb[j];
      const Fold f = fold1(s[k], q[k], p);
      const float inv = __fmul_rn(f.r, w[k]);
      // rsqrt's gradient, -0.5 r^3, then the clamp's: it passes where var_raw >= 0
      const float dvar = -0.5f * (bsum * w[k]) * f.r * f.r * f.r;
      const float dvar_raw = f.var_raw >= 0.0f ? dvar : 0.0f;
      coef[k] = -inv * a * p.inv_n;
      coef[c + k] = 2.0f * dvar_raw * p.inv_n;
      dw[k] = bsum * f.r;
      db[k] = a;
    }
  }
}

template <typename T, int V, Act kAct>
__global__ void __launch_bounds__(kThreads)
bn_train_bwd_reduce_kernel(const typename Lanes<T, V>::Raw* __restrict__ g,
                           const typename Lanes<T, V>::Raw* __restrict__ y,
                           const float* __restrict__ s, const float* __restrict__ q,
                           const float* __restrict__ w, const float* __restrict__ b, Params p,
                           int64_t rows, int vecs, bool vec_stats, float* partial,
                           unsigned int* tickets, float* __restrict__ coef,
                           float* __restrict__ dw, float* __restrict__ db) {
  backward_sums<T, V, kAct>(g, y, s, q, w, b, p, rows, vecs, vec_stats, partial, tickets, coef,
                             dw, db);
}

template <typename T, int V, Act kAct>
__global__ void __launch_bounds__(kThreads)
bn_batch_bwd_reduce_kernel(const typename Lanes<T, V>::Raw* __restrict__ g,
                           const typename Lanes<T, V>::Raw* __restrict__ y,
                           const float* __restrict__ s, const float* __restrict__ q,
                           const float* __restrict__ w, const float* __restrict__ b, Params p,
                           int64_t rows, int vecs, bool vec_stats, float* partial,
                           unsigned int* tickets, float* __restrict__ coef,
                           float* __restrict__ dw, float* __restrict__ db) {
  backward_sums<T, V, kAct>(g, y, s, q, w, b, p, rows, vecs, vec_stats, partial, tickets, coef,
                             dw, db);
}

// Pass 2 of the backward: dy = inv g' + k0 + k1 (y - mean), rounded once.
template <typename T, int V, Act kAct>
__device__ __forceinline__ void backward_apply(
    const typename Lanes<T, V>::Raw* __restrict__ g, const typename Lanes<T, V>::Raw* __restrict__ y,
    typename Lanes<T, V>::Raw* __restrict__ dy, const float* __restrict__ s,
    const float* __restrict__ q, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ coef, const Params& p, int64_t rows, int vecs, bool vec_stats) {
  using L = Lanes<T, V>;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= vecs) return;
  Channels<V> ch;
  ch.load(s, q, w, b, v * V, vec_stats, p);
  float k0[V], k1[V];
  load_stats<V>(coef, v * V, vec_stats, k0);
  load_stats<V>(coef + vecs * V, v * V, vec_stats, k1);

  const int64_t by = blockDim.y;
  const int64_t step = static_cast<int64_t>(gridDim.x) * by * kRowsInFlight;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * by * kRowsInFlight + threadIdx.y;
       r0 < rows; r0 += step) {
    typename L::Raw gin[kRowsInFlight], yin[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * by;
      if (r < rows) {
        gin[u] = g[r * vecs + v];
        yin[u] = y[r * vecs + v];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * by;
      if (r >= rows) break;
      float gf[V], yf[V];
      L::unpack(gin[u], gf);
      L::unpack(yin[u], yf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float yc = __fsub_rn(yf[j], ch.mean[j]);
        const float gp = masked<T, kAct>(gf[j], yc, ch.inv[j], ch.bias[j]);
        gf[j] = fmaf(ch.inv[j], gp, fmaf(k1[j], yc, k0[j]));
      }
      dy[r * vecs + v] = L::pack(gf);
    }
  }
}

template <typename T, int V, Act kAct>
__global__ void __launch_bounds__(kThreads)
bn_train_bwd_apply_kernel(const typename Lanes<T, V>::Raw* __restrict__ g,
                          const typename Lanes<T, V>::Raw* __restrict__ y,
                          typename Lanes<T, V>::Raw* __restrict__ dy,
                          const float* __restrict__ s, const float* __restrict__ q,
                          const float* __restrict__ w, const float* __restrict__ b,
                          const float* __restrict__ coef, Params p, int64_t rows, int vecs,
                          bool vec_stats) {
  backward_apply<T, V, kAct>(g, y, dy, s, q, w, b, coef, p, rows, vecs, vec_stats);
}

template <typename T, int V, Act kAct>
__global__ void __launch_bounds__(kThreads)
bn_batch_bwd_apply_kernel(const typename Lanes<T, V>::Raw* __restrict__ g,
                          const typename Lanes<T, V>::Raw* __restrict__ y,
                          typename Lanes<T, V>::Raw* __restrict__ dy,
                          const float* __restrict__ s, const float* __restrict__ q,
                          const float* __restrict__ w, const float* __restrict__ b,
                          const float* __restrict__ coef, Params p, int64_t rows, int vecs,
                          bool vec_stats) {
  backward_apply<T, V, kAct>(g, y, dy, s, q, w, b, coef, p, rows, vecs, vec_stats);
}

// The moments of x: its fp32 sum s and sum of squares q a channel, written
// to sq [2][C] by the last block of each channel chunk (one read of x).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_batch_moments_kernel(const typename Lanes<T, V>::Raw* __restrict__ x, int64_t rows, int vecs,
                        float* partial, unsigned int* tickets, float* __restrict__ sq) {
  using L = Lanes<T, V>;
  const int by = blockDim.y, ty = threadIdx.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = v < vecs;
  const int c = vecs * V;

  float sa[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.0f;
  if (live) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * by * kRowsInFlight;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * by * kRowsInFlight + ty; r0 < rows;
         r0 += step) {
      typename L::Raw in[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * by;
        if (r < rows) in[u] = x[r * vecs + v];
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (r0 + u * by >= rows) break;
        float f[V];
        L::unpack(in[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sa[j] += f[j];
          sb[j] = fmaf(f[j], f[j], sb[j]);
        }
      }
    }
  }
  if (!chunk_totals<V>(sa, sb, partial, tickets, v, live, c)) return;
  if (ty == 0 && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sq[v * V + j] = sa[j];
      sq[c + v * V + j] = sb[j];
    }
  }
}

// the checks every launch shares: a plan of `vec` channels a thread, a
// block of block_x x block_y threads, grid_y chunks that cover C
bool plan_ok(int64_t rows, int c, int vec, int kvec, int block_x, int block_y, int grid_x,
             int grid_y) {
  return rows > 0 && c > 0 && block_x > 0 && block_y > 0 && block_x * block_y <= kThreads &&
         grid_x > 0 && grid_y > 0 && grid_y <= 65535 && (vec == 1 || vec == kvec) &&
         c % vec == 0 && static_cast<int64_t>(block_x) * grid_y >= c / vec;
}

// The normalisation launch of either family (kBatch: bn_batch_fwd_kernel).
template <typename T, int V, Act kAct, bool kBatch>
void fwd(const T* y, T* out, const float* s, const float* q, const float* w, const float* b,
         float* rm, float* rv, long long* count, const Params& p, int64_t rows, int c,
         dim3 grid, dim3 block, bool update, cudaStream_t st) {
  using Raw = typename Lanes<T, V>::Raw;
  const bool vec_stats = V > 1 && aligned16(s) && aligned16(q) && aligned16(w) && aligned16(b);
  const Raw* yr = reinterpret_cast<const Raw*>(y);
  Raw* outr = reinterpret_cast<Raw*>(out);
  if constexpr (kBatch)
    bn_batch_fwd_kernel<T, V, kAct><<<grid, block, 0, st>>>(yr, outr, s, q, w, b, rm, rv, count,
                                                            p, rows, c / V, vec_stats, update);
  else
    bn_train_fwd_kernel<T, V, kAct><<<grid, block, 0, st>>>(yr, outr, s, q, w, b, rm, rv, count,
                                                            p, rows, c / V, vec_stats, update);
}

template <typename T, int V, bool kBatch>
void fwd_act(const T* y, T* out, const float* s, const float* q, const float* w, const float* b,
             float* rm, float* rv, long long* count, const Params& p, int64_t rows, int c,
             dim3 grid, dim3 block, Act act, bool update, cudaStream_t st) {
  if constexpr (kBatch) {
    if (act == kSilu) {
      fwd<T, V, kSilu, kBatch>(y, out, s, q, w, b, rm, rv, count, p, rows, c, grid, block, update, st);
      return;
    }
  }
  if (act == kRelu) fwd<T, V, kRelu, kBatch>(y, out, s, q, w, b, rm, rv, count, p, rows, c, grid, block, update, st);
  else fwd<T, V, kIdentity, kBatch>(y, out, s, q, w, b, rm, rv, count, p, rows, c, grid, block, update, st);
}

// The activation a launch asks for, false for one its family has no kernel
// of: the forward's flags (1 ReLU, 4 SiLU) or the backward's code (0
// identity, 1 ReLU, 2 SiLU); SiLU in the bn_batch_ family alone.
bool act_of_flags(int flags, bool batch, Act* act) {
  const bool relu = flags & 1, silu = flags & 4;
  if ((relu && silu) || (silu && !batch)) return false;
  *act = silu ? kSilu : relu ? kRelu : kIdentity;
  return true;
}

bool act_of_code(int code, bool batch, Act* act) {
  if (code < kIdentity || code > kSilu || (code == kSilu && !batch)) return false;
  *act = static_cast<Act>(code);
  return true;
}

template <typename T, int kVec>
int launch_fwd(const T* y, T* out, const float* s, const float* q, const float* w,
               const float* b, float* rm, float* rv, long long* count, Params p, int64_t rows,
               int c, int vec, int block_x, int block_y, int grid_x, int grid_y, int flags,
               void* stream) {
  Act act;
  if (!plan_ok(rows, c, vec, kVec, block_x, block_y, grid_x, grid_y) ||
      (vec != 1 && !(aligned16(y) && aligned16(out))) || !act_of_flags(flags, false, &act))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool update = flags & 2;
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1)
    fwd_act<T, 1, false>(y, out, s, q, w, b, rm, rv, count, p, rows, c, grid, block, act, update, st);
  else
    fwd_act<T, kVec, false>(y, out, s, q, w, b, rm, rv, count, p, rows, c, grid, block, act, update, st);
  return static_cast<int>(cudaGetLastError());
}

// The bn_batch forward: the moments into sq [2][C] (`partial` [reduce_grid_x][2][C]
// and one zeroed ticket a chunk), then the normalisation from them.
template <typename T, int V>
int batch_fwd(const T* x, T* out, float* sq, float* partial, unsigned int* tickets,
              const float* w, const float* b, float* rm, float* rv, long long* count,
              const Params& p, int64_t rows, int c, dim3 reduce_grid, dim3 reduce_block,
              dim3 grid, dim3 block, Act act, bool update, cudaStream_t st) {
  using Raw = typename Lanes<T, V>::Raw;
  bn_batch_moments_kernel<T, V><<<reduce_grid, reduce_block, 0, st>>>(
      reinterpret_cast<const Raw*>(x), rows, c / V, partial, tickets, sq);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  fwd_act<T, V, true>(x, out, sq, sq + c, w, b, rm, rv, count, p, rows, c, grid, block, act,
                      update, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int launch_batch_fwd(const T* x, T* out, float* sq, float* partial, unsigned int* tickets,
                     const float* w, const float* b, float* rm, float* rv, long long* count,
                     Params p, int64_t rows, int c, int vec, int reduce_x, int reduce_y,
                     int reduce_grid_x, int reduce_grid_y, int block_x, int block_y, int grid_x,
                     int grid_y, int flags, void* stream) {
  Act act;
  if (!plan_ok(rows, c, vec, kVec, block_x, block_y, grid_x, grid_y) ||
      !plan_ok(rows, c, vec, kVec, reduce_x, reduce_y, reduce_grid_x, reduce_grid_y) ||
      (vec != 1 && !(aligned16(x) && aligned16(out))) || !act_of_flags(flags, true, &act))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool update = flags & 2;
  const dim3 rgrid(reduce_grid_x, reduce_grid_y), rblock(reduce_x, reduce_y);
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1)
    return batch_fwd<T, 1>(x, out, sq, partial, tickets, w, b, rm, rv, count, p, rows, c, rgrid,
                           rblock, grid, block, act, update, st);
  return batch_fwd<T, kVec>(x, out, sq, partial, tickets, w, b, rm, rv, count, p, rows, c, rgrid,
                            rblock, grid, block, act, update, st);
}

// The backward's two launches of either family (kBatch: the bn_batch_ kernels).
template <typename T, int V, Act kAct, bool kBatch>
int bwd(const T* g, const T* y, T* dy, const float* s, const float* q, const float* w,
        const float* b, float* partial, unsigned int* tickets, float* coef, float* dw, float* db,
        const Params& p, int64_t rows, int c, dim3 reduce_grid, dim3 reduce_block, dim3 grid,
        dim3 block, cudaStream_t st) {
  using Raw = typename Lanes<T, V>::Raw;
  const bool vec_stats = V > 1 && aligned16(s) && aligned16(q) && aligned16(w) &&
                         aligned16(b) && aligned16(coef);
  const Raw* gr = reinterpret_cast<const Raw*>(g);
  const Raw* yr = reinterpret_cast<const Raw*>(y);
  if constexpr (kBatch)
    bn_batch_bwd_reduce_kernel<T, V, kAct><<<reduce_grid, reduce_block, 0, st>>>(
        gr, yr, s, q, w, b, p, rows, c / V, vec_stats, partial, tickets, coef, dw, db);
  else
    bn_train_bwd_reduce_kernel<T, V, kAct><<<reduce_grid, reduce_block, 0, st>>>(
        gr, yr, s, q, w, b, p, rows, c / V, vec_stats, partial, tickets, coef, dw, db);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  Raw* dyr = reinterpret_cast<Raw*>(dy);
  if constexpr (kBatch)
    bn_batch_bwd_apply_kernel<T, V, kAct><<<grid, block, 0, st>>>(gr, yr, dyr, s, q, w, b, coef,
                                                                  p, rows, c / V, vec_stats);
  else
    bn_train_bwd_apply_kernel<T, V, kAct><<<grid, block, 0, st>>>(gr, yr, dyr, s, q, w, b, coef,
                                                                  p, rows, c / V, vec_stats);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool kBatch>
int bwd_act(const T* g, const T* y, T* dy, const float* s, const float* q, const float* w,
            const float* b, float* partial, unsigned int* tickets, float* coef, float* dw,
            float* db, const Params& p, int64_t rows, int c, dim3 reduce_grid, dim3 reduce_block,
            dim3 grid, dim3 block, Act act, cudaStream_t st) {
  if constexpr (kBatch) {
    if (act == kSilu)
      return bwd<T, V, kSilu, kBatch>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db, p,
                                      rows, c, reduce_grid, reduce_block, grid, block, st);
  }
  return act == kRelu
      ? bwd<T, V, kRelu, kBatch>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db, p, rows, c,
                                 reduce_grid, reduce_block, grid, block, st)
      : bwd<T, V, kIdentity, kBatch>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db, p,
                                     rows, c, reduce_grid, reduce_block, grid, block, st);
}

// Both backward launches.  The sums pass: a block of reduce_x x reduce_y
// threads, reduce_grid_x row groups by reduce_grid_y chunks, `partial`
// [reduce_grid_x][2][C] and one zeroed ticket a chunk; the apply pass the
// forward's plan; `act_code` the activation (0 identity, 1 ReLU, 2 SiLU).
template <typename T, int kVec, bool kBatch>
int launch_bwd(const T* g, const T* y, T* dy, const float* s, const float* q, const float* w,
               const float* b, float* partial, unsigned int* tickets, float* coef, float* dw,
               float* db, Params p, int64_t rows, int c, int vec, int reduce_x, int reduce_y,
               int reduce_grid_x, int reduce_grid_y, int block_x, int block_y, int grid_x,
               int grid_y, int act_code, void* stream) {
  Act act;
  if (!plan_ok(rows, c, vec, kVec, block_x, block_y, grid_x, grid_y) ||
      !plan_ok(rows, c, vec, kVec, reduce_x, reduce_y, reduce_grid_x, reduce_grid_y) ||
      (vec != 1 && !(aligned16(g) && aligned16(y) && aligned16(dy))) ||
      !act_of_code(act_code, kBatch, &act))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 rgrid(reduce_grid_x, reduce_grid_y), rblock(reduce_x, reduce_y);
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1)
    return bwd_act<T, 1, kBatch>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db, p, rows, c,
                                 rgrid, rblock, grid, block, act, st);
  return bwd_act<T, kVec, kBatch>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db, p, rows,
                                  c, rgrid, rblock, grid, block, act, st);
}

}  // namespace

extern "C" {

// y and out [rows, c] (a channels_last tensor); s, q (the moments), weight,
// bias, running mean and var float32 [c]; count the int64 batch counter;
// then the scalars, the plan (V, block, grid) and flags: 1 ReLU, 2 move the
// running statistics.  Returns a cudaError_t: 0, the launch's, or that of a
// refused plan.
int vaeunet_bn_train_fwd_f32(const float* y, float* out, const float* s, const float* q,
                             const float* w, const float* b, float* rm, float* rv,
                             long long* count, float inv_n, float eps, float momentum,
                             float keep, float unbias, int64_t rows, int c, int vec, int block_x,
                             int block_y, int grid_x, int grid_y, int flags, void* stream) {
  return launch_fwd<float, 4>(y, out, s, q, w, b, rm, rv, count,
                              Params{inv_n, eps, momentum, keep, unbias}, rows, c, vec, block_x,
                              block_y, grid_x, grid_y, flags, stream);
}

int vaeunet_bn_train_fwd_bf16(const void* y, void* out, const float* s, const float* q,
                              const float* w, const float* b, float* rm, float* rv,
                              long long* count, float inv_n, float eps, float momentum,
                              float keep, float unbias, int64_t rows, int c, int vec, int block_x,
                              int block_y, int grid_x, int grid_y, int flags, void* stream) {
  return launch_fwd<__nv_bfloat16, 8>(
      static_cast<const __nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out), s, q, w, b, rm, rv,
      count, Params{inv_n, eps, momentum, keep, unbias}, rows, c, vec, block_x, block_y, grid_x,
      grid_y, flags, stream);
}

// g, y and dy [rows, c]; s, q, weight, bias float32 [c]; partial, tickets,
// coef [2][c] scratch; dweight, dbias float32 [c]; the two plans and the
// activation: 0 identity, 1 ReLU.
int vaeunet_bn_train_bwd_f32(const float* g, const float* y, float* dy, const float* s,
                             const float* q, const float* w, const float* b, float* partial,
                             unsigned int* tickets, float* coef, float* dw, float* db,
                             float inv_n, float eps, int64_t rows, int c, int vec, int reduce_x,
                             int reduce_y, int reduce_grid_x, int reduce_grid_y, int block_x,
                             int block_y, int grid_x, int grid_y, int act, void* stream) {
  return launch_bwd<float, 4, false>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db,
                              Params{inv_n, eps, 0.0f, 0.0f, 0.0f}, rows, c, vec, reduce_x,
                              reduce_y, reduce_grid_x, reduce_grid_y, block_x, block_y, grid_x,
                              grid_y, act, stream);
}

int vaeunet_bn_train_bwd_bf16(const void* g, const void* y, void* dy, const float* s,
                              const float* q, const float* w, const float* b, float* partial,
                              unsigned int* tickets, float* coef, float* dw, float* db,
                              float inv_n, float eps, int64_t rows, int c, int vec, int reduce_x,
                              int reduce_y, int reduce_grid_x, int reduce_grid_y, int block_x,
                              int block_y, int grid_x, int grid_y, int act, void* stream) {
  return launch_bwd<__nv_bfloat16, 8, false>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(dy), s, q, w, b, partial, tickets, coef, dw, db,
      Params{inv_n, eps, 0.0f, 0.0f, 0.0f}, rows, c, vec, reduce_x, reduce_y, reduce_grid_x,
      reduce_grid_y, block_x, block_y, grid_x, grid_y, act, stream);
}

// x and out [rows, c] (a channels_last tensor); sq float32 [2][c], the
// moments it fills (s, then q); partial [reduce_grid_x][2][c] and tickets
// (one zeroed a chunk) the moments' scratch; weight, bias, running mean and
// var float32 [c]; count the int64 batch counter; then the scalars, the
// moments' plan (block, grid), the normalisation's (V, block, grid) and
// flags: 1 ReLU, 2 move the running statistics, 4 SiLU.  Two launches; returns a
// cudaError_t: 0, a launch's, or that of a refused plan.
int vaeunet_bn_batch_fwd_f32(const float* x, float* out, float* sq, float* partial,
                             unsigned int* tickets, const float* w, const float* b, float* rm,
                             float* rv, long long* count, float inv_n, float eps, float momentum,
                             float keep, float unbias, int64_t rows, int c, int vec, int reduce_x,
                             int reduce_y, int reduce_grid_x, int reduce_grid_y, int block_x,
                             int block_y, int grid_x, int grid_y, int flags, void* stream) {
  return launch_batch_fwd<float, 4>(x, out, sq, partial, tickets, w, b, rm, rv, count,
                                    Params{inv_n, eps, momentum, keep, unbias}, rows, c, vec,
                                    reduce_x, reduce_y, reduce_grid_x, reduce_grid_y, block_x,
                                    block_y, grid_x, grid_y, flags, stream);
}

int vaeunet_bn_batch_fwd_bf16(const void* x, void* out, float* sq, float* partial,
                              unsigned int* tickets, const float* w, const float* b, float* rm,
                              float* rv, long long* count, float inv_n, float eps, float momentum,
                              float keep, float unbias, int64_t rows, int c, int vec, int reduce_x,
                              int reduce_y, int reduce_grid_x, int reduce_grid_y, int block_x,
                              int block_y, int grid_x, int grid_y, int flags, void* stream) {
  return launch_batch_fwd<__nv_bfloat16, 8>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), sq, partial,
      tickets, w, b, rm, rv, count, Params{inv_n, eps, momentum, keep, unbias}, rows, c, vec,
      reduce_x, reduce_y, reduce_grid_x, reduce_grid_y, block_x, block_y, grid_x, grid_y, flags,
      stream);
}

// The bn_batch backward: vaeunet_bn_train_bwd_*'s arguments, with s and q
// the moments the forward entry wrote, and the activation 2 SiLU as well.
int vaeunet_bn_batch_bwd_f32(const float* g, const float* y, float* dy, const float* s,
                             const float* q, const float* w, const float* b, float* partial,
                             unsigned int* tickets, float* coef, float* dw, float* db,
                             float inv_n, float eps, int64_t rows, int c, int vec, int reduce_x,
                             int reduce_y, int reduce_grid_x, int reduce_grid_y, int block_x,
                             int block_y, int grid_x, int grid_y, int act, void* stream) {
  return launch_bwd<float, 4, true>(g, y, dy, s, q, w, b, partial, tickets, coef, dw, db,
                                    Params{inv_n, eps, 0.0f, 0.0f, 0.0f}, rows, c, vec, reduce_x,
                                    reduce_y, reduce_grid_x, reduce_grid_y, block_x, block_y,
                                    grid_x, grid_y, act, stream);
}

int vaeunet_bn_batch_bwd_bf16(const void* g, const void* y, void* dy, const float* s,
                              const float* q, const float* w, const float* b, float* partial,
                              unsigned int* tickets, float* coef, float* dw, float* db,
                              float inv_n, float eps, int64_t rows, int c, int vec, int reduce_x,
                              int reduce_y, int reduce_grid_x, int reduce_grid_y, int block_x,
                              int block_y, int grid_x, int grid_y, int act, void* stream) {
  return launch_bwd<__nv_bfloat16, 8, true>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(dy), s, q, w, b, partial, tickets, coef, dw, db,
      Params{inv_n, eps, 0.0f, 0.0f, 0.0f}, rows, c, vec, reduce_x, reduce_y, reduce_grid_x,
      reduce_grid_y, block_x, block_y, grid_x, grid_y, act, stream);
}

}  // extern "C"

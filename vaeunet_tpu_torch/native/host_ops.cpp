// Native host-side data-path kernels for vaeunet_tpu_torch (a copy of
// vaeunet_tpu/native/host_ops.cpp).
//
// The reference leans on native code for its host data path: PIL/cv2 decode
// and resize plus 6 multiprocessing DataLoader workers
// (reference utils/data_loading.py:18-28,580-601; train.py:239-248).  This
// library is the equivalent runtime component of the host data path: a
// thread-parallel patch gather / batch assembler, feathered tile blending,
// and bilinear resize, callable from Python via ctypes (no pybind11 in the
// image).  Each function releases the GIL by construction (pure C, buffers
// owned by numpy).
//
// Build: make -C vaeunet_tpu_torch/native OUT=<path of the .so>   (g++ -O3,
// threads via std::thread; no external deps).  vaeunet_tpu_torch.native
// runs this at first use with OUT under build/native/ at the checkout's root.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

void parallel_for(int64_t n, int num_threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (n <= 0) return;
  int threads = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(num_threads, n)));
  if (threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Gather B patches of size P x P x C from per-image uint8 planes into a
// float32 NHWC batch (scaled by 1/255), plus the matching float32 mask
// patches (HW1).  `image_ptrs`/`mask_ptrs` are per-patch base pointers
// (aliasing allowed), `coords` is [B,2] (y, x) int32, strides in elements.
void gather_patch_batch_u8(const uint8_t** image_ptrs, const uint8_t** mask_ptrs,
                           const int32_t* coords, int64_t batch, int64_t patch,
                           const int64_t* img_row_strides,
                           const int64_t* mask_row_strides, float* out_images,
                           float* out_masks, int num_threads) {
  const int64_t C = 3;
  parallel_for(batch, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const int64_t y0 = coords[2 * b];
      const int64_t x0 = coords[2 * b + 1];
      const uint8_t* img = image_ptrs[b];
      const uint8_t* msk = mask_ptrs[b];
      const int64_t irs = img_row_strides[b];   // elements per image row
      const int64_t mrs = mask_row_strides[b];
      float* oi = out_images + b * patch * patch * C;
      float* om = out_masks + b * patch * patch;
      for (int64_t r = 0; r < patch; ++r) {
        const uint8_t* src = img + (y0 + r) * irs + x0 * C;
        float* dst = oi + r * patch * C;
        for (int64_t k = 0; k < patch * C; ++k) dst[k] = src[k] / 255.0f;
        const uint8_t* ms = msk + (y0 + r) * mrs + x0;
        float* md = om + r * patch;
        for (int64_t k = 0; k < patch; ++k) md[k] = ms[k] > 0 ? 1.0f : 0.0f;
      }
    }
  });
}

// Feathered accumulation of T tiles [T,P,P] (float32 probabilities) with
// weights [T,P,P] into out/wsum [H,W] at origins coords [T,2]; the host
// fallback of the on-device scatter blend (visualize_vae.py:383-384,409).
void feathered_blend_f32(const float* tiles, const float* weights,
                         const int32_t* coords, int64_t n_tiles, int64_t patch,
                         float* out, float* wsum, int64_t h, int64_t w) {
  (void)h;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t y0 = coords[2 * t];
    const int64_t x0 = coords[2 * t + 1];
    const float* tp = tiles + t * patch * patch;
    const float* wp = weights + t * patch * patch;
    for (int64_t r = 0; r < patch; ++r) {
      float* orow = out + (y0 + r) * w + x0;
      float* wrow = wsum + (y0 + r) * w + x0;
      const float* trow = tp + r * patch;
      const float* wrow_in = wp + r * patch;
      for (int64_t c = 0; c < patch; ++c) {
        orow[c] += trow[c] * wrow_in[c];
        wrow[c] += wrow_in[c];
      }
    }
  }
}

// Bilinear resize (align_corners=false, PyTorch convention) of an
// [H,W,C] float32 image to [OH,OW,C]; thread-parallel over output rows.
void resize_bilinear_f32(const float* in, int64_t h, int64_t w, int64_t c,
                         float* out, int64_t oh, int64_t ow, int num_threads) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  parallel_for(oh, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      float fy = std::max(0.0f, (r + 0.5f) * sy - 0.5f);
      int64_t y0 = std::min<int64_t>(static_cast<int64_t>(fy), h - 1);
      int64_t y1 = std::min(y0 + 1, h - 1);
      float ly = fy - y0;
      for (int64_t q = 0; q < ow; ++q) {
        float fx = std::max(0.0f, (q + 0.5f) * sx - 0.5f);
        int64_t x0 = std::min<int64_t>(static_cast<int64_t>(fx), w - 1);
        int64_t x1 = std::min(x0 + 1, w - 1);
        float lx = fx - x0;
        const float* p00 = in + (y0 * w + x0) * c;
        const float* p01 = in + (y0 * w + x1) * c;
        const float* p10 = in + (y1 * w + x0) * c;
        const float* p11 = in + (y1 * w + x1) * c;
        float* o = out + (r * ow + q) * c;
        for (int64_t k = 0; k < c; ++k) {
          float top = p00[k] * (1 - lx) + p01[k] * lx;
          float bot = p10[k] * (1 - lx) + p11[k] * lx;
          o[k] = top * (1 - ly) + bot * ly;
        }
      }
    }
  });
}

}  // extern "C"

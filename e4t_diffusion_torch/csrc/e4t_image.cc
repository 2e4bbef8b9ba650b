// e4t_image.cc — fused host-side image preprocessing for the data loader.
//
// The port's own copy of the JAX package's native/e4t_image.cc, the same
// code under the same C interface, less the batched variant that nothing
// calls: SmallestMaxSize (area resampling,
// cv2.INTER_AREA semantics) + crop + horizontal flip + x/127.5-1
// normalization + HWC->CHW transpose, fused into one pass that only
// computes pixels inside the crop window. OpenMP-parallel over rows.
//
// Built with g++ at first use by e4t_diffusion_torch/data/native_ops.py
// (the flags of native/Makefile, without -fopenmp where OpenMP's runtime
// does not link) and loaded through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Area-resample one axis: returns, for output index o in [0, out), the
// source coverage [lo, hi) with fractional edges. scale = in/out (>1 when
// downscaling).
static inline void area_span(int o, double scale, int in_size,
                             double* lo, double* hi) {
  *lo = o * scale;
  *hi = std::min((o + 1) * scale, (double)in_size);
}

// Fused: resize (short side -> target, area interpolation), crop a
// target x target window at (crop_top, crop_left) in resized coords,
// optional horizontal flip, normalize to [-1, 1], write CHW float32.
//
// src:  uint8 RGB HWC (h, w, 3)
// out:  float32 (3, target, target)
// Returns 0 on success, -1 on bad args.
int fused_preprocess(const uint8_t* src, int h, int w,
                     int target, int crop_top, int crop_left, int flip,
                     float* out) {
  if (h <= 0 || w <= 0 || target <= 0) return -1;
  const double s = (double)target / (double)std::min(h, w);
  const int rh = (int)std::lround(h * s);
  const int rw = (int)std::lround(w * s);
  if (crop_top < 0 || crop_left < 0 || crop_top + target > rh ||
      crop_left + target > rw)
    return -1;
  const double sy = (double)h / (double)rh;  // source rows per output row
  const double sx = (double)w / (double)rw;

  const bool upscale = s > 1.0;

#pragma omp parallel for schedule(static)
  for (int oy = 0; oy < target; ++oy) {
    const int ry = oy + crop_top;  // row in resized image
    for (int ox = 0; ox < target; ++ox) {
      const int rx_base = ox + crop_left;
      const int rx = flip ? (crop_left + target - 1 - (ox)) : rx_base;
      float acc[3] = {0.f, 0.f, 0.f};
      if (!upscale) {
        // area average over fractional source box
        double ylo, yhi, xlo, xhi;
        area_span(ry, sy, h, &ylo, &yhi);
        area_span(rx, sx, w, &xlo, &xhi);
        const int y0 = (int)ylo, y1 = (int)std::ceil(yhi);
        const int x0 = (int)xlo, x1 = (int)std::ceil(xhi);
        double wsum = 0.0;
        double accd[3] = {0.0, 0.0, 0.0};
        for (int yy = y0; yy < y1 && yy < h; ++yy) {
          const double wy =
              std::min((double)(yy + 1), yhi) - std::max((double)yy, ylo);
          const uint8_t* row = src + (size_t)yy * w * 3;
          for (int xx = x0; xx < x1 && xx < w; ++xx) {
            const double wx =
                std::min((double)(xx + 1), xhi) - std::max((double)xx, xlo);
            const double wt = wy * wx;
            const uint8_t* px = row + (size_t)xx * 3;
            accd[0] += wt * px[0];
            accd[1] += wt * px[1];
            accd[2] += wt * px[2];
            wsum += wt;
          }
        }
        const double inv = wsum > 0 ? 1.0 / wsum : 0.0;
        acc[0] = (float)(accd[0] * inv);
        acc[1] = (float)(accd[1] * inv);
        acc[2] = (float)(accd[2] * inv);
      } else {
        // upscaling: cv2 INTER_AREA boundary-overlap interpolation —
        // output pixels fully inside a source pixel copy it; pixels
        // straddling a source boundary blend by the overlap fraction
        // (OpenCV resize: sx=floor(dx*scale); fx=(dx+1)-(sx+1)*inv_scale).
        const double inv_sy = 1.0 / sy;  // dst pixels per src pixel
        const double inv_sx = 1.0 / sx;
        const int y0 = std::min(h - 1, (int)std::floor(ry * sy));
        const int x0 = std::min(w - 1, (int)std::floor(rx * sx));
        double fy = (ry + 1) - (y0 + 1) * inv_sy;
        fy = fy <= 0 ? 0.0 : fy - std::floor(fy);
        double fx = (rx + 1) - (x0 + 1) * inv_sx;
        fx = fx <= 0 ? 0.0 : fx - std::floor(fx);
        const int y1 = std::min(h - 1, y0 + 1);
        const int x1 = std::min(w - 1, x0 + 1);
        for (int c = 0; c < 3; ++c) {
          const double v00 = src[((size_t)y0 * w + x0) * 3 + c];
          const double v01 = src[((size_t)y0 * w + x1) * 3 + c];
          const double v10 = src[((size_t)y1 * w + x0) * 3 + c];
          const double v11 = src[((size_t)y1 * w + x1) * 3 + c];
          acc[c] = (float)((1 - fy) * ((1 - fx) * v00 + fx * v01) +
                           fy * ((1 - fx) * v10 + fx * v11));
        }
      }
      const size_t plane = (size_t)target * target;
      const size_t idx = (size_t)oy * target + ox;
      out[0 * plane + idx] = acc[0] / 127.5f - 1.0f;
      out[1 * plane + idx] = acc[1] / 127.5f - 1.0f;
      out[2 * plane + idx] = acc[2] / 127.5f - 1.0f;
    }
  }
  return 0;
}

// resized dims helper so python can draw crop coordinates
void resized_dims(int h, int w, int target, int* rh, int* rw) {
  const double s = (double)target / (double)std::min(h, w);
  *rh = (int)std::lround(h * s);
  *rw = (int)std::lround(w * s);
}

}  // extern "C"

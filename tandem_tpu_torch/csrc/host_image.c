/* Host-side image code of the port: the PNG row unfilter, the undistortion
 * remap with the photometric LUT and the BGR repacks for the MVSNet
 * runner.
 *
 * Plain C, built with the host compiler into its own shared library
 * (native_bridge.py) and called through ctypes, which releases the GIL for
 * the call. Counterpart of the JAX package's native/tandem_native.cpp
 * (tandem_remap_u8 :117-164, tandem_bgr_to_rgb_chw :210-227,
 * tandem_bgr_pack_u8 :229-245), single-threaded, with the
 * arithmetic of the port's numpy versions: tandem_remap_u8 computes in
 * double in numpy's order (data/undistort.remap_u8, built with
 * -ffp-contract=off so no multiply-add is fused), tandem_bgr_to_rgb_chw
 * divides by 255 in float32 as numpy does.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* The five PNG row filters (PNG spec 9.2) of `h` rows of `stride` bytes,
 * each row preceded by its filter byte in `raw`; `bpp` bytes per complete
 * pixel (at least 1). Returns 0, or 1 + the index of the first row whose
 * filter byte is unknown. */
int tandem_png_unfilter(const uint8_t* raw, int h, int64_t stride, int bpp,
                        uint8_t* out) {
  for (int y = 0; y < h; y++) {
    const uint8_t* line = raw + (int64_t)y * (stride + 1);
    const uint8_t ftype = line[0];
    const uint8_t* src = line + 1;
    uint8_t* cur = out + (int64_t)y * stride;
    const uint8_t* up = y > 0 ? cur - stride : NULL;
    int64_t x;
    switch (ftype) {
      case 0:
        memcpy(cur, src, (size_t)stride);
        break;
      case 1: /* sub */
        for (x = 0; x < stride && x < bpp; x++) cur[x] = src[x];
        for (; x < stride; x++) cur[x] = (uint8_t)(src[x] + cur[x - bpp]);
        break;
      case 2: /* up */
        if (up)
          for (x = 0; x < stride; x++) cur[x] = (uint8_t)(src[x] + up[x]);
        else
          memcpy(cur, src, (size_t)stride);
        break;
      case 3: /* average */
        for (x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4: /* paeth */
        for (x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          int p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(src[x] + p);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

/* Bilinear remap of an (in_h, in_w, channels) uint8 image through the
 * (out_h, out_w) grids map_x / map_y into double output, then the optional
 * 256-entry LUT (the inverse response), as data/undistort.remap_u8 and the
 * JAX package's numpy remap: a pixel is 0 where a map entry is negative
 * (before the LUT); the left/top corner is clipped to [0, in - 2] and its
 * weight to [0, 1]. */
void tandem_remap_u8(const uint8_t* src, int in_w, int in_h, int channels,
                     const float* map_x, const float* map_y, int out_w,
                     int out_h, const float* lut256, double* dst) {
  for (int64_t o = 0; o < (int64_t)out_w * out_h; o++) {
    const double mx = map_x[o], my = map_y[o];
    const int valid = mx >= 0 && my >= 0;
    const double fx = valid ? floor(mx) : 0, fy = valid ? floor(my) : 0;
    const int64_t x0 = fx > in_w - 2 ? in_w - 2 : (int64_t)fx;
    const int64_t y0 = fy > in_h - 2 ? in_h - 2 : (int64_t)fy;
    double wx = mx - (double)x0, wy = my - (double)y0;
    wx = wx < 0 ? 0 : (wx > 1 ? 1 : wx);
    wy = wy < 0 ? 0 : (wy > 1 ? 1 : wy);
    const uint8_t* p00 = src + (y0 * in_w + x0) * channels;
    const uint8_t* p01 = p00 + channels;
    const uint8_t* p10 = p00 + (int64_t)in_w * channels;
    const uint8_t* p11 = p10 + channels;
    for (int ch = 0; ch < channels; ch++) {
      double v = 0.0;
      if (valid)
        v = (double)(float)p00[ch] * (1 - wx) * (1 - wy)
            + (double)(float)p01[ch] * wx * (1 - wy)
            + (double)(float)p10[ch] * (1 - wx) * wy
            + (double)(float)p11[ch] * wx * wy;
      if (lut256) { /* on every pixel, the zeroed ones too, as numpy */
        int64_t i0 = (int64_t)v;
        i0 = i0 < 0 ? 0 : (i0 > 254 ? 254 : i0);
        const double f = v - (double)i0;
        v = (double)lut256[i0] * (1 - f) + (double)lut256[i0 + 1] * f;
      }
      dst[o * channels + ch] = v;
    }
  }
}

/* (h, w, 3) BGR uint8 -> (3, h, w) RGB float32 in [0, 1]. */
void tandem_bgr_to_rgb_chw(const uint8_t* bgr, int w, int h, float* rgb_chw) {
  const int64_t plane = (int64_t)w * h;
  for (int64_t i = 0; i < plane; i++) {
    rgb_chw[i] = (float)bgr[i * 3 + 2] / 255.0f;
    rgb_chw[plane + i] = (float)bgr[i * 3 + 1] / 255.0f;
    rgb_chw[2 * plane + i] = (float)bgr[i * 3 + 0] / 255.0f;
  }
}

/* n_views (h, w, 3) BGR uint8 views -> one (n_views, 3, h, w) RGB uint8
 * block: the MVSNet runner's input layout. */
void tandem_bgr_pack_u8(const uint8_t* const* bgr_views, int n_views, int w,
                        int h, uint8_t* out) {
  const int64_t plane = (int64_t)w * h;
  for (int v = 0; v < n_views; v++) {
    const uint8_t* src = bgr_views[v];
    uint8_t* dst = out + (int64_t)v * 3 * plane;
    for (int64_t i = 0; i < plane; i++) {
      dst[i] = src[i * 3 + 2];
      dst[plane + i] = src[i * 3 + 1];
      dst[2 * plane + i] = src[i * 3 + 0];
    }
  }
}

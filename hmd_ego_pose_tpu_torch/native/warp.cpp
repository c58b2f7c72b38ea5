// The host's uint8 affine warp (cv2.warpAffine semantics: inverse mapping),
// for the host input pipeline's 6-DoF augmentation of hmd_ego_pose_tpu_torch.
//
// The two functions are the JAX package's (hmd_ego_pose_tpu/native/frameio.cpp)
// character for character, and data/native_warp.py builds them with the same
// compiler flags, so on one host the two packages' warps compute the same bits.
// inv_m is the INVERSE 2x3 affine (dst -> src), row-major [a b c; d e f].
//
// Build: g++ -O3 -march=native -shared -fPIC warp.cpp -o libwarp.so

#include <cmath>
#include <cstdint>

namespace {

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// border_mode: 0 = constant zero (cv2.warpAffine default), 1 = clamp to
// edge (the convention of the resize path).
void warp_affine_bilinear_u8(const uint8_t* src, int src_h, int src_w,
                             int channels, const double* inv_m,
                             uint8_t* dst, int dst_h, int dst_w,
                             int border_mode) {
  for (int y = 0; y < dst_h; ++y) {
    const double base_x = inv_m[1] * y + inv_m[2];
    const double base_y = inv_m[4] * y + inv_m[5];
    uint8_t* orow = dst + static_cast<int64_t>(y) * dst_w * channels;
    for (int x = 0; x < dst_w; ++x) {
      const double sx = inv_m[0] * x + base_x;
      const double sy = inv_m[3] * x + base_y;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const double fx = sx - x0;
      const double fy = sy - y0;
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0;
        for (int dy = 0; dy < 2; ++dy) {
          int yy = y0 + dy;
          const double wy = dy ? fy : 1.0 - fy;
          if (yy < 0 || yy >= src_h) {
            if (border_mode == 0) continue;
            yy = yy < 0 ? 0 : src_h - 1;
          }
          for (int dx = 0; dx < 2; ++dx) {
            int xx = x0 + dx;
            const double wx = dx ? fx : 1.0 - fx;
            if (xx < 0 || xx >= src_w) {
              if (border_mode == 0) continue;
              xx = xx < 0 ? 0 : src_w - 1;
            }
            acc += wy * wx *
                   src[(static_cast<int64_t>(yy) * src_w + xx) * channels + c];
          }
        }
        // half-to-even rounding to match numpy's np.round exactly
        orow[x * channels + c] =
            clamp_u8(static_cast<int>(std::nearbyint(acc)));
      }
    }
  }
}

void warp_affine_nearest_u8(const uint8_t* src, int src_h, int src_w,
                            int channels, const double* inv_m, uint8_t* dst,
                            int dst_h, int dst_w) {
  for (int y = 0; y < dst_h; ++y) {
    const double base_x = inv_m[1] * y + inv_m[2];
    const double base_y = inv_m[4] * y + inv_m[5];
    uint8_t* orow = dst + static_cast<int64_t>(y) * dst_w * channels;
    for (int x = 0; x < dst_w; ++x) {
      const int sx = static_cast<int>(std::lround(inv_m[0] * x + base_x));
      const int sy = static_cast<int>(std::lround(inv_m[3] * x + base_y));
      if (sx < 0 || sx >= src_w || sy < 0 || sy >= src_h) {
        for (int c = 0; c < channels; ++c) orow[x * channels + c] = 0;
      } else {
        const uint8_t* s =
            src + (static_cast<int64_t>(sy) * src_w + sx) * channels;
        for (int c = 0; c < channels; ++c) orow[x * channels + c] = s[c];
      }
    }
  }
}

}  // extern "C"

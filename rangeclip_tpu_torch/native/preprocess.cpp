// Native host-side preprocessing kernels for the data loader (a copy of
// rangeclip_tpu/native/preprocess.cpp).
//
// The reference's per-sample transform chain (nearest resize + lower-median
// depth normalization + segmentation resize, dataloader.py:23-84) runs in
// Python/torch on loader workers.  These C++ functions implement the same
// math (torch's floor(i*in/out) nearest indexing and lower-median selection
// via nth_element; the normalisation multiplies by 1/median where the numpy
// path divides, one ulp apart at most) behind a C ABI consumed through
// ctypes (rangeclip_tpu_torch/native/__init__.py), which builds this file
// with the system g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Nearest-neighbor resize, torch index semantics: src = floor(i * in/out).
// Operates on float32 [h_in, w_in, c] -> [h_out, w_out, c].
void nearest_resize_f32(const float* src, float* dst, int64_t h_in,
                        int64_t w_in, int64_t c, int64_t h_out,
                        int64_t w_out) {
  std::vector<int64_t> cols(w_out);
  const double sx = static_cast<double>(w_in) / static_cast<double>(w_out);
  const double sy = static_cast<double>(h_in) / static_cast<double>(h_out);
  for (int64_t j = 0; j < w_out; ++j) {
    int64_t v = static_cast<int64_t>(std::floor(j * sx));
    cols[j] = v < w_in ? v : w_in - 1;
  }
  for (int64_t i = 0; i < h_out; ++i) {
    int64_t ri = static_cast<int64_t>(std::floor(i * sy));
    if (ri >= h_in) ri = h_in - 1;
    const float* row = src + ri * w_in * c;
    float* out = dst + i * w_out * c;
    if (c == 1) {  // depth maps: direct gather beats per-pixel memcpy
      for (int64_t j = 0; j < w_out; ++j) out[j] = row[cols[j]];
    } else {
      for (int64_t j = 0; j < w_out; ++j) {
        std::memcpy(out + j * c, row + cols[j] * c, sizeof(float) * c);
      }
    }
  }
}

// Same for int32 label maps.
void nearest_resize_i32(const int32_t* src, int32_t* dst, int64_t h_in,
                        int64_t w_in, int64_t h_out, int64_t w_out) {
  const double sx = static_cast<double>(w_in) / static_cast<double>(w_out);
  const double sy = static_cast<double>(h_in) / static_cast<double>(h_out);
  std::vector<int64_t> cols(w_out);
  for (int64_t j = 0; j < w_out; ++j) {
    int64_t v = static_cast<int64_t>(std::floor(j * sx));
    cols[j] = v < w_in ? v : w_in - 1;
  }
  for (int64_t i = 0; i < h_out; ++i) {
    int64_t ri = static_cast<int64_t>(std::floor(i * sy));
    if (ri >= h_in) ri = h_in - 1;
    const int32_t* row = src + ri * w_in;
    int32_t* out = dst + i * w_out;
    for (int64_t j = 0; j < w_out; ++j) out[j] = row[cols[j]];
  }
}

// Lower median (torch.median semantics: lower middle order statistic).
float lower_median_f32(const float* data, int64_t n) {
  if (n == 0) return 0.0f;
  std::vector<float> buf(data, data + n);
  int64_t k = (n - 1) / 2;
  std::nth_element(buf.begin(), buf.begin() + k, buf.end());
  return buf[k];
}

// In-place divide by the lower median with the reference's zero-guard
// (|median| < 1e-6 -> zeros; dataloader.py:49-54).
void median_normalize_f32(float* data, int64_t n) {
  float m = lower_median_f32(data, n);
  if (std::fabs(m) < 1e-6f) {
    std::memset(data, 0, sizeof(float) * n);
    return;
  }
  const float inv = 1.0f / m;
  for (int64_t i = 0; i < n; ++i) data[i] *= inv;
}

// Fused depth transform: nearest resize then median normalize.
void depth_transform_f32(const float* src, float* dst, int64_t h_in,
                         int64_t w_in, int64_t h_out, int64_t w_out) {
  nearest_resize_f32(src, dst, h_in, w_in, 1, h_out, w_out);
  median_normalize_f32(dst, h_out * w_out);
}

// ABI stamp checked by the Python loader: bump on ANY change to an
// exported function's semantics or signature.  A stale .so that merely
// still HAS every symbol name would otherwise run old code (or segfault
// on a changed argument list) when a rebuild is impossible (no g++).
int64_t preprocess_abi_version() { return 2; }

}  // extern "C"

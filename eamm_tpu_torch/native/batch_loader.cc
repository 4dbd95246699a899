// PNG batch decoder of the PyTorch port (eamm_tpu_torch/data/native.py).
//
// A C interface over libpng: each file decoded to float32 RGB in [0, 1]
// (any bit depth, palette, grey or alpha normalized to 8-bit RGB first),
// bilinearly resized when its size is not the requested one, the files of
// a batch spread over worker threads and written straight into one
// caller-owned [n, h, w, 3] buffer: no Python objects, no GIL.  The same
// decoder as the JAX package's native/batch_loader.cc, kept here so that
// the port builds it from its own sources.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared batch_loader.cc -lpng -lz -lpthread
// (data/native.py does so at first use, into build/native/).

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Decode one PNG into float32 RGB [0,1].  Returns 0 on success.
// On success *out_h/*out_w are set and `pixels` holds h*w*3 floats.
int decode_png_rgb(const char* path, std::vector<float>* pixels, int* out_h,
                   int* out_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return 2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  // Normalize every variant to 8-bit RGB.
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  pixels->resize(size_t(h) * w * 3);
  const float inv = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = pixels->data() + size_t(y) * w * 3;
    for (png_uint_32 x = 0; x < w * 3; ++x) dst[x] = row[x] * inv;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *out_h = int(h);
  *out_w = int(w);
  return 0;
}

// Box-ish bilinear resize float RGB.
void resize_rgb(const float* src, int sh, int sw, float* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, size_t(dh) * dw * 3 * sizeof(float));
    return;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sh / dh - 0.5f;
    int y0 = fy < 0 ? 0 : int(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sw / dw - 0.5f;
      int x0 = fx < 0 ? 0 : int(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int ch = 0; ch < 3; ++ch) {
        float a = src[(y0 * sw + x0) * 3 + ch] * (1 - wx) +
                  src[(y0 * sw + x1) * 3 + ch] * wx;
        float b = src[(y1 * sw + x0) * 3 + ch] * (1 - wx) +
                  src[(y1 * sw + x1) * 3 + ch] * wx;
        dst[(y * dw + x) * 3 + ch] = a * (1 - wy) + b * wy;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode one PNG into out[h*w*3] (float32, RGB, [0,1]), resizing to (h, w).
// Returns 0 on success, nonzero error code otherwise.
int eamm_decode_png(const char* path, float* out, int h, int w) {
  std::vector<float> pixels;
  int sh = 0, sw = 0;
  int rc = decode_png_rgb(path, &pixels, &sh, &sw);
  if (rc) return rc;
  resize_rgb(pixels.data(), sh, sw, out, h, w);
  return 0;
}

// Decode n PNGs in parallel into out[n*h*w*3].
// Returns 0 on success; otherwise 1-based index of the first failing path.
int eamm_decode_batch(const char** paths, int n, float* out, int h, int w,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) break;
      int rc = eamm_decode_png(paths[i], out + size_t(i) * h * w * 3, h, w);
      if (rc) failed.store(i + 1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return failed.load();
}

int eamm_native_version() { return 1; }

}  // extern "C"

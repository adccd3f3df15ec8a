// Native data-loading runtime: threaded JPEG decode + Lanczos resample.
//
// The port's copy of freesplat_tpu/native/dataloader.cpp (the same code;
// built by freesplat_tpu_torch/native/__init__.py into build/native/).
// The reference's host data path (PIL decode + LANCZOS resize per frame in
// dataloader worker processes) becomes the step-time bottleneck once the
// device step is tens of milliseconds; this C++ loader decodes and resizes
// a batch of frames in parallel with a thread pool and writes float32 NHWC
// [0, 1] directly into a caller-provided buffer.
//
// Resampling matches PIL's convolution-based `resize` (Image.LANCZOS):
// separable Lanczos-3 with the filter support scaled by the downscale
// factor (antialiasing), kernels normalized per output pixel.
//
// C ABI (used from Python via ctypes — no pybind11 in this image):
//   fs_load_batch(paths, n, out_h, out_w, out)        -> 0 on success
//   fs_load_depth_batch(paths, n, out_h, out_w, out)  -> 0 on success
//   fs_decode_jpeg_size(path, &w, &h)                 -> 0 on success

#include <cstddef>
#include <cstdio>
#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB8. Returns empty vector on failure.
std::vector<unsigned char> decode_jpeg(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return {};
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  std::vector<unsigned char> out;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return {};
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out.resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return out;
}

// Decode an 8/16-bit grayscale PNG to float (raw sample values).
std::vector<float> decode_png_gray(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return {};
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(f);
    return {};
  }
  png_init_io(png, f);
  png_read_info(png, info);
  const int color = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);
  if (color != PNG_COLOR_TYPE_GRAY || (depth != 8 && depth != 16)) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return {};  // not 8/16-bit grayscale: the batch fails
  }
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  const size_t stride = png_get_rowbytes(png, info);
  std::vector<unsigned char> raw(static_cast<size_t>(*h) * stride);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = raw.data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  std::vector<float> out(static_cast<size_t>(*w) * *h);
  if (depth == 8) {
    for (size_t i = 0; i < out.size(); ++i) out[i] = raw[i];
  } else {  // 16-bit PNG samples are big-endian
    for (size_t i = 0; i < out.size(); ++i)
      out[i] = static_cast<float>((raw[2 * i] << 8) | raw[2 * i + 1]);
  }
  return out;
}

// PIL's BICUBIC filter (a = -0.5, support 2) — the default for
// Image.resize, which the PIL depth path uses.
double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  const double pix = M_PI * x;
  return 3.0 * std::sin(pix) * std::sin(pix / 3.0) / (pix * pix);
}

// Precomputed per-output-pixel kernel (PIL precompute_coeffs equivalent).
struct ResampleKernels {
  int ksize;                 // taps per output pixel
  std::vector<int> bounds;   // (out, 2): start index, actual taps
  std::vector<double> coeffs;  // (out, ksize)
};

ResampleKernels build_kernels(int in_size, int out_size,
                              double (*filter)(double) = lanczos3,
                              double base_support = 3.0) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = base_support * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  ResampleKernels rk;
  rk.ksize = ksize;
  rk.bounds.resize(static_cast<size_t>(out_size) * 2);
  rk.coeffs.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = rk.coeffs.data() + static_cast<size_t>(xx) * ksize;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double wgt = filter((x + xmin - center + 0.5) / filterscale);
      k[x] = wgt;
      ww += wgt;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    rk.bounds[2 * xx] = xmin;
    rk.bounds[2 * xx + 1] = xmax;
  }
  return rk;
}

// Separable resample: RGB8 (sh, sw) -> float32 (dh, dw), values in [0, 1].
void resize_lanczos(const unsigned char* src, int sh, int sw, float* dst,
                    int dh, int dw) {
  const ResampleKernels kx = build_kernels(sw, dw);
  const ResampleKernels ky = build_kernels(sh, dh);
  // Horizontal pass: (sh, dw, 3) doubles.
  std::vector<double> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * sw * 3;
    double* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int xmin = kx.bounds[2 * x];
      const int xmax = kx.bounds[2 * x + 1];
      const double* k = kx.coeffs.data() + static_cast<size_t>(x) * kx.ksize;
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < xmax; ++i) {
        const unsigned char* px = row + static_cast<size_t>(xmin + i) * 3;
        acc[0] += px[0] * k[i];
        acc[1] += px[1] * k[i];
        acc[2] += px[2] * k[i];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // Vertical pass.
  for (int y = 0; y < dh; ++y) {
    const int ymin = ky.bounds[2 * y];
    const int ymax = ky.bounds[2 * y + 1];
    const double* k = ky.coeffs.data() + static_cast<size_t>(y) * ky.ksize;
    float* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      double acc = 0.0;
      for (int i = 0; i < ymax; ++i)
        acc += tmp[static_cast<size_t>(ymin + i) * dw * 3 + x] * k[i];
      // PIL clips + rounds to uint8 between passes for uint8 images; we
      // keep full precision and clamp once (slightly higher fidelity).
      drow[x] = static_cast<float>(std::min(255.0, std::max(0.0, acc)) / 255.0);
    }
  }
}

// Separable single-channel float resample with PIL BICUBIC (no clamp —
// raw depth units).
void resize_bicubic_1ch(const float* src, int sh, int sw, float* dst,
                        int dh, int dw) {
  const ResampleKernels kx = build_kernels(sw, dw, bicubic, 2.0);
  const ResampleKernels ky = build_kernels(sh, dh, bicubic, 2.0);
  std::vector<double> tmp(static_cast<size_t>(sh) * dw);
  for (int y = 0; y < sh; ++y) {
    const float* row = src + static_cast<size_t>(y) * sw;
    double* trow = tmp.data() + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      const int xmin = kx.bounds[2 * x];
      const int xmax = kx.bounds[2 * x + 1];
      const double* k = kx.coeffs.data() + static_cast<size_t>(x) * kx.ksize;
      double acc = 0.0;
      for (int i = 0; i < xmax; ++i) acc += row[xmin + i] * k[i];
      trow[x] = acc;
    }
  }
  for (int y = 0; y < dh; ++y) {
    const int ymin = ky.bounds[2 * y];
    const int ymax = ky.bounds[2 * y + 1];
    const double* k = ky.coeffs.data() + static_cast<size_t>(y) * ky.ksize;
    float* drow = dst + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      double acc = 0.0;
      for (int i = 0; i < ymax; ++i)
        acc += tmp[static_cast<size_t>(ymin + i) * dw + x] * k[i];
      drow[x] = static_cast<float>(acc);
    }
  }
}

}  // namespace

extern "C" {

int fs_decode_jpeg_size(const char* path, int* w, int* h) {
  auto data = decode_jpeg(path, w, h);
  return data.empty() ? 1 : 0;
}

// Decode + resize a batch of JPEGs in parallel.
// out: float32 buffer of shape (n, out_h, out_w, 3), NHWC, [0, 1].
int fs_load_batch(const char** paths, int n, int out_h, int out_w,
                  float* out) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const int n_threads =
      std::max(1u, std::min<unsigned>(std::thread::hardware_concurrency(),
                                      static_cast<unsigned>(n)));
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      auto rgb = decode_jpeg(paths[i], &w, &h);
      if (rgb.empty()) {
        failed.store(1);
        continue;
      }
      resize_lanczos(rgb.data(), h, w,
                     out + static_cast<size_t>(i) * out_h * out_w * 3,
                     out_h, out_w);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

// Decode + resize a batch of grayscale depth PNGs in parallel.
// out: float32 (n, out_h, out_w) in RAW sample units (e.g. millimeters).
int fs_load_depth_batch(const char** paths, int n, int out_h, int out_w,
                        float* out) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const int n_threads =
      std::max(1u, std::min<unsigned>(std::thread::hardware_concurrency(),
                                      static_cast<unsigned>(n)));
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      auto gray = decode_png_gray(paths[i], &w, &h);
      if (gray.empty()) {
        failed.store(1);
        continue;
      }
      resize_bicubic_1ch(gray.data(), h, w,
                         out + static_cast<size_t>(i) * out_h * out_w,
                         out_h, out_w);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

}  // extern "C"

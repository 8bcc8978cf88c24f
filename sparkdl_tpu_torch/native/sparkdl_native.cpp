// sparkdl_tpu_torch native host-IO core: the port's own copy of
// sparkdl_tpu/native/sparkdl_native.cpp (the same code, bit for bit the
// same output).
//
// The reference delegated image decode to PIL (Python path) / java.awt
// (Scala path) per executor.  Host-side decode+resize is what feeds the
// device, and PIL holds the GIL beside the runner's threads.  This library
// fuses JPEG/PNG decode and bilinear resize in one pass per image with:
//   * libjpeg DCT-domain prescaling (decode at 1/2, 1/4, 1/8 scale when the
//     target is much smaller than the source — skips most of the IDCT work;
//     PIL does not do this unless explicitly drafted),
//   * a std::thread pool with no Python GIL involvement,
//   * per-image failure status (undecodable rows surface as nulls upstream,
//     never as job failures — the imageIO drop-to-null contract).
//
// C ABI only; bound from Python via ctypes (sparkdl_tpu_torch/native).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// bilinear resize (RGB8, triangle kernel with area-style support for
// downscale — close to PIL's BILINEAR; parity is tolerance-based, matching
// the reference's own cross-backend resize tests)

void resize_bilinear_rgb(const uint8_t* src, int sh, int sw,
                         uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  std::vector<float> row_acc(static_cast<size_t>(dw) * 3);

  // Separable triangle filter; support widens for downscale (anti-alias),
  // degenerates to classic bilinear for upscale.
  const float support_y = std::max(1.0f, scale_y);
  const float support_x = std::max(1.0f, scale_x);

  // Precompute horizontal taps per output column.
  struct Tap { int start, count; };
  std::vector<Tap> xtaps(dw);
  std::vector<float> xweights;
  std::vector<int> xoff(dw);
  for (int ox = 0; ox < dw; ++ox) {
    const float center = (ox + 0.5f) * scale_x;
    int lo = static_cast<int>(std::floor(center - support_x));
    int hi = static_cast<int>(std::ceil(center + support_x));
    lo = std::max(lo, 0);
    hi = std::min(hi, sw);
    xoff[ox] = static_cast<int>(xweights.size());
    float total = 0.0f;
    for (int sx = lo; sx < hi; ++sx) {
      float d = std::fabs((sx + 0.5f) - center) / support_x;
      float wgt = std::max(0.0f, 1.0f - d);
      xweights.push_back(wgt);
      total += wgt;
    }
    if (total <= 0.0f) {  // degenerate window: nearest
      lo = std::min(std::max(static_cast<int>(center), 0), sw - 1);
      hi = lo + 1;
      xoff[ox] = static_cast<int>(xweights.size());
      xweights.push_back(1.0f);
      total = 1.0f;
    }
    for (size_t k = xoff[ox]; k < xweights.size(); ++k) xweights[k] /= total;
    xtaps[ox] = {lo, hi - lo};
  }

  std::vector<float> ycol;  // vertical weights per output row
  for (int oy = 0; oy < dh; ++oy) {
    const float center = (oy + 0.5f) * scale_y;
    int lo = static_cast<int>(std::floor(center - support_y));
    int hi = static_cast<int>(std::ceil(center + support_y));
    lo = std::max(lo, 0);
    hi = std::min(hi, sh);
    ycol.clear();
    float total = 0.0f;
    for (int sy = lo; sy < hi; ++sy) {
      float d = std::fabs((sy + 0.5f) - center) / support_y;
      float wgt = std::max(0.0f, 1.0f - d);
      ycol.push_back(wgt);
      total += wgt;
    }
    if (total <= 0.0f) {
      lo = std::min(std::max(static_cast<int>(center), 0), sh - 1);
      hi = lo + 1;
      ycol.assign(1, 1.0f);
      total = 1.0f;
    }
    for (float& wgt : ycol) wgt /= total;

    std::fill(row_acc.begin(), row_acc.end(), 0.0f);
    for (int t = 0; t < hi - lo; ++t) {
      const uint8_t* srow = src + static_cast<size_t>(lo + t) * sw * 3;
      const float wy = ycol[t];
      for (int ox = 0; ox < dw; ++ox) {
        const Tap tap = xtaps[ox];
        const float* wx = &xweights[xoff[ox]];
        float r = 0, gch = 0, b = 0;
        const uint8_t* p = srow + static_cast<size_t>(tap.start) * 3;
        for (int k = 0; k < tap.count; ++k, p += 3) {
          r += wx[k] * p[0];
          gch += wx[k] * p[1];
          b += wx[k] * p[2];
        }
        float* acc = &row_acc[static_cast<size_t>(ox) * 3];
        acc[0] += wy * r;
        acc[1] += wy * gch;
        acc[2] += wy * b;
      }
    }
    uint8_t* drow = dst + static_cast<size_t>(oy) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      drow[i] = static_cast<uint8_t>(
          std::min(255.0f, std::max(0.0f, row_acc[i] + 0.5f)));
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg with longjmp error trap + DCT prescale)

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg_resized(const uint8_t* data, size_t size, int out_h,
                         int out_w, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain prescale: decode at the smallest 1/1..1/8 scale that still
  // covers the target, skipping most IDCT + color conversion work.
  const int full_w = cinfo.image_width, full_h = cinfo.image_height;
  int denom = 1;
  while (denom < 8 && (full_w / (denom * 2)) >= out_w &&
         (full_h / (denom * 2)) >= out_h) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width, sh = cinfo.output_height;
  const int ch = cinfo.output_components;
  if (ch != 3) {  // grayscale etc. -> expand below
    if (ch != 1) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
  }
  pixels.resize(static_cast<size_t>(sh) * sw * 3);
  std::vector<uint8_t> line(static_cast<size_t>(sw) * ch);
  for (int y = 0; y < sh; ++y) {
    uint8_t* lp = line.data();
    jpeg_read_scanlines(&cinfo, &lp, 1);
    uint8_t* dst = &pixels[static_cast<size_t>(y) * sw * 3];
    if (ch == 3) {
      std::memcpy(dst, lp, static_cast<size_t>(sw) * 3);
    } else {
      for (int x = 0; x < sw; ++x) {
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = lp[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_bilinear_rgb(pixels.data(), sh, sw, out, out_h, out_w);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng from memory)

struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t off;
};

void png_read_fn(png_structp png, png_bytep dst, png_size_t len) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->off + len > st->size) {
    png_error(png, "eof");
  }
  std::memcpy(dst, st->data + st->off, len);
  st->off += len;
}

bool decode_png_resized(const uint8_t* data, size_t size, int out_h,
                        int out_w, uint8_t* out) {
  if (size < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  std::vector<uint8_t> pixels;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, size, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  const int sw = png_get_image_width(png, info);
  const int sh = png_get_image_height(png, info);
  if (png_get_channels(png, info) != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  pixels.resize(static_cast<size_t>(sh) * sw * 3);
  rows.resize(sh);
  for (int y = 0; y < sh; ++y) {
    rows[y] = &pixels[static_cast<size_t>(y) * sw * 3];
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  resize_bilinear_rgb(pixels.data(), sh, sw, out, out_h, out_w);
  return true;
}

// ---------------------------------------------------------------------------
// threadpool driver

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  const int k = std::min(n_threads, n);
  std::vector<std::thread> threads;
  threads.reserve(k - 1);
  for (int t = 1; t < k; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Decode (JPEG/PNG) + resize a batch of encoded images into a contiguous
// [n, out_h, out_w, 3] RGB8 buffer.  status[i]=1 on success, 0 on failure
// (the row's output pixels are zeroed).  Returns the success count.
int sdl_decode_resize_batch(const uint8_t** inputs, const size_t* sizes,
                            int n, int out_h, int out_w, uint8_t* out,
                            uint8_t* status, int n_threads) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> ok_count{0};
  parallel_for(n, n_threads, [&](int i) {
    uint8_t* dst = out + stride * i;
    const uint8_t* data = inputs[i];
    const size_t size = sizes[i];
    bool ok = false;
    if (size >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
      ok = decode_jpeg_resized(data, size, out_h, out_w, dst);
    } else if (size >= 8 && !png_sig_cmp(data, 0, 8)) {
      ok = decode_png_resized(data, size, out_h, out_w, dst);
    }
    if (!ok) {
      std::memset(dst, 0, stride);
    } else {
      ok_count.fetch_add(1);
    }
    status[i] = ok ? 1 : 0;
  });
  return ok_count.load();
}

// Resize a batch of raw RGB8 images (possibly different sizes) into a
// contiguous [n, out_h, out_w, 3] buffer.
void sdl_resize_batch(const uint8_t** inputs, const int* hs, const int* ws,
                      int n, int out_h, int out_w, uint8_t* out,
                      int n_threads) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  parallel_for(n, n_threads, [&](int i) {
    resize_bilinear_rgb(inputs[i], hs[i], ws[i], out + stride * i, out_h,
                        out_w);
  });
}

int sdl_version() { return 1; }

}  // extern "C"

// fastimage: JPEG decode + bilinear resize for the uncached host input
// pipeline (DirImageStore of iisan_tpu_torch/data/images.py).
//
// The port's own copy of the JAX package's native/fastimage.cc, built by
// iisan_tpu_torch/data/fastimage.py with g++ and -ljpeg into the port's
// build directory at first use, and bound through ctypes (the call
// releases the GIL, so the loader's threads overlap).  The reference
// decodes per sample with PIL inside DataLoader workers; this is libjpeg
// decode straight into a caller-provided uint8 buffer, DCT-domain
// downscaling fused into the decode, a bilinear remainder and an internal
// thread pool for batches.  Host C++ only: no kernel.
//
// C ABI only - no CPython / numpy headers needed:
//   fastimage_decode_resize_batch(datas, lens, n, resize, n_threads, out)
//     datas: n pointers to JPEG byte streams; lens: their lengths;
//     out: n * resize * resize * 3 uint8, RGB HWC per image.
//     Returns the number of successfully decoded images; failed slots are
//     zero-filled (callers treat zeros as the pad image).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jb, 1);
}

void silent_output(j_common_ptr) {}

// Bilinear resample (half-pixel centers, no antialias filter), uint8 RGB.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* o = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        o[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

bool decode_one(const uint8_t* data, size_t len, int resize, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  // Constructed BEFORE setjmp: longjmp skips destructors of objects
  // created after the setjmp point in this frame, which would leak the
  // decode buffer on every corrupt image; an object alive across setjmp
  // is destroyed normally when the function returns.
  std::vector<uint8_t> img;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // libjpeg can DCT-downscale by 1/2, 1/4, 1/8 during decode - pick the
  // largest factor that stays >= the target, then bilinear the remainder.
  // This is the big win over decode-full-then-resize for 1000px photos.
  if (resize > 0) {
    cinfo.scale_num = 1;
    for (unsigned denom = 8; denom >= 2; denom /= 2) {
      if (cinfo.image_width >= static_cast<unsigned>(resize) * denom &&
          cinfo.image_height >= static_cast<unsigned>(resize) * denom) {
        cinfo.scale_denom = denom;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  img.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (w == resize && h == resize) {
    std::memcpy(out, img.data(), img.size());
  } else {
    resize_bilinear(img.data(), w, h, out, resize, resize);
  }
  return true;
}

}  // namespace

extern "C" {

// Returns the count of successfully decoded images.
int fastimage_decode_resize_batch(const uint8_t** datas, const size_t* lens,
                                  int n, int resize, int n_threads,
                                  uint8_t* out) {
  const size_t stride = static_cast<size_t>(resize) * resize * 3;
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + static_cast<size_t>(i) * stride;
      if (datas[i] != nullptr && lens[i] > 0 &&
          decode_one(datas[i], lens[i], resize, dst)) {
        ok.fetch_add(1);
      } else {
        std::memset(dst, 0, stride);
      }
    }
  };
  if (n_threads <= 1 || n <= 1) {
    worker();
  } else {
    const int t = n_threads < n ? n_threads : n;
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (int i = 0; i < t; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return ok.load();
}

int fastimage_abi_version() { return 1; }

}  // extern "C"

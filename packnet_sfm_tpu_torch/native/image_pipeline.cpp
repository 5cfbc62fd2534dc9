// Native image decode for the data loader: threaded JPEG/PNG decode +
// resize + normalize.
//
// The port's own copy of native/image_pipeline.cpp (the JAX package's), the
// same code, built by packnet_sfm_tpu_torch/native/__init__.py into
// build/native/. A persistent in-process thread pool decodes and resizes a
// whole batch directly into one contiguous float32 NHWC buffer, with no
// Python in the decode path; pn_decode_image decodes one file at its own
// resolution for the datasets' readers.
//
// Exposed C ABI (ctypes):
//   pn_load_batch(paths, n, out_h, out_w, out)   -> 0 on success
//   pn_decode_image(path, out_buf, max_bytes, &w, &h) (raw u8 RGB)
//   pn_thread_count()

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- decoding

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// ------------------------------------------------------------------- resize

// Area-averaging downscale + bilinear upscale, normalize u8 -> [0,1] float.
void resize_normalize(const Image& src, int oh, int ow, float* out) {
  const double sy = double(src.h) / oh;
  const double sx = double(src.w) / ow;
  for (int y = 0; y < oh; ++y) {
    const double fy0 = y * sy, fy1 = (y + 1) * sy;
    int y0 = int(fy0), y1 = std::min(int(fy1 + 0.999999), src.h);
    if (sy <= 1.0) {  // upscale: bilinear
      double cy = (y + 0.5) * sy - 0.5;
      int iy = std::max(0, std::min(int(cy), src.h - 2));
      double wy = std::max(0.0, std::min(cy - iy, 1.0));
      for (int x = 0; x < ow; ++x) {
        double cx = (x + 0.5) * sx - 0.5;
        int ix = std::max(0, std::min(int(cx), src.w - 2));
        double wx = std::max(0.0, std::min(cx - ix, 1.0));
        for (int c = 0; c < 3; ++c) {
          double v00 = src.rgb[(size_t(iy) * src.w + ix) * 3 + c];
          double v01 = src.rgb[(size_t(iy) * src.w + ix + 1) * 3 + c];
          double v10 = src.rgb[(size_t(iy + 1) * src.w + ix) * 3 + c];
          double v11 = src.rgb[(size_t(iy + 1) * src.w + ix + 1) * 3 + c];
          double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                     v10 * wy * (1 - wx) + v11 * wy * wx;
          out[(size_t(y) * ow + x) * 3 + c] = float(v / 255.0);
        }
      }
      continue;
    }
    for (int x = 0; x < ow; ++x) {
      const double fx0 = x * sx, fx1 = (x + 1) * sx;
      int x0 = int(fx0), x1 = std::min(int(fx1 + 0.999999), src.w);
      double acc[3] = {0, 0, 0};
      int cnt = 0;
      for (int yy = y0; yy < y1; ++yy)
        for (int xx = x0; xx < x1; ++xx) {
          const uint8_t* p = &src.rgb[(size_t(yy) * src.w + xx) * 3];
          acc[0] += p[0];
          acc[1] += p[1];
          acc[2] += p[2];
          ++cnt;
        }
      for (int c = 0; c < 3; ++c)
        out[(size_t(y) * ow + x) * 3 + c] =
            cnt ? float(acc[c] / cnt / 255.0) : 0.f;
    }
  }
}

// -------------------------------------------------------------- thread pool

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }
  int size() const { return int(workers_.size()); }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

ThreadPool& pool() {
  static ThreadPool p(std::max(2u, std::thread::hardware_concurrency()));
  return p;
}

}  // namespace

extern "C" {

int pn_thread_count() { return pool().size(); }

// Decode one image to u8 RGB. Returns 0 ok, -1 failure, -2 buffer too small.
int pn_decode_image(const char* path, uint8_t* out, int64_t max_bytes,
                    int* out_w, int* out_h) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  int64_t need = int64_t(img.w) * img.h * 3;
  *out_w = img.w;
  *out_h = img.h;
  if (need > max_bytes) return -2;
  std::memcpy(out, img.rgb.data(), size_t(need));
  return 0;
}

// Decode+resize+normalize a batch of n images into out [n, oh, ow, 3] f32.
// paths: array of n C strings. Returns number of failures (0 = all good).
int pn_load_batch(const char** paths, int n, int oh, int ow, float* out) {
  std::atomic<int> failures{0};
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    pool().submit([&, i] {
      Image img;
      if (decode_file(paths[i], &img)) {
        resize_normalize(img, oh, ow, out + size_t(i) * oh * ow * 3);
      } else {
        std::memset(out + size_t(i) * oh * ow * 3, 0,
                    size_t(oh) * ow * 3 * sizeof(float));
        failures.fetch_add(1);
      }
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return failures.load();
}

}  // extern "C"

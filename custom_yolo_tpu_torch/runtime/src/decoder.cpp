// Native data-loader core: threaded JPEG decode + bilinear resize (the
// port's own copy of custom_yolo_tpu/runtime/src/decoder.cpp).
//
// A C++ thread pool decodes straight into the caller's batch buffer with
// no per-image python objects, no IPC and no extra copies. Exposed as a C
// ABI consumed via ctypes (custom_yolo_tpu_torch/runtime/__init__.py).
//
// Build: g++ -O3 -shared -fPIC decoder.cpp -o libyolo_runtime.so -ljpeg

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------- errors
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// ---------------------------------------------------------------- decode
// Decode a JPEG file to RGB. Returns true on success; fills w/h and pixel
// vector (h*w*3). The whole file is slurped into memory first (jpeg_mem_src
// avoids per-scanline stdio locking) and scanlines are pulled in batches.
//
// Serving-path speed knobs (both exact-output-preserving OFF by default;
// the training loader keeps the slow/exact path):
//  * fast_dct  — JDCT_IFAST: ~25% cheaper IDCT, ±1 LSB pixel error.
//  * target_w/target_h — enables libjpeg DCT-domain scaling: pick the
//    smallest output scale M/8 (M=1..8) that still covers the resize
//    target, so a 1280² source headed for 640² is inverse-transformed at
//    half resolution (~4× less IDCT + scanline + resize work; entropy
//    decode is unchanged). The subsequent triangle resize runs from the
//    scaled dims; never upscales the DCT (M capped at 8 = identity), so
//    sources already at/below target are unaffected. NOTE: the block-IDCT
//    downsample is a different resampling than triangle-filtering the full
//    decode — outputs are visually equivalent, not pixel-exact.
// width/height return the DECODED (possibly DCT-scaled) dims the pixel
// buffer actually holds; orig_width/orig_height the source's true dims
// (what box rescaling needs).
bool decode_jpeg_file(const char* path, std::vector<unsigned char>& pixels,
                      int* width, int* height, int* orig_width,
                      int* orig_height, bool fast_dct = false,
                      int target_w = 0, int target_h = 0) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  fseek(fp, 0, SEEK_END);
  const long fsize = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  if (fsize <= 0) { fclose(fp); return false; }
  thread_local std::vector<unsigned char> filebuf;
  filebuf.resize(static_cast<size_t>(fsize));
  const bool read_ok =
      fread(filebuf.data(), 1, static_cast<size_t>(fsize), fp) ==
      static_cast<size_t>(fsize);
  fclose(fp);
  if (!read_ok) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, filebuf.data(), static_cast<unsigned long>(fsize));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  *orig_width = cinfo.image_width;
  *orig_height = cinfo.image_height;
  if (fast_dct) cinfo.dct_method = JDCT_IFAST;
  if (target_w > 0 && target_h > 0) {
    // smallest M/8 whose output still covers the resize target on BOTH
    // axes (keeps the downstream triangle filter strictly downscaling or
    // identity — the target resolution's content is retained)
    int m = 8;
    while (m > 1 &&
           (static_cast<long>(cinfo.image_width) * (m - 1) + 7) / 8 >=
               target_w &&
           (static_cast<long>(cinfo.image_height) * (m - 1) + 7) / 8 >=
               target_h) {
      --m;
    }
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int stride = w * 3;
  pixels.resize(static_cast<size_t>(h) * stride);
  JSAMPROW rows[16];
  while (cinfo.output_scanline < cinfo.output_height) {
    const int base = cinfo.output_scanline;
    const int want = std::min(16, h - base);
    for (int i = 0; i < want; ++i) {
      rows[i] = pixels.data() + static_cast<size_t>(base + i) * stride;
    }
    jpeg_read_scanlines(&cinfo, rows, want);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *width = w;
  *height = h;
  return true;
}

// ---------------------------------------------------------------- resize
// Separable antialiased bilinear (triangle-filter) resize, matching the
// PIL/torchvision-v2 convention (antialias=true): on downscale the filter
// support widens by the scale ratio so results agree with the reference's
// torchvision Resize (src/data/transforms.py:9), not a plain 2x2 bilinear.

struct ResampleCoeffs {
  std::vector<int> bounds;       // 2 per out pixel: (first, count)
  std::vector<float> weights;    // ksize per out pixel
  int ksize;
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  rc.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.bounds.resize(out_size * 2);
  rc.weights.assign(static_cast<size_t>(out_size) * rc.ksize, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    float* w = rc.weights.data() + static_cast<size_t>(xx) * rc.ksize;
    for (int x = xmin; x < xmax; ++x) {
      double t = (x - center + 0.5) / filterscale;
      if (t < 0) t = -t;
      const double v = t < 1.0 ? 1.0 - t : 0.0;
      w[x - xmin] = static_cast<float>(v);
      total += v;
    }
    if (total > 0) {
      for (int i = 0; i < xmax - xmin; ++i) w[i] /= static_cast<float>(total);
    }
    rc.bounds[xx * 2] = xmin;
    rc.bounds[xx * 2 + 1] = xmax - xmin;
  }
  return rc;
}

void bilinear_resize(const unsigned char* src, int sw, int sh,
                     unsigned char* dst, int dw, int dh) {
  const ResampleCoeffs cx = triangle_coeffs(sw, dw);
  const ResampleCoeffs cy = triangle_coeffs(sh, dh);
  const int dstride = dw * 3;

  // horizontal pass: (sh, sw) u8 → (sh, dw) float. Inner loops specialized
  // on tap count (upscale/identity is 1–2 taps) so the compiler emits
  // straight-line FMA code instead of a variable-trip-count gather loop.
  thread_local std::vector<float> tmp;
  tmp.resize(static_cast<size_t>(sh) * dstride);
  for (int y = 0; y < sh; ++y) {
    const unsigned char* __restrict__ row =
        src + static_cast<size_t>(y) * sw * 3;
    float* __restrict__ out = tmp.data() + static_cast<size_t>(y) * dstride;
    for (int x = 0; x < dw; ++x) {
      const int first = cx.bounds[x * 2];
      const int count = cx.bounds[x * 2 + 1];
      const float* __restrict__ w =
          cx.weights.data() + static_cast<size_t>(x) * cx.ksize;
      const unsigned char* __restrict__ p = row + first * 3;
      float acc0, acc1, acc2;
      if (count == 1) {
        acc0 = p[0] * w[0];
        acc1 = p[1] * w[0];
        acc2 = p[2] * w[0];
      } else if (count == 2) {
        acc0 = p[0] * w[0] + p[3] * w[1];
        acc1 = p[1] * w[0] + p[4] * w[1];
        acc2 = p[2] * w[0] + p[5] * w[1];
      } else {
        acc0 = acc1 = acc2 = 0.0f;
        for (int i = 0; i < count; ++i) {
          acc0 += p[i * 3] * w[i];
          acc1 += p[i * 3 + 1] * w[i];
          acc2 += p[i * 3 + 2] * w[i];
        }
      }
      out[x * 3] = acc0;
      out[x * 3 + 1] = acc1;
      out[x * 3 + 2] = acc2;
    }
  }

  // vertical pass: (sh, dw) float → (dh, dw) u8, tap-outer so each tap is a
  // contiguous axpy over the row (auto-vectorizes to the host SIMD width).
  thread_local std::vector<float> acc;
  acc.resize(dstride);
  for (int y = 0; y < dh; ++y) {
    const int first = cy.bounds[y * 2];
    const int count = cy.bounds[y * 2 + 1];
    const float* __restrict__ w =
        cy.weights.data() + static_cast<size_t>(y) * cy.ksize;
    float* __restrict__ a = acc.data();
    {
      const float* __restrict__ r =
          tmp.data() + static_cast<size_t>(first) * dstride;
      const float w0 = w[0];
      for (int x = 0; x < dstride; ++x) a[x] = r[x] * w0;
    }
    for (int i = 1; i < count; ++i) {
      const float* __restrict__ r =
          tmp.data() + static_cast<size_t>(first + i) * dstride;
      const float wi = w[i];
      for (int x = 0; x < dstride; ++x) a[x] += r[x] * wi;
    }
    unsigned char* __restrict__ out = dst + static_cast<size_t>(y) * dstride;
    for (int x = 0; x < dstride; ++x) {
      const int v = static_cast<int>(a[x] + 0.5f);
      out[x] = static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// ---------------------------------------------------------------- pool
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

void* yt_pool_create(int num_threads) {
  return new ThreadPool(num_threads > 0 ? num_threads : 1);
}

void yt_pool_destroy(void* pool) {
  delete static_cast<ThreadPool*>(pool);
}

// Decode n JPEGs, resize each to (out_h, out_w), write into out
// (n*out_h*out_w*3, contiguous). orig_sizes receives n*(w,h) pairs — always
// the SOURCE dims (box rescale coordinates), regardless of DCT scaling.
// Returns the number of failed images (their slots are zeroed).
// fast != 0 enables the serving path: JDCT_IFAST + DCT-domain prescale to
// the resize target (exactness-preserving scale selection — see
// decode_jpeg_file); fast == 0 is the bit-exact training path.
int yt_decode_resize_batch(void* pool_ptr, const char** paths, int n,
                           int out_h, int out_w, unsigned char* out,
                           int* orig_sizes, int fast) {
  auto* pool = static_cast<ThreadPool*>(pool_ptr);
  std::atomic<int> failures{0};
  std::atomic<int> done{0};
  std::mutex done_mu;
  std::condition_variable done_cv;
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;

  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      thread_local std::vector<unsigned char> pixels;
      int w = 0, h = 0, ow = 0, oh = 0;
      unsigned char* dst = out + static_cast<size_t>(i) * img_bytes;
      if (decode_jpeg_file(paths[i], pixels, &w, &h, &ow, &oh,
                           /*fast_dct=*/fast != 0,
                           /*target_w=*/fast ? out_w : 0,
                           /*target_h=*/fast ? out_h : 0)) {
        bilinear_resize(pixels.data(), w, h, dst, out_w, out_h);
        orig_sizes[i * 2] = ow;
        orig_sizes[i * 2 + 1] = oh;
      } else {
        memset(dst, 0, img_bytes);
        orig_sizes[i * 2] = 0;
        orig_sizes[i * 2 + 1] = 0;
        failures.fetch_add(1);
      }
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lock(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lock(done_mu);
  done_cv.wait(lock, [&] { return done.load() == n; });
  return failures.load();
}

}  // extern "C"

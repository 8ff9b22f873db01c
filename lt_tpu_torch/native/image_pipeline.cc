// Native host-side image pipeline of the lt_tpu_torch data layer (its own
// copy of lt_tpu's; the same C API).
//
// The reference feeds the GPU through torch DataLoader worker *processes*
// running cv2/PIL/numpy per sample (mvn/datasets/human36m.py:116-189).  This
// library replaces that per-sample Python work with one fused C++ pass per
// view — JPEG decode (libjpeg) -> zero-padded crop -> area resize ->
// ImageNet normalize -> float32 HWC — executed by an in-process thread pool
// so a single Python process can keep host cores busy while the GPU
// computes.
//
// Exposed as a plain C API consumed via ctypes
// (lt_tpu_torch/native/__init__.py).  A file libjpeg cannot decode (not a
// JPEG, truncated, missing) fails that one image: libjpeg's errors return
// through setjmp instead of its default handler, which ends the process.
//
// Conventions matched to the reference pipeline:
//   - channel order BGR (cv2.imread convention, human36m.py:143);
//   - crop semantics: PIL-style zero padding outside the source image
//     (mvn/utils/img.py:10-24);
//   - resize: pixel-area averaging (cv2 INTER_AREA, img.py:27-28) for
//     downscale, bilinear for upscale;
//   - normalization: (x/255 - mean) / std with ImageNet stats (img.py:7).

#include <cstdio>  // must precede jpeglib.h (it uses FILE*)

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

const float kMean[3] = {0.485f, 0.456f, 0.406f};  // RGB order
const float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Image {
  std::vector<uint8_t> data;  // HWC, BGR
  int h = 0, w = 0;
};

// libjpeg's error handler: back to DecodeJpegFile's setjmp, silently.
struct JpegError {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void JpegErrorExit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1);
}

void JpegSilent(j_common_ptr) {}

bool DecodeJpegFile(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  jerr.mgr.output_message = JpegSilent;
  // Nothing with a destructor lives between here and the last libjpeg
  // call: the row buffer is libjpeg's own, freed by jpeg_destroy.
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->data.resize(size_t(out->h) * out->w * 3);

  JSAMPARRAY row = (*cinfo.mem->alloc_sarray)(
      reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE,
      JDIMENSION(out->w) * 3, 1);
  for (int y = 0; y < out->h; ++y) {
    jpeg_read_scanlines(&cinfo, row, 1);
    const uint8_t* src = row[0];
    uint8_t* dst = out->data.data() + size_t(y) * out->w * 3;
    // RGB -> BGR to match cv2.imread.
    for (int x = 0; x < out->w; ++x) {
      dst[x * 3 + 0] = src[x * 3 + 2];
      dst[x * 3 + 1] = src[x * 3 + 1];
      dst[x * 3 + 2] = src[x * 3 + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Fused zero-pad crop + area/bilinear resize + normalize.
//
// The crop (left, upper, right, lower) may extend past the source; those
// regions read as zeros.  Output is float32 HWC (out_h, out_w, 3), BGR, with
// per-channel ImageNet normalization applied to the *RGB* stats the way the
// reference does (it normalizes a BGR array with an RGB-ordered mean/std —
// img.py:102-110 applied to a cv2 image — so we replicate that exactly:
// channel c uses kMean[c]/kStd[c] on the BGR layout).
void CropResizeNormalize(const Image& img, int left, int upper, int right,
                         int lower, int out_h, int out_w, bool normalize,
                         float* out) {
  const int crop_h = lower - upper;
  const int crop_w = right - left;
  if (crop_h <= 0 || crop_w <= 0 || out_h <= 0 || out_w <= 0) return;

  const float sy = float(crop_h) / out_h;
  const float sx = float(crop_w) / out_w;
  const bool down_y = sy > 1.0f, down_x = sx > 1.0f;

  for (int oy = 0; oy < out_h; ++oy) {
    for (int ox = 0; ox < out_w; ++ox) {
      float acc[3] = {0.f, 0.f, 0.f};
      if (down_y || down_x) {
        // Pixel-area average over the source footprint (INTER_AREA).
        const float y0 = oy * sy, y1 = (oy + 1) * sy;
        const float x0 = ox * sx, x1 = (ox + 1) * sx;
        float total = 0.f;
        for (int yy = int(y0); yy < int(y1 + 0.9999f); ++yy) {
          const float wy = std::min(y1, float(yy + 1)) - std::max(y0, float(yy));
          if (wy <= 0) continue;
          for (int xx = int(x0); xx < int(x1 + 0.9999f); ++xx) {
            const float wx =
                std::min(x1, float(xx + 1)) - std::max(x0, float(xx));
            if (wx <= 0) continue;
            const float wgt = wx * wy;
            total += wgt;
            const int syy = yy + upper, sxx = xx + left;
            if (syy >= 0 && syy < img.h && sxx >= 0 && sxx < img.w) {
              const uint8_t* p =
                  img.data.data() + (size_t(syy) * img.w + sxx) * 3;
              acc[0] += wgt * p[0];
              acc[1] += wgt * p[1];
              acc[2] += wgt * p[2];
            }
          }
        }
        if (total > 0) {
          acc[0] /= total;
          acc[1] /= total;
          acc[2] /= total;
        }
      } else {
        // Bilinear for upscale.
        const float fy = (oy + 0.5f) * sy - 0.5f;
        const float fx = (ox + 0.5f) * sx - 0.5f;
        const int iy = int(std::floor(fy)), ix = int(std::floor(fx));
        const float dy = fy - iy, dx = fx - ix;
        for (int c = 0; c < 3; ++c) acc[c] = 0.f;
        const float wgts[4] = {(1 - dy) * (1 - dx), (1 - dy) * dx,
                               dy * (1 - dx), dy * dx};
        const int offs[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
        for (int k = 0; k < 4; ++k) {
          const int syy = iy + offs[k][0] + upper;
          const int sxx = ix + offs[k][1] + left;
          if (syy >= 0 && syy < img.h && sxx >= 0 && sxx < img.w) {
            const uint8_t* p =
                img.data.data() + (size_t(syy) * img.w + sxx) * 3;
            for (int c = 0; c < 3; ++c) acc[c] += wgts[k] * p[c];
          }
        }
      }
      float* dst = out + (size_t(oy) * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        dst[c] = normalize ? ((acc[c] / 255.0f) - kMean[c]) / kStd[c]
                           : acc[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Thread pool + batch loader
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), outstanding_(0) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Run(); });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      tasks_.push(std::move(fn));
      ++outstanding_;
    }
    cv_.notify_one();
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return outstanding_ == 0; });
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = std::move(tasks_.front());
        tasks_.pop();
      }
      task();
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--outstanding_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::queue<std::function<void()>> tasks_;
  std::vector<std::thread> workers_;
  bool stop_;
  int outstanding_;
};

}  // namespace

extern "C" {

typedef struct LtLoader LtLoader;
struct LtLoader {
  ThreadPool* pool;
};

LtLoader* lt_loader_create(int n_threads) {
  auto* l = new LtLoader;
  l->pool = new ThreadPool(n_threads > 0 ? n_threads
                                         : std::thread::hardware_concurrency());
  return l;
}

void lt_loader_destroy(LtLoader* l) {
  delete l->pool;
  delete l;
}

// Decode a JPEG into caller-provided buffer; returns 0 on success and fills
// (*h, *w). If buf is null, only probes the dimensions.
int lt_decode_jpeg(const char* path, uint8_t* buf, int buf_size, int* h,
                   int* w) {
  Image img;
  if (!DecodeJpegFile(path, &img)) return 1;
  *h = img.h;
  *w = img.w;
  if (buf != nullptr) {
    if (int(img.data.size()) > buf_size) return 2;
    std::memcpy(buf, img.data.data(), img.data.size());
  }
  return 0;
}

// Fused single-sample pipeline from an in-memory uint8 BGR image.
void lt_process_image(const uint8_t* data, int h, int w, int left, int upper,
                      int right, int lower, int out_h, int out_w,
                      int normalize, float* out) {
  Image img;
  img.h = h;
  img.w = w;
  img.data.assign(data, data + size_t(h) * w * 3);
  CropResizeNormalize(img, left, upper, right, lower, out_h, out_w,
                      normalize != 0, out);
}

// Batched: decode n JPEG files and run the fused pipeline for each, in
// parallel on the loader's thread pool. bboxes are (n, 4) LTRB int32.
// Output is (n, out_h, out_w, 3) float32. ok[i] = 1 on success.
void lt_load_batch(LtLoader* l, const char** paths, const int32_t* bboxes,
                   int n, int out_h, int out_w, int normalize, float* out,
                   int32_t* ok) {
  for (int i = 0; i < n; ++i) {
    l->pool->Submit([=] {
      Image img;
      if (!DecodeJpegFile(paths[i], &img)) {
        ok[i] = 0;
        return;
      }
      const int32_t* b = bboxes + i * 4;
      CropResizeNormalize(img, b[0], b[1], b[2], b[3], out_h, out_w,
                          normalize != 0,
                          out + size_t(i) * out_h * out_w * 3);
      ok[i] = 1;
    });
  }
  l->pool->Wait();
}

}  // extern "C"

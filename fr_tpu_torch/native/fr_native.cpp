// Native (C++) host library of the port: verification scoring, a u8 row
// gather and a threaded JPEG decode pool.
//
// A copy of fr_tpu/native/fr_native.cpp, byte for byte below this header,
// so the port's scores, gathers and decodes are fr_tpu's bits. It replaces
// the reference's numba @njit(parallel=True) scoring kernels (reference
// utils/eval.py:68-137) with an AOT-compiled shared library, loaded via
// ctypes (fr_tpu_torch/native/__init__.py). Exact semantics:
//   score    = 1 − ‖e1 − e2‖²/4, diffs in input precision, accumulation in
//              double (numba math.pow promotes to double)
//   hist_idx = (long)((1e5 − 1) · score) into 100001-bin histograms
//
// Threaded with std::thread over pair ranges; per-thread histograms merged
// at the end (the reference's numba prange parallelised the inner loop).
// This is host code: nothing here runs on the GPU.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef FR_HAVE_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif

namespace {
constexpr long kBins = 100001;
constexpr double kScale = 1e5 - 1.0;

inline long bin_of(double score) {
  long idx = static_cast<long>(kScale * score);
  if (idx < 0) idx = 0;
  if (idx >= kBins) idx = kBins - 1;
  return idx;
}

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}
}  // namespace

extern "C" {

// Pairwise scoring (reference utils/eval.py:68-99).
//   e1, e2 : (n, d) float32, row-major
//   labels : (n,) uint8 (0 = imposter, 1 = genuine)
//   hist_genuine, hist_imposter : (100001,) double, zero-initialised
//   scores : (n,) double
void pair_score_f32(const float* e1, const float* e2, const uint8_t* labels,
                    int64_t n, int64_t d, double* hist_genuine,
                    double* hist_imposter, double* scores) {
  int nthreads = hardware_threads();
  std::vector<std::vector<double>> hg(nthreads,
                                      std::vector<double>(kBins, 0.0));
  std::vector<std::vector<double>> hi(nthreads,
                                      std::vector<double>(kBins, 0.0));
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  const int64_t chunk = 1024;

  auto work = [&](int tid) {
    for (;;) {
      int64_t start = next.fetch_add(chunk);
      if (start >= n) return;
      int64_t end = std::min(start + chunk, n);
      for (int64_t i = start; i < end; ++i) {
        double sum = 0.0;
        const float* a = e1 + i * d;
        const float* b = e2 + i * d;
        for (int64_t k = 0; k < d; ++k) {
          // diff in f32 (input precision), square/accumulate in f64 —
          // matching numba's math.pow promotion semantics.
          float df = a[k] - b[k];
          sum += static_cast<double>(df) * static_cast<double>(df);
        }
        double score = 1.0 - sum / 4.0;
        scores[i] = score;
        (labels[i] ? hg : hi)[tid][bin_of(score)] += 1.0;
      }
    }
  };
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  for (int t = 0; t < nthreads; ++t)
    for (long b = 0; b < kBins; ++b) {
      hist_genuine[b] += hg[t][b];
      hist_imposter[b] += hi[t][b];
    }
}

// All-pairs cross scoring (reference utils/eval.py:102-137).
//   emb    : (n, d) float32
//   labels : (n,) int64
//   scores, pair_labels : (n(n-1)/2,) double in reference order
//   (i outer from 0..n-1, j inner from 0..i-1).
void cross_score_f32(const float* emb, const int64_t* labels, int64_t n,
                     int64_t d, double* hist_genuine, double* hist_imposter,
                     double* scores, double* pair_labels) {
  int nthreads = hardware_threads();
  std::vector<std::vector<double>> hg(nthreads,
                                      std::vector<double>(kBins, 0.0));
  std::vector<std::vector<double>> hi(nthreads,
                                      std::vector<double>(kBins, 0.0));
  std::vector<std::thread> threads;
  std::atomic<int64_t> next_i(0);

  auto work = [&](int tid) {
    for (;;) {
      int64_t i = next_i.fetch_add(1);
      if (i >= n) return;
      int64_t base = i * (i - 1) / 2;  // flat index of (i, j=0)
      const float* a = emb + i * d;
      for (int64_t j = 0; j < i; ++j) {
        const float* b = emb + j * d;
        double sum = 0.0;
        for (int64_t k = 0; k < d; ++k) {
          float df = b[k] - a[k];
          sum += static_cast<double>(df) * static_cast<double>(df);
        }
        double score = 1.0 - sum / 4.0;
        int64_t l = base + j;
        scores[l] = score;
        bool genuine = labels[i] == labels[j];
        pair_labels[l] = genuine ? 1.0 : 0.0;
        (genuine ? hg : hi)[tid][bin_of(score)] += 1.0;
      }
    }
  };
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  for (int t = 0; t < nthreads; ++t)
    for (long b = 0; b < kBins; ++b) {
      hist_genuine[b] += hg[t][b];
      hist_imposter[b] += hi[t][b];
    }
}

// uint8 HWC batch gather + crop-resize-free normalisation helper used by the
// host loader: out[i] = images[index[i]] (memcpy fan-out, threaded).
void gather_u8(const uint8_t* images, const int64_t* index, int64_t n_out,
               int64_t item_bytes, uint8_t* out) {
  int nthreads = hardware_threads();
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(64);
      if (i >= n_out) return;
      int64_t end = std::min(i + 64, n_out);
      for (; i < end; ++i)
        std::memcpy(out + i * item_bytes, images + index[i] * item_bytes,
                    item_bytes);
    }
  };
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// Threaded JPEG decode + bilinear resize pool (the host input pipeline's
// hot path; replaces the reference's cv2/albumentations decode inside torch
// DataLoader workers, reference utils/data_partial.py:134-164). Python hands
// one batch of raw JPEG bytes (concatenated blob + offsets); each image is
// decoded with libjpeg and bilinear-resized (half-pixel centers, the
// cv2.INTER_LINEAR convention) to out_size×out_size RGB uint8.
// ---------------------------------------------------------------------------

#ifdef FR_HAVE_JPEG
namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

// decode one JPEG to RGB; returns {w, h} into a caller buffer resized by it
bool decode_one(const uint8_t* data, int64_t size, std::vector<uint8_t>& px,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // OpenCV-style speed settings: fast integer DCT + plain upsampling
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  px.resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(cinfo.output_scanline)
                   * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// bilinear resize uint8 RGB, half-pixel centers (cv2.INTER_LINEAR sampling)
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= sh) { y1 = sh - 1; if (y0 > y1) { y0 = y1; } }
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= sw) { x1 = sw - 1; if (x0 > x1) { x0 = x1; } }
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* o = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        o[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace
#endif  // FR_HAVE_JPEG

int has_jpeg() {
#ifdef FR_HAVE_JPEG
  return 1;
#else
  return 0;
#endif
}

// Decode n JPEGs (blob + n+1 offsets) to (n, out_size, out_size, 3) uint8
// RGB. Returns the number decoded successfully; out rows of failed images
// are zeroed and their ok flag is 0.
int64_t decode_jpegs_rgb(const uint8_t* blob, const int64_t* offsets,
                         int64_t n, int64_t out_size, uint8_t* out,
                         uint8_t* ok) {
#ifndef FR_HAVE_JPEG
  (void)blob; (void)offsets; (void)out_size; (void)out;
  for (int64_t i = 0; i < n; ++i) ok[i] = 0;
  return 0;
#else
  const int64_t item = out_size * out_size * 3;
  int nthreads = std::min<int64_t>(hardware_threads(), n);
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> n_ok(0);
  auto work = [&]() {
    std::vector<uint8_t> px;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      bool good = decode_one(blob + offsets[i], offsets[i + 1] - offsets[i],
                             px, &w, &h);
      if (!good || w <= 0 || h <= 0) {
        std::memset(out + i * item, 0, item);
        ok[i] = 0;
        continue;
      }
      resize_bilinear(px.data(), w, h, out + i * item,
                      static_cast<int>(out_size), static_cast<int>(out_size));
      ok[i] = 1;
      n_ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return n_ok.load();
#endif
}

}  // extern "C"

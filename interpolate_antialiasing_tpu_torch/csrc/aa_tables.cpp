// Native weight-table builder: the PIL ImagingResample window algorithm in
// C++ (double precision), exported with C linkage for ctypes.
//
// The port's own copy of the JAX package's csrc/aa_tables.cpp, unchanged
// below this comment.  The numpy implementation in ops/weights.py is the
// specification; this library builds the same (xmin, size, weights) tables
// on the host in one O(out * ntaps) loop, and tests/test_torch_port_tooling.py
// holds it to ops/weights.py and to the JAX package's build of the same
// source.
//
// Build: c++ -O3 -shared -fPIC aa_tables.cpp -o libaa_tables.so, done at
// first use by native.py (compute_tables_native) with the host compiler,
// not nvcc.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

enum FilterId : int32_t {
  kBilinear = 0,
  kBox = 1,
  kBicubic = 2,
  kLanczos3 = 3,
  kBicubic075 = 4,  // classic (non-AA) torch/OpenCV convention
  kHamming = 5,
};

enum BorderId : int32_t {
  kRenorm = 0,     // PIL/antialias: clip window, renormalise
  kReplicate = 1,  // classic: clamp tap indices onto the edge pixel
};

inline double triangle(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

inline double box(double x) {
  return (x > -0.5 && x <= 0.5) ? 1.0 : 0.0;
}

inline double keys_cubic_a(double x, double a) {
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline double keys_cubic(double x) { return keys_cubic_a(x, -0.5); }

inline double sinc(double x) {
  if (x == 0.0) return 1.0;
  const double pix = M_PI * x;
  return std::sin(pix) / pix;
}

inline double hamming(double x) {
  // Pillow writes the window constants as float literals (0.54f/0.46f);
  // exact doubles flip fixed-point coefficients by one ULP.
  x = std::fabs(x);
  if (x >= 1.0) return 0.0;
  if (x == 0.0) return 1.0;
  const double pix = M_PI * x;
  return std::sin(pix) / pix * (double(0.54f) + double(0.46f) * std::cos(pix));
}

inline double lanczos3(double x) {
  return std::fabs(x) < 3.0 ? sinc(x) * sinc(x / 3.0) : 0.0;
}

inline double eval(int32_t f, double x) {
  switch (f) {
    case kBilinear: return triangle(x);
    case kBox: return box(x);
    case kBicubic: return keys_cubic(x);
    case kBicubic075: return keys_cubic_a(x, -0.75);
    case kHamming: return hamming(x);
    default: return lanczos3(x);
  }
}

inline double filter_support(int32_t f) {
  switch (f) {
    case kBilinear: return 1.0;
    case kBox: return 0.5;
    case kBicubic: return 2.0;
    case kBicubic075: return 2.0;
    case kHamming: return 1.0;
    default: return 3.0;
  }
}

}  // namespace

extern "C" {

// Returns ntaps; fills xmin[out], size[out], weights[out*ntaps].
// ntaps must be queried first via aa_ntaps() so callers can allocate.
int32_t aa_ntaps(int64_t in_size, int64_t out_size, int32_t filter,
                 int32_t antialias, int32_t align_corners) {
  double scale;
  if (align_corners) {
    scale = out_size > 1 ? double(in_size - 1) / double(out_size - 1) : 0.0;
  } else {
    scale = out_size > 0 ? double(in_size) / double(out_size) : 0.0;
  }
  double support = filter_support(filter);
  if (antialias && scale >= 1.0) support *= scale;
  return int32_t(std::ceil(support)) * 2 + 1;
}

void aa_compute_tables_v2(int64_t in_size, int64_t out_size, int32_t filter,
                          int32_t antialias, int32_t align_corners,
                          int32_t border,
                          int32_t* xmin_out, int32_t* size_out,
                          double* weights_out) {
  double scale;
  if (align_corners) {
    scale = out_size > 1 ? double(in_size - 1) / double(out_size - 1) : 0.0;
  } else {
    scale = out_size > 0 ? double(in_size) / double(out_size) : 0.0;
  }
  double support = filter_support(filter);
  double invscale = 1.0;
  if (antialias && scale >= 1.0) {
    support *= scale;
    invscale = 1.0 / scale;
  }
  const int32_t ntaps = int32_t(std::ceil(support)) * 2 + 1;

  for (int64_t i = 0; i < out_size; ++i) {
    const double center =
        align_corners ? scale * double(i) + 0.5 : scale * (double(i) + 0.5);
    double* w = weights_out + i * ntaps;
    if (border == kReplicate) {
      // unclamped window; fold out-of-range taps onto the edge pixel
      const int64_t lo0 = int64_t(std::floor(center - support + 0.5));
      double raw[64];
      double total = 0.0;
      for (int32_t j = 0; j < ntaps; ++j) {
        raw[j] = eval(filter, (double(j + lo0) - center + 0.5) * invscale);
        total += raw[j];
      }
      if (total != 0.0) {
        for (int32_t j = 0; j < ntaps; ++j) raw[j] /= total;
      }
      auto clampi = [&](int64_t v) {
        return v < 0 ? int64_t(0) : (v >= in_size ? in_size - 1 : v);
      };
      const int64_t lo = clampi(lo0);
      const int64_t hi = clampi(lo0 + ntaps - 1);
      xmin_out[i] = int32_t(lo);
      size_out[i] = int32_t(hi - lo + 1);
      for (int32_t j = 0; j < ntaps; ++j) w[j] = 0.0;
      for (int32_t j = 0; j < ntaps; ++j) {
        w[clampi(lo0 + j) - lo] += raw[j];
      }
      continue;
    }
    int64_t lo = int64_t(std::floor(center - support + 0.5));
    if (lo < 0) lo = 0;
    int64_t hi = int64_t(std::floor(center + support + 0.5));
    if (hi > in_size) hi = in_size;
    const int64_t n = hi - lo;
    xmin_out[i] = int32_t(lo);
    size_out[i] = int32_t(n);
    double total = 0.0;
    for (int64_t j = 0; j < n; ++j) {
      w[j] = eval(filter, (double(j + lo) - center + 0.5) * invscale);
      total += w[j];
    }
    if (total != 0.0) {
      for (int64_t j = 0; j < n; ++j) w[j] /= total;
    }
    for (int64_t j = n; j < ntaps; ++j) w[j] = 0.0;
  }
}

// Back-compat wrapper (renorm border).
void aa_compute_tables(int64_t in_size, int64_t out_size, int32_t filter,
                       int32_t antialias, int32_t align_corners,
                       int32_t* xmin_out, int32_t* size_out,
                       double* weights_out) {
  aa_compute_tables_v2(in_size, out_size, filter, antialias, align_corners,
                       kRenorm, xmin_out, size_out, weights_out);
}

// Scatter the compact tables into a dense [out, in] row-major matrix.
void aa_dense_matrix(int64_t in_size, int64_t out_size, int32_t ntaps,
                     const int32_t* xmin, const int32_t* size,
                     const double* weights, double* dense_out) {
  std::fill(dense_out, dense_out + in_size * out_size, 0.0);
  for (int64_t i = 0; i < out_size; ++i) {
    for (int32_t j = 0; j < size[i]; ++j) {
      const int64_t col = int64_t(xmin[i]) + j;
      if (col >= 0 && col < in_size) {
        dense_out[i * in_size + col] = weights[i * ntaps + j];
      }
    }
  }
}

}  // extern "C"

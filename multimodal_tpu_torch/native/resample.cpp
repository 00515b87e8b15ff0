// PIL's separable resampler for 8-bit images (Pillow's Resample.c:
// precompute_coeffs, normalize_coeffs_8bpc, ImagingResampleHorizontal_8bpc,
// ImagingResampleVertical_8bpc, ImagingResampleInner), for an RGB HWC
// uint8 array, so the FLAVA transform resizes as PIL does without PIL; and
// the FLAVA transform's two views of one RGB image in one call (both
// resizes, the normalisation, the dVAE's pixel map), in the fp32 arithmetic
// of the JAX transform's numpy normalisation. Called through ctypes by
// native/resample.py; a call holds no Python state, so threads may run it
// at once.

#pragma GCC optimize("O3")  // the integer passes vectorize at O3
// a * x + b stays two roundings, as numpy computes it
#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr int kChannels = 3;

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // per output pixel: first input pixel, count
  std::vector<int32_t> kk;  // per output pixel: ksize fixed-point weights
};

Coeffs precompute(int in_size, double in0, double in1, int out_size, int filter) {
  double (*fn)(double) = filter == 0 ? bicubic_filter : lanczos_filter;
  double support_base = filter == 0 ? 2.0 : 3.0;
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support_base * filterscale;
  Coeffs c;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.assign(out_size * 2, 0);
  c.kk.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> k(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    int x = 0;
    for (; x < xmax; ++x) {
      double w = fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (; x < c.ksize; ++x) k[x] = 0;
    for (x = 0; x < c.ksize; ++x) {
      double v = k[x] * (1 << kPrecisionBits);
      c.kk[static_cast<size_t>(xx) * c.ksize + x] =
          static_cast<int32_t>(k[x] < 0 ? -0.5 + v : 0.5 + v);
    }
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t ss) {
  int32_t v = ss >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void resample(const uint8_t* src, int h, int w, uint8_t* dst, int out_w, int out_h,
              double box0, double box1, double box2, double box3, int filter) {
  constexpr int ch = kChannels;
  if (out_w == w && out_h == h && box0 == 0 && box1 == 0 && box2 == w && box3 == h) {
    for (size_t i = 0; i < static_cast<size_t>(h) * w * ch; ++i) dst[i] = src[i];
    return;
  }
  bool need_h = out_w != w || box0 != 0 || box2 != out_w;
  bool need_v = out_h != h || box1 != 0 || box3 != out_h;
  Coeffs hc = precompute(w, box0, box2, out_w, filter);
  Coeffs vc = precompute(h, box1, box3, out_h, filter);
  int ybox_first = vc.bounds[0];
  int ybox_last = vc.bounds[out_h * 2 - 2] + vc.bounds[out_h * 2 - 1];

  const uint8_t* in = src;
  int in_h = h;
  int in_w = w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < out_h; ++i) vc.bounds[i * 2] -= ybox_first;
    in_h = ybox_last - ybox_first;
    uint8_t* out = need_v ? nullptr : dst;
    if (need_v) {
      tmp.resize(static_cast<size_t>(in_h) * out_w * ch);
      out = tmp.data();
    }
    int32_t ss[ch];
    for (int yy = 0; yy < in_h; ++yy) {
      const uint8_t* row = src + static_cast<size_t>(yy + ybox_first) * w * ch;
      uint8_t* orow = out + static_cast<size_t>(yy) * out_w * ch;
      for (int xx = 0; xx < out_w; ++xx) {
        int xmin = hc.bounds[xx * 2], xmax = hc.bounds[xx * 2 + 1];
        const int32_t* k = &hc.kk[static_cast<size_t>(xx) * hc.ksize];
        for (int c = 0; c < ch; ++c) ss[c] = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x) {
          const uint8_t* px = row + static_cast<size_t>(x + xmin) * ch;
          for (int c = 0; c < ch; ++c) ss[c] += px[c] * k[x];
        }
        for (int c = 0; c < ch; ++c) orow[static_cast<size_t>(xx) * ch + c] = clip8(ss[c]);
      }
    }
    in = out;
    in_w = out_w;
  }
  if (need_v) {
    std::vector<int32_t> ss(static_cast<size_t>(in_w) * ch);
    for (int yy = 0; yy < out_h; ++yy) {
      int ymin = vc.bounds[yy * 2], ymax = vc.bounds[yy * 2 + 1];
      const int32_t* k = &vc.kk[static_cast<size_t>(yy) * vc.ksize];
      for (auto& v : ss) v = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* row = in + static_cast<size_t>(y + ymin) * in_w * ch;
        int32_t ky = k[y];
        for (size_t i = 0; i < ss.size(); ++i) ss[i] += row[i] * ky;
      }
      uint8_t* orow = dst + static_cast<size_t>(yy) * in_w * ch;
      for (size_t i = 0; i < ss.size(); ++i) orow[i] = clip8(ss[i]);
    }
  }
}

constexpr float kLogitLaplaceEps = 0.1f;

}  // namespace

extern "C" {

// The FLAVA transform's views of an RGB image src (h x w x 3): enc_out
// (enc x enc x 3) is the bicubic resize of the box (the whole image when
// has_box is 0), normalised as (x / 255 - mean) / std; code_out (code x
// code x 3) the Lanczos resize of the box (of the encoder's uint8 view
// when has_box is 0), mapped as (1 - 2 eps) x / 255 + eps. Returns 0, or
// -1 for arguments out of range.
int flava_two_way_f32(const uint8_t* src, int h, int w, int has_box, double box0,
                      double box1, double box2, double box3, int enc, int code,
                      const float* mean, const float* std_, float* enc_out, float* code_out) {
  if (h < 1 || w < 1 || enc < 1 || code < 1) return -1;
  if (!has_box) {
    box0 = box1 = 0;
    box2 = w;
    box3 = h;
  }
  std::vector<uint8_t> enc_u8(static_cast<size_t>(enc) * enc * 3);
  std::vector<uint8_t> code_u8(static_cast<size_t>(code) * code * 3);
  resample(src, h, w, enc_u8.data(), enc, enc, box0, box1, box2, box3, 0);
  if (has_box)
    resample(src, h, w, code_u8.data(), code, code, box0, box1, box2, box3, 1);
  else
    resample(enc_u8.data(), enc, enc, code_u8.data(), code, code, 0, 0, enc, enc, 1);
  for (size_t i = 0; i < enc_u8.size(); ++i)
    enc_out[i] = (static_cast<float>(enc_u8[i]) / 255.0f - mean[i % 3]) / std_[i % 3];
  const float scale = 1.0f - 2.0f * kLogitLaplaceEps;
  for (size_t i = 0; i < code_u8.size(); ++i)
    code_out[i] = scale * (static_cast<float>(code_u8[i]) / 255.0f) + kLogitLaplaceEps;
  return 0;
}

// src: h x w x 3 uint8 (rows contiguous); dst: out_h x out_w x 3. The box
// (left, top, right, bottom) is the region of src to resample; filter 0 is
// bicubic, 1 Lanczos. Returns 0, or -1 for arguments out of range.
int flava_resample_u8(const uint8_t* src, int h, int w, uint8_t* dst, int out_w, int out_h,
                      double box0, double box1, double box2, double box3, int filter) {
  if (h < 1 || w < 1 || out_w < 1 || out_h < 1 || (filter != 0 && filter != 1)) return -1;
  resample(src, h, w, dst, out_w, out_h, box0, box1, box2, box3, filter);
  return 0;
}

}  // extern "C"

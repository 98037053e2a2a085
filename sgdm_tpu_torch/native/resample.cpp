// PIL's 8-bit separable resample (libImaging/Resample.c) and the PNG row
// unfilters, for the data path of the port.
//
// resample_u8: PIL's bilinear (filter 0, support 1), bicubic (1: a = -0.5,
// support 2), box (2: support 0.5), hamming (3: support 1) or lanczos (4:
// sinc(x) sinc(x/3), support 3) filter, its support widened by the
// downscale factor; coefficients in
// double, normalised to 22 fraction bits (a negative weight rounded as
// (int)(-0.5 + w * 2^22)); the horizontal pass first, then the vertical,
// each an int32 sum started at 1 << 21, shifted by 22 and clipped to uint8.
// An axis whose size does not change is not resampled, as in PIL.  The call
// writes the window [y0, y0 + sh) x [x0, x0 + sw) of the (oh, ow) result,
// which equals that crop of the whole result bit for bit (each output pixel
// has its own taps).  The source's rows may be strided.
//
// scale_crop_resize: the image chain of the segmentation datasets in one
// call: bilinear to (oh, ow) computed on the crop only, bicubic of the crop
// to rs x rs and, if asked, bilinear of the whole image to unsup x unsup.
//
// encode_mask: an id mask's NEAREST chain (the source row and column of
// each output pixel) and its encoding in one pass: 255 (the ignore label) is
// 0, a fine -> coarse table relabels, then the ids, or their one-hot, and the
// n-hot of the classes present.
//
// png_unfilter: the five PNG row filters (None, Sub, Up, Average, Paeth)
// undone in scanline order.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int PRECISION_BITS = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double box_filter(double x) {
  if (x > -0.5 && x <= 0.5) return 1.0;
  return 0.0;
}

// PIL's float constants 0.54f and 0.46f, widened to double as C does
double hamming_filter(double x) {
  if (x < 0.0) x = -x;
  if (x == 0.0) return 1.0;
  if (x >= 1.0) return 0.0;
  x = x * M_PI;
  return sin(x) / x * (0.54f + 0.46f * cos(x));
}

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

struct Filter {
  double (*f)(double);
  double support;
};

const Filter FILTERS[5] = {{bilinear_filter, 1.0},
                           {bicubic_filter, 2.0},
                           {box_filter, 0.5},
                           {hamming_filter, 1.0},
                           {lanczos_filter, 3.0}};

struct Taps {
  int ksize = 0;
  std::vector<int> xmin, xmax;  // first tap and tap count per output index
  std::vector<int32_t> k;       // [n_out, ksize] fixed-point weights
};

// precompute_coeffs + normalize_coeffs_8bpc
Taps taps(int in_size, int out_size, int filter) {
  double (*f)(double) = FILTERS[filter].f;
  double fsupport = FILTERS[filter].support;
  double scale = (double)in_size / out_size, filterscale = scale;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = fsupport * filterscale;
  Taps t;
  t.ksize = (int)ceil(support) * 2 + 1;
  t.xmin.resize(out_size);
  t.xmax.resize(out_size);
  t.k.assign((size_t)out_size * t.ksize, 0);
  std::vector<double> w(t.ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      w[x] = f((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    for (int x = 0; x < xmax; x++) {
      double v = ww != 0.0 ? w[x] / ww : w[x];
      t.k[(size_t)xx * t.ksize + x] =
          v < 0 ? (int)(-0.5 + v * (1 << PRECISION_BITS)) : (int)(0.5 + v * (1 << PRECISION_BITS));
    }
    t.xmin[xx] = xmin;
    t.xmax[xx] = xmax;
  }
  return t;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

// One row of the horizontal pass: output columns [x0, x0 + sw) of ``C``
// channels (C = 0: ``c`` known at run time only).
template <int C>
void horizontal_row(const uint8_t* row, uint8_t* out, const Taps& th, int x0, int sw, int c) {
  const int cc = C ? C : c;
  for (int xx = x0; xx < x0 + sw; xx++) {
    const int32_t* k = &th.k[(size_t)xx * th.ksize];
    const uint8_t* p = row + (size_t)th.xmin[xx] * cc;
    const int n = th.xmax[xx];
    int ss[4] = {1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1),
                 1 << (PRECISION_BITS - 1)};
    for (int x = 0; x < n; x++)
      for (int ch = 0; ch < cc; ch++) ss[ch] += p[x * cc + ch] * k[x];
    for (int ch = 0; ch < cc; ch++) out[(size_t)(xx - x0) * cc + ch] = clip8(ss[ch]);
  }
}

}  // namespace

extern "C" {

// src: [h, w, c] uint8, rows ``src_stride`` bytes apart, pixels packed;
// dst: [sh, sw, c] contiguous, the window at (y0, x0) of the (oh, ow) resize.
int resample_u8(const uint8_t* src, int64_t src_stride, int h, int w, int c, uint8_t* dst,
                int oh, int ow, int filter, int y0, int x0, int sh, int sw) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || c <= 0 || c > 4 || y0 < 0 || x0 < 0 ||
      sh <= 0 || sw <= 0 || y0 + sh > oh || x0 + sw > ow || filter < 0 || filter > 4)
    return -1;
  bool need_h = ow != w, need_v = oh != h;
  // rows of the source the window's vertical taps read
  Taps tv;
  int r0 = y0, r1 = y0 + sh;
  if (need_v) {
    tv = taps(h, oh, filter);
    r0 = tv.xmin[y0];
    r1 = 0;
    for (int y = y0; y < y0 + sh; y++)
      if (tv.xmin[y] + tv.xmax[y] > r1) r1 = tv.xmin[y] + tv.xmax[y];
  }
  // horizontal pass over rows [r0, r1) into tmp [r1 - r0, sw, c]
  std::vector<uint8_t> tmp;
  const uint8_t* mid;
  int64_t mid_stride;
  int mid_x0;
  if (need_h) {
    Taps th = taps(w, ow, filter);
    tmp.resize((size_t)(r1 - r0) * sw * c);
    for (int y = r0; y < r1; y++) {
      const uint8_t* row = src + (int64_t)y * src_stride;
      uint8_t* out = tmp.data() + (size_t)(y - r0) * sw * c;
      if (c == 3) horizontal_row<3>(row, out, th, x0, sw, c);
      else if (c == 1) horizontal_row<1>(row, out, th, x0, sw, c);
      else horizontal_row<0>(row, out, th, x0, sw, c);
    }
    mid = tmp.data();
    mid_stride = (int64_t)sw * c;
    mid_x0 = 0;
  } else {
    mid = src + (int64_t)r0 * src_stride;
    mid_stride = src_stride;
    mid_x0 = x0;
  }
  const int64_t row_bytes = (int64_t)sw * c;
  if (!need_v) {
    for (int y = 0; y < sh; y++)
      memcpy(dst + y * row_bytes, mid + (int64_t)y * mid_stride + (int64_t)mid_x0 * c, row_bytes);
    return 0;
  }
  std::vector<int> acc(row_bytes);
  for (int yy = y0; yy < y0 + sh; yy++) {
    const int32_t* k = &tv.k[(size_t)yy * tv.ksize];
    int first = tv.xmin[yy] - r0, n = tv.xmax[yy];
    std::fill(acc.begin(), acc.end(), 1 << (PRECISION_BITS - 1));
    for (int y = 0; y < n; y++) {
      const uint8_t* p = mid + (int64_t)(first + y) * mid_stride + (int64_t)mid_x0 * c;
      int32_t kk = k[y];
      for (int64_t i = 0; i < row_bytes; i++) acc[i] += p[i] * kk;
    }
    uint8_t* out = dst + (int64_t)(yy - y0) * row_bytes;
    for (int64_t i = 0; i < row_bytes; i++) out[i] = clip8(acc[i]);
  }
  return 0;
}

int scale_crop_resize(const uint8_t* src, int64_t src_stride, int h, int w, int c, int oh,
                      int ow, int y0, int x0, int crop, int rs, uint8_t* dst, int unsup,
                      uint8_t* unsup_dst) {
  std::vector<uint8_t> mid((size_t)crop * crop * c);
  if (resample_u8(src, src_stride, h, w, c, mid.data(), oh, ow, 0, y0, x0, crop, crop)) return -1;
  if (resample_u8(mid.data(), (int64_t)crop * c, crop, crop, c, dst, rs, rs, 1, 0, 0, rs, rs))
    return -1;
  if (unsup > 0 &&
      resample_u8(src, src_stride, h, w, c, unsup_dst, unsup, unsup, 0, 0, 0, unsup, unsup))
    return -1;
  return 0;
}

// m: uint8 mask, rows ``stride`` bytes apart; rows [oh], cols [ow]: source
// indices; lut: 256 entries (-1: not in the mapping) or null; k classes.
// Writes ids [oh, ow] uint8 or, if ``onehot``, [oh, ow, k] f32, and the n-hot
// [k] f32 if ``nhot``.  Returns 0; -(1 + v) if a value v has no entry in the
// table (the smallest such); 1 + v if an id v >= k (the largest).
int64_t encode_mask(const uint8_t* m, int64_t stride, const int64_t* rows, const int64_t* cols,
                    int oh, int ow, const int16_t* lut, int k, uint8_t* ids, float* onehot,
                    float* nhot) {
  std::vector<uint8_t> out((size_t)oh * ow);
  int missing = 256, top = -1;
  for (int y = 0; y < oh; y++) {
    const uint8_t* row = m + rows[y] * stride;
    for (int x = 0; x < ow; x++) {
      int v = row[cols[x]];
      if (v == 255) v = 0;
      if (lut) {
        int c = lut[v];
        if (c < 0) {
          if (v < missing) missing = v;
          c = 0;
        }
        v = c;
      }
      if (v > top) top = v;
      out[(size_t)y * ow + x] = (uint8_t)v;
    }
  }
  if (missing < 256) return -(1 + (int64_t)missing);
  if (top >= k) return 1 + (int64_t)top;
  const size_t n = (size_t)oh * ow;
  if (onehot) {
    memset(onehot, 0, n * k * sizeof(float));
    for (size_t i = 0; i < n; i++) onehot[i * k + out[i]] = 1.0f;
  } else {
    memcpy(ids, out.data(), n);
  }
  if (nhot) {
    for (int c = 0; c < k; c++) nhot[c] = 0.0f;
    for (size_t i = 0; i < n; i++) nhot[out[i]] = 1.0f;
  }
  return 0;
}

// raw: [h, 1 + stride] filtered scanlines; out: [h, stride].  Returns 0, or
// 1 + the row whose filter byte is not 0-4.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prior = zero.data();
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* line = raw + y * (1 + stride) + 1;
    int kind = raw[y * (1 + stride)];
    uint8_t* cur = out + y * stride;
    switch (kind) {
      case 0:
        memcpy(cur, line, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++) cur[i] = (uint8_t)(line[i] + prior[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(line[i] + ((left + prior[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = 0, c = 0, b = prior[i];
          if (i >= bpp) {
            a = cur[i - bpp];
            c = prior[i - bpp];
          }
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prior = cur;
  }
  return 0;
}

}  // extern "C"

// Batch assembly for the downsampled-ImageNet reader (32/64 px rows).
//
// The port's copy of the functions of sgdm_tpu/native/batchgather.cpp that
// ImageNetPickle.get_batch calls: the per-sample work (gather a row,
// CHW -> HWC, uint8 -> f32 in [-1, 1], collate) as one call per batch,
// OpenMP-parallel over samples; ctypes releases the interpreter lock for
// the call, so the loader thread assembles a batch while the train step
// launches its kernels.
//
// out_f32 = ((float)v / 255.0f) * 2.0f - 1.0f, in f32 and in this order:
// bit for bit what numpy gives for img.astype(float32) / 255.0 * 2.0 - 1.0.

#include <cstdint>
#include <cstring>

extern "C" {

// data: [N, 3*S*S] uint8, each row CHW (the Chrabaszcz pickle layout).
// idx: [B] int64 row ids.  out_f32: [B,S,S,3] float32; out_u8: [B,S,S,3]
// uint8 (the img4unsup copy) or nullptr.
void gather_chw_to_nhwc(const uint8_t* data, const int64_t* idx,
                        int64_t b, int64_t s,
                        float* out_f32, uint8_t* out_u8) {
  const int64_t plane = s * s;
  const int64_t row = 3 * plane;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* src = data + idx[i] * row;
    float* dst_f = out_f32 + i * row;
    uint8_t* dst_u = out_u8 ? out_u8 + i * row : nullptr;
    for (int64_t p = 0; p < plane; ++p) {
      const uint8_t r = src[p];
      const uint8_t g = src[plane + p];
      const uint8_t bch = src[2 * plane + p];
      float* f = dst_f + 3 * p;
      f[0] = ((float)r / 255.0f) * 2.0f - 1.0f;
      f[1] = ((float)g / 255.0f) * 2.0f - 1.0f;
      f[2] = ((float)bch / 255.0f) * 2.0f - 1.0f;
      if (dst_u) {
        uint8_t* u = dst_u + 3 * p;
        u[0] = r; u[1] = g; u[2] = bch;
      }
    }
  }
}

// The same for rows already HWC: data [N, S*S*3] -> out_f32 [B,S,S,3].
void gather_hwc_to_nhwc(const uint8_t* data, const int64_t* idx,
                        int64_t b, int64_t s,
                        float* out_f32, uint8_t* out_u8) {
  const int64_t row = 3 * s * s;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* src = data + idx[i] * row;
    float* dst_f = out_f32 + i * row;
    for (int64_t p = 0; p < row; ++p)
      dst_f[p] = ((float)src[p] / 255.0f) * 2.0f - 1.0f;
    if (out_u8) std::memcpy(out_u8 + i * row, src, (size_t)row);
  }
}

// f32 row gather (condition vectors, features): rows [N, D] -> out [B, D].
void gather_rows_f32(const float* rows, const int64_t* idx,
                     int64_t b, int64_t d, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i)
    std::memcpy(out + i * d, rows + idx[i] * d, sizeof(float) * (size_t)d);
}

}  // extern "C"

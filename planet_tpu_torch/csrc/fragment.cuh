// The exact raster's fragment math: one record at one pixel, min-merged
// into the packed framebuffer with atomicMin. Shared by the span and huge
// kernels (raster.cu, K2 and K3) and the span cost split (bench_span.cu,
// t_span), so the split's "full" body is K2's bit for bit. Plain PyTorch
// version: raster/coverage.py:_merge, the same op order.
//
// Built with -fmad=false -prec-div=true -prec-sqrt=true (see raster.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raster_core {

constexpr float kLightY = 0.7071067811865476f;    // f32(1/sqrt(2))
constexpr float kLightZ = -0.7071067811865476f;

// One fragment of record r at pixel (px, py); rx/ry are its offsets from
// the bbox-min pixel.
template <bool kIwTest>
__device__ __forceinline__ void fragment(const float* r, int px, int py,
                                         int rx_i, int ry_i, int width,
                                         bool wireframe, int* fb) {
  const float rx = (float)rx_i, ry = (float)ry_i;
  const float e0 = (r[0] * ry - r[1] * rx) + r[2];
  const float e1 = (r[3] * ry - r[4] * rx) + r[5];
  const float e2 = (r[6] * ry - r[7] * rx) + r[8];
  if (!(e0 > r[29] && e1 > r[30] && e2 > r[31])) return;
  if (wireframe) {
    const float w0 = e0 + e0, w1 = e1 + e1, w2 = e2 + e2;
    const bool on = (w0 * w0 <= r[0] * r[0] + r[1] * r[1]) ||
                    (w1 * w1 <= r[3] * r[3] + r[4] * r[4]) ||
                    (w2 * w2 <= r[6] * r[6] + r[7] * r[7]);
    if (!on) return;
  }
  const float z = (e0 * r[9] + e1 * r[10]) + e2 * r[11];
  if (!(z >= -1.0f)) return;
  if (kIwTest) {
    const float iw = (e0 * r[12] + e1 * r[13]) + e2 * r[14];
    if (!(iw > 0.0f && iw > r[28])) return;
  }
  const float nx = (e0 * r[15] + e1 * r[18]) + e2 * r[21];
  const float ny = (e0 * r[16] + e1 * r[19]) + e2 * r[22];
  const float nz = (e0 * r[17] + e1 * r[20]) + e2 * r[23];
  const float nlen = sqrtf((nx * nx + ny * ny) + nz * nz);
  const float ndl = (ny * kLightY + nz * kLightZ) / (nlen > 0.0f ? nlen : 1.0f);
  const float shade = sqrtf(0.001f + (ndl < 0.0f ? 0.0f : ndl));
  const int zq = (int)fminf((z * 0.5f + 0.5f) * 2097151.0f, 2097150.0f);
  const int sq = (int)fminf(shade * 1023.0f, 1023.0f);
  atomicMin(fb + (size_t)py * width + px, (zq << 10) | sq);
}

}  // namespace raster_core

// Exact-coverage raster kernels: the record gather (K6) and the span (K2)
// and huge (K3) fragment kernels, which min-merge packed
// (21-bit depth << 10 | 10-bit shade) int32 keys into an exact (H, W)
// framebuffer with atomicMin.
//
// Replaces, in planet_tpu/raster/coverage_pallas.py:
//   _tr_kernel (via _transpose_records)       -> gather_records_kernel
//   _raster_class_kernel / _one_triangle      -> span_kernel
//   _huge_class_kernel / _one_huge            -> huge_kernel
// Plain PyTorch versions: planet_tpu_torch/raster/coverage_cuda.py
// (gather_records_plain, raster_span_plain, raster_huge_plain).
//
// Records are coverage.setup_t's 32-float layout, one 128-byte row each:
//   0-8 edge (DX, DY, c) x3 | 9-11 z | 12-14 1/w | 15-23 normal*(1/w)
//   (vertex-major, all inv_area-folded) | 24-27 clamped bbox px0 py0 px1 py1
//   | 28: 0 dead, -1 live, +1/far live far-straddler | 29-31 accept biases.
//
// What bounds these on the H100: the 1080p LOD scene has ~36k span
// records whose bboxes hold 189 candidate pixels at the median (2035 at
// p99), 1.15e7 candidates in all, of which 15% are covered. That is
// ~5e8 f32 operations and 1.7e6 atomics per frame: microseconds of
// arithmetic, so the kernel is bound by latency (the per-candidate integer
// divide, divergence at bbox edges), not by bytes — the records are 4.6 MB
// and the framebuffer (8.3 MB at 1080p) stays in the 50 MB L2, so
// atomicMin traffic does not reach HBM. Design: one warp per record, the
// record loaded once with one coalesced 128-byte read and broadcast by
// shuffles, lanes striding over the bbox pixels. The huge kernel gives
// each record a 2-D grid of 16x16 pixel tiles (block y strides over the
// record's bbox tiles), so a screen-filling triangle spreads over many
// SMs. The gather is a 32x32 shared-memory transpose tile.
//
// The TPU-only machinery does not come across: no class caps or ladder, no
// _class_fixup window addressing, no per-block flags, no framebuffer
// padding. atomicMin is order-independent, so the image is deterministic.
//
// Fragment math is coverage._fragments' op order, compiled with
// -fmad=false -prec-div=true -prec-sqrt=true: coverage, depth and shade
// equal the plain version's bit for bit. A rejected fragment's packed key
// is never computed or merged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = 0x7fffffff;
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

constexpr int kSpanThreads = 256;

__global__ void __launch_bounds__(kSpanThreads)
span_kernel(const float* __restrict__ recs, int m, int* __restrict__ fb,
            int width, int wireframe) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= m) return;
  const float mine = recs[(size_t)warp * 32 + lane];
  float r[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) r[k] = __shfl_sync(0xffffffffu, mine, k);
  if (r[28] == 0.0f) return;
  const int px0 = (int)r[24], py0 = (int)r[25];
  const int bw = (int)r[26] - px0 + 1, bh = (int)r[27] - py0 + 1;
  const int area = bw * bh;
  for (int i = lane; i < area; i += 32) {
    const int ry = i / bw, rx = i - ry * bw;
    fragment<false>(r, px0 + rx, py0 + ry, rx, ry, width, wireframe != 0, fb);
  }
}

constexpr int kTile = 16;
constexpr int kHugeStride = 64;    // blocks per record; each strides tiles

__global__ void __launch_bounds__(kTile * kTile)
huge_kernel(const float* __restrict__ recs, int* __restrict__ fb, int width,
            int wireframe) {
  __shared__ float r[32];
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (t < 32) r[t] = recs[(size_t)blockIdx.x * 32 + t];
  __syncthreads();
  if (r[28] == 0.0f) return;
  const int px0 = (int)r[24], py0 = (int)r[25];
  const int px1 = (int)r[26], py1 = (int)r[27];
  const int ntx = (px1 - px0) / kTile + 1;
  const int nty = (py1 - py0) / kTile + 1;
  for (int tile = blockIdx.y; tile < ntx * nty; tile += gridDim.y) {
    const int rx = (tile % ntx) * kTile + threadIdx.x;
    const int ry = (tile / ntx) * kTile + threadIdx.y;
    if (px0 + rx <= px1 && py0 + ry <= py1)
      fragment<true>(r, px0 + rx, py0 + ry, rx, ry, width, wireframe != 0, fb);
  }
}

// out[j, k] = tm[k, idx[j]] for idx[j] in [0, n), else 0 (a dead record)
__global__ void gather_records_kernel(const float* __restrict__ tm,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, int m, int n) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32;
  const int tx = threadIdx.x;
  const int j = j0 + tx;
  const int src = j < m ? idx[j] : -1;
  for (int k = threadIdx.y; k < 32; k += blockDim.y)
    tile[k][tx] = (src >= 0 && src < n) ? tm[(size_t)k * n + src] : 0.0f;
  __syncthreads();
  for (int jj = threadIdx.y; jj < 32; jj += blockDim.y)
    if (j0 + jj < m) out[(size_t)(j0 + jj) * 32 + tx] = tile[tx][jj];
}

}  // namespace

extern "C" int planet_gather_records(const void* tm, const void* idx,
                                     void* out, int m, int n, void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  gather_records_kernel<<<(m + 31) / 32, dim3(32, 8), 0,
                          (cudaStream_t)stream>>>(
      (const float*)tm, (const int*)idx, (float*)out, m, n);
  return (int)cudaGetLastError();
}

extern "C" int planet_raster_span(const void* recs, int m, void* fb, int width,
                                  int height, int wireframe, void* stream) {
  (void)height;
  const long long threads = (long long)m * 32;
  if (m <= 0 || threads / kSpanThreads + 1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  span_kernel<<<(unsigned)((threads + kSpanThreads - 1) / kSpanThreads),
                kSpanThreads, 0, (cudaStream_t)stream>>>(
      (const float*)recs, m, (int*)fb, width, wireframe);
  return (int)cudaGetLastError();
}

extern "C" int planet_raster_huge(const void* recs, int m, void* fb, int width,
                                  int height, int wireframe, void* stream) {
  (void)height;
  if (m <= 0 || m > 0x7fffffff) return (int)cudaErrorInvalidValue;
  huge_kernel<<<dim3((unsigned)m, kHugeStride), dim3(kTile, kTile), 0,
                (cudaStream_t)stream>>>((const float*)recs, (int*)fb, width,
                                        wireframe);
  return (int)cudaGetLastError();
}

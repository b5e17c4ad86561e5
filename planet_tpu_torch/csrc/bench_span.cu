// Span-raster cost split (t_span): variants of the first port's K2, the
// bbox scan (raster.cu now scans a whole bbox only where an edge word is
// not finite), that keep or drop parts of its per-record work, so its time
// per record splits into setup, fragment math and atomics on the card.
//
// Replaces the Pallas span microbenchmarks in planet_tpu's tools/:
// microbench_span2.py:86 and microbench_span3.py:116 `run` (record bodies,
// TRI_BLOCK), proto_bv.py:94 and proto_bv2.py:92 `run_bv` (the
// block-vectorized span kernel). Plain PyTorch versions: planet_tpu_torch/
// tools/span_parts.py, which every variant equals bit for bit (full: K2's
// plain version, coverage_cuda.raster_span_plain); the wrapper is
// span_parts.raster.
//
// Records are coverage.setup_t's layout (raster.cu:13-16), absolute bbox.
// Per-record variants (the first port's K2: one warp per record, the
// record read once and broadcast by shuffles, lanes striding over the bbox
// pixels; `per_warp` records a warp one after another, TRI_BLOCK's
// counterpart):
//   0 full        K2's fragment (fragment.cuh)
//   1 noshade     no normal, length or light: shade = z
//   2 fewscalar   11 record words broadcast; edge 0 stands for all three
//                 edges, word 9 for the z and word 15 for the normal
//                 coefficients
//   3 rmw_only    the bbox and live words broadcast, atomicMin(7) over the
//                 bbox, no fragment math
//   4 empty       the record read, its live word broadcast and tested
//   5 static_rmw  full, every record drawn with its bbox min at (0, 0)
// Block-vectorized variants (proto_bv's counterpart): a block stages R
// records in shared memory and runs one thread per (record, pixel) of each
// record's aligned (winh, 128) window, with the bbox test (or without it,
// `noin`); the window origin comes from the record (its bbox min's 8-row
// and 128-column blocks, clamped to the framebuffer), from a side (m, 2)
// int32 array of those blocks, or is static (record k of a group draws at
// rows (k winh) mod (H - winh), columns 128 (k mod (W / 128)); the fragment
// math stays at the record's own window):
//   6 bv_record   7 bv_side   8 bv_static
//
// What bounds them: as the first port's K2, latency of the per-pixel integer
// arithmetic, divergence and atomics, not bytes.

#include "fragment.cuh"

namespace {

using namespace raster_core;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Body { kFullBody = 0, kNoShade, kFewScalar, kRmwOnly, kEmptyBody,
            kStaticRmw };

__device__ __forceinline__ void pack_min(int* fb, int px, int py, int width,
                                         float z, float shade) {
  const int zq = (int)fminf((z * 0.5f + 0.5f) * 2097151.0f, 2097150.0f);
  const int sq = (int)fminf(shade * 1023.0f, 1023.0f);
  atomicMin(fb + (size_t)py * width + px, (zq << 10) | sq);
}

__device__ __forceinline__ void frag_noshade(const float* r, int px, int py,
                                             int rx_i, int ry_i, int width,
                                             int* fb) {
  const float rx = (float)rx_i, ry = (float)ry_i;
  const float e0 = (r[0] * ry - r[1] * rx) + r[2];
  const float e1 = (r[3] * ry - r[4] * rx) + r[5];
  const float e2 = (r[6] * ry - r[7] * rx) + r[8];
  if (!(e0 > r[29] && e1 > r[30] && e2 > r[31])) return;
  const float z = (e0 * r[9] + e1 * r[10]) + e2 * r[11];
  if (!(z >= -1.0f)) return;
  pack_min(fb, px, py, width, z, z);
}

__device__ __forceinline__ void frag_few(const float* r, int px, int py,
                                         int rx_i, int ry_i, int width,
                                         int* fb) {
  const float rx = (float)rx_i, ry = (float)ry_i;
  const float e = (r[0] * ry - r[1] * rx) + r[2];
  if (!(e > r[29] && e > r[29] && e > r[29])) return;
  const float z = (e * r[9] + e * r[9]) + e * r[9];
  if (!(z >= -1.0f)) return;
  const float nv = (e * r[15] + e * r[15]) + e * r[15];
  const float nlen = sqrtf((nv * nv + nv * nv) + nv * nv);
  const float ndl = (nv * kLightY + nv * kLightZ) / (nlen > 0.0f ? nlen : 1.0f);
  const float shade = sqrtf(0.001f + (ndl < 0.0f ? 0.0f : ndl));
  pack_min(fb, px, py, width, z, shade);
}

template <int kBody>
__global__ void __launch_bounds__(kThreads)
record_kernel(const float* __restrict__ recs, int m, int* __restrict__ fb,
              int width, int per_warp) {
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < per_warp; ++j) {
    const long long rec = warp * per_warp + j;
    if (rec >= m) return;
    const float mine = recs[rec * 32 + lane];
    if (kBody == kEmptyBody) {
      const bool live = __shfl_sync(kFull, mine, 28) != 0.0f;
      asm volatile("" ::"r"((int)live));
      continue;
    }
    float r[32];
    if (kBody == kFewScalar) {
      constexpr int kWords[11] = {0, 1, 2, 9, 15, 24, 25, 26, 27, 28, 29};
#pragma unroll
      for (int k = 0; k < 11; ++k)
        r[kWords[k]] = __shfl_sync(kFull, mine, kWords[k]);
    } else if (kBody == kRmwOnly) {
#pragma unroll
      for (int k = 24; k < 29; ++k) r[k] = __shfl_sync(kFull, mine, k);
    } else {
#pragma unroll
      for (int k = 0; k < 32; ++k) r[k] = __shfl_sync(kFull, mine, k);
    }
    if (r[28] == 0.0f) continue;
    const int px0 = (int)r[24], py0 = (int)r[25];
    const int bw = (int)r[26] - px0 + 1, bh = (int)r[27] - py0 + 1;
    const int area = bw * bh;
    for (int i = lane; i < area; i += 32) {
      const int ry = i / bw, rx = i - ry * bw;
      const int px = px0 + rx, py = py0 + ry;
      if (kBody == kFullBody)
        fragment<false>(r, px, py, rx, ry, width, false, fb);
      else if (kBody == kNoShade)
        frag_noshade(r, px, py, rx, ry, width, fb);
      else if (kBody == kFewScalar)
        frag_few(r, px, py, rx, ry, width, fb);
      else if (kBody == kRmwOnly)
        atomicMin(fb + (size_t)py * width + px, 7);
      else
        fragment<false>(r, rx, ry, rx, ry, width, false, fb);
    }
  }
}

enum Addr { kFromRecord = 0, kSide = 1, kStatic = 2 };

template <int kWinh, int kAddr, bool kNoIn>
__global__ void __launch_bounds__(kThreads)
bv_kernel(const float* __restrict__ recs, const int* __restrict__ addr,
          int m, int* __restrict__ fb, int width, int height, int group) {
  extern __shared__ float s[];   // group * 32 record words
  const long long g0 = (long long)blockIdx.x * group;
  for (int i = threadIdx.x; i < group * 32; i += blockDim.x)
    s[i] = g0 * 32 + i < (long long)m * 32 ? recs[g0 * 32 + i] : 0.0f;
  __syncthreads();
  constexpr int kPixels = kWinh * 128;
  const int max_yb = (height - kWinh) / 8, max_xb = (width - 128) / 128;
  for (int p = threadIdx.x; p < group * kPixels; p += blockDim.x) {
    const int k = p / kPixels, l = p - k * kPixels;
    if (g0 + k >= m) break;
    const float* r = s + k * 32;
    if (r[28] == 0.0f) continue;
    const int row = l >> 7, col = l & 127;
    const int px0 = (int)r[24], py0 = (int)r[25];
    int yb, xb;
    if (kAddr == kSide) {
      yb = addr[(g0 + k) * 2], xb = addr[(g0 + k) * 2 + 1];
    } else {
      yb = py0 >> 3, xb = px0 >> 7;
    }
    yb = min(max(yb, 0), max_yb);
    xb = min(max(xb, 0), max_xb);
    const int px = xb * 128 + col, py = yb * 8 + row;
    if (!kNoIn && !(px >= px0 && px <= (int)r[26] && py >= py0 &&
                    py <= (int)r[27]))
      continue;
    int wx = px, wy = py;
    if (kAddr == kStatic) {
      wy = (k * kWinh) % (height - kWinh) + row;
      wx = 128 * (k % (width / 128)) + col;
    }
    fragment<false>(r, wx, wy, px - px0, py - py0, width, false, fb);
  }
}

template <int kWinh>
int launch_bv(int variant, int noin, const float* recs, const int* addr,
              int m, int* fb, int width, int height, int group,
              cudaStream_t s) {
  const unsigned blocks = (unsigned)((m + group - 1) / group);
  const size_t shm = (size_t)group * 32 * sizeof(float);
#define PLANET_BV(A, N)                                                     \
  bv_kernel<kWinh, A, N><<<blocks, kThreads, shm, s>>>(recs, addr, m, fb, \
                                                      width, height, group)
  if (variant == 6) {
    if (noin) PLANET_BV(kFromRecord, true); else PLANET_BV(kFromRecord, false);
  } else if (variant == 7) {
    if (noin) PLANET_BV(kSide, true); else PLANET_BV(kSide, false);
  } else {
    if (noin) PLANET_BV(kStatic, true); else PLANET_BV(kStatic, false);
  }
#undef PLANET_BV
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0-5 per-record bodies (group = records a warp), 6-8
// block-vectorized (group = R records a block, winh 8, 16 or 24, noin 0/1;
// addr is read by variant 7 only and may be null otherwise)
extern "C" int planet_t_span(int variant, const void* recs, const void* addr,
                             int m, void* fb, int width, int height,
                             int group, int winh, int noin, void* stream) {
  if (m <= 0 || group <= 0 || width < 128 || height <= winh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)recs;
  int* f = (int*)fb;
  if (variant >= 6 && variant <= 8) {
    if (group > 64 || (variant == 7 && addr == nullptr))
      return (int)cudaErrorInvalidValue;
    const int* a = (const int*)addr;
    if (winh == 8) return launch_bv<8>(variant, noin, r, a, m, f, width, height, group, s);
    if (winh == 16) return launch_bv<16>(variant, noin, r, a, m, f, width, height, group, s);
    if (winh == 24) return launch_bv<24>(variant, noin, r, a, m, f, width, height, group, s);
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = ((long long)m + group - 1) / group;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (variant) {
#define PLANET_REC(B)                                                   \
  record_kernel<B><<<(unsigned)blocks, kThreads, 0, s>>>(r, m, f, width, \
                                                         group);        \
  break
    case 0: PLANET_REC(kFullBody);
    case 1: PLANET_REC(kNoShade);
    case 2: PLANET_REC(kFewScalar);
    case 3: PLANET_REC(kRmwOnly);
    case 4: PLANET_REC(kEmptyBody);
    case 5: PLANET_REC(kStaticRmw);
#undef PLANET_REC
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

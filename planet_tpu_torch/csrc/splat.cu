// Splat kernel (S1): the splat raster's fragments, keys and depth test in
// one pass. (Q, G, G) patch grids of clip positions, shades and validity
// -> packed (21-bit depth << 10 | 10-bit shade) keys, min-merged into an
// (H, W) int32 framebuffer with atomicMin.
//
// planet_tpu computes the splat in XLA (raster/splat.py: upsample_cells,
// then splat_frame's projection, packing and one scatter-min), not in
// Pallas, so this kernel replaces no TPU kernel: the card's numbers called
// for it (the composed torch ops took ~29 ms of a 1080p splat frame at
// supersample 8, PERF.md). Plain PyTorch version:
// planet_tpu_torch/raster/splat.py:splat_keys_plain (upsample_cells, then
// pack_keys), which it equals bit for bit; the wrapper is
// raster/splat.py:splat_keys.
//
// What bounds it: issue. A fragment is ~60 f32 operations (the blend of
// five values, the reciprocal, the projection, two quantizations) and one
// atomicMin, and a 1080p frame at supersample 8 has 12.9-31.5 M of them.
// Design: a thread a grid cell, or two lanes a cell from 32 fragments a
// cell on (cell_kernel; kPairFrags). A block's lanes are neighbouring
// cells of a row and its 8 warps 8 rows, the grid (column blocks, row
// blocks, patches), so no thread divides an index: the cell's
// four corners, shades and validity are read once, coalesced across the
// warp, into registers (an invalid cell, such as DeviceRenderer's padding
// rows, exits at once), and the thread walks its k*k fragments (2k - 1
// with wireframe) in order through the block's weight table in shared
// memory, each a broadcast read (two lanes of a cell take every other
// fragment). The table is formed per block as the
// plain version forms it (raster/splat.py:weights: fu = j / (k - 1) in
// double, rounded to f32, then the f32 products), each entry by the lane
// of its column j and the warps of its rows i, at the position of (i, j)
// in weights' order (table_slot), with no division. Each fragment blends
// the corners in the plain version's order of multiplies and adds, then
// projects (the IEEE 1.0f / w), packs and atomicMins; neighbouring lanes
// are neighbouring cells, so a warp's atomics fall on distinct pixels.
// The index arithmetic is 32-bit where the grid fits (every frame here).
// Without upsampling (k <= 1) a thread takes one vertex (frag_kernel).
// Nothing is written but the keys of fragments that land on screen.
// Built with -fmad=false, so every product rounds as torch's.
//
// Designs that lost to this one on the card and were taken out (PERF.md
// S1 row; git ee5a145 holds them): the first design, a thread a fragment
// in a grid-stride loop with its cell by integer division or by
// multiply-high; and the cell kernel with a plain read of the pixel that
// skips the atomicMin when the pixel already holds a key no larger.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;         // a warp's lanes form a table row
constexpr int kMaxFrags = kMaxK * kMaxK;

// float -> int32 as XLA converts (truncate, saturate, NaN -> 0)
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return __float2int_rz(x);
}

// clamp(v, 0, vmax) with a NaN kept NaN (torch.clamp), then to_i32
__device__ __forceinline__ int clamped_i32(float v, float vmax) {
  return v != v ? 0 : to_i32(fminf(fmaxf(v, 0.0f), vmax));
}

__device__ __forceinline__ float blend(float a, float b, float c, float d,
                                       float4 w) {
  return ((a * w.x + b * w.y) + c * w.z) + d * w.w;
}

// the position of point (i, j) of a cell's k x k points in weights' order
// (rows i, columns j; with wireframe the row i == 0, then the column j ==
// 0 below it), -1 for a point wireframe drops (raster/splat.py:weights;
// splat.table_slot mirrors it for the tests)
__device__ __forceinline__ int table_slot(int i, int j, int k,
                                          int wireframe) {
  if (!wireframe) return i * k + j;
  if (i == 0) return j;
  return j == 0 ? k + i - 1 : -1;
}

// the block's weight table (w00, w01, w10, w11) of each fragment, in
// weights' order: lane j forms column j, the warps rows i, i + 8, ...
// (every thread of the block must call this; k <= kMaxK)
__device__ __forceinline__ void form_table(float4* table, int k,
                                           int wireframe) {
  const int j = threadIdx.x & 31;
  if (j < k) {
    const float fu = (float)((double)j / (double)(k - 1));
    for (int i = threadIdx.x >> 5; i < k; i += kWarps) {
      const int f = table_slot(i, j, k, wireframe);
      if (f < 0) continue;
      const float fv = (float)((double)i / (double)(k - 1));
      table[f] = make_float4((1.0f - fu) * (1.0f - fv), fu * (1.0f - fv),
                             (1.0f - fu) * fv, fu * fv);
    }
  }
  __syncthreads();
}

// project, pack and depth-test one fragment: clip position p, shade s
__device__ __forceinline__ void splat_fragment(float4 p, float s, int width,
                                               int height,
                                               int* __restrict__ fb) {
  if (!(p.w > 1e-9f)) return;
  const float inv_w = 1.0f / p.w;
  const float nx = p.x * inv_w, ny = p.y * inv_w, nz = p.z * inv_w;
  const int px = to_i32(floorf((nx * 0.5f + 0.5f) * (float)width));
  const int py = to_i32(floorf((0.5f - ny * 0.5f) * (float)height));
  if (px < 0 || px >= width || py < 0 || py >= height) return;
  if (!(nz >= -1.0f && nz <= 1.0f)) return;
  const int zq = clamped_i32((nz * 0.5f + 0.5f) * 2097151.0f, 2097151.0f);
  const int sq = clamped_i32(s * 1023.0f, 1023.0f);
  atomicMin(fb + (size_t)py * width + px, (zq << 10) | sq);
}

// A thread a cell (k > 1): lanes are cells c of row r of patch q, kGroup
// lanes a cell, each taking every kGroup-th fragment.
template <int kGroup, typename Index>
__global__ void __launch_bounds__(kThreads)
cell_kernel(const float4* __restrict__ clip, const float* __restrict__ shade,
            const uint8_t* __restrict__ valid, int q_n, int g, int k,
            int wireframe, int frags, int width, int height,
            int* __restrict__ fb) {
  __shared__ float4 table[kMaxFrags];
  form_table(table, k, wireframe);
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (32 / kGroup) + lane / kGroup;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (c >= g - 1 || r >= g - 1) return;
  const int first = kGroup > 1 ? lane % kGroup : 0;
  for (int q = blockIdx.z; q < q_n; q += gridDim.z) {
    const Index b00 = ((Index)q * g + r) * g + c;
    const Index b10 = b00 + g;
    if (!(valid[b00] && valid[b00 + 1] && valid[b10] && valid[b10 + 1]))
      continue;
    const float4 c00 = clip[b00], c01 = clip[b00 + 1];
    const float4 c10 = clip[b10], c11 = clip[b10 + 1];
    const float s00 = shade[b00], s01 = shade[b00 + 1];
    const float s10 = shade[b10], s11 = shade[b10 + 1];
    for (int f = first; f < frags; f += kGroup) {
      const float4 w = table[f];
      float4 p;
      p.x = blend(c00.x, c01.x, c10.x, c11.x, w);
      p.y = blend(c00.y, c01.y, c10.y, c11.y, w);
      p.z = blend(c00.z, c01.z, c10.z, c11.z, w);
      p.w = blend(c00.w, c01.w, c10.w, c11.w, w);
      splat_fragment(p, blend(s00, s01, s10, s11, w), width, height, fb);
    }
  }
}

// Without upsampling (k <= 1): a thread a vertex in a grid-stride loop.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
frag_kernel(const float4* __restrict__ clip, const float* __restrict__ shade,
            const uint8_t* __restrict__ valid, Index total, int width,
            int height, int* __restrict__ fb) {
  const Index stride = (Index)gridDim.x * blockDim.x;
  for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    if (!valid[i]) continue;
    splat_fragment(clip[i], shade[i], width, height, fb);
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  return sms;
}

int launch_frag(const void* clip, const void* shade, const void* valid,
                int q, int g, int width, int height, void* fb,
                cudaStream_t s) {
  const long long total = (long long)q * g * g;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // as many blocks as the card holds at once (2048 threads an SM)
  const long long blocks = std::min<long long>(
      (total + kThreads - 1) / kThreads, (long long)sms * (2048 / kThreads));
  if (total < (1LL << 31) - kThreads * blocks)
    frag_kernel<unsigned><<<(int)blocks, kThreads, 0, s>>>(
        (const float4*)clip, (const float*)shade, (const uint8_t*)valid,
        (unsigned)total, width, height, (int*)fb);
  else
    frag_kernel<long long><<<(int)blocks, kThreads, 0, s>>>(
        (const float4*)clip, (const float*)shade, (const uint8_t*)valid,
        total, width, height, (int*)fb);
  return (int)cudaGetLastError();
}

template <int kGroup>
int launch_cell(const void* clip, const void* shade, const void* valid,
                int q, int g, int k, int wireframe, int frags, int width,
                int height, void* fb, cudaStream_t s) {
  const dim3 grid((g - 1 + 32 / kGroup - 1) / (32 / kGroup),
                  (g - 1 + kWarps - 1) / kWarps, std::min(q, 65535));
  if ((long long)q * g * g < (1LL << 31))
    cell_kernel<kGroup, unsigned><<<grid, kThreads, 0, s>>>(
        (const float4*)clip, (const float*)shade, (const uint8_t*)valid, q,
        g, k, wireframe, frags, width, height, (int*)fb);
  else
    cell_kernel<kGroup, long long><<<grid, kThreads, 0, s>>>(
        (const float4*)clip, (const float*)shade, (const uint8_t*)valid, q,
        g, k, wireframe, frags, width, height, (int*)fb);
  return (int)cudaGetLastError();
}

// fragments a cell from which two lanes share a cell (k >= 6 without
// wireframe); fewer go to one lane. Measured on an H100 80GB HBM3 at
// 700 W, queued: at k = 8 (64 fragments) one lane a cell took 0.0529 /
// 0.0528 ms on PlanetEngine's 12.9 M fragments / DeviceRenderer's 512
// rows, two 0.0446 / 0.0449, four 0.0427 / 0.0467, eight 0.0449 / 0.0633;
// with wireframe (15) one 0.0214 / 0.0218, two 0.0211 / 0.0237.
constexpr int kPairFrags = 32;

}  // namespace

extern "C" int planet_splat(const void* clip, const void* shade,
                            const void* valid, int q, int g, int k,
                            int wireframe, int width, int height, void* fb,
                            void* stream) {
  if (q < 0 || g < 2 || width < 1 || height < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 1)          // k <= 1 passes the vertices through
    return launch_frag(clip, shade, valid, q, g, width, height, fb, s);
  const int wf = wireframe ? 1 : 0;
  const int frags = wf ? 2 * k - 1 : k * k;
  return frags >= kPairFrags
      ? launch_cell<2>(clip, shade, valid, q, g, k, wf, frags, width, height,
                       fb, s)
      : launch_cell<1>(clip, shade, valid, q, g, k, wf, frags, width, height,
                       fb, s);
}

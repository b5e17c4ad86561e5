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
// Design: a thread a fragment, in a grid-stride loop over as many blocks
// as the card holds at once. Each block first forms the cell's weight table
// in shared memory from (k, wireframe), as the plain version makes it
// (raster/splat.py:weights: fu = j / (k - 1) in double, rounded to f32,
// then the f32 products), so no thread divides for its weights and nothing
// comes from the host (formed by every thread, or by every block of 256
// fragments, the weights made the kernel 1.3-1.5x slower than a table read
// from memory, PERF.md). Fragment f of cell (q, r, c) blends
// the cell's four corners with row f in the plain version's order of
// multiplies and adds, then projects, packs and atomicMins; consecutive
// threads share a cell, so the corner reads are broadcasts from L1. The
// index arithmetic is 32-bit where the fragments fit (every frame here).
// Without upsampling (k <= 1) a thread takes one vertex. Nothing is written
// but the keys of fragments that land on screen. Built with -fmad=false, so
// every product rounds as torch's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrags = 1024;   // k <= 32, a 7680-pixel-wide window

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

// the weights (w00, w01, w10, w11) of fragment f of a cell: rows i, columns
// j of the k x k points, or with wireframe the row i == 0, then the column
// j == 0 below it
__device__ __forceinline__ float4 cell_weights(int f, int k, int wireframe) {
  int i, j;
  if (wireframe) {
    i = f < k ? 0 : f - k + 1;
    j = f < k ? f : 0;
  } else {
    i = f / k;
    j = f % k;
  }
  const float fu = (float)((double)j / (double)(k - 1));
  const float fv = (float)((double)i / (double)(k - 1));
  return make_float4((1.0f - fu) * (1.0f - fv), fu * (1.0f - fv),
                     (1.0f - fu) * fv, fu * fv);
}

// one fragment (fragment f of cell (q, r, c), or vertex i when k <= 1)
template <typename Index>
__device__ __forceinline__ void splat_one(
    Index i, const float4* __restrict__ clip, const float* __restrict__ shade,
    const uint8_t* __restrict__ valid, const float4* table, Index g, int k,
    Index frags, int width, int height, int* __restrict__ fb) {
  float4 p;
  float s;
  if (k > 1) {
    const Index f = i % frags;
    const Index cell = i / frags;
    const Index c = cell % (g - 1);
    const Index t = cell / (g - 1);
    const Index r = t % (g - 1);
    const Index q = t / (g - 1);
    const Index b00 = (q * g + r) * g + c;
    const Index b10 = b00 + g;
    if (!(valid[b00] && valid[b00 + 1] && valid[b10] && valid[b10 + 1]))
      return;
    const float4 w = table[f];
    const float4 c00 = clip[b00], c01 = clip[b00 + 1];
    const float4 c10 = clip[b10], c11 = clip[b10 + 1];
    p.x = blend(c00.x, c01.x, c10.x, c11.x, w);
    p.y = blend(c00.y, c01.y, c10.y, c11.y, w);
    p.z = blend(c00.z, c01.z, c10.z, c11.z, w);
    p.w = blend(c00.w, c01.w, c10.w, c11.w, w);
    s = blend(shade[b00], shade[b00 + 1], shade[b10], shade[b10 + 1], w);
  } else {
    if (!valid[i]) return;
    p = clip[i];
    s = shade[i];
  }
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

template <typename Index>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float4* __restrict__ clip, const float* __restrict__ shade,
             const uint8_t* __restrict__ valid, Index total, Index g, int k,
             int wireframe, Index frags, int width, int height,
             int* __restrict__ fb) {
  __shared__ float4 table[kMaxFrags];
  if (k > 1) {
    for (int f = threadIdx.x; f < (int)frags; f += blockDim.x)
      table[f] = cell_weights(f, k, wireframe);
    __syncthreads();
  }
  const Index stride = (Index)gridDim.x * blockDim.x;
  for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride)
    splat_one<Index>(i, clip, shade, valid, table, g, k, frags, width, height,
                     fb);
}

}  // namespace

extern "C" int planet_splat(const void* clip, const void* shade,
                            const void* valid, int q, int g, int k,
                            int wireframe, int width, int height, void* fb,
                            void* stream) {
  if (q < 0 || g < 2 || width < 1 || height < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  // fragments a cell (k > 1; k <= 1 passes the vertices through)
  const int frags = k <= 1 ? 1 : (wireframe ? 2 * k - 1 : k * k);
  const long long total = k > 1
      ? (long long)q * (g - 1) * (g - 1) * frags
      : (long long)q * g * g;
  if (total == 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the card holds at once (2048 threads an SM)
  const long long blocks = std::min<long long>(
      (total + kThreads - 1) / kThreads, (long long)sms * (2048 / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  const int wf = wireframe ? 1 : 0;
  if (total < (1LL << 31) - kThreads * blocks)
    splat_kernel<unsigned><<<(int)blocks, kThreads, 0, s>>>(
        (const float4*)clip, (const float*)shade, (const uint8_t*)valid,
        (unsigned)total, (unsigned)g, k, wf, (unsigned)frags, width, height,
        (int*)fb);
  else
    splat_kernel<long long><<<(int)blocks, kThreads, 0, s>>>(
        (const float4*)clip, (const float*)shade, (const uint8_t*)valid,
        total, (long long)g, k, wf, (long long)frags, width, height,
        (int*)fb);
  return (int)cudaGetLastError();
}

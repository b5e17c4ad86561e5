// Flat noise kernel (K4): six (n,) f32 double-float coordinate arrays ->
// (n,) f32 multi-octave ridged or fBm noise.
//
// Replaces planet_tpu/ops/kernels/perlin_pallas.py:_make_kernel (launched
// by _build_call through noise_df). Plain PyTorch version:
// planet_tpu_torch/ops/perlin.py:accumulate_octaves with an int octave
// count, which this kernel matches bit for bit; the wrapper is
// planet_tpu_torch/ops/kernels/perlin_cuda.py:noise_df. Users on the
// port's main path: the device refiner's probe heights (5 points per
// frontier slot per level, lod/refine_device.py).
//
// What bounds it on the H100: arithmetic and shared-memory table lookups.
// A point-octave is the same ~300 f32/int and ~30 f64 operations as a
// texel-octave of K1 (tile.cu); a point reads 24 bytes and writes 4, so at
// 6 octaves the kernel does ~70 operations per byte moved — far above the
// card's ~20 f32 operations per byte of HBM bandwidth.
// Design: one thread per point, 256-thread blocks over flat (n,) arrays
// (no 128-lane padding: noise_df's block padding is TPU sizing). The
// permutation table and packed gradient-sign codes live in shared memory,
// as in K1; the octave count, kind, lacunarity path (int24 shifts at 2.0,
// the per-octave double-float frequency table otherwise) and gain are
// arguments. The noise core is noise.cuh, shared with K1.

#include "noise.cuh"

namespace {

using namespace noise_core;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
noise_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
             const float* __restrict__ yh, const float* __restrict__ yl,
             const float* __restrict__ zh, const float* __restrict__ zl,
             const int* __restrict__ perm_g, const int* __restrict__ sign_g,
             const float* __restrict__ freq, float* __restrict__ out, int n,
             int octaves, int ridged, int pow2, float gain) {
  __shared__ int perm[256];
  __shared__ int sign[256];
  load_tables(perm, sign, perm_g, sign_g);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ph[3] = {xh[i], yh[i], zh[i]};
  const float pl[3] = {xl[i], yl[i], zl[i]};
  out[i] = accumulate_octaves(perm, sign, freq, octaves, ridged != 0,
                              pow2 != 0, gain, ph, pl);
}

}  // namespace

extern "C" int planet_noise(const void* xh, const void* xl, const void* yh,
                            const void* yl, const void* zh, const void* zl,
                            const void* perm, const void* sign,
                            const void* freq, void* out, int n, int octaves,
                            int ridged, int pow2, float gain, void* stream) {
  if (n <= 0 || octaves < 0 || octaves > kMaxOctaves)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  noise_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xh, (const float*)xl, (const float*)yh, (const float*)yl,
      (const float*)zh, (const float*)zl, (const int*)perm, (const int*)sign,
      (const float*)freq, (float*)out, n, octaves, ridged, pow2, gain);
  return (int)cudaGetLastError();
}

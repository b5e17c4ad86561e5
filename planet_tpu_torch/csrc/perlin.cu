// Flat noise kernel (K4): six (n,) f32 double-float coordinate arrays ->
// (n,) f32 multi-octave ridged or fBm noise.
//
// Replaces planet_tpu/ops/kernels/perlin_pallas.py:_make_kernel (launched
// by _build_call through noise_df). Plain PyTorch version:
// planet_tpu_torch/ops/perlin.py:accumulate_octaves with an int octave
// count, which this kernel matches bit for bit; the wrapper is
// planet_tpu_torch/ops/kernels/perlin_cuda.py:noise_df. Users on the
// port's main path: the device refiner's probe heights (5 points per
// frontier slot per level, lod/refine_device.py: 20,480 points, 6 ridged
// octaves, 19 launches a frame), and the field path's config 1
// (models/heightfield.heights_df).
//
// What bounds it on the H100: at large n, the noise core's instruction
// throughput (noise.cuh; 24 bytes read and 4 written a point against ~250
// instructions a point-octave). At the refine probes' 20,480 points, the
// launch's fixed cost and one thread's serial chain: 80 blocks of 256
// threads on 132 SMs, each thread running its octaves in series.
//
// Design: one thread per point, the octaves one after another
// (accumulate_octaves), in 256-thread blocks over flat (n,) arrays (no
// 128-lane padding: noise_df's block padding is TPU sizing). The
// permutation and gradient-sign tables live in shared memory, as in K1 and
// K5; the octave count, kind, lacunarity path (int24 shifts at 2.0, the
// per-octave double-float frequency table otherwise) and gain are
// arguments. An octave-parallel layout, a group of 2-8 lanes a point
// folding the octaves in order with __shfl_sync (bit for bit with
// accumulate_octaves), won on the card only below ~17,000 points and tied
// at the probes' 20,480, where the path launches K4, so it is not used
// (PERF.md).

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
  __shared__ Tables<kFast> tab;
  load_tables(tab, perm_g, sign_g);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ph[3] = {xh[i], yh[i], zh[i]};
  const float pl[3] = {xl[i], yl[i], zl[i]};
  out[i] = accumulate_octaves(tab, freq, octaves, ridged != 0, pow2 != 0,
                              gain, ph, pl);
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

// Stage split of the noise core (t_noise) and of the tile texel (t_tile):
// compile-time variants that run a subset of the per-point work, so the
// time of K4, K1 and K5's noise splits into its parts on the card.
//
// Replaces the Pallas microbenchmarks planet_tpu's tools/ built for the
// same split: tools/microbench_stages.py:32 `run` (noise stages) and
// tools/bench_tiles2.py:87 `make` (tile stages). Plain PyTorch versions:
// planet_tpu_torch/tools/noise_stages.py, which each variant equals bit
// for bit; the wrappers are noise_stages.noise_stage / tile_stage.
//
// t_noise, one thread per point, `octaves` ridged octaves at lacunarity 2:
//   0 full            accumulate_octaves: K4's body (perlin.cu)
//   1 splits          int24_parts once, then each octave's shift_frac48
//                     cells and frac_parts (f, f - 1, fade), summed
//   2 splits+gathers  1 plus the 8-corner permutation chain and the 8
//                     gradient-sign lookups of noise3, summed
//   3 hoisted         octave 0's split and fade reused every octave, the x
//                     cell moved by the octave index (noise3 and the ridged
//                     update only; microbench_stages.nosplit_full)
// t_tile, one thread per texel of 32x32 tiles, 6 ridged octaves:
//   0 full            K1's texel (tile.cu): uv, blend, noise, amplitude
//   1 bilinear        the uv and the blend; the six words summed
//   2 noise           the uv as coordinates (u, v, u / 2), noise, amplitude
//
// What bounds them on the H100: the same as K4 and K1 (arithmetic and
// shared-memory lookups; the splits are integer and f64 work). The tables
// are noise.cuh's shared-memory copies, as in K1 and K4.

#include "tile_blend.cuh"

namespace {

using namespace noise_core;

constexpr int kThreads = 256;

// the per-octave split sum of variants 1 and 2 (plain: noise_stages.py)
__device__ __forceinline__ float split_sum(const int* c, const float* f,
                                           const float* fm1,
                                           const float* fd) {
  float s = f[0] + fm1[0];
  s = s + fd[0];
  for (int k = 1; k < 3; ++k) {
    s = s + f[k];
    s = s + fm1[k];
    s = s + fd[k];
  }
  return s + (float)(c[0] + c[1] + c[2]);
}

// noise3's hash chain: the sum of the 8 corners' gradient-sign codes
__device__ __forceinline__ int sign_sum(const int* perm, const int* sign,
                                        const int* c) {
  const int cx = c[0], cy = c[1], cz = c[2];
  const int a0 = perm[cx & 255], a1 = perm[(cx + 1) & 255];
  const int b[4] = {perm[(a0 + cy) & 255], perm[(a0 + cy + 1) & 255],
                    perm[(a1 + cy) & 255], perm[(a1 + cy + 1) & 255]};
  int g = 0;
  for (int j = 0; j < 4; ++j)
    g += sign[(b[j] + cz) & 255] + sign[(b[j] + cz + 1) & 255];
  return g;
}

template <int kStage>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
             const float* __restrict__ yh, const float* __restrict__ yl,
             const float* __restrict__ zh, const float* __restrict__ zl,
             const int* __restrict__ perm_g, const int* __restrict__ sign_g,
             const float* __restrict__ freq, float* __restrict__ out, int n,
             int octaves, float gain) {
  __shared__ int perm[256];
  __shared__ int sign[256];
  if (kStage != 1) load_tables(perm, sign, perm_g, sign_g);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ph[3] = {xh[i], yh[i], zh[i]};
  const float pl[3] = {xl[i], yl[i], zl[i]};
  if (kStage == 0) {
    out[i] = accumulate_octaves(perm, sign, freq, octaves, true, true, gain,
                                ph, pl);
    return;
  }
  int c24[3], h24[3], l24[3];
  for (int k = 0; k < 3; ++k) int24_parts(ph[k], pl[k], c24[k], h24[k], l24[k]);
  float acc = 0.0f;
  if (kStage == 3) {
    int c0[3];
    float f[3], fm1[3], fd[3];
    for (int k = 0; k < 3; ++k) {
      double frac;
      shift_frac48(c24[k], h24[k], l24[k], 0, c0[k], frac);
      frac_parts(frac, f[k], fm1[k], fd[k]);
    }
    float weight = 1.0f, amp = 1.0f;
    for (int o = 0; o < octaves; ++o) {
      const int c[3] = {c0[0] + o, c0[1], c0[2]};
      const float nz = noise3(perm, sign, c, f, fm1, fd);
      float v = 1.0f - fabsf(nz);
      v = v * v;
      acc = acc + (v * amp) * weight;
      weight = v;
      amp = amp * gain;
    }
    out[i] = acc;
    return;
  }
  for (int o = 0; o < octaves; ++o) {
    int c[3];
    float f[3], fm1[3], fd[3];
    for (int k = 0; k < 3; ++k) {
      double frac;
      shift_frac48(c24[k], h24[k], l24[k], o, c[k], frac);
      frac_parts(frac, f[k], fm1[k], fd[k]);
    }
    acc = acc + split_sum(c, f, fm1, fd);
    if (kStage == 2) acc = acc + (float)sign_sum(perm, sign, c);
  }
  out[i] = acc;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
tile_stage_kernel(const float* __restrict__ corners_hi,
                  const float* __restrict__ corners_lo,
                  const int* __restrict__ perm_g,
                  const int* __restrict__ sign_g,
                  const float* __restrict__ freq, float* __restrict__ out,
                  int octaves, float gain, float amplitude, float div_hi,
                  float div_lo) {
  __shared__ int perm[256];
  __shared__ int sign[256];
  if (kMode != 1) load_tables(perm, sign, perm_g, sign_g);

  constexpr int kDim = 32, kBlocksPerTile = kDim * kDim / kThreads;
  const int tile = blockIdx.x / kBlocksPerTile;
  const int texel = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const int x = texel % kDim, y = texel / kDim;
  float uh, ul, vh, vl, ph[3], pl[3];
  tile_uv(x, y, div_hi, div_lo, uh, ul, vh, vl);
  float value;
  if (kMode == 2) {
    ph[0] = uh, pl[0] = ul, ph[1] = vh, pl[1] = vl;
    ph[2] = uh * 0.5f, pl[2] = ul * 0.5f;
  } else {
    tile_blend(corners_hi + (size_t)tile * 12, corners_lo + (size_t)tile * 12,
               uh, ul, vh, vl, ph, pl);
  }
  if (kMode == 1) {
    value = ph[0] + ph[1];
    value = value + ph[2];
    value = value + pl[0];
    value = value + pl[1];
    value = value + pl[2];
  } else {
    value = accumulate_octaves(perm, sign, freq, octaves, true, true, gain,
                               ph, pl) * amplitude;
  }
  out[(size_t)tile * kDim * kDim + texel] = value;
}

}  // namespace

extern "C" int planet_t_noise(int variant, const void* xh, const void* xl,
                              const void* yh, const void* yl, const void* zh,
                              const void* zl, const void* perm,
                              const void* sign, const void* freq, void* out,
                              int n, int octaves, float gain, void* stream) {
  if (n <= 0 || octaves < 0 || octaves > kMaxOctaves)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)xh, (const float*)xl, (const float*)yh,
        (const float*)yl, (const float*)zh, (const float*)zl,
        (const int*)perm, (const int*)sign, (const float*)freq, (float*)out,
        n, octaves, gain);
  };
  switch (variant) {
    case 0: run(stage_kernel<0>); break;
    case 1: run(stage_kernel<1>); break;
    case 2: run(stage_kernel<2>); break;
    case 3: run(stage_kernel<3>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int planet_t_tile(int variant, const void* corners_hi,
                             const void* corners_lo, const void* perm,
                             const void* sign, const void* freq, void* out,
                             int n, int octaves, float gain, float amplitude,
                             float div_hi, float div_lo, void* stream) {
  const long long blocks = (long long)n * 4;
  if (n <= 0 || blocks > 0x7fffffffLL || octaves < 0 || octaves > kMaxOctaves)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)corners_hi, (const float*)corners_lo, (const int*)perm,
        (const int*)sign, (const float*)freq, (float*)out, octaves, gain,
        amplitude, div_hi, div_lo);
  };
  switch (variant) {
    case 0: run(tile_stage_kernel<0>); break;
    case 1: run(tile_stage_kernel<1>); break;
    case 2: run(tile_stage_kernel<2>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

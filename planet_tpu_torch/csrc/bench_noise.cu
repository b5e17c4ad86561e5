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
//   0 full            accumulate_octaves: K4's body (perlin.cu, a thread a
//                     point)
//   1 splits          int24_parts once, then each octave's cells and
//                     (f, f - 1, fade) (noise.cuh octave_split), summed
//   2 splits+gathers  1 plus noise3's permutation chain and gradient-sign
//                     codes (7 pair-table reads), summed
//   3 hoisted         octave 0's split and fade reused every octave, the x
//                     cell moved by the octave index (noise3 and the ridged
//                     update only; microbench_stages.nosplit_full)
//   4 f64conv         full with the first port's fraction: (hi_o, lo_o)
//                     through two int-to-double conversions (kFracConv)
//   5 single_lookups  full with the first port's 14 single table reads, the
//                     sign codes decoded by bits (kSingleLookups)
// Variants 4 and 5 each put one part of the core back in the first port's
// form, so one run shows what each change bought; both equal full bit for
// bit. Variant 2 reads the sign pairs as the 6-bit codes they come in
// (CodePairs), the form its plain version sums.
// t_tile, one thread per texel of 32x32 tiles, 6 ridged octaves:
//   0 full            K1's texel (tile.cu): uv, blend, noise, amplitude
//   1 bilinear        the uv and the blend as K1 does them (the column
//                     terms in shared memory, then the texel's step); the
//                     six words summed
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

// variant 2's shared tables: the permutation and sign-code pairs as they
// come (perlin_cuda.kernel_tables)
struct CodePairs {
  int perm[256];
  int sign[256];
};

__device__ __forceinline__ void load_pairs(CodePairs& t,
                                           const int* __restrict__ perm_g,
                                           const int* __restrict__ sign_g) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    t.perm[i] = perm_g[i];
    t.sign[i] = sign_g[i];
  }
  __syncthreads();
}

// noise3's hash chain through the pair tables (noise.cuh): the sum of the
// 8 corners' gradient-sign codes
__device__ __forceinline__ int sign_sum(const CodePairs& t, const int* c) {
  const int pa = t.perm[slot(c[0], 0)];
  const int pb[2] = {t.perm[slot(pa, c[1])], t.perm[slot(pa >> 16, c[1])]};
  int g = 0;
  for (int j = 0; j < 2; ++j) {
    for (int half = 0; half < 2; ++half) {
      const int s = t.sign[slot(half ? pb[j] >> 16 : pb[j], c[2])];
      g += (s & 0xFFFF) + (s >> 16);
    }
  }
  return g;
}

// the core form of each t_noise variant
__host__ __device__ constexpr int stage_form(int stage) {
  return stage == 4 ? kFracConv : stage == 5 ? kSingleLookups : kFast;
}

template <int kStage>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
             const float* __restrict__ yh, const float* __restrict__ yl,
             const float* __restrict__ zh, const float* __restrict__ zl,
             const int* __restrict__ perm_g, const int* __restrict__ sign_g,
             const float* __restrict__ freq, float* __restrict__ out, int n,
             int octaves, float gain) {
  constexpr int kForm = stage_form(kStage);
  __shared__ Tables<kForm> tab;
  __shared__ CodePairs pairs;
  if (kStage == 2) {
    load_pairs(pairs, perm_g, sign_g);
  } else if (kStage != 1) {
    load_tables(tab, perm_g, sign_g);
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ph[3] = {xh[i], yh[i], zh[i]};
  const float pl[3] = {xl[i], yl[i], zl[i]};
  if (kStage == 0 || kStage >= 4) {
    out[i] = accumulate_octaves(tab, freq, octaves, true, true, gain, ph, pl);
    return;
  }
  PointSplit s;
  split_point(true, ph, pl, s);
  int c[3];
  float f[3], fm1[3], fd[3];
  float acc = 0.0f;
  if (kStage == 3) {
    for (int k = 0; k < 3; ++k)
      octave_split<kFast>(s, k, 0, c[k], f[k], fm1[k], fd[k]);
    const int cx = c[0];
    float weight = 1.0f, amp = 1.0f;
    for (int o = 0; o < octaves; ++o) {
      c[0] = cx + o;
      const float nz = noise3<kFast>(tab.perm, tab.sign, c, f, fm1, fd);
      add_octave(true, gain, nz, acc, weight, amp);
    }
    out[i] = acc;
    return;
  }
  for (int o = 0; o < octaves; ++o) {
    for (int k = 0; k < 3; ++k)
      octave_split<kFast>(s, k, o, c[k], f[k], fm1[k], fd[k]);
    acc = acc + split_sum(c, f, fm1, fd);
    if (kStage == 2) acc = acc + (float)sign_sum(pairs, c);
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
  constexpr int kDim = 32, kBlocksPerTile = kDim * kDim / kThreads;
  __shared__ Tables<kFast> tab;
  __shared__ float columns[kDim * kColumnWords];
  const int tile = blockIdx.x / kBlocksPerTile;
  const int texel = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const int x = texel % kDim, y = texel / kDim;
  float ph[3], pl[3];
  if (kMode == 2) {
    tile_uv(x, div_hi, div_lo, ph[0], pl[0]);
    tile_uv(y, div_hi, div_lo, ph[1], pl[1]);
    ph[2] = ph[0] * 0.5f, pl[2] = pl[0] * 0.5f;
  } else {
    tile_columns(corners_hi + (size_t)tile * 12,
                 corners_lo + (size_t)tile * 12, kDim, div_hi, div_lo,
                 columns);
  }
  if (kMode != 1) load_tables(tab, perm_g, sign_g);    // synchronizes
  else __syncthreads();
  if (kMode != 2) tile_texel(columns, x, y, ph, pl);
  float value;
  if (kMode == 1) {
    value = ph[0] + ph[1];
    value = value + ph[2];
    value = value + pl[0];
    value = value + pl[1];
    value = value + pl[2];
  } else {
    value = accumulate_octaves(tab, freq, octaves, true, true, gain, ph,
                               pl) * amplitude;
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
    case 4: run(stage_kernel<4>); break;
    case 5: run(stage_kernel<5>); break;
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

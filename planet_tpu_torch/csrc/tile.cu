// Heightmap tile kernel: quad corners -> (N, dim, dim) f32 height tiles.
//
// Replaces planet_tpu/ops/kernels/tile_pallas.py:_make_tile_kernel (the
// Pallas tile kernel, which inlines perlin_pallas.accumulate_octaves). Plain
// PyTorch version: planet_tpu_torch/ops/kernels/tile_cuda.py:tiles_plain,
// which this kernel matches bit for bit.
//
// Per texel: overscan uv = (x - 1) / (dim - 3) in double-float, bilinear
// blend of the four coord-scaled double-float corners, N octaves of ridged
// or fBm gradient noise (N from the tile's own octave count), times the
// amplitude. The noise itself (the int24 or per-octave DF split, the
// reference-precision fraction and fade, the ridged/fBm octave loop) is
// the shared core in noise.cuh, which K4 (perlin.cu) runs too; the uv and
// the blend are tile_blend.cuh, which the stage split (bench_noise.cu)
// runs too.
//
// What bounds it on the H100: arithmetic and shared-memory lookups, not
// bytes. A texel-octave is ~300 f32/int operations (24 table reads from
// shared memory, 8 gradient dots, 7 lerps, the shift split) and ~30 f64
// operations (three fades and the narrowing); a tile reads 96 bytes of
// corners (broadcast through L1) and writes 4 KB.
// Design: one thread per texel, one 256-thread block per quarter of a 32x32
// tile, so a tile's texels share their corner loads and octave count (no
// divergence inside a block). The 256-entry permutation table and the
// 256-entry packed gradient-sign codes live in shared memory; the TPU's
// packed pair tables and 128-lane payload are a lane-gather device and are
// not carried over — t[i & 255] is read directly, with the same values.
// A tile's octave count is clamped to kMaxOctaves so that no count can
// read past the frequency table; the callers keep counts within it (the
// plain version refuses larger ones).
//
// Bit-exactness: see noise.cuh (-fmad=false, no fast-math, the plain
// version's op order).

#include "tile_blend.cuh"

namespace {

using namespace noise_core;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tiles_kernel(const float* __restrict__ corners_hi,
             const float* __restrict__ corners_lo,
             const int* __restrict__ octaves, const int* __restrict__ perm_g,
             const int* __restrict__ sign_g, const float* __restrict__ freq,
             float* __restrict__ out, int dim, int blocks_per_tile,
             int ridged, int pow2, float gain, float amplitude, float div_hi,
             float div_lo) {
  __shared__ int perm[256];
  __shared__ int sign[256];
  load_tables(perm, sign, perm_g, sign_g);

  const int tile = blockIdx.x / blocks_per_tile;
  const int texel = (blockIdx.x % blocks_per_tile) * blockDim.x + threadIdx.x;
  if (texel >= dim * dim) return;
  const int x = texel % dim, y = texel / dim;

  float uh, ul, vh, vl, ph[3], pl[3];
  tile_uv(x, y, div_hi, div_lo, uh, ul, vh, vl);
  tile_blend(corners_hi + (size_t)tile * 12, corners_lo + (size_t)tile * 12,
             uh, ul, vh, vl, ph, pl);

  const int count = min(octaves[tile], kMaxOctaves);
  const float value = accumulate_octaves(perm, sign, freq, count, ridged != 0,
                                         pow2 != 0, gain, ph, pl);
  out[(size_t)tile * dim * dim + texel] = value * amplitude;
}

}  // namespace

extern "C" int planet_tiles(const void* corners_hi, const void* corners_lo,
                            const void* octaves, const void* perm,
                            const void* sign, const void* freq, void* out,
                            int n, int dim, int ridged, int pow2, float gain,
                            float amplitude, float div_hi, float div_lo,
                            void* stream) {
  const int blocks_per_tile = (dim * dim + kThreads - 1) / kThreads;
  const long long blocks = (long long)n * blocks_per_tile;
  if (n <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tiles_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)corners_hi, (const float*)corners_lo,
      (const int*)octaves, (const int*)perm, (const int*)sign,
      (const float*)freq, (float*)out, dim, blocks_per_tile, ridged, pow2,
      gain, amplitude, div_hi, div_lo);
  return (int)cudaGetLastError();
}

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
// What bounds it on the H100: instruction throughput, not bytes. A
// texel-octave is the noise core's ~90 f32 and ~40 integer operations, 7
// shared-memory pair-table reads and the f64 fade per axis (noise.cuh); a
// tile reads 96 bytes of corners and writes 4 KB.
// Design: one thread per texel, one 256-thread block per quarter of a 32x32
// tile, so a tile's texels share their corners and octave count (no
// divergence inside a block). The blend is split by what each part depends
// on (tile_blend.cuh): the block computes each column's overscan u and the
// column blends a, b (with the tile's corner differences) once into shared
// memory, and a texel does only its row's step, 2 df_add and 1 df_mul an
// axis (~150 f32 operations a texel instead of ~400, each error-free
// product a multiply and an FMA). A tile whose octave count is 0 — most of
// the fused frame's generation slots, which hold no leaf — writes
// 0 * amplitude, the plain version's value whatever its corners hold, and
// skips the tables, the blend and the noise; the count is uniform in a
// block, so the whole block leaves at once. The permutation table and the
// packed gradient-sign codes live in shared memory as 256-entry pair
// tables (each entry with its neighbour, noise.cuh), which halves the
// hash's reads; the TPU's 128-lane payload is a lane-gather device and is
// not carried over. A tile's octave count is clamped to kMaxOctaves so
// that no count can read past the frequency table; the callers keep
// counts within it (the plain version refuses larger ones). The grid comes
// from n and dim only, so the launch can be captured in a CUDA graph.
// Blocks start in index order, so with mixed octave counts the last long
// tiles to start set the end (~10 % of the time at 6-18 octaves); ordering
// the tiles longest first inside the kernel (a histogram and a rank
// search a block) won that back only in part and lost at the fused frame's
// occupancy, so the order stays (PERF.md).
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
  extern __shared__ float columns[];     // dim x kColumnWords
  __shared__ Tables<kFast> tab;

  const int tile = blockIdx.x / blocks_per_tile;
  const int texel = (blockIdx.x % blocks_per_tile) * blockDim.x + threadIdx.x;
  float* dst = out + (size_t)tile * dim * dim;
  const int count = min(octaves[tile], kMaxOctaves);
  if (count <= 0) {
    if (texel < dim * dim) dst[texel] = 0.0f * amplitude;
    return;
  }
  tile_columns(corners_hi + (size_t)tile * 12,
               corners_lo + (size_t)tile * 12, dim, div_hi, div_lo, columns);
  load_tables(tab, perm_g, sign_g);      // synchronizes the block
  if (texel >= dim * dim) return;

  float ph[3], pl[3];
  tile_texel(columns, texel % dim, texel / dim, ph, pl);
  const float value = accumulate_octaves(tab, freq, count, ridged != 0,
                                         pow2 != 0, gain, ph, pl);
  dst[texel] = value * amplitude;
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
  const size_t shared = (size_t)dim * kColumnWords * sizeof(float);
  if (n <= 0 || dim <= 0 || blocks > 0x7fffffffLL || shared > 32768)
    return (int)cudaErrorInvalidValue;
  tiles_kernel<<<(unsigned)blocks, kThreads, shared, (cudaStream_t)stream>>>(
      (const float*)corners_hi, (const float*)corners_lo,
      (const int*)octaves, (const int*)perm, (const int*)sign,
      (const float*)freq, (float*)out, dim, blocks_per_tile, ridged, pow2,
      gain, amplitude, div_hi, div_lo);
  return (int)cudaGetLastError();
}


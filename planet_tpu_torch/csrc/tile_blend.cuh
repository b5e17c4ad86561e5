// A tile texel's noise-space point: the overscan uv and the double-float
// bilinear blend of the tile's four coord-scaled corners, split by what
// each part depends on. Shared by the tile kernel (tile.cu, K1) and its
// stage split (bench_noise.cu, t_tile), so the split's "full" variant is
// K1's texel bit for bit. Plain PyTorch version:
// ops/kernels/tile_cuda.py:tile_coords, which computes the same operations
// on u as (1, 1, dim) and v as (1, dim, 1) broadcasts.
//
// Per axis, p = a + (b - a) v with a = p0 + (p1 - p0) u and b = p2 +
// (p3 - p2) u: p1 - p0 and p3 - p2 depend on the tile, u, a and b on the
// column, v on the row. tile_columns computes each column's u, a and b once
// into shared memory (the tile terms with them); tile_texel does the
// texel's own 2 df_add and 1 df_mul an axis. Each operation has the same
// inputs as in the unsplit blend, so the bits are the same.
//
// Bit-exactness: see noise.cuh (-fmad=false, no fast-math, the plain
// version's op order).

#pragma once

#include "noise.cuh"

namespace noise_core {

// shared-memory words a column: u (hi, lo), then (ah, al, bh, bl) an axis;
// odd, so a warp's 32 columns fall in 32 distinct banks
constexpr int kColumnWords = 15;

// the overscan coordinate (i - 1) * div of column or row i as a
// double-float pair, div the (hi, lo) split of 1 / (dim - 3): u of column
// i and v of row i are the same pair
__device__ __forceinline__ void tile_uv(int i, float div_hi, float div_lo,
                                        float& h, float& l) {
  df_scale((float)(i - 1), 0.0f, div_hi, div_lo, false, h, l);
}

// s[x * kColumnWords ...] for every column x < dim: u and per axis
// a = p0 + (p1 - p0) u, b = p2 + (p3 - p2) u, one (column, axis) a thread;
// ch/cl are one tile's (4, 3) corner words. The caller synchronizes the
// block before reading s.
__device__ __forceinline__ void tile_columns(const float* ch, const float* cl,
                                             int dim, float div_hi,
                                             float div_lo, float* s) {
  for (int i = threadIdx.x; i < 3 * dim; i += blockDim.x) {
    const int x = i / 3, k = i - 3 * x;
    float* c = s + x * kColumnWords;
    float uh, ul, v0h, v0l, v1h, v1l, t0h, t0l, t1h, t1l;
    tile_uv(x, div_hi, div_lo, uh, ul);
    if (k == 0) c[0] = uh, c[1] = ul;
    df_add(ch[3 + k], cl[3 + k], -ch[k], -cl[k], v0h, v0l);
    df_add(ch[9 + k], cl[9 + k], -ch[6 + k], -cl[6 + k], v1h, v1l);
    df_mul(v0h, v0l, uh, ul, t0h, t0l);
    df_add(ch[k], cl[k], t0h, t0l, c[2 + 4 * k], c[3 + 4 * k]);
    df_mul(v1h, v1l, uh, ul, t1h, t1l);
    df_add(ch[6 + k], cl[6 + k], t1h, t1l, c[4 + 4 * k], c[5 + 4 * k]);
  }
}

// the point of texel (x, y) from tile_columns' s: p = a + (b - a) v per
// axis, v the overscan coordinate of row y (column y's u)
__device__ __forceinline__ void tile_texel(const float* s, int x, int y,
                                           float* ph, float* pl) {
  const float* c = s + x * kColumnWords;
  const float vh = s[y * kColumnWords], vl = s[y * kColumnWords + 1];
  for (int k = 0; k < 3; ++k) {
    const float ah = c[2 + 4 * k], al = c[3 + 4 * k];
    float dvh, dvl, t2h, t2l;
    df_add(c[4 + 4 * k], c[5 + 4 * k], -ah, -al, dvh, dvl);
    df_mul(dvh, dvl, vh, vl, t2h, t2l);
    df_add(ah, al, t2h, t2l, ph[k], pl[k]);
  }
}

}  // namespace noise_core

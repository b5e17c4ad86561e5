// A tile texel's noise-space point: the overscan uv of texel (x, y) and the
// double-float bilinear blend of the tile's four coord-scaled corners.
// Shared by the tile kernel (tile.cu, K1) and its stage split
// (bench_noise.cu, t_tile), so the split's "full" variant is K1's texel bit
// for bit. Plain PyTorch version: ops/kernels/tile_cuda.py:tile_coords.
//
// Bit-exactness: see noise.cuh (-fmad=false, no fast-math, the plain
// version's op order).

#pragma once

#include "noise.cuh"

namespace noise_core {

// u = (x - 1) * div, v = (y - 1) * div as double-float pairs, div the
// (hi, lo) split of 1 / (dim - 3)
__device__ __forceinline__ void tile_uv(int x, int y, float div_hi,
                                        float div_lo, float& uh, float& ul,
                                        float& vh, float& vl) {
  df_scale((float)(x - 1), 0.0f, div_hi, div_lo, false, uh, ul);
  df_scale((float)(y - 1), 0.0f, div_hi, div_lo, false, vh, vl);
}

// p = a + (b - a) v with a = p0 + (p1 - p0) u and b = p2 + (p3 - p2) u, per
// axis, in double-float; ch/cl are one tile's (4, 3) corner words
__device__ __forceinline__ void tile_blend(const float* ch, const float* cl,
                                           float uh, float ul, float vh,
                                           float vl, float* ph, float* pl) {
  for (int k = 0; k < 3; ++k) {
    float v0h, v0l, v1h, v1l, t0h, t0l, ah, al, t1h, t1l, bh, bl, dvh, dvl,
        t2h, t2l;
    df_add(ch[3 + k], cl[3 + k], -ch[k], -cl[k], v0h, v0l);
    df_add(ch[9 + k], cl[9 + k], -ch[6 + k], -cl[6 + k], v1h, v1l);
    df_mul(v0h, v0l, uh, ul, t0h, t0l);
    df_add(ch[k], cl[k], t0h, t0l, ah, al);
    df_mul(v1h, v1l, uh, ul, t1h, t1l);
    df_add(ch[6 + k], cl[6 + k], t1h, t1l, bh, bl);
    df_add(bh, bl, -ah, -al, dvh, dvl);
    df_mul(dvh, dvl, vh, vl, t2h, t2l);
    df_add(ah, al, t2h, t2l, ph[k], pl[k]);
  }
}

}  // namespace noise_core

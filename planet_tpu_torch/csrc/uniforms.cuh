// The uniforms' arithmetic, one copy for its two kernels: U1
// (uniforms.cu, the uniforms as a kernel of their own, written to memory)
// and V1's rows mode (tess.cu, the same values computed into V1's
// shared-memory staging). Each function is one part of
// tess/uniforms_cuda.uniforms_plain, op for op in its order, so both
// kernels equal it bit for bit; every file that includes this is built
// with -fmad=false -prec-div=true -prec-sqrt=true, so no sum or product is
// contracted and the division and root are IEEE's.

#pragma once

#include <cuda_runtime.h>

namespace uniforms_core {

// nums/df.two_sum
__device__ __forceinline__ void two_sum(float a, float b, float* s,
                                        float* err) {
  *s = a + b;
  const float bb = *s - a;
  *err = (a - (*s - bb)) + (b - bb);
}

// nums/df.sub((h, l), (cam_h, cam_l)) = df.add with the camera negated: its
// hi word, the corner's camera-relative position on one axis
__device__ __forceinline__ float df_sub_hi(float h, float l, float cam_h,
                                           float cam_l) {
  float s, e, u, f;
  two_sum(h, -cam_h, &s, &e);
  two_sum(l, -cam_l, &u, &f);
  e = e + u;
  const float s1 = s + e;
  e = e - (s1 - s);
  e = e + f;
  return s1 + e;
}

// The root a corner's normal is divided by: nrm = c_hi + c_lo, its length
// sqrt((x x + y y) + z z). A padding row's zero corners give 0, and its
// normal 0 / 0, the card's NaN word 0x7fffffff.
__device__ __forceinline__ float normal_len(const float* nrm) {
  return sqrtf((nrm[0] * nrm[0] + nrm[1] * nrm[1]) + nrm[2] * nrm[2]);
}

// The crop variants (vx, vy) of a row: 0 unless cropped, else 1 + the
// child index's bits; geom/quadid.words_child_index, the digit at
// 2 (depth - 1) of the id's words (a depth-0 id reads digit 0)
__device__ __forceinline__ void crop_variants(int lo, int hi, bool crop,
                                              int* vx, int* vy) {
  int x = 0, y = 0;
  if (crop) {
    const int pos = 2 * (((hi >> 23) & 31) - 1);
    const int child = pos < 32 ? (lo >> (pos < 0 ? 0 : pos)) & 3
                               : (hi >> (pos - 32)) & 3;
    x = 1 + (child & 1);
    y = 1 + ((child >> 1) & 1);
  }
  *vx = x;
  *vy = y;
}

// The skirt of a row at `depth`: max_skirt / 2^(depth - 1 + 1) past depth
// 1, else max_skirt (exp2f and an IEEE division, as torch's exp2 and
// division on the card)
__device__ __forceinline__ float skirt_of(int depth, float max_skirt) {
  const float d1 = (float)(depth - 1);
  return d1 > 0.0f ? max_skirt / exp2f(d1 + 1.0f) : max_skirt;
}

}  // namespace uniforms_core

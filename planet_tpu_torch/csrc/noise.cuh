// Device noise core shared by the tile kernel (tile.cu, K1) and the flat
// noise kernel (perlin.cu, K4): double-float helpers, the FLOOR-macro and
// int24 cell/fraction splits, one octave of gradient noise and the
// multi-octave ridged/fBm loop. One implementation, so K1 and K4 give the
// same height for the same point and octave count, and each equals its
// plain PyTorch version (planet_tpu_torch/ops/perlin.py) bit for bit.
//
// Replaces the noise core that planet_tpu's Pallas kernels inline
// (planet_tpu/ops/kernels/perlin_pallas.py: accumulate_octaves,
// _noise3_core, _int24_parts, _shift_split24, _floor_split_df, _df_scale).
// Each octave's fraction is narrowed to f32 from the exact double and the
// fade is evaluated in double — the reference's precision (perlin.h:52-75),
// which the TPU kernel approximates in f32; see ops/perlin.py for why.
//
// Bit-exactness: every file that includes this is built with -fmad=false
// (the error-free transforms break under FMA contraction) and no
// fast-math; every expression keeps the op order of the plain version (f64
// included: -fmad=false keeps DFMA out too). Left shifts of possibly
// negative cells go through uint32_t (a signed left shift of a negative
// value is undefined in C++17); the arithmetic right shifts of int32 are
// what XLA and torch do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace noise_core {

constexpr int kM24 = (1 << 24) - 1;
constexpr float kSplit = 4097.0f;
// octave counts above this are refused by the wrappers (int24 octave
// shifts and the (kMaxOctaves, 3) frequency table)
constexpr int kMaxOctaves = 24;

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s,
                                              float& e) {
  s = a + b;
  e = b - (s - a);
}

__device__ __forceinline__ void df_add(float ah, float al, float bh, float bl,
                                       float& rh, float& rl) {
  float s, e, t, f;
  two_sum(ah, bh, s, e);
  two_sum(al, bl, t, f);
  e = e + t;
  quick_two_sum(s, e, s, e);
  e = e + f;
  quick_two_sum(s, e, rh, rl);
}

__device__ __forceinline__ void df_mul(float ah, float al, float bh, float bl,
                                       float& rh, float& rl) {
  float p = ah * bh;
  float ca = ah * kSplit;
  float xhi = ca - (ca - ah);
  float xlo = ah - xhi;
  float cb = bh * kSplit;
  float yhi = cb - (cb - bh);
  float ylo = bh - yhi;
  float err = ((xhi * yhi - p) + xhi * ylo + xlo * yhi) + xlo * ylo;
  err = err + (ah * bl + al * bh);
  quick_two_sum(p, err, rh, rl);
}

// double-float x times the (hi, lo) constant c; exact power-of-two scaling
// when `pow2` (perlin.is_pow2_scale), the Dekker product otherwise
__device__ __forceinline__ void df_scale(float xh, float xl, float chi,
                                         float clo, bool pow2, float& rh,
                                         float& rl) {
  if (pow2) {
    rh = xh * chi;
    rl = xl * chi;
    return;
  }
  float cb = kSplit * chi;
  float bhi = cb - (cb - chi);
  float blo = chi - bhi;
  float p = xh * chi;
  float ca = xh * kSplit;
  float ahi = ca - (ca - xh);
  float alo = xh - ahi;
  float err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo;
  err = err + (xh * clo + xl * chi);
  quick_two_sum(p, err, rh, rl);
}

// FLOOR-macro cell + fraction as a normalized double-float pair
__device__ __forceinline__ void floor_split_parts(float hi, float lo, int& cell,
                                                  float& fh, float& fl) {
  float cell_f = hi < 0.0f ? truncf(hi - 1.0f) : truncf(hi);
  float d, derr, f, e;
  two_sum(hi, -cell_f, d, derr);
  two_sum(d, lo, f, e);
  e = e + derr;
  quick_two_sum(f, e, f, e);
  float adj = floorf(f);
  if (f == 1.0f && e <= 0.0f) adj = 0.0f;
  cell = (int)cell_f + (int)adj;
  float ff, ferr;
  two_sum(f, -adj, ff, ferr);
  quick_two_sum(ff, e + ferr, fh, fl);
}

__device__ __forceinline__ void int24_parts(float hi, float lo, int& cell,
                                            int& hi24, int& lo24) {
  float fh, fl;
  floor_split_parts(hi, lo, cell, fh, fl);
  float t = fh * 16777216.0f;
  float hi_f = truncf(t);
  float r = t - hi_f;
  float lo_f = floorf(r * 16777216.0f + fl * 281474976710656.0f);
  int lo_i = (int)lo_f;
  int hi_i = (int)hi_f + (lo_i >> 24);
  lo_i = lo_i & kM24;
  cell = cell + (hi_i >> 24);
  hi24 = hi_i & kM24;
  lo24 = lo_i;
}

// octave-o cell and the fraction's full 48 bits as an exact double
__device__ __forceinline__ void shift_frac48(int cell, int hi24, int lo24,
                                             int o, int& cell_o,
                                             double& frac) {
  int hi_o = hi24, lo_o = lo24;
  cell_o = cell;
  if (o) {
    cell_o = (int)(((uint32_t)cell << o) + (uint32_t)(hi24 >> (24 - o)));
    hi_o = (int)(((uint32_t)hi24 << o) | (uint32_t)(lo24 >> (24 - o))) & kM24;
    lo_o = (int)((uint32_t)lo24 << o) & kM24;
  }
  frac = (double)hi_o * 0x1p-24 + (double)lo_o * 0x1p-48;
}

// (frac, frac - 1, fade) narrowed to f32 from the exact double fraction,
// the fade evaluated in double (the reference's precision, perlin.h:62-75)
__device__ __forceinline__ void frac_parts(double t, float& f, float& fm1,
                                           float& fade) {
  f = (float)t;
  fm1 = (float)(t - 1.0);
  fade = (float)(((t * 6.0 - 15.0) * t + 10.0) * t * t * t);
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + (b - a) * t;
}

__device__ __forceinline__ float grad_dot(int s, float gx, float gy, float gz) {
  float sx = (float)(s & 3) - 1.0f;
  float sy = (float)((s >> 2) & 3) - 1.0f;
  float sz = (float)((s >> 4) & 3) - 1.0f;
  return (gx * sx + gy * sy) + gz * sz;
}

__device__ __forceinline__ float noise3(const int* perm, const int* sign,
                                        const int* c, const float* f,
                                        const float* fm1, const float* fd) {
  const int cx = c[0], cy = c[1], cz = c[2];
  const float fx = f[0], fy = f[1], fz = f[2];
  const float fxm1 = fm1[0], fym1 = fm1[1], fzm1 = fm1[2];
  const float u = fd[0], v = fd[1], w = fd[2];
  int a0 = perm[cx & 255], a1 = perm[(cx + 1) & 255];
  int b00 = perm[(a0 + cy) & 255], b01 = perm[(a0 + cy + 1) & 255];
  int b10 = perm[(a1 + cy) & 255], b11 = perm[(a1 + cy + 1) & 255];
  float g000 = grad_dot(sign[(b00 + cz) & 255], fx, fy, fz);
  float g001 = grad_dot(sign[(b00 + cz + 1) & 255], fx, fy, fzm1);
  float g010 = grad_dot(sign[(b01 + cz) & 255], fx, fym1, fz);
  float g011 = grad_dot(sign[(b01 + cz + 1) & 255], fx, fym1, fzm1);
  float g100 = grad_dot(sign[(b10 + cz) & 255], fxm1, fy, fz);
  float g101 = grad_dot(sign[(b10 + cz + 1) & 255], fxm1, fy, fzm1);
  float g110 = grad_dot(sign[(b11 + cz) & 255], fxm1, fym1, fz);
  float g111 = grad_dot(sign[(b11 + cz + 1) & 255], fxm1, fym1, fzm1);
  float x00 = lerp(g000, g100, u);
  float x10 = lerp(g010, g110, u);
  float x01 = lerp(g001, g101, u);
  float x11 = lerp(g011, g111, u);
  return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w);
}

// Copy the 256-entry permutation table and packed gradient-sign codes into
// the block's shared memory (every thread of the block must call this).
__device__ __forceinline__ void load_tables(int* perm, int* sign,
                                            const int* __restrict__ perm_g,
                                            const int* __restrict__ sign_g) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    perm[i] = perm_g[i];
    sign[i] = sign_g[i];
  }
  __syncthreads();
}

// `count` octaves of ridged (v = (1 - |n|)^2, unclamped weight feedback) or
// fBm noise at the double-float point (ph, pl); planet_tpu_torch
// ops/perlin.accumulate_octaves. Lacunarity 2.0 (`pow2`) takes the
// octave-parallel int24 split; any other lacunarity scales the point per
// octave by freq[3*i] (hi), freq[3*i + 1] (lo), freq[3*i + 2] != 0 (exact
// power of two) and re-splits it. count must not exceed kMaxOctaves.
__device__ __forceinline__ float accumulate_octaves(
    const int* perm, const int* sign, const float* __restrict__ freq,
    int count, bool ridged, bool pow2, float gain, const float* ph,
    const float* pl) {
  float value = 0.0f, weight = 1.0f, amp = 1.0f;
  int c24[3], h24[3], l24[3];
  if (pow2) {
    for (int k = 0; k < 3; ++k) int24_parts(ph[k], pl[k], c24[k], h24[k], l24[k]);
  }
  for (int i = 0; i < count; ++i) {
    int c[3];
    float f[3], fm1[3], fd[3];
    for (int k = 0; k < 3; ++k) {
      double frac;
      if (pow2) {
        shift_frac48(c24[k], h24[k], l24[k], i, c[k], frac);
      } else {
        float oh, ol, fh, fl;
        df_scale(ph[k], pl[k], freq[3 * i], freq[3 * i + 1],
                 freq[3 * i + 2] != 0.0f, oh, ol);
        floor_split_parts(oh, ol, c[k], fh, fl);
        frac = (double)fh + (double)fl;
      }
      frac_parts(frac, f[k], fm1[k], fd[k]);
    }
    const float n = noise3(perm, sign, c, f, fm1, fd);
    if (ridged) {
      float v = 1.0f - fabsf(n);
      v = v * v;
      value = value + (v * amp) * weight;
      weight = v;
    } else {
      value = value + n * amp;
    }
    amp = amp * gain;
  }
  return value;
}

}  // namespace noise_core

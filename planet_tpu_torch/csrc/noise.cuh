// Device noise core shared by the tile kernel (tile.cu, K1), the flat noise
// kernel (perlin.cu, K4) and the field kernel (field.cu, K5): double-float
// helpers, the FLOOR-macro and int24 cell/fraction splits, one octave of
// gradient noise and the multi-octave ridged/fBm loop. One implementation,
// so K1, K4 and K5 give the same height for the same point and octave
// count, and each equals its plain PyTorch version
// (planet_tpu_torch/ops/perlin.py) bit for bit.
//
// Replaces the noise core that planet_tpu's Pallas kernels inline
// (planet_tpu/ops/kernels/perlin_pallas.py: accumulate_octaves,
// _noise3_core, _int24_parts, _shift_split24, _floor_split_df, _df_scale).
// Each octave's fraction is rounded to f32 from the exact fraction and the
// fade is evaluated in double — the reference's precision (perlin.h:52-75),
// which the TPU kernel approximates in f32; see ops/perlin.py for why.
//
// What bounds it on the H100: instruction throughput. A point-octave is ~250
// instructions: per axis the octave's cell and fraction, the f64 fade and
// three narrowings (~19), the hash (7 shared-memory reads and their
// indices, ~21), eight gradient dots (~60), seven lerps (21) and the
// octave update; the f64 and conversion pipes, and shared memory, are
// busy a fraction of that time. So the design cuts instructions, not slow
// conversions as such: the first port's fraction (two int-to-double
// conversions of the 24-bit words) timed faster than building the double by
// its bits with f, f - 1 as f32 two-term sums, which runs more instructions
// for fewer conversions (PERF.md, t_noise). The parts:
// - Octave fraction at lacunarity 2 (octave_split). The point's 48 fraction
//   bits are one word v48 = hi24 << 24 | lo24; octave o's fraction is
//   (v48 << o) mod 2^48, exact in a double after one conversion and a
//   multiply by 2^-48, equal to hi_o 2^-24 + lo_o 2^-48 of the two shifted
//   24-bit words. f, f - 1 and the fade are narrowed from it as the
//   reference does (frac_parts). The general-lacunarity path keeps the f64
//   sum of its double-float fraction.
// - Pair tables. perm and the gradient-sign codes come as 256 int32 pairs,
//   t2[i] = t[i] | t[(i + 1) & 255] << 16 (perlin_cuda.kernel_tables), so
//   noise3 reads each lookup together with its neighbour: 7 reads a
//   point-octave instead of 14. The low half needs no mask: (t2[i] + c) &
//   255 = (t[i] + c) & 255.
// - Gradient signs as f32 halves. load_tables expands the sign pairs in
//   shared memory: entry i holds the six signs of codes i and i + 1 as the
//   top 16 bits of their f32 values (float)field - 1 (+-1 and +0 have zero
//   low halves), one 16-byte read a pair, each sign one mask or shift:
//   the code's 3 x (shift, mask, add) decode goes.
// - Error-free products. df_mul and df_scale (and field.cu's two_prod) take
//   a product's rounding error as fmaf(a, b, -p): the error of an f32
//   product is exact in f32 (barring underflow, far below any coordinate
//   here), so the FMA returns the value of Dekker's split (and +0.0f where
//   the error is zero, as the split's sums do): the product and its error
//   in two instructions (the multiply and the FMA) instead of Dekker's ~17.
// Two other forms (kForm bits) put one part back as the first port had it,
// for bench_noise.cu to time beside kFast: the fraction from the two
// shifted 24-bit words through two int-to-double conversions, and 14 single
// table reads with the 6-bit sign codes decoded by bits (2^23 + x minus
// 2^23 + 1 in f32: (float)x - 1, +0.0f at x = 1; as fast as the first
// port's int-to-float decode, which compiles to the fast I2FP). Measured and
// not kept (PERF.md): f and f - 1 as f32 two-term sums, hi_o 2^-24 +
// lo_o 2^-48 and (hi_o 2^-24 - 1) + lo_o 2^-48 (each term exact in f32, so
// IEEE addition rounds the exact sum once: (float)t and (float)(t - 1) bit
// for bit), with t built from its bits; and the sign pairs kept as codes.
//
// Bit-exactness: every file that includes this is built with -fmad=false
// (the error-free transforms break under FMA contraction; the explicit
// fmaf above is allowed) and no fast-math; every expression keeps the op
// order of the plain version (f64 included: -fmad=false keeps DFMA out too).
// Left shifts of possibly negative cells go through uint32_t (a signed left
// shift of a negative value is undefined in C++17); the arithmetic right
// shifts of int32 are what XLA and torch do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace noise_core {

constexpr int kM24 = (1 << 24) - 1;
// octave counts above this are refused by the wrappers (int24 octave
// shifts and the (kMaxOctaves, 3) frequency table)
constexpr int kMaxOctaves = 24;

// Forms of the core, as bits: 0 (kFast) is the one K1, K4 and K5 run; each
// other bit swaps one part for another form that gives the same bits
// (bench_noise.cu times them beside kFast).
constexpr int kFast = 0;
constexpr int kFracConv = 1;      // the fraction from (hi_o, lo_o) by two
                                  // int-to-double conversions (the first
                                  // port's)
constexpr int kSingleLookups = 2; // 14 single table reads, the sign
                                  // codes decoded by bits (unit_sign)

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

// p = a * b and its exact rounding error (Dekker's two_prod, as one FMA)
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& err) {
  p = a * b;
  err = fmaf(a, b, -p);
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
  float p, err;
  two_prod(ah, bh, p, err);
  err = err + (ah * bl + al * bh);
  quick_two_sum(p, err, rh, rl);
}

// double-float x times the (hi, lo) constant c; exact power-of-two scaling
// when `pow2` (perlin.is_pow2_scale), the error-free product otherwise
__device__ __forceinline__ void df_scale(float xh, float xl, float chi,
                                         float clo, bool pow2, float& rh,
                                         float& rl) {
  if (pow2) {
    rh = xh * chi;
    rl = xl * chi;
    return;
  }
  float p, err;
  two_prod(xh, chi, p, err);
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

// octave-o cell and the fraction's 48 bits as two 24-bit words (o in
// [0, 23]; o = 0 leaves the split as it is)
__device__ __forceinline__ void shift_parts(int cell, int hi24, int lo24,
                                            int o, int& cell_o, int& hi_o,
                                            int& lo_o) {
  cell_o = (int)(((uint32_t)cell << o) + (uint32_t)(hi24 >> (24 - o)));
  hi_o = (int)(((uint32_t)hi24 << o) | (uint32_t)(lo24 >> (24 - o))) & kM24;
  lo_o = (int)((uint32_t)lo24 << o) & kM24;
}

// the quintic fade of the exact fraction, in double, narrowed once
__device__ __forceinline__ float fade64(double t) {
  return (float)(((t * 6.0 - 15.0) * t + 10.0) * t * t * t);
}

// (frac, frac - 1, fade) narrowed to f32 from an exact double fraction
__device__ __forceinline__ void frac_parts(double t, float& f, float& fm1,
                                           float& fade) {
  f = (float)t;
  fm1 = (float)(t - 1.0);
  fade = fade64(t);
}

// A point's octave-independent split: at lacunarity 2 (`pow2`) the int24
// cell and fraction words of each axis (octave 0) and the fraction as one
// 48-bit word; nothing otherwise.
struct PointSplit {
  int c24[3], h24[3], l24[3];
  uint64_t v48[3];
};

__device__ __forceinline__ void split_point(bool pow2, const float* ph,
                                            const float* pl, PointSplit& s) {
  if (pow2) {
    for (int k = 0; k < 3; ++k) {
      int24_parts(ph[k], pl[k], s.c24[k], s.h24[k], s.l24[k]);
      s.v48[k] = (uint64_t)(uint32_t)s.h24[k] << 24 | (uint32_t)s.l24[k];
    }
  }
}

// octave o's cell and (frac, frac - 1, fade) on axis k at lacunarity 2, both
// forms equal bit for bit to frac_parts(hi_o 2^-24 + lo_o 2^-48) of
// shift_parts (see the note at the top)
template <int kForm>
__device__ __forceinline__ void octave_split(const PointSplit& s, int k, int o,
                                             int& cell, float& f, float& fm1,
                                             float& fade) {
  if constexpr ((kForm & kFracConv) != 0) {
    int hi_o, lo_o;
    shift_parts(s.c24[k], s.h24[k], s.l24[k], o, cell, hi_o, lo_o);
    frac_parts((double)hi_o * 0x1p-24 + (double)lo_o * 0x1p-48, f, fm1, fade);
    return;
  }
  cell = (int)(((uint32_t)s.c24[k] << o) + (uint32_t)(s.h24[k] >> (24 - o)));
  const uint64_t v = (s.v48[k] << o) & ((1ULL << 48) - 1);
  frac_parts(__ull2double_rn(v) * 0x1p-48, f, fm1, fade);
}

// the table slot (a + b) & 255, added with wraparound (cells of high
// octaves use all 32 bits; signed overflow would be undefined)
__device__ __forceinline__ int slot(int a, int b) {
  return (int)(((uint32_t)a + (uint32_t)b) & 255u);
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + (b - a) * t;
}

// (float)x - 1.0f for a 2-bit sign field x, bit for bit
__device__ __forceinline__ float unit_sign(int x) {
  return __int_as_float(0x4B000000 | x) - 8388609.0f;
}

__device__ __forceinline__ float dot3(float sx, float sy, float sz, float gx,
                                      float gy, float gz) {
  return (gx * sx + gy * sy) + gz * sz;
}

// the packed code's gradient (x | y << 2 | z << 4, each field sign + 1)
// dotted with (gx, gy, gz); `s` may carry other bits above bit 5
__device__ __forceinline__ float grad_dot(int s, float gx, float gy,
                                          float gz) {
  return dot3(unit_sign(s & 3), unit_sign((s >> 2) & 3),
              unit_sign((s >> 4) & 3), gx, gy, gz);
}

// The block's shared copies of the tables: the permutation pairs, and the
// gradient-sign pairs as f32 halves (entry i holds the six signs of codes i
// and i + 1 as the top 16 bits of their f32 values, 4 words, read as one
// int4); kSingleLookups: the single permutation and sign-code tables.
template <int kForm>
struct Tables {
  int perm[256];
  __align__(16) int sign[(kForm & kSingleLookups) != 0 ? 256 : 1024];
};

// top half of the f32 (float)x - 1 of a 2-bit sign field (low half zero)
__device__ __forceinline__ uint32_t sign_top(int code, int field) {
  return (uint32_t)__float_as_int((float)((code >> (2 * field)) & 3) - 1.0f)
         >> 16;
}

// Copy the permutation and packed gradient-sign pair tables into the
// block's shared memory (every thread of the block must call this).
template <int kForm>
__device__ __forceinline__ void load_tables(Tables<kForm>& t,
                                            const int* __restrict__ perm_g,
                                            const int* __restrict__ sign_g) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int p = perm_g[i], s = sign_g[i];
    if constexpr ((kForm & kSingleLookups) != 0) {
      t.perm[i] = p & 0xFFFF;
      t.sign[i] = s & 0xFFFF;
    } else {
      t.perm[i] = p;
      const int a = s & 0xFFFF, b = s >> 16;
      t.sign[4 * i] = (int)(sign_top(a, 0) << 16 | sign_top(a, 1));
      t.sign[4 * i + 1] = (int)(sign_top(a, 2) << 16 | sign_top(b, 0));
      t.sign[4 * i + 2] = (int)(sign_top(b, 1) << 16 | sign_top(b, 2));
      t.sign[4 * i + 3] = 0;
    }
  }
  __syncthreads();
}

// the two corners of a sign-halves entry: (code a dotted with g, code b
// dotted with g') for the corners at z and z + 1
__device__ __forceinline__ void halves_dots(const int* sign, int i, float gx,
                                            float gy, float gz, float gzm1,
                                            float& ga, float& gb) {
  const int4 w = reinterpret_cast<const int4*>(sign)[i];
  ga = dot3(__int_as_float(w.x & 0xFFFF0000), __int_as_float(w.x << 16),
            __int_as_float(w.y & 0xFFFF0000), gx, gy, gz);
  gb = dot3(__int_as_float(w.y << 16), __int_as_float(w.z & 0xFFFF0000),
            __int_as_float(w.z << 16), gx, gy, gzm1);
}

// one octave of gradient noise from per-axis (cell, frac, frac - 1, fade)
template <int kForm>
__device__ __forceinline__ float noise3(const int* perm, const int* sign,
                                        const int* c, const float* f,
                                        const float* fm1, const float* fd) {
  const int cx = c[0], cy = c[1], cz = c[2];
  const float fx = f[0], fy = f[1], fz = f[2];
  const float fxm1 = fm1[0], fym1 = fm1[1], fzm1 = fm1[2];
  const float u = fd[0], v = fd[1], w = fd[2];
  float g000, g001, g010, g011, g100, g101, g110, g111;
  if constexpr ((kForm & kSingleLookups) != 0) {
    const int a0 = perm[slot(cx, 0)], a1 = perm[slot(cx, 1)];
    const int b00 = perm[slot(a0, cy)], b01 = perm[slot(a0 + 1, cy)];
    const int b10 = perm[slot(a1, cy)], b11 = perm[slot(a1 + 1, cy)];
    g000 = grad_dot(sign[slot(b00, cz)], fx, fy, fz);
    g001 = grad_dot(sign[slot(b00 + 1, cz)], fx, fy, fzm1);
    g010 = grad_dot(sign[slot(b01, cz)], fx, fym1, fz);
    g011 = grad_dot(sign[slot(b01 + 1, cz)], fx, fym1, fzm1);
    g100 = grad_dot(sign[slot(b10, cz)], fxm1, fy, fz);
    g101 = grad_dot(sign[slot(b10 + 1, cz)], fxm1, fy, fzm1);
    g110 = grad_dot(sign[slot(b11, cz)], fxm1, fym1, fz);
    g111 = grad_dot(sign[slot(b11 + 1, cz)], fxm1, fym1, fzm1);
  } else {
    // pa = a0 | a1 << 16, pb0 = b00 | b01 << 16, pb1 = b10 | b11 << 16;
    // sign entry (b + cz) holds the signs of corners (b, cz) and (b, cz + 1)
    const int pa = perm[slot(cx, 0)];
    const int pb0 = perm[slot(pa, cy)];
    const int pb1 = perm[slot(pa >> 16, cy)];
    halves_dots(sign, slot(pb0, cz), fx, fy, fz, fzm1, g000, g001);
    halves_dots(sign, slot(pb0 >> 16, cz), fx, fym1, fz, fzm1, g010, g011);
    halves_dots(sign, slot(pb1, cz), fxm1, fy, fz, fzm1, g100, g101);
    halves_dots(sign, slot(pb1 >> 16, cz), fxm1, fym1, fz, fzm1, g110, g111);
  }
  float x00 = lerp(g000, g100, u);
  float x10 = lerp(g010, g110, u);
  float x01 = lerp(g001, g101, u);
  float x11 = lerp(g011, g111, u);
  return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w);
}

// noise3 of octave i at the point (ph, pl): at lacunarity 2 by the static
// shifts of the point's int24 split; at any other lacunarity by scaling the
// point by freq[3*i] (hi), freq[3*i + 1] (lo), freq[3*i + 2] != 0 (exact
// power of two) and re-splitting it, the fraction through the f64 sum of
// its double-float pair (fh - 1 is not exact in f32 there). Octaves are
// independent of each other.
template <int kForm>
__device__ __forceinline__ float octave_noise(
    const Tables<kForm>& t, const float* __restrict__ freq, int i, bool pow2,
    const PointSplit& s, const float* ph, const float* pl) {
  int c[3];
  float f[3], fm1[3], fd[3];
  for (int k = 0; k < 3; ++k) {
    if (pow2) {
      octave_split<kForm>(s, k, i, c[k], f[k], fm1[k], fd[k]);
    } else {
      float oh, ol, fh, fl;
      df_scale(ph[k], pl[k], freq[3 * i], freq[3 * i + 1],
               freq[3 * i + 2] != 0.0f, oh, ol);
      floor_split_parts(oh, ol, c[k], fh, fl);
      frac_parts((double)fh + (double)fl, f[k], fm1[k], fd[k]);
    }
  }
  return noise3<kForm>(t.perm, t.sign, c, f, fm1, fd);
}

// fold octave value n into the running sum, in accumulate_octaves' order:
// ridged v = (1 - |n|)^2 with unclamped weight feedback, or fBm
__device__ __forceinline__ void add_octave(bool ridged, float gain, float n,
                                           float& value, float& weight,
                                           float& amp) {
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

// `count` octaves of ridged or fBm noise at the double-float point (ph, pl),
// one after another; planet_tpu_torch ops/perlin.accumulate_octaves. count
// must not exceed kMaxOctaves.
template <int kForm>
__device__ __forceinline__ float accumulate_octaves(
    const Tables<kForm>& t, const float* __restrict__ freq, int count,
    bool ridged, bool pow2, float gain, const float* ph, const float* pl) {
  float value = 0.0f, weight = 1.0f, amp = 1.0f;
  PointSplit s;
  split_point(pow2, ph, pl, s);
  for (int i = 0; i < count; ++i) {
    const float n = octave_noise<kForm>(t, freq, i, pow2, s, ph, pl);
    add_octave(ridged, gain, n, value, weight, amp);
  }
  return value;
}

}  // namespace noise_core

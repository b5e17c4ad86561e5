// Whole-cube heightfield kernel (K5): for every texel of six n x n cube
// faces (or of a strip of rows of each face), the sphere position, N octaves
// of ridged or fBm noise times the amplitude, the central-difference normal
// with face-edge clamping and the Lambert shade. Writes heights and shade,
// each (6, rows, n) f32; nothing else touches device memory.
//
// Replaces planet_tpu/ops/kernels/field_pallas.py:_make_field_kernel,
// launched there by _build_field_call (full cube) and
// _build_field_strip_call (row strips). Plain PyTorch version:
// planet_tpu_torch/ops/kernels/field_cuda.py:field_plain, which this kernel
// matches bit for bit; the wrapper is field_cuda.field_kernel.
//
// Per texel (face f, absolute row r, column c), the Pallas kernel's math:
// a = (2c + 1 - n)/n and b = (2r + 1 - n)/n (exact f32 for power-of-two n);
// 1 + a^2 + b^2 by two quick_two_sums; its double-float square root and the
// double-float quotient K / sqrt(...) with K = radius * coord_scale; the
// cube position q_j = C_j + A_j a + B_j b from per-face constants (exactly
// one term nonzero) times that quotient, as double-float noise coordinates;
// the shared octave loop of noise.cuh; the height times the amplitude.
// Normals: dx = h(c-1) - h(c+1), dy = h(r-1) - h(r+1), clamped to the face
// (edge replication); inv_len = 1/sqrt(dx*dx + ny^2 + dy*dy) and
// shade = sqrt(0.001 + max(0, (dx*lx + ny*ly + dy*lz) * inv_len)), in that
// op order. The square-root seed and the normalization use the correctly
// rounded 1.0f / sqrtf(x) (nums/df.sqrt does the same), where planet_tpu
// uses the approximate lax.rsqrt; CUDA's rsqrtf is approximate too.
//
// What bounds it on the H100: instruction throughput. A texel is ~100 f32
// operations outside the noise (the coordinates ~85, each of their five
// error-free products a multiply and an FMA; the normal and shade ~16),
// ~90 f32 and ~40 integer operations per octave, 7 shared-memory reads per
// octave and the f64 fade per axis-octave (noise.cuh); at 6 octaves that
// is ~750 f32 operations against 8 bytes written, two orders of magnitude
// above the card's f32-operations-per-byte of HBM bandwidth.
//
// Design: one launch. The Pallas kernel walks each face's blocks in order
// and carries the neighbouring rows between grid steps in VMEM scratch; CUDA
// blocks run in no order, so nothing can carry between them. Each 256-thread
// block owns a 64 x 128 tile of one face and evaluates the tile's heights
// plus a one-texel halo ring (66 x 130 values, 34 KB of static shared
// memory beside the noise core's 5 KB of tables) into shared memory, then
// writes heights and shade for its interior. The halo is recomputed, not
// exchanged: (66 * 130) / (64 * 128) = 1.047x the noise work (a 16-row
// tile cost 1.14x), in 34 rounds of the 256 threads of which the last is
// half full (~1.5 % idle lanes; 9 % at 16 rows). A separate height pass
// and normal pass would cost no recompute but a round trip of every height
// through device memory and a second launch. The noise core is noise.cuh's
// (the fraction as one 48-bit word, the pair tables, the signs as f32
// halves, the FMA products), and the coordinates' products are FMAs too
// (two_prod).
// Halo coordinates are clamped to the face, so an edge texel's outside
// neighbour is the texel itself: the Pallas kernel's edge replication,
// bit for bit, with no branch in the normal. A strip passes its absolute
// row offset: every value is a function of the absolute (f, r, c), so a
// strip equals the matching rows of the full cube bit for bit and its halo
// rows recompute the neighbour strip's values. Rows past the strip's halo
// row are left unevaluated (a block's loop stops at them). The TPU's lane
// rolls with their row-carry fix, the (6 n n / 128, 128) block layout,
// block_rows and the VMEM sizing do not come across.
//
// Bit-exactness: -fmad=false, IEEE division and square root, no fast-math
// (see noise.cuh; two_prod's fmaf gives the exact product error that
// field_plain's Dekker split gives); every expression keeps field_plain's
// op order.

#include "noise.cuh"

namespace {

using namespace noise_core;

constexpr int kThreads = 256;
constexpr int kTileRows = 64;
constexpr int kTileCols = 128;
constexpr int kHaloRows = kTileRows + 2;
constexpr int kHaloCols = kTileCols + 2;

// nums/df.sqrt: Karp's method, one Newton step from 1/sqrt(hi)
__device__ __forceinline__ void df_sqrt(float h, float l, float& rh,
                                        float& rl) {
  const float x = 1.0f / sqrtf(h);
  const float ax = h * x;
  float p, e, d_hi, d_e;
  two_prod(ax, ax, p, e);
  two_sum(h, -p, d_hi, d_e);
  const float diff = d_hi + ((d_e + l) - e);
  const float corr = diff * (x * 0.5f);
  quick_two_sum(ax, corr, rh, rl);
}

// nums/df.div
__device__ __forceinline__ void df_div(float ah, float al, float bh, float bl,
                                       float& rh, float& rl) {
  const float q1 = ah / bh;
  float p, e, r_hi, r_e;
  two_prod(q1, bh, p, e);
  two_sum(ah, -p, r_hi, r_e);
  const float r = r_hi + (((r_e + al) - e) - q1 * bl);
  const float q2 = r / bh;
  quick_two_sum(q1, q2, rh, rl);
}

struct FieldParams {
  int n, octaves;
  bool ridged, pow2;
  float inv_n, gain, k_hi, k_lo, amp;
};

// the noise height of face texel (r, c); abc = the face's
// [component j][C, A, B] constants
__device__ __forceinline__ float height(const FieldParams& p,
                                        const Tables<kFast>& tab,
                                        const float* __restrict__ freq,
                                        const float* abc, int r, int c) {
  const float a = (float)(2 * c + 1 - p.n) * p.inv_n;
  const float b = (float)(2 * r + 1 - p.n) * p.inv_n;
  const float a2 = a * a;
  const float b2 = b * b;
  float s1, e1, s2, e2, n2h, n2l, sh, sl, ih, il;
  quick_two_sum(1.0f, a2, s1, e1);
  quick_two_sum(s1, b2, s2, e2);
  quick_two_sum(s2, e1 + e2, n2h, n2l);
  df_sqrt(n2h, n2l, sh, sl);
  df_div(p.k_hi, p.k_lo, sh, sl, ih, il);
  float ph[3], pl[3];
  for (int j = 0; j < 3; ++j) {
    const float q = (abc[3 * j] + abc[3 * j + 1] * a) + abc[3 * j + 2] * b;
    float pr, e;
    two_prod(ih, q, pr, e);
    e = e + il * q;
    quick_two_sum(pr, e, ph[j], pl[j]);
  }
  return accumulate_octaves(tab, freq, p.octaves, p.ridged, p.pow2, p.gain,
                            ph, pl) *
         p.amp;
}

// 4 blocks an SM: at most 64 registers a thread (x 256 threads x 4 = the
// SM's 65,536; ptxas took 64 with no spills for this kernel, and
// chip_smoke.py phase 2 prints its count), and 4 x 39 KB of shared memory
// fit; 32 of the SM's 64 warps are resident
__global__ void __launch_bounds__(kThreads, 4)
field_kernel(const int* __restrict__ perm_g, const int* __restrict__ sign_g,
             const float* __restrict__ freq, const float* __restrict__ abc_g,
             float* __restrict__ h_out, float* __restrict__ shade_out,
             FieldParams p, int row0, int rows, float ny2, float nyly,
             float lx, float lz) {
  __shared__ Tables<kFast> tab;
  __shared__ float abc[9];
  __shared__ float hs[kHaloRows][kHaloCols];
  const int f = blockIdx.z;
  if (threadIdx.x < 9) abc[threadIdx.x] = abc_g[f * 9 + threadIdx.x];
  load_tables(tab, perm_g, sign_g);    // ends with __syncthreads()

  const int n = p.n;
  const int c0 = blockIdx.x * kTileCols;
  const int r0 = row0 + blockIdx.y * kTileRows;  // the tile's first row
  const int r_end = row0 + rows;                 // the strip's end row
  // halo rows r0 - 1 .. min(r0 + kTileRows, r_end): the strip's last tile
  // stops one row past the strip
  const int halo = min(kHaloRows, r_end - r0 + 2) * kHaloCols;
  for (int i = threadIdx.x; i < halo; i += kThreads) {
    const int hr = i / kHaloCols, hc = i - hr * kHaloCols;
    const int rc = min(max(r0 + hr - 1, 0), n - 1);
    const int cc = min(max(c0 + hc - 1, 0), n - 1);
    hs[hr][hc] = height(p, tab, freq, abc, rc, cc);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileRows * kTileCols; i += kThreads) {
    const int tr = i / kTileCols, tc = i - tr * kTileCols;
    const int r = r0 + tr;
    if (r >= r_end) break;
    const float dx = hs[tr + 1][tc] - hs[tr + 1][tc + 2];
    const float dy = hs[tr][tc + 1] - hs[tr + 2][tc + 1];
    const float inv_len = 1.0f / sqrtf((dx * dx + ny2) + dy * dy);
    const float dot = ((dx * lx + nyly) + dy * lz) * inv_len;
    const float shade = sqrtf(0.001f + fmaxf(dot, 0.0f));
    const size_t o = ((size_t)f * rows + (r - row0)) * n + c0 + tc;
    h_out[o] = hs[tr + 1][tc + 1];
    shade_out[o] = shade;
  }
}

}  // namespace

extern "C" int planet_field(const void* perm, const void* sign,
                            const void* freq, const void* abc, void* heights,
                            void* shade, int n, int row0, int rows,
                            int octaves, int ridged, int pow2, float gain,
                            float k_hi, float k_lo, float amp, float ny2,
                            float nyly, float lx, float lz, void* stream) {
  if (n <= 0 || n % kTileCols || (n & (n - 1)) || rows <= 0 || row0 < 0 ||
      row0 > n - rows || octaves < 0 || octaves > kMaxOctaves)
    return (int)cudaErrorInvalidValue;
  FieldParams p;
  p.n = n;
  p.octaves = octaves;
  p.ridged = ridged != 0;
  p.pow2 = pow2 != 0;
  p.inv_n = 1.0f / (float)n;
  p.gain = gain;
  p.k_hi = k_hi;
  p.k_lo = k_lo;
  p.amp = amp;
  const dim3 grid(n / kTileCols, (rows + kTileRows - 1) / kTileRows, 6);
  field_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)perm, (const int*)sign, (const float*)freq,
      (const float*)abc, (float*)heights, (float*)shade, p, row0, rows, ny2,
      nyly, lx, lz);
  return (int)cudaGetLastError();
}

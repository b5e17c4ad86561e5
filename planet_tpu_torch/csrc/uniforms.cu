// U1, the fused frame's uniforms as one kernel (uniforms_kernel): what
// the vertex program V1 takes besides the tiles, for each of the frame's
// R rows. planet_tpu computes them in an XLA fusion of its geometry jit
// (engine/device_step.py:242-263), not in Pallas, so this kernel
// replaces no TPU kernel: on the card the composed torch ops were some 56
// launches a frame (PERF.md). Plain PyTorch version:
// planet_tpu_torch/tess/uniforms_cuda.py: uniforms_plain, which it
// equals bit for bit; the wrapper is uniforms_cuda.uniforms.
//
// A thread a (row, corner), 256 to a block: the corner's camera-relative
// position (nums/df.sub's op order, its hi word), its normal
// (c_hi + c_lo over the correctly rounded root of (x x + y y) + z z; a
// padding row's zero corners give 0 / 0, the NaN word 0x7fffffff), and,
// in the row's first thread, the crop variants from the id's child index
// and the skirt max_skirt / 2^(depth - 1 + 1). The arithmetic is
// uniforms.cuh's, which V1's rows mode (tess.cu) computes into its own
// staging: the fused step launches that and not this kernel, which stays
// for the "uniforms" rung of the stage bisection, whose outputs are these.
// Bound by nothing of size: it reads 112 bytes a row and writes 108; one
// launch in place of the ops'. Built with -fmad=false, so every sum and
// product rounds as torch's do.

#include <cuda_runtime.h>

#include "uniforms.cuh"

namespace {

using namespace uniforms_core;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) uniforms_kernel(
    const int* __restrict__ q_lo, const int* __restrict__ q_hi,
    const unsigned char* __restrict__ crop, const int* __restrict__ depth,
    const float* __restrict__ c_hi, const float* __restrict__ c_lo,
    const float* __restrict__ cam_hi, const float* __restrict__ cam_lo,
    int rows, float max_skirt, int* __restrict__ vx, int* __restrict__ vy,
    float* __restrict__ corners_rel, float* __restrict__ normals,
    float* __restrict__ skirt) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4 * rows) return;
  const int r = t >> 2, c = t & 3;
  float nrm[3];
  for (int a = 0; a < 3; ++a) {
    const float h = c_hi[(3 * c + a) * rows + r];
    const float l = c_lo[(3 * c + a) * rows + r];
    corners_rel[(r * 4 + c) * 3 + a] = df_sub_hi(h, l, cam_hi[a], cam_lo[a]);
    nrm[a] = h + l;
  }
  const float len = normal_len(nrm);
  for (int a = 0; a < 3; ++a) normals[(r * 4 + c) * 3 + a] = nrm[a] / len;
  if (c == 0) {
    crop_variants(q_lo[r], q_hi[r], crop[r] != 0, &vx[r], &vy[r]);
    skirt[r] = skirt_of(depth[r], max_skirt);
  }
}

}  // namespace

// q_lo, q_hi, depth (rows,) int32, crop (rows,) bool, c_hi, c_lo (12, rows)
// f32 corner-major DF corners (row 3 c + a: corner c's axis a), cam_hi,
// cam_lo (3,) f32 -> vx, vy (rows,) int32, corners_rel, normals (rows, 4,
// 3) f32, skirt (rows,) f32.
extern "C" int planet_uniforms(const void* q_lo, const void* q_hi,
                               const void* crop, const void* depth,
                               const void* c_hi, const void* c_lo,
                               const void* cam_hi, const void* cam_lo,
                               int rows, float max_skirt, void* vx, void* vy,
                               void* corners_rel, void* normals, void* skirt,
                               void* stream) {
  if (rows < 0 || rows > (1 << 28)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int blocks = (4 * rows + kThreads - 1) / kThreads;
  uniforms_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)q_lo, (const int*)q_hi, (const unsigned char*)crop,
      (const int*)depth, (const float*)c_hi, (const float*)c_lo,
      (const float*)cam_hi, (const float*)cam_lo, rows, max_skirt, (int*)vx,
      (int*)vy, (float*)corners_rel, (float*)normals, (float*)skirt);
  return (int)cudaGetLastError();
}

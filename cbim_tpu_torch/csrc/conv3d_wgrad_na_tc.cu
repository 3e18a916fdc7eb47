// The fused preact conv's weight gradient on Hopper's bf16 tensor cores
// (sm_90a): conv3d_wgrad_na_tc,
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} xn[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
//   xn = act((x - mean[b, c]) * rstd[b, c]) rounded to bf16, zero outside
// the volume; bf16 x and g, fp32 mean and rstd [B, C], fp32 sums, dW
// [3, 3, 3, C, F] fp32.  The forward is conv3d_na_tc.cu; the CUDA-core
// conv3d_wgrad_na (widths that are not multiples of 8) is
// conv3d_wgrad_na.cu.
//
// Replaces the Pallas TPU kernel conv3d_wgrad_cw2_na of
// cbim_tpu/ops/pallas/conv3d.py (_wgrad_kernel_cw2_na: the norm-act
// recomputed on the raw halo tile in VMEM) in bf16.
//
// What bounds it on the H100: operations, as conv3d_wgrad_tc (0.70 ms at
// (2, 128^3, 96 -> 32) at 989 TFLOP/s), and beside them the norm-act on the
// CUDA cores: 600 halo rows of a 256-voxel tile, 2.3 normalisations of each
// input value per f tile.
//
// What the design does about it: conv3d_wgrad_tc's kernel (conv3d_wgrad_tc.cuh:
// a block owns a 32 c x 32 f tile of dW for all 27 taps and walks a chunk of
// (4, 8, 8) voxel tiles; x halo and g tile by TMA in a ring of 3 stages;
// mma.sync; split-K with the fixed fold of wgrad_fold.cuh) with the norm-act
// pass of na_halo.cuh on each x halo: while tile s is multiplied, tile s + 1
// (landed a step earlier) is normalised in its own stage, a slice of rows
// after every other k-step, so the CUDA-core pass interleaves with the MMAs
// in every warp.  Only each block's first tile is normalised before any MMA.
// The act is a template parameter.  Needs C % 8 == 0 and F % 8 == 0.
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "conv3d_wgrad_tc.cuh"

// conv3d_wgrad_tc against act((x - mean) * rstd): x [B, D, H, W, C] and g
// [B, D, H, W, F] bf16; mean and rstd fp32 [B, C]; act 0 none, 1 relu, 2
// gelu (exact erf); partial fp32 scratch of n_chunks * 27 * C * F; dw
// [3, 3, 3, C, F] fp32; voxel tiles and chunks as conv3d_wgrad_tc's.  Needs
// C % 8 == 0, F % 8 == 0 and 16-byte aligned x, g, mean and rstd.
extern "C" int conv3d_wgrad_na_tc(const void* x, const void* g,
                                  const void* mean, const void* rstd,
                                  void* partial, void* dw, int act, int B,
                                  int D, int H, int W, int C, int F,
                                  int tiles_per_chunk, int n_chunks,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if ((uintptr_t)m % 16 != 0 || (uintptr_t)r % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (act == kActRelu)
    return launch_wgrad_tc<kActRelu>(x, g, m, r, partial, dw, B, D, H, W, C,
                                     F, tiles_per_chunk, n_chunks, st);
  if (act == kActGelu)
    return launch_wgrad_tc<kActGelu>(x, g, m, r, partial, dw, B, D, H, W, C,
                                     F, tiles_per_chunk, n_chunks, st);
  if (act == kActNone)
    return launch_wgrad_tc<kActNone>(x, g, m, r, partial, dw, B, D, H, W, C,
                                     F, tiles_per_chunk, n_chunks, st);
  return (int)cudaErrorInvalidValue;
}

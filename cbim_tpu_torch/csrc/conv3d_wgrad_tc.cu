// Weight gradient of the stride-1, zero-pad-1, 3x3x3 convolution on
// Hopper's bf16 tensor cores (sm_90a): conv3d_wgrad_tc.  The forward and
// dgrad are conv3d_tc.cu, the fused preact conv's weight gradient
// conv3d_wgrad_na_tc.cu; the CUDA-core weight gradient (fp32, widths that
// are not multiples of 8) stays in conv3d_wgrad.cu.
//
// Replaces conv3d_wgrad of cbim_tpu/ops/pallas/conv3d.py in bf16:
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
// zeros outside the volume; bf16 x and g, fp32 sums, dW [3, 3, 3, C, F]
// fp32.  The TPU kernel's tap packing (_build_g9, K = 3C, N = 9F) is not
// carried over.
//
// What bounds it on the H100: operations, as the forward (2 * 27 * C * F
// FLOPs per voxel, 0.70 ms at (2, 128^3, 96 -> 32) at 989 TFLOP/s), with K
// = every voxel (4.2 M) reduced into a small output (27 * C * F values).
//
// What the design does about it: per tap a GEMM dW_t (M = c, N = f) =
// X_t^T G over K = voxels, on mma.sync.m16n8k16 (bf16 in, fp32 sums).
// - A block owns one (32-channel c tile, 32-channel f tile) of dW for all
//   27 taps and walks a chunk of (4, 8, 8) voxel tiles.  So each x halo and
//   each g tile is staged once for all 27 taps (conv3d_wgrad.cu stages them
//   once per (kd, kh): 9 times).
// - Staging: for each voxel tile, two 5D TMA boxes, the x halo (6 x 10 x 10
//   voxels, zero fill = the SAME padding and the ragged edge) and the g tile
//   (4 x 8 x 8), 64-byte swizzled rows, in a ring of 3 stages on mbarriers;
//   one thread starts the copies.
// - Operands: A = X_t^T by ldmatrix.trans from the shifted halo rows (a
//   tap's shift is an address), B = G by ldmatrix.trans.
// - 9 warps, warp (kd, kh) owns the 3 kw taps x 32 x 32 accumulators (96
//   fp32 registers a thread); the 3 taps share each B fragment.
// - Split-K over chunks of voxel tiles: each block writes fp32 partials and
//   a second kernel folds the chunks in a fixed order.  No atomics, so
//   results repeat bit for bit.
// The kernel is conv3d_wgrad_tc.cuh's, shared with the fused preact conv's
// weight gradient (conv3d_wgrad_na_tc.cu).
// Needs C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "conv3d_wgrad_tc.cuh"

// x [B, D, H, W, C] and g [B, D, H, W, F] bf16; partial fp32 scratch of
// n_chunks * 27 * C * F; dw [3, 3, 3, C, F] fp32.  The voxel tiles are (4,
// 8, 8) boxes, ceil(D / 4) * ceil(H / 8) * ceil(W / 8) a sample, in
// (b, d, h, w) order; tiles_per_chunk * n_chunks must cover them.  Needs
// C % 8 == 0, F % 8 == 0 and 16-byte aligned x and g.
extern "C" int conv3d_wgrad_tc(const void* x, const void* g, void* partial,
                               void* dw, int B, int D, int H, int W, int C,
                               int F, int tiles_per_chunk, int n_chunks,
                               void* stream) {
  return launch_wgrad_tc<kNoNorm>(x, g, nullptr, nullptr, partial, dw, B, D,
                                  H, W, C, F, tiles_per_chunk, n_chunks,
                                  static_cast<cudaStream_t>(stream));
}

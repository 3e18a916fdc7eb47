// Weight gradient of the stride-1, zero-pad-1, 3x3x3 convolution for
// Hopper (sm_90a), also with the fused norm-act prologue (the forward is
// conv3d.cu; the shared helpers are conv3d_common.cuh).
//
// Replaces conv3d_wgrad / conv3d_wgrad_cw / conv3d_wgrad_cw2 of
// cbim_tpu/ops/pallas/conv3d.py (one function in three TPU layouts):
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
// zeros outside the volume; x [B, D, H, W, C], g [B, D, H, W, F], fp32 or
// bf16 storage, fp32 sums, dW [3, 3, 3, C, F] fp32.
//
// What bounds it: arithmetic, as the forward (2*27*C*F FLOPs per voxel), and
// the reduction runs over K = every voxel (4.2 M at 2 x 128^3) into a small
// output (27*C*F values).  The TPU kernel accumulated that output across a
// sequential grid; Hopper's blocks run in no order, so the reduction is
// split: a block owns one chunk of voxels and one (kd, kh, c-tile, f-tile)
// of dW, and writes fp32 partials; a second kernel folds the chunks in a
// fixed order.  No atomics, so results repeat bit for bit.  The three kw
// taps of a block share each staged gradient row (3 x 16 FMAs per pair of
// shared-memory loads per thread), and the shifted input rows are staged
// with zeros outside the volume, so ragged D/H/W need no padded copy.  The
// TPU kernel's tap packing (_build_g9, _pack_weights_grouped) filled MXU
// lanes and has no counterpart here.  conv3d_wgrad_na runs the same kernel
// with the norm-act prologue on its staged input rows (dW against
// act(norm(x)), recomputed per tile, as conv3d_wgrad_cw2_na): 3 prologue
// applications per staged value (one per kw tap), about a dozen per thread
// against 768 FMAs a staged step at 64 x 64 tiles, two dozen at 32 x 32.
//
// The kernel is conv3d_wgrad.cuh; this source holds the plain entry,
// conv3d_wgrad_na.cu the fused one.  Each extern "C" entry launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include "conv3d_wgrad.cuh"

// dtype: 0 float32, 1 bfloat16.  partial: fp32 scratch of
// n_chunks * 27 * C * F; dw: [3, 3, 3, C, F] fp32.  rows_per_chunk *
// n_chunks must cover B * D * H * W voxels.
extern "C" int conv3d_wgrad(const void* x, const void* g, void* partial,
                            void* dw, int dtype, int B, int D, int H, int W,
                            int C, int F, int rows_per_chunk, int n_chunks,
                            void* stream) {
  return wgrad_entry<kNoNorm>(x, g, nullptr, nullptr, partial, dw, dtype, B,
                              D, H, W, C, F, rows_per_chunk, n_chunks,
                              stream);
}

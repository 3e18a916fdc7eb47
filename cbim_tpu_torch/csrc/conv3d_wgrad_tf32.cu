// Weight gradient of the stride-1, zero-pad-1, 3x3x3 convolution in fp32 on
// Hopper's TF32 tensor cores (sm_90a), error-compensated to fp32 accuracy
// (3xTF32): conv3d_wgrad_tf32.  The forward and dgrad are conv3d_tf32.cu,
// the bf16 weight gradient conv3d_wgrad_tc.cu, the fused preact conv's fp32
// weight gradient conv3d_wgrad_na_tf32.cu (the same kernel with a norm-act
// in its split); widths that are not multiples of 8 stay on the CUDA-core
// kernels of conv3d_wgrad.cu.
//
// Replaces, in fp32, conv3d_wgrad of cbim_tpu/ops/pallas/conv3d.py (:582;
// twins _cw :914 and _cw2 :1232):
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
// zeros outside the volume; fp32 x, g, sums and dW [3, 3, 3, C, F].  The
// TPU kernel's tap packing (_build_g9, K = 3C, N = 9F) is not carried over.
//
// What bounds it on the H100: operations.  2 * 27 * C * F FLOPs per voxel,
// 0.70 TFLOP at (2, 128^3, 96 -> 32), three times over on the TF32 tensor
// cores: 4.2 ms at 495 TFLOP/s, against 10.4 ms at the 67 TFLOP/s fp32 FMA
// rate of the CUDA cores and 0.6 ms for the bytes (x and g at 3.35 TB/s).
// K is every voxel (4.2 M there), reduced into 27 * C * F values.  Beside
// the MMAs, the split (below) runs on the CUDA cores and competes with
// mma.sync for the warp schedulers.
//
// What the design does about it:
// - conv3d_wgrad_tc.cuh's structure: per tap a GEMM dW_t (M = c, N = f) =
//   X_t^T G over K = voxels.  A block owns one (16-channel c tile,
//   32-channel f tile) of dW for all 27 taps and walks a chunk of (4, 8, 8)
//   voxel tiles.  For each tile, 5D TMA boxes bring the x halo (6 x 10 x
//   10 voxels x 16 channels, 38.4 KB; zero fill = the SAME padding and the
//   ragged edge) and the g tile (two 16-channel planes, 32 KB), 64-byte
//   swizzled rows, into a ring of 2 stages on mbarriers; one thread starts
//   the copies.  A 32-channel fp32 halo would take 76.8 KB a stage.  9
//   warps: warp (kd, kh) owns the 3 kw taps, which share each B fragment.
//   Split-K over chunks of voxel tiles: each block writes fp32 partials and
//   wgrad_fold.cuh adds them in a fixed order.  No atomics, so results
//   repeat bit for bit.
// - conv3d_tf32.cu's arithmetic: each operand split into hi = tf32(v) and
//   lo = tf32(v - hi) (round to nearest, ties away from zero, a NaN kept
//   in hi: split_tf32),
//   dW_t = x_lo g_hi + x_hi g_lo + x_hi g_hi, three mma.sync.m16n8k8 TF32
//   products (the dropped x_lo g_lo is 2^-22 of x g).
// - The split runs once per landed tile, by all threads, before its MMAs:
//   hi in place, lo into one buffer of the stage's layout (3 x 70 KB of
//   shared memory in all).  Split in registers instead, each of the 9 warps
//   would split every g value and each warp every x value of its taps'
//   rows; on the H100 that ran slower, and so did reading the split values
//   back with vector loads (the fragments then take register moves).
// - Accumulation.  The tensor cores add into their fp32 accumulators by
//   truncation, which over a whole forward tile erred by more than twice
//   cuDNN fp32.  So each z plane of a voxel tile (64 voxels, three passes:
//   192 products) is summed in fresh accumulators, its first MMA taking
//   zeros for C, and folded into the block's sums with fp32 adds (round to
//   nearest).  3 taps x 16 x 32 sums, twice: 96 registers a thread.
// - Fragments.  Both operands have the voxel as K, which is the outer,
//   strided dimension in shared memory, and ldmatrix.trans transposes
//   16-bit elements only.  The mma sums over k, so any map of voxels onto
//   the 8 k slots works when A and B share it, and so does any map of c
//   onto M.  A k step is one row of 8 voxels (x = 0..7 of one (z, y)).
//   Lane (gid = l / 4, tig = l % 4) takes voxels x = (tig & 1) + 4 (tig >>
//   1) and x + 2 as its k slots tig and tig + 4, and channels c = 2 gid and
//   2 gid + 1 as its rows gid and gid + 8: its A values of a tap are two
//   8-byte loads a part, and rows {r, r + 1, r + 4, r + 5} under the
//   64-byte swizzle put a half warp's loads on distinct banks whatever the
//   tap's shift.  B takes f = gid + 8 j as column gid of n8 tile j: 4-byte
//   loads, on distinct banks for the same reason.  Rows y and y + 4 of a
//   z plane are 40 halo rows apart and share their swizzle, so their k
//   steps run as a pair.  (ldmatrix.trans of the 16-bit halves, put back
//   together by byte permutes, was not built.)
// - wgmma is not the next step without a transpose in shared memory: it
//   takes TF32 operands only K-major, and both operands here are K-outer.
// The kernel is conv3d_wgrad_tf32.cuh's, shared with the fused preact
// conv's fp32 weight gradient (conv3d_wgrad_na_tf32.cu).
// Needs C % 8 == 0 and F % 8 == 0 (the route's width rule; TMA needs
// 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "conv3d_wgrad_tf32.cuh"

// x [B, D, H, W, C] and g [B, D, H, W, F] fp32; partial fp32 scratch of
// n_chunks * 27 * C * F; dw [3, 3, 3, C, F] fp32.  The voxel tiles are (4,
// 8, 8) boxes, ceil(D / 4) * ceil(H / 8) * ceil(W / 8) a sample, in
// (b, d, h, w) order; tiles_per_chunk * n_chunks must cover them.  Needs
// C % 8 == 0, F % 8 == 0 and 16-byte aligned x, g and partial.
extern "C" int conv3d_wgrad_tf32(const void* x, const void* g, void* partial,
                                 void* dw, int B, int D, int H, int W, int C,
                                 int F, int tiles_per_chunk, int n_chunks,
                                 void* stream) {
  return launch_wgrad_tf32<kNoNorm>(x, g, nullptr, nullptr, partial, dw, B,
                                    D, H, W, C, F, tiles_per_chunk, n_chunks,
                                    static_cast<cudaStream_t>(stream));
}

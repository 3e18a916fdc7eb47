// The fused preact conv's weight gradient in fp32 on Hopper's TF32 tensor
// cores (sm_90a), error-compensated to fp32 accuracy (3xTF32):
// conv3d_wgrad_na_tf32,
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} xn[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
//   xn = act((x - mean[b, c]) * rstd[b, c]) in fp32, zero outside the
// volume; fp32 x and g, fp32 mean and rstd [B, C], fp32 sums, dW [3, 3, 3,
// C, F].  The forward is conv3d_tf32.cu's conv3d_same_na_fwd_tf32, the bf16
// pair conv3d_na_tc.cu and conv3d_wgrad_na_tc.cu; widths that are not
// multiples of 8 stay on the CUDA-core conv3d_wgrad_na (conv3d_wgrad_na.cu).
//
// Replaces, in fp32, the Pallas TPU kernel conv3d_wgrad_cw2_na of
// cbim_tpu/ops/pallas/conv3d.py (:1518, pallas_call at :1545;
// _wgrad_kernel_cw2_na: the norm-act recomputed on the raw halo tile in
// VMEM).
//
// What bounds it on the H100: operations, as conv3d_wgrad_tf32 (three TF32
// passes over 2 * 27 * C * F FLOPs a voxel: 4.2 ms at (2, 128^3, 96 -> 32)
// at 495 TFLOP/s), and beside them the norm-act on the CUDA cores: 600 halo
// rows of 16 channels for a 256-voxel tile, 2.3 normalisations of each
// input value per f tile (an exact erf each with GELU).
//
// What the design does about it: conv3d_wgrad_tf32's kernel
// (conv3d_wgrad_tf32.cuh: a block owns a 16 c x 32 f tile of dW for all 27
// taps and walks a chunk of (4, 8, 8) voxel tiles; x halo and g planes by
// TMA in a ring of 2 stages; each landed tile split once in shared memory
// into TF32 hi and lo parts; three mma.sync TF32 products; split-K with
// wgrad_fold.cuh's fixed fold) whose split pass normalises each x halo
// value first, in fp32, as na_halo.cuh's pass does for the other fused
// kernels: rows outside the volume keep TMA's zeros (SAME padding applies
// to the normalised input), channels past C too.  One read and one write
// of the halo serve both, so the norm-act adds its arithmetic and no
// shared-memory traffic.  The act is a template parameter.  Needs C % 8 ==
// 0 and F % 8 == 0.
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "conv3d_wgrad_tf32.cuh"

// conv3d_wgrad_tf32 against act((x - mean) * rstd): x [B, D, H, W, C] and
// g [B, D, H, W, F] fp32; mean and rstd fp32 [B, C]; act 0 none, 1 relu, 2
// gelu (exact erf); partial fp32 scratch of n_chunks * 27 * C * F; dw
// [3, 3, 3, C, F] fp32; voxel tiles and chunks as conv3d_wgrad_tf32's.
// Needs C % 8 == 0, F % 8 == 0 and 16-byte aligned x, g, partial, mean and
// rstd.
extern "C" int conv3d_wgrad_na_tf32(const void* x, const void* g,
                                    const void* mean, const void* rstd,
                                    void* partial, void* dw, int act, int B,
                                    int D, int H, int W, int C, int F,
                                    int tiles_per_chunk, int n_chunks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if (act == kActRelu)
    return launch_wgrad_tf32<kActRelu>(x, g, m, r, partial, dw, B, D, H, W,
                                       C, F, tiles_per_chunk, n_chunks, st);
  if (act == kActGelu)
    return launch_wgrad_tf32<kActGelu>(x, g, m, r, partial, dw, B, D, H, W,
                                       C, F, tiles_per_chunk, n_chunks, st);
  if (act == kActNone)
    return launch_wgrad_tf32<kActNone>(x, g, m, r, partial, dw, B, D, H, W,
                                       C, F, tiles_per_chunk, n_chunks, st);
  return (int)cudaErrorInvalidValue;
}

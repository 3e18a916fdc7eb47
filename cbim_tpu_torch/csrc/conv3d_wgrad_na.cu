// The fused preact conv's weight gradient on the CUDA cores (sm_90a):
// conv3d_wgrad_na, conv3d_wgrad.cuh's kernel against act((x - mean) *
// rstd), the norm-act applied to each staged input row (see conv3d_wgrad.cu).
// It serves widths that are not multiples of 8, in fp32 and bf16; the
// tensor-core routes are conv3d_wgrad_na_tc.cu and conv3d_wgrad_na_tf32.cu.
//
// Replaces the Pallas TPU kernel conv3d_wgrad_cw2_na of
// cbim_tpu/ops/pallas/conv3d.py.
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for an act it does
// not take).

#include "conv3d_wgrad.cuh"

// conv3d_wgrad against act((x - mean) * rstd): mean, rstd fp32 [B, C]; act
// 0 none, 1 relu, 2 gelu; the rest as conv3d_wgrad.
extern "C" int conv3d_wgrad_na(const void* x, const void* g, const void* mean,
                               const void* rstd, void* partial, void* dw,
                               int dtype, int act, int B, int D, int H, int W,
                               int C, int F, int rows_per_chunk, int n_chunks,
                               void* stream) {
  if (act == kActNone)
    return wgrad_entry<kActNone>(x, g, mean, rstd, partial, dw, dtype, B, D,
                                 H, W, C, F, rows_per_chunk, n_chunks, stream);
  if (act == kActRelu)
    return wgrad_entry<kActRelu>(x, g, mean, rstd, partial, dw, dtype, B, D,
                                 H, W, C, F, rows_per_chunk, n_chunks, stream);
  if (act == kActGelu)
    return wgrad_entry<kActGelu>(x, g, mean, rstd, partial, dw, dtype, B, D,
                                 H, W, C, F, rows_per_chunk, n_chunks, stream);
  return (int)cudaErrorInvalidValue;
}

// The second kernel of the split-K weight gradients (conv2d.cu,
// conv3d_wgrad.cu, conv2d_wgrad_tc.cu, conv3d_wgrad_tc.cu,
// conv3d_wgrad_tf32.cuh, conv2d_wgrad_tf32.cu): each block of the first
// kernel writes fp32 partial sums of one pixel chunk, and this
// fold adds them in chunk order.  No atomics, so results repeat bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

// dw[i] = sum over chunks of partial[chunk, i], in chunk order.
__global__ void __launch_bounds__(256)
wgrad_fold_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                  long long n, int n_chunks) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += partial[(long long)k * n + i];
    dw[i] = s;
  }
}

// the fold of ``n_chunks`` partials of ``n`` values each into dw, on ``st``
inline int launch_wgrad_fold(const float* partial, float* dw, long long n,
                             int n_chunks, cudaStream_t st) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  wgrad_fold_kernel<<<(unsigned)blocks, 256, 0, st>>>(partial, dw, n,
                                                      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

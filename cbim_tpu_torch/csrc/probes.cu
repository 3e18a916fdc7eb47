// Probe kernel for Hopper (sm_90a): an instrument of the card's memory rate.
//
// Replaces the Pallas TPU probe of the JAX package's
// tools/probe_bandwidth.py main (scale_kernel): a bf16 copy-scale probe of
// HBM bandwidth, on (block, 32) vs (block, 128) VMEM blocks.  (The other
// probes' kernels: probe_dot_t is dot_t_wgmma.cu's, probe_gemm
// gemm_wgmma.cu's, the conv's ladder conv3d_tc.cu's and conv3d_tf32.cu's.)
// It lies on no serving or training path.  It computes what its TPU probe
// computes; lane density and VMEM blocks are TPU concerns, so it sweeps
// what plays their part on Hopper instead.
//
// probe_copy_scale: y = 2 x in bf16.  Bound by bytes: every element is read
// once and written once (0.537 GB at 2 x 128^3 x 32, 0.160 ms at 3.35
// TB/s).  Variants: a 2-byte scalar access per thread against a 16-byte
// vector of 8 bf16 (the TPU's lane-sparse vs lane-dense views), and 2048 vs
// 8192 elements per block (the TPU probe's small vs big blocks).
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// --------------------------------------------------------------- copy-scale

constexpr int kCopyThreads = 256;

template <bool VEC, int BLOCK>
__global__ void __launch_bounds__(kCopyThreads)
copy_scale_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                  long long n) {
  const long long base = (long long)blockIdx.x * BLOCK;
  if constexpr (VEC) {
    // n % 8 == 0: a vector is whole or past the end
    const __nv_bfloat162 two = __floats2bfloat162_rn(2.f, 2.f);
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    uint4* yv = reinterpret_cast<uint4*>(y + base);
#pragma unroll
    for (int i = threadIdx.x; i < BLOCK / 8; i += kCopyThreads) {
      if (base + 8LL * i >= n) break;
      uint4 r = xv[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int q = 0; q < 4; ++q) h[q] = __hmul2(h[q], two);
      yv[i] = r;
    }
  } else {
    const bf16 two = __float2bfloat16_rn(2.f);
#pragma unroll
    for (int i = threadIdx.x; i < BLOCK; i += kCopyThreads) {
      const long long e = base + i;
      if (e < n) y[e] = __hmul(x[e], two);
    }
  }
}

template <bool VEC, int BLOCK>
void launch_copy(const bf16* x, bf16* y, long long n, cudaStream_t st) {
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  copy_scale_kernel<VEC, BLOCK><<<(unsigned)blocks, kCopyThreads, 0, st>>>(
      x, y, n);
}

}  // namespace

// y = 2 x over n bf16 elements; vec: 16-byte accesses (x and y 16-byte
// aligned, n % 8 == 0), else 2-byte; block: elements per block, 2048 or
// 8192.
extern "C" int probe_copy_scale(const void* x, void* y, long long n, int vec,
                                int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* yt = static_cast<bf16*>(y);
  if (vec && (n % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (vec && block == 2048)
    launch_copy<true, 2048>(xt, yt, n, st);
  else if (vec && block == 8192)
    launch_copy<true, 8192>(xt, yt, n, st);
  else if (!vec && block == 2048)
    launch_copy<false, 2048>(xt, yt, n, st);
  else if (!vec && block == 8192)
    launch_copy<false, 8192>(xt, yt, n, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Shared by the 3x3x3 convolution kernels of conv3d.cu (forward, input
// gradient) and conv3d_wgrad.cuh (weight gradient): storage
// type conversions, vector loads, and the norm-act prologue of the fused
// preact conv.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive channels as fp32; VEC = 4 needs an aligned address.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float v[VEC]);
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float v[1]) {
  v[0] = p[0];
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float v[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float v[1]) {
  v[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float v[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// ---------------------------------------------------------------------------
// Norm-act prologue (conv3d_same_na_fwd, conv3d_wgrad_na)
//
// Replaces the norm+act that cbim_tpu/ops/pallas/conv3d.py applies to the raw
// input tile in VMEM (_na_apply, _conv_kernel_cw_na, _wgrad_kernel_cw2_na):
// each staged input value becomes act((x - mean[b, c]) * rstd[b, c]) in fp32,
// rounded to the storage type (as _na_apply casts back to the compute dtype,
// and as the unfused inorm_apply stores it), before it meets the weights or
// the gradient.  The normalised tensor never exists in device memory.
// - SAME padding applies to the normalised input: taps outside the volume
//   stay 0 (they are never loaded, so never normalised), not act(-mean*rstd).
// - mean and rstd ([B, C] fp32, as inorm_stats returns them) are indexed by
//   each staged row's own sample: a 128-voxel block straddles two samples
//   whenever D*H*W is not a multiple of 128.
// NA = kNoNorm leaves the plain conv; else the act code of fused_norm.cu
// (0 none, 1 relu, 2 exact-erf gelu).
// ---------------------------------------------------------------------------

constexpr int kNoNorm = -1;
constexpr int kActNone = 0, kActRelu = 1, kActGelu = 2;

template <typename T, int NA>
__device__ __forceinline__ float norm_act(float v, float mean, float rstd) {
  float n = (v - mean) * rstd;
  if constexpr (NA == kActRelu) n = n < 0.f ? 0.f : n;  // a NaN stays
  if constexpr (NA == kActGelu)
    n = 0.5f * n * (1.f + erff(n * 0.70710678118654752f));
  return to_f32<T>(from_f32<T>(n));
}

// VEC channels of x at p, then the prologue with the statistics at ms/rs
// (the same channels of the row's sample); VEC = 4 needs aligned addresses.
template <typename T, int VEC, int NA>
__device__ __forceinline__ void load_na(const T* p, const float* ms,
                                        const float* rs, float v[VEC]) {
  load_vec<T, VEC>(p, v);
  if constexpr (NA != kNoNorm) {
    float m[VEC], r[VEC];
    load_vec<float, VEC>(ms, m);
    load_vec<float, VEC>(rs, r);
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = norm_act<T, NA>(v[q], m[q], r[q]);
  }
}

}  // namespace

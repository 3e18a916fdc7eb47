// Fused InstanceNorm(+activation) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cbim_tpu/ops/pallas/fused_norm.py:
//   inorm_stats  <- _stats_kernel / _compute_stats (and the NDHCW twin
//                   _stats_kernel_cw): per-(b, c) mean and rstd over S rows;
//   inorm_apply  <- _apply_kernel / _forward (and _apply_kernel_cw):
//                   y = act((x - mean) * rstd), act in {none, relu, gelu}.
//
// Layout: x is [B, S, C] with C contiguous (an NDHWC activation viewed as
// rows of channels).  Both kernels are bound by device-memory bytes: the
// stats pass reads the tensor once, the apply pass reads it once and writes
// it once, against 3.35 TB/s on an H100 SXM; the arithmetic is a few
// operations per byte.
//
// What the design does about it:
// - The TPU stats kernel carried a running sum across a sequential grid.
//   Blocks on Hopper run in no order, so the reduction is split: each block
//   reduces one chunk of rows for 32 channels (a warp reads 32 neighbouring
//   channels of a row, one 128-byte line in fp32) into fp64 partials, and a
//   second kernel folds the partials of each (b, c) in a fixed order.  No
//   atomics: the result is the same bit for bit on every run.
// - The partials are accumulated in fp64, so var = E[x^2] - mean^2 keeps its
//   digits at S = 128^3 rows, where an fp32 sum of squares would not.
// - The apply pass moves four channels per thread (16 bytes of fp32 or 8 of
//   bf16) when C is a multiple of four, and runs a grid-stride loop.
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChanPerBlock = 32;  // threadIdx.x: channels
constexpr int kRowLanes = 8;       // threadIdx.y: rows reduced side by side

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

// partial[b, chunk, 0, c] = sum of x[b, s, c] over the chunk's rows,
// partial[b, chunk, 1, c] = sum of squares, both fp64.
template <typename T>
__global__ void __launch_bounds__(kChanPerBlock * kRowLanes)
inorm_partial_kernel(const T* __restrict__ x, double* __restrict__ partial,
                     long long S, int C, long long rows_per_chunk,
                     int n_chunks) {
  const int c = blockIdx.x * kChanPerBlock + threadIdx.x;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const long long s_begin = (long long)chunk * rows_per_chunk;
  const long long s_end =
      s_begin + rows_per_chunk < S ? s_begin + rows_per_chunk : S;

  double sum = 0.0, sq = 0.0;
  if (c < C) {
    const T* xb = x + (long long)b * S * C + c;
    long long s = s_begin + threadIdx.y;
    // four independent loads in flight per thread
    for (; s + 3 * kRowLanes < s_end; s += 4 * kRowLanes) {
      const double v0 = to_f32(xb[s * C]);
      const double v1 = to_f32(xb[(s + kRowLanes) * C]);
      const double v2 = to_f32(xb[(s + 2 * kRowLanes) * C]);
      const double v3 = to_f32(xb[(s + 3 * kRowLanes) * C]);
      sum += (v0 + v1) + (v2 + v3);
      sq += (v0 * v0 + v1 * v1) + (v2 * v2 + v3 * v3);
    }
    for (; s < s_end; s += kRowLanes) {
      const double v = to_f32(xb[s * C]);
      sum += v;
      sq += v * v;
    }
  }

  __shared__ double sh_sum[kRowLanes][kChanPerBlock];
  __shared__ double sh_sq[kRowLanes][kChanPerBlock];
  sh_sum[threadIdx.y][threadIdx.x] = sum;
  sh_sq[threadIdx.y][threadIdx.x] = sq;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < kRowLanes; ++i) {
      sum += sh_sum[i][threadIdx.x];
      sq += sh_sq[i][threadIdx.x];
    }
    double* p = partial + ((long long)b * n_chunks + chunk) * 2 * C;
    p[c] = sum;
    p[C + c] = sq;
  }
}

// Folds the chunks of each (b, c) in a fixed order; mean and rstd in fp32.
__global__ void __launch_bounds__(kChanPerBlock * kRowLanes)
inorm_finalize_kernel(const double* __restrict__ partial,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      long long S, int C, int n_chunks, float eps) {
  const int c = blockIdx.x * kChanPerBlock + threadIdx.x;
  const int b = blockIdx.y;
  double sum = 0.0, sq = 0.0;
  if (c < C) {
    const double* pb = partial + (long long)b * n_chunks * 2 * C;
    for (int k = threadIdx.y; k < n_chunks; k += kRowLanes) {
      sum += pb[(long long)k * 2 * C + c];
      sq += pb[(long long)k * 2 * C + C + c];
    }
  }
  __shared__ double sh_sum[kRowLanes][kChanPerBlock];
  __shared__ double sh_sq[kRowLanes][kChanPerBlock];
  sh_sum[threadIdx.y][threadIdx.x] = sum;
  sh_sq[threadIdx.y][threadIdx.x] = sq;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < kRowLanes; ++i) {
      sum += sh_sum[i][threadIdx.x];
      sq += sh_sq[i][threadIdx.x];
    }
    const double m = sum / (double)S;
    double var = sq / (double)S - m * m;
    if (var < 0.0) var = 0.0;
    mean[(long long)b * C + c] = (float)m;
    rstd[(long long)b * C + c] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

enum Act { kActNone = 0, kActRelu = 1, kActGelu = 2 };

template <int ACT>
__device__ __forceinline__ float act_fn(float n) {
  if (ACT == kActRelu) return n > 0.f ? n : 0.f;
  if (ACT == kActGelu) return 0.5f * n * (1.f + erff(n * 0.70710678118654752f));
  return n;
}

// Four consecutive elements as one aligned vector access.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  __device__ static void load(const float* p, float v[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  }
  __device__ static void store(__nv_bfloat16* p, const float v[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    r.x = *reinterpret_cast<const unsigned int*>(&lo);
    r.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
};

// VEC = 4: C % 4 == 0 and the pointers are aligned for the vector access.
template <typename T, int ACT, int VEC>
__global__ void __launch_bounds__(256)
inorm_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, long long S, int C,
                   long long n_vec) {
  const long long SC = S * (long long)C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * VEC;          // first element of this vector
    const long long b = e / SC;
    const int c = (int)(e % C);
    const float* mb = mean + b * C + c;
    const float* rb = rstd + b * C + c;
    if (VEC == 4) {
      float v[4];
      Vec4<T>::load(x + e, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = act_fn<ACT>((v[q] - mb[q]) * rb[q]);
      Vec4<T>::store(y + e, v);
    } else {
      y[e] = from_f32<T>(act_fn<ACT>((to_f32(x[e]) - mb[0]) * rb[0]));
    }
  }
}

template <typename T, int ACT>
void launch_apply(const void* x, void* y, const float* mean, const float* rstd,
                  long long B, long long S, int C, cudaStream_t stream) {
  const long long n = B * S * C;
  const int align = sizeof(T) * 4;
  const bool vec = C % 4 == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)y % align == 0;
  const long long n_vec = vec ? n / 4 : n;
  const int threads = 256;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 waves
  if (blocks < 1) blocks = 1;
  if (vec) {
    inorm_apply_kernel<T, ACT, 4><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, S, C, n_vec);
  } else {
    inorm_apply_kernel<T, ACT, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, S, C, n_vec);
  }
}

template <typename T>
void launch_apply_act(int act, const void* x, void* y, const float* mean,
                      const float* rstd, long long B, long long S, int C,
                      cudaStream_t stream) {
  if (act == kActRelu)
    launch_apply<T, kActRelu>(x, y, mean, rstd, B, S, C, stream);
  else if (act == kActGelu)
    launch_apply<T, kActGelu>(x, y, mean, rstd, B, S, C, stream);
  else
    launch_apply<T, kActNone>(x, y, mean, rstd, B, S, C, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  partial: fp64 scratch of B*n_chunks*2*C.
extern "C" int inorm_stats(const void* x, int dtype, long long B, long long S,
                           int C, long long rows_per_chunk, int n_chunks,
                           float eps, void* partial, void* mean, void* rstd,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 threads(kChanPerBlock, kRowLanes);
  const dim3 grid((C + kChanPerBlock - 1) / kChanPerBlock, n_chunks,
                  (unsigned)B);
  double* part = static_cast<double*>(partial);
  if (dtype == 0) {
    inorm_partial_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(x), part, S, C, rows_per_chunk, n_chunks);
  } else if (dtype == 1) {
    inorm_partial_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), part, S, C, rows_per_chunk,
        n_chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 fgrid((C + kChanPerBlock - 1) / kChanPerBlock, (unsigned)B);
  inorm_finalize_kernel<<<fgrid, threads, 0, st>>>(
      part, static_cast<float*>(mean), static_cast<float*>(rstd), S, C,
      n_chunks, eps);
  return (int)cudaGetLastError();
}

// act: 0 none, 1 relu, 2 gelu (exact erf).
extern "C" int inorm_apply(const void* x, void* y, const void* mean,
                           const void* rstd, int dtype, int act, long long B,
                           long long S, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if (dtype == 0)
    launch_apply_act<float>(act, x, y, m, r, B, S, C, st);
  else if (dtype == 1)
    launch_apply_act<__nv_bfloat16>(act, x, y, m, r, B, S, C, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Fused InstanceNorm(+activation) forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cbim_tpu/ops/pallas/fused_norm.py:
//   inorm_stats  <- _stats_kernel / _compute_stats (and the NDHCW twin
//                   _stats_kernel_cw): per-(b, c) mean and rstd over S rows;
//   inorm_apply  <- _apply_kernel / _forward (and _apply_kernel_cw):
//                   y = act((x - mean) * rstd), act in {none, relu, gelu};
//   inorm_bwd_stats, inorm_bwd_apply <- _backward / _backward_cw (see the
//                   backward section below).
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

// ---------------------------------------------------------------------------
// Backward (replaces _bwd_stats_kernel / _bwd_apply_kernel of _backward and
// their NDHCW twins in _backward_cw):
//   x_hat = (x - mean) * rstd,  dy' = dy * act'(x_hat),
//   a = mean_S(dy'),  b = mean_S(dy' * x_hat)          (inorm_bwd_stats)
//   dx = rstd * (dy' - a - x_hat * b), in x's dtype    (inorm_bwd_apply)
// Bound by bytes like the forward: the stats pass reads x and dy once, the
// apply pass reads both again and writes dx.  The stats pass is the same
// split reduction as inorm_stats (fp64 partials per chunk of rows, folded
// in a fixed order), so its results repeat bit for bit.
// ---------------------------------------------------------------------------

// d act(n) / dn from the pre-activation n; gelu: Phi(n) + n * phi(n).
template <int ACT>
__device__ __forceinline__ float act_grad(float n) {
  if (ACT == kActRelu) return n > 0.f ? 1.f : 0.f;
  if (ACT == kActGelu)
    return 0.5f * (1.f + erff(n * 0.70710678118654752f)) +
           n * 0.39894228040143268f * expf(-0.5f * n * n);
  return 1.f;
}

// partial[b, chunk, 0, c] = sum of dy', partial[b, chunk, 1, c] = sum of
// dy' * x_hat over the chunk's rows, both fp64.
template <typename T, int ACT>
__global__ void __launch_bounds__(kChanPerBlock * kRowLanes)
inorm_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         double* __restrict__ partial, long long S, int C,
                         long long rows_per_chunk, int n_chunks) {
  const int c = blockIdx.x * kChanPerBlock + threadIdx.x;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const long long s_begin = (long long)chunk * rows_per_chunk;
  const long long s_end =
      s_begin + rows_per_chunk < S ? s_begin + rows_per_chunk : S;

  double sa = 0.0, sb = 0.0;
  if (c < C) {
    const long long off = (long long)b * S * C + c;
    const T* xb = x + off;
    const T* gb = dy + off;
    const float m = mean[(long long)b * C + c];
    const float r = rstd[(long long)b * C + c];
    long long s = s_begin + threadIdx.y;
    // two independent rows in flight per thread
    for (; s + kRowLanes < s_end; s += 2 * kRowLanes) {
      const float n0 = (to_f32(xb[s * C]) - m) * r;
      const float n1 = (to_f32(xb[(s + kRowLanes) * C]) - m) * r;
      const float d0 = to_f32(gb[s * C]) * act_grad<ACT>(n0);
      const float d1 = to_f32(gb[(s + kRowLanes) * C]) * act_grad<ACT>(n1);
      sa += (double)d0 + (double)d1;
      sb += (double)(d0 * n0) + (double)(d1 * n1);
    }
    for (; s < s_end; s += kRowLanes) {
      const float n0 = (to_f32(xb[s * C]) - m) * r;
      const float d0 = to_f32(gb[s * C]) * act_grad<ACT>(n0);
      sa += d0;
      sb += d0 * n0;
    }
  }

  __shared__ double sh_a[kRowLanes][kChanPerBlock];
  __shared__ double sh_b[kRowLanes][kChanPerBlock];
  sh_a[threadIdx.y][threadIdx.x] = sa;
  sh_b[threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < kRowLanes; ++i) {
      sa += sh_a[i][threadIdx.x];
      sb += sh_b[i][threadIdx.x];
    }
    double* p = partial + ((long long)b * n_chunks + chunk) * 2 * C;
    p[c] = sa;
    p[C + c] = sb;
  }
}

// Folds the chunks of each (b, c) in a fixed order; red[b, 0, c] = a and
// red[b, 1, c] = b (means over S) in fp32.
__global__ void __launch_bounds__(kChanPerBlock * kRowLanes)
inorm_bwd_finalize_kernel(const double* __restrict__ partial,
                          float* __restrict__ red, long long S, int C,
                          int n_chunks) {
  const int c = blockIdx.x * kChanPerBlock + threadIdx.x;
  const int b = blockIdx.y;
  double sa = 0.0, sb = 0.0;
  if (c < C) {
    const double* pb = partial + (long long)b * n_chunks * 2 * C;
    for (int k = threadIdx.y; k < n_chunks; k += kRowLanes) {
      sa += pb[(long long)k * 2 * C + c];
      sb += pb[(long long)k * 2 * C + C + c];
    }
  }
  __shared__ double sh_a[kRowLanes][kChanPerBlock];
  __shared__ double sh_b[kRowLanes][kChanPerBlock];
  sh_a[threadIdx.y][threadIdx.x] = sa;
  sh_b[threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < kRowLanes; ++i) {
      sa += sh_a[i][threadIdx.x];
      sb += sh_b[i][threadIdx.x];
    }
    red[(long long)b * 2 * C + c] = (float)(sa / (double)S);
    red[(long long)b * 2 * C + C + c] = (float)(sb / (double)S);
  }
}

template <typename T, int ACT, int VEC>
__global__ void __launch_bounds__(256)
inorm_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       T* __restrict__ dx, const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const float* __restrict__ red, long long S, int C,
                       long long n_vec) {
  const long long SC = S * (long long)C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * VEC;
    const long long b = e / SC;
    const int c = (int)(e % C);
    const float* mb = mean + b * C + c;
    const float* rb = rstd + b * C + c;
    const float* ab = red + b * 2 * C + c;
    const float* bb = ab + C;
    float xv[VEC], gv[VEC];
    if constexpr (VEC == 4) {
      Vec4<T>::load(x + e, xv);
      Vec4<T>::load(dy + e, gv);
    } else {
      xv[0] = to_f32(x[e]);
      gv[0] = to_f32(dy[e]);
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float n = (xv[q] - mb[q]) * rb[q];
      const float d = gv[q] * act_grad<ACT>(n);
      xv[q] = rb[q] * (d - ab[q] - n * bb[q]);
    }
    if constexpr (VEC == 4)
      Vec4<T>::store(dx + e, xv);
    else
      dx[e] = from_f32<T>(xv[0]);
  }
}

template <typename T, int ACT>
void launch_bwd_stats(const void* x, const void* dy, const float* mean,
                      const float* rstd, double* partial, long long B,
                      long long S, int C, long long rows_per_chunk,
                      int n_chunks, cudaStream_t stream) {
  const dim3 threads(kChanPerBlock, kRowLanes);
  const dim3 grid((C + kChanPerBlock - 1) / kChanPerBlock, n_chunks,
                  (unsigned)B);
  inorm_bwd_partial_kernel<T, ACT><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd,
      partial, S, C, rows_per_chunk, n_chunks);
}

template <typename T>
void launch_bwd_stats_act(int act, const void* x, const void* dy,
                          const float* mean, const float* rstd,
                          double* partial, long long B, long long S, int C,
                          long long rows_per_chunk, int n_chunks,
                          cudaStream_t stream) {
  if (act == kActRelu)
    launch_bwd_stats<T, kActRelu>(x, dy, mean, rstd, partial, B, S, C,
                                  rows_per_chunk, n_chunks, stream);
  else if (act == kActGelu)
    launch_bwd_stats<T, kActGelu>(x, dy, mean, rstd, partial, B, S, C,
                                  rows_per_chunk, n_chunks, stream);
  else
    launch_bwd_stats<T, kActNone>(x, dy, mean, rstd, partial, B, S, C,
                                  rows_per_chunk, n_chunks, stream);
}

template <typename T, int ACT>
void launch_bwd_apply(const void* x, const void* dy, void* dx,
                      const float* mean, const float* rstd, const float* red,
                      long long B, long long S, int C, cudaStream_t stream) {
  const long long n = B * S * C;
  const int align = sizeof(T) * 4;
  const bool vec = C % 4 == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)dy % align == 0 && (uintptr_t)dx % align == 0;
  const long long n_vec = vec ? n / 4 : n;
  const int threads = 256;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (vec)
    inorm_bwd_apply_kernel<T, ACT, 4><<<(unsigned)blocks, threads, 0, stream>>>(
        xt, gt, dxt, mean, rstd, red, S, C, n_vec);
  else
    inorm_bwd_apply_kernel<T, ACT, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        xt, gt, dxt, mean, rstd, red, S, C, n_vec);
}

template <typename T>
void launch_bwd_apply_act(int act, const void* x, const void* dy, void* dx,
                          const float* mean, const float* rstd,
                          const float* red, long long B, long long S, int C,
                          cudaStream_t stream) {
  if (act == kActRelu)
    launch_bwd_apply<T, kActRelu>(x, dy, dx, mean, rstd, red, B, S, C, stream);
  else if (act == kActGelu)
    launch_bwd_apply<T, kActGelu>(x, dy, dx, mean, rstd, red, B, S, C, stream);
  else
    launch_bwd_apply<T, kActNone>(x, dy, dx, mean, rstd, red, B, S, C, stream);
}

}  // namespace

// x, dy: [B, S, C] of one dtype (0 float32, 1 bfloat16); mean, rstd: [B, C]
// fp32; partial: fp64 scratch of B*n_chunks*2*C; red: [B, 2, C] fp32.
extern "C" int inorm_bwd_stats(const void* x, const void* dy, const void* mean,
                               const void* rstd, int dtype, int act,
                               long long B, long long S, int C,
                               long long rows_per_chunk, int n_chunks,
                               void* partial, void* red, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  double* part = static_cast<double*>(partial);
  if (dtype == 0)
    launch_bwd_stats_act<float>(act, x, dy, m, r, part, B, S, C,
                                rows_per_chunk, n_chunks, st);
  else if (dtype == 1)
    launch_bwd_stats_act<__nv_bfloat16>(act, x, dy, m, r, part, B, S, C,
                                        rows_per_chunk, n_chunks, st);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 threads(kChanPerBlock, kRowLanes);
  const dim3 fgrid((C + kChanPerBlock - 1) / kChanPerBlock, (unsigned)B);
  inorm_bwd_finalize_kernel<<<fgrid, threads, 0, st>>>(
      part, static_cast<float*>(red), S, C, n_chunks);
  return (int)cudaGetLastError();
}

// dx = rstd * (dy' - a - x_hat * b) in x's dtype; act as inorm_apply.
extern "C" int inorm_bwd_apply(const void* x, const void* dy, void* dx,
                               const void* mean, const void* rstd,
                               const void* red, int dtype, int act,
                               long long B, long long S, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* rd = static_cast<const float*>(red);
  if (dtype == 0)
    launch_bwd_apply_act<float>(act, x, dy, dx, m, r, rd, B, S, C, st);
  else if (dtype == 1)
    launch_bwd_apply_act<__nv_bfloat16>(act, x, dy, dx, m, r, rd, B, S, C, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

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

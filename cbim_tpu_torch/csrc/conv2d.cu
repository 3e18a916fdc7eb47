// Stride-1, zero-pad-1, 3x3 convolution for Hopper (sm_90a): the forward
// (which also computes the input gradient, on flip-swapped weights) and the
// weight gradient (conv2d_wgrad, further below).
//
// Replaces the Pallas TPU kernels of cbim_tpu/ops/pallas/conv2d.py:
//   _conv_kernel2 / conv2d_same (and the dgrad of conv2d_same_t, the same
//   kernel on _flip_swap2 weights), and _wgrad_kernel2 / conv2d_wgrad.
// The TPU kernel's tap packing (K = (kh, c) = 3C, columns (kw, f) padded to
// 128-lane groups) filled MXU tiles at C = 32 and is not carried over.
//
//   y[b, h, w, f] = sum_{kh, kw, c} x[b, h+kh-1, w+kw-1, c] * wp[kh, kw, c, f]
// x: [B, H, W, C], wp: [3, 3, C, F] (the wrapper packs torch's
// [F, C, 3, 3]), y: [B, H, W, F]; fp32 or bf16 storage, fp32 sums.
//
// What bounds it on the H100: arithmetic.  MedFormer-2D's full-resolution
// convolutions at the ACDC recipe are 2*9*C*F FLOPs per pixel, 38.7 GFLOP
// per conv at batch 32 of 256^2 (C = F = 32), against 67 TFLOP/s of fp32
// FMA outside the tensor cores; the bytes (x, w and y once) are 8.4 MB in
// fp32, 2.5 us at 3.35 TB/s.
//
// What the design does about it: the implicit GEMM of conv3d.cu with nine
// taps.  M is the output pixels, N the output channels, K = 9 taps x C.  A
// block owns a 128-pixel x BN-channel tile; for each tap and each
// 16-channel slice it stages the shifted input rows (zeros outside the
// image, so ragged H/W need no padded copy) and the weight slice in shared
// memory, and each of its 128 threads accumulates an 8 x BN/8 register
// tile: 64 FMAs per pair of shared-memory vector loads at BN = 64.  The taps
// re-read neighbouring input rows, which L1 and the 50 MB L2 serve.  Tensor
// cores (mma/wgmma in bf16) and TMA staging are the next steps.
//
// The extern "C" entries launch on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgrad_fold.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kBM = 128;       // output pixels per block
constexpr int kBK = 16;        // input channels per staged slice
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kTM = kBM / 16;  // pixels per thread

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

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float v[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) p[q] = v[q];
  }
}

template <typename T, int BN, int VEC>
__global__ void __launch_bounds__(kThreads)
conv2d_same_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                       T* __restrict__ y, int H, int W, int C, int F,
                       long long M) {
  constexpr int TN = BN / 8;  // output channels per thread
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // The A row this thread stages is output pixel m0 + tid.
  const long long m_load = m0 + tid;
  const bool row_ok = m_load < M;
  int w0 = 0, h0 = 0;
  long long b0 = 0;
  if (row_ok) {
    long long r = m_load;
    w0 = (int)(r % W); r /= W;
    h0 = (int)(r % H);
    b0 = r / H;
  }

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    const int sh = h0 + t / 3 - 1;
    const int sw = w0 + t % 3 - 1;
    const bool valid = row_ok && sh >= 0 && sh < H && sw >= 0 && sw < W;
    const long long src_off =
        valid ? ((b0 * H + sh) * (long long)W + sw) * C : 0;
    const T* src = x + src_off;
    const T* wt = wp + (long long)t * C * F;

    for (int c0 = 0; c0 < C; c0 += kBK) {
#pragma unroll
      for (int j = 0; j < kBK / VEC; ++j) {
        const int c = c0 + j * VEC;
        float v[VEC];
        if (valid && c < C) {
          load_vec<T, VEC>(src + c, v);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) As[j * VEC + q][tid] = v[q];
      }
#pragma unroll
      for (int j = 0; j < kBK * BN / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int n = e % BN;
        const int k = e / BN;
        const int c = c0 + k;
        const int f = n0 + n;
        Bs[k][n] = (c < C && f < F) ? to_f32(wt[(long long)c * F + f]) : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM], bv[TN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[k][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) continue;
    T* yr = y + m * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = n0 + tx * TN + j;
      if (f < F) yr[f] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BN>
void launch_fwd(const void* x, const void* w, void* y, int B, int H, int W,
                int C, int F, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((F + BN - 1) / BN));
  const bool vec = C % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec)
    conv2d_same_fwd_kernel<T, BN, 4><<<grid, kThreads, 0, stream>>>(
        xt, wt, yt, H, W, C, F, M);
  else
    conv2d_same_fwd_kernel<T, BN, 1><<<grid, kThreads, 0, stream>>>(
        xt, wt, yt, H, W, C, F, M);
}

template <typename T>
void launch_fwd_dtype(const void* x, const void* w, void* y, int B, int H,
                      int W, int C, int F, cudaStream_t stream) {
  if (F <= 32)
    launch_fwd<T, 32>(x, w, y, B, H, W, C, F, stream);
  else
    launch_fwd<T, 64>(x, w, y, B, H, W, C, F, stream);
}

// ---------------------------------------------------------------------------
// Weight gradient (conv2d_wgrad)
//
// Replaces _wgrad_kernel2 / conv2d_wgrad of cbim_tpu/ops/pallas/conv2d.py:
//   dW[kh, kw, c, f] = sum_{b, h, w} x[b, h+kh-1, w+kw-1, c] * g[b, h, w, f],
// zeros outside the image; x [B, H, W, C], g [B, H, W, F], fp32 or bf16
// storage, fp32 sums, dW [3, 3, C, F] fp32.
//
// What bounds it: arithmetic, as the forward (2*9*C*F FLOPs per pixel), and
// the reduction runs over K = every pixel (2.1 M at 32 x 256^2) into a small
// output (9*C*F values).  The TPU kernel accumulated that output across a
// sequential grid; Hopper's blocks run in no order, so the reduction is
// split: a block owns one chunk of pixels and one (kh, c-tile, f-tile) of dW
// and writes fp32 partials; a second kernel folds the chunks in a fixed
// order.  No atomics, so results repeat bit for bit.  The three kw taps of a
// block share each staged gradient row (3 x 16 FMAs per pair of
// shared-memory loads per thread), and the shifted input rows are staged
// with zeros outside the image, so ragged H/W need no padded copy.
// ---------------------------------------------------------------------------

constexpr int kWgBK = 16;  // pixels per staged step

// partial[chunk, kh, kw, c, f]; grid.x = (kh, c-tile, f-tile), grid.y =
// chunk of pixels.  Each thread holds a 4 (c) x 4 (f) tile for each of the
// three kw taps.
template <typename T, int BC, int BF, int VEC>
__global__ void __launch_bounds__(BC * BF / 16)
conv2d_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            float* __restrict__ partial, int H, int W, int C,
                            int F, int M, int rows_per_chunk) {
  constexpr int kWgThreads = BC * BF / 16;
  constexpr int TXN = BF / 4;  // threads along f
  __shared__ __align__(16) float Xs[3][kWgBK][BC];
  __shared__ __align__(16) float Gs[kWgBK][BF];

  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int n_ct = (C + BC - 1) / BC;
  const int n_ft = (F + BF - 1) / BF;
  int tile = blockIdx.x;
  const int ft = tile % n_ft;
  tile /= n_ft;
  const int ct = tile % n_ct;
  const int kh = tile / n_ct;
  const int c0 = ct * BC, f0 = ft * BF;
  const int chunk = blockIdx.y;
  const int m_begin = chunk * rows_per_chunk;
  const int m_end = min(M, m_begin + rows_per_chunk);

  float acc[3][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kWgBK) {
    // input rows of the three kw taps, zeros outside the image
    for (int e = tid; e < kWgBK * BC / VEC; e += kWgThreads) {
      const int r = e / (BC / VEC);
      const int cv = (e % (BC / VEC)) * VEC;
      const int m = m0 + r;
      const int c = c0 + cv;
      int wq = 0, hq = 0, bq = 0;
      bool ok = m < m_end && c < C;
      if (ok) {
        int t = m;
        wq = t % W; t /= W;
        hq = t % H;
        bq = t / H;
      }
      const int sh = hq + kh - 1;
      ok = ok && sh >= 0 && sh < H;
      const long long row = ((long long)bq * H + sh) * (long long)W;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int sw = wq + kw - 1;
        float v[VEC];
        if (ok && sw >= 0 && sw < W) {
          load_vec<T, VEC>(x + (row + sw) * C + c, v);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v[q] = 0.f;
        }
        store_vec<VEC>(&Xs[kw][r][cv], v);
      }
    }
    // gradient rows
    for (int e = tid; e < kWgBK * BF / VEC; e += kWgThreads) {
      const int r = e / (BF / VEC);
      const int fv = (e % (BF / VEC)) * VEC;
      const int m = m0 + r;
      const int f = f0 + fv;
      float v[VEC];
      if (m < m_end && f < F) {
        load_vec<T, VEC>(g + (long long)m * F + f, v);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = 0.f;
      }
      store_vec<VEC>(&Gs[r][fv], v);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kWgBK; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&Gs[k][tx * 4]);
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float4 av = *reinterpret_cast<const float4*>(&Xs[kw][k][ty * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[kw][i][j] = fmaf(a[i], b[j], acc[kw][i][j]);
      }
    }
    __syncthreads();
  }

  float* out = partial + (long long)chunk * kTaps * C * F;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const long long tap = (long long)(kh * 3 + kw) * C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx * 4 + j;
        if (f < F) out[(tap + c) * F + f] = acc[kw][i][j];
      }
    }
  }
}

template <typename T, int BC, int BF>
void launch_wgrad(const void* x, const void* g, float* partial, int B, int H,
                  int W, int C, int F, int rows_per_chunk, int n_chunks,
                  cudaStream_t stream) {
  const int M = B * H * W;
  const int tiles = 3 * ((C + BC - 1) / BC) * ((F + BF - 1) / BF);
  const dim3 grid((unsigned)tiles, (unsigned)n_chunks);
  const bool vec = C % 4 == 0 && F % 4 == 0 &&
                   (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)g % (4 * sizeof(T)) == 0;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (vec)
    conv2d_wgrad_partial_kernel<T, BC, BF, 4><<<grid, BC * BF / 16, 0, stream>>>(
        xt, gt, partial, H, W, C, F, M, rows_per_chunk);
  else
    conv2d_wgrad_partial_kernel<T, BC, BF, 1><<<grid, BC * BF / 16, 0, stream>>>(
        xt, gt, partial, H, W, C, F, M, rows_per_chunk);
}

// A 64-wide tile where the channel count is a multiple of 64, else 32 (no
// half-empty tiles at C = 96, 160 or the ragged widths).
template <typename T>
void launch_wgrad_tiles(const void* x, const void* g, float* partial, int B,
                        int H, int W, int C, int F, int rows_per_chunk,
                        int n_chunks, cudaStream_t stream) {
  const bool wide_c = C % 64 == 0, wide_f = F % 64 == 0;
  if (wide_c && wide_f)
    launch_wgrad<T, 64, 64>(x, g, partial, B, H, W, C, F, rows_per_chunk,
                            n_chunks, stream);
  else if (wide_c)
    launch_wgrad<T, 64, 32>(x, g, partial, B, H, W, C, F, rows_per_chunk,
                            n_chunks, stream);
  else if (wide_f)
    launch_wgrad<T, 32, 64>(x, g, partial, B, H, W, C, F, rows_per_chunk,
                            n_chunks, stream);
  else
    launch_wgrad<T, 32, 32>(x, g, partial, B, H, W, C, F, rows_per_chunk,
                            n_chunks, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  w is packed [3, 3, C, F] in x's dtype.
extern "C" int conv2d_same_fwd(const void* x, const void* w, void* y,
                               int dtype, int B, int H, int W, int C, int F,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fwd_dtype<float>(x, w, y, B, H, W, C, F, st);
  else if (dtype == 1)
    launch_fwd_dtype<__nv_bfloat16>(x, w, y, B, H, W, C, F, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  partial: fp32 scratch of
// n_chunks * 9 * C * F; dw: [3, 3, C, F] fp32.  rows_per_chunk * n_chunks
// must cover B * H * W pixels.
extern "C" int conv2d_wgrad(const void* x, const void* g, void* partial,
                            void* dw, int dtype, int B, int H, int W, int C,
                            int F, int rows_per_chunk, int n_chunks,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    launch_wgrad_tiles<float>(x, g, part, B, H, W, C, F, rows_per_chunk,
                              n_chunks, st);
  else if (dtype == 1)
    launch_wgrad_tiles<__nv_bfloat16>(x, g, part, B, H, W, C, F,
                                      rows_per_chunk, n_chunks, st);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_wgrad_fold(part, static_cast<float*>(dw),
                           (long long)kTaps * C * F, n_chunks, st);
}

// Stride-1, zero-pad-1, 3x3x3 convolution for Hopper (sm_90a): the forward
// (which also computes the input gradient, on flip-swapped weights) and the
// weight gradient (conv3d_wgrad, further below), each also with a fused
// InstanceNorm+act prologue (conv3d_same_na_fwd, conv3d_wgrad_na: the
// preact conv(act(IN(x))), see "Norm-act prologue" below).
//
// Replaces the Pallas TPU kernels of cbim_tpu/ops/pallas/conv3d.py:
//   _conv_kernel / _conv3d_same_pallas / conv3d_same      (NDHWC),
//   _conv_kernel_cw / conv3d_same_cw                     (NDHCW twin),
//   _conv_kernel_cw2 / conv3d_same_cw2                   (NDHCW twin).
// The NDHCW twins exist for TPU lane density only; their math is this one
// NDHWC kernel.  The tap packing of the TPU kernel (K = 3*C, N = 9*F) existed
// to fill 128-lane MXU tiles at C = 32 and is not carried over.
//
//   y[b, d, h, w, f] = sum_{kd, kh, kw, c} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                        * wp[kd, kh, kw, c, f]
// x: [B, D, H, W, C], wp: [3, 3, 3, C, F] (the wrapper packs torch's
// [F, C, 3, 3, 3]), y: [B, D, H, W, F]; fp32 or bf16 storage, fp32 sums.
//
// What bounds it on the H100: arithmetic.  The full-resolution convolutions
// of MedFormer-3D are 2*27*C*F FLOPs per voxel, about 2 TFLOP per 128^3
// window, against 67 TFLOP/s of fp32 FMA outside the tensor cores.
//
// What the design does about it: an implicit GEMM on CUDA cores.  M is the
// output voxels, N the output channels, K = 27 taps x C.  A block owns a
// 128-voxel x BN-channel tile; for each tap and each 16-channel slice it
// stages the shifted input rows (zeros outside the volume, so ragged D/H/W
// need no padding copy) and the weight slice in shared memory, and each of
// its 128 threads accumulates an 8 x BN/8 register tile, 64 FMAs per pair
// of shared-memory vector loads at BN = 64.  The weights never sit whole in
// shared memory: 27*C*F*4 bytes is 1.3 MB at C = 192, F = 64.
// The taps re-read neighbouring input rows, which L1 and the 50 MB L2 serve.
// Tensor cores (mma/wgmma in bf16) and TMA staging are the next steps.
// With the norm-act prologue (conv3d_same_na_fwd) each input value is
// normalised where it is staged: once per tap and F-tile, 27x per input
// value at F <= 64.  With the exact-erf GELU that costs about as many
// instructions as the FMAs it feeds at BN = 32; a block of 128 voxels along
// W that staged its normalised halo rows once would still normalise each
// value 9x (once in each of the 9 blocks whose (d, h) rows read it), so
// cutting it to about once takes 3D output tiles (ROADMAP B7).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output voxels per block
constexpr int kBK = 16;        // input channels per staged slice
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kTM = kBM / 16;  // voxels per thread

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
  if constexpr (NA == kActRelu) n = n > 0.f ? n : 0.f;
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

template <typename T, int BN, int VEC, int NA>
__global__ void __launch_bounds__(kThreads)
conv3d_same_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                       T* __restrict__ y, const float* __restrict__ mean,
                       const float* __restrict__ rstd, int D, int H, int W,
                       int C, int F, long long M) {
  constexpr int TN = BN / 8;  // output channels per thread
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // The A row this thread stages is output voxel m0 + tid.
  const long long m_load = m0 + tid;
  const bool row_ok = m_load < M;
  int w0 = 0, h0 = 0, d0 = 0;
  long long b0 = 0;
  if (row_ok) {
    long long r = m_load;
    w0 = (int)(r % W); r /= W;
    h0 = (int)(r % H); r /= H;
    d0 = (int)(r % D);
    b0 = r / D;
  }
  // this row's sample's statistics (NA only)
  const long long st = NA == kNoNorm ? 0 : b0 * C;
  const float* ms = mean + st;
  const float* rs = rstd + st;

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < 27; ++t) {
    const int sd = d0 + t / 9 - 1;
    const int sh = h0 + (t / 3) % 3 - 1;
    const int sw = w0 + t % 3 - 1;
    const bool valid = row_ok && sd >= 0 && sd < D && sh >= 0 && sh < H &&
                       sw >= 0 && sw < W;
    const long long src_off =
        valid ? (((b0 * D + sd) * H + sh) * (long long)W + sw) * C : 0;
    const T* src = x + src_off;
    const T* wt = wp + (long long)t * C * F;

    for (int c0 = 0; c0 < C; c0 += kBK) {
#pragma unroll
      for (int j = 0; j < kBK / VEC; ++j) {
        const int c = c0 + j * VEC;
        float v[VEC];
        if (valid && c < C) {
          load_na<T, VEC, NA>(src + c, ms + c, rs + c, v);
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

template <typename T, int BN, int NA>
void launch(const void* x, const void* w, void* y, const float* mean,
            const float* rstd, int B, int D, int H, int W, int C, int F,
            cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((F + BN - 1) / BN));
  const bool vec = C % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)mean % 16 == 0 && (uintptr_t)rstd % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec)
    conv3d_same_fwd_kernel<T, BN, 4, NA><<<grid, kThreads, 0, stream>>>(
        xt, wt, yt, mean, rstd, D, H, W, C, F, M);
  else
    conv3d_same_fwd_kernel<T, BN, 1, NA><<<grid, kThreads, 0, stream>>>(
        xt, wt, yt, mean, rstd, D, H, W, C, F, M);
}

template <typename T, int NA>
void launch_dtype(const void* x, const void* w, void* y, const float* mean,
                  const float* rstd, int B, int D, int H, int W, int C, int F,
                  cudaStream_t stream) {
  if (F <= 32)
    launch<T, 32, NA>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else
    launch<T, 64, NA>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
}

// The forward with prologue ``na`` (kNoNorm or an act code); false for a
// bad code.
template <typename T>
bool launch_fwd(int na, const void* x, const void* w, void* y,
                const float* mean, const float* rstd, int B, int D, int H,
                int W, int C, int F, cudaStream_t stream) {
  if (na == kNoNorm)
    launch_dtype<T, kNoNorm>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else if (na == kActNone)
    launch_dtype<T, kActNone>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else if (na == kActRelu)
    launch_dtype<T, kActRelu>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else if (na == kActGelu)
    launch_dtype<T, kActGelu>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else
    return false;
  return true;
}

// ---------------------------------------------------------------------------
// Weight gradient (conv3d_wgrad)
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
// ---------------------------------------------------------------------------

constexpr int kWgBK = 16;  // voxels per staged step

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float v[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) p[q] = v[q];
  }
}

// partial[chunk, kd, kh, kw, c, f]; grid.x = (kd, kh, c-tile, f-tile),
// grid.y = chunk of voxels.  Each thread holds a 4 (c) x 4 (f) tile for each
// of the three kw taps.
template <typename T, int BC, int BF, int VEC, int NA>
__global__ void __launch_bounds__(BC * BF / 16)
conv3d_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd,
                            float* __restrict__ partial, int D, int H, int W,
                            int C, int F, int M, int rows_per_chunk) {
  constexpr int kThreads = BC * BF / 16;
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
  const int kdh = tile / n_ct;
  const int kd = kdh / 3, kh = kdh % 3;
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
    // input rows of the three kw taps, zeros outside the volume
    for (int e = tid; e < kWgBK * BC / VEC; e += kThreads) {
      const int r = e / (BC / VEC);
      const int cv = (e % (BC / VEC)) * VEC;
      const int m = m0 + r;
      const int c = c0 + cv;
      int wq = 0, hq = 0, dq = 0, bq = 0;
      bool ok = m < m_end && c < C;
      if (ok) {
        int t = m;
        wq = t % W; t /= W;
        hq = t % H; t /= H;
        dq = t % D;
        bq = t / D;
      }
      const int sd = dq + kd - 1, sh = hq + kh - 1;
      ok = ok && sd >= 0 && sd < D && sh >= 0 && sh < H;
      const long long row = (((long long)bq * D + sd) * H + sh) * (long long)W;
      // this row's sample's statistics (NA only)
      const long long st = NA == kNoNorm ? 0 : (long long)bq * C + c;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int sw = wq + kw - 1;
        float v[VEC];
        if (ok && sw >= 0 && sw < W) {
          load_na<T, VEC, NA>(x + (row + sw) * C + c, mean + st, rstd + st, v);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v[q] = 0.f;
        }
        store_vec<VEC>(&Xs[kw][r][cv], v);
      }
    }
    // gradient rows
    for (int e = tid; e < kWgBK * BF / VEC; e += kThreads) {
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

  float* out = partial + (long long)chunk * 27 * C * F;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const long long tap = (long long)(kdh * 3 + kw) * C;
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

// dw[i] = sum over chunks of partial[chunk, i], in chunk order.
__global__ void __launch_bounds__(256)
conv3d_wgrad_fold_kernel(const float* __restrict__ partial,
                         float* __restrict__ dw, long long n, int n_chunks) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += partial[(long long)k * n + i];
    dw[i] = s;
  }
}

template <typename T, int BC, int BF, int NA>
void launch_wgrad(const void* x, const void* g, const float* mean,
                  const float* rstd, float* partial, int B, int D, int H,
                  int W, int C, int F, int rows_per_chunk, int n_chunks,
                  cudaStream_t stream) {
  const int M = B * D * H * W;
  const int tiles = 9 * ((C + BC - 1) / BC) * ((F + BF - 1) / BF);
  const dim3 grid((unsigned)tiles, (unsigned)n_chunks);
  const bool vec = C % 4 == 0 && F % 4 == 0 &&
                   (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)g % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)mean % 16 == 0 && (uintptr_t)rstd % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (vec)
    conv3d_wgrad_partial_kernel<T, BC, BF, 4, NA>
        <<<grid, BC * BF / 16, 0, stream>>>(xt, gt, mean, rstd, partial, D, H,
                                           W, C, F, M, rows_per_chunk);
  else
    conv3d_wgrad_partial_kernel<T, BC, BF, 1, NA>
        <<<grid, BC * BF / 16, 0, stream>>>(xt, gt, mean, rstd, partial, D, H,
                                           W, C, F, M, rows_per_chunk);
}

// A 64-wide tile where the channel count is a multiple of 64, else 32 (no
// half-empty tiles at C = 96 or the ragged widths).
template <typename T, int NA>
void launch_wgrad_tiles(const void* x, const void* g, const float* mean,
                        const float* rstd, float* partial, int B, int D, int H,
                        int W, int C, int F, int rows_per_chunk, int n_chunks,
                        cudaStream_t stream) {
  const bool wide_c = C % 64 == 0, wide_f = F % 64 == 0;
  if (wide_c && wide_f)
    launch_wgrad<T, 64, 64, NA>(x, g, mean, rstd, partial, B, D, H, W, C, F,
                                rows_per_chunk, n_chunks, stream);
  else if (wide_c)
    launch_wgrad<T, 64, 32, NA>(x, g, mean, rstd, partial, B, D, H, W, C, F,
                                rows_per_chunk, n_chunks, stream);
  else if (wide_f)
    launch_wgrad<T, 32, 64, NA>(x, g, mean, rstd, partial, B, D, H, W, C, F,
                                rows_per_chunk, n_chunks, stream);
  else
    launch_wgrad<T, 32, 32, NA>(x, g, mean, rstd, partial, B, D, H, W, C, F,
                                rows_per_chunk, n_chunks, stream);
}

// The partial pass with prologue ``na`` (kNoNorm or an act code), then the
// fold.
template <typename T>
int wgrad_passes(int na, const void* x, const void* g, const float* mean,
                 const float* rstd, float* partial, float* dw, int B, int D,
                 int H, int W, int C, int F, int rows_per_chunk, int n_chunks,
                 cudaStream_t st) {
  if (na == kNoNorm)
    launch_wgrad_tiles<T, kNoNorm>(x, g, mean, rstd, partial, B, D, H, W, C,
                                   F, rows_per_chunk, n_chunks, st);
  else if (na == kActNone)
    launch_wgrad_tiles<T, kActNone>(x, g, mean, rstd, partial, B, D, H, W, C,
                                    F, rows_per_chunk, n_chunks, st);
  else if (na == kActRelu)
    launch_wgrad_tiles<T, kActRelu>(x, g, mean, rstd, partial, B, D, H, W, C,
                                    F, rows_per_chunk, n_chunks, st);
  else if (na == kActGelu)
    launch_wgrad_tiles<T, kActGelu>(x, g, mean, rstd, partial, B, D, H, W, C,
                                    F, rows_per_chunk, n_chunks, st);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = 27LL * C * F;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  conv3d_wgrad_fold_kernel<<<(unsigned)blocks, 256, 0, st>>>(partial, dw, n,
                                                            n_chunks);
  return (int)cudaGetLastError();
}

int wgrad_entry(int na, const void* x, const void* g, const void* mean,
                const void* rstd, void* partial, void* dw, int dtype, int B,
                int D, int H, int W, int C, int F, int rows_per_chunk,
                int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  if (dtype == 0)
    return wgrad_passes<float>(na, x, g, m, r, part, out, B, D, H, W, C, F,
                               rows_per_chunk, n_chunks, st);
  if (dtype == 1)
    return wgrad_passes<__nv_bfloat16>(na, x, g, m, r, part, out, B, D, H, W,
                                       C, F, rows_per_chunk, n_chunks, st);
  return (int)cudaErrorInvalidValue;
}

int fwd_entry(int na, const void* x, const void* w, void* y, const void* mean,
              const void* rstd, int dtype, int B, int D, int H, int W, int C,
              int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  bool ok = false;
  if (dtype == 0)
    ok = launch_fwd<float>(na, x, w, y, m, r, B, D, H, W, C, F, st);
  else if (dtype == 1)
    ok = launch_fwd<__nv_bfloat16>(na, x, w, y, m, r, B, D, H, W, C, F, st);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  partial: fp32 scratch of
// n_chunks * 27 * C * F; dw: [3, 3, 3, C, F] fp32.  rows_per_chunk *
// n_chunks must cover B * D * H * W voxels.
extern "C" int conv3d_wgrad(const void* x, const void* g, void* partial,
                            void* dw, int dtype, int B, int D, int H, int W,
                            int C, int F, int rows_per_chunk, int n_chunks,
                            void* stream) {
  return wgrad_entry(kNoNorm, x, g, nullptr, nullptr, partial, dw, dtype, B,
                     D, H, W, C, F, rows_per_chunk, n_chunks, stream);
}

// conv3d_wgrad against act((x - mean) * rstd): mean, rstd fp32 [B, C]; act
// 0 none, 1 relu, 2 gelu.
extern "C" int conv3d_wgrad_na(const void* x, const void* g, const void* mean,
                               const void* rstd, void* partial, void* dw,
                               int dtype, int act, int B, int D, int H, int W,
                               int C, int F, int rows_per_chunk, int n_chunks,
                               void* stream) {
  if (act == kNoNorm) return (int)cudaErrorInvalidValue;
  return wgrad_entry(act, x, g, mean, rstd, partial, dw, dtype, B, D, H, W, C,
                     F, rows_per_chunk, n_chunks, stream);
}

// dtype: 0 float32, 1 bfloat16.  w is packed [3, 3, 3, C, F] in x's dtype.
extern "C" int conv3d_same_fwd(const void* x, const void* w, void* y,
                               int dtype, int B, int D, int H, int W, int C,
                               int F, void* stream) {
  return fwd_entry(kNoNorm, x, w, y, nullptr, nullptr, dtype, B, D, H, W, C,
                   F, stream);
}

// conv3d_same_fwd of act((x - mean) * rstd): mean, rstd fp32 [B, C]; act 0
// none, 1 relu, 2 gelu.
extern "C" int conv3d_same_na_fwd(const void* x, const void* w, void* y,
                                  const void* mean, const void* rstd,
                                  int dtype, int act, int B, int D, int H,
                                  int W, int C, int F, void* stream) {
  if (act == kNoNorm) return (int)cudaErrorInvalidValue;
  return fwd_entry(act, x, w, y, mean, rstd, dtype, B, D, H, W, C, F, stream);
}

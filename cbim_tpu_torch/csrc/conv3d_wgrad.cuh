// The CUDA-core weight gradient of the 3x3x3 convolution (see
// conv3d_wgrad.cu for what it computes, what bounds it and its design),
// templated on the prologue NA: conv3d_wgrad.cu instantiates the plain
// kernel (kNoNorm), conv3d_wgrad_na.cu the three norm-acts, so that the two
// sources compile side by side.

#pragma once

#include "conv3d_common.cuh"
#include "wgrad_fold.cuh"

namespace {

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

// The partial pass with prologue NA (kNoNorm or an act code), then the
// fold.
template <typename T, int NA>
int wgrad_passes(const void* x, const void* g, const float* mean,
                 const float* rstd, float* partial, float* dw, int B, int D,
                 int H, int W, int C, int F, int rows_per_chunk, int n_chunks,
                 cudaStream_t st) {
  launch_wgrad_tiles<T, NA>(x, g, mean, rstd, partial, B, D, H, W, C, F,
                            rows_per_chunk, n_chunks, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_wgrad_fold(partial, dw, 27LL * C * F, n_chunks, st);
}

// dtype: 0 float32, 1 bfloat16.
template <int NA>
int wgrad_entry(const void* x, const void* g, const void* mean,
                const void* rstd, void* partial, void* dw, int dtype, int B,
                int D, int H, int W, int C, int F, int rows_per_chunk,
                int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  if (dtype == 0)
    return wgrad_passes<float, NA>(x, g, m, r, part, out, B, D, H, W, C, F,
                                   rows_per_chunk, n_chunks, st);
  if (dtype == 1)
    return wgrad_passes<__nv_bfloat16, NA>(x, g, m, r, part, out, B, D, H, W,
                                           C, F, rows_per_chunk, n_chunks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

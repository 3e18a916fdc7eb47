// The tensor-core weight gradient of the 3x3x3 conv (its design: the notes
// of conv3d_wgrad_tc.cu), templated on a norm-act of the staged x halo:
// NA = kNoNorm is conv3d_wgrad_tc (conv3d_wgrad_tc.cu), NA = an act code
// the fused preact conv's conv3d_wgrad_na_tc (conv3d_wgrad_na_tc.cu), whose
// x halo becomes act((x - mean) * rstd) in shared memory (na_halo.cuh)
// before it meets g.  g is never transformed.

#pragma once

#include "na_halo.cuh"
#include "wgrad_fold.cuh"

namespace {

constexpr int kWgWarps = 9;  // one per (kd, kh)
constexpr int kWgThreads = kWgWarps * 32;
constexpr int kTile = 32;  // c and f tile
constexpr int kTD = 4, kTH = 8, kTW = 8;  // voxel tile: 256 voxels, K = 256
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHaloRows = kHD * kHH * kHW;
constexpr int kHaloBytes = kHaloRows * kTile * 2;  // 38400
constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;
constexpr int kGBytes = kTD * kTH * kTW * kTile * 2;  // 16384
constexpr int kStage = kHaloSlot + kGBytes;
constexpr int kStages = 3;
constexpr int kSmem = kStages * kStage + 8 * kStages + 1024;
// the norm-act pass over an x halo: passes of 72 rows (a multiple of 8, so
// each thread keeps its physical chunk)
constexpr int kNaRowsPerPass = kWgThreads / 4;
constexpr int kNaPasses = (kHaloRows + kNaRowsPerPass - 1) / kNaRowsPerPass;
constexpr int kKSteps = kTD * kTH * kTW / 16;
static_assert(kNaRowsPerPass % 8 == 0, "pass plan");

// partial[chunk, kd, kh, kw, c, f]; grid.x = (c tile, f tile), grid.y =
// chunk of voxel tiles.  With NA != kNoNorm, while tile s is multiplied from
// one stage, tile s + 1's x halo (landed in the next) is normalised: warps
// 4-7 before their MMAs, the others after them, so the warps a scheduler
// shares (w, w + 4, w + 8) are out of phase; the first tile's before any
// MMA.  (Slices interleaved with the k-steps ran slower on the H100: they
// raise register pressure, and each store orders the next k-step's
// ldmatrix after it.)
template <int NA>
__global__ void __launch_bounds__(kWgThreads, 1)
conv3d_wgrad_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap gmap,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       float* __restrict__ partial, int D, int H, int W,
                       int C, int F, int tiles_d, int tiles_h, int tiles_w,
                       int n_tiles, int tiles_per_chunk) {
  extern __shared__ uint8_t smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned stage0 = (raw + 1023) & ~1023u;
  const unsigned bar0 = stage0 + kStages * kStage;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mat = lane / 8, r8 = lane % 8;
  const int nft = (F + kTile - 1) / kTile;
  const int c0 = blockIdx.x / nft * kTile, f0 = blockIdx.x % nft * kTile;
  const int chunk = blockIdx.y;
  const int t_begin = chunk * tiles_per_chunk;
  const int count = min(n_tiles - t_begin, tiles_per_chunk);
  const int kd = warp / 3, kh = warp % 3;

  // step s's voxel tile: sample b, first voxel (z0, y0, x0)
  auto tile_at = [&](int s, int& b, int& z0, int& y0, int& x0) {
    int t = t_begin + s;
    x0 = t % tiles_w * kTW;
    t /= tiles_w;
    y0 = t % tiles_h * kTH;
    t /= tiles_h;
    z0 = t % tiles_d * kTD;
    b = t / tiles_d;
  };
  auto load_tile = [&](int s) {
    int b, z0, y0, x0;
    tile_at(s, b, z0, y0, x0);
    const int st = s % kStages;
    const unsigned bar = bar0 + 8 * st;
    const unsigned dst = stage0 + st * kStage;
    mbar_expect_tx(bar, kHaloBytes + kGBytes);
    tma_load_5d(dst, &xmap, bar, c0, x0 - 1, y0 - 1, z0 - 1, b);
    tma_load_5d(dst + kHaloSlot, &gmap, bar, f0, x0, y0, z0, b);
  };

  // The norm-act pass of step na_s's x halo: this thread's logical chunk j
  // (channels c0 + 8 j..) of halo rows tid / 4 + 72 q; (nz, ny, nx) the
  // halo's first voxel; nm, nr the statistics of sample nb.
  const int j = tid % 4;
  const bool na_ch = c0 + j * 8 < C;
  int na_s = 0, nb = -1, nz = 0, ny = 0, nx = 0;
  float nm[8], nr[8];
  auto na_begin = [&](int s) {
    int b;
    tile_at(s, b, nz, ny, nx);
    nz -= 1;
    ny -= 1;
    nx -= 1;
    na_s = s;
    if (na_ch && b != nb) {
      na_stats(mean, rstd, (long long)b * C + c0 + j * 8, nm, nr);
      nb = b;
    }
    mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
  };
  auto na_ld = [&](int q) {
    return na_load<kHH, kHW>(stage0 + (na_s % kStages) * kStage,
                             tid / 4 + q * kNaRowsPerPass, kHaloRows, j,
                             na_ch, nz, ny, nx, D, H, W);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages - 1 && s < count; ++s) load_tile(s);
  }
  if constexpr (NA != kNoNorm) {
    na_begin(0);
    for (int q = 0; q < kNaPasses; ++q) na_store<NA>(na_ld(q), nm, nr);
    fence_proxy_async();
    __syncthreads();
  }

  float acc[3][2][4][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[kw][i][jn][q] = 0.f;

  for (int s = 0; s < count; ++s) {
    if (tid == 0) {
      // the slot refilled here was last read in step s - 1, which every
      // thread has left (the barrier at its end); with NA every thread
      // fenced its norm-act writes to it before an earlier barrier
      fence_proxy_async();
      if (s + kStages - 1 < count) load_tile(s + kStages - 1);
    }
    // with NA, tile s landed (and was normalised) in step s - 1
    const bool na_next = NA != kNoNorm && s + 1 < count;
    if constexpr (NA == kNoNorm)
      mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
    else if (na_next)
      na_begin(s + 1);
    const unsigned xs = stage0 + (s % kStages) * kStage;
    const unsigned gs = xs + kHaloSlot;
    // the MMAs of k-step kk (16 voxels of the tile) for this warp's 3 taps
    auto mma_kk = [&](int kk) {
      // B = G (k = voxel, n = f): matrices (k 0-7, n j), (k 8-15, n j),
      // (k 0-7, n j + 1), (k 8-15, n j + 1)
      unsigned bf[4][2];
#pragma unroll
      for (int jn = 0; jn < 4; jn += 2) {
        unsigned q[4];
        ldsm_x4_t(gs + swz64(kk * 16 + (mat & 1) * 8 + r8, jn + (mat >> 1)),
                  q);
        bf[jn][0] = q[0];
        bf[jn][1] = q[1];
        bf[jn + 1][0] = q[2];
        bf[jn + 1][1] = q[3];
      }
      // A = X_t^T (m = c, k = voxel): matrices (m 0-7, k 0-7), (m 8-15,
      // k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15); this lane's storage row
      // is voxel kk * 16 + (mat >> 1) * 8 + r8, shifted by the tap
      const int row = kk * 2 + (mat >> 1);  // (z, y) of the voxel: x = r8
      const int hrow = ((row / kTH + kd) * kHH + row % kTH + kh) * kHW + r8;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned a[4];
          ldsm_x4_t(xs + swz64(hrow + kw, 2 * i + (mat & 1)), a);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            mma_bf16(acc[kw][i][jn], a, bf[jn][0], bf[jn][1]);
        }
      }
    };
    // the next tile's x halo: warps 4-7 normalise their rows before their
    // MMAs, the others after them
    const bool na_first = warp >= 4 && warp < 8;
    if (na_next && na_first)
      for (int q = 0; q < kNaPasses; ++q) na_store<NA>(na_ld(q), nm, nr);
#pragma unroll 4
    for (int kk = 0; kk < kKSteps; ++kk) mma_kk(kk);
    if (na_next && !na_first)
      for (int q = 0; q < kNaPasses; ++q) na_store<NA>(na_ld(q), nm, nr);
    if (na_next) fence_proxy_async();
    __syncthreads();
  }

  // accumulator (row c = l / 4 [+ 8], columns f = 2 (l % 4) + {0, 1})
  const int g = lane / 4, c2 = (lane % 4) * 2;
  float* out = partial + (long long)chunk * 27 * C * F;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const long long tap = (long long)(warp * 3 + kw) * C;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + i * 16 + g + 8 * half;
        if (c >= C) continue;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int f = f0 + jn * 8 + c2;
          if (f < F)
            *reinterpret_cast<float2*>(out + (tap + c) * F + f) = make_float2(
                acc[kw][i][jn][2 * half], acc[kw][i][jn][2 * half + 1]);
        }
      }
  }
}

// The kernel and its fold on ``st``; mean and rstd are read only with NA.
template <int NA>
int launch_wgrad_tc(const void* x, const void* g, const float* mean,
                    const float* rstd, void* partial, void* dw, int B, int D,
                    int H, int W, int C, int F, int tiles_per_chunk,
                    int n_chunks, cudaStream_t st) {
  const int tiles_d = (D + kTD - 1) / kTD, tiles_h = (H + kTH - 1) / kTH,
            tiles_w = (W + kTW - 1) / kTW;
  const long long n_tiles = (long long)B * tiles_d * tiles_h * tiles_w;
  if (C % 8 != 0 || F % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)g % 16 != 0 || n_tiles >= (1LL << 31) ||
      tiles_per_chunk < 1 || n_chunks < 1 ||
      (long long)tiles_per_chunk * n_chunks < n_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  const long long nx[5] = {C, W, H, D, B}, ng[5] = {F, W, H, D, B};
  const unsigned xbox[5] = {kTile, kHW, kHH, kHD, 1};
  const unsigned gbox[5] = {kTile, kTW, kTH, kTD, 1};
  if (!encode_map(&xmap, x, 5, nx, xbox) || !encode_map(&gmap, g, 5, ng, gbox))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv3d_wgrad_tc_kernel<NA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_cf = ((C + kTile - 1) / kTile) * ((F + kTile - 1) / kTile);
  kernel<<<dim3((unsigned)tiles_cf, (unsigned)n_chunks), kWgThreads, kSmem,
           st>>>(xmap, gmap, mean, rstd, static_cast<float*>(partial), D, H,
                 W, C, F, tiles_d, tiles_h, tiles_w, (int)n_tiles,
                 tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_wgrad_fold(static_cast<const float*>(partial),
                           static_cast<float*>(dw), 27LL * C * F, n_chunks,
                           st);
}

}  // namespace

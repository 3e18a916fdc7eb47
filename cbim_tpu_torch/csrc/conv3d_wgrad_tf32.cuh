// The 3xTF32 weight gradient of the 3x3x3 conv (its design: the notes of
// conv3d_wgrad_tf32.cu), templated on a norm-act of the staged x halo:
// NA = kNoNorm is conv3d_wgrad_tf32 (conv3d_wgrad_tf32.cu), NA = an act code
// the fused preact conv's fp32 conv3d_wgrad_na_tf32
// (conv3d_wgrad_na_tf32.cu), whose x halo becomes act((x - mean) * rstd)
// in fp32 in the same pass that splits it into TF32 hi and lo parts, before
// it meets g.  g is never transformed.

#pragma once

#include "conv3d_common.cuh"
#include "mma_common.cuh"
#include "wgrad_fold.cuh"

namespace {

constexpr int kWarps = 9;  // one per (kd, kh)
constexpr int kThreads = kWarps * 32;
constexpr int kCt = 16;  // c tile: one 64-byte row of fp32 channels
constexpr int kFt = 32;  // f tile: two planes of 16 fp32 channels
constexpr int kTD = 4, kTH = 8, kTW = 8;  // voxel tile: 256 voxels
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHaloBytes = kHD * kHH * kHW * kCt * 4;         // 38400
constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;  // 38912
constexpr int kPlaneBytes = kTD * kTH * kTW * 16 * 4;         // 16384
constexpr int kStage = kHaloSlot + 2 * kPlaneBytes;           // 71680
// two stages of TMA boxes (the hi parts split in place) and one buffer of
// the lo parts in the same layout
constexpr int kStages = 2;
constexpr int kSmem = (kStages + 1) * kStage + 8 * kStages + 1024;
static_assert(kTW == 8, "a k step is one row of 8 voxels");

// the 64-byte swizzle of a linear shared-memory address (1024-byte aligned
// buffers): 16-byte chunk bits 4-5 XOR row bits 1-2 (address bits 7-8), as
// swz64
__device__ __forceinline__ unsigned swz(unsigned a) {
  return a ^ ((a >> 3) & 0x30);
}

// partial[chunk, kd, kh, kw, c, f]; grid.x = (c tile, f tile), grid.y =
// chunk of voxel tiles.  With NA != kNoNorm the split of each landed x halo
// first normalises it (rows inside the D x H x W volume, channels below C;
// TMA's zeros elsewhere stay 0): a thread's 16-byte chunks lie on halo
// rows tid / 4 + 72 u, which share one swizzle phase, so each thread
// normalises one logical chunk (4 channels) whose statistics it keeps in
// registers.
template <int NA>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_wgrad_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         float* __restrict__ partial, int D, int H, int W,
                         int C, int F, int tiles_d, int tiles_h, int tiles_w,
                         int n_tiles, int tiles_per_chunk) {
  extern __shared__ uint8_t smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned stage0 = (raw + 1023) & ~1023u;
  const unsigned lo0 = stage0 + kStages * kStage;
  const unsigned bar0 = lo0 + kStage;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int nft = (F + kFt - 1) / kFt;
  const int c0 = blockIdx.x / nft * kCt, f0 = blockIdx.x % nft * kFt;
  // the second g plane, unless it lies wholly past F
  const bool plane1 = f0 + 16 < F;
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
  // ... into stage s % kStages
  auto load_tile = [&](int s) {
    int b, z0, y0, x0;
    tile_at(s, b, z0, y0, x0);
    const int st = s % kStages;
    const unsigned bar = bar0 + 8 * st;
    const unsigned dst = stage0 + st * kStage;
    mbar_expect_tx(bar, kHaloBytes + (plane1 ? 2 : 1) * kPlaneBytes);
    tma_load_5d(dst, &xmap, bar, c0, x0 - 1, y0 - 1, z0 - 1, b);
    tma_load_5d(dst + kHaloSlot, &gmap, bar, f0, x0, y0, z0, b);
    if (plane1)
      tma_load_5d(dst + kHaloSlot + kPlaneBytes, &gmap, bar, f0 + 16, x0,
                  y0, z0, b);
  };

  // this lane's k slots tig and tig + 4: voxels xa and xa + 2 of a row
  const int xa = (tig & 1) + (tig >> 1) * 4;
  // B: g at voxel x of a row and f = gid + 8 j lies in plane j / 2, 16-byte
  // chunk gid / 4 + 2 (j % 2), element gid % 4: its offset for slot h (x =
  // xa + 2 h) and even or odd j (a row of 8 keeps the swizzle phase of x),
  // a plane more for j >= 2
  unsigned gb[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      gb[h][p] = kHaloSlot + swz64(xa + 2 * h, (gid >> 2) + 2 * p) +
                 4 * (gid & 3);
  // the 16-byte chunks a tile's split covers, the halo's, then the planes'
  // (the second as zeros when it lies past F), and those TMA filled
  const int n_split = (kHaloBytes + 2 * kPlaneBytes) / 16;
  const int n_landed = (kHaloBytes + (plane1 ? 2 : 1) * kPlaneBytes) / 16;
  // the norm-act: this thread's logical chunk of a halo row (its physical
  // chunk tid % 4 under the swizzle phase of rows tid / 4 + 72 u), its
  // channels' statistics (of sample nb) and whether they lie below C
  static_assert(kThreads % 32 == 0, "rows tid / 4 + 72 u share a phase");
  const int na_j = (tid & 3) ^ ((tid >> 3) & 3);
  const bool na_ch = c0 + 4 * na_j < C;
  int nb = -1;
  float nm[4], nr[4];

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages && s < count; ++s) load_tile(s);
  }

  // acc: the block's sums (fp32 adds); part: the current z plane's (MMAs)
  float acc[3][4][4], part[3][4][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[kw][jn][q] = 0.f;

  for (int s = 0; s < count; ++s) {
    const unsigned xs = stage0 + (s % kStages) * kStage;
    mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
    // with NA, the tile's halo origin and its sample's statistics
    int hb = 0, hz = 0, hy = 0, hx = 0;
    if constexpr (NA != kNoNorm) {
      tile_at(s, hb, hz, hy, hx);
      hz -= 1;
      hy -= 1;
      hx -= 1;
      if (na_ch && hb != nb) {
        const long long at = (long long)hb * C + c0 + 4 * na_j;
        load_vec<float, 4>(mean + at, nm);
        load_vec<float, 4>(rstd + at, nr);
        nb = hb;
      }
    }
    // the split, once for every warp: hi in place, lo at the same offset
    // of the lo buffer (free: every MMA of step s - 1 is done); with NA the
    // halo's values inside the volume normalised first, in fp32
    for (int i = tid; i < n_split; i += kThreads) {
      const unsigned off =
          i < kHaloBytes / 16 ? i * 16 : kHaloSlot + i * 16 - kHaloBytes;
      unsigned v[4] = {0u, 0u, 0u, 0u}, hi[4], lo[4];
      if (i < n_landed) lds_v4(xs + off, v);
      if constexpr (NA != kNoNorm) {
        const int r = i >> 2;  // halo row (z, y, x) of (kHD, kHH, kHW)
        const int gz = hz + r / (kHH * kHW), gy = hy + r / kHW % kHH,
                  gx = hx + r % kHW;
        if (i < kHaloBytes / 16 && na_ch && (unsigned)gz < (unsigned)D &&
            (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = __float_as_uint(norm_act<float, NA>(
                __uint_as_float(v[q]), nm[q], nr[q]));
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(v[q], hi[q], lo[q]);
      sts_v4(xs + off, hi);
      sts_v4(lo0 + off, lo);
    }
    // the in-place writes before the TMA copy that refills this stage
    fence_proxy_async();
    __syncthreads();
    const unsigned dlo = lo0 - xs;
#pragma unroll 1
    for (int z = 0; z < kTD; ++z) {
      // x halo row of voxel (z, 0, xa) for tap (kd, kh, 0); this lane's
      // channels 2 gid, 2 gid + 1 are bytes 8 gid.. of a 64-byte row
      const unsigned xrow =
          xs + (((z + kd) * kHH + kh) * kHW + xa) * 64 + 8 * gid;
      const unsigned grow = xs + z * kTH * kTW * 64;
      // rows y and y + 4 share their halo rows' swizzle phase (40 rows
      // apart), so each pair of k steps swizzles 5 row addresses
#pragma unroll
      for (int y0 = 0; y0 < kTH / 2; ++y0) {
        unsigned xr[5];
#pragma unroll
        for (int r = 0; r < 5; ++r) xr[r] = swz(xrow + (y0 * kHW + r) * 64);
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const int y = y0 + 4 * h4;
          // B = G (k = voxel, n = f): b0 at slot tig, b1 at slot tig + 4,
          // of n8 tile j (f = gid + 8 j), hi and lo for the 3 taps, each
          // loaded into its fragment register
          unsigned bh[4][2], bl[4][2];
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned at = grow + gb[h][jn & 1] + y * kTW * 64 +
                                  (jn >> 1) * kPlaneBytes;
              bh[jn][h] = lds_u32(at);
              bl[jn][h] = lds_u32(at + dlo);
            }
          // A = X_t^T (m = c, k = voxel): a0 (m gid, slot tig) = channel
          // 2 gid, a1 (m gid + 8) = 2 gid + 1 of halo row xa + kw; a2, a3
          // the same of row xa + kw + 2 (slot tig + 4)
          unsigned ah[3][4], al[3][4];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const unsigned r0 = xr[kw] + h4 * 40 * 64;
            const unsigned r2 = xr[kw + 2] + h4 * 40 * 64;
            lds_v2(r0, ah[kw]);
            lds_v2(r2, ah[kw] + 2);
            lds_v2(r0 + dlo, al[kw]);
            lds_v2(r2 + dlo, al[kw] + 2);
          }
          // the small products first, then the large one, each over the 12
          // (tap, n8 tile) sums before the next; the plane's first MMAs
          // start ``part`` from zeros
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
              if (y == 0)
                mma_tf32<true>(part[kw][jn], al[kw], bh[jn][0], bh[jn][1]);
              else
                mma_tf32(part[kw][jn], al[kw], bh[jn][0], bh[jn][1]);
            }
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
              mma_tf32(part[kw][jn], ah[kw], bl[jn][0], bl[jn][1]);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
              mma_tf32(part[kw][jn], ah[kw], bh[jn][0], bh[jn][1]);
        }
      }
      // the plane's sums into the block's, in fp32
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[kw][jn][q] += part[kw][jn][q];
    }
    // every MMA of step s is done: its stage and the lo buffer are free
    __syncthreads();
    if (tid == 0 && s + kStages < count) load_tile(s + kStages);
  }

  // accumulator q of tile j: row gid (c = 2 gid; q 0-1) or gid + 8 (c =
  // 2 gid + 1; q 2-3), columns 2 tig + {0, 1} (f = 8 j + 2 tig + {0, 1})
  float* out = partial + (long long)chunk * 27 * C * F;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const long long tap = (long long)(warp * 3 + kw) * C;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + 2 * gid + half;
      if (c >= C) continue;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int f = f0 + 8 * jn + 2 * tig;
        if (f < F)
          *reinterpret_cast<float2*>(out + (tap + c) * F + f) = make_float2(
              acc[kw][jn][2 * half], acc[kw][jn][2 * half + 1]);
      }
    }
  }
}

// The kernel and its fold on ``st``; mean and rstd are read only with NA.
// Needs C % 8 == 0, F % 8 == 0 and 16-byte aligned x, g and partial (and,
// with NA, mean and rstd).
template <int NA>
int launch_wgrad_tf32(const void* x, const void* g, const float* mean,
                      const float* rstd, void* partial, void* dw, int B,
                      int D, int H, int W, int C, int F, int tiles_per_chunk,
                      int n_chunks, cudaStream_t st) {
  const int tiles_d = (D + kTD - 1) / kTD, tiles_h = (H + kTH - 1) / kTH,
            tiles_w = (W + kTW - 1) / kTW;
  const long long n_tiles = (long long)B * tiles_d * tiles_h * tiles_w;
  if (C % 8 != 0 || F % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)g % 16 != 0 || (uintptr_t)partial % 16 != 0 ||
      (NA != kNoNorm &&
       ((uintptr_t)mean % 16 != 0 || (uintptr_t)rstd % 16 != 0)) ||
      n_tiles >= (1LL << 31) || tiles_per_chunk < 1 || n_chunks < 1 ||
      n_chunks > 65535 || (long long)tiles_per_chunk * n_chunks < n_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  const long long nx[5] = {C, W, H, D, B}, ng[5] = {F, W, H, D, B};
  const unsigned xbox[5] = {kCt, kHW, kHH, kHD, 1};
  const unsigned gbox[5] = {16, kTW, kTH, kTD, 1};
  if (!encode_map(&xmap, x, 5, nx, xbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !encode_map(&gmap, g, 5, ng, gbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv3d_wgrad_tf32_kernel<NA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_cf = ((C + kCt - 1) / kCt) * ((F + kFt - 1) / kFt);
  kernel<<<dim3((unsigned)tiles_cf, (unsigned)n_chunks), kThreads, kSmem,
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

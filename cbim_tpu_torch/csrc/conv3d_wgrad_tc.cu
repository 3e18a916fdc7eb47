// Weight gradient of the stride-1, zero-pad-1, 3x3x3 convolution on
// Hopper's bf16 tensor cores (sm_90a): conv3d_wgrad_tc.  The forward and
// dgrad are conv3d_tc.cu; the CUDA-core weight gradient (fp32, widths that
// are not multiples of 8, the norm-act prologue) stays in conv3d_wgrad.cu.
//
// Replaces conv3d_wgrad of cbim_tpu/ops/pallas/conv3d.py in bf16:
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
// zeros outside the volume; bf16 x and g, fp32 sums, dW [3, 3, 3, C, F]
// fp32.  The TPU kernel's tap packing (_build_g9, K = 3C, N = 9F) is not
// carried over.
//
// What bounds it on the H100: operations, as the forward (2 * 27 * C * F
// FLOPs per voxel, 0.70 ms at (2, 128^3, 96 -> 32) at 989 TFLOP/s), with K
// = every voxel (4.2 M) reduced into a small output (27 * C * F values).
//
// What the design does about it: per tap a GEMM dW_t (M = c, N = f) =
// X_t^T G over K = voxels, on mma.sync.m16n8k16 (bf16 in, fp32 sums).
// - A block owns one (32-channel c tile, 32-channel f tile) of dW for all
//   27 taps and walks a chunk of (4, 8, 8) voxel tiles.  So each x halo and
//   each g tile is staged once for all 27 taps (conv3d_wgrad.cu stages them
//   once per (kd, kh): 9 times).
// - Staging: for each voxel tile, two 5D TMA boxes, the x halo (6 x 10 x 10
//   voxels, zero fill = the SAME padding and the ragged edge) and the g tile
//   (4 x 8 x 8), 64-byte swizzled rows, in a ring of 3 stages on mbarriers;
//   one thread starts the copies.
// - Operands: A = X_t^T by ldmatrix.trans from the shifted halo rows (a
//   tap's shift is an address), B = G by ldmatrix.trans.
// - 9 warps, warp (kd, kh) owns the 3 kw taps x 32 x 32 accumulators (96
//   fp32 registers a thread); the 3 taps share each B fragment.
// - Split-K over chunks of voxel tiles: each block writes fp32 partials and
//   a second kernel folds the chunks in a fixed order.  No atomics, so
//   results repeat bit for bit.
// Needs C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "mma_common.cuh"
#include "wgrad_fold.cuh"

namespace {

constexpr int kWgWarps = 9;  // one per (kd, kh)
constexpr int kWgThreads = kWgWarps * 32;
constexpr int kTile = 32;  // c and f tile
constexpr int kTD = 4, kTH = 8, kTW = 8;  // voxel tile: 256 voxels, K = 256
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHaloBytes = kHD * kHH * kHW * kTile * 2;  // 38400
constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;
constexpr int kGBytes = kTD * kTH * kTW * kTile * 2;  // 16384
constexpr int kStage = kHaloSlot + kGBytes;
constexpr int kStages = 3;
constexpr int kSmem = kStages * kStage + 8 * kStages + 1024;

// partial[chunk, kd, kh, kw, c, f]; grid.x = (c tile, f tile), grid.y =
// chunk of voxel tiles.
__global__ void __launch_bounds__(kWgThreads, 1)
conv3d_wgrad_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap gmap,
                       float* __restrict__ partial, int C, int F, int tiles_d,
                       int tiles_h, int tiles_w, int n_tiles,
                       int tiles_per_chunk) {
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

  auto load_tile = [&](int s) {
    int t = t_begin + s;
    const int tx = t % tiles_w;
    t /= tiles_w;
    const int ty = t % tiles_h;
    t /= tiles_h;
    const int tz = t % tiles_d;
    const int b = t / tiles_d;
    const int st = s % kStages;
    const unsigned bar = bar0 + 8 * st;
    const unsigned dst = stage0 + st * kStage;
    mbar_expect_tx(bar, kHaloBytes + kGBytes);
    tma_load_5d(dst, &xmap, bar, c0, tx * kTW - 1, ty * kTH - 1, tz * kTD - 1,
                b);
    tma_load_5d(dst + kHaloSlot, &gmap, bar, f0, tx * kTW, ty * kTH,
                tz * kTD, b);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages - 1 && s < count; ++s) load_tile(s);
  }

  float acc[3][2][4][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[kw][i][j][q] = 0.f;

  for (int s = 0; s < count; ++s) {
    if (tid == 0) {
      // the slot refilled here was last read in step s - 1, which every
      // thread has left (the barrier at its end)
      fence_proxy_async();
      if (s + kStages - 1 < count) load_tile(s + kStages - 1);
    }
    mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
    const unsigned xs = stage0 + (s % kStages) * kStage;
    const unsigned gs = xs + kHaloSlot;
#pragma unroll 4
    for (int kk = 0; kk < kTD * kTH * kTW / 16; ++kk) {
      // B = G (k = voxel, n = f): matrices (k 0-7, n j), (k 8-15, n j),
      // (k 0-7, n j + 1), (k 8-15, n j + 1)
      unsigned bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        unsigned q[4];
        ldsm_x4_t(gs + swz64(kk * 16 + (mat & 1) * 8 + r8, j + (mat >> 1)), q);
        bf[j][0] = q[0];
        bf[j][1] = q[1];
        bf[j + 1][0] = q[2];
        bf[j + 1][1] = q[3];
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
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[kw][i][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
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
        for (int j = 0; j < 4; ++j) {
          const int f = f0 + j * 8 + c2;
          if (f < F)
            *reinterpret_cast<float2*>(out + (tap + c) * F + f) = make_float2(
                acc[kw][i][j][2 * half], acc[kw][i][j][2 * half + 1]);
        }
      }
  }
}

}  // namespace

// x [B, D, H, W, C] and g [B, D, H, W, F] bf16; partial fp32 scratch of
// n_chunks * 27 * C * F; dw [3, 3, 3, C, F] fp32.  The voxel tiles are (4,
// 8, 8) boxes, ceil(D / 4) * ceil(H / 8) * ceil(W / 8) a sample, in
// (b, d, h, w) order; tiles_per_chunk * n_chunks must cover them.  Needs
// C % 8 == 0, F % 8 == 0 and 16-byte aligned x and g.
extern "C" int conv3d_wgrad_tc(const void* x, const void* g, void* partial,
                               void* dw, int B, int D, int H, int W, int C,
                               int F, int tiles_per_chunk, int n_chunks,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_cf = ((C + kTile - 1) / kTile) * ((F + kTile - 1) / kTile);
  conv3d_wgrad_tc_kernel<<<dim3((unsigned)tiles_cf, (unsigned)n_chunks),
                           kWgThreads, kSmem, st>>>(
      xmap, gmap, static_cast<float*>(partial), C, F, tiles_d, tiles_h,
      tiles_w, (int)n_tiles, tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_wgrad_fold(static_cast<const float*>(partial),
                           static_cast<float*>(dw), 27LL * C * F, n_chunks,
                           st);
}

// Weight gradient of the stride-1, zero-pad-1, 3x3x3 convolution in fp32 on
// Hopper's TF32 tensor cores (sm_90a), error-compensated to fp32 accuracy
// (3xTF32): conv3d_wgrad_tf32.  The forward and dgrad are conv3d_tf32.cu,
// the bf16 weight gradient conv3d_wgrad_tc.cu; the fused preact conv's fp32
// weight gradient and widths that are not multiples of 8 stay on the
// CUDA-core kernels of conv3d_wgrad.cu.
//
// Replaces, in fp32, conv3d_wgrad of cbim_tpu/ops/pallas/conv3d.py (:582;
// twins _cw :914 and _cw2 :1232):
//   dW[kd, kh, kw, c, f] = sum_{b, d, h, w} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                          * g[b, d, h, w, f],
// zeros outside the volume; fp32 x, g, sums and dW [3, 3, 3, C, F].  The
// TPU kernel's tap packing (_build_g9, K = 3C, N = 9F) is not carried over.
//
// What bounds it on the H100: operations.  2 * 27 * C * F FLOPs per voxel,
// 0.70 TFLOP at (2, 128^3, 96 -> 32), three times over on the TF32 tensor
// cores: 4.2 ms at 495 TFLOP/s, against 10.4 ms at the 67 TFLOP/s fp32 FMA
// rate of the CUDA cores and 0.6 ms for the bytes (x and g at 3.35 TB/s).
// K is every voxel (4.2 M there), reduced into 27 * C * F values.  Beside
// the MMAs, the split (below) runs on the CUDA cores and competes with
// mma.sync for the warp schedulers.
//
// What the design does about it:
// - conv3d_wgrad_tc.cuh's structure: per tap a GEMM dW_t (M = c, N = f) =
//   X_t^T G over K = voxels.  A block owns one (16-channel c tile,
//   32-channel f tile) of dW for all 27 taps and walks a chunk of (4, 8, 8)
//   voxel tiles.  For each tile, 5D TMA boxes bring the x halo (6 x 10 x
//   10 voxels x 16 channels, 38.4 KB; zero fill = the SAME padding and the
//   ragged edge) and the g tile (two 16-channel planes, 32 KB), 64-byte
//   swizzled rows, into a ring of 2 stages on mbarriers; one thread starts
//   the copies.  A 32-channel fp32 halo would take 76.8 KB a stage.  9
//   warps: warp (kd, kh) owns the 3 kw taps, which share each B fragment.
//   Split-K over chunks of voxel tiles: each block writes fp32 partials and
//   wgrad_fold.cuh adds them in a fixed order.  No atomics, so results
//   repeat bit for bit.
// - conv3d_tf32.cu's arithmetic: each operand split into hi = tf32(v) and
//   lo = tf32(v - hi) (round to nearest, ties away from zero, a NaN kept
//   in hi: split_tf32),
//   dW_t = x_lo g_hi + x_hi g_lo + x_hi g_hi, three mma.sync.m16n8k8 TF32
//   products (the dropped x_lo g_lo is 2^-22 of x g).
// - The split runs once per landed tile, by all threads, before its MMAs:
//   hi in place, lo into one buffer of the stage's layout (3 x 70 KB of
//   shared memory in all).  Split in registers instead, each of the 9 warps
//   would split every g value and each warp every x value of its taps'
//   rows; on the H100 that ran slower, and so did reading the split values
//   back with vector loads (the fragments then take register moves).
// - Accumulation.  The tensor cores add into their fp32 accumulators by
//   truncation, which over a whole forward tile erred by more than twice
//   cuDNN fp32.  So each z plane of a voxel tile (64 voxels, three passes:
//   192 products) is summed in fresh accumulators, its first MMA taking
//   zeros for C, and folded into the block's sums with fp32 adds (round to
//   nearest).  3 taps x 16 x 32 sums, twice: 96 registers a thread.
// - Fragments.  Both operands have the voxel as K, which is the outer,
//   strided dimension in shared memory, and ldmatrix.trans transposes
//   16-bit elements only.  The mma sums over k, so any map of voxels onto
//   the 8 k slots works when A and B share it, and so does any map of c
//   onto M.  A k step is one row of 8 voxels (x = 0..7 of one (z, y)).
//   Lane (gid = l / 4, tig = l % 4) takes voxels x = (tig & 1) + 4 (tig >>
//   1) and x + 2 as its k slots tig and tig + 4, and channels c = 2 gid and
//   2 gid + 1 as its rows gid and gid + 8: its A values of a tap are two
//   8-byte loads a part, and rows {r, r + 1, r + 4, r + 5} under the
//   64-byte swizzle put a half warp's loads on distinct banks whatever the
//   tap's shift.  B takes f = gid + 8 j as column gid of n8 tile j: 4-byte
//   loads, on distinct banks for the same reason.  Rows y and y + 4 of a
//   z plane are 40 halo rows apart and share their swizzle, so their k
//   steps run as a pair.  (ldmatrix.trans of the 16-bit halves, put back
//   together by byte permutes, was not built.)
// - wgmma is not the next step without a transpose in shared memory: it
//   takes TF32 operands only K-major, and both operands here are K-outer.
// Needs C % 8 == 0 and F % 8 == 0 (the route's width rule; TMA needs
// 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

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
// chunk of voxel tiles
__global__ void __launch_bounds__(kThreads, 1)
conv3d_wgrad_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap,
                         float* __restrict__ partial, int C, int F,
                         int tiles_d, int tiles_h, int tiles_w, int n_tiles,
                         int tiles_per_chunk) {
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

  // step s's voxel tile (sample b, first voxel (z0, y0, x0)) into stage
  // s % kStages
  auto load_tile = [&](int s) {
    int t = t_begin + s;
    const int x0 = t % tiles_w * kTW;
    t /= tiles_w;
    const int y0 = t % tiles_h * kTH;
    t /= tiles_h;
    const int z0 = t % tiles_d * kTD;
    const int b = t / tiles_d;
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
    // the split, once for every warp: hi in place, lo at the same offset
    // of the lo buffer (free: every MMA of step s - 1 is done)
    for (int i = tid; i < n_split; i += kThreads) {
      const unsigned off =
          i < kHaloBytes / 16 ? i * 16 : kHaloSlot + i * 16 - kHaloBytes;
      unsigned v[4] = {0u, 0u, 0u, 0u}, hi[4], lo[4];
      if (i < n_landed) lds_v4(xs + off, v);
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

}  // namespace

// x [B, D, H, W, C] and g [B, D, H, W, F] fp32; partial fp32 scratch of
// n_chunks * 27 * C * F; dw [3, 3, 3, C, F] fp32.  The voxel tiles are (4,
// 8, 8) boxes, ceil(D / 4) * ceil(H / 8) * ceil(W / 8) a sample, in
// (b, d, h, w) order; tiles_per_chunk * n_chunks must cover them.  Needs
// C % 8 == 0, F % 8 == 0 and 16-byte aligned x, g and partial.
extern "C" int conv3d_wgrad_tf32(const void* x, const void* g, void* partial,
                                 void* dw, int B, int D, int H, int W, int C,
                                 int F, int tiles_per_chunk, int n_chunks,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_d = (D + kTD - 1) / kTD, tiles_h = (H + kTH - 1) / kTH,
            tiles_w = (W + kTW - 1) / kTW;
  const long long n_tiles = (long long)B * tiles_d * tiles_h * tiles_w;
  if (C % 8 != 0 || F % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)g % 16 != 0 || (uintptr_t)partial % 16 != 0 ||
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
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_cf = ((C + kCt - 1) / kCt) * ((F + kFt - 1) / kFt);
  conv3d_wgrad_tf32_kernel<<<dim3((unsigned)tiles_cf, (unsigned)n_chunks),
                             kThreads, kSmem, st>>>(
      xmap, gmap, static_cast<float*>(partial), C, F, tiles_d, tiles_h,
      tiles_w, (int)n_tiles, tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_wgrad_fold(static_cast<const float*>(partial),
                           static_cast<float*>(dw), 27LL * C * F, n_chunks,
                           st);
}

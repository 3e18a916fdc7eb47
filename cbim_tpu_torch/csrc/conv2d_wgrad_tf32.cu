// Weight gradient of the stride-1, zero-pad-1, 3x3 convolution in fp32 on
// Hopper's TF32 tensor cores (sm_90a), error-compensated to fp32 accuracy
// (3xTF32): conv2d_wgrad_tf32.  The forward and dgrad are conv2d_tf32.cu,
// the bf16 weight gradient conv2d_wgrad_tc.cu; widths that are not
// multiples of 8 stay on the CUDA-core kernel of conv2d.cu.
//
// Replaces, in fp32, _wgrad_kernel2 / conv2d_wgrad of
// cbim_tpu/ops/pallas/conv2d.py (:238):
//   dW[kh, kw, c, f] = sum_{b, h, w} x[b, h+kh-1, w+kw-1, c] * g[b, h, w, f],
// zeros outside the image; fp32 x, g, sums and dW [3, 3, C, F].  The TPU
// kernel's packing (K = 3C, 128-lane kw groups of g) is not carried over.
//
// What bounds it on the H100: operations.  2 * 9 * C * F FLOPs per pixel,
// 38.7 GFLOP at (32, 256^2, 32 -> 32) and at (32, 128^2, 64 -> 64), three
// times over on the TF32 tensor cores: 0.234 ms at 495 TFLOP/s, against
// 0.577 ms at the 67 TFLOP/s fp32 FMA rate and 0.160 / 0.080 ms for the
// bytes (x and g at 3.35 TB/s).  K is every pixel (2.1 M or 0.5 M), reduced
// into 9 * C * F values.
//
// What the design does about it: conv2d_wgrad_tc.cu's structure with
// conv3d_wgrad_tf32.cu's arithmetic and fragments.
// - Per tap a GEMM dW_t (M = c, N = f) = X_t^T G over K = pixels.  A block
//   owns one (16-channel c tile, 32-channel f tile) of dW for all 9 taps
//   and walks a chunk of (6, 32)-pixel tiles.  For each tile, 4D TMA boxes
//   bring the x halo (8 x 34 pixels x 16 channels, 17 KB; zero fill = the
//   SAME padding and the ragged edge) and the g tile (two 16-channel
//   planes, 24 KB), 64-byte swizzled rows, into a ring of 3 stages on
//   mbarriers; one thread starts the copies.
// - 9 warps: warp (kh, p) owns the 3 kw taps of row kh, which share each B
//   fragment, over rows p and p + 3 of each tile.  The three row parts of
//   a tap are added in shared memory at the end, in a fixed order.
//   Split-K over chunks of pixel tiles: each block writes fp32 partials and
//   wgrad_fold.cuh adds them in a fixed order.  No atomics, so results
//   repeat bit for bit.
// - 3xTF32: each operand split into hi = tf32(v) and lo = tf32(v - hi)
//   (round to nearest, ties away from zero, a NaN kept in hi: split_tf32),
//   dW_t = x_lo g_hi + x_hi g_lo + x_hi g_hi, three mma.sync.m16n8k8 TF32
//   products (the dropped x_lo g_lo is 2^-22 of x g).  The split runs once
//   per landed tile, by all threads, before its MMAs: hi in place, lo into
//   one buffer of the stage's layout (split in registers, each warp would
//   split every g value 3 times and each x value of its rows).
// - Accumulation.  The tensor cores add into their fp32 accumulators by
//   truncation, so each row of 32 pixels of a tile (three passes: 96
//   products) is summed in fresh accumulators, its first MMA taking zeros
//   for C, and folded into the block's sums with fp32 adds (round to
//   nearest).  3 taps x 16 x 32 sums, twice: 96 registers a thread.
// - Fragments.  Both operands have the pixel as K, the outer, strided
//   dimension in shared memory, and ldmatrix.trans transposes 16-bit
//   elements only.  The mma sums over k, so any map of pixels onto the 8 k
//   slots works when A and B share it, and so does any map of c onto M.  A
//   k step is 8 consecutive pixels of a row.  Lane (gid = l / 4, tig =
//   l % 4) takes pixels x = (tig & 1) + 4 (tig >> 1) and x + 2 as its k
//   slots tig and tig + 4, and channels c = 2 gid and 2 gid + 1 as its rows
//   gid and gid + 8: its A values of a tap are two 8-byte loads a part, and
//   rows {r, r + 1, r + 4, r + 5} under the 64-byte swizzle put a half
//   warp's loads on distinct banks whatever the tap's shift.  B takes f =
//   gid + 8 j as column gid of n8 tile j: 4-byte loads, on distinct banks
//   for the same reason.  The 4 k steps of a row lie 8 rows apart and share
//   their swizzle, so the row's 5 swizzled x addresses serve all of them.
// Needs C % 8 == 0 and F % 8 == 0 (the route's width rule; TMA needs
// 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "mma_common.cuh"
#include "wgrad_fold.cuh"

namespace {

constexpr int kWarps = 9;  // one per (kh, row part)
constexpr int kThreads = kWarps * 32;
constexpr int kCt = 16;  // c tile: one 64-byte row of fp32 channels
constexpr int kFt = 32;  // f tile: two planes of 16 fp32 channels
constexpr int kTH = 6, kTW = 32;  // pixel tile: 192 pixels
constexpr int kParts = 3;         // row parts: rows p, p + 3
constexpr int kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHaloBytes = kHH * kHW * kCt * 4;               // 17408
constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;  // 17408
constexpr int kPlaneBytes = kTH * kTW * 16 * 4;               // 12288
constexpr int kStage = kHaloSlot + 2 * kPlaneBytes;           // 41984
// three stages of TMA boxes (the hi parts split in place) and one buffer of
// the lo parts in the same layout
constexpr int kStages = 3;
constexpr int kSmem = (kStages + 1) * kStage + 8 * kStages + 1024;
static_assert(kTW % 8 == 0 && kTH % kParts == 0, "k steps of 8 pixels");
static_assert(kStage % 1024 == 0 && kPlaneBytes % 1024 == 0,
              "swizzled buffers start 1024-byte aligned");
// the row parts' sums, added at the end in the first stage
static_assert(3 * (kParts - 1) * 48 * 32 * 4 <= kStage, "fold buffer");

// the 64-byte swizzle of a linear shared-memory address (1024-byte aligned
// buffers): 16-byte chunk bits 4-5 XOR row bits 1-2 (address bits 7-8), as
// swz64
__device__ __forceinline__ unsigned swz(unsigned a) {
  return a ^ ((a >> 3) & 0x30);
}

// partial[chunk, kh, kw, c, f]; grid.x = (c tile, f tile), grid.y = chunk
// of pixel tiles
__global__ void __launch_bounds__(kThreads, 1)
conv2d_wgrad_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap,
                         float* __restrict__ partial, int C, int F,
                         int tiles_h, int tiles_w, int n_tiles,
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
  const int kh = warp / kParts, rp = warp % kParts;

  // step s's pixel tile (sample b, first pixel (y0, x0)) into stage
  // s % kStages
  auto load_tile = [&](int s) {
    int t = t_begin + s;
    const int x0 = t % tiles_w * kTW;
    t /= tiles_w;
    const int y0 = t % tiles_h * kTH;
    const int b = t / tiles_h;
    const int st = s % kStages;
    const unsigned bar = bar0 + 8 * st;
    const unsigned dst = stage0 + st * kStage;
    mbar_expect_tx(bar, kHaloBytes + (plane1 ? 2 : 1) * kPlaneBytes);
    tma_load_4d(dst, &xmap, bar, c0, x0 - 1, y0 - 1, b);
    tma_load_4d(dst + kHaloSlot, &gmap, bar, f0, x0, y0, b);
    if (plane1)
      tma_load_4d(dst + kHaloSlot + kPlaneBytes, &gmap, bar, f0 + 16, x0, y0,
                  b);
  };

  // this lane's k slots tig and tig + 4: pixels xa and xa + 2 of a k step
  const int xa = (tig & 1) + (tig >> 1) * 4;
  // B: g at pixel x of a k step and f = gid + 8 j lies in plane j / 2,
  // 16-byte chunk gid / 4 + 2 (j % 2), element gid % 4: its offset for slot
  // h (x = xa + 2 h) and even or odd j (a k step of 8 keeps the swizzle
  // phase of x), a plane more for j >= 2
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

  // acc: the block's sums (fp32 adds); part: the current row's (MMAs)
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
    for (int y = rp; y < kTH; y += kParts) {
      // x halo rows of pixel (y, xa) for taps (kh, 0..2) and of xa + 2;
      // this lane's channels 2 gid, 2 gid + 1 are bytes 8 gid.. of a
      // 64-byte row.  The k steps lie 8 rows (512 bytes) apart: the same
      // swizzle
      const unsigned xrow = xs + ((y + kh) * kHW + xa) * 64 + 8 * gid;
      unsigned xr[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) xr[r] = swz(xrow + r * 64);
      const unsigned grow = xs + y * kTW * 64;
#pragma unroll
      for (int k8 = 0; k8 < kTW / 8; ++k8) {
        // B = G (k = pixel, n = f): b0 at slot tig, b1 at slot tig + 4,
        // of n8 tile j (f = gid + 8 j), hi and lo for the 3 taps, each
        // loaded into its fragment register
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned at = grow + gb[h][jn & 1] + k8 * 8 * 64 +
                                (jn >> 1) * kPlaneBytes;
            bh[jn][h] = lds_u32(at);
            bl[jn][h] = lds_u32(at + dlo);
          }
        // A = X_t^T (m = c, k = pixel): a0 (m gid, slot tig) = channel
        // 2 gid, a1 (m gid + 8) = 2 gid + 1 of halo row xa + kw; a2, a3
        // the same of row xa + kw + 2 (slot tig + 4)
        unsigned ah[3][4], al[3][4];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const unsigned r0 = xr[kw] + k8 * 8 * 64;
          const unsigned r2 = xr[kw + 2] + k8 * 8 * 64;
          lds_v2(r0, ah[kw]);
          lds_v2(r2, ah[kw] + 2);
          lds_v2(r0 + dlo, al[kw]);
          lds_v2(r2 + dlo, al[kw] + 2);
        }
        // the small products first, then the large one, each over the 12
        // (tap, n8 tile) sums before the next; the row's first MMAs start
        // ``part`` from zeros
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            if (k8 == 0)
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
      // the row's sums into the block's, in fp32
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

  // the row parts of each tap: parts 1 and 2 into the first stage (free:
  // every copy has landed and every MMA is done), lane-minor, then part 0
  // adds them in order
  const unsigned fold = stage0 + (kh * (kParts - 1)) * 48 * 32 * 4;
  if (rp > 0) {
#pragma unroll
    for (int q = 0; q < 48; ++q)
      st_shared_u32(fold + ((rp - 1) * 48 + q) * 128 + lane * 4,
                    __float_as_uint(acc[q / 16][q / 4 % 4][q % 4]));
  }
  __syncthreads();
  if (rp > 0) return;
#pragma unroll
  for (int p = 0; p < kParts - 1; ++p)
#pragma unroll
    for (int q = 0; q < 48; ++q)
      acc[q / 16][q / 4 % 4][q % 4] +=
          __uint_as_float(lds_u32(fold + (p * 48 + q) * 128 + lane * 4));

  // accumulator q of tile j: row gid (c = 2 gid; q 0-1) or gid + 8 (c =
  // 2 gid + 1; q 2-3), columns 2 tig + {0, 1} (f = 8 j + 2 tig + {0, 1})
  float* out = partial + (long long)chunk * 9 * C * F;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const long long tap = (long long)(kh * 3 + kw) * C;
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

// x [B, H, W, C] and g [B, H, W, F] fp32; partial fp32 scratch of
// n_chunks * 9 * C * F; dw [3, 3, C, F] fp32.  The pixel tiles are (6, 32)
// boxes, B * ceil(H / 6) * ceil(W / 32) of them in (b, h, w) order;
// tiles_per_chunk * n_chunks must cover them.  Needs C % 8 == 0,
// F % 8 == 0, fewer than 2^31 pixel tiles and 16-byte aligned x, g and
// partial.
extern "C" int conv2d_wgrad_tf32(const void* x, const void* g, void* partial,
                                 void* dw, int B, int H, int W, int C, int F,
                                 int tiles_per_chunk, int n_chunks,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  const long long n_tiles = (long long)B * tiles_h * tiles_w;
  if (C % 8 != 0 || F % 8 != 0 || C < 8 || F < 8 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)g % 16 != 0 || (uintptr_t)partial % 16 != 0 ||
      n_tiles >= (1LL << 31) || tiles_per_chunk < 1 || n_chunks < 1 ||
      n_chunks > 65535 || (long long)tiles_per_chunk * n_chunks < n_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  const long long nx[4] = {C, W, H, B}, ng[4] = {F, W, H, B};
  const unsigned xbox[4] = {kCt, kHW, kHH, 1};
  const unsigned gbox[4] = {16, kTW, kTH, 1};
  if (!encode_map(&xmap, x, 4, nx, xbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !encode_map(&gmap, g, 4, ng, gbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_cf = ((C + kCt - 1) / kCt) * ((F + kFt - 1) / kFt);
  conv2d_wgrad_tf32_kernel<<<dim3((unsigned)tiles_cf, (unsigned)n_chunks),
                             kThreads, kSmem, st>>>(
      xmap, gmap, static_cast<float*>(partial), C, F, tiles_h, tiles_w,
      (int)n_tiles, tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_wgrad_fold(static_cast<const float*>(partial),
                           static_cast<float*>(dw), 9LL * C * F, n_chunks,
                           st);
}

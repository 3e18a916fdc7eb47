// Stride-1, zero-pad-1, 3x3 convolution in fp32 on Hopper's TF32 tensor
// cores (sm_90a), error-compensated to fp32 accuracy (3xTF32):
// conv2d_same_fwd_tf32, the forward and, on flip-swapped weights, the input
// gradient.  The weight gradient is conv2d_wgrad_tf32.cu; the bf16 kernels
// are conv2d_tc.cu and conv2d_wgrad_tc.cu, and widths that are not
// multiples of 8 take the CUDA-core kernels of conv2d.cu.
//
// Replaces, in fp32, the Pallas TPU kernel of cbim_tpu/ops/pallas/conv2d.py
// _conv_kernel2 / conv2d_same (:115) and the dgrad of its VJP conv2d_same_t
// (the same kernel on _flip_swap2 weights):
//   y[b, h, w, f] = sum_{kh, kw, c} x[b, h+kh-1, w+kw-1, c] * w[kh, kw, c, f],
// zeros outside the image, fp32 x, w, y.  The TPU kernel's tap packing
// (K = 3C, 128-lane kw groups) is not carried over.
//
// What bounds it on the H100: operations.  2 * 9 * C * F FLOPs per pixel,
// 38.7 GFLOP at (32, 256^2, 32 -> 32) and at (32, 128^2, 64 -> 64), three
// times over on the TF32 tensor cores: 0.234 ms at 495 TFLOP/s, against
// 0.577 ms at the 67 TFLOP/s fp32 FMA rate of the CUDA cores and 0.160 /
// 0.080 ms for the bytes (x and y at 3.35 TB/s).  Beside the MMAs the split
// (below) runs on the CUDA cores and competes with mma.sync for issue slots.
//
// What the design does about it: conv3d_tf32.cu's arithmetic on
// conv2d_tc.cu's 2D tiles.
// - 3xTF32.  Each operand is split into hi = tf32(v) and lo = tf32(v - hi)
//   (split_tf32: round to nearest, ties away from zero; a NaN stays in hi)
//   and y = x_lo w_hi + x_hi w_lo + x_hi w_hi, three mma.sync.m16n8k8 TF32
//   products into fp32 accumulators (the dropped x_lo w_lo is 2^-22 of
//   x w).  The weights are split once, by the packing kernel, into two
//   planes; x is split in registers after each A-fragment ldmatrix, reused
//   across the BN/8 n tiles.
// - Accumulation.  The tensor cores add into their fp32 accumulators by
//   truncation, which over a whole 3D tile erred by more than twice cuDNN's
//   fp32 sums.  So each tap of a (chunk, kh) step (16 channels, three
//   passes: 6 MMAs) is summed in fresh accumulators, its first MMA taking
//   zeros for C, and folded into the tile's sums with fp32 adds (round to
//   nearest).  A fresh sum per kh row (3 taps, 18 MMAs, the 3D kernels'
//   step) erred by 1.94x cuDNN fp32 against fp64 at (3, 37, 50, 24 -> 40)
//   in chip_smoke.py phase 3 on the H100 (the check's limit is 2x), a fold
//   per tap by 1.23x, for 11 % more time at the ACDC shapes.
// - Tiles.  Persistent blocks (as many as fit the card, spread over the
//   output-channel tiles) walk (tile, chunk) items: output tiles of 4 MT
//   rows x 32 pixels, each warp MT m16 tiles of half a row.  The halo
//   ((4 MT + 2) x 34 pixels) of a 16-channel chunk comes in as one TMA box:
//   64-byte rows (the bf16 kernel's 32-channel chunk in bytes) under the
//   64-byte swizzle, so non-transposed ldmatrix on 32-bit values gives the
//   TF32 A fragment conflict-free for every tap's shift; TMA's zero fill is
//   the SAME padding, the ragged edge and the channels past C.
// - Weight residency.  Two fp32 planes are 4x the bf16 bytes: 92 KB at
//   32 -> 32, 369 KB at 64 -> 64, so they do not stay resident as in the
//   bf16 kernel.  Each (chunk, kh) step's weights (both planes, 3 kw taps x
//   BN x 16, rows padded to 80 bytes: conflict-free ldmatrix) stream into
//   one of three stages beside two halo stages, on mbarriers; one thread
//   starts every copy, the next item's halo a whole item ahead.
// - BN = 32 with MT = 4 (16 x 32 pixels) or BN = 64 with MT = 2 (8 x 32),
//   so the tile's sums and the tap's fresh sums stay at 128 registers;
//   shared memory 126 or 137 KB.
// Needs C % 8 == 0 and F % 8 == 0 (the route's width rule; TMA needs 16-
// byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "mma_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCk = 16;  // fp32 channels of a staged chunk (64 bytes)
constexpr int kTW = 32, kHW = kTW + 2;  // output tile width, its halo
constexpr int kHaloStages = 2, kWStages = 3;

// The (4 MT, 32) output tile and its halo (one pixel more on each side):
// HH x kHW rows of kCk fp32 channels, one 1024-byte aligned stage.
template <int MT>
struct Tile {
  static constexpr int TH = 4 * MT;
  static constexpr int HH = TH + 2;
  static constexpr int rows = HH * kHW;
  static constexpr int bytes = rows * kCk * 4;
  static constexpr int stage = (bytes + 1023) / 1024 * 1024;
};

// One (chunk, kh) step of packed weights: two parts (hi, lo), each 3 kw
// taps x BN output channels x kCk input channels, rows of kCk + 4 floats
// (80 bytes: eight consecutive rows read at one 16-byte column fall on
// distinct banks).
template <int BN>
struct WTile {
  static constexpr int pitch = kCk + 4;
  static constexpr int part = 3 * BN * pitch;
  static constexpr int elems = 2 * part;
  static constexpr int bytes = elems * 4;
};

template <int BN, int MT>
constexpr int smem_bytes() {
  return kHaloStages * Tile<MT>::stage + kWStages * WTile<BN>::bytes +
         8 * (kHaloStages + kWStages) + 1024;
}

// The weights in the kernel's layout: wpk[n tile][chunk][kh][part][kw][n][k]
// (kCk + 4 values a row; part 0 hi, 1 lo) from torch's w[F][C][9]; with
// ``flip`` w is the forward's [C][F][9] and the packing is flip_swap's (the
// dgrad's weights: taps reversed, in and out swapped).  Zeros past C, F and
// kCk.
__global__ void __launch_bounds__(256)
conv2d_tf32_pack_kernel(const float* __restrict__ w, float* __restrict__ wpk,
                        int C, int F, int bn, int n_chunks, int flip,
                        long long total) {
  constexpr int pitch = kCk + 4;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long r = e;
    const int k = (int)(r % pitch);
    r /= pitch;
    const int n = (int)(r % bn);
    r /= bn;
    const int kw = (int)(r % 3);
    r /= 3;
    const int part = (int)(r % 2);
    r /= 2;
    const int tap = (int)(r % 3) * 3 + kw;
    r /= 3;
    const int c = (int)(r % n_chunks) * kCk + k;
    const int f = (int)(r / n_chunks) * bn + n;
    float v = 0.f;
    if (k < kCk && c < C && f < F)
      v = flip ? w[((long long)c * F + f) * 9 + 8 - tap]
               : w[((long long)f * C + c) * 9 + tap];
    unsigned hi, lo;
    split_tf32(__float_as_uint(v), hi, lo);
    wpk[e] = __uint_as_float(part == 0 ? hi : lo);
  }
}

template <int BN, int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv2d_tf32_same_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                            const float* __restrict__ wpk,
                            float* __restrict__ y, int H, int W, int F,
                            int n_chunks, int tiles_h, int tiles_w,
                            int n_tiles) {
  using Tl = Tile<MT>;
  using Wt = WTile<BN>;
  constexpr int NT = BN / 8;  // n8 tiles
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzle pattern is read from the address bits
  const unsigned raw = smem_u32(smem_raw);
  const unsigned halo0 = (raw + 1023) & ~1023u;
  const unsigned wts0 = halo0 + kHaloStages * Tl::stage;
  const unsigned bar0 = wts0 + kWStages * Wt::bytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row
  const int n0 = blockIdx.y * BN;
  const int items =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      n_chunks;
  const int steps = items * 3;
  const float* wblk = wpk + (long long)blockIdx.y * n_chunks * 3 * Wt::elems;

  // item i: chunk i % n_chunks of tile blockIdx.x + (i / n_chunks) gridDim.x,
  // whose sample and first output pixel are (b, y0, x0)
  auto tile_of = [&](int i, int& b, int& y0, int& x0) {
    int t = blockIdx.x + i / n_chunks * gridDim.x;
    x0 = t % tiles_w * kTW;
    t /= tiles_w;
    y0 = t % tiles_h * Tl::TH;
    b = t / tiles_h;
  };
  auto load_halo = [&](int i) {
    int b, y0, x0;
    tile_of(i, b, y0, x0);
    const int st = i % kHaloStages;
    const unsigned bar = bar0 + 8 * st;
    mbar_expect_tx(bar, Tl::bytes);
    tma_load_4d(halo0 + st * Tl::stage, &xmap, bar, i % n_chunks * kCk,
                x0 - 1, y0 - 1, b);
  };
  // step s: kh = s % 3 of item s / 3
  auto load_w = [&](int s) {
    const int st = s % kWStages;
    const unsigned bar = bar0 + 8 * (kHaloStages + st);
    mbar_expect_tx(bar, Wt::bytes);
    bulk_load(wts0 + st * Wt::bytes,
              wblk + (long long)(s / 3 % n_chunks * 3 + s % 3) * Wt::elems,
              Wt::bytes, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < kHaloStages + kWStages; ++i)
      mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_halo(0);
    if (items > 1) load_halo(1);
    load_w(0);
    if (steps > 1) load_w(1);
  }

  // halo row of this lane's ldmatrix row (pixel) in each m16 tile, tap 0
  int hrow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int v = (warp * MT + i) * 16 + (mat & 1) * 8 + r8;
    hrow[i] = (v / kTW) * kHW + v % kTW;
  }

  // acc: the tile's sums (fp32 adds); part: the current tap's (MMAs)
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int it = s / 3, kh = s % 3;
    if (tid == 0) {
      // the slots refilled here were last read in an earlier step, which
      // every thread has left (the barrier at its end)
      fence_proxy_async();
      if (s + 2 < steps) load_w(s + 2);
      if (kh == 0 && it >= 1 && it + 1 < items) load_halo(it + 1);
    }
    if (kh == 0)
      mbar_wait(bar0 + 8 * (it % kHaloStages), (it / kHaloStages) & 1);
    mbar_wait(bar0 + 8 * (kHaloStages + s % kWStages), (s / kWStages) & 1);
    const unsigned hs = halo0 + (it % kHaloStages) * Tl::stage;
    const unsigned ws = wts0 + (s % kWStages) * Wt::bytes;
    const int tap_row = kh * kHW;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
      for (int kk = 0; kk < kCk; kk += 8) {
        // B fragments of two n8 tiles per ldmatrix, hi and lo: matrices
        // (n jn, k 0-3), (n jn, k 4-7), (n jn + 1, k 0-3), (n jn + 1, k 4-7)
        unsigned bh[NT][2], bl[NT][2];
#pragma unroll
        for (int jn = 0; jn < NT; jn += 2) {
          const unsigned at =
              ws + ((kw * BN + (jn + (mat >> 1)) * 8 + r8) * Wt::pitch + kk +
                    (mat & 1) * 4) * 4;
          unsigned q[4];
          ldsm_x4(at, q);
          bh[jn][0] = q[0];
          bh[jn][1] = q[1];
          bh[jn + 1][0] = q[2];
          bh[jn + 1][1] = q[3];
          ldsm_x4(at + Wt::part * 4, q);
          bl[jn][0] = q[0];
          bl[jn][1] = q[1];
          bl[jn + 1][0] = q[2];
          bl[jn + 1][1] = q[3];
        }
        // A fragments, split: matrices (m 0-7, k 0-3), (m 8-15, k 0-3),
        // (m 0-7, k 4-7), (m 8-15, k 4-7); m is the shifted pixel
        unsigned ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4];
          ldsm_x4(hs + swz64(hrow[i] + tap_row + kw, kk / 4 + (mat >> 1)), a);
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[i][q], al[i][q]);
        }
        // the small products first, then the large one; the tap's first
        // MMAs start ``part`` from zeros
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            if (kk == 0)
              mma_tf32<true>(part[i][jn], al[i], bh[jn][0], bh[jn][1]);
            else
              mma_tf32(part[i][jn], al[i], bh[jn][0], bh[jn][1]);
          }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            mma_tf32(part[i][jn], ah[i], bl[jn][0], bl[jn][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            mma_tf32(part[i][jn], ah[i], bh[jn][0], bh[jn][1]);
      }
      // the tap's sums into the tile's, in fp32
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][jn][q] += part[i][jn][q];
    }
    __syncthreads();
    if (kh < 2 || it % n_chunks != n_chunks - 1) continue;

    // the tile's last chunk: accumulator (row l / 4 [+ 8], columns
    // 2 (l % 4) + {0, 1}) as fp32 pairs, then zeros for the next tile
    int b, y0, x0;
    tile_of(it, b, y0, x0);
    const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int v = (warp * MT + i) * 16 + g + 8 * half;
        const int gh = y0 + v / kTW, gw = x0 + v % kTW;
        if (gh >= H || gw >= W) continue;
        float* yr = y + (((long long)b * H + gh) * W + gw) * F;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int f = n0 + jn * 8 + c2;
          if (f < F)
            *reinterpret_cast<float2*>(yr + f) =
                make_float2(acc[i][jn][2 * half], acc[i][jn][2 * half + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.f;
  }
}

int pack_weights(const void* w, void* wpk, int C, int F, int bn, int flip,
                 cudaStream_t st) {
  const int n_chunks = (C + kCk - 1) / kCk;
  const long long total =
      (long long)((F + bn - 1) / bn) * n_chunks * 3 * 2 * 3 * bn * (kCk + 4);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  conv2d_tf32_pack_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<float*>(wpk), C, F, bn,
      n_chunks, flip, total);
  return (int)cudaGetLastError();
}

template <int BN, int MT>
int launch_fwd_tf32(const void* x, const void* wpk, void* y, int B, int H,
                    int W, int C, int F, cudaStream_t st) {
  using Tl = Tile<MT>;
  CUtensorMap map;
  const long long n[4] = {C, W, H, B};
  const unsigned box[4] = {kCk, kHW, Tl::HH, 1};
  if (!encode_map(&map, x, 4, n, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BN, MT>();
  auto kernel = conv2d_tf32_same_fwd_kernel<BN, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int tiles_h = (H + Tl::TH - 1) / Tl::TH, tiles_w = (W + kTW - 1) / kTW;
  const long long n_tiles = (long long)B * tiles_h * tiles_w;
  const int n_chunks = (C + kCk - 1) / kCk;
  if (n_tiles * n_chunks >= (1LL << 31) / 3 || per_sm < 1)
    return (int)cudaErrorInvalidValue;
  // one block for every slot the card has, spread over the F tiles
  const int n_f = (F + BN - 1) / BN;
  long long blocks = (long long)sms * per_sm / n_f;
  if (blocks < 1) blocks = 1;
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_f), kThreads, smem, st>>>(
      map, static_cast<const float*>(wpk), static_cast<float*>(y), H, W, F,
      n_chunks, tiles_h, tiles_w, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] fp32, y [B, H, W, F] fp32; w torch's [F, C, 3, 3] fp32,
// or with ``flip`` the forward weights [C, F, 3, 3] of which this conv is
// the input gradient (flip_swap: taps reversed, in and out swapped); wpk
// fp32 scratch of ceil(F / bn) * ceil(C / 16) * 3 * 2 * 3 * bn * 20 values,
// which a first kernel fills with the packed, split weights ([F tile]
// [16-channel chunk][kh][hi, lo][kw][bn][20], zeros past C, F and 16).
// bn 32 (16 x 32-pixel tiles) or 64 (8 x 32).  Needs C % 8 == 0, F % 8 == 0
// and 16-byte aligned x, wpk and y.
extern "C" int conv2d_same_fwd_tf32(const void* x, const void* w, void* wpk,
                                    void* y, int B, int H, int W, int C,
                                    int F, int bn, int flip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 != 0 || F % 8 != 0 || C < 8 || F < 8 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)wpk % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      (bn != 32 && bn != 64))
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, flip, st);
  if (err != 0) return err;
  if (bn == 32) return launch_fwd_tf32<32, 4>(x, wpk, y, B, H, W, C, F, st);
  return launch_fwd_tf32<64, 2>(x, wpk, y, B, H, W, C, F, st);
}

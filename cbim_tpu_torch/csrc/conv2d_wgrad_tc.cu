// Weight gradient of the stride-1, zero-pad-1, 3x3 convolution on Hopper's
// bf16 tensor cores (sm_90a): conv2d_wgrad_tc.  The forward and dgrad are
// conv2d_tc.cu; the CUDA-core weight gradient (fp32, widths that are not
// multiples of 8) stays in conv2d.cu.
//
// Replaces _wgrad_kernel2 / conv2d_wgrad of cbim_tpu/ops/pallas/conv2d.py
// in bf16:
//   dW[kh, kw, c, f] = sum_{b, h, w} x[b, h+kh-1, w+kw-1, c] * g[b, h, w, f],
// zeros outside the image; bf16 x and g, fp32 sums, dW [3, 3, C, F] fp32.
// The TPU kernel's packing (K = 3C, 128-lane kw groups of g) is not carried
// over.
//
// What bounds it on the H100: bytes at 32 -> 32 (x and g are 268 MB at
// (32, 256^2), 0.080 ms at 3.35 TB/s, against 0.039 ms of operations),
// balanced at (32, 128^2, 64 -> 64) (0.040 ms either way); K = every pixel
// (2.1 M or 0.5 M) is reduced into a small output (9 * C * F values).
//
// What the design does about it: per tap a GEMM dW_t (M = c, N = f) =
// X_t^T G over K = pixels, on mma.sync.m16n8k16 (bf16 in, fp32 sums).
// - A block owns all 9 taps of one (c tile, f tile) of dW, each tile all of
//   C and F up to 64 (every ACDC width), and walks a chunk of (TH, 32)-pixel
//   tiles.  So each x halo and each g tile is staged once, by TMA: the halo
//   (TH + 2) x 34 pixels (zero fill = the SAME padding and the ragged edge)
//   and the g tile TH x 32, one box a 32-channel slice, 64-byte swizzled
//   rows, in a ring of 4 stages.  TH = 8 at a 32 x 32 tile (1.33 staged x
//   pixels per pixel), 4 where a 64-wide tile doubles the stage.
// - Warp specialisation: one producer warp (one thread) starts the copies
//   on full/empty mbarriers; 9 consumer warps, warp (kh, kw) owning one
//   tap's whole c x f tile (32 or 128 fp32 accumulators a thread).
// - Operands: A = X_t^T by ldmatrix.trans from the shifted halo rows (a
//   tap's shift is an address), B = G by ldmatrix.trans.
// - Split-K over chunks of pixel tiles, about one block an SM: each block
//   writes fp32 partials and a second kernel folds the chunks in a fixed
//   order.  No atomics, so results repeat bit for bit.
// Needs C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "mma_common.cuh"
#include "wgrad_fold.cuh"

namespace {

constexpr int kWarps = 9;                    // consumer warps, one a tap
constexpr int kThreads = (kWarps + 1) * 32;  // and one producer warp
constexpr int kCc = 32;                      // channels of one box
constexpr int kTW = 32, kHW = kTW + 2;       // pixel tile width, its halo
constexpr int kStages = 4;

// the pixel tile (TH x 32) and a block's stage for a (TC, TF) tile of dW
template <int TC, int TF, int TH>
struct WgTile {
  static constexpr int HH = TH + 2;
  static constexpr int halo_bytes = HH * kHW * kCc * 2;   // one x box
  static constexpr int halo_slot = (halo_bytes + 1023) / 1024 * 1024;
  static constexpr int g_bytes = TH * kTW * kCc * 2;      // one g box
  static constexpr int CX = TC / kCc, CG = TF / kCc;      // boxes a stage
  static constexpr int stage = CX * halo_slot + CG * g_bytes;
  static constexpr int tx_bytes = CX * halo_bytes + CG * g_bytes;
  static constexpr int smem = kStages * stage + 16 * kStages + 1024;
};

// partial[chunk, kh, kw, c, f]; grid.x = (c tile, f tile), grid.y = chunk
// of pixel tiles.
template <int TC, int TF, int TH>
__global__ void __launch_bounds__(kThreads, 1)
conv2d_wgrad_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap gmap,
                       float* __restrict__ partial, int C, int F, int tiles_h,
                       int tiles_w, int n_tiles, int tiles_per_chunk) {
  using T = WgTile<TC, TF, TH>;
  constexpr int MI = TC / 16, NJ = TF / 8;
  extern __shared__ uint8_t smem_raw[];
  const unsigned stage0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned full0 = stage0 + kStages * T::stage;
  const unsigned empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nft = (F + TF - 1) / TF;
  const int c0 = blockIdx.x / nft * TC, f0 = blockIdx.x % nft * TF;
  const int chunk = blockIdx.y;
  const int t_begin = chunk * tiles_per_chunk;
  const int count = min(n_tiles - t_begin, tiles_per_chunk);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: one thread starts every copy, up to 4 tiles ahead
    if (lane == 0) {
      for (int s = 0; s < count; ++s) {
        const int st = s % kStages;
        if (s >= kStages) {
          mbar_wait(empty0 + 8 * st, (s / kStages - 1) & 1);
          fence_proxy_async();
        }
        int t = t_begin + s;
        const int tx = t % tiles_w;
        t /= tiles_w;
        const int ty = t % tiles_h;
        const int b = t / tiles_h;
        const unsigned dst = stage0 + st * T::stage;
        const unsigned bar = full0 + 8 * st;
        mbar_expect_tx(bar, T::tx_bytes);
#pragma unroll
        for (int q = 0; q < T::CX; ++q)
          tma_load_4d(dst + q * T::halo_slot, &xmap, bar, c0 + q * kCc,
                      tx * kTW - 1, ty * TH - 1, b);
#pragma unroll
        for (int q = 0; q < T::CG; ++q)
          tma_load_4d(dst + T::CX * T::halo_slot + q * T::g_bytes, &gmap, bar,
                      f0 + q * kCc, tx * kTW, ty * TH, b);
      }
    }
    return;
  }

  const int mat = lane / 8, r8 = lane % 8;
  const int kh = warp / 3, kw = warp % 3;
  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int s = 0; s < count; ++s) {
    const int st = s % kStages;
    mbar_wait(full0 + 8 * st, (s / kStages) & 1);
    const unsigned xs = stage0 + st * T::stage;
    const unsigned gs = xs + T::CX * T::halo_slot;
#pragma unroll 2
    for (int kk = 0; kk < TH * kTW / 16; ++kk) {
      // B = G (k = pixel, n = f): matrices (k 0-7, n j), (k 8-15, n j),
      // (k 0-7, n j + 1), (k 8-15, n j + 1)
      unsigned bf[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        unsigned q[4];
        ldsm_x4_t(gs + (j / 4) * T::g_bytes +
                      swz64(kk * 16 + (mat & 1) * 8 + r8, j % 4 + (mat >> 1)),
                  q);
        bf[j][0] = q[0];
        bf[j][1] = q[1];
        bf[j + 1][0] = q[2];
        bf[j + 1][1] = q[3];
      }
      // A = X_t^T (m = c, k = pixel): matrices (m 0-7, k 0-7), (m 8-15,
      // k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15); this lane's storage row
      // is pixel p of the tile, shifted by the tap
      const int p = kk * 16 + (mat >> 1) * 8 + r8;
      const int hrow = (p / kTW + kh) * kHW + p % kTW + kw;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        unsigned a[4];
        ldsm_x4_t(xs + (i / 2) * T::halo_slot +
                      swz64(hrow, (i % 2) * 2 + (mat & 1)),
                  a);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], a, bf[j][0], bf[j][1]);
      }
    }
    // this warp is done with the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // accumulator (row c = l / 4 [+ 8], columns f = 2 (l % 4) + {0, 1})
  const int g = lane / 4, c2 = (lane % 4) * 2;
  float* out = partial + ((long long)chunk * 9 + warp) * C * F;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + i * 16 + g + 8 * half;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int f = f0 + j * 8 + c2;
        if (f < F)
          *reinterpret_cast<float2*>(out + (long long)c * F + f) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
}

template <int TC, int TF, int TH>
int launch_wgrad_tc(const void* x, const void* g, float* partial, int B,
                    int H, int W, int C, int F, int tiles_per_chunk,
                    int n_chunks, cudaStream_t st) {
  using T = WgTile<TC, TF, TH>;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + kTW - 1) / kTW;
  const long long n_tiles = (long long)B * tiles_h * tiles_w;
  if (n_tiles >= (1LL << 31) || tiles_per_chunk < 1 || n_chunks < 1 ||
      (long long)tiles_per_chunk * n_chunks < n_tiles ||
      (long long)tiles_per_chunk * (n_chunks - 1) >= n_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  const long long nx[4] = {C, W, H, B}, ng[4] = {F, W, H, B};
  const unsigned xbox[4] = {kCc, kHW, T::HH, 1};
  const unsigned gbox[4] = {kCc, kTW, TH, 1};
  if (!encode_map(&xmap, x, 4, nx, xbox) || !encode_map(&gmap, g, 4, ng, gbox))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv2d_wgrad_tc_kernel<TC, TF, TH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_cf = ((C + TC - 1) / TC) * ((F + TF - 1) / TF);
  kernel<<<dim3((unsigned)tiles_cf, (unsigned)n_chunks), kThreads, T::smem,
           st>>>(xmap, gmap, partial, C, F, tiles_h, tiles_w, (int)n_tiles,
                 tiles_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] and g [B, H, W, F] bf16; partial fp32 scratch of
// n_chunks * 9 * C * F; dw [3, 3, C, F] fp32.  dW is cut into (TC, TF)
// tiles, TC = 32 where C <= 32 else 64 (TF likewise from F); the pixel
// tiles are (TH, 32) boxes, TH = 8 where TC = TF = 32 else 4,
// B * ceil(H / TH) * ceil(W / 32) of them in (b, h, w) order;
// tiles_per_chunk * n_chunks must cover them, every chunk holding one at
// least.  Needs C % 8 == 0, F % 8 == 0 and 16-byte aligned x and g.
extern "C" int conv2d_wgrad_tc(const void* x, const void* g, void* partial,
                               void* dw, int B, int H, int W, int C, int F,
                               int tiles_per_chunk, int n_chunks,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 != 0 || F % 8 != 0 || C < 8 || F < 8 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)g % 16 != 0)
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  const bool wide_c = C > kCc, wide_f = F > kCc;
  int err;
  if (!wide_c && !wide_f)
    err = launch_wgrad_tc<32, 32, 8>(x, g, part, B, H, W, C, F,
                                     tiles_per_chunk, n_chunks, st);
  else if (!wide_c)
    err = launch_wgrad_tc<32, 64, 4>(x, g, part, B, H, W, C, F,
                                     tiles_per_chunk, n_chunks, st);
  else if (!wide_f)
    err = launch_wgrad_tc<64, 32, 4>(x, g, part, B, H, W, C, F,
                                     tiles_per_chunk, n_chunks, st);
  else
    err = launch_wgrad_tc<64, 64, 4>(x, g, part, B, H, W, C, F,
                                     tiles_per_chunk, n_chunks, st);
  if (err != 0) return err;
  return launch_wgrad_fold(static_cast<const float*>(part),
                           static_cast<float*>(dw), 9LL * C * F, n_chunks, st);
}

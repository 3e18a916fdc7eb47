// Stride-1, zero-pad-1, 3x3 convolution on Hopper's bf16 tensor cores
// (sm_90a): the forward, which also computes the input gradient on
// flip-swapped weights (conv2d_same_fwd_tc).  The weight gradient is
// conv2d_wgrad_tc.cu; the CUDA-core kernels (fp32, widths that are not
// multiples of 8) stay in conv2d.cu.
//
// Replaces the Pallas TPU kernel of cbim_tpu/ops/pallas/conv2d.py
// _conv_kernel2 / conv2d_same and the dgrad of its VJP conv2d_same_t (the
// same kernel on _flip_swap2 weights), in bf16:
//   y[b, h, w, f] = sum_{kh, kw, c} x[b, h+kh-1, w+kw-1, c] * w[kh, kw, c, f],
// zeros outside the image, bf16 x and w, fp32 sums, y rounded once to bf16.
// The TPU kernel's tap packing (K = 3C, 128-lane kw groups) filled MXU
// tiles and is not carried over; what is carried over is its halo tile:
// one DMA of an (h_blk + 2)-row box per output tile.
//
// What bounds it on the H100: bytes.  At MedFormer-2D's ACDC widths a conv
// does 2 * 9 * C * F FLOPs per pixel against 2 (C + F) bytes: (32, 256^2,
// 32 -> 32) is 38.7 GFLOP (0.039 ms at 989 TFLOP/s) against 268 MB of x
// and y (0.080 ms at 3.35 TB/s); (32, 128^2, 64 -> 64) is balanced, 0.039
// ms of operations against 0.040 ms of bytes.  So the kernel must read each
// byte about once and keep loads in flight, not only feed the MMAs.
//
// What the design does about it: an implicit GEMM on mma.sync.m16n8k16
// (bf16 in, fp32 accumulators in registers across the 9 taps and every
// 32-channel chunk), fed from shared memory that TMA fills.
// - Persistent blocks, one an SM (the grid is the SM count over the output
//   channel tiles), each walking a strided list of (8 RW) x 32-pixel output
//   tiles.  A block owns every output channel of its tile (BN up to 96),
//   so x is read once a tile: its (8 RW + 2) x 34 x 32-channel halo, 1.2-
//   1.3 staged pixels per output pixel.
// - One TMA box per (tile, chunk): 64-byte rows with the 64-byte swizzle
//   (swz64), so ldmatrix reads eight pixel rows conflict-free; TMA's zero
//   fill of out-of-bounds coordinates is the SAME padding, the ragged H/W
//   edge and the channels past C.  A tap's shift is an ldmatrix address.
// - Loads in flight: a ring of up to 4 halo stages on full/empty
//   mbarriers.  Thread 0 starts every copy, stages - 1 steps ahead; each
//   warp releases a stage as soon as it has read it, and only thread 0
//   waits for the release (8 warps, one block an SM: 255 registers a
//   thread; a ninth, producer warp would share an SM quarter with two
//   others and cap them at 168).
// - The weights, packed by a first small kernel (conv2d_tc_pack_kernel,
//   which also applies the dgrad's flip_swap) as [n tile][chunk][tap][32]
//   [BN + 8] (rows padded by 16 bytes: conflict-free ldmatrix.trans), stay
//   resident in shared memory for the block's whole run where they fit
//   (every ACDC width: 23 KB at 32 -> 32, 83 KB at 64 -> 64); else one
//   chunk rides in each stage beside its halo (192 -> 160).
// - Each warp owns RW output rows of 32 pixels x BN channels (RW
//   = 2 at BN = 32, else 1): 2 RW m16 tiles, whose A fragments share each
//   B fragment.
// - The epilogue rounds to bf16 once, writes the warp's rows into a
//   swizzled staging buffer in shared memory (conflict-free) and stores
//   them with one TMA store a 32-channel slab: full sectors, clipped at the
//   ragged edge and past F by TMA itself, and asynchronous, so the next
//   tile's MMAs start at once.
// Needs C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCc = 32;                      // channels of a staged chunk
constexpr int kTW = 32, kHW = kTW + 2;       // output tile width, its halo
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;  // a block's opt-in shared memory, sm_90
constexpr int kBars = 2 * kMaxStages + 1;

__host__ __device__ constexpr int align1k(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// the output tile: 8 warps x RW rows of 32 pixels, and its halo
template <int RW>
struct Tile {
  static constexpr int TH = kWarps * RW;
  static constexpr int HH = TH + 2;
  static constexpr int halo_bytes = HH * kHW * kCc * 2;
  static constexpr int halo_slot = align1k(halo_bytes);
};

// one 32-channel chunk of packed weights: 9 taps x 32 x (BN + 8)
template <int BN>
struct WChunk {
  static constexpr int pitch = BN + 8;
  static constexpr int elems = 9 * kCc * pitch;
  static constexpr int bytes = elems * 2;
};

// bytes of the epilogue's staging buffer: each warp's RW x 32 pixels x BN
// channels in 32-channel slabs of 64-byte rows
template <int BN, int RW>
__host__ __device__ constexpr int out_bytes() {
  return kWarps * (BN / kCc) * RW * kTW * 64;
}

template <int BN, int RW>
__global__ void __launch_bounds__(kThreads, 1)
conv2d_tc_same_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap ymap,
                          const bf16* __restrict__ wpk, int n_chunks,
                          int tiles_h, int tiles_w, int n_tiles, int stages,
                          int resident) {
  using Tl = Tile<RW>;
  using Wc = WChunk<BN>;
  constexpr int MT = 2 * RW;         // m16 tiles a warp
  constexpr int NT = BN / 8;         // n8 tiles
  constexpr int slab = RW * kTW * 64;  // one warp's 32-channel slab, bytes
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzle pattern is read from the address bits
  const unsigned out0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned wres = out0 + out_bytes<BN, RW>();
  const unsigned stage0 =
      wres + (resident ? align1k(n_chunks * Wc::bytes) : 0);
  const int stage_bytes = Tl::halo_slot + (resident ? 0 : align1k(Wc::bytes));
  const unsigned full0 = stage0 + stages * stage_bytes;
  const unsigned empty0 = full0 + 8 * kMaxStages;
  const unsigned wbar = empty0 + 8 * kMaxStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* wblk = wpk + (long long)blockIdx.y * n_chunks * Wc::elems;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = my_tiles * n_chunks;

  // step s = (this block's tile s / n_chunks, chunk s % n_chunks): its halo
  // box (and, streaming, its weight chunk) into slot s % stages
  auto load_step = [&](int s) {
    int t = (int)blockIdx.x + (s / n_chunks) * (int)gridDim.x;
    const int cc = s % n_chunks;
    const int tx = t % tiles_w;
    t /= tiles_w;
    const int ty = t % tiles_h;
    const int b = t / tiles_h;
    const int st = s % stages;
    const unsigned dst = stage0 + st * stage_bytes;
    const unsigned bar = full0 + 8 * st;
    mbar_expect_tx(bar, Tl::halo_bytes + (resident ? 0 : Wc::bytes));
    tma_load_4d(dst, &xmap, bar, cc * kCc, tx * kTW - 1, ty * Tl::TH - 1, b);
    if (!resident)
      bulk_load(dst + Tl::halo_slot, wblk + (long long)cc * Wc::elems,
                Wc::bytes, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWarps);
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    if (resident) {
      mbar_expect_tx(wbar, n_chunks * Wc::bytes);
      bulk_load(wres, wblk, n_chunks * Wc::bytes, wbar);
    }
    for (int s = 0; s < stages - 1 && s < steps; ++s) load_step(s);
  }

  // warp w owns output rows w RW .. w RW + RW - 1 of a tile
  const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row
  // halo row of this lane's ldmatrix row (pixel) in each m16 tile, tap 0
  int hrow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    hrow[i] = (warp * RW + i / 2) * kHW + (i % 2) * 16 + (mat & 1) * 8 + r8;
  const unsigned outw = out0 + warp * (BN / kCc) * slab;
  if (resident) mbar_wait(wbar, 0);

  int s = 0;
  for (int it = 0; it < my_tiles; ++it) {
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    for (int cc = 0; cc < n_chunks; ++cc, ++s) {
      if (tid == 0 && s + stages - 1 < steps) {
        // step s + stages - 1 refills the slot of step s - 1 once every
        // warp has released it
        if (s >= 1) {
          mbar_wait(empty0 + 8 * ((s - 1) % stages), (s - 1) / stages & 1);
          fence_proxy_async();
        }
        load_step(s + stages - 1);
      }
      const int st = s % stages;
      mbar_wait(full0 + 8 * st, (s / stages) & 1);
      const unsigned hs = stage0 + st * stage_bytes;
      const unsigned ws = resident ? wres + cc * Wc::bytes : hs + Tl::halo_slot;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int tap_row = (tap / 3) * kHW + tap % 3;
#pragma unroll
        for (int kk = 0; kk < kCc; kk += 16) {
          // B fragments of two n8 tiles per ldmatrix: matrices (k 0-7, n j),
          // (k 8-15, n j), (k 0-7, n j + 1), (k 8-15, n j + 1)
          unsigned bf[NT][2];
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            unsigned q[4];
            ldsm_x4_t(ws + ((tap * kCc + kk + (mat & 1) * 8 + r8) * Wc::pitch +
                            (j + (mat >> 1)) * 8) * 2,
                      q);
            bf[j][0] = q[0];
            bf[j][1] = q[1];
            bf[j + 1][0] = q[2];
            bf[j + 1][1] = q[3];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            // A fragment: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
            // (m 0-7, k 8-15), (m 8-15, k 8-15); m is the shifted pixel
            unsigned a[4];
            ldsm_x4(hs + swz64(hrow[i] + tap_row, kk / 8 + (mat >> 1)), a);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(acc[i][j], a, bf[j][0], bf[j][1]);
          }
        }
      }
      // this warp is done with the slot
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // epilogue: the accumulator (row l / 4 [+ 8], columns 2 (l % 4) +
    // {0, 1}) as bf16 pairs into the swizzled staging slabs, then one TMA
    // store a slab; the previous tile's stores must have read the buffer
    if (it > 0) {
      if (lane == 0) bulk_wait_read();
      __syncwarp();
    }
    const int g = lane / 4, c4 = (lane % 4) * 4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (i / 2) * kTW + (i % 2) * 16 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[i][j][2 * half], acc[i][j][2 * half + 1]);
          st_shared_u32(outw + (j / 4) * slab + swz64(row, j % 4) + c4,
                        *reinterpret_cast<const unsigned*>(&v));
        }
      }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      int t = (int)blockIdx.x + it * (int)gridDim.x;
      const int tx = t % tiles_w;
      t /= tiles_w;
      const int ty = t % tiles_h;
      const int b = t / tiles_h;
#pragma unroll
      for (int sl = 0; sl < BN / kCc; ++sl)
        tma_store_4d(&ymap, outw + sl * slab, (int)blockIdx.y * BN + sl * kCc,
                     tx * kTW, ty * Tl::TH + warp * RW, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int BN, int RW>
int launch_fwd_tc(const void* x, const void* wpk, void* y, int B, int H,
                  int W, int C, int F, cudaStream_t st) {
  using Tl = Tile<RW>;
  using Wc = WChunk<BN>;
  const int n_chunks = (C + kCc - 1) / kCc;
  const int n_ntiles = (F + BN - 1) / BN;
  const int fixed = 1024 + out_bytes<BN, RW>() + 8 * kBars;
  const int res_bytes = align1k(n_chunks * Wc::bytes);
  // resident weights where they leave room for 3 halo stages, else one
  // weight chunk in each stage
  int resident = fixed + res_bytes + 3 * Tl::halo_slot <= kSmemLimit;
  const int stage_bytes = Tl::halo_slot + (resident ? 0 : align1k(Wc::bytes));
  const int room = kSmemLimit - fixed - (resident ? res_bytes : 0);
  const int stages = room / stage_bytes < kMaxStages ? room / stage_bytes
                                                     : kMaxStages;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem =
      fixed + (resident ? res_bytes : 0) + stages * stage_bytes;

  CUtensorMap xmap, ymap;
  const long long nx[4] = {C, W, H, B}, ny[4] = {F, W, H, B};
  const unsigned xbox[4] = {kCc, kHW, Tl::HH, 1};
  const unsigned ybox[4] = {kCc, kTW, RW, 1};
  if (!encode_map(&xmap, x, 4, nx, xbox) || !encode_map(&ymap, y, 4, ny, ybox))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv2d_tc_same_fwd_kernel<BN, RW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + Tl::TH - 1) / Tl::TH, tiles_w = (W + kTW - 1) / kTW;
  const long long tiles = (long long)B * tiles_h * tiles_w;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  long long blocks = sm_count() / n_ntiles;
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_ntiles), kThreads, smem, st>>>(
      xmap, ymap, static_cast<const bf16*>(wpk), n_chunks, tiles_h, tiles_w,
      (int)tiles, stages, resident);
  return (int)cudaGetLastError();
}

// The weights in the kernel's layout: wpk[n tile][chunk][tap][k][n] (bn +
// 8 values a row) from torch's w[F][C][9]; with ``flip`` w is the forward's
// [C][F][9] and the packing is flip_swap's (the dgrad's weights: taps
// reversed, in and out swapped).  Zeros past C, F and bn.
__global__ void __launch_bounds__(256)
conv2d_tc_pack_kernel(const bf16* __restrict__ w, bf16* __restrict__ wpk,
                      int C, int F, int bn, int n_chunks, int flip,
                      long long total) {
  const int pitch = bn + 8;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long r = e;
    const int n = (int)(r % pitch);
    r /= pitch;
    const int k = (int)(r % kCc);
    r /= kCc;
    const int tap = (int)(r % 9);
    r /= 9;
    const int c = (int)(r % n_chunks) * kCc + k;
    const int f = (int)(r / n_chunks) * bn + n;
    bf16 v = __float2bfloat16_rn(0.f);
    if (n < bn && c < C && f < F)
      v = flip ? w[((long long)c * F + f) * 9 + 8 - tap]
               : w[((long long)f * C + c) * 9 + tap];
    wpk[e] = v;
  }
}

int pack_weights(const void* w, void* wpk, int C, int F, int bn, int flip,
                 cudaStream_t st) {
  const int n_chunks = (C + kCc - 1) / kCc;
  const long long total =
      (long long)((F + bn - 1) / bn) * n_chunks * 9 * kCc * (bn + 8);
  long long blocks = (total + 255) / 256;
  if (blocks > sm_count() * 8) blocks = sm_count() * 8;
  conv2d_tc_pack_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpk), C, F, bn,
      n_chunks, flip, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] bf16, y [B, H, W, F] bf16; w torch's [F, C, 3, 3] bf16,
// or with ``flip`` the forward weights [C, F, 3, 3] of which this conv is
// the input gradient (flip_swap: taps reversed, in and out swapped); wpk
// bf16 scratch of ceil(F / bn) * ceil(C / 32) * 9 * 32 * (bn + 8) values,
// which a first kernel fills with the packed weights ([F tile][32-channel
// chunk][kh, kw][32][bn + 8], zeros past C, F and bn).  bn 32, 64 or 96.
// Needs C % 8 == 0, F % 8 == 0 and 16-byte aligned x, wpk and y.
extern "C" int conv2d_same_fwd_tc(const void* x, const void* w, void* wpk,
                                  void* y, int B, int H, int W, int C, int F,
                                  int bn, int flip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 != 0 || F % 8 != 0 || C < 8 || F < 8 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)wpk % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      (bn != 32 && bn != 64 && bn != 96))
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, flip, st);
  if (err != 0) return err;
  if (bn == 32) return launch_fwd_tc<32, 2>(x, wpk, y, B, H, W, C, F, st);
  if (bn == 64) return launch_fwd_tc<64, 1>(x, wpk, y, B, H, W, C, F, st);
  return launch_fwd_tc<96, 1>(x, wpk, y, B, H, W, C, F, st);
}

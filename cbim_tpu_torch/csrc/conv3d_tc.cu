// Stride-1, zero-pad-1, 3x3x3 convolution on Hopper's bf16 tensor cores
// (sm_90a): the forward, which also computes the input gradient on
// flip-swapped weights (conv3d_same_fwd_tc).  The weight gradient is
// conv3d_wgrad_tc.cu, the fused preact conv's forward conv3d_na_tc.cu; the
// CUDA-core kernels (fp32, widths that are not multiples of 8) stay in
// conv3d.cu.  The box, weight layout and packing kernel are shared with
// conv3d_na_tc.cu (conv3d_tc_common.cuh).
//
// Replaces the Pallas TPU kernels of cbim_tpu/ops/pallas/conv3d.py
// conv3d_same / _conv3d_same_pallas and the dgrad of its VJP conv3d_same_t
// (the forward kernel on _flip_swap'd weights), in bf16:
//   y[b, d, h, w, f] = sum_{kd, kh, kw, c} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                        * w[kd, kh, kw, c, f],
// zeros outside the volume, bf16 x and w, fp32 sums, y rounded once to bf16.
// The TPU kernel's tap packing (K = 3C, N = 9F) filled 128-lane MXU tiles
// and is not carried over; what is carried over is its halo tile: one DMA of
// a (d_blk + 2, h_blk + 2, W + 2) box per output tile (_halo_tile_dma).
//
// What bounds it on the H100: operations.  2 * 27 * C * F FLOPs per voxel,
// 0.70 TFLOP at (2, 128^3, 96 -> 32): 0.70 ms at 989 TFLOP/s, against 0.34
// GB of x, w and y (0.10 ms at 3.35 TB/s).
//
// What the design does about it: an implicit GEMM on mma.sync.m16n8k16
// (bf16 in, fp32 accumulators held in registers across all 27 taps and all
// channel chunks), fed from shared memory that TMA fills asynchronously.
// - A block owns a (4, 8, 4 * MT) box of output voxels (256 or 512) and up
//   to 128 output channels (BN), so the halo is read once for every output
//   channel of the tile: at F = 96 (the 32 -> 96 dgrad) one column tile.
// - The halo (6 x 10 x (4 MT + 2) voxels x 32 channels) arrives as one 5D
//   TMA box; TMA's zero fill of out-of-bounds coordinates is the SAME
//   padding, the ragged D/H/W edge and the channels past C.  2.3-2.8 staged
//   rows per output row, against 27 in conv3d.cu.  64-byte rows with the
//   64-byte swizzle, so ldmatrix reads eight consecutive rows conflict-free.
// - A tap's shift is an address: each lane's ldmatrix row points at the
//   shifted voxel's halo row.
// - The weights, packed by a first small kernel (conv3d_tc_pack_kernel,
//   which also applies the dgrad's flip_swap) as [n tile][32-channel chunk]
//   [kd, kh][kw][32][BN + 8] (rows padded by 16 bytes: conflict-free
//   ldmatrix.trans), arrive by one bulk copy per (chunk, kd, kh) step.
// - Pipelining: 2 halo stages (a chunk's halo lands while the one before is
//   multiplied) and 3 weight stages on mbarriers; one thread starts every
//   copy, the others never spend an instruction on loading.
// - 8 warps, each MT m16 tiles x BN: MT = 4 at BN <= 64 (128 accumulators a
//   thread), MT = 2 at BN = 96, 128; MT = 2 at BN <= 64 too where 512-voxel
//   tiles would give fewer than two blocks an SM (small volumes).
// The epilogue rounds to bf16 once and stores bf16 pairs, masked at the
// ragged edge.  Needs C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides).
//
// The phase ladder (conv3d_same_fwd_ladder, with conv3d_tf32.cu's fp32
// rungs) is the port of the TPU probe tools/probe_cw_dissect.py (build: the
// production kernel cut after its DMA, transpose, dot or reduce): this
// kernel cut after a phase, PHASE =
//   kPhaseCopy: the halo TMA boxes and the weight bulk copies land, with
//               the mbarrier waits and the step barriers; nothing is read
//               from the stages;
//   kPhaseFrag: plus the ldmatrix A and B fragments (each thread XORs
//               them into its one value);
//   kPhaseMma:  plus the mma.sync products (each thread sums its
//               accumulators);
//   kPhaseFull: plus the epilogue: the very instantiation
//               conv3d_same_fwd_tc launches (the default: the cut costs
//               the production kernel nothing, if constexpr only).
// A cut rung stores one value a thread, which depends on all the work it
// keeps, so the compiler drops none of it; its output is otherwise garbage
// by design.  The entry's weight-packing kernel runs before every rung, as
// in production; phase 0 runs it alone.  The tile sweep is the production
// picker's two tiles at BN = 32: MT 4 (512-voxel boxes) and MT 2.
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "conv3d_tc_common.cuh"

namespace {

// the ladder's rungs (0: the weight packing alone)
constexpr int kPhasePack = 0, kPhaseCopy = 1, kPhaseFrag = 2, kPhaseMma = 3,
              kPhaseFull = 4;

template <int BN, int MT, int PHASE = kPhaseFull>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_tc_same_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                          const bf16* __restrict__ wpk, bf16* __restrict__ y,
                          int D, int H, int W, int F, int n_chunks,
                          int tiles_d, int tiles_h, int tiles_w) {
  using Bx = Box<MT>;
  using Wt = WTile<BN>;
  constexpr int NT = BN / 8;  // n8 tiles
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzle pattern is read from the address bits
  const unsigned raw = smem_u32(smem_raw);
  const unsigned halo0 = (raw + 1023) & ~1023u;
  const unsigned wts0 = halo0 + kHaloStages * Bx::stage;
  const unsigned bar0 = wts0 + kWStages * Wt::bytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row
  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  t /= tiles_h;
  const int tz = t % tiles_d;
  const int b = t / tiles_d;
  const int z0 = tz * kTD, y0 = ty * kTH, x0 = tx * Bx::TW;
  const int n0 = blockIdx.y * BN;
  const int steps = n_chunks * 9;
  const bf16* wblk = wpk + (long long)blockIdx.y * steps * Wt::elems;

  auto load_halo = [&](int cc) {
    const int st = cc % kHaloStages;
    const unsigned bar = bar0 + 8 * st;
    mbar_expect_tx(bar, Bx::bytes);
    tma_load_5d(halo0 + st * Bx::stage, &xmap, bar, cc * kCc, x0 - 1, y0 - 1,
                z0 - 1, b);
  };
  auto load_w = [&](int s) {
    const int st = s % kWStages;
    const unsigned bar = bar0 + 8 * (kHaloStages + st);
    mbar_expect_tx(bar, Wt::bytes);
    bulk_load(wts0 + st * Wt::bytes, wblk + (long long)s * Wt::elems,
              Wt::bytes, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < kHaloStages + kWStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_halo(0);
    if (n_chunks > 1) load_halo(1);
    load_w(0);
    if (steps > 1) load_w(1);
  }

  // halo row of this lane's ldmatrix row (voxel) in each m16 tile, tap 0
  int hrow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int v = (warp * MT + i) * 16 + (mat & 1) * 8 + r8;
    const int z = v / (kTH * Bx::TW), yy = (v / Bx::TW) % kTH,
              xx = v % Bx::TW;
    hrow[i] = (z * Bx::HH + yy) * Bx::HW + xx;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  unsigned chk = 0;  // a cut rung's one stored value

  for (int s = 0; s < steps; ++s) {
    const int cc = s / 9, kdh = s % 9;
    if (tid == 0) {
      // the slots refilled here were last read in step s - 1, which every
      // thread has left (the barrier at its end)
      fence_proxy_async();
      if (s + 2 < steps) load_w(s + 2);
      if (kdh == 0 && cc >= 1 && cc + 1 < n_chunks) load_halo(cc + 1);
    }
    if (kdh == 0)
      mbar_wait(bar0 + 8 * (cc % kHaloStages), (cc / kHaloStages) & 1);
    mbar_wait(bar0 + 8 * (kHaloStages + s % kWStages), (s / kWStages) & 1);
    const unsigned hs = halo0 + (cc % kHaloStages) * Bx::stage;
    const unsigned ws = wts0 + (s % kWStages) * Wt::bytes;
    const int tap_row = ((kdh / 3) * Bx::HH + kdh % 3) * Bx::HW;
    if constexpr (PHASE == kPhaseCopy) chk += s;
    if constexpr (PHASE >= kPhaseFrag) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int kk = 0; kk < kCc; kk += 16) {
          // B fragments of two n8 tiles per ldmatrix: matrices (k 0-7, n j),
          // (k 8-15, n j), (k 0-7, n j + 1), (k 8-15, n j + 1)
          unsigned bf[NT][2];
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            unsigned q[4];
            ldsm_x4_t(ws + ((kw * kCc + kk + (mat & 1) * 8 + r8) * Wt::pitch +
                            (j + (mat >> 1)) * 8) * 2,
                      q);
            bf[j][0] = q[0];
            bf[j][1] = q[1];
            bf[j + 1][0] = q[2];
            bf[j + 1][1] = q[3];
            if constexpr (PHASE == kPhaseFrag)
              chk ^= q[0] ^ q[1] ^ q[2] ^ q[3];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            // A fragment: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
            // (m 0-7, k 8-15), (m 8-15, k 8-15); m is the shifted voxel
            unsigned a[4];
            ldsm_x4(hs + swz64(hrow[i] + tap_row + kw, kk / 8 + (mat >> 1)),
                    a);
            if constexpr (PHASE == kPhaseFrag) {
              chk ^= a[0] ^ a[1] ^ a[2] ^ a[3];
            } else {
#pragma unroll
              for (int j = 0; j < NT; ++j)
                mma_bf16(acc[i][j], a, bf[j][0], bf[j][1]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if constexpr (PHASE != kPhaseFull) {
    // a cut rung: one value a thread, at voxel tid of the box, channel n0
    if constexpr (PHASE == kPhaseMma) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) sum += acc[i][j][q];
      chk = __float_as_uint(sum);
    }
    const int gd = z0 + tid / (kTH * Bx::TW), gh = y0 + tid / Bx::TW % kTH,
              gw = x0 + tid % Bx::TW;
    if (gd < D && gh < H && gw < W && n0 < F)
      y[((((long long)b * D + gd) * H + gh) * W + gw) * F + n0] =
          __float2bfloat16_rn(__uint_as_float(chk));
    return;
  }

  // accumulator (row l / 4 [+ 8], columns 2 (l % 4) + {0, 1}) as bf16 pairs
  const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int v = (warp * MT + i) * 16 + g + 8 * half;
      const int gd = z0 + v / (kTH * Bx::TW);
      const int gh = y0 + (v / Bx::TW) % kTH;
      const int gw = x0 + v % Bx::TW;
      if (gd >= D || gh >= H || gw >= W) continue;
      bf16* yr = y + ((((long long)b * D + gd) * H + gh) * W + gw) * F;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int f = n0 + j * 8 + c2;
        if (f < F)
          *reinterpret_cast<__nv_bfloat162*>(yr + f) = __floats2bfloat162_rn(
              acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

template <int BN, int MT, int PHASE = kPhaseFull>
int launch_fwd_tc(const void* x, const void* wpk, void* y, int B, int D,
                  int H, int W, int C, int F, cudaStream_t st) {
  using Bx = Box<MT>;
  CUtensorMap map;
  const long long n[5] = {C, W, H, D, B};
  const unsigned box[5] = {kCc, Bx::HW, Bx::HH, Bx::HD, 1};
  if (!encode_map(&map, x, 5, n, box)) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BN, MT>();
  auto kernel = conv3d_tc_same_fwd_kernel<BN, MT, PHASE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_d = (D + kTD - 1) / kTD, tiles_h = (H + kTH - 1) / kTH,
            tiles_w = (W + Bx::TW - 1) / Bx::TW;
  const long long tiles = (long long)B * tiles_d * tiles_h * tiles_w;
  const dim3 grid((unsigned)tiles, (unsigned)((F + BN - 1) / BN));
  kernel<<<grid, kThreads, smem, st>>>(map, static_cast<const bf16*>(wpk),
                                       static_cast<bf16*>(y), D, H, W, F,
                                       (C + kCc - 1) / kCc, tiles_d, tiles_h,
                                       tiles_w);
  return (int)cudaGetLastError();
}

// The forward at tile (32, MT) cut after ``phase`` (kPhaseCopy..kPhaseFull)
template <int MT>
int launch_ladder(int phase, const void* x, const void* wpk, void* y, int B,
                  int D, int H, int W, int C, int F, cudaStream_t st) {
  if (phase == kPhaseCopy)
    return launch_fwd_tc<32, MT, kPhaseCopy>(x, wpk, y, B, D, H, W, C, F, st);
  if (phase == kPhaseFrag)
    return launch_fwd_tc<32, MT, kPhaseFrag>(x, wpk, y, B, D, H, W, C, F, st);
  if (phase == kPhaseMma)
    return launch_fwd_tc<32, MT, kPhaseMma>(x, wpk, y, B, D, H, W, C, F, st);
  return launch_fwd_tc<32, MT>(x, wpk, y, B, D, H, W, C, F, st);
}

}  // namespace

// the fp32 rungs (conv3d_tf32.cu)
extern "C" int conv3d_same_fwd_tf32_ladder(const void* x, const void* w,
                                           void* wpk, void* y, int B, int D,
                                           int H, int W, int C, int F,
                                           int phase, int bn, void* stream);

// x [B, D, H, W, C] bf16, y [B, D, H, W, F] bf16; w torch's [F, C, 3, 3, 3]
// bf16, or with ``flip`` the forward weights [C, F, 3, 3, 3] of which this
// conv is the input gradient (flip_swap: taps reversed, in and out
// swapped); wpk bf16 scratch of ceil(F / bn) * ceil(C / 32) * 27 * 32 *
// (bn + 8) values, which a first kernel fills with the packed weights
// ([F tile][32-channel chunk][kd, kh, kw][32][bn + 8], zeros past C, F and
// bn).  bn 32, 64, 96 or 128.  Needs C % 8 == 0, F % 8 == 0 and 16-byte
// aligned x, wpk and y.
extern "C" int conv3d_same_fwd_tc(const void* x, const void* w, void* wpk,
                                  void* y, int B, int D, int H, int W, int C,
                                  int F, int bn, int flip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 != 0 || F % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)wpk % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      (bn != 32 && bn != 64 && bn != 96 && bn != 128))
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, flip, st);
  if (err != 0) return err;
  // 512-voxel tiles where they fill the card twice over, else 256
  const long long big_tiles = (long long)B * ((D + kTD - 1) / kTD) *
                              ((H + kTH - 1) / kTH) * ((W + 15) / 16) *
                              ((F + bn - 1) / bn);
  const bool big = big_tiles >= 2 * kSMs;
  if (bn == 32 && big)
    return launch_fwd_tc<32, 4>(x, wpk, y, B, D, H, W, C, F, st);
  if (bn == 32) return launch_fwd_tc<32, 2>(x, wpk, y, B, D, H, W, C, F, st);
  if (bn == 64 && big)
    return launch_fwd_tc<64, 4>(x, wpk, y, B, D, H, W, C, F, st);
  if (bn == 64) return launch_fwd_tc<64, 2>(x, wpk, y, B, D, H, W, C, F, st);
  if (bn == 96) return launch_fwd_tc<96, 2>(x, wpk, y, B, D, H, W, C, F, st);
  return launch_fwd_tc<128, 2>(x, wpk, y, B, D, H, W, C, F, st);
}

// The phase ladder: the production 3^3 forward of ``dtype`` (1 bf16:
// conv3d_same_fwd_tc's kernel; 0 fp32: conv3d_same_fwd_tf32's unfused
// kernel) on x with torch weights w (not flipped), packing into wpk as the
// production entry does, then cut after ``phase`` (0 the packing alone, 1
// copy, 2 frag, 3 mma, 4 full) at tile (bn, mt): bf16 (32, 4) or (32, 2),
// fp32 (32, 4) or (64, 2).  ``full`` at the tile the production entry picks
// is the very launch conv3d_same makes.  The production entries' argument
// rules.
extern "C" int conv3d_same_fwd_ladder(const void* x, const void* w,
                                      void* wpk, void* y, int dtype, int B,
                                      int D, int H, int W, int C, int F,
                                      int phase, int bn, int mt,
                                      void* stream) {
  if (phase < kPhasePack || phase > kPhaseFull)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if ((bn == 32) != (mt == 4) || (bn != 32 && bn != 64))
      return (int)cudaErrorInvalidValue;
    return conv3d_same_fwd_tf32_ladder(x, w, wpk, y, B, D, H, W, C, F, phase,
                                       bn, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || bn != 32 || (mt != 2 && mt != 4) || C % 8 != 0 ||
      F % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)wpk % 16 != 0 ||
      (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, 0, st);
  if (err != 0 || phase == kPhasePack) return err;
  if (mt == 4)
    return launch_ladder<4>(phase, x, wpk, y, B, D, H, W, C, F, st);
  return launch_ladder<2>(phase, x, wpk, y, B, D, H, W, C, F, st);
}

// Stride-1, zero-pad-1, 3x3x3 convolution in fp32 on Hopper's TF32 tensor
// cores (sm_90a), error-compensated to fp32 accuracy (3xTF32):
// conv3d_same_fwd_tf32 (the forward, and on flip-swapped weights the input
// gradient) and conv3d_same_na_fwd_tf32 (the fused preact conv's forward,
// y = conv3d_same(act((x - mean[b, c]) * rstd[b, c]))).  One kernel
// template serves both; the weight gradients are conv3d_wgrad_tf32.cu and
// conv3d_wgrad_na_tf32.cu, and widths that
// are not multiples of 8 take the CUDA-core kernels of conv3d.cu.
//
// Replaces, in fp32, the Pallas TPU kernels of
// cbim_tpu/ops/pallas/conv3d.py conv3d_same / _conv3d_same_pallas
// (:299, :372), the dgrad of its VJP conv3d_same_t (the forward kernel on
// _flip_swap'd weights), and conv3d_same_cw_na (:1387; the norm-act on the
// raw halo tile in VMEM, _na_apply with _halo_valid_mask):
//   y[b, d, h, w, f] = sum_{kd, kh, kw, c} xn[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                        * w[kd, kh, kw, c, f],
// xn = x (or its norm-act in fp32), zeros outside the volume, fp32 x, w, y.
//
// What bounds it on the H100: operations.  2 * 27 * C * F FLOPs per voxel,
// 0.70 TFLOP at (2, 128^3, 96 -> 32), three times over on the TF32 tensor
// cores: 4.2 ms at 495 TFLOP/s, against 10.4 ms at the 67 TFLOP/s fp32
// FMA rate of the CUDA cores and 0.6 ms for the bytes (x, w, y at 3.35
// TB/s).  Beside the MMAs, the split (below) and, fused, the norm-act run
// on the CUDA cores and compete with mma.sync for issue slots.
//
// What the design does about it:
// - 3xTF32.  TF32 keeps 10 mantissa bits.  Each operand is split into
//   hi = tf32(v) and lo = tf32(v - hi) (split_tf32: round to nearest,
//   ties away from zero; a NaN stays in hi) and
//   y = x_lo w_hi + x_hi w_lo + x_hi w_hi, three
//   mma.sync.m16n8k8 TF32 products into fp32 accumulators (the dropped
//   x_lo w_lo is 2^-22 of x w).  The weights are split once, by the
//   packing kernel, into two planes; x is split in registers after each
//   A-fragment ldmatrix (seven integer and fp32 ops a value, reused across
//   the BN/8 n tiles): splitting it in shared memory would double the halo.
// - Accumulation.  The tensor cores add into their fp32 accumulators by
//   truncation, which over a whole tile (27 C products, three passes)
//   erred by more than twice cuDNN's fp32 sums on the H100.  So each
//   (kd, kh) step (3 taps x 16 channels, three passes) is summed in fresh
//   accumulators, its first MMA taking zeros for C, and folded into the
//   tile's sums with fp32 adds (round to nearest).
// - conv3d_tc.cu's implicit GEMM on a TMA halo box per output tile (the
//   (4, 8, 4 MT) output box; the halo as one 5D TMA box per chunk, its
//   zero fill the SAME padding, the ragged edge and the channels past C)
//   and conv3d_na_tc.cu's persistent walk over (tile, chunk) items: as
//   many blocks as fit the card, two halo stages (item i + 1's halo lands
//   while item i is multiplied) and three weight stages on mbarriers, one
//   thread starting every copy.
// - A chunk is 16 fp32 channels: 64-byte rows with the 64-byte swizzle, so
//   the halo box and its byte counts are the bf16 kernels' (a 32-channel
//   fp32 halo at MT = 4 would take 138 KB a stage).  Non-transposed
//   ldmatrix on 32-bit values gives the TF32 A fragment (row l / 4, column
//   l % 4); the weights are packed [n][k] (k contiguous, rows padded to 80
//   bytes), so the same load gives the B fragment conflict-free.
// - The tiles: BN = 32 output channels with MT = 4 (512-voxel boxes) or
//   BN = 64 with MT = 2 (256 voxels), so the two sets of accumulators stay
//   at 128 registers; two weight planes x three stages fit beside two halo
//   stages (182 or 167 KB).
// - Fused (ACT != kNoNorm): each landed halo stage is normalised once in
//   shared memory in fp32 (na_halo.cuh: rows outside the volume and
//   channels past C stay at TMA's zeros; a proxy fence before the refill
//   barrier), a slice of rows in each of the steps kNaFirstStep..8 of the
//   item before, beside its MMAs; the split follows the normalisation.
// Needs C % 8 == 0 and F % 8 == 0 (the route's width rule; TMA needs 16-
// byte strides).
//
// The phase ladder's fp32 rungs (conv3d_same_fwd_ladder, see conv3d_tc.cu):
// the unfused kernel (ACT = kNoNorm) cut after a phase, PHASE =
//   kPhaseCopy: the halo TMA boxes and the weight bulk copies land, with
//               the mbarrier waits and step barriers; nothing is read from
//               the stages;
//   kPhaseFrag: plus the ldmatrix A and B fragments (hi and lo planes of
//               the weights) and the split of A into TF32 hi and lo
//               (split_tf32), each thread XORing them into its one value;
//   kPhaseMma:  plus the three TF32 mma.sync passes and the per-(kd, kh)
//               fold into the tile's sums (each thread sums them at the
//               end of each tile);
//   kPhaseFull: plus the epilogue: the very instantiation
//               conv3d_same_fwd_tf32 launches (the default; if constexpr
//               only, so the cut costs production nothing).
// The fused instantiations are not cut.  The tiles are the production
// picker's two: (32, MT 4) and (64, MT 2).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "na_halo.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCk = 16;          // fp32 channels of a staged chunk (64 bytes)
constexpr int kTD = 4, kTH = 8;  // output box (d, h); its w is 4 * MT
constexpr int kHaloStages = 2, kWStages = 3;
// the first step (kd, kh) of an item in which the fused kernel normalises
// the next item's halo (the steps before it leave its TMA copy time to land)
constexpr int kNaFirstStep = 3;

// The (kTD, kTH, 4 MT) output box and its halo (one voxel more on each
// side): HD x HH x HW rows of kCk fp32 channels, one 1024-byte aligned
// stage.
template <int MT>
struct Box {
  static constexpr int TW = 4 * MT;
  static constexpr int HD = kTD + 2, HH = kTH + 2, HW = TW + 2;
  static constexpr int rows = HD * HH * HW;
  static constexpr int bytes = rows * kCk * 4;
  static constexpr int stage = (bytes + 1023) / 1024 * 1024;
};

// One (chunk, kd, kh) step of packed weights: two parts (hi, lo), each 3 kw
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
  return kHaloStages * Box<MT>::stage + kWStages * WTile<BN>::bytes +
         8 * (kHaloStages + kWStages) + 1024;
}

// The fused kernel's norm-act pass over one halo stage: ``passes`` of 64
// rows (a multiple of 8: each thread keeps its physical chunk),
// ``per_step`` of them in each of the steps kNaFirstStep..8.
template <int MT>
struct NaPlan {
  static constexpr int rows_per_pass = kThreads / 4;
  static constexpr int passes =
      (Box<MT>::rows + rows_per_pass - 1) / rows_per_pass;
  static constexpr int per_step =
      (passes + 9 - kNaFirstStep - 1) / (9 - kNaFirstStep);
  static_assert(rows_per_pass % 8 == 0, "pass plan");
};

// The weights in the kernel's layout: wpk[n tile][chunk][kd, kh][part]
// [kw][n][k] (kCk + 4 values a row; part 0 hi, 1 lo) from torch's
// w[F][C][27]; with ``flip`` w is the forward's [C][F][27] and the packing
// is flip_swap's (the dgrad's weights: taps reversed, in and out swapped).
// Zeros past C, F and kCk.
__global__ void __launch_bounds__(256)
conv3d_tf32_pack_kernel(const float* __restrict__ w, float* __restrict__ wpk,
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
    const int tap = (int)(r % 9) * 3 + kw;
    r /= 9;
    const int c = (int)(r % n_chunks) * kCk + k;
    const int f = (int)(r / n_chunks) * bn + n;
    float v = 0.f;
    if (k < kCk && c < C && f < F)
      v = flip ? w[((long long)c * F + f) * 27 + 26 - tap]
               : w[((long long)f * C + c) * 27 + tap];
    unsigned hi, lo;
    split_tf32(__float_as_uint(v), hi, lo);
    wpk[e] = __uint_as_float(part == 0 ? hi : lo);
  }
}

// the ladder's rungs (conv3d_tc.cu; 0: the weight packing alone)
constexpr int kPhasePack = 0, kPhaseCopy = 1, kPhaseFrag = 2, kPhaseMma = 3,
              kPhaseFull = 4;

template <int BN, int MT, int ACT, int PHASE = kPhaseFull>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_tf32_same_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                            const float* __restrict__ wpk,
                            float* __restrict__ y,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd, int D, int H,
                            int W, int C, int F, int n_chunks, int tiles_d,
                            int tiles_h, int tiles_w, int n_tiles) {
  using Bx = Box<MT>;
  using Wt = WTile<BN>;
  using Pl = NaPlan<MT>;
  constexpr int NT = BN / 8;  // n8 tiles
  constexpr bool kNa = ACT != kNoNorm;
  static_assert(PHASE == kPhaseFull || !kNa, "the ladder cuts kNoNorm only");
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzle pattern is read from the address bits
  const unsigned raw = smem_u32(smem_raw);
  const unsigned halo0 = (raw + 1023) & ~1023u;
  const unsigned wts0 = halo0 + kHaloStages * Bx::stage;
  const unsigned bar0 = wts0 + kWStages * Wt::bytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row
  const int n0 = blockIdx.y * BN;
  const int items =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      n_chunks;
  const int steps = items * 9;
  const float* wblk = wpk + (long long)blockIdx.y * n_chunks * 9 * Wt::elems;

  // item i: chunk i % n_chunks of tile blockIdx.x + (i / n_chunks) gridDim.x,
  // whose sample and first output voxel are (b, z0, y0, x0)
  auto tile_of = [&](int i, int& b, int& z0, int& y0, int& x0) {
    int t = blockIdx.x + i / n_chunks * gridDim.x;
    x0 = t % tiles_w * Bx::TW;
    t /= tiles_w;
    y0 = t % tiles_h * kTH;
    t /= tiles_h;
    z0 = t % tiles_d * kTD;
    b = t / tiles_d;
  };
  auto load_halo = [&](int i) {
    int b, z0, y0, x0;
    tile_of(i, b, z0, y0, x0);
    const int st = i % kHaloStages;
    const unsigned bar = bar0 + 8 * st;
    mbar_expect_tx(bar, Bx::bytes);
    tma_load_5d(halo0 + st * Bx::stage, &xmap, bar, i % n_chunks * kCk,
                x0 - 1, y0 - 1, z0 - 1, b);
  };
  // step s: (kd, kh) = s % 9 of item s / 9
  auto load_w = [&](int s) {
    const int st = s % kWStages;
    const unsigned bar = bar0 + 8 * (kHaloStages + st);
    mbar_expect_tx(bar, Wt::bytes);
    bulk_load(wts0 + st * Wt::bytes,
              wblk + (long long)(s / 9 % n_chunks * 9 + s % 9) * Wt::elems,
              Wt::bytes, bar);
  };

  // The fused kernel's norm-act pass of item na_i: this thread's logical
  // chunk j (channels j * 4.. of the item's chunk) of halo rows tid / 4 +
  // 64 q; (nz, ny, nx) is the halo's first voxel, nm, nr the 4 channels'
  // statistics.
  const int j = tid % 4;
  int na_i = 0, nz = 0, ny = 0, nx = 0;
  bool na_ch = false;
  float nm[4] = {0.f, 0.f, 0.f, 0.f}, nr[4] = {0.f, 0.f, 0.f, 0.f};
  auto na_begin = [&](int i) {
    int b;
    tile_of(i, b, nz, ny, nx);
    nz -= 1;
    ny -= 1;
    nx -= 1;
    na_i = i;
    const int c = i % n_chunks * kCk + j * 4;
    na_ch = c < C;
    if (na_ch) {
      load_vec<float, 4>(mean + (long long)b * C + c, nm);
      load_vec<float, 4>(rstd + (long long)b * C + c, nr);
    }
    mbar_wait(bar0 + 8 * (i % kHaloStages), (i / kHaloStages) & 1);
  };
  auto na_ld = [&](int q) {
    return na_load<Bx::HH, Bx::HW>(halo0 + (na_i % kHaloStages) * Bx::stage,
                                   tid / 4 + q * Pl::rows_per_pass, Bx::rows,
                                   j, na_ch, nz, ny, nx, D, H, W);
  };

  if (tid == 0) {
    for (int i = 0; i < kHaloStages + kWStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_halo(0);
    if (items > 1) load_halo(1);
    load_w(0);
    if (steps > 1) load_w(1);
  }
  if constexpr (kNa) {
    // the first item's halo before any step; every later one in the item
    // before it
    na_begin(0);
    for (int q = 0; q < Pl::passes; ++q) na_store_f32<ACT>(na_ld(q), nm, nr);
    fence_proxy_async();
    __syncthreads();
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

  // acc: the tile's sums (fp32 adds); part: the current step's (MMAs)
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.f;
  unsigned chk = 0;  // a cut rung's one stored value

  for (int s = 0; s < steps; ++s) {
    const int it = s / 9, kdh = s % 9;
    if (tid == 0) {
      // the slots refilled here were last read in an earlier step, which
      // every thread has left (the barrier at its end); in the fused kernel
      // every thread fenced its norm-act writes to the halo slot before
      // that barrier
      fence_proxy_async();
      if (s + 2 < steps) load_w(s + 2);
      if (kdh == 0 && it >= 1 && it + 1 < items) load_halo(it + 1);
    }
    bool na_next = false;
    if constexpr (kNa) {
      na_next = it + 1 < items && kdh >= kNaFirstStep;
      if (na_next && kdh == kNaFirstStep) na_begin(it + 1);
    } else if (kdh == 0) {
      mbar_wait(bar0 + 8 * (it % kHaloStages), (it / kHaloStages) & 1);
    }
    mbar_wait(bar0 + 8 * (kHaloStages + s % kWStages), (s / kWStages) & 1);
    const unsigned hs = halo0 + (it % kHaloStages) * Bx::stage;
    const unsigned ws = wts0 + (s % kWStages) * Wt::bytes;
    const int tap_row = ((kdh / 3) * Bx::HH + kdh % 3) * Bx::HW;
    // the MMAs of tap kw of this (kd, kh) step; the step's first ones start
    // ``part`` from zeros
    auto mma_kw = [&](int kw) {
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
          if constexpr (PHASE == kPhaseFrag)
            chk ^= q[0] ^ q[1] ^ q[2] ^ q[3];
          ldsm_x4(at + Wt::part * 4, q);
          bl[jn][0] = q[0];
          bl[jn][1] = q[1];
          bl[jn + 1][0] = q[2];
          bl[jn + 1][1] = q[3];
          if constexpr (PHASE == kPhaseFrag)
            chk ^= q[0] ^ q[1] ^ q[2] ^ q[3];
        }
        // A fragments, split: matrices (m 0-7, k 0-3), (m 8-15, k 0-3),
        // (m 0-7, k 4-7), (m 8-15, k 4-7); m is the shifted voxel
        unsigned ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4];
          ldsm_x4(hs + swz64(hrow[i] + tap_row + kw, kk / 4 + (mat >> 1)), a);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            split_tf32(a[q], ah[i][q], al[i][q]);
            if constexpr (PHASE == kPhaseFrag) chk ^= ah[i][q] ^ al[i][q];
          }
        }
        if constexpr (PHASE == kPhaseFrag) continue;
        // the small products first, then the large one
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            if (kw == 0 && kk == 0)
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
    };
    if (kNa && na_next) {
      // the step's passes over the next item's halo: loaded before the
      // MMAs, normalised beside them, stored after them
      const int q0 = (kdh - kNaFirstStep) * Pl::per_step;
      NaChunk c[Pl::per_step];
#pragma unroll
      for (int u = 0; u < Pl::per_step; ++u) c[u] = na_ld(q0 + u);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) mma_kw(kw);
#pragma unroll
      for (int u = 0; u < Pl::per_step; ++u) na_store_f32<ACT>(c[u], nm, nr);
    } else if constexpr (PHASE == kPhaseCopy) {
      chk += s;
    } else {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) mma_kw(kw);
    }
    // the step's sums into the tile's, in fp32
    if constexpr (PHASE >= kPhaseMma) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][jn][q] += part[i][jn][q];
    }
    if (kNa && na_next && kdh == 8) fence_proxy_async();
    __syncthreads();
    if (kdh < 8 || it % n_chunks != n_chunks - 1) continue;
    if constexpr (PHASE == kPhaseMma) {
      // a cut rung's tile end: its sums into the one value, then zeros
      float sum = __uint_as_float(chk);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sum += acc[i][jn][q];
            acc[i][jn][q] = 0.f;
          }
      chk = __float_as_uint(sum);
    }
    if constexpr (PHASE != kPhaseFull) continue;

    // the tile's last chunk: accumulator (row l / 4 [+ 8], columns
    // 2 (l % 4) + {0, 1}) as fp32 pairs, then zeros for the next tile
    int b, z0, y0, x0;
    tile_of(it, b, z0, y0, x0);
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
        float* yr = y + ((((long long)b * D + gd) * H + gh) * W + gw) * F;
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

  if constexpr (PHASE != kPhaseFull) {
    // a cut rung: one value a thread, at voxel tid of the block's first
    // box, channel n0
    int b, z0, y0, x0;
    tile_of(0, b, z0, y0, x0);
    const int gd = z0 + tid / (kTH * Bx::TW), gh = y0 + tid / Bx::TW % kTH,
              gw = x0 + tid % Bx::TW;
    if (gd < D && gh < H && gw < W && n0 < F)
      y[((((long long)b * D + gd) * H + gh) * W + gw) * F + n0] =
          __uint_as_float(chk);
  }
}

inline int pack_weights(const void* w, void* wpk, int C, int F, int bn,
                        int flip, cudaStream_t st) {
  const int n_chunks = (C + kCk - 1) / kCk;
  const long long total = (long long)((F + bn - 1) / bn) * n_chunks * 9 *
                          2 * 3 * bn * (kCk + 4);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  conv3d_tf32_pack_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<float*>(wpk), C, F, bn,
      n_chunks, flip, total);
  return (int)cudaGetLastError();
}

template <int BN, int MT, int ACT, int PHASE = kPhaseFull>
int launch_fwd_tf32(const void* x, const void* wpk, void* y,
                    const float* mean, const float* rstd, int B, int D,
                    int H, int W, int C, int F, cudaStream_t st) {
  using Bx = Box<MT>;
  CUtensorMap map;
  const long long n[5] = {C, W, H, D, B};
  const unsigned box[5] = {kCk, Bx::HW, Bx::HH, Bx::HD, 1};
  if (!encode_map(&map, x, 5, n, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BN, MT>();
  auto kernel = conv3d_tf32_same_fwd_kernel<BN, MT, ACT, PHASE>;
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
  const int tiles_d = (D + kTD - 1) / kTD, tiles_h = (H + kTH - 1) / kTH,
            tiles_w = (W + Bx::TW - 1) / Bx::TW;
  const long long n_tiles = (long long)B * tiles_d * tiles_h * tiles_w;
  const int n_chunks = (C + kCk - 1) / kCk;
  if (n_tiles * n_chunks >= (1LL << 31) / 9 || per_sm < 1)
    return (int)cudaErrorInvalidValue;
  // one block for every slot the card has, spread over the F tiles
  const int n_f = (F + BN - 1) / BN;
  long long blocks = (long long)sms * per_sm / n_f;
  if (blocks < 1) blocks = 1;
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_f), kThreads, smem, st>>>(
      map, static_cast<const float*>(wpk), static_cast<float*>(y), mean, rstd,
      D, H, W, C, F, n_chunks, tiles_d, tiles_h, tiles_w, (int)n_tiles);
  return (int)cudaGetLastError();
}

// BN = 32 with 512-voxel boxes, BN = 64 with 256-voxel ones
template <int ACT>
int launch_bn(int bn, const void* x, const void* wpk, void* y,
              const float* mean, const float* rstd, int B, int D, int H,
              int W, int C, int F, cudaStream_t st) {
  if (bn == 32)
    return launch_fwd_tf32<32, 4, ACT>(x, wpk, y, mean, rstd, B, D, H, W, C,
                                       F, st);
  return launch_fwd_tf32<64, 2, ACT>(x, wpk, y, mean, rstd, B, D, H, W, C, F,
                                     st);
}

// The unfused forward at tile (BN, MT) cut after ``phase`` (kPhaseCopy..
// kPhaseFull)
template <int BN, int MT>
int launch_ladder(int phase, const void* x, const void* wpk, void* y, int B,
                  int D, int H, int W, int C, int F, cudaStream_t st) {
  if (phase == kPhaseCopy)
    return launch_fwd_tf32<BN, MT, kNoNorm, kPhaseCopy>(
        x, wpk, y, nullptr, nullptr, B, D, H, W, C, F, st);
  if (phase == kPhaseFrag)
    return launch_fwd_tf32<BN, MT, kNoNorm, kPhaseFrag>(
        x, wpk, y, nullptr, nullptr, B, D, H, W, C, F, st);
  if (phase == kPhaseMma)
    return launch_fwd_tf32<BN, MT, kNoNorm, kPhaseMma>(
        x, wpk, y, nullptr, nullptr, B, D, H, W, C, F, st);
  return launch_fwd_tf32<BN, MT, kNoNorm>(x, wpk, y, nullptr, nullptr, B, D,
                                          H, W, C, F, st);
}

bool takes(int C, int F, int bn, const void* x, const void* wpk,
           const void* y) {
  return C % 8 == 0 && F % 8 == 0 && (uintptr_t)x % 16 == 0 &&
         (uintptr_t)wpk % 16 == 0 && (uintptr_t)y % 16 == 0 &&
         (bn == 32 || bn == 64);
}

}  // namespace

// x [B, D, H, W, C] fp32, y [B, D, H, W, F] fp32; w torch's [F, C, 3, 3, 3]
// fp32, or with ``flip`` the forward weights [C, F, 3, 3, 3] of which this
// conv is the input gradient (flip_swap: taps reversed, in and out
// swapped); wpk fp32 scratch of ceil(F / bn) * ceil(C / 16) * 9 * 2 * 3 *
// bn * 20 values, which a first kernel fills with the packed, split weights
// ([F tile][16-channel chunk][kd, kh][hi, lo][kw][bn][20], zeros past C, F
// and 16).  bn 32 or 64.  Needs C % 8 == 0, F % 8 == 0 and 16-byte aligned
// x, wpk and y.
extern "C" int conv3d_same_fwd_tf32(const void* x, const void* w, void* wpk,
                                    void* y, int B, int D, int H, int W,
                                    int C, int F, int bn, int flip,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes(C, F, bn, x, wpk, y)) return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, flip, st);
  if (err != 0) return err;
  return launch_bn<kNoNorm>(bn, x, wpk, y, nullptr, nullptr, B, D, H, W, C,
                            F, st);
}

// conv3d_same_fwd_tf32 (not flipped) cut after ``phase`` (0 the weight
// packing alone, 1 copy, 2 frag, 3 mma, 4 full) at tile bn (32: MT 4; 64:
// MT 2): the fp32 rungs of conv3d_same_fwd_ladder (conv3d_tc.cu).
extern "C" int conv3d_same_fwd_tf32_ladder(const void* x, const void* w,
                                           void* wpk, void* y, int B, int D,
                                           int H, int W, int C, int F,
                                           int phase, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes(C, F, bn, x, wpk, y) || phase < kPhasePack ||
      phase > kPhaseFull)
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, 0, st);
  if (err != 0 || phase == kPhasePack) return err;
  if (bn == 32)
    return launch_ladder<32, 4>(phase, x, wpk, y, B, D, H, W, C, F, st);
  return launch_ladder<64, 2>(phase, x, wpk, y, B, D, H, W, C, F, st);
}

// conv3d_same_fwd_tf32 of act((x - mean) * rstd): mean and rstd fp32 [B, C]
// (16-byte aligned); act 0 none, 1 relu, 2 gelu (exact erf); the normalised
// input stays fp32.
extern "C" int conv3d_same_na_fwd_tf32(const void* x, const void* w,
                                       void* wpk, void* y, const void* mean,
                                       const void* rstd, int act, int B,
                                       int D, int H, int W, int C, int F,
                                       int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes(C, F, bn, x, wpk, y) || (uintptr_t)mean % 16 != 0 ||
      (uintptr_t)rstd % 16 != 0 || act < kActNone || act > kActGelu)
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, 0, st);
  if (err != 0) return err;
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if (act == kActRelu)
    return launch_bn<kActRelu>(bn, x, wpk, y, m, r, B, D, H, W, C, F, st);
  if (act == kActGelu)
    return launch_bn<kActGelu>(bn, x, wpk, y, m, r, B, D, H, W, C, F, st);
  return launch_bn<kActNone>(bn, x, wpk, y, m, r, B, D, H, W, C, F, st);
}

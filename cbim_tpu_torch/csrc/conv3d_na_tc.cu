// The fused preact conv's forward on Hopper's bf16 tensor cores (sm_90a):
// conv3d_same_na_fwd_tc,
//   y = conv3d_same(act((x - mean[b, c]) * rstd[b, c])),
// bf16 x and w, fp32 mean and rstd [B, C], the normalised input rounded to
// bf16 once (as the unfused inorm_apply stores it), fp32 sums, y rounded
// once to bf16; zero padding applies to the normalised input.  Its weight
// gradient is conv3d_wgrad_na_tc.cu; the CUDA-core fused kernels (fp32,
// widths that are not multiples of 8) stay in conv3d.cu and
// conv3d_wgrad_na.cu.
//
// Replaces the Pallas TPU kernel conv3d_same_cw_na of
// cbim_tpu/ops/pallas/conv3d.py (_conv_kernel_cw_na: the norm-act applied
// to the raw halo tile in VMEM, _na_apply with _halo_valid_mask) in bf16.
//
// What bounds it on the H100: operations.  2 * 27 * C * F FLOPs per voxel
// on the tensor cores (0.70 ms at (2, 128^3, 96 -> 32) at 989 TFLOP/s),
// and beside them the norm-act on the CUDA cores: about 2.1 (512-voxel
// boxes) or 2.3 (256-voxel) normalisations of each input value per F tile,
// each some 25 instructions with the exact-erf GELU.  At F = 32 that is
// about as many issue slots as the MMAs it feeds; the bytes (x, w, y) take
// 0.10 ms at 3.35 TB/s.
//
// What the design does about it: conv3d_tc.cu's implicit GEMM (the
// (4, 8, 4 MT) output box, one 5D TMA halo box per 32-channel chunk, the
// packed weights by one bulk copy per (chunk, kd, kh) step, mma.sync
// m16n8k16 with fp32 accumulators across all taps and chunks), plus a
// norm-act pass over each landed halo stage (na_halo.cuh), overlapped with
// the MMAs:
// - Persistent blocks (as many as fit the card) each walk a list of items,
//   one item = (output tile, 32-channel chunk), tiles blockIdx.x +
//   k * gridDim.x.  Two halo stages: while item i is multiplied from one,
//   item i + 1's raw halo lands in the other and is normalised there, a
//   slice of rows in each of steps (kd, kh) kNaFirstStep..8 of item i.  So
//   at C = 32 (one chunk a tile) too the next tile's halo is normalised
//   under the current tile's MMAs.  Only each block's first item is
//   normalised before any MMA.
// - Within a step every warp interleaves its slice with its MMAs: its
//   16-byte chunks are loaded before the step's MMAs and stored after
//   them, branch-free (a predicated store), so the compiler may schedule
//   the CUDA-core chains among the MMAs (a store between two taps' MMAs
//   would hold the next tap's ldmatrix behind it).  On the H100 the pass
//   still adds about its own issue time to the MMAs' (PERF.md §6): with
//   the exact-erf GELU it is the kernel's largest cost after the MMAs.
// - The stage holds raw x until its pass and normalised x after it: no
//   second copy, so the 512-voxel box keeps its two stages in 160-180 KB.
// - 8 warps: MT = 4 m16 tiles a warp (512-voxel boxes) at BN <= 64, MT = 2
//   at BN = 96, 128.
// Needs C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides).
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).

#include "conv3d_tc_common.cuh"
#include "na_halo.cuh"

namespace {

// the first step (kd, kh) of an item in which the block normalises the next
// item's halo (the steps before it leave its TMA copy time to land)
constexpr int kNaFirstStep = 2;

// The norm-act pass over one halo stage: ``passes`` of 64 rows (a multiple
// of 8: each thread keeps its physical chunk), ``per_step`` of them in each
// of the steps kNaFirstStep..8.
template <int MT>
struct NaPlan {
  static constexpr int rows_per_pass = kThreads / 4;
  static constexpr int passes =
      (Box<MT>::rows + rows_per_pass - 1) / rows_per_pass;
  static constexpr int per_step =
      (passes + 9 - kNaFirstStep - 1) / (9 - kNaFirstStep);
  static_assert(rows_per_pass % 8 == 0, "pass plan");
};

template <int BN, int MT, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_tc_na_same_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                             const bf16* __restrict__ wpk,
                             bf16* __restrict__ y,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd, int D, int H,
                             int W, int C, int F, int n_chunks, int tiles_d,
                             int tiles_h, int tiles_w, int n_tiles) {
  using Bx = Box<MT>;
  using Wt = WTile<BN>;
  using Pl = NaPlan<MT>;
  constexpr int NT = BN / 8;  // n8 tiles
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
  const bf16* wblk = wpk + (long long)blockIdx.y * n_chunks * 9 * Wt::elems;

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
    tma_load_5d(halo0 + st * Bx::stage, &xmap, bar, i % n_chunks * kCc,
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

  // The norm-act pass of item na_i: this thread's logical chunk j (channels
  // j * 8.. of the item's chunk) of halo rows tid / 4 + 64 q; (nz, ny, nx)
  // is the halo's first voxel, nm, nr the 8 channels' statistics.
  const int j = tid % 4;
  int na_i = 0, nz = 0, ny = 0, nx = 0;
  bool na_ch = false;
  float nm[8], nr[8];
  auto na_begin = [&](int i) {
    int b;
    tile_of(i, b, nz, ny, nx);
    nz -= 1;
    ny -= 1;
    nx -= 1;
    na_i = i;
    const int c = i % n_chunks * kCc + j * 8;
    na_ch = c < C;
    if (na_ch) na_stats(mean, rstd, (long long)b * C + c, nm, nr);
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
  // the first item's halo before any step; every later one in the item
  // before it
  na_begin(0);
  for (int q = 0; q < Pl::passes; ++q) na_store<ACT>(na_ld(q), nm, nr);
  fence_proxy_async();
  __syncthreads();

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
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int it = s / 9, kdh = s % 9;
    if (tid == 0) {
      // the slots refilled here were last read in an earlier step, which
      // every thread has left (the barrier at its end); every thread fenced
      // its norm-act writes to the halo slot before that barrier
      fence_proxy_async();
      if (s + 2 < steps) load_w(s + 2);
      if (kdh == 0 && it >= 1 && it + 1 < items) load_halo(it + 1);
    }
    const bool na_next = it + 1 < items && kdh >= kNaFirstStep;
    if (na_next && kdh == kNaFirstStep) na_begin(it + 1);
    mbar_wait(bar0 + 8 * (kHaloStages + s % kWStages), (s / kWStages) & 1);
    const unsigned hs = halo0 + (it % kHaloStages) * Bx::stage;
    const unsigned ws = wts0 + (s % kWStages) * Wt::bytes;
    const int tap_row = ((kdh / 3) * Bx::HH + kdh % 3) * Bx::HW;
    // the MMAs of tap kw of this (kd, kh) step
    auto mma_kw = [&](int kw) {
#pragma unroll
      for (int kk = 0; kk < kCc; kk += 16) {
        // B fragments of two n8 tiles per ldmatrix: matrices (k 0-7, n j),
        // (k 8-15, n j), (k 0-7, n j + 1), (k 8-15, n j + 1)
        unsigned bf[NT][2];
#pragma unroll
        for (int jn = 0; jn < NT; jn += 2) {
          unsigned q[4];
          ldsm_x4_t(ws + ((kw * kCc + kk + (mat & 1) * 8 + r8) * Wt::pitch +
                          (jn + (mat >> 1)) * 8) * 2,
                    q);
          bf[jn][0] = q[0];
          bf[jn][1] = q[1];
          bf[jn + 1][0] = q[2];
          bf[jn + 1][1] = q[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // A fragment: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
          // (m 0-7, k 8-15), (m 8-15, k 8-15); m is the shifted voxel
          unsigned a[4];
          ldsm_x4(hs + swz64(hrow[i] + tap_row + kw, kk / 8 + (mat >> 1)), a);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            mma_bf16(acc[i][jn], a, bf[jn][0], bf[jn][1]);
        }
      }
    };
    if (na_next) {
      // the step's passes over the next item's halo: loaded before the
      // MMAs, normalised beside them, stored after them
      const int q0 = (kdh - kNaFirstStep) * Pl::per_step;
      NaChunk c[Pl::per_step];
#pragma unroll
      for (int u = 0; u < Pl::per_step; ++u) c[u] = na_ld(q0 + u);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) mma_kw(kw);
#pragma unroll
      for (int u = 0; u < Pl::per_step; ++u) na_store<ACT>(c[u], nm, nr);
    } else {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) mma_kw(kw);
    }
    if (na_next && kdh == 8) fence_proxy_async();
    __syncthreads();
    if (kdh < 8 || it % n_chunks != n_chunks - 1) continue;

    // the tile's last chunk: accumulator (row l / 4 [+ 8], columns
    // 2 (l % 4) + {0, 1}) as bf16 pairs, then zeros for the next tile
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
        bf16* yr = y + ((((long long)b * D + gd) * H + gh) * W + gw) * F;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int f = n0 + jn * 8 + c2;
          if (f < F)
            *reinterpret_cast<__nv_bfloat162*>(yr + f) = __floats2bfloat162_rn(
                acc[i][jn][2 * half], acc[i][jn][2 * half + 1]);
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

template <int BN, int MT, int ACT>
int launch_na_fwd_tc(const void* x, const void* wpk, void* y,
                     const float* mean, const float* rstd, int B, int D,
                     int H, int W, int C, int F, cudaStream_t st) {
  using Bx = Box<MT>;
  CUtensorMap map;
  const long long n[5] = {C, W, H, D, B};
  const unsigned box[5] = {kCc, Bx::HW, Bx::HH, Bx::HD, 1};
  if (!encode_map(&map, x, 5, n, box)) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BN, MT>();
  auto kernel = conv3d_tc_na_same_fwd_kernel<BN, MT, ACT>;
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
  if (n_tiles >= (1LL << 31) / 9 || per_sm < 1)
    return (int)cudaErrorInvalidValue;
  // one block for every slot the card has, spread over the F tiles
  const int n_f = (F + BN - 1) / BN;
  long long blocks = (long long)sms * per_sm / n_f;
  if (blocks < 1) blocks = 1;
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_f), kThreads, smem, st>>>(
      map, static_cast<const bf16*>(wpk), static_cast<bf16*>(y), mean, rstd,
      D, H, W, C, F, (C + kCc - 1) / kCc, tiles_d, tiles_h, tiles_w,
      (int)n_tiles);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch_na_fwd_bn(int bn, const void* x, const void* wpk, void* y,
                     const float* mean, const float* rstd, int B, int D,
                     int H, int W, int C, int F, cudaStream_t st) {
  if (bn == 32)
    return launch_na_fwd_tc<32, 4, ACT>(x, wpk, y, mean, rstd, B, D, H, W, C,
                                        F, st);
  if (bn == 64)
    return launch_na_fwd_tc<64, 4, ACT>(x, wpk, y, mean, rstd, B, D, H, W, C,
                                        F, st);
  if (bn == 96)
    return launch_na_fwd_tc<96, 2, ACT>(x, wpk, y, mean, rstd, B, D, H, W, C,
                                        F, st);
  return launch_na_fwd_tc<128, 2, ACT>(x, wpk, y, mean, rstd, B, D, H, W, C,
                                       F, st);
}

}  // namespace

// conv3d_same_fwd_tc of act((x - mean) * rstd): x [B, D, H, W, C] bf16,
// w torch's [F, C, 3, 3, 3] bf16, y [B, D, H, W, F] bf16, mean and rstd
// fp32 [B, C]; act 0 none, 1 relu, 2 gelu (exact erf); wpk bf16 scratch of
// ceil(F / bn) * ceil(C / 32) * 27 * 32 * (bn + 8) values for the packed
// weights (conv3d_same_fwd_tc's layout).  bn 32, 64, 96 or 128.  Needs
// C % 8 == 0, F % 8 == 0 and 16-byte aligned x, wpk, y, mean and rstd.
extern "C" int conv3d_same_na_fwd_tc(const void* x, const void* w, void* wpk,
                                     void* y, const void* mean,
                                     const void* rstd, int act, int B, int D,
                                     int H, int W, int C, int F, int bn,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 != 0 || F % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)wpk % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      (uintptr_t)mean % 16 != 0 || (uintptr_t)rstd % 16 != 0 ||
      (bn != 32 && bn != 64 && bn != 96 && bn != 128) || act < kActNone ||
      act > kActGelu)
    return (int)cudaErrorInvalidValue;
  const int err = pack_weights(w, wpk, C, F, bn, 0, st);
  if (err != 0) return err;
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if (act == kActRelu)
    return launch_na_fwd_bn<kActRelu>(bn, x, wpk, y, m, r, B, D, H, W, C, F,
                                      st);
  if (act == kActGelu)
    return launch_na_fwd_bn<kActGelu>(bn, x, wpk, y, m, r, B, D, H, W, C, F,
                                      st);
  return launch_na_fwd_bn<kActNone>(bn, x, wpk, y, m, r, B, D, H, W, C, F,
                                    st);
}

// probe_gemm for Hopper (sm_90a): a bf16 GEMM on wgmma, fed by TMA,
// warp-specialised and persistent.  The port's first wgmma kernel.
//
// Replaces the Pallas TPU kernel of the JAX package's
// tools/probe_lhst_dot.py big_square (kern): the square calibration dot
//   out[t] = a[t] . b,  a [T, M, K] row-major, b [K, N] row-major (shared by
//   every t), fp32 sums, out [T, M, N] bf16.
// It lies on no serving or training path: it measures what a hand-written
// TMA -> wgmma pipeline reaches against cuBLAS on this card.
//
// What bounds it on the H100: operations.  At 64 x [1024, 1024] .
// [1024, 1024], 137 GFLOP at 989 TFLOP/s: 0.139 ms, against 0.27 GB of a,
// b and out (0.08 ms at 3.35 TB/s).
//
// What the design does about it:
// - wgmma.mma_async m64n256k16 (bf16 in, fp32 accumulators in registers),
//   the only instruction that reaches the tensor cores' full rate; both
//   operands read from shared memory through their matrix descriptors.
// - a is K-major, as it lies.  b stays [K][N] as stored (N-major) and is
//   read through wgmma's transpose-B immediate (16-bit types allow it): no
//   transpose pass.
// - A block tile of 128 x 256 outputs, K in steps of 64 (128-byte rows,
//   TMA's 128-byte swizzle, which the descriptors name): a stage is the a
//   tile (16 KB, one 2D TMA box) and the b tile (32 KB, four boxes of 64
//   columns), and four stages form a ring in 192 KB of shared memory, each
//   stage with a full and an empty mbarrier.
// - Three warpgroups.  Warpgroup 0 is the producer: one thread issues
//   every TMA copy, the warpgroup gives its registers away (setmaxnreg.dec
//   to 40).  Warpgroups 1 and 2 are the consumers (setmaxnreg.inc to 232):
//   each owns 64 rows of the tile, a 64 x 256 fp32 accumulator (128
//   registers a thread), and issues four wgmma a K step.  It keeps one
//   committed group in flight and releases a stage (one arrival a warp on
//   its empty barrier) once the group that read it has completed.
// - Persistent: one block a SM walks the T x (M / 128) x (N / 256) tiles,
//   the N tiles of one a panel consecutive, so the blocks that run side by
//   side share that panel in L2 (b, 2 MB, stays there).
// - Epilogue: the consumers round their sums to bf16 and store them as
//   16-byte rows (two shuffle transposes within each quad of lanes), while
//   the producer already loads the next tile's first stages.  Stored as
//   bf16 pairs the epilogue took a third of the kernel's time on the H100.
// Needs M % 128, N % 256 and K % 64 == 0, 16-byte aligned a, b and out.
// With ``store`` 0 the consumers skip the epilogue's stores (out is left
// unwritten; the sums are computed all the same): the mainloop's time.
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).

#include <limits.h>

#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 256, kBK = 64;  // block tile, K step
constexpr int kBoxN = 64;                      // b columns a TMA box (128 B)
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2;              // 16 KB
constexpr int kBBoxBytes = kBK * kBoxN * 2;         // 8 KB
constexpr int kStageBytes = kABytes + kBN / kBoxN * kBBoxBytes;  // 48 KB
constexpr int kThreads = 384;                       // 3 warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;

__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  bf16* __restrict__ out, int N, int tiles_n, int k_steps,
                  int n_tiles, int store) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzle pattern is read from the address bits
  const unsigned ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned full0 = ring + kStages * kStageBytes;
  const unsigned empty0 = full0 + 8 * kStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = tile % tiles_n * kBN;
        const int row0 = tile / tiles_n * kBM;  // of a's T * M rows
        for (int kb = 0; kb < k_steps; ++kb) {
          // a slot's first use passes at once (the phase before is done)
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const unsigned full = full0 + 8 * stage;
          const unsigned sa = ring + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(sa, &amap, full, kb * kBK, row0);
#pragma unroll
          for (int j = 0; j < kBN / kBoxN; ++j)
            tma_load_2d(sa + kABytes + j * kBBoxBytes, &bmap, full,
                        n0 + j * kBoxN, kb * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // a consumer: rows 64 (wg - 1).. of each tile
    setmaxnreg_inc<232>();
    const int rows = (wg - 1) * 64;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    float acc[128];
    int stage = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int last = 0;  // the stage of the step before
      for (int kb = 0; kb < k_steps; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const unsigned sa = ring + stage * kStageBytes + rows * kBK * 2;
        const unsigned sb = ring + stage * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
          wgmma_m64n256k16_bf16_tn(
              acc, wgmma_desc_sw128(sa + 32 * k, 16, 1024),
              wgmma_desc_sw128(sb + 16 * 128 * k, kBBoxBytes, 1024),
              kb > 0 || k > 0);
        wgmma_commit();
        if (kb > 0) {
          // the group of step kb - 1 is done: its stage may be refilled
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * last);
        }
        last = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * last);
      if (!store) continue;

      // The accumulator holds, of n8 block j, rows l / 4 and l / 4 + 8 at
      // columns 8j + 2 (l % 4) + {0, 1}.  A quad of lanes thus holds rows
      // g and g + 8 of 16 columns (blocks 2p, 2p + 1) as 16 bf16 pairs;
      // two 4 x 4 transposes of those words (shuffles across lanes ^ 2,
      // then ^ 1) give each lane 8 consecutive bf16 of one row, stored as
      // 16 bytes: a quarter of the stores of bf16 pairs, each a whole
      // 32-byte sector with its neighbour lane's.
      const int q = lane % 4;
      const bool b0 = q & 1, b1 = q & 2;
      const long long row = (long long)(tile / tiles_n * kBM + rows +
                                        warp * 16 + lane / 4 + (b0 ? 8 : 0));
      bf16* o = out + row * N + tile % tiles_n * kBN + (b1 ? 8 : 0);
#pragma unroll
      for (int p = 0; p < kBN / 16; ++p) {
        // a[i] is bound for quad lane i: bit 0 row + 8, bit 1 columns + 8
        unsigned a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 h = __floats2bfloat162_rn(acc[8 * p + 2 * i],
                                                   acc[8 * p + 2 * i + 1]);
          a[i] = *reinterpret_cast<unsigned*>(&h);
        }
        // across bit 1: keep the two words bound for this half of the quad
        const unsigned r0 = __shfl_xor_sync(~0u, b1 ? a[0] : a[2], 2);
        const unsigned r1 = __shfl_xor_sync(~0u, b1 ? a[1] : a[3], 2);
        const unsigned s0 = b1 ? a[2] : a[0], s1 = b1 ? a[3] : a[1];
        // across bit 0: keep the words bound for this lane
        const unsigned u0 = __shfl_xor_sync(~0u, b0 ? s0 : s1, 1);
        const unsigned u1 = __shfl_xor_sync(~0u, b0 ? r0 : r1, 1);
        const unsigned ks = b0 ? s1 : s0, kp = b0 ? r1 : r0;
        // the words by source lane q ^ d: d = 0 ks, 1 u0, 2 kp, 3 u1;
        // source lane s holds columns 2s, 2s + 1
        const unsigned x0 = b1 ? kp : ks, x1 = b1 ? u1 : u0;
        const unsigned y0 = b1 ? ks : kp, y1 = b1 ? u0 : u1;
        uint4 v;
        v.x = b0 ? x1 : x0;
        v.y = b0 ? x0 : x1;
        v.z = b0 ? y1 : y0;
        v.w = b0 ? y0 : y1;
        *reinterpret_cast<uint4*>(o + 16 * p) = v;
      }
    }
  }
}

}  // namespace

// out[t] (M x N) = a[t] . b: a [T, M, K], b [K, N], out [T, M, N], bf16,
// fp32 sums.  Needs M % 128, N % 256 and K % 64 == 0, T * M < 2^31, and
// a, b and out 16-byte aligned.  store 0: out is not written (the
// kernel's mainloop alone).
extern "C" int probe_gemm(const void* a, const void* b, void* out, int T,
                          int M, int N, int K, int store, void* stream) {
  if (T < 1 || M < kBM || N < kBN || K < kBK || M % kBM != 0 ||
      N % kBN != 0 || K % kBK != 0 || (long long)T * M > INT_MAX ||
      (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  const long long na[2] = {K, (long long)T * M};
  const unsigned boxa[2] = {kBK, kBM};
  const long long nb[2] = {N, K};
  const unsigned boxb[2] = {kBoxN, kBK};
  if (!encode_map(&amap, a, 2, na, boxa, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&bmap, b, 2, nb, boxb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long n_tiles = (long long)T * (M / kBM) * (N / kBN);
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(n_tiles < sms ? n_tiles : sms);
  gemm_wgmma_kernel<<<blocks, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, static_cast<bf16*>(out), N, N / kBN, K / kBK,
      (int)n_tiles, store);
  return (int)cudaGetLastError();
}

// probe_dot_t for Hopper (sm_90a): a bf16 dot that contracts dim 0 of both
// operands, on wgmma, fed by TMA, its output stored by TMA, warp-specialised
// and persistent.
//
// Replaces the Pallas TPU kernels of the JAX package's
// tools/probe_lhst_dot.py main (batched_kernel, slabloop_kernel): the 3^3
// conv's per-tile GEMM
//   out[t] (N x L) = W^T (N x K) . A[t] (K x L),  W [K, N], A [T, K, L],
//   fp32 sums, out [T, N, L] bf16.
// It lies on no serving or training path: it measures how close a
// hand-written dot of this shape comes to the card's memory rate.
//
// What bounds it on the H100: bytes.  At the TPU probe's shape (T 2048,
// K 96, N 288, L 2560) it reads A (1.007 GB) and writes out (3.020 GB):
// 1.202 ms at 3.35 TB/s, against 0.293 ms for its 290 GFLOP at 989
// TFLOP/s.  Three quarters of the bytes are output stores.
//
// What the design does about it:
// - The GEMM mapping.  wgmma's M is N (the rows of W^T), its N the L
//   columns of a tile, its K the contracted dim.  W is read as stored,
//   [K][N], through an MN-major A descriptor and the transpose-A
//   immediate; A[t] as stored, [K][L], through the transpose-B immediate
//   (16-bit types allow both).  Both land by TMA in boxes of 64 columns
//   (128 bytes, the 128-byte swizzle) by 96 rows of K.  In the
//   descriptors the stride offset is the 1-KB step between 8-row groups
//   of K, and the leading offset the 12-KB step between the two 64-column
//   boxes that make A's 128 columns.  A K step of 16 is +2 KB.  A K under
//   96 arrives zero-padded (rows past K are out of the maps), so the K
//   loop is always six steps, unrolled.
// - M is padded, not swapped: N = 288 takes five m64 blocks (320 rows).
//   The TMA load of W's fifth box zero-fills columns 288-319 and the TMA
//   store clips those rows, so the padding costs 11 % more MMA work on
//   tensor cores that are about 75 % idle at this shape, and nothing of
//   memory.  Swapping the roles (M the tile's L columns, N = 288) would
//   leave the sums transposed ([L][N]) against the output's [N][L], and
//   the epilogue, where the bytes are, would pay a transpose.
// - The tile: one t, all of N, 128 columns of L (a ragged last tile is
//   zero-filled on load and clipped on store): 40 960 tiles at the TPU
//   shape.  128 columns because the rows the TMA writes are then 256
//   bytes long, which the H100's memory takes faster than 128-byte rows
//   when loads and stores mix (with 64-column tiles the kernel trailed
//   torch.matmul).  One block a SM walks the tiles (tile = blockIdx.x + j
//   * gridDim.x), so waves cost little (310.3 tiles a SM).
// - W resident, A streamed.  With ``stationary`` (the TPU probe's
//   slabloop) W's boxes (60 KB at N 288) are loaded once a block and stay;
//   a ring of four stages streams A's 24 KB a tile.  Without it (batched),
//   every tile reloads W from L2 beside its A, in a ring of two 84-KB
//   stages.
// - Two consumer warpgroups take alternate tiles, so one's epilogue and
//   stores run while the other's wgmma do; one producer warp issues every
//   TMA load.  A consumer computes a tile one m block at a time: six K
//   steps of wgmma m64n128k16 as one group (64 fp32 accumulators a
//   thread: ptxas gives a thread of this block 168 registers, and five
//   m64n64 blocks at once, 160 accumulators, spilled and serialised the
//   wgmma).  The ring has an even number of stages, so that each stage
//   feeds one consumer: a consumer waits on a stage's barrier only after
//   its own previous use of it.
// - The epilogue.  After each m block a consumer rounds its sums to bf16
//   pairs into a staging slot (64 rows x 128 columns, 16 KB) laid out as
//   a box of a 4D map over out, (64 columns, column half, row, t): lines
//   of 128 bytes under the 128-byte swizzle, so the 4-byte stores meet at
//   most two to a bank, while a row's two halves are one 256-byte run in
//   memory.  It fences the async proxy, and one thread
//   TMA-stores the slot (rows past N are clipped) as a bulk group.  A
//   consumer has two slots (one when batched) and waits only for the
//   store that last used a slot to have read it (wait_group.read), so the
//   stores drain while the next blocks compute.
// Shared memory at N 288: stationary 60 + 96 + 64 KB, batched 168 + 32
// KB, of the 227 KB a block may have.  The number of m blocks is a
// run-time argument: the accumulators serve each m block in turn, so only
// the buffers' offsets and the shared memory's size depend on it.
// Needs 1 <= K <= 96, N % 8 == 0 and 8 <= N <= 320, L % 64 == 0, T * L /
// 64 below 2^31, and 16-byte aligned a, w and out.  K stops at one box:
// each m block needs all of K of both operands in shared memory at once,
// and at K 192 W alone would take 120 KB and a stage 48 KB, more than the
// ring and the staging leave (the TPU probe's K is 96).
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).

#include <limits.h>

#include "mma_common.cuh"

namespace {

constexpr int kHalf = 64;        // L columns a box: 128 bytes
constexpr int kCols = 128;       // L columns a tile: two boxes
constexpr int kRows = 64;        // N rows an m block: wgmma's M
constexpr int kMaxBlocks = 5;    // m blocks: N <= 320
constexpr int kDepth = 96;       // K rows a box: K padded to 96
constexpr int kBox = kDepth * 128;          // 12 KB an operand box
constexpr int kSlot = kRows * kCols * 2;    // 16 KB of staging an m block
constexpr int kThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kProducer = 256;              // its issuing thread
constexpr int kConsumerWarps = 4;           // one consumer reads a stage

// Where each buffer lies in shared memory (bytes from the 1024-aligned
// base) with mb m blocks: W resident (stationary only), the ring, the two
// consumers' staging slots, the barriers; every buffer 1024-aligned for
// the swizzle.
template <bool STATIONARY>
struct Layout {
  static constexpr int kStages = STATIONARY ? 4 : 2;
  static constexpr int kSlots = STATIONARY ? 2 : 1;  // a consumer's
  int stage_bytes, ring, staging, bars, bytes;
  __host__ __device__ explicit Layout(int mb)
      // a stage: A's two boxes, then (batched) W's mb boxes
      : stage_bytes((STATIONARY ? 2 : 2 + mb) * kBox),
        ring(STATIONARY ? mb * kBox : 0),
        staging(ring + kStages * stage_bytes),
        bars(staging + 2 * kSlots * kSlot),
        // full and empty a stage, and W's
        bytes(bars + 8 * (2 * kStages + 1) + 1024) {}
};

template <bool STATIONARY>
__global__ void __launch_bounds__(kThreads, 1)
dot_t_kernel(const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap omap, int mb, int tiles_l,
             int n_tiles) {
  using Lay = Layout<STATIONARY>;
  const Lay lay(mb);
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzle pattern is read from the address bits
  const unsigned base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned full0 = base + lay.bars;
  const unsigned empty0 = full0 + 8 * Lay::kStages;
  const unsigned wfull = empty0 + 8 * Lay::kStages;
  const int wg = threadIdx.x / 128;  // 2: the producer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init(wfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == kProducer) {
      if (STATIONARY) {
        mbar_expect_tx(wfull, mb * kBox);
        for (int i = 0; i < mb; ++i)
          tma_load_2d(base + i * kBox, &wmap, wfull, i * kRows, 0);
      }
      int j = 0;  // this block's tile count
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
        const int stage = j % Lay::kStages;
        // a slot's first use passes at once (the phase before is done)
        mbar_wait(empty0 + 8 * stage, ((j / Lay::kStages) & 1) ^ 1);
        const unsigned full = full0 + 8 * stage;
        const unsigned s = base + lay.ring + stage * lay.stage_bytes;
        const int l0 = tile % tiles_l * kCols, t = tile / tiles_l;
        mbar_expect_tx(full, lay.stage_bytes);
        tma_load_3d(s, &amap, full, l0, 0, t);
        tma_load_3d(s + kBox, &amap, full, l0 + kHalf, 0, t);
        if (!STATIONARY) {
          for (int i = 0; i < mb; ++i)
            tma_load_2d(s + (2 + i) * kBox, &wmap, full, i * kRows, 0);
        }
      }
    }
    return;
  }

  // a consumer: tiles j = c, c + 2, .. of this block's
  const int c = wg;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const unsigned staging = base + lay.staging + c * Lay::kSlots * kSlot;
  // The accumulator holds rows 16 warp + g and + 8 (g = lane / 4), and of
  // n8 block j columns 8j + 2 (lane % 4) + {0, 1}: in the slot, 128-byte
  // line 2 row + j / 8, chunk j % 8 moved by the swizzle (the line modulo
  // 8), bytes 4 (lane % 4) of it.
  const int g = lane / 4;
  float acc[64];
  if (STATIONARY) mbar_wait(wfull, 0);
  int j = c;
  int n = 0;  // m blocks this consumer stored: the next goes to slot n % 2
  for (int tile = blockIdx.x + c * gridDim.x; tile < n_tiles;
       tile += 2 * gridDim.x, j += 2) {
    const int stage = j % Lay::kStages;
    mbar_wait(full0 + 8 * stage, (j / Lay::kStages) & 1);
    const unsigned s = base + lay.ring + stage * lay.stage_bytes;
    const unsigned w = STATIONARY ? base : s + 2 * kBox;
    for (int i = 0; i < mb; ++i, ++n) {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kDepth / 16; ++k)
        // K rows 16 k.. of both operands: 16 rows of 128 bytes further
        wgmma_m64n128k16_bf16_mn(
            acc, wgmma_desc_sw128(w + i * kBox + 2048 * k, kBox, 1024),
            wgmma_desc_sw128(s + 2048 * k, kBox, 1024), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      if (i == mb - 1 && lane == 0) mbar_arrive(empty0 + 8 * stage);

      // the store that last used this slot must have read it
      const unsigned slot = staging + n % Lay::kSlots * kSlot;
      if (tid == 0) bulk_wait_read<Lay::kSlots - 1>();
      named_bar_sync(1 + c, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8) {
          const int line = 2 * row + n8 / 8;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * n8 + 2 * h], acc[4 * n8 + 2 * h + 1]);
          st_shared_u32(slot + line * 128 +
                            (((n8 % 8) ^ (line % 8)) << 4) + 4 * (lane % 4),
                        *reinterpret_cast<const unsigned*>(&v));
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + c, 128);
      if (tid == 0) {
        tma_store_4d(&omap, slot, 0, tile % tiles_l * 2, i * kRows,
                     tile / tiles_l);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait();
}

template <bool STATIONARY>
int launch(const CUtensorMap& amap, const CUtensorMap& wmap,
           const CUtensorMap& omap, int mb, int tiles_l, int n_tiles,
           cudaStream_t st) {
  const int smem = Layout<STATIONARY>(mb).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      dot_t_kernel<STATIONARY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int blocks = n_tiles < sms ? n_tiles : sms;
  dot_t_kernel<STATIONARY><<<blocks, kThreads, smem, st>>>(
      amap, wmap, omap, mb, tiles_l, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// out[t] (N x L) = w^T . a[t]: a [T, K, L], w [K, N], out [T, N, L], bf16,
// fp32 sums.  stationary: a block keeps w in shared memory for all its
// tiles, else it reloads w with every tile.  Needs 1 <= K <= 96, N % 8 ==
// 0 and 8 <= N <= 320, L % 64 == 0, T * L / 64 below 2^31, and a, w and
// out 16-byte aligned.
extern "C" int probe_dot_t(const void* a, const void* w, void* out, int T,
                           int K, int N, int L, int stationary,
                           void* stream) {
  if (T < 1 || K < 1 || K > kDepth || N < 8 || N > kMaxBlocks * kRows ||
      N % 8 != 0 || L < kHalf || L % kHalf != 0 ||
      (long long)T * (L / kHalf) > INT_MAX || (uintptr_t)a % 16 != 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_l = (L + kCols - 1) / kCols;
  const int n_tiles = T * tiles_l;
  // a as [T][K][L] and w as [K][N]: rows past K, columns past N and past
  // L arrive as zeros; out as [T][N][L / 64][64], so that a box of two
  // 64-column halves is one 256-byte run of a row: rows past N and a
  // half past L are not written
  CUtensorMap amap, wmap, omap;
  const long long na[3] = {L, K, T};
  const long long nw[2] = {N, K};
  const long long no[4] = {kHalf, L / kHalf, N, T};
  const unsigned box_a[3] = {kHalf, kDepth, 1};
  const unsigned box_w[2] = {kRows, kDepth};
  const unsigned box_out[4] = {kHalf, 2, kRows, 1};
  if (!encode_map(&amap, a, 3, na, box_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&wmap, w, 2, nw, box_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&omap, out, 4, no, box_out,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mb = (N + kRows - 1) / kRows;
  return stationary ? launch<true>(amap, wmap, omap, mb, tiles_l, n_tiles, st)
                    : launch<false>(amap, wmap, omap, mb, tiles_l, n_tiles,
                                    st);
}

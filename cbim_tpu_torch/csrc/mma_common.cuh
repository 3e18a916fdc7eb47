// PTX helpers shared by the tensor-core kernels (gemm_wgmma.cu,
// dot_t_wgmma.cu, conv3d_tc.cu, conv3d_wgrad_tc.cu, conv2d_tc.cu,
// conv2d_wgrad_tc.cu, conv3d_tf32.cu, conv3d_wgrad_tf32.cuh, conv2d_tf32.cu,
// conv2d_wgrad_tf32.cu, window_attention.cu): ldmatrix, vector
// shared-memory loads, mma.sync bf16 and TF32 (with the TF32 hi/lo split),
// wgmma (its fences, groups and shared-memory matrix descriptors) and
// setmaxnreg, mbarriers, named barriers, TMA and bulk copies into shared
// memory, TMA stores out of it, and the host-side encoding of a TMA tensor
// map (cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// links no libcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ device side

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives, of each matrix, row l / 4, columns 2 (l % 4) + {0, 1}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, transposed: of each matrix, column l / 4, rows 2 (l % 4) + {0, 1}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one, two and four 32-bit values from shared memory (4-, 8- and 16-byte
// aligned)
__device__ __forceinline__ unsigned lds_u32(unsigned addr) {
  unsigned r;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(addr));
  return r;
}

__device__ __forceinline__ void lds_v2(unsigned addr, unsigned r[2]) {
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void lds_v4(unsigned addr, unsigned r[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void sts_v4(unsigned addr, const unsigned r[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// fp32 bits rounded to TF32 (10 mantissa bits), to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds finite values and infinities: an add of
// half the 13 dropped bits' range and a mask (ptxas lowers cvt.rna to a
// longer compare-and-select sequence).  The add carries a NaN with the top
// mantissa bits set, such as the card's 0x7FFFFFFF, into the sign bit:
// -0.0.
__device__ __forceinline__ unsigned tf32_rna_bits(unsigned b) {
  return (b + 0x1000u) & 0xFFFFE000u;
}

// v rounded to TF32 as above, a NaN to the quiet NaN 0x7FC00000
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return isnan(v) ? 0x7FC00000u : tf32_rna_bits(__float_as_uint(v));
}

// the split of an fp32 value (its bits): hi = tf32(v), lo = tf32(v - hi).
// hi carries a NaN or an infinity into its products; lo is then the card's
// NaN rounded, -0.0, so it takes no NaN test (with one the 3xTF32 forward
// took 41 % longer on the H100, with none on lo 6 %)
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(__uint_as_float(v));
  lo = tf32_rna_bits(
      __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)));
}

// d += a (16x8, row) . b (8x8, col), tf32 in, fp32 sums; with ZERO,
// d = a . b
template <bool ZERO = false>
__device__ __forceinline__ void mma_tf32(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  if constexpr (ZERO)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An mbarrier that one thread arms with the bytes its copies will bring.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// one arrival (count 1) on a barrier, with release semantics: this
// thread's earlier shared-memory reads are done before the phase completes
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the barrier's phase of parity ``parity`` has completed; a
// copy that never lands (a bad tensor map) traps after about 4 s instead
// of hanging the card (a real wait lasts microseconds)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  unsigned long long t0 = 0;
  for (unsigned polls = 1; !done; ++polls) {
    if (polls % 1024 == 0) {
      const unsigned long long now = global_ns();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// order this thread's earlier shared-memory accesses before later
// asynchronous-proxy (TMA) writes to the same buffer
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box of ``map`` at coordinates (c0..c4), innermost first, into
// shared memory at ``dst``; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_load_5d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// the same for a 2D map, coordinates (c0, c1)
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same for a 3D map, coordinates (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// the same for a 4D map, coordinates (c0..c3)
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// TMA store: the box of ``map`` at (c0..c3) from shared memory at ``src``
// (laid out as a load of the same map would leave it); elements out of
// bounds are not written.  Completes asynchronously: commit the group, and
// wait for it (bulk_wait_read) before ``src`` is written again.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             unsigned src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's committed bulk stores, all but the newest N groups, have
// read their shared memory
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's committed bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(unsigned addr, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// a contiguous copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) into shared memory
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset of 16-byte chunk ``j`` (0..3) of 64-byte row ``r`` in a
// buffer that TMA filled with CU_TENSOR_MAP_SWIZZLE_64B (address bits 4-5
// XOR bits 7-8; the buffer is 1024-byte aligned): eight consecutive rows
// read at one chunk fall on eight distinct bank groups.
__device__ __forceinline__ unsigned swz64(unsigned r, unsigned j) {
  return r * 64 + ((j ^ ((r >> 1) & 3)) << 4);
}

// Barrier ``id`` (1..15; 0 is __syncthreads') among ``threads`` threads
// (a multiple of 32): the warps of one warpgroup wait for each other
// without stopping the rest of the block.
__device__ __forceinline__ void named_bar_sync(unsigned id, unsigned threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ wgmma

// A warpgroup (4 consecutive, aligned warps) resizes its register file:
// setmaxnreg.dec in a warpgroup that needs few (a TMA producer), .inc in
// one that holds large accumulators.  Every thread of the warpgroup runs
// it, in a branch the warpgroup never leaves.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// order this warpgroup's register and shared-memory accesses before the
// wgmma that follow (before the first wgmma of a group, and whenever the
// accumulators were touched by other instructions)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins each of n accumulator registers at this point of the program, so
// the compiler reads them after (not before) the wgmma_wait before it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory matrix descriptor of a wgmma operand in a buffer that
// TMA filled with CU_TENSOR_MAP_SWIZZLE_128B (1024-byte aligned swizzle
// atoms of 8 rows x 128 bytes): start address, leading and stride byte
// offsets (in 16-byte units), layout type 1 (128-byte swizzle).
// - K-major (K contiguous, 64 bf16 a row): ``lbo`` unused (1), ``sbo``
//   the 8-row stride along M or N, 1024 bytes; a K step of 16 is +32 bytes
//   of ``addr``.
// - MN-major (M or N contiguous, the operand read transposed): ``lbo`` the
//   stride between atoms along M or N (64 values apart), ``sbo`` the stride
//   between 8-row groups along K; a K step of 16 is +2048 bytes of
//   ``addr``.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(unsigned addr,
                                                     unsigned lbo,
                                                     unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define WGMMA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_D16(i) \
  WGMMA_D4(i), WGMMA_D4(i + 4), WGMMA_D4(i + 8), WGMMA_D4(i + 12)

// d (64 x 256, fp32, this warpgroup's registers) = a (64 x 16, K-major) .
// b (16 x 256, N-major: read transposed, imm-trans-b 1) + (accumulate ? d :
// 0), bf16 operands from shared memory through their descriptors.
// Thread t of the warpgroup holds, of each n8 block j, d[4j], d[4j + 1] at
// row 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t % 4) + {0, 1}, and
// d[4j + 2], d[4j + 3] eight rows below.  Asynchronous: commit the group
// and wait for it before d is read.
__device__ __forceinline__ void wgmma_m64n256k16_bf16_tn(float (&d)[128],
                                                         uint64_t da,
                                                         uint64_t db,
                                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : WGMMA_D16(0), WGMMA_D16(16), WGMMA_D16(32), WGMMA_D16(48),
        WGMMA_D16(64), WGMMA_D16(80), WGMMA_D16(96), WGMMA_D16(112)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) = a (64 x 16, M-major: read transposed, imm-trans-a
// 1) . b (16 x 128, N-major: imm-trans-b 1) + (accumulate ? d : 0), both
// bf16 operands stored with their M or N contiguous, as a [K][M] and a
// [K][N] matrix lie.  Thread t holds, of each n8 block j, d[4j],
// d[4j + 1] at row 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t % 4) +
// {0, 1}, and d[4j + 2], d[4j + 3] eight rows below.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_mn(float (&d)[64],
                                                         uint64_t da,
                                                         uint64_t db,
                                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : WGMMA_D16(0), WGMMA_D16(16), WGMMA_D16(32), WGMMA_D16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef WGMMA_D16
#undef WGMMA_D4

// -------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled map of ``rank`` (at most 5) dimensions over
// t[n_{rank-1}]..[n1][n0] of bf16 (or, with ``dtype``, fp32) values (n0
// innermost, every stride a multiple of 16 bytes: n0 % 8 == 0 in bf16,
// n0 % 4 == 0 in fp32), box (b0, ..), 64-byte swizzle (b0 values of 64
// bytes: 32 bf16 or 16 fp32; with ``swizzle`` CU_TENSOR_MAP_SWIZZLE_128B,
// 128-byte rows), zeros out of bounds.  False if it cannot be encoded.
inline bool encode_map(
    CUtensorMap* map, const void* base, int rank, const long long* n,
    const unsigned* box,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_64B) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || rank < 1 || rank > 5) return false;
  cuuint64_t dims[5], strides[4];
  cuuint32_t boxd[5], estr[5];
  // bytes of one value
  unsigned long long stride = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  for (int i = 0; i < rank; ++i) {
    dims[i] = (cuuint64_t)n[i];
    boxd[i] = box[i];
    estr[i] = 1;
    stride *= (unsigned long long)n[i];
    if (i < rank - 1) strides[i] = stride;
  }
  return fn(map, dtype, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, boxd, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Probe kernels for Hopper (sm_90a): instruments of the port's own kernels.
//
// Replaces the Pallas TPU probes of the JAX package's tools/:
//   tools/probe_bandwidth.py main (scale_kernel): a bf16 copy-scale probe of
//     HBM bandwidth, on (block, 32) vs (block, 128) VMEM blocks;
//   tools/probe_lhst_dot.py main (batched_kernel, slabloop_kernel): an MXU
//     dot contracting dim 0 of both operands, out[t] = W^T . A[t];
//   tools/probe_lhst_dot.py big_square (kern): a 1k^2 calibration dot.
// They lie on no serving or training path.  Each computes what its TPU
// probe computes; lane density, VMEM blocks and the MXU's 128-wide tiles are
// TPU concerns, so each sweeps what plays their part on Hopper instead.
//
// probe_copy_scale: y = 2 x in bf16.  Bound by bytes: every element is read
// once and written once (0.537 GB at 2 x 128^3 x 32, 0.160 ms at 3.35
// TB/s).  Variants: a 2-byte scalar access per thread against a 16-byte
// vector of 8 bf16 (the TPU's lane-sparse vs lane-dense views), and 2048 vs
// 8192 elements per block (the TPU probe's small vs big blocks).
//
// probe_dot_t / probe_gemm: one hand-written bf16 tensor-core GEMM with
// fp32 sums, mma.sync.aligned.m16n8k16 (no cuBLAS, no CUTLASS; wgmma and TMA
// are the tensor-core conv redesign's work).  C[t] (M x N) = opA[t] (M x K)
// . B[t] (K x N), row-major bf16 C, B stored [K][N].
// - probe_dot_t stores opA as [K][M] (W [96, 288]): both operands contract
//   their dim 0, so both reach mma in the "wrong" major order.  Both are
//   staged in shared memory as they lie in device memory and transposed on
//   the way into registers by ldmatrix.trans (no transpose pass).  Bound by
//   bytes on the H100 at the TPU probe's shape: A [2048, 96, 2560] (1.0 GB)
//   in, out [2048, 288, 2560] (3.0 GB) out, 1.20 ms at 3.35 TB/s against
//   0.29 ms of bf16 tensor-core FLOPs.  A block owns one (t, 96 rows of W,
//   128-column slab) tile over all of K = 96; "slabs" > 1 makes it
//   weight-stationary: it keeps its 96 x 96 block of W in shared memory and
//   loops over that many slabs of its t (the TPU probe's "slabloop"), where
//   slabs = 1 spreads the 2560-wide dot over blocks that each reload W (its
//   "batched" form).
// - probe_gemm stores opA row-major [M][K] (plain ldmatrix) and shares B
//   across t: the square calibration, 64 x [1024, 1024] . [1024, 1024].
//   Bound by operations: 137 GFLOP at 989 TFLOP/s, 0.139 ms.
// Block tile BM x 128 with 8 warps as 2 (m) x 4 (n), each warp BM/2 x 32 of
// m16n8 tiles; K staged in BK-deep chunks, rows padded by 8 bf16 so that
// ldmatrix's eight 16-byte rows fall on distinct banks.  No double
// buffering yet: each chunk is staged, synchronised and consumed.
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// --------------------------------------------------------------- copy-scale

constexpr int kCopyThreads = 256;

template <bool VEC, int BLOCK>
__global__ void __launch_bounds__(kCopyThreads)
copy_scale_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                  long long n) {
  const long long base = (long long)blockIdx.x * BLOCK;
  if constexpr (VEC) {
    // n % 8 == 0: a vector is whole or past the end
    const __nv_bfloat162 two = __floats2bfloat162_rn(2.f, 2.f);
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    uint4* yv = reinterpret_cast<uint4*>(y + base);
#pragma unroll
    for (int i = threadIdx.x; i < BLOCK / 8; i += kCopyThreads) {
      if (base + 8LL * i >= n) break;
      uint4 r = xv[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int q = 0; q < 4; ++q) h[q] = __hmul2(h[q], two);
      yv[i] = r;
    }
  } else {
    const bf16 two = __float2bfloat16_rn(2.f);
#pragma unroll
    for (int i = threadIdx.x; i < BLOCK; i += kCopyThreads) {
      const long long e = base + i;
      if (e < n) y[e] = __hmul(x[e], two);
    }
  }
}

template <bool VEC, int BLOCK>
void launch_copy(const bf16* x, bf16* y, long long n, cudaStream_t st) {
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  copy_scale_kernel<VEC, BLOCK><<<(unsigned)blocks, kCopyThreads, 0, st>>>(
      x, y, n);
}

// ------------------------------------------------------- tensor-core GEMM

constexpr int kMmaThreads = 256;  // 8 warps: 2 (m) x 4 (n)
constexpr int kBN = 128;          // output columns per block tile
constexpr int kPad = 8;           // bf16 of padding per shared-memory row

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

// C[t] = opA[t] . B[t]; A_KM: opA stored [K][M], else [M][K].  a_bs, b_bs:
// batch strides in elements (0: shared by every t).  grid (N / (128 *
// slabs), M / BM, T); needs M % BM == 0, N % (128 * slabs) == 0, K % BK ==
// 0 and rows of 16-byte multiples.
template <bool A_KM, int BM, int BK>
__global__ void __launch_bounds__(kMmaThreads)
mma_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                bf16* __restrict__ C, int M, int N, int K, long long a_bs,
                long long b_bs, int slabs) {
  constexpr int WM = BM / 2, WN = kBN / 4;  // warp tile
  constexpr int MT = WM / 16, NT = WN / 8;  // m16 x n8 tiles per warp
  constexpr int A_ROWS = A_KM ? BK : BM;
  constexpr int A_COLS = (A_KM ? BM : BK) + kPad;
  constexpr int B_COLS = kBN + kPad;
  // raw 16-bit storage: only 16-byte copies and ldmatrix touch it
  __shared__ __align__(16) uint16_t As[A_ROWS * A_COLS];
  __shared__ __align__(16) uint16_t Bs[BK * B_COLS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row
  const int m0 = blockIdx.y * BM;
  const long long t = blockIdx.z;
  const bf16* At = A + t * a_bs;
  const bf16* Bt = B + t * b_bs;
  bf16* Ct = C + t * M * (long long)N;
  // the whole of K in one chunk: the A tile stays for every slab
  const bool a_resident = K == BK;

  for (int s = 0; s < slabs; ++s) {
    const int n0 = (blockIdx.x * slabs + s) * kBN;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      if (!(a_resident && s > 0)) {
        constexpr int VPR = (A_KM ? BM : BK) / 8;  // 16-byte vectors a row
        for (int e = tid; e < A_ROWS * VPR; e += kMmaThreads) {
          const int r = e / VPR, cv = (e % VPR) * 8;
          const long long src = A_KM ? (long long)(k0 + r) * M + m0 + cv
                                     : (long long)(m0 + r) * K + k0 + cv;
          *reinterpret_cast<uint4*>(&As[r * A_COLS + cv]) =
              *reinterpret_cast<const uint4*>(At + src);
        }
      }
      for (int e = tid; e < BK * (kBN / 8); e += kMmaThreads) {
        const int r = e / (kBN / 8), cv = (e % (kBN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[r * B_COLS + cv]) =
            *reinterpret_cast<const uint4*>(Bt + (long long)(k0 + r) * N +
                                            n0 + cv);
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        // B fragments of two n8 tiles per ldmatrix: matrices (k 0-7, n j),
        // (k 8-15, n j), (k 0-7, n j + 1), (k 8-15, n j + 1)
        unsigned b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned q[4];
          ldsm_x4_t(smem_u32(&Bs[(kk + (mat & 1) * 8 + r8) * B_COLS +
                                 wn * WN + j * 8 + (mat >> 1) * 8]),
                    q);
          b[j][0] = q[0];
          b[j][1] = q[1];
          b[j + 1][0] = q[2];
          b[j + 1][1] = q[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // A fragment: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
          // (m 0-7, k 8-15), (m 8-15, k 8-15)
          const int mr = wm * WM + i * 16 + (mat & 1) * 8;
          const int kc = kk + (mat >> 1) * 8;
          unsigned a[4];
          if constexpr (A_KM)
            ldsm_x4_t(smem_u32(&As[(kc + r8) * A_COLS + mr]), a);
          else
            ldsm_x4(smem_u32(&As[(mr + r8) * A_COLS + kc]), a);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
      __syncthreads();
    }

    // accumulator (row l / 4 [+ 8], columns 2 (l % 4) + {0, 1}) as bf16 pairs
    const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const long long row = m0 + wm * WM + i * 16 + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + c2;
        *reinterpret_cast<__nv_bfloat162*>(&Ct[row * N + col]) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<__nv_bfloat162*>(&Ct[(row + 8) * N + col]) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// probe_dot_t's tile: 96 rows of W by all of K = 96 (a K of any multiple)
constexpr int kDotBM = 96, kDotBK = 96;
// probe_gemm's tile: 128 x 128, K in chunks of 32
constexpr int kGemmBM = 128, kGemmBK = 32;

}  // namespace

// y = 2 x over n bf16 elements; vec: 16-byte accesses (x and y 16-byte
// aligned, n % 8 == 0), else 2-byte; block: elements per block, 2048 or
// 8192.
extern "C" int probe_copy_scale(const void* x, void* y, long long n, int vec,
                                int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* yt = static_cast<bf16*>(y);
  if (vec && (n % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (vec && block == 2048)
    launch_copy<true, 2048>(xt, yt, n, st);
  else if (vec && block == 8192)
    launch_copy<true, 8192>(xt, yt, n, st);
  else if (!vec && block == 2048)
    launch_copy<false, 2048>(xt, yt, n, st);
  else if (!vec && block == 8192)
    launch_copy<false, 8192>(xt, yt, n, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out[t] (N x L) = w^T . a[t]: a [T, K, L], w [K, N], out [T, N, L], bf16,
// fp32 sums; slabs: 128-column slabs a block walks with its W block kept.
extern "C" int probe_dot_t(const void* a, const void* w, void* out, int T,
                           int K, int N, int L, int slabs, void* stream) {
  if (T < 1 || T > 65535 || slabs < 1 || N % kDotBM != 0 ||
      K % kDotBK != 0 || L % (kBN * slabs) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(L / (kBN * slabs)), (unsigned)(N / kDotBM),
                  (unsigned)T);
  mma_gemm_kernel<true, kDotBM, kDotBK>
      <<<grid, kMmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(w), static_cast<const bf16*>(a),
          static_cast<bf16*>(out), N, L, K, 0, (long long)K * L, slabs);
  return (int)cudaGetLastError();
}

// out[t] (M x N) = a[t] . b: a [T, M, K], b [K, N], out [T, M, N], bf16,
// fp32 sums.
extern "C" int probe_gemm(const void* a, const void* b, void* out, int T,
                          int M, int N, int K, void* stream) {
  if (T < 1 || T > 65535 || M % kGemmBM != 0 || N % kBN != 0 ||
      K % kGemmBK != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(N / kBN), (unsigned)(M / kGemmBM), (unsigned)T);
  mma_gemm_kernel<false, kGemmBM, kGemmBK>
      <<<grid, kMmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(b),
          static_cast<bf16*>(out), M, N, K, (long long)M * K, 0, 1);
  return (int)cudaGetLastError();
}

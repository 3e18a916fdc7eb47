// Stride-1, zero-pad-1, 3x3x3 convolution for Hopper (sm_90a): the forward
// (which also computes the input gradient, on flip-swapped weights), also
// with a fused InstanceNorm+act prologue (conv3d_same_na_fwd: the preact
// conv(act(IN(x))), see "Norm-act prologue" in conv3d_common.cuh), and its
// phase ladder.  The weight gradient is conv3d_wgrad.cu: two translation
// units, so nvcc compiles the two kernel families side by side.
//
// Replaces the Pallas TPU kernels of cbim_tpu/ops/pallas/conv3d.py:
//   _conv_kernel / _conv3d_same_pallas / conv3d_same      (NDHWC),
//   _conv_kernel_cw / conv3d_same_cw                     (NDHCW twin),
//   _conv_kernel_cw2 / conv3d_same_cw2                   (NDHCW twin).
// The NDHCW twins exist for TPU lane density only; their math is this one
// NDHWC kernel.  The tap packing of the TPU kernel (K = 3*C, N = 9*F) existed
// to fill 128-lane MXU tiles at C = 32 and is not carried over.
//
//   y[b, d, h, w, f] = sum_{kd, kh, kw, c} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                        * wp[kd, kh, kw, c, f]
// x: [B, D, H, W, C], wp: [3, 3, 3, C, F] (the wrapper packs torch's
// [F, C, 3, 3, 3]), y: [B, D, H, W, F]; fp32 or bf16 storage, fp32 sums.
//
// What bounds it on the H100: arithmetic.  The full-resolution convolutions
// of MedFormer-3D are 2*27*C*F FLOPs per voxel, about 2 TFLOP per 128^3
// window, against 67 TFLOP/s of fp32 FMA outside the tensor cores.
//
// What the design does about it: an implicit GEMM on CUDA cores.  M is the
// output voxels, N the output channels, K = 27 taps x C.  A block owns a
// 128-voxel x BN-channel tile; for each tap and each 16-channel slice it
// stages the shifted input rows (zeros outside the volume, so ragged D/H/W
// need no padding copy) and the weight slice in shared memory, and each of
// its 128 threads accumulates an 8 x BN/8 register tile, 64 FMAs per pair
// of shared-memory vector loads at BN = 64.  The weights never sit whole in
// shared memory: 27*C*F*4 bytes is 1.3 MB at C = 192, F = 64.
// The taps re-read neighbouring input rows, which L1 and the 50 MB L2 serve.
// Tensor cores (mma/wgmma in bf16) and TMA staging are the next steps.
// With the norm-act prologue (conv3d_same_na_fwd) each input value is
// normalised where it is staged: once per tap and F-tile, 27x per input
// value at F <= 64.  With the exact-erf GELU that costs about as many
// instructions as the FMAs it feeds at BN = 32; a block of 128 voxels along
// W that staged its normalised halo rows once would still normalise each
// value 9x (once in each of the 9 blocks whose (d, h) rows read it), so
// cutting it to about once takes 3D output tiles (ROADMAP B7).
//
// The phase ladder (conv3d_same_fwd_ladder) is the port of the TPU probe
// tools/probe_cw_dissect.py (build: the cw kernel cut after its DMA,
// transpose, dot or reduce): the forward kernel cut after a phase, PHASE =
//   kPhaseLoad:  the shifted input rows and weight slices read, no shared
//                memory stores (each thread sums what it loads);
//   kPhaseStage: plus the shared-memory stores and the barriers (each thread
//                adds one staged value another thread stored);
//   kPhaseFma:   plus the register-tile FMAs (each thread sums its tile);
//   kPhaseFull:  plus the epilogue's store of the tile: the real op, the very
//                instantiation conv3d_same_fwd launches.
// A cut rung stores one value a thread, which depends on all the work it
// keeps, so the compiler cannot drop that work; its output is otherwise
// garbage by design.  The TPU probe's (d_blk, h_blk) sweep becomes the BN
// = 32/64 tiles.
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "conv3d_common.cuh"

namespace {

constexpr int kBM = 128;       // output voxels per block
constexpr int kBK = 16;        // input channels per staged slice
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kTM = kBM / 16;  // voxels per thread

constexpr int kPhaseLoad = 0, kPhaseStage = 1, kPhaseFma = 2, kPhaseFull = 3;

template <typename T, int BN, int VEC, int NA, int PHASE = kPhaseFull>
__global__ void __launch_bounds__(kThreads)
conv3d_same_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                       T* __restrict__ y, const float* __restrict__ mean,
                       const float* __restrict__ rstd, int D, int H, int W,
                       int C, int F, long long M) {
  constexpr int TN = BN / 8;  // output channels per thread
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // The A row this thread stages is output voxel m0 + tid.
  const long long m_load = m0 + tid;
  const bool row_ok = m_load < M;
  int w0 = 0, h0 = 0, d0 = 0;
  long long b0 = 0;
  if (row_ok) {
    long long r = m_load;
    w0 = (int)(r % W); r /= W;
    h0 = (int)(r % H); r /= H;
    d0 = (int)(r % D);
    b0 = r / D;
  }
  // this row's sample's statistics (NA only)
  const long long st = NA == kNoNorm ? 0 : b0 * C;
  const float* ms = mean + st;
  const float* rs = rstd + st;

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float chk = 0.f;  // a cut rung's one stored value

  for (int t = 0; t < 27; ++t) {
    const int sd = d0 + t / 9 - 1;
    const int sh = h0 + (t / 3) % 3 - 1;
    const int sw = w0 + t % 3 - 1;
    const bool valid = row_ok && sd >= 0 && sd < D && sh >= 0 && sh < H &&
                       sw >= 0 && sw < W;
    const long long src_off =
        valid ? (((b0 * D + sd) * H + sh) * (long long)W + sw) * C : 0;
    const T* src = x + src_off;
    const T* wt = wp + (long long)t * C * F;

    for (int c0 = 0; c0 < C; c0 += kBK) {
#pragma unroll
      for (int j = 0; j < kBK / VEC; ++j) {
        const int c = c0 + j * VEC;
        float v[VEC];
        if (valid && c < C) {
          load_na<T, VEC, NA>(src + c, ms + c, rs + c, v);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          if constexpr (PHASE == kPhaseLoad)
            chk += v[q];
          else
            As[j * VEC + q][tid] = v[q];
        }
      }
#pragma unroll
      for (int j = 0; j < kBK * BN / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int n = e % BN;
        const int k = e / BN;
        const int c = c0 + k;
        const int f = n0 + n;
        const float wv = (c < C && f < F) ? to_f32(wt[(long long)c * F + f])
                                          : 0.f;
        if constexpr (PHASE == kPhaseLoad)
          chk += wv;
        else
          Bs[k][n] = wv;
      }
      if constexpr (PHASE == kPhaseLoad) continue;
      __syncthreads();
      if constexpr (PHASE == kPhaseStage)
        chk += As[c0 / kBK % kBK][(tid + 1) % kBM] + Bs[tid % kBK][tid % BN];

      if constexpr (PHASE >= kPhaseFma) {
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
          float a[kTM], bv[TN];
#pragma unroll
          for (int i = 0; i < kTM; ++i) a[i] = As[k][ty * kTM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  if constexpr (PHASE != kPhaseFull) {
    if constexpr (PHASE == kPhaseFma) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) chk += acc[i][j];
    }
    if (m_load < M && n0 < F) y[m_load * F + n0] = from_f32<T>(chk);
    return;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) continue;
    T* yr = y + m * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = n0 + tx * TN + j;
      if (f < F) yr[f] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BN, int NA>
void launch(const void* x, const void* w, void* y, const float* mean,
            const float* rstd, int B, int D, int H, int W, int C, int F,
            cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((F + BN - 1) / BN));
  const bool vec = C % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)mean % 16 == 0 && (uintptr_t)rstd % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec)
    conv3d_same_fwd_kernel<T, BN, 4, NA><<<grid, kThreads, 0, stream>>>(
        xt, wt, yt, mean, rstd, D, H, W, C, F, M);
  else
    conv3d_same_fwd_kernel<T, BN, 1, NA><<<grid, kThreads, 0, stream>>>(
        xt, wt, yt, mean, rstd, D, H, W, C, F, M);
}

template <typename T, int NA>
void launch_dtype(const void* x, const void* w, void* y, const float* mean,
                  const float* rstd, int B, int D, int H, int W, int C, int F,
                  cudaStream_t stream) {
  if (F <= 32)
    launch<T, 32, NA>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else
    launch<T, 64, NA>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
}

// The forward with prologue ``na`` (kNoNorm or an act code); false for a
// bad code.
template <typename T>
bool launch_fwd(int na, const void* x, const void* w, void* y,
                const float* mean, const float* rstd, int B, int D, int H,
                int W, int C, int F, cudaStream_t stream) {
  if (na == kNoNorm)
    launch_dtype<T, kNoNorm>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else if (na == kActNone)
    launch_dtype<T, kActNone>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else if (na == kActRelu)
    launch_dtype<T, kActRelu>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else if (na == kActGelu)
    launch_dtype<T, kActGelu>(x, w, y, mean, rstd, B, D, H, W, C, F, stream);
  else
    return false;
  return true;
}

// The plain forward (no prologue) cut after PHASE at tile width BN, on the
// 16-byte staging path only; PHASE = kPhaseFull at the production BN is
// what launch_dtype<T, kNoNorm> launches.
template <typename T, int BN, int PHASE>
void launch_ladder(const void* x, const void* w, void* y, int B, int D,
                   int H, int W, int C, int F, cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                  (unsigned)((F + BN - 1) / BN));
  conv3d_same_fwd_kernel<T, BN, 4, kNoNorm, PHASE>
      <<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      nullptr, nullptr, D, H, W, C, F, M);
}

template <typename T, int BN>
bool ladder_phase(int phase, const void* x, const void* w, void* y, int B,
                  int D, int H, int W, int C, int F, cudaStream_t stream) {
  if (phase == kPhaseLoad)
    launch_ladder<T, BN, kPhaseLoad>(x, w, y, B, D, H, W, C, F, stream);
  else if (phase == kPhaseStage)
    launch_ladder<T, BN, kPhaseStage>(x, w, y, B, D, H, W, C, F, stream);
  else if (phase == kPhaseFma)
    launch_ladder<T, BN, kPhaseFma>(x, w, y, B, D, H, W, C, F, stream);
  else if (phase == kPhaseFull)
    launch_ladder<T, BN, kPhaseFull>(x, w, y, B, D, H, W, C, F, stream);
  else
    return false;
  return true;
}

template <typename T>
bool ladder_entry(int phase, int bn, const void* x, const void* w, void* y,
                  int B, int D, int H, int W, int C, int F,
                  cudaStream_t stream) {
  if (C % 4 != 0 || (uintptr_t)x % (4 * sizeof(T)) != 0) return false;
  if (bn == 32)
    return ladder_phase<T, 32>(phase, x, w, y, B, D, H, W, C, F, stream);
  if (bn == 64)
    return ladder_phase<T, 64>(phase, x, w, y, B, D, H, W, C, F, stream);
  return false;
}


int fwd_entry(int na, const void* x, const void* w, void* y, const void* mean,
              const void* rstd, int dtype, int B, int D, int H, int W, int C,
              int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  bool ok = false;
  if (dtype == 0)
    ok = launch_fwd<float>(na, x, w, y, m, r, B, D, H, W, C, F, st);
  else if (dtype == 1)
    ok = launch_fwd<__nv_bfloat16>(na, x, w, y, m, r, B, D, H, W, C, F, st);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  w is packed [3, 3, 3, C, F] in x's dtype.
extern "C" int conv3d_same_fwd(const void* x, const void* w, void* y,
                               int dtype, int B, int D, int H, int W, int C,
                               int F, void* stream) {
  return fwd_entry(kNoNorm, x, w, y, nullptr, nullptr, dtype, B, D, H, W, C,
                   F, stream);
}

// conv3d_same_fwd cut after ``phase`` (0 load, 1 stage, 2 fma, 3 full) at
// tile width ``bn`` (32 or 64; conv3d_same_fwd takes 32 for F <= 32, else
// 64); needs C % 4 == 0 and x aligned to 4 elements.
extern "C" int conv3d_same_fwd_ladder(const void* x, const void* w, void* y,
                                      int dtype, int B, int D, int H, int W,
                                      int C, int F, int phase, int bn,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = ladder_entry<float>(phase, bn, x, w, y, B, D, H, W, C, F, st);
  else if (dtype == 1)
    ok = ladder_entry<__nv_bfloat16>(phase, bn, x, w, y, B, D, H, W, C, F,
                                     st);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// conv3d_same_fwd of act((x - mean) * rstd): mean, rstd fp32 [B, C]; act 0
// none, 1 relu, 2 gelu.
extern "C" int conv3d_same_na_fwd(const void* x, const void* w, void* y,
                                  const void* mean, const void* rstd,
                                  int dtype, int act, int B, int D, int H,
                                  int W, int C, int F, void* stream) {
  if (act == kNoNorm) return (int)cudaErrorInvalidValue;
  return fwd_entry(act, x, w, y, mean, rstd, dtype, B, D, H, W, C, F, stream);
}

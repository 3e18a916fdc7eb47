// Fused (shifted-)window attention for Hopper (sm_90a), inference only.
//
// Replaces the Pallas TPU kernel of cbim_tpu/ops/pallas/window_attention.py:
//   _kernel / fused_window_attention (one (window, head) grid cell each).
//
//   o[b, h, i, :] = sum_j softmax_j(s[b, h, i, :]) * v[b, h, j, :]
//   s[b, h, i, j] = (q[b, h, i, :] * D^-1/2) . k[b, h, j, :]
//                   + rel_bias[h, i, j]
//                   - 100 if region[b % nW, i] != region[b % nW, j]
// q, k, v: [B, H, N, D] at any (batch, head, row) strides, unit stride on D;
// o: [B, H, N, D] at its own strides; fp32 or bf16 storage, fp32 softmax and
// sums.  The TPU kernel read a dense (B or 1, H, N, N) additive bias; here the
// relative-position bias (H, N, N) and the shifted-window region ids
// (nW, N) replace it: compute_attn_mask (cbim_tpu/models/swin_layers.py:90)
// builds its -100 mask from exactly these ids, and a dense mask would be
// 1000 x 343^2 x 4 B = 470 MB at SwinUNETR's first stage, read once per
// head, against 1.4 MB of ids.  The wrapper passes rel_bias transposed,
// bias_t[h, j, i], so the 32 query rows of a warp read one key's bias as one
// 128-byte line.
//
// What bounds it on the H100: arithmetic.  4*N^2*D FLOPs per (window, head)
// against N*D*4 values moved: 22.6 GFLOP over 263 MB at SwinUNETR's first
// stage of one 128^3 window (1000 x 3 x 343 x 16, fp32), 0.34 ms at 67
// TFLOP/s of fp32 FMA outside the tensor cores, 0.08 ms at 3.35 TB/s.
//
// What the design does about it: a block owns up to 128 query rows of one
// (window, head), one row per thread.  It stages the whole window's K and V
// (and region ids) in shared memory as fp32, N*D*8 bytes (44 KB at N = 343,
// D = 16; dynamic shared memory past 48 KB), so the N x N scores never leave
// registers.  Each thread keeps its scaled q row, an online softmax (running
// max and sum, base-2 exponent) and its fp32 output row in registers, and
// walks the keys 32 at a time: 32 dot products, one rescale, 32 updates of
// the output row.  Every thread of a warp reads the same key row, a shared-
// memory broadcast.  Tensor cores (mma/wgmma), TMA staging and several rows
// per thread are the next steps.
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 128;  // query rows (threads) per block
constexpr int kChunk = 32;     // keys per online-softmax step
constexpr float kLog2e = 1.4426950408889634f;
// the shifted-window mask value, -100 (swin_layers.py:122), in base 2
constexpr float kMaskLog2 = -100.0f * kLog2e;

// VEC consecutive values as fp32; VEC = 4 needs an aligned address.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float v[VEC]);
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float v[1]) {
  v[0] = p[0];
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float v[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float v[1]) {
  v[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float v[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// VEC consecutive fp32 values stored as T, rounded to nearest.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float v[VEC]);
template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p, const float v[1]) {
  p[0] = v[0];
}
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(
    __nv_bfloat16* p, const float v[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 4>(
    __nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

// grid.x = B * H * n_tiles (tile fastest), blockDim.x = rows per tile.
template <typename T, int D, int VEC>
__global__ void __launch_bounds__(kMaxRows)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias_t,
                        const int* __restrict__ region, T* __restrict__ o,
                        int H, int N, int nW, int n_tiles, long long sb,
                        long long sh, long long sn, long long osb,
                        long long osh, long long osn, float q_scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                                   // [N][D]
  float* Vs = smem + (long long)N * D;                // [N][D]
  int* Rs = reinterpret_cast<int*>(smem + 2LL * N * D);  // [N]

  const int rows = blockDim.x;
  long long blk = blockIdx.x;
  const int tile = (int)(blk % n_tiles);
  blk /= n_tiles;
  const int h = (int)(blk % H);
  const long long b = blk / H;
  const long long in_off = b * sb + (long long)h * sh;
  const bool masked = region != nullptr;

  // K, V (and the window's region ids) of (b, h) into shared memory
  for (int e = threadIdx.x; e < N * (D / VEC); e += rows) {
    const int r = e / (D / VEC);
    const int c = (e % (D / VEC)) * VEC;
    float kv[VEC], vv[VEC];
    load_vec<T, VEC>(k + in_off + r * sn + c, kv);
    load_vec<T, VEC>(v + in_off + r * sn + c, vv);
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      Ks[r * D + c + t] = kv[t];
      Vs[r * D + c + t] = vv[t];
    }
  }
  if (masked) {
    const int* reg = region + (b % nW) * N;
    for (int j = threadIdx.x; j < N; j += rows) Rs[j] = reg[j];
  }
  __syncthreads();

  const int i = tile * rows + threadIdx.x;
  const bool row_ok = i < N;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; d += VEC) {
    float t[VEC];
    if (row_ok) {
      load_vec<T, VEC>(q + in_off + (long long)i * sn + d, t);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) t[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) qr[d + u] = t[u] * q_scale;
  }
  const int ri = (masked && row_ok) ? Rs[i] : 0;
  // bias_t[h, j, i] = brow[j * N]; rows past N read row 0 and store nothing
  const float* brow = bias_t + (long long)h * N * N + (row_ok ? i : 0);

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max of the base-2 scores
  float l = 0.f;        // running sum of 2^(s - m)

  for (int j0 = 0; j0 < N; j0 += kChunk) {
    float s[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      float a = -INFINITY;
      if (j < N) {
        const float* kr = Ks + j * D;
        a = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
          a = fmaf(qr[d], kk.x, a);
          a = fmaf(qr[d + 1], kk.y, a);
          a = fmaf(qr[d + 2], kk.z, a);
          a = fmaf(qr[d + 3], kk.w, a);
        }
        a = fmaf(brow[(long long)j * N], kLog2e, a);
        if (masked && Rs[j] != ri) a += kMaskLog2;
      }
      s[jj] = a;
      cmax = fmaxf(cmax, a);
    }
    // every chunk holds at least one key, so m_new is finite; on the first
    // chunk exp2f(-inf) = 0 clears the empty sums
    const float m_new = fmaxf(m, cmax);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      if (j < N) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
        const float* vr = Vs + j * D;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / l;
    T* orow = o + b * osb + (long long)h * osh + (long long)i * osn;
#pragma unroll
    for (int d = 0; d < D; d += VEC) {
      float t[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) t[u] = acc[d + u] * inv;
      store_vec<T, VEC>(orow + d, t);
    }
  }
}

template <typename T, int D, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias_t, const int* region, void* o, int B,
                   int H, int N, int nW, long long sb, long long sh,
                   long long sn, long long osb, long long osh, long long osn,
                   cudaStream_t stream) {
  // a tile of 128 rows, or of N rounded up to a warp where N is smaller
  const int rows = N >= kMaxRows ? kMaxRows : ((N + 31) / 32) * 32;
  const int n_tiles = (N + rows - 1) / rows;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)N * D + N) * sizeof(float);
  auto kernel = window_attention_kernel<T, D, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float q_scale = kLog2e / sqrtf((float)D);
  kernel<<<(unsigned)blocks, rows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_t, region, static_cast<T*>(o), H, N, nW,
      n_tiles, sb, sh, sn, osb, osh, osn, q_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_vec(const void* q, const void* k, const void* v,
                       const float* bias_t, const int* region, void* o, int B,
                       int H, int N, int nW, long long sb, long long sh,
                       long long sn, long long osb, long long osh,
                       long long osn, cudaStream_t stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = (uintptr_t)q % align == 0 && (uintptr_t)k % align == 0 &&
                   (uintptr_t)v % align == 0 && (uintptr_t)o % align == 0 &&
                   sb % 4 == 0 && sh % 4 == 0 && sn % 4 == 0 &&
                   osb % 4 == 0 && osh % 4 == 0 && osn % 4 == 0;
  if (vec)
    return launch<T, D, 4>(q, k, v, bias_t, region, o, B, H, N, nW, sb, sh,
                           sn, osb, osh, osn, stream);
  return launch<T, D, 1>(q, k, v, bias_t, region, o, B, H, N, nW, sb, sh, sn,
                         osb, osh, osn, stream);
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const float* bias_t, const int* region, void* o, int B,
                       int H, int N, int D, int nW, long long sb, long long sh,
                       long long sn, long long osb, long long osh,
                       long long osn, cudaStream_t stream) {
  if (D == 16)
    return launch_vec<T, 16>(q, k, v, bias_t, region, o, B, H, N, nW, sb, sh,
                             sn, osb, osh, osn, stream);
  if (D == 32)
    return launch_vec<T, 32>(q, k, v, bias_t, region, o, B, H, N, nW, sb, sh,
                             sn, osb, osh, osn, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, k, v share strides (sb, sh, sn) over
// [B, H, N, D] with unit stride on D; o has (osb, osh, osn).  bias_t:
// float32 [H, N, N] laid out [h][key][query]; region: int32 [nW, N] or
// NULL (no shift mask), B a multiple of nW.  D is 16 or 32.
extern "C" int window_attention(const void* q, const void* k, const void* v,
                                const void* bias_t, const void* region,
                                void* o, int dtype, int B, int H, int N, int D,
                                int nW, long long sb, long long sh,
                                long long sn, long long osb, long long osh,
                                long long osn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bt = static_cast<const float*>(bias_t);
  const int* reg = static_cast<const int*>(region);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(q, k, v, bt, reg, o, B, H, N, D, nW, sb, sh, sn,
                            osb, osh, osn, st);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(q, k, v, bt, reg, o, B, H, N, D, nW, sb,
                                    sh, sn, osb, osh, osn, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Fused (shifted-)window attention for Hopper (sm_90a) on the tensor cores,
// inference only: 3xTF32 in fp32, bf16 mma.sync in bf16.
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
// sums.  The TPU kernel read a dense (B or 1, H, N, N) additive bias; here
// the relative-position bias and the shifted-window region ids (nW, N)
// replace it (compute_attn_mask, cbim_tpu/models/swin_layers.py:90, builds
// its -100 mask from exactly these ids; a dense mask would be 470 MB at
// SwinUNETR's first stage).  A first small kernel writes the bias in base
// 2 and padded, bias2[h, i, j] = rel_bias[h, i, j] * log2(e) for i, j < N,
// -inf for keys j >= N and 0 for rows i >= N (each [Np, Np], Np = N
// rounded up to the 32-key chunk), so padded keys weigh nothing and padded
// rows stay finite without a test in the loop.
//
// What bounds it on the H100: operations.  4 N^2 D FLOPs per (window, head):
// 22.6 GFLOP at SwinUNETR's first stage of one 128^3 window (1000 x 3 x 343
// x 16).  In fp32, three TF32 passes at 495 TFLOP/s: 0.137 ms; in bf16 one
// pass at 989 TFLOP/s: 0.023 ms.  Beside the MMAs, every score takes an
// exp2 on the SFU (16 a clock per SM: 353 M there, about 0.09 ms) and about
// ten CUDA-core instructions (bias, mask, max, sum, the split of P), and the
// bias is read from L2 once per (window, head): 3000 x 352^2 x 4 B = 1.49
// GB a launch at the first stage.
//
// What the design does about it (FlashAttention-2-like, on mma.sync; the
// CUDA cores keep only the softmax):
// - A block owns one (window, head): every query row of it, in m16 tiles
//   that its warps walk (tile w, w + warps, ...).  It stages that window's
//   K and V once, with cp.async (16 bytes a copy: the wrapper refuses views
//   whose base or (batch, head, row) strides are not 16-byte multiples; the
//   packed qkv view's row stride, 3 H D values, qualifies), and its region
//   ids.  Keys past N are zeros.
// - fp32 (3xTF32, as conv3d_tf32.cu): K and V are split once, as they land,
//   into TF32 hi and lo planes (split_tf32 of mma_common.cuh, which keeps a
//   NaN in hi); each warp splits its q rows in registers once.  S = Q K^T is
//   three m16n8k8 passes (q_lo k_hi, q_hi k_lo, q_hi k_hi; the dropped
//   q_lo k_lo is 2^-22 of q k) over K = D, and O += P V three passes with P
//   split in registers.  smem: 4 Np D 4 bytes (176 KB at N = 343, D = 32);
//   the wrapper refuses N and D past 227 KB (N = 512 at D = 32) rather than
//   stream the keys.
// - bf16: m16n8k16 with bf16 q, k, v as stored and fp32 sums; P is rounded
//   to bf16 for P V (a relative error of 2^-9 in each weight: about 1e-3 of
//   max|o| at the Swin shapes in the CPU model, against the 2^-6 the
//   phase holds bf16 to), and the row sums stay fp32.
// - Fragments.  The mma sums over k, so any map of k slots onto d (in S) or
//   onto keys (in P V) works when A and B share it.  In S, k slots t and
//   t + 4 of k-step s are d = (D/4) t + 2 s and + 1 (TF32; in bf16 slots
//   2t.. and 2t+8.. are d = (D/4) t + 4 s + {0, 1} and + {2, 3}), so a lane
//   reads its D/4 values of a key row as one or two 16-byte loads.  P stays
//   in registers: S's C fragment holds keys 2t and 2t + 1 of an n8 tile,
//   which become the TF32 A fragment's k slots t and t + 4 (in bf16 the C
//   fragments of two n8 tiles are the A fragment of one k16 step as they
//   stand), and V's B fragment is loaded in the same key order.  In TF32
//   P V, n slot g of d-tile i is d = (D/8) g + i, so a lane's output values
//   of a row are D/4 consecutive d and its V reads D/8 consecutive values.
//   bf16 V goes through ldmatrix.trans.
// - Shared-memory layouts put every load of a warp phase on distinct banks:
//   fp32 planes XOR the 16-byte chunk index within a 128-byte line with the
//   line (D = 16: two key rows a line), bf16 V with its row (ldmatrix's
//   eight rows), bf16 K rows are read whole.
// - Online softmax per chunk of 32 keys, in base 2 (q k scaled by
//   log2(e) / sqrt(D) in the fma that adds the base-2 bias; 2^x is one
//   ex2.approx.ftz); the mask adds -100 log2(e).  Each chunk's P V goes
//   into fresh MMA accumulators that are added into the fp32 running O
//   after its rescale: the tensor cores truncate as they accumulate, so no
//   accumulator runs over more than 32 keys.  In fp32 at D = 16 they are
//   two sets of 16 keys (6 TF32 products each), which also halves the
//   chain of dependent MMAs.  Row sums are per lane until the end.
//
// The extern "C" entry launches both kernels on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue
// for what it does not take).

#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int kChunk = 32;  // keys per online-softmax step (4 n8 tiles)
constexpr float kLog2e = 1.4426950408889634f;
// the shifted-window mask value, -100 (swin_layers.py:122), in base 2
constexpr float kMaskLog2 = -100.0f * kLog2e;

// 2^x on the SFU, one instruction (exp2f adds a denormal fix-up around
// it); results below 2^-126 flush to 0: weights that small, beside the
// row's largest weight of 1, change no fp32 sum
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;\n" ::
          : "memory");
}

// Byte offset of 16-byte chunk c of key row r in a staged plane.  fp32
// planes (K and V, hi and lo alike): 128-byte lines of two rows (D = 16)
// or one (D = 32), the chunk index within the line XORed with the line.
template <int D>
__device__ __forceinline__ unsigned f32_off(int r, int c) {
  if constexpr (D == 16) {
    const unsigned line = r >> 1, L = ((r & 1) << 2) | c;
    return (line << 7) | ((L ^ ((line & 3) << 1)) << 4);
  } else {
    return (r << 7) | ((c ^ (r & 7)) << 4);
  }
}

// bf16 K: rows of D values as they come
template <int D>
__device__ __forceinline__ unsigned bf16_k_off(int r, int c) {
  return r * (D * 2) + (c << 4);
}

// bf16 V: the eight rows an ldmatrix reads at one chunk on distinct banks
template <int D>
__device__ __forceinline__ unsigned bf16_v_off(int r, int c) {
  if constexpr (D == 16)
    return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
  else
    return swz64(r, c);
}

// K and V of (window b, head h) into their planes at ``ks`` and ``vs``
// (fp32: f32_off; bf16: bf16_k_off, bf16_v_off), zeros past N; the region
// ids of window ``win`` into rs (0 past N); then a CTA barrier.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         const int* __restrict__ region,
                                         int* rs, unsigned ks, unsigned vs,
                                         long long in_off, long long sn,
                                         int N, int Np, long long win) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kVals = 16 / sizeof(T);  // values a 16-byte copy moves
  constexpr int kRowChunks = D / kVals;
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int e = tid; e < Np * kRowChunks; e += nthr) {
    const int r = e / kRowChunks, c = e % kRowChunks;
    const unsigned ko = kF32 ? f32_off<D>(r, c) : bf16_k_off<D>(r, c);
    const unsigned vo = kF32 ? f32_off<D>(r, c) : bf16_v_off<D>(r, c);
    if (r < N) {
      const long long src = in_off + r * sn + c * kVals;
      cp_async16(ks + ko, k + src);
      cp_async16(vs + vo, v + src);
    } else {
      const unsigned z[4] = {0u, 0u, 0u, 0u};
      sts_v4(ks + ko, z);
      sts_v4(vs + vo, z);
    }
  }
  if (region != nullptr) {
    const int* reg = region + win * N;
    for (int j = tid; j < Np; j += nthr) rs[j] = j < N ? reg[j] : 0;
  }
  cp_async_wait_all();
  __syncthreads();
}

// The online softmax of one chunk: s holds the base-2 scores of rows g
// (elements 0, 1) and g + 8 (2, 3) of 4 n8 tiles; they become p = 2^(s -
// m) with m the running row max over the quad's lanes; l (this lane's
// share of the row sums) and m are updated, and alpha takes the factor the
// running O is rescaled by.  Every chunk holds a key below N, whose score
// is finite, so m is finite after the first chunk, whose alpha is 2^-inf =
// 0.
__device__ __forceinline__ void softmax_chunk(float s[4][4], float m[2],
                                              float l[2], float alpha[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = fast_exp2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(s[j][e] - m[e >> 1]);
    l[0] += s[j][0] + s[j][1];
    l[1] += s[j][2] + s[j][3];
  }
}

// s = q k * sscale + bias2 (- 100 log2 e where the region ids differ) for
// the chunk's 4 n8 tiles: bias rows ``b0``/``b1`` (rows g, g + 8, offset
// to column 2 t), keys n0 + 8 j + 2 t, + 1
template <bool MASKED>
__device__ __forceinline__ void scores(float s[4][4], const float* b0,
                                       const float* b1, const int* rs,
                                       int n0, int t, int ri0, int ri1,
                                       float sscale) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x0 = __ldg(reinterpret_cast<const float2*>(b0 + n0 + 8 * j));
    const float2 x1 = __ldg(reinterpret_cast<const float2*>(b1 + n0 + 8 * j));
    s[j][0] = fmaf(s[j][0], sscale, x0.x);
    s[j][1] = fmaf(s[j][1], sscale, x0.y);
    s[j][2] = fmaf(s[j][2], sscale, x1.x);
    s[j][3] = fmaf(s[j][3], sscale, x1.y);
    if constexpr (MASKED) {
      const int2 rk = *reinterpret_cast<const int2*>(rs + n0 + 8 * j + 2 * t);
      s[j][0] += rk.x != ri0 ? kMaskLog2 : 0.f;
      s[j][1] += rk.y != ri0 ? kMaskLog2 : 0.f;
      s[j][2] += rk.x != ri1 ? kMaskLog2 : 0.f;
      s[j][3] += rk.y != ri1 ? kMaskLog2 : 0.f;
    }
  }
}

// -------------------------------------------------------------- fp32 3xTF32

// smem: K hi, K lo, V hi, V lo (each Np x D fp32), region ids [Np].
// grid.x = B * H ((window, head), head fastest); blockDim = 32 x warps.
template <int D, bool MASKED, int WARPS, int MINB>
__global__ void __launch_bounds__(WARPS * 32, MINB)
window_attention_tf32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ bias2,
                             const int* __restrict__ region,
                             float* __restrict__ o, int H, int N, int Np,
                             int nW, long long sb, long long sh, long long sn,
                             long long osb, long long osh, long long osn,
                             float sscale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const unsigned plane = (unsigned)Np * D * 4;
  const unsigned khi = smem_u32(smem), vhi = khi + 2 * plane;
  int* rs = reinterpret_cast<int*>(smem + 4 * plane);
  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const long long in_off = b * sb + (long long)h * sh;
  stage_kv<float, D>(k, v, MASKED ? region : nullptr,
                                             rs, khi, vhi, in_off, sn, N, Np,
                                             b % nW);
  // the split, once: hi in place, lo one plane on (K's after K hi, V's
  // after V hi)
  {
    const int n = (int)(plane / 16);
    for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
      const unsigned at = (e < n ? khi : vhi - 16 * n) + 16 * e;
      unsigned x[4], hi[4], lo[4];
      lds_v4(at, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) split_tf32(x[u], hi[u], lo[u]);
      sts_v4(at, hi);
      sts_v4(at + plane, lo);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5, m_tiles = (N + 15) / 16;
  const float* bh = bias2 + (long long)h * Np * Np + 2 * t;
  constexpr int KS = D / 8;  // k-steps of S; d-tiles of O
  // P V's independent accumulator sets a chunk (k-step j into set j %
  // kPvSets), added in fp32: at D = 16 two, so no chain of dependent MMAs
  // runs over more than 6 products (its 2 d-tiles give little else to
  // interleave); at D = 32 one (4 d-tiles; a second set cost registers and
  // time on the H100)
  constexpr int kPvSets = D == 16 ? 2 : 1;

  for (int mt = warp; mt < m_tiles; mt += nwarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    // q: rows r0, r1 (zeros past N), d = (D/4) t .. + D/4, split once
    unsigned qh[KS][4], ql[KS][4];
    {
      float qv[2][D / 4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? r1 : r0;
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < N)
            x = *reinterpret_cast<const float4*>(q + in_off + row * sn +
                                                 (D / 4) * t + 4 * u);
          qv[r][4 * u] = x.x;
          qv[r][4 * u + 1] = x.y;
          qv[r][4 * u + 2] = x.z;
          qv[r][4 * u + 3] = x.w;
        }
      }
      // A (m16 x k8): a0 (g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3
      // (g + 8, t + 4); slot t of k-step s is d = (D/4) t + 2 s, t + 4 is
      // d + 1
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const float a[4] = {qv[0][2 * s], qv[1][2 * s], qv[0][2 * s + 1],
                            qv[1][2 * s + 1]};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          split_tf32(__float_as_uint(a[u]), qh[s][u], ql[s][u]);
      }
    }
    const int ri0 = MASKED ? rs[r0] : 0, ri1 = MASKED ? rs[r1] : 0;
    const float* b0 = bh + (long long)r0 * Np;
    const float* b1 = bh + (long long)r1 * Np;

    float oacc[KS][4];
#pragma unroll
    for (int i = 0; i < KS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll 1
    for (int n0 = 0; n0 < Np; n0 += kChunk) {
      // S: n8 tile j has keys n0 + 8 j + g as its columns
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = n0 + 8 * j + g;
        unsigned kh[D / 4], kl[D / 4];
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          const unsigned at = khi + f32_off<D>(key, (D / 16) * t + u);
          lds_v4(at, kh + 4 * u);
          lds_v4(at + plane, kl + 4 * u);
        }
        // the small products first, from zeros, then the large one
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks == 0)
            mma_tf32<true>(s[j], ql[ks], kh[2 * ks], kh[2 * ks + 1]);
          else
            mma_tf32(s[j], ql[ks], kh[2 * ks], kh[2 * ks + 1]);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma_tf32(s[j], qh[ks], kl[2 * ks], kl[2 * ks + 1]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma_tf32(s[j], qh[ks], kh[2 * ks], kh[2 * ks + 1]);
      }
      scores<MASKED>(s, b0, b1, rs, n0, t, ri0, ri1, sscale);
      float alpha[2];
      softmax_chunk(s, m, l, alpha);
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        oacc[i][0] *= alpha[0];
        oacc[i][1] *= alpha[0];
        oacc[i][2] *= alpha[1];
        oacc[i][3] *= alpha[1];
      }
      // P V into fresh accumulators: k-step j is S's n8 tile j, k slot t
      // its key 2 t (C element 0 / 2), slot t + 4 key 2 t + 1 (1 / 3)
      float pvs[kPvSets][KS][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // P lies in [0, 1] (a NaN score reaches the output through l), so
        // its split takes no NaN test
        const float a[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        unsigned ph[4], pl[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ph[u] = tf32_rna_bits(__float_as_uint(a[u]));
          pl[u] = tf32_rna_bits(
              __float_as_uint(a[u] - __uint_as_float(ph[u])));
        }
        // B: V rows key (slot t) and key + 1 (slot t + 4), columns d =
        // (D/8) g + i of d-tile i
        const int key = n0 + 8 * j + 2 * t;
        unsigned vh[2][KS], vl[2][KS];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (D == 16) {
            const unsigned at =
                vhi + f32_off<D>(key + r, g >> 1) + 8 * (g & 1);
            lds_v2(at, vh[r]);
            lds_v2(at + plane, vl[r]);
          } else {
            const unsigned at = vhi + f32_off<D>(key + r, g);
            lds_v4(at, vh[r]);
            lds_v4(at + plane, vl[r]);
          }
        }
        float (*pv)[4] = pvs[j % kPvSets];
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          if (j < kPvSets)
            mma_tf32<true>(pv[i], pl, vh[0][i], vh[1][i]);
          else
            mma_tf32(pv[i], pl, vh[0][i], vh[1][i]);
        }
#pragma unroll
        for (int i = 0; i < KS; ++i) mma_tf32(pv[i], ph, vl[0][i], vl[1][i]);
#pragma unroll
        for (int i = 0; i < KS; ++i) mma_tf32(pv[i], ph, vh[0][i], vh[1][i]);
      }
#pragma unroll
      for (int c = 0; c < kPvSets; ++c)
#pragma unroll
        for (int i = 0; i < KS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[i][e] += pvs[c][i][e];
    }

    // the row sums over the quad, then rows r0 (C elements 0, 1) and r1
    // (2, 3): d-tile i's element 0 is d = (D/4) t + i, element 1 is
    // (D/4) t + D/8 + i
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r ? r1 : r0;
      if (row < N) {
        const float inv = 1.f / l[r];
        float out[D / 4];
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          out[i] = oacc[i][2 * r] * inv;
          out[KS + i] = oacc[i][2 * r + 1] * inv;
        }
        float* dst = o + b * osb + (long long)h * osh + row * osn + (D / 4) * t;
#pragma unroll
        for (int u = 0; u < D / 16; ++u)
          *reinterpret_cast<float4*>(dst + 4 * u) = make_float4(
              out[4 * u], out[4 * u + 1], out[4 * u + 2], out[4 * u + 3]);
      }
    }
  }
}

// ------------------------------------------------------------------- bf16

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// smem: K, V (each Np x D bf16), region ids [Np]
template <int D, bool MASKED, int WARPS, int MINB>
__global__ void __launch_bounds__(WARPS * 32, MINB)
window_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias2,
                             const int* __restrict__ region,
                             __nv_bfloat16* __restrict__ o, int H, int N,
                             int Np, int nW, long long sb, long long sh,
                             long long sn, long long osb, long long osh,
                             long long osn, float sscale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const unsigned plane = (unsigned)Np * D * 2;
  const unsigned ks = smem_u32(smem), vs = ks + plane;
  int* rs = reinterpret_cast<int*>(smem + 2 * plane);
  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const long long in_off = b * sb + (long long)h * sh;
  stage_kv<__nv_bfloat16, D>(
      k, v, MASKED ? region : nullptr, rs, ks, vs, in_off, sn, N, Np, b % nW);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, r8 = lane & 7;
  const int nwarps = blockDim.x >> 5, m_tiles = (N + 15) / 16;
  const float* bh = bias2 + (long long)h * Np * Np + 2 * t;
  constexpr int KS = D / 16;  // k16 steps of S
  constexpr int DT = D / 8;   // d-tiles of O

  for (int mt = warp; mt < m_tiles; mt += nwarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    // q rows r0, r1 (zeros past N): d = (D/4) t .., D/8 packed pairs
    unsigned qw[2][D / 8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      const __nv_bfloat16* src = q + in_off + row * sn + (D / 4) * t;
      if constexpr (D == 16) {
        uint2 x = make_uint2(0u, 0u);
        if (row < N) x = *reinterpret_cast<const uint2*>(src);
        qw[r][0] = x.x;
        qw[r][1] = x.y;
      } else {
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (row < N) x = *reinterpret_cast<const uint4*>(src);
        qw[r][0] = x.x;
        qw[r][1] = x.y;
        qw[r][2] = x.z;
        qw[r][3] = x.w;
      }
    }
    // A (m16 x k16) of k-step s: slots 2t, 2t + 1 are d = (D/4) t + 4 s +
    // {0, 1} (pair 2 s), slots 2t + 8, 2t + 9 the next pair
    unsigned qa[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = qw[0][2 * s];
      qa[s][1] = qw[1][2 * s];
      qa[s][2] = qw[0][2 * s + 1];
      qa[s][3] = qw[1][2 * s + 1];
    }
    const int ri0 = MASKED ? rs[r0] : 0, ri1 = MASKED ? rs[r1] : 0;
    const float* b0 = bh + (long long)r0 * Np;
    const float* b1 = bh + (long long)r1 * Np;

    float oacc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll 1
    for (int n0 = 0; n0 < Np; n0 += kChunk) {
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned at = ks + bf16_k_off<D>(n0 + 8 * j + g, 0) + (D / 2) * t;
        unsigned kw[D / 8];
        if constexpr (D == 16)
          lds_v2(at, kw);
        else
          lds_v4(at, kw);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < KS; ++s2)
          mma_bf16(s[j], qa[s2], kw[2 * s2], kw[2 * s2 + 1]);
      }
      scores<MASKED>(s, b0, b1, rs, n0, t, ri0, ri1, sscale);
      float alpha[2];
      softmax_chunk(s, m, l, alpha);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        oacc[i][0] *= alpha[0];
        oacc[i][1] *= alpha[0];
        oacc[i][2] *= alpha[1];
        oacc[i][3] *= alpha[1];
      }
      float pv[DT][4];
#pragma unroll
      for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
      // k16 step kk: S tiles 2 kk and 2 kk + 1 are its A fragment; V's B
      // fragments by ldmatrix.trans, matrices (keys 0-7, d-tile i), (keys
      // 8-15, i), (0-7, i + 1), (8-15, i + 1)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = n0 + 16 * kk + (mat & 1) * 8 + r8;
#pragma unroll
        for (int i = 0; i < DT; i += 2) {
          unsigned bv[4];
          ldsm_x4_t(vs + bf16_v_off<D>(key, i + (mat >> 1)), bv);
          mma_bf16(pv[i], pa, bv[0], bv[1]);
          mma_bf16(pv[i + 1], pa, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[i][e] += pv[i][e];
    }

    // rows r0 (C elements 0, 1) and r1 (2, 3): d-tile i holds d = 8 i +
    // 2 t, + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r ? r1 : r0;
      if (row < N) {
        const float inv = 1.f / l[r];
        __nv_bfloat16* dst =
            o + b * osb + (long long)h * osh + row * osn + 2 * t;
#pragma unroll
        for (int i = 0; i < DT; ++i)
          *reinterpret_cast<unsigned*>(dst + 8 * i) =
              pack_bf16(oacc[i][2 * r] * inv, oacc[i][2 * r + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// The base-2, padded bias of the attention kernels from the caller's
// rel_bias (fp32 [H, N, N] at element strides rsh, rsi, rsj, such as the
// permuted view of a gathered bias table):
//   bias2[h, i, j] = rel_bias[h, i, j] * log2(e)  (i, j < N)
//                  = -inf                          (j >= N)
//                  = 0                             (i >= N, j < N)
// bias2 [H, Np, Np] fp32 contiguous.  One row (h, i) a block (grid.x = H
// Np), its threads along j; 3 x 352^2 values at SwinUNETR's first stage.
__global__ void __launch_bounds__(128)
base2_bias_kernel(const float* __restrict__ rel_bias, float* __restrict__ b2,
                  int N, int Np, long long rsh, long long rsi,
                  long long rsj) {
  const int i = blockIdx.x % Np, h = blockIdx.x / Np;
  const float* in = rel_bias + h * rsh + (long long)i * rsi;
  float* out = b2 + (long long)blockIdx.x * Np;
  for (int j = threadIdx.x; j < Np; j += blockDim.x) {
    float val = -INFINITY;
    if (j < N) val = i < N ? in[j * rsj] * kLog2e : 0.f;
    out[j] = val;
  }
}

// warps per block and blocks per SM the launch bounds ask for: 8 warps, and
// at D = 16 two blocks an SM in fp32 (92 KB of staged planes each at N =
// 343) and three in bf16 (SwinUNETR's last stage, 324 blocks, then fits
// one wave); fp32 at D = 32 takes 176 KB, one block, of 12 warps
template <typename T, int D>
struct Shape {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWarps = kF32 && D == 32 ? 12 : 8;
  static constexpr int kMinBlocks =
      kF32 ? (D == 32 ? 1 : 2) : (D == 16 ? 3 : 2);
  static constexpr int kParts = kF32 ? 2 : 1;  // hi and lo planes in fp32
};

// The bytes a block stages: K and V (fp32: hi and lo planes of each) and
// the region ids, 2 kParts Np D sizeof(T) + 4 Np, at most kMaxSmem (an
// H100 block's dynamic shared memory after opt-in).  The wrapper's
// kernel_smem_bytes (ops/kernels/window_attention.py) is this formula and
// refuses a larger window with an error before any launch; the check in
// launch only guards it.
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T, int D, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias2, const int* region, void* o, int B,
                   int H, int N, int Np, int nW, long long sb, long long sh,
                   long long sn, long long osb, long long osh, long long osn,
                   cudaStream_t stream) {
  using S = Shape<T, D>;
  const long long blocks = (long long)B * H;
  const int m_tiles = (N + 15) / 16;
  const int warps = m_tiles < S::kWarps ? m_tiles : S::kWarps;
  const size_t smem =
      2 * S::kParts * (size_t)Np * D * sizeof(T) + (size_t)Np * 4;
  if (blocks >= (1LL << 31) || smem > kMaxSmem) return cudaErrorInvalidValue;
  constexpr int W = S::kWarps, MB = S::kMinBlocks;
  const void* kernel;
  if constexpr (S::kF32)
    kernel = (const void*)window_attention_tf32_kernel<D, MASKED, W, MB>;
  else
    kernel = (const void*)window_attention_bf16_kernel<D, MASKED, W, MB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float sscale = kLog2e / sqrtf((float)D);
  if constexpr (S::kF32)
    window_attention_tf32_kernel<D, MASKED, W, MB>
        <<<(unsigned)blocks, warps * 32, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), bias2, region,
            static_cast<float*>(o), H, N, Np, nW, sb, sh, sn, osb, osh, osn,
            sscale);
  else
    window_attention_bf16_kernel<D, MASKED, W, MB>
        <<<(unsigned)blocks, warps * 32, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), bias2, region,
            static_cast<__nv_bfloat16*>(o), H, N, Np, nW, sb, sh, sn, osb,
            osh, osn, sscale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mask(const void* q, const void* k, const void* v,
                        const float* bias2, const int* region, void* o, int B,
                        int H, int N, int Np, int nW, long long sb,
                        long long sh, long long sn, long long osb,
                        long long osh, long long osn, cudaStream_t stream) {
  if (region != nullptr)
    return launch<T, D, true>(q, k, v, bias2, region, o, B, H, N, Np, nW, sb,
                              sh, sn, osb, osh, osn, stream);
  return launch<T, D, false>(q, k, v, bias2, region, o, B, H, N, Np, nW, sb,
                             sh, sn, osb, osh, osn, stream);
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const float* bias2, const int* region, void* o, int B,
                       int H, int N, int Np, int D, int nW, long long sb,
                       long long sh, long long sn, long long osb,
                       long long osh, long long osn, cudaStream_t stream) {
  if (D == 16)
    return launch_mask<T, 16>(q, k, v, bias2, region, o, B, H, N, Np, nW, sb,
                              sh, sn, osb, osh, osn, stream);
  if (D == 32)
    return launch_mask<T, 32>(q, k, v, bias2, region, o, B, H, N, Np, nW, sb,
                              sh, sn, osb, osh, osn, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, k, v share strides (sb, sh, sn) over
// [B, H, N, D] with unit stride on D, 16-byte aligned bases and 16-byte
// multiples for the strides; o has (osb, osh, osn), with 16-byte (fp32) or
// 4-byte (bf16) aligned rows.  rel_bias: float32 [H, N, N] at strides
// (rsh, rsi, rsj); bias2: float32 scratch of H * Np * Np values (16-byte
// aligned), which a first kernel fills with the base-2, padded bias
// (above), Np = N rounded up to 32; region: int32 [nW, N] or NULL (no
// shift mask), B a multiple of nW.  D is 16 or 32.
extern "C" int window_attention(const void* q, const void* k, const void* v,
                                const void* rel_bias, const void* region,
                                void* bias2, void* o, int dtype, int B, int H,
                                int N, int Np, int D, int nW, long long sb,
                                long long sh, long long sn, long long rsh,
                                long long rsi, long long rsj, long long osb,
                                long long osh, long long osn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* bt = static_cast<float*>(bias2);
  const int* reg = static_cast<const int*>(region);
  const long long elt = dtype == 0 ? 4 : 2;
  if (N < 1 || Np < N || Np % kChunk != 0 || nW < 1 || B % nW != 0 ||
      (uintptr_t)q % 16 != 0 || (uintptr_t)k % 16 != 0 ||
      (uintptr_t)v % 16 != 0 || (sb * elt) % 16 != 0 ||
      (sh * elt) % 16 != 0 || (sn * elt) % 16 != 0 ||
      (uintptr_t)bias2 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)H * Np >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  base2_bias_kernel<<<(unsigned)(H * Np), 128, 0, st>>>(
      static_cast<const float*>(rel_bias), bt, N, Np, rsh, rsi, rsj);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    err = launch_dim<float>(q, k, v, bt, reg, o, B, H, N, Np, D, nW, sb, sh,
                            sn, osb, osh, osn, st);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(q, k, v, bt, reg, o, B, H, N, Np, D, nW,
                                    sb, sh, sn, osb, osh, osn, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Shared by the tensor-core 3x3x3 forwards (conv3d_tc.cu: the plain conv
// and its dgrad; conv3d_na_tc.cu: the fused preact conv): the output box and
// its TMA halo box, the layout of a (kd, kh) step of packed weights, and the
// first small kernel that packs torch's weights into that layout.

#pragma once

#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCc = 32;          // channels of a staged chunk (64-byte rows)
constexpr int kTD = 4, kTH = 8;  // output box (d, h); its w is 4 * MT
constexpr int kHaloStages = 2, kWStages = 3;
constexpr int kSMs = 132;        // H100 SXM

// The (kTD, kTH, 4 MT) output box and its halo (one voxel more on each
// side): HD x HH x HW rows of kCc channels, one 1024-byte aligned stage.
template <int MT>
struct Box {
  static constexpr int TW = 4 * MT;
  static constexpr int HD = kTD + 2, HH = kTH + 2, HW = TW + 2;
  static constexpr int rows = HD * HH * HW;
  static constexpr int bytes = rows * kCc * 2;
  static constexpr int stage = (bytes + 1023) / 1024 * 1024;
};

template <int BN>
struct WTile {
  static constexpr int pitch = BN + 8;           // bf16 a row
  static constexpr int elems = 3 * kCc * pitch;  // one (kd, kh): 3 kw taps
  static constexpr int bytes = elems * 2;
};

template <int BN, int MT>
constexpr int smem_bytes() {
  return kHaloStages * Box<MT>::stage + kWStages * WTile<BN>::bytes +
         8 * (kHaloStages + kWStages) + 1024;
}

// The weights in the kernels' layout: wpk[n tile][chunk][tap][k][n] (bn +
// 8 values a row) from torch's w[F][C][27]; with ``flip`` w is the forward's
// [C][F][27] and the packing is flip_swap's (the dgrad's weights: taps
// reversed, in and out swapped).  Zeros past C, F and bn.
__global__ void __launch_bounds__(256)
conv3d_tc_pack_kernel(const bf16* __restrict__ w, bf16* __restrict__ wpk,
                      int C, int F, int bn, int n_chunks, int flip,
                      long long total) {
  const int pitch = bn + 8;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long r = e;
    const int n = (int)(r % pitch);
    r /= pitch;
    const int k = (int)(r % kCc);
    r /= kCc;
    const int tap = (int)(r % 27);
    r /= 27;
    const int c = (int)(r % n_chunks) * kCc + k;
    const int f = (int)(r / n_chunks) * bn + n;
    bf16 v = __float2bfloat16_rn(0.f);
    if (n < bn && c < C && f < F)
      v = flip ? w[((long long)c * F + f) * 27 + 26 - tap]
               : w[((long long)f * C + c) * 27 + tap];
    wpk[e] = v;
  }
}

inline int pack_weights(const void* w, void* wpk, int C, int F, int bn,
                        int flip, cudaStream_t st) {
  const int n_chunks = (C + kCc - 1) / kCc;
  const long long total =
      (long long)((F + bn - 1) / bn) * n_chunks * 27 * kCc * (bn + 8);
  long long blocks = (total + 255) / 256;
  if (blocks > kSMs * 8) blocks = kSMs * 8;
  conv3d_tc_pack_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpk), C, F, bn,
      n_chunks, flip, total);
  return (int)cudaGetLastError();
}

}  // namespace

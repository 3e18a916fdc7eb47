// The norm-act pass of the tensor-core fused preact conv (conv3d_na_tc.cu,
// conv3d_wgrad_na_tc.cu; in fp32 conv3d_tf32.cu): a staged x halo that TMA filled with raw x
// becomes act((x - mean[b, c]) * rstd[b, c]) in place, in shared memory,
// after it lands and before any ldmatrix reads it.  TMA cannot transform in
// flight, so this is a pass over shared memory: each staged value is
// normalised once per stage, where the CUDA-core kernels (conv3d.cu,
// conv3d_wgrad.cu) normalise it once per tap.
//
// The stage is rows of 32 bf16 (or 16 fp32) channels (64 bytes, 4 chunks
// of 16 bytes), swizzled by CU_TENSOR_MAP_SWIZZLE_64B: logical chunk j of
// row r sits at physical chunk j ^ ((r >> 1) & 3) (swz64).
// - A thread owns one logical chunk j (8 bf16 or 4 fp32 channels, whose
//   mean and rstd it holds in registers) and walks rows r0, r0 + R, ... with R a multiple
//   of 8, so its rows share one physical chunk; a warp's 16-byte accesses
//   cover 512 contiguous bytes, without bank conflicts.
// - SAME padding applies to the normalised input: TMA's zero fill of rows
//   outside the volume (the halo's border, the ragged D/H/W edge) stays 0,
//   not act(-mean * rstd).  So the pass needs each row's (d, h, w).
// - Channels past C keep TMA's zeros: C % 8 == 0, so a chunk lies wholly
//   inside or past C, and mean and rstd are never read past C.
// - bf16 values round to bf16 once, as norm_act<bf16> and the unfused
//   inorm_apply do; fp32 values stay fp32 (na_store_f32).
// - Proxies: the pass writes through the generic proxy into memory that TMA
//   (the async proxy) wrote and will refill.  Every thread that wrote a
//   stage fences (fence_proxy_async) before the barrier that precedes its
//   refill, and a CTA barrier separates the pass from the stage's first
//   ldmatrix.

#pragma once

#include "conv3d_common.cuh"
#include "mma_common.cuh"

namespace {

__device__ __forceinline__ uint4 ld_shared_v4(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// the store only where ``ok``: a predicated instruction, no branch
__device__ __forceinline__ void st_shared_v4_if(unsigned addr, uint4 v,
                                                bool ok) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %5, 0;\n"
      "@p st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
      "}\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)ok)
      : "memory");
}

// mean and rstd of 8 consecutive channels at offset ``at`` of the [B, C]
// statistics (at % 8 == 0, 16-byte aligned rows) into registers
__device__ __forceinline__ void na_stats(const float* __restrict__ mean,
                                         const float* __restrict__ rstd,
                                         long long at, float m[8],
                                         float r[8]) {
  load_vec<float, 4>(mean + at, m);
  load_vec<float, 4>(mean + at + 4, m + 4);
  load_vec<float, 4>(rstd + at, r);
  load_vec<float, 4>(rstd + at + 4, r + 4);
}

// two bf16 values of a packed pair through the norm-act, rounded once
template <int ACT>
__device__ __forceinline__ unsigned na_pair(unsigned u, float m0, float r0,
                                            float m1, float r1) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162 o = __floats2bfloat162_rn(
      norm_act<float, ACT>(__low2float(h), m0, r0),
      norm_act<float, ACT>(__high2float(h), m1, r1));
  return *reinterpret_cast<const unsigned*>(&o);
}

// One 16-byte chunk of a staged halo on its way through the norm-act: its
// address, the raw values, and whether it is normalised at all.  A kernel
// issues na_load early and na_store late, with MMAs between them, so the
// CUDA-core chain fills the MMAs' latency (both branch-free, so the
// compiler can interleave them with the MMAs of one basic block).
struct NaChunk {
  unsigned addr;
  bool ok;
  uint4 v;
};

// Logical chunk j of halo row r (of ``rows``) of the stage at ``stage``;
// the row is voxel (gz0, gy0, gx0) + (r / (HH HW), r / HW % HH, r % HW).
// ok: the row lies inside the D x H x W volume and ``ch_ok`` (channels
// below C); rows past ``rows`` load row rows - 1 and are not ok.
template <int HH, int HW>
__device__ __forceinline__ NaChunk na_load(unsigned stage, int r, int rows,
                                           int j, bool ch_ok, int gz0,
                                           int gy0, int gx0, int D, int H,
                                           int W) {
  const int rr = min(r, rows - 1);
  const int gz = gz0 + rr / (HH * HW), gy = gy0 + rr / HW % HH,
            gx = gx0 + rr % HW;
  NaChunk c;
  c.ok = ch_ok && r < rows && (unsigned)gz < (unsigned)D &&
         (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
  c.addr = stage + swz64(rr, j);
  c.v = ld_shared_v4(c.addr);
  return c;
}

// the chunk's 8 values through the norm-act (m, rs: their statistics),
// stored back in place where ok
template <int ACT>
__device__ __forceinline__ void na_store(const NaChunk& c, const float m[8],
                                         const float rs[8]) {
  uint4 o;
  o.x = na_pair<ACT>(c.v.x, m[0], rs[0], m[1], rs[1]);
  o.y = na_pair<ACT>(c.v.y, m[2], rs[2], m[3], rs[3]);
  o.z = na_pair<ACT>(c.v.z, m[4], rs[4], m[5], rs[5]);
  o.w = na_pair<ACT>(c.v.w, m[6], rs[6], m[7], rs[7]);
  st_shared_v4_if(c.addr, o, c.ok);
}

// the same for a chunk of 4 fp32 values
template <int ACT>
__device__ __forceinline__ void na_store_f32(const NaChunk& c,
                                             const float m[4],
                                             const float rs[4]) {
  uint4 o;
  o.x = __float_as_uint(
      norm_act<float, ACT>(__uint_as_float(c.v.x), m[0], rs[0]));
  o.y = __float_as_uint(
      norm_act<float, ACT>(__uint_as_float(c.v.y), m[1], rs[1]));
  o.z = __float_as_uint(
      norm_act<float, ACT>(__uint_as_float(c.v.z), m[2], rs[2]));
  o.w = __float_as_uint(
      norm_act<float, ACT>(__uint_as_float(c.v.w), m[3], rs[3]));
  st_shared_v4_if(c.addr, o, c.ok);
}

}  // namespace

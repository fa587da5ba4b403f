// Register-fragment helpers shared by the kernels: the shared-memory
// address of a pointer, bf16 packing (flash_attn.cu, motion_attn.cu) and
// the accumulator-to-A-fragment packing (acc_to_a) that feeds a wgmma
// accumulator back to the tensor cores as the register A operand
// (flash_attn.cu's d <= 160 path, flash_attn_bwd.cu).
//
// Per-warp fragment layouts of a wgmma m64nNk16 (bf16 in, f32 accumulate;
// PTX ISA, "Register Fragments"), warp w of the warpgroup owning rows
// 16 w .. 16 w + 15, lane = 4 g + q:
//   A (16 x 16 of the warp's rows): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..),
//                                   a2 = (g, 8+2q..), a3 = (g+8, 8+2q..)
//   D (f32), per 8 columns c:       c0, c1 = (g, 2q), (g, 2q+1);
//                                   c2, c3 = (g+8, 2q), (g+8, 2q+1)
// So an accumulator over 16 columns (two groups of 8) converts to one A
// fragment by packing (c0, c1), (c2, c3) of the first and then the second
// group: P and dS are fed back to the tensor cores without leaving registers.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16 columns [16 kk, 16 kk + 16) of an accumulator held as
// groups of 8 columns c[8 kk .. 8 kk + 8) (two groups of four registers).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

}  // namespace mma_tiles

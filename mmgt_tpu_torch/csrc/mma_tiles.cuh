// Warp-level building blocks of flash_attn.cu's d = 512 variant: 16-byte
// cp.async copies with zero fill (also group_norm.cu's), ldmatrix fragment
// loads, mma.sync m16n8k16 (bf16 in, f32 accumulate) and bf16 packing. The
// accumulator-to-A-fragment packing (acc_to_a) is also the register A
// operand of wgmma (flash_attn.cu's d <= 160 path, flash_attn_bwd.cu),
// whose per-warp layout is this one.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + q.
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..), a2 = (g, 8+2q..),
//                           a3 = (g+8, 8+2q..)
//   B (16 x 8, "col"):      b0 = (k 2q..2q+1, n g), b1 = (k 8+2q.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2q), (g, 2q+1); c2, c3 = (g+8, 2q), (g+8, 2q+1)
// So an accumulator tile over 16 columns (two n8 tiles) converts to one A
// fragment by packing (c0, c1), (c2, c3) of the first and then the second
// tile: P and dS are fed back to the tensor cores without leaving registers.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid` false writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[0:4] += a . b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16 columns [16 kk, 16 kk + 16) of an accumulator held as
// n8 tiles c[8 kk .. 8 kk + 8) (two tiles of four registers).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// Lane address offsets (row, column) for ldmatrix.x4 over a 16 x 16 block:
//   A operand, rows r .. r+15 and columns k .. k+15 (row-major source):
//     row r + (lane & 15), column k + (lane >> 4) * 8
//   B operand from an [n][k] source (two n8 tiles, non-transposed):
//     row n + (lane & 7) + (lane >> 4) * 8, column k + ((lane >> 3) & 1) * 8
//   B operand from a [k][n] source (two n8 tiles, .trans):
//     row k + (lane & 7) + ((lane >> 3) & 1) * 8, column n + (lane >> 4) * 8
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }

}  // namespace mma_tiles

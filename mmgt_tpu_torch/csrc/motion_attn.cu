// K4 (frame-attention part): multi-head attention over the F frames of each
// spatial token, for Hopper (sm_90a).
//
// Replaces, together with the LN/projection GEMMs of csrc/ln_proj.cu, the
// TPU kernel mmgt_tpu/ops/motion_attention.py:_motion_kernel:
//     out = x + W_o . MHA_frames(LN(x) * g + b + pe) + b_o.
// The caller (mmgt_tpu_torch/ops/motion_attention.py) launches
//   1. ln_proj.cu's row statistics and its GEMM with the LN + pe prologue,
//      writing q and k in f32 (as the TPU kernel keeps them) and v in bf16;
//   2. this kernel: per (row b, token l, head h), logits over the F x F
//      frame pairs from exact f32 products, f32 softmax, the probabilities
//      rounded to bf16, and P . V summed in f32, written as bf16;
//   3. ln_proj.cu's GEMM with the bias + residual epilogue for W_o.
//
// Bound: F <= 32 keeps the attention itself tiny (4*F*F*d flops per item
// against (2*4 + 2)*F*d bytes of q/k/v in and 2*F*d out, ~1 flop/byte), so
// this kernel is bound by the bytes it moves. Design: one warp per
// (b, l, h) item stages its F x d slices of q, k, v in shared memory with
// coalesced loads, the 32 lanes share the F*F logits, and the output is
// written back lane-contiguous. Every token count L is taken (the TPU's
// L % 128 gate was a lane-tiling rule).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__host__ __device__ inline int per_warp_floats(int F, int D) {
  return 2 * F * (D + 1) + F * D + F * (F + 1);
}

__global__ void frame_attn(const float* __restrict__ q, const float* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int B, int F, int L, int H, int D, float scale, int wpb) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * wpb + warp;
  const long long items = (long long)B * L * H;
  if (item >= items) return;
  const int h = (int)(item % H);
  const long long bl = item / H;
  const int l = (int)(bl % L);
  const int b = (int)(bl / L);
  const int C = H * D;
  const int DS = D + 1;

  float* qs = smem + (long long)warp * per_warp_floats(F, D);
  float* ks = qs + F * DS;
  float* vs = ks + F * DS;
  float* ps = vs + F * D;

  for (int f = 0; f < F; ++f) {
    const long long base = (((long long)b * F + f) * L + l) * C + (long long)h * D;
    for (int c = lane; c < D; c += 32) {
      qs[f * DS + c] = q[base + c];
      ks[f * DS + c] = k[base + c];
      vs[f * D + c] = __bfloat162float(v[base + c]);
    }
  }
  __syncwarp();
  for (int pidx = lane; pidx < F * F; pidx += 32) {
    const int i = pidx / F, j = pidx % F;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s += qs[i * DS + c] * ks[j * DS + c];
    ps[i * (F + 1) + j] = s * scale;
  }
  __syncwarp();
  if (lane < F) {
    float* row = ps + lane * (F + 1);
    float m = row[0];
    for (int j = 1; j < F; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < F; ++j) {
      const float e = __expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < F; ++j) row[j] = __bfloat162float(__float2bfloat16(row[j] / sum));
  }
  __syncwarp();
  for (int i = 0; i < F; ++i) {
    const long long base = (((long long)b * F + i) * L + l) * C + (long long)h * D;
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < F; ++j) acc += ps[i * (F + 1) + j] * vs[j * D + c];
      o[base + c] = __float2bfloat16(acc);
    }
  }
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int mmgt_frame_attn(const void* q, const void* k, const void* v, void* o,
                               int B, int F, int L, int H, int D, float scale,
                               void* stream) {
  if (F < 1 || F > 32 || D < 1) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * L * H;
  if (items == 0) return 0;
  const size_t per_warp = (size_t)per_warp_floats(F, D) * sizeof(float);
  int wpb = 4;
  while (wpb > 1 && per_warp * wpb > 200 * 1024) --wpb;
  const size_t smem = per_warp * wpb;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(frame_attn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (items + wpb - 1) / wpb;
  frame_attn<<<(unsigned)blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const bf16*)v, (bf16*)o, B, F, L, H, D, scale, wpb);
  return (int)cudaGetLastError();
}

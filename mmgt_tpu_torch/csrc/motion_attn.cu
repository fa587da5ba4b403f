// K4: motion-module (temporal) attention for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mmgt_tpu/ops/motion_attention.py:_motion_kernel
// (reached by _motion_fwd, :122):
//     out = x + W_o . MHA_frames(LN(x) * g + b + pe) + b_o
// over x (B, F, L, C): attention across the F frames of each token. The
// caller (mmgt_tpu_torch/ops/motion_attention.py) launches
//   1. ln_pe: h = bf16(LN(x) * g + b + pe[f]) for every row (TPR lanes a
//      row, the row in registers, f32 two-pass statistics as the reference):
//      the rounded normalised row that the TPU kernel feeds its products;
//   2. motion_attn (kernel A, below): per-head q/k/v projections of h and
//      the frame attention, writing only the attention output o (bf16);
//   3. csrc/ln_proj.cu's GEMM without LayerNorm (kernel B): o . W_o^T with
//      the f32 bias and the bf16 residual x.
// On a head shard (tensor parallelism) kernel A takes H local heads of D
// columns: W_q/W_k/W_v of (inner = H D, C), o of (B F L, inner); the
// caller runs kernel B on W_o (C, inner) without bias or residual and adds
// both once after the tp reduce.
// Numerics as the TPU kernel: the normalised row (+pe) rounded to bf16
// before the products, q and k kept at the projection's f32 accumulation
// (the logits multiply exact f32 products), v rounded to bf16, f32 softmax,
// probabilities rounded to bf16, P . V summed in f32.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), for the whole K4:
// operations at level 0 (x (4, 12, 4096, 320): the four C x C products and
// the frame attention, 164 GFLOP, 0.166 ms; 252 MB of x in and out, 0.075
// ms). q and k never reach device memory; h (bf16, the size of x) does.
//
// Why a pre-pass and not the LayerNorm inside kernel A: a kernel-A block
// covers one head, so inside it each x tile would be normalised once per
// head (8 times); one pass that writes h is cheaper (its time at levels 0,
// 1 and 3: mmgt_tpu_torch/tools/k34_parts.py, PERF.md).
//
// Kernel A: one block per (head h, block of Lt tokens, row b), heads
// fastest so that the blocks of one token block share its h tile in L2.
//   * Rows: the block's F x Lt rows in frame-major order (row f Lt + t),
//     padded to RP = 128 rows (d <= 96; the two warpgroups own 64 rows
//     each) or RP = 64 (d = 128, 160; both warpgroups own the 64 rows and
//     split the head's columns, so that q, k and v fit in registers).
//     Lt = RP / F tokens (F = 12: Lt = 10, 120 of 128 rows used); the last
//     token block may be ragged (TMA fills it with zeros; nothing of it is
//     stored).
//   * Loads: thread 0 loads, per 64-column chunk of C, the (64, Lt, F) box
//     of h (4-D tensor map over (C, L, F, B), 128-byte swizzle) and the
//     head's 64-column chunks of W_q, W_k, W_v (D rows each) into one stage
//     of a 2-4 stage ring (one full mbarrier a stage), issuing chunk
//     kc - 1 + stages as soon as every thread is past chunk kc - 1. No
//     producer warp: 256 threads, so that two blocks share an SM at d <= 64
//     (at most 128 registers a thread).
//   * Projections: the two warpgroups run q, k and v (m64nDk16 or
//     m64n(D/2)k16, SS wgmma) into f32 registers: 3 x D / 2 a thread.
//   * Frame attention: the accumulators go to shared memory (q, k in f32;
//     v rounded to bf16, held as f32), aliasing the drained ring; then two
//     threads per (token, query frame) compute the F logits (f32 dot
//     products of length D) and the f32 softmax with the probabilities
//     rounded to bf16, and P . V is summed in f32, two query frames a
//     thread; o is stored as 16-byte bf16 vectors, one D-wide slice per
//     head.
// The plan (RP, Lt, ring depth, shared-memory bytes) is computed in Python
// (mmgt_tpu_torch/ops/motion_attention.py:attn_plan) and checked here.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int kThreads = 256;     // 2 warpgroups
constexpr int kSpan = 64;         // bf16 columns of a 64-column (128-byte) chunk
constexpr int kMaxSmem = 232448;  // 227 KB a block
constexpr int kPad = 4;           // f32 padding of a staged q/k/v row

__host__ __device__ inline int stage_bytes(int rp, int d) { return rp * 128 + 3 * d * 128; }
__host__ __device__ inline int staging_bytes(int rp, int d) { return 3 * rp * (d + kPad) * 4; }
__host__ __device__ inline int region_bytes(int rp, int d, int stages) {
  const int ring = stages * stage_bytes(rp, d), st = staging_bytes(rp, d);
  return ring > st ? ring : st;
}
// the (Lt, F, F) f32 probabilities, rounded up to 16 bytes
__host__ __device__ inline int probs_bytes(int F, int lt) {
  return (lt * F * F * 4 + 15) / 16 * 16;
}
__host__ __device__ inline int attn_smem(int rp, int d, int stages, int F, int lt) {
  return 1024 + region_bytes(rp, d, stages) + probs_bytes(F, lt) + 8 * stages;
}

// ------------------------------------------------ LayerNorm + pe pre-pass
// h = bf16((x - mean) * rstd * gamma + beta + pe[f]) for every row of x
// (B, F, L, C), f = (row / L) % F. TPR neighbouring lanes share a row (8
// for C <= 640, 32 up to C = 2048), each holding up to MAXCH of its 16-byte
// chunks in registers, so x is read once; f32 mean and variance in two
// passes over the registers, as the reference.
template <int TPR, int MAXCH>
__global__ void ln_pe(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ pe,
                      bf16* __restrict__ h, long long M, int L, int F, int C, float eps) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TPR;
  const int sub = threadIdx.x % TPR;
  const bool valid = row < M;  // no early return: the row's lanes shuffle together
  const uint4* r = reinterpret_cast<const uint4*>(x + row * C);
  const int nch = C / 8;
  uint4 raw[MAXCH];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < MAXCH; ++u) {
    const int ch = sub + TPR * u;
    if (valid && ch < nch) {
      raw[u] = __ldg(r + ch);
      const bf16* e = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / C;
  float v = 0.f;
#pragma unroll
  for (int u = 0; u < MAXCH; ++u) {
    if (valid && sub + TPR * u < nch) {
      const bf16* e = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __bfloat162float(e[i]) - mean;
        v += d * d;
      }
    }
  }
#pragma unroll
  for (int off = TPR / 2; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (!valid) return;
  const float rstd = rsqrtf(v / C + eps);
  const float* per = pe + (long long)((row / L) % F) * C;
  uint4* out = reinterpret_cast<uint4*>(h + row * C);
#pragma unroll
  for (int u = 0; u < MAXCH; ++u) {
    const int ch = sub + TPR * u;
    if (ch >= nch) continue;
    bf16* e = reinterpret_cast<bf16*>(&raw[u]);
    const float4* g4 = reinterpret_cast<const float4*>(gamma + 8 * ch);
    const float4* b4 = reinterpret_cast<const float4*>(beta + 8 * ch);
    const float4* p4 = reinterpret_cast<const float4*>(per + 8 * ch);
    const float4 g0 = __ldg(g4), g1 = __ldg(g4 + 1), b0 = __ldg(b4), b1 = __ldg(b4 + 1);
    const float4 e0 = __ldg(p4), e1 = __ldg(p4 + 1);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float pp[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16((__bfloat162float(e[i]) - mean) * rstd * g[i] + bb[i] + pp[i]);
    out[ch] = raw[u];
  }
}

// ------------------------------------------------------------- kernel A
// F x F logits of each valid token from the staged q and k (f32 dot products
// of length D, times `scale`), then the f32 softmax over the key frames with
// the probabilities rounded to bf16, into probs (t, i, j). Threads 2 p and
// 2 p + 1 share (t, i) = pair p and take key frames [0, jh) and [jh, F);
// JM >= jh = ceil(F / 2) bounds the logits a thread keeps in registers.
template <int D, int JM>
__device__ __forceinline__ void logits_softmax(const float* qs, const float* ks, float* probs,
                                               float scale, int F, int Lt, int nt) {
  constexpr int DS = D + kPad;
  const int half = threadIdx.x & 1, jh = (F + 1) / 2;
  for (int base = 0; base < nt * F; base += blockDim.x / 2) {
    const int pi = base + (threadIdx.x >> 1);
    const bool active = pi < nt * F;
    const int t = active ? pi / F : 0, i = active ? pi % F : 0;
    const int j0 = half * jh;
    const float4* qv = reinterpret_cast<const float4*>(qs + (i * Lt + t) * DS);
    float lg[JM];
#pragma unroll
    for (int jj = 0; jj < JM; ++jj) lg[jj] = 0.f;
    if (active) {
      for (int c = 0; c < D / 4; ++c) {
        const float4 a = qv[c];
#pragma unroll
        for (int jj = 0; jj < JM; ++jj) {
          const int j = j0 + jj;
          if (jj < jh && j < F) {
            const float4 k = reinterpret_cast<const float4*>(ks + (j * Lt + t) * DS)[c];
            lg[jj] = fmaf(a.x, k.x, fmaf(a.y, k.y, fmaf(a.z, k.z, fmaf(a.w, k.w, lg[jj]))));
          }
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < JM; ++jj)
      if (active && jj < jh && j0 + jj < F) {
        lg[jj] *= scale;
        m = fmaxf(m, lg[jj]);
      }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JM; ++jj)
      if (active && jj < jh && j0 + jj < F) {
        lg[jj] = expf(lg[jj] - m);
        sum += lg[jj];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* row = probs + (t * F + i) * F;
#pragma unroll
    for (int jj = 0; jj < JM; ++jj)
      if (active && jj < jh && j0 + jj < F)
        row[j0 + jj] = __bfloat162float(__float2bfloat16(lg[jj] / sum));
  }
}

struct AttnParams {
  CUtensorMap th;          // h (B, F, L, C) as (C, L, F, B): boxes (64, Lt, F, 1)
  CUtensorMap tw[3];       // W_q, W_k, W_v (inner, C): boxes (64, D)
  bf16* o;                 // (B, F, L, inner)
  int F, L, C, inner, Lt, kchunks, stages;
  float scale;
};

template <int D, int RP>
__global__ void __launch_bounds__(kThreads, RP == 128 && D <= 64 ? 2 : 1)
    motion_attn(const __grid_constant__ AttnParams p) {
  constexpr int NW = RP == 128 ? D : D / 2;  // wgmma width of one warpgroup
  constexpr int DS = D + kPad;
  constexpr int XB = RP * 128, WB = D * 128, SB = XB + 3 * WB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sR = smem_u32(base_ptr);
  const int stages = p.stages;
  const int region = region_bytes(RP, D, stages);
  float* probs = reinterpret_cast<float*>(base_ptr + region);                 // (Lt, F, F)
  const uint32_t bars = sR + region + probs_bytes(p.F, p.Lt);
  auto full = [&](int s) { return bars + 8u * s; };

  const int h = blockIdx.x, l0 = blockIdx.y * p.Lt, b = blockIdx.z;
  const int F = p.F, L = p.L, Lt = p.Lt;
  const int nt = min(Lt, L - l0);  // valid tokens of this block
  const int rows = F * Lt;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  // chunk kc of h and of the head's W_q, W_k, W_v into stage kc % stages
  auto issue = [&](int kc) {
    const int s = kc % stages;
    const uint32_t st = sR + s * SB;
    mbar_expect_tx(full(s), (uint32_t)(rows * 128 + 3 * WB));
    tma_load(st, &p.th, full(s), kc * kSpan, l0, 0, b);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      tma_load_2d(st + XB + i * WB, &p.tw[i], full(s), kc * kSpan, h * D);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
    for (int kc = 0; kc < stages && kc < p.kchunks; ++kc) issue(kc);
  }
  __syncthreads();

  const int arow = RP == 128 ? 64 * wg : 0;   // the warpgroup's first row
  const int bcol = RP == 128 ? 0 : NW * wg;   // and first column of the head
  float q[NW / 2], k[NW / 2], v[NW / 2];
  for (int kc = 0; kc < p.kchunks; ++kc) {
    const int s = kc % stages;
    const uint32_t st = sR + s * SB;
    mbar_wait(full(s), (kc / stages) & 1);
    __syncthreads();
    // every thread is past chunk kc - 1's wgmma: its stage takes a new chunk
    if (tid == 0 && kc >= 1 && kc - 1 + stages < p.kchunks) issue(kc - 1 + stages);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = make_desc<128>(st + arow * 128 + kk * 32, 16);
      const int acc = kc > 0 || kk > 0;
      wgmma_ss<NW>(q, da, make_desc<128>(st + XB + bcol * 128 + kk * 32, 16), acc);
      wgmma_ss<NW>(k, da, make_desc<128>(st + XB + WB + bcol * 128 + kk * 32, 16), acc);
      wgmma_ss<NW>(v, da, make_desc<128>(st + XB + 2 * WB + bcol * 128 + kk * 32, 16), acc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NW / 2>(q);
    fence_regs<NW / 2>(k);
    fence_regs<NW / 2>(v);
  }
  // every warpgroup is done with the ring: stage q, k (f32) and v (bf16-rounded)
  __syncthreads();
  float* qs = reinterpret_cast<float*>(base_ptr);
  float* ks = qs + RP * DS;
  float* vs = ks + RP * DS;
  {
    const int g = lane >> 2, qd = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = arow + 16 * warp + g + 8 * j;
#pragma unroll
      for (int c = 0; c < NW / 8; ++c) {
        const int col = bcol + 8 * c + 2 * qd;
        const int i0 = 4 * c + 2 * j;
        *reinterpret_cast<float2*>(qs + r * DS + col) = make_float2(q[i0], q[i0 + 1]);
        *reinterpret_cast<float2*>(ks + r * DS + col) = make_float2(k[i0], k[i0 + 1]);
        *reinterpret_cast<float2*>(vs + r * DS + col) =
            make_float2(__bfloat162float(__float2bfloat16(v[i0])),
                        __bfloat162float(__float2bfloat16(v[i0 + 1])));
      }
    }
  }
  __syncthreads();
  // logits and softmax: two neighbouring threads per (token t, query frame
  // i), each with half of the key frames j
  const int jh = (F + 1) / 2;
  if (jh <= 2) logits_softmax<D, 2>(qs, ks, probs, p.scale, F, Lt, nt);
  else if (jh <= 4) logits_softmax<D, 4>(qs, ks, probs, p.scale, F, Lt, nt);
  else if (jh <= 8) logits_softmax<D, 8>(qs, ks, probs, p.scale, F, Lt, nt);
  else logits_softmax<D, 16>(qs, ks, probs, p.scale, F, Lt, nt);
  __syncthreads();
  // o = P . V, f32 sums, 16-byte bf16 stores; a thread takes 8 columns of
  // two query frames, so that each v load serves both
  constexpr int NV = D / 8;
  const int fp = (F + 1) / 2;
  for (int idx = tid; idx < nt * fp * NV; idx += kThreads) {
    const int t = idx / (fp * NV), i0 = 2 * ((idx / NV) % fp), cv = idx % NV;
    const bool two = i0 + 1 < F;
    const float* p0 = probs + (t * F + i0) * F;
    const float* p1 = two ? p0 + F : p0;
    float acc[2][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[0][u] = acc[1][u] = 0.f;
#pragma unroll 4
    for (int j = 0; j < F; ++j) {
      const float4* vv = reinterpret_cast<const float4*>(vs + (j * Lt + t) * DS + 8 * cv);
      const float4 v0 = vv[0], v1 = vv[1];
      const float w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      const float a0 = p0[j], a1 = p1[j];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc[0][u] = fmaf(a0, w[u], acc[0][u]);
        acc[1][u] = fmaf(a1, w[u], acc[1][u]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !two) break;
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        pw[u] = mma_tiles::pack_bf16(acc[k][2 * u], acc[k][2 * u + 1]);
      *reinterpret_cast<uint4*>(p.o + (((long long)b * F + i0 + k) * L + l0 + t) * p.inner +
                                h * D + 8 * cv) = packed;
    }
  }
}

template <int D, int RP>
int launch(const AttnParams& p, int H, int B, int smem, cudaStream_t st) {
  static cudaError_t attr = cudaFuncSetAttribute(
      motion_attn<D, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(H, (p.L + p.Lt - 1) / p.Lt, B);
  motion_attn<D, RP><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int mmgt_ln_pe(const void* x, const void* gamma, const void* beta, const void* pe,
                          void* h, long long M, int L, int F, int C, float eps, void* stream) {
  if (C <= 0 || C % 8 != 0 || C > 2048 || L <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int threads = 256;
  const int tpr = C <= 640 ? 8 : 32;
  const long long blocks = (M * tpr + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xx = (const bf16*)x;
  const float *g = (const float*)gamma, *b = (const float*)beta, *p = (const float*)pe;
  if (tpr == 8)
    ln_pe<8, 10><<<(unsigned)blocks, threads, 0, st>>>(xx, g, b, p, (bf16*)h, M, L, F, C, eps);
  else
    ln_pe<32, 8><<<(unsigned)blocks, threads, 0, st>>>(xx, g, b, p, (bf16*)h, M, L, F, C, eps);
  return (int)cudaGetLastError();
}

// Kernel A on h = ln_pe(x): H heads of D columns, W_q/W_k/W_v of
// (inner, C) with inner = H D (inner = C unsharded; a head shard's rows
// under tensor parallelism), o (B F L, inner). (rp, lt, stages, smem) is
// the Python plan, checked here.
extern "C" int mmgt_motion_attn(const void* h, const void* wq, const void* wk, const void* wv,
                                void* o, int B, int F, int L, int C, int H, int D, float scale,
                                int rp, int lt, int stages, int smem, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || D <= 0 || C % 8 != 0 || F < 1 || F > 32 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int inner = H * D;
  const int want_rp = D <= 96 ? 128 : 64;
  if (rp != want_rp || lt < 1 || lt * F > rp || lt > L || stages < 2 || stages > 4 ||
      smem != attn_smem(rp, D, stages, F, lt) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  AttnParams p;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)L * C * 2,
                                 (cuuint64_t)F * L * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)lt, (cuuint32_t)F, 1};
  if (!encode_bf16(&p.th, h, 4, dims, strides, box, 128)) return (int)cudaErrorInvalidValue;
  const void* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 3; ++i)
    if (!make_map_2d(&p.tw[i], ws[i], inner, C, D)) return (int)cudaErrorInvalidValue;
  p.o = (bf16*)o;
  p.F = F; p.L = L; p.C = C; p.inner = inner; p.Lt = lt; p.kchunks = (C + kSpan - 1) / kSpan; p.stages = stages;
  p.scale = scale;
  if ((L + lt - 1) / lt > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16, 128>(p, H, B, smem, st);
    case 32: return launch<32, 128>(p, H, B, smem, st);
    case 40: return launch<40, 128>(p, H, B, smem, st);
    case 64: return launch<64, 128>(p, H, B, smem, st);
    case 80: return launch<80, 128>(p, H, B, smem, st);
    case 96: return launch<96, 128>(p, H, B, smem, st);
    case 128: return launch<128, 64>(p, H, B, smem, st);
    case 160: return launch<160, 64>(p, H, B, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

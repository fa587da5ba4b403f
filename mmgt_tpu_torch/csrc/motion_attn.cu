// K4: motion-module (temporal) attention for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mmgt_tpu/ops/motion_attention.py:_motion_kernel
// (reached by _motion_fwd, :122):
//     out = x + W_o . MHA_frames(bf16(LN(x) * g + b + pe)) + b_o
// over x (B, F, L, C): attention across the F frames of each token. Numerics
// as the TPU kernel: f32 two-pass LayerNorm statistics (eps inside the
// rsqrt), the normalised row (+pe) rounded to bf16 before the products, q and
// k kept at the projection's f32 accumulation (the logits are f32 products),
// v rounded to bf16, f32 softmax, probabilities rounded to bf16, P . V summed
// in f32. The caller (mmgt_tpu_torch/ops/motion_attention.py) runs W_o, its
// bias and the residual on csrc/ln_proj.cu's GEMM; on a head shard (tensor
// parallelism) the q/k/v weights are (inner = H D, C) and that GEMM runs
// without bias or residual. gamma and beta are read as the caller holds
// them (bf16 or f32), pe as f32: no cast on the host.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), for the whole K4:
// operations at every path shape (level 0, x (4, 12, 4096, 320): the four
// C x C products and the frame attention, 164 GFLOP, 0.166 ms; 252 MB of x
// in and out, 0.075 ms).
//
// Three regimes, chosen by C and d (ops/motion_attention.py:attn_plan,
// checked by the C entries):
//
// Fused (C <= 320, d <= 64: level 0 and its head shards): one persistent
// kernel reads x once per token block; the normalised rows never reach
// device memory.
//   * A unit is 2 Lh tokens of one batch row (Lh = 64 // F, frame-major rows
//     f Lh + t: 10 tokens, 120 of 128 rows at F = 12) and a group of heads
//     (all 8 at level 0). Persistent blocks, one an SM, walk every 132nd
//     unit.
//   * Warp 8's first thread loads a unit's stripe by TMA (per 64-column
//     chunk a (64, Lh, F) box for each 64-row half, 128-byte swizzle) and
//     streams each head's W_q, W_k and W_v chunks (3 d rows x 64 columns)
//     through a 4-stage ring; it loads the next unit's stripe as soon as
//     both consumer warpgroups hold the current one. Warps 9-11 normalise a
//     stripe in place while the consumers run the previous unit (eight lanes
//     a row, gamma and beta from a shared f32 table, pe from L1).
//   * Two consumer warpgroups own 64 rows each. At a unit's start each
//     copies its normalised rows into registers as wgmma A fragments (C / 4
//     registers: 80 at C = 320), which frees the stripe. For each head it
//     runs q, k and v together as one m64n(3d)k16 product from registers
//     against the ring (both warpgroups read each stage, so each weight byte
//     brought into the SM serves 128 rows), stages q and k (f32) and v
//     (bf16, transposed) in its shared group, computes the F x F logits and
//     the softmax on the CUDA cores (two threads a (token, query frame)
//     pair; e^x as one MUFU.EX2, the sum's reciprocal multiplied) and
//     writes the bf16 probabilities into a 64 x 64 P tile whose
//     other entries stay zero, so that P . V is one m64ndk16 x 4 wgmma over
//     the tile (bf16 P times bf16 v, f32 sums: the plain version's
//     arithmetic), stored as bf16 pairs into o.
//   * What bounds it (NVIDIA H100 80GB HBM3, 700 W; throwaway copies timed
//     with tools/k4_rows.py, PERF.md): at level 0 the kernel takes 0.60 ms,
//     0.37 of them without the frame attention (the products, the weight
//     stream, the staging and the LayerNorm), so the frame attention on the
//     CUDA cores costs ~0.23. It runs after each head's products:
//     interleaving it with the next head's chunk issues measured slower.
//     Also measured slower: 4-query x 3-key register tiles for the logits,
//     P . V as a register-A wgmma, the logits sliced between chunk issues.
//   * Deterministic: no partial sum crosses a block.
//
// Clusters (d = 80, 128, 160: levels 1-3, the mid block and their head
// shards, C >= 640 on the main path): the pre-pass `ln_pe` writes
// h = bf16(LN(x) * g + b + pe[f]) for every row (TPR lanes a row, the row in
// registers, f32 two-pass statistics as the reference), then the persistent
// kernel `motion_cluster` runs each head's q/k/v products of h and the frame
// attention, writing only o. (A 128-row stripe of x is 160 KB at C = 640 and
// 320 KB at C = 1280: it neither stays in shared memory beside the
// attention's staging nor fits in registers, and normalising streamed x
// chunks once per head costs the LayerNorm eight times over: 0.40-0.57 ms
// at level 1, where ln_pe takes 0.06.)
//   * A unit is one head over cs neighbouring token blocks of the flattened
//     (batch row, block) index, one block a CTA of a thread block cluster of
//     cs CTAs: two 64-row groups a CTA at d = 80 (2 Lh tokens, a warpgroup
//     a group), one at d >= 128 (Lh tokens; the warpgroups split the head's
//     columns so that q, k and v fit in registers). Heads run fastest, so
//     the clusters at work at once share their h rows in L2; the last unit
//     may hold CTAs past the last block, which load no h and store nothing.
//   * What bounds it (NVIDIA H100 80GB HBM3, 700 W; tools/k4_rows.py and
//     throwaway copies, PERF.md): the per-head kernel, which ran these
//     shapes before (0.44, 0.41 and 0.11 ms at levels 1, 2 and 3), spent
//     0.26, 0.29 and 0.08 ms on the products, which streamed the head's
//     W_q, W_k and W_v (3 d C bf16) for each block's 64 or 128 rows (1.0,
//     2.0 and 0.5 GB a call from L2) and waited for each chunk's product
//     before the next, and the rest on the frame attention, after them,
//     on the CUDA cores.
//   * The weights: each CTA's warp-8 thread loads its h rows and only
//     1 / cs of each weight chunk (d / cs rows, a multiple of 8, so that
//     each slice starts on the 128-byte swizzle's 1024-byte pattern),
//     multicast to every CTA of the cluster (TMA .multicast::cluster): each
//     weight byte fetched from L2 serves cs times the rows. cs = 2 at d =
//     80 (4 would leave 20-row slices) and 4 at d >= 128: the weight bytes
//     a call at levels 1, 2 and 3 fall to 0.51, 0.51 and 0.13 GB. A stage
//     is refilled once the MMA warps of every CTA have freed it: each warp's
//     lanes 0 .. cs - 1 arrive on the empty barrier of CTA `lane`
//     (mbarrier.arrive.shared::cluster, which publishes nothing: with
//     .release.cluster a chunk took ~2 x as long).
//   * The products: each unit's chunk kc takes ring stage kc % stages (64
//     columns of C, one 128-byte swizzle span, as K3's tiled GEMM; 32-column
//     chunks under a 64-byte swizzle ran the products 1.7 x slower). The
//     two MMA warpgroups run q, k and v as one SS wgmma a k step
//     (m64n240k16: 64 rows x q, k and v at d = 80, or x half of each at d =
//     160; m64n192k16 at d = 128), the last chunk's product in flight while
//     the next stage is awaited.
//   * Frame attention: the accumulators are staged (q and k in f32, v
//     rounded to bf16 and transposed, zero in rows that hold no token; P
//     zeroed) in the ring's last stages, which the unit's last chunks do
//     not hand on until the attention is done; the next unit's first
//     chunks load into the stages before them meanwhile. Warps 0-7 and 9-11
//     (352 threads) compute the logits and softmax (2 or 4 threads a
//     (token, query frame) pair, e^x one MUFU.EX2) into a bf16 P tile a
//     group, and each MMA warpgroup runs P . V as an m64 n(d or d / 2) k16
//     x 4 wgmma over its group's 64 keys (bf16 P times bf16 v, f32 sums:
//     the plain version's arithmetic), storing o as bf16 pairs. Measured
//     no faster: the staging kept apart from the ring with the logits on
//     warps 9-11 under the next unit's products (beside its 110-120 KB only
//     32-column stages fit), and the next unit's first chunks issued under
//     the logits.
//   * Deterministic: no partial sum crosses a CTA.
//
// Per head (every other shape: d <= 64 at C > 320, and d = 96; off the
// main path): ln_pe, then one block per (head h, block of Lt tokens, row b),
// heads fastest so that the blocks of one token block share its h tile in
// L2.
//   * Rows: the block's F x Lt rows in frame-major order (row f Lt + t),
//     padded to 128 rows (the two warpgroups own 64 rows each). Lt = 128 /
//     F tokens; the last token block may be ragged (TMA fills it with
//     zeros; nothing of it is stored).
//   * Loads: thread 0 loads, per 64-column chunk of C, the (64, Lt, F) box
//     of h (4-D tensor map over (C, L, F, B), 128-byte swizzle) and the
//     head's 64-column chunks of W_q, W_k, W_v (D rows each) into one stage
//     of a 2-4 stage ring (one full mbarrier a stage), issuing chunk
//     kc - 1 + stages as soon as every thread is past chunk kc - 1.
//   * Projections: the two warpgroups run q, k and v (m64nDk16, SS wgmma)
//     into f32 registers: 3 x D / 2 a thread.
//   * Frame attention: the accumulators go to shared memory (q, k in f32;
//     v rounded to bf16, held as f32), aliasing the drained ring; then two
//     threads per (token, query frame) compute the F logits and the f32
//     softmax (e^x as one MUFU.EX2) with the probabilities rounded to bf16,
//     and P . V is summed in
//     f32, two query frames a thread; o is stored as 16-byte bf16 vectors.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB a block
constexpr int kPad = 4;           // f32 padding of a staged q or k row

// gamma and beta are read in the dtype the caller holds them (bf16 or f32)
// and widened to f32 in registers, which is exact for bf16: 8 values
// [8 i, 8 i + 8) of a vector
__device__ __forceinline__ void load8(const void* v, int is_bf16, int i, float* o) {
  if (is_bf16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(v) + i);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(e[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  } else {
    const float4* f4 = reinterpret_cast<const float4*>(v) + 2 * i;
    const float4 a = __ldg(f4), b = __ldg(f4 + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
}

// e^x for the softmaxes is one MUFU.EX2 of x log2 e (hopper.cuh's ex2; expf
// without --use_fast_math adds range handling, and the fused kernel's
// logits ran 13 % faster without it): an f32 result, rounded to bf16 after
// the normalisation as the reference's probabilities are.
constexpr float kLog2e = 1.4426950408889634f;

// ====================================================================
// the fused regime (C <= 320, d <= 64)
// ====================================================================

constexpr int kThreads = 384;       // 2 consumer warpgroups + the producer warpgroup
constexpr int kLnThreads = 96;      // warps 9-11: the LayerNorm
constexpr int kLnRows = kLnThreads / 8;  // rows a pass, eight lanes a row
constexpr int kChunks = 5;          // 64-column chunks of C <= 320
constexpr int kRows = 128;          // rows of a unit: two halves of 64

__host__ __device__ constexpr int round_up(int v, int a) { return (v + a - 1) / a * a; }
// the stripe: kchunks boxes of 128 rows x 64 columns (128-byte swizzle)
__host__ __device__ constexpr int stripe_bytes(int C) { return (C + 63) / 64 * kRows * 128; }
// a stage: the head's W_q, W_k, W_v chunks (d rows x 64 columns each)
__host__ __device__ constexpr int stage_bytes(int d) { return round_up(3 * d * 128, 1024); }
// an attention group (a warpgroup's 64 rows): q and k (f32), then P (bf16,
// 64 query rows x 64 key rows, 128-byte swizzle: the P . V product's A
// operand) and v transposed (bf16, d rows of the 64 keys: its B operand)
__host__ __device__ constexpr int qk_bytes(int d) { return round_up(2 * 64 * (d + kPad) * 4, 1024); }
__host__ __device__ constexpr int group_bytes(int d) { return qk_bytes(d) + 64 * 128 + d * 128; }
// gamma and beta (C), f32
__host__ __device__ constexpr int table_bytes(int C) { return 2 * C * 4; }
__host__ __device__ constexpr int fused_smem(int d, int C, int stages) {
  return 1024 + stripe_bytes(C) + stages * stage_bytes(d) + 2 * group_bytes(d) +
         table_bytes(C) + 8 * (2 * stages + 3);
}

struct Params {
  CUtensorMap tx;      // x (B, F, L, C) as (C, L, F, B): boxes (64, Lh, F, 1)
  CUtensorMap tw[3];   // W_q, W_k, W_v (inner, C): boxes (64, d)
  const void* gamma;   // (C,) bf16 or f32 (ln_bf16)
  const void* beta;
  const float* pe;     // (F, C)
  bf16* o;             // (B, F, L, inner)
  int ln_bf16;
  int F, L, C, inner, lh, kchunks, stages, hg, ngroups, nblk, units;
  float scale, eps;
};

// a work unit: batch row b, first token l0 of its 2 Lh tokens, first head h0
struct Unit {
  int b, l0, h0;
};
__device__ __forceinline__ Unit unit_at(const Params& p, int u) {
  const int item = u / p.ngroups;
  Unit r;
  r.b = item / p.nblk;
  r.l0 = (item % p.nblk) * 2 * p.lh;
  r.h0 = (u % p.ngroups) * p.hg;
  return r;
}

// row r of a unit: its half w (64 rows each), frame f and token t
// (frame-major rows f Lh + t); false for padding rows and tokens past L
__device__ __forceinline__ bool row_of(const Params& p, const Unit& un, int r, int& f) {
  const int rr = r & 63, w = r >> 6;
  if (rr >= p.F * p.lh) return false;
  f = rr / p.lh;
  return un.l0 + w * p.lh + rr % p.lh < p.L;
}

// ---------------------------------------------------------- LayerNorm
// 16-byte unit ch (columns 8 ch .. 8 ch + 7) of row r of the stripe
__device__ __forceinline__ uint32_t stripe_off(int r, int ch) {
  return (uint32_t)((ch >> 3) * kRows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// 8 values of a row, columns [col, col + 8) of gamma (g), beta (b) and pe's
// row (pp): bf16((x - mean) * rstd * gamma + beta + pe[f]), the rounding the
// TPU kernel gives its products' operand
__device__ __forceinline__ uint4 norm8(uint4 raw, float mean, float rstd, const float* g,
                                       const float* b, const float* pp) {
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(e[i]);
    e[i] = __floats2bfloat162_rn((v.x - mean) * rstd * g[2 * i] + b[2 * i] + pp[2 * i],
                                 (v.y - mean) * rstd * g[2 * i + 1] + b[2 * i + 1] + pp[2 * i + 1]);
  }
  return raw;
}

// the unit's stripe in place, eight lanes a row (12 rows a pass of warps
// 9-11): f32 mean and centred variance in two passes over shared memory, as
// the reference; gamma and beta from the block's f32 table (tab: gamma,
// then beta), pe from device memory (it stays in L1)
__device__ __forceinline__ void normalise_stripe(const Params& p, uint8_t* sx, const float* tab,
                                                 const Unit& un, int lt) {
  const int warp = lt / 32, lane = lt % 32, sub = lane & 7;
  const int nch = p.C / 8;
  for (int r0 = 0; r0 < kRows; r0 += kLnRows) {
    const int r = r0 + warp * 4 + (lane >> 3);
    int f = 0;
    const bool valid = r < kRows && row_of(p, un, r, f);
    const int n = valid ? nch : 0;
    float s = 0.f;
    for (int ch = sub; ch < n; ch += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(sx + stripe_off(r, ch));
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(e[i]);
        s += v.x + v.y;
      }
    }
#pragma unroll
    for (int off = 4; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = s / p.C;
    float q = 0.f;
    for (int ch = sub; ch < n; ch += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(sx + stripe_off(r, ch));
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(e[i]);
        const float d0 = v.x - mean, d1 = v.y - mean;
        q += d0 * d0 + d1 * d1;
      }
    }
#pragma unroll
    for (int off = 4; off; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
    const float rstd = rsqrtf(q / p.C + p.eps);
    for (int ch = sub; ch < n; ch += 8) {
      const float4* g4 = reinterpret_cast<const float4*>(tab + 8 * ch);
      const float4* b4 = reinterpret_cast<const float4*>(tab + p.C + 8 * ch);
      const float4* e4 = reinterpret_cast<const float4*>(p.pe + (size_t)f * p.C + 8 * ch);
      const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1], e0 = __ldg(e4),
                   e1 = __ldg(e4 + 1);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float pp[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      uint4* at = reinterpret_cast<uint4*>(sx + stripe_off(r, ch));
      *at = norm8(*at, mean, rstd, g, b, pp);
    }
  }
}

// the block's table, once: gamma and beta widened to f32
__device__ __forceinline__ void load_tables(const Params& p, float* tab, int lt) {
  for (int i = lt; i < p.C / 8; i += kLnThreads) {
    load8(p.gamma, p.ln_bf16, i, tab + 8 * i);
    load8(p.beta, p.ln_bf16, i, tab + p.C + 8 * i);
  }
}

// ------------------------------------------------------ frame attention
// byte offset of element (r, c) of a 128-byte-swizzled 64-column bf16 tile
// (P, and v transposed)
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) * 2)));
}

// A warpgroup's frame attention logits of its 64 rows: pair pi = (token t,
// query frame i) = t F + i, na = nt F <= 64 of them (Lh F <= 64). Threads
// 2 pi and 2 pi + 1 take key frames [0, jh) and [jh, F), jh = ceil(F / 2)
// <= JM: the f32 logits (dot products of length D of the staged q and k,
// times `scale`), the f32 softmax over the key frames (the two threads
// exchange their maximum and sum), the probabilities rounded to bf16 into P
// at query row i Lh + t, key column j Lh + t (P's other entries stay zero).
template <int D, int JM>
__device__ __forceinline__ void logits_softmax(const float* qs, const float* ks, uint8_t* ptile,
                                               float scale, int F, int lh, int na, int tg) {
  constexpr int DS = D + kPad;
  const int pi = tg >> 1;
  const bool active = pi < na;
  const int t = active ? pi / F : 0, i = active ? pi % F : 0;
  const int jh = (F + 1) / 2, j0 = (tg & 1) * jh;
  float lg[JM];
#pragma unroll
  for (int jj = 0; jj < JM; ++jj) lg[jj] = 0.f;
  if (active) {
    const float4* qv = reinterpret_cast<const float4*>(qs + (i * lh + t) * DS);
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = qv[c];
#pragma unroll
      for (int jj = 0; jj < JM; ++jj) {
        const int j = j0 + jj;
        if (jj < jh && j < F) {
          const float4 k = reinterpret_cast<const float4*>(ks + (j * lh + t) * DS)[c];
          lg[jj] = fmaf(a.x, k.x, fmaf(a.y, k.y, fmaf(a.z, k.z, fmaf(a.w, k.w, lg[jj]))));
        }
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < JM; ++jj) {
    lg[jj] *= scale;
    if (active && jj < jh && j0 + jj < F) m = fmaxf(m, lg[jj]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < JM; ++jj)
    if (active && jj < jh && j0 + jj < F) {
      lg[jj] = ex2((lg[jj] - m) * kLog2e);
      sum += lg[jj];
    }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (!active) return;
  const float inv = __frcp_rn(sum);
  const int r = i * lh + t;
#pragma unroll
  for (int jj = 0; jj < JM; ++jj)
    if (jj < jh && j0 + jj < F)
      *reinterpret_cast<bf16*>(ptile + tile_off(r, (j0 + jj) * lh + t)) =
          __float2bfloat16(lg[jj] * inv);
}

// ------------------------------------------------------------------ wgmma
// wgmma m64nNk16 with A from registers and B K-major from shared memory,
// every accumulator register named (f32 += bf16 x bf16; acc = 0 ignores d);
// N = 3 d: the q, k and v products of a head together
template <int N> __device__ __forceinline__ void wgmma_rs_k(float* d, const uint32_t* a, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_rs_k<48>(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<96>(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<120>(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, {%60, %61, %62, %63}, %64, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<192>(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ------------------------------------------------------------- consumers
// A consumer warpgroup's state and steps: its 64 rows of the unit (half wg).
// Members, not lambdas, and every step forced inline, so that the A
// fragments and the accumulators stay in registers.
template <int D>
struct Consumer {
  static constexpr int NW = 3 * D;   // the product's width: q, k and v of a head
  static constexpr int NA = NW / 2;  // its accumulator registers
  static constexpr int NO = D / 2;   // P . V's accumulator registers
  static constexpr int DS = D + kPad;

  const Params& p;
  uint32_t sX, sRing, bars;
  float *qs, *ks;
  uint8_t *ptile, *vtile;  // P and v^T
  uint32_t sP, sVt;        // and their shared addresses
  int stages, wg, warp, lane, tg;
  int s_use = 0, ph_use = 0, s_rel = 0, unrel = 0;
  uint32_t a[4 * kChunks][4];  // this warpgroup's normalised rows as A fragments
  float acc[NA];
  float oacc[NO];

  __device__ __forceinline__ Consumer(const Params& p_, uint8_t* base, uint32_t sX_,
                                      uint32_t sRing_, uint32_t sGroups, uint32_t bars_)
      : p(p_), sX(sX_), sRing(sRing_), bars(bars_) {
    stages = p.stages;
    wg = threadIdx.x / 128;
    warp = (threadIdx.x / 32) % 4;
    lane = threadIdx.x % 32;
    tg = threadIdx.x % 128;
    const uint32_t gofs = (sGroups - sX) + wg * group_bytes(D);
    qs = reinterpret_cast<float*>(base + gofs);
    ks = qs + 64 * DS;
    ptile = base + gofs + qk_bytes(D);
    vtile = ptile + 64 * 128;
    sP = sX + gofs + qk_bytes(D);
    sVt = sP + 64 * 128;
  }

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (stages + s); }
  __device__ __forceinline__ void group_sync() const { named_sync(1 + wg, 128); }

  // the oldest consumed stage is free again
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s_rel));
    s_rel = s_rel + 1 == stages ? 0 : s_rel + 1;
    --unrel;
  }

  // unit q's normalised rows of this warpgroup into registers as A
  // fragments; then the stripe is free for the next unit's x
  __device__ __forceinline__ void load_a(int q) {
    const uint32_t xready = bars + 8u * (2 * stages + 1), xempty = xready + 8;
    mbar_wait(xready, q & 1);
    const int r = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int k = 0; k < 4 * kChunks; ++k) {
      if (k < 4 * p.kchunks) {
        const int ch = 2 * (k % 4) + (lane >> 4);
        ldmatrix_x4(a[k], sX + (k / 4) * kRows * 128 + r * 128 + ((ch ^ (r & 7)) << 4));
      }
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty);
  }

  template <int KC>
  __device__ __forceinline__ void issue_chunk(uint32_t stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_k<NW>(acc, a[4 * KC + kk], make_desc<128>(stage + kk * 32, 16), KC > 0 || kk > 0);
  }

  // chunk kc of the current head: its products as one commit group
  __device__ __forceinline__ void issue(int kc) {
    mbar_wait(full(s_use), ph_use);
    const uint32_t stage = sRing + s_use * stage_bytes(D);
    wgmma_fence();
    switch (kc) {
      case 0: issue_chunk<0>(stage); break;
      case 1: issue_chunk<1>(stage); break;
      case 2: issue_chunk<2>(stage); break;
      case 3: issue_chunk<3>(stage); break;
      default: issue_chunk<4>(stage); break;
    }
    wgmma_commit();
    if (++s_use == stages) {
      s_use = 0;
      ph_use ^= 1;
    }
    ++unrel;
  }

  // a head's products, chunk by chunk; every committed group but the newest
  // W is retired as the next is issued, its stage freed
  __device__ __forceinline__ void run_products() {
    for (int kc = 0; kc < p.kchunks; ++kc) {
      issue(kc);
      if (stages >= 4) {
        wgmma_wait<2>();
        fence_regs<NA>(acc);
        while (unrel > 2) release();
      } else {
        wgmma_wait<1>();
        fence_regs<NA>(acc);
        while (unrel > 1) release();
      }
    }
    wgmma_wait_all();
    fence_regs<NA>(acc);
    while (unrel) release();
  }

  // the head's accumulators into the staging: q and k in f32, v rounded to
  // bf16 and transposed (register 4 c + 2 j + e holds row 16 warp + g + 8 j,
  // column 8 c + 2 qd + e: q's columns, then k's, then v's)
  __device__ __forceinline__ void stage_acc() {
    const int g = lane >> 2, qd = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * warp + g + 8 * j;
#pragma unroll
      for (int c = 0; c < NW / 8; ++c) {
        const int part = 8 * c / D, col = 8 * c % D + 2 * qd;
        const float v0 = acc[4 * c + 2 * j], v1 = acc[4 * c + 2 * j + 1];
        if (part == 0) {
          *reinterpret_cast<float2*>(qs + r * DS + col) = make_float2(v0, v1);
        } else if (part == 1) {
          *reinterpret_cast<float2*>(ks + r * DS + col) = make_float2(v0, v1);
        } else {  // v^T[col][r]
          *reinterpret_cast<bf16*>(vtile + tile_off(col, r)) = __float2bfloat16(v0);
          *reinterpret_cast<bf16*>(vtile + tile_off(col + 1, r)) = __float2bfloat16(v1);
        }
      }
    }
  }

  // the head's frame attention: logits and softmax on the CUDA cores into
  // P, then P . V as one wgmma group (m64n D k16 x 4: the 64 key rows, P
  // and v^T from the shared tiles), stored into o (B, F, L, inner) as bf16
  // pairs
  __device__ __forceinline__ void attend(int b, int lt0, int nt, int h) {
    const int na = nt * p.F, jh = (p.F + 1) / 2;
    if (jh <= 2) logits_softmax<D, 2>(qs, ks, ptile, p.scale, p.F, p.lh, na, tg);
    else if (jh <= 4) logits_softmax<D, 4>(qs, ks, ptile, p.scale, p.F, p.lh, na, tg);
    else if (jh <= 8) logits_softmax<D, 8>(qs, ks, ptile, p.scale, p.F, p.lh, na, tg);
    else logits_softmax<D, 16>(qs, ks, ptile, p.scale, p.F, p.lh, na, tg);
    fence_proxy_async();  // P is read by wgmma
    group_sync();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<D>(oacc, make_desc<128>(sP + kk * 32, 16), make_desc<128>(sVt + kk * 32, 16),
                  kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NO>(oacc);
    const int g = lane >> 2, qd = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * warp + g + 8 * j, i = r / p.lh, t = r - i * p.lh;
      if (i >= p.F || t >= nt) continue;
      bf16* row = p.o + (((size_t)b * p.F + i) * p.L + lt0 + t) * p.inner + h * D + 2 * qd;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(row + 8 * c) =
            mma_tiles::pack_bf16(oacc[4 * c + 2 * j], oacc[4 * c + 2 * j + 1]);
    }
  }

  // the walk: units blockIdx.x, + gridDim.x, ...; the heads of each in turn
  __device__ __forceinline__ void run() {
    int q = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++q) {
      const Unit un = unit_at(p, u);
      load_a(q);
      const int lt0 = un.l0 + wg * p.lh, nt = max(0, min(p.lh, p.L - lt0));
      for (int hh = 0; hh < p.hg; ++hh) {
        run_products();
        group_sync();  // the previous head's attention is done with the staging
        stage_acc();
        fence_proxy_async();  // v^T is read by wgmma
        group_sync();
        attend(un.b, lt0, nt, un.h0 + hh);
      }
    }
  }
};

// Persistent blocks, one an SM, each walking every gridDim.x-th unit (2 Lh
// tokens of one batch row and a group of heads). Warp 8's first thread
// loads by TMA; warps 9-11 normalise each unit's stripe while the consumers
// run the previous unit; warpgroups 0 and 1 run the products and the frame
// attention (Consumer).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) motion_fused(const __grid_constant__ Params p) {
  using Cn = Consumer<D>;
  constexpr int STAGE = stage_bytes(D);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sX = smem_u32(base_ptr);                      // the stripe
  const uint32_t sRing = sX + stripe_bytes(p.C);               // the weight stages
  const int stages = p.stages;
  const uint32_t sGroups = sRing + stages * STAGE;             // the attention groups
  const uint32_t sTab = sGroups + 2 * group_bytes(D);          // gamma, beta
  const uint32_t bars = sTab + table_bytes(p.C);
  // full[stages] (TMA), empty[stages] (consumed); the stripe has landed
  // (xfull), is normalised (xready), is held in registers by both
  // warpgroups (xempty)
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const uint32_t xfull = bars + 16u * stages, xready = xfull + 8, xempty = xfull + 16;
  const int first = blockIdx.x, step = gridDim.x;

  // the stripe's rows that hold no token stay zero, and so do P's entries
  // between frames of different tokens
  for (uint32_t i = threadIdx.x * 16; i < sTab - sX; i += kThreads * 16)
    *reinterpret_cast<uint4*>(base_ptr + i) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(xfull, 1);
    mbar_init(xready, kLnThreads / 32);
    mbar_init(xempty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ----------------------------------------------- producer and LayerNorm
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 256) {
      constexpr uint32_t kWBytes = 3 * D * 128;
      int s = 0, ph = 0;
      // unit u's x: per 64-column chunk a (64, Lh, F) box for each half that
      // holds tokens
      auto load_stripe = [&](int u) {
        const Unit un = unit_at(p, u);
        const int nh = un.l0 + p.lh < p.L ? 2 : 1;
        mbar_expect_tx(xfull, (uint32_t)(nh * p.kchunks * p.lh * p.F * 128));
        for (int kc = 0; kc < p.kchunks; ++kc)
          for (int w = 0; w < nh; ++w)
            tma_load(sX + kc * kRows * 128 + w * 64 * 128, &p.tx, xfull, kc * 64,
                     un.l0 + w * p.lh, 0, un.b);
      };
      load_stripe(first);
      int q = 0;
      for (int u = first; u < p.units; u += step, ++q) {
        const Unit un = unit_at(p, u);
        const int trig = min(stages, p.hg * p.kchunks) - 1;
        int c = 0;
        for (int hh = 0; hh < p.hg; ++hh) {
#pragma unroll 1
          for (int kc = 0; kc < p.kchunks; ++kc, ++c) {
            mbar_wait(empty(s), ph ^ 1);
            const uint32_t st = sRing + s * STAGE;
            mbar_expect_tx(full(s), kWBytes);
            for (int i = 0; i < 3; ++i)
              tma_load_2d(st + i * D * 128, &p.tw[i], full(s), kc * 64, (un.h0 + hh) * D);
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
            // the next unit's stripe, once both warpgroups hold this one
            if (c == trig && u + step < p.units) {
              mbar_wait(xempty, q & 1);
              load_stripe(u + step);
            }
          }
        }
      }
    } else if (threadIdx.x >= 256 + 32) {
      // warps 9-11: the table, then each unit's stripe
      const int lt = threadIdx.x - 288, lane = threadIdx.x % 32;
      float* tab = reinterpret_cast<float*>(base_ptr + (sTab - sX));
      load_tables(p, tab, lt);
      named_sync(3, kLnThreads);
      int q = 0;
      for (int u = first; u < p.units; u += step, ++q) {
        mbar_wait(xfull, q & 1);
        normalise_stripe(p, base_ptr, tab, unit_at(p, u), lt);
        fence_proxy_async();  // before the next TMA overwrites the stripe
        __syncwarp();
        if (lane == 0) mbar_arrive(xready);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    Cn c(p, base_ptr, sX, sRing, sGroups, bars);
    c.run();
  }
}

template <int D>
int launch_fused(const Params& p, int grid, int smem, cudaStream_t st) {
  static cudaError_t attr = cudaFuncSetAttribute(
      motion_fused<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  motion_fused<D><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// ====================================================================
// the per-head regime (every other shape)
// ====================================================================

constexpr int kHeadThreads = 256;  // the per-head kernel: 2 warpgroups
constexpr int kHeadRows = 128;     // rows of a block: 64 a warpgroup
constexpr int kSpan = 64;          // bf16 columns of a 64-column (128-byte) chunk

__host__ __device__ inline int head_stage_bytes(int d) { return kHeadRows * 128 + 3 * d * 128; }
__host__ __device__ inline int head_staging_bytes(int d) { return 3 * kHeadRows * (d + kPad) * 4; }
__host__ __device__ inline int region_bytes(int d, int stages) {
  const int ring = stages * head_stage_bytes(d), st = head_staging_bytes(d);
  return ring > st ? ring : st;
}
// the (Lt, F, F) f32 probabilities, rounded up to 16 bytes
__host__ __device__ inline int probs_bytes(int F, int lt) {
  return (lt * F * F * 4 + 15) / 16 * 16;
}
__host__ __device__ inline int attn_smem(int d, int stages, int F, int lt) {
  return 1024 + region_bytes(d, stages) + probs_bytes(F, lt) + 8 * stages;
}


// ------------------------------------------------ LayerNorm + pe pre-pass
// The per-head regime's pre-pass:
// h = bf16((x - mean) * rstd * gamma + beta + pe[f]) for every row of x
// (B, F, L, C), f = (row / L) % F. TPR neighbouring lanes share a row (8
// for C <= 640, 32 up to C = 2048), each holding up to MAXCH of its 16-byte
// chunks in registers, so x is read once; f32 mean and variance in two
// passes over the registers, as the reference; gamma and beta read as the
// caller holds them, bf16 or f32.
template <int TPR, int MAXCH, bool BF16_LN>  // gamma and beta are bf16 (else f32)
__global__ void ln_pe(const bf16* __restrict__ x, const void* __restrict__ gamma,
                      const void* __restrict__ beta, const float* __restrict__ pe,
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
    const float4* p4 = reinterpret_cast<const float4*>(per + 8 * ch);
    const float4 e0 = __ldg(p4), e1 = __ldg(p4 + 1);
    float g[8], bb[8];
    load8(gamma, BF16_LN, ch, g);
    load8(beta, BF16_LN, ch, bb);
    const float pp[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16((__bfloat162float(e[i]) - mean) * rstd * g[i] + bb[i] + pp[i]);
    out[ch] = raw[u];
  }
}


// ------------------------------------------------------ per-head kernel
// F x F logits of each valid token from the staged q and k (f32 dot products
// of length D, times `scale`), then the f32 softmax over the key frames with
// the probabilities rounded to bf16, into probs (t, i, j). Threads 2 p and
// 2 p + 1 share (t, i) = pair p and take key frames [0, jh) and [jh, F);
// JM >= jh = ceil(F / 2) bounds the logits a thread keeps in registers.
template <int D, int JM>
__device__ __forceinline__ void head_logits_softmax(const float* qs, const float* ks, float* probs,
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
        lg[jj] = ex2((lg[jj] - m) * kLog2e);
        sum += lg[jj];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float inv = __frcp_rn(sum);
    float* row = probs + (t * F + i) * F;
#pragma unroll
    for (int jj = 0; jj < JM; ++jj)
      if (active && jj < jh && j0 + jj < F)
        row[j0 + jj] = __bfloat162float(__float2bfloat16(lg[jj] * inv));
  }
}

struct AttnParams {
  CUtensorMap th;          // h (B, F, L, C) as (C, L, F, B): boxes (64, Lt, F, 1)
  CUtensorMap tw[3];       // W_q, W_k, W_v (inner, C): boxes (64, D)
  bf16* o;                 // (B, F, L, inner)
  int F, L, C, inner, Lt, kchunks, stages;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kHeadThreads, D <= 64 ? 2 : 1)
    motion_attn(const __grid_constant__ AttnParams p) {
  constexpr int DS = D + kPad;
  constexpr int XB = kHeadRows * 128, WB = D * 128, SB = XB + 3 * WB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sR = smem_u32(base_ptr);
  const int stages = p.stages;
  const int region = region_bytes(D, stages);
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

  const int arow = 64 * wg;  // the warpgroup's first row
  float q[D / 2], k[D / 2], v[D / 2];
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
      wgmma_ss<D>(q, da, make_desc<128>(st + XB + kk * 32, 16), acc);
      wgmma_ss<D>(k, da, make_desc<128>(st + XB + WB + kk * 32, 16), acc);
      wgmma_ss<D>(v, da, make_desc<128>(st + XB + 2 * WB + kk * 32, 16), acc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(q);
    fence_regs<D / 2>(k);
    fence_regs<D / 2>(v);
  }
  // every warpgroup is done with the ring: stage q, k (f32) and v (bf16-rounded)
  __syncthreads();
  float* qs = reinterpret_cast<float*>(base_ptr);
  float* ks = qs + kHeadRows * DS;
  float* vs = ks + kHeadRows * DS;
  {
    const int g = lane >> 2, qd = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = arow + 16 * warp + g + 8 * j;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = 8 * c + 2 * qd;
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
  if (jh <= 2) head_logits_softmax<D, 2>(qs, ks, probs, p.scale, F, Lt, nt);
  else if (jh <= 4) head_logits_softmax<D, 4>(qs, ks, probs, p.scale, F, Lt, nt);
  else if (jh <= 8) head_logits_softmax<D, 8>(qs, ks, probs, p.scale, F, Lt, nt);
  else head_logits_softmax<D, 16>(qs, ks, probs, p.scale, F, Lt, nt);
  __syncthreads();
  // o = P . V, f32 sums, 16-byte bf16 stores; a thread takes 8 columns of
  // two query frames, so that each v load serves both
  constexpr int NV = D / 8;
  const int fp = (F + 1) / 2;
  for (int idx = tid; idx < nt * fp * NV; idx += kHeadThreads) {
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

template <int D>
int launch_heads(const AttnParams& p, int H, int B, int smem, cudaStream_t st) {
  static cudaError_t attr = cudaFuncSetAttribute(
      motion_attn<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(H, (p.L + p.Lt - 1) / p.Lt, B);
  motion_attn<D><<<grid, kHeadThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}


// ====================================================================
// the cluster regime (d = 80, 128, 160: levels 1-3 and the mid block)
// ====================================================================

constexpr int kClThreads = 384;  // 2 MMA warpgroups, warp 8 (TMA), warps 9-11
constexpr int kClAttn = 352;     // the threads of the frame attention: all but warp 8's
constexpr int kClSpan = 64;      // bf16 columns of a chunk: one 128-byte swizzle span

// d <= 96: each MMA warpgroup owns a 64-row group (2 Lh tokens a CTA); d >=
// 128: one 64-row group (Lh tokens) whose head columns the two split
__host__ __device__ constexpr int cl_groups(int d) { return d >= 128 ? 1 : 2; }
// a ring stage: the CTA's h chunk (64 rows x 128 bytes a group), then the
// head's W_q, W_k and W_v chunks (d rows x 128 bytes each)
__host__ __device__ constexpr int cl_stage_bytes(int d) {
  return round_up(cl_groups(d) * 64 * 128 + 3 * d * 128, 1024);
}
// the attention groups (q, k, P, v^T as in the fused regime), which alias
// the ring's last stages
__host__ __device__ constexpr int cl_staging_bytes(int d) { return cl_groups(d) * group_bytes(d); }
// the ring's first stages that the staging leaves alone
__host__ __device__ constexpr int cl_free_stages(int d, int stages) {
  return (stages * cl_stage_bytes(d) - cl_staging_bytes(d)) / cl_stage_bytes(d);
}
// the ring (at least as large as the staging) and the mbarriers (full and
// empty a stage)
__host__ __device__ constexpr int cl_smem(int d, int stages) {
  return 1024 + stages * cl_stage_bytes(d) + 8 * 2 * stages;
}

struct ClParams {
  CUtensorMap th;     // h (B, F, L, C) as (C, L, F, B): boxes (64, Lh, F, 1)
  CUtensorMap tw[3];  // W_q, W_k, W_v (inner, C): boxes (64, d / cs)
  bf16* o;            // (B, F, L, inner)
  int F, L, C, inner, H, lh, kchunks, stages, cs, nblk, ntb, units;
  float scale;
};

// unit u of a cluster: head hd (heads fastest, so that the clusters running
// at once share their h rows in L2) over cs neighbouring token blocks of
// the flattened (row, block) index; CTA `rank` takes block tb = (u / H) cs +
// rank: row b, first token l0, nt[g] valid tokens in its group g (none
// past the last block)
struct ClUnit {
  int hd, b, l0, nt[2];
};
template <int G>
__device__ __forceinline__ ClUnit cl_unit(const ClParams& p, int u, int rank) {
  ClUnit r;
  r.hd = u % p.H;
  const int tb = (u / p.H) * p.cs + rank;
  const bool valid = tb < p.ntb;
  r.b = valid ? tb / p.nblk : 0;
  r.l0 = valid ? (tb % p.nblk) * G * p.lh : 0;
#pragma unroll
  for (int g = 0; g < 2; ++g)
    r.nt[g] = valid && g < G ? max(0, min(p.lh, p.L - r.l0 - g * p.lh)) : 0;
  return r;
}

// The logits and softmax of TP threads a (token t, query frame i) pair,
// pair pi = t F + i of a group (na of them), for thread tg = TP pi + part:
// the key frames j = part, part + TP, ... (at most JM), f32 dot products of
// length D of the staged q and k times `scale`, the f32 softmax over the
// key frames (the TP threads exchange their maximum and sum), the
// probabilities rounded to bf16 into P at query row i Lh + t, key column j
// Lh + t (P's other entries stay zero). Every thread of a warp calls it.
template <int D, int JM, int TP>
__device__ __forceinline__ void pair_logits(const float* qs, const float* ks, uint8_t* ptile,
                                            float scale, int F, int lh, int na, int tg) {
  constexpr int DS = D + kPad;
  const int pi = tg / TP, part = tg % TP;
  const bool active = pi < na;
  const int t = active ? pi / F : 0, i = active ? pi % F : 0;
  float lg[JM];
#pragma unroll
  for (int jj = 0; jj < JM; ++jj) lg[jj] = 0.f;
  if (active) {
    const float4* qv = reinterpret_cast<const float4*>(qs + (i * lh + t) * DS);
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = qv[c];
#pragma unroll
      for (int jj = 0; jj < JM; ++jj) {
        const int j = part + TP * jj;
        if (j < F) {
          const float4 k = reinterpret_cast<const float4*>(ks + (j * lh + t) * DS)[c];
          lg[jj] = fmaf(a.x, k.x, fmaf(a.y, k.y, fmaf(a.z, k.z, fmaf(a.w, k.w, lg[jj]))));
        }
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < JM; ++jj) {
    lg[jj] *= scale;
    if (active && part + TP * jj < F) m = fmaxf(m, lg[jj]);
  }
#pragma unroll
  for (int off = 1; off < TP; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < JM; ++jj)
    if (active && part + TP * jj < F) {
      lg[jj] = ex2((lg[jj] - m) * kLog2e);
      sum += lg[jj];
    }
#pragma unroll
  for (int off = 1; off < TP; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (!active) return;
  const float inv = __frcp_rn(sum);
  const int r = i * lh + t;
#pragma unroll
  for (int jj = 0; jj < JM; ++jj) {
    const int j = part + TP * jj;
    if (j < F)
      *reinterpret_cast<bf16*>(ptile + tile_off(r, j * lh + t)) = __float2bfloat16(lg[jj] * inv);
  }
}

// the unit's frame attention logits over kClAttn threads (lt): TP = 4
// threads a pair where that covers every pair of both groups in one pass,
// else 2
template <int D, int G>
__device__ __forceinline__ void cl_logits(const ClParams& p, uint8_t* groups, const ClUnit& un,
                                          int lt) {
  const int na0 = un.nt[0] * p.F, na1 = un.nt[1] * p.F;
  const int tp = 4 * (na0 + na1) <= kClAttn ? 4 : 2, jm = (p.F + tp - 1) / tp;
  for (int base = 0; base < tp * (na0 + na1); base += kClAttn) {
    const int pr = (base + lt) / tp;
    const int g = G == 2 && pr >= na0 ? 1 : 0;
    uint8_t* gb = groups + g * group_bytes(D);
    const float* qs = reinterpret_cast<const float*>(gb);
    const float* ks = qs + 64 * (D + kPad);
    uint8_t* pt = gb + qk_bytes(D);
    const int na = g ? na1 : na0, tg = tp * (pr - (g ? na0 : 0)) + (base + lt) % tp;
    if (tp == 4) {
      if (jm <= 2) pair_logits<D, 2, 4>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
      else if (jm <= 4) pair_logits<D, 4, 4>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
      else pair_logits<D, 8, 4>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
    } else {
      if (jm <= 2) pair_logits<D, 2, 2>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
      else if (jm <= 4) pair_logits<D, 4, 2>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
      else if (jm <= 8) pair_logits<D, 8, 2>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
      else pair_logits<D, 16, 2>(qs, ks, pt, p.scale, p.F, p.lh, na, tg);
    }
  }
}

// Persistent clusters of cs CTAs, each cluster walking every
// (gridDim.x / cs)-th unit. Warp 8's first thread loads the CTA's h rows
// and its 1 / cs of the head's weight chunks, multicast to the cluster;
// warpgroups 0 and 1 run the q/k/v products, stage them and run P . V;
// warps 0-7 and 9-11 run the logits and softmax between.
template <int D>
__global__ void __launch_bounds__(kClThreads, 1) motion_cluster(const __grid_constant__ ClParams p) {
  constexpr int G = cl_groups(D);
  constexpr bool SPLIT = G == 1;
  constexpr int NC = SPLIT ? D / 2 : D;  // a warpgroup's columns of q, k, v and o
  constexpr int NW = 3 * NC;             // its product: q, k and v side by side
  constexpr int DS = D + kPad;
  constexpr int STAGE = cl_stage_bytes(D);
  constexpr int HB = G * 64 * 128;       // the h part of a stage
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sRing = smem_u32(base_ptr);
  const int stages = p.stages, nfree = cl_free_stages(D, stages);
  // the staging: the ring's last bytes, from stage nfree on
  const uint32_t groups_off = stages * STAGE - cl_staging_bytes(D);
  uint8_t* groups = base_ptr + groups_off;
  const uint32_t bars = sRing + stages * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const int rank = (int)cluster_rank(), cid = blockIdx.x / p.cs, ncl = gridDim.x / p.cs;

  // h rows that no box writes (64 - F Lh of a group) stay zero, so v's
  // rows there are zero; so do P's entries between frames of two tokens
  for (uint32_t i = threadIdx.x * 16; i < bars - sRing; i += kClThreads * 16)
    *reinterpret_cast<uint4*>(base_ptr + i) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8 * p.cs);  // every MMA warp of the cluster frees the stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  // every CTA's barriers and zeroed ring before any multicast or remote arrival
  cluster_arrive();
  cluster_wait();

  // Each unit's chunk kc takes stage kc % stages, so that the next unit's
  // first nfree chunks load while this unit's attention holds the rest;
  // the parity of each stage's barriers is a bit of `ph`
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (threadIdx.x == 256) {
      // ------------------------------------------------------------ TMA
      const uint16_t mask = (uint16_t)((1u << p.cs) - 1);
      const int slice = D / p.cs, a = rank * slice;  // this CTA's rows of each weight
      const uint32_t hbytes = p.lh * p.F * 128, wbytes = 3 * D * 128;
      uint32_t ph = 0;
      for (int u = cid; u < p.units; u += ncl) {
        const ClUnit un = cl_unit<G>(p, u, rank);
        const int nh = (un.nt[0] > 0) + (un.nt[1] > 0);
        for (int kc = 0; kc < p.kchunks; ++kc) {
          const int s = kc % stages;
          mbar_wait(empty(s), ((ph >> s) & 1) ^ 1);
          ph ^= 1u << s;
          const uint32_t st = sRing + s * STAGE;
          mbar_expect_tx(full(s), nh * hbytes + wbytes);
          for (int w = 0; w < nh; ++w)
            tma_load(st + w * 64 * 128, &p.th, full(s), kc * kClSpan, un.l0 + w * p.lh, 0, un.b);
          // a warpgroup's q, k and v rows lie side by side (SPLIT: each
          // warpgroup's half of the head)
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int row = SPLIT ? (a / NC) * NW + i * NC + a % NC : i * D + a;
            tma_load_2d_mc(st + HB + row * 128, &p.tw[i], full(s), kc * kClSpan, un.hd * D + a,
                           mask);
          }
        }
      }
    } else if (threadIdx.x >= 288) {
      // ------------------------------------------- logits and softmax
      for (int u = cid; u < p.units; u += ncl) {
        named_sync(1, kClAttn);  // the unit's q, k and v are staged
        cl_logits<D, G>(p, groups, cl_unit<G>(p, u, rank), threadIdx.x - 288 + 256);
        fence_proxy_async();     // P is read by wgmma
        named_sync(2, kClAttn);
      }
    }
  } else {
    // ------------------------------------------------------------- MMA
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int grp = SPLIT ? 0 : wg, col0 = SPLIT ? wg * NC : 0;
    const uint32_t aoff = grp * 64 * 128, boff = HB + (SPLIT ? wg * NW * 128 : 0);
    uint8_t* gb = groups + grp * group_bytes(D);
    float* qs = reinterpret_cast<float*>(gb);
    float* ks = qs + 64 * DS;
    uint8_t* vtile = gb + qk_bytes(D) + 64 * 128;
    const uint32_t sP = sRing + groups_off + grp * group_bytes(D) + qk_bytes(D),
                   sVt = sP + 64 * 128;
    const int g = lane >> 2, qd = lane & 3;
    // frees a stage in every CTA of the cluster: lanes 0 .. cs - 1 arrive
    // on CTA `lane`'s barrier
    auto release = [&](int st) {
      __syncwarp();
      if (lane < p.cs) mbar_arrive_cluster(empty(st), lane);
    };
    float acc[NW / 2];
    uint32_t ph = 0;
    for (int u = cid; u < p.units; u += ncl) {
      const ClUnit un = cl_unit<G>(p, u, rank);
      // the unit's q, k and v: one m64 n NW k16 product a k step, the last
      // chunk's kept in flight while the next one's stage is awaited; a
      // stage that the staging aliases is freed for its next use in the
      // unit, else after the attention
      int pend = -1;
      for (int kc = 0; kc < p.kchunks; ++kc) {
        const int s = kc % stages;
        mbar_wait(full(s), (ph >> s) & 1);
        ph ^= 1u << s;
        const uint32_t st = sRing + s * STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kClSpan / 16; ++kk)
          wgmma_ss<NW>(acc, make_desc<128>(st + aoff + kk * 32, 16),
                       make_desc<128>(st + boff + kk * 32, 16), kc > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<NW / 2>(acc);
        if (pend >= 0 && (pend % stages < nfree || pend + stages < p.kchunks))
          release(pend % stages);
        pend = kc;
      }
      wgmma_wait_all();
      fence_regs<NW / 2>(acc);
      if (pend % stages < nfree || pend + stages < p.kchunks) release(pend % stages);
      // both warpgroups' products have read the stages that the staging
      // aliases
      named_sync(3, 256);
      // P is zero between the frames of two tokens (the staging's bytes
      // held ring stages in between)
      for (int i = threadIdx.x * 16; i < G * 64 * 128; i += 256 * 16)
        *reinterpret_cast<uint4*>(groups + (i >> 13) * group_bytes(D) + qk_bytes(D) + (i & 8191)) =
            make_uint4(0, 0, 0, 0);
      // q and k in f32, v rounded to bf16 and transposed (register 4 c + 2
      // j + e holds row 16 warp + g + 8 j, column 8 c + 2 qd + e of q's,
      // then k's, then v's columns); v is zero in the rows that hold no
      // token, whose h rows the ring's reuse left arbitrary
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * warp + g + 8 * j;
        const bool tok = r < p.F * p.lh && r % p.lh < un.nt[grp];
#pragma unroll
        for (int c = 0; c < NW / 8; ++c) {
          const int part = 8 * c / NC, col = col0 + 8 * c % NC + 2 * qd;
          const float v0 = acc[4 * c + 2 * j], v1 = acc[4 * c + 2 * j + 1];
          if (part == 0) {
            *reinterpret_cast<float2*>(qs + r * DS + col) = make_float2(v0, v1);
          } else if (part == 1) {
            *reinterpret_cast<float2*>(ks + r * DS + col) = make_float2(v0, v1);
          } else {  // v^T[col][r]
            *reinterpret_cast<bf16*>(vtile + tile_off(col, r)) = __float2bfloat16(tok ? v0 : 0.f);
            *reinterpret_cast<bf16*>(vtile + tile_off(col + 1, r)) = __float2bfloat16(tok ? v1 : 0.f);
          }
        }
      }
      fence_proxy_async();  // P and v^T are read by wgmma
      named_sync(1, kClAttn);
      cl_logits<D, G>(p, groups, un, threadIdx.x);
      fence_proxy_async();  // P is read by wgmma
      named_sync(2, kClAttn);
      // P . V: m64 n NC k16 x 4 over the group's 64 keys (bf16 P times
      // bf16 v^T, f32 sums), stored into o as bf16 pairs
      {
        float oacc[NC / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<NC>(oacc, make_desc<128>(sP + kk * 32, 16),
                       make_desc<128>(sVt + col0 * 128 + kk * 32, 16), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NC / 2>(oacc);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * warp + g + 8 * j, i = r / p.lh, t = r - i * p.lh;
          if (i >= p.F || t >= un.nt[grp]) continue;
          bf16* row = p.o + (((size_t)un.b * p.F + i) * p.L + un.l0 + grp * p.lh + t) * p.inner +
                      un.hd * D + col0 + 2 * qd;
#pragma unroll
          for (int c = 0; c < NC / 8; ++c)
            *reinterpret_cast<uint32_t*>(row + 8 * c) =
                mma_tiles::pack_bf16(oacc[4 * c + 2 * j], oacc[4 * c + 2 * j + 1]);
        }
      }
      // the staging is free: the stages it aliases take the next unit's chunks
      for (int kc = max(0, p.kchunks - stages); kc < p.kchunks; ++kc)
        if (kc % stages >= nfree) release(kc % stages);
    }
  }
  __syncwarp();
  // no CTA exits while its cluster may still multicast into it or arrive
  // on its barriers
  cluster_arrive();
  cluster_wait();
}

// how many clusters of cs CTAs (smem bytes each) the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once per (d, cs, smem)
template <int D>
cudaError_t max_clusters(cudaLaunchConfig_t cfg, int cs, int smem, int* out) {
  static int memo_smem[5] = {0, 0, 0, 0, 0}, memo_n[5];
  if (memo_smem[cs] == smem) {
    *out = memo_n[cs];
    return cudaSuccess;
  }
  cfg.gridDim = dim3(cs);
  cudaError_t e = cudaOccupancyMaxActiveClusters(out, (const void*)motion_cluster<D>, &cfg);
  if (e != cudaSuccess) return e;
  memo_smem[cs] = smem;
  memo_n[cs] = *out;
  return cudaSuccess;
}

template <int D>
int launch_cluster(const ClParams& p, int smem, cudaStream_t st) {
  static cudaError_t attr = cudaFuncSetAttribute(
      motion_cluster<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute la;
  la.id = cudaLaunchAttributeClusterDimension;
  la.val.clusterDim.x = p.cs;
  la.val.clusterDim.y = 1;
  la.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &la;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e = max_clusters<D>(cfg, p.cs, smem, &n);
  if (e != cudaSuccess) return (int)e;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;  // such a cluster cannot be scheduled
  cfg.gridDim = dim3((p.units < n ? p.units : n) * p.cs);
  e = cudaLaunchKernelEx(&cfg, motion_cluster<D>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The fused regime on x (B, F, L, C) bf16, C <= 320: H heads of D <= 64
// columns, W_q/W_k/W_v of (inner, C) with inner = H D (inner = C
// unsharded; a head shard's rows under tensor parallelism), gamma and beta
// (C,) in bf16 (ln_bf16) or f32, pe (F, C) f32; writes o (B F L, inner).
// (lh, stages, hg, grid, smem) is the Python plan
// (mmgt_tpu_torch/ops/motion_attention.py:attn_plan), checked here.
extern "C" int mmgt_motion_fused(const void* x, const void* gamma, const void* beta, int ln_bf16,
                                 const void* pe, const void* wq, const void* wk, const void* wv,
                                 void* o, int B, int F, int L, int C, int H, int D, float scale,
                                 float eps, int lh, int stages, int hg, int grid, int smem,
                                 void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || C <= 0 || C % 8 != 0 || C > 64 * kChunks || F < 1 || F > 32 || D > 64)
    return (int)cudaErrorInvalidValue;
  if (lh != (64 / F < L ? 64 / F : L) || stages < 2 || stages > 8 || hg < 1 || H % hg != 0 ||
      smem != fused_smem(D, C, stages) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params p;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)L * C * 2,
                                 (cuuint64_t)F * L * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)lh, (cuuint32_t)F, 1};
  if (!encode_bf16(&p.tx, x, 4, dims, strides, box, 128)) return (int)cudaErrorInvalidValue;
  const int inner = H * D;
  const void* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 3; ++i)
    if (!make_map_2d(&p.tw[i], ws[i], inner, C, D)) return (int)cudaErrorInvalidValue;
  p.gamma = gamma;
  p.beta = beta;
  p.pe = (const float*)pe;
  p.o = (bf16*)o;
  p.ln_bf16 = ln_bf16;
  p.F = F; p.L = L; p.C = C; p.inner = inner; p.lh = lh;
  p.kchunks = (C + 63) / 64;
  p.stages = stages;
  p.hg = hg;
  p.ngroups = H / hg;
  p.nblk = (L + 2 * lh - 1) / (2 * lh);
  const long long units = (long long)B * p.nblk * p.ngroups;
  if (units > 2147483647LL || grid != (units < 132 ? (int)units : 132))
    return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  p.scale = scale;
  p.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fused<16>(p, grid, smem, st);
    case 32: return launch_fused<32>(p, grid, smem, st);
    case 40: return launch_fused<40>(p, grid, smem, st);
    case 64: return launch_fused<64>(p, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mmgt_ln_pe(const void* x, const void* gamma, const void* beta, int ln_bf16,
                          const void* pe, void* h, long long M, int L, int F, int C, float eps,
                          void* stream) {
  if (C <= 0 || C % 8 != 0 || C > 2048 || L <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int threads = 256;
  const int tpr = C <= 640 ? 8 : 32;
  const long long blocks = (M * tpr + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xx = (const bf16*)x;
  const float* p = (const float*)pe;
  bf16* hh = (bf16*)h;
  if (tpr == 8 && ln_bf16)
    ln_pe<8, 10, true><<<(unsigned)blocks, threads, 0, st>>>(xx, gamma, beta, p, hh, M, L, F, C, eps);
  else if (tpr == 8)
    ln_pe<8, 10, false><<<(unsigned)blocks, threads, 0, st>>>(xx, gamma, beta, p, hh, M, L, F, C, eps);
  else if (ln_bf16)
    ln_pe<32, 8, true><<<(unsigned)blocks, threads, 0, st>>>(xx, gamma, beta, p, hh, M, L, F, C, eps);
  else
    ln_pe<32, 8, false><<<(unsigned)blocks, threads, 0, st>>>(xx, gamma, beta, p, hh, M, L, F, C, eps);
  return (int)cudaGetLastError();
}

// The per-head kernel on h = ln_pe(x): H heads of D columns (D <= 64 at C >
// 320, or 96: the shapes the fused and cluster regimes do not take),
// W_q/W_k/W_v of (inner, C) with inner = H D (inner = C unsharded; a head
// shard's rows under tensor parallelism), o (B F L, inner). (lt, stages,
// smem) is the Python plan, checked here.
extern "C" int mmgt_motion_heads(const void* h, const void* wq, const void* wk, const void* wv,
                                void* o, int B, int F, int L, int C, int H, int D, float scale,
                                int lt, int stages, int smem, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || D <= 0 || C % 8 != 0 || F < 1 || F > 32 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int inner = H * D;
  if (lt < 1 || lt * F > kHeadRows || lt > L || stages < 2 || stages > 4 ||
      smem != attn_smem(D, stages, F, lt) || smem > kMaxSmem)
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
  switch (D) {  // d = 80, 128 and 160 are the cluster regime's
    case 16: return launch_heads<16>(p, H, B, smem, st);
    case 32: return launch_heads<32>(p, H, B, smem, st);
    case 40: return launch_heads<40>(p, H, B, smem, st);
    case 64: return launch_heads<64>(p, H, B, smem, st);
    case 96: return launch_heads<96>(p, H, B, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// The cluster regime on h = ln_pe(x): H heads of D = 80, 128 or 160
// columns, W_q/W_k/W_v of (inner, C) with inner = H D (a head shard's rows
// under tensor parallelism), o (B F L, inner); clusters of cs CTAs (D / cs
// a multiple of 8). (cs, lh, stages, smem) is the Python plan, checked
// here; the grid is as many clusters as the card holds at once (at most
// one a unit), and a cluster the card cannot hold is an error.
extern "C" int mmgt_motion_cluster(const void* h, const void* wq, const void* wk, const void* wv,
                                   void* o, int B, int F, int L, int C, int H, int D, float scale,
                                   int cs, int lh, int stages, int smem, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || C <= 0 || C % 8 != 0 || F < 1 || F > 32 || (D != 80 && D != 128 && D != 160) ||
      (cs != 2 && cs != 4) || (D / cs) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (lh != (64 / F < L ? 64 / F : L) || stages < 2 || stages > 8 || smem != cl_smem(D, stages) ||
      smem > kMaxSmem || cl_free_stages(D, stages) < 1)
    return (int)cudaErrorInvalidValue;
  ClParams p;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)L * C * 2,
                                 (cuuint64_t)F * L * C * 2};
  const cuuint32_t box[4] = {kClSpan, (cuuint32_t)lh, (cuuint32_t)F, 1};
  if (!encode_bf16(&p.th, h, 4, dims, strides, box, 128)) return (int)cudaErrorInvalidValue;
  const int inner = H * D;
  const void* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 3; ++i)
    if (!make_map_2d(&p.tw[i], ws[i], inner, C, D / cs))
      return (int)cudaErrorInvalidValue;
  p.o = (bf16*)o;
  p.F = F; p.L = L; p.C = C; p.inner = inner; p.H = H; p.lh = lh;
  p.kchunks = (C + kClSpan - 1) / kClSpan;
  p.stages = stages;
  p.cs = cs;
  p.nblk = (L + cl_groups(D) * lh - 1) / (cl_groups(D) * lh);
  const long long ntb = (long long)B * p.nblk, units = (long long)H * ((ntb + cs - 1) / cs);
  if (units > 2147483647LL) return (int)cudaErrorInvalidValue;
  p.ntb = (int)ntb;
  p.units = (int)units;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 80: return launch_cluster<80>(p, smem, st);
    case 128: return launch_cluster<128>(p, smem, st);
    case 160: return launch_cluster<160>(p, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

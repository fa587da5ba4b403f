// K3: LayerNorm fused into 1-3 projections, for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel
// (reached by _ln_proj_fwd, :62):
//     y_i = (LN(x) * gamma + beta) @ W_i^T + b_i,   i < 3,
// with f32 row statistics (eps inside the rsqrt), the normalised row
// rounded to bf16 before the product (as the TPU kernel rounds x_n to the
// weight dtype) and f32 accumulation; the bias (and, for K4's output
// projection, a bf16 residual) is added in f32 in the epilogue. Without
// gamma the same kernel is a plain GEMM (K4's W_o, csrc/motion_attn.cu's
// caller). One call for all weights: one launch, or two in the tiled
// regime with a LayerNorm (its pre-pass, then the GEMM).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes at the level-0
// q/k/v shape (x (48, 4096, 320) against 3 x (320, 320): 503 MB moved,
// 0.150 ms; 0.121 ms of operations), bytes and operations alike at the
// level-0 GEGLU (N = 2560: 0.338 ms of bytes, 0.326 ms of operations),
// operations at the K >= 640 projections (the level-2 audio q, x (6144,
// 1280) against 3 x (1280, 1280): 0.061 ms; the level-1 GEGLU, x (49152,
// 640) against (5120, 640): 0.326 ms), bytes at K4's level-1 W_o with its
// residual (x, residual and output (49152, 640): 0.057 ms).
//
// Two regimes, one design each, chosen by K alone
// (mmgt_tpu_torch/ops/fused_ln.py:gemm_plan, checked here):
//
// Stripe (K <= 576, where a 128-row stripe of x and two weight tiles fit):
// the TPU kernel's design, one x block against every weight
// (mmgt_tpu/ops/fused_ln.py:37-56).
//   * A block owns 128 rows of x and loads the whole stripe once by TMA
//     (2-D map, 64-column boxes, 128-byte swizzle; 80 KB at K = 320). The
//     consumers compute each row's f32 mean and rstd from shared memory (2
//     threads a row, two passes as the reference), normalise the stripe in
//     place to bf16 in the same swizzled layout, once, and fence the
//     generic proxy before wgmma reads it. x is read from device memory
//     once.
//   * One producer thread walks the (N tile, 64-deep k chunk) pairs of
//     every weight and loads BN x 64 tiles (BN = 160, torch's (N, K)
//     layout, so both operands are K-major) through a ring of as many 20 KB
//     stages as fit (5 at K = 320; at most 8), guarded by full/empty
//     mbarriers. Two consumer warpgroups run m64n160k16 on 64 rows each.
//   * Epilogue: the f32 bias (and a residual, loaded by TMA first) added in
//     registers, the bf16 result staged in a 64 x 160 tile and written by
//     one TMA store, which clips the ragged edges.
//   * Grid: (stripes, N splits): where the stripes alone fill less than two
//     waves of 132 SMs, the N tiles are split over several blocks a stripe.
//
// Tiled (K >= 640, where a whole-K stripe of 128 rows no longer fits
// beside a ring; any K): 128 x 256 output tiles, both operands streamed.
//   * LayerNorm pre-pass (ln_gemm_rows, the same call): one warp a row, the
//     f32 mean and the centred variance in two passes as the reference,
//     then (x - mean) * rstd * gamma + beta in f32 rounded to bf16 (the
//     rounding the TPU kernel gives its product's operand) into xn, an
//     (M, K) bf16 scratch from the caller, which the GEMM reads as its x.
//     Normalising each 64-column chunk inside the GEMM instead, once for
//     every 256-column tile (in shared memory, or in registers for a
//     register-A wgmma), was measured slower on the card: the consumers'
//     normalisation did not overlap the tensor cores (PERF.md).
//   * A tile is 128 rows of x by two 128-column units of the weights (a
//     unit is one weight's rows [128 j, 128 j + 128); the two units of a
//     tile may belong to different weights, so 640-column weights waste no
//     columns). Each weight byte brought into the SM feeds 128 rows, each
//     x byte 256 columns: 48 KB a 64-deep k chunk for 2.1 M multiply-adds
//     (a 64-row stripe against 160-column weight tiles: 20 KB for 0.66 M).
//   * One producer thread loads, per k chunk, the x box (128 x 64) and the
//     tile's two weight boxes (128 x 64 each) into one 48 KB stage of a ring
//     (4 stages), guarded by full/empty mbarriers. K has no upper limit:
//     nothing of the row stays resident.
//   * Two consumer warpgroups own 64 rows each and run m64n256k16 over both
//     units, both operands from shared memory (128 f32 accumulators a
//     thread, setmaxnreg 240; the producer warpgroup 24), one committed
//     group kept in flight.
//   * Persistent blocks, one an SM, each taking every 132nd tile of an
//     order that walks groups of 16 row tiles column tile by column tile,
//     so the blocks that run together share x rows and weight columns in
//     L2; the producer loads the next tile's chunks while the consumers run
//     the epilogue.
//   * Epilogue, per unit: the f32 bias and an optional residual (loaded by
//     TMA into the staging tile first) added in registers, the bf16 result
//     written to a 64 x 128 staging tile in 128-byte-swizzled 64-column
//     boxes (conflict-free for the accumulator layout) and stored by TMA,
//     which clips rows past M and columns past N.
//   * Deterministic: no partial sum crosses a block, so two calls on the
//     same inputs give the same bits.
//   * What bounds it (PERF.md): the operations (the bytes at K4's level-1
//     W_o). The pre-pass moves x twice
//     more (read, and xn written; the GEMM's reads of xn mostly hit L2), the
//     chunks come from L2 at 48 KB every 1024 tensor-core cycles (about 47
//     bytes a clock an SM), and the tensor cores idle through each tile's
//     epilogue. A 2-CTA cluster multicasting the weight boxes (half the
//     weight reads from L2) was measured slower (PERF.md).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int kThreads = 384;               // 2 consumer warpgroups + 1 producer
constexpr int kSpan = 64;                   // bf16 columns of one 128-byte swizzle span
constexpr int kMaxSmem = 232448;            // 227 KB a block
constexpr int BM = 128;                     // rows of a stripe or of a tile

// stripe regime: 160-column weight tiles, a 64 x 160 staging tile a warpgroup
constexpr int SBN = 160;
constexpr int kStripeStage = SBN * 128;
__host__ __device__ inline int stripe_smem(int kchunks, int stages) {
  return 1024 + kchunks * BM * 128 + 2 * 64 * SBN * 2 + stages * kStripeStage +
         8 * (2 * stages + 3);
}

// tiled regime: stages of (x box, unit 0, unit 1), a 64 x 128 staging tile a
// warpgroup
constexpr int TU = 128;                     // columns of a unit
constexpr int kABytes = BM * 128;           // x box: 128 rows x 64 columns
constexpr int kUBytes = TU * 128;           // weight box: 128 rows x 64 columns
constexpr int kTileStage = kABytes + 2 * kUBytes;
constexpr int kStgBytes = 64 * TU * 2;
constexpr int kGroup = 16;                  // row tiles of a group in the tile order
__host__ __device__ inline int tiled_smem(int stages) {
  return 1024 + stages * kTileStage + 2 * kStgBytes + 8 * (2 * stages + 2);
}

struct GemmParams {
  CUtensorMap tx;          // x (M, K): boxes 64 x 128, 128-byte swizzle
  CUtensorMap tw[3];       // W_i (N_i, K): boxes 64 x 160 (stripe) or 64 x 128 (tiled), swizzled
  CUtensorMap to[3];       // out_i (M, N_i): boxes 160 x 64 unswizzled (stripe) or 64 x 64 swizzled
  CUtensorMap tr[3];       // residual_i (M, N_i), as to[i]
  const bf16* x;           // x itself: the tiled regime's LayerNorm pre-pass reads it
  bf16* xn;                // and writes the normalised x here, the GEMM's operand
  const float* gamma;      // (K,) f32; null: x is used as it is
  const float* beta;       // (K,) f32
  const float* bias[3];    // (N_i,) f32 or null
  int n[3], tiles[3], has_res[3];  // N_i, its tiles (stripe) or units (tiled), residual?
  int M, K, kchunks, stages, nsplit, total;  // total: tiles (stripe) or units (tiled)
  int mtiles, ntiles, ttotal;  // tiled: row tiles, 256-column tiles a row tile, tiles in all
  float eps;
};

// the weight and index within it of stripe tile / tiled unit t
__device__ __forceinline__ void tile_of(const GemmParams& p, int t, int& wi, int& nt) {
  wi = 0;
  while (t >= p.tiles[wi]) t -= p.tiles[wi++];
  nt = t;
}

// tile t of the tiled regime's order: groups of kGroup row tiles, each
// walked column tile by column tile, so the blocks that run together share
// their x rows and weight columns in L2
__device__ __forceinline__ void tile_at(const GemmParams& p, int t, int& mt, int& u0) {
  const int per = kGroup * p.ntiles;
  const int g0 = (t / per) * kGroup, rows = min(kGroup, p.mtiles - g0), in = t % per;
  mt = g0 + in % rows;
  u0 = 2 * (in / rows);
}

// ====================================================================
// stripe regime
// ====================================================================

// 16-byte chunk `ch` (columns 8 ch .. 8 ch + 7) of stripe row r
__device__ __forceinline__ uint32_t stripe_off(int r, int ch) {
  return (uint32_t)((ch >> 3) * BM * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// LayerNorm of the stripe in place: 2 neighbouring consumer threads share a
// row (its 16-byte chunks interleaved between them); f32 mean and variance
// in two passes over shared memory, then y = (x - mean) * rstd * gamma +
// beta rounded to bf16. Columns past K stay zero (TMA's fill); rows past M
// are normalised too but never stored.
__device__ void normalise_stripe(const GemmParams& p, uint8_t* sa) {
  constexpr int TPR = 256 / BM;
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int nch = p.K / 8;
  float s = 0.f;
  for (int ch = sub; ch < nch; ch += TPR) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sa + stripe_off(r, ch));
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
#pragma unroll
  for (int off = TPR / 2; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / p.K;
  float v = 0.f;
  for (int ch = sub; ch < nch; ch += TPR) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sa + stripe_off(r, ch));
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - mean;
      v += d * d;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const float rstd = rsqrtf(v / p.K + p.eps);
  for (int ch = sub; ch < nch; ch += TPR) {
    uint4* at = reinterpret_cast<uint4*>(sa + stripe_off(r, ch));
    uint4 raw = *at;
    bf16* e = reinterpret_cast<bf16*>(&raw);
    const float4* g4 = reinterpret_cast<const float4*>(p.gamma + 8 * ch);
    const float4* b4 = reinterpret_cast<const float4*>(p.beta + 8 * ch);
    const float4 g0 = __ldg(g4), g1 = __ldg(g4 + 1), b0 = __ldg(b4), b1 = __ldg(b4 + 1);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16((__bfloat162float(e[i]) - mean) * rstd * g[i] + b[i]);
    *at = raw;
  }
}

// bias (+ residual) of one warpgroup's 64 x 160 accumulator into its bf16
// staging tile (row-major), then one TMA store of the tile (rows and
// columns past the output's edge are not written). The residual, where
// there is one, is loaded into the staging tile by TMA first. stg: the
// staging tile's shared address and generic pointer; rbar, rphase: the
// residual-load barrier and its parity.
__device__ __forceinline__ void stripe_epilogue(const GemmParams& p, const float* acc, int wi,
                                                int row0, int col0, uint32_t stg,
                                                uint8_t* stg_ptr, uint32_t rbar,
                                                uint32_t& rphase) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  const int N = p.n[wi];
  const float* bias = p.bias[wi];
  const bool res = p.has_res[wi];
  // the previous tile's store has read the staging tile
  if (leader) bulk_wait_read();
  named_sync(2 + wg, 128);
  if (res) {
    if (leader) {
      mbar_expect_tx(rbar, 64 * SBN * 2);
      tma_load_2d(stg, &p.tr[wi], rbar, col0, row0);
    }
    mbar_wait(rbar, rphase);
    rphase ^= 1;
  }
  bf16* tile = reinterpret_cast<bf16*>(stg_ptr);
#pragma unroll
  for (int c = 0; c < SBN / 8; ++c) {
    const int col = 8 * c + 2 * q;
    float2 bb = make_float2(0.f, 0.f);
    if (bias && col0 + col < N) bb = __ldg(reinterpret_cast<const float2*>(bias + col0 + col));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = 16 * warp + g + 8 * j;
      __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(tile + row * SBN + col);
      float y0 = acc[4 * c + 2 * j] + bb.x, y1 = acc[4 * c + 2 * j + 1] + bb.y;
      if (res) {
        const float2 r = __bfloat1622float2(*at);
        y0 += r.x;
        y1 += r.y;
      }
      *at = __floats2bfloat162_rn(y0, y1);
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);
  if (leader) {
    tma_store_2d(&p.to[wi], stg, col0, row0);
    bulk_commit();
  }
}

__global__ void __launch_bounds__(kThreads, 1) ln_gemm_stripe(const __grid_constant__ GemmParams p) {
  constexpr int STG = 64 * SBN * 2;  // one warpgroup's staging tile
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sA = smem_u32(base_ptr);
  const uint32_t sStg = sA + p.kchunks * BM * 128;
  const uint32_t sB = sStg + 2 * STG;
  const uint32_t bars = sB + p.stages * kStripeStage;
  const int stages = p.stages;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const uint32_t abar = bars + 16u * stages;
  const int m0 = blockIdx.x * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(abar, 1);
    mbar_init(abar + 8, 1);   // residual loads of warpgroup 0
    mbar_init(abar + 16, 1);  // and 1
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(abar, (uint32_t)(p.kchunks * BM * 128));
      for (int kc = 0; kc < p.kchunks; ++kc)
        tma_load_2d(sA + kc * BM * 128, &p.tx, abar, kc * kSpan, m0);
      int it = 0;
      for (int t = blockIdx.y; t < p.total; t += p.nsplit) {
        int wi, nt;
        tile_of(p, t, wi, nt);
        for (int kc = 0; kc < p.kchunks; ++kc, ++it) {
          const int s = it % stages;
          mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
          mbar_expect_tx(full(s), kStripeStage);
          tma_load_2d(sB + s * kStripeStage, &p.tw[wi], full(s), kc * kSpan, nt * SBN);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int arow = 64 * wg;              // the warpgroup's first stripe row
    const uint32_t stg = sStg + wg * STG;  // this warpgroup's staging tile
    uint8_t* stg_ptr = base_ptr + (stg - sA);
    const uint32_t rbar = abar + 8u * (1 + wg);
    uint32_t rphase = 0;
    auto release = [&](uint32_t bar) {  // a consumed weight stage is free again
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    mbar_wait(abar, 0);
    if (p.gamma) {
      normalise_stripe(p, base_ptr);
      fence_proxy_async();
      named_sync(1, 256);
    }
    float acc[SBN / 2];
    int it = 0;
    for (int t = blockIdx.y; t < p.total; t += p.nsplit) {
      int wi, nt;
      tile_of(p, t, wi, nt);
      for (int kc = 0; kc < p.kchunks; ++kc, ++it) {
        const int s = it % stages;
        mbar_wait(full(s), (it / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<SBN>(acc, make_desc<128>(sA + kc * BM * 128 + arow * 128 + kk * 32, 16),
                        make_desc<128>(sB + s * kStripeStage + kk * 32, 16), kc > 0 || kk > 0);
        wgmma_commit();
        // the previous chunk's group is done: its weight stage is free
        wgmma_wait<1>();
        fence_regs<SBN / 2>(acc);
        if (kc > 0) release(empty((it - 1) % stages));
      }
      wgmma_wait_all();
      fence_regs<SBN / 2>(acc);
      release(empty((it - 1) % stages));
      stripe_epilogue(p, acc, wi, m0 + arow, nt * SBN, stg, stg_ptr, rbar, rphase);
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// ====================================================================
// tiled regime
// ====================================================================

// The tiled regime's LayerNorm pre-pass: one warp a row, 16-byte vectors
// (lane l takes vectors l, l + 32, ...): the f32 mean, then the centred
// variance (two passes, as the reference), then y = (x - mean) * rstd *
// gamma + beta rounded to bf16 (the rounding the TPU kernel gives its
// product's operand) into xn, which the GEMM then reads as its x. The
// second and third passes re-read the row from L1.
__global__ void __launch_bounds__(256) ln_gemm_rows(const __grid_constant__ GemmParams p) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.M) return;  // the whole warp
  const uint4* xr = reinterpret_cast<const uint4*>(p.x + (size_t)row * p.K);
  uint4* yr = reinterpret_cast<uint4*>(p.xn + (size_t)row * p.K);
  const int nv = p.K / 8;
  float s = 0.f;
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    const uint4 raw = __ldg(xr + v);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      s += f.x + f.y;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / p.K;
  float q = 0.f;
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    const uint4 raw = __ldg(xr + v);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      const float d0 = f.x - mean, d1 = f.y - mean;
      q += d0 * d0 + d1 * d1;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float rstd = rsqrtf(q / p.K + p.eps);
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    uint4 raw = __ldg(xr + v);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
    const float4* g4 = reinterpret_cast<const float4*>(p.gamma + 8 * v);
    const float4* b4 = reinterpret_cast<const float4*>(p.beta + 8 * v);
    const float4 g0 = __ldg(g4), g1 = __ldg(g4 + 1), b0 = __ldg(b4), b1 = __ldg(b4 + 1);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn((f.x - mean) * rstd * g[2 * i] + b[2 * i],
                                   (f.y - mean) * rstd * g[2 * i + 1] + b[2 * i + 1]);
    }
    yr[v] = raw;
  }
}

// bias (+ residual) of unit U (accumulator columns [128 U, 128 U + 128)) of
// one warpgroup's 64 x 256 tile into its staging tile: two 64 x 64 boxes,
// rows of 128 bytes in the 128-byte swizzle, so the 8 rows g of a store
// instruction land in 8 distinct 16-byte phases. Then TMA stores of the
// boxes that start inside N (rows past M and columns past N are clipped).
template <int U>
__device__ __forceinline__ void tiled_epilogue(const GemmParams& p, const float* acc, int wi,
                                               int row0, int col0, uint32_t stg,
                                               uint8_t* stg_ptr, uint32_t rbar,
                                               uint32_t& rphase) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  const int N = p.n[wi];
  const int boxes = col0 + kSpan < N ? 2 : 1;
  const float* bias = p.bias[wi];
  const bool res = p.has_res[wi];
  // the previous unit's store has read the staging tile
  if (leader) bulk_wait_read();
  named_sync(2 + wg, 128);
  if (res) {
    if (leader) {
      mbar_expect_tx(rbar, boxes * 64 * kSpan * 2);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(stg + b * 64 * 128, &p.tr[wi], rbar, col0 + b * kSpan, row0);
    }
    mbar_wait(rbar, rphase);
    rphase ^= 1;
  }
#pragma unroll
  for (int c = 0; c < TU / 8; ++c) {
    const int col = 8 * c + 2 * q;
    float2 bb = make_float2(0.f, 0.f);
    if (bias && col0 + col < N) bb = __ldg(reinterpret_cast<const float2*>(bias + col0 + col));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = 16 * warp + g + 8 * j;
      __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
          stg_ptr + (c >> 3) * 64 * 128 + row * 128 + (((c & 7) ^ (row & 7)) << 4) + 4 * q);
      const int a = 4 * (16 * U + c) + 2 * j;
      float y0 = acc[a] + bb.x, y1 = acc[a + 1] + bb.y;
      if (res) {
        const float2 r = __bfloat1622float2(*at);
        y0 += r.x;
        y1 += r.y;
      }
      *at = __floats2bfloat162_rn(y0, y1);
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);
  if (leader) {
    for (int b = 0; b < boxes; ++b)
      tma_store_2d(&p.to[wi], stg + b * 64 * 128, col0 + b * kSpan, row0);
    bulk_commit();
  }
}

__global__ void __launch_bounds__(kThreads, 1) ln_gemm_tiled(const __grid_constant__ GemmParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sS = smem_u32(base_ptr);                // the ring
  const uint32_t sStg = sS + p.stages * kTileStage;      // two staging tiles
  const uint32_t bars = sStg + 2 * kStgBytes;
  const int stages = p.stages;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  // this block's tiles: every gridDim.x-th of the grouped order (tile_at)
  const int first = blockIdx.x, step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(bars + 16u * stages, 1);      // residual loads of warpgroup 0
    mbar_init(bars + 16u * stages + 8, 1);  // and 1
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = first; t < p.ttotal; t += step) {
        int mt, u0;
        tile_at(p, t, mt, u0);
        const int nu = min(2, p.total - u0);
        int w0, j0, w1 = 0, j1 = 0;
        tile_of(p, u0, w0, j0);
        if (nu == 2) tile_of(p, u0 + 1, w1, j1);
        for (int kc = 0; kc < p.kchunks; ++kc, ++it) {
          const int s = it % stages;
          const uint32_t st = sS + s * kTileStage;
          mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
          mbar_expect_tx(full(s), kABytes + nu * kUBytes);
          tma_load_2d(st, &p.tx, full(s), kc * kSpan, mt * BM);
          tma_load_2d(st + kABytes, &p.tw[w0], full(s), kc * kSpan, j0 * TU);
          if (nu == 2) tma_load_2d(st + kABytes + kUBytes, &p.tw[w1], full(s), kc * kSpan, j1 * TU);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const uint32_t stg = sStg + wg * kStgBytes;
    uint8_t* stg_ptr = base_ptr + (stg - sS);
    const uint32_t rbar = bars + 16u * stages + 8u * wg;
    uint32_t rphase = 0;
    auto release = [&](uint32_t bar) {  // a consumed stage is free again
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float acc[128];
    int it = 0;
    for (int t = first; t < p.ttotal; t += step) {
      int mt, u0;
      tile_at(p, t, mt, u0);
      const int nu = min(2, p.total - u0);
      for (int kc = 0; kc < p.kchunks; ++kc, ++it) {
        const int s = it % stages;
        const uint32_t st = sS + s * kTileStage;
        mbar_wait(full(s), (it / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<2 * TU>(acc, make_desc<128>(st + wg * 64 * 128 + kk * 32, 16),
                           make_desc<128>(st + kABytes + kk * 32, 16), kc > 0 || kk > 0);
        wgmma_commit();
        // the previous chunk's group is done: its stage is free
        wgmma_wait<1>();
        fence_regs<128>(acc);
        if (kc > 0) release(empty((it - 1) % stages));
      }
      wgmma_wait_all();
      fence_regs<128>(acc);
      release(empty((it - 1) % stages));
      const int row0 = mt * BM + 64 * wg;  // the warpgroup's first row
      int wi, j;
      tile_of(p, u0, wi, j);
      tiled_epilogue<0>(p, acc, wi, row0, j * TU, stg, stg_ptr, rbar, rphase);
      if (nu == 2) {
        tile_of(p, u0 + 1, wi, j);
        tiled_epilogue<1>(p, acc, wi, row0, j * TU, stg, stg_ptr, rbar, rphase);
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One call for all weights. gamma/beta null: no LayerNorm. xn: the tiled
// regime's normalised x (M x K bf16 scratch, from the caller; unused
// otherwise). (tiled, stages, split, smem) is the Python tile plan, checked
// here: the regime (0: stripe, 1: tiled), the ring depth, the N split of a
// stripe (stripe) or the persistent blocks (tiled), and the shared-memory
// bytes.
extern "C" int mmgt_ln_gemm(
    const void* x, const void* gamma, const void* beta, int M, int K, float eps, int nw,
    const void* w0, const void* w1, const void* w2, int n0, int n1, int n2,
    const void* b0, const void* b1, const void* b2,
    const void* r0, const void* r1, const void* r2,
    void* o0, void* o1, void* o2, void* xn, int tiled, int stages, int split, int smem,
    void* stream) {
  if (nw < 1 || nw > 3 || K <= 0 || (K % 8) != 0 || (tiled != 0 && tiled != 1))
    return (int)cudaErrorInvalidValue;
  // the tiled regime's LayerNorm writes its normalised x to xn (M x K bf16)
  if (tiled && gamma && !xn) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  GemmParams p;
  p.kchunks = (K + kSpan - 1) / kSpan;
  const int want = tiled ? tiled_smem(stages) : stripe_smem(p.kchunks, stages);
  if (stages < 2 || smem != want || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* ws[3] = {w0, w1, w2};
  const int ns[3] = {n0, n1, n2};
  const void* bs[3] = {b0, b1, b2};
  const void* rs[3] = {r0, r1, r2};
  void* os[3] = {o0, o1, o2};
  const int tcols = tiled ? TU : SBN;           // columns of a tile or unit
  const int obox = tiled ? kSpan : SBN;         // output box columns
  const int osw = tiled ? 128 : 0;              // and swizzle
  p.total = 0;
  for (int i = 0; i < 3; ++i) {
    const int j = i < nw ? i : 0;  // unused slots repeat weight 0's maps
    if (ns[j] <= 0 || ns[j] % 8 != 0) return (int)cudaErrorInvalidValue;
    p.n[i] = i < nw ? ns[i] : 0;
    p.tiles[i] = i < nw ? (ns[i] + tcols - 1) / tcols : 0;
    p.bias[i] = i < nw ? (const float*)bs[i] : nullptr;
    p.has_res[i] = i < nw && rs[i] != nullptr;
    p.total += p.tiles[i];
    if (!make_map_2d(&p.tw[i], ws[j], ns[j], K, tcols) ||
        !make_map_2d(&p.to[i], os[j], M, ns[j], 64, obox, osw) ||
        !make_map_2d(&p.tr[i], rs[j] ? rs[j] : os[j], M, ns[j], 64, obox, osw))
      return (int)cudaErrorInvalidValue;
  }
  const bool pre = tiled && gamma;  // the LayerNorm pre-pass runs first
  if (!make_map_2d(&p.tx, pre ? xn : x, M, K, BM)) return (int)cudaErrorInvalidValue;
  p.x = (const bf16*)x;
  p.xn = (bf16*)xn;
  p.gamma = (const float*)gamma; p.beta = (const float*)beta;
  p.M = M; p.K = K; p.stages = stages; p.eps = eps;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(ln_gemm_stripe, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem),
      cudaFuncSetAttribute(ln_gemm_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)};
  if (attr[tiled] != cudaSuccess) return (int)attr[tiled];
  cudaStream_t st = (cudaStream_t)stream;
  const int mtiles = (M + BM - 1) / BM;
  if (tiled) {
    p.nsplit = 1;
    p.ntiles = (p.total + 1) / 2;
    const long long tt = (long long)mtiles * p.ntiles;
    if (tt > 0x7fffffffLL || split < 1 || split > tt || split > 65535)
      return (int)cudaErrorInvalidValue;
    p.mtiles = mtiles;
    p.ttotal = (int)tt;
    if (pre) {
      ln_gemm_rows<<<(M + 7) / 8, 256, 0, st>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    ln_gemm_tiled<<<split, kThreads, smem, st>>>(p);
  } else {
    if (split < 1 || split > p.total || split > 65535) return (int)cudaErrorInvalidValue;
    p.nsplit = split;
    p.mtiles = p.ntiles = p.ttotal = 0;
    ln_gemm_stripe<<<dim3(mtiles, split), kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

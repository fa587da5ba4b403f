// K3: LayerNorm fused into 1-3 projections, for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel
// (reached by _ln_proj_fwd, :62):
//     y_i = (LN(x) * gamma + beta) @ W_i^T + b_i,   i < 3,
// with f32 row statistics (eps inside the rsqrt), the normalised row
// rounded to bf16 before the product (as the TPU kernel rounds x_n to the
// weight dtype) and f32 accumulation; the bias (and, for K4's output
// projection, a bf16 residual) is added in f32 in the epilogue. gamma, beta
// and the biases are read as the caller holds them, bf16 or f32, and
// widened in registers. Without gamma the same kernel is a plain GEMM (K4's
// W_o, csrc/motion_attn.cu's caller). One call for all weights: one launch,
// or two in the tiled regime with a LayerNorm (its pre-pass, then the GEMM).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes at the level-0
// q/k/v shape (x (48, 4096, 320) against 3 x (320, 320): 503 MB moved,
// 0.150 ms; 0.121 ms of operations), bytes and operations alike at the
// level-0 GEGLU (N = 2560: 0.338 ms of bytes, 0.326 ms of operations),
// bytes at K4's level-0 W_o with its residual (x, residual and output
// (196608, 320): 0.113 ms), operations at the K >= 640 projections (the
// level-2 audio q, x (6144, 1280) against 3 x (1280, 1280): 0.061 ms; the
// level-1 GEGLU, x (49152, 640) against (5120, 640): 0.326 ms), bytes at
// K4's level-1 W_o with its residual (x, residual and output (49152, 640):
// 0.057 ms).
//
// Two regimes, one design each, chosen by K alone
// (mmgt_tpu_torch/ops/fused_ln.py:gemm_plan, checked here):
//
// Stripe (K <= 320, every level-0 width): the TPU kernel's idea, one x block against every
// weight (mmgt_tpu/ops/fused_ln.py:37-56), with its loads, LayerNorm and
// epilogues under the products.
//   * Persistent blocks, one an SM, each walking every 132nd work item: a
//     128-row stripe of x and every nsplit-th weight tile (nsplit > 1 only
//     where the stripes alone leave SMs idle). x is read from device memory
//     once (once a split), the normalised x never reaches it, and no
//     partial sum crosses a block, so two calls give the same bits.
//   * Warp 8's first thread loads the item's whole stripe by TMA (2-D map,
//     64-column boxes, 128-byte swizzle; 80 KB at K = 320) into one buffer,
//     and streams BN x 64 weight tiles (torch's (N, K) layout, K-major)
//     through a ring of up to 16 stages guarded by full/empty mbarriers
//     (10 of 10 KB at K = 320). It loads the next item's stripe as soon as
//     the consumers have taken the current one into registers.
//   * Warps 9-11 put gamma, beta and the biases into shared memory as f32
//     (widened from the caller's bf16 or f32), then normalise each stripe
//     in place, one thread a row: the f32 mean and the centred variance in
//     two passes over shared memory, as the reference, then (x - mean) *
//     rstd * gamma + beta rounded to bf16. This runs while the consumers
//     work on the previous item.
//   * Two consumer warpgroups (setmaxnreg 224; the producer warpgroup 56)
//     own 64 rows each. At an item's start each copies its rows of the
//     normalised stripe into registers with ldmatrix, as the A fragments of
//     wgmma m64nBNk16 (K / 16 of them: 80 registers at K = 320), and frees
//     the buffer. Every weight tile then runs from registers, B from the
//     ring; both warpgroups read each stage, so each weight byte brought
//     into the SM feeds 128 rows (1/64 byte of L2 reads a multiply-add).
//   * Two accumulators take turns: tile u + 1's first two chunks are issued
//     before tile u's epilogue, which then runs under the products. BN = 80:
//     two 40-register accumulators beside up to 80 registers of A.
//   * Epilogue: the bias (from the shared table) and a residual (loaded by
//     TMA into the staging tile while the tile ran) added in f32, the bf16
//     result written by stmatrix (four 8 x 8 blocks an instruction; the
//     residual read by ldmatrix) into one of the warpgroup's two staging
//     tiles, a 64 x 64 box in the 128-byte swizzle and a 64 x 16 box in
//     the 32-byte one, so the rows of a block fall on distinct banks, then stored by
//     TMA, which clips rows past M and columns past N. The next tile's
//     epilogue uses the other staging tile.
//   * What bounds it (NVIDIA H100 80GB HBM3, 700 W; throwaway copies timed
//     with tools/k3_rows.py, PERF.md): at the level-0 GEGLU (0.78 ms, 43 %
//     of its bytes bound) the consumer warps' instruction issue. Without
//     the products a call still takes 0.65 ms; without the products and
//     the epilogues 0.35 (the x loads, the LayerNorm and the weight
//     stream); without the TMA stores or without the LayerNorm 0.75.
//     Writing the staging tile with one st.shared a value pair, 64 x 16
//     store boxes alone, st.global in place of the TMA store, a bias load
//     from device memory in the epilogue, L2 eviction hints and a 2-CTA
//     cluster multicasting the weight tiles were each measured slower or
//     no faster.
//
// Tiled (K > 320, any K; the paths' K >= 640, where 64 rows of A fragments
// no longer fit in registers beside the accumulators): 128 x 256 output
// tiles, both operands streamed.
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
//     x byte 256 columns: 48 KB a 64-deep k chunk for 2.1 M multiply-adds.
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

// stripe regime: 80-column weight tiles (64 rows of A fragments take up to
// 80 registers beside two 40-register accumulators), two 64 x 80 staging
// tiles a consumer warpgroup, each a 64 x 64 box in the 128-byte swizzle and
// a 64 x 16 box in the 32-byte swizzle; gamma and beta in f32 (an f32 bias
// table, where a weight has a bias, comes on top: GemmParams::btab)
constexpr int kStripeMaxChunks = 5;         // K <= 320
constexpr int kStripeBN = 80;
constexpr int kLnThreads = 96;              // warps 9-11 normalise the stripes
constexpr int kStgBufs = 2;                 // staging tiles a consumer warpgroup
__host__ __device__ inline int stripe_smem(int kchunks, int stages) {
  return 1024 + kchunks * BM * 128 + 2 * kStgBufs * 64 * kStripeBN * 2 +
         stages * kStripeBN * 128 + kchunks * 64 * 8 + 8 * (2 * stages + 5);
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
  CUtensorMap tw[3];       // W_i (N_i, K): boxes 64 x 80 (stripe) or 64 x 128 (tiled), swizzled
  // out_i (M, N_i): boxes 64 x 64, 128-byte swizzle (the stripe's second
  // box of a tile: 16 x 64 in the 32-byte swizzle, to2)
  CUtensorMap to[3], to2[3];
  CUtensorMap tr[3], tr2[3];  // residual_i (M, N_i), as to and to2; only where there is one
  const bf16* x;           // x itself: the tiled regime's LayerNorm pre-pass reads it
  bf16* xn;                // and writes the normalised x here, the GEMM's operand
  const void* gamma;       // (K,) f32 or bf16 (ln_bf16); null: x is used as it is
  const void* beta;        // (K,), as gamma
  const void* bias[3];     // (N_i,) f32 or bf16 (bias_bf16), or null
  int ln_bf16, bias_bf16;
  int n[3], tiles[3], has_res[3];  // N_i, its tiles (stripe) or units (tiled), residual?
  int boff[3], btab;       // stripe: each weight's first column in the f32 bias table, its size
  int M, K, kchunks, stages, nsplit, total;  // total: tiles (stripe) or units (tiled)
  int items;               // stripe: (row stripe, N split) work items
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

// gamma, beta and the biases are read in the dtype the caller holds them
// (bf16 or f32) and widened to f32 in registers, which is exact for bf16.
// 8 values [8 i, 8 i + 8) of a vector
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
// values col and col + 1 (col even)
__device__ __forceinline__ float2 load2(const void* v, int is_bf16, int col) {
  if (is_bf16) {
    const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(v) + col / 2);
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  }
  return __ldg(reinterpret_cast<const float2*>(v) + col / 2);
}

// ====================================================================
// stripe regime
// ====================================================================

// 16-byte chunk `ch` (columns 8 ch .. 8 ch + 7) of stripe row r
__device__ __forceinline__ uint32_t stripe_off(int r, int ch) {
  return (uint32_t)((ch >> 3) * BM * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// LayerNorm of stripe row r in place, by one thread: f32 mean and variance
// in two passes over shared memory (as the reference; four partial sums a
// pass), then y = (x - mean) * rstd * gamma + beta rounded to bf16, gamma
// and beta read as f32 from shared memory (gb: gamma, then beta at gb +
// K). Columns past K stay zero (TMA's fill); rows past M are normalised
// too but never stored.
__device__ __forceinline__ void normalise_row(const GemmParams& p, uint8_t* sx, const float* gb,
                                              int r) {
  const int nch = p.K / 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int ch = 0; ch < nch; ++ch) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sx + stripe_off(r, ch));
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      s[i] += f.x + f.y;
    }
  }
  const float mean = ((s[0] + s[1]) + (s[2] + s[3])) / p.K;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int ch = 0; ch < nch; ++ch) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sx + stripe_off(r, ch));
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      const float d0 = f.x - mean, d1 = f.y - mean;
      v[i] += d0 * d0 + d1 * d1;
    }
  }
  const float rstd = rsqrtf(((v[0] + v[1]) + (v[2] + v[3])) / p.K + p.eps);
#pragma unroll 2
  for (int ch = 0; ch < nch; ++ch) {
    uint4* at = reinterpret_cast<uint4*>(sx + stripe_off(r, ch));
    uint4 raw = *at;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
    const float4* g4 = reinterpret_cast<const float4*>(gb + 8 * ch);
    const float4* b4 = reinterpret_cast<const float4*>(gb + p.K + 8 * ch);
    const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn((f.x - mean) * rstd * g[2 * i] + b[2 * i],
                                   (f.y - mean) * rstd * g[2 * i + 1] + b[2 * i + 1]);
    }
    *at = raw;
  }
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the committed bulk stores but the newest N have finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read_n() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// d[0:40] (+)= A(registers) . B(smem, K-major), m64n80k16; acc = 0 ignores d
__device__ __forceinline__ void wgmma_rs_k80(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The consumer warpgroups' side of the stripe kernel: state and steps.
// Members, not lambdas, and every step forced inline, so that the A
// fragments and both accumulators stay in registers.
template <int KC>
struct StripeConsumer {
  static constexpr int BN = kStripeBN;
  static constexpr int NA = BN / 2;         // accumulator registers of a 64 x BN tile
  static constexpr int STG = 64 * BN * 2;   // a staging tile (a 64- and a 16-column box)
  static constexpr int STAGE = BN * 128;    // a weight stage: BN rows x 64 columns

  const GemmParams& p;
  uint8_t* base_ptr;
  uint32_t sX, sStg, sB, sTab, bars, xready, xempty, rbar;
  int stages, wg, warp, lane, g, qd;
  bool leader;
  uint32_t rphase = 0;
  uint32_t a[4 * KC][4];  // this warpgroup's 64 rows of the normalised stripe
  float acc0[NA], acc1[NA];
  // W committed groups (chunks) kept in flight: two, so that a tile's
  // epilogue runs with two chunks on the tensor cores (one where a tile is
  // one chunk, K <= 64)
  static constexpr int W = KC > 1 ? 2 : 1;
  int s_use = 0, ph_use = 0;  // the next chunk's stage and its full barrier's parity
  int s_rel = 0, unrel = 0;   // the oldest unreleased chunk's stage; chunks unreleased
  int ntile = 0;  // tiles run (the staging tile's parity)
  uint64_t desc_b = 0;  // the weight ring's stage 0 as a wgmma descriptor
  // the tile whose epilogue is due: weight, first row and column, staging tile
  int e_wi = -1, e_row0 = 0, e_col0 = 0;
  uint32_t e_stg = 0;

  __device__ __forceinline__ StripeConsumer(const GemmParams& p_, uint8_t* base, uint32_t sX_,
                                            uint32_t sStg_, uint32_t sB_, uint32_t sTab_,
                                            uint32_t bars_)
      : p(p_), base_ptr(base), sX(sX_), sStg(sStg_), sB(sB_), sTab(sTab_), bars(bars_) {
    stages = p.stages;
    xready = bars + 16u * stages + 8;
    xempty = xready + 8;
    wg = threadIdx.x / 128;
    warp = (threadIdx.x / 32) % 4;
    lane = threadIdx.x % 32;
    g = lane >> 2;
    qd = lane & 3;
    leader = threadIdx.x % 128 == 0;
    rbar = bars + 16u * stages + 24 + 8u * wg;
    desc_b = make_desc<128>(sB, 16);
  }

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (stages + s); }
  // staging-tile byte offset of accumulator column group c (columns 8 c ..
  // 8 c + 7) in row `row`: the 128-byte swizzle (64-column box), then the
  // 32-byte one (16-column box). The 8 rows g of a store instruction fall on
  // distinct banks.
  __device__ __forceinline__ static uint32_t stg_off(int row, int c) {
    if (c < 8) return row * 128 + ((c ^ (row & 7)) << 4);
    return 64 * 128 + row * 32 + (((c & 1) ^ ((row >> 2) & 1)) << 4);
  }
  // TMA of the tile's boxes that start inside N, between shared and global
  template <bool STORE>
  __device__ __forceinline__ void move_boxes(int wi, int row0, int col0, uint32_t stg) {
    if (STORE) tma_store_2d(&p.to[wi], stg, col0, row0);
    else tma_load_2d(stg, &p.tr[wi], rbar, col0, row0);
    if (col0 + 64 < p.n[wi]) {
      if (STORE) tma_store_2d(&p.to2[wi], stg + 64 * 128, col0 + 64, row0);
      else tma_load_2d(stg + 64 * 128, &p.tr2[wi], rbar, col0 + 64, row0);
    }
  }
  // the oldest consumed weight stage is free again
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s_rel));
    s_rel = s_rel + 1 == stages ? 0 : s_rel + 1;
    --unrel;
  }

  // item q's normalised stripe: this warpgroup's 64 rows into registers,
  // then the buffer is free for the next item's x
  __device__ __forceinline__ void load_a(int q) {
    mbar_wait(xready, q & 1);
    const int r = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < 4 * KC; ++ks) {
      const int ch = 2 * (ks % 4) + (lane >> 4);
      ldmatrix_x4(a[ks], sX + (ks / 4) * BM * 128 + r * 128 + ((ch ^ (r & 7)) << 4));
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty);
  }

  // bias (+ residual) of the due tile's accumulator into its staging tile,
  // then TMA stores of the boxes that start inside N (rows past M and
  // columns past N are not written)
  __device__ __forceinline__ void epilogue(const float* acc) {
    const bool res = p.has_res[e_wi];
    // the tile's bias from the block's f32 table (zero past N)
    const bool has_bias = p.bias[e_wi] != nullptr;
    const float* bias = reinterpret_cast<const float*>(base_ptr + (sTab - sX)) + p.boff[e_wi] +
                        e_col0 + 2 * qd;
    if (res) {  // loaded by TMA while the tile ran
      mbar_wait(rbar, rphase);
      rphase ^= 1;
    } else {
      // the store that last read this staging tile (two tiles ago) is done
      if (leader) bulk_wait_read_n<kStgBufs - 1>();
      named_sync(2 + wg, 128);
    }
    // four 8 x 8 blocks an instruction: (column groups c, c + 1) x (rows
    // g, g + 8), lane l addressing row l % 8 of block l / 8
    const int mrow = 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
    for (int c = 0; c < BN / 8; c += 2) {
      const uint32_t at = e_stg + stg_off(mrow, c + (lane >> 4));
      uint32_t v[4];
      if (res) ldmatrix_x4(v, at);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int cc = c + m / 2, j = m % 2;
        const float2 bb = has_bias ? *reinterpret_cast<const float2*>(bias + 8 * cc)
                                   : make_float2(0.f, 0.f);
        float y0 = acc[4 * cc + 2 * j] + bb.x, y1 = acc[4 * cc + 2 * j + 1] + bb.y;
        if (res) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[m]));
          y0 += r.x;
          y1 += r.y;
        }
        v[m] = mma_tiles::pack_bf16(y0, y1);
      }
      stmatrix_x4(at, v);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (leader) {
      move_boxes<true>(e_wi, e_row0, e_col0, e_stg);
      bulk_commit();
    }
  }

  // tile (wi, nt) of rows row0 .. row0 + 63: its chunks into `cur`. Once W
  // of them are issued, every earlier group is done, so the previous tile
  // (in `prev`) is complete and its epilogue runs under the products.
  __device__ __forceinline__ void run_tile(float* cur, float* prev, int wi, int nt, int row0,
                                           bool fresh, int q) {
    if (fresh) {  // a new item: the old A fragments must be retired first
      wgmma_wait_all();
      fence_regs<NA>(prev);
      while (unrel) release();
      load_a(q);
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      mbar_wait(full(s_use), ph_use);
      wgmma_fence();
      // a stage's descriptor is stage 0's plus its offset in 16-byte units
      // (shared memory is below 256 KB, so the 14-bit address never carries)
      const uint64_t db = desc_b + (uint32_t)(s_use * (STAGE / 16));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_k80(cur, a[4 * kc + kk], db + 2 * kk, kc > 0 || kk > 0);
      wgmma_commit();
      if (++s_use == stages) {
        s_use = 0;
        ph_use ^= 1;
      }
      ++unrel;
      // every group but the newest W is done: their stages are free
      wgmma_wait<W>();
      fence_regs<NA>(cur);
      fence_regs<NA>(prev);
      if (unrel > W) release();
      if (kc == W - 1) {  // the previous tile is complete
        if (e_wi >= 0) epilogue(prev);
        e_wi = wi;
        e_row0 = row0;
        e_col0 = nt * BN;
        e_stg = sStg + (kStgBufs * wg + ntile % kStgBufs) * STG;
        ++ntile;
        if (p.has_res[wi] && leader) {
          // the store that last read this staging tile has read it
          bulk_wait_read_n<kStgBufs - 1>();
          mbar_expect_tx(rbar, 64 * 64 * 2 + (e_col0 + 64 < p.n[wi] ? 64 * 16 * 2 : 0));
          move_boxes<false>(wi, row0, e_col0, e_stg);
        }
      }
    }
  }

  __device__ __forceinline__ void finish(float* last) {
    wgmma_wait_all();
    fence_regs<NA>(last);
    while (unrel) release();
    epilogue(last);
    if (leader) bulk_wait();
  }

  // the walk: items blockIdx.x, + gridDim.x, ...; in each, tiles sp, sp +
  // nsplit, ... (sp: the item's N split); the accumulators alternate
  __device__ __forceinline__ void run() {
    const int step = gridDim.x;
    int t = blockIdx.x, q = 0, u = t % p.nsplit;
    bool fresh = true;
    while (true) {
      int wi, nt;
      tile_of(p, u, wi, nt);
      run_tile(acc0, acc1, wi, nt, (t / p.nsplit) * BM + 64 * wg, fresh, q);
      advance(t, q, u, fresh, step);
      if (t >= p.items) {
        finish(acc0);
        return;
      }
      tile_of(p, u, wi, nt);
      run_tile(acc1, acc0, wi, nt, (t / p.nsplit) * BM + 64 * wg, fresh, q);
      advance(t, q, u, fresh, step);
      if (t >= p.items) {
        finish(acc1);
        return;
      }
    }
  }

  __device__ __forceinline__ void advance(int& t, int& q, int& u, bool& fresh, int step) const {
    u += p.nsplit;
    fresh = false;
    if (u >= p.total) {
      t += step;
      ++q;
      u = t % p.nsplit;
      fresh = true;
    }
  }
};

// Persistent blocks, one an SM, each walking every gridDim.x-th work item
// (a 128-row stripe and every nsplit-th BN-column tile of the weights).
// Warp 8's first thread loads each item's x stripe by TMA into one buffer
// and streams the weight tiles through a ring; warps 9-11 normalise the
// stripe in place; each consumer warpgroup copies its 64 rows into
// registers (the A fragments of m64nBNk16, K / 16 of them), frees the
// buffer for the next item's x and runs every tile of the item from
// registers, two accumulators taking turns (StripeConsumer).
template <int KC>
__global__ void __launch_bounds__(kThreads, 1) ln_gemm_stripe(const __grid_constant__ GemmParams p) {
  using C = StripeConsumer<KC>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sX = smem_u32(base_ptr);        // the x stripe (KC boxes of 128 x 64)
  const uint32_t sStg = sX + KC * BM * 128;      // 2 staging tiles a consumer warpgroup
  const uint32_t sB = sStg + 2 * kStgBufs * C::STG;  // the weight ring
  const uint32_t sGB = sB + p.stages * C::STAGE;  // gamma, then beta, f32
  const uint32_t sTab = sGB + KC * 64 * 8;        // the biases, f32, tile-padded with zeros
  const uint32_t bars = sTab + 4 * p.btab;
  const int stages = p.stages;
  // full[stages], empty[stages], then: the stripe has landed (xfull), is
  // normalised (xready), is held in registers by both warpgroups (xempty);
  // the residual loads of warpgroups 0 and 1
  const uint32_t xfull = bars + 16u * stages, xready = xfull + 8, xempty = xfull + 16;
  const int first = blockIdx.x, step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (stages + s), 8);  // one arrival per consumer warp
    }
    mbar_init(xfull, 1);
    mbar_init(xready, kLnThreads / 32);
    mbar_init(xempty, 8);
    mbar_init(xfull + 24, 1);
    mbar_init(xfull + 32, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ----------------------------------------------- producer and LayerNorm
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 256) {
      auto load_x = [&](int t) {
        mbar_expect_tx(xfull, (uint32_t)(KC * BM * 128));
        for (int kc = 0; kc < KC; ++kc)
          tma_load_2d(sX + kc * BM * 128, &p.tx, xfull, kc * kSpan, (t / p.nsplit) * BM);
      };
      load_x(first);
      int s = 0, ph = 0, q = 0;  // the next stage, its empty barrier's parity
      for (int t = first; t < p.items; t += step, ++q) {
        const int sp = t % p.nsplit;
        const int chunks = ((p.total - sp + p.nsplit - 1) / p.nsplit) * KC;
        // the next item's x is loaded once the consumers run this one:
        // chunk `trig` of this item waits for a stage that only a chunk of
        // this item frees, so the wait for the buffer is short
        const int trig = min(stages, chunks) - 1;
        const bool more = t + step < p.items;
        int c = 0;
        for (int u = sp; u < p.total; u += p.nsplit) {
          int wi, nt;
          tile_of(p, u, wi, nt);
#pragma unroll 1
          for (int kc = 0; kc < KC; ++kc, ++c) {
            mbar_wait(bars + 8u * (stages + s), ph ^ 1);
            mbar_expect_tx(bars + 8u * s, C::STAGE);
            tma_load_2d(sB + s * C::STAGE, &p.tw[wi], bars + 8u * s, kc * kSpan, nt * C::BN);
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
            if (c == trig && more) {
              mbar_wait(xempty, q & 1);
              load_x(t + step);
            }
          }
        }
      }
    } else if (threadIdx.x >= 256 + 32) {
      // warps 9-11: gamma, beta and the biases into shared memory as f32
      // (the consumers read the biases after the first item's xready),
      // then the stripes, one thread a row
      const int lt = threadIdx.x - 288;
      float* gb = reinterpret_cast<float*>(base_ptr + (sGB - sX));
      if (p.gamma) {
        for (int i = lt; i < p.K / 8; i += kLnThreads) {
          load8(p.gamma, p.ln_bf16, i, gb + 8 * i);
          load8(p.beta, p.ln_bf16, i, gb + p.K + 8 * i);
        }
        named_sync(1, kLnThreads);  // warps 9-11
      }
      if (p.btab) {
        float* tab = reinterpret_cast<float*>(base_ptr + (sTab - sX));
        for (int i = 0; i < 3; ++i)
          for (int col = 2 * lt; col < p.tiles[i] * C::BN; col += 2 * kLnThreads)
            *reinterpret_cast<float2*>(tab + p.boff[i] + col) =
                p.bias[i] && col < p.n[i] ? load2(p.bias[i], p.bias_bf16, col)
                                          : make_float2(0.f, 0.f);
      }
      int q = 0;
      for (int t = first; t < p.items; t += step, ++q) {
        mbar_wait(xfull, q & 1);
        if (p.gamma) {
          for (int r = lt; r < BM; r += kLnThreads) normalise_row(p, base_ptr, gb, r);
          fence_proxy_async();  // before the next item's TMA overwrites the rows
        }
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(xready);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    C c(p, base_ptr, sX, sStg, sB, sTab, bars);
    c.run();
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
template <bool BF16_LN>  // gamma and beta are bf16 (else f32)
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
    float g[8], b[8];
    load8(p.gamma, BF16_LN, v, g);
    load8(p.beta, BF16_LN, v, b);
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
template <int U, bool BF16_BIAS>
__device__ __forceinline__ void tiled_epilogue(const GemmParams& p, const float* acc, int wi,
                                               int row0, int col0, uint32_t stg,
                                               uint8_t* stg_ptr, uint32_t rbar,
                                               uint32_t& rphase) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  const int N = p.n[wi];
  const int boxes = col0 + kSpan < N ? 2 : 1;
  const void* bias = p.bias[wi];
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
    if (bias && col0 + col < N) bb = load2(bias, BF16_BIAS, col0 + col);
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
      if (p.bias_bf16)
        tiled_epilogue<0, true>(p, acc, wi, row0, j * TU, stg, stg_ptr, rbar, rphase);
      else
        tiled_epilogue<0, false>(p, acc, wi, row0, j * TU, stg, stg_ptr, rbar, rphase);
      if (nu == 2) {
        tile_of(p, u0 + 1, wi, j);
        if (p.bias_bf16)
          tiled_epilogue<1, true>(p, acc, wi, row0, j * TU, stg, stg_ptr, rbar, rphase);
        else
          tiled_epilogue<1, false>(p, acc, wi, row0, j * TU, stg, stg_ptr, rbar, rphase);
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

namespace {
typedef void (*StripeKernel)(GemmParams);
const StripeKernel kStripe[kStripeMaxChunks] = {
    ln_gemm_stripe<1>, ln_gemm_stripe<2>, ln_gemm_stripe<3>, ln_gemm_stripe<4>, ln_gemm_stripe<5>};

cudaError_t allow_smem() {
  for (StripeKernel k : kStripe) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  return cudaFuncSetAttribute(ln_gemm_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}
}  // namespace

// One call for all weights. gamma/beta null: no LayerNorm; ln_bf16 and
// bias_bf16: gamma and beta, and the biases, are bf16 (else f32). xn: the
// tiled regime's normalised x (M x K bf16 scratch, from the caller; unused
// otherwise). (tiled, stages, split, blocks, smem) is the Python tile plan,
// checked here: the regime (0: stripe, 1: tiled), the ring depth, the N
// splits of a stripe (stripe; 1 for tiled), the persistent blocks and the
// shared-memory bytes. Only the tensor maps the call uses are encoded.
extern "C" int mmgt_ln_gemm(
    const void* x, const void* gamma, const void* beta, int M, int K, float eps, int nw,
    int ln_bf16, int bias_bf16, const void* w0, const void* w1, const void* w2, int n0, int n1,
    int n2, const void* b0, const void* b1, const void* b2, const void* r0, const void* r1,
    const void* r2, void* o0, void* o1, void* o2, void* xn, int tiled, int stages, int split,
    int blocks, int smem, void* stream) {
  if (nw < 1 || nw > 3 || K <= 0 || (K % 8) != 0 || (tiled != 0 && tiled != 1) ||
      (ln_bf16 & ~1) || (bias_bf16 & ~1) || (!gamma) != (!beta))
    return (int)cudaErrorInvalidValue;
  // the tiled regime's LayerNorm writes its normalised x to xn (M x K bf16)
  if (tiled && gamma && !xn) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  GemmParams p;
  p.kchunks = (K + kSpan - 1) / kSpan;
  if (!tiled && p.kchunks > kStripeMaxChunks) return (int)cudaErrorInvalidValue;
  const void* ws[3] = {w0, w1, w2};
  const int ns[3] = {n0, n1, n2};
  const void* bs[3] = {b0, b1, b2};
  const void* rs[3] = {r0, r1, r2};
  void* os[3] = {o0, o1, o2};
  const int tcols = tiled ? TU : kStripeBN;  // columns of a tile or unit
  p.total = 0;
  for (int i = 0; i < 3; ++i) {
    p.n[i] = p.tiles[i] = p.has_res[i] = 0;
    p.bias[i] = nullptr;
    p.boff[i] = p.total * tcols;
    if (i >= nw) continue;
    if (ns[i] <= 0 || ns[i] % 8 != 0 || !ws[i] || !os[i]) return (int)cudaErrorInvalidValue;
    p.n[i] = ns[i];
    p.tiles[i] = (ns[i] + tcols - 1) / tcols;
    p.bias[i] = bs[i];
    p.has_res[i] = rs[i] != nullptr;
    p.total += p.tiles[i];
    if (!make_map_2d(&p.tw[i], ws[i], ns[i], K, tcols) ||
        !make_map_2d(&p.to[i], os[i], M, ns[i], 64, kSpan) ||
        (rs[i] && !make_map_2d(&p.tr[i], rs[i], M, ns[i], 64, kSpan)))
      return (int)cudaErrorInvalidValue;
    // the stripe's 80-column tiles: their last 16 columns in a box of their own
    if (!tiled && ns[i] > kSpan &&
        (!make_map_2d(&p.to2[i], os[i], M, ns[i], 64, 16, 32) ||
         (rs[i] && !make_map_2d(&p.tr2[i], rs[i], M, ns[i], 64, 16, 32))))
      return (int)cudaErrorInvalidValue;
  }
  // the stripe's bias table: every weight's tiles, where any weight has a bias
  p.btab = !tiled && (b0 || (nw > 1 && b1) || (nw > 2 && b2)) ? p.total * tcols : 0;
  const int want = tiled ? tiled_smem(stages) : stripe_smem(p.kchunks, stages) + 4 * p.btab;
  if (stages < 2 || smem != want || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool pre = tiled && gamma;  // the LayerNorm pre-pass runs first
  if (!make_map_2d(&p.tx, pre ? xn : x, M, K, BM)) return (int)cudaErrorInvalidValue;
  p.x = (const bf16*)x;
  p.xn = (bf16*)xn;
  p.gamma = gamma;
  p.beta = beta;
  p.ln_bf16 = ln_bf16;
  p.bias_bf16 = bias_bf16;
  p.M = M; p.K = K; p.stages = stages; p.eps = eps;
  static const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = (cudaStream_t)stream;
  const int mtiles = (M + BM - 1) / BM;
  if (tiled) {
    p.nsplit = 1;
    p.items = 0;
    p.ntiles = (p.total + 1) / 2;
    const long long tt = (long long)mtiles * p.ntiles;
    if (tt > 0x7fffffffLL || split != 1 || blocks < 1 || blocks > tt || blocks > 65535)
      return (int)cudaErrorInvalidValue;
    p.mtiles = mtiles;
    p.ttotal = (int)tt;
    if (pre) {
      if (ln_bf16)
        ln_gemm_rows<true><<<(M + 7) / 8, 256, 0, st>>>(p);
      else
        ln_gemm_rows<false><<<(M + 7) / 8, 256, 0, st>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    ln_gemm_tiled<<<blocks, kThreads, smem, st>>>(p);
  } else {
    const long long items = (long long)mtiles * split;
    if (split < 1 || split > p.total || items > 0x7fffffffLL || blocks < 1 || blocks > items ||
        blocks > 65535)
      return (int)cudaErrorInvalidValue;
    p.nsplit = split;
    p.items = (int)items;
    p.mtiles = p.ntiles = p.ttotal = 0;
    kStripe[p.kchunks - 1]<<<blocks, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

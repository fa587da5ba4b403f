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
// caller).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes at the level-0
// q/k/v shape (x (48, 4096, 320) against 3 x (320, 320): 503 MB moved,
// 0.150 ms; 0.121 ms of operations), bytes and operations alike at GEGLU
// (N = 2560: 0.338 ms of bytes, 0.326 ms of operations), operations at the
// level-2 audio q (x (6144, 1280) against 3 x (1280, 1280): 0.061 ms).
//
// Design: the TPU kernel's, one x block against every weight
// (mmgt_tpu/ops/fused_ln.py:37-56).
//   * Row stripe resident: a block owns BM rows of x and loads the whole
//     stripe once by TMA (2-D map, 64-column boxes, 128-byte swizzle) into
//     shared memory: BM = 128 where the stripe leaves room for the output
//     staging and a ring of at least two weight tiles (K <= 576: 80 KB at
//     K = 320), else BM = 64 (K = 640 and 1280: 80 and 160 KB). The
//     consumers compute each row's f32 mean and rstd from shared memory (2
//     or 4 threads a row, two passes as the reference), normalise the stripe
//     in place to bf16 in the same swizzled layout, once, and fence the
//     generic proxy before wgmma reads it. No statistics launch; x is read
//     from device memory once.
//   * Weights streamed: one producer thread walks the (N tile, 64-deep k
//     chunk) pairs of every weight of the call and loads BN x 64 tiles
//     (BN = 160, torch's (N, K) layout, so both operands are K-major)
//     through a ring of as many 20 KB stages as fit (5 at K = 320, 6 at
//     640, 2 at 1280; at most 8), guarded by full/empty mbarriers.
//   * Two consumer warpgroups run SS wgmma against the resident stripe,
//     one committed group kept in flight: at BM = 128 each owns 64 rows x
//     160 columns (m64n160k16, 80 f32 registers a thread); at BM = 64 both
//     own the 64 rows and split the columns (m64n80k16).
//   * Epilogue: the f32 bias (and a residual, loaded by TMA into the same
//     tile first) is added in registers, the bf16 result written to the
//     warpgroup's 64 x 160 (or 80) staging tile and stored by one TMA
//     store, which clips the ragged edges; the next tile's epilogue waits
//     only until that store has read the staging tile. Stores straight
//     from the registers, a staging tile copied out by the threads, and
//     80-column halves through one buffer all wrote GEGLU's 1 GB output
//     more slowly on the card.
//   * Registers: setmaxnreg 240 for the consumers, 24 for the producer.
//   * Grid: (row stripes, N splits). Where the stripes alone fill less than
//     two waves of 132 SMs, the N tiles are split over several blocks per
//     stripe (the stripe is then re-read, from L2). The tile plan (BM, ring
//     depth, splits, shared-memory bytes) is computed in Python
//     (mmgt_tpu_torch/ops/fused_ln.py:gemm_plan) and checked here.
//   * What bounds it (PERF.md): at 64-row stripes every weight byte brought
//     into an SM feeds only 64 rows, so the SM needs 64 bytes of weights a
//     clock to keep the tensor cores busy, and at K = 1280 only 2 ring
//     stages fit beside the stripe, too few to cover L2's latency; the
//     level-2 audio q runs several times slower than F.layer_norm +
//     F.linear there (chip_smoke.py). A cluster that splits K over 2-4 CTAs
//     (128-row stripes of 320 columns each) is the next step (ROADMAP).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int kThreads = 384;               // 2 consumer warpgroups + 1 producer
constexpr int BN = 160;                     // output columns of a tile
constexpr int kSpan = 64;                   // bf16 columns of one 128-byte swizzle span
constexpr int kStageBytes = BN * 128;       // one BN x 64 weight tile
constexpr int kMaxSmem = 232448;            // 227 KB a block

// columns of one consumer warpgroup's 64-row output tile
__host__ __device__ constexpr int wg_cols(int bm) { return bm == 128 ? BN : BN / 2; }
__host__ __device__ inline int smem_bytes(int bm, int kchunks, int stages) {
  return 1024 + kchunks * bm * 128 + 2 * 64 * wg_cols(bm) * 2 + stages * kStageBytes +
         8 * (2 * stages + 3);
}

struct GemmParams {
  CUtensorMap tx;          // x (M, K): boxes 64 x BM, 128-byte swizzle
  CUtensorMap tw[3];       // W_i (N_i, K): boxes 64 x BN, 128-byte swizzle
  CUtensorMap to[3];       // out_i (M, N_i): boxes BNW x 64, no swizzle
  CUtensorMap tr[3];       // residual_i (M, N_i), as to[i]
  const float* gamma;      // (K,) f32; null: x is used as it is
  const float* beta;       // (K,) f32
  const float* bias[3];    // (N_i,) f32 or null
  int n[3], tiles[3], has_res[3];  // N_i, its BN tiles, whether a residual is added
  int M, K, kchunks, stages, nsplit, total;
  float eps;
};

__device__ __forceinline__ void tile_of(const GemmParams& p, int t, int& wi, int& nt) {
  wi = 0;
  while (t >= p.tiles[wi]) t -= p.tiles[wi++];
  nt = t;
}

// 16-byte chunk `ch` (columns 8 ch .. 8 ch + 7) of stripe row r
__device__ __forceinline__ uint32_t stripe_off(int bm, int r, int ch) {
  return (uint32_t)((ch >> 3) * bm * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// LayerNorm of the stripe in place: 256 / BM neighbouring consumer threads
// share a row (its 16-byte chunks interleaved among them); f32 mean and
// variance in two passes over shared memory, then y = (x - mean) * rstd *
// gamma + beta rounded to bf16. Columns past K stay zero (TMA's fill); rows
// past M are normalised too but never stored.
template <int BM>
__device__ void normalise_stripe(const GemmParams& p, uint8_t* sa) {
  constexpr int TPR = 256 / BM;
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int nch = p.K / 8;
  float s = 0.f;
  for (int ch = sub; ch < nch; ch += TPR) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sa + stripe_off(BM, r, ch));
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
#pragma unroll
  for (int off = TPR / 2; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / p.K;
  float v = 0.f;
  for (int ch = sub; ch < nch; ch += TPR) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sa + stripe_off(BM, r, ch));
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
    uint4* at = reinterpret_cast<uint4*>(sa + stripe_off(BM, r, ch));
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

// bias (+ residual) of one warpgroup's 64 x BNW accumulator into its bf16
// staging tile (row-major), then one TMA store of the tile (rows and
// columns past the output's edge are not written). The residual, where
// there is one, is loaded into the staging tile by TMA first. stg: the
// staging tile's shared address and generic pointer; rbar, rphase: the
// residual-load barrier and its parity.
template <int BNW>
__device__ __forceinline__ void epilogue(const GemmParams& p, const float* acc, int wi, int row0,
                                         int col0, uint32_t stg, uint8_t* stg_ptr, uint32_t rbar,
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
      mbar_expect_tx(rbar, 64 * BNW * 2);
      tma_load_2d(stg, &p.tr[wi], rbar, col0, row0);
    }
    mbar_wait(rbar, rphase);
    rphase ^= 1;
  }
  bf16* tile = reinterpret_cast<bf16*>(stg_ptr);
#pragma unroll
  for (int c = 0; c < BNW / 8; ++c) {
    const int col = 8 * c + 2 * q;
    float2 bb = make_float2(0.f, 0.f);
    if (bias && col0 + col < N) bb = __ldg(reinterpret_cast<const float2*>(bias + col0 + col));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = 16 * warp + g + 8 * j;
      __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(tile + row * BNW + col);
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

template <int BM>
__global__ void __launch_bounds__(kThreads, 1) ln_gemm(const __grid_constant__ GemmParams p) {
  constexpr int BNW = wg_cols(BM);
  constexpr int STG = 64 * BNW * 2;  // one warpgroup's staging tile
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sA = smem_u32(base_ptr);
  const uint32_t sStg = sA + p.kchunks * BM * 128;
  const uint32_t sB = sStg + 2 * STG;
  const uint32_t bars = sB + p.stages * kStageBytes;
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
          mbar_expect_tx(full(s), kStageBytes);
          tma_load_2d(sB + s * kStageBytes, &p.tw[wi], full(s), kc * kSpan, nt * BN);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int arow = BM == 128 ? 64 * wg : 0;   // the warpgroup's first stripe row
    const int bcol = BM == 128 ? 0 : BNW * wg;  // and first column of the tile
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
      normalise_stripe<BM>(p, base_ptr);
      fence_proxy_async();
      named_sync(1, 256);
    }
    float acc[BNW / 2];
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
          wgmma_ss<BNW>(acc, make_desc<128>(sA + kc * BM * 128 + arow * 128 + kk * 32, 16),
                        make_desc<128>(sB + s * kStageBytes + bcol * 128 + kk * 32, 16),
                        kc > 0 || kk > 0);
        wgmma_commit();
        // the previous chunk's group is done: its weight stage is free
        wgmma_wait<1>();
        fence_regs<BNW / 2>(acc);
        if (kc > 0) release(empty((it - 1) % stages));
      }
      wgmma_wait_all();
      fence_regs<BNW / 2>(acc);
      release(empty((it - 1) % stages));
      epilogue<BNW>(p, acc, wi, m0 + arow, nt * BN + bcol, stg, stg_ptr, rbar, rphase);
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One launch for all weights of the call. gamma/beta null: no LayerNorm.
// (bm, stages, nsplit, smem) is the Python tile plan, checked here.
extern "C" int mmgt_ln_gemm(
    const void* x, const void* gamma, const void* beta, int M, int K, float eps, int nw,
    const void* w0, const void* w1, const void* w2, int n0, int n1, int n2,
    const void* b0, const void* b1, const void* b2,
    const void* r0, const void* r1, const void* r2,
    void* o0, void* o1, void* o2, int bm, int stages, int nsplit, int smem, void* stream) {
  if (nw < 1 || nw > 3 || K <= 0 || (K % 8) != 0 || (bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  GemmParams p;
  p.kchunks = (K + kSpan - 1) / kSpan;
  if (stages < 2 || smem != smem_bytes(bm, p.kchunks, stages) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const void* ws[3] = {w0, w1, w2};
  const int ns[3] = {n0, n1, n2};
  const void* bs[3] = {b0, b1, b2};
  const void* rs[3] = {r0, r1, r2};
  void* os[3] = {o0, o1, o2};
  const int bnw = bm == 128 ? wg_cols(128) : wg_cols(64);
  p.total = 0;
  for (int i = 0; i < 3; ++i) {
    const int j = i < nw ? i : 0;  // unused slots repeat weight 0's maps
    if (ns[j] <= 0 || ns[j] % 8 != 0) return (int)cudaErrorInvalidValue;
    p.n[i] = i < nw ? ns[i] : 0;
    p.tiles[i] = i < nw ? (ns[i] + BN - 1) / BN : 0;
    p.bias[i] = i < nw ? (const float*)bs[i] : nullptr;
    p.has_res[i] = i < nw && rs[i] != nullptr;
    p.total += p.tiles[i];
    if (!make_map_2d(&p.tw[i], ws[j], ns[j], K, BN) ||
        !make_map_2d(&p.to[i], os[j], M, ns[j], 64, bnw, 0) ||
        !make_map_2d(&p.tr[i], rs[j] ? rs[j] : os[j], M, ns[j], 64, bnw, 0))
      return (int)cudaErrorInvalidValue;
  }
  if (nsplit < 1 || nsplit > p.total || nsplit > 65535) return (int)cudaErrorInvalidValue;
  if (!make_map_2d(&p.tx, x, M, K, bm)) return (int)cudaErrorInvalidValue;
  p.gamma = (const float*)gamma; p.beta = (const float*)beta;
  p.M = M; p.K = K; p.stages = stages; p.nsplit = nsplit; p.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + bm - 1) / bm, nsplit);
  if (bm == 128) {
    static cudaError_t attr = cudaFuncSetAttribute(
        ln_gemm<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    ln_gemm<128><<<grid, kThreads, smem, st>>>(p);
  } else {
    static cudaError_t attr = cudaFuncSetAttribute(
        ln_gemm<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    ln_gemm<64><<<grid, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

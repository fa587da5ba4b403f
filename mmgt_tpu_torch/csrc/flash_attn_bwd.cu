// K5: flash-attention backward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernels of mmgt_tpu/ops/attention.py:_flash_attention_bwd
// (:376): _flash_dq_kernel (:236, pallas_call :411) and _flash_dkv_kernel
// (:270, pallas_call :434). Given the forward's q, k, v, o, its f32
// log-sum-exp (K1's `lse`, (B, H, Sq)), the output gradient dO and the
// per-row valid key count kv_lens[b], it computes, per (row b, head h), over
// the keys j < kv_len:
//     D_i  = sum_d dO_id O_id                          (f32)
//     P_ij = exp(scale * q_i . k_j - lse_i)
//     dV_j = sum_i P_ij dO_i
//     dS_ij = P_ij (dO_i . v_j - D_i)
//     dQ_i = scale * sum_j dS_ij k_j,   dK_j = scale * sum_i dS_ij q_i
// Keys at or past kv_len get P = 0 and zero dK/dV rows; a row with
// kv_len = 0 gets dQ = dK = dV = 0.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations, 10 * H * d *
// Sq * sum(kv_len) (five products of 2 d flops per query and valid key).
// At the level-0 bank-concat shape (q (2, 4096, 8, 40), K/V (2, 8192, 8,
// 40), kv_lens [4096, 8192]) that is 161 GFLOP against 53 MB moved: 0.163
// ms at the peak. What the design does about it: every product runs on
// wgmma, from tiles that TMA brings into shared memory while a producer
// warp keeps the next tiles in flight; P and dS never leave registers
// (they are the register A operand of the accumulating products); each
// consumer warpgroup computes a tile's exponentials while its previous
// tile's accumulating product runs, and the two warpgroups take turns at
// the tensor cores (named barriers), so that one's exponentials overlap
// the other's products. What it costs over the bound: the two-pass split
// computes S and dP in both passes (7 products for the counted 5) and
// takes every exponential twice, and d = 40 runs padded to 48.
//
// Three launches in one C entry, with no atomics and a fixed summation
// order, so the result is bitwise the same from call to call (the JAX
// package's own two-pass split):
//   1. bwd_dsum: per (b, h), the statistics both passes read, over the
//      queries padded to a multiple of 128: lse * log2(e) (+inf past Sq,
//      so a padded query gets P = 0) and D (0 past Sq), into one
//      (B, H, 2, Sq_pad) f32 buffer. Four lanes a query, 16-byte loads.
//   2. bwd_dq: one block of 3 warpgroups per (128-query tile, head, row).
//      Warpgroup 2 produces (setmaxnreg 24): one thread loads the block's
//      Q and dO once, then streams the K/V tiles of BK keys below kv_len
//      through a 3-stage ring guarded by full/empty mbarriers (TMA, 4-D
//      tensor maps over (D, S, H, B) with the caller's strides).
//      Warpgroups 0 and 1 consume 64 queries each (setmaxnreg 240):
//      S = Q K^T and dP = dO V^T by wgmma (both operands K-major in shared
//      memory); P (the last tile's keys at or past kv_len set to -inf
//      before the exp) and dS = P (dP - D) in the accumulator registers;
//      then dQ += dS K by wgmma with dS, in bf16, as the register A
//      operand and K read MN-major (transposed) from the same tile. dQ
//      stays in registers for the whole key loop.
//   3. bwd_dkv: one block of 3 warpgroups per (128-key tile, head, row),
//      the same roles. The producer loads the block's K and V once (64
//      keys a consumer warpgroup) and streams (Q, dO) tiles of BQ queries
//      with their lse * log2(e) and D (bulk copies of the statistics)
//      through the ring. Consumers: S^T = K Q^T and dP^T = V dO^T by
//      wgmma; P^T and dS^T in the accumulator registers (at d = 40, a third
//      of the exponentials by a polynomial on the FMA pipe, the rest on the
//      SFU, which runs 16 lanes a clock); dV += P^T dO and dK += dS^T Q by
//      wgmma with P^T and dS^T as register A operands and dO and Q read
//      MN-major. dK and dV stay in registers for the whole query loop. A key row of P^T reaches only that row of dK and dV, so
//      keys at or past kv_len are masked where their rows are written
//      (zeros); a block whose first key is at or past kv_len writes zeros
//      and returns.
// Padding: TMA fills the columns past D and the rows past S of a box with
// zeros, so nothing padded lives in device memory. d = 40 runs as 48 with
// a 32-byte swizzle (3 boxes of 16 columns), d = 80 as 96 and d = 160 as
// is with a 64-byte swizzle (3 and 5 boxes of 32), as in K1.
// Tiles and f32 registers a consumer thread: the dq pass takes BK = 128
// at d <= 96 (dQ DP/2, S and dP 64 each, dS's fragments 32) and 64 at
// d = 160 (80 + 32 + 32 + 16). The dk/dv pass takes BQ = 64 at d <= 96
// (dK and dV DP/2 each, S^T and dP^T 32 each, their fragments 16 each).
// At d = 160 dK and dV alone are 160 registers, so the query tile shrinks
// to BQ = 32 (S^T and dP^T 16 each, 8 + 8 of fragments: 208 in all). The
// other way out, splitting dK/dV's columns over the two warpgroups, would
// make both compute S^T and dP^T for the same keys (1.5x the pass's
// products) and cut the 5-box head dim off a box boundary.
// Shared memory (dq / dk-dv): d 48: 97 / 62 KB, d 96: 193 / 122 KB,
// d 160: 201 / 141 KB.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;
using mma_tiles::acc_to_a;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 3;
constexpr int kStatsPad = 128;  // the statistics of a (b, h) cover Sq rounded up to this

// what both passes read besides their tensor maps
struct Common {
  const int* kv_lens;
  const float* stats;  // (B, H, 2, Sq_pad): lse * log2(e), then D
  int H, Sq, Skv, Sq_pad, D;
  float scale;
};

__device__ __forceinline__ int kv_len_of(const Common& c, int b) {
  const int n = c.kv_lens ? c.kv_lens[b] : c.Skv;
  return max(0, min(n, c.Skv));
}

// nrows x D elements from base, rows ss apart, set to 0, 16 bytes a store
// (D is a multiple of 8, rows 16-byte aligned)
__device__ __forceinline__ void zero_rows(bf16* base, long long ss, int nrows, int D) {
  const int ch = D / 8;
  for (int i = threadIdx.x; i < nrows * ch; i += blockDim.x)
    *reinterpret_cast<uint4*>(base + (i / ch) * ss + (i % ch) * 8) = make_uint4(0, 0, 0, 0);
}

// 2^x on the FMA pipe, for x in [-126, 127] (smaller x gives ~2^-126, not
// 0): x = j + f with j an integer (the 1.5 * 2^23 rounding trick) and f in
// [-1/2, 1/2], 2^f by its degree-5 Taylor polynomial (relative error
// ~2.4e-6), 2^j added to the exponent bits
__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = fmaf(fmaf(fmaf(1.3333558e-3f, f, 9.6181291e-3f), f, 5.5504109e-2f), f, 0.24022651f);
  p = fmaf(fmaf(p, f, 0.69314718f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// The two consumer warpgroups take turns issuing their products (named
// barriers 1 and 2: warpgroup w waits on 1 + w and passes to the other), so
// that one's exponentials overlap the other's wgmma.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// x = A_x B_x^T and y = A_y B_y^T for one warpgroup, committed as one
// group: 64 rows x N columns over the padded head dim, both operands
// K-major. An A tile is NBOX column boxes of 64 rows, a B tile of N rows.
template <int DP, int SW, int N>
__device__ __forceinline__ void issue_two_ss(float* x, float* y, uint32_t ax, uint32_t ay,
                                             uint32_t bx, uint32_t by) {
  constexpr int SWC = SW / 2;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int aoff = (16 * kk) / SWC * 64 * SW + (16 * kk) % SWC * 2;
    const int boff = (16 * kk) / SWC * N * SW + (16 * kk) % SWC * 2;
    wgmma_ss<N>(x, make_desc<SW>(ax + aoff, 16), make_desc<SW>(bx + boff, 16), kk > 0);
    wgmma_ss<N>(y, make_desc<SW>(ay + aoff, 16), make_desc<SW>(by + boff, 16), kk > 0);
  }
  wgmma_commit();
}

// d += A . B over K rows: A in registers (K / 16 fragments of 16 columns),
// B the MN-major (K rows x DP) tile at b, column boxes K * SW bytes apart
template <int DP, int SW, int K>
__device__ __forceinline__ void issue_rs(float* d, uint32_t (*a)[4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<DP>(d, a[kk], make_desc<SW>(b + kk * 16 * SW, K * SW));
}

// bf16 A fragments of an accumulator of N columns, after its wgmma's wait
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (*a)[4], float* acc) {
  fence_regs<N / 2>(acc);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) acc_to_a(a[kk], acc + 8 * kk);
}

__device__ __forceinline__ void store_pair(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// ------------------------------------------------- 1. lse * log2(e) and D
struct StatsParams {
  const bf16* o; const bf16* dout; const float* lse; float* stats;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int H, Sq, Sq_pad, D;
};

// four lanes a query row, 16-byte loads (B * H * Sq_pad is a multiple of
// the 64 rows of a block, so no warp is cut)
__global__ void bwd_dsum(const StatsParams p) {
  const int sub = threadIdx.x % 4;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 4;
  const long long bh = row / p.Sq_pad;
  const int i = (int)(row % p.Sq_pad), h = (int)(bh % p.H), b = (int)(bh / p.H);
  float s = 0.f;
  if (i < p.Sq) {
    const bf16* dor = p.dout + b * p.do_sb + i * p.do_ss + h * p.do_sh;
    const bf16* orr = p.o + b * p.o_sb + i * p.o_ss + h * p.o_sh;
    for (int c = 8 * sub; c < p.D; c += 32) {
      const uint4 x = *reinterpret_cast<const uint4*>(dor + c);
      const uint4 y = *reinterpret_cast<const uint4*>(orr + c);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 xf = __bfloat1622float2(x2[k]), yf = __bfloat1622float2(y2[k]);
        s = fmaf(xf.x, yf.x, s);
        s = fmaf(xf.y, yf.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (sub == 0) {
    float* st = p.stats + bh * 2 * p.Sq_pad;
    st[i] = i < p.Sq ? p.lse[bh * p.Sq + i] * kLog2e : INFINITY;
    st[p.Sq_pad + i] = s;
  }
}

// ------------------------------------------------------------------ 2. dQ
struct DqParams {
  CUtensorMap tq, tdo, tk, tv;  // Q and dO: 64-row boxes; K and V: BK-row boxes
  Common c;
  bf16* dq;
  long long dq_sb, dq_ss, dq_sh;
};

template <int DP, int SW, int BK>
struct DqCfg {
  static constexpr int SWC = SW / 2;      // columns of one box (one swizzle span)
  static constexpr int NBOX = DP / SWC;   // boxes across the padded head dim
  static constexpr int QB = 64 * DP * 2;  // one consumer's Q (or dO) tile, bytes
  static constexpr int KB = BK * DP * 2;  // one K (or V) tile, bytes
  static constexpr int SMEM = 4 * QB + kStages * 2 * KB + 8 * (2 * kStages + 1) + 1024;
  static_assert(DP % SWC == 0 && DP % 16 == 0, "head dim pads to whole boxes");
};

template <int DP, int SW, int BK>
__global__ void __launch_bounds__(384, 1) bwd_dq(const __grid_constant__ DqParams p) {
  using C = DqCfg<DP, SW, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles
  const uint32_t sQ = base, sdO = sQ + 2 * C::QB, sK = sdO + 2 * C::QB;
  const uint32_t sV = sK + kStages * C::KB, bars = sV + kStages * C::KB;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t qbar = bars + 16u * kStages;

  const int q0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const int kv_len = kv_len_of(p.c, b);
  const int ntiles = (kv_len + BK - 1) / BK;
  if (ntiles == 0) {  // no valid key: dQ = 0
    zero_rows(p.dq + b * p.dq_sb + (long long)q0 * p.dq_ss + h * p.dq_sh, p.dq_ss,
              min(128, p.c.Sq - q0), p.c.D);
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, 4 * C::QB);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          tma_load(sQ + half * C::QB + j * 64 * SW, &p.tq, qbar, j * C::SWC, q0 + 64 * half, h, b);
          tma_load(sdO + half * C::QB + j * 64 * SW, &p.tdo, qbar, j * C::SWC, q0 + 64 * half, h,
                   b);
        }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * C::KB);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          tma_load(sK + st * C::KB + j * BK * SW, &p.tk, full(st), j * C::SWC, t * BK, h, b);
          tma_load(sV + st * C::KB + j * BK * SW, &p.tv, full(st), j * C::SWC, t * BK, h, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qd = lane & 3;
    const uint32_t q_base = sQ + wg * C::QB, do_base = sdO + wg * C::QB;
    // this thread's two query rows (register 4c + 2j + e is row 16 warp + g + 8 j)
    const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
    const float* stats = p.c.stats + ((long long)b * p.c.H + h) * 2 * p.c.Sq_pad;
    float lse2[2], dd[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      lse2[j] = stats[r0 + 8 * j];
      dd[j] = stats[p.c.Sq_pad + r0 + 8 * j];
    }
    const float sl2 = p.c.scale * kLog2e;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    mbar_wait(qbar, 0);
    auto k_at = [&](int t) { return sK + t % kStages * C::KB; };
    auto v_at = [&](int t) { return sV + t % kStages * C::KB; };
    // P (0 at or past kv_len, before the exp) and dS = P (dP - D) of tile
    // t, into s (register 4c + 2j + e is key column 8c + 2q + e)
    float s[BK / 2], dp[BK / 2];
    auto grad = [&](int t) {
      fence_regs<BK / 2>(s);
      fence_regs<BK / 2>(dp);
      const int nk = kv_len - t * BK;
      if (nk < BK) {  // the last tile: keys at or past kv_len get P = 2^-inf = 0
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * c + 2 * qd + (e & 1) >= nk) s[4 * c + e] = -INFINITY;
      }
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1;
          s[4 * c + e] = ex2(fmaf(s[4 * c + e], sl2, -lse2[j])) * (dp[4 * c + e] - dd[j]);
        }
    };
    // Tile t's S = Q K^T and dP = dO V^T are issued before tile t - 1's
    // dQ += dS K (K read as the MN-major B operand), and its P and dS are
    // computed while that product runs on the tensor cores.
    uint32_t a[BK / 16][4];
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(full(0), 0);
    turn_wait(wg);
    wgmma_fence();
    issue_two_ss<DP, SW, BK>(s, dp, q_base, do_base, k_at(0), v_at(0));
    turn_pass(wg);
    wgmma_wait<0>();
    grad(0);
    to_frags<BK>(a, s);
    for (int t = 1; t < ntiles; ++t) {
      mbar_wait(full(t % kStages), (t / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_two_ss<DP, SW, BK>(s, dp, q_base, do_base, k_at(t), v_at(t));
      issue_rs<DP, SW, BK>(dq, a, k_at(t - 1));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // S and dP of tile t have landed
      grad(t);
      wgmma_wait<0>();  // tile t - 1's product has read a[] and K
      fence_frags<BK / 16>(a);
      fence_regs<DP / 2>(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((t - 1) % kStages));
      to_frags<BK>(a, s);
    }
    turn_wait(wg);
    wgmma_fence();
    issue_rs<DP, SW, BK>(dq, a, k_at(ntiles - 1));
    wgmma_commit();
    if (wg == 0) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq);

    // rows past Sq are not stored
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j;
      if (r >= p.c.Sq) continue;
      bf16* drow = p.dq + b * p.dq_sb + (long long)r * p.dq_ss + h * p.dq_sh;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = 8 * c + 2 * qd;
        if (col < p.c.D)
          store_pair(drow + col, dq[4 * c + 2 * j] * p.c.scale, dq[4 * c + 2 * j + 1] * p.c.scale);
      }
    }
  }
}

// ------------------------------------------------------------- 3. dK, dV
struct DkvParams {
  CUtensorMap tq, tdo, tk, tv;  // Q and dO: BQ-row boxes; K and V: 64-row boxes
  Common c;
  bf16* dk; bf16* dv;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
};

template <int DP, int SW, int BQ>
struct DkvCfg {
  static constexpr int SWC = SW / 2;
  static constexpr int NBOX = DP / SWC;
  static constexpr int KB = 64 * DP * 2;  // one consumer's K (or V) tile, bytes
  static constexpr int QT = BQ * DP * 2;  // one Q (or dO) tile, bytes
  static constexpr int ST = 2 * BQ * 4;   // a tile's lse * log2(e) and D
  static constexpr int SMEM =
      4 * KB + kStages * (2 * QT + ST) + 8 * (2 * kStages + 1) + 1024;
  static_assert(DP % SWC == 0 && DP % 16 == 0, "head dim pads to whole boxes");
  static_assert(QT % 1024 == 0 && KB % 1024 == 0, "tiles keep the swizzle alignment");
  static_assert(kStatsPad % BQ == 0, "a query tile never reads past Sq_pad");
};

template <int DP, int SW, int BQ>
__global__ void __launch_bounds__(384, 1) bwd_dkv(const __grid_constant__ DkvParams p) {
  using C = DkvCfg<DP, SW, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + 2 * C::KB, sQ = sV + 2 * C::KB;
  const uint32_t sdO = sQ + kStages * C::QT, sSt = sdO + kStages * C::QT;
  const uint32_t bars = sSt + kStages * C::ST;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t kvbar = bars + 16u * kStages;

  const int k0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const int kv_len = kv_len_of(p.c, b);
  if (k0 >= kv_len) {  // no valid key in this tile: its gradients are zero
    const int nrows = min(128, p.c.Skv - k0);
    zero_rows(p.dk + b * p.dk_sb + (long long)k0 * p.dk_ss + h * p.dk_sh, p.dk_ss, nrows, p.c.D);
    zero_rows(p.dv + b * p.dv_sb + (long long)k0 * p.dv_ss + h * p.dv_sh, p.dv_ss, nrows, p.c.D);
    return;
  }
  const int ntiles = (p.c.Sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kvbar, 4 * C::KB);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          tma_load(sK + half * C::KB + j * 64 * SW, &p.tk, kvbar, j * C::SWC, k0 + 64 * half, h, b);
          tma_load(sV + half * C::KB + j * 64 * SW, &p.tv, kvbar, j * C::SWC, k0 + 64 * half, h, b);
        }
      const float* stats = p.c.stats + ((long long)b * p.c.H + h) * 2 * p.c.Sq_pad;
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * C::QT + C::ST);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          tma_load(sQ + st * C::QT + j * BQ * SW, &p.tq, full(st), j * C::SWC, t * BQ, h, b);
          tma_load(sdO + st * C::QT + j * BQ * SW, &p.tdo, full(st), j * C::SWC, t * BQ, h, b);
        }
        bulk_load(sSt + st * C::ST, stats + t * BQ, BQ * 4, full(st));
        bulk_load(sSt + st * C::ST + BQ * 4, stats + p.c.Sq_pad + t * BQ, BQ * 4, full(st));
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qd = lane & 3;
    const uint32_t k_base = sK + wg * C::KB, v_base = sV + wg * C::KB;
    // this thread's two key rows in the block (register 4c + 2j + e is
    // key row 16 warp + g + 8 j, query column 8c + 2q + e)
    const int r0 = 64 * wg + 16 * warp + (lane >> 2);
    const float sl2 = p.c.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) { dk[i] = 0.f; dv[i] = 0.f; }

    mbar_wait(kvbar, 0);
    auto q_at = [&](int t) { return sQ + t % kStages * C::QT; };
    auto do_at = [&](int t) { return sdO + t % kStages * C::QT; };
    // P^T into s and dS^T into dp for tile t (register 4c + 2j + e is query
    // column 8c + 2q + e); past Sq, lse * log2(e) is +inf, so P = 0. Keys
    // at or past kv_len are not masked here: a key row of P^T and dS^T
    // reaches only that row of dV and dK, which the epilogue writes as 0.
    float s[BQ / 2], dp[BQ / 2];
    auto grad = [&](int t) {
      fence_regs<BQ / 2>(s);
      fence_regs<BQ / 2>(dp);
      const float* sts = reinterpret_cast<const float*>(
          smem_raw + (sSt + t % kStages * C::ST - smem_u32(smem_raw)));
      // at d <= 48, every third group of 8 columns (c is a constant once
      // unrolled) takes its 2^x on the FMA pipe, the rest on the SFU: a
      // padded query's ~2^-126 there meets a zero dO row and D = 0
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(sts + 8 * c + 2 * qd);
        const float2 d2 = *reinterpret_cast<const float2*>(sts + BQ + 8 * c + 2 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = (e & 1) ? l2.y : l2.x, dd = (e & 1) ? d2.y : d2.x;
          const float x = fmaf(s[4 * c + e], sl2, -lse2);
          const float pv = DP == 48 && c % 3 == 2 ? ex2_poly(x) : ex2(x);
          s[4 * c + e] = pv;
          dp[4 * c + e] = pv * (dp[4 * c + e] - dd);
        }
      }
    };
    // Tile t's S^T = K Q^T and dP^T = V dO^T are issued before tile t - 1's
    // dV += P^T dO and dK += dS^T Q (dO and Q read as MN-major B
    // operands), and its P^T and dS^T are computed while those run.
    uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
    if (wg == 1) turn_pass(wg);
    mbar_wait(full(0), 0);
    turn_wait(wg);
    wgmma_fence();
    issue_two_ss<DP, SW, BQ>(s, dp, k_base, v_base, q_at(0), do_at(0));
    turn_pass(wg);
    wgmma_wait<0>();
    grad(0);
    to_frags<BQ>(ap, s);
    to_frags<BQ>(ads, dp);
    for (int t = 1; t < ntiles; ++t) {
      mbar_wait(full(t % kStages), (t / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_two_ss<DP, SW, BQ>(s, dp, k_base, v_base, q_at(t), do_at(t));
      issue_rs<DP, SW, BQ>(dv, ap, do_at(t - 1));
      issue_rs<DP, SW, BQ>(dk, ads, q_at(t - 1));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // S^T and dP^T of tile t have landed
      grad(t);
      wgmma_wait<0>();  // tile t - 1's products have read ap[], ads[], Q and dO
      fence_frags<BQ / 16>(ap);
      fence_frags<BQ / 16>(ads);
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((t - 1) % kStages));
      to_frags<BQ>(ap, s);
      to_frags<BQ>(ads, dp);
    }
    turn_wait(wg);
    wgmma_fence();
    issue_rs<DP, SW, BQ>(dv, ap, do_at(ntiles - 1));
    issue_rs<DP, SW, BQ>(dk, ads, q_at(ntiles - 1));
    wgmma_commit();
    if (wg == 0) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);

    // rows at or past kv_len are written as zeros (whatever they summed, a
    // select and not a product: they may hold inf or NaN); rows past Skv
    // are not stored
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = k0 + r0 + 8 * j;
      if (r >= p.c.Skv) continue;
      const bool ok = r < kv_len;
      const float ks = p.c.scale;
      bf16* krow = p.dk + b * p.dk_sb + (long long)r * p.dk_ss + h * p.dk_sh;
      bf16* vrow = p.dv + b * p.dv_sb + (long long)r * p.dv_ss + h * p.dv_sh;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = 8 * c + 2 * qd;
        if (col < p.c.D) {
          const int i = 4 * c + 2 * j;
          store_pair(krow + col, ok ? dk[i] * ks : 0.f, ok ? dk[i + 1] * ks : 0.f);
          store_pair(vrow + col, ok ? dv[i] : 0.f, ok ? dv[i + 1] : 0.f);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host
struct Args {
  const bf16* q; const bf16* k; const bf16* v; const bf16* o; const bf16* dout;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int B;
};

template <int DP, int SW, int BK, int BQ>
int launch(const Args& a, const Common& c, const float* lse, float* stats, bf16* dq, bf16* dk,
           bf16* dv, const long long* ds, cudaStream_t stream) {
  using Q = DqCfg<DP, SW, BK>;
  using KV = DkvCfg<DP, SW, BQ>;
  // the shared-memory limits are set once per variant
  static cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq<DP, SW, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  static cudaError_t attr_dkv = cudaFuncSetAttribute(
      bwd_dkv<DP, SW, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, KV::SMEM);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;

  DqParams pq;
  DkvParams pk;
  const int D = c.D, H = c.H, B = a.B;
  bool ok = make_map(&pq.tq, a.q, D, c.Sq, H, B, a.q_ss, a.q_sh, a.q_sb, 64, SW) &&
            make_map(&pq.tdo, a.dout, D, c.Sq, H, B, a.do_ss, a.do_sh, a.do_sb, 64, SW) &&
            make_map(&pq.tk, a.k, D, c.Skv, H, B, a.k_ss, a.k_sh, a.k_sb, BK, SW) &&
            make_map(&pq.tv, a.v, D, c.Skv, H, B, a.v_ss, a.v_sh, a.v_sb, BK, SW) &&
            make_map(&pk.tk, a.k, D, c.Skv, H, B, a.k_ss, a.k_sh, a.k_sb, 64, SW) &&
            make_map(&pk.tv, a.v, D, c.Skv, H, B, a.v_ss, a.v_sh, a.v_sb, 64, SW);
  pk.tq = pq.tq;  // the dq pass's 64-row Q and dO maps, where BQ = 64
  pk.tdo = pq.tdo;
  if (BQ != 64)
    ok = ok && make_map(&pk.tq, a.q, D, c.Sq, H, B, a.q_ss, a.q_sh, a.q_sb, BQ, SW) &&
         make_map(&pk.tdo, a.dout, D, c.Sq, H, B, a.do_ss, a.do_sh, a.do_sb, BQ, SW);
  if (!ok) return (int)cudaErrorInvalidValue;
  pq.c = c; pk.c = c;
  pq.dq = dq; pq.dq_sb = ds[0]; pq.dq_ss = ds[1]; pq.dq_sh = ds[2];
  pk.dk = dk; pk.dk_sb = ds[3]; pk.dk_ss = ds[4]; pk.dk_sh = ds[5];
  pk.dv = dv; pk.dv_sb = ds[6]; pk.dv_ss = ds[7]; pk.dv_sh = ds[8];

  StatsParams ps;
  ps.o = a.o; ps.dout = a.dout; ps.lse = lse; ps.stats = stats;
  ps.o_sb = a.o_sb; ps.o_ss = a.o_ss; ps.o_sh = a.o_sh;
  ps.do_sb = a.do_sb; ps.do_ss = a.do_ss; ps.do_sh = a.do_sh;
  ps.H = H; ps.Sq = c.Sq; ps.Sq_pad = c.Sq_pad; ps.D = D;
  const long long rows = (long long)B * H * c.Sq_pad;
  bwd_dsum<<<(unsigned)(rows / 64), 256, 0, stream>>>(ps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q((c.Sq + 127) / 128, H, B);
  bwd_dq<DP, SW, BK><<<grid_q, 384, Q::SMEM, stream>>>(pq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k((c.Skv + 127) / 128, H, B);
  bwd_dkv<DP, SW, BQ><<<grid_k, 384, KV::SMEM, stream>>>(pk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// stats: f32 scratch of B * H * 2 * Sq_pad elements, Sq_pad = Sq rounded
// up to a multiple of kStatsPad (the wrapper allocates it: ops/attention.py)
extern "C" int mmgt_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* kv_lens, void* stats, void* dq, void* dk, void* dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    int B, int H, int Sq, int Skv, int D, float scale, void* stream) {
  Args a;
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
  a.o = (const bf16*)o; a.dout = (const bf16*)dout;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.B = B;
  Common c;
  c.kv_lens = (const int*)kv_lens; c.stats = (const float*)stats;
  c.H = H; c.Sq = Sq; c.Skv = Skv; c.D = D; c.scale = scale;
  c.Sq_pad = (Sq + kStatsPad - 1) / kStatsPad * kStatsPad;
  const long long ds[9] = {dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  const float* l = (const float*)lse;
  float* st = (float*)stats;
  bf16 *gq = (bf16*)dq, *gk = (bf16*)dk, *gv = (bf16*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  // the trained path's head dims: 40 -> 48, 80 -> 96, 160; a smaller d
  // runs zero-padded in the next variant up
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return launch<48, 32, 128, 64>(a, c, l, st, gq, gk, gv, ds, s);
  if (D <= 96) return launch<96, 64, 128, 64>(a, c, l, st, gq, gk, gv, ds, s);
  if (D <= 160) return launch<160, 64, 64, 32>(a, c, l, st, gq, gk, gv, ds, s);
  return (int)cudaErrorInvalidValue;
}

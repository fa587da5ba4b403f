// K1: two-segment flash-attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernels mmgt_tpu/ops/attention.py:_flash_kernel (reached
// by _flash_attention, :107), _flash_fwd_lse_kernel (_flash_attention_fwd_lse,
// :320, and _flash_attention_packed_fwd, :539) and _flash_fwd_lse_2seg_kernel
// (_flash_attention_packed_2seg_fwd, :764). Computes, per (row b, head h,
// query i),
//     softmax(q . [K_self ; K_bank]^T * scale) . [V_self ; V_bank]
// over the first kv_lens[b] keys of the concatenation, f32 online softmax,
// and optionally the f32 log-sum-exp (B, H, Sq). The bank segment has batch
// stride 0: every row reads the same (1, Lb, H, D) bank. A row with no
// valid key returns 0 (and an LSE of -1e30).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations. At the
// level-0 bank shape (q (2, 4096, 8, 40), self and bank K/V of 4096 keys,
// kv_lens [4096, 8192]) the two products are 4 * H * d * Sq * sum(kv_len)
// = 64.4 GFLOP against 26.5 MB moved, 0.065 ms at the tensor-core peak.
//
// d <= 160: one block per (128-query tile, head, row), 3 warpgroups.
//   * Warpgroup 2 is the producer: one thread starts TMA loads (4-D tensor
//     maps over (D, S, H, B) with the caller's strides, one map for the
//     self segment and one for the bank). It loads the Q tile once and then
//     walks the self tiles and the bank tiles below kv_len through a
//     3-stage ring of K/V buffers guarded by full/empty mbarriers. It
//     gives its registers away (setmaxnreg 24).
//   * Warpgroups 0 and 1 consume, 64 query rows each (setmaxnreg 240).
//     Per key tile: S = Q K^T by wgmma m64nBKk16 (Q and K K-major from
//     swizzled shared memory); the online softmax in registers (quad
//     shuffles, exp2f with scale * log2(e) folded in, the O accumulator
//     rescaled in registers); P converted to bf16 in registers and fed as
//     wgmma's register A operand for O += P V, V read MN-major
//     (transposed) from shared memory. S, the running max and sum and O
//     never leave registers. Only the last partial tile of a segment is
//     masked (columns at or past the limit get -inf before the max).
//   * Head-dim padding: TMA fills columns past D with zeros, so the padding
//     costs no device memory. Tiles are loaded as column boxes of one
//     swizzle span each. d = 40 runs padded to 48 with a 32-byte swizzle
//     (3 boxes); the 128-byte swizzle would pad it to 64 and add a third
//     more tensor-core work. Both were timed on an NVIDIA H100 80GB HBM3
//     at 700 W (mmgt_tpu_torch/tools/k1_swizzle.py, PERF.md): equal within
//     1 % at the d = 40 shapes (0.266 against 0.265 ms at the level-0 bank
//     shape), so the tensor cores do not bound a tile at d = 40. The
//     48-column one is kept: its tiles take three quarters of the shared
//     memory.
//     d = 80 runs padded to 96 and d = 160 as is, both with a 64-byte
//     swizzle (3 and 5 boxes).
//   * Tiles: BQ = 128; BK = 128 for d <= 96 (S is 64 f32 registers a
//     thread), 64 at d = 160 (O alone is 80). Shared memory: Q, then 3
//     stages of K and V: 86 KB (d 48), 168 KB (96), 160 KB (160).
//
// d = 512 (the VAE mid attention, 3 launches a generation): a 64-row f32
// accumulator at d = 512 is 128 KB, more than one warpgroup's registers.
// One block per 64-query tile runs 8 warps: warp (r, c) owns query rows
// 16 r .. 16 r + 15 and output columns 256 c .. 256 c + 255 (128 f32
// registers a thread). Each warp computes S for its rows and half of the
// 64 keys (mma.sync m16n8k16 with ldmatrix from XOR-swizzled shared
// memory); the two warps of a row group exchange their row maxima through
// shared memory, write P (bf16) to one shared 64 x 64 tile, and both read
// all of it for O += P V. K and V have one buffer each, filled by cp.async
// so that V_j loads during S_j and K_{j+1} during the softmax and P V_j.
// Shared memory: Q, K, V (64 KB each), P (8 KB).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

typedef __nv_bfloat16 bf16;
using namespace mma_tiles;
using namespace hopper;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEmptyLse = -1e30f;  // LSE of a row with no valid key

// ------------------------------------------------------------------ common
struct Segments {
  int n0, n1;  // valid keys in the self and the bank segment
};

__device__ __forceinline__ Segments segments(const int* kv_lens, int b, int Ls, int Lb) {
  const int kv = kv_lens ? min(max(kv_lens[b], 0), Ls + Lb) : Ls + Lb;
  return {min(Ls, kv), max(0, kv - Ls)};
}

// ---------------------------------------------------- d <= 160: TMA + wgmma
struct TmaParams {
  CUtensorMap tq, tk, tv, tkb, tvb;  // (D, S, H, B) maps; Q boxes 64 rows, K/V boxes BK
  const int* kv_lens;
  bf16* o;
  float* lse;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Ls, Lb, D;
  float scale_log2;
};

template <int DP, int SW, int BK>
struct TmaCfg {
  static constexpr int SWC = SW / 2;         // columns of one box (one swizzle span)
  static constexpr int NBOX = DP / SWC;      // boxes across the padded head dim
  static constexpr int STAGES = 3;
  static constexpr int QB = 64 * DP * 2;     // one consumer's Q tile, bytes
  static constexpr int KB = BK * DP * 2;     // one K (or V) tile, bytes
  static constexpr int SMEM = 2 * QB + STAGES * 2 * KB + 8 * (2 * STAGES + 1) + 1024;
  static_assert(DP % SWC == 0 && DP % 16 == 0, "head dim pads to whole boxes");
};

template <int DP, int SW, int BK>
__global__ void __launch_bounds__(384, 1) flash_fwd_tma(const __grid_constant__ TmaParams p) {
  using C = TmaCfg<DP, SW, BK>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + 2 * C::QB;
  const uint32_t sV = sK + C::STAGES * C::KB;
  const uint32_t bars = sV + C::STAGES * C::KB;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::STAGES + s); };
  const uint32_t qbar = bars + 16u * C::STAGES;

  const int q0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const Segments seg = segments(p.kv_lens, b, p.Ls, p.Lb);
  const int tiles0 = (seg.n0 + BK - 1) / BK;
  const int ntiles = tiles0 + (seg.n1 + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
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
      mbar_expect_tx(qbar, 2 * C::QB);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j)
          tma_load(sQ + half * C::QB + j * 64 * SW, &p.tq, qbar, j * C::SWC, q0 + 64 * half, h,
                   b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % C::STAGES;
        mbar_wait(empty(st), ((t / C::STAGES) & 1) ^ 1);
        const bool bank = t >= tiles0;
        const int row = (bank ? t - tiles0 : t) * BK;
        const CUtensorMap* mk = bank ? &p.tkb : &p.tk;
        const CUtensorMap* mv = bank ? &p.tvb : &p.tv;
        const int bb = bank ? 0 : b;
        mbar_expect_tx(full(st), 2 * C::KB);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          tma_load(sK + st * C::KB + j * BK * SW, mk, full(st), j * C::SWC, row, h, bb);
          tma_load(sV + st * C::KB + j * BK * SW, mv, full(st), j * C::SWC, row, h, bb);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const uint32_t q_base = sQ + wg * C::QB;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const float sl2 = p.scale_log2;

    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % C::STAGES;
      const bool bank = t >= tiles0;
      const int nk = bank ? min(BK, seg.n1 - (t - tiles0) * BK) : min(BK, seg.n0 - t * BK);
      mbar_wait(full(st), (t / C::STAGES) & 1);

      // S = Q K^T: 64 rows x BK keys per warpgroup
      float s[BK / 2];
      const uint32_t k_base = sK + st * C::KB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int box = (16 * kk) / C::SWC, within = (16 * kk) % C::SWC;
        wgmma_ss<BK>(s, make_desc<SW>(q_base + box * 64 * SW + within * 2, 16),
                     make_desc<SW>(k_base + box * BK * SW + within * 2, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(s);

      // mask the partial tile: register 4c + 2j + e is (row g + 8j, column 8c + 2q + e)
      if (nk < BK) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          const int col = 8 * c + 2 * (lane & 3);
          if (col >= nk) { s[4 * c] = -INFINITY; s[4 * c + 2] = -INFINITY; }
          if (col + 1 >= nk) { s[4 * c + 1] = -INFINITY; s[4 * c + 3] = -INFINITY; }
        }
      }
      // online softmax in registers (log2 domain)
      float alpha[2], mnew[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * j], s[4 * c + 2 * j + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mnew[j] = fmaxf(m[j], mx * sl2);
        alpha[j] = exp2f(m[j] - mnew[j]);
        m[j] = mnew[j];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1;
          s[4 * c + e] = exp2f(fmaf(s[4 * c + e], sl2, -mnew[j]));
          rs[j] += s[4 * c + e];
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
      for (int c = 0; c < DP / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * c + e] *= alpha[e >> 1];
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(a[kk], s + 8 * kk);

      // O += P V: V is the MN-major B operand (keys x head dim)
      const uint32_t v_base = sV + st * C::KB;
      wgmma_fence();
      fence_regs<DP / 2>(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP>(o, a[kk], make_desc<SW>(v_base + kk * 16 * SW, BK * SW));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DP / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // epilogue: O / l, bf16, straight from registers; rows past Sq are not stored
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * j;
      if (r >= p.Sq) continue;
      const float inv = 1.f / fmaxf(l[j], 1e-30f);
      bf16* orow = p.o + b * p.o_sb + (long long)r * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = 8 * c + 2 * (lane & 3);
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * c + 2 * j] * inv, o[4 * c + 2 * j + 1] * inv);
      }
      if (p.lse && (lane & 3) == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + r] = l[j] > 0.f ? m[j] * kLn2 + logf(l[j])
                                                               : kEmptyLse;
    }
  }
}

// ------------------------------------------------- d = 512: cp.async + mma
struct PtrParams {
  const bf16* q; const bf16* k; const bf16* v; const bf16* kb; const bf16* vb;
  const int* kv_lens; bf16* o; float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long kb_ss, kb_sh, vb_ss, vb_sh, o_sb, o_ss, o_sh;
  int H, Sq, Ls, Lb, D;
  float scale_log2;
};

constexpr int kWideD = 512;
constexpr int kWideTileBytes = 64 * kWideD * 2;  // one 64-row Q, K or V tile
constexpr int kWideSmem = 3 * kWideTileBytes + 64 * 64 * 2 + 2 * 2 * 64 * 4 + 128;

// byte offset of (row, col) in a tile of `chunks` 16-byte chunks a row,
// chunk index XOR-swizzled with row & 7 (conflict-free ldmatrix)
template <int CHUNKS>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)((row * CHUNKS + ((col >> 3) ^ (row & 7))) * 16 + (col & 7) * 2);
}

// 64 rows x 512 columns of a (rows, D) slice with row stride ss into a
// swizzled tile; rows >= nvalid and columns >= D are zero-filled
__device__ __forceinline__ void load_wide(uint32_t dst, const bf16* src, long long ss, int nvalid,
                                          int D, int tid) {
#pragma unroll
  for (int i = 0; i < 64 * 64 / 256; ++i) {
    const int idx = tid + 256 * i, row = idx >> 6, col = (idx & 63) * 8;
    const bool ok = row < nvalid && col < D;
    cp_async16(dst + swz<64>(row, col), ok ? src + row * ss + col : src, ok);
  }
}

__global__ void __launch_bounds__(256, 1) flash_fwd_wide(const PtrParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t sQ = base, sK = sQ + kWideTileBytes, sV = sK + kWideTileBytes;
  const uint32_t sP = sV + kWideTileBytes;
  float* red = reinterpret_cast<float*>(smem_raw + (sP + 64 * 64 * 2 - smem_u32(smem_raw)));
  float* red_max = red;        // [2][64]: each half's row maxima
  float* red_sum = red + 128;  // [2][64]: each half's row sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp & 3, hf = warp >> 2;  // row group (16 rows), column half
  const int g = lane >> 2, qd = lane & 3;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const Segments seg = segments(p.kv_lens, b, p.Ls, p.Lb);
  const int tiles0 = (seg.n0 + 63) / 64;
  const int ntiles = tiles0 + (seg.n1 + 63) / 64;
  const float sl2 = p.scale_log2;

  // tile t: keys [row, row + 64) of the self segment, then of the bank
  auto tile_row = [&](int t) { return (t >= tiles0 ? t - tiles0 : t) * 64; };
  auto tile_keys = [&](int t) { return min(64, (t >= tiles0 ? seg.n1 : seg.n0) - tile_row(t)); };
  auto load_kv = [&](uint32_t dst, int t, bool value) {
    const bool bank = t >= tiles0;
    const long long ss = bank ? (value ? p.vb_ss : p.kb_ss) : (value ? p.v_ss : p.k_ss);
    const bf16* base = bank ? (value ? p.vb + h * p.vb_sh : p.kb + h * p.kb_sh)
                            : (value ? p.v + b * p.v_sb + h * p.v_sh : p.k + b * p.k_sb + h * p.k_sh);
    load_wide(dst, base + tile_row(t) * ss, ss, tile_keys(t), p.D, tid);
  };

  load_wide(sQ, p.q + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh, p.q_ss,
            min(64, p.Sq - q0), p.D, tid);
  cp_async_commit();
  if (ntiles > 0) {
    load_kv(sK, 0, false);
    cp_async_commit();
    load_kv(sV, 0, true);
    cp_async_commit();
  }

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int rowl = 16 * rg + g;  // this thread's rows in the tile: rowl, rowl + 8

  for (int t = 0; t < ntiles; ++t) {
    const int nk = tile_keys(t);
    cp_async_wait<1>();  // Q and K_t have landed (V_t may still be in flight)
    __syncthreads();

    // S: rows 16 rg.., keys 32 hf .. 32 hf + 31
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kWideD / 16; ++kk) {
      uint32_t a[4], bq[4];
      ldsm_x4(a, sQ + swz<64>(16 * rg + a_row(lane), 16 * kk + a_col(lane)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm_x4(bq, sK + swz<64>(32 * hf + 16 * np + bn_row(lane), 16 * kk + bn_col(lane)));
        mma16816(s + 8 * np, a, bq[0], bq[1]);
        mma16816(s + 8 * np + 4, a, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with K_t
    if (t + 1 < ntiles) load_kv(sK, t + 1, false);
    cp_async_commit();

    // mask, then the row maxima over both halves
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (32 * hf + 8 * nt + 2 * qd + (e & 1) >= nk) s[4 * nt + e] = -INFINITY;
    float mx[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mx[j] = fmaxf(mx[j], fmaxf(s[4 * nt + 2 * j], s[4 * nt + 2 * j + 1]));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      if (qd == 0) red_max[hf * 64 + rowl + 8 * j] = mx[j];
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");  // the row group's two warps
    float alpha[2], mnew[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float other = red_max[(1 - hf) * 64 + rowl + 8 * j];
      mnew[j] = fmaxf(m[j], fmaxf(mx[j], other) * sl2);
      alpha[j] = exp2f(m[j] - mnew[j]);
      m[j] = mnew[j];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * nt + e] = exp2f(fmaf(s[4 * nt + e], sl2, -mnew[e >> 1]));
        rs[e >> 1] += s[4 * nt + e];
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P (bf16) into the shared 64 x 64 tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 32 * hf + 8 * nt + 2 * qd;
        const uint32_t v = pack_bf16(s[4 * nt + 2 * j], s[4 * nt + 2 * j + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sP + swz<8>(rowl + 8 * j, col)), "r"(v)
                     : "memory");
      }
    cp_async_wait<1>();  // V_t has landed (K_{t+1} may still be in flight)
    __syncthreads();

    // O[16 rows][256 columns of half hf] += P[16 rows][64 keys] . V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], bv[4];
      ldsm_x4(a, sP + swz<8>(16 * rg + a_row(lane), 16 * kk + a_col(lane)));
#pragma unroll
      for (int np = 0; np < 16; ++np) {
        ldsm_x4_t(bv, sV + swz<64>(16 * kk + bt_row(lane), 256 * hf + 16 * np + bt_col(lane)));
        mma16816(o + 8 * np, a, bv[0], bv[1]);
        mma16816(o + 8 * np + 4, a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with V_t and P
    if (t + 1 < ntiles) load_kv(sV, t + 1, true);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // l over both halves, then O / l
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    if (qd == 0) red_sum[hf * 64 + rowl + 8 * j] = l[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = q0 + rowl + 8 * j;
    if (r >= p.Sq) continue;
    const float lt = red_sum[rowl + 8 * j] + red_sum[64 + rowl + 8 * j];
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = p.o + b * p.o_sb + (long long)r * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int nt = 0; nt < 32; ++nt) {
      const int col = 256 * hf + 8 * nt + 2 * qd;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * nt + 2 * j] * inv, o[4 * nt + 2 * j + 1] * inv);
    }
    if (p.lse && hf == 0 && qd == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + r] = lt > 0.f ? m[j] * kLn2 + logf(lt) : kEmptyLse;
  }
}

// ------------------------------------------------------------------- host
template <int DP, int SW, int BK>
int launch_tma(const PtrParams& a, int B, cudaStream_t stream) {
  using C = TmaCfg<DP, SW, BK>;
  TmaParams p;
  bool ok = make_map(&p.tq, a.q, a.D, a.Sq, a.H, B, a.q_ss, a.q_sh, a.q_sb, 64, SW) &&
            make_map(&p.tk, a.k, a.D, a.Ls, a.H, B, a.k_ss, a.k_sh, a.k_sb, BK, SW) &&
            make_map(&p.tv, a.v, a.D, a.Ls, a.H, B, a.v_ss, a.v_sh, a.v_sb, BK, SW);
  if (a.Lb > 0) {
    ok = ok && make_map(&p.tkb, a.kb, a.D, a.Lb, a.H, 1, a.kb_ss, a.kb_sh, 0, BK, SW) &&
         make_map(&p.tvb, a.vb, a.D, a.Lb, a.H, 1, a.vb_ss, a.vb_sh, 0, BK, SW);
  } else {  // no bank tile is ever loaded; the self maps stand in
    p.tkb = p.tk;
    p.tvb = p.tv;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  p.kv_lens = a.kv_lens; p.o = a.o; p.lse = a.lse;
  p.o_sb = a.o_sb; p.o_ss = a.o_ss; p.o_sh = a.o_sh;
  p.H = a.H; p.Sq = a.Sq; p.Ls = a.Ls; p.Lb = a.Lb; p.D = a.D;
  p.scale_log2 = a.scale_log2;
  static cudaError_t attr = cudaFuncSetAttribute(  // once per variant
      flash_fwd_tma<DP, SW, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sq + 127) / 128, a.H, B);
  flash_fwd_tma<DP, SW, BK><<<grid, 384, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_wide(const PtrParams& p, int B, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((p.Sq + 63) / 64, p.H, B);
  flash_fwd_wide<<<grid, 256, kWideSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int mmgt_flash_attn(
    const void* q, const void* k, const void* v, const void* kb, const void* vb,
    const void* kv_lens, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long kb_ss, long long kb_sh, long long vb_ss, long long vb_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int H, int Sq, int Ls, int Lb, int D, float scale, void* stream) {
  PtrParams p;
  p.q = (const bf16*)q; p.k = (const bf16*)k; p.v = (const bf16*)v;
  p.kb = (const bf16*)kb; p.vb = (const bf16*)vb;
  p.kv_lens = (const int*)kv_lens; p.o = (bf16*)o; p.lse = (float*)lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.kb_ss = kb_ss; p.kb_sh = kb_sh; p.vb_ss = vb_ss; p.vb_sh = vb_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.H = H; p.Sq = Sq; p.Ls = Ls; p.Lb = Lb; p.D = D;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  // the path's head dims: 40 -> 48, 80 -> 96, 160, 512 (VAE); a smaller d
  // runs zero-padded in the next variant up
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return launch_tma<48, 32, 128>(p, B, st);
  if (D <= 96) return launch_tma<96, 64, 128>(p, B, st);
  if (D <= 160) return launch_tma<160, 64, 64>(p, B, st);
  if (D <= kWideD) return launch_wide(p, B, st);
  return (int)cudaErrorInvalidValue;
}

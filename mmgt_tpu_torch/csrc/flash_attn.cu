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
//     4-stage ring of K/V buffers guarded by full/empty mbarriers. It
//     gives its registers away (setmaxnreg 24).
//   * Warpgroups 0 and 1 consume, 64 query rows each (setmaxnreg 240).
//     Per key tile t: S_t = Q K_t^T by wgmma m64nBKk16 (Q and K K-major
//     from swizzled shared memory) and O += P_{t-1} V_{t-1} (P as wgmma's
//     register A operand, V read MN-major) are issued together as two
//     commit groups; wait_group 1 lets the online softmax of S_t (quad
//     shuffles, 2^x with scale * log2(e) folded in) run while P_{t-1} V_{t-1}
//     is still on the tensor cores, and O is rescaled once it has retired.
//     The two warpgroups take turns issuing (named barriers 1 and 2), so
//     one's softmax overlaps the other's products. 2^x is one MUFU.EX2
//     (ex2.approx.ftz; exp2f without --use_fast_math adds a compare and two
//     predicated multiplies). S, the running max and sum and O never leave
//     registers. Only the last partial tile of a segment is masked
//     (columns at or past the limit get -inf before the max). Each wgmma
//     descriptor is one add to a precomputed low word.
//   * What bounds it (NVIDIA H100 80GB HBM3, 700 W; mmgt_tpu_torch/tools/
//     k1_rows.py on throwaway copies, PERF.md): at the level-0 bank shape
//     the K/V stream alone (consumers that only wait and release) takes
//     0.218 ms and the work alone (no load after the ring's first fill)
//     0.215 ms, of the whole call's 0.222-0.225 ms; without its 2^x the
//     work takes 0.162 ms. So the stream of 80-byte key rows from L2, the
//     products and the exponentials each nearly fill the time; the
//     exponential floor (one 2^x a score at 16 a clock an SM) is 0.104 ms.
//   * Head-dim padding: TMA fills columns past D with zeros, so the padding
//     costs no device memory. Tiles are loaded as column boxes of one
//     swizzle span each. d = 40 runs padded to 48 with a 32-byte swizzle
//     (3 boxes); padding to 64 under the 128-byte swizzle (one box, a third
//     more tensor-core work) timed 7-9 % slower, so the 48-column tiles
//     are kept.
//     d = 80 runs padded to 96 and d = 160 as is, both with a 64-byte
//     swizzle (3 and 5 boxes).
//   * Tiles: BQ = 128; BK = 128 for d <= 96 (S is 64 f32 registers a
//     thread, P's fragments 32), 64 at d = 160 (O alone is 80). Shared
//     memory: Q, then 4 stages of K and V: 109 KB (d 48), 217 KB (96),
//     201 KB (160).
//
// d = 512 (the VAE's single-head mid attention: 10 launches at (8, 4096, 1,
// 512) in a flagship clip's decode, one at (1, 4096, 1, 512) for the
// reference encode, (12, 4096, 1, 512) in a video train step). Replaces
// _flash_kernel reached by _flash_attention (mmgt_tpu/ops/attention.py:107,
// pallas_call :132). Bound: operations, 4 * H * d * Sq * sum(kv_len): 34.4
// GFLOP at (1, 4096, 1, 512), 0.035 ms at the tensor-core peak (bytes: 16.8
// MB, 0.005 ms). What the design does about it: both products run on
// wgmma from tiles TMA brings into shared memory; the f32 O never leaves
// registers. One block per (64-query tile, head, row, key split), 3
// warpgroups:
//   * Warpgroup 2 produces (setmaxnreg 24): one thread loads the Q tile
//     once (64 KB, eight 64-column boxes under the 128-byte swizzle, 4-D
//     maps over (D, S, H, B) with the caller's strides), then walks the
//     self tiles and the bank tiles below kv_len, 64 keys each, into one K
//     and one V slot (64 KB each) guarded by full/empty mbarriers: K_{j+1}
//     lands while the consumers run the softmax and P V_j, V_{j+1} during
//     S_{j+1}. TMA's zero fill pads rows past S and columns past D.
//   * The register wall: a 64 x 512 f32 O is 256 registers a thread in one
//     warpgroup, so warpgroups 0 and 1 (setmaxnreg 240) share the 64
//     queries and each owns 256 of O's columns (128 registers). S is split
//     by keys: warpgroup w computes S for keys 32 w .. 32 w + 31 of the
//     tile over all of d (wgmma m64n32k16 x 32, Q and K K-major from
//     shared memory); the two exchange their row maxima through shared
//     memory (named barrier 1), take exp2 with scale * log2(e) folded in
//     and write their halves of P (bf16) into one 128-byte-swizzled 64 x 64
//     tile (fence.proxy.async, named barrier 2). Then O_w += P V[:, 256 w
//     ..] by wgmma m64n256k16 x 4 with P and V (MN-major) from shared
//     memory. The row sums are exchanged once, at the end.
//     The other split, each warpgroup a partial S over half of d (m64n64,
//     16 k-steps) with the two 16 KB f32 partials added through shared
//     memory and P fed from registers, was timed against this one on a
//     throwaway copy and was slower at the three shapes above: its f32
//     exchange costs more shared-memory traffic than this split's second
//     read of Q.
//   * Filling the card: at (1, 4096, 1, 512) one block per query tile is 64
//     blocks for 132 SMs. The wrapper (ops/attention.py:wide_splits) then
//     splits each row's key tiles into n ranges (n = SMs // blocks, at most
//     4), each block writes its O / l and LSE in f32 to scratch the wrapper
//     allocates (n * B * H * Sq * (D + 1) floats: 16.8 MB at n = 2), and
//     flash_fwd_combine weighs the n partials by exp(lse_s - max) in a
//     fixed order, so two calls give the same bits.
//   * What it costs over the bound: the two warpgroups run in lockstep (S,
//     the exchanges, the softmax and the rescale of O, then P V), so the
//     tensor cores idle during the softmax; each warpgroup reads all of Q
//     from shared memory for every key tile. A throwaway variant that loads
//     no K or V after the first tile ran no faster: the loads are hidden.
//   * Shared memory: Q, K, V (64 KB each), P (8 KB), the row maxima and
//     sums (1 KB), 5 mbarriers: 206,912 bytes with the alignment pad.
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
  static constexpr int SWC = SW / 2;       // columns of one box (one swizzle span)
  static constexpr int NBOX = DP / SWC;    // boxes across the padded head dim
  static constexpr int STAGES = 4;
  static constexpr int QB = 64 * DP * 2;  // one consumer's Q tile, bytes
  static constexpr int KB = BK * DP * 2;  // one K (or V) tile, bytes
  static constexpr int SMEM = 2 * QB + STAGES * 2 * KB + 8 * (2 * STAGES + 1) + 1024;
  static_assert(DP % SWC == 0 && DP % 16 == 0, "head dim pads to whole boxes");
  static_assert(SMEM <= 232448, "shared memory");
};

// The two consumer warpgroups take turns issuing their products (named
// barriers 1 and 2: warpgroup w waits on 1 + w and passes to the other), so
// that one's exponentials overlap the other's wgmma.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

template <int DP, int SW, int BK>
__global__ void __launch_bounds__(384, 1) flash_fwd_tma(const __grid_constant__ TmaParams p) {
  using C = TmaCfg<DP, SW, BK>;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte aligned bases
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + 2 * C::QB;
  const uint32_t sV = sK + ST * C::KB;
  const uint32_t bars = sV + ST * C::KB;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (ST + s); };
  const uint32_t qbar = bars + 16u * ST;

  const int q0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const Segments seg = segments(p.kv_lens, b, p.Ls, p.Lb);
  const int tiles0 = (seg.n0 + BK - 1) / BK;
  const int ntiles = tiles0 + (seg.n1 + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
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
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j)
          tma_load(sQ + w * C::QB + j * 64 * SW, &p.tq, qbar, j * C::SWC, q0 + 64 * w, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % ST;
        mbar_wait(empty(st), ((t / ST) & 1) ^ 1);
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
    if (ntiles > 0) {
      // S of one tile (register 4c + 2j + e is (row g + 8j, key 8c + 2q + e))
      // and the previous tile's P as bf16 A fragments
      float s[BK / 2];
      uint32_t a[BK / 16][4];
      // wgmma descriptors: the high word is the same for every operand and
      // the start address in the low word moves with the stage and the k
      // step (a tile's offsets never carry out of its 14 bits), so each
      // product's descriptor is one add
      const uint32_t hi = (uint32_t)(make_desc<SW>(sQ, 16) >> 32);
      const uint32_t q_lo = (uint32_t)make_desc<SW>(q_base, 16);
      const uint32_t k_lo = (uint32_t)make_desc<SW>(sK, 16);
      const uint32_t v_lo = (uint32_t)make_desc<SW>(sV, BK * SW);
      auto desc = [&](uint32_t lo, uint32_t off) {
        return ((uint64_t)hi << 32) | (lo + (off >> 4));
      };
      // S = Q K_t^T into acc: 64 rows x BK keys, Q and K K-major from
      // shared memory
      auto issue_s = [&](float* acc, int t) {
        const uint32_t kt = k_lo + (t % ST) * (C::KB >> 4);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int box = (16 * kk) / C::SWC, within = (16 * kk) % C::SWC * 2;
          wgmma_ss<BK>(acc, desc(q_lo, box * 64 * SW + within),
                       desc(kt, box * BK * SW + within), kk > 0);
        }
        wgmma_commit();
      };
      // O += P V_t: P the register A operand, V the MN-major B operand
      auto issue_pv = [&](int t) {
        const uint32_t vt = v_lo + (t % ST) * (C::KB >> 4);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<DP>(o, a[kk], desc(vt, kk * 16 * SW));
        wgmma_commit();
      };
      // the online softmax of tile t in x (log2 domain): only a segment's
      // last, partial tile is masked (keys at or past its limit get -inf
      // before the max); new row maxima, the factor alpha that brings O and
      // l to them, P = 2^(x * scale * log2 e - m), the row sums into l
      auto softmax = [&](float* x, int t, float* alpha) {
        const int nk = t >= tiles0 ? seg.n1 - (t - tiles0) * BK : seg.n0 - t * BK;
        if (nk < BK) {
#pragma unroll
          for (int c = 0; c < BK / 8; ++c) {
            const int col = 8 * c + 2 * (lane & 3);
            if (col >= nk) { x[4 * c] = -INFINITY; x[4 * c + 2] = -INFINITY; }
            if (col + 1 >= nk) { x[4 * c + 1] = -INFINITY; x[4 * c + 3] = -INFINITY; }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < BK / 8; ++c)
            mx = fmaxf(mx, fmaxf(x[4 * c + 2 * j], x[4 * c + 2 * j + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mnew = fmaxf(m[j], mx * sl2);
          alpha[j] = ex2(m[j] - mnew);
          m[j] = mnew;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[4 * c + e] = ex2(fmaf(x[4 * c + e], sl2, -m[e >> 1]));
            rs[e >> 1] += x[4 * c + e];
          }
#pragma unroll
        for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
      };
      auto to_frags = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(a[kk], s + 8 * kk);
      };

      // Tile t's S = Q K_t^T is issued before tile t - 1's O += P V, and
      // its softmax runs while that product is on the tensor cores; O is
      // rescaled once the product has retired. First and last tiles are
      // peeled, so every commit group is issued unconditionally.
      float alpha[2];
      if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
      mbar_wait(full(0), 0);
      turn_wait(wg);
      wgmma_fence();
      issue_s(s, 0);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      softmax(s, 0, alpha);  // O is 0: no rescale
      to_frags();
      for (int t = 1; t < ntiles; ++t) {
        mbar_wait(full(t % ST), (t / ST) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_s(s, t);
        issue_pv(t - 1);
        turn_pass(wg);
        wgmma_wait<1>();  // S of tile t has landed
        fence_regs<BK / 2>(s);
        softmax(s, t, alpha);
        wgmma_wait<0>();  // tile t - 1's product has read a[] and V
        fence_frags<BK / 16>(a);
        fence_regs<DP / 2>(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((t - 1) % ST));
#pragma unroll
        for (int c = 0; c < DP / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * c + e] *= alpha[e >> 1];
        to_frags();
      }
      turn_wait(wg);
      wgmma_fence();
      issue_pv(ntiles - 1);
      if (wg == 0) turn_pass(wg);  // every wait has had its pass
      wgmma_wait<0>();
      fence_regs<DP / 2>(o);
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

// ------------------------------------------------ d = 512: TMA + wgmma
struct PtrParams {
  const bf16* q; const bf16* k; const bf16* v; const bf16* kb; const bf16* vb;
  const int* kv_lens; bf16* o; float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long kb_ss, kb_sh, vb_ss, vb_sh, o_sb, o_ss, o_sh;
  int H, Sq, Ls, Lb, D;
  float scale_log2;
};

struct WideParams {
  CUtensorMap tq, tk, tv, tkb, tvb;  // (D, S, H, B) maps, boxes of 64 columns x 64 rows
  const int* kv_lens;
  bf16* o;
  float* lse;
  // nsplit > 1: the splits' outputs (nsplit, B, H, Sq, D) and LSEs
  // (nsplit, B, H, Sq), f32, for flash_fwd_combine
  float* part;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Ls, Lb, D, nsplit;
  float scale_log2;
};

constexpr int kWideBox = 64 * 128;       // 64 rows of one 64-column box (128-byte swizzle)
constexpr int kWideTile = 8 * kWideBox;  // a 64-row Q, K or V tile at d = 512: 64 KB
constexpr int kWideX = 64 * 64 * 2 + 4 * 64 * 4;  // P (bf16), the row maxima and sums
constexpr int kWideCols = 4;  // groups of 8 keys in a warpgroup's S (32 of the tile's 64)
constexpr int kWideSmem = 3 * kWideTile + kWideX + 64 + 1024;  // + mbarriers, alignment pad
constexpr int kMaxSplits = 4;  // key splits (ops/attention.py, MAX_SPLITS)

__global__ void __launch_bounds__(384, 1) flash_fwd_wide(const __grid_constant__ WideParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte aligned bases
  const uint32_t sQ = base, sK = sQ + kWideTile, sV = sK + kWideTile, sX = sV + kWideTile;
  const uint32_t qbar = sX + kWideX, kfull = qbar + 8, kempty = qbar + 16, vfull = qbar + 24,
                 vempty = qbar + 32;
  float* xf = reinterpret_cast<float*>(smem_raw + (sX - raw));

  const int split = blockIdx.x % p.nsplit, q0 = blockIdx.x / p.nsplit * 64;
  const int h = blockIdx.y, b = blockIdx.z;
  const Segments seg = segments(p.kv_lens, b, p.Ls, p.Lb);
  const int tiles0 = (seg.n0 + 63) / 64;
  const int ntiles = tiles0 + (seg.n1 + 63) / 64;
  const int t_beg = ntiles * split / p.nsplit, t_end = ntiles * (split + 1) / p.nsplit;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(kfull, 1);
    mbar_init(vfull, 1);
    mbar_init(kempty, 8);  // one arrival per consumer warp
    mbar_init(vempty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, kWideTile);
#pragma unroll
      for (int j = 0; j < 8; ++j) tma_load(sQ + j * kWideBox, &p.tq, qbar, 64 * j, q0, h, b);
      for (int t = t_beg; t < t_end; ++t) {
        const int it = t - t_beg;
        const bool bank = t >= tiles0;
        const int row = (bank ? t - tiles0 : t) * 64;
        const CUtensorMap* mk = bank ? &p.tkb : &p.tk;
        const CUtensorMap* mv = bank ? &p.tvb : &p.tv;
        const int bb = bank ? 0 : b;
        mbar_wait(kempty, (it & 1) ^ 1);
        mbar_expect_tx(kfull, kWideTile);
#pragma unroll
        for (int j = 0; j < 8; ++j) tma_load(sK + j * kWideBox, mk, kfull, 64 * j, row, h, bb);
        mbar_wait(vempty, (it & 1) ^ 1);
        mbar_expect_tx(vfull, kWideTile);
#pragma unroll
        for (int j = 0; j < 8; ++j) tma_load(sV + j * kWideBox, mv, vfull, 64 * j, row, h, bb);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
    const int qd = lane & 3;
    const int rl = 16 * (tid / 32) + (lane >> 2);  // this thread's rows of the tile: rl, rl + 8
    float o[128];  // O[:, 256 wg .. 256 wg + 255]
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const float sl2 = p.scale_log2;
    const int col0 = 32 * wg;
    float* red = xf + 64 * 64 / 2;  // [2][64] row maxima, then [2][64] row sums

    mbar_wait(qbar, 0);
    for (int t = t_beg; t < t_end; ++t) {
      const int it = t - t_beg;
      const bool bank = t >= tiles0;
      const int nk = bank ? min(64, seg.n1 - (t - tiles0) * 64) : min(64, seg.n0 - t * 64);
      float s[4 * kWideCols];
      mbar_wait(kfull, it & 1);
      wgmma_fence();
      // S = Q K^T for this warpgroup's 32 keys (rows 32 wg .. of the K tile)
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        const uint32_t off = (kk / 4) * kWideBox + (kk % 4) * 32;
        wgmma_ss<32>(s, make_desc<128>(sQ + off, 16),
                     make_desc<128>(sK + off + 32 * 128 * wg, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<4 * kWideCols>(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(kempty);
      // mask the partial tile: register 4c + 2j + e is (row rl + 8 j, key col0 + 8c + 2q + e)
      if (nk < 64) {
#pragma unroll
        for (int c = 0; c < kWideCols; ++c) {
          const int col = col0 + 8 * c + 2 * qd;
          if (col >= nk) { s[4 * c] = -INFINITY; s[4 * c + 2] = -INFINITY; }
          if (col + 1 >= nk) { s[4 * c + 1] = -INFINITY; s[4 * c + 3] = -INFINITY; }
        }
      }
      float mx[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = -INFINITY;
#pragma unroll
        for (int c = 0; c < kWideCols; ++c)
          mx[j] = fmaxf(mx[j], fmaxf(s[4 * c + 2 * j], s[4 * c + 2 * j + 1]));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      }
      if (qd == 0) {
        red[64 * wg + rl] = mx[0];
        red[64 * wg + rl + 8] = mx[1];
      }
      named_sync(1, 256);
      mx[0] = fmaxf(mx[0], red[64 * (1 - wg) + rl]);
      mx[1] = fmaxf(mx[1], red[64 * (1 - wg) + rl + 8]);
      // online softmax in registers (log2 domain)
      float alpha[2], mnew[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mnew[j] = fmaxf(m[j], mx[j] * sl2);
        alpha[j] = exp2f(m[j] - mnew[j]);
        m[j] = mnew[j];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kWideCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * c + e] = exp2f(fmaf(s[4 * c + e], sl2, -mnew[e >> 1]));
          rs[e >> 1] += s[4 * c + e];
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O[:, this warpgroup's 256 columns] += P V, V the MN-major B operand
      const uint32_t v_base = sV + 4 * wg * kWideBox;
      // P (bf16) into the shared 64 x 64 tile, swizzled as TMA would write it
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = rl + 8 * j, col = col0 + 8 * c + 2 * qd;
          const uint32_t addr = sX + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(pack_bf16(s[4 * c + 2 * j], s[4 * c + 2 * j + 1]))
                       : "memory");
        }
      fence_proxy_async();
      named_sync(2, 256);  // P is whole
      mbar_wait(vfull, it & 1);
      wgmma_fence();
      fence_regs<128>(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n256_t(o, make_desc<128>(sX + kk * 32, 16),
                        make_desc<128>(v_base + kk * 16 * 128, kWideBox));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<128>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(vempty);
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    }
    if (qd == 0) {
      red[128 + 64 * wg + rl] = l[0];
      red[128 + 64 * wg + rl + 8] = l[1];
    }
    named_sync(1, 256);
    l[0] = red[128 + rl] + red[192 + rl];
    l[1] = red[128 + rl + 8] + red[192 + rl + 8];
    // O / l straight from registers; rows past Sq are not stored
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = q0 + rl + 8 * j;
      if (r >= p.Sq) continue;
      const float inv = 1.f / fmaxf(l[j], 1e-30f);
      if (p.nsplit == 1) {
        bf16* orow = p.o + b * p.o_sb + (long long)r * p.o_ss + h * p.o_sh;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int col = 256 * wg + 8 * c + 2 * qd;
          if (col < p.D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[4 * c + 2 * j] * inv, o[4 * c + 2 * j + 1] * inv);
        }
        if (p.lse && wg == 0 && qd == 0)
          p.lse[((long long)b * p.H + h) * p.Sq + r] =
              l[j] > 0.f ? m[j] * kLn2 + logf(l[j]) : kEmptyLse;
      } else {  // this split's O / l and LSE (-inf: no key in the split)
        const long long row = (((long long)split * gridDim.z + b) * p.H + h) * p.Sq + r;
        float* prow = p.part + row * p.D;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int col = 256 * wg + 8 * c + 2 * qd;
          if (col < p.D)
            *reinterpret_cast<float2*>(prow + col) =
                make_float2(o[4 * c + 2 * j] * inv, o[4 * c + 2 * j + 1] * inv);
        }
        if (wg == 0 && qd == 0)
          p.part[(long long)p.nsplit * gridDim.z * p.H * p.Sq * p.D + row] =
              l[j] > 0.f ? m[j] * kLn2 + logf(l[j]) : -INFINITY;
      }
    }
  }
}

struct CombineParams {
  const float* part;
  bf16* o;
  float* lse;
  long long o_sb, o_ss, o_sh;
  int B, H, Sq, D, nsplit;
};

// O = sum_s w_s O_s / sum_s w_s with w_s = exp(lse_s - max lse), the
// splits taken in order (two calls give the same bits); 64 threads a
// (b, h, query) row, 8 columns a thread
__global__ void __launch_bounds__(256) flash_fwd_combine(const CombineParams p) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 64;
  if (row >= rows) return;
  const int i = (int)(row % p.Sq), h = (int)(row / p.Sq % p.H), b = (int)(row / p.Sq / p.H);
  const float* plse = p.part + (long long)p.nsplit * rows * p.D;
  float w[kMaxSplits], mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = s < p.nsplit ? plse[s * rows + row] : -INFINITY;
    mx = fmaxf(mx, w[s]);
  }
  float tot = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = mx > -INFINITY && w[s] > -INFINITY ? expf(w[s] - mx) : 0.f;
    tot += w[s];
  }
  const float inv = tot > 0.f ? 1.f / tot : 0.f;
  bf16* orow = p.o + b * p.o_sb + (long long)i * p.o_ss + h * p.o_sh;
  for (int c = 8 * (threadIdx.x % 64); c < p.D; c += 512) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s >= p.nsplit) break;
      const float4* src = reinterpret_cast<const float4*>(p.part + (s * rows + row) * p.D + c);
      const float4 x = src[0], y = src[1];
      const float ws = w[s] * inv;
      acc[0] = fmaf(ws, x.x, acc[0]); acc[1] = fmaf(ws, x.y, acc[1]);
      acc[2] = fmaf(ws, x.z, acc[2]); acc[3] = fmaf(ws, x.w, acc[3]);
      acc[4] = fmaf(ws, y.x, acc[4]); acc[5] = fmaf(ws, y.y, acc[5]);
      acc[6] = fmaf(ws, y.z, acc[6]); acc[7] = fmaf(ws, y.w, acc[7]);
    }
    uint4 out;
    out.x = pack_bf16(acc[0], acc[1]);
    out.y = pack_bf16(acc[2], acc[3]);
    out.z = pack_bf16(acc[4], acc[5]);
    out.w = pack_bf16(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(orow + c) = out;
  }
  if (p.lse && threadIdx.x % 64 == 0) p.lse[row] = tot > 0.f ? mx + logf(tot) : kEmptyLse;
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

int launch_wide(const PtrParams& a, int B, float* part, int nsplit, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > kMaxSplits || (nsplit > 1 && !part))
    return (int)cudaErrorInvalidValue;
  WideParams p;
  bool ok = make_map(&p.tq, a.q, a.D, a.Sq, a.H, B, a.q_ss, a.q_sh, a.q_sb, 64, 128) &&
            make_map(&p.tk, a.k, a.D, a.Ls, a.H, B, a.k_ss, a.k_sh, a.k_sb, 64, 128) &&
            make_map(&p.tv, a.v, a.D, a.Ls, a.H, B, a.v_ss, a.v_sh, a.v_sb, 64, 128);
  if (a.Lb > 0) {
    ok = ok && make_map(&p.tkb, a.kb, a.D, a.Lb, a.H, 1, a.kb_ss, a.kb_sh, 0, 64, 128) &&
         make_map(&p.tvb, a.vb, a.D, a.Lb, a.H, 1, a.vb_ss, a.vb_sh, 0, 64, 128);
  } else {  // no bank tile is ever loaded; the self maps stand in
    p.tkb = p.tk;
    p.tvb = p.tv;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  p.kv_lens = a.kv_lens; p.o = a.o; p.lse = a.lse; p.part = part;
  p.o_sb = a.o_sb; p.o_ss = a.o_ss; p.o_sh = a.o_sh;
  p.H = a.H; p.Sq = a.Sq; p.Ls = a.Ls; p.Lb = a.Lb; p.D = a.D; p.nsplit = nsplit;
  p.scale_log2 = a.scale_log2;
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sq + 63) / 64 * nsplit, a.H, B);
  flash_fwd_wide<<<grid, 384, kWideSmem, stream>>>(p);
  if (nsplit == 1) return (int)cudaGetLastError();
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CombineParams c{part, a.o, a.lse, a.o_sb, a.o_ss, a.o_sh, B, a.H, a.Sq, a.D, nsplit};
  const long long rows = (long long)B * a.H * a.Sq;
  flash_fwd_combine<<<(unsigned)((rows + 3) / 4), 256, 0, stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int mmgt_flash_attn(
    const void* q, const void* k, const void* v, const void* kb, const void* vb,
    const void* kv_lens, void* o, void* lse, void* part,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long kb_ss, long long kb_sh, long long vb_ss, long long vb_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int H, int Sq, int Ls, int Lb, int D, int nsplit, float scale, void* stream) {
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
  if (D <= 512) return launch_wide(p, B, (float*)part, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

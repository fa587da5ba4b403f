// K5: flash-attention backward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernels of mmgt_tpu/ops/attention.py:_flash_attention_bwd
// (:376): _flash_dq_kernel (:236) and _flash_dkv_kernel (:270). Given the
// forward's q, k, v, o, its f32 log-sum-exp (K1's `lse`, (B, H, Sq)), the
// output gradient dO and the per-row valid key count kv_lens[b], it
// computes, per (row b, head h), over the keys j < kv_len:
//     D_i  = sum_d dO_id O_id                          (f32)
//     P_ij = exp(scale * q_i . k_j - lse_i)
//     dV_j = sum_i P_ij dO_i
//     dS_ij = P_ij (dO_i . v_j - D_i)
//     dQ_i = scale * sum_j dS_ij k_j,   dK_j = scale * sum_i dS_ij q_i
// Keys at or past kv_len get P = 0 before anything else (a row with
// kv_len = 0 has lse ~ -1e30, so the exp must never see it), and their
// dK/dV rows are written as zeros.
//
// Three launches in one C entry, with no atomics (the result is
// deterministic), the JAX package's own two-pass split:
//   1. bwd_dsum: D for every (b, h, i), one warp per row;
//   2. bwd_dq:   one block per (64-query tile, h, b), looping over the
//                64-key tiles below kv_len;
//   3. bwd_dkv:  one block per (64-key tile, h, b), looping over every
//                query tile; a tile whose first key is >= kv_len writes
//                zeros and returns.
// Each pass recomputes S = Q K^T and dP = dO V^T on the tensor cores (WMMA
// bf16 16x16x16, f32 accumulate); P and dS are rounded to bf16 only as
// operands of the next product, as in FlashAttention-2. head_dim 40 / 80
// run zero-padded to 48 / 96 inside shared memory; 160 as is. The f32
// accumulators (dQ; dK and dV) live in shared memory: at d = 160 the dK/dV
// pass holds K, V, Q and dO tiles, S and dP in f32, P and dS in bf16 and
// both accumulators, 213.5 KB, set above the 48 KB default.
//
// Bound on the H100: operations. At the level-0 bank shape (q (12, 4096,
// 8, 40), K/V (12, 8192, 8, 40)) the five products take 10 * H * D * Sq *
// sum(kv_len) flops against ~(4 * Sq + 4 * Skv) * H * D * 2 bytes per row.
// This first version uses WMMA from shared memory with no cp.async/TMA
// pipelining; `wgmma` and TMA come in a later PR.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

struct BwdParams {
  const bf16* q; const bf16* k; const bf16* v; const bf16* o; const bf16* dout;
  const float* lse; const int* kv_lens; float* dsum;
  bf16* dq; bf16* dk; bf16* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int B, H, Sq, Skv, D;
  float scale;
};

__device__ __forceinline__ int kv_len_of(const BwdParams& p, int b) {
  const int n = p.kv_lens ? p.kv_lens[b] : p.Skv;
  return max(0, min(n, p.Skv));
}

// dst[rows][DP] <- base[r * ss + c] for r < nvalid, c < D; zero elsewhere.
// 16-byte loads: the wrapper requires D % 8 == 0 and 16-byte aligned rows.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long ss,
                                          int rows, int nvalid, int D, int tid,
                                          int nthreads) {
  constexpr int VPR = DP / 8;
  for (int i = tid; i < rows * VPR; i += nthreads) {
    int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid && c < D) val = *reinterpret_cast<const uint4*>(base + r * ss + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// out[16][N] (f32, ld N) = A[16][DP] . B[N][DP]^T, both bf16 row-major in
// shared memory: one warp's 16 rows against N rows of the other operand.
template <int DP, int N>
__device__ __forceinline__ void warp_abt(float* out, const bf16* a, const bf16* b) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, DP);
      wmma::load_matrix_sync(fb, b + j * 16 * DP + kk * 16, DP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, N, wmma::mem_row_major);
  }
}

// acc[16][DP] (f32 in shared memory, ld DP) += A[16][K] . B[K][DP], A bf16
// (ld K) and B bf16 (ld DP), both row-major.
template <int DP, int K>
__device__ __forceinline__ void warp_acc_ab(float* acc_s, const bf16* a, const bf16* b) {
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, acc_s + j * 16, DP, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, K);
      wmma::load_matrix_sync(fb, b + kk * 16 * DP + j * 16, DP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(acc_s + j * 16, acc, DP, wmma::mem_row_major);
  }
}

// ------------------------------------------------------------ 1. D = rowsum
__global__ void bwd_dsum(BwdParams p) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int i = (int)(row % p.Sq);
  const int h = (int)((row / p.Sq) % p.H);
  const int b = (int)(row / ((long long)p.Sq * p.H));
  const bf16* dor = p.dout + b * p.do_sb + i * p.do_ss + h * p.do_sh;
  const bf16* orr = p.o + b * p.o_sb + i * p.o_ss + h * p.o_sh;
  float s = 0.f;
  for (int c = lane; c < p.D; c += 32) s += __bfloat162float(dor[c]) * __bfloat162float(orr[c]);
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.dsum[row] = s;  // row == (b * H + h) * Sq + i
}

// ------------------------------------------------------------ 2. dQ
template <int DP, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * BQ * DP + 2 * BK * DP) * 2 + (size_t)2 * BQ * BK * 4 +
         (size_t)BQ * BK * 2 + (size_t)BQ * DP * 4 + 2 * BQ * 4;
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32) bwd_dq(BwdParams p) {
  constexpr int NT = BQ / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);            // [BQ][DP]
  bf16* dOs = Qs + BQ * DP;                            // [BQ][DP]
  bf16* Ks = dOs + BQ * DP;                            // [BK][DP]
  bf16* Vs = Ks + BK * DP;                             // [BK][DP]
  float* Ss = reinterpret_cast<float*>(Vs + BK * DP);  // [BQ][BK] logits
  float* dPs = Ss + BQ * BK;                           // [BQ][BK] dO V^T
  bf16* dSs = reinterpret_cast<bf16*>(dPs + BQ * BK);  // [BQ][BK]
  float* dQs = reinterpret_cast<float*>(dSs + BQ * BK);  // [BQ][DP] accumulator
  float* Lse = dQs + BQ * DP;
  float* Dsum = Lse + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, p.Sq - q0);
  const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;

  load_tile<DP>(Qs, p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss, BQ, nq, p.D, tid, NT);
  load_tile<DP>(dOs, p.dout + b * p.do_sb + q0 * p.do_ss + h * p.do_sh, p.do_ss, BQ, nq,
                p.D, tid, NT);
  for (int i = tid; i < BQ * DP; i += NT) dQs[i] = 0.f;
  for (int r = tid; r < BQ; r += NT) {
    Lse[r] = r < nq ? p.lse[row0 + r] : 0.f;
    Dsum[r] = r < nq ? p.dsum[row0 + r] : 0.f;
  }

  const int kv_len = kv_len_of(p, b);
  const bf16* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* Qw = Qs + warp * 16 * DP;
  const bf16* dOw = dOs + warp * 16 * DP;
  float* Sw = Ss + warp * 16 * BK;
  float* dPw = dPs + warp * 16 * BK;
  bf16* dSw = dSs + warp * 16 * BK;
  float* dQw = dQs + warp * 16 * DP;

  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    const int nk = min(BK, kv_len - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(Ks, kbase + k0 * p.k_ss, p.k_ss, BK, nk, p.D, tid, NT);
    load_tile<DP>(Vs, vbase + k0 * p.v_ss, p.v_ss, BK, nk, p.D, tid, NT);
    __syncthreads();

    warp_abt<DP, BK>(Sw, Qw, Ks);    // S  = Q K^T
    warp_abt<DP, BK>(dPw, dOw, Vs);  // dP = dO V^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float lse = Lse[row], dsum = Dsum[row];
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int c = lane + 32 * t;
        const float pv = (c < nk && row < nq) ? __expf(Sw[r * BK + c] * p.scale - lse) : 0.f;
        dSw[r * BK + c] = __float2bfloat16(pv * (dPw[r * BK + c] - dsum));
      }
    }
    __syncwarp();
    warp_acc_ab<DP, BK>(dQw, dSw, Ks);  // dQ += dS K
    __syncwarp();
  }
  __syncthreads();

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    if (r < nq && c < p.D)
      p.dq[b * p.dq_sb + (q0 + r) * p.dq_ss + h * p.dq_sh + c] =
          __float2bfloat16(dQs[i] * p.scale);
  }
}

// ------------------------------------------------------------ 3. dK, dV
template <int DP, int BQ, int BK>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * BK * DP + 2 * BQ * DP) * 2 + (size_t)2 * BK * BQ * 4 +
         (size_t)2 * BK * BQ * 2 + (size_t)2 * BK * DP * 4 + 2 * BQ * 4;
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BK / 16 * 32) bwd_dkv(BwdParams p) {
  constexpr int NT = BK / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);              // [BK][DP]
  bf16* Vs = Ks + BK * DP;                               // [BK][DP]
  bf16* Qs = Vs + BK * DP;                               // [BQ][DP]
  bf16* dOs = Qs + BQ * DP;                              // [BQ][DP]
  float* St = reinterpret_cast<float*>(dOs + BQ * DP);   // [BK][BQ] (K Q^T)
  float* dPt = St + BK * BQ;                             // [BK][BQ] (V dO^T)
  bf16* Pt = reinterpret_cast<bf16*>(dPt + BK * BQ);     // [BK][BQ]
  bf16* dSt = Pt + BK * BQ;                              // [BK][BQ]
  float* dKs = reinterpret_cast<float*>(dSt + BK * BQ);  // [BK][DP] accumulator
  float* dVs = dKs + BK * DP;                            // [BK][DP] accumulator
  float* Lse = dVs + BK * DP;
  float* Dsum = Lse + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(BK, p.Skv - k0);
  const int kv_len = kv_len_of(p, b);
  bf16* dkbase = p.dk + b * p.dk_sb + k0 * p.dk_ss + h * p.dk_sh;
  bf16* dvbase = p.dv + b * p.dv_sb + k0 * p.dv_ss + h * p.dv_sh;
  if (k0 >= kv_len) {  // no valid key in this tile: its gradients are zero
    const bf16 z = __float2bfloat16(0.f);
    for (int i = tid; i < nrows * p.D; i += NT) {
      const int r = i / p.D, c = i % p.D;
      dkbase[r * p.dk_ss + c] = z;
      dvbase[r * p.dv_ss + c] = z;
    }
    return;
  }
  const int nk = min(BK, kv_len - k0);

  load_tile<DP>(Ks, p.k + b * p.k_sb + k0 * p.k_ss + h * p.k_sh, p.k_ss, BK, nk, p.D, tid, NT);
  load_tile<DP>(Vs, p.v + b * p.v_sb + k0 * p.v_ss + h * p.v_sh, p.v_ss, BK, nk, p.D, tid, NT);
  for (int i = tid; i < BK * DP; i += NT) { dKs[i] = 0.f; dVs[i] = 0.f; }

  const bf16* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dobase = p.dout + b * p.do_sb + h * p.do_sh;
  const long long rowbase = ((long long)b * p.H + h) * p.Sq;
  const bf16* Kw = Ks + warp * 16 * DP;
  const bf16* Vw = Vs + warp * 16 * DP;
  float* Sw = St + warp * 16 * BQ;
  float* dPw = dPt + warp * 16 * BQ;
  bf16* Pw = Pt + warp * 16 * BQ;
  bf16* dSw = dSt + warp * 16 * BQ;
  float* dKw = dKs + warp * 16 * DP;
  float* dVw = dVs + warp * 16 * DP;

  for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
    const int nq = min(BQ, p.Sq - q0);
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<DP>(Qs, qbase + q0 * p.q_ss, p.q_ss, BQ, nq, p.D, tid, NT);
    load_tile<DP>(dOs, dobase + q0 * p.do_ss, p.do_ss, BQ, nq, p.D, tid, NT);
    for (int r = tid; r < BQ; r += NT) {
      Lse[r] = r < nq ? p.lse[rowbase + q0 + r] : 0.f;
      Dsum[r] = r < nq ? p.dsum[rowbase + q0 + r] : 0.f;
    }
    __syncthreads();

    warp_abt<DP, BQ>(Sw, Kw, Qs);    // S^T  = K Q^T
    warp_abt<DP, BQ>(dPw, Vw, dOs);  // dP^T = V dO^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const bool key_ok = warp * 16 + r < nk;
#pragma unroll
      for (int t = 0; t < BQ / 32; ++t) {
        const int c = lane + 32 * t;
        const float pv =
            (key_ok && c < nq) ? __expf(Sw[r * BQ + c] * p.scale - Lse[c]) : 0.f;
        Pw[r * BQ + c] = __float2bfloat16(pv);
        dSw[r * BQ + c] = __float2bfloat16(pv * (dPw[r * BQ + c] - Dsum[c]));
      }
    }
    __syncwarp();
    warp_acc_ab<DP, BQ>(dVw, Pw, dOs);  // dV += P^T dO
    warp_acc_ab<DP, BQ>(dKw, dSw, Qs);  // dK += dS^T Q
    __syncwarp();
  }
  __syncthreads();

  for (int i = tid; i < BK * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    if (r < nrows && c < p.D) {
      dkbase[r * p.dk_ss + c] = __float2bfloat16(dKs[i] * p.scale);
      dvbase[r * p.dv_ss + c] = __float2bfloat16(dVs[i]);
    }
  }
}

template <int DP, int BQ, int BK>
int launch(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<DP, BQ, BK>();
  constexpr size_t smem_dkv = dkv_smem_bytes<DP, BQ, BK>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq<DP, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      bwd_dkv<DP, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (e != cudaSuccess) return (int)e;

  const long long rows = (long long)p.B * p.H * p.Sq;
  bwd_dsum<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q((p.Sq + BQ - 1) / BQ, p.H, p.B);
  bwd_dq<DP, BQ, BK><<<grid_q, BQ / 16 * 32, smem_dq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k((p.Skv + BK - 1) / BK, p.H, p.B);
  bwd_dkv<DP, BQ, BK><<<grid_k, BK / 16 * 32, smem_dkv, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int mmgt_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* kv_lens, void* dsum, void* dq, void* dk, void* dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    int B, int H, int Sq, int Skv, int D, float scale, void* stream) {
  BwdParams p;
  p.q = (const bf16*)q; p.k = (const bf16*)k; p.v = (const bf16*)v;
  p.o = (const bf16*)o; p.dout = (const bf16*)dout;
  p.lse = (const float*)lse; p.kv_lens = (const int*)kv_lens; p.dsum = (float*)dsum;
  p.dq = (bf16*)dq; p.dk = (bf16*)dk; p.dv = (bf16*)dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  // the trained path's head dims: 40 -> 48, 80 -> 96, 160; a smaller d
  // runs zero-padded in the next instantiation up
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return launch<48, 64, 64>(p, st);
  if (D <= 96) return launch<96, 64, 64>(p, st);
  if (D <= 160) return launch<160, 64, 64>(p, st);
  return (int)cudaErrorInvalidValue;
}

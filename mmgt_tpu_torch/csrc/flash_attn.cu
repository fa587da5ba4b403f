// K1: two-segment flash-attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernels mmgt_tpu/ops/attention.py:_flash_kernel,
// :_flash_fwd_lse_kernel (also reached by _flash_attention_packed_fwd) and
// :_flash_fwd_lse_2seg_kernel. Computes, per (row b, head h, query i),
//     softmax(q . [K_self ; K_bank]^T * scale) . [V_self ; V_bank]
// over the first kv_lens[b] keys of the concatenation, f32 online softmax,
// and optionally the f32 log-sum-exp. The bank segment has batch stride 0:
// every row reads the same (1, Lb, H, D) bank; a row whose kv_len <= Ls
// skips every bank tile (the CFG-uncond rows pay nothing for the bank).
//
// Bound: at the path's shapes (Sq = Skv = 4096..8192, d = 40/80/160/512)
// the two products dominate, 4*Sq*Skv*d flops per (row, head) against
// (Sq + 2*Skv)*d*2 bytes: operations bound the kernel (well above the
// H100's ~295 flop/byte ridge). Design: one block per (64-query tile,
// head, row) keeps Q, one K/V tile, the logits, P and the f32 output
// accumulator in shared memory, so nothing but q/k/v/o touches device
// memory; both products run on the tensor cores (WMMA bf16 16x16x16, f32
// accumulate). head_dim 40/80 are zero-padded to 48/96 inside shared
// memory, not in device memory. d = 512 (VAE mid attention) runs 32-query
// / 32-key tiles so its f32 accumulator fits shared memory (170 KB, above
// the 48 KB default, set with cudaFuncSetAttribute). Rows with no valid
// key return 0 (the l >= 1e-30 guard of the TPU kernel).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNeg = -1e30f;

struct FlashParams {
  const bf16* q; const bf16* k; const bf16* v; const bf16* kb; const bf16* vb;
  const int* kv_lens; bf16* o; float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long kb_ss, kb_sh, vb_ss, vb_sh, o_sb, o_ss, o_sh;
  int B, H, Sq, Ls, Lb, D;
  float scale;
};

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

template <int DP, int BQ, int BK>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * DP + 2 * BK * DP) * 2 + (size_t)BQ * BK * 4 +
         (size_t)BQ * BK * 2 + (size_t)BQ * DP * 4 + 3 * BQ * 4;
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32) flash_fwd(FlashParams p) {
  constexpr int NT = BQ / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);      // [BQ][DP]
  bf16* Ks = Qs + BQ * DP;                       // [BK][DP]
  bf16* Vs = Ks + BK * DP;                       // [BK][DP]
  float* Ss = reinterpret_cast<float*>(Vs + BK * DP);  // [BQ][BK] logits
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * BK);    // [BQ][BK] probabilities
  float* Os = reinterpret_cast<float*>(Ps + BQ * BK);  // [BQ][DP] accumulator
  float* Ms = Os + BQ * DP;                      // running max
  float* Ls = Ms + BQ;                           // running sum
  float* As = Ls + BQ;                           // per-tile rescale

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, p.Sq - q0);

  load_tile<DP>(Qs, p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss, BQ, nq, p.D, tid,
                NT);
  for (int i = tid; i < BQ * DP; i += NT) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) { Ms[i] = kNeg; Ls[i] = 0.f; }

  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Ls + p.Lb;
  const int n_seg[2] = {max(0, min(p.Ls, kv_len)), max(0, min(p.Lb, kv_len - p.Ls))};

  const bf16* Qw = Qs + warp * 16 * DP;
  float* Sw = Ss + warp * 16 * BK;
  bf16* Pw = Ps + warp * 16 * BK;
  float* Ow = Os + warp * 16 * DP;

  for (int seg = 0; seg < 2; ++seg) {
    const int n = n_seg[seg];
    if (n == 0) continue;
    const bf16* kbase = seg == 0 ? p.k + b * p.k_sb + h * p.k_sh : p.kb + h * p.kb_sh;
    const bf16* vbase = seg == 0 ? p.v + b * p.v_sb + h * p.v_sh : p.vb + h * p.vb_sh;
    const long long kss = seg == 0 ? p.k_ss : p.kb_ss;
    const long long vss = seg == 0 ? p.v_ss : p.vb_ss;
    for (int k0 = 0; k0 < n; k0 += BK) {
      const int nk = min(BK, n - k0);
      __syncthreads();  // every warp is done with the previous K/V tile
      load_tile<DP>(Ks, kbase + k0 * kss, kss, BK, nk, p.D, tid, NT);
      load_tile<DP>(Vs, vbase + k0 * vss, vss, BK, nk, p.D, tid, NT);
      __syncthreads();

      // S = Q K^T for this warp's 16 query rows
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qw + kk * 16, DP);
          wmma::load_matrix_sync(fb, Ks + j * 16 * DP + kk * 16, DP);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Sw + j * 16, acc, BK, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax, one row at a time across the warp's lanes
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r;
        float s[BK / 32];
        float mloc = kNeg;
#pragma unroll
        for (int t = 0; t < BK / 32; ++t) {
          const int c = lane + 32 * t;
          s[t] = c < nk ? Sw[r * BK + c] * p.scale : kNeg;
          mloc = fmaxf(mloc, s[t]);
        }
        for (int off = 16; off; off >>= 1)
          mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
        const float m_old = Ms[row];
        const float m_new = fmaxf(m_old, mloc);
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < BK / 32; ++t) {
          const int c = lane + 32 * t;
          const float pv = c < nk ? __expf(s[t] - m_new) : 0.f;
          psum += pv;
          Pw[r * BK + c] = __float2bfloat16(pv);
        }
        for (int off = 16; off; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        __syncwarp();
        if (lane == 0) {
          const float alpha = __expf(m_old - m_new);
          As[row] = alpha;
          Ls[row] = alpha * Ls[row] + psum;
          Ms[row] = m_new;
        }
        __syncwarp();
      }

      // O = alpha * O + P V
      for (int i = lane; i < 16 * DP; i += 32) Ow[i] *= As[warp * 16 + i / DP];
      __syncwarp();
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Ow + j * 16, DP, wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Pw + kk * 16, BK);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * DP + j * 16, DP);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ow + j * 16, acc, DP, wmma::mem_row_major);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    if (r < nq && c < p.D) {
      const float l = fmaxf(Ls[r], 1e-30f);
      p.o[b * p.o_sb + (q0 + r) * p.o_ss + h * p.o_sh + c] = __float2bfloat16(Os[i] / l);
    }
  }
  if (p.lse) {
    for (int r = tid; r < nq; r += NT) {
      const float l = fmaxf(Ls[r], 1e-30f);
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + r] = Ms[r] + logf(l);
    }
  }
}

template <int DP, int BQ, int BK>
int launch(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP, BQ, BK>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<DP, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd<DP, BQ, BK><<<grid, BQ / 16 * 32, smem, stream>>>(p);
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
  FlashParams p;
  p.q = (const bf16*)q; p.k = (const bf16*)k; p.v = (const bf16*)v;
  p.kb = (const bf16*)kb; p.vb = (const bf16*)vb;
  p.kv_lens = (const int*)kv_lens; p.o = (bf16*)o; p.lse = (float*)lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.kb_ss = kb_ss; p.kb_sh = kb_sh; p.vb_ss = vb_ss; p.vb_sh = vb_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.B = B; p.H = H; p.Sq = Sq; p.Ls = Ls; p.Lb = Lb; p.D = D;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  // the path's head dims: 40 -> 48, 80 -> 96, 160, 512 (VAE); a smaller d
  // runs zero-padded in the next instantiation up
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return launch<48, 64, 64>(p, st);
  if (D <= 96) return launch<96, 64, 64>(p, st);
  if (D <= 160) return launch<160, 64, 64>(p, st);
  if (D <= 512) return launch<512, 32, 32>(p, st);
  return (int)cudaErrorInvalidValue;
}

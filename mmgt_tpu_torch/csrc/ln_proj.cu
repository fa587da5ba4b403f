// K3: LayerNorm fused into 1-3 projections, for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel:
//     y_i = (LN(x) * gamma + beta) @ W_i^T + b_i,   i < 3,
// with f32 row statistics (eps inside the rsqrt), the normalised row
// rounded to bf16 before the product (as the TPU kernel rounds x_n to the
// weight dtype) and f32 accumulation; the bias is added in f32 in the
// epilogue. Two launches: a row-statistics pass (one warp per row, two-pass
// mean/variance like the reference math) and a tiled GEMM whose A-tile
// loader normalises x as it stages it into shared memory, so the normalised
// tensor never reaches device memory. One launch covers all weights
// (grid.z = weight index).
//
// The same GEMM serves K4 (csrc/motion_attn.cu's caller): its prologue can
// add a per-frame positional row (pe[(m / L) % F]) after the affine, each
// output can be written in f32 (q/k of the motion attention stay f32), and
// its epilogue can add a residual.
//
// Bound: M = rows x tokens is 10^4..10^5 and N, C are 320..10240, so the
// product dominates (2*M*C*N flops vs (M*C + C*N + M*N)*2 bytes): operations
// bound it at the path's shapes. Design: 64x64 output tiles, 32-deep K
// steps, four warps each holding a 32x32 f32 accumulator in WMMA bf16
// fragments; A and W tiles load as 16-byte vectors (C % 8 == 0 is required).
// A first kernel that is right and simple: no cp.async/TMA pipelining yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, LDS = BK + 8, LDC = BN + 4, NT = 128;

__global__ void ln_stats(const bf16* __restrict__ x, float* __restrict__ stats,
                         int M, int K, float eps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= M) return;
  const bf16* row = x + (long long)warp * K;
  float s = 0.f;
  for (int c = lane; c < K; c += 32) s += __bfloat162float(row[c]);
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / K;
  float v = 0.f;
  for (int c = lane; c < K; c += 32) {
    const float d = __bfloat162float(row[c]) - mean;
    v += d * d;
  }
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) {
    stats[2 * (long long)warp] = mean;
    stats[2 * (long long)warp + 1] = rsqrtf(v / K + eps);
  }
}

struct GemmParams {
  const bf16* x;
  const float* stats;   // (M, 2) mean, rstd; null: A is used as it is
  const float* gamma;   // (K,)
  const float* beta;    // (K,)
  const float* pe;      // (F, K) added after the affine; null: none
  int M, K, L, F;
  const bf16* w[3];     // (N_i, K) row-major, torch Linear layout
  int n[3];
  const float* bias[3]; // (N_i,) or null
  const bf16* res[3];   // (M, N_i) or null
  void* out[3];         // (M, N_i)
  int out_f32[3];
};

__global__ void __launch_bounds__(NT) ln_gemm(GemmParams p) {
  __shared__ __align__(128) bf16 As[BM * LDS];
  __shared__ __align__(128) bf16 Bs[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int wi = blockIdx.z;
  const int N = p.n[wi];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (n0 >= N) return;
  const bf16* __restrict__ W = p.w[wi];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // A tile: 64 rows x 32 cols = 256 vectors of 8, two per thread
    for (int i = tid; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m < p.M && k < p.K) {
        raw = *reinterpret_cast<const uint4*>(p.x + (long long)m * p.K + k);
        if (p.stats) {
          const float mean = p.stats[2 * (long long)m], rstd = p.stats[2 * (long long)m + 1];
          const float* per = p.pe ? p.pe + (long long)((m / p.L) % p.F) * p.K + k : nullptr;
          bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            float y = (__bfloat162float(e[t]) - mean) * rstd * p.gamma[k + t] + p.beta[k + t];
            if (per) y += per[t];
            e[t] = __float2bfloat16(y);
          }
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + c) = raw;
    }
    // W tile: 64 output rows x 32 cols
    for (int i = tid; i < BN * BK / 8; i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int n = n0 + r, k = k0 + c;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && k < p.K) raw = *reinterpret_cast<const uint4*>(W + (long long)n * p.K + k);
      *reinterpret_cast<uint4*>(Bs + r * LDS + c) = raw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDS + kk * 16, LDS);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * LDS + kk * 16, LDS);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  const float* bias = p.bias[wi];
  const bf16* res = p.res[wi];
  for (int i = tid; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= N) continue;
    float y = Cs[r * LDC + c];
    if (bias) y += bias[n];
    const long long off = (long long)m * N + n;
    if (res) y += __bfloat162float(res[off]);
    if (p.out_f32[wi]) reinterpret_cast<float*>(p.out[wi])[off] = y;
    else reinterpret_cast<bf16*>(p.out[wi])[off] = __float2bfloat16(y);
  }
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int mmgt_ln_stats(const void* x, void* stats, int M, int K, float eps,
                             void* stream) {
  if (M <= 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)M * 32 + threads - 1) / threads;
  ln_stats<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (float*)stats, M, K, eps);
  return (int)cudaGetLastError();
}

extern "C" int mmgt_ln_gemm(
    const void* x, const void* stats, const void* gamma, const void* beta, const void* pe,
    int M, int K, int L, int F, int nw,
    const void* w0, const void* w1, const void* w2, int n0, int n1, int n2,
    const void* b0, const void* b1, const void* b2,
    const void* r0, const void* r1, const void* r2,
    void* o0, void* o1, void* o2, int f32_mask, void* stream) {
  if (nw < 1 || nw > 3 || (K % 8) != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  GemmParams p;
  p.x = (const bf16*)x; p.stats = (const float*)stats;
  p.gamma = (const float*)gamma; p.beta = (const float*)beta; p.pe = (const float*)pe;
  p.M = M; p.K = K; p.L = L > 0 ? L : 1; p.F = F > 0 ? F : 1;
  const void* ws[3] = {w0, w1, w2};
  const int ns[3] = {n0, n1, n2};
  const void* bs[3] = {b0, b1, b2};
  const void* rs[3] = {r0, r1, r2};
  void* os[3] = {o0, o1, o2};
  int nmax = 0;
  for (int i = 0; i < 3; ++i) {
    p.w[i] = (const bf16*)ws[i]; p.n[i] = i < nw ? ns[i] : 0;
    p.bias[i] = (const float*)bs[i]; p.res[i] = (const bf16*)rs[i];
    p.out[i] = os[i]; p.out_f32[i] = (f32_mask >> i) & 1;
    if (p.n[i] > nmax) nmax = p.n[i];
  }
  dim3 grid((M + BM - 1) / BM, (nmax + BN - 1) / BN, nw);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  ln_gemm<<<grid, NT, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// K2: GroupNorm (+ SiLU) over the trailing channels of an (N, L, C) tensor,
// for Hopper (sm_90a); x bf16 or f32, gamma/beta bf16, f32 or absent.
//
// Replaces the TPU kernels mmgt_tpu/ops/norms.py:_gn_kernel (one batch row
// held in VMEM, read once and written once; pallas_call at :231) and
// _gn_kernel_blocked (two phases for rows too big for VMEM; :171):
//     y = act((x - mean_g) * rstd_g * gamma + beta),
// f32 statistics per leading row over (L, channels of group g), eps inside
// the rsqrt, the output in x's dtype.
//
// Bound on the H100: bytes (about 10 flops an element against 4 bytes of
// bf16 in and out). At the UNet's level-0 row (48, 4096, 320) one read and
// one write take 0.075 ms at 3.35 TB/s. The SiLU's exp and reciprocal run
// on the SFUs (16 a clock an SM), which at that shape is close to the
// memory time, so the apply must overlap the memory traffic.
//
// Statistics: every thread sums d = x - K_g and d^2 in f32, K_g a pilot
// value of the group (its first element in the row, the same for every
// CTA of the row); var = E[d^2] - E[d]^2, clamped at 0 as the TPU kernel,
// mean = K_g + E[d]. The pilot keeps the difference from cancelling when a
// group's mean is far from 0 (one pass, no second exchange).
//
// Two regimes, chosen by the row's shape alone (mmgt_tpu_torch/ops/
// norms.py:gn_plan, checked here):
//   * Resident (gn_resident, one launch): the Hopper counterpart of a row
//     in VMEM is a row in the shared memory of a thread block cluster. A
//     cluster of k <= 16 CTAs owns a row; CTA r holds rows [r rp, (r+1) rp)
//     of it (its slab). The slab arrives by cp.async, 16 bytes a thread
//     (each thread copies exactly the vectors it later reads, so no block
//     barrier guards the data), in kStages commit groups so that the sums
//     start on the first piece. Each CTA sums per channel, then per group,
//     and pushes its partials into every CTA of the cluster by distributed
//     shared memory (st.async, completing on the receiver's mbarrier; two
//     gather buffers for alternate rows, so no cluster barrier stands
//     between rows). Each CTA adds the k slots in rank order, so every CTA
//     holds the same statistics and every run gives the same bits. It then
//     applies the affine (+ SiLU) from shared memory and writes 16-byte
//     vectors. The grid has
//     as many clusters as the card holds at once; each walks rows, and a
//     thread issues the copy of its next row's vector into a slot as soon
//     as it has written the current row's, so the next row's loads overlap
//     this row's stores even at one CTA an SM. x is read from device memory
//     once and written once.
//   * Streaming (gn_stream_stats + gn_stream_apply, two launches): rows
//     larger than a cluster's shared memory (the up blocks' concatenated
//     inputs, the VAE at 512^2). Pass 1: each CTA of a (split, row) grid
//     sums d and d^2 over its rows and writes per-(row, split, group)
//     partials to an f32 workspace. Pass 2 sums a row's partials in its
//     prologue, in split order (no statistics launch, no atomics), then
//     applies. x is read twice, as _gn_kernel_blocked.
//
// In both regimes a thread owns one 16-byte column of the row (8 bf16 or
// 4 f32 channels) and walks the rows `lanes` apart (threads = lanes x
// C / vector), so its channels' pilot, mean, scale and shift sit in
// registers: no per-element gather of the statistics. Sums go per channel
// first and then per group, in a fixed order, so a vector that straddles
// groups (group sizes 3, 10, 30) is summed right.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cluster_arrive;
using hopper::cluster_rank;
using hopper::cluster_wait;
using hopper::map_rank;
using hopper::mbar_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using mma_tiles::smem_u32;

constexpr int kMaxSmem = 232448;  // 227 KB a block on the H100
constexpr int kMaxCluster = 16;   // non-portable cluster size limit
constexpr int kStages = 4;        // cp.async commit groups of a resident slab
static_assert(kStages == 4, "gn_resident's waits are written out for four groups");
constexpr int kMaxThreads = 1024;

// ------------------------------------------------ cluster and cp.async
// a float into another CTA's shared memory (cluster addresses), counted
// as 4 bytes on that CTA's mbarrier
__device__ __forceinline__ void st_async(uint32_t remote, float v, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(remote),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies of all but the newest N commit groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------- 16-byte vectors
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
};
template <>
struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(v);
  else return v;
}

// gamma / beta in their own dtype: kind 0 absent (the default), 1 bf16, 2 f32
__device__ __forceinline__ float param(const void* p, int kind, int ch, float dflt) {
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[ch]);
  if (kind == 2) return static_cast<const float*>(p)[ch];
  return dflt;
}

// v * sigmoid(v): ex2 and reciprocal on the SFUs (a few f32 ulps)
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// The pilots of a thread's channels E j .. E j + E - 1: the first element
// of each channel's group in row xrow.
template <typename T, int E>
__device__ __forceinline__ void load_pilots(const T* xrow, int j, int gs, float* kp) {
#pragma unroll
  for (int e = 0; e < E; ++e) kp[e] = to_f32(xrow[((j * E + e) / gs) * gs]);
}

// d = x - pilot and d^2 of one vector, added to the thread's sums
template <typename T>
__device__ __forceinline__ void add_vec(const uint4& u, const float* kp, float* s1, float* s2) {
  constexpr int E = Vec<T>::E;
  float v[E];
  Vec<T>::unpack(u, v);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float d = v[e] - kp[e];
    s1[e] += d;
    s2[e] = fmaf(d, d, s2[e]);
  }
}

// (x - mean) * scale + shift (+ SiLU) of one vector
template <typename T, bool ACT>
__device__ __forceinline__ uint4 apply_vec(const uint4& u, const float* mu, const float* sc,
                                           const float* sh) {
  constexpr int E = Vec<T>::E;
  float v[E];
  Vec<T>::unpack(u, v);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = fmaf(v[e] - mu[e], sc[e], sh[e]);
    if constexpr (ACT) v[e] = silu(v[e]);
  }
  return Vec<T>::pack(v);
}

// Per-group totals of the threads' per-channel sums acc (thread t holds
// channels E (t % V) .. of row lane t / V) into gout[0:G]. buf (lanes x C)
// and chs (C) are scratch. Fixed order: the lanes of a channel, then the
// channels of a group.
template <int E>
__device__ __forceinline__ void reduce_to_groups(const float* acc, float* buf, float* chs,
                                                 float* gout, int c, int lanes, int gs, int G) {
  const int V = c / E, t = threadIdx.x;
  float* mine = buf + (t / V) * c + (t % V) * E;
#pragma unroll
  for (int e = 0; e < E; ++e) mine[e] = acc[e];
  __syncthreads();
  for (int ch = t; ch < c; ch += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < lanes; ++r) s += buf[(size_t)r * c + ch];
    chs[ch] = s;
  }
  __syncthreads();
  for (int g = t; g < G; g += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < gs; ++q) s += chs[g * gs + q];
    gout[g] = s;
  }
  __syncthreads();
}

__host__ __device__ constexpr size_t align_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// shared-memory layout of a resident CTA: the slab (rp rows), buf (lanes x
// C), chs (C), part (2 G: this slab's group sums of d and d^2), stat (2 G:
// mean and rstd), pil (G: the groups' pilots), gat (2 x k x 2 G: the
// cluster's partials, pushed by each CTA, for alternate rows), then two
// mbarriers (one for each half of gat)
__host__ __device__ inline size_t resident_floats_off(int rp, int c, int esize) {
  return align_up((size_t)rp * c * esize, 128);
}
__host__ __device__ inline size_t resident_bar_off(int rp, int c, int esize, int lanes, int G, int k) {
  return align_up(resident_floats_off(rp, c, esize) + 4 * ((size_t)lanes * c + c + (5 + 4 * k) * G), 8);
}
__host__ __device__ inline size_t resident_smem(int rp, int c, int esize, int lanes, int G, int k) {
  return resident_bar_off(rp, c, esize, lanes, G, k) + 16;
}
// pass 1 of the streaming regime: buf, chs, part
__host__ __device__ inline size_t stream_smem(int c, int lanes, int G) {
  return 4 * ((size_t)lanes * c + c + 2 * G);
}

// ------------------------------------------------------------- resident
// Grid (k, clusters): cluster q walks rows q, q + clusters, ...
template <typename T, bool ACT>
__global__ void __launch_bounds__(kMaxThreads) gn_resident(
    const T* __restrict__ x, const void* __restrict__ w, int wk, const void* __restrict__ b,
    int bk, T* __restrict__ y, int N, int l, int c, int G, float eps, int rp) {
  constexpr int E = Vec<T>::E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = gridDim.x;
  const uint32_t rank = cluster_rank();
  const int V = c / E, lanes = blockDim.x / V, gs = c / G;
  const int j = threadIdx.x % V, lane = threadIdx.x / V;
  const int r0 = min(l, (int)rank * rp), rows = min(l, r0 + rp) - r0;
  T* slab = reinterpret_cast<T*>(smem) + j * E;  // this thread's column of the slab
  float* buf = reinterpret_cast<float*>(smem + resident_floats_off(rp, c, sizeof(T)));
  float* chs = buf + (size_t)lanes * c;
  float* part = chs + c;
  float* stat = part + 2 * G;
  float* pil = stat + 2 * G;
  float* gat = pil + G;
  const uint32_t gbar = smem_u32(smem + resident_bar_off(rp, c, sizeof(T), lanes, G, k));
  const int srows = (rp + kStages - 1) / kStages;
  const float total = (float)((double)l * gs);
  float wv[E], bv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    wv[e] = param(w, wk, j * E + e, 1.f);
    bv[e] = param(b, bk, j * E + e, 0.f);
  }
  // this thread's vectors of piece s of row nn: rows a + lane, a + lane +
  // lanes, ... < e of the slab
  auto copy_piece = [&](int nn, int s) {
    const int a = min(rows, s * srows), e = min(rows, a + srows);
    const T* src = x + ((size_t)nn * l + r0) * c + j * E;
    for (int r = a + lane; r < e; r += lanes) cp_async16(slab + (size_t)r * c, src + (size_t)r * c);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) copy_piece(blockIdx.y, s);
  if (threadIdx.x == 0) {
    mbar_init(gbar, 1);
    mbar_init(gbar + 8, 1);
    mbar_fence_init();
  }
  cluster_arrive();  // every CTA's mbarriers are initialised before any push
  cluster_wait();

  for (int nn = blockIdx.y, it = 0; nn < N; nn += gridDim.y, ++it) {
    const int half = it & 1;  // rows alternate between the two halves of gat
    const uint32_t bar = gbar + 8 * half;
    const T* xrow = x + (size_t)nn * l * c;
    float kp[E], s1[E], s2[E];
    load_pilots<T, E>(xrow, j, gs, kp);
    for (int g = threadIdx.x; g < G; g += blockDim.x) pil[g] = to_f32(xrow[g * gs]);
    // this row's gather completes when all k CTAs' partials have landed
    if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)(2 * G * k * sizeof(float)));
#pragma unroll
    for (int e = 0; e < E; ++e) s1[e] = s2[e] = 0.f;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {  // sums, piece by piece as the copies land
      if (s == 0) cp_async_wait<kStages - 1>();
      else if (s == 1) cp_async_wait<kStages - 2>();
      else if (s == 2) cp_async_wait<kStages - 3>();
      else cp_async_wait<0>();
      const int a = min(rows, s * srows), e = min(rows, a + srows);
      for (int r = a + lane; r < e; r += lanes)
        add_vec<T>(*reinterpret_cast<const uint4*>(slab + (size_t)r * c), kp, s1, s2);
    }
    reduce_to_groups<E>(s1, buf, chs, part, c, lanes, gs, G);
    reduce_to_groups<E>(s2, buf, chs, part + G, c, lanes, gs, G);

    // exchange: each CTA pushes its partials into slot `rank` of every
    // CTA's gat half (st.async, counted on that CTA's mbarrier), then
    // waits for its own half to fill and adds the slots in rank order. No
    // cluster barrier: a CTA cannot push row it + 2 into a half before
    // every CTA has read row it's, since it first needs their row it + 1
    // partials.
    float* mine = gat + ((size_t)half * k + rank) * 2 * G;
    for (int i = threadIdx.x; i < 2 * G * k; i += blockDim.x) {
      const uint32_t dst = i / (2 * G), q = i % (2 * G);
      st_async(map_rank(smem_u32(mine + q), dst), part[q], map_rank(bar, dst));
    }
    mbar_wait(bar, (it >> 1) & 1);
    const float* rowgat = gat + (size_t)half * k * 2 * G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float a1 = 0.f, a2 = 0.f;
      for (int r = 0; r < k; ++r) {
        a1 += rowgat[r * 2 * G + g];
        a2 += rowgat[r * 2 * G + G + g];
      }
      const float m1 = a1 / total;
      stat[g] = pil[g] + m1;
      stat[G + g] = rsqrtf(fmaxf(a2 / total - m1 * m1, 0.f) + eps);
    }
    __syncthreads();

    // apply from shared memory; a slot takes the next row's vector as soon
    // as this thread has written the current one
    float mu[E], sc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int g = (j * E + e) / gs;
      mu[e] = stat[g];
      sc[e] = stat[G + g] * wv[e];
    }
    T* dst = y + ((size_t)nn * l + r0) * c + j * E;
    const int next = nn + gridDim.y;
    const T* nsrc = x + ((size_t)next * l + r0) * c + j * E;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int a = min(rows, s * srows), e = min(rows, a + srows);
      for (int r = a + lane; r < e; r += lanes) {
        T* slot = slab + (size_t)r * c;
        const uint4 out = apply_vec<T, ACT>(*reinterpret_cast<const uint4*>(slot), mu, sc, bv);
        *reinterpret_cast<uint4*>(dst + (size_t)r * c) = out;
        if (next < N) cp_async16(slot, nsrc + (size_t)r * c);
      }
      cp_async_commit();
    }
  }
  cluster_arrive();  // no CTA exits while a push to it may be in flight
  cluster_wait();
}

// ------------------------------------------------------------ streaming
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gn_stream_stats(
    const T* __restrict__ x, float* __restrict__ ws, int l, int c, int G, int rp) {
  constexpr int E = Vec<T>::E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = blockIdx.x, S = gridDim.x, n = blockIdx.y;
  const int V = c / E, lanes = blockDim.x / V, gs = c / G;
  const int j = threadIdx.x % V, lane = threadIdx.x / V;
  float* buf = reinterpret_cast<float*>(smem);
  float* chs = buf + (size_t)lanes * c;
  float* part = chs + c;
  const T* xrow = x + (size_t)n * l * c;
  const int r0 = min(l, s * rp), r1 = min(l, r0 + rp);
  float kp[E], s1[E], s2[E];
  load_pilots<T, E>(xrow, j, gs, kp);
#pragma unroll
  for (int e = 0; e < E; ++e) s1[e] = s2[e] = 0.f;
  const T* src = xrow + j * E;
  int r = r0 + lane;
  for (; r + 3 * lanes < r1; r += 4 * lanes) {  // four loads in flight a thread
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r + i * lanes) * c));
#pragma unroll
    for (int i = 0; i < 4; ++i) add_vec<T>(u[i], kp, s1, s2);
  }
  for (; r < r1; r += lanes) add_vec<T>(__ldg(reinterpret_cast<const uint4*>(src + (size_t)r * c)), kp, s1, s2);
  reduce_to_groups<E>(s1, buf, chs, part, c, lanes, gs, G);
  reduce_to_groups<E>(s2, buf, chs, part + G, c, lanes, gs, G);
  float* out = ws + ((size_t)n * S + s) * 2 * G;
  for (int g = threadIdx.x; g < 2 * G; g += blockDim.x) out[g] = part[g];
}

template <typename T, bool ACT>
__global__ void __launch_bounds__(kMaxThreads) gn_stream_apply(
    const T* __restrict__ x, const float* __restrict__ ws, const void* __restrict__ w, int wk,
    const void* __restrict__ b, int bk, T* __restrict__ y, int l, int c, int G, float eps, int rp) {
  constexpr int E = Vec<T>::E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = blockIdx.x, S = gridDim.x, n = blockIdx.y;
  const int V = c / E, lanes = blockDim.x / V, gs = c / G;
  const int j = threadIdx.x % V, lane = threadIdx.x / V;
  float* stat = reinterpret_cast<float*>(smem);  // mean, rstd
  const T* xrow = x + (size_t)n * l * c;
  const float total = (float)((double)l * gs);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {  // the row's statistics, split by split
    const float* p = ws + (size_t)n * S * 2 * G + g;
    float a1 = 0.f, a2 = 0.f;
    for (int i = 0; i < S; ++i) {
      a1 += p[(size_t)i * 2 * G];
      a2 += p[(size_t)i * 2 * G + G];
    }
    const float m1 = a1 / total;
    stat[g] = to_f32(xrow[g * gs]) + m1;
    stat[G + g] = rsqrtf(fmaxf(a2 / total - m1 * m1, 0.f) + eps);
  }
  __syncthreads();
  float mu[E], sc[E], sh[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int ch = j * E + e, g = ch / gs;
    mu[e] = stat[g];
    sc[e] = stat[G + g] * param(w, wk, ch, 1.f);
    sh[e] = param(b, bk, ch, 0.f);
  }
  const int r0 = min(l, s * rp), r1 = min(l, r0 + rp);
  const T* src = xrow + j * E;
  T* dst = y + (size_t)n * l * c + j * E;
  int r = r0 + lane;
  for (; r + 3 * lanes < r1; r += 4 * lanes) {
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r + i * lanes) * c));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(dst + (size_t)(r + i * lanes) * c) = apply_vec<T, ACT>(u[i], mu, sc, sh);
  }
  for (; r < r1; r += lanes)
    *reinterpret_cast<uint4*>(dst + (size_t)r * c) =
        apply_vec<T, ACT>(__ldg(reinterpret_cast<const uint4*>(src + (size_t)r * c)), mu, sc, sh);
}

// ----------------------------------------------------------------- host
template <typename T, bool ACT>
cudaError_t prepare_resident() {
  static cudaError_t e = [] {
    cudaError_t r = cudaFuncSetAttribute(gn_resident<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (r != cudaSuccess) return r;
    return cudaFuncSetAttribute(gn_resident<T, ACT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return e;
}

cudaLaunchConfig_t resident_config(int k, int clusters, int threads, int smem, cudaStream_t st,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool ACT>
int run(const void* x, const void* w, int wk, const void* b, int bk, void* y, void* ws, int n,
        int l, int c, int G, float eps, int regime, int k, int threads, int rp, int smem,
        int clusters, cudaStream_t st) {
  constexpr int E = Vec<T>::E;
  const int V = c / E;
  // the plan's threads: whole 16-byte columns, as many row lanes as fit 512
  // threads (at least one)
  if (threads != V * (V >= 512 ? 1 : 512 / V) || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int lanes = threads / V;
  if (regime == 0) {
    if (k < 1 || k > kMaxCluster || rp != (l + k - 1) / k || clusters < 1 || clusters > n ||
        (size_t)smem != resident_smem(rp, c, sizeof(T), lanes, G, k) || smem > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = prepare_resident<T, ACT>();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = resident_config(k, clusters, threads, smem, st, &attr);
    e = cudaLaunchKernelEx(&cfg, gn_resident<T, ACT>, (const T*)x, w, wk, b, bk, (T*)y, n, l, c,
                           G, eps, rp);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (regime != 1 || k < 1 || k > 65535 || rp != (l + k - 1) / k || ws == nullptr ||
      (size_t)smem != stream_smem(c, lanes, G) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static cudaError_t attr = [] {
    cudaError_t r = cudaFuncSetAttribute(gn_stream_stats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (r != cudaSuccess) return r;
    return cudaFuncSetAttribute(gn_stream_apply<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(k, n);
  gn_stream_stats<T><<<grid, threads, smem, st>>>((const T*)x, (float*)ws, l, c, G, rp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_stream_apply<T, ACT><<<grid, threads, 8 * G, st>>>((const T*)x, (const float*)ws, w, wk, b,
                                                         bk, (T*)y, l, c, G, eps, rp);
  return (int)cudaGetLastError();
}

template <typename T>
int run_act(int act, const void* x, const void* w, int wk, const void* b, int bk, void* y,
            void* ws, int n, int l, int c, int G, float eps, int regime, int k, int threads,
            int rp, int smem, int clusters, cudaStream_t st) {
  if (act)
    return run<T, true>(x, w, wk, b, bk, y, ws, n, l, c, G, eps, regime, k, threads, rp, smem,
                        clusters, st);
  return run<T, false>(x, w, wk, b, bk, y, ws, n, l, c, G, eps, regime, k, threads, rp, smem,
                       clusters, st);
}

}  // namespace

extern "C" const char* mmgt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One GroupNorm call: regime 0 resident (k = cluster size, `clusters`
// persistent clusters, at most n), 1 streaming (k = splits of a row, ws =
// n x k x 2 x groups f32). (regime, k, threads, rows a CTA, smem) is the
// Python plan (ops/norms.py:gn_plan), checked here. wkind / bkind: 0
// absent, 1 bf16, 2 f32.
extern "C" int mmgt_group_norm(
    const void* x, const void* w, int wkind, const void* b, int bkind, void* y, void* ws,
    int n, int l, int c, int groups, float eps, int silu, int x_f32, int regime, int k,
    int threads, int rows, int smem, int clusters, void* stream) {
  const int esize = x_f32 ? 4 : 2;
  if (n < 1 || n > 65535 || l < 1 || groups < 1 || c % groups != 0 || (c * esize) % 16 != 0 ||
      wkind < 0 || wkind > 2 || bkind < 0 || bkind > 2 || ((uintptr_t)x % 16) != 0 ||
      ((uintptr_t)y % 16) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_f32)
    return run_act<float>(silu, x, w, wkind, b, bkind, y, ws, n, l, c, groups, eps, regime, k,
                          threads, rows, smem, clusters, st);
  return run_act<__nv_bfloat16>(silu, x, w, wkind, b, bkind, y, ws, n, l, c, groups, eps, regime,
                                k, threads, rows, smem, clusters, st);
}

// How many clusters of k resident CTAs (threads, smem bytes each) the card
// can hold at once (cudaOccupancyMaxActiveClusters, the SiLU instance; the
// other takes the same resources); 0: such a cluster cannot be scheduled.
extern "C" int mmgt_gn_max_clusters(int k, int threads, int smem, int x_f32, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = resident_config(k, 1, threads, smem, 0, &attr);
  cudaError_t e;
  if (x_f32) {
    e = prepare_resident<float, true>();
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveClusters(out, (const void*)gn_resident<float, true>, &cfg);
  } else {
    e = prepare_resident<__nv_bfloat16, true>();
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveClusters(out, (const void*)gn_resident<__nv_bfloat16, true>, &cfg);
  }
  return (int)e;
}

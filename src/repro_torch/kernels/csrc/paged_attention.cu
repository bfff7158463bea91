// K1: paged decode attention through a block table.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::
// paged_attention_pooled (the scalar-prefetch Pallas kernel, grid
// (B, Hkv, n_pages) with the online-softmax state in VMEM scratch).
//
// What it computes: for every sequence b and kv head h, the G grouped
// query heads (q pre-scaled by D**-0.5) attend over positions
// 0 .. lengths[b]-1 of the pages listed in block_table[b]; positions at
// or past lengths[b] are masked to -1e30 and the result is divided by
// max(l, 1e-30), exactly as the Pallas kernel and ref.py do.
//
// What bounds it on the H100: bytes.  Each (b, h) reads its live K and V
// rows once (page * D values per page, bf16 in the serving engine) and
// does 4*G*D flops per row, far below the ~295 flop/byte ridge of the
// card.  Design: one CTA of 128 threads per (b, h) covering all G query
// heads, so every K/V row is loaded once for the whole group (the TPU
// kernel's grouping, kept); the sequential page axis of the TPU grid
// becomes a loop inside the CTA that stops at ceil(lengths[b]/page)
// pages (masked positions contribute exactly 0, so unused block-table
// columns are never read).  The pool arrives as a strided per-layer view
// of [slots, L, 2, page, Hkv, D]: slot/row/head strides are arguments,
// so the engine never copies the view.  Scores: one warp per token row,
// lanes split D and reduce with shuffles; softmax statistics and the
// accumulator stay in fp32 (shared memory and registers).  A simple,
// correct first kernel: no split-K over pages, no TMA/wgmma.
//
// Dual-pool variant (the pinned-host NVM tier served in place; the JAX
// package gathers both pools and selects per page in XLA,
// repro/serving/engine.py::_decode_core_pinned over
// kernels/paged_attention/ops.py::paged_attention_pages).  The card can
// reach the pinned pool only through its mapped device address, so the
// kernel takes a second pool with its own strides and a per-page
// pool_sel [B, P]: each page picks its base pointer and row stride, and
// nothing else changes, so a page's attention is bit-identical whichever
// pool holds it.  Pages read from host memory cross the host link, which
// then bounds those pages instead of HBM.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;          // grouped q heads per kv head
constexpr int kMaxDPerThread = 2;  // D <= 256
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const T* __restrict__ k_pool2,
                       const T* __restrict__ v_pool2,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ pool_sel,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int Hkv, int G, int D, int page,
                       int P, long long k_ss, long long k_rs, long long k_hs,
                       long long v_ss, long long v_rs, long long v_hs,
                       long long k2_ss, long long k2_rs, long long k2_hs,
                       long long v2_ss, long long v2_rs, long long v2_hs) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [G, D]
  float* s_s = q_s + G * D;       // [G, page] scores, then probabilities
  float* alpha_s = s_s + G * page;  // [G]
  float* m_s = alpha_s + G;       // [G] running max
  float* l_s = m_s + G;           // [G] running sum

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int len = lengths[b];

  const T* qb = q + static_cast<long long>(b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = to_float(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kMaxDPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) acc[g][j] = 0.f;
  __syncthreads();

  int n_pages = (len + page - 1) / page;
  if (n_pages > P) n_pages = P;
  for (int ip = 0; ip < n_pages; ++ip) {
    const long long cell = static_cast<long long>(b) * P + ip;
    const long long slot = block_table[cell];
    // the page's own pool: tier 0, or (pool_sel = 1) the second pool
    const bool second = pool_sel != nullptr && pool_sel[cell] != 0;
    const T* kp = second ? k_pool2 + slot * k2_ss + h * k2_hs
                         : k_pool + slot * k_ss + h * k_hs;
    const T* vp = second ? v_pool2 + slot * v2_ss + h * v2_hs
                         : v_pool + slot * v_ss + h * v_hs;
    const long long krs = second ? k2_rs : k_rs;
    const long long vrs = second ? v2_rs : v_rs;
    const int live = min(page, len - ip * page);  // unmasked rows here

    // scores s[g][t] = q[g] . k[t]; one warp per row
    for (int t = warp; t < page; t += n_warps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (t < live) {
        const T* kr = kp + t * krs;
        for (int d = lane; d < D; d += 32) {
          const float kv = to_float(kr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part[g] += q_s[g * D + d] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane == 0) {
        for (int g = 0; g < G; ++g)
          s_s[g * page + t] = (t < live) ? part[g] : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics, one thread per q head
    if (tid < G) {
      const int g = tid;
      float mx = m_s[g];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, s_s[g * page + t]);
      const float alpha = expf(m_s[g] - mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(s_s[g * page + t] - mx);
        s_s[g * page + t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      alpha_s[g] = alpha;
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) {
      const int d = tid + j * blockDim.x;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][j] *= alpha_s[g];
        for (int t = 0; t < live; ++t) {
          const float vv = to_float(vp[t * vrs + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][j] += s_s[g * page + t] * vv;
        }
      }
    }
    __syncthreads();  // s_s is rewritten by the next page
  }

  T* ob = out + static_cast<long long>(b * Hkv + h) * G * D;
#pragma unroll
  for (int j = 0; j < kMaxDPerThread; ++j) {
    const int d = tid + j * blockDim.x;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) ob[g * D + d] = from_float<T>(acc[g][j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_pool2, const void* v_pool2, const void* block_table,
           const void* pool_sel, const void* lengths, void* out, int B,
           int Hkv, int G, int D, int page, int P, long long k_ss,
           long long k_rs, long long k_hs, long long v_ss, long long v_rs,
           long long v_hs, long long k2_ss, long long k2_rs,
           long long k2_hs, long long v2_ss, long long v2_rs,
           long long v2_hs, void* stream) {
  if (G < 1 || G > kMaxG || D < 1 || D > kThreads * kMaxDPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hkv == 0) return 0;
  const size_t smem = sizeof(float) * (G * D + G * page + 3 * G);
  dim3 grid(B, Hkv);
  paged_attention_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const T*>(k_pool2),
      static_cast<const T*>(v_pool2),
      static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(pool_sel),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), Hkv, G, D,
      page, P, k_ss, k_rs, k_hs, v_ss, v_rs, v_hs, k2_ss, k2_rs, k2_hs,
      v2_ss, v2_rs, v2_hs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// single pool: block_table holds tier-0 slots
#define PAGED_ATTENTION_ENTRY(NAME, T)                                      \
  EXPORT int NAME(const void* q, const void* k_pool, const void* v_pool,   \
                  const void* block_table, const void* lengths, void* out, \
                  int B, int Hkv, int G, int D, int page, int P,           \
                  long long k_ss, long long k_rs, long long k_hs,          \
                  long long v_ss, long long v_rs, long long v_hs,          \
                  void* stream) {                                          \
    return launch<T>(q, k_pool, v_pool, k_pool, v_pool, block_table,       \
                     nullptr, lengths, out, B, Hkv, G, D, page, P, k_ss,   \
                     k_rs, k_hs, v_ss, v_rs, v_hs, k_ss, k_rs, k_hs, v_ss, \
                     v_rs, v_hs, stream);                                  \
  }

// two pools: block_table holds each page's slot in its own pool and
// pool_sel [B, P] is 1 where that pool is the second one
#define PAGED_ATTENTION_DUAL_ENTRY(NAME, T)                                 \
  EXPORT int NAME(const void* q, const void* k_pool, const void* v_pool,   \
                  const void* k_pool2, const void* v_pool2,                \
                  const void* block_table, const void* pool_sel,           \
                  const void* lengths, void* out, int B, int Hkv, int G,   \
                  int D, int page, int P, long long k_ss, long long k_rs,  \
                  long long k_hs, long long v_ss, long long v_rs,          \
                  long long v_hs, long long k2_ss, long long k2_rs,        \
                  long long k2_hs, long long v2_ss, long long v2_rs,       \
                  long long v2_hs, void* stream) {                         \
    return launch<T>(q, k_pool, v_pool, k_pool2, v_pool2, block_table,     \
                     pool_sel, lengths, out, B, Hkv, G, D, page, P, k_ss,  \
                     k_rs, k_hs, v_ss, v_rs, v_hs, k2_ss, k2_rs, k2_hs,    \
                     v2_ss, v2_rs, v2_hs, stream);                         \
  }

PAGED_ATTENTION_ENTRY(paged_attention_f32, float)
PAGED_ATTENTION_ENTRY(paged_attention_bf16, __nv_bfloat16)
PAGED_ATTENTION_DUAL_ENTRY(paged_attention_dual_f32, float)
PAGED_ATTENTION_DUAL_ENTRY(paged_attention_dual_bf16, __nv_bfloat16)

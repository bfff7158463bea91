// K1 / K1d: paged attention through a block table, as two Hopper bodies.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::
// paged_attention_pooled (the scalar-prefetch Pallas kernel, grid
// (B, Hkv, n_pages) with the online-softmax state in VMEM scratch), the
// XLA dual-pool form kernels/paged_attention/ops.py::paged_attention_pages
// (K1d), and ops.py::paged_attention_prefill / _prefill_pages, which the
// JAX package computes with the decode kernel at one row per packed
// position.
//
// What both bodies compute, exactly as the Pallas kernel and ref.py do:
// for every row and kv head h, the G grouped query heads (q pre-scaled by
// D**-0.5) attend over positions 0 .. lengths[row]-1 of the pages listed
// in the row's table; later positions are masked (-1e30 for the maximum,
// probability exactly 0) and unused table columns are never read; the
// softmax statistics and the accumulator stay in float32 and the result
// is acc / max(l, 1e-30), so a row of length 0 writes zeros.  Pools are
// strided views of [slots, L, 2, page, Hkv, D] (slot/row/head strides are
// arguments); D is a multiple of 8 up to 256, G from 1 to 8.
//
// Dual pool (K1d): the pinned-host NVM tier served in place.  A second
// pool with its own strides and a per-page pool_sel: each page picks its
// base pointer and row stride and nothing else changes, so a page's
// contribution is bit-identical whichever pool holds it.  The card reaches
// pinned pages through their mapped device address, by the same cp.async
// copies as HBM pages; those bytes cross the host link, which then bounds
// them.
//
// What bounds it on the H100: bytes.  Decode reads each live K/V row once
// for the G heads of its group (4*G*D flops per row, far below the card's
// ~295 flop/byte ridge).  Prefill shares every page among the rows of a
// packed segment (4*G*D flops per (row, key)): still below the ridge at
// these sizes.
//
// 1. Decode body (paged_attention_*, paged_attention_dual_*).  The old
//    body, one CTA walking a row's pages in series, was latency-bound
//    (47x its byte bound).  Now the grid is (B, Hkv, kCluster) launched as
//    thread-block clusters of kCluster CTAs along z: CTA r of a cluster
//    takes pages ip = r, r + kCluster, ... (split-K over pages), copies
//    their (page, head) K and V tiles in blocks of 16 keys into a 2-stage
//    shared-memory ring with 16-byte cp.async (the next block in flight
//    while this one is scored), scores with all warps (8 lanes per key
//    row, 16-byte loads), reduces each head's block max and sum with warp
//    shuffles, and accumulates P.V in float32.  Rank r then combines the
//    kCluster partial (m, l, acc) through distributed shared memory, in
//    rank order, for its share of the G*D outputs.  One launch, no global
//    workspace, no atomics: graph-safe.  kCluster is a compile-time
//    constant and a row's page split depends only on its own length, so a
//    row's bits do not depend on B, on its place in the batch, or on the
//    grid.
//
// 2. Prefill body (paged_attention_prefill_*, paged_attention_prefill_
//    dual_*).  q [L, Hkv, G, D] with per-row tables [L, Pp] and lengths
//    [L].  Grid (ceil(L / 64), Hkv, z).  A packed bucket's rows of a segment
//    are consecutive and share one table row, so each CTA splits its 64
//    rows into runs of rows whose table rows (and pool_sel rows) are equal,
//    compared entry by entry here; any table is right, all-different rows
//    are runs of one.  A run's (row, head) query rows go in passes that
//    stream the run's pages once, in blocks of 16 keys through a 3-stage
//    cp.async ring, for all of the pass's rows, stopping at the pass's
//    largest causal length; the passes of a tile spread over the CTAs
//    along z.  One pool: passes of 64 query rows on G CTAs per tile (at
//    the prefill shape 128 CTAs; one CTA per tile left 100 of 132 SMs
//    idle, and the other CTAs' re-reads of a page hit L2).  Two pools: one
//    pass of up to 256 query rows per tile (128 for D > 128), so a pinned
//    page crosses the host link once per tile, not once per CTA.  A block past
//    a row's length is an exact no-op for it (max unchanged, scale 1,
//    probability 0), so a row's bits do not depend on its neighbours, its
//    offset in the bucket, L, or the pass size.
//    bf16: S = Q.K^T on tensor cores (mma.sync m16n8k16 bf16 -> f32; the
//    products are exact, only the summation order changes); P is split
//    into P_hi + P_mid + P_lo, three bf16 terms whose sum is P to 2**-27,
//    and O += P_hi.V + P_mid.V + P_lo.V in float32.  P rounded to bf16
//    alone moves a short row's output by ~1e-3, and two terms still by
//    ~2**-18 relative: near a bf16 rounding edge either flips an output
//    of size 1-4 by an ulp, past the 3e-3 check; three terms leave only
//    float32 summation differences, as the FMA body has.  Each warp owns
//    16-row m-tiles (4 warps x 1 for one pool, 8 x 2 or 8 x 1 for two);
//    P stays in registers (the accumulator layout is the A fragment); S
//    sums even and odd k-steps in two chains.
//    float32: the same structure with every product in 3xTF32 (each
//    float32 operand split into a big and a small TF32 term on the fragment
//    load, S = Q.K^T and O += P.V as small.big + big.small + big.big on
//    mma.sync m16n8k8, float32 accumulate; common.cuh).  The choice came
//    from the CPU emulation in tests/test_torch_f32_tc.py: 3xTF32 stays
//    within 3-7 % of the 1e-5 limit against a float64 reference, one TF32
//    term (what TF32 matmuls do) or two products miss it 20-120x, and bf16
//    terms hold only with three per operand and six products on m16n8k16,
//    the same tensor-core instructions with a costlier split.  A float32
//    tile takes twice the bf16 one's shared memory: the ring stays at 3
//    stages of 16 keys (166 KB at D 256).  At the float32 probe's shape
//    this body takes ~0.046 ms on the device, ~3x SDPA's float32
//    (tools/f32_lines.py on an H100): as in the bf16 body, one warp per
//    scheduler walks the key blocks in series.
//    The two bodies differ in summation order, so position p of a
//    prefill no longer equals a decode step at p bitwise (the JAX
//    docstring's promise); within tolerance it does.
//
// Both bodies walk a page in blocks of 16 keys (a block never spans two
// pages; a page of 16 is one block), so their shared memory depends on G
// and D only and every page size is taken.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxG = 8;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr int kCluster = 8;        // decode: CTAs splitting a row's pages
constexpr int kDecThreads = 128;
constexpr int kTileRows = 64;      // prefill: rows per tile
constexpr int kStages = 3;         // prefill: depth of the key-block ring
constexpr int kKeyBlock = 16;      // keys per copied and softmax block
constexpr size_t kMaxSmem = 227 * 1024 - 1024;   // dynamic, after statics

// One pool: K and V base pointers and element strides of slot, row, head.
struct Pool {
  const void* k;
  const void* v;
  long long k_ss, k_rs, k_hs, v_ss, v_rs, v_hs;
};

// Issue the copies of one key block of a (page, head) K and V tile, rows
// row0 .. row0 + kKeyBlock - 1 of the page, into shared tiles of row
// stride srow elements; block rows at or past `rows` are zero-filled,
// never read.  pool_sel picks the pool: the choice changes only the
// address.
template <typename T>
__device__ __forceinline__ void load_block(T* ks, T* vs, int srow,
                                           const Pool& p0, const Pool& p1,
                                           bool second, long long slot,
                                           int h, int row0, int D, int rows,
                                           int tid, int nthreads) {
  // field by field, so the two pools stay in registers
  const T* kp = static_cast<const T*>(second ? p1.k : p0.k) +
                slot * (second ? p1.k_ss : p0.k_ss) +
                h * (second ? p1.k_hs : p0.k_hs);
  const T* vp = static_cast<const T*>(second ? p1.v : p0.v) +
                slot * (second ? p1.v_ss : p0.v_ss) +
                h * (second ? p1.v_hs : p0.v_hs);
  const long long k_rs = second ? p1.k_rs : p0.k_rs;
  const long long v_rs = second ? p1.v_rs : p0.v_rs;
  kp += row0 * k_rs;
  vp += row0 * v_rs;
  constexpr int ept = 16 / sizeof(T);               // elements per copy
  const int cpr = D / ept;                          // copies per row
  const int n = kKeyBlock * cpr;
  for (int i = tid; i < 2 * n; i += nthreads) {
    const bool isv = i >= n;
    const int j = isv ? i - n : i;
    const int t = j / cpr;
    const int c = (j - t * cpr) * ept;
    const bool live = t < rows;
    const T* base = isv ? vp : kp;
    const T* src = live ? base + t * (isv ? v_rs : k_rs) + c : base;
    cp_async16((isv ? vs : ks) + t * srow + c, src, live);
  }
}

// The key stream of a CTA: the blocks of kKeyBlock keys of pages first,
// first + step, ... below n_pages, in order, each page up to its live rows
// (`len` - ip * page at most `page`).  issue() copies the next block into
// the next of `stages` ring stages of [K|V][kKeyBlock][srow] (one commit
// group per call, empty past the end).  Table entries come 32 pages at a
// time: lane i of every warp loads the entry of the chunk's i-th page and
// a shuffle hands each page's entry to the whole warp, so one load
// latency covers 32 pages and no copy waits on a load issued just before
// it.  start() loads the first chunk, which needs no length.  Entries past the live pages are
// read, never the pages they name.  All threads call start() and issue()
// together.
template <typename T>
struct BlockIssuer {
  T* ring;
  int stages, srow;
  const Pool& p0;
  const Pool& p1;
  const int32_t* table;           // the table row, n_cols entries
  const int32_t* sel;             // its pool_sel row, or nullptr
  int n_cols, first, step, page, h, D, tid, nthreads;
  int len = 0, n_pages = 0;       // set before the first issue()
  int ip = 0, kb = 0, u = 0;
  int chunk = 0;                  // lane 0 holds this CTA's chunk-th page
  int e_slot = 0, e_sel = 0;      // this lane's entry of the chunk

  __device__ int rows(int p) const { return min(page, len - p * page); }
  __device__ void fetch(int k) {
    chunk = k;
    const int p = first + step * (k + (tid & 31));
    e_slot = p < n_cols ? table[p] : 0;
    e_sel = p < n_cols && sel != nullptr ? sel[p] : 0;
  }
  __device__ void start() {
    ip = first;
    fetch(0);
  }
  __device__ void issue() {
    if (ip < n_pages) {
      const int k = (ip - first) / step;
      if (k >= chunk + 32) fetch(k);
      const long long slot = __shfl_sync(0xffffffffu, e_slot, k - chunk);
      const bool second = __shfl_sync(0xffffffffu, e_sel, k - chunk) != 0;
      T* ks = ring + (u % stages) * 2 * kKeyBlock * srow;
      load_block(ks, ks + kKeyBlock * srow, srow, p0, p1, second, slot, h, kb,
                 D, min(kKeyBlock, rows(ip) - kb), tid, nthreads);
      ++u;
      kb += kKeyBlock;
      if (kb >= rows(ip)) {
        kb = 0;
        ip += step;
      }
    }
    cp_async_commit();
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 8 contiguous elements (16 or 32 bytes, aligned) as float
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 -> float is exact: the high half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ============================================================================
// 1. decode: split-K over pages across a thread-block cluster
// ============================================================================

template <typename T>
constexpr size_t decode_smem(int G, int D) {
  return sizeof(T) * 4 * kKeyBlock * D +              // 2 stages of K, V
         sizeof(float) * (2 * G * D + G * kKeyBlock + 3 * kMaxG);
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_kernel(const T* __restrict__ q, Pool p0, Pool p1,
                        const int32_t* __restrict__ block_table,
                        const int32_t* __restrict__ pool_sel,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int /*B: gridDim.x*/, int Hkv,
                        int G, int D, int page, int P) {
  constexpr int kB = kKeyBlock;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);           // [2][K|V][kB][D]
  float* q_s = reinterpret_cast<float*>(ring + 4 * kB * D);     // [G][D]
  float* acc_s = q_s + G * D;                         // [G][D] for combine
  float* s_s = acc_s + G * D;                         // [G][kB]
  float* m_s = s_s + G * kB;                          // [kMaxG] each
  float* l_s = m_s + kMaxG;
  float* alpha_s = l_s + kMaxG;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int n_warps = kDecThreads / 32;
  const long long row = static_cast<long long>(b) * P;
  // this rank's first table entries are read beside the length
  BlockIssuer<T> is{ring, 2, D, p0, p1, block_table + row,
                    pool_sel != nullptr ? pool_sel + row : nullptr, P, rank,
                    kCluster, page, h, D, tid, kDecThreads};
  is.start();
  const int len = lengths[b];
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  if (n_pages > P) n_pages = P;
  is.len = len;
  is.n_pages = n_pages;

  is.issue();
  const T* qb = q + (static_cast<long long>(b) * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kDecThreads) q_s[i] = to_float(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;

  // block (ip, kb) of this rank is scored while the next one is in flight
  int ip = rank, kb = 0;
  for (int k = 0; ip < n_pages; ++k) {
    is.issue();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = ring + (k & 1) * 2 * kB * D;
    const T* vs = ks + kB * D;
    const int live = min(kB, is.rows(ip) - kb);       // >= 1 here

    // scores s[g][t] = q[g] . k[t]: a warp takes 4 key rows at a time, 8
    // lanes per row, each lane 8 contiguous elements of every 64 of D
    const int sub = lane & 7;
    for (int t0 = warp * 4; t0 < live; t0 += 4 * n_warps) {
      const int t = t0 + (lane >> 3);
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (t < live) {
        for (int e = sub * 8; e < D; e += 64) {
          float kv[8];
          load8(ks + t * D + e, kv);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              float qv[8];
              load8(q_s + g * D + e, qv);
#pragma unroll
              for (int i = 0; i < 8; ++i) part[g] += qv[i] * kv[i];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], 1);
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], 2);
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], 4);
        }
      }
      if (sub == 0 && t < live) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s_s[g * kB + t] = part[g];
      }
    }
    __syncthreads();

    // online softmax: one warp per q head, shuffles for the page max/sum
    for (int g = warp; g < G; g += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < live; t += 32) mx = fmaxf(mx, s_s[g * kB + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < live; t += 32) {
        const float p = expf(s_s[g * kB + t] - m_new);
        s_s[g * kB + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = tid + j * kDecThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][j] *= alpha_s[g];
        for (int t = 0; t < live; ++t) {
          const float vv = to_float(vs[t * D + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][j] += s_s[g * kB + t] * vv;
        }
      }
    }
    __syncthreads();      // the ring stage and s_s are rewritten next
    kb += kB;
    if (kb >= is.rows(ip)) {
      kb = 0;
      ip += kCluster;
    }
  }
  cp_async_wait<0>();

  // combine the kCluster partials, in rank order, through DSMEM
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = tid + j * kDecThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc_s[g * D + d] = acc[g][j];
    }
  }
  cluster.sync();
  T* ob = out + (static_cast<long long>(b) * Hkv + h) * G * D;
  for (int e = rank * kDecThreads + tid; e < G * D;
       e += kCluster * kDecThreads) {
    const int g = e / D;
    float mr[kCluster];
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mr[r] = *cluster.map_shared_rank(m_s + g, r);
      M = fmaxf(M, mr[r]);
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float w = expf(mr[r] - M);
      L += *cluster.map_shared_rank(l_s + g, r) * w;
      O += *cluster.map_shared_rank(acc_s + e, r) * w;
    }
    ob[e] = from_float<T>(O / fmaxf(L, 1e-30f));
  }
  cluster.sync();         // no CTA leaves while another reads its smem
}

// ============================================================================
// 2. prefill: runs of rows that share a table, pages streamed once per run
// ============================================================================

// The run split of a CTA's rows, the same in every thread: bit i of the
// returned mask is set where row t0 + i starts a run (its table row, and
// pool_sel row on the dual path, differs from the row before).
__device__ unsigned long long run_starts(const int32_t* block_table,
                                         const int32_t* pool_sel, int t0,
                                         int nrows, int Pp,
                                         unsigned int* mask_s) {
  const int tid = threadIdx.x;
  if (tid < kTileRows) {
    bool start = true;
    if (tid > 0 && tid < nrows) {
      const int32_t* a = block_table + static_cast<long long>(t0 + tid) * Pp;
      const int32_t* b = a - Pp;
      start = false;              // no early exit: the loads overlap
      for (int j = 0; j < Pp; ++j) start |= a[j] != b[j];
      if (pool_sel != nullptr) {
        const int32_t* sa = pool_sel + static_cast<long long>(t0 + tid) * Pp;
        for (int j = 0; j < Pp; ++j) start |= sa[j] != sa[j - Pp];
      }
    }
    const unsigned int bits = __ballot_sync(0xffffffffu, start && tid < nrows);
    if ((tid & 31) == 0) mask_s[tid >> 5] = bits;
  }
  __syncthreads();
  return (static_cast<unsigned long long>(mask_s[1]) << 32) | mask_s[0];
}

// The largest length among the rows of query rows [a, a + nq) of a run
// starting at tile row r0 (query row j is row r0 + j / G, head j % G).
__device__ __forceinline__ int pass_length(const int* len_s, int r0, int a,
                                           int nq, int G) {
  int mx = 0;
  for (int r = r0 + a / G; r <= r0 + (a + nq - 1) / G; ++r)
    mx = max(mx, len_s[r]);
  return mx;
}

// shared-memory row stride (elements) of the bf16 body: D padded to a
// multiple of 16 for the k-steps, plus 8 so ldmatrix rows miss each other's
// banks
__host__ __device__ __forceinline__ constexpr int bf16_stride(int D) {
  return (D + 15) / 16 * 16 + 8;
}

constexpr size_t prefill_bf16_smem(int D, int pass) {
  return 2 * static_cast<size_t>(bf16_stride(D)) *
         (pass + 2 * kStages * kKeyBlock);              // Q, the K/V ring
}

// The passes of a CTA: every run of the tile is cut into passes of `pass`
// query rows, numbered in order over the tile, and CTA z of the tile's
// gridDim.z takes the passes numbered z, z + gridDim.z, ...  `body(r0, a,
// nq)` runs query rows [a, a + nq) of the run starting at tile row r0.
template <typename Body>
__device__ __forceinline__ void for_each_pass(unsigned long long starts,
                                              int nrows, int G, int pass_rows,
                                              Body body) {
  int pass = 0;
  while (starts) {
    const int r0 = __ffsll(static_cast<long long>(starts)) - 1;
    starts &= starts - 1;
    const int r1 = starts ? __ffsll(static_cast<long long>(starts)) - 1
                          : nrows;
    const int nq_run = (r1 - r0) * G;
    for (int a = 0; a < nq_run; a += pass_rows, ++pass)
      if (pass % gridDim.z == blockIdx.z)
        body(r0, a, min(pass_rows, nq_run - a));
  }
}

// bf16 body: WARPS warps own MT m-tiles of 16 query rows each (a pass of
// WARPS * MT * 16 rows); NT n-tiles of 8 columns cover D (D <= 8 * NT).
template <int WARPS, int MT, int NT>
__global__ void __launch_bounds__(WARPS * 32, 1)
    paged_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q, Pool p0,
                              Pool p1, const int32_t* __restrict__ block_table,
                              const int32_t* __restrict__ pool_sel,
                              const int32_t* __restrict__ lengths,
                              __nv_bfloat16* __restrict__ out, int L, int Hkv,
                              int G, int D, int page, int Pp) {
  using bf = __nv_bfloat16;
  constexpr int kThreads = WARPS * 32;
  constexpr int kRows = WARPS * MT * 16;               // query rows per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int len_s[kTileRows];
  __shared__ unsigned int mask_s[2];
  const int sr = bf16_stride(D);
  const int dp = sr - 8;                               // D padded to 16
  bf* q_s = reinterpret_cast<bf*>(smem_raw);           // [kRows][sr]
  bf* ring = q_s + kRows * sr;            // [kStages][K|V][kKeyBlock][sr]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, L - t0);
  // zero padding columns and key rows once: copies never write them
  {
    const int n16 = (kRows + 2 * kStages * kKeyBlock) * sr * 2 / 16;
    for (int i = tid; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid < kTileRows) len_s[tid] = tid < nrows ? lengths[t0 + tid] : 0;
  const unsigned long long starts =
      run_starts(block_table, pool_sel, t0, nrows, Pp, mask_s);

  for_each_pass(starts, nrows, G, kRows, [&](int r0, int a, int nq) {
    const long long trow = static_cast<long long>(t0 + r0) * Pp;
    const int plen = pass_length(len_s, r0, a, nq, G);
    int n_pages = plen > 0 ? (plen + page - 1) / page : 0;
    if (n_pages > Pp) n_pages = Pp;
    // Q of the pass: query row j is (row t0 + r0 + (a + j) / G, head
    // (a + j) % G); rows past nq in a used m-tile are zero-filled
    {
      const int cpr = D / 8;
      const int rows = (nq + 15) / 16 * 16;
      for (int i = tid; i < rows * cpr; i += kThreads) {
        const int j = i / cpr;
        const int c = (i - j * cpr) * 8;
        const int qi = a + j;
        const bool live = j < nq;
        const bf* src =
            live ? q + ((static_cast<long long>(t0 + r0 + qi / G) * Hkv + h) *
                            G + qi % G) * D + c
                 : q;
        cp_async16(q_s + j * sr + c, src, live);
      }
    }
    BlockIssuer<bf> is{ring, kStages, sr, p0, p1, block_table + trow,
                       pool_sel != nullptr ? pool_sel + trow : nullptr, Pp,
                       0, 1, page, h, D, tid, kThreads, plen, n_pages};
    is.start();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) is.issue();

    // this thread: rows lane/4 and lane/4 + 8 of each of its m-tiles
    float o[MT][NT][4];
    float m[MT][2], l[MT][2];
    int len_r[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = (warp * MT + mt) * 16 + (lane >> 2) + hf * 8;
        m[mt][hf] = kNegInf;
        l[mt][hf] = 0.f;
        len_r[mt][hf] = j < nq ? len_s[r0 + (a + j) / G] : 0;
      }
    }

    // block kb of page ip, while the next kStages - 1 are in flight
    for (int u = 0, ip = 0, kb = 0; ip < n_pages; ++u) {
      is.issue();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const bf* ks = ring + (u % kStages) * 2 * kKeyBlock * sr;
      const bf* vs = ks + kKeyBlock * sr;
      {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m0 = (warp * MT + mt) * 16;
          if (m0 >= nq) continue;                        // warp-uniform
          // S = Q . K^T over this block of 16 keys, even and odd k-steps
          // in two accumulators, then summed
          float s[2][2][4] = {};
#pragma unroll
          for (int kk = 0; kk < NT / 2; ++kk) {
            if (kk * 16 >= dp) break;
            uint32_t fa[4], fb[4];
            ldsm_x4(fa, q_s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * sr +
                            kk * 16 + (lane >> 4) * 8);
            ldsm_x4(fb, ks + ((lane & 7) + (lane >> 4) * 8) * sr +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[kk & 1][0], fa, fb[0], fb[1]);
            mma_bf16(s[kk & 1][1], fa, fb[2], fb[3]);
          }
          // online softmax per row; this thread holds keys
          // kb + nt*8 + (lane&3)*2 + e of rows lane/4 (regs 0,1) and
          // lane/4 + 8 (regs 2,3)
          float p[2][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int lim = min(page, len_r[mt][hf] - ip * page);
            bool ok[2][2];
            float sv[2][2];
            float mx = kNegInf;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                sv[nt][e] = s[0][nt][hf * 2 + e] + s[1][nt][hf * 2 + e];
                ok[nt][e] = kb + nt * 8 + (lane & 3) * 2 + e < lim;
                if (ok[nt][e]) mx = fmaxf(mx, sv[nt][e]);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[mt][hf], mx);
            const float alpha = expf(m[mt][hf] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float pv = ok[nt][e] ? expf(sv[nt][e] - m_new) : 0.f;
                p[nt][hf * 2 + e] = pv;
                sum += pv;
              }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l[mt][hf] = l[mt][hf] * alpha + sum;
            m[mt][hf] = m_new;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              o[mt][nt][hf * 2] *= alpha;
              o[mt][nt][hf * 2 + 1] *= alpha;
            }
          }
          // P = P_hi + P_mid + P_lo, three bf16 terms as the A fragments
          // (accumulator layout); their sum is P to 2**-27
          uint32_t ap[3][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x0 = p[i >> 1][(i & 1) * 2];
            float x1 = p[i >> 1][(i & 1) * 2 + 1];
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              const __nv_bfloat16 b0 = __float2bfloat16(x0);
              const __nv_bfloat16 b1 = __float2bfloat16(x1);
              ap[t][i] = pack_bf16(b0, b1);
              x0 -= __bfloat162float(b0);
              x1 -= __bfloat162float(b1);
            }
          }
          // O += P_hi.V + P_mid.V + P_lo.V, 16 columns of D per ldmatrix
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            if (np * 16 >= D) break;
            uint32_t fv[4];
            ldsm_x4_trans(fv, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * sr +
                                  np * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              mma_bf16(o[mt][2 * np], ap[t], fv[0], fv[1]);
              if (np * 16 + 8 < D)
                mma_bf16(o[mt][2 * np + 1], ap[t], fv[2], fv[3]);
            }
          }
        }
      }
      __syncthreads();       // the ring stage is rewritten next
      kb += kKeyBlock;
      if (kb >= is.rows(ip)) {
        kb = 0;
        ++ip;
      }
    }
    cp_async_wait<0>();

    // out = O / max(l, 1e-30) for the pass's query rows
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = (warp * MT + mt) * 16 + (lane >> 2) + hf * 8;
        if (j < nq) {
          const int qi = a + j;
          bf* orow = out + ((static_cast<long long>(t0 + r0 + qi / G) * Hkv +
                             h) * G + qi % G) * D;
          const float den = fmaxf(l[mt][hf], 1e-30f);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int d = nt * 8 + (lane & 3) * 2;
            if (d < D)
              *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                  __floats2bfloat162_rn(o[mt][nt][hf * 2] / den,
                                        o[mt][nt][hf * 2 + 1] / den);
          }
        }
      }
    }
    __syncthreads();         // q_s and the ring are refilled next pass
  });
}

// shared-memory row stride (floats) of the float32 body: D (a multiple of
// 8, the TF32 k-step) plus 4, so the 8 rows of an ldmatrix of Q or K, and
// the keys 2t, 2t + 1 x columns g of the scalar V loads, miss each other's
// banks
__host__ __device__ __forceinline__ constexpr int f32_stride(int D) {
  return (D + 7) / 8 * 8 + 4;
}

constexpr size_t prefill_f32_smem(int D, int pass) {
  return 4 * static_cast<size_t>(f32_stride(D)) *
         (pass + 2 * kStages * kKeyBlock);              // Q, the K/V ring
}

// float32 body: the bf16 body's structure (WARPS warps of one 16-row
// m-tile each, a pass of WARPS * 16 query rows; NT n-tiles of 8 columns
// cover D) with every product in 3xTF32 (common.cuh).  Q, K and V land in
// shared memory as float32 and are split into their TF32 terms on the
// fragment load.  S = Q.K^T: ldmatrix gives the TF32 A and B fragments
// directly (a 32-bit element is a pair of b16), the big.big products and
// the two corrections in separate accumulators, even and odd k-steps apart.
// O += P.V: the accumulator layout holds keys 2t, 2t + 1 of each 8-key
// n-tile, so P is the A fragment of a k-step whose columns t, t + 4 are
// those keys, and V's B fragment reads the same keys (rows 2t, 2t + 1)
// with scalar loads (ldmatrix.trans would split 32-bit elements).
template <int WARPS, int NT>
__global__ void __launch_bounds__(WARPS * 32, 1)
    paged_prefill_f32_kernel(const float* __restrict__ q, Pool p0, Pool p1,
                             const int32_t* __restrict__ block_table,
                             const int32_t* __restrict__ pool_sel,
                             const int32_t* __restrict__ lengths,
                             float* __restrict__ out, int L, int Hkv, int G,
                             int D, int page, int Pp) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kRows = WARPS * 16;                    // query rows per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int len_s[kTileRows];
  __shared__ unsigned int mask_s[2];
  const int sr = f32_stride(D);
  float* q_s = reinterpret_cast<float*>(smem_raw);     // [kRows][sr]
  float* ring = q_s + kRows * sr;         // [kStages][K|V][kKeyBlock][sr]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, L - t0);
  if (tid < kTileRows) len_s[tid] = tid < nrows ? lengths[t0 + tid] : 0;
  const unsigned long long starts =
      run_starts(block_table, pool_sel, t0, nrows, Pp, mask_s);

  for_each_pass(starts, nrows, G, kRows, [&](int r0, int a, int nq) {
    const long long trow = static_cast<long long>(t0 + r0) * Pp;
    const int plen = pass_length(len_s, r0, a, nq, G);
    int n_pages = plen > 0 ? (plen + page - 1) / page : 0;
    if (n_pages > Pp) n_pages = Pp;
    // Q of the pass: query row j is (row t0 + r0 + (a + j) / G, head
    // (a + j) % G); rows past nq in a used m-tile are zero-filled
    {
      const int cpr = D / 4;
      const int rows = (nq + 15) / 16 * 16;
      for (int i = tid; i < rows * cpr; i += kThreads) {
        const int j = i / cpr;
        const int c = (i - j * cpr) * 4;
        const int qi = a + j;
        const bool live = j < nq;
        const float* src =
            live ? q + ((static_cast<long long>(t0 + r0 + qi / G) * Hkv + h) *
                            G + qi % G) * D + c
                 : q;
        cp_async16(q_s + j * sr + c, src, live);
      }
    }
    BlockIssuer<float> is{ring, kStages, sr, p0, p1, block_table + trow,
                          pool_sel != nullptr ? pool_sel + trow : nullptr,
                          Pp, 0, 1, page, h, D, tid, kThreads, plen,
                          n_pages};
    is.start();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) is.issue();

    // this thread: rows g and g + 8 of the warp's m-tile
    const int m0 = warp * 16;
    float o[NT][4];
    float m[2], l[2];
    int len_r[2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = m0 + g + hf * 8;
      m[hf] = kNegInf;
      l[hf] = 0.f;
      len_r[hf] = j < nq ? len_s[r0 + (a + j) / G] : 0;
    }

    // block kb of page ip, while the next kStages - 1 are in flight
    for (int u = 0, ip = 0, kb = 0; ip < n_pages; ++u) {
      is.issue();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const float* ks = ring + (u % kStages) * 2 * kKeyBlock * sr;
      const float* vs = ks + kKeyBlock * sr;
      if (m0 < nq) {                                     // warp-uniform
        // S = Q . K^T over this block of 16 keys (n-tiles 0, 1): big
        // products and corrections apart, even and odd k-steps apart
        float sb[2][2][4] = {}, sc[2][2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          if (kk * 8 >= D) break;
          uint32_t fa[4], fb[4], ab[4], as[4], bb[4], bs[4];
          ldsm_x4(fa, q_s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * sr +
                          kk * 8 + (lane >> 4) * 4);
          ldsm_x4(fb, ks + ((lane & 7) + (lane >> 4) * 8) * sr + kk * 8 +
                          ((lane >> 3) & 1) * 4);
          split_tf32(fa, ab, as);
          split_tf32(fb, bb, bs);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_tf32(sc[kk & 1][nt], as, bb[2 * nt], bb[2 * nt + 1]);
            mma_tf32(sc[kk & 1][nt], ab, bs[2 * nt], bs[2 * nt + 1]);
            mma_tf32(sb[kk & 1][nt], ab, bb[2 * nt], bb[2 * nt + 1]);
          }
        }
        // online softmax per row; this thread holds keys
        // kb + nt*8 + 2t + e of rows g (regs 0,1) and g + 8 (regs 2,3)
        float p[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int lim = min(page, len_r[hf] - ip * page);
          bool ok[2][2];
          float sv[2][2];
          float mx = kNegInf;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = hf * 2 + e;
              sv[nt][e] = (sc[0][nt][i] + sc[1][nt][i]) +
                          (sb[0][nt][i] + sb[1][nt][i]);
              ok[nt][e] = kb + nt * 8 + t * 2 + e < lim;
              if (ok[nt][e]) mx = fmaxf(mx, sv[nt][e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[hf], mx);
          const float alpha = expf(m[hf] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pv = ok[nt][e] ? expf(sv[nt][e] - m_new) : 0.f;
              p[nt][hf * 2 + e] = pv;
              sum += pv;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[hf] = l[hf] * alpha + sum;
          m[hf] = m_new;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            o[nt][hf * 2] *= alpha;
            o[nt][hf * 2 + 1] *= alpha;
          }
        }
        // O += P . V: k-step j is n-tile j of S, its columns t, t + 4 the
        // keys 8j + 2t, 8j + 2t + 1
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t pb[4], ps[4];
          split_tf32(p[j][0], pb[0], ps[0]);
          split_tf32(p[j][2], pb[1], ps[1]);
          split_tf32(p[j][1], pb[2], ps[2]);
          split_tf32(p[j][3], pb[3], ps[3]);
          const float* v0 = vs + (8 * j + 2 * t) * sr + g;
#pragma unroll
          for (int dn = 0; dn < NT; ++dn) {
            if (dn * 8 >= D) break;
            uint32_t vb0, vs0, vb1, vs1;
            split_tf32(v0[dn * 8], vb0, vs0);
            split_tf32(v0[sr + dn * 8], vb1, vs1);
            mma_3xtf32(o[dn], pb, ps, vb0, vb1, vs0, vs1);
          }
        }
      }
      __syncthreads();       // the ring stage is rewritten next
      kb += kKeyBlock;
      if (kb >= is.rows(ip)) {
        kb = 0;
        ++ip;
      }
    }
    cp_async_wait<0>();

    // out = O / max(l, 1e-30) for the pass's query rows
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = m0 + g + hf * 8;
      if (j < nq) {
        const int qi = a + j;
        float* orow = out + ((static_cast<long long>(t0 + r0 + qi / G) * Hkv +
                              h) * G + qi % G) * D;
        const float den = fmaxf(l[hf], 1e-30f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int d = nt * 8 + t * 2;
          if (d < D)
            *reinterpret_cast<float2*>(orow + d) =
                make_float2(o[nt][hf * 2] / den, o[nt][hf * 2 + 1] / den);
        }
      }
    }
    __syncthreads();         // q_s and the ring are refilled next pass
  });
}

// How a body is launched: its kernel, grid, block, dynamic shared memory
// and whether it runs as clusters of kCluster CTAs along z.  `granted` is
// the kernel's shared-memory limit raised so far.
struct Plan {
  const void* kernel;
  dim3 grid;
  int threads;
  size_t smem;
  int* granted;
  bool cluster;
};

Plan plan_of(const void* kernel, int& granted, dim3 grid, int threads,
             size_t smem, bool cluster = false) {
  return {kernel, grid, threads, smem, &granted, cluster};
}

// Every body fits the card's shared memory at the largest G and D, and
// none depends on the page size (pages stream in key blocks).
static_assert(decode_smem<float>(kMaxG, kMaxD) <= kMaxSmem, "decode smem");
static_assert(prefill_f32_smem(kMaxD, 64) <= kMaxSmem, "f32 prefill smem");
static_assert(prefill_bf16_smem(kMaxD, 128) <= kMaxSmem, "bf16 smem");
static_assert(prefill_bf16_smem(128, 256) <= kMaxSmem, "bf16 dual smem");

// The row tiles of the prefill grid
inline unsigned int tiles(int L) { return (L + kTileRows - 1) / kTileRows; }

// bf16 prefill: WARPS warps of MT 16-row m-tiles, passes of WARPS*MT*16
// query rows spread over the CTAs along z.
template <int WARPS, int MT, int NT>
Plan bf16_plan(int L, int Hkv, int G, int D) {
  constexpr int rows = WARPS * MT * 16;
  static int granted = 0;
  return plan_of((const void*)paged_prefill_bf16_kernel<WARPS, MT, NT>,
                 granted,
                 dim3(tiles(L), Hkv, (G * kTileRows + rows - 1) / rows),
                 WARPS * 32, prefill_bf16_smem(D, rows));
}

template <typename T>
Plan make_plan(bool prefill, bool dual, int B, int Hkv, int G, int D);

// decode: one cluster of kCluster CTAs per (row, kv head).  bf16 prefill:
// the single pool runs passes of 64 query rows spread over the G CTAs of a
// tile (more CTAs; the other CTAs' re-reads of a page hit L2); the dual
// pool one pass per tile of up to 256 (D <= 128) or 128 rows, so a pinned
// page crosses the host link once per tile (a re-read of mapped host
// memory crosses it again).  A row's arithmetic is the same in all.
template <>
Plan make_plan<__nv_bfloat16>(bool prefill, bool dual, int B, int Hkv,
                              int G, int D) {
  static int granted = 0;
  if (!prefill)
    return plan_of((const void*)paged_decode_kernel<__nv_bfloat16>, granted,
                   dim3(B, Hkv, kCluster), kDecThreads,
                   decode_smem<__nv_bfloat16>(G, D), true);
  if (!dual)
    return D <= 128 ? bf16_plan<4, 1, 16>(B, Hkv, G, D)
                    : bf16_plan<4, 1, 32>(B, Hkv, G, D);
  return D <= 128 ? bf16_plan<8, 2, 16>(B, Hkv, G, D)
                  : bf16_plan<8, 1, 32>(B, Hkv, G, D);
}

// float32 prefill, one pool or two: passes of 64 query rows (4 warps of
// one m-tile) over the G CTAs of a tile; the dual pool takes the same plan,
// so a row's arithmetic is the same in both.
template <int NT>
Plan f32_plan(int L, int Hkv, int G, int D) {
  static int granted = 0;
  return plan_of((const void*)paged_prefill_f32_kernel<4, NT>, granted,
                 dim3(tiles(L), Hkv, G), 4 * 32, prefill_f32_smem(D, 64));
}

template <>
Plan make_plan<float>(bool prefill, bool /*dual*/, int B, int Hkv, int G,
                      int D) {
  static int granted = 0;
  if (!prefill)
    return plan_of((const void*)paged_decode_kernel<float>, granted,
                   dim3(B, Hkv, kCluster), kDecThreads,
                   decode_smem<float>(G, D), true);
  return D <= 128 ? f32_plan<16>(B, Hkv, G, D) : f32_plan<32>(B, Hkv, G, D);
}

// Raise the plan's kernel's dynamic shared-memory limit to its need if no
// launch has yet: later launches make no API call, so a CUDA graph can
// capture them (one card per process, as the engine runs).
cudaError_t allow_smem(const Plan& pl) {
  if (pl.smem <= 48 * 1024 || static_cast<int>(pl.smem) <= *pl.granted)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem));
  if (err == cudaSuccess) *pl.granted = static_cast<int>(pl.smem);
  return err;
}

bool shape_ok(int G, int D, int page, int P) {
  return G >= 1 && G <= kMaxG && D >= 8 && D <= kMaxD && D % 8 == 0 &&
         page >= 1 && P >= 0;
}

// Both bodies: check the shapes the kernels take, then launch decode or
// prefill.
template <typename T>
int launch(bool prefill, const void* q, const void* k_pool,
           const void* v_pool, const void* k_pool2, const void* v_pool2,
           const void* block_table, const void* pool_sel,
           const void* lengths, void* out, int B, int Hkv, int G, int D,
           int page, int P, long long k_ss, long long k_rs, long long k_hs,
           long long v_ss, long long v_rs, long long v_hs, long long k2_ss,
           long long k2_rs, long long k2_hs, long long v2_ss, long long v2_rs,
           long long v2_hs, void* stream) {
  if (!shape_ok(G, D, page, P)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hkv == 0) return 0;
  Pool p0{k_pool, v_pool, k_ss, k_rs, k_hs, v_ss, v_rs, v_hs};
  Pool p1{k_pool2, v_pool2, k2_ss, k2_rs, k2_hs, v2_ss, v2_rs, v2_hs};
  const Plan pl = make_plan<T>(prefill, pool_sel != nullptr, B, Hkv, G, D);
  const cudaError_t err = allow_smem(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = pl.grid;
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (pl.cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = kCluster;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  void* args[] = {&q, &p0, &p1, &block_table, &pool_sel, &lengths, &out,
                  &B, &Hkv, &G, &D, &page, &P};
  const cudaError_t lerr = cudaLaunchKernelExC(&cfg, pl.kernel, args);
  if (lerr != cudaSuccess) return static_cast<int>(lerr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// single pool: block_table holds tier-0 slots; B rows (decode) or the
// bucket's L rows (prefill)
#define PAGED_ATTENTION_ENTRY(NAME, T, PREFILL)                             \
  EXPORT int NAME(const void* q, const void* k_pool, const void* v_pool,   \
                  const void* block_table, const void* lengths, void* out, \
                  int B, int Hkv, int G, int D, int page, int P,           \
                  long long k_ss, long long k_rs, long long k_hs,          \
                  long long v_ss, long long v_rs, long long v_hs,          \
                  void* stream) {                                          \
    return launch<T>(PREFILL, q, k_pool, v_pool, k_pool, v_pool,           \
                     block_table, nullptr, lengths, out, B, Hkv, G, D,     \
                     page, P, k_ss, k_rs, k_hs, v_ss, v_rs, v_hs, k_ss,    \
                     k_rs, k_hs, v_ss, v_rs, v_hs, stream);                \
  }

// two pools: block_table holds each page's slot in its own pool and
// pool_sel [B, P] is 1 where that pool is the second one
#define PAGED_ATTENTION_DUAL_ENTRY(NAME, T, PREFILL)                        \
  EXPORT int NAME(const void* q, const void* k_pool, const void* v_pool,   \
                  const void* k_pool2, const void* v_pool2,                \
                  const void* block_table, const void* pool_sel,           \
                  const void* lengths, void* out, int B, int Hkv, int G,   \
                  int D, int page, int P, long long k_ss, long long k_rs,  \
                  long long k_hs, long long v_ss, long long v_rs,          \
                  long long v_hs, long long k2_ss, long long k2_rs,        \
                  long long k2_hs, long long v2_ss, long long v2_rs,       \
                  long long v2_hs, void* stream) {                         \
    return launch<T>(PREFILL, q, k_pool, v_pool, k_pool2, v_pool2,         \
                     block_table, pool_sel, lengths, out, B, Hkv, G, D,    \
                     page, P, k_ss, k_rs, k_hs, v_ss, v_rs, v_hs, k2_ss,   \
                     k2_rs, k2_hs, v2_ss, v2_rs, v2_hs, stream);           \
  }

PAGED_ATTENTION_ENTRY(paged_attention_f32, float, false)
PAGED_ATTENTION_ENTRY(paged_attention_bf16, __nv_bfloat16, false)
PAGED_ATTENTION_DUAL_ENTRY(paged_attention_dual_f32, float, false)
PAGED_ATTENTION_DUAL_ENTRY(paged_attention_dual_bf16, __nv_bfloat16, false)
PAGED_ATTENTION_ENTRY(paged_attention_prefill_f32, float, true)
PAGED_ATTENTION_ENTRY(paged_attention_prefill_bf16, __nv_bfloat16, true)
PAGED_ATTENTION_DUAL_ENTRY(paged_attention_prefill_dual_f32, float, true)
PAGED_ATTENTION_DUAL_ENTRY(paged_attention_prefill_dual_bf16, __nv_bfloat16,
                           true)

// How the body for these shapes launches, for measurement: info[0..4] =
// CTAs in the grid, threads per CTA, dynamic shared memory bytes, CTAs
// resident per SM (the occupancy calculator, after the shared-memory
// limit is raised), cluster size (1 without clusters).
EXPORT int paged_attention_launch_info(int prefill, int dual, int bf16,
                                       int B, int Hkv, int G, int D,
                                       int* info) {
  if (!shape_ok(G, D, 1, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = bf16 ? make_plan<__nv_bfloat16>(prefill, dual, B, Hkv, G, D)
                       : make_plan<float>(prefill, dual, B, Hkv, G, D);
  cudaError_t err = allow_smem(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kernel,
                                                      pl.threads, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = static_cast<int>(pl.grid.x * pl.grid.y * pl.grid.z);
  info[1] = pl.threads;
  info[2] = static_cast<int>(pl.smem);
  info[3] = per_sm;
  info[4] = pl.cluster ? kCluster : 1;
  return 0;
}

// K6: fused page gather + per-page int8 quantize, and its inverse.
//
// page_gather_quant replaces repro/kernels/page_gather/page_gather.py::
// page_gather_quant_pallas (one grid step per page, the page index
// scalar-prefetched into the DMA, the whole page reduced in VMEM):
//
//   scale[i] = max(absmax(pool[idx[i]]), 1e-8) / 127
//   q[i]     = clamp(rint(pool[idx[i]] / scale[i]), -127, 127)
//
// with x the stored value widened to f32, IEEE division (never
// x * (1/scale): that moves a .5 boundary and changes q by one) and
// rintf, which rounds half to even like np.round and jnp.round, so the
// bits are the numpy host quantizer's (repro/core/tiers.py::HostPool).
// This file must not be built with --use_fast_math.
//
// dequant_gather is the port's kernel for the XLA computation
// page_gather_dequant (repro/kernels/page_gather/ref.py): out[i] =
// f32(q[idx[i]]) * scale[idx[i]], computed in f32 and written as f32 or
// rounded once to bf16 (__float2bfloat16_rn, the cast that follows the
// JAX computation).  Its pool is usually the pinned-host int8 NVM tier,
// read in place through its mapped device address.
//
// What bounds them on the H100: bytes.  A KV page at the serving config
// is 1,179,648 values: K6 reads 2.36 MB of bf16 and writes 1.18 MB of
// int8 per page; dequant_gather reads 1.18 MB (over the host link when
// the pool is pinned) and writes 2.36 MB.
//
// K6's design: one launch, each page read from its pool once.  A page
// is held by a thread-block cluster of C CTAs (up to 16, a non-portable
// size), CTA r taking the r-th slice of units of 16 values.  One thread
// of each CTA streams its slice into shared memory in kStages bulk
// copies (TMA), all in flight at once — from device memory, or from
// pinned host memory through its mapped address — and the CTA takes the
// absmax of each part as it lands (the bits of |x|: non-negative floats
// order like their bits, so the max is exact and independent of order;
// bf16 magnitudes two at a time).  The cluster combines the C partial
// maxima in rank order through distributed shared memory, so no memset,
// no atomics and no scratch tensor; then each CTA quantizes its slice
// out of shared memory, 16 int8 values per 16-byte store, and rank 0
// writes the scale.  The quantize pass sets the pace (a CTA of 32 warps
// on each SM): its division is a product with the reciprocal, rounded by
// a float addition, checked against the IEEE quotient near a rounding
// boundary (unit_quant() below: the same bits).  A slice larger than the
// shared memory keeps what fits and reads only the rest from the pool
// again (a float32 serving page: 295 KB a CTA at C = 16).  The plan (C,
// units per CTA, units held) comes from the wrapper
// (kernels/page_quant.py::launch_info, testable without a card); the
// first launch of a plan checks that the card grants its shared memory
// and runs its clusters.  Pages whose size or base is not 16-byte
// aligned take an element loop over the pool (read twice) inside the
// same cluster kernel.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // dequant_gather
constexpr int kMaxBlocksPerPage = 64;
constexpr int kQuantThreads = 1024;    // K6: one CTA a SM, 32 warps
constexpr int kUnit = 16;      // values per unit: one 16-byte int8 store
constexpr int kStages = 4;     // bulk copies a held slice arrives in
constexpr int kMaxCluster = 16;

// 16-byte vectors of T in a unit of kUnit values
template <typename T>
__host__ __device__ constexpr int unit_vecs() {
  return kUnit * static_cast<int>(sizeof(T)) / 16;
}

// clamp(rint(x / scale), -127, 127) with the IEEE division (never
// x * (1/scale) alone: that moves a .5 boundary), as an int
__device__ __forceinline__ int quant(float x, float scale) {
  return static_cast<int>(
      fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f));
}

__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

// max of |x| over a unit, as the uint32 bits of a float32 (non-negative
// floats order like their bits, so the max is exact in any order).  bf16:
// the 16-bit magnitudes, two at a time (max.u16x2), widened at the end.
__device__ __forceinline__ uint32_t unit_absmax(const uint4* u,
                                                __nv_bfloat16) {
  uint32_t m2 = 0;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 x = u[v];
    m2 = __vmaxu2(m2, x.x & 0x7fff7fffu);
    m2 = __vmaxu2(m2, x.y & 0x7fff7fffu);
    m2 = __vmaxu2(m2, x.z & 0x7fff7fffu);
    m2 = __vmaxu2(m2, x.w & 0x7fff7fffu);
  }
  return max(m2 >> 16, m2 & 0xffffu) << 16;
}
__device__ __forceinline__ uint32_t unit_absmax(const uint4* u, float) {
  uint32_t m = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 x = u[v];
    m = max(m, x.x & 0x7fffffffu);
    m = max(m, x.y & 0x7fffffffu);
    m = max(m, x.z & 0x7fffffffu);
    m = max(m, x.w & 0x7fffffffu);
  }
  return m;
}

// A unit's 16 values as float32
__device__ __forceinline__ void unit_values(const uint4* u, float (&x)[16],
                                            __nv_bfloat16) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 w = u[v];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[8 * v + 2 * i] = __uint_as_float(ws[i] << 16);
      x[8 * v + 2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void unit_values(const uint4* u, float (&x)[16],
                                            float) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 w = u[v];
    x[4 * v] = __uint_as_float(w.x);
    x[4 * v + 1] = __uint_as_float(w.y);
    x[4 * v + 2] = __uint_as_float(w.z);
    x[4 * v + 3] = __uint_as_float(w.w);
  }
}

// A unit's 16 int8 values, clamp(rint(x / scale), -127, 127) with the
// IEEE quotient's bits.  The fast path rounds y = x * inv (inv = 1/scale
// rounded), which lies within 2.3e-5 of the rounded quotient: |x| <=
// absmax makes |x / scale| <= 127.00003, so no clamp is ever active and
// both round to the same integer unless y lies within 2**-14 of a
// half-integer — then the whole unit takes quant()'s division.  y is
// rounded to nearest even by adding 1.5 * 2**23, whose low byte is then
// the int8 (two's complement) value.  On an H100 this path makes K6 1.33x
// faster than quant() for every value at 16 bf16 pages of 2.36 MB
// (tools/kernel_lines.py --k6-only on both versions), with equal bits.
template <typename T>
__device__ __forceinline__ uint4 unit_quant(const uint4* u, float scale,
                                            float inv) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2**23
  float x[16];
  unit_values(u, x, T());
  uint32_t b[16];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float y = __fmul_rn(x[i], inv);
    const float big = __fadd_rn(y, kMagic);
    const float r = __fsub_rn(big, kMagic);
    near |= fabsf(fabsf(__fsub_rn(y, r)) - 0.5f) < 0x1p-14f;
    b[i] = __float_as_uint(big);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      b[i] = static_cast<uint32_t>(quant(x[i], scale));
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = __byte_perm(__byte_perm(b[4 * j], b[4 * j + 1], 0x0040),
                       __byte_perm(b[4 * j + 2], b[4 * j + 3], 0x0040),
                       0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a stage of the held slice arrives as one bulk copy (cp.async.bulk),
// completing on its own mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// wait for phase 0 of `bar`; traps after ~2**34 cycles rather than hang
// the card on a lost transfer
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (C, k), clusters of (C, 1, 1): page blockIdx.y, slice `rank`.
// vec: units of kUnit values, `per` units a CTA, the first `held` of
// them staged in shared memory; else `per` elements a CTA, none held.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quant_cluster_kernel(const T* __restrict__ pool,
                     const int32_t* __restrict__ idx, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, long long n,
                     long long per, long long held, int vec) {
  extern __shared__ __align__(16) uint4 slice[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ uint32_t warp_max[kQuantThreads / 32];
  __shared__ uint32_t cta_max;
  __shared__ float page_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int page = blockIdx.y;
  const T* p = pool + static_cast<long long>(idx[page]) * n;
  int8_t* qp = q + static_cast<long long>(page) * n;
  const int t = threadIdx.x;
  constexpr int V = unit_vecs<T>();
  uint32_t m = 0;
  long long u0 = 0, u1 = 0, nh = 0, stage = 0;
  if (vec) {
    const long long units = n / kUnit;
    u0 = min(units, rank * per);
    u1 = min(units, u0 + per);
    nh = min(held, u1 - u0);
    stage = (nh + kStages - 1) / kStages;
    const uint4* src = reinterpret_cast<const uint4*>(p) + u0 * V;
    if (t == 0) {  // one thread issues a bulk copy a stage
      for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(bars + s));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      for (int s = 0; s < kStages; ++s) {
        const long long a = s * stage, b = min(nh, (s + 1) * stage);
        if (b > a)
          bulk_load(smem_u32(slice + a * V), src + a * V,
                    static_cast<uint32_t>((b - a) * V * 16),
                    smem_u32(bars + s));
      }
    }
    // the units past what shared memory holds, straight from the pool
    // (unrolled: several loads in flight a thread)
    const uint4* rest = reinterpret_cast<const uint4*>(p);
#pragma unroll 4
    for (long long u = u0 + nh + t; u < u1; u += kQuantThreads)
      m = max(m, unit_absmax(rest + u * V, T()));
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const long long b = min(nh, (s + 1) * stage);
      if (b > s * stage) mbar_wait0(smem_u32(bars + s));
      for (long long u = s * stage + t; u < b; u += kQuantThreads)
        m = max(m, unit_absmax(slice + u * V, T()));
    }
  } else {
    u0 = min(n, rank * per);
    u1 = min(n, u0 + per);
    for (long long i = u0 + t; i < u1; i += kQuantThreads)
      m = max(m, abs_bits(to_float(p[i])));
  }
  // the CTA's maximum, then the cluster's, read in rank order from each
  // CTA's shared memory
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  if (t < 32) {
    m = t < kQuantThreads / 32 ? warp_max[t] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (t == 0) cta_max = m;
  }
  cluster.sync();
  if (t < 32) {
    m = t < C ? *cluster.map_shared_rank(&cta_max, t) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (t == 0) {
      page_scale = __fdiv_rn(fmaxf(__uint_as_float(m), 1e-8f), 127.0f);
      if (rank == 0) scale_out[page] = page_scale;
    }
  }
  cluster_arrive();  // this CTA is done reading its peers' maxima
  __syncthreads();
  const float scale = page_scale;
  const float inv = __frcp_rn(scale);
  if (vec) {
    uint4* out = reinterpret_cast<uint4*>(qp);
    for (long long u = t; u < nh; u += kQuantThreads)
      out[u0 + u] = unit_quant<T>(slice + u * V, scale, inv);
    const uint4* rest = reinterpret_cast<const uint4*>(p);
#pragma unroll 4
    for (long long u = u0 + nh + t; u < u1; u += kQuantThreads)
      out[u] = unit_quant<T>(rest + u * V, scale, inv);
  } else {
    for (long long i = u0 + t; i < u1; i += kQuantThreads)
      qp[i] = static_cast<int8_t>(quant(to_float(p[i]), scale));
  }
  cluster_wait();  // no CTA leaves while a peer may still read its maximum
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ pool_q,
               const float* __restrict__ pool_scale,
               const int32_t* __restrict__ idx, T* __restrict__ out,
               long long n, int vec) {
  const int i = blockIdx.y;
  const long long s = idx[i];
  const int8_t* qi = pool_q + s * n;
  T* o = out + static_cast<long long>(i) * n;
  const float scale = pool_scale[s];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    // 16 int8 values in, 16 outputs out (64 or 32 bytes)
    const long long n_vec = n / 16;
    const uint4* qv = reinterpret_cast<const uint4*>(qi);
    for (long long v = start; v < n_vec; v += stride) {
      const uint4 x = qv[v];
      const int8_t* e = reinterpret_cast<const int8_t*>(&x);
      alignas(16) T vals[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        vals[j] = from_float<T>(__fmul_rn(static_cast<float>(e[j]), scale));
      uint4* ov = reinterpret_cast<uint4*>(o + v * 16);
#pragma unroll
      for (int j = 0; j < 16 * static_cast<int>(sizeof(T)) / 16; ++j)
        ov[j] = reinterpret_cast<const uint4*>(vals)[j];
    }
    done = n_vec * 16;
  }
  for (long long j = done + start; j < n; j += stride)
    o[j] = from_float<T>(__fmul_rn(static_cast<float>(qi[j]), scale));
}

dim3 page_grid(long long units, int k) {
  long long bx = (units + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerPage) bx = kMaxBlocksPerPage;
  if (bx < 1) bx = 1;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(k));
}

cudaLaunchConfig_t quant_config(int cluster, int k, size_t smem,
                                cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, k);
  cfg.blockDim = dim3(kQuantThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// At the first launch of a plan's (cluster, smem): allow non-portable
// cluster sizes, raise the quant kernel's shared-memory limit to `smem`
// (fails when smem and the kernel's static shared memory exceed what a
// block may use) and check that at least one such cluster fits on the
// card (cudaOccupancyMaxActiveClusters).  Later launches of a plan make
// no API call, so a CUDA graph can capture them (one card per process,
// as the engine runs).
template <typename T>
cudaError_t allow_cluster(int cluster, size_t smem) {
  static int granted = -1;                       // smem already raised to
  static uint32_t checked[kMaxCluster + 1] = {};  // smem + 1 seen per size
  const void* kernel = (const void*)quant_cluster_kernel<T>;
  if (static_cast<int>(smem) > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = static_cast<int>(smem);
  }
  if (checked[cluster] != static_cast<uint32_t>(smem) + 1) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = quant_config(cluster, 1, smem, nullptr, attr);
    int active = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    checked[cluster] = static_cast<uint32_t>(smem) + 1;
  }
  return cudaSuccess;
}

template <typename T>
int launch_quant(const void* pool, const void* idx, void* q, void* scale,
                 int k, long long n, int cluster, long long per,
                 long long held, int vec, cudaStream_t s) {
  // the plan covers the page: every CTA a non-empty slice, none left over
  const long long units = vec ? n / kUnit : n;
  if (cluster < 1 || cluster > kMaxCluster || per < 1 || held < 0 ||
      held > per || (!vec && held) || (vec && n % kUnit) ||
      (cluster - 1) * per >= units || cluster * per < units)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = vec ? static_cast<size_t>(held) * kUnit * sizeof(T) : 0;
  cudaError_t err = allow_cluster<T>(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = quant_config(cluster, k, smem, s, attr);
  const T* pool_t = static_cast<const T*>(pool);
  const int32_t* idx_t = static_cast<const int32_t*>(idx);
  int8_t* q_t = static_cast<int8_t*>(q);
  float* scale_t = static_cast<float*>(scale);
  err = cudaLaunchKernelEx(&cfg, quant_cluster_kernel<T>, pool_t, idx_t, q_t,
                           scale_t, n, per, held, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequant(const void* pool_q, const void* pool_scale,
                   const void* idx, void* out, int k, long long n,
                   cudaStream_t s) {
  const int vec = (n % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pool_q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid = page_grid(vec ? n / 16 : n, k);
  dequant_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(pool_q),
      static_cast<const float*>(pool_scale),
      static_cast<const int32_t*>(idx), static_cast<T*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (q[i], scale[i]) = quantize(pool[idx[i]]); pool elements are f32
// (elem_bytes 4) or bf16 (2).  The plan (clusters of `cluster` CTAs,
// `per` units a CTA, `held` of them in shared memory, units of 16 values
// when `vec`, else of one) is kernels/page_quant.py::launch_info's; the
// entry checks that it covers the page, and at its first launch that its
// shared memory is granted and its clusters fit on the card.
EXPORT int page_gather_quant(const void* pool, const void* idx, void* q,
                             void* scale, int k, long long n_elems,
                             int elem_bytes, int cluster, long long per,
                             long long held, int vec, void* stream) {
  if (k <= 0 || n_elems <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_quant<float>(pool, idx, q, scale, k, n_elems, cluster, per,
                               held, vec, s);
  if (elem_bytes == 2)
    return launch_quant<__nv_bfloat16>(pool, idx, q, scale, k, n_elems,
                                       cluster, per, held, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[i] = f32(pool_q[idx[i]]) * pool_scale[idx[i]], written as f32
// (out_bf16 0) or rounded to bf16 (out_bf16 1).
EXPORT int dequant_gather(const void* pool_q, const void* pool_scale,
                          const void* idx, void* out, int k,
                          long long n_elems, int out_bf16, void* stream) {
  if (k <= 0 || n_elems <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_dequant<__nv_bfloat16>(pool_q, pool_scale, idx, out, k,
                                         n_elems, s);
  return launch_dequant<float>(pool_q, pool_scale, idx, out, k, n_elems, s);
}

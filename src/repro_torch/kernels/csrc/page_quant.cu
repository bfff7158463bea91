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
// the pool is pinned) and writes 2.36 MB.  Design: grid.y walks the k
// pages (each block reads its own index), grid.x splits a page across up
// to 64 blocks, threads move 16-byte vectors with a grid stride.  A page
// spans many blocks, so K6's absmax is a cross-block reduction: a first
// launch takes atomicMax over the uint32 bit patterns of |x| (exact and
// independent of order: non-negative floats order like their bits), a
// second launch divides and rounds.  Pages whose size or base is not
// 16-byte aligned take an element loop.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerPage = 64;

template <typename T>
struct Vec;  // 16 bytes of T and the matching int8 vector
template <>
struct Vec<float> {
  static constexpr int n = 4;
  using Q = uint32_t;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  using Q = uint2;
};

__device__ __forceinline__ float quant(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ pool, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ amax, long long n, int vec) {
  const T* p = pool + static_cast<long long>(idx[blockIdx.y]) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t m = 0;
  long long done = 0;
  if (vec) {
    constexpr int kPer = Vec<T>::n;
    const long long n_vec = n / kPer;
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    for (long long v = start; v < n_vec; v += stride) {
      const uint4 x = pv[v];
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        m = max(m, __float_as_uint(fabsf(to_float(e[j]))));
    }
    done = n_vec * kPer;
  }
  for (long long i = done + start; i < n; i += stride)
    m = max(m, __float_as_uint(fabsf(to_float(p[i]))));
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ uint32_t part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? part[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax + blockIdx.y, m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ pool, const int32_t* __restrict__ idx,
             const uint32_t* __restrict__ amax, int8_t* __restrict__ q,
             float* __restrict__ scale_out, long long n, int vec) {
  const int i = blockIdx.y;
  const T* p = pool + static_cast<long long>(idx[i]) * n;
  int8_t* qi = q + static_cast<long long>(i) * n;
  const float scale = __fdiv_rn(fmaxf(__uint_as_float(amax[i]), 1e-8f),
                                127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[i] = scale;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    constexpr int kPer = Vec<T>::n;
    using Q = typename Vec<T>::Q;
    const long long n_vec = n / kPer;
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    Q* qv = reinterpret_cast<Q*>(qi);
    for (long long v = start; v < n_vec; v += stride) {
      const uint4 x = pv[v];
      const T* e = reinterpret_cast<const T*>(&x);
      Q out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        o[j] = static_cast<int8_t>(quant(to_float(e[j]), scale));
      qv[v] = out;
    }
    done = n_vec * kPer;
  }
  for (long long j = done + start; j < n; j += stride)
    qi[j] = static_cast<int8_t>(quant(to_float(p[j]), scale));
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

template <typename T>
int launch_quant(const void* pool, const void* idx, void* q, void* scale,
                 void* amax, int k, long long n, cudaStream_t s) {
  const long long page_bytes = n * static_cast<long long>(sizeof(T));
  const int vec = (page_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const dim3 grid = page_grid(vec ? n / Vec<T>::n : n, k);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(uint32_t) * k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(pool), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(amax), n, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(pool), static_cast<const int32_t*>(idx),
      static_cast<const uint32_t*>(amax), static_cast<int8_t*>(q),
      static_cast<float*>(scale), n, vec);
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
// (elem_bytes 4) or bf16 (2); ``amax`` is uint32 scratch [k].
EXPORT int page_gather_quant(const void* pool, const void* idx, void* q,
                             void* scale, void* amax, int k,
                             long long n_elems, int elem_bytes,
                             void* stream) {
  if (k <= 0 || n_elems <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_quant<float>(pool, idx, q, scale, amax, k, n_elems, s);
  if (elem_bytes == 2)
    return launch_quant<__nv_bfloat16>(pool, idx, q, scale, amax, k,
                                       n_elems, s);
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

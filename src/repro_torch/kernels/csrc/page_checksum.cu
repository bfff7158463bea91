// K5: per-page integrity checksum over the stored bits.
//
// Replaces repro/kernels/page_checksum/page_checksum.py::
// page_checksum_pallas (one grid step per page, the page index
// scalar-prefetched into the DMA, the whole page folded in VMEM).
//
// What it computes: for each listed slot, view the page as unsigned
// integers u[0..N) of the element width (f32 as u32, bf16 as u16, int8
// as u8) and return  sum_i u[i] * (2*i + 1)  mod 2^32  (ref.py).  Every
// weight is odd, so any single-bit flip changes the sum.
//
// What bounds it on the H100: bytes.  A KV page at the serving config is
// 2.36 MB read once for one 4-byte result, and the pool it reads is
// usually the pinned-host NVM tier, so the limit is the host link, not
// HBM.  Design: grid.y walks the k listed pages (each block reads its
// own slot, the counterpart of scalar prefetch), grid.x splits a page
// across up to 64 blocks so enough loads are in flight on the host link,
// and each thread reads 16-byte vectors with a grid stride.  Partial sums
// are native uint32 with wraparound, which is the mod-2^32 reduction:
// addition mod 2^32 is associative and commutative, so the warp
// shuffles, the shared-memory step and the final atomicAdd give the
// exact result in any order.  The pool pointer may be HBM or the mapped
// device address of pinned host memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads)
checksum_kernel(const char* __restrict__ pool,
                const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
                long long n_elems, long long page_bytes, int vec) {
  const char* p = pool + static_cast<long long>(idx[blockIdx.y]) * page_bytes;
  const U* e = reinterpret_cast<const U*>(p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  long long done = 0;
  if (vec) {
    constexpr int kPer = 16 / sizeof(U);
    const long long n_vec = n_elems / kPer;
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    for (long long v = start; v < n_vec; v += stride) {
      const uint4 x = pv[v];
      const U* u = reinterpret_cast<const U*>(&x);
      const uint32_t w0 = static_cast<uint32_t>(2 * v * kPer + 1);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        acc += static_cast<uint32_t>(u[j]) * (w0 + 2u * j);
    }
    done = n_vec * kPer;
  }
  for (long long i = done + start; i < n_elems; i += stride)
    acc += static_cast<uint32_t>(e[i]) * static_cast<uint32_t>(2 * i + 1);

  // block reduction in uint32 (wraparound is exact in any order)
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ uint32_t part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? part[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) atomicAdd(out + blockIdx.y, acc);
  }
}

}  // namespace

// out[i] = checksum(pool[idx[i]]); ``out`` must be zeroed by the caller.
EXPORT int page_checksum(const void* pool, const void* idx, void* out, int k,
                         long long page_bytes, int elem_bytes, void* stream) {
  if (k <= 0 || page_bytes <= 0) return 0;
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_elems = page_bytes / elem_bytes;
  const int vec = (page_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pool) % 16 == 0);
  const long long units = vec ? page_bytes / 16 : n_elems;
  long long bx = (units + kThreads - 1) / kThreads;
  if (bx > 64) bx = 64;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(k));
  const char* base = static_cast<const char*>(pool);
  const int32_t* ids = static_cast<const int32_t*>(idx);
  uint32_t* res = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    checksum_kernel<uint8_t><<<grid, kThreads, 0, s>>>(base, ids, res,
                                                       n_elems, page_bytes,
                                                       vec);
  else if (elem_bytes == 2)
    checksum_kernel<uint16_t><<<grid, kThreads, 0, s>>>(base, ids, res,
                                                        n_elems, page_bytes,
                                                        vec);
  else
    checksum_kernel<uint32_t><<<grid, kThreads, 0, s>>>(base, ids, res,
                                                        n_elems, page_bytes,
                                                        vec);
  return static_cast<int>(cudaGetLastError());
}

// K3: page gather / scatter, the migration engine's data mover.
//
// Replaces repro/kernels/page_gather/page_gather.py::page_gather_pallas
// (staging[i] = pool[idx[i]]) and ::page_scatter_pallas
// (pool[idx[i]] = pages[i] in place, other slots untouched), both one
// grid step per page with the page index scalar-prefetched into the DMA.
//
// What bounds it on the H100: bytes.  A KV page at the serving config is
// L * 2 * page * Hkv * D bf16 values (2.36 MB for qwen3_4b), read once
// and written once.  Design: one kernel serves both directions: grid.y
// walks the k pages (each block reads its own index, the counterpart of
// scalar prefetch), grid.x splits a page across up to 32 blocks, and
// each thread copies 16-byte vectors with a grid stride, so neighbouring
// threads touch neighbouring addresses.  Pages whose size or base is not
// 16-byte aligned fall back to a byte loop.  The scatter's pow2 padding
// repeats the last index with an identical page, so two blocks writing
// the same slot store the same bytes (a benign race).
#include "common.cuh"

namespace {

__global__ void page_copy_kernel(const char* __restrict__ src,
                                 char* __restrict__ dst,
                                 const int32_t* __restrict__ src_idx,
                                 const int32_t* __restrict__ dst_idx,
                                 long long page_bytes, int vec) {
  const int i = blockIdx.y;
  const long long s = src_idx ? src_idx[i] : i;
  const long long d = dst_idx ? dst_idx[i] : i;
  const char* sp = src + s * page_bytes;
  char* dp = dst + d * page_bytes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n_vec = page_bytes / 16;
    const uint4* sv = reinterpret_cast<const uint4*>(sp);
    uint4* dv = reinterpret_cast<uint4*>(dp);
    for (long long v = start; v < n_vec; v += stride) dv[v] = sv[v];
    done = n_vec * 16;
  }
  for (long long t = done + start; t < page_bytes; t += stride) dp[t] = sp[t];
}

int launch(const void* src, void* dst, const void* src_idx,
           const void* dst_idx, int k, long long page_bytes, void* stream) {
  if (k <= 0 || page_bytes <= 0) return 0;
  const int threads = 256;
  const int vec = (page_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  const long long units = vec ? page_bytes / 16 : page_bytes;
  long long bx = (units + threads - 1) / threads;
  if (bx > 32) bx = 32;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(k));
  page_copy_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst),
      static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(dst_idx), page_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[i] = pool[idx[i]]
EXPORT int page_gather(const void* pool, const void* idx, void* out, int k,
                       long long page_bytes, void* stream) {
  return launch(pool, out, idx, nullptr, k, page_bytes, stream);
}

// pool[idx[i]] = pages[i]
EXPORT int page_scatter(void* pool, const void* idx, const void* pages,
                        int k, long long page_bytes, void* stream) {
  return launch(pages, pool, nullptr, idx, k, page_bytes, stream);
}

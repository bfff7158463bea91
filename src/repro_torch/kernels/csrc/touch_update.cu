// K2: SysMon touch histogram for one sampling.
//
// Replaces repro/kernels/hotness_update/hotness_update.py::
// touch_update_pallas (each grid step owns a block of pages and reduces
// the whole event list against it as a [block, k] compare/select/sum),
// together with the normalisation its JAX op does around it
// (repro/kernels/hotness_update/ops.py::touch_update: ids clipped to
// [0, n_pages), invalid events weigh 0, reads and writes split by
// is_write).
//
// What it computes: for events i < k with page id = clip(ids[i], 0,
// n_pages - 1) and weights (r_i, w_i): d_reads[id] += r_i, d_writes[id]
// += w_i (duplicates add up), touched[id] = 1 when r_i + w_i > 0, every
// other entry 0.  The weights are either explicit int32 vectors r, w, or
// derived as SysMon samples them: r_i = valid_i & !write_i, w_i = valid_i
// & write_i, with valid (bool, or all true) and write (bool per event or
// one flag) read as bytes.
//
// What bounds it on the H100: launch latency and the host.  k is B*P
// block-table reads or B tail writes per decode step (hundreds of events,
// a few KB), so the bytes take nanoseconds at 3.35 TB/s.  Design: one
// launch does everything, so a sampling costs one kernel and no zero fill
// or normalisation ops.  Owner-computes, as on the TPU: each CTA owns
// kPages pages, zeroes three int32 histograms for them in shared memory,
// streams the whole event list with coalesced 16-byte loads (4 events a
// thread), counts its own pages' events with shared-memory atomicAdd
// (exact in any order; the 0 -> 1 store to touched is a benign race),
// and writes all three outputs for its range with 16-byte stores, so the
// outputs need no zeroing beforehand.  SysMon's 512 pages take one CTA;
// a larger table takes several, each reading the event list.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPages = 2048;  // pages per CTA: 3 x 8 KB of shared memory

__device__ __forceinline__ int4 load4(const int32_t* p, int i, int k,
                                      bool vec, int fill) {
  if (vec && i + 4 <= k) return *reinterpret_cast<const int4*>(p + i);
  int4 v;
  v.x = i < k ? p[i] : fill;
  v.y = i + 1 < k ? p[i + 1] : fill;
  v.z = i + 2 < k ? p[i + 2] : fill;
  v.w = i + 3 < k ? p[i + 3] : fill;
  return v;
}

__device__ __forceinline__ uchar4 load4(const uint8_t* p, int i, int k,
                                        bool vec) {
  if (vec && i + 4 <= k) return *reinterpret_cast<const uchar4*>(p + i);
  uchar4 v;
  v.x = i < k ? p[i] : 0;
  v.y = i + 1 < k ? p[i + 1] : 0;
  v.z = i + 2 < k ? p[i + 2] : 0;
  v.w = i + 3 < k ? p[i + 3] : 0;
  return v;
}

__device__ __forceinline__ void count(int32_t* h, int lo, int n, int n_pages,
                                      int id, int r, int w) {
  id = min(max(id, 0), n_pages - 1);
  const int j = id - lo;
  if (j < 0 || j >= n) return;
  if (r) atomicAdd(h + j, r);
  if (w) atomicAdd(h + kPages + j, w);
  if (r + w > 0) h[2 * kPages + j] = 1;
}

// r, w: explicit weights, or null to derive them from valid (null: all
// true) and is_write (null: every event is `write_flag`).
__global__ void __launch_bounds__(kThreads)
touch_update_kernel(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ r,
                    const int32_t* __restrict__ w,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ is_write, int write_flag,
                    int k, int n_pages, int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t h[3 * kPages];
  const int lo = blockIdx.x * kPages;
  const int n = min(kPages, n_pages - lo);
  for (int j = threadIdx.x; j < n; j += kThreads)
    h[j] = h[kPages + j] = h[2 * kPages + j] = 0;
  __syncthreads();

  const auto aligned = [](const void* p, int bytes) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = aligned(ids, 16) && aligned(r, 16) && aligned(w, 16) &&
                   aligned(valid, 4) && aligned(is_write, 4);
  for (int i = 4 * threadIdx.x; i < k; i += 4 * kThreads) {
    const int4 id = load4(ids, i, k, vec, 0);
    int rr[4], ww[4];
    if (r != nullptr) {
      const int4 a = load4(r, i, k, vec, 0), b = load4(w, i, k, vec, 0);
      rr[0] = a.x; rr[1] = a.y; rr[2] = a.z; rr[3] = a.w;
      ww[0] = b.x; ww[1] = b.y; ww[2] = b.z; ww[3] = b.w;
    } else {
      uchar4 ok = make_uchar4(1, 1, 1, 1);
      uchar4 wr = make_uchar4(write_flag, write_flag, write_flag,
                              write_flag);
      if (valid != nullptr) ok = load4(valid, i, k, vec);
      if (is_write != nullptr) wr = load4(is_write, i, k, vec);
      const uint8_t oks[4] = {ok.x, ok.y, ok.z, ok.w};
      const uint8_t wrs[4] = {wr.x, wr.y, wr.z, wr.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rr[e] = oks[e] && !wrs[e];
        ww[e] = oks[e] && wrs[e];
      }
    }
    const int ids4[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i + e < k) count(h, lo, n, n_pages, ids4[e], rr[e], ww[e]);
  }
  __syncthreads();

  // each output row is out + c * n_pages; 16-byte stores where aligned
  for (int c = 0; c < 3; ++c) {
    int32_t* dst = out + static_cast<long long>(c) * n_pages + lo;
    const int32_t* src = h + c * kPages;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 && n % 4 == 0) {
      for (int j = 4 * threadIdx.x; j < n; j += 4 * kThreads)
        *reinterpret_cast<int4*>(dst + j) =
            *reinterpret_cast<const int4*>(src + j);
    } else {
      for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = src[j];
    }
  }
}

}  // namespace

EXPORT int touch_update(const void* ids, const void* r, const void* w,
                        const void* valid, const void* is_write,
                        int write_flag, int k, int n_pages, void* out,
                        void* stream) {
  if (k <= 0 || n_pages <= 0) return 0;
  const int blocks = (n_pages + kPages - 1) / kPages;
  touch_update_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(w), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(is_write), write_flag, k, n_pages,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

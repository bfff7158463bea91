// K2: SysMon touch histogram for one sampling.
//
// Replaces repro/kernels/hotness_update/hotness_update.py::
// touch_update_pallas (each grid step owns a block of pages and reduces
// the whole event list against it as a [block, k] compare/select/sum).
//
// What it computes: for events i < k with in-bounds page ids[i] and 0/1
// weights r[i], w[i]: d_reads[ids[i]] += r[i], d_writes[ids[i]] += w[i]
// (duplicates add up), touched[ids[i]] = 1 when r[i] + w[i] > 0.  The
// outputs arrive zeroed.
//
// What bounds it on the H100: launch latency.  k is B*P block-table reads
// or B tail writes per decode step (hundreds of events, a few KB), so the
// bytes take nanoseconds at 3.35 TB/s.  Design: the TPU needed the
// owner-computes [block, k] sweep because its grid steps cannot scatter
// safely; on the card each event is one thread doing integer atomicAdd,
// which is exact in any order, and the 0 -> 1 store to touched is a
// benign race (every writer stores 1).
#include "common.cuh"

namespace {

__global__ void touch_update_kernel(const int32_t* __restrict__ ids,
                                    const int32_t* __restrict__ r,
                                    const int32_t* __restrict__ w, int k,
                                    int32_t* d_reads, int32_t* d_writes,
                                    int32_t* touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int id = ids[i];
  const int ri = r[i];
  const int wi = w[i];
  if (ri) atomicAdd(d_reads + id, ri);
  if (wi) atomicAdd(d_writes + id, wi);
  if (ri + wi > 0) touched[id] = 1;
}

}  // namespace

EXPORT int touch_update(const void* ids, const void* r, const void* w, int k,
                        void* d_reads, void* d_writes, void* touched,
                        void* stream) {
  if (k <= 0) return 0;
  const int threads = 256;
  const int blocks = (k + threads - 1) / threads;
  touch_update_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(w), k, static_cast<int32_t*>(d_reads),
      static_cast<int32_t*>(d_writes), static_cast<int32_t*>(touched));
  return static_cast<int>(cudaGetLastError());
}

// K4: NVM wear-counter scatter-add.
//
// Replaces repro/kernels/wear_update/wear_update.py::wear_update_pallas
// (each grid step owns a block of counters and reduces the whole event
// list against it).
//
// What it computes: wear[ids[i]] += amount[i] for i < k, in place; ids
// are in bounds, duplicates add up and zero-amount padding is a no-op.
//
// What bounds it on the H100: launch latency.  The event list is one
// entry per slow-tier page written since the last flush, bucketed to a
// multiple of 128 (kilobytes).  Design: one thread per event with an
// integer atomicAdd, exact in any order; the owner-computes sweep the
// TPU needed has no purpose when the card can scatter atomically.
#include "common.cuh"

namespace {

__global__ void wear_update_kernel(int32_t* wear,
                                   const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ amount,
                                   int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int a = amount[i];
  if (a) atomicAdd(wear + ids[i], a);
}

}  // namespace

EXPORT int wear_update(void* wear, const void* ids, const void* amount, int k,
                       void* stream) {
  if (k <= 0) return 0;
  const int threads = 256;
  const int blocks = (k + threads - 1) / threads;
  wear_update_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(wear), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(amount), k);
  return static_cast<int>(cudaGetLastError());
}

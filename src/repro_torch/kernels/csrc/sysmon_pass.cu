// K7: SysMon's pass-boundary sweep.
//
// Replaces repro/kernels/hotness_update/hotness_update.py::
// sysmon_pass_pallas (blocked elementwise sweep over the page counters).
//
// What it computes, per page (paper Sec. 3.1-3.2):
//   * WD/RD/COLD from the pass counters (writes weighted by
//     write_weight against reads; an untouched page is COLD);
//   * the WD history shift  hist' = ((hist << 1) | is_wd) & window_mask;
//   * a SWAR popcount of the window;
//   * the future state WD_FREQ_H / WD_FREQ_L / UN_WD from the popcount,
//     with the K_Len suffix override (all-WD suffix -> WD_FREQ_H,
//     all-clear suffix -> UN_WD).
// Every code and threshold arrives as an argument from the port's
// core/patterns.py and core/predictor.py, so no constant is restated
// here.
//
// What bounds it on the H100: bytes (3 int32 reads and 3 int32 writes
// per page, 24 B) and, at the page counts memos runs, launch latency.
// Design: one thread per page, everything in registers, one pass over
// the counters instead of the several elementwise launches the tensor
// composition takes.
#include "common.cuh"

namespace {

struct PassParams {
  int write_weight, cold, rd, wd;
  int window_len, k_len, hi, lo;
  int un_wd, wd_freq_l, wd_freq_h;
};

__device__ __forceinline__ int popcount16(int x) {
  x = x - ((x >> 1) & 0x5555);
  x = (x & 0x3333) + ((x >> 2) & 0x3333);
  x = (x + (x >> 4)) & 0x0F0F;
  return (x + (x >> 8)) & 0x001F;
}

__global__ void sysmon_pass_kernel(const int32_t* __restrict__ reads,
                                   const int32_t* __restrict__ writes,
                                   const int32_t* __restrict__ hist,
                                   int32_t* __restrict__ wd_code,
                                   int32_t* __restrict__ new_hist,
                                   int32_t* __restrict__ future, int n,
                                   PassParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = reads[i];
  const int w = writes[i];
  const int code = (r + w) > 0 ? (p.write_weight * w >= r ? p.wd : p.rd)
                               : p.cold;
  const int mask = (1 << p.window_len) - 1;
  const int h = ((hist[i] << 1) | (code == p.wd ? 1 : 0)) & mask;
  const int ones = popcount16(h);
  int fut = ones >= p.hi ? p.wd_freq_h
                         : (ones >= p.lo ? p.wd_freq_l : p.un_wd);
  const int kmask = (1 << p.k_len) - 1;
  const int suffix = h & kmask;
  if (suffix == kmask) fut = p.wd_freq_h;
  if (suffix == 0) fut = p.un_wd;
  wd_code[i] = code;
  new_hist[i] = h;
  future[i] = fut;
}

// For measurement only, on no path: a launch of one thread that does
// nothing, the floor that K7's device time (one thread per page) is read
// against in chip_smoke.py.
__global__ void empty_kernel() {}

}  // namespace

EXPORT int launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

EXPORT int sysmon_pass(const void* reads, const void* writes,
                       const void* hist, void* wd_code, void* new_hist,
                       void* future, int n, int write_weight, int cold,
                       int rd, int wd, int window_len, int k_len, int hi,
                       int lo, int un_wd, int wd_freq_l, int wd_freq_h,
                       void* stream) {
  if (n <= 0) return 0;
  if (window_len < 1 || window_len > 16 || k_len < 1 || k_len > window_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const PassParams p{write_weight, cold, rd, wd, window_len, k_len,
                     hi, lo, un_wd, wd_freq_l, wd_freq_h};
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  sysmon_pass_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), static_cast<const int32_t*>(writes),
      static_cast<const int32_t*>(hist), static_cast<int32_t*>(wd_code),
      static_cast<int32_t*>(new_hist), static_cast<int32_t*>(future), n, p);
  return static_cast<int>(cudaGetLastError());
}

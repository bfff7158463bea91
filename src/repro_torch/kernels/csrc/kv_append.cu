// KV append of the dual-pool decode step.
//
// Replaces the four drop-mode scatters of repro/serving/engine.py::
// _decode_core_pinned (fast_pool.at[f_idx, l, 0/1, off].set(...,
// mode="drop") and pinned_pool.at[p_idx, l, 0/1, off].set(...)), which
// XLA fuses into the JAX dispatch.
//
// What it computes: for every batch row b, the new token's K and V rows
// ([Hkv * D] each) land at in-page offset off[b] of slot f_idx[b] of the
// tier-0 pool and of slot p_idx[b] of the pinned pool; an index outside
// its pool's [0, n_slots) writes nothing (the JAX "drop" rule), so the
// caller points the pool that does not hold the tail page at n_slots and
// a numeric slot collision between the two pools can never clobber a
// real write.  The pinned pool is reached through the mapped device
// address of pinned host memory.
//
// What bounds it on the H100: bytes and launch latency: 2 * B * Hkv * D
// values written per layer (a few KB).  Design: one block per batch row,
// threads over the contiguous Hkv * D row; the pools arrive as strided
// per-layer views [slots, 2, page, Hkv, D] (slot, K/V and row strides are
// arguments).
#include "common.cuh"

namespace {

template <typename T>
__global__ void kv_append_kernel(T* __restrict__ fast, T* __restrict__ pin,
                                 const int32_t* __restrict__ f_idx,
                                 const int32_t* __restrict__ p_idx,
                                 const int32_t* __restrict__ off,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, int row,
                                 int n_fast, int n_pin, long long f_ss,
                                 long long f_kvs, long long f_rs,
                                 long long p_ss, long long p_kvs,
                                 long long p_rs) {
  const int b = blockIdx.x;
  const int fi = f_idx[b];
  const int pi = p_idx[b];
  const long long o = off[b];
  const T* kb = k + static_cast<long long>(b) * row;
  const T* vb = v + static_cast<long long>(b) * row;
  T* fd = (fi >= 0 && fi < n_fast) ? fast + fi * f_ss + o * f_rs : nullptr;
  T* pd = (pi >= 0 && pi < n_pin) ? pin + pi * p_ss + o * p_rs : nullptr;
  for (int i = threadIdx.x; i < row; i += blockDim.x) {
    const T kv = kb[i];
    const T vv = vb[i];
    if (fd) {
      fd[i] = kv;
      fd[f_kvs + i] = vv;
    }
    if (pd) {
      pd[i] = kv;
      pd[p_kvs + i] = vv;
    }
  }
}

template <typename T>
int launch(void* fast, void* pin, const void* f_idx, const void* p_idx,
           const void* off, const void* k, const void* v, int B, int row,
           int n_fast, int n_pin, long long f_ss, long long f_kvs,
           long long f_rs, long long p_ss, long long p_kvs, long long p_rs,
           void* stream) {
  if (B <= 0 || row <= 0) return 0;
  const int threads = row < 256 ? ((row + 31) / 32) * 32 : 256;
  kv_append_kernel<T><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(fast), static_cast<T*>(pin),
      static_cast<const int32_t*>(f_idx), static_cast<const int32_t*>(p_idx),
      static_cast<const int32_t*>(off), static_cast<const T*>(k),
      static_cast<const T*>(v), row, n_fast, n_pin, f_ss, f_kvs, f_rs, p_ss,
      p_kvs, p_rs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KV_APPEND_ENTRY(NAME, T)                                            \
  EXPORT int NAME(void* fast, void* pin, const void* f_idx,                 \
                  const void* p_idx, const void* off, const void* k,        \
                  const void* v, int B, int row, int n_fast, int n_pin,     \
                  long long f_ss, long long f_kvs, long long f_rs,          \
                  long long p_ss, long long p_kvs, long long p_rs,          \
                  void* stream) {                                           \
    return launch<T>(fast, pin, f_idx, p_idx, off, k, v, B, row, n_fast,    \
                     n_pin, f_ss, f_kvs, f_rs, p_ss, p_kvs, p_rs, stream);  \
  }

KV_APPEND_ENTRY(kv_append_f32, float)
KV_APPEND_ENTRY(kv_append_bf16, __nv_bfloat16)

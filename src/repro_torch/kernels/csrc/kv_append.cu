// qkv_rope_append: one layer's qk-norm, RoPE, q scaling and KV append in
// one launch.
//
// Replaces what the JAX package fuses into one XLA computation inside its
// jitted dispatch: the qk-norm and RoPE of repro/models/attention.py::
// project_qkv (after its einsums), the q scaling of the paged attention
// call, and the drop-mode scatters of the new K/V rows into the page
// pools (repro/serving/engine.py::_decode_core and _decode_core_pinned:
// pool.at[idx, l, 0/1, off].set(..., mode="drop"); the same scatters in
// repro/serving/prefill.py).  Eagerly the port ran those as ~38 launches
// per layer.
//
// What it computes, for every row r (a decode batch entry or a packed
// prefill position) and head:
//
//   q_out[r, h]               = rope(norm(q[r, h], q_norm), r) * D**-0.5
//   pool[f_idx[r], 0, off[r]] = rope(norm(k[r], k_norm), r)   (and pin[p_idx])
//   pool[f_idx[r], 1, off[r]] = v[r]                          (and pin[p_idx])
//
// norm is RMSNorm over D (eps, no norm when its weight is null), rope the
// interleaved-pair rotation (2i, 2i+1) by cos/sin[r, i] (float32 tables
// from torch).  An index outside its pool's [0, n) writes nothing (the
// JAX "drop" rule): the pool that does not hold a row's page gets an
// out-of-range slot, and so do padding rows.  The second pool may be
// pinned host memory, reached through its mapped device address.
//
// Rounding is the plain composition's (layers.rms_norm -> apply_rope ->
// * D**-0.5), step for step: every step in float32, rounded to T where
// the plain version casts (after the norm, after RoPE, after the scale);
// each product and sum rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn:
// -O3 would contract x*c - y*s into an FMA); rsqrtf as torch's CUDA
// rsqrt.  The one difference is the order of the sum of squares: lane
// sums, then a xor-shuffle tree, fixed whatever R is, so a row's bits
// depend on that row only; torch's mean sums in its own order, so a
// normed value may lie one ulp of T from the plain version's.
//
// What bounds it on the H100: launch latency.  At qwen3_4b's decode
// (8 rows, 32 + 8 + 8 heads of 128) it reads ~98 KB and writes ~96 KB
// (~0.06 us at 3.35 TB/s).  Design: one warp per (row, head), four warps
// a CTA; lane l holds the pairs l, l + 32, ... of the head (a 4- or
// 8-byte load each, a warp reads a contiguous run), so a pair never
// leaves its lane; q and k heads take norm, RoPE and scale or store, v
// heads are a copy.  No shared memory, no workspace, no host sync: a
// CUDA graph can capture it.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxD = 256;
constexpr int kPairs = kMaxD / 64;  // pairs a lane holds at kMaxD

// a source tensor [R, H, D] with unit stride along D
struct Src {
  const void* p;
  long long rs, hs;  // row and head strides, in elements
};

// a pool view [slots, 2, page, Hkv, D] with each Hkv * D row contiguous,
// and the slot each row writes (out of [0, n): dropped)
struct Dst {
  void* p;
  const int32_t* idx;
  int n;
  long long ss, kvs, rs;  // slot, K/V and row strides, in elements
};

__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __bfloat162float(x.x);
  b = __bfloat162float(x.y);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  __nv_bfloat162 x;
  x.x = __float2bfloat16(a);
  x.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = x;
}
// the plain version's .to(T) and back to float32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
qkv_rope_append_kernel(Src q, Src k, Src v, const T* __restrict__ q_norm,
                       const T* __restrict__ k_norm,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, T* __restrict__ q_out,
                       Dst d0, Dst d1, const int32_t* __restrict__ off, int R,
                       int Hq, int Hkv, int D, float scale, float eps,
                       float inv_d) {
  const int lane = threadIdx.x & 31;
  const int heads = Hq + 2 * Hkv;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(R) * heads) return;  // whole warps leave
  const int r = static_cast<int>(w / heads);
  const int h = static_cast<int>(w % heads);
  const int half = D / 2;
  // role 0: a q head, 1: a k head, 2: a v head
  const int role = h < Hq ? 0 : (h < Hq + Hkv ? 1 : 2);
  const int hh = role == 0 ? h : (role == 1 ? h - Hq : h - Hq - Hkv);
  const Src s = role == 0 ? q : (role == 1 ? k : v);
  const T* src = static_cast<const T*>(s.p) + r * s.rs + hh * s.hs;

  float xe[kPairs], xo[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int j = lane + 32 * i;
    xe[i] = xo[i] = 0.f;
    if (j < half) load_pair(src + 2 * j, xe[i], xo[i]);
  }
  if (role < 2) {
    const T* wn = role == 0 ? q_norm : k_norm;
    if (wn != nullptr) {  // RMSNorm: x * rsqrt(mean(x^2) + eps) * w
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (lane + 32 * i < half) {
          ss = __fadd_rn(ss, __fmul_rn(xe[i], xe[i]));
          ss = __fadd_rn(ss, __fmul_rn(xo[i], xo[i]));
        }
      }
      // every lane ends with the same bits: each level adds the same two
      // values in both lanes of a pair
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
      const float rs = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int j = lane + 32 * i;
        if (j < half) {
          float we, wo;
          load_pair(wn + 2 * j, we, wo);
          xe[i] = round_to<T>(__fmul_rn(__fmul_rn(xe[i], rs), we));
          xo[i] = round_to<T>(__fmul_rn(__fmul_rn(xo[i], rs), wo));
        }
      }
    }
    const float* c = cos_t + static_cast<long long>(r) * half;
    const float* sn = sin_t + static_cast<long long>(r) * half;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int j = lane + 32 * i;
      if (j < half) {
        const float cj = c[j], sj = sn[j];
        const float ye = __fsub_rn(__fmul_rn(xe[i], cj), __fmul_rn(xo[i], sj));
        const float yo = __fadd_rn(__fmul_rn(xe[i], sj), __fmul_rn(xo[i], cj));
        xe[i] = round_to<T>(ye);
        xo[i] = round_to<T>(yo);
      }
    }
  }
  if (role == 0) {  // q: scaled, rounded once more, [R, Hq, D]
    T* dst = q_out + (static_cast<long long>(r) * Hq + hh) * D;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int j = lane + 32 * i;
      if (j < half)
        store_pair(dst + 2 * j, __fmul_rn(xe[i], scale),
                   __fmul_rn(xo[i], scale));
    }
    return;
  }
  const long long o = off[r];
  const int kv = role - 1;
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const Dst& d = pi == 0 ? d0 : d1;
    const int slot = d.idx[r];
    if (slot < 0 || slot >= d.n) continue;
    T* dst = static_cast<T*>(d.p) + slot * d.ss + kv * d.kvs + o * d.rs +
             static_cast<long long>(hh) * D;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int j = lane + 32 * i;
      if (j < half) store_pair(dst + 2 * j, xe[i], xo[i]);
    }
  }
}

template <typename T>
int launch(Src q, Src k, Src v, const void* q_norm, const void* k_norm,
           const void* cos_t, const void* sin_t, void* q_out, Dst d0, Dst d1,
           const void* off, int R, int Hq, int Hkv, int D, float scale,
           float eps, void* stream) {
  if (D < 2 || D > kMaxD || D % 2 || Hq < 1 || Hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const long long warps = static_cast<long long>(R) * (Hq + 2 * Hkv);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  qkv_rope_append_kernel<T><<<blocks, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      q, k, v, static_cast<const T*>(q_norm), static_cast<const T*>(k_norm),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(q_out), d0, d1, static_cast<const int32_t*>(off), R, Hq,
      Hkv, D, scale, eps, 1.0f / static_cast<float>(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [R, Hq, D], k/v [R, Hkv, D] (row and head strides given, D unit
// stride); q_norm/k_norm [D] or null; cos/sin float32 [R, D/2]; q_out
// [R, Hq, D] contiguous; the tier-0 view and the second view (the same
// view with n_pin 0 for one pool), their per-row slots and off [R].
#define QKV_ROPE_APPEND_ENTRY(NAME, T)                                        \
  EXPORT int NAME(const void* q, long long q_rs, long long q_hs,             \
                  const void* k, long long k_rs, long long k_hs,             \
                  const void* v, long long v_rs, long long v_hs,             \
                  const void* q_norm, const void* k_norm, const void* cos_t, \
                  const void* sin_t, void* q_out, void* fast,                \
                  const void* f_idx, int n_fast, long long f_ss,             \
                  long long f_kvs, long long f_rs, void* pin,                \
                  const void* p_idx, int n_pin, long long p_ss,              \
                  long long p_kvs, long long p_rs, const void* off, int R,   \
                  int Hq, int Hkv, int D, float scale, float eps,            \
                  void* stream) {                                            \
    const Dst d0{fast, static_cast<const int32_t*>(f_idx), n_fast, f_ss,     \
                 f_kvs, f_rs};                                               \
    const Dst d1{pin, static_cast<const int32_t*>(p_idx), n_pin, p_ss, p_kvs, \
                 p_rs};                                                      \
    return launch<T>(Src{q, q_rs, q_hs}, Src{k, k_rs, k_hs},                 \
                     Src{v, v_rs, v_hs}, q_norm, k_norm, cos_t, sin_t, q_out, \
                     d0, d1, off, R, Hq, Hkv, D, scale, eps, stream);        \
  }

QKV_ROPE_APPEND_ENTRY(qkv_rope_append_f32, float)
QKV_ROPE_APPEND_ENTRY(qkv_rope_append_bf16, __nv_bfloat16)

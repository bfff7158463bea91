// K8: flash attention forward (causal / sliding window / GQA).
//
// Replaces repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bhsd (grid (B*Hq, Sq/bq, Sk/bk), the k-block axis
// innermost and in order, with the online-softmax state m, l, acc in
// VMEM scratch).  It computes what that kernel computes: an online
// softmax over blocks of keys with m, l and acc in float32, keys masked
// to NEG_INF = -1e30 where k >= seq_len, where k > q (causal) and where
// q - k >= window (window > 0), and a final acc / max(l, 1e-30); q head
// h reads kv head h / G (GQA, no KV expansion).
//
// What changes from the TPU design:
// - Grid: one CTA per (q block of 64 rows, b * Hq + h), with the sweep
//   over key blocks as a loop inside the CTA.  The loop starts at the
//   window's edge and stops at the causal edge and at seq_len, which the
//   TPU grid does not; the blocks it skips are ones the TPU kernel masks
//   whole, so the result is the same.
// - Layout: q, k, v are read as the model holds them, [B, S, H, D] with
//   strides (unit stride over D), so the transposes to [B*H, S, D] that
//   the Pallas wrapper makes (ops.py:36-38) go away; out is [B, Sq, Hq, D]
//   contiguous, in q's type.
// - Head dimension: any D up to 128 (zamba2's 112), unpadded; the TPU
//   pads D to a multiple of 128 (ops.py:46-48).
// - Scaling: the model's sdpa scales q in float32 (attention.py:118-121),
//   the Pallas wrapper pre-scales q in q's type (ops.py:36).  This kernel
//   takes the scale as an argument and applies it to q in float32, as
//   sdpa does; on float32 inputs the two agree.
//
// Inside a CTA: 4 warps, each owning 16 query rows; scores S = q . k^T
// for a 64-key block with lanes over keys (k rows padded to D+1 floats so
// the lanes hit distinct banks), row max and sum by warp shuffles, P
// staged in shared memory, then acc = acc * alpha + P . V with lanes over
// D.  All of it is float32 FMA from shared memory: no wgmma, no TMA, no
// warp specialisation (later work).
//
// Bound on the H100: operations 4 * B * Hq * Sq * Sk * D (half of that
// when causal) over 989 TFLOP/s, against q, k, v read once and out
// written once over 3.35 TB/s.  At zamba2's prefill shape (B 4, S 2000,
// 32/32 heads, D 112, causal, bf16) that is ~115 GFLOP, 0.116 ms, against
// ~229 MB, 0.068 ms: operations bound it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;                         // query rows per CTA
constexpr int kBK = 64;                         // keys per block
constexpr int kRows = kBQ / kWarps;             // query rows per warp
constexpr int kKeyGroups = kBK / 32;            // keys per lane
constexpr int kMaxD = 128;
constexpr int kMaxDGroups = kMaxD / 32;         // D columns per lane
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * D + kBK * (D + 1) +
                          kBK * D + kBQ * kBK);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, int D, int seq_len,
                       int causal, int window, float scale, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh) {
  extern __shared__ float smem[];
  const int kstride = D + 1;
  float* q_s = smem;                    // [kBQ, D], scaled
  float* k_s = q_s + kBQ * D;           // [kBK, D+1]
  float* v_s = k_s + kBK * kstride;     // [kBK, D]
  float* p_s = v_s + kBK * D;           // [kBQ, kBK] probabilities

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb_ptr = k + b * k_sb + hk * k_sh;
  const T* vb_ptr = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    q_s[i] = q0 + r < Sq ? to_float(qb[(q0 + r) * q_ss + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kMaxDGroups];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxDGroups; ++g) acc[r][g] = 0.f;
  }

  // the key range any row of this CTA can see
  int k_hi = min(seq_len, Sk);
  if (causal) k_hi = min(k_hi, min(Sq, q0 + kBQ));
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1) / kBK * kBK;
  const int row_base = warp * kRows;

  for (int kb = k_lo; kb < k_hi; kb += kBK) {
    __syncthreads();                    // q_s loaded / last block consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = kb + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = to_float(kb_ptr[key * k_ss + d]);
        vv = to_float(vb_ptr[key * v_ss + d]);
      }
      k_s[j * kstride + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    float s[kRows][kKeyGroups];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeyGroups; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[kKeyGroups];
#pragma unroll
      for (int c = 0; c < kKeyGroups; ++c)
        kv[c] = k_s[(lane + 32 * c) * kstride + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = q_s[(row_base + r) * D + d];
#pragma unroll
        for (int c = 0; c < kKeyGroups; ++c) s[r][c] = fmaf(qv, kv[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row_base + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeyGroups; ++c) {
        const int key = kb + lane + 32 * c;
        bool ok = key < seq_len;
        if (causal) ok = ok && key <= qpos;
        if (window > 0) ok = ok && (qpos - key) < window;
        if (!ok) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeyGroups; ++c) {
        const float p = expf(s[r][c] - m_new);
        p_s[(row_base + r) * kBK + lane + 32 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < kMaxDGroups; ++g) acc[r][g] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < kBK; ++j) {
      float vv[kMaxDGroups];
#pragma unroll
      for (int g = 0; g < kMaxDGroups; ++g) {
        const int d = lane + 32 * g;
        vv[g] = d < D ? v_s[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_s[(row_base + r) * kBK + j];
#pragma unroll
        for (int g = 0; g < kMaxDGroups; ++g)
          acc[r][g] = fmaf(p, vv[g], acc[r][g]);
      }
    }
  }

  const long long o_ss = static_cast<long long>(Hq) * D;
  T* ob = out + static_cast<long long>(b) * Sq * o_ss + h * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row_base + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < kMaxDGroups; ++g) {
      const int d = lane + 32 * g;
      if (d < D) ob[qpos * o_ss + d] = from_float<T>(acc[r][g] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int seq_len, int causal,
           int window, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh,
           cudaStream_t stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, D,
      seq_len, causal, window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_ENTRY(NAME, T)                                                  \
  EXPORT int NAME(const void* q, const void* k, const void* v, void* out,    \
                  int B, int Sq, int Sk, int Hq, int Hkv, int D, int seq_len, \
                  int causal, int window, float scale, long long q_sb,        \
                  long long q_ss, long long q_sh, long long k_sb,             \
                  long long k_ss, long long k_sh, long long v_sb,             \
                  long long v_ss, long long v_sh, cudaStream_t stream) {      \
    return launch<T>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal,    \
                     window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, \
                     v_ss, v_sh, stream);                                     \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

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
// What changes from the TPU design, in both entries:
// - Grid: one CTA per (q block, b * Hq + h), with the sweep over key
//   blocks as a loop inside the CTA.  The loop starts at the window's
//   edge and stops at the causal edge and at seq_len, which the TPU grid
//   does not; the blocks it skips are ones the TPU kernel masks whole,
//   so the result is the same.
// - Layout: q, k, v are read as the model holds them, [B, S, H, D] with
//   strides (unit stride over D), so the transposes to [B*H, S, D] that
//   the Pallas wrapper makes (ops.py:36-38) go away; out is [B, Sq, Hq, D]
//   contiguous, in q's type.
// - Head dimension: any D up to 128 (zamba2's 112), not padded in device
//   memory; the TPU pads D to a multiple of 128 (ops.py:46-48).
// - Scaling: the model's sdpa scales q in float32 (attention.py:118-121),
//   the Pallas wrapper pre-scales q in q's type (ops.py:36).  Both entries
//   apply the scale in float32, as sdpa does, never to q in bf16.
//
// Bound on the H100: operations 4 * B * Hq * Sq * Sk * D (half of that
// when causal) over 989 TFLOP/s, against q, k, v read once and out
// written once over 3.35 TB/s.  At zamba2's prefill shape (B 4, S 2000,
// 32/32 heads, D 112, causal, bf16) that is ~115 GFLOP, 0.116 ms, against
// ~229 MB, 0.068 ms: operations bound it, so only the tensor cores can
// come near it.
//
// flash_attention_bf16 -- warpgroup MMA from TMA-loaded tiles:
// - CTA: two consumer warpgroups of 64 q rows each (128 rows per CTA)
//   and one producer warp.  The producer's lane 0 loads Q once and then
//   streams 64-key K and V tiles into a ring of kStages stages, each
//   with a full and an empty mbarrier.  No setmaxnreg: 288 threads get
//   up to 224 registers each, which the consumers need.
// - Loads: one TMA tensor map per operand over [B, S, H, D] as the model
//   holds it (dims {D, H, S, B}, the caller's strides), D in 64-column
//   boxes with 128-byte swizzle.  TMA's out-of-bounds zero fill pads D to
//   128 in shared memory and the ragged S edge, so nothing is padded or
//   copied in device memory.  The wrapper refuses what TMA
//   cannot address (D not a multiple of 8, or a base or S/H/B stride not
//   16-byte aligned).
// - S = Q.K^T: wgmma m64n64k16, both operands K-major from shared memory
//   (descriptors with 128B swizzle, stride 1024 B per 8 rows, the start
//   advanced 32 B per k-step inside the swizzle atom).
// - Softmax: S scaled in float32 by scale * log2(e) for exp2f; masks only
//   on tiles that straddle the seq_len, causal or window edge; row max by
//   quad shuffles, row sums kept per thread and reduced once at the end.
// - O += P.V: P rounded to bf16 in registers is wgmma's register A
//   operand (the m64n64 accumulator layout is the A fragment layout, two
//   accumulator pairs per 32-bit register); V from shared memory is
//   MN-major (the transpose flag bf16 allows), one m64n64k16 per 64-column
//   chunk of D; O stays in float32 registers.
// - Each GEMM is fenced, committed and waited on (wait_group 0) before
//   its registers are read or written; there is no ping-pong between
//   the warpgroups and no overlap of softmax with the next GEMM yet.
// - The grid launches the heaviest causal q blocks first (blockIdx.y
//   reversed, b * Hq + h on blockIdx.x), so the long rows do not trail.
//
// flash_attention_f32 -- the float32 FMA kernel (kept for the float32
// probes: tensor cores in float32 would be TF32): 4 warps, each owning
// 16 of 64 query rows; scores q . k^T for a 64-key block with lanes over
// keys (k rows padded to D+1 floats so the lanes hit distinct banks), row
// max and sum by warp shuffles, P staged in shared memory, then acc =
// acc * alpha + P . V with lanes over D.
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ============================================================================
// float32: FMA from shared memory
// ============================================================================

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;                         // query rows per CTA
constexpr int kBK = 64;                         // keys per block
constexpr int kRows = kBQ / kWarps;             // query rows per warp
constexpr int kKeyGroups = kBK / 32;            // keys per lane
constexpr int kMaxD = 128;
constexpr int kMaxDGroups = kMaxD / 32;         // D columns per lane

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

// ============================================================================
// bf16: wgmma from TMA-loaded tiles
// ============================================================================

namespace wg {

constexpr int kConsumers = 2;                   // warpgroups of 64 q rows
constexpr int kBQ = 64 * kConsumers;            // q rows per CTA
constexpr int kBK = 64;                         // keys per tile
constexpr int kStages = 3;                      // K/V ring depth
constexpr int kDChunks = 2;                     // 64-column boxes of D
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kRowBytes = 128;                  // 64 bf16: one swizzle row
constexpr int kQChunk = kBQ * kRowBytes;        // one 64-column box of Q
constexpr int kKVChunk = kBK * kRowBytes;       // one 64-column box of K/V
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A completion that
// never comes (a lost TMA transaction) traps after ~2**34 cycles rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads/writes across the fences.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// Keys [lo, hi) that q rows [qw, qw + 64) of one warpgroup can see.
__device__ __forceinline__ void key_range(int qw, int Sq, int Sk,
                                          int seq_len, int causal,
                                          int window, int& lo, int& hi) {
  hi = min(seq_len, Sk);
  if (causal) hi = min(hi, min(Sq, qw + 64));
  lo = window > 0 ? max(0, qw - window + 1) / kBK * kBK : 0;
  if (qw >= Sq) hi = lo;                // a warpgroup past the last row
}

__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                   int Hkv, int D, int seq_len, int causal, int window,
                   float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // 128B swizzle repeats every 1024 B: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;                // [kDChunks][kBQ][128 B]
  const uint32_t kv_s = q_s + kDChunks * kQChunk;  // [stage][K|V][kDChunks]
  constexpr uint32_t kStageBytes = 2 * kDChunks * kKVChunk;
  const uint32_t bar = kv_s + kStages * kStageBytes;      // q, full[], empty[]
  const uint32_t q_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto k_tile = [&](int s, int c) {
    return kv_s + s * kStageBytes + c * kKVChunk;
  };
  auto v_tile = [&](int s, int c) {
    return kv_s + s * kStageBytes + (kDChunks + c) * kKVChunk;
  };

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first

  int lo0, hi0, lo1, hi1;
  key_range(q0, Sq, Sk, seq_len, causal, window, lo0, hi0);
  key_range(q0 + 64, Sq, Sk, seq_len, causal, window, lo1, hi1);
  const int lo = lo0;                   // warpgroup 0 starts no later
  const int hi = max(hi0, hi1);
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // ---- producer: Q once, then the K/V ring ----------------------------
    if (lane == 0) {
      mbar_expect_tx(q_full, kDChunks * kQChunk);
      for (int c = 0; c < kDChunks; ++c)
        tma_load(q_s + c * kQChunk, &tq, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStageBytes);
        const int kb = lo + i * kBK;
        for (int c = 0; c < kDChunks; ++c) {
          tma_load(k_tile(s, c), &tk, full(s), 64 * c, hk, kb, b);
          tma_load(v_tile(s, c), &tv, full(s), 64 * c, hk, kb, b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 q rows ---------------------------
  const int wg = warp >> 2;
  const int qw = q0 + 64 * wg;
  const int my_lo = wg == 0 ? lo0 : lo1;
  const int my_hi = wg == 0 ? hi0 : hi1;
  // this thread's two rows of the m64 accumulators, and its column pair
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);

  float o[kDChunks][32];
#pragma unroll
  for (int c = 0; c < kDChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int kb = lo + i * kBK;
    mbar_wait(full(s), (i / kStages) & 1);
    if (kb < my_hi && kb + kBK > my_lo) {
      // -- S = Q . K^T ------------------------------------------------------
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kDChunks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc,
                   desc_sw128(q_wg + c * kQChunk + 32 * kk, 16, 1024),
                   desc_sw128(k_tile(s, c) + 32 * kk, 16, 1024),
                   (c | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // -- online softmax in float32, log2 domain ---------------------------
      const bool edge = kb + kBK > seq_len || (causal && kb + kBK - 1 > qw) ||
                        (window > 0 && qw + 63 - kb >= window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * scale_log2;
        if (edge) {
          const int key = kb + 8 * (j >> 2) + cq + (j & 1);
          const int qpos = (j & 2) ? r1 : r0;
          bool ok = key < seq_len;
          if (causal) ok = ok && key <= qpos;
          if (window > 0) ok = ok && qpos - key < window;
          if (!ok) x = kNegInf;
        }
        sc[j] = x;
        if (j & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2f(sc[j] - ((j & 2) ? mn1 : mn0));
        sc[j] = p;
        if (j & 2) sum1 += p;
        else sum0 += p;
      }
      l0 = l0 * alpha0 + sum0;          // per-thread partial row sums
      l1 = l1 * alpha1 + sum1;
      // P as the A operand: k-step t holds keys 16t..16t+15, i.e. the
      // accumulator values 8t..8t+7 in pairs
      uint32_t pa[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
      for (int c = 0; c < kDChunks; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= (j & 2) ? alpha1 : alpha0;

      // -- O += P . V -------------------------------------------------------
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) fence_regs(o[c]);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kDChunks; ++c)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_rs(o[c], pa[4 * t], pa[4 * t + 1], pa[4 * t + 2],
                   pa[4 * t + 3],
                   desc_sw128(v_tile(s, c) + t * 16 * kRowBytes, kKVChunk,
                              1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) fence_regs(o[c]);
    }
    mbar_arrive(empty(s));
  }

  // -- epilogue: quad-reduce l, normalise, store bf16 pairs ---------------
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o_ss = static_cast<long long>(Hq) * D;
  __nv_bfloat16* ob = out + static_cast<long long>(b) * Sq * o_ss +
                      static_cast<long long>(h) * D;
#pragma unroll
  for (int c = 0; c < kDChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + cq;
      if (col >= D) continue;           // D is a multiple of 8
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
            pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
            pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint*), so the library links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over [B, S, H, D] (dims innermost first: D, H, S, B), boxes of
// 64 D columns x `rows` positions of one head, 128B swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              long long sb, long long ss, long long sh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int seq_len, int causal,
           int window, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh,
           cudaStream_t stream) {
  if (D < 8 || D > kMaxD || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, kBQ) ||
      !make_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, kBK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + kDChunks * (kQChunk + kStages * 2 * kKVChunk) +
                   8 * (1 + 2 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, D,
      seq_len, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

#define FLASH_ARGS                                                           \
  const void *q, const void *k, const void *v, void *out, int B, int Sq,     \
      int Sk, int Hq, int Hkv, int D, int seq_len, int causal, int window,   \
      float scale, long long q_sb, long long q_ss, long long q_sh,           \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,        \
      long long v_ss, long long v_sh, cudaStream_t stream

EXPORT int flash_attention_f32(FLASH_ARGS) {
  return launch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal,
                       window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                       v_sb, v_ss, v_sh, stream);
}

EXPORT int flash_attention_bf16(FLASH_ARGS) {
  return wg::launch(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal,
                    window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                    v_ss, v_sh, stream);
}

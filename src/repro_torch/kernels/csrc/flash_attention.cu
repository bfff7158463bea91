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
// - Head dimension: any D up to 256 (musicgen's 64, zamba2's 112,
//   gemma3's 256), not padded in device memory; the TPU pads D to a
//   multiple of 128 (ops.py:46-48).  bf16 has a kernel for D <= 64, one
//   for D <= 128 and one for 128 < D <= 256; float32 one up to D 128 and
//   one past it (below).  The D <= 128 kernels keep the bits they gave
//   before the others were added.
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
// - D <= 128 (flash_wgmma_body): two consumer warpgroups of 64 q rows
//   each (128 rows per CTA) and one producer warp.  The producer's lane 0
//   loads Q once and then streams 64-key K and V tiles into a ring of
//   kStages stages, each with a full and an empty mbarrier.
// - D <= 64 (flash_wgmma_d64_kernel): one 64-column box and 4 stages
//   (Q 16 KB, a stage 16 KB, O 32 registers a thread), two CTAs an SM
//   (95 registers a thread, no spill; 81 KB of shared memory each).  Its
//   exponent takes S unscaled, the scale folded into one FFMA, with
//   ex2.approx.ftz: musicgen's shape (B 4, S 2000, 24/24, causal) went
//   0.32 -> 0.17 ms on an H100, against SDPA's 0.14.  Tried and slower
//   there: the heads' q blocks together (0.23), a software pipeline that
//   issues tile i's S behind tile i - 1's P.V (spills at two CTAs an SM;
//   0.19-0.24 at one CTA of 2-4 consumer warpgroups), one-warpgroup CTAs
//   four an SM (the same 0.17), skipping O's rescale when every alpha is
//   1 (0.178).  Before it D <= 64 ran the D <= 128 kernel, whose second
//   box was TMA's zero fill (0.32 ms).
// - D up to 128 (flash_wgmma_kernel): two 64-column boxes of D and 3 K/V
//   stages, no setmaxnreg (138 registers a thread, within the 168 that
//   ptxas allows 288 threads).
// - Loads: one TMA tensor map per operand over [B, S, H, D] as the model
//   holds it (dims {D, H, S, B}, the caller's strides), D in 64-column
//   boxes with 128-byte swizzle.  TMA's out-of-bounds zero fill pads D to
//   a whole box in shared memory and the ragged S edge, so nothing is padded or
//   copied in device memory.  The wrapper refuses what TMA
//   cannot address (D not a multiple of 8, or a base or S/H/B stride not
//   16-byte aligned).
// - S = Q.K^T: wgmma m64n64k16, both operands K-major from shared memory
//   (descriptors with 128B swizzle, stride 1024 B per 8 rows, the start
//   advanced 32 B per k-step inside the swizzle atom).
// - Softmax: S scaled in float32 by scale * log2(e) for exp2f (D <= 64:
//   the FFMA above); masks only
//   on tiles that straddle the seq_len, causal or window edge; row max by
//   quad shuffles, row sums kept per thread and reduced once at the end.
// - O += P.V: P rounded to bf16 in registers is wgmma's register A
//   operand (the m64n64 accumulator layout is the A fragment layout, two
//   accumulator pairs per 32-bit register); V from shared memory is
//   MN-major (the transpose flag bf16 allows), one m64n64k16 per 64-column
//   chunk of D; O stays in float32 registers.
// - Each GEMM is fenced, committed and waited on (wait_group 0) before
//   its registers are read or written.
// - The grid launches the heaviest causal q blocks first (blockIdx.y
//   reversed, b * Hq + h on blockIdx.x), so the long rows do not trail.
//
// flash_attention_bf16 past D 128 -- flash_d256_kernel (gemma3's 256):
// - What bounds it: at gemma3's shape (B 4, S 2000, 8/4 heads, causal)
//   the whole tiles' products are ~73 GFLOP, 0.074 ms at the bf16 peak.
//   Streaming the K/V tiles is not the floor: the earlier D-256 design's
//   TMA pattern with no math (tools/flash_d256_probe.cu) takes 0.075 ms
//   at 8.0 TB/s into shared memory, 0.057 with two CTAs of a cluster
//   sharing each tile by multicast (L2 read at 5.6 TB/s).  That earlier
//   design (flash_wgmma_body at four boxes: 64-key tiles, one barrier
//   for K and V, P.V as 16 m64n64k16, one CTA an item) took 0.164 ms:
//   its n = 64 products reread Q from shared memory for every 64 keys,
//   and each CTA's Q load and epilogue were exposed, one CTA an SM.
// - CTA: two consumer warpgroups of 64 q rows and a producer warpgroup
//   (384 threads, setmaxnreg 232 / 40, 168 at launch, no spill).
//   Persistent: one CTA an SM walks the items (128 q rows, b * Hq + h),
//   heaviest causal q block first, dealt to the CTAs in a snake; the next
//   item's Q loads once both warpgroups are past their last S.
// - Shared memory (197680 B): Q (64 KB) and one 128-key tile each of K
//   and V (64 KB each) with barriers of their own: K(i) is released after
//   S(i), V(i) after P.V(i), so K(i + 1) loads under softmax(i) and
//   P.V(i).  S is m64n128k16 (16 a tile), P.V m64n256k16 (8 a tile, V's
//   four boxes one descriptor apart); the warpgroups take turns (named
//   barriers) to issue S, so one's softmax runs under the other's
//   products (FA3's ping-pong); the scale is folded into the exponent's
//   FFMA as at D <= 64.
// - At gemma3's shape on an H100 (tools/flash_lines.py,
//   tools/flash_d256_probe.py, which times every plan below side by
//   side): 0.133 ms causal (SDPA 0.145, the earlier design 0.164); the
//   1024 window 0.119 (0.145).  Tried and slower: a two-CTA cluster per
//   GQA pair sharing K/V by multicast (equal when persistent, 3-6 %
//   slower one item a CTA), the in-warpgroup pipeline of S(i) under
//   softmax(i - 1) (S and P at once spill; 0.18 ms at 64 keys), 64-key
//   tiles with 3 K + 2 V stages in the earlier order (0.156), one item a
//   CTA (0.143), items dealt round-robin (its busiest CTA 16 % over an
//   even split, tests/test_torch_flash_d256_wide.py), the unfolded
//   exponent (0.141), no turns (0.4-4.8 % slower in each of eight
//   timings in one run).  With the softmax left out it takes 0.117 ms,
//   with the loads 0.130, both 0.109: the products themselves run at
//   ~68 % of the 989 TFLOP/s peak.
//
// flash_attention_f32 -- 3xTF32 on mma.sync from a cp.async ring:
// - CTA: 8 warps, each owning one 16-row m-tile (128 q rows per CTA), the
//   grid ordered heaviest causal q block first as in the bf16 entry.  Q is
//   loaded once, scaled in float32, into shared memory; 64-key K and V
//   tiles stream through a 2-stage cp.async ring (16-byte copies where
//   every row is 16-byte aligned, 4-byte copies otherwise, so any view
//   with a unit stride over D is read in place).  D is padded to the
//   k-step of 8 in shared memory with zeros.  A warp skips the tiles none
//   of its rows can see.
// - Products: every float32 operand is split into a big and a small TF32
//   term on the fragment load and each product is small.big + big.small +
//   big.big on mma.sync m16n8k8 with float32 accumulate (common.cuh): the
//   accuracy of float32 FMA (the CPU emulation in
//   tests/test_torch_f32_tc.py stays within 3-6 % of the 1e-5 limit
//   against a float64 reference; one TF32 term misses it 30-80x).  S = Q.K^T takes both fragments from
//   ldmatrix (a 32-bit element is a pair of b16).  wgmma would take TF32
//   only K-major from shared memory, so P.V would need V transposed; here
//   P stays in registers: the accumulator layout holds keys 2t, 2t + 1 of
//   each 8-key n-tile, which become the columns t, t + 4 of a k-step, and
//   V's B fragment reads those key rows with scalar loads.
// - Softmax in float32 with expf, masks only on tiles that straddle an
//   edge, row sums per thread reduced once at the end.
// - Sums: mma.sync rounds its float32 sum toward zero
//   (tools/mma_tf32_probe.cu), so with one accumulator per output fed by
//   every tile's mma.sync the error against plain grew with the keys
//   (6.0e-6 at zamba2's shape on the card).  S keeps its big products and
//   its corrections in separate accumulators, and each tile's P.V starts
//   from zero and is added to O in float32 (O * alpha + P.V): 2.3-2.5e-6
//   there, about SDPA's own 2.4e-6.
// - Bound: operations, over the 494.7 TFLOP/s TF32 peak / 3 (~165 TFLOP/s
//   of float32 products).  mma.sync m16n8k8 TF32 reaches ~305 TFLOP/s on
//   the H100 (tools/mma_tf32_probe.cu), and SDPA's float32 kernel (CUTLASS
//   fmha, sm80 code, mma.sync too) runs at about a third of that.  At
//   zamba2's prefill shape this entry takes ~4.0 ms on the device, SDPA
//   3.2; at the float32 probe's shape 0.125 against 0.088
//   (tools/f32_lines.py on an H100).
//
// flash_attention_f32 past D 128 -- 3xTF32 on wgmma (flash_f32_d256_kernel):
// - wgmma takes TF32 only K-major from shared memory, so P.V needs V^T.
//   A pre-pass (flash_f32_split_kernel, one CTA per 32 keys x 32 columns
//   of D x kv head x K or V, through a shared-memory transpose) writes
//   K's big and small TF32 terms and V^T's into scratch the wrapper
//   allocates, D padded to 256 with zeros and the keys of each 8-key group
//   of V^T in the order P's fragment holds them (below).  It reads any
//   view with a unit stride over D, 4 bytes at a time, and moves ~197 MB
//   at gemma3's shape (B 4, S 2000, 8/4 heads): 0.065 ms on an H100.
// - CTA: 64 q rows, two consumer warpgroups that own D's columns 0-127
//   and 128-255, and a producer warpgroup (384 threads; setmaxnreg 240 /
//   24, ptxas 168 at launch, no spill).  Shared memory (230432 B): Q's
//   big term (64 KB, written by the consumers in the 128B-swizzled layout
//   TMA would write), one 32-key tile of K's two terms (64 KB: per
//   32-column box the big keys, then the small) and one of V^T's (64 KB),
//   and a double-buffered exchange of partial S (32 KB).  K and V have a
//   buffer each with its own full and empty barriers, so K's tile i + 1
//   loads during tile i's softmax and P.V, and V's during S.
// - Q is scaled in float32 and split on the load; its small term stays in
//   registers (64 a thread) as wgmma's register A operand.
// - S over a warpgroup's half: wgmma m64n64k8 with Q's big term against
//   [K big | K small] (one read of A for the big product and one
//   correction, into the accumulator's two halves) and m64n32k8 with Q's
//   small term against K's big term: three accumulators, summed as
//   (big.small + small.big) + big.big.  Each warpgroup writes its partial
//   to shared memory, and after a named barrier adds the other's: a + b
//   in both, so both hold the same S and the same P (S made once a row).
// - P.V: P's two terms are the register A operand, each k-step of 8 keys
//   holding keys 2t, 2t + 1 of the accumulator as columns t, t + 4, which
//   is why V^T keeps each 8-key group in the order 0 2 4 6 1 3 5 7.  Per
//   64-column chunk of the warpgroup's half: small.big + big.small +
//   big.big from zero (m64n64k8), then O = O * alpha + P.V in float32, as
//   the mma.sync kernel does against the truncated sums.
// - Grid: one CTA per (64 q rows, b * Hq + h), heaviest causal q block
//   first as above.  At gemma3's shape: 0.93 ms in all (parent, 3xTF32 on
//   mma.sync with S made twice: 3.25; SDPA 1.89), 0.75 with the 1024
//   window (2.56; SDPA's masked call 3.57).  The kernel reads ~4.2 GB of
//   K/V terms from L2 at 64 q rows a CTA; 128 rows would halve that but
//   do not fit in shared memory with Q's terms.
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;                      // both entries
constexpr int kNarrowD = 128;     // the widest D of the D <= 128 kernels

// ============================================================================
// float32: 3xTF32 on mma.sync from a cp.async ring
// ============================================================================

namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;                      // K/V ring depth

// D <= 128 (past it f32w below): each warp owns one 16-row m-tile, so a
// CTA takes 128 q rows, over 64-key tiles.
constexpr int kBQ = kWarps * 16;                // query rows per CTA
constexpr int kBK = 64;                         // keys per tile
constexpr int kKT = kNarrowD / 8;               // k-steps of S over D
constexpr int kNT = kNarrowD / 8;               // 8-column tiles of O
constexpr int kKeyTiles = kBK / 8;              // 8-key n-tiles of S

// shared-memory row stride (floats): D padded to the k-step of 8, plus 4,
// so ldmatrix rows and the scalar V loads miss each other's banks
__host__ __device__ __forceinline__ constexpr int stride(int D) {
  return (D + 7) / 8 * 8 + 4;
}

constexpr size_t smem_bytes(int D) {
  return 4 * static_cast<size_t>(stride(D)) * (kBQ + kStages * 2 * kBK);
}
static_assert(smem_bytes(kNarrowD) <= 227 * 1024, "flash f32 smem");

// 4 bytes global -> shared, zero-filled when pred is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

#define F32_ARGS                                                             \
  const float *__restrict__ q, const float *__restrict__ k,                  \
      const float *__restrict__ v, float *__restrict__ out, int Sq, int Sk,  \
      int Hq, int Hkv, int D, int seq_len, int causal, int window,           \
      float scale, long long q_sb, long long q_ss, long long q_sh,           \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,        \
      long long v_ss, long long v_sh, int vec

__global__ void __launch_bounds__(kThreads, 1) flash_f32_kernel(F32_ARGS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sr = stride(D);
  const int dp = sr - 4;                        // D padded to 8
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [kBQ][sr], scaled
  float* ring = q_s + kBQ * sr;                 // [stage][K|V][kBK][sr]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp;                          // this warp's m-tile
  const int g = lane >> 2;
  const int t = lane & 3;

  // the padding columns D .. dp - 1 of every tile row read as zeros
  if (dp > D) {
    const int pad = dp - D;
    for (int i = tid; i < (kBQ + kStages * 2 * kBK) * pad; i += kThreads)
      q_s[(i / pad) * sr + D + i % pad] = 0.f;
  }
  // Q scaled in float32 (as the model's sdpa scales q); rows past Sq zero
  const float* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    q_s[r * sr + d] =
        q0 + r < Sq ? qb[static_cast<long long>(q0 + r) * q_ss + d] * scale
                    : 0.f;
  }

  // the key range any row of this CTA can see, in tiles of kBK
  int k_hi = min(seq_len, Sk);
  if (causal) k_hi = min(k_hi, min(Sq, q0 + kBQ));
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  const float* kp = k + b * k_sb + hk * k_sh;
  const float* vp = v + b * v_sb + hk * v_sh;

  // tile i into stage i % kStages, one commit group; key rows at or past
  // Sk are zero-filled
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int kb = k_lo + i * kBK;
      float* ks = ring + (i % kStages) * 2 * kBK * sr;
      float* vs = ks + kBK * sr;
      const int ept = vec ? 4 : 1;              // floats per copy
      const int cpr = D / ept;
      const int n = kBK * cpr;
      for (int x = tid; x < 2 * n; x += kThreads) {
        const bool isv = x >= n;
        const int j = isv ? x - n : x;
        const int r = j / cpr;
        const int c = (j - r * cpr) * ept;
        const int key = kb + r;
        const bool live = key < Sk;
        const float* src = live ? (isv ? vp + key * v_ss : kp + key * k_ss) + c
                                : kp;
        float* dst = (isv ? vs : ks) + r * sr + c;
        if (vec)
          cp_async16(dst, src, live);
        else
          cp_async4(dst, src, live);
      }
    }
    cp_async_commit();
  };

  // this warp's rows wq .. wq + 15 (this thread: wq + g and wq + g + 8)
  // and the keys they can see, [w_lo, w_hi)
  const int wq = q0 + mt * 16;
  const int r0 = wq + g;
  const int r1 = r0 + 8;
  int w_hi = min(seq_len, Sk);
  if (causal) w_hi = min(w_hi, wq + 16);
  const int w_lo = window > 0 ? max(0, wq - window + 1) : 0;
  if (wq >= Sq) w_hi = 0;

  float o[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    issue(i + 1);
    cp_async_wait<1>();
    __syncthreads();                            // tile i and Q landed
    const int kb = k_lo + i * kBK;
    if (kb < w_hi && kb + kBK > w_lo) {         // warp-uniform
      const float* ks = ring + (i % kStages) * 2 * kBK * sr;
      const float* vs = ks + kBK * sr;
      // -- S = Q . K^T: n-tiles of 8 keys, 3xTF32, the big products and
      // the two corrections in separate accumulators ------------------------
      float sb[kKeyTiles][4], sc[kKeyTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[nt][e] = sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        if (kk * 8 >= dp) break;
        uint32_t fa[4], ab[4], as[4];
        ldsm_x4(fa, q_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              sr + kk * 8 + (lane >> 4) * 4);
        split_tf32(fa, ab, as);
#pragma unroll
        for (int np = 0; np < kKeyTiles / 2; ++np) {   // keys 16 np .. + 15
          uint32_t fb[4], bb[4], bs[4];
          ldsm_x4(fb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * sr +
                          kk * 8 + ((lane >> 3) & 1) * 4);
          split_tf32(fb, bb, bs);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int nt = 2 * np + h2;
            mma_tf32(sc[nt], as, bb[2 * h2], bb[2 * h2 + 1]);
            mma_tf32(sc[nt], ab, bs[2 * h2], bs[2 * h2 + 1]);
            mma_tf32(sb[nt], ab, bb[2 * h2], bb[2 * h2 + 1]);
          }
        }
      }
      float s[kKeyTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = sc[nt][e] + sb[nt][e];
      // -- online softmax in float32 ---------------------------------------
      const bool edge = kb + kBK > seq_len || (causal && kb + kBK - 1 > wq) ||
                        (window > 0 && wq + 15 - kb >= window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e];
          if (edge) {
            const int key = kb + nt * 8 + 2 * t + (e & 1);
            const int qpos = (e & 2) ? r1 : r0;
            bool ok = key < seq_len;
            if (causal) ok = ok && key <= qpos;
            if (window > 0) ok = ok && qpos - key < window;
            if (!ok) x = kNegInf;
          }
          s[nt][e] = x;
          if (e & 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - ((e & 2) ? mn1 : mn0));
          s[nt][e] = p;
          if (e & 2) sum1 += p;
          else sum0 += p;
        }
      l0 = l0 * alpha0 + sum0;                  // per-thread partial sums
      l1 = l1 * alpha1 + sum1;
      // -- O = O * alpha + P . V, P . V in a fresh accumulator per tile: k-step
      // j is n-tile j of S, its columns t, t + 4 the keys 8j + 2t, 8j + 2t +
      // 1; V's B fragment reads those key rows ------------------------------
      float pv[kNT][4];
#pragma unroll
      for (int dn = 0; dn < kNT; ++dn) pv[dn][0] = pv[dn][1] = pv[dn][2] = pv[dn][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        uint32_t pb[4], ps[4];
        split_tf32(s[j][0], pb[0], ps[0]);
        split_tf32(s[j][2], pb[1], ps[1]);
        split_tf32(s[j][1], pb[2], ps[2]);
        split_tf32(s[j][3], pb[3], ps[3]);
        const float* v0 = vs + (8 * j + 2 * t) * sr + g;
#pragma unroll
        for (int dn = 0; dn < kNT; ++dn) {
          if (dn * 8 >= dp) break;
          uint32_t vb0, vs0, vb1, vs1;
          split_tf32(v0[dn * 8], vb0, vs0);
          split_tf32(v0[sr + dn * 8], vb1, vs1);
          mma_3xtf32(pv[dn], pb, ps, vb0, vb1, vs0, vs1);
        }
      }
#pragma unroll
      for (int dn = 0; dn < kNT; ++dn) {
        o[dn][0] = o[dn][0] * alpha0 + pv[dn][0];
        o[dn][1] = o[dn][1] * alpha0 + pv[dn][1];
        o[dn][2] = o[dn][2] * alpha1 + pv[dn][2];
        o[dn][3] = o[dn][3] * alpha1 + pv[dn][3];
      }
    }
    __syncthreads();                            // stage i % 2 is refilled
  }
  cp_async_wait<0>();

  // -- epilogue: quad-reduce l, normalise, store ---------------------------
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o_ss = static_cast<long long>(Hq) * D;
  float* ob = out + static_cast<long long>(b) * Sq * o_ss +
              static_cast<long long>(h) * D;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      const int r = (e & 2) ? r1 : r0;
      if (col < D && r < Sq)
        ob[r * o_ss + col] = o[nt][e] * ((e & 2) ? inv1 : inv0);
    }
  }
}



// Raise the kernel's shared-memory limit once, to its widest D: later
// launches make no API call, so a CUDA graph can capture them.
cudaError_t grant_smem() {
  static bool granted = false;
  if (granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kNarrowD)));
  if (err == cudaSuccess) granted = true;
  return err;
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int seq_len, int causal,
           int window, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh,
           cudaStream_t stream) {
  if (D < 1 || D > kNarrowD || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // K and V rows copied 16 bytes at a time where every row is 16-byte
  // aligned, else 4 bytes at a time
  auto a16 = [](const void* p, long long sb, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
           ss % 4 == 0 && sh % 4 == 0;
  };
  const int vec = D % 4 == 0 && a16(k, k_sb, k_ss, k_sh) &&
                  a16(v, v_sb, v_ss, v_sh);
  const cudaError_t err = grant_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  // one CTA of kThreads per (kBQ query rows, b * Hq + h)
  flash_f32_kernel<<<dim3(B * Hq, (Sq + kBQ - 1) / kBQ), kThreads,
                     smem_bytes(D), stream>>>(
      qf, kf, vf, of, Sq, Sk, Hq, Hkv, D, seq_len, causal, window, scale,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ============================================================================
// float32, 128 < D <= 256: 3xTF32 on wgmma, K and V split by a pre-pass
// ============================================================================

namespace f32w {

constexpr int kDp = kMaxD;                      // D padded with zeros
constexpr int kBQ = 64;                         // q rows per CTA
constexpr int kBK = 32;                         // keys per tile
constexpr int kThreads = 384;   // two consumer warpgroups, a producer one
constexpr int kProducerRegs = 24;               // setmaxnreg
constexpr int kConsumerRegs = 240;
constexpr int kBoxes = kDp / 32;                // 32-float (128-byte) boxes
constexpr int kQBox = kBQ * 128;                // Q's big term, one box
constexpr int kKBox = 2 * kBK * 128;            // K's big and small, one box
constexpr int kVTerm = kDp * 128;               // one term of a V^T tile
constexpr int kX = kBQ * kBK;                   // floats of a partial S
constexpr int kTileFloats = 2 * kBK * kDp;      // a tile's two terms
constexpr int kQBytes = kBoxes * kQBox;         // 64 KB
constexpr int kKBytes = kBoxes * kKBox;         // 64 KB
constexpr int kVBytes = 2 * kVTerm;             // 64 KB
constexpr int kSmem = 1024 + kQBytes + kKBytes + kVBytes + 4 * kX * 4 + 4 * 8;
static_assert(kSmem <= 227 * 1024, "flash f32 d256 smem");

// V^T's position p in a group of 8 keys holds key perm8(p): P's
// accumulator holds keys 2t and 2t + 1 of each 8-key group, and as wgmma's
// A operand they become the columns t and t + 4 of a k-step
__device__ __forceinline__ int perm8(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// The pre-pass: one CTA per (32-key tile x 32-column box, b * Hkv + hk, K
// or V).  K goes to [b * Hkv + hk][tile][big | small][32 keys][256] and V
// transposed to [b * Hkv + hk][tile][big | small][256][32 keys in perm8
// order], D and the keys past Sk zero-filled; any view with a unit stride
// over D is read 4 bytes at a time.
__global__ void __launch_bounds__(256) flash_f32_split_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ ks, float* __restrict__ vts, int Sk, int Hkv, int D,
    int n_kt, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh) {
  __shared__ float tile[32][33];
  const int kt = blockIdx.x / kBoxes;
  const int c = blockIdx.x - kt * kBoxes;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const bool isv = blockIdx.z != 0;
  const float* src = isv ? v + b * v_sb + hk * v_sh : k + b * k_sb + hk * k_sh;
  const long long ss = isv ? v_ss : k_ss;
  const int x = threadIdx.x & 31;
  const int y = threadIdx.x >> 5;
  for (int r = y; r < kBK; r += 8) {
    const int key = kt * kBK + r;
    const int d = c * 32 + x;
    tile[r][x] = key < Sk && d < D ? src[key * ss + d] : 0.f;
  }
  __syncthreads();
  float* dst = (isv ? vts : ks) +
               static_cast<long long>(bhk * n_kt + kt) * kTileFloats;
  for (int r = y; r < kBK; r += 8) {
    uint32_t big, small;
    if (isv) {                                  // r: a column of D
      split_tf32(tile[(x & ~7) | perm8(x & 7)][r], big, small);
      dst[(c * 32 + r) * kBK + x] = __uint_as_float(big);
      dst[kDp * kBK + (c * 32 + r) * kBK + x] = __uint_as_float(small);
    } else {                                    // r: a key
      split_tf32(tile[r][x], big, small);
      dst[r * kDp + c * 32 + x] = __uint_as_float(big);
      dst[kBK * kDp + r * kDp + c * 32 + x] = __uint_as_float(small);
    }
  }
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64], TF32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_ss64(float (&d)[32], uint64_t da,
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64], TF32, A in registers (a0: row g,
// column t; a1: row g + 8; a2: column t + 4; a3: both), B K-major in
// shared memory
__device__ __forceinline__ void wgmma_tf32_rs64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64 x 32] (+)= A[64 x 8] . B[8 x 32], TF32, A in registers
__device__ __forceinline__ void wgmma_tf32_rs32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// One CTA per (64 q rows, b * Hq + h), the heaviest causal block of a head
// first and the heads in order, so the K/V a head shares stay in L2.
// Warpgroups 0 and 1 own D's columns 0-127 and 128-255; warpgroup 2 is
// the producer (one thread of it issues TMA).
__global__ void __launch_bounds__(kThreads, 1) flash_f32_d256_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ q,
    float* __restrict__ out, int Sq, int Sk, int Hq, int Hkv, int D,
    int seq_len, int causal, int window, float scale, long long q_sb,
    long long q_ss, long long q_sh, int n_kt) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;                    // [box][64 rows][128 B]
  const uint32_t k_s = q_s + kQBytes;           // [box][big | small keys]
  const uint32_t v_s = k_s + kKBytes;           // [big | small][256][128 B]
  float* xs = reinterpret_cast<float*>(smem_raw + (v_s + kVBytes - raw));
  const uint32_t bar = v_s + kVBytes + 4 * kX * 4;
  const uint32_t k_full = bar, k_empty = bar + 8;
  const uint32_t v_full = bar + 16, v_empty = bar + 24;

  const int nqb = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - (blockIdx.x - bh * nqb)) * kBQ;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  int hi = min(seq_len, Sk);
  if (causal) hi = min(hi, min(Sq, q0 + kBQ));
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    mbar_init(k_empty, 256);
    mbar_init(v_full, 1);
    mbar_init(v_empty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: K's tile i once S(i - 1) is done with the buffer,
    // V's tile i once P . V(i - 1) is ---------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == 8 && lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int row = bhk * n_kt + lo / kBK + i;
        if (i > 0) mbar_wait(k_empty, (i - 1) & 1);
        mbar_expect_tx(k_full, kKBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_2d(k_s + c * kKBox, &tk, k_full, 32 * c, row * 2 * kBK);
        if (i > 0) mbar_wait(v_empty, (i - 1) & 1);
        mbar_expect_tx(v_full, kVBytes);
        tma_load_2d(v_s, &tv, v_full, 0, row * 2 * kDp);
        tma_load_2d(v_s + kVTerm, &tv, v_full, 0, row * 2 * kDp + kDp);
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;                     // its half of D
  const int tw = threadIdx.x & 127;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rl = 16 * (warp & 3) + g;           // rows rl, rl + 8 of 64
  const int r0 = q0 + rl;
  const int r1 = r0 + 8;

  // Q scaled in float32 and split: the small term stays in registers as
  // the A operand of its product, the big term goes to shared memory in
  // the 128B-swizzled layout TMA would write; each warpgroup writes and
  // reads its own half
  uint32_t qs[16][4];
  const float* qb = q + b * q_sb + h * q_sh;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rl + 8 * (e & 1);
      const int col = 128 * wg + 8 * kk + t + 4 * (e >> 1);
      const float x =
          q0 + r < Sq && col < D ? qb[(q0 + r) * q_ss + col] * scale : 0.f;
      uint32_t big;
      split_tf32(x, big, qs[kk][e]);
      const int cc = col & 31;
      st_shared(q_s + (col >> 5) * kQBox + r * 128 +
                    (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4,
                big);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  float o[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int kb = lo + i * kBK;
    mbar_wait(k_full, i & 1);
    // -- this half's S: Qb . [Kb | Ks] (big products left, Qb . Ks right)
    // and Qs . Kb, three accumulators -----------------------------------------
    float sa[32], sq[16];
#pragma unroll
    for (int j = 0; j < 32; ++j) sa[j] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) sq[j] = 0.f;
    fence_regs(sa);
    fence_regs(sq);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dk =
            desc_sw128(k_s + (4 * wg + c) * kKBox + 32 * kk, 16, 1024);
        wgmma_tf32_ss64(
            sa, desc_sw128(q_s + (4 * wg + c) * kQBox + 32 * kk, 16, 1024),
            dk, (c | kk) != 0);
        wgmma_tf32_rs32(sq, qs[4 * c + kk], dk, (c | kk) != 0);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sa);
    fence_regs(sq);
    mbar_arrive(k_empty);

    // -- S = (this half) + (the other half), the same bits in both ---------
    float* xw = xs + ((i & 1) * 2 + wg) * kX;
    const float* xo = xs + ((i & 1) * 2 + (wg ^ 1)) * kX;
    float s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = (sa[16 + j] + sq[j]) + sa[j];
      xw[j * 128 + tw] = s[j];
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] += xo[j * 128 + tw];

    // -- online softmax in float32 -----------------------------------------
    const bool edge = kb + kBK > seq_len || (causal && kb + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - kb >= window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float x = s[j];
      if (edge) {
        const int key = kb + 8 * (j >> 2) + 2 * t + (j & 1);
        const int qpos = (j & 2) ? r1 : r0;
        bool ok = key < seq_len;
        if (causal) ok = ok && key <= qpos;
        if (window > 0) ok = ok && qpos - key < window;
        if (!ok) x = kNegInf;
      }
      s[j] = x;
      if (j & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = expf(s[j] - ((j & 2) ? mn1 : mn0));
      s[j] = p;
      if (j & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * alpha0 + sum0;                    // per-thread partial sums
    l1 = l1 * alpha1 + sum1;
    // P's terms as A fragments: k-step j is keys 8j .. 8j + 7
    uint32_t pb[4][4], ps[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(s[4 * j], pb[j][0], ps[j][0]);
      split_tf32(s[4 * j + 2], pb[j][1], ps[j][1]);
      split_tf32(s[4 * j + 1], pb[j][2], ps[j][2]);
      split_tf32(s[4 * j + 3], pb[j][3], ps[j][3]);
    }

    // -- O = O * alpha + P . V, P . V from zero per tile and 64-column chunk
    mbar_wait(v_full, i & 1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float pv[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) pv[j] = 0.f;
      fence_regs(pv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_regs(pb[j]);
        fence_regs(ps[j]);
      }
      wgmma_fence();
      const uint32_t vrow = v_s + (128 * wg + 64 * c) * 128;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t vb = desc_sw128(vrow + 32 * j, 16, 1024);
        const uint64_t vsm = desc_sw128(vrow + kVTerm + 32 * j, 16, 1024);
        wgmma_tf32_rs64(pv, ps[j], vb, j != 0);
        wgmma_tf32_rs64(pv, pb[j], vsm, 1);
        wgmma_tf32_rs64(pv, pb[j], vb, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        o[c][j] = o[c][j] * ((j & 2) ? alpha1 : alpha0) + pv[j];
    }
    mbar_arrive(v_empty);
  }

  // -- epilogue: quad-reduce l, normalise, store -----------------------------
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o_ss = static_cast<long long>(Hq) * D;
  float* ob = out + static_cast<long long>(b) * Sq * o_ss +
              static_cast<long long>(h) * D;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 128 * wg + 64 * c + 8 * (j >> 2) + 2 * t + (j & 1);
      const int r = (j & 2) ? r1 : r0;
      if (col < D && r < Sq)
        ob[r * o_ss + col] = o[c][j] * ((j & 2) ? inv1 : inv0);
    }
}

// a 2-d float32 map over [rows, cols] contiguous, boxes of 32 columns x
// box_rows rows, 128B swizzle
bool make_map(CUtensorMap* map, const float* ptr, uint64_t cols,
              uint64_t rows, uint32_t box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {32, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Key tiles of the scratch: at least one, so the maps have rows.
inline int key_tiles(int Sk) { return Sk > kBK ? (Sk + kBK - 1) / kBK : 1; }

cudaError_t grant_smem() {
  static bool granted = false;
  if (granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err == cudaSuccess) granted = true;
  return err;
}

int launch(const void* q, const void* k, const void* v, void* out,
           void* scratch, int B, int Sq, int Sk, int Hq, int Hkv, int D,
           int seq_len, int causal, int window, float scale, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           cudaStream_t stream) {
  if (D <= kNarrowD || D > kMaxD || Hkv < 1 || Hq % Hkv != 0 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_kt = key_tiles(Sk);
  const long long heads = static_cast<long long>(B) * Hkv;
  float* ks = static_cast<float*>(scratch);
  float* vts = ks + heads * n_kt * kTileFloats;
  CUtensorMap tk, tv;
  if (!make_map(&tk, ks, kDp, heads * n_kt * 2 * kBK, 2 * kBK) ||
      !make_map(&tv, vts, kBK, heads * n_kt * 2 * kDp, kDp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = grant_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_split_kernel<<<dim3(n_kt * kBoxes, B * Hkv, 2), 256, 0,
                           stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), ks, vts,
      Sk, Hkv, D, n_kt, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_d256_kernel<<<B * Hq * ((Sq + kBQ - 1) / kBQ), kThreads, kSmem,
                          stream>>>(
      tk, tv, static_cast<const float*>(q), static_cast<float*>(out), Sq, Sk,
      Hq, Hkv, D, seq_len, causal, window, scale, q_sb, q_ss, q_sh, n_kt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32w

// ============================================================================
// bf16: wgmma from TMA-loaded tiles
// ============================================================================

namespace wg {

constexpr int kConsumers = 2;                   // warpgroups of 64 q rows
constexpr int kBQ = 64 * kConsumers;            // q rows per CTA
constexpr int kBK = 64;                         // keys per tile
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
// D > 128: a whole producer warpgroup (one warp of it loads), so that
// setmaxnreg can move registers from it to the consumers
constexpr int kWideThreads = 128 * kConsumers + 128;
constexpr int kRowBytes = 128;                  // 64 bf16: one swizzle row
constexpr int kQChunk = kBQ * kRowBytes;        // one 64-column box of Q
constexpr int kKVChunk = kBK * kRowBytes;       // one 64-column box of K/V
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// Keys [lo, hi) that q rows [qw, qw + 64) of one warpgroup can see, lo
// a whole tile of kTileKeys.
template <int kTileKeys = kBK>
__device__ __forceinline__ void key_range(int qw, int Sq, int Sk,
                                          int seq_len, int causal,
                                          int window, int& lo, int& hi) {
  hi = min(seq_len, Sk);
  if (causal) hi = min(hi, min(Sq, qw + 64));
  lo = window > 0 ? max(0, qw - window + 1) / kTileKeys * kTileKeys : 0;
  if (qw >= Sq) hi = lo;                // a warpgroup past the last row
}

// The kernel for D up to 64 * kDChunks (64-column boxes of D) with a
// K/V ring of kStages stages: kDChunks 1, kStages 4 up to D 64; kDChunks
// 2, kStages 3 up to D 128 (past D 128, flash_d256_kernel below).
template <int kDChunks, int kStages>
struct Ring {
  static constexpr int kSmem = 1024 + kDChunks * (kQChunk + kStages * 2 *
                                                  kKVChunk) +
                               8 * (1 + 2 * kStages);
};
static_assert(Ring<2, 3>::kSmem <= 227 * 1024, "flash bf16 smem");
constexpr int kD64Stages = 4;                   // D <= 64: two CTAs an SM
static_assert(2 * (Ring<1, kD64Stages>::kSmem + 1024) <= 228 * 1024,
              "flash bf16 d64 smem");

// exp2 on the MUFU unit alone (ex2.approx.ftz: no denormal scaling)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kFold (the D <= 64 kernel) keeps S unscaled and folds the scale into
// the exponent's FFMA, with ex2.approx.ftz: an FMUL and exp2f's denormal
// handling fewer an element.
template <int kDChunks, int kStages, bool kFold = false>
__device__ __forceinline__ void flash_wgmma_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq, int Hkv, int D,
    int seq_len, int causal, int window, float scale_log2) {
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

  if (warp >= 4 * kConsumers) {
    // ---- producer: Q once, then the K/V ring ----------------------------
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(q_full, kDChunks * kQChunk);
      for (int c = 0; c < kDChunks; ++c)
        tma_load_4d(q_s + c * kQChunk, &tq, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStageBytes);
        const int kb = lo + i * kBK;
        for (int c = 0; c < kDChunks; ++c) {
          tma_load_4d(k_tile(s, c), &tk, full(s), 64 * c, hk, kb, b);
          tma_load_4d(v_tile(s, c), &tv, full(s), 64 * c, hk, kb, b);
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
  // kFold masks with -2**100, whose product with the scale is exact, so
  // in a row that has seen only masked keys fmaf(x, scale, -m * scale) is
  // 0 and p is 1, as the unfolded arithmetic gives
  constexpr float kMasked = kFold ? -0x1p100f : kNegInf;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

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
      float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = kFold ? sc[j] : sc[j] * scale_log2;
        if (edge) {
          const int key = kb + 8 * (j >> 2) + cq + (j & 1);
          const int qpos = (j & 2) ? r1 : r0;
          bool ok = key < seq_len;
          if (causal) ok = ok && key <= qpos;
          if (window > 0) ok = ok && qpos - key < window;
          if (!ok) x = kMasked;
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
      const float alpha0 = kFold ? exp2_ftz((m0 - mn0) * scale_log2)
                                 : exp2f(m0 - mn0);
      const float alpha1 = kFold ? exp2_ftz((m1 - mn1) * scale_log2)
                                 : exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p =
            kFold ? exp2_ftz(fmaf(sc[j], scale_log2, -((j & 2) ? ms1 : ms0)))
                  : exp2f(sc[j] - ((j & 2) ? mn1 : mn0));
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

#define WG_ARGS                                                              \
  const __grid_constant__ CUtensorMap tq,                                    \
      const __grid_constant__ CUtensorMap tk,                                \
      const __grid_constant__ CUtensorMap tv,                                \
      __nv_bfloat16 *__restrict__ out, int Sq, int Sk, int Hq, int Hkv,      \
      int D, int seq_len, int causal, int window, float scale_log2
#define WG_PASS                                                              \
  tq, tk, tv, out, Sq, Sk, Hq, Hkv, D, seq_len, causal, window, scale_log2

// D <= 64: one box, so Q takes 16 KB, a stage 16 KB and O 32 registers a
// thread; two CTAs share an SM (95 registers a thread, no spill).
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_d64_kernel(WG_ARGS) {
  flash_wgmma_body<1, kD64Stages, true>(WG_PASS);
}
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(WG_ARGS) {
  flash_wgmma_body<2, 3>(WG_PASS);
}

// ---------------------------------------------------------------------------
// 128 < D <= 256: flash_d256_kernel, persistent, 128-key tiles
// ---------------------------------------------------------------------------

constexpr int kWideBK = 128;                    // keys a tile
constexpr int kWideBox = kWideBK * kRowBytes;   // 64 columns of a tile
constexpr int kWideTile = 4 * kWideBox;         // a K or a V tile: 64 KB
constexpr int kWideQBytes = 4 * kQChunk;        // Q, 128 rows: 64 KB
// Q, one K and one V tile, and the full and empty barrier of each
constexpr int kWideSmem = 1024 + kWideQBytes + 2 * kWideTile + 8 * 6;
static_assert(kWideSmem <= 232448, "flash bf16 d256 smem");
// setmaxnreg: the producer keeps 40 (at 24 its loop spilled), the consumers
// 232; at most 512 a thread triple
constexpr int kWideProducerRegs = 40;
constexpr int kWideConsumerRegs = 232;
static_assert(kWideProducerRegs + 2 * kWideConsumerRegs <= 504, "setmaxnreg");

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], A in registers (bf16 pairs), B
// MN-major in shared memory (transpose flag set), its four 64-column boxes
// the descriptor's leading byte offset apart
__device__ __forceinline__ void wgmma_rs256(float (&d)[128], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The key tiles of q rows [q0, q0 + 128): warpgroup w's keys [lo_w, hi_w)
// and the tile count n from lo0 (warpgroup 0 starts no later).
template <int kTileKeys>
__device__ __forceinline__ void wide_tiles(int q0, int Sq, int Sk,
                                           int seq_len, int causal,
                                           int window, int& lo0, int& hi0,
                                           int& lo1, int& hi1, int& n) {
  key_range<kTileKeys>(q0, Sq, Sk, seq_len, causal, window, lo0, hi0);
  key_range<kTileKeys>(q0 + 64, Sq, Sk, seq_len, causal, window, lo1, hi1);
  const int hi = max(hi0, hi1);
  n = hi > lo0 ? (hi - lo0 + kTileKeys - 1) / kTileKeys : 0;
}

// S = Q . K^T over one tile: 4 boxes of D x 4 k-steps of m64n128k16
__device__ __forceinline__ void wide_s(float (&sc)[64], uint32_t q_wg,
                                       uint32_t kt) {
#pragma unroll
  for (int j = 0; j < 64; ++j) sc[j] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss128(sc, desc_sw128(q_wg + c * kQChunk + 32 * kk, 16, 1024),
                  desc_sw128(kt + c * kWideBox + 32 * kk, 16, 1024),
                  (c | kk) != 0);
  wgmma_commit();
}

// O *= alpha (row r0's, row r1's), then O += P . V over one tile: one
// m64n256k16 a 16-key step, V's four boxes one descriptor apart
__device__ __forceinline__ void wide_pv(float (&o)[128], uint32_t (&pa)[32],
                                        uint32_t vt, float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < 128; ++j) o[j] *= (j & 2) ? alpha1 : alpha0;
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kWideBK / 16; ++t)
    wgmma_rs256(o, pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3],
                desc_sw128(vt + t * 16 * kRowBytes, kWideBox, 1024));
  wgmma_commit();
}

// The online softmax of one tile in float32, log2 domain, as
// flash_wgmma_body's D <= 64 form: S unscaled and the scale folded into the
// exponent's FFMA, masked with -2**100 (whose product with the scale is
// exact) on a tile that straddles an edge, row maxima by quad shuffles, the
// new maxima's rescale factors in alpha0/1, P packed into pa (bf16 pairs,
// wgmma's A fragment) and per-thread row sums in l0/1.
__device__ __forceinline__ void wide_softmax(
    float (&sc)[64], uint32_t (&pa)[32], int kb, int qw, int r0, int r1,
    int cq, int seq_len, int causal, int window, float scale_log2,
    float& m0, float& m1, float& l0, float& l1, float& alpha0,
    float& alpha1) {
  constexpr float kMasked = -0x1p100f;
  const bool edge = kb + kWideBK > seq_len ||
                    (causal && kb + kWideBK - 1 > qw) ||
                    (window > 0 && qw + 63 - kb >= window);
  float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    float x = sc[j];
    if (edge) {
      const int key = kb + 8 * (j >> 2) + cq + (j & 1);
      const int qpos = (j & 2) ? r1 : r0;
      bool ok = key < seq_len;
      if (causal) ok = ok && key <= qpos;
      if (window > 0) ok = ok && qpos - key < window;
      if (!ok) x = kMasked;
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
  alpha0 = exp2_ftz((m0 - mn0) * scale_log2);
  alpha1 = exp2_ftz((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const float p = exp2_ftz(fmaf(sc[j], scale_log2, (j & 2) ? -ms1 : -ms0));
    sc[j] = p;
    if (j & 2) sum1 += p;
    else sum0 += p;
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
#pragma unroll
  for (int j = 0; j < 32; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

// Persistent: one CTA an SM walks the work items, (128 q rows,
// b * Hq + h), heaviest causal q block first, in a snake over the CTAs
// (nth below).  Warpgroups 0 and 1 consume 64 q rows each, warpgroup 2
// produces (one thread issues TMA).  K and V have one slot each with
// barriers of their own, their uses counted across items (g): K(g) is
// released after S(g), V(g) after P.V(g), and Q after a warpgroup's last S
// of the item, so the next item's Q loads under the last P.V and the
// epilogue.  Each warpgroup runs S(g), softmax(g), P.V(g) in turn, the two
// taking turns (named barriers 1 and 2) to issue their S, so that one's
// softmax runs under the other's GEMMs.
__global__ void __launch_bounds__(kWideThreads, 1)
flash_d256_kernel(WG_ARGS, int B) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                    // [4][128 rows][128 B]
  const uint32_t k_s = q_s + kWideQBytes;       // [4][128 keys][128 B]
  const uint32_t v_s = k_s + kWideTile;         // [4][128 keys][128 B]
  const uint32_t q_full = v_s + kWideTile, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, k_empty = k_full + 8;
  const uint32_t v_full = k_empty + 8, v_empty = v_full + 8;

  const int nqb = (Sq + kBQ - 1) / kBQ;
  const int heads = B * Hq;
  const int n_items = nqb * heads;
  // the CTA's r-th item: the items in rounds of gridDim.x, each round's
  // order reversed from the last (a snake, so that the heavy and the light
  // items of the causal schedule even out across CTAs)
  auto nth = [&](int r) {
    return r * gridDim.x +
           ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };
  // item k: its batch row, q head and first q row
  auto item = [&](int k, int& b, int& h, int& q0) {
    const int y = k / heads;
    const int x = k - y * heads;
    b = x / Hq;
    h = x - b * Hq;
    q0 = (nqb - 1 - y) * kBQ;
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(q_empty, 8);                      // the consumer warps
    mbar_init(k_empty, 8);
    mbar_init(v_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: each item's Q once its predecessor's is released, then
    // K(g) and V(g), each slot refilled once released ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWideProducerRegs));
    if (warp == 8 && lane == 0) {
      int g = 0;                                // tiles so far, all items
      for (int it = 0, k = nth(0); k < n_items; k = nth(++it)) {
        int b, h, q0, lo, hi0, lo1, hi1, n;
        item(k, b, h, q0);
        wide_tiles<kWideBK>(q0, Sq, Sk, seq_len, causal, window, lo, hi0,
                            lo1, hi1, n);
        const int hk = h / (Hq / Hkv);
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, kWideQBytes);
        for (int c = 0; c < 4; ++c)
          tma_load_4d(q_s + c * kQChunk, &tq, q_full, 64 * c, h, q0, b);
        for (int i = 0; i < n; ++i, ++g) {
          const int kb = lo + i * kWideBK;
          if (g > 0) mbar_wait(k_empty, (g - 1) & 1);
          mbar_expect_tx(k_full, kWideTile);
          for (int c = 0; c < 4; ++c)
            tma_load_4d(k_s + c * kWideBox, &tk, k_full, 64 * c, hk, kb, b);
          if (g > 0) mbar_wait(v_empty, (g - 1) & 1);
          mbar_expect_tx(v_full, kWideTile);
          for (int c = 0; c < 4; ++c)
            tma_load_4d(v_s + c * kWideBox, &tv, v_full, 64 * c, hk, kb, b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 q rows -----------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kWideConsumerRegs));
  const int wg = warp >> 2;
  const int cq = 2 * (lane & 3);
  const int rw = 16 * (warp & 3) + (lane >> 2);     // row of 64, and + 8
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  auto release = [&](uint32_t bar) {    // one arrival a warp
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Turns: both warpgroups take n + 1 an item, one a tile and one after
  // the last, alternating across items; warpgroup 1 gives warpgroup 0 the
  // first, and warpgroup 0 takes one more after the last item to match
  // warpgroup 1's last pass (per item, warpgroup 1 could pass twice on
  // warpgroup 0's barrier before warpgroup 0 reached it).  No warpgroup
  // waits for a turn while it holds a slot the other's turn needs.
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };
  auto skip = [&](int g) {              // a tile none of these rows sees
    mbar_wait(k_full, g & 1);
    turn_wait();
    turn_pass();
    release(k_empty);
    mbar_wait(v_full, g & 1);
    release(v_empty);
  };

  if (wg == 1) turn_pass();
  int g = 0;                                    // tiles so far, all items
  for (int it = 0, k = nth(0); k < n_items; k = nth(++it)) {
    int b, h, q0, lo, hi0, lo1, hi1, n;
    item(k, b, h, q0);
    wide_tiles<kWideBK>(q0, Sq, Sk, seq_len, causal, window, lo, hi0, lo1,
                        hi1, n);
    const int qw = q0 + 64 * wg;
    const int r0 = qw + rw, r1 = r0 + 8;
    const int my_lo = wg == 0 ? lo : lo1;
    const int my_hi = wg == 0 ? hi0 : hi1;
    // the item's tiles this warpgroup computes, [ib, ie); it waits for and
    // releases the others without computing
    const int ib = min((my_lo - lo) / kWideBK, n);
    const int ie = my_hi > my_lo
                       ? max(ib, min(n, (my_hi - lo + kWideBK - 1) / kWideBK))
                       : ib;
    float o[128];                       // [64 rows, 256 columns] of O
#pragma unroll
    for (int j = 0; j < 128; ++j) o[j] = 0.f;
    float m0 = -0x1p100f, m1 = -0x1p100f, l0 = 0.f, l1 = 0.f;
    float alpha0 = 1.f, alpha1 = 1.f;
    mbar_wait(q_full, it & 1);
    if (ib == ie) release(q_empty);

    for (int i = 0; i < ib; ++i) skip(g + i);
    for (int i = ib; i < ie; ++i) {
      float sc[64];
      uint32_t pa[32];
      mbar_wait(k_full, (g + i) & 1);
      turn_wait();
      wide_s(sc, q_wg, k_s);
      turn_pass();
      wgmma_wait_all();
      fence_regs(sc);
      release(k_empty);
      if (i == ie - 1) release(q_empty);
      wide_softmax(sc, pa, lo + i * kWideBK, qw, r0, r1, cq, seq_len, causal,
                   window, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      mbar_wait(v_full, (g + i) & 1);
      wide_pv(o, pa, v_s, alpha0, alpha1);
      wgmma_wait_all();
      fence_regs(o);
      release(v_empty);
    }
    for (int i = ie; i < n; ++i) skip(g + i);
    turn_wait();                        // the item's last turn
    turn_pass();
    g += n;

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
    for (int j = 0; j < 32; ++j) {      // columns 8j + cq, 8j + cq + 1
      const int col = 8 * j + cq;
      if (col >= D) continue;           // D is a multiple of 8
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if (wg == 0) turn_wait();
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

// flash_d256_kernel's grid: one CTA an SM of the current card, at most one
// per work item (0 if the card cannot be asked)
inline int wide_grid(int B, int Sq, int Hq) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long items =
      static_cast<long long>(B) * Hq * ((Sq + kBQ - 1) / kBQ);
  return static_cast<int>(min(static_cast<long long>(sms), items));
}

int launch_wide(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int Hkv, int D, int seq_len,
                int causal, int window, float scale, long long q_sb,
                long long q_ss, long long q_sh, long long k_sb,
                long long k_ss, long long k_sh, long long v_sb,
                long long v_ss, long long v_sh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, kBQ) ||
      !make_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, kWideBK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, kWideBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = wide_grid(B, Sq, Hq);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  flash_d256_kernel<<<grid, kWideThreads, kWideSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, D,
      seq_len, causal, window, scale * kLog2e, B);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int seq_len, int causal,
           int window, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh,
           cudaStream_t stream) {
  if (D < 8 || D > kMaxD || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > kNarrowD)
    return launch_wide(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal,
                       window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                       v_sb, v_ss, v_sh, stream);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, kBQ) ||
      !make_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, kBK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // D <= 64: one box (two CTAs an SM); D <= 128: two
  const bool narrow = D <= 64;
  const int smem = narrow ? Ring<1, kD64Stages>::kSmem : Ring<2, 3>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      narrow ? flash_wgmma_d64_kernel : flash_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (narrow)
    flash_wgmma_d64_kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, o, Sq, Sk, Hq, Hkv, D, seq_len, causal, window,
        scale * kLog2e);
  else
    flash_wgmma_kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, o, Sq, Sk, Hq, Hkv, D, seq_len, causal, window,
        scale * kLog2e);
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

// D <= 128 (128 < D <= 256 takes flash_attention_f32_d256)
EXPORT int flash_attention_f32(FLASH_ARGS) {
  return f32::launch(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal,
                     window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                     v_ss, v_sh, stream);
}

// 128 < D <= 256: the pre-pass writes K's and V^T's TF32 terms into
// `scratch`, the caller's, of 2 * B * Hkv * max(1, ceil(Sk / 32)) * 2 * 32
// * 256 floats (kernels/flash_attention.py), then the wgmma kernel reads
// them
EXPORT int flash_attention_f32_d256(FLASH_ARGS, void* scratch) {
  return f32w::launch(q, k, v, out, scratch, B, Sq, Sk, Hq, Hkv, D, seq_len,
                      causal, window, scale, q_sb, q_ss, q_sh, k_sb, k_ss,
                      k_sh, v_sb, v_ss, v_sh, stream);
}

// How the float32 entry launches, for measurement: info[0..3] = CTAs in
// the grid, threads per CTA, dynamic shared memory bytes, CTAs resident
// per SM (the occupancy calculator, after the shared-memory limit is
// raised) of its main kernel.
EXPORT int flash_attention_f32_launch_info(int B, int Sq, int Hq, int D,
                                           int* info) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = D <= kNarrowD;
  cudaError_t err = narrow ? f32::grant_smem() : f32w::grant_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = narrow ? f32::kThreads : f32w::kThreads;
  const int smem =
      narrow ? static_cast<int>(f32::smem_bytes(D)) : f32w::kSmem;
  int per_sm = 0;
  if (narrow)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, f32::flash_f32_kernel, threads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, f32w::flash_f32_d256_kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = narrow ? f32::kBQ : f32w::kBQ;
  info[0] = B * Hq * ((Sq + rows - 1) / rows);
  info[1] = threads;
  info[2] = smem;
  info[3] = per_sm;
  return 0;
}

// How the bf16 entry launches past D 128, for measurement: info[0..4] =
// CTAs in the grid (persistent: at most one an SM), threads per CTA,
// dynamic shared memory bytes, CTAs resident per SM (the occupancy
// calculator) and registers a thread at launch.
EXPORT int flash_attention_bf16_wide_launch_info(int B, int Sq, int Hq,
                                                 int* info) {
  if (B < 1 || Sq < 1 || Hq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::kWideSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wg::flash_d256_kernel, wg::kWideThreads, wg::kWideSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, wg::flash_d256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = wg::wide_grid(B, Sq, Hq);
  info[1] = wg::kWideThreads;
  info[2] = wg::kWideSmem;
  info[3] = per_sm;
  info[4] = fa.numRegs;
  return 0;
}

EXPORT int flash_attention_bf16(FLASH_ARGS) {
  return wg::launch(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal,
                    window, scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                    v_ss, v_sh, stream);
}

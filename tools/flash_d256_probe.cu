// bf16 K8 past D 128 on the card: the streaming floor of its tiles and
// the plans of flash_d256_kernel side by side.  Built and run by
// tools/flash_d256_probe.py (which chip_smoke.py also calls for the
// streaming time), which compiles this file with the port's own nvcc
// flags:
//
//   nvcc -O3 -std=c++17 -Xcompiler -fPIC -Xptxas -v \
//        -gencode arch=compute_90a,code=sm_90a -shared \
//        -I src/repro_torch/kernels/csrc -o libflash_d256_probe.so \
//        tools/flash_d256_probe.cu
//
// It includes csrc/flash_attention.cu for the port's helpers (tensor
// maps, key ranges, the wgmma wrappers, the grid).  The library's
// flash_d256_kernel is one plan, fixed; the variants below are that
// kernel's body with the choices it made open as template knobs, so that
// each can be timed against it in one call (variant 0 is the library's
// plan and must give its bits).
#include "flash_attention.cu"

namespace {
namespace probe {

using namespace wg;

// ---------------------------------------------------------------------------
// clusters: TMA multicast and remote barriers
// ---------------------------------------------------------------------------

// The same box into shared memory at dst of every CTA of the cluster in
// `mask` (bit r: rank r), each CTA's barrier at `bar` told of its bytes:
// one read of L2 for all of them (K8's bf16 kernel past D 128).
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int d,
                                                      int h, int s, int b,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask),
      "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// This CTA's rank in its cluster and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// One arrival on the barrier at `bar` in the shared memory of the
// cluster's CTA `rank` (this one included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// Every thread of the cluster's CTAs meets here: writes before it (TMA
// multicast into a peer, arrivals on a peer's barriers) are done after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the streaming floor
// ---------------------------------------------------------------------------

// The streaming floor of the tiles past D 128: the TMA pattern of the
// earlier D-256 design (flash_wgmma_body at four boxes) with no math.  One
// CTA per (128 q rows, b * Hq + h), that design's grid and key ranges; a
// producer warp loads Q (64 KB) once, then each 64-key
// tile's K and V, four 64-column boxes each (64 KB), into a ring of two
// stages with one full and one empty barrier each; eight consumer warps
// wait for each stage and release it at once.  In clusters of two (q
// heads 2j and 2j + 1) each CTA loads half the boxes of a tile and
// multicasts them into both, so L2 is read once for the pair.
constexpr int kStreamStages = 2;
constexpr int kStreamStage = 8 * kKVChunk;       // K and V: 64 KB
constexpr int kStreamSmem = 1024 + 4 * kQChunk +
                            kStreamStages * kStreamStage +
                            8 * (1 + 2 * kStreamStages);
static_assert(kStreamSmem <= 232448, "flash stream probe smem");

__global__ void __launch_bounds__(kThreads, 1)
flash_stream_kernel(WG_ARGS) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = q_s + 4 * kQChunk;
  const uint32_t q_full = kv_s + kStreamStages * kStreamStage;
  const uint32_t full = q_full + 8, empty = full + 8 * kStreamStages;
  const int ncta = cluster_size();
  const int rank = cluster_rank();
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int lo0, hi0, lo1, hi1;
  key_range(q0, Sq, Sk, seq_len, causal, window, lo0, hi0);
  key_range(q0 + 64, Sq, Sk, seq_len, causal, window, lo1, hi1);
  const int lo = lo0;
  const int hi = max(hi0, hi1);
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStreamStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * ncta);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_barrier();
  if (warp == 8) {
    if (lane == 0) {
      mbar_expect_tx(q_full, 4 * kQChunk);
      for (int c = 0; c < 4; ++c)
        tma_load_4d(q_s + c * kQChunk, &tq, q_full, 64 * c, h, q0, b);
      const int per = 8 / ncta;                 // boxes this CTA loads
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStreamStages;
        if (i >= kStreamStages)
          mbar_wait(empty + 8 * s, (i / kStreamStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, kStreamStage);
        const int kb = lo + i * kBK;
        for (int x = rank * per; x < (rank + 1) * per; ++x) {
          const CUtensorMap* map = x < 4 ? &tk : &tv;
          const uint32_t dst = kv_s + s * kStreamStage + x * kKVChunk;
          if (ncta == 1)
            tma_load_4d(dst, map, full + 8 * s, 64 * (x & 3), hk, kb, b);
          else
            tma_load_4d_multicast(dst, map, full + 8 * s, 64 * (x & 3), hk,
                                  kb, b,
                                  static_cast<uint16_t>((1u << ncta) - 1));
        }
      }
    }
  } else {
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStreamStages;
      mbar_wait(full + 8 * s, (i / kStreamStages) & 1);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + 8 * s);
        if (ncta == 2) mbar_arrive_cluster(empty + 8 * s, rank ^ 1);
      }
    }
  }
  __syncwarp();
  cluster_barrier();
}

// flash_stream_kernel in clusters of `cluster` CTAs (2 needs G even)
int launch_stream(const void* q, const void* k, const void* v, int B,
                  int Sq, int Sk, int Hq, int Hkv, int D, int seq_len,
                  int causal, int window, long long q_sb, long long q_ss,
                  long long q_sh, long long k_sb, long long k_ss,
                  long long k_sh, long long v_sb, long long v_ss,
                  long long v_sh, int cluster, cudaStream_t stream) {
  if (D <= kNarrowD || D > kMaxD || D % 8 != 0 || Hkv < 1 ||
      Hq % Hkv != 0 || (cluster != 1 && cluster != 2) ||
      (cluster == 2 && (Hq / Hkv) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, kBQ) ||
      !make_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, kBK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStreamSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hq, (Sq + kBQ - 1) / kBQ);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kStreamSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_stream_kernel, tq, tk, tv,
                           static_cast<__nv_bfloat16*>(nullptr), Sq, Sk, Hq,
                           Hkv, D, seq_len, causal, window, 0.f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the plans of flash_d256_kernel
// ---------------------------------------------------------------------------

// The plan of a variant of flash_d256_kernel: kBK keys a tile (64 or
// 128), kKS stages of K and kVS of V, each tile four 64-column boxes.
// kPipe issues S(i) and P.V(i - 1) together and waits only for S(i)
// before softmax(i), so P.V(i - 1) runs under softmax(i) (S and P live at once); without it
// a warpgroup runs S(i), softmax(i), P.V(i) as flash_wgmma_body does.
// kPingPong makes the two consumer warpgroups take turns (named barriers)
// to issue their S GEMMs, so one warpgroup's GEMMs run while the other
// does softmax.  kFold keeps S unscaled and folds the scale into the
// exponent's FFMA, with ex2.approx.ftz, as the D <= 64 kernel does.
// kAblate, for where the time goes, leaves parts out: 1 the S GEMMs, 2
// the P.V GEMMs, 4 the softmax, 8 the loads after the first rings' worth.
template <int kBK_, int kKS_, int kVS_, bool kPipe_, bool kPingPong_,
          bool kFold_, int kAblate_ = 0>
struct Wide {
  static constexpr int kBK = kBK_, kKS = kKS_, kVS = kVS_;
  static constexpr bool kPipe = kPipe_, kPingPong = kPingPong_;
  static constexpr bool kFold = kFold_;
  static constexpr int kAblate = kAblate_;
  static constexpr int kBox = kBK * kRowBytes;    // 64 columns of a tile
  static constexpr int kTile = 4 * kBox;          // a K or a V tile
  static constexpr int kQBytes = 4 * kQChunk;     // Q, 128 rows: 64 KB
  static constexpr int kSmem = 1024 + kQBytes + (kKS + kVS) * kTile +
                               8 * (2 + 2 * (kKS + kVS));
  static_assert(kBK == 64 || kBK == 128, "S's wgmma is n64 or n128");
  static_assert(kSmem <= 232448, "flash bf16 d256 smem");
  // setmaxnreg: the producer keeps 40 (at 24 its loop spilled), the
  // consumers 232, or 24 and 240 where the pipeline holds S and P at once;
  // at most 512 a thread triple
  static constexpr int kProducerRegs = kPipe ? 24 : 40;
  static constexpr int kConsumerRegs = kPipe ? 240 : 232;
  static_assert(kProducerRegs + 2 * kConsumerRegs <= 504, "setmaxnreg");
};

// S = Q . K^T over one tile: 4 boxes of D x 4 k-steps, n = kBK keys
template <class C>
__device__ __forceinline__ void var_s(float (&sc)[C::kBK / 2],
                                       uint32_t q_wg, uint32_t kt) {
#pragma unroll
  for (int j = 0; j < C::kBK / 2; ++j) sc[j] = 0.f;
  fence_regs(sc);
  wgmma_fence();
  if constexpr (!(C::kAblate & 1)) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da =
            desc_sw128(q_wg + c * kQChunk + 32 * kk, 16, 1024);
        const uint64_t db =
            desc_sw128(kt + c * C::kBox + 32 * kk, 16, 1024);
        if constexpr (C::kBK == 64)
          wgmma_ss(sc, da, db, (c | kk) != 0);
        else
          wgmma_ss128(sc, da, db, (c | kk) != 0);
      }
  }
  wgmma_commit();
}

// O *= alpha (row r0's, row r1's), then O += P . V over one tile: one
// m64n256k16 a 16-key step, V's four boxes one descriptor apart
template <class C>
__device__ __forceinline__ void var_pv(float (&o)[128],
                                        uint32_t (&pa)[C::kBK / 4],
                                        uint32_t vt, float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < 128; ++j) o[j] *= (j & 2) ? alpha1 : alpha0;
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  if constexpr (!(C::kAblate & 2)) {
#pragma unroll
    for (int t = 0; t < C::kBK / 16; ++t)
      wgmma_rs256(o, pa[4 * t], pa[4 * t + 1], pa[4 * t + 2],
                  pa[4 * t + 3],
                  desc_sw128(vt + t * 16 * kRowBytes, C::kBox, 1024));
  }
  wgmma_commit();
}

// The online softmax of one tile in float32, log2 domain, as
// flash_wgmma_body's (kFold: as its D <= 64 form's): masked on a tile that
// straddles an edge, row maxima by quad shuffles, the new maxima's rescale
// factors in alpha0/1, P packed into pa (bf16 pairs, wgmma's A fragment)
// and per-thread row sums in l0/1.
template <class C>
__device__ __forceinline__ void var_softmax(
    float (&sc)[C::kBK / 2], uint32_t (&pa)[C::kBK / 4], int kb, int qw,
    int r0, int r1, int cq, int seq_len, int causal, int window,
    float scale_log2, float& m0, float& m1, float& l0, float& l1,
    float& alpha0, float& alpha1) {
  if constexpr (C::kAblate & 4) {
    alpha0 = alpha1 = 1.f;
    l0 += sc[0];
    l1 += sc[2];
  } else {
    // kFold masks with -2**100, whose product with the scale is exact
    // (see flash_wgmma_body)
    constexpr float kMasked = C::kFold ? -0x1p100f : kNegInf;
    const bool edge = kb + C::kBK > seq_len ||
                      (causal && kb + C::kBK - 1 > qw) ||
                      (window > 0 && qw + 63 - kb >= window);
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int j = 0; j < C::kBK / 2; ++j) {
      float x = C::kFold ? sc[j] : sc[j] * scale_log2;
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
    if constexpr (C::kFold) {
      alpha0 = exp2_ftz((m0 - mn0) * scale_log2);
      alpha1 = exp2_ftz((m1 - mn1) * scale_log2);
    } else {
      alpha0 = exp2f(m0 - mn0);
      alpha1 = exp2f(m1 - mn1);
    }
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < C::kBK / 2; ++j) {
      const float p = C::kFold ? exp2_ftz(fmaf(sc[j], scale_log2,
                                               -((j & 2) ? ms1 : ms0)))
                               : exp2f(sc[j] - ((j & 2) ? mn1 : mn0));
      sc[j] = p;
      if (j & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }
#pragma unroll
  for (int j = 0; j < C::kBK / 4; ++j)
    pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

// flash_d256_kernel under plan C (Wide<128, 1, 1, false, true, true> is
// the library's).  Persistent: one CTA an SM walks the work items, (128 q
// rows, b * Hq + h), heaviest causal q block first, in a snake over the
// CTAs (nth below).  Warpgroups 0 and 1 consume 64 q rows each, warpgroup 2
// produces (one thread issues TMA).  K and V have rings and barriers of
// their own, counted across items: K(i) is released after S(i), V(i) after
// P.V(i), and Q after a warpgroup's last S of the item, so the next item's
// Q loads under the last P.V and the epilogue.
template <class C>
__global__ void __launch_bounds__(kWideThreads, 1)
variant_kernel(WG_ARGS, int B) {
  constexpr int kBK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                    // [4][128 rows][128 B]
  const uint32_t k_s = q_s + C::kQBytes;        // [kKS][4][kBK][128 B]
  const uint32_t v_s = k_s + C::kKS * C::kTile;  // [kVS][4][kBK][128 B]
  const uint32_t q_full = v_s + C::kVS * C::kTile, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, k_empty = k_full + 8 * C::kKS;
  const uint32_t v_full = k_empty + 8 * C::kKS;
  const uint32_t v_empty = v_full + 8 * C::kVS;

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
    mbar_init(q_empty, 8);                      // the consumer warps
    for (int s = 0; s < C::kKS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
    }
    for (int s = 0; s < C::kVS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: each item's Q once its predecessor's is released, then
    // K(i) and V(i) into their rings, each slot refilled once released ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::kProducerRegs));
    if (warp == 8 && lane == 0) {
      int g = 0;                                // tiles so far, all items
      for (int it = 0, k = nth(0); k < n_items; k = nth(++it)) {
        int b, h, q0, lo, hi0, lo1, hi1, n;
        item(k, b, h, q0);
        wide_tiles<kBK>(q0, Sq, Sk, seq_len, causal, window, lo, hi0, lo1,
                        hi1, n);
        const int hk = h / (Hq / Hkv);
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, C::kQBytes);
        for (int c = 0; c < 4; ++c)
          tma_load_4d(q_s + c * kQChunk, &tq, q_full, 64 * c, h, q0, b);
        for (int i = 0; i < n; ++i, ++g) {
          const int kb = lo + i * kBK;
          const int sk = g % C::kKS, sv = g % C::kVS;
          if (g >= C::kKS) mbar_wait(k_empty + 8 * sk, (g / C::kKS - 1) & 1);
          if ((C::kAblate & 8) && g >= C::kKS + C::kVS) {
            mbar_arrive(k_full + 8 * sk);
            if (g >= C::kVS)
              mbar_wait(v_empty + 8 * sv, (g / C::kVS - 1) & 1);
            mbar_arrive(v_full + 8 * sv);
            continue;
          }
          mbar_expect_tx(k_full + 8 * sk, C::kTile);
          for (int c = 0; c < 4; ++c)
            tma_load_4d(k_s + sk * C::kTile + c * C::kBox, &tk,
                        k_full + 8 * sk, 64 * c, hk, kb, b);
          if (g >= C::kVS) mbar_wait(v_empty + 8 * sv, (g / C::kVS - 1) & 1);
          mbar_expect_tx(v_full + 8 * sv, C::kTile);
          for (int c = 0; c < 4; ++c)
            tma_load_4d(v_s + sv * C::kTile + c * C::kBox, &tv,
                        v_full + 8 * sv, 64 * c, hk, kb, b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 q rows -----------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      C::kConsumerRegs));
  const int wg = warp >> 2;
  const int cq = 2 * (lane & 3);
  const int rw = 16 * (warp & 3) + (lane >> 2);     // row of 64, and + 8
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  // tiles by their count over all items, g
  auto k_tile = [&](int g) { return k_s + (g % C::kKS) * C::kTile; };
  auto v_tile = [&](int g) { return v_s + (g % C::kVS) * C::kTile; };
  auto k_wait = [&](int g) {
    mbar_wait(k_full + 8 * (g % C::kKS), (g / C::kKS) & 1);
  };
  auto v_wait = [&](int g) {
    mbar_wait(v_full + 8 * (g % C::kVS), (g / C::kVS) & 1);
  };
  auto release = [&](uint32_t bar) {    // one arrival a warp
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto k_release = [&](int g) { release(k_empty + 8 * (g % C::kKS)); };
  auto v_release = [&](int g) { release(v_empty + 8 * (g % C::kVS)); };
  // Ping-pong: both warpgroups take n + 1 turns an item, alternating across
  // items; warpgroup 1 gives warpgroup 0 the first turn, and warpgroup 0
  // takes one more after the last item to match warpgroup 1's last pass
  // (per item, warpgroup 1 could pass twice on warpgroup 0's barrier
  // before warpgroup 0 reached it).  No warpgroup waits for a turn while
  // it holds a slot the other's turn needs.
  auto turn_wait = [&]() {
    if constexpr (C::kPingPong)
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    if constexpr (C::kPingPong)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };
  auto skip = [&](int g) {              // a tile none of these rows sees
    k_wait(g);
    turn_wait();
    turn_pass();
    k_release(g);
    v_wait(g);
    v_release(g);
  };
  constexpr float kMasked = C::kFold ? -0x1p100f : kNegInf;

  if (wg == 1) turn_pass();
  int g = 0;                                    // tiles so far, all items
  for (int it = 0, k = nth(0); k < n_items; k = nth(++it)) {
    int b, h, q0, lo, hi0, lo1, hi1, n;
    item(k, b, h, q0);
    wide_tiles<kBK>(q0, Sq, Sk, seq_len, causal, window, lo, hi0, lo1, hi1,
                    n);
    const int qw = q0 + 64 * wg;
    const int r0 = qw + rw, r1 = r0 + 8;
    const int my_lo = wg == 0 ? lo : lo1;
    const int my_hi = wg == 0 ? hi0 : hi1;
    // the item's tiles this warpgroup computes, [ib, ie); it waits for and
    // releases the others without computing
    const int ib = min((my_lo - lo) / kBK, n);
    const int ie =
        my_hi > my_lo ? max(ib, min(n, (my_hi - lo + kBK - 1) / kBK)) : ib;
    float o[128];                       // [64 rows, 256 columns] of O
#pragma unroll
    for (int j = 0; j < 128; ++j) o[j] = 0.f;
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
    float alpha0 = 1.f, alpha1 = 1.f;
    mbar_wait(q_full, it & 1);
    if (ib == ie) release(q_empty);

    for (int i = 0; i < ib; ++i) skip(g + i);
    if constexpr (!C::kPipe) {
      // -- tile i: S(i), softmax(i), P.V(i) ---------------------------------
      for (int i = ib; i < ie; ++i) {
        float sc[kBK / 2];
        uint32_t pa[kBK / 4];
        k_wait(g + i);
        turn_wait();
        var_s<C>(sc, q_wg, k_tile(g + i));
        turn_pass();
        wgmma_wait_all();
        fence_regs(sc);
        k_release(g + i);
        if (i == ie - 1) release(q_empty);
        var_softmax<C>(sc, pa, lo + i * kBK, qw, r0, r1, cq, seq_len,
                        causal, window, scale_log2, m0, m1, l0, l1, alpha0,
                        alpha1);
        v_wait(g + i);
        var_pv<C>(o, pa, v_tile(g + i), alpha0, alpha1);
        wgmma_wait_all();
        fence_regs(o);
        v_release(g + i);
      }
    } else if (ib < ie) {
      float sc[kBK / 2];
      uint32_t pa[kBK / 4];
      // -- tile ib: S, softmax ----------------------------------------------
      k_wait(g + ib);
      turn_wait();
      var_s<C>(sc, q_wg, k_tile(g + ib));
      turn_pass();
      wgmma_wait_all();
      fence_regs(sc);
      k_release(g + ib);
      if (ib == ie - 1) release(q_empty);
      var_softmax<C>(sc, pa, lo + ib * kBK, qw, r0, r1, cq, seq_len, causal,
                      window, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      // -- tile i: S(i) and P.V(i - 1) issued together, softmax(i) under
      // P.V(i - 1) -----------------------------------------------------------
      for (int i = ib + 1; i < ie; ++i) {
        uint32_t pn[kBK / 4];
        k_wait(g + i);
        turn_wait();
        var_s<C>(sc, q_wg, k_tile(g + i));
        v_wait(g + i - 1);
        var_pv<C>(o, pa, v_tile(g + i - 1), alpha0, alpha1);
        turn_pass();
        wgmma_wait<1>();                // S(i) done, P.V(i - 1) may run on
        fence_regs(sc);
        k_release(g + i);
        if (i == ie - 1) release(q_empty);
        var_softmax<C>(sc, pn, lo + i * kBK, qw, r0, r1, cq, seq_len,
                        causal, window, scale_log2, m0, m1, l0, l1, alpha0,
                        alpha1);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        v_release(g + i - 1);
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) pa[j] = pn[j];
      }
      // -- the last P.V -----------------------------------------------------
      turn_wait();
      v_wait(g + ie - 1);
      var_pv<C>(o, pa, v_tile(g + ie - 1), alpha0, alpha1);
      turn_pass();
      wgmma_wait_all();
      fence_regs(o);
      v_release(g + ie - 1);
    }
    for (int i = ie; i < n; ++i) skip(g + i);
    // the turn that the pipeline's last P.V takes, last, so that no
    // warpgroup waits for a turn while it holds a slot
    if (!C::kPipe || ib == ie) {
      turn_wait();
      turn_pass();
    }
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

// variant_kernel<C> on `ctas` CTAs (0: the library's grid, one an SM)
template <class C>
int launch_variant(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int Hkv, int D, int seq_len,
                int causal, int window, float scale, long long q_sb,
                long long q_ss, long long q_sh, long long k_sb,
                long long k_ss, long long k_sh, long long v_sb,
                long long v_ss, long long v_sh, int ctas,
                cudaStream_t stream) {
  if (D <= kNarrowD || D > kMaxD || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, kBQ) ||
      !make_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, C::kBK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, C::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      variant_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>(B) * Hq * ((Sq + kBQ - 1) / kBQ);
  const int grid = ctas > 0 ? static_cast<int>(min(
                                  static_cast<long long>(ctas), items))
                            : wide_grid(B, Sq, Hq);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  variant_kernel<C><<<grid, kWideThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, D,
      seq_len, causal, window, scale * kLog2e, B);
  return static_cast<int>(cudaGetLastError());
}

// the variants, by number
template <class F>
int with_plan(int variant, F&& f) {
  switch (variant) {
    // keys, K stages, V stages, pipeline, ping-pong, fold
    case 0: return f(Wide<128, 1, 1, false, true, true>{});   // the library's
    case 1: return f(Wide<128, 1, 1, false, false, true>{});  // no (a)
    case 2: return f(Wide<128, 1, 1, false, true, false>{});  // unfolded
    case 3: return f(Wide<64, 3, 2, true, false, true>{});    // (b)
    case 4: return f(Wide<64, 3, 2, true, true, true>{});     // (a) + (b)
    case 5: return f(Wide<64, 3, 2, false, false, false>{});  // the parent's
    // parts of the library's plan left out, for where the time goes
    case 6: return f(Wide<128, 1, 1, false, true, true, 4>{});   // softmax
    case 7: return f(Wide<128, 1, 1, false, true, true, 8>{});   // loads
    case 8: return f(Wide<128, 1, 1, false, true, true, 12>{});  // both
    case 9: return f(Wide<128, 1, 1, false, true, true, 15>{});  // all
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace probe
}  // namespace

EXPORT int probe_variants() { return 10; }

// One variant of flash_d256_kernel on `ctas` CTAs (0: the library's
// persistent grid, one an SM)
EXPORT int probe_wide(FLASH_ARGS, int variant, int ctas) {
  return probe::with_plan(variant, [&](auto plan) {
    return probe::launch_variant<decltype(plan)>(
        q, k, v, out, B, Sq, Sk, Hq, Hkv, D, seq_len, causal, window, scale,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, ctas, stream);
  });
}

// The plan of a variant: info[0..3] = keys a tile, K stages, V stages,
// shared memory bytes; info[4..7] = pipeline, ping-pong, parts left out,
// fold.
EXPORT int probe_plan(int variant, int* info) {
  return probe::with_plan(variant, [&](auto plan) {
    using C = decltype(plan);
    info[0] = C::kBK;
    info[1] = C::kKS;
    info[2] = C::kVS;
    info[3] = C::kSmem;
    info[4] = C::kPipe;
    info[5] = C::kPingPong;
    info[6] = C::kAblate;
    info[7] = C::kFold;
    return 0;
  });
}

// The K/V tiles of the earlier D-256 design streamed with no math
// (flash_stream_kernel), in clusters of `cluster` CTAs (2: q heads 2j and
// 2j + 1 read each tile once, by multicast; G must be even); `out` and
// `scale` are not read
EXPORT int probe_stream(FLASH_ARGS, int cluster) {
  return probe::launch_stream(q, k, v, B, Sq, Sk, Hq, Hkv, D, seq_len,
                              causal, window, q_sb, q_ss, q_sh, k_sb, k_ss,
                              k_sh, v_sb, v_ss, v_sh, cluster, stream);
}

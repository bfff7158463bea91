// moe_ffn_bwd's weight gradients on the card: the two routes its dW walk
// could take, side by side, and what wgmma does with TF32 operands.  Built
// and run by tools/moe_bwd_probe.py, which compiles this file with the
// port's own nvcc flags:
//
//   nvcc -O3 -std=c++17 -Xcompiler -fPIC -Xptxas -v \
//        -gencode arch=compute_90a,code=sm_90a -shared \
//        -I src/repro_torch/kernels/csrc -o libmoe_bwd_probe.so \
//        tools/moe_bwd_probe.cu
//
// It includes csrc/moe_ffn_bwd.cu, whose kDw launch (wgmma.m64n128k8 TF32,
// A = x's or dy's rows from registers, B = dg^T, du^T or h^T K-major from
// a TMA ring, each landed B stage's small TF32 term written once in
// shared memory by the producer's warps) is the shipped route.  The
// other route, which lost, is here alone: dW on mma.sync m16n8k8 from the
// row-major [R, FF] intermediates as they lie, in the same persistent
// walk over (expert, product, 128 x 128 tile) units heaviest expert
// first, each 32-row stage landed by cp.async and split once in shared
// memory by all the CTA's threads (big in place, small beside it), the
// warps then reading both terms of their fragments.  Last, the
// consumers' wgmma pattern with nothing else in the way (wgmma_rate).
#include "moe_ffn_bwd.cu"

namespace {
namespace probe {

// ---------------------------------------------------------------------------
// the mma.sync route
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 256;              // 2 x 4 warps of 64 x 32
constexpr int MT = 4, NT = 4;
constexpr int kS = kBM + 8;                // [k][m] and [k][n] row stride
constexpr int kTileF = kBK * kS;           // floats of one tile
constexpr int kStageF = 4 * kTileF;        // A big, A small, B big, B small
constexpr int kSmem = 4 * kStages * kStageF + 4 * (4 * kMaxExperts + 1);
static_assert(kSmem <= 232448, "probe smem");

struct DwArgs {
  const float* x;       // [R, D]
  const float* dy;      // [R, D]
  const float* dg;      // [R, FF]
  const float* du;      // [R, FF]
  const float* h;       // [R, FF]
  const int32_t* offs;  // [E + 1]
  const float* gate;    // [R]
  float* dwg;           // [E, D, FF]
  float* dwu;           // [E, D, FF]
  float* dwd;           // [E, FF, D]
  int R, E, D, FF;
};

// dWg = X^T dg, dWu = X^T du ([D, FF]) and dWd = H^T (c dy) ([FF, D]):
// A [k][m] = x's or h's rows, B [k][n] = dg's, du's or dy's.
__global__ void __launch_bounds__(kThreads, 1) dw_mma_kernel(const DwArgs p) {
  extern __shared__ __align__(16) float smem[];
  int* row0 = reinterpret_cast<int*>(smem + kStages * kStageF);
  int* rows = row0 + kMaxExperts;
  int* order = rows + kMaxExperts;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  for (int e = tid; e < p.E; e += kThreads) {
    row0[e] = p.offs[e];
    rows[e] = max(p.offs[e + 1] - p.offs[e], 0);
  }
  __syncthreads();
  for (int e = tid; e < p.E; e += kThreads) {
    int rank = 0;
    for (int f = 0; f < p.E; ++f)
      rank += rows[f] > rows[e] || (rows[f] == rows[e] && f < e);
    order[rank] = e;
  }
  __syncthreads();
  // every product's gradient is [M, N] = [D, FF] or [FF, D]: same tiles
  const int tiles = cdiv(p.D, kBM) * cdiv(p.FF, kBN);
  const int units = 3 * p.E * tiles;

  struct W { int e, r0, nrows, prod, M, N, m0, n0, kt; };
  auto at = [&](int u) {
    W w;
    const int rank = u / (3 * tiles);
    const int rem = u - rank * 3 * tiles;
    w.prod = rem / tiles;
    const int tile = rem - w.prod * tiles;
    w.e = order[rank];
    w.r0 = row0[w.e];
    w.nrows = rows[w.e];
    w.M = w.prod == 2 ? p.FF : p.D;
    w.N = w.prod == 2 ? p.D : p.FF;
    const int tn = cdiv(w.N, kBN);
    w.m0 = tile / tn * kBM;
    w.n0 = tile % tn * kBN;
    w.kt = cdiv(w.nrows, kBK);
    return w;
  };
  // the load cursor runs kStages - 1 stages ahead, across units
  int lu = blockIdx.x, lkt = 0;
  W lw{};
  auto next_load_unit = [&]() {
    while (lu < units) {
      lw = at(lu);
      if (lw.kt > 0) return;
      lu += gridDim.x;
    }
  };
  next_load_unit();
  auto load = [&](int s) {
    float* As = smem + s * kStageF;
    float* Bs = As + 2 * kTileF;
    const float* a = lw.prod == 2 ? p.h : p.x;
    const float* b = lw.prod == 0 ? p.dg : lw.prod == 1 ? p.du : p.dy;
    const int k0 = lkt * kBK;
    for (int c = tid; c < kBK * kBM / 4; c += kThreads) {
      const int k = c / (kBM / 4), q = (c % (kBM / 4)) * 4;
      const bool ok = k0 + k < lw.nrows && lw.m0 + q < lw.M;
      cp_async16(As + k * kS + q,
                 a + (ok ? static_cast<long long>(lw.r0 + k0 + k) * lw.M +
                               lw.m0 + q
                         : 0),
                 ok);
      const bool okb = k0 + k < lw.nrows && lw.n0 + q < lw.N;
      cp_async16(Bs + k * kS + q,
                 b + (okb ? static_cast<long long>(lw.r0 + k0 + k) * lw.N +
                                lw.n0 + q
                          : 0),
                 okb);
    }
    if (++lkt == lw.kt) {
      lkt = 0;
      lu += gridDim.x;
      next_load_unit();
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (lu < units) load(i);
    cp_async_commit();
  }

  float acc[MT][NT][4];
  int q = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const W w = at(u);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    for (int kt = 0; kt < w.kt; ++kt, ++q) {
      const int s = q % kStages;
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // split the landed stage once: big in place, small beside it
      {
        float* st = smem + s * kStageF;
        const float* cg = p.gate + w.r0 + kt * kBK;
        for (int c = tid; c < 2 * kBK * kBM / 4; c += kThreads) {
          const int isb = c >= kBK * kBM / 4;
          const int cc = c - isb * (kBK * kBM / 4);
          const int k = cc / (kBM / 4), qq = (cc % (kBM / 4)) * 4;
          float* big = st + 2 * isb * kTileF + k * kS + qq;
          float4 v = *reinterpret_cast<float4*>(big);
          if (isb && w.prod == 2) {             // (c dy), as JAX rounds it
            const float cv = kt * kBK + k < w.nrows ? cg[k] : 0.f;
            v.x *= cv; v.y *= cv; v.z *= cv; v.w *= cv;
          }
          uint32_t b4[4], s4[4];
          split_tf32(v.x, b4[0], s4[0]);
          split_tf32(v.y, b4[1], s4[1]);
          split_tf32(v.z, b4[2], s4[2]);
          split_tf32(v.w, b4[3], s4[3]);
          *reinterpret_cast<uint4*>(big) = make_uint4(b4[0], b4[1], b4[2],
                                                      b4[3]);
          *reinterpret_cast<uint4*>(big + kTileF) =
              make_uint4(s4[0], s4[1], s4[2], s4[3]);
        }
      }
      __syncthreads();
      if (lu < units) load((q + kStages - 1) % kStages);
      cp_async_commit();
      const float* Ab = smem + s * kStageF;
      const float* As = Ab + kTileF;
      const float* Bb = As + kTileF;
      const float* Bsm = Bb + kTileF;
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = 64 * wm + 16 * i + g;
          const int o[4] = {(kk + t) * kS + r, (kk + t) * kS + r + 8,
                            (kk + t + 4) * kS + r, (kk + t + 4) * kS + r + 8};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ab[i][c] = __float_as_uint(Ab[o[c]]);
            as[i][c] = __float_as_uint(As[o[c]]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 32 * wn + 8 * j + g;
          bb[j][0] = __float_as_uint(Bb[(kk + t) * kS + col]);
          bb[j][1] = __float_as_uint(Bb[(kk + t + 4) * kS + col]);
          bs[j][0] = __float_as_uint(Bsm[(kk + t) * kS + col]);
          bs[j][1] = __float_as_uint(Bsm[(kk + t + 4) * kS + col]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_3xtf32(part[i][j], ab[i], as[i], bb[j][0], bb[j][1],
                       bs[j][0], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
    }
    float* out = (w.prod == 0 ? p.dwg : w.prod == 1 ? p.dwu : p.dwd) +
                 static_cast<long long>(w.e) * w.M * w.N;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = w.m0 + 64 * wm + 16 * i + g + 8 * h2;
        if (m >= w.M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = w.n0 + 32 * wn + 8 * j + 2 * t;
          if (col >= w.N) continue;
          *reinterpret_cast<float2*>(out + static_cast<long long>(m) * w.N +
                                     col) =
              make_float2(acc[i][j][2 * h2], acc[i][j][2 * h2 + 1]);
        }
      }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// what wgmma.m64n128k8 TF32 does: the operand bits it reads and how it
// rounds its float32 sum (tools/mma_tf32_probe.cu asks mma.sync the same)
// ---------------------------------------------------------------------------

// out[0] = c0 + x . 1 through one wgmma: A's column 0 = x (register
// operand), B's k row 0 = 1 (K-major, 128B swizzle), the rest 0.
__global__ void __launch_bounds__(128) wgmma_one(float x, float c0,
                                                 float* out) {
  __shared__ __align__(1024) float b[128 * 32];
  for (int i = threadIdx.x; i < 128 * 32; i += 128) {
    const int n = i / 32, c = i % 32;
    // element (n, k) sits at n * 32 + ((k / 4) ^ (n % 8)) * 4 + k % 4
    b[i] = ((c / 4) ^ (n % 8)) == 0 && c % 4 == 0 ? 1.f : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int t = threadIdx.x & 3;
  const uint32_t a[4] = {t == 0 ? __float_as_uint(x) : 0u, 0u, 0u, 0u};
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = c0;
  wgmma_fence();
  bwd::wgmma_tf32_rs128(d, a, desc_sw128(smem_u32(b), 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  if (threadIdx.x == 0) out[0] = d[0];
}

// The tensor cores' TF32 rate as the consumers use them: two warpgroups,
// each issuing the 12 wgmma.m64n128k8 of a stage (small.big, big.small,
// big.big over 4 k8 steps, A from registers, B from 128B-swizzled shared
// memory) `iters` times; STAGE_SUMS: each stage from zero, waited for and
// added to the output's sum, as the kernel does; otherwise one chain
// waited for once at the end (the ceiling).
template <bool STAGE_SUMS>
__global__ void __launch_bounds__(256, 1) wgmma_rate(int iters,
                                                     float* out) {
  __shared__ __align__(1024) float b[2][128 * 32];
  for (int i = threadIdx.x; i < 2 * 128 * 32; i += 256)
    (&b[0][0])[i] = 1e-3f * (i & 7);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t ab[4][4], as[4][4];
  for (int k = 0; k < 4; ++k)
    for (int e = 0; e < 4; ++e) {
      ab[k][e] = __float_as_uint(1e-3f * (threadIdx.x + k + e));
      as[k][e] = ab[k][e] & 0x1fff;
    }
  float acc[64], part[64];
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  const uint32_t bb = smem_u32(b[0]), bs = smem_u32(b[1]);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(bb + 32 * kk, 16, 1024);
      const uint64_t ds = desc_sw128(bs + 32 * kk, 16, 1024);
      bwd::wgmma_tf32_rs128(part, as[kk], db,
                            STAGE_SUMS ? kk != 0 : 1);
      bwd::wgmma_tf32_rs128(part, ab[kk], ds, 1);
      bwd::wgmma_tf32_rs128(part, ab[kk], db, 1);
    }
    wgmma_commit();
    if (STAGE_SUMS) {
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }
  wgmma_wait<0>();
  fence_regs(part);
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i] + part[i];
  if (s == 12345.f) out[0] = s;                 // keeps the loop
}

}  // namespace probe
}  // namespace

EXPORT int probe_wgmma_rate(int stage_sums, int iters, void* out,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (stage_sums)
    probe::wgmma_rate<true><<<sm_count(), 256, 0, s>>>(
        iters, static_cast<float*>(out));
  else
    probe::wgmma_rate<false><<<sm_count(), 256, 0, s>>>(
        iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

EXPORT int probe_dw_mma(const void* x, const void* dy, const void* dg,
                        const void* du, const void* h, const void* offs,
                        const void* gate, void* dwg, void* dwu, void* dwd,
                        int R, int E, int D, int FF, void* stream) {
  using namespace probe;
  const DwArgs p{static_cast<const float*>(x),
                 static_cast<const float*>(dy),
                 static_cast<const float*>(dg),
                 static_cast<const float*>(du),
                 static_cast<const float*>(h),
                 static_cast<const int32_t*>(offs),
                 static_cast<const float*>(gate),
                 static_cast<float*>(dwg),
                 static_cast<float*>(dwu),
                 static_cast<float*>(dwd),
                 R, E, D, FF};
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  dw_mma_kernel<<<sm_count(), kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

EXPORT int probe_wgmma_one(float x, float c0, void* out) {
  probe::wgmma_one<<<1, 128>>>(x, c0, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// moe_ffn_bwd: the float32 backward of the grouped SwiGLU expert FFN
// (moe_ffn.cu).
//
// Replaces what XLA derives from the three lax.ragged_dot products of
// repro/models/moe.py::_grouped_ffn when JAX trains an MoE layer (no
// Pallas kernel).  The port needs kernels because a per-expert
// torch.matmul loop reads the group sizes on the host, one device ->
// host sync per MoE layer per backward; these kernels read the group
// offsets on the device.
//
// For sorted row r of expert e (rows offs[e] .. offs[e+1]-1) with gate
// weight c_r and output gradient dy [R, D], from the forward's g = x.Wg[e],
// u = x.Wu[e] and h = silu(g) u (moe_gate_up_f32_train keeps them):
//   t = dy.Wd[e]^T,  dc_r = sum_f h_rf t_rf,  dh = c_r t
//   dg = dh * u * silu'(g),  du = dh * silu(g)
//   dx = dg.Wg[e]^T + du.Wu[e]^T
//   dWg[e] = X_e^T.dg_e,  dWu[e] = X_e^T.du_e,  dWd[e] = H_e^T.(c dy)_e
// Wg/Wu [E, D, FF], Wd [E, FF, D], offs int32 [E + 1], gate float32 [R].
//
// Three launches of one kernel template, in stream order:
//   kDown  t over D (A = dy's rows, B = Wd[e] as it lies); the epilogue
//          forms dg and du from the forward's g and u and writes dg^T,
//          du^T and h^T [FF, Rp] (rows contiguous, each group's from a
//          column that is a multiple of 4, since TMA reads a box from a
//          16-byte aligned inner coordinate) and each row's dc over its
//          128 columns: dc partials [R, ceil(FF / 128)], no atomics;
//   kDx    dx = [dg | du].[Wg | Wu]^T over 2 FF (A = dg^T / du^T read
//          M-major, B = Wg[e] / Wu[e] as they lie); the CTAs of column
//          tile 0 sum each row's dc partials in column order into dgate;
//   kDw    dWg, dWu and dWd^T = (c dy)^T.H, every one [D, FF]-shaped:
//          A = x's or dy's rows read M-major (c applied to dy's), B =
//          dg^T, du^T or h^T, K the group's rows; dWd stored transposed.
// Every B operand is K-major as it lies in device memory, which is what
// wgmma takes for TF32: no transposed copy of the weights.
//
// Design (the H100): every launch walks a persistent grid (one CTA an SM)
// over 128 x 128 output units: kDown and kDx over (expert, row tile,
// column tile) from the unit plan of moe_plan.cuh, kDw over (expert,
// product, tile) with the heaviest experts first (an expert without rows
// stores zeros).  A CTA is three warpgroups: two consumers (64 output
// rows each, wgmma.m64n128k8 TF32 from registers and shared memory) and a
// producer.  In the producer one thread streams A and B tiles of 128 x 32
// (128-byte swizzle) by TMA into a 4-stage ring, each stage as soon as
// the consumers free its slot, and three warps write each landed B
// tile's small TF32 term beside it (the tile itself is the big term),
// zeroing kDw's rows past the group.  The consumers split A at the
// fragment load (registers) and run small.big + big.small + big.big per
// k8 step; a unit's epilogue overlaps the next unit's loads.

// What bounds it: at olmoe's training shape (16384 rows over 64 experts,
// D 2048, FF 1024) the tensor cores: 12 R D FF operations (2 for t, 4
// for dx, 6 for the three dW) over 494.7/3 TFLOP/s in 3xTF32, 2.50 ms;
// the bytes (the weights, dW, x, dy, dx, the forward's g, u, h and the
// three transposed [FF, R] intermediates) take a few percent of that.
// Measured on an H100 80GB HBM3 at 700 W (tools/moe_bwd_lines.py, the
// parent design in the same run): 5.41 ms a call (kDown 0.98, kDx 1.37,
// kDw 2.66), 46 % of the bound; the parent's four mma.sync launches
// with g and u recomputed took 11.90.  The consumers' wgmma pattern
// alone, per-stage sums included, runs at 98 % of the TF32 peak
// (tools/moe_bwd_probe.py), so what is left is the consumers' own work
// between their products: the dgrads' partial row tiles (a group's last
// tile), kDw's short units (a group's ~256 rows, 8-9 stages) and their
// stores.  The loads have their own thread so that a stage's TMA never
// waits on the split of an earlier one, and B splits by truncation so
// that the producer writes one term, not two.
//
// Arithmetic: 3xTF32, big.big + big.small + small.big with float32
// accumulate.  A (registers) splits as split_tf32 does (common.cuh: big
// rounded to nearest); B splits by truncation: its landed float32 tile is
// its big term as the tensor cores read it, and the producer writes only
// the small term x - trunc(x).  Each 32-deep stage's products start from
// zero and are added to the output's float32 sum with one rounded add:
// wgmma rounds its float32 sum toward zero and reads TF32 operands
// truncated (tools/moe_bwd_probe.py, as tools/mma_tf32_probe.cu shows for
// mma.sync).
//
// The bit rules: every output element of dx, dg, du and dgate sees the
// same instruction shape and k walk whatever its group's size or its
// place in the group, so a row's bits depend on the row alone; dW's bits
// depend only on its group's rows in sorted order (no split-K across
// CTAs, no atomics), so a step repeats its bits.
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda

#include "common.cuh"
#include "moe_plan.cuh"

namespace {
namespace bwd {

enum Kind { kDown = 0, kDx = 1, kDw = 2 };

constexpr int kBM = 128;                 // output rows a unit
constexpr int kBN = 128;                 // output columns a unit
constexpr int kBK = 32;                  // reduction depth of a stage
constexpr int kStages = 4;
constexpr int kThreads = 384;            // consumers 0-255, producer 256-383
constexpr int kSplitters = 96;           // the producer's warps 9-11
constexpr int kTile = 128 * kBK * 4;     // 16 KB: A, B, B's small term
constexpr int kBox = 32 * kBK * 4;       // an M-major A box: 32 x 32
constexpr int kStageBytes = 3 * kTile;
constexpr int kSmem = 1024 + kStages * kStageBytes + 3 * 8 * kStages +
                      kPlanBytes + 8 * kMaxExperts + 4 * kStages * kBK;
static_assert(kSmem <= 232448, "moe_ffn_bwd smem");
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

struct Args {
  const int32_t* offs;  // [E + 1]
  const float* gate;    // [R]
  const float* g;       // the forward's g [R, FF]
  const float* u;       // the forward's u [R, FF]
  const float* h;       // the forward's h [R, FF]
  float* dgt;           // dg^T [FF, Rp], group e from column pad0[e]
  float* dut;           // du^T [FF, Rp]
  float* ht;            // h^T [FF, Rp]
  float* part;          // [R, ceil(FF / kBN)]: dc over each column tile
  float* dx;            // [R, D]
  float* dgate;         // [R]
  float* dwg;           // [E, D, FF]
  float* dwu;           // [E, D, FF]
  float* dwd;           // [E, FF, D]
  int Rp, E, D, FF;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// x as the tensor cores read it as a TF32 operand: the low 13 bits cleared
__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// d[64 x 128] (+)= A[64 x 8] . B[8 x 128], TF32, A in registers (a0: row
// g, column t; a1: row g + 8; a2: column t + 4; a3: both), B K-major in
// 128B-swizzled shared memory
__device__ __forceinline__ void wgmma_tf32_rs128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// One unit of work: expert e, its rows r0 .. r0 + nrows - 1 (row-tiled
// kinds: from the tile's first row on; nrows may pass kBM), row r0's
// column c0 in the transposed [FF, Rp] intermediates, output columns
// n0 ..; kDw: product prod, output rows m0 .., K the group.
struct Work {
  int e, r0, c0, nrows, n0, m0, prod, kt;
};

// Warp 0: pad0[e] = the first column of group e in the transposed
// intermediates, each group's rows rounded up to 4 (rows[] from
// plan_units).
__device__ __forceinline__ void pad_columns(const int* rows, int E,
                                            int* pad0) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const int n = e < E ? (rows[e] + 3) & ~3 : 0;
    int x = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += v;
    }
    if (e < E) pad0[e] = carry + x - n;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
}

template <int KIND>
__device__ __forceinline__ Work work_at(const Args& p, const int* start,
                                        const int* row0, const int* rows,
                                        const int* order, const int* pad0,
                                        int u) {
  Work w{};
  if constexpr (KIND == kDw) {
    const int tn = cdiv(p.FF, kBN);
    const int tiles = cdiv(p.D, kBM) * tn;
    const int rank = u / (3 * tiles);
    const int rem = u - rank * 3 * tiles;
    w.prod = rem / tiles;
    const int tile = rem - w.prod * tiles;
    w.e = order[rank];
    w.r0 = row0[w.e];
    w.nrows = rows[w.e];
    w.c0 = pad0[w.e];
    w.m0 = tile / tn * kBM;
    w.n0 = tile % tn * kBN;
    w.kt = cdiv(w.nrows, kBK);
  } else {
    const Unit t = unit_at(start, row0, rows, p.E, kBM, u);
    w.e = t.e;
    w.r0 = t.row;
    w.nrows = t.rows;
    w.c0 = pad0[t.e] + (t.row - row0[t.e]);
    w.n0 = t.n * kBN;
    w.kt = (KIND == kDown ? p.D : 2 * p.FF) / kBK;
  }
  return w;
}

// A 2-d map over a float32 [outer, inner] matrix with row stride `ld`
// elements: boxes of box_x x box_y, 128B swizzle, zero fill past its
// edges.
bool map2d(CUtensorMap* map, const void* ptr, long long inner,
           long long outer, long long ld, int box_x, int box_y) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_x),
                             static_cast<cuuint32_t>(box_y)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Maps a launch reads: kDown ta0 = dy (128-row boxes), tb0 = Wd as
// [E * FF, D]; kDx ta0/ta1 = dg^T/du^T (32 x 32 boxes), tb0/tb1 = Wg/Wu
// as [E * D, FF]; kDw ta0/ta1 = x/dy (32 x 32 boxes), tb0/tb1/tb2 = dg^T,
// du^T, h^T.  Every B box is 32 deep by 128 rows.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_kernel(const __grid_constant__ CUtensorMap ta0,
               const __grid_constant__ CUtensorMap ta1,
               const __grid_constant__ CUtensorMap tb0,
               const __grid_constant__ CUtensorMap tb1,
               const __grid_constant__ CUtensorMap tb2, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;    // the swizzle's period
  const uint32_t bar = base + kStages * kStageBytes;
  auto landed = [&](int s) { return bar + 8 * s; };
  auto full = [&](int s) { return bar + 8 * (kStages + s); };
  auto empty = [&](int s) { return bar + 8 * (2 * kStages + s); };
  int* start = reinterpret_cast<int*>(smem_raw + (bar - raw) +
                                      24 * kStages);
  int* row0 = start + kMaxExperts + 1;
  int* rows = row0 + kMaxExperts;
  int* order = rows + kMaxExperts;
  int* pad0 = order + kMaxExperts;
  float* cs = reinterpret_cast<float*>(pad0 + kMaxExperts);  // [stage][k]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = p.D, FF = p.FF;
  const CUtensorMap* ma0 = &ta0;
  const CUtensorMap* ma1 = &ta1;
  const CUtensorMap* mb0 = &tb0;
  const CUtensorMap* mb1 = &tb1;
  const CUtensorMap* mb2 = &tb2;
  if (warp == 0) {
    plan_units(p.offs, p.E, kBM,
               cdiv(KIND == kDx ? D : FF, kBN), start, row0, rows);
    __syncwarp();
    pad_columns(rows, p.E, pad0);
  }
  if (threadIdx.x == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), kSplitters);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (KIND == kDw) {
    // experts by rows, heaviest first (ties by index)
    for (int e = threadIdx.x; e < p.E; e += kThreads) {
      int rank = 0;
      for (int f = 0; f < p.E; ++f)
        rank += rows[f] > rows[e] || (rows[f] == rows[e] && f < e);
      order[rank] = e;
    }
    __syncthreads();
  }
  const int units = KIND == kDw
                        ? 3 * p.E * cdiv(D, kBM) * cdiv(FF, kBN)
                        : start[p.E];
  auto at = [&](int u) {
    return work_at<KIND>(p, start, row0, rows, order, pad0, u);
  };

  if (warp >= 8) {
    // ---- producer: warp 8's first thread streams the ring (each stage's
    // TMA as soon as its slot is free), warps 9-11 write the small terms
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == 8) {
      if (lane != 0) return;
      int q = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Work w = at(u);
        for (int kt = 0; kt < w.kt; ++kt, ++q) {
          const int s = q % kStages;
          if (q >= kStages) mbar_wait(empty(s), ((q / kStages) - 1) & 1);
          const uint32_t a_s = base + s * kStageBytes;
          const uint32_t b_s = a_s + kTile;
          const int k0 = kt * kBK;
          mbar_expect_tx(landed(s), 2 * kTile);
          if constexpr (KIND == kDown) {
            tma_load_2d(a_s, ma0, landed(s), k0, w.r0);
            tma_load_2d(b_s, mb0, landed(s), k0, w.e * FF + w.n0);
          } else if constexpr (KIND == kDx) {
            const bool up = k0 >= FF;
            const int kk = up ? k0 - FF : k0;
            for (int c = 0; c < 4; ++c)
              tma_load_2d(a_s + c * kBox, up ? ma1 : ma0, landed(s),
                          w.c0 + 32 * c, kk);
            tma_load_2d(b_s, up ? mb1 : mb0, landed(s), kk,
                        w.e * D + w.n0);
          } else {
            for (int c = 0; c < 4; ++c)
              tma_load_2d(a_s + c * kBox, w.prod == 2 ? ma1 : ma0,
                          landed(s), w.m0 + 32 * c, w.r0 + k0);
            tma_load_2d(b_s, w.prod == 0 ? mb0 : w.prod == 1 ? mb1 : mb2,
                        landed(s), w.c0 + k0, w.n0);
          }
        }
      }
      return;
    }
    const int pt = threadIdx.x - 288;            // 0 .. kSplitters - 1
    int q = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = at(u);
      for (int kt = 0; kt < w.kt; ++kt, ++q) {
        const int s = q % kStages;
        mbar_wait(landed(s), (q / kStages) & 1);
        // B's 1024 16-byte chunks.  The landed float32 tile is its own big
        // term (wgmma reads a TF32 operand truncated); the small term
        // x - trunc(x) goes beside it.  kDw's rows past the group, in a
        // group's last stage, become zeros in both.
        uint8_t* b = smem_raw + (base - raw) + s * kStageBytes + kTile;
        const int left = w.nrows - kt * kBK;
        const bool cut = KIND == kDw && left < kBK;
        if (KIND == kDw && pt < kBK)           // the stage's gate weights
          cs[s * kBK + pt] = pt < left ? p.gate[w.r0 + kt * kBK + pt] : 0.f;
#pragma unroll 2
        for (int i = pt; i < kTile / 16; i += kSplitters) {
          float4 v = *reinterpret_cast<float4*>(b + 16 * i);
          if (cut) {
            const int k = 4 * ((i & 7) ^ ((i >> 3) & 7));
            if (k >= left) v.x = 0.f;
            if (k + 1 >= left) v.y = 0.f;
            if (k + 2 >= left) v.z = 0.f;
            if (k + 3 >= left) v.w = 0.f;
            *reinterpret_cast<float4*>(b + 16 * i) = v;
          }
          *reinterpret_cast<float4*>(b + kTile + 16 * i) =
              make_float4(v.x - trunc_tf32(v.x), v.y - trunc_tf32(v.y),
                          v.z - trunc_tf32(v.z), v.w - trunc_tf32(v.w));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 output rows of the unit ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wgi = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ml = 64 * wgi + 16 * w4 + g;        // rows ml, ml + 8 of 128
  float acc[64], part[64];
  int q = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Work w = at(u);
    const bool active = KIND == kDw ? w.m0 + 64 * wgi < D
                                    : 64 * wgi < w.nrows;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < w.kt; ++kt, ++q) {
      const int s = q % kStages;
      mbar_wait(full(s), (q / kStages) & 1);
      if (active) {
        const uint32_t a_s = base + s * kStageBytes;
        const uint32_t b_s = a_s + kTile;
        const float* A = reinterpret_cast<const float*>(smem_raw +
                                                        (a_s - raw));
        const int left = w.nrows - kt * kBK;
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = ml + 8 * (e & 1);
            const int k = 8 * kk + t + 4 * (e >> 1);
            float v;
            if constexpr (KIND == kDown)       // [m][k], K-major
              v = A[m * 32 + (((k >> 2) ^ (m & 7)) << 2) + (k & 3)];
            else                               // [k][m] in 32-wide boxes
              v = A[(m >> 5) * (kBox / 4) + k * 32 +
                    ((((m & 31) >> 2) ^ (k & 7)) << 2) + (m & 3)];
            if constexpr (KIND == kDw) {
              if (k >= left) v = 0.f;
              else if (w.prod == 2)            // (c dy), as JAX rounds it
                v *= cs[s * kBK + k];
            }
            split_tf32(v, ab[kk][e], as[kk][e]);
          }
        // wgmma is .aligned: the warp reconverged after the last unit's
        // epilogue, where some lanes may have run on alone
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bb = desc_sw128(b_s + 32 * kk, 16, 1024);
          const uint64_t bs = desc_sw128(b_s + kTile + 32 * kk, 16, 1024);
          wgmma_tf32_rs128(part, as[kk], bb, kk != 0);
          wgmma_tf32_rs128(part, ab[kk], bs, 1);
          wgmma_tf32_rs128(part, ab[kk], bb, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      mbar_arrive(empty(s));
    }

    // ---- epilogues: rows ml and ml + 8, column pairs 8 j + 2 t --------
    if constexpr (KIND == kDown) {
      const int np = cdiv(FF, kBN);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = ml + 8 * h2;
        const bool in = rr < w.nrows && rr < kBM;
        float dc = 0.f;
        if (in) {
          const long long row = w.r0 + rr;
          const float c = p.gate[row];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = w.n0 + 8 * j + 2 * t;
            if (col >= FF) continue;
            const long long at2 = row * FF + col;
            const float2 gg = *reinterpret_cast<const float2*>(p.g + at2);
            const float2 uu = *reinterpret_cast<const float2*>(p.u + at2);
            const float2 hh = *reinterpret_cast<const float2*>(p.h + at2);
#pragma unroll
            for (int q2 = 0; q2 < 2; ++q2) {
              const float gq = q2 ? gg.y : gg.x;
              const float uq = q2 ? uu.y : uu.x;
              const float hq = q2 ? hh.y : hh.x;
              const float tv = acc[4 * j + 2 * h2 + q2];
              const float sg = 1.f / (1.f + expf(-gq));
              const float a = gq / (1.f + expf(-gq));     // silu, as forward
              dc += hq * tv;
              const float dh = c * tv;
              const long long tp =
                  static_cast<long long>(col + q2) * p.Rp + w.c0 + rr;
              p.dgt[tp] = dh * uq * (sg * (1.f + gq * (1.f - sg)));
              p.dut[tp] = dh * a;
              p.ht[tp] = hq;
            }
          }
        }
        dc += __shfl_xor_sync(0xffffffffu, dc, 1);
        dc += __shfl_xor_sync(0xffffffffu, dc, 2);
        if (in && t == 0)
          p.part[(w.r0 + rr) * static_cast<long long>(np) + w.n0 / kBN] = dc;
      }
    } else if constexpr (KIND == kDx) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = ml + 8 * h2;
        if (rr >= w.nrows || rr >= kBM) continue;
        float* o = p.dx + static_cast<long long>(w.r0 + rr) * D;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = w.n0 + 8 * j + 2 * t;
          if (col >= D) continue;
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
        }
      }
      const int ct = threadIdx.x;                // 0 .. 255
      if (w.n0 == 0 && ct < kBM && ct < w.nrows) {
        const int np = cdiv(FF, kBN);
        const float* pr = p.part + static_cast<long long>(w.r0 + ct) * np;
        float s = 0.f;
        for (int j = 0; j < np; ++j) s += pr[j];
        p.dgate[w.r0 + ct] = s;
      }
    } else {
      if (!active) continue;
      float* out = (w.prod == 0 ? p.dwg : w.prod == 1 ? p.dwu : p.dwd) +
                   static_cast<long long>(w.e) * D * FF;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = w.m0 + ml + 8 * h2;
        if (m >= D) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = w.n0 + 8 * j + 2 * t;
          if (n >= FF) continue;
          const float v0 = acc[4 * j + 2 * h2], v1 = acc[4 * j + 2 * h2 + 1];
          if (w.prod == 2) {                     // dWd [FF, D]
            out[static_cast<long long>(n) * D + m] = v0;
            out[static_cast<long long>(n + 1) * D + m] = v1;
          } else {
            *reinterpret_cast<float2*>(
                out + static_cast<long long>(m) * FF + n) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int KIND>
int launch(const CUtensorMap (&m)[5], const Args& p, cudaStream_t stream) {
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_bwd_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  moe_bwd_kernel<KIND><<<sm_count(), kThreads, kSmem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace

// One launch of entry `kind` (0 down dgrad, 1 x dgrad and dgate, 2 weight
// gradients); the wrapper calls 0-2 in order on one stream.  Shapes the
// wrapper has checked: D and FF multiples of 64, E at most kMaxExperts,
// R >= 1, Rp >= the groups' rows each rounded up to 4 (R + 3 E) and a
// multiple of 4, every base 16-byte aligned, all tensors
// contiguous float32 on the card; g, u, h the forward's [R, FF]; dgt,
// dut, ht [FF, Rp]; part [R, ceil(FF / 128)].
EXPORT int moe_ffn_bwd_f32(int kind, const void* dy, const void* x,
                           const void* offs, const void* wg, const void* wu,
                           const void* wd, const void* gate, const void* g,
                           const void* u, const void* h, void* dgt,
                           void* dut, void* ht, void* part, void* dx,
                           void* dgate, void* dwg, void* dwu, void* dwd,
                           int R, int Rp, int E, int D, int FF,
                           void* stream) {
  using namespace bwd;
  const Args p{static_cast<const int32_t*>(offs),
               static_cast<const float*>(gate),
               static_cast<const float*>(g),
               static_cast<const float*>(u),
               static_cast<const float*>(h),
               static_cast<float*>(dgt),
               static_cast<float*>(dut),
               static_cast<float*>(ht),
               static_cast<float*>(part),
               static_cast<float*>(dx),
               static_cast<float*>(dgate),
               static_cast<float*>(dwg),
               static_cast<float*>(dwu),
               static_cast<float*>(dwd),
               Rp, E, D, FF};
  const long long ed = static_cast<long long>(E) * D;
  const long long ef = static_cast<long long>(E) * FF;
  CUtensorMap m[5];
  bool ok = true;
  switch (kind) {
    case kDown:
      ok = map2d(&m[0], dy, D, R, D, kBK, kBM) &&
           map2d(&m[2], wd, D, ef, D, kBK, kBN);
      m[1] = m[3] = m[4] = m[0];
      break;
    case kDx:
      ok = map2d(&m[0], dgt, Rp, FF, Rp, 32, kBK) &&
           map2d(&m[1], dut, Rp, FF, Rp, 32, kBK) &&
           map2d(&m[2], wg, FF, ed, FF, kBK, kBN) &&
           map2d(&m[3], wu, FF, ed, FF, kBK, kBN);
      m[4] = m[0];
      break;
    case kDw:
      ok = map2d(&m[0], x, D, R, D, 32, kBK) &&
           map2d(&m[1], dy, D, R, D, 32, kBK) &&
           map2d(&m[2], dgt, Rp, FF, Rp, kBK, kBN) &&
           map2d(&m[3], dut, Rp, FF, Rp, kBK, kBN) &&
           map2d(&m[4], ht, Rp, FF, Rp, kBK, kBN);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kDown: return launch<kDown>(m, p, s);
    case kDx: return launch<kDx>(m, p, s);
    default: return launch<kDw>(m, p, s);
  }
}

// ============================================================================
// bf16 entry: the gradient of the bf16 forward (moe_gate_up_bf16_train keeps
// g and u in float32 beside h), on bf16 wgmma with float32 accumulation.
//
// Rounding points are those of the gradient XLA derives from _grouped_ffn
// on bf16 rows and weights: dh = c t is rounded to bf16; dg and du are
// float32 there and are rounded to bf16 here, where they become wgmma
// operands (dy and c dy too); dx = bf16(dg.Wg^T) + bf16(du.Wu^T), the sum
// rounded to bf16; dWg, dWu and dWd leave in bf16; dgate in float32.
//
// Three launches, as the float32 entry's:
//   kDown  t = dy.Wd[e]^T (64-row x 128-column tiles of [R, FF]); the
//          epilogue writes dg and du (bf16 [R, FF]) and each row's dc over
//          its 128 columns: dc partials [R, ceil(FF / 128)], no atomics;
//   kDx    dx over [R, D] tiles from two accumulators; the CTAs of column
//          tile 0 sum each row's dc partials in column order into dgate;
//   kDw    dWg = X^T.dg, dWu = X^T.du, dWd = H^T.(c dy), one CTA a
//          (64 x 128 tile, product, expert), K the group's rows.
// A CTA is one warpgroup.  Each 64-deep stage is staged by every thread
// with plain loads (converted to bf16 and transposed where the operand
// lies M- or N-major in device memory) into 128B-swizzled K-major tiles,
// then four wgmma.m64n128k16; no pipelining.  Row tiles find their
// expert from offs on the device (a CTA per possible tile; the surplus
// exits), so nothing is read on the host.  A simple design: its times
// and bound are in PERF.md.
// ============================================================================
namespace {
namespace b16 {

constexpr int kBM = 64;                  // output rows a CTA
constexpr int kBN = 128;                 // output columns a CTA
constexpr int kBK = 64;                  // reduction depth a stage
constexpr int kThreads = 128;            // one warpgroup
constexpr int kATile = kBM * 128;        // rows of 64 bf16 (128 bytes)
constexpr int kBTile = kBN * 128;
constexpr int kSmem = 1024 + kATile + kBTile;

struct Args {
  const float* dy;             // [R, D]
  const __nv_bfloat16* x;      // [R, D]
  const int32_t* offs;         // [E + 1]
  const __nv_bfloat16* wg;     // [E, D, FF]
  const __nv_bfloat16* wu;     // [E, D, FF]
  const __nv_bfloat16* wd;     // [E, FF, D]
  const float* gate;           // [R]
  const float* g;              // the forward's g [R, FF]
  const float* u;              // the forward's u [R, FF]
  const __nv_bfloat16* h;      // the forward's h [R, FF]
  __nv_bfloat16* dgb;          // dg [R, FF]
  __nv_bfloat16* dub;          // du [R, FF]
  float* part;                 // [R, ceil(FF / kBN)]
  __nv_bfloat16* dx;           // [R, D]
  float* dgate;                // [R]
  __nv_bfloat16* dwg;          // [E, D, FF]
  __nv_bfloat16* dwu;          // [E, D, FF]
  __nv_bfloat16* dwd;          // [E, FF, D]
  int R, E, D, FF;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_k(float (&d)[64], uint64_t da,
                                        uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

// 8 values along k, rounded to bf16, into row `row`'s 16-byte chunk `ch`
// of a K-major tile of 128-byte rows (128B swizzle: the chunk index XORed
// with the row's place in its 8-row atom)
__device__ __forceinline__ void put8(uint8_t* tile, int row, int ch,
                                     const float (&v)[8]) {
  uint4 q;
  q.x = pack_bf16(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
  q.y = pack_bf16(__float2bfloat16(v[2]), __float2bfloat16(v[3]));
  q.z = pack_bf16(__float2bfloat16(v[4]), __float2bfloat16(v[5]));
  q.w = pack_bf16(__float2bfloat16(v[6]), __float2bfloat16(v[7]));
  *reinterpret_cast<uint4*>(tile + row * 128 + ((ch ^ (row & 7)) << 4)) = q;
}

__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
}

// acc[64 x 128] = A[64 x K] . B[K x 128]: la(m, k, v) / lb(n, k, v) give
// the 8 operand values at k .. k + 7 of output row m / column n (zero past
// the operand's edges)
template <class LA, class LB>
__device__ __forceinline__ void gemm(float (&acc)[64], int K, uint8_t* sa,
                                     uint8_t* sb, LA la, LB lb) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t a_s = smem_u32(sa), b_s = smem_u32(sb);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int c = threadIdx.x; c < kBM * 8; c += kThreads) {
      const int row = c % kBM, ch = c / kBM;
      float v[8];
      la(row, k0 + 8 * ch, v);
      put8(sa, row, ch, v);
    }
    for (int c = threadIdx.x; c < kBN * 8; c += kThreads) {
      const int row = c % kBN, ch = c / kBN;
      float v[8];
      lb(row, k0 + 8 * ch, v);
      put8(sb, row, ch, v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t)
      wgmma_k(acc, desc_sw128(a_s + 32 * t, 16, 1024),
              desc_sw128(b_s + 32 * t, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();
  }
}

__device__ __forceinline__ uint8_t* tiles(uint8_t* raw) {
  const uint32_t r = smem_u32(raw);
  return raw + (((r + 1023) & ~1023u) - r);
}

// Row tile t of all experts' groups in order (each group cut into 64-row
// tiles): its expert and rows [r0, r1); false past the last tile.
__device__ bool row_tile(const int32_t* offs, int E, int t, int& e, int& r0,
                         int& r1) {
  __shared__ int s[3];
  if (threadIdx.x == 0) {
    s[0] = -1;
    int acc = 0;
    for (int i = 0; i < E; ++i) {
      const int a = offs[i], b = offs[i + 1];
      const int n = cdiv(b - a, kBM);
      if (t < acc + n) {
        s[0] = i;
        s[1] = a + (t - acc) * kBM;
        s[2] = b;
        break;
      }
      acc += n;
    }
  }
  __syncthreads();
  e = s[0];
  r0 = s[1];
  r1 = min(s[2], r0 + kBM);
  return e >= 0;
}

// accumulator element (row, column) of this thread: rows rr(h2), columns
// cc(j) + q, register 4 j + 2 h2 + q
__device__ __forceinline__ int acc_row(int h2) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h2;
}
__device__ __forceinline__ int acc_col(int j) {
  return 8 * j + 2 * (threadIdx.x & 3);
}

__global__ void __launch_bounds__(kThreads) down_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = tiles(smem_raw);
  uint8_t* sb = sa + kATile;
  int e, r0, r1;
  if (!row_tile(p.offs, p.E, blockIdx.x, e, r0, r1)) return;
  const int n0 = blockIdx.y * kBN, nr = r1 - r0, D = p.D, FF = p.FF;
  float acc[64];
  const __nv_bfloat16* wd = p.wd + static_cast<long long>(e) * FF * D;
  gemm(acc, D, sa, sb,
       [&](int m, int k, float (&v)[8]) {
         if (m < nr) ld8(p.dy + static_cast<long long>(r0 + m) * D + k, v);
         else zero8(v);
       },
       [&](int n, int k, float (&v)[8]) {
         if (n0 + n < FF) ld8(wd + static_cast<long long>(n0 + n) * D + k, v);
         else zero8(v);
       });
  const int nt = cdiv(FF, kBN);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int rr = acc_row(h2);
    const bool live = rr < nr;
    const long long row = r0 + rr;
    float dc = 0.f;
    if (live) {
      const float c = p.gate[row];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + acc_col(j);
        if (col >= FF) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float t = acc[4 * j + 2 * h2 + q];
          const long long o = row * FF + col + q;
          dc += __bfloat162float(p.h[o]) * t;
          const float dh = __bfloat162float(__float2bfloat16(c * t));
          const float gv = p.g[o], uv = p.u[o];
          const float s = 1.f / (1.f + expf(-gv));
          const float be = dh * uv;
          p.dgb[o] = __float2bfloat16(be * s + (gv * be) * (s * (1.f - s)));
          p.dub[o] = __float2bfloat16((gv * s) * dh);
        }
      }
    }
    // a row's 128 columns lie in the four lanes of its quad
    dc += __shfl_xor_sync(0xffffffffu, dc, 1);
    dc += __shfl_xor_sync(0xffffffffu, dc, 2);
    if (live && (threadIdx.x & 3) == 0) p.part[row * nt + blockIdx.y] = dc;
  }
}

__global__ void __launch_bounds__(kThreads) dx_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = tiles(smem_raw);
  uint8_t* sb = sa + kATile;
  int e, r0, r1;
  if (!row_tile(p.offs, p.E, blockIdx.x, e, r0, r1)) return;
  const int n0 = blockIdx.y * kBN, nr = r1 - r0, D = p.D, FF = p.FF;
  const long long wo = static_cast<long long>(e) * D * FF;
  float ag[64], au[64];
  auto rows_of = [&](const __nv_bfloat16* src) {
    return [=](int m, int k, float (&v)[8]) {
      if (m < nr) ld8(src + static_cast<long long>(r0 + m) * FF + k, v);
      else zero8(v);
    };
  };
  auto cols_of = [&](const __nv_bfloat16* w) {
    return [=](int n, int k, float (&v)[8]) {
      if (n0 + n < D) ld8(w + wo + static_cast<long long>(n0 + n) * FF + k, v);
      else zero8(v);
    };
  };
  gemm(ag, FF, sa, sb, rows_of(p.dgb), cols_of(p.wg));
  gemm(au, FF, sa, sb, rows_of(p.dub), cols_of(p.wu));
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int rr = acc_row(h2);
    if (rr >= nr) continue;
    const long long row = r0 + rr;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + acc_col(j);
      if (col >= D) continue;
      const int i = 4 * j + 2 * h2;
      const float a0 = __bfloat162float(__float2bfloat16(ag[i])) +
                       __bfloat162float(__float2bfloat16(au[i]));
      const float a1 = __bfloat162float(__float2bfloat16(ag[i + 1])) +
                       __bfloat162float(__float2bfloat16(au[i + 1]));
      *reinterpret_cast<uint32_t*>(p.dx + row * D + col) =
          pack_bf16(__float2bfloat16(a0), __float2bfloat16(a1));
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < nr) {
    const int nt = cdiv(FF, kBN);
    const long long row = r0 + threadIdx.x;
    float s = 0.f;
    for (int t = 0; t < nt; ++t) s += p.part[row * nt + t];
    p.dgate[row] = s;
  }
}

__global__ void __launch_bounds__(kThreads) dw_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = tiles(smem_raw);
  uint8_t* sb = sa + kATile;
  const int e = blockIdx.z / 3, prod = blockIdx.z % 3;
  const int D = p.D, FF = p.FF;
  const int M = prod == 2 ? FF : D, N = prod == 2 ? D : FF;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  if (m0 >= M || n0 >= N) return;
  const int a = p.offs[e], K = p.offs[e + 1] - a;
  float acc[64];
  if (prod < 2) {
    const __nv_bfloat16* src = prod == 0 ? p.dgb : p.dub;
    gemm(acc, K, sa, sb,
         [&](int m, int k, float (&v)[8]) {     // X^T: x read M-major
#pragma unroll
           for (int i = 0; i < 8; ++i)
             v[i] = k + i < K ? __bfloat162float(
                        p.x[static_cast<long long>(a + k + i) * D + m0 + m])
                              : 0.f;
         },
         [&](int n, int k, float (&v)[8]) {     // dg / du read N-major
#pragma unroll
           for (int i = 0; i < 8; ++i)
             v[i] = k + i < K ? __bfloat162float(
                        src[static_cast<long long>(a + k + i) * FF + n0 + n])
                              : 0.f;
         });
  } else {
    gemm(acc, K, sa, sb,
         [&](int m, int k, float (&v)[8]) {     // H^T
#pragma unroll
           for (int i = 0; i < 8; ++i)
             v[i] = k + i < K ? __bfloat162float(
                        p.h[static_cast<long long>(a + k + i) * FF + m0 + m])
                              : 0.f;
         },
         [&](int n, int k, float (&v)[8]) {     // c dy
#pragma unroll
           for (int i = 0; i < 8; ++i) {
             const long long r = a + k + i;
             v[i] = k + i < K ? p.gate[r] * p.dy[r * D + n0 + n] : 0.f;
           }
         });
  }
  __nv_bfloat16* out = (prod == 0 ? p.dwg : prod == 1 ? p.dwu : p.dwd) +
                       static_cast<long long>(e) * M * N;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int m = m0 + acc_row(h2);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + acc_col(j);
      if (n >= N) continue;
      const int i = 4 * j + 2 * h2;
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(m) * N + n) =
          pack_bf16(__float2bfloat16(acc[i]), __float2bfloat16(acc[i + 1]));
    }
  }
}

}  // namespace b16
}  // namespace

// One launch of the bf16 entry `kind` (0 down dgrad, 1 x dgrad and dgate,
// 2 weight gradients); the wrapper calls 0-2 in order on one stream.
// Shapes the wrapper has checked: D and FF multiples of 64, E at most
// kMaxExperts, R >= 1, offs[E] = R, every base 16-byte aligned, all
// tensors contiguous on the card: dy, gate, g, u, part, dgate float32;
// x, weights, h, dgb, dub, dx and the weight gradients bf16.
EXPORT int moe_ffn_bwd_bf16(int kind, const void* dy, const void* x,
                            const void* offs, const void* wg, const void* wu,
                            const void* wd, const void* gate, const void* g,
                            const void* u, const void* h, void* dgb,
                            void* dub, void* part, void* dx, void* dgate,
                            void* dwg, void* dwu, void* dwd, int R, int E,
                            int D, int FF, void* stream) {
  using namespace b16;
  using bf = __nv_bfloat16;
  const Args p{static_cast<const float*>(dy), static_cast<const bf*>(x),
               static_cast<const int32_t*>(offs), static_cast<const bf*>(wg),
               static_cast<const bf*>(wu), static_cast<const bf*>(wd),
               static_cast<const float*>(gate), static_cast<const float*>(g),
               static_cast<const float*>(u), static_cast<const bf*>(h),
               static_cast<bf*>(dgb), static_cast<bf*>(dub),
               static_cast<float*>(part), static_cast<bf*>(dx),
               static_cast<float*>(dgate), static_cast<bf*>(dwg),
               static_cast<bf*>(dwu), static_cast<bf*>(dwd), R, E, D, FF};
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles_r = cdiv(R, kBM) + E;
  const int wide = D > FF ? D : FF;
  switch (kind) {
    case 0:
      down_kernel<<<dim3(tiles_r, cdiv(FF, kBN)), kThreads, kSmem, s>>>(p);
      break;
    case 1:
      dx_kernel<<<dim3(tiles_r, cdiv(D, kBN)), kThreads, kSmem, s>>>(p);
      break;
    case 2:
      dw_kernel<<<dim3(cdiv(wide, kBM), cdiv(wide, kBN), 3 * E), kThreads,
                  kSmem, s>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A 2-d map over a row-major [outer, inner] matrix of float32 or bf16
// (`dtype`) with row stride `ld` elements: boxes of box_x x box_y, 128B
// swizzle, zero fill past its edges.
bool map2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype,
           long long inner, long long outer, long long ld, int box_x,
           int box_y) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int elem_bytes = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_x),
                             static_cast<cuuint32_t>(box_y)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
constexpr CUtensorMapDataType kBF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

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

// Raises kernel K's dynamic shared memory limit to smem bytes, once.
template <auto K>
cudaError_t grant(int smem) {
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  return cudaSuccess;
}

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
    heaviest_first(rows, p.E, order);
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

template <int KIND>
int launch(const CUtensorMap (&m)[5], const Args& p, cudaStream_t stream) {
  const cudaError_t err = grant<moe_bwd_kernel<KIND>>(kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
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
      ok = map2d(&m[0], dy, kF32, D, R, D, kBK, kBM) &&
           map2d(&m[2], wd, kF32, D, ef, D, kBK, kBN);
      m[1] = m[3] = m[4] = m[0];
      break;
    case kDx:
      ok = map2d(&m[0], dgt, kF32, Rp, FF, Rp, 32, kBK) &&
           map2d(&m[1], dut, kF32, Rp, FF, Rp, 32, kBK) &&
           map2d(&m[2], wg, kF32, FF, ed, FF, kBK, kBN) &&
           map2d(&m[3], wu, kF32, FF, ed, FF, kBK, kBN);
      m[4] = m[0];
      break;
    case kDw:
      ok = map2d(&m[0], x, kF32, D, R, D, 32, kBK) &&
           map2d(&m[1], dy, kF32, D, R, D, 32, kBK) &&
           map2d(&m[2], dgt, kF32, Rp, FF, Rp, kBK, kBN) &&
           map2d(&m[3], dut, kF32, Rp, FF, Rp, kBK, kBN) &&
           map2d(&m[4], ht, kF32, Rp, FF, Rp, kBK, kBN);
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
// Three launches, as the float32 entry's, each over 128-row x 256-column
// output units:
//   kDown  t = dy.Wd[e]^T over [R, FF] (A = dy's float32 rows, rounded to
//          bf16 in registers; B = Wd[e] as it lies); the epilogue writes
//          dg and du (bf16 [R, FF]) and each row's dc over every 128
//          columns: dc partials [R, ceil(FF / 128)], no atomics.  It also
//          writes c dy once, rounded to bf16, into cdy [R, D] for kDw: a
//          unit the stages kt with kt % (its row tile's column tiles) equal
//          to its column tile;
//   kDx    dx over [R, D]: dg.Wg^T over FF, kept in registers as bf16,
//          then du.Wu^T over FF from zero (A = dg or du rows, B = Wg[e] or
//          Wu[e] as they lie); the units of column tile 0 sum each row's dc
//          partials in column order into dgate;
//   kDw    dWg = X^T.dg, dWu = X^T.du, dWd = H^T.(c dy), K the group's
//          rows: A (x or h) read M-major and B (dg, du or cdy) N-major as
//          they lie in their row-major [R, .] matrices, wgmma's transpose
//          flags set, so no thread repacks an operand.
//
// Design (the H100): every launch walks a persistent grid (one CTA an SM):
// kDown and kDx over (expert, row tile, column tile) from the unit plan of
// moe_plan.cuh, kDw over (expert, product, tile) with the heaviest experts
// first (an expert without rows stores zeros).  A CTA is three
// warpgroups: two consumers (64 output rows each, wgmma.m64n256k16 bf16,
// float32 accumulators) and a producer, whose first thread streams 64 x
// 128-byte TMA boxes (128-byte swizzle, zero fill past the matrices'
// edges) into a ring of 64-deep stages (kDown and kDw three, kDx four) as
// soon as the consumers free a slot.  A consumer warpgroup waits on each
// stage's products and frees the slot at once: the other warpgroup's
// products keep the tensor cores busy meanwhile, and the producer gets
// the slot a stage earlier than if one stage stayed in flight (faster at
// both shapes below, on the card).  In kDw the producer's warps 9-11
// zero the rows past the group in a group's last stage (the next group's)
// before the consumers read it, and a unit's dW tile leaves through
// shared memory by TMA stores that run on while the consumers start the
// next unit.  kDown's epilogue reads g, u and h in batches of 24 loads a
// thread.  Rows past the group in a row tile are computed and never
// stored; a warpgroup whose rows all lie past it skips the products.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700.00 W): at olmoe's training
// shape (16384 rows over 64 experts, d 2048, ff 1024) the bytes, 0.611
// ms (the weights read and the weight gradients written, 805 MB each, x,
// dy, g, u, h, dx); operations 0.417 ms (12 R d ff at 989 TFLOP/s).  At
// mixtral's (8192 rows over 8 experts, d 4096, ff 14336) the operations,
// 5.84 ms.  Measured (tools/moe_bwd_lines.py, a CUDA graph of 10 calls;
// the design before it in the same run): olmoe 1.279-1.280 ms a call
// (down dgrad 0.365-0.369, x dgrad 0.349-0.355, dW 0.544-0.546), 48 % of
// its bound, from 6.20-6.21; mixtral 11.40-11.56 (2.70 / 3.07 / 4.80),
// 51 %, from 72.10-72.19.
//
// The bit rules: every output element sums its k16 products in k order
// into one float32 accumulator from zero, whatever its group's size or
// its place in the group, so a row's dx, dg, du and dgate bits depend on
// the row alone; dW's bits depend only on its group's rows in sorted
// order (no split-K across CTAs, no atomics), so a step repeats its bits.
// The outputs equal those of the design before it (one warpgroup a CTA,
// operands staged by plain loads, m64n128k16) bit for bit.
// ============================================================================
namespace {
namespace b16 {

enum Kind { kDown = 0, kDx = 1, kDw = 2 };

constexpr int kBM = 128;                 // output rows a unit
constexpr int kBN = 256;                 // output columns a unit
constexpr int kBK = 64;                  // reduction depth a stage
constexpr int kThreads = 384;            // consumers 0-255, producer 256-383
constexpr int kFixers = 96;              // the producer's warps 9-11 (kDw)
constexpr int kBox = 64 * 128;           // a TMA box: 64 rows of 128 bytes
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// offs' plan (moe_plan.cuh) and kDw's walk order
constexpr int kPlan16 = kPlanBytes + 4 * kMaxExperts;

// A stage of each launch, in boxes: kDown four float32 boxes of dy (two
// 32-column halves of each warpgroup's 64 rows) and four of Wd's rows;
// kDx two boxes of dg's or du's rows and four of Wg's or Wu's; kDw one
// M-major box of x or h per warpgroup and four N-major boxes of dg, du or
// cdy.  kDw adds the 128 x 256 bf16 dW tile its stores leave from, so its
// ring holds three stages; kDx's holds four.
template <int KIND>
struct Plan {
  static constexpr int kStages = KIND == kDx ? 4 : 3;
  static constexpr int kStageBytes = (KIND == kDown ? 8 : 6) * kBox;
  static constexpr int kStoreBytes = KIND == kDw ? 8 * kBox : 0;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kStoreBytes +
                               24 * kStages + kPlan16;
  static_assert(kSmem <= 232448, "moe_ffn_bwd bf16 smem");
};

struct Args {
  const int32_t* offs;         // [E + 1]
  const float* gate;           // [R]
  const float* g;              // the forward's g [R, FF]
  const float* u;              // the forward's u [R, FF]
  const __nv_bfloat16* h;      // the forward's h [R, FF]
  __nv_bfloat16* dgb;          // dg [R, FF]
  __nv_bfloat16* dub;          // du [R, FF]
  __nv_bfloat16* cdy;          // c dy [R, D]
  float* part;                 // [R, ceil(FF / 128)]
  __nv_bfloat16* dx;           // [R, D]
  float* dgate;                // [R]
  int E, D, FF;
};

// kDw's units of one expert: dWg's and dWu's [D, FF] tiles, then dWd's
// [FF, D] ones
__host__ __device__ inline int dw_tiles(int M, int N) {
  return cdiv(M, kBM) * cdiv(N, kBN);
}
__host__ __device__ inline int dw_units(int D, int FF) {
  return 2 * dw_tiles(D, FF) + dw_tiles(FF, D);
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], A and B in shared memory, A
// M-major if TA (else K-major), B N-major if TB (else K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "%127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], A in registers (k16 step KK of
// four: bf16 pairs a[4 KK] row g, k 2t; + 1 row g + 8; + 2 k 2t + 8; + 3
// both), B K-major in shared memory
template <int KK>
__device__ __forceinline__ void wgmma_n256_rs(float (&d)[128],
                                              const uint32_t (&a)[16],
                                              uint64_t db) {
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
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
      : "r"(a[4 * KK]), "r"(a[4 * KK + 1]), "r"(a[4 * KK + 2]),
        "r"(a[4 * KK + 3]), "l"(db), "r"(1));
}

// a 2-d box of `map` from shared memory at src to (x inner, y outer)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup wgi (named barrier 1 + wgi)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// One unit: expert e, its rows r0 .. r0 + rows - 1 (row-tiled kinds: from
// the tile's first row on; rows may pass kBM), column tile n from column
// n0, K in stages of kBK; kDw: product prod, output rows m0 .., its [M, N]
// dW.
struct Work {
  int e, r0, rows, n, n0, m0, M, N, prod, kt;
};

template <int KIND>
__device__ __forceinline__ Work work_at(const Args& p, const int* start,
                                        const int* row0, const int* rows,
                                        const int* order, int u) {
  Work w{};
  if constexpr (KIND == kDw) {
    const int tg = dw_tiles(p.D, p.FF);
    const int per = dw_units(p.D, p.FF);
    const int rank = u / per;
    int rem = u - rank * per;
    w.prod = rem < tg ? 0 : rem < 2 * tg ? 1 : 2;
    rem -= w.prod * tg;
    w.M = w.prod == 2 ? p.FF : p.D;
    w.N = w.prod == 2 ? p.D : p.FF;
    const int tn = cdiv(w.N, kBN);
    w.m0 = rem / tn * kBM;
    w.n0 = rem % tn * kBN;
    w.e = order[rank];
    w.r0 = row0[w.e];
    w.rows = rows[w.e];
    w.kt = cdiv(w.rows, kBK);
  } else {
    const Unit t = unit_at(start, row0, rows, p.E, kBM, u);
    w.e = t.e;
    w.r0 = t.row;
    w.rows = t.rows;
    w.n = t.n;
    w.n0 = t.n * kBN;
    w.kt = (KIND == kDown ? p.D : 2 * p.FF) / kBK;   // kDx: g, then u
  }
  return w;
}

// Maps a launch reads and writes, every box 64 x 128 bytes:
//   kDown  t0 = dy (float32, 32 x 64 boxes), t1 = Wd as [E * FF, D];
//   kDx    t0/t1 = dg/du, t2/t3 = Wg/Wu as [E * D, FF];
//   kDw    t0/t1 = x/h (A), t2/t3/t4 = dg/du/cdy (B), t5/t6/t7 = dWg/dWu
//          as [E * D, FF] and dWd as [E * FF, D] (stores).
template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd16_kernel(const __grid_constant__ CUtensorMap t0,
                 const __grid_constant__ CUtensorMap t1,
                 const __grid_constant__ CUtensorMap t2,
                 const __grid_constant__ CUtensorMap t3,
                 const __grid_constant__ CUtensorMap t4,
                 const __grid_constant__ CUtensorMap t5,
                 const __grid_constant__ CUtensorMap t6,
                 const __grid_constant__ CUtensorMap t7, const Args p) {
  using P = Plan<KIND>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;    // the swizzle's period
  constexpr int kStages = P::kStages;
  const uint32_t stg = base + kStages * P::kStageBytes;   // kDw's stores
  const uint32_t bar = stg + P::kStoreBytes;
  auto landed = [&](int s) { return bar + 8 * s; };
  auto full = [&](int s) { return bar + 8 * (kStages + s); };
  auto empty = [&](int s) { return bar + 8 * (2 * kStages + s); };
  auto at_smem = [&](uint32_t a) { return smem_raw + (a - raw); };
  int* start = reinterpret_cast<int*>(at_smem(bar + 24 * kStages));
  int* row0 = start + kMaxExperts + 1;
  int* rows = row0 + kMaxExperts;
  int* order = rows + kMaxExperts;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = p.D, FF = p.FF;
  if (warp == 0)
    plan_units(p.offs, p.E, kBM,
               KIND == kDw ? 1 : cdiv(KIND == kDown ? FF : D, kBN),
               start, row0, rows);
  if (threadIdx.x == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), kFixers);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (KIND == kDw) {
    heaviest_first(rows, p.E, order);
    __syncthreads();
  }
  const int units = KIND == kDw ? p.E * dw_units(D, FF) : start[p.E];
  auto at = [&](int u) {
    return work_at<KIND>(p, start, row0, rows, order, u);
  };

  if (warp >= 8) {
    // ---- producer: warp 8's first thread streams the ring; in kDw warps
    // 9-11 zero the rows past the group in a group's last stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == 8) {
      if (lane != 0) return;
      int q = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Work w = at(u);
        // the second warpgroup's rows hold some of the unit's
        const int na = (KIND == kDw ? w.m0 + 64 < w.M : w.rows > 64) ? 2 : 1;
        for (int kt = 0; kt < w.kt; ++kt, ++q) {
          const int s = q % kStages;
          if (q >= kStages) mbar_wait(empty(s), ((q / kStages) - 1) & 1);
          const uint32_t st = base + s * P::kStageBytes;
          const int k0 = kt * kBK;
          if constexpr (KIND == kDown) {
            const int nb = min(4, (FF - w.n0) / 64);   // Wd boxes inside FF
            mbar_expect_tx(landed(s), (2 * na + nb) * kBox);
            for (int a = 0; a < na; ++a)
              for (int h = 0; h < 2; ++h)
                tma_load_2d(st + (2 * a + h) * kBox, &t0, landed(s),
                            k0 + 32 * h, w.r0 + 64 * a);
            for (int c = 0; c < nb; ++c)
              tma_load_2d(st + (4 + c) * kBox, &t1, landed(s), k0,
                          w.e * FF + w.n0 + 64 * c);
          } else if constexpr (KIND == kDx) {
            // the gate product's FF / kBK stages, then the up product's
            const bool up = k0 >= FF;
            const int kf = up ? k0 - FF : k0;
            const int nb = min(4, (D - w.n0) / 64);
            mbar_expect_tx(landed(s), (na + nb) * kBox);
            for (int a = 0; a < na; ++a)
              tma_load_2d(st + a * kBox, up ? &t1 : &t0, landed(s), kf,
                          w.r0 + 64 * a);
            for (int c = 0; c < nb; ++c)
              tma_load_2d(st + (2 + c) * kBox, up ? &t3 : &t2, landed(s), kf,
                          w.e * D + w.n0 + 64 * c);
          } else {
            const int nb = min(4, (w.N - w.n0) / 64);
            const CUtensorMap* ma = w.prod == 2 ? &t1 : &t0;
            const CUtensorMap* mb = w.prod == 0 ? &t2 : w.prod == 1 ? &t3
                                                                    : &t4;
            mbar_expect_tx(landed(s), (na + nb) * kBox);
            for (int a = 0; a < na; ++a)
              tma_load_2d(st + a * kBox, ma, landed(s), w.m0 + 64 * a,
                          w.r0 + k0);
            for (int c = 0; c < nb; ++c)
              tma_load_2d(st + (2 + c) * kBox, mb, landed(s),
                          w.n0 + 64 * c, w.r0 + k0);
          }
        }
      }
      return;
    }
    if constexpr (KIND == kDw) {
      const int ft = threadIdx.x - 288;            // 0 .. kFixers - 1
      int q = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Work w = at(u);
        for (int kt = 0; kt < w.kt; ++kt, ++q) {
          const int s = q % kStages;
          mbar_wait(landed(s), (q / kStages) & 1);
          const int left = w.rows - kt * kBK;
          if (left < kBK) {
            // a k row is a box's 128-byte line (the swizzle moves chunks
            // within a line): lines left .. 63 of all six boxes to zero
            uint8_t* st = at_smem(base + s * P::kStageBytes);
            const int n16 = (kBK - left) * 8;
            for (int i = ft; i < 6 * n16; i += kFixers) {
              const int b = i / n16;
              *reinterpret_cast<uint4*>(st + b * kBox + left * 128 +
                                        16 * (i - b * n16)) =
                  make_uint4(0u, 0u, 0u, 0u);
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          }
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 output rows of the unit ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wgi = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ml = 16 * (warp & 3) + g;      // rows ml, ml + 8 of the 64
  const int rr0 = 64 * wgi + ml;           // ... of the unit's 128
  int q = 0;

  if constexpr (KIND == kDown) {
    const int nt = cdiv(FF, kBN);            // column tiles a row tile
    const int np = cdiv(FF, 128);            // dc partials a row
    float acc[128];
    uint32_t a[16];                          // a stage's A fragments
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = at(u);
      const bool active = 64 * wgi < w.rows;
      const bool live0 = rr0 < w.rows, live1 = rr0 + 8 < w.rows;
      const float c0 = live0 ? p.gate[w.r0 + rr0] : 0.f;
      const float c1 = live1 ? p.gate[w.r0 + rr0 + 8] : 0.f;
      __nv_bfloat16* cd = p.cdy + static_cast<long long>(w.r0 + rr0) * D;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < w.kt; ++kt, ++q) {
        const int s = q % kStages;
        mbar_wait(landed(s), (q / kStages) & 1);
        if (!active) {
          mbar_arrive(empty(s));
          continue;
        }
        const uint32_t st = base + s * P::kStageBytes;
        const uint8_t* A = at_smem(st + 2 * wgi * kBox);
        const bool wc = kt % nt == w.n;       // this unit's share of c dy
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // A fragment e: row ml (+ 8 if e odd), k 2t (+ 8 if e > 1) of
            // k16 step kk, from the float32 box of its 32 columns
            const int m = ml + 8 * (e & 1);
            const int k = 16 * kk + 2 * t + 8 * (e >> 1);
            const float2 v = *reinterpret_cast<const float2*>(
                A + (k >> 5) * kBox + m * 128 +
                ((((k & 31) >> 2) ^ (m & 7)) << 4) + 4 * (k & 3));
            a[4 * kk + e] = pack_bf16(__float2bfloat16(v.x),
                                      __float2bfloat16(v.y));
            if (wc && ((e & 1) ? live1 : live0)) {
              const float c = (e & 1) ? c1 : c0;
              *reinterpret_cast<uint32_t*>(
                  cd + (e & 1) * 8 * static_cast<long long>(D) + kt * kBK +
                  k) = pack_bf16(__float2bfloat16(c * v.x),
                                 __float2bfloat16(c * v.y));
            }
          }
        // wgmma is .aligned: the warp reconverged after the c dy stores
        __syncwarp();
        fence_regs(acc);
        fence_regs(a);
        wgmma_fence();
        const uint32_t b = st + 4 * kBox;
        wgmma_n256_rs<0>(acc, a, desc_sw128(b, 16, 1024));
        wgmma_n256_rs<1>(acc, a, desc_sw128(b + 32, 16, 1024));
        wgmma_n256_rs<2>(acc, a, desc_sw128(b + 64, 16, 1024));
        wgmma_n256_rs<3>(acc, a, desc_sw128(b + 96, 16, 1024));
        wgmma_commit();
        // a's registers and the slot free once the products are done
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(a);
        mbar_arrive(empty(s));
      }

      // ---- epilogue: rows rr0 and rr0 + 8, column pairs 8 j + 2 t of
      // each 128-column half, dc over each half.  FF is a multiple of 64,
      // so a half holds 16 or 8 column octets (j); each batch of 8 issues
      // its 24 loads of g, u and h before it computes.
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int cb = w.n0 + 128 * ph;
        if (cb >= FF) continue;                  // the same for the warp
        const int nb = cb + 128 <= FF ? 2 : 1;   // batches of 8 octets
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int rr = rr0 + 8 * h2;
          const bool live = rr < w.rows;
          const long long row = w.r0 + rr;
          float dc = 0.f;
          if (live) {
            const float c = p.gate[row];
#pragma unroll
            for (int jb = 0; jb < 2; ++jb) {
              if (jb >= nb) break;
              const long long o0 = row * FF + cb + 64 * jb + 2 * t;
              float2 gg[8], uu[8];
              __nv_bfloat162 hh[8];
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                gg[jj] = __ldg(reinterpret_cast<const float2*>(p.g + o0 +
                                                               8 * jj));
                uu[jj] = __ldg(reinterpret_cast<const float2*>(p.u + o0 +
                                                               8 * jj));
                hh[jj] = *reinterpret_cast<const __nv_bfloat162*>(p.h + o0 +
                                                                  8 * jj);
              }
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                __nv_bfloat16 dg2[2], du2[2];
#pragma unroll
                for (int q2 = 0; q2 < 2; ++q2) {
                  const float tv =
                      acc[4 * (16 * ph + 8 * jb + jj) + 2 * h2 + q2];
                  dc += (q2 ? __high2float(hh[jj]) : __low2float(hh[jj])) *
                        tv;
                  const float dh =
                      __bfloat162float(__float2bfloat16(c * tv));
                  const float gv = q2 ? gg[jj].y : gg[jj].x;
                  const float uv = q2 ? uu[jj].y : uu[jj].x;
                  const float sg = 1.f / (1.f + expf(-gv));
                  const float be = dh * uv;
                  dg2[q2] = __float2bfloat16(be * sg +
                                             (gv * be) * (sg * (1.f - sg)));
                  du2[q2] = __float2bfloat16((gv * sg) * dh);
                }
                *reinterpret_cast<uint32_t*>(p.dgb + o0 + 8 * jj) =
                    pack_bf16(dg2[0], dg2[1]);
                *reinterpret_cast<uint32_t*>(p.dub + o0 + 8 * jj) =
                    pack_bf16(du2[0], du2[1]);
              }
            }
          }
          // a row's 128 columns lie in the four lanes of its quad
          dc += __shfl_xor_sync(0xffffffffu, dc, 1);
          dc += __shfl_xor_sync(0xffffffffu, dc, 2);
          if (live && t == 0) p.part[row * np + cb / 128] = dc;
        }
      }
    }
  } else if constexpr (KIND == kDx) {
    float acc[128];
    uint32_t kept[64];     // bf16(dg.Wg^T) in pairs while du.Wu^T runs
    const int ct = threadIdx.x;                // 0 .. 255
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = at(u);
      const bool active = 64 * wgi < w.rows;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < w.kt; ++kt, ++q) {
        const int s = q % kStages;
        mbar_wait(landed(s), (q / kStages) & 1);
        if (!active) {
          mbar_arrive(empty(s));
          continue;
        }
        const uint32_t st = base + s * P::kStageBytes;
        __syncwarp();
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n256<0, 0>(acc,
                           desc_sw128(st + wgi * kBox + 32 * kk, 16, 1024),
                           desc_sw128(st + 2 * kBox + 32 * kk, 16, 1024));
        wgmma_commit();
        // the slot back as soon as its products are done (the other
        // warpgroup's keep the tensor cores busy meanwhile)
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(s));
        if (kt == w.kt / 2 - 1) {
          // dg.Wg^T is whole: keep it in bf16, du.Wu^T from zero
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            kept[i] = pack_bf16(__float2bfloat16(acc[2 * i]),
                                __float2bfloat16(acc[2 * i + 1]));
            acc[2 * i] = acc[2 * i + 1] = 0.f;
          }
        }
      }
      // ---- epilogue: dx = bf16(bf16(dg.Wg^T) + bf16(du.Wu^T)) ----------
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = rr0 + 8 * h2;
        if (rr >= w.rows) continue;
        __nv_bfloat16* o = p.dx + static_cast<long long>(w.r0 + rr) * D;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = w.n0 + 8 * j + 2 * t;
          if (col >= D) continue;
          const int i = 4 * j + 2 * h2;
          // a bf16's float32 value: its 16 bits on top
          const float a0 = __uint_as_float(kept[i / 2] << 16) +
                           __bfloat162float(__float2bfloat16(acc[i]));
          const float a1 = __uint_as_float(kept[i / 2] & 0xffff0000u) +
                           __bfloat162float(__float2bfloat16(acc[i + 1]));
          *reinterpret_cast<uint32_t*>(o + col) =
              pack_bf16(__float2bfloat16(a0), __float2bfloat16(a1));
        }
      }
      if (w.n0 == 0 && ct < kBM && ct < w.rows) {
        const int np = cdiv(FF, 128);
        const long long row = w.r0 + ct;
        float sum = 0.f;
        for (int j = 0; j < np; ++j) sum += p.part[row * np + j];
        p.dgate[row] = sum;
      }
    }
  } else {
    float acc[128];
    const uint32_t out = stg + wgi * 4 * kBox;   // this warpgroup's 64 rows
    uint8_t* outp = at_smem(out);
    const bool lead = (threadIdx.x & 127) == 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = at(u);
      const bool active = w.m0 + 64 * wgi < w.M;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < w.kt; ++kt, ++q) {
        const int s = q % kStages;
        mbar_wait(full(s), (q / kStages) & 1);
        if (!active) {
          mbar_arrive(empty(s));
          continue;
        }
        const uint32_t st = base + s * P::kStageBytes;
        __syncwarp();
        fence_regs(acc);
        wgmma_fence();
        // a k16 step is 16 of a box's 128-byte lines; B's four 64-column
        // boxes one box apart
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n256<1, 1>(acc,
                        desc_sw128(st + wgi * kBox + 2048 * kk, kBox, 1024),
                        desc_sw128(st + 2 * kBox + 2048 * kk, kBox, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(s));
      }
      if (!active) continue;
      // ---- epilogue: the tile in bf16 into its four 64 x 64 boxes
      // (128-byte swizzle), then TMA stores that run on into the next unit
      if (lead) bulk_wait_read();    // the last unit's stores have read it
      wg_sync(wgi);
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = ml + 8 * h2;
          *reinterpret_cast<uint32_t*>(
              outp + (j >> 3) * kBox + r * 128 +
              ((((j & 7) ^ (r & 7)) << 4) | (4 * t))) =
              pack_bf16(__float2bfloat16(acc[4 * j + 2 * h2]),
                        __float2bfloat16(acc[4 * j + 2 * h2 + 1]));
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wgi);
      if (lead) {
        const CUtensorMap* mo = w.prod == 0 ? &t5 : w.prod == 1 ? &t6 : &t7;
        const int y = w.e * w.M + w.m0 + 64 * wgi;
        for (int c = 0; c < 4 && w.n0 + 64 * c < w.N; ++c)
          tma_store_2d(mo, out + c * kBox, w.n0 + 64 * c, y);
        bulk_commit();
      }
    }
    if (lead) bulk_wait();
  }
}

template <int KIND>
int launch(const CUtensorMap (&m)[8], const Args& p, cudaStream_t stream) {
  const cudaError_t err = grant<moe_bwd16_kernel<KIND>>(Plan<KIND>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_bwd16_kernel<KIND><<<sm_count(), kThreads, Plan<KIND>::kSmem,
                           stream>>>(m[0], m[1], m[2], m[3], m[4], m[5],
                                     m[6], m[7], p);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_info(int* info) {
  const cudaError_t err = grant<moe_bwd16_kernel<KIND>>(Plan<KIND>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, moe_bwd16_kernel<KIND>, kThreads, Plan<KIND>::kSmem);
  if (occ != cudaSuccess) return static_cast<int>(occ);
  const int v[7] = {sm_count(), kThreads, Plan<KIND>::kSmem, per_sm,
                    Plan<KIND>::kStages, kBM, kBN};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}

}  // namespace b16
}  // namespace

// One launch of the bf16 entry `kind` (0 down dgrad, 1 x dgrad and dgate,
// 2 weight gradients); the wrapper calls 0-2 in order on one stream.
// Shapes the wrapper has checked: D and FF multiples of 64, E at most
// kMaxExperts, R >= 1, offs[E] = R, every base 16-byte aligned, all
// tensors contiguous on the card: dy, gate, g, u, part, dgate float32;
// x, weights, h, dgb, dub, cdy, dx and the weight gradients bf16.
EXPORT int moe_ffn_bwd_bf16(int kind, const void* dy, const void* x,
                            const void* offs, const void* wg, const void* wu,
                            const void* wd, const void* gate, const void* g,
                            const void* u, const void* h, void* dgb,
                            void* dub, void* cdy, void* part, void* dx,
                            void* dgate, void* dwg, void* dwu, void* dwd,
                            int R, int E, int D, int FF, void* stream) {
  using namespace b16;
  using bf = __nv_bfloat16;
  const Args p{static_cast<const int32_t*>(offs),
               static_cast<const float*>(gate),
               static_cast<const float*>(g),
               static_cast<const float*>(u),
               static_cast<const bf*>(h),
               static_cast<bf*>(dgb),
               static_cast<bf*>(dub),
               static_cast<bf*>(cdy),
               static_cast<float*>(part),
               static_cast<bf*>(dx),
               static_cast<float*>(dgate),
               E, D, FF};
  const long long ed = static_cast<long long>(E) * D;
  const long long ef = static_cast<long long>(E) * FF;
  CUtensorMap m[8];
  bool ok = true;
  switch (kind) {
    case kDown:
      ok = map2d(&m[0], dy, kF32, D, R, D, 32, 64) &&
           map2d(&m[1], wd, kBF16, D, ef, D, 64, 64);
      for (int i = 2; i < 8; ++i) m[i] = m[0];
      break;
    case kDx:
      ok = map2d(&m[0], dgb, kBF16, FF, R, FF, 64, 64) &&
           map2d(&m[1], dub, kBF16, FF, R, FF, 64, 64) &&
           map2d(&m[2], wg, kBF16, FF, ed, FF, 64, 64) &&
           map2d(&m[3], wu, kBF16, FF, ed, FF, 64, 64);
      for (int i = 4; i < 8; ++i) m[i] = m[0];
      break;
    case kDw:
      ok = map2d(&m[0], x, kBF16, D, R, D, 64, 64) &&
           map2d(&m[1], h, kBF16, FF, R, FF, 64, 64) &&
           map2d(&m[2], dgb, kBF16, FF, R, FF, 64, 64) &&
           map2d(&m[3], dub, kBF16, FF, R, FF, 64, 64) &&
           map2d(&m[4], cdy, kBF16, D, R, D, 64, 64) &&
           map2d(&m[5], dwg, kBF16, FF, ed, FF, 64, 64) &&
           map2d(&m[6], dwu, kBF16, FF, ed, FF, 64, 64) &&
           map2d(&m[7], dwd, kBF16, D, ef, D, 64, 64);
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

// How launch `kind` of the bf16 entry runs, for measurement: info[0..6] =
// CTAs in the grid, threads per CTA, dynamic shared memory bytes, CTAs
// resident per SM (the occupancy calculator, after the limit is raised),
// ring stages, rows a unit, columns a unit.
EXPORT int moe_ffn_bwd_bf16_launch_info(int kind, int* info) {
  using namespace b16;
  switch (kind) {
    case kDown: return launch_info<kDown>(info);
    case kDx: return launch_info<kDx>(info);
    case kDw: return launch_info<kDw>(info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// moe_ffn: the grouped SwiGLU expert FFN of a mixture-of-experts layer.
//
// Replaces what the JAX package leaves to XLA: the three lax.ragged_dot
// products of repro/models/moe.py::_grouped_ffn (no Pallas kernel).  The
// port needs a kernel because a per-expert torch.matmul loop needs the
// group sizes on the host, one device -> host sync per MoE layer per
// decode step; these kernels read the group offsets on the device.
//
// What it computes, for rows sorted by expert x [R, D] (group e holds
// rows offs[e] .. offs[e+1]-1):
//   moe_gate_up: h = silu(x.Wg[e]) * (x.Wu[e]), products and silu in
//                float32, h rounded to the input type (JAX's
//                (act(g) * u).astype(xg.dtype));           h [R, FF]
//   moe_down:    y = (h.Wd[e]) * gate[r] in float32;       y [R, D]
// Wg/Wu [E, D, FF], Wd [E, FF, D], offs int32 [E + 1], gate float32 [R].
//
// What bounds it on the H100: in decode, the expert weights it reads
// (each touched expert's 3 x D x FF elements once; a few rows a group):
// bytes.  In a long prefill (mixtral's ~1040 rows a group), the tensor
// cores: 6 R D FF operations over 989 TFLOP/s in bf16, over 494.7/3 in
// float32 (3xTF32).
//
// Work: both entries walk a persistent grid (one CTA per SM) over units
// of (expert, column tile, row tile), only for the experts that have
// rows.  Every CTA reads offs itself and lays the units out in shared
// memory (a prefix sum of the row tiles), so nothing is read on the
// host and a CUDA graph can capture the launch.  Row tiles run fastest,
// so the CTAs that run together share one column tile of the weights
// (read once from HBM, the other row tiles hit L2).  A CTA's loads run
// on across its units: the next unit's tiles stream in while the last
// one's epilogue stores.  A row tile may reach rows of the next group,
// or zero-filled rows past R: those rows are computed and never stored.
// Warps (warpgroups) whose rows all lie past the group skip the products
// (a decode group holds one or two rows) but still take part in the ring.
//
// bf16 entry, wgmma from TMA-loaded tiles: a unit is 128 rows (one m64
// tile per consumer warpgroup) by 128 columns of h (gate and up: two
// accumulators over the same A tile, silu(g) * u applied in float32 in
// the epilogue) or 256 columns of y (down: two accumulators side by
// side).  A producer warp keeps a ring of 4 stages in flight, each 64
// deep in the reduction: one 64-row box of the rows per active
// warpgroup (128-byte swizzle, K-major) and four 64 x 64 boxes of the
// weights, read MN-major as they lie ([E * D, FF] and [E * FF, D]
// views; wgmma transposes 16-bit B operands).  Each k16 step is
// wgmma.m64n128k16 per accumulator; one stage's group stays in flight
// while the next is issued.
//
// float32 entry, 3xTF32 on mma.sync.m16n8k8 (split_tf32 and the product
// order of mma_3xtf32, common.cuh): a unit is 128 weight columns (64 of
// gate and the same 64 of up, or 128 of down) by 128 rows (8 warps of
// 64 x 32, a 3-stage cp.async ring 64 deep) or, while the rows average
// at most 32 a group, by 16 rows (4 warps of 16 x 32, three CTAs an SM:
// a decode step is bound by the latency of each warp's mma.sync chain).
// Both tilings take the same instruction, k walk and sums, so a row's
// bits are the same in either.  wgmma takes TF32 only
// K-major and the weights are N-major, so mma.sync reads them in place
// (no transposed copy).  mma.sync rounds its float32 sum toward zero, so
// each stage's products start from zero and are added to the output's
// float32 sum with one rounded add: over FF = 14336 one accumulator fed
// by every mma.sync would drift by ~1e-4 of |y|.
//
// The bit rule: every output element sees the same instruction shape and
// the same k walk whatever the group size, R or the row's place in its
// tile (no split-K, no size-dependent path), so a row's bits depend on
// neither its neighbours, its group size nor its place in the group.
#include "common.cuh"
#include "moe_plan.cuh"

namespace {

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

// ============================================================================
// bf16: wgmma from TMA-loaded tiles
// ============================================================================

namespace wg {

constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kBM = 64 * kConsumers;            // rows a unit
constexpr int kBN = 128;                        // columns an accumulator
constexpr int kBK = 64;                         // reduction depth a stage
constexpr int kStages = 4;
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBox = 64 * 128;                  // 64 rows of 128 bytes
constexpr int kBBoxes = 2 * kBN / 64;           // weight boxes a stage
constexpr int kStageBytes = (kConsumers + kBBoxes) * kBox;
constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages +
                      kPlanBytes;
static_assert(kSmem <= 232448, "moe_ffn bf16 smem");

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A K-major, B MN-major (the
// transpose flag), both from 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 1;\n}\n"
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

// GLU: out = h (bf16) from the gate (tb0) and up (tb1) products over the
// same 128 columns; otherwise out = y (float32) from 256 columns of tb0,
// scaled by the row's gate weight.  KEEP (GLU, the training forward): the
// float32 products g and u [R, N] stored beside h.
template <bool GLU, bool KEEP = false>
__global__ void __launch_bounds__(kThreads, 1)
moe_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb0,
                 const __grid_constant__ CUtensorMap tb1,
                 const int32_t* __restrict__ offs,
                 const float* __restrict__ gate, void* __restrict__ out,
                 int E, int K, int N, float* __restrict__ gk,
                 float* __restrict__ uk) {
  extern __shared__ uint8_t smem_raw[];
  // 128B swizzle repeats every 1024 B: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar = base + kStages * kStageBytes;   // full[], empty[]
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  int* start = reinterpret_cast<int*>(smem_raw + (bar - raw) + 16 * kStages);
  int* row0 = start + kMaxExperts + 1;
  int* rows = row0 + kMaxExperts;

  constexpr int kCols = GLU ? kBN : 2 * kBN;    // output columns a unit
  const int nt = (N + kCols - 1) / kCols;
  const int KT = K / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) plan_units(offs, E, kBM, nt, start, row0, rows);
  if (threadIdx.x == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int units = start[E];

  if (warp == 4 * kConsumers) {
    // ---- producer: the rows' and the weights' boxes of every stage ----
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at(start, row0, rows, E, kBM, u);
        const int na = w.rows > 64 ? 2 : 1;     // row boxes with rows
        const int wrow = w.e * K;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
          const uint32_t st = base + s * kStageBytes;
          mbar_expect_tx(full(s), (na + kBBoxes) * kBox);
          for (int a = 0; a < na; ++a)
            tma_load_2d(st + a * kBox, &ta, full(s), kt * kBK, w.row + 64 * a);
          for (int b = 0; b < kBBoxes; ++b) {
            const uint32_t dst = st + (kConsumers + b) * kBox;
            if (GLU)
              tma_load_2d(dst, b < 2 ? &tb0 : &tb1, full(s),
                          w.n * kBN + 64 * (b & 1), wrow + kt * kBK);
            else
              tma_load_2d(dst, &tb0, full(s), w.n * 2 * kBN + 64 * b,
                          wrow + kt * kBK);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 rows of the unit ---------------
  const int wgi = warp >> 2;
  const int r_lo = 64 * wgi + 16 * (warp & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[2][64];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, it += KT) {
    const Unit w = unit_at(start, row0, rows, E, kBM, u);
    if (64 * wgi >= w.rows) {
      // rows past the group: no products, the stages handed back
      for (int kt = 0; kt < KT; ++kt) {
        const int s = (it + kt) % kStages;
        mbar_wait(full(s), ((it + kt) / kStages) & 1);
        mbar_arrive(empty(s));
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = (it + kt) % kStages;
      mbar_wait(full(s), ((it + kt) / kStages) & 1);
      const uint32_t st = base + s * kStageBytes;
      const uint32_t a_s = st + wgi * kBox;
      const uint32_t b_s = st + kConsumers * kBox;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wgmma_n128(acc[j], desc_sw128(a_s + 32 * t, 16, 1024),
                     desc_sw128(b_s + 2 * j * kBox + t * 16 * 128, kBox,
                                1024));
      wgmma_commit();
      // the previous stage's products are done: hand its slot back
      wgmma_wait<1>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (kt > 0) mbar_arrive(empty((it + kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    mbar_arrive(empty((it + KT - 1) % kStages));

    // -- epilogue: rows r_lo and r_lo + 8, column pairs ------------------
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = r_lo + 8 * h2;
      if (rr >= w.rows) continue;
      const long long row = w.row + rr;
      if constexpr (GLU) {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + row * N;
#pragma unroll
        for (int jj = 0; jj < kBN / 8; ++jj) {
          const int col = w.n * kBN + 8 * jj + cq;
          if (col >= N) continue;               // N is a multiple of 64
          const int i = 4 * jj + 2 * h2;
          *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(
              __float2bfloat16(silu_mul(acc[0][i], acc[1][i])),
              __float2bfloat16(silu_mul(acc[0][i + 1], acc[1][i + 1])));
          if constexpr (KEEP) {
            *reinterpret_cast<float2*>(gk + row * N + col) =
                make_float2(acc[0][i], acc[0][i + 1]);
            *reinterpret_cast<float2*>(uk + row * N + col) =
                make_float2(acc[1][i], acc[1][i + 1]);
          }
        }
      } else {
        const float gw = gate[row];
        float* o = static_cast<float*>(out) + row * N;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int jj = 0; jj < kBN / 8; ++jj) {
            const int col = w.n * 2 * kBN + j * kBN + 8 * jj + cq;
            if (col >= N) continue;
            const int i = 4 * jj + 2 * h2;
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc[j][i] * gw, acc[j][i + 1] * gw);
          }
      }
    }
  }
}

// A 2-d map over a row-major bf16 [outer, inner] matrix: 64 x 64 boxes,
// 128B swizzle, zero fill past its edges.
bool make_map(CUtensorMap* map, const void* ptr, int inner,
              long long outer) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GLU, bool KEEP = false>
int launch(const void* a, const void* offs, const void* b0, const void* b1,
           const void* gate, void* out, int R, int E, int K, int N,
           cudaStream_t stream, void* gk = nullptr, void* uk = nullptr) {
  CUtensorMap ta, tb0, tb1;
  const long long ek = static_cast<long long>(E) * K;
  if (!make_map(&ta, a, K, R) || !make_map(&tb0, b0, N, ek) ||
      !make_map(&tb1, GLU ? b1 : b0, N, ek))
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the shared-memory limit once: later launches make no API call
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_wgmma_kernel<GLU, KEEP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  moe_wgmma_kernel<GLU, KEEP><<<sm_count(), kThreads, kSmem, stream>>>(
      ta, tb0, tb1, static_cast<const int32_t*>(offs),
      static_cast<const float*>(gate), out, E, K, N,
      static_cast<float*>(gk), static_cast<float*>(uk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ============================================================================
// float32: 3xTF32 on mma.sync from a cp.async ring
// ============================================================================

namespace tc {

// the reduction depth of a stage sum: every 32 products of an output start
// from zero and are then added to its float32 sum
constexpr int kSum = 32;

// Two tilings of one arithmetic (the same mma.sync shape, k walk and
// stage sums): wide units of 128 rows (2 x 4 warps of 64 x 32, 3 stages
// 64 deep, one CTA an SM) for many rows a group; narrow units of 16 rows
// (4 warps of 16 x 32, 3 stages 32 deep, three CTAs an SM) for a few,
// where each warp's chain of dependent mma.sync decides: a stage sum
// feeds 12 of them into one accumulator, so the SM needs many warps with
// independent tiles.  Measured on the H100 (tools/moe_lines.py): olmoe's
// float32 decode 1.13 ms wide, 0.73 narrow at 32 rows and 8 warps of 2
// tiles, 0.39 so; the mixtral probe 69.4 ms at 4 stages 32 deep, 63.7-64.0
// so.
template <int WM_, int WN_, int MT_, int NT_, int BK_, int STAGES_,
          int CTAS_>
struct Cfg {
  static constexpr int kBN = WN_ * NT_ * 8;     // weight columns a unit
  static constexpr int kBK = BK_;               // reduction depth a stage
  // row strides: rows g and columns t of A, rows t and columns g of B on
  // 32 distinct banks
  static constexpr int kAS = kBK + 4;
  static constexpr int kBS = kBN + 8;
  static constexpr int WM = WM_;                // warps along the rows
  static constexpr int WN = WN_;                // warps along the columns
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = MT_;                // m16 tiles a warp
  static constexpr int NT = NT_;                // n8 tiles a warp
  static constexpr int kStages = STAGES_;
  static constexpr int kCtas = CTAS_;           // CTAs an SM
  static constexpr int kBM = WM * MT * 16;      // rows a unit
  static constexpr int kStageFloats = kBM * kAS + kBK * kBS;
  static constexpr int kSmem = 4 * kStages * kStageFloats + kPlanBytes;
  static_assert(kSmem <= 232448, "moe_ffn float32 smem");
  static_assert(kBK % kSum == 0, "stages hold whole stage sums");
};
using Wide = Cfg<2, 4, 4, 4, 64, 3, 1>;
using Narrow = Cfg<1, 4, 1, 4, 32, 3, 3>;

// GLU: weight columns 0-63 of a unit are gate's, 64-127 up's, over the
// same 64 columns of h (a warp's first NT / 2 n8 tiles gate's, the rest
// up's); otherwise 128 columns of y.
template <class C, bool GLU, bool KEEP = false>
__global__ void __launch_bounds__(C::kThreads, C::kCtas)
moe_tf32_kernel(const float* __restrict__ a, const int32_t* __restrict__ offs,
                const float* __restrict__ b0, const float* __restrict__ b1,
                const float* __restrict__ gate, float* __restrict__ out,
                float* __restrict__ g_out, float* __restrict__ u_out,
                int E, int K, int N) {
  constexpr int kBM = C::kBM, kStages = C::kStages, MT = C::MT, NT = C::NT;
  constexpr int kThreads = C::kThreads, kBN = C::kBN, kBS = C::kBS;
  constexpr int kBK = C::kBK, kAS = C::kAS;
  extern __shared__ __align__(16) float smem[];
  int* start = reinterpret_cast<int*>(smem + kStages * C::kStageFloats);
  int* row0 = start + kMaxExperts + 1;
  int* rows = row0 + kMaxExperts;

  constexpr int kCols = GLU ? kBN / 2 : kBN;    // output columns a unit
  const int nt = (N + kCols - 1) / kCols;
  const int KT = K / kBK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / C::WN;                  // rows 16 MT wm ..
  const int wn = warp % C::WN;                  // weight columns 8 NT wn ..
  if (warp == 0) plan_units(offs, E, kBM, nt, start, row0, rows);
  __syncthreads();
  const int units = start[E];
  const int mine = units > static_cast<int>(blockIdx.x)
                       ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int steps = mine * KT;

  // the load cursor runs kStages - 1 steps ahead of the compute cursor,
  // across units
  int lu = blockIdx.x, lkt = 0;
  Unit lw{};
  if (mine) lw = unit_at(start, row0, rows, E, kBM, lu);
  auto load = [&](int s) {
    float* As = smem + s * C::kStageFloats;
    float* Bs = As + kBM * kAS;
    for (int c = tid; c < kBM * kBK / 4; c += kThreads) {
      const int r = c / (kBK / 4), k4 = (c % (kBK / 4)) * 4;
      const bool ok = r < lw.rows;              // rows past the group: 0
      cp_async16(As + r * kAS + k4,
                 a + static_cast<long long>(ok ? lw.row + r : 0) * K +
                     lkt * kBK + k4,
                 ok);
    }
    for (int c = tid; c < kBK * kBN / 4; c += kThreads) {
      const int k = c / (kBN / 4), q = c % (kBN / 4);
      const long long wrow =
          (static_cast<long long>(lw.e) * K + lkt * kBK + k) * N;
      if (GLU) {
        const int col = lw.n * kCols + (q % (kCols / 4)) * 4;
        const bool ok = col < N;                // N is a multiple of 64
        cp_async16(Bs + k * kBS + q * 4,
                   (q < kCols / 4 ? b0 : b1) + wrow + (ok ? col : 0), ok);
      } else {
        const int col = lw.n * kBN + q * 4;
        const bool ok = col < N;                // N is a multiple of 64
        cp_async16(Bs + k * kBS + q * 4, b0 + wrow + (ok ? col : 0), ok);
      }
    }
  };
  auto advance_load = [&]() {
    if (++lkt == KT) {
      lkt = 0;
      lu += gridDim.x;
      if (lu < units) lw = unit_at(start, row0, rows, E, kBM, lu);
    }
  };
  // this warp's n8 tiles in the stage's weight columns
  auto bcol = [&](int j) {
    if (GLU)
      return (j < NT / 2 ? 0 : kCols) + 4 * NT * wn + 8 * (j % (NT / 2));
    return 8 * NT * wn + 8 * j;
  };

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) {
      load(i);
      advance_load();
    }
    cp_async_commit();
  }

  int cu = blockIdx.x, ckt = 0;
  Unit cw{};
  if (mine) cw = unit_at(start, row0, rows, E, kBM, cu);
  float acc[MT][NT][4];
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < steps) {
      load((i + kStages - 1) % kStages);
      advance_load();
    }
    cp_async_commit();
    if (ckt == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][j][c] = 0.f;
    }
    // this warp's m16 tiles that hold rows of the group
    const int mt = min(max((cw.rows - 16 * MT * wm + 15) / 16, 0), MT);
    if (mt > 0) {
      const float* As = smem + (i % kStages) * C::kStageFloats;
      const float* Bs = As + kBM * kAS;
      float part[MT][NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mi][j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (mi >= mt) continue;
          // one ldmatrix.x4 (a float32 is a pair of b16): rows g, g + 8,
          // columns t, t + 4 of the m16 x k8 tile
          const int r = 16 * MT * wm + 16 * mi + (lane & 7) +
                        8 * ((lane >> 3) & 1);
          uint32_t x[4];
          ldsm_x4(x, As + r * kAS + kk + 4 * (lane >> 4));
          split_tf32(x, ab[mi], as[mi]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* p = Bs + (kk + t) * kBS + bcol(j) + g;
          split_tf32(p[0], bb[j][0], bs[j][0]);
          split_tf32(p[4 * kBS], bb[j][1], bs[j][1]);
        }
        // the two correction products first, then the big one, each tile
        // in mma_3xtf32's order
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (mi < mt) mma_tf32(part[mi][j], as[mi], bb[j][0], bb[j][1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (mi < mt) mma_tf32(part[mi][j], ab[mi], bs[j][0], bs[j][1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (mi < mt) mma_tf32(part[mi][j], ab[mi], bb[j][0], bb[j][1]);
        if ((kk + 8) % kSum == 0) {
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[mi][j][c] += part[mi][j][c];
                part[mi][j][c] = 0.f;
              }
        }
      }
    }

    if (ckt == KT - 1) {
      // -- epilogue: rows g and g + 8 of each m16 tile, column pairs -----
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int rr = 16 * MT * wm + 16 * mi + g + 8 * h2;
          if (rr >= cw.rows) continue;
          const long long row = cw.row + rr;
          float* o = out + row * N;
          if constexpr (GLU) {
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
              const int col = cw.n * kCols + 4 * NT * wn + 8 * j + 2 * t;
              if (col >= N) continue;
              *reinterpret_cast<float2*>(o + col) = make_float2(
                  silu_mul(acc[mi][j][2 * h2], acc[mi][j + NT / 2][2 * h2]),
                  silu_mul(acc[mi][j][2 * h2 + 1],
                           acc[mi][j + NT / 2][2 * h2 + 1]));
              if constexpr (KEEP) {             // training: g and u too
                *reinterpret_cast<float2*>(g_out + row * N + col) =
                    make_float2(acc[mi][j][2 * h2], acc[mi][j][2 * h2 + 1]);
                *reinterpret_cast<float2*>(u_out + row * N + col) =
                    make_float2(acc[mi][j + NT / 2][2 * h2],
                                acc[mi][j + NT / 2][2 * h2 + 1]);
              }
            }
          } else {
            const float gw = gate[row];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int col = cw.n * kBN + 8 * NT * wn + 8 * j + 2 * t;
              if (col >= N) continue;
              *reinterpret_cast<float2*>(o + col) =
                  make_float2(acc[mi][j][2 * h2] * gw,
                              acc[mi][j][2 * h2 + 1] * gw);
            }
          }
        }
    }
    if (++ckt == KT) {
      ckt = 0;
      cu += gridDim.x;
      if (cu < units) cw = unit_at(start, row0, rows, E, kBM, cu);
    }
  }
  cp_async_wait_all();
}

// Narrow units while the rows average at most 32 a group (decode; R and
// E are shapes, nothing is read from the card), wide ones otherwise.
bool narrow(int R, int E) { return R <= 32 * E; }

template <class C, bool GLU, bool KEEP>
int launch_cfg(const float* a, const int32_t* offs, const float* b0,
               const float* b1, const float* gate, float* out, float* g,
               float* u, int E, int K, int N, cudaStream_t stream) {
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_tf32_kernel<C, GLU, KEEP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  moe_tf32_kernel<C, GLU, KEEP><<<sm_count() * C::kCtas, C::kThreads,
                                  C::kSmem, stream>>>(
      a, offs, b0, b1, gate, out, g, u, E, K, N);
  return static_cast<int>(cudaGetLastError());
}

// KEEP (the training entry's gate/up): g and u stored beside h
template <bool GLU, bool KEEP = false>
int launch(const void* a, const void* offs, const void* b0, const void* b1,
           const void* gate, void* out, int R, int E, int K, int N,
           cudaStream_t stream, void* g = nullptr, void* u = nullptr) {
  auto run = narrow(R, E) ? launch_cfg<Narrow, GLU, KEEP>
                           : launch_cfg<Wide, GLU, KEEP>;
  return run(static_cast<const float*>(a), static_cast<const int32_t*>(offs),
             static_cast<const float*>(b0), static_cast<const float*>(b1),
             static_cast<const float*>(gate), static_cast<float*>(out),
             static_cast<float*>(g), static_cast<float*>(u), E, K, N,
             stream);
}

}  // namespace tc

}  // namespace

// Shapes the wrapper has checked: D and FF multiples of 64, E at most
// kMaxExperts, R >= 1, every base 16-byte aligned, all tensors
// contiguous on the card.
EXPORT int moe_gate_up_bf16(const void* x, const void* offs, const void* wg,
                            const void* wu, void* h, int R, int E, int D,
                            int FF, void* stream) {
  return wg::launch<true>(x, offs, wg, wu, nullptr, h, R, E, D, FF,
                          static_cast<cudaStream_t>(stream));
}
// The bf16 training forward's gate/up: moe_gate_up_bf16's h, products
// and bits, with the float32 products g = x.Wg[e] and u = x.Wu[e]
// [R, FF] stored beside it for the backward (moe_ffn_bwd.cu).
EXPORT int moe_gate_up_bf16_train(const void* x, const void* offs,
                                  const void* wg, const void* wu, void* h,
                                  void* g, void* u, int R, int E, int D,
                                  int FF, void* stream) {
  return wg::launch<true, true>(x, offs, wg, wu, nullptr, h, R, E, D, FF,
                                static_cast<cudaStream_t>(stream), g, u);
}
EXPORT int moe_down_bf16(const void* h, const void* offs, const void* wd,
                         const void* gate, void* y, int R, int E, int D,
                         int FF, void* stream) {
  return wg::launch<false>(h, offs, wd, nullptr, gate, y, R, E, FF, D,
                           static_cast<cudaStream_t>(stream));
}
EXPORT int moe_gate_up_f32(const void* x, const void* offs, const void* wg,
                           const void* wu, void* h, int R, int E, int D,
                           int FF, void* stream) {
  return tc::launch<true>(x, offs, wg, wu, nullptr, h, R, E, D, FF,
                          static_cast<cudaStream_t>(stream));
}
// The training forward's gate/up: moe_gate_up_f32's h, products and bits,
// with g = x.Wg[e] and u = x.Wu[e] [R, FF] stored beside it for the
// backward (moe_ffn_bwd.cu).
EXPORT int moe_gate_up_f32_train(const void* x, const void* offs,
                                 const void* wg, const void* wu, void* h,
                                 void* g, void* u, int R, int E, int D,
                                 int FF, void* stream) {
  return tc::launch<true, true>(x, offs, wg, wu, nullptr, h, R, E, D, FF,
                                static_cast<cudaStream_t>(stream), g, u);
}
EXPORT int moe_down_f32(const void* h, const void* offs, const void* wd,
                        const void* gate, void* y, int R, int E, int D,
                        int FF, void* stream) {
  return tc::launch<false>(h, offs, wd, nullptr, gate, y, R, E, FF, D,
                           static_cast<cudaStream_t>(stream));
}

// How an entry launches at R rows over E experts, for measurement:
// info[0..7] = CTAs in the grid, threads per CTA, dynamic shared memory
// bytes, CTAs resident per SM (the occupancy calculator, after the limit
// is raised), ring stages, rows a unit, gate/up weight columns a unit,
// down columns a unit.
namespace {

template <class Fn>
int fill_launch_info(Fn fn, int ctas, int threads, int smem, int stages,
                     int rows, int gate_up_cols, int down_cols, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[8] = {sm_count() * ctas, threads, smem, per_sm, stages, rows,
                    gate_up_cols, down_cols};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

}  // namespace

EXPORT int moe_ffn_launch_info(int f32, int R, int E, int* info) {
  if (!f32)
    return fill_launch_info(wg::moe_wgmma_kernel<true>, 1, wg::kThreads,
                            wg::kSmem, wg::kStages, wg::kBM, 2 * wg::kBN,
                            2 * wg::kBN, info);
  if (tc::narrow(R, E))
    return fill_launch_info(tc::moe_tf32_kernel<tc::Narrow, true>,
                            tc::Narrow::kCtas, tc::Narrow::kThreads,
                            tc::Narrow::kSmem, tc::Narrow::kStages,
                            tc::Narrow::kBM,
                            tc::Narrow::kBN, tc::Narrow::kBN, info);
  return fill_launch_info(tc::moe_tf32_kernel<tc::Wide, true>,
                          tc::Wide::kCtas, tc::Wide::kThreads, tc::Wide::kSmem,
                          tc::Wide::kStages, tc::Wide::kBM, tc::Wide::kBN,
                          tc::Wide::kBN, info);
}

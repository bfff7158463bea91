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
// weight c_r and output gradient dy [R, D]:
//   g = x.Wg[e], u = x.Wu[e], a = silu(g), h = a * u
//   t = dy.Wd[e]^T,  dc_r = sum_f h_rf t_rf,  dh = c_r t
//   dg = dh * u * silu'(g),  du = dh * a
//   dx = dg.Wg[e]^T + du.Wu[e]^T
//   dWg[e] = X_e^T.dg_e,  dWu[e] = X_e^T.du_e,  dWd[e] = H_e^T.(c dy)_e
// Wg/Wu [E, D, FF], Wd [E, FF, D], offs int32 [E + 1], gate float32 [R].
//
// Four launches of one kernel template, in stream order:
//   kGateUp  g and u again for the sorted rows (the forward's gate/up walk,
//            its epilogue storing g and u);                  g, u [R, FF]
//   kDown    t over D; the epilogue forms dg and du in place of g and u,
//            stores h, and each row's dc over its 128 columns; dc partials
//            [R, ceil(FF / 128)], no atomics;
//   kDx      dx = [dg | du].[Wg | Wu]^T over 2 FF; the CTAs of column
//            tile 0 sum each row's dc partials in column order into dgate;
//   kDw      dWg, dWu, dWd: one CTA an (product, expert, 128 x 128 tile)
//            walks the group's rows in order, 32 a stage; rows past the
//            group load as zeros, and an expert without rows stores zeros.
// Both dgrad products read the weights K-major exactly as they lie (Wd[e]
// is [FF, D], Wg[e] [D, FF]): no transposed copy.
//
// What bounds it on the H100: at olmoe's training shape (16384 rows over 64
// experts, D 2048, FF 1024) the tensor cores: 16 R D FF operations (4
// for the recomputed g and u, 2 for t, 4 for dx, 6 for the three dW)
// over 494.7/3 TFLOP/s in 3xTF32; the bytes (the weights and dW once, the
// rows' x, dy, dx and four [R, FF] intermediates) take a few percent of
// that.  The design is the simple one: 128 x 128 tiles of 8 warps (64 x 32
// each), a 3-stage cp.async ring 32 deep, one CTA an SM, a grid of every
// possible unit (CTAs past the plan return at once).
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8 (split_tf32 and mma_3xtf32,
// common.cuh), as moe_ffn's float32 entry.  Each 32-deep stage's products
// start from zero and are added to the output's float32 sum with one
// rounded add (mma.sync rounds its sum toward zero).
//
// The bit rules: every output element of dx, g, u, dg, du, h and dgate sees
// the same instruction shape and k walk whatever its group's size or its
// place in the group, so a row's bits depend on the row alone; dW's bits
// depend only on its group's rows in sorted order (no split-K across CTAs,
// no atomics), so a step repeats its bits.
#include "common.cuh"
#include "moe_plan.cuh"

namespace {

enum Kind { kGateUp = 0, kDown = 1, kDx = 2, kDw = 3 };

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kWN = 4, kThreads = 256;   // 2 x 4 warps of 64 x 32
constexpr int MT = 4, NT = 4;            // m16 and n8 tiles a warp
// row strides: rows g and columns t of an [m][k] or [n][k] tile, and rows
// t and columns g of a [k][m] or [k][n] tile, on 32 distinct banks
constexpr int kKS = kBK + 4;   // [rows][k]
constexpr int kMS = kBM + 8;   // [k][rows]
constexpr int kNS = kBN + 8;   // [k][columns]
constexpr int kTile = kBM * kKS;               // >= kBK * kMS
constexpr int kStageFloats = 2 * kTile + kBK;  // A, B, the stage's gates
constexpr int kSmem = 4 * kStages * kStageFloats + kPlanBytes;
static_assert(kBK * kMS <= kTile && kBK * kNS <= kTile &&
                  kBN * kKS <= kTile, "moe_ffn_bwd tiles");
static_assert(kSmem <= 232448, "moe_ffn_bwd smem");

struct Args {
  const float* x;      // xg [R, D]
  const float* dy;     // [R, D]
  const int32_t* offs; // [E + 1]
  const float* wg;     // [E, D, FF]
  const float* wu;     // [E, D, FF]
  const float* wd;     // [E, FF, D]
  const float* gate;   // [R]
  float* g;            // [R, FF]: g, then dg
  float* u;            // [R, FF]: u, then du
  float* h;            // [R, FF]
  float* part;         // [R, ceil(FF / kBN)]: dc over each column tile
  float* dx;           // [R, D]
  float* dgate;        // [R]
  float* dwg;          // [E, D, FF]
  float* dwu;          // [E, D, FF]
  float* dwd;          // [E, FF, D]
  int R, E, D, FF;
};

// output columns of a row-tiled unit: kGateUp 64 of g and the same 64 of u
template <int KIND>
__host__ __device__ constexpr int unit_cols() {
  return KIND == kGateUp ? kBN / 2 : kBN;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  int* start = reinterpret_cast<int*>(smem + kStages * kStageFloats);
  int* row0 = start + kMaxExperts + 1;
  int* rows = row0 + kMaxExperts;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / kWN;                    // rows 64 wm ..
  const int wn = warp % kWN;                    // columns 32 wn ..
  const int FF = p.FF, D = p.D;

  // ---- the unit -----------------------------------------------------------
  // row-tiled kinds: rows r0 .. r0 + nrows - 1 of expert e (nrows may pass
  // kBM: the group goes on), column tile n.  kDw: product prod, expert e,
  // tile (mi, n) of its [M, N] gradient, the group's rows r0 .. as its
  // reduction.
  int e, r0, nrows, n = 0, prod = 0, mi = 0, M = 0, N = 0, K;
  if constexpr (KIND == kDw) {
    const int tiles = cdiv(D, kBM) * cdiv(FF, kBN);
    const int b = blockIdx.x;
    prod = b / (p.E * tiles);
    e = (b / tiles) % p.E;
    M = prod == 2 ? FF : D;
    N = prod == 2 ? D : FF;
    const int tile = b % tiles;
    mi = tile / cdiv(N, kBN);
    n = tile % cdiv(N, kBN);
    r0 = p.offs[e];
    nrows = max(p.offs[e + 1] - r0, 0);
    K = nrows;
  } else {
    N = KIND == kDx ? D : FF;
    if (warp == 0)
      plan_units(p.offs, p.E, kBM, cdiv(N, unit_cols<KIND>()), start, row0,
                 rows);
    __syncthreads();
    if (static_cast<int>(blockIdx.x) >= start[p.E]) return;
    const Unit w = unit_at(start, row0, rows, p.E, kBM, blockIdx.x);
    e = w.e;
    r0 = w.row;
    nrows = w.rows;
    n = w.n;
    K = KIND == kDx ? 2 * FF : D;
  }
  const int KT = cdiv(K, kBK);

  // ---- loads: A and B of reduction step kt into stage s -------------------
  auto load = [&](int s, int kt) {
    float* As = smem + s * kStageFloats;
    float* Bs = As + kTile;
    const int k0 = kt * kBK;
    if constexpr (KIND == kDw) {
      // A [k][m]: rows of x (dWg, dWu) or h (dWd); B [k][n]: rows of dg,
      // du or dy.  Rows past the group: zeros.
      const float* a = prod == 2 ? p.h : p.x;
      const float* bsrc = prod == 0 ? p.g : prod == 1 ? p.u : p.dy;
      for (int c = tid; c < kBK * kBM / 4; c += kThreads) {
        const int k = c / (kBM / 4), q = (c % (kBM / 4)) * 4;
        const bool ok = k0 + k < nrows && mi * kBM + q < M;
        cp_async16(As + k * kMS + q,
                   a + (ok ? static_cast<long long>(r0 + k0 + k) * M +
                                 mi * kBM + q
                           : 0),
                   ok);
        const bool okb = k0 + k < nrows && n * kBN + q < N;
        cp_async16(Bs + k * kNS + q,
                   bsrc + (okb ? static_cast<long long>(r0 + k0 + k) * N +
                                     n * kBN + q
                               : 0),
                   okb);
      }
      if (prod == 2 && tid < kBK) {
        float* cs = Bs + kTile;
        cs[tid] = k0 + tid < nrows ? p.gate[r0 + k0 + tid] : 0.f;
      }
    } else {
      // A [m][k]: the unit's rows of x, dy or [dg | du]; rows past the
      // group: zeros
      const float* a = KIND == kGateUp ? p.x : KIND == kDown ? p.dy
                       : k0 < FF ? p.g : p.u;
      const int lda = KIND == kDx ? FF : D;
      const int ka = KIND == kDx && k0 >= FF ? k0 - FF : k0;
      for (int c = tid; c < kBM * kBK / 4; c += kThreads) {
        const int r = c / (kBK / 4), q = (c % (kBK / 4)) * 4;
        const bool ok = r < nrows;
        cp_async16(As + r * kKS + q,
                   a + (ok ? static_cast<long long>(r0 + r) * lda + ka + q
                           : 0),
                   ok);
      }
      if constexpr (KIND == kGateUp) {
        // B [k][n]: rows k0.. of Wg[e] (columns 0-63) and Wu[e] (64-127)
        for (int c = tid; c < kBK * kBN / 4; c += kThreads) {
          const int k = c / (kBN / 4), q = (c % (kBN / 4)) * 4;
          const int col = n * (kBN / 2) + q % (kBN / 2);
          const bool ok = col < FF;
          const float* w = q < kBN / 2 ? p.wg : p.wu;
          cp_async16(Bs + k * kNS + q,
                     w + (ok ? (static_cast<long long>(e) * D + k0 + k) * FF +
                                   col
                             : 0),
                     ok);
        }
      } else {
        // B [n][k], K-major as the weights lie: rows n.. of Wd[e] [FF, D]
        // (kDown), or of Wg[e] / Wu[e] [D, FF] (kDx)
        const float* w = KIND == kDown ? p.wd : k0 < FF ? p.wg : p.wu;
        const int ldw = KIND == kDown ? D : FF;
        const int rows_w = KIND == kDown ? FF : D;
        for (int c = tid; c < kBN * kBK / 4; c += kThreads) {
          const int r = c / (kBK / 4), q = (c % (kBK / 4)) * 4;
          const int wr = n * kBN + r;
          const bool ok = wr < rows_w;
          cp_async16(Bs + r * kKS + q,
                     w + (ok ? (static_cast<long long>(e) * rows_w + wr) *
                                       ldw + ka + q
                             : 0),
                     ok);
        }
      }
    }
  };

  // this warp's m16 tiles that hold rows of the group (row-tiled kinds
  // skip the rest; kDw's rows are the gradient's, all present)
  const int mt = KIND == kDw
                     ? MT
                     : min(max((nrows - 64 * wm + 15) / 16, 0), MT);
  // column of this warp's n8 tile j in the stage's B tile
  auto bcol = [&](int j) {
    if (KIND == kGateUp)
      return (j < NT / 2 ? 0 : kBN / 2) + 16 * wn + 8 * (j % (NT / 2));
    return 32 * wn + 8 * j;
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < KT) load(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < KT)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    if (mt == 0) continue;
    const float* As = smem + (kt % kStages) * kStageFloats;
    const float* Bs = As + kTile;
    const float* cs = Bs + kTile;
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
        if (i >= mt) continue;
        // rows g, g + 8 and columns t, t + 4 of the m16 x k8 tile
        const int r = 64 * wm + 16 * i + g;
        float v[4];
        if constexpr (KIND == kDw) {
          v[0] = As[(kk + t) * kMS + r];
          v[1] = As[(kk + t) * kMS + r + 8];
          v[2] = As[(kk + t + 4) * kMS + r];
          v[3] = As[(kk + t + 4) * kMS + r + 8];
        } else {
          v[0] = As[r * kKS + kk + t];
          v[1] = As[(r + 8) * kKS + kk + t];
          v[2] = As[r * kKS + kk + t + 4];
          v[3] = As[(r + 8) * kKS + kk + t + 4];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(v[c], ab[i][c], as[i][c]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // column g, rows t and t + 4 of the k8 x n8 tile
        const int col = bcol(j) + g;
        float b0, b1;
        if constexpr (KIND == kDw || KIND == kGateUp) {
          b0 = Bs[(kk + t) * kNS + col];
          b1 = Bs[(kk + t + 4) * kNS + col];
          if (KIND == kDw && prod == 2) {     // (c dy), as JAX rounds it
            b0 *= cs[kk + t];
            b1 *= cs[kk + t + 4];
          }
        } else {
          b0 = Bs[col * kKS + kk + t];
          b1 = Bs[col * kKS + kk + t + 4];
        }
        split_tf32(b0, bb[j][0], bs[j][0]);
        split_tf32(b1, bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (i < mt)
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
  cp_async_wait_all();

  // ---- epilogues: rows g and g + 8 of each m16 tile, column pairs --------
  if constexpr (KIND == kDw) {
    float* out = (prod == 0 ? p.dwg : prod == 1 ? p.dwu : p.dwd) +
                 static_cast<long long>(e) * M * N;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = mi * kBM + 64 * wm + 16 * i + g + 8 * h2;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n * kBN + 32 * wn + 8 * j + 2 * t;
          if (col >= N) continue;
          *reinterpret_cast<float2*>(out + static_cast<long long>(m) * N +
                                     col) =
              make_float2(acc[i][j][2 * h2], acc[i][j][2 * h2 + 1]);
        }
      }
  } else if constexpr (KIND == kGateUp) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = 64 * wm + 16 * i + g + 8 * h2;
        if (rr >= nrows || rr >= kBM) continue;
        const long long base = static_cast<long long>(r0 + rr) * FF;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          const int col = n * (kBN / 2) + 16 * wn + 8 * j + 2 * t;
          if (col >= FF) continue;
          *reinterpret_cast<float2*>(p.g + base + col) =
              make_float2(acc[i][j][2 * h2], acc[i][j][2 * h2 + 1]);
          *reinterpret_cast<float2*>(p.u + base + col) =
              make_float2(acc[i][j + NT / 2][2 * h2],
                          acc[i][j + NT / 2][2 * h2 + 1]);
        }
      }
  } else if constexpr (KIND == kDown) {
    // dg, du in place of g, u; h; each row's dc over this unit's columns:
    // the thread's 8 columns in order, then the 4 lanes of a row (xor
    // tree), then the 4 warps of a row in warp order
    __syncthreads();                  // the ring's last reads are done
    float* red = smem;                // [kWN][kBM]
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = 64 * wm + 16 * i + g + 8 * h2;
        const bool in = rr < nrows && rr < kBM;
        float dc = 0.f;
        if (in) {
          const long long row = r0 + rr;
          const long long base = row * FF;
          const float c = p.gate[row];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = n * kBN + 32 * wn + 8 * j + 2 * t;
            if (col >= FF) continue;
            const float2 gg = *reinterpret_cast<const float2*>(p.g + base +
                                                               col);
            const float2 uu = *reinterpret_cast<const float2*>(p.u + base +
                                                               col);
            float dgv[2], duv[2], hv[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float gq = q ? gg.y : gg.x;
              const float uq = q ? uu.y : uu.x;
              const float tv = acc[i][j][2 * h2 + q];
              const float s = 1.f / (1.f + expf(-gq));
              const float a = gq / (1.f + expf(-gq));     // silu, as forward
              hv[q] = silu_mul(gq, uq);
              dc += hv[q] * tv;
              const float dh = c * tv;
              dgv[q] = dh * uq * (s * (1.f + gq * (1.f - s)));
              duv[q] = dh * a;
            }
            *reinterpret_cast<float2*>(p.g + base + col) =
                make_float2(dgv[0], dgv[1]);
            *reinterpret_cast<float2*>(p.u + base + col) =
                make_float2(duv[0], duv[1]);
            *reinterpret_cast<float2*>(p.h + base + col) =
                make_float2(hv[0], hv[1]);
          }
        }
        dc += __shfl_xor_sync(0xffffffffu, dc, 1);
        dc += __shfl_xor_sync(0xffffffffu, dc, 2);
        if (t == 0) red[wn * kBM + rr] = dc;
      }
    __syncthreads();
    if (tid < kBM && tid < nrows) {
      const int np = cdiv(FF, kBN);
      p.part[static_cast<long long>(r0 + tid) * np + n] =
          ((red[tid] + red[kBM + tid]) + red[2 * kBM + tid]) +
          red[3 * kBM + tid];
    }
  } else {  // kDx
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = 64 * wm + 16 * i + g + 8 * h2;
        if (rr >= nrows || rr >= kBM) continue;
        float* o = p.dx + static_cast<long long>(r0 + rr) * D;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n * kBN + 32 * wn + 8 * j + 2 * t;
          if (col >= D) continue;
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc[i][j][2 * h2], acc[i][j][2 * h2 + 1]);
        }
      }
    if (n == 0 && tid < kBM && tid < nrows) {
      const int np = cdiv(FF, kBN);
      const float* pr = p.part + static_cast<long long>(r0 + tid) * np;
      float s = 0.f;
      for (int j = 0; j < np; ++j) s += pr[j];
      p.dgate[r0 + tid] = s;
    }
  }
}

// CTAs of a launch: every unit the rows could make (a row-tiled kind has
// at most ceil(R / 128) + E row tiles; kDw a fixed count), so the grid
// needs nothing from the card
template <int KIND>
int grid(const Args& p) {
  if (KIND == kDw) return 3 * p.E * cdiv(p.D, kBM) * cdiv(p.FF, kBN);
  const int N = KIND == kDx ? p.D : p.FF;
  return (cdiv(p.R, kBM) + p.E) * cdiv(N, unit_cols<KIND>());
}

template <int KIND>
int launch(const Args& p, cudaStream_t stream) {
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_bwd_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  moe_bwd_kernel<KIND><<<grid<KIND>(p), kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of entry `kind` (0 gate/up recompute, 1 down dgrad, 2 x dgrad
// and dgate, 3 weight gradients); the wrapper calls 0-3 in order on one
// stream.  Shapes the wrapper has checked: D and FF multiples of 64, E at
// most kMaxExperts, R >= 1, every base 16-byte aligned, all tensors
// contiguous float32 on the card; part is [R, ceil(FF / 128)].
EXPORT int moe_ffn_bwd_f32(int kind, const void* dy, const void* x,
                           const void* offs, const void* wg, const void* wu,
                           const void* wd, const void* gate, void* g, void* u,
                           void* h, void* part, void* dx, void* dgate,
                           void* dwg, void* dwu, void* dwd, int R, int E,
                           int D, int FF, void* stream) {
  const Args p{static_cast<const float*>(x),
               static_cast<const float*>(dy),
               static_cast<const int32_t*>(offs),
               static_cast<const float*>(wg),
               static_cast<const float*>(wu),
               static_cast<const float*>(wd),
               static_cast<const float*>(gate),
               static_cast<float*>(g),
               static_cast<float*>(u),
               static_cast<float*>(h),
               static_cast<float*>(part),
               static_cast<float*>(dx),
               static_cast<float*>(dgate),
               static_cast<float*>(dwg),
               static_cast<float*>(dwu),
               static_cast<float*>(dwd),
               R, E, D, FF};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kGateUp: return launch<kGateUp>(p, s);
    case kDown: return launch<kDown>(p, s);
    case kDx: return launch<kDx>(p, s);
    case kDw: return launch<kDw>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

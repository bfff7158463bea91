// K9: the Mamba-2 SSD chunked scan, chunk-parallel.
//
// Replaces repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (grid
// (B, n_chunks); the chunk axis runs in order on the TPU, so the state
// h [H, N, P] of every head persists in VMEM scratch from chunk to
// chunk).  It computes what that kernel computes: with cs the inclusive
// cumsum of dt * A within a chunk of Q steps,
//   y_i    = sum_{j<=i} (C_i.B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) C_i.h_prev,
//   h_next = h_prev exp(cs_end) + sum_j exp(cs_end - cs_j) dt_j B_j (x) x_j,
// y and the final state in float32.  B and C are shared by all heads
// (G = 1), as the Pallas kernel takes them.
//
// What changes from the TPU design: blocks run in no order on Hopper, so
// nothing carries from one block to the next.  Only the state recurrence
// is serial over chunks, and it is one multiply-add per state element per
// chunk, so the scan runs as four launches, each parallel over chunks:
//   1. prologue, one CTA per (batch, chunk): cs of every head, written
//      [B, nc, H, Qp] (a warp per head: runs per lane, then a shuffle
//      scan of the runs), and CB = C.B^T [B, nc, Qp, Qp], the 16x16
//      tiles on and below the diagonal, once for all heads;
//   2. chunk states, one CTA per (batch, chunk, head): S = B^T . (w o x),
//      w_j = exp(cs_end - cs_j) dt_j, written [B, nc, H, N, P];
//   3. state passing, one thread per (batch, head, 4 state elements):
//      h_prev[c + 1] = h_prev[c] exp(cs_end,c) + S[c] over the nc chunks
//      from h0 (or 0), h_prev written over S in place, then h_final;
//   4. chunk output, one CTA per (batch, chunk, head):
//      y = (CB o exp(cs_i - cs_j) o dt_j, j <= i) . x + exp(cs_i) C.h_prev;
//      16-row tiles of y skip every 16-column tile of j above the
//      diagonal; a warp takes one m-tile, or m-tiles t and M-1-t when
//      there are more tiles than warps.
// Q is padded to Qp (a multiple of 16) and a ragged last chunk is masked
// in the kernels: steps past the chunk or past L load dt = 0 and zero x,
// B, C (identity steps, exactly what padding gives) and write no y, so
// nothing is padded or copied outside.  The workspace (cs, CB and the
// chunk states, sized by ssd_scan_workspace) comes from the wrapper, and
// passes 2 and 4 read dt from the input; the kernels allocate
// nothing, sync nothing and use no atomics, and each work item's split is
// fixed by (L, H, P, N, Q), so the bits of a sequence do not depend on
// the batch around it.  Each kernel's shared-memory limit is raised at
// its first launch only, so a CUDA graph can capture a call.
//
// Arithmetic.  bf16 entry: C.B^T, and every product whose other operand
// is bf16 input, run on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulate), where bf16 products are exact.  The float32
// operand of the other three products (w o x in the states, h_prev in
// C.h_prev, the decayed CB in y) is split into kTerms = 2 bf16 terms,
// t = hi + lo with hi = bf16(t), lo = bf16(t - hi), which hold t to
// 2**-17 (one term, 2**-9, does not hold the 1e-4 tolerance), and the
// products of both terms are summed in float32.  float32 entry: the same
// passes with every product in 3xTF32 on mma.sync m16n8k8 (common.cuh:
// each float32 operand split into a big and a small TF32 term on the
// fragment load, small.big + big.small + big.big summed in float32); the
// operands w o x and the decayed CB are formed in float32 before the
// split.  tests/test_torch_ssd_f32_tc.py emulates it on the CPU: 3xTF32
// holds y and h_final within 1e-5 of the largest output against a
// float64 recurrence and the JAX package, one TF32 term misses 1e-4.
//
// Bound on the H100: x, B, C and dt read once, y (float32) and h_final
// written once: ~357 MB at zamba2's prefill shape (B 4, L 2000, H 112,
// P 64, N 64, Q 128, bf16), 0.107 ms at 3.35 TB/s; ~22 GFLOP (C.B^T's
// triangle once per chunk, its decayed product with x per head, the
// states and C.h_prev), 0.022 ms at the bf16 tensor-core rate: bytes
// bound it.  The passes move more than
// that: x is read twice, and the chunk states (B nc H N P float32, 117 MB
// at zamba2's shape) are written, read and written, and read again, ~0.83
// GB in all (0.25 ms at 3.35 TB/s); CB is read from L2 by every head.
// The product passes run 8 warps a CTA: the chunk states as (16 state
// rows, half the columns) items, the chunk output as m-tiles of 16 rows.
// float32 tiles take twice the bf16 ones' shared memory, so the float32
// chunk states stream the steps through shared memory kF32JBlock at a
// time, and the float32 prologue and chunk output read C's rows from
// global memory: every in-range shape fits (static_asserts below).
#include "common.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kTerms = 2;           // bf16 terms of a float32 operand
constexpr int kPrologueThreads = 256;
constexpr int kTileThreads = 256;   // passes 2 and 4
constexpr int kPassThreads = 256;   // pass 3
constexpr int kF32JBlock = 64;      // steps per shared-memory block, f32 pass 2
constexpr int kMaxSmem = 232448;    // dynamic shared memory a CTA can have
constexpr int kPassUnroll = 8;      // chunks whose states pass 3 loads at once
constexpr int kPassVec = 4;         // state elements per thread, pass 3

__host__ __device__ constexpr int pad16(int v) { return (v + 15) / 16 * 16; }
// bf16 shared-memory row stride: padded to the k-steps, plus 8 so the
// eight rows of an ldmatrix hit distinct banks
__host__ __device__ constexpr int bf_stride(int cols) { return pad16(cols) + 8; }
__host__ __device__ constexpr int pad8(int v) { return (v + 7) / 8 * 8; }
// float32 shared-memory row stride: padded to the TF32 k-step of 8, plus
// 4, so the 8 rows of an ldmatrix hit distinct 16-byte bank groups and the
// scalar fragment loads of rows 2t + e (e fixed), columns g hit 32
// distinct banks
__host__ __device__ constexpr int f32_stride(int cols) { return pad8(cols) + 4; }

struct Dims {
  int L, H, P, N, Q, Qp, nc;
};

// t = out[0] + out[1] + ... to 2**-(9 * kTerms)
__device__ __forceinline__ void split_bf16(float t, bf (&out)[kTerms]) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    out[k] = __float2bfloat16(t);
    t -= __bfloat162float(out[k]);
  }
}

// Elements [c0, c0 + 8) of a row (zero past `cols` or when !live), 16
// bytes at a time where the row allows it.
template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* row, int c0,
                                      int cols, bool live, bool vec) {
  if (live && vec && c0 + 8 <= cols) {
    if constexpr (sizeof(T) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + c0);
      const bf* e = reinterpret_cast<const bf*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(row + c0);
      const float4 b = *reinterpret_cast<const float4*>(row + c0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = live && c0 + k < cols ? to_float(row[c0 + k]) : 0.f;
}

// Whether rows of `cols` elements at stride `ld` from `p` can be read 16
// bytes at a time.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int cols, long long ld) {
  constexpr int per = 16 / sizeof(T);
  return cols % per == 0 && ld % per == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows [0, rows_pad) of a [*, cols] bf16 matrix at row stride ld into
// shared memory at row stride sd: rows >= live and columns >= cols up to
// pad16(cols) are zero.  16-byte rows go by cp.async, all in flight at
// once; the caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void load_bf16_rows(bf* dst, int sd, const bf* src,
                                               long long ld, int live,
                                               int rows_pad, int cols, int tid,
                                               int nthreads) {
  const bool vec = vec_ok(src, cols, ld);
  const int groups = pad16(cols) / 8;
  for (int i = tid; i < rows_pad * groups; i += nthreads) {
    const int r = i / groups;
    const int c0 = (i - r * groups) * 8;
    bf* out = dst + r * sd + c0;
    if (vec) {
      const bool pred = r < live && c0 < cols;
      cp_async16(out, pred ? src + r * ld + c0 : src, pred);
      continue;
    }
    float v[8];
    load8(v, src + r * ld, c0, cols, r < live, false);
    uint4 u;
    bf* e = reinterpret_cast<bf*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(v[k]);
    *reinterpret_cast<uint4*>(out) = u;
  }
}

// Rows [0, rows) of a [*, cols] float32 matrix at row stride ld into
// shared memory at row stride sd, columns [0, pad8(cols)): rows >= live
// and columns >= cols are zero.  16-byte groups go by cp.async where the
// rows allow it (the caller waits and syncs), else by scalar loads.
__device__ __forceinline__ void load_f32_rows(float* dst, int sd,
                                              const float* src, long long ld,
                                              int live, int rows, int cols,
                                              int tid, int nthreads) {
  const bool vec = vec_ok(src, cols, ld);
  const int groups = pad8(cols) / 4;
  for (int i = tid; i < rows * groups; i += nthreads) {
    const int r = i / groups;
    const int c0 = (i - r * groups) * 4;
    float* out = dst + r * sd + c0;
    if (vec) {
      const bool pred = r < live && c0 < cols;
      cp_async16(out, pred ? src + r * ld + c0 : src, pred);
      continue;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = r < live && c0 + k < cols ? src[r * ld + c0 + k] : 0.f;
  }
}

// The TF32 terms of a float32 value read from global memory, 0 when !live.
__device__ __forceinline__ void split_ldg(const float* p, bool live,
                                          uint32_t& big, uint32_t& small) {
  split_tf32(live ? __ldg(p) : 0.f, big, small);
}

// Stores a pair of float32 outputs at columns p, p + 1 < cols of a row
// (8 bytes at once where cols is even).
__device__ __forceinline__ void store2(float* row, int p, int cols, float a,
                                       float b) {
  if ((cols & 1) == 0 && p + 1 < cols) {
    *reinterpret_cast<float2*>(row + p) = make_float2(a, b);
    return;
  }
  if (p < cols) row[p] = a;
  if (p + 1 < cols) row[p + 1] = b;
}

// =============================================================================
// 1. prologue: cs, dt per head and CB = C.B^T, one CTA per (chunk, batch)
// =============================================================================

template <typename T>
__global__ void __launch_bounds__(kPrologueThreads)
    ssd_prologue_kernel(const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, float* __restrict__ cs,
                        float* __restrict__ cb, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kPrologueThreads / 32;
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * d.Q;
  const int nv = min(d.Q, d.L - t0);              // live steps
  const long long row0 = static_cast<long long>(b) * d.L + t0;
  const long long bc = static_cast<long long>(b) * d.nc + c;
  const int Qp = d.Qp;

  // cs = inclusive cumsum of dt * A: lane l takes steps [l*per, l*per+per)
  const int per = (Qp + 31) / 32;                 // <= 8
  for (int h = warp; h < d.H; h += kWarps) {
    const float a = A[h];
    float dv[8], run[8];
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = lane * per + k;
      dv[k] = k < per && j < nv ? dt[(row0 + j) * d.H + h] : 0.f;
      tot += __fmul_rn(dv[k], a);
      run[k] = tot;
    }
    float inc = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) excl = 0.f;
    float* cs_h = cs + (bc * d.H + h) * Qp;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = lane * per + k;
      if (k < per && j < Qp) cs_h[j] = excl + run[k];
    }
  }

  // CB tiles (mi, mj), mj <= mi, of 16 x 16, taken by warps in turn.
  // bf16: C and B in shared memory, fragments by ldmatrix.  float32: B in
  // shared memory (the B^T fragments by ldmatrix, a 32-bit element being a
  // pair of b16), C's rows of the tile read from global memory, 3xTF32.
  float* cbc = cb + bc * Qp * Qp;
  const int M = Qp / 16;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int sN = kBf16 ? bf_stride(d.N) : f32_stride(d.N);
  T* b_s = reinterpret_cast<T*>(smem_raw);       // [Qp][sN]
  [[maybe_unused]] T* c_s = b_s + Qp * sN;       // bf16: [Qp][sN]
  if constexpr (kBf16) {
    load_bf16_rows(c_s, sN, Cm + row0 * d.N, d.N, nv, Qp, d.N, tid,
                   kPrologueThreads);
    load_bf16_rows(b_s, sN, Bm + row0 * d.N, d.N, nv, Qp, d.N, tid,
                   kPrologueThreads);
  } else {
    load_f32_rows(b_s, sN, Bm + row0 * d.N, d.N, nv, Qp, d.N, tid,
                  kPrologueThreads);
  }
  cp_async_wait_all();
  __syncthreads();
  const int g = lane >> 2, tq = lane & 3;
  int t = 0;
  for (int mi = 0; mi < M; ++mi)
    for (int mj = 0; mj <= mi; ++mj, ++t) {
      if (t % kWarps != warp) continue;
      float s[2][4] = {};
      if constexpr (kBf16) {
        for (int kk = 0; kk < pad16(d.N) / 16; ++kk) {
          uint32_t fa[4], fb[4];
          ldsm_x4(fa, c_s + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                sN + kk * 16 + (lane >> 4) * 8);
          ldsm_x4(fb, b_s + (mj * 16 + (lane & 7) + (lane >> 4) * 8) * sN +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[0], fa, fb[0], fb[1]);
          mma_bf16(s[1], fa, fb[2], fb[3]);
        }
      } else {
        const int i0 = mi * 16 + g;
        const float* c0 = Cm + (row0 + i0) * d.N;
        const float* c1 = c0 + 8 * d.N;
        const bool l0 = i0 < nv, l1 = i0 + 8 < nv;
        for (int kk = 0; kk < pad8(d.N) / 8; ++kk) {
          const int n0 = kk * 8 + tq, n1 = n0 + 4;
          uint32_t ab[4], as[4], fb[4], bb[4], bs[4];
          split_ldg(c0 + n0, l0 && n0 < d.N, ab[0], as[0]);
          split_ldg(c1 + n0, l1 && n0 < d.N, ab[1], as[1]);
          split_ldg(c0 + n1, l0 && n1 < d.N, ab[2], as[2]);
          split_ldg(c1 + n1, l1 && n1 < d.N, ab[3], as[3]);
          ldsm_x4(fb, b_s + (mj * 16 + (lane & 7) + (lane >> 4) * 8) * sN +
                          kk * 8 + ((lane >> 3) & 1) * 4);
          split_tf32(fb, bb, bs);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_3xtf32(s[nt], ab, as, bb[2 * nt], bb[2 * nt + 1],
                       bs[2 * nt], bs[2 * nt + 1]);
        }
      }
      const int r = mi * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = mj * 16 + nt * 8 + tq * 2;
        *reinterpret_cast<float2*>(cbc + r * Qp + col) =
            make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(cbc + (r + 8) * Qp + col) =
            make_float2(s[nt][2], s[nt][3]);
      }
    }
}

// =============================================================================
// 2. chunk states S = B^T . (w o x), one CTA per (chunk, head, batch)
// =============================================================================

// bf16: NT n-tiles of 8 columns cover P.  A = B^T from B [Qp][N] by
// ldmatrix.trans; the B operand (w o x) in kTerms bf16 terms.
template <int NT>
__global__ void __launch_bounds__(kTileThreads)
    ssd_states_bf16_kernel(const bf* __restrict__ x, const bf* __restrict__ Bm,
                           const float* __restrict__ cs,
                           const float* __restrict__ dt,
                           float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kTileThreads / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * d.Q;
  const int nv = min(d.Q, d.L - t0);
  const long long row0 = static_cast<long long>(b) * d.L + t0;
  const long long bc = static_cast<long long>(b) * d.nc + c;
  const int Qp = d.Qp, P = d.P, N = d.N;
  const int sN = bf_stride(N), sP = bf_stride(P);
  bf* b_s = reinterpret_cast<bf*>(smem_raw);     // [Qp][sN]
  bf* wx_s = b_s + Qp * sN;                      // [kTerms][Qp][sP]
  float* w_s = reinterpret_cast<float*>(wx_s + kTerms * Qp * sP);  // [Qp]

  const float* cs_h = cs + (bc * d.H + h) * Qp;
  const float cs_end = cs_h[Qp - 1];
  for (int j = tid; j < Qp; j += kTileThreads)
    w_s[j] = j < nv ? expf(cs_end - cs_h[j]) * dt[(row0 + j) * d.H + h] : 0.f;
  // B, and x raw into the last term's rows; then w o x split in place
  // (each thread rewrites only the elements it read)
  bf* x_raw = wx_s + (kTerms - 1) * Qp * sP;
  load_bf16_rows(b_s, sN, Bm + row0 * N, N, nv, Qp, N, tid, kTileThreads);
  load_bf16_rows(x_raw, sP, x + row0 * d.H * P + static_cast<long long>(h) * P,
                 static_cast<long long>(d.H) * P, nv, Qp, P, tid,
                 kTileThreads);
  cp_async_wait_all();
  __syncthreads();
  {
    const int groups = pad16(P) / 8;
    for (int i = tid; i < Qp * groups; i += kTileThreads) {
      const int j = i / groups;
      const int c0 = (i - j * groups) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(x_raw + j * sP + c0);
      const bf* xv = reinterpret_cast<const bf*>(&raw);
      const float w = w_s[j];
      uint4 u[kTerms];
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        bf t0s[kTerms], t1s[kTerms];
        split_bf16(w * __bfloat162float(xv[k]), t0s);
        split_bf16(w * __bfloat162float(xv[k + 1]), t1s);
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
          reinterpret_cast<uint32_t*>(&u[t])[k / 2] = pack_bf16(t0s[t],
                                                                t1s[t]);
      }
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        *reinterpret_cast<uint4*>(wx_s + (t * Qp + j) * sP + c0) = u[t];
    }
  }
  __syncthreads();

  const int ksteps = (nv + 15) / 16;             // j tiles with a live step
  float* st_h = st + (bc * d.H + h) * N * P;
  // work items (m-tile of 16 state rows, half of the columns), in turn
  constexpr int kHalf = NT / 2;                  // n-tiles of an item
  for (int it = warp; it < pad16(N) / 16 * 2; it += kWarps) {
    const int mt = it >> 1;
    const int nt0 = (it & 1) * kHalf;
    if (nt0 * 8 >= P) continue;
    float acc[kHalf][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t fa[4];
      ldsm_x4_trans(fa, b_s + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * sN +
                            mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < kHalf / 2; ++np) {
        const int c0 = (nt0 + 2 * np) * 8;
        if (c0 >= P) break;
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          uint32_t fv[4];
          ldsm_x4_trans(fv, wx_s + (t * Qp + ks * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * sP +
                                c0 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], fa, fv[0], fv[1]);
          mma_bf16(acc[2 * np + 1], fa, fv[2], fv[3]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = mt * 16 + (lane >> 2) + hf * 8;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < kHalf; ++nt)
        store2(st_h + n * P, (nt0 + nt) * 8 + (lane & 3) * 2, P,
               acc[nt][hf * 2], acc[nt][hf * 2 + 1]);
    }
  }
}

// float32: the bf16 kernel's work items with every product in 3xTF32.
// Steps stream through shared memory kF32JBlock at a time, so each warp
// keeps its (at most two) items' sums in registers across the blocks.  A
// k-step takes steps j = 2t and j + 1 for its columns t and t + 4 (the
// k order of a fragment is free): A = B^T reads B's rows j, j + 1 at
// columns n = g, g + 8 of the m-tile, and the B operand w_j x_j is formed
// in float32 from x's rows j, j + 1 before it is split.
template <int NT>
__global__ void __launch_bounds__(kTileThreads)
    ssd_states_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ Bm,
                          const float* __restrict__ cs,
                          const float* __restrict__ dt,
                          float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kTileThreads / 32;
  constexpr int kHalf = NT / 2;                  // n-tiles of an item
  constexpr int kItems = 2 * (kMaxN / 16) / kWarps;   // items per warp
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * d.Q;
  const int nv = min(d.Q, d.L - t0);
  const long long row0 = static_cast<long long>(b) * d.L + t0;
  const long long bc = static_cast<long long>(b) * d.nc + c;
  const int Qp = d.Qp, P = d.P, N = d.N;
  const int sN = f32_stride(N), sP = f32_stride(P);
  float* b_s = reinterpret_cast<float*>(smem_raw);   // [kF32JBlock][sN]
  float* x_s = b_s + kF32JBlock * sN;                // [kF32JBlock][sP]
  float* w_s = x_s + kF32JBlock * sP;                // [Qp]

  const float* cs_h = cs + (bc * d.H + h) * Qp;
  const float cs_end = cs_h[Qp - 1];
  for (int j = tid; j < Qp; j += kTileThreads)
    w_s[j] = j < nv ? expf(cs_end - cs_h[j]) * dt[(row0 + j) * d.H + h] : 0.f;
  const int n_items = pad16(N) / 16 * 2;
  float acc[kItems][kHalf][4] = {};
  const long long ldx = static_cast<long long>(d.H) * P;
  const float* xh = x + row0 * ldx + static_cast<long long>(h) * P;
  for (int j0 = 0; j0 < nv; j0 += kF32JBlock) {
    const int nj = min(kF32JBlock, nv - j0);
    __syncthreads();                      // w_s written; last block read
    load_f32_rows(b_s, sN, Bm + (row0 + j0) * N, N, nj,
                  pad8(nj), N, tid, kTileThreads);
    load_f32_rows(x_s, sP, xh + j0 * ldx, ldx, nj, pad8(nj), P, tid,
                  kTileThreads);
    cp_async_wait_all();
    __syncthreads();
    const int ksteps = (nj + 7) / 8;
#pragma unroll
    for (int ii = 0; ii < kItems; ++ii) {
      const int it = warp + ii * kWarps;
      const int m0 = (it >> 1) * 16;
      const int nt0 = (it & 1) * kHalf;
      if (it >= n_items || nt0 * 8 >= P) continue;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int j = ks * 8 + 2 * tq;
        const float* br = b_s + j * sN + m0 + g;
        uint32_t ab[4], as[4];
        split_tf32(br[0], ab[0], as[0]);
        split_tf32(br[8], ab[1], as[1]);
        split_tf32(br[sN], ab[2], as[2]);
        split_tf32(br[sN + 8], ab[3], as[3]);
        const float w0 = w_s[j0 + j], w1 = w_s[j0 + j + 1];
        const float* xr = x_s + j * sP + g;
#pragma unroll
        for (int nt = 0; nt < kHalf; ++nt) {
          const int p0 = (nt0 + nt) * 8;
          if (p0 >= P) break;
          uint32_t vb0, vs0, vb1, vs1;
          split_tf32(w0 * xr[p0], vb0, vs0);
          split_tf32(w1 * xr[sP + p0], vb1, vs1);
          mma_3xtf32(acc[ii][nt], ab, as, vb0, vb1, vs0, vs1);
        }
      }
    }
  }
  float* st_h = st + (bc * d.H + h) * N * P;
#pragma unroll
  for (int ii = 0; ii < kItems; ++ii) {
    const int it = warp + ii * kWarps;
    const int m0 = (it >> 1) * 16;
    const int nt0 = (it & 1) * kHalf;
    if (it >= n_items || nt0 * 8 >= P) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = m0 + g + hf * 8;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < kHalf; ++nt)
        store2(st_h + n * P, (nt0 + nt) * 8 + tq * 2, P, acc[ii][nt][hf * 2],
               acc[ii][nt][hf * 2 + 1]);
    }
  }
}

// =============================================================================
// 3. state passing over the chunks, one thread per (4 state elements,
//    head, batch): h_prev written over the chunk states, then h_final
// =============================================================================

__global__ void __launch_bounds__(kPassThreads)
    ssd_state_passing_kernel(const float* __restrict__ cs, float* st,
                             const float* __restrict__ h0,
                             float* __restrict__ h_out, Dims d) {
  const int NP = d.N * d.P;
  const int e0 = (blockIdx.x * kPassThreads + threadIdx.x) * kPassVec;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e0 >= NP) return;
  const int ne = min(kPassVec, NP - e0);
  const bool vec = ne == kPassVec && NP % kPassVec == 0;
  const long long bh = static_cast<long long>(b) * d.H + h;
  auto ld4 = [&](const float* p, float (&v)[kPassVec]) {
    if (vec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPassVec; ++k) v[k] = k < ne ? p[k] : 0.f;
    }
  };
  auto st4 = [&](float* p, const float (&v)[kPassVec]) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kPassVec; ++k)
        if (k < ne) p[k] = v[k];
    }
  };
  float hv[kPassVec];
  if (h0 != nullptr) {
    ld4(h0 + bh * NP + e0, hv);
  } else {
#pragma unroll
    for (int k = 0; k < kPassVec; ++k) hv[k] = 0.f;
  }
  // kPassUnroll chunks' states in flight at once, then the recurrence
  for (int c0 = 0; c0 < d.nc; c0 += kPassUnroll) {
    float s[kPassUnroll][kPassVec], dec[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const long long bch =
          (static_cast<long long>(b) * d.nc + min(c0 + u, d.nc - 1)) * d.H + h;
      ld4(st + bch * NP + e0, s[u]);
      dec[u] = expf(cs[bch * d.Qp + d.Qp - 1]);
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u >= d.nc) break;
      const long long bch = (static_cast<long long>(b) * d.nc + c0 + u) *
                                d.H + h;
      st4(st + bch * NP + e0, hv);
#pragma unroll
      for (int k = 0; k < kPassVec; ++k) hv[k] = hv[k] * dec[u] + s[u][k];
    }
  }
  st4(h_out + bh * NP + e0, hv);
}

// =============================================================================
// 4. chunk output, one CTA per (chunk, head, batch)
// =============================================================================

// The m-tiles of Qp rows a warp takes: one each while there are no more
// tiles than warps, else pairs (q, M-1-q) for q = warp, warp + kWarps,
// ..., so each warp's share of the triangle is even.
template <int kWarps, typename Body>
__device__ __forceinline__ void for_each_mtile(int M, int warp, Body body) {
  if (M <= kWarps) {
    if (warp < M) body(warp);
    return;
  }
  for (int q = warp; q < (M + 1) / 2; q += kWarps) {
    body(q);
    if (M - 1 - q != q) body(M - 1 - q);
  }
}

// bf16: y_off = C . h_prev with C from shared memory (A, ldmatrix) and
// h_prev in kTerms bf16 terms (B, ldmatrix.trans); then y_diag = att . x
// with att built in registers in the A layout from CB (read from L2),
// cs and dt, split into kTerms terms.
// (At most 80 registers, so three CTAs share an SM at P <= 64.)
template <int NT>
__global__ void __launch_bounds__(kTileThreads, NT == 8 ? 3 : 1)
    ssd_output_bf16_kernel(const bf* __restrict__ x, const bf* __restrict__ Cm,
                           const float* __restrict__ cs,
                           const float* __restrict__ dt,
                           const float* __restrict__ cb,
                           const float* __restrict__ st,
                           float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kTileThreads / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * d.Q;
  const int nv = min(d.Q, d.L - t0);
  const long long row0 = static_cast<long long>(b) * d.L + t0;
  const long long bc = static_cast<long long>(b) * d.nc + c;
  const int Qp = d.Qp, P = d.P, N = d.N, Np = pad16(N);
  const int sN = bf_stride(N), sP = bf_stride(P);
  bf* c_s = reinterpret_cast<bf*>(smem_raw);     // [Qp][sN]
  bf* x_s = c_s + Qp * sN;                       // [Qp][sP]
  bf* h_s = x_s + Qp * sP;                       // [kTerms][Np][sP]
  float* cs_s = reinterpret_cast<float*>(h_s + kTerms * Np * sP);  // [Qp]
  float* dt_s = cs_s + Qp;                       // [Qp]
  float* ecs_s = dt_s + Qp;                      // [Qp] exp(cs_i)

  const float* cs_h = cs + (bc * d.H + h) * Qp;
  for (int j = tid; j < Qp; j += kTileThreads) {
    const float v = cs_h[j];
    cs_s[j] = v;
    dt_s[j] = j < nv ? dt[(row0 + j) * d.H + h] : 0.f;
    ecs_s[j] = expf(v);
  }
  load_bf16_rows(c_s, sN, Cm + row0 * N, N, nv, Qp, N, tid, kTileThreads);
  load_bf16_rows(x_s, sP, x + row0 * d.H * P + static_cast<long long>(h) * P,
                 static_cast<long long>(d.H) * P, nv, Qp, P, tid,
                 kTileThreads);
  {
    // h_prev in kTerms bf16 terms; a thread loads kHBatch groups of 8
    // before it converts any, so their latencies overlap
    constexpr int kHBatch = 4;
    const float* hp = st + (bc * d.H + h) * N * P;
    const bool vec = vec_ok(hp, P, P);
    const int groups = pad16(P) / 8;
    const int total = Np * groups;
    for (int i0 = tid; i0 < total; i0 += kHBatch * kTileThreads) {
      float v[kHBatch][8];
#pragma unroll
      for (int k = 0; k < kHBatch; ++k) {
        const int i = i0 + k * kTileThreads;
        const int n = i / groups;
        load8(v[k], hp + static_cast<long long>(n) * P, (i - n * groups) * 8,
              P, i < total && n < N, vec);
      }
#pragma unroll
      for (int k = 0; k < kHBatch; ++k) {
        const int i = i0 + k * kTileThreads;
        if (i >= total) break;
        const int n = i / groups;
        const int c0 = (i - n * groups) * 8;
        uint4 u[kTerms];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          bf a[kTerms], b[kTerms];
          split_bf16(v[k][e], a);
          split_bf16(v[k][e + 1], b);
#pragma unroll
          for (int t = 0; t < kTerms; ++t)
            reinterpret_cast<uint32_t*>(&u[t])[e / 2] = pack_bf16(a[t], b[t]);
        }
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
          *reinterpret_cast<uint4*>(h_s + (t * Np + n) * sP + c0) = u[t];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const float* cbc = cb + bc * Qp * Qp;
  const int M = (nv + 15) / 16;                  // m-tiles with a live row
  for_each_mtile<kWarps>(M, warp, [&](int mt) {
    const int r0 = mt * 16 + (lane >> 2);        // this thread's rows r0, r0+8
    // C.B^T at rows r0 (+8), columns js*16 + (lane&3)*2 + {0,1} (+8), read
    // from L2 one j tile ahead of its use
    const float* cb_t = cbc + r0 * Qp + (lane & 3) * 2;
    auto load_cb = [&](int js, float2 (&v)[4]) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = __ldg(reinterpret_cast<const float2*>(
            cb_t + (q & 1) * 8 * Qp + js * 16 + (q >> 1) * 8));
    };
    float2 cbv[4], cbn[4] = {};
    load_cb(0, cbv);
    float acc[NT][4] = {};
    // y_off = C . h_prev
    for (int kk = 0; kk < Np / 16; ++kk) {
      uint32_t fa[4];
      ldsm_x4(fa, c_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * sN +
                      kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np * 16 >= P) break;
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          uint32_t fv[4];
          ldsm_x4_trans(fv, h_s + (t * Np + kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * sP +
                                np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], fa, fv[0], fv[1]);
          mma_bf16(acc[2 * np + 1], fa, fv[2], fv[3]);
        }
      }
    }
    const float e0 = ecs_s[r0], e1 = ecs_s[r0 + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
    // y_diag = att . x over the j tiles up to the diagonal
    const float cs0 = cs_s[r0], cs1 = cs_s[r0 + 8];
    for (int js = 0; js <= mt; ++js) {
      if (js < mt) load_cb(js + 1, cbn);
      // att at rows r0 (+8), columns j0 + {0, 1} (+8)
      const int j0 = js * 16 + (lane & 3) * 2;
      float av[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = r0 + (q & 1) * 8;
        const int j = j0 + (q >> 1) * 8;
        const float ci = (q & 1) ? cs1 : cs0;
        av[q][0] = j <= i ? cbv[q].x * expf(ci - cs_s[j]) * dt_s[j] : 0.f;
        av[q][1] = j + 1 <= i
                       ? cbv[q].y * expf(ci - cs_s[j + 1]) * dt_s[j + 1]
                       : 0.f;
      }
      uint32_t ap[kTerms][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf lo[kTerms], hi[kTerms];
        split_bf16(av[q][0], lo);
        split_bf16(av[q][1], hi);
#pragma unroll
        for (int t = 0; t < kTerms; ++t) ap[t][q] = pack_bf16(lo[t], hi[t]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np * 16 >= P) break;
        uint32_t fv[4];
        ldsm_x4_trans(fv, x_s + (js * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * sP +
                              np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          mma_bf16(acc[2 * np], ap[t], fv[0], fv[1]);
          mma_bf16(acc[2 * np + 1], ap[t], fv[2], fv[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) cbv[q] = cbn[q];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = r0 + hf * 8;
      if (i >= nv) continue;
      float* yr = y + ((row0 + i) * d.H + h) * P;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store2(yr, nt * 8 + (lane & 3) * 2, P, acc[nt][hf * 2],
               acc[nt][hf * 2 + 1]);
    }
  });
}

// float32: the bf16 kernel's m-tiles with every product in 3xTF32.  x
// and h_prev sit in shared memory at the padded float32 stride; the A
// fragments of C . h_prev are C's rows of the m-tile read from global
// memory (L2: every head of the chunk reads them), those of att . x are
// built in registers from CB (read from L2 one k-step ahead), cs and dt.
// A k-step takes k = 2t and 2t + 1 for its columns t and t + 4, so CB's
// pair comes as one float2 and x's and h_prev's B fragments are scalar
// loads of rows 2t, 2t + 1.
template <int NT>
__global__ void __launch_bounds__(kTileThreads, NT == 8 ? 3 : 1)
    ssd_output_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ Cm,
                          const float* __restrict__ cs,
                          const float* __restrict__ dt,
                          const float* __restrict__ cb,
                          const float* __restrict__ st,
                          float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kTileThreads / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * d.Q;
  const int nv = min(d.Q, d.L - t0);
  const long long row0 = static_cast<long long>(b) * d.L + t0;
  const long long bc = static_cast<long long>(b) * d.nc + c;
  const int Qp = d.Qp, P = d.P, N = d.N, N8 = pad8(N);
  const int sP = f32_stride(P);
  float* x_s = reinterpret_cast<float*>(smem_raw);   // [Qp][sP]
  float* h_s = x_s + Qp * sP;                        // [N8][sP]
  float* cs_s = h_s + N8 * sP;                       // [Qp]
  float* dt_s = cs_s + Qp;                           // [Qp]
  float* ecs_s = dt_s + Qp;                          // [Qp] exp(cs_i)

  const float* cs_h = cs + (bc * d.H + h) * Qp;
  for (int j = tid; j < Qp; j += kTileThreads) {
    const float v = cs_h[j];
    cs_s[j] = v;
    dt_s[j] = j < nv ? dt[(row0 + j) * d.H + h] : 0.f;
    ecs_s[j] = expf(v);
  }
  const long long ldx = static_cast<long long>(d.H) * P;
  load_f32_rows(x_s, sP, x + row0 * ldx + static_cast<long long>(h) * P, ldx,
                nv, Qp, P, tid, kTileThreads);
  load_f32_rows(h_s, sP, st + (bc * d.H + h) * N * P, P, N, N8, P, tid,
                kTileThreads);
  cp_async_wait_all();
  __syncthreads();

  const float* cbc = cb + bc * Qp * Qp;
  const int M = (nv + 15) / 16;                  // m-tiles with a live row
  for_each_mtile<kWarps>(M, warp, [&](int mt) {
    const int r0 = mt * 16 + g;                  // this thread's rows r0, r0+8
    const bool l0 = r0 < nv, l1 = r0 + 8 < nv;
    const float* c0 = Cm + (row0 + r0) * N;
    const float* c1 = c0 + 8 * N;
    float acc[NT][4] = {};
    // y_off = C . h_prev
    for (int kk = 0; kk < N8 / 8; ++kk) {
      const int n = kk * 8 + 2 * tq;
      uint32_t ab[4], as[4];
      split_ldg(c0 + n, l0 && n < N, ab[0], as[0]);
      split_ldg(c1 + n, l1 && n < N, ab[1], as[1]);
      split_ldg(c0 + n + 1, l0 && n + 1 < N, ab[2], as[2]);
      split_ldg(c1 + n + 1, l1 && n + 1 < N, ab[3], as[3]);
      const float* hr = h_s + n * sP + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= P) break;
        uint32_t vb0, vs0, vb1, vs1;
        split_tf32(hr[nt * 8], vb0, vs0);
        split_tf32(hr[sP + nt * 8], vb1, vs1);
        mma_3xtf32(acc[nt], ab, as, vb0, vb1, vs0, vs1);
      }
    }
    const float e0 = ecs_s[r0], e1 = ecs_s[r0 + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
    // y_diag = att . x over the k-steps of 8 steps up to the diagonal
    const float cs0 = cs_s[r0], cs1 = cs_s[r0 + 8];
    const float* cb0 = cbc + r0 * Qp + 2 * tq;
    const float* cb1 = cb0 + 8 * Qp;
    const int ksteps = 2 * mt + 2;
    float2 v0 = __ldg(reinterpret_cast<const float2*>(cb0));
    float2 v1 = __ldg(reinterpret_cast<const float2*>(cb1));
    for (int ks = 0; ks < ksteps; ++ks) {
      float2 n0 = v0, n1 = v1;
      if (ks + 1 < ksteps) {
        n0 = __ldg(reinterpret_cast<const float2*>(cb0 + (ks + 1) * 8));
        n1 = __ldg(reinterpret_cast<const float2*>(cb1 + (ks + 1) * 8));
      }
      // att at rows r0 (+8), steps j, j + 1
      const int j = ks * 8 + 2 * tq;
      const float d0 = dt_s[j], d1 = dt_s[j + 1];
      const float s0 = cs_s[j], s1 = cs_s[j + 1];
      uint32_t ab[4], as[4];
      split_tf32(j <= r0 ? v0.x * expf(cs0 - s0) * d0 : 0.f, ab[0], as[0]);
      split_tf32(j <= r0 + 8 ? v1.x * expf(cs1 - s0) * d0 : 0.f, ab[1],
                 as[1]);
      split_tf32(j + 1 <= r0 ? v0.y * expf(cs0 - s1) * d1 : 0.f, ab[2],
                 as[2]);
      split_tf32(j + 1 <= r0 + 8 ? v1.y * expf(cs1 - s1) * d1 : 0.f, ab[3],
                 as[3]);
      const float* xr = x_s + j * sP + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= P) break;
        uint32_t vb0, vs0, vb1, vs1;
        split_tf32(xr[nt * 8], vb0, vs0);
        split_tf32(xr[sP + nt * 8], vb1, vs1);
        mma_3xtf32(acc[nt], ab, as, vb0, vb1, vs0, vs1);
      }
      v0 = n0;
      v1 = n1;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = r0 + hf * 8;
      if (i >= nv) continue;
      float* yr = y + ((row0 + i) * d.H + h) * P;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store2(yr, nt * 8 + tq * 2, P, acc[nt][hf * 2], acc[nt][hf * 2 + 1]);
    }
  });
}

// =============================================================================
// launch plans
// =============================================================================

struct Plan {
  const void* kernel;
  int* granted;          // the shared-memory limit raised so far
  dim3 grid;
  int threads;
  size_t smem;
};

constexpr int kPasses = 4;

// Dynamic shared memory of each product pass, from the tiles above
// (tests/test_torch_ssd_f32_tc.py mirrors these sizes).
constexpr size_t prologue_smem(bool bf16, int Qp, int N) {
  return bf16 ? 2 * static_cast<size_t>(Qp) * bf_stride(N) * 2
              : 4 * static_cast<size_t>(Qp) * f32_stride(N);
}
constexpr size_t states_smem(bool bf16, int Qp, int P, int N) {
  return bf16 ? static_cast<size_t>(Qp) * bf_stride(N) * 2 +
                    static_cast<size_t>(kTerms) * Qp * bf_stride(P) * 2 +
                    4 * Qp
              : 4 * (static_cast<size_t>(kF32JBlock) *
                         (f32_stride(N) + f32_stride(P)) +
                     Qp);
}
constexpr size_t output_smem(bool bf16, int Qp, int P, int N) {
  return bf16 ? static_cast<size_t>(Qp) * (bf_stride(N) + bf_stride(P)) * 2 +
                    static_cast<size_t>(kTerms) * pad16(N) * bf_stride(P) *
                        2 +
                    12 * Qp
              : 4 * (static_cast<size_t>(Qp + pad8(N)) * f32_stride(P) +
                     3 * Qp);
}
// the widest tiles of the range fit the card: every in-range shape does
static_assert(prologue_smem(true, kMaxQ, kMaxN) <= kMaxSmem, "smem");
static_assert(prologue_smem(false, kMaxQ, kMaxN) <= kMaxSmem, "smem");
static_assert(states_smem(true, kMaxQ, kMaxP, kMaxN) <= kMaxSmem, "smem");
static_assert(states_smem(false, kMaxQ, kMaxP, kMaxN) <= kMaxSmem, "smem");
static_assert(output_smem(true, kMaxQ, kMaxP, kMaxN) <= kMaxSmem, "smem");
static_assert(output_smem(false, kMaxQ, kMaxP, kMaxN) <= kMaxSmem, "smem");

template <typename T>
void make_plans(int B, const Dims& d, Plan (&pl)[kPasses]) {
  constexpr bool kBf16 = sizeof(T) == 2;
  static int granted[6] = {0, 0, 0, 0, 0, 0};
  const dim3 tiles(d.nc, d.H, B);
  const bool wide = d.P > 64;
  pl[0] = {(const void*)ssd_prologue_kernel<T>, &granted[0], dim3(d.nc, B),
           kPrologueThreads, prologue_smem(kBf16, d.Qp, d.N)};
  if constexpr (kBf16) {
    pl[1] = {wide ? (const void*)ssd_states_bf16_kernel<16>
                  : (const void*)ssd_states_bf16_kernel<8>,
             &granted[wide ? 2 : 1], tiles, kTileThreads, 0};
    pl[3] = {wide ? (const void*)ssd_output_bf16_kernel<16>
                  : (const void*)ssd_output_bf16_kernel<8>,
             &granted[wide ? 4 : 3], tiles, kTileThreads, 0};
  } else {
    pl[1] = {wide ? (const void*)ssd_states_f32_kernel<16>
                  : (const void*)ssd_states_f32_kernel<8>,
             &granted[wide ? 2 : 1], tiles, kTileThreads, 0};
    pl[3] = {wide ? (const void*)ssd_output_f32_kernel<16>
                  : (const void*)ssd_output_f32_kernel<8>,
             &granted[wide ? 4 : 3], tiles, kTileThreads, 0};
  }
  pl[1].smem = states_smem(kBf16, d.Qp, d.P, d.N);
  pl[3].smem = output_smem(kBf16, d.Qp, d.P, d.N);
  pl[2] = {(const void*)ssd_state_passing_kernel, &granted[5],
           dim3((d.N * d.P + kPassThreads * kPassVec - 1) /
                    (kPassThreads * kPassVec),
                d.H, B),
           kPassThreads, 0};
}

// Raise the kernel's dynamic shared-memory limit to the plan's need if no
// launch has yet: later launches make no API call, so a CUDA graph can
// capture them (one card per process).
cudaError_t allow_smem(const Plan& pl) {
  if (pl.smem <= 48 * 1024 || static_cast<int>(pl.smem) <= *pl.granted)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem));
  if (err == cudaSuccess) *pl.granted = static_cast<int>(pl.smem);
  return err;
}

bool dims_of(int L, int H, int P, int N, int Q, Dims* d) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      L < 1 || H < 1)
    return false;
  *d = {L, H, P, N, Q, pad16(Q), (L + Q - 1) / Q};
  return true;
}

// Launches the four kernels of a call, in order, on `stream`: each plan's
// kernel with its arguments (the bf16 and float32 kernels of a pass take
// the same arguments).
template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, float* y, float* h_out, float* cs,
           float* cb, float* st, int B, int L, int H, int P, int N, int Q,
           cudaStream_t stream) {
  Dims d;
  if (!dims_of(L, H, P, N, Q, &d) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl[kPasses];
  make_plans<T>(B, d, pl);
  void* prologue[] = {&dt, &A, &Bm, &Cm, &cs, &cb, &d};
  void* states[] = {&x, &Bm, &cs, &dt, &st, &d};
  void* passing[] = {&cs, &st, &h0, &h_out, &d};
  void* output[] = {&x, &Cm, &cs, &dt, &cb, &st, &y, &d};
  void** args[kPasses] = {prologue, states, passing, output};
  for (int k = 0; k < kPasses; ++k) {
    cudaError_t err = allow_smem(pl[k]);
    if (err == cudaSuccess)
      err = cudaLaunchKernel(pl[k].kernel, pl[k].grid, dim3(pl[k].threads),
                             args[k], pl[k].smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, L, H, P], dt [B, L, H], A [H], Bm/Cm [B, L, N], h0 [B, H, N, P]
// or null; y [B, L, H, P], h_out [B, H, N, P]; the float32 workspace cs,
// cb and st as ssd_scan_workspace sizes it.
#define SSD_SCAN_ENTRY(NAME, T)                                               \
  EXPORT int NAME(const void* x, const float* dt, const float* A,             \
                  const void* Bm, const void* Cm, const float* h0, float* y,  \
                  float* h_out, float* cs, float* cb, float* st, int B,       \
                  int L, int H, int P, int N, int Q, cudaStream_t stream) {   \
    return launch<T>(x, dt, A, Bm, Cm, h0, y, h_out, cs, cb, st, B, L, H, P,  \
                     N, Q, stream);                                           \
  }

SSD_SCAN_ENTRY(ssd_scan_f32, float)
SSD_SCAN_ENTRY(ssd_scan_bf16, __nv_bfloat16)

// How a call launches, for measurement: for each of the four kernels in
// order, info[5k .. 5k+4] = CTAs in the grid, threads per CTA, dynamic
// shared memory bytes, CTAs resident per SM (the occupancy calculator,
// after the shared-memory limit is raised), 1 (no clusters).
EXPORT int ssd_scan_launch_info(int bf16, int B, int L, int H, int P, int N,
                                int Q, int* info) {
  Dims d;
  if (!dims_of(L, H, P, N, Q, &d) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl[kPasses];
  if (bf16)
    make_plans<__nv_bfloat16>(B, d, pl);
  else
    make_plans<float>(B, d, pl);
  for (int k = 0; k < kPasses; ++k) {
    cudaError_t err = allow_smem(pl[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pl[k].kernel, pl[k].threads, pl[k].smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[5 * k] = static_cast<int>(pl[k].grid.x * pl[k].grid.y * pl[k].grid.z);
    info[5 * k + 1] = pl[k].threads;
    info[5 * k + 2] = static_cast<int>(pl[k].smem);
    info[5 * k + 3] = per_sm;
    info[5 * k + 4] = 1;
  }
  return 0;
}

// The float32 workspace of a call, in elements, in the entry's order
// (nc = ceil(L / Q), Qp = Q rounded up to 16): elems[0] cs [B, nc, H, Qp],
// elems[1] cb = C.B^T [B, nc, Qp, Qp], elems[2] st, the chunk states and
// then h_prev, [B, nc, H, N, P].
EXPORT int ssd_scan_workspace(int B, int L, int H, int P, int N, int Q,
                              long long* elems) {
  Dims d;
  if (!dims_of(L, H, P, N, Q, &d) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bnc = static_cast<long long>(B) * d.nc;
  elems[0] = bnc * d.H * d.Qp;
  elems[1] = bnc * d.Qp * d.Qp;
  elems[2] = bnc * d.H * d.N * d.P;
  return 0;
}

// K9: the Mamba-2 SSD chunked scan.
//
// Replaces repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (grid
// (B, n_chunks); the chunk axis runs in order on the TPU, so the state
// h [H, N, P] of every head persists in VMEM scratch from chunk to
// chunk).  It computes what that kernel computes: per chunk of Q steps
// the dA cumsum, the intra-chunk attention form
// y_diag = (C.B^T o exp(seg) o dt) . x over j <= i, the inter-chunk
// output y_off = (C . h_prev) o exp(dA_cs), and the state update
// h = h * exp(dA_sum) + sum_j exp(dA_sum - dA_cs_j) dt_j B_j (x) x_j;
// y and the final state come out in float32.  B and C are shared by all
// heads (G = 1), as the Pallas kernel takes them.
//
// What changes from the TPU design: blocks run in no order on Hopper, so
// nothing can carry from one block to the next.  One CTA owns one
// (batch, head) and walks its chunks in a loop, keeping that head's
// state h [N, P] in shared memory (16 KB at zamba2's N = P = 64, 32 KB
// at mamba2's N = 128); zamba2's B = 4, H = 112 gives 448 CTAs for 132
// SMs.  A ragged last chunk is masked in the kernel: steps past L load
// dt = 0 and zero x, B, C (identity steps, exactly what padding gives)
// and write no y, so the wrapper never copies its inputs.  exp() of the
// intra-chunk decay is taken only where j <= i (the TPU form takes it
// over the whole square and selects the upper triangle away), and a
// warp's rows stop their j loop at their own diagonal.
//
// Shared memory per CTA (float32): x [Q, P], B [Q, N+1] (padded so the
// lanes of a warp, one j each, hit distinct banks), C [Q, N], h [N, P],
// one 32-row tile of the attention form [32, Q], and four [Q] vectors:
// 211 KB at Q = 128, P = 64, N = 128, so one CTA per SM.  Every product
// is a float32 FMA from shared memory into registers (4 rows x up to 4
// columns per thread); no TF32, no bf16 accumulation, no tensor cores.
// Each head's CTA recomputes C.B^T, which all heads share (G = 1): the
// price of one CTA per head.
//
// Bound on the H100: x, B, C and dt read once, y (float32) written once,
// h_final written once; operations ~ 2*B*H*L*Q*(N+P) (attention form,
// the full square) + 4*B*H*L*N*P (chunk states and y_off).  At zamba2's
// prefill shape (B 4, L 2000, H 112, P 64, N 64, Q 128, bf16 x/B/C) that
// is ~44 GFLOP against ~357 MB (y in float32 is two thirds of it):
// 0.045 ms at the bf16 tensor-core rate, 0.107 ms at 3.35 TB/s, so bytes
// bound it.  This first kernel runs its ~44 GFLOP on the float32 FMA
// units from shared memory, far from that bound; tensor cores and a
// chunk-parallel two-pass design are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;   // rows of a y tile
constexpr int kMaxQ = 256;
constexpr int kMaxColGroups = 4;                   // P <= 128
constexpr int kMaxJGroups = kMaxQ / 32;
constexpr int kMaxN = 128;
constexpr int kMaxStateRows = kMaxN / kWarps;      // N rows per warp

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) * (static_cast<size_t>(Q) * P + Q * (N + 1) +
                          Q * N + N * P + kTileRows * Q + 4 * Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int L,
                int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int bstride = N + 1;
  float* x_s = smem;                   // [Q, P]
  float* b_s = x_s + Q * P;            // [Q, N+1]
  float* c_s = b_s + Q * bstride;      // [Q, N]
  float* h_s = c_s + Q * N;            // [N, P]
  float* att_s = h_s + N * P;          // [kTileRows, Q]
  float* dt_s = att_s + kTileRows * Q; // [Q]
  float* cs_s = dt_s + Q;              // [Q] inclusive cumsum of dt * A
  float* w_s = cs_s + Q;               // [Q] exp(cs_end - cs_j) * dt_j
  float* ecs_s = w_s + Q;              // [Q] exp(cs_i)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float a = A[hd];
  const long long hbase = static_cast<long long>(bh) * N * P;

  for (int i = tid; i < N * P; i += kThreads)
    h_s[i] = h0 != nullptr ? h0[hbase + i] : 0.f;

  const int n_chunks = (L + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int nv = min(Q, L - t0);     // live steps of this chunk
    __syncthreads();                   // the previous chunk is done
    const long long row0 = static_cast<long long>(b) * L + t0;
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P;
      const int p = i - j * P;
      x_s[i] = j < nv ? to_float(x[((row0 + j) * H + hd) * P + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N;
      const int n = i - j * N;
      float bv = 0.f, cv = 0.f;
      if (j < nv) {
        bv = to_float(Bm[(row0 + j) * N + n]);
        cv = to_float(Cm[(row0 + j) * N + n]);
      }
      b_s[j * bstride + n] = bv;
      c_s[i] = cv;
    }
    for (int j = tid; j < Q; j += kThreads)
      dt_s[j] = j < nv ? dt[(row0 + j) * H + hd] : 0.f;
    __syncthreads();

    // inclusive cumsum of dA = dt * A: each lane a run of steps, then a
    // warp scan of the runs' totals
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int lo = lane * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int j = lo + k;
        if (j < Q) {
          run += dt_s[j] * a;
          cs_s[j] = run;
        }
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += v;
      }
      const float excl = tot - run;
      for (int k = 0; k < per; ++k) {
        const int j = lo + k;
        if (j < Q) cs_s[j] += excl;
      }
    }
    __syncthreads();
    const float cs_end = cs_s[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      w_s[j] = expf(cs_end - cs_s[j]) * dt_s[j];
      ecs_s[j] = expf(cs_s[j]);
    }
    __syncthreads();

    // y, one tile of kTileRows rows at a time; a warp owns 4 rows of the
    // tile (its rows of att_s too), a lane the columns lane + 32 * cg
    for (int i0 = 0; i0 < nv; i0 += kTileRows) {
      const int r0 = i0 + warp * kRowsPerWarp;
      if (r0 < nv) {
        int ir[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) ir[r] = min(r0 + r, Q - 1);
        const int jmax = min(Q, r0 + kRowsPerWarp);  // j <= the last row
        float* att_w = att_s + warp * kRowsPerWarp * Q;
#pragma unroll
        for (int cg = 0; cg < kMaxJGroups; ++cg) {
          if (32 * cg >= jmax) break;
          const int j = lane + 32 * cg;
          float dot[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = 0.f;
          if (j < jmax) {
            const float* br = b_s + j * bstride;
            for (int n = 0; n < N; ++n) {
              const float bv = br[n];
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r)
                dot[r] = fmaf(c_s[ir[r] * N + n], bv, dot[r]);
            }
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const int i = r0 + r;
              float v = 0.f;
              if (j <= i && i < Q)
                v = dot[r] * expf(cs_s[i] - cs_s[j]) * dt_s[j];
              att_w[r * Q + j] = v;
            }
          }
        }
        __syncwarp();

        float accd[kRowsPerWarp][kMaxColGroups];
        float acco[kRowsPerWarp][kMaxColGroups];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int cg = 0; cg < kMaxColGroups; ++cg) {
            accd[r][cg] = 0.f;
            acco[r][cg] = 0.f;
          }
        for (int j = 0; j < jmax; ++j) {      // y_diag
          float xv[kMaxColGroups];
#pragma unroll
          for (int cg = 0; cg < kMaxColGroups; ++cg) {
            const int p = lane + 32 * cg;
            xv[cg] = p < P ? x_s[j * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float av = att_w[r * Q + j];
#pragma unroll
            for (int cg = 0; cg < kMaxColGroups; ++cg)
              accd[r][cg] = fmaf(av, xv[cg], accd[r][cg]);
          }
        }
        for (int n = 0; n < N; ++n) {         // C . h_prev
          float hv[kMaxColGroups];
#pragma unroll
          for (int cg = 0; cg < kMaxColGroups; ++cg) {
            const int p = lane + 32 * cg;
            hv[cg] = p < P ? h_s[n * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float cv = c_s[ir[r] * N + n];
#pragma unroll
            for (int cg = 0; cg < kMaxColGroups; ++cg)
              acco[r][cg] = fmaf(cv, hv[cg], acco[r][cg]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = r0 + r;
          if (i >= nv) continue;
          const float e = ecs_s[i];
          float* yr = y + ((row0 + i) * H + hd) * P;
#pragma unroll
          for (int cg = 0; cg < kMaxColGroups; ++cg) {
            const int p = lane + 32 * cg;
            if (p < P) yr[p] = accd[r][cg] + acco[r][cg] * e;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();                   // every read of h_prev is done

    // state update: a warp owns rows n = warp + kWarps * r of h
    const float dec = expf(cs_end);
    float acc[kMaxStateRows][kMaxColGroups];
#pragma unroll
    for (int r = 0; r < kMaxStateRows; ++r)
#pragma unroll
      for (int cg = 0; cg < kMaxColGroups; ++cg) acc[r][cg] = 0.f;
    for (int j = 0; j < nv; ++j) {     // steps past nv add exactly 0
      const float wj = w_s[j];
      float xw[kMaxColGroups];
#pragma unroll
      for (int cg = 0; cg < kMaxColGroups; ++cg) {
        const int p = lane + 32 * cg;
        xw[cg] = p < P ? wj * x_s[j * P + p] : 0.f;
      }
      const float* br = b_s + j * bstride;
#pragma unroll
      for (int r = 0; r < kMaxStateRows; ++r) {
        const int n = warp + kWarps * r;
        if (n < N) {
          const float bv = br[n];
#pragma unroll
          for (int cg = 0; cg < kMaxColGroups; ++cg)
            acc[r][cg] = fmaf(bv, xw[cg], acc[r][cg]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxStateRows; ++r) {
      const int n = warp + kWarps * r;
      if (n >= N) continue;
#pragma unroll
      for (int cg = 0; cg < kMaxColGroups; ++cg) {
        const int p = lane + 32 * cg;
        if (p < P) h_s[n * P + p] = h_s[n * P + p] * dec + acc[r][cg];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) h_out[hbase + i] = h_s[i];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, float* y, float* h_out, int B,
           int L, int H, int P, int N, int Q, cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > 32 * kMaxColGroups || N < 1 ||
      N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, y, h_out, L, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT int ssd_scan_f32(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const float* h0,
                        float* y, float* h_out, int B, int L, int H, int P,
                        int N, int Q, cudaStream_t stream) {
  return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, B, L, H, P, N, Q,
                       stream);
}

EXPORT int ssd_scan_bf16(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, const float* h0,
                         float* y, float* h_out, int B, int L, int H, int P,
                         int N, int Q, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h_out, B, L, H, P,
                               N, Q, stream);
}

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
// (each touched expert's 3 x D x FF elements once; a few rows a group);
// in a long prefill, the FMA rate (2 R D FF x 3 operations; this first
// kernel multiplies on the FMA units, not the tensor cores).
//
// Design.  The grid covers (output-column tile, expert) for every expert,
// whatever the routing: no group size is read on the host.  A CTA reads
// its group's row range from offs and returns at once when the group is
// empty.  It walks its rows in tiles of BM; for each row tile it streams
// the weight columns it owns through shared memory in BK-deep stages
// (cp.async, two stages), so a weight tile is read once per row tile, not
// once per row.  Warps whose rows all lie past the group's end skip the
// products (a decode group holds one or two rows).
//
// The bit rule: each output element is one thread's fmaf chain over the
// reduction axis in index order, so a row's bits depend on neither its
// neighbours, its group size nor its place in the group.
#include "common.cuh"

namespace {

constexpr int BM = 32;        // rows per row tile
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 32;        // reduction depth per stage
constexpr int TM = 2;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = 256;  // 16 column groups x 16 row groups
static_assert((BN / TN) * (BM / TM) == THREADS, "thread tile");

__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&b)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  b[0] = lo.x;
  b[1] = lo.y;
  b[2] = hi.x;
  b[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  uint2 u;
  u.x = pack_bf16(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
  u.y = pack_bf16(__float2bfloat16(v[2]), __float2bfloat16(v[3]));
  *reinterpret_cast<uint2*>(p) = u;
}

// GLU: out = h (type T) from the gate and up products; otherwise out = y
// (float32) from one product, scaled by the row's gate weight.
template <typename T, bool GLU>
__global__ void __launch_bounds__(THREADS)
    moe_ffn_kernel(const T* __restrict__ x, const int32_t* __restrict__ offs,
                   const T* __restrict__ w0, const T* __restrict__ w1,
                   const float* __restrict__ gate, void* __restrict__ out,
                   int K, int N) {
  constexpr int EL = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int NW = GLU ? 2 : 1;
  __shared__ __align__(16) T xs[2][BM][BK + EL];
  __shared__ __align__(16) T ws[2][NW][BK][BN];

  const int e = blockIdx.y;
  const int r0 = offs[e];
  const int nrows = offs[e + 1] - r0;
  if (nrows <= 0) return;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  // a warp holds two row groups: rows 2 * TM * warp .. + 2 * TM - 1
  const int warp_row0 = (tid / 32) * 2 * TM;
  const size_t wbase = static_cast<size_t>(e) * K * N;
  const int KT = K / BK;

  auto load = [&](int s, int m0, int k0) {
    for (int c = tid; c < BM * BK / EL; c += THREADS) {
      const int row = c / (BK / EL), col = (c % (BK / EL)) * EL;
      const bool ok = m0 + row < nrows;  // rows past the group read zeros
      const T* src = x + static_cast<size_t>(r0 + (ok ? m0 + row : 0)) * K +
                     k0 + col;
      cp_async16(&xs[s][row][col], src, ok);
    }
    for (int c = tid; c < BK * BN / EL; c += THREADS) {
      const int row = c / (BN / EL), col = (c % (BN / EL)) * EL;
      const size_t g = wbase + static_cast<size_t>(k0 + row) * N + n0 + col;
      cp_async16(&ws[s][0][row][col], w0 + g, true);
      if constexpr (GLU) cp_async16(&ws[s][1][row][col], w1 + g, true);
    }
    cp_async_commit();
  };

  for (int m0 = 0; m0 < nrows; m0 += BM) {
    const bool active = warp_row0 < nrows - m0;
    float acc[NW][TM][TN];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[w][i][j] = 0.f;

    load(0, m0, 0);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt & 1;
      if (kt + 1 < KT) {
        load(s ^ 1, m0, (kt + 1) * BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          float a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = to_float(xs[s][ty * TM + i][k]);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            float b[TN];
            load4(&ws[s][w][k][tx * TN], b);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[w][i][j] = fmaf(a[i], b[j], acc[w][i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row >= nrows) continue;
      const size_t o = static_cast<size_t>(r0 + row) * N + n0 + tx * TN;
      float v[TN];
      if constexpr (GLU) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float g = acc[0][i][j];
          v[j] = g / (1.f + expf(-g)) * acc[1][i][j];
        }
        store4(static_cast<T*>(out) + o, v);
      } else {
        const float gw = gate[r0 + row];
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = acc[0][i][j] * gw;
        store4(static_cast<float*>(out) + o, v);
      }
    }
  }
}

template <typename T>
int gate_up(const void* x, const void* offs, const void* wg, const void* wu,
            void* h, int E, int D, int FF, void* stream) {
  moe_ffn_kernel<T, true><<<dim3(FF / BN, E), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(offs),
      static_cast<const T*>(wg), static_cast<const T*>(wu), nullptr, h, D,
      FF);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int down(const void* h, const void* offs, const void* wd, const void* gate,
         void* y, int E, int D, int FF, void* stream) {
  moe_ffn_kernel<T, false><<<dim3(D / BN, E), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const int32_t*>(offs),
      static_cast<const T*>(wd), nullptr, static_cast<const float*>(gate), y,
      FF, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes the wrapper has checked: D and FF multiples of BN (64), every
// base 16-byte aligned, all tensors contiguous on the card.
EXPORT int moe_gate_up_bf16(const void* x, const void* offs, const void* wg,
                            const void* wu, void* h, int E, int D, int FF,
                            void* stream) {
  return gate_up<__nv_bfloat16>(x, offs, wg, wu, h, E, D, FF, stream);
}
EXPORT int moe_gate_up_f32(const void* x, const void* offs, const void* wg,
                           const void* wu, void* h, int E, int D, int FF,
                           void* stream) {
  return gate_up<float>(x, offs, wg, wu, h, E, D, FF, stream);
}
EXPORT int moe_down_bf16(const void* h, const void* offs, const void* wd,
                         const void* gate, void* y, int E, int D, int FF,
                         void* stream) {
  return down<__nv_bfloat16>(h, offs, wd, gate, y, E, D, FF, stream);
}
EXPORT int moe_down_f32(const void* h, const void* offs, const void* wd,
                        const void* gate, void* y, int E, int D, int FF,
                        void* stream) {
  return down<float>(h, offs, wd, gate, y, E, D, FF, stream);
}

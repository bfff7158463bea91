// Shared by the moe_ffn kernels (moe_ffn.cu) and their backward
// (moe_ffn_bwd.cu): the plan of (expert, row tile, column tile) units
// that a CTA lays out in shared memory from the group offsets, which it
// reads on the device, the backward's weight-gradient walk order
// (heaviest expert first), and the SwiGLU's silu(g) * u.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxExperts = 256;
// offs, the units' prefix and the group sizes in shared memory
constexpr int kPlanBytes = 4 * (3 * kMaxExperts + 1);

struct Unit {
  int e;     // expert
  int row;   // first row of the tile
  int rows;  // rows of the group from `row` on
  int n;     // column tile
};

// Warp 0: start[e] = first unit of expert e (start[E] = all units),
// row0[e] and rows[e] its group, bm rows a tile, nt column tiles.
__device__ __forceinline__ void plan_units(const int32_t* __restrict__ offs,
                                           int E, int bm, int nt, int* start,
                                           int* row0, int* rows) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    int n = 0;
    if (e < E) {
      const int a = offs[e];
      const int r = max(offs[e + 1] - a, 0);
      row0[e] = a;
      rows[e] = r;
      n = (r + bm - 1) / bm * nt;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, n, o);
      if (lane >= o) n += v;
    }
    if (e < E) start[e + 1] = carry + n;
    carry += __shfl_sync(0xffffffffu, n, 31);
  }
  if (lane == 0) start[0] = 0;
}

// Unit u: its expert is the last with start[e] <= u (never an empty
// one), row tiles fastest within the expert.
__device__ __forceinline__ Unit unit_at(const int* start, const int* row0,
                                        const int* rows, int E, int bm,
                                        int u) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= u) lo = mid;
    else hi = mid;
  }
  const int mt = (rows[lo] + bm - 1) / bm;
  const int local = u - start[lo];
  const int m = local % mt;
  return Unit{lo, row0[lo] + m * bm, rows[lo] - m * bm, local / mt};
}

// All the CTA's threads: order[i] = the expert of rank i by its rows (from
// plan_units), heaviest first, ties by index.  The caller syncs before
// reading order.
__device__ __forceinline__ void heaviest_first(const int* rows, int E,
                                               int* order) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int rank = 0;
    for (int f = 0; f < E; ++f)
      rank += rows[f] > rows[e] || (rows[f] == rows[e] && f < e);
    order[rank] = e;
  }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

}  // namespace

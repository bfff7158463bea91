// What mma.sync m16n8k8 with TF32 operands does on the card, for the
// 3xTF32 split of the float32 attention kernels (csrc/common.cuh):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o /tmp/mma_tf32_probe tools/mma_tf32_probe.cu && /tmp/mma_tf32_probe
//
// 1. operand bits: an A operand with bits below TF32's 10 mantissa bits
//    set, times 1, shows what the tensor cores read (x truncated at 10
//    bits, x rounded, or all of x);
// 2. accumulation: 1 + 0.75 ulp(1) added through the tensor cores shows
//    whether the float32 sum rounds to nearest or toward zero;
// 3. rate: TFLOP/s of independent m16n8k8 TF32 mma.sync on every SM at 4,
//    8 and 16 warps per SM (8 accumulators per warp).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

static float bits_trunc(float x) {            // x with its low 13 bits cleared
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u &= 0xffffe000u;
  std::memcpy(&x, &u, 4);
  return x;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[0][0] = c0 + a . b with A's column 0 = x, B's row 0 = 1, the rest 0
__global__ void one_product(float x, float c0, float* out) {
  const bool col0 = (threadIdx.x & 3) == 0;
  const uint32_t a[4] = {col0 ? __float_as_uint(x) : 0u,
                         col0 ? __float_as_uint(x) : 0u, 0u, 0u};
  float c[4] = {c0, c0, c0, c0};
  mma_tf32(c, a, col0 ? __float_as_uint(1.f) : 0u, 0u);
  if (threadIdx.x == 0) out[0] = c[0];
}

template <int CHAINS>
__global__ void rate(float* out, int iters) {
  const uint32_t a[4] = {__float_as_uint(1e-3f), 0u, 0u, 0u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) mma_tf32(c[k], a, a[0], a[1]);
  float s = 0.f;
  for (int k = 0; k < CHAINS; ++k) s += c[k][0];
  if (s == 12345.f) out[0] = s;                // keeps the loop
}

static float run_one(float x, float c0, float* d) {
  float h = 0.f;
  one_product<<<1, 32>>>(x, c0, d);
  cudaMemcpy(&h, d, 4, cudaMemcpyDeviceToHost);
  return h;
}

int main() {
  float* d = nullptr;
  cudaMalloc(&d, 4);
  const float xs[] = {1.f + 1.f / 4096, 1.f + 3.f / 8192,
                      1.f + 1.f / 1024 + 1.f / 4096, -(1.f + 3.f / 8192)};
  for (float x : xs)
    printf("operand x=%.10g read as %.10g (truncated %.10g)\n", x,
           run_one(x, 0.f, d), bits_trunc(x));
  const float p = 3.f / 33554432.f;            // 0.75 ulp of 1
  printf("accumulate 1 + %.6g -> %.10g (nearest %.10g, toward zero 1)\n", p,
         run_one(p, 1.f, d), 1.f + p);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int warps : {4, 8, 16}) {
    const int iters = 4096;
    rate<8><<<sms, 32 * warps>>>(d, 16);
    cudaEventRecord(e0);
    rate<8><<<sms, 32 * warps>>>(d, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flops = 2.0 * 16 * 8 * 8 * 8.0 * iters * warps * sms;
    printf("rate %d warps/SM: %.1f TFLOP/s of TF32 mma.sync m16n8k8\n", warps,
           flops / ms / 1e9);
  }
  cudaFree(d);
  return 0;
}

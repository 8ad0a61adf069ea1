// The issue rate of mma.sync on one card: every SM runs `warps` warps, each
// issuing 8 independent m16n8k8 TF32 (or m16n8k16 bf16) products in a loop;
// prints one JSON object of TFLOP/s by shape and warps an SM. The SSD
// kernels (src/repro_torch/csrc/ssd_scan*.cu) run their products this way,
// so this rate, not the card's wgmma peak, bounds them.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate mma_sync_rate.cu
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void products(float* out, int iters, int bf16) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b[2] = {threadIdx.x * 5u, 11u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (bf16)
        mma_bf16(d[k], a, b);
      else
        mma_tf32(d[k], a, b);
    }
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k)
    for (int r = 0; r < 4; ++r) s += d[k][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)sms * 512 * sizeof(float)) != cudaSuccess) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  printf("{");
  for (int bf16 = 0; bf16 < 2; ++bf16)
    for (int warps : {4, 8, 16}) {
      products<<<sms, 32 * warps>>>(out, 16, bf16);  // warm-up
      cudaEventRecord(e0);
      products<<<sms, 32 * warps>>>(out, iters, bf16);
      cudaEventRecord(e1);
      if (cudaEventSynchronize(e1) != cudaSuccess) return 1;
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flop = 2.0 * 16 * 8 * (bf16 ? 16 : 8) * 8.0 * iters * warps * sms;
      printf("%s\"%s warps %d\": %.1f", bf16 || warps != 4 ? ", " : "",
             bf16 ? "bf16 m16n8k16" : "tf32 m16n8k8", warps, flop / ms / 1e9);
    }
  printf("}\n");
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

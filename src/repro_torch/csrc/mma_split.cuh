// The tensor-core fragments of the SSD scan's kernels (ssd_scan.cu, the
// forward; ssd_scan_bwd.cu, its gradient): TF32 rounding, the split of an
// f32 operand into a TF32 high part and the TF32 rounding of what it leaves
// ("3xTF32"), and mma.sync on m16n8k16 bf16 and m16n8k8 TF32 with f32
// accumulation.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// TF32 rounding to nearest, ties away from zero (cvt.rna.tf32.f32's
// rounding, for finite v): half an ulp of the 13 dropped bits is added to
// the magnitude and the low bits masked; two integer operations where ptxas
// expands cvt.rna.tf32.f32 into four.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// The same rounding of a low part, whose 13 low bits the tensor core drops
// by itself: only the half-ulp add.
__device__ __forceinline__ uint32_t tf32_low_bits(float v) {
  return __float_as_uint(v) + 0x1000u;
}

// An mma operand of R registers: a value TF32 holds exactly (bf16 data) as
// it is, any other f32 value as a TF32 high part and the TF32 rounding of
// what it leaves.
template <int R, bool Exact>
struct Operand {
  uint32_t hi[R], lo[R];
  Operand() = default;
  // From parts split before (the state's, stored beside it).
  __device__ __forceinline__ Operand(const uint32_t (&h)[R], const uint32_t (&l)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hi[i] = h[i];
      lo[i] = l[i];
    }
  }
  __device__ __forceinline__ explicit Operand(const float (&v)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (Exact) {
        hi[i] = __float_as_uint(v[i]);
        lo[i] = 0u;
      } else {
        hi[i] = tf32_bits(v[i]);
        lo[i] = tf32_low_bits(v[i] - __uint_as_float(hi[i]));
      }
    }
  }
};

// D(16 x 8) += A(16 x 16) B(16 x 8), bf16 operands (two a register), f32
// accumulate: A holds (g, 2t..2t+1), (g + 8, 2t..), (g, 2t+8..), (g + 8,
// 2t+8..); B (k = 2t..2t+1, n = g), (k = 2t+8.., g); the accumulator as
// m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D(16 x 8) += A(16 x 8) B(8 x 8), TF32 operands, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a b[i] for NB operands b, in the passes the split needs: the
// hi.hi products into d, the small ones (lo.hi, hi.lo) into dl, pass by
// pass over i, so that no product waits for the one before it.
template <int NB, bool EA, bool EB>
__device__ __forceinline__ void mma_row(float (&d)[NB][4], float (&dl)[NB][4],
                                        const Operand<4, EA>& a,
                                        const Operand<2, EB> (&b)[NB]) {
  if (!EA) {
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(dl[i], a.lo, b[i].hi);
  }
  if (!EB) {
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(dl[i], a.hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(d[i], a.hi, b[i].hi);
}

// d += dl, where the small products went (nothing to add when both
// operands were exact).
template <int NB, bool Any>
__device__ __forceinline__ void add_small(float (&d)[NB][4], const float (&dl)[NB][4]) {
  if (Any) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[i][r] += dl[i][r];
  }
}

// d[i] += a b[i] for the operands b[i], i < last (warp-uniform), in the
// passes the split needs, pass by pass over i so that no product waits for
// the one before it. Unlike mma_row the small products (lo.hi, hi.lo) go
// into d itself, ahead of hi.hi: no second accumulator to hold.
template <int NB, bool EA, bool EB>
__device__ __forceinline__ void mma_acc(float (&d)[NB][4], const Operand<4, EA>& a,
                                        const Operand<2, EB> (&b)[NB], int last = NB) {
  if (!EA) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < last) mma_tf32(d[i], a.lo, b[i].hi);
  }
  if (!EB) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < last) mma_tf32(d[i], a.hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (i < last) mma_tf32(d[i], a.hi, b[i].hi);
}

}  // namespace repro

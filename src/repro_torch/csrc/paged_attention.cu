// Decode attention for Hopper (sm_90a): one query token per sequence against
// a block-table-indirected KV page pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (body _paged_kernel), the TPU kernel whose jnp twin the reference model
// runs at decode (models/layers.py::decode_attention over the slot cache),
// with its bf16, f32 and int8 pages. Int8 pages carry one scale per
// (position, head) (f16 in the model's cache, f32 in the reference's kernel
// test); the kernel dequantizes right after the 16-byte load, as the TPU
// kernel does after its page read, so device memory holds and moves int8.
//
// What bounds it on an H100: bytes. Each KV position is read once and used
// for G = H / K query heads, about 2 * G FLOPs per KV byte, far below the
// card's ~295 FLOPs per byte. The floor is sum(lengths) * K * 2 (K and V)
// * (D * itemsize + scale bytes) per layer at 3.35 TB/s.
//
// What this design does about it (first, simple version):
//   * One CTA per (sequence, kv_head) serves all G query heads of that KV
//     head, so each KV byte is loaded from device memory once (the TPU
//     kernel's (G, D) tile).
//   * The TPU kernel walks pages as a sequential grid axis with
//     accumulators in VMEM; here the CTA walks the sequence in tiles of 64
//     positions, looking up each position's page in the block table, and
//     keeps m / l / acc in shared memory.
//   * Positions at or past the sequence's length are never loaded (the tile
//     is zero-filled and the scores masked), so pages past the length cost
//     nothing and may hold anything.
//   * Pages are read with 16-byte vector loads, coalesced along D, several
//     in flight per thread (8 bf16 or 16 int8 values a load; D = 80 is
//     10 bf16 or 5 int8 loads a row). zamba2's shared attention is full
//     MHA (G = 1): one query head per CTA, one KV head's positions.
//   * The grid has only B * K CTAs, which cannot fill 132 SMs at serving
//     batch sizes; splitting the sequence across CTAs (a second reduction
//     pass) is the next step for this kernel.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include <type_traits>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::load16;
using repro::store;
using repro::to_f32;

constexpr int kTok = 64;       // cache positions per tile (two per lane)
constexpr int kThreads = 256;  // eight warps

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// TS is the type of the int8 pages' scales (unused for bf16/f32 pages).
template <typename TQ, typename TKV, typename TS, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const TS* __restrict__ k_scales,
                        const TS* __restrict__ v_scales,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, TQ* __restrict__ o,
                        int H, int KH, int page, int pps, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int DP = D + 1;  // padded shared-memory row stride
  constexpr int V = repro::Vec16<TKV>::n;  // elements per 16-byte load
  constexpr int CH = D / V;                // 16-byte chunks per position
  const int G = H / KH;

  extern __shared__ float smem[];
  float* qs = smem;              // [G][D]
  float* ks = qs + G * D;        // [kTok][DP]
  float* vs = ks + kTok * DP;    // [kTok][DP]
  float* ss = vs + kTok * DP;    // [G][kTok] scores, then probabilities
  float* acc = ss + G * kTok;    // [G][D]
  float* ms = acc + G * D;       // [G] running max
  float* ls = ms + G;            // [G] running sum
  float* cs = ls + G;            // [G] this tile's rescale factor

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // A length past the mapped pages means every mapped position is valid.
  const int len = min(lengths[b], pps * page);
  const int* bt = block_tables + (size_t)b * pps;

  const TQ* qg = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f32(qg[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += kTok) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int i = tid; i < kTok * CH; i += kThreads) {
      const int t = i / CH, d = (i % CH) * V;
      const int pos = t0 + t;
      float kx[V], vx[V];
      if (pos < len) {
        const size_t row =
            ((size_t)bt[pos / page] * page + pos % page) * KH + kvh;
        load16(kp + row * D + d, kx);
        load16(vp + row * D + d, vx);
        if constexpr (kQuant) {
          const float sk = to_f32(k_scales[row]), sv = to_f32(v_scales[row]);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            kx[j] *= sk;
            vx[j] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ks[t * DP + d + j] = kx[j];
        vs[t * DP + d + j] = vx[j];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * kTok; i += kThreads) {
      const int g = i / kTok, t = i % kTok;
      const float* qr = qs + g * D;
      const float* kr = ks + t * DP;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      ss[i] = (t0 + t < len) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // Online-softmax update: one warp per query head.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sr = ss + g * kTok;
      const float a = sr[lane], c = sr[lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      sr[lane] = pa;
      sr[lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = ss + g * kTok;
      float a = acc[i] * cs[g];
#pragma unroll 8
      for (int t = 0; t < kTok; ++t) a = fmaf(pr[t], vs[t * DP + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  TQ* og = o + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    store(acc[i] / fmaxf(ls[i / D], 1e-30f), og + i);
}

// The operands every dispatch level passes on unchanged.
struct Args {
  const void *q, *kp, *vp, *ks, *vs;
  const int *bt, *lengths;
  void* o;
  int B, H, KH, page, pps;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, typename TS, int D>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.KH;
  const size_t smem =
      (size_t)(2 * G * D + 2 * kTok * (D + 1) + G * kTok + 3 * G) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV, TS, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.KH, a.B);
  paged_decode_kernel<TQ, TKV, TS, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const TS*>(a.ks),
      static_cast<const TS*>(a.vs), a.bt, a.lengths, static_cast<TQ*>(a.o),
      a.H, a.KH, a.page, a.pps, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TS>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 32: return launch<TQ, TKV, TS, 32>(a);
    case 64: return launch<TQ, TKV, TS, 64>(a);
    case 80: return launch<TQ, TKV, TS, 80>(a);
    case 128: return launch<TQ, TKV, TS, 128>(a);
    case 256: return launch<TQ, TKV, TS, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(const Args& a, int D, int kv_dtype, int scale_dtype) {
  if (kv_dtype == 0) return dispatch_d<TQ, float, float>(a, D);
  if (kv_dtype == 1) return dispatch_d<TQ, __nv_bfloat16, float>(a, D);
  if (kv_dtype == 2 && scale_dtype == 0) return dispatch_d<TQ, int8_t, float>(a, D);
  if (kv_dtype == 2 && scale_dtype == 2) return dispatch_d<TQ, int8_t, __half>(a, D);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = int8 (pages) or float16 (scales).
// q (B,H,D) and o like q; pages (P,page,KH,D); for int8 pages the scales
// (P,page,KH,1), else null; block_tables (B,pps) and lengths (B,) int32;
// all contiguous.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales,
                                   const void* block_tables,
                                   const void* lengths, void* o, int B,
                                   int H, int KH, int D, int page, int pps,
                                   float scale, int q_dtype, int kv_dtype,
                                   int scale_dtype, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || page <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(lengths), o, B, H, KH, page, pps,
               scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return (int)dispatch_kv<float>(a, D, kv_dtype, scale_dtype);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(a, D, kv_dtype, scale_dtype);
  return (int)cudaErrorInvalidValue;
}

// Decode attention for Hopper (sm_90a): one query token per sequence against
// a block-table-indirected KV page pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (body _paged_kernel), the TPU kernel whose jnp twin the reference model
// runs at decode (models/layers.py::decode_attention over the slot cache).
// The int8-page variant of that kernel is not ported yet.
//
// What bounds it on an H100: bytes. Each KV position is read once and used
// for G = H / K query heads, about 2 * G FLOPs per KV byte, far below the
// card's ~295 FLOPs per byte. The floor is sum(lengths) * K * D * 2 (K and V)
// * itemsize bytes per layer at 3.35 TB/s.
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
//     in flight per thread. The grid has only B * K CTAs, which
//     cannot fill 132 SMs at serving batch sizes; splitting the sequence
//     across CTAs (a second reduction pass) is the next step for this
//     kernel.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

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

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, TQ* __restrict__ o,
                        int H, int KH, int page, int pps, float scale) {
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
        const size_t off =
            (((size_t)bt[pos / page] * page + pos % page) * KH + kvh) * D + d;
        load16(kp + off, kx);
        load16(vp + off, vx);
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

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* lengths, void* o, int B, int H,
                   int KH, int page, int pps, float scale,
                   cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem =
      (size_t)(2 * G * D + 2 * kTok * (D + 1) + G * kTok + 3 * G) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KH, B);
  paged_decode_kernel<TQ, TKV, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), bt, lengths, static_cast<TQ*>(o), H, KH,
      page, pps, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int* bt, const int* lengths, void* o, int B,
                       int H, int KH, int D, int page, int pps, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 32: return launch<TQ, TKV, 32>(q, kp, vp, bt, lengths, o, B, H, KH, page, pps, scale, s);
    case 64: return launch<TQ, TKV, 64>(q, kp, vp, bt, lengths, o, B, H, KH, page, pps, scale, s);
    case 128: return launch<TQ, TKV, 128>(q, kp, vp, bt, lengths, o, B, H, KH, page, pps, scale, s);
    case 256: return launch<TQ, TKV, 256>(q, kp, vp, bt, lengths, o, B, H, KH, page, pps, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(const void* q, const void* kp, const void* vp,
                        const int* bt, const int* lengths, void* o, int B,
                        int H, int KH, int D, int page, int pps, float scale,
                        int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 0)
    return dispatch_d<TQ, float>(q, kp, vp, bt, lengths, o, B, H, KH, D, page, pps, scale, s);
  if (kv_dtype == 1)
    return dispatch_d<TQ, __nv_bfloat16>(q, kp, vp, bt, lengths, o, B, H, KH, D, page, pps, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. q (B,H,D) and o like q; pages
// (P,page,KH,D); block_tables (B,pps) and lengths (B,) int32; all contiguous.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* o, int B,
                                   int H, int KH, int D, int page, int pps,
                                   float scale, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || page <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_kv<float>(q, k_pages, v_pages, bt, ln, o, B, H, KH, D, page, pps, scale, kv_dtype, s);
  else if (q_dtype == 1)
    err = dispatch_kv<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, o, B, H, KH, D, page, pps, scale, kv_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Prefill attention for Hopper (sm_90a): causal or full, GQA, online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel), the TPU kernel whose jnp twin the reference model
// runs at prefill (models/layers.py::flash_attention).
//
// What bounds it on an H100: operations at long prompts, launch and
// latency at short ones. Causal prefill does 2 * 2 * B * H * L^2/2 * D
// FLOPs against B * (H + 2K) * L * D inputs, hundreds of FLOPs per byte at
// L >= 512, so the tensor cores' bf16 rate (989 TFLOP/s) is the ceiling.
//
// Two variants, chosen by dtype and head dim in the C entry point (never as
// a fallback): flash_attention_variant() names the one a call takes.
//
// Variant 1, tensor cores (bf16, D in {64, 80, 128, 256}):
//   * One CTA owns one (batch, head, 64-row query block): one consumer
//     warpgroup (warps 0-3) and one producer warp (warp 4). The producer's
//     lane 0 issues TMA tile loads: the Q tile once, then K and V tiles of
//     64 keys through a 2-stage ring, each stage with a "full" mbarrier
//     (TMA transaction bytes) and an "empty" one (the 128 consumers'
//     arrivals once the stage's products have completed).
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
//     K-major (D contiguous), D/16 k-steps. The online softmax runs on the
//     accumulator fragment in registers: each thread holds two rows' 16
//     columns; row max and sum reduce over the four lanes of a row, with
//     the TPU kernel's recurrence (m, l, rescale of acc). Only the causal
//     diagonal block and the ragged edge (kpos >= Lk, kpos > qpos) are
//     masked; key blocks above the diagonal are never loaded.
//   * O += P V converts P to bf16 in registers, where the S fragment is
//     already the layout of wgmma's register A operand, so P never touches
//     shared memory. V is stored D-contiguous, which is MN-major for this
//     product: the instruction's transpose-B flag reads it, with the
//     descriptor's leading offset stepping between swizzle atoms along D
//     and its stride offset between 8-key groups.
//   * Swizzle: D = 64, 128, 256 use 128-byte swizzled boxes of 64 columns
//     (one, two or four per tile). A D = 80 row is 160 bytes, which no
//     128-byte box divides, so D = 80 uses 32-byte swizzled boxes of 16
//     columns, five per tile: no padding, the same descriptors with the
//     32-byte layout, and a k-step of QK^T is exactly one box.
//   * Ragged L needs no padding: TMA zero-fills rows past L, those scores
//     are masked, those output rows are not stored.
//   * q, k, v and o are read and written with strides, so the model's
//     (B, L, H, D) layout goes in and comes out without a copy; the tensor
//     maps order the three outer dimensions by stride.
//   * Tensor maps are encoded on the host per call through the driver's
//     cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint (the
//     library links no libcuda), and passed as __grid_constant__ params.
//     The tile layout, descriptors and map encoding are shared with the
//     backward kernel (flash_tiles.cuh).
//
// Variant 0, CUDA cores (f32 inputs, and D = 32): the first version of this
// kernel, kept for the reduced widths and f32 tests: one CTA per (batch,
// head, 64-row block), 256 threads, four per query row, f32 tiles in shared
// memory padded by one word, products with scalar FMAs.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include <cuda.h>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using repro::encode;
using repro::kmajor_desc;
using repro::kNegInf;
using repro::load16;
using repro::MapOrder;
using repro::set_smem_once;
using repro::store;
using repro::Strides;
using repro::tma_load_tile;
using repro::vmajor_desc;

constexpr int kBlock = 64;  // query rows and key columns per tile

// ============================ variant 0: CUDA cores =========================

constexpr int kThreads = 256;  // four threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int KH, int Lq, int Lk,
                      int causal, float scale) {
  constexpr int DP = D + 1;          // padded shared-memory row stride
  constexpr int kCols = kBlock / 4;  // score columns per thread
  constexpr int kAcc = D / 4;        // output columns per thread
  constexpr int PP = kBlock + 1;     // padded probability row stride

  extern __shared__ float smem[];
  float* qs = smem;               // [kBlock][DP]
  float* ks = qs + kBlock * DP;   // [kBlock][DP]
  float* vs = ks + kBlock * DP;   // [kBlock][DP]
  float* ps = vs + kBlock * DP;   // [kBlock][PP]

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x;
  const int row = tid >> 2;  // the four lanes of a row share one warp
  const int sub = tid & 3;
  const int qpos = q0 + row;

  const T* qg = q + b * sq.b + h * sq.h;
  const T* kg = k + b * sk.b + kvh * sk.h;
  const T* vg = v + b * sv.b + kvh * sv.h;

  constexpr int V = repro::Vec16<T>::n;  // elements per 16-byte load
  constexpr int CH = D / V;               // 16-byte chunks per row
  for (int i = tid; i < kBlock * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * V;
    float x[V];
    if (q0 + r < Lq) {
      load16(qg + (q0 + r) * sq.l + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) qs[r * DP + c + j] = x[j];
  }

  float m = kNegInf, l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // Causal: with equal query and key blocks, key block j contributes to
  // query block i only when j <= i.
  const int k_end = causal ? min(Lk, q0 + kBlock) : Lk;
  const int n_kb = (k_end + kBlock - 1) / kBlock;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous tiles are consumed
#pragma unroll 4
    for (int i = tid; i < kBlock * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * V;
      float kx[V], vx[V];
      if (k0 + r < Lk) {
        load16(kg + (k0 + r) * sk.l + c, kx);
        load16(vg + (k0 + r) * sv.l + c, vx);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ks[r * DP + c + j] = kx[j];
        vs[r * DP + c + j] = vx[j];
      }
    }
    __syncthreads();

    const float* qr = qs + row * DP;
    float s[kCols];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = sub + 4 * j;
      const float* kr = ks + col * DP;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      dot *= scale;
      const int kpos = k0 + col;
      if (kpos >= Lk || (causal && kpos > qpos)) dot = kNegInf;
      s[j] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      ps[row * PP + sub + 4 * j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's probabilities are written by its own warp

#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= corr;
    const float* pr = ps + row * PP;
    for (int c = 0; c < kBlock; ++c) {
      const float p = pr[c];
      const float* vr = vs + c * DP + sub;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
  }

  if (qpos < Lq) {
    T* og = o + b * so.b + h * so.h + qpos * so.l + sub;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) store(acc[i] / denom, og + 4 * i);
    // m is already in units of scale * q.k here.
    if (lse != nullptr && sub == 0)
      lse[((long long)b * H + h) * Lq + qpos] = m + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        float* lse, Strides sq, Strides sk, Strides sv, Strides so, int B,
                        int H, int KH, int Lq, int Lk, int causal, float scale,
                        cudaStream_t stream) {
  static bool done[64] = {};
  const int smem =
      (3 * kBlock * (D + 1) + kBlock * (kBlock + 1)) * (int)sizeof(float);
  cudaError_t err = set_smem_once(flash_simt_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlock - 1) / kBlock, H, B);
  flash_simt_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, sv, so, H,
      KH, Lq, Lk, causal, scale);
  return cudaGetLastError();
}

// =========================== variant 1: tensor cores ========================

constexpr int kTcThreads = 160;  // consumer warpgroup + producer warp
constexpr int kStages = 2;       // K/V ring depth

template <int D>
struct Tc : repro::TileLayout<D> {
  static constexpr int SMEM =
      1024 + repro::TileLayout<D>::TILE * (1 + 2 * kStages) + 64;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    Strides so, MapOrder oq,
                    MapOrder ok, MapOrder ov, int H, int KH, int Lq, int Lk,
                    int causal, float scale_log2) {
  using S = Tc<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = base;
  uint8_t* sk = sq + S::TILE;             // [kStages] tiles
  uint8_t* sv = sk + kStages * S::TILE;   // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * S::TILE);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;              // [kStages]
  uint64_t* empty = bars + 1 + kStages;   // [kStages]

  // Causal blocks run longest first: the last query block walks the most
  // key blocks.
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int k_end = causal ? min(Lk, q0 + kBlock) : Lk;
  const int n_kb = (k_end + kBlock - 1) / kBlock;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 128);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: one lane issues every TMA load
    if (lane == 0) {
      repro::mbar_expect_tx(q_full, S::TILE);
      tma_load_tile<D>(sq, &tq, oq, q_full, q0, h, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) repro::mbar_wait(&empty[s], ((kb / kStages) - 1) & 1);
        repro::mbar_expect_tx(&full[s], 2 * S::TILE);
        tma_load_tile<D>(sk + s * S::TILE, &tk, ok, &full[s], kb * kBlock, kvh, b);
        tma_load_tile<D>(sv + s * S::TILE, &tv, ov, &full[s], kb * kBlock, kvh, b);
      }
    }
    return;
  }

  // Consumer warpgroup. Thread layout of a 64 x N f32 accumulator: rows
  // r0 = 16 * warp + lane / 4 and r0 + 8; register i holds column
  // 8 * (i / 4) + 2 * (lane % 4) + (i % 2) of row r0 + 8 * ((i / 2) % 2).
  const int r0 = warp * 16 + lane / 4;
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t sq_a = repro::smem_u32(sq);

  repro::mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const uint32_t sk_a = repro::smem_u32(sk + s * S::TILE);
    const uint32_t sv_a = repro::smem_u32(sv + s * S::TILE);
    repro::mbar_wait(&full[s], (kb / kStages) & 1);

    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      repro::wgmma_ss_n64(sacc, kmajor_desc<D>(sq_a, kk),
                          kmajor_desc<D>(sk_a, kk), kk > 0);
    repro::wgmma_commit();
    repro::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) repro::fence_reg(sacc[i]);

    const int k0 = kb * kBlock;
    if (k0 + kBlock > Lk || (causal && k0 + kBlock - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i % 2);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= Lk || (causal && kpos > qpos)) sacc[i] = kNegInf;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2)
        mx1 = fmaxf(mx1, sacc[i]);
      else
        mx0 = fmaxf(mx0, sacc[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = exp2f((m0 - mx0) * scale_log2);
    const float c1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f((sacc[i] - ((i & 2) ? mx1 : mx0)) * scale_log2);
      sacc[i] = p;
      if (i & 2)
        rs1 += p;
      else
        rs0 += p;
    }
    l0 = l0 * c0 + rs0;  // this thread's columns; the row's four lanes
    l1 = l1 * c1 + rs1;  // are summed once, at the end
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? c1 : c0;

    // P as wgmma's register A operand: k-step kk covers keys 16kk..16kk+15,
    // which are S registers 8kk..8kk+7 in A-fragment order.
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const __nv_bfloat162 two =
          __floats2bfloat162_rn(sacc[2 * j], sacc[2 * j + 1]);
      pa[j] = *reinterpret_cast<const uint32_t*>(&two);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) repro::fence_reg(oacc[i]);
#pragma unroll
    for (int j = 0; j < 16; ++j) repro::fence_reg(pa[j]);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      repro::wgmma_rs_tb<D>(oacc, pa + 4 * kk, vmajor_desc<D>(sv_a, kk), 1);
    repro::wgmma_commit();
    repro::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) repro::fence_reg(oacc[i]);
    repro::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && cq == 0) {
    // m is in raw q.k units and the sums in base 2 of scale * q.k: lse in
    // base e is ln 2 * (m * scale_log2 + log2 l).
    float* lrow = lse + ((long long)b * H + h) * Lq;
    if (qpos0 < Lq)
      lrow[qpos0] = 0.6931471805599453f * (m0 * scale_log2 + log2f(fmaxf(l0, 1e-30f)));
    if (qpos1 < Lq)
      lrow[qpos1] = 0.6931471805599453f * (m1 * scale_log2 + log2f(fmaxf(l1, 1e-30f)));
  }
  __nv_bfloat16* ob = o + b * so.b + h * so.h + cq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (qpos0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos0 * so.l + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (qpos1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos1 * so.l + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv1,
                                oacc[4 * j + 3] * inv1);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, Strides sq, Strides sk, Strides sv, Strides so, int B,
                      int H, int KH, int Lq, int Lk, int causal, float scale,
                      cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = set_smem_once(flash_tc_kernel<D>, Tc<D>::SMEM, done);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  MapOrder oq, ok, ov;
  if ((err = encode<D>(&tq, &oq, q, sq, B, H, Lq)) != cudaSuccess) return err;
  if ((err = encode<D>(&tk, &ok, k, sk, B, KH, Lk)) != cudaSuccess) return err;
  if ((err = encode<D>(&tv, &ov, v, sv, B, KH, Lk)) != cudaSuccess) return err;
  const dim3 grid((Lq + kBlock - 1) / kBlock, H, B);
  flash_tc_kernel<D><<<grid, kTcThreads, Tc<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, so, oq, ok, ov, H, KH,
      Lq, Lk, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// 1 = tensor cores, 0 = CUDA cores, -1 = not taken.
int variant(int D, int dtype) {
  const bool known = D == 32 || D == 64 || D == 80 || D == 128 || D == 256;
  if (!known || (dtype != 0 && dtype != 1)) return -1;
  return (dtype == 1 && D != 32) ? 1 : 0;
}

template <typename T>
cudaError_t dispatch_simt(int D, const void* q, const void* k, const void* v,
                          void* o, float* lse, Strides sq, Strides sk, Strides sv,
                          Strides so, int B, int H, int KH, int Lq, int Lk,
                          int causal, float scale, cudaStream_t s) {
#define REPRO_SIMT(DD)                                                      \
  case DD:                                                                  \
    return launch_simt<T, DD>(q, k, v, o, lse, sq, sk, sv, so, B, H, KH, Lq, \
                              Lk, causal, scale, s)
  switch (D) {
    REPRO_SIMT(32);
    REPRO_SIMT(64);
    REPRO_SIMT(80);
    REPRO_SIMT(128);
    REPRO_SIMT(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SIMT
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        void* o, float* lse, Strides sq, Strides sk, Strides sv,
                        Strides so, int B, int H, int KH, int Lq, int Lk,
                        int causal, float scale, cudaStream_t s) {
#define REPRO_TC(DD)                                                      \
  case DD:                                                                \
    return launch_tc<DD>(q, k, v, o, lse, sq, sk, sv, so, B, H, KH, Lq,   \
                         Lk, causal, scale, s)
  switch (D) {
    REPRO_TC(64);
    REPRO_TC(80);
    REPRO_TC(128);
    REPRO_TC(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_TC
}

}  // namespace

// The variant a call with this head dim and dtype takes: 1 = tensor cores,
// 0 = CUDA cores, -1 = refused.
extern "C" int flash_attention_variant(int D, int dtype) {
  return variant(D, dtype);
}

// dtype: 0 = float32, 1 = bfloat16. q viewed as (B,H,Lq,D), k/v as
// (B,KH,Lk,D), o like q, each with D contiguous and element strides
// (b, h, l) given; one dtype. lse, when not null, receives each query row's
// log-sum-exp of scale * q.k over its unmasked keys, f32 (B, H, Lq)
// contiguous: what the backward kernel (flash_attention_bwd.cu) recomputes
// the probabilities from. Serving passes null.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H,
    int KH, int Lq, int Lk, int D, int causal, float scale, int dtype,
    long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long osb, long long osh, long long osl,
    void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  if (causal && Lq != Lk) return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qsl}, sk{ksb, ksh, ksl}, sv{vsb, vsh, vsl},
      so{osb, osh, osl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant(D, dtype)) {
    case 1:
      return (int)dispatch_tc(D, q, k, v, o, lse, sq, sk, sv, so, B, H, KH,
                              Lq, Lk, causal, scale, s);
    case 0:
      if (dtype == 0)
        return (int)dispatch_simt<float>(D, q, k, v, o, lse, sq, sk, sv, so,
                                         B, H, KH, Lq, Lk, causal, scale, s);
      return (int)dispatch_simt<__nv_bfloat16>(D, q, k, v, o, lse, sq, sk, sv,
                                               so, B, H, KH, Lq, Lk, causal,
                                               scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

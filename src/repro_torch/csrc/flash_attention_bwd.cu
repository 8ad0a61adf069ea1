// Backward of the prefill attention (flash_attention.cu) for Hopper (sm_90a):
// causal or full (Lq != Lk), GQA, any length, head dims 32, 64, 80, 128 and
// 256, float32 or bfloat16 operands with f32 accumulation.
//
// Replaces no Pallas kernel: the reference differentiates its jnp online-
// softmax attention (src/repro/models/layers.py::flash_attention) with
// jax.grad, and the port's counterpart of that attention is the flash
// kernel, whose gradient is this kernel.
//
// Given q, k, v, the forward's output o and its per-row log-sum-exp lse
// (f32 (B, H, Lq), written by flash_attention_fwd), and dO, it computes
//   P  = exp(scale * Q K^T - lse)        (masked entries 0)
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta),  dQ = scale * dS K,  dK = scale * dS^T Q
// in three launches on the caller's stream (delta, dkdv, dq), with no
// atomics, so two runs give the same bits. Keeping dq a launch of its own
// costs 3.5 / 2.5 of the least FLOPs (it recomputes S and dP): the price of
// summing dQ over key tiles without atomics.
//
// What bounds it on an H100: operations. The function's minimum is 2.5x the
// forward's matmul FLOPs (5 of 64 x 64 x D products a tile pair against 2),
// at hundreds of FLOPs a byte, so the tensor cores' bf16 rate is the
// ceiling. Two variants, chosen by dtype and head dim in the C entry point
// (flash_attention_bwd_variant() names the one a call takes):
//
// Variant 1, tensor cores (bf16 at D 64, 80, 128: the models' training
// shapes), in the forward's shape (namespace tc below):
//   * A CTA is three warpgroups: two consumers that run wgmma and a
//     producer whose lane 0 issues TMA loads into a 2-stage ring of full /
//     empty mbarriers (the tile layout and maps of flash_tiles.cuh: 64-row
//     tiles, D contiguous, swizzled boxes, rows past L zero-filled). The
//     producer gives back registers with setmaxnreg (40 a thread) and the
//     consumers take them (232), room for dK and dV (128 f32 at D 128) plus
//     S^T and dP^T (64) in registers. The role is read through a warp
//     shuffle, so ptxas sees uniform branches. dkdv still spills at D 80
//     and 128, where ptxas serializes its wgmma (chip_smoke.py's [build]
//     lines report both).
//   * dkdv: a work item is a 128-key tile of one (batch, kv head) and a
//     group of its G query heads; each consumer warpgroup owns 64 keys. K
//     and V are loaded once; the producer streams (Q, dO) tiles of 64
//     query rows with their lse and delta rows (a second producer warp
//     writes those) through the ring, over each head of the group and, if
//     causal, only the tiles at or below the diagonal. A consumer forms
//     S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory,
//     K-major), P^T and dS^T in registers while dP^T completes, then dV +=
//     P^T dO and dK += dS^T Q with the accumulator fragment as wgmma's
//     register A operand and dO, Q read MN-major. Masks apply only on
//     diagonal and ragged tiles. (Forming dS^T from P^T's bf16 operand, so
//     S^T and dP^T are never live together, spilled less and ran dkdv
//     faster, but put dK's worst row at the 2-ulp limit: PERF.md.)
//   * A grid that fills the card at any G: the wrapper's schedule
//     (kernels/flash_attention.py::backward_schedule) splits each kv head's
//     G heads into `split` groups (uneven where split does not divide G)
//     and orders the items by the query tiles they walk, longest first.
//     The groups of one key tile are one thread-block cluster: each CTA
//     writes its f32 dK / dV partials to its shared memory, and each sums
//     its share of the rows over the cluster's ranks in rank order and
//     rounds once, so the result does not depend on the schedule's timing.
//   * dq: a CTA is a 128-row query tile of one head (64 rows a consumer
//     warpgroup); Q and dO stay resident, K and V stream through the ring;
//     S = Q K^T and dP = dO V^T (P formed while dP completes), dQ += dS K
//     (K read MN-major) accumulate in registers, scaled and rounded once.
//     Causal tiles run longest first.
//   * P and dS are rounded to bf16 as operands (2**-9 relative, as the
//     forward rounds P), dS formed from the f32 P; every sum stays f32.
//
// Variant 0, CUDA cores (f32, and bf16 at D 32 and 256): every tile widened
// to f32 in shared memory (rows padded by one word, so the column walks are
// free of bank conflicts); each of 256 threads owns a 4 x 4 block of a
// 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and a (BK / 16) x
// (D / 16) block of dK and dV (or dQ), with scalar FMAs; dK and dV sum a kv
// head's G heads inside one CTA.
//
// Measured (chip_smoke.py's [flash-bwd], one NVIDIA H100 80GB HBM3 at its
// 700 W limit): yi-6b B 2 L 2048 causal 0.9034 ms (the mma.sync design
// before this one 2.1907, SDPA's backward 0.5093, the bound 0.1737), of
// which dkdv 0.5602 and dq 0.3019; qwen3's G 16 at L 1024 0.3033 ms
// (1.4859 before, SDPA 0.2107). PERF.md's kernel table, row 1b, has every
// shape.
//
// Interface: plain C, pointers from torch tensors, the strides of the eight
// operands in a host array, the tensor-core variant's work list on the
// device; launched on the caller's stream; returns the first cudaError_t of
// the three launches (0 on success).

#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::load16;
using repro::set_smem_once;
using repro::store;
using repro::Strides;

constexpr int kThreads = 256;  // 16 x 16

template <int D>
struct Tiles {
  static constexpr int BK = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows a tile
  static constexpr int DP = D + 1;              // padded f32 row of a tile
  static constexpr int PP = BK + 1;             // padded row of P / dS
};

// ROWS rows of one head, from row r0 on, into f32 shared memory [ROWS][D+1];
// rows at or past L are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride_l, int r0, int L) {
  constexpr int V = repro::Vec16<T>::n;
  constexpr int CH = D / V;
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * V;
    float x[V];
    if (r0 + r < L) {
      load16(src + (r0 + r) * stride_l + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * DP + c + j] = x[j];
  }
}

// One query tile's lse and delta rows into shared memory (0 past Lq).
template <int BQ>
__device__ __forceinline__ void load_rows(float* lse_s, float* dlt_s,
                                          const float* lse, const float* dlt,
                                          int q0, int Lq) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const bool ok = q0 + i < Lq;
    lse_s[i] = ok ? lse[q0 + i] : 0.f;
    dlt_s[i] = ok ? dlt[q0 + i] : 0.f;
  }
}

// ============================ variant 0: CUDA cores =========================

// P and dS of one (query tile, key tile) pair from the f32 tiles in shared
// memory, into ps (when not null) and dss, both [BQ][BK+1].
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse_s, const float* dlt_s,
                                       float* ps, float* dss, int q0, int k0,
                                       int Lq, int Lk, int causal,
                                       float scale) {
  using S = Tiles<D>;
  constexpr int RQ = S::BQ / 16, CK = S::BK / 16, DP = S::DP, PP = S::PP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], gv[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = qs[(ty + 16 * i) * DP + d];
      gv[i] = dos[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = ks[(tx + 16 * j) * DP + d];
      vv[j] = vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      const bool ok = qpos < Lq && kpos < Lk && !(causal && kpos > qpos);
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (ps != nullptr) ps[r * PP + c] = p;
      dss[r * PP + c] = p * (dp[i][j] - dlt_s[r]);
    }
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d] over rows (b, h, i), one warp a
// row; delta is f32 (B, H, Lq) contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Strides so, Strides sd, int H,
                 int Lq, long long rows) {
  constexpr int V = repro::Vec16<T>::n;
  constexpr int CH = D / V;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = (int)(row % Lq);
  const long long bh = row / Lq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = o + b * so.b + h * so.h + i * so.l;
  const T* drow = dout + b * sd.b + h * sd.h + i * sd.l;
  float acc = 0.f;
  for (int c = lane; c < CH; c += 32) {
    float x[V], y[V];
    load16(orow + c * V, x);
    load16(drow + c * V, y);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fmaf(x[j], y[j], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr int dkdv_smem() {
  using S = Tiles<D>;
  return (2 * S::BK * S::DP + 2 * S::BQ * S::DP + 2 * S::BQ * S::PP +
          2 * S::BQ) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk,
                Strides sdv, int H, int KH, int Lq, int Lk, int causal,
                float scale) {
  using S = Tiles<D>;
  constexpr int BK = S::BK, BQ = S::BQ, DP = S::DP, PP = S::PP;
  constexpr int RK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][DP]
  float* qs = vs + BK * DP;      // [BQ][DP]
  float* dos = qs + BQ * DP;     // [BQ][DP]
  float* ps = dos + BQ * DP;     // [BQ][PP]
  float* dss = ps + BQ * PP;     // [BQ][PP]
  float* lse_s = dss + BQ * PP;  // [BQ]
  float* dlt_s = lse_s + BQ;     // [BQ]

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, BK>(ks, k + b * sk.b + kvh * sk.h, sk.l, k0, Lk);
  load_tile<T, D, BK>(vs, v + b * sv.b + kvh * sv.h, sv.l, k0, Lk);

  float adk[RK][CD], adv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) adk[i][j] = adv[i][j] = 0.f;

  // Causal: query tile t meets this key tile only when t * BQ + BQ - 1 >= k0.
  const int t0 = causal ? k0 / BQ : 0;
  const int n_qt = (Lq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qh = q + b * sq.b + h * sq.h;
    const T* dh = dout + b * sdo.b + h * sdo.h;
    const float* lse_h = lse + ((long long)b * H + h) * Lq;
    const float* dlt_h = delta + ((long long)b * H + h) * Lq;
    for (int t = t0; t < n_qt; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's ps / dss / qs / dos are read
      load_tile<T, D, BQ>(qs, qh, sq.l, q0, Lq);
      load_tile<T, D, BQ>(dos, dh, sdo.l, q0, Lq);
      load_rows<BQ>(lse_s, dlt_s, lse_h, dlt_h, q0, Lq);
      __syncthreads();
      scores<D>(qs, dos, ks, vs, lse_s, dlt_s, ps, dss, q0, k0, Lq, Lk,
                causal, scale);
      __syncthreads();
      // dV[key][d] += P[q][key] dO[q][d]; dK[key][d] += dS[q][key] Q[q][d]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[RK], sr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = ps[r * PP + ty + 16 * i];
          sr[i] = dss[r * PP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          const float gv = dos[r * DP + tx + 16 * j];
          const float qv = qs[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            adv[i][j] = fmaf(pr[i], gv, adv[i][j]);
            adk[i][j] = fmaf(sr[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * sdk.b + kvh * sdk.h;
  T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Lk) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      store(adk[i][j] * scale, dkb + kpos * sdk.l + tx + 16 * j);
      store(adv[i][j], dvb + kpos * sdv.l + tx + 16 * j);
    }
  }
}

template <int D>
constexpr int dq_smem() {
  using S = Tiles<D>;
  return (2 * S::BQ * S::DP + 2 * S::BK * S::DP + S::BQ * S::PP + 2 * S::BQ) *
         (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int KH, int Lq, int Lk,
              int causal, float scale) {
  using S = Tiles<D>;
  constexpr int BK = S::BK, BQ = S::BQ, DP = S::DP, PP = S::PP;
  constexpr int RQ = BQ / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][DP]
  float* dos = qs + BQ * DP;     // [BQ][DP]
  float* ks = dos + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][DP]
  float* dss = vs + BK * DP;     // [BQ][PP]
  float* lse_s = dss + BQ * PP;  // [BQ]
  float* dlt_s = lse_s + BQ;     // [BQ]

  // Causal tiles run longest first: the last query tile walks the most keys.
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, BQ>(qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_tile<T, D, BQ>(dos, dout + b * sdo.b + h * sdo.h, sdo.l, q0, Lq);
  load_rows<BQ>(lse_s, dlt_s, lse + ((long long)b * H + h) * Lq,
                delta + ((long long)b * H + h) * Lq, q0, Lq);

  float adq[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) adq[i][j] = 0.f;

  const T* kh = k + b * sk.b + kvh * sk.h;
  const T* vh = v + b * sv.b + kvh * sv.h;
  const int k_end = causal ? min(Lk, q0 + BQ) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous key tile and dss are read
    load_tile<T, D, BK>(ks, kh, sk.l, k0, Lk);
    load_tile<T, D, BK>(vs, vh, sv.l, k0, Lk);
    __syncthreads();
    scores<D>(qs, dos, ks, vs, lse_s, dlt_s, nullptr, dss, q0, k0, Lq, Lk,
              causal, scale);
    __syncthreads();
    // dQ[q][d] += dS[q][key] K[key][d]
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sr[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sr[i] = dss[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float kv = ks[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) adq[i][j] = fmaf(sr[i], kv, adq[i][j]);
      }
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Lq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      store(adq[i][j] * scale, dqb + qpos * sdq.l + tx + 16 * j);
  }
}

// ============================ variant 1: tensor cores =======================
//
// bf16 at head dims 64, 80 and 128, on wgmma with TMA-fed tiles; the
// design is described at the top of this file.
namespace tc {

using repro::kmajor_desc;
using repro::tma_load_tile;
using repro::MapOrder;
using repro::TileLayout;
using repro::vmajor_desc;

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kTile = repro::kTileRows;  // 64: rows a warpgroup owns
constexpr int kRows = 2 * kTile;  // keys of a dkdv CTA, queries of a dq CTA
constexpr int kStages = 2;        // ring depth
// Registers a thread: the launch gives each of the 384 threads 168 (65536
// / 384, rounded down to 8); the producer warpgroup gives back down to 40
// and the two consumer warpgroups take up to 232 (40 + 2 * 232 = 3 * 168).
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * kLaunchRegs, "registers");
constexpr int kMaxSplit = 8;   // portable cluster size
constexpr int kWorkInts = 5;   // a dkdv work item: b, kv head, key tile, heads [lo, hi)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a dkdv CTA (byte offsets from a 1024-aligned base). The
// f32 dK / dV partials of a split kv head overlay the tiles once every
// product has completed.
template <int D>
struct KvSmem {
  using L = TileLayout<D>;
  static constexpr int PART_LD = D + 8;  // padded f32 row of a partial
  static constexpr int K_OFF = 0;                          // 2 tiles
  static constexpr int V_OFF = 2 * L::TILE;                // 2 tiles
  static constexpr int Q_OFF = 4 * L::TILE;                // kStages tiles
  static constexpr int DO_OFF = Q_OFF + kStages * L::TILE; // kStages tiles
  static constexpr int ROWS_OFF = DO_OFF + kStages * L::TILE;  // lse, delta
  static constexpr int TILES_END = ROWS_OFF + 2 * kStages * kTile * 4;
  static constexpr int PART = 2 * kRows * PART_LD * 4;
  static constexpr int BARS_OFF = TILES_END > PART ? TILES_END : PART;
  static constexpr int SMEM = 1024 + BARS_OFF + (1 + 2 * kStages) * 8;
};

// Shared memory of a dq CTA.
template <int D>
struct QSmem {
  using L = TileLayout<D>;
  static constexpr int Q_OFF = 0;                          // 2 tiles
  static constexpr int DO_OFF = 2 * L::TILE;               // 2 tiles
  static constexpr int K_OFF = 4 * L::TILE;                // kStages tiles
  static constexpr int V_OFF = K_OFF + kStages * L::TILE;  // kStages tiles
  static constexpr int BARS_OFF = V_OFF + kStages * L::TILE;
  static constexpr int SMEM = 1024 + BARS_OFF + (1 + 2 * kStages) * 8;
};

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

// A 64 x 64 f32 accumulator fragment as the bf16 A operand of four k-steps
// of 16 (k-step kk: registers 4 kk .. 4 kk + 3).
__device__ __forceinline__ void to_a(uint32_t (&a)[16], const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack(c[2 * j], c[2 * j + 1]);
}

template <typename T, int N>
__device__ __forceinline__ void fence_all(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) repro::fence_reg(r[i]);
}

// acc = A B^T over the D columns of two K-major 64-row tiles in shared
// memory (D / 16 wgmma k-steps, issued, not committed).
template <int D>
__device__ __forceinline__ void kmajor_product(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    repro::wgmma_ss_n64(acc, kmajor_desc<D>(a, kk), kmajor_desc<D>(b, kk), kk > 0);
}

// Stores a 64 x D f32 fragment (rows row0 and row0 + 8 of this thread,
// row < limit only) as bf16 times mul.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld,
                                           const float (&acc)[D / 2], int row0,
                                           int limit, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + row0 * ld + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row0 + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + (row0 + 8) * ld + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x, float mul) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * mul, x.y * mul);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * mul, x.w * mul);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// dK, dV of one work item: a 128-key tile (consumer warpgroup w owns keys
// k0 + 64 w ..) of kv head kvh against the query heads [h_lo, h_hi).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, MapOrder oq,
                      MapOrder ok, MapOrder ov, MapOrder odo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      Strides sdk, Strides sdv, const int* __restrict__ work,
                      int split, int H, int Lq, int Lk, int causal, float scale) {
  using L = TileLayout<D>;
  using S = KvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  uint8_t* sk = base + S::K_OFF;
  uint8_t* sv = base + S::V_OFF;
  uint8_t* sq = base + S::Q_OFF;
  uint8_t* sdo = base + S::DO_OFF;
  float* lse_s = reinterpret_cast<float*>(base + S::ROWS_OFF);  // [kStages][64], base 2
  float* dlt_s = lse_s + kStages * kTile;                         // [kStages][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::BARS_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;             // [kStages]
  uint64_t* empty = bars + 1 + kStages;  // [kStages]

  const int* item = work + kWorkInts * blockIdx.x;
  const int b = item[0], kvh = item[1], k0 = item[2] * kRows;
  const int h_lo = item[3], h_hi = item[4];
  // Causal: query tile t meets this key tile when its last row >= k0.
  const int t0 = causal ? k0 / kTile : 0;
  const int n_t = (Lq + kTile - 1) / kTile - t0;  // query tiles a head
  const int n_iter = (h_hi - h_lo) * n_t;
  // The role, warp-uniform as ptxas sees it (a shuffle from lane 0, as
  // CUTLASS does): ptxas then spills less under setmaxnreg's budget.
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0),
            warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0), lane = tid % 32;

  if (tid == 0) {
    repro::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1 + 32);  // the TMA lane + the row loader
      repro::mbar_init(&empty[s], 256);    // every consumer thread
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup
    repro::setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {  // TMA: K and V once, then Q and dO tiles
      const int halves = min(2, (Lk - k0 + kTile - 1) / kTile);
      repro::mbar_expect_tx(kv_full, 2 * halves * L::TILE);
      for (int j = 0; j < halves; ++j) {
        tma_load_tile<D>(sk + j * L::TILE, &tk, ok, kv_full, k0 + j * kTile, kvh, b);
        tma_load_tile<D>(sv + j * L::TILE, &tv, ov, kv_full, k0 + j * kTile, kvh, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int h = h_lo + it / n_t, q0 = (t0 + it % n_t) * kTile;
        if (it >= kStages) repro::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        repro::mbar_expect_tx(&full[s], 2 * L::TILE);
        tma_load_tile<D>(sq + s * L::TILE, &tq, oq, &full[s], q0, h, b);
        tma_load_tile<D>(sdo + s * L::TILE, &tdo, odo, &full[s], q0, h, b);
      }
    } else if (warp == 1) {  // the tile's lse (base 2) and delta rows
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int h = h_lo + it / n_t, q0 = (t0 + it % n_t) * kTile;
        if (it >= kStages) repro::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        const long long row = ((long long)b * H + h) * Lq + q0;
        for (int r = lane; r < kTile; r += 32) {
          const bool in = q0 + r < Lq;
          lse_s[s * kTile + r] = in ? lse[row + r] * kLog2e : 0.f;
          dlt_s[s * kTile + r] = in ? delta[row + r] : 0.f;
        }
        repro::mbar_arrive(&full[s]);
      }
    }
    __syncwarp();
    if (split > 1) {  // the cluster's combine (below) syncs every thread
      __syncthreads();
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  repro::setmaxnreg_inc<kConsumerRegs>();
  // Accumulator layout of a 64 x N f32 fragment: rows r0 = 16 * warp +
  // lane / 4 and r0 + 8; register i holds column 8 * (i / 4) + 2 * (lane %
  // 4) + (i % 2) of row r0 + 8 * ((i / 2) % 2). Rows are keys here, the
  // columns of S^T and dP^T queries.
  const int kw0 = k0 + wg * kTile;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int key0 = kw0 + r0, key1 = key0 + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t sk_a = repro::smem_u32(sk + wg * L::TILE);
  const uint32_t sv_a = repro::smem_u32(sv + wg * L::TILE);
  const bool live = kw0 < Lk;
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

  repro::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = (t0 + it % n_t) * kTile;
    repro::mbar_wait(&full[s], (it / kStages) & 1);
    // A query tile wholly above this warpgroup's keys adds nothing.
    if (live && !(causal && q0 + kTile - 1 < kw0)) {
      const uint32_t sq_a = repro::smem_u32(sq + s * L::TILE);
      const uint32_t sdo_a = repro::smem_u32(sdo + s * L::TILE);
      const float* ls = lse_s + s * kTile;
      const float* dl = dlt_s + s * kTile;
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      // S^T = K Q^T, then dP^T = V dO^T; P^T is formed while dP^T runs.
      repro::wgmma_fence();
      kmajor_product<D>(st, sk_a, sq_a);
      repro::wgmma_commit();
      kmajor_product<D>(dpt, sv_a, sdo_a);
      repro::wgmma_commit();
      repro::wgmma_wait<1>();
      fence_all(st);
      const bool edge =
          q0 + kTile > Lq || kw0 + kTile > Lk || (causal && kw0 + kTile - 1 > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + cq + (i % 2);
        const int key = (i & 2) ? key1 : key0;
        float p = exp2f(st[i] * scale_log2 - ls[col]);
        if (edge && (q0 + col >= Lq || key >= Lk || (causal && key > q0 + col))) p = 0.f;
        st[i] = p;
      }
      repro::wgmma_wait<0>();
      fence_all(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + cq + (i % 2);
        dpt[i] = st[i] * (dpt[i] - dl[col]);  // dS^T
      }
      uint32_t pa[16], sa[16];
      to_a(pa, st);
      to_a(sa, dpt);
      fence_all(adv);
      fence_all(adk);
      fence_all(pa);
      fence_all(sa);
      // dV += P^T dO, dK += dS^T Q (depth: this tile's 64 queries).
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        repro::wgmma_rs_tb<D>(adv, pa + 4 * kk, vmajor_desc<D>(sdo_a, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        repro::wgmma_rs_tb<D>(adk, sa + 4 * kk, vmajor_desc<D>(sq_a, kk), 1);
      repro::wgmma_commit();
      repro::wgmma_wait0();
      fence_all(adv);
      fence_all(adk);
    }
    repro::mbar_arrive(&empty[s]);
  }

  if (split == 1) {  // this CTA holds all of the kv head's sum
    if (!live) return;
    store_rows<D>(dk + b * sdk.b + kvh * sdk.h + cq, sdk.l, adk, key0, Lk, scale);
    store_rows<D>(dv + b * sdv.b + kvh * sdv.h + cq, sdv.l, adv, key0, Lk, 1.f);
    return;
  }

  // The kv head's G heads are split over the cluster's CTAs: each writes
  // its f32 partials to its own shared memory; then each CTA sums its
  // share of the rows over the cluster's ranks in rank order and rounds
  // once.
  __syncthreads();  // both consumer warpgroups are done with every tile
  constexpr int LD = S::PART_LD;
  float* part = reinterpret_cast<float*>(base);  // dK [kRows][LD], then dV
  const int prow = wg * kTile + r0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + cq;
    *reinterpret_cast<float2*>(part + prow * LD + c) = make_float2(adk[4 * j], adk[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (prow + 8) * LD + c) =
        make_float2(adk[4 * j + 2], adk[4 * j + 3]);
    *reinterpret_cast<float2*>(part + (kRows + prow) * LD + c) =
        make_float2(adv[4 * j], adv[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (kRows + prow + 8) * LD + c) =
        make_float2(adv[4 * j + 2], adv[4 * j + 3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int C4 = D / 4;  // float4 chunks a row
  const int rank = (int)cluster.block_rank();
  const int lo = rank * kRows * C4 / split, hi = (rank + 1) * kRows * C4 / split;
  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h;
  for (int idx = lo + tid; idx < hi; idx += 256) {
    const int row = idx / C4, c = (idx % C4) * 4, key = k0 + row;
    if (key >= Lk) continue;
    float4 gk = make_float4(0.f, 0.f, 0.f, 0.f), gv = gk;
    for (int r = 0; r < split; ++r) {
      const float* pr = cluster.map_shared_rank(part, r);
      const float4 a = *reinterpret_cast<const float4*>(pr + row * LD + c);
      const float4 e = *reinterpret_cast<const float4*>(pr + (kRows + row) * LD + c);
      gk.x += a.x; gk.y += a.y; gk.z += a.z; gk.w += a.w;
      gv.x += e.x; gv.y += e.y; gv.z += e.z; gv.w += e.w;
    }
    store4(dkb + key * sdk.l + c, gk, scale);
    store4(dvb + key * sdv.l + c, gv, 1.f);
  }
  cluster.sync();  // the partials stay readable until every CTA is done
}

// dQ of one 128-row query tile of head h (consumer warpgroup w owns rows
// q0 + 64 w ..), against the key tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, MapOrder oq,
                    MapOrder ok, MapOrder ov, MapOrder odo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, Strides sdq, int H, int KH,
                    int Lq, int Lk, int causal, float scale) {
  using L = TileLayout<D>;
  using S = QSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  uint8_t* sq = base + S::Q_OFF;
  uint8_t* sdo = base + S::DO_OFF;
  uint8_t* sk = base + S::K_OFF;
  uint8_t* sv = base + S::V_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::BARS_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;             // [kStages]
  uint64_t* empty = bars + 1 + kStages;  // [kStages]

  // Causal tiles run longest first: the grid's slowest dimension walks the
  // query tiles from the last one down, for every head and batch at once.
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kRows, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KH);
  const int k_end = causal ? min(Lk, q0 + kRows) : Lk;
  const int n_kb = (k_end + kTile - 1) / kTile;
  // The role, warp-uniform as ptxas sees it (a shuffle from lane 0, as
  // CUTLASS does): ptxas then spills less under setmaxnreg's budget.
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0),
            warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0), lane = tid % 32;

  if (tid == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 256);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one lane issues every TMA load
    repro::setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      const int halves = min(2, (Lq - q0 + kTile - 1) / kTile);
      repro::mbar_expect_tx(q_full, 2 * halves * L::TILE);
      for (int j = 0; j < halves; ++j) {
        tma_load_tile<D>(sq + j * L::TILE, &tq, oq, q_full, q0 + j * kTile, h, b);
        tma_load_tile<D>(sdo + j * L::TILE, &tdo, odo, q_full, q0 + j * kTile, h, b);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) repro::mbar_wait(&empty[s], ((kb / kStages) - 1) & 1);
        repro::mbar_expect_tx(&full[s], 2 * L::TILE);
        tma_load_tile<D>(sk + s * L::TILE, &tk, ok, &full[s], kb * kTile, kvh, b);
        tma_load_tile<D>(sv + s * L::TILE, &tv, ov, &full[s], kb * kTile, kvh, b);
      }
    }
    return;
  }

  repro::setmaxnreg_inc<kConsumerRegs>();
  // Rows are queries here, the columns of S and dP keys.
  const int qw0 = q0 + wg * kTile;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int qpos0 = qw0 + r0, qpos1 = qpos0 + 8;
  const float scale_log2 = scale * kLog2e;
  const long long row = ((long long)b * H + h) * Lq;
  const float lse0 = qpos0 < Lq ? lse[row + qpos0] * kLog2e : 0.f;
  const float lse1 = qpos1 < Lq ? lse[row + qpos1] * kLog2e : 0.f;
  const float dlt0 = qpos0 < Lq ? delta[row + qpos0] : 0.f;
  const float dlt1 = qpos1 < Lq ? delta[row + qpos1] : 0.f;
  const uint32_t sq_a = repro::smem_u32(sq + wg * L::TILE);
  const uint32_t sdo_a = repro::smem_u32(sdo + wg * L::TILE);
  const bool live = qw0 < Lq;
  float adq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adq[i] = 0.f;

  repro::mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kTile;
    repro::mbar_wait(&full[s], (kb / kStages) & 1);
    // A key tile wholly past this warpgroup's rows adds nothing.
    if (live && !(causal && k0 > qw0 + kTile - 1)) {
      const uint32_t sk_a = repro::smem_u32(sk + s * L::TILE);
      const uint32_t sv_a = repro::smem_u32(sv + s * L::TILE);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      // S = Q K^T, then dP = dO V^T; P is formed while dP runs.
      repro::wgmma_fence();
      kmajor_product<D>(sc, sq_a, sk_a);
      repro::wgmma_commit();
      kmajor_product<D>(dp, sdo_a, sv_a);
      repro::wgmma_commit();
      repro::wgmma_wait<1>();
      fence_all(sc);
      const bool edge =
          k0 + kTile > Lk || qw0 + kTile > Lq || (causal && k0 + kTile - 1 > qw0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i % 2);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        float p = exp2f(sc[i] * scale_log2 - ((i & 2) ? lse1 : lse0));
        if (edge && (kpos >= Lk || qpos >= Lq || (causal && kpos > qpos))) p = 0.f;
        sc[i] = p;
      }
      repro::wgmma_wait<0>();
      fence_all(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - ((i & 2) ? dlt1 : dlt0));
      uint32_t sa[16];
      to_a(sa, dp);
      fence_all(adq);
      fence_all(sa);
      // dQ += dS K (depth: this tile's 64 keys; K read MN-major).
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        repro::wgmma_rs_tb<D>(adq, sa + 4 * kk, vmajor_desc<D>(sk_a, kk), 1);
      repro::wgmma_commit();
      repro::wgmma_wait0();
      fence_all(adq);
    }
    repro::mbar_arrive(&empty[s]);
  }
  if (live)
    store_rows<D>(dq + b * sdq.b + h * sdq.h + cq, sdq.l, adq, qpos0, Lq, scale);
}

// The launch gives each thread kLaunchRegs registers only if ptxas
// compiled the kernel at that count; with fewer, the consumers' setmaxnreg
// would wait for registers that never come, so the launch is refused.
template <typename Kernel>
cudaError_t check_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs >= kLaunchRegs ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, const Strides* st, int B, int H,
                   int KH, int Lq, int Lk, int causal, float scale,
                   const int* work, int n_work, int split, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (work == nullptr || split < 1 || split > kMaxSplit || n_work <= 0 ||
      n_work % split != 0)
    return cudaErrorInvalidValue;
  static bool done_kv[64] = {}, done_q[64] = {};
  cudaError_t err = set_smem_once(dkdv_wgmma_kernel<D>, KvSmem<D>::SMEM, done_kv);
  if (err != cudaSuccess) return err;
  if ((err = set_smem_once(dq_wgmma_kernel<D>, QSmem<D>::SMEM, done_q)) != cudaSuccess)
    return err;
  if ((err = check_regs(dkdv_wgmma_kernel<D>)) != cudaSuccess) return err;
  if ((err = check_regs(dq_wgmma_kernel<D>)) != cudaSuccess) return err;
  // st: q, k, v, o, dO, dq, dk, dv
  CUtensorMap tq, tk, tv, tdo;
  MapOrder oq, ok, ov, odo;
  if ((err = repro::encode<D>(&tq, &oq, q, st[0], B, H, Lq)) != cudaSuccess) return err;
  if ((err = repro::encode<D>(&tk, &ok, k, st[1], B, KH, Lk)) != cudaSuccess) return err;
  if ((err = repro::encode<D>(&tv, &ov, v, st[2], B, KH, Lk)) != cudaSuccess) return err;
  if ((err = repro::encode<D>(&tdo, &odo, dout, st[4], B, H, Lq)) != cudaSuccess)
    return err;

  const long long rows = (long long)B * H * Lq;
  const int warps = ::kThreads / 32;
  delta_kernel<bf16, D><<<(unsigned)((rows + warps - 1) / warps), ::kThreads, 0,
                          stream>>>(static_cast<const bf16*>(o),
                                    static_cast<const bf16*>(dout), delta, st[3],
                                    st[4], H, Lq, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_work);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = KvSmem<D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dkdv_wgmma_kernel<D>, tq, tk, tv, tdo, oq, ok, ov,
                           odo, lse, static_cast<const float*>(delta),
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), st[6],
                           st[7], work, split, H, Lq, Lk, causal, scale);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid_q(H, B, (Lq + kRows - 1) / kRows);
  dq_wgmma_kernel<D><<<grid_q, kThreads, QSmem<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, oq, ok, ov, odo, lse, delta, static_cast<bf16*>(dq), st[5], H,
      KH, Lq, Lk, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, const Strides* st, int B, int H,
                   int KH, int Lq, int Lk, int causal, float scale,
                   cudaStream_t stream) {
  using S = Tiles<D>;
  static bool done_kv[64] = {}, done_q[64] = {};
  cudaError_t err = set_smem_once(dkdv_kernel<T, D>, dkdv_smem<D>(), done_kv);
  if (err != cudaSuccess) return err;
  if ((err = set_smem_once(dq_kernel<T, D>, dq_smem<D>(), done_q)) != cudaSuccess)
    return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  // st: q, k, v, o, dO, dq, dk, dv
  const long long rows = (long long)B * H * Lq;
  const int warps = kThreads / 32;
  delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                       stream>>>(static_cast<const T*>(o), tdo, delta, st[3],
                                 st[4], H, Lq, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((Lk + S::BK - 1) / S::BK, KH, B);
  dkdv_kernel<T, D><<<grid_kv, kThreads, dkdv_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      st[0], st[1], st[2], st[4], st[6], st[7], H, KH, Lq, Lk, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((Lq + S::BQ - 1) / S::BQ, H, B);
  dq_kernel<T, D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), st[0], st[1], st[2],
      st[4], st[5], H, KH, Lq, Lk, causal, scale);
  return cudaGetLastError();
}

// 1 = tensor cores (bf16 at D 64, 80, 128), 0 = CUDA cores, -1 = refused.
int variant(int D, int dtype) {
  const bool known = D == 32 || D == 64 || D == 80 || D == 128 || D == 256;
  if (!known || (dtype != 0 && dtype != 1)) return -1;
  return (dtype == 1 && (D == 64 || D == 80 || D == 128)) ? 1 : 0;
}

// One case a (head dim, dtype) pair that variant() accepts, keyed 2 D +
// dtype: bf16 at D 64, 80 and 128 on the tensor cores (which take the work
// list), the rest on the CUDA cores, so no instantiation is compiled that
// no call reaches.
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* o, const void* dout,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, const Strides* st, int B, int H, int KH, int Lq,
                     int Lk, int causal, float scale, const int* work,
                     int n_work, int split, cudaStream_t s) {
#define REPRO_BWD_ARGS \
  q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H, KH, Lq, Lk, causal, scale
#define REPRO_BWD_CC(T, DD, DT) \
  case 2 * DD + DT:             \
    return launch<T, DD>(REPRO_BWD_ARGS, s)
#define REPRO_BWD_TC(DD) \
  case 2 * DD + 1:       \
    return tc::launch<DD>(REPRO_BWD_ARGS, work, n_work, split, s)
  switch (2 * D + dtype) {
    REPRO_BWD_CC(float, 32, 0);
    REPRO_BWD_CC(float, 64, 0);
    REPRO_BWD_CC(float, 80, 0);
    REPRO_BWD_CC(float, 128, 0);
    REPRO_BWD_CC(float, 256, 0);
    REPRO_BWD_CC(__nv_bfloat16, 32, 1);
    REPRO_BWD_TC(64);
    REPRO_BWD_TC(80);
    REPRO_BWD_TC(128);
    REPRO_BWD_CC(__nv_bfloat16, 256, 1);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_TC
#undef REPRO_BWD_CC
#undef REPRO_BWD_ARGS
}

}  // namespace

// The variant a call with this head dim and dtype takes: 1 = tensor cores,
// 0 = CUDA cores, -1 = refused.
extern "C" int flash_attention_bwd_variant(int D, int dtype) {
  return variant(D, dtype);
}

// dtype: 0 = float32, 1 = bfloat16 (all eight operands). q, o, dO and dq
// viewed as (B, H, Lq, D), k, v, dk and dv as (B, KH, Lk, D), each with D
// contiguous; strides: 24 element strides, (b, h, l) of q, k, v, o, dO, dq,
// dk, dv in that order. lse (the forward's) and delta (scratch) are f32
// (B, H, Lq) contiguous. work: the tensor-core variant's dkdv work list on
// the device, n_work items of five int32 (batch, kv head, 128-key tile,
// first and one-past-last query head), the `split` groups of one key tile
// consecutive (one cluster); the CUDA-core variant ignores it (null, 0, 1).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KH, int Lq, int Lk, int D, int causal,
    float scale, int dtype, const long long* strides, const int* work,
    int n_work, int split, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  if (causal && Lq != Lk) return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant(D, dtype) < 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(D, dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                       B, H, KH, Lq, Lk, causal, scale, work, n_work, split, s);
}

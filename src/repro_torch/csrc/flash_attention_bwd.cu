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
// in three launches on the caller's stream, with no atomics, so two runs
// give the same bits:
//   1. delta_kernel: one warp a query row, delta into an f32 scratch.
//   2. dkdv: one CTA a (batch, kv head, 64-key tile). It keeps its K and V
//      tiles in shared memory and dK, dV in registers, and walks the query
//      tiles of its G query heads (causal: only those at or below the
//      diagonal), recomputing P and dS per tile. dK and dV of a kv head sum
//      over its G heads inside the CTA.
//   3. dq: one CTA a (batch, head, 64-row query tile); it keeps Q, dO and dQ
//      and walks the key tiles (causal: up to the diagonal).
//
// What bounds it on an H100: operations. It does 2.5x the forward's matmul
// FLOPs at the least (3.5x here, since dq recomputes S and dP), at hundreds
// of FLOPs a byte. Two variants, chosen by dtype and head dim in the C entry
// point (flash_attention_bwd_variant() names the one a call takes):
//   * tensor cores (bf16 at D 64, 80, 128: the models' training shapes):
//     mma.sync m16n8k16 on bf16 tiles, described at namespace tc below.
//     wgmma on TMA-fed tiles, as the forward, is later work.
//   * CUDA cores (f32, and D 32 and 256): every tile widened to f32 in
//     shared memory (rows padded by one word, so the column walks are free
//     of bank conflicts); each of 256 threads owns a 4 x 4 block of a 64 x 64
//     score tile (rows ty + 16 i, columns tx + 16 j) and a (BK / 16) x
//     (D / 16) block of dK and dV (or dQ), with scalar FMAs.
//
// Interface: plain C, pointers from torch tensors, the strides of the eight
// operands in a host array; launched on the caller's stream; returns the
// first cudaError_t of the three launches (0 on success).

#include "common.cuh"

namespace {

using repro::load16;
using repro::store;

constexpr int kThreads = 256;  // 16 x 16

// Element strides of one operand viewed as (B, heads, L, D), D contiguous.
struct Strides {
  long long b, h, l;
};

template <int D>
struct Tiles {
  static constexpr int BK = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows a tile
  static constexpr int DP = D + 1;              // padded f32 row of a tile
  static constexpr int PP = BK + 1;             // padded row of P / dS
};

template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

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
// bf16 at head dims 64, 80 and 128: the same three launches, with the four
// products of a tile pair as mma.sync m16n8k16 (bf16 operands, f32
// accumulators) from bf16 tiles in shared memory (rows padded by 16 bytes,
// so the ldmatrix row addresses of a warp fall in distinct bank groups).
//   * dkdv: one CTA a (batch, kv head, 64-key tile), four warps of 16 keys.
//     A warp forms S^T = K Q^T and dP^T = V dO^T for its keys and a
//     32-query step, turns them into P^T and dS^T in registers (the
//     accumulator fragment of two n-tiles is the A fragment of one k-step,
//     as in the forward), and accumulates dV += P^T dO and dK += dS^T Q with
//     dO and Q read transposed by ldmatrix.trans.
//   * dq: one CTA a (batch, head, 64-query tile), four warps of 16 queries;
//     S = Q K^T and dP = dO V^T a 32-key step, dQ += dS K.
// P and dS are rounded to bf16 as operands (2**-9 relative, as the forward
// rounds P); every sum stays f32.
namespace tc {

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // keys of a dkdv CTA, queries of a dq CTA
constexpr int kStep = 32;      // queries (dkdv) or keys (dq) a step
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int SD = D + 8;   // padded row of a bf16 tile
  static constexpr int NT = D / 8;   // n-tiles over D
  static constexpr int KT = D / 16;  // k-steps over D
  static_assert(NT % 2 == 0, "head dim");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a [rows][SD] tile.
template <int SD>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int c0, int lane) {
  return tile + ((r0 + lane % 16) * SD + c0 + (lane / 16) * 8) * 2;
}

// B fragments of two n-tiles (rows n0..n0+15 of an [n][k] tile, k columns
// c0..c0+15): r[0..1] n-tile n0, r[2..3] n-tile n0 + 8.
template <int SD>
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int c0, int lane) {
  return tile + ((n0 + lane % 8 + (lane / 16) * 8) * SD + c0 + ((lane / 8) % 2) * 8) * 2;
}

// The same from a [k][n] tile read transposed (rows k0..k0+15, n columns
// n0..n0+15).
template <int SD>
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int k0, int n0, int lane) {
  return tile + ((k0 + lane % 8 + ((lane / 8) % 2) * 8) * SD + n0 + (lane / 16) * 8) * 2;
}

// ROWS rows of one head from row r0 on into a bf16 [ROWS][SD] tile; rows at
// or past L are zero.
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride_l, int r0, int L) {
  constexpr int CH = D / 8, SD = Cfg<D>::SD;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride_l + c);
    *reinterpret_cast<uint4*>(dst + r * SD + c) = val;
  }
}

// A fragments (two k-steps of 16) from the accumulators of four n-tiles.
__device__ __forceinline__ void to_a(uint32_t (&a)[2][4], const float (&c)[4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j][0] = pack(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

template <int D>
constexpr int dkdv_smem() {
  return (2 * kRows + 2 * kStep) * Cfg<D>::SD * 2 + 2 * kStep * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                   Strides sdv, int H, int KH, int Lq, int Lk, int causal,
                   float scale) {
  using C = Cfg<D>;
  constexpr int SD = C::SD, NT = C::NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][SD]
  __nv_bfloat16* vs = ks + kRows * SD;                             // [64][SD]
  __nv_bfloat16* qs = vs + kRows * SD;                             // [32][SD]
  __nv_bfloat16* gs = qs + kStep * SD;                             // dO [32][SD]
  float* lse_s = reinterpret_cast<float*>(gs + kStep * SD);        // [32], base 2
  float* dlt_s = lse_s + kStep;                                    // [32]

  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4);
  const int key0 = k0 + warp * 16 + lane / 4, key1 = key0 + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);
  const uint32_t qs_a = smem_addr(qs), gs_a = smem_addr(gs);

  copy_tile<D, kRows>(ks, k + b * sk.b + kvh * sk.h, sk.l, k0, Lk);
  copy_tile<D, kRows>(vs, v + b * sv.b + kvh * sv.h, sv.l, k0, Lk);

  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  // Causal: a query step meets this key tile when its last row >= k0.
  const int s0 = causal ? k0 / kStep : 0;
  const int n_steps = (Lq + kStep - 1) / kStep;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const __nv_bfloat16* qh = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* gh = dout + b * sdo.b + h * sdo.h;
    const float* lse_h = lse + ((long long)b * H + h) * Lq;
    const float* dlt_h = delta + ((long long)b * H + h) * Lq;
    for (int st = s0; st < n_steps; ++st) {
      const int q0 = st * kStep;
      __syncthreads();  // the previous step's tiles are read
      copy_tile<D, kStep>(qs, qh, sq.l, q0, Lq);
      copy_tile<D, kStep>(gs, gh, sdo.l, q0, Lq);
      if (threadIdx.x < kStep) {
        const bool ok = q0 + threadIdx.x < Lq;
        lse_s[threadIdx.x] = ok ? lse_h[q0 + threadIdx.x] * kLog2e : 0.f;
        dlt_s[threadIdx.x] = ok ? dlt_h[q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // S^T (16 keys x 32 queries) and dP^T of this warp's keys.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KT; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, a_addr<SD>(ks_a, warp * 16, kk * 16, lane));
        ldsm_x4(va, a_addr<SD>(vs_a, warp * 16, kk * 16, lane));
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t qb[4], gb[4];
          ldsm_x4(qb, b_addr<SD>(qs_a, pr * 16, kk * 16, lane));
          ldsm_x4(gb, b_addr<SD>(gs_a, pr * 16, kk * 16, lane));
          mma(s[2 * pr], ka, qb[0], qb[1]);
          mma(s[2 * pr + 1], ka, qb[2], qb[3]);
          mma(dp[2 * pr], va, gb[0], gb[1]);
          mma(dp[2 * pr + 1], va, gb[2], gb[3]);
        }
      }
      // P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta), masked.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (e & 2) ? key1 : key0;
          const int qi = j * 8 + t2 + (e & 1), qpos = q0 + qi;
          const bool ok = qpos < Lq && key < Lk && !(causal && key > qpos);
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_s[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt_s[qi]);
        }
      uint32_t pa[2][4], sa[2][4];
      to_a(pa, s);
      to_a(sa, dp);
      // dV += P^T dO, dK += dS^T Q (k = this step's queries, n = D).
#pragma unroll
      for (int kq = 0; kq < 2; ++kq)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t gb[4], qb[4];
          ldsm_x4_t(gb, bt_addr<SD>(gs_a, kq * 16, np * 16, lane));
          ldsm_x4_t(qb, bt_addr<SD>(qs_a, kq * 16, np * 16, lane));
          mma(adv[2 * np], pa[kq], gb[0], gb[1]);
          mma(adv[2 * np + 1], pa[kq], gb[2], gb[3]);
          mma(adk[2 * np], sa[kq], qb[0], qb[1]);
          mma(adk[2 * np + 1], sa[kq], qb[2], qb[3]);
        }
    }
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h + t2;
  __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h + t2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (key0 < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * sdk.l + n * 8) =
          __floats2bfloat162_rn(adk[n][0] * scale, adk[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * sdv.l + n * 8) =
          __floats2bfloat162_rn(adv[n][0], adv[n][1]);
    }
    if (key1 < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * sdk.l + n * 8) =
          __floats2bfloat162_rn(adk[n][2] * scale, adk[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * sdv.l + n * 8) =
          __floats2bfloat162_rn(adv[n][2], adv[n][3]);
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (2 * kRows + 2 * kStep) * Cfg<D>::SD * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk,
                 Strides sv, Strides sdo, Strides sdq, int H, int KH, int Lq,
                 int Lk, int causal, float scale) {
  using C = Cfg<D>;
  constexpr int SD = C::SD, NT = C::NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][SD]
  __nv_bfloat16* gs = qs + kRows * SD;                             // dO [64][SD]
  __nv_bfloat16* ks = gs + kRows * SD;                             // [32][SD]
  __nv_bfloat16* vs = ks + kStep * SD;                             // [32][SD]

  // Causal tiles run longest first: the last query tile walks the most keys.
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t qs_a = smem_addr(qs), gs_a = smem_addr(gs);
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);

  copy_tile<D, kRows>(qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  copy_tile<D, kRows>(gs, dout + b * sdo.b + h * sdo.h, sdo.l, q0, Lq);
  const float* lse_h = lse + ((long long)b * H + h) * Lq;
  const float* dlt_h = delta + ((long long)b * H + h) * Lq;
  const float lse0 = row0 < Lq ? lse_h[row0] * kLog2e : 0.f;
  const float lse1 = row1 < Lq ? lse_h[row1] * kLog2e : 0.f;
  const float dlt0 = row0 < Lq ? dlt_h[row0] : 0.f;
  const float dlt1 = row1 < Lq ? dlt_h[row1] : 0.f;

  float adq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  const __nv_bfloat16* kh = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vh = v + b * sv.b + kvh * sv.h;
  const int k_end = causal ? min(Lk, q0 + kRows) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += kStep) {
    __syncthreads();  // the previous step's K and V are read
    copy_tile<D, kStep>(ks, kh, sk.l, k0, Lk);
    copy_tile<D, kStep>(vs, vh, sv.l, k0, Lk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KT; ++kk) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, a_addr<SD>(qs_a, warp * 16, kk * 16, lane));
      ldsm_x4(ga, a_addr<SD>(gs_a, warp * 16, kk * 16, lane));
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, b_addr<SD>(ks_a, pr * 16, kk * 16, lane));
        ldsm_x4(vb, b_addr<SD>(vs_a, pr * 16, kk * 16, lane));
        mma(s[2 * pr], qa, kb[0], kb[1]);
        mma(s[2 * pr + 1], qa, kb[2], kb[3]);
        mma(dp[2 * pr], ga, vb[0], vb[1]);
        mma(dp[2 * pr + 1], ga, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = (e & 2) ? row1 : row0;
        const int kpos = k0 + j * 8 + t2 + (e & 1);
        const bool ok = qpos < Lq && kpos < Lk && !(causal && kpos > qpos);
        const float p =
            ok ? exp2f(s[j][e] * scale_log2 - ((e & 2) ? lse1 : lse0)) : 0.f;
        dp[j][e] = p * (dp[j][e] - ((e & 2) ? dlt1 : dlt0));
      }
    uint32_t sa[2][4];
    to_a(sa, dp);
    // dQ += dS K (k = this step's keys, n = D).
#pragma unroll
    for (int kq = 0; kq < 2; ++kq)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4_t(kb, bt_addr<SD>(ks_a, kq * 16, np * 16, lane));
        mma(adq[2 * np], sa[kq], kb[0], kb[1]);
        mma(adq[2 * np + 1], sa[kq], kb[2], kb[3]);
      }
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h + t2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * sdq.l + n * 8) =
          __floats2bfloat162_rn(adq[n][0] * scale, adq[n][1] * scale);
    if (row1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * sdq.l + n * 8) =
          __floats2bfloat162_rn(adq[n][2] * scale, adq[n][3] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, const Strides* st, int B, int H,
                   int KH, int Lq, int Lk, int causal, float scale,
                   cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  static bool done_kv[64] = {}, done_q[64] = {};
  cudaError_t err = set_smem_once(dkdv_tc_kernel<D>, dkdv_smem<D>(), done_kv);
  if (err != cudaSuccess) return err;
  if ((err = set_smem_once(dq_tc_kernel<D>, dq_smem<D>(), done_q)) != cudaSuccess)
    return err;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const long long rows = (long long)B * H * Lq;
  const int warps = ::kThreads / 32;
  delta_kernel<bf16, D><<<(unsigned)((rows + warps - 1) / warps), ::kThreads, 0,
                          stream>>>(static_cast<const bf16*>(o), tdo, delta,
                                    st[3], st[4], H, Lq, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((Lk + kRows - 1) / kRows, KH, B);
  dkdv_tc_kernel<D><<<grid_kv, kThreads, dkdv_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      st[0], st[1], st[2], st[4], st[6], st[7], H, KH, Lq, Lk, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((Lq + kRows - 1) / kRows, H, B);
  dq_tc_kernel<D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), st[0], st[1], st[2],
      st[4], st[5], H, KH, Lq, Lk, causal, scale);
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
// dtype: bf16 at D 64, 80 and 128 on the tensor cores, the rest on the CUDA
// cores, so no instantiation is compiled that no call reaches.
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* o, const void* dout,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, const Strides* st, int B, int H, int KH, int Lq,
                     int Lk, int causal, float scale, cudaStream_t s) {
#define REPRO_BWD_ARGS \
  q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H, KH, Lq, Lk, causal, scale, s
#define REPRO_BWD_CC(T, DD, DT) \
  case 2 * DD + DT:             \
    return launch<T, DD>(REPRO_BWD_ARGS)
#define REPRO_BWD_TC(DD) \
  case 2 * DD + 1:       \
    return tc::launch<DD>(REPRO_BWD_ARGS)
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
// (B, H, Lq) contiguous.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KH, int Lq, int Lk, int D, int causal,
    float scale, int dtype, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  if (causal && Lq != Lk) return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant(D, dtype) < 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(D, dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                       B, H, KH, Lq, Lk, causal, scale, s);
}

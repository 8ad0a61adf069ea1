// Decode attention for Hopper (sm_90a): one query token per sequence against
// a block-table-indirected KV page pool, split across a thread-block cluster.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (body _paged_kernel), the TPU kernel whose jnp twin the reference model
// runs at decode (models/layers.py::decode_attention over the slot cache),
// with its bf16, f32 and int8 pages. Int8 pages carry one scale per
// (position, head) (f16 in the model's cache, f32 in the reference's kernel
// test).
//
// What bounds it on an H100: bytes. Each KV position is read once and used
// for G = H / K query heads, about 2 * G FLOPs per KV byte, far below the
// card's ~295 FLOPs per byte. The floor is sum(lengths) * K * 2 (K and V)
// * (D * itemsize + scale bytes) per layer at 3.35 TB/s; at serving batch
// sizes what keeps a kernel from it is too few CTAs and too few bytes in
// flight.
//
// What this design does about it:
//   * Split (flash-decoding). Each sequence's positions, for each KV head,
//     are cut into S shares of ceil(length / S) positions, one CTA each,
//     the length read on the card. The wrapper picks S (at most 8) from B,
//     K and the mapped length alone (no sync): the largest power of two
//     that keeps the grid within one CTA per SM, since a CTA has a fixed
//     cost of a few microseconds (length, block table and first tile read
//     in series, then the merges). A boundary may fall inside a page. A
//     share that starts at or past the length is empty (m = -1e30, l = 0,
//     acc = 0: a finite "minus infinity", so empty shares weigh 0 without
//     inf - inf).
//   * The combine stays in the launch: the S CTAs of one (sequence, KV
//     head) are one thread-block cluster. Each CTA first merges its warps'
//     states in shared memory; after cluster.sync() every CTA reads the
//     others' partials (cluster.map_shared_rank) for its own slice of the
//     outputs and writes it; a second cluster.sync() keeps shared memory
//     alive until all have read. The sums run in a fixed order, so results
//     do not vary from run to run.
//   * Pipelined loads. Tiles of 64 positions stream through a two-stage
//     ring of 16-byte cp.async copies in the pages' own type (bf16, int8 or
//     f32; rows padded by 16 bytes so a warp's row reads spread over the
//     banks): the next tile is in flight while one is computed, and values
//     are widened to f32 at use. Two stages and at most 128 registers a
//     thread let two CTAs share an SM, which the cluster launch places
//     faster than one large CTA. One block-table entry names one page; each
//     tile's entries (at most 64) pass through a two-slot ring in shared
//     memory: read into registers a tile before they are stored, stored a
//     tile before their copies are issued. Shared memory does not grow with
//     the table, and the first tiles' entries come from a row of at most
//     256 entries read alongside the length. Int8 scales are read into
//     registers with the copies and stored after the current tile's
//     products; the K scale multiplies the dot product, the V scale the
//     probability.
//   * Positions at or past a length are never read (no copy is issued for
//     them and no product reads their rows), so pages past the length may
//     hold anything, NaN included.
//   * One barrier a tile. Each warp owns 8 positions of every tile and runs
//     its own online softmax over them: lanes 4t..4t+3 split D for position
//     t and compute it against every query head of the CTA (up to 8, so
//     one K load feeds 8 heads, with 8 independent sums), quad and warp
//     shuffles give the scores, the tile's max and sum; the probabilities
//     pass to the P V lanes through a warp-private buffer. In P V a lane
//     holds 8 columns of every head (64 f32 accumulators) over a few of the
//     warp's positions, so one V load feeds 64 FMAs. Full MHA (zamba2,
//     G = 1) compiles with one head's registers; a KV head with more than 8
//     query heads spreads them over CTAs.
//   * The log-sum-exp, where the caller asks for it (a non-null lse): the
//     cluster's combine already forms each head's max m and denominator l
//     over all shares; the first CTA writes m + log l (f32, the scaled-score
//     units), -inf where no position is valid. A sequence-sharded cache's
//     shards merge their partial outputs with it.
//   * What bounds it now: at G = 8 the f32 products on the CUDA cores. A
//     tile costs a CTA about as long as its bytes take to arrive, so a long
//     sequence on few (sequence, KV head) pairs runs below the card's byte
//     rate.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include <cooperative_groups.h>
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kNegInf;
using repro::store;
using repro::to_f32;

constexpr int kTok = 64;       // cache positions per tile
constexpr int kThreads = 256;  // eight warps
constexpr int kMaxSplit = 8;   // portable cluster size

// Eight values of a shared-memory row, widened to f32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  repro::load16(p, out);
}
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(c[j]);
}

template <typename TKV, int D>
struct Paged {
  static constexpr int ROW = D * (int)sizeof(TKV) + 16;  // padded row bytes
  static constexpr int CH16 = D * (int)sizeof(TKV) / 16;  // copies a row
  static constexpr int STAGE = 2 * kTok * ROW;            // K and V tiles
  // Two stages (one tile in flight while one is computed) keep a CTA
  // small enough for two per SM, which clusters are placed faster with;
  // f32 pages at D = 256 leave room for one.
  static constexpr int STAGES = 2 * STAGE <= 200 * 1024 ? 2 : 1;
  static constexpr int CHQ = D / 8;  // 8-column chunks a row
  // P V lanes: NG column groups (CHQ rounded up to a power of two, at most
  // 32), LPD = 32 / NG lanes on each group splitting the warp's positions.
  static constexpr int NG = CHQ <= 4 ? 4 : CHQ <= 8 ? 8 : CHQ <= 16 ? 16 : 32;
  static constexpr int LPD = 32 / NG;
  // Dynamic shared memory with GMAX query heads a CTA, as the kernel lays
  // it out: the ring, then f32 q, probabilities, warp and CTA states,
  // combine weights, int8 scales, and the block-table slots.
  template <int GMAX>
  static constexpr size_t smem() {
    constexpr int kWarps = kThreads / 32;
    constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
    return (size_t)STAGES * STAGE +
           sizeof(float) * ((size_t)GMAX * D + kWarps * 8 * GMAX +
                            2 * kWarps * GMAX + 2 * GMAX + kMaxSplit * GMAX +
                            (kQuant ? 2 * STAGES * kTok : 0)) +
           sizeof(int) * 2 * kTok;
  }
};

// TS is the type of the int8 pages' scales (unused for bf16/f32 pages).
// GMAX query heads per CTA (1, or 8 with the CTA's count ng <= 8 at run
// time); a KV head with more query heads spreads them over CTAs.
template <typename TQ, typename TKV, typename TS, int D, int GMAX>
__global__ void __launch_bounds__(kThreads, 2)
    paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const TS* __restrict__ k_scales,
                       const TS* __restrict__ v_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, TQ* __restrict__ o,
                       float* __restrict__ lse, int H, int KH, int page,
                       int pps, float scale) {
  using P = Paged<TKV, D>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int STAGES = P::STAGES;
  constexpr int kWarps = kThreads / 32;
  static_assert(kWarps * GMAX * D * 4 <= STAGES * P::STAGE,
                "the warps' partials must fit in the tile ring");
  const int G = H / KH;
  const int n_hg = (G + GMAX - 1) / GMAX;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();  // == blockIdx.x
  const int n_split = (int)cluster.num_blocks();

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                    // [STAGES][K|V]
  float* qs = reinterpret_cast<float*>(ring + STAGES * P::STAGE);  // [GMAX][D]
  float* pw = qs + GMAX * D;                  // [kWarps][8][GMAX] probabilities
  float* wm = pw + kWarps * 8 * GMAX;         // [kWarps][GMAX] warp max
  float* wl = wm + kWarps * GMAX;             // [kWarps][GMAX] warp sum
  float* cm = wl + kWarps * GMAX;             // [GMAX] CTA max
  float* cl = cm + GMAX;                      // [GMAX] CTA sum
  float* wgt = cl + GMAX;                     // [kMaxSplit][GMAX] combine weights
  float* ksc = wgt + kMaxSplit * GMAX;        // [STAGES][kTok]
  float* vsc = ksc + (kQuant ? STAGES * kTok : 0);  // [STAGES][kTok]
  int* bts = reinterpret_cast<int*>(vsc + (kQuant ? STAGES * kTok : 0));  // [2][kTok]
  float* wacc = reinterpret_cast<float*>(ring);  // [kWarps][GMAX][D], after the loop
  float* part = qs;                              // [GMAX][D], after the loop

  const int kvh = blockIdx.y / n_hg;
  const int g0 = (blockIdx.y % n_hg) * GMAX;  // first of this CTA's heads
  const int ng = min(GMAX, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // A short block-table row is read alongside the length, not after it.
  const int* bt = block_tables + (size_t)b * pps;
  const int bt_own = (pps <= kThreads && tid < pps) ? bt[tid] : 0;
  // This share of the sequence: ceil(len / S) positions from split * that.
  // A length past the mapped pages means every mapped position is valid.
  const int len = min(lengths[b], pps * page);
  const int chunk = (len + n_split - 1) / n_split;
  const int p0 = split * chunk;
  const int p_end = min(p0 + chunk, len);
  const int n_tiles = p_end > p0 ? (p_end - p0 + kTok - 1) / kTok : 0;
  // Tile j's pages, (p0 + 64 j) / page onwards, at most 64 (page = 1), sit
  // in slot j % 2 of bts; entry i names the tile's i-th page.
  auto tile_pages = [&](int j, int& first) {
    const int t0 = p0 + j * kTok;
    first = t0 / page;
    return (min(t0 + kTok, p_end) - 1) / page - first + 1;
  };
  // Thread i < (tile j's pages) reads entry i of tile j; the rest read none.
  auto read_entry = [&](int j) {
    int first;
    const int n = tile_pages(j, first);
    return tid < n ? bt[first + tid] : 0;
  };
  for (int j = 0; j < STAGES && j < n_tiles; ++j) {  // the first tiles' entries
    int first;
    const int n = tile_pages(j, first);
    int* slot = bts + (j % 2) * kTok;
    if (pps <= kThreads) {
      if (tid >= first && tid < first + n) slot[tid - first] = bt_own;
    } else if (tid < n) {
      slot[tid] = bt[first + tid];
    }
  }
  const TQ* qg = q + ((size_t)b * H + (size_t)kvh * G + g0) * D;
  for (int i = tid; i < GMAX * D; i += kThreads)
    qs[i] = i < ng * D ? to_f32(qg[i]) : 0.f;
  __syncthreads();

  // Copies of tile j into its stage; int8 scales of its positions come
  // back in registers (thread t < 64 holds position t's).
  auto issue = [&](int j, float& sk, float& sv) {
    const int t0 = p0 + j * kTok;
    const int nt = min(kTok, p_end - t0);
    const int* slot = bts + (j % 2) * kTok;
    const int page0 = t0 / page;
    uint8_t* kt = ring + (j % STAGES) * P::STAGE;
    uint8_t* vt = kt + kTok * P::ROW;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(kp);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(vp);
    for (int i = tid; i < nt * P::CH16; i += kThreads) {
      const int t = i / P::CH16, c = i % P::CH16;
      const int pos = t0 + t;
      const size_t row =
          ((size_t)slot[pos / page - page0] * page + pos % page) * KH +
          kvh;
      const size_t off = row * (D * sizeof(TKV)) + c * 16;
      repro::cp_async16(kt + t * P::ROW + c * 16, kb + off);
      repro::cp_async16(vt + t * P::ROW + c * 16, vb + off);
    }
    if constexpr (kQuant) {
      if (tid < nt) {
        const int pos = t0 + tid;
        const size_t row =
            ((size_t)slot[pos / page - page0] * page + pos % page) * KH +
            kvh;
        sk = to_f32(k_scales[row]);
        sv = to_f32(v_scales[row]);
      }
    }
  };
  auto put_scales = [&](int j, float sk, float sv) {
    if constexpr (kQuant) {
      if (tid < kTok) {
        ksc[(j % STAGES) * kTok + tid] = sk;
        vsc[(j % STAGES) * kTok + tid] = sv;
      }
    }
  };

  // Each warp owns positions 8 * warp .. 8 * warp + 7 of every tile and
  // keeps its own softmax state (m, l) and accumulators for the CTA's heads.
  // Scores: lane = 4 * (position) + sub, sub splitting D's 8-column chunks.
  const int tt = lane >> 2, sub = lane & 3;
  // P V: lane = dg + NG * pp; column group dg, positions pp, pp + LPD, ...
  const int dg = lane % P::NG, pp = lane / P::NG;
  float m_w[GMAX], l_w[GMAX], acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  float sk_next = 0.f, sv_next = 0.f;
  // An entry of tile j + STAGES, read from global memory during tile j - 1
  // and stored after tile j's barrier, so its load has a whole tile to land.
  int bt_next = STAGES < n_tiles ? read_entry(STAGES) : 0;
  // Prologue: STAGES - 1 groups, empty past the last tile, so that the
  // wait below always leaves exactly the later tiles in flight.
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) {
      issue(j, sk_next, sv_next);
      put_scales(j, sk_next, sv_next);
    }
    repro::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (STAGES == 1) {
      __syncthreads();  // the previous tile is consumed
      issue(j, sk_next, sv_next);
      put_scales(j, sk_next, sv_next);
      repro::cp_async_commit();
      repro::cp_async_wait<0>();
    } else {
      repro::cp_async_wait<STAGES - 2>();
    }
    __syncthreads();  // tile j landed for every thread; tile j - 1 consumed
    // Slot (j + STAGES) % 2 was last read by the copies of tile j + STAGES - 2,
    // issued before this barrier.
    if (j + STAGES < n_tiles) {
      if (tid < kTok) bts[((j + STAGES) % 2) * kTok + tid] = bt_next;
      if (j + STAGES + 1 < n_tiles) bt_next = read_entry(j + STAGES + 1);
    }
    const bool ahead = STAGES > 1 && j + STAGES - 1 < n_tiles;
    if constexpr (STAGES > 1) {
      if (ahead) issue(j + STAGES - 1, sk_next, sv_next);
      repro::cp_async_commit();
    }

    const int nt = min(kTok, p_end - (p0 + j * kTok));
    const TKV* kt =
        reinterpret_cast<const TKV*>(ring + (j % STAGES) * P::STAGE);
    const TKV* vt = reinterpret_cast<const TKV*>(
        ring + (j % STAGES) * P::STAGE + kTok * P::ROW);
    constexpr int ROWE = P::ROW / (int)sizeof(TKV);  // row stride, elements

    // Scores of this lane's position for every head.
    const int t = 8 * warp + tt;
    const bool live = t < nt;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < (P::CHQ + 3) / 4; ++i) {
        const int c = sub + 4 * i;
        if (c < P::CHQ) {
          float kx[8];
          load8(kt + t * ROWE + 8 * c, kx);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            float qx[8];
            load8(qs + g * D + 8 * c, qx);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] = fmaf(qx[e], kx[e], s[g]);
          }
        }
      }
    }
    float kscale = scale;
    if constexpr (kQuant) kscale *= live ? ksc[(j % STAGES) * kTok + t] : 0.f;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
      s[g] = live ? s[g] * kscale : kNegInf;
      float mt = s[g];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_w[g], mt);
      const float corr = expf(m_w[g] - m_new);
      const float p = live ? expf(s[g] - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_w[g] = l_w[g] * corr + ps;
      m_w[g] = m_new;
      s[g] = p;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
    if (sub == 0) {  // the probabilities, V scale applied, for the P V lanes
      float vscale = 1.f;
      if constexpr (kQuant) vscale = live ? vsc[(j % STAGES) * kTok + t] : 0.f;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) pw[(warp * 8 + tt) * GMAX + g] = s[g] * vscale;
    }
    __syncwarp();

    // O += P V over the warp's positions (acc already rescaled above).
    if (dg < P::CHQ) {
#pragma unroll
      for (int i = 0; i < 8 / P::LPD; ++i) {
        const int u = pp + P::LPD * i;  // position within the warp's eight
        if (8 * warp + u < nt) {
          float vx[8], pr[GMAX];
          load8(vt + (8 * warp + u) * ROWE + 8 * dg, vx);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) pr[g] = pw[(warp * 8 + u) * GMAX + g];
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr[g], vx[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
    if (ahead) put_scales(j + STAGES - 1, sk_next, sv_next);
  }

  // The CTA's partial: the warps' states merged in warp order (the ring,
  // drained, holds their accumulators).
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = P::NG; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (pp == 0 && dg < P::CHQ) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        wacc[(warp * GMAX + g) * D + 8 * dg + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      wm[warp * GMAX + g] = m_w[g];
      wl[warp * GMAX + g] = l_w[g];
    }
  }
  __syncthreads();
  if (tid < ng) {  // CTA max and sum; the warps' weights into pw
    float m_all = kNegInf;
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, wm[w * GMAX + tid]);
    float l_all = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * GMAX + tid] - m_all);
      pw[w * GMAX + tid] = e;
      l_all = fmaf(e, wl[w * GMAX + tid], l_all);
    }
    cm[tid] = m_all;
    cl[tid] = l_all;
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kThreads) {
    const int g = i / D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      x = fmaf(pw[w * GMAX + g], wacc[(w * GMAX + g) * D + i % D], x);
    part[i] = x;
  }

  // Combine the cluster's partials in rank order. Every CTA of the cluster
  // writes a slice of the outputs; per head, share s weighs
  // exp(m_s - max m) / sum_s exp(m_s - max m) l_s.
  cluster.sync();
  if (tid < ng) {
    float mv[kMaxSplit], lv[kMaxSplit];
    float m_all = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mv[r] = r < n_split ? cluster.map_shared_rank(cm, r)[tid] : kNegInf;
      lv[r] = r < n_split ? cluster.map_shared_rank(cl, r)[tid] : 0.f;
      m_all = fmaxf(m_all, mv[r]);
    }
    float l_all = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mv[r] = expf(mv[r] - m_all);
      l_all = fmaf(mv[r], lv[r], l_all);
    }
    const float inv = 1.f / fmaxf(l_all, 1e-30f);
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) wgt[r * GMAX + tid] = mv[r] * inv;
    if (lse != nullptr && split == 0)  // no valid position: l_all = 0
      lse[(size_t)b * H + (size_t)kvh * G + g0 + tid] =
          l_all > 0.f ? m_all + logf(l_all) : -CUDART_INF_F;
  }
  __syncthreads();
  const float* parts[kMaxSplit];
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r)
    parts[r] = cluster.map_shared_rank(part, r < n_split ? r : 0);
  TQ* og = o + ((size_t)b * H + (size_t)kvh * G + g0) * D;
  const int per = (ng * D + n_split - 1) / n_split;
  for (int i = split * per + tid; i < min(ng * D, (split + 1) * per); i += kThreads) {
    const int g = i / D;
    float x[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) x[r] = r < n_split ? parts[r][i] : 0.f;
    float out = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) out = fmaf(wgt[r * GMAX + g], x[r], out);
    store(out, og + i);
  }
  cluster.sync();  // partials stay readable until every CTA is done
}

// The operands every dispatch level passes on unchanged.
struct Args {
  const void *q, *kp, *vp, *ks, *vs;
  const int *bt, *lengths;
  void* o;
  float* lse;
  int B, H, KH, page, pps, splits;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, typename TS, int D, int GMAX>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = Paged<TKV, D>::template smem<GMAX>();
  static_assert(smem <= 232448, "a CTA's shared memory must fit an sm_90 SM");
  const int G = a.H / a.KH;
  const int n_hg = (G + GMAX - 1) / GMAX;
  if (a.splits < 1 || a.splits > kMaxSplit) return cudaErrorInvalidValue;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(paged_split_kernel<TQ, TKV, TS, D, GMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KH * n_hg, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, paged_split_kernel<TQ, TKV, TS, D, GMAX>,
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const TS*>(a.ks),
      static_cast<const TS*>(a.vs), a.bt, a.lengths, static_cast<TQ*>(a.o),
      a.lse, a.H, a.KH, a.page, a.pps, a.scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// CTAs of up to eight query heads. Full MHA at D = 80 (zamba2's shared
// attention, the one MHA model served) compiles with one head's registers;
// MHA at another head dim runs the eight-head CTA with one head live.
template <typename TQ, typename TKV, typename TS, int D>
cudaError_t launch_g(const Args& a) {
  if constexpr (D == 80) {
    if (a.H == a.KH) return launch<TQ, TKV, TS, D, 1>(a);
  }
  return launch<TQ, TKV, TS, D, 8>(a);
}

template <typename TQ, typename TKV, typename TS>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 32: return launch_g<TQ, TKV, TS, 32>(a);
    case 64: return launch_g<TQ, TKV, TS, 64>(a);
    case 80: return launch_g<TQ, TKV, TS, 80>(a);
    case 128: return launch_g<TQ, TKV, TS, 128>(a);
    case 256: return launch_g<TQ, TKV, TS, 256>(a);
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
// q (B,H,D) and o like q; lse (B,H) f32, or null for none; pages
// (P,page,KH,D); for int8 pages the scales (P,page,KH,1), else null;
// block_tables (B,pps) and lengths (B,) int32; all contiguous. splits: CTAs
// (one cluster) per (sequence, KV head), 1-8.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales,
                                   const void* block_tables,
                                   const void* lengths, void* o, void* lse,
                                   int B, int H, int KH, int D, int page, int pps,
                                   int splits, float scale, int q_dtype,
                                   int kv_dtype, int scale_dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || page <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(lengths), o, static_cast<float*>(lse),
               B, H, KH, page, pps,
               splits, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return (int)dispatch_kv<float>(a, D, kv_dtype, scale_dtype);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(a, D, kv_dtype, scale_dtype);
  return (int)cudaErrorInvalidValue;
}

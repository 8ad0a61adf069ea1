// Mamba-2 SSD chunk scan, backward, for Hopper (sm_90a): the gradient of
// what ssd_scan.cu computes, (dx, dlog_a, dB, dC) from dy, the gradient of
// the final state and the state entering each chunk (which the forward
// writes when asked).
//
// Replaces no TPU kernel: the reference differentiates its jnp
// src/repro/models/ssm.py::ssd_chunked with jax.grad (no Pallas backward);
// this is the hand-written counterpart of that gradient, held against
// kernels/ssd_scan.py::ssd_scan_backward_plain.
//
// Per (batch, head) and chunk k of Q = 64 steps, with cum the inclusive
// cumsum of log_a in the chunk, S the state entering it, dS the gradient of
// the state leaving it, L_ij = exp(cum_i - cum_j) for j <= i (else 0),
// M_ij = (C_i . B_j) L_ij, e_i = exp(cum_i), w_j = exp(cum_Q - cum_j):
//   dS_{k-1} = exp(cum_Q) dS_k + sum_i e_i dy_i C_i^T
//   dx_j = sum_i M_ij dy_i + w_j dS B_j
//   dC_i = sum_j (dy_i . x_j) L_ij B_j + e_i dy_i S
//   dB_j = sum_i (dy_i . x_j) L_ij C_i + w_j x_j dS
//   dlog_a_t = sum_{i >= t} dcum_i over the chunk, dcum gathering the
//   decays' gradients: (dy_i . x_j) M_ij on row i and minus it on column j,
//   e_i dy_i . (S C_i), w_j x_j . (dS B_j) minus on cum_j and plus on
//   cum_Q, and exp(cum_Q) <dS, S> on cum_Q.
//
// What bounds it on an H100. At zamba2's training shape (B 2, H 80, P = N
// = 64, L 2048, bf16 B/C) the function must read x, dy and the chunk
// states and write dx (84 MB each in f32), 0.10 ms at 3.35 TB/s. Its
// products, 8 of 64 x 64 x 64 a head and chunk (about 21 GFLOP), take 0.13
// ms at the TF32 tensor-core rate over three passes, 0.32 ms at the f32
// CUDA-core rate, which bound the first design (1.2 ms). This design runs
// them on mma.sync, whose m16n8k8 TF32 rate on an H100 is about a third of
// the card's TF32 peak (160 TFLOP/s measured, bf16 m16n8k16 twice that), so
// its split passes, about 38 GFLOP, set the chunk kernel's floor near 0.25
// ms.
//
// Three launches:
//   * dstate_kernel, one CTA of 4 warps per (batch, head, 32 rows of P,
//     64 columns of N): the reverse sweep over chunks, the only part that is
//     sequential. Its product a chunk, (e dy)^T . C, runs on mma.sync, each
//     warp holding a 16 x 32 slice of dS in its accumulators; the next two
//     chunks' dy and C are copied with cp.async while this one computes. It
//     writes the dS leaving every chunk (B, H, nck, P, N) f32.
//   * chunk_tc_kernel (P and N up to 64, zamba2's 64 and 64 among them):
//     one CTA per (batch, chunk, group of heads), 4 warps, each owning 16
//     rows of the chunk. B and C are read once a CTA; for each head of the
//     group in turn the CTA copies x, dy, S and dS, and every product of
//     the gradient runs on the tensor cores:
//                                   passes: bf16 B/C   f32 B/C
//       C . B^T, B . C^T  (M, M^T)             1          3
//       dy . x^T  (dm)                         3          3
//       dy . S, x . dS                         3          3
//       B . dS^T                               2          3
//       M^T . dy                               3          3
//       dCB . B, dCB^T . C                     2          3
//     (3xTF32: an f32 operand is split into a TF32 high part and the TF32
//     rounding of the rest, and lo.hi + hi.lo + hi.hi summed in f32; a bf16
//     operand is exact in TF32 and is not split; one pass a product misses
//     the 2e-5 limit on dx and dlog_a: tests/test_torch_ssd_bwd_precision.py
//     holds this plan on the CPU.) Phase A, a warp over its rows i, forms
//     dm and M = (C . B^T) o L and from them dC and the decays' gradients;
//     phase B, over rows j, dx and dB. The two products that need a
//     transposed accumulator get it two ways: M^T is recomputed as (B .
//     C^T) o L^T, one exact bf16 pass; dCB^T, whose recomputation would
//     cost three passes of x . dy^T, is read from the f32 dCB that phase A
//     stages in shared memory. A warp reads the dCB rows of the warps below
//     it, so each warp arrives on a named barrier of its row block once its
//     rows are in, and a warp waits only for the blocks it reads, after the
//     work that needs none of them: phase A's cost grows with the row
//     block and phase B's falls, and a barrier between the phases would
//     wait for the slowest warp of each. Accumulators feed
//     the next product as A fragments directly (columns 2t, 2t + 1 of an
//     accumulator tile are the A fragment's k = t, t + 4, and the B
//     operand's rows are read in that order), and causal tiles (M, dm's
//     use and dCB are zero for j > i) are skipped. dB and dC are summed
//     over the group's heads in registers, in head order, and leave the
//     CTA as one f32 partial per group: at zamba2's training shape 20 heads
//     a CTA (kernels/ssd_scan.py::bwd_group), 256 CTAs, 8.4 MB of partials
//     where the first design wrote 168 MB of per-head ones. 108 KB of shared
//     memory and 240 registers a thread (bf16 B/C): two CTAs an SM.
//     mma.sync and not wgmma for the forward's reason: every split operand
//     would have to be
//     staged in shared memory twice more, transposed, for 16-row tiles;
//     mma.sync takes both operands from registers, where the split is three
//     operations.
//   * chunk_simt_kernel (P or N above 64, a shape no model of the repo
//     has): the first design's CUDA-core kernel, one CTA per (batch, head,
//     chunk), f32 products on 4 x 4 register blocks, dB and dC as per-head
//     partials; counted apart (ssd_scan_backward.launches_simt).
//   * sum_groups_kernel: dB and dC, the partials summed over groups (or
//     heads) in order and rounded once to B's dtype. No float atomics
//     anywhere: two launches give the same bits.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launches (0 on success).

#include "common.cuh"
#include "hopper.cuh"
#include "mma_split.cuh"

#include <algorithm>
#include <type_traits>

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_acc;
using repro::mma_bf16;
using repro::Operand;
using repro::to_f32;

constexpr int kQ = 64;  // steps per chunk (the forward's)
constexpr int kMaxN = 256;
constexpr int kTcMax = 64;  // P and N the tensor-core chunk kernel takes
constexpr size_t kMaxSmem = 232448;

__host__ __device__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
__device__ __forceinline__ T zero() {
  T z;
  repro::store(0.f, &z);
  return z;
}

// Inclusive cumsum over one warp of a chunk's log_a, two steps a lane
// (la0, la1 at steps 2 lane and 2 lane + 1): cum at those two steps.
__device__ __forceinline__ float2 warp_cumsum(float la0, float la1) {
  const int lane = threadIdx.x & 31;
  float s = la0 + la1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
  return make_float2(before + la0, before + la0 + la1);
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `count` threads: a
// producer arrives without waiting, a consumer waits for them all.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows x cols of a row-major matrix (row stride ld elements) into an R x C
// tile whose element (r, c) lies at off(r, c), zero past rows and cols;
// whole 16-byte pieces by cp.async where vec (the source's rows 16-byte
// aligned; the caller commits and waits), the rest element by element.
// off must keep a 16-byte piece contiguous.
template <int R, int C, typename T, typename Off>
__device__ __forceinline__ void load_tile(T* dst, Off off, const T* src, int rows, int cols,
                                          int ld, bool vec) {
  constexpr int v = 16 / sizeof(T), per = C / v;
  for (int i = threadIdx.x; i < R * per; i += blockDim.x) {
    const int r = i / per, c = (i % per) * v;
    if (vec && r < rows && c + v <= cols) {
      cp_async16(dst + off(r, c), src + (size_t)r * ld + c);
    } else {
#pragma unroll
      for (int u = 0; u < v; ++u)
        dst[off(r, c + u)] =
            (r < rows && c + u < cols) ? src[(size_t)r * ld + c + u] : zero<T>();
    }
  }
}

// Two consecutive B/C elements (an even column) as one register of a bf16
// pair, for m16n8k16.
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// Two consecutive elements widened to f32.
__device__ __forceinline__ float2 two(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 two(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- the reverse dS sweep --------------------------------------------------

constexpr int kSweepWarps = 4;               // 2 x 16 rows of P by 2 x 32 columns of N
constexpr int kSweepStages = 3;               // chunks in flight: this one and two ahead
constexpr int kSweepRows = 32;                // rows of P a sweep CTA takes
constexpr int kSweepCols = 64;                // columns of N a sweep CTA takes
constexpr int kSweepTiles = kSweepCols / 16;  // accumulator tiles a warp holds
constexpr int kSweepLdY = kSweepRows + 8;     // dy tile row stride: A loads on 32 banks
constexpr int kSweepLdC = kSweepCols + 8;     // C tile row stride (bf16 and f32)

template <typename TBC>
__host__ __device__ constexpr size_t sweep_buffer() {
  return (size_t)kQ * kSweepLdY * sizeof(float) + (size_t)kQ * kSweepLdC * sizeof(TBC);
}
template <typename TBC>
__host__ __device__ constexpr size_t sweep_smem() {
  return kSweepStages * sweep_buffer<TBC>() + kSweepWarps * kQ * sizeof(float);
}

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k = t, n = g), (t + 4, g); the
// accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
//
// A warp holds rows p0 + 16 warp + g (+ 8) of dS and its 64 columns of N
// from n0 (8 accumulator tiles); a chunk adds (e dy)^T . C: A = (e dy)^T,
// rows p and k the chunk's steps, B = C, k the steps and n the columns.
// ds[b, h, k] is the gradient of the state leaving chunk k.
template <typename TBC>
__global__ void __launch_bounds__(32 * kSweepWarps)
    dstate_kernel(const float* __restrict__ log_a, const TBC* __restrict__ cm,
                  const float* __restrict__ dy, const float* __restrict__ ds_final,
                  float* __restrict__ ds, int H, int L, int P, int N) {
  constexpr bool kExact = sizeof(TBC) == 2;
  constexpr size_t kDyBytes = (size_t)kQ * kSweepLdY * sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  auto dy_buf = [&](int k) { return reinterpret_cast<float*>(smem + k * sweep_buffer<TBC>()); };
  auto c_buf = [&](int k) {
    return reinterpret_cast<TBC*>(smem + k * sweep_buffer<TBC>() + kDyBytes);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* ew = reinterpret_cast<float*>(smem + kSweepStages * sweep_buffer<TBC>()) + warp * kQ;

  const int nnt = (N + kSweepCols - 1) / kSweepCols;
  const int p0 = (blockIdx.x / nnt) * kSweepRows, n0 = (blockIdx.x % nnt) * kSweepCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int nck = (L + kQ - 1) / kQ;
  const int rows = min(kSweepRows, P - p0), cols = min(kSweepCols, N - n0);
  const bool vec_dy = aligned16(dy);  // P % 4 == 0: every row 16-byte aligned
  const bool vec_c = aligned16(cm) && (N * sizeof(TBC)) % 16 == 0;
  const float* lg = log_a + bh * L;
  const int pr = 16 * (warp & 1) + g;  // this thread's rows of the tile: pr, pr + 8
  const int nw = (warp >> 1) * (kSweepCols / 2);  // and its warp's first column

  // Chunk c's dy and C into slot k, when there is such a chunk; one commit
  // group either way, so that a chunk's group is always the kSweepStages -
  // 1'th newest when it is waited for.
  auto load = [&](int c, int k) {
    if (c >= 0) {
      const int t0 = c * kQ, qlen = min(kQ, L - t0);
      load_tile<kQ, kSweepRows>(dy_buf(k), [](int r, int col) { return r * kSweepLdY + col; },
                                dy + (bh * L + t0) * P + p0, qlen, rows, P, vec_dy);
      load_tile<kQ, kSweepCols>(c_buf(k), [](int r, int col) { return r * kSweepLdC + col; },
                        cm + ((size_t)b * L + t0) * N + n0, qlen, cols, N, vec_c);
    }
    cp_async_commit();
  };
  float la0 = 0.f, la1 = 0.f;  // the log_a of the chunk to compute next
  auto read_la = [&](int c) {
    const int s0 = c * kQ + 2 * lane;
    la0 = s0 < L ? lg[s0] : 0.f;
    la1 = s0 + 1 < L ? lg[s0 + 1] : 0.f;
  };

  float acc[kSweepTiles][4];
#pragma unroll
  for (int nt = 0; nt < kSweepTiles; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + pr + 8 * r, n = n0 + nw + 8 * nt + 2 * t;  // n even, N % 4 == 0
      const float2 v = (ds_final && p < P && n < N) ? two(ds_final + (bh * P + p) * N + n)
                                                    : make_float2(0.f, 0.f);
      acc[nt][2 * r] = v.x;
      acc[nt][2 * r + 1] = v.y;
    }
  for (int k = 0; k < kSweepStages - 1; ++k) load(nck - 1 - k, k);
  read_la(nck - 1);
  for (int c = nck - 1, k = 0; c >= 0; --c, k = (k + 1) % kSweepStages) {
    float* dsg = ds + (bh * nck + c) * P * N;
#pragma unroll
    for (int nt = 0; nt < kSweepTiles; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + pr + 8 * r, n = n0 + nw + 8 * nt + 2 * t;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(dsg + (size_t)p * N + n) =
              make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    // chunk c's decays in this warp's own row of e, while its copies land
    const float2 cu = warp_cumsum(la0, la1);
    ew[2 * lane] = expf(cu.x);
    ew[2 * lane + 1] = expf(cu.y);
    const float decay = __shfl_sync(0xffffffffu, ew[2 * lane + 1], 31);
    __syncwarp();
    if (c > 0) read_la(c - 1);
    cp_async_wait<kSweepStages - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c + 1's slot
    load(c - (kSweepStages - 1), (k + kSweepStages - 1) % kSweepStages);
#pragma unroll
    for (int nt = 0; nt < kSweepTiles; ++nt)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[nt][m] *= decay;
    const float* Y = dy_buf(k);
    const TBC* Cs = c_buf(k);
#pragma unroll 2
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const int i0 = 8 * ks + t;
      const float e0 = ew[i0], e1 = ew[i0 + 4];
      const float av[4] = {Y[i0 * kSweepLdY + pr] * e0, Y[i0 * kSweepLdY + pr + 8] * e0,
                           Y[(i0 + 4) * kSweepLdY + pr] * e1,
                           Y[(i0 + 4) * kSweepLdY + pr + 8] * e1};
      const Operand<4, false> a(av);
      Operand<2, kExact> bo[kSweepTiles];
#pragma unroll
      for (int nt = 0; nt < kSweepTiles; ++nt) {
        const float bv[2] = {to_f32(Cs[i0 * kSweepLdC + nw + 8 * nt + g]),
                             to_f32(Cs[(i0 + 4) * kSweepLdC + nw + 8 * nt + g])};
        bo[nt] = Operand<2, kExact>(bv);
      }
      mma_acc(acc, a, bo);
    }
  }
}

// ---- the chunk kernel on the tensor cores ----------------------------------

constexpr int kWarps = 4;  // 16 rows of the chunk each
constexpr int kThreads = 32 * kWarps;
constexpr int kLdX = 68;  // x and dy row stride (f32): fragment loads on 32 banks
constexpr int kLdS = 72;  // S row stride (f32)
template <typename TBC>
__host__ __device__ constexpr int ld_bc() {
  return sizeof(TBC) == 4 ? 68 : 72;
}
// dS, 64 x 64 f32 without padding, its columns permuted within a row so
// that both orientations it is read in ((p, n) = (8 tile + g, k + t) and
// (k + t, 8 tile + g)) hit 32 banks; 16-byte pieces stay whole.
__device__ __forceinline__ int ds_off(int r, int c) {
  return r * 64 + (c ^ (((r & 3) << 3) | (r & 4)));
}

template <typename TBC>
struct TcLayout {
  static constexpr size_t bc = (size_t)kQ * ld_bc<TBC>() * sizeof(TBC);
  static constexpr size_t xt = (size_t)kQ * kLdX * sizeof(float);
  static constexpr size_t st = (size_t)kQ * kLdS * sizeof(float);
  static constexpr size_t dst = (size_t)kQ * 64 * sizeof(float);
  // B, C, x, dy, S, dS, dCB (x's stride), then f32 rows of 64: cum, e, w,
  // the row sums, the cross terms, dw, each warp's column sums (4), and each
  // warp's <dS, S>
  static constexpr size_t small = 2 * bc + 3 * xt + st + dst;
  static constexpr size_t total = small + (10 * kQ + kWarps) * sizeof(float);
};

// One (batch, chunk) and the heads h0 .. h1 - 1 of a group. Phase A, warp w
// over rows i = 16 w ..: dm = dy . x^T and dy . S; the cross-chunk read's
// gradient e_i dy S into dC and e_i C_i . (dy_i S) into dcum; M = (C . B^T)
// o L and dCB = dm o L a tile of 8 columns at a time, the row and column
// sums of dm o M, dCB into shared memory, and dC += dCB . B. Phase B, over
// rows j = 16 w ..: x . dS into dB (times w_j) and w_j B_j . (x_j dS); dx =
// w_j B . dS^T + M^T . dy and dB += dCB^T . C, with M^T = (B . C^T) o L^T a
// tile of 8 columns at a time and dCB^T read from shared memory. Then one
// warp gathers dcum and writes dlog_a as its reverse cumsum.
template <typename TBC>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_tc_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                    const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                    const float* __restrict__ dy, const float* __restrict__ states,
                    const float* __restrict__ ds, float* __restrict__ dx,
                    float* __restrict__ dla, float* __restrict__ db_parts,
                    float* __restrict__ dc_parts, int H, int L, int P, int N, int group) {
  using Lay = TcLayout<TBC>;
  constexpr bool kExact = sizeof(TBC) == 2;
  constexpr int LBC = ld_bc<TBC>();
  extern __shared__ __align__(16) unsigned char smem[];
  TBC* sC = reinterpret_cast<TBC*>(smem);
  TBC* sB = reinterpret_cast<TBC*>(smem + Lay::bc);
  float* sX = reinterpret_cast<float*>(smem + 2 * Lay::bc);
  float* sDY = reinterpret_cast<float*>(smem + 2 * Lay::bc + Lay::xt);
  float* sS = reinterpret_cast<float*>(smem + 2 * Lay::bc + 2 * Lay::xt);
  float* sDS = reinterpret_cast<float*>(smem + 2 * Lay::bc + 2 * Lay::xt + Lay::st);
  float* sG = reinterpret_cast<float*>(smem + 2 * Lay::bc + 2 * Lay::xt + Lay::st + Lay::dst);
  float* cum = reinterpret_cast<float*>(smem + Lay::small);
  float* ecum = cum + kQ;
  float* wq = ecum + kQ;
  float* rsum = wq + kQ;
  float* cross = rsum + kQ;
  float* dwv = cross + kQ;
  float* colp = dwv + kQ;        // [kWarps][64]
  float* sdot = colp + kWarps * kQ;  // [kWarps]

  const int c = blockIdx.x, gi = blockIdx.y, b = blockIdx.z;
  const int nck = gridDim.x, ngroups = gridDim.y;
  const int t0 = c * kQ, qlen = min(kQ, L - t0);
  const int h0 = gi * group, h1 = min(H, h0 + group);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows (i in A, j in B)
  const bool vec_x = aligned16(x) && aligned16(dy);  // P % 4 == 0
  const bool vec_s = aligned16(states) && aligned16(ds);  // N % 4 == 0
  const bool vec_bc = aligned16(bm) && aligned16(cm) && (N * sizeof(TBC)) % 16 == 0;
  auto xo = [](int r, int col) { return r * kLdX + col; };
  auto so = [](int r, int col) { return r * kLdS + col; };
  auto bo = [](int r, int col) { return r * LBC + col; };
  auto dso = [](int r, int col) { return ds_off(r, col); };

  auto load_head = [&](int h) {
    const size_t bh = (size_t)b * H + h;
    load_tile<kQ, 64>(sX, xo, x + (bh * L + t0) * P, qlen, P, P, vec_x);
    load_tile<kQ, 64>(sDY, xo, dy + (bh * L + t0) * P, qlen, P, P, vec_x);
    load_tile<kQ, 64>(sS, so, states + (bh * nck + c) * P * N, P, N, N, vec_s);
    load_tile<kQ, 64>(sDS, dso, ds + (bh * nck + c) * P * N, P, N, N, vec_s);
    cp_async_commit();
  };
  // One warp: cum, e and w of head h's chunk.
  auto decays = [&](int h) {
    const float* lg = log_a + ((size_t)b * H + h) * L + t0;
    const float la0 = 2 * lane < qlen ? lg[2 * lane] : 0.f;
    const float la1 = 2 * lane + 1 < qlen ? lg[2 * lane + 1] : 0.f;
    const float2 cu = warp_cumsum(la0, la1);
    const float last = __shfl_sync(0xffffffffu, cu.y, 31);
    cum[2 * lane] = cu.x;
    cum[2 * lane + 1] = cu.y;
    ecum[2 * lane] = expf(cu.x);
    ecum[2 * lane + 1] = expf(cu.y);
    wq[2 * lane] = expf(last - cu.x);
    wq[2 * lane + 1] = expf(last - cu.y);
  };
  // The causal decay of an accumulator tile's four elements: rows ra, rb,
  // columns ca, ca + 1, nonzero where the column's step is at most the
  // row's (or, transposed, at least). Returns 0 where masked.
  auto decay4 = [&](float (&l)[4], int ra, int rb, int ca, bool transposed) {
    const int rr[4] = {ra, ra, rb, rb}, cc[4] = {ca, ca + 1, ca, ca + 1};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const bool on = transposed ? cc[m] >= rr[m] : cc[m] <= rr[m];
      const float d = transposed ? cum[cc[m]] - cum[rr[m]] : cum[rr[m]] - cum[cc[m]];
      const float v = expf(on ? d : 0.f);
      l[m] = on ? v : 0.f;
    }
  };
  // (C . B^T) tile jt over this thread's rows r0 (+ 8) of `rows_of` and
  // columns 8 jt .. of `cols_of` (C . B^T: rows of C, columns of B; B . C^T
  // the other way).
  auto gram = [&](float (&d)[1][4], const TBC* rows_of, const TBC* cols_of, int jt) {
    const int ra = r0;
    if constexpr (kExact) {
      const __nv_bfloat16* A = reinterpret_cast<const __nv_bfloat16*>(rows_of);
      const __nv_bfloat16* Bt = reinterpret_cast<const __nv_bfloat16*>(cols_of);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k0 = 16 * q + 2 * t;
        const uint32_t a[4] = {pair(A + bo(ra, k0)), pair(A + bo(ra + 8, k0)),
                               pair(A + bo(ra, k0 + 8)), pair(A + bo(ra + 8, k0 + 8))};
        const uint32_t bb[2] = {pair(Bt + bo(8 * jt + g, k0)), pair(Bt + bo(8 * jt + g, k0 + 8))};
        mma_bf16(d[0], a, bb);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k0 = 8 * q + t;
        const float av[4] = {to_f32(rows_of[bo(ra, k0)]), to_f32(rows_of[bo(ra + 8, k0)]),
                             to_f32(rows_of[bo(ra, k0 + 4)]), to_f32(rows_of[bo(ra + 8, k0 + 4)])};
        const float bv[2] = {to_f32(cols_of[bo(8 * jt + g, k0)]),
                             to_f32(cols_of[bo(8 * jt + g, k0 + 4)])};
        const Operand<2, false> bb[1] = {Operand<2, false>(bv)};
        mma_acc(d, Operand<4, false>(av), bb);
      }
    }
  };
  // d[tile] += A . B[k0 .. k0 + 8) for an accumulator tile used as the A
  // fragment (columns 2t, 2t + 1 = k t, t + 4), B's rows k0 + 2t, k0 + 2t +
  // 1 and its 8 tiles of columns from a shared tile of T.
  auto acc_times = [&](float (&d)[8][4], const float (&v)[4], auto* Bsrc, auto off, int k0,
                       auto exact) {
    constexpr bool E = decltype(exact)::value;
    const float av[4] = {v[0], v[2], v[1], v[3]};
    const Operand<4, false> a(av);
    Operand<2, E> bb[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float bv[2] = {to_f32(Bsrc[off(k0 + 2 * t, 8 * nt + g)]),
                           to_f32(Bsrc[off(k0 + 2 * t + 1, 8 * nt + g)])};
      bb[nt] = Operand<2, E>(bv);
    }
    mma_acc(d, a, bb);
  };
  using ExactBC = std::integral_constant<bool, kExact>;
  using Split = std::integral_constant<bool, false>;

  load_tile<kQ, 64>(sC, bo, cm + ((size_t)b * L + t0) * N, qlen, N, N, vec_bc);
  load_tile<kQ, 64>(sB, bo, bm + ((size_t)b * L + t0) * N, qlen, N, N, vec_bc);
  load_head(h0);
  float dct[8][4] = {}, dbt[8][4] = {};  // dC over rows i, dB over rows j, summed over heads

  for (int h = h0; h < h1; ++h) {
    if (warp == kWarps - 1) decays(h);
    cp_async_wait<0>();
    __syncthreads();  // head h's tiles and decays
    const size_t bh = (size_t)b * H + h;

    // ---- phase A: rows i = r0, r1
    const int diag = 2 * warp + 2;  // column tiles at or left of the diagonal block
    {
      float dm[8][4] = {}, dys[8][4] = {};
#pragma unroll 1
      for (int ks = 0; ks < 8; ++ks) {
        const int k0 = 8 * ks + t;
        const float av[4] = {sDY[xo(r0, k0)], sDY[xo(r1, k0)], sDY[xo(r0, k0 + 4)],
                             sDY[xo(r1, k0 + 4)]};
        const Operand<4, false> a(av);
        {
          Operand<2, false> xb[8];
#pragma unroll
          for (int jt = 0; jt < 8; ++jt) {
            if (jt >= diag) continue;
            const float bv[2] = {sX[xo(8 * jt + g, k0)], sX[xo(8 * jt + g, k0 + 4)]};
            xb[jt] = Operand<2, false>(bv);
          }
          mma_acc(dm, a, xb, diag);
        }
        Operand<2, false> sb[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float bv[2] = {sS[so(k0, 8 * nt + g)], sS[so(k0 + 4, 8 * nt + g)]};
          sb[nt] = Operand<2, false>(bv);
        }
        mma_acc(dys, a, sb);
      }
      // the cross-chunk read: e_i dy_i S into dC, e_i C_i . (dy_i S) into dcum
      const float e0 = ecum[r0], e1 = ecum[r1];
      float cr0 = 0.f, cr1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 c0 = two(sC + bo(r0, 8 * nt + 2 * t)), c1 = two(sC + bo(r1, 8 * nt + 2 * t));
        cr0 = fmaf(c0.x, dys[nt][0], fmaf(c0.y, dys[nt][1], cr0));
        cr1 = fmaf(c1.x, dys[nt][2], fmaf(c1.y, dys[nt][3], cr1));
        dct[nt][0] = fmaf(e0, dys[nt][0], dct[nt][0]);
        dct[nt][1] = fmaf(e0, dys[nt][1], dct[nt][1]);
        dct[nt][2] = fmaf(e1, dys[nt][2], dct[nt][2]);
        dct[nt][3] = fmaf(e1, dys[nt][3], dct[nt][3]);
      }
      // M, dCB and dseg = dm o M a column tile at a time (none above the
      // diagonal block), and dC += dCB . B
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        float cs0 = 0.f, cs1 = 0.f;
        if (jt < diag) {
          float cb[1][4] = {};
          gram(cb, sC, sB, jt);
          float l[4];
          decay4(l, r0, r1, 8 * jt + 2 * t, false);
          float dcb[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float dseg = dm[jt][m] * (cb[0][m] * l[m]);
            dcb[m] = dm[jt][m] * l[m];
            if (m < 2)
              rs0 += dseg;
            else
              rs1 += dseg;
          }
          cs0 = dm[jt][0] * (cb[0][0] * l[0]) + dm[jt][2] * (cb[0][2] * l[2]);
          cs1 = dm[jt][1] * (cb[0][1] * l[1]) + dm[jt][3] * (cb[0][3] * l[3]);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
            cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
          }
          const int j0 = 8 * jt + 2 * t;
          *reinterpret_cast<float2*>(sG + xo(r0, j0)) = make_float2(dcb[0], dcb[1]);
          *reinterpret_cast<float2*>(sG + xo(r1, j0)) = make_float2(dcb[2], dcb[3]);
          acc_times(dct, dcb, sB, bo, 8 * jt, ExactBC{});
        }
        if (g == 0) {
          colp[warp * kQ + 8 * jt + 2 * t] = cs0;
          colp[warp * kQ + 8 * jt + 2 * t + 1] = cs1;
        }
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      cr0 = quad_sum(cr0);
      cr1 = quad_sum(cr1);
      if (t == 0) {
        rsum[r0] = rs0;
        rsum[r1] = rs1;
        cross[r0] = cr0;
        cross[r1] = cr1;
      }
    }
    // this warp's dCB rows are in: warps that read them (those above, in
    // phase B) wait on the barrier of this row block; the warp's own lanes
    // read them too, ordered by __syncwarp
    if (warp > 0) named_arrive(warp, 32 * (warp + 1));
    __syncwarp();

    // ---- phase B: rows j = r0, r1
    const float w0 = wq[r0], w1 = wq[r1];
    auto x_rows = [&](int k0) {  // x's rows j as an A fragment over k = p
      const float av[4] = {sX[xo(r0, k0)], sX[xo(r1, k0)], sX[xo(r0, k0 + 4)],
                           sX[xo(r1, k0 + 4)]};
      return Operand<4, false>(av);
    };
    {  // x . dS: w_j x_j dS into dB, w_j B_j . (x_j dS) into dcum
      float xds[8][4] = {};
#pragma unroll 1
      for (int ks = 0; ks < 8; ++ks) {
        const int k0 = 8 * ks + t;
        const Operand<4, false> a = x_rows(k0);
        Operand<2, false> sb[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float bv[2] = {sDS[ds_off(k0, 8 * nt + g)], sDS[ds_off(k0 + 4, 8 * nt + g)]};
          sb[nt] = Operand<2, false>(bv);
        }
        mma_acc(xds, a, sb);
      }
      float dw0 = 0.f, dw1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 b0 = two(sB + bo(r0, 8 * nt + 2 * t)), b1 = two(sB + bo(r1, 8 * nt + 2 * t));
        dw0 = fmaf(b0.x, xds[nt][0], fmaf(b0.y, xds[nt][1], dw0));
        dw1 = fmaf(b1.x, xds[nt][2], fmaf(b1.y, xds[nt][3], dw1));
        dbt[nt][0] = fmaf(w0, xds[nt][0], dbt[nt][0]);
        dbt[nt][1] = fmaf(w0, xds[nt][1], dbt[nt][1]);
        dbt[nt][2] = fmaf(w1, xds[nt][2], dbt[nt][2]);
        dbt[nt][3] = fmaf(w1, xds[nt][3], dbt[nt][3]);
      }
      dw0 = quad_sum(dw0);
      dw1 = quad_sum(dw1);
      if (t == 0) {
        dwv[r0] = dw0;
        dwv[r1] = dw1;
      }
    }
    {
      // dx = w_j B_j dS^T, over k = n
      float dxa[8][4] = {};
#pragma unroll 1
      for (int ks = 0; ks < 8; ++ks) {
        const int k0 = 8 * ks + t;
        const float av[4] = {to_f32(sB[bo(r0, k0)]), to_f32(sB[bo(r1, k0)]),
                             to_f32(sB[bo(r0, k0 + 4)]), to_f32(sB[bo(r1, k0 + 4)])};
        const Operand<4, kExact> a(av);
        Operand<2, false> sb[8];
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          const float bv[2] = {sDS[ds_off(8 * pt + g, k0)], sDS[ds_off(8 * pt + g, k0 + 4)]};
          sb[pt] = Operand<2, false>(bv);
        }
        mma_acc(dxa, a, sb);
      }
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        dxa[pt][0] *= w0;
        dxa[pt][1] *= w0;
        dxa[pt][2] *= w1;
        dxa[pt][3] *= w1;
      }
      const int first = 2 * warp;  // column tiles at or right of the diagonal block
      // M^T and dCB^T a column tile at a time: dx += M^T . dy, dB += dCB^T . C
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        if (it < first) continue;
        if (it % 2 == 0 && it / 2 > warp) named_sync(it / 2, 32 * (it / 2 + 1));
        float bc[1][4] = {};
        gram(bc, sB, sC, it);
        float l[4];
        decay4(l, r0, r1, 8 * it + 2 * t, true);
        const int i0 = 8 * it + 2 * t;
        const float mt[4] = {bc[0][0] * l[0], bc[0][1] * l[1], bc[0][2] * l[2], bc[0][3] * l[3]};
        const float dcbt[4] = {sG[xo(i0, r0)], sG[xo(i0 + 1, r0)], sG[xo(i0, r1)],
                               sG[xo(i0 + 1, r1)]};
        acc_times(dxa, mt, sDY, xo, 8 * it, Split{});
        acc_times(dbt, dcbt, sC, bo, 8 * it, ExactBC{});
      }
      float* dxg = dx + (bh * L + t0) * P;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int p = 8 * pt + 2 * t;  // even, and P % 4 == 0: p + 1 is live too
        if (p < P) {
          if (r0 < qlen)
            *reinterpret_cast<float2*>(dxg + (size_t)r0 * P + p) =
                make_float2(dxa[pt][0], dxa[pt][1]);
          if (r1 < qlen)
            *reinterpret_cast<float2*>(dxg + (size_t)r1 * P + p) =
                make_float2(dxa[pt][2], dxa[pt][3]);
        }
      }
    }
    {  // <dS, S>
      float sd = 0.f;
      for (int i = threadIdx.x; i < kQ * 64; i += kThreads)
        sd = fmaf(sS[so(i >> 6, i & 63)], sDS[ds_off(i >> 6, i & 63)], sd);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sd += __shfl_xor_sync(0xffffffffu, sd, o);
      if (lane == 0) sdot[warp] = sd;
    }
    __syncthreads();  // every read of head h's tiles is done; its sums are in
    if (h + 1 < h1) load_head(h + 1);
    if (warp == kWarps - 1) {  // dcum, then dlog_a as its reverse cumsum
      float d[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        float col = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) col += colp[v * kQ + i];
        d[u] = rsum[i] - col + ecum[i] * cross[i] - wq[i] * dwv[i];
      }
      float wd = wq[2 * lane] * dwv[2 * lane] + wq[2 * lane + 1] * dwv[2 * lane + 1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) wd += __shfl_xor_sync(0xffffffffu, wd, o);
      if (lane == 31) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) s += sdot[v];
        d[1] += wd + ecum[kQ - 1] * s;
      }
      float suffix = d[0] + d[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, suffix, o);
        if (lane + o < 32) suffix += v;
      }
      float after = __shfl_down_sync(0xffffffffu, suffix, 1);
      if (lane == 31) after = 0.f;
      float* dlg = dla + bh * L + t0;
      if (2 * lane + 1 < qlen) dlg[2 * lane + 1] = after + d[1];
      if (2 * lane < qlen) dlg[2 * lane] = after + d[1] + d[0];
    }
  }

  // dC (rows i) and dB (rows j) of this group
  const size_t part = (((size_t)b * ngroups + gi) * L + t0) * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + 2 * t;
    if (n >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (row >= qlen) continue;
      const size_t o = part + (size_t)row * N + n;
      *reinterpret_cast<float2*>(dc_parts + o) = make_float2(dct[nt][2 * r], dct[nt][2 * r + 1]);
      *reinterpret_cast<float2*>(db_parts + o) = make_float2(dbt[nt][2 * r], dbt[nt][2 * r + 1]);
    }
  }
}

// ---- dB and dC: the partials summed ------------------------------------------

// out[b, l, n] = sum over the parts[b, k, l, n], k in order, rounded once to
// TBC; four consecutive elements a thread (N % 4 == 0).
template <typename TBC>
__global__ void sum_groups_kernel(const float* __restrict__ db_parts,
                                  const float* __restrict__ dc_parts, TBC* __restrict__ db,
                                  TBC* __restrict__ dc, int B, int parts, int L, int N) {
  const size_t per = (size_t)L * N / 4, total = (size_t)B * per;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / per, e = 4 * (i % per);
    float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
#pragma unroll 4
    for (int k = 0; k < parts; ++k) {
      const size_t o = (b * parts + k) * L * N + e;
      const float4 vb = *reinterpret_cast<const float4*>(db_parts + o);
      const float4 vc = *reinterpret_cast<const float4*>(dc_parts + o);
      sb = make_float4(sb.x + vb.x, sb.y + vb.y, sb.z + vb.z, sb.w + vb.w);
      sc = make_float4(sc.x + vc.x, sc.y + vc.y, sc.z + vc.z, sc.w + vc.w);
    }
    const size_t o = b * L * N + e;
    const float vb[4] = {sb.x, sb.y, sb.z, sb.w}, vc[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      repro::store(vb[u], db + o + u);
      repro::store(vc[u], dc + o + u);
    }
  }
}

// ---- the chunk kernel on the CUDA cores (P or N above 64) -------------------

constexpr int kT = 64;                // tile width over P and N
constexpr int kSimtThreads = 256;     // 16 x 16 threads, a 4 x 4 block each

// Shared row stride (elements) of a [64][kT] tile of T: rows stay 16-byte
// aligned for cp.async and start 4 banks apart.
template <typename T>
__host__ __device__ constexpr int tile_ld() {
  return sizeof(T) == 4 ? kT + 4 : kT + 8;
}
template <typename T>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)kQ * tile_ld<T>() * sizeof(T);
}

// Four consecutive elements widened to f32 (8-byte aligned for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows x cols of a row-major matrix (row stride ld elements) into a
// [64][tile_ld<T>] tile of the same type, zero past them: cp.async copies
// where vec (cols == 64, rows 16-byte aligned; the caller commits and
// waits), element copies otherwise.
template <typename T>
__device__ void simt_load_tile(T* dst, const T* src, int rows, int cols, int ld, bool vec) {
  constexpr int LD = tile_ld<T>();
  if (vec) {
    constexpr int v = 16 / sizeof(T), per = kT / v;
    for (int i = threadIdx.x; i < kQ * per; i += kSimtThreads) {
      const int r = i / per, e = (i % per) * v;
      if (r < rows)
        cp_async16(dst + r * LD + e, src + (size_t)r * ld + e);
      else
        *reinterpret_cast<uint4*>(dst + r * LD + e) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kQ * kT; i += kSimtThreads) {
      const int r = i / kT, e = i % kT;
      dst[r * LD + e] = (r < rows && e < cols) ? src[(size_t)r * ld + e] : zero<T>();
    }
  }
}

// Waits for this thread's copies, then for every thread's.
__device__ __forceinline__ void land() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// acc[r][c] += sum_k A(4 ty + r, k) B(k, tx + 16 c), k < 64. A is stored
// [i][k] (AK) or [k][i]; B is stored [j][k] (BK) or [k][j]; each a tile of
// its type (tile_ld). Every layout but B's [k][j] reads four elements a
// load; that one reads the thread's four columns one by one (16
// consecutive elements a half-warp).
template <bool AK, bool BK, typename TA, typename TB>
__device__ __forceinline__ void mm(const TA* __restrict__ A, const TB* __restrict__ B,
                                   float (&acc)[4][4], int ty, int tx) {
  constexpr int LA = tile_ld<TA>(), LB = tile_ld<TB>();
#pragma unroll 1
  for (int k0 = 0; k0 < kQ; k0 += 4) {
    float a[4][4], b[4][4];  // a[r][kk], b[kk][c]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (AK) {
        const float4 v = load4(A + (4 * ty + u) * LA + k0);
        a[u][0] = v.x, a[u][1] = v.y, a[u][2] = v.z, a[u][3] = v.w;
      } else {
        const float4 v = load4(A + (k0 + u) * LA + 4 * ty);
        a[0][u] = v.x, a[1][u] = v.y, a[2][u] = v.z, a[3][u] = v.w;
      }
      if (BK) {
        const float4 v = load4(B + (tx + 16 * u) * LB + k0);
        b[0][u] = v.x, b[1][u] = v.y, b[2][u] = v.z, b[3][u] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) b[u][c] = to_f32(B[(k0 + u) * LB + tx + 16 * c]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r][kk], b[kk][c], acc[r][c]);
  }
}

// Sum over the 16 threads of a half-warp (one ty, every tx).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Everything but the reverse sweep, for one (batch, head, chunk): dx, dlog_a,
// and dB / dC as this head's partials.
template <typename TBC>
__global__ void __launch_bounds__(kSimtThreads, 2)
    chunk_simt_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                      const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                      const float* __restrict__ dy, const float* __restrict__ states,
                      const float* __restrict__ ds, float* __restrict__ dx,
                      float* __restrict__ dla, float* __restrict__ db_parts,
                      float* __restrict__ dc_parts, int H, int L, int P, int N) {
  constexpr int LF = tile_ld<float>(), LB = tile_ld<TBC>();
  extern __shared__ __align__(16) unsigned char smem[];
  TBC* sC = reinterpret_cast<TBC*>(smem);                     // C[i][n]: an N tile
  TBC* sB = reinterpret_cast<TBC*>(smem + tile_bytes<TBC>());  // B[j][n]: an N tile
  float* sDY = reinterpret_cast<float*>(smem + 2 * tile_bytes<TBC>());  // dy[i][p]: a P tile
  float* sX = sDY + kQ * LF;       // x[j][p]: a P tile
  float* sS = sX + kQ * LF;        // S[p][n]: a (P, N) tile of the entering state
  float* sDS = sS + kQ * LF;       // dS[p][n]: of the leaving state's gradient
  float* sMG = sDS + kQ * LF;      // M[i][j] for dx, then dCB[i][j] = (dy_i . x_j) L_ij
  float* cum = sMG + kQ * LF;      // [64] each
  float* ecum = cum + kQ;
  float* w = ecum + kQ;
  float* rowsum = w + kQ;
  float* colsum = rowsum + kQ;
  float* cross = colsum + kQ;
  float* dw = cross + kQ;
  float* red = dw + kQ;            // [16][64]: column partials; then 8 warp sums

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nck = gridDim.x;
  const int t0 = c * kQ, qlen = min(kQ, L - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t bh = (size_t)b * H + h;
  const float* xg = x + (bh * L + t0) * P;
  const float* dyg = dy + (bh * L + t0) * P;
  const TBC* bg = bm + ((size_t)b * L + t0) * N;
  const TBC* cg = cm + ((size_t)b * L + t0) * N;
  const float* sg = states + (bh * nck + c) * P * N;
  const float* dsg = ds + (bh * nck + c) * P * N;
  const int npt = (P + kT - 1) / kT, nnt = (N + kT - 1) / kT;
  const bool vec_p = P % 4 == 0 && aligned16(x) && aligned16(dy);
  const bool vec_n = (N * sizeof(TBC)) % 16 == 0 && aligned16(bm) && aligned16(cm);
  const bool vec_s = N % 4 == 0 && aligned16(states) && aligned16(ds);

  // The tile each buffer holds (-1: none), the same in every thread; a
  // phase asks for its tiles between a barrier and land(), which copies
  // what is missing.
  int tC = -1, tB = -1, tDY = -1, tX = -1, tS = -1, tDS = -1;
  auto need_bc = [&](int nt) {
    const int cols = min(kT, N - nt * kT);
    if (tC != nt) simt_load_tile(sC, cg + nt * kT, qlen, cols, N, vec_n && cols == kT), tC = nt;
    if (tB != nt) simt_load_tile(sB, bg + nt * kT, qlen, cols, N, vec_n && cols == kT), tB = nt;
  };
  auto need_dy = [&](int pt) {
    const int cols = min(kT, P - pt * kT);
    if (tDY != pt) simt_load_tile(sDY, dyg + pt * kT, qlen, cols, P, vec_p && cols == kT), tDY = pt;
  };
  auto need_x = [&](int pt) {
    const int cols = min(kT, P - pt * kT);
    if (tX != pt) simt_load_tile(sX, xg + pt * kT, qlen, cols, P, vec_p && cols == kT), tX = pt;
  };
  auto need_state = [&](float* dst, const float* src, int& tag, int pt, int nt) {
    const int rows = min(kT, P - pt * kT), cols = min(kT, N - nt * kT);
    if (tag != pt * nnt + nt)
      simt_load_tile(dst, src + (size_t)pt * kT * N + nt * kT, rows, cols, N, vec_s && cols == kT),
          tag = pt * nnt + nt;
  };

  // One batch of copies: the first tiles of every operand.
  need_bc(0);
  need_dy(0);
  need_x(0);
  need_state(sS, sg, tS, 0, 0);
  need_state(sDS, dsg, tDS, 0, 0);
  if (tid < 32) {
    const int lane = tid;
    const float la0 = 2 * lane < qlen ? log_a[bh * L + t0 + 2 * lane] : 0.f;
    const float la1 = 2 * lane + 1 < qlen ? log_a[bh * L + t0 + 2 * lane + 1] : 0.f;
    const float2 cu = warp_cumsum(la0, la1);
    cum[2 * lane] = cu.x;
    cum[2 * lane + 1] = cu.y;
  }
  land();
  if (tid < kQ) {
    ecum[tid] = expf(cum[tid]);
    w[tid] = expf(cum[kQ - 1] - cum[tid]);
  }

  // C.B^T and dy.x^T over this thread's 4 x 4 block of (i, j).
  float cb[4][4] = {}, dm[4][4] = {};
  for (int nt = 0; nt < nnt; ++nt) {
    if (nt > 0) {
      __syncthreads();
      need_bc(nt);
      land();
    }
    mm<true, true>(sC, sB, cb, ty, tx);
  }
  for (int pt = 0; pt < npt; ++pt) {
    if (pt > 0) {
      __syncthreads();
      need_dy(pt);
      need_x(pt);
      land();
    }
    mm<true, true>(sDY, sX, dm, ty, tx);
  }

  // M, dCB (kept in registers until dx is done) and the intra-chunk decay
  // gradient dseg = dm . M, summed by row (over the half-warp) and by
  // column (over ty, through shared memory).
  float g[4][4];
  {
    float rs[4] = {}, cs[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * ty + r, j = tx + 16 * u;
        const bool on = j <= i;
        const float l = expf(on ? cum[i] - cum[j] : 0.f);
        const float m = on ? cb[r][u] * l : 0.f;
        g[r][u] = on ? dm[r][u] * l : 0.f;
        sMG[i * LF + j] = m;
        rs[r] += dm[r][u] * m;
        cs[u] += dm[r][u] * m;
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = half_warp_sum(rs[r]);
      if (tx == 0) rowsum[4 * ty + r] = v;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) red[ty * kQ + tx + 16 * u] = cs[u];
    __syncthreads();
    if (tid < kQ) {
      float v = 0.f;
      for (int k = 0; k < 16; ++k) v += red[k * kQ + tid];
      colsum[tid] = v;
    }
  }

  // dx_j = w_j dS B_j + sum_i M_ij dy_i, a P tile at a time.
  for (int pt = 0; pt < npt; ++pt) {
    float acc[4][4] = {};
    for (int nt = 0; nt < nnt; ++nt) {
      __syncthreads();
      need_bc(nt);
      need_state(sDS, dsg, tDS, pt, nt);
      land();
      mm<true, true>(sB, sDS, acc, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] *= w[4 * ty + r];
    __syncthreads();
    need_dy(pt);
    land();
    mm<false, false>(sMG, sDY, acc, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * ty + r, p = pt * kT + tx + 16 * u;
        if (j < qlen && p < P) dx[(bh * L + t0 + j) * P + p] = acc[r][u];
      }
  }
  __syncthreads();  // every read of M is done
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) sMG[(4 * ty + r) * LF + tx + 16 * u] = g[r][u];

  // dC_i = exp(cum_i) dy_i S + sum_j dCB_ij B_j and dB_j = w_j x_j dS +
  // sum_i dCB_ij C_i, an N tile at a time; with them the cross-chunk read's
  // and the state update's decay gradients and <dS, S>.
  float crs[4] = {}, dws[4] = {}, sdot = 0.f;
  for (int nt = 0; nt < nnt; ++nt) {
    float dys[4][4] = {}, xds[4][4] = {};
    for (int pt = 0; pt < npt; ++pt) {
      __syncthreads();
      need_dy(pt);
      need_x(pt);
      need_state(sS, sg, tS, pt, nt);
      need_state(sDS, dsg, tDS, pt, nt);
      land();
      mm<true, false>(sDY, sS, dys, ty, tx);
      mm<true, false>(sX, sDS, xds, ty, tx);
      for (int e = tid; e < kT * kT; e += kSimtThreads) {
        const int o = (e / kT) * LF + e % kT;
        sdot = fmaf(sS[o], sDS[o], sdot);
      }
    }
    __syncthreads();
    need_bc(nt);
    land();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = (4 * ty + r) * LB + tx + 16 * u;
        crs[r] = fmaf(to_f32(sC[o]), dys[r][u], crs[r]);
        dws[r] = fmaf(to_f32(sB[o]), xds[r][u], dws[r]);
        dys[r][u] *= ecum[4 * ty + r];
        xds[r][u] *= w[4 * ty + r];
      }
    mm<true, false>(sMG, sB, dys, ty, tx);
    mm<false, false>(sMG, sC, xds, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * ty + r, n = nt * kT + tx + 16 * u;
        if (i < qlen && n < N) {
          dc_parts[(bh * L + t0 + i) * N + n] = dys[r][u];
          db_parts[(bh * L + t0 + i) * N + n] = xds[r][u];
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = half_warp_sum(crs[r]), d = half_warp_sum(dws[r]);
    if (tx == 0) cross[4 * ty + r] = a, dw[4 * ty + r] = d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sdot += __shfl_xor_sync(0xffffffffu, sdot, o);
  if ((tid & 31) == 0) red[kQ * 16 + (tid >> 5)] = sdot;
  __syncthreads();

  // dcum, then dlog_a as its reverse cumsum over the chunk.
  float* dcum = rowsum;
  if (tid < kQ) {
    float v = rowsum[tid] - colsum[tid] + ecum[tid] * cross[tid] - w[tid] * dw[tid];
    if (tid == kQ - 1) {
      float s = 0.f;
      for (int k = 0; k < kSimtThreads / 32; ++k) s += red[kQ * 16 + k];
      v += ecum[kQ - 1] * s;
      for (int j = 0; j < kQ; ++j) v += w[j] * dw[j];
    }
    dcum[tid] = v;  // rowsum[tid] is read above by this thread only
  }
  __syncthreads();
  if (tid < qlen) {
    float v = 0.f;
    for (int k = kQ - 1; k >= tid; --k) v += dcum[k];
    dla[bh * L + t0 + tid] = v;
  }
}

template <typename TBC>
size_t simt_smem() {
  return 2 * tile_bytes<TBC>() + 5 * tile_bytes<float>() +
         (7 * kQ + 16 * kQ + kSimtThreads / 32) * sizeof(float);
}

// Sets each kernel's shared-memory limit once a device.
template <typename TBC>
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  for (const void* k : {(const void*)dstate_kernel<TBC>, (const void*)chunk_tc_kernel<TBC>,
                        (const void*)chunk_simt_kernel<TBC>}) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  if (dev >= 0 && dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <typename TBC>
cudaError_t launch(const float* x, const float* log_a, const void* b, const void* c,
                   const float* dy, const float* ds_final, const float* states, float* ds,
                   float* dx, float* dla, float* db_parts, float* dc_parts, void* db, void* dc,
                   int B, int H, int L, int P, int N, int variant, int group,
                   cudaStream_t stream) {
  const size_t c_smem = variant == 0 ? TcLayout<TBC>::total : simt_smem<TBC>();
  if (sweep_smem<TBC>() > kMaxSmem || c_smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = prepare<TBC>();
  if (err != cudaSuccess) return err;
  const int nck = (L + kQ - 1) / kQ;
  const TBC* bm = static_cast<const TBC*>(b);
  const TBC* cm = static_cast<const TBC*>(c);
  const dim3 s_grid(((P + kSweepRows - 1) / kSweepRows) * ((N + kSweepCols - 1) / kSweepCols), H,
                    B);
  dstate_kernel<TBC><<<s_grid, 32 * kSweepWarps, sweep_smem<TBC>(), stream>>>(
      log_a, cm, dy, ds_final, ds, H, L, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int parts = (H + group - 1) / group;
  if (variant == 0)
    chunk_tc_kernel<TBC><<<dim3(nck, parts, B), kThreads, c_smem, stream>>>(
        x, log_a, bm, cm, dy, states, ds, dx, dla, db_parts, dc_parts, H, L, P, N, group);
  else
    chunk_simt_kernel<TBC><<<dim3(nck, H, B), kSimtThreads, c_smem, stream>>>(
        x, log_a, bm, cm, dy, states, ds, dx, dla, db_parts, dc_parts, H, L, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t quads = (size_t)B * L * N / 4;
  const int blocks = (int)std::min<size_t>((quads + 63) / 64, 16384);
  sum_groups_kernel<TBC><<<blocks, 64, 0, stream>>>(db_parts, dc_parts, static_cast<TBC*>(db),
                                                    static_cast<TBC*>(dc), B, parts, L, N);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (B and C, and dB and dC). x, dy, dx
// (B,H,L,P) f32; log_a, dla (B,H,L) f32; b, c, db, dc (B,L,N); ds_final
// (B,H,P,N) f32 or null (zero); states and ds (scratch)
// (B,H,ceil(L/64),P,N) f32; db_parts, dc_parts (scratch) (B,ceil(H/group),
// L,N) f32; all contiguous, P and N multiples of 4, N up to 256. variant 0
// (P and N up to 64) runs chunk_tc_kernel on groups of `group` heads,
// variant 1 chunk_simt_kernel, whose partials are per head (group 1).
extern "C" int ssd_scan_bwd(const void* x, const void* log_a, const void* b, const void* c,
                            const void* dy, const void* ds_final, const void* states,
                            void* ds, void* dx, void* dla, void* db_parts, void* dc_parts,
                            void* db, void* dc, int B, int H, int L, int P, int N,
                            int bc_dtype, int variant, int group, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || P % 4 || N % 4 || N > kMaxN ||
      B > 65535 || H > 65535 || group <= 0 || (variant == 0 && (P > kTcMax || N > kTcMax)) ||
      (variant == 1 && group != 1) || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (bc_dtype == 0)
    return (int)launch<float>(f(x), f(log_a), b, c, f(dy), f(ds_final), f(states), o(ds),
                              o(dx), o(dla), o(db_parts), o(dc_parts), db, dc, B, H, L, P, N,
                              variant, group, s);
  if (bc_dtype == 1)
    return (int)launch<__nv_bfloat16>(f(x), f(log_a), b, c, f(dy), f(ds_final), f(states),
                                      o(ds), o(dx), o(dla), o(db_parts), o(dc_parts), db, dc,
                                      B, H, L, P, N, variant, group, s);
  return (int)cudaErrorInvalidValue;
}

// Mamba-2 SSD chunk scan for Hopper (sm_90a): per (batch, head), the chunks
// in order, carrying a (P, N) f32 state; inside a chunk the quadratic dual
// form, on the tensor cores.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _ssd_kernel), the TPU kernel behind the reference's ops.ssd_scan; the
// reference model runs its jnp twin models/ssm.py::ssd_chunked at prefill.
//
// Inputs are pre-projected by the wrapper, as for the TPU kernel: x is
// dt * x (f32 in the model, folded in f32 as ssd_chunked folds it),
// log_a = A * dt per step, B and C single-group. For one chunk of Q steps
// with inclusive cumsum cum of log_a and carried state S (P, N):
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) x_j + exp(cum_i) C_i . S
//   S  <- exp(cum_last) S + sum_j exp(cum_last - cum_j) x_j B_j^T
//
// What bounds it on an H100: bytes, once the products run on the tensor
// cores. The fewest FLOPs the function needs (the chunked form at its
// cheapest chunk length, chip_smoke.py's ssd_min_flops) are 368 MFLOP at
// zamba2's prefill shape (B = 1, H = 80 SSM heads, P = N = 64, L = 256):
// 2.2 us at the TF32 rate this design gets with three passes (495 / 3
// TFLOP/s), against 11.9 MB of x and y in f32, log_a, B, C and the state,
// 3.6 us at 3.35 TB/s. On the CUDA cores in f32 (67 TFLOP/s) the same
// FLOPs took 5.5 us, which bound the first version of this kernel.
//
// What this design does about it:
//   * The three products of a chunk (C.B^T; the masked scores times x with
//     the C.S^T read; the state update (x w)^T . B) run on the tensor cores
//     as mma.sync with f32 accumulation: m16n8k8 TF32, and C.B^T of bf16 B
//     and C as m16n8k16 bf16 (exact, two values a register). Each warp owns
//     16 of the chunk's 64 rows: its C.B^T accumulators are decayed and
//     masked in registers and feed the scores-times-x product as its A
//     operand directly (the accumulator's columns 2t, 2t + 1 become the A
//     fragment's k = t, t + 4, and x's rows are read in the same order),
//     so the scores never touch shared memory. mma.sync and not wgmma:
//     every f32 operand is split into a TF32 high and low part, and wgmma
//     takes B only from shared memory (K-major for TF32), so each split B
//     operand (x, S) would be staged twice more, transposed, behind more
//     barriers, for 64 x 16 tiles; mma.sync takes both operands from
//     registers, where the split is three integer and float operations.
//   * f32 accuracy: one TF32 pass rounds each operand to 2^-11 relative,
//     which misses the 1e-4 + 1e-4 |y| tolerance at zamba2's widths. An f32
//     operand is split into hi = rna_tf32(v) and lo = rna_tf32(v - hi), and
//     a product sums lo.hi + hi.lo (in a second accumulator) + hi.hi
//     ("3xTF32"; lo.lo, ~2^-22, is dropped). A bf16 operand is exact in
//     TF32 and is not split. Passes per product:
//                          bf16 B and C   f32 B and C
//       C . B^T                 1              3
//       scores . x              3 (x f32; 2 for bf16 x)
//       C . S^T                 2              3
//       (x w)^T . B             2              3
//     (tests/test_torch_ssd_precision.py holds this plan on the CPU.) At
//     N = 64 the state is stored with its TF32 parts, split once where it
//     is written rather than by every warp that reads it.
//   * More CTAs than heads: the columns of y and the rows of the state
//     split along P with no dependence between the parts, so a CTA takes
//     kPT = 16 of P's columns (320 CTAs at zamba2's prefill, 2-3 an SM)
//     and recomputes the chunk's C.B^T and decays, which cost little on the
//     tensor cores. The state (kPT x N) lives in shared memory, double
//     buffered: a chunk reads one copy and writes the other.
//   * Overlap: the next chunk's x, B and C tiles are fetched with 16-byte
//     cp.async into a second buffer while the current chunk computes, and
//     its log_a into registers; one barrier a chunk. Where two buffers do
//     not fit (N in the hundreds) the kernel runs one, loading after a
//     barrier; where a tensor's rows are not 16-byte aligned it copies
//     element-wise.
//   * Any L, P and N that are multiples of 4: steps past L load x = 0,
//     log_a = 0 and B = C = 0, N is padded to a multiple of 8 and P to the
//     CTA's tile with zeros in shared memory, which leaves every product
//     exact.
// What still bounds it: each chunk is a chain of dependent phases in every
// warp (copy, barrier, cumsum, C.B^T, decay, scores times x, state), and a
// CTA's time hardly changes with its share of the work: 32 columns a CTA
// (160 CTAs), a producer warp's bulk copies, TMA boxes into swizzled
// tiles, and scores and state warps in separate roles all ran as fast or
// slower on an H100 (PERF.md).
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include "common.cuh"
#include "hopper.cuh"
#include "mma_split.cuh"

namespace {

using repro::add_small;
using repro::mma_bf16;
using repro::mma_row;
using repro::mma_tf32;
using repro::Operand;
using repro::tf32_bits;
using repro::tf32_low_bits;
using repro::to_f32;

constexpr int kQ = 64;  // steps per chunk: 4 warps x 16 rows
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPT = 16;  // columns of P a CTA takes
constexpr size_t kMaxSmem = 232448;

// Shared-memory layout of one CTA, for nbuf buffers of the chunk tiles and
// the state. Tile rows carry 16 bytes of padding, so the fragment loads
// below hit 32 distinct banks (or share a word) across a warp. With NP (N
// known at compile time) the state is kept with its TF32 parts; otherwise
// (any N, up to the hundreds) as f32 alone, split where it is read.
template <typename TX, typename TBC, int NP>
struct Layout {
  int np;               // N padded to a multiple of 8 (the mma's k and n)
  int xs, bs, ss;       // row strides (elements) of x, B/C and the state
  size_t x, bc, s;      // bytes of one buffer of each
  __host__ __device__ explicit Layout(int N)
      : np((N + 7) & ~7),
        xs(kPT + 16 / (int)sizeof(TX)),
        bs(np + 16 / (int)sizeof(TBC)),
        ss(np + 4),
        x((size_t)kQ * xs * sizeof(TX)),
        bc((size_t)kQ * bs * sizeof(TBC)),
        s((size_t)(NP ? 3 : 1) * kPT * ss * sizeof(float)) {}
  __host__ __device__ size_t buffer() const { return x + 2 * bc + s; }
  // nbuf buffers, then each warp's cumsum and exp(cum_last - cum) rows
  __host__ __device__ size_t total(int nbuf) const {
    return nbuf * buffer() + (size_t)kWarps * 2 * kQ * sizeof(float);
  }
  // element offsets of (r, c) in the x and the B/C tiles
  __device__ __forceinline__ int xo(int r, int c) const { return r * xs + c; }
  __device__ __forceinline__ int bo(int r, int c) const { return r * bs + c; }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k = t, n = g), (t + 4, g); the
// accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// NP, where nonzero, is N padded to 8 as a compile-time constant (the
// model's N = 64), so loops over N unroll and offsets fold.
template <typename TX, typename TBC, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ log_a,
                    const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                    TX* __restrict__ y, float* __restrict__ s_out,
                    float* __restrict__ s_chunks, int H, int L, int P, int N, int nbuf,
                    int vec_x, int vec_bc) {
  constexpr bool kExactX = sizeof(TX) == 2;
  constexpr bool kExactBC = sizeof(TBC) == 2;
  constexpr int kPT8 = kPT / 8;  // 8-column tiles of y a warp holds
  constexpr int kMT = kPT / 16;  // 16-row tiles of the state a CTA holds
  const Layout<TX, TBC, NP> lay(NP ? NP : N);
  extern __shared__ __align__(16) unsigned char smem[];

  const int splits = (P + kPT - 1) / kPT;
  const int h = blockIdx.x / splits;
  const int p_off = (blockIdx.x % splits) * kPT;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pw = min(kPT, P - p_off);  // this CTA's live columns of P
  const int nchunks = (L + kQ - 1) / kQ;

  const size_t bh = (size_t)b * H + h;
  const TX* xg = x + bh * L * P + p_off;
  const float* lg = log_a + bh * L;
  const TBC* bg = bm + (size_t)b * L * N;
  const TBC* cg = cm + (size_t)b * L * N;
  TX* yg = y + bh * L * P + p_off;

  auto x_tile = [&](int k) { return reinterpret_cast<TX*>(smem + k * lay.buffer()); };
  auto b_tile = [&](int k) {
    return reinterpret_cast<TBC*>(smem + k * lay.buffer() + lay.x);
  };
  auto c_tile = [&](int k) {
    return reinterpret_cast<TBC*>(smem + k * lay.buffer() + lay.x + lay.bc);
  };
  auto state = [&](int k) {
    return reinterpret_cast<float*>(smem + k * lay.buffer() + lay.x + 2 * lay.bc);
  };
  float* cum = reinterpret_cast<float*>(smem + nbuf * lay.buffer()) + warp * 2 * kQ;
  const float* wq = cum + kQ;  // exp(cum_last - cum_j)

  // The state starts at 0, and the columns past the tile's P and past N
  // (to the row's end: the bf16 k-steps of 16 may read to np + 7), which
  // no copy writes, read as 0; rows past L are zeroed where they are
  // loaded.
  TX zx;
  TBC zbc;
  repro::store(0.f, &zx);
  repro::store(0.f, &zbc);
  {
    float4* z = reinterpret_cast<float4*>(state(0));
    for (int i = threadIdx.x; i < (int)(lay.s / 16); i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int xpad = kPT - pw, bpad = lay.bs - N;
    for (int k = 0; k < nbuf; ++k) {
      for (int i = threadIdx.x; i < kQ * xpad; i += kThreads)
        x_tile(k)[lay.xo(i / xpad, pw + i % xpad)] = zx;
      for (int i = threadIdx.x; i < kQ * bpad; i += kThreads) {
        const int o = lay.bo(i / bpad, N + i % bpad);
        b_tile(k)[o] = zbc;
        c_tile(k)[o] = zbc;
      }
    }
  }
  __syncthreads();

  // Chunk c's x, B and C tiles into buffer k: 16-byte cp.async copies where
  // rows are 16-byte aligned, element-wise stores otherwise. Rows past L are
  // zeroed.
  auto load_chunk = [&](int c, int k) {
    const int t0 = c * kQ, q_len = min(kQ, L - t0);
    TX* xd = x_tile(k);
    TBC* bd = b_tile(k);
    TBC* cd = c_tile(k);
    if (vec_x) {
      constexpr int v = 16 / sizeof(TX), per_row = kPT / v;
      for (int i = threadIdx.x; i < q_len * per_row; i += kThreads) {
        const int r = i / per_row, e = (i % per_row) * v;
        if (e < pw) repro::cp_async16(xd + lay.xo(r, e), xg + (size_t)(t0 + r) * P + e);
      }
    }
    if (vec_bc) {
      constexpr int v = 16 / sizeof(TBC);
      const int per_row = (NP ? NP : N) / v;
      for (int i = threadIdx.x; i < q_len * per_row; i += kThreads) {
        const int r = i / per_row, e = (i % per_row) * v;
        const size_t src = (size_t)(t0 + r) * N + e;
        repro::cp_async16(bd + lay.bo(r, e), bg + src);
        repro::cp_async16(cd + lay.bo(r, e), cg + src);
      }
    }
    repro::cp_async_commit();
    for (int i = threadIdx.x + (vec_x ? q_len * kPT : 0); i < kQ * kPT; i += kThreads) {
      const int r = i / kPT, e = i % kPT;
      xd[lay.xo(r, e)] = (r < q_len && e < pw) ? xg[(size_t)(t0 + r) * P + e] : zx;
    }
    for (int i = threadIdx.x + (vec_bc ? q_len * lay.np : 0); i < kQ * lay.np; i += kThreads) {
      const int r = i / lay.np, e = i % lay.np;
      const bool ok = r < q_len && e < N;
      const size_t src = (size_t)(t0 + r) * N + e;
      bd[lay.bo(r, e)] = ok ? bg[src] : zbc;
      cd[lay.bo(r, e)] = ok ? cg[src] : zbc;
    }
  };

  auto log_a_at = [&](int i) { return i < L ? lg[i] : 0.f; };
  float la0 = log_a_at(2 * lane), la1 = log_a_at(2 * lane + 1);
  load_chunk(0, 0);
  const int i0 = warp * 16 + g;  // this thread's rows: i0 and i0 + 8
  const int ntn = lay.np / 8;

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kQ, q_len = min(kQ, L - t0);
    const int k = c % nbuf;
    if (nbuf == 1 && c > 0) {  // every warp is done with chunk c - 1
      __syncthreads();
      load_chunk(c, 0);
    }
    repro::cp_async_wait<0>();
    __syncthreads();  // chunk c visible; every warp is done with chunk c - 1
    if (nbuf == 2 && c + 1 < nchunks) load_chunk(c + 1, k ^ 1);
    const float na0 = log_a_at(t0 + kQ + 2 * lane), na1 = log_a_at(t0 + kQ + 2 * lane + 1);

    const TX* X = x_tile(k);
    const TBC* Bt = b_tile(k);
    const TBC* Ct = c_tile(k);
    const float* Sc = state(k);  // f32, then (NP) the TF32 high and low parts
    if (s_chunks) {  // the state entering chunk c, for the backward
      float* dst = s_chunks + ((bh * nchunks + c) * P + p_off) * N;
      for (int i = threadIdx.x; i < pw * (N / 4); i += kThreads) {
        const int r = i / (N / 4), e = 4 * (i % (N / 4));
        *reinterpret_cast<float4*>(dst + (size_t)r * N + e) =
            *reinterpret_cast<const float4*>(Sc + r * lay.ss + e);
      }
    }
    const uint32_t* Sh = reinterpret_cast<const uint32_t*>(Sc) + kPT * lay.ss;
    const uint32_t* Sl = Sh + kPT * lay.ss;
    float* Sn = state((c + 1) % nbuf);

    // Inclusive cumsum of log_a, two steps a lane, in this warp's own rows.
    {
      float s = la0 + la1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) before = 0.f;
      const float c0 = before + la0, c1 = c0 + la1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      cum[kQ + 2 * lane] = expf(last - c0);
      cum[kQ + 2 * lane + 1] = expf(last - c1);
      __syncwarp();
    }

    // C.B^T over this warp's 16 rows and every 8-column tile of j (a warp
    // above the diagonal computes tiles the mask then zeroes: every warp
    // runs the same straight-line code, and the last one, which has no
    // such tile, sets the time), and C.S^T over the tile's columns.
    float G[8][4] = {}, G_lo[8][4] = {};
    float cross[kPT8][4] = {}, cross_lo[kPT8][4] = {};
    if constexpr (kExactBC) {  // bf16 B and C: C.B^T exact on m16n8k16
#pragma unroll
      for (int n0 = 0; n0 < lay.np; n0 += 16) {
        auto pair = [&](const TBC* tile, int r, int col) {
          return *reinterpret_cast<const uint32_t*>(tile + lay.bo(r, col));
        };
        const int k0 = n0 + 2 * t;
        const uint32_t a[4] = {pair(Ct, i0, k0), pair(Ct, i0 + 8, k0), pair(Ct, i0, k0 + 8),
                               pair(Ct, i0 + 8, k0 + 8)};
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
          const uint32_t bb[2] = {pair(Bt, 8 * jt + g, k0), pair(Bt, 8 * jt + g, k0 + 8)};
          mma_bf16(G[jt], a, bb);
        }
      }
    }
#pragma unroll
    for (int n0 = 0; n0 < lay.np; n0 += 8) {
      const float av[4] = {
          to_f32(Ct[lay.bo(i0, n0 + t)]), to_f32(Ct[lay.bo(i0 + 8, n0 + t)]),
          to_f32(Ct[lay.bo(i0, n0 + t + 4)]), to_f32(Ct[lay.bo(i0 + 8, n0 + t + 4)])};
      const Operand<4, kExactBC> a(av);
      if constexpr (!kExactBC) {  // f32 B and C: C.B^T in three TF32 passes
        Operand<2, false> bj[8];
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
          const float bv[2] = {to_f32(Bt[lay.bo(8 * jt + g, n0 + t)]),
                               to_f32(Bt[lay.bo(8 * jt + g, n0 + t + 4)])};
          bj[jt] = Operand<2, false>(bv);
        }
        mma_row(G, G_lo, a, bj);
      }
      Operand<2, false> sp[kPT8];
#pragma unroll
      for (int pt = 0; pt < kPT8; ++pt) {
        const int o = (8 * pt + g) * lay.ss + n0 + t;
        if constexpr (NP != 0) {
          const uint32_t sh[2] = {Sh[o], Sh[o + 4]}, sl[2] = {Sl[o], Sl[o + 4]};
          sp[pt] = Operand<2, false>(sh, sl);
        } else {
          const float sv[2] = {Sc[o], Sc[o + 4]};
          sp[pt] = Operand<2, false>(sv);
        }
      }
      mma_row(cross, cross_lo, a, sp);
    }
    add_small<8, !kExactBC>(G, G_lo);
    add_small<kPT8, true>(cross, cross_lo);

    // Scores: decay exp(cum_i - cum_j), zero above the diagonal, where the
    // exponent is replaced by 0 first so that no branch guards the exp.
    const float ci0 = cum[i0], ci1 = cum[i0 + 8];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int j = 8 * jt + 2 * t;
      const float cj0 = cum[j], cj1 = cum[j + 1];
      const bool m00 = j <= i0, m01 = j + 1 <= i0, m10 = j <= i0 + 8, m11 = j + 1 <= i0 + 8;
      const float e00 = expf(m00 ? ci0 - cj0 : 0.f), e01 = expf(m01 ? ci0 - cj1 : 0.f);
      const float e10 = expf(m10 ? ci1 - cj0 : 0.f), e11 = expf(m11 ? ci1 - cj1 : 0.f);
      G[jt][0] = m00 ? G[jt][0] * e00 : 0.f;
      G[jt][1] = m01 ? G[jt][1] * e01 : 0.f;
      G[jt][2] = m10 ? G[jt][2] * e10 : 0.f;
      G[jt][3] = m11 ? G[jt][3] * e11 : 0.f;
    }

    // Scores times x: the accumulator's columns 2t, 2t + 1 of tile jt are
    // the A fragment's k = t, t + 4, so x's rows 8 jt + 2t, + 1 are read.
    float intra[kPT8][4] = {}, intra_lo[kPT8][4] = {};
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const float gv[4] = {G[jt][0], G[jt][2], G[jt][1], G[jt][3]};
      const Operand<4, false> a(gv);
      const int j = 8 * jt + 2 * t;
      Operand<2, kExactX> xp[kPT8];
#pragma unroll
      for (int pt = 0; pt < kPT8; ++pt) {
        const float xv[2] = {to_f32(X[lay.xo(j, 8 * pt + g)]),
                             to_f32(X[lay.xo(j + 1, 8 * pt + g)])};
        xp[pt] = Operand<2, kExactX>(xv);
      }
      mma_row(intra, intra_lo, a, xp);
    }
    add_small<kPT8, true>(intra, intra_lo);

    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int pt = 0; pt < kPT8; ++pt) {
      const int p = 8 * pt + 2 * t;  // even, and P % 4 == 0: p + 1 is live too
      if (p < pw) {
        if (i0 < q_len)
          store2(yg + (size_t)(t0 + i0) * P + p, intra[pt][0] + e0 * cross[pt][0],
                 intra[pt][1] + e0 * cross[pt][1]);
        if (i0 + 8 < q_len)
          store2(yg + (size_t)(t0 + i0 + 8) * P + p, intra[pt][2] + e1 * cross[pt][2],
                 intra[pt][3] + e1 * cross[pt][3]);
      }
    }

    // State: S <- exp(cum_last) S + (x w)^T B. A warp takes n-tiles nt0 and
    // nt0 + 4 over every 16-row tile of the CTA's columns, so each x w
    // fragment feeds two products and each B fragment kMT; x's rows are
    // read in the same order as above. With NP the new state is stored
    // with its TF32 parts, which the next chunk's C.S^T reads.
    if (nbuf == 1) __syncthreads();  // every warp's read of S is done
    const float decay = expf(cum[kQ - 1]);
    for (int nt0 = warp; nt0 < ntn; nt0 += 2 * kWarps) {
      const bool two = (NP && NP % 64 == 0) || nt0 + kWarps < ntn;
      float acc[kMT][2][4], acc_lo[kMT][2][4] = {};
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * (nt0 + u * kWarps) + 2 * t;
          const bool live = u == 0 || two;
          const float2 z = make_float2(0.f, 0.f);
          const float2 s0 =
              live ? *reinterpret_cast<const float2*>(Sc + (16 * mt + g) * lay.ss + col) : z;
          const float2 s1 =
              live ? *reinterpret_cast<const float2*>(Sc + (16 * mt + g + 8) * lay.ss + col) : z;
          acc[mt][u][0] = decay * s0.x;
          acc[mt][u][1] = decay * s0.y;
          acc[mt][u][2] = decay * s1.x;
          acc[mt][u][3] = decay * s1.y;
        }
#pragma unroll
      for (int jb = 0; jb < kQ / 8; ++jb) {
        const int j = 8 * jb + 2 * t;
        const float w0 = wq[j], w1 = wq[j + 1];
        const int nc = 8 * nt0 + g;
        const float bv0[2] = {to_f32(Bt[lay.bo(j, nc)]), to_f32(Bt[lay.bo(j + 1, nc)])};
        const float bv1[2] = {two ? to_f32(Bt[lay.bo(j, nc + 8 * kWarps)]) : 0.f,
                              two ? to_f32(Bt[lay.bo(j + 1, nc + 8 * kWarps)]) : 0.f};
        const Operand<2, kExactBC> bn[2] = {Operand<2, kExactBC>(bv0), Operand<2, kExactBC>(bv1)};
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int pc = 16 * mt + g;
          const float av[4] = {to_f32(X[lay.xo(j, pc)]) * w0, to_f32(X[lay.xo(j, pc + 8)]) * w0,
                               to_f32(X[lay.xo(j + 1, pc)]) * w1,
                               to_f32(X[lay.xo(j + 1, pc + 8)]) * w1};
          mma_row(acc[mt], acc_lo[mt], Operand<4, false>(av), bn);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) add_small<2, true>(acc[mt], acc_lo[mt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) continue;
          const int col = 8 * (nt0 + u * kWarps) + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int o = (16 * mt + g + 8 * r) * lay.ss + col;
            const float v0 = acc[mt][u][2 * r], v1 = acc[mt][u][2 * r + 1];
            store2(Sn + o, v0, v1);
            if constexpr (NP != 0) {
              const uint32_t h0 = tf32_bits(v0), h1 = tf32_bits(v1);
              uint32_t* hp = reinterpret_cast<uint32_t*>(Sn) + kPT * lay.ss + o;
              *reinterpret_cast<uint2*>(hp) = make_uint2(h0, h1);
              *reinterpret_cast<uint2*>(hp + kPT * lay.ss) =
                  make_uint2(tf32_low_bits(v0 - __uint_as_float(h0)),
                             tf32_low_bits(v1 - __uint_as_float(h1)));
            }
          }
        }
    }
    la0 = na0;
    la1 = na1;
  }
  __syncthreads();

  const float* Sf = state(nchunks % nbuf);
  float* sg = s_out + bh * P * N + (size_t)p_off * N;
  for (int i = threadIdx.x; i < pw * N; i += kThreads)
    sg[i] = Sf[(i / N) * lay.ss + i % N];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TX, typename TBC, int NP>
cudaError_t launch(const void* x, const float* log_a, const void* b, const void* c,
                   void* y, float* s_out, float* s_chunks, int B, int H, int L, int P,
                   int N, cudaStream_t stream) {
  static bool done[64] = {};
  const Layout<TX, TBC, NP> lay(N);
  const int nbuf = lay.total(2) <= kMaxSmem ? 2 : 1;
  const size_t smem = lay.total(nbuf);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<TX, TBC, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
  const int vec_x = aligned16(x) && (P * sizeof(TX)) % 16 == 0;
  const int vec_bc = aligned16(b) && aligned16(c) && (N * sizeof(TBC)) % 16 == 0;
  const dim3 grid(H * ((P + kPT - 1) / kPT), B);
  ssd_scan_kernel<TX, TBC, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), log_a, static_cast<const TBC*>(b),
      static_cast<const TBC*>(c), static_cast<TX*>(y), s_out, s_chunks, H, L, P, N, nbuf,
      vec_x, vec_bc);
  return cudaGetLastError();
}

template <typename TX, typename TBC>
cudaError_t dispatch_n(const void* x, const float* log_a, const void* b, const void* c,
                       void* y, float* s_out, float* s_chunks, int B, int H, int L, int P,
                       int N, cudaStream_t s) {
  if (N == 64)
    return launch<TX, TBC, 64>(x, log_a, b, c, y, s_out, s_chunks, B, H, L, P, N, s);
  return launch<TX, TBC, 0>(x, log_a, b, c, y, s_out, s_chunks, B, H, L, P, N, s);
}

template <typename TX>
cudaError_t dispatch_bc(const void* x, const float* log_a, const void* b, const void* c,
                        void* y, float* s_out, float* s_chunks, int B, int H, int L, int P,
                        int N, int bc_dtype, cudaStream_t s) {
  if (bc_dtype == 0)
    return dispatch_n<TX, float>(x, log_a, b, c, y, s_out, s_chunks, B, H, L, P, N, s);
  if (bc_dtype == 1)
    return dispatch_n<TX, __nv_bfloat16>(x, log_a, b, c, y, s_out, s_chunks, B, H, L, P, N,
                                         s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. x (B,H,L,P) and y like x; log_a
// (B,H,L) f32; b, c (B,L,N); s_out (B,H,P,N) f32; s_chunks, when not null,
// (B,H,ceil(L/64),P,N) f32, the state entering each chunk (the backward's
// input; serving passes null and gets y and s_out alone); all contiguous,
// P and N multiples of 4.
extern "C" int ssd_scan_fwd(const void* x, const void* log_a, const void* b,
                            const void* c, void* y, void* s_out, void* s_chunks, int B,
                            int H, int L, int P, int N, int x_dtype, int bc_dtype,
                            void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || P % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  float* so = static_cast<float*>(s_out);
  float* sc = static_cast<float*>(s_chunks);
  if (sc && reinterpret_cast<uintptr_t>(sc) % 16) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (x_dtype == 0)
    err = dispatch_bc<float>(x, la, b, c, y, so, sc, B, H, L, P, N, bc_dtype, s);
  else if (x_dtype == 1)
    err = dispatch_bc<__nv_bfloat16>(x, la, b, c, y, so, sc, B, H, L, P, N, bc_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

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
// M_ij = (C_i . B_j) L_ij, w_j = exp(cum_Q - cum_j):
//   dS_{k-1} = exp(cum_Q) dS_k + sum_i exp(cum_i) dy_i C_i^T
//   dx_j = sum_i M_ij dy_i + w_j dS B_j
//   dC_i = sum_j (dy_i . x_j) L_ij B_j + exp(cum_i) dy_i S
//   dB_j = sum_i (dy_i . x_j) L_ij C_i + w_j x_j dS
//   dlog_a_t = sum_{i >= t} dcum_i over the chunk, dcum gathering the
//   decays' gradients: (dy_i . x_j) M_ij on row i and minus it on column j,
//   exp(cum_i) dy_i . (S C_i), w_j x_j . (dS B_j) minus on cum_j and plus on
//   cum_Q, and exp(cum_Q) <dS, S> on cum_Q.
//
// Two launches:
//   * state_kernel, one CTA per (batch, head, 16 rows of P): the reverse
//     sweep over chunks, the 16 x N slice of dS in registers; it writes the
//     dS leaving every chunk (B, H, nck, P, N) f32. Only this part is
//     sequential over chunks, and it is the cheap part (Q.P.N a chunk): the
//     next chunk's C and dy are fetched with cp.async while this one
//     computes, and at N <= 64 a thread of 128 holds 8 elements, so its
//     CTAs (640 at zamba2's training shape) all fit on the card at once.
//   * chunk_kernel, one CTA per (batch, head, chunk), 5120 at zamba2's
//     training shape (B 2, H 80, L 2048): every other term, with S and dS
//     read from memory. It writes dx and dlog_a, and dB and dC as per-head
//     f32 partials (B and C are shared by every head), which the wrapper
//     sums over H with torch.sum in a fixed order: no float atomics, so two
//     launches give the same bits.
//
// What bounds it on an H100: bytes at the bound, the products in practice.
// At zamba2's training shape it must read x, dy and the chunk states and
// write dx (84 MB each in f32) and B, C, dB, dC: about 0.1 ms at 3.35 TB/s;
// its products (eight 64 x 64 x 64 a head and chunk) are about 21 GFLOP,
// 0.32 ms at the f32 CUDA-core rate. This first design runs them on the CUDA
// cores in f32: each of 256 threads owns a 4 x 4 block of a 64 x 64 output
// (rows 4 ty + r, columns tx + 16 c), operands from shared memory in
// vector loads along k wherever the layout allows, rows padded (68 floats,
// 72 bf16) so a warp's loads spread over the banks. Tiles are 64 wide over
// P and N; a tile stays resident while later phases need it, so at P = N =
// 64 every operand is read from memory once, all six in one batch of
// cp.async copies at the start. B and C stay bf16 in shared memory and
// M's buffer takes dCB once dx is done, so with bf16 B/C a CTA needs 111 KB
// and two share an SM (16 warps), which hides one CTA's copies and
// barriers behind the other's products. On an H100 (700 W) a call takes
// 1.20 ms at that shape, 12x the bytes bound (PERF.md); the tensor cores
// (the forward's 3xTF32 mma.sync) are the next step for speed.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launches (0 on success).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::to_f32;

constexpr int kQ = 64;             // steps per chunk (the forward's)
constexpr int kT = 64;             // tile width over P and N
constexpr int kThreads = 256;      // 16 x 16 threads, a 4 x 4 block each
constexpr int kRows = 16;          // rows of P a state_kernel CTA takes
constexpr int kStateThreads = 128; // state_kernel's threads: all its CTAs fit at once
constexpr int kMaxN = 256;         // state_kernel keeps kRows x N in registers
constexpr size_t kMaxSmem = 232448;

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

__host__ __device__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
__device__ __forceinline__ T zero() {
  T z;
  repro::store(0.f, &z);
  return z;
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
__device__ void load_tile(T* dst, const T* src, int rows, int cols, int ld, bool vec) {
  constexpr int LD = tile_ld<T>();
  if (vec) {
    constexpr int v = 16 / sizeof(T), per = kT / v;
    for (int i = threadIdx.x; i < kQ * per; i += kThreads) {
      const int r = i / per, e = (i % per) * v;
      if (r < rows)
        cp_async16(dst + r * LD + e, src + (size_t)r * ld + e);
      else
        *reinterpret_cast<uint4*>(dst + r * LD + e) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kQ * kT; i += kThreads) {
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

// The reverse sweep: dS (16 rows of P by N) from the final state's gradient
// back to the first chunk; ds[b, h, k] is the gradient of the state leaving
// chunk k. A thread holds E consecutive elements of one row, four columns
// at a time ((r, n) = divmod(E tid + m, N); N and E are multiples of 4), so
// each step of the chunk reads one scaled dy and four C values for four
// products. Chunk k - 1's C and dy are copied into the other buffer while
// chunk k computes.
template <typename TBC, int E>
__global__ void __launch_bounds__(kStateThreads)
    state_kernel(const float* __restrict__ log_a, const TBC* __restrict__ cm,
                 const float* __restrict__ dy, const float* __restrict__ ds_final,
                 float* __restrict__ ds, int H, int L, int P, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t c_bytes = ((size_t)kQ * N * sizeof(TBC) + 15) & ~(size_t)15;
  const size_t buf = c_bytes + kQ * kRows * sizeof(float);
  auto c_buf = [&](int k) { return reinterpret_cast<TBC*>(smem + k * buf); };
  auto dy_buf = [&](int k) { return reinterpret_cast<float*>(smem + k * buf + c_bytes); };
  float* ecum = reinterpret_cast<float*>(smem + 2 * buf);  // exp(cum_i) of the chunk

  const int p0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kRows, P - p0);
  const int nck = (L + kQ - 1) / kQ;
  const size_t bh = (size_t)b * H + h;
  const int tid = threadIdx.x, lane = tid & 31;
  const float* lg = log_a + bh * L;
  const bool vec_c = (N * sizeof(TBC)) % 16 == 0 && aligned16(cm);
  const bool vec_dy = rows == kRows && P % 4 == 0 && aligned16(dy);

  auto load = [&](int c, int k) {
    const int t0 = c * kQ, qlen = min(kQ, L - t0);
    TBC* cd = c_buf(k);
    float* dd = dy_buf(k);
    const TBC* cg = cm + ((size_t)b * L + t0) * N;
    const float* dyg = dy + (bh * L + t0) * P + p0;
    if (vec_c) {
      constexpr int v = 16 / sizeof(TBC);
      for (int i = tid; i < qlen * N / v; i += kStateThreads) cp_async16(cd + i * v, cg + i * v);
      for (int i = qlen * N + tid; i < kQ * N; i += kStateThreads) cd[i] = zero<TBC>();
    } else {
      for (int i = tid; i < kQ * N; i += kStateThreads) cd[i] = i / N < qlen ? cg[i] : zero<TBC>();
    }
    if (vec_dy) {
      for (int i = tid; i < qlen * (kRows / 4); i += kStateThreads) {
        const int t = i / (kRows / 4), e = 4 * (i % (kRows / 4));
        cp_async16(dd + t * kRows + e, dyg + (size_t)t * P + e);
      }
      for (int i = qlen * kRows + tid; i < kQ * kRows; i += kStateThreads) dd[i] = 0.f;
    } else {
      for (int i = tid; i < kQ * kRows; i += kStateThreads) {
        const int t = i / kRows, r = i % kRows;
        dd[i] = (t < qlen && r < rows) ? dyg[(size_t)t * P + r] : 0.f;
      }
    }
    cp_async_commit();
  };
  float la0 = 0.f, la1 = 0.f;  // warp 0: the log_a of the chunk to compute next
  auto read_la = [&](int c) {
    const int t0 = c * kQ, qlen = min(kQ, L - t0);
    la0 = 2 * lane < qlen ? lg[t0 + 2 * lane] : 0.f;
    la1 = 2 * lane + 1 < qlen ? lg[t0 + 2 * lane + 1] : 0.f;
  };

  // E / 4 groups of four columns: group q at row gr[q], columns gn[q] to
  // gn[q] + 3.
  constexpr int G = E / 4;
  float acc[E];
  int gr[G], gn[G];
  bool ok[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int e = E * tid + 4 * q;
    gr[q] = e / N, gn[q] = e % N;
    ok[q] = e < kRows * N && gr[q] < rows;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc[4 * q + u] = (ds_final && ok[q]) ? ds_final[(bh * P + p0 + gr[q]) * N + gn[q] + u]
                                           : 0.f;
  }
  load(nck - 1, 0);
  if (tid < 32) read_la(nck - 1);
  for (int c = nck - 1, k = 0; c >= 0; --c, k ^= 1) {
    float* dsg = ds + ((bh * nck + c) * P + p0) * N;
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (ok[q])
        *reinterpret_cast<float4*>(dsg + gr[q] * N + gn[q]) =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every thread is done with chunk c + 1
    if (c > 0) load(c - 1, k ^ 1);
    if (tid < 32) {
      const float2 cu = warp_cumsum(la0, la1);
      ecum[2 * lane] = expf(cu.x);
      ecum[2 * lane + 1] = expf(cu.y);
      if (c > 0) read_la(c - 1);
    }
    __syncthreads();
    float* ys = dy_buf(k);
    for (int i = tid; i < kQ * kRows; i += kStateThreads) ys[i] *= ecum[i / kRows];
    __syncthreads();
    const TBC* cs = c_buf(k);
    const float decay = ecum[kQ - 1];
#pragma unroll
    for (int m = 0; m < E; ++m) acc[m] *= decay;
    for (int i = 0; i < kQ; ++i) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (!ok[q]) continue;
        const float y = ys[i * kRows + gr[q]];
        const float4 cv = load4(cs + i * N + gn[q]);
        acc[4 * q] = fmaf(y, cv.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(y, cv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(y, cv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(y, cv.w, acc[4 * q + 3]);
      }
    }
  }
}

// Everything but the reverse sweep, for one (batch, head, chunk): dx, dlog_a,
// and dB / dC as this head's partials.
template <typename TBC>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
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
    if (tC != nt) load_tile(sC, cg + nt * kT, qlen, cols, N, vec_n && cols == kT), tC = nt;
    if (tB != nt) load_tile(sB, bg + nt * kT, qlen, cols, N, vec_n && cols == kT), tB = nt;
  };
  auto need_dy = [&](int pt) {
    const int cols = min(kT, P - pt * kT);
    if (tDY != pt) load_tile(sDY, dyg + pt * kT, qlen, cols, P, vec_p && cols == kT), tDY = pt;
  };
  auto need_x = [&](int pt) {
    const int cols = min(kT, P - pt * kT);
    if (tX != pt) load_tile(sX, xg + pt * kT, qlen, cols, P, vec_p && cols == kT), tX = pt;
  };
  auto need_state = [&](float* dst, const float* src, int& tag, int pt, int nt) {
    const int rows = min(kT, P - pt * kT), cols = min(kT, N - nt * kT);
    if (tag != pt * nnt + nt)
      load_tile(dst, src + (size_t)pt * kT * N + nt * kT, rows, cols, N, vec_s && cols == kT),
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
      for (int e = tid; e < kT * kT; e += kThreads) {
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
      for (int k = 0; k < kThreads / 32; ++k) s += red[kQ * 16 + k];
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
size_t chunk_smem() {
  return 2 * tile_bytes<TBC>() + 5 * tile_bytes<float>() +
         (7 * kQ + 16 * kQ + kThreads / 32) * sizeof(float);
}

size_t state_smem(int N, size_t bc_size) {
  return 2 * ((((size_t)kQ * N * bc_size + 15) & ~(size_t)15) + kQ * kRows * sizeof(float)) +
         kQ * sizeof(float);
}

template <typename TBC>
cudaError_t launch(const float* x, const float* log_a, const void* b, const void* c,
                   const float* dy, const float* ds_final, const float* states, float* ds,
                   float* dx, float* dla, float* db_parts, float* dc_parts, int B, int H,
                   int L, int P, int N, cudaStream_t stream) {
  static bool done[64] = {};
  const size_t s_smem = state_smem(N, sizeof(TBC)), c_smem = chunk_smem<TBC>();
  if (s_smem > kMaxSmem || c_smem > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !done[dev]) {
    for (const void* k : {(const void*)state_kernel<TBC, 8>, (const void*)state_kernel<TBC, 32>,
                          (const void*)chunk_kernel<TBC>}) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err != cudaSuccess) return err;
    }
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
  const int nck = (L + kQ - 1) / kQ;
  const TBC* bm = static_cast<const TBC*>(b);
  const TBC* cm = static_cast<const TBC*>(c);
  const dim3 s_grid((P + kRows - 1) / kRows, H, B);
  if (kRows * N <= 8 * kStateThreads)
    state_kernel<TBC, 8><<<s_grid, kStateThreads, s_smem, stream>>>(log_a, cm, dy, ds_final,
                                                                     ds, H, L, P, N);
  else
    state_kernel<TBC, 32><<<s_grid, kStateThreads, s_smem, stream>>>(log_a, cm, dy, ds_final,
                                                                      ds, H, L, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_kernel<TBC><<<dim3(nck, H, B), kThreads, c_smem, stream>>>(
      x, log_a, bm, cm, dy, states, ds, dx, dla, db_parts, dc_parts, H, L, P, N);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (B and C). x, dy, dx (B,H,L,P) f32;
// log_a, dla (B,H,L) f32; b, c (B,L,N); ds_final (B,H,P,N) f32 or null
// (zero); states and ds (scratch) (B,H,ceil(L/64),P,N) f32; db_parts,
// dc_parts (B,H,L,N) f32, this head's share of dB and dC; all contiguous,
// N a multiple of 4 up to 256.
extern "C" int ssd_scan_bwd(const void* x, const void* log_a, const void* b, const void* c,
                            const void* dy, const void* ds_final, const void* states,
                            void* ds, void* dx, void* dla, void* db_parts, void* dc_parts,
                            int B, int H, int L, int P, int N, int bc_dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || N % 4 || N > kMaxN || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (bc_dtype == 0)
    return (int)launch<float>(f(x), f(log_a), b, c, f(dy), f(ds_final), f(states), o(ds),
                              o(dx), o(dla), o(db_parts), o(dc_parts), B, H, L, P, N, s);
  if (bc_dtype == 1)
    return (int)launch<__nv_bfloat16>(f(x), f(log_a), b, c, f(dy), f(ds_final), f(states),
                                      o(ds), o(dx), o(dla), o(db_parts), o(dc_parts), B, H, L,
                                      P, N, s);
  return (int)cudaErrorInvalidValue;
}

// Mamba-2 SSD chunk scan for Hopper (sm_90a): per (batch, head), the chunks
// in order, carrying a (P, N) f32 state; inside a chunk the quadratic dual
// form.
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
// What bounds it on an H100: operations, at zamba2's prefill shape. The
// fewest the function needs is the chunked form at its cheapest chunk
// length m: per chunk and head (N + P) * m(m + 1) FLOPs for the masked dual
// form, 4 * m * P * N for the state read and update and P * N for the
// state's decay. At P = N = 64 that is least at m = 5-6, ~18.0 k FLOPs a
// step against 8 * P bytes of x read and y written: ~35 FLOPs per byte,
// above the f32 (CUDA-core) ridge of 67 TFLOP/s over 3.35 TB/s = 20 FLOPs
// per byte. At B = 1, H = 80 SSM heads, L = 256: 368 MFLOP, 5.5 us at
// 67 TFLOP/s; 11.9 MB, 3.6 us at 3.35 TB/s (chip_smoke.py's ssd_min_flops).
// This kernel's Q = 64 does ~24.7 k FLOPs a step, 1.37x that minimum.
//
// What this design does about it (first, simple version):
//   * The TPU grid's sequential chunk axis becomes a loop inside one CTA
//     per (head, batch); the state lives in shared memory (transposed,
//     [N][P]) for the whole sequence and is written out once. At zamba2's
//     prefill shape that is 80 CTAs of 256 threads on 132 SMs.
//   * The chunk length is the kernel's own (Q = 64: the (Q, Q) f32 score
//     tile is 16 KB; ~84 KB of shared memory at P = N = 64). Any length
//     works: steps past L load x = 0, log_a = 0 and B = C = 0, which
//     leaves y and the final state exact.
//   * Each of the three products (C.B^T, the masked scores times x with
//     the C.S read, and the state update) gives every thread a 4 x 4
//     register tile; operands come from shared memory as float4 rows, the
//     tiles of B and C transposed so a warp reads contiguous words. Score
//     tiles wholly above the diagonal are skipped.
//   * Products run on the CUDA cores in f32, as the reference's f32
//     accumulation does. Moving them onto wgmma (tf32 or bf16 operands)
//     is the next step for this kernel.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include "common.cuh"

namespace {

using repro::store;
using repro::to_f32;

constexpr int kQ = 64;         // steps per chunk
constexpr int kQP = kQ + 4;    // row stride of the transposed B/C tiles
constexpr int kThreads = 256;  // (kQ / 4)^2 score tiles, one per thread

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ log_a,
                    const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                    TX* __restrict__ y, float* __restrict__ s_out, int H,
                    int L, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;              // [N][P] carried state, transposed
  float* xs = st + N * P;        // [kQ][P] this chunk's x
  float* bt = xs + kQ * P;       // [N][kQP] B^T
  float* ct = bt + N * kQP;      // [N][kQP] C^T
  float* gs = ct + N * kQP;      // [kQ][kQ] (C.B^T) * exp(cum_i - cum_j), i >= j
  float* cum = gs + kQ * kQ;     // [kQ] inclusive cumsum of log_a
  float* wq = cum + kQ;          // [kQ] exp(cum_last - cum_j)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int P4 = P / 4, N4 = N / 4;

  const TX* xg = x + ((size_t)b * H + h) * L * P;
  const float* lg = log_a + ((size_t)b * H + h) * L;
  const TBC* bg = bm + (size_t)b * L * N;
  const TBC* cg = cm + (size_t)b * L * N;
  TX* yg = y + ((size_t)b * H + h) * L * P;

  for (int i = tid; i < N * P; i += kThreads) st[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kQ) {
    const int q_len = min(kQ, L - t0);
    __syncthreads();  // the previous chunk is consumed, the state updated

    for (int i = tid; i < kQ * P; i += kThreads)
      xs[i] = i < q_len * P ? to_f32(xg[(size_t)t0 * P + i]) : 0.f;
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const bool ok = r < q_len;
      bt[n * kQP + r] = ok ? to_f32(bg[(size_t)(t0 + r) * N + n]) : 0.f;
      ct[n * kQP + r] = ok ? to_f32(cg[(size_t)(t0 + r) * N + n]) : 0.f;
    }
    if (tid < 32) {  // inclusive cumsum, two steps per lane
      const int i0 = 2 * tid;
      const float a0 = i0 < q_len ? lg[t0 + i0] : 0.f;
      const float a1 = i0 + 1 < q_len ? lg[t0 + i0 + 1] : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) before = 0.f;
      cum[i0] = before + a0;
      cum[i0 + 1] = cum[i0] + a1;
    }
    __syncthreads();

    // Scores: one 4 x 4 tile of (i, j) per thread.
    if (tid < kQ) wq[tid] = expf(cum[kQ - 1] - cum[tid]);
    for (int tile = tid; tile < (kQ / 4) * (kQ / 4); tile += kThreads) {
      const int i0 = (tile / (kQ / 4)) * 4, j0 = (tile % (kQ / 4)) * 4;
      float acc[4][4] = {};
      if (j0 <= i0 + 3) {
        for (int n = 0; n < N; ++n)
          fma4x4(acc, ld4(ct + n * kQP + i0), ld4(bt + n * kQP + j0));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + a;
        float g[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          g[c] = j <= i ? acc[a][c] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(gs + i * kQ + j0) =
            make_float4(g[0], g[1], g[2], g[3]);
      }
    }
    __syncthreads();

    // Output: one 4 x 4 tile of (i, p) per thread; the masked scores times
    // x, plus exp(cum_i) * C_i . S with the state carried in.
    for (int tile = tid; tile < (kQ / 4) * P4; tile += kThreads) {
      const int i0 = (tile / P4) * 4, p0 = (tile % P4) * 4;
      float intra[4][4] = {}, cross[4][4] = {};
      for (int j = 0; j < min(i0 + 4, q_len); ++j) {
        const float4 g = make_float4(gs[i0 * kQ + j], gs[(i0 + 1) * kQ + j],
                                     gs[(i0 + 2) * kQ + j],
                                     gs[(i0 + 3) * kQ + j]);
        fma4x4(intra, g, ld4(xs + j * P + p0));
      }
      for (int n = 0; n < N; ++n)
        fma4x4(cross, ld4(ct + n * kQP + i0), ld4(st + n * P + p0));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + a;
        if (i >= q_len) break;
        const float e = expf(cum[i]);
        TX* yr = yg + (size_t)(t0 + i) * P + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) store(intra[a][c] + cross[a][c] * e, yr + c);
      }
    }
    __syncthreads();  // every read of the old state is done

    // State: one 4 x 4 tile of (n, p) per thread, in place.
    const float decay = expf(cum[kQ - 1]);
    for (int tile = tid; tile < N4 * P4; tile += kThreads) {
      const int n0 = (tile / P4) * 4, p0 = (tile % P4) * 4;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 s = ld4(st + (n0 + a) * P + p0);
        acc[a][0] = decay * s.x;
        acc[a][1] = decay * s.y;
        acc[a][2] = decay * s.z;
        acc[a][3] = decay * s.w;
      }
      for (int j = 0; j < q_len; ++j) {
        const float w = wq[j];
        const float4 bw = make_float4(
            bt[n0 * kQP + j] * w, bt[(n0 + 1) * kQP + j] * w,
            bt[(n0 + 2) * kQP + j] * w, bt[(n0 + 3) * kQP + j] * w);
        fma4x4(acc, bw, ld4(xs + j * P + p0));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(st + (n0 + a) * P + p0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
  __syncthreads();

  float* sg = s_out + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) sg[i] = st[(i % N) * P + i / N];
}

size_t smem_bytes(int P, int N) {
  return (size_t)(N * P + kQ * P + 2 * N * kQP + kQ * kQ + 2 * kQ) *
         sizeof(float);
}

template <typename TX, typename TBC>
cudaError_t launch(const void* x, const float* log_a, const void* b,
                   const void* c, void* y, float* s_out, int B, int H, int L,
                   int P, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<TX, TBC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<TX, TBC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), log_a, static_cast<const TBC*>(b),
      static_cast<const TBC*>(c), static_cast<TX*>(y), s_out, H, L, P, N);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_bc(const void* x, const float* log_a, const void* b,
                        const void* c, void* y, float* s_out, int B, int H,
                        int L, int P, int N, int bc_dtype, cudaStream_t s) {
  if (bc_dtype == 0)
    return launch<TX, float>(x, log_a, b, c, y, s_out, B, H, L, P, N, s);
  if (bc_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, log_a, b, c, y, s_out, B, H, L, P, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. x (B,H,L,P) and y like x; log_a
// (B,H,L) f32; b, c (B,L,N); s_out (B,H,P,N) f32; all contiguous, P and N
// multiples of 4.
extern "C" int ssd_scan_fwd(const void* x, const void* log_a, const void* b,
                            const void* c, void* y, void* s_out, int B, int H,
                            int L, int P, int N, int x_dtype, int bc_dtype,
                            void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || P % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  float* so = static_cast<float*>(s_out);
  cudaError_t err;
  if (x_dtype == 0)
    err = dispatch_bc<float>(x, la, b, c, y, so, B, H, L, P, N, bc_dtype, s);
  else if (x_dtype == 1)
    err = dispatch_bc<__nv_bfloat16>(x, la, b, c, y, so, B, H, L, P, N, bc_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

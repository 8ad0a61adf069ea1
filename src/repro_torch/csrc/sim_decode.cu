// Fused DES decode-advance round for Hopper (sm_90a): one round of the
// torch fleet-simulator tier over the stacked (P, I, S) slot arrays.
//
// Replaces: src/repro/kernels/sim_decode.py::decode_advance_pallas (body
// _decode_kernel, grid (I,), one (1, S) slot row per program), the compiled
// DES tier's decode-advance round, and the reference engine's per-pool
// restack around it: here one launch covers every pool, with c_max a
// per-pool int32 array.
//
// Per (pool, instance) row: feed one prefill chunk to the oldest prefilling
// slot (first-index argmin of sq over occ & pre > 0); compute the
// event-distance k-jump min(min rem, min(c_max - ctx),
// ceil((t_limit - now) / t_it - 1e-9)), clamped to [1, 2^30] and forced to 1
// with prefill or when the KV growth sum max(blocks_for(inp+gen+k) - blk, 0)
// exceeds the row's free blocks; end = now + k * t_it with
// t_it = w + h * nact; advance gen / rem / ft and stage trunc_new, tr, comp.
//
// Numerics: float64 event times, int32 counters, sentinels 2^30 and 1e18,
// as the reference. Every float64 operation is an explicitly rounded
// intrinsic, so nvcc has nothing to contract or reorder. The two products
// that the reference's compiled tier (jax.jit on XLA) contracts into fused
// multiply-adds, w + h*nact and now + k*t_it, are written as __fma_rn here,
// and as an exact fma in the plain PyTorch version; the rest are
// __dsub_rn / __ddiv_rn / __dadd_rn. So the kernel, the plain version and
// the compiled reference agree bit for bit.
// Integer sums wrap mod 2^32 as XLA's int32 adds do.
//
// What bounds it on an H100: bytes. About 34 bytes in and 24 bytes out per
// slot and a few per row, against a handful of integer operations per
// byte; at the fleet shapes (a few hundred rows of at most 128 slots) the
// whole pass moves under 3 MB, so a launch is microseconds of memory
// traffic and, in practice, launch latency.
//
// What this design does about it (first, simple version): one CTA of 128
// threads per (pool, instance) row, one thread per slot (looping when a row
// has more slots), block reductions through warp shuffles for the argmin,
// the two minima and the growth sum. t_limit is read from device memory, so
// a round needs no host sync. Each slot field is read once per pass from
// global memory (L1-resident within the CTA).
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBigI = 1 << 30;
constexpr double kBigF = 1.0e18;
constexpr int kBlockTokens = 16;  // KV_BLOCK_TOKENS

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// max(1, floor((tok + 15) / 16)), floor division as jnp's // on int32.
__device__ __forceinline__ int blocks_for(int tok) {
  const int q = wrap_add(tok, kBlockTokens - 1);
  int d = q / kBlockTokens;
  if (q % kBlockTokens != 0 && q < 0) d -= 1;
  return d > 1 ? d : 1;
}

struct MinU64 {
  __device__ unsigned long long operator()(unsigned long long a, unsigned long long b) const {
    return a < b ? a : b;
  }
};
struct MinI32 {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct OrI32 {
  __device__ int operator()(int a, int b) const { return a | b; }
};
struct SumU32 {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};

// Reduce v over the CTA; every thread gets the result. `smem` holds one
// value per warp.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous reduction's readers are done with smem
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, smem[w]);
  return r;
}

__global__ void __launch_bounds__(kThreads) decode_advance_kernel(
    const double* __restrict__ t_limit_p, const bool* __restrict__ busy_p,
    const double* __restrict__ now_p, const int* __restrict__ nact_p,
    const int* __restrict__ free_p, const bool* __restrict__ occ_p,
    const int* __restrict__ pre_p, const int* __restrict__ sq_p,
    const int* __restrict__ inp_p, const int* __restrict__ gen_p,
    const int* __restrict__ rem_p, const int* __restrict__ blk_p,
    const double* __restrict__ ft_p, const bool* __restrict__ tr_p,
    const int* __restrict__ cmax_p, int* __restrict__ pre_o,
    bool* __restrict__ dec_o, int* __restrict__ k_o, double* __restrict__ end_o,
    int* __restrict__ gen_o, int* __restrict__ rem_o, double* __restrict__ ft_o,
    bool* __restrict__ trn_o, bool* __restrict__ tra_o, bool* __restrict__ comp_o,
    int I, int S, double w, double h, int chunk) {
  __shared__ unsigned long long s_u64[kWarps];
  __shared__ int s_i32[kWarps];
  __shared__ unsigned s_u32[kWarps];

  const int row = blockIdx.x;  // pool * I + instance
  const long long base = static_cast<long long>(row) * S;
  const double t_limit = *t_limit_p;
  const bool busy = busy_p[row];
  const double now = now_p[row];
  const int free_blocks = free_p[row];
  const int c_max = cmax_p[row / I];
  const double t_it = __fma_rn(h, static_cast<double>(nact_p[row]), w);

  // 1) oldest prefilling slot: lexicographic min of (sq, slot) over pmask;
  // rows without one pick slot 0, as jnp.argmin of an all-2^30 row does.
  unsigned long long best = ULLONG_MAX;
  int any_pre = 0;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const bool pm = occ_p[base + s] && pre_p[base + s] > 0;
    const int key = pm ? sq_p[base + s] : kBigI;
    const unsigned long long ord = static_cast<unsigned>(key) ^ 0x80000000u;  // signed order
    const unsigned long long cand = (ord << 32) | static_cast<unsigned>(s);
    best = cand < best ? cand : best;
    any_pre |= pm ? 1 : 0;
  }
  best = block_reduce(best, MinU64(), s_u64);
  any_pre = block_reduce(any_pre, OrI32(), s_i32);
  const int oldest = static_cast<int>(best & 0xffffffffull);
  const bool has_pre = any_pre != 0 && busy;
  const int take = min(pre_p[base + oldest], chunk);

  // 2) event-distance k-jump
  int k_complete = kBigI, k_trunc = kBigI;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const int pre_a = (s == oldest && has_pre) ? wrap_sub(pre_p[base + s], take) : pre_p[base + s];
    const int rem = rem_p[base + s];
    if (occ_p[base + s] && pre_a == 0 && rem > 0) {
      k_complete = min(k_complete, rem);
      k_trunc = min(k_trunc, wrap_sub(c_max, wrap_add(inp_p[base + s], gen_p[base + s])));
    }
  }
  k_complete = block_reduce(k_complete, MinI32(), s_i32);
  k_trunc = block_reduce(k_trunc, MinI32(), s_i32);
  const double q = __ddiv_rn(__dsub_rn(t_limit, now), t_it);
  const double k_time = isfinite(q) ? ceil(__dsub_rn(q, 1e-9)) : kBigF;
  double kd = static_cast<double>(min(k_complete, k_trunc));
  kd = kd < k_time ? kd : k_time;
  kd = has_pre ? 1.0 : (kd > 1.0 ? kd : 1.0);
  kd = kd < static_cast<double>(kBigI) ? kd : static_cast<double>(kBigI);
  int k = static_cast<int>(kd);

  // 3) KV growth over-check: with too little free space the round is one
  // iteration long
  unsigned growth = 0;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const bool occ = occ_p[base + s];
    const int pre_a = (s == oldest && has_pre) ? wrap_sub(pre_p[base + s], take) : pre_p[base + s];
    const bool dec = occ && pre_a == 0 && rem_p[base + s] > 0;
    const int ng = wrap_add(gen_p[base + s], dec ? k : 0);
    const int nd = occ ? blocks_for(wrap_add(inp_p[base + s], ng)) : 0;
    const int d = wrap_sub(nd, blk_p[base + s]);
    growth += static_cast<unsigned>(d > 0 ? d : 0);
  }
  growth = block_reduce(growth, SumU32(), s_u32);
  if (busy && static_cast<int>(growth) > free_blocks) k = 1;
  const double end = __fma_rn(static_cast<double>(k), t_it, now);

  // 4) advance + stage completion/truncation for the record scatter
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const long long j = base + s;
    const bool occ = occ_p[j];
    const int pre_a = (s == oldest && has_pre) ? wrap_sub(pre_p[j], take) : pre_p[j];
    const int rem = rem_p[j];
    const bool dec = occ && pre_a == 0 && rem > 0;
    const int kcol = dec ? k : 0;
    const int gen_a = wrap_add(gen_p[j], kcol);
    int rem_a = wrap_sub(rem, kcol);
    const double ft = ft_p[j];
    const bool trunc = dec && wrap_add(inp_p[j], gen_a) >= c_max && rem_a > 0 && busy;
    if (trunc) rem_a = 0;
    pre_o[j] = pre_a;
    dec_o[j] = dec;
    gen_o[j] = gen_a;
    rem_o[j] = rem_a;
    ft_o[j] = (dec && isnan(ft)) ? __dadd_rn(now, t_it) : ft;
    trn_o[j] = trunc;
    tra_o[j] = tr_p[j] || trunc;
    comp_o[j] = dec && rem_a == 0 && busy;
  }
  if (threadIdx.x == 0) {
    k_o[row] = k;
    end_o[row] = end;
  }
}

}  // namespace

extern "C" int sim_decode_advance(
    const void* t_limit, const void* busy, const void* now, const void* nact,
    const void* free_blocks, const void* occ, const void* pre, const void* sq,
    const void* inp, const void* gen, const void* rem, const void* blk,
    const void* ft, const void* tr, const void* c_max, void* pre_o,
    void* dec_o, void* k_o, void* end_o, void* gen_o, void* rem_o, void* ft_o,
    void* trn_o, void* tra_o, void* comp_o, int P, int I, int S, double w,
    double h, int chunk, void* stream) {
  if (P <= 0 || I <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  decode_advance_kernel<<<P * I, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t_limit), static_cast<const bool*>(busy),
      static_cast<const double*>(now), static_cast<const int*>(nact),
      static_cast<const int*>(free_blocks), static_cast<const bool*>(occ),
      static_cast<const int*>(pre), static_cast<const int*>(sq),
      static_cast<const int*>(inp), static_cast<const int*>(gen),
      static_cast<const int*>(rem), static_cast<const int*>(blk),
      static_cast<const double*>(ft), static_cast<const bool*>(tr),
      static_cast<const int*>(c_max), static_cast<int*>(pre_o),
      static_cast<bool*>(dec_o), static_cast<int*>(k_o),
      static_cast<double*>(end_o), static_cast<int*>(gen_o),
      static_cast<int*>(rem_o), static_cast<double*>(ft_o),
      static_cast<bool*>(trn_o), static_cast<bool*>(tra_o),
      static_cast<bool*>(comp_o), I, S, w, h, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Fused DES decode-advance round for Hopper (sm_90a): one round of the
// torch fleet-simulator tier over the stacked (G, P, I, S) slot arrays of G
// grid lanes.
//
// Replaces: src/repro/kernels/sim_decode.py::decode_advance_pallas (body
// _decode_kernel, grid (I,), one (1, S) slot row per program), the compiled
// DES tier's decode-advance round, the reference engine's per-pool restack
// around it, and the vmap over grid lanes that run_fleet_grid puts around
// both: here one launch covers every lane and every pool, with c_max a
// per-pool int32 array and t_limit one float64 per lane. A single fleet run
// is G = 1.
//
// Per (lane, pool, instance) row, row = ((g * P) + p) * I + i, which reads
// c_max[(row / I) % P] and t_limit[row / (P * I)]: feed one prefill chunk
// to the oldest prefilling slot (first-index argmin of sq over occ &
// pre > 0); compute the event-distance k-jump min(min rem, min(c_max - ctx),
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
// byte; at the fleet shapes (a few hundred rows of at most 128 slots a
// lane) one lane's pass moves under 3 MB, so a launch is microseconds of memory
// traffic and, in practice, launch latency.
//
// What this design does about it: the first design (one 128-thread CTA a
// row, five block reductions with two barriers each, four passes that each
// re-read the slot fields as scalars) ran at ~1/11 of that bound. Here:
//   * One warp per (lane, pool, instance) row, four rows per 128-thread CTA
//     (112 CTAs at the Table-2 shape (1, 2, 224, 128), 1,792 at sixteen
//     lanes); warps of rows past the end return at once.
//   * Each lane holds four consecutive slots. A row of up to 128 slots is
//     read once, into registers: int32 fields as int4, four bools as one
//     32-bit word, ft as two double2, where S % 4 == 0 and every slot
//     tensor is 16-byte aligned (checked on the host); otherwise, and for
//     the quad past S, element by element. Longer rows walk 128-slot
//     segments, re-reading each segment per phase.
//   * Reductions are __shfl_xor_sync butterflies: no shared memory, no
//     barrier. The completion and truncation minima are one min (only
//     their minimum is used), taken in the argmin's pass and butterfly
//     (exact: see phase 1), so a round walks its slots three times, from
//     registers, and reduces twice: the (sq, slot) argmin with the
//     any-prefill OR and the k minimum, then the growth sum. The oldest
//     slot's pre comes from its lane by a shuffle.
//   * Outputs are written as they were read: int4, 32-bit words of bools,
//     double2.
// At the Table-2 shape the work is 57,344 stacked slots of which 12,800
// are real (72 x 128 short + 224 x 16 long): the padding is read and
// written as the engine stacks it.
// What still bounds it: latency, not bytes. A warp's round is one wait for
// its loads, ~1.5 k cycles of dependent work over four slots a lane, and
// its stores; measured per phase on an H100 the loads and the store phase
// each take about as long as the work between them, whatever the number
// of rows a CTA holds (1, 2 and 4 measured alike, 8 slower), so the round
// runs at about the first design's time (PERF.md).
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 4;  // rows (warps) per CTA
constexpr int kThreads = 32 * kRows;
constexpr int kSeg = 128;  // slots a warp holds at once: four a lane
constexpr int kBigI = 1 << 30;
constexpr double kBigF = 1.0e18;
constexpr int kBlockTokens = 16;  // KV_BLOCK_TOKENS
constexpr unsigned kAll = 0xffffffffu;

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

struct SlotIn {
  const bool* occ;
  const int *pre, *sq, *inp, *gen, *rem, *blk;
  const double* ft;
  const bool* tr;
};

struct SlotOut {
  int *pre, *gen, *rem;
  bool *dec, *trn, *tra, *comp;
  double* ft;
};

// One lane's four consecutive slots of a row, in registers. Slots past the
// row's end read as unoccupied and hold no blocks, so they add nothing.
struct Quad {
  int n;  // live slots, 0-4
  bool occ[4], tr[4];
  int pre[4], sq[4], inp[4], gen[4], rem[4], blk[4];
  double ft[4];

  __device__ __forceinline__ void load(const SlotIn& in, long long j, int live, bool vec) {
    n = live < 0 ? 0 : (live > 4 ? 4 : live);
    // Tested on live itself, not as n == 4: nvcc 12.8 folded the clamp and
    // that test into one VIMNMX.RELU whose predicate also held at live == 0,
    // so the lane whose slots start at the row's end read 16 bytes past it,
    // past the tensor in its last row (ROADMAP C, R3).
    if (vec && live >= 4) {
      const unsigned o = *reinterpret_cast<const unsigned*>(in.occ + j);
      const unsigned r = *reinterpret_cast<const unsigned*>(in.tr + j);
      const int4 p = *reinterpret_cast<const int4*>(in.pre + j);
      const int4 q = *reinterpret_cast<const int4*>(in.sq + j);
      const int4 a = *reinterpret_cast<const int4*>(in.inp + j);
      const int4 gn = *reinterpret_cast<const int4*>(in.gen + j);
      const int4 rm = *reinterpret_cast<const int4*>(in.rem + j);
      const int4 b = *reinterpret_cast<const int4*>(in.blk + j);
      const double2 f0 = *reinterpret_cast<const double2*>(in.ft + j);
      const double2 f1 = *reinterpret_cast<const double2*>(in.ft + j + 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        occ[i] = (o >> (8 * i)) & 0xffu;
        tr[i] = (r >> (8 * i)) & 0xffu;
      }
      pre[0] = p.x, pre[1] = p.y, pre[2] = p.z, pre[3] = p.w;
      sq[0] = q.x, sq[1] = q.y, sq[2] = q.z, sq[3] = q.w;
      inp[0] = a.x, inp[1] = a.y, inp[2] = a.z, inp[3] = a.w;
      gen[0] = gn.x, gen[1] = gn.y, gen[2] = gn.z, gen[3] = gn.w;
      rem[0] = rm.x, rem[1] = rm.y, rem[2] = rm.z, rem[3] = rm.w;
      blk[0] = b.x, blk[1] = b.y, blk[2] = b.z, blk[3] = b.w;
      ft[0] = f0.x, ft[1] = f0.y, ft[2] = f1.x, ft[3] = f1.y;
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = i < n;
      occ[i] = ok && in.occ[j + i];
      tr[i] = ok && in.tr[j + i];
      pre[i] = ok ? in.pre[j + i] : 0;
      sq[i] = ok ? in.sq[j + i] : kBigI;
      inp[i] = ok ? in.inp[j + i] : 0;
      gen[i] = ok ? in.gen[j + i] : 0;
      rem[i] = ok ? in.rem[j + i] : 0;
      blk[i] = ok ? in.blk[j + i] : 0;
      ft[i] = ok ? in.ft[j + i] : 0.0;
    }
  }

};

__device__ __forceinline__ unsigned pack4(const bool (&v)[4]) {
  return static_cast<unsigned>(v[0]) | static_cast<unsigned>(v[1]) << 8 |
         static_cast<unsigned>(v[2]) << 16 | static_cast<unsigned>(v[3]) << 24;
}

template <bool kOne>
__global__ void __launch_bounds__(kThreads) decode_advance_kernel(
    const double* __restrict__ t_limit_p, const bool* __restrict__ busy_p,
    const double* __restrict__ now_p, const int* __restrict__ nact_p,
    const int* __restrict__ free_p, SlotIn in, const int* __restrict__ cmax_p,
    SlotOut out, int* __restrict__ k_o, double* __restrict__ end_o, int rows, int P,
    int I, int S, double w, double h, int chunk, bool vec) {
  const int lane = threadIdx.x & 31;
  // (grid lane * P + pool) * I + instance
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = static_cast<long long>(row) * S;

  // With kOne the row (S <= 128) is read once; otherwise each phase walks
  // the row's segments and reads each again.
  Quad q;
  if (kOne) q.load(in, base + 4 * lane, S - 4 * lane, vec);
  const double t_limit = t_limit_p[row / (P * I)];
  const bool busy = busy_p[row];
  const double now = now_p[row];
  const int free_blocks = free_p[row];
  const int c_max = cmax_p[(row / I) % P];
  const double t_it = __fma_rn(h, static_cast<double>(nact_p[row]), w);
  // The time limit's k needs only the row's scalars.
  const double qt = __ddiv_rn(__dsub_rn(t_limit, now), t_it);
  const double k_time = isfinite(qt) ? ceil(__dsub_rn(qt, 1e-9)) : kBigF;
  auto seg = [&](int s0) {
    if (!kOne) q.load(in, base + s0 + 4 * lane, S - s0 - 4 * lane, vec);
  };

  // 1) oldest prefilling slot: lexicographic min of (sq, slot) over pmask;
  // rows without one pick slot 0, as jnp.argmin of an all-2^30 row does.
  // In the same pass, the event-distance minimum over decoding slots: the
  // least of rem and c_max - ctx, one min. It counts slots with pre == 0,
  // not pre after the chunk is fed: the two differ only where the row feeds
  // a chunk (has_pre), and then k is 1 whatever the minimum.
  unsigned long long best = ULLONG_MAX;
  int any_pre = 0, k_min = kBigI;
  for (int s0 = 0; s0 < S; s0 += kSeg) {
    seg(s0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= q.n) break;
      const bool pm = q.occ[i] && q.pre[i] > 0;
      const int key = pm ? q.sq[i] : kBigI;
      const unsigned long long ord = static_cast<unsigned>(key) ^ 0x80000000u;  // signed order
      const unsigned long long cand = (ord << 32) | static_cast<unsigned>(s0 + 4 * lane + i);
      best = cand < best ? cand : best;
      any_pre |= pm ? 1 : 0;
      if (q.occ[i] && q.pre[i] == 0 && q.rem[i] > 0) {
        k_min = min(k_min, q.rem[i]);
        k_min = min(k_min, wrap_sub(c_max, wrap_add(q.inp[i], q.gen[i])));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ob = __shfl_xor_sync(kAll, best, o);
    best = ob < best ? ob : best;
    any_pre |= __shfl_xor_sync(kAll, any_pre, o);
    k_min = min(k_min, __shfl_xor_sync(kAll, k_min, o));
  }
  const int oldest = static_cast<int>(best & 0xffffffffull);
  const bool has_pre = any_pre != 0 && busy;
  int pre_oldest;
  if (kOne) {  // from the lane that holds it
    const int e = oldest & 3;
    const int mine = e == 0 ? q.pre[0] : e == 1 ? q.pre[1] : e == 2 ? q.pre[2] : q.pre[3];
    pre_oldest = __shfl_sync(kAll, mine, oldest >> 2);
  } else {
    pre_oldest = in.pre[base + oldest];
  }
  const int take = min(pre_oldest, chunk);
  auto pre_after = [&](int i, int s0) {
    return (s0 + 4 * lane + i == oldest && has_pre) ? wrap_sub(q.pre[i], take) : q.pre[i];
  };

  // 2) event-distance k-jump
  double kd = static_cast<double>(k_min);
  kd = kd < k_time ? kd : k_time;
  kd = has_pre ? 1.0 : (kd > 1.0 ? kd : 1.0);
  kd = kd < static_cast<double>(kBigI) ? kd : static_cast<double>(kBigI);
  int k = static_cast<int>(kd);

  // 3) KV growth over-check: with too little free space the round is one
  // iteration long
  unsigned growth = 0;
  for (int s0 = 0; s0 < S; s0 += kSeg) {
    seg(s0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= q.n) break;
      const bool dec = q.occ[i] && pre_after(i, s0) == 0 && q.rem[i] > 0;
      const int ng = wrap_add(q.gen[i], dec ? k : 0);
      const int nd = q.occ[i] ? blocks_for(wrap_add(q.inp[i], ng)) : 0;
      const int d = wrap_sub(nd, q.blk[i]);
      growth += static_cast<unsigned>(d > 0 ? d : 0);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) growth += __shfl_xor_sync(kAll, growth, o);
  if (busy && static_cast<int>(growth) > free_blocks) k = 1;
  const double end = __fma_rn(static_cast<double>(k), t_it, now);

  // 4) advance + stage completion/truncation for the record scatter
  for (int s0 = 0; s0 < S; s0 += kSeg) {
    seg(s0);
    if (q.n == 0) continue;
    int pre_a[4], gen_a[4], rem_a[4];
    bool dec[4], trunc[4], tra[4], comp[4];
    double ft_a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pre_a[i] = pre_after(i, s0);
      dec[i] = q.occ[i] && pre_a[i] == 0 && q.rem[i] > 0;
      const int kcol = dec[i] ? k : 0;
      gen_a[i] = wrap_add(q.gen[i], kcol);
      rem_a[i] = wrap_sub(q.rem[i], kcol);
      trunc[i] = dec[i] && wrap_add(q.inp[i], gen_a[i]) >= c_max && rem_a[i] > 0 && busy;
      if (trunc[i]) rem_a[i] = 0;
      ft_a[i] = (dec[i] && isnan(q.ft[i])) ? __dadd_rn(now, t_it) : q.ft[i];
      tra[i] = q.tr[i] || trunc[i];
      comp[i] = dec[i] && rem_a[i] == 0 && busy;
    }
    const long long j = base + s0 + 4 * lane;
    if (vec && q.n == 4) {
      *reinterpret_cast<int4*>(out.pre + j) = make_int4(pre_a[0], pre_a[1], pre_a[2], pre_a[3]);
      *reinterpret_cast<int4*>(out.gen + j) = make_int4(gen_a[0], gen_a[1], gen_a[2], gen_a[3]);
      *reinterpret_cast<int4*>(out.rem + j) = make_int4(rem_a[0], rem_a[1], rem_a[2], rem_a[3]);
      *reinterpret_cast<double2*>(out.ft + j) = make_double2(ft_a[0], ft_a[1]);
      *reinterpret_cast<double2*>(out.ft + j + 2) = make_double2(ft_a[2], ft_a[3]);
      *reinterpret_cast<unsigned*>(out.dec + j) = pack4(dec);
      *reinterpret_cast<unsigned*>(out.trn + j) = pack4(trunc);
      *reinterpret_cast<unsigned*>(out.tra + j) = pack4(tra);
      *reinterpret_cast<unsigned*>(out.comp + j) = pack4(comp);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= q.n) break;
        out.pre[j + i] = pre_a[i];
        out.gen[j + i] = gen_a[i];
        out.rem[j + i] = rem_a[i];
        out.ft[j + i] = ft_a[i];
        out.dec[j + i] = dec[i];
        out.trn[j + i] = trunc[i];
        out.tra[j + i] = tra[i];
        out.comp[j + i] = comp[i];
      }
    }
  }
  if (lane == 0) {
    k_o[row] = k;
    end_o[row] = end;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int sim_decode_advance(
    const void* t_limit, const void* busy, const void* now, const void* nact,
    const void* free_blocks, const void* occ, const void* pre, const void* sq,
    const void* inp, const void* gen, const void* rem, const void* blk,
    const void* ft, const void* tr, const void* c_max, void* pre_o,
    void* dec_o, void* k_o, void* end_o, void* gen_o, void* rem_o, void* ft_o,
    void* trn_o, void* tra_o, void* comp_o, int G, int P, int I, int S, double w,
    double h, int chunk, void* stream) {
  if (G <= 0 || P <= 0 || I <= 0 || S <= 0 || static_cast<long long>(G) * P * I > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const SlotIn in{static_cast<const bool*>(occ), static_cast<const int*>(pre),
                  static_cast<const int*>(sq),   static_cast<const int*>(inp),
                  static_cast<const int*>(gen),  static_cast<const int*>(rem),
                  static_cast<const int*>(blk),  static_cast<const double*>(ft),
                  static_cast<const bool*>(tr)};
  const SlotOut out{static_cast<int*>(pre_o),  static_cast<int*>(gen_o),
                    static_cast<int*>(rem_o),  static_cast<bool*>(dec_o),
                    static_cast<bool*>(trn_o), static_cast<bool*>(tra_o),
                    static_cast<bool*>(comp_o), static_cast<double*>(ft_o)};
  // 16-byte vectors where every slot row starts on a 16-byte boundary
  const void* const slot_ptrs[] = {occ,   pre,   sq,   inp,  gen,   rem,   blk,  ft,   tr,
                                   pre_o, dec_o, gen_o, rem_o, ft_o, trn_o, tra_o, comp_o};
  bool vec = S % 4 == 0;
  for (const void* p : slot_ptrs) vec = vec && aligned16(p);
  const int rows = G * P * I;
  const int grid = (rows + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* tl = static_cast<const double*>(t_limit);
  const bool* bz = static_cast<const bool*>(busy);
  const double* nw = static_cast<const double*>(now);
  const int* na = static_cast<const int*>(nact);
  const int* fb = static_cast<const int*>(free_blocks);
  const int* cm = static_cast<const int*>(c_max);
  int* ko = static_cast<int*>(k_o);
  double* eo = static_cast<double*>(end_o);
  if (S <= kSeg)
    decode_advance_kernel<true><<<grid, kThreads, 0, s>>>(
        tl, bz, nw, na, fb, in, cm, out, ko, eo, rows, P, I, S, w, h, chunk, vec);
  else
    decode_advance_kernel<false><<<grid, kThreads, 0, s>>>(
        tl, bz, nw, na, fb, in, cm, out, ko, eo, rows, P, I, S, w, h, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

// Prefill attention for Hopper (sm_90a): causal or full, GQA, online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel), the TPU kernel whose jnp twin the reference model
// runs at prefill (models/layers.py::flash_attention).
//
// What bounds it on an H100: operations. Causal prefill does
// 2 * 2 * B * H * L^2/2 * D multiply-adds against B * (H + 2K) * L * D
// inputs, hundreds of FLOPs per byte at L >= 512, so the card's matrix rate
// is the ceiling (989 TFLOP/s bf16 on tensor cores).
//
// What this design does about it (first, simple version):
//   * The TPU kernel walks key blocks as a sequential grid axis that carries
//     m / l / acc in VMEM. Here one CTA owns one (batch, head, 64-row query
//     block) and walks the key blocks in a loop, keeping the query tile,
//     one key tile and one value tile in shared memory (f32, rows padded by
//     one word so the column walks hit distinct banks) and m / l / acc in
//     registers.
//   * GQA is folded the reference way (kv_head = h / G): the G query heads
//     of one KV head read the same K/V rows; K/V are never replicated.
//   * Causal key blocks above the diagonal are never loaded or computed.
//   * Any length works: rows and columns past L are zero-filled and masked,
//     so the serving engine's 64-token prompt buckets need no padding here.
//   * Tiles are loaded with 16-byte vector loads (rows must start 16-byte
//     aligned: D a multiple of 8, base pointers 16-byte aligned). Head
//     dims 32, 64, 80 (zamba2's shared attention), 128 and 256 are
//     instantiated; at D = 80 a thread holds 20 output columns and a bf16
//     row is ten 16-byte loads.
//   * Products run on the CUDA cores in f32 (four threads per query row,
//     16 score columns each, shuffles for the row max and sum). This leaves
//     the tensor cores idle; moving QK^T and PV onto wgmma with TMA-fed
//     tiles is the next step for this kernel.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the cudaError_t of the launch (0 on success).

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::load16;
using repro::store;

constexpr int kBlock = 64;     // query rows and key columns per tile
constexpr int kThreads = 256;  // four threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KH, int Lq, int Lk, int causal, float scale) {
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

  const T* qg = q + (size_t)(b * H + h) * Lq * D;
  const T* kg = k + (size_t)(b * KH + kvh) * Lk * D;
  const T* vg = v + (size_t)(b * KH + kvh) * Lk * D;

  constexpr int V = repro::Vec16<T>::n;  // elements per 16-byte load
  constexpr int CH = D / V;               // 16-byte chunks per row
  for (int i = tid; i < kBlock * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * V;
    float x[V];
    if (q0 + r < Lq) {
      load16(qg + (size_t)(q0 + r) * D + c, x);
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
        load16(kg + (size_t)(k0 + r) * D + c, kx);
        load16(vg + (size_t)(k0 + r) * D + c, vx);
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
    T* og = o + ((size_t)(b * H + h) * Lq + qpos) * D + sub;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) store(acc[i] / denom, og + 4 * i);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int Lq, int Lk, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * kBlock * (D + 1) + kBlock * (kBlock + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlock - 1) / kBlock, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Lq, Lk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KH, int Lq, int Lk, int D,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, KH, Lq, Lk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KH, Lq, Lk, causal, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, KH, Lq, Lk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KH, Lq, Lk, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KH, Lq, Lk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,H,Lq,D), k/v (B,KH,Lk,D), o like q,
// all contiguous and of one dtype.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KH, int Lq, int Lk, int D, int causal,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  if (causal && Lq != Lk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, B, H, KH, Lq, Lk, D, causal, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, KH, Lq, Lk, D, causal,
                                    scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

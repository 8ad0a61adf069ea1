// Tile layout, wgmma descriptors and host-side TMA maps shared by the
// flash kernel (flash_attention.cu) and its backward
// (flash_attention_bwd.cu): bf16 tiles of 64 rows of one head, D
// contiguous, loaded by TMA in swizzled boxes.
//   * D = 64, 128, 256: 128-byte swizzled boxes of 64 columns (one, two or
//     four a tile). D = 80: a row is 160 bytes, which no 128-byte box
//     divides, so 32-byte swizzled boxes of 16 columns, five a tile: no
//     padding, the same descriptors with the 32-byte layout, and a k-step
//     of a D-deep product is exactly one box.
//   * One tile serves as a K-major operand (D is the product's depth:
//     kmajor_desc) and as an MN-major one (D is its width: vmajor_desc,
//     read through wgmma's transpose-B flag).
//   * Operands are read through strides: the maps order the three outer
//     dims (L, head, batch) by stride, so the model's (B, L, H, D) layout
//     needs no copy. Maps are encoded on the host per call through the
//     driver's cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint
//     (the libraries link no libcuda), and passed as __grid_constant__
//     kernel parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace repro {

constexpr int kTileRows = 64;  // rows of a tile, and of a TMA box

// Element strides of one operand viewed as (B, heads, L, D), D contiguous.
struct Strides {
  long long b, h, l;
};

// Sets a kernel's dynamic shared-memory cap once per device.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

template <int D>
struct TileLayout {
  static constexpr int SW = (D % 64 == 0) ? 128 : 32;  // swizzle span, bytes
  static constexpr int MODE = SW == 128 ? 1 : 3;       // descriptor code
  static constexpr int BOX = SW / 2;                   // bf16 columns a box
  static constexpr int NB = D / BOX;                   // boxes per tile
  static constexpr int BOX_BYTES = kTileRows * SW;
  static constexpr int TILE = kTileRows * D * 2;       // bytes of a tile
  static_assert(D % BOX == 0 && D % 16 == 0, "head dim");
};

// Descriptor of k-step kk (16 columns of D) of a K-major 64-row tile.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using S = TileLayout<D>;
  const uint32_t col = kk * 16;
  const uint32_t addr =
      tile + (col / S::BOX) * S::BOX_BYTES + (col % S::BOX) * 2;
  return wgmma_desc(addr, 16, 8 * S::SW, S::MODE);
}

// Descriptor of k-step kk (16 rows) of a tile as the MN-major B of a
// product whose width is D: leading offset = next box along D, stride
// offset = next 8 rows.
template <int D>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t tile, int kk) {
  using S = TileLayout<D>;
  return wgmma_desc(tile + kk * 16 * S::SW, S::BOX_BYTES, 8 * S::SW, S::MODE);
}

// Tensor-map coordinate order of one operand: which of dims 1..3 of the
// map holds L, the head and the batch (dims sorted by stride).
struct MapOrder {
  int l, h, b;
};

__device__ __forceinline__ void coords(const MapOrder& ord, int l, int h,
                                       int b, int* c) {
  c[ord.l] = l;
  c[ord.h] = h;
  c[ord.b] = b;
}

// Loads the 64-row tile at row l of (head h, batch b) into dst (NB boxes),
// completing on bar.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              const MapOrder& ord, uint64_t* bar,
                                              int l, int h, int b) {
  using S = TileLayout<D>;
  int c[4];
  coords(ord, l, h, b, c);
#pragma unroll
  for (int i = 0; i < S::NB; ++i)
    tma_load_4d(dst + i * S::BOX_BYTES, map, bar, i * S::BOX, c[1], c[2], c[3]);
}

// cuTensorMapEncodeTiled's signature (CUDA driver API, cuda.h).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over one bf16 operand viewed as (B, heads, L, D): dim 0 is D,
// dims 1..3 are L, the head and the batch in increasing stride. A box is
// BOX columns of 64 rows of one head of one batch; rows past L read as 0.
template <int D>
cudaError_t encode(CUtensorMap* map, MapOrder* ord, const void* ptr,
                   Strides st, int B, int heads, int L) {
  using S = TileLayout<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  struct Dim {
    long long stride;
    int size, box, which;  // which: 0 = L, 1 = head, 2 = batch
  } dims[3] = {{st.l, L, kTileRows, 0}, {st.h, heads, 1, 1}, {st.b, B, 1, 2}};
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t size[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t stride[3];
  cuuint32_t box[4] = {(cuuint32_t)S::BOX, 0, 0, 0};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  int* slot[3] = {&ord->l, &ord->h, &ord->b};
  for (int i = 0; i < 3; ++i) {
    size[i + 1] = (cuuint64_t)dims[i].size;
    stride[i] = (cuuint64_t)dims[i].stride * 2;
    box[i + 1] = (cuuint32_t)dims[i].box;
    *slot[dims[i].which] = i + 1;
  }
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), size,
      stride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      S::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace repro

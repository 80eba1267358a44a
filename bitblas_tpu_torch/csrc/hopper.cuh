// Hopper (sm_90a) building blocks shared by the kernels that load tiles
// with the Tensor Memory Accelerator and multiply them with wgmma
// (flash_attention.cu, dense_matmul.cu, dequant_wgmma.cuh): mbarriers, TMA
// tile loads, the host-side tensor-map encoding, wgmma shared-memory
// descriptors and the wgmma fences.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace bbt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA tile loads ----------------------------------------------------------

// One box of a 2-D tensor map at coordinates (c0 innermost, c1) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same for a 3-D tensor map.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// wgmma shared-memory descriptor of a K-major (or one-atom MN-major) tile
// with the 128-byte swizzle: rows of 128 bytes in 8-row groups of 1024
// bytes. The contiguous extent of one wgmma (32 bytes: k16 of f16/bf16,
// k32 of int8) lies inside one swizzle atom, so only the stride between
// 8-row groups matters; it goes in both offset fields, whichever the
// layout reads. A step of k within the atom adds its byte offset to
// `addr`; tiles start 1024-byte aligned (base offset 0).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory, then read by wgmma or TMA (the
// async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from touching accumulators across an async wgmma,
// and an A fragment's registers alive until the wgmma reading them is
// waited for.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

// -- tensor maps (host) ------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so the library
// needs no -lcuda. nullptr if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] matrix of `elem_bytes`-byte elements in boxes
// of `box_rows` rows x `box_bytes` bytes (32, 64 or 128), swizzled by that
// width (TMA's 32-, 64- or 128-byte swizzle); reads past either edge are
// zero-filled (and still count toward the barrier's bytes).
inline bool make_map_2d_sw(EncodeTiled encode, CUtensorMap* map,
                           const void* ptr, CUtensorMapDataType type,
                           int elem_bytes, long long rows, long long cols,
                           int box_rows, int box_bytes) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw = box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  if (box_bytes != 32 && box_bytes != 64 && box_bytes != 128) return false;
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An N-D tensor (dims[0] innermost, `strides` in bytes of dims 1..N-1,
// each a multiple of 16) in boxes of `box` elements, the innermost 128
// bytes wide, 128-byte swizzle; reads past any edge are zero-filled (and
// still count toward the barrier's bytes).
inline bool make_map_nd_sw128(EncodeTiled encode, CUtensorMap* map,
                              const void* ptr, CUtensorMapDataType type,
                              int rank, const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same in boxes of 128 bytes, 128-byte swizzle.
inline bool make_map_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                        CUtensorMapDataType type, int elem_bytes,
                        long long rows, long long cols, int box_rows) {
  return make_map_2d_sw(encode, map, ptr, type, elem_bytes, rows, cols,
                        box_rows, 128);
}

// A row-major [rows, cols] matrix in unswizzled boxes of `box_rows` rows x
// `box_cols` elements (box_cols * elem_bytes a multiple of 16, at most 256
// elements a side); reads past either edge are zero-filled.
inline bool make_map_2d_box(EncodeTiled encode, CUtensorMap* map,
                            const void* ptr, CUtensorMapDataType type,
                            int elem_bytes, long long rows, long long cols,
                            int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace bbt

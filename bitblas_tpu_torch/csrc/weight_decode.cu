// weight_decode_u4: Wd[N, K] = (q - z) * s (zeros mode original) or
// q * s - z (rescale), the GPTQ uint4 weight decoded to a dense operand in
// float16, bfloat16 or float32.
//
// Replaces bitblas_tpu/kernels/materialize.py:make_weight_decode_pallas
// (its pallas_call at :378) for uint4 weights with grouped scales and
// zeros (g = 8 j for any j that divides K / 8: GPTQ's 32, 64, 128, per
// channel): the decode half of the two-pass "materialize" plan, whose
// dense half is torch.matmul (kernels/materialize.py; the bias is added
// after it, in f32).
//
// Operands (layout of quantization/packing.py, "Hopper device layout"):
//   Wq     [N, K/8]  int32, eight uint4 codes per word along K, LSB first
//   scales [K/g, N]  float16      zeros [K/g, N] float16
//   out    [N, K]    row-major (JAX writes [K, N]; [N, K] makes
//                    torch.matmul(A, out.T) the nt product)
// float16 output is (q - z) * s (q * s - z) in float16 arithmetic, each
// op rounded, bit-identical to dequantize_hopper
// (kernels/dequant_matmul.py) and to the fused kernel's
// decoded tile, so the two routes differ only in the order of their sums.
// bfloat16 and float32 follow JAX's single rounding: the float32 value,
// then one cast.
//
// What bounds it: bytes. It reads N*K/2 + 4*N*K/g and writes N*K*2 (f16)
// or N*K*4 (f32) at 3.35 TB/s; there is no reuse to exploit. Design: a
// grid-stride loop with one packed word per thread per iteration, so a
// warp reads 128 consecutive bytes of Wq and writes 512 (f16) consecutive
// bytes of out with 16-byte stores; the scale and zero of word j's group j
// * 8 / g are shared by g / 8 neighbouring threads (a broadcast) and stay
// in L2.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// RESCALE: q * s - z, else (q - z) * s, each op rounded in f16
template <bool RESCALE>
__device__ __forceinline__ half deq(uint32_t q, half s, half z) {
  const half h = __ushort2half_rn(q & 0xF);
  return RESCALE ? __hsub(bbt::hmul_rn(h, s), z) : __hmul(__hsub(h, z), s);
}
template <bool RESCALE>
__device__ __forceinline__ float deq(uint32_t q, float s, float z) {
  const float f = (float)(q & 0xF);
  return RESCALE ? __fmul_rn(f, s) - z : (f - z) * s;
}

template <bool RESCALE>
__device__ __forceinline__ void store8(half* dst, const uint32_t q,
                                       const half s, const half z) {
  uint32_t o[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    o[p] = bbt::pack_half2(deq<RESCALE>(q >> (8 * p), s, z),
                           deq<RESCALE>(q >> (8 * p + 4), s, z));
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
}

template <bool RESCALE>
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const uint32_t q,
                                       const half s, const half z) {
  const float sf = __half2float(s), zf = __half2float(z);
  uint32_t o[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    __nv_bfloat162 v =
        __floats2bfloat162_rn(deq<RESCALE>(q >> (8 * p), sf, zf),
                              deq<RESCALE>(q >> (8 * p + 4), sf, zf));
    o[p] = *reinterpret_cast<uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
}

template <bool RESCALE>
__device__ __forceinline__ void store8(float* dst, const uint32_t q,
                                       const half s, const half z) {
  const float sf = __half2float(s), zf = __half2float(z);
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = deq<RESCALE>(q >> (4 * i), sf, zf);
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// gw = g / 8: the words of a group
template <typename OutT, bool RESCALE>
__global__ void __launch_bounds__(256)
    weight_decode_u4_kernel(const uint32_t* __restrict__ Wq,
                            const half* __restrict__ scales,
                            const half* __restrict__ zeros,
                            OutT* __restrict__ out, int N, int K, int gw) {
  const int KW = K / 8;
  const long long words = (long long)N * KW;
  for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       w < words; w += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(w / KW), j = (int)(w % KW);
    const size_t sg = (size_t)(j / gw) * N + n;
    // out (n, 8j + i) sits at n*K + 8j + i = 8w + i
    store8<RESCALE>(out + w * 8, __ldg(Wq + w), scales[sg], zeros[sg]);
  }
}

template <typename OutT>
cudaError_t launch(const uint32_t* Wq, const half* s, const half* z,
                   void* out, int N, int K, int group, bool rescale,
                   cudaStream_t stream) {
  const long long words = (long long)N * (K / 8);
  const long long want = (words + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  auto o = static_cast<OutT*>(out);
  if (rescale)
    weight_decode_u4_kernel<OutT, true><<<blocks, 256, 0, stream>>>(
        Wq, s, z, o, N, K, group / 8);
  else
    weight_decode_u4_kernel<OutT, false><<<blocks, 256, 0, stream>>>(
        Wq, s, z, o, N, K, group / 8);
  return cudaGetLastError();
}

}  // namespace

// out_dtype: 0 float16, 1 bfloat16, 2 float32; rescale: zeros mode
// rescale, else original
extern "C" int weight_decode_u4(const void* Wq, const void* scales,
                                const void* zeros, void* out, int N, int K,
                                int group, int rescale, int out_dtype,
                                void* stream) {
  if (group < 8 || group % 8 != 0 || K % group != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  auto w = static_cast<const uint32_t*>(Wq);
  auto s = static_cast<const half*>(scales);
  auto z = static_cast<const half*>(zeros);
  auto st = static_cast<cudaStream_t>(stream);
  const bool r = rescale != 0;
  switch (out_dtype) {
    case 0: return (int)launch<half>(w, s, z, out, N, K, group, r, st);
    case 1:
      return (int)launch<__nv_bfloat16>(w, s, z, out, N, K, group, r, st);
    case 2: return (int)launch<float>(w, s, z, out, N, K, group, r, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// weight_decode_int8: sub-byte int/uint codes -> int8 [N, K].
//
// Replaces bitblas_tpu/kernels/materialize.py:make_weight_decode_int8_pallas
// (its pallas_call at :446): the decode half of the two-pass "materialize"
// plan for integer activations, whose dense half is torch._int_mm with
// int32 accumulation (kernels/materialize.py). Zero-point free: the int
// family subtracts its storage bias 2^(bits-1), the uint family keeps the
// field.
//
// Operands (layout of quantization/packing.py, "Hopper device layout"):
//   Wq   [N, K*bits/32] int32, 32/bits fields per word along K, LSB first
//   out  [N, K]         int8, row-major (JAX writes [K, N]; [N, K] makes
//                       out.T the column-major B that torch._int_mm takes)
// bits is 1, 2 (BitNet's int2) or 4.
//
// What bounds it: bytes. It reads N*K*bits/8 and writes N*K at 3.35 TB/s;
// there is no reuse to exploit. Design: a grid-stride loop with one packed
// word per thread per iteration, so a warp reads 128 consecutive bytes and
// writes 1024 (1-bit), 512 (int2) or 256 (4-bit) consecutive bytes of out
// with two 16-byte, one 16- or one 8-byte store. The int2 path spreads
// each byte with bbt::decode_i2x4, as the fused W2A8 kernel does.

#include "common.cuh"

namespace {

template <int BITS>
__device__ __forceinline__ uint32_t decode4(uint32_t q, int p, int bias) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t f = (q >> (BITS * (4 * p + b))) & ((1u << BITS) - 1);
    r |= ((f - (uint32_t)bias) & 0xFFu) << (8 * b);
  }
  return r;
}

template <int BITS>
__global__ void __launch_bounds__(256)
    weight_decode_int8_kernel(const uint32_t* __restrict__ Wq,
                              int8_t* __restrict__ out, long long words,
                              int bias) {
  constexpr int E = 32 / BITS;   // fields per word
  for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       w < words; w += (long long)gridDim.x * blockDim.x) {
    const uint32_t q = __ldg(Wq + w);
    // out (n, E*j + i) sits at n*K + E*j + i = E*w + i
    if constexpr (BITS == 1) {
      uint32_t o[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) o[p] = decode4<1>(q, p, bias);
      uint4* dst = reinterpret_cast<uint4*>(out + w * E);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else if constexpr (BITS == 2) {
      uint32_t o[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        o[p] = bias ? bbt::decode_i2x4(q >> (8 * p)) : decode4<2>(q, p, 0);
      *reinterpret_cast<uint4*>(out + w * E) =
          make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      *reinterpret_cast<uint2*>(out + w * E) =
          make_uint2(decode4<BITS>(q, 0, bias), decode4<BITS>(q, 1, bias));
    }
  }
}

template <int BITS>
cudaError_t launch(const uint32_t* Wq, int8_t* out, long long words,
                   int bias, cudaStream_t stream) {
  const long long want = (words + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  weight_decode_int8_kernel<BITS><<<blocks, 256, 0, stream>>>(Wq, out,
                                                              words, bias);
  return cudaGetLastError();
}

}  // namespace

// is_int: 1 for the int family (subtract 2^(bits-1)), 0 for uint
extern "C" int weight_decode_int8(const void* Wq, void* out, int N, int K,
                                  int bits, int is_int, void* stream) {
  if ((bits != 1 && bits != 2 && bits != 4) || N < 1 ||
      K % (32 / bits) != 0)
    return (int)cudaErrorInvalidValue;
  const long long words = (long long)N * (K / (32 / bits));
  const int bias = is_int ? 1 << (bits - 1) : 0;
  auto w = static_cast<const uint32_t*>(Wq);
  auto o = static_cast<int8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (bits == 1) return (int)launch<1>(w, o, words, bias, st);
  return bits == 2 ? (int)launch<2>(w, o, words, bias, st)
                   : (int)launch<4>(w, o, words, bias, st);
}

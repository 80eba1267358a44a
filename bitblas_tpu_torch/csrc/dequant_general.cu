// The general instances of kernels 1-3 (bitblas_tpu/kernels/
// dequant_matmul.py:make_dequant_matmul, bitblas_tpu/kernels/
// materialize.py:make_weight_decode_pallas and
// make_weight_decode_int8_pallas): every quantized configuration the JAX
// package runs that the specialized instances do not take. The weight
// formats are uint1-32, int1-32, nf4, fp4_e2m1 and fp8 e4m3 / e5m2 (packed
// int32 words for 8 bits or fewer, [N, K] int16 / int32 words for the
// wide ones); the activations and the decode type are any dense type of
// the JAX package (float16, bfloat16, float32, float64, e4m3, e5m2, int4 /
// uint4 / int8 / uint8 / int16 / uint16 / int32 / uint32, each in the torch
// storage of formats.TORCH_DTYPES); every K (a tail past the last word is
// zero codes), every group that divides K; zeros in the modes original,
// rescale and quantized (with or without scales, as JAX's oracle reads
// them).
//
// Semantics are the JAX oracle's (ops/reference.py), value for value: each
// code is decoded into the decode type D (numerics.decode_to: XLA's
// conversions, so an integer D truncates and saturates a float value and
// wraps an integer one, and e4m3 overflows to NaN), the scales and zeros
// converted to D, and (w - z) * s (rescale w * s - z; quantized (q - z)
// in the integer domain, then * s) with every op rounded to D. The decode
// is a template on D (decode_value): float16, bfloat16 and float32 carry
// D's value in a float and take each op in float32 (__fmul_rn /
// __fsub_rn, never contracted) rounded to D -- the product of two 11- or
// 8-bit significands is exact there, and a difference rounded to 24 bits,
// then to D, is D's correctly rounded difference (24 >= 2p + 2) -- with
// integers of more than 24 bits converted through a double; the integer
// types wrap and saturate in integer arithmetic; float64 and the fp8
// types keep the double path, exact for them. The format and zeros mode
// pick one instance of the per-code decode (decode_k) for a whole launch,
// and a group's scale and zero are read once for the codes that share it.
//
// dqg_matmul (kernel 1): out[M, N] (Acc) = sum_k A[m, k] W_D[n, k], Acc
// int32 (JAX's int_path: wrapping sums), float32 or float64. The caller
// (kernels/general.general_unit) names the sum unit, a fixed rule on (A's
// type, D, the sums' type) that takes the tensor cores only where they
// reproduce the oracle's sums up to their order:
//   UNIT_F16  mma.sync m16n8k16 f16, f32 sums: A and W_D both held exactly
//             by float16 (float16 itself, fp8 upcast, 8-bit integers);
//   UNIT_BF16 the same in bfloat16;
//   UNIT_S8   mma.sync m16n8k32 s8 / u8, int32 sums (wrapping, as JAX's);
//   UNIT_F64  DMMA, mma.sync m8n8k4 f64;
//   UNIT_FFMA float32 FMAs on CUDA cores, register tiles (float32 and the
//             wide integer activations, and W_D in float32: TF32 would
//             change the answer).
// What bounds it on the H100: below M ~ 64 the weight's bytes (N K bits /
// 8, up to 4 bytes a value for the 32-bit formats) and the decode's
// instructions, N K of them whatever M is; above, the products at the
// unit's rate (mma.sync f16 / s8; float32 FFMA at 67 TFLOP/s).
//
// Design (general_kernel, csrc/dequant_general.cuh). One block of 256
// threads per 64 weight rows (32 for float64) and up to MR rows of M (MR =
// 512 on the tensor-core units, 256 on FFMA, 128 on float64; 32 at M <=
// 32): the block decodes its weight tile once per step of K and multiplies
// every M tile it holds by it, so decode work is N K per launch for every
// M up to MR. Past MR the tile is decoded again for each further MR rows:
// FFMA at M > 256 (M > 128 where A is int32 / uint32, converted in shared
// memory) and float64 at M > 128, 2-4 decodes below M = 512. The ring
// holds A's MR rows for four steps, and at 512 rows of 4- or 8-byte
// elements that is 288 / 544 KB against a block's 227. Where those tiles are fewer than two an SM (small M), K is
// split over up to three blocks an SM, each summing a range of steps into
// partials that the last block of the tile adds in split order (an
// atomic counter it leaves at 0: the same sums at every call); the decode
// work stays N K. Steps of BK = 32 of K:
//   - A's rows and the packed weight words arrive by cp.async (16 or 4
//     bytes a copy as the rows' alignment allows, bytes past a row's end
//     zero-filled; plain loads where a row is not 4-byte aligned) into a
//     four-stage ring, three steps ahead;
//   - each thread decodes 8 consecutive codes of one weight row (4 for
//     float64), read from the ring at once, into the unit's operand type
//     in shared memory (double buffered), the group's scale and zero read
//     once, and converts A's tile the same way where its type is not the
//     operand's: K past the end and rows past M or N are zeros;
//   - one barrier a step: after it, the decode of step k + 1 and the
//     products of step k run side by side (other warps' products hide a
//     warp's decode);
//   - the unit's products from shared memory (mma.sync fragments by
//     ldmatrix from rows padded to avoid bank conflicts; DMMA and FFMA
//     operands as words); warps tile 2 (M) x 4 (N); FFMA: each thread 4
//     columns x MR / 16 rows.
// The caller adds the bias and casts (the oracle's `cast_output`).
// dqg_decode (kernels 2 and 3): the dense W_D [N, K] in D's storage, one
// thread an element, through the same decode_value.
#include "dequant_general.cuh"

using namespace bbt::dqg;

// part / count: scratch for a split of K (partials of the sums' type,
// part_elems of them; counters, all 0; the device's SMs), or null for none.
// unit: the sum unit (kernels/general.py UNIT_CODE: f16, bf16, s8 here;
// f64 and ffma in dequant_general_ffma.cu); acc_code: 0 int32, 1 float32,
// 2 float64 (the type of `out`, the unit's)
extern "C" int dqg_matmul(const void* A, int a_code, const void* Wq,
                          int family, int bits, const void* scales,
                          int s_code, const void* zeros, int z_code,
                          int zmode, int d_code, int acc_code, int unit,
                          void* out, int M, int N, int K, int group,
                          void* part, int part_elems, void* count,
                          int counters, int sms, void* stream) {
  const int want_acc = unit == UNIT_S8 ? 0 : unit == UNIT_F64 ? 2 : 1;
  if (!weight_ok(family, bits) || M < 1 || N < 1 || K < 1 || group < 1 ||
      K % group != 0 || acc_code != want_acc || a_code < 0 || a_code > T_U4)
    return (int)cudaErrorInvalidValue;
  const Weight W = make_weight(Wq, family, bits, scales, s_code, zeros,
                               z_code, zmode, d_code, N, K, group);
  const Split sp = {part, part_elems, static_cast<int*>(count), counters,
                    sms};
  return launch_general<true>(unit, A, a_code, W, out, M, N, K, sp,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int dqg_decode(const void* Wq, int family, int bits,
                          const void* scales, int s_code, const void* zeros,
                          int z_code, int zmode, int d_code, void* out, int N,
                          int K, int group, void* stream) {
  if (!weight_ok(family, bits) || N < 1 || K < 1 || group < 1 ||
      K % group != 0)
    return (int)cudaErrorInvalidValue;
  const Weight W = make_weight(Wq, family, bits, scales, s_code, zeros,
                               z_code, zmode, d_code, N, K, group);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dt_class(d_code)) {
    case T_F16: return launch_decode<T_F16>(W, out, N, K, st);
    case T_BF16: return launch_decode<T_BF16>(W, out, N, K, st);
    case T_F32: return launch_decode<T_F32>(W, out, N, K, st);
    case DT_INT: return launch_decode<DT_INT>(W, out, N, K, st);
    case DT_DBL: return launch_decode<DT_DBL>(W, out, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

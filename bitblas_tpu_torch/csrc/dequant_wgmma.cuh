// The tiled instances of kernel 1 (kernels/dequant_matmul.py FUSED_TILES
// past the decode instance; every fused call with M > 16 on the default
// route): one mixed-input wgmma + TMA main loop for every format,
// instantiated by dequant_matmul.cu (uint4 x f16), dequant_matmul_i2.cu
// (int2 x int8), dequant_formats.cuh (Fmt: the other float-activation
// formats) and dequant_int.cuh (IntFmt: int8 activations with uint1/2/4
// and int1/2/4 weights, scaled, zero-pointed or not, four output types).
//
// Replaces bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul (its
// pallas_call at :629) at prefill M. What it computes:
//   uint4 x f16: out[M, N] f16 = A[M, K] f16 . W^T (+ bias), W[n, k] =
//     (q - z) * s, or q * s - z (zeros mode rescale), rounded in f16
//     exactly as dequantize_hopper / the plain version decode it (so
//     kernel and plain version differ only in the order of the f32 sums),
//     f32 accumulation, the f32 bias added, one rounding to f16;
//   int2 x int8: out[M, N] f32 = the exact int32 sums of A[M, K] int8 .
//     (field - 2)^T, converted once (bit for bit the plain version).
// Operands: the Hopper layout of quantization/packing.py (Wq [N, K/8]
// int32 uint4 codes or [N, K/16] int32 biased int2 fields, K-packed, LSB
// first; scales and zeros [K/g, N] f16 for g = 32, 64, 128, a multiple
// of 256 or K; bias [N] f32 or none), A row-major, all 16-byte aligned.
// No second copy of the weight: the codes are reordered in registers.
//
// What bounds it on the H100: at M = 32 ... 64 the weight bytes (N K / 2
// or N K / 4, plus uint4's scales and zeros) over 3.35 TB/s; from M = 128
// the tensor cores, 2 M N K over 989 TFLOP/s (f16) or 1979 TOP/s (int8).
//
// Design (Machete's orientation): the transposed problem out^T[N, M] =
// W[N, K] . A[M, K]^T, the decoded weight as wgmma's register operand.
//   - A block owns BN = 64 WG weight rows and BM tokens. One producer warp
//     keeps a STAGES-deep ring of TMA boxes, each slot completing on its
//     full mbarrier: four activation boxes (BM rows x 128 bytes each, 64
//     f16 or 128 int8 of K, 128-byte swizzled, K-major: wgmma's B operand,
//     read as kernel 9 reads its W), one packed weight box (BN rows x 128
//     bytes, the same K, 128-byte swizzled so that the rows a warp reads
//     hit distinct banks) and, for uint4, the slot's scale and zero rows
//     (BN halves each), from row slot * 256 / g: 256 / g rows for g = 32
//     and 64 (the NARROW instances, 8 rows of room), else a box of two
//     rows of which the slot reads the first (g >= 256: the slot lies in
//     one group) or both (g = 128), so that g >= 128 runs with the sizes
//     and the reads it had at g = 128 alone. A slot covers 256 (uint4) or
//     512 (int2) of K: a weight box of 32-byte rows made TMA issue one
//     request for every 32 bytes, and slots that small bounded the kernel
//     at ~0.5 us a slot whatever its arithmetic. Rows past M or N and a K
//     tail past the last whole slot (whole activation boxes included) are
//     TMA's zero fill: zero activations add 0 whatever the weight decodes
//     to.
//   - WG consumer warpgroups each own 64 weight rows (wgmma's m side);
//     tokens are its n side, n = BM, so a bucket of 32 pads nothing. A
//     slot is four steps, one per activation box, of four wgmma.mma_async
//     m64nBMk16 (f16) or m64nBMk32 (s8) products whose A operand comes
//     from registers: thread (g = lane / 4, t = lane % 4) of warp w owns
//     weight rows 16 w + g and 16 w + g + 8, and product s of step u takes
//     byte t of the row's words 8 u + 2 s and 8 u + 2 s + 1 (k = 2t, 2t+1
//     and 2t+8, 2t+9 of a k16 product; 4t..4t+3 and 16+4t.. of a k32
//     one). It reads only its two rows' 32 bytes of the step from shared
//     memory and decodes them straight into the fragments:
//       uint4: __byte_perm puts byte t of word x at byte 0 and byte t of
//         x >> 4 at byte 2; & 0x000F000F | 0x64006400 is then the f16x2
//         (1024 + q_lo, 1024 + q_hi) (the 0x6400 magic); less 1024
//         (exact), less z, times s in f16: (q - z) * s as the plain
//         version rounds it (rescale: times s, less z); NARROW: a
//         step's two 32-deep halves take their own scale / zero pair (one
//         group each at g = 32, the same pair at g = 64);
//       int2: bbt::decode_i2x4 gives the byte's four fields - 2 in int8
//         lanes, summed exactly in s32.
//   - The fragments are double-buffered: step u's products stay in flight
//     while step u + 1 is decoded. Shared-memory loads issue through the
//     queue the wgmmas issue through, so a step's packed words are read
//     one step ahead, before the previous step's products are issued
//     (read after them, the decode waited for those products). A slot is
//     released once the products of its last step are waited for. uint4
//     sums each slot in accumulators of its own and adds them to the
//     running sums in f32 (U4::kPromote).
//   - IntFmt decodes each product's codes straight into s8 fragments (the
//     int family less its bias 2^(b-1) in the register, so its sums need
//     no correction) and sums in s32. With scales, the s32 sums of each
//     group are converted and scaled in f32 before they join the f32
//     sums, as JAX applies a group's scale to an exact integer dot: a
//     unit of P = min(16, the largest power of two dividing g / 32) k32
//     products (a slot for g >= 512 and per channel, a step for g = 128,
//     one product for g = 32) ends with a full wait and its promotion,
//     which reads the unit's scale (and zero) row from the slot that
//     holds it. Zeros need the sum of A over the unit for each token: a
//     second product of the same A box against an all-ones fragment
//     gives it in s32 (z sum a, taken off in f32: (d - r z) s or d s - r
//     z). Narrow groups wait after every unit, so they keep fewer products
//     in flight: a simple design first.
//   - Epilogue: each thread stores its accumulators (weight rows r, r + 8,
//     tokens 8 i + 2 t, + 1) plus the rows' f32 bias transposed into
//     out[M, N], rows past M and columns past N masked; for f32 a warp's
//     store fills whole 32-byte sectors.
//   - The grid runs the token tiles of one weight tile side by side (x =
//     M tile), so the packed weight comes from device memory once; the
//     activation is read again for every weight tile, from L2 (at M = 256
//     about as many bytes a second as L2 gives: PERF.md).

#pragma once

#include <type_traits>

#include "common.cuh"
#include "decode_formats.cuh"
#include "hopper.cuh"

namespace bbt {
namespace dqw {

// -- wgmma with the A operand in registers -----------------------------------

// d (64 x n) = a (64 x k16 f16 / k32 s8, registers: rows g and g + 8 of
// each warp's 16, k 2t.. / 4t.. and +8 / +16) . b (n x k, shared, K-major,
// 128-byte swizzle)^T + (scale_d ? d : 0); one overload per n = 32, 64,
// 128 (d[n / 2]).
__device__ __forceinline__ void rs_f16(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void rs_f16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void rs_f16(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void rs_s8(
    int (&d)[16], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void rs_s8(
    int (&d)[32], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void rs_s8(
    int (&d)[64], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The same with bf16 operands, n = 64 (the new formats' 64 x 128 tile).
__device__ __forceinline__ void rs_bf16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 16 bytes and one half from shared memory at a shared-window address.
__device__ __forceinline__ void lds128(uint32_t* v, uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
}
__device__ __forceinline__ void lds64(uint32_t* v, uint32_t addr) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v[0]), "=r"(v[1])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ half lds_half(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return __ushort_as_half(v);
}

// -- the two formats ---------------------------------------------------------

// Byte t of each of a row's 8 words: one stage's k of that row for this
// thread, k16 (k32) step s from words 2 s and 2 s + 1. RESCALE: zeros mode
// rescale, q * s - z. NARROW: g = 32 or 64, a scale / zero pair for each
// 32-deep half of a step.
template <bool RESCALE, bool NARROW>
struct U4 {
  using In = half;
  using Acc = float;
  using Out = half;
  static constexpr bool kScaled = true;
  static constexpr bool kZeros = true;     // always a zero tensor
  static constexpr bool kBias = true;
  static constexpr bool kOutAny = false;   // out is Out
  static constexpr bool kNarrow = NARROW;
  static constexpr int kHalves = NARROW ? 2 : 1;   // scale pairs a step
  static constexpr int kStepWords = 8;     // packed words of a row a step
  static constexpr int kSZRows = NARROW ? 8 : 2;   // rows of room a slot
  // A ring slot's products sum in their own accumulators, added to the
  // running sums in f32 once the slot is done: summed over all of K in the
  // tensor cores' accumulators, outputs near zero strayed up to 1.3 f16
  // ulps (plus 2^-18 of the largest output) from the plain version and
  // from exact sums at K = 11008.
  static constexpr bool kPromote = true;
  static constexpr int kStepK = 64;        // K of a 128-byte row of A
  static constexpr int kWordK = 8;         // K a packed int32 word
  static constexpr CUtensorMapDataType kAMap =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;

  // f[4 s + i] for product s: i = 0 (row lo, word 2 s), 1 (row hi, word
  // 2 s), 2 (row lo, word 2 s + 1), 3 (row hi, word 2 s + 1). NARROW:
  // words 0-3 (the step's first 32 of K) take pair 0, words 4-7 pair 1;
  // else every word pair 0.
  __device__ __forceinline__ static void decode(const uint32_t (&lo)[8],
                                                const uint32_t (&hi)[8],
                                                int t, const half2 (&s_lo)[2],
                                                const half2 (&z_lo)[2],
                                                const half2 (&s_hi)[2],
                                                const half2 (&z_hi)[2],
                                                const uint16_t*,
                                                uint32_t (&f)[16]) {
    // byte t of x at byte 0 and byte t of x >> 4 at byte 2: the low
    // nibbles of those bytes are the byte's codes (q_lo, q_hi)
    const uint32_t sel = t | ((t + 4) << 8);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t x = r ? hi[w] : lo[w];
        // the 0x6400 magic (decode_formats.cuh), exact
        uint32_t m = fmt::UInt<4>::convert<fmt::F16>(
            __byte_perm(x, x >> 4, sel) & 0x000F000Fu, nullptr);
        half2 q = *reinterpret_cast<half2*>(&m);
        const int h = NARROW ? w / 4 : 0;
        const half2 s = r ? s_hi[h] : s_lo[h];
        const half2 z = r ? z_hi[h] : z_lo[h];
        q = RESCALE ? __hsub2(hmul2_rn(q, s), z) : __hmul2(__hsub2(q, z), s);
        f[4 * (w / 2) + 2 * (w % 2) + r] = *reinterpret_cast<uint32_t*>(&q);
      }
    }
  }

  template <int ND>
  __device__ __forceinline__ static void mma(float (&d)[ND],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    rs_f16(d, a, db, scale_d);
  }

  __device__ __forceinline__ static Out cvt(float x) {
    return __float2half_rn(x);
  }
};

struct I2 {
  using In = int8_t;
  using Acc = int;
  using Out = float;
  static constexpr bool kScaled = false;
  static constexpr bool kZeros = false;
  static constexpr bool kBias = false;
  static constexpr bool kOutAny = false;
  static constexpr bool kNarrow = false;
  static constexpr int kHalves = 1;
  static constexpr int kStepWords = 8;
  static constexpr int kSZRows = 0;
  static constexpr bool kPromote = false;   // integer sums are exact
  static constexpr int kStepK = 128;       // K of a 128-byte row of A
  static constexpr int kWordK = 16;
  static constexpr CUtensorMapDataType kAMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;

  __device__ __forceinline__ static void decode(const uint32_t (&lo)[8],
                                                const uint32_t (&hi)[8],
                                                int t, const half2 (&)[2],
                                                const half2 (&)[2],
                                                const half2 (&)[2],
                                                const half2 (&)[2],
                                                const uint16_t*,
                                                uint32_t (&f)[16]) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      f[4 * (w / 2) + 2 * (w % 2)] = bbt::decode_i2x4(lo[w] >> (8 * t));
      f[4 * (w / 2) + 2 * (w % 2) + 1] = bbt::decode_i2x4(hi[w] >> (8 * t));
    }
  }

  template <int ND>
  __device__ __forceinline__ static void mma(int (&d)[ND],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    rs_s8(d, a, db, scale_d);
  }

  // exact: |sum| <= K * 128 * 2 <= 2^24 for K <= 65536
  __device__ __forceinline__ static Out cvt(int x) { return (float)x; }
};

// Every other format with f16 / bf16 activations (decode_formats.cuh): a
// step's 64 of K are 8 b bytes (2 b words) of each row; product s takes
// codes 16 s + 2t, + 1 (logical k 2t, 2t + 1) and 16 s + 8 + 2t, + 1 of
// the step, so the weight follows A's natural order of k. Each pair is
// decoded and scaled in A's type (fmt::scale2), exactly as the plain
// version and kernel 2 decode it; product s takes the scale / zero pair
// of its 32-deep half of the step (two groups at g = 32, one above: both
// pairs are read whatever the group, so the group is a runtime value).
// Zeros, when the configuration has them, are a runtime choice (nsz = 2);
// the output is A's type or float32 (out_f32).
template <class Fam, class AT, int MODE>
struct Fmt {
  using In = typename AT::T;
  using Acc = float;
  using Out = typename AT::T;
  static constexpr int B = Fam::kBits;
  static constexpr bool kScaled = MODE != fmt::kNone;
  static constexpr bool kZeros = false;    // runtime: nsz
  static constexpr bool kBias = true;
  static constexpr bool kOutAny = true;
  static constexpr bool kNarrow = false;   // runtime: the box's rows
  static constexpr int kHalves = 2;
  static constexpr int kStepWords = 2 * B;
  static constexpr int kSZRows = 8;
  static constexpr bool kPromote = true;   // as uint4: f32 sums a slot
  static constexpr int kStepK = 64;
  static constexpr int kWordK = 32 / B;
  static constexpr CUtensorMapDataType kAMap =
      AT::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;

  // codes base + 2t and base + 2t + 1 of the step's words (base a
  // multiple of 8: 32 b bits), as a raw pair
  __device__ __forceinline__ static uint32_t pair(
      const uint32_t (&w)[kStepWords], int base, int t) {
    if constexpr (B == 8) {
      const int w0 = base / 4;
      const uint32_t x = ((t & 2) ? w[w0 + 1] : w[w0]) >> (16 * (t & 1));
      return (x & 0xFFu) | ((x << 8) & 0xFF0000u);
    } else {
      constexpr uint32_t M = (1u << B) - 1u;
      const int pos = base * B;
      const uint32_t x = w[pos / 32] >> (pos % 32 + 2 * t * B);
      return (x & M) | ((x << (16 - B)) & (M << 16));
    }
  }

  __device__ __forceinline__ static uint32_t bits(half2 h) {
    return *reinterpret_cast<uint32_t*>(&h);
  }

  __device__ __forceinline__ static void decode(
      const uint32_t (&lo)[kStepWords], const uint32_t (&hi)[kStepWords],
      int t, const half2 (&s_lo)[2], const half2 (&z_lo)[2],
      const half2 (&s_hi)[2], const half2 (&z_hi)[2], const uint16_t* lut,
      uint32_t (&f)[16]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int h = s / 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int base = 16 * s + 8 * j;
        f[4 * s + 2 * j] = fmt::scale2<AT, MODE>(
            Fam::template convert<AT>(pair(lo, base, t), lut), bits(s_lo[h]),
            bits(z_lo[h]));
        f[4 * s + 2 * j + 1] = fmt::scale2<AT, MODE>(
            Fam::template convert<AT>(pair(hi, base, t), lut), bits(s_hi[h]),
            bits(z_hi[h]));
      }
    }
  }

  template <int ND>
  __device__ __forceinline__ static void mma(float (&d)[ND],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    if constexpr (AT::kBf16)
      rs_bf16(d, a, db, scale_d);
    else
      rs_f16(d, a, db, scale_d);
  }

  __device__ __forceinline__ static Out cvt(float x) { return AT::cvt(x); }
};

// Whether a functor decodes through nf4's table (kept in shared memory).
template <class F>
struct LutOf {
  static constexpr bool value = false, bf16 = false;
};
template <class Fam, class AT, int MODE>
struct LutOf<Fmt<Fam, AT, MODE>> {
  static constexpr bool value = Fam::kLut, bf16 = AT::kBf16;
};

// -- integer activations ------------------------------------------------------

// The output types of the integer column (kernels/dequant_matmul.py
// _INT_OUT), and its stores: f32, f16 (round to nearest), int32 (the
// exact sums; through float32 truncated toward zero when a bias is added,
// as the plain version casts), int8 (saturating: rounded half to even,
// then clamped; the exact sums clamped).
enum OutKind { kOutF32 = 0, kOutF16 = 1, kOutI32 = 2, kOutI8 = 3 };

__device__ __forceinline__ void store_float(void* out, size_t at, float v,
                                            int kind) {
  if (kind == kOutF32)
    static_cast<float*>(out)[at] = v;
  else if (kind == kOutF16)
    static_cast<half*>(out)[at] = __float2half_rn(v);
  else if (kind == kOutI32)
    static_cast<int*>(out)[at] = __float2int_rz(v);
  else
    static_cast<int8_t*>(out)[at] =
        (int8_t)fminf(fmaxf(rintf(v), -128.f), 127.f);
}

// `bias`: the f32 bias of the output's column, or null
__device__ __forceinline__ void store_int(void* out, size_t at, int v,
                                          const float* bias, int kind) {
  if (bias != nullptr) {
    store_float(out, at, __fadd_rn(__int2float_rn(v), *bias), kind);
  } else if (kind == kOutI32) {
    static_cast<int*>(out)[at] = v;
  } else if (kind == kOutI8) {
    static_cast<int8_t*>(out)[at] = (int8_t)min(max(v, -128), 127);
  } else {
    store_float(out, at, __int2float_rn(v), kind);
  }
}

// Modes of the integer column: unscaled (exact int32 sums), scales, scales
// and zeros (s (d - r z)), scales and zeros rescale (d s - r z).
enum IntMode { kUnscaled = 0, kScale = 1, kZeros = 2, kRescale = 3 };

// One group's (or unit's) f32 term from its exact sums d (of the values)
// and r (of A), each op rounded on its own: the split plain version's
// order (kernels/dequant_matmul.py dequant_matmul_int_split_plain).
template <int MODE>
__device__ __forceinline__ float fold(int d, int r, float s, float z) {
  if constexpr (MODE == kScale) {
    return __fmul_rn(__int2float_rn(d), s);
  } else if constexpr (MODE == kZeros) {
    return __fmul_rn(
        __fsub_rn(__int2float_rn(d), __fmul_rn(__int2float_rn(r), z)), s);
  } else {
    return __fsub_rn(__fmul_rn(__int2float_rn(d), s),
                     __fmul_rn(__int2float_rn(r), z));
  }
}

// A group the kernels take at this K: 32, 64, 128, a multiple of 256 that
// divides K, or K (per channel), with K a multiple of 128; neither a
// decode chunk's scale pair nor a tiled slot's rows straddle a group.
inline bool group_ok(int K, int group) {
  if (K % 128 != 0 || group < 32 || K % group != 0) return false;
  return group == 32 || group == 64 || group == 128 || group % 256 == 0 ||
         group == K;
}

// int8 activations with FAM (0 uint, 1 int) weights of B = 1, 2 or 4 bits:
// a step's 128 of K are 4 B words of each row; product s takes codes 32 s
// + 4t .. + 3 (logical k 4t..) and 32 s + 16 + 4t .. + 3 (16 + 4t..) in
// A's natural order, four codes spread to the four bytes of a register.
template <int FAM, int B, int MODE>
struct IntFmt {
  using In = int8_t;
  using Acc = typename std::conditional<MODE == kUnscaled, int, float>::type;
  static constexpr bool kScaled = MODE != kUnscaled;   // scale rows loaded
  static constexpr bool kZeros = false;    // read at promotion, not decode
  static constexpr bool kNarrow = false;
  static constexpr int kHalves = 2;
  static constexpr int kStepWords = 4 * B;
  static constexpr int kSZRows = MODE == kUnscaled ? 0 : 16;   // g = 32
  static constexpr bool kPromote = false;  // IntOf::groups instead
  static constexpr int kStepK = 128;
  static constexpr int kWordK = 32 / B;
  static constexpr int kBias8 = FAM == 1 ? (1 << (B - 1)) * 0x01010101 : 0;
  static constexpr CUtensorMapDataType kAMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;

  // codes 32 s + 16 h + 4t .. + 3 of the step's words, one a byte
  __device__ __forceinline__ static uint32_t four(
      const uint32_t (&w)[kStepWords], int s, int h, int t) {
    uint32_t f;
    if constexpr (B == 4) {   // half t & 1 of word 4 s + 2 h + t / 2,
      const uint32_t x = w[2 * s + h];   // which the fetch put at 2 s + h
      f = __byte_perm(x, x >> 4, (t & 1) ? 0x7362 : 0x5140) & 0x0F0F0F0Fu;
    } else if constexpr (B == 2) {   // byte t of word 2 s + h
      const uint32_t x = w[2 * s + h] >> (8 * t);
      f = (x & 0x3u) | ((x & 0xCu) << 6) | ((x & 0x30u) << 12) |
          ((x & 0xC0u) << 18);
    } else {   // nibble 4 h + t of word s
      f = (((w[s] >> (4 * (4 * h + t))) & 0xFu) * 0x00204081u) &
          0x01010101u;
    }
    if constexpr (FAM == 1)   // less the bias in each byte (no borrows)
      f = ((f | 0x80808080u) - (uint32_t)kBias8) ^ 0x80808080u;
    return f;
  }

  __device__ __forceinline__ static void decode(
      const uint32_t (&lo)[kStepWords], const uint32_t (&hi)[kStepWords],
      int t, const half2 (&)[2], const half2 (&)[2], const half2 (&)[2],
      const half2 (&)[2], const uint16_t*, uint32_t (&f)[16]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      f[4 * s] = four(lo, s, 0, t);
      f[4 * s + 1] = four(hi, s, 0, t);
      f[4 * s + 2] = four(lo, s, 1, t);
      f[4 * s + 3] = four(hi, s, 1, t);
    }
  }

  template <int ND>
  __device__ __forceinline__ static void mma(int (&d)[ND],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    rs_s8(d, a, db, scale_d);
  }

  __device__ __forceinline__ static void store(void* out, size_t at, Acc v,
                                               const float* bias, int n,
                                               int kind) {
    if constexpr (MODE == kUnscaled)
      store_int(out, at, v, bias != nullptr ? bias + n : nullptr, kind);
    else
      store_float(out, at, bias != nullptr ? __fadd_rn(v, bias[n]) : v,
                  kind);
  }
};

// Whether a functor is IntFmt: then its products sum in s32 (`Part`), with
// scales promoted a group at a time (`groups`), with zeros also summing A
// (`zeros`), and it stores through IntFmt::store.
template <class F>
struct IntOf {
  static constexpr bool value = false, groups = false, zeros = false;
  static constexpr int mode = kUnscaled;
  using Part = typename F::Acc;
};
template <int FAM, int B, int MODE>
struct IntOf<IntFmt<FAM, B, MODE>> {
  static constexpr bool value = true, groups = MODE != kUnscaled,
                        zeros = MODE >= kZeros;
  static constexpr int mode = MODE;
  using Part = int;
};

// -- the kernel --------------------------------------------------------------

constexpr int kRowBytes = 128;   // bytes of one row of an A box
constexpr int kSub = 4;          // A boxes (steps of four products) a stage

// TMA's W-byte swizzle of a box whose rows are W bytes (32, 64 or 128;
// CUTLASS's Swizzle<log2(W / 16), 4, 3>: address bits 4.. XOR bits
// 7..) puts the 16-byte chunk c of row r at chunk c ^ ((r / (128 / W)) %
// (W / 16)).

template <class F, int BM, int WG, int STAGES>
struct Tiled {
  static constexpr int BN = 64 * WG;                   // weight rows
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;     // + producer warp
  static constexpr int kStepK = F::kStepK;             // K of one A box
  static constexpr int kStageK = kSub * kStepK;
  static constexpr int kABox = BM * kRowBytes;
  static constexpr int kABytes = kSub * kABox;
  // a stage's packed bytes of one weight row, in boxes of at most 128
  // bytes (swizzled by their width)
  static constexpr int kWRow = kSub * F::kStepWords * 4;
  static constexpr int kWBox = kWRow < 128 ? kWRow : 128;
  static constexpr int kWBoxes = kWRow / kWBox;
  static constexpr int kWBytes = BN * kWRow;
  // uint4: the room for a slot's scale (then zero) rows
  static constexpr int kSZBytes = F::kSZRows * BN * 2;   // each
  static constexpr int kLoadBytes = kABytes + kWBytes + 2 * kSZBytes;
  static constexpr int kStageBytes = (kLoadBytes + 1023) / 1024 * 1024;
  static constexpr int kSmemBytes =
      1024 /* alignment */ + STAGES * kStageBytes + 2 * STAGES * 8;
  // two blocks an SM where registers and shared memory leave room
  static constexpr int kMinBlocks =
      BM <= 64 && 2 * kSmemBytes <= 232448 ? 2 : 1;
};

template <class F, int BM, int WG, int STAGES>
__global__ void __launch_bounds__(Tiled<F, BM, WG, STAGES>::kThreads,
                                  Tiled<F, BM, WG, STAGES>::kMinBlocks)
    dequant_tiled_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ts,
                         const __grid_constant__ CUtensorMap tz,
                         const float* __restrict__ bias,
                         void* __restrict__ out_ptr, int M, int N, int K,
                         int group, int rs, int box, int nsz, int out_f32) {
  // rs: the scale / zero rows of a slot's box that the slot reads (g = 32
  // / 64: 8 / 4, the box's rows; g = 128: 2; g >= 256: 1 of a box of 2;
  // IntFmt: 512 / g up to 16); box: the rows of the box (rs, or 2 where rs
  // <= 2); nsz: the scale tensors loaded (0, 1 scales, 2 scales and
  // zeros); out_f32: a float32 output for a functor whose output may be
  // either (F::kOutAny), IntFmt's OutKind
  using T = Tiled<F, BM, WG, STAGES>;
  using Acc = typename F::Acc;
  constexpr int ND = BM / 2;   // accumulators a thread
  static_assert(BM == 32 || BM == 64 || BM == 128, "wgmma n");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int kStageBytes = T::kStageBytes, kSZBytes = T::kSZBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * kStageBytes);
  uint64_t* empty = full + STAGES;
  __shared__ uint16_t lut[16];   // nf4's table in A's type

  const int tid = threadIdx.x;
  // the M tiles of one weight tile are neighbours on the grid, so they run
  // together and the packed weight comes from device memory once
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * T::BN;
  // a K tail past the last whole stage is zero-filled (whole A boxes too)
  const int nk = (K + T::kStageK - 1) / T::kStageK;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], T::kConsumers);
    }
    mbar_fence_init();
  }
  if constexpr (LutOf<F>::value) {
    if (tid < 16)
      lut[tid] = LutOf<F>::bf16 ? fmt::kNf4Bf16[tid] : fmt::kNf4F16[tid];
  }
  __syncthreads();

  if (tid >= T::kConsumers) {   // the producer warp: one thread issues
    if (tid == T::kConsumers) {
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        // use u = j / STAGES of a stage waits for the release of use u - 1
        if (j >= STAGES) mbar_wait(&empty[st], (j / STAGES - 1) & 1);
        unsigned char* base = smem + st * kStageBytes;
        // each scale tensor's box: `box` rows of BN halves
        mbar_expect_tx(&full[st],
                       T::kABytes + T::kWBytes + nsz * 2 * box * T::BN);
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          tma_load_2d(base + i * T::kABox, &ta, &full[st],
                      j * T::kStageK + i * T::kStepK, m0);
#pragma unroll
        for (int b = 0; b < T::kWBoxes; ++b)
          tma_load_2d(base + T::kABytes + b * T::BN * T::kWBox, &tw,
                      &full[st],
                      j * (T::kStageK / F::kWordK) + b * (T::kWBox / 4), n0);
        if constexpr (F::kScaled) {
          // the slot's first group row (a K tail past the last group is
          // zero-filled)
          const int row = j * T::kStageK / group;
          unsigned char* sz = base + T::kABytes + T::kWBytes;
          tma_load_2d(sz, &ts, &full[st], n0, row);
          if (nsz == 2) tma_load_2d(sz + kSZBytes, &tz, &full[st], n0, row);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = wg * 64 + warp * 16 + g;   // this thread's weight rows
  const int r_hi = r_lo + 8;                  // (within the tile)
  // 16-byte chunk c of weight row r sits at chunk c ^ ((r / (128 / W)) %
  // (W / 16)) of its W-byte box row (TMA's swizzle, above): the rows g of
  // a warp hit distinct banks. Rows r_lo and r_hi are g and g + 8 modulo
  // 16, so that term is sw = g / (128 / W) for both
  constexpr int kWB = T::kWBox;
  const int sw = g / (128 / kWB);
  const uint32_t ring = smem_u32(smem);

  // the running sums; with F::kPromote the products go to `part`, one
  // ring slot at a time
  using IO = IntOf<F>;
  constexpr int NP = F::kPromote || IO::groups ? ND : 1;
  constexpr int NO = IO::zeros ? ND : 1;
  Acc acc[ND];
  typename IO::Part part[NP];
  int ones[NO];   // IntFmt with zeros: each token's sum of A over the unit
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) part[i] = 0;
#pragma unroll
  for (int i = 0; i < NO; ++i) ones[i] = 0;
  uint32_t fa[16], fb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) fa[i] = fb[i] = 0u;

  // The packed words of the next step (8 of each row) and its scale and
  // zero pairs, read from shared memory one step ahead: shared-memory
  // loads queue behind the wgmmas issued before them, so a step's reads
  // go out before the previous step's products.
  constexpr int SW = F::kStepWords;
  uint32_t lo[SW], hi[SW];
  half2 s_lo[2]{}, z_lo[2]{}, s_hi[2]{}, z_hi[2]{};
  auto fetch = [&](uint32_t base, int u) {
    const uint32_t w = base + T::kABytes;
    // step u's 4 SW bytes of each row: in box (4 SW u) / kWB, from byte
    // (4 SW u) % kWB of its row
    const int byte0 = 4 * SW * u;
    const uint32_t wb = w + (byte0 / kWB) * T::BN * kWB;
    const int c0 = (byte0 % kWB) / 16;
    if constexpr (IO::value && SW == 16) {
      // IntFmt at 4 bits: a thread decodes every other word of the step,
      // 4 s + 2 h + t / 2, read alone into lo / hi[2 s + h] (constant
      // indices keep the arrays in registers; IntFmt::four)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t o = (((c0 + s) ^ sw) << 4) + 4 * (2 * h + t / 2);
          lo[2 * s + h] = lds_u32(wb + r_lo * kWB + o);
          hi[2 * s + h] = lds_u32(wb + r_hi * kWB + o);
        }
    } else if constexpr (SW >= 4) {
#pragma unroll
      for (int c = 0; c < SW / 4; ++c)
        lds128(&lo[4 * c], wb + r_lo * kWB + (((c0 + c) ^ sw) << 4));
#pragma unroll
      for (int c = 0; c < SW / 4; ++c)
        lds128(&hi[4 * c], wb + r_hi * kWB + (((c0 + c) ^ sw) << 4));
    } else {   // 8 bytes, half a chunk
      const int o = byte0 % 16;
      lds64(&lo[0], wb + r_lo * kWB + ((c0 ^ sw) << 4) + o);
      lds64(&hi[0], wb + r_hi * kWB + ((c0 ^ sw) << 4) + o);
    }
    if constexpr (F::kScaled && !IO::groups) {
      // the group row of the step (of each 32-deep half where kHalves is
      // 2), row (u * kStepK + 32 h) * rs / kStageK of the slot's rs
#pragma unroll
      for (int h = 0; h < F::kHalves; ++h) {
        const int row = (u * T::kStepK + 32 * h) * rs / T::kStageK;
        const uint32_t sz = w + T::kWBytes + row * T::BN * 2 + 2 * r_lo;
        s_lo[h] = __half2half2(lds_half(sz));
        s_hi[h] = __half2half2(lds_half(sz + 16));
        if (F::kZeros || nsz == 2) {
          z_lo[h] = __half2half2(lds_half(sz + kSZBytes));
          z_hi[h] = __half2half2(lds_half(sz + kSZBytes + 16));
        }
      }
    }
  };

  // IntFmt with scales: the k32 products of a unit (P of them, never
  // straddling a group or a slot) sum in `part` (and A's sums in `ones`);
  // `promote` adds the finished unit that starts at product p0 (over K)
  // to acc in f32 with its scale (and zero) row, read from the slot of
  // its first product
  int P = 16;
  if constexpr (IO::groups) {
    const int q = group / 32;
    P = min(16, q & -q);
  }
  auto promote = [&](int p0) {
    if constexpr (IO::groups) {
      const int j0 = p0 / 16;
      const int row = 32 * p0 / group - j0 * T::kStageK / group;
      const uint32_t sz = ring + (j0 % STAGES) * kStageBytes + T::kABytes +
                          T::kWBytes + row * T::BN * 2 + 2 * r_lo;
      const float s2[2] = {__half2float(lds_half(sz)),
                           __half2float(lds_half(sz + 16))};
      float z2[2] = {0.f, 0.f};
      if constexpr (IO::zeros) {
        z2[0] = __half2float(lds_half(sz + kSZBytes));
        z2[1] = __half2float(lds_half(sz + kSZBytes + 16));
      }
#pragma unroll
      for (int i = 0; i < ND; ++i)   // acc[i]: row r_hi where i & 2
        acc[i] = __fadd_rn(
            acc[i], fold<IO::mode>(part[i], IO::zeros ? ones[i % NO] : 0,
                                   s2[(i >> 1) & 1], z2[(i >> 1) & 1]));
    }
  };

  // Step u of stage j (A box u, packed bytes 32 u .. 32 u + 31 of each
  // weight row): decode the fetched words into `cur`, fetch the next
  // step's, issue this step's four products, wait for the previous
  // step's (whose fragments are `prev`); a stage's first step then
  // releases the previous stage.
  auto step = [&](int j, int u, uint32_t base, uint32_t (&cur)[16],
                  uint32_t (&prev)[16]) {
    F::decode(lo, hi, t, s_lo, z_lo, s_hi, z_hi, lut, cur);
    if (u + 1 < kSub) {
      fetch(base, u + 1);
    } else if (j + 1 < nk) {
      const int nx = (j + 1) % STAGES;
      mbar_wait(&full[nx], ((j + 1) / STAGES) & 1);
      fetch(ring + nx * kStageBytes, 0);
    }
    if constexpr (F::kPromote) {
      if (u == 0 && j > 0) {   // the previous slot's sums into acc
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] += part[i];
      }
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t a[4] = {cur[4 * s], cur[4 * s + 1], cur[4 * s + 2],
                               cur[4 * s + 3]};
        // a slot's first product overwrites the previous slot's sums
        F::mma(part, a, desc_sw128(base + u * T::kABox + s * 32),
               u != 0 || s != 0);
      }
    } else if constexpr (IO::groups) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = 16 * j + 4 * u + s;
        const bool first = p % P == 0;   // of a unit: overwrites
        if (first && p > 0) {   // the previous unit is done: promote it
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
          fence_regs(ones);
          promote(p - P);
        }
        if (s == 0 || (first && p > 0)) {
          fence_regs(part);
          fence_regs(ones);
          wgmma_fence();
        }
        const uint32_t a[4] = {cur[4 * s], cur[4 * s + 1], cur[4 * s + 2],
                               cur[4 * s + 3]};
        const uint64_t db = desc_sw128(base + u * T::kABox + s * 32);
        F::mma(part, a, db, !first);
        if constexpr (IO::zeros) {
          const uint32_t one[4] = {0x01010101u, 0x01010101u, 0x01010101u,
                                   0x01010101u};
          F::mma(ones, one, db, !first);
        }
      }
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t a[4] = {cur[4 * s], cur[4 * s + 1], cur[4 * s + 2],
                               cur[4 * s + 3]};
        F::mma(acc, a, desc_sw128(base + u * T::kABox + s * 32), 1);
      }
    }
    wgmma_commit();
    // this step's products stay in flight; those of the step before are
    // done, so its fragments may be overwritten and, at a stage's first
    // step, the previous stage's slot refilled
    wgmma_wait<1>();
    fence_regs(acc);
    fence_regs(part);
    if constexpr (IO::zeros) fence_regs(ones);
    keep_regs(prev);
    if (u == 0 && j > 0) mbar_arrive(&empty[(j - 1) % STAGES]);
  };

  mbar_wait(&full[0], 0);
  fetch(ring, 0);
  for (int j = 0; j < nk; ++j) {
    const uint32_t base = ring + (j % STAGES) * kStageBytes;
    static_assert(kSub % 2 == 0, "fragments alternate within a stage");
#pragma unroll
    for (int u = 0; u < kSub; u += 2) {
      step(j, u, base, fa, fb);
      step(j, u + 1, base, fb, fa);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(part);
  if constexpr (IO::zeros) fence_regs(ones);
  if constexpr (F::kPromote) {
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += part[i];
  }
  if constexpr (IO::groups) promote(16 * nk - P);   // the last unit
  keep_regs(fa);
  keep_regs(fb);

  // acc[4 i + e]: weight row r_lo + 8 (e / 2), token 8 i + 2 t + e % 2
  const int n_lo = n0 + r_lo, n_hi = n0 + r_hi;
  if constexpr (IO::value) {
#pragma unroll
    for (int i = 0; i < ND / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * i + 2 * t + (e & 1);
        const int n = (e & 2) ? n_hi : n_lo;
        if (m < M && n < N)
          F::store(out_ptr, (size_t)m * N + n, acc[4 * i + e], bias, n,
                   out_f32);
      }
    }
  } else {
    if constexpr (F::kBias) {
      // the f32 bias of the thread's two rows, before the one rounding
      if (bias != nullptr) {
        const float b_lo = n_lo < N ? bias[n_lo] : 0.f;
        const float b_hi = n_hi < N ? bias[n_hi] : 0.f;
#pragma unroll
        for (int i = 0; i < ND / 4; ++i) {
          acc[4 * i] += b_lo;
          acc[4 * i + 1] += b_lo;
          acc[4 * i + 2] += b_hi;
          acc[4 * i + 3] += b_hi;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ND / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * i + 2 * t + (e & 1);
        const int n = (e & 2) ? n_hi : n_lo;
        if (m >= M || n >= N) continue;
        if constexpr (F::kOutAny) {
          if (out_f32) {
            static_cast<float*>(out_ptr)[(size_t)m * N + n] =
                acc[4 * i + e];
            continue;
          }
        }
        static_cast<typename F::Out*>(out_ptr)[(size_t)m * N + n] =
            F::cvt(acc[4 * i + e]);
      }
    }
  }
}

// Launches one instance: A [M, K] (F::In), Wq [N, K / F::kWordK] int32,
// scales and zeros [K / group, N] (2-byte: f16, or bf16 for a bf16 Fmt;
// zeros null for a scale-only Fmt) and bias [N] f32 or null (not int2),
// out [M, N] (F::Out, or float32 where out_f32 and F::kOutAny).
template <class F, int BM, int WG, int STAGES>
cudaError_t launch_tiled(const void* A, const void* Wq, const void* scales,
                         const void* zeros, const float* bias, void* out,
                         int out_f32, int M, int N, int K, int group,
                         cudaStream_t stream) {
  using T = Tiled<F, BM, WG, STAGES>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap ta, tw, ts, tz;
  if (!make_map_2d(encode, &ta, A, F::kAMap, (int)sizeof(typename F::In), M,
                   K, BM) ||
      !make_map_2d_sw(encode, &tw, Wq, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, N,
                      K / F::kWordK, T::BN, T::kWBox))
    return cudaErrorInvalidValue;
  // the group rows a slot reads: 256 / g for g <= 128, else 1; a box of
  // that many rows for g < 128 (NARROW), else of 2
  const int rs = group < T::kStageK ? T::kStageK / group : 1;
  const int box = rs > 2 ? rs : 2;
  const int nsz = !F::kScaled ? 0 : zeros != nullptr ? 2 : 1;
  if constexpr (F::kScaled) {
    if (group < 32 || K % group != 0 || rs > F::kSZRows ||
        (F::kHalves == 1 && rs > 2) || (F::kNarrow && rs <= 2) ||
        (F::kZeros && zeros == nullptr) ||
        !make_map_2d_box(encode, &ts, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                         2, K / group, N, T::BN, box))
      return cudaErrorInvalidValue;
    if (nsz < 2) {
      tz = ts;   // not read
    } else if (!make_map_2d_box(encode, &tz, zeros,
                                CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, K / group,
                                N, T::BN, box)) {
      return cudaErrorInvalidValue;
    }
  } else {
    ts = tw;   // not read
    tz = tw;
  }
  auto kernel = dequant_tiled_kernel<F, BM, WG, STAGES>;
  static bool smem_set[kMaxDevices];
  cudaError_t err = set_max_smem_once(kernel, T::kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + T::BN - 1) / T::BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      ta, tw, ts, tz, bias, out, M, N, K, group, rs, box, nsz, out_f32);
  return cudaGetLastError();
}

// The compiled instances, (block_m = BM tokens, block_n = 64 WG weight
// rows, block_k = the K of a slot, stages): kernels/dequant_matmul.py
// FUSED_TILES lists the same after each format's decode instance, and
// fused_smem_bytes gives Tiled<...>::kSmemBytes. 64-row tiles give the
// down projections (N = 4096) twice the blocks; 128-token tiles decode
// each weight for twice the tokens. uint4's promoted sums take registers
// that the two-block 64 x 128 tile and the 128 x 128 tile do not have to
// spare (they spilled: ptxas gave a 288-thread block at most 168
// registers a thread): its 64 x 128 tile runs one block an SM with a
// deeper ring, and it has no 128 x 128 tile.
template <class F>
cudaError_t run_tiled(const void* A, const void* Wq, const void* scales,
                      const void* zeros, const float* bias, void* out, int M,
                      int N, int K, int group, int bm, int bn, int bk,
                      int stages, cudaStream_t stream) {
  if (bk != kSub * F::kStepK) return cudaErrorInvalidValue;
#define BBT_DQW_TILE(BM, BN, S)                                             \
  if (bm == BM && bn == BN && stages == S)                                  \
    return launch_tiled<F, BM, BN / 64, S>(A, Wq, scales, zeros, bias, out, \
                                           0, M, N, K, group, stream);
  BBT_DQW_TILE(32, 64, 4)
  BBT_DQW_TILE(128, 64, 3)
  if constexpr (F::kPromote) {
    BBT_DQW_TILE(64, 128, 4)
  } else {
    BBT_DQW_TILE(64, 128, 2)
    BBT_DQW_TILE(128, 128, 2)
  }
#undef BBT_DQW_TILE
  return cudaErrorInvalidValue;
}

// The Fmt and IntFmt formats' one tiled instance: 64 tokens x 128 weight
// rows, three slots of 256 (Fmt) or 512 (IntFmt) of K (an 8-bit weight's
// slot is 256 bytes of each row: four slots would not fit).
// kernels/dequant_matmul.py FMT_TILED_TILE, INT_TILED_TILE. `out_f32`:
// IntFmt's OutKind.
template <class F>
cudaError_t run_tiled_fmt(const void* A, const void* Wq, const void* scales,
                          const void* zeros, const float* bias, void* out,
                          int out_f32, int M, int N, int K, int group,
                          cudaStream_t stream) {
  return launch_tiled<F, 64, 2, 3>(A, Wq, scales, zeros, bias, out, out_f32,
                                   M, N, K, group, stream);
}

}  // namespace dqw
}  // namespace bbt

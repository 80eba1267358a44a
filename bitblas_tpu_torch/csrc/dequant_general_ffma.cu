// dqg_matmul_ffma: kernel 1's general instance on the DMMA (float64) and
// FFMA (float32) sum units (csrc/dequant_general.cuh; the header of
// csrc/dequant_general.cu has the design), a source of its own so that it
// builds beside the mma.sync units'.
#include "dequant_general.cuh"

using namespace bbt::dqg;

// as dqg_matmul, for unit f64 (acc_code 2) or ffma (acc_code 1)
extern "C" int dqg_matmul_ffma(const void* A, int a_code, const void* Wq,
                               int family, int bits, const void* scales,
                               int s_code, const void* zeros, int z_code,
                               int zmode, int d_code, int acc_code, int unit,
                               void* out, int M, int N, int K, int group,
                               void* part, int part_elems, void* count,
                               int counters, int sms, void* stream) {
  const int want_acc = unit == UNIT_F64 ? 2 : 1;
  if (!weight_ok(family, bits) || M < 1 || N < 1 || K < 1 || group < 1 ||
      K % group != 0 || acc_code != want_acc || a_code < 0 || a_code > T_U4)
    return (int)cudaErrorInvalidValue;
  const Weight W = make_weight(Wq, family, bits, scales, s_code, zeros,
                               z_code, zmode, d_code, N, K, group);
  const Split sp = {part, part_elems, static_cast<int*>(count), counters,
                    sms};
  return launch_general<false>(unit, A, a_code, W, out, M, N, K, sp,
                               static_cast<cudaStream_t>(stream));
}

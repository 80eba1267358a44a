"""The port's tile space and roofline (counterpart of
bitblas_tpu/tuner/space.py).

The space of a quantized spec is what the port's kernels can vary: the
compiled tile instances of the fused dequant-GEMM kernel
(kernels/dequant_matmul.FUSED_TILES) and, from the 256 bucket, the
two-pass materialize plan. JAX offers materialize from M = 512. On the
H100 (PERF.md, route table) the fused kernel's wgmma + TMA tiles beat
the plan at M = 256 in both formats and, for int2 x int8, up to M =
2048; for uint4 x f16 the plan wins from M = 512. The port offers the
plan from the 256 bucket and the measured tuner decides. A native spec
has one "dense" hint, as in JAX, where hints do not change the dense
product. A configuration of kernel 1's general instance ("general") has
its one tile and, where JAX's rule allows it, the materialize plan.

`default_hint` is the untuned choice and reproduces the routing the port
had before it had a tuner: the fused kernel below M = 512 with
`default_tile` by M (the split-K decode instance up to 16 rows, the
64-token x 128-row wgmma tile above), the materialize plan from M = 512
(`MATERIALIZE_MIN_M`, JAX's bound).
`roofline_seconds` is the least time the card could take for the plan's
work: the larger of its bytes (each input read once, each output written
once; the materialize plan also writes and reads its decoded weight) over
the memory bandwidth and its operations over the tensor-core peak of the
operand type (FFMA for float32).
"""

from __future__ import annotations

from typing import List

from ..kernels.dense import DENSE_TILES, dense_smem_bytes
from ..kernels.dequant_matmul import (FUSED_TILES, default_tile,
                                      fused_smem_bytes, spec_format)
from ..kernels.materialize import supports_materialize_spec
from ..kernels.spec import KernelSpec
from ..quantization.formats import as_torch_dtype
from .arch import TileDevice
from .hint import MATERIALIZE, TileHint

# The untuned route bound (JAX's tuner offers materialize from here).
MATERIALIZE_MIN_M = 512
# The smallest bucket in which the tuner measures the materialize plan.
MATERIALIZE_TUNE_MIN_M = 256


def _bytes(dtype: str) -> int:
    return as_torch_dtype(dtype).itemsize


def smem_bytes(spec: KernelSpec, hint: TileHint) -> int:
    """Shared memory one block of the hint's kernel takes (0 for the
    library routes)."""
    if hint.decode_mode == "fused":
        return fused_smem_bytes(spec_format(spec), hint.tile,
                                spec.group_size)
    if hint.decode_mode == "dense" and hint.block_n > 0:
        return dense_smem_bytes(as_torch_dtype(spec.a_dtype), hint.tile)
    return 0


def _peak(spec: KernelSpec, arch: TileDevice) -> float:
    if spec.is_int_activation:
        return arch.flops_int8
    return arch.flops_f32 if spec.a_dtype == "float32" else arch.flops_f16


def roofline_seconds(spec: KernelSpec, hint: TileHint,
                     arch: TileDevice) -> float:
    """max(bytes / bandwidth, operations / peak) of the hint's plan: the
    activation, the packed weight (N K bits / 8), its scales and zeros (2
    bytes each a group and column: 2 N K / g each), the float32 bias and
    the output, each once."""
    M, N, K = spec.m, spec.n, spec.k
    a_b = M * K * _bytes(spec.a_dtype)
    o_b = M * N * _bytes(spec.out_dtype)
    if spec.native:
        w_b = N * K * _bytes(spec.a_dtype)
    else:
        w_b = N * K * spec.bits // 8
        if spec.with_scaling:
            g = spec.group_size if spec.group_size > 0 else K
            w_b += (K // g) * N * 2 * (1 + int(spec.with_zeros))
        if hint.decode_mode == "materialize":
            # the decoded operand is written once and read once
            w_b += 2 * N * K * _bytes(spec.a_dtype)
    if spec.with_bias:
        w_b += 4 * N
    return max((a_b + w_b + o_b) / arch.hbm_bandwidth,
               2.0 * M * N * K / _peak(spec, arch))


def _dense_want(spec: KernelSpec):
    """Kernel 9's tile for this M. On wgmma (f16, bf16, int8): 64 x 128 up
    to 256 rows (where the card needs the most blocks; at M = 16 it
    measured faster than the 16-row mma.sync tile, PERF.md), 128 x 128 up
    to 1024 and 128 x 256 above. float32 (FFMA at every tile): the
    16-row tile up to 16 rows, 64 x 128 up to 64, 128 x 128 above."""
    if spec.a_dtype == "float32":
        if spec.m <= 16:
            return DENSE_TILES[0]
        return DENSE_TILES[1] if spec.m <= 64 else DENSE_TILES[2]
    if spec.m <= 256:
        return DENSE_TILES[1]
    return DENSE_TILES[2] if spec.m <= 1024 else DENSE_TILES[3]


def _dense_hint(spec: KernelSpec) -> TileHint:
    """The one hint of a native spec: full float32 for float32, and the
    kernel-9 tile of `_dense_want`, or the one of nearest block_m (then
    narrowest) among those that divide N and K (no tile if none does)."""
    precision = "highest" if spec.a_dtype == "float32" else "default"
    want = _dense_want(spec)
    fits = [t for t in DENSE_TILES
            if spec.n % t[1] == 0 and spec.k % t[2] == 0]
    if not fits:
        return TileHint("dense", 0, 0, 0, 0, precision)
    bm, bn, bk = want if want in fits else min(
        fits, key=lambda t: (abs(t[0] - want[0]), t[1]))
    return TileHint("dense", bm, bn, bk, 0, precision)


def default_hint(spec: KernelSpec, arch: TileDevice) -> TileHint:
    """The untuned hint (see the module docstring)."""
    del arch   # the same on every target: untuned routing does not move
    if spec.native:
        return _dense_hint(spec)
    if spec.m >= MATERIALIZE_MIN_M and supports_materialize_spec(spec):
        return MATERIALIZE
    return TileHint("fused", *default_tile(spec_format(spec), spec.m))


def enumerate_hints(spec: KernelSpec, arch: TileDevice) -> List[TileHint]:
    """The legal candidates, the default first and the rest by roofline:
    every fused instance whose shared memory fits the arch and whose
    block_n divides N (a ragged last N tile is masked and legal, but the
    space keeps whole tiles; the default tile stays whatever N), and the
    materialize plan from the 256 bucket."""
    first = default_hint(spec, arch)
    if spec.native:
        return [first]
    hints = [TileHint("fused", *tile)
             for tile in FUSED_TILES[spec_format(spec)]]
    hints = [h for h in hints if h != first
             and smem_bytes(spec, h) <= arch.smem_per_block
             and spec.n % h.block_n == 0]
    if spec.m >= MATERIALIZE_TUNE_MIN_M and first != MATERIALIZE \
            and supports_materialize_spec(spec):
        hints.append(MATERIALIZE)
    hints.sort(key=lambda h: roofline_seconds(spec, h, arch))
    return [first] + hints

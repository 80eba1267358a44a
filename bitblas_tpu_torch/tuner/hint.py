"""TileHint: what a tuning hint fixes for one Matmul launch (counterpart
of bitblas_tpu/tuner/hint.py, the fields the port uses).

The port has no tuner yet, so a hint only pins the route of a quantized
Matmul (ops/matmul.py):

  "fused"        the dequant-GEMM kernel, decoding the packed weight
                 inside the product (kernels/dequant_matmul.py);
  "materialize"  the two-pass plan: decode the weight to a dense operand
                 once, then the dense product (kernels/materialize.py).

The JAX package's other decode modes ("mask", "telescope", "asplit") are
TPU decode strategies inside its fused kernel; they raise
NotImplementedError here.
"""

from __future__ import annotations

from dataclasses import dataclass

DECODE_MODES = ("fused", "materialize")


@dataclass(frozen=True)
class TileHint:
    decode_mode: str = "fused"

    def __post_init__(self):
        if self.decode_mode not in DECODE_MODES:
            raise NotImplementedError(
                f"decode_mode {self.decode_mode!r} is not ported "
                f"(bitblas_tpu_torch runs {DECODE_MODES})")

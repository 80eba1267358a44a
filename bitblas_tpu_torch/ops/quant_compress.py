"""QuantCompress: low-bit codes packed into int8 storage words
(counterpart of bitblas_tpu/ops/quant_compress.py).

``QW[n, j] |= W[n, j*e + v] << bits*v``, e = 8 / bits codes a byte, LSB
first: the reference checkpoint layout. It runs as torch ops on the
operator's device (`packing.compress`, the torch form of
`packing.general_compress`, the same bytes); there is no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..common import resolve_device
from ..quantization import packing
from .matmul_config import OperatorConfig
from .weight_transform import as_tensor


@dataclass(frozen=True)
class QuantCompressConfig(OperatorConfig):
    M: Optional[int] = None        # rows (N of the weight), JAX's naming
    N: Optional[int] = None        # columns (K of the weight)
    input_dtype: str = "int8"
    storage_dtype: str = "int8"
    dequantize_bits: int = 4

    def __post_init__(self):
        if self.M is None or self.N is None:
            raise ValueError("M and N must be specified")


class QuantCompress:

    def __init__(self, config: QuantCompressConfig,
                 target: Optional[str] = None, enable_tuning: bool = False,
                 device="cuda", **_):
        del target, enable_tuning
        self.config = config
        self.device = resolve_device(device)

    def forward(self, weight) -> torch.Tensor:
        """Codes [M, N] (the low bits kept) -> int8 [M, N*bits/8]."""
        w = as_tensor(weight, self.device)
        if tuple(w.shape) != (self.config.M, self.config.N):
            raise ValueError(f"weight shape {tuple(w.shape)} != (M, N) = "
                             f"{(self.config.M, self.config.N)}")
        return packing.compress(w, self.config.dequantize_bits)

    __call__ = forward

    def retrieve_output_shape(self):
        bits = self.config.dequantize_bits
        return (self.config.M, self.config.N * bits // 8)

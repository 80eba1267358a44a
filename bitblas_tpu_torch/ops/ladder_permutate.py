"""LadderPermutate: the offline weight layout transform (counterpart of
bitblas_tpu/ops/ladder_permutate.py).

The reference permutes weights into the ladder / ldmatrix order its
tensor-core kernels read; JAX emits its TPU slot-strided pack
(`pack_nslot`). The port emits its own device layout, the one
`Matmul.transform_weight` hands the kernels: codes [M(out), N(red)] ->
K-packed int32 words [M, N*bits/32] (`packing.pack_k`, 32 / bits codes a
word along the reduction). The two layouts hold the same codes and
differ in bytes. Integer weights of 8 bits or more (and dense values,
``dequantize_bits=-1``) are transposed to [N(red), M(out)] as JAX does;
``propagate_kind="A"`` and `TransformKind.NonTransform` return the input
unchanged, as in JAX (activations are never permuted at run time).
Torch ops on the operator's device; no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch

from ..common import resolve_device
from ..quantization import packing
from .common import TransformKind
from .matmul_config import OperatorConfig
from .weight_transform import as_tensor


@dataclass(frozen=True)
class LadderPermutateConfig(OperatorConfig):
    M: Optional[int] = None              # output-feature dim (N of matmul)
    N: Optional[int] = None              # reduction dim (K of matmul)
    datatype: str = "float16"
    dequantize_bits: int = -1            # -1: dense values, else code width
    storage_dtype: str = "int8"
    propagate_kind: Literal["A", "B"] = "B"
    transpose_matrix: bool = True        # True: input is [M, N] (nt layout)
    transform_kind: TransformKind = TransformKind.LDMatrixTransform

    def __post_init__(self):
        if self.M is None or self.N is None:
            raise ValueError("M and N must be specified")
        if isinstance(self.transform_kind, int):
            object.__setattr__(self, "transform_kind",
                               TransformKind(self.transform_kind))


class LadderPermutate:

    def __init__(self, config: LadderPermutateConfig,
                 target: Optional[str] = None, enable_tuning: bool = False,
                 device="cuda", **_):
        del target, enable_tuning
        self.config = config
        self.device = resolve_device(device)

    def forward(self, w) -> torch.Tensor:
        cfg = self.config
        w = as_tensor(w, self.device)
        if cfg.transform_kind == TransformKind.NonTransform \
                or cfg.propagate_kind == "A":
            return w
        mat = w if cfg.transpose_matrix else w.T       # [out, red]
        bits = cfg.dequantize_bits
        if bits is None or bits < 0 or bits >= 8:
            kn = mat.T.contiguous()                    # [red, out]
            return kn.to(torch.int8) if "int" in cfg.storage_dtype else kn
        return packing.pack_k(mat.contiguous(), bits)

    __call__ = forward

"""LOP3Permutate: BitBLAS's LOP3 interleave of the fields inside each
32-bit storage word, and its inverse (counterpart of
bitblas_tpu/ops/lop3_permutate.py).

The Hopper kernels read the plain K-packed layout (quantization/packing
.pack_k) and never this one; the op is kept so that weights repacked for
BitBLAS's GPU kernels round-trip (`inverse(forward(w)) == w`) and scripts
written against the reference's op surface keep working. It runs as
torch ops on the operator's device (`packing.interleave_weight`, bit for
bit the JAX function).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

from ..common import resolve_device
from ..quantization import packing
from .matmul_config import OperatorConfig
from .weight_transform import as_tensor


@dataclass(frozen=True)
class LOP3PermutateConfig(OperatorConfig):
    M: Optional[int] = None
    N: Optional[int] = None
    datatype: str = "float16"
    storage_dtype: str = "int8"
    dequantize_bits: int = 4

    def __post_init__(self):
        if self.M is None or self.N is None:
            raise ValueError("M and N must be specified")


@lru_cache(maxsize=None)
def field_destinations(bits: int, target: str) -> Tuple[int, ...]:
    """The field each source field of a word lands in under the
    interleave: a probe of all ones in each field, as JAX inverts it."""
    out = []
    mask = (1 << bits) - 1
    for i in range(32 // bits):
        probe = torch.tensor([mask << (bits * i)], dtype=torch.int64)
        probe = torch.where(probe >= 1 << 31, probe - (1 << 32), probe)
        word = int(packing.interleave_weight(
            probe.to(torch.int32).view(torch.int8), bits, target)
            .view(torch.int32)[0]) & 0xFFFFFFFF
        out.append(next(j for j in range(32 // bits)
                        if (word >> (bits * j)) & mask))
    return tuple(out)


class LOP3Permutate:

    def __init__(self, config: LOP3PermutateConfig,
                 target: Optional[str] = None, enable_tuning: bool = False,
                 device="cuda", **_):
        del target, enable_tuning
        self.config = config
        self.device = resolve_device(device)

    @property
    def target_dtype(self) -> str:
        return "int8" if "int8" in self.config.datatype else "float16"

    def forward(self, w) -> torch.Tensor:
        """Storage bytes [M, N*bits/8] (a multiple of 4 a row) -> the
        interleaved int8 bytes, in w's shape."""
        cfg = self.config
        w = as_tensor(w, self.device)
        shaped = w.reshape(cfg.M, -1).contiguous().view(torch.int8)
        out = packing.interleave_weight(shaped, cfg.dequantize_bits,
                                        self.target_dtype)
        return out.reshape(w.shape)

    def inverse(self, w) -> torch.Tensor:
        """Undo `forward`: each field moved back from where the interleave
        put it."""
        bits = self.config.dequantize_bits
        w = as_tensor(w, self.device)
        mask = (1 << bits) - 1
        w32 = w.contiguous().reshape(-1).view(torch.int32).to(torch.int64) \
            & 0xFFFFFFFF
        out = torch.zeros_like(w32)
        for src, dst in enumerate(field_destinations(bits,
                                                     self.target_dtype)):
            out |= ((w32 >> (bits * dst)) & mask) << (bits * src)
        out = torch.where(out >= 1 << 31, out - (1 << 32), out)
        return out.to(torch.int32).view(torch.int8).reshape(w.shape)

    __call__ = forward

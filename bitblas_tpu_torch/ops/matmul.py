"""Matmul: the quantized-linear operator (counterpart of
bitblas_tpu/ops/matmul.py).

`transform_weight` turns reference-layout operands into the Hopper device
layout on the operator's device: uint4 codes [N, K] with scales and zeros
[N, K/g] (W4A16), or int2 values [N, K] in -2..1, clamped and biased
(W2A8). `forward(A, W, scale=, zeros=)` runs at any M. PyTorch runs
eagerly, so there is no per-bucket compile and no bucket padding; the
route is chosen per call:

* M < 512: the fused kernel (kernels/dequant_matmul.py), which decodes
  the packed weight inside the product;
* M >= 512: the two-pass materialize plan (kernels/materialize.py):
  decode the weight once, then the dense product.

512 is the bound from which the JAX tuner offers the materialize plan
(bitblas_tpu/tuner/space.py); the port has no tuner yet, so it fixes the
route at that bound. A `TileHint` passed as `hint` pins one route for
every M.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..common import resolve_device
from ..kernels.dequant_matmul import dequant_matmul_i2, dequant_matmul_u4
from ..kernels.materialize import materialize_matmul
from ..kernels.spec import KernelSpec
from ..tuner.hint import TileHint
from .matmul_config import MatmulConfig
from . import weight_transform as wt

MATERIALIZE_MIN_M = 512


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x))


class Matmul:

    def __init__(self, config: MatmulConfig, name: str = "matmul",
                 device="cuda", hint: Optional[TileHint] = None):
        self.config = config
        self.name = name
        self.device = resolve_device(device)
        self.hint = hint
        self.spec = KernelSpec.from_config(config, config.m_buckets[0])

    def retrieve_weight_shape(self) -> Tuple[int, ...]:
        """Device-layout packed weight shape."""
        return self.spec.packed_shape

    def transform_weight(self, weight, scale=None, zeros=None):
        """Reference-layout operands -> device layout: [qweight [N, K*bits/32]
        int32, scales [K/g, N] f16, zeros [K/g, N] f16] (a single tensor
        when only the weight is given)."""
        w = _to_tensor(weight)
        if self.config.source_format == "int":
            result = [wt.signed_weight_to_device(self.config, w)]
        else:
            result = [wt.unpacked_weight_to_device(self.config, w.cpu())]
        if scale is not None:
            result.append(wt.scales_to_device(_to_tensor(scale).cpu()))
        if zeros is not None:
            result.append(wt.scales_to_device(_to_tensor(zeros).cpu()))
        result = [t.to(self.device) for t in result]
        return result[0] if len(result) == 1 else result

    def route(self, m: int) -> str:
        """The hint's decode mode, else "fused" below MATERIALIZE_MIN_M and
        "materialize" from it."""
        if self.hint is not None:
            return self.hint.decode_mode
        return "materialize" if m >= MATERIALIZE_MIN_M else "fused"

    def forward(self, A: torch.Tensor, W: torch.Tensor, scale=None,
                zeros=None) -> torch.Tensor:
        """A [..., K] -> [..., N]: float16 -> float16 (W4A16), int8 ->
        float32 (W2A8)."""
        cfg = self.config
        if cfg.with_scaling and (scale is None or zeros is None):
            raise ValueError("this configuration needs scale and zeros")
        lead = A.shape[:-1]
        A2 = A.reshape(-1, cfg.K).contiguous()
        if self.route(A2.shape[0]) == "materialize":
            out = materialize_matmul(self.spec, A2, W, scale, zeros)
        elif cfg.source_format == "int":
            out = dequant_matmul_i2(A2, W)
        else:
            out = dequant_matmul_u4(A2, W, scale, zeros, cfg.group_size)
        return out.reshape(*lead, cfg.N)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

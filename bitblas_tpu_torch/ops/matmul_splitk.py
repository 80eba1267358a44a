"""MatmulWithSplitK: the reduction split into `k_split` K shards, one
Matmul launch a shard (counterpart of bitblas_tpu/ops/matmul_splitk.py).

Each shard runs Matmul's path at K / k_split (kernel 1 on the fused
route, the hint of the shard's shape); its output is in out_dtype, the
shards are summed in float32 and the sum cast to out_dtype, with the
bias on shard 0 only: JAX's arithmetic. Kernel 1's own split-K decode
instance already spreads a skinny GEMM's K over the SMs in one launch;
this operator keeps the reference's surface and is the pattern that
tensor-parallel row sharding follows across cards.

Device layout: the packed weight is stored shard-major, [k_split, N,
K*bits/32/k_split] int32 (`transform_weight`, `shard_weight`), so shard s
is one contiguous [N, K*bits/32/k_split] block as the kernels take it (a
column slice of Matmul's [N, K*bits/32] words would be a copy at every
call; JAX's K-major ``Wp[s*kk:(s+1)*kk]`` has no counterpart here).
Scales and zeros keep Matmul's [K/g, N]: shard s is rows [s kk/g, (s+1)
kk/g), contiguous. A native weight has no groups (its group is K), so
the configuration's check allows it k_split = 1 only, as in JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ..kernels.spec import KernelSpec
from ..quantization import numerics, packing
from .matmul import Matmul
from .matmul_config import MatmulConfig


@dataclass(frozen=True)
class MatmulConfigWithSplitK(MatmulConfig):
    k_split: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.K % max(self.k_split, 1):
            raise ValueError(f"k_split={self.k_split} must divide K={self.K}")
        g = self.effective_group_size
        if (self.K // max(self.k_split, 1)) % g:
            raise ValueError("K/k_split must stay group-aligned")


class MatmulWithSplitK(Matmul):
    """k_split launches of Matmul's path over K shards, partials summed
    in float32."""

    def __init__(self, config: MatmulConfigWithSplitK,
                 name: str = "matmul_splitk", **kwargs):
        self.k_split = max(config.k_split, 1)
        super().__init__(config, name=name, **kwargs)

    @property
    def shard_k(self) -> int:
        return self.config.K // self.k_split

    def _make_spec(self, m: int) -> KernelSpec:
        return dataclasses.replace(self._spec, m=m, k=self.shard_k)

    def retrieve_weight_shape(self) -> Tuple[int, ...]:
        return (self.k_split, *self._make_spec(1).packed_shape)

    def shard_weight(self, qweight: torch.Tensor) -> torch.Tensor:
        """Matmul's [N, ceil(K*bits/32)] words (wide weights and a native
        weight: their [N, K] or [K, N]) -> [k_split, N, words of a shard],
        shard-major; a shard that ends inside a word is repacked from its
        codes."""
        cfg = self.config
        n, words = qweight.shape
        if cfg.is_native_compute() or cfg.bit > 8 \
                or (self.shard_k * cfg.bit) % 32 == 0:
            return qweight.reshape(n, self.k_split, words // self.k_split) \
                .transpose(0, 1).contiguous()
        codes = packing.unpack_k(qweight, cfg.bit)[:, :cfg.K]
        return torch.stack([packing.pack_k(c, cfg.bit) for c in
                            codes.split(self.shard_k, dim=1)])

    def transform_weight(self, weight, scale=None, zeros=None, bias=None):
        """Matmul.transform_weight with the packed weight shard-major."""
        out = super().transform_weight(weight, scale, zeros, bias)
        if isinstance(out, list):
            return [self.shard_weight(out[0])] + out[1:]
        return self.shard_weight(out)

    def _run(self, hint, A: torch.Tensor, W: torch.Tensor, scale=None,
             zeros=None, bias=None) -> torch.Tensor:
        kk = self.shard_k
        gk = kk // self.config.effective_group_size
        total = None
        for s in range(self.k_split):
            part = super()._run(
                hint, A[:, s * kk:(s + 1) * kk].contiguous(), W[s],
                None if scale is None else scale[s * gk:(s + 1) * gk],
                None if zeros is None else zeros[s * gk:(s + 1) * gk],
                bias if s == 0 else None).float()
            total = part if total is None else total + part
        return numerics.convert(total, self.config.out_dtype)

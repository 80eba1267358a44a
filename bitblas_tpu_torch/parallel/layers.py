"""Tensor-parallel quantized transformer layers (counterpart of
bitblas_tpu/parallel/layers.py).

Megatron's placement over the fused kernels on the ranks of a process
group:

  attention:  q/k/v column-parallel (heads shard with N), o row-parallel
              (an all-reduce joins the head shards)
  mlp:        gate/up column-parallel, down row-parallel

Activations stay replicated between blocks: the column projections gather
their N shards, the row projections take the rank's K slice of the
replicated input and all-reduce. `tp_layer_forward` is
models.quant_llama.layer_forward over these projections.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..models.quant_llama import _PROJS, LlamaConfig, _dim, layer_forward
from ..ops.matmul_config import MatmulConfig
from ..ops.weight_transform import (DeviceWeights,
                                    transform_reference_operands)
from ..testing import random_reference_operands
from . import (make_column_parallel_matmul, make_row_parallel_matmul,
               shard_weights_column, shard_weights_row)

_COLUMN = {"q", "k", "v", "gate", "up"}   # shard N (outputs)
_ROW = {"o", "down"}                      # shard K (inputs) + all-reduce


class TPQuantLlamaLayer:
    """One decoder layer with every projection sharded over `group`. Its
    weights are the JAX layer's draws from the same seed (symmetric uint4
    codes, zero point 8, scales |N(0, 1)| 0.002 + 0.004), so both packages
    build the same layer."""

    def __init__(self, cfg: LlamaConfig, group=None, *, m: int,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.group = group
        tp = dist.get_world_size(group)
        if cfg.num_heads % tp or cfg.num_kv_heads % tp:
            raise ValueError("heads must divide tp")
        self.fns: Dict[str, callable] = {}
        self.weights: Dict[str, DeviceWeights] = {}
        rng = np.random.default_rng(seed)
        for name, kin, kout in _PROJS:
            K, N = _dim(cfg, kin), _dim(cfg, kout)
            mcfg = MatmulConfig(M=m, N=N, K=K, A_dtype=cfg.act_dtype,
                                W_dtype="uint4", with_scaling=True,
                                with_zeros=True, zeros_mode="original",
                                group_size=cfg.group_size,
                                out_dtype=cfg.act_dtype)
            ops = random_reference_operands(
                mcfg, 1, seed=seed * 10 + zlib.crc32(name.encode()) % 7)
            scales = (np.abs(rng.standard_normal((N, K // cfg.group_size)))
                      * 0.002 + 0.004).astype(np.float16)
            zeros = np.full((N, K // cfg.group_size), 8.0, np.float16)
            dw = transform_reference_operands(mcfg, ops.qweight, scales,
                                              zeros)
            dw = DeviceWeights(*(None if t is None else t.to(device)
                                 for t in (dw.qweight, dw.scales, dw.zeros)))
            if name in _COLUMN:
                self.weights[name] = shard_weights_column(dw, mcfg, group)
                self.fns[name] = make_column_parallel_matmul(
                    mcfg, m, group, gather_output=True, device=device)
            else:
                self.weights[name] = shard_weights_row(dw, mcfg, group)
                self.fns[name] = make_row_parallel_matmul(
                    mcfg, m, group, device=device)
        dev = self.weights["q"].qweight.device
        self.attn_norm = torch.ones(cfg.hidden_size, device=dev)
        self.mlp_norm = torch.ones(cfg.hidden_size, device=dev)

    def proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x [..., K] replicated -> [..., N] replicated."""
        w = self.weights[name]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if name in _ROW:
            k = x2.shape[-1] // dist.get_world_size(self.group)
            r = dist.get_rank(self.group)
            x2 = x2[:, r * k:(r + 1) * k].contiguous()
        out = self.fns[name](x2, w.qweight, w.scales, w.zeros)
        return out.reshape(*lead, out.shape[-1])


def tp_layer_forward(layer: TPQuantLlamaLayer, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Replicated-activation forward: models.quant_llama.layer_forward with
    the projections sharded."""
    return layer_forward(layer, x, positions)

"""Graph-level transforms (counterpart of bitblas_tpu/graph):

* `tune_all`: tune every MatmulConfig a model needs on the card, fill the
  global operator cache and persist the hints to the database, so a model
  load never tunes online.
* `repack_gptq_layer` / `repack_gptq_checkpoint`: AutoGPTQ v1 or GPTQModel
  v2 tensor bundles -> the port's device layout, as torch ops on the
  tensors' own device (a checkpoint already on the card is repacked
  there; JAX's walks every weight through numpy on the host).

For 4-bit weights GPTQ's qweight [K/8, N] int32 holds, in word [j, n],
the codes of k = 8 j + i at bits 4 i: exactly the Hopper layout's word
[n, j] (quantization/packing.py), so the device weight is its transpose.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..cache import get_database_path, global_operator_cache
from ..common import get_logger, resolve_device
from ..ops import weight_transform as wt
from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from ..quantization import packing
from ..tuner import auto_detect_target

logger = get_logger()


def as_tensor(x, device=None) -> torch.Tensor:
    """A torch tensor (moved to `device` when given), a numpy array or
    anything with `__array__` -> torch tensor, without a copy where none
    is needed."""
    t = x.detach() if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.ascontiguousarray(np.asarray(x)))
    return t if device is None else t.to(device)


def tune_all(configs: Iterable[MatmulConfig], *, topk: int = 20,
             database_path: Optional[str] = None,
             target: Optional[str] = None,
             device="cuda") -> Dict[MatmulConfig, Matmul]:
    """Build and tune every config (on the card; on the CPU the analytic
    hints stay), fill the global cache, persist the hints."""
    database_path = database_path or get_database_path()
    dev = resolve_device(device)
    target = target or auto_detect_target(dev)
    out = {}
    for cfg in configs:
        op = global_operator_cache.get(cfg)
        if op is None:
            op = Matmul(cfg, device=dev, enable_tuning=False)
            op.hardware_aware_finetune(topk=topk)
            global_operator_cache.add(cfg, op)
        out[cfg] = op
    global_operator_cache.save_into_database(database_path, target)
    logger.info("tuned %d operators into %s/%s", len(out), database_path,
                target)
    return out


def _gptq_zeros(config: MatmulConfig, intzeros: torch.Tensor,
               scales_gn: torch.Tensor) -> torch.Tensor:
    """GPTQ integer zeros [K/g, N] -> the device zeros of the config's
    mode, [K/g, N] in the scales' type (A's: float16 or bfloat16): the
    integers (original, quantized) or z * s rounded to that type
    (rescale, w = q s - z s)."""
    sdt = wt.scale_dtype(config)
    if config.zeros_mode == "rescale":
        z = intzeros.to(torch.float32) * scales_gn.to(torch.float32)
        return z.to(sdt).contiguous()
    return intzeros.to(sdt).contiguous()


def repack_gptq_layer(config: MatmulConfig, qweight, scales, qzeros,
                      bias=None, *, gptq_v2: bool = False,
                      device=None) -> Dict[str, torch.Tensor]:
    """One GPTQ layer bundle (AutoGPTQ conventions: qweight [K*bits/32, N]
    int32, scales [K/g, N], qzeros [K/g, N*bits/32] int32, bias [N]) ->
    {"qweight" [N, K*bits/32] int32, "scales" / "zeros" [K/g, N] in A's
    type (float16, or bfloat16 for a bfloat16 configuration), "bias"
    [1, N] float32}, on `device` (default: the qweight's)."""
    qw = as_tensor(qweight, device)
    dev = qw.device
    bits, K, N = config.bit, config.K, config.N
    if bits == 4 and tuple(qw.shape) == (K // 8, N):
        dev_w = qw.to(torch.int32).T.contiguous()
    else:
        codes = packing.unpack_qweight(qw.T.contiguous(), bits)[:, :K]
        dev_w = wt.unpacked_weight_to_device(config, codes)
    sc = as_tensor(scales, dev).to(wt.scale_dtype(config))
    out = {"qweight": dev_w, "scales": sc.contiguous()}
    if qzeros is not None and config.with_zeros:
        unpack = packing.unpack_qzeros_v2 if gptq_v2 else \
            packing.unpack_qzeros
        intz = unpack(as_tensor(qzeros, dev), bits)[:, :N]       # [K/g, N]
        out["zeros"] = _gptq_zeros(config, intz, sc)
    if bias is not None:
        out["bias"] = wt.bias_to_device(as_tensor(bias, dev))
    return out


def repack_gptq_checkpoint(
    layers: Mapping[str, Tuple],
    configs: Mapping[str, MatmulConfig],
    *, gptq_v2: bool = False, device=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """A whole checkpoint: {layer_name: (qweight, scales, qzeros[, bias])}
    with a config per layer -> {layer_name: device tensor dict}."""
    out = {}
    for name, tensors in layers.items():
        qweight, scales = tensors[0], tensors[1]
        qzeros = tensors[2] if len(tensors) > 2 else None
        bias = tensors[3] if len(tensors) > 3 else None
        out[name] = repack_gptq_layer(configs[name], qweight, scales, qzeros,
                                      bias, gptq_v2=gptq_v2, device=device)
        logger.info("repacked %s", name)
    return out


__all__ = ["tune_all", "repack_gptq_layer", "repack_gptq_checkpoint",
           "as_tensor"]

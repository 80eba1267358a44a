"""Carry the JAX package's weights across to the port.

`from_jax_state` takes ``bitblas_tpu.models.QuantLlama.state_dict()`` with
every array converted by ``np.asarray`` -- {"layer_<i>": {"<proj>.qweight"
[K, N_pad/2] int8, "<proj>.scales" / "<proj>.zeros" [K/g, 1, N_pad] f32,
optional "<proj>.bias", "attn_norm", "mlp_norm"}} -- and returns the
state dict of this package's QuantLlama (CPU tensors; `load_state_dict`
moves them to the model's device). Per projection it undoes the TPU
layout: the XOR 0x80 storage, then the slot-strided N packing at the
canonical tile `pack_tile_n(N_pad, 2)`, then the N padding; then it
applies the Hopper K-packing. Scales and zeros go from [K/g, 1, N_pad]
float32 to [K/g, N] float16 (the JAX package upcast them from float16,
so the downcast is exact).

`from_jax_mixtral_state` does it for ``bitblas_tpu.models.QuantMixtral``
({"layer_<i>": {q / k / v / o bundles, "router" [H, E],
"expert_<e>.<gate|up|down>.<qweight|scales|zeros>", the norms}}): the
attention and every expert projection through the same per-projection
conversion, the router as float32 [H, E], under the port's names
(``layers.<i>.moe.expert_<e>.<proj>.<tensor>``, ``layers.<i>.moe.router``).

`from_jax_bitnet_state` does the same for ``bitblas_tpu.models.BitNetLlama``
({"layer_<i>": {"<proj>.qweight" [K, N_pad/4] int8, "<proj>.sw" scalar,
"attn_norm", "mlp_norm"}}): per projection it undoes the XOR 0x80 storage,
the slot-strided N packing at `pack_tile_n(N_pad, 4)` and the N padding,
then K-packs the biased int2 fields. Both take numpy arrays only and
import nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.quant_llama import _PROJS, LlamaConfig, _dim
from .models.quant_moe import EXPERT_PROJS
from .quantization import packing


def _tpu_fields(qweight: np.ndarray, bits: int, n: int) -> np.ndarray:
    """The JAX TPU layout [K, N_pad*bits/8] int8 (XOR 0x80 storage,
    slot-strided N packing, N padded) -> the unsigned fields [N, K]."""
    e = 8 // bits
    n_pad = qweight.shape[1] * e
    plain = (qweight.view(np.uint8) ^ 0x80).view(np.int8)
    fields_kn = packing.unpack_nslot(plain, bits,
                                     packing.pack_tile_n(n_pad, e))
    return np.ascontiguousarray(fields_kn[:, :n].T)


def _projection(qweight: np.ndarray, scales: np.ndarray, zeros: np.ndarray,
                n: int):
    codes_nk = _tpu_fields(qweight, 4, n)
    return (packing.pack_k(torch.from_numpy(codes_nk), 4),
            torch.from_numpy(np.ascontiguousarray(
                scales[:, 0, :n]).astype(np.float16)),
            torch.from_numpy(np.ascontiguousarray(
                zeros[:, 0, :n]).astype(np.float16)))


def from_jax_state(jax_state_np: Dict[str, Dict[str, np.ndarray]],
                   cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """JAX QuantLlama state (numpy) -> port QuantLlama state dict."""
    out = {}
    for i in range(cfg.num_layers):
        layer = jax_state_np[f"layer_{i}"]
        base = f"layers.{i}."
        for name, _, kout in _PROJS:
            w, s, z = _projection(np.asarray(layer[f"{name}.qweight"]),
                                  np.asarray(layer[f"{name}.scales"]),
                                  np.asarray(layer[f"{name}.zeros"]),
                                  _dim(cfg, kout))
            out[base + f"{name}_qweight"] = w
            out[base + f"{name}_scales"] = s
            out[base + f"{name}_zeros"] = z
            if f"{name}.bias" in layer:
                out[base + f"{name}_bias"] = torch.tensor(
                    np.asarray(layer[f"{name}.bias"], np.float32))
        for norm in ("attn_norm", "mlp_norm"):
            out[base + norm] = torch.tensor(
                np.asarray(layer[norm], np.float32))
    return out


def from_jax_moe_state(layer: Dict[str, np.ndarray], cfg
                       ) -> Dict[str, torch.Tensor]:
    """One JAX layer's routed FFN ({"router", "expert_<e>.<proj>.<...>"})
    -> the port QuantMoELayer's state dict; `cfg` a MoEConfig or a
    MixtralConfig."""
    out = {"router": torch.tensor(np.asarray(layer["router"], np.float32))}
    for e in range(cfg.n_experts):
        for name, _, kout in EXPERT_PROJS:
            key = f"expert_{e}.{name}"
            w, s, z = _projection(np.asarray(layer[f"{key}.qweight"]),
                                  np.asarray(layer[f"{key}.scales"]),
                                  np.asarray(layer[f"{key}.zeros"]),
                                  getattr(cfg, kout))
            out[f"{key}.qweight"] = w
            out[f"{key}.scales"] = s
            out[f"{key}.zeros"] = z
    return out


def from_jax_mixtral_state(jax_state_np: Dict[str, Dict[str, np.ndarray]],
                           cfg) -> Dict[str, torch.Tensor]:
    """JAX QuantMixtral state (numpy) -> port QuantMixtral state dict;
    `cfg` the MixtralConfig."""
    out = {}
    for i in range(cfg.num_layers):
        layer = jax_state_np[f"layer_{i}"]
        base = f"layers.{i}."
        for name, _, kout in _PROJS[:4]:
            w, s, z = _projection(np.asarray(layer[f"{name}.qweight"]),
                                  np.asarray(layer[f"{name}.scales"]),
                                  np.asarray(layer[f"{name}.zeros"]),
                                  _dim(cfg, kout))
            out[base + f"{name}_qweight"] = w
            out[base + f"{name}_scales"] = s
            out[base + f"{name}_zeros"] = z
        for norm in ("attn_norm", "mlp_norm"):
            out[base + norm] = torch.tensor(
                np.asarray(layer[norm], np.float32))
        for key, t in from_jax_moe_state(layer, cfg).items():
            out[base + "moe." + key] = t
    return out


def bitnet_projection(qweight: np.ndarray, n: int) -> torch.Tensor:
    """One JAX int2 projection [K, N_pad/4] int8 -> [N, K/16] int32
    K-packed biased fields (the fields are already biased: value + 2)."""
    return packing.pack_k(torch.from_numpy(_tpu_fields(qweight, 2, n)), 2)


def from_jax_bitnet_state(jax_state_np: Dict[str, Dict[str, np.ndarray]],
                          cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """JAX BitNetLlama state (numpy) -> port BitNetLlama state dict."""
    out = {}
    for i in range(cfg.num_layers):
        layer = jax_state_np[f"layer_{i}"]
        base = f"layers.{i}."
        for name, _, kout in _PROJS:
            out[base + f"projs.{name}.qweight"] = bitnet_projection(
                np.asarray(layer[f"{name}.qweight"]), _dim(cfg, kout))
            out[base + f"projs.{name}.sw"] = torch.tensor(
                float(np.asarray(layer[f"{name}.sw"])), dtype=torch.float32)
        for norm in ("attn_norm", "mlp_norm"):
            out[base + norm] = torch.tensor(
                np.asarray(layer[norm], np.float32))
    return out

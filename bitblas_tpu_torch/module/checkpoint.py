"""Checkpoint save / load of quantized layer states (counterpart of
bitblas_tpu/module/checkpoint.py: `save_quant_state`, `load_quant_state`).

A repacked model's device-layout tensors are plain tensors, so a
checkpoint is one npz (``<path>.npz``, keys ``<layer>/<tensor>``, or a
module's own state-dict names for a flat state dict such as
``QuantMixtral.state_dict()``) with a ``<path>.npz.meta.json`` sidecar.
The sidecar carries the port's own layout tag, `DEVICE_LAYOUT`: the
Hopper K-packed words of quantization/packing.py with [K/g, N] float16
scales and zeros. The JAX
package stamps ``device_layout_version`` for its TPU layout (slot-strided
N packing, XOR 0x80 storage, N padding), whose words would decode wrong
here; `load_quant_state` refuses any sidecar without the port's tag, and
the JAX loader refuses ours (it finds no ``device_layout_version``). The
orbax and Flax NNX savers of the JAX module are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..common import resolve_device

# Bump the suffix whenever the packed device layout changes incompatibly.
DEVICE_LAYOUT = "bitblas_tpu_torch.hopper_kpack.v1"


def _meta_path(path: str) -> str:
    return (path if path.endswith(".npz") else path + ".npz") + ".meta.json"


def _check_layout(meta: dict, where: str) -> None:
    tag = meta.get("device_layout")
    if tag == DEVICE_LAYOUT:
        return
    if tag is None and "device_layout_version" in meta:
        raise ValueError(
            f"{where} was written by the JAX package (TPU device layout "
            f"v{meta['device_layout_version']}: slot-strided, XOR-stored "
            f"words) and would decode wrong here; repack it from the "
            f"source (GPTQ) checkpoint")
    raise ValueError(
        f"{where} has device layout {tag!r}; this build reads "
        f"{DEVICE_LAYOUT!r}: repack it from the source checkpoint")


def _host(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def save_quant_state(path: str, layers: Mapping[str, object],
                     meta: dict | None = None) -> None:
    """layers: {layer_name: {tensor_name: tensor}}, or a flat state dict
    {name: tensor} (a model's `state_dict()`), or both mixed -> <path>.npz
    (tensors copied to the host) + <path>.npz.meta.json (`meta` and the
    layout tag)."""
    flat = {}
    for lname, tensors in layers.items():
        if not isinstance(tensors, Mapping):
            flat[lname] = _host(tensors)
            continue
        for tname, t in tensors.items():
            flat[f"{lname}/{tname}"] = _host(t)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    np.savez(path, **flat)
    meta = dict(meta or {})
    meta["device_layout"] = DEVICE_LAYOUT
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f, indent=1)


def load_quant_state(path: str, device="cuda") -> Dict[str, object]:
    """<path>.npz -> {layer_name: {tensor_name: tensor on `device`}} (a
    flat state dict's entries as {name: tensor}, ready for the module's
    `load_state_dict`); a checkpoint without the port's layout tag raises
    ValueError."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    _check_layout(meta, path)
    dev = resolve_device(device)
    out: Dict[str, object] = {}
    with np.load(path) as data:
        for key in data.files:
            t = torch.from_numpy(data[key]).to(dev)
            if "/" in key:
                lname, tname = key.rsplit("/", 1)
                out.setdefault(lname, {})[tname] = t
            else:
                out[key] = t
    return out


__all__ = ["DEVICE_LAYOUT", "save_quant_state", "load_quant_state"]

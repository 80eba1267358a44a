"""Reference layout <-> Hopper device layout (counterpart of
bitblas_tpu/ops/weight_transform.py).

The chain is: unpack the reference packing -> K-packed int32 words
(quantization/packing.pack_k: 32 / bits codes of 1, 2, 4 or 8 bits per
word; the reference stores 8-bit weights one byte a code, int8 as two's
complement and fp8 as its bits); sub-byte int values are clamped and
biased first (`signed_weight_to_device`, the JAX Matmul.transform_weight
rule); scales and zeros [N, K/g] -> [K/g, N] in A's type (float16 or
bfloat16: `scale_dtype`) for every group size; quantized zeros
(reference [K/g, N*bits/8] int8, packed along N) are unpacked to the same
[K/g, N] zeros, since (q - z) * s with an integer z is exactly the
original mode's value (`zeros_to_device`); a bias [N] -> [1, N] float32.
Every transform of a tensor stays on the tensor's device. The TPU's
slot-strided N packing, its XOR-0x80 storage and its [K/g, 1, N] float32
scale planes are Mosaic workarounds and have no counterpart here. Each
transform has an inverse so tests can round-trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..quantization import numerics, packing
from ..quantization.formats import as_torch_dtype
from .matmul_config import MatmulConfig, specialized
from .reference import decode_name


@dataclass
class DeviceWeights:
    """Device-layout operand bundle for the dequant kernel."""
    qweight: torch.Tensor                  # [N, K*bits/32] int32
    scales: Optional[torch.Tensor] = None  # [K/g, N] A's type
    zeros: Optional[torch.Tensor] = None   # [K/g, N] A's type
    bias: Optional[torch.Tensor] = None    # [1, N] float32

    def args(self):
        """The operands a forward takes after A, those present, in order."""
        return [t for t in (self.qweight, self.scales, self.zeros, self.bias)
                if t is not None]


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor of `x` (a tensor, numpy array or nested list), moved to
    `device` where one is given."""
    t = x if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.ascontiguousarray(x))
    return t if device is None else t.to(device)


def scale_dtype(config: MatmulConfig) -> torch.dtype:
    """The type of the device scales and zeros: for the specialized kernels
    A's (float16 or bfloat16; float16 for int8 activations); for the
    general instance the decode type's (ops/reference.decode_name: JAX
    casts them to it)."""
    if not specialized(config):
        return as_torch_dtype(decode_name(config))
    return torch.bfloat16 if config.A_dtype == "bfloat16" else torch.float16


def general_quantized_zeros(config: MatmulConfig) -> bool:
    """Whether the device zeros are the int32 values of quantized zeros
    (the general instance: JAX subtracts them from the fields before the
    decode type, which for nf4 / fp / fp8 formats is not the original
    mode's value)."""
    return config.zeros_mode == "quantized" and not specialized(config)


def unpacked_weight_to_device(config: MatmulConfig,
                              w_fields_nk) -> torch.Tensor:
    """[N, K] unsigned fields -> [N, ceil(K*bits/32)] int32 K-packed words;
    wide int / uint values -> [N, K] int16 / int32 words (uint values
    wrapped into the signed container, as JAX stores them)."""
    codes = w_fields_nk if isinstance(w_fields_nk, torch.Tensor) else \
        as_tensor(_signed_view(np.asarray(w_fields_nk)))
    if tuple(codes.shape) != (config.N, config.K):
        raise ValueError(f"weight shape {tuple(codes.shape)} != "
                         f"(N, K) = {(config.N, config.K)}")
    if config.bit > 8:
        return numerics.convert(codes.to(torch.int64),
                                f"int{config.bit}").contiguous()
    return packing.pack_k(codes, config.bit)


def _signed_view(a: np.ndarray) -> np.ndarray:
    """uint16 / uint32 arrays as the signed type of their width (torch
    computes little with its unsigned types)."""
    return a.view(f"int{a.dtype.itemsize * 8}") if a.dtype.kind == "u" \
        and a.dtype.itemsize > 1 else a


def signed_weight_to_device(config: MatmulConfig,
                            values_nk) -> torch.Tensor:
    """[N, K] int values (int2: -2..1) -> biased fields -> K-packed words;
    a tensor stays on its device."""
    values = values_nk if isinstance(values_nk, torch.Tensor) \
        else torch.as_tensor(np.asarray(values_nk))
    return unpacked_weight_to_device(
        config, packing.bias_signed_weight(values, config.bit))


def reference_weight_to_device(config: MatmulConfig,
                               qweight: np.ndarray) -> torch.Tensor:
    """Reference packed qweight [N, K*bits/8] int8 (8-bit formats: [N, K],
    one byte a code; wide formats [N, K] words) -> device layout."""
    q = np.asarray(qweight)
    if config.bit > 8:
        return unpacked_weight_to_device(config, q)
    if config.bit == 8:
        return unpacked_weight_to_device(config, q.view(np.uint8))
    fields = packing.general_decompress(q.view(np.int8), config.bit,
                                        out_elems=config.K)
    return unpacked_weight_to_device(config, fields)


def device_weight_to_reference(config: MatmulConfig,
                               qweight: torch.Tensor) -> np.ndarray:
    """Inverse of reference_weight_to_device."""
    if config.bit > 8:
        return qweight.cpu().numpy()
    codes = packing.unpack_k(qweight.cpu(), config.bit)[:, :config.K] \
        .numpy()
    if config.bit == 8:
        return codes.view(np.int8)
    return packing.general_compress(codes, config.bit)


def scales_to_device(scales_ngk,
                     dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """[N, K/g] -> [K/g, N] in `dtype` (the scales' type), contiguous;
    into a float8 type as XLA converts (numerics.convert)."""
    t = torch.as_tensor(np.asarray(scales_ngk)
                        if not isinstance(scales_ngk, torch.Tensor)
                        else scales_ngk)
    if dtype in _FLOAT8_NAMES:
        return numerics.convert(t, _FLOAT8_NAMES[dtype]).T.contiguous()
    return t.to(dtype).T.contiguous()


_FLOAT8_NAMES = {torch.float8_e4m3fn: "e4m3_float8",
                 torch.float8_e5m2: "e5m2_float8"}


def scales_from_device(scales_gn: torch.Tensor) -> np.ndarray:
    """Inverse of scales_to_device."""
    return scales_gn.T.contiguous().cpu().numpy()


def qzeros_to_device(config: MatmulConfig, qzeros) -> torch.Tensor:
    """Reference quantized zeros [K/g, N*bits/8] int8 (packed along N,
    LSB first) -> their integer values as [K/g, N] zeros in the scales'
    type (the general instance: int32), on the tensor's device."""
    q = qzeros if isinstance(qzeros, torch.Tensor) \
        else torch.as_tensor(np.asarray(qzeros))
    if config.bit > 8:
        raise ValueError(f"quantized zeros of {config.W_dtype} weights "
                         f"(packed in bytes, as JAX packs them, a field "
                         f"holds 8 bits at most)")
    fields = packing.decompress(q.to(torch.int8), config.bit)
    dt = torch.int32 if general_quantized_zeros(config) \
        else scale_dtype(config)
    return fields[:, :config.N].to(dt).contiguous()


def zeros_to_device(config: MatmulConfig, zeros) -> torch.Tensor:
    """The zeros of the configuration's mode -> [K/g, N] in A's type:
    [N, K/g] values (original, rescale), or packed quantized zeros
    (`qzeros_to_device`)."""
    if config.zeros_mode == "quantized":
        return qzeros_to_device(config, zeros)
    return scales_to_device(zeros, scale_dtype(config))


def bias_to_device(bias) -> torch.Tensor:
    """[N] -> [1, N] float32, contiguous, on the tensor's device."""
    b = bias if isinstance(bias, torch.Tensor) \
        else torch.as_tensor(np.asarray(bias))
    return b.to(torch.float32).reshape(1, -1).contiguous()


def transform_reference_operands(config: MatmulConfig, qweight: np.ndarray,
                                 scales: Optional[np.ndarray] = None,
                                 zeros: Optional[np.ndarray] = None,
                                 qzeros: Optional[np.ndarray] = None,
                                 bias: Optional[np.ndarray] = None
                                 ) -> DeviceWeights:
    """Bundle-transform reference-layout operands (ops/reference.py's
    shapes; `qzeros` for zeros mode quantized) into the device layout."""
    dw = DeviceWeights(qweight=reference_weight_to_device(config, qweight))
    if config.with_scaling:
        dw.scales = scales_to_device(scales, scale_dtype(config))
    if config.with_zeros:
        dw.zeros = zeros_to_device(
            config, qzeros if config.zeros_mode == "quantized" else zeros)
    if bias is not None:
        dw.bias = bias_to_device(bias)
    return dw

"""Bit-exact decode formulas for the uint and int families, as torch ops
(counterpart of bitblas_tpu/quantization/numerics.py).

Conventions are the JAX package's: a packed word holds
``storage_bits // bits`` fields, field ``i`` at bit offset ``bits * i``
(LSB first, the reference ``general_compress`` layout); decode functions
take an unpacked field and produce the target float dtype.

The dequant kernel (csrc/dequant_matmul.cu) decodes with the f16 magic
number of `fast_decode_uint_to_f16`: ``0x6400 | q`` is the f16 bit pattern
of ``1024 + q`` for any ``q < 1024``, so one OR and one f16 subtract turn
a field into its exact f16 value without an int->float convert (the
reference's LOP3 trick). This module keeps the formula testable on the
CPU; the tests hold it bit-identical to the plain cast.
"""

from __future__ import annotations

from typing import Optional

import torch


def unpack_fields(packed: torch.Tensor, bits: int, *, axis: int = -1,
                  storage_bits: Optional[int] = None) -> torch.Tensor:
    """Unpack sub-word fields along `axis`, LSB-first.

    packed [..., P, ...] -> int32 [..., P*elems, ...] with element
    ``p*elems + i`` taken from bits ``[bits*i, bits*(i+1))`` of word ``p``.
    Signed containers are read as unsigned (two's complement bits).
    """
    if storage_bits is None:
        storage_bits = packed.element_size() * 8
    elems = storage_bits // bits
    if axis < 0:
        axis += packed.dim()
    u = packed.to(torch.int64) & ((1 << storage_bits) - 1)
    shape = [1] * (u.dim() + 1)
    shape[axis + 1] = elems
    shifts = (torch.arange(elems, device=packed.device, dtype=torch.int64)
              * bits).reshape(shape)
    fields = (u.unsqueeze(axis + 1) >> shifts) & ((1 << bits) - 1)
    new_shape = list(packed.shape)
    new_shape[axis] *= elems
    return fields.reshape(new_shape).to(torch.int32)


def decode_uint_field(field: torch.Tensor, bits: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """uint field -> dtype (reference `_tir_packed_to_unsigned_convert`)."""
    del bits
    return field.to(dtype)


def decode_int_field(field: torch.Tensor, bits: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """int field -> dtype: the value is stored biased by 2^(bits-1)
    (packing.bias_signed_weight), so value = field - 2^(bits-1), taken in
    int32 before the cast (the JAX `decode_int_field`)."""
    return (field.to(torch.int32) - (1 << (bits - 1))).to(dtype)


def decode_field(field: torch.Tensor, family: str, bits: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Dispatch on the source-format family (uint or int)."""
    if family == "uint":
        return decode_uint_field(field, bits, dtype)
    if family == "int":
        return decode_int_field(field, bits, dtype)
    raise NotImplementedError(f"source format {family}{bits} is not ported")


def fast_decode_uint_to_f16(field: torch.Tensor, bits: int) -> torch.Tensor:
    """uint{1,2,4} field -> f16 through the 0x6400 exponent-bias bitcast:
    ``0x6400 | q`` is 1024 + q in f16, so subtracting 1024 is exact."""
    del bits
    magic = (field.to(torch.int32) | 0x6400).to(torch.int16)
    return magic.view(torch.float16) - torch.tensor(1024.0,
                                                    dtype=torch.float16)


def apply_scaling(w: torch.Tensor, scale: Optional[torch.Tensor],
                  zeros: Optional[torch.Tensor],
                  zeros_mode: str) -> torch.Tensor:
    """Reference semantics (the JAX `apply_scaling`):
      original:  (w - zeros) * scale
      rescale:    w * scale - zeros
      quantized:  w * scale   (zero subtracted before the cast)
    `scale`/`zeros` are broadcast to w's shape by the caller."""
    if scale is None:
        return w
    if zeros is None or zeros_mode == "quantized":
        return w * scale
    if zeros_mode == "original":
        return (w - zeros) * scale
    if zeros_mode == "rescale":
        return w * scale - zeros
    raise ValueError(f"Unsupported zeros_mode: {zeros_mode}")


def saturate(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Round and clamp an accumulator for a narrow-int output dtype; the
    identity for float outputs (whose cast rounds to nearest and overflows
    to inf, as the JAX `saturate_cast` does)."""
    if not out_dtype.is_floating_point and out_dtype.itemsize < 4:
        info = torch.iinfo(out_dtype)
        if x.is_floating_point():
            x = torch.round(x)
        x = torch.clamp(x, info.min, info.max)
    return x


def saturate_cast(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return saturate(x, out_dtype).to(out_dtype)

"""Bit-exact decode formulas for every weight family, as torch ops
(counterpart of bitblas_tpu/quantization/numerics.py).

Conventions are the JAX package's: a packed word holds
``storage_bits // bits`` fields, field ``i`` at bit offset ``bits * i``
(LSB first, the reference ``general_compress`` layout); decode functions
take an unpacked field and produce the target float dtype, bit for bit
the JAX function of the same name (`decode_field` and the per-family
decoders; the bf16 "fast" decoders the JAX kernel uses).

The kernels (csrc/decode_formats.cuh) decode into float16 or bfloat16
registers with magic numbers and bit surgery: ``0x6400 | q`` is the f16
bit pattern of ``1024 + q`` for any ``q < 1024`` (bf16: ``0x4300 | q`` is
``128 + q`` for ``q <= 127``), so one OR and one subtract turn a field
into its exact value without an int->float convert (the reference's LOP3
trick). Every value `decode_field` gives in float16 or bfloat16 is exact
there, so those routes and the formulas below agree bit for bit (NaN
payloads aside); the tests hold them to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .formats import nf4_lut


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


def decode_fp4_field(field: torch.Tensor,
                     dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """fp4_e2m1 4-bit field -> dtype, the reference `_tir_packed_to_fp4_to_f16`
    (the JAX `decode_fp4_field`): the low three bits e, ORed with 8, are
    placed at f16 bit 10 with the sign at bit 15, so the value is
    +-2^(e - 7), and +0 for e = 0. Not OCP e2m1."""
    f4 = field.to(torch.int32)
    e = f4 & 7
    bits16 = ((e | 8) | ((f4 >> 3) << 5)) << 10
    val = bits16.to(torch.int16).view(torch.float16)
    return torch.where(e == 0, torch.zeros_like(val), val).to(dtype)


def decode_f8e4m3_byte(byte: torch.Tensor,
                       dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """float8_e4m3 byte -> dtype by the reference's bit surgery (the JAX
    `decode_f8e4m3_byte`): f16 exponent e4 + 8, no subnormals, no NaN."""
    v = byte.to(torch.int32) & 0xFF
    s_f16 = (v >> 7) << 15
    e4 = v & 0x40
    e_f16 = ((v & 63) << 7) | (e4 << 8) | (e4 << 7)
    e_f16 = e_f16 ^ 0x2000
    bits16 = (s_f16 | e_f16).to(torch.int16)
    return bits16.view(torch.float16).to(dtype)


def decode_f8e5m2_byte(byte: torch.Tensor,
                       dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """float8_e5m2 byte -> dtype: f16's top byte (the JAX
    `decode_f8e5m2_byte`)."""
    v = ((byte.to(torch.int32) & 0xFF) << 8).to(torch.int16)
    return v.view(torch.float16).to(dtype)


def decode_nf4_field(field: torch.Tensor,
                     dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """NF4 4-bit field -> its table value rounded to dtype (the JAX
    `decode_nf4_field` with `nf4_lut(dtype)`)."""
    lut = nf4_lut(dtype).to(field.device)
    return lut[field.to(torch.int64)]


def decode_field(field: torch.Tensor, family: str, bits: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Dispatch on the source-format family (the JAX `decode_field`)."""
    if family == "uint":
        return decode_uint_field(field, bits, dtype)
    if family == "int":
        return decode_int_field(field, bits, dtype)
    if family == "fp" and bits == 4:
        return decode_fp4_field(field, dtype)
    if family == "fp_e4m3":
        return decode_f8e4m3_byte(field, dtype)
    if family == "fp_e5m2":
        return decode_f8e5m2_byte(field, dtype)
    if family == "nf":
        return decode_nf4_field(field, dtype)
    raise ValueError(f"Unsupported source format {family}{bits}")


def decode_codes(codes: torch.Tensor, family: str, bits: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Stored codes (as `unpack_fields` / packing.unpack_k give them,
    unsigned) -> values in dtype, as the JAX oracle decodes them: 8-bit
    int weights are stored unbiased (two's complement bytes), every other
    family through `decode_field`."""
    if family == "int" and bits == 8:
        return codes.to(torch.uint8).view(torch.int8).to(dtype)
    return decode_field(codes, family, bits, dtype)


def fast_decode_uint_to_f16(field: torch.Tensor, bits: int) -> torch.Tensor:
    """uint{1,2,4} field -> f16 through the 0x6400 exponent-bias bitcast:
    ``0x6400 | q`` is 1024 + q in f16, so subtracting 1024 is exact."""
    del bits
    magic = (field.to(torch.int32) | 0x6400).to(torch.int16)
    return magic.view(torch.float16) - torch.tensor(1024.0,
                                                    dtype=torch.float16)


def _bf16(bits16: torch.Tensor) -> torch.Tensor:
    """int32 lanes holding 16-bit patterns -> bfloat16 of those bits."""
    return torch.where(bits16 >= 1 << 15, bits16 - (1 << 16),
                       bits16).to(torch.int16).view(torch.bfloat16)


def fast_decode_uint_to_bf16(field: torch.Tensor, bits: int) -> torch.Tensor:
    """uint{1,2,4} field -> bf16: ``0x4300 | q`` is 128 + q, exact for q
    <= 127, less 128 (the JAX `fast_decode_uint_to_bf16`)."""
    del bits
    return _bf16(field.to(torch.int32) | 0x4300) - torch.tensor(
        128.0, dtype=torch.bfloat16)


def decode_f8e4m3_to_bf16_fast(byte: torch.Tensor) -> torch.Tensor:
    """float8_e4m3 byte -> bf16 bit pattern ((v & 0x7f) << 4) + 120 << 7 |
    sign (the JAX `decode_f8e4m3_to_bf16_fast`)."""
    v = byte.to(torch.int32) & 0xFF
    return _bf16((((v & 0x7F) << 4) + (120 << 7)) | ((v >> 7) << 15))


def decode_f8e5m2_to_bf16_fast(byte: torch.Tensor) -> torch.Tensor:
    """float8_e5m2 byte -> bf16 (the JAX `decode_f8e5m2_to_bf16_fast`):
    normals as the raw-exponent pattern times 2^112, the exponent-0 codes
    (payload < 4) as m 2^-16 with the sign ORed in; exponent-31 codes give
    finite values there, as in JAX."""
    v = byte.to(torch.int32) & 0xFF
    payload = v & 0x7F
    sbit = (v >> 7) << 15
    two112 = torch.tensor(2.0 ** 112, dtype=torch.bfloat16)
    normal = _bf16((payload << 5) | sbit) * two112
    m_f = payload.to(torch.bfloat16)
    subm = (m_f * torch.tensor(2.0 ** -16, dtype=torch.bfloat16)).view(
        torch.int16).to(torch.int32) & 0xFFFF
    sub = _bf16(subm | sbit)
    return torch.where(payload < 4, sub, normal)


def decode_fp4_field_bf16_fast(field: torch.Tensor) -> torch.Tensor:
    """fp4_e2m1 field -> bf16, select-free (the JAX
    `decode_fp4_field_bf16_fast`): the pattern e << 7 | s << 15 times
    2^120, so payload 0 gives -0.0 for the negative codes where
    `decode_fp4_field` gives +0.0."""
    f4 = field.to(torch.int32)
    return _bf16(((f4 & 7) << 7) | ((f4 >> 3) << 15)) * torch.tensor(
        2.0 ** 120, dtype=torch.bfloat16)


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

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

from .formats import (FLOAT8, INT_TYPES, NF4_TABLE, as_torch_dtype,
                      int_range, nf4_lut)


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


# -- conversions and decodes into any dense type (the general route) --------

def convert(x: torch.Tensor, name: str) -> torch.Tensor:
    """XLA's conversion of `x` into the dense type `name` (JAX's astype),
    held in name's torch storage (formats.TORCH_DTYPES). Into a float
    type: rounded to nearest even; past the type's largest value to inf,
    but e4m3 to NaN (it has no inf: above 464, as ml_dtypes and XLA round,
    where torch would saturate). Into an integer type: a float truncated
    toward zero, NaN to 0, clamped to the type's range; an integer wrapped
    to the type's bits (two's complement)."""
    dt = as_torch_dtype(name)
    if name in INT_TYPES:
        bits, signed = INT_TYPES[name]
        if x.is_floating_point():
            lo, hi = int_range(name)
            v = torch.nan_to_num(x.double().trunc(), nan=0.0, posinf=hi,
                                 neginf=lo).clamp(lo, hi).to(torch.int64)
        else:
            v = x.to(torch.int64) & ((1 << bits) - 1)
            if signed:
                v = torch.where(v >= 1 << (bits - 1), v - (1 << bits), v)
        return v.to(dt)
    if name == "e4m3_float8":
        f = x.double() if not x.is_floating_point() else x
        f = f.float() if f.dtype in (torch.float16, torch.bfloat16,
                                     torch.float8_e4m3fn,
                                     torch.float8_e5m2) else f
        b = f.to(dt).view(torch.uint8)
        over = ~torch.isfinite(f) | (f.abs() > 464)
        return torch.where(over, torch.full_like(b, 0x7F),
                           b).view(dt)
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        x = x.float()
    return x.to(dt)


def to_float(x: torch.Tensor) -> torch.Tensor:
    """A dense value tensor in float32 (float64 stays float64): exact for
    every float type of 32 bits or fewer and every integer within 2^24."""
    return x if x.dtype == torch.float64 else x.float()


def fields_of(codes: torch.Tensor, family: str, bits: int) -> torch.Tensor:
    """Stored codes (unsigned, as `unpack_fields` or packing.unpack_k give
    them; a wide weight's words) -> the int64 fields the JAX oracle
    decodes: 8-bit and wide int weights their signed values, wide uint
    weights their unsigned ones, every other code as it is."""
    c = codes.to(torch.int64)
    if family == "int" and bits >= 8:
        return convert(c, f"int{bits}").to(torch.int64)
    if bits >= 8:
        return c & ((1 << bits) - 1)
    return c


def decode_to(fields: torch.Tensor, family: str, bits: int,
              name: str) -> torch.Tensor:
    """int64 fields (`fields_of`) -> values in the dense type `name`, as
    the JAX oracle decodes them (`dequantize_weight`): uint and wide int
    fields converted, sub-byte int fields less 2^(bits-1) converted, fp4,
    e4m3 and e5m2 decoded to float16 by the reference's formulas and then
    converted, nf4 the float32 table converted; so an integer `name`
    truncates (and saturates) the float formats, and wraps nf4's -1 into
    an unsigned type, as JAX's host-side table does."""
    if family == "uint" or (family == "int" and bits >= 8):
        return convert(fields, name)
    if family == "int":
        return convert(fields - (1 << (bits - 1)), name)
    if family == "fp" and bits == 4:
        return convert(decode_fp4_field(fields, torch.float16), name)
    if family == "fp_e4m3":
        return convert(decode_f8e4m3_byte(fields, torch.float16), name)
    if family == "fp_e5m2":
        return convert(decode_f8e5m2_byte(fields, torch.float16), name)
    if family == "nf":
        # JAX's table is NF4_TABLE converted on the host (numpy): into an
        # integer type truncated and wrapped (-1.0 into uint8 is 255)
        table = torch.from_numpy(NF4_TABLE).to(fields.device)
        if name in INT_TYPES:
            table = table.trunc().long()
        return convert(table[fields], name)
    raise ValueError(f"Unsupported source format {family}{bits}")


def scale_in(w: torch.Tensor, scale, zeros, zeros_mode: str,
             name: str) -> torch.Tensor:
    """`apply_scaling` with every op rounded to the float type `name`, as
    JAX computes it in the weight's type (float8 types: each op in
    float32, then converted)."""
    if name not in FLOAT8:
        return apply_scaling(w, scale, zeros, zeros_mode)
    f = lambda t: None if t is None else t.float()   # noqa: E731
    r = lambda t: convert(t, name).float()           # noqa: E731
    w, scale, zeros = f(w), f(scale), f(zeros)
    if scale is None:
        out = w
    elif zeros is None or zeros_mode == "quantized":
        out = r(w * scale)
    elif zeros_mode == "original":
        out = r(r(w - zeros) * scale)
    else:
        out = r(r(w * scale) - zeros)
    return convert(out, name)


def cast_output(x: torch.Tensor, name: str) -> torch.Tensor:
    """The JAX oracle's cast of the sums to out_dtype `name`
    (`cast_output`): integer types narrower than 32 bits saturate (a float
    rounded half to even, then clamped), then `convert`."""
    if name in INT_TYPES and INT_TYPES[name][0] < 32:
        lo, hi = int_range(name)
        if x.is_floating_point():
            x = torch.round(x)
        x = torch.clamp(x, lo, hi)
    return convert(x, name)

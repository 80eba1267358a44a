"""The two-pass "materialize" plan: decode the packed weight to a dense
operand once, then the dense product (counterpart of
bitblas_tpu/kernels/materialize.py).

The fused kernels (kernels/dequant_matmul.py) decode every weight tile
again for each M tile; at large M that repeated decode costs more than
writing the decoded weight out once and running the library GEMM on it.
`ops/matmul.Matmul` takes this route where its hint says so: by default
from M = 512, or in a bucket whose measured winner it is
(tuner/space.py).

* `weight_decode_u4` -- kernel 2's counterpart (csrc/weight_decode.cu):
  uint4 codes, grouped scales (any group of whole words: GPTQ's 32, 64,
  128 and per channel), original or rescale zeros -> dense [N, K]
  float16, bfloat16 or float32 (JAX's `mma_dtype`). float16 is
  bit-identical to `dequantize_hopper`, the fused kernel's decoded tile;
  bfloat16 and float32 are the float32 value (q - z) * s (q * s - z)
  with one cast, as JAX computes.
* `weight_decode_fmt` -- kernel 2 for every other format with float16
  or bfloat16 activations (csrc/dequant_formats.cuh, instantiated by
  csrc/dequant_fmt_*.cu): the codes decoded and scaled in A's type, the
  dense [N, K] weight the fused kernel's decode gives, bit for bit
  `dequantize_fmt_hopper`.
* `weight_decode_int8` -- kernel 3's counterpart
  (csrc/weight_decode_int8.cu): 1-, 2- or 4-bit int/uint fields -> int8
  codes [N, K], the int family minus its bias 2^(bits-1). Integer
  activations take the plan, as in JAX, only without zeros and with at
  most per-channel scales (`supports_materialize_spec`): the int32
  product then taken to float32 times the float16 scale of each column;
  forcing the plan on a grouped or zero-point configuration raises.
* `weight_decode_general` (kernels/general.py) -- kernels 2 and 3's
  general instance, for every configuration the specialized kernels do
  not take (`spec_format` "general"): the weight in the decode type with
  its scales (integer activations: the codes in A's type, the
  per-channel scales applied to the sums), then float32 / float64 sums
  on cuBLAS with TF32 off, or exact integer sums.
* `materialize_matmul` -- decode, then the dense product
  (kernels/dense.dense_product): on the card `torch.matmul` (float16 in
  and out) or `torch._int_mm` (int8 in, int32 out). JAX computes both
  products as `lax.dot_general` outside any Pallas kernel, so they stay
  library calls. A bias is added to the product in float32 before the
  cast, as JAX's `_finish` adds it. A float32 output of float16 or
  bfloat16 operands (dequant_matmul_fmt's formats) takes the product of
  their float32 copies in full float32: a float16 product would round
  its sums first. cuBLAS may reduce split-K partial
  sums of the float16 product in float16
  (`torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction`,
  left as the process has it), so the route is held to 4e-3 of the
  largest output against the fused kernel and the plain version; the
  error measured at the slice's shapes on an H100 was 0 (chip_smoke.py's
  route table).

The decoded weight is a per-call temporary, as in JAX: caching it would
give up the quantized footprint. Both decoders write [N, K] where JAX
writes [K, N], so that ``A @ W.T`` is the nt product. On a CUDA tensor
each decoder launches its kernel; on a CPU tensor it runs its plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.reference import expand_groups
from ..quantization import numerics, packing
from ..ops.reference import decode_type, finish_sums, sums
from ..quantization.formats import as_torch_dtype, source_format_and_bits
from . import build
from .dense import dense_product, full_f32
from .dequant_matmul import (FMT_FORMATS, GROUP, ZEROS_MODES,
                             dequantize_fmt_hopper, dequantize_hopper,
                             fmt_entry, spec_format)
from .general import weight_decode_general
from .spec import KernelSpec

_ARGTYPES_U4 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_I8 = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES_FMT = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_OUT_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}


def supports_materialize_spec(spec: KernelSpec) -> bool:
    """Can this spec's weight be decoded to a dense operand at all (the
    JAX rule)? Integer activations need no zeros and at most per-channel
    scaling; the decoded operand must be int8 codes."""
    if spec.native:
        return False
    if spec.is_int_activation:
        g = spec.group_size if spec.group_size > 0 else spec.k
        per_channel = g >= spec.k
        return (not spec.with_zeros
                and (not spec.with_scaling or per_channel)
                and spec.family in ("uint", "int") and spec.bits < 8)
    if spec.bits < 8:
        return spec.family in ("uint", "int", "nf", "fp")
    return spec.family in ("int", "uint", "fp_e4m3", "fp_e5m2")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, qweight on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def weight_decode_u4_plain(qweight: torch.Tensor, scales: torch.Tensor,
                           zeros: torch.Tensor,
                           out_dtype: torch.dtype = torch.float16,
                           group: int = GROUP,
                           zeros_mode: str = "original") -> torch.Tensor:
    """Plain PyTorch version of kernel 2 (any device)."""
    if out_dtype == torch.float16:
        return dequantize_hopper(qweight, scales, zeros, group, zeros_mode)
    K = qweight.shape[1] * 8
    q = packing.unpack_k(qweight, 4).to(torch.float32)
    s = expand_groups(scales.T.to(torch.float32), group, K)
    z = expand_groups(zeros.T.to(torch.float32), group, K)
    w = q * s - z if zeros_mode == "rescale" else (q - z) * s
    return w.to(out_dtype)


def weight_decode_u4(qweight: torch.Tensor, scales: torch.Tensor,
                     zeros: torch.Tensor,
                     out_dtype: torch.dtype = torch.float16,
                     group: int = GROUP,
                     zeros_mode: str = "original") -> torch.Tensor:
    """qweight [N, K/8] int32, scales / zeros [K/g, N] float16 (g a
    multiple of 8 that divides K) -> dense [N, K] in `out_dtype`
    (float16, bfloat16 or float32); `zeros_mode` original or rescale."""
    if qweight.dim() != 2:
        raise ValueError(f"qweight must be [N, K/8], got {qweight.shape}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"out_dtype {out_dtype} (float16, bfloat16, "
                         f"float32)")
    if zeros_mode not in ZEROS_MODES:
        raise ValueError(f"zeros_mode {zeros_mode!r} ({ZEROS_MODES})")
    N, K = qweight.shape[0], qweight.shape[1] * 8
    if group < 8 or group % 8 or K % group:
        raise ValueError(f"K={K} must be a multiple of the group size "
                         f"{group}, a multiple of 8")
    _check("qweight", qweight, torch.int32, (N, K // 8), qweight.device)
    for name, t in (("scales", scales), ("zeros", zeros)):
        _check(name, t, torch.float16, (K // group, N), qweight.device)
    if qweight.device.type == "cpu":
        return weight_decode_u4_plain(qweight, scales, zeros, out_dtype,
                                      group, zeros_mode)
    if qweight.device.type != "cuda":
        raise ValueError(f"unsupported device {qweight.device}")
    out = torch.empty((N, K), dtype=out_dtype, device=qweight.device)
    with torch.cuda.device(qweight.device):
        fn = build.entry("weight_decode", "weight_decode_u4", _ARGTYPES_U4)
        err = fn(qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                 out.data_ptr(), N, K, group, int(zeros_mode == "rescale"),
                 _OUT_CODE[out_dtype],
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "weight_decode_u4")
    weight_decode_u4.launches += 1
    key = ("per_channel" if group == K and group > GROUP else f"g{group}") \
        + (" rescale" if zeros_mode == "rescale" else "")
    counts = weight_decode_u4.variant_launches
    counts[key] = counts.get(key, 0) + 1
    return out


weight_decode_u4.launches = 0
# the launches by group size and zeros mode ("g64", "g128 rescale", ...)
weight_decode_u4.variant_launches = {}


def weight_decode_fmt_plain(qweight: torch.Tensor, w_dtype: str,
                            a_dtype: str, scales=None, zeros=None,
                            group: int = -1,
                            zeros_mode: str = "original") -> torch.Tensor:
    """Plain PyTorch version of weight_decode_fmt (any device)."""
    return dequantize_fmt_hopper(qweight, w_dtype, a_dtype, scales, zeros,
                                 group, zeros_mode)


def weight_decode_fmt(qweight: torch.Tensor, w_dtype: str, a_dtype: str,
                      scales=None, zeros=None, group: int = -1,
                      zeros_mode: str = "original") -> torch.Tensor:
    """qweight [N, K*bits/32] int32 of a `w_dtype` weight (a format of
    dequant_matmul_fmt) with scales (and, uint only, zeros) [K/g, N] in
    A's type or none -> the dense [N, K] weight in `a_dtype` (float16 or
    bfloat16); K a multiple of 128; `group` g (-1: per channel), a
    multiple of 8 that divides K; `zeros_mode` original or rescale."""
    fmt = f"{w_dtype}x{a_dtype}"
    if fmt not in FMT_FORMATS:
        raise NotImplementedError(f"weight_decode_fmt does not run "
                                  f"{w_dtype} -> {a_dtype}")
    if qweight.dim() != 2:
        raise ValueError(f"qweight must be 2-D, got {qweight.shape}")
    if zeros_mode not in ZEROS_MODES:
        raise ValueError(f"zeros_mode {zeros_mode!r} ({ZEROS_MODES})")
    family, bits = source_format_and_bits(w_dtype)
    adt = as_torch_dtype(a_dtype)
    N, K = qweight.shape[0], qweight.shape[1] * 32 // bits
    g = K if group in (-1, None) else group
    if zeros is not None and (scales is None or family != "uint"):
        raise NotImplementedError(f"zeros need scales and the uint family "
                                  f"(got {w_dtype})")
    if K % 128 or (scales is not None and (g % 8 or K % g)):
        raise ValueError(f"K={K} must be a multiple of 128 and of the group "
                         f"size {g}, a multiple of 8")
    _check("qweight", qweight, torch.int32, qweight.shape, qweight.device)
    for name, t in (("scales", scales), ("zeros", zeros)):
        if t is not None:
            _check(name, t, adt, (K // g, N), qweight.device)
    if qweight.device.type == "cpu":
        return weight_decode_fmt_plain(qweight, w_dtype, a_dtype, scales,
                                       zeros, g, zeros_mode)
    if qweight.device.type != "cuda":
        raise ValueError(f"unsupported device {qweight.device}")
    mode = 0 if scales is None else 2 if zeros_mode == "rescale" and \
        zeros is not None else 1
    out = torch.empty((N, K), dtype=adt, device=qweight.device)
    with torch.cuda.device(qweight.device):
        fn, fam, b = fmt_entry(w_dtype, a_dtype, "weight_decode",
                               _ARGTYPES_FMT)
        err = fn(fam, b, mode, qweight.data_ptr(),
                 scales.data_ptr() if scales is not None else 0,
                 zeros.data_ptr() if zeros is not None else 0,
                 out.data_ptr(), N, K, g,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, f"weight_decode_fmt {fmt}")
    weight_decode_fmt.launches += 1
    counts = weight_decode_fmt.format_launches
    counts[fmt] = counts.get(fmt, 0) + 1
    return out


weight_decode_fmt.launches = 0
# the launches by format ("nf4xbfloat16", ...)
weight_decode_fmt.format_launches = {}


def weight_decode_int8_plain(qweight: torch.Tensor, bits: int = 2,
                             family: str = "int") -> torch.Tensor:
    """Plain PyTorch version of kernel 3 (any device)."""
    return numerics.decode_field(packing.unpack_k(qweight, bits), family,
                                 bits, torch.int8)


def weight_decode_int8(qweight: torch.Tensor, bits: int = 2,
                       family: str = "int") -> torch.Tensor:
    """qweight [N, K*bits/32] int32 of `family` ("int" or "uint") fields
    of `bits` (1, 2 or 4) -> int8 codes [N, K]."""
    if bits not in (1, 2, 4) or family not in ("int", "uint"):
        raise ValueError(f"int8 decode covers int/uint at 1, 2 or 4 bits, "
                         f"got {family}{bits}")
    if qweight.dim() != 2:
        raise ValueError(f"qweight must be 2-D, got {qweight.shape}")
    N, K = qweight.shape[0], qweight.shape[1] * 32 // bits
    _check("qweight", qweight, torch.int32, qweight.shape, qweight.device)
    if qweight.device.type == "cpu":
        return weight_decode_int8_plain(qweight, bits, family)
    if qweight.device.type != "cuda":
        raise ValueError(f"unsupported device {qweight.device}")
    out = torch.empty((N, K), dtype=torch.int8, device=qweight.device)
    with torch.cuda.device(qweight.device):
        fn = build.entry("weight_decode_int8", "weight_decode_int8",
                         _ARGTYPES_I8)
        err = fn(qweight.data_ptr(), out.data_ptr(), N, K, bits,
                 int(family == "int"), torch.cuda.current_stream().cuda_stream)
    build.check(err, "weight_decode_int8")
    weight_decode_int8.launches += 1
    counts = weight_decode_int8.variant_launches
    counts[f"{family}{bits}"] = counts.get(f"{family}{bits}", 0) + 1
    return out


weight_decode_int8.launches = 0
# the launches by format ("int2", "uint1", ...)
weight_decode_int8.variant_launches = {}


def decode_weight(spec: KernelSpec, qweight: torch.Tensor, scales=None,
                  zeros=None) -> torch.Tensor:
    """The plan's first pass, the dense [N, K] weight: int8 codes (kernel
    3) for integer activations, else the weight in A's type (kernel 2:
    `weight_decode_u4` for GPTQ's uint4 x float16, `weight_decode_fmt` for
    every other format)."""
    if not supports_materialize_spec(spec):
        raise ValueError(f"materialize plan unsupported for {spec}")
    if spec_format(spec) == "general":
        if spec.is_int_activation:   # the codes in A's integer type
            return weight_decode_general(qweight, spec.w_dtype, spec.k,
                                         spec.a_dtype)
        decode = decode_type(spec.a_dtype,
                             spec.with_scaling or spec.with_zeros)
        return weight_decode_general(qweight, spec.w_dtype, spec.k, decode,
                                     scales, zeros, spec.group_size,
                                     spec.zeros_mode)
    if spec.is_int_activation:
        return weight_decode_int8(qweight, spec.bits, spec.family)
    mode = "rescale" if spec.zeros_mode == "rescale" else "original"
    if spec_format(spec) in FMT_FORMATS:
        return weight_decode_fmt(qweight, spec.w_dtype, spec.a_dtype,
                                 scales, zeros, spec.group_size, mode)
    return weight_decode_u4(qweight, scales, zeros, group=spec.group_size,
                            zeros_mode=mode)


def materialize_matmul(spec: KernelSpec, A: torch.Tensor,
                       qweight: torch.Tensor, scales=None,
                       zeros=None, bias=None) -> torch.Tensor:
    """A [M, K] -> out [M, N] through the two-pass plan for the ported
    configurations: integer activations (int8 codes, the int32 sums, times
    the per-channel float16 scales in float32 where there are scales),
    W4A16 (float16 weight at the spec's group and zeros mode, float16 out)
    and every other format with float activations (the weight in A's type;
    out in A's type or float32); a float32 bias added to the product
    before the cast, which saturates for an int8 output."""
    general = spec_format(spec) == "general"
    out_dtype = as_torch_dtype(spec.out_dtype)
    precision = "default"
    W = decode_weight(spec, qweight, scales, zeros)
    if spec.is_int_activation:
        if A.dtype == W.dtype == torch.int8:
            out = dense_product(A, W, torch.int32)
        else:   # uint8: exact within 2^53
            out = torch.matmul(A.double(), W.double().T).to(torch.int32)
        if scales is not None:   # per channel: [1, N]
            out = out.float() * scales.reshape(1, -1).float()
        if bias is not None:
            out = out.float() + bias.reshape(1, -1).float()
        return numerics.cast_output(out, spec.out_dtype)
    if general:
        return _general_product(spec, A, W, bias)
    if out_dtype == torch.float32 and W.dtype != torch.float32:
        # a float16 / bfloat16 product would round its sums to A's type
        # first: the float32 product of the float32 copies
        A, W, precision = A.float(), W.float(), "highest"
    if bias is None:
        return dense_product(A, W, out_dtype, precision)
    out = dense_product(A, W, torch.float32, precision) \
        + bias.reshape(1, -1).float()
    return out.to(out_dtype)


def _general_product(spec: KernelSpec, A: torch.Tensor, W: torch.Tensor,
                     bias) -> torch.Tensor:
    """The plan's second pass for the general instance's configurations
    with float activations: the sums of A and the decoded weight on
    float32 (float64 for float64 activations) copies, cuBLAS with TF32
    off, then the bias and the oracle's cast (ops/reference.
    finish_sums)."""
    with full_f32():
        out = sums(A, W, "float64" if spec.a_dtype == "float64"
                   else "float32")
    return finish_sums(out, bias, spec.out_dtype)

"""The general instances of kernels 1-3 (csrc/dequant_general.cu): every
quantized configuration the JAX package runs that the specialized
instances (kernels/dequant_matmul.py, kernels/materialize.py) do not
take, with the JAX oracle's semantics (ops/reference.py).

* `dequant_matmul_general` -- kernel 1's general instance: out[M, N] =
  A[M, K] . W_D^T (+ bias), then the oracle's cast to the output type.
  A is any dense type (its torch storage, formats.TORCH_DTYPES); the
  weight is the Hopper layout of any format (K-packed int32 words for 8
  bits or fewer, [N, K] int16 / int32 words for the wide ones), decoded
  into the decode type D (ops/reference.decode_name) with scales and zeros
  [K/g, N] (original / rescale zeros in a float type, quantized zeros as
  their int32 values), every K and every group that divides K. The sums
  are int32 (JAX's int_path, ops/reference.sums_type), float32 or
  float64.
* `weight_decode_general` -- kernels 2 and 3's general instance: the
  dense W_D [N, K] in D's storage.

Both have plain versions (`decode_general`, the torch form of the
oracle's decode, and `dequant_matmul_general_plain`) that the CPU runs
and the tests hold the kernels to. On a CUDA tensor each wrapper launches
its kernel and counts it (`launches`, and by configuration in
`variant_launches`)."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.reference import expand_groups, finish_sums, sums, sums_type
from ..quantization import numerics, packing
from ..quantization.formats import (INT_TYPES, TORCH_DTYPES, as_torch_dtype,
                                    source_format_and_bits)
from . import build

SOURCE = "dequant_general"
# (block_m, block_n, block_k, stages) of the one compiled tile
GENERAL_TILE = (32, 64, 32, 1)
# csrc/dequant_general.cu's codes
TYPE_CODE = {"float16": 0, "bfloat16": 1, "float32": 2, "float64": 3,
             "e4m3_float8": 4, "e5m2_float8": 5, "int8": 6, "uint8": 7,
             "int16": 8, "uint16": 9, "int32": 10, "uint32": 11, "int4": 12,
             "uint4": 13}
FAMILY_CODE = {"uint": 0, "int": 1, "nf": 2, "fp": 3, "fp_e4m3": 4,
               "fp_e5m2": 5}
ZEROS_CODE = {None: 0, "original": 1, "rescale": 2, "quantized": 3}
ACC_CODE = {"int32": 0, "float32": 1, "float64": 2}
_ACC_DTYPE = {"int32": torch.int32, "float32": torch.float32,
              "float64": torch.float64}
_TORCH_NAME = {torch.float16: "float16", torch.bfloat16: "bfloat16",
               torch.float32: "float32", torch.float64: "float64",
               torch.float8_e4m3fn: "e4m3_float8",
               torch.float8_e5m2: "e5m2_float8", torch.int32: "int32"}
_ARGTYPES_MATMUL = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES_DECODE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _zeros_name(t: torch.Tensor) -> str:
    if t.dtype not in _TORCH_NAME:
        raise ValueError(f"zeros of type {t.dtype}: a float type, or int32 "
                         f"for quantized zeros")
    return _TORCH_NAME[t.dtype]


def _check(qweight, w_dtype, K, scales, zeros, group, zeros_mode, decode):
    """Shape and type checks shared by both wrappers; returns (N, g)."""
    family, bits = source_format_and_bits(w_dtype)
    if family in ("fp", "bf") and bits > 8:
        raise ValueError(f"{w_dtype} is not a quantized weight format")
    if decode not in TYPE_CODE:
        raise ValueError(f"decode type {decode!r}: one of {list(TYPE_CODE)}")
    N = qweight.shape[0]
    g = K if group in (-1, None) else group
    if K < 1 or g < 1 or K % g:
        raise ValueError(f"K={K} must be a multiple of the group size {g}")
    if zeros_mode not in ZEROS_CODE or zeros_mode is None:
        raise ValueError(f"zeros_mode {zeros_mode!r}: original, rescale or "
                         f"quantized")
    if bits > 8:
        want = (torch.int16 if bits == 16 else torch.int32, (N, K))
    else:
        want = (torch.int32, (N, -(-K * bits // 32)))
    if qweight.dtype != want[0] or tuple(qweight.shape) != want[1]:
        raise ValueError(f"qweight: expected {want[0]} {want[1]}, got "
                         f"{qweight.dtype} {tuple(qweight.shape)}")
    for name, t in (("scales", scales), ("zeros", zeros)):
        if t is None:
            continue
        if tuple(t.shape) != (K // g, N):
            raise ValueError(f"{name}: expected {(K // g, N)}, got "
                             f"{tuple(t.shape)}")
        if t.device != qweight.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on "
                             f"{qweight.device}")
    if scales is not None and scales.dtype not in _TORCH_NAME:
        raise ValueError(f"scales of type {scales.dtype}")
    if zeros is not None:
        _zeros_name(zeros)
        if zeros_mode == "quantized" and zeros.dtype != torch.int32:
            raise ValueError("quantized zeros are their int32 values")
    if not qweight.is_contiguous():
        raise ValueError("qweight must be contiguous")
    return N, g


def decode_general(qweight: torch.Tensor, w_dtype: str, K: int,
                   decode: str, scales=None, zeros=None, group: int = -1,
                   zeros_mode: str = "original") -> torch.Tensor:
    """Plain PyTorch version of `weight_decode_general` (any device): the
    Hopper-layout weight -> W_D [N, K] in `decode`'s storage, as
    ops/reference.dequantize_weight decodes the reference layout."""
    family, bits = source_format_and_bits(w_dtype)
    g = K if group in (-1, None) else group
    if bits > 8:
        codes = qweight.to(torch.int64) & ((1 << bits) - 1)
    else:
        codes = packing.unpack_k(qweight, bits)[:, :K]
    fields = numerics.fields_of(codes, family, bits)
    if zeros is not None and zeros_mode == "quantized":
        z = expand_groups(zeros.T.to(torch.int64), g, K)
        w = numerics.convert(numerics.convert(fields, "int32").long() - z,
                             decode)
    else:
        w = numerics.decode_to(fields, family, bits, decode)
    if scales is None:
        return w
    s = expand_groups(numerics.convert(scales.T.contiguous(), decode), g, K)
    z = None
    if zeros is not None and zeros_mode != "quantized":
        z = expand_groups(numerics.convert(zeros.T.contiguous(), decode), g,
                          K)
    return numerics.scale_in(w, s, z, zeros_mode, decode)


def weight_decode_general(qweight: torch.Tensor, w_dtype: str, K: int,
                          decode: str, scales=None, zeros=None,
                          group: int = -1,
                          zeros_mode: str = "original") -> torch.Tensor:
    """qweight (the Hopper layout of `w_dtype` at K) with scales and zeros
    [K/g, N] or none -> the dense [N, K] weight in the dense type
    `decode`'s storage (kernels 2 and 3's general instance)."""
    N, g = _check(qweight, w_dtype, K, scales, zeros, group, zeros_mode,
                  decode)
    if qweight.device.type == "cpu":
        return decode_general(qweight, w_dtype, K, decode, scales, zeros, g,
                              zeros_mode)
    if qweight.device.type != "cuda":
        raise ValueError(f"unsupported device {qweight.device}")
    family, bits = source_format_and_bits(w_dtype)
    out = torch.empty((N, K), dtype=as_torch_dtype(decode),
                      device=qweight.device)
    with torch.cuda.device(qweight.device):
        fn = build.entry(SOURCE, "dqg_decode", _ARGTYPES_DECODE)
        err = fn(qweight.data_ptr(), FAMILY_CODE[family], bits,
                 _ptr(scales), _code(scales), _ptr(zeros), _code(zeros),
                 ZEROS_CODE[zeros_mode if zeros is not None else None],
                 TYPE_CODE[decode], out.data_ptr(), N, K, g,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, f"weight_decode_general {w_dtype} -> {decode}")
    weight_decode_general.launches += 1
    key = f"{w_dtype}->{decode}"
    counts = weight_decode_general.variant_launches
    counts[key] = counts.get(key, 0) + 1
    return out


weight_decode_general.launches = 0
# launches by weight format and decode type ("uint16->float16", ...)
weight_decode_general.variant_launches = {}


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _code(t) -> int:
    return 0 if t is None else TYPE_CODE[_zeros_name(t)]


def dequant_matmul_general_plain(A: torch.Tensor, qweight: torch.Tensor,
                                 w_dtype: str, a_dtype: str, decode: str,
                                 scales=None, zeros=None, group: int = -1,
                                 zeros_mode: str = "original", bias=None,
                                 out_dtype: str = "float32"
                                 ) -> torch.Tensor:
    """Plain PyTorch version of `dequant_matmul_general` (any device): the
    weight of `decode_general`, A . W^T in the sums' type (ops/reference.
    sums_type; int32 exact), then `finish_sums` (the bias, the oracle's
    cast)."""
    K = A.shape[1]
    W = decode_general(qweight, w_dtype, K, decode, scales, zeros, group,
                       zeros_mode)
    return finish_sums(sums(A, W, sums_type(a_dtype, w_dtype, decode)),
                       bias, out_dtype)


def dequant_matmul_general(A: torch.Tensor, qweight: torch.Tensor,
                           w_dtype: str, a_dtype: str, decode: str,
                           scales=None, zeros=None, group: int = -1,
                           zeros_mode: str = "original", bias=None,
                           out_dtype: str = "float32",
                           tile=None) -> torch.Tensor:
    """out [M, N] in `out_dtype`'s storage = A [M, K] (the dense type
    `a_dtype`'s storage) . W_D^T, W the Hopper layout of `w_dtype` decoded
    into `decode` with scales / zeros [K/g, N] (`zeros_mode` original,
    rescale or quantized), `bias` float32 [N] or [1, N] (kernel 1's
    general instance; `tile` GENERAL_TILE or None)."""
    if tile is not None and tuple(tile) != GENERAL_TILE:
        raise ValueError(f"general tile {tuple(tile)} is not compiled "
                         f"({GENERAL_TILE})")
    if A.dim() != 2 or a_dtype not in TYPE_CODE \
            or A.dtype != TORCH_DTYPES[a_dtype]:
        raise ValueError(f"A must be [M, K] in {a_dtype}'s storage, got "
                         f"{A.dtype} {tuple(A.shape)}")
    if out_dtype not in TORCH_DTYPES:
        raise ValueError(f"out_dtype {out_dtype!r} has no dense type")
    M, K = A.shape
    N, g = _check(qweight, w_dtype, K, scales, zeros, group, zeros_mode,
                  decode)
    if bias is not None and (bias.numel() != N or bias.dtype != torch.float32
                             or bias.device != A.device):
        raise ValueError(f"bias: expected {N} float32 values on {A.device}")
    if qweight.device != A.device:
        raise ValueError(f"qweight on {qweight.device}, A on {A.device}")
    if A.device.type == "cpu":
        return dequant_matmul_general_plain(A, qweight, w_dtype, a_dtype,
                                            decode, scales, zeros, g,
                                            zeros_mode, bias, out_dtype)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    acc = sums_type(a_dtype, w_dtype, decode)
    totals = torch.empty((M, N), dtype=_ACC_DTYPE[acc], device=A.device)
    if M:
        family, bits = source_format_and_bits(w_dtype)
        A = A.contiguous()
        with torch.cuda.device(A.device):
            fn = build.entry(SOURCE, "dqg_matmul", _ARGTYPES_MATMUL)
            err = fn(A.data_ptr(), TYPE_CODE[a_dtype], qweight.data_ptr(),
                     FAMILY_CODE[family], bits, _ptr(scales), _code(scales),
                     _ptr(zeros), _code(zeros),
                     ZEROS_CODE[zeros_mode if zeros is not None else None],
                     TYPE_CODE[decode], ACC_CODE[acc], totals.data_ptr(), M, N,
                     K, g, torch.cuda.current_stream().cuda_stream)
        build.check(err, f"dequant_matmul_general {w_dtype} x {a_dtype}")
        dequant_matmul_general.launches += 1
        key = general_variant(w_dtype, a_dtype, decode, scales is not None,
                              None if zeros is None else zeros_mode,
                              out_dtype)
        counts = dequant_matmul_general.variant_launches
        counts[key] = counts.get(key, 0) + 1
    return finish_sums(totals, bias, out_dtype)


def general_variant(w_dtype: str, a_dtype: str, decode: str, scaled: bool,
                    zeros_mode: Optional[str], out_dtype: str) -> str:
    """The name of a general launch's configuration, as `variant_launches`
    counts it: "uint16xfloat16 scaled ->float32", "nf4xint8 int8
    ->int32", ..."""
    parts = [f"{w_dtype}x{a_dtype}"]
    if decode != a_dtype:
        parts.append(f"as_{decode}")
    parts.append("scaled" if scaled else "unscaled")
    if zeros_mode is not None:
        parts.append(f"zeros_{zeros_mode}")
    return " ".join(parts + [f"->{out_dtype}"])


dequant_matmul_general.launches = 0
# launches by configuration (general_variant)
dequant_matmul_general.variant_launches = {}

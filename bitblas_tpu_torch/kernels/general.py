"""The general instances of kernels 1-3 (csrc/dequant_general.cu and
csrc/dequant_general_ffma.cu over csrc/dequant_general.cuh): every
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

Kernel 1's general instance sums on the unit `general_unit` names, a
fixed rule on (A's type, D, the sums' type) that takes the tensor cores
only where they reproduce the oracle's sums up to their order: "f16"
(mma.sync m16n8k16: float16, the fp8 types upcast exactly, 8-bit integers
under float32 sums), "bf16", "s8" (m16n8k32 over int8 / uint8 / int4 /
uint4, int32 sums), "f64" (DMMA) and "ffma" (float32 FMAs: float32 and the
wide integer activations, and integer activations with a float32 decode).

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
from . import build, scratch

SOURCE = "dequant_general"
# the DMMA and FFMA units' source (csrc/dequant_general_ffma.cu)
SOURCE_FFMA = "dequant_general_ffma"
# (block_m, block_n, block_k, stages): the most rows of M a block holds
# (the launch takes 32 or this many on the tensor-core units; 32, 128 or
# 256 on "ffma" and 32 or 128 on "f64" as M needs and shared memory
# allows), 64 weight rows (32 on "f64"), steps of 32 of K, the ring's
# stages
GENERAL_TILE = (512, 64, 32, 4)
# the sum units (csrc/dequant_general.cu UNIT_*)
UNIT_CODE = {"f16": 0, "bf16": 1, "s8": 2, "f64": 3, "ffma": 4}
_F16_EXACT = ("float16", "e4m3_float8", "e5m2_float8", "int8", "uint8",
              "int4", "uint4")
_BYTE_INTS = ("int8", "uint8", "int4", "uint4")
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
# A, its type, the weight words, family, bits, scales, their type, zeros,
# their type, zeros mode, decode type, sums type, unit, out, M, N, K,
# group, then the split of K's scratch (partials, their count, counters,
# their count, SMs) and the stream
_ARGTYPES_MATMUL = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_int] * 4 + [
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# A block holds 64 weight rows (32 on "f64") and up to GENERAL_TILE[0]
# rows of M, K in steps of 32; where such tiles are fewer than two an SM,
# K is split over up to SPLIT_TARGET blocks an SM (at least
# SPLIT_MIN_STEPS steps each), the partials merged in the launch
SPLIT_TARGET = 3
SPLIT_MIN_STEPS = 8


def general_splits_bound(M: int, N: int, K: int, sms: int) -> int:
    """The most splits of K the kernel takes at this shape (it picks its
    own from its tile; this bounds the partials' room)."""
    tiles = -(-N // 64) * -(-M // GENERAL_TILE[0])
    if tiles >= 2 * sms:
        return 1
    steps = -(-K // GENERAL_TILE[2])
    return max(1, min(-(-SPLIT_TARGET * sms // -(-N // 64)),
                      steps // SPLIT_MIN_STEPS))
_ARGTYPES_DECODE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def general_unit(a_dtype: str, decode: str, sums: str) -> str:
    """The unit kernel 1's general instance sums on, by a fixed rule on A's
    type, the decode type D and the sums' type (ops/reference.sums_type):
    a tensor-core unit only where its products and sums are the oracle's
    up to their order.

    * int32 sums (A and D the same 8-bit-or-narrower integer type): "s8",
      mma.sync m16n8k32 (wrapping int32 sums, JAX's int_path);
    * float64 sums: "f64", DMMA;
    * float32 sums of A and D both held exactly by float16 -- float16
      itself, fp8 (an exact upcast, as kernel 9's fp8 pairs), 8-bit
      integers with an integer D: "f16", mma.sync m16n8k16 into float32;
      bfloat16 with D bfloat16: "bf16";
    * every other float32 sum -- float32 activations, the wide integer
      activations, integer activations with a float32 D -- "ffma": float32
      FMAs on CUDA cores (TF32 would change the products)."""
    if sums == "int32":
        if a_dtype in _BYTE_INTS and decode == a_dtype:
            return "s8"
    elif sums == "float64":
        if a_dtype == decode == "float64":
            return "f64"
    elif sums == "float32":
        if a_dtype == decode == "bfloat16":
            return "bf16"
        if a_dtype == decode and a_dtype in _F16_EXACT:
            return "f16"
        if decode in ("float32",) + tuple(INT_TYPES) \
                and a_dtype not in ("float16", "bfloat16", "float64"):
            return "ffma"
    raise ValueError(f"no sum unit for A {a_dtype}, decode {decode}, "
                     f"{sums} sums")


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
    unit = general_unit(a_dtype, decode, acc)
    totals = torch.empty((M, N), dtype=_ACC_DTYPE[acc], device=A.device)
    if M:
        family, bits = source_format_and_bits(w_dtype)
        A = A.contiguous()
        sms = scratch.sm_count(A.device)
        bound = general_splits_bound(M, N, K, sms)
        part = count = None
        if bound > 1:
            part = scratch.partials(A.device, bound * M * N,
                                    _ACC_DTYPE[acc])
            count = scratch.counters(A.device, -(-N // 32) * -(-M // 32))
        with torch.cuda.device(A.device):
            fn = build.entry(SOURCE, "dqg_matmul", _ARGTYPES_MATMUL) \
                if unit in ("f16", "bf16", "s8") else build.entry(
                    SOURCE_FFMA, "dqg_matmul_ffma", _ARGTYPES_MATMUL)
            err = fn(A.data_ptr(), TYPE_CODE[a_dtype], qweight.data_ptr(),
                     FAMILY_CODE[family], bits, _ptr(scales), _code(scales),
                     _ptr(zeros), _code(zeros),
                     ZEROS_CODE[zeros_mode if zeros is not None else None],
                     TYPE_CODE[decode], ACC_CODE[acc], UNIT_CODE[unit],
                     totals.data_ptr(), M, N, K, g, _ptr(part),
                     0 if part is None else part.numel(), _ptr(count),
                     0 if count is None else count.numel(), sms,
                     torch.cuda.current_stream().cuda_stream)
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

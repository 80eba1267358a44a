"""Plain reference: dequantize, then a matmul with float32 accumulation,
or int32 for integer activations on integer codes (counterpart of
bitblas_tpu/ops/reference.py).

Inputs use the reference checkpoint layouts of the JAX package:

  qweight : [N, K*bits/8] int8, packed along K, LSB-first (general_compress)
  scales  : [N, K/group_size]
  zeros   : [N, K/group_size]   (zeros_mode original or rescale)
  qzeros  : [K/group_size, N*bits/8] int8, packed along N (zeros_mode
            quantized)
  bias    : [N]

Wide int16 / int32 weights are [N, K] words, one value each.
`dequantize_weight` is bit-exact against the JAX function for every
pair (float64 aside: the port keeps it, JAX without x64 computes it in
float32); `contract` accumulates in float32, or exactly in int32 for
integer activations on unscaled integer codes (a float32 weight of
integer activations, scaled, contracts in float32 as JAX's does), and
casts as JAX's `cast_output`. The dequant kernels' plain versions
(kernels/dequant_matmul.py) decode the Hopper layout and then run
`matmul_dense_reference` or `contract`, so they share this arithmetic.
"""

from __future__ import annotations

import torch

from ..quantization import numerics
from ..quantization.formats import INT_TYPES, source_format_and_bits
from .matmul_config import MatmulConfig


def _tensor(x, device=None):
    return x if x is None or isinstance(x, torch.Tensor) \
        else torch.as_tensor(x, device=device)


def expand_groups(grouped: torch.Tensor, group: int, K: int) -> torch.Tensor:
    """[N, K/g] -> [N, K], each group value repeated over its g columns."""
    return grouped.repeat_interleave(group, dim=1)[:, :K]


def reference_codes(config: MatmulConfig, qweight) -> torch.Tensor:
    """A reference-layout qweight -> its unsigned codes [N, K] (int32; a
    wide weight's words, int64): fields of [N, K*bits/8] bytes packed
    along K, one byte a code at 8 bits, one int16 / int32 word a value
    for the wide int and uint weights."""
    q = _tensor(qweight)
    if config.bit > 8:
        return q.to(torch.int64) & ((1 << config.bit) - 1)
    if config.bit == 8:
        return q.contiguous().view(torch.uint8).to(torch.int32)
    return numerics.unpack_fields(q, config.bit)[..., :config.K]


def decode_type(a_dtype: str, scaled_or_zeros: bool) -> str:
    """The type the weight is decoded into (JAX's `adt`): A's, or float32
    for integer activations with scales or zeros (the kernel scales exact
    integer sums in a float32 epilogue). float64 stays float64 here, where
    the JAX package, without x64, computes it in float32."""
    return "float32" if a_dtype in INT_TYPES and scaled_or_zeros \
        else a_dtype


def decode_name(config: MatmulConfig) -> str:
    """`decode_type` of a quantized configuration."""
    return decode_type(config.A_dtype,
                       config.with_scaling or config.with_zeros)


def sums_type(a_dtype: str, w_dtype: str, decode: str) -> str:
    """The sums' type (JAX's int_path): int32 for activations of 8 bits or
    fewer on int / uint weights decoded to an integer type (a native
    weight is its own decode), float64 for float64 activations, else
    float32 (a float weight of integer activations takes A to float)."""
    family = source_format_and_bits(w_dtype)[0]
    if a_dtype in ("int8", "uint8", "int4", "uint4") and \
            family in ("int", "uint") and decode in INT_TYPES:
        return "int32"
    return "float64" if a_dtype == "float64" else "float32"


def dequantize_weight(config: MatmulConfig, qweight, scales=None,
                      zeros=None, qzeros=None) -> torch.Tensor:
    """Decode a reference-layout packed weight to dense [N, K] in the
    decode type (`decode_name`), on its torch storage, as the JAX oracle
    does: the codes decoded (numerics.decode_to: into an integer type the
    float formats truncate and saturate, integers wrap); with quantized
    zeros the fields less the zeros in the integer domain, then converted,
    for every format (also without scales); then with scales ``(w - zeros)
    * scales`` (rescale: ``w * scales - zeros``), each op in the decode
    type. Zeros of the original and rescale modes apply only with scales,
    as in JAX."""
    qweight = _tensor(qweight)
    name = decode_name(config)
    g, K, N = config.effective_group_size, config.K, config.N
    family, bits = config.source_format, config.bit
    fields = numerics.fields_of(reference_codes(config, qweight), family,
                                bits)
    if config.with_zeros and config.zeros_mode == "quantized":
        z = numerics.unpack_fields(_tensor(qzeros, fields.device),
                                   min(bits, 8))[..., :N]      # [K/g, N]
        z = expand_groups(z.T.to(torch.int64), g, K)
        w = numerics.convert(numerics.convert(fields, "int32").long() - z,
                             name)
    else:
        w = numerics.decode_to(fields, family, bits, name)
    if config.with_scaling:
        s = expand_groups(numerics.convert(_tensor(scales, w.device), name),
                          g, K)
        z = None
        if config.with_zeros and config.zeros_mode != "quantized":
            z = expand_groups(numerics.convert(_tensor(zeros, w.device),
                                               name), g, K)
        w = numerics.scale_in(w, s, z, config.zeros_mode, name)
    return w


def _absmax(t: torch.Tensor) -> int:
    return max(abs(int(t.max())), abs(int(t.min()))) if t.numel() else 0


def matmul_dense_reference(A: torch.Tensor, W_nk: torch.Tensor,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """C = A @ W^T (W_nk is [N, K]) accumulated in float32, or in int32
    when both operands are integer, then the saturating cast to
    `out_dtype`. Integer sums run as a float32 product while every
    partial sum is an integer within 2^24 (K * max|A| * max|W|), which is
    exact in any order of summation and far faster on the CPU than an
    integer one; otherwise as a float64 product, exact within 2^53 (int8
    operands: K < 2^39), which runs on the card too (PyTorch has no CUDA
    integer matmul)."""
    if not (A.is_floating_point() or W_nk.is_floating_point()):
        worst = A.shape[-1] * _absmax(A) * _absmax(W_nk)
        wide = torch.float32 if worst <= 2 ** 24 else torch.float64
        out = torch.matmul(A.to(wide), W_nk.to(wide).T).to(torch.int32)
    else:
        out = torch.matmul(A.to(torch.float32), W_nk.to(torch.float32).T)
    return numerics.saturate_cast(out, out_dtype)


def contract(config: MatmulConfig, A: torch.Tensor, W_nk: torch.Tensor,
             bias=None) -> torch.Tensor:
    """The JAX oracle's contraction (`matmul_dense_reference`) for any
    configuration: A [M, K] . W_nk^T summed in `sums_type` (int32 exact),
    the bias added in float32 (float64) to the sums, then
    `numerics.cast_output` to out_dtype."""
    decode = config.A_dtype if config.is_native_compute() \
        else decode_name(config)
    out = sums(A, W_nk, sums_type(config.A_dtype, config.W_dtype, decode))
    return finish_sums(out, None if bias is None else _tensor(bias, A.device),
                       config.out_dtype)


def sums(A: torch.Tensor, W_nk: torch.Tensor, acc: str) -> torch.Tensor:
    """A . W_nk^T in `acc` ("int32": exact, `matmul_dense_reference`;
    "float32" / "float64": the product of float copies)."""
    if acc == "int32":
        return matmul_dense_reference(A.to(torch.int32),
                                      W_nk.to(torch.int32), torch.int32)
    wide = torch.float64 if acc == "float64" else torch.float32
    return torch.matmul(numerics.to_float(A).to(wide),
                        numerics.to_float(W_nk).to(wide).T)


def finish_sums(out: torch.Tensor, bias, out_dtype: str) -> torch.Tensor:
    """The oracle's epilogue: int32 sums to float32 before a bias, a bias
    added in the sums' float type, then `numerics.cast_output`."""
    if bias is not None:
        if not out.is_floating_point():
            out = out.float()
        out = out + bias.reshape(1, -1).to(out.dtype)
    return numerics.cast_output(out, out_dtype)


def matmul_reference(config: MatmulConfig, A, qweight, scales=None,
                     zeros=None, qzeros=None, bias=None) -> torch.Tensor:
    """Full oracle (JAX's `matmul_reference`): a native configuration
    contracts A with the weight as it is (``*n`` layouts: its transpose),
    a quantized one with `dequantize_weight`'s; see `contract`."""
    A = _tensor(A)
    if config.is_native_compute():
        W = _tensor(qweight).to(A.device)
        W = W if config.layout[1] == "t" else W.T
    else:
        W = dequantize_weight(config, qweight, scales, zeros,
                              qzeros).to(A.device)
    return contract(config, A, W, bias)

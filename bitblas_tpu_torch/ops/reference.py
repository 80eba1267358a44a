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

`dequantize_weight` is bit-exact against the JAX function; the
contraction accumulates in float32, or exactly in int32 for integer
activations on unscaled integer codes (a float32 weight of integer
activations, scaled, contracts in float32 as JAX's does). The dequant
kernel's plain version (kernels/dequant_matmul.py) decodes the Hopper
layout and then runs
`matmul_dense_reference`, so both share this arithmetic.
"""

from __future__ import annotations

import torch

from ..quantization import numerics
from ..quantization.formats import as_torch_dtype
from .matmul_config import MatmulConfig


def _tensor(x, device=None):
    return x if x is None or isinstance(x, torch.Tensor) \
        else torch.as_tensor(x, device=device)


def expand_groups(grouped: torch.Tensor, group: int, K: int) -> torch.Tensor:
    """[N, K/g] -> [N, K], each group value repeated over its g columns."""
    return grouped.repeat_interleave(group, dim=1)[:, :K]


def reference_codes(config: MatmulConfig, qweight) -> torch.Tensor:
    """A reference-layout qweight -> its unsigned codes [N, K]: fields of
    [N, K*bits/8] bytes packed along K, or one byte a code at 8 bits."""
    q = _tensor(qweight)
    if config.bit == 8:
        return q.contiguous().view(torch.uint8).to(torch.int32)
    return numerics.unpack_fields(q, config.bit)[..., :config.K]


def dequantize_weight(config: MatmulConfig, qweight, scales=None,
                      zeros=None, qzeros=None) -> torch.Tensor:
    """Decode a reference-layout packed weight to dense [N, K] in A_dtype,
    as the JAX oracle does: the codes decoded (numerics.decode_codes: the
    int family less 2^(bits-1), int8 unbiased, nf4, fp4 and fp8 by the
    reference's formulas) in A's type, then ``(w - zeros) * scales``
    (rescale: ``w * scales - zeros``; quantized: ``(q - z)`` in the
    integer domain, cast, times scales), each op in A's type, or the int
    values as they are for integer activations; with scales or zeros the
    weight of integer activations is float32 (JAX's rule: the kernel
    scales exact integer sums in a float32 epilogue)."""
    qweight = _tensor(qweight)
    adt = as_torch_dtype(config.A_dtype)
    if not adt.is_floating_point and (config.with_scaling
                                      or config.with_zeros):
        adt = torch.float32
    g, K, N = config.effective_group_size, config.K, config.N
    fields = reference_codes(config, qweight)
    if config.with_zeros and config.zeros_mode == "quantized":
        z = numerics.unpack_fields(_tensor(qzeros, fields.device),
                                   config.bit)[..., :N]        # [K/g, N]
        z = expand_groups(z.T.to(torch.int32), g, K)
        w = (fields.to(torch.int32) - z).to(adt)
    else:
        w = numerics.decode_codes(fields, config.source_format, config.bit,
                                  adt)
    if config.with_scaling:
        s = expand_groups(_tensor(scales, w.device).to(adt), g, K)
        z = None
        if config.with_zeros and config.zeros_mode != "quantized":
            z = expand_groups(_tensor(zeros, w.device).to(adt), g, K)
        w = numerics.apply_scaling(w, s, z, config.zeros_mode)
    return w.to(adt)


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


def matmul_reference(config: MatmulConfig, A, qweight, scales=None,
                     zeros=None, qzeros=None, bias=None) -> torch.Tensor:
    """Full oracle: dequantize, then contract; a bias is added to the
    float32 (or int32) sums in float32 before the cast, as JAX adds it."""
    A = _tensor(A)
    W = dequantize_weight(config, qweight, scales, zeros,
                          qzeros).to(A.device)
    out_dtype = as_torch_dtype(config.out_dtype)
    if bias is None:
        return matmul_dense_reference(A, W, out_dtype)
    out = matmul_dense_reference(A, W, torch.float32)
    out = out + _tensor(bias, A.device).reshape(1, -1).float()
    return numerics.saturate_cast(out, out_dtype)

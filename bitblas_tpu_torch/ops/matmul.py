"""Matmul: the matmul operator (counterpart of bitblas_tpu/ops/matmul.py).

`transform_weight` turns reference-layout operands into the Hopper device
layout on the operator's device (where it moves them first): W4A16's
uint4 codes [N, K] with scales [N, K/g] and zeros [N, K/g] (original,
rescale) or packed [K/g, N/2] (quantized: unpacked to float16 zeros);
W2A8's int2 values [N, K] in -2..1, clamped and biased; every other
quantized format's codes [N, K] (sub-byte int values clamped and biased,
int8 values as they are, fp8 as its bytes, a float8 tensor viewed as
them) with scales and zeros in A's type; or a native
weight as it is ([N, K] for ``*t`` layouts, [K, N] for ``*n``); a bias
as float32 [1, N]. `forward(A, W, scale=, zeros=,
bias=)` runs at any M, on the device of its inputs: PyTorch runs eagerly,
so there is no per-bucket compile and no bucket padding, and each call
takes the hint of its M (ops/operator.py):

* "fused": the dequant-GEMM kernel with the hint's tile instance
  (kernels/dequant_matmul.py: dequant_matmul_u4 for GPTQ's W4A16,
  dequant_matmul_i2 for BitNet's W2A8, dequant_matmul_fmt for every other
  float-activation configuration, dequant_matmul_int for every other
  int8-activation one);
* "materialize": decode the weight once, then the library product
  (kernels/materialize.py);
* "dense": a native configuration's product (kernels/dense.py), every
  layout, bias added in the output type. ``t*`` layouts take A as
  [K, M], as JAX does.

Activations of another type than A_dtype are converted to it first
(numerics.convert, XLA's conversion), as JAX's kernel casts its A
block.

Untuned, that is the fused kernel below M = 512 and the materialize plan
from it (tuner/space.default_hint). With `enable_tuning` (the default) an
operator on the card measures each bucket's candidates when it is built;
on the CPU it keeps the defaults and measures nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels.dense import make_dense_matmul
from ..kernels.dequant_matmul import (FMT_FORMATS, INT_FORMATS,
                                      dequant_matmul_fmt, dequant_matmul_i2,
                                      dequant_matmul_int, dequant_matmul_u4,
                                      spec_format)
from ..kernels.general import dequant_matmul_general
from ..kernels.materialize import materialize_matmul
from ..kernels.spec import KernelSpec
from ..quantization import numerics
from ..quantization.formats import TORCH_DTYPES, as_torch_dtype
from ..tuner.hint import TileHint
from .matmul_config import MatmulConfig
from .operator import BaseKernelNameGenerator, Operator
from .reference import decode_name
from . import weight_transform as wt


class MatmulKernelNameGenerator(BaseKernelNameGenerator):
    """Readable kernel names for logs and cache keys: JAX's
    ``matmul_m16n512k512_f16xu4_`` prefix, then the port's tile: ``t``,
    the hint's block_m x block_n x block_k (and stages), its plan
    ("fused", "dense"; "t_materialize" for the two-pass plan)."""

    KERNEL_PREFIX = "matmul"

    SHORT = {"float32": "f32", "float16": "f16", "bfloat16": "bf16"}

    @classmethod
    def simplify_dtype(cls, dtype: str) -> str:
        if dtype in cls.SHORT:
            return cls.SHORT[dtype]
        if dtype.startswith("int"):
            return f"i{dtype[3:]}"
        if dtype.startswith("uint"):
            return f"u{dtype[4:]}"
        return dtype

    def is_valid_config(self, config) -> bool:
        return isinstance(config, MatmulConfig)

    @staticmethod
    def tile_name(hint: TileHint) -> str:
        if hint.decode_mode == "materialize":
            return "t_materialize"
        s = f"t{hint.block_m}x{hint.block_n}x{hint.block_k}"
        if hint.decode_mode == "fused":
            s += f"s{hint.stages}"
        s += f"_{hint.decode_mode}"
        return s if hint.precision == "default" else f"{s}_{hint.precision}"

    def generate(self, hint=None) -> str:
        c = self.config
        shape = f"n{c.N}k{c.K}"
        if isinstance(c.M, int):
            shape = f"m{c.M}" + shape
        precision = (f"{self.simplify_dtype(c.A_dtype)}"
                     f"x{self.simplify_dtype(c.W_dtype)}")
        return "_".join([self.KERNEL_PREFIX, shape, precision,
                         self.tile_name(hint) if hint else "default"])


def _to_tensor(x) -> torch.Tensor:
    """A tensor of `x`; a float8 tensor or array as its bytes (uint8)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.uint8) if x.dtype in _FLOAT8 else x
    a = np.asarray(x)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "iub":
        a = a.view(np.uint8)   # ml_dtypes float8
    return torch.as_tensor(a)


def _float8_kind(x):
    """The torch float8 type of a float8 tensor or ml_dtypes array, or
    None."""
    if isinstance(x, torch.Tensor):
        return x.dtype if x.dtype in _FLOAT8 else None
    name = str(np.asarray(x).dtype)
    return {"float8_e4m3fn": torch.float8_e4m3fn,
            "float8_e5m2": torch.float8_e5m2}.get(name)


_FLOAT8_NAMES = ("e4m3_float8", "e5m2_float8")
_FLOAT8 = tuple(getattr(torch, n) for n in (
    "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz")
    if hasattr(torch, n))


class Matmul(Operator):

    def __init__(self, config: MatmulConfig, name: str = "matmul",
                 device="cuda", enable_tuning: bool = True,
                 from_database: bool = False):
        self._spec = KernelSpec.from_config(config, config.m_buckets[0])
        super().__init__(name, config, device)
        self.kernel_name_generator = MatmulKernelNameGenerator(config)
        if not from_database:
            self._build_default_module()
            if enable_tuning:
                self.hardware_aware_finetune()

    # -- Operator hooks -------------------------------------------------------
    @property
    def m_buckets(self) -> Tuple[int, ...]:
        return self.config.m_buckets

    def _make_spec(self, m: int) -> KernelSpec:
        return dataclasses.replace(self._spec, m=m)

    def _build_kernel(self, spec: KernelSpec, hint: TileHint):
        """fn(A [M, K], W, *rest) with rest the scale, zeros and bias the
        configuration takes, in that order."""
        del spec
        cfg = self.config

        def fn(A, W, *rest):
            it = iter(rest)
            scale = next(it) if cfg.with_scaling else None
            zeros = next(it) if cfg.with_zeros else None
            bias = next(it) if cfg.with_bias else None
            return self._run(hint, A, W, scale, zeros, bias)

        return fn

    def _example_input(self, m: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(m)
        return _random((m, self.config.K), self.config.A_dtype, gen,
                       self.device)

    def _example_weights(self):
        """Seeded random device-layout operands: every code of the packed
        weight occurs; scales and zeros in the ranges the models use."""
        cfg, dev = self.config, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        if cfg.is_native_compute():
            out = [_random(self.retrieve_weight_shape(), cfg.W_dtype, gen,
                           dev)]
        else:
            wbits = 16 if cfg.bit == 16 else 32
            out = [torch.randint(-2 ** (wbits - 1), 2 ** (wbits - 1),
                                 self.retrieve_weight_shape(), generator=gen,
                                 device=dev, dtype=torch.int64)
                   .to(getattr(torch, f"int{wbits}"))]
            groups = (cfg.K // cfg.effective_group_size, cfg.N)
            sdt = wt.scale_dtype(cfg)
            if cfg.with_scaling:
                out.append((torch.rand(groups, generator=gen, device=dev)
                            * 0.01 + 0.005).to(sdt))
            if cfg.with_zeros:
                z = torch.randint(0, 1 << min(cfg.bit, 8), groups,
                                  generator=gen, device=dev)
                if wt.general_quantized_zeros(cfg):
                    z = z.to(torch.int32)
                else:
                    z = z.to(sdt)
                if cfg.zeros_mode == "rescale" and cfg.with_scaling:
                    z = (z.float() * out[-1].float()).to(sdt)   # z s, GPTQ's
                out.append(z)
        if cfg.with_bias:
            out.append(torch.randn((1, cfg.N), generator=gen, device=dev))
        return out

    # -- weight transform ---------------------------------------------------
    def retrieve_weight_shape(self) -> Tuple[int, ...]:
        """Device-layout weight shape."""
        cfg = self.config
        if cfg.is_native_compute():
            return (cfg.N, cfg.K) if cfg.layout[1] == "t" else (cfg.K, cfg.N)
        return self._spec.packed_shape

    def transform_weight(self, weight, scale=None, zeros=None, bias=None):
        """Reference-layout operands -> device layout: [weight, scales
        [K/g, N], zeros [K/g, N] (quantized: unpacked from [K/g,
        N*bits/8]), both in A's type, bias [1, N] float32], those given
        (a single tensor when only the weight is)."""
        cfg = self.config
        w = _to_tensor(weight).to(self.device)
        if cfg.is_native_compute():
            # a float8 weight keeps its own float8 type, as JAX's dot takes
            # the weight it is given (an fp8 pair takes either type); any
            # other is converted to W_dtype
            kind = _float8_kind(weight)
            if kind is not None:
                w = w.view(kind)
            elif w.dtype != TORCH_DTYPES[cfg.W_dtype]:
                w = numerics.convert(w, cfg.W_dtype)
            if cfg.W_dtype not in _FLOAT8_NAMES and w.dtype in _FLOAT8:
                w = numerics.convert(w, cfg.W_dtype)
            result = [w]
        elif cfg.source_format == "int" and cfg.bit < 8:
            result = [wt.signed_weight_to_device(cfg, w)]
        else:   # codes, int8 values, fp8 bytes: their low bits packed
            result = [wt.unpacked_weight_to_device(cfg, w)]
        if scale is not None:
            result.append(wt.scales_to_device(
                _to_tensor(scale).to(self.device), wt.scale_dtype(cfg)))
        if zeros is not None:
            result.append(wt.zeros_to_device(
                cfg, _to_tensor(zeros).to(self.device)))
        if bias is not None:
            result.append(wt.bias_to_device(_to_tensor(bias).to(
                self.device)))
        return result[0] if len(result) == 1 else result

    def transform_input(self, A):
        """The identity: no activation is permuted at run time (JAX's
        parity stub for the reference API)."""
        return A

    # -- forward ------------------------------------------------------------
    def _run(self, hint: TileHint, A: torch.Tensor, W: torch.Tensor,
             scale=None, zeros=None, bias=None) -> torch.Tensor:
        """A [M, K] -> [M, N] through the hint's plan."""
        cfg = self.config
        if hint.decode_mode == "dense":
            return make_dense_matmul(self._spec, hint,
                                     layout="n" + cfg.layout[1])(
                A, W, bias=bias)
        if hint.decode_mode == "materialize":
            return materialize_matmul(self._spec, A, W, scale, zeros, bias)
        fmt = spec_format(self._spec)
        if fmt == "general":
            return dequant_matmul_general(
                A, W, cfg.W_dtype, cfg.A_dtype, decode_name(cfg), scale,
                zeros, cfg.effective_group_size, zeros_mode=cfg.zeros_mode,
                bias=bias, out_dtype=cfg.out_dtype, tile=hint.tile)
        mode = "rescale" if cfg.zeros_mode == "rescale" else "original"
        if fmt in FMT_FORMATS + INT_FORMATS:
            run = dequant_matmul_fmt if fmt in FMT_FORMATS \
                else dequant_matmul_int
            return run(A, W, cfg.W_dtype, scale, zeros,
                       cfg.effective_group_size, tile=hint.tile, bias=bias,
                       zeros_mode=mode,
                       out_dtype=as_torch_dtype(cfg.out_dtype))
        if fmt == "int2":
            return dequant_matmul_i2(A, W, tile=hint.tile)
        return dequant_matmul_u4(
            A, W, scale, zeros, cfg.effective_group_size, tile=hint.tile,
            bias=bias, zeros_mode=mode)

    def forward(self, A: torch.Tensor, W: torch.Tensor, scale=None,
                zeros=None, bias=None) -> torch.Tensor:
        """A [..., K] (``t*`` layouts: [K, M]) -> [..., N] in the
        configuration's out_dtype. A quantized configuration with float16
        or bfloat16 activations takes a float A of any type, cast to
        A_dtype."""
        cfg = self.config
        if not cfg.is_native_compute() and (
                (cfg.with_scaling and scale is None)
                or (cfg.with_zeros and zeros is None)):
            raise ValueError("this configuration needs scale and zeros")
        if cfg.layout[0] == "t":
            A = A.T
        adt = as_torch_dtype(cfg.A_dtype)
        if A.dtype != adt and (A.is_floating_point() or not
                               cfg.is_native_compute()):
            # an activation of another type (a bfloat16 model's float16
            # inputs or float32 residual stream) takes the configured type
            # first, as JAX's kernel casts its A block to the mma type
            A = A.to(adt) if adt in (torch.float16, torch.bfloat16) \
                else numerics.convert(A, cfg.A_dtype)
        lead = A.shape[:-1]
        A2 = A.reshape(-1, cfg.K).contiguous()
        out = self._run(self.hint_for(A2.shape[0]), A2, W, scale, zeros,
                        bias if cfg.with_bias else None)
        return out.reshape(*lead, cfg.N)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    # -- the configuration's fields (JAX's accessors) -----------------------
    M = property(lambda self: self.config.M)
    N = property(lambda self: self.config.N)
    K = property(lambda self: self.config.K)
    A_dtype = property(lambda self: self.config.A_dtype)
    W_dtype = property(lambda self: self.config.W_dtype)
    out_dtype = property(lambda self: self.config.out_dtype)
    accum_dtype = property(lambda self: self.config.accum_dtype)
    storage_dtype = property(lambda self: self.config.storage_dtype)
    with_scaling = property(lambda self: self.config.with_scaling)
    with_zeros = property(lambda self: self.config.with_zeros)
    group_size = property(lambda self: self.config.effective_group_size)
    fast_decoding = property(lambda self: self.config.fast_decoding)
    with_bias = property(lambda self: self.config.with_bias)
    zeros_mode = property(lambda self: self.config.zeros_mode)
    source_format = property(lambda self: self.config.source_format)
    bit = property(lambda self: self.config.bit)
    layout = property(lambda self: self.config.layout)


def _random(shape, name: str, gen: torch.Generator,
            device) -> torch.Tensor:
    """Standard normal floats, or integer values over the dense type
    `name`'s range up to int8's, in name's storage."""
    dtype = as_torch_dtype(name)
    if dtype.is_floating_point:
        return numerics.convert(torch.randn(shape, generator=gen,
                                            device=device), name)
    return numerics.convert(torch.randint(-128, 128, shape, generator=gen,
                                          device=device, dtype=torch.int64),
                            name)

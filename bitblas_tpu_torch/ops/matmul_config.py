"""MatmulConfig: the frozen dataclass that specifies a matmul operator
(counterpart of bitblas_tpu/ops/matmul_config.py, same fields).

The port runs these configurations (`PORTED`), all layout "nt" but the
native ones: every quantized weight format with float16 or bfloat16
activations (`FLOAT_PAIRS` and uint4 x float16, GPTQ's W4A16 among them:
uint1/2/4, int1/2/4/8, nf4, fp4_e2m1, e4m3 and e5m2 weights; scales in
groups of 32, 64 or 128, every multiple of 256 that divides K, or per
channel (-1), or none; zeros for the uint family only, in zeros_mode
"original", "rescale" or "quantized", and only with scales; a bias or
none; the output in A's type or float32, float32 accumulation); the
integer column (`INT_PAIRS`: int8 activations with uint1/2/4 and int1/2/4
weights, the BitNet W2A8 linear of models/bitnet.py among them: scales
in the same groups or none, zeros for the uint family with scales, a
bias or none, the output float32, float16, int32 (unscaled only: the
exact sums) or int8 (saturating: rounded half to even, then clamped),
int32 or float32 accumulation named, the kernels summing each group in
int32 either way); and the native dense configurations, A_dtype ==
W_dtype in float16, bfloat16, float32 (out_dtype the same) or int8, int4
and uint4 (out_dtype int32 or float32; 4-bit operands held in int8), in
every layout, with or without bias. A native configuration accumulates
in float32 for float operands and in int32 for integer ones whatever
`accum_dtype` says, as the JAX dense kernel does, and the field is
legalized to that type. Every other configuration raises
NotImplementedError, but zeros on int weights raise ValueError, as in JAX
(the bias of the int family is their zero point); the JAX legalization
rules then fill the derived fields (`fast_decoding` for sub-byte int /
uint weights under float activations; the storage is the port's Hopper
layout, int32 words, or the weight's own type for native compute). `M`
gives the operator's M buckets (ops/operator.py). The repr holds field
values only, so it is the same in every process: the hint database keys on
it (cache/__init__.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional, Tuple, Union

from ..quantization.formats import (DTYPE_MAP, is_native_compute,
                                   source_format_and_bits)
from .common import OptimizeStrategy, TransformKind

DEFAULT_OPT_M_DECODE = (1, 16, 32, 64, 128, 256, 512, 1024)
DEFAULT_OPT_M_BATCHED = (16, 32, 64, 128, 256, 512, 1024)


class OneOf(tuple):
    """The values a field of PORTED may take."""


def gptq_group(config) -> bool:
    """GPTQ's group sizes at this K: -1 (per channel), 32, 64, 128, or a
    multiple of 256 that divides K (the kernels' steps and slots never
    straddle a group)."""
    g = config.group_size
    return g in (-1, 32, 64, 128) or (g > 0 and g % 256 == 0
                                      and config.K % g == 0)


gptq_group.describe = "-1, 32, 64, 128 or a multiple of 256 that divides K"


# The legal configurations: field -> the value each takes (a OneOf: any
# of its values; a function of the config: where it returns True).
# Quantized configurations are "nt"; native ones take every layout and bias
# (those two fields are not listed for them).
_DENSE = {"group_size": -1, "with_scaling": False, "with_zeros": False,
          "zeros_mode": "original"}


def zeros_need_scaling(config) -> bool:
    """Zeros apply only together with scales (JAX's dequantize_weight
    reads them under with_scaling)."""
    return config.with_scaling or not config.with_zeros


zeros_need_scaling.describe = "False unless with_scaling"

# The weight formats the port runs with each float activation besides
# uint4 x float16 (GPTQ's, which has kernels of its own): (A_dtype,
# W_dtype) pairs.
FLOAT_PAIRS = tuple(
    [("float16", w) for w in ("uint2", "uint1", "int4", "int2", "int1",
                              "int8", "nf4", "fp4_e2m1", "e4m3_float8",
                              "e5m2_float8")]
    + [("bfloat16", w) for w in ("uint4", "int4", "nf4", "fp4_e2m1",
                                 "e4m3_float8", "int8", "uint2", "int2",
                                 "uint1", "int1", "e5m2_float8")])
# The integer column: int8 activations with sub-byte int / uint weights.
INT_PAIRS = tuple(("int8", w) for w in ("uint1", "uint2", "uint4", "int1",
                                        "int2", "int4"))


def _float_pair(a: str, w: str) -> dict:
    family = DTYPE_MAP[w][0]
    return dict(A_dtype=a, W_dtype=w, out_dtype=OneOf((a, "float32")),
                accum_dtype="float32", group_size=gptq_group,
                with_scaling=OneOf((False, True)),
                with_zeros=(OneOf((False, True)) if family == "uint"
                            else False),
                layout="nt",
                zeros_mode=OneOf(("original", "rescale", "quantized")),
                with_bias=OneOf((False, True)),
                zeros_with_scaling=zeros_need_scaling)


def int32_out_unscaled(config) -> bool:
    """An int32 output holds the exact sums: unscaled only (JAX's
    OUT_MATRIX)."""
    return config.out_dtype != "int32" or not config.with_scaling


int32_out_unscaled.describe = "int32 only without scales"


def _int_pair(w: str) -> dict:
    family = DTYPE_MAP[w][0]
    return dict(A_dtype="int8", W_dtype=w,
                out_dtype=OneOf(("float32", "float16", "int32", "int8")),
                accum_dtype=OneOf(("int32", "float32")),
                group_size=gptq_group, with_scaling=OneOf((False, True)),
                with_zeros=(OneOf((False, True)) if family == "uint"
                            else False),
                layout="nt",
                zeros_mode=OneOf(("original", "rescale", "quantized")),
                with_bias=OneOf((False, True)),
                zeros_with_scaling=zeros_need_scaling,
                int32_out=int32_out_unscaled)


PORTED = (
    _float_pair("float16", "uint4"),
    *(_int_pair(w) for _, w in INT_PAIRS),
    *(dict(A_dtype=dt, W_dtype=dt, out_dtype=dt, accum_dtype="float32",
           **_DENSE) for dt in ("float16", "bfloat16", "float32")),
    *(dict(A_dtype=dt, W_dtype=dt, out_dtype=out, accum_dtype="int32",
           **_DENSE) for dt in ("int8", "int4", "uint4")
      for out in ("int32", "float32")),
    *(_float_pair(a, w) for a, w in FLOAT_PAIRS),
)


def _allows(cfg, name: str, want) -> bool:
    if callable(want):
        return want(cfg)
    if isinstance(want, OneOf):
        return getattr(cfg, name) in want
    return getattr(cfg, name) == want


def _describe(want) -> str:
    if callable(want):
        return want.describe
    if isinstance(want, OneOf):
        return "one of " + ", ".join(repr(v) for v in want)
    return repr(want)


def _check_ported(cfg) -> None:
    """Raise NotImplementedError unless `cfg` is one of PORTED, naming the
    first field that differs from the ported configuration nearest to it
    (same A_dtype and W_dtype, else same A_dtype)."""
    if any(all(_allows(cfg, k, v) for k, v in p.items()) for p in PORTED):
        return
    near = next((p for p in PORTED if (p["A_dtype"], p["W_dtype"])
                 == (cfg.A_dtype, cfg.W_dtype)), None) \
        or next((p for p in PORTED if p["A_dtype"] == cfg.A_dtype),
                PORTED[0])
    name, want = next((k, v) for k, v in near.items()
                      if not _allows(cfg, k, v))
    got = getattr(cfg, name) if hasattr(cfg, name) else \
        (cfg.with_scaling, cfg.with_zeros)
    raise NotImplementedError(
        f"bitblas_tpu_torch runs {name} = {_describe(want)} only with "
        f"A_dtype={near['A_dtype']!r}, W_dtype={near['W_dtype']!r} so far "
        f"(got {got!r} in A_dtype={cfg.A_dtype!r}, W_dtype={cfg.W_dtype!r})")


@dataclass(frozen=True)
class OperatorConfig:
    """Base class for operator configs (hashable, frozen)."""


@dataclass(frozen=True)
class MatmulConfig(OperatorConfig):
    M: Union[int, Tuple[int, ...], None] = None
    N: Optional[int] = None
    K: Optional[int] = None
    A_dtype: str = "float16"
    W_dtype: Optional[str] = None  # defaults to A_dtype
    out_dtype: str = "float16"
    accum_dtype: str = "float32"
    layout: Literal["nn", "nt", "tn", "tt"] = "nt"
    with_bias: bool = False
    group_size: int = -1
    with_scaling: bool = False
    with_zeros: bool = False
    zeros_mode: Literal["original", "rescale", "quantized"] = "original"
    storage_dtype: str = "int8"
    fast_decoding: Optional[bool] = None
    propagate_a: Optional[Union[bool, int, TransformKind]] = None
    propagate_b: Optional[Union[bool, int, TransformKind]] = None
    optimize_stratety: Union[int, OptimizeStrategy] = (
        OptimizeStrategy.SingleBatchDecodeOnly)

    def __post_init__(self):
        if self.N is None or self.K is None:
            raise ValueError("N and K must be specified")
        if self.W_dtype is None:
            object.__setattr__(self, "W_dtype", self.A_dtype)
        for name in ("A_dtype", "W_dtype", "out_dtype", "accum_dtype"):
            if getattr(self, name) not in DTYPE_MAP:
                raise ValueError(f"Unsupported {name} {getattr(self, name)}")
        if self.layout not in ("nn", "nt", "tn", "tt"):
            raise ValueError(f"unknown layout {self.layout!r}")
        strategy = self.optimize_stratety
        if isinstance(strategy, int):
            strategy = OptimizeStrategy(strategy)
        object.__setattr__(self, "optimize_stratety", strategy)
        if self.M is None:
            object.__setattr__(
                self, "M",
                DEFAULT_OPT_M_DECODE
                if strategy == OptimizeStrategy.SingleBatchDecodeOnly
                else DEFAULT_OPT_M_BATCHED)
        if isinstance(self.M, list):
            object.__setattr__(self, "M", tuple(self.M))

        # JAX legalization of unset fields, then the ported check
        if self.zeros_mode is None:
            object.__setattr__(self, "zeros_mode", "original")
        if self.group_size is None:
            object.__setattr__(self, "group_size", -1)
        for name in ("with_bias", "with_scaling", "with_zeros"):
            if getattr(self, name) is None:
                object.__setattr__(self, name, False)
        native = self.is_native_compute()
        if native:
            object.__setattr__(self, "accum_dtype",
                               "int32" if self.A_dtype in ("int8", "int4",
                                                           "uint4")
                               else "float32")
        family, bits = source_format_and_bits(self.W_dtype)
        if (family == "int" and self.with_zeros
                and (self.A_dtype, self.W_dtype) in FLOAT_PAIRS
                + INT_PAIRS):
            # JAX's rule: the int family's bias is its zero point
            raise ValueError(
                "with_zeros is unsupported for signed int weights "
                "(constant zero point is implied)")
        _check_ported(self)
        if self.group_size > 0 and self.K % self.group_size:
            raise ValueError(f"K={self.K} not a multiple of group_size="
                             f"{self.group_size}")
        # The Hopper layout: K-packed int32 words (quantization/packing.py),
        # or the weight in its own dtype for native compute (JAX rule); no
        # runtime activation transform.
        object.__setattr__(self, "storage_dtype",
                           self.W_dtype if native else "int32")
        object.__setattr__(self, "propagate_a", TransformKind.NonTransform)
        object.__setattr__(self, "propagate_b", TransformKind.NonTransform)
        if self.fast_decoding is None:
            # JAX rule: fast decoding for sub-byte int/uint weights under
            # float activations only (the kernels decode every format with
            # magic numbers or bit surgery either way: the flag changes no
            # bit of a result)
            object.__setattr__(self, "fast_decoding",
                               family in ("int", "uint") and bits < 8
                               and self.A_dtype in ("float16", "bfloat16"))

    # -- derived properties -------------------------------------------------
    def is_native_compute(self) -> bool:
        return is_native_compute(self.A_dtype, self.W_dtype)

    @property
    def source_format(self) -> str:
        return source_format_and_bits(self.W_dtype)[0]

    @property
    def bit(self) -> int:
        return source_format_and_bits(self.W_dtype)[1]

    @property
    def is_dynamic_m(self) -> bool:
        return isinstance(self.M, tuple)

    @property
    def m_buckets(self) -> Tuple[int, ...]:
        return self.M if isinstance(self.M, tuple) else (self.M,)

    @property
    def effective_group_size(self) -> int:
        return self.K if self.group_size in (-1, None) else self.group_size

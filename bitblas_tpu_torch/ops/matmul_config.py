"""MatmulConfig: the frozen dataclass that specifies a matmul operator
(counterpart of bitblas_tpu/ops/matmul_config.py, same fields).

The port takes every configuration the JAX package's Matmul runs, and
raises the JAX error class where JAX raises (at construction, where JAX
may raise later, at its build or its first call):

* ValueError: N or K missing; a name outside the dtype map; A or the
  output a packed format (nf4, fp4_e2m1, int1/2, uint1/2: they have no
  dense type, JAX's `as_jax_dtype`); a quantized configuration in a
  layout other than "nt"; zeros on int weights (their bias is their zero
  point); a group size that does not divide K; a float16, bfloat16 or
  float32 weight under other activations (JAX's decode has no such
  family);
* KeyError: a float64 weight under other activations (JAX's dtype
  table).

Native configurations (A_dtype and W_dtype a pair of
formats.NATIVE_COMPUTE_PATTERNS) take every layout and drop scales and
zeros, as JAX's XLA dot does; they accumulate in float32 for float
operands (float64 for float64), in int32 for integer ones, whatever
`accum_dtype` says, and the field is legalized to that type. Every other
configuration decodes its weight (ops/reference.py has the rules): the
kernels of `FLOAT_PAIRS`, `INT_PAIRS`, GPTQ's uint4 x float16 and BitNet's
int2 x int8 take the configurations `specialized` names, the general
instance (kernels/general.dequant_matmul_general) every other.
The JAX legalization rules then fill the derived fields (`fast_decoding`
for sub-byte int / uint weights under float activations; the storage is
the port's Hopper layout: the weight's own type for native compute,
natural-width int16 / int32 words for wide int / uint weights, else
K-packed int32 words). `M` gives the operator's M buckets
(ops/operator.py). The repr holds field values only, so it is the same in
every process: the hint database keys on it (cache/__init__.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional, Tuple, Union

from ..quantization.formats import (DTYPE_MAP, TORCH_DTYPES,
                                   is_native_compute,
                                   source_format_and_bits)
from .common import OptimizeStrategy, TransformKind

DEFAULT_OPT_M_DECODE = (1, 16, 32, 64, 128, 256, 512, 1024)
DEFAULT_OPT_M_BATCHED = (16, 32, 64, 128, 256, 512, 1024)

# The weight formats the specialized kernels of float activations take
# besides uint4 x float16 (GPTQ's, which has kernels of its own): (A_dtype,
# W_dtype) pairs (csrc/dequant_formats.cuh).
FLOAT_PAIRS = tuple(
    [("float16", w) for w in ("uint2", "uint1", "int4", "int2", "int1",
                              "int8", "nf4", "fp4_e2m1", "e4m3_float8",
                              "e5m2_float8")]
    + [("bfloat16", w) for w in ("uint4", "int4", "nf4", "fp4_e2m1",
                                 "e4m3_float8", "int8", "uint2", "int2",
                                 "uint1", "int1", "e5m2_float8")])
# The integer column: int8 activations with sub-byte int / uint weights
# (csrc/dequant_int.cuh).
INT_PAIRS = tuple(("int8", w) for w in ("uint1", "uint2", "uint4", "int1",
                                        "int2", "int4"))


def group_ok(g: int, K: int) -> bool:
    """The group sizes the specialized kernels take at this K: -1 or K
    (per channel), 32, 64, 128, or a multiple of 256 that divides K (their
    steps and slots never straddle a group)."""
    return g in (-1, 32, 64, 128, K) or (g > 0 and g % 256 == 0
                                         and K % g == 0)


def specialized_pair(a_dtype: str, w_dtype: str, out_dtype: str, K: int,
                     N: int, group: int, scaled: bool, zeros: bool) -> bool:
    """Whether a quantized configuration runs on the specialized kernels
    (FLOAT_PAIRS and uint4 x float16 through dequant_matmul_fmt / _u4,
    INT_PAIRS through dequant_matmul_int / _i2) rather than the general
    instance: K a multiple of 128 and N of 8, a group of `group_ok`, zeros
    (uint only) with scales, in mode original, rescale or quantized
    (unpacked to original-mode zeros: (q - z) s is the same value for the
    uint family), and an output those kernels write (A's type or float32;
    for int8 activations float32, float16, int8, or int32 unscaled)."""
    pair = (a_dtype, w_dtype)
    if K % 128 or N % 8 or not group_ok(group, K) or (zeros and not (
            scaled and w_dtype.startswith("uint"))):
        return False
    if pair in FLOAT_PAIRS or pair == ("float16", "uint4"):
        return out_dtype in (a_dtype, "float32")
    if pair in INT_PAIRS:
        return out_dtype in ("float32", "float16", "int8") or (
            out_dtype == "int32" and not scaled)
    return False


def specialized(config) -> bool:
    """`specialized_pair` of a quantized MatmulConfig."""
    return not config.is_native_compute() and specialized_pair(
        config.A_dtype, config.W_dtype, config.out_dtype, config.K,
        config.N, config.group_size, config.with_scaling, config.with_zeros)


def _check_jax_refusals(cfg) -> None:
    """Raise what the JAX package raises for `cfg` (see the module
    docstring)."""
    for name in ("A_dtype", "out_dtype"):
        if getattr(cfg, name) not in TORCH_DTYPES:
            raise ValueError(f"{getattr(cfg, name)} has no dense type; it "
                             f"is always packed ({name})")
    family, bits = source_format_and_bits(cfg.W_dtype)
    if family == "int" and cfg.with_zeros:
        raise ValueError("with_zeros is unsupported for signed int weights "
                         "(constant zero point is implied)")
    if cfg.is_native_compute():
        return
    if cfg.layout != "nt":
        raise ValueError(
            f"quantized-weight matmul supports layout 'nt' only (packed "
            f"[N, K] weights), got {cfg.layout!r}")
    if family in ("fp", "bf") and bits > 8:
        if bits == 64:
            raise KeyError(bits)
        raise ValueError(f"unsupported 8-bit family {family}")
    g = cfg.effective_group_size
    if g < 1 or cfg.K % g:
        raise ValueError(f"K={cfg.K} not a multiple of group_size={g}")


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

        # JAX legalization of unset fields, then JAX's refusals
        if self.zeros_mode is None:
            object.__setattr__(self, "zeros_mode", "original")
        if self.group_size is None:
            object.__setattr__(self, "group_size", -1)
        for name in ("with_bias", "with_scaling", "with_zeros"):
            if getattr(self, name) is None:
                object.__setattr__(self, name, False)
        native = self.is_native_compute()
        _check_jax_refusals(self)
        family, bits = source_format_and_bits(self.W_dtype)
        if native:
            object.__setattr__(self, "accum_dtype",
                               "int32" if family in ("int", "uint")
                               else "float64" if bits == 64
                               else "float32")
        # The Hopper layout: K-packed int32 words (quantization/packing.py),
        # natural-width words for wide int / uint weights, or the weight in
        # its own dtype for native compute (JAX's rules); no runtime
        # activation transform.
        object.__setattr__(self, "storage_dtype",
                           self.W_dtype if native else f"int{bits}"
                           if bits > 8 else "int32")
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

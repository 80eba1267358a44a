"""Kernel 1's general instance: the rule that names its sum unit
(`kernels.general.general_unit`), on the CPU.

- Every configuration of JAX's PAIRS and WIDE_PAIRS (the list
  tests/test_torch_support_matrix.py runs) gets exactly one unit, and a
  tensor-core unit only where its operands hold A and the decoded weight
  exactly: every value of A's type and of the decode type (all 256 codes
  of the 8-bit types, the integer types' ranges) converts to the unit's
  operand type and back unchanged, so the products are the oracle's and
  only the order of the sums differs.
- The fp8 upcast the f16 unit takes is exact on all 256 codes of e4m3 and
  e5m2: NaN where the code is NaN, inf where it is inf, the value
  otherwise.
- On the unit's operands, float32 sums of the products equal the plain
  version (`dequant_matmul_general_plain`) up to their order: a small
  case per tensor-core unit within 2^-20 of the largest output; int32
  sums exactly.
"""

import pytest
import torch

from bitblas_tpu_torch.kernels.general import (UNIT_CODE, decode_general,
                                               dequant_matmul_general_plain,
                                               general_unit)
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.ops.reference import decode_name, sums_type
from bitblas_tpu_torch.quantization import numerics, packing
from bitblas_tpu_torch.quantization.formats import (INT_TYPES, TORCH_DTYPES,
                                                    source_format_and_bits)

# tests/test_torch_support_matrix.py JAX_PAIRS and JAX_WIDE_PAIRS (JAX's
# tests/test_support_matrix.py PAIRS :22-72, WIDE_PAIRS :114-119)
PAIRS = [
    ("float16", "float16", False), ("bfloat16", "bfloat16", False),
    ("float32", "float32", False), ("int8", "int8", False),
    ("e4m3_float8", "e4m3_float8", False),
    ("e5m2_float8", "e5m2_float8", False),
    ("float16", "uint4", True), ("float16", "uint2", True),
    ("float16", "uint1", True), ("float16", "int4", False),
    ("float16", "int2", False), ("float16", "int1", False),
    ("float16", "int8", False), ("float16", "nf4", True),
    ("float16", "fp4_e2m1", True), ("float16", "e4m3_float8", False),
    ("float16", "e5m2_float8", False),
    ("bfloat16", "uint4", True), ("bfloat16", "int4", False),
    ("bfloat16", "nf4", True), ("bfloat16", "fp4_e2m1", True),
    ("bfloat16", "e4m3_float8", False), ("bfloat16", "int8", False),
    ("bfloat16", "uint2", True), ("bfloat16", "int2", False),
    ("bfloat16", "uint1", True),
    ("e4m3_float8", "e5m2_float8", False),
    ("e5m2_float8", "e4m3_float8", False),
    ("int4", "int4", False),
    ("int8", "uint4", True), ("int8", "uint2", True),
    ("int8", "int8", False), ("int8", "uint4", False),
    ("int8", "int4", False), ("int8", "uint2", False),
    ("int8", "int2", False), ("int8", "uint1", False),
    ("int8", "int1", False),
]
WIDE_PAIRS = [
    ("float16", "int16", False), ("float16", "int16", True),
    ("float16", "uint16", False), ("float16", "uint16", True),
    ("float16", "int32", False), ("float16", "int32", True),
    ("float16", "uint32", False), ("float16", "uint32", True),
]
# the unit's operand type and its sums
OPERAND = {"f16": torch.float16, "bf16": torch.bfloat16, "s8": None,
           "f64": torch.float64, "ffma": torch.float32}


def _values(name: str) -> torch.Tensor:
    """Every value of a type with at most 16 bits (all codes), else a
    spread of values, as float64."""
    if name in ("e4m3_float8", "e5m2_float8"):
        codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    elif name in ("float16", "bfloat16"):
        codes = (torch.arange(1 << 16, dtype=torch.int32) - 32768) \
            .to(torch.int16)
    else:
        codes = None
    if codes is not None:
        v = codes.view(TORCH_DTYPES[name]).double()
        return v[torch.isfinite(v)]
    if name in INT_TYPES:
        lo, hi = {"int4": (-8, 7), "uint4": (0, 15), "int8": (-128, 127),
                  "uint8": (0, 255), "int16": (-32768, 32767),
                  "uint16": (0, 65535)}.get(name, (-2 ** 31, 2 ** 31 - 1))
        if name == "uint32":
            lo, hi = 0, 2 ** 32 - 1
        step = max(1, (hi - lo) // 65536)
        return torch.arange(lo, hi + 1, step, dtype=torch.float64)
    return torch.randn(4096, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1)) \
        .to(TORCH_DTYPES[name]).double()


def _exact_in(values: torch.Tensor, unit: str) -> bool:
    if unit == "s8":
        return bool(((values >= -128) & (values <= 255)
                     & (values == values.round())).all())
    return torch.equal(values.to(OPERAND[unit]).double(), values)


@pytest.mark.parametrize("a_dtype,w_dtype,scaling", PAIRS + WIDE_PAIRS)
def test_one_unit_for_every_jax_pair(a_dtype, w_dtype, scaling):
    cfg = MatmulConfig(M=16, N=256, K=256, A_dtype=a_dtype, W_dtype=w_dtype,
                       with_scaling=scaling,
                       group_size=64 if scaling else -1)
    dn = decode_name(cfg)
    sums = sums_type(a_dtype, w_dtype, dn)
    unit = general_unit(a_dtype, dn, sums)
    assert unit in UNIT_CODE
    # the sums' type is the unit's
    assert {"s8": "int32", "f64": "float64"}.get(unit, "float32") == sums
    if unit != "ffma":
        # a tensor-core unit holds A and the decode type exactly
        assert _exact_in(_values(a_dtype), unit), a_dtype
        assert _exact_in(_values(dn), unit), dn
    else:
        # FFMA exactly where no 16-bit operand holds both
        assert not (_exact_in(_values(a_dtype), "f16")
                    and _exact_in(_values(dn), "f16")) \
            or a_dtype == "float32" or dn == "float32"


def test_rule_refuses_what_no_unit_sums():
    for a, d, s in (("float16", "float32", "float32"),
                    ("int8", "uint8", "int32"),
                    ("float32", "float32", "float64")):
        with pytest.raises(ValueError, match="no sum unit"):
            general_unit(a, d, s)


@pytest.mark.parametrize("name", ["e4m3_float8", "e5m2_float8"])
def test_fp8_upcast_is_exact_on_every_code(name):
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    x = codes.view(TORCH_DTYPES[name])
    up = x.to(torch.float16).double()
    want = x.double()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(up), nan)
    assert torch.equal(up[~nan], want[~nan])
    assert int(nan.sum()) == (2 if name == "e4m3_float8" else 6)


# (A, W, decode, scaled): one case a tensor-core unit
UNIT_CASES = [("float16", "uint16", "float16", True, "f16"),
              ("bfloat16", "fp4_e2m1", "bfloat16", True, "bf16"),
              ("e4m3_float8", "uint4", "e4m3_float8", True, "f16"),
              ("int8", "nf4", "int8", False, "f16"),
              ("int8", "uint8", "int8", False, "s8"),
              ("float64", "int4", "float64", True, "f64")]


@pytest.mark.parametrize("a,w,decode,scaled,unit", UNIT_CASES)
def test_unit_sums_are_the_plain_version(a, w, decode, scaled, unit):
    """The unit's arithmetic (operands converted to its type, products
    summed in its sums' type) against the plain version."""
    g = torch.Generator().manual_seed(len(a) + len(w))
    M, N, K, group = 5, 24, 96, 32
    bits = source_format_and_bits(w)[1]
    if bits > 8:
        qw = torch.randint(0, 1024, (N, K), generator=g).to(
            TORCH_DTYPES[f"int{bits}"])
    else:
        qw = packing.pack_k(torch.randint(0, 1 << bits, (N, K),
                                          generator=g), bits)
    A = numerics.convert(torch.randint(-8, 8, (M, K), generator=g), a) \
        if a in INT_TYPES else numerics.convert(
            torch.randn((M, K), generator=g), a)
    s = numerics.convert(torch.rand((K // group, N), generator=g) * 0.1
                         + 0.01, decode) if scaled else None
    sums = sums_type(a, w, decode)
    assert general_unit(a, decode, sums) == unit
    want = dequant_matmul_general_plain(A, qw, w, a, decode, s, None, group,
                                        "original", None, sums)
    W = decode_general(qw, w, K, decode, s, None, group)
    if unit == "s8":
        got = (A.long() @ W.long().T).to(torch.int32)
        assert torch.equal(got, want)
        return
    op = OPERAND[unit]
    acc = torch.float64 if unit == "f64" else torch.float32
    Au, Wu = numerics.to_float(A).to(op), numerics.to_float(W).to(op)
    assert torch.equal(Au.double(), numerics.to_float(A).double())
    assert torch.equal(Wu.double(), numerics.to_float(W).double())
    got = Au.to(acc) @ Wu.to(acc).T
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= top * 2.0 ** -20

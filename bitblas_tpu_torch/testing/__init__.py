"""Testing utilities (counterpart of bitblas_tpu/testing/__init__.py).

`random_reference_operands` draws from numpy with the same generator calls
as the JAX package, so both packages get identical reference-layout
inputs from one seed. `main()` runs the calling test file under pytest.
`assert_close` bounds the share of elements outside
the tolerance, as the JAX helper does; `out_ulps` measures a kernel's
distance from its plain version in ulps of the output type, and
`attention_err` an attention output's, element by element, with a floor
per output row.
"""

from __future__ import annotations

import inspect
import math
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.matmul_config import MatmulConfig
from ..quantization import packing


def main():
    """Run the calling test file under pytest and exit with its code."""
    import pytest
    caller = inspect.getframeinfo(sys._getframe(1)).filename
    sys.exit(pytest.main([caller]))


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        x = x.numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(actual, expected, *, rtol=1e-2, atol=1e-3,
                 max_mismatched_ratio=0.001, msg=""):
    """Allow up to `max_mismatched_ratio` of elements to violate
    ``|actual - expected| <= atol + rtol * |expected|``; non-finite
    expectations match only the identical inf/nan class."""
    actual, expected = _numpy(actual), _numpy(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    finite = np.isfinite(expected)
    nonfin_ok = (actual == expected) | (np.isnan(actual) & np.isnan(expected))
    tol = atol + rtol * np.abs(np.where(finite, expected, 0.0))
    diff = np.abs(np.where(finite, actual, 0.0) -
                  np.where(finite, expected, 0.0))
    mism = np.where(finite, ~(diff <= tol), ~nonfin_ok)
    n_mism = int(mism.sum())
    budget = int(np.ceil(actual.size * max_mismatched_ratio))
    if n_mism > budget:
        idx = np.argwhere(mism)[:10]
        details = "\n".join(
            f"  [{tuple(i)}] actual={actual[tuple(i)]} "
            f"expected={expected[tuple(i)]}" for i in idx)
        raise AssertionError(
            f"{msg} mismatch {n_mism}/{actual.size} elements "
            f"(budget {budget}, rtol={rtol}, atol={atol}):\n{details}")


@dataclass
class ReferenceOperands:
    """Random operands in reference layouts (see ops/reference.py)."""
    A: np.ndarray
    qweight: np.ndarray
    scales: Optional[np.ndarray] = None
    zeros: Optional[np.ndarray] = None


# (mantissa bits, smallest normal exponent) of each output type
_ULP = {torch.float16: (10, -14), torch.bfloat16: (7, -126),
        torch.float32: (23, -126)}


def out_ulps(got: torch.Tensor, want: torch.Tensor, dtype=None,
             floor: float = 2.0 ** -18) -> float:
    """The largest |got - want| in units of want's ulp in `dtype` (want's
    own type by default: float16, bfloat16 or float32) plus `floor` of the
    largest |want|: at most 1 when got is within one ulp of the output
    type of each output. Two float32 sums of the same products in another
    order differ by their f32 rounding, about 2^-24 of the largest output,
    which can exceed the ulp of an output near zero: hence the floor.
    Non-finite wants must be matched exactly (both NaN, or equal)."""
    dtype = dtype or want.dtype
    mant, emin = _ULP[dtype]
    w, g = want.double(), got.double()
    fin = torch.isfinite(w)
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    if not bool(same[~fin].all()):
        return math.inf
    w, g = w[fin], g[fin]
    if w.numel() == 0:
        return 0.0
    # floor(log2 |w|) exactly, at least the type's smallest normal exponent
    e = (torch.frexp(w.abs().clamp_min(2.0 ** emin))[1] - 1).double()
    unit = torch.exp2(e - mant) + floor * w.abs().max()
    return ((g - w).abs() / unit).max().item()


# One ulp of a float16 / bfloat16 attention output, relative to the value
# (at most: 2^-10 / 2^-7 at a power of two).
ATTN_ULP = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}


def attention_err(got: torch.Tensor, want: torch.Tensor, rel: float,
                  row_floor: float) -> float:
    """The largest |got - want| / (rel |want| + row_floor rms(row)), the
    rms of want's row over the last dim (one head's output): at most 1
    passes. Two outputs rounded to one type differ by one ulp, at most
    ATTN_ULP of the value, where their float32 values are close: `rel`.
    A flash prefill rounds P to Q's type before P V: the sum of those
    per-key roundings is a random walk whose size follows its row's
    magnitude, not the element's, and an element near zero carries it
    whole: hence a floor per row, `row_floor` times the row's rms (a
    float32 P, as in the decode kernels, needs one ulp of it). Each
    element is held to its own row, so an error inside a sliding window's
    band, where outputs average many keys and are small, is not hidden by
    the large outputs of early rows. Non-finite values fail."""
    w, g = want.double(), got.double()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    lim = rel * w.abs() + row_floor * w.pow(2).mean(-1, keepdim=True).sqrt()
    err = (g - w).abs()
    return torch.where(err == 0, torch.zeros_like(err), err / lim).max() \
        .item()


def _float_draw(x: np.ndarray, dtype: str,
                via_f16: bool = True) -> np.ndarray:
    """float64 draws -> `dtype` as JAX casts them (activations reach
    bfloat16 through float16, weights directly); bfloat16 comes back as
    float32 holding the values."""
    if dtype == "float32":
        return x.astype(np.float32)
    if dtype == "float16" or via_f16:
        x = x.astype(np.float16)
    if dtype == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def random_reference_operands(config: MatmulConfig, m: int,
                              seed: int = 0) -> ReferenceOperands:
    """The JAX generator's draws, in the same order, for the ported
    configurations: float activations (standard normal; float16 first
    for float16 and bfloat16, as JAX draws) or int8 ones (uniform in
    [-8, 8)); native weights drawn the same way ([N, K] for ``*t``
    layouts, [K, N] for ``*n``); sub-byte weight fields uniform over all codes
    (int codes are stored biased); scales and zeros (original). numpy has
    no bfloat16: those arrays are float32 holding the bfloat16 values."""
    rng = np.random.default_rng(seed)
    N, K, bits = config.N, config.K, config.bit
    g = config.effective_group_size
    if config.A_dtype == "int8":
        A = rng.integers(-8, 8, (m, K), dtype=np.int64).astype(np.int8)
    else:
        A = _float_draw(rng.standard_normal((m, K)), config.A_dtype)
    if config.is_native_compute():
        if config.A_dtype == "int8":
            W = rng.integers(-8, 8, (N, K), dtype=np.int64).astype(np.int8)
        else:   # JAX casts the float64 draws to A's dtype directly
            W = _float_draw(rng.standard_normal((N, K)), config.A_dtype,
                            via_f16=False)
        return ReferenceOperands(
            A=A, qweight=W if config.layout[1] == "t"
            else np.ascontiguousarray(W.T))
    codes = rng.integers(0, 1 << bits, (N, K),
                         dtype=np.int64).astype(np.uint8)
    out = ReferenceOperands(A=A, qweight=packing.general_compress(codes,
                                                                  bits))
    if config.with_scaling:
        out.scales = (rng.standard_normal((N, K // g)).astype(np.float16)
                      * 0.1 + 0.5).astype(np.float16)
    if config.with_zeros:
        out.zeros = rng.integers(0, 1 << bits,
                                 (N, K // g)).astype(np.float16)
    return out

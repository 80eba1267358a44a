"""Weight/activation dtype registry (counterpart of
bitblas_tpu/quantization/formats.py).

Every weight dtype is a ``(source_format, bits)`` pair, as in the
reference's ``BITBLAS_TRICK_DTYPE_MAP``. The whole map is kept so that a
config naming a format this port does not run yet fails with
NotImplementedError (ops/matmul_config.py) rather than "unknown dtype";
every pair the JAX package runs runs here too (ops/matmul_config.py).

`TORCH_DTYPES` gives each name with a dense type the torch type that
holds its values: its own, or for the types torch computes little with
the next wider signed one (int4 / uint4 in int8, as the JAX package holds
them; uint16 in int32, uint32 in int64). `convert` (quantization/
numerics.py) gives XLA's conversion into a name, on that storage.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np
import torch

DTYPE_MAP = {
    "float64": ("fp", 64),
    "float32": ("fp", 32),
    "float16": ("fp", 16),
    "bfloat16": ("bf", 16),
    "int32": ("int", 32),
    "uint32": ("uint", 32),
    "int16": ("int", 16),
    "uint16": ("uint", 16),
    "int8": ("int", 8),
    "uint8": ("uint", 8),
    "int4": ("int", 4),
    "uint4": ("uint", 4),
    "int2": ("int", 2),
    "uint2": ("uint", 2),
    "int1": ("int", 1),
    "uint1": ("uint", 1),
    "nf4": ("nf", 4),
    "fp4_e2m1": ("fp", 4),
    "e4m3_float8": ("fp_e4m3", 8),
    "e5m2_float8": ("fp_e5m2", 8),
}

# Names with a dense torch dtype (activations, outputs, scales).
TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "e4m3_float8": torch.float8_e4m3fn,
    "e5m2_float8": torch.float8_e5m2,
    # 4-bit values one an int8 (as the JAX package holds 4-bit
    # activations); unsigned 16- and 32-bit values in the next wider
    # signed type
    "int4": torch.int8,
    "uint4": torch.int8,
    "uint16": torch.int32,
    "uint32": torch.int64,
}
# The integer names with a dense type: (bits, signed).
INT_TYPES = {"int4": (4, True), "uint4": (4, False), "int8": (8, True),
             "uint8": (8, False), "int16": (16, True),
             "uint16": (16, False), "int32": (32, True),
             "uint32": (32, False)}
FLOAT8 = ("e4m3_float8", "e5m2_float8")


# (A_dtype, W_dtype) pairs computed densely without a dequantize stage
# (the JAX package's NATIVE_COMPUTE_PATTERNS).
NATIVE_COMPUTE_PATTERNS = frozenset([
    ("float64", "float64"),
    ("float32", "float32"),
    ("float16", "float16"),
    ("bfloat16", "bfloat16"),
    ("int8", "int8"),
    ("uint8", "uint8"),
    ("int4", "int4"),
    ("uint4", "uint4"),
    ("e4m3_float8", "e4m3_float8"),
    ("e4m3_float8", "e5m2_float8"),
    ("e5m2_float8", "e4m3_float8"),
    ("e5m2_float8", "e5m2_float8"),
])


def is_native_compute(A_dtype: str, W_dtype: str) -> bool:
    return (A_dtype, W_dtype) in NATIVE_COMPUTE_PATTERNS


def source_format_and_bits(W_dtype: str) -> Tuple[str, int]:
    if W_dtype not in DTYPE_MAP:
        raise ValueError(f"Unsupported weight dtype: {W_dtype}")
    return DTYPE_MAP[W_dtype]


def is_float_name(name: str) -> bool:
    """Whether the dense type `name` is a float type (float64 ... e5m2)."""
    return name in TORCH_DTYPES and name not in INT_TYPES


def int_range(name: str) -> Tuple[int, int]:
    """The least and greatest value of the integer name `name`."""
    bits, signed = INT_TYPES[name]
    return (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed \
        else (0, (1 << bits) - 1)


def as_torch_dtype(name: str) -> torch.dtype:
    if name not in TORCH_DTYPES:
        raise ValueError(f"{name} has no dense torch dtype; it is packed")
    return TORCH_DTYPES[name]


def storage_bits(storage_dtype: str) -> int:
    """Bit width of a storage container name ("int8" -> 8, "int32" -> 32)."""
    m = re.search(r"(\d+)$", storage_dtype)
    if not m:
        raise ValueError(f"Bad storage dtype: {storage_dtype}")
    return int(m.group(1))


# NF4 quantile table (QLoRA NormalFloat4): the JAX package's NF4_TABLE
# (bitblas_tpu/quantization/formats.py), the reference's LUT values.
NF4_TABLE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)


def nf4_lut(dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """NF4's 16 values rounded to `dtype` (the JAX `nf4_lut`)."""
    return torch.from_numpy(NF4_TABLE).to(dtype)


def weight_dtype_name(family: str, bits: int) -> str:
    """The W_dtype name of a (source format, bits) pair."""
    for name, fb in DTYPE_MAP.items():
        if fb == (family, bits):
            return name
    raise ValueError(f"no weight dtype {family}{bits}")

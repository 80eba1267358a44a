"""Operator-layer enums kept for config parity with the JAX package
(bitblas_tpu/ops/common.py).

`BackendKind` keeps the enum's name, but its members name the port's two
backends: a hand-written CUDA kernel (csrc/, built by kernels/build.py)
and a PyTorch library call (cuBLAS through `torch.matmul` /
`torch._int_mm`, cuDNN through `F.conv2d`). JAX's `Pallas` and `XLA` do
not apply here. `QuantizationMemoryStage` keeps JAX's members and values:
on Hopper, Local is the register decode inside kernel 1 and Global the
materialize plan's decoded weight in device memory (kernels 2 and 3).
"""

from __future__ import annotations

from enum import IntEnum


class TransformKind(IntEnum):
    NonTransform = 0
    InterWarpTransform = 1
    IntraWarpTransform = 2
    LDMatrixTransform = 3


class OptimizeStrategy(IntEnum):
    SingleBatchDecodeOnly = 0
    ContigousBatching = 1  # (sic) reference spelling kept for config parity


class BackendKind(IntEnum):
    CUDA = 0      # a hand-written CUDA kernel (csrc/)
    PyTorch = 1   # a PyTorch library call (cuBLAS, cuDNN)


class QuantizationMemoryStage(IntEnum):
    Local = 0     # decoded in registers inside the fused kernel
    Shared = 1
    Global = 2    # decoded to device memory, then the library product

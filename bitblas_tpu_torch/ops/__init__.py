"""Operators: configs, the plain reference, weight transforms and the
operators the JAX package exports from its `ops` (Matmul, MatmulWithSplitK,
FlashAtten, LadderPermutate, LOP3Permutate, QuantCompress, Conv2D,
QuantConv2D, BatchMatmul, Operator), each loaded on first use: the
kernels import ops.reference while this package initializes."""

import importlib

_EXPORTS = {
    "BackendKind": "common", "OptimizeStrategy": "common",
    "TransformKind": "common",
    "MatmulConfig": "matmul_config", "OperatorConfig": "matmul_config",
    "Matmul": "matmul",
    "MatmulConfigWithSplitK": "matmul_splitk",
    "MatmulWithSplitK": "matmul_splitk",
    "FlashAtten": "flashatten", "FlashAttenConfig": "flashatten",
    "LadderPermutate": "ladder_permutate",
    "LadderPermutateConfig": "ladder_permutate",
    "LOP3Permutate": "lop3_permutate", "LOP3PermutateConfig": "lop3_permutate",
    "QuantCompress": "quant_compress", "QuantCompressConfig": "quant_compress",
    "Conv2D": "conv2d", "Conv2DConfig": "conv2d", "QuantConv2D": "conv2d",
    "QuantConv2DConfig": "conv2d",
    "BatchMatmul": "batch_matmul", "BatchMatmulConfig": "batch_matmul",
    "Operator": "operator",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

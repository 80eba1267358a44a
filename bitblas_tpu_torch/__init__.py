"""bitblas_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper, sm_90a) port of
bitblas_tpu.

The JAX package (`bitblas_tpu/`) is the reference; this package keeps its
module and class names so each counterpart is found by name, and never
imports it (or JAX). Every entry point runs on the card unless the caller
passes ``device="cpu"``; on the CPU each kernel wrapper runs its plain
PyTorch version. The CUDA kernels under ``csrc/`` are compiled with
``nvcc`` at first use (``kernels/build.py``); importing builds nothing.

The public surface is the JAX package's `__all__`, less its TPU-only
names (`auto_detect_tpu_target`, `enable_jax_compilation_cache`):
`auto_detect_target` stands in their place. Each name is loaded on first
use, so ``import bitblas_tpu_torch`` stays light.
"""

import importlib

from .common import __version__, resolve_device, set_log_level

_EXPORTS = {
    **{name: "ops" for name in (
        "Matmul", "MatmulConfig", "MatmulWithSplitK",
        "MatmulConfigWithSplitK", "FlashAtten", "FlashAttenConfig",
        "LadderPermutate", "LadderPermutateConfig", "LOP3Permutate",
        "LOP3PermutateConfig", "QuantCompress", "QuantCompressConfig",
        "Conv2D", "Conv2DConfig", "QuantConv2D", "QuantConv2DConfig",
        "BatchMatmul", "BatchMatmulConfig", "TransformKind",
        "OptimizeStrategy", "OperatorConfig")},
    **{name: "tuner" for name in (
        "TileDevice", "TileHint", "fast_tune", "fast_tune_with_dynamic_range",
        "get_arch", "auto_detect_target")},
    **{name: "cache" for name in (
        "OperatorCache", "global_operator_cache", "load_global_ops_cache",
        "get_database_path")},
    "Linear": "module",
}

__all__ = [
    "Matmul", "MatmulConfig", "MatmulWithSplitK", "MatmulConfigWithSplitK",
    "FlashAtten", "FlashAttenConfig", "Linear",
    "LadderPermutate", "LadderPermutateConfig",
    "LOP3Permutate", "LOP3PermutateConfig",
    "QuantCompress", "QuantCompressConfig",
    "Conv2D", "Conv2DConfig", "QuantConv2D", "QuantConv2DConfig",
    "BatchMatmul", "BatchMatmulConfig",
    "TransformKind", "OptimizeStrategy",
    "TileDevice", "TileHint", "fast_tune", "fast_tune_with_dynamic_range",
    "auto_detect_target", "set_log_level",
    "OperatorCache", "global_operator_cache", "load_global_ops_cache",
    "get_database_path", "__version__", "resolve_device",
]


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

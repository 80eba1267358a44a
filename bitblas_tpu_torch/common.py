"""Device resolution shared by every public constructor and entry point,
the hint database's default location, and the package's logger.

Devices are explicit: the default is ``"cuda"``, and only an explicit
``device="cpu"`` runs on the CPU. Asking for CUDA on a host without a card
raises instead of quietly carrying on on the CPU.

The hint database (cache/__init__.py) lives under
``$BITBLAS_TPU_TORCH_CACHE_PATH``, by default ``~/.cache/bitblas_tpu_torch``:
the port's own, never the JAX package's.

`get_logger()` is the ``"bitblas_tpu_torch"`` logger every module logs
through: one stderr handler at WARNING, not propagated to the root logger
(the JAX package's `common._initialize_logging` rule); `set_log_level`
takes a level number or name.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

__version__ = "0.1.0"

DATABASE_PATH_ENV = "BITBLAS_TPU_TORCH_CACHE_PATH"


def default_database_path() -> str:
    """The hint database's root, read from the environment at each call."""
    return os.path.expanduser(os.environ.get(
        DATABASE_PATH_ENV, "~/.cache/bitblas_tpu_torch"))


def resolve_device(device="cuda") -> torch.device:
    """Validate `device` ("cuda", "cuda:N", "cpu" or a torch.device)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bitblas_tpu_torch: device 'cuda' requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


_LOGGER_NAME = "bitblas_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def _initialize_logging() -> None:
    logger = get_logger()
    if logger.handlers:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s [bitblas_tpu_torch:%(levelname)s] %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.WARNING)
    logger.propagate = False


def set_log_level(level) -> None:
    """Set the package's log level (a number, or a name such as "info")."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    get_logger().setLevel(level)


_initialize_logging()

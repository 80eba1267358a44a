"""Device resolution shared by every public constructor and entry point,
and the hint database's default location.

Devices are explicit: the default is ``"cuda"``, and only an explicit
``device="cpu"`` runs on the CPU. Asking for CUDA on a host without a card
raises instead of quietly carrying on on the CPU.

The hint database (cache/__init__.py) lives under
``$BITBLAS_TPU_TORCH_CACHE_PATH``, by default ``~/.cache/bitblas_tpu_torch``:
the port's own, never the JAX package's.
"""

from __future__ import annotations

import os

import torch

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

"""Device envelopes for the tile space and the roofline (counterpart of
bitblas_tpu/tuner/arch.py).

A `TileDevice` records what bounds a kernel on one card: device memory
bandwidth, the dense tensor-core peaks by operand type, the FFMA peak for
float32, the SM count, the shared memory a block may use and the L2 size.
`H100_SXM` holds NVIDIA's data-sheet figures for the H100 SXM part (the
peaks assume its 700 W power limit); `CPU` is the envelope of an operator
that runs the plain PyTorch versions on the host, where nothing is
measured: its rates are nominal and only rank plans, and its shared
memory is the H100's, so the CPU tests see the card's tile space.

`auto_detect_target` names the attached card from
`torch.cuda.get_device_properties`; an unknown card, like an unknown
target name given to `get_arch`, raises instead of borrowing another
card's envelope.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class TileDevice:
    """One card's performance envelope."""
    name: str
    hbm_bandwidth: float     # device memory, bytes/s
    flops_f16: float         # dense f16 / bf16 tensor core, flop/s
    flops_int8: float        # dense int8 tensor core, op/s
    flops_f32: float         # float32 FFMA outside the tensor cores, flop/s
    sm_count: int
    smem_per_block: int      # bytes of shared memory one block may use
    l2_bytes: int
    is_cpu: bool = False


# NVIDIA H100 SXM data sheet (dense rates, no sparsity) and the Hopper
# tuning guide's 227 KB opt-in shared memory per block.
H100_SXM = TileDevice("h100_sxm", 3.35e12, 989e12, 1979e12, 67e12, 132,
                      232448, 50 * 2 ** 20)
CPU = TileDevice("cpu", 50e9, 1e12, 1e12, 5e11, 1, 232448, 32 * 2 ** 20,
                 is_cpu=True)

_BY_NAME = {"h100_sxm": H100_SXM, "h100": H100_SXM, "cpu": CPU}


def auto_detect_target(device: Optional[torch.device] = None) -> str:
    """The target name of the card `device` (default: the current one),
    or "cpu" when no card is available or `device` is the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    props = torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else device)
    name = props.name
    # The SXM part carries HBM3 (the PCIe card HBM2e, NVL HBM3 with 94 GB)
    if "H100" in name and "HBM3" in name and "NVL" not in name \
            and props.multi_processor_count == H100_SXM.sm_count:
        return H100_SXM.name
    raise ValueError(f"no envelope for the card {name!r} "
                     f"({props.multi_processor_count} SMs); known targets: "
                     f"{sorted(set(_BY_NAME))}")


def get_arch(target: Optional[str] = None) -> TileDevice:
    if target is None:
        target = auto_detect_target()
    key = target.lower()
    if key not in _BY_NAME:
        raise ValueError(f"Unknown target {target!r}; "
                         f"known: {sorted(set(_BY_NAME))}")
    return _BY_NAME[key]

"""Device scratch of the kernels that split a reduction across blocks and
merge it inside the same launch (the split-KV decode kernels of
kernels/flash.py, the split-K decode instances of kernel 1 in
kernels/dequant_matmul.py and its general instance in
kernels/general.py).

Each such launch writes partials (float32; int32 for integer sums) to a
scratch buffer and counts finished blocks in an int32 counter that the
last block resets to 0. The counters live in one buffer a device,
zeroed once and left at 0 by every launch, so calls on one device must
run in stream order (the engines run one stream). The partials are per
call. Both come from here, so that one change (a CUDA graph's pool, a
counter buffer made before capture) covers every split kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

# Counters allocated at least this many at a time, so that the buffer of
# a device rarely has to grow (a new buffer would be a new allocation).
_MIN_COUNTERS = 1 << 14

_counters: Dict[int, torch.Tensor] = {}   # device index -> int32 zeros
_sms: Dict[int, int] = {}                 # device index -> SM count


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (cached)."""
    dev = _index(device)
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def counters(device: torch.device, n: int) -> torch.Tensor:
    """At least `n` int32 counters on `device`, all 0 (the kernels leave
    them at 0)."""
    dev = _index(device)
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = _counters[dev] = torch.zeros(max(n, _MIN_COUNTERS),
                                           dtype=torch.int32, device=device)
    return buf


def partials(device: torch.device, numel: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A buffer of `numel` partial sums for one launch (float32; int32 for
    kernel 1's int2 decode instance and integer sums, float64 for float64
    sums)."""
    return torch.empty(numel, dtype=dtype, device=device)

"""Profiling helpers (counterpart of bitblas_tpu/utils/profiling.py).

`profiler_trace` records a block under `torch.profiler` (the host's
calls and, where a card is present, its kernels) and writes a Chrome
trace into `logdir`; `get_commit_id` stamps results with the checkout's
commit. Kernel times come from utils/timing.py.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Profile a block and write ``trace-<time>.json`` (Chrome trace
    format, chrome://tracing or Perfetto) into `logdir`:

        with profiler_trace("traces") as prof:
            fn(*args)
            torch.cuda.synchronize()
        print(prof.key_averages().table())
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))


def get_commit_id() -> Optional[str]:
    """The checkout's commit (``git rev-parse HEAD``), or None outside a
    git checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None

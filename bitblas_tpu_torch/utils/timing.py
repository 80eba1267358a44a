"""Kernel timing on the card (counterpart of bitblas_tpu/utils/timing.py).

`measure_kernel(fn, args)` is the median device time of one call of
``fn(*args)``: warm-up calls first, then `iters` calls each between two
CUDA events, with the L2 cache flushed before each call so that weights
come from device memory as they do on the serving path. The flush reads
a buffer of twice the card's L2 size (one sum into a one-element
output); the buffer is written once, before the warm-up. A read leaves
no dirty line behind, so the timed call never pays for writing back the
flush's lines (a flush that rewrote the buffer did: a plain read of
25.8 MB then took three times its byte bound). A device-side sleep queued before
the timed calls keeps the card busy while the host enqueues them, so no
call waits on the host's wrapper code between its two events.

`make_chained(fn, args)` and `measure_chained(chained)` keep the JAX
package's pair: `chained(iters)` enqueues `iters` calls back to back with
no flush between them, and `measure_chained` takes the slope of the
CUDA-event spans of two call counts, each queued behind a device sleep.
That is the warm-cache, back-to-back time a call (a call finds in L2
what the call before it left there), where `measure_kernel` gives the
flushed single-call time. JAX's loop carries a value through one input
and out of the output so that XLA can neither elide a call nor slice it
to the part that is read: a TPU workaround that eager PyTorch does not
need.

There is no CPU fallback: without a card these functions raise.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import time

import torch

# ~25 ms of an H100's clock: longer than the host needs to enqueue the
# timed calls
_SLEEP_CYCLES = 50_000_000


# the sleep's clock rate assumed when sizing it to the host's enqueue time
_SLEEP_HZ = 2e9
# the most calls measure_chained queues in one span
_MAX_CHAIN = 256


def _require_card(name: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} times on the card; "
                           "torch.cuda.is_available() is False")


def time_launches(fn: Callable, args: Sequence = (), *, warmup: int = 2,
                  iters: int = 20, flush: bool = True) -> List[float]:
    """Per-call device seconds of `iters` calls of fn(*args), sorted."""
    _require_card("measure_kernel")
    buf = acc = None
    if flush:
        l2 = torch.cuda.get_device_properties(
            torch.cuda.current_device()).L2_cache_size
        buf = torch.zeros(2 * l2 // 4, dtype=torch.float32, device="cuda")
        acc = torch.empty((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(_SLEEP_CYCLES)
    events = []
    for _ in range(iters):
        if buf is not None:
            torch.sum(buf, 0, out=acc)   # read-only: leaves no dirty line
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) * 1e-3 for s, e in events)


def median(times: Sequence[float]) -> float:
    return times[len(times) // 2]


def spread(times: Sequence[float]) -> float:
    """Interquartile range over the median of sorted times."""
    n = len(times)
    return (times[(3 * n) // 4] - times[n // 4]) / median(times)


def measure_kernel(fn: Callable, args: Sequence = (), *, warmup: int = 2,
                   iters: int = 20, flush: bool = True) -> float:
    """Median device seconds of one call of fn(*args)."""
    return median(time_launches(fn, args, warmup=warmup, iters=iters,
                                flush=flush))


def make_chained(fn: Callable, args: Sequence = (),
                 inject: Optional[int] = None,
                 full_output_dep: bool = False) -> Callable:
    """chained(iters) -> the last output: `iters` calls of fn(*args)
    enqueued back to back on the current stream, no L2 flush between
    them. `inject` and `full_output_dep` are JAX's (the input that carries
    the loop's value, and whether the whole output feeds it) and are not
    needed here: an eager call runs whole whether or not its output is
    read."""
    del inject, full_output_dep
    _require_card("make_chained")
    args = tuple(args)

    def chained(iters: int):
        out = None
        for _ in range(int(iters)):
            out = fn(*args)
        return out

    return chained


def _span(chained: Callable, iters: int, sleep_cycles: int):
    """(device seconds of chained(iters) between two CUDA events queued
    behind a device sleep, host seconds its enqueue took)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(sleep_cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chained(iters)
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3, host


def measure_chained(chained: Callable, *, est_iters: int = 32,
                    target_sec: float = 0.05, repeats: int = 2) -> float:
    """Seconds a call of `chained` (make_chained) back to back: the slope
    (T(n2) - T(n1)) / (n2 - n1) of the shortest of max(repeats, 3) spans
    at each count, n1 = 4 and n2 sized from a first span of `est_iters`
    calls to about `target_sec` (at most n1 + 256 calls). Each span waits
    behind a device sleep at least twice as long as the host took to
    enqueue its calls, so the card runs them without a gap."""
    _require_card("measure_chained")
    chained(2)
    rough, host = _span(chained, est_iters, _SLEEP_CYCLES)
    per_call = max(rough / est_iters, 1e-7)
    n1 = 4
    n2 = n1 + min(max(16, int(target_sec / per_call)), _MAX_CHAIN)
    sleep = max(_SLEEP_CYCLES,
                int(2 * host / est_iters * n2 * _SLEEP_HZ))
    t1s, t2s = [], []
    for _ in range(max(repeats, 3)):
        t1s.append(_span(chained, n1, sleep)[0])
        t2s.append(_span(chained, n2, sleep)[0])
    return max((min(t2s) - min(t1s)) / (n2 - n1), 1e-9)

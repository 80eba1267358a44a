"""Measured tuning: rank the tile space, time candidates on the card, keep
the fastest (counterpart of bitblas_tpu/tuner/tune.py).

Same contract as the JAX tuner: `fast_tune` tunes one static shape,
`fast_tune_with_dynamic_range` every M bucket, `_stratified_candidates`
picks which top-k to measure. Candidates are timed with CUDA events
(utils/timing.py), each warmed up in a pass over all of them before any
is timed, because a run's first timing reads high and would penalise
whichever candidate came first. Unlike the JAX loop, a candidate that
fails to launch raises: the space lists only legal candidates, so a
failure is a kernel fault, not a candidate to skip. On the CPU nothing is
measured and the analytic pick (the default hint) comes back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..kernels.spec import KernelSpec
from ..utils import timing
from .arch import TileDevice
from .hint import TileHint
from .space import enumerate_hints, roofline_seconds


@dataclasses.dataclass
class TuneResult:
    hint: TileHint
    latency: float           # seconds/run (measured median) or roofline
    measured: bool
    # (hint, median seconds, interquartile range over the median)
    candidates: List[Tuple[TileHint, float, float]] = dataclasses.field(
        default_factory=list)


def _stratified_candidates(hints: Sequence[TileHint],
                           topk: int) -> List[TileHint]:
    """The measured set: the ranked prefix (half of topk) plus the first
    representative of every family (plan, block_m) not in it, then the
    next-ranked hints until topk."""
    def family(h: TileHint):
        return (h.decode_mode, h.block_m)

    half = max(topk // 2, 1)
    picked: List[TileHint] = list(hints[:half])
    seen_fams = {family(h) for h in picked}
    rest = list(hints[half:])
    for h in rest:
        if len(picked) >= topk:
            return picked
        if family(h) not in seen_fams:
            seen_fams.add(family(h))
            picked.append(h)
    for h in rest:
        if len(picked) >= topk:
            break
        if h not in picked:
            picked.append(h)
    return picked


def fast_tune(spec: KernelSpec, arch: TileDevice,
              builder: Callable[[TileHint], Callable],
              make_args: Callable[[TileHint], Sequence],
              topk: int = 20, iters: int = 20) -> TuneResult:
    """Tune one static-shape spec: builder(hint) -> fn(*args); make_args
    (hint) -> the example inputs on the card."""
    hints = enumerate_hints(spec, arch)
    if not hints:
        raise ValueError(f"No legal tile configuration for {spec}")
    if arch.is_cpu or topk <= 0:
        return TuneResult(hint=hints[0],
                          latency=roofline_seconds(spec, hints[0], arch),
                          measured=False)
    runs = [(h, builder(h), make_args(h))
            for h in _stratified_candidates(hints, topk)]
    for _, fn, args in runs:          # warm every candidate first
        fn(*args)
    torch.cuda.synchronize()
    results = []
    for h, fn, args in runs:
        times = timing.time_launches(fn, args, iters=iters)
        results.append((h, timing.median(times), timing.spread(times)))
    best = min(results, key=lambda r: r[1])
    return TuneResult(hint=best[0], latency=best[1], measured=True,
                      candidates=results)


def fast_tune_with_dynamic_range(
    make_spec: Callable[[int], KernelSpec],
    m_buckets: Sequence[int],
    arch: TileDevice,
    builder: Callable[[KernelSpec, TileHint], Callable],
    make_args: Callable[[KernelSpec, TileHint], Sequence],
    topk: int = 20,
) -> Dict[int, TuneResult]:
    """Tune every M bucket; the operator picks the bucket per call."""
    out: Dict[int, TuneResult] = {}
    for m in m_buckets:
        spec = make_spec(m)
        out[m] = fast_tune(
            spec, arch,
            builder=lambda h, s=spec: builder(s, h),
            make_args=lambda h, s=spec: make_args(s, h),
            topk=topk)
    return out

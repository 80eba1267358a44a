"""Operator base class: hints per M bucket, tuning, dispatch, profiling
(counterpart of bitblas_tpu/ops/operator.py).

An operator holds a bucket -> TileHint table over its M buckets. There
are no compiled objects to hold: the CUDA kernels are built once per
process by kernels/build.py, and a hint only picks the plan and the tile
instance a call launches. Each bucket starts at the analytic default
(tuner/space.default_hint); `hardware_aware_finetune` measures the
legal candidates of every bucket on the card and installs the winners,
and `apply_hints` installs hints from elsewhere (a tune script, the hint
database). An installed hint routes every M of its bucket (the smallest
bucket >= M, `select_bucket`); an M in a bucket nobody installed, or past
the largest bucket, takes `default_hint` at its true M, so an untuned
operator routes exactly as the port did before it had a tuner.

Buckets whose hints were measured here (or pinned by the caller) are
`tuned_hints`, the ones the hint database persists; hints loaded from the
database are installed without pinning, so a process that only loaded
them never re-persists them as its own measurements.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..common import get_logger, resolve_device
from ..kernels.spec import KernelSpec
from ..tuner import (TileDevice, TileHint, TuneResult, auto_detect_target,
                     default_hint, fast_tune, get_arch, roofline_seconds)
from ..utils.timing import measure_kernel
from .matmul_config import OperatorConfig

logger = get_logger()

# hint_for keeps the default hint of each M it has seen (a decode step
# asks for the same few M hundreds of times); at most this many
_DEFAULTS_KEPT = 4096


class BaseKernelNameGenerator:
    """Kernel names for logs and cache keys (JAX's generator interface):
    `generate(hint)` names the configuration and the hint's plan."""

    KERNEL_PREFIX = "kernel"

    def __init__(self, config: OperatorConfig):
        if not self.is_valid_config(config):
            raise ValueError(f"{type(self).__name__} does not name "
                             f"{config!r}")
        self.config = config

    def is_valid_config(self, config: OperatorConfig) -> bool:
        raise NotImplementedError

    def generate(self, hint=None) -> str:
        raise NotImplementedError


class Operator:
    """Holds one hint per dynamic-M bucket."""

    def __init__(self, name: str, config: OperatorConfig, device="cuda"):
        self.name = name
        self.config = config
        self.device = resolve_device(device)
        self.arch: TileDevice = get_arch(auto_detect_target(self.device))
        self._hints: Dict[int, TileHint] = {}
        self._installed: set = set()  # applied or tuned: routes its bucket
        self._pinned: set = set()     # measured here: persisted by the DB
        self._buckets = tuple(sorted(self.m_buckets))
        self._defaults: Dict[int, TileHint] = {}   # M -> default_hint
        self.tune_results: Dict[int, TuneResult] = {}

    # -- abstract hooks ------------------------------------------------------
    @property
    def m_buckets(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def _make_spec(self, m: int) -> KernelSpec:
        raise NotImplementedError

    def _build_kernel(self, spec: KernelSpec, hint: TileHint) -> Callable:
        """fn(*example_args) running the hint's plan."""
        raise NotImplementedError

    def _example_input(self, m: int):
        raise NotImplementedError

    def _example_weights(self) -> Sequence:
        raise NotImplementedError

    def _example_args(self, spec: KernelSpec, hint: TileHint) -> Sequence:
        """Random inputs on the operator's device for timing `spec`
        (the hint does not change the device layout on Hopper)."""
        del hint
        return (self._example_input(spec.m), *self._example_weights())

    # -- lifecycle -----------------------------------------------------------
    def _build_default_module(self) -> None:
        for m in self.m_buckets:
            if m not in self._hints:
                self._hints[m] = default_hint(self._make_spec(m), self.arch)

    def apply_hints(self, hints: Dict[int, TileHint], *,
                    pin: bool = True) -> None:
        """Install hints for their buckets (others keep or get defaults).
        `pin=True` marks them as this process's measurements, which a
        database save persists; the database load passes pin=False."""
        for m, hint in hints.items():
            if m not in self.m_buckets:
                continue
            self._hints[m] = hint
            self._installed.add(m)
            if pin:
                self._pinned.add(m)
            else:
                self._pinned.discard(m)
        self._build_default_module()

    def hardware_aware_finetune(self, topk: int = 20) -> None:
        """Measure every bucket's candidates on the card and install the
        winners (JAX topk=20 contract). On the CPU nothing is measured and
        the analytic defaults stay."""
        if self.arch.is_cpu:
            logger.info("%s: CPU -- keeping the analytic hints", self.name)
            return
        weights = self._example_weights()
        for m in self.m_buckets:
            spec = self._make_spec(m)
            args = (self._example_input(m), *weights)
            result = fast_tune(
                spec, self.arch,
                builder=lambda h, s=spec: self._build_kernel(s, h),
                make_args=lambda h, a=args: a, topk=topk)
            self._hints[m] = result.hint
            self._installed.add(m)
            self._pinned.add(m)
            self.tune_results[m] = result
            logger.info("%s m=%d tuned: %s (%.1f us)", self.name, m,
                        result.hint.short_name(), result.latency * 1e6)

    # -- dispatch ------------------------------------------------------------
    def select_bucket(self, m: int) -> int:
        """Smallest bucket >= m, else the largest."""
        i = bisect.bisect_left(self._buckets, m)
        return self._buckets[min(i, len(self._buckets) - 1)]

    def hint_for(self, m: int) -> TileHint:
        """The hint a call with M = m runs: its bucket's installed hint,
        else the default at m."""
        b = self.select_bucket(m)
        if m <= b and b in self._installed:
            return self._hints[b]
        hint = self._defaults.get(m)
        if hint is None:
            hint = default_hint(self._make_spec(m), self.arch)
            if len(self._defaults) < _DEFAULTS_KEPT:
                self._defaults[m] = hint
        return hint

    def kernel_for(self, m: int, jitted: bool = True) -> Callable:
        """fn(*args) launching what a call with M = m launches: the plan
        and tile of `hint_for(m)`, its bucket's hint where one is
        installed. There is nothing compiled to hold (the kernels are
        built once a process), so `jitted` changes nothing."""
        del jitted
        return self._build_kernel(self._make_spec(m), self.hint_for(m))

    @property
    def hints(self) -> Dict[int, TileHint]:
        return dict(self._hints)

    @property
    def tuned_hints(self) -> Dict[int, TileHint]:
        """The measured / pinned buckets: what the hint database keeps
        (defaults are reconstructible)."""
        return {m: self._hints[m] for m in self._pinned}

    # -- profiling ------------------------------------------------------------
    def profile_latency(self, m: Optional[int] = None) -> float:
        """Seconds per call of bucket m's hint, measured on the card; on
        the CPU the roofline, as the JAX operator returns in interpret
        mode."""
        bucket = self.select_bucket(m if m is not None
                                    else max(self.m_buckets))
        spec = self._make_spec(bucket)
        hint = self._hints.get(bucket) or default_hint(spec, self.arch)
        if self.arch.is_cpu:
            return roofline_seconds(spec, hint, self.arch)
        return measure_kernel(self._build_kernel(spec, hint),
                              self._example_args(spec, hint))

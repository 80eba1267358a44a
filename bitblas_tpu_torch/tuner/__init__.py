"""Tuner: device envelopes, tile hints, the tile space with its roofline,
and the measured top-k search (counterpart of bitblas_tpu/tuner)."""

from .arch import (  # noqa: F401
    CPU,
    H100_SXM,
    TileDevice,
    auto_detect_target,
    get_arch,
)
from .hint import (  # noqa: F401
    HINT_CLASSES,
    MATERIALIZE,
    FlashHint,
    TileHint,
)
from .space import (  # noqa: F401
    MATERIALIZE_MIN_M,
    default_hint,
    enumerate_hints,
    roofline_seconds,
    smem_bytes,
)
from .tune import (  # noqa: F401
    TuneResult,
    fast_tune,
    fast_tune_with_dynamic_range,
)

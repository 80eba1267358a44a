"""Operator cache: in-memory registry + on-disk tuned-hint database
(counterpart of bitblas_tpu/cache/__init__.py).

The database keeps what a measurement found, the tuned hints, with the
config to rebuild the operator; the kernels themselves are rebuilt from
the sources (kernels/build.py). Layout:

    <db>/<target>/<sha256(repr(config))[:32]>/
        config.json   -- dataclass fields of the operator config
        mapping.json  -- operator / config / hint class names
        hints.json    -- {m_bucket: TileHint dict}, tuned buckets only (a
                         FlashAtten: {0: FlashHint dict})

`<db>` defaults to common.default_database_path(), the port's own
location. Every file is written to a temporary name and renamed, so a
concurrent reader sees a whole file or none; hints.json is merged under
an fcntl lock, so two processes tuning different buckets of one config
keep both, and a bucket measured here replaces what the disk held. Only
tuned buckets are written (defaults are reconstructible), and loaded
hints are installed unpinned (Operator.apply_hints(pin=False)), so a
process that only loaded them never writes them back as its own.
"""

from __future__ import annotations

import dataclasses
import fcntl
import hashlib
import json
import os
import threading
from typing import Dict, Optional

from ..common import default_database_path, get_logger
from ..tuner import HINT_CLASSES, auto_detect_target, get_arch

logger = get_logger()


def get_database_path() -> str:
    return default_database_path()


def _config_hash(config) -> str:
    return hashlib.sha256(repr(config).encode()).hexdigest()[:32]


def _atomic_write_json(path: str, obj) -> None:
    """tmp file + rename: readers in any thread or process see the old
    complete file or the new one."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _config_to_json(config) -> dict:
    out = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        if hasattr(v, "value"):   # IntEnum
            v = int(v)
        if isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def _classes() -> Dict[str, type]:
    """Reflection registry for mapping.json (imported here: the models
    import this module)."""
    from ..ops.flashatten import FlashAtten, FlashAttenConfig
    from ..ops.matmul import Matmul
    from ..ops.matmul_config import MatmulConfig
    return {"Matmul": Matmul, "MatmulConfig": MatmulConfig,
            "FlashAtten": FlashAtten, "FlashAttenConfig": FlashAttenConfig}


class OperatorCache:

    def __init__(self):
        self._lock = threading.RLock()
        self._ops: Dict[object, object] = {}

    def get(self, config):
        with self._lock:
            return self._ops.get(config)

    def add(self, config, op):
        with self._lock:
            self._ops[config] = op

    def size(self) -> int:
        with self._lock:
            return len(self._ops)

    def clear(self):
        with self._lock:
            self._ops.clear()

    # -- disk -----------------------------------------------------------------
    def save_into_database(self, database_path: Optional[str] = None,
                           target: Optional[str] = None) -> None:
        """Write every operator's tuned hints under `target` (default: the
        operator's own arch)."""
        database_path = database_path or get_database_path()
        with self._lock:
            items = list(self._ops.items())
        for config, op in items:
            d = os.path.join(database_path, target or op.arch.name,
                             _config_hash(config))
            os.makedirs(d, exist_ok=True)
            _atomic_write_json(os.path.join(d, "config.json"),
                               _config_to_json(config))
            _atomic_write_json(os.path.join(d, "mapping.json"), {
                "operator": type(op).__name__,
                "config": type(config).__name__,
                "hint": getattr(op, "HINT_CLASS", "TileHint")})
            tuned = {str(m): h.to_dict() for m, h in op.tuned_hints.items()}
            with open(os.path.join(d, ".lock"), "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                merged = {}
                try:
                    with open(os.path.join(d, "hints.json")) as f:
                        merged = json.load(f)
                except FileNotFoundError:
                    pass
                merged.update(tuned)
                _atomic_write_json(os.path.join(d, "hints.json"), merged)

    def load_from_database(self, database_path: Optional[str] = None,
                           target: Optional[str] = None) -> int:
        """Rebuild every operator saved under `target` (default: the
        attached card, or "cpu") with its hints installed unpinned, on
        the target's device; returns how many were loaded. An entry still
        being written (a file missing) or unreadable is skipped with a
        warning."""
        database_path = database_path or get_database_path()
        target = target or auto_detect_target()
        device = "cpu" if get_arch(target).is_cpu else "cuda"
        root = os.path.join(database_path, target)
        if not os.path.isdir(root):
            return 0
        classes = _classes()
        loaded = 0
        for entry in sorted(os.listdir(root)):
            d = os.path.join(root, entry)
            try:
                with open(os.path.join(d, "mapping.json")) as f:
                    mapping = json.load(f)
                with open(os.path.join(d, "config.json")) as f:
                    config_fields = json.load(f)
                with open(os.path.join(d, "hints.json")) as f:
                    hints = json.load(f)
                config = classes[mapping["config"]](**config_fields)
                hint_cls = HINT_CLASSES[mapping["hint"]]
                hints = {int(m): hint_cls.from_dict(h)
                         for m, h in hints.items()}
            except (OSError, ValueError, KeyError,
                    NotImplementedError) as ex:
                logger.warning("cache entry %s not loaded: %s", d, ex)
                continue
            op = classes[mapping["operator"]](
                config, device=device, enable_tuning=False,
                from_database=True)
            op.apply_hints(hints, pin=False)
            self.add(config, op)
            loaded += 1
        return loaded


global_operator_cache = OperatorCache()


def load_global_ops_cache(database_path: Optional[str] = None,
                          target: Optional[str] = None) -> int:
    return global_operator_cache.load_from_database(database_path, target)

"""Build the CUDA sources under ``csrc/`` with nvcc and load them with
ctypes.

Each ``csrc/<name>.cu`` exports plain C entry points (no PyTorch headers,
so one nvcc call takes seconds, not minutes) and is compiled for
``sm_90a`` into ``build/bitblas_tpu_torch/<name>-<hash>.so`` inside the
checkout, keyed by a hash of the sources and flags. Nothing is built when
a module is imported: `load` builds on first use, and `build` starts one
nvcc per source at once so a fresh checkout compiles in parallel. A build
that fails raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bitblas_tpu_torch"
# -fno-gnu-unique: a template's statics (the once-a-device shared-memory
# flags of dequant_wgmma.cuh) stay private to each library, so two trees'
# libraries loaded into one process (scripts/torch_ab_kernels.py) do not
# share them and skip each other's cudaFuncSetAttribute.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique",
              "-Xptxas", "-v")
SOURCES = ("dequant_matmul", "dequant_matmul_i2", "weight_decode",
           "weight_decode_int8", "flash_attention", "flash_decode",
           # kernel 4 at its other head dims, for float32 operands, and its
           # general instance (every configuration the others do not take)
           "flash_attention_d64", "flash_attention_d80",
           "flash_attention_d96", "flash_attention_d100",
           "flash_attention_d256", "flash_attention_f32",
           "flash_attention_general",
           "flash_decode_quant", "flash_decode_paged",
           "flash_decode_paged_quant", "dense_matmul",
           # kernels 1 and 2 for the other formats with float activations
           # (csrc/dequant_formats.cuh), a source for each family group and
           # activation type so that they build side by side
           "dequant_fmt_uint_f16", "dequant_fmt_uint_bf16",
           "dequant_fmt_int_f16", "dequant_fmt_int_bf16",
           "dequant_fmt_float_f16", "dequant_fmt_float_bf16",
           # kernel 1 for int8 activations (csrc/dequant_int.cuh), a
           # source for each weight format
           "dequant_int_u1", "dequant_int_u2", "dequant_int_u4",
           "dequant_int_i1", "dequant_int_i2", "dequant_int_i4",
           # kernels 1-3's general instance: every other configuration
           # (the mma.sync units and the decode; the DMMA and FFMA units)
           "dequant_general", "dequant_general_ffma")

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels of bitblas_tpu_torch cannot be built")
    return cand


def library_path(name: str) -> Path:
    """Where `name`'s shared library lands, keyed by its sources."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library of `names` that is not built yet, one nvcc
    process per source, all started together. Returns, per name,
    ``{"seconds": wall time or 0.0 if cached, "log": nvcc output}``."""
    procs = {}
    out = {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)   # atomic: concurrent builders never see half
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def entry(source: str, symbol: str, argtypes):
    """The C entry point `symbol` of csrc/<source>.cu with its ctypes
    signature set (pointers and the stream as c_void_p); every entry point
    returns the launch's cudaError_t as an int."""
    with _lock:
        fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with _lock:
            _entries[symbol] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

"""Time nvcc on single CUDA sources of the port and read ptxas's report.

Each source is compiled alone, with the flags `bitblas_tpu_torch.kernels.
build` uses (``-Xptxas -v`` among them), into a temporary directory under
``build/``; at most ``--jobs`` compiles run at once (default: the CPU
count, so that no two share a core). For each source one JSON line:

    {"label": ..., "source": ..., "wall_s": ..., "cpu_s": ...,
     "kernels": [{"name": mangled entry, "registers": n,
                  "spill_stores": bytes, "spill_loads": bytes}, ...]}

``cpu_s`` is nvcc's user + system time with its children (cicc, ptxas,
the host compiler). A source may carry a label, ``label:path``, so that
two trees' copies of one source (e.g. a parent commit unpacked under
``build/``) compile side by side in one run:

    python3 scripts/nvcc_times.py bitblas_tpu_torch/csrc/dequant_general.cu \\
        parent:build/parent/bitblas_tpu_torch/csrc/dequant_general.cu

``--log-dir`` keeps each nvcc output. Needs nvcc (CUDA toolkit); no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bitblas_tpu_torch.kernels import build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_kernels(log: str):
    """[{name, registers, spill_stores, spill_loads}] from ptxas -v."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"name": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", help="[label:]path/to/source.cu")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--log-dir", type=Path)
    args = ap.parse_args(argv)
    specs = []
    for s in args.sources:
        label, _, path = s.rpartition(":")
        specs.append((label or "tree", Path(path)))
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="nvcc_times_", dir=ROOT / "build"))
    if args.log_dir:
        args.log_dir.mkdir(parents=True, exist_ok=True)
    pending, running, rc = list(enumerate(specs)), {}, 0
    while pending or running:
        while pending and len(running) < args.jobs:
            i, (label, src) = pending.pop(0)
            log = open(tmp / f"{i}.log", "w+")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                   str(tmp / f"{i}.so"), str(src)]
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT)
            running[proc.pid] = (proc, log, label, src, time.perf_counter())
        # reap whichever ends first, with its (and its children's) rusage
        pid, status, use = os.wait4(-1, 0)
        if pid not in running:
            continue
        proc, log, label, src, t0 = running.pop(pid)
        wall = time.perf_counter() - t0
        proc.returncode = os.waitstatus_to_exitcode(status)
        log.seek(0)
        text = log.read()
        log.close()
        if args.log_dir:
            (args.log_dir / f"{label}_{src.stem}.log").write_text(text)
        row = {"label": label, "source": str(src), "rc": proc.returncode,
               "wall_s": wall, "cpu_s": use.ru_utime + use.ru_stime,
               "kernels": ptxas_kernels(text)}
        if proc.returncode:
            rc = 1
            row["log_tail"] = text[-2000:]
        print(json.dumps(row), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

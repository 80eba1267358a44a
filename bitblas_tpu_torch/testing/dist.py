"""Worlds of ranks for the port's distributed paths (test infrastructure,
not a public launcher).

`run_world(target, world_size, *args, backend="gloo")` spawns one process
a rank. Each joins a process group over a `FileStore` in a fresh temporary
directory (no TCP port: several test workers start worlds at once), takes
one intra-op thread, calls ``target(rank, world_size, *args)`` and saves
what it returns; `run_world` returns those values in rank order. A rank
that raises fails the world (the others are stopped) with its traceback.

Spawn re-imports the target's module in every rank, so the target lives
in a module that imports only torch and this package (never a test
module, which imports the JAX package). The rank code picks its own
device: the CPU in the tests, the card in chip_smoke.py.

`probe_collectives` is a rank target that tries each collective the
parallel layer uses (parallel/__init__.py's table) on tensors of one
device and reports which the backend takes and whether the values came
back right.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this fails the rank (and the world)
# instead of hanging it
TIMEOUT_S = 300


def _rank_main(rank: int, world_size: int, store_path: str, backend: str,
               target, args, out_dir: str, threads: int,
               timeout_s: float) -> None:
    torch.set_num_threads(threads)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = target(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(target, world_size: int, *args, backend: str = "gloo",
              threads: int = 1, timeout_s: float = TIMEOUT_S) -> list:
    """Run ``target(rank, world_size, *args)`` in `world_size` spawned
    processes joined by a `backend` process group; their return values
    (torch.save-able), in rank order."""
    with tempfile.TemporaryDirectory(prefix="bbt_world_") as d:
        mp.spawn(_rank_main,
                 args=(world_size, os.path.join(d, "store"), backend, target,
                       args, d, threads, timeout_s),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def _first_line(e: Exception) -> str:
    return f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}" \
        if str(e).strip() else type(e).__name__


def probe_collectives(rank: int, world_size: int, device: str,
                      p2p: bool = True) -> dict:
    """Each collective of the parallel layer on `device` tensors: "ok",
    "wrong values" or the first line of the error it raised. p2p=False
    leaves out batch_isend_irecv: gloo fails it on CUDA tensors (a writev
    of a device pointer, "Bad address"), at times from a background thread
    that aborts the rank."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    n, r = world_size, rank
    out = {"backend": dist.get_backend(), "device": str(dev)}

    def attempt(name, fn, want):
        try:
            got = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[name] = "ok" if torch.equal(got.cpu(), want) \
                else "wrong values"
        except Exception as e:   # noqa: BLE001 - reported, not hidden
            out[name] = _first_line(e)

    def reduce(op):
        x = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(x, op=op)
        return x

    total = float(n * (n + 1) // 2)
    attempt("all_reduce_sum", lambda: reduce(dist.ReduceOp.SUM),
            torch.full((4,), total))
    attempt("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX),
            torch.full((4,), float(n)))

    def gather():
        y = torch.empty((n * 2,), device=dev)
        dist.all_gather_into_tensor(y, torch.full((2,), float(r), device=dev))
        return y

    attempt("all_gather_into_tensor", gather,
            torch.arange(n).float().repeat_interleave(2))

    def scatter():
        y = torch.empty((2,), device=dev)
        dist.reduce_scatter_tensor(
            y, torch.arange(n * 2, dtype=torch.float32, device=dev))
        return y

    attempt("reduce_scatter_tensor", scatter,
            torch.arange(n * 2, dtype=torch.float32)[2 * r:2 * r + 2] * n)

    def bcast():
        y = torch.full((4,), float(r), device=dev)
        dist.broadcast(y, src=n - 1)
        return y

    attempt("broadcast", bcast, torch.full((4,), float(n - 1)))

    def permute():
        send = torch.full((4,), float(r), device=dev)
        recv = torch.empty((4,), device=dev)
        ops = [dist.P2POp(dist.isend, send, (r + 1) % n),
               dist.P2POp(dist.irecv, recv, (r - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return recv

    if p2p:
        attempt("batch_isend_irecv", permute,
                torch.full((4,), float((r - 1) % n)))
    return out

#!/usr/bin/env python3
"""Time kernel 1 (uint4 x f16 and int2 x int8) and kernel 9 (dense nt
GEMM) of an earlier checkout of bitblas_tpu_torch against this one, on one
NVIDIA GPU, in turns (earlier, this, this, earlier) within one process.

    python3 scripts/torch_ab_kernels.py --parent DIR [--only-parent]
                [--kernels all|tiled|i2decode|flash_decode|flash_prefill]

DIR holds an earlier tree's `bitblas_tpu_torch` package (for example
`git archive <commit> bitblas_tpu_torch | tar -x -C DIR`, DIR a
git-ignored directory). It is imported beside this tree's package under
the name `ab_parent`, builds its own kernels into DIR/build, and each
tree runs its own wrappers on its own untuned routes: kernel 1 on the
default tile of each M (`default_tile(fmt, M)`), kernel 9 on the tile of
its dense hint (`tuner.default_hint`). Rows:

* `dequant_matmul_u4` at M = 1 / 4 / 16 (the decode instance) on
  Llama-2-7B's three W4A16 shapes;
* `dequant_matmul_i2` at M = 1 / 4 / 16 (the default tile: the decode
  instance) on BitNet's four W2A8 shapes at Llama-3-8B widths (N x K =
  14336 x 4096, 4096 x 14336, 4096 x 4096, 1024 x 4096), with each
  tree's 32-token x 64-row wgmma tile timed on the same operands beside
  it (`tile_32x64_ms`), the bound, `stream_ms` and `library_ms`
  (torch.matmul on float32 copies of A and the pre-decoded weight:
  exact, |sum| < 2^24);
* `dequant_matmul_u4_tiled` and `dequant_matmul_i2_tiled`: kernel 1's
  tiled instances at M = 32 / 64 / 128 / 256 / 512 on the models' MLP
  shapes (uint4 11008 x 4096 and 4096 x 11008, int2 14336 x 4096 and
  4096 x 14336): the default tile in turns, every tiled instance of each
  tree (each tree's FUSED_TILES past its decode instance) timed once, and
  beside them the bound (the larger of the bytes over 3.35 TB/s and
  2 M N K over 989 TFLOP/s f16 or 1979 TOP/s int8), `stream_ms` (one
  PyTorch sum over an f16 buffer of the row's bytes) and `library_ms`
  (torch.matmul on the pre-decoded f16 weight, torch._int_mm on the
  pre-decoded int8 weight);
* `dense_matmul` (kernel 9) at M = 16 / 256 / 4096, N = K = 4096;
* `flash_attention_fwd` (kernel 4, windowless, causal, D = 128, each
  tree's default tile; `--kernels flash_prefill` alone): float16 and
  bfloat16 at B = 1, H = 32, Hkv = 32 and 8, S = 512 and 2048
  (chip_smoke.py's prefill rows, Llama-2-7B's and Mistral-7B-v0.1's
  heads), each tree's output against this tree's plain version;
* `flash_decode` / `flash_decode_quant` (kernels 5 and 6, windowless,
  float16 queries; `--kernels flash_decode` alone): the slot cache (bf16
  or int8 + f32 scales) at B = 4, H = 32, Hkv = 32 and 8, D = 128, Smax
  = 1024, lengths 1 / 37 / 513 / 1024 (chip_smoke.py's decode rows), each
  tree's output against this tree's plain version.

`--kernels tiled` keeps only the tiled rows, `--kernels i2decode` only
the int2 decode rows, `--kernels flash_decode` only the decode attention
rows, `--kernels flash_prefill` only kernel 4's; `--only-parent` times the
earlier tree alone (this tree's kernels are neither built nor run). Each
time is this tree's `utils.timing.measure_kernel` (median of 20
CUDA-event launches, L2 flushed by a read before each). A one-element
fill is timed the same way: the floor of any timed launch. One JSON line
per row; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def import_tree(name: str, package_dir: str):
    """Import the package at `package_dir` under `name` (its modules import
    one another relatively, so they resolve inside it)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(package_dir, "__init__.py"),
        submodule_search_locations=[package_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory holding an earlier bitblas_tpu_torch")
    ap.add_argument("--only-parent", action="store_true",
                    help="time the earlier tree alone")
    ap.add_argument("--kernels", choices=("all", "tiled", "i2decode",
                                          "flash_decode", "flash_prefill"),
                    default="all")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bitblas_tpu_torch
    from bitblas_tpu_torch.utils.timing import measure_kernel
    import_tree("ab_parent", os.path.join(os.path.abspath(args.parent),
                                          "bitblas_tpu_torch"))
    trees = {}
    for key, pkg in (("earlier", "ab_parent"),
                     ("this", bitblas_tpu_torch.__name__))[
                         :1 if args.only_parent else 2]:
        trees[key] = {mod: importlib.import_module(f"{pkg}.{path}")
                      for mod, path in (("build", "kernels.build"),
                                        ("dq", "kernels.dequant_matmul"),
                                        ("dense", "kernels.dense"),
                                        ("flash", "kernels.flash"),
                                        ("spec", "kernels.spec"),
                                        ("tuner", "tuner"))}

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def ms(fn):
        return measure_kernel(fn, (), iters=20) * 1e3

    def turns(fns):
        if "this" not in fns:
            return [ms(fns["earlier"]), ms(fns["earlier"])]
        return [ms(fns["earlier"]), ms(fns["this"]), ms(fns["this"]),
                ms(fns["earlier"])]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": smi})
    for t in trees.values():
        t["build"].build(["flash_decode", "flash_decode_quant"]
                         if args.kernels == "flash_decode" else
                         ["flash_attention"]
                         if args.kernels == "flash_prefill" else
                         ["dequant_matmul", "dequant_matmul_i2",
                          "dense_matmul"])
    warm = torch.randn((8192, 8192), device="cuda").half()
    ms(lambda: warm @ warm)
    del warm
    one = torch.zeros(1, device="cuda")
    emit({"row": "timer_floor", "one_element_fill_ms": ms(one.zero_)})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    plain = next(iter(trees.values()))["dq"]
    if args.kernels == "flash_decode":
        flash_decode_rows(torch, trees, gen, turns, emit)
        return 0
    if args.kernels == "flash_prefill":
        flash_prefill_rows(torch, trees, gen, turns, emit)
        return 0
    if args.kernels in ("all", "i2decode"):
        i2_decode_rows(torch, trees, plain, gen, ms, turns, emit)
    if args.kernels in ("all", "tiled"):
        tiled_rows(torch, trees, plain, gen, ms, turns, emit)
    if args.kernels != "all":
        return 0
    for N, K in ((4096, 4096), (11008, 4096), (4096, 11008)):
        G = K // 128
        qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
              + 0.005).half()
        zr = torch.randint(0, 16, (G, N), generator=gen,
                           device="cuda").half()
        for M in (1, 4, 16):
            A = torch.randn((M, K), generator=gen, device="cuda").half()
            ref = plain.dequant_matmul_u4_plain(A, qw, sc, zr)
            fns, row = {}, {"row": "dequant_matmul_u4", "M": M, "N": N,
                            "K": K}
            for key, t in trees.items():
                fns[key] = (lambda dq=t["dq"]: dq.dequant_matmul_u4(
                    A, qw, sc, zr))
                out = fns[key]()
                torch.cuda.synchronize()
                row[f"{key}_tile"] = list(t["dq"].default_tile("uint4", M))
                row[f"{key}_max_abs_err"] = (
                    out.float() - ref.float()).abs().max().item()
            emit({**row, "ms_earlier_this_this_earlier": turns(fns)})
    N = K = 4096
    for name in ("float16", "bfloat16", "int8"):
        dt = getattr(torch, name)
        out_dt = torch.int32 if name == "int8" else dt

        def draw(shape):
            if name == "int8":
                return torch.randint(-128, 128, shape, generator=gen,
                                     device="cuda",
                                     dtype=torch.int64).to(torch.int8)
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        W = draw((N, K))
        for M in (16, 256, 4096):
            A = draw((M, K))
            fns, row = {}, {"row": "dense_matmul", "dtype": name, "M": M,
                            "N": N, "K": K}
            for key, t in trees.items():
                spec = t["spec"].KernelSpec(
                    m=M, n=N, k=K, a_dtype=name,
                    out_dtype="int32" if name == "int8" else name,
                    family="int" if name == "int8" else "fp",
                    bits=8 * W.element_size(), native=True)
                tile = t["tuner"].default_hint(
                    spec, t["tuner"].H100_SXM).tile[:3]
                fns[key] = (lambda dense=t["dense"], tile=tile:
                            dense.dense_matmul(A, W, out_dt, tile))
                row[f"{key}_tile"] = list(tile)
            emit({**row, "ms_earlier_this_this_earlier": turns(fns)})
    return 0


HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK = {"uint4": 989e12, "int2": 1979e12}   # f16 / int8 tensor cores
TILED_SHAPES = {"uint4": ((11008, 4096), (4096, 11008)),
                "int2": ((14336, 4096), (4096, 14336))}
TILED_M = (32, 64, 128, 256, 512)


I2_DECODE_SHAPES = ((14336, 4096), (4096, 14336), (4096, 4096),
                    (1024, 4096))


def _bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def i2_decode_rows(torch, trees, plain, gen, ms, turns, emit):
    """Kernel 1's int2 x int8 decode rows (see the module docstring)."""
    for N, K in I2_DECODE_SHAPES:
        qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 16), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        Wf = plain.decode_i2_hopper(qw).float()
        for M in (1, 4, 16):
            A = torch.randint(-128, 128, (M, K), generator=gen,
                              device="cuda", dtype=torch.int64).to(
                                  torch.int8)
            Af = A.float()
            ref = plain.dequant_matmul_i2_plain(A, qw)
            nbytes = M * K + N * K / 4 + M * N * 4
            buf = torch.zeros(int(nbytes) // 2, dtype=torch.float16,
                              device="cuda")
            b_ms, b_by = _bound(nbytes, 2.0 * M * N * K, PEAK["int2"])
            row = {"row": "dequant_matmul_i2", "M": M, "N": N, "K": K,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "stream_ms": ms(lambda: buf.sum()),
                   "library_ms": ms(lambda: torch.matmul(Af, Wf.T))}
            fns = {}
            for key, t in trees.items():
                dq = t["dq"]
                fns[key] = (lambda dq=dq: dq.dequant_matmul_i2(A, qw))
                out = fns[key]()
                torch.cuda.synchronize()
                row[f"{key}_tile"] = list(dq.default_tile("int2", M))
                row[f"{key}_max_abs_err"] = (out - ref).abs().max().item()
                row[f"{key}_tile_32x64_ms"] = ms(
                    lambda dq=dq: dq.dequant_matmul_i2(
                        A, qw, tile=dq.FUSED_TILES["int2"][1]))
            row["ms_earlier_this_this_earlier"] = turns(fns)
            emit(row)
            del buf
        del qw, Wf


def tiled_rows(torch, trees, plain, gen, ms, turns, emit):
    """Kernel 1's tiled instances, uint4 x f16 and int2 x int8 (see the
    module docstring)."""
    for fmt, shapes in TILED_SHAPES.items():
        for N, K in shapes:
            if fmt == "uint4":
                G = K // 128
                qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8),
                                   generator=gen, device="cuda",
                                   dtype=torch.int64).to(torch.int32)
                sc = (torch.rand((G, N), generator=gen, device="cuda")
                      * 0.01 + 0.005).half()
                zr = torch.randint(0, 16, (G, N), generator=gen,
                                   device="cuda").half()
                Wd = plain.dequantize_hopper(qw, sc, zr)
                wbytes = N * K / 2 + 2 * G * N * 2
            else:
                qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 16),
                                   generator=gen, device="cuda",
                                   dtype=torch.int64).to(torch.int32)
                Wd = plain.decode_i2_hopper(qw)
                wbytes = N * K / 4
            for M in TILED_M:
                if fmt == "uint4":
                    A = torch.randn((M, K), generator=gen,
                                    device="cuda").half()
                    ref = plain.dequant_matmul_u4_plain(A, qw, sc, zr)
                    nbytes = M * K * 2 + wbytes + M * N * 2

                    def call(dq, tile, A=A):
                        return dq.dequant_matmul_u4(A, qw, sc, zr, tile=tile)

                    def library(A=A):
                        return torch.matmul(A, Wd.T)
                else:
                    A = torch.randint(-128, 128, (M, K), generator=gen,
                                      device="cuda",
                                      dtype=torch.int64).to(torch.int8)
                    ref = plain.dequant_matmul_i2_plain(A, qw)
                    nbytes = M * K + wbytes + M * N * 4

                    def call(dq, tile, A=A):
                        return dq.dequant_matmul_i2(A, qw, tile=tile)

                    def library(A=A):
                        return torch._int_mm(A, Wd.T)
                buf = torch.zeros(int(nbytes) // 2, dtype=torch.float16,
                                  device="cuda")
                name = ("dequant_matmul_u4_tiled" if fmt == "uint4"
                        else "dequant_matmul_i2_tiled")
                b_ms, b_by = _bound(nbytes, 2.0 * M * N * K, PEAK[fmt])
                row = {"row": name, "M": M, "N": N, "K": K,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "stream_ms": ms(lambda: buf.sum()),
                       "library_ms": ms(library)}
                fns = {}
                for key, t in trees.items():
                    dq = t["dq"]
                    tile = dq.default_tile(fmt, M)
                    fns[key] = (lambda dq=dq, tile=tile: call(dq, tile))
                    out = fns[key]()
                    torch.cuda.synchronize()
                    row[f"{key}_tile"] = list(tile)
                    row[f"{key}_max_abs_err"] = (
                        out.float() - ref.float()).abs().max().item()
                    row[f"{key}_tiles_ms"] = {
                        "x".join(map(str, tl)): ms(
                            lambda dq=dq, tl=tl: call(dq, tl))
                        for tl in dq.FUSED_TILES[fmt][1:]}
                row["ms_earlier_this_this_earlier"] = turns(fns)
                emit(row)
                del buf
            del qw, Wd



def flash_prefill_rows(torch, trees, gen, turns, emit):
    """Kernel 4 without a window (see the module docstring)."""
    this = trees.get("this", trees["earlier"])["flash"]
    B, H, D = 1, 32, 128
    for dtype in (torch.float16, torch.bfloat16):
        for S in (512, 2048):
            for Hkv in (32, 8):
                Q = torch.randn((B, S, H, D), generator=gen,
                                device="cuda").to(dtype)
                K, V = (torch.randn((B, S, Hkv, D), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                ref = this.flash_attention_plain(Q, K, V)
                fns, row = {}, {"row": "flash_attention_fwd",
                                "dtype": str(dtype).split(".")[-1], "B": B,
                                "H": H, "Hkv": Hkv, "S": S, "D": D}
                for key, t in trees.items():
                    fns[key] = (lambda fn=t["flash"].flash_attention_fwd:
                                fn(Q, K, V))
                    out = fns[key]()
                    torch.cuda.synchronize()
                    row[f"{key}_max_abs_err"] = (
                        out.float() - ref.float()).abs().max().item()
                emit({**row, "ms_earlier_this_this_earlier": turns(fns)})
                del Q, K, V, ref


DECODE_LENGTHS = (1, 37, 513, 1024)


def flash_decode_rows(torch, trees, gen, turns, emit):
    """Kernels 5 and 6 without a window (see the module docstring)."""
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    this = trees.get("this", trees["earlier"])["flash"]
    B, H, D, Smax = 4, 32, 128, 1024
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    for quant in (False, True):
        for Hkv in (32, 8):
            q = torch.randn((B, H, D), generator=gen, device="cuda").half()
            kf, vf = (torch.randn((6, Smax, Hkv, D), generator=gen,
                                  device="cuda") for _ in range(2))
            if quant:
                (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
                caches = (kc, vc, ks, vs)
                name = "flash_decode_quant"
            else:
                caches = (kf.to(torch.bfloat16), vf.to(torch.bfloat16))
                name = "flash_decode"
            args = (q, *caches, lengths, slots)
            ref = getattr(this, name + "_plain")(*args)
            fns, row = {}, {"row": name, "B": B, "H": H, "Hkv": Hkv,
                            "D": D, "Smax": Smax,
                            "lengths": list(DECODE_LENGTHS)}
            for key, t in trees.items():
                fns[key] = (lambda fn=getattr(t["flash"], name): fn(*args))
                out = fns[key]()
                torch.cuda.synchronize()
                row[f"{key}_max_abs_err"] = (
                    out.float() - ref.float()).abs().max().item()
            emit({**row, "ms_earlier_this_this_earlier": turns(fns)})
            del kf, vf, caches


if __name__ == "__main__":
    sys.exit(main())

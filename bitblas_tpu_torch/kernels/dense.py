"""Dense (native-compute) matmul paths (counterpart of
bitblas_tpu/kernels/dense.py).

* `make_dense_matmul` -- the counterpart of JAX's XLA dot: every reference
  layout, float32 accumulation for float operands and int32 for int8. On
  the card it is cuBLAS, through `torch.matmul` (float16 / bfloat16 /
  float32) or `torch._int_mm` (int8): JAX computes this product outside
  Pallas, so it stays a library call. cuBLAS may reduce split-K partial
  sums of a float16 product in float16
  (`torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction`,
  left as the process has it), so the route is held to a tolerance against
  JAX's float32-accumulated dot; a "highest" hint runs a float32 product
  with TF32 off, restoring the process's setting after the call. On the
  CPU it runs `ops/reference.matmul_dense_reference` (float32 sums, exact
  integer sums).
* `make_dense_matmul_pallas` -- TPU kernel 9's counterpart: the tiled "nt"
  GEMM of csrc/dense_matmul.cu with the hint's tile, N % block_n == 0 and
  K % block_k == 0 required, M padded up to block_m (rows past M are
  masked, which gives the same rows). float16, bfloat16 and int8 run on
  wgmma + TMA (4-stage ring), a hint of the 16-row tile on the 64 x 128
  tile; float32 on FFMA at every tile. As in JAX, no part of the program calls it; the
  tuner's tests and chip_smoke.py do.
* `dense_matmul` / `dense_matmul_plain` -- kernel 9's wrapper (a launch
  counter, the kernel on a CUDA tensor, the plain version on a CPU one)
  and its plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import TYPE_CHECKING

import torch

from ..ops.reference import matmul_dense_reference
from ..quantization import numerics
from ..quantization.formats import as_torch_dtype
from . import build
from .spec import KernelSpec

if TYPE_CHECKING:   # the tuner imports this module
    from ..tuner.hint import TileHint

# Compiled tiles of csrc/dense_matmul.cu (block_m, block_n, block_k): the
# 16-row tile (float32's FFMA kernel; the other types run a hint that
# names it on the 64 x 128 wgmma tile, which measured faster at M = 16,
# PERF.md), then the wgmma + TMA tiles with their ring depth.
DENSE_TILES = ((16, 128, 128), (64, 128, 64), (128, 128, 64),
               (128, 256, 64))
WGMMA_STAGES = {(64, 128, 64): 4, (128, 128, 64): 4, (128, 256, 64): 4}
_A_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
           torch.int8: 3}
_OUT_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
             torch.int32: 3}
# Output types the kernel writes, by operand type.
OUT_DTYPES = {torch.float16: (torch.float16, torch.bfloat16, torch.float32),
              torch.bfloat16: (torch.float16, torch.bfloat16, torch.float32),
              torch.float32: (torch.float16, torch.bfloat16, torch.float32),
              torch.int8: (torch.int32, torch.float32)}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# torch._int_mm takes M > 16 rows; smaller M is padded with zero rows
_INT_MM_MIN_M = 17


def launched_tile(a_dtype: torch.dtype, tile):
    """The compiled tile that runs a hint's `tile`: the 16-row tile is
    float32's; f16, bf16 and int8 run it as the 64 x 128 wgmma tile."""
    tile = tuple(tile[:3])
    if tile == DENSE_TILES[0] and a_dtype != torch.float32:
        return DENSE_TILES[1]
    return tile


def dense_smem_bytes(a_dtype: torch.dtype, tile) -> int:
    """Shared memory one block of csrc/dense_matmul.cu takes for the tile
    that runs `tile`: for a wgmma tile (f16, bf16, int8) its WgTile, 1 KB
    of alignment, the ring of (BM + BN) rows of 128 bytes a stage and two
    barriers a stage; for float32 its F32Tile, two stages of (BM + BN)
    rows of BK floats plus 16 bytes of padding a row."""
    bm, bn, bk = launched_tile(a_dtype, tile)
    stages = WGMMA_STAGES.get((bm, bn, bk))
    if stages and a_dtype != torch.float32:
        return 1024 + stages * (bm + bn) * 128 + 16 * stages
    return 2 * (bm + bn) * (bk * a_dtype.itemsize + 16)


def dense_matmul_plain(A: torch.Tensor, W: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel 9 (any device): A [M, K] . W[N, K]^T
    with float32 sums for float operands (TF32 off), exact integer sums
    for int8 (float32 while provably exact, else float64), then the
    cast."""
    if A.dtype == torch.float32:
        with full_f32():
            return matmul_dense_reference(A, W, out_dtype)
    return matmul_dense_reference(A, W, out_dtype)


def _check_kernel_args(A, W, out_dtype, tile):
    if A.dim() != 2 or W.dim() != 2 or A.shape[1] != W.shape[1]:
        raise ValueError(f"A must be [M, K] and W [N, K], got "
                         f"{tuple(A.shape)} and {tuple(W.shape)}")
    if A.dtype not in _A_CODE or W.dtype != A.dtype:
        raise ValueError(f"operands {A.dtype} / {W.dtype}: one of "
                         f"{list(_A_CODE)} for both")
    if out_dtype not in OUT_DTYPES[A.dtype]:
        raise ValueError(f"out_dtype {out_dtype} for {A.dtype} operands "
                         f"(one of {OUT_DTYPES[A.dtype]})")
    if tuple(tile) not in DENSE_TILES:
        raise ValueError(f"tile {tuple(tile)} is not compiled "
                         f"({DENSE_TILES})")
    N, K = W.shape
    if N % tile[1] or K % tile[2]:
        raise ValueError(f"N={N} K={K} not divisible by tile "
                         f"({tile[1]},{tile[2]})")
    for name, t in (("A", A), ("W", W)):
        if t.device != A.device:
            raise ValueError(f"{name} on {t.device}, A on {A.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def dense_matmul(A: torch.Tensor, W: torch.Tensor, out_dtype: torch.dtype,
                 tile=DENSE_TILES[0]) -> torch.Tensor:
    """out [M, N] in `out_dtype` = A [M, K] . W [N, K]^T through kernel 9
    with `tile` (block_m, block_n, block_k)."""
    _check_kernel_args(A, W, out_dtype, tile)
    if A.device.type == "cpu":
        return dense_matmul_plain(A, W, out_dtype)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    M, N = A.shape[0], W.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=A.device)
    if M == 0:
        return out
    with torch.cuda.device(A.device):
        fn = build.entry("dense_matmul", "dense_matmul", _ARGTYPES)
        err = fn(A.data_ptr(), W.data_ptr(), out.data_ptr(), M, N,
                 A.shape[1], _A_CODE[A.dtype], _OUT_CODE[out_dtype],
                 *launched_tile(A.dtype, tile),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "dense_matmul")
    dense_matmul.launches += 1
    return out


dense_matmul.launches = 0


def make_dense_matmul_pallas(spec: KernelSpec, hint: TileHint):
    """Kernel 9 with the hint's tile (nt layout): fn(A [M, K], W [N, K],
    bias=None) -> [M, N] in spec.out_dtype; raises unless N % block_n ==
    0 and K % block_k == 0, as JAX does."""
    tile = (hint.block_m, hint.block_n, hint.block_k)
    if hint.block_n <= 0 or hint.block_k <= 0 \
            or spec.n % hint.block_n or spec.k % hint.block_k:
        raise ValueError(f"N={spec.n} K={spec.k} not divisible by tile "
                         f"({hint.block_n},{hint.block_k})")
    out_dtype = as_torch_dtype(spec.out_dtype)

    def fn(A, W, scales=None, zeros=None, bias=None):
        del scales, zeros
        out = dense_matmul(A, W, out_dtype, tile)
        if spec.with_bias and bias is not None:
            out = out + bias.to(out.dtype)
        return out

    return fn


@contextlib.contextmanager
def full_f32():
    """cuBLAS float32 products and cuDNN float32 convolutions without TF32
    for the block, whatever the process set; the settings are restored
    after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def dense_product(A: torch.Tensor, W_nk: torch.Tensor,
                  out_dtype: torch.dtype,
                  precision: str = "default") -> torch.Tensor:
    """A [M, K] . W_nk^T (W_nk [N, K], any strides) cast to out_dtype: the
    library product of the dense route and of the materialize plan."""
    if A.device.type == "cpu":
        return matmul_dense_reference(A, W_nk, out_dtype)
    if A.dtype == torch.int8:
        M = A.shape[0]
        if M < _INT_MM_MIN_M:   # exact: the zero rows are sliced off
            A = torch.nn.functional.pad(A, (0, 0, 0, _INT_MM_MIN_M - M))
        out = torch._int_mm(A, W_nk.T)[:M]
        return numerics.saturate_cast(out, out_dtype)
    if A.dtype == torch.float32 and precision == "highest":
        with full_f32():
            out = torch.matmul(A, W_nk.T)
    else:
        out = torch.matmul(A, W_nk.T)
    return out.to(out_dtype)


def make_dense_matmul(spec: KernelSpec, hint: TileHint, *,
                      layout: str = "nt"):
    """The dense product over every reference layout (JAX
    make_dense_matmul): A is [M, K] for ``n*`` layouts, [K, M] for ``t*``;
    W is [N, K] for ``*t``, [K, N] for ``*n``. Returns fn(A, W,
    scales=None, zeros=None, bias=None) -> [M, N] in spec.out_dtype, bias
    (when the spec has one) added in the output type after the cast."""
    if layout not in ("nn", "nt", "tn", "tt"):
        raise ValueError(f"unknown layout {layout!r}")
    out_dtype = as_torch_dtype(spec.out_dtype)

    def fn(A, W, scales=None, zeros=None, bias=None):
        del scales, zeros
        A2 = A if layout[0] == "n" else A.T
        W_nk = W if layout[1] == "t" else W.T
        out = dense_product(A2, W_nk, out_dtype, hint.precision)
        if spec.with_bias and bias is not None:
            out = out + bias.to(out.dtype)
        return out

    return fn

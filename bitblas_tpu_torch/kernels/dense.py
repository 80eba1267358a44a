"""Dense (native-compute) matmul paths (counterpart of
bitblas_tpu/kernels/dense.py).

* `make_dense_matmul` -- the counterpart of JAX's XLA dot, for every
  native pair (`native_product`): every reference layout, float32
  accumulation for float operands (float64 for float64), int32 for
  integer ones, then JAX's astype to out_dtype and the bias in that type.
  On the card float16 / bfloat16 into their own type and float32 are
  cuBLAS (`torch.matmul`), int8 `torch._int_mm`, uint8 `torch._int_mm`
  on the operands shifted to int8 (`uint8_mm`), float64 DGEMM: JAX
  computes this product outside Pallas, so a library call may stay;
  float16 / bfloat16 into another type and the fp8 pairs take kernel 9's
  float32 accumulators (`f16_sums`, fp8 upcast exactly to float16,
  `fp8_sums`). cuBLAS may reduce split-K partial
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
  tile; float32 on FFMA at every tile. As in JAX, `make_dense_matmul_pallas`
  has no caller in the program (the tuner's tests and chip_smoke.py call
  it); the dense route calls kernel 9 through `f16_sums`.
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
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)
_NAME = {torch.float16: "float16", torch.bfloat16: "bfloat16",
         torch.float32: "float32", torch.float64: "float64"}


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
    key = f"{_NAME.get(A.dtype, 'int8')}->{_NAME.get(out_dtype, 'int32')}"
    counts = dense_matmul.variant_launches
    counts[key] = counts.get(key, 0) + 1
    return out


dense_matmul.launches = 0
# launches by operand and output type ("float16->float32", ...)
dense_matmul.variant_launches = {}


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


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t [r, c] with zero rows and columns up to [rows, cols] (float8
    through its bytes: +0 is the zero byte)."""
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t.contiguous()
    if t.dtype in _FLOAT8:
        return _pad2(t.view(torch.uint8), rows, cols).view(t.dtype)
    return torch.nn.functional.pad(t, (0, cols - c, 0, rows - r))


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(A: torch.Tensor, W_nk: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of int8 A [M, K] . W_nk^T through
    `torch._int_mm`, its operands padded with zeros to what it takes (M
    past 16, K and N multiples of 8) and the result sliced back."""
    M, K = A.shape
    N = W_nk.shape[0]
    Mp, Kp, Np = max(M, _INT_MM_MIN_M), _up(K, 8), _up(N, 8)
    out = torch._int_mm(_pad2(A, Mp, Kp), _pad2(W_nk, Np, Kp).T)
    return out[:M, :N]


def uint8_mm(A: torch.Tensor, W_nk: torch.Tensor) -> torch.Tensor:
    """The exact (wrapping) int32 sums of uint8 A . W_nk^T over int8
    operands a = A - 128, w = W - 128: sum A W = sum a w + 128 sum a +
    128 sum w + 128^2 K (`int_mm` for the first term)."""
    a = (A.to(torch.int16) - 128).to(torch.int8)
    w = (W_nk.to(torch.int16) - 128).to(torch.int8)
    K = A.shape[1]
    return (int_mm(a, w) + 128 * a.sum(1, keepdim=True, dtype=torch.int32)
            + 128 * w.sum(1, dtype=torch.int32)[None] + 128 * 128 * K)


def f16_sums(A: torch.Tensor, W_nk: torch.Tensor) -> torch.Tensor:
    """The float32 sums of float16 or bfloat16 A . W_nk^T through kernel
    9 (its 64 x 128 tile writes float32 from wgmma's float32
    accumulators), N and K padded with zeros to its tile."""
    M, K = A.shape
    N = W_nk.shape[0]
    tile = DENSE_TILES[1]
    Kp, Np = _up(K, tile[2]), _up(N, tile[1])
    out = dense_matmul(_pad2(A, M, Kp), _pad2(W_nk, Np, Kp), torch.float32,
                       tile)
    return out[:, :N]


def fp8_sums(A: torch.Tensor, W_nk: torch.Tensor) -> torch.Tensor:
    """The float32 sums of float8 A . W_nk^T (either type on either side):
    both upcast exactly to float16 (every e4m3 and e5m2 value is one),
    then kernel 9 (`f16_sums`). `torch._scaled_mm` (`scaled_mm_sums`) is
    not used here: even with `use_fast_accum=False` its sums strayed ~1e-4
    of the output from float32 sums of the same products on an H100
    (tests/test_torch_cuda_general.py), where JAX's dot sums in
    float32."""
    return f16_sums(A.to(torch.float16), W_nk.to(torch.float16))


def scaled_mm_sums(A: torch.Tensor, W_nk: torch.Tensor) -> torch.Tensor:
    """cuBLASLt's float8 product of the same operands (`torch._scaled_mm`,
    unit scales, `use_fast_accum=False`, operands padded to multiples of
    16, W column-major; e5m2 x e5m2 it refuses): the library row of the
    fp8 pairs, timed beside `fp8_sums`, used nowhere in the port."""
    M, K = A.shape
    N = W_nk.shape[0]
    one = torch.ones((), dtype=torch.float32, device=A.device)
    out = torch._scaled_mm(_pad2(A, _up(M, 16), _up(K, 16)),
                           _pad2(W_nk, _up(N, 16), _up(K, 16)).T,
                           scale_a=one, scale_b=one,
                           out_dtype=torch.float32, use_fast_accum=False)
    if isinstance(out, tuple):   # older PyTorch: (out, amax)
        out = out[0]
    return out[:M, :N]


def native_product(A: torch.Tensor, W_nk: torch.Tensor, out_name: str,
                   precision: str = "default") -> torch.Tensor:
    """The dense route's product of a native pair, as JAX's Matmul computes
    it (an XLA dot, then astype): A [M, K] . W_nk^T (any strides) summed in
    int32 (int8, int4 / uint4 in int8, uint8), float32 or float64, then
    converted to `out_name` (numerics.convert: float sums truncate and
    saturate into an integer type, integer sums wrap); float16 and
    bfloat16 operands with an output of their own type take cuBLAS's
    product in that type."""
    name = _NAME.get(A.dtype)
    if A.device.type == "cpu":
        if not (A.is_floating_point() or W_nk.is_floating_point()):
            return numerics.convert(matmul_dense_reference(
                A.to(torch.int32), W_nk.to(torch.int32), torch.int32),
                out_name)
        wide = torch.float64 if A.dtype == torch.float64 else torch.float32
        with full_f32():
            out = torch.matmul(numerics.to_float(A).to(wide),
                               numerics.to_float(W_nk).to(wide).T)
        return numerics.convert(out, out_name)
    if A.dtype in (torch.float16, torch.bfloat16):
        if out_name == name:
            return torch.matmul(A, W_nk.T)
        sums = f16_sums(A, W_nk)
    elif A.dtype == torch.int8:
        sums = int_mm(A, W_nk)
    elif A.dtype == torch.uint8:
        sums = uint8_mm(A, W_nk)
    elif A.dtype in _FLOAT8:
        sums = fp8_sums(A, W_nk)
    elif A.dtype == torch.float32 and precision == "highest":
        with full_f32():
            sums = torch.matmul(A, W_nk.T)
    elif not A.is_floating_point():   # int16 / int32 / int64 storage
        sums = torch.matmul(A.double(), W_nk.double().T)
    else:   # float32, float64 (cuBLAS SGEMM / DGEMM)
        sums = torch.matmul(A, W_nk.T)
    return numerics.convert(sums, out_name)


def add_bias(out: torch.Tensor, bias: torch.Tensor,
             out_name: str) -> torch.Tensor:
    """out + bias in the output type, as JAX's dense Matmul adds it after
    the cast (bias.astype(out.dtype), then one add in that type: rounded
    for a float type, wrapping for an integer one)."""
    if out.dtype in (torch.float16, torch.bfloat16, torch.float32,
                     torch.float64):
        return out + bias.reshape(1, -1).to(out.dtype)
    b = numerics.convert(bias.reshape(1, -1), out_name)
    wide = torch.float64 if out.is_floating_point() else torch.int64
    return numerics.convert(numerics.to_float(out).to(wide)
                            + numerics.to_float(b).to(wide), out_name)


def dense_product(A: torch.Tensor, W_nk: torch.Tensor,
                  out_dtype: torch.dtype,
                  precision: str = "default") -> torch.Tensor:
    """A [M, K] . W_nk^T (W_nk [N, K], any strides) cast to out_dtype: the
    library product of the materialize plan."""
    if A.device.type == "cpu":
        return matmul_dense_reference(A, W_nk, out_dtype)
    if A.dtype == torch.int8:
        return numerics.saturate_cast(int_mm(A, W_nk), out_dtype)
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

    def fn(A, W, scales=None, zeros=None, bias=None):
        del scales, zeros
        A2 = A if layout[0] == "n" else A.T
        W_nk = W if layout[1] == "t" else W.T
        out = native_product(A2, W_nk, spec.out_dtype, hint.precision)
        if spec.with_bias and bias is not None:
            out = add_bias(out, bias, spec.out_dtype)
        return out

    return fn

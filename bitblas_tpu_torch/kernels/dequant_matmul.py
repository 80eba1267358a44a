"""The fused dequantize-into-matmul kernels (counterpart of
bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul), one per
ported configuration, with the Hopper layout of quantization/packing.py:

* `dequant_matmul_u4` (GPTQ W4A16): ``out[M, N] f16 = A[M, K] f16 @
  dequant(Wq)^T``, Wq [N, K/8] int32, scales and zeros [K/g, N] float16,
  g = 128; csrc/dequant_matmul.cu. Its plain version decodes the same
  layout and contracts with float32 accumulation (ops/reference.py).
* `dequant_matmul_i2` (BitNet W2A8): ``out[M, N] f32 = A[M, K] int8 @
  (Wq - 2)^T`` with int32 accumulation, Wq [N, K/16] int32 of biased int2
  fields; csrc/dequant_matmul_i2.cu.
* Both tiled paths: csrc/dequant_wgmma.cuh.

Each kernel is compiled for a small fixed set of tile instances
(`FUSED_TILES`, (block_m, block_n, block_k, stages)); the caller names one
(`tile=`, from the Matmul's hint), and `default_tile` is the choice by M
that the Matmul makes untuned. The first instance of each format is its
decode-M design, split-K with the weight decoded in registers: 128
weight rows a block on the mma's 16-row side, the tokens on its 8-wide
side, K split across blocks from static sizes only, the partials summed
in split order by the last block of each tile, one launch a call:
* uint4 `U4_DECODE_TILE`: K split in whole 128-groups (`plan_splits_k`),
  f32 partials (`dequant_matmul_u4_split_plain` is that arithmetic in
  plain PyTorch, for the tests);
* int2 `I2_DECODE_TILE`: K split in steps of 256 (`plan_splits_k_i2`;
  the last step may end at a K tail of 64, 128 or 192), the biased codes
  fed to the mma as they are and the bias taken off once a split (sum (f
  - 2) a = sum f a - 2 sum a), int32 partials
  (`dequant_matmul_i2_split_plain`). Bound at M <= 16: the weight bytes
  N K / 4 over 3.35 TB/s.
The others are the tiled instances (block_m tokens x block_n weight
rows, three uint4 and four int2), one mixed-input wgmma + TMA main loop
shared by both formats (csrc/dequant_wgmma.cuh): the weight decoded in
registers straight into wgmma's A operand, the tokens on its n side.
Each wrapper counts its launches (`launches`), and apart from them those
of its decode instance (`decode_launches`) and of its tiled instances
(`tiled_launches`). On a CUDA tensor each wrapper launches its kernel
(design and bound are written in the source); on a CPU tensor it runs
the plain version, for which the tile changes nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.reference import expand_groups, matmul_dense_reference
from ..quantization import numerics, packing
from . import build, scratch

GROUP = 128
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ARGTYPES_DECODE = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_ARGTYPES_I2 = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ARGTYPES_I2_DECODE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
# The compiled instances of csrc/dequant_matmul.cu ("uint4") and
# csrc/dequant_matmul_i2.cu ("int2"), (block_m, block_n, block_k, stages):
# each format's decode instance, then its tiled instances on the wgmma +
# TMA loop of csrc/dequant_wgmma.cuh: block_m tokens (wgmma's n), block_n
# weight rows (a warpgroup each 64), block_k the K of one ring slot (four
# 128-byte rows of A: 256 f16 or 512 int8), `stages` slots.
U4_DECODE_TILE = (16, 128, 128, 4)   # split-K, register decode
I2_DECODE_TILE = (16, 128, 256, 4)   # split-K, register decode
WGMMA_BK = {"uint4": 256, "int2": 512}
# (block_m, block_n, stages); uint4 sums each slot apart (more registers):
# its 64 x 128 tile runs one block an SM, and it has no 128 x 128 tile
WGMMA_TILES = {"uint4": ((32, 64, 4), (64, 128, 4), (128, 64, 3)),
               "int2": ((32, 64, 4), (64, 128, 2), (128, 64, 3),
                        (128, 128, 2))}
FUSED_TILES = {
    fmt: (decode,) + tuple((bm, bn, WGMMA_BK[fmt], stages)
                           for bm, bn, stages in WGMMA_TILES[fmt])
    for fmt, decode in (("uint4", U4_DECODE_TILE),
                        ("int2", I2_DECODE_TILE))}
# Integer sums stay exact in float32 while |acc| <= K * 128 * 2 <= 2^24.
I2_MAX_K = 1 << 16
# The decode instances: 128 weight rows a block, A tiles of 16 rows, at
# most 8 groups (uint4) or 8 steps of 256 (int2) a split (its K range of A
# sits in shared memory), and the planner's target of blocks an SM.
DECODE_BN = 128
DECODE_BM = 16
DECODE_MAX_CHUNK = 8
I2_DECODE_STEP = 256
I2_DECODE_MAX_CHUNK = 8
SPLITK_BLOCKS_PER_SM = 2
H100_SMS = 132


def default_tile(fmt: str, m: int):
    """The untuned instance at M = m: the decode instance up to 16 rows,
    where the weight bytes bound the kernel, the 64-token x 128-row wgmma
    tile above."""
    return FUSED_TILES[fmt][0] if m <= 16 else FUSED_TILES[fmt][2]


def is_tiled(fmt: str, tile) -> bool:
    """Whether `tile` is one of the format's wgmma + TMA instances."""
    return tuple(tile) in FUSED_TILES[fmt][1:]


def _plan_splits(m: int, n: int, steps: int, max_chunk: int, sms: int):
    """(chunk, splits): `steps` cut into `splits` runs of `chunk` (the last
    may be shorter, none is empty), enough that the (N tiles x M tiles x
    splits) blocks come within a factor 2 of SPLITK_BLOCKS_PER_SM on every
    SM where there are the steps, and at most `max_chunk` steps a split."""
    tiles = -(-n // DECODE_BN) * -(-m // DECODE_BM)
    want = -(-SPLITK_BLOCKS_PER_SM * sms // tiles)
    splits = min(steps, max(want, -(-steps // max_chunk)))
    chunk = -(-steps // splits)
    return chunk, -(-steps // chunk)


def plan_splits_k(m: int, n: int, k: int, sms: int = H100_SMS):
    """(chunk, splits) of the uint4 decode instance, from static sizes
    only: K's 128-groups cut into `splits` runs of `chunk` groups (the
    last may be shorter, none is empty), enough that the (N tiles x M
    tiles x splits) blocks come within a factor 2 of SPLITK_BLOCKS_PER_SM
    on every SM where K has the groups, and at most DECODE_MAX_CHUNK
    groups a split. Split s covers groups [s * chunk, min((s + 1) *
    chunk, K / 128))."""
    if min(m, n, k, sms) < 1 or k % GROUP:
        raise ValueError(f"plan_splits_k: M={m}, N={n}, K={k} (a multiple "
                         f"of {GROUP}), sms={sms}")
    return _plan_splits(m, n, k // GROUP, DECODE_MAX_CHUNK, sms)


def plan_splits_k_i2(m: int, n: int, k: int, sms: int = H100_SMS):
    """(chunk, splits) of the int2 decode instance, from static sizes only:
    K cut into steps of I2_DECODE_STEP (the last ends at K, which need only
    be a multiple of 64), the steps planned as `plan_splits_k` plans
    groups, at most I2_DECODE_MAX_CHUNK a split. Split s covers K [s *
    chunk * 256, min((s + 1) * chunk * 256, K))."""
    if min(m, n, k, sms) < 1 or k % 64:
        raise ValueError(f"plan_splits_k_i2: M={m}, N={n}, K={k} (a "
                         f"multiple of 64), sms={sms}")
    return _plan_splits(m, n, -(-k // I2_DECODE_STEP), I2_DECODE_MAX_CHUNK,
                        sms)


def fused_smem_bytes(fmt: str, tile) -> int:
    """Dynamic shared memory one block of the instance takes (the sources'
    own sizes). The wgmma + TMA instances (dequant_wgmma.cuh Tiled): 1024
    bytes of alignment, STAGES ring slots of A (four boxes of block_m rows
    x 128 bytes), the packed weight (block_n rows x 128 bytes) and, for
    uint4, the slot's two scale and two zero rows (block_n halves each),
    each slot rounded up to 1024 bytes, and two mbarriers a slot. The
    uint4 decode instance: its largest size, A and its group sums over 8
    groups (16 rows) and the per-thread ring of weight chunks and scale /
    zero pairs. The int2 decode instance (dequant_matmul_i2.cu): its
    largest size, A over 8 steps of 256 (16 rows), A's 16 row sums and the
    per-thread ring of two 16-byte weight chunks a stage."""
    bm, bn, bk, stages = tile
    if is_tiled(fmt, tile):
        load = 4 * bm * 128 + bn * 128 + (8 * bn if fmt == "uint4" else 0)
        return 1024 + stages * -(-load // 1024) * 1024 + 2 * stages * 8
    threads = bn // 16 * 32
    if fmt == "uint4":
        return DECODE_MAX_CHUNK * bm * (bk * 2 + 4) + stages * threads * (
            2 * 16 + 2 * 4)
    return I2_DECODE_MAX_CHUNK * bm * bk + bm * 4 + stages * threads * 2 * 16


def _tile(fmt: str, m: int, tile):
    tile = default_tile(fmt, m) if tile is None else tuple(tile)
    if tile not in FUSED_TILES[fmt]:
        raise ValueError(f"{fmt} tile {tile} is not compiled "
                         f"({FUSED_TILES[fmt]})")
    return tile


def dequantize_hopper(qweight: torch.Tensor, scales: torch.Tensor,
                      zeros: torch.Tensor, group: int = GROUP
                      ) -> torch.Tensor:
    """Hopper-layout operands -> dense [N, K] float16, ``(q - z) * s``
    evaluated in float16 (bit-identical to ops/reference.dequantize_weight
    on the same codes)."""
    K = qweight.shape[1] * 8
    w = numerics.decode_uint_field(packing.unpack_k(qweight, 4), 4,
                                   torch.float16)
    s = expand_groups(scales.T.to(torch.float16), group, K)
    z = expand_groups(zeros.T.to(torch.float16), group, K)
    return numerics.apply_scaling(w, s, z, "original").to(torch.float16)


def dequant_matmul_u4_plain(A: torch.Tensor, qweight: torch.Tensor,
                            scales: torch.Tensor, zeros: torch.Tensor,
                            group: int = GROUP) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    W = dequantize_hopper(qweight, scales, zeros, group)
    return matmul_dense_reference(A, W, torch.float16)


def dequant_matmul_u4_split_plain(A: torch.Tensor, qweight: torch.Tensor,
                                  scales: torch.Tensor, zeros: torch.Tensor,
                                  sms: int = H100_SMS) -> torch.Tensor:
    """The decode instance's arithmetic in plain PyTorch (any device): the
    splits `plan_splits_k` gives; in each, the groups in order, each
    adding s (sum q a - z sum a) in f32 (scale and zero applied to the
    group's sums, as the kernel and the JAX kernel apply them); then the
    partials summed in split order 0, 1, ... in f32 and rounded once to
    float16. Only the tests call it."""
    M, K = A.shape
    N = qweight.shape[0]
    chunk, splits = plan_splits_k(M, N, K, sms)
    q = packing.unpack_k(qweight, 4).float()              # [N, K] codes
    Af = A.float()
    out = torch.zeros((M, N), dtype=torch.float32, device=A.device)
    for sp in range(splits):
        part = torch.zeros_like(out)
        for g in range(sp * chunk, min((sp + 1) * chunk, K // GROUP)):
            ks = slice(g * GROUP, (g + 1) * GROUP)
            a = Af[:, ks]
            raw = a @ q[:, ks].T - a.sum(dim=1, keepdim=True) \
                * zeros[g].float()[None]
            part = part + raw * scales[g].float()[None]
        out = out + part
    return out.to(torch.float16)


def _check(A, qweight, scales, zeros, group):
    if A.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"A must be [M, K] and qweight [N, K/8], got "
                         f"{tuple(A.shape)} and {tuple(qweight.shape)}")
    M, K = A.shape
    N = qweight.shape[0]
    if group != GROUP:
        raise NotImplementedError(f"group size {group} (kernel runs {GROUP})")
    if K % GROUP or N % 8:
        raise ValueError(f"K={K} must be a multiple of {GROUP} and N={N} of 8")
    want = {"A": (A, torch.float16, (M, K)),
            "qweight": (qweight, torch.int32, (N, K // 8)),
            "scales": (scales, torch.float16, (K // group, N)),
            "zeros": (zeros, torch.float16, (K // group, N))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != A.device:
            raise ValueError(f"{name} on {t.device}, A on {A.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def dequant_matmul_u4(A: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor, zeros: torch.Tensor,
                      group: int = GROUP, tile=None) -> torch.Tensor:
    """out [M, N] float16; see the module docstring for the layout.
    `tile` is one of FUSED_TILES["uint4"] (default: default_tile)."""
    _check(A, qweight, scales, zeros, group)
    tile = _tile("uint4", A.shape[0], tile)
    if A.device.type == "cpu":
        return dequant_matmul_u4_plain(A, qweight, scales, zeros, group)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    M, K = A.shape
    N = qweight.shape[0]
    out = torch.empty((M, N), dtype=torch.float16, device=A.device)
    if M == 0:
        return out
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tile == U4_DECODE_TILE:
            chunk, splits = plan_splits_k(M, N, K,
                                          scratch.sm_count(A.device))
            part = count = None
            if splits > 1:
                part = scratch.partials(A.device, splits * M * N)
                count = scratch.counters(
                    A.device, -(-N // DECODE_BN) * -(-M // DECODE_BM))
            fn = build.entry("dequant_matmul", "dequant_matmul_u4_decode",
                             _ARGTYPES_DECODE)
            err = fn(A.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                     zeros.data_ptr(), out.data_ptr(),
                     part.data_ptr() if part is not None else 0,
                     count.data_ptr() if count is not None else 0, M, N, K,
                     group, chunk, splits, stream)
        else:
            fn = build.entry("dequant_matmul", "dequant_matmul_u4",
                             _ARGTYPES)
            err = fn(A.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                     zeros.data_ptr(), out.data_ptr(), M, N, K, group,
                     *tile, stream)
    build.check(err, "dequant_matmul_u4")
    dequant_matmul_u4.launches += 1
    if tile == U4_DECODE_TILE:
        dequant_matmul_u4.decode_launches += 1
    else:
        dequant_matmul_u4.tiled_launches += 1
    return out


dequant_matmul_u4.launches = 0
# among them, the launches of the split-K decode instance and those of the
# wgmma + TMA tiled instances
dequant_matmul_u4.decode_launches = 0
dequant_matmul_u4.tiled_launches = 0


def decode_i2_hopper(qweight: torch.Tensor) -> torch.Tensor:
    """[N, K/16] int32 words of biased int2 fields -> int8 values [N, K]
    (``field - 2``, numerics.decode_int_field)."""
    return numerics.decode_int_field(packing.unpack_k(qweight, 2), 2,
                                     torch.int8)


def dequant_matmul_i2_plain(A: torch.Tensor,
                            qweight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the W2A8 kernel (any device): the int32
    sums (ops/reference.matmul_dense_reference), cast to float32 as the
    kernel's epilogue does; exact while K <= I2_MAX_K."""
    return matmul_dense_reference(A, decode_i2_hopper(qweight),
                                  torch.float32)


def dequant_matmul_i2_split_plain(A: torch.Tensor, qweight: torch.Tensor,
                                  sms: int = H100_SMS) -> torch.Tensor:
    """The int2 decode instance's arithmetic in plain PyTorch (any device):
    the splits `plan_splits_k_i2` gives; in each, the biased codes f =
    value + 2 against A, less 2 sum A of the split (sum (f - 2) a); then
    the int32 partials summed in split order 0, 1, ... and cast to
    float32 once. Integer sums are exact in any order, so it equals
    `dequant_matmul_i2_plain` bit for bit. Only the tests call it."""
    M, K = A.shape
    N = qweight.shape[0]
    chunk, splits = plan_splits_k_i2(M, N, K, sms)
    f = packing.unpack_k(qweight, 2).to(torch.int8)      # [N, K] codes
    out = torch.zeros((M, N), dtype=torch.int32, device=A.device)
    span = chunk * I2_DECODE_STEP
    for sp in range(splits):
        ks = slice(sp * span, min((sp + 1) * span, K))
        a = A[:, ks]
        bias = 2 * a.to(torch.int32).sum(dim=1, keepdim=True)
        out = out + (matmul_dense_reference(a, f[:, ks], torch.int32)
                     - bias)
    return out.to(torch.float32)


def _check_i2(A, qweight):
    if A.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"A must be [M, K] and qweight [N, K/16], got "
                         f"{tuple(A.shape)} and {tuple(qweight.shape)}")
    M, K = A.shape
    N = qweight.shape[0]
    if K % 64 or N % 8 or K > I2_MAX_K:
        raise ValueError(f"K={K} must be a multiple of 64 and at most "
                         f"{I2_MAX_K}, N={N} a multiple of 8")
    for name, t, dt, shape in (("A", A, torch.int8, (M, K)),
                               ("qweight", qweight, torch.int32,
                                (N, K // 16))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != A.device:
            raise ValueError(f"{name} on {t.device}, A on {A.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def dequant_matmul_i2(A: torch.Tensor, qweight: torch.Tensor,
                      tile=None) -> torch.Tensor:
    """out [M, N] float32 (the exact int32 sums); see the module
    docstring for the layout. `tile` is one of FUSED_TILES["int2"]
    (default: default_tile)."""
    _check_i2(A, qweight)
    tile = _tile("int2", A.shape[0], tile)
    if A.device.type == "cpu":
        return dequant_matmul_i2_plain(A, qweight)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    M, K = A.shape
    N = qweight.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=A.device)
    if M == 0:
        return out
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tile == I2_DECODE_TILE:
            chunk, splits = plan_splits_k_i2(M, N, K,
                                             scratch.sm_count(A.device))
            part = count = None
            if splits > 1:
                part = scratch.partials(A.device, splits * M * N,
                                        torch.int32)
                count = scratch.counters(
                    A.device, -(-N // DECODE_BN) * -(-M // DECODE_BM))
            fn = build.entry("dequant_matmul_i2", "dequant_matmul_i2_decode",
                             _ARGTYPES_I2_DECODE)
            err = fn(A.data_ptr(), qweight.data_ptr(), out.data_ptr(),
                     part.data_ptr() if part is not None else 0,
                     count.data_ptr() if count is not None else 0, M, N, K,
                     chunk, splits, stream)
        else:
            fn = build.entry("dequant_matmul_i2", "dequant_matmul_i2",
                             _ARGTYPES_I2)
            err = fn(A.data_ptr(), qweight.data_ptr(), out.data_ptr(), M, N,
                     K, *tile, stream)
    build.check(err, "dequant_matmul_i2")
    dequant_matmul_i2.launches += 1
    if tile == I2_DECODE_TILE:
        dequant_matmul_i2.decode_launches += 1
    else:
        dequant_matmul_i2.tiled_launches += 1
    return out


dequant_matmul_i2.launches = 0
# among them, the launches of the split-K decode instance and those of the
# wgmma + TMA tiled instances
dequant_matmul_i2.decode_launches = 0
dequant_matmul_i2.tiled_launches = 0

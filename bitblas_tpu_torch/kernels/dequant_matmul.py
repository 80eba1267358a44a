"""The fused dequantize-into-matmul kernels (counterpart of
bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul), one per
ported configuration, with the Hopper layout of quantization/packing.py:

* `dequant_matmul_u4` (GPTQ W4A16): ``out[M, N] f16 = A[M, K] f16 @
  dequant(Wq)^T (+ bias)``, Wq [N, K/8] int32, scales and zeros [K/g, N]
  float16 for g in 32, 64, 128, any multiple of 256 and K (per channel;
  `check_group`), zeros mode original ((q - z) s) or rescale (q s - z),
  an optional float32 bias [N] added before the one f16 rounding;
  csrc/dequant_matmul.cu. Its plain version decodes the same layout and
  contracts with float32 accumulation (ops/reference.py).
* `dequant_matmul_i2` (BitNet W2A8): ``out[M, N] f32 = A[M, K] int8 @
  (Wq - 2)^T`` with int32 accumulation, Wq [N, K/16] int32 of biased int2
  fields; csrc/dequant_matmul_i2.cu.
* `dequant_matmul_fmt` (every other weight format with float16 or
  bfloat16 activations, ops/matmul_config.FLOAT_PAIRS, and uint4 x
  float16 beyond GPTQ's options: unscaled, scales without zeros, float32
  out): ``out[M, N] =
  A[M, K] @ W^T (+ bias)`` in A's type or float32, W the codes of Wq [N,
  K*bits/32] int32 (uint1/2/4, int1/2/4 biased by 2^(bits-1), int8, nf4,
  fp4_e2m1, e4m3, e5m2) decoded to A's type, with scales [K/g, N] and, for
  uint, zeros [K/g, N] in A's type (original or rescale), or neither;
  csrc/dequant_formats.cuh, instantiated by csrc/dequant_fmt_*.cu. Its
  decoded weight is the plain version's bit for bit
  (`dequantize_fmt_hopper`).
* `dequant_matmul_int` (the integer column, ops/matmul_config.INT_PAIRS,
  but BitNet's int2 configuration): ``out[M, N] = A[M, K] int8 . W^T (+
  bias)``, W the uint1/2/4 codes or int1/2/4 values of Wq [N, K*bits/32]
  int32 (int codes biased by 2^(bits-1)); unscaled, the exact int32 sums;
  with scales [K/g, N] float16 (and, uint, zeros [K/g, N] float16,
  original or rescale) each group's exact int32 sums converted and scaled
  in float32 (s (d - z sum a), rescale d s - z sum a), as JAX's kernel
  applies them; the float32 bias added; out float32, float16, int32
  (unscaled) or int8 (saturating: rounded half to even, clamped);
  csrc/dequant_int.cuh, instantiated by csrc/dequant_int_*.cu. Its plain
  version is JAX's oracle: exact int32 sums unscaled, else the float32
  product of the float32 weight (w - z) s.
* The tiled paths: csrc/dequant_wgmma.cuh.
* Every configuration none of these take (ops/matmul_config.specialized:
  other activation types, wide weights, K off 128, other groups and
  outputs, zeros on nf4 / fp4 / fp8, zeros without scales): kernel 1's
  general instance, kernels/general.py (`spec_format` "general").

Each kernel is compiled for a small fixed set of tile instances
(`FUSED_TILES`, (block_m, block_n, block_k, stages)); the caller names one
(`tile=`, from the Matmul's hint), and `default_tile` is the choice by M
that the Matmul makes untuned. The first instance of each format is its
decode-M design, split-K with the weight decoded in registers: 128 weight
rows a block on the mma's 16-row side, the tokens on its 8-wide side, K
split across blocks from static sizes only, the partials summed in split
order by the last block of each tile, one launch a call:
* uint4 `U4_DECODE_TILE`: K split in whole steps of 128 (`plan_splits_k`),
  the scale and zero applied to a group's sums (a step's, or each 32-deep
  quarter's for g = 32 and 64), f32 partials
  (`dequant_matmul_u4_split_plain` is that arithmetic in plain PyTorch,
  for the tests);
* int2 `I2_DECODE_TILE`: K split in steps of 256 (`plan_splits_k_i2`;
  the last step may end at a K tail of 64, 128 or 192), the biased codes
  fed to the mma as they are and the bias taken off once a split (sum (f
  - 2) a = sum f a - 2 sum a), int32 partials
  (`dequant_matmul_i2_split_plain`). Bound at M <= 16: the weight bytes
  N K / 4 over 3.35 TB/s;
* `fmt_decode_tile` (dequant_matmul_fmt): 16 x 128, K split in steps of
  512 / bits, each thread's chunk decoded and scaled in A's type, f32
  partials (`plan_splits_fmt`, `dequant_matmul_fmt_split_plain`);
* the same tile for dequant_matmul_int: int2's design for 1, 2 and 4
  bits, K split in steps of 512 / bits (`plan_splits_k_int`), every mma
  within one 32-deep window of K so that each group's int32 sums are
  taken apart, int32 partials unscaled, f32 partials scaled
  (`dequant_matmul_int_split_plain`).
The others are the tiled instances (block_m tokens x block_n weight
rows: three uint4, four int2, and for each other format one,
`FMT_TILED_TILE` or `INT_TILED_TILE`), one mixed-input wgmma + TMA main
loop shared by all formats (csrc/dequant_wgmma.cuh): the weight decoded
in registers straight into wgmma's A operand, the tokens on its n side.
Each wrapper counts its launches (`launches`), and apart from them those
of its decode instance (`decode_launches`) and of its tiled instances
(`tiled_launches`); `dequant_matmul_fmt` and `dequant_matmul_int` also by
format (`format_launches`) and by instance and options
(`variant_launches`). On
a CUDA tensor each wrapper launches its kernel (design and bound are
written in the source); on a CPU tensor it runs the plain version, for
which the tile changes nothing."""

from __future__ import annotations

import ctypes

import torch

from ..ops.matmul_config import FLOAT_PAIRS, INT_PAIRS, specialized_pair
from ..ops.reference import expand_groups, matmul_dense_reference
from ..quantization import numerics, packing
from ..quantization.formats import as_torch_dtype, source_format_and_bits
from . import build, scratch
from .general import GENERAL_TILE

GROUP = 128          # the step of the uint4 decode instance, JAX's default
# groups the uint4 kernels take besides 128, the multiples of 256 that
# divide K and K itself (per channel): csrc/dequant_matmul.cu group_ok
NARROW_GROUPS = (32, 64)
ZEROS_MODES = ("original", "rescale")
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_ARGTYPES_DECODE = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
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
# dequant_matmul_fmt's formats (csrc/dequant_formats.cuh): the split-K
# decode instance, K in steps of 512 / bits (a quad's four 16-byte chunks
# of each weight row), at most FMT_MAX_SPLIT_K of K a split; and one
# tiled instance, 64 tokens x 128 weight rows, slots of 256 of K, three
# slots (csrc/dequant_wgmma.cuh run_tiled_fmt).
FMT_MAX_SPLIT_K = 1024
FMT_DECODE_STAGES = 4
FMT_TILED_TILE = (64, 128, 256, 3)


def fmt_decode_tile(bits: int):
    return (16, 128, 512 // bits, FMT_DECODE_STAGES)


def fused_format(W_dtype: str, A_dtype: str, out_dtype=None, scaled=None,
                 zeros=None, bias=None) -> str:
    """The key of a quantized configuration's fused instances. Two pairs
    have kernels of their own for one configuration, which keeps its key
    (so the tuned hints of the database keep their meaning), and a call
    without options names it: "uint4" for GPTQ's uint4 x float16 (scales
    and zeros, float16 out; dequant_matmul_u4) and "int2" for BitNet's
    int2 x int8 (unscaled, float32 out, no bias; dequant_matmul_i2).
    Every other configuration is "<W>x<A>": "nf4xbfloat16" and
    "uint4xfloat16" (dequant_matmul_fmt), "uint4xint8" and "int2xint8"
    (dequant_matmul_int). `out_dtype` is a name; None for an option means
    the pair's own configuration."""
    pair = (W_dtype, A_dtype)
    if pair == ("uint4", "float16") and scaled in (None, True) \
            and zeros in (None, True) and out_dtype in (None, "float16"):
        return "uint4"
    if pair == ("int2", "int8") and not scaled and not bias \
            and out_dtype in (None, "float32"):
        return "int2"
    return f"{W_dtype}x{A_dtype}"


def spec_format(spec) -> str:
    """fused_format of a KernelSpec (kernels/spec.py); "general" for a
    configuration the specialized kernels do not take
    (ops/matmul_config.specialized_pair: kernels/general.py runs it)."""
    if not spec.native and not specialized_pair(
            spec.a_dtype, spec.w_dtype, spec.out_dtype, spec.k, spec.n,
            spec.group_size, spec.with_scaling, spec.with_zeros):
        return "general"
    return fused_format(spec.w_dtype, spec.a_dtype, spec.out_dtype,
                        spec.with_scaling, spec.with_zeros, spec.with_bias)


def split_format(fmt: str):
    """(W_dtype, A_dtype) of a fused_format key."""
    return {"uint4": ("uint4", "float16"),
            "int2": ("int2", "int8")}.get(fmt) or tuple(fmt.split("x"))


FMT_FORMATS = tuple(f"{w}x{a}" for a, w in FLOAT_PAIRS
                    + (("float16", "uint4"),))
for _fmt in FMT_FORMATS:
    FUSED_TILES[_fmt] = (
        fmt_decode_tile(source_format_and_bits(split_format(_fmt)[0])[1]),
        FMT_TILED_TILE)
# dequant_matmul_int's formats (csrc/dequant_int.cuh): the split-K decode
# instance (fmt_decode_tile's geometry: K in steps of 512 / bits, a
# quad's four 16-byte chunks of each weight row), at most INT_MAX_SPLIT_K
# of K a split; and one tiled
# instance, 64 tokens x 128 weight rows, slots of 512 of K (four
# 128-byte boxes of A), three slots (csrc/dequant_wgmma.cuh IntFmt).
INT_MAX_SPLIT_K = 2048
INT_TILED_TILE = (64, 128, 512, 3)
INT_FORMATS = tuple(f"{w}x{a}" for a, w in INT_PAIRS)
for _fmt in INT_FORMATS:
    FUSED_TILES[_fmt] = (
        fmt_decode_tile(source_format_and_bits(split_format(_fmt)[0])[1]),
        INT_TILED_TILE)
# The general instance (kernels/general.py, csrc/dequant_general.cu): one
# tile, up to 512 tokens x 64 weight rows, K in steps of 32.
FUSED_TILES["general"] = (GENERAL_TILE,)
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
    tiles = FUSED_TILES[fmt]
    if m <= 16 or fmt == "general":
        return tiles[0]
    return tiles[1] if fmt in FMT_FORMATS + INT_FORMATS else tiles[2]


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
    only, whatever the group size: K's steps of 128 cut into `splits`
    runs of `chunk` steps (the last may be shorter, none is empty),
    enough that the (N tiles x M tiles x splits) blocks come within a
    factor 2 of SPLITK_BLOCKS_PER_SM on every SM where K has the steps,
    and at most DECODE_MAX_CHUNK steps a split. Split s covers steps [s *
    chunk, min((s + 1) * chunk, K / 128))."""
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


def plan_splits_k_int(m: int, n: int, k: int, bits: int,
                      sms: int = H100_SMS):
    """(chunk, splits) of dequant_matmul_int's decode instance, from
    static sizes only: K's steps of 512 / bits (the last may end at a K
    tail, K a multiple of 128) planned as `plan_splits_k` plans uint4's, at
    most INT_MAX_SPLIT_K of K a split. Split s covers steps [s * chunk,
    min((s + 1) * chunk, ceil(K / step)))."""
    step = 512 // bits
    if bits not in (1, 2, 4) or min(m, n, k, sms) < 1 or k % 128:
        raise ValueError(f"plan_splits_k_int: M={m}, N={n}, K={k} (a "
                         f"multiple of 128), bits={bits}, sms={sms}")
    return _plan_splits(m, n, -(-k // step), INT_MAX_SPLIT_K // step, sms)


def fused_smem_bytes(fmt: str, tile, group: int = GROUP) -> int:
    """Dynamic shared memory one block of the instance takes at uint4's
    group size `group` (the sources' own sizes; dequant_matmul_int's at
    the largest of its options). The wgmma + TMA
    instances (dequant_wgmma.cuh Tiled): 1024 bytes of alignment, STAGES
    ring slots of A (four boxes of block_m rows x 128 bytes), the packed
    weight (block_n rows x 128 bytes) and, for uint4, room for the slot's
    scale and zero rows (block_n halves each; 8 rows for g = 32 and 64,
    else 2), each slot rounded up to 1024 bytes, and two mbarriers a slot.
    The uint4 decode instance: its largest size, A and its sums over 8
    steps (16 rows; a sum a quarter for g = 32, 64) and the per-thread
    ring of weight chunks and scale / zero pairs. The int2 decode
    instance (dequant_matmul_i2.cu): its largest
    size, A over 8 steps of 256 (16 rows), A's 16 row sums and the
    per-thread ring of two 16-byte weight chunks a stage."""
    bm, bn, bk, stages = tile
    if fmt == "general":   # the largest instance: float16 operands from
        # one-byte A at 512 rows (the ring's A and 32-bit weight words, two
        # operand tiles of each)
        return stages * (bm * (bk + 16) + bn * bk * 4) \
            + 2 * (bm + bn) * (bk + 8) * 2
    if fmt in INT_FORMATS:
        bits = source_format_and_bits(split_format(fmt)[0])[1]
        if is_tiled(fmt, tile):   # a slot's 512 of K is 64 bits bytes a
            # row; 16 rows of room for the scales and for the zeros
            load = 4 * bm * 128 + bn * 64 * bits + 2 * 16 * bn * 2
            return 1024 + stages * -(-load // 1024) * 1024 + 2 * stages * 8
        # A over INT_MAX_SPLIT_K of K (16 rows, each padded by 32 bytes),
        # the sums of A by 32-deep window, the ring of two 16-byte chunks
        return 16 * (INT_MAX_SPLIT_K + 32) + 16 * INT_MAX_SPLIT_K // 32 * 4 \
            + stages * (bn // 16 * 32) * 2 * 16
    if fmt in FMT_FORMATS:
        bits = source_format_and_bits(split_format(fmt)[0])[1]
        if is_tiled(fmt, tile):   # a slot's 256 of K is 32 bits bytes a row
            load = 4 * bm * 128 + bn * 32 * bits + 2 * 8 * bn * 2
            return 1024 + stages * -(-load // 1024) * 1024 + 2 * stages * 8
        # A over FMT_MAX_SPLIT_K of K (16 rows, each padded by 32 bytes),
        # the ring of two 16-byte chunks and up to four scale / zero pairs
        # (a chunk's 128 / bits codes against groups of 32) a thread
        pairs = max(1, 128 // bits // 32)
        return 16 * (FMT_MAX_SPLIT_K * 2 + 32) \
            + stages * (bn // 16 * 32) * (2 * 16 + 2 * pairs * 4)
    if is_tiled(fmt, tile):
        rows = (8 if group in NARROW_GROUPS else 2) if fmt == "uint4" \
            else 0
        load = 4 * bm * 128 + bn * 128 + 4 * rows * bn
        return 1024 + stages * -(-load // 1024) * 1024 + 2 * stages * 8
    threads = bn // 16 * 32
    if fmt == "uint4":
        sums = 4 if group in NARROW_GROUPS else 1
        return DECODE_MAX_CHUNK * (bm * bk * 2 + sums * bm * 4) \
            + stages * threads * (2 * 16 + 2 * 4)
    return I2_DECODE_MAX_CHUNK * bm * bk + bm * 4 + stages * threads * 2 * 16


def _tile(fmt: str, m: int, tile):
    tile = default_tile(fmt, m) if tile is None else tuple(tile)
    if tile not in FUSED_TILES[fmt]:
        raise ValueError(f"{fmt} tile {tile} is not compiled "
                         f"({FUSED_TILES[fmt]})")
    return tile


def check_group(K: int, group: int) -> None:
    """Raise NotImplementedError unless the kernels take this group size
    at this K (csrc/dequant_matmul.cu and dequant_formats.cuh group_ok): K
    a multiple of 128 and g = 32, 64, 128, a multiple of 256 that divides
    K, or K."""
    if K % GROUP == 0 and K % group == 0 and (
            group in NARROW_GROUPS or group == GROUP or group % 256 == 0
            or group == K):
        return
    raise NotImplementedError(
        f"no kernel instance takes K={K} with group size {group} (K a "
        f"multiple of {GROUP}; g = 32, 64, 128, a multiple of 256 that "
        f"divides K, or K)")


def dequantize_hopper(qweight: torch.Tensor, scales: torch.Tensor,
                      zeros: torch.Tensor, group: int = GROUP,
                      zeros_mode: str = "original") -> torch.Tensor:
    """Hopper-layout operands -> dense [N, K] float16, ``(q - z) * s``
    (rescale: ``q * s - z``) evaluated in float16 (bit-identical to
    ops/reference.dequantize_weight on the same codes)."""
    K = qweight.shape[1] * 8
    w = numerics.decode_uint_field(packing.unpack_k(qweight, 4), 4,
                                   torch.float16)
    s = expand_groups(scales.T.to(torch.float16), group, K)
    z = expand_groups(zeros.T.to(torch.float16), group, K)
    return numerics.apply_scaling(w, s, z, zeros_mode).to(torch.float16)


def _with_bias(out: torch.Tensor, bias) -> torch.Tensor:
    """f32 sums [M, N] + the f32 bias, rounded once to float16."""
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(torch.float16)


def dequant_matmul_u4_plain(A: torch.Tensor, qweight: torch.Tensor,
                            scales: torch.Tensor, zeros: torch.Tensor,
                            group: int = GROUP, bias=None,
                            zeros_mode: str = "original") -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    W = dequantize_hopper(qweight, scales, zeros, group, zeros_mode)
    if bias is None:
        return matmul_dense_reference(A, W, torch.float16)
    return _with_bias(matmul_dense_reference(A, W, torch.float32), bias)


def dequant_matmul_u4_split_plain(A: torch.Tensor, qweight: torch.Tensor,
                                  scales: torch.Tensor, zeros: torch.Tensor,
                                  sms: int = H100_SMS, group: int = GROUP,
                                  bias=None, zeros_mode: str = "original"
                                  ) -> torch.Tensor:
    """The decode instance's arithmetic in plain PyTorch (any device): the
    splits `plan_splits_k` gives; in each, the steps of 128 in order, each
    adding s (sum q a - z sum a) in f32 (rescale: s sum q a - z sum a;
    scale and zero applied to a group's sums, as the kernel and the JAX
    kernel apply them), one pair a step for g >= 128 and one a 32-deep
    quarter, in order, for g = 32 and 64; then the partials summed in
    split order 0, 1, ... in f32, the bias added and rounded once to
    float16. Only the tests call it."""
    M, K = A.shape
    N = qweight.shape[0]
    chunk, splits = plan_splits_k(M, N, K, sms)
    q = packing.unpack_k(qweight, 4).float()              # [N, K] codes
    Af = A.float()
    span = 32 if group in NARROW_GROUPS else GROUP     # K a correction
    out = torch.zeros((M, N), dtype=torch.float32, device=A.device)
    for sp in range(splits):
        part = torch.zeros_like(out)
        for k0 in range(sp * chunk * GROUP, min((sp + 1) * chunk * GROUP, K),
                        span):
            ks = slice(k0, k0 + span)
            a = Af[:, ks]
            r = k0 // group
            s, z = scales[r].float()[None], zeros[r].float()[None]
            raw, asum = a @ q[:, ks].T, a.sum(dim=1, keepdim=True)
            if zeros_mode == "rescale":
                part = part + (raw * s - asum * z)
            else:
                part = part + (raw - asum * z) * s
        out = out + part
    return _with_bias(out, bias)


def _check(A, qweight, scales, zeros, group, bias=None,
           zeros_mode="original"):
    if A.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"A must be [M, K] and qweight [N, K/8], got "
                         f"{tuple(A.shape)} and {tuple(qweight.shape)}")
    M, K = A.shape
    N = qweight.shape[0]
    if zeros_mode not in ZEROS_MODES:
        raise ValueError(f"zeros_mode {zeros_mode!r} (the kernels take "
                         f"{ZEROS_MODES}; quantized zeros are unpacked to "
                         f"float16 zeros by the weight transform)")
    # the plain version takes what the kernels take, on every device
    check_group(K, group)
    if N % 8:
        raise ValueError(f"N={N} must be a multiple of 8")
    want = {"A": (A, torch.float16, (M, K)),
            "qweight": (qweight, torch.int32, (N, K // 8)),
            "scales": (scales, torch.float16, (K // group, N)),
            "zeros": (zeros, torch.float16, (K // group, N))}
    if bias is not None:
        want["bias"] = (bias, torch.float32, tuple(bias.shape))
        if bias.numel() != N:
            raise ValueError(f"bias: expected {N} values, got "
                             f"{tuple(bias.shape)}")
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
                      group: int = GROUP, tile=None, bias=None,
                      zeros_mode: str = "original") -> torch.Tensor:
    """out [M, N] float16; see the module docstring for the layout.
    `tile` is one of FUSED_TILES["uint4"] (default: default_tile); `bias`
    float32 [N] or [1, N]; `zeros_mode` "original" or "rescale". A group
    size no instance takes raises NotImplementedError (`check_group`), on
    the card and, so that the CPU tests see it, on the CPU."""
    _check(A, qweight, scales, zeros, group, bias, zeros_mode)
    tile = _tile("uint4", A.shape[0], tile)
    if A.device.type == "cpu":
        return dequant_matmul_u4_plain(A, qweight, scales, zeros, group,
                                       bias, zeros_mode)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    M, K = A.shape
    N = qweight.shape[0]
    rescale = int(zeros_mode == "rescale")
    bias_ptr = bias.data_ptr() if bias is not None else 0
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
                     zeros.data_ptr(), bias_ptr, out.data_ptr(),
                     part.data_ptr() if part is not None else 0,
                     count.data_ptr() if count is not None else 0, M, N, K,
                     group, rescale, chunk, splits, stream)
        else:
            fn = build.entry("dequant_matmul", "dequant_matmul_u4",
                             _ARGTYPES)
            err = fn(A.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                     zeros.data_ptr(), bias_ptr, out.data_ptr(), M, N, K,
                     group, rescale, *tile, stream)
    build.check(err, "dequant_matmul_u4")
    dequant_matmul_u4.launches += 1
    kind = "decode" if tile == U4_DECODE_TILE else "tiled"
    if kind == "decode":
        dequant_matmul_u4.decode_launches += 1
    else:
        dequant_matmul_u4.tiled_launches += 1
    key = u4_variant(kind, group, K, zeros_mode, bias is not None)
    counts = dequant_matmul_u4.variant_launches
    counts[key] = counts.get(key, 0) + 1
    return out


def u4_variant(kind: str, group: int, K: int, zeros_mode: str,
               bias: bool) -> str:
    """The name of a uint4 launch's instance and options, as
    `variant_launches` counts it: "decode g64", "tiled per_channel",
    "decode g128 rescale bias", ..."""
    g = "per_channel" if group == K and group > GROUP else f"g{group}"
    return " ".join([kind, g] + (["rescale"] if zeros_mode == "rescale"
                                 else []) + (["bias"] if bias else []))


dequant_matmul_u4.launches = 0
# among them, the launches of the split-K decode instance and those of the
# wgmma + TMA tiled instances; and every launch by instance, group size,
# zeros mode and bias (u4_variant)
dequant_matmul_u4.decode_launches = 0
dequant_matmul_u4.tiled_launches = 0
dequant_matmul_u4.variant_launches = {}


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


# -- every other format with float activations (csrc/dequant_formats.cuh) ----

# the family codes of the C entry points
_FMT_FAMILY = {"uint": 0, "int": 1, "nf": 2, "fp": 3, "fp_e4m3": 4,
               "fp_e5m2": 5}
# csrc/dequant_fmt_<tag>.cu of a (family, A_dtype)
_FMT_TAG = {"uint": "uint", "int": "int", "nf": "float", "fp": "float",
            "fp_e4m3": "float", "fp_e5m2": "float"}
_FMT_ACT = {"float16": "f16", "bfloat16": "bf16"}


def fmt_source(w_dtype: str, a_dtype: str) -> str:
    """The csrc/ source that compiles the (w_dtype, a_dtype) pair."""
    family = source_format_and_bits(w_dtype)[0]
    return f"dequant_fmt_{_FMT_TAG[family]}_{_FMT_ACT[a_dtype]}"

_ARGTYPES_FMT_DECODE = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_ARGTYPES_FMT_TILED = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def fmt_entry(w_dtype: str, a_dtype: str, kind: str, argtypes):
    """The C entry point `kind` ("decode", "tiled", "weight_decode") of the
    source that compiles (w_dtype, a_dtype), and the (family, bits) codes
    it dispatches on."""
    family, bits = source_format_and_bits(w_dtype)
    source = fmt_source(w_dtype, a_dtype)
    fn = build.entry(source, f"dqf_{source[len('dequant_fmt_'):]}_{kind}",
                     argtypes)
    return fn, _FMT_FAMILY[family], bits


def plan_splits_fmt(m: int, n: int, k: int, bits: int, sms: int = H100_SMS):
    """(chunk, splits) of dequant_matmul_fmt's decode instance, from static
    sizes only: K's steps of 512 / bits (the last may end at a K tail, K
    a multiple of 128) planned as `plan_splits_k` plans uint4's, at most
    FMT_MAX_SPLIT_K of K a split. Split s covers steps [s * chunk, min((s
    + 1) * chunk, ceil(K / step)))."""
    step = 512 // bits
    if min(m, n, k, sms) < 1 or k % 128:
        raise ValueError(f"plan_splits_fmt: M={m}, N={n}, K={k} (a "
                         f"multiple of 128), sms={sms}")
    return _plan_splits(m, n, -(-k // step), FMT_MAX_SPLIT_K // step, sms)


def dequantize_fmt_hopper(qweight: torch.Tensor, w_dtype: str,
                          a_dtype: str, scales=None, zeros=None,
                          group: int = -1,
                          zeros_mode: str = "original") -> torch.Tensor:
    """Hopper-layout operands -> the dense weight [N, K] in A's type: the
    codes decoded (numerics.decode_codes) and, with scales, ``(w - z) *
    s`` (rescale: ``w * s - z``; no zeros: ``w * s``), each op rounded in
    A's type: bit-identical to ops/reference.dequantize_weight (the JAX
    oracle) on the same codes, and to what the kernels decode."""
    family, bits = source_format_and_bits(w_dtype)
    adt = as_torch_dtype(a_dtype)
    codes = packing.unpack_k(qweight, bits)
    K = codes.shape[1]
    w = numerics.decode_codes(codes, family, bits, adt)
    if scales is None:
        return w
    g = K if group in (-1, None) else group
    s = expand_groups(scales.T.to(adt), g, K)
    z = None if zeros is None else expand_groups(zeros.T.to(adt), g, K)
    return numerics.apply_scaling(w, s, z, zeros_mode).to(adt)


def _finish(out: torch.Tensor, bias, out_dtype: torch.dtype):
    """f32 sums [M, N] + the f32 bias, rounded once to out_dtype."""
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(out_dtype)


def dequant_matmul_fmt_plain(A: torch.Tensor, qweight: torch.Tensor,
                             w_dtype: str, scales=None, zeros=None,
                             group: int = -1, bias=None,
                             zeros_mode: str = "original",
                             out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of dequant_matmul_fmt (any device): the dense
    weight of `dequantize_fmt_hopper`, the product summed in float32, the
    bias added, one rounding to out_dtype (A's type by default)."""
    adt = A.dtype
    W = dequantize_fmt_hopper(qweight, w_dtype, _act_name(adt), scales,
                              zeros, group, zeros_mode)
    return _finish(matmul_dense_reference(A, W, torch.float32), bias,
                   out_dtype or adt)


def dequant_matmul_fmt_split_plain(A: torch.Tensor, qweight: torch.Tensor,
                                   w_dtype: str, scales=None, zeros=None,
                                   group: int = -1, bias=None,
                                   zeros_mode: str = "original",
                                   out_dtype=None,
                                   sms: int = H100_SMS) -> torch.Tensor:
    """The decode instance's arithmetic in plain PyTorch (any device): the
    splits `plan_splits_fmt` gives, each the f32 product of its K range
    (the dense weight of `dequantize_fmt_hopper`), the partials summed in
    split order 0, 1, ..., the bias added, one rounding. Only the tests
    call it."""
    M, K = A.shape
    N = qweight.shape[0]
    bits = source_format_and_bits(w_dtype)[1]
    chunk, splits = plan_splits_fmt(M, N, K, bits, sms)
    W = dequantize_fmt_hopper(qweight, w_dtype, _act_name(A.dtype), scales,
                              zeros, group, zeros_mode).float()
    Af = A.float()
    span = chunk * (512 // bits)
    out = torch.zeros((M, N), dtype=torch.float32, device=A.device)
    for sp in range(splits):
        ks = slice(sp * span, min((sp + 1) * span, K))
        out = out + Af[:, ks] @ W[:, ks].T
    return _finish(out, bias, out_dtype or A.dtype)


def _act_name(dtype: torch.dtype) -> str:
    if dtype not in (torch.float16, torch.bfloat16):
        raise ValueError(f"A must be float16 or bfloat16, got {dtype}")
    return "float16" if dtype == torch.float16 else "bfloat16"


def _check_quant(A, qweight, w_dtype, scales, zeros, group, bias,
                 zeros_mode, sdtype):
    """The operand checks dequant_matmul_fmt and dequant_matmul_int share
    (the plain versions take what the kernels take, on every device): A
    [M, K], qweight [N, K*bits/32] int32, scales and zeros [K/g, N] in
    `sdtype` (zeros with scales, uint only), a float32 bias of N values,
    every tensor contiguous, 16-byte aligned and on A's device. Returns
    (g, bits)."""
    if A.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"A must be [M, K] and qweight 2-D, got "
                         f"{tuple(A.shape)} and {tuple(qweight.shape)}")
    family, bits = source_format_and_bits(w_dtype)
    M, K = A.shape
    N = qweight.shape[0]
    g = K if group in (-1, None) else group
    if zeros_mode not in ZEROS_MODES:
        raise ValueError(f"zeros_mode {zeros_mode!r} (the kernels take "
                         f"{ZEROS_MODES}; quantized zeros are unpacked by "
                         f"the weight transform)")
    if zeros is not None and (scales is None or family != "uint"):
        raise NotImplementedError(f"zeros need scales and the uint family "
                                  f"(got {w_dtype}, scales "
                                  f"{'none' if scales is None else 'given'})")
    if scales is not None:
        check_group(K, g)
    if K % 128 or N % 8:
        raise ValueError(f"K={K} must be a multiple of 128, N={N} of 8")
    want = {"A": (A, A.dtype, (M, K)),
            "qweight": (qweight, torch.int32, (N, K * bits // 32))}
    for name, t in (("scales", scales), ("zeros", zeros)):
        if t is not None:
            want[name] = (t, sdtype, (K // g, N))
    if bias is not None:
        want["bias"] = (bias, torch.float32, tuple(bias.shape))
        if bias.numel() != N:
            raise ValueError(f"bias: expected {N} values, got "
                             f"{tuple(bias.shape)}")
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != A.device:
            raise ValueError(f"{name} on {t.device}, A on {A.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return g, bits


def _check_fmt(A, qweight, w_dtype, scales, zeros, group, bias, zeros_mode,
               out_dtype):
    a_name = _act_name(A.dtype)
    fmt = f"{w_dtype}x{a_name}"
    if fmt not in FMT_FORMATS:
        raise NotImplementedError(f"dequant_matmul_fmt does not run "
                                  f"{w_dtype} x {a_name}")
    if out_dtype not in (None, A.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: A's type or float32")
    return (fmt, *_check_quant(A, qweight, w_dtype, scales, zeros, group,
                               bias, zeros_mode, A.dtype))


def fmt_variant(fmt: str, kind: str, group: int, K: int, scaled: bool,
                zeros_mode: str, bias: bool) -> str:
    """The name of a dequant_matmul_fmt launch's instance and options, as
    `variant_launches` counts it: "nf4xbfloat16 decode g128",
    "uint2xfloat16 tiled per_channel rescale bias", "int8xfloat16 decode
    unscaled", ..."""
    g = ("unscaled" if not scaled else "per_channel" if group == K
         and group > GROUP else f"g{group}")
    return " ".join([fmt, kind, g] + (["rescale"] if zeros_mode == "rescale"
                                      else []) + (["bias"] if bias else []))


def dequant_matmul_fmt(A: torch.Tensor, qweight: torch.Tensor, w_dtype: str,
                       scales=None, zeros=None, group: int = -1, tile=None,
                       bias=None, zeros_mode: str = "original",
                       out_dtype=None) -> torch.Tensor:
    """out [M, N] in `out_dtype` (A's type by default, or float32) for a
    `w_dtype` weight under A's float16 / bfloat16 activations; see the
    module docstring for the layout. `scales` (and, for the uint family,
    `zeros`) [K/g, N] in A's type or None; `group` g (-1: per channel);
    `tile` one of FUSED_TILES["<w_dtype>x<A's type>"] (default:
    default_tile); `bias` float32 [N] or [1, N]; `zeros_mode` "original"
    ((w - z) s) or "rescale" (w s - z)."""
    fmt, g, bits = _check_fmt(A, qweight, w_dtype, scales, zeros, group,
                              bias, zeros_mode, out_dtype)
    tile = _tile(fmt, A.shape[0], tile)
    odt = out_dtype or A.dtype
    if A.device.type == "cpu":
        return dequant_matmul_fmt_plain(A, qweight, w_dtype, scales, zeros,
                                        g, bias, zeros_mode, odt)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    M, K = A.shape
    N = qweight.shape[0]
    mode = 0 if scales is None else 2 if zeros_mode == "rescale" and \
        zeros is not None else 1
    ptrs = [A.data_ptr(), qweight.data_ptr(),
            scales.data_ptr() if scales is not None else 0,
            zeros.data_ptr() if zeros is not None else 0,
            bias.data_ptr() if bias is not None else 0]
    out = torch.empty((M, N), dtype=odt, device=A.device)
    if M == 0:
        return out
    f32 = int(odt == torch.float32)
    decode = tile == FUSED_TILES[fmt][0]
    a_name = _act_name(A.dtype)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if decode:
            chunk, splits = plan_splits_fmt(M, N, K, bits,
                                            scratch.sm_count(A.device))
            part = count = None
            if splits > 1:
                part = scratch.partials(A.device, splits * M * N)
                count = scratch.counters(
                    A.device, -(-N // DECODE_BN) * -(-M // DECODE_BM))
            fn, fam, b = fmt_entry(w_dtype, a_name, "decode",
                                   _ARGTYPES_FMT_DECODE)
            err = fn(fam, b, mode, *ptrs, out.data_ptr(), f32,
                     part.data_ptr() if part is not None else 0,
                     count.data_ptr() if count is not None else 0, M, N, K,
                     g, chunk, splits, stream)
        else:
            fn, fam, b = fmt_entry(w_dtype, a_name, "tiled",
                                   _ARGTYPES_FMT_TILED)
            err = fn(fam, b, mode, *ptrs, out.data_ptr(), f32, M, N, K, g,
                     stream)
    build.check(err, f"dequant_matmul_fmt {fmt}")
    kind = "decode" if decode else "tiled"
    dequant_matmul_fmt.launches += 1
    if decode:
        dequant_matmul_fmt.decode_launches += 1
    else:
        dequant_matmul_fmt.tiled_launches += 1
    for counts, key in (
            (dequant_matmul_fmt.format_launches, fmt),
            (dequant_matmul_fmt.variant_launches,
             fmt_variant(fmt, kind, g, K, scales is not None, zeros_mode
                         if zeros is not None else "original",
                         bias is not None))):
        counts[key] = counts.get(key, 0) + 1
    return out


dequant_matmul_fmt.launches = 0
# among them, the decode instance's and the tiled instance's launches; and
# every launch by format ("nf4xbfloat16") and by instance and options
# (fmt_variant)
dequant_matmul_fmt.decode_launches = 0
dequant_matmul_fmt.tiled_launches = 0
dequant_matmul_fmt.format_launches = {}
dequant_matmul_fmt.variant_launches = {}


# -- the integer column (csrc/dequant_int.cuh) --------------------------------

# the options of the C entry points: the mode (0 unscaled, 1 scales, 2
# scales and zeros (w - z) s, 3 w s - z) and the output type
_INT_OUT = {torch.float32: 0, torch.float16: 1, torch.int32: 2,
            torch.int8: 3}
_ARGTYPES_INT_DECODE = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_ARGTYPES_INT_TILED = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def int_source(w_dtype: str) -> str:
    """The csrc/ source that compiles the int8 x `w_dtype` instances
    (dequant_int_u4, dequant_int_i1, ...); its entry points are
    dqi_<u4, i1, ...>_decode and _tiled."""
    family, bits = source_format_and_bits(w_dtype)
    return f"dequant_int_{family[0]}{bits}"


def decode_int_hopper(qweight: torch.Tensor, w_dtype: str,
                      dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """[N, K*bits/32] int32 words of a uint / int weight -> its values [N,
    K] in `dtype` (the int family less 2^(bits-1))."""
    family, bits = source_format_and_bits(w_dtype)
    return numerics.decode_field(packing.unpack_k(qweight, bits), family,
                                 bits, dtype)


def _saturated(out: torch.Tensor, bias, out_dtype: torch.dtype):
    """int32 or float32 sums [M, N] + the float32 bias (the sums taken to
    float32 first), then the saturating cast (numerics.saturate_cast)."""
    if bias is not None:
        out = out.float() + bias.reshape(1, -1).float()
    return numerics.saturate_cast(out, out_dtype)


def dequant_matmul_int_plain(A: torch.Tensor, qweight: torch.Tensor,
                             w_dtype: str, scales=None, zeros=None,
                             group: int = -1, bias=None,
                             zeros_mode: str = "original",
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of dequant_matmul_int (any device), JAX's
    oracle (ops/reference.py): unscaled, the exact int32 sums of the
    values; scaled, the float32 product of A and the float32 weight (w -
    z) s (rescale w s - z); the bias added in float32, the saturating
    cast."""
    if scales is None:
        out = matmul_dense_reference(A, decode_int_hopper(qweight, w_dtype),
                                     torch.int32)
    else:
        K = A.shape[1]
        g = K if group in (-1, None) else group
        w = decode_int_hopper(qweight, w_dtype, torch.float32)
        s = expand_groups(scales.T.float(), g, K)
        z = None if zeros is None else expand_groups(zeros.T.float(), g, K)
        out = matmul_dense_reference(
            A, numerics.apply_scaling(w, s, z, zeros_mode), torch.float32)
    return _saturated(out, bias, out_dtype)


def dequant_matmul_int_split_plain(A: torch.Tensor, qweight: torch.Tensor,
                                   w_dtype: str, scales=None, zeros=None,
                                   group: int = -1, bias=None,
                                   zeros_mode: str = "original",
                                   out_dtype=torch.float32,
                                   sms: int = H100_SMS) -> torch.Tensor:
    """The decode instance's arithmetic in plain PyTorch (any device): the
    splits `plan_splits_k_int` gives; in each, the stored codes f against
    A in int32, less 2^(bits-1) sum A for the int family (sum (f - b) a =
    sum f a - b sum a). Unscaled: the int32 partials summed in split
    order. Scaled: each run of a group within the split (a segment) gives
    d = its int32 sum and r = its sum of A, and the split's f32 partial
    adds float(d) s (zeros: (float(d) - float(r) z) s; rescale: float(d) s
    - float(r) z) segment by segment; the partials summed in split order
    0, 1, ... in f32. Then the bias and the saturating cast. Only the
    tests call it."""
    M, K = A.shape
    N = qweight.shape[0]
    family, bits = source_format_and_bits(w_dtype)
    chunk, splits = plan_splits_k_int(M, N, K, bits, sms)
    f = packing.unpack_k(qweight, bits)                   # [N, K] codes
    b = 1 << (bits - 1) if family == "int" else 0
    g = K if group in (-1, None) else group
    span = chunk * (512 // bits)

    def segment(k0, k1):
        a = A[:, k0:k1]
        r = a.to(torch.int32).sum(dim=1, keepdim=True)
        return matmul_dense_reference(a, f[:, k0:k1], torch.int32) - b * r, r

    if scales is None:
        out = torch.zeros((M, N), dtype=torch.int32, device=A.device)
        for sp in range(splits):
            out = out + segment(sp * span, min((sp + 1) * span, K))[0]
        return _saturated(out, bias, out_dtype)
    out = torch.zeros((M, N), dtype=torch.float32, device=A.device)
    for sp in range(splits):
        part = torch.zeros_like(out)
        k, end = sp * span, min((sp + 1) * span, K)
        while k < end:
            k1 = min(end, (k // g + 1) * g)
            d, r = segment(k, k1)
            d, r = d.float(), r.float()
            s = scales[k // g].float()[None]
            if zeros is None:
                v = d * s
            elif zeros_mode == "rescale":
                v = d * s - r * zeros[k // g].float()[None]
            else:
                v = (d - r * zeros[k // g].float()[None]) * s
            part = part + v
            k = k1
        out = out + part
    return _saturated(out, bias, out_dtype)


def _check_int(A, qweight, w_dtype, scales, zeros, group, bias, zeros_mode,
               out_dtype):
    fmt = f"{w_dtype}xint8"
    if fmt not in INT_FORMATS:
        raise NotImplementedError(f"dequant_matmul_int does not run "
                                  f"{w_dtype} x int8")
    if A.dtype != torch.int8:
        raise ValueError(f"A must be int8, got {A.dtype}")
    if out_dtype not in _INT_OUT or (out_dtype == torch.int32
                                     and scales is not None):
        raise ValueError(f"out_dtype {out_dtype}: float32, float16, int8, "
                         f"or int32 without scales")
    return (fmt, *_check_quant(A, qweight, w_dtype, scales, zeros, group,
                               bias, zeros_mode, torch.float16))


def int_variant(fmt: str, kind: str, group: int, K: int, scaled: bool,
                zeros_mode, bias: bool, out_dtype: torch.dtype) -> str:
    """The name of a dequant_matmul_int launch's instance and options, as
    `variant_launches` counts it: "uint4xint8 decode g128 zeros int8",
    "int1xint8 tiled unscaled int32", ... (zeros_mode None: no zeros)."""
    g = ("unscaled" if not scaled else "per_channel" if group == K
         and group > GROUP else f"g{group}")
    z = [] if zeros_mode is None else \
        ["rescale" if zeros_mode == "rescale" else "zeros"]
    return " ".join([fmt, kind, g] + z + (["bias"] if bias else [])
                    + [str(out_dtype).split(".")[-1]])


def dequant_matmul_int(A: torch.Tensor, qweight: torch.Tensor, w_dtype: str,
                       scales=None, zeros=None, group: int = -1, tile=None,
                       bias=None, zeros_mode: str = "original",
                       out_dtype=torch.float32) -> torch.Tensor:
    """out [M, N] in `out_dtype` (float32, float16, int32 without scales,
    or int8) for a `w_dtype` weight (uint1/2/4, int1/2/4) under int8
    activations; see the module docstring for the layout. `scales` (and,
    for the uint family, `zeros`) [K/g, N] float16 or None; `group` g (-1:
    per channel); `tile` one of FUSED_TILES[f"{w_dtype}xint8"] (default:
    default_tile); `bias` float32 [N] or [1, N]; `zeros_mode` "original"
    ((w - z) s) or "rescale" (w s - z)."""
    fmt, g, bits = _check_int(A, qweight, w_dtype, scales, zeros, group,
                              bias, zeros_mode, out_dtype)
    tile = _tile(fmt, A.shape[0], tile)
    if A.device.type == "cpu":
        return dequant_matmul_int_plain(A, qweight, w_dtype, scales, zeros,
                                        g, bias, zeros_mode, out_dtype)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    M, K = A.shape
    N = qweight.shape[0]
    mode = 0 if scales is None else 1 if zeros is None else \
        3 if zeros_mode == "rescale" else 2
    ptrs = [A.data_ptr(), qweight.data_ptr(),
            scales.data_ptr() if scales is not None else 0,
            zeros.data_ptr() if zeros is not None else 0,
            bias.data_ptr() if bias is not None else 0]
    out = torch.empty((M, N), dtype=out_dtype, device=A.device)
    if M == 0:
        return out
    decode = tile == FUSED_TILES[fmt][0]
    source = int_source(w_dtype)
    kind = "decode" if decode else "tiled"
    symbol = f"dqi_{source[len('dequant_int_'):]}_{kind}"
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if decode:
            chunk, splits = plan_splits_k_int(M, N, K, bits,
                                              scratch.sm_count(A.device))
            part = count = None
            if splits > 1:
                part = scratch.partials(
                    A.device, splits * M * N,
                    torch.int32 if scales is None else torch.float32)
                count = scratch.counters(
                    A.device, -(-N // DECODE_BN) * -(-M // DECODE_BM))
            fn = build.entry(source, symbol, _ARGTYPES_INT_DECODE)
            err = fn(mode, *ptrs, out.data_ptr(), _INT_OUT[out_dtype],
                     part.data_ptr() if part is not None else 0,
                     count.data_ptr() if count is not None else 0, M, N, K,
                     g, chunk, splits, stream)
        else:
            fn = build.entry(source, symbol, _ARGTYPES_INT_TILED)
            err = fn(mode, *ptrs, out.data_ptr(), _INT_OUT[out_dtype], M, N,
                     K, g, stream)
    build.check(err, f"dequant_matmul_int {fmt}")
    dequant_matmul_int.launches += 1
    if decode:
        dequant_matmul_int.decode_launches += 1
    else:
        dequant_matmul_int.tiled_launches += 1
    for counts, key in (
            (dequant_matmul_int.format_launches, fmt),
            (dequant_matmul_int.variant_launches,
             int_variant(fmt, kind, g, K, scales is not None,
                         None if zeros is None else zeros_mode,
                         bias is not None, out_dtype))):
        counts[key] = counts.get(key, 0) + 1
    return out


dequant_matmul_int.launches = 0
# among them, the decode instance's and the tiled instance's launches; and
# every launch by format ("uint4xint8") and by instance and options
# (int_variant)
dequant_matmul_int.decode_launches = 0
dequant_matmul_int.tiled_launches = 0
dequant_matmul_int.format_launches = {}
dequant_matmul_int.variant_launches = {}

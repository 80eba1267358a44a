"""Flash attention for prefill and decode (counterpart of
bitblas_tpu/kernels/flash.py: make_flash_attention, make_flash_decode,
make_flash_decode_quant, make_flash_decode_paged and
make_flash_decode_paged_quant).

* `flash_attention_fwd` -- prefill over Q [B, S, H, D] and K/V [B, S,
  Hkv, D] (or K^T [B, D, Hkv, S]: trans_k, JAX's "ntn"), causal or dense,
  any S, all float16, bfloat16 or float32, out in float16, bfloat16 or
  float32, with an optional sliding window, at any head dim up to
  `GENERAL_MAX_HEAD_DIM`. A fixed rule on the shape (`prefill_instance`)
  picks the instance: csrc/flash_attention.cuh (wgmma + TMA, one source a
  head dim of `HEAD_DIMS`) where TMA can address the rows, the same
  instance behind a layout pass (`prefill_layout`: rows padded to 16
  bytes, K^T's key rows too) where only a stride stops it,
  csrc/flash_attention_general.cu (wgmma + TMA, the head dim split over
  warpgroups) for the other 16-bit head dims, and
  csrc/flash_attention_f32.cu for float32.
* `flash_decode` -- one query token per sequence against the slot cache
  [rows, Smax, Hkv, D] bfloat16 through `slots` and `lengths`, with an
  optional sliding window (csrc/flash_decode.cu).
* `flash_decode_quant` -- the same against the int8 slot cache and its
  f32 scales [rows, Smax, Hkv] (csrc/flash_decode_quant.cu).
* `flash_decode_paged` / `flash_decode_paged_quant` -- the same against
  the block pool [blocks, bs, Hkv, D] (bfloat16, or int8 with scale planes
  [blocks, bs, Hkv]) through block tables [B, MB]
  (csrc/flash_decode_paged{,_quant}.cu).

Each wrapper runs its CUDA kernel on CUDA tensors and its plain PyTorch
version (`*_plain`) on CPU tensors. Decode queries (and outputs) are
float16 or bfloat16, as the JAX kernels take any query type. The
plain decode versions take any head dim and GQA group; the decode
kernels take head dims D % 128 == 0 up to `DECODE_MAX_HEAD_DIM` (128 and
256 on instances of their own, `DECODE_HEAD_DIMS`; above 256 the wide
instances, in slices of 128 output columns) and any group (above 8 in
chunks of 8 query heads), and the two float decode kernels bfloat16 or
float16 caches. On the card
a shape no kernel instance takes raises. The decode kernels split each
sequence's keys into chunks across blocks (`plan_splits`, from static
sizes only) and merge the chunks' partials in the same launch;
`flash_decode_split_plain` is that arithmetic in plain PyTorch, for the
tests. A sliding window (HF convention: prefill row i attends keys (i -
window, i]; the decode query at position len - 1 attends [max(len -
window, 0), len)) runs in kernels 4, 5 and 6, as in the JAX package; the
paged kernels have none there either.

`flash_decode` and `flash_decode_quant` take ``partial_stats=True`` (the
JAX kernels' option, flash.py:476-483): they then return the merged
online-softmax state of the sequence's keys, (acc [B, H, D] f32
unnormalised, m [B, H] f32 in the natural-log domain, l [B, H] f32), for
context parallelism's log-sum-exp merge across sequence shards
(serving/kv_cache.py's *_partial attends). `lengths` are then the valid
keys of this shard; a length of 0 gives acc 0, m = -1e30 ln 2 and l 0, so
the merge weighs the shard 0. No window, as JAX's context parallelism
takes none. On the card they launch the same kernels through their own
entry points (`flash_decode_partial`, `flash_decode_quant_partial`, each
counting its launches); `flash_decode_partial_plain` is the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import build, scratch

LOG2E = 1.4426950408889634
# the wgmma prefill instances' head dims, one csrc source each (csrc/
# flash_attention.cuh); the general instance and the float32 kernel (3xTF32
# on the tensor cores) take any D up to GENERAL_MAX_HEAD_DIM
HEAD_DIMS = (64, 80, 96, 100, 128, 256)
_PREFILL_SOURCES = {64: "flash_attention_d64", 80: "flash_attention_d80",
                    96: "flash_attention_d96", 100: "flash_attention_d100",
                    128: "flash_attention", 256: "flash_attention_d256"}
# csrc/flash_attention_general.cu's and flash_attention_f32.cu's
# kMaxHeadDim: a tile of the whole head dim (Q, or K and V split into
# their TF32 halves) fills a block's shared memory there
GENERAL_MAX_HEAD_DIM = 768
# (block_q, block_kv), FlashHint's: 64 q rows a block, 64- or 128-key tiles
PREFILL_TILES = ((64, 64), (64, 128))
# the head dims that build 128-key tiles (csrc/flash_attention.cuh kKv128)
KV128_HEAD_DIMS = (64,)
PREFILL_DTYPES = (torch.float16, torch.bfloat16, torch.float32)
DECODE_HEAD_DIMS = (128, 256)   # the decode head dims with own instances
# the decode kernels take D % 128 == 0 up to this (csrc/flash_decode.cuh
# kMaxHeadDim); above 256 in slices of DECODE_SLICE output columns
DECODE_MAX_HEAD_DIM = 1024
DECODE_SLICE = 128
MAX_GROUP = 8       # query rows a decode block holds: larger groups chunk
MAX_GRID_Y = 65535  # Hkv * ceil(group / MAX_GROUP) rides the grid's y axis
DECODE_TILE = 64    # keys a decode tile; a split's chunk is a multiple
H100_SMS = 132      # SMs of an H100 SXM, the split planner's default
SPLIT_BLOCKS_PER_SM = 2   # the planner's target: B * Hkv * splits >= 2 SMs
MAX_SPLITS = 1024   # the kernels' merge holds at most this many weights

# prefill: Q, K, V, O, then B, S, H, Hkv, D, bf16, out code, causal,
# trans_k, block_kv, window, the row pitches of Q, K (K^T: of its key rows)
# and V, the head stride (float32: no bf16 flag, no block_kv, no pitches)
_PREFILL_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 \
    + [ctypes.c_float, ctypes.c_void_p]
_PREFILL_F32_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_void_p]
# the general instance: Q, K, V, O, then B, S, H, Hkv, the tensors' head
# dim, O's, bf16, out code, causal, window, the three row pitches
_PREFILL_GENERAL_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 \
    + [ctypes.c_float, ctypes.c_void_p]
# the instances of kernel 4 (`prefill_instance`); "aligned" runs the
# wgmma instances behind `prefill_layout`'s copy
PREFILL_INSTANCES = ("wgmma", "aligned", "general", "f32")
_OUT_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
QUERY_DTYPES = (torch.float16, torch.bfloat16)   # the decode kernels' q
# decode entry points: q, caches (scales), index, lengths, out, the split
# scratch and counters, then ints (sizes, chunk, splits, head dim, for the
# float caches whether they are float16, whether q is bfloat16, for the
# slot caches the window)
_DECODE_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
    + [ctypes.c_float, ctypes.c_void_p]
_DECODE_QUANT_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_void_p]
# partial_stats: the slot entry points with acc and ml in place of out and
# no window
_DECODE_PARTIAL_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_void_p]
_DECODE_QUANT_PARTIAL_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 \
    + [ctypes.c_float, ctypes.c_void_p]
LN2 = 0.6931471805599453
EMPTY_M = -1e30     # a shard with no live key: m = EMPTY_M * ln 2
_DECODE_PAGED_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
    + [ctypes.c_float, ctypes.c_void_p]
_DECODE_PAGED_QUANT_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_void_p]


def _require(t: torch.Tensor, name: str, dtype, shape, device,
             align: int = 16):
    """Type, shape, device, contiguity and alignment (16 bytes for what
    the kernels read with 16-byte loads, 4 for scalar reads)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         f"aligned")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _check_window(window: Optional[int]) -> None:
    if window is not None and (isinstance(window, bool)
                               or int(window) != window or window < 1):
        raise ValueError(f"window must be None or an int >= 1, got "
                         f"{window!r}")


def _name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _tma_rows(heads: int, D: int) -> bool:
    """Whether TMA can address a token row of `heads` heads of D 2-byte
    elements: a row stride that is a multiple of 16 bytes."""
    return (heads * D * 2) % 16 == 0


def prefill_instance(S: int, H: int, Hkv: int, D: int, dtype: torch.dtype,
                     *, trans_k: bool = False) -> str:
    """The instance of kernel 4 that runs a shape, by a fixed rule:
    "f32" (csrc/flash_attention_f32.cu) for float32; at the 16-bit head
    dims of `HEAD_DIMS`, "wgmma" (csrc/flash_attention.cuh) where TMA can
    address the tensors as they are -- rows of heads * D 2-byte elements a
    multiple of 16 bytes (D % 8 == 4 needs an even H and Hkv) and, with
    trans_k, key rows of S % 8 == 0 -- else "aligned": the same instance
    behind `prefill_layout`'s copy with its rows padded to 16 bytes; for
    the other 16-bit head dims "general" (csrc/flash_attention_general.cu).
    The general and float32 kernels take head dims up to
    `GENERAL_MAX_HEAD_DIM`."""
    if dtype == torch.float32:
        return "f32"
    if D in HEAD_DIMS:
        if _tma_rows(H, D) and _tma_rows(Hkv, D) and not (trans_k and S % 8):
            return "wgmma"
        return "aligned"
    return "general"


def _rows_into(x: torch.Tensor, D: int, pitch: int) -> torch.Tensor:
    """x [B, S, n, d] as a [B, S, pitch] buffer holding each head's d
    columns zero-padded to D (x itself where nothing changes)."""
    B, S, n, d = x.shape
    if d == D and pitch == n * D and x.is_contiguous():
        return x
    buf = x.new_zeros((B, S, pitch)) if d != D else \
        x.new_empty((B, S, pitch))
    buf[..., :n * D].view(B, S, n, D)[..., :d].copy_(x)
    return buf


def _pitch(n: int) -> int:
    """A row of n 2-byte elements rounded up to 16 bytes."""
    return -(-n // 8) * 8


def prefill_layout(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, *,
                   trans_k: bool = False, instance: Optional[str] = None):
    """The layout pass in front of the 16-bit instances (JAX's pad shim,
    kernels/flash.py:122-150, does the same for its kernel): Q [B, S, H,
    D], K [B, S, Hkv, D] (K^T [B, D, Hkv, S] with trans_k) and V ->
    (q, k, v, Dk, hs, pitches, trans_k'): the tensors the instance reads
    at its head dim Dk, each head hs >= Dk columns of a token row, the
    rows' pitches in elements and whether k is K^T. "wgmma" takes the
    tensors as they are; "aligned" copies only what TMA cannot address:
    rows of odd head counts at D % 8 == 4 into rows padded to 16 bytes,
    each head zero-padded to a multiple of 16 columns (so that the last
    k16 step of QK^T reads zeros, not the next head), and K^T's key rows
    to S % 8 == 0; "general" zero-pads the head dim to a multiple of 16 and takes K^T
    transposed into K's layout. The scale stays 1/sqrt of the true D and
    O keeps D columns: zero columns add nothing to q . k."""
    B, S, H, D = Q.shape
    Hkv = V.shape[2]
    if instance is None:
        instance = prefill_instance(S, H, Hkv, D, Q.dtype, trans_k=trans_k)
    if instance == "aligned":
        if _tma_rows(H, D) and _tma_rows(Hkv, D):
            hs, q, v, pq, pv = D, Q, V, H * D, Hkv * D
        else:
            hs = -(-D // 16) * 16
            pq, pv = _pitch(H * hs), _pitch(Hkv * hs)
            q, v = _rows_into(Q, hs, pq), _rows_into(V, hs, pv)
        if trans_k:
            pk = _pitch(S)
            k = K
            if pk != S:
                k = K.new_empty((B, D, Hkv, pk))
                k[..., :S].copy_(K)
        else:
            pk = pv
            k = K if hs == D else _rows_into(K, hs, pk)
        return q, k, v, D, hs, (pq, pk, pv), trans_k
    if instance == "general":
        Dk = -(-D // 16) * 16
        pq, pkv = _pitch(H * Dk), _pitch(Hkv * Dk)
        Kr = K.permute(0, 3, 2, 1) if trans_k else K
        return (_rows_into(Q, Dk, pq), _rows_into(Kr, Dk, pkv),
                _rows_into(V, Dk, pkv), Dk, Dk, (pq, pkv, pkv), False)
    return Q, K, V, D, D, (H * D, S if trans_k else Hkv * D, Hkv * D), \
        trans_k


def prefill_refusal(S: int, H: int, Hkv: int, D: int, dtype: torch.dtype,
                    *, causal: bool = True, trans_k: bool = False,
                    window: Optional[int] = None) -> Optional[str]:
    """Why kernel 4 does not take this shape, or None where it does: what
    JAX's make_flash_attention refuses (a window without causality), and
    head dims past the general and float32 kernels' shared memory."""
    if window is not None and not causal:
        return "a sliding window requires causal=True"
    if D > GENERAL_MAX_HEAD_DIM:
        return (f"head dims up to {GENERAL_MAX_HEAD_DIM} (the cap of the "
                f"general and float32 instances: Q and a K tile of the "
                f"whole head dim in shared memory)")
    return None


def check_prefill(B: int, S: int, H: int, Hkv: int, D: int,
                  dtype: torch.dtype, out_dtype: torch.dtype, *,
                  causal: bool = True, trans_k: bool = False,
                  window: Optional[int] = None, tile=None):
    """Raise on what kernel 4 does not take, on every device (the plain
    version takes the same shapes): ValueError on sizes or types no
    attention has, NotImplementedError with `prefill_refusal`'s reason.
    Returns the (block_q, block_kv) tile a launch runs: `tile`, or the
    default of tuner/curated's flash_block_hint for (S, D, causal)."""
    _check_window(window)
    shape = (f"B={B} S={S} H={H} Hkv={Hkv} D={D} {_name(dtype)} -> "
             f"{_name(out_dtype)}, causal={causal}, trans_k={trans_k}")
    if min(B, S, H, Hkv, D) < 1 or H % Hkv:
        raise ValueError(f"flash_attention_fwd: sizes must be positive "
                         f"and H a multiple of Hkv ({shape})")
    if dtype not in PREFILL_DTYPES or out_dtype not in PREFILL_DTYPES:
        raise ValueError(f"flash_attention_fwd: operands and output are "
                         f"float16, bfloat16 or float32 ({shape})")
    why = prefill_refusal(S, H, Hkv, D, dtype, causal=causal,
                          trans_k=trans_k, window=window)
    if why is not None:
        raise NotImplementedError(f"flash_attention_fwd: {why} ({shape})")
    instance = prefill_instance(S, H, Hkv, D, dtype, trans_k=trans_k)
    tiles = prefill_tiles(D, dtype, instance)
    if tile is None:
        from ..tuner.curated import flash_block_hint
        tile = flash_block_hint(S, D, causal)
        if tile not in tiles:     # one tile, whatever the hint
            tile = tiles[0]
    tile = tuple(int(x) for x in tile)
    if tile not in tiles:
        raise ValueError(f"flash_attention_fwd: tile {tile} is not one of "
                         f"{tiles} ({shape})")
    return tile


def prefill_tiles(D: int, dtype: torch.dtype = torch.float16,
                  instance: str = "wgmma"):
    """The (block_q, block_kv) tiles of kernel 4's `instance`
    (`prefill_instance`) at head dim D: 128-key tiles on the wgmma
    instances (also behind the layout pass) at `KV128_HEAD_DIMS` only; the
    float32 kernel and the general instance fix their tiles by head dim,
    and `PREFILL_TILES[0]` stands for them."""
    if instance in ("wgmma", "aligned") \
            and dtype != torch.float32 and D in KV128_HEAD_DIMS:
        return PREFILL_TILES
    return PREFILL_TILES[:1]


def flash_attention_plain(Q: torch.Tensor, K: torch.Tensor,
                          V: torch.Tensor, window: Optional[int] = None, *,
                          causal: bool = True, trans_k: bool = False,
                          out_dtype: Optional[torch.dtype] = None,
                          tile=None) -> torch.Tensor:
    """Plain attention with the kernel's arithmetic: Q folded into the
    base-2 domain and rounded to Q's dtype, f32 scores and softmax, output
    cast to `out_dtype` (Q's by default). K is [B, S, Hkv, D], or K^T [B,
    D, Hkv, S] with `trans_k`. Keys run to the tile's multiple of S as
    the kernel's do: keys >= S are masked and their V rows zeroed
    (flash.py:44-47). `causal`: row i attends keys <= i; with a `window`
    keys (i - window, i] (every row keeps its own key)."""
    _check_window(window)
    return _attention_plain(Q, K, V, window, causal, trans_k, out_dtype,
                            tile, Q.shape[3])


def _attention_plain(Q, K, V, window, causal, trans_k, out_dtype, tile,
                     true_d: int) -> torch.Tensor:
    """`flash_attention_plain` with the scale of head dim `true_d` (the
    layout pass's zero columns leave it at the true D's)."""
    if trans_k:
        K = K.permute(0, 3, 2, 1)
    B, S, H, D = Q.shape
    group = H // K.shape[2]
    block_kv = (tile or PREFILL_TILES[0])[1]
    pad = -S % block_kv
    q = (Q.float() * (LOG2E / math.sqrt(true_d))).to(Q.dtype).float()
    k = F.pad(K.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(group, 2)
    v = F.pad(V.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(group, 2)
    key = torch.arange(S + pad, device=Q.device)
    live = key < S
    v = torch.where(live[None, :, None, None], v,
                    torch.zeros((), device=v.device))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    keep = live[None].expand(S, S + pad)
    row = torch.arange(S, device=Q.device)[:, None]
    if causal:
        keep = keep & (key[None] <= row)
    if window is not None:
        keep = keep & (key[None] > row - window)
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v) \
        / p.sum(dim=-1).permute(0, 2, 1)[..., None]
    return out.to(out_dtype or Q.dtype)


def prefill_routed_plain(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                         window: Optional[int] = None, *, causal: bool = True,
                         trans_k: bool = False,
                         out_dtype: Optional[torch.dtype] = None, tile=None,
                         instance: Optional[str] = None) -> torch.Tensor:
    """The plain form of a 16-bit instance's route: `prefill_layout`'s
    tensors (read back through their row pitches), attention at the
    instance's head dim with the true D's scale
    (`flash_attention_plain`'s arithmetic), then O's first D columns."""
    _check_window(window)
    B, S, H, D = Q.shape
    Hkv = V.shape[2]
    q, k, v, Dk, hs, (pq, pk, pv), tk = prefill_layout(
        Q, K, V, trans_k=trans_k, instance=instance)

    def rows(x, n, pitch):
        return x.as_strided((B, S, n, Dk), (S * pitch, pitch, hs, 1))
    q, v = rows(q, H, pq), rows(v, Hkv, pv)
    k = k.as_strided((B, Dk, Hkv, S), (Dk * Hkv * pk, Hkv * pk, pk, 1)) \
        if tk else rows(k, Hkv, pk)
    out = _attention_plain(q, k, v, window, causal, tk, out_dtype, tile, D)
    return out[..., :D].contiguous()


def _variant(dtype: torch.dtype, window: Optional[int], D: int = 128) -> str:
    """A decode launch's variant as `variant_launches` counts it: the query
    type, the head dim where it is not 128, then the window: "float16",
    "bfloat16 window", "float16 d512", ..."""
    return _name(dtype) + ("" if D == 128 else f" d{D}") \
        + ("" if window is None else " window")


def prefill_variant(dtype: torch.dtype, D: int, *, causal: bool = True,
                    trans_k: bool = False, window: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    block_kv: int = 64,
                    instance: Optional[str] = None) -> str:
    """A prefill launch's variant as `variant_launches` counts it: the
    operand type, then what differs from the causal D = 128 launch of the
    wgmma instance on 64-key tiles: the instance where it is not "wgmma" or
    "f32" ("aligned", "general"), "d100" (head dim), "nc" (not causal), "ntn" (K^T), "window",
    "out float32" (the output type), "kv128" (the tile), e.g. "float16
    d100", "bfloat16 d80 window", "float16 general d512", "float16 aligned
    d128 ntn", "float32 d64 nc ntn out float16"."""
    parts = [_name(dtype)]
    if instance not in (None, "wgmma", "f32"):
        parts.append(instance)
    if D != 128:
        parts.append(f"d{D}")
    if not causal:
        parts.append("nc")
    if trans_k:
        parts.append("ntn")
    if window is not None:
        parts.append("window")
    if out_dtype is not None and out_dtype != dtype:
        parts.append(f"out {_name(out_dtype)}")
    if block_kv != 64 and dtype != torch.float32:
        parts.append(f"kv{block_kv}")
    return " ".join(parts)


def _count(wrapper, key: str) -> None:
    wrapper.launches += 1
    wrapper.variant_launches[key] = wrapper.variant_launches.get(key, 0) + 1


def flash_attention_fwd(Q: torch.Tensor, K: torch.Tensor,
                        V: torch.Tensor, window: Optional[int] = None, *,
                        causal: bool = True, trans_k: bool = False,
                        out_dtype: Optional[torch.dtype] = None,
                        tile=None) -> torch.Tensor:
    """Attention, Q [B, S, H, D] x K [B, S, Hkv, D] (K^T [B, D, Hkv, S]
    with `trans_k`) x V [B, S, Hkv, D] -> [B, S, H, D] in `out_dtype`
    (Q's type by default). Q, K and V are all float16, bfloat16 or
    float32; outputs float16, bfloat16 or float32; any head dim up to
    `GENERAL_MAX_HEAD_DIM`, on the instance `prefill_instance` names; any
    S >= 1. `causal` (default) or dense; with causality a `window`: row i
    attends keys (i - window, i], and a window >= S is no window. `tile`:
    a FlashHint's (block_q, block_kv), one of the instance's
    `prefill_tiles`; None takes tuner/curated's flash_block_hint where the
    instance has that tile. What kernel 4 does not take raises, with the
    shape (`check_prefill`), on the CPU too."""
    if Q.dim() != 4 or K.dim() != 4:
        raise ValueError(f"Q and K must be 4-D, got {tuple(Q.shape)}, "
                         f"{tuple(K.shape)}")
    B, S, H, D = Q.shape
    Hkv = K.shape[2]
    out_dtype = out_dtype or Q.dtype
    tile = check_prefill(B, S, H, Hkv, D, Q.dtype, out_dtype, causal=causal,
                         trans_k=trans_k, window=window, tile=tile)
    _require(Q, "Q", Q.dtype, (B, S, H, D), Q.device)
    _require(K, "K", Q.dtype, (B, D, Hkv, S) if trans_k else (B, S, Hkv, D),
             Q.device)
    _require(V, "V", Q.dtype, (B, S, Hkv, D), Q.device)
    if window is not None and window >= S:
        window = None
    if Q.device.type == "cpu":
        return flash_attention_plain(Q, K, V, window, causal=causal,
                                     trans_k=trans_k, out_dtype=out_dtype,
                                     tile=tile)
    if Q.device.type != "cuda":
        raise ValueError(f"unsupported device {Q.device}")
    instance = prefill_instance(S, H, Hkv, D, Q.dtype, trans_k=trans_k)
    out = _prefill_launch(Q, K, V, window, causal, trans_k, out_dtype, tile,
                          instance)
    _count(flash_attention_fwd, prefill_variant(
        Q.dtype, D, causal=causal, trans_k=trans_k, window=window,
        out_dtype=out_dtype, block_kv=tile[1], instance=instance))
    return out


def _prefill_launch(Q, K, V, window, causal, trans_k, out_dtype, tile,
                    instance) -> torch.Tensor:
    """One launch of kernel 4's `instance` on CUDA tensors (checked by
    `flash_attention_fwd`), behind `prefill_layout` for the 16-bit ones."""
    B, S, H, D = Q.shape
    Hkv = V.shape[2]
    out = torch.empty((B, S, H, D), dtype=out_dtype, device=Q.device)
    scale = LOG2E / math.sqrt(D)
    bf16 = int(Q.dtype == torch.bfloat16)
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if instance == "f32":
            fn = build.entry("flash_attention_f32", "flash_attention_f32",
                             _PREFILL_F32_ARGS)
            err = fn(Q.data_ptr(), K.data_ptr(), V.data_ptr(),
                     out.data_ptr(), B, S, H, Hkv, D, _OUT_CODES[out_dtype],
                     int(causal), int(trans_k), window or 0, scale, stream)
            build.check(err, "flash_attention_fwd")
            return out
        q, k, v, Dk, hs, pitch, tk = prefill_layout(
            Q, K, V, trans_k=trans_k, instance=instance)
        if instance == "general":
            fn = build.entry("flash_attention_general",
                             "flash_attention_general", _PREFILL_GENERAL_ARGS)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, S, H, Hkv, Dk, D, bf16,
                     _OUT_CODES[out_dtype], int(causal), window or 0, *pitch,
                     scale, stream)
        else:
            dst = out if Dk == D else torch.empty(
                (B, S, H, Dk), dtype=out_dtype, device=Q.device)
            fn = build.entry(_PREFILL_SOURCES[Dk],
                             f"flash_attention_fwd_d{Dk}", _PREFILL_ARGS)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     dst.data_ptr(), B, S, H, Hkv, Dk, bf16,
                     _OUT_CODES[out_dtype], int(causal), int(tk), tile[1],
                     window or 0, *pitch, hs, scale, stream)
            if dst is not out:
                out.copy_(dst[..., :D])
    build.check(err, "flash_attention_fwd")
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.variant_launches = {}


# ---------------------------------------------------------------------------
# Decode: one query token per sequence against the slot cache or the block
# pool, bf16 or int8 (csrc/flash_decode.cuh holds the one kernel body)
# ---------------------------------------------------------------------------

def _attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Length-masked decode attention in f32 with the kernels' arithmetic.
    q [B, H, D]; k/v [B, L, Hkv, D] gathered rows; valid [B, L]; scales
    [B, L, Hkv] for int8 codes. Rows not valid get -inf scores and zero V
    and V scale (stale rows may hold anything, NaN included); a sequence
    with no valid row yields 0."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    zero = torch.zeros((), device=q.device)
    v = torch.where(valid[:, :, None, None], v.float(), zero)
    qf = q.float().reshape(B, Hkv, group, D) * (LOG2E / math.sqrt(D))
    s = torch.einsum("bhgd,blhd->bhgl", qf, k.float())
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), float("-inf"), device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, zero)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        vsc = torch.where(valid[..., None], v_scale.float(), zero)
        p = p * vsc.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhgl,blhd->bhgd", p, v) / l.clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _live(span: int, lengths: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """[B, span] mask of the keys the query at position lengths - 1
    attends: below each length and, with a window, at or above length -
    window."""
    pos = torch.arange(span, device=lengths.device)[None]
    keep = pos < lengths[:, None]
    if window is not None:
        keep = keep & (pos >= lengths[:, None] - window)
    return keep


def _slot_rows(slots: torch.Tensor, lengths: torch.Tensor, *caches,
               window: Optional[int] = None):
    """Each cache [rows, Smax, ...] gathered to its sequences' rows
    [B, Smax, ...], then the [B, Smax] mask of the live keys (`_live`)."""
    rows = [c[slots.long()] for c in caches]
    return (*rows, _live(caches[0].shape[1], lengths, window))


def _page_rows(tables: torch.Tensor, lengths: torch.Tensor, *pools,
               window: Optional[int] = None):
    """Each block pool [blocks, bs, ...] gathered through tables [B, MB]
    into [B, MB * bs, ...] (the table gather), then the mask of the live
    keys (`_live`)."""
    B, MB = tables.shape
    rows = [p[tables.long()].reshape(B, MB * p.shape[1], *p.shape[2:])
            for p in pools]
    return (*rows, _live(rows[0].shape[1], lengths, window))


def decode_span(span: int, window: Optional[int]) -> int:
    """The keys a sequence's splits cover: its whole span (Smax, or
    max_blocks * bs), or with a window the live band plus the tile that
    holds its first key, min(span, window + 64)."""
    return span if window is None else min(span, window + DECODE_TILE)


def plan_splits(span: int, batch: int, kv_heads: int,
                sms: int = H100_SMS):
    """(chunk, splits) of the split-KV decode kernels, from static sizes
    only: the span a sequence's splits cover (`decode_span`), B, Hkv and
    the SM count -- never from the lengths, which live on the card.
    chunk is a multiple of the 64-key tile; splits = ceil(span / chunk) <=
    MAX_SPLITS and B * Hkv * splits reaches 2 * sms wherever the span has
    enough tiles. Split s covers keys [base + s * chunk, base + (s + 1) *
    chunk), base = 64 floor(max(len - window, 0) / 64) with a window and 0
    without."""
    if min(span, batch, kv_heads, sms) < 1:
        raise ValueError(f"plan_splits: sizes must be positive, got span "
                         f"{span}, B {batch}, Hkv {kv_heads}, sms {sms}")
    tiles = -(-span // DECODE_TILE)
    want = -(-SPLIT_BLOCKS_PER_SM * sms // (batch * kv_heads))
    chunk = DECODE_TILE * max(1, tiles // want, -(-tiles // MAX_SPLITS))
    return chunk, -(-span // chunk)


def _split_partials_plain(q, k, v, valid, chunk, k_scale=None,
                          v_scale=None, slices: int = 1):
    """Each chunk's partial in the kernels' arithmetic: the unnormalised
    f32 accumulator acc [B, Hkv, splits, group, D], the base-2 max m and
    the sum l [B, Hkv, splits, group] (m = -inf, l = 0, acc = 0 for a chunk
    with no live key). Arguments as `_attend_plain`'s; with `slices` > 1
    the scores are the wide instances' cluster sum: each slice of D /
    slices columns dots its own columns, and the partial scores add up in
    slice order."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    splits = -(-L // chunk)
    pad = splits * chunk - L
    zero = torch.zeros((), device=q.device)
    if pad:
        grow = (lambda x: torch.cat(
            [x, torch.zeros((B, pad, *x.shape[2:]), dtype=x.dtype,
                            device=x.device)], dim=1))
        k, v, valid = grow(k), grow(v), grow(valid)
        k_scale = grow(k_scale) if k_scale is not None else None
        v_scale = grow(v_scale) if v_scale is not None else None
    v = torch.where(valid[:, :, None, None], v.float(), zero)
    qf = q.float().reshape(B, Hkv, group, D) * (LOG2E / math.sqrt(D))
    kf = torch.where(valid[:, :, None, None], k.float(), zero)
    w = D // slices
    s = torch.einsum("bhgd,blhd->bhgl", qf[..., :w], kf[..., :w])
    for sl in range(1, slices):
        cols = slice(sl * w, (sl + 1) * w)
        s = s + torch.einsum("bhgd,blhd->bhgl", qf[..., cols], kf[..., cols])
    if k_scale is not None:
        ks = torch.where(valid[..., None], k_scale.float(), zero)
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), float("-inf"), device=s.device))
    s = s.reshape(B, Hkv, group, splits, chunk).transpose(2, 3)
    m = s.amax(dim=-1)                                 # [B, Hkv, sp, g]
    m_use = torch.where(torch.isfinite(m), m, zero)
    p = torch.exp2(s - m_use[..., None])
    l = p.sum(dim=-1)
    if v_scale is not None:
        vsc = torch.where(valid[..., None], v_scale.float(), zero)
        p = p * vsc.permute(0, 2, 1).reshape(B, Hkv, 1, splits, chunk) \
            .transpose(2, 3)
    vv = v.reshape(B, splits, chunk, Hkv, D)
    acc = torch.einsum("bhsgc,bschd->bhsgd", p, vv)
    return acc, m, l


def _merge_partials_plain(acc, m, l, lengths, chunk, stats: bool = False):
    """The kernels' merge: the live splits of each (sequence, KV head)
    (s * chunk < length, the length counted from the splits' base) by
    log-sum-exp in split order; a split whose keys are all masked (m =
    -inf) weighs 0, and a sequence of length 0 gives 0. -> [B, H, D]
    f32, or with `stats` the partial_stats triple (acc unnormalised
    [B, H, D], m [B, H] in the natural-log domain, EMPTY_M ln 2 where no
    key is live, l [B, H])."""
    B, Hkv, splits, group, D = acc.shape
    live = (torch.arange(splits, device=acc.device)[None] * chunk
            < lengths[:, None].long())                      # [B, splits]
    live = live[:, None, :, None]
    zero = torch.zeros((), device=acc.device)
    M = torch.where(live, m, torch.full((), float("-inf"),
                                        device=acc.device)).amax(dim=2)
    finite = torch.isfinite(M)
    M = torch.where(finite, M, zero)
    w = torch.where(live, torch.exp2(m - M[:, :, None]), zero)
    o = (w[..., None] * acc).sum(dim=2)
    lsum = (w * l).sum(dim=2)
    if stats:
        m_ln = torch.where(finite, M, torch.full((), EMPTY_M,
                                                 device=M.device)) * LN2
        return (o.reshape(B, Hkv * group, D), m_ln.reshape(B, Hkv * group),
                lsum.reshape(B, Hkv * group))
    return (o / lsum.clamp_min(1e-30)[..., None]).reshape(B, Hkv * group, D)


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lengths: torch.Tensor,
                             index: torch.Tensor, *, paged: bool = False,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None,
                             window: Optional[int] = None,
                             sms: int = H100_SMS, stats: bool = False):
    """The split-KV arithmetic of the decode kernels in plain PyTorch: the
    chunks `plan_splits` gives the span the splits cover (`decode_span`),
    each chunk's base-2 partial, then the merge. Slot cache (index = slots)
    or block pool (paged=True, index = tables), bf16 or int8 with scales;
    a `window` (slot cache only) offsets each sequence's splits to its
    live band, as the kernels do. Above head dim 256 the scores are the
    wide instances' cluster walk: partial scores of each 128-column slice
    summed in slice order, one softmax for all slices (`decode_slices`).
    `stats` returns the partial_stats triple (acc, m, l) instead of the
    output. Only the tests call it; the wrappers take the single-pass
    `*_plain` versions."""
    _check_window(window)
    B, H, _ = q.shape
    Hkv = k.shape[2]
    scales = tuple(x for x in (k_scale, v_scale) if x is not None)
    if paged:
        if window is not None:
            raise ValueError("the paged kernels take no window")
        rows = _page_rows(index, lengths, k, v, *scales)
        span = index.shape[1] * k.shape[1]
        base = torch.zeros_like(lengths)
    else:
        Smax = k.shape[1]
        if window is not None and window >= Smax:
            window = None
        span = decode_span(Smax, window)
        lo = (lengths - window).clamp_min(0) if window is not None \
            else torch.zeros_like(lengths)
        base = lo // DECODE_TILE * DECODE_TILE
        pos = base[:, None].long() + torch.arange(span, device=q.device)
        valid = (pos < lengths[:, None]) & (pos >= lo[:, None]) \
            & (pos < Smax)
        s = index.long()[:, None]
        at = pos.clamp_max(Smax - 1)
        rows = (*(c[s, at] for c in (k, v, *scales)), valid)
    chunk, _ = plan_splits(span, B, Hkv, sms)
    kr, vr = rows[:2]
    ks, vs = rows[2:4] if k_scale is not None else (None, None)
    acc, m, l = _split_partials_plain(q, kr, vr, rows[-1], chunk, ks, vs,
                                      decode_slices(q.shape[-1]))
    out = _merge_partials_plain(acc, m, l, lengths - base, chunk, stats)
    return out if stats else out.to(q.dtype)


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor,
                       slots: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """Plain decode over the bf16 slot cache (kernel `flash_decode`)."""
    k, v, valid = _slot_rows(slots, lengths, k_cache, v_cache, window=window)
    return _attend_plain(q, k, v, valid)


def flash_decode_quant_plain(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, lengths: torch.Tensor,
                             slots: torch.Tensor,
                             window: Optional[int] = None) -> torch.Tensor:
    """Plain decode over the int8 slot cache (kernel `flash_decode_quant`):
    logits scale by the K scales, weights by the V scales."""
    k, v, ks, vs, valid = _slot_rows(slots, lengths, k_cache, v_cache,
                                     k_scale, v_scale, window=window)
    return _attend_plain(q, k, v, valid, ks, vs)


def flash_decode_partial_plain(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               slots: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None):
    """Plain partial_stats decode over the slot cache (bf16, or int8 with
    its scales: kernels `flash_decode_partial` / `flash_decode_quant_partial`):
    the keys below each (shard-local) length as one chunk of the kernels'
    arithmetic, merged without the final division -> (acc [B, H, D], m
    [B, H] natural-log domain, l [B, H]), all f32."""
    scales = tuple(x for x in (k_scale, v_scale) if x is not None)
    rows = _slot_rows(slots, lengths, k_cache, v_cache, *scales)
    ks, vs = rows[2:4] if scales else (None, None)
    span = k_cache.shape[1]
    acc, m, l = _split_partials_plain(q, rows[0], rows[1], rows[-1], span,
                                      ks, vs)
    return _merge_partials_plain(acc, m, l, lengths, span, stats=True)


def flash_decode_paged_plain(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor,
                             window: Optional[int] = None) -> torch.Tensor:
    """Plain decode over the bf16 block pool: the table gather (kernel
    `flash_decode_paged`). With a `window` it is the windowed paged decode
    itself, as in the JAX package, whose paged kernels take no window."""
    k, v, valid = _page_rows(tables, lengths, k_pool, v_pool, window=window)
    return _attend_plain(q, k, v, valid)


def flash_decode_paged_quant_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   k_scale: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   tables: torch.Tensor,
                                   lengths: torch.Tensor,
                                   window: Optional[int] = None
                                   ) -> torch.Tensor:
    """Plain decode over the int8 block pool: the table gather of codes
    and scales (kernel `flash_decode_paged_quant`; with a `window`, the
    windowed paged decode itself, as flash_decode_paged_plain)."""
    k, v, ks, vs, valid = _page_rows(tables, lengths, k_pool, v_pool,
                                     k_scale, v_scale, window=window)
    return _attend_plain(q, k, v, valid, ks, vs)


def _decode_shape(q: torch.Tensor, kv: torch.Tensor, name: str):
    """(B, H, Hkv, D) for a query [B, H, D] and a cache or pool
    [n, span, Hkv, D] (what the plain versions need too)."""
    if q.dim() != 3 or kv.dim() != 4 or q.shape[-1] != kv.shape[-1] \
            or kv.shape[2] < 1 or q.shape[1] % kv.shape[2]:
        raise ValueError(f"{name}: q [B, H, D] and caches [n, L, Hkv, D] "
                         f"with H % Hkv == 0, got {tuple(q.shape)}, "
                         f"{tuple(kv.shape)}")
    B, H, D = q.shape
    return B, H, kv.shape[2], D


def decode_slices(D: int) -> int:
    """The output-column slices of a decode launch at head dim D: D / 128
    on the wide instances (D > 256), else 1 (csrc/flash_decode.cuh)."""
    return D // DECODE_SLICE if D > DECODE_HEAD_DIMS[-1] else 1


def _check_decode(name: str, B: int, H: int, Hkv: int, D: int):
    """Raises NotImplementedError on a shape no instance of the decode
    kernels takes: head dims other than D % 128 == 0 up to
    DECODE_MAX_HEAD_DIM (JAX's kernels assert D % 128 == 0), or a grid past
    CUDA's limits."""
    hchunks = -(-(H // Hkv) // MAX_GROUP)
    if D % DECODE_SLICE or not 0 < D <= DECODE_MAX_HEAD_DIM \
            or B > MAX_GRID_Y \
            or Hkv * hchunks * decode_slices(D) > MAX_GRID_Y:
        raise NotImplementedError(
            f"{name}: no kernel instance takes B={B}, H={H}, Hkv={Hkv}, "
            f"D={D} (head dims D % {DECODE_SLICE} == 0 up to "
            f"{DECODE_MAX_HEAD_DIM}, B and Hkv * ceil(group / {MAX_GROUP}) * "
            f"slices up to {MAX_GRID_Y})")


def _split_scratch(q: torch.Tensor, B: int, H: int, Hkv: int, span: int):
    """(chunk, splits, part, count) for a decode launch on q's device: the
    plan from static sizes, the partials' f32 scratch (allocated only when
    a sequence can span several splits; m and l once a slice) and the
    counters, one per sequence, KV head, chunk of query heads and slice
    (kernels/scratch.py)."""
    chunk, splits = plan_splits(span, B, Hkv, scratch.sm_count(q.device))
    if splits == 1:
        return chunk, splits, None, None
    D = q.shape[-1]
    slices = decode_slices(D)
    part = scratch.partials(q.device, B * H * splits * (D + 2 * slices))
    hchunks = -(-(H // Hkv) // MAX_GROUP)
    return chunk, splits, part, scratch.counters(
        q.device, B * Hkv * hchunks * slices)


def _launch(wrapper, symbol: str, argtypes, q: torch.Tensor,
            tensors, ints, span: int, kv_f16=None,
            window: Optional[int] = None, slot: bool = True,
            source: Optional[str] = None, stats: bool = False):
    """Launch the entry point `symbol` of csrc/<source or symbol>.cu on
    q's device: pointers of q and `tensors`, the output (with `stats` the
    f32 accumulator and the [2, B, H] m / l buffer), the split scratch and
    counters, then the ints, the split plan for the `span` the splits
    cover, the head dim, for the float kernels whether the cache is
    float16, whether q is bfloat16, for the slot kernels the window (0 for
    none; none with `stats`), 1/sqrt(D) and the stream. One launch a
    call. Returns the output, or with `stats` (acc, m, l)."""
    B, H, Hkv = ints[:3]
    D = q.shape[-1]
    _check_decode(symbol, B, H, Hkv, D)
    if stats:
        out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
        ml = torch.empty((2, B, H), dtype=torch.float32, device=q.device)
        outs = (out.data_ptr(), ml.data_ptr())
    else:
        out = torch.empty_like(q)
        outs = (out.data_ptr(),)
    fn = build.entry(source or symbol, symbol, argtypes)
    with torch.cuda.device(q.device):
        chunk, splits, part, count = _split_scratch(q, B, H, Hkv, span)
        err = fn(q.data_ptr(), *(t.data_ptr() for t in tensors), *outs,
                 part.data_ptr() if part is not None else 0,
                 count.data_ptr() if count is not None else 0, *ints,
                 chunk, splits, D,
                 *(() if kv_f16 is None else (int(kv_f16),)),
                 int(q.dtype == torch.bfloat16),
                 *((window or 0,) if slot and not stats else ()),
                 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, symbol)
    _count(wrapper, _variant(q.dtype, window, D))
    return (out, ml[0], ml[1]) if stats else out


def _float_cache(name: str, k: torch.Tensor, v: torch.Tensor, dev):
    """The float caches: bfloat16 (the engines') or float16 (generate's),
    both of one type."""
    if k.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{name}: caches must be bfloat16 or float16, got "
                         f"{k.dtype}")
    _require(k, "k", k.dtype, k.shape, dev)
    _require(v, "v", k.dtype, k.shape, dev)


def _device(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _query(q: torch.Tensor, shape) -> None:
    """q (and so the output): float16 or bfloat16."""
    if q.dtype not in QUERY_DTYPES:
        raise ValueError(f"q: float16 or bfloat16, got {q.dtype}")
    _require(q, "q", q.dtype, shape, q.device)


def _slot_window(window: Optional[int], Smax: int) -> Optional[int]:
    """A checked window of the slot kernels; one >= Smax is none."""
    _check_window(window)
    return None if window is None or window >= Smax else window


def _no_stats_window(window: Optional[int]) -> None:
    if window is not None:
        raise ValueError("partial_stats takes no window (context "
                         "parallelism refuses sliding windows)")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor,
                 slots: torch.Tensor,
                 window: Optional[int] = None, *,
                 partial_stats: bool = False):
    """q [B, H, D] f16 or bf16 against caches [rows, Smax, Hkv, D] bf16 or
    f16 through slots/lengths [B] int32 -> [B, H, D] in q's type. With a
    `window` the query at position len - 1 attends keys [max(len - window,
    0), len), and the splits cover min(Smax, window + 64) keys a
    sequence. partial_stats=True returns (acc, m, l) instead (the module
    docstring; `flash_decode_partial`)."""
    if partial_stats:
        _no_stats_window(window)
        return flash_decode_partial(q, k_cache, v_cache, lengths, slots)
    B, H, Hkv, D = _decode_shape(q, k_cache, "flash_decode")
    rows, Smax = k_cache.shape[:2]
    dev = q.device
    _query(q, (B, H, D))
    _float_cache("flash_decode", k_cache, v_cache, dev)
    _require(lengths, "lengths", torch.int32, (B,), dev, align=4)
    _require(slots, "slots", torch.int32, (B,), dev, align=4)
    window = _slot_window(window, Smax)
    if _device(q) == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, slots,
                                  window)
    return _launch(flash_decode, "flash_decode", _DECODE_ARGS, q,
                   (k_cache, v_cache, slots, lengths), (B, H, Hkv, Smax),
                   decode_span(Smax, window),
                   kv_f16=k_cache.dtype == torch.float16, window=window)


flash_decode.launches = 0
flash_decode.variant_launches = {}


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         slots: torch.Tensor):
    """flash_decode in partial_stats mode: q [B, H, D] f16 or bf16, the
    bf16 or f16 slot cache, slots / shard-local lengths [B] int32 -> (acc
    [B, H, D], m [B, H], l [B, H]) f32 (kernel 5's
    `flash_decode_partial` entry point; the plain version on the CPU)."""
    B, H, Hkv, D = _decode_shape(q, k_cache, "flash_decode_partial")
    rows, Smax = k_cache.shape[:2]
    dev = q.device
    _query(q, (B, H, D))
    _float_cache("flash_decode_partial", k_cache, v_cache, dev)
    _require(lengths, "lengths", torch.int32, (B,), dev, align=4)
    _require(slots, "slots", torch.int32, (B,), dev, align=4)
    if _device(q) == "cpu":
        return flash_decode_partial_plain(q, k_cache, v_cache, lengths,
                                          slots)
    return _launch(flash_decode_partial, "flash_decode_partial",
                   _DECODE_PARTIAL_ARGS, q,
                   (k_cache, v_cache, slots, lengths), (B, H, Hkv, Smax),
                   Smax, kv_f16=k_cache.dtype == torch.float16,
                   source="flash_decode", stats=True)


flash_decode_partial.launches = 0
flash_decode_partial.variant_launches = {}


def _quant_cache(name: str, q, k_cache, v_cache, k_scale, v_scale,
                 lengths, slots):
    """(B, H, Hkv, D) after checking the int8 slot cache's operands."""
    B, H, Hkv, D = _decode_shape(q, k_cache, name)
    dev = q.device
    _query(q, (B, H, D))
    _require(k_cache, "k_cache", torch.int8, k_cache.shape, dev)
    _require(v_cache, "v_cache", torch.int8, k_cache.shape, dev)
    _require(k_scale, "k_scale", torch.float32, k_cache.shape[:3], dev,
             align=4)
    _require(v_scale, "v_scale", torch.float32, k_cache.shape[:3], dev,
             align=4)
    _require(lengths, "lengths", torch.int32, (B,), dev, align=4)
    _require(slots, "slots", torch.int32, (B,), dev, align=4)
    return B, H, Hkv, D


def flash_decode_quant(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, lengths: torch.Tensor,
                       slots: torch.Tensor,
                       window: Optional[int] = None, *,
                       partial_stats: bool = False):
    """q [B, H, D] f16 or bf16 against int8 caches [rows, Smax, Hkv, D]
    with f32 scales [rows, Smax, Hkv] through slots/lengths [B] int32
    -> [B, H, D] in q's type; `window` as flash_decode's;
    partial_stats=True returns (acc, m, l) (`flash_decode_quant_partial`)."""
    if partial_stats:
        _no_stats_window(window)
        return flash_decode_quant_partial(q, k_cache, v_cache, k_scale,
                                          v_scale, lengths, slots)
    B, H, Hkv, D = _quant_cache("flash_decode_quant", q, k_cache, v_cache,
                                k_scale, v_scale, lengths, slots)
    Smax = k_cache.shape[1]
    window = _slot_window(window, Smax)
    if _device(q) == "cpu":
        return flash_decode_quant_plain(q, k_cache, v_cache, k_scale,
                                        v_scale, lengths, slots, window)
    return _launch(flash_decode_quant, "flash_decode_quant",
                   _DECODE_QUANT_ARGS, q,
                   (k_cache, v_cache, k_scale, v_scale, slots, lengths),
                   (B, H, Hkv, Smax), decode_span(Smax, window),
                   window=window)


flash_decode_quant.launches = 0
flash_decode_quant.variant_launches = {}


def flash_decode_quant_partial(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, lengths: torch.Tensor,
                               slots: torch.Tensor):
    """flash_decode_quant in partial_stats mode: the int8 slot cache and
    its scales, shard-local lengths -> (acc, m, l) f32 (kernel 6's
    `flash_decode_quant_partial` entry point; the plain version on the
    CPU). The V scales weigh acc, not l, as in JAX's kernel."""
    B, H, Hkv, D = _quant_cache("flash_decode_quant_partial", q, k_cache,
                                v_cache, k_scale, v_scale, lengths, slots)
    Smax = k_cache.shape[1]
    if _device(q) == "cpu":
        return flash_decode_partial_plain(q, k_cache, v_cache, lengths,
                                          slots, k_scale, v_scale)
    return _launch(flash_decode_quant_partial, "flash_decode_quant_partial",
                   _DECODE_QUANT_PARTIAL_ARGS, q,
                   (k_cache, v_cache, k_scale, v_scale, slots, lengths),
                   (B, H, Hkv, Smax), Smax, source="flash_decode_quant",
                   stats=True)


flash_decode_quant_partial.launches = 0
flash_decode_quant_partial.variant_launches = {}


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """q [B, H, D] f16 or bf16 against the bf16 or f16 block pool
    [blocks, bs, Hkv, D] through tables [B, MB] and lengths [B] int32 ->
    [B, H, D] in q's type. Only pages below each length are read. No
    window, as in the JAX package (kv_cache.decode_attention_paged routes
    a windowed decode to the table gather)."""
    B, H, Hkv, D = _decode_shape(q, k_pool, "flash_decode_paged")
    bs = k_pool.shape[1]
    dev = q.device
    _query(q, (B, H, D))
    _float_cache("flash_decode_paged", k_pool, v_pool, dev)
    _require(tables, "tables", torch.int32, (B, tables.shape[-1]), dev,
             align=4)
    _require(lengths, "lengths", torch.int32, (B,), dev, align=4)
    if _device(q) == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, tables, lengths)
    return _launch(flash_decode_paged, "flash_decode_paged",
                   _DECODE_PAGED_ARGS, q, (k_pool, v_pool, tables, lengths),
                   (B, H, Hkv, bs, tables.shape[1]), bs * tables.shape[1],
                   kv_f16=k_pool.dtype == torch.float16, slot=False)


flash_decode_paged.launches = 0
flash_decode_paged.variant_launches = {}


def flash_decode_paged_quant(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """q [B, H, D] f16 or bf16 against the int8 block pool [blocks, bs,
    Hkv, D] and its f32 scale planes [blocks, bs, Hkv] through tables
    [B, MB] and lengths [B] int32 -> [B, H, D] in q's type (no window, as
    flash_decode_paged)."""
    B, H, Hkv, D = _decode_shape(q, k_pool, "flash_decode_paged_quant")
    bs = k_pool.shape[1]
    dev = q.device
    _query(q, (B, H, D))
    _require(k_pool, "k_pool", torch.int8, k_pool.shape, dev)
    _require(v_pool, "v_pool", torch.int8, k_pool.shape, dev)
    _require(k_scale, "k_scale", torch.float32, k_pool.shape[:3], dev,
             align=4)
    _require(v_scale, "v_scale", torch.float32, k_pool.shape[:3], dev,
             align=4)
    _require(tables, "tables", torch.int32, (B, tables.shape[-1]), dev,
             align=4)
    _require(lengths, "lengths", torch.int32, (B,), dev, align=4)
    if _device(q) == "cpu":
        return flash_decode_paged_quant_plain(q, k_pool, v_pool, k_scale,
                                              v_scale, tables, lengths)
    return _launch(flash_decode_paged_quant, "flash_decode_paged_quant",
                   _DECODE_PAGED_QUANT_ARGS, q,
                   (k_pool, v_pool, k_scale, v_scale, tables, lengths),
                   (B, H, Hkv, bs, tables.shape[1]), bs * tables.shape[1],
                   slot=False)


flash_decode_paged_quant.launches = 0
flash_decode_paged_quant.variant_launches = {}

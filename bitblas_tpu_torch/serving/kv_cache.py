"""KV caches for decode serving (counterpart of
bitblas_tpu/serving/kv_cache.py: the slot cache, its int8 twin, the paged
block pool and its int8 twin, chunked appends and the ring cache):

  slot   k/v : [num_layers, num_slots, max_seq_len, kv_heads, head_dim]
  paged  k/v : [num_layers, num_blocks, block_size, kv_heads, head_dim]
               + block tables [num_slots, max_blocks_per_slot] (host side)
  ring   k/v : [num_layers, num_slots, R, kv_heads, head_dim], R about the
               sliding window (token at absolute position p in row p % R)
  int8       : codes in k/v, f32 scales [...,  kv_heads] in k_scale/v_scale

Unlike the JAX package, whose arrays are immutable, the caches here are
updated IN PLACE: the writers and appenders write into the tensors they
are given (and return them for call-site parity), so a decode step never
copies a cache. The block pool is indexed like the slot cache, with
(block, offset) in place of (slot, position), so the paged appenders are
the slot appenders.

A sliding window (HF convention: the query at position p attends keys
(p - window, p]) runs through the slot decode kernels; a windowed paged
decode takes the table gather, as in the JAX package, whose paged kernels
have no window. The chunk and ring attends are plain PyTorch, as JAX's are
XLA: a chunk's T queries are one batched contraction, and a window-sized
ring holds about the W keys a windowed kernel would read anyway.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import math

import torch

from ..common import resolve_device
from ..kernels.flash import (flash_decode, flash_decode_paged,
                             flash_decode_paged_plain,
                             flash_decode_paged_quant,
                             flash_decode_paged_quant_plain,
                             flash_decode_plain, flash_decode_quant,
                             flash_decode_quant_plain)


@dataclass(frozen=True)
class KVCacheConfig:
    num_slots: int
    max_seq_len: int
    num_kv_heads: int
    head_dim: int
    num_layers: int
    dtype: str = "bfloat16"


def init_kv_cache(cfg: KVCacheConfig,
                  device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers, cfg.num_slots, cfg.max_seq_len,
             cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "lengths": torch.zeros((cfg.num_slots,), dtype=torch.int32,
                               device=dev),
    }


def write_prompt(cache: Dict[str, torch.Tensor], layer: int, slot: int,
                 k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write a prompt's K/V [S, Hkv, D] into rows [0, S) of one slot, in
    place."""
    S = k.shape[0]
    cache["k"][layer, slot, :S] = k.to(cache["k"].dtype)
    cache["v"][layer, slot, :S] = v.to(cache["v"].dtype)
    return cache


def append_token(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 slots: torch.Tensor, positions: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer decode append, in place: cache_k/v [slots, L, Hkv, D];
    slots, positions [B]; k/v_new [B, Hkv, D]."""
    s, p = slots.long(), positions.long()
    cache_k[s, p] = k_new.to(cache_k.dtype)
    cache_v[s, p] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def _int32(*ts: torch.Tensor):
    return tuple(t.to(torch.int32).contiguous() for t in ts)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, slots: torch.Tensor,
                     lengths: torch.Tensor, *, num_heads: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against the cache: q [B, H, D]; cache_k/v
    [slots, L, Hkv, D]; lengths [B] valid tokens (including the one just
    appended). Returns [B, H, D].

    With a lane-aligned head dim (D % 128 == 0, the JAX package's rule) it
    runs the flash-decode wrapper straight out of the slot cache, reading
    only rows below each length (any GQA group; on the card the kernel
    takes every such head dim up to `kernels.flash.DECODE_MAX_HEAD_DIM`,
    1024, and raises above it); other head dims take the plain
    length-masked decode, as JAX's XLA path does. With a `window` the query at
    position lengths - 1 attends keys [max(lengths - window, 0),
    lengths), through the same kernel."""
    lengths, slots = _int32(lengths, slots)
    if q.shape[-1] % 128 == 0:
        return flash_decode(q, cache_k, cache_v, lengths, slots, window)
    return flash_decode_plain(q, cache_k, cache_v, lengths, slots, window)


def append_chunk(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 slots: torch.Tensor, starts: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer multi-token append, in place: cache_k/v [slots, L, Hkv,
    D]; slots, starts [B]; k/v_new [B, T, Hkv, D] landing at positions
    starts[b] + 0..T-1 (the caller guarantees starts[b] + T <= L)."""
    b, pos = _chunk_index(slots, starts, k_new.shape[1])
    cache_k[b, pos] = k_new.to(cache_k.dtype)
    cache_v[b, pos] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def _chunk_index(slots: torch.Tensor, starts: torch.Tensor, T: int,
                 rows: Optional[int] = None):
    """([B, 1] slots, [B, T] positions starts + 0..T-1, modulo `rows` for
    the ring) as int64 index tensors."""
    pos = starts.long()[:, None] + torch.arange(T, device=starts.device)
    if rows is not None:
        pos = pos % rows
    return slots.long()[:, None], pos


def _softmax_attend(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep: torch.Tensor, k_scale=None, v_scale=None,
                    chunk: bool = False) -> torch.Tensor:
    """The JAX package's XLA attend in float32: logits q.k / sqrt(D)
    (times the K scales of an int8 cache), masked to -1e30 where `keep` is
    False, softmax, the weights times the V scales, then P V. qf [B, Hkv,
    g, D] (decode) or [B, T, Hkv, g, D] (chunk=True); k/v [B, L, Hkv, D];
    keep broadcastable to the logits [B, Hkv, g, (T,) L]; scales
    [B, L, Hkv]."""
    D = qf.shape[-1]
    if chunk:
        s = torch.einsum("bthgd,blhd->bhgtl", qf, k.float())
        ksc = None if k_scale is None else \
            k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
        vsc = None if v_scale is None else \
            v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    else:
        s = torch.einsum("bhgd,blhd->bhgl", qf, k.float())
        ksc = None if k_scale is None else \
            k_scale.float().permute(0, 2, 1)[:, :, None, :]
        vsc = None if v_scale is None else \
            v_scale.float().permute(0, 2, 1)[:, :, None, :]
    s = s / math.sqrt(D)
    if ksc is not None:
        s = s * ksc
    s = torch.where(keep, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    if vsc is not None:
        p = p * vsc
    if chunk:
        return torch.einsum("bhgtl,blhd->bthgd", p, v.float())
    return torch.einsum("bhgl,blhd->bhgd", p, v.float())


def _gather_attend(q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, slots: torch.Tensor,
                   keep: torch.Tensor, scale_k=None,
                   scale_v=None) -> torch.Tensor:
    """The chunk and ring attends: gather the slots' cache rows (and
    scales) and attend in float32 (_softmax_attend). q [B, H, D] (one
    token) or [B, T, H, D] (a chunk); returns q's shape and type."""
    s = slots.long()
    Hkv, H, D = cache_k.shape[2], q.shape[-2], q.shape[-1]
    qf = q.float().reshape(*q.shape[:-2], Hkv, H // Hkv, D)
    out = _softmax_attend(qf, cache_k[s], cache_v[s], keep,
                          None if scale_k is None else scale_k[s],
                          None if scale_v is None else scale_v[s],
                          chunk=q.dim() == 4)
    return out.reshape(q.shape).to(q.dtype)


def _chunk_keep(starts: torch.Tensor, T: int, L: int,
                window: Optional[int]) -> torch.Tensor:
    """[B, 1, 1, T, L] mask of chunk_attention: query i of request b
    attends positions < starts[b] + i + 1 and, with a window, above
    starts[b] + i - window."""
    limit = starts.long()[:, None] + torch.arange(T, device=starts.device) \
        + 1                                                    # [B, T]
    pos = torch.arange(L, device=starts.device)[None, None, :]
    keep = pos < limit[:, :, None]
    if window is not None:
        keep = keep & (pos > limit[:, :, None] - 1 - window)
    return keep[:, None, None]


def chunk_attention(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, slots: torch.Tensor,
                    starts: torch.Tensor, *, num_heads: int,
                    window: Optional[int] = None) -> torch.Tensor:
    """T-token causal attention against the slot cache (chunk already
    appended): q [B, T, H, D]; query i of request b attends cache
    positions < starts[b] + i + 1, and within the trailing `window` keys
    when one is set. Returns [B, T, H, D] in q's type. One batched
    contraction per chunk, in plain PyTorch as JAX's is XLA."""
    keep = _chunk_keep(starts, q.shape[1], cache_k.shape[1], window)
    return _gather_attend(q, cache_k, cache_v, slots, keep)


# -- int8 slot cache ----------------------------------------------------------
#
# Per-(token, head) symmetric scales keep the math factorable outside the
# dots: logits[l] = (q . k_int[l]) * k_scale[l], and the V scales fold into
# the softmax weights, so both contractions run on the stored codes.


def init_kv_scales(kv_shape: Tuple[int, ...],
                   device="cuda") -> torch.Tensor:
    """Zero f32 int8-KV scales for a cache of `kv_shape` ([..., D]; the
    scales drop the trailing head_dim axis). Shared by the slot and paged
    engines."""
    return torch.zeros(kv_shape[:-1], dtype=torch.float32,
                       device=resolve_device(device))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(..., head) int8 quantization over the last (D) axis:
    x [..., D] float -> (codes int8 [..., D], scale f32 [...]) with
    x ~= codes * scale. Zero rows get scale 0 (codes 0). The f32 divide
    and round-half-to-even give the JAX package's codes bit for bit."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    live = scale[..., None] > 0
    codes = torch.where(live, xf / torch.where(live, scale[..., None], 1.0),
                        0.0)
    return torch.round(codes).to(torch.int8), scale


def init_quant_kv_cache(cfg: KVCacheConfig,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Slot cache with int8 k/v + f32 per-(token, head) scales."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_slots, cfg.max_seq_len,
             cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_scale": init_kv_scales(shape, dev),
        "v_scale": init_kv_scales(shape, dev),
        "lengths": torch.zeros((cfg.num_slots,), dtype=torch.int32,
                               device=dev),
    }


def append_token_quant(cache_k: torch.Tensor, cache_v: torch.Tensor,
                       scale_k: torch.Tensor, scale_v: torch.Tensor,
                       slots: torch.Tensor, positions: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor):
    """Per-layer decode append with quantization, in place: cache_k/v
    [slots, L, Hkv, D] int8; scale_k/v [slots, L, Hkv] f32; k/v_new
    [B, Hkv, D] float."""
    s, p = slots.long(), positions.long()
    for codes, scales, x in ((cache_k, scale_k, k_new),
                             (cache_v, scale_v, v_new)):
        codes[s, p], scales[s, p] = quantize_kv(x)
    return cache_k, cache_v, scale_k, scale_v


def write_prompt_quant(cache: Dict[str, torch.Tensor], layer: int,
                       slot: int, k: torch.Tensor,
                       v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantized twin of write_prompt: k/v [S, Hkv, D] float, in place."""
    S = k.shape[0]
    for name, x in (("k", k), ("v", v)):
        codes, scales = quantize_kv(x)
        cache[name][layer, slot, :S] = codes
        cache[f"{name}_scale"][layer, slot, :S] = scales
    return cache


def decode_attention_quant(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, scale_k: torch.Tensor,
                           scale_v: torch.Tensor, slots: torch.Tensor,
                           lengths: torch.Tensor, *, num_heads: int,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against the int8 cache: q [B, H, D];
    cache_k/v [slots, L, Hkv, D] int8; scale_k/v [slots, L, Hkv] f32;
    lengths [B]. Returns [B, H, D]. Lane-aligned head dims (D % 128 == 0)
    run the int8 flash-decode kernel; other head dims its plain version;
    `window` as decode_attention's."""
    lengths, slots = _int32(lengths, slots)
    fn = flash_decode_quant if q.shape[-1] % 128 == 0 \
        else flash_decode_quant_plain
    return fn(q, cache_k, cache_v, scale_k, scale_v, lengths, slots, window)


def append_chunk_quant(cache_k: torch.Tensor, cache_v: torch.Tensor,
                       scale_k: torch.Tensor, scale_v: torch.Tensor,
                       slots: torch.Tensor, starts: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor):
    """Quantized twin of append_chunk: k/v_new [B, T, Hkv, D] float are
    quantized per (token, head) and written at starts[b] + 0..T-1, in
    place."""
    b, pos = _chunk_index(slots, starts, k_new.shape[1])
    for codes, scales, x in ((cache_k, scale_k, k_new),
                             (cache_v, scale_v, v_new)):
        codes[b, pos], scales[b, pos] = quantize_kv(x)
    return cache_k, cache_v, scale_k, scale_v


def chunk_attention_quant(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, scale_k: torch.Tensor,
                          scale_v: torch.Tensor, slots: torch.Tensor,
                          starts: torch.Tensor, *, num_heads: int,
                          window: Optional[int] = None) -> torch.Tensor:
    """Quantized twin of chunk_attention: the same chunk-causal mask, the
    K scales on the logits and the V scales folded into the weights."""
    keep = _chunk_keep(starts, q.shape[1], cache_k.shape[1], window)
    return _gather_attend(q, cache_k, cache_v, slots, keep, scale_k, scale_v)


# -- paged cache (block pool) -------------------------------------------------
#
# The slot cache reserves max_seq_len rows per slot; the paged cache pools
# fixed-size blocks so memory follows live tokens. The engine's host-side
# BlockAllocator hands blocks to slots as their sequences grow.


@dataclass(frozen=True)
class PagedKVConfig:
    num_blocks: int
    block_size: int
    num_kv_heads: int
    head_dim: int
    num_layers: int
    max_blocks_per_slot: int
    dtype: str = "bfloat16"


def _pool_shape(cfg: PagedKVConfig) -> Tuple[int, ...]:
    return (cfg.num_layers, cfg.num_blocks, cfg.block_size,
            cfg.num_kv_heads, cfg.head_dim)


def init_paged_kv_cache(cfg: PagedKVConfig,
                        device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(_pool_shape(cfg), dtype=dt, device=dev),
            "v": torch.zeros(_pool_shape(cfg), dtype=dt, device=dev)}


def init_quant_paged_kv_cache(cfg: PagedKVConfig,
                              device="cuda") -> Dict[str, torch.Tensor]:
    """Paged cache with int8 k/v + f32 per-(token, head) scales."""
    dev = resolve_device(device)
    shape = _pool_shape(cfg)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_scale": init_kv_scales(shape, dev),
        "v_scale": init_kv_scales(shape, dev),
    }


# Per-layer decode append into the block pool [blocks, bs, Hkv, D], in
# place: (block_rows, offsets) [B] = the physical block and the row in it
# where each request's new token lands.
append_token_paged = append_token
append_token_paged_quant = append_token_quant


def _use_paged_kernel(q: torch.Tensor, use_flash: Optional[bool]) -> bool:
    if use_flash is None:
        return q.is_cuda and q.shape[-1] % 128 == 0
    return use_flash


def decode_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *, num_heads: int,
                           use_flash: Optional[bool] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against the paged cache: q [B, H, D];
    cache_k/v [blocks, bs, Hkv, D]; tables [B, MB] physical block ids per
    request (entries past the live pages are never read); lengths [B].
    Returns [B, H, D].

    use_flash=None runs the paged kernel's wrapper when q is on the card
    and the head dim is lane-aligned (D % 128 == 0, as the slot route;
    any GQA group; the kernel takes every such head dim up to 1024 and
    raises above it), and the plain table gather otherwise; False always
    takes the gather (the same function); True the kernel's wrapper.

    A `window` always takes the table gather, masked to the window: this
    is the JAX package's own design (its paged kernels have no window
    lower bound, kv_cache.py:197-198), not a fallback. Such calls count
    in `decode_attention_paged.window_gathers`."""
    tables, lengths = _int32(tables, lengths)
    if window is not None:
        decode_attention_paged.window_gathers += 1
        return flash_decode_paged_plain(q, cache_k, cache_v, tables, lengths,
                                        window)
    fn = flash_decode_paged if _use_paged_kernel(q, use_flash) \
        else flash_decode_paged_plain
    return fn(q, cache_k, cache_v, tables, lengths)


decode_attention_paged.window_gathers = 0


def decode_attention_paged_quant(q: torch.Tensor, cache_k: torch.Tensor,
                                 cache_v: torch.Tensor,
                                 scale_k: torch.Tensor,
                                 scale_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor, *, num_heads: int,
                                 use_flash: Optional[bool] = None,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Quantized twin of decode_attention_paged over the int8 pool and its
    scale planes [blocks, bs, Hkv]; same routing (a window takes the
    masked gather, counted in `window_gathers`)."""
    tables, lengths = _int32(tables, lengths)
    if window is not None:
        decode_attention_paged_quant.window_gathers += 1
        return flash_decode_paged_quant_plain(q, cache_k, cache_v, scale_k,
                                              scale_v, tables, lengths,
                                              window)
    fn = flash_decode_paged_quant if _use_paged_kernel(q, use_flash) \
        else flash_decode_paged_quant_plain
    return fn(q, cache_k, cache_v, scale_k, scale_v, tables, lengths)


decode_attention_paged_quant.window_gathers = 0


class BlockAllocator:
    """Host-side free list over the physical block pool."""

    def __init__(self, num_blocks: int):
        self.free = list(range(num_blocks))[::-1]

    def alloc(self) -> Optional[int]:
        return self.free.pop() if self.free else None

    def alloc_many(self, n: int) -> Optional[list]:
        """n blocks, or None (and none taken) when fewer are free."""
        if len(self.free) < n:
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, blocks) -> None:
        self.free.extend(int(b) for b in blocks)

    @property
    def available(self) -> int:
        return len(self.free)


# -- ring (sliding-window rolling-buffer) cache --------------------------------
#
# With a sliding window only the trailing `window` keys are ever attended;
# the ring cache stores R ~= W rows a slot and writes the token at
# absolute position p into row p % R, so KV memory follows the window, not
# the conversation length. Row r of a slot holding `length` tokens holds
# the newest p <= length - 1 with p % R == r, p = (length - 1) - ((length
# - 1 - r) mod R), derived from `lengths`; attention masks on that
# position, so the attended set is the windowed full-cache one. A chunk of
# T tokens overwrites rows of positions < length - R, and its first query
# still needs starts - window + 1: R >= window + T - 1 (decode: R >=
# window). The attends are plain PyTorch, as JAX's are XLA (kv_cache.py:
# 836-842): the ring is already window-sized, so they read about the W
# keys a windowed kernel would.


def ring_capacity(window: int, max_chunk: int = 1, align: int = 128) -> int:
    """Smallest aligned ring capacity correct for chunked appends of up
    to `max_chunk` tokens: R >= window + max_chunk - 1, rounded up."""
    need = window + max_chunk - 1
    return ((need + align - 1) // align) * align


def _ring_shape(cfg: KVCacheConfig, window: int, max_chunk: int):
    R = min(ring_capacity(window, max_chunk), cfg.max_seq_len)
    return (cfg.num_layers, cfg.num_slots, R, cfg.num_kv_heads,
            cfg.head_dim)


def init_ring_kv_cache(cfg: KVCacheConfig, window: int, max_chunk: int = 1,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """Slot cache with ring rows: k/v [L, slots, R, Hkv, D], R the
    window-sized capacity (at most cfg.max_seq_len)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    shape = _ring_shape(cfg, window, max_chunk)
    return {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "lengths": torch.zeros((cfg.num_slots,), dtype=torch.int32,
                               device=dev),
    }


def init_ring_quant_kv_cache(cfg: KVCacheConfig, window: int,
                             max_chunk: int = 1,
                             device="cuda") -> Dict[str, torch.Tensor]:
    """int8 ring cache: codes + per-(row, head) f32 scales at ring
    capacity."""
    dev = resolve_device(device)
    shape = _ring_shape(cfg, window, max_chunk)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_scale": init_kv_scales(shape, dev),
        "v_scale": init_kv_scales(shape, dev),
        "lengths": torch.zeros((cfg.num_slots,), dtype=torch.int32,
                               device=dev),
    }


def ring_abs_positions(lengths: torch.Tensor, capacity: int) -> torch.Tensor:
    """[B] lengths -> [B, R] absolute position held by each ring row (-1
    for rows never written). Row r holds the newest p <= length - 1 with
    p % R == r."""
    r = torch.arange(capacity, device=lengths.device)[None]
    last = lengths.long()[:, None] - 1
    abs_pos = last - torch.remainder(last - r, capacity)
    return torch.where(abs_pos >= 0, abs_pos, torch.full_like(abs_pos, -1))


def append_token_ring(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      slots: torch.Tensor, positions: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """append_token into ring rows, in place: cache_k/v [slots, R, Hkv,
    D]; the token at absolute position positions[b] lands in row
    positions[b] % R."""
    return append_token(cache_k, cache_v, slots,
                        positions.long() % cache_k.shape[1], k_new, v_new)


def append_token_ring_quant(cache_k, cache_v, scale_k, scale_v,
                            slots: torch.Tensor, positions: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor):
    """Quantized ring append: codes + scales land in row position % R."""
    return append_token_quant(cache_k, cache_v, scale_k, scale_v, slots,
                              positions.long() % cache_k.shape[1], k_new,
                              v_new)


def _check_ring_chunk(T: int, R: int, name: str) -> None:
    if T > R:
        raise ValueError(f"{name}: chunk T={T} exceeds ring capacity R={R} "
                         f"(two tokens of the chunk would share a row)")


def append_chunk_ring(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      slots: torch.Tensor, starts: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """append_chunk into ring rows (absolute starts[b] + i -> row % R),
    in place. T <= R keeps the T rows distinct."""
    T, R = k_new.shape[1], cache_k.shape[1]
    _check_ring_chunk(T, R, "append_chunk_ring")
    b, pos = _chunk_index(slots, starts, T, R)
    cache_k[b, pos] = k_new.to(cache_k.dtype)
    cache_v[b, pos] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def append_chunk_ring_quant(cache_k, cache_v, scale_k, scale_v,
                            slots: torch.Tensor, starts: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor):
    """Quantized ring chunk append: codes + scales land in rows
    (starts[b] + i) % R, in place."""
    T, R = k_new.shape[1], cache_k.shape[1]
    _check_ring_chunk(T, R, "append_chunk_ring_quant")
    b, pos = _chunk_index(slots, starts, T, R)
    for codes, scales, x in ((cache_k, scale_k, k_new),
                             (cache_v, scale_v, v_new)):
        codes[b, pos], scales[b, pos] = quantize_kv(x)
    return cache_k, cache_v, scale_k, scale_v


def _ring_decode_keep(lengths: torch.Tensor, R: int,
                      window: int) -> torch.Tensor:
    """[B, 1, 1, R]: ring rows written and within the window of the query
    at position lengths - 1."""
    if R < window:
        raise ValueError(f"ring capacity {R} < window {window}")
    abs_pos = ring_abs_positions(lengths, R)
    p = lengths.long()[:, None] - 1
    return ((abs_pos >= 0) & (abs_pos > p - window))[:, None, None]


def _ring_chunk_keep(starts: torch.Tensor, T: int, R: int,
                     window: int) -> torch.Tensor:
    """[B, 1, 1, T, R]: ring rows written, at or before query i's position
    starts + i and within its window."""
    if R < window + T - 1:
        raise ValueError(
            f"ring capacity {R} < window+T-1 = {window + T - 1}: chunk "
            f"appends would evict keys the first chunk queries still need")
    a = ring_abs_positions(starts + T, R)[:, None, :]           # [B, 1, R]
    pq = (starts.long()[:, None]
          + torch.arange(T, device=starts.device))[:, :, None]  # [B, T, 1]
    return ((a >= 0) & (a <= pq) & (a > pq - window))[:, None, None]


def ring_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, slots: torch.Tensor,
                          lengths: torch.Tensor, *, num_heads: int,
                          window: int) -> torch.Tensor:
    """Single-token windowed attention against the ring cache: q [B, H,
    D]; cache_k/v [slots, R, Hkv, D]; lengths [B] valid tokens INCLUDING
    the one just appended; R >= window. Returns [B, H, D] in q's type:
    the attended set of decode_attention(window=) on a full cache.
    Counted in `ring_decode_attention.calls`."""
    ring_decode_attention.calls += 1
    keep = _ring_decode_keep(lengths, cache_k.shape[1], window)
    return _gather_attend(q, cache_k, cache_v, slots, keep)


def ring_decode_attention_quant(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, scale_k: torch.Tensor,
                                scale_v: torch.Tensor, slots: torch.Tensor,
                                lengths: torch.Tensor, *, num_heads: int,
                                window: int) -> torch.Tensor:
    """Single-token windowed attention against the int8 ring cache
    (scales on the dot results, as decode_attention_quant)."""
    ring_decode_attention_quant.calls += 1
    keep = _ring_decode_keep(lengths, cache_k.shape[1], window)
    return _gather_attend(q, cache_k, cache_v, slots, keep, scale_k, scale_v)


def ring_chunk_attention(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, slots: torch.Tensor,
                         starts: torch.Tensor, *, num_heads: int,
                         window: int) -> torch.Tensor:
    """T-token windowed causal attention against the ring cache (chunk
    already appended): q [B, T, H, D]; starts [B] tokens cached BEFORE
    the chunk; R >= window + T - 1. Returns [B, T, H, D] in q's type."""
    ring_chunk_attention.calls += 1
    keep = _ring_chunk_keep(starts, q.shape[1], cache_k.shape[1], window)
    return _gather_attend(q, cache_k, cache_v, slots, keep)


def ring_chunk_attention_quant(q: torch.Tensor, cache_k: torch.Tensor,
                               cache_v: torch.Tensor, scale_k: torch.Tensor,
                               scale_v: torch.Tensor, slots: torch.Tensor,
                               starts: torch.Tensor, *, num_heads: int,
                               window: int) -> torch.Tensor:
    """Quantized twin of ring_chunk_attention (scales on dot results)."""
    ring_chunk_attention_quant.calls += 1
    keep = _ring_chunk_keep(starts, q.shape[1], cache_k.shape[1], window)
    return _gather_attend(q, cache_k, cache_v, slots, keep, scale_k, scale_v)


# Each ring attend counts its calls (the serve phases read them: the ring
# attends are torch ops, not kernels).
for _fn in (ring_decode_attention, ring_decode_attention_quant,
            ring_chunk_attention, ring_chunk_attention_quant):
    _fn.calls = 0


# -- context parallelism: sequence shards of the slot cache --------------------
#
# Under context parallelism (parallel/serving.TPQuantLlama) each rank of a
# cp group holds one sequence shard of every slot: global positions
# [c * local_len, (c + 1) * local_len) of shard c. The appends write only
# the positions the shard owns; the *_partial attends return the
# online-softmax state over the shard's live keys, (acc [..., H, D] f32
# unnormalised, m [..., H] f32 in the natural-log domain, l [..., H] f32),
# which the cp group merges by log-sum-exp: with m* = max_c m_c and w_c =
# exp(m_c - m*), out = sum_c w_c acc_c / sum_c w_c l_c. A shard with no live
# key for a sequence weighs exp(-1e30 - m*) = 0. The decode partials run
# kernels 5 and 6 in partial_stats mode at lane-aligned head dims (the JAX
# package's rule, kv_cache.py:658-666, :744-752), else plain torch ops as
# JAX's are XLA; the chunk partials are plain torch ops, as JAX's are.


def shard_kv_cache(cache: Dict[str, torch.Tensor], index: int, n: int,
                   dim: int = 3) -> Dict[str, torch.Tensor]:
    """Rank `index` of `n`'s slice of a cache dict (k / v and, int8, their
    scales) along `dim` (3: the kv-head axis, as JAX's P(None, None, None,
    axis, None); 2: the sequence axis of a cp shard); `lengths` stays
    whole."""
    out = {}
    for name, t in cache.items():
        if name == "lengths":
            out[name] = t
            continue
        w = t.shape[dim] // n
        out[name] = t.narrow(dim, index * w, w).contiguous()
    return out


def _owned(positions: torch.Tensor, cp_index: int, local_len: int):
    """(owned mask, local positions) of global positions on shard
    cp_index."""
    p_loc = positions.long() - cp_index * local_len
    return (p_loc >= 0) & (p_loc < local_len), p_loc


def append_token_cp(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    slots: torch.Tensor, positions: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, *,
                    cp_index: int, local_len: int):
    """Decode append onto a sequence shard, in place: cache_k/v [slots,
    local_len, Hkv, D]; positions [B] global; only the tokens this shard
    owns are written (each global position is stored once across the cp
    group)."""
    own, p_loc = _owned(positions, cp_index, local_len)
    b = own.nonzero(as_tuple=True)[0]
    s = slots.long()[b]
    cache_k[s, p_loc[b]] = k_new[b].to(cache_k.dtype)
    cache_v[s, p_loc[b]] = v_new[b].to(cache_v.dtype)
    return cache_k, cache_v


def append_chunk_cp(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    slots: torch.Tensor, starts: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, *,
                    cp_index: int, local_len: int):
    """T-token append onto a sequence shard, in place: token i of request
    b lands at global position starts[b] + i where this shard owns it (a
    chunk may straddle the shard boundary); k/v_new [B, T, Hkv, D]."""
    sb, pos = _chunk_index(slots, starts, k_new.shape[1])
    own, p_loc = _owned(pos, cp_index, local_len)
    bi, ti = own.nonzero(as_tuple=True)
    cache_k[sb[bi, 0], p_loc[bi, ti]] = k_new[bi, ti].to(cache_k.dtype)
    cache_v[sb[bi, 0], p_loc[bi, ti]] = v_new[bi, ti].to(cache_v.dtype)
    return cache_k, cache_v


def append_token_quant_cp(cache_k, cache_v, scale_k, scale_v,
                          slots: torch.Tensor, positions: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor, *,
                          cp_index: int, local_len: int):
    """Quantized twin of append_token_cp: codes and scales land on the
    owning shard only."""
    own, p_loc = _owned(positions, cp_index, local_len)
    b = own.nonzero(as_tuple=True)[0]
    s = slots.long()[b]
    for codes, scales, x in ((cache_k, scale_k, k_new),
                             (cache_v, scale_v, v_new)):
        codes[s, p_loc[b]], scales[s, p_loc[b]] = quantize_kv(x[b])
    return cache_k, cache_v, scale_k, scale_v


def append_chunk_quant_cp(cache_k, cache_v, scale_k, scale_v,
                          slots: torch.Tensor, starts: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor, *,
                          cp_index: int, local_len: int):
    """Quantized twin of append_chunk_cp."""
    sb, pos = _chunk_index(slots, starts, k_new.shape[1])
    own, p_loc = _owned(pos, cp_index, local_len)
    bi, ti = own.nonzero(as_tuple=True)
    at = (sb[bi, 0], p_loc[bi, ti])
    for codes, scales, x in ((cache_k, scale_k, k_new),
                             (cache_v, scale_v, v_new)):
        codes[at], scales[at] = quantize_kv(x[bi, ti])
    return cache_k, cache_v, scale_k, scale_v


def _partial_softmax(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                     vsc=None, chunk: bool = False):
    """JAX's XLA partial (kv_cache.py:604-760): logits s masked to -1e30,
    the local max m, p = exp(s - m), l = sum p, acc = (p, times the V
    scales where given, zero where masked) V. s [B, Hkv, g, (T,) L]."""
    s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if vsc is not None:
        p = torch.where(mask, p * vsc, torch.zeros((), device=s.device))
    eq = "bhgtl,blhd->bthgd" if chunk else "bhgl,blhd->bhgd"
    return torch.einsum(eq, p, v.float()), m, l


def _partial_out(acc, m, l, chunk: bool):
    """[B, (T,) H, D] / [B, (T,) H] from the [B, Hkv, g, ...] partials."""
    if chunk:
        B, T, Hkv, g, D = acc.shape
        perm = (0, 3, 1, 2, 4)
        return (acc.reshape(B, T, Hkv * g, D),
                m.permute(*perm).reshape(B, T, Hkv * g),
                l.permute(*perm).reshape(B, T, Hkv * g))
    B, Hkv, g, D = acc.shape
    return (acc.reshape(B, Hkv * g, D), m.reshape(B, Hkv * g),
            l.reshape(B, Hkv * g))


def _gathered(slots, *caches):
    s = slots.long()
    return [None if c is None else c[s] for c in caches]


def decode_attention_partial(q: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, slots: torch.Tensor,
                             lengths_local: torch.Tensor, *, num_heads: int,
                             use_flash: Optional[bool] = None):
    """Single-token attention state over ONE sequence shard: q [B, H, D];
    cache_k/v [slots, local_len, Hkv, D]; lengths_local [B] valid keys in
    this shard (the global length clipped to its range) -> (acc [B, H, D],
    m [B, H], l [B, H]) for the log-sum-exp merge (section comment).
    Lane-aligned head dims take kernel 5 in partial_stats mode
    (length-proportional shard reads); others the plain softmax."""
    B, H, D = q.shape
    if use_flash is None:
        use_flash = D % 128 == 0
    if use_flash:
        lengths_local, slots = _int32(lengths_local, slots)
        return flash_decode(q, cache_k, cache_v, lengths_local, slots,
                            partial_stats=True)
    k, v = _gathered(slots, cache_k, cache_v)
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,blhd->bhgl", qf, k.float()) / math.sqrt(D)
    mask = (torch.arange(k.shape[1], device=q.device)[None]
            < lengths_local.long()[:, None])[:, None, None, :]
    return _partial_out(*_partial_softmax(s, mask, v), chunk=False)


def decode_attention_quant_partial(q: torch.Tensor, cache_k: torch.Tensor,
                                   cache_v: torch.Tensor,
                                   scale_k: torch.Tensor,
                                   scale_v: torch.Tensor,
                                   slots: torch.Tensor,
                                   lengths_local: torch.Tensor, *,
                                   num_heads: int,
                                   use_flash: Optional[bool] = None):
    """int8 twin of decode_attention_partial: the K scales on the logits
    before the local max, the V scales in the weights of acc (not in l).
    Lane-aligned head dims take kernel 6 in partial_stats mode."""
    B, H, D = q.shape
    if use_flash is None:
        use_flash = D % 128 == 0
    if use_flash:
        lengths_local, slots = _int32(lengths_local, slots)
        return flash_decode_quant(q, cache_k, cache_v, scale_k, scale_v,
                                  lengths_local, slots, partial_stats=True)
    k, v, ks, vs = _gathered(slots, cache_k, cache_v, scale_k, scale_v)
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,blhd->bhgl", qf, k.float())
    s = s * ks.float().permute(0, 2, 1)[:, :, None, :] / math.sqrt(D)
    mask = (torch.arange(k.shape[1], device=q.device)[None]
            < lengths_local.long()[:, None])[:, None, None, :]
    return _partial_out(*_partial_softmax(
        s, mask, v, vs.float().permute(0, 2, 1)[:, :, None, :]), chunk=False)


def _chunk_partial_mask(limits_local: torch.Tensor, L: int) -> torch.Tensor:
    pos = torch.arange(L, device=limits_local.device)[None, None, :]
    return (pos < limits_local.long()[:, :, None])[:, None, None]


def chunk_attention_partial(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, slots: torch.Tensor,
                            limits_local: torch.Tensor, *, num_heads: int):
    """T-token causal attention state over ONE sequence shard:
    limits_local [B, T] = each query's valid positions in this shard (its
    global causal limit starts[b] + i + 1 clipped to the shard's range) ->
    (acc [B, T, H, D], m [B, T, H], l [B, T, H])."""
    B, T, H, D = q.shape
    k, v = _gathered(slots, cache_k, cache_v)
    Hkv = k.shape[2]
    qf = q.float().reshape(B, T, Hkv, H // Hkv, D)
    s = torch.einsum("bthgd,blhd->bhgtl", qf, k.float()) / math.sqrt(D)
    mask = _chunk_partial_mask(limits_local, k.shape[1])
    return _partial_out(*_partial_softmax(s, mask, v, chunk=True),
                        chunk=True)


def chunk_attention_quant_partial(q: torch.Tensor, cache_k: torch.Tensor,
                                  cache_v: torch.Tensor,
                                  scale_k: torch.Tensor,
                                  scale_v: torch.Tensor, slots: torch.Tensor,
                                  limits_local: torch.Tensor, *,
                                  num_heads: int):
    """int8 twin of chunk_attention_partial (the scale factorisation of
    chunk_attention_quant)."""
    B, T, H, D = q.shape
    k, v, ks, vs = _gathered(slots, cache_k, cache_v, scale_k, scale_v)
    Hkv = k.shape[2]
    qf = q.float().reshape(B, T, Hkv, H // Hkv, D)
    s = torch.einsum("bthgd,blhd->bhgtl", qf, k.float()) / math.sqrt(D)
    s = s * ks.float().permute(0, 2, 1)[:, :, None, None, :]
    mask = _chunk_partial_mask(limits_local, k.shape[1])
    return _partial_out(*_partial_softmax(
        s, mask, v, vs.float().permute(0, 2, 1)[:, :, None, None, :],
        chunk=True), chunk=True)

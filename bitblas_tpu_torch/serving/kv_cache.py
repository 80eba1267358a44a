"""KV caches for decode serving (counterpart of
bitblas_tpu/serving/kv_cache.py: the slot cache, its int8 twin, the paged
block pool and its int8 twin):

  slot   k/v : [num_layers, num_slots, max_seq_len, kv_heads, head_dim]
  paged  k/v : [num_layers, num_blocks, block_size, kv_heads, head_dim]
               + block tables [num_slots, max_blocks_per_slot] (host side)
  int8       : codes in k/v, f32 scales [...,  kv_heads] in k_scale/v_scale

Unlike the JAX package, whose arrays are immutable, the caches here are
updated IN PLACE: the writers and appenders write into the tensors they
are given (and return them for call-site parity), so a decode step never
copies a cache. The block pool is indexed like the slot cache, with
(block, offset) in place of (slot, position), so the paged appenders are
the slot appenders. The ring cache and chunked appends are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
    takes D = 128 and 256 and raises on other such head dims); other head
    dims take the plain length-masked decode."""
    if window is not None:
        raise NotImplementedError("sliding-window decode is not ported yet")
    lengths, slots = _int32(lengths, slots)
    if q.shape[-1] % 128 == 0:
        return flash_decode(q, cache_k, cache_v, lengths, slots)
    return flash_decode_plain(q, cache_k, cache_v, lengths, slots)


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
    run the int8 flash-decode kernel; other head dims its plain
    version."""
    if window is not None:
        raise NotImplementedError("sliding-window decode is not ported yet")
    lengths, slots = _int32(lengths, slots)
    fn = flash_decode_quant if q.shape[-1] % 128 == 0 \
        else flash_decode_quant_plain
    return fn(q, cache_k, cache_v, scale_k, scale_v, lengths, slots)


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
    any GQA group; the kernel takes D = 128 and 256 and raises on other
    such head dims), and the plain table gather otherwise; False always
    takes the gather (the same function); True the kernel's wrapper."""
    if window is not None:
        raise NotImplementedError("sliding-window decode is not ported yet")
    tables, lengths = _int32(tables, lengths)
    fn = flash_decode_paged if _use_paged_kernel(q, use_flash) \
        else flash_decode_paged_plain
    return fn(q, cache_k, cache_v, tables, lengths)


def decode_attention_paged_quant(q: torch.Tensor, cache_k: torch.Tensor,
                                 cache_v: torch.Tensor,
                                 scale_k: torch.Tensor,
                                 scale_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor, *, num_heads: int,
                                 use_flash: Optional[bool] = None,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Quantized twin of decode_attention_paged over the int8 pool and its
    scale planes [blocks, bs, Hkv]; same routing."""
    if window is not None:
        raise NotImplementedError("sliding-window decode is not ported yet")
    tables, lengths = _int32(tables, lengths)
    fn = flash_decode_paged_quant if _use_paged_kernel(q, use_flash) \
        else flash_decode_paged_quant_plain
    return fn(q, cache_k, cache_v, scale_k, scale_v, tables, lengths)


class BlockAllocator:
    """Host-side free list over the physical block pool."""

    def __init__(self, num_blocks: int):
        self.free = list(range(num_blocks))[::-1]

    def alloc(self) -> Optional[int]:
        return self.free.pop() if self.free else None

    def release(self, blocks) -> None:
        self.free.extend(int(b) for b in blocks)

    @property
    def available(self) -> int:
        return len(self.free)

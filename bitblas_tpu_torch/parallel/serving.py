"""Tensor-parallel serving: head-local decode over rank-local KV caches
(counterpart of bitblas_tpu/parallel/serving.py).

Layout of a decoder layer on each rank (Megatron's, attention kept local
between the projections):

  q/k/v   one fused column-parallel matmul (the rank's heads)   no collective
  attn    the rank's q heads against its KV heads
  o       row-parallel over the rank's head dims                1 all-reduce
  gate/up one fused column-parallel matmul                      no collective
  down    row-parallel                                          1 all-reduce

Two float32 all-reduces a layer; activations are replicated between the
layers. Each rank's engine holds only its rank's KV heads (the cache shape
comes from `kv_cache_shape`), so attention never moves cache data.

`TPQuantLlama(src, group)` is built from a single-device
models.quant_llama.QuantLlama on every rank of `group` (the same weights
on each: the same seed or checkpoint) and serves the protocol the engines
drive (`cfg`, `device`, `make_prefill`, the decode steps and chunks on the
slot cache, float or int8, the ring, and the paged steps). Every rank runs
the same host-side schedule and, from replicated logits, samples the same
greedy tokens.

With fewer KV heads than ranks each source KV head is replicated
tp / num_kv_heads times (`kv_rep`). context_parallel=True shards the
cache's SEQUENCE axis across those kv_rep ranks instead (process
subgroups of kv_rep consecutive ranks, JAX's axis-major order): each rank
keeps one source KV head and max_seq_len / kv_rep rows, the cp group
all-gathers its q heads, each rank attends them over its rows (kernels 5
and 6 in partial_stats mode for a step) and the partials merge by
log-sum-exp.

JAX's refusals hold: attention biases, a sliding window with
context_parallel, a paged step with either, non-uint4 weights. A row
shard whose K breaks the group size or kernel 1's K rule is refused
(parallel.check_row_shard).

Collectives are counted in `allreduces` (the row-parallel sums) and
`collectives` (every call), and their host seconds in `collective_s`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch
import torch.distributed as dist

from ..models.quant_llama import (DecoderServingMixin, QuantLlama,
                                  causal_attention, prefill_flash, rmsnorm,
                                  rope)
from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from . import all_gather, check_row_shard

def _quantized_allreduce(part: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce through an int8 all-gather: each rank quantizes its f32
    partial per row (absmax, scale 127 / amax), all-gathers codes and
    scales, and sums the dequantized copies. One int8 rounding a partial
    (about 0.4% of its row's absmax)."""
    amax = part.abs().amax(dim=-1, keepdim=True)
    scale = 127.0 / amax.clamp_min(1e-20)
    q = torch.clamp(torch.round(part * scale), -127, 127).to(torch.int8)
    qs = all_gather(q[None], 0, group)          # [tp, B, N] int8
    ss = all_gather(scale[None], 0, group)      # [tp, B, 1] f32
    return (qs.float() / ss).sum(dim=0)


class TPQuantLlama:
    """A QuantLlama's layers sharded over the ranks of `group`."""

    def __init__(self, src: QuantLlama, group=None, *,
                 quantized_collectives: bool = False,
                 overlap_chunks: int = 1, context_parallel: bool = False):
        cfg = src.cfg
        if cfg.attention_bias or any(hasattr(l, "q_bias")
                                     for l in src.layers):
            raise NotImplementedError(
                "TPQuantLlama does not carry q/k/v projection biases "
                "(Qwen2-style attention_bias): the fused qkv kernel would "
                "drop them")
        if cfg.sliding_window is not None and context_parallel:
            raise NotImplementedError(
                "context_parallel + sliding_window is not implemented "
                f"(sliding_window={cfg.sliding_window})")
        for layer in src.layers:
            for name, op in layer.ops.items():
                if op.config.W_dtype != "uint4":
                    raise NotImplementedError(
                        f"TPQuantLlama takes uint4 weights only, got "
                        f"{op.config.W_dtype} for {name}")
        self.group = group
        self.tp = tp = dist.get_world_size(group)
        self.rank = rank = dist.get_rank(group)
        self.device = src.device
        if cfg.num_heads % tp:
            raise ValueError(f"tp={tp} must divide num_heads="
                             f"{cfg.num_heads}")
        if cfg.num_kv_heads % tp == 0:
            self.kv_rep = 1
        elif tp % cfg.num_kv_heads == 0:
            self.kv_rep = tp // cfg.num_kv_heads
        else:
            raise ValueError("need num_kv_heads % tp == 0 or tp % "
                             "num_kv_heads == 0")
        self.kv_eff = cfg.num_kv_heads * self.kv_rep
        self.kvl = self.kv_eff // tp        # KV heads a rank computes
        self.hl = cfg.num_heads // tp       # q heads a rank computes
        self.context_parallel = bool(context_parallel) and self.kv_rep > 1
        self.cp, self.cp_index, self.cp_group = 1, 0, None
        if self.context_parallel:
            self.cp = self.kv_rep
            self.cp_index = rank % self.cp
            ranks = dist.get_process_group_ranks(group) \
                if group is not None else list(range(tp))
            a = rank // self.cp
            # only the members make their group (its name hashes the ranks)
            self.cp_group = dist.new_group(
                ranks[a * self.cp:(a + 1) * self.cp],
                use_local_synchronization=True)
            self.cfg = dataclasses.replace(cfg)
        else:
            # the engines read .cfg: the effective (replicated) KV heads
            self.cfg = dataclasses.replace(cfg, num_kv_heads=self.kv_eff)
        self.quantized_collectives = quantized_collectives
        self.overlap_chunks = nc = int(overlap_chunks)
        H, D, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        kv_size = self.kv_eff * D
        full = {"qkv": (H + 2 * kv_size, H), "o": (H, H),
                "gateup": (2 * inter, H), "down": (H, inter)}
        self.mcfg: Dict[str, MatmulConfig] = {
            name: MatmulConfig(
                M=None, N=n, K=k, A_dtype=cfg.act_dtype, W_dtype="uint4",
                with_scaling=True, with_zeros=True, zeros_mode="original",
                group_size=cfg.group_size, out_dtype=cfg.act_dtype)
            for name, (n, k) in full.items()}
        if nc > 1 and (H % nc or (H // nc) % 256):
            raise ValueError("chunk width must cover whole pack tiles (256)")
        for name in ("o", "down"):
            check_row_shard(self.mcfg[name], tp)
        local = {"qkv": ((self.hl + 2 * self.kvl) * D, H),
                 "gateup": (2 * inter // tp, H),
                 "o": (H // nc, H // tp), "down": (H // nc, inter // tp)}
        self.ops: Dict[str, Matmul] = {
            name: Matmul(dataclasses.replace(self.mcfg[name], N=n, K=k),
                         device=self.device, enable_tuning=False)
            for name, (n, k) in local.items()}
        self.weights = [self._shard(layer) for layer in src.layers]
        self.norms = [(l.attn_norm, l.mlp_norm) for l in src.layers]
        self.allreduces = 0
        self.collectives = 0
        self.collective_s = 0.0

    # -- the rank's weights ---------------------------------------------------
    def _rows(self, layer, name: str, rows: torch.Tensor):
        """(words, scales, zeros) of output rows `rows` of `name`."""
        return (getattr(layer, f"{name}_qweight")[rows],
                getattr(layer, f"{name}_scales")[:, rows],
                getattr(layer, f"{name}_zeros")[:, rows])

    def _shard(self, layer):
        """One layer's fused, rank-local (words, scales, zeros): q / k / v
        and gate / up fused column-parallel (KV heads replicated kv_rep
        times first: effective head j is source head j // kv_rep), o and
        down row-parallel."""
        cfg, r, tp, D = self.cfg, self.rank, self.tp, self.cfg.head_dim
        dev = layer.attn_norm.device

        def heads(first: int, count: int, rep: int = 1):
            h = torch.arange(first, first + count, device=dev) // rep
            return (h[:, None] * D + torch.arange(D, device=dev)).reshape(-1)

        inter = cfg.intermediate_size // tp
        span = torch.arange(r * inter, (r + 1) * inter, device=dev)
        fused = {
            "qkv": [self._rows(layer, "q", heads(r * self.hl, self.hl)),
                    *(self._rows(layer, n, heads(r * self.kvl, self.kvl,
                                                 self.kv_rep))
                      for n in ("k", "v"))],
            "gateup": [self._rows(layer, n, span) for n in ("gate", "up")]}
        out = {name: tuple(torch.cat(t, dim=0 if i == 0 else 1).contiguous()
                           for i, t in enumerate(zip(*parts)))
               for name, parts in fused.items()}
        nc = self.overlap_chunks
        for name in ("o", "down"):
            w = getattr(layer, f"{name}_qweight")
            s = getattr(layer, f"{name}_scales")
            z = getattr(layer, f"{name}_zeros")
            kw, kg = w.shape[1] // tp, s.shape[0] // tp
            cw = w.shape[0] // nc
            # one (words, scales, zeros) a column chunk of overlap_chunks
            out[name] = [(w[c * cw:(c + 1) * cw, r * kw:(r + 1) * kw]
                          .contiguous(),
                          s[r * kg:(r + 1) * kg, c * cw:(c + 1) * cw]
                          .contiguous(),
                          z[r * kg:(r + 1) * kg, c * cw:(c + 1) * cw]
                          .contiguous()) for c in range(nc)]
        return out

    def kv_cache_shape(self, lead: int, rows: int, paged: bool = False):
        """This rank's cache shape [L, lead, rows, KV heads, D]: its
        effective KV heads, or under context parallelism its source KV
        heads and rows / cp of the sequence (rows must divide)."""
        cfg = self.cfg
        if paged:
            self._no_cp("the paged cache")
        if self.context_parallel:
            if rows % self.cp:
                raise ValueError(f"context_parallel: cp={self.cp} must "
                                 f"divide the cache's {rows} rows")
            return (cfg.num_layers, lead, rows // self.cp,
                    cfg.num_kv_heads * self.cp // self.tp, cfg.head_dim)
        return (cfg.num_layers, lead, rows, self.kvl, cfg.head_dim)

    def seq_shard(self, rows: int):
        """The global positions [lo, hi) this rank's cache rows hold."""
        if not self.context_parallel:
            return 0, rows
        n = rows // self.cp
        return self.cp_index * n, (self.cp_index + 1) * n

    # -- collectives ----------------------------------------------------------
    def _timed(self, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return out

    def _allreduce(self, part: torch.Tensor, async_op: bool = False):
        """The row-parallel sum of a float32 partial, in place (or, with
        quantized_collectives, through the int8 all-gather); async_op
        returns the pending work."""
        self.allreduces += 1
        if self.quantized_collectives:
            part.copy_(self._timed(_quantized_allreduce, part, self.group))
            return None
        return self._timed(dist.all_reduce, part, group=self.group,
                           async_op=async_op)

    def _row_proj(self, name: str, xin: torch.Tensor, w) -> torch.Tensor:
        """Row-parallel projection + all-reduce -> f32 [M, hidden]; `w` the
        (words, scales, zeros) of each column chunk: with overlap_chunks
        c > 1 each chunk's all-reduce is in flight while the next chunk's
        kernel runs."""
        op = self.ops[name]
        if len(w) == 1:
            W, S, Z = w[0]
            part = op.forward(xin, W, scale=S, zeros=Z).float()
            self._allreduce(part)
            return part
        parts, works = [], []
        for W, S, Z in w:
            p = op.forward(xin, W, scale=S, zeros=Z).float()
            works.append(self._allreduce(p, async_op=True))
            parts.append(p)
        for work in works:
            if work is not None:
                self._timed(work.wait)
        return torch.cat(parts, dim=1)

    def _merge(self, acc, m, l, head_dim: int):
        """Log-sum-exp merge of the cp group's partials over heads at
        `head_dim` of m / l; returns this rank's heads of the output."""
        g = self.cp_group
        m_g = m.clone()
        self._timed(dist.all_reduce, m_g, op=dist.ReduceOp.MAX, group=g)
        w = torch.exp(m - m_g)
        l_g = l * w
        acc_g = acc * w[..., None]
        self._timed(dist.all_reduce, l_g, group=g)
        self._timed(dist.all_reduce, acc_g, group=g)
        out = acc_g / l_g.clamp_min(1e-30)[..., None]
        return out.narrow(head_dim, self.cp_index * self.hl, self.hl)

    def _gather_q(self, q: torch.Tensor, dim: int) -> torch.Tensor:
        return self._timed(all_gather, q, dim, self.cp_group)

    # -- the layer stack ------------------------------------------------------
    def _layers(self, x, positions, attend, B: int, T: int):
        """rmsnorm -> fused qkv (the rank's heads) -> rope -> attend(li, q,
        k, v) -> row-parallel o -> rmsnorm -> fused gate/up -> silu * up ->
        row-parallel down, every layer; q [B, T, hl, D], k / v [B, T, kvl,
        D], attend returns [B, T, hl, D]."""
        cfg = self.cfg
        Hd, D, hl, kvl = cfg.hidden_size, cfg.head_dim, self.hl, self.kvl
        il = cfg.intermediate_size // self.tp
        for li, w in enumerate(self.weights):
            attn_norm, mlp_norm = self.norms[li]
            h2 = rmsnorm(x, attn_norm, cfg.rms_norm_eps).reshape(B * T, Hd)
            W, S, Z = w["qkv"]
            qkv = self.ops["qkv"].forward(h2, W, scale=S, zeros=Z)
            q = rope(qkv[:, :hl * D].reshape(B, T, hl, D), positions,
                     cfg.rope_arg)
            k = rope(qkv[:, hl * D:(hl + kvl) * D].reshape(B, T, kvl, D),
                     positions, cfg.rope_arg)
            v = qkv[:, (hl + kvl) * D:].reshape(B, T, kvl, D)
            attn = attend(li, q, k, v)
            o = self._row_proj("o", attn.reshape(B * T, hl * D), w["o"])
            x = x + o.to(x.dtype).reshape(B, T, Hd)
            h2 = rmsnorm(x, mlp_norm, cfg.rms_norm_eps).reshape(B * T, Hd)
            W, S, Z = w["gateup"]
            gu = self.ops["gateup"].forward(h2, W, scale=S, zeros=Z)
            act = (torch.nn.functional.silu(gu[:, :il].float())
                   * gu[:, il:].float()).to(x.dtype)
            d = self._row_proj("down", act, w["down"])
            x = x + d.to(x.dtype).reshape(B, T, Hd)
        return x

    def _check_ring(self, ring: bool) -> None:
        if not ring:
            return
        if self.cfg.sliding_window is None:
            raise ValueError("ring cache requires cfg.sliding_window")
        if self.context_parallel:
            raise NotImplementedError(
                "ring + context_parallel is not implemented (the window "
                "already bounds the KV a rank holds; use kv_ring without "
                "cp)")

    def _no_swa(self, name: str) -> None:
        if self.cfg.sliding_window is not None:
            raise NotImplementedError(
                f"{name} does not implement sliding-window attention "
                f"(sliding_window={self.cfg.sliding_window})")

    def _no_cp(self, name: str) -> None:
        if self.context_parallel:
            raise NotImplementedError(
                f"{name} does not support context_parallel yet: cp mode "
                f"covers every slot-cache serving path (prefill, "
                f"decode_step/chunk, float + int8 KV); run with "
                f"context_parallel=False for the paged variants")

    # -- the slot cache ---------------------------------------------------------
    def _slot(self, x, caches, slots, lengths, *, chunk: bool, ring: bool):
        """Every slot-cache step and chunk: the single-device decoder's
        appends and attends over the rank's KV heads, or under context
        parallelism the shard's appends, partials and merge. `caches`
        (K, V) or, int8, (K, V, K scales, V scales), updated in place."""
        from ..serving import kv_cache as kvc
        self._check_ring(ring)
        quant = len(caches) == 4
        B, T = x.shape[:2]
        positions = lengths[:, None] + torch.arange(
            T, device=lengths.device, dtype=lengths.dtype)
        hl = self.hl
        if self.context_parallel:
            append = {(False, False): kvc.append_token_cp,
                      (True, False): kvc.append_chunk_cp,
                      (False, True): kvc.append_token_quant_cp,
                      (True, True): kvc.append_chunk_quant_cp}[chunk, quant]
            partial = {(False, False): kvc.decode_attention_partial,
                       (True, False): kvc.chunk_attention_partial,
                       (False, True): kvc.decode_attention_quant_partial,
                       (True, True): kvc.chunk_attention_quant_partial}[
                chunk, quant]
            s_loc = caches[0].shape[2]
            c = self.cp_index
            # each query's causal limit, clipped to this shard
            limit = positions + 1 if chunk else lengths + 1
            lloc = (limit - c * s_loc).clamp(0, s_loc)

            def attend(li, q, k, v):
                cache = tuple(t[li] for t in caches)
                kk, vv = (k, v) if chunk else (k[:, 0], v[:, 0])
                append(*cache, slots, lengths, kk, vv, cp_index=c,
                       local_len=s_loc)
                # the cp group shares a KV head but not its q heads: attend
                # the union over this shard, merge, keep this rank's heads
                qg = self._gather_q(q if chunk else q[:, 0], 2 if chunk
                                    else 1)
                acc, m, l = partial(qg.contiguous(), *cache, slots, lloc,
                                    num_heads=qg.shape[-2])
                out = self._merge(acc, m, l, 2 if chunk else 1)
                out = out.to(q.dtype)
                return out if chunk else out[:, None]
        else:
            table = {
                (False, False): (kvc.append_token, kvc.decode_attention),
                (False, True): (kvc.append_token_ring,
                                kvc.ring_decode_attention),
                (True, False): (kvc.append_chunk, kvc.chunk_attention),
                (True, True): (kvc.append_chunk_ring,
                               kvc.ring_chunk_attention),
            } if not quant else {
                (False, False): (kvc.append_token_quant,
                                 kvc.decode_attention_quant),
                (False, True): (kvc.append_token_ring_quant,
                                kvc.ring_decode_attention_quant),
                (True, False): (kvc.append_chunk_quant,
                                kvc.chunk_attention_quant),
                (True, True): (kvc.append_chunk_ring_quant,
                               kvc.ring_chunk_attention_quant),
            }
            append, attention = table[chunk, ring]
            seen = lengths if chunk else lengths + 1
            window = self.cfg.sliding_window

            def attend(li, q, k, v):
                cache = tuple(t[li] for t in caches)
                if chunk:
                    append(*cache, slots, lengths, k, v)
                    return attention(q, *cache, slots, seen, num_heads=hl,
                                     window=window)
                append(*cache, slots, lengths, k[:, 0], v[:, 0])
                return attention(q[:, 0].contiguous(), *cache, slots, seen,
                                 num_heads=hl, window=window)[:, None]

        return (self._layers(x, positions, attend, B, T), *caches)

    def decode_step(self, x, caches_k, caches_v, slots, lengths, *,
                    ring: bool = False):
        """x [B, 1, H]; this rank's caches [L, slots, S(/cp), kv heads,
        D], updated in place; as QuantLlama.decode_step."""
        return self._slot(x, (caches_k, caches_v), slots, lengths,
                          chunk=False, ring=ring)

    def decode_step_quant(self, x, caches_k, caches_v, scales_k, scales_v,
                          slots, lengths, *, ring: bool = False):
        """decode_step against this rank's int8 cache and scales."""
        return self._slot(x, (caches_k, caches_v, scales_k, scales_v),
                          slots, lengths, chunk=False, ring=ring)

    def decode_chunk(self, x, caches_k, caches_v, slots, lengths, *,
                     ring: bool = False):
        """T tokens a slot in one pass (chunked prefill): x [B, T, H];
        the rank's projections run at M = B * T."""
        return self._slot(x, (caches_k, caches_v), slots, lengths,
                          chunk=True, ring=ring)

    def decode_chunk_quant(self, x, caches_k, caches_v, scales_k, scales_v,
                           slots, lengths, *, ring: bool = False):
        """decode_chunk against this rank's int8 cache and scales."""
        return self._slot(x, (caches_k, caches_v, scales_k, scales_v),
                          slots, lengths, chunk=True, ring=ring)

    # -- the paged cache --------------------------------------------------------
    def _paged(self, x, caches, tables, block_rows, offsets, lengths,
               name: str):
        from ..serving import kv_cache as kvc
        self._no_cp(name)
        self._no_swa(name)
        quant = len(caches) == 4
        append = kvc.append_token_paged_quant if quant \
            else kvc.append_token_paged
        attention = kvc.decode_attention_paged_quant if quant \
            else kvc.decode_attention_paged

        def attend(li, q, k, v):
            cache = tuple(t[li] for t in caches)
            append(*cache, block_rows, offsets, k[:, 0], v[:, 0])
            return attention(q[:, 0].contiguous(), *cache, tables,
                             lengths + 1, num_heads=self.hl)[:, None]

        B = x.shape[0]
        return (self._layers(x, lengths[:, None], attend, B, 1), *caches)

    def decode_step_paged(self, x, caches_k, caches_v, tables, block_rows,
                          offsets, lengths):
        """One-token decode against this rank's share of the block pool
        [L, blocks, bs, kv heads, D] (its KV heads); tables / block_rows /
        offsets as QuantLlama.decode_step_paged's."""
        return self._paged(x, (caches_k, caches_v), tables, block_rows,
                           offsets, lengths, "decode_step_paged")

    def decode_step_paged_quant(self, x, caches_k, caches_v, scales_k,
                                scales_v, tables, block_rows, offsets,
                                lengths):
        """decode_step_paged against this rank's int8 pool and scales."""
        return self._paged(x, (caches_k, caches_v, scales_k, scales_v),
                           tables, block_rows, offsets, lengths,
                           "decode_step_paged_quant")

    # -- prefill ------------------------------------------------------------------
    def make_prefill(self, seq_len: int):
        """fn(x [1, S, H], positions) -> (hidden, ks, vs): the layer stack
        with in-context causal attention over the rank's heads (the flash
        kernel by the single-device rule), ks / vs each layer's rank-local
        K/V [S, kvl, D] for the rank's cache (under context parallelism its
        source KV head, all S rows: the engine keeps the rows of its
        shard)."""
        cfg = self.cfg
        flash, refused = prefill_flash(cfg, seq_len, self.hl, self.kvl)

        def prefill(x, positions):
            if refused:
                DecoderServingMixin.plain_prefills += 1
            B, S, _ = x.shape
            ks, vs = [], []
            dtype = x.dtype

            def attend(li, q, k, v):
                ks.append(k[0])
                vs.append(v[0])
                return causal_attention(q, k, v, flash=flash,
                                        window=cfg.sliding_window,
                                        dtype=dtype)

            return self._layers(x, positions, attend, B, S), ks, vs

        return prefill

"""Continuous-batching decode engines (counterpart of
bitblas_tpu/serving/engine.py: Request, SlotAllocator,
ContinuousBatchingEngine, PagedContinuousBatchingEngine, TokenRequest,
TokenContinuousBatchingEngine, DataParallelEngineGroup).

* ContinuousBatchingEngine: a fixed pool of `num_slots` sequence slots
  backed by the slot KV cache, bfloat16 or, with `kv_quant=True`, int8
  codes + f32 per-(token, head) scales; the token engine inherits both.
* PagedContinuousBatchingEngine: hidden-state requests over a block pool
  (float or int8) with prefix caching; memory follows live tokens.
* DataParallelEngineGroup: a host router over replica engines.

A tensor-parallel model (parallel/serving.TPQuantLlama) is served by one
engine a rank, each driving the same schedule: the engine allocates only
the cache shape the model gives (`kv_cache_shape`: the rank's KV heads,
and under context parallelism its rows of the sequence) and writes a
prompt's K/V rows of its own sequence shard (`seq_shard`).

Caches are updated in place; scheduling is host-side; each `step()` runs
one decode step for every slot (inactive slots are masked by their
length). Prompts are prefilled at power-of-two buckets, so prompts of
129+ tokens reach the flash prefill kernel, or with `prefill_chunk=T` in
T-token pieces through the model's `decode_chunk`. A sliding-window model
can keep its slot cache as a window-sized ring (`kv_ring`, with
prefill_chunk).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .kv_cache import BlockAllocator, init_kv_scales, quantize_kv


@dataclasses.dataclass
class Request:
    uid: int
    prompt: object              # [S, hidden] prompt hidden states
    max_new: int = 16
    generated: int = 0
    slot: int = -1
    done: bool = False
    final_hidden: Optional[np.ndarray] = None   # snapshot at completion


class SlotAllocator:
    def __init__(self, num_slots: int):
        self.free = list(range(num_slots))[::-1]

    def alloc(self) -> Optional[int]:
        return self.free.pop() if self.free else None

    def release(self, slot: int):
        self.free.append(slot)


def _bucket(S: int) -> int:
    """The power-of-two prefill length that holds S tokens."""
    return 1 << (max(S - 1, 0)).bit_length() if S > 1 else 1


def _kv_shape(model, lead: int, rows: int, paged: bool = False):
    """The cache shape this engine holds: the model's `kv_cache_shape`
    where it has one (a tensor-parallel rank's share), else [L, lead,
    rows, Hkv, D]."""
    shape = getattr(model, "kv_cache_shape", None)
    if shape is not None:
        return shape(lead, rows, paged=paged)
    c = model.cfg
    return (c.num_layers, lead, rows, c.num_kv_heads, c.head_dim)


def _init_caches(engine, kv_shape, kv_quant: bool) -> None:
    """caches_k/v in bfloat16, or int8 with scales_k/v (f32, kv_shape
    without the head dim), on the engine's device."""
    engine.caches_k = torch.zeros(
        kv_shape, dtype=torch.int8 if kv_quant else torch.bfloat16,
        device=engine.device)
    engine.caches_v = torch.zeros_like(engine.caches_k)
    if kv_quant:
        engine.scales_k = init_kv_scales(kv_shape, engine.device)
        engine.scales_v = torch.zeros_like(engine.scales_k)


def _run_prefill(engine, prompt, bucket: int):
    """The prompt [S, hidden] zero-padded to `bucket` rows through the
    engine's model (one prefill function per bucket, kept in
    engine._prefills): (hidden [1, bucket, hidden], per-layer K/V lists
    of [bucket, Hkv, D])."""
    if bucket not in engine._prefills:
        engine._prefills[bucket] = engine.model.make_prefill(bucket)
    S = prompt.shape[0]
    x = torch.zeros((1, bucket, engine.cfg.hidden_size),
                    dtype=torch.float16, device=engine.device)
    x[0, :S] = torch.as_tensor(prompt).to(engine.device, torch.float16)
    positions = torch.arange(bucket, device=engine.device)[None]
    return engine._prefills[bucket](x, positions)


def _write_rows(engine, ks: torch.Tensor, vs: torch.Tensor,
                index) -> None:
    """Write stacked prompt K/V (ks/vs [L, ...rows..., Hkv, D]) into the
    engine's caches at caches[index], in place; `index` picks those rows
    (a slot's first positions, or whole blocks). An int8 cache gets the
    codes and scales of quantize_kv."""
    for cache, scales, x in (("caches_k", "scales_k", ks),
                             ("caches_v", "scales_v", vs)):
        dst = getattr(engine, cache)
        if engine.kv_quant:
            codes, sc = quantize_kv(x)
            dst[index] = codes
            getattr(engine, scales)[index] = sc
        else:
            dst[index] = x.to(dst.dtype)


class ContinuousBatchingEngine:
    """Drives decode steps over a slot pool on the model's device.
    kv_quant=True stores the cache as int8 codes + per-(token, head) f32
    scales (half the KV bytes per decode step and of the footprint); the
    model must expose decode_step_quant.

    prefill_chunk=T admits prompts through the model's decode_chunk in
    T-token pieces, the tail zero-padded (its pad rows land past the
    sequence's length, where attention never reads and later appends
    overwrite them; a tail that would run past the cache's last row is
    cut there instead).

    kv_ring=True (sliding-window models, with prefill_chunk): the cache
    rows become a window-sized ring (kv_cache ring section), R rows a slot
    instead of max_seq_len; kv_ring_capacity overrides R's default
    ring_capacity(window, T). R >= window + T - 1 is required: it keeps
    every key a chunk's first query needs and keeps the pad rows of a
    tail chunk out of every window."""

    def __init__(self, model, num_slots: int, max_seq_len: int,
                 kv_quant: bool = False, prefill_chunk: int = 0,
                 kv_ring: bool = False,
                 kv_ring_capacity: Optional[int] = None):
        self.prefill_chunk = int(prefill_chunk)
        self.kv_ring = bool(kv_ring)
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if self.prefill_chunk and kv_quant and not hasattr(
                model, "decode_chunk_quant"):
            raise ValueError("prefill_chunk with kv_quant needs the model "
                             "to expose decode_chunk_quant")
        cache_rows = max_seq_len
        if self.kv_ring:
            from .kv_cache import ring_capacity
            window = model.cfg.sliding_window
            if window is None:
                raise ValueError("kv_ring requires cfg.sliding_window")
            if not self.prefill_chunk:
                raise ValueError(
                    "kv_ring requires prefill_chunk > 0 (prompts must "
                    "enter through the wrap-aware decode_chunk path)")
            if kv_ring_capacity is not None:
                cache_rows = int(kv_ring_capacity)
            else:
                cache_rows = min(ring_capacity(window, self.prefill_chunk),
                                 max_seq_len)
            if cache_rows < window + self.prefill_chunk - 1:
                raise ValueError(
                    f"kv_ring: ring capacity {cache_rows} < window + "
                    f"prefill_chunk - 1 = {window + self.prefill_chunk - 1}"
                    f": the ring cannot keep the keys a chunk needs; raise "
                    f"the capacity, shrink prefill_chunk, or drop kv_ring")
        self.cache_rows = cache_rows
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.kv_quant = kv_quant
        self.alloc = SlotAllocator(num_slots)
        self.active: Dict[int, Request] = {}
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        c = self.cfg
        _init_caches(self, _kv_shape(model, num_slots, cache_rows), kv_quant)
        # the global positions this engine's cache rows hold
        shard = getattr(model, "seq_shard", None)
        self._rows = shard(cache_rows) if shard else (0, cache_rows)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.last_hidden = torch.zeros((num_slots, c.hidden_size),
                                       dtype=torch.float16,
                                       device=self.device)
        self._slots = torch.arange(num_slots, dtype=torch.int32,
                                   device=self.device)
        self._prefills = {}

    # -- request lifecycle -----------------------------------------------------
    def submit(self, req: Request):
        S = req.prompt.shape[0]
        if S > self.max_seq_len:
            raise ValueError(
                f"prompt length {S} exceeds max_seq_len {self.max_seq_len}")
        self.pending.append(req)

    def _admit(self):
        while self.pending:
            slot = self.alloc.alloc()
            if slot is None:
                return
            req = self.pending.pop(0)
            req.slot = slot
            self._prefill(req)
            self.active[slot] = req

    def _prefill(self, req: Request):
        if self.prefill_chunk:
            return self._prefill_chunked(req)
        S = req.prompt.shape[0]
        bucket = min(_bucket(S), self.max_seq_len)
        hidden, ks, vs = _run_prefill(self, req.prompt, bucket)
        # The whole bucket is written (the rows of it this cache holds);
        # rows past S are pad K/V that the length-masked decode never
        # reads and later appends overwrite.
        lo, hi = self._rows
        top = min(hi, bucket)
        if top > lo:
            _write_rows(self, torch.stack(ks)[:, lo:top],
                        torch.stack(vs)[:, lo:top],
                        (slice(None), req.slot, slice(0, top - lo)))
        self.lengths[req.slot] = S
        self.last_hidden[req.slot] = hidden[0, S - 1].to(
            self.last_hidden.dtype)

    def _caches(self):
        """The cache tensors a decode step or chunk takes, in order."""
        if self.kv_quant:
            return (self.caches_k, self.caches_v, self.scales_k,
                    self.scales_v)
        return self.caches_k, self.caches_v

    def _prefill_chunked(self, req: Request):
        """Admit a prompt through T-token decode_chunk calls, in place; the
        tail chunk is zero-padded (cut at the cache's last row on the slot
        cache)."""
        T = self.prefill_chunk
        S = req.prompt.shape[0]
        step = self.model.decode_chunk_quant if self.kv_quant \
            else self.model.decode_chunk
        kw = {"ring": True} if self.kv_ring else {}
        slots = self._slots[req.slot:req.slot + 1]
        prompt = torch.as_tensor(req.prompt).to(self.device, torch.float16)
        written, hidden, n = 0, None, 0
        while written < S:
            n = min(T, S - written)
            rows = T if self.kv_ring else min(T, self.cache_rows - written)
            x = torch.zeros((1, rows, self.cfg.hidden_size),
                            dtype=torch.float16, device=self.device)
            x[0, :n] = prompt[written:written + n]
            start = torch.tensor([written], dtype=torch.int32,
                                 device=self.device)
            hidden = step(x, *self._caches(), slots, start, **kw)[0]
            written += n
        self.lengths[req.slot] = S
        self.last_hidden[req.slot] = hidden[0, n - 1].to(
            self.last_hidden.dtype)

    # -- main loop ---------------------------------------------------------------
    def _run_decode(self) -> None:
        """One decode step over every slot; updates the caches (in place)
        and last_hidden."""
        lengths = torch.from_numpy(self.lengths).to(self.device)
        x = self.last_hidden[:, None, :]
        kw = {"ring": True} if self.kv_ring else {}
        step = self.model.decode_step_quant if self.kv_quant \
            else self.model.decode_step
        hidden = step(x, *self._caches(), self._slots, lengths, **kw)[0]
        self.last_hidden = hidden[:, 0, :].to(self.last_hidden.dtype)

    def step(self) -> int:
        """One decode step across all active slots; returns #active."""
        self._admit()
        if not self.active:
            return 0
        self._run_decode()
        finished_slots = []
        for slot, req in list(self.active.items()):
            self.lengths[slot] += 1
            req.generated += 1
            if (req.generated >= req.max_new
                    or self.lengths[slot] >= self.max_seq_len):
                req.done = True
                req.final_hidden = self.last_hidden[slot].float().cpu() \
                    .numpy()
                self.finished.append(req)
                finished_slots.append(slot)
        for slot in finished_slots:
            del self.active[slot]
            self.lengths[slot] = 0
            # released slots still flow through the masked batched step;
            # a stale hidden would grow through the residuals
            self.last_hidden[slot] = 0.0
            self.alloc.release(slot)
        return len(self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            self._admit()
            if not self.active and not self.pending:
                break
            self.step()
        return self.finished


class PagedContinuousBatchingEngine:
    """Continuous batching over a paged (block-pooled) KV cache.

    Memory follows live tokens instead of num_slots * max_seq_len: the
    host-side BlockAllocator hands fixed-size blocks to requests as their
    sequences grow and reclaims them on completion. Admission waits while
    the pool is short; a request that runs out of blocks mid-flight
    finishes early. Full prompt blocks are content-addressed (a sha1 hash
    chain over the prompt) and shared between requests through refcounts;
    shared blocks are never written. Requests carry hidden states (the
    JAX package's paged engine has no token loop either). kv_quant=True
    keeps the pool as int8 codes + f32 scale planes."""

    def __init__(self, model, num_slots: int, num_blocks: int,
                 block_size: int = 16, max_blocks_per_slot: int = 64,
                 prefix_caching: bool = True, kv_quant: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_blocks = max_blocks_per_slot
        self.prefix_caching = prefix_caching
        self.kv_quant = kv_quant
        self.slot_alloc = SlotAllocator(num_slots)
        # Physical block 0 is reserved: it fills unused table entries and
        # takes the appends of inactive slots (their block_rows resolve to
        # table[slot, 0] = 0), so it never holds live data.
        self.block_alloc = BlockAllocator(num_blocks)
        self.block_alloc.free.remove(0)
        self.active: Dict[int, Request] = {}
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        c = self.cfg
        _init_caches(self, _kv_shape(model, num_blocks, block_size,
                                     paged=True), kv_quant)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.tables = np.zeros((num_slots, max_blocks_per_slot), np.int32)
        self.slot_blocks: Dict[int, List[int]] = {}
        self.last_hidden = torch.zeros((num_slots, c.hidden_size),
                                       dtype=torch.float16,
                                       device=self.device)
        self._prefills = {}
        self.block_ref: Dict[int, int] = {}
        self.prefix_index: Dict[bytes, int] = {}
        self.block_key: Dict[int, bytes] = {}
        self.prefix_hits = 0

    # -- block bookkeeping ------------------------------------------------------
    def _blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def _grow_slot(self, slot: int, new_len: int) -> bool:
        """Ensure the slot owns enough blocks for new_len tokens."""
        have = self.slot_blocks.get(slot, [])
        need = self._blocks_needed(new_len)
        if need > self.max_blocks:
            return False
        while len(have) < need:
            b = self.block_alloc.alloc()
            if b is None:
                return False
            self.block_ref[b] = 1
            self.tables[slot, len(have)] = b
            have.append(b)
        self.slot_blocks[slot] = have
        return True

    def _unref(self, b: int):
        self.block_ref[b] -= 1
        if self.block_ref[b] == 0:
            del self.block_ref[b]
            key = self.block_key.pop(b, None)
            if key is not None:
                self.prefix_index.pop(key, None)
            self.block_alloc.release([b])

    def _release_slot(self, slot: int):
        for b in self.slot_blocks.pop(slot, []):
            self._unref(b)
        self.tables[slot, :] = 0
        self.lengths[slot] = 0
        self.last_hidden[slot] = 0.0
        self.slot_alloc.release(slot)

    def _finish(self, slot: int):
        req = self.active.pop(slot)
        req.done = True
        req.final_hidden = self.last_hidden[slot].float().cpu().numpy()
        self.finished.append(req)
        self._release_slot(slot)

    # -- request lifecycle -------------------------------------------------------
    def submit(self, req: Request):
        self.pending.append(req)

    def _admit(self):
        while self.pending:
            req = self.pending[0]
            S = req.prompt.shape[0]
            if (self.block_alloc.available
                    < self._blocks_needed(S + req.max_new)):
                return   # pool short: wait for completions
            slot = self.slot_alloc.alloc()
            if slot is None:
                return
            self.pending.pop(0)
            req.slot = slot
            if not self._grow_slot(slot, S):
                raise RuntimeError("admission check guaranteed blocks")
            self._prefill(req)
            self.active[slot] = req

    def _prefix_keys(self, prompt) -> List[bytes]:
        """Hash-chain keys for each FULL block of the prompt: key i covers
        tokens [0, (i + 1) * bs), so equal prefixes give equal keys."""
        bs = self.block_size
        prompt = np.asarray(torch.as_tensor(prompt).cpu(), np.float16)
        keys = []
        h = hashlib.sha1()
        for i in range(prompt.shape[0] // bs):
            h.update(np.ascontiguousarray(prompt[i * bs:(i + 1) * bs])
                     .tobytes())
            keys.append(h.digest())
        return keys

    def _prefill(self, req: Request):
        S = req.prompt.shape[0]
        bs = self.block_size
        slot = req.slot
        # Swap shared prefix blocks in for the private ones _grow_slot
        # handed out (shared full blocks are never written).
        blocks = self.slot_blocks[slot]
        write = [True] * len(blocks)
        keys = self._prefix_keys(req.prompt) if self.prefix_caching else []
        for i, key in enumerate(keys):
            shared = self.prefix_index.get(key)
            if shared is not None and shared != blocks[i]:
                self._unref(blocks[i])
                self.block_ref[shared] += 1
                blocks[i] = shared
                self.tables[slot, i] = shared
                write[i] = False
                self.prefix_hits += 1
            elif self.prefix_caching and blocks[i] not in self.block_key:
                # this (private) block becomes the prefix's owner
                self.prefix_index[key] = blocks[i]
                self.block_key[blocks[i]] = key
        self.slot_blocks[slot] = blocks

        hidden, ks, vs = _run_prefill(self, req.prompt, _bucket(S))
        # Scatter the prompt K/V into the slot's private blocks, in place:
        # rows [i * bs, (i + 1) * bs) into block blocks[i] where write[i].
        # Rows past S in the tail block hold prompt padding (zero rows
        # when the bucket is shorter than the blocks); decode masks them
        # by length and appends overwrite them.
        nb = len(blocks)
        rows = nb * bs

        def paged(x):
            x = torch.stack(list(x))[:, :rows]
            if x.shape[1] < rows:
                x = torch.nn.functional.pad(
                    x, (0, 0, 0, 0, 0, rows - x.shape[1]))
            return x.reshape(x.shape[0], nb, bs, *x.shape[2:])

        sel = [i for i in range(nb) if write[i]]
        if sel:
            pick = torch.tensor(sel, device=self.device)
            dst = torch.tensor([blocks[i] for i in sel], device=self.device)
            _write_rows(self, paged(ks)[:, pick], paged(vs)[:, pick],
                        (slice(None), dst))
        self.lengths[slot] = S
        self.last_hidden[slot] = hidden[0, S - 1].to(self.last_hidden.dtype)

    # -- main loop ----------------------------------------------------------------
    def step(self) -> int:
        self._admit()
        if not self.active:
            return 0
        # blocks for this step's appends
        for slot in list(self.active):
            if not self._grow_slot(slot, int(self.lengths[slot]) + 1):
                self._finish(slot)   # out of pool mid-flight: finish early
        if not self.active:
            return 0
        bs = self.block_size
        idx = np.arange(self.num_slots)
        block_rows = self.tables[idx, self.lengths // bs]
        offsets = self.lengths % bs

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        x = self.last_hidden[:, None, :]
        args = (dev(self.tables), dev(block_rows), dev(offsets),
                dev(self.lengths))
        if self.kv_quant:
            hidden = self.model.decode_step_paged_quant(
                x, self.caches_k, self.caches_v, self.scales_k,
                self.scales_v, *args)[0]
        else:
            hidden = self.model.decode_step_paged(
                x, self.caches_k, self.caches_v, *args)[0]
        self.last_hidden = hidden[:, 0, :].to(self.last_hidden.dtype)

        for slot, req in list(self.active.items()):
            self.lengths[slot] += 1
            req.generated += 1
            if req.generated >= req.max_new:
                self._finish(slot)
        return len(self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            self._admit()
            if not self.active and not self.pending:
                break
            self.step()
        return self.finished


class DataParallelEngineGroup:
    """Continuous batching across replicas: each replica is an engine over
    its own model (a card, or a tensor-parallel group), with its caches
    kept to itself, so the only traffic between replicas is requests in
    and results out, on the host. The group admits each request to the
    least-loaded replica, steps every replica a tick and gathers the
    completions. Any engine above serves (slot or paged, float or int8,
    single-device or tensor-parallel)."""

    def __init__(self, engines):
        if not engines:
            raise ValueError("need at least one replica engine")
        self.engines = list(engines)

    def _load(self, eng) -> int:
        return len(eng.active) + len(eng.pending)

    def submit(self, req: Request):
        min(self.engines, key=self._load).submit(req)

    def submit_tokens(self, uid: int, tokens, **kw) -> "TokenRequest":
        """Route a token request to the least-loaded replica (replicas
        must be TokenContinuousBatchingEngines)."""
        return min(self.engines, key=self._load).submit_tokens(uid, tokens,
                                                               **kw)

    def step(self) -> int:
        return sum(eng.step() for eng in self.engines)

    @property
    def finished(self) -> List[Request]:
        out = []
        for eng in self.engines:
            out.extend(eng.finished)
        return out

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not any(eng.active or eng.pending for eng in self.engines):
                break
            self.step()
        return self.finished


@dataclasses.dataclass
class TokenRequest(Request):
    """A Request whose prompt arrived as token ids and whose output is
    sampled token ids (`out_tokens`)."""
    tokens: np.ndarray = None
    temperature: float = 0.0
    top_k: int = 0
    eos_token_id: Optional[int] = None
    seed: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)


class TokenContinuousBatchingEngine(ContinuousBatchingEngine):
    """Token-in/token-out continuous batching: after every decode step the
    batch of last hiddens goes through `head.logits`, each active request
    samples its next token (per-request seeded numpy generator), and the
    sampled tokens' embeddings become the next step's inputs. `head`
    duck-types models.hf_import.LMHead."""

    def __init__(self, model, head, num_slots: int, max_seq_len: int,
                 **kw):
        super().__init__(model, num_slots, max_seq_len, **kw)
        self.head = head
        self._rngs: Dict[int, np.random.Generator] = {}

    def submit_tokens(self, uid: int, tokens, max_new: int = 16, *,
                      temperature: float = 0.0, top_k: int = 0,
                      eos_token_id: Optional[int] = None,
                      seed: int = 0) -> TokenRequest:
        toks = np.asarray(tokens).reshape(-1).astype(np.int32)
        if toks.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        embeds = self.head.embed_tokens(toks).to(torch.float16)
        req = TokenRequest(uid=uid, prompt=embeds, max_new=max_new,
                           tokens=toks, temperature=temperature,
                           top_k=top_k, eos_token_id=eos_token_id,
                           seed=seed)
        self.submit(req)
        return req

    def _sample(self, req: TokenRequest, logits_row: np.ndarray) -> int:
        from ..models.hf_import import sample_token
        rng = self._rngs.get(req.uid)
        if rng is None:
            rng = self._rngs[req.uid] = np.random.default_rng(req.seed)
        return sample_token(logits_row, temperature=req.temperature,
                            top_k=req.top_k, rng=rng)

    def _emit_token(self, req: TokenRequest) -> bool:
        """Sample req's first token from its prompt's last hidden; True
        when the request is already complete (eos / budget)."""
        slot = req.slot
        logits = self.head.logits(
            self.last_hidden[slot][None].float())[0].cpu().numpy()
        tok = self._sample(req, logits)
        req.out_tokens.append(tok)
        req.generated += 1
        done = (req.generated >= req.max_new
                or self.lengths[slot] >= self.max_seq_len
                or (req.eos_token_id is not None
                    and tok == req.eos_token_id))
        if not done:
            self.last_hidden[slot] = self.head.embed_tokens(tok).to(
                self.last_hidden.dtype)
        return done

    def _finish(self, req: Request) -> None:
        slot = req.slot
        req.done = True
        req.final_hidden = self.last_hidden[slot].float().cpu().numpy()
        self.finished.append(req)
        self._rngs.pop(req.uid, None)
        self.active.pop(slot, None)
        self.lengths[slot] = 0
        self.last_hidden[slot] = 0.0
        self.alloc.release(slot)

    def _admit(self):
        # The prompt's final hidden yields the first token at once; a
        # request done after it never joins the decode batch.
        while self.pending:
            slot = self.alloc.alloc()
            if slot is None:
                return
            req = self.pending.pop(0)
            req.slot = slot
            self._prefill(req)
            if isinstance(req, TokenRequest) and self._emit_token(req):
                self._finish(req)
            else:
                self.active[slot] = req

    def step(self) -> int:
        self._admit()
        if not self.active:
            return 0
        self._run_decode()
        any_tok = any(isinstance(r, TokenRequest)
                      for r in self.active.values())
        logits = self.head.logits(self.last_hidden.float()).cpu().numpy() \
            if any_tok else None
        continue_slots: List[int] = []
        continue_toks: List[int] = []
        finished: List[Request] = []
        for slot, req in list(self.active.items()):
            self.lengths[slot] += 1
            req.generated += 1
            if isinstance(req, TokenRequest):
                tok = self._sample(req, logits[slot])
                req.out_tokens.append(tok)
                if (req.generated >= req.max_new
                        or self.lengths[slot] >= self.max_seq_len
                        or (req.eos_token_id is not None
                            and tok == req.eos_token_id)):
                    finished.append(req)
                else:
                    continue_slots.append(slot)
                    continue_toks.append(tok)
            elif (req.generated >= req.max_new
                    or self.lengths[slot] >= self.max_seq_len):
                finished.append(req)
        for req in finished:
            self._finish(req)
        if continue_slots:
            idx = torch.tensor(continue_slots, device=self.device)
            self.last_hidden[idx] = self.head.embed_tokens(
                continue_toks).to(self.last_hidden.dtype)
        return len(self.active)

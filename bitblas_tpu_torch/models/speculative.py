"""Speculative decoding: a cheap draft model proposes, the target verifies
(counterpart of bitblas_tpu/models/speculative.py).

Decode streams every quantized weight for one token. Speculation turns
`gamma` draft tokens into one target pass over gamma + 1 rows, which
streams the target's weights once a burst instead of once a token.
Typical drafts: the same checkpoint quantized more coarsely, or a smaller
model.

Acceptance follows Leviathan et al. 2023, on the host in numpy over
[n, V] float32 logit rows, exactly as the JAX package's:
  * temperature = 0 (greedy): draft tokens are accepted while they equal
    the target's argmax, so the output is the target's own greedy
    stream.
  * temperature > 0: a draft token is accepted with probability
    min(1, p_target / p_draft); on a rejection the replacement is drawn
    from the residual max(0, p_t - p_d). The output is distributed as the
    target's own sampling.

`speculative_generate` verifies with a full forward over the sequence
(any tokens -> logits callable); `speculative_generate_cached` keeps a
slot KV cache for both models (`QuantLlamaLM`s, Llama or Mixtral) and
verifies each burst with one `decode_chunk`, which updates the caches in
place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@dataclass
class SpecStats:
    """Acceptance telemetry: `accepted` / `proposed` is the expected
    speedup's lever; `target_calls` against `tokens` the realized ratio;
    `rounds` the tokens each burst appended."""
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0
    draft_calls: int = 0
    tokens: int = 0
    rounds: List[int] = field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


def _softmax(z: np.ndarray, temperature: float) -> np.ndarray:
    z = z.astype(np.float64) / max(temperature, 1e-8)
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def _host_rows(out) -> np.ndarray:
    """A logits result (a tensor on any device, or an array) as float32
    numpy."""
    if isinstance(out, torch.Tensor):
        out = out.detach().float().cpu().numpy()
    return np.asarray(out, np.float32)


def _accept(proposal, tgt, draft_probs, temperature, rng):
    """Leviathan acceptance sweep: (n_accept, replacement or None), tgt[i]
    the target's logits after the prefix plus proposal[:i]."""
    n_accept = 0
    replacement = None
    for i, t in enumerate(proposal):
        if temperature <= 0.0:
            ok = int(np.argmax(tgt[i])) == t
            if not ok:
                replacement = int(np.argmax(tgt[i]))
        else:
            p_t = _softmax(tgt[i], temperature)
            p_d = draft_probs[i]
            ok = rng.random() < min(1.0, p_t[t] / max(p_d[t], 1e-12))
            if not ok:
                residual = np.maximum(p_t - p_d, 0.0)
                s = residual.sum()
                residual = residual / s if s > 0 else p_t
                replacement = int(rng.choice(residual.shape[0],
                                             p=residual))
        if not ok:
            break
        n_accept += 1
    return n_accept, replacement


def _speculate(target_rows, draft_rows, prompt_tokens, max_new_tokens,
               gamma, temperature, eos_token_id, seed, after_round=None):
    """The draft / verify loop shared by both entry points.
    `draft_rows(seq)` gives the draft's [V] logits after seq,
    `target_rows(seq, n)` the target's last n rows [n, V] over seq;
    `after_round(n_tokens)` runs after each burst."""
    toks = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
    budget = max_new_tokens
    rng = np.random.default_rng(seed)
    stats = SpecStats()

    def pick(row: np.ndarray) -> int:
        if temperature <= 0.0:
            return int(np.argmax(row))
        return int(rng.choice(row.shape[0], p=_softmax(row, temperature)))

    done = False
    while budget > 0 and not done:
        g = min(gamma, budget)
        # the draft proposes g tokens, one at a time
        draft_seq = list(toks)
        draft_probs = []
        for _ in range(g):
            row = draft_rows(draft_seq)
            stats.draft_calls += 1
            draft_seq.append(pick(row))
            draft_probs.append(
                None if temperature <= 0.0 else _softmax(row, temperature))
        proposal = draft_seq[len(toks):]
        stats.proposed += g

        # one target pass scores the g proposals and the bonus slot: tgt[i]
        # are the logits after toks + proposal[:i]
        tgt = target_rows(draft_seq, g + 1)
        stats.target_calls += 1

        n_accept, replacement = _accept(proposal, tgt, draft_probs,
                                        temperature, rng)
        stats.accepted += n_accept
        new = list(proposal[:n_accept])
        if n_accept < g:
            new.append(replacement)          # the corrected token
        elif budget - len(new) > 0:
            new.append(pick(tgt[g]))         # the target's bonus token
        appended = 0
        for t in new[:budget]:
            toks.append(int(t))
            budget -= 1
            stats.tokens += 1
            appended += 1
            if eos_token_id is not None and t == eos_token_id:
                done = True
                break
        stats.rounds.append(appended)
        if after_round is not None:
            after_round(len(toks))
    return np.asarray(toks, np.int32), stats


def _check(gamma: int, prompt_tokens) -> None:
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    if np.asarray(prompt_tokens).size == 0:
        raise ValueError("prompt_tokens must hold at least one token")


def speculative_generate(target_lm, draft_lm, prompt_tokens,
                         max_new_tokens: int = 32, *, gamma: int = 4,
                         temperature: float = 0.0,
                         eos_token_id: Optional[int] = None, seed: int = 0,
                         return_stats: bool = False):
    """Generate with draft / verify speculation, each call a full forward.

    target_lm / draft_lm: tokens -> logits callables over [1, S] int32
    token ids (e.g. `QuantLlamaLM`), returning [1, S, V] logits as a
    tensor or an array. Returns the full token sequence [S + new] int32
    (and the `SpecStats` with return_stats=True)."""
    _check(gamma, prompt_tokens)

    def rows(lm, seq, n):
        ids = torch.from_numpy(np.asarray(seq, np.int32))[None]
        return _host_rows(lm(ids))[0, -n:]

    out, stats = _speculate(
        lambda seq, n: rows(target_lm, seq, n),
        lambda seq: rows(draft_lm, seq, 1)[0], prompt_tokens,
        max_new_tokens, gamma, temperature, eos_token_id, seed)
    return (out, stats) if return_stats else out


class _CachedLM:
    """A KV-cached single-slot view of a QuantLlamaLM: logits after any
    prefix without recomputing it. The prompt is prefilled through
    `make_prefill` (the flash kernel where the prompt takes it) into one
    slot cache [L, 1, capacity, Hkv, D] in the hidden dtype, as
    `QuantLlamaLM.generate` keeps it; `decode_chunk` appends each chunk
    IN PLACE. Rolling back a rejected burst is free: rows past `lengths`
    are masked, and the next chunk overwrites them."""

    def __init__(self, lm, prompt_toks: List[int], capacity: int):
        model = lm.model
        cfg, dev = model.cfg, model.device
        self.lm = lm
        S = len(prompt_toks)
        hidden, ks, vs = model.make_prefill(S)(
            lm.head.embed_tokens(np.asarray(prompt_toks, np.int32))[None],
            torch.arange(S, device=dev)[None])
        shape = (cfg.num_layers, 1, capacity, cfg.num_kv_heads, cfg.head_dim)
        self.ck = torch.zeros(shape, dtype=hidden.dtype, device=dev)
        self.cv = torch.zeros(shape, dtype=hidden.dtype, device=dev)
        self.ck[:, 0, :S] = torch.stack(ks).to(hidden.dtype)
        self.cv[:, 0, :S] = torch.stack(vs).to(hidden.dtype)
        self.slots = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.cached = S          # positions [0, cached) hold real tokens

    def logits_after(self, seq: List[int], n: int) -> np.ndarray:
        """[n, V] logits: row i is the distribution after the prefix
        seq[:len(seq) - n + 1 + i]. One decode_chunk over seq[start:],
        where start covers both the first uncached position and the first
        row asked for; replayed tokens rewrite their own K / V rows with
        the same values."""
        lm, model = self.lm, self.lm.model
        start = min(self.cached, len(seq) - n)
        x = lm.head.embed_tokens(np.asarray(seq[start:], np.int32))[None]
        lengths = torch.tensor([start], dtype=torch.int32,
                               device=model.device)
        hidden, self.ck, self.cv = model.decode_chunk(
            x, self.ck, self.cv, self.slots, lengths)
        self.cached = len(seq)
        return _host_rows(lm.head.logits(hidden.float()))[0, -n:]

    def rollback(self, n_valid: int) -> None:
        """Keep only the first n_valid tokens' K / V as authoritative."""
        self.cached = min(self.cached, n_valid)


def speculative_generate_cached(target_lm, draft_lm, prompt_tokens,
                                max_new_tokens: int = 32, *, gamma: int = 4,
                                temperature: float = 0.0,
                                eos_token_id: Optional[int] = None,
                                seed: int = 0,
                                return_stats: bool = False):
    """KV-cached speculative generation over two `QuantLlamaLM`s, with
    `speculative_generate`'s acceptance (greedy output the target's own
    greedy stream): each verify is one `decode_chunk` over the g
    proposals and the replayed last token, each draft token one
    `decode_chunk` of one token. The accepted proposals' K / V stay
    cached; the replacement or bonus token's lands with the next round's
    replay."""
    _check(gamma, prompt_tokens)
    toks = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
    capacity = len(toks) + max_new_tokens + gamma + 1
    tgt_c = _CachedLM(target_lm, toks, capacity)
    drf_c = _CachedLM(draft_lm, toks, capacity)

    def rollback(n_tokens):
        tgt_c.rollback(n_tokens - 1)
        drf_c.rollback(n_tokens - 1)

    out, stats = _speculate(
        tgt_c.logits_after, lambda seq: drf_c.logits_after(seq, 1)[0],
        toks, max_new_tokens, gamma, temperature, eos_token_id, seed,
        after_round=rollback)
    return (out, stats) if return_stats else out

"""The unquantized ends of a quantized Llama and the tokens->logits
wrapper (counterpart of bitblas_tpu/models/hf_import.py: LMHead,
QuantLlamaLM, sample_token). Loading HF GPTQ checkpoints is not ported
yet."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..common import resolve_device
from .quant_llama import QuantLlama, rmsnorm


def _tensor(x, dtype, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype).contiguous()


class LMHead(nn.Module):
    """Token embedding [V, H] (activation dtype), final RMSNorm [H] f32 and
    the lm_head projection [V, H] f32. The lm_head product is a plain dense
    float32 matmul (torch.matmul), as the JAX package leaves it to XLA."""

    def __init__(self, embed, final_norm, lm_head, norm_eps: float = 1e-5,
                 device="cuda", act_dtype=torch.float16):
        super().__init__()
        dev = resolve_device(device)
        self.norm_eps = norm_eps
        self.register_buffer("embed", _tensor(embed, act_dtype, dev))
        self.register_buffer("final_norm",
                             _tensor(final_norm, torch.float32, dev))
        self.register_buffer("lm_head", _tensor(lm_head, torch.float32, dev))

    def embed_tokens(self, token_ids) -> torch.Tensor:
        ids = torch.as_tensor(token_ids, device=self.embed.device)
        return self.embed[ids.long()]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(hidden.float(), self.final_norm, self.norm_eps)
        return h @ self.lm_head.T


class QuantLlamaLM:
    """tokens -> logits: LMHead.embed -> QuantLlama trunk -> LMHead.logits."""

    def __init__(self, model: QuantLlama, head: LMHead):
        self.model = model
        self.head = head

    def __call__(self, token_ids, positions=None) -> torch.Tensor:
        ids = torch.as_tensor(token_ids, device=self.model.device)
        if ids.dim() == 1:
            ids = ids[None]
        B, S = ids.shape
        if positions is None:
            positions = torch.arange(S, device=ids.device)[None].expand(B, S)
        x = self.head.embed_tokens(ids)
        x = self.model(x, positions)
        return self.head.logits(x)

    def generate(self, prompt_tokens, max_new_tokens: int = 32, *,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 max_seq_len: Optional[int] = None) -> np.ndarray:
        """Autoregressive generation for one sequence: prefill through
        `make_prefill`, then one `decode_step` per token over a slot cache
        in the hidden dtype (float16), as JAX's generate keeps it; the
        engines keep bfloat16, as JAX's do. temperature=0 is greedy.
        Returns the full token sequence [S + new] int32."""
        toks = np.asarray(prompt_tokens).reshape(-1).astype(np.int32)
        S = toks.shape[0]
        if S < 1:
            raise ValueError("prompt_tokens must hold at least one token")
        cfg = self.model.cfg
        dev = self.model.device
        lmax = max_seq_len or (S + max_new_tokens)
        if lmax < S + max_new_tokens:
            raise ValueError(f"max_seq_len={lmax} < prompt {S} + "
                             f"max_new_tokens {max_new_tokens}")
        rng = np.random.default_rng(seed)
        hidden, ks, vs = self.model.make_prefill(S)(
            self.head.embed_tokens(toks)[None],
            torch.arange(S, device=dev)[None])
        L = cfg.num_layers
        shape = (L, 1, lmax, cfg.num_kv_heads, cfg.head_dim)
        caches_k = torch.zeros(shape, dtype=hidden.dtype, device=dev)
        caches_v = torch.zeros(shape, dtype=hidden.dtype, device=dev)
        caches_k[:, 0, :S] = torch.stack(ks).to(hidden.dtype)
        caches_v[:, 0, :S] = torch.stack(vs).to(hidden.dtype)
        slots = torch.zeros((1,), dtype=torch.int32, device=dev)
        out = list(toks)
        last_hidden = hidden[:, -1:]
        for i in range(max_new_tokens):
            logits = self.head.logits(last_hidden)[0, -1].cpu().numpy()
            nxt = sample_token(logits, temperature=temperature, top_k=top_k,
                               rng=rng)
            out.append(nxt)
            if eos_token_id is not None and nxt == eos_token_id:
                break
            if i == max_new_tokens - 1:
                break
            lengths = torch.tensor([len(out) - 1], dtype=torch.int32,
                                   device=dev)
            x = self.head.embed_tokens([[nxt]])
            last_hidden, caches_k, caches_v = self.model.decode_step(
                x, caches_k, caches_v, slots, lengths)
        return np.asarray(out, np.int32)


def sample_token(logits_row: np.ndarray, *, temperature: float = 0.0,
                 top_k: int = 0, rng=None) -> int:
    """Sample one token id from a [V] logits row: temperature<=0 is greedy,
    otherwise softmax sampling, optionally truncated to the top_k logits."""
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    z = np.asarray(logits_row, dtype=np.float64) / temperature
    if 0 < top_k < z.shape[0]:
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z >= kth, z, -np.inf)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    rng = rng or np.random.default_rng()
    return int(rng.choice(z.shape[0], p=p))

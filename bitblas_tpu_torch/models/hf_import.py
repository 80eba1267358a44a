"""Import a HuggingFace-transformers GPTQ Llama checkpoint into
QuantLlama, with the unquantized ends of the model and the tokens->logits
wrapper (counterpart of bitblas_tpu/models/hf_import.py).

`load_quant_llama_from_hf_gptq` maps the HF state-dict names
(`model.layers.{i}.self_attn.q_proj.qweight` ...) onto QuantLlama's seven
projections, repacks every GPTQ bundle into the Hopper layout with torch
ops on the model's device (graph.repack_gptq_layer) and returns the
trunk and its LMHead. The config comes from `llama_config_from_hf`, a
transformers config object or a plain dict (transformers is never
imported). Act-order (`desc_act=True`) checkpoints are refused: their
`g_idx` permutes K, which grouped scales do not represent. `perplexity`
evaluates any tokens->logits callable.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..common import get_logger, resolve_device
from ..graph import as_tensor, repack_gptq_layer
from .quant_llama import LlamaConfig, QuantLlama, rmsnorm

logger = get_logger()

# HF projection name -> the port's projection name
_HF_PROJS = (
    ("self_attn.q_proj", "q"),
    ("self_attn.k_proj", "k"),
    ("self_attn.v_proj", "v"),
    ("self_attn.o_proj", "o"),
    ("mlp.gate_proj", "gate"),
    ("mlp.up_proj", "up"),
    ("mlp.down_proj", "down"),
)


def rope_scaling_from_hf(get) -> Optional[dict]:
    """A HF config's rope_scaling, checked: None or "default" pass
    through as None, "llama3" is taken, anything else raises (dropping a
    scaling silently would drift long-context logits from the source)."""
    scaling = get("rope_scaling", None)
    if scaling is None:
        return None
    if not isinstance(scaling, Mapping):
        scaling = dict(scaling.__dict__)
    rt = scaling.get("rope_type", scaling.get("type", "default"))
    if rt == "default":
        return None
    if rt != "llama3":
        raise ValueError(
            f"rope_scaling type {rt!r} unsupported (only 'llama3'; "
            f"linear/dynamic NTK checkpoints need that formula added "
            f"to quant_llama.llama3_scaled_freqs' family)")
    return dict(scaling)


def llama_config_from_hf(hf_config, *, group_size: int = 128,
                         act_dtype: str = "float16") -> LlamaConfig:
    """Map a transformers LlamaConfig (an object or a plain dict) onto the
    port's LlamaConfig, as JAX's importer maps it."""
    def get(name, default=None):
        if isinstance(hf_config, Mapping):
            return hf_config.get(name, default)
        return getattr(hf_config, name, default)

    heads = get("num_attention_heads")
    scaling = rope_scaling_from_hf(get)
    sw = (get("sliding_window", None)
          if get("use_sliding_window", True) else None)
    mwl = get("max_window_layers", None)
    if sw is not None and mwl is not None \
            and mwl < get("num_hidden_layers"):
        # Qwen2: layers from max_window_layers attend fully while lower
        # layers window; per-layer windows are not wired, and windowing
        # every layer would drift the logits
        raise NotImplementedError(
            f"max_window_layers={mwl} < num_hidden_layers="
            f"{get('num_hidden_layers')} with an active sliding window: "
            f"per-layer window gating is not implemented")
    return LlamaConfig(
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_heads=heads,
        num_kv_heads=get("num_key_value_heads", heads) or heads,
        num_layers=get("num_hidden_layers"),
        vocab_size=get("vocab_size"),
        group_size=group_size,
        act_dtype=act_dtype,
        rope_theta=float(get("rope_theta", 10000.0)),
        rope_scaling=scaling,
        # Qwen2 configs carry no attention_bias field (the q/k/v biases
        # are implicit in the architecture): default it from model_type
        attention_bias=bool(get("attention_bias",
                                get("model_type", "") == "qwen2")),
        rms_norm_eps=float(get("rms_norm_eps", 1e-5)),
        # Mistral-family sliding windows; use_sliding_window=False (the
        # Qwen2 gate) turns one off, as transformers does
        sliding_window=sw,
    )


def _check_g_idx(state: Mapping, key: str, K: int, group_size: int) -> None:
    """Refuse a non-sequential g_idx (act-order / desc_act)."""
    g_idx = state.get(f"{key}.g_idx")
    if g_idx is None:
        return
    g = K if group_size in (-1, None) else group_size
    got = as_tensor(g_idx).to(torch.int64).reshape(-1)
    expect = torch.arange(K, dtype=torch.int64, device=got.device) // g
    if not torch.equal(got, expect):
        raise ValueError(
            f"{key}: non-sequential g_idx (act-order / desc_act checkpoint)."
            f" The grouped-scale layout needs sequential groups; "
            f"re-quantize with desc_act=False or pre-permute K offline")


def _lm_head_weight(state: Mapping):
    """lm_head.weight, else the tied embedding (Qwen2-small and many
    chat finetunes ship no lm_head.weight)."""
    if "lm_head.weight" in state:
        return state["lm_head.weight"]
    return state["model.embed_tokens.weight"]


def load_quant_llama_from_hf_gptq(
    state: Mapping[str, object],
    hf_config,
    *,
    bits: int = 4,
    group_size: int = 128,
    gptq_v2: bool = False,
    opt_m=(1, 16, 256),
    enable_tuning: bool = False,
    device="cuda",
) -> Tuple[QuantLlama, "LMHead"]:
    """A QuantLlama trunk and its LMHead from a HF GPTQ Llama state dict
    (torch tensors on any device, or numpy arrays): per layer the GPTQ
    bundles (`...q_proj.qweight/qzeros/scales`, an optional sequential
    g_idx, q/k/v biases where the config has attention_bias) and the two
    RMSNorm weights; `model.embed_tokens.weight`, `model.norm.weight` and
    `lm_head.weight` (or the tied embedding). `QuantLlamaLM` composes the
    two into tokens -> logits."""
    if bits != 4:
        raise ValueError(f"GPTQ llama import supports 4-bit (got {bits})")
    dev = resolve_device(device)
    cfg = llama_config_from_hf(hf_config, group_size=group_size)
    model = QuantLlama(cfg, device=dev, enable_tuning=enable_tuning,
                       opt_m=opt_m)
    for i, layer in enumerate(model.layers):
        base = f"model.layers.{i}"
        for hf_name, ours in _HF_PROJS:
            key = f"{base}.{hf_name}"
            mcfg = layer.ops[ours].config
            if f"{key}.bias" in state:
                if not (cfg.attention_bias and ours in ("q", "k", "v")):
                    raise ValueError(
                        f"{key}: unexpected bias (attention_bias covers "
                        f"q/k/v only); refusing to drop it")
                setattr(layer, f"{ours}_bias", as_tensor(
                    state[f"{key}.bias"], dev).to(torch.float32))
            _check_g_idx(state, key, mcfg.K, group_size)
            packed = repack_gptq_layer(
                mcfg, state[f"{key}.qweight"], state[f"{key}.scales"],
                state[f"{key}.qzeros"], gptq_v2=gptq_v2, device=dev)
            for t in ("qweight", "scales", "zeros"):
                setattr(layer, f"{ours}_{t}", packed[t])
        layer.attn_norm = as_tensor(
            state[f"{base}.input_layernorm.weight"], dev).float()
        layer.mlp_norm = as_tensor(
            state[f"{base}.post_attention_layernorm.weight"], dev).float()
        logger.info("imported layer %d/%d", i + 1, cfg.num_layers)
    head = LMHead(embed=as_tensor(state["model.embed_tokens.weight"], dev),
                  final_norm=as_tensor(state["model.norm.weight"], dev),
                  lm_head=as_tensor(_lm_head_weight(state), dev),
                  norm_eps=cfg.rms_norm_eps, device=dev,
                  act_dtype=getattr(torch, cfg.act_dtype))
    return model, head


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


def perplexity(lm, token_ids, *, chunk: int = 0) -> float:
    """Causal-LM perplexity of `lm` (any tokens -> logits callable, e.g.
    QuantLlamaLM) over token_ids [B, S]: exp of the mean next-token
    negative log-likelihood, summed in float32 per chunk of `chunk`
    sequences (0: the whole batch at once)."""
    ids = as_tensor(token_ids)
    if ids.dim() == 1:
        ids = ids[None]
    B = ids.shape[0]
    step = B if chunk <= 0 else chunk
    total, count = 0.0, 0
    for s in range(0, B, step):
        toks = ids[s:s + step]
        logits = lm(toks[:, :-1]).float()
        logp = torch.log_softmax(logits, dim=-1)
        tgt = toks[:, 1:].to(device=logp.device, dtype=torch.int64)
        nll = -torch.gather(logp, -1, tgt[..., None])
        total += float(nll.sum())
        count += tgt.numel()
    return float(np.exp(total / max(count, 1)))


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

"""Quantized Llama-style decoder (counterpart of
bitblas_tpu/models/quant_llama.py).

RMSNorm + RoPE + GQA attention + SwiGLU MLP, every weight matrix a GPTQ
uint4 matmul (scales and zeros in groups of `LlamaConfig.group_size`: 32,
64, 128, a multiple of 256 or -1, per channel) under float16 or bfloat16
activations (`act_dtype`) through the dequant kernels; prefill attention
runs the flash kernel for long prompts and each decode step a
flash-decode kernel over the slot cache or the block pool, bfloat16 or
int8, or a plain attend over the ring cache; `decode_chunk` appends T
tokens a slot in one pass (chunked prefill). A sliding window
(`sliding_window`, Mistral's) reaches every path. The decoder is an
nn.Module whose buffers hold the device-layout weights;
`convert.from_jax_state` carries the JAX package's weights across.

The types follow the JAX package's: the engines feed float16 hidden
states; each projection casts its activation to act_dtype and returns
act_dtype, so with bfloat16 the first residual add (float16 + bfloat16)
promotes the hidden state to float32, as jnp's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import resolve_device
from ..kernels.flash import (check_prefill, flash_attention_fwd,
                             prefill_refusal)
from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from ..ops.weight_transform import scale_dtype
from ..quantization.formats import as_torch_dtype


@dataclass
class LlamaConfig:
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_heads: int = 16
    num_kv_heads: int = 16
    num_layers: int = 2
    vocab_size: int = 32000
    group_size: int = 128
    act_dtype: str = "float16"
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None   # HF llama3 rope scaling, or None
    sliding_window: Optional[int] = None
    attention_bias: bool = False          # Qwen2 q/k/v biases
    rms_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rope_arg(self):
        """What `rope()` takes: plain theta, or the llama3-scaled
        inverse-frequency table when rope_scaling is set."""
        if not self.rope_scaling:
            return self.rope_theta
        return llama3_scaled_freqs(self.rope_theta, self.head_dim,
                                   self.rope_scaling)


def llama3_scaled_freqs(theta: float, head_dim: int,
                        scaling: dict) -> np.ndarray:
    """Llama-3.1 rope scaling (HF `_compute_llama3_parameters`): returns
    the scaled inverse frequencies [head_dim // 2] float32."""
    rt = scaling.get("rope_type", scaling.get("type", "llama3"))
    if rt != "llama3":
        raise ValueError(f"unsupported rope_scaling type {rt!r} "
                         f"(only 'llama3' is implemented)")
    half = head_dim // 2
    inv = theta ** (-np.arange(half, dtype=np.float64) / half)
    factor = float(scaling["factor"])
    lo = float(scaling.get("low_freq_factor", 1.0))
    hi = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * np.pi / inv
    scaled = np.where(wavelen > orig / lo, inv / factor, inv)
    smooth = (orig / wavelen - lo) / (hi - lo)
    smoothed = (1.0 - smooth) / factor * inv + smooth * inv
    is_mid = (wavelen <= orig / lo) & (wavelen >= orig / hi)
    return np.where(is_mid, smoothed, scaled).astype(np.float32)


_PROJS = (("q", "hidden_size", "hidden_size"),
          ("k", "hidden_size", "kv_size"),
          ("v", "hidden_size", "kv_size"),
          ("o", "hidden_size", "hidden_size"),
          ("gate", "hidden_size", "intermediate_size"),
          ("up", "hidden_size", "intermediate_size"),
          ("down", "intermediate_size", "hidden_size"))


def _dim(cfg: LlamaConfig, name: str) -> int:
    if name == "kv_size":
        return cfg.num_kv_heads * cfg.head_dim
    return getattr(cfg, name)


class QuantLlamaLayer(nn.Module):
    """One decoder layer; all 7 projections are uint4 dequant matmuls.

    Buffers ``<proj>_qweight`` [N, K/8] int32, ``<proj>_scales`` and
    ``<proj>_zeros`` [K/g, N] in the activation type, float16 or bfloat16
    (quantization/packing.py layout; load_state_dict casts float16 ones),
    optional ``<proj>_bias`` [N] float32, and the two RMSNorm weights.
    Random init draws from a seeded torch.Generator on the layer's device:
    uniform uint4 codes (every 32-bit pattern is eight of them), zero
    point 8 and small scales, which keep the random residual stream
    contractive as the JAX fixture's do. `PROJS` lists the projections
    built, (name, K dim, N dim): a subclass with its own MLP block
    (models/quant_moe.QuantMixtralLayer) keeps q/k/v/o only."""

    PROJS = _PROJS

    def __init__(self, cfg: LlamaConfig, seed: int = 0, device="cuda",
                 enable_tuning: bool = False,
                 opt_m: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.ops: Dict[str, Matmul] = {}
        for name, kin, kout in self.PROJS:
            K, N = _dim(cfg, kin), _dim(cfg, kout)
            mcfg = MatmulConfig(M=None if opt_m is None else list(opt_m),
                                N=N, K=K, A_dtype=cfg.act_dtype,
                                W_dtype="uint4", with_scaling=True,
                                with_zeros=True, zeros_mode="original",
                                group_size=cfg.group_size,
                                out_dtype=cfg.act_dtype)
            g = mcfg.effective_group_size
            self.ops[name] = Matmul(mcfg, device=dev,
                                    enable_tuning=enable_tuning)
            words = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8),
                                  generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32)
            sdt = scale_dtype(mcfg)
            scales = (torch.randn((K // g, N), generator=gen, device=dev)
                      * 0.0002 + 0.001).to(sdt)
            zeros = torch.full((K // g, N), 8.0, dtype=sdt, device=dev)
            self.register_buffer(f"{name}_qweight", words)
            self.register_buffer(f"{name}_scales", scales)
            self.register_buffer(f"{name}_zeros", zeros)
            if cfg.attention_bias and name in ("q", "k", "v"):
                self.register_buffer(f"{name}_bias", torch.zeros(
                    N, dtype=torch.float32, device=dev))
        self.register_buffer("attn_norm", torch.ones(
            cfg.hidden_size, dtype=torch.float32, device=dev))
        self.register_buffer("mlp_norm", torch.ones(
            cfg.hidden_size, dtype=torch.float32, device=dev))

    def proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out = self.ops[name].forward(
            x, getattr(self, f"{name}_qweight"),
            scale=getattr(self, f"{name}_scales"),
            zeros=getattr(self, f"{name}_zeros"))
        b = getattr(self, f"{name}_bias", None)
        if b is not None:
            out = (out.float() + b).to(out.dtype)
        return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x [B, S, H, D]; rotate pairs (d, d + D/2). `theta` is a float base
    or a precomputed inverse-frequency table [D//2] (cfg.rope_arg)."""
    D = x.shape[-1]
    half = D // 2
    if np.ndim(theta) == 0:
        freqs = torch.tensor(float(theta), dtype=torch.float32,
                             device=x.device) ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    else:
        freqs = torch.as_tensor(np.asarray(theta, np.float32),
                                device=x.device)
    ang = positions.float()[:, :, None] * freqs              # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _layer_mlp(layer: QuantLlamaLayer, h: torch.Tensor) -> torch.Tensor:
    """The decoder's MLP block, h [..., hidden] -> [..., hidden]. A layer
    with an `mlp_forward` (the routed MoE FFN of
    models/quant_moe.QuantMixtralLayer) owns the whole block and takes h
    as [tokens, hidden]; a Llama layer runs the SwiGLU projections."""
    if hasattr(layer, "mlp_forward"):
        lead = h.shape[:-1]
        return layer.mlp_forward(h.reshape(-1, h.shape[-1])).reshape(
            *lead, -1)
    gate = layer.proj("gate", h)
    up = layer.proj("up", h)
    act = (torch.nn.functional.silu(gate.float()) * up.float()).to(h.dtype)
    return layer.proj("down", act)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     flash=None, window: Optional[int] = None,
                     dtype=None) -> torch.Tensor:
    """In-context causal attention, q [B, S, H, D], k/v [B, S, Hkv, D] ->
    [B, S, H, D]: through `flash` (fn(q, k, v[, window]), the prefill
    kernel) where given, else the plain masked softmax in float32, out in
    `dtype` (q's by default). With a `window` query i attends keys
    (i - window, i]."""
    if flash is not None:
        qkv = (q.contiguous(), k.contiguous(), v.contiguous())
        return flash(*qkv) if window is None else flash(*qkv, window)
    S, H, D = q.shape[1:]
    group = H // k.shape[2]
    k_ = k.repeat_interleave(group, dim=2).float()
    v_ = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_) / math.sqrt(D)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    keep = qi >= kj
    if window is not None:
        keep = keep & (kj > qi - window)
    s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_).to(dtype or q.dtype)


def prefill_flash(cfg: LlamaConfig, seq_len: int, num_heads: int,
                  num_kv_heads: int):
    """(flash, refused) of a prefill at `seq_len` over `num_heads` /
    `num_kv_heads` heads: prompts of 256+ tokens in 128-multiples attend
    through the flash kernel at any head dim (the JAX rule,
    bitblas_tpu/models/quant_llama.py:309-326), on the instance
    `kernels.flash.prefill_instance` names and the tile of tuner/curated's
    flash_block_hint, out in act_dtype; `flash` is None for the others,
    and `refused` says the rule took the prompt but kernel 4 refuses its
    shape (`kernels.flash.prefill_refusal`: a head dim past the general
    instance's cap, which JAX's kernel would still take)."""
    if not (seq_len >= 256 and seq_len % 128 == 0):
        return None, False
    out_dtype = as_torch_dtype(cfg.act_dtype)
    if prefill_refusal(seq_len, num_heads, num_kv_heads, cfg.head_dim,
                       out_dtype, window=cfg.sliding_window) is not None:
        return None, True
    tile = check_prefill(1, seq_len, num_heads, num_kv_heads, cfg.head_dim,
                         out_dtype, out_dtype, window=cfg.sliding_window)

    def flash(q, k, v, *window):
        return flash_attention_fwd(q, k, v, *window, out_dtype=out_dtype,
                                   tile=tile)

    return flash, False


def layer_forward(layer: QuantLlamaLayer, x: torch.Tensor,
                  positions: torch.Tensor, *, flash=None,
                  return_kv: bool = False, window: Optional[int] = None):
    """x [B, S, hidden] -> [B, S, hidden] (optionally also the rope-applied
    K/V [B, S, Hkv, D] for the KV cache). Attention is causal, with an
    optional sliding `window` (query i attends keys (i - window, i]).
    `flash` is an attention function fn(q, k, v[, window]) (the prefill
    kernel); without it the plain masked softmax runs."""
    cfg = layer.cfg
    B, S, _ = x.shape
    h = rmsnorm(x, layer.attn_norm, cfg.rms_norm_eps)
    q = layer.proj("q", h).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = layer.proj("k", h).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = layer.proj("v", h).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_arg)
    k = rope(k, positions, cfg.rope_arg)
    attn = causal_attention(q, k, v, flash=flash, window=window,
                            dtype=x.dtype)
    attn = attn.reshape(B, S, cfg.hidden_size)
    x = x + layer.proj("o", attn)
    h = rmsnorm(x, layer.mlp_norm, cfg.rms_norm_eps)
    x = x + _layer_mlp(layer, h)
    if return_kv:
        return x, k, v
    return x


class DecoderServingMixin:
    """Serving hooks for a llama-topology decoder stack (`cfg`, `layers`):
    forward, bucketed prefill and single-token decode against the slot
    cache or the paged cache, float or int8."""

    # prefill calls whose prompt the flash rule takes but whose shape kernel
    # 4 refuses (a head dim past GENERAL_MAX_HEAD_DIM), so they ran the
    # plain masked softmax where JAX's model runs its kernel (make_prefill)
    plain_prefills = 0

    def forward(self, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer_forward(layer, x, positions,
                              window=self.cfg.sliding_window)
        return x

    def make_prefill(self, seq_len: int):
        """Returns fn(x [1, S, hidden], positions) -> (hidden, ks, vs),
        ks/vs per-layer rope-applied K/V [S, Hkv, D]. Prompts of 256+
        tokens in 128-multiples attend through the flash kernel (the JAX
        rule) at any head dim, a sliding window included (its banded
        walk), on the tile of tuner/curated's flash_block_hint, out in the
        model's act_dtype; shorter prompts keep the plain masked softmax,
        as JAX's do; a prompt the rule sends to the kernel but whose shape
        the kernel refuses (`kernels.flash.prefill_refusal`: a head dim
        past the general instance's cap) counts in
        `DecoderServingMixin.plain_prefills` at each call."""
        cfg = self.cfg
        flash, refused = prefill_flash(cfg, seq_len, cfg.num_heads,
                                       cfg.num_kv_heads)

        def prefill(x, positions):
            if refused:
                DecoderServingMixin.plain_prefills += 1
            ks, vs = [], []
            for layer in self.layers:
                x, k, v = layer_forward(layer, x, positions, flash=flash,
                                        return_kv=True,
                                        window=cfg.sliding_window)
                ks.append(k[0])
                vs.append(v[0])
            return x, ks, vs

        return prefill

    def _decode_layers(self, x: torch.Tensor, lengths: torch.Tensor,
                       attend, chunk: bool = False) -> torch.Tensor:
        """The layer stack shared by every decode step and chunk: x
        [B, T, hidden] (T = 1 for a decode step); lengths [B] tokens
        already cached, so token i sits at position lengths + i. Each
        projection runs at M = B * T. `attend(li, q, k, v)` writes layer
        li's new K/V into its cache and returns the attention: q [B, H, D],
        k/v [B, Hkv, D] -> [B, H, D] for a step, [B, T, H, D], [B, T, Hkv,
        D] -> [B, T, H, D] with `chunk`."""
        cfg = self.cfg
        B, T, _ = x.shape
        positions = lengths[:, None] + torch.arange(
            T, device=lengths.device, dtype=lengths.dtype)
        for li, layer in enumerate(self.layers):
            h = rmsnorm(x, layer.attn_norm, cfg.rms_norm_eps)
            h2 = h.reshape(B * T, cfg.hidden_size)
            q = layer.proj("q", h2).reshape(B, T, cfg.num_heads, cfg.head_dim)
            k = layer.proj("k", h2).reshape(B, T, cfg.num_kv_heads,
                                            cfg.head_dim)
            v = layer.proj("v", h2).reshape(B, T, cfg.num_kv_heads,
                                            cfg.head_dim)
            q = rope(q, positions, cfg.rope_arg)
            k = rope(k, positions, cfg.rope_arg)
            if chunk:
                attn = attend(li, q.contiguous(), k, v)
            else:
                attn = attend(li, q[:, 0].contiguous(), k[:, 0], v[:, 0])
            attn = attn.reshape(B * T, cfg.hidden_size)
            x = x + layer.proj("o", attn).reshape(B, T, cfg.hidden_size)
            h = rmsnorm(x, layer.mlp_norm, cfg.rms_norm_eps)
            x = x + _layer_mlp(layer, h.reshape(B * T, cfg.hidden_size)) \
                .reshape(B, T, cfg.hidden_size)
        return x

    def _slot_decode(self, x: torch.Tensor, caches, slots: torch.Tensor,
                     lengths: torch.Tensor, *, chunk: bool, ring: bool):
        """The slot-cache steps: `caches` (K, V) or, int8, (K, V, K scales,
        V scales), each stacked over the layers and updated IN PLACE.
        Picks the token or chunk append and attend, on the slot cache or
        (ring=True, needs cfg.sliding_window) the ring. Returns (hidden,
        *caches)."""
        from ..serving import kv_cache as kvc

        if ring and self.cfg.sliding_window is None:
            raise ValueError("ring cache requires cfg.sliding_window")
        ops = {  # (chunk, ring) -> append, attention; int8 twins below
            (False, False): (kvc.append_token, kvc.decode_attention),
            (False, True): (kvc.append_token_ring,
                            kvc.ring_decode_attention),
            (True, False): (kvc.append_chunk, kvc.chunk_attention),
            (True, True): (kvc.append_chunk_ring, kvc.ring_chunk_attention),
        } if len(caches) == 2 else {
            (False, False): (kvc.append_token_quant,
                             kvc.decode_attention_quant),
            (False, True): (kvc.append_token_ring_quant,
                            kvc.ring_decode_attention_quant),
            (True, False): (kvc.append_chunk_quant,
                            kvc.chunk_attention_quant),
            (True, True): (kvc.append_chunk_ring_quant,
                           kvc.ring_chunk_attention_quant),
        }
        append, attention = ops[chunk, ring]
        # a step's attention sees the token just appended; a chunk's
        # attends from `lengths`, the tokens cached before it
        seen = lengths if chunk else lengths + 1

        def attend(li, q, k, v):
            cache = tuple(c[li] for c in caches)
            append(*cache, slots, lengths, k, v)
            return attention(q, *cache, slots, seen,
                             num_heads=self.cfg.num_heads,
                             window=self.cfg.sliding_window)

        return (self._decode_layers(x, lengths, attend, chunk=chunk),
                *caches)

    def decode_step(self, x: torch.Tensor, caches_k: torch.Tensor,
                    caches_v: torch.Tensor, slots: torch.Tensor,
                    lengths: torch.Tensor, *, ring: bool = False):
        """One-token decode across B slots.

        x [B, 1, hidden]; caches_k/v [L, slots, Lmax, Hkv, D]; lengths [B]
        tokens already in each slot's cache. The new token's K/V land at
        position lengths[b], IN PLACE in caches_k/v. Returns (hidden
        [B, 1, hidden], caches_k, caches_v). ring=True: the caches are
        window-sized rings [L, slots, R, Hkv, D] (kv_cache ring section;
        needs cfg.sliding_window): the token lands in row lengths[b] % R
        and attention masks on the rows' absolute positions."""
        return self._slot_decode(x, (caches_k, caches_v), slots, lengths,
                                 chunk=False, ring=ring)

    def decode_step_quant(self, x: torch.Tensor, caches_k: torch.Tensor,
                          caches_v: torch.Tensor, scales_k: torch.Tensor,
                          scales_v: torch.Tensor, slots: torch.Tensor,
                          lengths: torch.Tensor, *, ring: bool = False):
        """decode_step against the int8 slot cache: caches_k/v
        [L, slots, Lmax, Hkv, D] int8, scales_k/v [L, slots, Lmax, Hkv]
        f32, all updated IN PLACE (ring=True: int8 rings). Returns
        (hidden, caches_k, caches_v, scales_k, scales_v)."""
        return self._slot_decode(x, (caches_k, caches_v, scales_k, scales_v),
                                 slots, lengths, chunk=False, ring=ring)

    def decode_chunk(self, x: torch.Tensor, caches_k: torch.Tensor,
                     caches_v: torch.Tensor, slots: torch.Tensor,
                     lengths: torch.Tensor, *, ring: bool = False):
        """Append T tokens a slot in one pass (chunked prefill): x [B, T,
        hidden]; caches as decode_step's; lengths [B] tokens already
        cached. Token i lands at position lengths[b] + i, IN PLACE, and
        attends its prefix and the chunk's tokens up to itself (within the
        window, if set). Returns (hidden [B, T, hidden], caches_k,
        caches_v). The projections run at M = B * T. ring=True: the
        caches are rings with R >= window + T - 1."""
        return self._slot_decode(x, (caches_k, caches_v), slots, lengths,
                                 chunk=True, ring=ring)

    def decode_chunk_quant(self, x: torch.Tensor, caches_k: torch.Tensor,
                           caches_v: torch.Tensor, scales_k: torch.Tensor,
                           scales_v: torch.Tensor, slots: torch.Tensor,
                           lengths: torch.Tensor, *, ring: bool = False):
        """decode_chunk against the int8 slot cache (or int8 rings).
        Returns (hidden [B, T, hidden], caches_k, caches_v, scales_k,
        scales_v)."""
        return self._slot_decode(x, (caches_k, caches_v, scales_k, scales_v),
                                 slots, lengths, chunk=True, ring=ring)

    def decode_step_paged(self, x: torch.Tensor, caches_k: torch.Tensor,
                          caches_v: torch.Tensor, tables: torch.Tensor,
                          block_rows: torch.Tensor, offsets: torch.Tensor,
                          lengths: torch.Tensor):
        """One-token decode against the paged cache: x [B, 1, hidden];
        caches_k/v [L, blocks, bs, Hkv, D] (updated IN PLACE); tables
        [B, MB] physical blocks per request; block_rows/offsets [B] = where
        the new token's K/V lands; lengths [B] = tokens already cached.
        Returns (hidden, caches_k, caches_v)."""
        from ..serving.kv_cache import (append_token_paged,
                                        decode_attention_paged)

        def attend(li, q, k, v):
            append_token_paged(caches_k[li], caches_v[li], block_rows,
                               offsets, k, v)
            return decode_attention_paged(
                q, caches_k[li], caches_v[li], tables, lengths + 1,
                num_heads=self.cfg.num_heads, window=self.cfg.sliding_window)

        return self._decode_layers(x, lengths, attend), caches_k, caches_v

    def decode_step_paged_quant(self, x: torch.Tensor,
                                caches_k: torch.Tensor,
                                caches_v: torch.Tensor,
                                scales_k: torch.Tensor,
                                scales_v: torch.Tensor, tables: torch.Tensor,
                                block_rows: torch.Tensor,
                                offsets: torch.Tensor, lengths: torch.Tensor):
        """decode_step_paged against the int8 block pool: caches_k/v
        [L, blocks, bs, Hkv, D] int8, scales_k/v [L, blocks, bs, Hkv] f32.
        Returns (hidden, caches_k, caches_v, scales_k, scales_v)."""
        from ..serving.kv_cache import (append_token_paged_quant,
                                        decode_attention_paged_quant)

        def attend(li, q, k, v):
            cache = (caches_k[li], caches_v[li], scales_k[li], scales_v[li])
            append_token_paged_quant(*cache, block_rows, offsets, k, v)
            return decode_attention_paged_quant(
                q, *cache, tables, lengths + 1, num_heads=self.cfg.num_heads,
                window=self.cfg.sliding_window)

        return (self._decode_layers(x, lengths, attend), caches_k, caches_v,
                scales_k, scales_v)


class QuantLlama(DecoderServingMixin, nn.Module):
    """A stack of quantized decoder layers (no embeddings: the engines
    stream hidden states; models/hf_import.LMHead adds the ends)."""

    def __init__(self, cfg: LlamaConfig, device="cuda", seed: int = 0,
                 enable_tuning: bool = False,
                 opt_m: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.layers = nn.ModuleList(
            [QuantLlamaLayer(cfg, seed=seed + i, device=self.device,
                             enable_tuning=enable_tuning, opt_m=opt_m)
             for i in range(cfg.num_layers)])

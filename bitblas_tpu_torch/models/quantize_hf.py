"""Quantize a float Hugging Face Llama or Mixtral checkpoint into the
port's uint4 models, by RTN or by GPTQ (counterpart of
bitblas_tpu/models/quantize_hf.py).

`models.hf_import` and `models.hf_import_mixtral` take checkpoints that a
GPTQ tool already quantized; these functions make the quantized model from
the original float16 / bfloat16 weights:

    state = hf_model.state_dict()            # torch tensors or numpy
    model, head = quantize_llama_from_hf_fp16(
        state, hf_model.config, method="gptq", calib_tokens=tokens)
    lm = QuantLlamaLM(model, head)

GPTQ calibration is sequential (Frantar et al.): layer i's Hessians come
from the activations of the already quantized layers 0 .. i-1. The
calibration forward is the served forward's twin (the port's rmsnorm and
rope, GQA, the sliding window, q / k / v biases) in float32 on the
dequantized codes, on the model's device; the codes then go through each
layer's `Matmul.transform_weight` into its buffers. Projections that read
the same input (q / k / v; gate / up) share its Hessian and are swept in
one pass over their stacked rows. The embedding, the final norm and the
lm_head stay float in the LMHead, as GPTQ checkpoints leave them.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from ..common import get_logger, resolve_device
from ..graph import as_tensor
from ..quantization.gptq import (HessianAccumulator, QuantizedWeight,
                                 gptq_quantize, rtn_quantize)
from .hf_import import _HF_PROJS, LMHead, _lm_head_weight, llama_config_from_hf
from .quant_llama import QuantLlama, rmsnorm, rope

logger = get_logger()


def _attention(cfg, q, k, v):
    """Causal GQA attention in float32, the sliding window included (the
    Hessians must come from the activations the served, windowed model
    produces): q [B, S, H, D], k / v [B, S, Hkv, D] -> [B, S, H D]."""
    B, S = q.shape[:2]
    group = cfg.num_heads // cfg.num_kv_heads
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.full(
        (), math.sqrt(cfg.head_dim), dtype=torch.float32, device=q.device)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    keep = qi >= kj
    if getattr(cfg, "sliding_window", None) is not None:
        keep = keep & (kj > qi - cfg.sliding_window)
    p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, -1)


def _make_quant(method, bits, group_size, symmetric, percdamp):
    """quant({name: weight [N, K] float32}, hessian or None) -> {name:
    QuantizedWeight}: the weights share one input, so GPTQ sweeps their
    stacked rows against the Hessian at once (rows are independent: the
    codes of separate sweeps); RTN without a Hessian (also the fallback
    of an expert with no calibration traffic)."""
    def quant(weights: Dict[str, torch.Tensor], hess
              ) -> Dict[str, QuantizedWeight]:
        if method != "gptq" or hess is None:
            return {name: rtn_quantize(w, bits=bits, group_size=group_size,
                                       symmetric=symmetric)
                    for name, w in weights.items()}
        qw = gptq_quantize(torch.cat(list(weights.values())), hess,
                           bits=bits, group_size=group_size,
                           symmetric=symmetric, percdamp=percdamp)
        out, r0 = {}, 0
        for name, w in weights.items():
            rows = slice(r0, r0 + w.shape[0])
            out[name] = QuantizedWeight(qw.codes[rows], qw.scales[rows],
                                        qw.zeros[rows], bits, qw.group_size)
            r0 += w.shape[0]
        return out
    return quant


def _check_method(method: str, bits: int, calib_tokens) -> None:
    if method not in ("rtn", "gptq"):
        raise ValueError(f"method must be 'rtn' or 'gptq', got {method!r}")
    if bits != 4:
        raise ValueError("the port's decoders pack uint4 projections; for "
                         "other widths quantize per tensor through "
                         "quantization.gptq and feed a matching "
                         "MatmulConfig / Linear")
    if method == "gptq" and calib_tokens is None:
        raise ValueError("method='gptq' requires calib_tokens [B, S]")


def _head(state, cfg, dev) -> LMHead:
    return LMHead(embed=as_tensor(state["model.embed_tokens.weight"], dev),
                  final_norm=as_tensor(state["model.norm.weight"], dev),
                  lm_head=as_tensor(_lm_head_weight(state), dev),
                  norm_eps=cfg.rms_norm_eps, device=dev,
                  act_dtype=getattr(torch, cfg.act_dtype))


def _calibration_input(head: LMHead, calib_tokens):
    """Token ids [B, S] (or [S]) -> (embedded x [B, S, hidden] float32,
    positions [B, S])."""
    toks = as_tensor(calib_tokens, head.embed.device).long()
    if toks.dim() == 1:
        toks = toks[None]
    B, S = toks.shape
    positions = torch.arange(S, device=toks.device)[None].expand(B, S)
    return head.embed_tokens(toks).float(), positions


def _float(state, key, dev) -> torch.Tensor:
    return as_tensor(state[key], dev).float()


def _pack(layer, ops, qws: Dict[str, QuantizedWeight], experts=None):
    """Each QuantizedWeight through its Matmul's transform_weight (codes
    int8, float16 scales and zeros) into the layer's buffers; `experts`
    (an expert index) fills that expert's slice of a QuantMoELayer's
    stacked buffers."""
    for name, qw in qws.items():
        packed = ops[name].transform_weight(
            qw.codes.to(torch.int8), scale=qw.scales.to(torch.float16),
            zeros=qw.zeros.to(torch.float16))
        if experts is None:
            for t, v in zip(("qweight", "scales", "zeros"), packed):
                setattr(layer, f"{name}_{t}", v)
        else:
            for dst, v in zip(layer.expert(name, experts), packed):
                dst.copy_(v)


def _calibrate_attention(cfg, x, positions, attn_fp, attn_norm, quant,
                         biases=None):
    """The sequential-GPTQ attention block of both quantizers: q / k / v
    against the Hessian of the normalized input, attention on their
    dequantized weights (with the q / k / v biases, as the served forward
    adds them), o against the Hessian of the attention output. Returns
    ({name: QuantizedWeight}, x after the residual add)."""
    B, S = positions.shape
    biases = biases or {}
    h = rmsnorm(x, attn_norm, cfg.rms_norm_eps)
    acc = HessianAccumulator(cfg.hidden_size, x.device)
    acc.update(h)
    qatt = quant({n: attn_fp[n] for n in ("q", "k", "v")}, acc.hessian)

    def proj(name, heads):
        y = h @ qatt[name].dequantize().T
        if biases.get(name) is not None:
            y = y + biases[name]
        return y.reshape(B, S, heads, cfg.head_dim)

    q = rope(proj("q", cfg.num_heads), positions, cfg.rope_arg)
    k = rope(proj("k", cfg.num_kv_heads), positions, cfg.rope_arg)
    attn = _attention(cfg, q, k, proj("v", cfg.num_kv_heads))
    acc_o = HessianAccumulator(cfg.hidden_size, x.device)
    acc_o.update(attn)
    qatt.update(quant({"o": attn_fp["o"]}, acc_o.hessian))
    return qatt, x + attn @ qatt["o"].dequantize().T


def quantize_llama_from_hf_fp16(
    state: Mapping[str, object],
    hf_config,
    *,
    bits: int = 4,
    group_size: int = 128,
    method: str = "rtn",
    calib_tokens=None,
    symmetric: bool = False,
    percdamp: float = 0.01,
    opt_m=(1, 16, 256),
    enable_tuning: bool = False,
    device="cuda",
) -> Tuple[QuantLlama, LMHead]:
    """A float16 / bfloat16 HF Llama state dict (torch tensors on any
    device, or numpy arrays) -> (QuantLlama, LMHead) on `device`.
    `hf_config` is a transformers config object or a plain dict.
    method="rtn" needs no data; method="gptq" needs `calib_tokens` [B, S]
    token ids."""
    _check_method(method, bits, calib_tokens)
    dev = resolve_device(device)
    cfg = llama_config_from_hf(hf_config, group_size=group_size)
    model = QuantLlama(cfg, device=dev, enable_tuning=enable_tuning,
                       opt_m=opt_m)
    head = _head(state, cfg, dev)
    if method == "gptq":
        x, positions = _calibration_input(head, calib_tokens)
    quant = _make_quant(method, bits, group_size, symmetric, percdamp)

    for i, layer in enumerate(model.layers):
        base = f"model.layers.{i}"
        fpw = {}
        for hf_name, ours in _HF_PROJS:
            key = f"{base}.{hf_name}"
            if f"{key}.bias" in state:
                if not (cfg.attention_bias and ours in ("q", "k", "v")):
                    raise ValueError(f"{key}: unexpected bias "
                                     f"(attention_bias covers q/k/v only)")
                setattr(layer, f"{ours}_bias",
                        _float(state, f"{key}.bias", dev))
            fpw[ours] = _float(state, f"{key}.weight", dev)
        attn_norm = _float(state, f"{base}.input_layernorm.weight", dev)
        mlp_norm = _float(state, f"{base}.post_attention_layernorm.weight",
                          dev)

        if method == "rtn":
            qws = quant(fpw, None)
        else:
            biases = {n: getattr(layer, f"{n}_bias", None)
                      for n in ("q", "k", "v")}
            qws, x = _calibrate_attention(cfg, x, positions, fpw, attn_norm,
                                          quant, biases)
            h2 = rmsnorm(x, mlp_norm, cfg.rms_norm_eps)
            acc = HessianAccumulator(cfg.hidden_size, dev)
            acc.update(h2)
            qws.update(quant({n: fpw[n] for n in ("gate", "up")},
                             acc.hessian))
            act = (torch.nn.functional.silu(h2 @ qws["gate"].dequantize().T)
                   * (h2 @ qws["up"].dequantize().T))
            acc = HessianAccumulator(cfg.intermediate_size, dev)
            acc.update(act)
            qws.update(quant({"down": fpw["down"]}, acc.hessian))
            x = x + act @ qws["down"].dequantize().T
        _pack(layer, layer.ops, qws)
        layer.attn_norm = attn_norm
        layer.mlp_norm = mlp_norm
        logger.info("quantized layer %d/%d (%s)", i + 1, cfg.num_layers,
                    method)
    return model, head


def quantize_mixtral_from_hf_fp16(
    state: Mapping[str, object],
    hf_config,
    *,
    bits: int = 4,
    group_size: int = 128,
    method: str = "rtn",
    calib_tokens=None,
    symmetric: bool = False,
    percdamp: float = 0.01,
    opt_m=(1, 16, 256),
    moe_tokens: int = 256,
    capacity_factor: float = 2.0,
    calib_chunk: int = 512,
    enable_tuning: bool = False,
    device="cuda",
):
    """A float HF Mixtral state dict -> (QuantMixtral, LMHead) on `device`.

    The attention quantizes as the Llama one's. With method="gptq"
    each expert's projections take their own Hessians, from the rows the
    (float) router dispatches to it: the calibration stream is routed in
    `calib_chunk`-token pieces, each at its own capacity, as a serving
    batch is, and each expert's Hessian counts every row of its capacity
    buffer, filled or not (JAX's count). Three passes a layer: gate / up
    from the dispatched rows; down from the quantized gate / up
    activations; the layer's output through the quantized experts. An
    expert with no calibration traffic (a zero Hessian would zero its
    weights through GPTQ's dead columns) falls back to RTN with a warning.
    The router stays float32 [H, E]."""
    from .hf_import_mixtral import _ATTN, _EXPERTS, mixtral_config_from_hf
    from .quant_moe import (QuantMixtral, combine_rows, dispatch_rows,
                            moe_capacity, route)

    _check_method(method, bits, calib_tokens)
    dev = resolve_device(device)
    cfg = mixtral_config_from_hf(hf_config, group_size=group_size,
                                 capacity_factor=capacity_factor)
    model = QuantMixtral(cfg, device=dev, enable_tuning=enable_tuning,
                         opt_m=opt_m, moe_tokens=moe_tokens)
    head = _head(state, cfg, dev)
    if method == "gptq":
        x, positions = _calibration_input(head, calib_tokens)
    quant = _make_quant(method, bits, group_size, symmetric, percdamp)
    E = cfg.n_experts
    mcfg = cfg.moe_config()

    for i, layer in enumerate(model.layers):
        base = f"model.layers.{i}"
        for hf, _ in _ATTN:
            if f"{base}.{hf}.bias" in state:
                raise ValueError(f"{base}.{hf}: bias present (mixtral "
                                 f"projections are bias-free)")
        attn_fp = {ours: _float(state, f"{base}.{hf}.weight", dev)
                   for hf, ours in _ATTN}
        router = _float(state, f"{base}.block_sparse_moe.gate.weight",
                        dev).T.contiguous()                        # [H, E]
        exp_fp = [{} for _ in range(E)]
        for hf, ours in _EXPERTS:
            for e in range(E):
                key = f"{base}.block_sparse_moe.experts.{e}.{hf}"
                if f"{key}.bias" in state:
                    raise ValueError(f"{key}: bias present (mixtral "
                                     f"experts are bias-free)")
                exp_fp[e][ours] = _float(state, f"{key}.weight", dev)
        attn_norm = _float(state, f"{base}.input_layernorm.weight", dev)
        mlp_norm = _float(state, f"{base}.post_attention_layernorm.weight",
                          dev)

        if method == "rtn":
            qatt = quant(attn_fp, None)
            qexp = [quant(w, None) for w in exp_fp]
        else:
            qatt, x = _calibrate_attention(cfg, x, positions, attn_fp,
                                           attn_norm, quant)
            h2 = rmsnorm(x, mlp_norm, cfg.rms_norm_eps).reshape(
                -1, cfg.hidden_size)
            # each piece's route and its experts' rows [E, C, H]
            pieces, step = [], max(int(calib_chunk), 8)
            for s in range(0, h2.shape[0], step):
                hc = h2[s:s + step]
                cap = moe_capacity(mcfg, hc.shape[0])
                r = route(hc @ router, cfg.top_k, cap,
                          valid=(hc != 0).any(dim=-1))
                pieces.append((r, dispatch_rows(hc, r, E, cap)))

            def expert_quant(e, names, accs):
                hess = accs[e].hessian
                if not torch.diagonal(hess).any():
                    logger.warning(
                        "layer %d expert %d received no calibration "
                        "traffic: RTN fallback (raise the calibration "
                        "set's size or diversity)", i, e)
                    hess = None
                return quant({n: exp_fp[e][n] for n in names}, hess)

            def expert_act(e, xin):
                g = xin @ qexp[e]["gate"].dequantize().T
                return (g / (1.0 + torch.exp(-g))
                        * (xin @ qexp[e]["up"].dequantize().T))

            # pass 1: gate / up Hessians from each expert's dispatched rows
            accs = [HessianAccumulator(cfg.hidden_size, dev)
                    for _ in range(E)]
            for _, xin in pieces:
                for e in range(E):
                    accs[e].update(xin[e])
            qexp = [expert_quant(e, ("gate", "up"), accs) for e in range(E)]
            # pass 2: down Hessians from the quantized gate / up activations
            accs = [HessianAccumulator(cfg.intermediate_size, dev)
                    for _ in range(E)]
            for _, xin in pieces:
                for e in range(E):
                    accs[e].update(expert_act(e, xin[e]))
            for e in range(E):
                qexp[e].update(expert_quant(e, ("down",), accs))
            # pass 3: the layer's output through the quantized experts
            y = torch.cat([combine_rows(torch.stack([
                expert_act(e, xin[e]) @ qexp[e]["down"].dequantize().T
                for e in range(E)]), r) for r, xin in pieces])
            x = x + y.reshape(x.shape)

        _pack(layer, layer.ops, qatt)
        layer.moe.router = router
        for e in range(E):
            _pack(layer.moe, layer.moe.ops, qexp[e], experts=e)
        layer.attn_norm = attn_norm
        layer.mlp_norm = mlp_norm
        logger.info("quantized mixtral layer %d/%d (%s)", i + 1,
                    cfg.num_layers, method)
    return model, head

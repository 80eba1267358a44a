"""Import a HuggingFace GPTQ Mixtral checkpoint into QuantMixtral
(counterpart of bitblas_tpu/models/hf_import_mixtral.py).

Per layer: the Llama attention bundles
(`self_attn.{q,k,v,o}_proj.{qweight,qzeros,scales}`), the float router
`block_sparse_moe.gate.weight` [E, H] (transposed to the port's [H, E]),
and each expert's bundles `block_sparse_moe.experts.{e}.w{1,2,3}.*` (HF
names: w1 = gate, w3 = up, w2 = down), every bundle repacked into the
Hopper layout with torch ops on the model's device
(graph.repack_gptq_layer). The config comes from
`mixtral_config_from_hf`, a transformers config object or a plain dict
(transformers is never imported).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from ..common import get_logger, resolve_device
from ..graph import as_tensor, repack_gptq_layer
from .hf_import import LMHead, _check_g_idx, rope_scaling_from_hf
from .quant_moe import MixtralConfig, QuantMixtral

logger = get_logger()

_ATTN = (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
         ("self_attn.v_proj", "v"), ("self_attn.o_proj", "o"))
# HF expert projection name -> the port's
_EXPERTS = (("w1", "gate"), ("w3", "up"), ("w2", "down"))


def mixtral_config_from_hf(hf_config, *, group_size: int = 128,
                           act_dtype: str = "float16",
                           capacity_factor: float = 2.0) -> MixtralConfig:
    """Map a transformers MixtralConfig (an object or a plain dict) onto
    the port's MixtralConfig, as JAX's importer maps it. The window is
    taken where `use_sliding_window` (default true) holds;
    Mixtral-8x7B-v0.1's `sliding_window: null` runs windowless."""
    def get(name, default=None):
        if isinstance(hf_config, Mapping):
            return hf_config.get(name, default)
        return getattr(hf_config, name, default)

    heads = get("num_attention_heads")
    return MixtralConfig(
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_heads=heads,
        num_kv_heads=get("num_key_value_heads", heads) or heads,
        num_layers=get("num_hidden_layers"),
        vocab_size=get("vocab_size"),
        group_size=group_size,
        act_dtype=act_dtype,
        rope_theta=float(get("rope_theta", 1e6)),
        rope_scaling=rope_scaling_from_hf(get),
        rms_norm_eps=float(get("rms_norm_eps", 1e-5)),
        n_experts=get("num_local_experts"),
        top_k=get("num_experts_per_tok"),
        capacity_factor=capacity_factor,
        sliding_window=(get("sliding_window", None)
                        if get("use_sliding_window", True) else None),
    )


def load_quant_mixtral_from_hf_gptq(
    state: Mapping[str, object],
    hf_config,
    *,
    bits: int = 4,
    group_size: int = 128,
    gptq_v2: bool = False,
    opt_m=(1, 16, 256),
    moe_tokens: int = 256,
    capacity_factor: float = 2.0,
    act_dtype: str = "float16",
    enable_tuning: bool = False,
    device="cuda",
) -> Tuple[QuantMixtral, LMHead]:
    """A QuantMixtral trunk and its LMHead from a HF GPTQ Mixtral state
    dict (torch tensors on any device, or numpy arrays). `gptq_v2` takes
    GPTQModel v2 zeros; `capacity_factor` sets the experts' buffer
    headroom (a choice past an expert's capacity is dropped); widths other
    than 4 bits and act-order checkpoints are refused."""
    if bits != 4:
        raise ValueError(f"Mixtral import supports 4-bit (got {bits})")
    dev = resolve_device(device)
    cfg = mixtral_config_from_hf(hf_config, group_size=group_size,
                                 capacity_factor=capacity_factor,
                                 act_dtype=act_dtype)
    model = QuantMixtral(cfg, device=dev, enable_tuning=enable_tuning,
                         opt_m=opt_m, moe_tokens=moe_tokens)

    def repack(key, mcfg):
        _check_g_idx(state, key, mcfg.K, group_size)
        return repack_gptq_layer(
            mcfg, state[f"{key}.qweight"], state[f"{key}.scales"],
            state[f"{key}.qzeros"], gptq_v2=gptq_v2, device=dev)

    for i, layer in enumerate(model.layers):
        base = f"model.layers.{i}"
        for hf_name, ours in _ATTN:
            packed = repack(f"{base}.{hf_name}", layer.ops[ours].config)
            for t in ("qweight", "scales", "zeros"):
                setattr(layer, f"{ours}_{t}", packed[t])
        moe = layer.moe
        # HF stores the router [E, H]; the port multiplies [H, E]
        moe.router = as_tensor(state[f"{base}.block_sparse_moe.gate.weight"],
                               dev).float().T.contiguous()
        for hf_name, ours in _EXPERTS:
            mcfg = moe.ops[ours].config
            for e in range(cfg.n_experts):
                packed = repack(
                    f"{base}.block_sparse_moe.experts.{e}.{hf_name}", mcfg)
                for t, dst in zip(("qweight", "scales", "zeros"),
                                  moe.expert(ours, e)):
                    dst.copy_(packed[t])
        layer.attn_norm = as_tensor(
            state[f"{base}.input_layernorm.weight"], dev).float()
        layer.mlp_norm = as_tensor(
            state[f"{base}.post_attention_layernorm.weight"], dev).float()
        logger.info("imported mixtral layer %d/%d", i + 1, cfg.num_layers)
    head = LMHead(embed=as_tensor(state["model.embed_tokens.weight"], dev),
                  final_norm=as_tensor(state["model.norm.weight"], dev),
                  lm_head=as_tensor(state["lm_head.weight"], dev),
                  norm_eps=cfg.rms_norm_eps, device=dev,
                  act_dtype=getattr(torch, cfg.act_dtype))
    return model, head

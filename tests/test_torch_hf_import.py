"""bitblas_tpu_torch.models.hf_import's GPTQ import (CPU: the kernels'
plain versions) against the JAX package's importer on the same HF-layout
state dicts (the fixtures of tests/test_hf_import.py, rebuilt here): the
config mapping, act-order refused, every projection decoded bit for bit
as JAX's oracle decodes it, the 2-layer logits and perplexity, Qwen2
q/k/v biases. No `transformers` import: configs are dicts or plain
objects.

Tolerances: logits `bitblas_tpu_torch.testing.assert_close` with rtol
1e-2, atol 2e-3 of their largest magnitude (the hidden states are float16
through two layers on both sides; JAX applies the weight's scales to
f32 sums, the port rounds each weight to f16 first); perplexity within
1e-3 relative.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models import llama_config_from_hf as jax_config_from_hf
from bitblas_tpu.models import load_quant_llama_from_hf_gptq as jax_load
from bitblas_tpu.models import perplexity as jax_perplexity
from bitblas_tpu.quantization.packing import pack_autogptq

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.kernels.dequant_matmul import dequantize_hopper
from bitblas_tpu_torch.models.hf_import import (QuantLlamaLM,
                                                llama_config_from_hf,
                                                load_quant_llama_from_hf_gptq,
                                                perplexity,
                                                rope_scaling_from_hf)
from bitblas_tpu_torch.testing import assert_close

HF_CFG = {
    "hidden_size": 256,
    "intermediate_size": 512,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "num_hidden_layers": 2,
    "vocab_size": 64,
    "rope_theta": 10000.0,
}
G = 64
_PROJ_DIMS = {
    "self_attn.q_proj": (256, 256),
    "self_attn.k_proj": (256, 128),
    "self_attn.v_proj": (256, 128),
    "self_attn.o_proj": (256, 256),
    "mlp.gate_proj": (256, 512),
    "mlp.up_proj": (256, 512),
    "mlp.down_proj": (512, 256),
}
_HF2OURS = {"self_attn.q_proj": "q", "self_attn.k_proj": "k",
            "self_attn.v_proj": "v", "self_attn.o_proj": "o",
            "mlp.gate_proj": "gate", "mlp.up_proj": "up",
            "mlp.down_proj": "down"}


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


def _make_state(rng, *, v2=False, with_g_idx=False, act_order=False,
                qkv_bias=False):
    """(state_dict, {proj_key: (codes [K, N], zeros, scales)})"""
    state, truth = {}, {}
    for i in range(HF_CFG["num_hidden_layers"]):
        base = f"model.layers.{i}"
        for hf_name, (K, N) in _PROJ_DIMS.items():
            key = f"{base}.{hf_name}"
            codes = rng.integers(0, 16, (K, N)).astype(np.int64)
            zeros = rng.integers(0, 16, (K // G, N)).astype(np.int64)
            scales = (rng.standard_normal((K // G, N)) * 0.0002
                      + 0.001).astype(np.float16)
            qw, qz, sc = pack_autogptq(codes, zeros, scales, 4, v2=v2)
            state[f"{key}.qweight"] = qw
            state[f"{key}.qzeros"] = qz
            state[f"{key}.scales"] = sc
            if with_g_idx:
                g = np.arange(K, dtype=np.int64) // G
                if act_order:
                    g = g[rng.permutation(K)]
                state[f"{key}.g_idx"] = g
            if qkv_bias and _HF2OURS[hf_name] in ("q", "k", "v"):
                state[f"{key}.bias"] = (rng.standard_normal(N) * 0.1).astype(
                    np.float32)
            truth[key] = (codes, zeros, scales)
        state[f"{base}.input_layernorm.weight"] = \
            np.ones(256, np.float32) + 0.1 * rng.standard_normal(256)
        state[f"{base}.post_attention_layernorm.weight"] = \
            np.ones(256, np.float32) + 0.1 * rng.standard_normal(256)
    state["model.embed_tokens.weight"] = \
        rng.standard_normal((64, 256)).astype(np.float16)
    state["model.norm.weight"] = np.ones(256, np.float32)
    state["lm_head.weight"] = (rng.standard_normal((64, 256)) * 0.02).astype(
        np.float32)
    return state, truth


def _both(state, cfg=HF_CFG, **kw):
    jm, jh = jax_load(state, cfg, group_size=G, opt_m=(1, 16), **kw)
    pm, ph = load_quant_llama_from_hf_gptq(state, cfg, group_size=G,
                                           opt_m=(1, 16), device="cpu", **kw)
    return JaxQuantLlamaLM(jm, jh), QuantLlamaLM(pm, ph)


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert_close(got, want, rtol=1e-2, atol=2e-3 * scale,
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("v2", [False, True])
def test_import_matches_jax(v2):
    rng = np.random.default_rng(int(v2))
    state, truth = _make_state(rng, v2=v2, with_g_idx=True)
    jlm, plm = _both(state, gptq_v2=v2)
    for i, layer in enumerate(plm.model.layers):
        for hf_name, ours in _HF2OURS.items():
            codes, zeros, scales = truth[f"model.layers.{i}.{hf_name}"]
            W = dequantize_hopper(getattr(layer, f"{ours}_qweight"),
                                  getattr(layer, f"{ours}_scales"),
                                  getattr(layer, f"{ours}_zeros"), G)
            gidx = np.arange(codes.shape[0]) // G
            want = ((codes - zeros[gidx]).astype(np.float16)
                    * scales[gidx]).T                     # f16, as decoded
            np.testing.assert_array_equal(W.numpy(), want)
    toks = rng.integers(0, 64, (2, 8)).astype(np.int32)
    got = plm(torch.from_numpy(toks))
    assert got.shape == (2, 8, 64) and torch.isfinite(got).all()
    _logits_close(got, jlm(jnp.asarray(toks)))


def test_qwen2_qkv_biases_match_jax():
    rng = np.random.default_rng(5)
    state, _ = _make_state(rng, qkv_bias=True)
    cfg = dict(HF_CFG, model_type="qwen2")
    jlm, plm = _both(state, cfg)
    assert plm.model.cfg.attention_bias
    np.testing.assert_array_equal(
        plm.model.layers[0].k_bias.numpy(),
        state["model.layers.0.self_attn.k_proj.bias"])
    toks = rng.integers(0, 64, (1, 8)).astype(np.int32)
    _logits_close(plm(torch.from_numpy(toks)), jlm(jnp.asarray(toks)))


def test_unexpected_bias_refused():
    rng = np.random.default_rng(6)
    state, _ = _make_state(rng)
    state["model.layers.0.mlp.up_proj.bias"] = np.zeros(512, np.float32)
    with pytest.raises(ValueError, match="unexpected bias"):
        load_quant_llama_from_hf_gptq(state, HF_CFG, group_size=G,
                                      device="cpu")


def test_act_order_rejected():
    rng = np.random.default_rng(3)
    state, _ = _make_state(rng, with_g_idx=True, act_order=True)
    with pytest.raises(ValueError, match="act-order"):
        load_quant_llama_from_hf_gptq(state, HF_CFG, group_size=G,
                                      device="cpu")
    with pytest.raises(ValueError, match="act-order"):
        jax_load(state, HF_CFG, group_size=G, opt_m=(16,))


def test_tied_embedding_when_no_lm_head():
    rng = np.random.default_rng(7)
    state, _ = _make_state(rng)
    del state["lm_head.weight"]
    _, head = load_quant_llama_from_hf_gptq(state, HF_CFG, group_size=G,
                                            device="cpu")
    np.testing.assert_array_equal(
        head.lm_head.numpy(),
        state["model.embed_tokens.weight"].astype(np.float32))


@pytest.mark.parametrize("as_object", [False, True])
def test_config_mapping_matches_jax(as_object):
    hf = dict(HF_CFG, rms_norm_eps=1e-6, rope_theta=500000.0,
              rope_scaling={"rope_type": "llama3", "factor": 8.0,
                            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                            "original_max_position_embeddings": 8192})
    src = types.SimpleNamespace(**hf) if as_object else hf
    got = llama_config_from_hf(src, group_size=G)
    want = jax_config_from_hf(src, group_size=G)
    for f in ("hidden_size", "intermediate_size", "num_heads",
              "num_kv_heads", "num_layers", "vocab_size", "group_size",
              "act_dtype", "rope_theta", "rope_scaling", "attention_bias",
              "rms_norm_eps", "sliding_window"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.head_dim == 64 and got.num_kv_heads == 2


def test_config_rules():
    assert rope_scaling_from_hf({}.get) is None
    assert rope_scaling_from_hf({"rope_scaling": {"rope_type":
                                                  "default"}}.get) is None
    with pytest.raises(ValueError, match="linear"):
        rope_scaling_from_hf({"rope_scaling": {"type": "linear",
                                               "factor": 2.0}}.get)
    qwen = llama_config_from_hf(dict(HF_CFG, model_type="qwen2"))
    assert qwen.attention_bias and qwen.sliding_window is None
    sw = llama_config_from_hf(dict(HF_CFG, sliding_window=4096,
                                   use_sliding_window=False))
    assert sw.sliding_window is None
    with pytest.raises(NotImplementedError, match="max_window_layers"):
        llama_config_from_hf(dict(HF_CFG, sliding_window=16,
                                  max_window_layers=1))


def test_perplexity_matches_jax():
    rng = np.random.default_rng(4)
    state, _ = _make_state(rng)
    jlm, plm = _both(state)
    toks = rng.integers(0, 64, (4, 9)).astype(np.int32)
    want = jax_perplexity(jlm, toks)
    got = perplexity(plm, torch.from_numpy(toks))
    assert np.isfinite(got) and abs(got - want) <= 1e-3 * want, (got, want)
    assert abs(perplexity(plm, toks, chunk=2) - got) <= 1e-4 * got
    # a uniform LM has perplexity exactly its vocabulary
    assert abs(perplexity(lambda t: torch.zeros((*t.shape, 32)),
                          np.arange(16)[None] % 32) - 32) < 1e-3


def test_port_never_imports_transformers():
    """The card's machine has no `transformers`: importing every module of
    the port (and chip_smoke.py) must not pull it in."""
    import subprocess
    import sys
    code = (
        "import pkgutil, sys, importlib\n"
        "import bitblas_tpu_torch\n"
        "for m in pkgutil.walk_packages(bitblas_tpu_torch.__path__,"
        " 'bitblas_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m == 'transformers'"
        " or m.startswith('transformers.')]\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr

"""bitblas_tpu_torch.models.hf_import_mixtral against the JAX package's
importer, on the CPU: the same synthetic AutoGPTQ / GPTQModel Mixtral
state dict (JAX's tests/test_hf_import_mixtral.py fixture rebuilt, 2
layers here) through both, v1 and v2 zeros; each decoded expert and
attention weight against the float32 truth; the config mapping,
Mixtral-8x7B-v0.1's own included.

Tolerances: decoded weights within one float16 rounding of the float32
truth (rtol 2^-11: the port evaluates (q - z) * s in float16); a
projection through the kernels' plain versions against x @ truth as
JAX's test holds it (rtol 5e-2, atol 5e-3); logits within 1e-2 of their
largest magnitude (f16 activations through two MoE layers on both
sides, JAX's kernel applying the scales to f32 sums; see
tests/test_torch_mixtral.py).
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models.hf_import_mixtral import (
    load_quant_mixtral_from_hf_gptq as jax_load,
    mixtral_config_from_hf as jax_config_from_hf)
from bitblas_tpu.quantization.packing import pack_autogptq

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.kernels.dequant_matmul import dequantize_hopper
from bitblas_tpu_torch.models.hf_import import QuantLlamaLM
from bitblas_tpu_torch.models.hf_import_mixtral import (
    load_quant_mixtral_from_hf_gptq, mixtral_config_from_hf)
from bitblas_tpu_torch.testing import assert_close

HF_CFG = {
    "hidden_size": 256,
    "intermediate_size": 512,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "num_hidden_layers": 2,
    "vocab_size": 64,
    "rope_theta": 1e6,
    "num_local_experts": 4,
    "num_experts_per_tok": 2,
}
# mistralai/Mixtral-8x7B-v0.1 config.json
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "hidden_size": 4096,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "rms_norm_eps": 1e-05, "rope_theta": 1e6, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_size": 32000,
}
G = 64
_ATTN_DIMS = {"self_attn.q_proj": (256, 256), "self_attn.k_proj": (256, 128),
              "self_attn.v_proj": (256, 128), "self_attn.o_proj": (256, 256)}
_EXPERT_DIMS = {"w1": (256, 512), "w3": (256, 512), "w2": (512, 256)}
_OURS = {"w1": "gate", "w3": "up", "w2": "down"}


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread (the tier-1 command runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle(rng, K, N, v2):
    codes = rng.integers(0, 16, (K, N)).astype(np.int64)
    zeros = rng.integers(0, 16, (K // G, N)).astype(np.int64)
    scales = (rng.standard_normal((K // G, N)) * 0.0002
              + 0.001).astype(np.float16)
    qw, qz, sc = pack_autogptq(codes, zeros, scales, 4, v2=v2)
    gidx = np.repeat(np.arange(K // G), G)
    truth = (scales.astype(np.float32)[gidx]
             * (codes - zeros[gidx])).astype(np.float32)
    return {"qweight": qw, "qzeros": qz, "scales": sc}, truth


def _make_state(rng, v2=False, g_idx=None):
    state, truth = {}, {}
    H, E = HF_CFG["hidden_size"], HF_CFG["num_local_experts"]
    for i in range(HF_CFG["num_hidden_layers"]):
        base = f"model.layers.{i}"
        keys = [(f"{base}.{n}", d) for n, d in _ATTN_DIMS.items()]
        keys += [(f"{base}.block_sparse_moe.experts.{e}.{w}", d)
                 for e in range(E) for w, d in _EXPERT_DIMS.items()]
        for key, (K, N) in keys:
            b, t = _bundle(rng, K, N, v2)
            for k, v in b.items():
                state[f"{key}.{k}"] = v
            if g_idx is not None:
                state[f"{key}.g_idx"] = g_idx(K)
            truth[key] = t
        state[f"{base}.block_sparse_moe.gate.weight"] = \
            (rng.standard_normal((E, H)) * 0.05).astype(np.float16)
        state[f"{base}.input_layernorm.weight"] = \
            np.ones(H, np.float32) + 0.1 * rng.standard_normal(H)
        state[f"{base}.post_attention_layernorm.weight"] = \
            np.ones(H, np.float32) + 0.1 * rng.standard_normal(H)
    state["model.embed_tokens.weight"] = \
        (rng.standard_normal((64, H)) * 0.05).astype(np.float16)
    state["model.norm.weight"] = np.ones(H, np.float32)
    state["lm_head.weight"] = (rng.standard_normal((64, H)) * 0.05).astype(
        np.float32)
    return state, truth


def _load(state, **kw):
    return load_quant_mixtral_from_hf_gptq(
        state, HF_CFG, group_size=G, opt_m=(1, 8, 16), moe_tokens=16,
        device="cpu", **kw)


@pytest.mark.parametrize("v2", [False, True])
def test_import_matches_jax(v2):
    state, _ = _make_state(np.random.default_rng(0), v2=v2)
    jm, jh = jax_load(state, HF_CFG, group_size=G, gptq_v2=v2,
                      opt_m=(1, 8, 16), moe_tokens=16)
    pm, ph = _load(state, gptq_v2=v2)
    toks = np.random.default_rng(4).integers(0, 64, (2, 10))
    want = np.asarray(JaxQuantLlamaLM(jm, jh)(jnp.asarray(toks)), np.float32)
    got = QuantLlamaLM(pm, ph)(toks)
    assert_close(got, want, rtol=0.0, atol=1e-2 * float(np.abs(want).max()),
                 max_mismatched_ratio=0.0)
    for jl, pl in zip(jm.layers, pm.layers):
        assert np.array_equal(pl.moe.router.numpy(),
                              np.asarray(jl.moe.router))
        assert np.array_equal(pl.attn_norm.numpy(),
                              np.asarray(jl.attn_norm))


@pytest.mark.parametrize("v2", [False, True])
def test_decoded_weights_match_the_truth(v2):
    """Every expert's and attention projection's decoded weight within one
    f16 rounding of the float32 truth, and the projections through the
    kernels' plain versions against x @ truth (JAX's
    test_mixtral_import_matches_dequant_truth)."""
    rng = np.random.default_rng(1)
    state, truth = _make_state(rng, v2=v2)
    pm, _ = _load(state, gptq_v2=v2)
    for i, layer in enumerate(pm.layers):
        base = f"model.layers.{i}"
        for e in range(HF_CFG["num_local_experts"]):
            for w, ours in _OURS.items():
                W = dequantize_hopper(*layer.moe.expert(ours, e), G).float()
                want = truth[f"{base}.block_sparse_moe.experts.{e}.{w}"].T
                np.testing.assert_allclose(W.numpy(), want, rtol=2.0 ** -11,
                                           atol=0)
        for hf_name, ours in (("self_attn.q_proj", "q"),
                              ("self_attn.o_proj", "o")):
            W = dequantize_hopper(getattr(layer, f"{ours}_qweight"),
                                  getattr(layer, f"{ours}_scales"),
                                  getattr(layer, f"{ours}_zeros"), G).float()
            np.testing.assert_allclose(W.numpy(), truth[f"{base}.{hf_name}"].T,
                                       rtol=2.0 ** -11, atol=0)
    layer = pm.layers[0]
    for e, w in ((0, "w1"), (3, "w2")):
        W_true = truth[f"model.layers.0.block_sparse_moe.experts.{e}.{w}"]
        x = rng.standard_normal((16, W_true.shape[0])).astype(np.float16)
        out = layer.moe.proj(_OURS[w], e, torch.from_numpy(x))
        assert_close(out, x.astype(np.float32) @ W_true, rtol=5e-2,
                     atol=5e-3, msg=f"expert {e} {w}")
    hf_router = state["model.layers.0.block_sparse_moe.gate.weight"]
    assert np.array_equal(layer.moe.router.numpy(),
                          hf_router.astype(np.float32).T)


def test_import_generates():
    state, _ = _make_state(np.random.default_rng(2))
    pm, ph = _load(state)
    lm = QuantLlamaLM(pm, ph)
    out = lm.generate(np.arange(6), max_new_tokens=4)
    assert out.shape == (10,) and out.min() >= 0 and out.max() < 64
    assert torch.isfinite(lm(out[None, :6])).all()


@pytest.mark.parametrize("as_object", [False, True])
@pytest.mark.parametrize("hf", ["small", "8x7b", "windowed", "window_off"])
def test_config_mapping_matches_jax(hf, as_object):
    src = {"small": HF_CFG, "8x7b": MIXTRAL_8X7B,
           "windowed": dict(HF_CFG, sliding_window=4096),
           "window_off": dict(HF_CFG, sliding_window=4096,
                              use_sliding_window=False)}[hf]
    if as_object:
        src = types.SimpleNamespace(**src)
    want = jax_config_from_hf(src, group_size=G)
    got = mixtral_config_from_hf(src, group_size=G)
    for f in ("hidden_size", "intermediate_size", "num_heads",
              "num_kv_heads", "num_layers", "vocab_size", "group_size",
              "act_dtype", "rope_theta", "rope_scaling", "rms_norm_eps",
              "n_experts", "top_k", "capacity_factor", "sliding_window"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.head_dim == want.head_dim
    if hf == "8x7b":
        assert (got.n_experts, got.top_k, got.num_kv_heads, got.head_dim,
                got.sliding_window, got.capacity_factor) == \
            (8, 2, 8, 128, None, 2.0)
    if hf == "windowed":
        assert got.sliding_window == 4096
    if hf == "window_off":
        assert got.sliding_window is None


def test_refusals():
    state, _ = _make_state(np.random.default_rng(3))
    with pytest.raises(ValueError, match="4-bit"):
        _load(state, bits=8)
    perm = np.random.default_rng(5)
    state, _ = _make_state(np.random.default_rng(3),
                           g_idx=lambda K: perm.permutation(K) // G)
    with pytest.raises(ValueError, match="act-order"):
        _load(state)

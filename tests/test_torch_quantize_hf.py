"""bitblas_tpu_torch.models.quantize_hf (float checkpoint -> the port's
uint4 Llama and Mixtral, RTN or GPTQ) against the JAX package's
quantizers on the same float16 HF-layout state dicts, on the CPU.

Fixtures: JAX's tests/test_quantize.py (hidden 256, intermediate 512, 4 /
2 heads, vocab 128; Llama 2 layers, Mixtral 1 layer with 4 experts top-2;
calibration 2 x 32 tokens). JAX's quantized model is carried across with
`convert.from_jax_state` / `from_jax_mixtral_state`; the JAX side runs its
Pallas kernels in interpret mode, the port its kernels' plain versions.

- RTN: every packed buffer (codes, float16 scales and zeros, norms, the
  router) bit for bit against JAX's; JAX's identity-probe wiring check
  through the port's plain kernel.
- GPTQ: the codes against JAX's (measured: 0 of 1,179,648 Llama codes
  and 0 of 1,769,472 Mixtral codes differ; held to at most 1e-4 of them,
  each one step), scales and zeros likewise, logits within 1e-2 of the
  largest (measured 9e-4 and 5e-4: float16 hidden states on both sides).
  The sliding window and q / k / v biases in the calibration forward
  (a Qwen2-style config) likewise, and the window changes the codes.
- The errors JAX raises; a Mixtral expert with no calibration traffic is
  RTN's bit for bit; the quantized Llama tracks the float model (rel <
  0.25, JAX's bound), also built from a random-init
  `transformers.LlamaForCausalLM` state dict (torch tensors).
"""

import copy
import logging
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models.quantize_hf import \
    quantize_llama_from_hf_fp16 as jax_quantize_llama
from bitblas_tpu.models.quantize_hf import \
    quantize_mixtral_from_hf_fp16 as jax_quantize_mixtral
from bitblas_tpu.quantization.gptq import rtn_quantize as jax_rtn

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV, get_logger
from bitblas_tpu_torch.convert import from_jax_mixtral_state, from_jax_state
from bitblas_tpu_torch.models.hf_import import QuantLlamaLM
from bitblas_tpu_torch.models.quant_llama import rmsnorm, rope
from bitblas_tpu_torch.models.quantize_hf import (
    _attention, quantize_llama_from_hf_fp16, quantize_mixtral_from_hf_fp16)
from bitblas_tpu_torch.quantization import packing

TINY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=128)
TINY_MIX = dict(TINY, num_hidden_layers=1, num_local_experts=4,
                num_experts_per_tok=2)
OPT_M = (1, 16)
MIX_KW = dict(opt_m=(1, 8, 16), moe_tokens=16)
LOGIT_REL = 1e-2
CODE_SHARE = 1e-4
PROJS = (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
         ("self_attn.v_proj", "v"), ("self_attn.o_proj", "o"),
         ("mlp.gate_proj", "gate"), ("mlp.up_proj", "up"),
         ("mlp.down_proj", "down"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread (the tier-1 command runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


def _llama_state(cfg, seed=0, qkv_bias=False):
    """JAX's _tiny_fp16_llama_state (float16 N(0, 0.02) projections,
    embedding and lm_head * 0.05, unit norms), with q / k / v biases
    when asked."""
    rng = np.random.default_rng(seed)
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    kv = cfg["num_key_value_heads"] * H // cfg["num_attention_heads"]
    V = cfg["vocab_size"]

    def w(n, k, scale=0.02):
        return (rng.standard_normal((n, k)) * scale).astype(np.float16)

    state = {"model.embed_tokens.weight": w(V, H, 0.05),
             "model.norm.weight": np.ones(H, np.float16),
             "lm_head.weight": w(V, H, 0.05)}
    dims = {"q": (H, H), "k": (kv, H), "v": (kv, H), "o": (H, H),
            "gate": (I, H), "up": (I, H), "down": (H, I)}
    for i in range(cfg["num_hidden_layers"]):
        b = f"model.layers.{i}"
        for hf, ours in PROJS:
            state[f"{b}.{hf}.weight"] = w(*dims[ours])
            if qkv_bias and ours in ("q", "k", "v"):
                state[f"{b}.{hf}.bias"] = (rng.standard_normal(
                    dims[ours][0]) * 0.1).astype(np.float16)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{b}.{norm}.weight"] = np.ones(H, np.float16)
    return state


def _mixtral_state(cfg, seed=0):
    """JAX's _tiny_fp16_mixtral_state."""
    rng = np.random.default_rng(seed)
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    kv = cfg["num_key_value_heads"] * H // cfg["num_attention_heads"]
    V, E = cfg["vocab_size"], cfg["num_local_experts"]

    def w(n, k, scale=0.02):
        return (rng.standard_normal((n, k)) * scale).astype(np.float16)

    state = {"model.embed_tokens.weight": w(V, H, 0.05),
             "model.norm.weight": np.ones(H, np.float16),
             "lm_head.weight": w(V, H, 0.05)}
    for i in range(cfg["num_hidden_layers"]):
        b = f"model.layers.{i}"
        state[f"{b}.self_attn.q_proj.weight"] = w(H, H)
        state[f"{b}.self_attn.k_proj.weight"] = w(kv, H)
        state[f"{b}.self_attn.v_proj.weight"] = w(kv, H)
        state[f"{b}.self_attn.o_proj.weight"] = w(H, H)
        state[f"{b}.block_sparse_moe.gate.weight"] = w(E, H, 0.05)
        for e in range(E):
            base = f"{b}.block_sparse_moe.experts.{e}"
            state[f"{base}.w1.weight"] = w(I, H)
            state[f"{base}.w3.weight"] = w(I, H)
            state[f"{base}.w2.weight"] = w(H, I)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{b}.{norm}.weight"] = np.ones(H, np.float16)
    return state


def _calib(seed, shape=(2, 32)):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], shape)


def _np_state(model):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in model.state_dict().items()}


def _compare(want_sd, got_sd, exact: bool):
    """JAX's carried-across state against the port's: exact, every tensor
    bit for bit; otherwise the codes may differ in at most CODE_SHARE of
    places, each by one step, and the rest equal where the codes are.
    Returns the number of differing codes."""
    assert set(want_sd) <= set(got_sd)
    differ = total = 0
    for key, want in want_sd.items():
        got = got_sd[key]
        if key.endswith("qweight") and not exact:
            d = (packing.unpack_k(want, 4).long()
                 - packing.unpack_k(got, 4).long()).abs()
            assert int(d.max()) <= 1, key
            differ += int((d > 0).sum())
            total += d.numel()
        elif not exact and key.endswith(("scales", "zeros")):
            assert float((want.float() - got.float()).abs().max()) <= \
                float(want.float().abs().max()) * 1e-2, key
        else:
            assert torch.equal(want, got), key
    assert differ <= CODE_SHARE * max(total, 1), (differ, total)
    return differ


def _logits_close(jax_lm, lm, toks):
    want = np.asarray(jax_lm(jnp.asarray(toks)), np.float32)
    got = lm(torch.from_numpy(toks)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_REL * np.abs(want).max())


@pytest.mark.parametrize("method", ["rtn", "gptq"])
def test_llama_matches_jax(method):
    state = _llama_state(TINY)
    calib = _calib(7) if method == "gptq" else None
    jm, jh = jax_quantize_llama(state, TINY, method=method,
                                calib_tokens=calib, opt_m=OPT_M)
    pm, ph = quantize_llama_from_hf_fp16(state, TINY, method=method,
                                         calib_tokens=calib, opt_m=OPT_M,
                                         device="cpu")
    _compare(from_jax_state(_np_state(jm), pm.cfg),
             pm.state_dict(), exact=method == "rtn")
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(getattr(ph, name).numpy(),
                                      np.asarray(getattr(jh, name)))
    _logits_close(JaxQuantLlamaLM(jm, jh), QuantLlamaLM(pm, ph),
                  _calib(13, (1, 16)))


def test_llama_rtn_wiring_identity_probe():
    """One-hot rows through the port's projection (the kernel's plain
    version) read back the RTN weight with float16 scales, exactly (JAX's
    test_quantize_llama_rtn_wiring_bit_exact)."""
    state = _llama_state(TINY)
    model, _ = quantize_llama_from_hf_fp16(state, TINY, method="rtn",
                                           opt_m=OPT_M, device="cpu")
    w = state["model.layers.0.self_attn.q_proj.weight"].astype(np.float32)
    qw = jax_rtn(w, bits=4, group_size=128)
    g = np.repeat(np.arange(qw.scales.shape[1]), qw.group_size)
    want = ((qw.codes.astype(np.float32) - qw.zeros[:, g])
            * qw.scales.astype(np.float16).astype(np.float32)[:, g])
    K = w.shape[1]
    eye = torch.eye(K, dtype=torch.float16)
    got = torch.cat([model.layers[0].proj("q", eye[o:o + 16])
                     for o in range(0, K, 16)]).float().numpy()
    np.testing.assert_array_equal(got, want.T.astype(np.float16)
                                  .astype(np.float32))


QWEN_WINDOW = dict(TINY, num_hidden_layers=1, model_type="qwen2",
                   sliding_window=8, use_sliding_window=True,
                   max_window_layers=1)


def test_gptq_window_and_biases_match_jax():
    """A Qwen2-style config (q / k / v biases) with an 8-token window over
    32-token calibration rows: the calibration forward windows and adds
    the biases as JAX's does, and the window moves the codes."""
    state = _llama_state(QWEN_WINDOW, seed=3, qkv_bias=True)
    calib = _calib(4)
    kw = dict(method="gptq", calib_tokens=calib, opt_m=OPT_M)
    jm, jh = jax_quantize_llama(state, QWEN_WINDOW, **kw)
    pm, ph = quantize_llama_from_hf_fp16(state, QWEN_WINDOW, device="cpu",
                                         **kw)
    assert pm.cfg.sliding_window == 8 and pm.cfg.attention_bias
    _compare(from_jax_state(_np_state(jm), pm.cfg), pm.state_dict(),
             exact=False)
    _logits_close(JaxQuantLlamaLM(jm, jh), QuantLlamaLM(pm, ph),
                  _calib(5, (1, 16)))
    full, _ = quantize_llama_from_hf_fp16(
        state, dict(QWEN_WINDOW, use_sliding_window=False), device="cpu",
        **kw)
    assert not torch.equal(full.layers[0].o_qweight, pm.layers[0].o_qweight)


def test_errors():
    state = _llama_state(TINY)
    kw = dict(opt_m=OPT_M, device="cpu")
    with pytest.raises(ValueError, match="method"):
        quantize_llama_from_hf_fp16(state, TINY, method="awq", **kw)
    with pytest.raises(ValueError, match="uint4"):
        quantize_llama_from_hf_fp16(state, TINY, bits=3, **kw)
    with pytest.raises(ValueError, match="calib_tokens"):
        quantize_llama_from_hf_fp16(state, TINY, method="gptq", **kw)
    biased = dict(state)
    biased["model.layers.0.mlp.up_proj.bias"] = np.zeros(512, np.float16)
    with pytest.raises(ValueError, match="unexpected bias"):
        quantize_llama_from_hf_fp16(biased, TINY, **kw)
    mix = _mixtral_state(TINY_MIX)
    mix["model.layers.0.block_sparse_moe.experts.1.w2.bias"] = np.zeros(
        256, np.float16)
    with pytest.raises(ValueError, match="bias-free"):
        quantize_mixtral_from_hf_fp16(mix, TINY_MIX, device="cpu", **MIX_KW)
    with pytest.raises(ValueError, match="calib_tokens"):
        quantize_mixtral_from_hf_fp16(mix, TINY_MIX, method="gptq",
                                      device="cpu", **MIX_KW)


@pytest.mark.parametrize("method", ["rtn", "gptq"])
def test_mixtral_matches_jax(method):
    state = _mixtral_state(TINY_MIX)
    calib = _calib(3) if method == "gptq" else None
    jm, jh = jax_quantize_mixtral(state, TINY_MIX, method=method,
                                  calib_tokens=calib, **MIX_KW)
    pm, ph = quantize_mixtral_from_hf_fp16(state, TINY_MIX, method=method,
                                           calib_tokens=calib, device="cpu",
                                           **MIX_KW)
    _compare(from_jax_mixtral_state(_np_state(jm), pm.cfg), pm.state_dict(),
             exact=method == "rtn")
    # the router carried over as [H, E] float32
    router = state["model.layers.0.block_sparse_moe.gate.weight"]
    np.testing.assert_array_equal(pm.layers[0].moe.router.numpy(),
                                  router.astype(np.float32).T)
    lm = QuantLlamaLM(pm, ph)
    _logits_close(JaxQuantLlamaLM(jm, jh), lm, _calib(9, (1, 16)))
    assert lm.generate(np.arange(5), max_new_tokens=4).shape == (9,)


def test_mixtral_zero_traffic_expert_is_rtn():
    """An expert the calibration stream never reaches: every embedding
    holds 2.0 in channel 0, which q / k / v do not read and o does not
    write, so each token's normalized MLP input is positive there; expert
    3's router row is -10 there and 0 elsewhere, the other rows 0 there:
    its logit is the lowest for every token. Its weights are RTN's codes,
    scales and zeros bit for bit (not GPTQ's zeroed dead columns), a
    warning names it in both passes, and the experts with traffic differ
    from RTN (chip_smoke.py's quantize_mixtral builds the same case)."""
    state = _mixtral_state(TINY_MIX, seed=5)
    state["model.embed_tokens.weight"][:, 0] = 2.0
    for p in ("q", "k", "v"):
        state[f"model.layers.0.self_attn.{p}_proj.weight"][:, 0] = 0.0
    state["model.layers.0.self_attn.o_proj.weight"][0] = 0.0
    r = state["model.layers.0.block_sparse_moe.gate.weight"].copy()
    r[:, 0] = 0.0
    r[3, 0] = -10.0
    state["model.layers.0.block_sparse_moe.gate.weight"] = r
    warned = []
    handler = logging.Handler()
    handler.emit = lambda rec: warned.append(rec.getMessage())
    get_logger().addHandler(handler)
    try:
        model, _ = quantize_mixtral_from_hf_fp16(
            state, TINY_MIX, method="gptq", calib_tokens=_calib(6),
            device="cpu", **MIX_KW)
    finally:
        get_logger().removeHandler(handler)
    assert len(warned) == 2 and all("expert 3 received no calibration"
                                    in m for m in warned), warned
    moe = model.layers[0].moe
    for e in range(4):
        for hf, name in (("w1", "gate"), ("w3", "up"), ("w2", "down")):
            w = state[f"model.layers.0.block_sparse_moe.experts.{e}."
                      f"{hf}.weight"].astype(np.float32)
            qw = jax_rtn(w, bits=4, group_size=128)
            W, S, Z = moe.ops[name].transform_weight(
                qw.codes.astype(np.int8), scale=qw.scales.astype(np.float16),
                zeros=qw.zeros.astype(np.float16))
            got = moe.expert(name, e)
            same = all(torch.equal(a, b) for a, b in zip(got, (W, S, Z)))
            assert same == (e == 3), (e, name)


def _float_logits(state, cfg, model, head, toks):
    """The float model straight from the state dict, in float32 (JAX's
    test_quantize_llama_tracks_fp16_model reference forward)."""
    S = toks.shape[1]
    positions = torch.arange(S)[None]
    x = head.embed_tokens(torch.from_numpy(toks)).float()
    c = model.cfg
    for i in range(c.num_layers):
        b = f"model.layers.{i}"
        W = {name: torch.as_tensor(np.asarray(state[f"{b}.{hf}.weight"]))
             .float() for hf, name in PROJS}
        h = rmsnorm(x, torch.as_tensor(np.asarray(
            state[f"{b}.input_layernorm.weight"])).float(), c.rms_norm_eps)
        q = (h @ W["q"].T).reshape(1, S, c.num_heads, c.head_dim)
        k = (h @ W["k"].T).reshape(1, S, c.num_kv_heads, c.head_dim)
        v = (h @ W["v"].T).reshape(1, S, c.num_kv_heads, c.head_dim)
        attn = _attention(c, rope(q, positions, c.rope_arg),
                          rope(k, positions, c.rope_arg), v)
        x = x + attn @ W["o"].T
        h2 = rmsnorm(x, torch.as_tensor(np.asarray(
            state[f"{b}.post_attention_layernorm.weight"])).float(),
            c.rms_norm_eps)
        x = x + (torch.nn.functional.silu(h2 @ W["gate"].T)
                 * (h2 @ W["up"].T)) @ W["down"].T
    return head.logits(x).numpy()


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-6))


def test_quantized_llama_tracks_the_float_model():
    state = _llama_state(TINY, seed=11)
    model, head = quantize_llama_from_hf_fp16(state, TINY, method="rtn",
                                              opt_m=OPT_M, device="cpu")
    toks = _calib(13, (1, 16))
    got = QuantLlamaLM(model, head)(torch.from_numpy(toks)).numpy()
    # random weights are RTN's worst case (every weight a half step off the
    # grid); JAX's bound, measured ~0.17 there
    assert _rel(got, _float_logits(state, TINY, model, head, toks)) < 0.25


def test_random_init_transformers_llama(monkeypatch):
    """A random-init transformers LlamaForCausalLM built from a local
    config (no download): its state dict (torch tensors) and config object
    quantized by RTN and GPTQ; the port's logits track HF's float logits
    (rel < 0.25). Only the test imports transformers (without its
    TensorFlow side, which only slows the import)."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        hidden_size=256, intermediate_size=512, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=2, vocab_size=128,
        max_position_embeddings=64, attn_implementation="eager")
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    toks = _calib(17, (1, 16))
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.float().numpy()
    state = copy.deepcopy(hf.state_dict())
    for method in ("rtn", "gptq"):
        model, head = quantize_llama_from_hf_fp16(
            state, hf_cfg, method=method, calib_tokens=_calib(18),
            opt_m=OPT_M, device="cpu")
        assert math.isclose(model.cfg.rms_norm_eps, hf_cfg.rms_norm_eps)
        got = QuantLlamaLM(model, head)(torch.from_numpy(toks)).numpy()
        assert _rel(got, want) < 0.25, method


def test_default_device_is_the_card(monkeypatch):
    """The quantizers and the Hessian accumulator default to "cuda" and raise
    without a card; only device="cpu" runs on the CPU."""
    from bitblas_tpu_torch.quantization.gptq import HessianAccumulator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_llama_from_hf_fp16(_llama_state(TINY), TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_mixtral_from_hf_fp16(_mixtral_state(TINY_MIX), TINY_MIX)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HessianAccumulator(8)

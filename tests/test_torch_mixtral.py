"""The port's Mixtral decoder (bitblas_tpu_torch.models.quant_moe
.QuantMixtral) against the JAX package's, on the CPU: the full forward,
generate, the token engine on the float and the int8 slot cache, the
paged engine, token counts, zero rows, the state dict and checkpoint
round trips, and the Llama path under the MLP hook.

Fixture: JAX's tests/test_mixtral.py config (hidden 256, intermediate
512, 4 heads / 2 KV heads, 2 layers, vocab 64, 4 experts top-2, capacity
factor 2.0); the JAX model's random weights carried across with
`convert.from_jax_mixtral_state`. The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.

Tolerances: hidden states, logits and MoE outputs within 1e-2 of their
largest magnitude (`REL`). Both sides run f16 activations; the JAX
kernel applies the scales to f32 sums where the port rounds each weight
to f16, and the expert weights' scales (0.004-0.02, JAX's fixture) are
larger than the attention's: measured <= 5.2e-3 on the logits, 4.5e-3
on the hidden states (JAX's own MoE layer sits 3.4e-3 from its float32
oracle, the port's 7e-4: tests/test_torch_moe.py). Single projections
within 1e-2 absolute and relative. Greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.models import MixtralConfig as JaxMixtralConfig
from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models import QuantMixtral as JaxQuantMixtral
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.serving import PagedContinuousBatchingEngine as JaxPaged
from bitblas_tpu.serving import Request as JaxRequest
from bitblas_tpu.serving import \
    TokenContinuousBatchingEngine as JaxTokenEngine

from bitblas_tpu_torch.convert import from_jax_mixtral_state
from bitblas_tpu_torch.models import quant_llama as pql
from bitblas_tpu_torch.models.hf_import import LMHead, QuantLlamaLM
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.models.quant_moe import (MixtralConfig, QuantMixtral,
                                                moe_capacity)
from bitblas_tpu_torch.module.checkpoint import (load_quant_state,
                                                 save_quant_state)
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.serving.engine import (PagedContinuousBatchingEngine,
                                              Request,
                                              TokenContinuousBatchingEngine)
from bitblas_tpu_torch.testing import assert_close

V, H = 64, 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=4,
           num_kv_heads=2, num_layers=2, vocab_size=V, group_size=128,
           n_experts=4, top_k=2, capacity_factor=2.0)
OPT_M = (1, 4, 8, 16)
ATOL = 1e-2
REL = 1e-2


def _close(got, want, msg=""):
    want = np.asarray(want, np.float32)
    assert_close(got, want, rtol=0.0, atol=REL * float(np.abs(want).max()),
                 max_mismatched_ratio=0.0, msg=msg)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread (the tier-1 command runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synchronous(engine):
    """A JAX engine whose decode steps finish before they return (the JAX
    engines update host arrays an asynchronous step may still read; see
    tests/test_torch_serving.py)."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


def _np_state(model) -> dict:
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    jm = JaxQuantMixtral(JaxMixtralConfig(**CFG), opt_m=OPT_M, moe_tokens=16)
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V, H)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, H)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((H,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = MixtralConfig(**CFG)
    pm = QuantMixtral(cfg, device="cpu", seed=123, opt_m=OPT_M,
                      moe_tokens=16)
    pm.load_state_dict(from_jax_mixtral_state(_np_state(jm), cfg))
    ph = LMHead(embed, np.ones(H, np.float32), lm_head, device="cpu")
    return jm, jh, pm, ph, embed


def test_convert_carries_every_projection(pair):
    jm, _, pm, _, _ = pair
    x = np.random.default_rng(1).standard_normal((3, 512)).astype(np.float16)
    for jl, pl in zip(jm.layers, pm.layers):
        for name in ("q", "k", "v", "o"):
            want = np.asarray(jl.proj(name, jnp.asarray(x[:, :H])))
            got = pl.proj(name, torch.from_numpy(x[:, :H]))
            assert_close(got, want, rtol=1e-2, atol=ATOL,
                         max_mismatched_ratio=0.0, msg=name)
        for e in (0, 3):
            for name, K in (("gate", H), ("down", 512)):
                W, S, Z = jl.moe.weights[name][e]
                want = np.asarray(jl.moe.ops[name].forward(
                    jnp.asarray(x[:, :K]), W, scale=S, zeros=Z))
                got = pl.moe.proj(name, e, torch.from_numpy(x[:, :K]))
                assert_close(got, want, rtol=1e-2, atol=ATOL,
                             max_mismatched_ratio=0.0, msg=f"{name} {e}")
        assert np.array_equal(pl.moe.router.numpy(),
                              np.asarray(jl.moe.router))
        assert np.array_equal(pl.mlp_norm.numpy(), np.asarray(jl.mlp_norm))


def test_full_forward_logits_match_jax(pair):
    jm, jh, pm, ph, _ = pair
    toks = np.random.default_rng(6).integers(0, V, (2, 12))
    want = np.asarray(JaxQuantLlamaLM(jm, jh)(jnp.asarray(toks)))
    got = QuantLlamaLM(pm, ph)(toks)
    assert tuple(got.shape) == (2, 12, V)
    _close(got, want)


def test_generate_matches_jax(pair):
    """Greedy generate (prefill, then T = 1 decode steps through the MoE
    hook) gives JAX's tokens, and the full-forward recompute agrees with
    each (JAX's test_mixtral_generate_matches_full_forward)."""
    jm, jh, pm, ph, _ = pair
    prompt = np.arange(6, dtype=np.int32)
    want = JaxQuantLlamaLM(jm, jh).generate(prompt, max_new_tokens=4,
                                            temperature=0.0)
    lm = QuantLlamaLM(pm, ph)
    got = lm.generate(prompt, max_new_tokens=4)
    assert np.array_equal(got, np.asarray(want))
    for t in range(6, 10):
        assert int(lm(got[None, :t])[0, -1].argmax()) == got[t], t


@pytest.mark.parametrize("kv_quant", [False, True])
def test_token_engine_greedy_tokens_match_jax(pair, kv_quant):
    """Two requests on three slots (an inactive slot's zero rows ride
    every decode step): the float and the int8 slot cache."""
    jm, jh, pm, ph, _ = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (9, 20)]
    je = _synchronous(JaxTokenEngine(jm, jh, num_slots=3, max_seq_len=64,
                                     kv_quant=kv_quant))
    pe = TokenContinuousBatchingEngine(pm, ph, num_slots=3, max_seq_len=64,
                                       kv_quant=kv_quant)
    jr = [je.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    pr = [pe.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    je.run_to_completion()
    pe.run_to_completion()
    for a, b in zip(jr, pr):
        assert b.done and len(b.out_tokens) == 5
        assert b.out_tokens == a.out_tokens, b.uid
        _close(b.final_hidden, a.final_hidden)
    if kv_quant:
        assert pe.caches_k.dtype == torch.int8


def test_paged_engine_matches_jax(pair):
    """Hidden-state requests on the paged pool, two sharing a prefix: the
    block tables step by step, the final hidden states and their greedy
    tokens through the head."""
    jm, jh, pm, ph, _ = pair
    rng = np.random.default_rng(8)
    prefix = (rng.standard_normal((8, H)) * 0.05).astype(np.float16)
    prompts = [np.concatenate([prefix, (rng.standard_normal((n, H)) * 0.05)
                               .astype(np.float16)]) for n in (3, 5)]
    prompts.append((rng.standard_normal((6, H)) * 0.05).astype(np.float16))
    kw = dict(num_slots=3, num_blocks=16, block_size=4)
    je = _synchronous(JaxPaged(jm, **kw))
    pe = PagedContinuousBatchingEngine(pm, **kw)
    for i, p in enumerate(prompts):
        je.submit(JaxRequest(uid=i, prompt=p, max_new=4))
        pe.submit(Request(uid=i, prompt=p, max_new=4))
    for step in range(20):
        if not (je.active or je.pending):
            break
        je.step()
        pe.step()
        assert np.array_equal(pe.tables, je.tables), step
    assert not (pe.active or pe.pending) and pe.prefix_hits > 0
    want = {r.uid: np.asarray(r.final_hidden) for r in je.finished}
    for r in pe.finished:
        _close(r.final_hidden, want[r.uid], msg=f"uid {r.uid}")
        lp = ph.logits(torch.from_numpy(np.asarray(r.final_hidden)[None]))
        lj = np.asarray(jh.logits(jnp.asarray(want[r.uid])[None]))
        assert int(lp.argmax()) == int(lj.argmax()), r.uid


@pytest.mark.parametrize("T", [1, 8, 16, 40])
def test_moe_takes_any_token_count(pair, T):
    """Each T re-derives the capacity; the routed FFN's output agrees with
    JAX's at every T (JAX's test_moe_layer_accepts_any_token_count)."""
    jm, _, pm, _, _ = pair
    x = (np.random.default_rng(T).standard_normal((T, H)) * 0.1).astype(
        np.float16)
    want = np.asarray(jm.layers[0].moe.forward(jnp.asarray(x)), np.float32)
    got = pm.layers[0].mlp_forward(torch.from_numpy(x))
    assert tuple(got.shape) == (T, H) and torch.isfinite(got).all()
    assert pm.layers[0].moe.capacity_for(T) == moe_capacity(
        pm.layers[0].moe.cfg, T)
    _close(got, want)


def test_zero_rows_do_not_consume_expert_capacity(pair):
    """A real token batched with zero pad rows gets its solo output; the
    pad rows stay zero (JAX's test_mixtral.py:83)."""
    jm, _, pm, _, _ = pair
    moe = pm.layers[0].moe
    real = (np.random.default_rng(12).standard_normal((1, H)) * 0.1).astype(
        np.float16)
    solo = moe(torch.from_numpy(real)).float()
    padded = np.zeros((32, H), np.float16)
    padded[31] = real[0]
    batched = moe(torch.from_numpy(padded)).float()
    assert torch.allclose(batched[31], solo[0], rtol=1e-3, atol=1e-5)
    assert not batched[:31].any()
    want = np.asarray(jm.layers[0].moe.forward(jnp.asarray(padded)),
                      np.float32)
    _close(batched, want)


def _forward(model, seed=9):
    x = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (1, 8, H)) * 0.1).astype(np.float16))
    return model(x, torch.arange(8)[None])


def test_state_dict_round_trip(pair):
    """The state dict carries the experts under JAX's names and loads
    into a model drawn from another seed, which then computes the same
    bits."""
    _, _, pm, _, _ = pair
    sd = pm.state_dict()
    assert "layers.1.moe.router" in sd
    assert "layers.0.moe.expert_3.down.scales" in sd
    assert "layers.0.q_qweight" in sd and "layers.0.gate_qweight" not in sd
    other = QuantMixtral(MixtralConfig(**CFG), device="cpu", seed=7,
                         opt_m=OPT_M, moe_tokens=16)
    assert not torch.equal(_forward(other), _forward(pm))
    other.load_state_dict(sd)
    assert torch.equal(_forward(other), _forward(pm))
    with pytest.raises(RuntimeError, match="expert_0"):
        other.load_state_dict({k: v for k, v in sd.items()
                               if "expert_0.up" not in k})


def test_checkpoint_round_trip(pair, tmp_path):
    """save_quant_state / load_quant_state carry a Mixtral state dict,
    every expert bundle included, bit for bit (JAX's
    test_mixtral_checkpoint_module_roundtrip)."""
    _, _, pm, _, _ = pair
    save_quant_state(str(tmp_path / "mix"), pm.state_dict())
    back = load_quant_state(str(tmp_path / "mix"), device="cpu")
    assert set(back) == set(pm.state_dict())
    other = QuantMixtral(MixtralConfig(**CFG), device="cpu", seed=5,
                         opt_m=OPT_M, moe_tokens=16)
    other.load_state_dict(back)
    assert torch.equal(_forward(other), _forward(pm))


def test_llama_path_unchanged_by_the_hook(monkeypatch):
    """A Llama layer still runs its three SwiGLU projections (no
    `mlp_forward`), bit for bit as before the hook, with 7 projection
    calls a layer; a Mixtral layer runs 4 and 3 a expert."""
    cfg = LlamaConfig(hidden_size=H, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, num_layers=2, vocab_size=V)
    llama = QuantLlama(cfg, device="cpu", seed=3)
    layer = llama.layers[0]
    assert not hasattr(layer, "mlp_forward")
    assert [p[0] for p in layer.PROJS] == ["q", "k", "v", "o", "gate", "up",
                                           "down"]
    h = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (2, 5, H)) * 0.3).astype(np.float16))
    g, u = layer.proj("gate", h), layer.proj("up", h)
    want = layer.proj("down", (torch.nn.functional.silu(g.float())
                               * u.float()).to(h.dtype))
    assert torch.equal(pql._layer_mlp(layer, h), want)
    calls = []
    forward = Matmul.forward

    def counting(op, A, *a, **kw):
        calls.append(op.config.N)
        return forward(op, A, *a, **kw)

    monkeypatch.setattr(Matmul, "forward", counting)
    _forward(llama)
    assert len(calls) == 7 * cfg.num_layers
    calls.clear()
    mix = QuantMixtral(MixtralConfig(**CFG), device="cpu", opt_m=OPT_M,
                       moe_tokens=16)
    _forward(mix)
    assert len(calls) == (4 + 3 * CFG["n_experts"]) * CFG["num_layers"]


"""bitblas_tpu_torch.models.speculative against the JAX package's on the
CPU.

- A stub LM (logits of each position from a fixed seeded table indexed by
  the token and the one before it; a draft's table is the target's plus
  noise) fed to both packages: `speculative_generate` gives identical
  tokens and SpecStats, greedy and at temperature 0.8, over seeds,
  gammas and EOS placements; `_accept` the same decisions and leaves the
  generator in the same state. The host logic is numpy on float32 rows
  in both, so equality is exact.
- JAX's two-layer target / draft pair (tests/test_speculative.py: one
  trunk, two lm_heads) carried across with `convert.from_jax_state`:
  greedy speculation, uncached and cached, equals the port's `generate`
  and JAX's `generate` token for token; a perfect draft accepts
  everything in at most 3 target calls (JAX's pin); rounds sum to the
  tokens; gamma is validated; sampled runs repeat under a seed; a
  Mixtral target (models/quant_moe) speculates its own greedy stream.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.models import speculative as jspec

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.models import speculative as pspec
from bitblas_tpu_torch.models.hf_import import LMHead, QuantLlamaLM
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.models.quant_moe import MixtralConfig, QuantMixtral

V, H = 64, 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=4,
           num_kv_heads=2, num_layers=2, vocab_size=V, group_size=128)
STUB_V = 24


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


class StubLM:
    """tokens [1, S] (a JAX array or a torch tensor) -> logits [1, S, V]
    float32: position i's row is table[tokens[i - 1], tokens[i]]."""

    def __init__(self, table: np.ndarray):
        self.table = table

    def __call__(self, ids):
        t = np.asarray(ids).reshape(-1).astype(np.int64)
        prev = np.concatenate([[0], t[:-1]])
        return self.table[prev, t][None]


def _stub_pair(seed: int, noise: float):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((STUB_V, STUB_V, STUB_V)).astype(np.float32)
    draft = table + noise * rng.standard_normal(table.shape).astype(
        np.float32)
    return StubLM(table), StubLM(draft)


def _stats(s) -> tuple:
    return (s.proposed, s.accepted, s.target_calls, s.draft_calls, s.tokens,
            tuple(s.rounds), s.acceptance_rate)


@pytest.mark.parametrize("eos", [None, 5])
@pytest.mark.parametrize("gamma", [1, 3, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("seed", [0, 1])
def test_stub_matches_jax(seed, temperature, gamma, eos):
    target, draft = _stub_pair(seed, noise=0.7)
    prompt = np.arange(3, dtype=np.int32) + seed
    kw = dict(max_new_tokens=17, gamma=gamma, temperature=temperature,
              eos_token_id=eos, seed=seed + 7, return_stats=True)
    want, ws = jspec.speculative_generate(target, draft, prompt, **kw)
    got, gs = pspec.speculative_generate(target, draft, prompt, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert _stats(gs) == _stats(ws)
    assert sum(gs.rounds) == gs.tokens


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_accept_matches_jax(temperature):
    rng = np.random.default_rng(3)
    for trial in range(20):
        g = 1 + trial % 5
        tgt = rng.standard_normal((g + 1, STUB_V)).astype(np.float32)
        proposal = [int(t) for t in rng.integers(0, STUB_V, g)]
        probs = [None if temperature <= 0 else jspec._softmax(
            rng.standard_normal(STUB_V).astype(np.float32), temperature)
            for _ in range(g)]
        jr, pr = (np.random.default_rng(trial) for _ in range(2))
        assert pspec._accept(proposal, tgt, probs, temperature, pr) == \
            jspec._accept(proposal, tgt, probs, temperature, jr)
        assert pr.random() == jr.random()


def _heads(seed):
    rng = np.random.default_rng(seed)
    embed = (np.random.default_rng(0).standard_normal((V, H))
             * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, H)) * 0.05).astype(np.float32)
    return embed, lm_head


@pytest.fixture(scope="module")
def models():
    """JAX's target / draft (one trunk, lm_heads from seeds 0 and 5) and
    the port's, carried across."""
    jm = JaxQuantLlama(JaxLlamaConfig(**CFG), opt_m=(1, 16))
    cfg = LlamaConfig(**CFG)
    pm = QuantLlama(cfg, device="cpu", seed=123)
    pm.load_state_dict(from_jax_state(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jm.state_dict().items()}, cfg))
    out = {}
    for name, seed in (("target", 0), ("draft", 5)):
        embed, lm_head = _heads(seed)
        out["jax_" + name] = JaxQuantLlamaLM(jm, JaxLMHead(
            embed=jnp.asarray(embed), final_norm=jnp.ones((H,), jnp.float32),
            lm_head=jnp.asarray(lm_head)))
        out[name] = QuantLlamaLM(pm, LMHead(embed, np.ones(H, np.float32),
                                            lm_head, device="cpu"))
    return out


def test_greedy_equals_generate_and_jax(models):
    target, draft = models["target"], models["draft"]
    prompt = np.arange(5, dtype=np.int32)
    ref = target.generate(prompt, max_new_tokens=7)
    np.testing.assert_array_equal(
        ref, models["jax_target"].generate(prompt, max_new_tokens=7))
    for fn in (pspec.speculative_generate, pspec.speculative_generate_cached):
        out, stats = fn(target, draft, prompt, max_new_tokens=7, gamma=3,
                        return_stats=True)
        np.testing.assert_array_equal(out, ref)
        assert stats.tokens == 7 and sum(stats.rounds) == 7
        assert stats.target_calls >= 2


@pytest.mark.parametrize("cached", [False, True])
def test_perfect_draft_accepts_everything(models, cached):
    target = models["target"]
    fn = (pspec.speculative_generate_cached if cached
          else pspec.speculative_generate)
    prompt = np.arange(6, dtype=np.int32)
    out, stats = fn(target, target, prompt, max_new_tokens=8, gamma=4,
                    return_stats=True)
    np.testing.assert_array_equal(out, target.generate(prompt,
                                                       max_new_tokens=8))
    assert stats.acceptance_rate == 1.0
    assert stats.target_calls <= 3


def test_eos_and_rounds(models):
    target = models["target"]
    prompt = np.arange(6, dtype=np.int32)
    full = pspec.speculative_generate_cached(target, target, prompt,
                                             max_new_tokens=8)
    eos = int(full[7])
    out, stats = pspec.speculative_generate_cached(
        target, target, prompt, max_new_tokens=8, eos_token_id=eos,
        return_stats=True)
    stop = 6 + list(full[6:]).index(eos) + 1
    np.testing.assert_array_equal(out, full[:stop])
    assert sum(stats.rounds) == stats.tokens == stop - 6


def test_gamma_and_prompt_validation(models):
    target = models["target"]
    for fn in (pspec.speculative_generate, pspec.speculative_generate_cached):
        with pytest.raises(ValueError, match="gamma"):
            fn(target, target, np.arange(3), gamma=0)
        with pytest.raises(ValueError, match="prompt"):
            fn(target, target, np.zeros(0, np.int32))


def test_sampled_runs_repeat_under_a_seed(models):
    target, draft = models["target"], models["draft"]
    prompt = np.arange(4, dtype=np.int32)
    for fn in (pspec.speculative_generate, pspec.speculative_generate_cached):
        a = fn(target, draft, prompt, max_new_tokens=6, gamma=3,
               temperature=0.8, seed=9)
        b = fn(target, draft, prompt, max_new_tokens=6, gamma=3,
               temperature=0.8, seed=9)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (10,) and a.min() >= 0 and a.max() < V


def test_mixtral_target(models):
    """A two-layer Mixtral (4 experts top-2) as the target, the Llama
    draft proposing: cached speculation gives the Mixtral's own greedy
    stream."""
    cfg = MixtralConfig(**CFG, n_experts=4, top_k=2, capacity_factor=2.0)
    mix = QuantMixtral(cfg, device="cpu", seed=3, opt_m=(1, 4, 8, 16),
                       moe_tokens=16)
    target = QuantLlamaLM(mix, models["target"].head)
    prompt = np.arange(5, dtype=np.int32)
    out, stats = pspec.speculative_generate_cached(
        target, models["draft"], prompt, max_new_tokens=6, gamma=2,
        return_stats=True)
    np.testing.assert_array_equal(out, target.generate(prompt,
                                                       max_new_tokens=6))
    assert stats.tokens == 6

"""The port's serving slice against the JAX package, on the CPU.

Fixture: hidden 256, 2 heads / 1 KV head (head dim 128, so both flash
paths are live), 2 layers, vocab 64. The JAX model's random weights are
carried across with `convert.from_jax_state`; both packages then run the
same numbers. The JAX side runs its Pallas kernels in interpret mode, the
port its kernels' plain versions.

Tolerances: activations are f16 in both; the JAX dequant kernel applies
scales to its f32 accumulator where the port rounds (q - z) * s to f16
(2^-11 relative per weight), and the flash kernels round P differently.
After 2 layers hidden states (|.| < 4) and logits (|.| < 3) agree to
~1e-3; atol 1e-2 bounds that with margin.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.models import quant_llama as jql
from bitblas_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bitblas_tpu.serving import Request as JaxRequest
from bitblas_tpu.serving import \
    TokenContinuousBatchingEngine as JaxTokenEngine
from bitblas_tpu.serving import kv_cache as jkv

import bitblas_tpu_torch.models.quant_llama as pql
from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.models.hf_import import LMHead, QuantLlamaLM
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.serving.engine import (ContinuousBatchingEngine,
                                              Request,
                                              TokenContinuousBatchingEngine)
from bitblas_tpu_torch.testing import assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file. The tier-1 command runs
    six workers on eight cores, and torch's eight-thread pool then spins
    against the other workers: this file's small CPU ops took several
    times their time alone there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

V, H = 64, 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=2,
           num_kv_heads=1, num_layers=2, vocab_size=V, group_size=128)
ATOL = 1e-2


def _synchronous(engine):
    """A JAX engine whose decode steps finish before they return. The JAX
    engines hand host numpy arrays (lengths, block tables) to an
    asynchronously dispatched step and then update those arrays in place;
    on the CPU jnp.asarray may alias the numpy buffer, so a step still
    queued can read the next step's lengths. Its results then moved by up
    to 1.9e-2 between processes, depending on what ran before."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


@pytest.fixture(scope="module")
def pair():
    jm = JaxQuantLlama(JaxLlamaConfig(**CFG), opt_m=(1, 2, 16))
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V, H)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, H)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((H,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = LlamaConfig(**CFG)
    pm = QuantLlama(cfg, device="cpu", seed=123)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(from_jax_state(state, cfg))
    ph = LMHead(embed, np.ones(H, np.float32), lm_head, device="cpu")
    return jm, jh, pm, ph, embed


def test_convert_carries_the_weights_across(pair):
    jm, _, pm, _, _ = pair
    x = np.random.default_rng(1).standard_normal((3, H)).astype(np.float16)
    for jl, pl in zip(jm.layers, pm.layers):
        for name in ("q", "k", "o", "gate", "down"):
            width = 512 if name == "down" else H
            xi = np.resize(x, (3, width)).astype(np.float16)
            want = np.asarray(jl.proj(name, jnp.asarray(xi)))
            got = pl.proj(name, torch.from_numpy(xi))
            assert_close(got, want, rtol=1e-2, atol=ATOL,
                         max_mismatched_ratio=0.0, msg=name)
        assert np.array_equal(pl.attn_norm.numpy(), np.asarray(jl.attn_norm))


def test_prefill_logits_and_decode_steps_match(pair, monkeypatch):
    jm, jh, pm, ph, embed = pair
    calls = []
    flash = pql.flash_attention_fwd

    def counting_flash(q, k, v, *a, **kw):
        calls.append(q.shape)
        return flash(q, k, v, *a, **kw)

    monkeypatch.setattr(pql, "flash_attention_fwd", counting_flash)
    S, bucket = 200, 256
    toks = np.random.default_rng(2).integers(0, V, S)
    x = np.zeros((1, bucket, H), np.float16)
    x[0, :S] = embed[toks]
    pos = np.arange(bucket)[None]
    jhid, jks, jvs = jm.make_prefill(bucket)(jnp.asarray(x),
                                            jnp.asarray(pos))
    phid, pks, pvs = pm.make_prefill(bucket)(torch.from_numpy(x),
                                            torch.from_numpy(pos))
    assert len(calls) == CFG["num_layers"]            # flash was on
    assert_close(ph.logits(phid[:, :S]), np.asarray(jh.logits(jhid[:, :S])),
                 rtol=0.0, atol=ATOL, max_mismatched_ratio=0.0)

    # teacher-forced decode steps from the prefilled caches
    L, lmax = CFG["num_layers"], bucket + 4
    jk = jnp.zeros((L, 1, lmax, 1, 128), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([k[:S] for k in jks]).astype(jnp.bfloat16))
    jv = jnp.zeros((L, 1, lmax, 1, 128), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([v[:S] for v in jvs]).astype(jnp.bfloat16))
    pk = torch.zeros((L, 1, lmax, 1, 128), dtype=torch.bfloat16)
    pv = torch.zeros_like(pk)
    pk[:, 0, :S] = torch.stack([k[:S] for k in pks]).to(torch.bfloat16)
    pv[:, 0, :S] = torch.stack([v[:S] for v in pvs]).to(torch.bfloat16)
    slots = np.zeros((1,), np.int32)
    for i, tok in enumerate((3, 17, 42)):
        xi = embed[[[tok]]]
        lengths = np.array([S + i], np.int32)
        jh_i, jk, jv = jm.decode_step(jnp.asarray(xi), jk, jv,
                                      jnp.asarray(slots),
                                      jnp.asarray(lengths))
        ph_i, pk, pv = pm.decode_step(torch.from_numpy(xi), pk, pv,
                                      torch.from_numpy(slots),
                                      torch.from_numpy(lengths))
        assert_close(ph_i, np.asarray(jh_i), rtol=0.0, atol=ATOL,
                     max_mismatched_ratio=0.0, msg=f"step {i}")


def test_lm_logits_match_jax(pair):
    jm, jh, pm, ph, _ = pair
    toks = np.random.default_rng(6).integers(0, V, (2, 12))
    want = np.asarray(JaxQuantLlamaLM(jm, jh)(jnp.asarray(toks)))
    got = QuantLlamaLM(pm, ph)(toks)
    assert tuple(got.shape) == (2, 12, V)
    assert_close(got, want, rtol=0.0, atol=ATOL, max_mismatched_ratio=0.0)


def test_hidden_state_engine_matches_jax(pair):
    jm, _, pm, _, _ = pair
    rng = np.random.default_rng(5)
    prompts = [(rng.standard_normal((n, H)) * 0.05).astype(np.float16)
               for n in (9, 30)]
    je = _synchronous(JaxEngine(jm, num_slots=2, max_seq_len=64))
    pe = ContinuousBatchingEngine(pm, num_slots=2, max_seq_len=64)
    for i, p in enumerate(prompts):
        je.submit(JaxRequest(uid=i, prompt=p, max_new=3))
        pe.submit(Request(uid=i, prompt=p, max_new=3))
    want = {r.uid: r.final_hidden for r in je.run_to_completion()}
    got = {r.uid: r.final_hidden for r in pe.run_to_completion()}
    assert sorted(got) == [0, 1]
    for uid in got:
        assert_close(got[uid], want[uid], rtol=0.0, atol=ATOL,
                     max_mismatched_ratio=0.0)


@pytest.mark.parametrize("D", [128, 64])
def test_kv_cache_ops_match_jax(D):
    """D=128 attends through flash decode, D=64 through the plain gather
    (the JAX routing rule D % 128 == 0)."""
    rng = np.random.default_rng(4)
    kw = dict(num_slots=3, max_seq_len=64, num_kv_heads=2, head_dim=D,
              num_layers=2)
    jc = jkv.init_kv_cache(jkv.KVCacheConfig(**kw))
    pc = pkv.init_kv_cache(pkv.KVCacheConfig(**kw), device="cpu")
    S = 20
    kp, vp = (torch.from_numpy(rng.standard_normal((S, 2, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    jc = jkv.write_prompt(jc, 1, 2, jnp.asarray(kp.float().numpy(),
                                                jnp.bfloat16),
                          jnp.asarray(vp.float().numpy(), jnp.bfloat16))
    pkv.write_prompt(pc, 1, 2, kp, vp)
    assert np.array_equal(np.asarray(jc["k"], np.float32),
                          pc["k"].float().numpy())
    slots = np.array([2, 0], np.int32)
    pos = np.array([S, 0], np.int32)
    kn, vn = (rng.standard_normal((2, 2, D)).astype(np.float32)
              for _ in range(2))
    jk, jv = jkv.append_token(jc["k"][1], jc["v"][1], jnp.asarray(slots),
                              jnp.asarray(pos), jnp.asarray(kn),
                              jnp.asarray(vn))
    pk, pv = pkv.append_token(pc["k"][1], pc["v"][1],
                              torch.from_numpy(slots), torch.from_numpy(pos),
                              torch.from_numpy(kn), torch.from_numpy(vn))
    assert pk.data_ptr() == pc["k"][1].data_ptr()          # in place
    assert np.array_equal(np.asarray(jv, np.float32),
                          pc["v"][1].float().numpy())
    q = rng.standard_normal((2, 4, D)).astype(np.float16)
    lengths = pos + 1
    want = jkv.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(slots),
                                jnp.asarray(lengths), num_heads=4)
    got = pkv.decode_attention(torch.from_numpy(q), pk, pv,
                               torch.from_numpy(slots),
                               torch.from_numpy(lengths), num_heads=4)
    assert_close(got, np.asarray(want), rtol=0.0, atol=4e-3,
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_matches_jax(scaled):
    D = 128
    theta = 10000.0
    if scaled:
        scaling = {"rope_type": "llama3", "factor": 8.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 8192}
        theta = pql.llama3_scaled_freqs(500000.0, D, scaling)
        assert np.array_equal(
            theta, jql.llama3_scaled_freqs(500000.0, D, scaling))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float16)
    pos = np.stack([np.arange(5), np.arange(600, 605)])
    want = np.asarray(jql.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = pql.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # f32 angles (positions up to 604 rad) rounded to f16 outputs
    assert_close(got, want, rtol=0.0, atol=4e-3, max_mismatched_ratio=0.0)


def test_token_engine_greedy_tokens_match_jax(pair):
    _token_engines_agree(pair)


def test_token_engine_kv_quant_greedy_tokens_match_jax(pair):
    """The int8-KV token engine (decode through flash_decode_quant's
    plain version) against the JAX int8 token engine (its Pallas kernel
    in interpret mode)."""
    pe = _token_engines_agree(pair, kv_quant=True)
    assert pe.caches_k.dtype == torch.int8
    assert pe.scales_k.dtype == torch.float32


def _token_engines_agree(pair, **kw):
    jm, jh, pm, ph, _ = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (150, 40)]
    je = _synchronous(JaxTokenEngine(jm, jh, num_slots=2, max_seq_len=512,
                                     **kw))
    pe = TokenContinuousBatchingEngine(pm, ph, num_slots=2, max_seq_len=512,
                                       **kw)
    jr = [je.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    pr = [pe.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    je.run_to_completion()
    pe.run_to_completion()
    for a, b in zip(jr, pr):
        assert b.done and len(b.out_tokens) == 5
        assert b.out_tokens == a.out_tokens, b.uid
    return pe


def test_generate_matches_the_engine(pair):
    _, _, pm, ph, _ = pair
    prompt = np.arange(7, dtype=np.int32)
    solo = QuantLlamaLM(pm, ph).generate(prompt, max_new_tokens=4)
    eng = TokenContinuousBatchingEngine(pm, ph, num_slots=2, max_seq_len=64)
    req = eng.submit_tokens(uid=0, tokens=prompt, max_new=4)
    eng.run_to_completion()
    assert req.out_tokens == list(solo[7:])


@pytest.mark.parametrize("kw", [{"kv_ring": True, "prefill_chunk": 16},
                                {"kv_ring": True}])
def test_unported_engine_options_raise(pair, kw):
    """The ring cache needs a sliding window (this fixture has none) and
    chunked prefill, as JAX's engine checks (prefill_chunk and kv_ring
    themselves are ported: tests/test_torch_chunk_ring.py)."""
    _, _, pm, _, _ = pair
    with pytest.raises(ValueError, match="sliding_window"):
        ContinuousBatchingEngine(pm, num_slots=1, max_seq_len=32, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import bitblas_tpu_torch\n"
        "for m in pkgutil.walk_packages(bitblas_tpu_torch.__path__,"
        " 'bitblas_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bitblas_tpu' or m.startswith('bitblas_tpu.')]\n"
        "assert not bad, bad\n"
        "new = ['ops.' + m for m in ('matmul_splitk', 'batch_matmul',"
        " 'conv2d', 'ladder_permutate', 'lop3_permutate',"
        " 'quant_compress')] + ['utils.timing', 'parallel',"
        " 'parallel.layers', 'parallel.serving', 'parallel.moe',"
        " 'parallel.pipeline', 'testing.dist', 'testing.ranks']\n"
        "missing = [m for m in new if 'bitblas_tpu_torch.' + m"
        " not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('bitblas_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(**CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantLlama(cfg)
    with pytest.raises(RuntimeError):
        LMHead(np.zeros((V, H)), np.ones(H), np.zeros((V, H)))

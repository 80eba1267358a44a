"""A bfloat16 model (LlamaConfig(act_dtype="bfloat16")) in the port
against the JAX package, on the CPU.

Fixture: hidden 256, 2 heads / 1 KV head (head dim 128, so the flash
prefill and decode paths are live), 2 layers, group 128, vocab 64; the
JAX model's weights carried across with `convert.from_jax_state`. The
JAX side runs its Pallas kernels in interpret mode, the port its
kernels' plain versions.

The types are JAX's: the engines feed float16 hidden states, each
projection casts its activation to bfloat16 and returns bfloat16, so the
first residual add promotes the hidden state to float32; the K/V caches
hold bfloat16 (or int8), the attention runs on bfloat16 queries, and the
engines keep float16 hidden buffers.

Tolerances come from bfloat16's rounding, 2^-8 of a value. Logits of
|.| < 3 after 2 layers: one bfloat16 rounding of the largest, 3 * 2^-8 ~
1.2e-2 absolute (measured ~2e-3: the two packages round the same
bfloat16 operands, apart from the scales, which the port holds in
bfloat16 and JAX's kernel in float32). Hidden states (|.| < 0.5): 2^-8
absolute. A projection's output (|.| < 1.5): 1.5 * 2^-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.serving import PagedContinuousBatchingEngine as JaxPaged
from bitblas_tpu.serving import Request as JaxRequest
from bitblas_tpu.serving import \
    TokenContinuousBatchingEngine as JaxTokenEngine

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.models.hf_import import LMHead
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving.engine import (PagedContinuousBatchingEngine,
                                              Request,
                                              TokenContinuousBatchingEngine)
from bitblas_tpu_torch.testing import assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file. The tier-1 command runs
    six workers on eight cores, and torch's eight-thread pool then spins
    against the other workers: this file's small CPU ops took minutes
    there (the ring tests: 24 s in six concurrent runs with one thread,
    647 s with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, H = 64, 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=2,
           num_kv_heads=1, num_layers=2, vocab_size=V, group_size=128,
           act_dtype="bfloat16")
BF16 = 2.0 ** -8
LOGIT_ATOL = 3 * BF16
HIDDEN_ATOL = BF16
PROJ_ATOL = 1.5 * BF16


def _synchronous(engine):
    """A JAX engine whose decode steps finish before they return (see
    tests/test_torch_serving.py: its host arrays are updated in place)."""
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


@pytest.mark.parametrize("a_dtype", ["float16", "float32", "bfloat16"])
def test_bf16_projection_takes_any_float_activation(pair, a_dtype):
    """A bfloat16 layer's projections take what the model feeds them
    (float16 inputs, the float32 residual stream) and return bfloat16, as
    JAX's do; kernel 1's plain version decodes uint4 x bfloat16."""
    jm, _, pm, _, _ = pair
    x = np.random.default_rng(1).standard_normal((3, H)).astype(np.float32)
    jx = jnp.asarray(x, a_dtype)
    px = torch.from_numpy(x).to(getattr(torch, a_dtype))
    assert pm.layers[0].q_scales.dtype == torch.bfloat16
    for name in ("q", "k", "gate"):
        want = jm.layers[0].proj(name, jx)
        got = pm.layers[0].proj(name, px)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert_close(got, np.asarray(want, np.float32), rtol=0.0,
                     atol=PROJ_ATOL, max_mismatched_ratio=0.0, msg=name)


def test_bf16_prefill_and_decode_steps_match_jax(pair):
    """Prefill at bucket 256 (the flash kernel's plain version on bfloat16
    Q/K/V), then teacher-forced decode steps over bfloat16 caches: the
    hidden states come back float32 in both, the K/V bfloat16."""
    jm, jh, pm, ph, embed = pair
    S, bucket = 200, 256
    toks = np.random.default_rng(2).integers(0, V, S)
    x = np.zeros((1, bucket, H), np.float16)
    x[0, :S] = embed[toks]
    pos = np.arange(bucket)[None]
    jhid, jks, jvs = jm.make_prefill(bucket)(jnp.asarray(x),
                                            jnp.asarray(pos))
    phid, pks, pvs = pm.make_prefill(bucket)(torch.from_numpy(x),
                                            torch.from_numpy(pos))
    assert jhid.dtype == jnp.float32 and phid.dtype == torch.float32
    assert jks[0].dtype == jnp.bfloat16 and pks[0].dtype == torch.bfloat16
    assert_close(phid, np.asarray(jhid), rtol=0.0, atol=HIDDEN_ATOL,
                 max_mismatched_ratio=0.0)
    assert_close(ph.logits(phid[:, :S]), np.asarray(jh.logits(jhid[:, :S])),
                 rtol=0.0, atol=LOGIT_ATOL, max_mismatched_ratio=0.0)

    L, lmax = CFG["num_layers"], bucket + 4
    jk = jnp.zeros((L, 1, lmax, 1, 128), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([k[:S] for k in jks]))
    jv = jnp.zeros((L, 1, lmax, 1, 128), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([v[:S] for v in jvs]))
    pk = torch.zeros((L, 1, lmax, 1, 128), dtype=torch.bfloat16)
    pv = torch.zeros_like(pk)
    pk[:, 0, :S] = torch.stack([k[:S] for k in pks])
    pv[:, 0, :S] = torch.stack([v[:S] for v in pvs])
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
        assert ph_i.dtype == torch.float32 and jh_i.dtype == jnp.float32
        assert_close(ph.logits(ph_i),
                     np.asarray(jh.logits(jh_i)), rtol=0.0, atol=LOGIT_ATOL,
                     max_mismatched_ratio=0.0, msg=f"step {i}")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bf16_token_engine_matches_jax(pair, kv_quant):
    """The token engine on a bfloat16 model, bfloat16 or int8 KV (prompts
    in buckets 64 and 16; the prefill test above takes the flash path):
    the same greedy tokens as JAX's, final hidden states within 2^-8, the
    hidden buffer float16 as JAX keeps it."""
    jm, jh, pm, ph, _ = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (40, 9)]
    je = _synchronous(JaxTokenEngine(jm, jh, num_slots=2, max_seq_len=64,
                                     kv_quant=kv_quant))
    pe = TokenContinuousBatchingEngine(pm, ph, num_slots=2, max_seq_len=64,
                                       kv_quant=kv_quant)
    assert pe.last_hidden.dtype == torch.float16
    assert pe.caches_k.dtype == (torch.int8 if kv_quant else torch.bfloat16)
    jr = [je.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    pr = [pe.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    je.run_to_completion()
    pe.run_to_completion()
    for a, b in zip(jr, pr):
        assert b.done and len(b.out_tokens) == 5
        assert b.out_tokens == a.out_tokens, b.uid
        assert_close(b.final_hidden, np.asarray(a.final_hidden, np.float32),
                     rtol=0.0, atol=HIDDEN_ATOL, max_mismatched_ratio=0.0)


def test_bf16_paged_engine_matches_jax(pair):
    """The paged engine on a bfloat16 model over the bfloat16 pool: final
    hidden states within 2^-8 of JAX's."""
    jm, _, pm, _, _ = pair
    rng = np.random.default_rng(6)
    prompts = [(rng.standard_normal((n, H)) * 0.05).astype(np.float16)
               for n in (20, 37)]
    kw = dict(num_slots=2, num_blocks=16, block_size=16,
              max_blocks_per_slot=4)
    je = _synchronous(JaxPaged(jm, **kw))
    pe = PagedContinuousBatchingEngine(pm, **kw)
    for i, p in enumerate(prompts):
        je.submit(JaxRequest(uid=i, prompt=p, max_new=4))
        pe.submit(Request(uid=i, prompt=p, max_new=4))
    want = {r.uid: r.final_hidden for r in je.run_to_completion()}
    got = {r.uid: r.final_hidden for r in pe.run_to_completion()}
    assert sorted(got) == [0, 1]
    for uid in got:
        assert_close(got[uid], np.asarray(want[uid], np.float32), rtol=0.0,
                     atol=HIDDEN_ATOL, max_mismatched_ratio=0.0)


def test_bf16_linear_repacks_gptq_in_bf16():
    """A GPTQ bundle repacked into a bfloat16 Linear keeps its scales and
    zeros in bfloat16 (the type kernel 1 takes for uint4 x bfloat16) and
    computes what JAX's bfloat16 Linear computes from the same bundle:
    within four bfloat16 roundings (2^-8) of the largest output (the
    port rounds the float16 scales to bfloat16, JAX's kernel keeps them
    in float32; both round the output)."""
    import types

    from bitblas_tpu import Linear as JaxLinear
    from bitblas_tpu.quantization import packing as jpack
    from bitblas_tpu_torch.module import Linear
    K = N = 256
    rng = np.random.default_rng(11)
    qw, qz, sc = jpack.pack_autogptq(
        rng.integers(0, 16, (K, N)), rng.integers(1, 15, (K // 64, N)),
        (rng.standard_normal((K // 64, N)) * 0.01 + 0.03).astype(np.float16),
        4)
    kw = dict(bias=False, A_dtype="bfloat16", W_dtype="uint4",
              with_scaling=True, with_zeros=True, zeros_mode="original",
              group_size=64, out_dtype="bfloat16", opt_M=[1, 16],
              enable_tuning=False)
    stub = types.SimpleNamespace(qweight=qw, qzeros=qz, scales=sc, bias=None)
    jl = JaxLinear(K, N, **kw)
    jl.repack_from_gptq(stub)
    pl = Linear(K, N, device="cpu", **kw)
    pl.repack_from_gptq(types.SimpleNamespace(
        qweight=torch.from_numpy(qw), qzeros=torch.from_numpy(qz),
        scales=torch.from_numpy(sc), bias=None))
    assert pl.scales.dtype == torch.bfloat16
    assert pl.zeros.dtype == torch.bfloat16
    A = rng.standard_normal((4, K)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(A, jnp.bfloat16)), np.float32)
    got = pl(torch.from_numpy(A).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, rtol=0.0, atol=4 * BF16 * abs(want).max(),
                 max_mismatched_ratio=0.0)

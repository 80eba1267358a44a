"""The port's DataParallelEngineGroup (serving/engine.py: a host router
over replica engines) against the JAX package's, on the CPU.

Fixtures: JAX's tests/test_token_engine.py model (hidden 256, 4 heads /
2 KV heads, 2 layers, vocab 64) with its weights carried across by
`convert.from_jax_state`, and tests/test_quant_kv_cache.py's mixed group
(a float and an int8-cache replica). The routing is host code on both
sides, so the replica each request lands on is held exactly; the greedy
tokens equal JAX's group's and each request's solo generation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.serving import DataParallelEngineGroup as JaxGroup
from bitblas_tpu.serving import TokenContinuousBatchingEngine as JaxTokenEngine

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.models.hf_import import LMHead, QuantLlamaLM
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving.engine import (ContinuousBatchingEngine,
                                              DataParallelEngineGroup,
                                              Request,
                                              TokenContinuousBatchingEngine)

V, H = 64, 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=4, num_kv_heads=2,
           num_layers=2, vocab_size=V, group_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread (the tier-1 command runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lms():
    jm = JaxQuantLlama(JaxLlamaConfig(**CFG), opt_m=(1, 4, 16))
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V, H)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, H)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((H,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = LlamaConfig(**CFG)
    pm = QuantLlama(cfg, device="cpu")
    pm.load_state_dict(from_jax_state(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jm.state_dict().items()}, cfg))
    ph = LMHead(embed, np.ones(H, np.float32), lm_head, device="cpu")
    return JaxQuantLlamaLM(jm, jh), QuantLlamaLM(pm, ph)


def _prompts():
    rng = np.random.default_rng(15)
    return [rng.integers(0, V, n).astype(np.int32) for n in (4, 6, 5, 7)]


def test_dp_group_of_token_engines(lms):
    """Token requests routed over two replicas: each stream equals its
    solo generation and JAX's group's, on the same replica."""
    jlm, plm = lms
    prompts = _prompts()
    solos = [plm.generate(p, max_new_tokens=3)[len(p):] for p in prompts]
    group = DataParallelEngineGroup([
        TokenContinuousBatchingEngine(plm.model, plm.head, num_slots=4,
                                      max_seq_len=64) for _ in range(2)])
    reqs = [group.submit_tokens(uid=i, tokens=p, max_new=3)
            for i, p in enumerate(prompts)]
    group.run_to_completion()
    jgroup = JaxGroup([
        JaxTokenEngine(jlm.model, jlm.head, num_slots=4, max_seq_len=64)
        for _ in range(2)])
    jreqs = [jgroup.submit_tokens(uid=i, tokens=p, max_new=3)
             for i, p in enumerate(prompts)]
    jgroup.run_to_completion()
    for req, jreq, solo in zip(reqs, jreqs, solos):
        assert req.done
        assert req.out_tokens == list(solo), req.uid
        assert req.out_tokens == [int(t) for t in jreq.out_tokens], req.uid
    # the same replica took each request on both sides
    where = [[r.uid for r in e.finished] for e in group.engines]
    jwhere = [[r.uid for r in e.finished] for e in jgroup.engines]
    assert sorted(map(sorted, where)) == sorted(map(sorted, jwhere))
    assert all(where)


def test_dp_group_mixed_replicas():
    """A float and an int8-cache replica behind one router: six requests
    balanced over both, all complete with finite hidden states (JAX's
    test_data_parallel_engine_group)."""
    model = QuantLlama(LlamaConfig(**CFG), device="cpu", seed=1)
    group = DataParallelEngineGroup([
        ContinuousBatchingEngine(model, num_slots=2, max_seq_len=32),
        ContinuousBatchingEngine(model, num_slots=2, max_seq_len=32,
                                 kv_quant=True)])
    rng = np.random.default_rng(10)
    for i in range(6):
        group.submit(Request(uid=i, prompt=rng.standard_normal(
            (int(rng.integers(2, 7)), H)).astype(np.float16), max_new=2))
    fin = group.run_to_completion(max_steps=100)
    assert len(fin) == 6 and all(r.done for r in fin)
    assert all(np.all(np.isfinite(r.final_hidden)) for r in fin)
    assert all(len(e.finished) >= 1 for e in group.engines)
    with pytest.raises(ValueError):
        DataParallelEngineGroup([])

"""BitNet b1.58 at 3B-like widths on the CPU, the port against the JAX
package: head dim 100 (hidden 1600, 16 heads and KV heads; the 3B model
has hidden 3200, 32 heads), intermediate 1088 (K % 128 = 64 at the down
projection, as the 3B model's 8640 gives), 2 layers, vocab 64.

What this adds to tests/test_torch_bitnet.py (head dim 128): the prefill
of a head dim that is not a multiple of 128 runs the flash kernel on both
sides -- the port's plain version of kernel 4 at D = 100, JAX's Pallas
kernel in interpret mode through its zero-pad shim -- and decode at D =
100 takes both packages' plain length-masked attention (D % 128 != 0).
The JAX model's ternarized weights are carried across with
`convert.from_jax_bitnet_state`.

Tolerances, for test_torch_bitnet.py's reasons: a BitLinear is exact on
both sides (every projection bit for bit here too); a layer adds float16
activations, attention (the flash kernels round P differently) and the
next activation's absmax quantization, whose per-token scale follows the
largest element, so a one-ulp difference upstream moves a code by a whole
step. At these widths the RMSNorm's mean over 1600 elements, summed in
other orders, already differs by one float16 ulp (2e-3 at |.| < 4); one
layer differs by 0.0061 on outputs of |.| < 1 with or without the flash
kernels, two by 0.015 on |.| < 1.3 (1.2% of the largest, against
test_torch_bitnet.py's 2e-3 on |.| < 0.25). Hidden states are held to
2e-2 of the largest, chip_smoke.py's limit for hidden states through 2
float16 layers, logits to 2e-2 x max |logit|; greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.models import BitNetLlama as JaxBitNetLlama
from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.serving import \
    TokenContinuousBatchingEngine as JaxTokenEngine

import bitblas_tpu_torch.models.quant_llama as pql
from bitblas_tpu_torch import convert
from bitblas_tpu_torch.models import bitnet as pbn
from bitblas_tpu_torch.models.hf_import import LMHead
from bitblas_tpu_torch.models.quant_llama import LlamaConfig
from bitblas_tpu_torch.serving.engine import TokenContinuousBatchingEngine
from bitblas_tpu_torch.testing import assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file: the tier-1 command runs
    six workers on eight cores, and torch's eight-thread pool then spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, H, HEADS = 64, 1600, 16
CFG = dict(hidden_size=H, intermediate_size=1088, num_heads=HEADS,
           num_kv_heads=HEADS, num_layers=2, vocab_size=V, group_size=128,
           rope_theta=10000.0, rms_norm_eps=1e-5)
D = H // HEADS
HIDDEN_RTOL = 2e-2    # of max |hidden|
LOGIT_RTOL = 2e-2     # of max |logit|


def _hidden_close(got, want, msg=""):
    want = np.asarray(want, np.float32)
    assert_close(got, want, rtol=0.0, atol=HIDDEN_RTOL * np.abs(want).max(),
                 max_mismatched_ratio=0.0, msg=msg)


def _synchronous(engine):
    """A JAX engine whose decode steps finish before they return (see
    test_torch_serving.py)."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


@pytest.fixture(scope="module")
def pair():
    jm = JaxBitNetLlama(JaxLlamaConfig(**CFG), opt_m=(1, 2, 16))
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V, H)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, H)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((H,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = LlamaConfig(**CFG)
    pm = pbn.BitNetLlama(cfg, device="cpu", seed=78)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(convert.from_jax_bitnet_state(state, cfg))
    ph = LMHead(embed, np.ones(H, np.float32), lm_head, device="cpu")
    return jm, jh, pm, ph, embed


def test_widths_are_the_3b_edges(pair):
    cfg = pair[2].cfg
    assert cfg.head_dim == 100 and cfg.head_dim % 128
    assert cfg.intermediate_size % 128 == 64     # as 8640 % 128


def test_prefill_through_flash_at_head_dim_100_and_decode_match_jax(
        pair, monkeypatch):
    jm, jh, pm, ph, embed = pair
    calls = []
    flash = pql.flash_attention_fwd

    def counting_flash(q, k, v, *a, **kw):
        calls.append(q.shape)
        return flash(q, k, v, *a, **kw)

    monkeypatch.setattr(pql, "flash_attention_fwd", counting_flash)
    S, bucket = 200, 256
    toks = np.random.default_rng(7).integers(0, V, S)
    x = np.zeros((1, bucket, H), np.float16)
    x[0, :S] = embed[toks]
    pos = np.arange(bucket)[None]
    jhid, jks, jvs = jm.make_prefill(bucket)(jnp.asarray(x),
                                            jnp.asarray(pos))
    phid, pks, pvs = pm.make_prefill(bucket)(torch.from_numpy(x),
                                            torch.from_numpy(pos))
    assert calls == [(1, bucket, HEADS, D)] * CFG["num_layers"]
    _hidden_close(phid[:, :S], jhid[:, :S])
    want = np.asarray(jh.logits(jhid[:, :S]))
    assert_close(ph.logits(phid[:, :S]), want, rtol=0.0,
                 atol=LOGIT_RTOL * np.abs(want).max(),
                 max_mismatched_ratio=0.0)

    L, lmax = CFG["num_layers"], bucket + 4
    jk = jnp.zeros((L, 1, lmax, HEADS, D), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([k[:S] for k in jks]).astype(jnp.bfloat16))
    jv = jnp.zeros((L, 1, lmax, HEADS, D), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([v[:S] for v in jvs]).astype(jnp.bfloat16))
    pk = torch.zeros((L, 1, lmax, HEADS, D), dtype=torch.bfloat16)
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
        _hidden_close(ph_i, jh_i, msg=f"step {i}")


def test_token_engine_greedy_tokens_match_jax(pair):
    """Prompts of 200 and 40 tokens: the first prefills in bucket 256,
    through the flash kernel at head dim 100, the second in bucket 64
    through the plain masked softmax; decode steps at M = 2."""
    jm, jh, pm, ph, _ = pair
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (200, 40)]
    je = _synchronous(JaxTokenEngine(jm, jh, num_slots=2, max_seq_len=256))
    pe = TokenContinuousBatchingEngine(pm, ph, num_slots=2, max_seq_len=256)
    jr = [je.submit_tokens(uid=i, tokens=p, max_new=4)
          for i, p in enumerate(prompts)]
    pr = [pe.submit_tokens(uid=i, tokens=p, max_new=4)
          for i, p in enumerate(prompts)]
    je.run_to_completion()
    pe.run_to_completion()
    for a, b in zip(jr, pr):
        assert b.done and len(b.out_tokens) == 4
        assert b.out_tokens == a.out_tokens, b.uid
        _hidden_close(b.final_hidden, a.final_hidden)


class _NoLayers(pql.DecoderServingMixin):
    """make_prefill's routing alone: a config and no layers."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.layers = []


@pytest.mark.parametrize("D,heads,S,refused", [
    (100, 16, 256, False),     # the 3B-like model: kernel 4
    (100, 15, 256, False),     # odd heads at D % 8 == 4: the general one
    (80, 16, 256, False),      # Danube's head dim: its wgmma instance
    (80, 16, 200, False),      # a short prompt: JAX's rule, not a refusal
    (800, 2, 256, True),       # past the general instance's cap
])
def test_make_prefill_counts_what_kernel_4_refuses(D, heads, S, refused):
    """A prompt JAX's rule sends to the flash kernel but whose shape
    kernel 4 refuses takes the plain masked softmax, one count in
    `plain_prefills` a call; the rest count nothing."""
    cfg = LlamaConfig(**{**CFG, "hidden_size": D * heads, "num_heads": heads,
                         "num_kv_heads": heads})
    fn = _NoLayers(cfg).make_prefill(S)
    x = torch.zeros((1, S, cfg.hidden_size), dtype=torch.float16)
    before = pql.DecoderServingMixin.plain_prefills
    for _ in range(2):
        fn(x, torch.arange(S)[None])
    assert pql.DecoderServingMixin.plain_prefills == before + 2 * refused

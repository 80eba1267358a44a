"""An H2O-Danube-1.8B-shaped model (head dim 80, a sliding window, GQA,
bfloat16 activations) in the port against the JAX package, on the CPU.

H2O-Danube-1.8B (`h2oai/h2o-danube-1.8b-base`, a MistralForCausalLM;
arXiv:2401.16818, Table 1) has hidden 2560 = 32 heads x 80, 8 KV heads,
window 4096. Here: hidden 320 = 4 heads x 80, 2 KV heads, 2 layers,
window 64, uint4 at group 64 (K = 320 takes no group of 128), a
256-token prompt, which JAX's rule sends through the flash kernel (S >=
256, S % 128 == 0) at head dim 80: JAX pads D to 128, the port's plain
version (on the card the "d80" wgmma instance) takes 80 as it is. Decode
at D = 80 is JAX's XLA path and the port's plain decode on both sides.
The weights are JAX's, carried across by `convert.from_jax_state`.

Tolerances (tests/test_torch_bf16_serving.py's): bfloat16 rounds 2^-8 of
a value; logits of |.| < 3 after 2 layers within 3 * 2^-8, hidden states
(|.| < 0.5) within 2^-8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.models.hf_import import \
    llama_config_from_hf as jax_config_from_hf

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.kernels import flash
from bitblas_tpu_torch.models import quant_llama as pql
from bitblas_tpu_torch.models.hf_import import LMHead, llama_config_from_hf
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.testing import assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file (the tier-1 command runs six
    workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16 = 2.0 ** -8
LOGIT_ATOL = 3 * BF16
HIDDEN_ATOL = BF16
V, H, D = 64, 320, 80
CFG = dict(hidden_size=H, intermediate_size=640, num_heads=4,
           num_kv_heads=2, num_layers=2, vocab_size=V, group_size=64,
           act_dtype="bfloat16", sliding_window=64, rms_norm_eps=1e-5)
S = 256

# h2oai/h2o-danube-1.8b-base config.json, its published fields
DANUBE_HF = {"architectures": ["MistralForCausalLM"], "model_type": "mistral",
             "hidden_size": 2560, "intermediate_size": 6912,
             "num_attention_heads": 32, "num_key_value_heads": 8,
             "num_hidden_layers": 24, "vocab_size": 32000,
             "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
             "sliding_window": 4096, "max_position_embeddings": 16384,
             "tie_word_embeddings": False, "torch_dtype": "bfloat16"}


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
    toks = np.random.default_rng(2).integers(0, V, S)
    x = embed[toks][None]
    pos = np.arange(S)[None]
    jout = jm.make_prefill(S)(jnp.asarray(x), jnp.asarray(pos))
    before = pql.DecoderServingMixin.plain_prefills
    calls = []
    fwd = pql.flash_attention_fwd

    def recording(*a, **k):
        calls.append(a[0].shape)
        return fwd(*a, **k)

    pql.flash_attention_fwd = recording
    try:
        pout = pm.make_prefill(S)(torch.from_numpy(x), torch.from_numpy(pos))
    finally:
        pql.flash_attention_fwd = fwd
    counts = (calls, pql.DecoderServingMixin.plain_prefills - before)
    return jm, jh, pm, ph, embed, jout, pout, counts


def test_danube_prefill_takes_kernel_4_and_matches_jax(pair):
    jm, jh, pm, ph, _, (jhid, _, _), (phid, _, _), (calls, plain) = pair
    assert pm.cfg.head_dim == D and pm.cfg.sliding_window < S
    # JAX's rule: the prompt attends through kernel 4 in every layer, on
    # the d80 instance; nothing counts as a plain prefill
    assert calls == [(1, S, 4, D)] * CFG["num_layers"] and plain == 0
    assert flash.prefill_instance(S, 4, 2, D, torch.bfloat16) == "wgmma"
    assert_close(phid, np.asarray(jhid), rtol=0.0, atol=HIDDEN_ATOL,
                 max_mismatched_ratio=0.0)
    assert_close(ph.logits(phid[0]), np.asarray(jh.logits(jhid[0])),
                 rtol=0.0, atol=LOGIT_ATOL, max_mismatched_ratio=0.0)


def test_danube_decode_steps_match_jax(pair):
    """Four teacher-forced decode steps past the window over bfloat16 slot
    caches: head dim 80 takes the plain length-masked decode in both
    packages (JAX's XLA path at D % 128 != 0)."""
    jm, jh, pm, ph, embed, (_, jks, jvs), (_, pks, pvs), _ = pair
    L, lmax, Hkv = CFG["num_layers"], S + 8, CFG["num_kv_heads"]
    jk = jnp.zeros((L, 1, lmax, Hkv, D), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack(list(jks)))
    jv = jnp.zeros((L, 1, lmax, Hkv, D), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack(list(jvs)))
    pk = torch.zeros((L, 1, lmax, Hkv, D), dtype=torch.bfloat16)
    pv = torch.zeros_like(pk)
    pk[:, 0, :S] = torch.stack(list(pks))
    pv[:, 0, :S] = torch.stack(list(pvs))
    slots = np.zeros((1,), np.int32)
    for i, tok in enumerate((3, 17, 42, 5)):
        xi = embed[[[tok]]]
        lengths = np.array([S + i + 1], np.int32)
        jh_i, jk, jv = jm.decode_step(jnp.asarray(xi), jk, jv,
                                      jnp.asarray(slots),
                                      jnp.asarray(lengths))
        ph_i, pk, pv = pm.decode_step(torch.from_numpy(xi), pk, pv,
                                      torch.from_numpy(slots),
                                      torch.from_numpy(lengths))
        assert_close(ph.logits(ph_i), np.asarray(jh.logits(jh_i)),
                     rtol=0.0, atol=LOGIT_ATOL, max_mismatched_ratio=0.0,
                     msg=f"step {i}")


def test_danube_config_maps_as_jax():
    """H2O-Danube-1.8B's config.json maps to the same LlamaConfig in both
    packages: head dim 80, window 4096."""
    got = llama_config_from_hf(DANUBE_HF, group_size=128,
                               act_dtype="bfloat16")
    want = jax_config_from_hf(DANUBE_HF, group_size=128,
                              act_dtype="bfloat16")
    for f in ("hidden_size", "intermediate_size", "num_heads",
              "num_kv_heads", "num_layers", "vocab_size", "group_size",
              "act_dtype", "rope_theta", "rope_scaling", "attention_bias",
              "rms_norm_eps", "sliding_window", "head_dim"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.head_dim == 80 and got.sliding_window == 4096
    assert (got.num_heads, got.num_kv_heads, got.num_layers) == (32, 8, 24)

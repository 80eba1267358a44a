"""The port's expert parallelism (parallel/moe: EPQuantMoELayer,
expert_parallel_mixtral through QuantMixtralLayer's `moe_ep` hook)
against the JAX package's on the 8-device CPU mesh and against the port's
single-device layer and model.

Fixtures: JAX's tests/test_moe.py layer (hidden 256, intermediate 512, 4
experts top-2, group 128; 32 tokens, x ~ 0.5 N(0, 1), one zero row) at ep
2 and 4, and tests/test_torch_mixtral.py's Mixtral (2 layers, vocab 64)
at ep 2; the JAX weights carried across with `convert.from_jax_moe_state`
/ `from_jax_mixtral_state`. One world of four gloo ranks runs every case.

Tolerances: EP against the port's single-device layer bit for bit (each
token's top-2 gate sums reach the all-reduce on at most two ranks, as
w0 o0 + 0 and 0 + w1 o1, which add exactly); against JAX's EP layer
within 1e-2 of the largest output (test_torch_moe.py's); greedy tokens
equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bitblas_tpu.models import MixtralConfig as JaxMixtralConfig
from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models import QuantMixtral as JaxQuantMixtral
from bitblas_tpu.models import quant_moe as jmoe
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.parallel.moe import EPQuantMoELayer as JaxEPLayer

from bitblas_tpu_torch.convert import (from_jax_mixtral_state,
                                       from_jax_moe_state)
from bitblas_tpu_torch.models.quant_moe import MixtralConfig, MoEConfig
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.testing.dist import run_world
from bitblas_tpu_torch.testing.ranks import moe_world

MOE = dict(hidden_size=256, intermediate_size=512, n_experts=4, top_k=2,
           group_size=128)
MIXTRAL = dict(hidden_size=256, intermediate_size=512, num_heads=4,
               num_kv_heads=2, num_layers=2, vocab_size=64, group_size=128,
               n_experts=4, top_k=2, capacity_factor=2.0)
T = 32


def _jax_layer():
    return jmoe.QuantMoELayer(jmoe.MoEConfig(**MOE), tokens=T, seed=1)


def _layer_state(jl):
    st = {"router": np.asarray(jl.router)}
    for name, per in jl.weights.items():
        for e, (W, S, Z) in enumerate(per):
            for t, v in (("qweight", W), ("scales", S), ("zeros", Z)):
                st[f"expert_{e}.{name}.{t}"] = np.asarray(v)
    return from_jax_moe_state(st, MoEConfig(**MOE))


def _x():
    x = (np.random.default_rng(5).standard_normal((T, 256)) * 0.5
         ).astype(np.float32)
    x[1] = 0.0
    return x


def _mixtral():
    jm = JaxQuantMixtral(JaxMixtralConfig(**MIXTRAL), opt_m=(1, 4, 8, 16),
                         moe_tokens=16)
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((64, 256)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((64, 256)) * 0.05).astype(np.float32)
    return jm, embed, lm_head


PROMPT = np.arange(6, dtype=np.int32)
MAX_NEW = 4


@pytest.fixture(scope="module")
def world():
    jl = _jax_layer()
    state = _layer_state(jl)
    jm, embed, lm_head = _mixtral()
    mstate = from_jax_mixtral_state(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jm.state_dict().items()}, MixtralConfig(**MIXTRAL))
    cases = [dict(name=f"layer_ep{ep}", tp=ep, kind="layer", cfg=MOE,
                  tokens=T, state=state, x=_x()) for ep in (2, 4)]
    cases.append(dict(name="mixtral", tp=2, kind="mixtral", cfg=MIXTRAL,
                      state=mstate, embed=embed, lm_head=lm_head,
                      prompt=PROMPT, max_new=MAX_NEW))
    return run_world(moe_world, 4, cases), jl, (jm, embed, lm_head)


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_layer_matches_single_device_and_jax(world, ep):
    res, jl, _ = world
    out = res[0][f"layer_ep{ep}"]
    np.testing.assert_array_equal(out["y"], out["ref_y"])
    for r in range(1, ep):
        np.testing.assert_array_equal(res[r][f"layer_ep{ep}"]["y"],
                                      out["y"])
    assert out["allreduces"] == 1
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    want = np.asarray(JaxEPLayer(jl, mesh).forward(
        jnp.asarray(_x(), jnp.float16)), np.float32)
    assert_close(out["y"], want, rtol=0.0,
                 atol=1e-2 * float(np.abs(want).max()),
                 max_mismatched_ratio=0.0)
    assert np.all(out["y"][1] == 0.0)          # the zero row stays zero


def test_expert_parallel_mixtral_tokens(world):
    """expert_parallel_mixtral at ep 2: the greedy stream equals the
    single-device model's on both ranks, and JAX's."""
    res, _, (jm, embed, lm_head) = world
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((256,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    want = np.asarray(JaxQuantLlamaLM(jm, jh).generate(
        PROMPT, max_new_tokens=MAX_NEW, temperature=0.0))
    out = res[0]["mixtral"]
    np.testing.assert_array_equal(out["tokens"], out["ref_tokens"])
    np.testing.assert_array_equal(res[1]["mixtral"]["tokens"],
                                  out["tokens"])
    np.testing.assert_array_equal(out["tokens"], want)

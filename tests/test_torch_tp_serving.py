"""The port's tensor-parallel serving (parallel/serving.TPQuantLlama and the
engines over it) against the JAX package's, on the CPU.

One world of four gloo ranks (testing/dist.run_world, ranks in
testing/ranks.tp_serving_world) runs every case of this file once; the
tp = 2 cases use ranks 0-1 as a subgroup. The JAX side runs the same case
on the 8-device CPU mesh from tests/conftest.py. Both get the weights of
one JAX QuantLlama (carried across with `convert.from_jax_state`) and the
same seeded numpy inputs.

The fixture is JAX's (tests/test_tp_serving.py) at hidden 512 (head dim
64): K/tp of the row-parallel o projection must stay a multiple of 128 at
tp = 4 (kernel 1's K rule), which hidden 256 breaks (the refusal is a case
here). The kv-head replication and context-parallel cases run tp = 4 over
2 KV heads, where JAX's run tp = 8 over 4.

Tolerances: the port's TP run against JAX's TP run at the port's model
tests' 1e-2 (test_torch_serving.py); against the port's single-device
model at JAX's rtol = atol = 2e-2; the int8-cache and int8-collective
runs within JAX's own relative limits of their exact twins.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from bitblas_tpu.models.quant_llama import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models.quant_llama import QuantLlama as JaxQuantLlama
from bitblas_tpu.parallel.serving import TPQuantLlama as JaxTPQuantLlama
from bitblas_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from bitblas_tpu.serving.engine import \
    PagedContinuousBatchingEngine as JaxPagedEngine
from bitblas_tpu.serving.engine import Request as JaxRequest
from bitblas_tpu.serving.kv_cache import quantize_kv as jax_quantize_kv

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.models.quant_llama import LlamaConfig
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.testing.dist import run_world
from bitblas_tpu_torch.testing.ranks import tp_serving_world

BASE = dict(hidden_size=512, intermediate_size=1024, num_heads=8,
            num_kv_heads=4, num_layers=1, group_size=64)
CFGS = {"base": BASE,
        "kv2": dict(BASE, num_kv_heads=2),           # tp 4 > 2 KV heads
        "window": dict(BASE, sliding_window=6),
        "kv2_window": dict(BASE, num_kv_heads=2, sliding_window=6),
        "narrow": dict(BASE, hidden_size=256, intermediate_size=512),
        "bias": dict(BASE, attention_bias=True)}
ATOL = 1e-2          # port against JAX (the port's model tests')
TP_TOL = 2e-2        # port TP against port single device (JAX's)
B, S, D = 4, 16, 64
WORLD = 4


@functools.lru_cache(maxsize=None)
def jax_model(name):
    return JaxQuantLlama(JaxLlamaConfig(**CFGS[name]), opt_m=(1, 4, 8, 16))


def port_state(name):
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jax_model(name).state_dict().items()}
    return from_jax_state(state, LlamaConfig(**CFGS[name]))


def _cache(rng, L, hkv, scale=1.0):
    return (scale * rng.standard_normal((L, B, S, hkv, D))) \
        .astype(np.float32)


def _decode_case(name, cfg, tp, seed, lengths, T=1, scale=1.0, kind="decode",
                 **kw):
    rng = np.random.default_rng(seed)
    c = CFGS[cfg]
    L, hkv = c["num_layers"], c["num_kv_heads"]
    return dict(name=name, cfg=cfg, tp=tp, kind=kind, seed=seed,
                ck=_cache(rng, L, hkv, scale), cv=_cache(rng, L, hkv),
                x=rng.standard_normal((B, T, c["hidden_size"]))
                .astype(np.float16),
                slots=np.arange(B, dtype=np.int32),
                lengths=np.asarray(lengths, np.int32), **kw)


def _prompts(seed, sizes, hidden=512):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, hidden)).astype(np.float16)
            for s in sizes]


CP = dict(context_parallel=True)
CASES = [
    _decode_case("decode_tp2", "base", 2, 0, [3, 5, 0, 7]),
    _decode_case("decode_tp4", "base", 4, 0, [3, 5, 0, 7]),
    _decode_case("replicate", "kv2", 4, 3, [3, 5, 0, 7]),
    # peaked K (20x): a head- or shard-mixing merge cannot hide in a flat
    # softmax; lengths straddle the shard boundary (8 rows a shard)
    _decode_case("cp_decode", "kv2", 4, 5, [3, 5, 9, 12], scale=20.0,
                 tp_kw=CP),
    _decode_case("cp_chunk", "kv2", 4, 12, [2, 6, 7, 12], T=3, scale=20.0,
                 tp_kw=CP),
    _decode_case("cp_float", "kv2", 4, 15, [3, 5, 9, 12], scale=4.0,
                 tp_kw=CP),
    _decode_case("cp_quant", "kv2", 4, 15, [3, 5, 9, 12], scale=4.0,
                 kind="quant", tp_kw=CP),
    _decode_case("cp_chunk_float", "kv2", 4, 16, [2, 6, 7, 12], T=3,
                 scale=4.0, tp_kw=CP),
    _decode_case("cp_chunk_quant", "kv2", 4, 16, [2, 6, 7, 12], T=3,
                 scale=4.0, kind="quant", tp_kw=CP),
    _decode_case("quant_kv_float", "base", 2, 5, [8, 8, 8, 8]),
    _decode_case("quant_kv", "base", 2, 5, [8, 8, 8, 8], kind="quant"),
    _decode_case("int8_collectives", "base", 4, 0, [3, 5, 0, 7],
                 tp_kw=dict(quantized_collectives=True)),
    _decode_case("overlap", "base", 2, 1, [3, 5, 0, 7],
                 tp_kw=dict(overlap_chunks=2)),
    _decode_case("window", "window", 4, 2, [3, 8, 12, 15]),
    dict(name="prefill", cfg="base", tp=4, kind="prefill",
         x=np.random.default_rng(1).standard_normal((1, 8, 512))
         .astype(np.float16)),
    dict(name="cp_prefill", cfg="kv2", tp=4, kind="prefill", tp_kw=CP,
         x=np.random.default_rng(6).standard_normal((1, 8, 512))
         .astype(np.float16)),
    dict(name="overlap_prefill", cfg="base", tp=2, kind="prefill",
         tp_kw=dict(overlap_chunks=2),
         x=np.random.default_rng(1).standard_normal((1, 8, 512))
         .astype(np.float16)),
    dict(name="slot_engine", cfg="base", tp=4, kind="engine",
         prompts=_prompts(2, (3, 5)), max_new=3),
    dict(name="cp_engine", cfg="kv2", tp=4, kind="engine", tp_kw=CP,
         prompts=_prompts(9, (3, 5)), max_new=3),
    dict(name="paged_engine", cfg="base", tp=4, kind="engine", paged=True,
         prompts=_prompts(5, (3, 6)), max_new=3),
    dict(name="paged_float", cfg="base", tp=2, kind="engine", paged=True,
         slots=3, prompts=_prompts(9, (2, 6, 4)), max_new=2),
    dict(name="paged_int8", cfg="base", tp=2, kind="engine", paged=True,
         kv_quant=True, slots=3, prompts=_prompts(9, (2, 6, 4)), max_new=2),
    dict(name="refuse_cp_window", cfg="kv2_window", tp=4, kind="refuse",
         tp_kw=CP),
    dict(name="refuse_k_rule", cfg="narrow", tp=4, kind="refuse"),
    dict(name="refuse_bias", cfg="bias", tp=4, kind="refuse"),
    dict(name="refuse_paged_cp", cfg="kv2", tp=4, kind="refuse", tp_kw=CP,
         paged=True, prompts=_prompts(9, (3,)), max_new=2),
    dict(name="refuse_paged_window", cfg="window", tp=4, kind="refuse",
         paged=True, prompts=_prompts(9, (3,)), max_new=2),
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def world():
    """Every case through the port's world of four ranks, once."""
    states = {}
    cases = []
    for c in CASES:
        if c["cfg"] not in states:
            states[c["cfg"]] = port_state(c["cfg"])
        cases.append(dict(c, cfg=CFGS[c["cfg"]], state=states[c["cfg"]]))
    return run_world(tp_serving_world, WORLD, cases)


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]).reshape(tp), ("tp",))


@functools.lru_cache(maxsize=None)
def _jax_tp_of(cfg, tp, kw):
    return JaxTPQuantLlama(jax_model(cfg), _mesh(tp), **dict(kw))


def _jax_tp(case):
    return _jax_tp_of(case["cfg"], case["tp"],
                      tuple(sorted(case.get("tp_kw", {}).items())))


def _synchronous(engine):
    """A JAX engine whose steps finish before they return (its host
    arrays are updated in place after an asynchronous step;
    test_torch_serving.py)."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


def jax_decode(case):
    """JAX's TP decode step / chunk on the case: (y, ck, cv) with the
    caches in the model's layout (effective heads, or source heads under
    context parallelism)."""
    tpm = _jax_tp(case)
    rep = 1 if tpm.context_parallel else tpm.kv_rep
    ck = jnp.repeat(jnp.asarray(case["ck"], jnp.bfloat16), rep, axis=3)
    cv = jnp.repeat(jnp.asarray(case["cv"], jnp.bfloat16), rep, axis=3)
    x = jnp.asarray(case["x"])
    args = (jnp.asarray(case["slots"]), jnp.asarray(case["lengths"]))
    chunk = case["x"].shape[1] > 1
    sh = tpm.kv_cache_sharding()
    if case["kind"] == "quant":
        (kq, ks), (vq, vs) = (jax_quantize_kv(ck.astype(jnp.float32)),
                              jax_quantize_kv(cv.astype(jnp.float32)))
        ssh = NamedSharding(tpm.smesh, tpm._ks_spec)
        step = tpm.decode_chunk_quant if chunk else tpm.decode_step_quant
        out = step(x, jax.device_put(kq, sh), jax.device_put(vq, sh),
                   jax.device_put(ks, ssh), jax.device_put(vs, ssh), *args)
    else:
        step = tpm.decode_chunk if chunk else tpm.decode_step
        out = step(x, jax.device_put(ck, sh), jax.device_put(cv, sh), *args)
    return [np.asarray(t, np.float32) for t in out[:3]]


def port_cache(world, case, key):
    """The port ranks' cache shards of `key` reassembled in JAX's layout
    (float32)."""
    parts = [world[r][case["name"]][key] for r in range(case["tp"])]
    if case.get("tp_kw", {}).get("context_parallel"):
        cp = case["tp"] // CFGS[case["cfg"]]["num_kv_heads"]
        heads = [np.concatenate(parts[a * cp:(a + 1) * cp], axis=2)
                 for a in range(case["tp"] // cp)]
        return np.concatenate(heads, axis=3)
    return np.concatenate(parts, axis=3)


def _rel(a, b):
    return np.abs(a - b).max() / max(1e-6, np.abs(b).max())


@pytest.mark.parametrize("name", ["decode_tp2", "decode_tp4", "replicate",
                                  "cp_decode", "cp_chunk", "window"])
def test_tp_decode_matches_jax_and_single_device(world, name):
    """decode_step (decode_chunk for cp_chunk) at tp 2 / 4, with KV heads
    replicated at tp 4 > 2 KV heads, with context parallelism, and with a
    sliding window: hidden states and the updated caches against JAX's TP
    run and the port's single-device model."""
    case = BY_NAME[name]
    res = world[0][name]
    y, ck, cv = jax_decode(case)
    assert_close(res["y"], y, rtol=ATOL, atol=ATOL, max_mismatched_ratio=0.0)
    assert_close(res["y"], res["ref_y"], rtol=TP_TOL, atol=TP_TOL,
                 max_mismatched_ratio=0.0)
    for key, want in (("ck", ck), ("cv", cv)):
        assert_close(port_cache(world, case, key), want, rtol=ATOL,
                     atol=ATOL, max_mismatched_ratio=0.0, msg=key)
    # two all-reduces a layer
    assert res["allreduces"] == 2 * CFGS[case["cfg"]]["num_layers"]


def test_window_reached_the_tp_attention(world):
    """Length 15 > window 6: the windowed TP decode differs from the
    single-device decode without the window at the same weights (JAX's
    check that the window reached the attention)."""
    res = world[0]["window"]
    assert np.abs(res["ref_y_nowindow"][3] - res["y"][3]).max() > 1e-3


@pytest.mark.parametrize("name,float_name", [
    ("cp_quant", "cp_float"), ("cp_chunk_quant", "cp_chunk_float"),
    ("quant_kv", "quant_kv_float")])
def test_int8_kv_matches_jax_and_float(world, name, float_name):
    """decode_step_quant / decode_chunk_quant (context-parallel and not)
    against JAX's on the same int8 codes, and within JAX's limit of the
    float-cache run (rel 0.06 under cp, rtol 5e-2 / atol 0.3 at tp 2)."""
    case = BY_NAME[name]
    res = world[0][name]
    y, ck, _ = jax_decode(case)
    assert_close(res["y"], y, rtol=ATOL, atol=ATOL, max_mismatched_ratio=0.0)
    # the appended token's K differs by an f16 rounding between the
    # packages: its codes by at most 1
    assert_close(port_cache(world, case, "ck"), ck, rtol=0, atol=1,
                 max_mismatched_ratio=0.0, msg="int8 codes")
    y_f = world[0][float_name]["y"]
    if case.get("tp_kw"):
        assert _rel(res["y"], y_f) < 0.06
    else:
        assert_close(res["y"], y_f, rtol=5e-2, atol=0.3)


def test_quantized_collectives_close_to_exact(world):
    """The int8 all-gather all-reduce tracks the exact all-reduce within
    JAX's limit (rel 0.05) and JAX's own int8 collectives."""
    res = world[0]["int8_collectives"]["y"]
    assert _rel(res, world[0]["decode_tp4"]["y"]) < 0.05
    y, _, _ = jax_decode(BY_NAME["int8_collectives"])
    assert_close(res, y, rtol=ATOL, atol=ATOL, max_mismatched_ratio=0.0)


def test_overlap_chunks_decode_and_prefill(world):
    """overlap_chunks=2: decode and prefill against JAX's and the port's
    single-device model."""
    case = BY_NAME["overlap"]
    res = world[0]["overlap"]
    y, _, _ = jax_decode(case)
    assert_close(res["y"], y, rtol=ATOL, atol=ATOL, max_mismatched_ratio=0.0)
    assert_close(res["y"], res["ref_y"], rtol=TP_TOL, atol=TP_TOL,
                 max_mismatched_ratio=0.0)
    pre = world[0]["overlap_prefill"]
    assert_close(pre["hidden"], pre["ref_hidden"], rtol=TP_TOL,
                 atol=TP_TOL, max_mismatched_ratio=0.0)


@pytest.mark.parametrize("name", ["prefill", "cp_prefill"])
def test_prefill_matches_jax_and_single_device(world, name):
    """make_prefill: the hidden states, and each rank's K (its effective
    heads, or under cp its source head) against JAX's K."""
    case = BY_NAME[name]
    tpm = _jax_tp(case)
    x = jnp.asarray(case["x"])
    pos = jnp.arange(x.shape[1])[None]
    h, ks, _ = tpm.make_prefill(x.shape[1])(x, pos)
    res = world[0][name]
    assert_close(res["hidden"], np.asarray(h, np.float32), rtol=ATOL,
                 atol=ATOL, max_mismatched_ratio=0.0)
    assert_close(res["hidden"], res["ref_hidden"], rtol=TP_TOL, atol=TP_TOL,
                 max_mismatched_ratio=0.0)
    k_jax = np.stack([np.asarray(k, np.float32) for k in ks])  # [L, S, h, D]
    cp = tpm.cp if tpm.context_parallel else 1
    for r in range(case["tp"]):
        k = world[r][name]["k"]
        if cp > 1:                      # source head r // cp
            want = k_jax[:, :, r // cp:r // cp + 1]
        else:                           # effective heads of rank r
            n = k.shape[2]
            want = k_jax[:, :, r * n:(r + 1) * n]
        assert_close(k, want, rtol=ATOL, atol=ATOL, max_mismatched_ratio=0.0)


def _jax_engine(case):
    tpm = _jax_tp(case)
    if case.get("paged"):
        eng = JaxPagedEngine(tpm, num_slots=case.get("slots", 4),
                             num_blocks=32, block_size=4,
                             cache_sharding=tpm.kv_cache_sharding(),
                             kv_quant=case.get("kv_quant", False))
    else:
        eng = JaxEngine(tpm, num_slots=4, max_seq_len=32,
                        cache_sharding=tpm.kv_cache_sharding())
    eng = _synchronous(eng)
    for i, p in enumerate(case["prompts"]):
        eng.submit(JaxRequest(uid=i, prompt=p.copy(),
                              max_new=case["max_new"]))
    done = eng.run_to_completion(max_steps=60)
    assert len(done) == len(case["prompts"])
    return {r.uid: np.asarray(r.final_hidden, np.float32) for r in done}


@pytest.mark.parametrize("name", ["slot_engine", "cp_engine",
                                  "paged_engine", "paged_int8"])
def test_engines_over_ranks(world, name):
    """The slot, context-parallel and paged engines (float and int8 pool)
    over the ranks: every request's final hidden state against JAX's TP
    engine, and the float engines against the port's single-device engine
    (JAX's engine tests' 5e-2); the int8 pool within JAX's 0.3 of the
    float pool."""
    case = BY_NAME[name]
    res = world[0][name]
    want = _jax_engine(case)
    assert sorted(res["final"]) == sorted(want)
    for uid, h in want.items():
        assert_close(res["final"][uid], h, rtol=ATOL, atol=ATOL,
                     max_mismatched_ratio=0.0, msg=f"uid {uid}")
    if case.get("kv_quant"):
        for uid, h in world[0]["paged_float"]["final"].items():
            assert_close(res["final"][uid], h, rtol=5e-2, atol=0.3)
    else:
        assert_close(res["last"], res["ref_last"], rtol=5e-2, atol=5e-2,
                     max_mismatched_ratio=0.02)
    # every rank ran the same schedule to the same hidden states
    for r in range(1, case["tp"]):
        np.testing.assert_array_equal(world[r][name]["last"], res["last"])


def test_refusals(world):
    """JAX's refusals (a window with context parallelism, q/k/v biases,
    the paged steps under context parallelism or a window:
    parallel/serving.py:191-205, :593-605), and the row shard whose K/tp
    breaks kernel 1's K rule (hidden 256 at tp 4: the o projection's
    K/tp = 64)."""
    res = world[0]
    assert res["refuse_cp_window"].startswith("NotImplementedError")
    assert "sliding_window" in res["refuse_cp_window"]
    msg = res["refuse_k_rule"]
    assert msg.startswith("ValueError") and "K/tp=64" in msg
    assert res["refuse_bias"].startswith("NotImplementedError")
    assert "bias" in res["refuse_bias"]
    assert res["refuse_paged_cp"].startswith("NotImplementedError")
    assert "context_parallel" in res["refuse_paged_cp"]
    assert res["refuse_paged_window"].startswith("NotImplementedError")
    assert "sliding-window" in res["refuse_paged_window"]
    with pytest.raises(NotImplementedError, match="sliding_window"):
        _jax_tp(BY_NAME["refuse_cp_window"])

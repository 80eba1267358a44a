"""The port's int8 slot KV cache against the JAX package, on the CPU.

Both packages get the same numpy inputs. The JAX side runs its int8
flash-decode Pallas kernel in interpret mode (or its XLA path), the port
the kernel's plain version. Quantization must give the same codes and
scales bit for bit; attention outputs are f16 of magnitude < 4 computed
in f32 on both sides, so they agree to about one f16 ulp: atol 4e-3.
Model-level outputs (2 layers, hidden 256) follow test_torch_serving's
1e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bitblas_tpu.serving import Request as JaxRequest
from bitblas_tpu.serving import kv_cache as jkv

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.kernels.flash import (flash_decode_quant,
                                             flash_decode_quant_plain)
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
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

H = 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=2,
           num_kv_heads=1, num_layers=2, vocab_size=64, group_size=128)
ATTN_ATOL = 4e-3
MODEL_ATOL = 1e-2


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
    cfg = LlamaConfig(**CFG)
    pm = QuantLlama(cfg, device="cpu", seed=1)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(from_jax_state(state, cfg))
    return jm, pm


def _quant_inputs(case):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 128)) * 3).astype(np.float32)
    if case == "zero_rows":
        x[0, 1] = 0.0
        x[2, :, 1] = 0.0
    elif case == "ties":
        # amax 127 -> scale exactly 1, so every x / scale is an exact .5
        # tie that round-half-to-even must settle the same way
        x = np.tile(np.arange(128, dtype=np.float32) - 63.5, (3, 5, 2, 1))
        x[..., 0] = 127.0
        x = x.astype(np.float16)
    return x


@pytest.mark.parametrize("case", ["normal", "zero_rows", "ties"])
def test_quantize_kv_bit_identical(case):
    x = _quant_inputs(case)
    jc, js = jkv.quantize_kv(jnp.asarray(x))
    pc, ps = pkv.quantize_kv(torch.from_numpy(x))
    assert pc.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert np.array_equal(ps.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))
    if case == "zero_rows":
        assert ps[0, 1].max().item() == 0 and pc[0, 1].abs().max() == 0


def test_write_prompt_and_append_token_quant_match_jax():
    rng = np.random.default_rng(1)
    kw = dict(num_slots=3, max_seq_len=32, num_kv_heads=2, head_dim=128,
              num_layers=2)
    jc = jkv.init_quant_kv_cache(jkv.KVCacheConfig(**kw))
    pc = pkv.init_quant_kv_cache(pkv.KVCacheConfig(**kw), device="cpu")
    S = 20
    kp, vp = (rng.standard_normal((S, 2, 128)).astype(np.float32)
              for _ in range(2))
    jc = jkv.write_prompt_quant(jc, 1, 2, jnp.asarray(kp), jnp.asarray(vp))
    pkv.write_prompt_quant(pc, 1, 2, torch.from_numpy(kp),
                           torch.from_numpy(vp))
    slots = np.array([2, 0], np.int32)
    pos = np.array([S, 0], np.int32)
    kn, vn = (rng.standard_normal((2, 2, 128)).astype(np.float32)
              for _ in range(2))
    jout = jkv.append_token_quant(
        jc["k"][1], jc["v"][1], jc["k_scale"][1], jc["v_scale"][1],
        jnp.asarray(slots), jnp.asarray(pos), jnp.asarray(kn),
        jnp.asarray(vn))
    layer = [pc[n][1] for n in ("k", "v", "k_scale", "v_scale")]
    pout = pkv.append_token_quant(*layer, torch.from_numpy(slots),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(kn), torch.from_numpy(vn))
    for want, got, t in zip(jout, pout, layer):
        assert got.data_ptr() == t.data_ptr()             # in place
        assert np.array_equal(got.numpy(), np.asarray(want))


def _attention_inputs(seed, D, H, Hkv):
    """Codes and scales of K amplified 20x (so a head mix-up shows) and
    of V; stale rows past each length hold extreme codes and huge
    scales."""
    rng = np.random.default_rng(seed)
    B, rows, Smax = 3, 5, 256
    q = rng.standard_normal((B, H, D)).astype(np.float16)
    k = rng.standard_normal((rows, Smax, Hkv, D)).astype(np.float32) * 20
    v = rng.standard_normal((rows, Smax, Hkv, D)).astype(np.float32)
    (kc, ks), (vc, vs) = (
        tuple(np.asarray(a) for a in jkv.quantize_kv(jnp.asarray(x)))
        for x in (k, v))
    kc, vc, ks, vs = (np.array(a) for a in (kc, vc, ks, vs))
    lengths = np.array([1, 37, 200], np.int32)
    slots = np.array([4, 0, 2], np.int32)
    for b in range(B):
        kc[slots[b], lengths[b]:] = 127
        vc[slots[b], lengths[b]:] = -128
        ks[slots[b], lengths[b]:] = 1e4
        vs[slots[b], lengths[b]:] = 1e4
    return q, kc, vc, ks, vs, lengths, slots


@pytest.mark.parametrize("D,H,Hkv,jax_flash", [
    (128, 2, 2, True), (128, 8, 2, True), (128, 8, 1, False),
    (64, 4, 2, False)])
def test_decode_attention_quant_matches_jax(D, H, Hkv, jax_flash):
    """D = 128 routes the port to flash_decode_quant (its plain version on
    the CPU), held against JAX's kernel (interpret mode) and its XLA path;
    D = 64 takes the plain version on both sides."""
    q, kc, vc, ks, vs, lengths, slots = _attention_inputs(D + H, D, H, Hkv)
    want = jkv.decode_attention_quant(
        *(jnp.asarray(a) for a in (q, kc, vc, ks, vs, slots, lengths)),
        num_heads=H, use_flash=jax_flash)
    got = pkv.decode_attention_quant(
        *(torch.from_numpy(a) for a in (q, kc, vc, ks, vs, slots, lengths)),
        num_heads=H)
    assert got.dtype == torch.float16
    assert_close(got, np.asarray(want), rtol=0.0, atol=ATTN_ATOL,
                 max_mismatched_ratio=0.0)


def test_flash_decode_quant_plain_nan_stale_scales_and_zero_length():
    q, kc, vc, ks, vs, lengths, slots = _attention_inputs(3, 128, 4, 2)
    lengths[0] = 0
    for b in range(3):
        ks[slots[b], lengths[b]:] = np.nan
        vs[slots[b], lengths[b]:] = np.nan
    t = [torch.from_numpy(a) for a in (q, kc, vc, ks, vs, lengths, slots)]
    out = flash_decode_quant(*t)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    # against a direct softmax over the dequantized valid rows
    b, L = 2, int(lengths[2])
    k = t[1][slots[b], :L].float() * t[3][slots[b], :L, :, None]
    v = t[2][slots[b], :L].float() * t[4][slots[b], :L, :, None]
    qf = t[0][b].float().reshape(2, 2, 128)
    s = torch.einsum("hgd,lhd->hgl", qf, k) / np.sqrt(128.0)
    want = torch.einsum("hgl,lhd->hgd", torch.softmax(s, -1), v)
    assert_close(out[b], want.reshape(4, 128), rtol=0.0, atol=ATTN_ATOL,
                 max_mismatched_ratio=0.0)


def test_flash_decode_quant_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((2, 4, 128), dtype=torch.float16)
    codes = torch.zeros((2, 16, 2, 128), dtype=torch.int8)
    sc = torch.zeros((2, 16, 2))
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):                # bf16 cache
        flash_decode_quant(q, codes.bfloat16(), codes.bfloat16(), sc, sc,
                           idx, idx)
    with pytest.raises(ValueError):                # f16 scales
        flash_decode_quant(q, codes, codes, sc.half(), sc.half(), idx, idx)
    # a GQA group of 16 is served (the kernel chunks it; here the plain
    # version runs), as JAX serves it
    q16 = torch.zeros((2, 32, 128), dtype=torch.float16)
    assert torch.equal(
        flash_decode_quant(q16, codes, codes, sc, sc, idx + 3, idx),
        flash_decode_quant_plain(q16, codes, codes, sc, sc, idx + 3, idx))
    out = flash_decode_quant_plain(q, codes, codes, sc, sc, idx + 3, idx)
    assert torch.equal(out, torch.zeros_like(out))   # zero rows, scale 0


def test_decode_step_quant_matches_jax(pair):
    jm, pm = pair
    rng = np.random.default_rng(4)
    L, B, S, Lmax = 2, 2, 9, 16
    hist_k = rng.standard_normal((L, B, S, 1, 128)).astype(np.float32)
    hist_v = rng.standard_normal((L, B, S, 1, 128)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jkv.quantize_kv(jnp.asarray(hist_k)))
    vq, vs = (np.asarray(a) for a in jkv.quantize_kv(jnp.asarray(hist_v)))
    caches = []
    for codes, scales in ((kq, ks), (vq, vs)):
        c = np.zeros((L, B, Lmax, 1, 128), np.int8)
        c[:, :, :S] = codes
        sc = np.zeros((L, B, Lmax, 1), np.float32)
        sc[:, :, :S] = scales
        caches += [c, sc]
    jstate = [jnp.asarray(caches[i]) for i in (0, 2, 1, 3)]
    pstate = [torch.from_numpy(caches[i].copy()) for i in (0, 2, 1, 3)]
    slots = np.arange(B, dtype=np.int32)
    for step in range(2):
        x = (rng.standard_normal((B, 1, H)) * 0.05).astype(np.float16)
        lengths = np.full((B,), S + step, np.int32)
        jout = jm.decode_step_quant(jnp.asarray(x), *jstate,
                                    jnp.asarray(slots), jnp.asarray(lengths))
        pout = pm.decode_step_quant(torch.from_numpy(x), *pstate,
                                    torch.from_numpy(slots),
                                    torch.from_numpy(lengths))
        jstate = list(jout[1:])
        assert all(a is b for a, b in zip(pout[1:], pstate))   # in place
        assert_close(pout[0], np.asarray(jout[0]), rtol=0.0,
                     atol=MODEL_ATOL, max_mismatched_ratio=0.0,
                     msg=f"step {step}")


def test_hidden_state_engine_kv_quant_matches_jax(pair):
    jm, pm = pair
    rng = np.random.default_rng(5)
    prompts = [(rng.standard_normal((n, H)) * 0.05).astype(np.float16)
               for n in (9, 30, 5)]
    je = _synchronous(JaxEngine(jm, num_slots=2, max_seq_len=64,
                                kv_quant=True))
    pe = ContinuousBatchingEngine(pm, num_slots=2, max_seq_len=64,
                                  kv_quant=True)
    for i, p in enumerate(prompts):
        je.submit(JaxRequest(uid=i, prompt=p, max_new=3 + i))
        pe.submit(Request(uid=i, prompt=p, max_new=3 + i))
    want = {r.uid: (r.slot, r.final_hidden) for r in je.run_to_completion()}
    got = {r.uid: (r.slot, r.final_hidden) for r in pe.run_to_completion()}
    assert pe.caches_k.dtype == torch.int8
    assert sorted(got) == [0, 1, 2]
    for uid in got:
        assert got[uid][0] == want[uid][0]                  # same slots
        assert_close(got[uid][1], want[uid][1], rtol=0.0, atol=MODEL_ATOL,
                     max_mismatched_ratio=0.0)


def test_engine_kv_quant_tracks_float_engine(pair):
    """The port of JAX's own check (tests/test_quant_kv_cache.py): int8 KV
    final hiddens stay within int8 quantization error of the float
    cache's."""
    _, pm = pair
    outs = {}
    for quant in (False, True):
        eng = ContinuousBatchingEngine(pm, num_slots=3, max_seq_len=32,
                                       kv_quant=quant)
        rng = np.random.default_rng(7)
        for i in range(4):
            S = int(rng.integers(2, 9))
            eng.submit(Request(uid=i, prompt=rng.standard_normal(
                (S, H)).astype(np.float16), max_new=int(rng.integers(2, 4))))
        done = eng.run_to_completion(max_steps=100)
        assert len(done) == 4 and all(r.done for r in done)
        outs[quant] = {r.uid: r.final_hidden for r in done}
    for uid in outs[False]:
        assert_close(outs[True][uid], outs[False][uid], rtol=5e-2, atol=0.3)

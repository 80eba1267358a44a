"""Chunked prefill (`decode_chunk`, `prefill_chunk`) and the ring cache
(`kv_ring`) in the port, on the CPU: the single-device cases of the JAX
package's tests/test_decode_chunk.py and tests/test_ring_cache.py run on
the port's functions, and the port's chunk and ring functions, its
decode_chunk and its engines held against the JAX package's on the same
inputs.

Fixture: hidden 256, 4 heads / 2 KV heads (head dim 64: every attend is
plain PyTorch, as JAX's are XLA), 2 layers, sliding window 6, ring
capacity 8. K is amplified 20x in the cache-level cases so that a wrong
attended set cannot hide in a near-uniform softmax.

Tolerances: the JAX tests' own (ring against the masked full cache 1e-5
in float32; model-level 2e-2 and 3e-2; the engine 5e-2 / 0.3, sized
there for ~19 bfloat16 decode steps). Port against JAX: the cache-level
attends 1e-5 (the same float32 operations), the ring appends' int8 codes
bit for bit; model and engine hidden states (|.| < 2) 2e-2, a few
float16 roundings, and the int8 codes of the model's K within 1.
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
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.serving.engine import (ContinuousBatchingEngine,
                                              Request)
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


WINDOW = 6
LMAX = 64          # full-cache capacity (the memory the ring saves)
R = 8              # ring capacity >= WINDOW
Hkv, H, D = 2, 4, 8
MCFG = dict(hidden_size=256, intermediate_size=512, num_heads=4,
            num_kv_heads=2, num_layers=2, vocab_size=64, group_size=128,
            sliding_window=WINDOW)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol, msg=""):
    assert_close(got.float() if isinstance(got, torch.Tensor) else got,
                 np.asarray(want, np.float32), rtol=tol, atol=tol,
                 max_mismatched_ratio=0.0, msg=msg)


# -- cache level ---------------------------------------------------------------

def test_ring_capacity_formula():
    assert pkv.ring_capacity(4096, 1) == 4096
    assert pkv.ring_capacity(4096, 256) == pkv.ring_capacity(4096 + 255,
                                                             1) == 4352
    assert pkv.ring_capacity(5, 1, align=1) == 5


def test_ring_abs_positions_matches_reference():
    for length in [0, 1, 5, 8, 9, 23]:
        got = pkv.ring_abs_positions(torch.tensor([length],
                                                  dtype=torch.int32), R)[0]
        want = np.full(R, -1)
        for p in range(length):          # increasing: newest write wins
            want[p % R] = p
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"len={length}")
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jkv.ring_abs_positions(jnp.asarray([length], jnp.int32), R))[0])


def _fill(rng, lengths, quant=False):
    """The same token stream appended token by token into a full cache and
    a ring (port), float32 or int8; returns the caches, the slots and the
    stream."""
    B = len(lengths)
    dt = torch.int8 if quant else torch.float32
    full = [torch.zeros((B, LMAX, Hkv, D), dtype=dt) for _ in range(2)]
    ring = [torch.zeros((B, R, Hkv, D), dtype=dt) for _ in range(2)]
    if quant:
        full += [torch.zeros((B, LMAX, Hkv)) for _ in range(2)]
        ring += [torch.zeros((B, R, Hkv)) for _ in range(2)]
    slots = torch.arange(B, dtype=torch.int32)
    stream = []
    for p in range(max(lengths)):
        k = rng.standard_normal((B, Hkv, D)).astype(np.float32) * 20
        v = rng.standard_normal((B, Hkv, D)).astype(np.float32)
        stream.append((k, v))
        live = [b for b in range(B) if p < lengths[b]]
        s = slots[live]
        pos = torch.full((len(live),), p, dtype=torch.int32)
        kt, vt = _t(k[live]), _t(v[live])
        if quant:
            pkv.append_token_quant(*full, s, pos, kt, vt)
            pkv.append_token_ring_quant(*ring, s, pos, kt, vt)
        else:
            pkv.append_token(*full, s, pos, kt, vt)
            pkv.append_token_ring(*ring, s, pos, kt, vt)
    return full, ring, slots, stream


@pytest.mark.parametrize("lengths", [(3, 2), (7, 5), (9, 8), (23, 17)])
def test_ring_decode_matches_masked_full(lengths):
    """Same attended set below, at, and well past the wrap point; and the
    port's ring attend against JAX's on the same ring."""
    rng = np.random.default_rng(0)
    full, ring, slots, _ = _fill(rng, lengths)
    q = _t(rng.standard_normal((len(lengths), H, D)).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = pkv.decode_attention(q, *full, slots, lens, num_heads=H,
                                window=WINDOW)
    got = pkv.ring_decode_attention(q, *ring, slots, lens, num_heads=H,
                                    window=WINDOW)
    _close(got, want, 1e-5)
    jax_ring = jkv.ring_decode_attention(
        jnp.asarray(q.numpy()), *(jnp.asarray(x.numpy()) for x in ring),
        jnp.asarray(slots.numpy()), jnp.asarray(lens.numpy()), num_heads=H,
        window=WINDOW)
    _close(got, jax_ring, 1e-5)


def test_ring_decode_quant_matches_masked_full():
    rng = np.random.default_rng(3)
    lengths = (19, 11)
    full, ring, slots, _ = _fill(rng, lengths, quant=True)
    q = _t(rng.standard_normal((2, H, D)).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = pkv.decode_attention_quant(q, *full, slots, lens, num_heads=H,
                                      window=WINDOW)
    got = pkv.ring_decode_attention_quant(q, *ring, slots, lens,
                                          num_heads=H, window=WINDOW)
    _close(got, want, 1e-5)
    jax_ring = jkv.ring_decode_attention_quant(
        jnp.asarray(q.numpy()), *(jnp.asarray(x.numpy()) for x in ring),
        jnp.asarray(slots.numpy()), jnp.asarray(lens.numpy()), num_heads=H,
        window=WINDOW)
    _close(got, jax_ring, 1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_ring_chunk_matches_masked_full(quant):
    """Chunked append + attention on the ring against the full-cache
    windowed chunk path, the chunk straddling the wrap point; the port's
    appends and attends against JAX's on the same caches (int8 codes and
    scales bit for bit)."""
    rng = np.random.default_rng(1 + 11 * quant)
    T, B = 3, 2                          # R = 8 >= WINDOW + T - 1 = 8
    starts = (6, 10)
    full, ring, slots, _ = _fill(rng, starts, quant)
    jring = [jnp.asarray(x.numpy()) for x in ring]
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32) * 20
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    q = _t(rng.standard_normal((B, T, H, D)).astype(np.float32))
    st = torch.tensor(starts, dtype=torch.int32)
    sfx = "_quant" if quant else ""
    getattr(pkv, "append_chunk" + sfx)(*full, slots, st, _t(k), _t(v))
    getattr(pkv, "append_chunk_ring" + sfx)(*ring, slots, st, _t(k), _t(v))
    want = getattr(pkv, "chunk_attention" + sfx)(
        q, *full, slots, st, num_heads=H, window=WINDOW)
    got = getattr(pkv, "ring_chunk_attention" + sfx)(
        q, *ring, slots, st, num_heads=H, window=WINDOW)
    _close(got, want, 1e-5)
    js, jst = jnp.asarray(slots.numpy()), jnp.asarray(st.numpy())
    jring = getattr(jkv, "append_chunk_ring" + sfx)(
        *jring, js, jst, jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(ring, jring):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jgot = getattr(jkv, "ring_chunk_attention" + sfx)(
        jnp.asarray(q.numpy()), *jring, js, jst, num_heads=H, window=WINDOW)
    _close(got, jgot, 1e-5)
    jfull = getattr(jkv, "chunk_attention" + sfx)(
        jnp.asarray(q.numpy()), *(jnp.asarray(x.numpy()) for x in full), js,
        jst, num_heads=H, window=WINDOW)
    _close(want, jfull, 1e-5)


def test_ring_chunk_eviction_guard():
    rng = np.random.default_rng(2)
    T = 4                                # WINDOW + T - 1 = 9 > R = 8
    rk = torch.zeros((1, R, Hkv, D))
    q = _t(rng.standard_normal((1, T, H, D)).astype(np.float32))
    zero = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="evict"):
        pkv.ring_chunk_attention(q, rk, rk.clone(), zero, zero, num_heads=H,
                                 window=WINDOW)
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        pkv.append_chunk_ring(rk, rk.clone(), zero, zero,
                              torch.zeros((1, R + 1, Hkv, D)),
                              torch.zeros((1, R + 1, Hkv, D)))


def test_init_ring_caches():
    cfg = pkv.KVCacheConfig(num_slots=2, max_seq_len=8192, num_kv_heads=8,
                            head_dim=128, num_layers=1)
    c = pkv.init_ring_kv_cache(cfg, 4096, 256, device="cpu")
    assert tuple(c["k"].shape) == (1, 2, 4352, 8, 128)
    assert c["k"].dtype == torch.bfloat16
    cq = pkv.init_ring_quant_kv_cache(cfg, 4096, 256, device="cpu")
    assert cq["k"].dtype == torch.int8
    assert tuple(cq["k_scale"].shape) == (1, 2, 4352, 8)
    small = pkv.KVCacheConfig(num_slots=1, max_seq_len=100, num_kv_heads=1,
                              head_dim=8, num_layers=1)
    assert pkv.init_ring_kv_cache(small, 4096, device="cpu")["k"] \
        .shape[2] == 100


# -- model level ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The JAX model and the port's with its weights."""
    jm = JaxQuantLlama(JaxLlamaConfig(**MCFG), opt_m=(1, 4, 8, 16))
    cfg = LlamaConfig(**MCFG)
    pm = QuantLlama(cfg, device="cpu", seed=99)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(from_jax_state(state, cfg))
    return jm, pm


def _caches(rows, quant=False, B=2):
    shape = (MCFG["num_layers"], B, rows, MCFG["num_kv_heads"], 64)
    if quant:
        return [torch.zeros(shape, dtype=torch.int8),
                torch.zeros(shape, dtype=torch.int8),
                torch.zeros(shape[:-1]), torch.zeros(shape[:-1])]
    return [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]


def _x(rng, shape, scale=0.1):
    return _t((rng.standard_normal(shape) * scale).astype(np.float16))


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_of_one_matches_decode_step(pair, quant):
    """decode_chunk with T = 1 is decode_step (int8: the same codes), and
    the port's decode_chunk matches JAX's on the same caches."""
    jm, pm = pair
    rng = np.random.default_rng(5 if quant else 0)
    pre = (rng.standard_normal((2, 2, 5, 2, 64)) * 0.1).astype(np.float32)
    caches = _caches(16, quant)
    if quant:
        caches[0][:, :, :5], caches[2][:, :, :5] = pkv.quantize_kv(_t(pre))
        caches[1][:, :, :5], caches[3][:, :, :5] = pkv.quantize_kv(
            _t(pre[::-1]))
    else:
        caches[0][:, :, :5] = _t(pre).to(torch.bfloat16)
        caches[1][:, :, :5] = _t(pre[::-1]).to(torch.bfloat16)
    x = _x(rng, (2, 1, 256))
    slots = torch.arange(2, dtype=torch.int32)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    jc = [jnp.asarray(c.float().numpy() if c.dtype == torch.bfloat16
                      else c.numpy()) for c in caches]
    if not quant:
        jc = [c.astype(jnp.bfloat16) for c in jc]
    step = pm.decode_step_quant if quant else pm.decode_step
    chunk = pm.decode_chunk_quant if quant else pm.decode_chunk
    one = [c.clone() for c in caches]
    y1, *c1 = step(x, *one, slots, lengths)
    y2, *c2 = chunk(x, *caches, slots, lengths)
    _close(y2, y1.float().numpy(), 2e-2)
    if quant:
        assert torch.equal(c2[0], c1[0])
        _close(c2[2], c1[2].numpy(), 1e-5)
    else:
        _close(c2[0], c1[0].float().numpy(), 2e-2)
    jchunk = jm.decode_chunk_quant if quant else jm.decode_chunk
    jy, *jcs = jchunk(jnp.asarray(x.numpy()), *jc,
                      jnp.asarray(slots.numpy()), jnp.asarray(lengths.numpy()))
    _close(y2, jy, 2e-2)
    if quant:   # codes of K that the two packages round a few f16 ulps apart
        assert np.abs(c2[0].numpy().astype(np.int32)
                      - np.asarray(jcs[0], np.int32)).max() <= 1


def test_chunked_prefill_matches_one_shot(pair):
    _, pm = pair
    rng = np.random.default_rng(1)
    x_full = _x(rng, (1, 8, 256))
    positions = torch.arange(8)[None]
    h_full, ks_full, _ = pm.make_prefill(8)(x_full, positions)
    _, ks1, vs1 = pm.make_prefill(4)(x_full[:, :4], positions[:, :4])
    ck, cv = _caches(16)
    for li in range(MCFG["num_layers"]):
        ck[li, 0, :4] = ks1[li].to(torch.bfloat16)
        cv[li, 0, :4] = vs1[li].to(torch.bfloat16)
    h2, ck, cv = pm.decode_chunk(x_full[:, 4:], ck, cv,
                                 torch.zeros((1,), dtype=torch.int32),
                                 torch.tensor([4], dtype=torch.int32))
    _close(h2[0], h_full[0, 4:].float().numpy(), 3e-2)
    for li in range(MCFG["num_layers"]):
        _close(ck[li, 0, :8], ks_full[li].to(torch.bfloat16).float().numpy(),
               3e-2)


def test_chunk_respects_per_slot_starts(pair):
    """Two slots with different prefix lengths write to their own offsets
    and never read each other's tokens."""
    _, pm = pair
    rng = np.random.default_rng(2)
    ck, cv = _caches(16)
    x = _x(rng, (2, 2, 256))
    _, ck2, _ = pm.decode_chunk(x, ck, cv, torch.arange(2, dtype=torch.int32),
                                torch.tensor([3, 6], dtype=torch.int32))
    w = ck2.float()
    assert w[:, 0, 3:5].abs().max() > 0
    assert w[:, 0, 5:].abs().max() == 0
    assert w[:, 1, 6:8].abs().max() > 0
    assert w[:, 1, :6].abs().max() == 0


@pytest.mark.parametrize("quant", [False, True])
def test_model_ring_decode_matches_full(pair, quant):
    """decode_step chains on the window-sized ring equal the masked
    full-length cache, through several wraps (int8: R + 4 steps)."""
    _, pm = pair
    rng = np.random.default_rng(6 if quant else 4)
    B, steps = (1, R + 4) if quant else (2, 2 * R + 3)
    full, ring = _caches(LMAX, quant, B), _caches(R, quant, B)
    step = pm.decode_step_quant if quant else pm.decode_step
    slots = torch.arange(B, dtype=torch.int32)
    for i in range(steps):
        x = _x(rng, (B, 1, 256), 0.5)
        lens = torch.full((B,), i, dtype=torch.int32)
        yf = step(x, *full, slots, lens)[0]
        yr = step(x, *ring, slots, lens, ring=True)[0]
        _close(yr, yf.float().numpy(), 2e-2, f"step {i}")


def test_model_ring_chunk_matches_full_and_jax(pair):
    """A chunk after one wrap on the ring equals the full cache, and the
    port's ring decode_chunk equals JAX's on the same history."""
    jm, pm = pair
    rng = np.random.default_rng(5)
    B, T, start = 1, 3, R + 1
    full, ring = _caches(LMAX, B=B), _caches(R, B=B)
    slots = torch.zeros((B,), dtype=torch.int32)
    for i in range(start):               # identical decode_step warmup
        x = _x(rng, (B, 1, 256), 0.5)
        lens = torch.full((B,), i, dtype=torch.int32)
        pm.decode_step(x, *full, slots, lens)
        pm.decode_step(x, *ring, slots, lens, ring=True)
    jring = [jnp.asarray(c.float().numpy()).astype(jnp.bfloat16)
             for c in ring]
    x = _x(rng, (B, T, 256), 0.5)
    lens = torch.full((B,), start, dtype=torch.int32)
    yf = pm.decode_chunk(x, *full, slots, lens)[0]
    yr = pm.decode_chunk(x, *ring, slots, lens, ring=True)[0]
    _close(yr, yf.float().numpy(), 2e-2)
    jy = jm.decode_chunk(jnp.asarray(x.numpy()), *jring,
                         jnp.asarray(slots.numpy()),
                         jnp.asarray(lens.numpy()), ring=True)[0]
    _close(yr, jy, 2e-2)


def test_model_ring_requires_window():
    cfg = LlamaConfig(**dict(MCFG, num_layers=1, sliding_window=None))
    m = QuantLlama(cfg, device="cpu")
    ck, cv = _caches(R, B=1)
    x = torch.zeros((1, 1, 256), dtype=torch.float16)
    zero = torch.zeros((1,), dtype=torch.int32)
    for fn in (m.decode_step, m.decode_chunk):
        with pytest.raises(ValueError, match="sliding_window"):
            fn(x, ck[:1], cv[:1], zero, zero, ring=True)


# -- engines -------------------------------------------------------------------

def _synchronous(engine):
    """A JAX engine whose steps finish before they return (see
    tests/test_torch_serving.py); the chunk step too."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


def _requests(n=4, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        S = int(rng.integers(2, 9))
        out.append((i, (rng.standard_normal((S, 256)) * 0.5)
                    .astype(np.float16), int(rng.integers(12, 20))))
    return out


def _run(engine, reqs, cls):
    for uid, prompt, max_new in reqs:
        engine.submit(cls(uid=uid, prompt=prompt, max_new=max_new))
    finished = engine.run_to_completion(max_steps=200)
    assert len(finished) == len(reqs) and all(r.done for r in finished)
    return {r.uid: np.asarray(r.final_hidden, np.float32) for r in finished}


def test_engine_kv_ring_tracks_plain(pair):
    """The engine with the window-sized ring matches the full-length masked
    engine on identical request streams, through ring wraps and slot reuse
    (4 requests over 2 slots: released slots leave stale ring rows that
    the derived-position mask must hide)."""
    _, pm = pair
    reqs = _requests()
    outs, shapes = {}, {}
    for use_ring in (False, True):
        eng = ContinuousBatchingEngine(
            pm, num_slots=2, max_seq_len=64, prefill_chunk=3,
            kv_ring=use_ring, kv_ring_capacity=16 if use_ring else None)
        outs[use_ring] = _run(eng, reqs, Request)
        shapes[use_ring] = eng.caches_k.shape
    assert shapes[True][2] == 16 and shapes[False][2] == 64
    for uid in outs[False]:
        assert_close(outs[True][uid], outs[False][uid], rtol=5e-2, atol=0.3,
                     max_mismatched_ratio=0.0, msg=f"uid {uid}")


@pytest.mark.parametrize("kw", [
    {"prefill_chunk": 3},
    {"prefill_chunk": 3, "kv_ring": True, "kv_ring_capacity": 16},
    {"prefill_chunk": 3, "kv_quant": True, "kv_ring": True,
     "kv_ring_capacity": 16}])
def test_engine_chunked_prefill_and_ring_match_jax(pair, kw):
    """prefill_chunk (the zero-padded tail chunk included) and kv_ring,
    bfloat16 and int8, on the port's engine and on JAX's: the same final
    hidden states."""
    jm, pm = pair
    reqs = _requests(3, seed=9)
    je = _synchronous(JaxEngine(jm, num_slots=2, max_seq_len=64, **kw))
    pe = ContinuousBatchingEngine(pm, num_slots=2, max_seq_len=64, **kw)
    if kw.get("kv_ring"):
        assert pe.caches_k.shape[2] == 16
    want = _run(je, reqs, JaxRequest)
    got = _run(pe, reqs, Request)
    for uid in want:
        assert_close(got[uid], want[uid], rtol=0.0, atol=2e-2,
                     max_mismatched_ratio=0.0, msg=f"uid {uid}")


def test_engine_chunk_tail_at_the_last_row(pair):
    """A prompt whose zero-padded tail chunk would run past the slot
    cache's last row: the tail is cut there (JAX drops those writes), and
    the engine still serves it."""
    _, pm = pair
    rng = np.random.default_rng(10)
    prompt = (rng.standard_normal((31, 256)) * 0.5).astype(np.float16)
    eng = ContinuousBatchingEngine(pm, num_slots=1, max_seq_len=32,
                                   prefill_chunk=4)
    eng.submit(Request(uid=0, prompt=prompt, max_new=1))
    (req,) = eng.run_to_completion()
    assert req.done and np.isfinite(req.final_hidden).all()


def test_engine_kv_ring_guards(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatchingEngine(pm, num_slots=1, max_seq_len=64,
                                 kv_ring=True)
    with pytest.raises(ValueError, match="window \\+ prefill_chunk - 1"):
        ContinuousBatchingEngine(pm, num_slots=1, max_seq_len=64,
                                 prefill_chunk=4, kv_ring=True,
                                 kv_ring_capacity=8)
    nw = QuantLlama(LlamaConfig(**dict(MCFG, num_layers=1,
                                       sliding_window=None)), device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        ContinuousBatchingEngine(nw, num_slots=1, max_seq_len=64,
                                 prefill_chunk=3, kv_ring=True)

"""Sliding-window attention in the port against the JAX package, on the
CPU: kernel 4's plain version against JAX's banded flash walk
(`make_flash_attention(window=...)`), the split plain version of kernels
5 and 6 with the band plan against JAX's windowed decode kernels
(`make_flash_decode{,_quant}(window=...)`), all in interpret mode, and a
windowed 2-layer model's prefill and decode steps on the slot, int8 slot,
paged and int8 paged caches.

Windows 1, 63, 64, 65 and >= S: with 64-key tiles, 63 and 64 leave the
last rows of a q tile an all-masked first tile (the kernel's trap; here
the plain arithmetic must agree with JAX's either way), and in decode a
window moves each sequence's splits to its live band, so a split may hold
no live key at all (lengths up to 256 over 64-key splits).

Tolerances:
- prefill, float16: atol 4e-3 (tests/test_torch_flash.py: a few f16 ulps
  of |out| < 4); bfloat16: 2^-5, two bfloat16 roundings (JAX rounds P to
  bfloat16 before P V; both round the output) of |out| < 4 at 2^-8 each;
- decode: against JAX atol 1e-2, as tests/test_torch_flash_split.py (K
  amplified 20x, f32 dot products in other orders; JAX rounds P); a
  bfloat16 query adds one bfloat16 rounding of |out| < 4 (2^-6 in all);
- prefill and decode against JAX, element by element as well
  (testing.attention_err): one ulp of the output type (2^-10 float16,
  2^-7 bfloat16) of |want| plus 4 ulps of the row's rms. JAX rounds P to
  the output type before P V and the port's plain versions keep it in
  float32: a sum of per-key roundings whose size follows the row, not
  the element (worst 0.49 of the limit in prefill, 0.85 in decode, where
  K amplified 20x leaves a few keys to carry each row). The absolute
  limits alone would let band rows, which average up to `window` keys
  and are small, be wrong by their own size;
- decode, against the single-pass plain version 4e-3 (float16 queries),
  the same arithmetic regrouped by chunk;
- the model: logits of |.| < 3 within 1e-2 (tests/test_torch_serving.py's
  float16 model).
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.kernels.flash import (make_flash_attention,
                                       make_flash_decode,
                                       make_flash_decode_quant)
from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.serving import kv_cache as jkv

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.kernels.flash import (
    DECODE_TILE, decode_span, flash_attention_fwd, flash_attention_plain,
    flash_decode, flash_decode_quant, flash_decode_split_plain,
    plan_splits)
from bitblas_tpu_torch.models.hf_import import LMHead
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.testing import ATTN_ULP, assert_close, attention_err


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


D, SMS = 128, 132
BF16 = 2.0 ** -8
PREFILL_ATOL = {"float16": 4e-3, "bfloat16": 8 * BF16}
DECODE_ATOL = {"float16": 1e-2, "bfloat16": 4 * BF16}
WINDOWS = (1, 63, 64, 65, 10 ** 6)


def _err(got: torch.Tensor, want: np.ndarray) -> float:
    """attention_err with a floor of 4 ulps of each row's rms: JAX rounds
    P to the output type before P V, the port's plain versions keep it in
    float32."""
    u = ATTN_ULP[got.dtype]
    return attention_err(got, torch.from_numpy(want), u, 4 * u)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype,S", [("float16", 128), ("bfloat16", 128),
                                     ("bfloat16", 256)])
def test_windowed_prefill_matches_jax(dtype, S, window):
    rng = np.random.default_rng(S + window % 1000)
    Q, K, V = (rng.standard_normal((1, S, h, D)).astype(np.float32)
               for h in (2, 1, 1))
    K *= 3
    fn = make_flash_attention(batch=1, heads=2, seq_len=S, dim=D,
                              kv_heads=1, causal=True, block_q=64,
                              block_kv=64, out_dtype=jnp.dtype(dtype),
                              window=min(window, S), interpret=True)
    want = np.asarray(fn(*(jnp.asarray(a, dtype) for a in (Q, K, V))),
                      np.float32)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (Q, K, V)]
    got = flash_attention_fwd(*t, window=window)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, rtol=0.0, atol=PREFILL_ATOL[dtype],
                 max_mismatched_ratio=0.0)
    assert _err(got, want) <= 1.0
    full = flash_attention_fwd(*t)
    if window >= S:          # a window >= S is no window, bit for bit
        assert torch.equal(got, full)
        assert torch.equal(flash_attention_plain(*t, window), full)
    else:                    # row i attends i - window + 1 .. i only
        assert not torch.equal(got, full)
        if window == 1:
            assert_close(got[0, :, 0], t[2][0, :, 0].float().numpy(),
                         rtol=0.0, atol=0.0, max_mismatched_ratio=0.0)


def test_attention_err_holds_band_rows_to_their_size():
    """The limit follows each row: band rows of a windowed prefill (S =
    1024, window 512) average 512 keys and are about 0.07; the same
    output with those rows off by 1/16 stays within 2^-5 absolute, the
    bfloat16 prefill's absolute limit, but not within attention_err's."""
    g = torch.Generator().manual_seed(0)
    Q, K, V = (torch.randn((1, 1024, h, D), generator=g).to(torch.bfloat16)
               for h in (4, 2, 2))
    ref = flash_attention_plain(Q, K, V, 512)
    bad = ref.clone()
    bad[:, 512:] = (ref[:, 512:].float() * (1 + 2.0 ** -4)).to(ref.dtype)
    u = ATTN_ULP[torch.bfloat16]
    assert (bad.float() - ref.float()).abs().max().item() <= 2.0 ** -5
    assert attention_err(ref, ref, u, 4 * u) == 0.0
    assert attention_err(bad, ref, u, 4 * u) > 1.0


def _decode_case(quant, window, Smax, seed, stale):
    """Slot-cache operands (numpy) with lengths around the window: 0 / 1,
    window - 1, window, window + 1, and Smax; rows past each length hold
    `stale`."""
    rng = np.random.default_rng(seed)
    w = min(window, Smax)
    lengths = np.array(sorted({1, max(w - 1, 0), w, min(w + 1, Smax), 200,
                               Smax}), np.int32)
    B, Hkv, H = len(lengths), 2, 8
    rows = B + 1
    slots = rng.permutation(rows)[:B].astype(np.int32)
    shape = (rows, Smax, Hkv, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.2 + 0.05).astype(np.float32) * 20
        vs = (rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32)
        planes = [(k, 127), (v, -128), (ks, stale), (vs, stale)]
        caches = [k, v, ks, vs]
    else:
        k = (rng.standard_normal(shape) * 20).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        planes = [(k, stale), (v, -stale)]
        caches = [k, v]
    for x, val in planes:
        for b, n in enumerate(lengths):
            x[slots[b], n:] = val
    return q, caches, slots, lengths


def _port(q, caches, dtype, quant):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in caches]
    if not quant:
        t = [x.to(torch.bfloat16) for x in t]
    return torch.from_numpy(q).to(getattr(torch, dtype)), t


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("quant", [False, True])
def test_windowed_decode_split_plain_matches_jax(quant, window):
    """Kernels 5 and 6's split arithmetic with the band plan (splits from
    64 floor((len - window) / 64), a span of min(Smax, window + 64) keys)
    against JAX's windowed decode kernel, float16 and bfloat16 queries."""
    Smax = 256
    q, caches, slots, lengths = _decode_case(quant, window, Smax, 3, 1e4)
    maker = make_flash_decode_quant if quant else make_flash_decode
    jc = caches if quant else [c.astype(ml_dtypes.bfloat16) for c in caches]
    for dtype in ("float16", "bfloat16"):
        fn = maker(batch=len(lengths), heads=q.shape[1], max_seq_len=Smax,
                   dim=D, kv_heads=2, block_kv=64,
                   out_dtype=jnp.dtype(dtype), window=window,
                   interpret=True)
        want = np.asarray(fn(jnp.asarray(q, dtype),
                             *(jnp.asarray(c) for c in jc),
                             jnp.asarray(lengths), jnp.asarray(slots)),
                          np.float32)
        tq, tc = _port(q, caches, dtype, quant)
        scales = dict(k_scale=tc[2], v_scale=tc[3]) if quant else {}
        got = flash_decode_split_plain(
            tq, tc[0], tc[1], torch.from_numpy(lengths),
            torch.from_numpy(slots), window=window, sms=SMS, **scales)
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, rtol=0.0, atol=DECODE_ATOL[dtype],
                     max_mismatched_ratio=0.0, msg=dtype)
        assert _err(got, want) <= 1.0, dtype


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("quant", [False, True])
def test_windowed_decode_wrappers_match_split_plain(quant, window):
    """The wrappers' single-pass plain version (what runs on the CPU)
    against the split one, with NaN in every row past each length: the
    band plan reads no such row, and a split with no live key weighs 0.
    A window >= Smax gives the windowless call bit for bit."""
    Smax = 256
    q, caches, slots, lengths = _decode_case(quant, window, Smax, 4,
                                             float("nan"))
    tq, tc = _port(q, caches, "float16", quant)
    lens, sl = torch.from_numpy(lengths), torch.from_numpy(slots)
    if quant:
        single = flash_decode_quant(tq, *tc, lens, sl, window=window)
        split = flash_decode_split_plain(tq, tc[0], tc[1], lens, sl,
                                         k_scale=tc[2], v_scale=tc[3],
                                         window=window, sms=SMS)
        full = flash_decode_quant(tq, *tc, lens, sl)
    else:
        single = flash_decode(tq, *tc, lens, sl, window=window)
        split = flash_decode_split_plain(tq, *tc, lens, sl, window=window,
                                         sms=SMS)
        full = flash_decode(tq, *tc, lens, sl)
    assert torch.isfinite(split).all() and torch.isfinite(single).all()
    assert_close(split, single.float().numpy(), rtol=0.0, atol=4e-3,
                 max_mismatched_ratio=0.0)
    if window >= Smax:
        assert torch.equal(single, full)
    # the band plan: a windowed sequence's splits cover at most window +
    # 64 keys, the first at the tile holding its first live key
    span = decode_span(Smax, None if window >= Smax else window)
    chunk, splits = plan_splits(span, len(lengths), 2, SMS)
    assert span == min(Smax, window + DECODE_TILE)
    for n in lengths.tolist():
        lo = max(n - window, 0)
        base = lo // DECODE_TILE * DECODE_TILE
        assert base <= lo < base + chunk
        assert n - base <= splits * chunk


def test_split_with_no_live_key_weighs_nothing():
    """A band plan whose last splits start past the length (a dead split,
    m = -inf, l = 0) and whose first tile is partly below the window: the
    split arithmetic equals a plain softmax over the window's keys."""
    rng = np.random.default_rng(7)
    Smax, window, n = 512, 65, 300
    q = rng.standard_normal((1, 4, D)).astype(np.float32)
    k = (rng.standard_normal((1, Smax, 1, D)) * 20).astype(np.float32)
    v = rng.standard_normal((1, Smax, 1, D)).astype(np.float32)
    k[0, n:] = v[0, n:] = np.nan
    tq, (tk, tv) = _port(q, [k, v], "float16", False)
    lens, sl = torch.tensor([n], dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)
    chunk, splits = plan_splits(decode_span(Smax, window), 1, 1, SMS)
    base = (n - window) // DECODE_TILE * DECODE_TILE
    assert base + (splits - 1) * chunk >= n      # the last split is dead
    got = flash_decode_split_plain(tq, tk, tv, lens, sl, window=window,
                                   sms=SMS)
    qs = tq.float() / math.sqrt(D)
    keys = tk[0, n - window:n, 0].float()
    p = torch.softmax(qs[0] @ keys.T, dim=-1)
    want = p @ tv[0, n - window:n, 0].float()
    assert_close(got[0], want.numpy(), rtol=0.0, atol=4e-3,
                 max_mismatched_ratio=0.0)


# -- a windowed model on all four caches ------------------------------------

V_, H_ = 64, 256
WINDOW = 48
MCFG = dict(hidden_size=H_, intermediate_size=512, num_heads=2,
            num_kv_heads=1, num_layers=2, vocab_size=V_, group_size=128,
            sliding_window=WINDOW)


def _synchronous_fn(fn):
    return lambda *a, **k: jax.block_until_ready(fn(*a, **k))


@pytest.fixture(scope="module")
def windowed():
    jm = JaxQuantLlama(JaxLlamaConfig(**MCFG), opt_m=(1, 2, 16))
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V_, H_)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V_, H_)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((H_,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = LlamaConfig(**MCFG)
    pm = QuantLlama(cfg, device="cpu", seed=123)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(from_jax_state(state, cfg))
    ph = LMHead(embed, np.ones(H_, np.float32), lm_head, device="cpu")
    # prefill a 200-token prompt at bucket 256: JAX's banded flash walk
    # and the port's windowed flash (plain version)
    S, bucket = 200, 256
    toks = np.random.default_rng(2).integers(0, V_, S)
    x = np.zeros((1, bucket, H_), np.float16)
    x[0, :S] = embed[toks]
    pos = np.arange(bucket)[None]
    jout = jm.make_prefill(bucket)(jnp.asarray(x), jnp.asarray(pos))
    pout = pm.make_prefill(bucket)(torch.from_numpy(x),
                                   torch.from_numpy(pos))
    return jm, jh, pm, ph, embed, S, jout, pout


def test_windowed_model_prefill_matches_jax(windowed):
    jm, jh, pm, ph, _, S, (jhid, _, _), (phid, _, _) = windowed
    assert_close(ph.logits(phid[:, :S]), np.asarray(jh.logits(jhid[:, :S])),
                 rtol=0.0, atol=1e-2, max_mismatched_ratio=0.0)
    # the window is live: the same model without it attends differently
    assert pm.cfg.sliding_window == WINDOW < S


def _slot(ks, vs, S, lmax, quant, lib):
    """A one-slot cache [L, 1, lmax, Hkv, D] holding the prompt's K/V."""
    L = len(ks)
    k = np.zeros((L, 1, lmax, 1, D), np.float32)
    v = np.zeros_like(k)
    k[:, 0, :S] = np.stack([np.asarray(x[:S], np.float32) for x in ks])
    v[:, 0, :S] = np.stack([np.asarray(x[:S], np.float32) for x in vs])
    return _cache_arrays(k, v, quant, lib)


def _cache_arrays(k, v, quant, lib):
    if lib == "jax":
        k, v = jnp.asarray(k), jnp.asarray(v)
        if quant:
            (kq, ksc), (vq, vsc) = jkv.quantize_kv(k), jkv.quantize_kv(v)
            return [kq, vq, ksc, vsc]
        return [k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)]
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    if quant:
        (kq, ksc), (vq, vsc) = pkv.quantize_kv(k), pkv.quantize_kv(v)
        return [kq, vq, ksc, vsc]
    return [k.to(torch.bfloat16), v.to(torch.bfloat16)]


@pytest.mark.parametrize("kind", ["slot", "slot_quant", "paged",
                                  "paged_quant"])
def test_windowed_decode_steps_match_jax(windowed, kind):
    """Teacher-forced decode steps past the window (prompt 200, window
    48) on each cache: the slot caches through kernels 5 / 6's plain
    versions with the window, the paged ones through the masked table
    gather (JAX's own route for a windowed paged decode)."""
    jm, jh, pm, ph, embed, S, (_, jks, jvs), (_, pks, pvs) = windowed
    quant = kind.endswith("quant")
    paged = kind.startswith("paged")
    lmax, bs = 264, 8
    jc = _slot(jks, jvs, S, lmax, quant, "jax")
    pc = _slot([x.float().numpy() for x in pks],
               [x.float().numpy() for x in pvs], S, lmax, quant, "torch")
    if paged:
        # the slot's rows as a block pool in a permuted table (block 0
        # reserved): pool[tables[j]] holds rows [j * bs, (j + 1) * bs)
        MB = lmax // bs
        perm = np.random.default_rng(5).permutation(np.arange(1, MB + 1))
        tables = perm[None].astype(np.int32)

        def pool(x, lib):
            rows = x[:, 0].reshape(x.shape[0], MB, bs, *x.shape[3:])
            if lib == "jax":
                out = jnp.zeros((x.shape[0], MB + 1, *rows.shape[2:]),
                                x.dtype)
                return out.at[:, perm].set(rows)
            out = torch.zeros((x.shape[0], MB + 1, *rows.shape[2:]),
                              dtype=x.dtype)
            out[:, torch.from_numpy(perm)] = rows
            return out

        jc = [pool(x, "jax") for x in jc]
        pc = [pool(x, "torch") for x in pc]
    jstep = {"slot": jm.decode_step, "slot_quant": jm.decode_step_quant,
             "paged": jm.decode_step_paged,
             "paged_quant": jm.decode_step_paged_quant}[kind]
    pstep = {"slot": pm.decode_step, "slot_quant": pm.decode_step_quant,
             "paged": pm.decode_step_paged,
             "paged_quant": pm.decode_step_paged_quant}[kind]
    gathers = (pkv.decode_attention_paged_quant if quant
               else pkv.decode_attention_paged).window_gathers
    for i, tok in enumerate((3, 17, 42)):
        xi = embed[[[tok]]]
        n = S + i
        if paged:
            where = (tables[:, n // bs], np.array([n % bs], np.int32))
            jargs = (jnp.asarray(tables), *(jnp.asarray(a) for a in where))
            pargs = (torch.from_numpy(tables),
                     *(torch.from_numpy(a) for a in where))
        else:
            jargs = (jnp.zeros((1,), jnp.int32),)
            pargs = (torch.zeros((1,), dtype=torch.int32),)
        lens = np.array([n], np.int32)
        jo = jstep(jnp.asarray(xi), *jc, *jargs, jnp.asarray(lens))
        po = pstep(torch.from_numpy(xi), *pc, *pargs, torch.from_numpy(lens))
        jc, pc = list(jo[1:]), list(po[1:])
        assert_close(ph.logits(po[0]), np.asarray(jh.logits(jo[0])),
                     rtol=0.0, atol=1e-2, max_mismatched_ratio=0.0,
                     msg=f"{kind} step {i}")
    if paged:   # every layer of every step took the windowed gather
        now = (pkv.decode_attention_paged_quant if quant
               else pkv.decode_attention_paged).window_gathers
        assert now - gathers == 3 * MCFG["num_layers"]


def test_mistral_config_maps_as_jax():
    """Mistral-7B-v0.1's config.json (its published fields) maps to the
    same LlamaConfig in both packages, window and bfloat16 included."""
    from bitblas_tpu.models.hf_import import \
        llama_config_from_hf as jax_config_from_hf
    from bitblas_tpu_torch.models.hf_import import llama_config_from_hf
    hf = {"architectures": ["MistralForCausalLM"], "model_type": "mistral",
          "hidden_size": 4096, "intermediate_size": 14336,
          "num_attention_heads": 32, "num_key_value_heads": 8,
          "num_hidden_layers": 32, "vocab_size": 32000,
          "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
          "sliding_window": 4096, "torch_dtype": "bfloat16",
          "max_position_embeddings": 32768}
    got = llama_config_from_hf(hf, group_size=128, act_dtype="bfloat16")
    want = jax_config_from_hf(hf, group_size=128, act_dtype="bfloat16")
    for f in ("hidden_size", "intermediate_size", "num_heads",
              "num_kv_heads", "num_layers", "vocab_size", "group_size",
              "act_dtype", "rope_theta", "rope_scaling", "attention_bias",
              "rms_norm_eps", "sliding_window"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.sliding_window == 4096 and got.head_dim == 128

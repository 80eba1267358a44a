"""Kernels 5 and 6 in partial_stats mode and the context-parallel half of
the slot cache (serving/kv_cache.py: the cp appends and the four
*_partial attends), against the JAX package on the CPU.

The wrappers' plain versions (`flash_decode(..., partial_stats=True)`,
`flash_decode_quant(..., partial_stats=True)` on CPU tensors) are held to
JAX's make_flash_decode{,_quant}(partial_stats=True) in interpret mode:
the unnormalised accumulator, m in the natural-log domain and l, over
shard-local lengths, an empty shard (length 0: m = -1e30 ln 2, l = 0)
included. The four *_partial attends against JAX's: the decode ones at
head dim 128 (the flash route on both sides) and 64 (JAX's XLA partial
and the port's plain one), the chunk ones (plain torch ops against XLA).
Two shards merged by log-sum-exp give the unsplit decode. On the card,
tests/test_torch_cuda_kernels.py holds the kernels to their plain
versions (test_partial_stats_kernels_match_plain).

Inputs: q f16, K amplified 20x (a head or shard mix-up cannot hide in a
flat softmax), GQA group 4, lengths {0, 1, 37, 64}.

Tolerances: m to 2^-18 of |m| plus 1e-3 (f32 sums of 128 products in
another order); acc and l relative to their largest value at 1e-2 (JAX's
interpret kernel rounds P to f16 before P V, the port keeps it in f32:
2^-11 a weight); the merge against the unsplit decode at 4e-3 (f32
arithmetic regrouped, then one f16 rounding of |out| < 4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import (make_flash_decode,
                                       make_flash_decode_quant)
from bitblas_tpu.serving import kv_cache as jkv

from bitblas_tpu_torch.kernels.flash import (EMPTY_M, LN2, flash_decode,
                                             flash_decode_quant)
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.testing import assert_close

B, H, HKV, SMAX = 4, 8, 2, 64
LENGTHS = np.array([0, 1, 37, 64], np.int32)
SLOTS = np.array([2, 0, 3, 1], np.int32)


def _inputs(D=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float16)
    k = (20 * rng.standard_normal((B, SMAX, HKV, D))).astype(np.float32)
    v = rng.standard_normal((B, SMAX, HKV, D)).astype(np.float32)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    kq, ks = pkv.quantize_kv(kb.float())
    vq, vs = pkv.quantize_kv(vb.float())
    return q, kb, vb, (kq, vq, ks, vs)


def _j(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jnp.asarray(t)


def _stats_close(got, want, msg=""):
    acc, m, l = (np.asarray(x, np.float32) for x in got)
    wa, wm, wl = (np.asarray(x, np.float32) for x in want)
    assert_close(m, wm, rtol=2.0 ** -18, atol=1e-3,
                 max_mismatched_ratio=0.0, msg=msg + " m")
    for name, a, w in (("l", l, wl), ("acc", acc, wa)):
        assert_close(a, w, rtol=0.0, atol=1e-2 * float(np.abs(w).max()),
                     max_mismatched_ratio=0.0, msg=f"{msg} {name}")


@pytest.mark.parametrize("quant", [False, True])
def test_partial_stats_plain_matches_jax_kernel(quant):
    """The plain partial_stats decode (the wrappers on CPU tensors)
    against JAX's interpret-mode kernel, an empty shard included."""
    q, kb, vb, (kq, vq, ks, vs) = _inputs()
    lengths, slots = torch.from_numpy(LENGTHS), torch.from_numpy(SLOTS)
    qt = torch.from_numpy(q)
    if quant:
        got = flash_decode_quant(qt, kq, vq, ks, vs, lengths, slots,
                                 partial_stats=True)
        fn = make_flash_decode_quant(batch=B, heads=H, max_seq_len=SMAX,
                                     dim=128, kv_heads=HKV, block_kv=64,
                                     partial_stats=True, interpret=True)
        want = fn(_j(q), _j(kq), _j(vq), _j(ks), _j(vs), _j(LENGTHS),
                  _j(SLOTS))
    else:
        got = flash_decode(qt, kb, vb, lengths, slots, partial_stats=True)
        fn = make_flash_decode(batch=B, heads=H, max_seq_len=SMAX, dim=128,
                               kv_heads=HKV, block_kv=64,
                               partial_stats=True, interpret=True)
        want = fn(_j(q), _j(kb), _j(vb), _j(LENGTHS), _j(SLOTS))
    _stats_close(got, want, "quant" if quant else "bf16")
    acc, m, l = got
    empty = m[0]                               # length 0
    assert torch.all(empty == torch.tensor(EMPTY_M) * LN2)
    assert torch.all(l[0] == 0) and torch.all(acc[0] == 0)


def test_partial_stats_refuses_a_window():
    q, kb, vb, _ = _inputs()
    with pytest.raises(ValueError, match="window"):
        flash_decode(torch.from_numpy(q), kb, vb, torch.from_numpy(LENGTHS),
                     torch.from_numpy(SLOTS), 16, partial_stats=True)


@pytest.mark.parametrize("quant", [False, True])
def test_two_shards_merge_to_the_unsplit_decode(quant):
    """Cut the cache's rows into two shards (length 1 leaves the second
    empty), take each shard's partial over its local lengths and merge by
    log-sum-exp: the unsplit decode's output."""
    q, kb, vb, (kq, vq, ks, vs) = _inputs(seed=1)
    qt = torch.from_numpy(q)
    lengths, slots = torch.from_numpy(LENGTHS), torch.from_numpy(SLOTS)
    half = SMAX // 2
    parts = []
    for c in range(2):
        rows = slice(c * half, (c + 1) * half)
        lloc = (lengths - c * half).clamp(0, half).to(torch.int32)
        if quant:
            parts.append(flash_decode_quant(
                qt, kq[:, rows].contiguous(), vq[:, rows].contiguous(),
                ks[:, rows].contiguous(), vs[:, rows].contiguous(), lloc,
                slots, partial_stats=True))
        else:
            parts.append(flash_decode(qt, kb[:, rows].contiguous(),
                                      vb[:, rows].contiguous(), lloc, slots,
                                      partial_stats=True))
    m_g = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(p[1] - m_g) for p in parts]
    acc = sum(wi[..., None] * p[0] for wi, p in zip(w, parts))
    l = sum(wi * p[2] for wi, p in zip(w, parts))
    merged = (acc / l.clamp_min(1e-30)[..., None]).to(qt.dtype)
    whole = flash_decode_quant(qt, kq, vq, ks, vs, lengths, slots) if quant \
        else flash_decode(qt, kb, vb, lengths, slots)
    assert_close(merged, whole, rtol=0.0, atol=4e-3,
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_partials_match_jax(D, quant):
    """decode_attention{,_quant}_partial: at D = 128 the flash route on
    both sides (JAX's kernel in interpret mode), at D = 64 JAX's XLA
    partial against the port's plain one; an empty shard included."""
    q, kb, vb, (kq, vq, ks, vs) = _inputs(D=D, seed=2)
    lengths, slots = torch.from_numpy(LENGTHS), torch.from_numpy(SLOTS)
    qt = torch.from_numpy(q)
    if quant:
        got = pkv.decode_attention_quant_partial(qt, kq, vq, ks, vs, slots,
                                                 lengths, num_heads=H)
        want = jkv.decode_attention_quant_partial(
            _j(q), _j(kq), _j(vq), _j(ks), _j(vs), _j(SLOTS), _j(LENGTHS),
            num_heads=H)
    else:
        got = pkv.decode_attention_partial(qt, kb, vb, slots, lengths,
                                           num_heads=H)
        want = jkv.decode_attention_partial(_j(q), _j(kb), _j(vb),
                                            _j(SLOTS), _j(LENGTHS),
                                            num_heads=H)
    _stats_close(got, want, f"D={D}")


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_partials_match_jax(quant):
    """chunk_attention{,_quant}_partial (per-query shard limits, one row
    empty) against JAX's XLA partials."""
    T = 3
    q, kb, vb, (kq, vq, ks, vs) = _inputs(D=64, seed=3)
    rng = np.random.default_rng(4)
    qc = rng.standard_normal((B, T, H, 64)).astype(np.float16)
    limits = np.array([[0, 0, 0], [1, 2, 3], [30, 31, 32], [62, 63, 64]],
                      np.int32)
    slots = torch.from_numpy(SLOTS)
    qt, lt = torch.from_numpy(qc), torch.from_numpy(limits)
    if quant:
        got = pkv.chunk_attention_quant_partial(qt, kq, vq, ks, vs, slots,
                                                lt, num_heads=H)
        want = jkv.chunk_attention_quant_partial(
            _j(qc), _j(kq), _j(vq), _j(ks), _j(vs), _j(SLOTS), _j(limits),
            num_heads=H)
    else:
        got = pkv.chunk_attention_partial(qt, kb, vb, slots, lt,
                                          num_heads=H)
        want = jkv.chunk_attention_partial(_j(qc), _j(kb), _j(vb),
                                           _j(SLOTS), _j(limits),
                                           num_heads=H)
    _stats_close(got, want, "chunk")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("chunk", [False, True])
def test_cp_appends_match_jax(quant, chunk):
    """append_{token,chunk}{,_quant}_cp: each of two shards writes only
    the positions it owns (a chunk straddling the boundary included), as
    JAX's scatter-dropped appends."""
    rng = np.random.default_rng(5)
    L_loc, T = 8, (3 if chunk else 1)
    kn = rng.standard_normal((B, T, HKV, 64)).astype(np.float32)
    vn = rng.standard_normal((B, T, HKV, 64)).astype(np.float32)
    starts = np.array([2, 6, 7, 12], np.int32)
    slots = np.array([0, 1, 2, 3], np.int32)
    for c in range(2):
        ck = np.zeros((B, L_loc, HKV, 64), np.float32)
        args_j = (_j(slots), _j(starts))
        args_p = (torch.from_numpy(slots), torch.from_numpy(starts))
        kw = dict(cp_index=c, local_len=L_loc)
        kj, vj = (jnp.asarray(kn if chunk else kn[:, 0]),
                  jnp.asarray(vn if chunk else vn[:, 0]))
        kp, vp = (torch.from_numpy(kn if chunk else kn[:, 0].copy()),
                  torch.from_numpy(vn if chunk else vn[:, 0].copy()))
        if quant:
            sc = np.zeros((B, L_loc, HKV), np.float32)
            fj = jkv.append_chunk_quant_cp if chunk \
                else jkv.append_token_quant_cp
            fp = pkv.append_chunk_quant_cp if chunk \
                else pkv.append_token_quant_cp
            want = fj(jnp.asarray(ck, jnp.int8), jnp.asarray(ck, jnp.int8),
                      jnp.asarray(sc), jnp.asarray(sc), *args_j, kj, vj,
                      **kw)
            got = fp(torch.zeros(ck.shape, dtype=torch.int8),
                     torch.zeros(ck.shape, dtype=torch.int8),
                     torch.zeros(sc.shape), torch.zeros(sc.shape), *args_p,
                     kp, vp, **kw)
        else:
            fj = jkv.append_chunk_cp if chunk else jkv.append_token_cp
            fp = pkv.append_chunk_cp if chunk else pkv.append_token_cp
            want = fj(jnp.asarray(ck), jnp.asarray(ck), *args_j, kj, vj,
                      **kw)
            got = fp(torch.zeros(ck.shape), torch.zeros(ck.shape), *args_p,
                     kp, vp, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))

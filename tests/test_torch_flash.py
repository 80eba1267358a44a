"""bitblas_tpu_torch flash attention (CPU, the kernels' plain versions)
against the JAX Pallas kernels in interpret mode.

Tolerances: both sides take f16 inputs, keep f32 softmax statistics and
round the output to f16 once; the JAX kernel rounds the base-2-scaled Q
and the weights P to f16 before its products where the plain port keeps
f32 for P, so outputs of magnitude < 4 differ by a few f16 ulps:
atol 4e-3.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import make_flash_attention, make_flash_decode

from bitblas_tpu_torch.kernels.flash import (GENERAL_MAX_HEAD_DIM,
                                             flash_attention_fwd,
                                             flash_decode, flash_decode_plain)
from bitblas_tpu_torch.testing import assert_close

D = 128


def test_flash_attention_matches_jax():
    B, S, H, Hkv = 1, 256, 2, 1
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((B, S, H, D)).astype(np.float16)
    K = (rng.standard_normal((B, S, Hkv, D)) * 3).astype(np.float16)
    V = rng.standard_normal((B, S, Hkv, D)).astype(np.float16)
    fn = make_flash_attention(batch=B, heads=H, seq_len=S, dim=D,
                              kv_heads=Hkv, causal=True,
                              out_dtype=jnp.float16, interpret=True)
    want = np.asarray(fn(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V)))
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(torch.from_numpy(Q), torch.from_numpy(K),
                              torch.from_numpy(V))
    assert flash_attention_fwd.launches == before   # CPU: plain version
    assert got.dtype == torch.float16
    assert_close(got, want, rtol=0.0, atol=4e-3, max_mismatched_ratio=0.0)
    # causality: the first row attends only itself
    assert_close(got[0, 0, :, :], np.repeat(V[0, 0], H, axis=0),
                 rtol=0.0, atol=1e-3, max_mismatched_ratio=0.0)


def _decode_inputs(seed, stale):
    B, H, Hkv, Smax, rows = 3, 4, 2, 256, 5
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float16)
    kc = rng.standard_normal((rows, Smax, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((rows, Smax, Hkv, D)).astype(np.float32)
    lengths = np.array([1, 37, 200], np.int32)
    slots = np.array([4, 0, 2], np.int32)
    for b in range(B):           # stale rows past each length
        kc[slots[b], lengths[b]:] = stale
        vc[slots[b], lengths[b]:] = -stale
    return q, kc, vc, lengths, slots


def test_flash_decode_matches_jax_with_stale_rows():
    q, kc, vc, lengths, slots = _decode_inputs(1, stale=1e4)
    B, H = q.shape[:2]
    Smax, Hkv = kc.shape[1], kc.shape[2]
    kb, vb = (x.astype(ml_dtypes.bfloat16) for x in (kc, vc))
    fn = make_flash_decode(batch=B, heads=H, max_seq_len=Smax, dim=D,
                           kv_heads=Hkv, block_kv=128, interpret=True)
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                         jnp.asarray(lengths), jnp.asarray(slots)))
    got = flash_decode(torch.from_numpy(q),
                       torch.from_numpy(kc).to(torch.bfloat16),
                       torch.from_numpy(vc).to(torch.bfloat16),
                       torch.from_numpy(lengths), torch.from_numpy(slots))
    assert_close(got, want, rtol=0.0, atol=4e-3, max_mismatched_ratio=0.0)


def test_flash_decode_plain_nan_stale_rows_and_zero_length():
    q, kc, vc, lengths, slots = _decode_inputs(2, stale=float("nan"))
    lengths[0] = 0
    kt = torch.from_numpy(kc).to(torch.bfloat16)
    vt = torch.from_numpy(vc).to(torch.bfloat16)
    out = flash_decode_plain(torch.from_numpy(q), kt, vt,
                             torch.from_numpy(lengths),
                             torch.from_numpy(slots))
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    # against a direct softmax over the valid rows only
    b, L = 2, int(lengths[2])
    k = kt[slots[b], :L].float()                    # [L, Hkv, D]
    v = vt[slots[b], :L].float()
    qf = torch.from_numpy(q[b]).float().reshape(2, 2, D)
    s = torch.einsum("hgd,lhd->hgl", qf, k) / math.sqrt(D)
    want = torch.einsum("hgl,lhd->hgd", torch.softmax(s, -1), v)
    assert_close(out[b], want.reshape(4, D), rtol=0.0, atol=2e-3,
                 max_mismatched_ratio=0.0)


def test_flash_wrappers_reject_what_the_kernels_do_not_take():
    # the prefill kernel takes any S and any head dim up to its general
    # instance's cap (tests/test_torch_flash_dims.py), K^T at any S; it
    # refuses a head dim past the cap and a window without causality
    # (JAX's refusal), on the CPU as on the card
    x = torch.zeros((1, 96, 2, GENERAL_MAX_HEAD_DIM + 8),
                    dtype=torch.float16)
    with pytest.raises(NotImplementedError):      # head dim
        flash_attention_fwd(x, x, x)
    y = torch.zeros((1, 100, 2, 64), dtype=torch.float16)
    assert flash_attention_fwd(y, y.permute(0, 3, 2, 1).contiguous(), y,
                               trans_k=True).shape == y.shape   # S % 8
    with pytest.raises(NotImplementedError):      # window, not causal
        flash_attention_fwd(y, y, y, 8, causal=False)
    q = torch.zeros((2, 4, D), dtype=torch.float16)
    cache = torch.zeros((2, 16, 2, D), dtype=torch.float32)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):               # cache dtype (bf16/f16)
        flash_decode(q, cache, cache, idx, idx)

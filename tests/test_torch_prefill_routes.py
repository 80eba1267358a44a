"""Kernel 4's routes for the 16-bit shapes off its wgmma instances, on the
CPU: the fixed rule (`kernels.flash.prefill_instance`) for every shape of
the card tests' general cases, and each route's plain form
(`prefill_routed_plain`: the layout pass's tensors read back through their
row pitches, attention at the instance's head dim with the true D's
scale, O's first D columns) against JAX's `make_flash_attention` in
interpret mode:

- "aligned" (a wgmma instance behind rows padded to 16 bytes): D = 100
  over three heads (rows of 200 x 3 bytes), K^T at S = 161 (key rows of
  161 x 2 bytes) at D = 128;
- "general" (the head dim to a multiple of 16; K^T transposed into K's
  layout): D = 160, D = 160 with K^T, a window and GQA, D = 40 and D = 72
  with GQA.

Inputs: N(0, 1) from numpy, K amplified 3x. Tolerances as
tests/test_torch_flash_dims.py against JAX's kernel: float16 atol 4e-3,
bfloat16 2^-5 (two bfloat16 roundings of |out| < 4), and element by
element one ulp of |want| plus 4 ulps of the row's rms
(testing.attention_err: JAX rounds P to the operands' type before P V,
the plain version keeps float32). The layout pass's zero columns add
exactly nothing, so each route's plain form equals the plain version
bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import make_flash_attention

from bitblas_tpu_torch.kernels import flash
from bitblas_tpu_torch.testing import ATTN_ULP, assert_close, attention_err

ATOL = {"float16": 4e-3, "bfloat16": 8 * 2.0 ** -8}

# tests/test_torch_cuda_kernels.py GENERAL_CASES: (D, S, H, Hkv, causal,
# trans_k, window, dtype, out) and the route each takes
ROUTE_CASES = [
    ((16, 200, 4, 2, True, False, None, "float16", None), "general"),
    ((48, 130, 3, 3, False, False, None, "bfloat16", "float32"), "general"),
    ((160, 300, 4, 2, True, False, 70, "bfloat16", None), "general"),
    ((384, 257, 2, 1, True, False, None, "float16", None), "general"),
    ((512, 256, 4, 2, False, True, None, "bfloat16", None), "general"),
    ((768, 130, 2, 2, True, False, None, "float16", "bfloat16"), "general"),
    ((100, 192, 3, 3, True, False, None, "float16", None), "aligned"),
    ((100, 161, 5, 1, False, True, None, "bfloat16", None), "aligned"),
    ((128, 161, 4, 2, True, True, None, "float16", None), "aligned"),
    ((512, 2048, 8, 8, True, False, None, "float16", None), "general"),
    ((160, 2048, 8, 8, True, False, None, "bfloat16", None), "general"),
    ((100, 2048, 25, 25, True, False, None, "float16", None), "aligned"),
    ((128, 2047, 8, 8, True, True, None, "float16", None), "aligned"),
    ((6, 200, 2, 1, True, False, 33, "float32", None), "f32"),
    ((288, 130, 2, 2, False, True, None, "float32", "float16"), "f32"),
    ((768, 100, 2, 1, True, False, None, "float32", None), "f32"),
]


@pytest.mark.parametrize("case,route", ROUTE_CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else c)
def test_rule_routes_every_general_case(case, route):
    """The rule: what only a stride keeps off a wgmma instance takes the
    aligned route; the other 16-bit head dims the general instance; float32
    the FFMA kernel; the launch variant names the route."""
    D, S, H, Hkv, causal, trans_k, window, dtype, out = case
    dt = getattr(torch, dtype)
    assert flash.prefill_instance(S, H, Hkv, D, dt, trans_k=trans_k) \
        == route
    variant = flash.prefill_variant(dt, D, causal=causal, trans_k=trans_k,
                                    window=window, instance=route)
    assert (f" {route} " in variant + " ") == (route != "f32")
    assert flash.prefill_refusal(S, H, Hkv, D, dt, causal=causal,
                                 trans_k=trans_k, window=window) is None


def _inputs(seed, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((1, S, H, D)).astype(np.float32)
    K = (rng.standard_normal((1, S, Hkv, D)) * 3).astype(np.float32)
    V = rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
    return Q, K, V


# (D, S, H, Hkv, trans_k, window, dtype, instance)
PLAIN_CASES = [
    (100, 128, 3, 3, False, None, "float16", "aligned"),
    (128, 161, 4, 2, True, None, "float16", "aligned"),
    (100, 161, 5, 1, True, 40, "bfloat16", "aligned"),
    (160, 128, 2, 2, False, None, "bfloat16", "general"),
    (160, 130, 2, 1, True, 50, "float16", "general"),
    (40, 96, 4, 2, True, None, "float16", "general"),
    (72, 96, 3, 1, False, None, "bfloat16", "general"),
]


@pytest.mark.parametrize("D,S,H,Hkv,trans_k,window,dtype,instance",
                         PLAIN_CASES)
def test_route_plain_form_matches_jax(D, S, H, Hkv, trans_k, window, dtype,
                                      instance):
    tdt = getattr(torch, dtype)
    Q, K, V = _inputs(D + S + H, S, H, Hkv, D)
    fn = make_flash_attention(batch=1, heads=H, seq_len=S, dim=D,
                              kv_heads=Hkv, causal=True, block_q=128,
                              block_kv=128, out_dtype=jnp.dtype(dtype),
                              window=window, interpret=True)
    want = np.asarray(fn(*(jnp.asarray(a, dtype) for a in (Q, K, V))),
                      np.float32)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in (Q, K, V))
    if trans_k:
        k = k.permute(0, 3, 2, 1).contiguous()
    got = flash.prefill_routed_plain(q, k, v, window, trans_k=trans_k,
                                     instance=instance)
    assert got.dtype == tdt and got.shape == (1, S, H, D)
    assert_close(got, want, rtol=0.0, atol=ATOL[dtype],
                 max_mismatched_ratio=0.0)
    u = ATTN_ULP[tdt]
    assert attention_err(got, torch.from_numpy(want), u, 4 * u) <= 1.0
    # the zero columns and padded rows change nothing at all
    assert torch.equal(got, flash.flash_attention_plain(
        q, k, v, window, trans_k=trans_k))


@pytest.mark.parametrize("instance,trans_k", [("aligned", True),
                                               ("general", True),
                                               ("general", False)])
def test_layout_pitches_are_tma_rows(instance, trans_k):
    """Every pitch the layout pass hands an instance is a 16-byte row, at
    least the heads' columns, and the copies carry the operands; only the
    aligned route keeps K^T (the general instance reads K's layout)."""
    H, Hkv, S = 3, 1, 37
    D = 100 if instance == "aligned" else 72
    g = torch.Generator().manual_seed(5)
    Q = torch.randn((2, S, H, D), generator=g).half()
    K = torch.randn((2, S, Hkv, D), generator=g).half()
    V = torch.randn((2, S, Hkv, D), generator=g).half()
    Kin = K.permute(0, 3, 2, 1).contiguous() if trans_k else K
    q, k, v, Dk, hs, pitch, tk = flash.prefill_layout(
        Q, Kin, V, trans_k=trans_k, instance=instance)
    assert all(p % 8 == 0 for p in pitch) and hs % 16 == 0
    assert Dk == (D if instance == "aligned" else 80)
    # a head's k16 steps end inside its own (zero-padded) columns
    assert hs == -(-Dk // 16) * 16
    assert pitch[0] >= H * hs and pitch[2] >= Hkv * hs
    assert tk == (trans_k and instance == "aligned")
    assert pitch[1] >= (S if tk else Hkv * hs)
    rows = q.reshape(2, S, -1)[..., :H * hs].reshape(2, S, H, hs)
    assert torch.equal(rows[..., :D], Q) and not rows[..., D:].any()
    if not tk:
        keys = k.reshape(2, S, -1)[..., :Hkv * hs].reshape(2, S, Hkv, hs)
        assert torch.equal(keys[..., :D], K) and not keys[..., D:].any()

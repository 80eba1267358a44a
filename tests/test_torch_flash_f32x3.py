"""The arithmetic of kernel 4's float32 kernel (csrc/flash_attention_f32.cu)
against JAX's `make_flash_attention` on the CPU and a float64 truth.

The kernel runs every product on the TF32 tensor cores in the 3xTF32
split: x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
hi), and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b in float32, three mma
products a k-step of 8, the small terms first; Q K^T in parts of 64 dims
(one warp a part), the small terms in sums of their own, and P V in key
tiles, each part's or tile's sums from zero and added in order.
`_attention` emulates that in plain PyTorch, TF32 rounding by bit masking
(the kernel's integer form of cvt.rna.tf32), at D = 6 / 128 / 288, causal
and dense, K and K^T, with K amplified 20x (scores of a few hundred in
the base-2 domain).

Limits: the float32 limit of the prefill tests against JAX, 2e-5 absolute
(tests/test_torch_flash_dims.py), against the float64 truth, and against
JAX at the prefill tests' K amplified 3x. With K amplified 20x JAX's own
float32 kernel strays from that truth (its float32 dot products: 4.9e-5
at D = 288), so the emulation misses 2e-5 against JAX there (5.3e-5 at
most) and is held to a fixed `JAX_ATOL_X20` of 1e-4, which one TF32
product (no split; 9.3e-3 from JAX at the least) misses by two orders
of magnitude: the evidence that the split is needed and is enough.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import make_flash_attention

from bitblas_tpu_torch.kernels import flash

ATOL = 2e-5
# against JAX at K amplified 20x, between the emulation's largest gap
# (5.3e-5) and one TF32 product's smallest (9.3e-3)
JAX_ATOL_X20 = 1e-4
S, H, HKV = 128, 2, 1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to a
    10-bit mantissa (add half an ulp to the magnitude's bits, drop 13)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32) \
        .view(torch.float32)


def _split(x: torch.Tensor):
    """x = hi + lo: hi by cvt.rna.tf32, which keeps a NaN (the integer form
    would turn 0x7fffffff into -0), lo = x - hi by the integer form."""
    hi = torch.where(torch.isnan(x), x, _tf32(x))
    return hi, _tf32(x - hi)


def _products(a: torch.Tensor, b: torch.Tensor, split: bool, part: int,
              apart: bool = False) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] in float32 as the kernel's mma sums
    it: parts of `part` k summed in part order, in each part k-steps of
    8 adding lo hi', hi lo' (into a sum of their own with `apart`) and hi
    hi' (split), or one TF32 product a step."""
    K = a.shape[-1]
    total = None
    for p0 in range(0, K, part):
        big = torch.zeros(a.shape[:-1] + b.shape[-1:])
        small = torch.zeros_like(big)
        for k0 in range(p0, min(K, p0 + part), 8):
            x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
            if split:
                (xh, xl), (yh, yl) = _split(x), _split(y)
                if apart:
                    small = small + xl @ yh
                    small = small + xh @ yl
                else:
                    big = big + xl @ yh
                    big = big + xh @ yl
                big = big + xh @ yh
            else:
                big = big + _tf32(x) @ _tf32(y)
        acc = big + small
        total = acc if total is None else total + acc
    return total


def _attention(Q, K, V, causal: bool, trans_k: bool, mode: str):
    """Attention with the kernel's scale and masks: `mode` "x3" (the
    3xTF32 split), "x1" (one TF32 product) or "f64" (the truth)."""
    if trans_k:
        K = K.permute(0, 3, 2, 1)
    D = Q.shape[-1]
    group = Q.shape[2] // K.shape[2]
    dt = torch.float64 if mode == "f64" else torch.float32
    q = (Q.to(dt) * (flash.LOG2E / math.sqrt(D))).transpose(1, 2)
    k, v = (x.to(dt).repeat_interleave(group, 2).transpose(1, 2)
            for x in (K, V))
    if mode == "f64":
        s = q @ k.transpose(-1, -2)
    else:
        pad = -D % 8                     # the reduction dim padded to 8
        q, k = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k))
        s = _products(q, k.transpose(-1, -2), mode == "x3", 64, apart=True)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    # the kernel's key tiles: 64 keys up to D = 32, 32 up to 128, 16 above
    tile = 64 if D <= 32 else 32 if D <= 128 else 16
    o = p @ v if mode == "f64" else _products(p, v, mode == "x3", tile)
    return (o / p.sum(-1, keepdim=True)).transpose(1, 2).float()


def _inputs(D: int, trans_k: bool, amp: float):
    rng = np.random.default_rng(D * 7 + trans_k)
    Q = rng.standard_normal((1, S, H, D)).astype(np.float32)
    K = (rng.standard_normal((1, S, HKV, D)) * amp).astype(np.float32)
    V = rng.standard_normal((1, S, HKV, D)).astype(np.float32)
    if trans_k:
        K = np.ascontiguousarray(K.transpose(0, 3, 2, 1))
    return Q, K, V


def _jax(Q, K, V, D, causal, trans_k):
    fn = make_flash_attention(batch=1, heads=H, seq_len=S, dim=D,
                              kv_heads=HKV, causal=causal, trans_k=trans_k,
                              block_q=128, block_kv=128,
                              out_dtype=jnp.float32, interpret=True)
    return torch.from_numpy(np.array(
        fn(*(jnp.asarray(a) for a in (Q, K, V))), np.float32))


def _gap(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("trans_k", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [6, 128, 288])
def test_split_products_hold_float32_limit(D, causal, trans_k):
    Q, K, V = _inputs(D, trans_k, 20.0)
    t = [torch.from_numpy(a) for a in (Q, K, V)]
    want = _jax(Q, K, V, D, causal, trans_k)
    truth = _attention(*t, causal, trans_k, "f64")
    got = _attention(*t, causal, trans_k, "x3")
    assert torch.isfinite(got).all() and got.shape == (1, S, H, D)
    assert _gap(got, truth) <= ATOL
    assert _gap(got, want) <= JAX_ATOL_X20
    # the port's float32 route on the CPU (its plain version) is JAX's
    got_port = flash.flash_attention_fwd(*t, causal=causal, trans_k=trans_k)
    assert _gap(got_port, want) <= ATOL


@pytest.mark.parametrize("D", [6, 128, 288])
def test_split_products_match_jax_at_prefill_scores(D):
    """At the prefill tests' K amplified 3x the emulation is within 2e-5
    of JAX's kernel outright."""
    Q, K, V = _inputs(D, False, 3.0)
    got = _attention(*(torch.from_numpy(a) for a in (Q, K, V)), True, False,
                     "x3")
    assert _gap(got, _jax(Q, K, V, D, True, False)) <= ATOL


@pytest.mark.parametrize("D", [6, 128, 288])
def test_one_tf32_product_misses_the_limit(D):
    Q, K, V = _inputs(D, False, 20.0)
    t = [torch.from_numpy(a) for a in (Q, K, V)]
    truth = _attention(*t, True, False, "f64")
    want = _jax(Q, K, V, D, True, False)
    one = _attention(*t, True, False, "x1")
    assert _gap(one, truth) > 100 * ATOL
    assert _gap(one, want) > 100 * ATOL + _gap(want, truth)


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna.tf32: 13 low bits cleared, the half ulp (bit
    12) rounding the magnitude up, so ties go away from zero; lo = x - hi
    rounded again leaves x - hi - lo within 2^-22 |x|."""
    base = 1.0 + 2.0 ** -10            # an ulp of TF32 above 1
    x = torch.tensor([base + 2.0 ** -11, -(base + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -9), 1.0,
                                 3.0]
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 100
    hi, lo = _split(r)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= 2.0 ** -22 * r.double().abs()).all()


def test_split_keeps_nan():
    """A NaN reaches hi whatever its payload (CUDA's 0x7fffffff, -NaN,
    the quiet NaN) and Inf stays Inf, as cvt.rna.tf32 keeps them; the
    integer form alone turns 0x7fffffff into -0 and 0xffffffff into 0."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800000,
                         -0x800000], dtype=torch.int32)
    x = bits.view(torch.float32)
    hi, _ = _split(x)
    assert torch.isnan(hi[:3]).all()
    assert hi[3:].tolist() == [math.inf, -math.inf]
    assert _tf32(x[:2]).tolist() == [-0.0, 0.0]

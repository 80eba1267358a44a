"""Kernel 4's configuration surface (head dims 64 / 96 / 100 / 256,
non-causal, K^T "ntn", a ragged S, float32, an output type other than
Q's) and `ops/flashatten.FlashAtten` with `tuner/hint.FlashHint`, on the
CPU: the port's plain version against JAX's `make_flash_attention` in
interpret mode, the port's FlashAtten against JAX's (forward and
ref_program, both layouts), and a tuned FlashHint through the port's
hint database.

Inputs are N(0, 1) from numpy, K amplified 3x (a head mix-up cannot hide
in a near-uniform softmax). Tolerances:
- float16 operands: atol 4e-3 (tests/test_torch_flash.py: JAX rounds P
  to float16 before P V, the plain version keeps it in float32; a few
  float16 ulps of |out| < 4); bfloat16: 2^-5, two bfloat16 roundings;
- element by element as well (testing.attention_err): one ulp of the
  output type of |want| plus 4 ulps of the row's rms, as
  tests/test_torch_window.py holds the windowed rows;
- float32 operands: both sides keep everything in float32 and sum in
  other orders: atol 2e-5 on |out| < 4 (about 40 float32 ulps at 2);
- an output type other than the operands' rounds nearly the same float32
  value once more: one ulp of that type at |out| < 4 at least (2^-9
  float16, 2^-6 bfloat16);
- FlashAtten.ref_program against JAX's: the same float32 softmax, one
  rounding to Out_dtype: 2e-3 absolute (one float16 ulp at 2), and the
  forward against JAX's forward at the operands' limit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import make_flash_attention
from bitblas_tpu.ops.flashatten import FlashAtten as JaxFlashAtten
from bitblas_tpu.ops.flashatten import FlashAttenConfig as JaxFlashAttenConfig
from bitblas_tpu.tuner.hint import FlashHint as JaxFlashHint

from bitblas_tpu_torch.cache import OperatorCache
from bitblas_tpu_torch.kernels.flash import (GENERAL_MAX_HEAD_DIM,
                                             HEAD_DIMS, check_prefill,
                                             flash_attention_fwd,
                                             flash_attention_plain,
                                             prefill_refusal, prefill_tiles,
                                             prefill_variant)
from bitblas_tpu_torch.ops import FlashAtten, FlashAttenConfig
from bitblas_tpu_torch.testing import ATTN_ULP, assert_close, attention_err
from bitblas_tpu_torch.tuner import HINT_CLASSES, FlashHint
from bitblas_tpu_torch.tuner.curated import flash_block_hint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file: the tier-1 command runs
    six workers on eight cores, and torch's eight-thread pool then spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = {"float16": 4e-3, "bfloat16": 8 * 2.0 ** -8, "float32": 2e-5}
OUT_ATOL = {"float16": 2.0 ** -9, "bfloat16": 2.0 ** -6, "float32": 0.0}


def _inputs(seed, B, S, H, Hkv, D, trans_k=False):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    K = (rng.standard_normal((B, S, Hkv, D)) * 3).astype(np.float32)
    V = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    if trans_k:
        K = np.ascontiguousarray(K.transpose(0, 3, 2, 1))   # [B, D, Hkv, S]
    return Q, K, V


def _held(got, want, dtype):
    out = str(got.dtype).split(".")[-1]
    assert_close(got, want, rtol=0.0, atol=max(ATOL[dtype], OUT_ATOL[out]),
                 max_mismatched_ratio=0.0)
    if got.dtype in ATTN_ULP:
        u = ATTN_ULP[got.dtype]
        assert attention_err(got, torch.from_numpy(np.asarray(
            want, np.float32)), u, 4 * u) <= 1.0


# (D, S, H, Hkv, causal, trans_k, dtype, out dtype): every head dim,
# dense and causal, K^T, ragged S (160, 64-key tiles plus 32), GQA,
# float32 in and out, and outputs in another type
CASES = [
    (64, 256, 4, 2, True, False, "float16", None),
    (64, 160, 2, 2, False, False, "float16", None),
    (100, 256, 4, 2, True, False, "float16", None),
    (100, 160, 2, 2, False, False, "bfloat16", None),
    (100, 256, 2, 2, True, True, "float16", "float32"),
    (96, 160, 2, 1, True, False, "bfloat16", None),
    (256, 128, 2, 1, False, False, "float16", None),
    (64, 256, 2, 2, False, True, "bfloat16", None),
    (64, 160, 4, 2, True, False, "float32", None),
    (100, 256, 2, 1, False, True, "float32", "float16"),
]


@pytest.mark.parametrize("D,S,H,Hkv,causal,trans_k,dtype,out", CASES)
def test_plain_version_matches_jax(D, S, H, Hkv, causal, trans_k, dtype,
                                   out):
    out = out or dtype
    Q, K, V = _inputs(D + S + H, 1, S, H, Hkv, D, trans_k)
    # JAX's 128-row blocks make S = 160 ragged there too (its kv_len mask)
    fn = make_flash_attention(batch=1, heads=H, seq_len=S, dim=D,
                              kv_heads=Hkv, causal=causal, trans_k=trans_k,
                              block_q=128, block_kv=128,
                              out_dtype=jnp.dtype(out), interpret=True)
    want = np.asarray(fn(*(jnp.asarray(a, dtype) for a in (Q, K, V))),
                      np.float32)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (Q, K, V)]
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(*t, causal=causal, trans_k=trans_k,
                              out_dtype=getattr(torch, out))
    assert flash_attention_fwd.launches == before   # CPU: plain version
    assert got.dtype == getattr(torch, out) and got.shape == (1, S, H, D)
    assert torch.isfinite(got).all()
    _held(got, want, dtype)
    # both tiles give the same plain arithmetic (keys padded with zeros)
    for tile in prefill_tiles(D, t[0].dtype):
        assert torch.equal(got, flash_attention_plain(
            *t, causal=causal, trans_k=trans_k,
            out_dtype=getattr(torch, out), tile=tile))


def test_plain_version_masks_keys_past_s_and_zeroes_their_v():
    """The plain version pads the keys to the tile as the kernel reads
    them: a ragged S gives the same rows as the keys it has, and the
    first row of a causal walk attends only its own key."""
    Q, K, V = (torch.from_numpy(a).half()
               for a in _inputs(3, 1, 96, 2, 2, 64))
    got = flash_attention_plain(Q, K, V, tile=(64, 128))
    assert torch.equal(got[0, 0], V[0, 0])
    dense = flash_attention_plain(Q, K, V, causal=False)
    p = torch.softmax(torch.einsum("qhd,khd->hqk", Q[0].float(),
                                   K[0].float()) / 8.0, dim=-1)
    want = torch.einsum("hqk,khd->qhd", p, V[0].float())
    assert_close(dense[0], want.numpy(), rtol=0.0, atol=4e-3,
                 max_mismatched_ratio=0.0)


def test_refusals_name_the_shape():
    """Kernel 4 refuses what JAX's refuses (a window without causality)
    and head dims past its general instance's cap; the shapes TMA cannot
    address run the general instance."""
    f16 = torch.float16
    cap = GENERAL_MAX_HEAD_DIM
    for args, kw in (((1, 64, 2, 2, cap + 16, f16, f16), {}),  # head dim
                     ((1, 64, 1, 1, cap + 4, torch.float32, f16), {}),
                     ((1, 64, 2, 2, 64, f16, f16),
                      {"causal": False, "window": 16})):
        with pytest.raises(NotImplementedError,
                           match=r"S=\d+ H=\d+") as refused:
            check_prefill(*args, **kw)
        # the reason make_prefill reads (S, H, Hkv, D, type)
        assert prefill_refusal(*args[1:6], **kw) in str(refused.value)
    assert prefill_refusal(64, 2, 2, 100, f16) is None
    assert prefill_refusal(161, 1, 1, 100, torch.float32,
                           trans_k=True) is None
    # once refused, now the general instance's (one 64-key tile)
    for args, kw in (((1, 64, 2, 2, 80, f16, f16), {}),
                     ((1, 64, 1, 1, 100, f16, f16), {}),
                     ((1, 161, 2, 2, 64, f16, f16), {"trans_k": True})):
        assert prefill_refusal(*args[1:6], **kw) is None
        assert check_prefill(*args, **kw) == (64, 64)
    # 128-key tiles are built at head dim 64 alone
    for D in (96, 100, 128, 256):
        with pytest.raises(ValueError, match="tile"):
            check_prefill(1, 64, 2, 2, D, f16, f16, tile=(64, 128))
    assert check_prefill(1, 64, 2, 2, 64, f16, f16, tile=(64, 128)) \
        == (64, 128)
    # float32 runs the FFMA kernel: any D up to the cap, any S
    assert check_prefill(1, 161, 1, 1, 100, torch.float32, f16,
                         trans_k=True) == (64, 64)
    assert prefill_tiles(256) == prefill_tiles(100) == ((64, 64),)
    assert prefill_tiles(64) == ((64, 64), (64, 128))
    assert prefill_tiles(64, torch.float32) == ((64, 64),)
    assert set(HEAD_DIMS) == {64, 80, 96, 100, 128, 256}
    assert prefill_variant(torch.float16, 100) == "float16 d100"
    assert prefill_variant(torch.bfloat16, 128, window=4096) == \
        "bfloat16 window"
    assert prefill_variant(torch.float32, 64, causal=False, trans_k=True,
                           out_dtype=f16) == "float32 d64 nc ntn out float16"


# FlashAtten configs: the JAX operator's own test shapes (D = 64, both
# layouts, GQA) and the 3B-like head dim 100
FA_CONFIGS = [
    dict(batch=2, heads=4, seq_len=256, dim=64, is_causal=True),
    dict(batch=1, heads=2, seq_len=256, dim=64, layout="ntn"),
    dict(batch=1, heads=4, kv_heads=2, seq_len=256, dim=100, is_causal=True,
         Q_dtype="bfloat16", Out_dtype="bfloat16"),
    dict(batch=1, heads=2, seq_len=256, dim=96, layout="ntn",
         is_causal=True, Q_dtype="float32", Out_dtype="float32"),
]


@pytest.mark.parametrize("cfg", FA_CONFIGS,
                         ids=lambda c: f"d{c['dim']}-{c.get('layout', 'nnn')}")
def test_flashatten_matches_jax(cfg):
    jop = JaxFlashAtten(JaxFlashAttenConfig(**cfg), enable_tuning=False)
    op = FlashAtten(FlashAttenConfig(**cfg), device="cpu")
    assert op.kernel_name_generator.generate() == \
        jop.kernel_name_generator.generate()
    args = op._example_args()
    jargs = jop._example_args()     # the same numpy draws
    for a, j in zip(args, jargs):
        assert np.array_equal(a.float().numpy(), np.asarray(j, np.float32))
    dtype = cfg.get("Q_dtype", "float16")
    got = op.forward(*args)
    assert got.dtype == op.out_dtype
    _held(got, np.asarray(jop.forward(*jargs), np.float32), dtype)
    assert_close(op.ref_program(*args),
                 np.asarray(jop.ref_program(*jargs), np.float32),
                 rtol=0.0, atol=2e-3 if dtype != "float32" else 1e-5,
                 max_mismatched_ratio=0.0)
    assert_close(got, op.ref_program(*args).float().numpy(), rtol=0.0,
                 atol=2 * ATOL[dtype] if dtype != "float32" else 1e-4,
                 max_mismatched_ratio=0.0)


def test_flashatten_refuses_what_the_kernel_does_not_take():
    """JAX's operator serves its XLA oracle where its kernel cannot tile
    a shape; the port's runs kernel 4's general instance there, and
    raises at construction only past that instance's head-dim cap."""
    FlashAtten(FlashAttenConfig(batch=1, heads=2, seq_len=64, dim=80),
               device="cpu")
    with pytest.raises(NotImplementedError, match="head dims"):
        FlashAtten(FlashAttenConfig(batch=1, heads=2, seq_len=64,
                                    dim=GENERAL_MAX_HEAD_DIM + 128),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="one type"):
        FlashAtten(FlashAttenConfig(batch=1, heads=2, seq_len=64, dim=64,
                                    K_dtype="bfloat16"), device="cpu")


def test_flash_hint_matches_jax_and_round_trips(tmp_path):
    h = FlashHint(block_q=64, block_kv=128)
    j = JaxFlashHint(block_q=64, block_kv=128)
    assert h.to_dict() == j.to_dict() and h.short_name() == j.short_name()
    assert FlashHint.from_dict({**j.to_dict(), "diag_sub": 128}) == h
    assert HINT_CLASSES["FlashHint"] is FlashHint
    # head dim 64, the one with two tiles: the default takes 128 keys at
    # S = 256, the tuned hint 64
    cfg = FlashAttenConfig(batch=1, heads=4, kv_heads=2, seq_len=256,
                           dim=64, is_causal=True)
    op = FlashAtten(cfg, device="cpu")
    assert op.hints == {0: FlashHint(*flash_block_hint(256, 64, True))} \
        == {0: h}
    assert op.tuned_hints == {}
    h = FlashHint(block_q=64, block_kv=64)
    op.apply_hints({0: h})
    assert op.tuned_hints == {0: h}
    with pytest.raises(ValueError, match="not one of"):
        op.apply_hints({0: FlashHint(64, 256)})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database(str(tmp_path))
    loaded = OperatorCache()
    assert loaded.load_from_database(str(tmp_path), target="cpu") == 1
    back = loaded.get(cfg)
    assert isinstance(back, FlashAtten) and back.config == cfg
    assert back.hints == {0: h} and back.tuned_hints == {}   # unpinned
    args = op._example_args()
    assert torch.equal(back.forward(*args), op.forward(*args))

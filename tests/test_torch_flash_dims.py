"""Kernel 4 at every head dim and stride JAX takes, and kernels 5-8 at a
head dim above 256, against the JAX package on the CPU.

- Kernel 4's plain version (`flash_attention_fwd` on CPU tensors) against
  JAX's `make_flash_attention` in interpret mode at head dims 32 / 80 /
  160 / 384, at D = 100 with three heads (a row of 200 x 3 bytes, which
  TMA cannot address: the aligned route, the d100 instance behind the
  layout pass), and in float32 at D = 6
  (the FFMA kernel, which takes every head dim).
  JAX pads D to a multiple of 128 and keeps 1/sqrt of the true D; the
  port's instances take D as it is.
- `FlashAtten` against JAX's for K^T ("ntn") at S = 200 and 201: JAX's
  kernel refuses S % 128 != 0 there and its operator serves its oracle.
- The support sweep: every `FlashAttenConfig` of a grid of head dims,
  head counts, types, layouts and walks builds in the port (no
  refusal) and its forward matches JAX's operator's oracle
  (`ref_program`).
- The caps: the general instance's head dim and the decode kernels'.
- Kernels 5-8's plain versions, and 5-6's partial_stats, against JAX's
  decode kernels in interpret mode at D = 384.

Inputs: N(0, 1) from numpy, K amplified 3x in prefill (a head mix-up
cannot hide in a near-uniform softmax) and 20x in decode. Tolerances:
- prefill against JAX's kernel: float16 atol 4e-3, bfloat16 2^-5 (two
  bfloat16 roundings of |out| < 4), float32 2e-5
  (tests/test_torch_flashatten.py's), and element by element one ulp of
  |want| plus 4 ulps of the row's rms (testing.attention_err: JAX rounds
  P to the operands' type before P V, the plain version keeps float32);
- the sweep against JAX's oracle (float32 softmax, one rounding to the
  output type; the port's plain version rounds the scaled Q to its type
  first): float16 4e-3, bfloat16 2^-5, float32 2e-5 absolute on |out| < 4;
- decode against JAX's kernels: atol 1e-2 (tests/test_torch_decode_
  shapes.py: scores of a few hundred in the base-2 domain, f32 dot
  products in other orders, JAX rounds P to f16); partial_stats as
  tests/test_torch_flash_partial.py (m to 2^-18 relative plus 1e-3, acc
  and l 1e-2 of their largest value).
"""

import itertools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import (make_flash_attention,
                                       make_flash_decode,
                                       make_flash_decode_paged,
                                       make_flash_decode_paged_quant,
                                       make_flash_decode_quant)
from bitblas_tpu.ops.flashatten import FlashAtten as JaxFlashAtten
from bitblas_tpu.ops.flashatten import FlashAttenConfig as JaxFlashAttenConfig

from bitblas_tpu_torch.kernels import flash
from bitblas_tpu_torch.ops import FlashAtten, FlashAttenConfig
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.testing import ATTN_ULP, assert_close, attention_err


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file (the tier-1 command runs six
    workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = {"float16": 4e-3, "bfloat16": 8 * 2.0 ** -8, "float32": 2e-5}


def _prefill_inputs(seed, S, H, Hkv, D, trans_k=False):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((1, S, H, D)).astype(np.float32)
    K = (rng.standard_normal((1, S, Hkv, D)) * 3).astype(np.float32)
    V = rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
    if trans_k:
        K = np.ascontiguousarray(K.transpose(0, 3, 2, 1))   # [B, D, Hkv, S]
    return Q, K, V


def _held(got, want, dtype):
    assert_close(got, want, rtol=0.0, atol=ATOL[dtype],
                 max_mismatched_ratio=0.0)
    if got.dtype in ATTN_ULP:
        u = ATTN_ULP[got.dtype]
        assert attention_err(got, torch.from_numpy(np.asarray(
            want, np.float32)), u, 4 * u) <= 1.0


# (D, S, H, Hkv, causal, window, dtype, instance): the new head dims,
# Danube's D = 80 with a window, odd heads at D % 8 == 4, float32 D = 6
PREFILL_CASES = [
    (32, 128, 4, 2, True, None, "float16", "general"),
    (80, 256, 4, 2, True, 64, "bfloat16", "wgmma"),
    (160, 128, 2, 2, False, None, "float16", "general"),
    (384, 128, 2, 1, True, None, "bfloat16", "general"),
    (100, 128, 3, 3, True, None, "float16", "aligned"),
    (6, 128, 2, 1, True, None, "float32", "f32"),
]


@pytest.mark.parametrize("D,S,H,Hkv,causal,window,dtype,instance",
                         PREFILL_CASES)
def test_prefill_plain_matches_jax(D, S, H, Hkv, causal, window, dtype,
                                   instance):
    tdt = getattr(torch, dtype)
    assert flash.prefill_instance(S, H, Hkv, D, tdt) == instance
    Q, K, V = _prefill_inputs(D + S + H, S, H, Hkv, D)
    fn = make_flash_attention(batch=1, heads=H, seq_len=S, dim=D,
                              kv_heads=Hkv, causal=causal, block_q=128,
                              block_kv=128, out_dtype=jnp.dtype(dtype),
                              window=window, interpret=True)
    want = np.asarray(fn(*(jnp.asarray(a, dtype) for a in (Q, K, V))),
                      np.float32)
    t = [torch.from_numpy(a).to(tdt) for a in (Q, K, V)]
    before = flash.flash_attention_fwd.launches
    got = flash.flash_attention_fwd(*t, window, causal=causal)
    assert flash.flash_attention_fwd.launches == before   # plain version
    assert got.dtype == tdt and got.shape == (1, S, H, D)
    _held(got, want, dtype)


@pytest.mark.parametrize("S", [200, 201])
def test_flashatten_trans_k_matches_jax(S):
    """K^T at S = 200 (the wgmma instance's key rows) and 201 (the same
    instance behind the layout pass's padded key rows): JAX's kernel
    cannot tile either, and its operator serves its oracle; the port's
    runs kernel 4."""
    cfg = dict(batch=1, heads=4, kv_heads=2, seq_len=S, dim=64,
               layout="ntn", is_causal=True)
    jop = JaxFlashAtten(JaxFlashAttenConfig(**cfg), enable_tuning=False)
    op = FlashAtten(FlashAttenConfig(**cfg), device="cpu")
    assert flash.prefill_instance(S, 4, 2, 64, torch.float16, trans_k=True) \
        == ("wgmma" if S % 8 == 0 else "aligned")
    assert op.candidates == ((64, 64), (64, 128))
    assert (op.block_q, op.block_kv) in op.candidates
    args = op._example_args()
    got = op.forward(*args)
    want = np.asarray(jop.forward(*jop._example_args()), np.float32)
    _held(got, want, "float16")


# the support sweep: every config builds and matches JAX's oracle
SWEEP_DIMS = (16, 48, 80, 100, 112, 160, 200, 384, 512)
SWEEP_HEADS = ((1, 1), (3, 3), (4, 2), (6, 3))
SWEEP_S = 24


def _exact_inputs(seed, H, Hkv, D):
    """Q, K, V in float32 whose values float16 and bfloat16 both hold
    exactly (8 significant bits, none below float16's normal range), so
    one oracle call serves the three types."""
    Q, K, V = _prefill_inputs(seed, SWEEP_S, H, Hkv, D)
    out = []
    for a in (Q, K, V):
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        out.append(np.where(np.abs(a) < 2.0 ** -14, 0.0, a)
                   .astype(np.float32))
    return out


@pytest.mark.parametrize("D", SWEEP_DIMS)
def test_every_config_builds_and_matches_jax(D):
    """Every config of the grid: no refusal, the port's operator and JAX's
    build, and the port's forward matches JAX's oracle (the float32
    config's ref_program on the same values, cast to the output type as
    JAX's does)."""
    for (H, Hkv), causal in itertools.product(SWEEP_HEADS, (True, False)):
        Q, K, V = _exact_inputs(D + H, H, Hkv, D)
        oracle = JaxFlashAtten(JaxFlashAttenConfig(
            batch=1, heads=H, kv_heads=Hkv, seq_len=SWEEP_S, dim=D,
            Q_dtype="float32", Out_dtype="float32", is_causal=causal))
        want = np.asarray(oracle.ref_program(*map(jnp.asarray, (Q, K, V))))
        for dtype, layout in itertools.product(
                ("float16", "bfloat16", "float32"), ("nnn", "ntn")):
            cfg = dict(batch=1, heads=H, kv_heads=Hkv, seq_len=SWEEP_S,
                       dim=D, Q_dtype=dtype, Out_dtype=dtype, layout=layout,
                       is_causal=causal)
            tdt = getattr(torch, dtype)
            trans_k = layout == "ntn"
            assert flash.prefill_refusal(SWEEP_S, H, Hkv, D, tdt,
                                         causal=causal,
                                         trans_k=trans_k) is None
            op = FlashAtten(FlashAttenConfig(**cfg), device="cpu")
            JaxFlashAtten(JaxFlashAttenConfig(**cfg), enable_tuning=False)
            k = np.ascontiguousarray(K.transpose(0, 3, 2, 1)) if trans_k \
                else K
            got = op.forward(*(torch.from_numpy(a).to(tdt)
                               for a in (Q, k, V)))
            assert got.dtype == tdt
            assert_close(got, want.astype(ml_dtypes.bfloat16 if dtype ==
                                          "bfloat16" else dtype)
                         .astype(np.float32), rtol=0.0, atol=ATOL[dtype],
                         max_mismatched_ratio=0.0, msg=str(cfg))


def test_caps_raise_naming_them():
    f16 = torch.float16
    cap = flash.GENERAL_MAX_HEAD_DIM
    for dtype in (f16, torch.bfloat16, torch.float32):
        assert flash.check_prefill(1, 64, 3, 3, cap, dtype, dtype) \
            == (64, 64)
        with pytest.raises(NotImplementedError, match=f"up to {cap}"):
            flash.check_prefill(1, 64, 3, 3, cap + 8, dtype, dtype)
    with pytest.raises(NotImplementedError, match=f"up to {cap}"):
        FlashAtten(FlashAttenConfig(batch=1, heads=2, seq_len=64,
                                    dim=cap + 128), device="cpu")
    # what JAX refuses, the port refuses with JAX's class
    with pytest.raises(NotImplementedError, match="causal"):
        flash.check_prefill(1, 64, 2, 2, 80, f16, f16, causal=False,
                            window=16)
    # decode: D % 128 == 0 up to the cap, over slices of 128 above 256
    top = flash.DECODE_MAX_HEAD_DIM
    for D in range(128, top + 1, 128):
        flash._check_decode("flash_decode", 4, 16, 4, D)
    assert [flash.decode_slices(D) for D in (128, 256, 384, 1024)] == \
        [1, 1, 3, 8]
    for D in (top + 128, 320):
        with pytest.raises(NotImplementedError, match=f"up to {top}"):
            flash._check_decode("flash_decode", 4, 16, 4, D)


def test_variants_name_the_new_instances():
    assert flash.prefill_variant(torch.bfloat16, 80, window=4096) == \
        "bfloat16 d80 window"
    assert flash.prefill_variant(torch.float16, 512, instance="general") == \
        "float16 general d512"
    assert flash.prefill_variant(torch.float32, 6,
                                 out_dtype=torch.float16) == \
        "float32 d6 out float16"
    assert 80 in flash.HEAD_DIMS
    for D, H, S, trans_k, want in ((80, 1, 64, False, "wgmma"),
                                   (80, 5, 64, False, "wgmma"),
                                   (100, 4, 64, False, "wgmma"),
                                   (100, 5, 64, False, "aligned"),
                                   (128, 4, 161, True, "aligned"),
                                   (128, 4, 161, False, "wgmma"),
                                   (512, 4, 64, False, "general")):
        assert flash.prefill_instance(S, H, H, D, torch.float16,
                                      trans_k=trans_k) == want
    for D in (6, 256, 288, flash.GENERAL_MAX_HEAD_DIM):
        assert flash.prefill_instance(64, 3, 3, D, torch.float32) == "f32"
    assert flash.prefill_tiles(64, torch.float16, "general") == ((64, 64),)


# -- kernels 5-8 at D = 384 ----------------------------------------------------

DD, DH, DHKV, SPAN = 384, 4, 2, 128
DLEN = np.array([0, 1, 63, 65, SPAN], np.int32)
DEC_ATOL = 1e-2


def _decode_inputs(kind, seed):
    """numpy operands of `kind` (slot / paged, float / int8), the index
    and lengths; rows past each length hold 1e4 or extreme codes."""
    rng = np.random.default_rng(seed)
    B = len(DLEN)
    q = rng.standard_normal((B, DH, DD)).astype(np.float16)
    quant = kind.endswith("quant")
    if kind.startswith("slot"):
        index = rng.permutation(B + 1)[:B].astype(np.int32)
        shape = (B + 1, SPAN, DHKV, DD)
    else:
        bs = SPAN                # JAX's int8 pool takes 128-row pages
        need = [-(-int(n) // bs) for n in DLEN]
        perm = rng.permutation(np.arange(1, 2 + sum(need)))
        index = np.zeros((B, 1), np.int32)
        at = 0
        for b, n in enumerate(need):
            index[b, :n] = perm[at:at + n]
            at += n
        shape = (2 + sum(need), bs, DHKV, DD)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.2 + 0.05).astype(np.float32) * 20
        vs = (rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32)
        arrays = [q, k, v, ks, vs]
        stale = [(k, 127), (v, -128), (ks, 1e4), (vs, 1e4)]
    else:
        k = (rng.standard_normal(shape) * 20).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        arrays = [q, k, v]
        stale = [(k, 1e4), (v, -1e4)]
    for x, val in stale:
        for b, n in enumerate(DLEN):
            if kind.startswith("slot"):
                x[index[b], n:] = val
            elif n % shape[1]:
                x[index[b, n // shape[1]], n % shape[1]:] = val
    return arrays, index


def _torch(arrays, quant):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if not quant:
        t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    return t


@pytest.mark.parametrize("kind", ["slot", "slot_quant", "paged",
                                  "paged_quant"])
def test_decode_plains_match_jax_at_d384(kind):
    arrays, index = _decode_inputs(kind, seed=len(kind))
    quant = kind.endswith("quant")
    B = len(DLEN)
    jarr = arrays if quant else arrays[:1] + [
        a.astype(ml_dtypes.bfloat16) for a in arrays[1:]]
    if kind.startswith("slot"):
        maker = make_flash_decode_quant if quant else make_flash_decode
        fn = maker(batch=B, heads=DH, max_seq_len=SPAN, dim=DD,
                   kv_heads=DHKV, block_kv=128, interpret=True)
        jargs = (*jarr, DLEN, index)
    else:
        maker = make_flash_decode_paged_quant if quant \
            else make_flash_decode_paged
        fn = maker(batch=B, heads=DH, block_size=SPAN, max_blocks=1,
                   dim=DD, kv_heads=DHKV, interpret=True)
        jargs = (*jarr, index, DLEN)
    want = np.asarray(fn(*(jnp.asarray(a) for a in jargs)), np.float32)
    t = _torch(arrays, quant)
    idx, lens = torch.from_numpy(index), torch.from_numpy(DLEN)
    if kind == "slot":
        got = flash.flash_decode(*t, lens, idx)
        entry = pkv.decode_attention(t[0], t[1], t[2], idx, lens,
                                     num_heads=DH)
    elif kind == "slot_quant":
        got = flash.flash_decode_quant(*t, lens, idx)
        entry = pkv.decode_attention_quant(*t, idx, lens, num_heads=DH)
    elif kind == "paged":
        got = flash.flash_decode_paged(*t, idx, lens)
        entry = pkv.decode_attention_paged(*t, idx, lens, num_heads=DH)
    else:
        got = flash.flash_decode_paged_quant(*t, idx, lens)
        entry = pkv.decode_attention_paged_quant(*t, idx, lens,
                                                 num_heads=DH)
    assert got.shape == (B, DH, DD) and torch.equal(entry, got)
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # length 0
    assert_close(got, want, rtol=0.0, atol=DEC_ATOL,
                 max_mismatched_ratio=0.0)
    if kind.startswith("slot"):
        # the split arithmetic the kernels run, against the plain version
        split = flash.flash_decode_split_plain(
            t[0], t[1], t[2], lens, idx,
            k_scale=t[3] if quant else None, v_scale=t[4] if quant else None)
        assert_close(split, got.float().numpy(), rtol=0.0, atol=4e-3,
                     max_mismatched_ratio=0.0)


@pytest.mark.parametrize("quant", [False, True])
def test_partial_stats_match_jax_at_d384(quant):
    kind = "slot_quant" if quant else "slot"
    arrays, index = _decode_inputs(kind, seed=7)
    t = _torch(arrays, quant)
    idx, lens = torch.from_numpy(index), torch.from_numpy(DLEN)
    B = len(DLEN)
    if quant:
        got = flash.flash_decode_quant(*t, lens, idx, partial_stats=True)
        fn = make_flash_decode_quant(batch=B, heads=DH, max_seq_len=SPAN,
                                     dim=DD, kv_heads=DHKV, block_kv=128,
                                     partial_stats=True, interpret=True)
        jarr = arrays
    else:
        got = flash.flash_decode(*t, lens, idx, partial_stats=True)
        fn = make_flash_decode(batch=B, heads=DH, max_seq_len=SPAN, dim=DD,
                               kv_heads=DHKV, block_kv=128,
                               partial_stats=True, interpret=True)
        jarr = arrays[:1] + [a.astype(ml_dtypes.bfloat16)
                             for a in arrays[1:]]
    want = fn(*(jnp.asarray(a) for a in (*jarr, DLEN, index)))
    acc, m, l = (np.asarray(x, np.float32) for x in got)
    wa, wm, wl = (np.asarray(x, np.float32) for x in want)
    assert_close(m, wm, rtol=2.0 ** -18, atol=1e-3, max_mismatched_ratio=0.0)
    for a, w in ((l, wl), (acc, wa)):
        assert_close(a, w, rtol=0.0, atol=1e-2 * float(np.abs(w).max()),
                     max_mismatched_ratio=0.0)
    assert torch.all(got[0][0] == 0) and torch.all(got[2][0] == 0)
    assert torch.all(got[1][0] == torch.tensor(flash.EMPTY_M) * flash.LN2)

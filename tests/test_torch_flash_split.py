"""The split-KV arithmetic of the port's decode kernels (CPU): the host's
split planner, and `flash_decode_split_plain` -- per-chunk base-2 partials
and the fixed-order merge the CUDA kernels compute -- held against the
JAX Pallas decode kernels in interpret mode and against the port's
single-pass plain versions.

Inputs: q f16, K amplified 20x so that a head or chunk mix-up cannot hide
in a near-uniform softmax, GQA groups 1/4/8 at H = 8, the slot cache
(bf16, int8) and the block pool (bf16 at bs = 16: four pages a tile;
int8 at bs = 128, the JAX kernel's page size), a span of 256 keys cut
into chunks of 64, lengths {0, 1, chunk - 1, chunk, chunk + 1, span}.

Tolerances:
- against JAX, atol 1e-2: scores reach a few hundred in the base-2
  domain, where the two sides' f32 dot products (summed in other orders)
  differ by ~1e-5 relative, i.e. ~0.3% in a weight, on outputs that are
  convex mixes of V rows (|.| < 5); the JAX kernels also round P to f16;
- against the single-pass plain version, atol 4e-3: the same f32
  arithmetic regrouped by chunk, so the outputs differ by at most one f16
  rounding of |out| < 4 (2^-8).
Stale rows past each length are 1e4 (or extreme codes and scales) where
JAX reads them masked, and NaN where only the port's versions run: those
never read them.
"""

import inspect

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import (make_flash_decode,
                                       make_flash_decode_paged,
                                       make_flash_decode_paged_quant,
                                       make_flash_decode_quant)

from bitblas_tpu_torch.kernels.flash import (
    DECODE_TILE, MAX_SPLITS, flash_decode_paged_plain,
    flash_decode_paged_quant_plain, flash_decode_plain,
    flash_decode_quant_plain, flash_decode_split_plain, plan_splits)
from bitblas_tpu_torch.testing import assert_close

D, H, SPAN = 128, 8, 256
SMS = 132
KINDS = ("slot", "slot_quant", "paged", "paged_quant")
JAX_ATOL = 1e-2
PLAIN_ATOL = 4e-3


def test_plan_splits_takes_static_sizes_only():
    assert list(inspect.signature(plan_splits).parameters) == [
        "span", "batch", "kv_heads", "sms"]
    with pytest.raises(ValueError):
        plan_splits(0, 1, 1)
    with pytest.raises(ValueError):
        plan_splits(64, 1, 0)


@pytest.mark.parametrize("span,B,Hkv", [
    (1024, 4, 32), (1024, 4, 8), (2048, 1, 8), (200, 3, 2), (64, 1, 1),
    (300000, 1, 1)])
def test_plan_splits_covers_each_live_key_once(span, B, Hkv):
    chunk, splits = plan_splits(span, B, Hkv, SMS)
    assert chunk % DECODE_TILE == 0 and chunk >= DECODE_TILE
    assert splits == -(-span // chunk) and splits <= MAX_SPLITS
    tiles = -(-span // DECODE_TILE)
    if tiles * B * Hkv >= 2 * SMS and tiles <= MAX_SPLITS:
        assert B * Hkv * splits >= 2 * SMS
    for length in range(0, span + 1, 1 if span <= 4096 else 997):
        # the kernels: split s is live iff s * chunk < length, and covers
        # [s * chunk, min((s + 1) * chunk, length))
        live = [s for s in range(splits) if s * chunk < length]
        covered = np.zeros(length, np.int64)
        for s in live:
            covered[s * chunk:min((s + 1) * chunk, length)] += 1
        assert (covered == 1).all()
        assert len(live) == -(-length // chunk)


def _lengths():
    chunk, _ = plan_splits(SPAN, 6, 1, SMS)
    assert chunk == 64        # every group below cuts the span in 4
    return np.array([0, 1, chunk - 1, chunk, chunk + 1, SPAN], np.int32)


def _inputs(kind, Hkv, seed, stale):
    """numpy operands of `kind` and the index (slots or tables); rows past
    each length (and, paged, block 0 and the tail of the last page) hold
    `stale`: 1e4 / extreme codes and scales, or NaN."""
    rng = np.random.default_rng(seed)
    lengths = _lengths()
    B = len(lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float16)
    quant = kind.endswith("quant")
    if kind.startswith("slot"):
        rows = B + 1
        index = rng.permutation(rows)[:B].astype(np.int32)
        shape = (rows, SPAN, Hkv, D)
    else:
        bs = 128 if quant else 16
        MB = SPAN // bs
        need = [-(-int(n) // bs) for n in lengths]
        blocks = 1 + sum(need) + 1
        perm = rng.permutation(np.arange(1, blocks))
        index = np.zeros((B, MB), np.int32)
        at = 0
        for b, n in enumerate(need):
            index[b, :n] = perm[at:at + n]
            at += n
        shape = (blocks, bs, Hkv, D)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.2 + 0.05).astype(np.float32) * 20
        vs = (rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32)
        planes = [(k, 127), (v, -128), (ks, stale), (vs, stale)]
    else:
        k = (rng.standard_normal(shape) * 20).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        planes = [(k, stale), (v, -stale)]
    for x, val in planes:
        for b, n in enumerate(lengths):
            if kind.startswith("slot"):
                x[index[b], n:] = val
            else:
                bs = shape[1]
                x[0] = val
                if n % bs:
                    x[index[b, n // bs], n % bs:] = val
    arrays = [q, k, v] + ([ks, vs] if quant else [])
    return arrays, index, lengths


def _jax(kind, arrays, index, lengths, Hkv):
    B = len(lengths)
    quant = kind.endswith("quant")
    if not quant:
        arrays = arrays[:1] + [a.astype(ml_dtypes.bfloat16)
                               for a in arrays[1:]]
    if kind == "slot":
        fn = make_flash_decode(batch=B, heads=H, max_seq_len=SPAN, dim=D,
                               kv_heads=Hkv, block_kv=128, interpret=True)
        args = (*arrays, lengths, index)
    elif kind == "slot_quant":
        fn = make_flash_decode_quant(batch=B, heads=H, max_seq_len=SPAN,
                                     dim=D, kv_heads=Hkv, block_kv=128,
                                     interpret=True)
        args = (*arrays, lengths, index)
    else:
        maker = make_flash_decode_paged_quant if quant \
            else make_flash_decode_paged
        fn = maker(batch=B, heads=H, block_size=arrays[1].shape[1],
                   max_blocks=index.shape[1], dim=D, kv_heads=Hkv,
                   interpret=True)
        args = (*arrays, index, lengths)
    return np.asarray(fn(*(jnp.asarray(a) for a in args)), np.float32)


def _torch(kind, arrays, index, lengths):
    """(the split plain version's output, the single-pass plain's)."""
    quant = kind.endswith("quant")
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if not quant:
        t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    q, k, v = t[:3]
    ks, vs = (t[3], t[4]) if quant else (None, None)
    idx, lens = torch.from_numpy(index), torch.from_numpy(lengths)
    paged = kind.startswith("paged")
    split = flash_decode_split_plain(q, k, v, lens, idx, paged=paged,
                                     k_scale=ks, v_scale=vs, sms=SMS)
    if kind == "slot":
        single = flash_decode_plain(q, k, v, lens, idx)
    elif kind == "slot_quant":
        single = flash_decode_quant_plain(q, k, v, ks, vs, lens, idx)
    elif kind == "paged":
        single = flash_decode_paged_plain(q, k, v, idx, lens)
    else:
        single = flash_decode_paged_quant_plain(q, k, v, ks, vs, idx, lens)
    return split, single


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_split_plain_matches_jax(kind, group):
    Hkv = H // group
    arrays, index, lengths = _inputs(kind, Hkv, 10 + group, stale=1e4)
    want = _jax(kind, arrays, index, lengths, Hkv)
    split, _ = _torch(kind, arrays, index, lengths)
    assert split.dtype == torch.float16
    assert torch.equal(split[0], torch.zeros_like(split[0]))   # length 0
    assert_close(split, want, rtol=0.0, atol=JAX_ATOL,
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_split_plain_matches_single_pass_with_nan_stale_rows(kind, group):
    arrays, index, lengths = _inputs(kind, H // group, 20 + group,
                                     stale=float("nan"))
    split, single = _torch(kind, arrays, index, lengths)
    assert torch.isfinite(split).all()
    assert torch.equal(split[0], torch.zeros_like(split[0]))   # length 0
    assert_close(split, single.float().numpy(), rtol=0.0, atol=PLAIN_ATOL,
                 max_mismatched_ratio=0.0)
    again, _ = _torch(kind, arrays, index, lengths)
    assert torch.equal(split, again)            # the merge's fixed order

"""The arithmetic of kernels 5-8's wide instances (head dims above 256, a
cluster of D / 128 column slices, csrc/flash_decode.cuh) against JAX's
decode kernels on the CPU.

`flash.flash_decode_split_plain` is the cluster's walk in plain PyTorch:
each 128-column slice dots its own columns, the partial scores add up in
slice order 0 .. n-1 into the scores every slice shares (one softmax, one
m and l), each slice accumulates P V over its own columns, and the splits
of a sequence merge per slice in split order. It runs here at D = 512 and
384 over the slot cache, its int8 codes, the block pool and its int8
codes, with a window on the slot caches and in kernels 5-6's
partial_stats mode, against JAX's `make_flash_decode{,_quant,_paged,
_paged_quant}` in interpret mode, and against the single-pass plain
versions the wrappers take on the CPU.

Inputs: N(0, 1) from numpy with K amplified 20x (scores of a few hundred
in the base-2 domain), so a head mix-up or a slice whose columns or
order go astray cannot hide in a near-uniform softmax; rows past each
length hold 1e4 or extreme codes, which no kernel may read. Limits:
D512_DECODE_TOL, 1e-2 absolute, against JAX (chip_smoke.py's limit of the
D = 512 card rows: f32 dot products in other orders, JAX rounds P to
float16); 4e-3 against the single-pass plain version (the same float32
arithmetic regrouped by slice and split); partial_stats as
tests/test_torch_flash_dims.py (m to 2^-18 relative plus 1e-3, acc and l
1e-2 of their largest value).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import (make_flash_decode,
                                       make_flash_decode_paged,
                                       make_flash_decode_paged_quant,
                                       make_flash_decode_quant)

from bitblas_tpu_torch.kernels import flash
from bitblas_tpu_torch.testing import assert_close

D512_DECODE_TOL = 1e-2
SPLIT_TOL = 4e-3
H, HKV, SPAN, WINDOW = 8, 2, 128, 64
LENGTHS = np.array([0, 1, 63, 65, SPAN], np.int32)


def _inputs(kind: str, D: int, seed: int):
    """numpy operands of `kind` (slot / paged, float / int8) at head dim
    D, the index (slots or tables); rows past each length hold 1e4 or
    extreme codes."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    q = rng.standard_normal((B, H, D)).astype(np.float16)
    quant = kind.endswith("quant")
    if kind.startswith("slot"):
        index = rng.permutation(B + 1)[:B].astype(np.int32)
        shape = (B + 1, SPAN, HKV, D)
    else:                                # one 128-row page a sequence
        index = rng.permutation(np.arange(1, B + 1))[:, None] \
            .astype(np.int32)
        shape = (B + 1, SPAN, HKV, D)
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
    rows = index if kind.startswith("slot") else index[:, 0]
    for x, val in stale:
        for b, n in enumerate(LENGTHS):
            x[rows[b], n:] = val
    return arrays, index


def _torch(arrays, quant):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if not quant:
        t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    return t


def _jax(kind, arrays, index, D, window=None, stats=False):
    quant = kind.endswith("quant")
    B = len(LENGTHS)
    jarr = arrays if quant else arrays[:1] + [
        a.astype(ml_dtypes.bfloat16) for a in arrays[1:]]
    if kind.startswith("slot"):
        maker = make_flash_decode_quant if quant else make_flash_decode
        fn = maker(batch=B, heads=H, max_seq_len=SPAN, dim=D, kv_heads=HKV,
                   block_kv=SPAN, window=window, partial_stats=stats,
                   interpret=True)
        args = (*jarr, LENGTHS, index)
    else:
        maker = make_flash_decode_paged_quant if quant \
            else make_flash_decode_paged
        fn = maker(batch=B, heads=H, block_size=SPAN, max_blocks=1, dim=D,
                   kv_heads=HKV, interpret=True)
        args = (*jarr, index, LENGTHS)
    out = fn(*(jnp.asarray(a) for a in args))
    if stats:
        return tuple(np.array(x, np.float32) for x in out)
    return np.array(out, np.float32)


def _cluster_walk(kind, t, index, window=None, stats=False):
    quant = kind.endswith("quant")
    lens = torch.from_numpy(LENGTHS)
    return flash.flash_decode_split_plain(
        t[0], t[1], t[2], lens, torch.from_numpy(index),
        paged=kind.startswith("paged"),
        k_scale=t[3] if quant else None, v_scale=t[4] if quant else None,
        window=window, stats=stats)


def _single_pass(kind, t, index, window=None):
    idx, lens = torch.from_numpy(index), torch.from_numpy(LENGTHS)
    if kind == "slot":
        return flash.flash_decode(*t, lens, idx, window=window)
    if kind == "slot_quant":
        return flash.flash_decode_quant(*t, lens, idx, window=window)
    if kind == "paged":
        return flash.flash_decode_paged(*t, idx, lens)
    return flash.flash_decode_paged_quant(*t, idx, lens)


@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("kind", ["slot", "slot_quant", "paged",
                                  "paged_quant"])
def test_cluster_walk_matches_jax(kind, D):
    assert flash.decode_slices(D) == D // 128
    arrays, index = _inputs(kind, D, seed=D + len(kind))
    t = _torch(arrays, kind.endswith("quant"))
    got = _cluster_walk(kind, t, index)
    assert got.shape == (len(LENGTHS), H, D) and got.dtype == torch.float16
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # length 0
    assert_close(got, _jax(kind, arrays, index, D), rtol=0.0,
                 atol=D512_DECODE_TOL, max_mismatched_ratio=0.0)
    assert_close(got, _single_pass(kind, t, index).float().numpy(),
                 rtol=0.0, atol=SPLIT_TOL, max_mismatched_ratio=0.0)


@pytest.mark.parametrize("kind", ["slot", "slot_quant"])
def test_cluster_walk_window_matches_jax(kind):
    """A window of 64 over lengths around it: each sequence's splits start
    at its band, the slices share the band's scores."""
    D = 512
    arrays, index = _inputs(kind, D, seed=11 + len(kind))
    t = _torch(arrays, kind.endswith("quant"))
    got = _cluster_walk(kind, t, index, window=WINDOW)
    assert_close(got, _jax(kind, arrays, index, D, window=WINDOW), rtol=0.0,
                 atol=D512_DECODE_TOL, max_mismatched_ratio=0.0)
    assert_close(got, _single_pass(kind, t, index, WINDOW).float().numpy(),
                 rtol=0.0, atol=SPLIT_TOL, max_mismatched_ratio=0.0)


@pytest.mark.parametrize("kind", ["slot", "slot_quant"])
def test_cluster_walk_partial_stats_match_jax(kind):
    """Kernels 5-6's partial_stats triple of the cluster's walk: m and l
    shared by the slices, acc per slice, an empty sequence m = -1e30 ln 2,
    l = 0, acc = 0."""
    D = 512
    arrays, index = _inputs(kind, D, seed=23 + len(kind))
    t = _torch(arrays, kind.endswith("quant"))
    acc, m, l = (x.numpy() for x in _cluster_walk(kind, t, index,
                                                  stats=True))
    wa, wm, wl = _jax(kind, arrays, index, D, stats=True)
    assert_close(m, wm, rtol=2.0 ** -18, atol=1e-3, max_mismatched_ratio=0.0)
    for a, w in ((l, wl), (acc, wa)):
        assert_close(a, w, rtol=0.0, atol=1e-2 * float(np.abs(w).max()),
                     max_mismatched_ratio=0.0)
    assert np.all(acc[0] == 0) and np.all(l[0] == 0)
    assert np.all(m[0] == np.float32(flash.EMPTY_M * flash.LN2))

"""bitblas_tpu_torch.quantization.gptq against the JAX package's numpy
quantizers (bitblas_tpu/quantization/gptq.py) on the CPU.

- `rtn_quantize`: codes, scales and zeros bit for bit over bits 2 / 3 / 4
  / 8, symmetric or not, groups 32 / 128 / per row.
- `gptq_quantize` given JAX's own Hessian: codes bit for bit, scales and
  zeros equal (both sweep in float64; only the order of the inverse's and
  the block products' sums can differ, in the last float64 bit).
- `HessianAccumulator`: within float64 rounding (rtol 1e-13).
- JAX's properties (tests/test_quantize.py) ported: the RTN grid and its
  half-step bound, symmetric zeros, discrete weights round trip, an
  identity Hessian gives RTN, GPTQ beats RTN on its objective (< 0.9x),
  validation errors, dead columns, the caller's weight untouched.
- A numpy weight goes to the card by default (here: raises), to the CPU
  only with device="cpu".
- Stacked rows (q / k / v, gate / up under one Hessian) give the codes of
  separate sweeps, bit for bit.
- The card's blocked sweep (static buffers, a captured CUDA graph
  replayed a block) with the replay emulated by the same `_sweep` on the
  same buffers: bit for bit the eager sweep's and JAX's codes.
- The division trap: the scales divide by a tensor, as numpy divides; a
  weight whose codes move when the scale is taken as rng * (1 / maxq) (how
  CUDA evaluates ``t / c`` for a Python number c) keeps numpy's codes.
"""

import numpy as np
import pytest
import torch

from bitblas_tpu.quantization import gptq as jgptq

from bitblas_tpu_torch.quantization.gptq import (HessianAccumulator,
                                                 QuantizedWeight,
                                                 gptq_quantize, rtn_quantize)


def _rand_w(n=32, k=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)) * 0.02).astype(np.float32)


def _hessian(k=256, m=2048, seed=4):
    """A correlated input's Hessian (JAX's test_quantize fixture), and the
    inputs."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((k, k)) * 0.3 + np.eye(k)
    x = rng.standard_normal((m, k)).astype(np.float32) @ mix.astype(
        np.float32)
    acc = jgptq.HessianAccumulator(k)
    acc.update(x)
    return acc.hessian, x


def _equal(got: QuantizedWeight, want) -> None:
    np.testing.assert_array_equal(got.codes.numpy(), want.codes)
    np.testing.assert_array_equal(got.scales.numpy(), want.scales)
    np.testing.assert_array_equal(got.zeros.numpy(), want.zeros)
    assert got.codes.dtype == torch.uint8
    assert (got.bits, got.group_size) == (want.bits, want.group_size)


@pytest.mark.parametrize("group", [32, 128, -1])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_rtn_matches_jax(bits, symmetric, group):
    w = _rand_w(48, 256, seed=bits + 10 * symmetric)
    got = rtn_quantize(torch.from_numpy(w), bits, group, symmetric)
    _equal(got, jgptq.rtn_quantize(w, bits, group, symmetric))
    np.testing.assert_array_equal(
        got.dequantize().numpy(),
        jgptq.rtn_quantize(w, bits, group, symmetric).dequantize())


@pytest.mark.parametrize("group", [32, 128, -1])
@pytest.mark.parametrize("symmetric", [False, True])
def test_gptq_matches_jax_given_its_hessian(symmetric, group):
    h, _ = _hessian()
    w = _rand_w(64, 256, seed=5 + group)
    got = gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), 4, group,
                        symmetric)
    _equal(got, jgptq.gptq_quantize(w, h, 4, group, symmetric))


def test_gptq_blocksize_and_damping_match_jax():
    h, _ = _hessian(seed=6)
    w = _rand_w(40, 256, seed=7)
    got = gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), 3, 64,
                        percdamp=0.1, blocksize=96)
    _equal(got, jgptq.gptq_quantize(w, h, 3, 64, percdamp=0.1,
                                    blocksize=96))


def test_hessian_accumulator_matches_jax():
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((3, 5, 64), (7, 64), (64,))]
    want = jgptq.HessianAccumulator(64)
    got = HessianAccumulator(64, device="cpu")
    for x in xs:
        want.update(x)
        got.update(torch.from_numpy(x))
    assert got.count == want.count == 23
    np.testing.assert_allclose(got.hessian.numpy(), want.hessian,
                               rtol=1e-13, atol=0)
    assert got.hessian.dtype == torch.float64


def test_rtn_grid_and_error_bound():
    w = _rand_w()
    qw = rtn_quantize(torch.from_numpy(w), bits=4, group_size=128)
    assert int(qw.codes.min()) >= 0 and int(qw.codes.max()) <= 15
    assert qw.scales.shape == (32, 2) and qw.zeros.shape == (32, 2)
    g = np.repeat(np.arange(2), 128)
    err = np.abs(qw.dequantize().numpy() - w)
    assert np.all(err <= 0.5 * qw.scales.numpy()[:, g] + 1e-7)


def test_rtn_symmetric_centers_zero():
    qw = rtn_quantize(torch.from_numpy(_rand_w(seed=1)), 4, 128,
                      symmetric=True)
    assert torch.all(qw.zeros == 8.0)


def test_rtn_roundtrips_discrete_weights():
    rng = np.random.default_rng(2)
    w = (rng.integers(0, 16, (8, 128)) - 5).astype(np.float32) * 0.01
    qw = rtn_quantize(torch.from_numpy(w), bits=4, group_size=128)
    np.testing.assert_allclose(qw.dequantize().numpy(), w, atol=1e-6)


def test_gptq_identity_hessian_equals_rtn():
    w = torch.from_numpy(_rand_w(seed=3))
    rtn = rtn_quantize(w, bits=4, group_size=128)
    gptq = gptq_quantize(w, torch.eye(256, dtype=torch.float64), 4, 128,
                         percdamp=0.0)
    assert torch.equal(gptq.codes, rtn.codes)
    assert torch.equal(gptq.scales, rtn.scales)
    assert torch.equal(gptq.zeros, rtn.zeros)


def test_gptq_beats_rtn_on_calibration_objective():
    h, _ = _hessian()
    w = _rand_w(64, 256, seed=5)
    ht = torch.from_numpy(h)

    def obj(dq):
        e = (torch.from_numpy(w) - dq).double()
        return float(torch.einsum("nk,kl,nl->", e, ht, e))

    loss_rtn = obj(rtn_quantize(torch.from_numpy(w), 4, 128).dequantize())
    loss_gptq = obj(gptq_quantize(torch.from_numpy(w), ht, 4,
                                  128).dequantize())
    assert loss_gptq < 0.9 * loss_rtn, (loss_gptq, loss_rtn)


def test_validation_errors():
    with pytest.raises(ValueError, match="divisible"):
        rtn_quantize(torch.from_numpy(_rand_w(8, 200)), 4, 128)
    with pytest.raises(ValueError, match="hessian shape"):
        gptq_quantize(torch.from_numpy(_rand_w(8, 256)),
                      torch.eye(8, dtype=torch.float64), 4, 128)
    with pytest.raises(ValueError, match="bits"):
        rtn_quantize(torch.from_numpy(_rand_w(8, 256)), 9, 128)
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        rtn_quantize(torch.zeros(256), 4, 128)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
@pytest.mark.parametrize("fn", ["rtn", "gptq"])
def test_numpy_weight_goes_to_the_card(fn):
    """A numpy weight is quantized on the card unless `device=` says
    otherwise: here, with no card, it raises instead of quietly running on
    the CPU; with device="cpu" it gives the codes of a CPU tensor, and
    JAX's."""
    w = _rand_w(8, 256, seed=10)
    h, _ = _hessian(seed=11)
    run = {"rtn": lambda x, **kw: rtn_quantize(x, 4, 128, **kw),
           "gptq": lambda x, **kw: gptq_quantize(x, h, 4, 128, **kw)}[fn]
    with pytest.raises(RuntimeError, match="cuda"):
        run(w)
    want = (jgptq.rtn_quantize(w, 4, 128) if fn == "rtn"
            else jgptq.gptq_quantize(w, h, 4, 128))
    got = run(w, device="cpu")
    assert got.codes.device.type == "cpu"
    _equal(got, want)
    _equal(run(torch.from_numpy(w)), want)


def test_dead_columns_and_no_mutation():
    """A zero-diagonal column quantizes as a zero weight, as JAX's; the
    caller's tensor is not written."""
    w = _rand_w(8, 256, seed=9)
    h = np.eye(256)
    h[3, 3] = h[200, 200] = 0.0
    wt = torch.from_numpy(w.copy())
    got = gptq_quantize(wt, torch.from_numpy(h), 4, 128)
    assert torch.equal(wt, torch.from_numpy(w))
    _equal(got, jgptq.gptq_quantize(w, h, 4, 128))
    dq = got.dequantize()
    assert torch.all(dq[:, 3] == 0) and torch.all(dq[:, 200] == 0)


@pytest.mark.parametrize("sizes", [(48, 16, 16), (64, 64)])
def test_stacked_rows_equal_separate_sweeps(sizes):
    """q / k / v (or gate / up) swept as one [sum N, K] weight under their
    shared Hessian: each one's codes, scales and zeros are its own
    sweep's."""
    h, _ = _hessian(seed=11)
    ws = [torch.from_numpy(_rand_w(n, 256, seed=20 + i))
          for i, n in enumerate(sizes)]
    stacked = gptq_quantize(torch.cat(ws), torch.from_numpy(h), 4, 128)
    r0 = 0
    for w in ws:
        one = gptq_quantize(w, torch.from_numpy(h), 4, 128)
        rows = slice(r0, r0 + w.shape[0])
        assert torch.equal(stacked.codes[rows], one.codes)
        assert torch.equal(stacked.scales[rows], one.scales)
        assert torch.equal(stacked.zeros[rows], one.zeros)
        r0 += w.shape[0]


def _reciprocal_codes(w: np.ndarray, maxq: int) -> np.ndarray:
    """RTN codes of one group per row with the scale taken as rng * (1 /
    maxq) in float32: how CUDA evaluates a float32 tensor over a Python
    number."""
    wmax = np.maximum(w.max(axis=1), 0.0)
    wmin = np.minimum(w.min(axis=1), 0.0)
    scale = (wmax - wmin) * np.float32(1.0 / maxq)
    zero = np.clip(np.round(-wmin / scale), 0, maxq)
    return np.clip(np.round(w / scale[:, None]) + zero[:, None], 0, maxq)


def test_scale_division_is_exact():
    """Rows built so that rng * (1 / 15) and rng / 15 round apart and a
    value sits where that moves its code: the port's codes are numpy's
    (true division), not the reciprocal product's."""
    rng = np.random.default_rng(12)
    rows = []
    while len(rows) < 16:
        lo, hi = -rng.uniform(0.01, 0.05), rng.uniform(0.01, 0.05)
        rg = np.float32(np.float32(hi) - np.float32(lo))
        s_true = np.float32(rg / np.float32(15))
        if s_true == rg * np.float32(1.0 / 15):
            continue
        row = rng.uniform(lo, hi, 128).astype(np.float32)
        row[0], row[1] = lo, hi
        # a value on the half step of one scale's grid
        row[2] = np.float32(s_true * np.float32(3.5))
        rows.append(row)
    w = np.stack(rows)
    want = jgptq.rtn_quantize(w, 4, 128)
    assert (_reciprocal_codes(w, 15) != want.codes).any()
    _equal(rtn_quantize(torch.from_numpy(w), 4, 128), want)


@pytest.mark.parametrize("group,blocksize", [(32, 128), (128, 128),
                                             (-1, 128), (128, 64)])
def test_graphed_blocks_equal_the_eager_sweep(monkeypatch, group, blocksize):
    """The card's path (full blocks through `_GraphedSweep`'s static
    buffers, the captured graph's replay) with the replay emulated by
    running the same `_sweep` on the same buffers: codes, scales and zeros
    bit for bit those of the eager sweep and of JAX, at groups inside a
    block, one a block and spanning blocks."""
    from bitblas_tpu_torch.quantization import gptq
    h, _ = _hessian(k=512, seed=13)
    w = _rand_w(24, 512, seed=14)
    want = jgptq.gptq_quantize(w, h, 4, group, blocksize=blocksize)
    monkeypatch.setattr(gptq._GraphedSweep, "takes",
                        staticmethod(lambda *a: True))
    monkeypatch.setattr(gptq._GraphedSweep, "_capture",
                        staticmethod(lambda args: lambda: gptq._sweep(*args)))
    _equal(gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), 4, group,
                         blocksize=blocksize), want)

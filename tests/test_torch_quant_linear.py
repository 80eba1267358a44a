"""bitblas_tpu_torch.integration.pytorch.QuantLinear (CPU: the kernels'
plain versions) against the JAX package's QuantLinear (its Pallas kernel
in interpret mode): pack, the GPTQ v1 / v2 repack and the buffers it
mirrors, post_init after load_state_dict, what it refuses.

Tolerance: `bitblas_tpu_torch.testing.assert_close` with rtol 2e-3 (two
f16 roundings) and atol 2e-2 (outputs ~10 at K = 256, f16 ulp 2^-7), no
element outside; buffers and codes bit-equal.
"""

import types

import numpy as np
import pytest
import torch

from bitblas_tpu.integration.pytorch import QuantLinear as JaxQuantLinear
from bitblas_tpu.quantization import packing as jpack

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.integration.pytorch import QuantLinear
from bitblas_tpu_torch.quantization import packing
from bitblas_tpu_torch.testing import assert_close

IN = OUT = 256
TOL = dict(rtol=2e-3, atol=2e-2, max_mismatched_ratio=0.0)


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


def _fake_quant_linear(group_size, bias, seed=0):
    """A fake-quantized nn.Linear on the 4-bit grid with its (scales,
    zeros), as AutoGPTQ hands them to pack()."""
    rng = np.random.default_rng(seed)
    groups = IN // group_size
    scales = rng.uniform(0.01, 0.05, size=(OUT, groups)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(OUT, groups)).astype(np.float32)
    codes = rng.integers(0, 16, size=(OUT, IN)).astype(np.float32)
    g_idx = np.arange(IN) // group_size
    w = (codes - zeros[:, g_idx]) * scales[:, g_idx]
    lin = torch.nn.Linear(IN, OUT, bias=bias)
    lin.weight.data = torch.from_numpy(w)
    if bias:
        lin.bias.data = torch.from_numpy(
            rng.standard_normal(OUT).astype(np.float32) * 0.1)
    return lin, torch.from_numpy(scales), torch.from_numpy(zeros), codes


def _pair(group_size, bias):
    kw = dict(bits=4, group_size=group_size, in_features=IN,
              out_features=OUT, bias=bias, enable_tuning=False)
    return JaxQuantLinear(**kw), QuantLinear(device="cpu", **kw)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("group_size", [32, 64, 128, -1])
def test_pack_forward_matches_jax(group_size, bias):
    g = IN if group_size == -1 else group_size
    lin, scales, zeros, codes = _fake_quant_linear(g, bias, seed=g)
    jq, pq = _pair(group_size, bias)
    jq.pack(lin, scales, zeros)
    pq.pack(lin, scales, zeros)
    for name in ("qweight", "scales", "zeros") + (("bias",) if bias else ()):
        assert torch.equal(getattr(pq, name), getattr(jq, name)), name
    np.testing.assert_array_equal(
        packing.unpack_qweight(pq.qweight, 4).numpy(), codes.astype(np.int8))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, IN)).astype(np.float32))
    got = pq(x)
    assert got.dtype == x.dtype and got.shape == (2, 3, OUT)
    assert_close(got, jq(x), **TOL)


def _gptq_stub(v2, bias, seed=4):
    rng = np.random.default_rng(seed)
    g = 64
    codes = rng.integers(0, 16, (IN, OUT))
    zeros = rng.integers(1, 15, (IN // g, OUT))
    scales = (rng.standard_normal((IN // g, OUT)) * 0.01 + 0.03).astype(
        np.float16)
    qw, qz, sc = jpack.pack_autogptq(codes, zeros, scales, 4, v2=v2)
    b = rng.standard_normal(OUT).astype(np.float16) if bias else None
    return types.SimpleNamespace(qweight=qw, qzeros=qz, scales=sc, bias=b)


@pytest.mark.parametrize("v2", [False, True])
def test_repack_from_gptq_mirrors_buffers_like_jax(v2):
    stub = _gptq_stub(v2, bias=True)
    jq, pq = _pair(64, True)
    repack = "repack_from_gptq_v2" if v2 else "repack_from_gptq"
    getattr(jq, repack)(stub)
    getattr(pq, repack)(stub)
    for name in ("qweight", "scales", "zeros", "bias"):
        assert torch.equal(getattr(pq, name), getattr(jq, name)), name
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, IN)).astype(np.float16))
    want = pq(x)
    assert_close(want, jq(x), **TOL)
    # a state_dict round trip after the repack gives the same layer
    fresh = QuantLinear(4, 64, IN, OUT, bias=True, device="cpu")
    fresh.load_state_dict(pq.state_dict())
    fresh.post_init()
    assert torch.equal(fresh(x), want)


def test_state_dict_round_trip():
    lin, scales, zeros, _ = _fake_quant_linear(64, True, seed=3)
    pq = QuantLinear(4, 64, IN, OUT, bias=True, device="cpu")
    pq.pack(lin, scales, zeros)
    sd = pq.state_dict()
    assert sd["qweight"].dtype == torch.int8 and \
        tuple(sd["qweight"].shape) == (OUT, IN // 2)
    assert sd["scales"].dtype == torch.half and \
        tuple(sd["zeros"].shape) == (OUT, IN // 64)
    fresh = QuantLinear(4, 64, IN, OUT, bias=True, device="cpu")
    fresh.load_state_dict(sd)
    fresh.post_init()
    x = torch.randn(5, IN, dtype=torch.float16)
    assert torch.equal(fresh(x), pq(x))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_int8_activations_match_jax(bits, bias):
    """QuantLinear(bits, A_dtype="int8"), as JAX builds it (uint codes with
    zeros, grouped, int8 output saturating): pack() the same fake-quantized
    layer on both, buffers bit-equal, forwards on integer-valued
    activations (a float input is taken to int8) bit-equal, saturated
    outputs included."""
    rng = np.random.default_rng(bits)
    g = 64
    scales = torch.from_numpy(rng.uniform(0.01, 0.05, (OUT, IN // g))
                              .astype(np.float32))
    zeros = torch.from_numpy(rng.integers(0, 1 << bits, (OUT, IN // g))
                             .astype(np.float32))
    codes = rng.integers(0, 1 << bits, (OUT, IN)).astype(np.float32)
    gi = np.arange(IN) // g
    lin = torch.nn.Linear(IN, OUT, bias=bias)
    lin.weight.data = torch.from_numpy(
        (codes - zeros.numpy()[:, gi]) * scales.numpy()[:, gi])
    if bias:
        lin.bias.data = torch.from_numpy(rng.standard_normal(OUT).astype(
            np.float32) * 4)
    kw = dict(bits=bits, group_size=g, in_features=IN, out_features=OUT,
              bias=bias, enable_tuning=False, A_dtype="int8")
    jq, pq = JaxQuantLinear(**kw), QuantLinear(device="cpu", **kw)
    assert pq.inner.bitblas_matmul.config.out_dtype == "int8"
    jq.pack(lin, scales, zeros)
    pq.pack(lin, scales, zeros)
    for name in ("qweight", "scales", "zeros") + (("bias",) if bias else ()):
        assert torch.equal(getattr(pq, name), getattr(jq, name)), name
    x = torch.from_numpy(rng.integers(-40, 40, (2, 3, IN)).astype(
        np.float32))
    got, want = pq(x), jq(x)
    assert got.dtype == x.dtype and got.shape == (2, 3, OUT)
    assert torch.equal(got, want)
    assert got.abs().max() == 128 or bits < 4   # uint4 saturates here


def test_quantlinear_rejects_unsupported():
    with pytest.raises(NotImplementedError):
        QuantLinear(3, 64, IN, OUT, bias=False, device="cpu")
    with pytest.raises(NotImplementedError):
        QuantLinear(4, 64, IN, OUT, bias=False, trainable=True,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        QuantLinear(4, 64, IN, OUT, bias=False, layout="nn", device="cpu")
    with pytest.raises(ValueError):
        QuantLinear(4, 96, IN, OUT, bias=False, device="cpu")
    ql = QuantLinear(4, 64, IN, OUT, bias=False, device="cpu")
    with pytest.raises(ValueError, match="bias=True"):
        ql.repack_from_gptq(_gptq_stub(False, bias=True))

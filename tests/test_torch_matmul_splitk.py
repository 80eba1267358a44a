"""MatmulWithSplitK against the JAX package and against the port's own
Matmul, on the CPU.

- Against JAX's MatmulWithSplitK (its kernels in interpret mode): rtol
  1e-2, atol 1.0, the Pallas tolerance of tests/test_torch_splitk.py
  (JAX's kernel decodes to its own mma type); int2 x int8 shards sum
  integers exactly on both sides and are held bit for bit.
- Against the port's Matmul on the whole K: each shard's output is
  rounded to float16 before the float32 sum, so the two differ by at most
  half a float16 ulp of each partial and one ulp of the output (plus the
  float32 sums' order, 2^-18 of the largest output).
- A bias: JAX's split-K raises in its kernel call for k_split > 1 (its
  later shards pass no bias to a kernel built with one), so the port's is
  held to JAX's Matmul with the bias, at the same tolerance.
- The configuration errors are JAX's, message for message.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.ops.matmul_splitk import (
    MatmulConfigWithSplitK as JaxSplitKConfig,
    MatmulWithSplitK as JaxSplitK)
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.testing import random_reference_operands

from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.ops.matmul_splitk import (MatmulConfigWithSplitK,
                                                 MatmulWithSplitK)
from bitblas_tpu_torch.quantization import packing
from bitblas_tpu_torch.testing import assert_close

N, K = 256, 1024
U4 = dict(N=N, K=K, A_dtype="float16", W_dtype="uint4", with_scaling=True,
          group_size=128)
U4Z = dict(U4, with_zeros=True)
I8 = dict(N=N, K=K, A_dtype="int8", W_dtype="uint4", accum_dtype="int32",
          out_dtype="float32", with_scaling=True, group_size=128)
MS = (1, 16, 64, 600)     # decode instance, tiled, materialize (port)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(kw, m, seed, bias=False):
    ops = random_reference_operands(JaxSplitKConfig(M=MS, **kw, k_split=2),
                                    m, seed)
    w = packing.general_decompress(ops.qweight, 4, out_elems=K)
    extra = {}
    if ops.scales is not None:
        extra["scale"] = ops.scales
    if ops.zeros is not None:
        extra["zeros"] = ops.zeros
    if bias:
        extra["bias"] = np.random.default_rng(seed).standard_normal(
            N).astype(np.float32)
    return ops.A, w, extra


def _ops(kw, k_split, bias=False):
    cfg = dict(M=MS, **kw, k_split=k_split, with_bias=bias)
    return (MatmulWithSplitK(MatmulConfigWithSplitK(**cfg), device="cpu",
                             enable_tuning=False),
            JaxSplitK(JaxSplitKConfig(**cfg), enable_tuning=False))


def _run(op, A, packed, names):
    args = packed if isinstance(packed, list) else [packed]
    return op.forward(A, args[0], **dict(zip(names, args[1:])))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k_split", [2, 4])
@pytest.mark.parametrize("name,kw", [("u4", U4), ("u4z", U4Z)])
def test_uint4_matches_jax(name, kw, k_split, m):
    op, jop = _ops(kw, k_split)
    A, w, extra = _operands(kw, m, seed=m + k_split)
    got = _run(op, torch.from_numpy(A), op.transform_weight(w, **extra),
               list(extra))
    jpacked = jop.transform_weight(w, **extra)
    want = _run(jop, jnp.asarray(A), jpacked, list(extra))
    assert got.dtype == torch.float16 and tuple(got.shape) == (m, N)
    assert_close(got, np.asarray(want, np.float32), rtol=1e-2, atol=1.0)


@pytest.mark.parametrize("m", (1, 16, 64))
def test_int8_activations_match_jax(m):
    op, jop = _ops(I8, 2)
    A, w, extra = _operands(I8, m, seed=m)
    got = _run(op, torch.from_numpy(A), op.transform_weight(w, **extra),
               list(extra))
    want = _run(jop, jnp.asarray(A), jop.transform_weight(w, **extra),
                list(extra))
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), rtol=1e-2, atol=1.0)


def test_bias_on_shard_zero_matches_jax():
    op, _ = _ops(U4, 2, bias=True)
    jop = JaxMatmul(JaxMatmulConfig(M=MS, **U4, with_bias=True),
                    enable_tuning=False)
    A, w, extra = _operands(U4, 16, seed=5, bias=True)
    names = list(extra)
    got = _run(op, torch.from_numpy(A), op.transform_weight(w, **extra),
               names)
    want = _run(jop, jnp.asarray(A), jop.transform_weight(w, **extra), names)
    assert_close(got, np.asarray(want, np.float32), rtol=1e-2, atol=1.0)
    # the bias counted once, in shard 0's output
    W, S, B = op.transform_weight(w, **extra)
    kk = K // 2
    shard = Matmul(MatmulConfig(M=MS, **dict(U4, K=kk), with_bias=True),
                   device="cpu", enable_tuning=False)
    A = torch.from_numpy(A)
    parts = [shard.forward(A[:, s * kk:(s + 1) * kk].contiguous(), W[s],
                           scale=S[s * kk // 128:(s + 1) * kk // 128],
                           bias=B if s == 0 else None) for s in range(2)]
    assert torch.equal(got, (parts[0].float() + parts[1].float()).half())


def _f16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.frexp(x.double().abs().clamp_min(2.0 ** -14))[1] - 1
    return torch.exp2(e.double() - 10)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k_split", [2, 4])
def test_within_partial_roundings_of_matmul(k_split, m):
    op, _ = _ops(U4Z, k_split)
    full = Matmul(MatmulConfig(M=MS, **U4Z), device="cpu",
                  enable_tuning=False)
    A, w, extra = _operands(U4Z, m, seed=20 + m)
    A = torch.from_numpy(A)
    got = _run(op, A, op.transform_weight(w, **extra), list(extra))
    W, S, Z = full.transform_weight(w, **extra)
    want = full.forward(A, W, scale=S, zeros=Z)
    kk, gk = K // k_split, K // k_split // 128
    shard = Matmul(MatmulConfig(M=MS, **dict(U4Z, K=kk)), device="cpu",
                   enable_tuning=False)
    parts = [shard.forward(A[:, s * kk:(s + 1) * kk].contiguous(),
                           W[:, s * kk // 8:(s + 1) * kk // 8].contiguous(),
                           scale=S[s * gk:(s + 1) * gk],
                           zeros=Z[s * gk:(s + 1) * gk])
             for s in range(k_split)]
    total = sum(p.float() for p in parts).half()
    assert torch.equal(got, total)
    limit = sum(0.5 * _f16_ulp(p) for p in parts) + _f16_ulp(want) \
        + 2.0 ** -18 * want.double().abs().max()
    assert bool(((got.double() - want.double()).abs() <= limit).all())


def test_shard_major_layout():
    op, _ = _ops(U4Z, 4)
    full = Matmul(MatmulConfig(M=MS, **U4Z), device="cpu",
                  enable_tuning=False)
    _, w, extra = _operands(U4Z, 1, seed=1)
    W = op.transform_weight(w, **extra)[0]
    Wf = full.transform_weight(w, **extra)[0]
    assert tuple(W.shape) == op.retrieve_weight_shape() == (4, N, K // 32)
    for s in range(4):
        assert W[s].is_contiguous()
        assert torch.equal(W[s], Wf[:, s * K // 32:(s + 1) * K // 32])


@pytest.mark.parametrize("kw", [
    dict(U4, k_split=3),                               # does not divide K
    dict(U4, k_split=16),                              # 64 < group 128
    dict(U4, group_size=-1, k_split=2),                # per channel
    dict(U4, K=768, group_size=128, k_split=4)])      # 192 % 128
def test_config_errors_equal_jax(kw):
    with pytest.raises(ValueError) as got:
        MatmulConfigWithSplitK(M=16, **kw)
    with pytest.raises(ValueError) as want:
        JaxSplitKConfig(M=16, **kw)
    assert str(got.value) == str(want.value)


def test_native_configuration():
    # a native weight has no groups (its group is K): JAX's check refuses
    # any split, and k_split = 1 is Matmul's product
    dense = dict(N=N, K=K, A_dtype="float16", W_dtype="float16")
    with pytest.raises(ValueError) as got:
        MatmulConfigWithSplitK(M=16, **dense, k_split=2)
    with pytest.raises(ValueError) as want:
        JaxSplitKConfig(M=16, **dense, k_split=2)
    assert str(got.value) == str(want.value)
    op = MatmulWithSplitK(MatmulConfigWithSplitK(M=16, **dense, k_split=1),
                          device="cpu", enable_tuning=False)
    full = Matmul(MatmulConfig(M=16, **dense), device="cpu",
                  enable_tuning=False)
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((16, K)).astype(np.float16))
    w = rng.standard_normal((N, K)).astype(np.float16)
    assert torch.equal(op.forward(A, op.transform_weight(w)),
                       full.forward(A, full.transform_weight(w)))

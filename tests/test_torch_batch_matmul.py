"""BatchMatmul against the JAX package, on the CPU (both layouts): float16
within JAX's own tolerance (tests/test_matmul_operator.py:241, rtol 1e-2,
atol 5e-2) and, tighter, within one float16 ulp of each output (both
sides sum in float32 and round once); bfloat16 / float32 outputs the same
way; int8 operands bit for bit (exact integer sums on both sides, then
JAX's cast). Shapes: a few heads of Llama-2-7B's attention product
(M = N = 64, K = 128) and a ragged one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.ops.batch_matmul import BatchMatmul as JaxBatchMatmul
from bitblas_tpu.ops.batch_matmul import \
    BatchMatmulConfig as JaxBatchMatmulConfig

from bitblas_tpu_torch.ops.batch_matmul import (BatchMatmul,
                                                BatchMatmulConfig,
                                                batch_matmul_plain)
from bitblas_tpu_torch.testing import assert_close, out_ulps

SHAPES = [(4, 64, 64, 128), (3, 17, 40, 24)]


def _operands(dtype, B, M, N, K, layout, seed):
    rng = np.random.default_rng(seed)
    wshape = (B, N, K) if layout == "nt" else (B, K, N)
    if dtype == "int8":
        return (rng.integers(-128, 128, (B, M, K)).astype(np.int8),
                rng.integers(-128, 128, wshape).astype(np.int8))
    np_dtype = np.float32 if dtype == "float32" else np.float16
    return (rng.standard_normal((B, M, K)).astype(np_dtype),
            rng.standard_normal(wshape).astype(np_dtype))


def _pair(dtype, out, shape, layout):
    B, M, N, K = shape
    kw = dict(Batch=B, M=M, N=N, K=K, A_dtype=dtype, W_dtype=dtype,
              out_dtype=out, layout=layout,
              accum_dtype="int32" if dtype == "int8" else "float32")
    return (BatchMatmul(BatchMatmulConfig(**kw), device="cpu"),
            JaxBatchMatmul(JaxBatchMatmulConfig(**kw)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("layout", ["nt", "nn"])
def test_float16_matches_jax(shape, layout):
    op, jop = _pair("float16", "float16", shape, layout)
    a, w = _operands("float16", *shape, layout, seed=sum(shape))
    out = op(a, w)
    want = np.array(jop(jnp.asarray(a), jnp.asarray(w)))
    assert out.dtype == torch.float16 and tuple(out.shape) == want.shape
    assert_close(out, want.astype(np.float32), rtol=1e-2, atol=5e-2)
    assert out_ulps(out, torch.from_numpy(want)) <= 1.0


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nt", "nn"])
def test_other_outputs_match_jax(out, layout):
    shape = SHAPES[0]
    dtype = "float32" if out == "float32" else "float16"
    op, jop = _pair(dtype, out, shape, layout)
    a, w = _operands(dtype, *shape, layout, seed=3)
    got = op(torch.from_numpy(a), torch.from_numpy(w))
    want = torch.from_numpy(np.array(
        jop(jnp.asarray(a), jnp.asarray(w)).astype(jnp.float32)))
    assert got.dtype == getattr(torch, out)
    assert out_ulps(got.float(), want, getattr(torch, out)) <= 1.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("layout", ["nt", "nn"])
@pytest.mark.parametrize("out", ["int32", "float32"])
def test_int8_bit_equal(shape, layout, out):
    op, jop = _pair("int8", out, shape, layout)
    a, w = _operands("int8", *shape, layout, seed=7)
    got = op(a, w)
    want = np.array(jop(jnp.asarray(a), jnp.asarray(w)))
    assert str(got.dtype).split(".")[1] == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.einsum("bmk,bnk->bmn" if layout == "nt" else "bmk,bkn->bmn",
                      a.astype(np.int64), w.astype(np.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)


def test_plain_version_is_the_cpu_path():
    op, _ = _pair("float16", "float16", SHAPES[1], "nn")
    a, w = _operands("float16", *SHAPES[1], "nn", seed=1)
    a, w = torch.from_numpy(a), torch.from_numpy(w)
    assert torch.equal(op(a, w), batch_matmul_plain(a, w, "nn",
                                                    torch.float16))


def test_config_and_shape_errors():
    with pytest.raises(ValueError):
        BatchMatmulConfig(Batch=2, M=4, N=4, K=4, A_dtype="float16",
                          W_dtype="int8")
    with pytest.raises(ValueError):
        BatchMatmulConfig(Batch=2, M=4, N=None, K=4)
    with pytest.raises(ValueError):
        BatchMatmulConfig(Batch=2, M=4, N=4, K=4, layout="tn")
    op, _ = _pair("float16", "float16", SHAPES[0], "nt")
    a, w = _operands("float16", *SHAPES[0], "nn", seed=1)
    with pytest.raises(ValueError):
        op(a, w)            # an nn weight given to an nt operator

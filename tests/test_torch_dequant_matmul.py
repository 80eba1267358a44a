"""bitblas_tpu_torch Matmul (CPU, the kernel's plain version) against the
JAX package's Matmul (its Pallas kernel in interpret mode) and its oracle.

Tolerances. Against the JAX oracle (dequantize in f16, contract in f32,
exactly the port's arithmetic) outputs differ only by the order of the f32
sums: 1 f16 ulp of the output, atol 0.25 (outputs reach ~400, ulp 0.25).
Against the JAX Pallas kernel, which applies scales and zeros to the f32
accumulator (s * (a @ q - z * sum(a))) instead of rounding (q - z) * s to
f16 first, each weight also carries a 2^-11 relative rounding; over K=512
random-sign terms that is ~0.05 abs standard deviation, so atol 1.0 with
rtol 1e-2 bounds it with margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu import testing as jtesting
from bitblas_tpu.ops import reference as jref
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.quantization.packing import general_decompress

from bitblas_tpu_torch.kernels.dequant_matmul import (dequant_matmul_u4,
                                                      dequant_matmul_u4_plain)
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.testing import assert_close

CFG = dict(N=256, K=512, A_dtype="float16", W_dtype="uint4",
           with_scaling=True, with_zeros=True, zeros_mode="original",
           group_size=128, out_dtype="float16")


@pytest.fixture(scope="module")
def ops():
    jc = JaxMatmulConfig(M=[1, 16, 64], **CFG)
    pc = MatmulConfig(M=[1, 16, 64], **CFG)
    ref = jtesting.random_reference_operands(jc, 1, seed=11)
    codes = general_decompress(ref.qweight, 4, out_elems=jc.K)
    jm = JaxMatmul(jc, enable_tuning=False)
    jw = jm.transform_weight(codes, scale=ref.scales, zeros=ref.zeros)
    pm = Matmul(pc, device="cpu")
    pw = pm.transform_weight(codes, scale=ref.scales, zeros=ref.zeros)
    return jc, jm, jw, pm, pw, ref


@pytest.mark.parametrize("m", [1, 5, 64])
def test_matmul_forward_matches_jax(ops, m):
    jc, jm, (W, S, Z), pm, (pW, pS, pZ), ref = ops
    A = np.random.default_rng(m).standard_normal((m, jc.K)).astype(np.float16)
    got = pm.forward(torch.from_numpy(A), pW, scale=pS, zeros=pZ)
    assert got.dtype == torch.float16 and tuple(got.shape) == (m, jc.N)
    oracle = np.asarray(jref.matmul_reference(
        jc, jnp.asarray(A), jnp.asarray(ref.qweight),
        jnp.asarray(ref.scales), jnp.asarray(ref.zeros)))
    assert_close(got, oracle, rtol=0.0, atol=0.25, max_mismatched_ratio=0.0)
    kernel = np.asarray(jm.forward(jnp.asarray(A), W, scale=S, zeros=Z))
    assert_close(got, kernel, rtol=1e-2, atol=1.0, max_mismatched_ratio=0.0)


def test_matmul_leading_dims_and_counter(ops):
    jc, _, _, pm, (pW, pS, pZ), _ = ops
    A = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, jc.K)).astype(np.float16))
    before = dequant_matmul_u4.launches
    out = pm(A, pW, scale=pS, zeros=pZ)
    assert tuple(out.shape) == (2, 3, jc.N)
    assert pm.retrieve_weight_shape() == tuple(pW.shape) == (jc.N, jc.K // 8)
    # CPU tensors take the plain version: no kernel launch is counted
    assert dequant_matmul_u4.launches == before
    flat = dequant_matmul_u4_plain(A.reshape(6, jc.K), pW, pS, pZ)
    assert torch.equal(out.reshape(6, jc.N), flat)


def test_wrapper_rejects_what_the_kernel_does_not_take(ops):
    jc, _, _, _, (pW, pS, pZ), _ = ops
    A = torch.zeros((4, jc.K), dtype=torch.float16)
    with pytest.raises(ValueError):
        dequant_matmul_u4(A.float(), pW, pS, pZ)            # dtype
    with pytest.raises(ValueError):
        dequant_matmul_u4(A[:, :256], pW, pS, pZ)           # shape
    with pytest.raises(ValueError):
        dequant_matmul_u4(torch.zeros((jc.K, 4), dtype=torch.float16).T,
                          pW, pS, pZ)                       # contiguity
    with pytest.raises(NotImplementedError):
        dequant_matmul_u4(A, pW, pS, pZ, group=16)

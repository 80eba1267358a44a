"""The float-activation columns of the support matrix through the port's
Matmul on the CPU (the kernels' plain versions), each pair against the
JAX package's oracle (bitblas_tpu/ops/reference.py matmul_reference) on
the same operands (bitblas_tpu.testing.random_reference_operands), as
tests/test_support_matrix.py holds the JAX Matmul: M = 16, N = K = 256,
scaled where the reference's schemes scale (uint, nf4, fp4), output
float32.

Tolerances are tests/test_support_matrix.py's: rtol 5e-2, atol 4.0 and
1% of the elements for fp8 weights and bfloat16 activations, else 2e-2,
0.35 and 0.1%. The port decodes the oracle's weight bit for bit, so
every pair in fact agrees to the order of the float32 sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops.reference import matmul_reference
from bitblas_tpu.testing import random_reference_operands

from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.ops import weight_transform as wt
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import FLOAT_PAIRS, MatmulConfig
from bitblas_tpu_torch.testing import assert_close

N = K = 256
M = 16
TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _tolerance(a_dtype, w_dtype):
    wide = "float8" in w_dtype or a_dtype == "bfloat16"
    rtol, atol, budget = (5e-2, 4.0, 0.01) if wide else (2e-2, 0.35, 0.001)
    return dict(rtol=rtol, atol=atol, max_mismatched_ratio=budget)


def _scaled(w_dtype):
    return w_dtype.startswith("uint") or w_dtype in ("nf4", "fp4_e2m1")


def _act(config, A):
    return torch.from_numpy(np.asarray(A).astype(np.float32)).to(
        TORCH[config.A_dtype])


@pytest.mark.parametrize("a_dtype,w_dtype", FLOAT_PAIRS)
def test_support_matrix_pair(a_dtype, w_dtype):
    scaled = _scaled(w_dtype)
    kw = dict(M=M, N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
              with_scaling=scaled, group_size=64 if scaled else -1,
              out_dtype="float32")
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = random_reference_operands(jc, M, seed=0)
    expected = np.asarray(matmul_reference(
        jc, jnp.asarray(ops.A), jnp.asarray(ops.qweight),
        None if ops.scales is None else jnp.asarray(ops.scales)))
    op = Matmul(pc, device="cpu", enable_tuning=False)
    assert op.hint_for(M).decode_mode == "fused"
    dw = wt.transform_reference_operands(pc, ops.qweight, ops.scales)
    got = op.forward(_act(pc, ops.A), dw.qweight, scale=dw.scales)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert_close(got, expected, msg=f"{w_dtype}x{a_dtype}",
                 **_tolerance(a_dtype, w_dtype))


@pytest.mark.parametrize("a_dtype,w_dtype", [
    p for p in FLOAT_PAIRS if p[1].startswith("uint")])
@pytest.mark.parametrize("zeros_mode", ["original", "rescale", "quantized"])
def test_uint_zeros_and_bias(a_dtype, w_dtype, zeros_mode):
    """uint pairs with zeros in each mode, a bias and A's output type,
    at M = 16 (the decode instance) and M = 512 (the materialize plan)."""
    kw = dict(M=[16, 512], N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
              with_scaling=True, with_zeros=True, zeros_mode=zeros_mode,
              group_size=32, with_bias=True, out_dtype=a_dtype)
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    op = Matmul(pc, device="cpu", enable_tuning=False)
    for m, plan in ((16, "fused"), (512, "materialize")):
        ops = random_reference_operands(jc, m, seed=m)
        assert ops.bias is not None and (ops.zeros is not None
                                         or ops.qzeros is not None)
        expected = np.asarray(matmul_reference(
            jc, jnp.asarray(ops.A), jnp.asarray(ops.qweight),
            jnp.asarray(ops.scales),
            None if ops.zeros is None else jnp.asarray(ops.zeros),
            None if ops.qzeros is None else jnp.asarray(ops.qzeros),
            jnp.asarray(ops.bias)).astype(jnp.float32))
        dw = wt.transform_reference_operands(
            pc, ops.qweight, ops.scales, ops.zeros, ops.qzeros, ops.bias)
        assert op.hint_for(m).decode_mode == plan
        got = op.forward(_act(pc, ops.A), dw.qweight, scale=dw.scales,
                         zeros=dw.zeros, bias=dw.bias)
        assert got.dtype == TORCH[a_dtype]
        top = float(np.abs(expected).max())
        # one rounding of the output type apart
        ulp = 2 ** -10 if a_dtype == "float16" else 2 ** -7
        assert_close(got, expected, rtol=ulp, atol=ulp * top,
                     max_mismatched_ratio=0.0,
                     msg=f"{w_dtype}x{a_dtype} {zeros_mode} M={m}")


def test_every_pair_has_its_instances():
    """Each pair has a decode instance (steps of 512 / bits) and the one
    tiled instance, all within the card's shared memory."""
    for a_dtype, w_dtype in FLOAT_PAIRS:
        fmt = dq.fused_format(w_dtype, a_dtype)
        bits = MatmulConfig(N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
                            out_dtype=a_dtype).bit
        assert dq.FUSED_TILES[fmt] == (dq.fmt_decode_tile(bits),
                                       dq.FMT_TILED_TILE)
        assert dq.default_tile(fmt, 16) == dq.fmt_decode_tile(bits)
        assert dq.default_tile(fmt, 17) == dq.FMT_TILED_TILE
        for tile in dq.FUSED_TILES[fmt]:
            assert dq.fused_smem_bytes(fmt, tile) <= 232448


@pytest.mark.parametrize("m", [4, 256, 512])
@pytest.mark.parametrize("a_dtype,w_dtype", [
    ("float16", "uint1"), ("bfloat16", "e4m3_float8"), ("float16", "nf4")])
def test_tuner_space_of_a_pair(a_dtype, w_dtype, m):
    """The tuner's space for a pair lists its compiled instances only: the
    default first (the decode instance to M = 16, the tiled one above, the
    materialize plan from 512), every hint within shared memory, the plan
    from the 256 bucket; the roofline counts bits / 8 bytes a weight."""
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    from bitblas_tpu_torch.tuner import (H100_SXM, default_hint,
                                         enumerate_hints, smem_bytes)
    from bitblas_tpu_torch.tuner.space import roofline_seconds
    cfg = MatmulConfig(N=11008, K=4096, A_dtype=a_dtype, W_dtype=w_dtype,
                       with_scaling=True, group_size=128, out_dtype=a_dtype)
    spec = KernelSpec.from_config(cfg, m)
    fmt = dq.fused_format(w_dtype, a_dtype)
    hints = enumerate_hints(spec, H100_SXM)
    assert hints[0] == default_hint(spec, H100_SXM)
    assert hints[0].decode_mode == ("materialize" if m >= 512 else "fused")
    fused = [h.tile for h in hints if h.decode_mode == "fused"]
    assert set(fused) == set(dq.FUSED_TILES[fmt])
    assert all(smem_bytes(spec, h) <= H100_SXM.smem_per_block for h in hints)
    assert (any(h.decode_mode == "materialize" for h in hints)) == (m >= 256)
    seconds = roofline_seconds(spec, hints[0], H100_SXM)
    weight = 11008 * 4096 * cfg.bit / 8 + 2 * 11008 * 4096 / 128
    assert seconds >= weight / H100_SXM.hbm_bandwidth

"""The float- and integer-activation columns of the support matrix through
the port's
Matmul on the CPU (the kernels' plain versions), each pair against the
JAX package's oracle (bitblas_tpu/ops/reference.py matmul_reference) on
the same operands (bitblas_tpu.testing.random_reference_operands), as
tests/test_support_matrix.py holds the JAX Matmul: M = 16, N = K = 256,
scaled where the reference's schemes scale (uint, nf4, fp4), output
float32.

Tolerances are tests/test_support_matrix.py's: rtol 5e-2, atol 4.0 and
1% of the elements for fp8 weights and bfloat16 activations, else 2e-2,
0.35 and 0.1%. The port decodes the oracle's weight bit for bit, so
every pair in fact agrees to the order of the float32 sums. The integer
rows (JAX's PAIRS with int8 or int4 activations) and the output matrix
(JAX's OUT_MATRIX: int32 and unscaled int8 outputs bit-equal, scaled
int8 within 1, the others at rtol 2e-2, atol 0.5, 0.5% of the elements)
hold the port's Matmul to JAX's Matmul on the same operands, as JAX's
tests hold it to the oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops.reference import matmul_reference
from bitblas_tpu.ops.weight_transform import \
    transform_reference_operands as jax_transform
from bitblas_tpu.testing import random_reference_operands

from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.ops import weight_transform as wt
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import (FLOAT_PAIRS, INT_PAIRS,
                                                 MatmulConfig)
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


# tests/test_support_matrix.py PAIRS with integer activations: (A_dtype,
# W_dtype, with_scaling), and its OUT_MATRIX: (..., out_dtype)
INT_ROWS = [
    ("int4", "int4", False),
    ("int8", "uint4", True),
    ("int8", "uint2", True),
    ("int8", "int8", False),
    ("int8", "uint4", False),
    ("int8", "int4", False),
    ("int8", "uint2", False),
    ("int8", "int2", False),
    ("int8", "uint1", False),
    ("int8", "int1", False),
]
OUT_MATRIX = [
    ("int8", "int2", False, "float32"),
    ("int8", "int2", False, "float16"),
    ("int8", "int2", False, "int32"),
    ("int8", "int2", False, "int8"),
    ("int8", "uint4", False, "int32"),
    ("int8", "uint4", False, "int8"),
    ("int8", "uint4", False, "float16"),
    ("int8", "uint4", True, "float16"),
    ("int8", "uint4", True, "int8"),
    ("int8", "uint2", True, "float32"),
    ("float16", "uint4", True, "float16"),
    ("float16", "uint4", True, "float32"),
]


def _jax_and_port(kw, m, seed):
    """JAX's Matmul forward and the port's (CPU) on JAX's operands; the
    port's hint at m."""
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = random_reference_operands(jc, m, seed=seed)
    jop = JaxMatmul(jc, enable_tuning=False)
    op = Matmul(pc, device="cpu", enable_tuning=False)
    A = np.asarray(ops.A)
    if pc.is_native_compute():
        want = jop.forward(jnp.asarray(A), jnp.asarray(ops.qweight))
        got = op.forward(torch.from_numpy(A), op.transform_weight(
            np.asarray(ops.qweight)))
    else:
        jw = jax_transform(jc, ops.qweight, ops.scales)
        want = jop.forward(jnp.asarray(A), jnp.asarray(jw.qweight),
                           scale=None if jw.scales is None
                           else jnp.asarray(jw.scales))
        dw = wt.transform_reference_operands(pc, ops.qweight, ops.scales)
        At = torch.from_numpy(A) if A.dtype == np.int8 else _act(pc, A)
        got = op.forward(At, dw.qweight, scale=dw.scales)
    return np.asarray(want), got, op


@pytest.mark.parametrize("a_dtype,w_dtype,scaling", INT_ROWS)
def test_integer_rows_match_jax(a_dtype, w_dtype, scaling):
    """JAX's integer rows (M = 16, N = K = 256, g = 64 where scaled,
    float32 out) through the port's Matmul and JAX's: unscaled they sum
    integers on both sides, bit for bit; scaled within JAX's tolerance."""
    kw = dict(M=M, N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
              with_scaling=scaling, group_size=64 if scaling else -1,
              accum_dtype="int32", out_dtype="float32")
    want, got, op = _jax_and_port(kw, M, 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    if op.config.is_native_compute():
        assert op.hint_for(M).decode_mode == "dense"
    else:
        assert dq.spec_format(op._spec) == f"{w_dtype}x{a_dtype}" or \
            (w_dtype, scaling) == ("int2", False)
    if scaling:
        assert_close(got, want, rtol=2e-2, atol=0.35,
                     max_mismatched_ratio=0.001, msg=f"{w_dtype}x{a_dtype}")
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a_dtype,w_dtype,scaling,out_dtype", OUT_MATRIX)
def test_out_dtype_matrix(a_dtype, w_dtype, scaling, out_dtype):
    """JAX's OUT_MATRIX (its float16 x uint4 rows included) through
    the port's Matmul and JAX's, with JAX's tolerances."""
    int_act = a_dtype == "int8"
    kw = dict(M=M, N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
              with_scaling=scaling, group_size=64 if scaling else -1,
              accum_dtype="int32" if int_act and not scaling else "float32",
              out_dtype=out_dtype)
    want, got, _ = _jax_and_port(kw, M, 1)
    assert str(got.dtype) == f"torch.{out_dtype}"
    if out_dtype in ("int32", "int8") and not scaling:
        np.testing.assert_array_equal(got.numpy(), want)
    elif out_dtype == "int8":
        assert np.abs(got.numpy().astype(np.int32)
                      - want.astype(np.int32)).max() <= 1
    else:
        assert_close(got, want.astype(np.float32), rtol=2e-2, atol=0.5,
                     max_mismatched_ratio=0.005,
                     msg=f"{w_dtype}x{a_dtype}->{out_dtype}")


@pytest.mark.parametrize("opts", [
    dict(with_scaling=False, out_dtype="float16"),
    dict(with_scaling=True, group_size=64, out_dtype="float32"),
    dict(with_scaling=True, group_size=128, out_dtype="float16"),
    dict(with_scaling=True, with_zeros=True, group_size=32,
         out_dtype="float32", with_bias=True)])
def test_uint4_float16_options_beyond_gptq(opts):
    """uint4 x float16 takes every option the other float pairs take:
    unscaled, scales without zeros and float32 out run on
    dequant_matmul_fmt ("uint4xfloat16"); GPTQ's configuration (scales,
    zeros, float16 out) keeps dequant_matmul_u4 ("uint4"). Each against
    JAX's oracle on the same operands."""
    kw = dict(M=M, N=N, K=K, A_dtype="float16", W_dtype="uint4", **opts)
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    op = Matmul(pc, device="cpu", enable_tuning=False)
    gptq = pc.with_scaling and pc.with_zeros and pc.out_dtype == "float16"
    assert dq.spec_format(op._spec) == ("uint4" if gptq else "uint4xfloat16")
    ops = random_reference_operands(jc, M, seed=2)
    j = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(matmul_reference(
        jc, jnp.asarray(ops.A), jnp.asarray(ops.qweight), j(ops.scales),
        j(ops.zeros), None, j(ops.bias))).astype(np.float32)
    dw = wt.transform_reference_operands(pc, ops.qweight, ops.scales,
                                         ops.zeros, None, ops.bias)
    got = op.forward(_act(pc, ops.A), dw.qweight, scale=dw.scales,
                     zeros=dw.zeros, bias=dw.bias)
    assert str(got.dtype) == f"torch.{pc.out_dtype}"
    assert_close(got, want, rtol=2e-2, atol=0.35, max_mismatched_ratio=0.001)


def _spec_of(config):
    """The KernelSpec of a configuration at M = 16."""
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    return KernelSpec.from_config(config, 16)


def test_gptq_and_bitnet_keep_their_keys():
    """The two configurations with kernels of their own keep their keys (the
    tuned hints of the database keep their meaning); their other options
    and every other integer pair get "<W>x<A>" keys."""
    gptq = MatmulConfig(N=N, K=K, A_dtype="float16", W_dtype="uint4",
                        with_scaling=True, with_zeros=True, group_size=128,
                        out_dtype="float16", with_bias=True)
    bitnet = MatmulConfig(N=N, K=K, A_dtype="int8", W_dtype="int2",
                          accum_dtype="int32", out_dtype="float32")
    assert dq.spec_format(_spec_of(gptq)) == "uint4"
    assert dq.spec_format(_spec_of(bitnet)) == "int2"
    assert dq.fused_format("uint4", "float16") == "uint4"
    assert dq.fused_format("int2", "int8") == "int2"
    assert dq.fused_format("int2", "int8", "int8") == "int2xint8"
    assert dq.fused_format("int2", "int8", bias=True) == "int2xint8"
    assert dq.fused_format("uint4", "float16", "float32") == "uint4xfloat16"
    for a, w in INT_PAIRS:
        cfg = MatmulConfig(N=N, K=K, A_dtype=a, W_dtype=w,
                           with_scaling=True, group_size=128,
                           out_dtype="int8")
        fmt = dq.spec_format(_spec_of(cfg))
        assert fmt == f"{w}x{a}" and fmt in dq.INT_FORMATS
        assert dq.FUSED_TILES[fmt] == (dq.fmt_decode_tile(cfg.bit),
                                       dq.INT_TILED_TILE)
        for tile in dq.FUSED_TILES[fmt]:
            assert dq.fused_smem_bytes(fmt, tile) <= 232448


@pytest.mark.parametrize("m", [4, 256, 512])
@pytest.mark.parametrize("group", [-1, 128])
def test_tuner_space_of_an_int_pair(m, group):
    """The tuner's space for int8 x uint4: the decode instance to M = 16,
    the tiled one above; the materialize plan (the default from 512,
    offered from 256) only per channel."""
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    from bitblas_tpu_torch.tuner import (H100_SXM, default_hint,
                                         enumerate_hints, smem_bytes)
    from bitblas_tpu_torch.tuner.space import roofline_seconds
    cfg = MatmulConfig(N=11008, K=4096, A_dtype="int8", W_dtype="uint4",
                       with_scaling=True, group_size=group, out_dtype="int8")
    spec = KernelSpec.from_config(cfg, m)
    hints = enumerate_hints(spec, H100_SXM)
    assert hints[0] == default_hint(spec, H100_SXM)
    per_channel = group == -1
    assert hints[0].decode_mode == ("materialize" if m >= 512
                                    and per_channel else "fused")
    fused = [h.tile for h in hints if h.decode_mode == "fused"]
    assert set(fused) == set(dq.FUSED_TILES["uint4xint8"])
    if hints[0].decode_mode == "fused":
        assert hints[0].tile == dq.default_tile("uint4xint8", m)
    assert all(smem_bytes(spec, h) <= H100_SXM.smem_per_block for h in hints)
    assert any(h.decode_mode == "materialize" for h in hints) == \
        (m >= 256 and per_channel)
    seconds = roofline_seconds(spec, hints[0], H100_SXM)
    assert seconds >= 11008 * 4096 / 2 / H100_SXM.hbm_bandwidth
    assert seconds >= 2.0 * m * 11008 * 4096 / H100_SXM.flops_int8

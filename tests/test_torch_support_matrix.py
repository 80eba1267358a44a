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

from torch_jax_parity import (agrees, as_f64, jax_refusal, operands, oracle,
                              port_forward, to_torch)

N = K = 256
M = 16
TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# -- every configuration JAX's Matmul runs -----------------------------------
#
# JAX's own support-matrix cases, copied (tests/test_support_matrix.py):
# PAIRS :22-72, WIDE_PAIRS :114-119 (OUT_MATRIX :152-165 is above); M = 16,
# N = K = 256, g = 64 where scaled, float32 out; its tolerances (:76-108
# PAIRS, :136-149 WIDE_PAIRS).
JAX_PAIRS = [
    ("float16", "float16", False), ("bfloat16", "bfloat16", False),
    ("float32", "float32", False), ("int8", "int8", False),
    ("e4m3_float8", "e4m3_float8", False),
    ("e5m2_float8", "e5m2_float8", False),
    ("float16", "uint4", True), ("float16", "uint2", True),
    ("float16", "uint1", True), ("float16", "int4", False),
    ("float16", "int2", False), ("float16", "int1", False),
    ("float16", "int8", False), ("float16", "nf4", True),
    ("float16", "fp4_e2m1", True), ("float16", "e4m3_float8", False),
    ("float16", "e5m2_float8", False),
    ("bfloat16", "uint4", True), ("bfloat16", "int4", False),
    ("bfloat16", "nf4", True), ("bfloat16", "fp4_e2m1", True),
    ("bfloat16", "e4m3_float8", False), ("bfloat16", "int8", False),
    ("bfloat16", "uint2", True), ("bfloat16", "int2", False),
    ("bfloat16", "uint1", True),
    ("e4m3_float8", "e5m2_float8", False),
    ("e5m2_float8", "e4m3_float8", False),
    ("int4", "int4", False),
    ("int8", "uint4", True), ("int8", "uint2", True),
    ("int8", "int8", False), ("int8", "uint4", False),
    ("int8", "int4", False), ("int8", "uint2", False),
    ("int8", "int2", False), ("int8", "uint1", False),
    ("int8", "int1", False),
]
JAX_WIDE_PAIRS = [
    ("float16", "int16", False), ("float16", "int16", True),
    ("float16", "uint16", False), ("float16", "uint16", True),
    ("float16", "int32", False), ("float16", "int32", True),
    ("float16", "uint32", False), ("float16", "uint32", True),
]
def _jax_case(a_dtype, w_dtype, scaling, **extra):
    kw = dict(M=M, N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
              with_scaling=scaling, group_size=64 if scaling else -1,
              out_dtype="float32", **extra)
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = random_reference_operands(jc, M, seed=0)
    want = matmul_reference(jc, jnp.asarray(ops.A), jnp.asarray(ops.qweight),
                            None if ops.scales is None
                            else jnp.asarray(ops.scales))
    got = port_forward(pc, ops.A, ops.qweight, ops.scales)
    assert tuple(got.shape) == (M, N) and got.dtype == torch.float32
    return np.asarray(want), got


@pytest.mark.parametrize("a_dtype,w_dtype,scaling", JAX_PAIRS)
def test_jax_support_matrix_pair(a_dtype, w_dtype, scaling):
    """Every case of JAX's PAIRS through the port's Matmul against JAX's
    oracle, at JAX's tolerances (its fp8 and bfloat16 rows wider)."""
    int_act = a_dtype in ("int8", "int4")
    want, got = _jax_case(a_dtype, w_dtype, scaling, accum_dtype=(
        "int32" if int_act and "float8" not in w_dtype else "float32"))
    wide = ("float8" in a_dtype + w_dtype) or a_dtype == "bfloat16"
    rtol, atol, budget = (5e-2, 4.0, 0.01) if wide else (2e-2, 0.35, 0.001)
    assert_close(got, want, rtol=rtol, atol=atol,
                 max_mismatched_ratio=budget, msg=f"{w_dtype}x{a_dtype}")


@pytest.mark.parametrize("a_dtype,w_dtype,scaling", JAX_WIDE_PAIRS)
def test_jax_wide_int_formats(a_dtype, w_dtype, scaling):
    """JAX's WIDE_PAIRS: int16 / int32 storage as JAX legalizes it, the
    output within JAX's limit (2% of the largest output)."""
    pc = MatmulConfig(N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
                      with_scaling=scaling, group_size=64 if scaling else -1)
    assert pc.storage_dtype == ("int16" if "16" in w_dtype else "int32")
    want, got = _jax_case(a_dtype, w_dtype, scaling)
    top = float(np.max(np.abs(want))) or 1.0
    assert_close(got, want, rtol=5e-2, atol=0.02 * top,
                 max_mismatched_ratio=0.01, msg=f"{w_dtype}x{a_dtype}")


# Activations by dense type, and the weight formats JAX decodes.
ACTS = ("float16", "bfloat16", "float32", "float64", "int8", "uint8",
        "int4", "uint4", "int16", "uint16", "int32", "uint32",
        "e4m3_float8", "e5m2_float8")
WEIGHTS = ("uint1", "uint2", "uint4", "uint8", "uint16", "uint32", "int1",
           "int2", "int4", "int8", "int16", "int32", "nf4", "fp4_e2m1",
           "e4m3_float8", "e5m2_float8")
# (with_scaling, with_zeros, zeros_mode): zeros without scales count only
# in mode quantized, as in JAX's oracle
OPTIONS = ((False, False, "original"), (True, False, "original"),
           (True, True, "original"), (True, True, "rescale"),
           (True, True, "quantized"), (False, True, "original"),
           (False, True, "quantized"))
SM, SN, SK, SG = 3, 40, 96, 32   # K a tail of every word and 128


@pytest.mark.parametrize("a_dtype", ACTS)
def test_every_pair_matches_the_oracle(a_dtype):
    """Every weight format under `a_dtype` with every scale / zeros option
    JAX takes (int weights: no zeros, as JAX refuses them), K = 96 off
    every word and 128, through the port's Matmul against JAX's oracle.
    Each runs on the general instance's plain version or a specialized
    kernel's, or the dense route for a native pair."""
    ran = 0
    for w_dtype in WEIGHTS:
        for scaled, zeros, mode in OPTIONS:
            if zeros and w_dtype.startswith("int"):
                continue
            if zeros and mode == "quantized" and w_dtype in (
                    "uint16", "uint32"):
                continue   # JAX packs quantized zeros in bytes
            kw = dict(M=SM, N=SN, K=SK, A_dtype=a_dtype, W_dtype=w_dtype,
                      with_scaling=scaled, with_zeros=zeros,
                      zeros_mode=mode, out_dtype="float32",
                      group_size=SG if scaled or zeros else -1)
            ops = operands(kw)
            got = port_forward(MatmulConfig(**kw), ops["A"], ops["qweight"],
                               ops["scales"], ops["zeros"], ops["qzeros"])
            assert agrees(as_f64(got), oracle(kw, ops)), \
                (w_dtype, scaled, zeros, mode)
            ran += 1
    assert ran == 16 * 7 - 6 * 5 - 2 * 2


OUTS = ("float16", "bfloat16", "float32", "float64", "int8", "uint8",
        "int16", "int32", "uint4", "e4m3_float8")


@pytest.mark.parametrize("a_dtype,w_dtype,scaled", [
    ("float16", "uint4", True), ("int8", "uint4", False),
    ("int8", "nf4", True), ("float32", "e5m2_float8", False),
    ("uint8", "uint8", False), ("bfloat16", "bfloat16", False),
    ("e4m3_float8", "e4m3_float8", False)])
def test_every_output_type_matches_the_oracle(a_dtype, w_dtype, scaled):
    """Every dense output type, with a bias, through the port against JAX's
    oracle: the saturating cast of narrow integers (rounded half to even),
    e4m3's NaN past 464."""
    for out in OUTS:
        kw = dict(M=SM, N=SN, K=SK, A_dtype=a_dtype, W_dtype=w_dtype,
                  with_scaling=scaled, group_size=SG if scaled else -1,
                  out_dtype=out, with_bias=True)
        ops = operands(kw, seed=3)
        got = port_forward(MatmulConfig(**kw), ops["A"], ops["qweight"],
                           ops["scales"], bias=ops["bias"])
        want = oracle(kw, ops)
        assert str(got.dtype) == "torch." + {
            "uint4": "int8", "e4m3_float8": "float8_e4m3fn"}.get(out, out)
        if out.startswith(("int", "uint")):
            assert np.array_equal(as_f64(got), want), out
        else:
            assert agrees(as_f64(got), want, rtol=1e-2), out


# One configuration of each class the port added, against JAX's oracle and
# JAX's Matmul (its Pallas kernel in interpret mode; the XLA dot for the
# native pairs) on the same operands.
CLASSES = {
    "native_f16_out_f32": dict(A_dtype="float16", W_dtype="float16"),
    "native_bf16_out_f32": dict(A_dtype="bfloat16", W_dtype="bfloat16"),
    "native_e4m3": dict(A_dtype="e4m3_float8", W_dtype="e4m3_float8"),
    "native_e5m2_e4m3": dict(A_dtype="e5m2_float8", W_dtype="e4m3_float8"),
    "native_uint8": dict(A_dtype="uint8", W_dtype="uint8",
                         out_dtype="int32"),
    "native_float64": dict(A_dtype="float64", W_dtype="float64"),
    "wide_uint16_scaled": dict(A_dtype="float16", W_dtype="uint16",
                               with_scaling=True, group_size=32),
    "int8_x_uint8": dict(A_dtype="int8", W_dtype="uint8",
                         out_dtype="int32"),
    "int8_x_nf4": dict(A_dtype="int8", W_dtype="nf4", out_dtype="int32"),
    "int8_x_fp4": dict(A_dtype="int8", W_dtype="fp4_e2m1",
                       out_dtype="int32"),
    "int8_x_e4m3": dict(A_dtype="int8", W_dtype="e4m3_float8"),
    "int8_x_int8_scaled": dict(A_dtype="int8", W_dtype="int8",
                               with_scaling=True, group_size=32),
    "float32_x_uint4": dict(A_dtype="float32", W_dtype="uint4",
                            with_scaling=True, group_size=32),
    "nf4_zeros": dict(A_dtype="float16", W_dtype="nf4", with_scaling=True,
                      with_zeros=True, group_size=32),
    "fp4_zeros_rescale": dict(A_dtype="bfloat16", W_dtype="fp4_e2m1",
                              with_scaling=True, with_zeros=True,
                              zeros_mode="rescale", group_size=32),
    "e4m3_zeros": dict(A_dtype="float16", W_dtype="e4m3_float8",
                       with_scaling=True, with_zeros=True, group_size=32),
    "k_tail_uint4": dict(A_dtype="float16", W_dtype="uint4",
                         with_scaling=True, group_size=-1),
}
# JAX's Matmul decodes into its mma type (bfloat16 for float16 and
# float32 activations) where its oracle decodes into A's: those classes
# are held to JAX's Matmul at JAX's wide limit (5e-2, 4.0, 1%).
INTERPRET_WIDE = ("wide_uint16_scaled", "float32_x_uint4", "nf4_zeros",
                  "fp4_zeros_rescale", "e4m3_zeros", "k_tail_uint4",
                  "native_e4m3", "native_e5m2_e4m3")
# JAX's Matmul departs from its own oracle here (ROADMAP §3, faults in the
# reference): its kernel decodes nf4 to the table's values in its mma type
# where the oracle decodes them into int8 (-1, 0, 1). The port follows the
# oracle; the test shows the departure is JAX's.
JAX_DEPARTS = ("int8_x_nf4",)


@pytest.mark.parametrize("name", list(CLASSES))
def test_each_class_matches_jax(name):
    kw = dict(M=16, N=128, K=288 if name == "k_tail_uint4" else 256,
              out_dtype="float32")
    kw.update(CLASSES[name])
    ops = operands(kw, seed=5)
    pc = MatmulConfig(**kw)
    got = as_f64(port_forward(pc, ops["A"], ops["qweight"], ops["scales"],
                              ops["zeros"], ops["qzeros"]))
    assert agrees(got, oracle(kw, ops))
    jc = JaxMatmulConfig(**kw)
    jop = JaxMatmul(jc, enable_tuning=False)
    j = (lambda x: None if x is None else jnp.asarray(x))
    if jc.is_native_compute():
        want = jop.forward(j(ops["A"]), j(ops["qweight"]))
    else:
        jw = jax_transform(jc, ops["qweight"], ops["scales"], ops["zeros"],
                           ops["qzeros"])
        want = jop.forward(j(ops["A"]), j(jw.qweight), scale=j(jw.scales),
                           zeros=j(jw.zeros))
    want = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    if name in JAX_DEPARTS:
        assert not agrees(want, oracle(kw, ops), rtol=5e-2)
    elif name in INTERPRET_WIDE:
        assert_close(torch.from_numpy(got).float(), want.astype(np.float32),
                     rtol=5e-2, atol=4.0, max_mismatched_ratio=0.01)
    else:
        assert agrees(got, want)


# Configurations JAX refuses: the port raises the same class (JAX at its
# config, its Matmul's build or its first call; the port at its config).
REFUSALS = [
    dict(A_dtype="nf4", W_dtype="uint4"),
    dict(A_dtype="int2", W_dtype="int2"),
    dict(A_dtype="float16", W_dtype="uint4", out_dtype="fp4_e2m1"),
    dict(A_dtype="float16", W_dtype="uint4", layout="nn"),
    dict(A_dtype="int8", W_dtype="int4", with_zeros=True,
         with_scaling=True, group_size=64),
    dict(A_dtype="int8", W_dtype="int8", with_zeros=True),
    dict(A_dtype="float16", W_dtype="float32"),
    dict(A_dtype="float32", W_dtype="bfloat16"),
    dict(A_dtype="float16", W_dtype="float64"),
    dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
         group_size=48),
    dict(A_dtype="float16", W_dtype="nf5"),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_refusals_match_jax(kw):
    kw = dict(M=4, N=128, K=256, **kw)
    cls = jax_refusal(kw)
    assert cls is not None
    with pytest.raises(cls):
        MatmulConfig(**kw)


# Linear and QuantLinear take the same configurations (module.Linear's
# buffers: int16 / int32 words for wide weights, int32 quantized zeros on
# the general instance, a native weight in W's type).
LINEAR_CASES = {
    "float32_x_uint4_zeros": dict(A_dtype="float32", W_dtype="uint4",
                                  with_scaling=True, with_zeros=True,
                                  zeros_mode="original", group_size=32,
                                  out_dtype="float32"),
    "int8_x_uint8": dict(A_dtype="int8", W_dtype="uint8",
                         out_dtype="int32"),
    "float16_x_uint16_scaled": dict(A_dtype="float16", W_dtype="uint16",
                                    with_scaling=True, group_size=32,
                                    out_dtype="float16"),
    "float16_x_nf4_quantized_zeros": dict(
        A_dtype="float16", W_dtype="nf4", with_scaling=True,
        with_zeros=True, zeros_mode="quantized", group_size=32,
        out_dtype="float16"),
    "native_e4m3_x_e5m2": dict(A_dtype="e4m3_float8",
                               W_dtype="e5m2_float8", out_dtype="float32"),
    "native_uint8": dict(A_dtype="uint8", W_dtype="uint8",
                         out_dtype="int32"),
    "native_float64": dict(A_dtype="float64", W_dtype="float64",
                           out_dtype="float64"),
}


@pytest.mark.parametrize("name", list(LINEAR_CASES))
def test_linear_takes_the_new_classes(name, tmp_path, monkeypatch):
    """module.Linear (K = 96, a tail, N = 48) on each new class: its
    buffers in the port's types, the weight loaded through
    load_and_transform_weight, the forward against JAX's result on the
    same reference operands."""
    from bitblas_tpu_torch.cache import global_operator_cache
    from bitblas_tpu_torch.common import DATABASE_PATH_ENV
    from bitblas_tpu_torch.module import Linear
    from bitblas_tpu.quantization import packing as jpack
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path))
    global_operator_cache.clear()
    kw = dict(M=3, N=48, K=96, **LINEAR_CASES[name])
    ops = operands(kw, seed=7)
    lkw = {k: v for k, v in kw.items() if k not in ("M", "N", "K")}
    lin = Linear(96, 48, opt_M=[3], enable_tuning=False, device="cpu",
                 **lkw)
    cfg = lin.bitblas_matmul.config
    if cfg.is_native_compute():
        lin.load_and_transform_weight(to_torch(ops["qweight"]))
        assert lin.weight.dtype == to_torch(ops["qweight"]).dtype
    else:
        q = np.asarray(ops["qweight"])
        if cfg.bit < 8:   # the unpacked codes [N, K], as a user has them
            q = jpack.general_decompress(q.view(np.int8), cfg.bit,
                                         out_elems=96)
        zeros = ops["qzeros"] if cfg.zeros_mode == "quantized" \
            else ops["zeros"]
        lin.load_and_transform_weight(
            to_torch(q), scales=ops["scales"] if cfg.with_scaling else None,
            zeros=zeros)
        assert lin.qweight.dtype == (torch.int16 if cfg.bit == 16
                                     else torch.int32)
        if cfg.with_zeros and cfg.zeros_mode == "quantized":
            assert lin.zeros.dtype == torch.int32
    got = lin(to_torch(ops["A"]))
    assert agrees(as_f64(got), oracle(kw, ops))
    global_operator_cache.clear()


def test_quantlinear_float32_activations():
    """QuantLinear(bits=4, A_dtype="float32") (uint4 with GPTQ's scales and
    zeros under float32 activations, the general instance) against JAX's
    QuantLinear on the same packed buffers."""
    from bitblas_tpu.integration.pytorch import QuantLinear as JaxQuantLinear
    from bitblas_tpu_torch.integration.pytorch import QuantLinear
    gen = torch.Generator().manual_seed(3)
    fake = torch.nn.Linear(96, 48, bias=True)
    s = torch.rand((48, 3), generator=gen) * 0.02 + 0.01
    z = torch.randint(0, 16, (48, 3), generator=gen).float()
    q = torch.randint(0, 16, (48, 96), generator=gen).float()
    gi = torch.arange(96) // 32
    fake.weight.data = (q - z[:, gi]) * s[:, gi]
    pq = QuantLinear(4, 32, 96, 48, bias=True, A_dtype="float32",
                     device="cpu")
    pq.pack(fake, s, z)
    jq = JaxQuantLinear(4, 32, 96, 48, bias=True, A_dtype="float32")
    jq.load_state_dict(pq.state_dict(), strict=False)
    jq.post_init()
    x = torch.randn((2, 96), generator=gen)
    got, want = pq(x), jq(x)
    assert got.dtype == x.dtype and tuple(got.shape) == (2, 48)
    assert_close(got, want.float(), rtol=5e-2, atol=4e-2,
                 max_mismatched_ratio=0.0)


def test_tuner_space_of_general_configs():
    """The tuner's space of configurations the general instance runs: its
    one tile below M = 512 (untuned), the materialize plan from there where
    JAX's rule allows it, offered from the 256 bucket; every hint fits."""
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    from bitblas_tpu_torch.tuner import (H100_SXM, default_hint,
                                         enumerate_hints, smem_bytes)
    for kw in (dict(A_dtype="float16", W_dtype="uint16", with_scaling=True,
                    group_size=128),
               dict(A_dtype="int8", W_dtype="nf4", out_dtype="int32"),
               dict(A_dtype="float32", W_dtype="uint4", with_scaling=True,
                    with_zeros=True, group_size=32, out_dtype="float32"),
               dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
                    group_size=-1, K=288)):
        kw = dict(dict(N=11008, K=4096), **kw)
        cfg = MatmulConfig(**kw)
        for m in (4, 256, 512):
            spec = KernelSpec.from_config(cfg, m)
            assert dq.spec_format(spec) == "general"
            hints = enumerate_hints(spec, H100_SXM)
            assert hints[0] == default_hint(spec, H100_SXM)
            modes = [h.decode_mode for h in hints]
            can = pmat_supports(spec)
            assert hints[0].decode_mode == ("materialize" if m >= 512 and can
                                            else "fused")
            assert ("materialize" in modes) == (m >= 256 and can)
            assert all(smem_bytes(spec, h) <= H100_SXM.smem_per_block
                       for h in hints)
            fused = [h.tile for h in hints if h.decode_mode == "fused"]
            assert fused == [dq.FUSED_TILES["general"][0]]


def pmat_supports(spec):
    from bitblas_tpu_torch.kernels.materialize import \
        supports_materialize_spec
    return supports_materialize_spec(spec)


@pytest.mark.parametrize("kw", [
    dict(A_dtype="float16", W_dtype="uint16", with_scaling=True,
         group_size=32, out_dtype="float16"),
    dict(A_dtype="int8", W_dtype="nf4", group_size=32, out_dtype="int32"),
    dict(A_dtype="float32", W_dtype="uint1", with_scaling=True,
         group_size=48, out_dtype="float32"),
])
def test_split_k_takes_the_new_classes(kw):
    """MatmulWithSplitK (k_split 2, K = 192: shards of 96, a 1-bit shard
    repacked from its codes) on the general instance, against JAX's
    oracle of the unsplit configuration (JAX's own MatmulWithSplitK goes
    through its Matmul, which departs from the oracle for int8 x nf4 and
    whose transform_weight wraps wide values: ROADMAP §3)."""
    from bitblas_tpu.quantization import packing as jpack
    from bitblas_tpu_torch.ops.matmul_splitk import (MatmulConfigWithSplitK,
                                                     MatmulWithSplitK)
    cfg = dict(M=[4], N=48, K=192, k_split=2, **kw)
    op = MatmulWithSplitK(MatmulConfigWithSplitK(**cfg), device="cpu",
                          enable_tuning=False)
    flat = dict(cfg, M=4, k_split=None)
    ops = operands(flat, seed=8)
    q = np.asarray(ops["qweight"])
    if op.config.bit < 8:
        q = jpack.general_decompress(q.view(np.int8), op.config.bit,
                                     out_elems=192)
    extra = {} if ops["scales"] is None else {"scale": ops["scales"]}
    packed = op.transform_weight(to_torch(q), **extra)
    args = packed if isinstance(packed, list) else [packed]
    got = op.forward(to_torch(ops["A"]), args[0],
                     **dict(zip(extra, args[1:])))
    want = oracle({f: v for f, v in flat.items() if v is not None}, ops)
    assert agrees(as_f64(got), want, rtol=2e-3)


@pytest.mark.parametrize("dtype,out", [
    ("uint8", "int32"), ("e4m3_float8", "float32"), ("float64", "float64"),
    ("e5m2_float8", "float16")])
def test_batch_matmul_takes_the_new_types(dtype, out):
    """BatchMatmul over the dense types JAX's takes beyond float16 /
    bfloat16 / float32 / int8, against JAX's BatchMatmul."""
    from bitblas_tpu.ops.batch_matmul import BatchMatmul as JaxBatchMatmul
    from bitblas_tpu.ops.batch_matmul import \
        BatchMatmulConfig as JaxBatchMatmulConfig
    from bitblas_tpu_torch.ops.batch_matmul import (BatchMatmul,
                                                    BatchMatmulConfig)
    kw = dict(Batch=2, M=5, N=24, K=40, A_dtype=dtype, W_dtype=dtype,
              out_dtype=out, layout="nt")
    ops = operands(dict(M=10, N=24, K=40, A_dtype=dtype, W_dtype=dtype),
                   seed=9)
    a = np.asarray(ops["A"]).reshape(2, 5, 40)
    w = np.stack([np.asarray(ops["qweight"])[:12],
                  np.asarray(ops["qweight"])[12:]]).repeat(2, axis=1)
    got = BatchMatmul(BatchMatmulConfig(**kw), device="cpu")(
        to_torch(a), to_torch(w))
    want = JaxBatchMatmul(JaxBatchMatmulConfig(**kw))(jnp.asarray(a),
                                                     jnp.asarray(w))
    want = np.asarray(want.astype(jnp.float32), np.float64)
    assert agrees(as_f64(got), want, rtol=1e-3)

"""Kernel 1's integer column (int8 activations with uint1/2/4 and int1/2/4
weights: kernels/dequant_matmul.dequant_matmul_int) and kernel 3 at 1 bit
on the CPU: the plain version and the decode instance's split arithmetic
(`dequant_matmul_int_split_plain`) against the JAX package's
make_dequant_matmul in interpret mode under the int8 telescope hint of
tests/test_dequant_matmul_kernel.py TestInt8MXUTelescope, the split
planner `plan_splits_k_int` for every M <= 16, kernel 3's plain decode
against JAX's make_weight_decode_int8_pallas(interpret=True), and the
materialize plan's rule for integer activations, and the int8 output's
ties rounding to even as JAX's do.

N = K = 256, M <= 16. Unscaled, both sides sum integers: bit for bit.
Scaled, JAX's kernel applies each group's scale to an exact integer dot,
which is nearer the truth than its float oracle (JAX's own test): each
side is held to a float64 truth at rtol 1e-6, atol 1e-4 (outputs reach a
few hundred).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.dequant_matmul import make_dequant_matmul
from bitblas_tpu.kernels.materialize import make_weight_decode_int8_pallas
from bitblas_tpu.kernels.spec import KernelSpec as JaxKernelSpec
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops.weight_transform import \
    transform_reference_operands as jax_transform
from bitblas_tpu.quantization import numerics as jnumerics
from bitblas_tpu.quantization.packing import general_decompress
from bitblas_tpu.testing import random_reference_operands
from bitblas_tpu.tuner.hint import TileHint as JaxTileHint

from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.kernels import materialize as mz
from bitblas_tpu_torch.kernels.spec import KernelSpec
from bitblas_tpu_torch.ops import weight_transform as wt
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import INT_PAIRS, MatmulConfig
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.tuner import MATERIALIZE

N = K = 256
SMS = 132
TELESCOPE = JaxTileHint(block_m=64, block_n=512, block_k=128,
                        mma_dtype="int8", decode_mode="telescope")
FORMATS = [w for _, w in INT_PAIRS]
TRUTH_TOL = dict(rtol=1e-6, atol=1e-4, max_mismatched_ratio=0.0)


def _case(w_dtype, group=None, zeros=False, m=16, seed=0):
    """(JAX config, port config, reference operands, port device operands,
    A as a tensor) of an int8 x w_dtype layer; `group` None: unscaled."""
    kw = dict(M=m, N=N, K=K, A_dtype="int8", W_dtype=w_dtype,
              with_scaling=group is not None, with_zeros=zeros,
              group_size=group or -1, accum_dtype="int32",
              out_dtype="float32")
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = random_reference_operands(jc, m, seed)
    dw = wt.transform_reference_operands(pc, ops.qweight, ops.scales,
                                         ops.zeros)
    return jc, pc, ops, dw, torch.from_numpy(np.asarray(ops.A))


def _jax_telescope(jc, ops, m):
    dw = jax_transform(jc, ops.qweight, ops.scales, ops.zeros)
    fn = make_dequant_matmul(JaxKernelSpec.from_config(jc, m), TELESCOPE,
                             interpret=True)
    j = (lambda a: None if a is None else jnp.asarray(a))
    return np.asarray(fn(jnp.asarray(ops.A), jnp.asarray(dw.qweight),
                         scales=j(dw.scales), zeros=j(dw.zeros)))


def _truth(jc, ops, group, zeros):
    """float64 A . ((v - z) s)^T of the reference operands."""
    family, bits = jc.source_format, jc.bit
    v = general_decompress(ops.qweight, bits, out_elems=K).astype(
        np.float64)
    if family == "int":
        v -= 1 << (bits - 1)
    s = np.repeat(np.asarray(ops.scales, np.float64), group, axis=1)
    if zeros:
        v = v - np.repeat(np.asarray(ops.zeros, np.float64), group, axis=1)
    return ops.A.astype(np.float64) @ (v * s).T


@pytest.mark.parametrize("w_dtype", FORMATS)
def test_unscaled_bit_equal_to_jax_telescope(w_dtype):
    """The plain version and the split arithmetic at M = 16 (the int32
    sums, taken to float32) equal JAX's telescope kernel bit for bit; the
    split arithmetic at M = 1 and 7 equals the plain version."""
    jc, pc, ops, dw, A = _case(w_dtype)
    want = _jax_telescope(jc, ops, 16)
    plain = dq.dequant_matmul_int_plain(A, dw.qweight, w_dtype)
    split = dq.dequant_matmul_int_split_plain(A, dw.qweight, w_dtype,
                                              sms=SMS)
    assert plain.dtype == torch.float32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(split.numpy(), want)
    for m in (1, 7):
        assert torch.equal(
            dq.dequant_matmul_int_split_plain(A[:m], dw.qweight, w_dtype,
                                              out_dtype=torch.int32,
                                              sms=SMS),
            dq.dequant_matmul_int_plain(A[:m], dw.qweight, w_dtype,
                                        out_dtype=torch.int32))


@pytest.mark.parametrize("w_dtype,group,zeros", [
    ("uint4", 128, False), ("uint4", 64, True), ("uint2", 32, True),
    ("uint1", 256, True), ("int4", 64, False), ("int1", 128, False),
    ("int2", 256, False)])
def test_scaled_against_float64_truth(w_dtype, group, zeros):
    """Scaled (and with zeros, original mode): JAX's telescope kernel, the
    plain version and the split arithmetic each within rtol 1e-6 of the
    float64 truth."""
    jc, pc, ops, dw, A = _case(w_dtype, group, zeros, seed=group)
    truth = _truth(jc, ops, group, zeros)
    assert_close(_jax_telescope(jc, ops, 16), truth, **TRUTH_TOL)
    for fn in (dq.dequant_matmul_int_plain,
               dq.dequant_matmul_int_split_plain):
        got = fn(A, dw.qweight, w_dtype, dw.scales, dw.zeros, group)
        assert got.dtype == torch.float32
        assert_close(got, truth, msg=fn.__name__, **TRUTH_TOL)


def test_rescale_and_outputs_follow_jax_oracle():
    """Zeros mode rescale, a bias, and the int8 (saturating), float16 and
    int32 outputs of the plain and split versions against the JAX
    oracle: int8 within 1 (the f32 sums' order), int32 bit-equal."""
    from bitblas_tpu.ops.reference import matmul_reference
    for out, zeros_mode, scaled in (("int8", "rescale", True),
                                    ("float16", "original", True),
                                    ("int8", "original", False),
                                    ("int32", "original", False)):
        kw = dict(M=16, N=N, K=K, A_dtype="int8", W_dtype="uint2",
                  with_scaling=scaled, with_zeros=scaled,
                  zeros_mode=zeros_mode, group_size=64 if scaled else -1,
                  with_bias=True, out_dtype=out)
        jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
        ops = random_reference_operands(jc, 16, 3)
        j = (lambda a: None if a is None else jnp.asarray(a))
        want = np.asarray(matmul_reference(
            jc, jnp.asarray(ops.A), jnp.asarray(ops.qweight), j(ops.scales),
            j(ops.zeros), None, j(ops.bias))).astype(np.float64)
        dw = wt.transform_reference_operands(pc, ops.qweight, ops.scales,
                                             ops.zeros, None, ops.bias)
        A = torch.from_numpy(np.asarray(ops.A))
        for fn in (dq.dequant_matmul_int_plain,
                   dq.dequant_matmul_int_split_plain):
            got = fn(A, dw.qweight, "uint2", dw.scales, dw.zeros,
                     pc.effective_group_size, dw.bias, zeros_mode,
                     getattr(torch, out))
            assert str(got.dtype) == f"torch.{out}"
            diff = np.abs(got.double().numpy() - want)
            if out in ("int8", "int32") and not scaled:
                assert diff.max() == 0, (out, fn.__name__)
            elif out == "int8":
                assert diff.max() <= 1, (out, fn.__name__)
            else:   # one f16 rounding apart
                assert (diff <= 2 ** -10 * np.abs(want) + 2 ** -10).all()


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("N_,K_", [(256, 4096), (4096, 512), (136, 1408),
                                   (11008, 4096)])
def test_plan_splits_k_int_covers_each_step_once(bits, N_, K_):
    """For every M <= 16: K's steps of 512 / bits each covered by one
    split, none empty, at most INT_MAX_SPLIT_K of K a split, and within a
    factor 2 of the blocks an SM the planner aims at where K has the
    steps."""
    step = 512 // bits
    steps = -(-K_ // step)
    for m in range(1, 17):
        chunk, splits = dq.plan_splits_k_int(m, N_, K_, bits, SMS)
        assert 1 <= chunk <= dq.INT_MAX_SPLIT_K // step
        assert splits == -(-steps // chunk)
        cover = np.zeros(steps, np.int64)
        for s in range(splits):
            lo, hi = s * chunk, min((s + 1) * chunk, steps)
            assert hi > lo, "an empty split"
            cover[lo:hi] += 1
        assert (cover == 1).all()
        tiles = -(-N_ // dq.DECODE_BN) * -(-m // dq.DECODE_BM)
        target = dq.SPLITK_BLOCKS_PER_SM * SMS
        if steps * tiles >= 2 * target:
            assert 2 * tiles * splits >= target
    with pytest.raises(ValueError):
        dq.plan_splits_k_int(4, 256, 4160, bits, SMS)   # K % 128
    assert dq.plan_splits_k_int(4, 11008, 4096, 4) == \
        dq.plan_splits_k_int(4, 11008, 4096, 4, SMS)


@pytest.mark.parametrize("w_dtype", ["int2", "uint2", "int4", "uint4",
                                     "int1", "uint1"])
def test_weight_decode_int8_plain_matches_jax_pallas(w_dtype):
    """Kernel 3's plain version (int8 codes [N, K], 1, 2 and 4 bits) equals
    JAX's make_weight_decode_int8_pallas in interpret mode ([K, N]) on the
    same reference weight, every code included."""
    cfg = dict(M=16, N=512, K=512, A_dtype="int8", W_dtype=w_dtype,
               accum_dtype="int32", out_dtype="float32")
    jc, pc = JaxMatmulConfig(**cfg), MatmulConfig(**cfg)
    ops = random_reference_operands(jc, 16, 0)
    want = np.asarray(make_weight_decode_int8_pallas(
        JaxKernelSpec.from_config(jc, 16), interpret=True)(
        jnp.asarray(jax_transform(jc, ops.qweight, None).qweight)))
    dw = wt.transform_reference_operands(pc, ops.qweight)
    got = mz.weight_decode_int8(dw.qweight, pc.bit, pc.source_format)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want[:, :512].T)
    assert got.unique().numel() == 1 << pc.bit
    lo = -(1 << (pc.bit - 1)) if pc.source_format == "int" else 0
    assert int(got.min()) == lo
    # JAX's field decode of the same codes
    fields = general_decompress(ops.qweight, pc.bit, out_elems=512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnumerics.decode_field(jnp.asarray(fields), pc.source_format,
                               pc.bit, jnp.int8)))


@pytest.mark.parametrize("w_dtype", ["uint1", "int4"])
def test_materialize_per_channel_matches_jax(w_dtype):
    """Integer activations take the materialize plan only without zeros and
    with at most per-channel scales, as in JAX: unscaled and per channel
    at M = 512 (its default from 512) it matches JAX's oracle (int32 sums
    exact; per channel the int32 sums times the scale in float32)."""
    from bitblas_tpu.ops.reference import matmul_reference
    for scaled in (False, True):
        kw = dict(M=[16, 512], N=N, K=K, A_dtype="int8", W_dtype=w_dtype,
                  with_scaling=scaled, group_size=-1, accum_dtype="int32",
                  out_dtype="float32")
        jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
        op = Matmul(pc, device="cpu", enable_tuning=False)
        assert op.hint_for(512) == MATERIALIZE
        assert op.hint_for(16).decode_mode == "fused"
        ops = random_reference_operands(jc, 512, 5)
        j = (lambda a: None if a is None else jnp.asarray(a))
        want = np.asarray(matmul_reference(jc, jnp.asarray(ops.A),
                                           jnp.asarray(ops.qweight),
                                           j(ops.scales)))
        dw = wt.transform_reference_operands(pc, ops.qweight, ops.scales)
        got = op.forward(torch.from_numpy(np.asarray(ops.A)), dw.qweight,
                         scale=dw.scales)
        if scaled:
            assert_close(got, want, rtol=1e-6, atol=1e-4,
                         max_mismatched_ratio=0.0)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("group,zeros", [(64, False), (-1, True),
                                         (128, True)])
def test_materialize_refused_for_grouped_or_zeros(group, zeros):
    """A grouped or zero-point integer configuration keeps the fused kernel
    at every M (materialize is not in its tuning space either), and
    forcing the plan raises, as in JAX."""
    from bitblas_tpu_torch.tuner import H100_SXM, enumerate_hints
    cfg = MatmulConfig(M=[512], N=N, K=K, A_dtype="int8", W_dtype="uint4",
                       with_scaling=True, with_zeros=zeros, group_size=group,
                       out_dtype="int8")
    op = Matmul(cfg, device="cpu", enable_tuning=False)
    assert op.hint_for(512).decode_mode == "fused"
    spec = KernelSpec.from_config(cfg, 512)
    assert MATERIALIZE not in enumerate_hints(spec, H100_SXM)
    assert not mz.supports_materialize_spec(spec)
    with pytest.raises(ValueError, match="materialize"):
        mz.materialize_matmul(spec, torch.zeros((512, K), dtype=torch.int8),
                              torch.zeros((N, K // 8), dtype=torch.int32))


def test_int8_output_rounds_ties_to_even_as_jax():
    """Scales of 0.5 make every odd integer sum a tie (k + 0.5, exact in
    float32): the saturating int8 output rounds it half to even and
    clamps, bit for bit as JAX's oracle, in the plain version and the
    split arithmetic."""
    from bitblas_tpu.ops.reference import matmul_reference
    kw = dict(M=16, N=N, K=K, A_dtype="int8", W_dtype="uint2",
              with_scaling=True, group_size=-1, out_dtype="int8")
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = random_reference_operands(jc, 16, 6)
    A = np.asarray(ops.A) // 4            # sums mostly inside int8's range
    scales = np.full_like(np.asarray(ops.scales), 0.5)
    want = np.asarray(matmul_reference(jc, jnp.asarray(A),
                                       jnp.asarray(ops.qweight),
                                       jnp.asarray(scales)))
    dw = wt.transform_reference_operands(pc, ops.qweight, scales)
    d = dq.dequant_matmul_int_plain(torch.from_numpy(A), dw.qweight, "uint2",
                                    out_dtype=torch.int32)
    ties = (d % 2 != 0) & (d.abs() < 255)
    assert ties.sum() > 1000 and (d.abs() > 256).any()   # ties and clamps
    for fn in (dq.dequant_matmul_int_plain,
               dq.dequant_matmul_int_split_plain):
        got = fn(torch.from_numpy(A), dw.qweight, "uint2", dw.scales, None,
                 K, out_dtype=torch.int8)
        np.testing.assert_array_equal(got.numpy(), want)
    # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    tie = got[ties].int()
    assert ((tie % 2) == 0).all()

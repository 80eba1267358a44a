"""Kernel 1's decode instances (split-K, register decode; uint4 x f16 and
int2 x int8) on the CPU: their split planners, the split-then-merge
arithmetic they compute (`dequant_matmul_u4_split_plain`,
`dequant_matmul_i2_split_plain`) against the JAX package's
make_dequant_matmul (Pallas, interpret mode) and oracle, and the tuner's
space with the new instances.

The int2 x int8 sums are integers on both sides: every comparison of the
int2 path is bit for bit.

Tolerances (as tests/test_torch_dequant_matmul.py, same configuration):
against the JAX oracle (dequantize in f16, contract in f32) the outputs
differ only by the order of the f32 sums, here regrouped by split: 1 f16
ulp of outputs reaching ~400, atol 0.25. Against the JAX Pallas kernel,
which applies scales and zeros to its f32 accumulator, each weight also
carries a 2^-11 relative rounding: rtol 1e-2, atol 1.0. Against the
single-pass plain version: one f16 rounding of the output apart, at most
1 ulp (0.25 at |out| < 512).
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

from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.kernels.spec import KernelSpec
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.tuner import (H100_SXM, TileHint, default_hint,
                                     enumerate_hints, smem_bytes)

SMS = 132
CFG = dict(N=256, K=512, A_dtype="float16", W_dtype="uint4",
           with_scaling=True, with_zeros=True, zeros_mode="original",
           group_size=128, out_dtype="float16")
# (N, K): Llama-2-7B's projections, then Mixtral-8x7B's experts (gate / up,
# down)
W4A16_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008), (14336, 4096),
                (4096, 14336))
# BitNet's W2A8 projections at Llama-3-8B widths: gate/up, down, q/o, k/v
W2A8_SHAPES = ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096))
I2_CFG = dict(N=256, K=512, A_dtype="int8", W_dtype="int2",
              accum_dtype="int32", out_dtype="float32")


def _covered(chunk, splits, groups):
    """How often each K group is covered by the splits the kernel walks:
    split s takes groups [s * chunk, min((s + 1) * chunk, groups))."""
    cover = np.zeros(groups, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, groups)
        assert hi > lo, "an empty split"
        cover[lo:hi] += 1
    return cover


@pytest.mark.parametrize("N,K", W4A16_SHAPES + ((4096, 128), (136, 2048)))
def test_plan_splits_k_covers_each_group_once(N, K):
    groups = K // 128
    for m in range(1, 17):
        chunk, splits = dq.plan_splits_k(m, N, K, SMS)
        assert 1 <= chunk <= dq.DECODE_MAX_CHUNK
        assert splits == -(-groups // chunk)
        assert (_covered(chunk, splits, groups) == 1).all()
        tiles = -(-N // dq.DECODE_BN) * -(-m // dq.DECODE_BM)
        target = dq.SPLITK_BLOCKS_PER_SM * SMS
        if groups * tiles >= 2 * target:
            # whole groups a split: within a factor 2 of the target
            assert 2 * tiles * splits >= target
        elif tiles * groups <= target:   # one group a split: all K gives
            assert chunk == 1


def test_plan_splits_k_takes_static_sizes_only():
    assert dq.plan_splits_k(4, 11008, 4096, SMS) == (8, 4)
    assert dq.plan_splits_k(4, 4096, 4096, SMS) == (4, 8)
    assert dq.plan_splits_k(1, 4096, 128, SMS) == (1, 1)
    with pytest.raises(ValueError):
        dq.plan_splits_k(4, 4096, 4000, SMS)       # K not whole groups
    with pytest.raises(ValueError):
        dq.plan_splits_k(0, 4096, 4096, SMS)


@pytest.fixture(scope="module")
def ops():
    jc = JaxMatmulConfig(M=[1, 16], **CFG)
    pc = MatmulConfig(M=[1, 16], **CFG)
    ref = jtesting.random_reference_operands(jc, 1, seed=13)
    codes = general_decompress(ref.qweight, 4, out_elems=jc.K)
    jm = JaxMatmul(jc, enable_tuning=False)
    jw = jm.transform_weight(codes, scale=ref.scales, zeros=ref.zeros)
    pm = Matmul(pc, device="cpu")
    pw = pm.transform_weight(codes, scale=ref.scales, zeros=ref.zeros)
    return jc, jm, jw, pw, ref


@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_split_plain_matches_jax(ops, m):
    jc, jm, (W, S, Z), (pW, pS, pZ), ref = ops
    chunk, splits = dq.plan_splits_k(m, jc.N, jc.K, SMS)
    assert (chunk, splits) == (1, 4)          # every group its own split
    A = np.random.default_rng(40 + m).standard_normal(
        (m, jc.K)).astype(np.float16)
    At = torch.from_numpy(A)
    got = dq.dequant_matmul_u4_split_plain(At, pW, pS, pZ, sms=SMS)
    assert got.dtype == torch.float16 and tuple(got.shape) == (m, jc.N)
    oracle = np.asarray(jref.matmul_reference(
        jc, jnp.asarray(A), jnp.asarray(ref.qweight),
        jnp.asarray(ref.scales), jnp.asarray(ref.zeros)))
    assert_close(got, oracle, rtol=0.0, atol=0.25, max_mismatched_ratio=0.0)
    kernel = np.asarray(jm.forward(jnp.asarray(A), W, scale=S, zeros=Z))
    assert_close(got, kernel, rtol=1e-2, atol=1.0, max_mismatched_ratio=0.0)
    single = dq.dequant_matmul_u4_plain(At, pW, pS, pZ)
    assert_close(got, single.float().numpy(), rtol=0.0, atol=0.25,
                 max_mismatched_ratio=0.0)
    # the wrapper on the CPU runs the plain version at every instance
    assert torch.equal(dq.dequant_matmul_u4(At, pW, pS, pZ,
                                            tile=dq.U4_DECODE_TILE), single)


def _spec(m, N=4096, K=4096):
    cfg = dict(CFG, N=N, K=K)
    return KernelSpec.from_config(MatmulConfig(**cfg), m)


@pytest.mark.parametrize("N,K", W4A16_SHAPES)
def test_tuner_defaults_and_space_take_the_decode_instance(N, K):
    decode = TileHint("fused", *dq.U4_DECODE_TILE)
    for m in (1, 4, 16, 17, 256):
        spec = _spec(m, N, K)
        hints = enumerate_hints(spec, H100_SXM)
        assert (default_hint(spec, H100_SXM) == decode) == (m <= 16)
        assert hints[0] == default_hint(spec, H100_SXM)
        assert decode in hints            # a measured candidate at every M
        assert smem_bytes(spec, decode) == dq.fused_smem_bytes(
            "uint4", dq.U4_DECODE_TILE) <= H100_SXM.smem_per_block
    # the 16 x 32 instance is no longer compiled: a hint naming it raises
    A = torch.zeros((4, 256), dtype=torch.float16)
    qw = torch.zeros((128, 32), dtype=torch.int32)
    s = torch.zeros((2, 128), dtype=torch.float16)
    with pytest.raises(ValueError, match="not compiled"):
        dq.dequant_matmul_u4(A, qw, s, s, tile=(16, 32, 128, 6))


@pytest.mark.parametrize("N,K", W2A8_SHAPES + ((136, 4096), (4096, 4160),
                                              (136, 4160), (1024, 64)))
def test_plan_splits_k_i2_covers_each_step_once(N, K):
    steps = -(-K // dq.I2_DECODE_STEP)      # the last may end at a K tail
    for m in range(1, 17):
        chunk, splits = dq.plan_splits_k_i2(m, N, K, SMS)
        assert 1 <= chunk <= dq.I2_DECODE_MAX_CHUNK
        assert splits == -(-steps // chunk)
        assert (_covered(chunk, splits, steps) == 1).all()
        tiles = -(-N // dq.DECODE_BN) * -(-m // dq.DECODE_BM)
        target = dq.SPLITK_BLOCKS_PER_SM * SMS
        if steps * tiles >= 2 * target:
            assert 2 * tiles * splits >= target
        elif tiles * steps <= target:   # one step a split: all K gives
            assert chunk == 1


def test_plan_splits_k_i2_takes_static_sizes_only():
    # M = 4 on BitNet's projections: 112, 32, 32 and 8 tiles of 128 rows
    assert dq.plan_splits_k_i2(4, 14336, 4096, SMS) == (6, 3)
    assert dq.plan_splits_k_i2(4, 4096, 14336, SMS) == (7, 8)
    assert dq.plan_splits_k_i2(4, 4096, 4096, SMS) == (2, 8)
    assert dq.plan_splits_k_i2(4, 1024, 4096, SMS) == (1, 16)
    assert dq.plan_splits_k_i2(1, 4096, 4160, SMS) == (2, 9)   # 17 steps
    with pytest.raises(ValueError):
        dq.plan_splits_k_i2(4, 4096, 4000, SMS)    # K not a multiple of 64
    with pytest.raises(ValueError):
        dq.plan_splits_k_i2(0, 4096, 4096, SMS)


@pytest.fixture(scope="module")
def i2_ops():
    jc = JaxMatmulConfig(M=[1, 16], **I2_CFG)
    pc = MatmulConfig(M=[1, 16], **I2_CFG)
    ref = jtesting.random_reference_operands(jc, 1, seed=17)
    values = general_decompress(ref.qweight, 2, out_elems=jc.K).astype(
        np.int8) - 2
    jm = JaxMatmul(jc, enable_tuning=False)
    pm = Matmul(pc, device="cpu")
    return jc, jm, jm.transform_weight(values), pm.transform_weight(values)


@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_i2_split_plain_matches_jax(i2_ops, m):
    jc, jm, jW, pW = i2_ops
    chunk, splits = dq.plan_splits_k_i2(m, jc.N, jc.K, SMS)
    assert (chunk, splits) == (1, 2)          # every step its own split
    A = jtesting.random_reference_operands(jc, m, seed=50 + m).A
    At = torch.from_numpy(A)
    got = dq.dequant_matmul_i2_split_plain(At, pW, sms=SMS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, jc.N)
    assert torch.equal(got, dq.dequant_matmul_i2_plain(At, pW))
    kernel = np.asarray(jm.forward(jnp.asarray(A), jW))
    assert np.array_equal(got.numpy(), kernel)
    # full-range activations too (the operands above draw -8 .. 7)
    A8 = np.random.default_rng(60 + m).integers(
        -128, 128, (m, jc.K)).astype(np.int8)
    full = dq.dequant_matmul_i2_split_plain(torch.from_numpy(A8), pW,
                                            sms=SMS)
    assert np.array_equal(full.numpy(),
                          np.asarray(jm.forward(jnp.asarray(A8), jW)))
    # the wrapper on the CPU runs the plain version at every instance
    assert torch.equal(dq.dequant_matmul_i2(At, pW, tile=dq.I2_DECODE_TILE),
                       got)


def _i2_spec(m, N, K):
    return KernelSpec.from_config(MatmulConfig(**dict(I2_CFG, N=N, K=K)), m)


@pytest.mark.parametrize("N,K", W2A8_SHAPES)
def test_tuner_defaults_and_space_take_the_i2_decode_instance(N, K):
    decode = TileHint("fused", *dq.I2_DECODE_TILE)
    for m in (1, 4, 16, 17, 256):
        spec = _i2_spec(m, N, K)
        hints = enumerate_hints(spec, H100_SXM)
        assert (default_hint(spec, H100_SXM) == decode) == (m <= 16)
        assert hints[0] == default_hint(spec, H100_SXM)
        assert decode in hints            # a measured candidate at every M
        assert smem_bytes(spec, decode) == dq.fused_smem_bytes(
            "int2", dq.I2_DECODE_TILE) <= H100_SXM.smem_per_block
    # the 16 x 32 mma.sync instance is no longer compiled: a hint naming
    # it raises
    A = torch.zeros((4, 256), dtype=torch.int8)
    qw = torch.zeros((128, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="not compiled"):
        dq.dequant_matmul_i2(A, qw, tile=(16, 32, 256, 4))

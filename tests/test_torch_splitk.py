"""Kernel 1's uint4 decode instance (split-K, register decode) on the CPU:
its split planner, the split-then-merge arithmetic it computes
(`dequant_matmul_u4_split_plain`) against the JAX package's
make_dequant_matmul (Pallas, interpret mode) and oracle, and the tuner's
space with the new instance.

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
W4A16_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))   # (N, K)


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

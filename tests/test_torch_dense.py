"""The port's native dense route and TPU kernel 9's counterpart
(kernels/dense.py, ops/matmul.py's "dense" plan) against the JAX package,
on the CPU.

Both packages get identical numpy inputs (bfloat16 draws travel as
float32 holding the bfloat16 values). The JAX side runs its XLA dot
(`Matmul`, `make_dense_matmul`) and its Pallas kernel 9
(`make_dense_matmul_pallas`) in interpret mode; the port runs its plain
versions.

Tolerances. int8 products sum exactly in int32 on both sides: equal.
Float products accumulate in float32 on both sides and round once to the
output type, so they differ only in the order of the float32 sums: at
most one ulp of the output where a sum lands near a rounding boundary --
rtol 2e-3 for float16 (ulp 2^-10 relative), 1.6e-2 for bfloat16 (2^-7),
1e-5 for float32 (K <= 256 terms of float32 rounding), each with a small
atol for outputs near zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.dense import (
    make_dense_matmul_pallas as jax_dense_pallas)
from bitblas_tpu.kernels.spec import KernelSpec as JaxKernelSpec
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.testing import random_reference_operands as jax_operands
from bitblas_tpu.tuner.hint import TileHint as JaxTileHint

from bitblas_tpu_torch.kernels import dense as pdense
from bitblas_tpu_torch.kernels.spec import KernelSpec
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.testing import random_reference_operands
from bitblas_tpu_torch.tuner import CPU, TileHint, default_hint

from torch_jax_parity import agrees, as_f64, operands, oracle, port_forward

OUT = {"float16": "float16", "bfloat16": "bfloat16", "float32": "float32",
       "int8": "int32"}
TOL = {"float16": dict(rtol=2e-3, atol=1e-3),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-2),
       "float32": dict(rtol=1e-5, atol=1e-5),
       "int8": dict(rtol=0.0, atol=0.0)}
DTYPES = list(OUT)


def _config_kw(dtype, layout="nt", with_bias=False, M=(16,), N=128,
               K=256):
    return dict(M=list(M), N=N, K=K, A_dtype=dtype, W_dtype=dtype,
                out_dtype=OUT[dtype],
                accum_dtype="int32" if dtype == "int8" else "float32",
                layout=layout, with_bias=with_bias)


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    """A JAX-side numpy operand as the port's tensor (bfloat16 via its
    exact float32 values)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.asarray(x).astype(np.float32)) \
            .to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _compare(got: torch.Tensor, want, dtype):
    want = np.asarray(want)
    if dtype == "int8":
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    else:
        assert_close(got.float(), want.astype(np.float32),
                     max_mismatched_ratio=0.0, **TOL[dtype])


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_native_matmul_matches_jax(dtype, layout, with_bias):
    kw = _config_kw(dtype, layout, with_bias)
    jc, pc = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = jax_operands(jc, 16, seed=3)
    bias = np.random.default_rng(4).standard_normal(jc.N).astype(np.float32)
    A = ops.A if layout[0] == "n" else np.ascontiguousarray(ops.A.T)
    jm = JaxMatmul(jc, enable_tuning=False)
    pm = Matmul(pc, device="cpu")
    if with_bias:
        jW, jb = jm.transform_weight(ops.qweight, bias=bias)
        pW, pb = pm.transform_weight(_torch(ops.qweight, dtype), bias=bias)
    else:
        jW, jb = jm.transform_weight(ops.qweight), None
        pW, pb = pm.transform_weight(_torch(ops.qweight, dtype)), None
    want = jm.forward(jnp.asarray(A), jW, bias=jb)
    got = pm.forward(_torch(A, dtype), pW, bias=pb)
    assert tuple(got.shape) == (16, jc.N)
    assert pm.hint_for(16).decode_mode == "dense"
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_operands_match_jax_draws(dtype):
    kw = _config_kw(dtype, "nn")
    jops = jax_operands(JaxMatmulConfig(**kw), 4, seed=9)
    pops = random_reference_operands(MatmulConfig(**kw), 4, seed=9)
    for a, b in ((jops.A, pops.A), (jops.qweight, pops.qweight)):
        assert np.array_equal(np.asarray(a).astype(np.float64),
                              np.asarray(b).astype(np.float64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_matmul_plain_matches_jax_pallas(dtype):
    """Kernel 9's plain version against the Pallas kernel in interpret
    mode at M = 16, N = K = 256, tile (16, 128, 128)."""
    kw = _config_kw(dtype, M=(16,), N=256, K=256)
    jc = JaxMatmulConfig(**kw)
    ops = jax_operands(jc, 16, seed=5)
    precision = "highest" if dtype == "float32" else "default"
    jhint = JaxTileHint(block_m=16, block_n=128, block_k=128,
                        precision=precision)
    want = jax_dense_pallas(JaxKernelSpec.from_config(jc, 16), jhint,
                            interpret=True)(jnp.asarray(ops.A),
                                            jnp.asarray(ops.qweight))
    spec = KernelSpec.from_config(MatmulConfig(**kw), 16)
    hint = TileHint("dense", 16, 128, 128, 0, precision)
    before = pdense.dense_matmul.launches
    got = pdense.make_dense_matmul_pallas(spec, hint)(
        _torch(ops.A, dtype), _torch(ops.qweight, dtype))
    assert pdense.dense_matmul.launches == before   # CPU: plain version
    _compare(got, want, dtype)
    plain = pdense.dense_matmul_plain(_torch(ops.A, dtype),
                                      _torch(ops.qweight, dtype),
                                      got.dtype)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("n,k", [(136, 256), (256, 200)])
def test_dense_matmul_pallas_rejects_ragged_tiles(n, k):
    kw = _config_kw("float16", N=n, K=k)
    jc = JaxMatmulConfig(**kw)
    jhint = JaxTileHint(block_m=16, block_n=128, block_k=128)
    with pytest.raises(ValueError):
        jax_dense_pallas(JaxKernelSpec.from_config(jc, 16), jhint,
                         interpret=True)
    spec = KernelSpec.from_config(MatmulConfig(**kw), 16)
    with pytest.raises(ValueError):
        pdense.make_dense_matmul_pallas(
            spec, TileHint("dense", 16, 128, 128, 0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_16_row_hint_launches_its_tile(dtype):
    """The 16-row tile is float32's; a hint of it runs the 64 x 128 wgmma
    tile for the other types, with that tile's shared memory."""
    dt = getattr(torch, dtype)
    small, wgmma = pdense.DENSE_TILES[:2]
    want = small if dt == torch.float32 else wgmma
    assert pdense.launched_tile(dt, small) == want
    assert pdense.dense_smem_bytes(dt, small) == \
        pdense.dense_smem_bytes(dt, want)
    for tile in pdense.DENSE_TILES[1:]:
        assert pdense.launched_tile(dt, tile) == tile


def test_dense_matmul_checks_its_arguments():
    A = torch.zeros((4, 256), dtype=torch.float16)
    W = torch.zeros((128, 256), dtype=torch.float16)
    with pytest.raises(ValueError, match="not compiled"):
        pdense.dense_matmul(A, W, torch.float16, (32, 128, 128))
    with pytest.raises(ValueError, match="out_dtype"):
        pdense.dense_matmul(A, W, torch.int32)
    with pytest.raises(ValueError):
        pdense.dense_matmul(A, W.float(), torch.float16)     # mixed types
    with pytest.raises(ValueError):
        pdense.dense_matmul(A.T.contiguous().T, W, torch.float16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_native_default_hint_is_dense(dtype):
    """One "dense" hint per native spec, as in JAX: true float32 for
    float32 (JAX's precision="highest"), a kernel-9 tile that divides N
    and K."""
    spec = KernelSpec.from_config(MatmulConfig(**_config_kw(dtype)), 300)
    hint = default_hint(spec, CPU)
    assert hint.decode_mode == "dense"
    assert hint.precision == ("highest" if dtype == "float32" else "default")
    assert hint.tile[:3] in pdense.DENSE_TILES
    assert spec.n % hint.block_n == 0 and spec.k % hint.block_k == 0
    pdense.make_dense_matmul_pallas(spec, hint)       # legal for kernel 9


def test_native_config_legalizes_accumulation():
    """The dense route accumulates in int32 for int8 and float32 for
    floats whatever accum_dtype says; the config records that type. Every
    output type JAX takes runs (a bfloat16 pair into float16), and scales
    on a native pair are dropped, as JAX's XLA dot drops them (ROADMAP
    §3): both against JAX's oracle."""
    cfg = MatmulConfig(N=128, K=256, A_dtype="int8", W_dtype="int8",
                       out_dtype="int32", accum_dtype="float32")
    assert cfg.accum_dtype == "int32" and cfg.storage_dtype == "int8"
    assert cfg.is_native_compute() and not cfg.fast_decoding
    for kw in (dict(A_dtype="bfloat16", W_dtype="bfloat16",
                    out_dtype="float16"),
               dict(A_dtype="float16", W_dtype="float16", group_size=128,
                    with_scaling=True)):
        kw = dict(M=4, N=128, K=256, **kw)
        ops = operands(kw)
        got = port_forward(MatmulConfig(**kw), ops["A"], ops["qweight"])
        assert agrees(as_f64(got), oracle(kw, ops))

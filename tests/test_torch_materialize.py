"""The port's W2A8 operator and materialize plan (kernels/materialize.py,
the int2 path of kernels/dequant_matmul.py, ops/matmul.py's routes, the
int side of quantization/ and ops/) against the JAX package, on the CPU.

Both packages get identical numpy inputs. The JAX side runs its Pallas
kernels in interpret mode, the port its kernels' plain versions.

Tolerances. Decodes are bit-exact: kernel 2's float32 and bfloat16
outputs are the same float32 value (q - z) * s with one cast on both
sides, its float16 output is the fused kernel's tile; kernel 3's int8
codes are integers. The int2 x int8 operator accumulates integers on both
sides, so it is exact. The uint4 x f16 routes round the decoded weight to
f16 (2^-11 relative per weight) where JAX's float32 materialize plan keeps
it in float32; over K = 512 random-sign terms of outputs up to ~400 that
is ~0.05 standard deviation, so rtol 1e-2 with atol 1.0 (as
test_torch_dequant_matmul.py holds the fused kernel). The two port routes
share the f16 weight and differ only in the order of their float32 sums
and one f16 rounding of the output: atol 0.25, one ulp at 256-512.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu import testing as jtesting
from bitblas_tpu.kernels import materialize as jmat
from bitblas_tpu.kernels.spec import KernelSpec as JaxKernelSpec
from bitblas_tpu.ops import reference as jref
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.quantization import numerics as jnum
from bitblas_tpu.quantization import packing as jpack
from bitblas_tpu.tuner.hint import TileHint as JaxTileHint

import bitblas_tpu_torch.ops.matmul as pmm
from bitblas_tpu_torch import testing as ptesting
from bitblas_tpu_torch.kernels import materialize as pmat
from bitblas_tpu_torch.kernels.dequant_matmul import (
    decode_i2_hopper, default_tile, dequant_matmul_i2,
    dequant_matmul_i2_plain, dequantize_hopper)
from bitblas_tpu_torch.kernels.spec import KernelSpec
from bitblas_tpu_torch.ops import reference as pref
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.quantization import numerics as pnum
from bitblas_tpu_torch.quantization import packing as ppack
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.tuner import TileHint

from torch_jax_parity import agrees, as_f64, jax_refusal, operands, oracle, \
    port_forward

N, K = 256, 512
U4 = dict(N=N, K=K, A_dtype="float16", W_dtype="uint4", with_scaling=True,
          with_zeros=True, zeros_mode="original", group_size=128,
          out_dtype="float16")
I2 = dict(N=N, K=K, A_dtype="int8", W_dtype="int2", accum_dtype="int32",
          out_dtype="float32")
MAT_F32 = JaxTileHint(block_m=64, block_n=256, block_k=128,
                      mma_dtype="float32", decode_mode="materialize",
                      precision="highest")


def _fields(jc, seed):
    """Reference operands and the unsigned weight fields [N, K]."""
    ops = jtesting.random_reference_operands(jc, 1, seed=seed)
    return ops, jpack.general_decompress(ops.qweight, jc.bit,
                                         out_elems=jc.K)


def _u4_operands(seed=0):
    """JAX device operands and the port's, from one draw."""
    jc = JaxMatmulConfig(M=[512], **U4)
    ops, codes = _fields(jc, seed)
    jw = JaxMatmul(jc, enable_tuning=False).transform_weight(
        codes, scale=ops.scales, zeros=ops.zeros)
    pw = Matmul(MatmulConfig(M=[512], **U4), device="cpu").transform_weight(
        codes, scale=ops.scales, zeros=ops.zeros)
    return jc, jw, pw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_decode_u4_matches_jax_pallas(dtype):
    jc, (jW, jS, jZ), (pW, pS, pZ) = _u4_operands(1)
    spec = JaxKernelSpec.from_config(jc, 512)
    want = np.asarray(jmat.make_weight_decode_pallas(
        spec, dtype, interpret=True)(jW, jS, jZ), np.float32)   # [K, N]
    got = pmat.weight_decode_u4(pW, pS, pZ, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, K)
    assert np.array_equal(got.float().numpy().view(np.uint32),
                          np.ascontiguousarray(want.T).view(np.uint32))


def test_weight_decode_u4_f16_is_the_fused_tile():
    """float16 output: the fused kernel's decoded tile bit for bit, and
    the float32 value rounded once."""
    _, _, (pW, pS, pZ) = _u4_operands(2)
    got = pmat.weight_decode_u4(pW, pS, pZ)
    assert got.dtype == torch.float16
    assert torch.equal(got.view(torch.int16),
                       dequantize_hopper(pW, pS, pZ).view(torch.int16))
    f32 = pmat.weight_decode_u4(pW, pS, pZ, torch.float32)
    assert torch.equal(f32.half().view(torch.int16), got.view(torch.int16))


@pytest.mark.parametrize("w_dtype", ["int2", "uint2", "int4", "uint4"])
def test_weight_decode_int8_matches_jax_pallas(w_dtype):
    jc = JaxMatmulConfig(M=[512], N=N, K=K, A_dtype="int8", W_dtype=w_dtype,
                         accum_dtype="int32", out_dtype="float32")
    ops, fields = _fields(jc, 3)
    spec = JaxKernelSpec.from_config(jc, 512)
    jw = JaxMatmul(jc, enable_tuning=False)
    wp = jw.transform_weight(fields.astype(np.int8) - (1 << (jc.bit - 1))
                             if jc.source_format == "int" else fields)
    want = np.asarray(jmat.make_weight_decode_int8_pallas(
        spec, interpret=True)(wp))                               # [K, N]
    got = pmat.weight_decode_int8(ppack.pack_k(torch.from_numpy(fields),
                                               jc.bit),
                                  jc.bit, jc.source_format)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want[:, :N].T)


@pytest.fixture(scope="module")
def i2_pair():
    jc = JaxMatmulConfig(M=[1, 16, 256, 512], **I2)
    ops, fields = _fields(jc, 4)
    values = fields.astype(np.int8) - 2
    jm = JaxMatmul(jc, enable_tuning=False)
    pm = Matmul(MatmulConfig(M=[1, 16, 256, 512], **I2), device="cpu")
    return jc, jm, jm.transform_weight(values), pm, \
        pm.transform_weight(values)


@pytest.mark.parametrize("m", [1, 16, 256, 511, 512])
def test_matmul_int2_int8_matches_jax(i2_pair, m):
    jc, jm, jW, pm, pW = i2_pair
    A = np.random.default_rng(m).integers(-128, 128, (m, K)).astype(np.int8)
    want = np.asarray(jm.forward(jnp.asarray(A), jW))
    got = pm.forward(torch.from_numpy(A), pW)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    assert np.array_equal(got.numpy(), want)


def _route_hint(route):
    """The uint4 hint of a route: the fused kernel on its untuned tile at
    M = 512 (a compiled instance), or the materialize plan."""
    if route == "fused":
        return TileHint("fused", *default_tile("uint4", 512))
    return TileHint(decode_mode=route)


@pytest.mark.parametrize("route", ["fused", "materialize"])
def test_matmul_uint4_routes_match_jax_materialize(route):
    jc, (jW, jS, jZ), (pW, pS, pZ) = _u4_operands(5)
    A = np.random.default_rng(6).standard_normal((512, K)).astype(np.float16)
    spec = JaxKernelSpec.from_config(jc, 512)
    want = np.asarray(jmat.make_materialize_matmul(
        spec, MAT_F32, interpret=True)(jnp.asarray(A), jW, jS, jZ))
    pm = Matmul(MatmulConfig(M=[512], **U4), device="cpu")
    pm.apply_hints({512: _route_hint(route)})
    got = pm.forward(torch.from_numpy(A), pW, scale=pS, zeros=pZ)
    assert got.dtype == torch.float16 and got.shape == (512, N)
    assert_close(got, want, rtol=1e-2, atol=1.0, max_mismatched_ratio=0.0)


def test_matmul_uint4_routes_agree():
    _, _, (pW, pS, pZ) = _u4_operands(7)
    A = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (512, K)).astype(np.float16))
    cfg = MatmulConfig(M=[512], **U4)
    outs = []
    for r in ("fused", "materialize"):
        pm = Matmul(cfg, device="cpu")
        pm.apply_hints({512: _route_hint(r)})
        outs.append(pm.forward(A, pW, scale=pS, zeros=pZ))
    assert_close(outs[1], outs[0], rtol=0.0, atol=0.25,
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("fmt", ["uint4", "int2"])
@pytest.mark.parametrize("m", [511, 512])
def test_route_boundary(monkeypatch, fmt, m):
    """M = 511 takes the fused kernel, M = 512 the materialize plan."""
    calls = []
    for name in ("dequant_matmul_u4", "dequant_matmul_i2",
                 "materialize_matmul"):
        fn = getattr(pmm, name)
        monkeypatch.setattr(pmm, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    if fmt == "int2":
        pm = Matmul(MatmulConfig(**I2), device="cpu")
        W = pm.transform_weight(np.zeros((N, K), np.int8))
        pm.forward(torch.zeros((m, K), dtype=torch.int8), W)
    else:
        _, _, (pW, pS, pZ) = _u4_operands(9)
        pm = Matmul(MatmulConfig(**U4), device="cpu")
        pm.forward(torch.zeros((m, K), dtype=torch.float16), pW, scale=pS,
                   zeros=pZ)
    fused = "dequant_matmul_u4" if fmt == "uint4" else "dequant_matmul_i2"
    assert calls == ([fused] if m < 512 else ["materialize_matmul"])
    assert pm.hint_for(m).decode_mode == ("fused" if m < 512
                                          else "materialize")


@pytest.mark.parametrize("mode", ["mask", "telescope", "asplit"])
def test_tile_hint_rejects_unported_modes(mode):
    assert TileHint().decode_mode == "fused"
    with pytest.raises(NotImplementedError, match=mode):
        TileHint(decode_mode=mode)


@pytest.mark.parametrize("kw", [
    dict(A_dtype="int8", W_dtype="int2", accum_dtype="int32",
         out_dtype="float32"),
    dict(A_dtype="int8", W_dtype="uint4", accum_dtype="int32",
         out_dtype="float32"),
    dict(A_dtype="int8", W_dtype="int4", with_scaling=True,
         group_size=-1, out_dtype="float32"),
    dict(A_dtype="int8", W_dtype="int2", with_scaling=True,
         group_size=128, out_dtype="float32"),
    dict(**{k: v for k, v in U4.items() if k not in ("N", "K")}),
])
def test_supports_materialize_spec_matches_jax(kw):
    jc = JaxMatmulConfig(M=[512], N=N, K=K, **kw)
    js = JaxKernelSpec.from_config(jc, 512)
    ps = KernelSpec(**{f: getattr(js, f) for f in
                       KernelSpec.__dataclass_fields__})
    assert pmat.supports_materialize_spec(ps) == \
        jmat.supports_materialize_spec(js)


def test_w2a8_config_is_legal_and_legalized():
    cfg = MatmulConfig(**I2, group_size=None, with_scaling=None)
    jc = JaxMatmulConfig(**I2)
    assert (cfg.group_size, cfg.with_scaling, cfg.fast_decoding) == \
        (jc.group_size, jc.with_scaling, jc.fast_decoding) == (-1, False,
                                                              False)
    assert cfg.storage_dtype == "int32" and cfg.bit == 2
    assert Matmul(cfg, device="cpu").retrieve_weight_shape() == (N, K // 16)


@pytest.mark.parametrize("field,value", [
    ("group_size", 48), ("out_dtype", "bfloat16"), ("W_dtype", "nf4"),
    ("layout", "nn"), ("accum_dtype", "float16")])
def test_w2a8_config_rejects_what_is_not_ported(field, value):
    """One field away from BitNet's W2A8 configuration: the port raises the
    class JAX raises (a group that does not divide K, a quantized "nn"
    layout) and runs the rest against JAX's oracle, as JAX runs them."""
    kw = dict(I2, M=4, **{field: value})
    cls = jax_refusal(kw)
    if cls is not None:
        with pytest.raises(cls):
            MatmulConfig(**kw)
        return
    ops = operands(kw)
    got = port_forward(MatmulConfig(**kw), ops["A"], ops["qweight"])
    assert agrees(as_f64(got), oracle(kw, ops))


@pytest.mark.parametrize("bits", [2, 4])
def test_bias_signed_weight_matches_jax(bits):
    vals = np.arange(-(1 << bits), 1 << bits).astype(np.int8)
    got = ppack.bias_signed_weight(torch.from_numpy(vals), bits)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), jpack.bias_signed_weight(vals, bits))


@pytest.mark.parametrize("w_dtype", ["int2", "int4", "uint4"])
def test_decode_field_matches_jax_on_every_code(w_dtype):
    family, bits = w_dtype.rstrip("0123456789"), int(w_dtype[-1])
    codes = np.arange(1 << bits, dtype=np.uint8)
    want = np.asarray(jnum.decode_field(jnp.asarray(codes), family, bits,
                                        jnp.int8))
    got = pnum.decode_field(torch.from_numpy(codes), family, bits,
                            torch.int8)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(decode_i2_hopper(ppack.pack_k(
        torch.arange(16).reshape(1, 16) % 4, 2)).numpy()[0],
        np.arange(16) % 4 - 2)


def test_pack_k_2bit_layout():
    """Word [n, j] holds (n, 16j + i) at bits 2i; byte p holds k = 4p..4p+3."""
    rng = np.random.default_rng(10)
    fields = rng.integers(0, 4, (8, 64)).astype(np.uint8)
    qw = ppack.pack_k(torch.from_numpy(fields), 2)
    assert qw.dtype == torch.int32 and qw.shape == (8, 4)
    w = int(qw[3, 2]) & 0xFFFFFFFF
    assert [(w >> (2 * i)) & 3 for i in range(16)] == list(fields[3, 32:48])
    assert np.array_equal(ppack.unpack_k(qw, 2).numpy(), fields)
    # the reference packing along K agrees with the JAX package
    assert np.array_equal(ppack.general_compress(fields, 2),
                          jpack.general_compress(fields, 2))


def test_reference_operands_and_int_oracle_match_jax():
    jc, pc = JaxMatmulConfig(M=[8], **I2), MatmulConfig(M=[8], **I2)
    jo = jtesting.random_reference_operands(jc, 8, seed=12)
    po = ptesting.random_reference_operands(pc, 8, seed=12)
    assert np.array_equal(jo.A, po.A) and np.array_equal(jo.qweight,
                                                         po.qweight)
    want = np.asarray(jref.matmul_reference(jc, jnp.asarray(jo.A),
                                            jnp.asarray(jo.qweight)))
    got = pref.matmul_reference(pc, po.A, po.qweight)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    W = pref.dequantize_weight(pc, po.qweight)
    assert W.dtype == torch.int8
    assert np.array_equal(W.numpy(), np.asarray(jref.dequantize_weight(
        jc, jnp.asarray(jo.qweight))))


def test_i2_wrappers_reject_what_the_kernels_do_not_take(i2_pair):
    *_, pW = i2_pair
    A = torch.zeros((4, K), dtype=torch.int8)
    assert torch.equal(dequant_matmul_i2(A, pW),
                       dequant_matmul_i2_plain(A, pW))
    with pytest.raises(ValueError):
        dequant_matmul_i2(A.float(), pW)                         # dtype
    with pytest.raises(ValueError):
        dequant_matmul_i2(A[:, :256].contiguous(), pW)           # shape
    with pytest.raises(ValueError):
        dequant_matmul_i2(torch.zeros((4, 96), dtype=torch.int8),
                          torch.zeros((N, 6), dtype=torch.int32))  # K % 64
    with pytest.raises(ValueError):
        pmat.weight_decode_int8(pW, bits=3)
    with pytest.raises(ValueError):
        pmat.weight_decode_u4(pW, torch.zeros((4, N), dtype=torch.float16),
                              torch.zeros((4, N), dtype=torch.float16),
                              torch.int8)

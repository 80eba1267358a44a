"""bitblas_tpu_torch quantization against the JAX package, on the CPU.

Both packages get identical numpy inputs from one seed. uint4 decode must
be bit-exact against bitblas_tpu.ops.reference.dequantize_weight; packing
and the Hopper layout must round-trip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu import testing as jtesting
from bitblas_tpu.ops import reference as jref
from bitblas_tpu.ops import weight_transform as jwt
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.quantization import numerics as jnum
from bitblas_tpu.quantization import packing as jpack

from bitblas_tpu_torch import testing as ptesting
from bitblas_tpu_torch.kernels.dequant_matmul import dequantize_hopper
from bitblas_tpu_torch.ops import reference as pref
from bitblas_tpu_torch.ops import weight_transform as pwt
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig

from torch_jax_parity import agrees, as_f64, jax_refusal, operands, oracle, \
    port_forward
from bitblas_tpu_torch.quantization import numerics as pnum
from bitblas_tpu_torch.quantization import packing as ppack

CFG = dict(N=256, K=512, A_dtype="float16", W_dtype="uint4",
           with_scaling=True, with_zeros=True, zeros_mode="original",
           group_size=128, out_dtype="float16")


def _configs():
    return JaxMatmulConfig(M=[1, 16], **CFG), MatmulConfig(M=[1, 16], **CFG)


@pytest.mark.parametrize("seed", [0, 3])
def test_reference_operands_identical(seed):
    jc, pc = _configs()
    jo = jtesting.random_reference_operands(jc, 5, seed=seed)
    po = ptesting.random_reference_operands(pc, 5, seed=seed)
    for f in ("A", "qweight", "scales", "zeros"):
        assert np.array_equal(getattr(jo, f), getattr(po, f)), f


@pytest.mark.parametrize("seed", [0, 1])
def test_uint4_decode_bit_exact(seed):
    jc, pc = _configs()
    ops = jtesting.random_reference_operands(jc, 1, seed=seed)
    want = np.asarray(jref.dequantize_weight(
        jc, jnp.asarray(ops.qweight), jnp.asarray(ops.scales),
        jnp.asarray(ops.zeros)))
    got = pref.dequantize_weight(pc, ops.qweight, ops.scales,
                                 ops.zeros).numpy()
    assert got.dtype == np.float16
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    # the kernel's plain version decodes the Hopper layout to the same bits
    dw = pwt.transform_reference_operands(pc, ops.qweight, ops.scales,
                                          ops.zeros)
    hop = dequantize_hopper(dw.qweight, dw.scales, dw.zeros).numpy()
    assert np.array_equal(hop.view(np.uint16), want.view(np.uint16))


def test_fast_decode_magic_matches_plain_cast():
    codes = np.arange(16, dtype=np.uint8)
    got = pnum.fast_decode_uint_to_f16(torch.from_numpy(codes), 4).numpy()
    want = np.asarray(jnum.fast_decode_uint_to_f16(jnp.asarray(codes), 4))
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    assert np.array_equal(got, codes.astype(np.float16))


def test_unpack_fields_matches_jax():
    rng = np.random.default_rng(5)
    packed = rng.integers(-128, 128, (7, 12), dtype=np.int64).astype(np.int8)
    want = np.asarray(jnum.unpack_fields(jnp.asarray(packed), 4))
    got = pnum.unpack_fields(torch.from_numpy(packed), 4).numpy()
    assert np.array_equal(got, want.astype(np.int32))


def test_general_compress_roundtrip_matches_jax():
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 16, (64, 256), dtype=np.int64).astype(np.uint8)
    packed = ppack.general_compress(codes, 4)
    assert np.array_equal(packed, jpack.general_compress(codes, 4))
    assert np.array_equal(ppack.general_decompress(packed, 4), codes)


def test_hopper_layout_roundtrip():
    jc, pc = _configs()
    ops = jtesting.random_reference_operands(jc, 1, seed=2)
    qw = pwt.reference_weight_to_device(pc, ops.qweight)
    assert qw.dtype == torch.int32 and tuple(qw.shape) == (256, 64)
    assert np.array_equal(pwt.device_weight_to_reference(pc, qw),
                          ops.qweight)
    codes = ppack.general_decompress(ops.qweight, 4)
    assert np.array_equal(ppack.unpack_k(qw, 4).numpy(), codes)
    # word [n, j] holds (n, 8j + i) at bits 4i (packing.py invariant)
    w = int(qw[3, 5]) & 0xFFFFFFFF
    assert [(w >> (4 * i)) & 0xF for i in range(8)] == \
        list(codes[3, 40:48])
    s = pwt.scales_to_device(ops.scales)
    assert s.dtype == torch.float16 and tuple(s.shape) == (4, 256)
    assert np.array_equal(pwt.scales_from_device(s), ops.scales)


def test_unpack_nslot_reads_the_jax_device_layout():
    jc, _ = _configs()
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 16, (jc.N, jc.K), dtype=np.int64).astype(np.int8)
    dev = jwt.unpacked_weight_to_device(jc, codes)       # [K, N/2] xored
    plain = (dev.view(np.uint8) ^ 0x80).view(np.int8)
    tile = ppack.pack_tile_n(jc.N, 2)
    assert tile == jpack.pack_tile_n(jc.N, 2)
    got = ppack.unpack_nslot(plain, 4, tile)
    assert np.array_equal(got, jpack.unpack_nslot(plain, 4, tile))
    assert np.array_equal(got.T, codes.astype(np.uint8))


@pytest.mark.parametrize("field,value", [
    ("A_dtype", "uint8"), ("W_dtype", "int16"), ("group_size", 96),
    ("out_dtype", "int8"), ("with_scaling", False), ("layout", "nn")])
def test_config_rejects_what_is_not_ported(field, value):
    """One field away from GPTQ's W4A16 configuration: the port raises the
    class JAX raises (a quantized "nn" layout; zeros on the int16 weight)
    and runs the rest against JAX's oracle, as JAX runs them."""
    kw = dict(CFG, M=4, **{field: value})
    cls = jax_refusal(kw)
    if cls is not None:
        with pytest.raises(cls):
            MatmulConfig(**kw)
        return
    ops = operands(kw)
    got = port_forward(MatmulConfig(**kw), ops["A"], ops["qweight"],
                       ops["scales"], ops["zeros"], ops["qzeros"])
    assert agrees(as_f64(got), oracle(kw, ops))

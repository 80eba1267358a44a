"""The offline weight transforms against the JAX package, on the CPU:
QuantCompress and LOP3Permutate (forward and inverse) give JAX's bytes;
LadderPermutate's K-packed words (the port's device layout) decode to the
codes JAX's slot-strided TPU pack decodes to, bit for bit; its
NonTransform, propagate_kind="A" and >= 8-bit paths give JAX's output
outright. Inputs are numpy draws from one seed, every code of each width
present.
"""

import numpy as np
import pytest
import torch

from bitblas_tpu.ops.ladder_permutate import (
    LadderPermutate as JaxLadder, LadderPermutateConfig as JaxLadderConfig)
from bitblas_tpu.ops.lop3_permutate import (
    LOP3Permutate as JaxLOP3, LOP3PermutateConfig as JaxLOP3Config)
from bitblas_tpu.ops.quant_compress import (
    QuantCompress as JaxCompress, QuantCompressConfig as JaxCompressConfig)
from bitblas_tpu.quantization import packing as jpack

from bitblas_tpu_torch.ops.common import TransformKind
from bitblas_tpu_torch.ops.ladder_permutate import (LadderPermutate,
                                                    LadderPermutateConfig)
from bitblas_tpu_torch.ops.lop3_permutate import (LOP3Permutate,
                                                  LOP3PermutateConfig,
                                                  field_destinations)
from bitblas_tpu_torch.ops.quant_compress import (QuantCompress,
                                                  QuantCompressConfig)
from bitblas_tpu_torch.quantization import packing

M, N = 64, 256


def _codes(bits: int, seed: int, shape=(M, N)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, shape, dtype=np.int64).astype(np.int8)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_quant_compress_bytes_equal_jax(bits, as_tensor):
    codes = _codes(bits, bits)
    kw = dict(M=M, N=N, dequantize_bits=bits)
    op = QuantCompress(QuantCompressConfig(**kw), device="cpu")
    jop = JaxCompress(JaxCompressConfig(**kw))
    out = op(torch.from_numpy(codes) if as_tensor else codes)
    want = jop(codes)
    assert out.dtype == torch.int8 and tuple(out.shape) == want.shape
    np.testing.assert_array_equal(out.numpy(), want)
    assert op.retrieve_output_shape() == jop.retrieve_output_shape()
    with pytest.raises(ValueError):
        op(codes[:, :-8])


def _stored(bits: int, seed: int) -> np.ndarray:
    """Codes of `bits` packed as int8 storage [M, N*bits/8]."""
    return jpack.general_compress(_codes(bits, seed).astype(np.uint8), bits)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("datatype", ["float16", "int8"])
def test_lop3_forward_and_inverse_bytes_equal_jax(bits, datatype):
    w = _stored(bits, 10 + bits)
    kw = dict(M=M, N=N, datatype=datatype, dequantize_bits=bits)
    op = LOP3Permutate(LOP3PermutateConfig(**kw), device="cpu")
    jop = JaxLOP3(JaxLOP3Config(**kw))
    fwd, jfwd = op(w), jop(w)
    assert fwd.dtype == torch.int8 and tuple(fwd.shape) == w.shape
    np.testing.assert_array_equal(fwd.numpy(), jfwd)
    inv = op.inverse(fwd)
    np.testing.assert_array_equal(inv.numpy(), jop.inverse(jfwd))
    np.testing.assert_array_equal(inv.numpy(), w)
    # the inverse of any bytes, not only of an interleave's output
    np.testing.assert_array_equal(op.inverse(w).numpy(), jop.inverse(w))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("target", ["float16", "int8"])
def test_lop3_field_map_is_a_permutation(bits, target):
    dest = field_destinations(bits, target)
    assert sorted(dest) == list(range(32 // bits))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("transpose", [True, False])
def test_ladder_decodes_to_jax_codes(bits, transpose):
    codes = _codes(bits, 20 + bits)                    # [out, red]
    w = codes if transpose else np.ascontiguousarray(codes.T)
    kw = dict(M=M, N=N, dequantize_bits=bits, transpose_matrix=transpose)
    op = LadderPermutate(LadderPermutateConfig(**kw), device="cpu")
    jop = JaxLadder(JaxLadderConfig(**kw))
    out, jout = op(w), jop(w)
    # the port's words: [out, red*bits/32] int32, the Matmul layout
    assert out.dtype == torch.int32 and tuple(out.shape) == \
        (M, N * bits // 32)
    e = 8 // bits
    jcodes = jpack.unpack_nslot(jout, bits, jpack.pack_tile_n(M, e))
    np.testing.assert_array_equal(packing.unpack_k(out, bits).numpy(),
                                  jcodes.T)
    np.testing.assert_array_equal(packing.unpack_k(out, bits).numpy(),
                                  codes.astype(np.uint8))


@pytest.mark.parametrize("bits,dtype", [(8, np.int8), (8, np.uint8),
                                        (-1, np.float16), (16, np.int16)])
@pytest.mark.parametrize("storage", ["int8", "float16"])
def test_ladder_wide_paths_equal_jax(bits, dtype, storage):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((M, N)) * 15).astype(dtype)   # int8 range
    kw = dict(M=M, N=N, dequantize_bits=bits, storage_dtype=storage)
    out = LadderPermutate(LadderPermutateConfig(**kw), device="cpu")(w)
    want = JaxLadder(JaxLadderConfig(**kw))(w)
    assert str(out.dtype).split(".")[1] == want.dtype.name
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(transform_kind=TransformKind.NonTransform, dequantize_bits=4),
    dict(transform_kind=0, dequantize_bits=2),
    dict(propagate_kind="A", dequantize_bits=4),
    dict(propagate_kind="A", dequantize_bits=-1)])
def test_ladder_identity_paths_equal_jax(kw):
    w = _codes(4, 7)
    out = LadderPermutate(LadderPermutateConfig(M=M, N=N, **kw),
                          device="cpu")(w)
    want = JaxLadder(JaxLadderConfig(M=M, N=N, **kw))(w)
    np.testing.assert_array_equal(out.numpy(), want)


def test_configs_need_m_and_n():
    for cfg in (QuantCompressConfig, LOP3PermutateConfig,
                LadderPermutateConfig):
        with pytest.raises(ValueError):
            cfg(M=4)

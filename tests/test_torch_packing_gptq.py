"""bitblas_tpu_torch's GPTQ packing (quantization/packing.py torch ops) and
graph.repack_gptq_layer against the JAX package's numpy functions.

Every packing function is compared bit for bit (values and dtype) on
seeded inputs and on the committed AutoGPTQ golden
(tests/golden/gptq_golden_256x256_g64.npz); the repacked layer's decoded
weight is compared bit for bit with the JAX oracle's decode of the same
GPTQ tensors.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.graph import repack_gptq_layer as jax_repack_gptq_layer
from bitblas_tpu.ops import reference as jref
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.quantization import packing as jpack

from bitblas_tpu_torch.graph import (repack_gptq_checkpoint,
                                     repack_gptq_layer)
from bitblas_tpu_torch.kernels.dequant_matmul import dequantize_hopper
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.quantization import packing as ppack

GOLD = os.path.join(os.path.dirname(__file__), "golden",
                    "gptq_golden_256x256_g64.npz")


def _same(port: torch.Tensor, ref: np.ndarray) -> None:
    got = port.cpu().numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def _words(rng, shape):
    return rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
        np.int32)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_unpack_functions_match_jax(bits):
    rng = np.random.default_rng(bits)
    qw = _words(rng, (48, 24))
    _same(ppack.unpack_qweight(torch.from_numpy(qw.view(np.int8)), bits),
          jpack.unpack_qweight(qw.view(np.int8), bits))
    # an int32 tensor's bytes are read as the numpy view's
    _same(ppack.unpack_qweight(torch.from_numpy(qw), bits),
          jpack.unpack_qweight(qw.view(np.int8), bits))
    _same(ppack.unpack_qzeros(torch.from_numpy(qw), bits),
          jpack.unpack_qzeros(qw, bits))
    _same(ppack.unpack_qzeros_v2(torch.from_numpy(qw), bits),
          jpack.unpack_qzeros_v2(qw, bits))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_compress_decompress_match_jax(bits):
    rng = np.random.default_rng(10 + bits)
    codes = rng.integers(0, 1 << bits, (16, 128)).astype(np.int8)
    packed = jpack.general_compress(codes, bits)
    _same(ppack.compress(torch.from_numpy(codes), bits), packed)
    _same(ppack.decompress(torch.from_numpy(packed), bits),
          jpack.general_decompress(packed, bits))
    _same(ppack.decompress(torch.from_numpy(packed), bits, out_elems=100),
          jpack.general_decompress(packed, bits, out_elems=100))


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("target", ["float16", "int8"])
def test_interleave_weight_matches_jax(nbits, target):
    qw = _words(np.random.default_rng(nbits), (32, 16))
    _same(ppack.interleave_weight(torch.from_numpy(qw), nbits, target),
          jpack.interleave_weight(qw.copy(), nbits, target))


@pytest.mark.parametrize("bits,v2", [(4, False), (4, True), (2, False)])
def test_pack_autogptq_matches_jax_and_inverts(bits, v2):
    rng = np.random.default_rng(bits + 2 * v2)
    K, N, G = 256, 64, 64
    codes = rng.integers(0, 1 << bits, (K, N))
    zeros = rng.integers(0, 1 << bits, (K // G, N))
    scales = (rng.standard_normal((K // G, N)) * 0.01).astype(np.float16)
    ref = jpack.pack_autogptq(codes, zeros, scales, bits, v2=v2)
    got = ppack.pack_autogptq(torch.from_numpy(codes),
                              torch.from_numpy(zeros),
                              torch.from_numpy(scales), bits, v2=v2)
    for g, r in zip(got, ref):
        _same(g, r)
    unpack = ppack.unpack_qzeros_v2 if v2 else ppack.unpack_qzeros
    np.testing.assert_array_equal(unpack(got[1], bits).numpy(), zeros)
    back = ppack.unpack_qweight(got[0].T.contiguous(), bits)
    np.testing.assert_array_equal(back.numpy(), codes.T)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLD)


@pytest.mark.parametrize("layer", ["l1", "l2"])
def test_golden_unpacks_bit_identical(gold, layer):
    """The committed AutoGPTQ tensors unpack to the committed codes and
    zeros (v1 and v2), as JAX's functions unpack them."""
    qw = torch.from_numpy(gold[f"{layer}/qweight"])
    codes = ppack.unpack_qweight(qw.T.contiguous(), 4)
    np.testing.assert_array_equal(codes.numpy(),
                                  gold[f"{layer}/intweight"].T)
    _same(codes, jpack.unpack_qweight(np.ascontiguousarray(
        gold[f"{layer}/qweight"].T).view(np.int8), 4))
    for name, fn, jfn in (("qzeros", ppack.unpack_qzeros,
                           jpack.unpack_qzeros),
                          ("qzeros_v2", ppack.unpack_qzeros_v2,
                           jpack.unpack_qzeros_v2)):
        z = fn(torch.from_numpy(gold[f"{layer}/{name}"]), 4)
        np.testing.assert_array_equal(z.numpy(), gold[f"{layer}/zeros"])
        _same(z, jfn(gold[f"{layer}/{name}"], 4))


def _cfgs(mode, K=256, N=256, G=64, bias=False):
    kw = dict(N=N, K=K, A_dtype="float16", W_dtype="uint4", group_size=G,
              with_scaling=True, with_zeros=True, zeros_mode=mode,
              with_bias=bias, out_dtype="float16")
    return JaxMatmulConfig(M=(16,), **kw), MatmulConfig(M=(16,), **kw)


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("mode", ["original", "rescale", "quantized"])
def test_repack_gptq_layer_decodes_like_jax(gold, mode, v2):
    """graph.repack_gptq_layer on the golden: the decoded weight is the
    JAX oracle's decode of the same tensors, bit for bit (original and
    quantized: (q - z) s; rescale: q s - f16(z s))."""
    suffix = "_v2" if v2 else ""
    qw, qz = gold[f"l1/qweight{suffix}"], gold[f"l1/qzeros{suffix}"]
    sc = gold["l1/scales"]
    jc, pc = _cfgs(mode)
    bias = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    got = repack_gptq_layer(pc, torch.from_numpy(qw), torch.from_numpy(sc),
                            torch.from_numpy(qz), torch.from_numpy(bias),
                            gptq_v2=v2)
    pmode = "rescale" if mode == "rescale" else "original"
    W = dequantize_hopper(got["qweight"], got["scales"], got["zeros"], 64,
                          pmode)
    intz = gold["l1/zeros"]                              # [K/g, N]
    codes = gold["l1/intweight"].T                       # [N, K]
    if mode == "quantized":
        kw = dict(qzeros=jnp.asarray(jpack.general_compress(
            np.ascontiguousarray(intz), 4)))
    elif mode == "rescale":
        kw = dict(zeros=jnp.asarray(
            (intz * sc.astype(np.float32)).T.astype(np.float16)))
    else:
        kw = dict(zeros=jnp.asarray(intz.T.astype(np.float16)))
    ref = np.asarray(jref.dequantize_weight(
        jc, jnp.asarray(jpack.general_compress(codes, 4)),
        jnp.asarray(sc.T), **kw))
    _same(W, ref)
    np.testing.assert_array_equal(got["bias"].numpy(), bias[None])
    # JAX's own repack of the same tensors keeps the same scales and bias
    jp = jax_repack_gptq_layer(jc, qw, sc, qz, bias, gptq_v2=v2)
    np.testing.assert_array_equal(
        got["scales"].float().numpy(), np.asarray(jp["scales"])[:, 0, :])
    np.testing.assert_array_equal(got["bias"].numpy(),
                                  np.asarray(jp["bias"]))


def test_repack_gptq_checkpoint_matches_layerwise(gold):
    _, pc = _cfgs("original")
    layers = {li: (gold[f"{li}/qweight"], gold[f"{li}/scales"],
                   gold[f"{li}/qzeros"]) for li in ("l1", "l2")}
    packed = repack_gptq_checkpoint(layers, {"l1": pc, "l2": pc})
    for li, tensors in layers.items():
        one = repack_gptq_layer(pc, *tensors)
        for t in ("qweight", "scales", "zeros"):
            assert torch.equal(packed[li][t], one[t])
        # the Hopper words are the GPTQ words transposed, unpacked or not
        codes = ppack.unpack_qweight(
            torch.from_numpy(tensors[0]).T.contiguous(), 4)
        assert torch.equal(packed[li]["qweight"], ppack.pack_k(codes, 4))

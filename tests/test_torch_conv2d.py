"""Conv2D and QuantConv2D against the JAX package, on the CPU (shaped like
tests/test_matmul_operator.py:126-228; C = 128, so that the contraction
C*KH*KW is a multiple of 128, as the specialized kernels 1 and 2 take
it; and JAX's own C = 32 shapes, a contraction of 288, which the general
instance of kernels 1-3 takes, on both routes).

Tolerances:
- float16 outputs against JAX: rtol 2e-2, atol 0.2 (JAX's own for its
  routes). JAX's materialize route rounds x and the filter to bfloat16
  (its MXU type) and its fused kernel decodes to its mma type; the port
  keeps float16. The dense Conv2D sums the same float16 products in
  float32 on both sides: within one float16 ulp of each output (plus
  2^-18 of the largest, the float32 order), tighter than JAX's limit.
- The port's two routes share the float16 filter: one ulp apart (plus
  the same floor).
- int8 activations, materialize: the exact integer convolution times
  per-channel float16 scales in float32, bit for bit against JAX's same
  route; the dense int8 Conv2D's int32 sums bit for bit. The fused route
  sums scaled float32 products (kernel 1's plain version is JAX's oracle,
  A . (w s)) where JAX's interpret-mode kernel scales its own K blocks'
  sums: neither is the correctly rounded product, and they differ in
  ~10% of outputs by a float32 ulp or a few (near zero, where the sums
  cancel). Both are held to the float64 truth at rtol 1e-6 plus 1e-6 of
  the largest output, and to each other at twice that.
- `route="auto"` makes JAX's choice for every configuration below, and
  forcing materialize raises where JAX's raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.ops.conv2d import Conv2D as JaxConv2D
from bitblas_tpu.ops.conv2d import Conv2DConfig as JaxConv2DConfig
from bitblas_tpu.ops.conv2d import QuantConv2D as JaxQuantConv2D
from bitblas_tpu.ops.conv2d import QuantConv2DConfig as JaxQuantConv2DConfig

from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.kernels import materialize as mz
from bitblas_tpu_torch.ops.conv2d import (Conv2D, Conv2DConfig, QuantConv2D,
                                          QuantConv2DConfig, conv_patches)
from bitblas_tpu_torch.quantization import packing
from bitblas_tpu_torch.testing import assert_close, out_ulps

GEOMS = {   # (N, C, H, W, F, K, S, P, D)
    "3x3": (2, 128, 6, 6, 64, 3, 1, 1, 1),
    "1x1_s2": (2, 128, 7, 7, 32, 1, 2, 0, 1),
    "3x3_s2_d2": (1, 128, 9, 9, 32, 3, 2, 2, 2),
    # JAX's QuantConv2D shapes (tests/test_matmul_operator.py:137-228):
    # C = 32 under a 3 x 3 filter, K = 288
    "3x3_c32": (2, 32, 8, 8, 64, 3, 1, 1, 1),
    "3x3_c32_n1": (1, 32, 8, 8, 64, 3, 1, 1, 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geom(name):
    n, c, h, w, f, k, s, p, d = GEOMS[name]
    return dict(N=n, C=c, H=h, W=w, F=f, K=k, S=s, P=p, D=d)


def _x(g, seed, int8=False):
    rng = np.random.default_rng(seed)
    shape = (g["N"], g["H"], g["W"], g["C"])
    if int8:
        return rng.integers(-100, 100, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float16)


def _filter(g, bits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, (g["K"], g["K"], g["C"], g["F"]),
                        dtype=np.int64).astype(np.uint8)


def _scales(g, groups, seed):
    rng = np.random.default_rng(seed)
    # float16 values (the port keeps scales in float16)
    return (np.abs(rng.standard_normal((g["F"], groups))) * 0.1
            + 0.01).astype(np.float16)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_conv2d_patches_in_jax_order(name):
    g = _geom(name)
    x = _x(g, 1)
    cfg = Conv2DConfig(**g)
    got = conv_patches(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(g["K"], g["K"]),
        window_strides=(g["S"], g["S"]),
        padding=[(g["P"], g["P"])] * 2, rhs_dilation=(g["D"], g["D"]),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_dense_float16_matches_jax(name):
    g = _geom(name)
    x = _x(g, 2)
    w = np.random.default_rng(3).standard_normal(
        (g["K"], g["K"], g["C"], g["F"])).astype(np.float16)
    out = Conv2D(Conv2DConfig(**g), device="cpu")(x, w)
    want = np.asarray(JaxConv2D(JaxConv2DConfig(**g))(jnp.asarray(x),
                                                      jnp.asarray(w)))
    assert out.dtype == torch.float16 and tuple(out.shape) == want.shape
    assert_close(out, want.astype(np.float32), rtol=2e-2, atol=0.2)
    assert out_ulps(out, torch.from_numpy(want.copy())) <= 1.0


@pytest.mark.parametrize("out", ["int32", "float32"])
def test_dense_int8_bit_equal(out):
    g = _geom("3x3")
    x = _x(g, 4, int8=True)
    w = np.random.default_rng(5).integers(
        -128, 128, (g["K"], g["K"], g["C"], g["F"])).astype(np.int8)
    kw = dict(g, in_dtype="int8", out_dtype=out, accum_dtype="int32")
    got = Conv2D(Conv2DConfig(**kw), device="cpu")(x, w)
    want = np.asarray(JaxConv2D(JaxConv2DConfig(**kw))(jnp.asarray(x),
                                                       jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)


QUANT = {   # name -> (W_dtype, group_size, with_zeros)
    "u4_per_channel": ("uint4", -1, False),
    "u4_g128": ("uint4", 128, False),
    "u4_g128_zeros": ("uint4", 128, True),
    "u2_g128": ("uint2", 128, False),
}


def _quant_ops(g, qname, route, **extra):
    w_dtype, group, zeros = QUANT[qname]
    kw = dict(g, W_dtype=w_dtype, group_size=group, with_scaling=True,
              with_zeros=zeros, route=route, **extra)
    return (QuantConv2D(QuantConv2DConfig(**kw), device="cpu"),
            JaxQuantConv2D(JaxQuantConv2DConfig(**kw), enable_tuning=False))


def _quant_operands(g, qname, seed):
    w_dtype, group, zeros = QUANT[qname]
    bits = int(w_dtype[4:])
    kdim = g["C"] * g["K"] * g["K"]
    groups = 1 if group == -1 else kdim // group
    extra = {"scale": _scales(g, groups, seed)}
    if zeros:
        extra["zeros"] = np.random.default_rng(seed).integers(
            0, 1 << bits, (g["F"], groups)).astype(np.float16)
    return _filter(g, bits, seed), extra


def _forward(op, x, packed, names):
    args = packed if isinstance(packed, list) else [packed]
    return op.forward(x, args[0], **dict(zip(names, args[1:])))


@pytest.mark.parametrize("route", ["fused", "materialize"])
@pytest.mark.parametrize("qname", sorted(QUANT))
def test_quant_float16_matches_jax(qname, route):
    g = _geom("3x3")
    op, jop = _quant_ops(g, qname, route)
    assert op.route == jop.route == route
    w, extra = _quant_operands(g, qname, 6)
    x = _x(g, 7)
    got = _forward(op, torch.from_numpy(x), op.transform_weight(w, **extra),
                   list(extra))
    want = _forward(jop, jnp.asarray(x), jop.transform_weight(w, **extra),
                    list(extra))
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    assert_close(got, np.asarray(want, np.float32), rtol=2e-2, atol=0.2)


@pytest.mark.parametrize("name", ["1x1_s2", "3x3_s2_d2"])
def test_quant_routes_agree(name):
    g = _geom(name)
    op_m, jop_m = _quant_ops(g, "u4_g128", "materialize")
    op_f, _ = _quant_ops(g, "u4_g128", "fused")
    w, extra = _quant_operands(g, "u4_g128", 8)
    x = torch.from_numpy(_x(g, 9))
    packed = op_m.transform_weight(w, **extra)
    got_m = _forward(op_m, x, packed, list(extra))
    got_f = _forward(op_f, x, packed, list(extra))
    assert out_ulps(got_f, got_m) <= 1.0
    want = _forward(jop_m, jnp.asarray(x.numpy()),
                    jop_m.transform_weight(w, **extra), list(extra))
    assert_close(got_m, np.asarray(want, np.float32), rtol=2e-2, atol=0.2)


def test_transform_weight_flattens_channel_major():
    g = _geom("3x3")
    op, _ = _quant_ops(g, "u4_g128", "fused")
    w, extra = _quant_operands(g, "u4_g128", 10)
    W, S = op.transform_weight(w, **extra)
    flat = w.transpose(3, 2, 0, 1).reshape(g["F"], -1)
    np.testing.assert_array_equal(packing.unpack_k(W, 4).numpy(), flat)
    np.testing.assert_array_equal(S.numpy(), extra["scale"].T)


def test_bias_on_both_routes():
    """A bias adds in float32 on both of the port's routes (JAX's fused
    route drops it: its Matmul has no with_bias); held to JAX's
    materialize route."""
    g = _geom("3x3")
    op_m, jop_m = _quant_ops(g, "u4_per_channel", "materialize")
    op_f, _ = _quant_ops(g, "u4_per_channel", "fused")
    w, extra = _quant_operands(g, "u4_per_channel", 11)
    extra["bias"] = np.random.default_rng(12).standard_normal(
        g["F"]).astype(np.float32) * 4
    x = torch.from_numpy(_x(g, 13))
    packed = op_m.transform_weight(w, **extra)
    names = list(extra)
    got_m = _forward(op_m, x, packed, names)
    got_f = _forward(op_f, x, packed, names)
    assert out_ulps(got_f, got_m) <= 1.0
    want = _forward(jop_m, jnp.asarray(x.numpy()),
                    jop_m.transform_weight(w, **extra), names)
    assert_close(got_m, np.asarray(want, np.float32), rtol=2e-2, atol=0.2)


@pytest.mark.parametrize("route", ["fused", "materialize"])
@pytest.mark.parametrize("name", ["3x3", "1x1_s2"])
def test_int8_activations_bit_equal_to_jax(name, route):
    g = _geom(name)
    op, jop = _quant_ops(g, "u4_per_channel", route, in_dtype="int8",
                         accum_dtype="int32", out_dtype="float32")
    assert op.route == jop.route == route
    w, extra = _quant_operands(g, "u4_per_channel", 14)
    x = _x(g, 15, int8=True)
    got = _forward(op, x, op.transform_weight(w, **extra), list(extra))
    want = _forward(jop, jnp.asarray(x), jop.transform_weight(w, **extra),
                    list(extra))
    assert got.dtype == torch.float32
    if route == "materialize":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    patches = conv_patches(torch.from_numpy(x), op.config).numpy()
    flat = w.transpose(3, 2, 0, 1).reshape(g["F"], -1).astype(np.int64)
    truth = (patches.astype(np.int64) @ flat.T).astype(np.float64) \
        * extra["scale"].astype(np.float64).reshape(1, -1)
    truth = truth.reshape(got.shape)
    atol = 1e-6 * np.abs(truth).max()
    for out, limit in ((got, 1e-6), (np.asarray(want), 1e-6)):
        assert_close(out, truth, rtol=limit, atol=atol,
                     max_mismatched_ratio=0)
    assert_close(got, np.asarray(want), rtol=2e-6, atol=2 * atol,
                 max_mismatched_ratio=0)


def test_int8_routes_launch_their_decoders(monkeypatch):
    """The materialize route decodes the filter with kernel 3's wrapper,
    the fused one runs kernel 1's integer wrapper (their plain versions
    on the CPU)."""
    g = _geom("1x1_s2")
    calls = []
    for mod, fn in ((mz, "weight_decode_int8"), (dq, "dequant_matmul_int")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **k:
                            calls.append(_n) or _r(*a, **k))
    import bitblas_tpu_torch.ops.matmul as pmm
    monkeypatch.setattr(pmm, "dequant_matmul_int", dq.dequant_matmul_int)
    w, extra = _quant_operands(g, "u4_per_channel", 16)
    x = _x(g, 17, int8=True)
    for route, want in (("materialize", "weight_decode_int8"),
                        ("fused", "dequant_matmul_int")):
        op, _ = _quant_ops(g, "u4_per_channel", route, in_dtype="int8",
                           accum_dtype="int32", out_dtype="float32")
        calls.clear()
        _forward(op, x, op.transform_weight(w, **extra), list(extra))
        assert calls == [want], route


AUTO = [   # (in_dtype, W_dtype, group_size, with_scaling, with_zeros)
    ("float16", "uint4", -1, True, False),
    ("float16", "uint4", 128, True, True),
    ("float16", "int4", 128, True, False),
    ("float16", "nf4", 128, True, False),
    ("float16", "e4m3_float8", -1, True, False),
    ("bfloat16", "uint4", 128, True, False),
    ("int8", "uint4", -1, True, False),
    ("int8", "uint4", -1, False, False),
    ("int8", "int2", -1, False, False),
    ("int8", "uint4", 128, True, False),
    ("int8", "uint4", -1, True, True),
    ("int8", "uint2", 64, True, False),
]


@pytest.mark.parametrize("case", AUTO)
def test_auto_route_decides_as_jax(case):
    in_dtype, w_dtype, group, scaled, zeros = case
    out = "float32" if in_dtype == "int8" else in_dtype
    kw = dict(N=1, C=128, H=4, W=4, F=64, K=3, S=1, P=1, in_dtype=in_dtype,
              out_dtype=out, W_dtype=w_dtype, group_size=group,
              with_scaling=scaled, with_zeros=zeros,
              accum_dtype="int32" if in_dtype == "int8" else "float32")
    op = QuantConv2D(QuantConv2DConfig(**kw), device="cpu")
    jop = JaxQuantConv2D(JaxQuantConv2DConfig(**kw), enable_tuning=False)
    assert op.route == jop.route
    jax_raises = False
    try:
        JaxQuantConv2D(JaxQuantConv2DConfig(**kw, route="materialize"),
                       enable_tuning=False)
    except ValueError:
        jax_raises = True
    if jax_raises:
        with pytest.raises(ValueError):
            QuantConv2D(QuantConv2DConfig(**kw, route="materialize"),
                        device="cpu")
    else:
        assert QuantConv2D(QuantConv2DConfig(**kw, route="materialize"),
                           device="cpu").route == "materialize"
    assert jax_raises == (op.route == "fused")


def test_unknown_route_and_missing_scales():
    g = _geom("3x3")
    with pytest.raises(ValueError):
        QuantConv2D(QuantConv2DConfig(**g, route="im2col"), device="cpu")
    op, _ = _quant_ops(g, "u4_g128", "fused")
    w, extra = _quant_operands(g, "u4_g128", 1)
    W, _ = op.transform_weight(w, **extra)
    with pytest.raises(ValueError):
        op.forward(_x(g, 1), W)
    with pytest.raises(ValueError):
        op.forward(np.zeros((1, 5, 5, 128), np.float16), W,
                   scale=torch.ones(9, 64))


@pytest.mark.parametrize("route", ["fused", "materialize"])
def test_quant_c32_float16_matches_jax(route):
    """JAX's C = 32 QuantConv2D (uint4, per-channel scales, float16; its
    tests/test_matmul_operator.py:137-192) on both routes: the contraction
    K = 288 is off 128, so kernel 1's and kernel 2's general instance run
    it (their plain versions here), against JAX's same route."""
    g = _geom("3x3_c32")
    op, jop = _quant_ops(g, "u4_per_channel", route)
    assert op.route == jop.route == route
    assert dq.spec_format(op.spec) == "general"
    w, extra = _quant_operands(g, "u4_per_channel", 11)
    x = _x(g, 12)
    got = _forward(op, torch.from_numpy(x), op.transform_weight(w, **extra),
                   list(extra))
    want = _forward(jop, jnp.asarray(x), jop.transform_weight(w, **extra),
                    list(extra))
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    assert_close(got, np.asarray(want, np.float32), rtol=2e-2, atol=0.2)


@pytest.mark.parametrize("route", ["fused", "materialize"])
def test_quant_c32_int8_matches_jax(route):
    """JAX's C = 32 int8-activation QuantConv2D (uint4 per channel, scales
    float32, out float32; its tests/test_matmul_operator.py:195-220) on
    both routes against JAX's same route, at JAX's limits (rtol and atol
    1e-3)."""
    g = _geom("3x3_c32_n1")
    extra_kw = dict(in_dtype="int8", accum_dtype="int32",
                    out_dtype="float32")
    op, jop = _quant_ops(g, "u4_per_channel", route, **extra_kw)
    assert op.route == jop.route == route
    w, extra = _quant_operands(g, "u4_per_channel", 13)
    extra["scale"] = extra["scale"].astype(np.float32)
    x = _x(g, 14, int8=True)
    got = _forward(op, torch.from_numpy(x), op.transform_weight(w, **extra),
                   list(extra))
    want = _forward(jop, jnp.asarray(x), jop.transform_weight(w, **extra),
                    list(extra))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_close(got, np.asarray(want, np.float32), rtol=1e-3, atol=1e-3)

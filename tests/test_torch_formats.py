"""Kernels 1 and 2 for every weight format with float16 / bfloat16
activations (bitblas_tpu_torch dequant_matmul_fmt, weight_decode_fmt) on
the CPU, against the JAX package: the decoders of every code, the 1- and
8-bit packing, the legal configurations, the split-K arithmetic of the
decode instance against JAX's make_dequant_matmul (Pallas, interpret
mode), and module.Linear / QuantLinear(bits=1|2) against JAX's.

Tolerances. Decodes are bit for bit (NaN payloads aside: e5m2's NaN
codes must decode to NaN on both sides). The split plain version sums the
plain version's dense weight in another order, so against the JAX oracle
it is held to one rounding of the output type (rtol 2^-10 float16, 2^-7
bfloat16 relative, atol the same of the largest output, no element
outside). Against JAX's Pallas kernel, which decodes in float32 and
applies scales to its accumulator, each weight also carries the
rounding of A's type: rtol 1e-2 (float16) / 2e-2 (bfloat16), atol 2e-2
of the largest output. Linear and QuantLinear against JAX's: the same
kernel tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from bitblas_tpu import testing as jtesting
from bitblas_tpu.integration.pytorch import QuantLinear as JaxQuantLinear
from bitblas_tpu.module import Linear as JaxLinear
from bitblas_tpu.ops import reference as jref
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.quantization import numerics as jnum
from bitblas_tpu.quantization import packing as jpack

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.integration.pytorch import QuantLinear
from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.kernels import materialize as mz
from bitblas_tpu_torch.module import Linear
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops import weight_transform as wt
from bitblas_tpu_torch.ops.matmul_config import FLOAT_PAIRS, MatmulConfig
from bitblas_tpu_torch.quantization import numerics, packing
from bitblas_tpu_torch.testing import assert_close

FAMILIES = [("uint", 1), ("uint", 2), ("uint", 4), ("int", 1), ("int", 2),
            ("int", 4), ("nf", 4), ("fp", 4), ("fp_e4m3", 8),
            ("fp_e5m2", 8)]
DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SMS = 132


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


def _bits16(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _same_bits(got, want):
    """Bit-equal, NaN payloads aside (both NaN)."""
    g, w = _bits16(got), _bits16(want)
    nan = np.isnan(np.asarray(got.float())) & np.isnan(
        np.asarray(want, np.float32))
    np.testing.assert_array_equal(np.where(nan, 0, g), np.where(nan, 0, w))
    assert np.array_equal(np.isnan(np.asarray(got.float())),
                          np.isnan(np.asarray(want, np.float32)))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("family,bits", FAMILIES)
def test_every_code_decodes_as_jax(family, bits, dtype):
    pdt, jdt = DTYPES[dtype]
    codes = np.arange(1 << bits, dtype=np.int32)
    got = numerics.decode_field(torch.from_numpy(codes), family, bits, pdt)
    want = jnum.decode_field(jnp.asarray(codes).astype(jnp.uint16), family,
                             bits, jdt)
    _same_bits(got, want)
    # and through the stored-code entry the plain versions use
    _same_bits(numerics.decode_codes(torch.from_numpy(codes), family, bits,
                                     pdt), want)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_int8_codes_are_twos_complement(dtype):
    pdt, jdt = DTYPES[dtype]
    codes = np.arange(256, dtype=np.int32)
    got = numerics.decode_codes(torch.from_numpy(codes), "int", 8, pdt)
    want = jnp.asarray(codes.astype(np.uint8).view(np.int8)).astype(jdt)
    _same_bits(got, want)


@pytest.mark.parametrize("name,n", [
    ("decode_f8e4m3_to_bf16_fast", 256), ("decode_f8e5m2_to_bf16_fast", 256),
    ("decode_fp4_field_bf16_fast", 16), ("fast_decode_uint_to_bf16", 16)])
def test_bf16_fast_decoders_match_jax(name, n):
    codes = np.arange(n, dtype=np.int32)
    args = (4,) if name == "fast_decode_uint_to_bf16" else ()
    got = getattr(numerics, name)(torch.from_numpy(codes), *args)
    want = getattr(jnum, name)(jnp.asarray(codes), *args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


@pytest.mark.parametrize("bits", [1, 8])
def test_pack_k_round_trips(bits):
    rng = np.random.default_rng(bits)
    codes = torch.from_numpy(rng.integers(0, 1 << bits, (48, 256)))
    words = packing.pack_k(codes, bits)
    assert words.dtype == torch.int32 and tuple(words.shape) == (
        48, 256 * bits // 32)
    back = packing.unpack_k(words, bits)
    assert back.dtype == torch.uint8
    assert torch.equal(back.long(), codes)
    # the reference layout round trip through the device layout
    cfg = MatmulConfig(N=48, K=256, A_dtype="float16",
                       W_dtype="uint1" if bits == 1 else "int8")
    assert cfg.bit == bits
    ref = (jpack.general_compress(codes.numpy().astype(np.int8), 1)
           if bits == 1 else codes.numpy().astype(np.uint8).view(np.int8))
    dev = wt.reference_weight_to_device(cfg, ref)
    assert torch.equal(dev, words)
    np.testing.assert_array_equal(wt.device_weight_to_reference(cfg, dev),
                                  ref)


@pytest.mark.parametrize("a_dtype,w_dtype", FLOAT_PAIRS)
def test_config_legalizes_as_jax(a_dtype, w_dtype):
    base = dict(N=64, K=256, A_dtype=a_dtype, W_dtype=w_dtype,
                out_dtype=a_dtype)
    family = MatmulConfig(**base).source_format
    for kw in (dict(), dict(with_scaling=True, group_size=64),
               dict(with_scaling=True, group_size=-1, with_bias=True,
                    out_dtype="float32")):
        kw = dict(base, **kw)
        cfg, jc = MatmulConfig(**kw), JaxMatmulConfig(**kw)
        assert cfg.fast_decoding == jc.fast_decoding
        assert (cfg.bit, cfg.source_format) == (jc.bit, jc.source_format)
        assert cfg.storage_dtype == "int32"      # the Hopper layout
    zeros = dict(base, with_scaling=True, with_zeros=True, group_size=64)
    if family == "int":
        for cls in (MatmulConfig, JaxMatmulConfig):   # both refuse
            with pytest.raises(ValueError, match="zero point"):
                cls(**zeros)
    else:   # legal in both, every mode, with scales or without
        for mode in ("original", "rescale", "quantized"):
            for scaled in (True, False):
                kw = dict(zeros, zeros_mode=mode, with_scaling=scaled)
                JaxMatmulConfig(**kw)
                MatmulConfig(**kw)
    # JAX takes group 16 and an int8 output, and accum_dtype changes
    # nothing; a quantized "nn" layout is JAX's ValueError
    for ok in (dict(group_size=16, with_scaling=True),
               dict(out_dtype="int8"), dict(accum_dtype="float16")):
        JaxMatmulConfig(**dict(base, **ok))
        MatmulConfig(**dict(base, **ok))
    for cls in (MatmulConfig, JaxMatmulConfig):
        with pytest.raises(ValueError, match="layout"):
            cls(**dict(base, layout="nn"))


@pytest.mark.parametrize("a_dtype,w_dtype", [
    ("bfloat16", "int16"), ("int8", "uint8"), ("int8", "nf4"),
    ("float16", "int16"), ("e4m3_float8", "e5m2_float8")])
def test_outside_the_slice_is_refused_by_name(a_dtype, w_dtype):
    """Pairs the specialized kernels do not take (these were refused by
    name before the general instance): now they run, as in JAX, against
    JAX's oracle on the same operands."""
    kw = dict(M=4, N=64, K=256, A_dtype=a_dtype, W_dtype=w_dtype,
              out_dtype="float32")
    jc, cfg = JaxMatmulConfig(**kw), MatmulConfig(**kw)
    ops = jtesting.random_reference_operands(jc, 4, seed=0)
    want = np.asarray(jref.matmul_reference(
        jc, jnp.asarray(ops.A), jnp.asarray(ops.qweight)))
    op = Matmul(cfg, device="cpu", enable_tuning=False)
    if cfg.is_native_compute():
        got = op.forward(_torch_operand(ops.A),
                         op.transform_weight(_torch_operand(ops.qweight)))
    else:
        got = op.forward(_torch_operand(ops.A), wt.reference_weight_to_device(
            cfg, ops.qweight))
    assert_close(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max(),
                 max_mismatched_ratio=0.0)


def _torch_operand(a):
    """A numpy operand (ml_dtypes bfloat16 / float8 included) as torch."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    if str(a.dtype) in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            getattr(torch, str(a.dtype)))
    return torch.from_numpy(a.copy())


# One configuration of each family for JAX's Pallas kernel: scaled where
# JAX's transform_weight takes scales (not the sub-byte int family).
KERNEL_CASES = [("float16", "uint2", True), ("bfloat16", "int4", False),
                ("float16", "nf4", True), ("bfloat16", "fp4_e2m1", True),
                ("bfloat16", "e4m3_float8", False),
                ("float16", "e5m2_float8", False)]


def _operands(a_dtype, w_dtype, scaled, m, seed, K=512, N=256, group=128):
    kw = dict(N=N, K=K, A_dtype=a_dtype, W_dtype=w_dtype,
              with_scaling=scaled, group_size=group if scaled else -1,
              out_dtype="float32")
    jc, pc = JaxMatmulConfig(M=m, **kw), MatmulConfig(M=m, **kw)
    ref = jtesting.random_reference_operands(jc, m, seed=seed)
    return jc, pc, ref


def _act(a):
    """A JAX-side numpy activation as the port's tensor."""
    t = torch.from_numpy(np.asarray(a).astype(np.float32))
    return t.to(torch.bfloat16 if a.dtype == ml_dtypes.bfloat16
                else torch.float16)


@pytest.mark.parametrize("a_dtype,w_dtype,scaled", KERNEL_CASES)
def test_split_plain_matches_jax_kernel(a_dtype, w_dtype, scaled):
    m = 5
    jc, pc, ref = _operands(a_dtype, w_dtype, scaled, m, seed=3)
    dw = wt.transform_reference_operands(pc, ref.qweight, ref.scales)
    A = _act(ref.A)
    bits = pc.bit
    chunk, splits = dq.plan_splits_fmt(m, pc.N, pc.K, bits, SMS)
    assert splits == -(-pc.K // (512 // bits)) and chunk == 1
    got = dq.dequant_matmul_fmt_split_plain(
        A, dw.qweight, w_dtype, dw.scales, None, pc.effective_group_size,
        out_dtype=torch.float32, sms=SMS)
    oracle = np.asarray(jref.matmul_reference(
        jc, jnp.asarray(ref.A), jnp.asarray(ref.qweight),
        None if ref.scales is None else jnp.asarray(ref.scales)))
    top = float(np.abs(oracle).max())
    assert_close(got, oracle, rtol=2 ** -10, atol=2 ** -10 * top,
                 max_mismatched_ratio=0.0)
    jm = JaxMatmul(jc, enable_tuning=False)
    fields = (ref.qweight if bits == 8 else jpack.general_decompress(
        ref.qweight, bits, out_elems=jc.K))
    if pc.source_format == "int" and bits < 8:
        fields = fields.astype(np.int8) - (1 << (bits - 1))
    jw = jm.transform_weight(fields, scale=ref.scales) if scaled else \
        [jm.transform_weight(fields)]
    kernel = np.asarray(jm.forward(jnp.asarray(ref.A), *jw[:1],
                                   **({"scale": jw[1]} if scaled else {})))
    rtol = 1e-2 if a_dtype == "float16" else 2e-2
    assert_close(got, kernel, rtol=rtol, atol=2e-2 * top,
                 max_mismatched_ratio=0.0)
    # the single-pass plain version, and the wrapper on the CPU
    single = dq.dequant_matmul_fmt_plain(A, dw.qweight, w_dtype, dw.scales,
                                         None, pc.effective_group_size,
                                         out_dtype=torch.float32)
    assert_close(got, single, rtol=2 ** -20, atol=2 ** -20 * top,
                 max_mismatched_ratio=0.0)
    for tile in dq.FUSED_TILES[dq.fused_format(w_dtype, a_dtype)]:
        assert torch.equal(dq.dequant_matmul_fmt(
            A, dw.qweight, w_dtype, dw.scales, None,
            pc.effective_group_size, tile=tile, out_dtype=torch.float32),
            single)


@pytest.mark.parametrize("a_dtype,w_dtype", FLOAT_PAIRS)
def test_weight_decode_is_the_oracle_weight(a_dtype, w_dtype):
    """Kernel 2's plain version (and the fused kernels' decoded weight) is
    JAX's dequantize_weight bit for bit, unscaled and scaled (uint:
    with zeros in both modes)."""
    jc, pc, ref = _operands(a_dtype, w_dtype, True, 1, seed=9, K=256, N=64,
                            group=64)
    family = pc.source_format
    rng = np.random.default_rng(11)
    zeros = rng.integers(0, 1 << pc.bit, ref.scales.shape).astype(
        np.float32) if family == "uint" else None
    modes = ("original", "rescale") if family == "uint" else ("original",)
    _, jdt = DTYPES[a_dtype]
    for scaled in (False, True):
        for mode in modes:
            kw = dict(N=64, K=256, A_dtype=a_dtype, W_dtype=w_dtype,
                      out_dtype=a_dtype,
                      with_scaling=scaled, group_size=64 if scaled else -1,
                      with_zeros=scaled and zeros is not None,
                      zeros_mode=mode)
            jcfg, pcfg = JaxMatmulConfig(**kw), MatmulConfig(**kw)
            dw = wt.transform_reference_operands(
                pcfg, ref.qweight, ref.scales if scaled else None,
                zeros if pcfg.with_zeros else None)
            got = mz.weight_decode_fmt(dw.qweight, w_dtype, a_dtype,
                                       dw.scales, dw.zeros,
                                       pcfg.effective_group_size, mode)
            want = jref.dequantize_weight(
                jcfg, jnp.asarray(ref.qweight),
                jnp.asarray(ref.scales) if scaled else None,
                jnp.asarray(zeros) if pcfg.with_zeros else None)
            assert got.dtype == DTYPES[a_dtype][0]
            _same_bits(got, jnp.asarray(want, jdt))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("a_dtype,w_dtype,group,zeros_mode", [
    ("float16", "uint2", 32, "original"), ("bfloat16", "uint1", 128,
                                           "rescale"),
    ("bfloat16", "nf4", -1, None), ("float16", "int8", None, None)])
def test_linear_matches_jax(a_dtype, w_dtype, group, zeros_mode, bias):
    """module.Linear against JAX's Linear (Pallas, interpret mode) on the
    same codes, scales, zeros and bias."""
    IN = OUT = 256
    scaled = group is not None
    zeros = zeros_mode is not None
    kw = dict(in_features=IN, out_features=OUT, bias=bias, A_dtype=a_dtype,
              W_dtype=w_dtype, out_dtype=a_dtype,
              group_size=group if scaled else -1, with_scaling=scaled,
              with_zeros=zeros, zeros_mode=zeros_mode, opt_M=[1, 16],
              enable_tuning=False)
    jl, pl = JaxLinear(**kw), Linear(device="cpu", **kw)
    rng = np.random.default_rng(5)
    g = IN if group in (-1, None) else group
    bits = pl.bits
    codes = rng.integers(0, 1 << bits, (OUT, IN))
    if w_dtype == "int8":
        codes = codes.astype(np.uint8).view(np.int8)
    sc = rng.uniform(0.01, 0.03, (OUT, IN // g)).astype(np.float32) \
        if scaled else None
    zr = (rng.integers(0, 1 << bits, (OUT, IN // g)).astype(np.float32)
          * (sc if zeros_mode == "rescale" else 1.0)) if zeros else None
    b = rng.standard_normal(OUT).astype(np.float32) if bias else None
    jl.load_and_transform_weight(codes, scales=sc, zeros=zr, bias=b)
    pl.load_and_transform_weight(torch.from_numpy(codes), scales=sc,
                                 zeros=zr, bias=b)
    if scaled:
        assert pl.scales.dtype == DTYPES[a_dtype][0]
    x = rng.standard_normal((3, IN)).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[a_dtype][1])
    want = np.asarray(jl(jx), np.float32)
    got = pl(torch.from_numpy(x).to(DTYPES[a_dtype][0]))
    assert got.dtype == DTYPES[a_dtype][0] and got.shape == (3, OUT)
    top = float(np.abs(want).max())
    rtol = 1e-2 if a_dtype == "float16" else 2e-2
    assert_close(got, want, rtol=rtol, atol=2e-2 * top,
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("bits", [1, 2])
def test_quantlinear_low_bits_match_jax(bits):
    """QuantLinear(bits=1|2) pack() and forward against JAX's, g = 64."""
    IN = OUT = 256
    rng = np.random.default_rng(bits)
    g = 64
    scales = rng.uniform(0.01, 0.05, (OUT, IN // g)).astype(np.float32)
    zeros = rng.integers(0, 1 << bits, (OUT, IN // g)).astype(np.float32)
    codes = rng.integers(0, 1 << bits, (OUT, IN)).astype(np.float32)
    gi = np.arange(IN) // g
    lin = torch.nn.Linear(IN, OUT, bias=True)
    lin.weight.data = torch.from_numpy((codes - zeros[:, gi]) * scales[:, gi])
    lin.bias.data = torch.from_numpy(rng.standard_normal(OUT).astype(
        np.float32) * 0.1)
    kw = dict(bits=bits, group_size=g, in_features=IN, out_features=OUT,
              bias=True, enable_tuning=False)
    jq, pq = JaxQuantLinear(**kw), QuantLinear(device="cpu", **kw)
    jq.pack(lin, torch.from_numpy(scales), torch.from_numpy(zeros))
    pq.pack(lin, torch.from_numpy(scales), torch.from_numpy(zeros))
    for name in ("qweight", "scales", "zeros", "bias"):
        assert torch.equal(getattr(pq, name), getattr(jq, name)), name
    np.testing.assert_array_equal(
        packing.unpack_qweight(pq.qweight, bits).numpy(),
        codes.astype(np.int8))
    x = torch.from_numpy(rng.standard_normal((2, 3, IN)).astype(np.float32))
    want = jq(x)
    got = pq(x)
    assert got.dtype == x.dtype and got.shape == (2, 3, OUT)
    top = float(want.abs().max())
    assert_close(got, want, rtol=1e-2, atol=2e-2 * top,
                 max_mismatched_ratio=0.0)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    A = torch.zeros((4, 256), dtype=torch.float16)
    qw = torch.zeros((64, 256 * 2 // 32), dtype=torch.int32)
    s = torch.ones((2, 64), dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="group size 16"):
        dq.dequant_matmul_fmt(A, qw, "uint2", torch.ones(
            (16, 64), dtype=torch.float16), group=16)
    with pytest.raises(NotImplementedError, match="zeros"):
        dq.dequant_matmul_fmt(A, torch.zeros((64, 32), dtype=torch.int32),
                              "nf4", s, s, group=128)
    with pytest.raises(NotImplementedError, match="uint8 x bfloat16"):
        dq.dequant_matmul_fmt(A.bfloat16(), torch.zeros(
            (64, 64), dtype=torch.int32), "uint8")
    with pytest.raises(ValueError, match="scales"):
        dq.dequant_matmul_fmt(A, qw, "uint2", s.float(), group=128)
    with pytest.raises(ValueError, match="out_dtype"):
        dq.dequant_matmul_fmt(A, qw, "uint2", out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        dq.dequant_matmul_fmt(A[:, :192], qw[:, :12], "uint2")
    with pytest.raises(ValueError, match="not compiled"):
        dq.dequant_matmul_fmt(A, qw, "uint2", tile=(64, 128, 256, 4))


@pytest.mark.parametrize("w_dtype,torch_name,np_name", [
    ("e4m3_float8", "float8_e4m3fn", "float8_e4m3fn"),
    ("e5m2_float8", "float8_e5m2", "float8_e5m2")])
def test_fp8_weight_loads_as_its_bytes(w_dtype, torch_name, np_name):
    """An fp8 weight given as its bytes, as a float8 tensor or as an
    ml_dtypes array packs to the same codes (JAX's transform_weight views
    fp8 as bytes)."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    kw = dict(in_features=256, out_features=128, A_dtype="bfloat16",
              W_dtype=w_dtype, out_dtype="bfloat16", opt_M=[1],
              enable_tuning=False, device="cpu")
    packed = []
    for weight in (torch.from_numpy(codes),
                   torch.from_numpy(codes).view(getattr(torch, torch_name)),
                   codes.view(getattr(ml_dtypes, np_name))):
        lin = Linear(**kw)
        lin.load_and_transform_weight(weight)
        packed.append(lin.qweight)
    assert all(torch.equal(p, packed[0]) for p in packed)
    assert torch.equal(packing.unpack_k(packed[0], 8),
                       torch.from_numpy(codes))

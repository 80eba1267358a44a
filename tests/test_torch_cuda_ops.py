"""The operator surface on the card: Conv2D, QuantConv2D (both routes,
float16 and int8 activations), BatchMatmul, MatmulWithSplitK, the
permutes and the chained timer, each against its plain PyTorch version on
the card, with the kernel launches each route must make.

Every test needs an NVIDIA GPU with nvcc and skips elsewhere. Run on the
card with ``python -m pytest --noconftest -q tests/test_torch_cuda_ops.py``
(the suite's conftest imports JAX, which the GPU host need not have).
Limits as chip_smoke.py's ops phase states them: a cuDNN float16
convolution within two float16 ulps of the float32 convolution, kernel 1
within one of its plain version, integer routes bit for bit.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from bitblas_tpu_torch import (BatchMatmul, BatchMatmulConfig, Conv2D,
                               Conv2DConfig, LadderPermutate,
                               LadderPermutateConfig, LOP3Permutate,
                               LOP3PermutateConfig, MatmulConfigWithSplitK,
                               MatmulWithSplitK, QuantCompress,
                               QuantCompressConfig, QuantConv2D,
                               QuantConv2DConfig)
from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.kernels import materialize as mz
from bitblas_tpu_torch.kernels.dense import full_f32
from bitblas_tpu_torch.ops.batch_matmul import batch_matmul_plain
from bitblas_tpu_torch.ops.conv2d import conv_patches
from bitblas_tpu_torch.testing import out_ulps
from bitblas_tpu_torch.utils.timing import (make_chained, measure_chained,
                                            measure_kernel)

pytestmark = pytest.mark.cuda

GEOM = dict(N=2, C=128, H=8, W=8, F=64, K=3, S=1, P=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """Each element's float16 ulp (at least the smallest normal's)."""
    e = torch.frexp(t.double().abs().clamp_min(2.0 ** -14))[1] - 1
    return torch.exp2(e.double() - 10)


def _conv_plain(x, w_oihw, c, bias=None):
    with full_f32():
        out = F.conv2d(x.permute(0, 3, 1, 2).float(), w_oihw.float(),
                       stride=c.S, padding=c.P, dilation=c.D)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).float()
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("geom", [GEOM, dict(GEOM, K=1, S=2, P=0),
                                  dict(GEOM, S=2, P=2, D=2)])
def test_conv2d_dense(dev, geom):
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cfg = Conv2DConfig(**geom)
    x = torch.randn((2, 8, 8, 128), generator=g, device=dev).half()
    w = (torch.randn((geom["K"], geom["K"], 128, 64), generator=g,
                     device=dev) / 30).half()
    out = Conv2D(cfg)(x, w)
    ref = _conv_plain(x, w.permute(3, 2, 0, 1), cfg).half()
    assert out.shape == ref.shape and out.is_contiguous()
    assert out_ulps(out, ref) <= 2.0
    xi = torch.randint(-128, 128, x.shape, generator=g, device=dev,
                       dtype=torch.int8)
    wi = torch.randint(-128, 128, w.shape, generator=g, device=dev,
                       dtype=torch.int8)
    cfg_i = Conv2DConfig(**geom, in_dtype="int8", out_dtype="int32",
                         accum_dtype="int32")
    got = Conv2D(cfg_i)(xi, wi)
    exact = conv_patches(xi, cfg_i).double() @ \
        wi.permute(3, 2, 0, 1).reshape(64, -1).double().T
    assert torch.equal(got.reshape(-1, 64), exact.to(torch.int32))


@pytest.mark.parametrize("route", ["materialize", "fused"])
def test_quant_conv2d_float16(dev, route):
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    op = QuantConv2D(QuantConv2DConfig(**GEOM, W_dtype="uint4",
                                       group_size=128, route=route))
    kdim = 128 * 9
    codes = torch.randint(0, 16, (3, 3, 128, 64), generator=g, device=dev,
                          dtype=torch.uint8)
    scale = (torch.rand((64, kdim // 128), generator=g, device=dev) * 0.01
             + 0.005).half()
    bias = torch.randn(64, generator=g, device=dev)
    W, S, B = op.transform_weight(codes, scale=scale, bias=bias)
    x = torch.randn((2, 8, 8, 128), generator=g, device=dev).half()
    k1, k2 = dq.dequant_matmul_fmt.launches, mz.weight_decode_fmt.launches
    out = op(x, W, scale=S, bias=B)
    torch.cuda.synchronize()
    launched = (dq.dequant_matmul_fmt.launches - k1,
                mz.weight_decode_fmt.launches - k2)
    assert launched == ((0, 1) if route == "materialize" else (1, 0))
    wplain = mz.weight_decode_fmt_plain(W, "uint4", "float16", S, None, 128)
    if route == "fused":
        ref = dq.dequant_matmul_fmt_plain(
            conv_patches(x, op.config).contiguous(), W, "uint4", S, None,
            128, bias=B)
        assert out_ulps(out.reshape(-1, 64), ref) <= 1.0
        return
    assert torch.equal(mz.weight_decode_fmt(W, "uint4", "float16", S, None,
                                            128), wplain)
    w_oihw = wplain.reshape(64, 128, 3, 3)
    ref = _conv_plain(x, w_oihw, op.config, B).half()
    # two roundings, the convolution's and the biased output's: in units of
    # one ulp of each, at most 2 (chip_smoke.OPS_MATERIALIZE_RATIO)
    unit = _ulp(_conv_plain(x, w_oihw, op.config).half()) + _ulp(ref) \
        + 2.0 ** -18 * ref.double().abs().max()
    assert bool(((out.double() - ref.double()).abs() <= 2 * unit).all())


@pytest.mark.parametrize("route", ["materialize", "fused"])
def test_quant_conv2d_int8(dev, route):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    op = QuantConv2D(QuantConv2DConfig(
        **GEOM, W_dtype="uint4", group_size=-1, in_dtype="int8",
        accum_dtype="int32", out_dtype="float32", route=route))
    codes = torch.randint(0, 16, (3, 3, 128, 64), generator=g, device=dev,
                          dtype=torch.uint8)
    scale = (torch.rand((64, 1), generator=g, device=dev) * 0.01
             + 0.005).half()
    W, S = op.transform_weight(codes, scale=scale)
    x = torch.randint(-64, 64, (2, 8, 8, 128), generator=g, device=dev,
                      dtype=torch.int8)
    k1, k3 = dq.dequant_matmul_int.launches, mz.weight_decode_int8.launches
    out = op(x, W, scale=S).reshape(-1, 64)
    torch.cuda.synchronize()
    launched = (dq.dequant_matmul_int.launches - k1,
                mz.weight_decode_int8.launches - k3)
    assert launched == ((0, 1) if route == "materialize" else (1, 0))
    codes_nk = mz.weight_decode_int8_plain(W, 4, "uint")
    exact = conv_patches(x, op.config).double() @ codes_nk.double().T
    if route == "materialize":
        assert torch.equal(out, exact.float() * S.reshape(1, -1).float())
        return
    truth = exact * S.reshape(1, -1).double()
    ref = dq.dequant_matmul_int_plain(conv_patches(x, op.config), W,
                                      "uint4", S, None, -1)
    err = (out.double() - truth).abs().max().item()
    assert out_ulps(out, ref) <= 1.0 or \
        err <= (ref.double() - truth).abs().max().item()


@pytest.mark.parametrize("layout", ["nt", "nn"])
def test_batch_matmul(dev, layout):
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    B, M, N, K = 4, 96, 80, 64
    wshape = (B, N, K) if layout == "nt" else (B, K, N)
    for dtype, out in (("float16", "float16"), ("int8", "int32"),
                       ("float16", "float32")):
        op = BatchMatmul(BatchMatmulConfig(
            Batch=B, M=M, N=N, K=K, A_dtype=dtype, W_dtype=dtype,
            out_dtype=out, layout=layout))
        if dtype == "int8":
            a = torch.randint(-128, 128, (B, M, K), generator=g, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-128, 128, wshape, generator=g, device=dev,
                              dtype=torch.int8)
        else:
            a = torch.randn((B, M, K), generator=g, device=dev).half()
            w = torch.randn(wshape, generator=g, device=dev).half()
        got = op(a, w)
        ref = batch_matmul_plain(a, w, layout, got.dtype)
        if dtype == "int8":
            assert torch.equal(got, ref)
        else:
            assert out_ulps(got, ref) <= 1.0


@pytest.mark.parametrize("k_split", [2, 4])
@pytest.mark.parametrize("M", [1, 16, 40])
def test_matmul_splitk(dev, k_split, M):
    g = torch.Generator(device=dev)
    g.manual_seed(5 + M)
    N, K = 512, 2048
    op = MatmulWithSplitK(MatmulConfigWithSplitK(
        M=(1, 16, 64), N=N, K=K, A_dtype="float16", W_dtype="uint4",
        with_scaling=True, with_zeros=True, group_size=128,
        k_split=k_split), enable_tuning=False)
    codes = torch.randint(0, 16, (N, K), generator=g, device=dev,
                          dtype=torch.uint8)
    scales = (torch.rand((N, K // 128), generator=g, device=dev) * 0.01
              + 0.005).half()
    zeros = torch.randint(0, 16, (N, K // 128), generator=g,
                          device=dev).half()
    W, S, Z = op.transform_weight(codes, scale=scales, zeros=zeros)
    A = torch.randn((M, K), generator=g, device=dev).half()
    before = dq.dequant_matmul_u4.launches
    got = op(A, W, scale=S, zeros=Z)
    torch.cuda.synchronize()
    assert dq.dequant_matmul_u4.launches == before + k_split
    kk, gk = K // k_split, K // k_split // 128
    plain = (dq.dequant_matmul_u4_split_plain if M <= 16
             else dq.dequant_matmul_u4_plain)
    parts = [plain(A[:, s * kk:(s + 1) * kk].contiguous(), W[s],
                   S[s * gk:(s + 1) * gk], Z[s * gk:(s + 1) * gk])
             for s in range(k_split)]
    ref = sum(p.float() for p in parts).half()
    # each shard within one f16 ulp of its plain version (plus 2^-18 of the
    # largest output), then one rounding of the sum
    limit = sum(_ulp(p) for p in parts) + _ulp(ref) \
        + (k_split + 1) * 2.0 ** -18 * ref.double().abs().max()
    assert bool(((got.double() - ref.double()).abs() <= limit).all())


def test_permutes_match_cpu(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    M, N = 256, 1024
    codes = torch.randint(0, 16, (M, N), generator=g, device=dev,
                          dtype=torch.int8)
    for make in (
            lambda d: QuantCompress(QuantCompressConfig(M=M, N=N), device=d),
            lambda d: LadderPermutate(LadderPermutateConfig(
                M=M, N=N, dequantize_bits=4), device=d)):
        assert torch.equal(make("cuda")(codes).cpu(), make("cpu")(
            codes.cpu()))
    packed = QuantCompress(QuantCompressConfig(M=M, N=N))(codes)
    lop3 = LOP3Permutate(LOP3PermutateConfig(M=M, N=N))
    fwd = lop3(packed)
    assert torch.equal(fwd.cpu(), LOP3Permutate(LOP3PermutateConfig(
        M=M, N=N), device="cpu")(packed.cpu()))
    assert torch.equal(lop3.inverse(fwd), packed)


def test_chained_timer(dev):
    a = torch.randn((2048, 2048), device=dev).half()
    calls = []

    def fn():
        calls.append(1)
        return a @ a

    chained = make_chained(fn, ())
    chained(5)
    assert len(calls) == 5
    per_call = measure_chained(chained)
    single = measure_kernel(fn, (), flush=False)
    assert math.isfinite(per_call) and per_call > 0
    # back to back and one at a time time the same product
    assert 0.25 * single <= per_call <= 4 * single

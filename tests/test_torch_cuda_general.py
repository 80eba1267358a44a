"""The general instances of kernels 1-3 (csrc/dequant_general.cu) and the
native dense route's new pairs, on the card, against their plain PyTorch
versions.

CUDA kernels have no interpret mode: every test here needs an NVIDIA GPU
with nvcc and skips elsewhere. Run on the card with ``python -m pytest
--noconftest -q tests/test_torch_cuda_general.py``.

* kernel 2 / 3's general instance decodes bit for bit as its plain
  version (`decode_general`), NaN for NaN, for every weight format into
  every decode type, every code of the 8-bit formats, with scales and
  zeros in each mode and K off every word boundary;
* kernel 1's general instance: integer outputs equal, float outputs within
  one ulp of the output type plus 2^-17 of the largest output (the sums
  run in another order), NaN and inf where the plain version has them;
* the native route (kernels/dense.native_product) against its CPU form
  (and every code of both fp8 operands read back through one-hot rows):
  uint8 x uint8 exact; float64, float16 / bfloat16 into float32 (kernel
  9) and the fp8 pairs (an exact float16 upcast into kernel 9) within
  `close`'s limit; cuBLASLt's fp8 product (`torch._scaled_mm`, not used
  by the port) within 2^-8 of the largest output, which it needs;
* a general configuration through Matmul on both routes (fused below M =
  512, the materialize plan from it) within the same limit of the CPU's.
"""

import pytest
import torch

from bitblas_tpu_torch.kernels import dense as pdense
from bitblas_tpu_torch.kernels.general import (
    GENERAL_TILE, UNIT_CODE, decode_general, dequant_matmul_general,
    dequant_matmul_general_plain, general_unit, weight_decode_general)
from bitblas_tpu_torch.ops.reference import sums_type
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.quantization import numerics, packing
from bitblas_tpu_torch.quantization.formats import (INT_TYPES, TORCH_DTYPES,
                                                    source_format_and_bits)

pytestmark = pytest.mark.cuda

WEIGHTS = ("uint1", "uint2", "uint4", "uint8", "int1", "int2", "int4",
           "int8", "nf4", "fp4_e2m1", "e4m3_float8", "e5m2_float8",
           "int16", "uint16", "int32", "uint32")
DECODES = ("float16", "bfloat16", "float32", "float64", "e4m3_float8",
           "int8", "uint8", "int4", "uint16", "int32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def weight(w_dtype, N, K, gen, device):
    """Random Hopper-layout words of a `w_dtype` weight (every code)."""
    bits = source_format_and_bits(w_dtype)[1]
    if bits > 8:
        return torch.randint(-2 ** (bits - 1), 2 ** (bits - 1), (N, K),
                             generator=gen, device=device,
                             dtype=torch.int64).to(TORCH_DTYPES[f"int{bits}"])
    codes = torch.randint(0, 1 << bits, (N, K), generator=gen, device=device)
    return packing.pack_k(codes, bits)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN."""
    a = numerics.to_float(a.cpu()).double()
    b = numerics.to_float(b.cpu()).double()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


# mantissa bits (with the implicit one) of each float output type
MANTISSA = {"float16": 11, "bfloat16": 8, "float32": 24, "float64": 53,
            "e4m3_float8": 4, "e5m2_float8": 3}


def close(got: torch.Tensor, want: torch.Tensor, out: str) -> bool:
    """Integer outputs equal; float outputs within one ulp of `out` at
    each value plus 2^-17 of the largest, NaN and inf where `want` has
    them."""
    if out in INT_TYPES:
        return torch.equal(got.cpu(), want.cpu())
    g = numerics.to_float(got.cpu()).double()
    w = numerics.to_float(want.cpu()).double()
    fin = torch.isfinite(w)
    if not (torch.equal(fin, torch.isfinite(g))
            and torch.equal(torch.isnan(w), torch.isnan(g))
            and torch.equal(g[torch.isinf(w)], w[torch.isinf(w)])):
        return False
    if not fin.any():
        return True
    top = float(w[fin].abs().max())
    ulp = torch.ldexp(torch.ones_like(w[fin]),
                      torch.frexp(w[fin])[1] - MANTISSA[out])
    return bool(((g[fin] - w[fin]).abs() <= ulp + top * 2 ** -17).all())


@pytest.mark.parametrize("w_dtype", WEIGHTS)
@pytest.mark.parametrize("decode", DECODES)
def test_weight_decode_general_matches_plain(dev, w_dtype, decode):
    g = torch.Generator(device=dev)
    g.manual_seed(WEIGHTS.index(w_dtype) * 100 + DECODES.index(decode))
    N, K = 40, 100
    qw = weight(w_dtype, N, K, g, dev)
    got = weight_decode_general(qw, w_dtype, K, decode)
    assert same(got, decode_general(qw.cpu(), w_dtype, K, decode))
    if decode in INT_TYPES:
        return
    sdt = TORCH_DTYPES[decode]
    s = numerics.convert(torch.rand((5, N), generator=g, device=dev) + 0.5,
                         decode)
    z = numerics.convert(torch.randint(0, 8, (5, N), generator=g,
                                       device=dev).float(), decode)
    qz = torch.randint(0, 8, (5, N), generator=g, device=dev,
                       dtype=torch.int32)
    for zeros, mode in ((None, "original"), (z, "original"), (z, "rescale"),
                        (qz, "quantized")):
        got = weight_decode_general(qw, w_dtype, K, decode, s, zeros, 20,
                                    mode)
        want = decode_general(qw.cpu(), w_dtype, K, decode, s.cpu(),
                              None if zeros is None else zeros.cpu(), 20,
                              mode)
        assert got.dtype == sdt and same(got, want), (zeros is None, mode)


@pytest.mark.parametrize("w_dtype", ["e4m3_float8", "e5m2_float8", "uint8",
                                     "int8"])
@pytest.mark.parametrize("decode", ["float16", "bfloat16", "float32",
                                    "int8", "uint4"])
def test_general_every_code_decodes_as_plain(dev, w_dtype, decode):
    codes = torch.arange(256, device=dev).reshape(4, 64)
    qw = packing.pack_k(codes, 8)
    assert same(weight_decode_general(qw, w_dtype, 64, decode),
                decode_general(qw.cpu(), w_dtype, 64, decode))


CASES = [   # (A, W, decode, scaled, zeros mode or None, out)
    ("float16", "uint16", "float16", True, None, "float32"),
    ("float16", "int32", "float16", False, None, "float16"),
    ("bfloat16", "uint32", "bfloat16", True, "original", "bfloat16"),
    ("float16", "uint8", "float16", True, "rescale", "float16"),
    ("float32", "uint4", "float32", True, "original", "float32"),
    ("float32", "nf4", "float32", True, None, "float32"),
    ("float32", "e5m2_float8", "float32", False, None, "float32"),
    ("float64", "int4", "float64", True, None, "float64"),
    ("int8", "uint8", "int8", False, None, "int32"),
    ("int8", "nf4", "int8", False, None, "int32"),
    ("int8", "fp4_e2m1", "int8", False, None, "int32"),
    ("int8", "e4m3_float8", "int8", False, None, "int32"),
    ("int8", "e5m2_float8", "int8", False, None, "float32"),
    ("int8", "int8", "float32", True, None, "float32"),
    ("int8", "nf4", "float32", True, "original", "float16"),
    ("int8", "uint4", "float32", True, "quantized", "int8"),
    ("float16", "nf4", "float16", True, "original", "float16"),
    ("float16", "fp4_e2m1", "float16", True, "rescale", "float16"),
    ("bfloat16", "e4m3_float8", "bfloat16", True, "quantized", "float32"),
    ("float16", "uint4", "float16", False, "quantized", "float16"),
    ("uint8", "uint4", "uint8", False, None, "int32"),
    ("int16", "int8", "int16", False, None, "float32"),
    ("e4m3_float8", "uint4", "e4m3_float8", True, None, "float32"),
    ("uint32", "uint2", "uint32", False, None, "float32"),
]


def _activation(name, M, K, gen, device):
    if name in INT_TYPES:
        lo, hi = (0, 16) if name.startswith("u") else (-8, 8)
        return numerics.convert(torch.randint(lo, hi, (M, K), generator=gen,
                                              device=device), name)
    return numerics.convert(torch.randn((M, K), generator=gen,
                                        device=device), name)


# M of one block's instance (32, 128 rows), of the largest (512 rows on
# the tensor-core units, 256 on FFMA) and past it (two blocks along M)
@pytest.mark.parametrize("M", [1, 5, 33, 130, 520])
@pytest.mark.parametrize("a,w,decode,scaled,zmode,out", CASES)
def test_dequant_matmul_general_matches_plain(dev, M, a, w, decode, scaled,
                                              zmode, out):
    g = torch.Generator(device=dev)
    g.manual_seed(M)
    N, K, group = 72, 288, 96
    qw = weight(w, N, K, g, dev)
    if source_format_and_bits(w)[1] > 8:   # small values: f16 is exact
        qw = (qw % 1024).to(qw.dtype)
    A = _activation(a, M, K, g, dev)
    s = numerics.convert(torch.rand((3, N), generator=g, device=dev) * 0.1
                         + 0.01, decode) if scaled else None
    z = None
    if zmode == "quantized":
        z = torch.randint(0, 8, (3, N), generator=g, device=dev,
                          dtype=torch.int32)
    elif zmode is not None:
        z = numerics.convert(torch.randint(0, 8, (3, N), generator=g,
                                           device=dev).float(), decode)
    bias = torch.randn(N, generator=g, device=dev)
    before = dequant_matmul_general.launches
    got = dequant_matmul_general(A, qw, w, a, decode, s, z, group,
                                 zmode or "original", bias, out,
                                 tile=GENERAL_TILE)
    assert dequant_matmul_general.launches == before + 1
    assert general_unit(a, decode, sums_type(a, w, decode)) in UNIT_CODE
    cpu = lambda t: None if t is None else t.cpu()   # noqa: E731
    want = dequant_matmul_general_plain(A.cpu(), qw.cpu(), w, a, decode,
                                        cpu(s), cpu(z), group,
                                        zmode or "original", bias.cpu(), out)
    assert got.dtype == want.dtype and got.shape == (M, N)
    assert close(got, want, out)
    again = dequant_matmul_general(A, qw, w, a, decode, s, z, group,
                                   zmode or "original", bias, out)
    assert same(got, again)


NATIVE = [("float16", "float16", "float32"), ("bfloat16", "bfloat16",
                                                "float32"),
          ("uint8", "uint8", "int32"), ("float64", "float64", "float64"),
          ("float16", "float16", "float64")] + [
    (a, w, "float32") for a in ("e4m3_float8", "e5m2_float8")
    for w in ("e4m3_float8", "e5m2_float8")]


@pytest.mark.parametrize("a_dtype,w_name,out", NATIVE)
@pytest.mark.parametrize("M,N,K", [(4, 136, 200), (33, 256, 4096)])
def test_native_route_matches_plain(dev, a_dtype, w_name, out, M, N, K):
    g = torch.Generator(device=dev)
    g.manual_seed(M + N)
    A = _activation(a_dtype, M, K, g, dev)
    W = _activation(w_name, N, K, g, dev)
    got = pdense.native_product(A, W, out)
    want = pdense.native_product(A.cpu(), W.cpu(), out)
    assert got.dtype == want.dtype and close(got, want, out)


@pytest.mark.parametrize("kw", [
    dict(A_dtype="float16", W_dtype="uint16", with_scaling=True,
         group_size=96, out_dtype="float32"),
    dict(A_dtype="int8", W_dtype="nf4", out_dtype="int32"),
    dict(A_dtype="float32", W_dtype="uint4", with_scaling=True,
         with_zeros=True, group_size=32, out_dtype="float32"),
    dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
         group_size=-1, out_dtype="float16"),
])
@pytest.mark.parametrize("M", [4, 512])
def test_matmul_general_routes(dev, kw, M):
    """A general configuration through Matmul on the card: the fused
    instance below M = 512 and the materialize plan (kernel 2's general
    instance + cuBLAS) from it, each close to the CPU Matmul."""
    cfg = MatmulConfig(N=128, K=288, **kw)
    g = torch.Generator()
    g.manual_seed(M)
    op, cpu_op = (Matmul(cfg, device=d, enable_tuning=False)
                  for d in ("cuda", "cpu"))
    words = cpu_op._example_weights()
    A = cpu_op._example_input(M)
    want = cpu_op.forward(A, *words)
    got = op.forward(A.to(dev), *[t.to(dev) for t in words])
    assert close(got, want, cfg.out_dtype)


@pytest.mark.parametrize("a_dtype,w_dtype", [
    ("e4m3_float8", "e4m3_float8"), ("e4m3_float8", "e5m2_float8"),
    ("e5m2_float8", "e4m3_float8")])
def test_scaled_mm_is_near_float32_sums(dev, a_dtype, w_dtype):
    """cuBLASLt's fp8 product, even without fast accumulation, is not
    float32's sums of the products; it stays within 2^-8 of the largest
    output at K = 4096 (the reason the port takes kernel 9)."""
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    A = _activation(a_dtype, 33, 4096, g, dev)
    W = _activation(w_dtype, 256, 4096, g, dev)
    got = pdense.scaled_mm_sums(A, W)
    want = pdense.native_product(A.cpu(), W.cpu(), "float32")
    err = float((got.cpu() - want).abs().max())
    assert err <= 2 ** -8 * float(want.abs().max())


FP8 = {"e4m3_float8": torch.float8_e4m3fn, "e5m2_float8": torch.float8_e5m2}


@pytest.mark.parametrize("a_dtype", list(FP8))
@pytest.mark.parametrize("w_dtype", list(FP8))
def test_native_fp8_every_code_reads_back(dev, a_dtype, w_dtype):
    """Every one of the 256 codes of either operand of a native fp8 pair
    through the card's route (the float16 upcast into kernel 9) against a
    one-hot 1.0 on the other side: the code's OCP value exactly, NaN and
    inf where it has them (both tensors are OCP float8, as JAX's are)."""
    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    grid = torch.zeros((256, 64), dtype=torch.uint8, device=dev)
    grid[:, 0] = codes
    one = torch.zeros((1, 64), device=dev)
    one[0, 0] = 1.0
    W = grid.view(FP8[w_dtype])
    got = pdense.native_product(one.to(FP8[a_dtype]), W, "float32")
    assert same(got[0], W[:, 0].float())
    A = grid.view(FP8[a_dtype])
    got = pdense.native_product(A, one.to(FP8[w_dtype]), "float32")
    assert same(got[:, 0], A[:, 0].float())

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no interpret mode, so every test here needs an NVIDIA
GPU with nvcc and skips elsewhere. Run on the card with
``python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py``
(the suite's conftest imports JAX, which the GPU host need not have).
Shapes are small but cover the edges: ragged N and M tiles, K tails of
the W2A8 kernel (K = 4160) and its deep K (14336), every int2 code, the
Matmul route boundary M = 511 / 512, GQA groups 1 to 8, stale NaN rows
(and NaN scales) past each length and in the reserved block 0, a length
of 0, block sizes 16 and 128 over permuted tables, and K amplified 20x so
that a head mix-up cannot hide in a near-uniform softmax.
"""

import math

import pytest
import torch

from bitblas_tpu_torch.kernels.dequant_matmul import (
    decode_i2_hopper, dequant_matmul_i2, dequant_matmul_i2_plain,
    dequant_matmul_u4, dequant_matmul_u4_plain)
from bitblas_tpu_torch.kernels.materialize import (
    weight_decode_int8, weight_decode_int8_plain, weight_decode_u4,
    weight_decode_u4_plain)
from bitblas_tpu_torch.kernels.flash import (
    flash_attention_fwd, flash_attention_plain, flash_decode,
    flash_decode_paged, flash_decode_paged_plain, flash_decode_paged_quant,
    flash_decode_paged_quant_plain, flash_decode_plain, flash_decode_quant,
    flash_decode_quant_plain)
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.serving import kv_cache

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("M", [1, 3, 16, 17, 130])
@pytest.mark.parametrize("N,K", [(136, 256), (256, 384)])
def test_dequant_matmul_matches_plain(dev, M, N, K):
    g = torch.Generator(device=dev)
    g.manual_seed(M * 1000 + N)
    qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8), generator=g,
                       device=dev, dtype=torch.int64).to(torch.int32)
    sc = (torch.rand((K // 128, N), generator=g, device=dev) * 0.05).half()
    zr = torch.randint(0, 16, (K // 128, N), generator=g, device=dev).half()
    A = torch.randn((M, K), generator=g, device=dev).half()
    before = dequant_matmul_u4.launches
    out = dequant_matmul_u4(A, qw, sc, zr)
    ref = dequant_matmul_u4_plain(A, qw, sc, zr)
    torch.cuda.synchronize()
    assert dequant_matmul_u4.launches == before + 1
    # same f16 dequantized weights; f32 sums in another order + 1 rounding
    tol = 4e-3 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _words(g, dev, rows, cols):
    """Random int32 words: every 2- and 4-bit field value occurs."""
    return torch.randint(-2 ** 31, 2 ** 31, (rows, cols), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("M", [1, 17, 511])
@pytest.mark.parametrize("N,K", [(1024, 4160), (1024, 14336), (14336, 4160)])
def test_dequant_matmul_i2_matches_plain(dev, M, N, K):
    g = torch.Generator(device=dev)
    g.manual_seed(M * 7 + N + K)
    qw = _words(g, dev, N, K // 16)
    assert set(decode_i2_hopper(qw).unique().tolist()) == {-2, -1, 0, 1}
    A = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int8)
    before = dequant_matmul_i2.launches
    out = dequant_matmul_i2(A, qw)
    ref = dequant_matmul_i2_plain(A, qw)
    torch.cuda.synchronize()
    assert dequant_matmul_i2.launches == before + 1
    assert torch.equal(out, ref)        # integer sums, exact on both sides


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("N,K", [(1024, 4096), (136, 11008)])
def test_weight_decode_u4_matches_plain(dev, dtype, N, K):
    g = torch.Generator(device=dev)
    g.manual_seed(N + K)
    qw = _words(g, dev, N, K // 8)
    sc = (torch.rand((K // 128, N), generator=g, device=dev) * 0.05).half()
    zr = torch.randint(0, 16, (K // 128, N), generator=g, device=dev).half()
    before = weight_decode_u4.launches
    out = weight_decode_u4(qw, sc, zr, dtype)
    ref = weight_decode_u4_plain(qw, sc, zr, dtype)
    torch.cuda.synchronize()
    assert weight_decode_u4.launches == before + 1
    assert out.dtype == dtype and torch.equal(out, ref)     # bit for bit


@pytest.mark.parametrize("bits,family", [(2, "int"), (2, "uint"), (4, "int"),
                                         (4, "uint")])
@pytest.mark.parametrize("N,K", [(1024, 4160), (14336, 4096)])
def test_weight_decode_int8_matches_plain(dev, bits, family, N, K):
    g = torch.Generator(device=dev)
    g.manual_seed(bits + N + K)
    qw = _words(g, dev, N, K * bits // 32)
    before = weight_decode_int8.launches
    out = weight_decode_int8(qw, bits, family)
    ref = weight_decode_int8_plain(qw, bits, family)
    torch.cuda.synchronize()
    assert weight_decode_int8.launches == before + 1
    assert torch.equal(out, ref)
    lo = -(1 << (bits - 1)) if family == "int" else 0
    assert set(out.unique().tolist()) == set(range(lo, lo + (1 << bits)))


def test_int_mm_equals_the_int32_oracle(dev):
    """torch._int_mm on the [N, K] int8 decode through its transpose (the
    column-major B it takes) gives the exact int32 sums."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    A = torch.randint(-128, 128, (512, 4160), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int8)
    W = weight_decode_int8(_words(g, dev, 1024, 4160 // 16))
    got = torch._int_mm(A, W.T)
    want = A.cpu().long() @ W.cpu().long().T
    assert got.dtype == torch.int32 and torch.equal(got.cpu().long(), want)


@pytest.mark.parametrize("fmt", ["uint4", "int2"])
def test_matmul_routes_at_the_boundary(dev, fmt):
    """M = 511 launches the fused kernel, M = 512 the decode kernel (then
    the library product); both agree with the plain fused version."""
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    N, K = 1024, 4096
    if fmt == "int2":
        pm = Matmul(MatmulConfig(N=N, K=K, A_dtype="int8", W_dtype="int2",
                                 accum_dtype="int32", out_dtype="float32"),
                    device=dev)
        W, rest = _words(g, dev, N, K // 16), {}
        fused, decode = dequant_matmul_i2, weight_decode_int8
        A = torch.randint(-128, 128, (512, K), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int8)
        want = dequant_matmul_i2_plain(A, W)
    else:
        pm = Matmul(MatmulConfig(N=N, K=K, A_dtype="float16",
                                 W_dtype="uint4", with_scaling=True,
                                 with_zeros=True, group_size=128,
                                 out_dtype="float16"), device=dev)
        W = _words(g, dev, N, K // 8)
        rest = {"scale": (torch.rand((K // 128, N), generator=g, device=dev)
                          * 0.01).half(),
                "zeros": torch.randint(0, 16, (K // 128, N), generator=g,
                                       device=dev).half()}
        fused, decode = dequant_matmul_u4, weight_decode_u4
        A = torch.randn((512, K), generator=g, device=dev).half()
        want = dequant_matmul_u4_plain(A, W, rest["scale"], rest["zeros"])
    for m, counter in ((511, fused), (512, decode)):
        before = (fused.launches, decode.launches)
        out = pm.forward(A[:m], W, **rest)
        torch.cuda.synchronize()
        after = (fused.launches, decode.launches)
        assert after[0] - before[0] == (counter is fused)
        assert after[1] - before[1] == (counter is decode)
        if fmt == "int2":
            assert torch.equal(out, want[:m])
        else:
            # the same f16 weights; cuBLAS may reduce split-K partial sums
            # in f16 (allow_fp16_reduced_precision_reduction): 4e-3 of the
            # largest output, as chip_smoke.py holds the fused kernel
            tol = 4e-3 * want.float().abs().max().item()
            assert (out.float() - want[:m].float()).abs().max() <= tol


@pytest.mark.parametrize("S,H,Hkv", [(64, 2, 2), (192, 4, 2), (256, 4, 1)])
def test_flash_attention_matches_plain(dev, S, H, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(S + H)
    Q = torch.randn((2, S, H, 128), generator=g, device=dev).half()
    K = (torch.randn((2, S, Hkv, 128), generator=g, device=dev) * 3).half()
    V = torch.randn((2, S, Hkv, 128), generator=g, device=dev).half()
    out = flash_attention_fwd(Q, K, V)
    ref = flash_attention_plain(Q, K, V)
    torch.cuda.synchronize()
    # P rounds to f16 before the PV product; outputs |.| < 4
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2


def test_flash_attention_pad_rows_do_not_leak(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    Q, K, V = (torch.randn((1, 128, 2, 128), generator=g, device=dev).half()
               for _ in range(3))
    out = flash_attention_fwd(Q, K, V)
    K2, V2 = K.clone(), V.clone()
    K2[:, 100:] = 1e4      # pad rows hold finite garbage (zero-embedded
    V2[:, 100:] = -1e4     # inputs), which causality keeps at weight 0
    out2 = flash_attention_fwd(Q, K2, V2)
    assert torch.equal(out[:, :100], out2[:, :100])


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (16, 2)])
def test_flash_decode_matches_plain(dev, H, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(H * 10 + Hkv)
    rows, Smax = 5, 200
    lengths = torch.tensor([0, 1, 64, 65, 200], dtype=torch.int32, device=dev)
    slots = torch.tensor([3, 0, 4, 1, 2], dtype=torch.int32, device=dev)
    q = torch.randn((5, H, 128), generator=g, device=dev).half()
    kc = torch.randn((rows, Smax, Hkv, 128), generator=g,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((rows, Smax, Hkv, 128), generator=g,
                     device=dev).to(torch.bfloat16)
    for b in range(5):
        kc[slots[b], lengths[b]:] = float("nan")
        vc[slots[b], lengths[b]:] = float("nan")
    before = flash_decode.launches
    out = flash_decode(q, kc, vc, lengths, slots)
    ref = flash_decode_plain(q, kc, vc, lengths, slots)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # length 0
    assert (out.float() - ref.float()).abs().max().item() <= 2e-3
    assert not math.isnan(out.float().sum().item())


# Decode over int8 codes or the block pool. Outputs are convex mixes of V
# rows (|.| < 5, int8 rows dequantize to the same range); K amplified 20x
# makes scores reach a few hundred in the base-2 domain, where the f32 dot
# products of kernel and plain version (summed in another order) differ by
# ~1e-5 relative, i.e. ~0.3% in a weight: 1e-2 absolute on the outputs.
DECODE_TOL = 1e-2
LENGTHS = (0, 1, 37, 64, 65, 200)


def _decode_q(gen, dev, B, H):
    return torch.randn((B, H, 128), generator=gen, device=dev).half()


def _rows(gen, dev, shape):
    """K rows amplified 20x and V rows, float32."""
    k = torch.randn(shape, generator=gen, device=dev) * 20
    v = torch.randn(shape, generator=gen, device=dev)
    return k, v


def _check_decode(out, ref, wrapper, before):
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # length 0
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_TOL


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (16, 2)])
def test_flash_decode_quant_matches_plain(dev, H, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(100 + H * 10 + Hkv)
    B, rows, Smax = len(LENGTHS), 7, 200
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    slots = torch.tensor([3, 0, 6, 4, 1, 2], dtype=torch.int32, device=dev)
    kf, vf = _rows(g, dev, (rows, Smax, Hkv, 128))
    kc, ks = kv_cache.quantize_kv(kf)
    vc, vs = kv_cache.quantize_kv(vf)
    for b in range(B):           # stale rows: any codes, NaN scales
        kc[slots[b], lengths[b]:] = 127
        vc[slots[b], lengths[b]:] = -128
        ks[slots[b], lengths[b]:] = float("nan")
        vs[slots[b], lengths[b]:] = float("nan")
    q = _decode_q(g, dev, B, H)
    before = flash_decode_quant.launches
    out = flash_decode_quant(q, kc, vc, ks, vs, lengths, slots)
    ref = flash_decode_quant_plain(q, kc, vc, ks, vs, lengths, slots)
    _check_decode(out, ref, flash_decode_quant, before)


def _pool(gen, dev, B, bs, Hkv, quant):
    """A block pool with permuted tables for LENGTHS: block 0 reserved and
    NaN, rows past each length NaN (or NaN scales), unused table entries
    0."""
    MB = -(-max(LENGTHS) // bs) + 1
    need = [-(-n // bs) for n in LENGTHS]
    blocks = 1 + sum(need) + 2
    perm = (torch.randperm(blocks - 1, generator=gen, device=dev) + 1)
    tables = torch.zeros((B, MB), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    kf, vf = _rows(gen, dev, (blocks, bs, Hkv, 128))
    if quant:
        (k, ks), (v, vs) = kv_cache.quantize_kv(kf), kv_cache.quantize_kv(vf)
        stale = ((k, 127), (v, -128), (ks, float("nan")),
                 (vs, float("nan")))
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
        stale = ((k, float("nan")), (v, float("nan")))
    for x, val in stale:
        x[0] = val                                   # the reserved block
        for b, n in enumerate(LENGTHS):
            if n % bs:                               # tail of the last page
                x[tables[b, n // bs], n % bs:] = val
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    return k, v, ks, vs, tables, lengths


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (16, 2)])
def test_flash_decode_paged_matches_plain(dev, bs, H, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(200 + bs + H * 10 + Hkv)
    B = len(LENGTHS)
    k, v, _, _, tables, lengths = _pool(g, dev, B, bs, Hkv, quant=False)
    q = _decode_q(g, dev, B, H)
    before = flash_decode_paged.launches
    out = flash_decode_paged(q, k, v, tables, lengths)
    ref = flash_decode_paged_plain(q, k, v, tables, lengths)
    _check_decode(out, ref, flash_decode_paged, before)


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (16, 2)])
def test_flash_decode_paged_quant_matches_plain(dev, bs, H, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(300 + bs + H * 10 + Hkv)
    B = len(LENGTHS)
    k, v, ks, vs, tables, lengths = _pool(g, dev, B, bs, Hkv, quant=True)
    q = _decode_q(g, dev, B, H)
    before = flash_decode_paged_quant.launches
    out = flash_decode_paged_quant(q, k, v, ks, vs, tables, lengths)
    ref = flash_decode_paged_quant_plain(q, k, v, ks, vs, tables, lengths)
    _check_decode(out, ref, flash_decode_paged_quant, before)


def test_paged_routing_takes_the_kernels_on_the_card(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(400)
    B = len(LENGTHS)
    k, v, _, _, tables, lengths = _pool(g, dev, B, 16, 2, quant=False)
    q = _decode_q(g, dev, B, 4)
    before = flash_decode_paged.launches
    out = kv_cache.decode_attention_paged(q, k, v, tables, lengths,
                                          num_heads=4)
    assert flash_decode_paged.launches == before + 1
    gather = kv_cache.decode_attention_paged(q, k, v, tables, lengths,
                                             num_heads=4, use_flash=False)
    assert flash_decode_paged.launches == before + 1
    torch.cuda.synchronize()
    assert (out.float() - gather.float()).abs().max().item() <= DECODE_TOL

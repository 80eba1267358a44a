"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no interpret mode, so every test here needs an NVIDIA
GPU with nvcc and skips elsewhere. Run on the card with
``python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py``
(the suite's conftest imports JAX, which the GPU host need not have).
Shapes are small but cover the edges: ragged N and M tiles, K tails of
the W2A8 kernel (K = 4160) and its deep K (14336), every int2 code, every
compiled tile instance of the fused kernels and of kernel 9 (dense_matmul:
every operand type, N and K of one tile and of several, M tails), the
untuned Matmul route boundary M = 511 / 512, measured 2-bucket tunes of
both quantized formats and of native Matmuls in every layout, GQA groups
1 to 8, stale NaN rows (and NaN scales) past each length and in the
reserved block 0, a length of 0, block sizes 16 and 128 over permuted
tables, and K amplified 20x so that a head mix-up cannot hide in a
near-uniform softmax. The split-KV decode kernels run at a span of 2048
keys with lengths across several splits (two calls bit-equal, one launch
a call); the wgmma prefill at S = 64 ... 1024, Hkv = H and H / 4; the
decode kernels at head dim 256, GQA groups 12 and 16 (chunks of 8 query
heads) and on float16 caches; kernel 9's wgmma tiles (f16, bf16, int8
bit for bit) at M tails and an int8 K tail of 64; kernel 1's split-K
decode instances at M = 1, 3, 8, 16 and odd N (two calls bit-equal, one
launch a call, against the split-then-merge plain version too; int2 bit
for bit at a K tail of 64 and at K = 14336); kernel 1's uint4 instances at
GPTQ's group sizes (32, 64, 128, 256, per channel), zeros mode rescale
and a bias, kernel 2 at those groups, and the refusal of a group no
instance takes; kernel 1 (both instances) and kernel 2 for the 20 other
float-activation pairs (`FLOAT_PAIRS`) at every group, zeros mode, bias
and output type, every code of each format, either instance at any M,
and two of them tuned; kernel 1's integer column (`INT_PAIRS`: int8
activations with uint1/2/4 and int1/2/4 weights) on both instances at
every group, zeros mode, bias and output type (float32, float16, int32,
int8), K tails and N = 136, M = 1, 16, 17 and 256 (the decode instance
bit-equal to its split plain version, the tiled one bit-equal unscaled
and, scaled, within one ulp of the plain version or nearer a float64
truth, int8 within 1), ties at the int8 output rounding to even as the
plain version rounds them, every code through one-hot activations,
either instance at any M, and kernel 3 at 1 bit. Kernels 4-8 on
bfloat16 queries, and kernels 4-6 with a sliding window: the prefill at S
= 64 ... 1024 with windows 1, 63, 64, 65 and >= S (rows whose first tile
is all masked; a window >= S bit-equal to none), the slot decode kernels
at Smax = 2048 with float16 and bfloat16 queries and lengths around the
window (against the single-pass and the split plain versions), the paged
kernels on bfloat16 queries and a windowed paged decode through the
masked gather. Kernel 4 at every head dim of its wgmma instances (64,
80, 96, 100, 128, 256) over nine cases: causal and dense, K^T, a ragged S
over two sequences, a window, float32 operands, outputs in another type,
both KV tiles (two calls bit-equal, one launch a call); its general
instance at head dims 16 ... 768 (the cap), odd head counts at D % 8 ==
4, K^T at S % 8 != 0, the float32 kernel at D = 6 / 288 / 768, and
neighbour heads of
Inf that must not reach a head's output (d80 and general). Kernels 5-8
at head dims 384, 512 and 1024 (the wide instances: a cluster of 128-column
slices), with a window and in partial_stats mode; the float32 kernel's
3xTF32 products with K amplified 20x against a float64 truth, and a NaN
in Q, K or V reaching its output where the plain version's has one.
"""

import math

import pytest
import torch

from bitblas_tpu_torch.kernels.dense import (
    DENSE_TILES, WGMMA_STAGES, dense_matmul, dense_matmul_plain)
from bitblas_tpu_torch.kernels.dequant_matmul import (
    FUSED_TILES, I2_DECODE_TILE, U4_DECODE_TILE, decode_i2_hopper,
    dequant_matmul_i2, dequant_matmul_i2_plain, dequant_matmul_i2_split_plain,
    dequant_matmul_u4, dequant_matmul_u4_plain, dequant_matmul_u4_split_plain,
    plan_splits_k, plan_splits_k_i2)
from bitblas_tpu_torch.kernels.materialize import (
    weight_decode_int8, weight_decode_int8_plain, weight_decode_u4,
    weight_decode_u4_plain)
from bitblas_tpu_torch.kernels.flash import (
    flash_attention_fwd, flash_attention_plain, flash_decode,
    flash_decode_paged, flash_decode_paged_plain, flash_decode_paged_quant,
    flash_decode_paged_quant_plain, flash_decode_plain, flash_decode_quant,
    flash_decode_quant_plain, flash_decode_split_plain, plan_splits,
    prefill_tiles)
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import FLOAT_PAIRS, MatmulConfig
from bitblas_tpu_torch.serving import kv_cache
from bitblas_tpu_torch.testing import ATTN_ULP, attention_err
from bitblas_tpu_torch.tuner import H100_SXM, fast_tune
from bitblas_tpu_torch.tuner.space import enumerate_hints

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


@pytest.mark.parametrize("bits,family", [(1, "int"), (1, "uint"),
                                         (2, "int"), (2, "uint"), (4, "int"),
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
    """Untuned, M = 511 launches the fused kernel, M = 512 the decode
    kernel (then the library product); both agree with the plain fused
    version."""
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    N, K = 1024, 4096
    if fmt == "int2":
        pm = Matmul(MatmulConfig(N=N, K=K, A_dtype="int8", W_dtype="int2",
                                 accum_dtype="int32", out_dtype="float32"),
                    device=dev, enable_tuning=False)
        W, rest = _words(g, dev, N, K // 16), {}
        fused, decode = dequant_matmul_i2, weight_decode_int8
        A = torch.randint(-128, 128, (512, K), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int8)
        want = dequant_matmul_i2_plain(A, W)
    else:
        pm = Matmul(MatmulConfig(N=N, K=K, A_dtype="float16",
                                 W_dtype="uint4", with_scaling=True,
                                 with_zeros=True, group_size=128,
                                 out_dtype="float16"), device=dev,
                    enable_tuning=False)
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


@pytest.mark.parametrize("S", [64, 192, 256, 512, 1024])
@pytest.mark.parametrize("Hkv", [8, 2])
def test_flash_attention_wgmma_shapes(dev, S, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(S * 10 + Hkv)
    Q = torch.randn((1, S, 8, 128), generator=g, device=dev).half()
    K = (torch.randn((1, S, Hkv, 128), generator=g, device=dev) * 3).half()
    V = torch.randn((1, S, Hkv, 128), generator=g, device=dev).half()
    before = flash_attention_fwd.launches
    out = flash_attention_fwd(Q, K, V)
    ref = flash_attention_plain(Q, K, V)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert torch.isfinite(out).all()
    # P rounds to f16 before the PV product; outputs |.| < 4
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert torch.equal(out, flash_attention_fwd(Q, K, V))


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


# Split-KV decode at a span of 2048 keys (H = 8, the group set by Hkv):
# lengths of 0 among long ones, of one key, at and around a chunk end and
# across many splits; stale rows NaN, K amplified 20x.
SPAN = 2048


def _split_lengths(B, Hkv, sms):
    chunk, _ = plan_splits(SPAN, B, Hkv, sms)
    return (0, SPAN, 1, chunk, chunk + 1, 3 * chunk - 1, 1000)


@pytest.mark.parametrize("bs", [0, 16, 128])     # 0: the slot cache
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_decode_split_kv(dev, bs, quant, group):
    g = torch.Generator(device=dev)
    g.manual_seed(500 + bs + 10 * quant + group)
    H, Hkv = 8, 8 // group
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lengths_ = _split_lengths(7, Hkv, sms)
    B = len(lengths_)
    lengths = torch.tensor(lengths_, dtype=torch.int32, device=dev)
    if bs == 0:
        rows = B + 1
        index = torch.randperm(rows, generator=g, device=dev)[:B].to(
            torch.int32)
        shape = (rows, SPAN, Hkv, 128)
    else:
        MB = SPAN // bs
        need = [-(-n // bs) for n in lengths_]
        blocks = 1 + sum(need)
        perm = torch.randperm(blocks - 1, generator=g, device=dev) + 1
        index = torch.zeros((B, MB), dtype=torch.int32, device=dev)
        at = 0
        for b, n in enumerate(need):
            index[b, :n] = perm[at:at + n].to(torch.int32)
            at += n
        shape = (blocks, bs, Hkv, 128)
    kf, vf = _rows(g, dev, shape)
    if quant:
        (k, ks), (v, vs) = kv_cache.quantize_kv(kf), kv_cache.quantize_kv(vf)
        stale = ((k, 127), (v, -128), (ks, float("nan")),
                 (vs, float("nan")))
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
        stale = ((k, float("nan")), (v, float("nan")))
    for x, val in stale:
        for b, n in enumerate(lengths_):
            if bs == 0:
                x[index[b], n:] = val
            else:
                x[0] = val
                if n % bs:
                    x[index[b, n // bs], n % bs:] = val
    q = _decode_q(g, dev, B, H)
    if bs == 0:
        wrapper = flash_decode_quant if quant else flash_decode
        plain = flash_decode_quant_plain if quant else flash_decode_plain
        args = ((q, k, v, ks, vs, lengths, index) if quant
                else (q, k, v, lengths, index))
    else:
        wrapper = flash_decode_paged_quant if quant else flash_decode_paged
        plain = (flash_decode_paged_quant_plain if quant
                 else flash_decode_paged_plain)
        args = ((q, k, v, ks, vs, index, lengths) if quant
                else (q, k, v, index, lengths))
    before = wrapper.launches
    out = wrapper(*args)
    _check_decode(out, plain(*args), wrapper, before)
    again = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(out, again)          # the merge's fixed order
    split = flash_decode_split_plain(q, k, v, lengths, index, paged=bs > 0,
                                     k_scale=ks, v_scale=vs, sms=sms)
    assert (out.float() - split.float()).abs().max().item() <= DECODE_TOL


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


@pytest.mark.parametrize("tile", FUSED_TILES["uint4"])
@pytest.mark.parametrize("M", [1, 33, 130])
def test_dequant_matmul_u4_tiles_match_plain(dev, tile, M):
    """Every uint4 instance against the plain version (N = 384: three
    128-row tiles; M = 33 and 130 cut a token tile): within 4e-3 of the
    largest output; the wgmma + TMA tiled instances decode the plain
    version's f16 weights bit for bit, so they also lie within one f16 ulp
    of each output (`_f16_ulps`) and equal one another (f32 sums over K in
    the same order); the split-K decode instance sums by split and equals
    itself. Each launch counts as a decode or a tiled launch."""
    g = torch.Generator(device=dev)
    g.manual_seed(M + tile[0])
    N, K = 384, 512
    qw = _words(g, dev, N, K // 8)
    sc = (torch.rand((K // 128, N), generator=g, device=dev) * 0.05).half()
    zr = torch.randint(0, 16, (K // 128, N), generator=g, device=dev).half()
    A = torch.randn((M, K), generator=g, device=dev).half()
    decode_before = dequant_matmul_u4.decode_launches
    tiled_before = dequant_matmul_u4.tiled_launches
    out = dequant_matmul_u4(A, qw, sc, zr, tile=tile)
    decode = tile == U4_DECODE_TILE
    assert dequant_matmul_u4.decode_launches == decode_before + int(decode)
    assert dequant_matmul_u4.tiled_launches == tiled_before + int(not decode)
    ref = dequant_matmul_u4_plain(A, qw, sc, zr)
    torch.cuda.synchronize()
    # same f16 weights; f32 sums in another order + 1 rounding
    tol = 4e-3 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.isfinite(out).all()
    if not decode:
        assert _f16_ulps(out, ref) <= 1
    same = U4_DECODE_TILE if decode else FUSED_TILES["uint4"][2]
    assert torch.equal(out, dequant_matmul_u4(A, qw, sc, zr, tile=same))


@pytest.mark.parametrize("tile", FUSED_TILES["int2"])
@pytest.mark.parametrize("M", [1, 33, 130])
def test_dequant_matmul_i2_tiles_match_plain(dev, tile, M):
    """Every int2 instance equals the plain version bit for bit (int32
    sums), at a K tail of 64 past the last whole 128 of the wgmma + TMA
    stages (K = 4160) and a ragged token tile; each launch counts as a
    decode or a tiled launch."""
    g = torch.Generator(device=dev)
    g.manual_seed(M + tile[0] + 1)
    N, K = 384, 4160
    qw = _words(g, dev, N, K // 16)
    A = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int8)
    tiled_before = dequant_matmul_i2.tiled_launches
    decode_before = dequant_matmul_i2.decode_launches
    out = dequant_matmul_i2(A, qw, tile=tile)
    torch.cuda.synchronize()
    decode = tile == I2_DECODE_TILE
    assert dequant_matmul_i2.tiled_launches == tiled_before + int(not decode)
    assert dequant_matmul_i2.decode_launches == decode_before + int(decode)
    assert torch.equal(out, dequant_matmul_i2_plain(A, qw))


def test_fused_kernels_refuse_an_uncompiled_tile(dev):
    A = torch.zeros((4, 256), dtype=torch.int8, device=dev)
    qw = torch.zeros((128, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="not compiled"):
        dequant_matmul_i2(A, qw, tile=(16, 32, 128, 4))


# float sums in another order, one rounding to the output type
_DENSE_TOL = {torch.float16: 4e-3, torch.bfloat16: 1.6e-2,
              torch.float32: 1e-5}
_DENSE_OUT = {torch.float16: torch.float16, torch.bfloat16: torch.bfloat16,
              torch.float32: torch.float32, torch.int8: torch.int32}


@pytest.mark.parametrize("tile", DENSE_TILES)
@pytest.mark.parametrize("M,NT,K", [(1, 1, 128), (17, 2, 384),
                                    (130, 3, 4096)])
@pytest.mark.parametrize("dtype", list(_DENSE_OUT))
def test_dense_matmul_matches_plain(dev, dtype, M, NT, K, tile):
    N = NT * tile[1]          # one, two and three tiles of N
    g = torch.Generator(device=dev)
    g.manual_seed(M + N + K + tile[0])
    if dtype == torch.int8:
        A, W = (torch.randint(-128, 128, shape, generator=g, device=dev,
                              dtype=torch.int64).to(torch.int8)
                for shape in ((M, K), (N, K)))
    else:
        A, W = (torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((M, K), (N, K)))
    out_dtype = _DENSE_OUT[dtype]
    before = dense_matmul.launches
    out = dense_matmul(A, W, out_dtype, tile)
    ref = dense_matmul_plain(A, W, out_dtype)
    torch.cuda.synchronize()
    assert dense_matmul.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (M, N)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
        f32 = dense_matmul(A, W, torch.float32, tile)
        assert torch.equal(f32, ref.float())
    else:
        tol = _DENSE_TOL[dtype] * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol
    if tile == DENSE_TILES[0] and dtype != torch.float32:
        # the 16-row tile is float32's; the other types run the hint on
        # the 64 x 128 wgmma tile
        assert torch.equal(out, dense_matmul(A, W, out_dtype,
                                             DENSE_TILES[1]))


def test_dense_matmul_refuses_ragged_tiles(dev):
    A = torch.zeros((4, 256), dtype=torch.float16, device=dev)
    with pytest.raises(ValueError, match="divisible"):
        dense_matmul(A, torch.zeros((136, 256), dtype=torch.float16,
                                    device=dev), torch.float16)


@pytest.mark.parametrize("fmt", ["uint4", "int2", "uint1xfloat16",
                                 "nf4xbfloat16"])
def test_fast_tune_measures_and_installs_two_buckets(dev, fmt):
    if fmt == "int2":
        kw = dict(A_dtype="int8", W_dtype="int2", accum_dtype="int32",
                  out_dtype="float32")
    elif fmt == "uint4":
        kw = dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
                  with_zeros=True, group_size=128, out_dtype="float16")
    else:   # dequant_matmul_fmt's formats: its two instances and the plan
        w_dtype, a_dtype = fmt.split("x")
        kw = dict(A_dtype=a_dtype, W_dtype=w_dtype, with_scaling=True,
                  group_size=128, out_dtype=a_dtype)
    pm = Matmul(MatmulConfig(M=[4, 256], N=1024, K=4096, **kw), device=dev)
    assert set(pm.tuned_hints) == {4, 256}
    for m in (4, 256):
        res = pm.tune_results[m]
        spec = pm._make_spec(m)
        assert res.measured and res.hint == pm.hints[m]
        assert [h for h, _, _ in res.candidates] == \
            enumerate_hints(spec, H100_SXM)
        assert res.latency == min(t for _, t, _ in res.candidates) > 0
    W = pm._example_weights()
    for m in (3, 200):
        A = pm._example_input(m)
        got = pm.forward(A, *W)
        default = Matmul(pm.config, device=dev, enable_tuning=False)
        want = default.forward(A, *W)
        torch.cuda.synchronize()
        # int2 sums are exact on every route; float routes sum in their own
        # order (the split-K decode instances by split), so the same route
        # is equal and another within a rounding of the output type of f32
        # sums (4e-3 of the largest f16 output, 4 x 2^-7 of a bf16 one)
        if fmt == "int2" or pm.hint_for(m) == default.hint_for(m):
            assert torch.equal(got, want), (m, pm.hint_for(m))
        else:
            rel = 4 * 2.0 ** -7 if want.dtype == torch.bfloat16 else 4e-3
            tol = rel * want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() <= tol


def test_fast_tune_raises_when_a_candidate_fails(dev):
    pm = Matmul(MatmulConfig(M=[4], N=1024, K=4096, A_dtype="int8",
                             W_dtype="int2", accum_dtype="int32",
                             out_dtype="float32"), device=dev,
                enable_tuning=False)
    spec = pm._make_spec(4)
    args = (pm._example_input(4), *pm._example_weights())

    def builder(hint):
        if hint.block_m == 32:
            return lambda *a: dequant_matmul_i2(a[0], a[1],
                                                tile=(32, 64, 128, 4))
        return pm._build_kernel(spec, hint)

    with pytest.raises(ValueError, match="not compiled"):
        fast_tune(spec, H100_SXM, builder, lambda h: args)


@pytest.mark.parametrize("layout", ["nt", "nn", "tn", "tt"])
@pytest.mark.parametrize("dtype", list(_DENSE_OUT))
def test_native_matmul_tunes_and_matches_plain(dev, dtype, layout):
    """A native Matmul on the card measures its one "dense" hint per
    bucket and runs cuBLAS in every layout, with bias: against the plain
    product (int8 exact, also at M <= 16 where torch._int_mm's rows are
    padded; floats within the one-rounding tolerances above, cuBLAS may
    reduce float16 partial sums in float16)."""
    name = str(dtype).split(".")[1]
    out_name = "int32" if dtype == torch.int8 else name
    cfg = MatmulConfig(M=[8, 64], N=256, K=512, A_dtype=name, W_dtype=name,
                       out_dtype=out_name, layout=layout, with_bias=True)
    pm = Matmul(cfg, device=dev)
    assert set(pm.tuned_hints) == {8, 64}
    assert all(r.measured and r.hint.decode_mode == "dense"
               for r in pm.tune_results.values())
    W, bias = pm._example_weights()
    W_nk = W if layout[1] == "t" else W.T
    for m in (5, 40):
        A = pm._example_input(m)                      # [M, K]
        got = pm.forward(A if layout[0] == "n" else A.T.contiguous(), W,
                         bias=bias)
        want = dense_matmul_plain(A, W_nk.contiguous(), _DENSE_OUT[dtype])
        want = want + bias.to(want.dtype)
        torch.cuda.synchronize()
        assert got.dtype == _DENSE_OUT[dtype] and got.shape == (m, 256)
        if dtype == torch.int8:
            assert torch.equal(got, want)
        else:
            tol = _DENSE_TOL[dtype] * want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() <= tol


# -- this slice: kernel 9 on wgmma, kernel 1's split-K decode instance, the
# widened decode kernels ------------------------------------------------------

@pytest.mark.parametrize("tile", sorted(WGMMA_STAGES))
@pytest.mark.parametrize("M", [1, 65, 200])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int8])
def test_dense_matmul_wgmma_tails(dev, dtype, M, tile):
    """The wgmma tiles at M tails (TMA's zero fill past M) and K = 192
    (for int8 a last 128-byte K step half past K, zero-filled): int8 bit
    for bit, floats within one rounding; two calls bit-equal."""
    g = torch.Generator(device=dev)
    g.manual_seed(M + tile[0] + tile[1])
    N, K = 2 * tile[1], 192
    if dtype == torch.int8:
        A, W = (torch.randint(-128, 128, shape, generator=g, device=dev,
                              dtype=torch.int64).to(torch.int8)
                for shape in ((M, K), (N, K)))
    else:
        A, W = (torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((M, K), (N, K)))
    out_dtype = _DENSE_OUT[dtype]
    before = dense_matmul.launches
    out = dense_matmul(A, W, out_dtype, tile)
    again = dense_matmul(A, W, out_dtype, tile)
    ref = dense_matmul_plain(A, W, out_dtype)
    torch.cuda.synchronize()
    assert dense_matmul.launches == before + 2
    assert torch.equal(out, again)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        tol = _DENSE_TOL[dtype] * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol


def _f16_ulps(got, want, floor=2.0 ** -18):
    """The largest |got - want| in units of want's float16 ulp plus `floor`
    of the largest |want|: the split-K instance sums each group in the
    mma's order, so its f32 rounding, about 2^-24 of the largest output,
    can exceed the f16 ulp of an output near zero."""
    w = want.double()
    # floor(log2 |w|) exactly (log2 of a power of two can fall a hair
    # short, halving that output's unit), at least float16's -14
    e = (torch.frexp(w.abs().clamp_min(2.0 ** -14))[1] - 1).double()
    unit = torch.exp2(e - 10) + floor * w.abs().max()
    return ((got.double() - w).abs() / unit).max().item()


@pytest.mark.parametrize("M", [1, 3, 8, 16])
@pytest.mark.parametrize("N,K", [(136, 2048), (136, 256), (11008, 4096)])
def test_dequant_matmul_u4_decode_instance(dev, M, N, K):
    """Kernel 1's split-K decode instance (the default up to M = 16): one
    launch a call, counted as a decode-instance launch; within 4e-3 of the
    largest output of the plain version and within one f16 ulp of each
    output of the split-then-merge plain version (`_f16_ulps`); two calls
    bit-equal; N = 136 has a ragged last tile, K = 2048 at N = 136 cuts K
    into 16 splits of one group."""
    g = torch.Generator(device=dev)
    g.manual_seed(M * 7 + N + K)
    qw = _words(g, dev, N, K // 8)
    sc = (torch.rand((K // 128, N), generator=g, device=dev) * 0.05).half()
    zr = torch.randint(0, 16, (K // 128, N), generator=g, device=dev).half()
    A = torch.randn((M, K), generator=g, device=dev).half()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, splits = plan_splits_k(M, N, K, sms)
    assert splits > 1
    before = dequant_matmul_u4.launches
    decode_before = dequant_matmul_u4.decode_launches
    out = dequant_matmul_u4(A, qw, sc, zr)
    again = dequant_matmul_u4(A, qw, sc, zr, tile=U4_DECODE_TILE)
    ref = dequant_matmul_u4_plain(A, qw, sc, zr)
    split = dequant_matmul_u4_split_plain(A, qw, sc, zr, sms=sms)
    torch.cuda.synchronize()
    assert dequant_matmul_u4.launches == before + 2
    assert dequant_matmul_u4.decode_launches == decode_before + 2
    assert torch.equal(out, again)            # the merge's fixed order
    assert torch.isfinite(out).all()
    tol = 4e-3 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert _f16_ulps(out, split) <= 1


@pytest.mark.parametrize("M", [1, 3, 8, 16])
@pytest.mark.parametrize("N,K", [(136, 4160), (136, 14336), (1024, 4096)])
def test_dequant_matmul_i2_decode_instance(dev, M, N, K):
    """Kernel 1's int2 split-K decode instance (the default up to M = 16):
    one launch a call, counted as a decode-instance launch; bit-equal to
    the plain version and to the split-then-merge plain version (integer
    sums); two calls bit-equal (the counters left at 0). N = 136 has a
    ragged last 128-row tile; K = 4160 ends in a step of 64 (three of its
    threads' chunks past K), K = 14336 runs 56 steps."""
    g = torch.Generator(device=dev)
    g.manual_seed(M * 11 + N + K)
    qw = _words(g, dev, N, K // 16)
    A = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, splits = plan_splits_k_i2(M, N, K, sms)
    assert splits > 1
    before = dequant_matmul_i2.launches
    decode_before = dequant_matmul_i2.decode_launches
    tiled_before = dequant_matmul_i2.tiled_launches
    out = dequant_matmul_i2(A, qw)
    again = dequant_matmul_i2(A, qw, tile=I2_DECODE_TILE)
    ref = dequant_matmul_i2_plain(A, qw)
    split = dequant_matmul_i2_split_plain(A, qw, sms=sms)
    torch.cuda.synchronize()
    assert dequant_matmul_i2.launches == before + 2
    assert dequant_matmul_i2.decode_launches == decode_before + 2
    assert dequant_matmul_i2.tiled_launches == tiled_before
    assert torch.equal(out, again)
    assert torch.equal(out, ref)
    assert torch.equal(out, split)


def _wide_decode_args(g, dev, kind, D, H, Hkv, dtype):
    """(wrapper, plain, args) of one decode kernel over LENGTHS at head dim
    D, H query heads, Hkv KV heads and cache dtype (bf16 or f16 for the
    float kernels); stale rows NaN (NaN scales for int8), K amplified
    20x."""
    B = len(LENGTHS)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    quant = kind.endswith("quant")
    if kind.startswith("slot"):
        rows, span = B + 1, 256
        index = torch.randperm(rows, generator=g, device=dev)[:B].to(
            torch.int32)
        shape = (rows, span, Hkv, D)
    else:
        bs, MB = 16, 16
        need = [-(-n // bs) for n in LENGTHS]
        blocks = 1 + sum(need)
        perm = torch.randperm(blocks - 1, generator=g, device=dev) + 1
        index = torch.zeros((B, MB), dtype=torch.int32, device=dev)
        at = 0
        for b, n in enumerate(need):
            index[b, :n] = perm[at:at + n].to(torch.int32)
            at += n
        shape = (blocks, bs, Hkv, D)
    kf = torch.randn(shape, generator=g, device=dev) * 20
    vf = torch.randn(shape, generator=g, device=dev)
    if quant:
        (k, ks), (v, vs) = kv_cache.quantize_kv(kf), kv_cache.quantize_kv(vf)
        stale = ((k, 127), (v, -128), (ks, float("nan")),
                 (vs, float("nan")))
    else:
        k, v = kf.to(dtype), vf.to(dtype)
        stale = ((k, float("nan")), (v, float("nan")))
    for x, val in stale:
        for b, n in enumerate(LENGTHS):
            if kind.startswith("slot"):
                x[index[b], n:] = val
            else:
                x[0] = val
                if n % 16:
                    x[index[b, n // 16], n % 16:] = val
    q = torch.randn((B, H, D), generator=g, device=dev).half()
    table = {
        "slot": (flash_decode, flash_decode_plain,
                 lambda: (q, k, v, lengths, index)),
        "slot_quant": (flash_decode_quant, flash_decode_quant_plain,
                       lambda: (q, k, v, ks, vs, lengths, index)),
        "paged": (flash_decode_paged, flash_decode_paged_plain,
                  lambda: (q, k, v, index, lengths)),
        "paged_quant": (flash_decode_paged_quant,
                        flash_decode_paged_quant_plain,
                        lambda: (q, k, v, ks, vs, index, lengths)),
    }
    wrapper, plain, args = table[kind]
    return wrapper, plain, args()


@pytest.mark.parametrize("D,H,Hkv,dtype", [
    (256, 8, 2, torch.bfloat16), (128, 16, 1, torch.bfloat16),
    (128, 24, 2, torch.bfloat16), (256, 16, 1, torch.bfloat16),
    (128, 8, 2, torch.float16), (256, 16, 1, torch.float16),
    (512, 16, 4, torch.bfloat16), (384, 8, 2, torch.float16),
    (1024, 12, 1, torch.bfloat16)])
@pytest.mark.parametrize("kind", ["slot", "slot_quant", "paged",
                                  "paged_quant"])
def test_flash_decode_wide_shapes(dev, kind, D, H, Hkv, dtype):
    """The decode kernels at head dim 256, at GQA groups 16 and 12 (chunks
    of 8 query heads on the grid) and on float16 caches (the int8 kernels
    take their codes whatever `dtype` says), and at head dims 384, 512 and
    1024 (the wide instances): one launch a call, against the plain
    version, two calls bit-equal."""
    g = torch.Generator(device=dev)
    g.manual_seed(D + H * 3 + Hkv + (dtype == torch.float16))
    wrapper, plain, args = _wide_decode_args(g, dev, kind, D, H, Hkv, dtype)
    before = wrapper.launches
    out = wrapper(*args)
    _check_decode(out, plain(*args), wrapper, before)
    assert torch.equal(out, wrapper(*args))


def test_decode_attention_routes_wide_shapes_to_the_kernels(dev):
    """decode_attention and decode_attention_paged at D = 256 and group 16
    run their kernels on the card (no quiet fallback); a lane-aligned
    head dim past the kernels' cap (D = 1152) raises on the slot and the
    paged routes alike."""
    g = torch.Generator(device=dev)
    wrapper, plain, args = _wide_decode_args(g, dev, "slot", 256, 16, 1,
                                             torch.bfloat16)
    q, k, v, lengths, slots = args
    before = flash_decode.launches
    out = kv_cache.decode_attention(q, k, v, slots, lengths, num_heads=16)
    _check_decode(out, plain(*args), flash_decode, before)
    wrapper, plain, args = _wide_decode_args(g, dev, "paged", 256, 16, 1,
                                             torch.bfloat16)
    q, k, v, tables, lengths = args
    before = flash_decode_paged.launches
    out = kv_cache.decode_attention_paged(q, k, v, tables, lengths,
                                          num_heads=16)
    _check_decode(out, plain(*args), flash_decode_paged, before)
    wide = torch.zeros((2, 4, 1152), dtype=torch.float16, device=dev)
    cache = torch.zeros((2, 16, 2, 1152), dtype=torch.bfloat16, device=dev)
    codes = torch.zeros((2, 16, 2, 1152), dtype=torch.int8, device=dev)
    scales = torch.ones((2, 16, 2), dtype=torch.float32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    tables = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="D=1152"):
        kv_cache.decode_attention(wide, cache, cache, idx, idx, num_heads=4)
    with pytest.raises(NotImplementedError, match="D=1152"):
        kv_cache.decode_attention_paged(wide, cache, cache, tables, idx,
                                        num_heads=4)
    with pytest.raises(NotImplementedError, match="D=1152"):
        kv_cache.decode_attention_paged_quant(wide, codes, codes, scales,
                                              scales, tables, idx,
                                              num_heads=4)


def _gptq_operands(g, dev, N, K, group, mode, seed):
    """Random codes, scales and zeros of a group size and zeros mode
    (rescale: z * s, as a GPTQ import makes them) and an f32 bias."""
    g.manual_seed(seed)
    qw = _words(g, dev, N, K // 8)
    G = K // group
    sc = (torch.rand((G, N), generator=g, device=dev) * 0.05).half()
    zr = torch.randint(0, 16, (G, N), generator=g, device=dev).half()
    if mode == "rescale":
        zr = (zr * sc).half()
    bias = torch.randn(N, generator=g, device=dev)
    return qw, sc, zr, bias


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["original", "rescale"])
@pytest.mark.parametrize("K,group", [(512, 32), (512, 64), (512, 128),
                                     (512, 256), (512, -1), (384, 32),
                                     (384, 64), (384, 128), (384, -1)])
@pytest.mark.parametrize("tile", FUSED_TILES["uint4"])
def test_dequant_matmul_u4_groups_modes_bias(dev, tile, K, group, mode,
                                             bias):
    """GPTQ's groups (32, 64, 128, 256, per channel), both zeros modes and
    a bias on every uint4 instance (K = 384: a tiled slot cut to 128 of
    K): the decode instance within one f16 ulp of each output of the
    split plain version, the tiled instances within one of the plain
    version, both within 4e-3 of the largest output of the plain version;
    two calls bit-equal; each launch counted."""
    grp = K if group == -1 else group
    g = torch.Generator(device=dev)
    N = 384
    qw, sc, zr, b = _gptq_operands(g, dev, N, K, grp, mode,
                                   K + grp + tile[0] + len(mode))
    b = b if bias else None
    decode = tile == U4_DECODE_TILE
    M = 5 if decode else 33
    A = torch.randn((M, K), generator=g, device=dev).half()
    decode_before = dequant_matmul_u4.decode_launches
    tiled_before = dequant_matmul_u4.tiled_launches
    kw = dict(tile=tile, bias=b, zeros_mode=mode)
    out = dequant_matmul_u4(A, qw, sc, zr, grp, **kw)
    again = dequant_matmul_u4(A, qw, sc, zr, grp, **kw)
    ref = dequant_matmul_u4_plain(A, qw, sc, zr, grp, bias=b,
                                  zeros_mode=mode)
    torch.cuda.synchronize()
    assert dequant_matmul_u4.decode_launches == decode_before + 2 * decode
    assert dequant_matmul_u4.tiled_launches == \
        tiled_before + 2 * (not decode)
    assert torch.equal(out, again) and torch.isfinite(out).all()
    tol = 4e-3 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if decode:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        split = dequant_matmul_u4_split_plain(A, qw, sc, zr, sms=sms,
                                              group=grp, bias=b,
                                              zeros_mode=mode)
        assert _f16_ulps(out, split) <= 1
    else:
        assert _f16_ulps(out, ref) <= 1


@pytest.mark.parametrize("mode", ["original", "rescale"])
@pytest.mark.parametrize("group", [32, 64, 4096])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_weight_decode_u4_groups_and_rescale(dev, dtype, group, mode):
    """Kernel 2 at GPTQ's groups (4096: per channel) and rescale, bit for
    bit its plain version."""
    g = torch.Generator(device=dev)
    N, K = 1024, 4096
    qw, sc, zr, _ = _gptq_operands(g, dev, N, K, group, mode, group)
    before = weight_decode_u4.launches
    out = weight_decode_u4(qw, sc, zr, dtype, group=group, zeros_mode=mode)
    ref = weight_decode_u4_plain(qw, sc, zr, dtype, group, mode)
    torch.cuda.synchronize()
    assert weight_decode_u4.launches == before + 1
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.parametrize("M", [4, 64, 512])
def test_matmul_gptq_bias_routes(dev, M):
    """A Matmul at group 64 with a bias on each untuned route (decode
    instance, tiled instance, materialize) against the plain version."""
    cfg = MatmulConfig(M=[M], N=384, K=512, A_dtype="float16",
                       W_dtype="uint4", with_scaling=True, with_zeros=True,
                       zeros_mode="quantized", group_size=64, with_bias=True)
    op = Matmul(cfg, device=dev, enable_tuning=False)
    g = torch.Generator(device=dev)
    qw, sc, zr, b = _gptq_operands(g, dev, 384, 512, 64, "original", M)
    A = torch.randn((M, 512), generator=g, device=dev).half()
    out = op.forward(A, qw, scale=sc, zeros=zr, bias=b.reshape(1, -1))
    ref = dequant_matmul_u4_plain(A, qw, sc, zr, 64, bias=b)
    torch.cuda.synchronize()
    tol = 4e-3 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_dequant_matmul_u4_refuses_groups_no_instance_takes(dev):
    """No fallback: a group no instance takes raises on the card."""
    A = torch.zeros((4, 384), dtype=torch.float16, device=dev)
    qw = torch.zeros((256, 48), dtype=torch.int32, device=dev)
    s = torch.zeros((24, 256), dtype=torch.float16, device=dev)
    before = dequant_matmul_u4.launches
    with pytest.raises(NotImplementedError, match="group size 16"):
        dequant_matmul_u4(A, qw, s, s, 16)
    A = torch.zeros((1, 4160), dtype=torch.float16, device=dev)
    s = torch.zeros((1, 256), dtype=torch.float16, device=dev)
    with pytest.raises(NotImplementedError, match="K=4160"):
        dequant_matmul_u4(A, torch.zeros((256, 520), dtype=torch.int32,
                                         device=dev), s, s, 4160)
    assert dequant_matmul_u4.launches == before


# -- kernels 1 and 2 for every other format with float activations ----------

_FMT_TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _fmt_words(gen, dev, w_dtype, N, K):
    """Random packed words of a format: every code occurs; e5m2's inf /
    NaN codes (exponent 31) are turned into finite ones."""
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    family, bits = source_format_and_bits(w_dtype)
    qw = torch.randint(-2 ** 31, 2 ** 31, (N, K * bits // 32), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    if family == "fp_e5m2":
        b = qw.view(torch.uint8)
        b[(b & 0x7C) == 0x7C] &= 0xBF
    return qw, family, bits


# (N, K, group) shapes: a ragged last N tile and a K tail past the last
# whole step of every width (K = 1408: 2.75 steps of 512), the groups of
# GPTQ (32, 64, 128, per channel), and multiples of 256
_FMT_SHAPES = ((136, 1408, 32), (136, 1408, 64), (136, 1408, 128),
               (136, 1408, 1408), (256, 1536, 256), (256, 1536, 512))


# dequant_matmul_fmt's pairs: FLOAT_PAIRS and uint4 x float16 beyond
# GPTQ's options
_FMT_PAIRS = FLOAT_PAIRS + (("float16", "uint4"),)


@pytest.mark.parametrize("a_dtype,w_dtype", [
    pytest.param(a, w, id=f"{w}x{a}") for a, w in _FMT_PAIRS])
def test_dequant_matmul_fmt_matches_plain(dev, a_dtype, w_dtype):
    """Kernel 1 for each of the new (A, W) pairs on both instances: M = 3
    and 16 on the split-K decode instance (one f16 / bf16 / f32 ulp of
    each output of the split plain version, `out_ulps`), M = 17 and 100 on
    the tiled one (one ulp of the plain version); at every group size,
    scaled or not, zeros modes original and rescale (uint), with and
    without a bias, output in A's type and float32; two calls bit-equal,
    each launch counted by instance and format."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.testing import out_ulps
    adt = _FMT_TORCH[a_dtype]
    fmt = f"{w_dtype}x{a_dtype}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(len(fmt))
    f = dq.dequant_matmul_fmt
    for N, K, g in _FMT_SHAPES:
        qw, family, bits = _fmt_words(gen, dev, w_dtype, N, K)
        sc = (torch.rand((K // g, N), generator=gen, device=dev) * 0.01
              + 0.005).to(adt)
        zr = torch.randint(0, 1 << bits, (K // g, N), generator=gen,
                           device=dev).to(adt)
        bias = torch.randn(N, generator=gen, device=dev)
        opts = [dict(), dict(scales=sc, bias=bias),
                dict(scales=sc, out_dtype=torch.float32)]
        if family == "uint":
            opts += [dict(scales=sc, zeros=zr, bias=bias),
                     dict(scales=sc, zeros=(zr * sc).to(adt),
                          zeros_mode="rescale", out_dtype=torch.float32)]
        for kw in opts:
            if "scales" not in kw and g != K:
                continue   # unscaled: the group changes nothing
            if family == "fp_e5m2" and "scales" not in kw:
                kw = dict(kw, out_dtype=torch.float32)   # |w| <= 57344
            for M in (3, 16, 17, 100):
                A = torch.randn((M, K), generator=gen, device=dev).to(adt)
                before = (f.launches, f.decode_launches, f.tiled_launches,
                          f.format_launches.get(fmt, 0))
                out = f(A, qw, w_dtype, group=g, **kw)
                again = f(A, qw, w_dtype, group=g, **kw)
                decode = M <= 16
                ref = (dq.dequant_matmul_fmt_split_plain if decode
                       else dq.dequant_matmul_fmt_plain)(
                    A, qw, w_dtype, kw.get("scales"), kw.get("zeros"), g,
                    kw.get("bias"), kw.get("zeros_mode", "original"),
                    kw.get("out_dtype"))
                torch.cuda.synchronize()
                assert (f.launches, f.decode_launches, f.tiled_launches,
                        f.format_launches[fmt]) == (
                    before[0] + 2, before[1] + 2 * decode,
                    before[2] + 2 * (not decode), before[3] + 2)
                assert torch.equal(out, again)
                assert out.dtype == ref.dtype
                ulps = out_ulps(out, ref)
                assert ulps <= 1, (N, K, g, sorted(kw), M, ulps)


@pytest.mark.parametrize("a_dtype,w_dtype", [
    pytest.param(a, w, id=f"{w}x{a}") for a, w in _FMT_PAIRS])
def test_fmt_every_code_decodes_as_plain(dev, a_dtype, w_dtype):
    """Every code of each format, unscaled and scaled: kernel 2's decoded
    weight bit-equal to the plain one (NaN codes decode to NaN), and kernel
    1's decoded weight read back through one-hot activations (out[m, n] =
    W[n, k_m] in float32, exactly) on both instances, bit-equal; the
    weight's codes cycle through every value along N and K."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.kernels import materialize as mz
    from bitblas_tpu_torch.quantization import packing
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    adt = _FMT_TORCH[a_dtype]
    family, bits = source_format_and_bits(w_dtype)
    N, K, g = 256, 512, 64
    codes = (torch.arange(N, device=dev)[:, None] * 7
             + torch.arange(K, device=dev)[None, :]) % (1 << bits)
    qw = packing.pack_k(codes, bits)
    gen = torch.Generator(device=dev)
    gen.manual_seed(bits)
    sc = (torch.rand((K // g, N), generator=gen, device=dev) * 0.5
          + 0.25).to(adt)   # e5m2: |w s| stays under f16's maximum
    for scales in (None, sc):
        dec = mz.weight_decode_fmt(qw, w_dtype, a_dtype, scales, None, g)
        want = mz.weight_decode_fmt_plain(qw, w_dtype, a_dtype, scales,
                                          None, g)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(dec), nan)
        assert torch.equal(dec.view(torch.int16)[~nan],
                           want.view(torch.int16)[~nan])
        # kernel 1 reads a finite weight (0 * inf would be NaN): e5m2's
        # exponent-31 codes made finite
        fin_codes = codes
        if family == "fp_e5m2":
            fin_codes = torch.where((codes & 0x7C) == 0x7C, codes & 0xBF,
                                    codes)
        fqw = packing.pack_k(fin_codes, bits)
        fwant = mz.weight_decode_fmt_plain(fqw, w_dtype, a_dtype, scales,
                                           None, g)
        assert torch.isfinite(fwant).all()
        for M in (16, 64):
            ks = torch.arange(M, device=dev) * (K // M) + M % 7
            A = torch.zeros((M, K), device=dev, dtype=adt)
            A[torch.arange(M), ks] = 1
            out = dq.dequant_matmul_fmt(A, fqw, w_dtype, scales, None, g,
                                        out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert torch.equal(out, fwant[:, ks].T.float()), (M, scales is
                                                              None)


@pytest.mark.parametrize("a_dtype,w_dtype", [
    ("float16", "uint1"), ("bfloat16", "nf4"), ("float16", "e5m2_float8"),
    ("bfloat16", "int8")])
def test_fmt_instances_take_any_m(dev, a_dtype, w_dtype):
    """A tuned hint may name either instance at any M: the decode instance
    at M = 40 (three M tiles of 16) and the tiled instance at M = 5, each
    within one ulp of its plain version (the decode instance's split plain
    version), two calls bit-equal."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.testing import out_ulps
    adt = _FMT_TORCH[a_dtype]
    fmt = f"{w_dtype}x{a_dtype}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(40)
    N, K, g = 264, 1536, 64
    qw, _, _ = _fmt_words(gen, dev, w_dtype, N, K)
    sc = (torch.rand((K // g, N), generator=gen, device=dev) * 0.01
          + 0.005).to(adt)
    for M, tile in ((40, dq.FUSED_TILES[fmt][0]), (5, dq.FMT_TILED_TILE)):
        A = torch.randn((M, K), generator=gen, device=dev).to(adt)
        out = dq.dequant_matmul_fmt(A, qw, w_dtype, sc, None, g, tile=tile)
        again = dq.dequant_matmul_fmt(A, qw, w_dtype, sc, None, g, tile=tile)
        ref = (dq.dequant_matmul_fmt_split_plain if M == 40
               else dq.dequant_matmul_fmt_plain)(A, qw, w_dtype, sc, None, g)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert out_ulps(out, ref) <= 1, (M, tile)


# -- the integer column (dequant_matmul_int) ----------------------------------

# (N, K, group): a ragged last N tile, K tails past the last whole step of
# every width (K = 1408: 2.75 steps of 512, 11 of 128), GPTQ's groups
_INT_SHAPES = ((136, 1408, 64), (136, 1408, 128), (136, 1408, 1408),
               (256, 1536, 32), (256, 1536, 512))


def _int_truth(A, qw, w_dtype, sc, zr, g, mode, bias):
    """The float64 sums of A and the weight (v - z) s (rescale v s - z)."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    K = A.shape[1]
    v = dq.decode_int_hopper(qw, w_dtype, torch.float64)
    s = sc.T.double().repeat_interleave(g, dim=1)[:, :K]
    W = v * s
    if zr is not None:
        z = zr.T.double().repeat_interleave(g, dim=1)[:, :K]
        W = W - z if mode == "rescale" else (v - z) * s
    out = A.double() @ W.T
    return out if bias is None else out + bias.double()[None]


def _int_close(out, ref, truth):
    """int8: within 1 of the plain version; a float output within one ulp
    of it, or nearer the float64 truth than it is."""
    from bitblas_tpu_torch.testing import out_ulps
    if out.dtype == torch.int8:
        return (out.int() - ref.int()).abs().max().item() <= 1
    if out_ulps(out, ref) <= 1:
        return True
    return ((out.double() - truth).abs().max()
            <= (ref.double() - truth).abs().max()).item()


@pytest.mark.parametrize("w_dtype", ["uint1", "uint2", "uint4", "int1",
                                     "int2", "int4"])
def test_dequant_matmul_int_matches_plain(dev, w_dtype):
    """Kernel 1 for int8 activations on both instances: M = 1 and 16 on the
    split-K decode instance, bit-equal to the split plain version; M = 17
    and 256 on the tiled one, bit-equal to the plain version unscaled,
    scaled `_int_close`; unscaled (float32, float16, int32, int8 outputs,
    a bias), scaled (float32, float16, int8, a bias), uint also with
    zeros original and rescale; two calls bit-equal, each launch counted
    by instance and format."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    fmt = f"{w_dtype}xint8"
    gen = torch.Generator(device=dev)
    gen.manual_seed(len(w_dtype))
    f = dq.dequant_matmul_int
    for N, K, g in _INT_SHAPES:
        qw, family, bits = _fmt_words(gen, dev, w_dtype, N, K)
        sc = (torch.rand((K // g, N), generator=gen, device=dev) * 0.01
              + 0.005).half()
        zr = torch.randint(0, 1 << bits, (K // g, N), generator=gen,
                           device=dev).half()
        bias = torch.randn(N, generator=gen, device=dev) * 4
        opts = [dict(out_dtype=t) for t in (torch.float32, torch.float16,
                                            torch.int32, torch.int8)]
        opts += [dict(bias=bias, out_dtype=torch.int8),
                 dict(scales=sc), dict(scales=sc, out_dtype=torch.float16),
                 dict(scales=sc, bias=bias, out_dtype=torch.int8)]
        if family == "uint":
            opts += [dict(scales=sc, zeros=zr, bias=bias),
                     dict(scales=sc, zeros=(zr * sc).half(),
                          zeros_mode="rescale", out_dtype=torch.int8)]
        for kw in opts:
            if "scales" not in kw and g != K:
                continue   # unscaled: the group changes nothing
            for M in (1, 16, 17, 256):
                A = torch.randint(-32, 32, (M, K), generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int8)
                before = (f.launches, f.decode_launches, f.tiled_launches,
                          f.format_launches.get(fmt, 0))
                out = f(A, qw, w_dtype, group=g, **kw)
                again = f(A, qw, w_dtype, group=g, **kw)
                decode = M <= 16
                args = (A, qw, w_dtype, kw.get("scales"), kw.get("zeros"), g,
                        kw.get("bias"), kw.get("zeros_mode", "original"),
                        kw.get("out_dtype", torch.float32))
                ref = (dq.dequant_matmul_int_split_plain if decode
                       else dq.dequant_matmul_int_plain)(*args)
                torch.cuda.synchronize()
                assert (f.launches, f.decode_launches, f.tiled_launches,
                        f.format_launches[fmt]) == (
                    before[0] + 2, before[1] + 2 * decode,
                    before[2] + 2 * (not decode), before[3] + 2)
                assert torch.equal(out, again)
                assert out.dtype == ref.dtype
                what = (N, K, g, sorted(kw), M)
                if decode or "scales" not in kw:
                    assert torch.equal(out, ref), what
                else:
                    truth = _int_truth(A, qw, w_dtype, kw["scales"],
                                       kw.get("zeros"), g,
                                       kw.get("zeros_mode"), kw.get("bias"))
                    assert _int_close(out, ref, truth), what


@pytest.mark.parametrize("w_dtype", ["uint1", "uint2", "uint4", "int1",
                                     "int2", "int4"])
def test_int_every_code_reads_back(dev, w_dtype):
    """Every code of each weight through one-hot int8 activations: out[m,
    n] = v[n, k_m] (int32, exactly) on both instances, the codes cycling
    through every value along N and K; and with unit scales (float32
    out) the same values."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.quantization import packing
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    bits = source_format_and_bits(w_dtype)[1]
    N, K, g = 256, 1024, 64
    codes = (torch.arange(N, device=dev)[:, None] * 7
             + torch.arange(K, device=dev)[None, :]) % (1 << bits)
    qw = packing.pack_k(codes, bits)
    v = dq.decode_int_hopper(qw, w_dtype, torch.int32)
    assert v.unique().numel() == 1 << bits
    ones = torch.ones((K // g, N), device=dev, dtype=torch.float16)
    for M in (16, 64):
        ks = torch.arange(M, device=dev) * (K // M) + M % 7
        A = torch.zeros((M, K), device=dev, dtype=torch.int8)
        A[torch.arange(M), ks] = 1
        out = dq.dequant_matmul_int(A, qw, w_dtype, out_dtype=torch.int32)
        scaled = dq.dequant_matmul_int(A, qw, w_dtype, ones, None, g)
        torch.cuda.synchronize()
        assert torch.equal(out, v[:, ks].T), M
        assert torch.equal(scaled, v[:, ks].T.float()), M


@pytest.mark.parametrize("w_dtype", ["uint4", "int1"])
def test_int_instances_take_any_m(dev, w_dtype):
    """A tuned hint may name either instance at any M: the decode instance
    at M = 40 (three M tiles of 16) bit-equal to its split plain version,
    the tiled instance at M = 5 `_int_close` to the plain version."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    fmt = f"{w_dtype}xint8"
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    N, K, g = 264, 1536, 128
    qw, _, _ = _fmt_words(gen, dev, w_dtype, N, K)
    sc = (torch.rand((K // g, N), generator=gen, device=dev) * 0.01
          + 0.005).half()
    for M, tile in ((40, dq.FUSED_TILES[fmt][0]), (5, dq.INT_TILED_TILE)):
        A = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int8)
        out = dq.dequant_matmul_int(A, qw, w_dtype, sc, None, g, tile=tile)
        again = dq.dequant_matmul_int(A, qw, w_dtype, sc, None, g, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        if M == 40:
            ref = dq.dequant_matmul_int_split_plain(A, qw, w_dtype, sc, None,
                                                    g)
            assert torch.equal(out, ref)
        else:
            ref = dq.dequant_matmul_int_plain(A, qw, w_dtype, sc, None, g)
            truth = _int_truth(A, qw, w_dtype, sc, None, g, None, None)
            assert _int_close(out, ref, truth)


def test_matmul_int_routes(dev):
    """Untuned Matmul routes of an int8 x uint2 layer: the decode instance
    at M = 16, the tiled one at 17, materialize from 512 where the
    configuration allows it (per channel, no zeros; kernel 3 then
    torch._int_mm), and the fused kernel at 512 where it does not
    (grouped); each as its plain version."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    N, K = 1024, 2048
    qw = _words(gen, dev, N, K // 16)
    for group in (-1, 128):
        g = K if group == -1 else group
        pm = Matmul(MatmulConfig(N=N, K=K, A_dtype="int8", W_dtype="uint2",
                                 with_scaling=True, group_size=group,
                                 out_dtype="float32"), device=dev,
                    enable_tuning=False)
        sc = (torch.rand((K // g, N), generator=gen, device=dev) * 0.01
              + 0.005).half()
        A = torch.randint(-64, 64, (512, K), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int8)
        for m, route in ((16, "decode"), (17, "tiled"),
                         (512, "materialize" if group == -1 else "tiled")):
            f = dq.dequant_matmul_int
            before = (f.decode_launches, f.tiled_launches,
                      weight_decode_int8.launches)
            out = pm.forward(A[:m], qw, scale=sc)
            torch.cuda.synchronize()
            after = (f.decode_launches, f.tiled_launches,
                     weight_decode_int8.launches)
            delta = tuple(a - b for a, b in zip(after, before))
            assert delta == {"decode": (1, 0, 0), "tiled": (0, 1, 0),
                             "materialize": (0, 0, 1)}[route], (group, m)
            ref = dq.dequant_matmul_int_plain(A[:m], qw, "uint2", sc, None,
                                              g)
            truth = _int_truth(A[:m], qw, "uint2", sc, None, g, None, None)
            assert _int_close(out, ref, truth), (group, m)


def test_int8_output_rounds_ties_to_even(dev):
    """Scales of 0.5 make every odd integer sum a tie (k + 0.5, exact in
    float32): both instances' saturating int8 outputs (cvt.rni, then the
    clamp) equal the plain version's torch.round bit for bit, ties and
    clamped outputs included."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    N, K = 256, 2048
    qw = _words(gen, dev, N, K // 16)
    sc = torch.full((1, N), 0.5, device=dev, dtype=torch.float16)
    for M in (16, 64):
        A = torch.randint(-2, 3, (M, K), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int8)
        d = dq.dequant_matmul_int_plain(A, qw, "uint2",
                                        out_dtype=torch.int32)
        assert ((d % 2 != 0) & (d.abs() < 255)).sum() > 100
        assert (d.abs() > 256).any()
        out = dq.dequant_matmul_int(A, qw, "uint2", sc, None, K,
                                    out_dtype=torch.int8)
        ref = dq.dequant_matmul_int_plain(A, qw, "uint2", sc, None, K,
                                          out_dtype=torch.int8)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), M


# bfloat16 and sliding windows in kernels 4-8. The prefill's P rounds to
# bfloat16 before P V (2^-8 of each weight) and its output rounds once:
# 2^-5 on outputs |.| < 4. A bfloat16 decode output is one bfloat16
# rounding (2^-6 of |.| < 4) beyond DECODE_TOL's float32 differences.
# Each element is held to its own size as well (testing.attention_err):
# one ulp of the output type of |ref| plus a floor of the row's rms, 4 ulps
# for the prefill (a sum of per-key roundings of P, about 2^-9 of the
# row's rms in bfloat16) and 1 ulp for the decode kernels (float32 P, as
# their plain versions). The absolute limits alone would let a band row,
# which averages up to `window` keys and is small, be wrong by its size.
BF16_PREFILL_TOL = 2.0 ** -5
BF16_DECODE_TOL = DECODE_TOL + 2.0 ** -6
WINDOWS = (1, 63, 64, 65, 100000)


def _prefill_err(out, ref):
    u = ATTN_ULP[out.dtype]
    return attention_err(out, ref, u, 4 * u)


def _decode_err(out, ref):
    u = ATTN_ULP[out.dtype]
    return attention_err(out, ref, u, u)


def _qkv(gen, dev, S, H, Hkv, dtype):
    Q = torch.randn((1, S, H, 128), generator=gen, device=dev).to(dtype)
    K = (torch.randn((1, S, Hkv, 128), generator=gen, device=dev) * 3) \
        .to(dtype)
    V = torch.randn((1, S, Hkv, 128), generator=gen, device=dev).to(dtype)
    return Q, K, V


@pytest.mark.parametrize("S", [64, 256, 1024])
@pytest.mark.parametrize("Hkv", [8, 2])
def test_flash_attention_bf16_matches_plain(dev, S, Hkv):
    g = torch.Generator(device=dev)
    g.manual_seed(S + Hkv)
    Q, K, V = _qkv(g, dev, S, 8, Hkv, torch.bfloat16)
    before = flash_attention_fwd.variant_launches.get("bfloat16", 0)
    out = flash_attention_fwd(Q, K, V)
    ref = flash_attention_plain(Q, K, V)
    torch.cuda.synchronize()
    assert flash_attention_fwd.variant_launches["bfloat16"] == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_PREFILL_TOL
    assert _prefill_err(out, ref) <= 1.0
    assert torch.equal(out, flash_attention_fwd(Q, K, V))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("S", [64, 128, 256, 1024])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_flash_attention_window_matches_plain(dev, dtype, S, window):
    """The banded walk: KV tiles from the band's first, the lower mask on
    band-edge tiles; windows 63 and 64 give rows whose first tile is all
    masked (no NaN); a window >= S is the windowless call bit for bit."""
    g = torch.Generator(device=dev)
    g.manual_seed(S * 7 + window % 997)
    Q, K, V = _qkv(g, dev, S, 4, 2, dtype)
    out = flash_attention_fwd(Q, K, V, window=window)
    ref = flash_attention_plain(Q, K, V, min(window, S))
    torch.cuda.synchronize()
    tol = BF16_PREFILL_TOL if dtype == torch.bfloat16 else 1e-2
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert _prefill_err(out, ref) <= 1.0
    assert torch.equal(out, flash_attention_fwd(Q, K, V, window=window))
    if window >= S:
        assert torch.equal(out, flash_attention_fwd(Q, K, V))


def _window_slot_case(gen, dev, quant, window, Smax=2048, H=8, Hkv=2):
    w = min(window, Smax)
    lens = sorted({0, 1, max(w - 1, 1), w, min(w + 1, Smax), 1000, Smax})
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    slots = torch.randperm(B + 1, generator=gen, device=dev)[:B] \
        .to(torch.int32)
    kf, vf = _rows(gen, dev, (B + 1, Smax, Hkv, 128))
    if quant:
        (k, ks), (v, vs) = kv_cache.quantize_kv(kf), kv_cache.quantize_kv(vf)
        caches = [k, v, ks, vs]
        stale = ((k, 127), (v, -128), (ks, float("nan")),
                 (vs, float("nan")))
    else:
        caches = [kf.to(torch.bfloat16), vf.to(torch.bfloat16)]
        stale = ((caches[0], float("nan")), (caches[1], float("nan")))
    for x, val in stale:
        for b in range(B):
            x[slots[b], lens[b]:] = val
    return caches, lengths, slots


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("qdtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_window_matches_plain(dev, quant, qdtype, window):
    """Kernels 5 and 6 with a window, float16 and bfloat16 queries, at
    lengths window - 1, window and window + 1 over Smax = 2048: the splits
    cover the live band (from 64 floor((len - window) / 64)), NaN rows
    past each length are never read, a split with no live key weighs 0;
    the single-pass and the split plain versions agree, two calls are
    bit-equal, and a window >= Smax is the windowless call bit for bit."""
    g = torch.Generator(device=dev)
    g.manual_seed(500 + window % 997 + 7 * quant)
    caches, lengths, slots = _window_slot_case(g, dev, quant, window)
    q = _decode_q(g, dev, len(lengths), 8).to(qdtype)
    kernel = flash_decode_quant if quant else flash_decode
    plain = flash_decode_quant_plain if quant else flash_decode_plain
    key = str(qdtype).split(".")[-1] + ("" if window >= 2048 else " window")
    before = kernel.variant_launches.get(key, 0)
    out = kernel(q, *caches, lengths, slots, window=window)
    ref = plain(q, *caches, lengths, slots, window)
    scales = dict(k_scale=caches[2], v_scale=caches[3]) if quant else {}
    split = flash_decode_split_plain(
        q, caches[0], caches[1], lengths, slots, window=window,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count,
        **scales)
    torch.cuda.synchronize()
    assert kernel.variant_launches[key] == before + 1
    assert out.dtype == qdtype and torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # length 0
    tol = BF16_DECODE_TOL if qdtype == torch.bfloat16 else DECODE_TOL
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out.float() - split.float()).abs().max().item() <= tol
    assert _decode_err(out, ref) <= 1.0
    assert _decode_err(out, split) <= 1.0
    assert torch.equal(out, kernel(q, *caches, lengths, slots,
                                   window=window))
    if window >= 2048:
        assert torch.equal(out, kernel(q, *caches, lengths, slots))


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_paged_bf16_query(dev, quant):
    """Kernels 7 and 8 on bfloat16 queries (no window: a windowed paged
    decode takes the masked gather, as in the JAX package)."""
    g = torch.Generator(device=dev)
    g.manual_seed(600 + quant)
    B = len(LENGTHS)
    k, v, ks, vs, tables, lengths = _pool(g, dev, B, 16, 2, quant)
    q = _decode_q(g, dev, B, 8).to(torch.bfloat16)
    pools = (k, v, ks, vs) if quant else (k, v)
    kernel = flash_decode_paged_quant if quant else flash_decode_paged
    plain = flash_decode_paged_quant_plain if quant \
        else flash_decode_paged_plain
    before = kernel.launches
    out = kernel(q, *pools, tables, lengths)
    ref = plain(q, *pools, tables, lengths)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_DECODE_TOL
    assert _decode_err(out, ref) <= 1.0
    gathers = kv_cache.decode_attention_paged.window_gathers
    windowed = (kv_cache.decode_attention_paged_quant if quant
                else kv_cache.decode_attention_paged)(
        q, *pools, tables, lengths, num_heads=8, window=64)
    assert kernel.launches == before + 1      # the gather, not the kernel
    assert torch.equal(windowed, plain(q, *pools, tables, lengths, 64))
    assert quant or kv_cache.decode_attention_paged.window_gathers \
        == gathers + 1


# Kernel 4's configuration surface: every head dim, both KV tiles, the
# dense walk, K^T, a ragged S over two sequences (rows past S come from
# TMA's zero fill, not the next sequence), float32 operands (the FFMA
# kernel) and outputs in another type. (D, S, H, Hkv, causal, trans_k,
# window, dtype, out, block_kv); a block_kv the head dim does not build
# (128 keys outside head dim 64) takes 64.
FA_CASES = [
    (160, 4, 2, True, False, None, "float16", None, 64),
    (160, 4, 2, False, False, None, "bfloat16", None, 128),
    (256, 2, 2, True, True, None, "float16", None, 128),
    (200, 4, 4, False, True, None, "bfloat16", None, 64),
    (256, 4, 2, True, False, 65, "bfloat16", None, 128),
    (512, 2, 2, True, False, None, "float16", "float32", 64),
    (96, 4, 2, False, False, None, "float16", "bfloat16", 128),
    (161, 2, 1, False, True, None, "float32", None, 64),
    (100, 4, 2, True, False, 33, "float32", "bfloat16", 64),
]


def _fa_ulp(dtype, out):
    """The element-wise limit's unit: the coarser of the operands' type
    (the kernel rounds P to it) and the output's; float32 operands sum
    in other orders: 2^-18."""
    return max(ATTN_ULP.get(d, 2.0 ** -18) for d in (dtype, out))


@pytest.mark.parametrize("case", FA_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
@pytest.mark.parametrize("D", [64, 80, 96, 100, 128, 256])
def test_flash_attention_configs_match_plain(dev, D, case):
    S, H, Hkv, causal, trans_k, window, dtype, out, bkv = case
    if (H * D * 2) % 16 and dtype != "float32":
        H, Hkv = 2 * H, 2 * Hkv           # D = 100 takes even head counts
    dt, ot = getattr(torch, dtype), getattr(torch, out or dtype)
    tile = (64, bkv) if (64, bkv) in prefill_tiles(D, dt) else (64, 64)
    g = torch.Generator(device=dev)
    g.manual_seed(D * 1000 + S)
    B = 2
    Q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    K = (torch.randn((B, S, Hkv, D), generator=g, device=dev) * 3).to(dt)
    V = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dt)
    if trans_k:
        K = K.permute(0, 3, 2, 1).contiguous()
    kw = dict(causal=causal, trans_k=trans_k, out_dtype=ot, tile=tile)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(Q, K, V, window, **kw)
    ref = flash_attention_plain(Q, K, V, window, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == ot and torch.isfinite(got).all()
    u = _fa_ulp(dt, ot)
    assert attention_err(got, ref, u, 4 * u) <= 1.0
    assert torch.equal(got, flash_attention_fwd(Q, K, V, window, **kw))


@pytest.mark.parametrize("quant", [False, True])
def test_partial_stats_kernels_match_plain(dev, quant):
    """Kernels 5 and 6 in partial_stats mode against their plain version
    (span 2048: several splits a sequence, merged in the launch; an empty
    sequence gives m = -1e30 ln 2, l = 0): m to 1e-3, acc and l to 1e-4 of
    their largest value (the same f32 arithmetic regrouped by split)."""
    from bitblas_tpu_torch.kernels.flash import (EMPTY_M, LN2,
                                                 flash_decode_partial_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, Hkv, D, Smax = 4, 8, 2, 128, 2048
    q = torch.randn((B, H, D), generator=g, device=dev).half()
    k = (20 * torch.randn((B, Smax, Hkv, D), generator=g,
                          device=dev)).to(torch.bfloat16)
    v = torch.randn((B, Smax, Hkv, D), generator=g,
                    device=dev).to(torch.bfloat16)
    lengths = torch.tensor([0, 1, 1500, 2048], dtype=torch.int32, device=dev)
    slots = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=dev)
    if quant:
        kq, ks = kv_cache.quantize_kv(k.float())
        vq, vs = kv_cache.quantize_kv(v.float())
        got = flash_decode_quant(q, kq, vq, ks, vs, lengths, slots,
                                 partial_stats=True)
        want = flash_decode_partial_plain(q, kq, vq, lengths, slots, ks, vs)
    else:
        got = flash_decode(q, k, v, lengths, slots, partial_stats=True)
        want = flash_decode_partial_plain(q, k, v, lengths, slots)
    torch.cuda.synchronize()
    for name, a, b, lim in (("m", got[1], want[1], 1e-3),
                            ("l", got[2], want[2], 1e-4),
                            ("acc", got[0], want[0], 1e-4)):
        tol = lim if name == "m" else lim * b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= tol, (name, err, tol)
    assert torch.all(got[1][0] == torch.tensor(EMPTY_M, device=dev) * LN2)
    assert torch.all(got[2][0] == 0) and torch.all(got[0][0] == 0)


# Kernel 4's general instance: (D, S, H, Hkv, causal, trans_k, window,
# dtype, out). Head dims outside the wgmma instances up to the cap, odd
# head counts at D % 8 == 4, K^T at S % 8 != 0, a window and GQA.
GENERAL_CASES = [
    (16, 200, 4, 2, True, False, None, "float16", None),
    (48, 130, 3, 3, False, False, None, "bfloat16", "float32"),
    (160, 300, 4, 2, True, False, 70, "bfloat16", None),
    (384, 257, 2, 1, True, False, None, "float16", None),
    (512, 256, 4, 2, False, True, None, "bfloat16", None),
    (768, 130, 2, 2, True, False, None, "float16", "bfloat16"),
    (100, 192, 3, 3, True, False, None, "float16", None),
    (100, 161, 5, 1, False, True, None, "bfloat16", None),
    (128, 161, 4, 2, True, True, None, "float16", None),
    # the configurations of chip_smoke.py's slice19_prefill rows, S = 2048
    (512, 2048, 8, 8, True, False, None, "float16", None),
    (160, 2048, 8, 8, True, False, None, "bfloat16", None),
    (100, 2048, 25, 25, True, False, None, "float16", None),
    (128, 2047, 8, 8, True, True, None, "float16", None),
    # the float32 kernel at the head dims it takes since the general one:
    # D % 4 != 0, past 256 (128-column chunks), up to the cap
    (6, 200, 2, 1, True, False, 33, "float32", None),
    (288, 130, 2, 2, False, True, None, "float32", "float16"),
    (768, 100, 2, 1, True, False, None, "float32", None),
]


@pytest.mark.parametrize("case", GENERAL_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_flash_attention_general_matches_plain(dev, case):
    from bitblas_tpu_torch.kernels.flash import HEAD_DIMS, prefill_instance
    D, S, H, Hkv, causal, trans_k, window, dtype, out = case
    dt, ot = getattr(torch, dtype), getattr(torch, out or dtype)
    # the stride-only shapes take the layout pass into a wgmma instance
    instance = "f32" if dtype == "float32" else "aligned" \
        if D in HEAD_DIMS else "general"
    assert prefill_instance(S, H, Hkv, D, dt, trans_k=trans_k) == instance
    g = torch.Generator(device=dev)
    g.manual_seed(D * 1000 + S)
    B = 2
    Q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    K = (torch.randn((B, S, Hkv, D), generator=g, device=dev) * 3).to(dt)
    V = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dt)
    if trans_k:
        K = K.permute(0, 3, 2, 1).contiguous()
    kw = dict(causal=causal, trans_k=trans_k, out_dtype=ot)
    before = flash_attention_fwd.launches
    variants = dict(flash_attention_fwd.variant_launches)
    got = flash_attention_fwd(Q, K, V, window, **kw)
    ref = flash_attention_plain(Q, K, V, window, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    new = {k for k, n in flash_attention_fwd.variant_launches.items()
           if n != variants.get(k, 0)}
    assert len(new) == 1 and (f" {instance} " in new.pop() + " ") == (
        instance != "f32")
    assert got.dtype == ot and torch.isfinite(got).all()
    u = _fa_ulp(dt, ot)
    assert attention_err(got, ref, u, 4 * u) <= 1.0
    assert torch.equal(got, flash_attention_fwd(Q, K, V, window, **kw))


@pytest.mark.parametrize("D,H,Hkv,trans_k", [(80, 4, 2, False),
                                             (80, 6, 3, True),
                                             (100, 3, 3, False),
                                             (160, 4, 2, False)])
def test_flash_attention_neighbour_heads_do_not_leak(dev, D, H, Hkv,
                                                     trans_k):
    """The wgmma boxes read the next head's columns (and TMA's zeros past
    the last head); only Q's zeroed columns and the clipped store keep
    them out. With the last KV head's K and V all Inf, every query head
    of the other KV heads matches the plain version on finite data; and
    the last head itself, where the boxes run past the row, is held on
    data whose first head is Inf instead."""
    dt = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(D + H)
    S, group = 256, H // Hkv
    Q = torch.randn((1, S, H, D), generator=g, device=dev).to(dt)
    K = (torch.randn((1, S, Hkv, D), generator=g, device=dev) * 3).to(dt)
    V = torch.randn((1, S, Hkv, D), generator=g, device=dev).to(dt)
    u = _fa_ulp(dt, dt)
    for bad, keep in ((Hkv - 1, slice(0, (Hkv - 1) * group)),
                      (0, slice(group, H))):
        Kb, Vb = K.clone(), V.clone()
        Kb[:, :, bad] = float("inf")
        Vb[:, :, bad] = float("inf")
        Kin = Kb.permute(0, 3, 2, 1).contiguous() if trans_k else Kb
        got = flash_attention_fwd(Q, Kin, Vb, 64, trans_k=trans_k)
        ref = flash_attention_plain(
            Q, K.permute(0, 3, 2, 1).contiguous() if trans_k else K, V, 64,
            trans_k=trans_k)
        torch.cuda.synchronize()
        assert torch.isfinite(got[:, :, keep]).all()
        assert attention_err(got[:, :, keep].contiguous(),
                             ref[:, :, keep].contiguous(), u, 4 * u) <= 1.0


@pytest.mark.parametrize("kind", ["slot", "slot_quant"])
@pytest.mark.parametrize("D", [384, 512])
def test_flash_decode_wide_window_and_partials(dev, kind, D):
    """The slot kernels' wide instances with a window of 64 (the splits
    start at each sequence's band), and in partial_stats mode (m to 1e-3,
    acc and l to 1e-4 of their largest), against the plain versions."""
    from bitblas_tpu_torch.kernels.flash import flash_decode_partial_plain
    g = torch.Generator(device=dev)
    g.manual_seed(D + len(kind))
    wrapper, plain, args = _wide_decode_args(g, dev, kind, D, 8, 2,
                                             torch.bfloat16)
    before = wrapper.launches
    out = wrapper(*args, window=64)
    ref = plain(*args, 64)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_TOL
    q, *caches, lengths, slots = args
    got = wrapper(*args, partial_stats=True)
    scales = tuple(caches[2:])
    want = flash_decode_partial_plain(q, caches[0], caches[1], lengths,
                                      slots, *scales)
    torch.cuda.synchronize()
    for name, a, b, lim in (("m", got[1], want[1], 1e-3),
                            ("l", got[2], want[2], 1e-4),
                            ("acc", got[0], want[0], 1e-4)):
        tol = lim if name == "m" else lim * b.abs().max().item()
        assert (a - b).abs().max().item() <= tol, name


def test_flashatten_tunes_the_new_instances(dev):
    """FlashAtten's hardware_aware_finetune on the d80 instance and on the
    general instance (K^T at S % 8 != 0): each has one tile, which it
    times and pins; the forward matches the plain version."""
    from bitblas_tpu_torch.ops import FlashAtten, FlashAttenConfig
    for cfg in (dict(batch=1, heads=4, kv_heads=2, seq_len=256, dim=80,
                     is_causal=True, Q_dtype="bfloat16",
                     Out_dtype="bfloat16"),
                dict(batch=1, heads=4, seq_len=201, dim=64, layout="ntn")):
        op = FlashAtten(FlashAttenConfig(**cfg), device="cuda",
                        enable_tuning=True)
        assert list(op.tune_results) == list(op.candidates) == [(64, 64)]
        assert op.tuned_hints
        Q, K, V = op._example_args()
        got = op(Q, K, V)
        ref = flash_attention_plain(Q, K, V, causal=op.config.is_causal,
                                    trans_k=op.trans_k)
        torch.cuda.synchronize()
        u = _fa_ulp(op.dtype, op.out_dtype)
        assert attention_err(got, ref, u, 4 * u) <= 1.0


# The float32 kernel's 3xTF32 products at scores of a few hundred (K
# amplified 20x), where a fault in P's fragment layout or a dropped product
# term shows: held to 2e-5 of a float64 truth (the float32 limit of the
# CPU tests against JAX, tests/test_torch_flash_f32x3.py). The float32
# plain version strays past 2^-18 ulp of that truth at these scores, so
# the truth and not the plain version is the reference here.
F32_AMPLIFIED_ATOL = 2e-5


@pytest.mark.parametrize("trans_k", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [6, 128, 288])
def test_flash_attention_f32_amplified_keys(dev, D, causal, trans_k):
    from bitblas_tpu_torch.kernels.flash import LOG2E
    g = torch.Generator(device=dev)
    g.manual_seed(D * 4 + 2 * causal + trans_k)
    S, H, Hkv = 200, 4, 2
    Q = torch.randn((1, S, H, D), generator=g, device=dev)
    K = torch.randn((1, S, Hkv, D), generator=g, device=dev) * 20
    V = torch.randn((1, S, Hkv, D), generator=g, device=dev)
    Kin = K.permute(0, 3, 2, 1).contiguous() if trans_k else K
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(Q, Kin, V, causal=causal, trans_k=trans_k)
    q = Q.double() * (LOG2E / math.sqrt(D))
    k, v = (x.double().repeat_interleave(H // Hkv, 2) for x in (K, V))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=dev)
                          .triu(1), float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    truth = torch.einsum("bhqk,bkhd->bqhd", p, v) \
        / p.sum(-1).permute(0, 2, 1)[..., None]
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert (got.double() - truth).abs().max().item() <= F32_AMPLIFIED_ATOL


# A NaN in Q (query row 70), K or V (key 0, which every query attends) of
# one head, as CUDA's 0x7fffffff (what 0 / 0 gives) or -NaN (0xffffffff),
# written on the card: the TF32 split must carry it to the output wherever
# the plain version's output has one, and leave the rest as it was.
@pytest.mark.parametrize("bits", [0x7FFFFFFF, -1])
@pytest.mark.parametrize("where", ["q", "k", "v"])
@pytest.mark.parametrize("D", [128, 288])
def test_flash_attention_f32_keeps_nan(dev, D, where, bits):
    g = torch.Generator(device=dev)
    g.manual_seed(D + len(where))
    S, H, Hkv = 200, 4, 2
    Q, K, V = (torch.randn((1, S, h, D), generator=g, device=dev)
               for h in (H, Hkv, Hkv))
    x = {"q": Q, "k": K, "v": V}[where]
    x.view(torch.int32)[0, 70 if where == "q" else 0, 1, 5] = bits
    assert torch.isnan(x).sum().item() == 1
    got = flash_attention_fwd(Q, K, V, causal=True)
    ref = flash_attention_plain(Q, K, V, causal=True)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    assert (got[~nan] - ref[~nan]).abs().max().item() <= 1e-5

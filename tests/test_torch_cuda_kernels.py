"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no interpret mode, so every test here needs an NVIDIA
GPU with nvcc and skips elsewhere. Run on the card with
``python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py``
(the suite's conftest imports JAX, which the GPU host need not have).
Shapes are small but cover the edges: ragged N and M tiles, GQA groups
1 to 8, stale NaN rows (and NaN scales) past each length and in the
reserved block 0, a length of 0, block sizes 16 and 128 over permuted
tables, and K amplified 20x so that a head mix-up cannot hide in a
near-uniform softmax.
"""

import math

import pytest
import torch

from bitblas_tpu_torch.kernels.dequant_matmul import (
    dequant_matmul_u4, dequant_matmul_u4_plain)
from bitblas_tpu_torch.kernels.flash import (
    flash_attention_fwd, flash_attention_plain, flash_decode,
    flash_decode_paged, flash_decode_paged_plain, flash_decode_paged_quant,
    flash_decode_paged_quant_plain, flash_decode_plain, flash_decode_quant,
    flash_decode_quant_plain)
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

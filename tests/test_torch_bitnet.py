"""The port's BitNet b1.58 path (models/bitnet.py, integration/bitnet.py,
convert.from_jax_bitnet_state) against the JAX package, on the CPU.

Fixture: hidden 256, 2 heads / 1 KV head (head dim 128, GQA 2, so both
flash paths are live), intermediate 512, 2 layers, vocab 64. The JAX
model's ternarized weights are carried across with
`convert.from_jax_bitnet_state`; the JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.

Tolerances. Quantization is bit-identical (same float32 formulas, round
half to even). A BitLinear is exact on both sides: int8 x int2 products
summed in integers, rescaled by the same float32 ``acc / (sw * s_a)``, so
its outputs are compared bit for bit. A whole layer adds f16 activations,
attention (the flash kernels round P differently) and the next
activation's absmax quantization, whose per-token scale follows the
largest element: a one-ulp difference there moves a code by one step.
Without flash the two packages' 2-layer hidden states differ by 1.8e-4
(about one f16 ulp); the flash kernels round P differently and take that
to 1.1e-3 -- an absolute error of the attention output, which does not
shrink with this random model's small hidden states (rms 0.05, |.| <
0.25). Hidden states are held to atol 2e-3. The LM head's RMSNorm scales
the hidden state up ~20x, so logits (|.| < 3, measured error 0.012) are
held to 2e-2 x max |logit|, chip_smoke.py's bound for logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.integration.bitnet import \
    BitLinearBitBLAS as JaxBitLinearBitBLAS
from bitblas_tpu.models import BitNetLlama as JaxBitNetLlama
from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import bitnet as jbn
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.serving import \
    TokenContinuousBatchingEngine as JaxTokenEngine

from bitblas_tpu_torch import convert
from bitblas_tpu_torch.integration.bitnet import BitLinearBitBLAS
from bitblas_tpu_torch.models import bitnet as pbn
from bitblas_tpu_torch.models.hf_import import LMHead
from bitblas_tpu_torch.models.quant_llama import LlamaConfig
from bitblas_tpu_torch.quantization import packing
from bitblas_tpu_torch.serving.engine import TokenContinuousBatchingEngine
from bitblas_tpu_torch.testing import assert_close

V, H = 64, 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=2,
           num_kv_heads=1, num_layers=2, vocab_size=V, group_size=128)
HIDDEN_ATOL = 2e-3
LOGIT_RTOL = 2e-2     # of max |logit|


def _bits(x):
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[x.itemsize])


def _synchronous(engine):
    """A JAX engine whose decode steps finish before they return (see
    test_torch_serving.py: the JAX engines mutate host arrays that a
    queued step may still read)."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


def _tie_rows(dtype):
    """Rows whose absmax is 127 (so the scale is exactly 1): .5 ties of
    both parities and signs, a clamp at -128's edge, and an all-zero row."""
    x = np.zeros((3, 16), np.float32)
    x[0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5, -126.5, 126.5,
            0.49, -0.51, 7.0, -127, 0]
    x[1] = np.random.default_rng(0).standard_normal(16) * 3
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_activation_quant_int8_bit_identical(dtype):
    rng = np.random.default_rng(1)
    x = np.concatenate([_tie_rows(dtype),
                        (rng.standard_normal((5, 16)) * 2).astype(dtype)])
    jq, js = jbn.activation_quant_int8(jnp.asarray(x))
    pq, ps = pbn.activation_quant_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(ps), _bits(np.asarray(js)))
    assert pq[0, :7].tolist() == [127, 0, 2, 2, 0, -2, -2]   # half to even
    assert not pq[2].any()


@pytest.mark.parametrize("case", ["random", "ties", "zeros"])
def test_weight_quant_codes_bit_identical(case):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((32, 48)) * 0.02).astype(np.float32)
    if case == "ties":
        # mean |w| = 1, so sw = 1 and w * sw hits every .5 tie exactly
        w = np.resize(np.array([0.5, -0.5, 1.5, -1.5, 1.0, -1.0, 2.0, 0.0],
                               np.float32), (8, 16))
    elif case == "zeros":
        w = np.zeros((8, 16), np.float32)
    jc, jsw = jbn.weight_quant_codes(w)
    pc, psw = pbn.weight_quant_codes(w)
    assert pc.dtype == np.int8 and np.array_equal(pc, jc)
    assert _bits(np.float32(psw)) == _bits(np.float32(jsw))
    # the tensor path (random init on the card) gives the same codes
    tc, tsw = pbn.weight_quant_codes(torch.from_numpy(w))
    assert np.array_equal(tc.numpy(), pc)
    assert float(tsw) == pytest.approx(float(psw), rel=1e-6)


@pytest.mark.parametrize("fn", ["weight_quant", "activation_quant"])
def test_fake_quant_matches_jax(fn):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 64)) * 0.5).astype(np.float32)
    want = np.asarray(getattr(jbn, fn)(jnp.asarray(x)))
    got = getattr(pbn, fn)(torch.from_numpy(x))
    # the absmean / absmax scale is reduced in another order: ~1 f32 ulp
    assert_close(got, want, rtol=1e-6, atol=1e-7, max_mismatched_ratio=0.0)


@pytest.mark.parametrize("m", [1, 5, 512])
def test_bit_linear_inference_matches_jax(m):
    """Bit for bit: integer sums and the same float32 rescale. M = 512
    takes the port's materialize route (int8 decode + the int product)
    and the JAX fused kernel."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((192, 256)) * 0.02).astype(np.float32)
    x = (rng.standard_normal((m, 256))).astype(np.float16)
    jl = jbn.BitLinearInference.from_weight(w, opt_m=(1, 16))
    pl = pbn.BitLinearInference.from_weight(w, opt_m=(1, 16), device="cpu")
    want = np.asarray(jl(jnp.asarray(x)))
    got = pl(torch.from_numpy(x))
    assert got.dtype == torch.float16 and tuple(got.shape) == (m, 192)
    assert np.array_equal(_bits(got), _bits(want))


def test_bit_linear_bitblas_from_bit_linear_matches_jax():
    torch.manual_seed(0)
    lin = torch.nn.Linear(256, 128, bias=True)
    jl = JaxBitLinearBitBLAS.from_bit_linear(lin)
    pl = BitLinearBitBLAS.from_bit_linear(lin, device="cpu")
    assert torch.equal(pl.qweight, jl.qweight)
    assert torch.equal(pl.sw, jl.sw) and torch.equal(pl.bias, jl.bias)
    assert pl.format == "bitblas"
    x = torch.randn((2, 3, 256))
    want = jl(x)
    got = pl(x)
    assert got.dtype == x.dtype and got.shape == (2, 3, 128)
    assert torch.equal(got, want)
    # a fresh module loads the state dict and rebuilds its operand
    other = BitLinearBitBLAS(256, 128, device="cpu")
    other.load_state_dict(pl.state_dict())
    other.post_init()
    assert torch.equal(other(x), got)


def test_bitnet_projection_undoes_the_tpu_padding():
    """N = 320 is not a multiple of the 512-column int2 pack tile: the
    JAX layout pads it; the converter slices it back."""
    rng = np.random.default_rng(5)
    vals = rng.integers(-2, 2, (320, 256)).astype(np.int8)
    jc = JaxMatmulConfig(M=[1], N=320, K=256, A_dtype="int8",
                         W_dtype="int2", accum_dtype="int32",
                         out_dtype="float32")
    jw = np.asarray(JaxMatmul(jc, enable_tuning=False).transform_weight(vals))
    assert jw.shape == (256, 512 // 4)
    got = convert.bitnet_projection(jw, 320)
    want = packing.pack_k(packing.bias_signed_weight(
        torch.from_numpy(vals), 2), 2)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def pair():
    jm = JaxBitNetLlama(JaxLlamaConfig(**CFG), opt_m=(1, 2, 16))
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V, H)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, H)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((H,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = LlamaConfig(**CFG)
    pm = pbn.BitNetLlama(cfg, device="cpu", seed=77)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(convert.from_jax_bitnet_state(state, cfg))
    ph = LMHead(embed, np.ones(H, np.float32), lm_head, device="cpu")
    return jm, jh, pm, ph, embed


def test_convert_carries_bitnet_weights_across(pair):
    jm, _, pm, _, _ = pair
    rng = np.random.default_rng(6)
    for jl, pl in zip(jm.layers, pm.layers):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            width = 512 if name == "down" else H
            x = rng.standard_normal((3, width)).astype(np.float16)
            want = np.asarray(jl.proj(name, jnp.asarray(x)))
            got = pl.proj(name, torch.from_numpy(x))
            assert np.array_equal(_bits(got), _bits(want)), name
        assert np.array_equal(pl.mlp_norm.numpy(), np.asarray(jl.mlp_norm))


def test_prefill_logits_and_decode_steps_match_jax(pair):
    jm, jh, pm, ph, embed = pair
    S, bucket = 200, 256
    toks = np.random.default_rng(7).integers(0, V, S)
    x = np.zeros((1, bucket, H), np.float16)
    x[0, :S] = embed[toks]
    pos = np.arange(bucket)[None]
    jhid, jks, jvs = jm.make_prefill(bucket)(jnp.asarray(x),
                                            jnp.asarray(pos))
    phid, pks, pvs = pm.make_prefill(bucket)(torch.from_numpy(x),
                                            torch.from_numpy(pos))
    assert_close(phid[:, :S], np.asarray(jhid[:, :S]), rtol=0.0,
                 atol=HIDDEN_ATOL, max_mismatched_ratio=0.0)
    want = np.asarray(jh.logits(jhid[:, :S]))
    assert_close(ph.logits(phid[:, :S]), want, rtol=0.0,
                 atol=LOGIT_RTOL * np.abs(want).max(),
                 max_mismatched_ratio=0.0)

    L, lmax = CFG["num_layers"], bucket + 4
    jk = jnp.zeros((L, 1, lmax, 1, 128), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([k[:S] for k in jks]).astype(jnp.bfloat16))
    jv = jnp.zeros((L, 1, lmax, 1, 128), jnp.bfloat16).at[:, 0, :S].set(
        jnp.stack([v[:S] for v in jvs]).astype(jnp.bfloat16))
    pk = torch.zeros((L, 1, lmax, 1, 128), dtype=torch.bfloat16)
    pv = torch.zeros_like(pk)
    pk[:, 0, :S] = torch.stack([k[:S] for k in pks]).to(torch.bfloat16)
    pv[:, 0, :S] = torch.stack([v[:S] for v in pvs]).to(torch.bfloat16)
    slots = np.zeros((1,), np.int32)
    for i, tok in enumerate((3, 17, 42)):
        xi = embed[[[tok]]]
        lengths = np.array([S + i], np.int32)
        jh_i, jk, jv = jm.decode_step(jnp.asarray(xi), jk, jv,
                                      jnp.asarray(slots),
                                      jnp.asarray(lengths))
        ph_i, pk, pv = pm.decode_step(torch.from_numpy(xi), pk, pv,
                                      torch.from_numpy(slots),
                                      torch.from_numpy(lengths))
        assert_close(ph_i, np.asarray(jh_i), rtol=0.0, atol=HIDDEN_ATOL,
                     max_mismatched_ratio=0.0, msg=f"step {i}")


def test_token_engine_greedy_tokens_match_jax(pair):
    """Prompts of 300 and 40 tokens: the first prefills in bucket 512,
    where the port takes the materialize route, the second in bucket 64
    through the fused path; decode steps run at M = 2."""
    jm, jh, pm, ph, _ = pair
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (300, 40)]
    je = _synchronous(JaxTokenEngine(jm, jh, num_slots=2, max_seq_len=512))
    pe = TokenContinuousBatchingEngine(pm, ph, num_slots=2, max_seq_len=512)
    jr = [je.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    pr = [pe.submit_tokens(uid=i, tokens=p, max_new=5)
          for i, p in enumerate(prompts)]
    je.run_to_completion()
    pe.run_to_completion()
    for a, b in zip(jr, pr):
        assert b.done and len(b.out_tokens) == 5
        assert b.out_tokens == a.out_tokens, b.uid
        assert_close(b.final_hidden, a.final_hidden, rtol=0.0,
                     atol=HIDDEN_ATOL, max_mismatched_ratio=0.0)

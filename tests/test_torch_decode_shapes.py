"""Decode attention at every shape the JAX package serves, and `generate`'s
cache dtype (CPU).

1. Head dim 256 and a GQA group of 16 (H = 16, Hkv = 1), which JAX's
   decode kernels take (any D % 128 == 0, any group): the port's four
   entry points (`serving/kv_cache.decode_attention{,_quant,_paged,
   _paged_quant}`) and the four wrappers of kernels/flash.py (which take
   the plain version on the CPU before any kernel-only check) against
   JAX's Pallas decode kernels in interpret mode.
2. `QuantLlamaLM.generate` keeps its cache in the hidden dtype (float16),
   as JAX's generate does, and its greedy tokens equal JAX's on the
   2-layer fixture of tests/test_torch_serving.py.

Inputs: q f16, K amplified 20x so that a head mix-up cannot hide in a
near-uniform softmax, lengths {0, 1, 63, 64, 65, span}, stale rows past
each length 1e4 (or extreme codes and scales), which JAX reads masked.

Tolerance against JAX, atol 1e-2 (as tests/test_torch_flash_split.py):
scores reach a few hundred in the base-2 domain, where the two sides'
f32 dot products (summed in other orders) differ by ~1e-5 relative, i.e.
~0.3% in a weight, on outputs that are convex mixes of V rows (|.| < 5);
the JAX kernels also round P to f16. At D = 256 the dot products have
twice the terms: the same bound holds with margin.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.kernels.flash import (make_flash_decode,
                                       make_flash_decode_paged,
                                       make_flash_decode_paged_quant,
                                       make_flash_decode_quant)
from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.models import QuantLlamaLM as JaxQuantLlamaLM
from bitblas_tpu.models.hf_import import LMHead as JaxLMHead

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.kernels import flash
from bitblas_tpu_torch.models.hf_import import LMHead, QuantLlamaLM
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving import kv_cache
from bitblas_tpu_torch.testing import assert_close

SPAN = 256
JAX_ATOL = 1e-2
KINDS = ("slot", "slot_quant", "paged", "paged_quant")
# (D, H, Hkv): head dim 256 (group 4), group 16 at D = 128, both at once
SHAPES = [(256, 8, 2), (128, 16, 1), (256, 16, 1)]


def _inputs(kind, D, H, Hkv, seed):
    """numpy operands of `kind`, the index (slots or tables) and lengths;
    rows past each length (and, paged, block 0 and the tail of the last
    page) hold 1e4 or extreme codes and scales."""
    rng = np.random.default_rng(seed)
    lengths = np.array([0, 1, 63, 64, 65, SPAN], np.int32)
    B = len(lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float16)
    quant = kind.endswith("quant")
    if kind.startswith("slot"):
        rows = B + 1
        index = rng.permutation(rows)[:B].astype(np.int32)
        shape = (rows, SPAN, Hkv, D)
    else:
        bs = 128 if quant else 16       # JAX's int8 pool needs 128-row pages
        MB = SPAN // bs
        need = [-(-int(n) // bs) for n in lengths]
        blocks = 1 + sum(need) + 1
        perm = rng.permutation(np.arange(1, blocks))
        index = np.zeros((B, MB), np.int32)
        at = 0
        for b, n in enumerate(need):
            index[b, :n] = perm[at:at + n]
            at += n
        shape = (blocks, bs, Hkv, D)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.2 + 0.05).astype(np.float32) * 20
        vs = (rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32)
        planes = [(k, 127), (v, -128), (ks, 1e4), (vs, 1e4)]
    else:
        k = (rng.standard_normal(shape) * 20).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        planes = [(k, 1e4), (v, -1e4)]
    for x, val in planes:
        for b, n in enumerate(lengths):
            if kind.startswith("slot"):
                x[index[b], n:] = val
            else:
                bs = shape[1]
                x[0] = val
                if n % bs:
                    x[index[b, n // bs], n % bs:] = val
    arrays = [q, k, v] + ([ks, vs] if quant else [])
    return arrays, index, lengths


def _jax(kind, arrays, index, lengths, H, Hkv, D):
    B = len(lengths)
    quant = kind.endswith("quant")
    if not quant:
        arrays = arrays[:1] + [a.astype(ml_dtypes.bfloat16)
                               for a in arrays[1:]]
    if kind == "slot":
        fn = make_flash_decode(batch=B, heads=H, max_seq_len=SPAN, dim=D,
                               kv_heads=Hkv, block_kv=128, interpret=True)
        args = (*arrays, lengths, index)
    elif kind == "slot_quant":
        fn = make_flash_decode_quant(batch=B, heads=H, max_seq_len=SPAN,
                                     dim=D, kv_heads=Hkv, block_kv=128,
                                     interpret=True)
        args = (*arrays, lengths, index)
    else:
        maker = make_flash_decode_paged_quant if quant \
            else make_flash_decode_paged
        fn = maker(batch=B, heads=H, block_size=arrays[1].shape[1],
                   max_blocks=index.shape[1], dim=D, kv_heads=Hkv,
                   interpret=True)
        args = (*arrays, index, lengths)
    return np.asarray(fn(*(jnp.asarray(a) for a in args)), np.float32)


def _torch_args(kind, arrays, index, lengths):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if not kind.endswith("quant"):
        t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    return t, torch.from_numpy(index), torch.from_numpy(lengths)


def _entry_point(kind, t, idx, lens, H):
    """The serving entry point of `kind`, as the engines call it."""
    if kind == "slot":
        return kv_cache.decode_attention(t[0], t[1], t[2], idx, lens,
                                         num_heads=H)
    if kind == "slot_quant":
        return kv_cache.decode_attention_quant(*t, idx, lens, num_heads=H)
    if kind == "paged":
        return kv_cache.decode_attention_paged(*t, idx, lens, num_heads=H)
    return kv_cache.decode_attention_paged_quant(*t, idx, lens, num_heads=H)


def _wrapper(kind, t, idx, lens):
    """The kernel wrapper of `kind` (kernels/flash.py), on CPU tensors."""
    if kind == "slot":
        return flash.flash_decode(*t, lens, idx)
    if kind == "slot_quant":
        return flash.flash_decode_quant(*t, lens, idx)
    if kind == "paged":
        return flash.flash_decode_paged(*t, idx, lens)
    return flash.flash_decode_paged_quant(*t, idx, lens)


@pytest.mark.parametrize("D,H,Hkv", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_decode_entry_points_serve_what_jax_serves(kind, D, H, Hkv):
    arrays, index, lengths = _inputs(kind, D, H, Hkv, seed=D + H + Hkv)
    want = _jax(kind, arrays, index, lengths, H, Hkv, D)
    t, idx, lens = _torch_args(kind, arrays, index, lengths)
    got = _entry_point(kind, t, idx, lens, H)
    assert got.dtype == torch.float16 and tuple(got.shape) == (6, H, D)
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # length 0
    assert_close(got, want, rtol=0.0, atol=JAX_ATOL,
                 max_mismatched_ratio=0.0)
    # the kernel wrapper takes its plain version on the CPU, whatever the
    # kernels' own limits
    assert torch.equal(_wrapper(kind, t, idx, lens), got)


def test_kernel_only_limits_raise_with_the_shapes():
    """On the card a head dim no kernel instance takes raises (never a
    quiet fallback); groups of any size are taken, and every head dim
    D % 128 == 0 up to the cap."""
    flash._check_decode("flash_decode", 4, 64, 1, 128)      # group 64
    flash._check_decode("flash_decode", 4, 16, 1, 256)
    flash._check_decode("flash_decode", 4, 8, 2, 384)
    with pytest.raises(NotImplementedError, match="D=1152"):
        flash._check_decode("flash_decode", 4, 8, 2, 1152)
    flash._check_decode("flash_decode", 1, 12 * 5000, 5000, 128)  # 2 chunks
    with pytest.raises(NotImplementedError, match="Hkv=40000"):
        flash._check_decode("flash_decode", 1, 12 * 40000, 40000, 128)


@pytest.mark.parametrize("use_flash", [None, False])
def test_paged_routing_on_the_cpu_is_the_gather(use_flash):
    arrays, index, lengths = _inputs("paged", 256, 16, 1, seed=5)
    t, idx, lens = _torch_args("paged", arrays, index, lengths)
    assert not kv_cache._use_paged_kernel(t[0], use_flash)
    got = kv_cache.decode_attention_paged(*t, idx, lens, num_heads=16,
                                          use_flash=use_flash)
    assert torch.equal(got, flash.flash_decode_paged_plain(*t, idx, lens))


# -- generate keeps the hidden dtype ------------------------------------------

V, HID = 64, 256
CFG = dict(hidden_size=HID, intermediate_size=512, num_heads=2,
           num_kv_heads=1, num_layers=2, vocab_size=V, group_size=128)


@pytest.fixture(scope="module")
def lm_pair():
    jm = JaxQuantLlama(JaxLlamaConfig(**CFG), opt_m=(1, 2, 16))
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((V, HID)) * 0.05).astype(np.float16)
    lm_head = (rng.standard_normal((V, HID)) * 0.05).astype(np.float32)
    jh = JaxLMHead(embed=jnp.asarray(embed),
                   final_norm=jnp.ones((HID,), jnp.float32),
                   lm_head=jnp.asarray(lm_head))
    cfg = LlamaConfig(**CFG)
    pm = QuantLlama(cfg, device="cpu", seed=123)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(from_jax_state(state, cfg))
    ph = LMHead(embed, np.ones(HID, np.float32), lm_head, device="cpu")
    return JaxQuantLlamaLM(jm, jh), QuantLlamaLM(pm, ph)


def test_generate_keeps_the_hidden_dtype_and_jax_tokens(lm_pair,
                                                        monkeypatch):
    jlm, plm = lm_pair
    seen = []
    step = plm.model.decode_step

    def recording(x, caches_k, caches_v, *rest):
        seen.append((caches_k.dtype, caches_v.dtype))
        return step(x, caches_k, caches_v, *rest)

    monkeypatch.setattr(plm.model, "decode_step", recording)
    prompt = np.array([3, 17, 42, 5, 9, 11, 60], np.int32)
    got = plm.generate(prompt, max_new_tokens=12)
    want = jlm.generate(prompt, max_new_tokens=12)
    assert len(seen) == 11
    assert set(seen) == {(torch.float16, torch.float16)}
    np.testing.assert_array_equal(got, np.asarray(want))

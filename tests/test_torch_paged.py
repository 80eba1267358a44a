"""The port's paged KV cache and PagedContinuousBatchingEngine against the
JAX package, on the CPU, float and int8.

Both packages get the same numpy inputs. At block size 128 the JAX side
runs its paged Pallas kernels (float and int8) in interpret mode, at block
size 16 its XLA table gather; the port runs its kernels' plain versions
(the table gather). Attention outputs are f16 of magnitude < 4 computed in
f32 on both sides: atol 4e-3 (about one f16 ulp; JAX's float paged kernel
came to 2.6e-3 on these inputs). Model-level outputs (2 layers, hidden
256) follow test_torch_serving's 1e-2: hidden states fed back through up
to 15 engine steps came to 2.4e-4 (float) and 3.1e-4 (int8) once the JAX
engine waits on each step (`_synchronous`).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitblas_tpu.models import LlamaConfig as JaxLlamaConfig
from bitblas_tpu.models import QuantLlama as JaxQuantLlama
from bitblas_tpu.serving import kv_cache as jkv
from bitblas_tpu.serving.engine import \
    PagedContinuousBatchingEngine as JaxPagedEngine
from bitblas_tpu.serving.engine import Request as JaxRequest

from bitblas_tpu_torch.convert import from_jax_state
from bitblas_tpu_torch.kernels.flash import (flash_decode_paged,
                                             flash_decode_paged_plain,
                                             flash_decode_paged_quant)
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
from bitblas_tpu_torch.serving import kv_cache as pkv
from bitblas_tpu_torch.serving.engine import (PagedContinuousBatchingEngine,
                                              Request)
from bitblas_tpu_torch.testing import assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file. The tier-1 command runs
    six workers on eight cores, and torch's eight-thread pool then spins
    against the other workers: this file's small CPU ops took several
    times their time alone there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

H = 256
CFG = dict(hidden_size=H, intermediate_size=512, num_heads=2,
           num_kv_heads=1, num_layers=2, vocab_size=64, group_size=128)
ATTN_ATOL = 4e-3
MODEL_ATOL = 1e-2


def _synchronous(engine):
    """A JAX engine whose decode steps finish before they return. The JAX
    engines hand host numpy arrays (lengths, block tables) to an
    asynchronously dispatched step and then update those arrays in place;
    on the CPU jnp.asarray may alias the numpy buffer, so a step still
    queued can read the next step's lengths. Its results then moved by up
    to 1.9e-2 between processes, depending on what ran before."""
    step = engine._decode_step
    engine._decode_step = lambda *a: jax.block_until_ready(step(*a))
    return engine


@pytest.fixture(scope="module")
def pair():
    jm = JaxQuantLlama(JaxLlamaConfig(**CFG), opt_m=(1, 2, 16))
    cfg = LlamaConfig(**CFG)
    pm = QuantLlama(cfg, device="cpu", seed=2)
    state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in jm.state_dict().items()}
    pm.load_state_dict(from_jax_state(state, cfg))
    return jm, pm


def _np_pool(rows, quant):
    """float32 rows [..., D] -> (k, v)-style pool arrays for both
    packages: bf16 values (ml_dtypes) or (int8 codes, f32 scales) made by
    the JAX quantizer."""
    if not quant:
        return [rows.astype(ml_dtypes.bfloat16)]
    codes, scales = jkv.quantize_kv(jnp.asarray(rows))
    return [np.array(codes), np.array(scales)]


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_cache_and_append_match_jax(quant):
    rng = np.random.default_rng(1)
    kw = dict(num_blocks=6, block_size=4, num_kv_heads=2, head_dim=128,
              num_layers=2, max_blocks_per_slot=3)
    init_j = jkv.init_quant_paged_kv_cache if quant \
        else jkv.init_paged_kv_cache
    init_p = pkv.init_quant_paged_kv_cache if quant \
        else pkv.init_paged_kv_cache
    jc = init_j(jkv.PagedKVConfig(**kw))
    pc = init_p(pkv.PagedKVConfig(**kw), device="cpu")
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for n in names:
        assert tuple(pc[n].shape) == jc[n].shape
        assert str(pc[n].dtype).split(".")[-1] == str(jc[n].dtype)
    rows = np.array([3, 5], np.int32)
    offs = np.array([1, 3], np.int32)
    kn, vn = (rng.standard_normal((2, 2, 128)).astype(np.float32)
              for _ in range(2))
    args = (rows, offs, kn, vn)
    layer = [pc[n][1] for n in names]
    if quant:
        jout = jkv.append_token_paged_quant(
            *(jc[n][1] for n in names), *(jnp.asarray(a) for a in args))
        pout = pkv.append_token_paged_quant(
            *layer, *(torch.from_numpy(a) for a in args))
    else:
        jout = jkv.append_token_paged(*(jc[n][1] for n in names),
                                      *(jnp.asarray(a) for a in args))
        pout = pkv.append_token_paged(*layer,
                                      *(torch.from_numpy(a) for a in args))
    for want, got, t in zip(jout, pout, layer):
        assert got.data_ptr() == t.data_ptr()               # in place
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


def _paged_inputs(seed, bs, H_, Hkv, quant):
    """A pool with permuted tables, lengths 0 / mid-page / full page /
    third page, K amplified 20x, and stale rows (tail of the last page,
    reserved block 0) holding huge values."""
    rng = np.random.default_rng(seed)
    lengths = np.array([0, bs // 2 + 3, bs, 2 * bs + 5], np.int32)
    B, MB = len(lengths), 4
    need = [-(-int(n) // bs) for n in lengths]
    blocks = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, blocks))
    tables = np.zeros((B, MB), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    q = rng.standard_normal((B, H_, 128)).astype(np.float16)
    k = rng.standard_normal((blocks, bs, Hkv, 128)).astype(np.float32) * 20
    v = rng.standard_normal((blocks, bs, Hkv, 128)).astype(np.float32)
    k, v = _np_pool(k, quant), _np_pool(v, quant)
    for parts, big in ((k, 127), (v, -128)):
        for i, a in enumerate(parts):
            val = (big if quant else 1e4) if i == 0 else 1e4
            a[0] = val
            for b, n in enumerate(lengths):
                if n % bs:
                    a[tables[b, n // bs], n % bs:] = val
    arrays = [q, k[0], v[0]] + ([k[1], v[1]] if quant else [])
    return arrays, tables, lengths


@pytest.mark.parametrize("H_,Hkv", [(2, 2), (8, 2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bs", [16, 128])
def test_decode_attention_paged_matches_jax(bs, quant, H_, Hkv):
    """bs 128: JAX's paged kernels (interpret mode); bs 16: JAX's table
    gather. The port runs its kernel's wrapper (the plain gather on the
    CPU) in both cases."""
    arrays, tables, lengths = _paged_inputs(bs + H_, bs, H_, Hkv, quant)
    jfn = jkv.decode_attention_paged_quant if quant \
        else jkv.decode_attention_paged
    pfn = pkv.decode_attention_paged_quant if quant \
        else pkv.decode_attention_paged
    want = np.asarray(jfn(*(jnp.asarray(a) for a in arrays),
                          jnp.asarray(tables), jnp.asarray(lengths),
                          num_heads=H_, use_flash=bs == 128), np.float32)
    kernel = flash_decode_paged_quant if quant else flash_decode_paged
    before = kernel.launches
    got = pfn(*(_to_torch(a) for a in arrays), torch.from_numpy(tables),
              torch.from_numpy(lengths), num_heads=H_, use_flash=True)
    assert kernel.launches == before            # the CPU takes the plain
    assert got.dtype == torch.float16
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # length 0
    # JAX's gather gives a length-0 row a uniform mix, its kernels 0
    live = slice(0, None) if bs == 128 else slice(1, None)
    assert_close(got[live], want[live], rtol=0.0, atol=ATTN_ATOL,
                 max_mismatched_ratio=0.0)


def test_paged_routing_on_the_cpu():
    arrays, tables, lengths = _paged_inputs(0, 16, 4, 2, quant=False)
    t = [_to_torch(a) for a in arrays]
    before = flash_decode_paged.launches
    got = pkv.decode_attention_paged(*t, torch.from_numpy(tables),
                                     torch.from_numpy(lengths), num_heads=4)
    gather = pkv.decode_attention_paged(*t, torch.from_numpy(tables),
                                        torch.from_numpy(lengths),
                                        num_heads=4, use_flash=False)
    assert flash_decode_paged.launches == before
    assert torch.equal(got, gather)
    # a window takes the table gather masked to it, as in JAX (its paged
    # kernels have no window), and is counted
    gathers = pkv.decode_attention_paged.window_gathers
    windowed = pkv.decode_attention_paged(*t, torch.from_numpy(tables),
                                          torch.from_numpy(lengths),
                                          num_heads=4, window=8)
    assert pkv.decode_attention_paged.window_gathers == gathers + 1
    assert flash_decode_paged.launches == before
    assert torch.equal(windowed, flash_decode_paged_plain(
        *t, torch.from_numpy(tables), torch.from_numpy(lengths), window=8))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_step_paged_matches_jax(pair, quant):
    jm, pm = pair
    rng = np.random.default_rng(4)
    L, bs, blocks = 2, 4, 12
    lengths = np.array([5, 9, 3], np.int32)
    B = len(lengths)
    tables = np.zeros((B, 4), np.int32)
    tables[:, :3] = rng.permutation(np.arange(1, blocks))[:9].reshape(B, 3)
    pools = []
    for _ in range(2):                                      # K, V
        rows = rng.standard_normal((L, blocks, bs, 1, 128)).astype(
            np.float32)
        pools += _np_pool(rows, quant)
    order = (0, 2, 1, 3) if quant else (0, 1)      # k, v (, ks, vs)
    jstate = [jnp.asarray(pools[i]) for i in order]
    pstate = [_to_torch(pools[i].copy()) for i in order]
    jstep = jm.decode_step_paged_quant if quant else jm.decode_step_paged
    pstep = pm.decode_step_paged_quant if quant else pm.decode_step_paged
    for step in range(2):
        x = (rng.standard_normal((B, 1, H)) * 0.05).astype(np.float16)
        idx = (tables, tables[np.arange(B), lengths // bs], lengths % bs,
               lengths)
        jout = jstep(jnp.asarray(x), *jstate,
                     *(jnp.asarray(np.ascontiguousarray(a)) for a in idx))
        pout = pstep(torch.from_numpy(x), *pstate,
                     *(torch.from_numpy(np.ascontiguousarray(a))
                       for a in idx))
        jstate = list(jout[1:])
        assert all(a is b for a, b in zip(pout[1:], pstate))   # in place
        assert_close(pout[0], np.asarray(jout[0]), rtol=0.0,
                     atol=MODEL_ATOL, max_mismatched_ratio=0.0,
                     msg=f"step {step}")
        lengths = lengths + 1


def _stream(seed=12):
    """Five hidden-state requests; three share an 8-row prefix (two full
    4-row blocks), one is the bare prefix."""
    rng = np.random.default_rng(11)
    prefix = (rng.standard_normal((8, H)) * 0.05).astype(np.float16)
    r = np.random.default_rng(seed)
    out = []
    for i, (tail, max_new) in enumerate([(2, 9), (3, 8), (0, 7), (5, 4),
                                         (1, 6)]):
        t = (r.standard_normal((tail, H)) * 0.05).astype(np.float16)
        p = np.concatenate([prefix, t]) if i != 3 else \
            (r.standard_normal((7, H)) * 0.05).astype(np.float16)
        out.append((p, max_new))
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_paged_engine_matches_jax(pair, quant):
    """A pool of 8 usable blocks for 5 requests on 3 slots: admission
    waits, prefix blocks are shared, and one request runs out of blocks
    mid-flight and finishes early. Tables, lengths, prefix hits, slots,
    finish order and early finishes must match step by step."""
    jm, pm = pair
    kw = dict(num_slots=3, num_blocks=9, block_size=4, kv_quant=quant)
    je = _synchronous(JaxPagedEngine(jm, **kw))
    pe = PagedContinuousBatchingEngine(pm, **kw)
    for i, (p, n) in enumerate(_stream()):
        je.submit(JaxRequest(uid=i, prompt=p, max_new=n))
        pe.submit(Request(uid=i, prompt=p, max_new=n))
    waited = 0
    for step in range(40):
        if not (je.active or je.pending):
            break
        je.step()
        pe.step()
        waited += bool(pe.pending)
        assert np.array_equal(pe.tables, je.tables), step
        assert np.array_equal(pe.lengths, je.lengths), step
        assert pe.prefix_hits == je.prefix_hits, step
        assert sorted(pe.active) == sorted(je.active), step
        assert [r.uid for r in pe.finished] == [r.uid for r in je.finished]
    assert not (pe.active or pe.pending)
    assert waited > 0 and pe.prefix_hits > 0
    early = [r.uid for r in pe.finished if r.generated < r.max_new]
    assert early and early == [r.uid for r in je.finished
                               if r.generated < r.max_new]
    assert pe.block_alloc.available == 8 and not pe.block_ref
    if quant:
        assert pe.caches_k.dtype == torch.int8
    want = {r.uid: (r.slot, r.final_hidden) for r in je.finished}
    for r in pe.finished:
        assert r.slot == want[r.uid][0]
        assert_close(r.final_hidden, want[r.uid][1], rtol=0.0,
                     atol=MODEL_ATOL, max_mismatched_ratio=0.0,
                     msg=f"uid {r.uid}")


def _finals(eng):
    out = {r.uid: r.final_hidden for r in eng.finished}
    assert all(v is not None and np.isfinite(v).all() for v in out.values())
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_paged_generates_under_memory_pressure(pair, quant):
    """Port of JAX's scenario: a pool far smaller than the requests' total
    makes them queue on block availability; all complete with the results
    of an unconstrained pool, and every block returns."""
    _, pm = pair
    rng = np.random.default_rng(1)
    prompts = [(rng.standard_normal((int(rng.integers(2, 7)), H)) * 0.05)
               .astype(np.float16) for _ in range(6)]
    finals = []
    for num_blocks in (64, 9):
        eng = PagedContinuousBatchingEngine(pm, num_slots=4,
                                            num_blocks=num_blocks,
                                            block_size=4, kv_quant=quant)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new=4))
        done = eng.run_to_completion()
        assert sorted(r.uid for r in done) == list(range(6))
        finals.append(_finals(eng))
    assert eng.block_alloc.available == 8
    for uid in range(6):
        assert_close(finals[1][uid], finals[0][uid], rtol=0.0,
                     atol=MODEL_ATOL, max_mismatched_ratio=0.0)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_block_reuse_is_clean(pair, quant):
    """Port of JAX's scenario: a request that reuses blocks released by an
    earlier one sees none of its K/V."""
    _, pm = pair
    rng = np.random.default_rng(2)
    p1, p2 = ((rng.standard_normal((n, H)) * 0.05).astype(np.float16)
              for n in (6, 5))
    fresh = PagedContinuousBatchingEngine(pm, num_slots=2, num_blocks=16,
                                          block_size=4, kv_quant=quant)
    fresh.submit(Request(uid=0, prompt=p2.copy(), max_new=3))
    fresh.run_to_completion()
    reused = PagedContinuousBatchingEngine(pm, num_slots=2, num_blocks=16,
                                           block_size=4, kv_quant=quant)
    reused.submit(Request(uid=0, prompt=p1.copy(), max_new=3))
    reused.run_to_completion()                     # p1's blocks released
    reused.submit(Request(uid=1, prompt=p2.copy(), max_new=3))
    reused.run_to_completion()
    assert set(reused.slot_blocks) == set()
    assert np.array_equal(_finals(reused)[1], _finals(fresh)[0])


def test_prefix_caching_shares_blocks(pair):
    """Port of JAX's scenario: three equal 8-row prompts share both full
    prefix blocks (refcounted); results equal a prefix-caching-disabled
    engine's, and every block is reclaimed."""
    _, pm = pair
    rng = np.random.default_rng(3)
    prompt = (rng.standard_normal((8, H)) * 0.05).astype(np.float16)
    runs = {}
    for on in (True, False):
        eng = PagedContinuousBatchingEngine(pm, num_slots=4, num_blocks=32,
                                            block_size=4, prefix_caching=on)
        for i in range(3):
            eng.submit(Request(uid=i, prompt=prompt.copy(), max_new=3))
        eng.run_to_completion()
        runs[on] = (eng, _finals(eng))
    assert runs[True][0].prefix_hits == 4 and runs[False][0].prefix_hits == 0
    for uid in range(3):
        assert_close(runs[True][1][uid], runs[False][1][uid], rtol=0.0,
                     atol=MODEL_ATOL, max_mismatched_ratio=0.0)
    eng = runs[True][0]
    assert eng.block_alloc.available == 31
    assert not eng.block_ref and not eng.prefix_index

"""The port's routed MoE FFN (bitblas_tpu_torch.models.quant_moe) against
the JAX package's, on the CPU.

Fixture: JAX's MoEConfig(hidden 256, intermediate 512, 4 experts, top-2,
group 128); the JAX layer's random weights carried across with
`convert.from_jax_moe_state`. The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.

Tolerances: the routing (which token takes which slot of which expert)
is held exactly; the gates within 2 float32 ulps of 1 (2.4e-7: XLA's
and PyTorch's softmax round exp differently); the gather into the
experts' buffers bit for bit; the combine against XLA's one-hot einsum
on the same expert outputs and gates within one float32 rounding of the
sum of |gate * output| (XLA fuses the second product into the add). A
layer's output within 1e-2 of its largest value with float16 activations (JAX applies
the scales to f32 sums, the port rounds each weight to f16 first:
measured <= 3.5e-3) and 2e-2 with bfloat16 (the port also holds the
scales in bfloat16, JAX's kernel in float32: measured <= 7.8e-3); the
float32 oracles within 1e-5 (f16 scales) and 1e-2 (bf16 scales).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu.models import quant_moe as jmoe

from bitblas_tpu_torch.convert import from_jax_moe_state
from bitblas_tpu_torch.models import quant_moe as pmoe

H, I = 256, 512
CFG = dict(hidden_size=H, intermediate_size=I, n_experts=4, top_k=2,
           group_size=128)
GATE_ATOL = 2.0 ** -22


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread (the tier-1 command runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(layer) -> dict:
    """A JAX QuantMoELayer's weights under QuantMixtralLayer's names."""
    out = {"router": np.asarray(layer.router)}
    for name, per in layer.weights.items():
        for e, (W, S, Z) in enumerate(per):
            for t, v in (("qweight", W), ("scales", S), ("zeros", Z)):
                out[f"expert_{e}.{name}.{t}"] = np.asarray(v)
    return out


def _pair(tokens, act_dtype="float16", **kw):
    cfg = dict(CFG, act_dtype=act_dtype, **kw)
    jl = jmoe.QuantMoELayer(jmoe.MoEConfig(**cfg), tokens=tokens, seed=0)
    pl = pmoe.QuantMoELayer(pmoe.MoEConfig(**cfg), tokens, seed=11,
                            device="cpu")
    pl.load_state_dict(from_jax_moe_state(_jax_state(jl), pl.cfg))
    return jl, pl


def _inputs(T, dtype, seed=3, zero_rows=(1,)):
    x = (np.random.default_rng(seed).standard_normal((T, H)) * 0.5
         ).astype(np.float32)
    x[list(r for r in zero_rows if r < T)] = 0.0
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, jnp.dtype(dtype)))


@pytest.mark.parametrize("n_experts,top_k,factor",
                         [(4, 2, 1.5), (8, 2, 2.0), (8, 1, 1.0),
                          (4, 2, 4.0), (8, 2, 1.25)])
def test_moe_capacity_matches_jax(n_experts, top_k, factor):
    kw = dict(CFG, n_experts=n_experts, top_k=top_k, capacity_factor=factor)
    jc, pc = jmoe.MoEConfig(**kw), pmoe.MoEConfig(**kw)
    for T in range(1, 301):
        c = pmoe.moe_capacity(pc, T)
        assert c == jmoe.moe_capacity(jc, T), T
        assert c % 8 == 0 and c >= 8


def _logits(case, T, E, rng):
    lg = rng.standard_normal((T, E)).astype(np.float32)
    valid = None
    if case == "valid":
        valid = rng.random(T) > 0.3
    elif case == "ties":
        lg[::2] = 0.0             # a zero row: every probability equal
        lg[1::4, :2] = 1.0        # two tied maxima
        lg[3::8, 1:] = -1.0       # ties below the top choice
    elif case == "drops":
        lg[:, 0] += 4.0           # most first choices on expert 0
    return lg, valid


CASES = [("plain", 32, 4, 2, 24), ("valid", 40, 8, 2, 16),
         ("ties", 24, 4, 2, 24), ("drops", 48, 4, 2, 8),
         ("drops", 64, 8, 1, 8), ("ties", 16, 8, 3, 8)]


@pytest.mark.parametrize("case,T,E,k,C", CASES)
def test_dispatch_combine_matches_jax(case, T, E, k, C):
    lg, valid = _logits(case, T, E, np.random.default_rng(T + E + k))
    jd, jc = jmoe.dispatch_combine(
        jnp.asarray(lg), k, C, None if valid is None else jnp.asarray(valid))
    pd, pc = pmoe.dispatch_combine(
        torch.from_numpy(lg), k, C,
        None if valid is None else torch.from_numpy(valid))
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0,
                               atol=GATE_ATOL)
    if case == "drops":     # some choices fell past the capacity
        assert pd.numpy().sum() < (T * k)


@pytest.mark.parametrize("case,T,E,k,C", CASES)
def test_index_routing_reproduces_jax_pair(case, T, E, k, C):
    """Every (token, choice) that fits sits where JAX's one-hot pair puts
    a 1 and its gate; nothing else is dispatched."""
    lg, valid = _logits(case, T, E, np.random.default_rng(T + E + k))
    jd, jc = (np.asarray(a) for a in jmoe.dispatch_combine(
        jnp.asarray(lg), k, C, None if valid is None else jnp.asarray(valid)))
    r = pmoe.route(torch.from_numpy(lg), k, C,
                   None if valid is None else torch.from_numpy(valid))
    t_idx, c_idx = np.nonzero(r.fits.numpy())
    e = r.experts.numpy()[t_idx, c_idx]
    s = r.slots.numpy()[t_idx, c_idx]
    assert int(r.fits.sum()) == int(jd.sum())
    assert (jd[t_idx, e, s] == 1.0).all()
    np.testing.assert_allclose(jc[t_idx, e, s],
                               r.gates.numpy()[t_idx, c_idx], rtol=0,
                               atol=GATE_ATOL)
    if valid is not None:
        assert not r.fits.numpy()[~valid].any()


@pytest.mark.parametrize("case,T,E,k,C", CASES)
def test_gather_and_combine_equal_the_einsums(case, T, E, k, C):
    """dispatch_rows equals JAX's einsum("tec,th->ech") bit for bit, and
    combine_rows its einsum("tec,ech->th") on the same gates and expert
    outputs within one float32 rounding."""
    rng = np.random.default_rng(T * E)
    lg, valid = _logits(case, T, E, rng)
    x = rng.standard_normal((T, 64)).astype(np.float16)
    r = pmoe.route(torch.from_numpy(lg), k, C,
                   None if valid is None else torch.from_numpy(valid))
    pd, pc = pmoe.dispatch_combine(
        torch.from_numpy(lg), k, C,
        None if valid is None else torch.from_numpy(valid))
    xin = pmoe.dispatch_rows(torch.from_numpy(x), r, E, C)
    want = jnp.einsum("tec,th->ech", jnp.asarray(pd.numpy(), jnp.float16),
                      jnp.asarray(x))
    assert np.array_equal(xin.numpy(), np.asarray(want))
    outs = rng.standard_normal((E, C, 64)).astype(np.float16)
    got = pmoe.combine_rows(torch.from_numpy(outs), r)
    want = jnp.einsum("tec,ech->th", jnp.asarray(pc.numpy()),
                      jnp.asarray(outs, jnp.float32))
    # XLA fuses a product into the sum (one rounding less): within one
    # float32 rounding of the terms' magnitude
    size = pmoe.combine_rows(torch.from_numpy(np.abs(outs)), r).numpy()
    assert (np.abs(got.numpy() - np.asarray(want)) <= 2.0 ** -23 * size
            ).all()


@pytest.mark.parametrize("act_dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("T", [4, 16, 64])
def test_moe_layer_matches_jax(T, act_dtype):
    jl, pl = _pair(T, act_dtype)
    xt, xj = _inputs(T, act_dtype)
    want = np.asarray(jl.forward(xj).astype(jnp.float32))
    got = pl(xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (T, H)
    tol = 1e-2 if act_dtype == "float16" else 2e-2
    assert np.abs(got.float().numpy() - want).max() \
        <= tol * np.abs(want).max()
    assert not got[1].any()                      # the zero row
    # the same routes: both packages on the port's float32 logits
    lg = xt.float() @ pl.router
    jd, _ = jmoe.dispatch_combine(
        jnp.asarray(lg.numpy()), 2, pl.capacity,
        jnp.asarray((xt != 0).any(-1).numpy()))
    pd, _ = pmoe.dispatch_combine(lg, 2, pl.capacity, (xt != 0).any(-1))
    assert np.array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("act_dtype", ["float16", "bfloat16"])
def test_moe_reference_matches_jax(act_dtype):
    jl, pl = _pair(16, act_dtype)
    xt, xj = _inputs(16, act_dtype, seed=5)
    want = np.asarray(jmoe.moe_reference(jl, xj))
    got = pmoe.moe_reference(pl, xt)
    assert got.dtype == torch.float32
    tol = 1e-5 if act_dtype == "float16" else 1e-2
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    # and the kernel path against the oracle, as JAX's test_moe holds it
    y = pl(xt).float()
    assert (y - got).abs().max() <= 2e-2 * got.abs().max()


def test_capacity_drops_overflow_tokens():
    """Every token on expert 0 with k = 1: the first `capacity` tokens
    keep their gate (1.0), later ones contribute nothing (JAX's
    test_moe.py)."""
    T, C = 16, 8
    lg = np.tile(np.float32([10.0, -10, -10, -10]), (T, 1))
    _, jc = jmoe.dispatch_combine(jnp.asarray(lg), 1, C)
    _, pc = pmoe.dispatch_combine(torch.from_numpy(lg), 1, C)
    kept = pc.numpy().sum(axis=(1, 2))
    np.testing.assert_allclose(kept[:C], 1.0, atol=1e-6)
    np.testing.assert_allclose(kept[C:], 0.0, atol=1e-6)
    np.testing.assert_allclose(kept, np.asarray(jc).sum(axis=(1, 2)),
                               atol=GATE_ATOL)
    r = pmoe.route(torch.from_numpy(lg), 1, C)
    assert r.fits[:C].all() and not r.fits[C:].any()
    assert r.slots[:, 0].tolist() == list(range(T))


def test_drops_follow_slot_major_priority():
    """With capacity 8 and every token's first choice on expert 0, the
    second choices that land on expert 0 lose to every first choice,
    whatever their token's position (a per-token order would differ)."""
    T, E, C = 12, 4, 8
    lg = np.full((T, E), -5.0, np.float32)
    lg[:, 0] = 5.0
    lg[:, 1] = 4.0
    lg[:6, 1], lg[:6, 0] = 5.0, 4.0       # tokens 0-5 pick 1 then 0
    _, jc = jmoe.dispatch_combine(jnp.asarray(lg), 2, C)
    r = pmoe.route(torch.from_numpy(lg), 2, C)
    # expert 0: the 6 first choices of tokens 6-11 take slots 0-5, then
    # the second choices of tokens 0 and 1 take 6 and 7; 2-5 drop
    first0 = r.experts[:, 0] == 0
    assert r.slots[first0, 0].tolist() == list(range(6))
    assert r.fits[:2, 1].all() and not r.fits[2:6, 1].any()
    np.testing.assert_allclose(
        pmoe.dispatch_combine(torch.from_numpy(lg), 2, C)[1].numpy(),
        np.asarray(jc), rtol=0, atol=GATE_ATOL)


def test_layer_takes_any_token_count():
    """The capacity follows T (a T unlike `tokens` re-derives it), the
    output finite, zero rows zero (JAX's test_mixtral.py:36)."""
    _, pl = _pair(16)
    for T in (1, 8, 16, 40):
        x, _ = _inputs(T, "float16", seed=T, zero_rows=())
        y = pl(x * 0.2)
        assert tuple(y.shape) == (T, H) and torch.isfinite(y).all()
        assert pl.capacity_for(T) == pmoe.moe_capacity(pl.cfg, T)


def test_expert_weights_are_contiguous_views():
    """One expert's operands are contiguous views of the stacks (what the
    kernels and a grouped kernel read), and the state dict's per-expert
    tensors are those views."""
    _, pl = _pair(8)
    w, s, z = pl.expert("down", 2)
    assert w.is_contiguous() and s.is_contiguous() and z.is_contiguous()
    assert w.data_ptr() == pl.down_qweight.data_ptr() + 2 * w.numel() * 4
    assert tuple(pl.down_qweight.shape) == (4, H, I // 8)
    assert tuple(pl.gate_scales.shape) == (4, H // 128, I)
    sd = pl.state_dict()
    assert sorted(sd)[:2] == ["expert_0.down.qweight", "expert_0.down.scales"]
    assert torch.equal(sd["expert_2.down.qweight"], w)
    assert len(sd) == 1 + 4 * 3 * 3

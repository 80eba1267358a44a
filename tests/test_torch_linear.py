"""bitblas_tpu_torch.module.Linear (CPU: the kernels' plain versions)
against the JAX package's Linear (its Pallas kernel in interpret mode) and
oracle, over GPTQ's group sizes (32, 64, 128, per channel), the three
zeros modes and bias; the GPTQ v1 / v2 repack; load_and_transform_weight;
the state_dict round trip; the operator cache and hint database keyed on
the widened config; and kernels 1 and 2's plain versions at the new
groups, rescale and bias against JAX.

Tolerances. Decoded weights are bit-equal to the JAX oracle's (f16
arithmetic on both sides). Outputs: `bitblas_tpu_torch.testing.
assert_close` with rtol 2e-3 (two f16 roundings of an output, 2^-10
each) and atol 2e-2 at K = 256 (outputs of magnitude ~10, f16 ulp there
2^-7), no element outside: the port rounds each weight to f16 before the
f32 sums, the JAX kernel applies scales and zeros to its f32 sums (s (sum
q a - z sum a)), and the order of the sums differs.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitblas_tpu import Linear as JaxLinear
from bitblas_tpu.ops import reference as jref
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.quantization import packing as jpack

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.kernels import dequant_matmul as dq
from bitblas_tpu_torch.kernels.materialize import weight_decode_u4
from bitblas_tpu_torch.module import (Linear, unpack_qweight, unpack_qzeros,
                                      unpack_qzeros_v2)
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.testing import assert_close
from bitblas_tpu_torch.tuner import TileHint

K = N = 256
TOL = dict(rtol=2e-3, atol=2e-2, max_mismatched_ratio=0.0)
MODES = ("original", "rescale", "quantized")
GROUPS = (32, 64, 128, -1)


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    """Each test loads and saves hints in its own directory, with the
    global operator cache empty at the start and the end."""
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


def _kw(g, mode, bias, **extra):
    return dict(bias=bias, A_dtype="float16", W_dtype="uint4",
                with_scaling=True, with_zeros=True, zeros_mode=mode,
                group_size=g, opt_M=[1, 16], enable_tuning=False, **extra)


def _operands(seed, g, mode, bias):
    """Reference-layout operands: codes [N, K], scales [N, K/g], zeros in
    the mode's form (original: integers [N, K/g]; rescale: z * s [N,
    K/g]; quantized: packed [K/g, N/2] int8), bias [N] or None."""
    rng = np.random.default_rng(seed)
    gg = K if g == -1 else g
    codes = rng.integers(0, 16, (N, K)).astype(np.int8)
    scales = (rng.standard_normal((N, K // gg)) * 0.01 + 0.02).astype(
        np.float16)
    zi = rng.integers(0, 16, (N, K // gg))
    if mode == "quantized":
        zeros = jpack.general_compress(np.ascontiguousarray(zi.T), 4)
    elif mode == "rescale":
        zeros = (zi * scales.astype(np.float32)).astype(np.float16)
    else:
        zeros = zi.astype(np.float16)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    A = rng.standard_normal((5, K)).astype(np.float16)
    return codes, scales, zeros, b, A


def _jax_oracle_weight(jcfg, codes, scales, zeros, mode):
    kw = dict(qzeros=jnp.asarray(zeros)) if mode == "quantized" else \
        dict(zeros=jnp.asarray(zeros))
    return np.asarray(jref.dequantize_weight(
        jcfg, jnp.asarray(jpack.general_compress(codes, 4)),
        jnp.asarray(scales), **kw))


def _decoded(lin: Linear) -> torch.Tensor:
    cfg = lin.bitblas_matmul.config
    return dq.dequantize_hopper(
        lin.qweight, lin.scales, lin.zeros, cfg.effective_group_size,
        "rescale" if cfg.zeros_mode == "rescale" else "original")


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("g", GROUPS)
def test_linear_matches_jax(g, mode, bias):
    codes, scales, zeros, b, A = _operands(g % 97 + len(mode), g, mode, bias)
    jl = JaxLinear(K, N, **_kw(g, mode, bias))
    jl.load_and_transform_weight(codes, scales=scales, zeros=zeros, bias=b)
    pl = Linear(K, N, device="cpu", **_kw(g, mode, bias))
    pl.load_and_transform_weight(codes, scales=scales, zeros=zeros, bias=b)
    W = _jax_oracle_weight(jl.bitblas_matmul.config, codes, scales, zeros,
                           mode)
    np.testing.assert_array_equal(_decoded(pl).numpy(), W)
    for m in (1, 5):
        got = pl(torch.from_numpy(A[:m]))
        assert got.dtype == torch.float16 and got.shape == (m, N)
        want = np.asarray(jl(jnp.asarray(A[:m])))
        assert_close(got, want, **TOL)


def _gptq_bundle(seed, g, *, v2=False, bias=True):
    """An AutoGPTQ (v2: GPTQModel) layer: qweight [K/8, N] int32, qzeros
    [K/g, N/8] int32, scales [K/g, N] f16, bias [N] f16."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (K, N))
    zeros = rng.integers(1, 15, (K // g, N))
    scales = (rng.standard_normal((K // g, N)) * 0.01 + 0.03).astype(
        np.float16)
    qw, qz, sc = jpack.pack_autogptq(codes, zeros, scales, 4, v2=v2)
    b = rng.standard_normal(N).astype(np.float16) if bias else None
    return types.SimpleNamespace(qweight=qw, qzeros=qz, scales=sc, bias=b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("v2", [False, True])
def test_repack_from_gptq_matches_jax(v2, mode):
    g = 64
    stub = _gptq_bundle(3 + v2, g, v2=v2)
    jl = JaxLinear(K, N, **_kw(g, mode, True))
    pl = Linear(K, N, device="cpu", **_kw(g, mode, True))
    repack = "repack_from_gptq_v2" if v2 else "repack_from_gptq"
    jcodes, jz = getattr(jl, repack)(stub)
    # torch tensors in the bundle repack the same
    tstub = types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in vars(stub).items()})
    pcodes, pz = getattr(pl, repack)(tstub)
    np.testing.assert_array_equal(pcodes.numpy(), jcodes)
    np.testing.assert_array_equal(pz.numpy(), jz)
    np.testing.assert_array_equal(pl.scales.numpy(), stub.scales)
    np.testing.assert_array_equal(pl.bias.numpy(),
                                  stub.bias.astype(np.float32)[None])
    A = np.random.default_rng(7).standard_normal((4, K)).astype(np.float16)
    assert_close(pl(torch.from_numpy(A)), np.asarray(jl(jnp.asarray(A))),
                 **TOL)


def test_module_level_unpackers_match_jax():
    from bitblas_tpu.module import (unpack_qweight as ju, unpack_qzeros as jz,
                                    unpack_qzeros_v2 as jz2)
    stub = _gptq_bundle(5, 64)
    qw8 = np.ascontiguousarray(stub.qweight.T).view(np.int8)
    np.testing.assert_array_equal(unpack_qweight(qw8, 4).numpy(),
                                  ju(qw8, 4))
    np.testing.assert_array_equal(unpack_qzeros(stub.qzeros, 4).numpy(),
                                  jz(stub.qzeros, 4))
    np.testing.assert_array_equal(unpack_qzeros_v2(stub.qzeros, 4).numpy(),
                                  jz2(stub.qzeros, 4))


def test_biased_checkpoint_into_bias_false_raises():
    pl = Linear(K, N, device="cpu", **_kw(64, "original", False))
    with pytest.raises(ValueError, match="bias=True"):
        pl.repack_from_gptq(_gptq_bundle(6, 64))
    jl = JaxLinear(K, N, **_kw(64, "original", False))
    with pytest.raises(ValueError, match="bias=True"):
        jl.repack_from_gptq(_gptq_bundle(6, 64))


@pytest.mark.parametrize("mode", MODES)
def test_state_dict_round_trip(mode):
    codes, scales, zeros, b, A = _operands(8, 32, mode, True)
    pl = Linear(K, N, device="cpu", **_kw(32, mode, True))
    pl.load_and_transform_weight(codes, scales=scales, zeros=zeros, bias=b)
    sd = pl.state_dict()
    assert set(sd) == {"qweight", "scales", "zeros", "bias"}
    assert sd["qweight"].dtype == torch.int32 and sd["zeros"].dtype == \
        torch.float16 and tuple(sd["scales"].shape) == (K // 32, N)
    fresh = Linear(K, N, device="cpu", **_kw(32, mode, True))
    fresh.load_state_dict(sd)
    x = torch.from_numpy(A)
    assert torch.equal(fresh(x), pl(x))


def test_native_layer_loads_dense_weight():
    rng = np.random.default_rng(9)
    W = rng.standard_normal((N, K)).astype(np.float16)
    pl = Linear(K, N, A_dtype="float16", W_dtype="float16", opt_M=[16],
                enable_tuning=False, device="cpu")
    pl.load_and_transform_weight(W)
    A = rng.standard_normal((8, K)).astype(np.float16)
    jl = JaxLinear(K, N, A_dtype="float16", W_dtype="float16", opt_M=[16],
                   enable_tuning=False)
    jl.load_and_transform_weight(W)
    assert_close(pl(torch.from_numpy(A)), np.asarray(jl(jnp.asarray(A))),
                 **TOL)


def test_operator_cache_keys_on_group_size(tmp_path):
    """Layers that differ only in group size get their own operators, and
    a hint installed (and saved) for one never routes the other."""
    a = Linear(K, N, device="cpu", **_kw(64, "original", False))
    b = Linear(K, N, device="cpu", **_kw(128, "original", False))
    c = Linear(K, N, device="cpu", **_kw(64, "original", False))
    assert a.bitblas_matmul is c.bitblas_matmul
    assert a.bitblas_matmul is not b.bitblas_matmul
    tiled = TileHint("fused", *dq.FUSED_TILES["uint4"][1])
    a.bitblas_matmul.apply_hints({1: tiled})
    assert b.bitblas_matmul.hint_for(1) != tiled
    global_operator_cache.save_into_database(target="cpu")
    global_operator_cache.clear()
    assert global_operator_cache.load_from_database(target="cpu") == 2
    for g, want in ((64, tiled), (128, None)):
        cfg = MatmulConfig(M=(1, 16), N=N, K=K, A_dtype="float16",
                           W_dtype="uint4", with_scaling=True,
                           with_zeros=True, group_size=g,
                           storage_dtype="int8")
        op = global_operator_cache.get(cfg)
        assert op is not None and (op.hint_for(1) == want if want else
                                   op.hint_for(1) != tiled)


def test_tuning_saves_then_a_new_layer_loads(tmp_path):
    """enable_tuning builds, tunes (on the CPU: the analytic hints) and
    saves the operator; a later process (an empty cache) loads it from
    the database instead of building it."""
    Linear(K, N, device="cpu", **dict(_kw(64, "rescale", True),
                                      enable_tuning=True))
    global_operator_cache.clear()
    again = Linear(K, N, device="cpu", **_kw(64, "rescale", True))
    assert global_operator_cache.size() == 1
    assert global_operator_cache.get(again.bitblas_matmul.config) is \
        again.bitblas_matmul


def _jax_kernel(g, mode, bias, m, seed):
    """JAX Matmul (Pallas, interpret mode) and the port's device operands
    of the same reference operands at M = m."""
    kw = dict(N=N, K=K, A_dtype="float16", W_dtype="uint4",
              with_scaling=True, with_zeros=True, zeros_mode=mode,
              group_size=g, with_bias=bias, out_dtype="float16")
    codes, scales, zeros, b, A = _operands(seed, g, mode, bias)
    jm = JaxMatmul(JaxMatmulConfig(M=[m], **kw), enable_tuning=False)
    jw = jm.transform_weight(codes, scale=scales, zeros=zeros, bias=b)
    want = np.asarray(jm.forward(jnp.asarray(A[:m]), *jw[:3],
                                 **({"bias": jw[3]} if bias else {})))
    pm = Matmul(MatmulConfig(M=[m], **kw), device="cpu")
    pw = pm.transform_weight(codes, scale=scales, zeros=zeros, bias=b)
    return torch.from_numpy(A[:m]), pw, want


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["original", "rescale"])
@pytest.mark.parametrize("g", GROUPS)
def test_decode_split_plain_matches_jax_kernel(g, mode, bias):
    """Kernel 1's decode instance in plain PyTorch (the steps of 128, a
    scale / zero pair a step or a 32-deep quarter, the partials in split
    order, the bias before the one rounding) against JAX's Pallas
    kernel."""
    A, pw, want = _jax_kernel(g, mode, bias, 4, 20 + (g % 7))
    got = dq.dequant_matmul_u4_split_plain(
        A, pw[0], pw[1], pw[2], sms=2, group=K if g == -1 else g,
        bias=pw[3] if bias else None, zeros_mode=mode)
    assert dq.plan_splits_k(4, N, K, 2)[1] > 1    # several splits
    assert_close(got, want, **TOL)
    plain = dq.dequant_matmul_u4_plain(
        A, pw[0], pw[1], pw[2], K if g == -1 else g,
        bias=pw[3] if bias else None, zeros_mode=mode)
    assert_close(got, plain, **TOL)


@pytest.mark.parametrize("mode", ["original", "rescale"])
@pytest.mark.parametrize("g", [32, 64, -1])
def test_weight_decode_u4_plain_matches_jax_oracle(g, mode):
    """Kernel 2's plain version at GPTQ's groups and rescale: bit-equal to
    the JAX oracle's decode (f16) and to its float32 value (f32)."""
    codes, scales, zeros, _, _ = _operands(30, g, mode, False)
    gg = K if g == -1 else g
    pm = Matmul(MatmulConfig(N=N, K=K, A_dtype="float16", W_dtype="uint4",
                             with_scaling=True, with_zeros=True,
                             zeros_mode=mode, group_size=g), device="cpu")
    W, S, Z = pm.transform_weight(codes, scale=scales, zeros=zeros)
    jc = JaxMatmulConfig(N=N, K=K, A_dtype="float16", W_dtype="uint4",
                         with_scaling=True, with_zeros=True,
                         zeros_mode=mode, group_size=g)
    want = _jax_oracle_weight(jc, codes, scales, zeros, mode)
    got = weight_decode_u4(W, S, Z, group=gg, zeros_mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = weight_decode_u4(W, S, Z, torch.float32, group=gg,
                           zeros_mode=mode)
    s = np.repeat(scales.astype(np.float32), gg, axis=1)
    z = np.repeat(zeros.astype(np.float32), gg, axis=1)
    q = codes.astype(np.float32)
    np.testing.assert_array_equal(
        f32.numpy(), q * s - z if mode == "rescale" else (q - z) * s)


def test_materialize_route_adds_bias_in_f32():
    """The materialize plan at M = 512 with GPTQ's group 64 and a bias
    against the JAX oracle."""
    kw = dict(N=N, K=K, A_dtype="float16", W_dtype="uint4",
              with_scaling=True, with_zeros=True, zeros_mode="original",
              group_size=64, with_bias=True, out_dtype="float16")
    codes, scales, zeros, b, _ = _operands(40, 64, "original", True)
    A = np.random.default_rng(41).standard_normal((512, K)).astype(
        np.float16)
    pm = Matmul(MatmulConfig(M=[512], **kw), device="cpu")
    assert pm.hint_for(512).decode_mode == "materialize"
    W, S, Z, B = pm.transform_weight(codes, scale=scales, zeros=zeros,
                                     bias=b)
    got = pm.forward(torch.from_numpy(A), W, scale=S, zeros=Z, bias=B)
    want = np.asarray(jref.matmul_reference(
        JaxMatmulConfig(M=[512], **kw), jnp.asarray(A),
        jnp.asarray(jpack.general_compress(codes, 4)), jnp.asarray(scales),
        jnp.asarray(zeros), bias=jnp.asarray(b)))
    assert_close(got, want, **TOL)


def test_wrapper_refuses_groups_no_instance_takes():
    A = torch.zeros((4, 384), dtype=torch.float16)
    qw = torch.zeros((N, 48), dtype=torch.int32)
    for g in (16, 96, 192):
        s = torch.zeros((384 // g, N), dtype=torch.float16)
        with pytest.raises(NotImplementedError, match=f"group size {g}"):
            dq.dequant_matmul_u4(A, qw, s, s, g)
    # per channel at K = 4160 (no 128-deep step ends there)
    A = torch.zeros((1, 4160), dtype=torch.float16)
    s = torch.zeros((1, N), dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="K=4160"):
        dq.dequant_matmul_u4(A, torch.zeros((N, 520), dtype=torch.int32),
                             s, s, 4160)
    with pytest.raises(ValueError, match="zeros_mode"):
        dq.dequant_matmul_u4(torch.zeros((1, 384), dtype=torch.float16), qw,
                             torch.zeros((3, N), dtype=torch.float16),
                             torch.zeros((3, N), dtype=torch.float16), 128,
                             zeros_mode="quantized")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Linear, QuantLinear, the HF import and load_quant_state run on the
    card unless the caller passes device="cpu": without one they raise."""
    from bitblas_tpu_torch.integration.pytorch import QuantLinear
    from bitblas_tpu_torch.models.hf_import import (
        load_quant_llama_from_hf_gptq)
    from bitblas_tpu_torch.module.checkpoint import (load_quant_state,
                                                     save_quant_state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Linear(K, N, **_kw(64, "original", False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantLinear(4, 64, K, N, bias=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_quant_llama_from_hf_gptq({}, {"num_attention_heads": 4})
    save_quant_state(str(tmp_path / "c"), {"l": {"w": torch.zeros(2)}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_quant_state(str(tmp_path / "c"))


def test_tune_all_fills_the_cache_and_saves(tmp_path):
    """graph.tune_all builds each config's operator (on the CPU: the
    analytic hints), fills the global cache and writes the database; a
    config already cached is reused."""
    from bitblas_tpu_torch.graph import tune_all
    cfgs = [MatmulConfig(M=(1, 16), N=N, K=K, A_dtype="float16",
                         W_dtype="uint4", with_scaling=True, with_zeros=True,
                         group_size=g, zeros_mode="rescale", with_bias=True)
            for g in (32, 128)]
    first = global_operator_cache.get(cfgs[0]) or Matmul(cfgs[0],
                                                         device="cpu")
    global_operator_cache.add(cfgs[0], first)
    ops = tune_all(cfgs, database_path=str(tmp_path / "tuned"),
                   target="cpu", device="cpu")
    assert ops[cfgs[0]] is first and set(ops) == set(cfgs)
    assert all(global_operator_cache.get(c) is ops[c] for c in cfgs)
    assert (tmp_path / "tuned" / "cpu").is_dir()


INT_FORMATS = ("uint1", "uint2", "uint4", "int1", "int2", "int4")


def _int_layer_kw(w_dtype):
    """An int8-activation layer of each kind: uint with zeros (original),
    g = 64, a bias, saturating int8 out; the int family unscaled (JAX's
    transform_weight takes no scales for it): int32 out (int2), float16
    out and a bias (int4), saturating int8 out (int1)."""
    if w_dtype.startswith("uint"):
        return dict(with_scaling=True, with_zeros=True,
                    zeros_mode="original", group_size=64, bias=True,
                    out_dtype="int8")
    return {"int2": dict(accum_dtype="int32", out_dtype="int32"),
            "int4": dict(bias=True, out_dtype="float16"),
            "int1": dict(out_dtype="int8")}[w_dtype]


def _int_operands(seed, w_dtype, kw):
    """Reference-layout operands of an int8-activation layer: codes (uint)
    or values (int) [N, K], scales [N, K/g] f16, integer zeros [N, K/g],
    bias [N], A int8 [5, K]."""
    rng = np.random.default_rng(seed)
    bits = int(w_dtype[-1])
    lo = -(1 << (bits - 1)) if w_dtype.startswith("int") else 0
    codes = rng.integers(lo, lo + (1 << bits), (N, K)).astype(np.int8)
    g = kw.get("group_size", K)
    scales = (rng.standard_normal((N, K // g)) * 0.01 + 0.05).astype(
        np.float16) if kw.get("with_scaling") else None
    zeros = rng.integers(0, 1 << bits, (N, K // g)).astype(np.float16) \
        if kw.get("with_zeros") else None
    b = (rng.standard_normal(N) * 4).astype(np.float32) \
        if kw.get("bias") else None
    A = rng.integers(-64, 64, (5, K)).astype(np.int8)
    return codes, scales, zeros, b, A


@pytest.mark.parametrize("w_dtype", INT_FORMATS)
def test_int8_linear_matches_jax(w_dtype):
    """module.Linear(A_dtype="int8") for every weight of the integer
    column against JAX's Linear on the same operands through
    load_and_transform_weight: int32 outputs bit-equal, saturating int8
    ones within 1 (JAX's kernel scales exact integer sums, the port's
    plain version contracts a float32 weight), float16 ones at TOL."""
    kw = dict(A_dtype="int8", W_dtype=w_dtype, opt_M=[1, 16],
              enable_tuning=False, **_int_layer_kw(w_dtype))
    codes, scales, zeros, b, A = _int_operands(len(w_dtype), w_dtype, kw)
    jl, pl = JaxLinear(K, N, **kw), Linear(K, N, device="cpu", **kw)
    for lin in (jl, pl):
        lin.load_and_transform_weight(codes, scales=scales, zeros=zeros,
                                      bias=b)
    for m in (1, 5):
        got = pl(torch.from_numpy(A[:m]))
        want = np.asarray(jl(jnp.asarray(A[:m])))
        assert str(got.dtype) == f"torch.{kw['out_dtype']}"
        if kw["out_dtype"] == "int32":
            np.testing.assert_array_equal(got.numpy(), want)
        elif kw["out_dtype"] == "int8":
            assert np.abs(got.numpy().astype(np.int32)
                          - want.astype(np.int32)).max() <= 1
        else:
            assert_close(got, want, **TOL)


def test_int8_linear_checkpoint_round_trip(tmp_path):
    """An int8 x uint2 layer (zeros, bias, int8 out) loaded through
    load_and_transform_weight, saved to an npz checkpoint and loaded into
    a new layer: the same buffers and outputs, bit for bit."""
    from bitblas_tpu_torch.module.checkpoint import (load_quant_state,
                                                     save_quant_state)
    kw = dict(A_dtype="int8", W_dtype="uint2", opt_M=[16],
              enable_tuning=False, **_int_layer_kw("uint2"))
    codes, scales, zeros, b, A = _int_operands(12, "uint2", kw)
    pl = Linear(K, N, device="cpu", **kw)
    pl.load_and_transform_weight(codes, scales=scales, zeros=zeros, bias=b)
    assert pl.qweight.dtype == torch.int32 and \
        tuple(pl.qweight.shape) == (N, K // 16)
    assert pl.scales.dtype == pl.zeros.dtype == torch.float16
    path = str(tmp_path / "int8")
    save_quant_state(path, {"l0": dict(pl.state_dict())})
    fresh = Linear(K, N, device="cpu", **kw)
    fresh.load_state_dict(load_quant_state(path, device="cpu")["l0"])
    for name, t in pl.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t), name
    x = torch.from_numpy(A)
    assert torch.equal(fresh(x), pl(x))

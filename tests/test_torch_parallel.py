"""The port's tensor-parallel matmuls and layer (parallel/__init__.py,
parallel/layers.py) against the JAX package's on the 8-device CPU mesh
(JAX's tests/test_parallel.py cases): column-parallel with and without
the gathered output, row-parallel with the all-reduce and with the
reduce-scatter, overlap_chunks, N = 320 (uint4 and e4m3) at tp 2 and 4,
the TP layer at tp 2 and 4, and the row shard that breaks kernel 1's K
rule. One world of four gloo ranks runs every case; tp 2 is ranks 0-1.

Tolerances: against JAX's float32 oracle (ops/reference) JAX's own
(rtol 5e-2, atol 2.0 at K = 1024); against JAX's TP outputs within 1e-2
of their largest value (JAX applies the scales to f32 sums, the port
rounds each weight to f16 first); the port's chunked and unchunked row
products bit for bit (the same kernel on the same columns); the layer at
tp 2 against tp 4 at JAX's (rtol 2e-2, atol 0.1), and against JAX's tp 4
layer within 1e-2 of the largest value.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops.reference import matmul_reference
from bitblas_tpu.ops.weight_transform import transform_reference_operands
from bitblas_tpu import parallel as jpar

from bitblas_tpu_torch.testing import assert_close, random_reference_operands
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.parallel import check_row_shard
from bitblas_tpu_torch.testing.dist import run_world
from bitblas_tpu_torch.testing.ranks import matmul_world

CFG = dict(M=16, N=2048, K=1024, A_dtype="float16", W_dtype="uint4",
           with_scaling=True, group_size=128, fast_decoding=False)
UNALIGNED = {(w, tp): dict(CFG, N=320, K=512, W_dtype=w)
             for w in ("uint4", "e4m3_float8") for tp in (2, 4)}
LAYER = dict(hidden_size=1024, intermediate_size=2048, num_heads=8,
             num_kv_heads=8, num_layers=1, group_size=128)


def _operands(cfg, seed):
    ops = random_reference_operands(MatmulConfig(**cfg), 16, seed)
    return dict(A=ops.A, qweight=ops.qweight, scales=ops.scales)


def _cases():
    base = _operands(CFG, 0)
    cases = [dict(name=kind, tp=4, kind=kind, config=CFG, **base)
             for kind in ("column", "column_gather", "row", "row_scatter")]
    cases += [dict(name=f"overlap{nc}", tp=4, kind="row_overlap",
                   chunks=nc, config=CFG, **base) for nc in (2, 4)]
    cases += [dict(name=f"unaligned_{w}_{tp}", tp=tp, kind="column_gather",
                   config=cfg, **_operands(cfg, 1))
              for (w, tp), cfg in UNALIGNED.items()]
    # Llama-2-7B's down projection at tp 4: K/tp = 2752
    cases.append(dict(name="refuse", tp=4, kind="refuse",
                      config=dict(CFG, N=4096, K=11008)))
    return cases


def _layer_cases():
    x = np.random.default_rng(0).standard_normal((1, 8, 1024)) \
        .astype(np.float16)
    return [dict(name=f"layer_tp{tp}", tp=tp, kind="layer", cfg=LAYER, seed=3,
                 x=x, positions=np.arange(8)[None]) for tp in (2, 4)]


@pytest.fixture(scope="module")
def world():
    return run_world(matmul_world, 4, _cases() + _layer_cases())


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))


def _jax(cfg, seed, kind, tp=4, **kw):
    """(JAX's TP output, JAX's oracle) for one case."""
    jcfg = JaxMatmulConfig(**cfg)
    ops = _operands(cfg, seed)
    dw = transform_reference_operands(jcfg, ops["qweight"], ops["scales"])
    mesh = _mesh(tp)
    if kind.startswith("column"):
        w = jpar.shard_weights_column(dw, mesh, "tp", jcfg)
        fn = jpar.make_column_parallel_matmul(
            jcfg, 16, mesh, "tp", gather_output=True)
    else:
        w = jpar.shard_weights_row(dw, mesh, "tp", jcfg)
        fn = jpar.make_row_parallel_matmul(jcfg, 16, mesh, "tp", **kw)
    out = jax.jit(fn)(jnp.asarray(ops["A"]), w.qweight, scales=w.scales)
    ref = matmul_reference(jcfg, jnp.asarray(ops["A"]),
                           jnp.asarray(ops["qweight"]),
                           jnp.asarray(ops["scales"]))
    return np.asarray(out, np.float32), np.asarray(ref, np.float32)


def _port(res, name, tp, sharded):
    parts = [res[r][name] for r in range(tp)]
    return np.concatenate(parts, axis=1) if sharded else parts[0]


def _held(got, want, ref):
    assert_close(got, ref, rtol=5e-2, atol=2.0)
    assert_close(got, want, rtol=0.0,
                 atol=1e-2 * float(np.abs(want).max()),
                 max_mismatched_ratio=0.0)


@pytest.mark.parametrize("name,sharded", [
    ("column", True), ("column_gather", False), ("row", False),
    ("row_scatter", True)])
def test_parallel_matmuls_match_jax(world, name, sharded):
    """Column-parallel (this rank's N shard, or gathered) and row-parallel
    (the all-reduce, or this rank's N shard of the reduce-scatter): the
    ranks' outputs assembled against JAX's and the oracle."""
    res = world
    got = _port(res, name, 4, sharded)
    assert got.shape == (16, 2048)
    kw = {"reduce_scatter": True} if name == "row_scatter" else {}
    want, ref = _jax(CFG, 0, name, **kw)
    _held(got, want, ref)
    if not sharded:               # a replicated output, on every rank
        for r in range(1, 4):
            np.testing.assert_array_equal(res[r][name], got)


@pytest.mark.parametrize("nc", [2, 4])
def test_row_parallel_overlap_chunks(world, nc):
    """overlap_chunks: the chunked all-reduces give the unchunked product
    bit for bit, and JAX's chunked run."""
    res = world
    got = res[0][f"overlap{nc}"]
    np.testing.assert_array_equal(got, res[0]["row"])
    want, ref = _jax(CFG, 0, "row", overlap_chunks=nc)
    _held(got, want, ref)


@pytest.mark.parametrize("w_dtype,tp", list(UNALIGNED))
def test_column_parallel_unaligned_n(world, w_dtype, tp):
    """N = 320 at tp 2 and 4 (N/tp = 160 / 80: no whole TPU pack tile,
    which JAX retiles; a K-packed row slice here): gathered output
    against JAX's and the oracle."""
    res = world
    got = res[0][f"unaligned_{w_dtype}_{tp}"]
    assert got.shape == (16, 320)
    want, ref = _jax(UNALIGNED[w_dtype, tp], 1, "column_gather", tp=tp)
    _held(got, want, ref)


def test_tp_layer_mesh_invariance(world):
    """TPQuantLlamaLayer (JAX's draws from one seed) gives the same
    forward at tp 2 and 4, and JAX's tp 4 layer."""
    from bitblas_tpu.models.quant_llama import LlamaConfig as JaxLlamaConfig
    from bitblas_tpu.parallel.layers import (TPQuantLlamaLayer,
                                             tp_layer_forward)
    layers = world
    a, b = layers[0]["layer_tp2"], layers[0]["layer_tp4"]
    assert a.shape == (1, 8, 1024) and np.all(np.isfinite(a))
    assert_close(a, b, rtol=2e-2, atol=0.1)
    case = _layer_cases()[1]
    layer = TPQuantLlamaLayer(JaxLlamaConfig(**LAYER), _mesh(4), m=8, seed=3)
    want = np.asarray(tp_layer_forward(layer, jnp.asarray(case["x"]),
                                       jnp.asarray(case["positions"])),
                      np.float32)
    assert_close(b, want, rtol=0.0, atol=1e-2 * float(np.abs(want).max()),
                 max_mismatched_ratio=0.0)


def test_row_shard_refused(world):
    """Llama-2-7B's down projection (K = 11008) at tp 4: K/tp = 2752 is
    not a multiple of 128, and the shard is refused with the numbers."""
    res = world
    assert "K/tp=2752" in res[0]["refuse"] and "128" in res[0]["refuse"]
    with pytest.raises(ValueError, match="K/tp=2752"):
        check_row_shard(MatmulConfig(**dict(CFG, N=4096, K=11008)), 4)

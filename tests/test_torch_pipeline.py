"""The port's GPipe schedule (parallel/pipeline: stack_stage_params,
make_gpipe_fn, make_quant_stage_fn over batch_isend_irecv) against the
JAX package's on the 8-device CPU mesh and against every stage applied in
turn on one rank (JAX's tests/test_pipeline_parallel.py: 4 stages of 2
uint4 g128 layers at N = K = 256, microbatches of 4 rows; 3, 1 and 6
microbatches). One world of four gloo ranks runs every case.

Tolerances: the pipeline against the port's sequential run bit for bit
(the same kernels on the same inputs; the schedule only moves them),
against JAX's pipeline within JAX's 5e-2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops.weight_transform import transform_reference_operands
from bitblas_tpu.parallel.pipeline import (make_gpipe_fn,
                                           make_quant_stage_fn,
                                           stack_stage_params)

from bitblas_tpu_torch.testing import random_reference_operands
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.testing.dist import run_world
from bitblas_tpu_torch.testing.ranks import pipeline_world

PP, LAYERS, B, H = 4, 2, 4, 256
CONFIG = dict(M=B, N=H, K=H, A_dtype="float16", W_dtype="uint4",
              with_scaling=True, group_size=128, out_dtype="float16")
CASES = {"three": (7, 0, 3), "one": (3, 1, 1), "six": (3, 2, 6)}


def _layers(seed):
    """Each stage's layers' reference-layout (qweight, scales): JAX's
    draws (tests/test_pipeline_parallel.py _build) with the scales cut
    500-fold. At JAX's own scales (about 0.5; no zero point, so every
    weight is positive) eight layers overflow float16 and both pipelines
    hold NaN, which its test's assert_allclose counts as equal."""
    cfg = MatmulConfig(**CONFIG)
    return [[(o.qweight, (o.scales * 0.002).astype(np.float16)) for o in
             (random_reference_operands(cfg, B, seed + s * 10 + i)
              for i in range(LAYERS))] for s in range(PP)]


def _xs(seed, n_micro):
    return np.random.default_rng(seed).standard_normal(
        (n_micro, B, H)).astype(np.float16)


@pytest.fixture(scope="module")
def world():
    cases = [dict(name=name, tp=PP, config=CONFIG, m=B,
                  stages=_layers(w_seed), xs=_xs(x_seed, n))
             for name, (w_seed, x_seed, n) in CASES.items()]
    return run_world(pipeline_world, PP, cases)


def _jax_pipeline(name):
    w_seed, x_seed, n = CASES[name]
    cfg = JaxMatmulConfig(**CONFIG)
    stages = []
    for layers in _layers(w_seed):
        dws = [transform_reference_operands(cfg, q, s) for q, s in layers]
        stages.append({"qweight": jnp.stack([d.qweight for d in dws]),
                       "scales": jnp.stack([d.scales for d in dws])})
    mesh = Mesh(np.array(jax.devices()[:PP]), ("pp",))
    pipe = make_gpipe_fn(make_quant_stage_fn(cfg, B, LAYERS), mesh, "pp")
    return np.asarray(pipe(stack_stage_params(stages, mesh, "pp"),
                           jnp.asarray(_xs(x_seed, n))), np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_gpipe_matches_sequential_and_jax(world, name):
    """3 microbatches, 1 (all bubble) and 6 (> pp): the pipelined
    outputs on every rank equal the sequential run, and JAX's pipeline."""
    res = world[0][name]
    assert res["ys"].shape == (CASES[name][2], B, H)
    assert np.all(np.isfinite(res["ys"]))
    np.testing.assert_array_equal(res["ys"], res["ref_ys"])
    for r in range(1, PP):                    # the broadcast reached all
        np.testing.assert_array_equal(world[r][name]["ys"], res["ys"])
    np.testing.assert_allclose(res["ys"], _jax_pipeline(name), rtol=5e-2,
                               atol=5e-2)

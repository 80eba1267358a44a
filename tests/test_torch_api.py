"""The port's public surface against the JAX package's, on the CPU: the
operator accessors (Matmul's config properties, `transform_input`,
`kernel_name_generator`, `Operator.kernel_for`), the kernel-name
generators' base class, `DeviceWeights.args`, `BlockAllocator.alloc_many`,
`ops.common.BackendKind` / `QuantizationMemoryStage`, `testing.main`, and
the names the package and its `ops` export (lazily: importing the package
builds and loads no kernel module).

Values are compared with JAX's for the same configuration. `kernel_for`'s
output is held to JAX's at the Pallas tolerance of tests/test_torch_splitk.py
(rtol 1e-2, atol 1.0: JAX's interpret-mode kernel decodes to its own mma
type) and to the port's own forward bit for bit (the same plan).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bitblas_tpu
from bitblas_tpu import ops as jops
from bitblas_tpu.ops import common as jcommon
from bitblas_tpu.ops.flashatten import FlashAtten as JaxFlashAtten
from bitblas_tpu.ops.flashatten import FlashAttenConfig as JaxFlashAttenConfig
from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops import weight_transform as jwt
from bitblas_tpu.serving.kv_cache import BlockAllocator as JaxBlockAllocator
from bitblas_tpu.testing import random_reference_operands

import bitblas_tpu_torch
from bitblas_tpu_torch import ops as pops
from bitblas_tpu_torch import testing as ptesting
from bitblas_tpu_torch.ops import common as pcommon
from bitblas_tpu_torch.ops.flashatten import (FlashAtten, FlashAttenConfig,
                                              FlashAttenKernelNameGenerator)
from bitblas_tpu_torch.ops.matmul import Matmul, MatmulKernelNameGenerator
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.ops.operator import BaseKernelNameGenerator
from bitblas_tpu_torch.ops import weight_transform as pwt
from bitblas_tpu_torch.serving.kv_cache import BlockAllocator
from bitblas_tpu_torch.testing import assert_close

CONFIGS = {
    "uint4_g128_zeros": dict(M=16, N=512, K=512, A_dtype="float16",
                             W_dtype="uint4", with_scaling=True,
                             with_zeros=True, group_size=128),
    "uint4_per_channel": dict(M=16, N=512, K=512, A_dtype="float16",
                              W_dtype="uint4", with_scaling=True),
    "int2_int8": dict(M=(1, 16, 256), N=256, K=512, A_dtype="int8",
                      W_dtype="int2", accum_dtype="int32",
                      out_dtype="float32"),
    "f16_dense_bias": dict(M=64, N=256, K=128, A_dtype="float16",
                           W_dtype="float16", with_bias=True),
    "nf4_bf16_g64": dict(M=32, N=256, K=512, A_dtype="bfloat16",
                         W_dtype="nf4", out_dtype="bfloat16",
                         with_scaling=True, group_size=64),
}
PROPERTIES = ("M", "N", "K", "A_dtype", "W_dtype", "out_dtype",
              "accum_dtype", "with_scaling", "with_zeros",
              "group_size", "fast_decoding", "with_bias", "zeros_mode",
              "source_format", "bit", "layout")


def _pair(name):
    kw = CONFIGS[name]
    return (Matmul(MatmulConfig(**kw), device="cpu", enable_tuning=False),
            JaxMatmul(JaxMatmulConfig(**kw), enable_tuning=False))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matmul_config_properties_match_jax(name):
    op, jop = _pair(name)
    for prop in PROPERTIES:
        assert getattr(op, prop) == getattr(jop, prop), prop
    assert op.group_size == op.config.effective_group_size
    # the storage of each package's own device layout: a native weight
    # in its type in both; a packed one in the port's K-packed int32
    # words where JAX packs bytes
    if op.config.is_native_compute():
        assert op.storage_dtype == jop.storage_dtype == op.W_dtype
    else:
        assert (op.storage_dtype, jop.storage_dtype) == ("int32", "int8")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_transform_input_is_the_identity(name):
    op, jop = _pair(name)
    a = torch.arange(12.0).reshape(3, 4)
    assert op.transform_input(a) is a
    assert jop.transform_input(a) is a


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_name_generator_keeps_jax_prefix(name):
    op, jop = _pair(name)
    gen = op.kernel_name_generator
    assert isinstance(gen, MatmulKernelNameGenerator)
    assert isinstance(gen, BaseKernelNameGenerator)
    m = op.config.m_buckets[0]
    jname = jop.kernel_name_generator.generate(jop.hint_for(m))
    name_ = gen.generate(op.hint_for(m))
    prefix = jname[:jname.index("_t") + 2]
    assert name_.startswith(prefix), (name_, jname)
    assert gen.generate() == jop.kernel_name_generator.generate()


def test_kernel_name_of_jax_test():
    # tests/test_matmul_operator.py:119-123
    op = Matmul(MatmulConfig(M=16, N=512, K=512, A_dtype="float16",
                             W_dtype="uint4"), device="cpu",
                enable_tuning=False)
    name = op.kernel_name_generator.generate(op.hint_for(16))
    assert name.startswith("matmul_m16n512k512_f16xu4_t")
    assert MatmulKernelNameGenerator.simplify_dtype("bfloat16") == "bf16"


def test_base_kernel_name_generator():
    class Named(BaseKernelNameGenerator):
        def is_valid_config(self, config):
            return isinstance(config, MatmulConfig)

    cfg = MatmulConfig(**CONFIGS["uint4_g128_zeros"])
    gen = Named(cfg)
    assert gen.config is cfg and gen.KERNEL_PREFIX == "kernel"
    with pytest.raises(NotImplementedError):
        gen.generate()
    with pytest.raises(ValueError):
        Named(FlashAttenConfig(batch=1, heads=4, seq_len=64, dim=64))
    with pytest.raises(NotImplementedError):
        BaseKernelNameGenerator(cfg)


def test_flashatten_generator_derives_from_base():
    kw = dict(batch=1, heads=4, kv_heads=4, seq_len=64, dim=64,
              is_causal=True)
    op = FlashAtten(FlashAttenConfig(**kw), device="cpu")
    jop = JaxFlashAtten(JaxFlashAttenConfig(**kw))
    assert isinstance(op.kernel_name_generator, FlashAttenKernelNameGenerator)
    assert issubclass(FlashAttenKernelNameGenerator, BaseKernelNameGenerator)
    assert op.kernel_name_generator.generate() == \
        jop.kernel_name_generator.generate()
    with pytest.raises(ValueError):
        FlashAttenKernelNameGenerator(MatmulConfig(**CONFIGS["int2_int8"]))


@pytest.mark.parametrize("m", [1, 16, 256])
def test_kernel_for_runs_the_bucket_hint(m):
    kw = CONFIGS["int2_int8"]
    cfg = MatmulConfig(**kw)
    op = Matmul(cfg, device="cpu", enable_tuning=False)
    jop = JaxMatmul(JaxMatmulConfig(**kw), enable_tuning=False)
    ops = random_reference_operands(JaxMatmulConfig(**kw), m, seed=m)
    W = op.transform_weight(_int2_values(ops.qweight, cfg.K))
    jW = jop.transform_weight(_int2_values(ops.qweight, cfg.K))
    fn = op.kernel_for(m)
    out = fn(torch.from_numpy(ops.A), W)
    assert torch.equal(out, op.forward(torch.from_numpy(ops.A), W))
    jout = jop.kernel_for(m)(jnp.asarray(ops.A), jW, scales=None,
                             zeros=None, bias=None)
    assert_close(out, np.asarray(jout, np.float32), rtol=1e-2, atol=1.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _int2_values(qweight: np.ndarray, K: int) -> np.ndarray:
    """Reference int2 codes (biased) -> their values -2..1."""
    from bitblas_tpu_torch.quantization import packing
    codes = packing.general_decompress(qweight, 2, out_elems=K)
    return codes.astype(np.int8) - 2


def test_kernel_for_uint4_matches_jax():
    kw = CONFIGS["uint4_g128_zeros"]
    jcfg = JaxMatmulConfig(**kw)
    op = Matmul(MatmulConfig(**kw), device="cpu", enable_tuning=False)
    jop = JaxMatmul(jcfg, enable_tuning=False)
    ops = random_reference_operands(jcfg, 16, seed=3)
    from bitblas_tpu_torch.quantization import packing
    codes = packing.general_decompress(ops.qweight, 4)
    W, S, Z = op.transform_weight(codes, scale=ops.scales, zeros=ops.zeros)
    jW, jS, jZ = jop.transform_weight(codes, scale=ops.scales,
                                      zeros=ops.zeros)
    out = op.kernel_for(16)(torch.from_numpy(ops.A), W, S, Z)
    assert torch.equal(out, op.forward(torch.from_numpy(ops.A), W, scale=S,
                                       zeros=Z))
    jout = jop.kernel_for(16)(jnp.asarray(ops.A), jW, scales=jS, zeros=jZ,
                              bias=None)
    assert_close(out, np.asarray(jout, np.float32), rtol=1e-2, atol=1.0)


@pytest.mark.parametrize("present", [(1, 0, 0), (1, 1, 0), (1, 1, 1),
                                     (0, 0, 1), (1, 0, 1)])
def test_device_weights_args(present):
    s, z, b = present
    q = np.arange(8, dtype=np.int32).reshape(2, 4)
    kw = dict(scales=np.ones((1, 4)) if s else None,
              zeros=np.zeros((1, 4)) if z else None,
              bias=np.full((1, 4), 2.0) if b else None)
    jargs = jwt.DeviceWeights(qweight=q, **kw).args()
    pargs = pwt.DeviceWeights(
        qweight=torch.from_numpy(q),
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()}).args()
    assert len(pargs) == len(jargs) == 1 + s + z + b
    for p, j in zip(pargs, jargs):
        np.testing.assert_array_equal(p.numpy(), j)


def test_block_allocator_alloc_many_matches_jax():
    alloc, jalloc = BlockAllocator(10), JaxBlockAllocator(10)
    for step in (3, 4, 5, 2, 1, 9):
        got, want = alloc.alloc_many(step), jalloc.alloc_many(step)
        assert got == want
        assert alloc.available == jalloc.available
        if got is not None and step == 4:
            alloc.release(got)
            jalloc.release(want)
    assert alloc.alloc_many(alloc.available + 1) is None
    assert alloc.alloc_many(0) == []


def test_backend_and_memory_stage_enums():
    assert {m.name: m.value for m in pcommon.QuantizationMemoryStage} == \
        {m.name: m.value for m in jcommon.QuantizationMemoryStage}
    # the port's two backends in place of Pallas / XLA
    assert [(m.name, m.value) for m in pcommon.BackendKind] == \
        [("CUDA", 0), ("PyTorch", 1)]
    assert len(pcommon.BackendKind) == len(jcommon.BackendKind)
    assert pops.BackendKind is pcommon.BackendKind


def test_testing_main_runs_the_caller(monkeypatch):
    import pytest as pytest_module
    seen = []
    monkeypatch.setattr(pytest_module, "main",
                        lambda args: seen.append(args) or 3)
    with pytest.raises(SystemExit) as exit_:
        ptesting.main()
    assert exit_.value.code == 3
    assert seen == [[__file__]]


# JAX's __all__ names that are TPU-only (ROADMAP queue 1 item 6); the
# port's auto_detect_target stands in their place
TPU_ONLY = {"auto_detect_tpu_target", "enable_jax_compilation_cache"}


def test_package_exports_jax_surface():
    want = set(bitblas_tpu.__all__) - TPU_ONLY
    assert want <= set(bitblas_tpu_torch.__all__)
    assert set(bitblas_tpu_torch.__all__) - want == {"auto_detect_target",
                                                      "resolve_device"}
    for name in bitblas_tpu_torch.__all__:
        value = getattr(bitblas_tpu_torch, name)
        if name != "__version__":
            assert value.__module__.startswith("bitblas_tpu_torch"), name
    assert bitblas_tpu_torch.__version__ == bitblas_tpu.__version__
    assert bitblas_tpu_torch.Matmul is Matmul
    with pytest.raises(AttributeError):
        bitblas_tpu_torch.auto_detect_tpu_target


# bitblas_tpu/ops/__init__.py:3-14
JAX_OPS = ("BackendKind", "OptimizeStrategy", "TransformKind", "MatmulConfig",
           "OperatorConfig", "Matmul", "MatmulConfigWithSplitK",
           "MatmulWithSplitK", "FlashAtten", "FlashAttenConfig",
           "LadderPermutate", "LadderPermutateConfig", "LOP3Permutate",
           "LOP3PermutateConfig", "QuantCompress", "QuantCompressConfig",
           "Conv2D", "Conv2DConfig", "QuantConv2D", "QuantConv2DConfig",
           "BatchMatmul", "BatchMatmulConfig", "Operator")


@pytest.mark.parametrize("name", JAX_OPS)
def test_ops_exports(name):
    assert hasattr(jops, name)
    value = getattr(pops, name)
    assert value.__module__.startswith("bitblas_tpu_torch.ops."), name
    assert value.__name__ == name
    assert name in pops.__all__


def test_import_stays_light():
    code = (
        "import sys\n"
        "import bitblas_tpu_torch as b\n"
        "loaded = sorted(m for m in sys.modules"
        " if m.startswith('bitblas_tpu_torch'))\n"
        "assert loaded == ['bitblas_tpu_torch', 'bitblas_tpu_torch.common'],"
        " loaded\n"
        "assert b.QuantConv2D.__name__ == 'QuantConv2D'\n"
        "assert not any(m == 'jax' or m.startswith('bitblas_tpu.')"
        " for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr


def test_chained_timer_needs_the_card(monkeypatch):
    from bitblas_tpu_torch.utils import timing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="make_chained"):
        timing.make_chained(lambda: None, ())
    with pytest.raises(RuntimeError, match="measure_chained"):
        timing.measure_chained(lambda iters: None)
    with pytest.raises(RuntimeError, match="measure_kernel"):
        timing.measure_kernel(lambda: None, ())

"""The port's tuner (tuner/arch.py, hint.py, space.py, tune.py,
utils/timing.py) and the operator's bucket dispatch (ops/operator.py,
ops/matmul.py), on the CPU.

On the CPU nothing is measured: the operator keeps the analytic defaults,
as the JAX operator does in interpret mode. What is checked here is the
space's legality, the default routing (which must reproduce the routing
the port had before the tuner, for every M), the hint round trip, the
stratified candidate set and the dispatch of installed hints by bucket.
The measuring half runs on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py's tune phase).
"""

import numpy as np
import pytest
import torch

from bitblas_tpu.tuner.hint import TileHint as JaxTileHint

import bitblas_tpu_torch.ops.matmul as pmm
from bitblas_tpu_torch.kernels.dense import DENSE_TILES, dense_smem_bytes
from bitblas_tpu_torch.kernels.dequant_matmul import (FUSED_TILES,
                                                      fused_smem_bytes)
from bitblas_tpu_torch.kernels.spec import KernelSpec
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.tuner import (CPU, H100_SXM, MATERIALIZE, TileHint,
                                     auto_detect_target, default_hint,
                                     enumerate_hints, fast_tune,
                                     fast_tune_with_dynamic_range, get_arch,
                                     roofline_seconds, smem_bytes)
from bitblas_tpu_torch.tuner.tune import _stratified_candidates
from bitblas_tpu_torch.utils import timing

U4 = dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
          with_zeros=True, zeros_mode="original", group_size=128,
          out_dtype="float16")
I2 = dict(A_dtype="int8", W_dtype="int2", accum_dtype="int32",
          out_dtype="float32")
FORMATS = {"uint4": U4, "int2": I2}
# The untuned routing: the split-K decode instance up to M = 16 (it
# replaced, in both formats, the 16 x 32 tile the port ran before it had a
# tuner), the 64-token x 128-row wgmma + TMA tile above (block_k: 256 f16
# or 512 int8, four 128-byte rows of A a ring slot), the materialize plan
# from M = 512.
UNTUNED_SMALL = {"uint4": (16, 128, 128, 4), "int2": (16, 128, 256, 4)}
UNTUNED_LARGE = {"uint4": (64, 128, 256, 4), "int2": (64, 128, 512, 2)}
# The N of the models' projections (Llama-2-7B: 4096, 11008; Llama-3-8B
# widths, BitNet: 4096, 1024, 14336; Mixtral-8x7B's uint4 experts: 14336,
# 4096).
# the N of every projection the models run: Llama-2-7B, Llama-3-8B /
# BitNet, and the rank-local N of Llama-3-70B at tp 2 (parallel/serving:
# the fused q/k/v, (32 + 2 * 4) heads * 128 = 5120, and the fused gate /
# up, 2 * 14336 = 28672; its o and down keep N = 8192)
MODEL_N = (4096, 11008, 14336, 1024, 5120, 28672, 8192)
# Mixtral-8x7B's expert projections (N, K): gate / up, down
MIXTRAL_EXPERTS = ((14336, 4096), (4096, 14336))


def _untuned_hint(fmt, m):
    if m >= 512:
        return MATERIALIZE
    tile = UNTUNED_SMALL[fmt] if m <= 16 else UNTUNED_LARGE[fmt]
    return TileHint("fused", *tile)


def _spec(fmt, m, N=4096, K=4096):
    return KernelSpec.from_config(MatmulConfig(N=N, K=K, **FORMATS[fmt]), m)


@pytest.mark.parametrize("name", ["h100_sxm", "H100", "cpu"])
def test_get_arch_known_targets(name):
    arch = get_arch(name)
    assert arch is (CPU if name == "cpu" else H100_SXM)


@pytest.mark.parametrize("name", ["tpu_v5e", "a100", "h200", "cpu_interpret"])
def test_get_arch_unknown_target_raises(name):
    with pytest.raises(ValueError, match="Unknown target"):
        get_arch(name)


def test_h100_envelope_is_the_data_sheet():
    a = H100_SXM
    assert (a.hbm_bandwidth, a.flops_f16, a.flops_int8, a.flops_f32) == \
        (3.35e12, 989e12, 1979e12, 67e12)
    assert (a.sm_count, a.smem_per_block, a.l2_bytes) == \
        (132, 232448, 50 * 2 ** 20)
    assert not a.is_cpu and CPU.is_cpu


def test_cpu_operator_targets_the_cpu():
    assert auto_detect_target(torch.device("cpu")) == "cpu"
    op = Matmul(MatmulConfig(N=256, K=512, **I2), device="cpu")
    assert op.arch is CPU


def test_every_compiled_instance_fits_shared_memory():
    for fmt, tiles in FUSED_TILES.items():
        for tile in tiles:
            assert fused_smem_bytes(fmt, tile) <= H100_SXM.smem_per_block
    for dt in (torch.float16, torch.bfloat16, torch.float32, torch.int8):
        for tile in DENSE_TILES:
            assert dense_smem_bytes(dt, tile) <= H100_SXM.smem_per_block
    # the sources' own sizes: the wgmma + TMA ring (1024 bytes of
    # alignment; slots of four A boxes, the packed W and, for uint4, two
    # scale and two zero rows, each rounded up to 1024 bytes; two
    # mbarriers a slot) and int2's decode instance (A over 8 steps of 256
    # and 16 rows, its 16 row sums, the 4-stage ring of two 16-byte weight
    # chunks a thread)
    assert fused_smem_bytes("uint4", (64, 128, 256, 4)) == 201792
    assert fused_smem_bytes("uint4", (128, 64, 256, 3)) == 225328
    assert fused_smem_bytes("int2", (128, 128, 512, 2)) == 164896
    assert fused_smem_bytes("int2", (16, 128, 256, 4)) == 65600


@pytest.mark.parametrize("fmt", ["uint4", "int2"])
def test_every_fused_instance_fits_and_tiles_the_models_n(fmt):
    """Each compiled instance of both formats fits the 227 KB a block may
    take, and its block_n divides every N the two models run, so the
    tuner's space (whole N tiles) keeps every instance at every shape; the
    tiled instances are the wgmma + TMA loop's: 32 / 64 / 128 tokens
    (a wgmma n), 64 or 128 weight rows (one warpgroup each 64), block_k
    four 128-byte rows of A (uint4, whose sums take more registers, has
    no 128 x 128 tile)."""
    for tile in FUSED_TILES[fmt]:
        assert fused_smem_bytes(fmt, tile) <= 232448
        assert all(n % tile[1] == 0 for n in MODEL_N), tile
    want = {"uint4": ((32, 64, 256, 4), (64, 128, 256, 4),
                      (128, 64, 256, 3)),
            "int2": ((32, 64, 512, 4), (64, 128, 512, 2),
                     (128, 64, 512, 3), (128, 128, 512, 2))}
    assert FUSED_TILES[fmt][1:] == want[fmt]
    assert FUSED_TILES[fmt][2] == UNTUNED_LARGE[fmt]


@pytest.mark.parametrize("N,K", MIXTRAL_EXPERTS)
def test_uint4_instances_tile_mixtral_experts(N, K):
    """Every uint4 instance's block_n (the decode instance's too) divides
    Mixtral-8x7B's expert N, so each stays in the tuner's space there; an
    expert at the decode capacity (8) takes the split-K decode instance,
    at a prefill capacity of 256 the default tiled instance, from 512
    the materialize plan."""
    for tile in FUSED_TILES["uint4"]:
        assert N % tile[1] == 0 and 14336 % tile[1] == 0, tile
    for m, want in ((8, TileHint("fused", *UNTUNED_SMALL["uint4"])),
                    (256, TileHint("fused", *UNTUNED_LARGE["uint4"])),
                    (512, MATERIALIZE), (2048, MATERIALIZE)):
        spec = _spec("uint4", m, N, K)
        assert default_hint(spec, H100_SXM) == want, m
        assert want in enumerate_hints(spec, H100_SXM) or want is MATERIALIZE


@pytest.mark.parametrize("m", [1, 16, 256, 512])
@pytest.mark.parametrize("fmt,N,K", [("uint4", 11008, 4096),
                                     ("uint4", 4096, 11008),
                                     ("int2", 14336, 4096),
                                     ("int2", 1024, 4096)])
def test_enumerate_hints_is_legal(fmt, N, K, m):
    spec = _spec(fmt, m, N, K)
    hints = enumerate_hints(spec, H100_SXM)
    assert hints[0] == default_hint(spec, H100_SXM)
    assert len(set(hints)) == len(hints)
    for h in hints:
        assert smem_bytes(spec, h) <= H100_SXM.smem_per_block
        if h.decode_mode == "fused":
            assert h.tile in FUSED_TILES[fmt]
            assert N % h.block_n == 0
        else:
            assert h == MATERIALIZE
    assert (MATERIALIZE in hints) == (m >= 256)
    assert len(hints) == len(FUSED_TILES[fmt]) + (m >= 256)
    # the space on the CPU is the card's
    assert enumerate_hints(spec, CPU) == hints


def test_enumerate_hints_keeps_the_default_of_a_ragged_n():
    """N = 136 is no multiple of the wider tiles: the space drops them but
    keeps the default (the kernel masks the ragged N tile)."""
    spec = _spec("uint4", 4, N=136, K=256)
    hints = enumerate_hints(spec, H100_SXM)
    assert hints == [TileHint("fused", *UNTUNED_SMALL["uint4"])]


@pytest.mark.parametrize("fmt", ["uint4", "int2"])
def test_default_hint_reproduces_the_untuned_routing(fmt):
    for m in range(1, 4097):
        assert default_hint(_spec(fmt, m), H100_SXM) == \
            _untuned_hint(fmt, m), m


@pytest.mark.parametrize("fmt", ["uint4", "int2"])
def test_untuned_matmul_routes_every_m_as_before(fmt):
    """With the default buckets (1 ... 1024), M = 257..511 falls in bucket
    512 and M > 1024 past the largest: an untuned operator still routes
    each M by its true value."""
    op = Matmul(MatmulConfig(N=4096, K=4096, **FORMATS[fmt]), device="cpu")
    assert not op.tuned_hints
    for m in range(1, 4097):
        assert op.hint_for(m) == _untuned_hint(fmt, m), m


def test_installed_hints_route_by_bucket(monkeypatch):
    calls = []
    for name in ("dequant_matmul_u4", "dequant_matmul_i2",
                 "materialize_matmul"):
        fn = getattr(pmm, name)
        monkeypatch.setattr(pmm, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, k.get("tile"))), _f(*a, **k))[1])
    op = Matmul(MatmulConfig(M=[1, 16, 256], N=256, K=512, **I2),
                device="cpu")
    mid = TileHint("fused", 32, 64, 512, 4)
    op.apply_hints({16: mid, 256: MATERIALIZE, 4096: MATERIALIZE})
    assert op.tuned_hints == {16: mid, 256: MATERIALIZE}
    assert set(op.hints) == {1, 16, 256}          # 4096 is no bucket
    W = op.transform_weight(np.zeros((256, 512), np.int8))
    for m, want in ((1, ("dequant_matmul_i2", UNTUNED_SMALL["int2"])),
                    (2, ("dequant_matmul_i2", mid.tile)),
                    (16, ("dequant_matmul_i2", mid.tile)),
                    (17, ("materialize_matmul", None)),
                    (256, ("materialize_matmul", None)),
                    (300, ("dequant_matmul_i2", UNTUNED_LARGE["int2"]))):
        calls.clear()
        out = op.forward(torch.zeros((m, 512), dtype=torch.int8), W)
        assert out.shape == (m, 256) and calls == [want], m
        assert op.select_bucket(m) == min([b for b in (1, 16, 256)
                                           if b >= m] or [256])


@pytest.mark.parametrize("fmt", ["uint4", "int2"])
def test_fast_tune_on_the_cpu_returns_the_analytic_pick(fmt):
    spec = _spec(fmt, 256)

    def never(*_):
        raise AssertionError("nothing is built or measured on the CPU")

    res = fast_tune(spec, CPU, builder=never, make_args=never)
    assert not res.measured and not res.candidates
    assert res.hint == default_hint(spec, CPU)
    assert res.latency == roofline_seconds(spec, res.hint, CPU)


def test_fast_tune_with_dynamic_range_tunes_every_bucket():
    results = fast_tune_with_dynamic_range(
        lambda m: _spec("int2", m), (1, 16, 256), CPU,
        builder=lambda s, h: None, make_args=lambda s, h: ())
    assert sorted(results) == [1, 16, 256]
    for m, res in results.items():
        assert not res.measured
        assert res.hint == default_hint(_spec("int2", m), CPU)


def test_tuning_on_the_cpu_measures_nothing():
    op = Matmul(MatmulConfig(M=[1, 256], N=256, K=512, **U4), device="cpu",
                enable_tuning=True)
    assert not op.tuned_hints and not op.tune_results
    assert op.hints == {m: default_hint(op._make_spec(m), CPU)
                        for m in (1, 256)}
    assert op.profile_latency(256) == roofline_seconds(
        op._make_spec(256), op.hints[256], CPU)


def test_roofline_is_the_perf_md_bound():
    """The bound PERF.md gives kernel 1 at M = 4 (bytes over 3.35 TB/s)."""
    f = TileHint("fused", *UNTUNED_SMALL["uint4"])
    u4 = roofline_seconds(_spec("uint4", 4, 11008, 4096), f, H100_SXM)
    i2 = roofline_seconds(_spec("int2", 4, 14336, 4096), f, H100_SXM)
    assert round(u4 * 1e3, 6) == 0.007186 and round(i2 * 1e3, 6) == 0.004455
    # the materialize plan also writes and reads the decoded weight
    big = _spec("int2", 4096, 14336, 4096)
    assert roofline_seconds(big, MATERIALIZE, H100_SXM) >= \
        roofline_seconds(big, f, H100_SXM)


def test_stratified_candidates_keep_the_jax_contract():
    """Half of topk from the ranked prefix, then one representative of
    every family not yet picked, then the next-ranked."""
    f = [TileHint("fused", 16, 32, 128, 6), TileHint("fused", 16, 32, 128, 6,
                                                      "highest"),
         TileHint("fused", 32, 64, 128, 4), TileHint("fused", 64, 128, 128, 3),
         MATERIALIZE, TileHint("fused", 128, 128, 128, 3)]
    assert _stratified_candidates(f, 2) == [f[0], f[2]]
    assert _stratified_candidates(f, 4) == [f[0], f[1], f[2], f[3]]
    assert _stratified_candidates(f, 5) == [f[0], f[1], f[2], f[3], f[4]]
    assert _stratified_candidates(f, 20) == [f[0], f[1], f[2], f[3], f[4],
                                             f[5]]
    assert _stratified_candidates(f[:1], 1) == f[:1]


@pytest.mark.parametrize("hint", [
    TileHint(), MATERIALIZE, TileHint("fused", 16, 32, 256, 4),
    TileHint("dense", 16, 128, 128, 0, "highest")])
def test_tile_hint_dict_round_trip(hint):
    d = hint.to_dict()
    assert TileHint.from_dict(d) == hint
    # fields the port does not have (JAX's TPU knobs) are ignored
    assert TileHint.from_dict({**d, "mma_dtype": "bfloat16",
                               "lut_mode": "take"}) == hint


def test_tile_hint_names_and_checks():
    assert TileHint("fused", 16, 32, 128, 6).short_name() == \
        "fused_t16x32x128s6"
    assert MATERIALIZE.short_name() == "materialize"
    assert TileHint("dense", 16, 128, 128, 0, "highest").short_name() == \
        "dense_t16x128x128_highest"
    with pytest.raises(ValueError):
        TileHint(precision="high")
    # a JAX hint dict loads as far as the port has its fields
    jd = JaxTileHint(block_m=8, decode_mode="mask").to_dict()
    with pytest.raises(NotImplementedError):
        TileHint.from_dict(jd)


def test_measure_kernel_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the host without a card")
    with pytest.raises(RuntimeError, match="card"):
        timing.measure_kernel(lambda: None)
    assert timing.median([1.0, 2.0, 3.0]) == 2.0
    assert timing.spread([1.0, 2.0, 2.0, 4.0]) == 1.0

"""The port's operator cache and hint database (cache/__init__.py), the
global cache under BitNet's layers (models/bitnet.py) and the tuning
switch of the Llama layers, on the CPU. Mirrors tests/test_cache.py:
round trip, only measured buckets persisted, loaded hints never
re-persisted as measured, two writers merging, thread safety.

Every database lives under pytest's `tmp_path`, one per test (so xdist
workers never share one). On the CPU nothing is measured, so a test
stands in for a tuning process by installing hints with
`apply_hints(pin=True)`, as the JAX tests do.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from bitblas_tpu_torch import cache as pcache
from bitblas_tpu_torch.cache import OperatorCache, global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.models import bitnet as pbitnet
from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlamaLayer
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.tuner import MATERIALIZE, TileHint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U4 = dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
          with_zeros=True, zeros_mode="original", group_size=128,
          out_dtype="float16")
I2 = dict(A_dtype="int8", W_dtype="int2", accum_dtype="int32",
          out_dtype="float32")
# two of the uint4 wgmma + TMA instances
H1 = TileHint("fused", 32, 64, 256, 4)
H16 = TileHint("fused", 128, 64, 256, 3)


def _cfg(K=256, M=(1, 16), **kw):
    return MatmulConfig(M=list(M), N=256, K=K, **(kw or U4))


@pytest.fixture
def clean_global_cache():
    global_operator_cache.clear()
    yield global_operator_cache
    global_operator_cache.clear()


def test_config_is_hashable_and_its_repr_stable_across_processes():
    c1, c2 = _cfg(), _cfg()
    assert c1 == c2 and hash(c1) == hash(c2) and {c1: 1}[c2] == 1
    assert " at 0x" not in repr(c1)
    code = ("from bitblas_tpu_torch.cache import _config_hash; "
            "from bitblas_tpu_torch.ops.matmul_config import MatmulConfig; "
            f"print(_config_hash(MatmulConfig(M=[1, 16], N=256, K=256, "
            f"**{U4!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == pcache._config_hash(c1)


def test_database_roundtrip(tmp_path):
    cfg = _cfg()
    op = Matmul(cfg, device="cpu")
    op.apply_hints({1: H1, 16: MATERIALIZE})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database(str(tmp_path), target="cpu")

    cache2 = OperatorCache()
    assert cache2.load_from_database(str(tmp_path), target="cpu") == 1
    op2 = cache2.get(cfg)
    assert isinstance(op2, Matmul) and op2 is not op
    assert op2.hints == op.hints
    assert not op2.tuned_hints                       # loaded, not measured
    rng = np.random.default_rng(0)
    W, S, Z = op.transform_weight(
        rng.integers(0, 16, (256, 256)).astype(np.int8),
        scale=(rng.random((256, 2)) * 0.01).astype(np.float16),
        zeros=rng.integers(0, 16, (256, 2)).astype(np.float16))
    for m in (1, 12):
        A = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float16))
        assert op2.hint_for(m) == op.hint_for(m)
        assert torch.equal(op.forward(A, W, S, Z), op2.forward(A, W, S, Z))


def test_int8_operator_roundtrip(tmp_path):
    """A tuned int8 x uint4 operator (grouped scales, int8 out): its hints
    (the tiled instance at M = 1, the decode instance at 256) saved and
    loaded back, and the reloaded operator's forwards equal the tuned
    one's."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    cfg = MatmulConfig(M=[1, 256], N=256, K=256, A_dtype="int8",
                       W_dtype="uint4", with_scaling=True, group_size=64,
                       out_dtype="int8")
    decode, tiled = dq.FUSED_TILES["uint4xint8"]
    op = Matmul(cfg, device="cpu")
    op.apply_hints({1: TileHint("fused", *tiled),
                    256: TileHint("fused", *decode)})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database(str(tmp_path), target="cpu")
    cache2 = OperatorCache()
    assert cache2.load_from_database(str(tmp_path), target="cpu") == 1
    op2 = cache2.get(cfg)
    assert op2.hints == op.hints and not op2.tuned_hints
    assert op2.hint_for(1).tile == tiled and op2.hint_for(200).tile == decode
    rng = np.random.default_rng(3)
    W, S = op.transform_weight(
        rng.integers(0, 16, (256, 256)).astype(np.int8),
        scale=(rng.random((256, 4)) * 0.05).astype(np.float16))
    for m in (1, 200):
        A = torch.from_numpy(rng.integers(-64, 64, (m, 256)).astype(np.int8))
        out = op2.forward(A, W, S)
        assert out.dtype == torch.int8
        assert torch.equal(op.forward(A, W, S), out)


def test_only_tuned_buckets_are_persisted(tmp_path):
    cfg = _cfg(M=(1, 16, 256))
    op = Matmul(cfg, device="cpu")
    op.apply_hints({16: H16})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database(str(tmp_path), target="cpu")
    (entry,) = os.listdir(tmp_path / "cpu")
    d = tmp_path / "cpu" / entry
    assert entry == pcache._config_hash(cfg)
    assert json.loads((d / "hints.json").read_text()) == \
        {"16": H16.to_dict()}
    assert json.loads((d / "mapping.json").read_text()) == \
        {"operator": "Matmul", "config": "MatmulConfig", "hint": "TileHint"}
    assert MatmulConfig(**json.loads((d / "config.json").read_text())) == cfg
    assert not [f for f in os.listdir(d) if ".tmp." in f]


def test_loaded_hints_do_not_masquerade_as_measured(tmp_path):
    cfg = _cfg()
    op_a = Matmul(cfg, device="cpu")
    op_a.apply_hints({1: H1})                        # "process A" measures
    cache_a = OperatorCache()
    cache_a.add(cfg, op_a)
    cache_a.save_into_database(str(tmp_path), target="cpu")

    cache_b = OperatorCache()                        # "process B" loads
    cache_b.load_from_database(str(tmp_path), target="cpu")
    op_b = cache_b.get(cfg)
    assert op_b.hints[1] == H1 and 1 not in op_b.tuned_hints

    op_a.apply_hints({1: H16})                       # A re-measures
    cache_a.save_into_database(str(tmp_path), target="cpu")
    cache_b.save_into_database(str(tmp_path), target="cpu")   # B saves late
    merged = OperatorCache()
    merged.load_from_database(str(tmp_path), target="cpu")
    assert merged.get(cfg).hints[1] == H16


def test_two_caches_saving_one_database_merge(tmp_path):
    cfg = _cfg()
    for bucket, hint in ((1, H1), (16, H16)):
        op = Matmul(cfg, device="cpu")
        op.apply_hints({bucket: hint})
        cache = OperatorCache()
        cache.add(cfg, op)
        cache.save_into_database(str(tmp_path), target="cpu")
    merged = OperatorCache()
    assert merged.load_from_database(str(tmp_path), target="cpu") == 1
    assert merged.get(cfg).hints == {1: H1, 16: H16}


_SAVE_ONE_BUCKET = """
import sys
from bitblas_tpu_torch.cache import OperatorCache
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
from bitblas_tpu_torch.tuner import TileHint
cfg = MatmulConfig(M=[1, 16, 256], N=256, K=256, A_dtype="int8",
                   W_dtype="int2", accum_dtype="int32", out_dtype="float32")
bucket = int(sys.argv[2])
for rep in range(20):
    op = Matmul(cfg, device="cpu")
    op.apply_hints({bucket: TileHint("fused", 32, 64, 512, 4)})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database(sys.argv[1], target="cpu")
"""


def test_processes_saving_different_buckets_keep_both(tmp_path):
    """Three processes save different buckets of one config at once: the
    fcntl merge keeps every bucket."""
    procs = [subprocess.Popen([sys.executable, "-c", _SAVE_ONE_BUCKET,
                               str(tmp_path), str(b)], cwd=ROOT)
             for b in (1, 16, 256)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    merged = OperatorCache()
    assert merged.load_from_database(str(tmp_path), target="cpu") == 1
    (op,) = merged._ops.values()
    want = TileHint("fused", 32, 64, 512, 4)
    assert op.hints == {1: want, 16: want, 256: want}


def test_one_directory_per_target(tmp_path):
    cfg = _cfg()
    op = Matmul(cfg, device="cpu")
    op.apply_hints({1: H1})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database(str(tmp_path))            # the op's own: cpu
    cache.save_into_database(str(tmp_path), target="h100_sxm")
    assert sorted(os.listdir(tmp_path)) == ["cpu", "h100_sxm"]
    assert OperatorCache().load_from_database(str(tmp_path),
                                              target="cpu") == 1
    assert OperatorCache().load_from_database(str(tmp_path / "none"),
                                              target="cpu") == 0


def test_load_skips_an_entry_being_written(tmp_path):
    d = tmp_path / "cpu" / ("0" * 32)
    d.mkdir(parents=True)
    (d / "mapping.json").write_text('{"operator": "Matmul"}')
    assert OperatorCache().load_from_database(str(tmp_path),
                                              target="cpu") == 0


def test_database_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(DATABASE_PATH_ENV, raising=False)
    default = pcache.get_database_path()
    assert default == os.path.expanduser("~/.cache/bitblas_tpu_torch")
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    assert pcache.get_database_path() == str(tmp_path / "db")
    cfg = _cfg()
    op = Matmul(cfg, device="cpu")
    op.apply_hints({16: H16})
    cache = OperatorCache()
    cache.add(cfg, op)
    cache.save_into_database()
    assert os.listdir(tmp_path / "db") == ["cpu"]


def test_cache_clear_and_size():
    cache = OperatorCache()
    cfg = _cfg()
    cache.add(cfg, Matmul(cfg, device="cpu"))
    assert cache.size() == 1 and cache.get(_cfg()) is not None
    cache.clear()
    assert cache.size() == 0 and cache.get(cfg) is None


def test_cache_thread_safety(tmp_path):
    """Threads add, get and save at once: the registry holds each config
    once and the saved database loads whole."""
    cache = OperatorCache()
    cfgs = [_cfg(K=256 * (i + 1)) for i in range(3)]
    ops = [Matmul(c, device="cpu") for c in cfgs]
    for op in ops:
        op.apply_hints({1: H1})
    errors = []

    def worker(i):
        try:
            for _ in range(30):
                cache.add(cfgs[i % 3], ops[i % 3])
                got = cache.get(cfgs[(i + 1) % 3])
                assert got is None or isinstance(got, Matmul)
                cache.size()
            cache.save_into_database(str(tmp_path), target="cpu")
        except Exception as ex:  # noqa: BLE001 - reported by the assert
            errors.append(ex)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert cache.size() == 3
    loaded = OperatorCache()
    assert loaded.load_from_database(str(tmp_path), target="cpu") == 3
    assert all(loaded.get(c).hints[1] == H1 for c in cfgs)


def _tiny_bitnet(opt_m=(1, 16, 256)):
    cfg = LlamaConfig(hidden_size=128, intermediate_size=256, num_heads=2,
                      num_kv_heads=1, num_layers=2, vocab_size=64)
    return pbitnet.BitNetLlama(cfg, opt_m=opt_m, device="cpu", seed=3)


def test_bitnet_layers_share_one_operator_per_shape(clean_global_cache):
    model = _tiny_bitnet()
    ops = {}
    for layer in model.layers:
        for proj in layer.projs.values():
            key = (proj.out_features, proj.in_features)
            assert ops.setdefault(key, proj.matmul) is proj.matmul
            assert clean_global_cache.get(proj.config) is proj.matmul
    assert len(ops) == clean_global_cache.size() == 4   # q, kv, up, down


def test_bitnet_serves_on_hints_loaded_from_the_database(
        clean_global_cache, tmp_path):
    """Hints saved for BitNet's operators, the cache cleared and loaded
    again: a model built afterwards takes the loaded operators, routes as
    they say, and computes what the default route computes (integer
    sums: exactly)."""
    buckets = (1, 16, 32, 64, 128, 256)
    ref = _tiny_bitnet(buckets)
    x = torch.randn((1, 24, 128), generator=torch.Generator().manual_seed(1)
                    ).half()
    want = ref.layers[0].proj("up", x)
    for op in list(clean_global_cache._ops.values()):
        op.apply_hints({32: MATERIALIZE, 1: TileHint("fused", 32, 64,
                                                      512, 4)})
    clean_global_cache.save_into_database(str(tmp_path), target="cpu")
    clean_global_cache.clear()
    assert pcache.load_global_ops_cache(str(tmp_path), target="cpu") == 4
    model = _tiny_bitnet(buckets)
    up = model.layers[0].projs["up"]
    assert up.matmul is clean_global_cache.get(up.config)
    assert not up.matmul.tuned_hints
    assert up.matmul.hint_for(24) == MATERIALIZE
    assert torch.equal(model.layers[0].proj("up", x), want)


@pytest.mark.parametrize("enable_tuning", [False, True])
def test_quant_llama_layer_passes_enable_tuning(monkeypatch, enable_tuning):
    seen = []
    monkeypatch.setattr(Matmul, "hardware_aware_finetune",
                        lambda self, topk=20: seen.append(self.config.N))
    cfg = LlamaConfig(hidden_size=128, intermediate_size=256, num_heads=2,
                      num_kv_heads=2, num_layers=1, vocab_size=64)
    QuantLlamaLayer(cfg, device="cpu", enable_tuning=enable_tuning)
    assert len(seen) == (7 if enable_tuning else 0)

"""bitblas_tpu_torch.module.checkpoint: save_quant_state / load_quant_state
round trips bit for bit, and the layout tag keeps the port's and the JAX
package's device layouts apart (each refuses the other's checkpoints)."""

import json

import numpy as np
import pytest
import torch

from bitblas_tpu.module import checkpoint as jckpt

from bitblas_tpu_torch.cache import global_operator_cache
from bitblas_tpu_torch.common import DATABASE_PATH_ENV
from bitblas_tpu_torch.module import Linear
from bitblas_tpu_torch.module.checkpoint import (DEVICE_LAYOUT,
                                                 load_quant_state,
                                                 save_quant_state)


@pytest.fixture(autouse=True)
def _private_database(tmp_path, monkeypatch):
    monkeypatch.setenv(DATABASE_PATH_ENV, str(tmp_path / "db"))
    global_operator_cache.clear()
    yield
    global_operator_cache.clear()


def _linear(seed, g=64, bias=True):
    rng = np.random.default_rng(seed)
    lin = Linear(256, 128, bias=bias, A_dtype="float16", W_dtype="uint4",
                 with_scaling=True, with_zeros=True, zeros_mode="original",
                 group_size=g, opt_M=[16], enable_tuning=False,
                 device="cpu")
    lin.load_and_transform_weight(
        rng.integers(0, 16, (128, 256)),
        scales=(rng.standard_normal((128, 256 // g)) * 0.01).astype(
            np.float16),
        zeros=rng.integers(0, 16, (128, 256 // g)).astype(np.float16),
        bias=rng.standard_normal(128).astype(np.float32) if bias else None)
    return lin


def test_round_trip_bit_for_bit(tmp_path):
    layers = {"l0": dict(_linear(0).state_dict()),
              "l1": dict(_linear(1, g=32, bias=False).state_dict())}
    path = str(tmp_path / "ckpt")
    save_quant_state(path, layers, meta={"model": "test"})
    meta = json.load(open(path + ".npz.meta.json"))
    assert meta == {"model": "test", "device_layout": DEVICE_LAYOUT}
    back = load_quant_state(path, device="cpu")
    assert set(back) == set(layers)
    for lname, tensors in layers.items():
        assert set(back[lname]) == {k for k, v in tensors.items()
                                    if v is not None}
        for tname, t in back[lname].items():
            assert t.dtype == tensors[tname].dtype
            assert torch.equal(t, tensors[tname]), (lname, tname)


def test_loaded_state_serves_the_same(tmp_path):
    lin = _linear(2)
    save_quant_state(str(tmp_path / "c.npz"), {"l": dict(lin.state_dict())})
    fresh = _linear(3)
    fresh.load_state_dict(load_quant_state(str(tmp_path / "c.npz"),
                                           device="cpu")["l"])
    x = torch.randn(4, 256, dtype=torch.float16)
    assert torch.equal(fresh(x), lin(x))


def test_jax_checkpoint_refused(tmp_path):
    """A checkpoint the JAX package wrote (its TPU layout v2 stamp) is
    refused loudly, never decoded; and the JAX loader refuses ours."""
    path = str(tmp_path / "jax")
    jckpt.save_quant_state(path, {"l": {"qweight": np.zeros((4, 4),
                                                            np.int8)}})
    with pytest.raises(ValueError, match="JAX package"):
        load_quant_state(path, device="cpu")
    ours = str(tmp_path / "ours")
    save_quant_state(ours, {"l": {"qweight": torch.zeros(4, 4)}})
    with pytest.raises(ValueError, match="device_layout_version"):
        jckpt.load_quant_state(ours)


def test_unstamped_or_other_layouts_refused(tmp_path):
    path = str(tmp_path / "c")
    save_quant_state(path, {"l": {"w": torch.zeros(2)}})
    meta_path = path + ".npz.meta.json"
    json.dump({"device_layout": "bitblas_tpu_torch.hopper_kpack.v0"},
              open(meta_path, "w"))
    with pytest.raises(ValueError, match="hopper_kpack.v0"):
        load_quant_state(path, device="cpu")
    json.dump({}, open(meta_path, "w"))
    with pytest.raises(ValueError, match="None"):
        load_quant_state(path, device="cpu")

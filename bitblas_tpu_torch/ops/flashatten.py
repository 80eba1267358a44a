"""FlashAtten operator (counterpart of bitblas_tpu/ops/flashatten.py).

The JAX package's config surface -- {batch, heads, kv_heads, seq_len,
dim, Q/K/V/Out dtypes, layout "nnn" / "ntn", is_causal} -- run by kernel
4 (kernels/flash.py flash_attention_fwd). The tunable is the kernel's
tile, a FlashHint (block_q, block_kv): the construction default is
tuner/curated's flash_block_hint (through kernels.flash.check_prefill),
`hardware_aware_finetune` times the tiles of
`kernels.flash.prefill_tiles` on the card, and the operator
speaks the hint database's protocol (hints / tuned_hints / apply_hints),
so a tuned tile persists through cache/__init__.py like a Matmul's.

Unlike the JAX operator, which logs a warning and serves its XLA oracle
when its kernel cannot tile a shape (trans_k with S % 128 != 0), this
one runs kernel 4 for every configuration JAX's builds: the general
instance takes the shapes the specialized ones do not
(`kernels.flash.prefill_instance`). Only a head dim past the general
instance's cap (`kernels.flash.GENERAL_MAX_HEAD_DIM`) raises, at
construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np
import torch

from ..common import get_logger, resolve_device
from ..kernels.flash import (check_prefill, flash_attention_fwd,
                             prefill_instance, prefill_tiles)
from ..quantization.formats import as_torch_dtype
from ..tuner import FlashHint, auto_detect_target, get_arch
from ..utils.timing import measure_kernel
from .matmul_config import OperatorConfig
from .operator import BaseKernelNameGenerator

logger = get_logger()

FLASH_SUPPORTED_DTYPES = ("float16", "bfloat16", "float32")


@dataclass(frozen=True)
class FlashAttenConfig(OperatorConfig):
    batch: Optional[int] = None
    heads: Optional[int] = None
    kv_heads: Optional[int] = None
    seq_len: Optional[int] = None
    dim: Optional[int] = None
    Q_dtype: str = "float16"
    K_dtype: Optional[str] = None
    V_dtype: Optional[str] = None
    Accu_dtype: str = "float32"
    Out_dtype: str = "float16"
    layout: Literal["nnn", "ntn"] = "nnn"
    is_causal: bool = False

    def __post_init__(self):
        for f in ("batch", "heads", "seq_len", "dim"):
            if getattr(self, f) is None:
                raise ValueError(f"{f} must be specified")
        if self.K_dtype is None:
            object.__setattr__(self, "K_dtype", self.Q_dtype)
        if self.V_dtype is None:
            object.__setattr__(self, "V_dtype", self.Q_dtype)
        if self.kv_heads in (None, -1):
            object.__setattr__(self, "kv_heads", self.heads)
        if self.heads % self.kv_heads:
            raise ValueError("heads must be a multiple of kv_heads")
        for d in (self.Q_dtype, self.K_dtype, self.V_dtype):
            if d not in FLASH_SUPPORTED_DTYPES:
                raise ValueError(f"unsupported flash dtype {d}")
        if self.layout not in ("nnn", "ntn"):
            raise ValueError(f"layout must be 'nnn' or 'ntn', got "
                             f"{self.layout!r}")


class FlashAttenKernelNameGenerator(BaseKernelNameGenerator):
    """Kernel naming for logs and cache keys (the JAX generator's names)."""

    KERNEL_PREFIX = "flashatten"

    def is_valid_config(self, config) -> bool:
        return isinstance(config, FlashAttenConfig)

    def generate(self, hint=None) -> str:
        c = self.config
        name = (f"{self.KERNEL_PREFIX}_batch{c.batch}heads{c.heads}"
                f"seqlen{c.seq_len}dim{c.dim}_causal{int(c.is_causal)}")
        return name if hint is None else f"{name}_{hint.short_name()}"


class FlashAtten:
    """Single-device flash attention with measured tile tuning, on the
    card (`device="cuda"`, the default) or, through the kernel's plain
    version, on the CPU."""

    HINT_CLASS = "FlashHint"   # the hint database's record type

    def __init__(self, config: FlashAttenConfig, name: str = "flashatten",
                 target: Optional[str] = None, enable_tuning: bool = False,
                 from_database: bool = False, device="cuda"):
        del from_database
        self.name = name
        self.config = config
        self.device = resolve_device(device)
        self.arch = get_arch(target or auto_detect_target(self.device))
        self.kernel_name_generator = FlashAttenKernelNameGenerator(config)
        c = config
        if len({c.Q_dtype, c.K_dtype, c.V_dtype}) != 1:
            raise NotImplementedError(
                f"FlashAtten: kernel 4 takes Q, K and V of one type, got "
                f"{c.Q_dtype}, {c.K_dtype}, {c.V_dtype}")
        self.dtype = as_torch_dtype(c.Q_dtype)
        self.out_dtype = as_torch_dtype(c.Out_dtype)
        self.block_q, self.block_kv = check_prefill(
            c.batch, c.seq_len, c.heads, c.kv_heads, c.dim, self.dtype,
            self.out_dtype, causal=c.is_causal, trans_k=self.trans_k)
        self._tuned = False
        self.tune_results = {}
        if enable_tuning and self.device.type == "cuda":
            self.hardware_aware_finetune()

    @property
    def trans_k(self) -> bool:
        return self.config.layout == "ntn"

    @property
    def candidates(self):
        """The tiles of the kernel 4 instance that runs this config."""
        c = self.config
        return prefill_tiles(c.dim, self.dtype, prefill_instance(
            c.seq_len, c.heads, c.kv_heads, c.dim, self.dtype,
            trans_k=self.trans_k))

    # -- the hint database's protocol (the Operator's duck type) ------------
    @property
    def hints(self):
        return {0: FlashHint(block_q=self.block_q, block_kv=self.block_kv)}

    @property
    def tuned_hints(self):
        return self.hints if self._tuned else {}

    def apply_hints(self, hints, *, pin: bool = True) -> None:
        if not hints:
            return
        h = hints.get(0) or next(iter(hints.values()))
        if h.tile not in self.candidates:
            raise ValueError(f"FlashAtten: hint {h} is not one of "
                             f"{self.candidates}")
        self.block_q, self.block_kv = h.tile
        if pin:
            self._tuned = True

    def _run(self, Q, K, V, tile):
        c = self.config
        return flash_attention_fwd(Q, K, V, causal=c.is_causal,
                                   trans_k=self.trans_k,
                                   out_dtype=self.out_dtype, tile=tile)

    def _example_args(self, seed: int = 0):
        """Q, K (K^T for "ntn"), V drawn from numpy's generator with
        `seed`, in the config's type on the operator's device."""
        c = self.config
        rng = np.random.default_rng(seed)
        k_shape = ((c.batch, c.dim, c.kv_heads, c.seq_len) if self.trans_k
                   else (c.batch, c.seq_len, c.kv_heads, c.dim))
        return tuple(
            torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
                self.device, self.dtype)
            for shape in ((c.batch, c.seq_len, c.heads, c.dim), k_shape,
                          (c.batch, c.seq_len, c.kv_heads, c.dim)))

    def hardware_aware_finetune(self, topk: int = 25):
        """Time each tile of `candidates` (at most `topk`) on the card
        with utils/timing.measure_kernel and install the fastest, pinned.
        Returns (tile, seconds); `tune_results` holds every candidate's
        time. A failing candidate raises: the kernel never falls back."""
        if self.device.type != "cuda":
            raise RuntimeError("FlashAtten.hardware_aware_finetune times on "
                               "the card; the operator is on the CPU")
        args = self._example_args()
        self.tune_results = {}
        for tile in self.candidates[:topk]:
            self.tune_results[tile] = measure_kernel(
                lambda t=tile: self._run(*args, t))
            logger.info("flashatten tune %s -> %.1f us", tile,
                        self.tune_results[tile] * 1e6)
        best = min(self.tune_results, key=self.tune_results.get)
        self.block_q, self.block_kv = best
        self._tuned = True
        return best, self.tune_results[best]

    def forward(self, Q, K, V, output=None) -> torch.Tensor:
        del output
        c = self.config
        want = (c.batch, c.seq_len, c.heads, c.dim)
        if tuple(Q.shape) != want:
            raise ValueError(f"FlashAtten: Q {tuple(Q.shape)}, config "
                             f"{want}")
        return self._run(Q, K, V, (self.block_q, self.block_kv))

    def __call__(self, *args, **kwargs) -> torch.Tensor:
        return self.forward(*args, **kwargs)

    def ref_program(self, Q, K, V) -> torch.Tensor:
        """The oracle (the JAX operator's ref_program): float32 softmax
        attention, output in Out_dtype."""
        c = self.config
        K_ = K.permute(0, 3, 2, 1) if self.trans_k else K   # [B, S, Hkv, D]
        group = c.heads // c.kv_heads
        k = K_.float().repeat_interleave(group, dim=2)
        v = V.float().repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", Q.float(), k) / math.sqrt(c.dim)
        if c.is_causal:
            keep = torch.ones((c.seq_len, c.seq_len), dtype=torch.bool,
                              device=Q.device).tril()
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return o.to(self.out_dtype)

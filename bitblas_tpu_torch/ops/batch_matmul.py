"""BatchMatmul: C[b] = A[b] . W[b]^T (nt) or A[b] . W[b] (nn), dense only
(counterpart of bitblas_tpu/ops/batch_matmul.py).

JAX computes it as one XLA `dot_general` with a batch dimension and no
Pallas kernel, so a library call is its counterpart: `torch.bmm` for
float operands (float16 / bfloat16 sums in float32 inside cuBLAS, one
rounding to the output; another output type takes the float32 product of
float32 copies, TF32 off), and for int8 `torch._int_mm` on each batch
slice (`kernels/dense.native_product`, exact int32 sums: `torch.bmm`
takes no int8 on CUDA; uint8, float8, float64 and the wider integers
through the same product, each batch slice). The result is cast to
out_dtype as JAX casts it. On
the CPU the plain version runs (`batch_matmul_plain`: float32 sums, or
integer sums exact in a wider float), as on the card in the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..common import resolve_device
from ..kernels.dense import full_f32, native_product
from .reference import matmul_dense_reference
from ..quantization import numerics
from ..quantization.formats import as_torch_dtype
from .matmul_config import OperatorConfig
from .weight_transform import as_tensor


@dataclass(frozen=True)
class BatchMatmulConfig(OperatorConfig):
    Batch: Optional[int] = None
    M: Optional[int] = None
    N: Optional[int] = None
    K: Optional[int] = None
    A_dtype: str = "float16"
    W_dtype: str = "float16"
    out_dtype: str = "float16"
    accum_dtype: str = "float32"
    layout: str = "nt"

    def __post_init__(self):
        for f in ("Batch", "M", "N", "K"):
            if getattr(self, f) is None:
                raise ValueError(f"{f} must be specified")
        if self.A_dtype != self.W_dtype:
            raise ValueError("BatchMatmul is dense-only (A_dtype == W_dtype); "
                             "use Matmul for weight-dequant batched shapes "
                             "(batch folds into M)")
        if self.layout not in ("nt", "nn"):
            raise ValueError(f"layout must be 'nt' or 'nn', got "
                             f"{self.layout!r}")


def _rows_nk(w: torch.Tensor, layout: str) -> torch.Tensor:
    """W as [B, N, K], whatever the layout (a view)."""
    return w if layout == "nt" else w.transpose(1, 2)


def batch_matmul_plain(a: torch.Tensor, w: torch.Tensor, layout: str,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version (any device): each batch's float32 sums, or
    its exact integer sums, then the cast."""
    w_nk = _rows_nk(w, layout)
    acc = torch.float32 if a.is_floating_point() else torch.int32
    return torch.stack([matmul_dense_reference(a[b], w_nk[b], acc)
                        for b in range(a.shape[0])]).to(out_dtype)


class BatchMatmul:

    def __init__(self, config: BatchMatmulConfig, name: str = "batch_matmul",
                 target: Optional[str] = None, enable_tuning: bool = False,
                 device="cuda", **_):
        del target, enable_tuning
        self.name = name
        self.config = config
        self.device = resolve_device(device)
        self.dtype = as_torch_dtype(config.A_dtype)
        self.out_dtype = as_torch_dtype(config.out_dtype)

    def forward(self, a, w) -> torch.Tensor:
        """a [B, M, K]; w [B, N, K] for nt / [B, K, N] for nn -> [B, M, N]
        in out_dtype, on the operator's device."""
        c = self.config
        a, w = as_tensor(a, self.device), as_tensor(w, self.device)
        want_w = (c.Batch, c.N, c.K) if c.layout == "nt" else \
            (c.Batch, c.K, c.N)
        for name, t, shape in (("a", a, (c.Batch, c.M, c.K)),
                               ("w", w, want_w)):
            if tuple(t.shape) != shape or t.dtype != self.dtype:
                raise ValueError(f"{name}: expected {self.dtype} {shape}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        if self.device.type == "cpu":
            return batch_matmul_plain(a, w, c.layout, self.out_dtype)
        w_nk = _rows_nk(w, c.layout)
        if self.dtype not in (torch.float16, torch.bfloat16, torch.float32):
            # int8 / uint8 (exact int32 sums), float64, float8, the wider
            # integers: each batch through the dense route's product
            acc = "int32" if c.A_dtype in ("int8", "uint8") else \
                "float64" if c.A_dtype == "float64" else "float32"
            return numerics.convert(torch.stack([
                native_product(a[b], w_nk[b].contiguous(), acc)
                for b in range(c.Batch)]), c.out_dtype)
        if self.out_dtype == self.dtype:
            return torch.bmm(a, w_nk.transpose(1, 2))
        with full_f32():
            out = torch.bmm(a.float(), w_nk.float().transpose(1, 2))
        return out.to(self.out_dtype)

    def __call__(self, *args: Any, **kw: Any) -> Any:
        return self.forward(*args, **kw)

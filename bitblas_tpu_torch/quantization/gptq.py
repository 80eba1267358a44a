"""Weight quantization: round to nearest (RTN) and GPTQ (counterpart of
bitblas_tpu/quantization/gptq.py).

The codes follow the kernels' dequant contract (ops/reference.py,
zeros_mode="original"):

    dequant[n, k] = (code[n, k] - zero[n, g(k)]) * scale[n, g(k)]

with `code` an unsigned integer in [0, 2^bits) and one (scale, zero) pair
per `group_size` contiguous K. The (codes, scales, zeros) feed
`Matmul.transform_weight(codes, scale=scales, zeros=zeros)` directly.

Tensors go in and out on the weight's device (a numpy weight goes to the
card unless `device=` says otherwise), in the JAX package's
precision at every step: the group parameters and RTN in float32; the
Hessian, its damped inverse, the Cholesky factor and GPTQ's column sweep
in float64, each group's scales computed in float32 from the float64
residual and widened. Wherever the JAX package divides by a scalar the
port divides by a tensor on the device: PyTorch computes ``t / c`` for a
Python number c on CUDA as ``t * (1 / c)``, one ulp off, which moves codes.
`torch.round` rounds half to even, as `np.round` does.

GPTQ (Frantar et al. 2022) quantizes the columns left to right and feeds
each column's rounding error into the columns still to come through the
upper Cholesky factor of H^-1. Rows are independent under one Hessian, so
a caller may sweep the rows of several projections that share a Hessian
(q / k / v, gate / up) at once: the same codes in a third of the column
steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..common import resolve_device

__all__ = [
    "QuantizedWeight",
    "HessianAccumulator",
    "rtn_quantize",
    "gptq_quantize",
]


@dataclass
class QuantizedWeight:
    """Grouped-quantized weight in the kernels' input convention.

    codes  [N, K] uint8 values in [0, 2^bits)
    scales [N, K // group_size] float32
    zeros  [N, K // group_size] float32 (integer zero points stored as
           float, the zeros_mode="original" device format)
    """
    codes: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    bits: int
    group_size: int

    def dequantize(self) -> torch.Tensor:
        """[N, K] float32 reconstruction: the oracle the kernels match."""
        g = self.group_size
        z = self.zeros.repeat_interleave(g, dim=1)
        s = self.scales.repeat_interleave(g, dim=1)
        return (self.codes.to(torch.float32) - z) * s


def _as_weight(weight, device) -> torch.Tensor:
    """A float32 copy of `weight` on `device`; with `device` None a tensor
    stays on its own device and anything else (a numpy array) goes to the
    card. The sweep writes into the copy, never into the caller's
    tensor."""
    if device is None and isinstance(weight, torch.Tensor):
        return weight.detach().to(torch.float32, copy=True)
    dev = resolve_device("cuda" if device is None else device)
    if isinstance(weight, torch.Tensor):
        return weight.detach().to(dev, torch.float32, copy=True)
    return torch.tensor(np.asarray(weight, dtype=np.float32), device=dev)


def _legalize(weight, bits: int, group_size: int, device):
    w = _as_weight(weight, device)
    if w.dim() != 2:
        raise ValueError(f"weight must be [N, K], got shape {tuple(w.shape)}")
    N, K = w.shape
    if group_size <= 0:
        group_size = K
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits={bits} outside the packed range [1, 8]")
    return w, N, K, group_size, (1 << bits) - 1


def _group_params(w: torch.Tensor, maxq: int, symmetric: bool,
                  dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero), float32, of each row of one K-group `w` (float32),
    reducing over `dim` (the group's K)."""
    q = torch.full((), float(maxq), dtype=torch.float32, device=w.device)
    if symmetric:
        amax = w.abs().amax(dim=dim)
        scale = torch.where(amax > 0, 2.0 * amax / q, 1.0)
        return scale, torch.full_like(scale, (maxq + 1) // 2)
    wmax = w.amax(dim=dim).clamp(min=0.0)
    wmin = w.amin(dim=dim).clamp(max=0.0)
    rng = wmax - wmin
    scale = torch.where(rng > 0, rng / q, 1.0)
    zero = torch.clamp(torch.round(-wmin / scale), 0, maxq)
    return scale, zero


def _quantize(col: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
              maxq: int) -> torch.Tensor:
    """Values -> integer codes (in the values' float type) on the (scale,
    zero) grid."""
    return torch.clamp(torch.round(col / scale) + zero, 0, maxq)


def rtn_quantize(weight, bits: int = 4, group_size: int = 128,
                 symmetric: bool = False, device=None) -> QuantizedWeight:
    """Round-to-nearest grouped quantization of `weight` [N(out), K(in)]:
    the baseline GPTQ must beat, and the fallback of an expert that gets
    no calibration traffic. On `device`, by default a tensor's own and the
    card for anything else."""
    w, N, K, group_size, maxq = _legalize(weight, bits, group_size, device)
    wg = w.reshape(N, K // group_size, group_size)
    scales, zeros = _group_params(wg, maxq, symmetric, dim=2)
    codes = _quantize(wg, scales[..., None], zeros[..., None], maxq)
    return QuantizedWeight(codes.reshape(N, K).to(torch.uint8), scales,
                           zeros, bits, group_size)


class HessianAccumulator:
    """Streaming H = E[x x^T] over calibration activations, float64 on
    `device`.

    Feed the *inputs* of a linear layer (any leading dims, last dim K);
    the Hessian drives `gptq_quantize` for that layer's weight. Every row
    fed counts, zero rows included (an expert's unfilled capacity slots,
    as the JAX package counts them)."""

    def __init__(self, k: int, device="cuda"):
        self.h = torch.zeros((k, k), dtype=torch.float64,
                             device=resolve_device(device))
        self.count = 0

    def update(self, x) -> None:
        x = torch.as_tensor(x).to(self.h.device, torch.float64).reshape(
            -1, self.h.shape[0])
        self.h += x.T @ x
        self.count += x.shape[0]

    @property
    def hessian(self) -> torch.Tensor:
        return self.h / torch.full((), float(max(self.count, 1)),
                                   dtype=torch.float64, device=self.h.device)


def _inverse_factor(H: torch.Tensor, percdamp: float) -> torch.Tensor:
    """The damped H (in place) -> U upper-triangular with H^-1 = U^T U:
    damping percdamp * mean(diag H) (at least 1e-12), the inverse
    symmetrized, U = chol(H^-1)^T."""
    diag = torch.diagonal(H)
    damp = percdamp * float(np.mean(diag.cpu().numpy()))
    diag += max(damp, 1e-12)
    hinv = torch.linalg.inv(H)
    hinv = (hinv + hinv.T) / 2.0
    return torch.linalg.cholesky(hinv).T.contiguous()


def _sweep(wb, ub, qb, eb, sz, sc, zr, col0: int, ncols: int,
           group_size: int, g0: int, maxq: int, symmetric: bool,
           first: bool) -> None:
    """GPTQ's column loop over one block, in place: wb [>= ncols, N]
    float64, its rows the block's columns of W (and, when a group starting
    in the block runs past it, the rows after); ub [ncols, ncols] the
    block of U; qb / eb [ncols, N] receive the codes (float64) and the
    scaled errors; sz [2, N] float64 holds the current group's scale and
    zero. A group starting at column j = col0 + c (c > 0, or c = 0 with
    `first`) takes its parameters from wb[c:c + group_size] into rows
    j // group_size - g0 of sc / zr [., N] float32 and into sz."""
    for c in range(ncols):
        j = col0 + c
        if j % group_size == 0 and (c > 0 or first):
            sg, zg = _group_params(wb[c:c + group_size].float(), maxq,
                                   symmetric, dim=0)
            sc[j // group_size - g0], zr[j // group_size - g0] = sg, zg
            sz[0], sz[1] = sg, zg
        col = wb[c]
        q = qb[c]
        torch.clamp(torch.round(col / sz[0]).add_(sz[1]), 0, maxq, out=q)
        dq = (q - sz[1]).mul_(sz[0])
        torch.div(torch.sub(col, dq, out=dq), ub[c, c], out=eb[c])
        if c + 1 < ncols:
            wb[c + 1:ncols] -= ub[c, c + 1:ncols, None] * eb[c]


class _GraphedSweep:
    """On the card, full blocks replay one captured CUDA graph of
    `_sweep` (its ~10 launches a column are host-bound when issued one by
    one) over static buffers: the block's rows of W and of U are copied
    in, the codes and errors out. The graph serves every full block when
    group starts fall at the same positions in each (blocksize a multiple
    of group_size, or the reverse): a group that starts at a block's first
    column is entered before the replay, from W's rows past the block too.
    The first full block runs `_sweep` eagerly on the same buffers (the
    warm-up), then the graph is captured."""

    def __init__(self, N: int, B: int, group_size: int, maxq: int,
                 symmetric: bool, sz: torch.Tensor):
        dev, f64 = sz.device, torch.float64
        self.B, self.g, self.maxq, self.symmetric = B, group_size, maxq, \
            symmetric
        self.w, self.q, self.e = (torch.empty((B, N), dtype=f64, device=dev)
                                  for _ in range(3))
        self.u = torch.empty((B, B), dtype=f64, device=dev)
        rows = max(B // group_size, 1)
        self.sc, self.zr = (torch.empty((rows, N), dtype=torch.float32,
                                        device=dev) for _ in range(2))
        self.sz = sz
        self.replay = None

    @staticmethod
    def _capture(args):
        """`_sweep(*args)` captured (not run): the graph's replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _sweep(*args)
        return graph.replay

    @staticmethod
    def takes(dev, B: int, group_size: int) -> bool:
        return (dev.type == "cuda"
                and (B % group_size == 0 or group_size % B == 0))

    def run(self, wt, U, codes, scales, zeros, i1: int) -> torch.Tensor:
        """Quantize the columns [i1, i1 + B); returns the errors."""
        B, g = self.B, self.g
        i2 = i1 + B
        if i1 % g == 0:
            sg, zg = _group_params(wt[i1:i1 + g].float(), self.maxq,
                                   self.symmetric, dim=0)
            scales[i1 // g], zeros[i1 // g] = sg, zg
            self.sz[0], self.sz[1] = sg, zg
        self.w.copy_(wt[i1:i2])
        self.u.copy_(U[i1:i2, i1:i2])
        if self.replay is None:
            args = (self.w, self.u, self.q, self.e, self.sz, self.sc,
                    self.zr, i1, B, g, i1 // g, self.maxq, self.symmetric,
                    False)
            _sweep(*args)
            self.replay = self._capture(args)
        else:
            self.replay()
        codes[i1:i2] = self.q
        if B > g:    # the groups that start inside the block
            scales[i1 // g + 1:i2 // g] = self.sc[1:]
            zeros[i1 // g + 1:i2 // g] = self.zr[1:]
        return self.e


def gptq_quantize(weight, hessian, bits: int = 4, group_size: int = 128,
                  symmetric: bool = False, percdamp: float = 0.01,
                  blocksize: int = 128, device=None) -> QuantizedWeight:
    """GPTQ: quantize `weight` [N, K] against the input Hessian `hessian`
    [K, K] on `device`: by default a tensor weight's own device, and the
    card for anything else (the Hessian follows the weight).

    Columns are quantized left to right; each column's rounding error is
    fed into the columns still to come through the upper Cholesky factor
    U of H^-1 (in `blocksize` blocks, the trailing columns updated once a
    block), minimizing tr((W - W^) H (W - W^)^T), the layer-output error
    over the calibration set. With H = I it is `rtn_quantize`. A group's
    scales are taken when the sweep enters it, from the error-updated
    weights (no act-order: the grouped-scale layout needs sequential
    groups). Columns whose diagonal is 0 (never activated) quantize as
    zeros. On the card the full blocks replay a captured CUDA graph
    (`_GraphedSweep`): the same kernels, so the same codes."""
    w, N, K, group_size, maxq = _legalize(weight, bits, group_size, device)
    dev = w.device
    H = torch.as_tensor(hessian).to(dev, torch.float64, copy=True)
    if tuple(H.shape) != (K, K):
        raise ValueError(f"hessian shape {tuple(H.shape)} != ({K}, {K})")
    dead = (torch.diagonal(H) == 0).nonzero().flatten()
    if dead.numel():
        H[dead, dead] = 1.0
        w[:, dead] = 0.0
    U = _inverse_factor(H, percdamp)
    del H

    # the sweep works on W^T [K, N], so that column j is a contiguous row
    wt = w.T.to(torch.float64).contiguous()
    del w
    G = K // group_size
    scales = torch.empty((G, N), dtype=torch.float32, device=dev)
    zeros = torch.empty((G, N), dtype=torch.float32, device=dev)
    codes = torch.empty((K, N), dtype=torch.float64, device=dev)
    sz = torch.empty((2, N), dtype=torch.float64, device=dev)
    graphed = (_GraphedSweep(N, blocksize, group_size, maxq, symmetric, sz)
               if _GraphedSweep.takes(dev, blocksize, group_size)
               else None)
    for i1 in range(0, K, blocksize):
        i2 = min(i1 + blocksize, K)
        if graphed is not None and i2 - i1 == blocksize:
            err = graphed.run(wt, U, codes, scales, zeros, i1)
        else:
            err = torch.empty((i2 - i1, N), dtype=torch.float64, device=dev)
            _sweep(wt[i1:], U[i1:i2, i1:i2], codes[i1:i2], err, sz, scales,
                   zeros, i1, i2 - i1, group_size, 0, maxq, symmetric, True)
        if i2 < K:
            wt[i2:] -= U[i1:i2, i2:].T @ err
    return QuantizedWeight(codes.T.to(torch.uint8).contiguous(),
                           scales.T.contiguous(), zeros.T.contiguous(),
                           bits, group_size)

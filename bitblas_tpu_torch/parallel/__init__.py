"""Process-group execution: tensor-parallel fused dequant matmuls
(counterpart of bitblas_tpu/parallel/__init__.py).

The JAX package runs one SPMD program under `shard_map` over a mesh axis.
Here every rank is a process of its own and a `torch.distributed`
ProcessGroup stands wherever JAX takes (mesh, axis), as in Megatron and
vLLM. The collectives map one to one:

  psum                   all_reduce(SUM)
  pmax                   all_reduce(MAX)
  all_gather(tiled)      all_gather_into_tensor
  psum_scatter           reduce_scatter_tensor
  ppermute               batch_isend_irecv

No entry point initialises a process group or picks a backend: the caller
does both (as under torchrun) and passes the group (None: the default
group). Tensors stay on the device the caller's weights are on.

Weights keep the port's own layout (ops/weight_transform.DeviceWeights:
K-packed words [N, K*bits/32] int32, scales / zeros [K/g, N], bias
[1, N]), so a shard is a slice, and the TPU N-packing's retiling has no
counterpart:

  column-parallel (N sharded): rank r holds rows [r N/tp, (r+1) N/tp) of
      the words and those columns of scales, zeros and bias; no collective
      (gather_output all-gathers the N shards).
  row-parallel (K sharded): rank r holds word columns [r K/tp, (r+1) K/tp)
      / (32/bits) and scale / zero rows [r, r+1) K/(tp g); each rank's
      partial product is summed by an all-reduce in float32, as JAX's psum
      of f32 partials, and the bias (replicated) is added once after it.
      K/tp must stay a multiple of the group size and of kernel 1's K rule
      (128): a shard that breaks either is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from ..ops.weight_transform import DeviceWeights

K_RULE = 128   # kernel 1 and 2's K rule: K a multiple of 128


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """JAX's all_gather(tiled=True) along `dim`: the ranks' tensors
    concatenated in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int,
                       group=None) -> torch.Tensor:
    """JAX's psum_scatter(tiled=True) along `dim`: the sum over the ranks,
    rank r keeping its 1/n slice of `dim`."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def check_row_shard(config: MatmulConfig, tp: int) -> None:
    """Raise where K does not shard `tp` ways: K/tp must be a multiple of
    the group size and of the kernels' K rule."""
    g = config.effective_group_size
    k = config.K // tp
    if config.K % tp or k % g or k % K_RULE:
        raise ValueError(
            f"row-parallel shard refused: K={config.K} over tp={tp} gives "
            f"K/tp={config.K / tp:g}, which must be a multiple of the group "
            f"size {g} and of {K_RULE} (kernel 1's K rule)")


def check_column_shard(config: MatmulConfig, tp: int) -> None:
    if config.N % tp:
        raise ValueError(f"column-parallel shard refused: tp={tp} must "
                         f"divide N={config.N}")


def _slice(t: Optional[torch.Tensor], dim: int, i: int, n: int):
    if t is None:
        return None
    w = t.shape[dim] // n
    return t.narrow(dim, i * w, w).contiguous()


def shard_weights_column(dw: DeviceWeights, config: MatmulConfig,
                         group=None) -> DeviceWeights:
    """This rank's column shard (N sharded) of device-layout weights:
    rows of the words, columns of scales, zeros and bias."""
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    check_column_shard(config, tp)
    return DeviceWeights(qweight=_slice(dw.qweight, 0, r, tp),
                         scales=_slice(dw.scales, 1, r, tp),
                         zeros=_slice(dw.zeros, 1, r, tp),
                         bias=_slice(dw.bias, -1, r, tp))


def shard_weights_row(dw: DeviceWeights, config: MatmulConfig,
                      group=None) -> DeviceWeights:
    """This rank's row shard (K sharded) of device-layout weights: word
    columns and scale / zero rows; the bias stays whole (added once, after
    the sum)."""
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    check_row_shard(config, tp)
    return DeviceWeights(qweight=_slice(dw.qweight, 1, r, tp),
                         scales=_slice(dw.scales, 0, r, tp),
                         zeros=_slice(dw.zeros, 0, r, tp),
                         bias=dw.bias)


def local_matmul(config: MatmulConfig, m: int, device, *, n=None,
                 k=None, bias: bool = False) -> Matmul:
    """The untuned Matmul of a rank's shard: `config` at N = n, K = k,
    built for M = m; with a bias only where `bias` (a row-parallel bias is
    added after the sum)."""
    cfg = dataclasses.replace(config, M=m, N=n or config.N,
                              K=k or config.K,
                              with_bias=config.with_bias and bias)
    return Matmul(cfg, device=device, enable_tuning=False)


def make_column_parallel_matmul(config: MatmulConfig, m: int, group=None,
                                *, gather_output: bool = False,
                                device="cuda") -> Callable:
    """fn(A [M, K] replicated, W, scales, zeros, bias) -> this rank's N
    shard [M, N/tp] of A W^T (or, gather_output, the whole [M, N]); W,
    scales, zeros, bias this rank's column shard (shard_weights_column).
    The bias goes into the fused kernel, as JAX's does."""
    tp = dist.get_world_size(group)
    check_column_shard(config, tp)
    op = local_matmul(config, m, device, n=config.N // tp, bias=True)

    def fn(A, W, scales=None, zeros=None, bias=None):
        out = op.forward(A, W, scale=scales, zeros=zeros, bias=bias)
        return all_gather(out, 1, group) if gather_output else out

    fn.op = op
    return fn


def make_row_parallel_matmul(config: MatmulConfig, m: int, group=None, *,
                             reduce_scatter: bool = False,
                             overlap_chunks: int = 1,
                             device="cuda") -> Callable:
    """fn(A [M, K/tp] this rank's K shard, W, scales, zeros, bias) -> the
    all-reduced [M, N] (or, reduce_scatter, this rank's [M, N/tp] of the
    sum). Partials are summed in float32; the bias (whole, or with
    reduce_scatter this rank's N shard) is added after the sum.

    overlap_chunks = c > 1 cuts N into c column chunks, each its own
    kernel and all-reduce: chunk i's all-reduce is issued asynchronously
    (on NCCL it runs on NCCL's stream) while chunk i + 1's kernel runs,
    and all are waited before the concatenation. JAX's conditions hold
    (parallel/__init__.py:256-263): N/c covers whole pack tiles of the
    TPU layout (128 * 8/bits columns), no reduce_scatter, no packed
    (quantized) zeros."""
    tp = dist.get_world_size(group)
    check_row_shard(config, tp)
    nc = int(overlap_chunks)
    if nc > 1:
        tile = 128 * (8 // config.bit) if config.bit < 8 else 128
        if config.N % nc or (config.N // nc) % tile:
            raise ValueError(f"chunk width N/{nc} must cover whole pack "
                             f"tiles ({tile})")
        if reduce_scatter:
            raise ValueError("overlap_chunks composes with the all-reduce "
                             "only (a chunked reduce-scatter would permute "
                             "the N shard layout)")
        if config.zeros_mode == "quantized":
            raise ValueError("overlap_chunks with packed qzeros is not "
                             "supported")
    cw = config.N // nc
    op = local_matmul(config, m, device, n=cw, k=config.K // tp)

    def fn(A, W, scales=None, zeros=None, bias=None):
        parts, works = [], []
        out_dtype = None
        for c in range(nc):
            sl = slice(c * cw, (c + 1) * cw)
            if nc == 1:
                w_c, s_c, z_c = W, scales, zeros
            else:   # the chunk's weight rows, scale and zero columns
                w_c = W[sl]
                s_c = None if scales is None else scales[:, sl].contiguous()
                z_c = None if zeros is None else zeros[:, sl].contiguous()
            out_c = op.forward(A, w_c, scale=s_c, zeros=z_c)
            out_dtype = out_c.dtype
            acc = out_c.float()
            if reduce_scatter:
                acc = reduce_scatter_dim(acc, 1, group)
            elif tp > 1:
                works.append(dist.all_reduce(acc, group=group,
                                             async_op=nc > 1))
            parts.append(acc)
        for w in works:
            if w is not None:
                w.wait()
        acc = parts[0] if nc == 1 else torch.cat(parts, dim=1)
        if config.with_bias and bias is not None:
            acc = acc + bias.reshape(1, -1).float()
        return acc.to(out_dtype)

    fn.op = op
    return fn

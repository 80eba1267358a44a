"""Pipeline parallelism: the GPipe schedule over a process group
(counterpart of bitblas_tpu/parallel/pipeline.py).

Rank s of the group is pipeline stage s and holds only its stage's
layers. For pp stages and n_micro microbatches the schedule runs
n_micro + pp - 1 ticks:

  tick t:  stage 0 takes microbatch t (while t < n_micro)
           every stage applies its layers to its current activation
           stage pp - 1 emits microbatch t - (pp - 1)
           activations hop s -> s + 1 (batch_isend_irecv, JAX's
           ppermute ring)

A stage outside its n_micro busy ticks (the bubble, (pp - 1) / (n_micro +
pp - 1) of them) sends zeros and computes nothing: JAX computes on zeros
there and masks the result. The last stage's outputs reach every rank by
a broadcast from it (JAX: a psum in which the other stages add zeros).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def stack_stage_params(per_stage_params: Sequence[Dict[str, torch.Tensor]],
                       group=None) -> Dict[str, torch.Tensor]:
    """This rank's stage of the per-stage parameter dicts (stage s on rank
    s of `group`; JAX stacks them on a leading axis sharded over the
    pipeline axis, whose local slab is this one)."""
    if len(per_stage_params) != dist.get_world_size(group):
        raise ValueError(f"{len(per_stage_params)} stages for a group of "
                         f"{dist.get_world_size(group)} ranks")
    return {k: v.contiguous()
            for k, v in per_stage_params[dist.get_rank(group)].items()}


def make_gpipe_fn(stage_fn: Callable, group=None) -> Callable:
    """pipeline(params, xs) -> ys: `stage_fn(params, x)` applies this
    rank's stage to one microbatch [B, ...] (same shape out); xs [n_micro,
    B, ...] replicated on every rank; ys [n_micro, B, ...] replicated."""
    pp, s = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = _global(group, (s + 1) % pp), _global(group, (s - 1) % pp)
    last = _global(group, pp - 1)

    def pipeline(params, xs):
        n_micro = xs.shape[0]
        cur = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + pp - 1):
            if s == 0 and t < n_micro:
                cur = xs[t]
            busy = s <= t < s + n_micro
            y = stage_fn(params, cur) if busy else torch.zeros_like(cur)
            emit = t - (pp - 1)
            if s == pp - 1 and 0 <= emit < n_micro:
                outs[emit] = y
            if pp > 1 and t < n_micro + pp - 2:   # the last hop is dead
                recv = torch.empty_like(y)
                ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                       dist.P2POp(dist.irecv, recv, prv, group)]
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
                cur = recv
        if pp > 1:
            dist.broadcast(outs, src=last, group=group)
        return outs

    return pipeline


def make_quant_stage_fn(config: MatmulConfig, m: int, layers_per_stage: int,
                        device="cuda") -> Callable:
    """Stage body: `layers_per_stage` fused dequant matmuls, each followed
    by gelu (tanh, as jax.nn.gelu's default). Params: {"qweight" [L, N,
    K*bits/32], optionally "scales" [L, K/g, N]}; N == K, so activations
    keep their shape. The building block for pipelining a quantized MLP
    trunk."""
    if config.N != config.K:
        raise ValueError("pipeline stage needs N == K")
    import dataclasses
    op = Matmul(dataclasses.replace(config, M=m), device=device,
                enable_tuning=False)

    def stage_fn(params, x):
        h = x
        for i in range(layers_per_stage):
            s = params["scales"][i] if "scales" in params else None
            h = op.forward(h, params["qweight"][i], scale=s)
            h = torch.nn.functional.gelu(h.float(),
                                         approximate="tanh").to(x.dtype)
        return h

    stage_fn.op = op
    return stage_fn

"""Expert-parallel MoE over a process group (counterpart of
bitblas_tpu/parallel/moe.py).

The experts are split across the ranks of the group (rank r holds experts
[r E/ep, (r+1) E/ep)); the router and the activations are replicated.
Every rank computes the whole dispatch (the router is a small dense
product), runs its own experts through the fused Matmul, combines their
outputs with its tokens' gates (zero for other ranks' experts) and one
float32 all-reduce joins the ranks' partial sums: the dense-dispatch
formulation of expert parallelism, with no all-to-all while the
activations are replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.quant_moe import (QuantMoELayer, combine_rows, dispatch_rows,
                                route)


class EPQuantMoELayer:
    """The expert-parallel twin of a single-device QuantMoELayer (its
    router, its Matmul operators and this rank's slice of its expert
    stacks, as views), so EP can be held to the single-device layer."""

    def __init__(self, layer: QuantMoELayer, group=None):
        cfg = layer.cfg
        ep = dist.get_world_size(group)
        if cfg.n_experts % ep:
            raise ValueError(f"ep={ep} must divide n_experts="
                             f"{cfg.n_experts}")
        self.cfg = cfg
        self.group = group
        self.layer = layer
        self.e_local = cfg.n_experts // ep
        self.e0 = dist.get_rank(group) * self.e_local
        self.allreduces = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, H] -> [T, H] in x's type, at any T (the capacity follows
        T, as QuantMoELayer's); all-zero rows are routing-invisible."""
        cfg, layer = self.cfg, self.layer
        capacity = layer.capacity_for(x.shape[0])
        valid = (x != 0).any(dim=-1)
        r = route(x.float() @ layer.router, cfg.top_k, capacity, valid)
        xin = dispatch_rows(x, r, cfg.n_experts, capacity)
        outs = torch.zeros_like(xin)
        for e in range(self.e0, self.e0 + self.e_local):
            outs[e] = layer.expert_ffn(e, xin[e])
        y = combine_rows(outs, r)
        if dist.get_world_size(self.group) > 1:
            dist.all_reduce(y, group=self.group)
            self.allreduces += 1
        return y.to(x.dtype)

    __call__ = forward


def expert_parallel_mixtral(model, group=None):
    """Switch a QuantMixtral's routed FFNs to expert parallelism over
    `group`, in place: each layer's `moe_ep` becomes an EPQuantMoELayer
    over its `moe` (one all-reduce a layer joins the experts' outputs).
    Attention stays replicated. The single-device QuantMoELayer stays
    attached (its state dict is unchanged). Returns the model."""
    for layer in model.layers:
        layer.moe_ep = EPQuantMoELayer(layer.moe, group)
    return model

"""Routed MoE FFN and the Mixtral decoder (counterpart of
bitblas_tpu/models/quant_moe.py).

Routing is GShard / Switch top-k with a capacity: each token picks its
top_k experts by router probability (the lower index first on a tie, as
`jax.lax.top_k`), every first choice claims a slot in its expert's
buffer before any second choice does (slot-major priority), and an
expert takes at most `capacity` tokens (`moe_capacity`); a choice past
the capacity is dropped. All-zero rows (inactive engine slots, bucket
padding) claim nothing.

`dispatch_combine` gives the JAX package's one-hot [T, E, C] pair. The
forward path uses the same routing in index form (`route`): each
(token, choice) maps to its expert, its slot in that expert's buffer,
whether it fits and its gate. The dispatch is then a gather of rows into
[E, C, hidden] and the combine a weighted sum of each token's k expert
rows: the one-hot einsums' numbers without their [T k, E, C] tensors,
and no host sync. Every expert runs its three projections at M =
capacity, as in JAX, through one uint4 `Matmul` a projection shared by
the experts; each projection's experts are stacked, [E, N, K/8] words
and [E, K/g, N] scales and zeros, so one expert's operands are a
contiguous view.

`QuantMixtral` is a Llama decoder whose layers hand their MLP block to
the routed FFN through `mlp_forward` (quant_llama._layer_mlp), so every
engine, `generate` and the chunked paths serve it unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..common import resolve_device
from ..kernels.dequant_matmul import dequantize_hopper
from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from ..ops.weight_transform import scale_dtype
from .quant_llama import (_PROJS, DecoderServingMixin, LlamaConfig,
                          QuantLlamaLayer)


@dataclass
class MoEConfig:
    hidden_size: int = 512
    intermediate_size: int = 1024
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.5
    group_size: int = 128
    act_dtype: str = "float16"


def moe_capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots an expert's buffer: ceil(T k / E * factor), rounded up to a
    multiple of 8, at least 8 (JAX's rule: it decides which tokens drop)."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, (c + 7) // 8 * 8)


class MoERoute(NamedTuple):
    """Each (token, choice), [T, top_k]: its expert, gate (float32,
    normalized over the token's choices), slot in the expert's buffer,
    and whether it fits (a valid row within the capacity)."""
    experts: torch.Tensor
    gates: torch.Tensor
    slots: torch.Tensor
    fits: torch.Tensor


def top_k_gates(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits [T, E] -> (gates [T, k] float32, experts [T, k]
    int64): the top k of the softmax, from a stable descending sort (the
    lower index first on equal probabilities, as jax.lax.top_k), the gates
    divided by their sum."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    return gates / gates.sum(dim=-1, keepdim=True), idx[:, :top_k]


def route(logits: torch.Tensor, top_k: int, capacity: int,
          valid: Optional[torch.Tensor] = None) -> MoERoute:
    """Router logits [T, E] -> MoERoute. A choice's slot is the number of
    valid choices before it, in slot-major order (every token's first
    choice, then every second choice), that went to the same expert."""
    T, E = logits.shape
    gates, experts = top_k_gates(logits, top_k)
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=logits.device)
    flat = experts.T.reshape(-1)                        # slot-major [k T]
    onehot = torch.nn.functional.one_hot(flat, E) \
        * valid.repeat(top_k).to(torch.int64)[:, None]
    before = (onehot.cumsum(dim=0) - onehot).gather(1, flat[:, None])
    slots = before.reshape(top_k, T).T
    fits = valid[:, None] & (slots < capacity)
    return MoERoute(experts, gates, slots, fits)


def dispatch_combine(logits: torch.Tensor, top_k: int, capacity: int,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits [T, E] -> (dispatch [T, E, C] 0 / 1, combine [T, E,
    C] the gates), both float32: the JAX package's one-hot form of
    `route`."""
    T, E = logits.shape
    r = route(logits, top_k, capacity, valid)
    pos = (r.experts * capacity + r.slots).clamp(max=E * capacity - 1)
    hot = torch.nn.functional.one_hot(pos, E * capacity).float() \
        * r.fits[..., None].float()                         # [T, k, E C]
    dispatch = hot.sum(dim=1).reshape(T, E, capacity)
    combine = (hot * r.gates[..., None]).sum(dim=1).reshape(T, E, capacity)
    return dispatch, combine


def dispatch_rows(x: torch.Tensor, r: MoERoute, n_experts: int,
                  capacity: int) -> torch.Tensor:
    """x [T, H] -> the experts' buffers [E, C, H] in x's type: row (e, c)
    holds the token routed to slot c of expert e, or zeros."""
    T, H = x.shape
    size = n_experts * capacity
    dest = torch.where(r.fits, r.experts * capacity + r.slots, size)
    tokens = torch.arange(T, device=x.device)[:, None].expand_as(dest)
    src = torch.full((size + 1,), T, dtype=torch.int64, device=x.device)
    src.scatter_(0, dest.reshape(-1), tokens.reshape(-1))
    rows = torch.cat([x, x.new_zeros((1, H))])
    return rows[src[:size]].reshape(n_experts, capacity, H)


def combine_rows(outs: torch.Tensor, r: MoERoute) -> torch.Tensor:
    """The experts' outputs [E, C, H] -> [T, H] float32: each token's sum
    over its choices of gate * its slot's row (0 for a dropped choice), in
    choice order."""
    E, C, H = outs.shape
    rows = outs.reshape(E * C, H)
    at = torch.where(r.fits, r.experts * C + r.slots, 0)
    w = torch.where(r.fits, r.gates, 0.0)
    y = w[:, 0:1] * rows[at[:, 0]].float()
    for j in range(1, at.shape[1]):
        y = y + w[:, j:j + 1] * rows[at[:, j]].float()
    return y


EXPERT_PROJS = (("gate", "hidden_size", "intermediate_size"),
                ("up", "hidden_size", "intermediate_size"),
                ("down", "intermediate_size", "hidden_size"))
_TENSORS = ("qweight", "scales", "zeros")


def expert_config(cfg: MoEConfig, name: str, M) -> MatmulConfig:
    """The uint4 Matmul configuration of projection `name` (gate / up /
    down): group `cfg.group_size`, original zeros, A and out in
    act_dtype."""
    kin, kout = next((k, n) for p, k, n in EXPERT_PROJS if p == name)
    return MatmulConfig(M=M, N=getattr(cfg, kout), K=getattr(cfg, kin),
                        A_dtype=cfg.act_dtype, W_dtype="uint4",
                        with_scaling=True, with_zeros=True,
                        zeros_mode="original", group_size=cfg.group_size,
                        out_dtype=cfg.act_dtype)


def make_expert_weights(cfg: MoEConfig, seed: int = 0, device="cuda"
                        ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Random stacked device-layout operands {projection: (qweight [E, N,
    K/8] int32, scales [E, K/g, N], zeros [E, K/g, N])}, drawn on `device`
    from a seeded torch.Generator in the JAX fixture's distributions:
    uniform uint4 codes (every 32-bit word is eight of them), scales
    |N(0, 1)| * 0.004 + 0.004, zero point 8; scales and zeros in the
    activation type."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, _, _ in EXPERT_PROJS:
        mcfg = expert_config(cfg, name, None)
        K, N, E = mcfg.K, mcfg.N, cfg.n_experts
        groups = K // mcfg.effective_group_size
        sdt = scale_dtype(mcfg)
        words = torch.randint(-2 ** 31, 2 ** 31, (E, N, K // 8),
                              generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        scales = (torch.randn((E, groups, N), generator=gen, device=dev)
                  .abs() * 0.004 + 0.004).to(sdt)
        zeros = torch.full((E, groups, N), 8.0, dtype=sdt, device=dev)
        out[name] = (words, scales, zeros)
    return out


class QuantMoELayer(nn.Module):
    """The routed FFN: a float32 router [H, E] and, for each of gate / up
    / down, one uint4 Matmul shared by the experts (built for M =
    capacity at `tokens`) and the experts' stacked buffers
    ``<proj>_qweight`` [E, N, K/8], ``<proj>_scales`` / ``<proj>_zeros``
    [E, K/g, N]. Its state dict takes the JAX package's names: ``router``
    and ``expert_<e>.<proj>.<qweight|scales|zeros>`` (views of the
    stacks)."""

    def __init__(self, cfg: MoEConfig, tokens: int, *, seed: int = 0,
                 device="cuda", enable_tuning: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tokens = tokens
        self.capacity = moe_capacity(cfg, tokens)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        self.register_buffer("router", torch.randn(
            (cfg.hidden_size, cfg.n_experts), generator=gen, device=dev)
            * 0.05)
        self.ops: Dict[str, Matmul] = {}
        for name, (w, s, z) in make_expert_weights(cfg, seed, dev).items():
            self.ops[name] = Matmul(expert_config(cfg, name, self.capacity),
                                    device=dev, enable_tuning=enable_tuning)
            for t, v in zip(_TENSORS, (w, s, z)):
                self.register_buffer(f"{name}_{t}", v)

    @property
    def group_size(self) -> int:
        return self.ops["gate"].config.effective_group_size

    def expert(self, name: str, e: int) -> Tuple[torch.Tensor, ...]:
        """Expert e's (qweight, scales, zeros) of projection `name`."""
        return tuple(getattr(self, f"{name}_{t}")[e] for t in _TENSORS)

    def proj(self, name: str, e: int, x: torch.Tensor) -> torch.Tensor:
        w, s, z = self.expert(name, e)
        return self.ops[name].forward(x, w, scale=s, zeros=z)

    def expert_ffn(self, e: int, x: torch.Tensor) -> torch.Tensor:
        g = self.proj("gate", e, x)
        u = self.proj("up", e, x)
        h = (torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype)
        return self.proj("down", e, h)

    def capacity_for(self, tokens: int) -> int:
        return (self.capacity if tokens == self.tokens
                else moe_capacity(self.cfg, tokens))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, H] -> [T, H] in x's type, at any T (the capacity follows
        T). All-zero rows are masked out of routing: the block has no
        biases, so their output is zero whatever the routing, and they
        must not take a real token's slot."""
        cfg = self.cfg
        capacity = self.capacity_for(x.shape[0])
        valid = (x != 0).any(dim=-1)
        r = route(x.float() @ self.router, cfg.top_k, capacity, valid)
        xin = dispatch_rows(x, r, cfg.n_experts, capacity)
        outs = torch.stack([self.expert_ffn(e, xin[e])
                            for e in range(cfg.n_experts)])
        return combine_rows(outs, r).to(x.dtype)

    # -- the JAX package's state names -----------------------------------
    def _named(self) -> Dict[str, torch.Tensor]:
        out = {"router": self.router}
        for name, _, _ in EXPERT_PROJS:
            for t in _TENSORS:
                stack = getattr(self, f"{name}_{t}")
                for e in range(self.cfg.n_experts):
                    out[f"expert_{e}.{name}.{t}"] = stack[e]
        return out

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for key, t in self._named().items():
            destination[prefix + key] = t if keep_vars else t.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        named = self._named()
        for key, dst in named.items():
            src = state_dict.get(prefix + key)
            if src is None:
                missing_keys.append(prefix + key)
            elif tuple(src.shape) != tuple(dst.shape):
                error_msgs.append(f"size mismatch for {prefix + key}: "
                                  f"{tuple(src.shape)} vs {tuple(dst.shape)}")
            else:
                with torch.no_grad():
                    dst.copy_(src)
        if strict:
            unexpected_keys.extend(
                k for k in state_dict if k.startswith(prefix)
                and k[len(prefix):] not in named)


def moe_reference(layer: QuantMoELayer, x: torch.Tensor) -> torch.Tensor:
    """The oracle, float32 [T, H]: the same routing at `layer.capacity`
    (as JAX's), each expert a float32 product on its decoded weights."""
    cfg = layer.cfg
    xf = x.float()
    r = route(xf @ layer.router, cfg.top_k, layer.capacity,
              (x != 0).any(dim=-1))
    xin = dispatch_rows(xf, r, cfg.n_experts, layer.capacity)
    outs = []
    for e in range(cfg.n_experts):
        w = {name: dequantize_hopper(*layer.expert(name, e),
                                     layer.group_size).float()
             for name, _, _ in EXPERT_PROJS}
        g = xin[e] @ w["gate"].T
        u = xin[e] @ w["up"].T
        outs.append((torch.nn.functional.silu(g) * u) @ w["down"].T)
    return combine_rows(torch.stack(outs), r)


# -- the Mixtral decoder ------------------------------------------------------

@dataclass
class MixtralConfig(LlamaConfig):
    """LlamaConfig (the attention fields) and the routed FFN's."""
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.5

    def moe_config(self) -> MoEConfig:
        return MoEConfig(hidden_size=self.hidden_size,
                         intermediate_size=self.intermediate_size,
                         n_experts=self.n_experts, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         group_size=self.group_size,
                         act_dtype=self.act_dtype)


class QuantMixtralLayer(QuantLlamaLayer):
    """One Mixtral layer: QuantLlamaLayer's q / k / v / o projections and
    norms, and a QuantMoELayer (`moe`) as its MLP block through
    `mlp_forward`."""

    PROJS = _PROJS[:4]

    def __init__(self, cfg: MixtralConfig, seed: int = 0, device="cuda",
                 enable_tuning: bool = False,
                 opt_m: Optional[Sequence[int]] = None,
                 moe_tokens: int = 256):
        super().__init__(cfg, seed=seed, device=device,
                         enable_tuning=enable_tuning, opt_m=opt_m)
        self.moe = QuantMoELayer(cfg.moe_config(), moe_tokens, seed=seed,
                                 device=self.attn_norm.device,
                                 enable_tuning=enable_tuning)

    # parallel/moe.expert_parallel_mixtral sets an EPQuantMoELayer here
    moe_ep = None

    def mlp_forward(self, h: torch.Tensor) -> torch.Tensor:
        return (self.moe_ep or self.moe)(h)


class QuantMixtral(DecoderServingMixin, nn.Module):
    """A stack of Mixtral layers with the decoder's serving surface (no
    embeddings: models/hf_import.LMHead adds the ends). `moe_tokens` is
    the T each layer's expert operators are built for (their M is its
    capacity); any T runs."""

    def __init__(self, cfg: MixtralConfig, device="cuda", seed: int = 0,
                 enable_tuning: bool = False,
                 opt_m: Optional[Sequence[int]] = None,
                 moe_tokens: int = 256):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.layers = nn.ModuleList(
            [QuantMixtralLayer(cfg, seed=seed + i, device=self.device,
                               enable_tuning=enable_tuning, opt_m=opt_m,
                               moe_tokens=moe_tokens)
             for i in range(cfg.num_layers)])

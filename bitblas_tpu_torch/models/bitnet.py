"""BitNet b1.58 inference layers (counterpart of
bitblas_tpu/models/bitnet.py).

Weights are ternarized offline to {-1, 0, 1} codes with one absmean scale
`sw` per matrix and stored as int2 fields (ops/matmul.py, W2A8
configuration); activations are quantized per token to int8 at run time.
The W_INT2 x A_INT8 product accumulates in int32 -- through the fused
kernel or the materialize plan, as the operator's hint for M says -- and
is rescaled by ``sw * s_a`` (the reference's post_quant_process). A
BitLinearInference takes its Matmul from `cache.global_operator_cache`
(building an untuned one on a miss), as the JAX layer does, so one
operator per distinct (N, K) serves every layer, and hints loaded from
the hint database (cache.load_global_ops_cache) route them all.
`BitNetLlama` is a llama-topology stack with every projection a
BitLinear, served by the decoder mixin of models/quant_llama.py and so
by every engine.

The training side is the straight-through QAT forward: `ste` and
`bitlinear_train_forward` fake-quantize activations and weights, take
the dense product in float32 (torch.matmul: no kernel is involved, as
JAX's is a plain XLA dot) and let autograd pass the gradient straight
through the rounding.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..cache import global_operator_cache
from ..common import resolve_device
from ..ops import weight_transform as wt
from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from .quant_llama import _PROJS, DecoderServingMixin, LlamaConfig, _dim


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t rounded once, as JAX divides: PyTorch evaluates ``c / t`` for
    a Python number c as ``t.reciprocal() * c``, which can differ by one
    float32 ulp."""
    return torch.full_like(t, c) / t


def weight_quant(w: torch.Tensor, num_bits: int = 1) -> torch.Tensor:
    """Ternary fake quant around the mean |w| scale (the JAX
    `weight_quant`); returns w's dtype."""
    del num_bits
    wf = w.to(torch.float32)
    s = _rdiv(1.0, torch.clamp(wf.abs().mean(), min=1e-5))
    return (torch.clamp(torch.round(wf * s), -1, 1) / s).to(w.dtype)


def weight_quant_codes(w):
    """Offline ternarization: (codes in {-1, 0, 1} int8, the scale sw
    float32). A numpy array is processed in numpy, as the JAX function
    does (bit-identical); a tensor stays on its device."""
    if isinstance(w, torch.Tensor):
        wf = w.to(torch.float32)
        sw = _rdiv(1.0, torch.clamp(wf.abs().mean(), min=1e-5))
        codes = torch.clamp(torch.round(wf * sw), -1, 1).to(torch.int8)
        return codes, sw
    w = np.asarray(w, np.float32)
    sw = 1.0 / max(np.abs(w).mean(), 1e-5)
    codes = np.clip(np.round(w * sw), -1, 1).astype(np.int8)
    return codes, np.float32(sw)


def activation_quant(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Per-token absmax int8 fake quant (the JAX `activation_quant`)."""
    xf = x.to(torch.float32)
    qp = 2 ** (num_bits - 1) - 1
    qn = -(2 ** (num_bits - 1))
    s = _rdiv(qp, torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-5))
    return (torch.clamp(torch.round(xf * s), qn, qp) / s).to(x.dtype)


def activation_quant_int8(x: torch.Tensor):
    """Per-token int8 quantization for the W2A8 product: (q int8, scale
    float32 [..., 1]) with x ~= q / scale. float32 absmax, 127 /
    clamp(max, 1e-5), round half to even, clamp to [-128, 127] -- the JAX
    function bit for bit."""
    xf = x.to(torch.float32)
    s = _rdiv(127.0, torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                                 min=1e-5))
    q = torch.clamp(torch.round(xf * s), -128, 127).to(torch.int8)
    return q, s


def ste(x: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value of `quantized`, the gradient
    of `x`."""
    return x + (quantized - x).detach()


def bitlinear_train_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """QAT forward: x [..., K] and w [N, K] fake-quantized through `ste`,
    their product summed in float32 and cast to x's type. The operands
    are float32 before the product, so no reduced-precision reduction of
    cuBLAS applies."""
    xq = ste(x, activation_quant(x))
    wq = ste(w, weight_quant(w))
    return torch.matmul(xq.float(), wq.float().T).to(x.dtype)


class BitLinearInference(nn.Module):
    """W_INT2 x A_INT8 inference layer: buffers `qweight` [N, K/16] int32
    (biased int2 fields, K-packed) and `sw` () float32; its Matmul comes
    from the global operator cache. The operator runs on the device of
    its inputs, so layers on the card and on the CPU share it."""

    def __init__(self, in_features: int, out_features: int,
                 opt_m: tuple = (1, 16, 32, 64, 128, 256), device="cuda"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        dev = resolve_device(device)
        self.config = MatmulConfig(
            M=list(opt_m), N=out_features, K=in_features, A_dtype="int8",
            W_dtype="int2", accum_dtype="int32", out_dtype="float32")
        op = global_operator_cache.get(self.config)
        if op is None:
            op = Matmul(self.config, device=dev, enable_tuning=False)
            global_operator_cache.add(self.config, op)
        self.matmul = op
        self.register_buffer("qweight", torch.zeros(
            self.matmul.retrieve_weight_shape(), dtype=torch.int32,
            device=dev))
        self.register_buffer("sw", torch.ones((), dtype=torch.float32,
                                              device=dev))

    @classmethod
    def from_weight(cls, w, **kw) -> "BitLinearInference":
        """w: [out, in] float master weight (numpy or tensor) -> the
        ternarized layer."""
        layer = cls(in_features=w.shape[1], out_features=w.shape[0], **kw)
        codes, sw = weight_quant_codes(w)
        layer.qweight.copy_(wt.signed_weight_to_device(layer.config, codes))
        layer.sw.copy_(torch.as_tensor(sw, dtype=torch.float32))
        return layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, s_a = activation_quant_int8(x)
        acc = self.matmul.forward(q, self.qweight)   # exact int sums, f32
        return (acc / (self.sw * s_a)).to(x.dtype)


class BitNetLlamaLayer(nn.Module):
    """One BitNet b1.58 decoder layer: llama topology, every projection a
    BitLinearInference (`projs.<name>.qweight` / `.sw`), and the two
    RMSNorm weights. Random init draws each master weight from N(0, 0.02)
    on the layer's device with a seeded torch.Generator, as the JAX
    fixture draws from numpy, and ternarizes it."""

    def __init__(self, cfg: LlamaConfig, opt_m=(1, 16, 256), seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        projs: Dict[str, BitLinearInference] = {}
        for name, kin, kout in _PROJS:
            K, N = _dim(cfg, kin), _dim(cfg, kout)
            w = torch.randn((N, K), generator=gen, device=dev) * 0.02
            projs[name] = BitLinearInference.from_weight(w, opt_m=opt_m,
                                                         device=dev)
            del w
        self.projs = nn.ModuleDict(projs)
        self.register_buffer("attn_norm", torch.ones(
            cfg.hidden_size, dtype=torch.float32, device=dev))
        self.register_buffer("mlp_norm", torch.ones(
            cfg.hidden_size, dtype=torch.float32, device=dev))

    def proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.projs[name](x)


class BitNetLlama(DecoderServingMixin, nn.Module):
    """A stack of BitNet decoder layers (hidden states in and out, like
    QuantLlama); the decoder mixin gives it prefill, every decode step and
    so every engine."""

    def __init__(self, cfg: LlamaConfig, opt_m=(1, 16, 256), device="cuda",
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.layers = nn.ModuleList(
            [BitNetLlamaLayer(cfg, opt_m, seed=seed + i, device=self.device)
             for i in range(cfg.num_layers)])

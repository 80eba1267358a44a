"""BitNet b1.58 as a torch.nn.Module over the W_INT2 x A_INT8 operator
(counterpart of bitblas_tpu/integration/bitnet.py).

`BitLinearBitBLAS.from_bit_linear` ternarizes a trained BitLinear's master
weight to {-1, 0, 1} codes with one absmean scale `sw` and serves it
through `models.bitnet.BitLinearInference`. The state dict holds `qweight`
[out, in] int8 (the unpacked ternary codes; `post_init` rebuilds the
packed device operand from it), `sw` () float32 and `bias` [out] float32.
Unlike the JAX module, whose forward round-trips through numpy on the
host, `forward` stays on the module's device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import resolve_device
from ..ops import weight_transform as wt
from ..models.bitnet import (BitLinearInference, activation_quant,
                             weight_quant, weight_quant_codes)


class BitLinearBitBLAS(nn.Module):
    """Inference BitLinear: ternary weights on the int8 tensor cores."""

    def __init__(self, in_features: int, out_features: int,
                 weight_bits: int = 1, input_bits: int = 8, device="cuda"):
        super().__init__()
        if input_bits != 8:
            raise NotImplementedError("Only int8 activations are supported.")
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.inner = BitLinearInference(in_features, out_features,
                                        device=dev)
        self.register_buffer("qweight", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=dev))
        self.register_buffer("sw", torch.ones((), dtype=torch.float32,
                                              device=dev))
        # always present (zeros when the source has none), so a state dict
        # saved from a biased layer loads into a fresh module
        self.register_buffer("bias", torch.zeros(
            (out_features,), dtype=torch.float32, device=dev))
        self.format = "bitnet"

    @classmethod
    def from_bit_linear(cls, bitlinear: nn.Module,
                        device="cuda") -> "BitLinearBitBLAS":
        """A trained BitLinear (float master weight) -> the packed
        inference layer on `device`."""
        layer = cls(bitlinear.in_features, bitlinear.out_features,
                    device=device)
        w = bitlinear.weight.detach().float().cpu().numpy()
        codes, sw = weight_quant_codes(w)
        layer.qweight.copy_(torch.from_numpy(codes))
        layer.sw.fill_(float(sw))
        if getattr(bitlinear, "bias", None) is not None:
            layer.bias.copy_(bitlinear.bias.detach().float())
        layer.post_init()
        return layer

    def post_init(self) -> None:
        """Rebuild the packed operand from the buffers (call after
        `load_state_dict`)."""
        inner = self.inner
        inner.qweight.copy_(wt.signed_weight_to_device(inner.config,
                                                       self.qweight))
        inner.sw.copy_(self.sw)
        self.format = "bitblas"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        out = self.inner(x.reshape(-1, self.in_features).float())
        out = out.reshape(*lead, self.out_features) + self.bias
        return out.to(x.dtype)


__all__ = ["BitLinearBitBLAS", "weight_quant", "activation_quant"]

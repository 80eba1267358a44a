"""PyTorch drop-in quantized linear (counterpart of
bitblas_tpu/integration/pytorch.py, the reference `QuantLinear`).

A `torch.nn.Module` whose state_dict fields follow the reference layout:
``qweight`` [out, in*bits/8] int8 (codes packed along `in`), ``scales``
[out, in/groups] half, ``zeros`` [out, in/groups] half (integer zero
points stored as floats, zeros_mode "original": w = (q - z) * s) and an
optional ``bias`` [out] half, so checkpoints are interchangeable with the
reference's torch integration. The compute runs through the port's
`module.Linear` on the layer's device (JAX's version converts every
activation through numpy on the host; this one stays on the card).
`post_init()` rebuilds the device operands from the buffers: call it
after `load_state_dict`, as AutoGPTQ's post-init contract asks. Bits 1,
2 and 4 run (uint1 / uint2 / uint4 with GPTQ-style scales and zeros),
under any A_dtype JAX's QuantLinear takes: float16, bfloat16 (the scales
and zeros then in bfloat16 on the card), int8 (as JAX builds it: the
activations taken to int8 (a float input truncated), the output int8,
saturating, then taken to the input's type), float32 and the others
(the general instance of kernel 1, ops/matmul_config.py).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn as nn

from ..common import resolve_device
from ..graph import as_tensor
from ..module import Linear
from ..quantization import packing
from ..quantization.formats import as_torch_dtype


class QuantLinear(nn.Module):
    QUANT_TYPE = "bitblas_tpu_torch"

    def __init__(
        self,
        bits: int,
        group_size: int,
        in_features: int,
        out_features: int,
        bias: bool,
        enable_tuning: bool = False,
        fast_decoding: Optional[bool] = None,
        opt_M: Optional[Union[int, List[int]]] = None,
        layout: str = "nt",
        trainable: bool = False,
        A_dtype: str = "float16",
        device="cuda",
        **kwargs,
    ):
        super().__init__()
        if bits not in (1, 2, 4):
            raise NotImplementedError("Only 1/2/4 bits are supported.")
        if trainable:
            raise NotImplementedError(
                "QuantLinear is inference-only (reference parity).")
        if layout != "nt":
            raise NotImplementedError("Only the nt layout is supported.")
        if group_size == -1:
            group_size = in_features
        if in_features % group_size != 0:
            raise ValueError(
                "`in_features` must be divisible by `group_size`.")
        dev = resolve_device(device)
        self.bits = bits
        self.in_features = in_features
        self.out_features = out_features
        self.group_size = group_size
        self.opt_M = opt_M
        self.act_dtype = as_torch_dtype(A_dtype)

        self.inner = Linear(
            in_features, out_features, bias=bias, A_dtype=A_dtype,
            W_dtype=f"uint{bits}", accum_dtype="float32", out_dtype=A_dtype,
            group_size=group_size, with_scaling=True, with_zeros=True,
            zeros_mode="original", opt_M=opt_M, enable_tuning=enable_tuning,
            fast_decoding=fast_decoding, device=dev)

        groups = in_features // group_size
        self.register_buffer("qweight", torch.zeros(
            (out_features, in_features * bits // 8), dtype=torch.int8,
            device=dev))
        self.register_buffer("scales", torch.ones(
            (out_features, groups), dtype=torch.half, device=dev))
        self.register_buffer("zeros", torch.zeros(
            (out_features, groups), dtype=torch.half, device=dev))
        if bias:
            self.register_buffer("bias", torch.zeros(
                (out_features,), dtype=torch.half, device=dev))
        else:
            self.bias = None

    # -- weight ingestion -------------------------------------------------

    def post_init(self) -> None:
        """Rebuild the device operands from the buffers (call after
        `load_state_dict`)."""
        codes = packing.unpack_qweight(self.qweight,
                                       self.bits)[:, :self.in_features]
        self.inner.load_and_transform_weight(
            codes, scales=self.scales, zeros=self.zeros,
            bias=None if self.bias is None else self.bias.float())

    def pack(self, linear: nn.Linear, scales: torch.Tensor,
             zeros: Optional[torch.Tensor] = None) -> None:
        """Quantize a fake-quantized `nn.Linear` into this layer (the
        reference's pack()): codes = round(w / s + z) clipped to the field,
        so w ~= (codes - z) * s; scales / zeros [out, in / group_size]."""
        dev = self.qweight.device
        w = linear.weight.detach().to(dev, torch.float32)
        s = scales.detach().to(dev, torch.float32)
        z = torch.zeros_like(s) if zeros is None else \
            zeros.detach().to(dev, torch.float32)
        g_idx = torch.arange(self.in_features, device=dev) // self.group_size
        codes = torch.round(w / s[:, g_idx] + z[:, g_idx])
        codes = torch.clamp(codes, 0, 2 ** self.bits - 1).to(torch.int8)
        self.qweight = packing.compress(codes, self.bits)
        self.scales = scales.detach().to(dev, torch.half).contiguous()
        self.zeros = z.to(torch.half)
        if self.bias is not None and linear.bias is not None:
            self.bias = linear.bias.detach().to(dev, torch.half).contiguous()
        self.post_init()

    def repack_from_gptq(self, gptq_module) -> None:
        """Ingest an AutoGPTQ (v1) CudaOldQuantLinear (the qzeros +1 quirk
        handled by module.Linear.repack_from_gptq)."""
        codes, intz = self.inner.repack_from_gptq(gptq_module)
        self._mirror_buffers_from_gptq(gptq_module, codes, intz)

    def repack_from_gptq_v2(self, gptq_module) -> None:
        """Ingest a GPTQModel (v2) checkpoint (no off-by-one)."""
        codes, intz = self.inner.repack_from_gptq_v2(gptq_module)
        self._mirror_buffers_from_gptq(gptq_module, codes, intz)

    def _mirror_buffers_from_gptq(self, gptq_module, codes: torch.Tensor,
                                  intz: torch.Tensor) -> None:
        """Keep the state_dict fields in step with what the device
        operands were built from (the codes and int zeros the inner
        repack unpacked), so a save / load round trip after a GPTQ repack
        gives the same layer."""
        dev = self.qweight.device
        self.qweight = packing.compress(codes, self.bits)
        self.scales = as_tensor(gptq_module.scales, dev).T.to(
            torch.half).contiguous()
        self.zeros = intz.T.to(torch.half).contiguous()
        b = getattr(gptq_module, "bias", None)
        if b is not None:
            # bias=False with a biased checkpoint raised in the inner
            # repack, so self.bias exists here
            self.bias = as_tensor(b, dev).to(torch.half)

    # -- forward ----------------------------------------------------------

    def forward(self, A: torch.Tensor) -> torch.Tensor:
        """A [..., in] on the layer's device -> [..., out] in A's dtype."""
        lead = A.shape[:-1]
        a2 = A.reshape(-1, self.in_features).to(self.act_dtype)
        out = self.inner.forward(a2)
        return out.reshape(*lead, self.out_features).to(A.dtype)


__all__ = ["QuantLinear"]

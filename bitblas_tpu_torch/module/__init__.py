"""Linear: the quantized linear layer over the Matmul operator
(counterpart of bitblas_tpu/module/__init__.py, the reference
`bitblas.Linear`).

An `nn.Module` on an explicit device (default "cuda"): it builds a
dynamic-M Matmul through the global operator cache (loading the hint
database first, tuning and saving when asked), owns the device-layout
buffers, and repacks AutoGPTQ v1 / GPTQModel v2 checkpoints (the v1
qzeros off-by-one included) with torch ops on its device. Every
(A_dtype, W_dtype) pair JAX's Linear takes runs (ops/matmul_config.py).
Buffers: ``qweight`` [N, ceil(K*bits/32)] int32 (wide int / uint
weights: [N, K] int16 / int32 words), or ``weight`` [N, K] in W's type
for a native pair; ``scales`` and ``zeros`` [K/g, N] in the scales' type
(wt.scale_dtype: A's for the specialized kernels, float16 for their int8
activations, else the decode type; quantized zeros are kept unpacked, as
values of that type, or int32 for the general instance), ``bias`` [1, N]
float32.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from ..cache import get_database_path, global_operator_cache
from ..common import get_logger, resolve_device
from ..graph import as_tensor, repack_gptq_layer
from ..ops import weight_transform as wt
from ..ops.matmul import Matmul
from ..ops.matmul_config import MatmulConfig
from ..quantization import packing
from ..quantization.formats import as_torch_dtype
from ..tuner import auto_detect_target

logger = get_logger()


def unpack_qweight(qweight, bits: int) -> torch.Tensor:
    """GPTQ qweight fields (packed along the last axis of its bytes) ->
    int8 codes, on the tensor's device."""
    return packing.unpack_qweight(as_tensor(qweight), bits)


def unpack_qzeros(qzeros, bits: int) -> torch.Tensor:
    """AutoGPTQ v1 qzeros with the `(z + 1) & mask` quirk."""
    return packing.unpack_qzeros(as_tensor(qzeros), bits)


def unpack_qzeros_v2(qzeros, bits: int) -> torch.Tensor:
    """GPTQModel v2 qzeros, no off-by-one."""
    return packing.unpack_qzeros_v2(as_tensor(qzeros), bits)


class Linear(nn.Module):
    opt_M = (1, 16, 32, 64, 128, 256, 512)
    STORAGE_DTYPE = "int8"

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = False,
        A_dtype: str = "float16",
        W_dtype: str = "float16",
        accum_dtype: str = "float32",
        out_dtype: str = "float16",
        group_size: int = -1,
        with_scaling: Optional[bool] = None,
        with_zeros: bool = False,
        zeros_mode: Optional[str] = None,
        opt_M: Union[int, List[int], None] = None,
        enable_tuning: bool = True,
        fast_decoding: Optional[bool] = None,
        target: Optional[str] = None,
        device="cuda",
    ):
        super().__init__()
        if in_features % 16 or out_features % 16:
            raise ValueError(
                "in_features/out_features must be divisible by 16")
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.opt_m = tuple(opt_M) if isinstance(opt_M, (list, tuple)) else \
            ((opt_M,) if isinstance(opt_M, int) else self.opt_M)
        self.group_size = in_features if group_size in (-1, None) \
            else group_size
        if in_features % self.group_size:
            raise ValueError("in_features must be divisible by group_size")
        self.is_consistent = A_dtype == W_dtype
        self.zeros_mode = zeros_mode

        config = MatmulConfig(
            M=list(self.opt_m), N=out_features, K=in_features,
            A_dtype=A_dtype, W_dtype=W_dtype, out_dtype=out_dtype,
            accum_dtype=accum_dtype, storage_dtype=self.STORAGE_DTYPE,
            with_scaling=bool(with_scaling), with_zeros=with_zeros,
            group_size=group_size, fast_decoding=fast_decoding,
            with_bias=bias, zeros_mode=zeros_mode)
        self.bitblas_matmul = self._get_or_create_operator(
            config, enable_tuning, target, dev)
        self.bits = self.bitblas_matmul.config.bit
        self.source_format = self.bitblas_matmul.config.source_format

        cfg = self.bitblas_matmul.config
        self.native = cfg.is_native_compute()
        if self.native:
            self.register_buffer("weight", torch.zeros(
                (out_features, in_features),
                dtype=as_torch_dtype(W_dtype), device=dev))
            self.register_buffer("qweight", None)
        else:
            self.register_buffer("qweight", torch.zeros(
                self.bitblas_matmul.retrieve_weight_shape(),
                dtype=torch.int16 if cfg.bit == 16 else torch.int32,
                device=dev))
            self.register_buffer("weight", None)
        groups = (in_features // self.group_size, out_features)
        sdt = wt.scale_dtype(cfg)
        zdt = torch.int32 if wt.general_quantized_zeros(cfg) else sdt
        self.register_buffer("scales", torch.ones(
            groups, dtype=sdt, device=dev) if cfg.with_scaling else None)
        self.register_buffer("zeros", torch.zeros(
            groups, dtype=zdt, device=dev) if cfg.with_zeros else None)
        self.register_buffer("bias", torch.zeros(
            (1, out_features), dtype=torch.float32, device=dev)
            if bias else None)

    @property
    def device(self) -> torch.device:
        return (self.weight if self.native else self.qweight).device

    # -- operator cache -----------------------------------------------------
    @staticmethod
    def _get_or_create_operator(config: MatmulConfig, enable_tuning: bool,
                                target: Optional[str],
                                device) -> Matmul:
        """The config's operator from the global cache, which is filled
        from the hint database first when empty; a new one is tuned
        (enable_tuning) and saved to the database."""
        target = target or auto_detect_target(device)
        path = get_database_path()
        if global_operator_cache.size() == 0:
            loaded = global_operator_cache.load_from_database(path, target)
            if loaded:
                logger.info("Loaded %d operators from database.", loaded)
        op = global_operator_cache.get(config)
        if op is None:
            op = Matmul(config, device=device, enable_tuning=False)
            if enable_tuning:
                op.hardware_aware_finetune(topk=20)
                global_operator_cache.add(config, op)
                global_operator_cache.save_into_database(path, target)
                logger.info("tuned operator saved to database")
            else:
                global_operator_cache.add(config, op)
        return op

    def warmup(self, topk: int = 20) -> None:
        self.bitblas_matmul.hardware_aware_finetune(topk=topk)

    # -- forward --------------------------------------------------------------
    def forward(self, A) -> torch.Tensor:
        """A [..., in_features] on the layer's device -> [..., out]."""
        W = self.weight if self.native else self.qweight
        A = as_tensor(A, W.device)
        return self.bitblas_matmul.forward(A, W, scale=self.scales,
                                           zeros=self.zeros, bias=self.bias)

    # -- weight loading -----------------------------------------------------
    def load_and_transform_weight(self, weight, scales=None, zeros=None,
                                  bias=None) -> None:
        """Load an unpacked weight [out, in] (codes; int values for the int
        family; fp8 bytes or a float8 tensor; or the dense weight of a
        native layer) with scales [out, in/g], zeros [out, in/g]
        (quantized mode: packed [in/g, out*bits/8] int8) and bias [out]."""
        dev, cfg = self.device, self.bitblas_matmul.config
        # the Matmul moves it to the device, reads float8 codes as bytes
        # and keeps a native weight's values (converted to W's type)
        if self.native:
            self.weight = self.bitblas_matmul.transform_weight(
                weight).contiguous()
        else:
            self.qweight = self.bitblas_matmul.transform_weight(weight)
        if scales is not None:
            self.scales = wt.scales_to_device(as_tensor(scales, dev),
                                              wt.scale_dtype(cfg))
        if zeros is not None:
            self.zeros = wt.zeros_to_device(cfg, as_tensor(zeros, dev))
        if bias is not None:
            self.bias = wt.bias_to_device(as_tensor(bias, dev))

    def _repack_gptq(self, gptq_module, v2: bool):
        """graph.repack_gptq_layer into this layer's buffers; returns the
        unpacked ([out, in] int8 codes, [in/g, out] int8 zeros)."""
        cfg = self.bitblas_matmul.config
        bias = getattr(gptq_module, "bias", None)
        if bias is not None and not cfg.with_bias:
            # the forward path adds a bias only when the config has one:
            # storing it here would drop it from every output
            raise ValueError(
                "checkpoint carries a bias but this Linear was built with "
                "bias=False: reconstruct with bias=True")
        packed = repack_gptq_layer(cfg, gptq_module.qweight,
                                   gptq_module.scales, gptq_module.qzeros,
                                   bias, gptq_v2=v2, device=self.device)
        for name, t in packed.items():
            setattr(self, name, t)
        unpack = packing.unpack_qzeros_v2 if v2 else packing.unpack_qzeros
        intzeros = unpack(as_tensor(gptq_module.qzeros, self.device),
                          self.bits)[:, :self.out_features]
        codes = packing.unpack_k(self.qweight, self.bits).to(torch.int8)
        return codes, intzeros

    def repack_from_gptq(self, gptq_module):
        """AutoGPTQ (v1) CudaOldQuantLinear repack: qzeros carry the +1
        quirk. Returns the unpacked ([out, in] int8 codes, [in/g, out] int8
        zeros), so wrappers can mirror them without unpacking again."""
        return self._repack_gptq(gptq_module, v2=False)

    def repack_from_gptq_v2(self, gptq_module):
        """GPTQModel (v2) repack, no off-by-one. Returns (codes, int zeros)
        like repack_from_gptq."""
        return self._repack_gptq(gptq_module, v2=True)

    @property
    def consistent(self) -> bool:
        return self.is_consistent


__all__ = ["Linear", "unpack_qweight", "unpack_qzeros", "unpack_qzeros_v2"]

"""KernelSpec: static description of one dequant-matmul launch
(counterpart of bitblas_tpu/kernels/spec.py, same fields).

On Hopper the device layout needs no N padding (the kernel masks the
ragged N tile): the packed weight is the K-packed ``[N, ceil(K*bits/32)]``
int32 of quantization/packing.py, or for wide int / uint weights the
``[N, K]`` int16 / int32 words. `w_dtype` names the weight format of
(family, bits); nf4's table is quantization/formats.nf4_lut (the kernels
keep its float16 / bfloat16 bits in csrc/decode_formats.cuh).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.matmul_config import MatmulConfig
from ..quantization.formats import (source_format_and_bits, storage_bits,
                                   weight_dtype_name)


@dataclass(frozen=True)
class KernelSpec:
    m: int
    n: int
    k: int
    a_dtype: str
    out_dtype: str
    family: str
    bits: int
    storage_bits: int = 32
    group_size: int = -1
    with_scaling: bool = False
    with_zeros: bool = False
    zeros_mode: str = "original"
    with_bias: bool = False
    fast_decoding: bool = False
    native: bool = False

    @classmethod
    def from_config(cls, config: MatmulConfig, m: int) -> "KernelSpec":
        family, bits = source_format_and_bits(config.W_dtype)
        return cls(
            native=config.is_native_compute(),
            m=m,
            n=config.N,
            k=config.K,
            a_dtype=config.A_dtype,
            out_dtype=config.out_dtype,
            family=family,
            bits=bits,
            storage_bits=storage_bits(config.storage_dtype),
            group_size=config.effective_group_size,
            with_scaling=config.with_scaling,
            with_zeros=config.with_zeros,
            zeros_mode=config.zeros_mode,
            with_bias=config.with_bias,
            fast_decoding=bool(config.fast_decoding),
        )

    @property
    def is_int_activation(self) -> bool:
        return self.a_dtype in ("int8", "uint8", "int4", "uint4")

    @property
    def w_dtype(self) -> str:
        """The weight format's name ("uint4", "nf4", "e4m3_float8", ...)."""
        return self.a_dtype if self.native else weight_dtype_name(
            self.family, self.bits)

    @property
    def elems_per_word(self) -> int:
        return max(1, self.storage_bits // self.bits)

    @property
    def packed_shape(self):
        """Device weight shape: [N, ceil(K*bits/storage_bits)] (K-packed;
        wide weights [N, K] words)."""
        return (self.n, -(-self.k // self.elems_per_word))

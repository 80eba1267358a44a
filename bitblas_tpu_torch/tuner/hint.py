"""TileHint: what a tuning hint fixes for one Matmul launch, and
FlashHint, the tile of one FlashAtten (counterpart of
bitblas_tpu/tuner/hint.py).

A hint names the plan of one M bucket (`decode_mode`):

  "fused"        the dequant-GEMM kernel, decoding the packed weight
                 inside the product (kernels/dequant_matmul.py); the tile
                 (block_m, block_n, block_k, stages) picks one of that
                 kernel's compiled instances;
  "materialize"  the two-pass plan: decode the weight to a dense operand
                 once, then the library product (kernels/materialize.py);
                 no tile (the library owns its tiling);
  "dense"        a native configuration's product (kernels/dense.py);
                 `precision="highest"` holds a float32 product to full
                 float32; the tile is the one kernel 9
                 (`make_dense_matmul_pallas`) would take, and does not
                 change the dense route.

Hints are JSON-serializable: they are what the hint database persists
(cache/__init__.py). The JAX package's TPU decode strategies ("mask",
"telescope", "asplit") and its Mosaic fields (mma_dtype, lut_mode,
group_mode, fp_mode, vmem_limit_bytes) have no Hopper counterpart; those
modes raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields

DECODE_MODES = ("fused", "materialize", "dense")
PRECISIONS = ("default", "highest")


@dataclass(frozen=True)
class TileHint:
    decode_mode: str = "fused"
    block_m: int = 64
    block_n: int = 128
    block_k: int = 128
    stages: int = 3
    precision: str = "default"

    def __post_init__(self):
        if self.decode_mode not in DECODE_MODES:
            raise NotImplementedError(
                f"decode_mode {self.decode_mode!r} is not ported "
                f"(bitblas_tpu_torch runs {DECODE_MODES})")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r} "
                             f"(one of {PRECISIONS})")

    @property
    def tile(self):
        return (self.block_m, self.block_n, self.block_k, self.stages)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TileHint":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def short_name(self) -> str:
        if self.decode_mode == "materialize":
            return "materialize"
        s = (f"{self.decode_mode}_t{self.block_m}x{self.block_n}"
             f"x{self.block_k}")
        if self.decode_mode == "fused":
            s += f"s{self.stages}"
        if self.precision != "default":
            s += f"_{self.precision}"
        return s


# The materialize plan has no tile of its own: one canonical hint.
MATERIALIZE = TileHint("materialize", 0, 0, 0, 0)

@dataclass(frozen=True)
class FlashHint:
    """The tile of kernel 4 (kernels/flash.py flash_attention_fwd): on
    Hopper `block_q` is the q rows a block (64: one consumer warpgroup)
    and `block_kv` the keys a KV tile (64 or 128;
    kernels.flash.prefill_tiles). The JAX hint's Mosaic field `diag_sub`
    (the TPU's diagonal sub-chunking) has no Hopper counterpart and is
    not carried over; the defaults are the port's, not the TPU's."""
    block_q: int = 64
    block_kv: int = 64

    @property
    def tile(self):
        return (self.block_q, self.block_kv)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FlashHint":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def short_name(self) -> str:
        return f"fa{self.block_q}x{self.block_kv}"


# Reflection registry for the hint database (cache/__init__.py stores the
# hint class name in mapping.json, so each operator family round-trips
# its own record type).
HINT_CLASSES = {"TileHint": TileHint, "FlashHint": FlashHint}

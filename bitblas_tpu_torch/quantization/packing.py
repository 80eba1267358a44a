"""Weight packing: the reference checkpoint layout, GPTQ's checkpoint
tensors (AutoGPTQ v1 / GPTQModel v2), the JAX package's TPU layout
(read-only, to carry JAX state across) and the port's own Hopper layout
(counterpart of bitblas_tpu/quantization/packing.py).

The reference and GPTQ functions come in two forms: numpy
(`general_compress`, `general_decompress`) where a host array is the
natural input, and torch ops that run on the tensors' own device
(`compress`, `decompress`, `unpack_qweight`, `unpack_qzeros{,_v2}`,
`pack_autogptq`, `interleave_weight`), so a checkpoint already on the
card is repacked there; each is bit-identical to the JAX function of the
same name.

Hopper device layout (K-packed words)
-------------------------------------
A uint4 weight [N, K] is stored as ``qweight [N, K/8] int32``: word
``[n, j]`` holds the codes of ``(n, k = 8j + i)`` for ``i = 0..7`` at bits
``[4i, 4i + 4)`` (LSB first). Every other width is the same with 32 /
bits codes a word (``pack_k(codes, bits)`` for bits 1, 2, 4 and 8): an
int2 weight is ``[N, K/16] int32``, 16 fields per word at bits ``[2i, 2i
+ 2)``, each the value biased by 2 (``bias_signed_weight``), so byte ``p``
of a word holds k = 4p..4p+3; a uint1 weight ``[N, K/32]``; an 8-bit
weight (int8, e4m3, e5m2) ``[N, K/4]``, one byte a code (int8 as two's
complement, not biased).
Invariants the kernels rely on:

* Packing runs along K, the contraction axis, so a block that owns output
  columns ``[n0, n0 + BN)`` and a K slab ``[k0, k0 + BK)`` reads ``BN``
  rows of ``BK/8`` consecutive words: 16-byte vector loads, neighbouring
  threads on neighbouring addresses. No slot striding along N is needed:
  that TPU layout (``pack_nslot``) exists to keep Mosaic's vector lanes
  aligned, and Hopper has no such constraint.
* Codes ``k`` and ``k + 1`` (``k`` even) sit in one byte, low nibble
  first, so ``(w >> 8i) & 0xF`` and ``(w >> (8i + 4)) & 0xF`` placed in
  the two 16-bit halves of a register and ORed with ``0x64006400`` give
  the f16x2 pair (1024 + q_k, 1024 + q_{k+1}): consecutive k in one
  register, the pair order of an mma.sync B fragment. No XOR-0x80
  storage: the TPU stores it only for its int8-MXU telescope.
* Scales and zeros are ``[K/g, N]`` float16: one row per group, N
  contiguous, so a block's ``BN`` scale reads coalesce.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Reference-compatible K-major packing (checkpoint interchange format)
# ---------------------------------------------------------------------------


def general_compress(unpacked: np.ndarray, bits: int = 4,
                     storage_dtype=np.int8) -> np.ndarray:
    """Pack along the last axis, LSB-first; bit-identical to the
    reference's ``general_compress``."""
    storage_bits = np.dtype(storage_dtype).itemsize * 8
    elems = storage_bits // bits
    if unpacked.dtype == np.float16:
        unpacked = unpacked.astype(np.int8)
    u = unpacked.astype(np.uint32) & ((1 << bits) - 1)
    *lead, last = u.shape
    u = u.reshape(*lead, last // elems, elems)
    shifts = np.arange(elems, dtype=np.uint32) * bits
    packed = (u << shifts).sum(axis=-1, dtype=np.uint32)
    udt = np.dtype(f"uint{storage_bits}")
    return packed.astype(udt).view(storage_dtype)


def general_decompress(packed: np.ndarray, bits: int,
                       out_elems: int | None = None) -> np.ndarray:
    """Inverse of general_compress -> uint8 fields in [0, 2^bits)."""
    storage_bits = packed.dtype.itemsize * 8
    elems = storage_bits // bits
    udt = np.dtype(f"uint{storage_bits}")
    u = packed.view(udt)
    shifts = np.arange(elems, dtype=udt) * bits
    fields = (u[..., None] >> shifts) & ((1 << bits) - 1)
    out = fields.reshape(*packed.shape[:-1], packed.shape[-1] * elems)
    if out_elems is not None:
        out = out[..., :out_elems]
    return out.astype(np.uint8)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.ascontiguousarray(x))


def _wrap32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 of the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def compress(codes: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """`general_compress` as torch ops: fields [..., K] (the low `bits`
    bits kept) -> int8 [..., K*bits/8], packed along the last axis, LSB
    first, on the codes' device."""
    codes = _tensor(codes)
    e = 8 // bits
    *lead, last = codes.shape
    c = (codes.to(torch.int64) & ((1 << bits) - 1)).reshape(
        *lead, last // e, e)
    shifts = torch.arange(e, device=codes.device, dtype=torch.int64) * bits
    return (c << shifts).sum(dim=-1).to(torch.uint8).view(torch.int8)


def decompress(packed: torch.Tensor, bits: int,
               out_elems: int | None = None) -> torch.Tensor:
    """`general_decompress` of int8 storage as torch ops: [..., P] bytes
    (any dtype; its bytes are read, little-endian) -> uint8 fields [...,
    P*8/bits], on the tensor's device."""
    packed = _tensor(packed)
    b = packed.contiguous().view(torch.uint8)
    out = _byte_fields(bits, b.device)[b.to(torch.int64)].reshape(
        *b.shape[:-1], b.shape[-1] * 8 // bits)
    return out if out_elems is None else out[..., :out_elems]


# ---------------------------------------------------------------------------
# GPTQ checkpoint tensors (AutoGPTQ v1 / GPTQModel v2), as torch ops
# ---------------------------------------------------------------------------

def unpack_qweight(qweight: torch.Tensor, bits: int) -> torch.Tensor:
    """GPTQ qweight fields, packed along the last axis of its bytes (an
    [N, K*bits/8] int8 view) -> int8 codes [N, K]."""
    return decompress(qweight, bits).to(torch.int8)


def _unpack_zeros(qzeros: torch.Tensor, bits: int, add: int) -> torch.Tensor:
    z = _tensor(qzeros).contiguous().view(torch.int32).to(torch.int64)
    e = 32 // bits
    shifts = torch.arange(e, device=z.device, dtype=torch.int64) * bits
    fields = ((z[..., None] >> shifts) + add) & ((1 << bits) - 1)
    return fields.reshape(*z.shape[:-1], z.shape[-1] * e).to(torch.int8)


def unpack_qzeros(qzeros: torch.Tensor, bits: int) -> torch.Tensor:
    """AutoGPTQ v1 qzeros [G, N*bits/32] int32 -> int8 zeros [G, N], with
    the v1 quirk: the stored field is z - 1, so the zero is (field + 1) &
    mask."""
    return _unpack_zeros(qzeros, bits, 1)


def unpack_qzeros_v2(qzeros: torch.Tensor, bits: int) -> torch.Tensor:
    """GPTQModel v2 qzeros: the fields as they are, no off-by-one."""
    return _unpack_zeros(qzeros, bits, 0)


def pack_autogptq(intweight_kn: torch.Tensor, zeros_gn: torch.Tensor,
                  scales_gn: torch.Tensor, bits: int = 4, *,
                  v2: bool = False):
    """Inverse of unpack_qweight / unpack_qzeros: natural-layout codes
    [K, N], integer zeros [K/g, N] and scales [K/g, N] -> AutoGPTQ
    CudaOldQuantLinear storage on their device: (qweight int32 [K*bits/32,
    N], qzeros int32 [K/g, N*bits/32] storing z - 1 (v2: z), scales f16
    [K/g, N])."""
    iw, zg = _tensor(intweight_kn), _tensor(zeros_gn)
    e = 32 // bits
    K, N = iw.shape
    if K % e or N % e:
        raise ValueError(f"K={K} and N={N} must be multiples of {e}")
    mask = (1 << bits) - 1
    shifts = torch.arange(e, device=iw.device, dtype=torch.int64) * bits
    w = (iw.to(torch.int64) & mask).reshape(K // e, e, N)
    qweight = _wrap32((w << shifts[None, :, None]).sum(dim=1))
    z = (zg.to(torch.int64) - (0 if v2 else 1)) & mask
    z = z.reshape(z.shape[0], N // e, e)
    qzeros = _wrap32((z << shifts).sum(dim=2))
    return qweight, qzeros, _tensor(scales_gn).to(torch.float16)


def interleave_weight(qweight: torch.Tensor, nbits: int = 4,
                      target_dtype: str = "float16") -> torch.Tensor:
    """The reference's `interleave_weight`: rearranges the fields inside
    each 32-bit word so BitBLAS's LOP3 decode reads contiguous nibbles;
    returns the int8 view. Kept for checkpoint parity; the Hopper kernels
    read the plain K-packed layout instead."""
    if target_dtype not in ("float16", "int8"):
        raise ValueError(f"target_dtype {target_dtype!r}")
    q = _tensor(qweight).contiguous()
    w = q.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    new = torch.zeros_like(w)
    bits_stride = 8 if target_dtype == "int8" else 16
    mask = (1 << nbits) - 1
    num_groups = 32 // bits_stride
    elems_per_group = bits_stride // nbits
    for i in range(num_groups):
        for j in range(elems_per_group):
            offset = i * elems_per_group + j
            shift = (offset % num_groups) * bits_stride \
                + (offset // num_groups) * nbits
            new |= ((w >> (nbits * offset)) & mask) << shift

    def moved(src_mask: int, down: int, up: int) -> torch.Tensor:
        return ((new & src_mask) >> down) << up

    if nbits == 1 and target_dtype == "int8":
        out = (new & 0xF0F00F0F) | moved(0x000000F0, 4, 16) \
            | moved(0x0000F000, 12, 24) | moved(0x000F0000, 16, 4) \
            | moved(0x0F000000, 24, 12)
    elif nbits == 2 and target_dtype == "float16":
        out = (new & 0xFF0000FF) | moved(0x0000FF00, 8, 16) \
            | moved(0x00FF0000, 16, 8)
    elif nbits == 1 and target_dtype == "float16":
        out = (new & 0xF000000F) | moved(0x000000F0, 4, 8) \
            | moved(0x00000F00, 8, 16) | moved(0x0000F000, 12, 24) \
            | moved(0x000F0000, 16, 4) | moved(0x00F00000, 20, 12) \
            | moved(0x0F000000, 24, 20)
    else:
        out = new
    return _wrap32(out & 0xFFFFFFFF).view(torch.int8)


# ---------------------------------------------------------------------------
# The JAX package's TPU layout, read to carry its state across (convert.py)
# ---------------------------------------------------------------------------

PACK_SUB = 128  # output columns per slot segment in the TPU layout


def pack_tile_n(n: int, elems: int) -> int:
    """The TPU layout's canonical N-packing tile (128 columns per slot)."""
    t = PACK_SUB * elems
    if n % t == 0:
        return t
    if n % elems:
        raise ValueError(f"N={n} not divisible by elems={elems}")
    return n


def unpack_nslot(packed: np.ndarray, bits: int, tile_n: int,
                 storage_bits: int = 8) -> np.ndarray:
    """TPU slot-strided N packing [K, N*bits/storage_bits] -> uint8 fields
    [K, N]: within each N tile, word j holds slot i = natural column
    ``i*(tile_n//e) + j``."""
    elems = storage_bits // bits
    K, P = packed.shape
    N = P * elems
    sub = tile_n // elems
    udt = np.dtype(f"uint{storage_bits}")
    u = packed.view(udt).reshape(K, N // tile_n, sub)
    shifts = np.arange(elems, dtype=udt) * bits
    fields = (u[..., None, :] >> shifts[None, None, :, None]) \
        & ((1 << bits) - 1)
    return fields.reshape(K, N).astype(np.uint8)


# ---------------------------------------------------------------------------
# Hopper device layout: K-packed words (see module docstring)
# ---------------------------------------------------------------------------

def bias_signed_weight(weight: torch.Tensor, bits: int) -> torch.Tensor:
    """Clamp+bias a signed low-bit weight into unsigned storage fields
    (the JAX ``bias_signed_weight``, on the weight's device): clamp to
    [-2^(b-1), 2^(b-1)], cast int8, add 2^(b-1). Decode subtracts the same
    bias (numerics.decode_int_field)."""
    maxq = 1 << (bits - 1)
    return torch.clamp(weight, -maxq, maxq).to(torch.int8) + maxq


def pack_k(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes [N, K] (any integer dtype; the low `bits` bits are kept) ->
    [N, ceil(K*bits/32)] int32 K-packed words, LSB first, on the codes'
    device: word ``[n, j]`` holds ``(n, k = e*j + i)`` at bits ``[bits*i,
    bits*(i+1))``, e = 32 / bits; a K off a multiple of e fills the last
    word with zero codes."""
    e = 32 // bits
    N, K = codes.shape
    c = codes.to(torch.int64) & ((1 << bits) - 1)
    if K % e:
        c = torch.nn.functional.pad(c, (0, e - K % e))
    c = c.reshape(N, -1, e)
    shifts = torch.arange(e, device=codes.device, dtype=torch.int64) * bits
    words = (c << shifts).sum(dim=-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def _byte_fields(bits: int, device) -> torch.Tensor:
    """[256, 8/bits] uint8: the fields of every byte value, LSB first."""
    b = torch.arange(256, dtype=torch.int32, device=device)[:, None]
    shifts = torch.arange(8 // bits, dtype=torch.int32, device=device) * bits
    return ((b >> shifts) & ((1 << bits) - 1)).to(torch.uint8)


def unpack_k(qweight: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack_k: [N, K*bits/32] int32 -> uint8 codes [N, K]. Each
    byte of the (little-endian) words is looked up in a 256-entry table."""
    N, P = qweight.shape
    b = qweight.contiguous().view(torch.uint8).to(torch.int32)  # [N, 4P]
    return _byte_fields(bits, qweight.device)[b].reshape(N, P * 32 // bits)


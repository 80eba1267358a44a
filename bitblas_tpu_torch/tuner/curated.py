"""The default tile of kernel 4 (counterpart of
bitblas_tpu/tuner/curated.py's `flash_block_hint`; the JAX file's other
tables are the TPU's measured Matmul winners and are not ported).

`flash_block_hint(seq_len, dim, causal)` is the (block_q, block_kv) a
FlashAtten starts from and `QuantLlama.make_prefill` runs; a tuned entry
of the hint database overrides it for a FlashAtten. The tiles are the
port kernel's (kernels.flash.prefill_tiles): 64 q rows a block, KV tiles
of 64 keys, or of 128 at head dim 64.

The rule is read off chip_smoke.py's flashatten rows (each 16-bit row
times both tiles; NVIDIA H100 80GB HBM3, 700 W; B = 1, H = 32): 128-key
tiles win only at head dim 64 (its 72 KB of shared memory still leave
two blocks an SM), dense at S = 512 and 2048 (0.0151 against 0.0168 ms,
0.1034 against 0.1087) and causal at S = 512 (0.0135 against 0.0142),
not causal at 2048 (0.0633 against 0.0623). At head dims 96 and up a
128-key tile takes a whole SM's shared memory and loses everywhere, 11-
28% (D = 100, causal, S = 2048: 0.1447 against 0.1160 ms), so only head
dim 64 builds them. Every other instance -- the wgmma ones at head dims
80 / 96 / 100 / 128 / 256, the float32 kernel and the general instance
(any other D, odd head counts at D % 8 == 4, K^T with S % 8 != 0) --
takes 64-key tiles, which the hint returns at every other shape: at head
dim 64 too when S % 8 != 0, where a K^T prompt runs the general
instance.
"""

from __future__ import annotations

from typing import Tuple


def flash_block_hint(seq_len: int, dim: int,
                     causal: bool) -> Tuple[int, int]:
    """(block_q, block_kv) of kernel 4 for one shape: a tile of the
    instance that runs it, whatever its head count and K layout."""
    if dim == 64 and seq_len % 8 == 0 and (not causal or seq_len < 2048):
        return 64, 128
    return 64, 64

"""Bitwise operations that need more than an infix operator.

The port's copy of ``pilosa_tpu.ops.bitops``: ``shift``, the plain
PyTorch version of kernel K4 (``kernels.row_shift``). Words are int32
tensors holding the uint32 bit patterns; torch's ``>>`` on int32 is
arithmetic, so the words are widened to int64 and masked to 32 bits,
where every shift is logical.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.shardwidth import WORD_BITS

_LOW32 = 0xFFFFFFFF


def shift(a: torch.Tensor, n: int) -> torch.Tensor:
    """Shift set bits toward higher positions by ``n`` along the last axis
    (reference row.go Shift); negative ``n`` shifts toward lower
    positions. Bits shifted past either end of a row are dropped: no bit
    crosses from one shard's row into the next."""
    n = int(n)
    # floor division and mod: n = 32 * word_shift + bit_shift with
    # bit_shift in [0, 32) for negative n too
    word_shift, bit_shift = n // WORD_BITS, n % WORD_BITS
    n_words = a.shape[-1]
    wide = a.to(torch.int64) & _LOW32
    src = torch.arange(n_words, device=a.device) - word_shift

    def word_at(idx):
        inside = (idx >= 0) & (idx < n_words)
        return torch.where(inside, wide[..., idx.clamp(0, n_words - 1)], 0)

    out = (word_at(src) << bit_shift) & _LOW32
    if bit_shift:
        # the lower neighbour's spill-over; for a negative shift this
        # also brings the top word's bits to word n_words + word_shift
        out |= word_at(src - 1) >> (WORD_BITS - bit_shift)
    return ((out ^ (1 << 31)) - (1 << 31)).to(torch.int32)

"""Host-side bit packing between column-id sets and dense uint32 words.

The port's copy of ``pilosa_tpu.ops.packing``. Bit b of the vector lives
at ``words[b // 32] >> (b % 32) & 1`` (little bit order, matching the
little-endian byte layout so numpy packbits/unpackbits round-trip). Each
function takes the fastbits library (``pilosa_tpu_torch.native``) when
it is active and numpy otherwise, with the same result.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch import native
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


def pack_bits(bit_positions, n_bits: int = SHARD_WIDTH) -> np.ndarray:
    """Pack bit positions into a uint32 word vector."""
    n_words = (n_bits + 31) // 32
    bit_positions = np.asarray(bit_positions, dtype=np.uint64)
    if bit_positions.size == 0:
        return np.zeros(n_words, dtype=np.uint32)
    if bit_positions.max() >= n_bits:
        raise ValueError(
            f"bit position {bit_positions.max()} out of range for {n_bits} bits"
        )
    fast = native.pack_positions(bit_positions, n_words)
    if fast is not None:
        return fast
    bytes_ = np.zeros(n_words * 4, dtype=np.uint8)
    byte_idx = (bit_positions >> np.uint64(3)).astype(np.int64)
    bit_in_byte = (bit_positions & np.uint64(7)).astype(np.uint8)
    np.bitwise_or.at(bytes_, byte_idx, np.uint8(1) << bit_in_byte)
    return bytes_.view("<u4").copy()


def unpack_bits(words: np.ndarray, offset: int = 0) -> np.ndarray:
    """Expand a uint32 word vector to sorted absolute bit positions;
    ``offset`` shifts positions into absolute column space."""
    fast = native.unpack_positions(np.asarray(words), offset)
    if fast is not None:
        return fast
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64) + np.uint64(offset)


def pack_shard_row(column_positions) -> np.ndarray:
    """Pack in-shard column positions into a full shard-row word vector."""
    return pack_bits(column_positions, SHARD_WIDTH)


def popcount_words(words: np.ndarray) -> int:
    """Host popcount."""
    fast = native.popcount_words(np.asarray(words))
    if fast is not None:
        return fast
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return int(np.bitwise_count(words).sum(dtype=np.int64))

"""Shard-width constants (reference: shardwidth/shardwidth.go, SURVEY.md §2 #27).

The column axis is partitioned into shards of 2^20 columns. On device a
shard-row is a dense bit-vector packed into 32-bit words: 2^20 bits =
32768 uint32 words = 128 KiB. 32768 is a multiple of the TPU lane count
(128), so a row tiles cleanly onto the VPU; uint32 is the native vector
lane width.
"""

SHARD_WIDTH_EXP = 20
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP  # columns per shard (reference: ShardWidth)

WORD_BITS = 32
WORDS_PER_SHARD = SHARD_WIDTH // WORD_BITS  # 32768 uint32 words per row


def shard_of(column_id: int) -> int:
    """Shard that owns an absolute column id (reference: col / ShardWidth)."""
    return column_id >> SHARD_WIDTH_EXP


def position(column_id: int) -> int:
    """Column position within its shard."""
    return column_id & (SHARD_WIDTH - 1)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1). Shared padding/bucketing rule for
    compiled-shape axes (shard blocks, GroupBy chunks, compressed blocks)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def shard_groups(columns):
    """Group absolute column ids by shard for bulk writes.

    Returns (order, bounds, shards_sorted): ``order`` is the stable
    argsort of the shard of each column; ``bounds[i]:bounds[i+1]`` slices
    ``order``-permuted arrays to the rows of shard ``shards_sorted[bounds
    [i]]``. One implementation of the argsort/diff boundary walk shared
    by every import path (api.import_bits, Index.mark_columns_exist).
    """
    import numpy as np

    cols = np.asarray(columns, np.uint64)
    shards = (cols >> np.uint64(SHARD_WIDTH_EXP)).astype(np.int64)
    order = np.argsort(shards, kind="stable")
    shards_sorted = shards[order]
    bounds = np.concatenate(
        ([0], np.nonzero(np.diff(shards_sorted))[0] + 1, [cols.size])
    )
    return order, bounds, shards_sorted


def keep_last_unique(keys):
    """Sorted indices selecting the LAST occurrence of each unique key —
    the sequential last-write-wins semantics batched writes must match
    (np.unique keeps the FIRST, so dedupe the reversed array and map the
    indices back). Shared by Field.import_values and
    Fragment.import_mutex."""
    import numpy as np

    keys = np.asarray(keys)
    _, first_in_rev = np.unique(keys[::-1], return_index=True)
    return np.sort(keys.size - 1 - first_in_rev)

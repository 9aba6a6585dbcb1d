"""Batched membership probes over a roaring bitmap.

The port's copy of the part of ``pilosa_tpu.roaring.merge_kernels`` that
its writes use: the mutex import's probe of which rows hold each column
of a batch.
"""

from __future__ import annotations

import numpy as np

_EMPTY_I64 = np.empty(0, np.int64)


def set_rows_for_positions(bm, positions) -> tuple[np.ndarray, np.ndarray]:
    """Every (row, position index) pair set in ``bm`` among a batch of
    in-shard positions, as ``(rows, pos_idx)`` int64 arrays. Each
    existing container is visited once and probed only with the batch
    positions that fall in its 65536-bit slot of the row."""
    pos = np.asarray(positions, np.uint64)
    keys = list(bm.keys)
    if pos.size == 0 or not keys:
        return _EMPTY_I64, _EMPTY_I64
    slots = (pos >> np.uint64(16)).astype(np.int64)  # 0..15 within a row
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    lows = (pos & np.uint64(0xFFFF)).astype(np.uint16)
    hit_rows: list = []
    hit_idx: list = []
    for key in keys:
        lo = int(np.searchsorted(sorted_slots, key & 15, side="left"))
        hi = int(np.searchsorted(sorted_slots, key & 15, side="right"))
        c = bm.container(key)
        if lo == hi or c is None:
            continue
        sel = order[lo:hi]
        m = c.contains_lows(lows[sel])
        if m.any():
            found = sel[m]
            hit_idx.append(found)
            hit_rows.append(np.full(found.size, key >> 4, np.int64))
    if not hit_idx:
        return _EMPTY_I64, _EMPTY_I64
    return (np.concatenate(hit_rows),
            np.concatenate(hit_idx).astype(np.int64))

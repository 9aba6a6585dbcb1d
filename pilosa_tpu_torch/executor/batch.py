"""Batched shard evaluation: one kernel launch, one readback per query.

The port's copy of ``pilosa_tpu.executor.batch`` for the slice's two
reduce kinds. A query's leaves are stacked ``int32[S_padded, 32768]``
tensors (one slot per shard, the shard count padded to a power of two
with zero slots, as in the reference, so packed results compare equal),
built once per (query leaf, shard set) and kept resident by the holder's
``DeviceRowCache``. Writes patch resident leaves in place (K3) instead of
evicting them.

Reduce kinds and their packed results (int32):
  'count' → [2]: split-sum scalar; the micro-batched form is [B, 2]
  'row'   → [S_padded, words] (the only multi-row readback)

Split sums: partial popcounts are int32 and a per-shard popcount can
reach 2^20, so every cross-row sum is carried in two int32 channels — lo
15 bits and hi bits of each partial summed separately — and recombined
on the host as ``hi·2^15 + lo``.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import expr
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD, next_pow2
from pilosa_tpu_torch.storage.residency import upload

SPLIT_SHIFT = 15
SPLIT_MASK = (1 << SPLIT_SHIFT) - 1

# Row width of the count reduction: per-row partials of 2^18 words stay
# <= 2^23 and fit int32. Divides every stacked block of 8+ slots
# (S_padded·2^15 words, S_padded a power of two); smaller blocks reduce
# as one row.
COUNT_CHUNK_WORDS = 1 << 18


def split_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum int32 partials over the last axis in two overflow-safe int32
    channels: [..., n] → [..., 2] (lo-bit sums, hi-bit sums)."""
    lo = (x & SPLIT_MASK).sum(dim=-1, dtype=torch.int32)
    hi = (x >> SPLIT_SHIFT).sum(dim=-1, dtype=torch.int32)
    return torch.stack([lo, hi], dim=-1)


def merge_split(packed: np.ndarray) -> np.ndarray:
    """Host-side recombination of split sums [2, ...] → int64 [...]."""
    packed = np.asarray(packed, np.int64)
    return (packed[1] << SPLIT_SHIFT) + packed[0]


class ShardBlock:
    """Orders a query's shard list as the leading axis of stacked leaves;
    the slot count pads to the next power of two."""

    def __init__(self, shards: list[int]):
        self.shards = sorted(shards)
        self.padded = next_pow2(max(len(self.shards), 1))
        self._key = ("blk", tuple(self.shards), self.padded)

    def key(self) -> tuple:
        return self._key

    def stack(self, per_shard_fn, inner: tuple) -> np.ndarray:
        """The [padded, *inner] host array: per_shard_fn(shard) → row
        block; padding slots are zeros."""
        out = np.zeros((self.padded,) + tuple(inner), np.uint32)
        for i, s in enumerate(self.shards):
            out[i] = per_shard_fn(s)
        return out


def host_row(idx, spec, shard: int) -> np.ndarray:
    """Dense uint32[words] for a _RowSpec leaf on one shard (host side)."""
    field = idx.field(spec.field)
    acc = None
    for vname in spec.views:
        view = field.view(vname) if field else None
        frag = view.fragment(shard) if view else None
        if frag is None:
            continue
        words = frag.row_words(spec.row)
        acc = words if acc is None else np.bitwise_or(acc, words)
    return acc if acc is not None else np.zeros(WORDS_PER_SHARD, np.uint32)


# ------------------------------------------------------ cached stacked leaves


def _word_masks(positions) -> tuple[np.ndarray, np.ndarray]:
    """In-shard positions → (unique word indices int32, OR-combined masks
    uint32). Unpadded: the patch kernel takes the real pair count."""
    positions = np.asarray(positions, np.uint32)
    words = (positions >> 5).astype(np.int32)
    bits = np.uint32(1) << (positions & np.uint32(31))
    uw = np.unique(words)
    masks = np.zeros(uw.size, np.uint32)
    np.bitwise_or.at(masks, np.searchsorted(uw, words), bits)
    return uw, masks


def _make_probe(block: ShardBlock, match, decode_row, delta_on_clear: bool):
    """Write-routing probe for a stacked leaf: None when the event does
    not touch the leaf, else ``apply(arr)`` patching the shard's slot in
    place — the exact word delta (K3) when the event carries positions,
    a fresh host decode of the row otherwise. ``delta_on_clear``: clears
    may delta-patch (single-view leaves only: with several OR'd views a
    cleared bit may survive in another view)."""
    slot_of = {s: i for i, s in enumerate(block.shards)}

    def probe(ev):
        slot = slot_of.get(ev.shard)
        if slot is None or not match(ev):
            return None
        if ev.positions is not None and (
                ev.added or (ev.added is False and delta_on_clear)):
            word_idx, masks = _word_masks(ev.positions)
            clear = not ev.added
            return lambda arr: kernels.word_patch(arr, slot, word_idx, masks,
                                                  word_idx.size, clear)

        def set_row(arr):
            arr[slot].copy_(upload(decode_row(ev), arr.device))

        return set_row

    return probe


def leaf_key(idx, spec, block: ShardBlock) -> tuple:
    """Residency key of a compiled spec's stacked leaf."""
    from pilosa_tpu_torch.executor.executor import (
        PQLError,
        _RowSpec,
        _ZeroSpec,
    )

    if isinstance(spec, _RowSpec):
        return ("stack", idx.scope, idx.name, spec.field, spec.views,
                spec.row, block.key())
    if isinstance(spec, _ZeroSpec):
        return ("stackz", block.key())
    raise PQLError(f"unknown leaf spec {type(spec).__name__}")


def stacked_leaf(idx, spec, block: ShardBlock, cache) -> torch.Tensor:
    """Device-resident stacked leaf for a compiled spec, via ``cache``."""
    from pilosa_tpu_torch.executor.executor import PQLError, _RowSpec, _ZeroSpec

    key = leaf_key(idx, spec, block)
    if isinstance(spec, _ZeroSpec):
        return cache.get_row(
            key, lambda: np.zeros((block.padded, WORDS_PER_SHARD), np.uint32))
    if not isinstance(spec, _RowSpec):
        raise PQLError(f"unknown leaf spec {type(spec).__name__}")

    def decode():
        return block.stack(lambda shard: host_row(idx, spec, shard),
                           inner=(WORDS_PER_SHARD,))

    def probe():
        views = frozenset(spec.views)
        return _make_probe(
            block,
            match=lambda ev: ev.row == spec.row and ev.view in views,
            decode_row=lambda ev: host_row(idx, spec, ev.shard),
            delta_on_clear=len(spec.views) == 1,
        )

    return cache.get_or_build(key, (idx.scope, idx.name, spec.field),
                              probe, decode)


# ------------------------------------------------------------------ programs


def count_elementwise_sub(structure, leaf_ranks: tuple):
    """For a ('count', sub) structure whose tree is purely elementwise over
    rank-1 word leaves (and/or/xor/diff/leaf/const0), return ``sub``;
    else None. Bit position never matters to such a count, so the whole
    stacked block reduces as one flat array in wide rows."""
    if not structure or structure[0] != "count":
        return None
    if any(r != 1 for r in leaf_ranks):
        return None

    def ok(n):
        if n[0] in ("leaf", "const0"):
            return True
        if n[0] in ("and", "or", "xor", "diff"):
            return all(ok(c) for c in n[1:])
        return False

    return structure[1] if ok(structure[1]) else None


def count_flat_batched(program, batch_leaves) -> torch.Tensor:
    """K1 over a micro-batch: each query's count program over its stacked
    leaves, popcounts reduced in COUNT_CHUNK_WORDS-wide rows, split-summed
    on the device → int32[B, 2]. One kernel launch for the batch."""
    n_words = batch_leaves[0][0].numel()
    row_words = min(COUNT_CHUNK_WORDS, n_words)
    partials = kernels.tree_count(program, batch_leaves,
                                  [0] * len(batch_leaves), row_words)
    return split_sum(partials)


def count_flat(program, leaves) -> torch.Tensor:
    """Single-query form of count_flat_batched → int32[2]."""
    return count_flat_batched(program, [leaves])[0]


def _check_kind(structure, reduce_kind: str, leaf_ranks: tuple) -> tuple:
    if reduce_kind == "count":
        if count_elementwise_sub(structure, leaf_ranks) is None:
            raise ValueError(f"count of {structure!r} is not ported yet")
    elif reduce_kind == "row":
        if any(r != 1 for r in leaf_ranks):
            raise ValueError("row results take rank-1 word leaves")
    else:
        raise ValueError(f"reduce kind {reduce_kind!r} is not ported yet")
    return expr.compile_program(structure)


def local_fn(structure, reduce_kind: str, leaf_ranks: tuple):
    """The single-query evaluator for a query shape, called as
    ``fn(*leaves)`` with stacked leaves: 'count' → int32[2] split sums
    (K1), 'row' → int32[S_padded, words] (K2). The reference's
    ``local_fn`` contract without scalar operands (no shift yet)."""
    program = _check_kind(structure, reduce_kind, leaf_ranks)
    if reduce_kind == "count":
        return lambda *leaves: count_flat(program, list(leaves))
    return lambda *leaves: kernels.tree_rows(program, list(leaves))


def local_fn_batched(structure, reduce_kind: str, leaf_ranks: tuple,
                     n_queries: int):
    """ONE launch evaluating ``n_queries`` same-shape count queries (the
    micro-batch): args are the queries' leaves back to back; returns
    int32[n_queries, 2]."""
    if reduce_kind != "count":
        raise ValueError("only count queries are micro-batched")
    program = _check_kind(structure, reduce_kind, leaf_ranks)
    n_leaves = len(leaf_ranks)

    def fn(*args):
        batch = [list(args[i * n_leaves:(i + 1) * n_leaves])
                 for i in range(n_queries)]
        return count_flat_batched(program, batch)

    return fn

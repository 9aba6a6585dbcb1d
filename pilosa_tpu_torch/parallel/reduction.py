"""Compressed/quantized reduction lanes + the cross-member wire-byte model.

The port's copy of ``pilosa_tpu.parallel.reduction``. The inter-group
hop of a hierarchical mesh (``parallel/mesh.py``'s ``groups x shards``
form) carries per-group partials. A partial's range is bounded
statically (each per-shard summand is at most SHARD_WIDTH), so a lane
is cast to uint8/uint16 where the bound proves it lossless and summed
exactly on the receiver; int32 otherwise. TopN's and GroupBy's
candidate-ranking lanes may instead cross as 8-bit max-scaled mantissas
with a transmitted error bound (``hier_quantized_counts``), which the
executor widens its window by before an exact recount, so results stay
byte-identical (the ``topn-quantized-ranking`` knob). A materialized Row
crosses as roaring containers in block frames (``encode_row_frames``),
and the result is decoded from them.

Device side, each a hand-written kernel with a plain version beside it
(``kernels.py``): K12+K13 ``lane_reduce`` is a lossless or extremum
reduce whole, in one launch that reads the members' partials where
their kernels wrote them (the intra-group sum or best, the cast to the
narrow lane and the receivers' fold, the lanes kept in registers; on
the flat mesh the sum or best over the members), and K14+K15
``quant_reduce`` the 8-bit lane's reduce whole in the same way (the
intra-group sum, each group's encode and the receivers' decode, or on
the flat mesh the exact sum with zero bounds). On one card the gather
between groups is a register's cast or encode; between cards it would
be a peer copy (``Tensor.copy_``), which a one-card machine cannot run.
The host side (the lane widths, the byte model, the quantized lane's
decode and window, the row frames, the counters) is the reference's.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

SPLIT_SHIFT = kernels.SPLIT_SHIFT  # executor/batch.py's
SPLIT_MASK = kernels.SPLIT_MASK
# per-shard summand ceiling: split channels are bounded per slot by
# SPLIT_MASK (lo) and SHARD_WIDTH >> SPLIT_SHIFT (hi)
HI_PER_SLOT = SHARD_WIDTH >> SPLIT_SHIFT

# Candidates per max-scale block of the quantized ranking lane: one int32
# scale and one error-bound lane amortize over QUANT_BLOCK uint8
# mantissas. A group total rides one int32, exact while it stays < 2^31.
QUANT_BLOCK = kernels.QUANT_BLOCK


def lane_dtype_bytes(bound: int) -> int:
    """Width of the narrowest integer lane proven lossless for values in
    [0, bound]. int32 is the exact fallback."""
    if bound <= 0xFF:
        return 1
    if bound <= 0xFFFF:
        return 2
    return 4


def lane_dtype(bound: int) -> torch.dtype:
    return kernels.LANE_DTYPES[lane_dtype_bytes(bound)]


def split_channel_bounds(group_slots: int) -> tuple[int, int]:
    """Static (lo, hi) channel bounds for a per-group split-sum partial
    over ``group_slots`` shard slots."""
    return group_slots * SPLIT_MASK, group_slots * HI_PER_SLOT


def quant_blocks(n_rows: int) -> int:
    """Number of QUANT_BLOCK-sized scale blocks covering ``n_rows``
    candidate lanes."""
    return max(1, -(-n_rows // QUANT_BLOCK))


def quant_total_elems(n_rows: int) -> int:
    """Lanes in a quantized packed result: the approx counts plus one
    error-bound lane per scale block."""
    return n_rows + quant_blocks(n_rows)


def quant_real_elems(total: int) -> int:
    """Inverse of quant_total_elems (host accounting sees only the packed
    shape)."""
    n = max(1, total - quant_blocks(total))
    while quant_total_elems(n) < total:
        n += 1
    return n


def quant_payload_bytes(n_rows: int) -> int:
    """Encoded bytes ONE group contributes to the quantized inter-group
    hop: a uint8 mantissa per candidate + an int32 scale per block."""
    return n_rows * 1 + quant_blocks(n_rows) * 4


# ---------------------------------------------------------- device lanes
#
# The contract with the flat path is bit-identical packed results:
# integer adds are exact and associative, so the intra-group sum plus the
# narrow lane's fold equals the flat sum channel for channel, and the
# narrow cast is a no-op on the values the static bound covers. Each
# function takes the members' partials as ``kernels.lane_reduce`` does: a
# list of member tensors, read in place, or one tensor stacked on a
# leading member axis (member g·S + s of the mesh at row g·S + s).


def flat_split_sum(parts) -> torch.Tensor:
    """The flat mesh's reduce of split-sum partials (each member's
    int32[2, N]): one exact int32 sum over the members (K12+K13 with one
    group and int32 lanes)."""
    return kernels.lane_reduce(parts, 1, (4, 4))


def hier_split_channels(parts, groups: int, group_slots: int
                        ) -> torch.Tensor:
    """A 2-D mesh's reduce of split-sum partials (each member's
    int32[2, N]): each group's exact sum cast per channel to its
    narrowest lossless lane, then every receiver's int32 fold of the G
    lanes → int32[2, N], one K12+K13 launch."""
    lo_b, hi_b = split_channel_bounds(group_slots)
    return kernels.lane_reduce(parts, groups, (lane_dtype_bytes(lo_b),
                                               lane_dtype_bytes(hi_b)))


def gather_extreme(parts, groups: int | None, want_max: bool,
                   bound=None) -> torch.Tensor:
    """The reduce of extremum partials (each member's [N] or 0-d, int32
    or int64): on a 2-D mesh each group's best (narrowed when ``bound``
    proves it lossless), then the fold of the G lanes; on the flat mesh
    (``groups`` None) the best over the members alone. One K12+K13
    launch; returns [N]."""
    width = (parts if isinstance(parts, torch.Tensor)
             else parts[0]).element_size()
    if groups is not None and bound is not None:
        width = lane_dtype_bytes(bound)
    return kernels.lane_reduce(parts, groups or 1, width,
                               "max" if want_max else "min")


def hier_quantized_counts(parts, groups: int | None) -> torch.Tensor:
    """The candidate-ranking lane for split-sum partials (each member's
    int32[2, R], or int32[M, 2, R]).

    Per QUANT_BLOCK of candidates each group's totals are max-scaled to 8
    bits, ``s = max(1, ceil(max/255))`` and ``q = (v + s//2) // s`` in
    int32 arithmetic; the receivers decode ``approx = Σ q·s`` and the
    per-block error bound ``Σ (s+1)//2`` over the groups with s > 1. A
    group's error is at most (s+1)//2, exactly 0 where s == 1 (max <= 255
    quantizes losslessly), so the bound crossing with the data covers the
    decoded total. One K14+K15 launch.

    Returns split-form ``[2, R + n_blocks]``: approx counts followed by
    per-block error bounds (``batch.merge_split`` then
    ``split_quantized``). ``groups`` None (the flat mesh) is the
    lossless pass-through: the exact sum, bounds 0."""
    return kernels.quant_reduce(parts, groups)


def split_quantized(merged: np.ndarray, n_rows: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Host decode of one merged quantized section ``[R + n_blocks]``
    (after batch.merge_split): (approx counts [R], per-candidate error
    bound [R] — each candidate inherits its scale block's bound)."""
    nb = quant_blocks(n_rows)
    approx = np.asarray(merged[:n_rows], np.int64)
    err_blocks = np.asarray(merged[n_rows:n_rows + nb], np.int64)
    err = np.repeat(err_blocks, QUANT_BLOCK)[:n_rows]
    return approx, err


def quant_topn_window(approx: np.ndarray, err: np.ndarray, n: int
                      ) -> np.ndarray:
    """Indices of every candidate that could still be in the exact top
    ``n`` given approx counts with per-candidate error bound ``err``
    (true count in [approx-err, approx+err]).

    Rule: admit j unless n candidates have a LOWER bound strictly above
    j's UPPER bound — those n have provably greater exact counts, so j's
    exact rank exceeds n under any tie-break. The window is therefore a
    superset of the exact top n."""
    m = len(approx)
    if n <= 0 or m <= n:
        return np.arange(m)
    lo = approx - err
    hi = approx + err
    cut = np.partition(lo, m - n)[m - n]  # n-th largest lower bound
    return np.nonzero(hi >= cut)[0]


# ------------------------------------------------------ host byte model


def inter_group_payload_bytes(reduce_kind: str, out_elems: int,
                              group_slots: int) -> int:
    """Encoded bytes ONE group contributes to the inter-group hop, for a
    packed result of ``out_elems`` int32 lanes (batched dispatches pass
    the batch-multiplied element count)."""
    lo_b, hi_b = split_channel_bounds(group_slots)
    lo_w, hi_w = lane_dtype_bytes(lo_b), lane_dtype_bytes(hi_b)
    if reduce_kind in ("min", "max"):
        # [best, count_lo, count_hi] per query -> best int32 + any_valid
        # uint8 + narrowed count channels
        return (out_elems // 3) * (4 + 1 + lo_w + hi_w)
    # every other packed kind is pairs of split channels
    return (out_elems // 2) * (lo_w + hi_w)


def dense_reduce_bytes(n_devices: int, out_elems: int) -> int:
    """Flat-path equivalent: ring all-reduce of the int32 packed lanes
    over the whole mesh."""
    return 2 * (n_devices - 1) * out_elems * 4


def hier_reduce_bytes(reduce_kind: str, out_elems: int, groups: int,
                      shards_per_group: int, group_slots: int
                      ) -> tuple[int, int]:
    """(inter_group_bytes, intra_group_bytes) for one hierarchical
    dispatch: narrow ring all-gather across the G group leads, dense
    int32 ring all-reduce inside each group."""
    inter = groups * (groups - 1) * inter_group_payload_bytes(
        reduce_kind, out_elems, group_slots
    )
    intra = groups * 2 * max(shards_per_group - 1, 0) * out_elems * 4
    return inter, intra


def quant_hier_bytes(n_rows: int, groups: int, shards_per_group: int,
                     group_slots: int) -> tuple[int, int, int]:
    """(inter, intra, lossless_inter) for one QUANTIZED ranking dispatch
    of ``n_rows`` candidate lanes: the 8-bit scaled inter-group hop, the
    unchanged dense intra-group all-reduce of the [2, R] split channels,
    and what the same hop would have cost on the lossless countrows
    lane."""
    inter = groups * (groups - 1) * quant_payload_bytes(n_rows)
    intra = groups * 2 * max(shards_per_group - 1, 0) * 2 * n_rows * 4
    lossless = groups * (groups - 1) * inter_group_payload_bytes(
        "countrows", 2 * n_rows, group_slots
    )
    return inter, intra, lossless


# -------------------------------------------------- row-gather wire sim


def _bitmap_of_words(words: np.ndarray):
    """A roaring bitmap of one dense row (bit i → id i), its containers
    chosen as the reference's ``RoaringBitmap.from_dense_words`` does."""
    from pilosa_tpu_torch.roaring.bitmap import Container, RoaringBitmap

    bits = np.unpackbits(np.ascontiguousarray(words, np.uint32).view(np.uint8),
                         bitorder="little")
    ids = np.nonzero(bits)[0]
    b = RoaringBitmap()
    keys = ids >> 16
    cuts = np.concatenate(([0], np.nonzero(np.diff(keys))[0] + 1,
                           [ids.size]))
    for i in range(cuts.size - 1):
        lo, hi = int(cuts[i]), int(cuts[i + 1])
        b._containers[int(keys[lo])] = Container.from_lows(
            (ids[lo:hi] & 0xFFFF).astype(np.uint16))
    b.keys = sorted(b._containers)
    return b


def encode_row_frames(host: np.ndarray) -> tuple[list[bytes], int]:
    """Serialize a [slots, WORDS_PER_SHARD] dense row readback as
    per-slot roaring payloads, framed as the repair plane's block frames
    are (a 4-byte length, then the payload). Empty slots frame as b"".
    Returns (frames, framed_bytes)."""
    from pilosa_tpu_torch.roaring import format as rformat

    payloads = []
    for slot in range(host.shape[0]):
        words = host[slot]
        if words.any():
            payloads.append(rformat.serialize(_bitmap_of_words(words)))
        else:
            payloads.append(b"")
    return payloads, sum(4 + len(p) for p in payloads)


def decode_row_frames(payloads: list[bytes], shape: tuple) -> np.ndarray:
    """Inverse of encode_row_frames: rebuild the dense [slots, words]
    uint32 array. This IS the result path on a hierarchical mesh, so a
    codec fault is a visible wrong answer."""
    from pilosa_tpu_torch.roaring import format as rformat

    out = np.zeros(shape, np.uint32)
    for slot, payload in enumerate(payloads):
        if not payload:
            continue
        bm, _ = rformat.deserialize(payload)
        out[slot] = bm.dense_range_words32(0, WORDS_PER_SHARD * 32)
    return out


# ------------------------------------------------------ global counters


class ReduceStats:
    """Process-wide dist_reduce_* counters (served on /metrics and
    /debug/vars)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.dispatches = 0
            self.hier_dispatches = 0
            self.dense_bytes = 0
            self.actual_bytes = 0
            self.intra_bytes = 0
            self.row_gathers = 0
            self.row_dense_bytes = 0
            self.row_actual_bytes = 0
            self.quant_dispatches = 0
            self.quant_actual_bytes = 0
            self.quant_lossless_bytes = 0
            self.quant_window_rows = 0
            self.quant_candidate_rows = 0

    def note_reduce(self, dense: int, actual: int, intra: int,
                    hier: bool) -> None:
        with self._lock:
            self.dispatches += 1
            self.hier_dispatches += 1 if hier else 0
            self.dense_bytes += dense
            self.actual_bytes += actual
            self.intra_bytes += intra

    def note_quant_reduce(self, actual: int, lossless: int) -> None:
        """One quantized ranking dispatch: the encoded hop bytes against
        what the lossless lane would have moved for the same candidates
        (beside note_reduce, which counts the hop as actual bytes)."""
        with self._lock:
            self.quant_dispatches += 1
            self.quant_actual_bytes += actual
            self.quant_lossless_bytes += lossless

    def note_quant_window(self, window_rows: int, candidate_rows: int
                          ) -> None:
        """One TopN window selection: candidates surviving into the
        exact recount against the full ranked set."""
        with self._lock:
            self.quant_window_rows += window_rows
            self.quant_candidate_rows += candidate_rows

    def note_row_gather(self, dense: int, actual: int) -> None:
        with self._lock:
            self.row_gathers += 1
            self.row_dense_bytes += dense
            self.row_actual_bytes += actual

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "hier_dispatches": self.hier_dispatches,
                "dense_bytes": self.dense_bytes,
                "actual_bytes": self.actual_bytes,
                "intra_bytes": self.intra_bytes,
                "row_gathers": self.row_gathers,
                "row_dense_bytes": self.row_dense_bytes,
                "row_actual_bytes": self.row_actual_bytes,
                "quantized_dispatches": self.quant_dispatches,
                "quantized_actual_bytes": self.quant_actual_bytes,
                "quantized_lossless_bytes": self.quant_lossless_bytes,
                "quantized_window_rows": self.quant_window_rows,
                "quantized_candidate_rows": self.quant_candidate_rows,
            }


_STATS = ReduceStats()


def global_reduce_stats() -> ReduceStats:
    return _STATS

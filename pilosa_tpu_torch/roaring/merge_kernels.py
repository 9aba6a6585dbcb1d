"""Whole-batch roaring merge kernels (the write path), the port's copy of
``pilosa_tpu.roaring.merge_kernels``.

``merge_ids`` merges a sorted id batch into every container it touches
with a fixed number of numpy calls, where ``RoaringBitmap._merge_loop``
pays a union and a ``from_lows`` rebuild a container:

- **word space**: every touched BITMAP container (and each ARRAY
  container the loop would promote) stacks into one (n, 8192)-byte
  matrix; the batch ORs (or AND-NOTs) in with one scatter, and the
  cardinalities come from one popcount;
- **sorted-id space**: every other touched container's payload gathers
  into one sorted stream (arrays as slices, runs expanded in one pass)
  that merges with the batch once;
- **container choice**: the array / run / bitmap choice of every rebuilt
  container is made in one pass over the segments' cardinalities and
  run counts (``Container.from_lows``' cost model), then built from
  slices (``_canonical_into``).

Container choice is part of the bytes on disk, so the result is
byte-identical to ``_merge_loop``'s, its non-canonical edges included: a
bitmap stays a bitmap above ARRAY_MAX where runs would be smaller, a
container left unchanged is kept as the same object, and the ARRAY
promotion is measured against the deduplicated batch.

Also here, the batched membership probes of the imports:
``set_rows_for_positions`` (the mutex import: which rows hold each
column) and ``member_matrix`` (the BSI import: the exists row and every
bit plane in one call). ``MergeStats`` counts the calls (the
``ingest_merge_*`` series of ``/metrics``).
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import (
    ARRAY,
    ARRAY_MAX,
    BITMAP,
    BITMAP_N_WORDS,
    RUN,
    Container,
)

_LOW = np.uint64(0xFFFF)
_U16 = np.uint64(16)
_C_BYTES = BITMAP_N_WORDS * 8  # 8192 bytes per container bitmap

_EMPTY_I64 = np.empty(0, np.int64)
_EMPTY_I64.setflags(write=False)

# Below this batch size the per-container loop is the cheaper path (a
# point write touches one container; the kernel's segmenting and stacked
# gathers cost more than the loop's few calls). Both build the same
# bytes, so the value is tuning only; the reference's.
KERNEL_MIN_IDS = 64


class MergeStats:
    """Process-wide write-kernel counters (``ingest_merge_*``). Plain
    int adds, no lock: they feed dashboards, not correctness."""

    __slots__ = ("kernel_calls", "ids_merged", "containers_merged",
                 "word_space_merges", "stream_merges", "canonical_builds",
                 "loop_fallbacks", "probe_calls")

    def __init__(self):
        self.kernel_calls = 0       # whole-batch merge calls
        self.ids_merged = 0         # deduplicated ids through the kernel
        self.containers_merged = 0  # touched containers, all calls
        self.word_space_merges = 0  # containers merged as bitmap OR/ANDNOT
        self.stream_merges = 0      # containers merged in sorted-id space
        self.canonical_builds = 0   # containers rebuilt by the choice pass
        self.loop_fallbacks = 0     # small batches through _merge_loop
        self.probe_calls = 0        # batched mutex / BSI membership probes

    def metrics(self) -> dict:
        return {
            "ingest_merge_kernel_calls_total": self.kernel_calls,
            "ingest_merge_ids_total": self.ids_merged,
            "ingest_merge_containers_total": self.containers_merged,
            "ingest_merge_word_space_total": self.word_space_merges,
            "ingest_merge_stream_total": self.stream_merges,
            "ingest_merge_canonical_builds_total": self.canonical_builds,
            "ingest_merge_loop_fallbacks_total": self.loop_fallbacks,
            "ingest_merge_probe_calls_total": self.probe_calls,
        }


_STATS = MergeStats()


def global_merge_stats() -> MergeStats:
    return _STATS


# ------------------------------------------------------------ the kernel


def merge_ids(bm, ids: np.ndarray, remove: bool = False) -> int:
    """Merge a whole id batch into ``bm``'s containers; returns #bits
    changed. Byte-identical to ``RoaringBitmap._merge_loop`` on the same
    input (op-log replay, WAL recovery and the imports all route
    through one of the two).

    ``ids`` may be unsorted/duplicated; it is deduped exactly like the
    loop's. The caller holds whatever lock it held for the loop path
    — container installs remain one-at-a-time atomic dict swaps, so
    lock-free readers keep seeing self-consistent containers."""
    ids = np.atleast_1d(np.asarray(ids, dtype=np.uint64))
    if ids.size == 0:
        return 0
    if ids.size > 1:
        if not bool(np.all(ids[1:] >= ids[:-1])):
            ids = np.sort(ids)
        ids = ids[np.concatenate(([True], ids[1:] != ids[:-1]))]

    his = (ids >> _U16).astype(np.int64)
    bounds = np.concatenate(([0], np.nonzero(np.diff(his))[0] + 1,
                             [ids.size]))
    seg_keys = his[bounds[:-1]]
    seg_sizes = np.diff(bounds)
    nseg = int(seg_keys.size)

    _STATS.kernel_calls += 1
    _STATS.ids_merged += int(ids.size)
    _STATS.containers_merged += nseg

    # the metadata gather: container refs + (kind, n) arrays
    conts = [bm._containers.get(int(k)) for k in seg_keys.tolist()]
    kinds = np.fromiter((0 if c is None else c.kind for c in conts),
                        np.int64, nseg)
    # word-space delta accounting uses the maintained cardinality (the
    # loop compares against c.n); stream-space uses actual payload
    # sizes (the loop compares against materialized lows)
    ns_attr = np.fromiter((0 if c is None else c.n for c in conts),
                          np.int64, nseg)

    # the loop's promote rule measures c.n against the PRE-dedup
    # segment size — here segments are already deduped, which is the
    # same value (dedup happens before the loop there too)
    word_like = kinds == BITMAP
    if not remove:
        word_like |= (kinds == ARRAY) & (ns_attr + seg_sizes > ARRAY_MAX)

    installs: dict[int, Container | None] = {}  # None = pop
    changed = 0

    # element -> segment row map, shared by both groups
    seg_of = np.repeat(np.arange(nseg), seg_sizes)

    # ------------------------------------------------ word-space group
    wsel = np.nonzero(word_like)[0]
    if wsel.size:
        _STATS.word_space_merges += int(wsel.size)
        words8 = np.zeros((wsel.size, _C_BYTES), np.uint8)
        arr_rows: list[int] = []
        arr_datas: list[np.ndarray] = []
        for j, i in enumerate(wsel.tolist()):  # memcpy-only gather loop
            c = conts[i]
            if c.kind == BITMAP:
                words8[j] = c.data.view(np.uint8)
            else:  # ARRAY crossing the promote threshold
                arr_rows.append(j)
                arr_datas.append(c.data)
        flat8 = words8.reshape(-1)
        if arr_datas:
            # promote every crossing array with ONE global scatter
            lows = np.concatenate(arr_datas)
            rep = np.repeat(
                np.asarray(arr_rows, np.int64),
                np.fromiter((d.size for d in arr_datas), np.int64,
                            len(arr_datas)))
            np.bitwise_or.at(
                flat8,
                rep * _C_BYTES + (lows >> np.uint16(3)).astype(np.int64),
                np.uint8(1) << (lows & np.uint16(7)).astype(np.uint8))
        # scatter the batch into the stacked words
        row_of = np.full(nseg, -1, np.int64)
        row_of[wsel] = np.arange(wsel.size)
        elem_row = row_of[seg_of]
        m = elem_row >= 0
        blows = (ids[m] & _LOW).astype(np.uint16)
        byte_idx = (elem_row[m] * _C_BYTES
                    + (blows >> np.uint16(3)).astype(np.int64))
        bit = np.uint8(1) << (blows & np.uint16(7)).astype(np.uint8)
        if remove:
            np.bitwise_and.at(flat8, byte_idx, np.uint8(0xFF) ^ bit)
        else:
            np.bitwise_or.at(flat8, byte_idx, bit)
        new_ns = np.bitwise_count(words8).sum(axis=1, dtype=np.int64)
        deltas = np.abs(new_ns - ns_attr[wsel])
        changed += int(deltas.sum())

        moved = deltas > 0
        for j in np.nonzero(moved & (new_ns == 0))[0].tolist():
            installs[int(seg_keys[wsel[j]])] = None
        for j in np.nonzero(moved & (new_ns > ARRAY_MAX))[0].tolist():
            # above the break-even a bitmap STAYS a bitmap (the
            # loop never reconsiders runs here) — non-canonical
            # on purpose, byte-identical to the loop
            installs[int(seg_keys[wsel[j]])] = Container(
                BITMAP, words8[j].copy().view("<u8"), int(new_ns[j]))
        shrunk = np.nonzero(moved & (new_ns > 0)
                            & (new_ns <= ARRAY_MAX))[0]
        if shrunk.size:
            # one batched unpack for every shrunken container, then the
            # shared canonical build (the loop: from_lows(lows()))
            bits = np.unpackbits(words8[shrunk], axis=1,
                                 bitorder="little")
            rows, cols = np.nonzero(bits)
            lows16 = cols.astype(np.uint16)
            los = np.searchsorted(rows, np.arange(shrunk.size))
            his_b = np.append(los[1:], rows.size)
            _canonical_into(installs, seg_keys[wsel[shrunk]],
                            lows16, los, his_b)

    # ------------------------------------------------ sorted-id group
    gsel = np.nonzero(~word_like)[0]
    if gsel.size:
        _STATS.stream_merges += int(gsel.size)
        g_keys = seg_keys[gsel]
        # actual payload sizes (ARRAY: data.size; RUN: expanded length)
        g_ns = np.zeros(gsel.size, np.int64)
        run_dst: list[int] = []
        run_blocks: list[np.ndarray] = []
        for j, i in enumerate(gsel.tolist()):  # metadata gather loop
            c = conts[i]
            if c is None:
                continue
            if c.kind == ARRAY:
                g_ns[j] = c.data.size
            else:  # RUN (BITMAP is always word-space)
                runs = c.data.astype(np.int64)
                g_ns[j] = int((runs[:, 1] - runs[:, 0] + 1).sum())
                run_dst.append(j)
                run_blocks.append(runs)
        off = np.concatenate(([0], np.cumsum(g_ns)))
        ex_lows = np.empty(int(off[-1]), np.uint16)
        for j, i in enumerate(gsel.tolist()):  # memcpy-only fill loop
            c = conts[i]
            if c is not None and c.kind == ARRAY:
                ex_lows[off[j]:off[j + 1]] = c.data
        if run_blocks:
            # expand ALL run payloads in one vectorized pass (the
            # kernels._run_ids idiom), then memcpy each block home
            runs = np.concatenate(run_blocks)
            lens = runs[:, 1] - runs[:, 0] + 1
            base = np.repeat(
                runs[:, 0] - np.concatenate(([0], np.cumsum(lens)[:-1])),
                lens)
            run_lows = (base + np.arange(int(lens.sum()))).astype(
                np.uint16)
            r0 = 0
            for j in run_dst:
                n = int(g_ns[j])
                ex_lows[off[j]:off[j + 1]] = run_lows[r0:r0 + n]
                r0 += n
        ex_ids = (ex_lows.astype(np.uint64)
                  + (np.repeat(g_keys, g_ns).astype(np.uint64) << _U16))

        if wsel.size:
            b_ids = ids[row_of[seg_of] < 0]
        else:
            b_ids = ids
        if remove:
            from pilosa_tpu_torch.roaring.kernels import setdiff_sorted

            merged = setdiff_sorted(ex_ids, b_ids)
        elif ex_ids.size == 0:
            merged = b_ids
        elif b_ids.size == 0:
            merged = ex_ids
        else:
            # both streams are sorted + deduped, so union is a linear
            # two-way merge: scatter the batch into its merged slots
            # instead of re-sorting the concatenation
            out = np.empty(ex_ids.size + b_ids.size, np.uint64)
            bmask = np.zeros(out.size, bool)
            bmask[np.searchsorted(ex_ids, b_ids)
                  + np.arange(b_ids.size)] = True
            out[bmask] = b_ids
            out[~bmask] = ex_ids
            merged = out[np.concatenate(([True], out[1:] != out[:-1]))]

        key_base = g_keys.astype(np.uint64) << _U16
        mlo = np.searchsorted(merged, key_base)
        mhi = np.searchsorted(merged, key_base + np.uint64(1 << 16))
        new_ns = (mhi - mlo).astype(np.int64)
        deltas = np.abs(new_ns - g_ns)
        changed += int(deltas.sum())
        moved = deltas > 0
        for j in np.nonzero(moved & (new_ns == 0))[0].tolist():
            installs[int(g_keys[j])] = None
        bsel = np.nonzero(moved & (new_ns > 0))[0]
        if bsel.size:
            _canonical_into(installs, g_keys[bsel],
                            (merged & _LOW).astype(np.uint16),
                            mlo[bsel].astype(np.int64),
                            mhi[bsel].astype(np.int64))

    if changed:
        for key, c in installs.items():
            if c is None:
                bm._containers.pop(key, None)
            else:
                bm._containers[key] = c
        bm.keys = sorted(bm._containers)
    return changed


def _canonical_into(installs: dict, keys: np.ndarray, lows16: np.ndarray,
                    los: np.ndarray, his: np.ndarray) -> None:
    """Build the canonical (``Container.from_lows``-identical) container
    for each segment ``[los[j], his[j])`` of the shared ``lows16``
    stream, installing under ``keys[j]``. The kind decision — the
    density-driven array↔run↔bitmap conversion — is computed for ALL
    segments in one vectorized pass over cardinalities and run counts;
    the per-segment loop below only slices and wraps. Segments must be
    non-empty and need not be contiguous in the stream."""
    n = (his - los).astype(np.int64)
    _STATS.canonical_builds += int(keys.size)
    if lows16.size > 1:
        gap_idx = np.nonzero(
            (lows16[1:].astype(np.int32)
             - lows16[:-1].astype(np.int32)) != 1)[0]
    else:
        gap_idx = _EMPTY_I64
    # breaks strictly inside each segment; size-1 segments have none
    g_lo = np.searchsorted(gap_idx, los)
    g_hi = np.searchsorted(gap_idx, np.maximum(his - 1, los))
    n_runs = (g_hi - g_lo) + 1
    # the from_lows cost model, verbatim: run 4 bytes/run beats
    # min(array 2n, bitmap 8192)
    run_kind = 4 * n_runs < np.minimum(2 * n, 8192)
    arr_kind = ~run_kind & (n <= ARRAY_MAX)
    bmp_kind = ~run_kind & ~arr_kind

    bsel = np.nonzero(bmp_kind)[0]
    if bsel.size:
        # batch-scatter every bitmap build at once
        words8 = np.zeros((bsel.size, _C_BYTES), np.uint8)
        flat8 = words8.reshape(-1)
        rep = np.repeat(np.arange(bsel.size), n[bsel])
        sel = np.concatenate([np.arange(los[j], his[j])
                              for j in bsel.tolist()])
        blows = lows16[sel]
        np.bitwise_or.at(
            flat8,
            rep * _C_BYTES + (blows >> np.uint16(3)).astype(np.int64),
            np.uint8(1) << (blows & np.uint16(7)).astype(np.uint8))
        for j2, j in enumerate(bsel.tolist()):
            installs[int(keys[j])] = Container(
                BITMAP, words8[j2].view("<u8").copy(), int(n[j]))

    for j in np.nonzero(run_kind)[0].tolist():  # slice/assemble loop
        lo, hi = int(los[j]), int(his[j])
        g = gap_idx[g_lo[j]:g_hi[j]]
        starts = np.empty(g.size + 1, np.int64)
        starts[0] = lo
        starts[1:] = g + 1
        ends = np.empty(g.size + 1, np.int64)
        ends[:-1] = g
        ends[-1] = hi - 1
        runs = np.stack([lows16[starts], lows16[ends]], axis=1)
        installs[int(keys[j])] = Container(
            RUN, np.ascontiguousarray(runs, np.uint16), int(n[j]))

    asel = np.nonzero(arr_kind)[0]
    if asel.size:
        # ONE global gather copies every array payload out of the shared
        # stream; containers hold contiguous views into it (exactly the
        # payload bytes are retained, nothing else)
        ln = n[asel]
        offs = np.concatenate(([0], np.cumsum(ln)))
        idx = (np.repeat(los[asel].astype(np.int64) - offs[:-1], ln)
               + np.arange(int(offs[-1])))
        buf = lows16[idx]
        a_keys = keys[asel]
        for j2, j in enumerate(asel.tolist()):  # slice/wrap-only loop
            installs[int(a_keys[j2])] = Container(
                ARRAY, buf[offs[j2]:offs[j2 + 1]], int(ln[j2]))


# --------------------------------------------------- membership probes


def set_rows_for_positions(bm, positions) -> tuple[np.ndarray, np.ndarray]:
    """Every (row, position index) pair set in ``bm`` among a batch of
    in-shard positions, as ``(rows, pos_idx)`` int64 arrays. Each
    existing container is visited once and probed only with the batch
    positions that fall in its 65536-bit slot of the row."""
    pos = np.asarray(positions, np.uint64)
    keys = list(bm.keys)
    if pos.size == 0 or not keys:
        return _EMPTY_I64, _EMPTY_I64
    _STATS.probe_calls += 1
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


def member_matrix(bm, rows, positions: np.ndarray) -> np.ndarray:
    """Membership of ``positions`` in each of ``rows``, as one
    (len(rows), len(positions)) bool matrix — the batched BSI-plane
    probe (exists row + every bit plane in one call instead of a row
    decode a plane). Probes only containers that exist, one vectorized
    ``Container.contains_lows`` per (row, slot) pair."""
    pos = np.asarray(positions, np.uint64)
    out = np.zeros((len(rows), pos.size), bool)
    if pos.size == 0 or not bm.keys:
        return out
    _STATS.probe_calls += 1
    slots = (pos >> _U16).astype(np.int64)
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    uniq_slots = np.unique(sorted_slots)
    slot_lo = np.searchsorted(sorted_slots, uniq_slots, side="left")
    slot_hi = np.searchsorted(sorted_slots, uniq_slots, side="right")
    lows = (pos & _LOW).astype(np.uint16)
    for i, r in enumerate(rows):  # one vectorized probe a (row, slot)
        base_key = int(r) << 4
        for s, lo, hi in zip(uniq_slots.tolist(), slot_lo.tolist(),
                             slot_hi.tolist()):
            c = bm.container(base_key | int(s))
            if c is None:
                continue
            sel = order[lo:hi]
            out[i, sel] = c.contains_lows(lows[sel])
    return out

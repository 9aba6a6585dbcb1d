"""Whole-fragment roaring kernels on the host (numpy), the port's copy of
``pilosa_tpu.roaring.kernels``.

A fragment's containers are concatenated once into flat per-kind arrays
(``flatten``, optionally over a window of container keys; the one
per-container loop), and every other kernel works on those arrays in a
fixed number of numpy calls a fragment, not a container:

- ``fragment_ids`` / ``range_ids``: the sorted bit ids;
- ``dense_words32``: a window of containers as packed uint32 words, the
  decode of a row before its upload to the card (``Fragment.row_words``);
- ``popcount``: the population from the payloads;
- ``fragment_and`` / ``_or`` / ``_xor`` / ``_andnot`` and ``diff_ids``:
  set operations, bitmap against bitmap in word space, the rest over
  sorted ids (a galloping probe when the sides are lopsided);
- ``block_slices`` / ``diff_digests``: the checksum blocks of an id array
  and the blocks two digest lists disagree on;
- ``snapshot_ids``: a snapshot's bytes parsed straight into flat arrays
  (``flat_from_snapshot``: no Container objects, the same checks and
  error texts as ``format.deserialize``); irregular but accepted
  snapshots (a bitmap payload not of 1024 words, duplicate keys) take
  the decoder and ``flatten`` instead.

Every kernel is byte-identical to the per-container walk it replaces.
``KernelStats`` counts their calls (the ``hostpath_*`` series of
``/metrics``).
"""

from __future__ import annotations

import bisect
import struct

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import ARRAY, BITMAP, BITMAP_N_WORDS, RUN

_U16 = np.uint64(16)
_EMPTY_IDS = np.empty(0, np.uint64)
_EMPTY_IDS.setflags(write=False)


class KernelStats:
    """Process-wide host-path kernel counters (``hostpath_*``). Plain int
    adds, no lock: they feed dashboards, not correctness."""

    __slots__ = ("kernel_calls", "containers_flattened", "ids_materialized",
                 "dense_decodes", "set_ops")

    def __init__(self):
        self.kernel_calls = 0
        self.containers_flattened = 0
        self.ids_materialized = 0
        self.dense_decodes = 0
        self.set_ops = 0

    def metrics(self) -> dict:
        return {
            "hostpath_kernel_calls_total": self.kernel_calls,
            "hostpath_containers_flattened_total": self.containers_flattened,
            "hostpath_ids_materialized_total": self.ids_materialized,
            "hostpath_dense_decodes_total": self.dense_decodes,
            "hostpath_set_ops_total": self.set_ops,
        }


_STATS = KernelStats()


def global_kernel_stats() -> KernelStats:
    return _STATS


class FlatFragment:
    """A fragment's containers as flat per-kind arrays, in ascending key
    order: ``keys``/``kinds``/``cards`` per container, ``kind_row[i]`` its
    row within its kind; array payloads concatenated in ``arr_data`` with
    ``arr_off`` offsets, bitmap words stacked in ``bmp_words`` (n, 1024),
    run intervals in ``run_data`` (R, 2) with ``run_off`` offsets."""

    __slots__ = ("keys", "kinds", "cards", "kind_row",
                 "arr_sel", "arr_data", "arr_off",
                 "bmp_sel", "bmp_words",
                 "run_sel", "run_data", "run_off")

    @property
    def n_containers(self) -> int:
        return int(self.keys.size)

    def total(self) -> int:
        return int(self.cards.sum()) if self.cards.size else 0

    def kind_counts(self) -> tuple[int, int, int]:
        """(array, bitmap, run) container counts: the PROFILE tally of
        one decode."""
        c = np.bincount(self.kinds, minlength=4)
        return int(c[ARRAY]), int(c[BITMAP]), int(c[RUN])


def _build_flat(pairs) -> FlatFragment:
    """A FlatFragment from (key, Container) pairs in ascending key order:
    references and metadata only, every bit touched in the kernels."""
    f = FlatFragment()
    n = len(pairs)
    keys = np.empty(n, np.int64)
    kinds = np.empty(n, np.uint8)
    cards = np.empty(n, np.int64)
    kind_row = np.empty(n, np.int64)
    arr_sel, arr_parts = [], []
    bmp_sel, bmp_parts = [], []
    run_sel, run_parts = [], []
    for i, (key, c) in enumerate(pairs):
        keys[i] = key
        kinds[i] = c.kind
        cards[i] = c.n
        if c.kind == ARRAY:
            kind_row[i] = len(arr_sel)
            arr_sel.append(i)
            arr_parts.append(c.data)
        elif c.kind == BITMAP:
            kind_row[i] = len(bmp_sel)
            bmp_sel.append(i)
            bmp_parts.append(c.data)
        else:
            kind_row[i] = len(run_sel)
            run_sel.append(i)
            run_parts.append(c.data)
    f.keys, f.kinds, f.cards, f.kind_row = keys, kinds, cards, kind_row
    f.arr_sel = np.asarray(arr_sel, np.int64)
    f.arr_data = (np.concatenate(arr_parts) if arr_parts
                  else np.empty(0, np.uint16))
    lens = np.asarray([p.size for p in arr_parts], np.int64)
    f.arr_off = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    f.bmp_sel = np.asarray(bmp_sel, np.int64)
    f.bmp_words = (np.stack(bmp_parts) if bmp_parts
                   else np.empty((0, BITMAP_N_WORDS), np.uint64))
    f.run_sel = np.asarray(run_sel, np.int64)
    f.run_data = (np.concatenate(run_parts).astype(np.int64).reshape(-1, 2)
                  if run_parts else np.empty((0, 2), np.int64))
    rlens = np.asarray([p.shape[0] for p in run_parts], np.int64)
    f.run_off = np.concatenate(([0], np.cumsum(rlens))).astype(np.int64)
    _STATS.containers_flattened += n
    return f


def flatten(bitmap, lo_key: int | None = None,
            hi_key: int | None = None) -> FlatFragment:
    """A RoaringBitmap's non-empty containers with keys in [lo_key,
    hi_key] (inclusive; None: unbounded), flattened. Lock-free against
    writers: a container removed meanwhile is skipped, and containers
    are swapped whole, never changed in place."""
    keys = bitmap.keys
    lo_i = 0 if lo_key is None else bisect.bisect_left(keys, lo_key)
    hi_i = len(keys) if hi_key is None else bisect.bisect_right(keys, hi_key)
    pairs = []
    for key in keys[lo_i:hi_i]:
        c = bitmap.container(key)
        if c is not None and c.n:
            pairs.append((key, c))
    return _build_flat(pairs)


def _take(f: FlatFragment, idx: np.ndarray) -> FlatFragment:
    """The containers at positions ``idx`` (ascending) as a new
    FlatFragment: array gathers only."""
    arr_pick = idx[f.kinds[idx] == ARRAY]
    bmp_pick = idx[f.kinds[idx] == BITMAP]
    run_pick = idx[f.kinds[idx] == RUN]
    out = FlatFragment()
    out.keys = f.keys[idx]
    out.kinds = f.kinds[idx]
    out.cards = f.cards[idx]
    kind_row = np.empty(idx.size, np.int64)
    kind_row[f.kinds[idx] == ARRAY] = np.arange(arr_pick.size)
    kind_row[f.kinds[idx] == BITMAP] = np.arange(bmp_pick.size)
    kind_row[f.kinds[idx] == RUN] = np.arange(run_pick.size)
    out.kind_row = kind_row
    rows = f.kind_row[arr_pick]
    starts, stops = f.arr_off[rows], f.arr_off[rows + 1]
    out.arr_sel = np.nonzero(out.kinds == ARRAY)[0]
    out.arr_data = _gather_ranges(f.arr_data, starts, stops)
    out.arr_off = np.concatenate(
        ([0], np.cumsum(stops - starts))).astype(np.int64)
    out.bmp_sel = np.nonzero(out.kinds == BITMAP)[0]
    out.bmp_words = f.bmp_words[f.kind_row[bmp_pick]]
    rrows = f.kind_row[run_pick]
    rstarts, rstops = f.run_off[rrows], f.run_off[rrows + 1]
    out.run_sel = np.nonzero(out.kinds == RUN)[0]
    out.run_data = _gather_ranges(f.run_data, rstarts, rstops)
    out.run_off = np.concatenate(
        ([0], np.cumsum(rstops - rstarts))).astype(np.int64)
    return out


def _gather_ranges(data: np.ndarray, starts: np.ndarray,
                   stops: np.ndarray) -> np.ndarray:
    """``data[s0:e0] ++ data[s1:e1] ++ ...``: slice views and one
    concatenate, never a per-element gather."""
    parts = [data[a:b] for a, b in zip(starts.tolist(), stops.tolist())]
    if not parts:
        return data[:0].copy()
    return np.concatenate(parts) if len(parts) > 1 else parts[0].copy()


def _bmp_lows(f: FlatFragment) -> tuple[np.ndarray, np.ndarray]:
    """Set bit positions across the stacked bitmap words (int64 into the
    nb x 65536-bit space) and the count a bitmap container."""
    nb = f.bmp_words.shape[0]
    if nb == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    bits = np.unpackbits(
        np.ascontiguousarray(f.bmp_words).view(np.uint8), bitorder="little")
    pos = np.flatnonzero(bits.view(bool))
    edges = np.searchsorted(pos, np.arange(nb + 1, dtype=np.int64) << 16)
    return pos, np.diff(edges)


def _bmp_ids(f: FlatFragment) -> tuple[np.ndarray, np.ndarray]:
    """Global ids of every bitmap container as one sorted uint64 stream,
    and the count a container: each segment's container base added in
    place (``id = pos + ((key - slot) << 16)``)."""
    pos, counts = _bmp_lows(f)
    if pos.size == 0:
        return _EMPTY_IDS, counts
    adj = ((f.keys[f.bmp_sel] - np.arange(f.bmp_sel.size))
           << np.int64(16)).tolist()
    edges = np.concatenate(([0], np.cumsum(counts))).tolist()
    for c, a in enumerate(adj):
        if a and edges[c] != edges[c + 1]:
            pos[edges[c]:edges[c + 1]] += a
    return pos.view(np.uint64), counts


def _run_ids(f: FlatFragment) -> tuple[np.ndarray, np.ndarray]:
    """Global ids of every run container as one sorted uint64 stream, and
    the count a container: bases folded into the run starts, then ones
    plus boundary deltas and one in-place cumsum."""
    runs = f.run_data
    if runs.shape[0] == 0:
        return _EMPTY_IDS, np.zeros(f.run_sel.size, np.int64)
    lengths = np.maximum(runs[:, 1] - runs[:, 0] + 1, 0)
    per_cont = np.add.reduceat(lengths, f.run_off[:-1])
    per_cont[f.run_off[:-1] == f.run_off[1:]] = 0
    total = int(lengths.sum())
    if total == 0:
        return _EMPTY_IDS, per_cont
    runs_per_cont = f.run_off[1:] - f.run_off[:-1]
    gstarts = runs[:, 0] + np.repeat(f.keys[f.run_sel] << np.int64(16),
                                     runs_per_cont)
    keep = lengths > 0
    if not keep.all():
        gstarts, lengths = gstarts[keep], lengths[keep]
    gids = np.ones(total, np.int64)
    gids[0] = gstarts[0]
    bounds = np.cumsum(lengths)[:-1]
    if bounds.size:
        gids[bounds] = gstarts[1:] - (gstarts[:-1] + lengths[:-1] - 1)
    np.cumsum(gids, out=gids)
    return gids.view(np.uint64), per_cont


def fragment_ids(f: FlatFragment) -> np.ndarray:
    """Every id of the flat fragment, sorted uint64. Extents come from
    the payloads, never the descriptors' cardinalities (a decodable but
    corrupt file may carry a false one). The kinds' streams interleave
    with one slice per run of same-kind containers."""
    _STATS.kernel_calls += 1
    nc = int(f.keys.size)
    if nc == 0:
        return _EMPTY_IDS
    arr_ids = _EMPTY_IDS
    arr_counts = f.arr_off[1:] - f.arr_off[:-1]
    if f.arr_data.size:
        bases = f.keys[f.arr_sel].astype(np.uint64) << _U16
        arr_ids = np.repeat(bases, arr_counts) + f.arr_data
    bmp_ids, bmp_counts = _bmp_ids(f)
    run_ids, run_counts = _run_ids(f)
    total = arr_ids.size + bmp_ids.size + run_ids.size
    if total == 0:
        return _EMPTY_IDS
    _STATS.ids_materialized += total
    if f.arr_sel.size == nc:
        return arr_ids
    if f.bmp_sel.size == nc:
        return bmp_ids
    if f.run_sel.size == nc:
        return run_ids
    arr_off = f.arr_off.tolist()
    bmp_off = np.concatenate(([0], np.cumsum(bmp_counts))).tolist()
    run_off = np.concatenate(([0], np.cumsum(run_counts))).tolist()
    kinds, rows = f.kinds.tolist(), f.kind_row.tolist()
    seg = [0, *(np.flatnonzero(np.diff(f.kinds)) + 1).tolist(), nc]
    parts = []
    for j in range(len(seg) - 1):
        s = seg[j]
        k, r0, r1 = kinds[s], rows[s], rows[seg[j + 1] - 1] + 1
        if k == ARRAY:
            parts.append(arr_ids[arr_off[r0]:arr_off[r1]])
        elif k == BITMAP:
            parts.append(bmp_ids[bmp_off[r0]:bmp_off[r1]])
        else:
            parts.append(run_ids[run_off[r0]:run_off[r1]])
    return np.concatenate(parts)


def range_ids(f: FlatFragment, start: int, stop: int) -> np.ndarray:
    """Sorted ids in [start, stop) of a key-bounded flat view (the edge
    containers trimmed by one mask)."""
    ids = fragment_ids(f)
    if ids.size == 0:
        return ids
    return ids[(ids >= np.uint64(start)) & (ids < np.uint64(stop))]


# ------------------------------------------------------------ dense decode


def _or_runs_into(words: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray) -> None:
    """OR the inclusive bit ranges [starts[i], ends[i]] into flat uint64
    words in O(runs + words): the partial head and tail words through
    masked ``bitwise_or.at``, the whole words between through a cumsum
    of coverage."""
    ok = ends >= starts
    if not ok.all():
        starts, ends = starts[ok], ends[ok]
    if starts.size == 0:
        return
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    ws, we = starts >> 6, ends >> 6
    head = ones << (starts & 63).astype(np.uint64)
    tail = ones >> (np.uint64(63) - (ends & 63).astype(np.uint64))
    same = ws == we
    np.bitwise_or.at(words, ws, np.where(same, head & tail, head))
    cross = ~same
    if cross.any():
        np.bitwise_or.at(words, we[cross], tail[cross])
        delta = np.zeros(words.size + 1, np.int64)
        np.add.at(delta, ws[cross] + 1, 1)
        np.add.at(delta, we[cross], -1)
        words[np.cumsum(delta[:-1]) > 0] = ones


def dense_words32(f: FlatFragment, base_key: int,
                  n_containers: int) -> np.ndarray:
    """``n_containers`` consecutive containers from ``base_key`` as
    packed uint32 words, byte-identical to each container's
    ``dense_words32``. Bitmap words copy across (an all-bitmap window
    is the flat view's own buffer), runs fill whole words without
    expanding to bits, array bits scatter while sparse and go through
    one bool write and ``np.packbits`` past 1/128 of the window."""
    _STATS.kernel_calls += 1
    _STATS.dense_decodes += 1
    slots = f.keys - base_key
    n_scatter = int(f.arr_data.size)
    if (n_scatter == 0 and f.run_data.shape[0] == 0
            and f.bmp_sel.size == n_containers):
        w = f.bmp_words
        if w.flags.owndata and w.flags.writeable and w.flags.c_contiguous:
            return w.reshape(-1).view("<u4")
        return np.ascontiguousarray(w).reshape(-1).view("<u4").copy()
    run_gs = run_ge = None
    if f.run_data.shape[0]:
        runs_per_cont = f.run_off[1:] - f.run_off[:-1]
        rbase = np.repeat(slots[f.run_sel] << 16, runs_per_cont)
        run_gs = rbase + f.run_data[:, 0]
        run_ge = rbase + f.run_data[:, 1]
    if n_scatter >= n_containers << 9:  # window bits / 128
        bits = np.zeros(n_containers << 16, bool)
        arr_counts = f.arr_off[1:] - f.arr_off[:-1]
        gpos = (np.repeat(slots[f.arr_sel] << 16, arr_counts)
                + f.arr_data.astype(np.int64))
        bits[gpos] = True
        out8 = np.packbits(bits, bitorder="little")
        out64 = out8.view("<u8").reshape(n_containers, BITMAP_N_WORDS)
        if f.bmp_words.shape[0]:
            out64[slots[f.bmp_sel]] = f.bmp_words
        if run_gs is not None:
            _or_runs_into(out64.reshape(-1), run_gs, run_ge)
        return out8.view("<u4").copy()
    out64 = np.zeros((n_containers, BITMAP_N_WORDS), np.uint64)
    if f.bmp_words.shape[0]:
        out64[slots[f.bmp_sel]] = f.bmp_words
    if n_scatter:
        arr_counts = f.arr_off[1:] - f.arr_off[:-1]
        gpos = (np.repeat(slots[f.arr_sel] << 16, arr_counts)
                + f.arr_data.astype(np.int64))
        np.bitwise_or.at(out64.reshape(-1), gpos >> 6,
                         np.uint64(1) << (gpos & 63).astype(np.uint64))
    if run_gs is not None:
        _or_runs_into(out64.reshape(-1), run_gs, run_ge)
    return out64.reshape(-1).view("<u4")


def popcount(f: FlatFragment) -> int:
    """The population from the payloads (array sizes, bitmap popcounts,
    run lengths), never the cached cardinalities."""
    _STATS.kernel_calls += 1
    total = int(f.arr_data.size)
    if f.bmp_words.shape[0]:
        total += int(np.bitwise_count(f.bmp_words).sum(dtype=np.int64))
    if f.run_data.shape[0]:
        total += int((f.run_data[:, 1] - f.run_data[:, 0] + 1).sum())
    return total


# ----------------------------------------------------------------- set ops


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique uint64 intersection: the small side probed into the
    big one with one ``searchsorted`` when they are lopsided, a linear
    merge otherwise."""
    if a.size == 0 or b.size == 0:
        return _EMPTY_IDS
    small, big = (a, b) if a.size <= b.size else (b, a)
    if small.size << 5 < big.size:
        i = np.searchsorted(big, small)
        i_c = np.minimum(i, big.size - 1)
        return small[(i < big.size) & (big[i_c] == small)]
    return np.intersect1d(a, b, assume_unique=True)


def setdiff_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique a \\ b, probing when b dwarfs a."""
    if a.size == 0:
        return _EMPTY_IDS
    if b.size == 0:
        return a
    if a.size << 5 < b.size:
        i = np.searchsorted(b, a)
        i_c = np.minimum(i, b.size - 1)
        return a[~((i < b.size) & (b[i_c] == a))]
    return np.setdiff1d(a, b, assume_unique=True)


def _ids_from_word_rows(keys: np.ndarray, words: np.ndarray) -> np.ndarray:
    """Ids of (key, 1024-word row) pairs: one unpack, one nonzero, each
    row's container base added."""
    nb = words.shape[0]
    if nb == 0:
        return _EMPTY_IDS
    bits = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), bitorder="little")
    pos = np.flatnonzero(bits.view(bool))
    if pos.size == 0:
        return _EMPTY_IDS
    edges = np.searchsorted(pos, np.arange(nb + 1, dtype=np.int64) << 16)
    adj = (keys.astype(np.int64) - np.arange(nb)) << np.int64(16)
    return (pos + np.repeat(adj, np.diff(edges))).view(np.uint64)


def _as_flat(x) -> FlatFragment:
    return x if isinstance(x, FlatFragment) else flatten(x)


def _setop(a, b, word_op, id_op, keep_a_only: bool,
           keep_b_only: bool) -> np.ndarray:
    fa, fb = _as_flat(a), _as_flat(b)
    _STATS.kernel_calls += 1
    _STATS.set_ops += 1
    common, ia, ib = np.intersect1d(fa.keys, fb.keys, return_indices=True)
    parts = []
    if common.size:
        bb = (fa.kinds[ia] == BITMAP) & (fb.kinds[ib] == BITMAP)
        if bb.any():  # bitmap against bitmap stays in word space
            wa = fa.bmp_words[fa.kind_row[ia[bb]]]
            wb = fb.bmp_words[fb.kind_row[ib[bb]]]
            parts.append(_ids_from_word_rows(common[bb], word_op(wa, wb)))
        if (~bb).any():
            ids_a = fragment_ids(_take(fa, ia[~bb]))
            ids_b = fragment_ids(_take(fb, ib[~bb]))
            parts.append(id_op(ids_a, ids_b))
    if keep_a_only:
        only = np.setdiff1d(np.arange(fa.keys.size), ia)
        if only.size:
            parts.append(fragment_ids(_take(fa, only)))
    if keep_b_only:
        only = np.setdiff1d(np.arange(fb.keys.size), ib)
        if only.size:
            parts.append(fragment_ids(_take(fb, only)))
    parts = [p for p in parts if p.size]
    if not parts:
        return _EMPTY_IDS
    if len(parts) == 1:
        return parts[0]
    return np.sort(np.concatenate(parts))


def fragment_and(a, b) -> np.ndarray:
    """Sorted ids of a ∩ b (bitmaps or flat views)."""
    return _setop(a, b, np.bitwise_and, intersect_sorted, False, False)


def fragment_or(a, b) -> np.ndarray:
    """Sorted ids of a ∪ b."""
    return _setop(a, b, np.bitwise_or,
                  lambda x, y: np.union1d(x, y), True, True)


def fragment_xor(a, b) -> np.ndarray:
    """Sorted ids of a △ b."""
    return _setop(a, b, np.bitwise_xor,
                  lambda x, y: np.setxor1d(x, y, assume_unique=True),
                  True, True)


def fragment_andnot(a, b) -> np.ndarray:
    """Sorted ids of a \\ b."""
    return _setop(a, b, lambda x, y: x & ~y, setdiff_sorted, True, False)


def diff_ids(a, b) -> tuple[np.ndarray, np.ndarray]:
    """(only in a, only in b) as sorted id arrays: the content diff of
    two copies of a block."""
    ids_a = fragment_ids(_as_flat(a))
    ids_b = fragment_ids(_as_flat(b))
    return setdiff_sorted(ids_a, ids_b), setdiff_sorted(ids_b, ids_a)


# -------------------------------------------------------- digests / diffs


def block_slices(ids: np.ndarray, blocks, block_rows: int = 100) -> dict:
    """``{block: ids}``: a sorted id array sliced into the requested
    checksum blocks with one ``searchsorted`` over their edges."""
    _STATS.kernel_calls += 1
    wanted = np.asarray(sorted(set(int(b) for b in blocks)), np.int64)
    if wanted.size == 0:
        return {}
    width = np.uint64(block_rows) << np.uint64(20)
    los = wanted.astype(np.uint64) * width
    edges = np.searchsorted(ids, np.concatenate((los, los + width)))
    n = wanted.size
    return {int(wanted[i]): ids[edges[i]:edges[n + i]] for i in range(n)}


def diff_digests(local, peer) -> list[int]:
    """The blocks to fetch from a peer: every block it has that the
    local side lacks or disagrees on, sorted."""
    local = dict(local)
    return sorted(int(b) for b, checksum in dict(peer).items()
                  if local.get(b) != checksum)


_HEADER = struct.Struct("<IHHIQ")
_SNAP_MAGIC = 0x50C4B175
_SNAP_VERSION = 1
_DESCR_DTYPE = np.dtype([("key", "<u8"), ("kind", "<u2"),
                         ("nm1", "<u2"), ("plen", "<u4")])


class _IrregularSnapshot(Exception):
    """Structurally valid but irregular snapshot (non-canonical payload
    sizes, duplicate keys): take the decoder."""


def flat_from_snapshot(buf) -> tuple[FlatFragment, int]:
    """Parse a snapshot's bytes into a FlatFragment with the decoder's
    structural checks and error texts; returns (flat, offset where the
    op records begin). Raises _IrregularSnapshot on inputs the decoder
    accepts but this parser does not model."""
    buf = memoryview(buf)
    if len(buf) < _HEADER.size:
        raise ValueError("roaring: truncated header")
    magic, version, _flags, n_containers, payload_bytes = _HEADER.unpack_from(
        buf, 0)
    if magic != _SNAP_MAGIC:
        raise ValueError(f"roaring: bad magic 0x{magic:08X}")
    if version != _SNAP_VERSION:
        raise ValueError(f"roaring: unsupported version {version}")
    descr_end = _HEADER.size + n_containers * _DESCR_DTYPE.itemsize
    if descr_end > len(buf):
        raise ValueError("roaring: truncated container payload")
    descrs = np.frombuffer(buf, dtype=_DESCR_DTYPE, count=n_containers,
                           offset=_HEADER.size)
    kinds = descrs["kind"].astype(np.uint8)
    plens = descrs["plen"].astype(np.int64)
    bad = (kinds < ARRAY) | (kinds > RUN)
    if bad.any():
        k = int(descrs["kind"][np.nonzero(bad)[0][0]])
        raise ValueError(f"roaring: unknown container kind {k}")
    offs = descr_end + np.concatenate(([0], np.cumsum(plens)))
    if int(offs[-1]) > len(buf):
        raise ValueError("roaring: truncated container payload")
    if int(offs[-1]) != descr_end + payload_bytes:
        raise ValueError("roaring: payload length mismatch")
    is_b = kinds == BITMAP
    if ((plens[kinds == ARRAY] & 1).any()
            or (plens[is_b] != BITMAP_N_WORDS * 8).any()
            or (plens[kinds == RUN] & 3).any()):
        raise _IrregularSnapshot()
    keys = descrs["key"].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    if np.unique(keys).size != keys.size:
        raise _IrregularSnapshot()  # the decoder keeps the last of a key
    buf8 = np.frombuffer(buf, np.uint8)
    f = FlatFragment()
    f.keys = keys[order]
    f.kinds = kinds[order]
    kind_row = np.empty(n_containers, np.int64)
    kind_row[f.kinds == ARRAY] = np.arange(int((f.kinds == ARRAY).sum()))
    kind_row[f.kinds == BITMAP] = np.arange(int((f.kinds == BITMAP).sum()))
    kind_row[f.kinds == RUN] = np.arange(int((f.kinds == RUN).sum()))
    f.kind_row = kind_row
    starts, stops = offs[:-1][order], offs[1:][order]
    a_m, b_m, r_m = (f.kinds == ARRAY), (f.kinds == BITMAP), (f.kinds == RUN)
    f.arr_sel = np.nonzero(a_m)[0]
    f.arr_data = np.ascontiguousarray(
        _gather_ranges(buf8, starts[a_m], stops[a_m])).view("<u2")
    f.arr_off = np.concatenate(
        ([0], np.cumsum((stops[a_m] - starts[a_m]) >> 1))).astype(np.int64)
    f.bmp_sel = np.nonzero(b_m)[0]
    f.bmp_words = np.ascontiguousarray(
        _gather_ranges(buf8, starts[b_m], stops[b_m])
    ).view("<u8").reshape(-1, BITMAP_N_WORDS)
    f.run_sel = np.nonzero(r_m)[0]
    f.run_data = np.ascontiguousarray(
        _gather_ranges(buf8, starts[r_m], stops[r_m])
    ).view("<u2").astype(np.int64).reshape(-1, 2)
    f.run_off = np.concatenate(
        ([0], np.cumsum((stops[r_m] - starts[r_m]) >> 2))).astype(np.int64)
    # cardinalities from the payloads, as the decoder materializes them
    cards = np.zeros(n_containers, np.int64)
    cards[a_m] = f.arr_off[1:] - f.arr_off[:-1]
    if f.bmp_words.shape[0]:
        cards[b_m] = np.bitwise_count(f.bmp_words).sum(axis=1,
                                                       dtype=np.int64)
    if f.run_data.shape[0]:
        rlens = f.run_data[:, 1] - f.run_data[:, 0] + 1
        per = np.add.reduceat(rlens, f.run_off[:-1])
        per[f.run_off[:-1] == f.run_off[1:]] = 0
        cards[r_m] = per
    f.cards = cards
    _STATS.containers_flattened += n_containers
    return f, int(offs[-1])


def snapshot_ids(buf) -> tuple[np.ndarray, int]:
    """Sorted ids of a snapshot's payload, straight from the bytes, and
    the offset where its op records begin; byte-identical to decoding
    the snapshot and listing its ids."""
    try:
        flat, ops_at = flat_from_snapshot(buf)
    except _IrregularSnapshot:
        from pilosa_tpu_torch.roaring.format import deserialize

        bitmap, ops_at = deserialize(buf)
        flat = flatten(bitmap)
    return fragment_ids(flat), ops_at

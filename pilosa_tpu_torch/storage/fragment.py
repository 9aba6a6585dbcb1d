"""Fragment: one (index, field, view, shard) slice of the bitmap matrix.

The port's thin copy of ``pilosa_tpu.storage.fragment``. Row ``r``
occupies bit positions [r·2^20, (r+1)·2^20) of the fragment bitmap. The
file is a roaring snapshot followed by an append-only op log, in the
reference's byte layout, compacted once the op count crosses a
threshold; opening replays the log (torn tails dropped).

Where the op log lives depends on the holder's durability mode
(``storage/wal.py``): ``group`` routes each record through the holder's
group-commit WAL (one fsync per group of concurrent writers; the file
holds snapshots only, and a clean close snapshots a dirty fragment);
``per-op`` appends to this fragment's own file and fsyncs it before the
mutator returns; ``flush-only`` appends and flushes without an fsync. A
fragment built without a WAL logs as ``per-op``. Every mutation emits a
``WriteEvent`` to the holder's residency cache, which patches the
dependent resident leaves.

The reference's sidecars are kept as it keeps them: every snapshot
writes the ``.checksums`` block digests (``storage/integrity.py``), which
an open with ``verify_on_load`` checks (a corrupt file raises
``CorruptFragmentError``, which ``View.open`` turns into a quarantine);
every write path updates the row-count cache (``storage/cache.py``),
which a clean close saves as ``.cache`` (when it changed since it was
loaded or saved) and ``recalculate_cache`` rebuilds. TopN's phase 1
takes its candidates from that cache (``top``), as the reference does.
One deliberate difference: a fragment opened without a ``.cache``
sidecar fills its cache from the exact counts, where the reference's
starts empty. Every write is a write point (``_note_write``): the
result cache's entries of this (index, field, shard) are invalidated
there, before the write's ACK (``serving/rescache.py``), and a point
write served by the API records write heat (``storage/heat.py``). Under
a request's cost context ``row_words`` tallies the containers it
decodes (one batched decode of the row's window,
``roaring/kernels.dense_words32``); the mutex and BSI imports probe the
bits they replace in one batched pass (``roaring/merge_kernels``). A
failed per-op fsync, snapshot or sidecar write
trips the holder's ``StorageHealth`` latch, and every file operation
that can fail passes the disk fault plane's seams
(``testing/faults.py``).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from pilosa_tpu_torch.ops.packing import unpack_bits
from pilosa_tpu_torch.roaring import OP_ADD, OP_REMOVE, RoaringBitmap, \
    kernels, merge_kernels
from pilosa_tpu_torch.roaring.format import (
    encode_op,
    replay_ops,
    serialize,
)
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, keep_last_unique
from pilosa_tpu_torch.serving import rescache
from pilosa_tpu_torch.storage import heat
from pilosa_tpu_torch.storage.cache import (
    CACHE_TYPE_RANKED,
    DEFAULT_CACHE_SIZE,
    new_row_cache,
)
from pilosa_tpu_torch.storage.integrity import (
    BLOCK_ROWS,
    CHECKSUM_SUFFIX,
    DECODE_ERRORS,
    CorruptFragmentError,
    block_digests,
    load_verified,
    read_file,
    save_checksums,
)
from pilosa_tpu_torch.storage.residency import WriteEvent
from pilosa_tpu_torch.storage.wal import MODE_PER_OP, fsync_dir, wal_fsync
from pilosa_tpu_torch.testing import faults
from pilosa_tpu_torch.utils.cost import current_cost
from pilosa_tpu_torch.utils.stats import global_stats

# Snapshot (compact) once this many op records have accumulated (the
# reference's DEFAULT_SNAPSHOT_OP_THRESHOLD).
DEFAULT_SNAPSHOT_OP_THRESHOLD = 2048

# The row-count cache's sidecar beside the fragment file.
ROW_CACHE_SUFFIX = ".cache"


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _group_by_row(rows: np.ndarray, positions: np.ndarray):
    """Yield ``(row, positions_in_row)`` ascending by row."""
    if rows.size == 0:
        return
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    sorted_pos = positions[order]
    uniq, starts = np.unique(sorted_rows, return_index=True)
    bounds = np.append(starts, sorted_rows.size)
    for i, r in enumerate(uniq.tolist()):
        yield int(r), sorted_pos[bounds[i]:bounds[i + 1]]


def _ranked(pairs) -> list[tuple[int, int]]:
    """(row, count) pairs with a count, by count descending, then row."""
    return sorted(((r, c) for r, c in pairs if c > 0),
                  key=lambda rc: (-rc[1], rc[0]))


class Fragment:
    def __init__(self, path: str, index: str, field: str, view: str,
                 shard: int, scope: str = "", cache=None,
                 snapshot_threshold: int = DEFAULT_SNAPSHOT_OP_THRESHOLD,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 verify_on_load: bool = False, wal=None):
        self.path = path
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.scope = scope
        self.cache = cache  # the holder's DeviceRowCache (None: no device)
        # the holder's WriteAheadLog (None: log per-op to this file)
        self.wal = wal
        self.wal_key = f"{index}/{field}/{view}/{shard}"
        self.frag_id = (scope, index, field, view, shard)
        self.bitmap = RoaringBitmap()
        self.op_n = 0
        self.snapshot_threshold = snapshot_threshold
        self._file = None
        self._open = False
        # open() checks the snapshot's block digests against .checksums
        self.verify_on_load = verify_on_load
        # the TopN row-count cache, saved as the .cache sidecar on close
        self.row_cache = new_row_cache(cache_type, cache_size)
        # the .cache sidecar holds the row cache as it is (loaded or saved
        # since the last write): a clean close need not rewrite it
        self._cache_saved = False
        # bumped after every bitmap change; keys the row-count and ranking
        # memos
        self.mutations = 0
        self._row_counts_memo = None
        self._top_memo = None
        # one writer at a time; row reads stay lock-free against the
        # bitmap's atomic container swaps
        self.lock = threading.RLock()

    # ------------------------------------------------------------- lifecycle

    def open(self) -> "Fragment":
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        torn = False
        if os.path.exists(self.path):
            buf = read_file(self.path)  # the disk-fault read seam
            if buf:
                # the sidecar describes the snapshot alone: verify before
                # the op log is replayed
                self.bitmap, ops_at = load_verified(
                    buf, self.path, verify=self.verify_on_load)
                try:
                    self.op_n, ops_end = replay_ops(self.bitmap, buf, ops_at)
                except DECODE_ERRORS as e:
                    raise CorruptFragmentError(
                        self.path, f"op replay failed: {e}",
                        offset=ops_at) from e
                torn = ops_end < len(buf)
        else:
            with open(self.path, "wb") as f:
                f.write(serialize(self.bitmap))
                f.flush()
                os.fsync(f.fileno())
            fsync_dir(os.path.dirname(self.path))
        self._cache_saved = self.row_cache.load(self.path + ROW_CACHE_SUFFIX)
        if not self._cache_saved:
            # no sidecar (a crash before the first close, a deleted
            # file): fill the cache from the exact counts, where the
            # reference starts empty and ranks only rows written later
            rows, counts = self.row_counts()
            for r, c in zip(rows.tolist(), counts.tolist()):
                self.row_cache.bulk_add(r, c)
        self._open = True
        if torn or self.op_n > self.snapshot_threshold:
            # a torn tail left by a crash mid-append must go before any
            # new record is appended behind it, or replay would stop at
            # the tear and drop every acknowledged write after it
            self.snapshot()
        return self

    def close(self, discard: bool = False) -> None:
        """``discard``: the caller is about to unlink the files (a shard
        delete that replay redoes), so nothing is written first."""
        with self.lock:
            if not self._open:
                return
            grouped = self.wal is not None and self.wal.grouped
            if not discard:
                if grouped and self.op_n > 0:
                    # group mode keeps ops only in the WAL: a clean close
                    # snapshots, so the file is self-contained and the WAL
                    # can be dropped. A failed snapshot leaves the ops in
                    # their segments for the next open's recover().
                    try:
                        self._snapshot_locked()
                    except OSError:
                        pass
                try:
                    if not self._cache_saved:
                        self.row_cache.save(self.path + ROW_CACHE_SUFFIX)
                except OSError:
                    pass  # derived data: recalculate_cache rebuilds it
            elif grouped:
                self.wal.discard_key(self.wal_key)
            if self._file is not None:
                if self.op_n > 0 and not discard and not grouped:
                    # flush-only's op tail: one fsync a fragment at close
                    try:
                        self._file.flush()
                        os.fsync(self._file.fileno())
                    except OSError:
                        pass
                self._file.close()
                self._file = None
            if self.cache is not None:
                self.cache.invalidate_fragment(self.frag_id)
            # a delete or a swap changes what this fragment answers next
            rescache.invalidate_write(self.scope, self.index, self.field,
                                      self.shard)
            self._open = False

    # ----------------------------------------------------------------- reads

    def row_words(self, row: int) -> np.ndarray:
        """Dense uint32[32768] for one row (host side): one flatten of the
        row's 16-container window and one batched decode. Under a
        request's cost context the window's containers are tallied by
        type, once a decode (only residency misses decode)."""
        base_key = (row << 20) >> 16
        flat = kernels.flatten(self.bitmap, base_key, base_key + 15)
        cost = current_cost()
        if cost is not None:
            cost.note_containers(*flat.kind_counts())
        return kernels.dense_words32(flat, base_key, 16)

    def count_row(self, row: int) -> int:
        base = row << 20
        return self.bitmap.count_range(base, base + SHARD_WIDTH)

    def contains(self, row: int, pos: int) -> bool:
        return (row << 20) + pos in self.bitmap

    def row_ids(self) -> list[int]:
        """Rows with a container (every such row is non-empty: writes
        drop empty containers)."""
        return sorted({k >> 4 for k in list(self.bitmap.keys)})

    def row_columns(self, row: int) -> np.ndarray:
        """Sorted in-shard positions set in ``row`` (uint64)."""
        return unpack_bits(self.row_words(row))

    def row_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """Exact (row_ids, counts) of every row with a container, from
        container metadata alone: a row spans 16 containers (key >> 4) and
        each container knows its cardinality. Empty containers are dropped
        by every write, so every listed row is non-empty. Memoized on the
        mutation counter, read BEFORE the pass, so a racing write forces a
        recount and never a stale hit. Callers must not mutate the
        returned arrays."""
        memo = self._row_counts_memo
        if memo is not None and memo[0] == self.mutations:
            return memo[1]
        version = self.mutations
        flat = kernels.flatten(self.bitmap)  # metadata of every container
        if flat.n_containers == 0:
            out = (np.empty(0, np.int64), np.empty(0, np.int64))
        else:
            rows, inv = np.unique(flat.keys >> 4, return_inverse=True)
            counts = np.zeros(rows.size, np.int64)
            np.add.at(counts, inv, flat.cards)
            out = (rows, counts)
        for a in out:
            a.setflags(write=False)
        self._row_counts_memo = (version, out)
        return out

    def rows_containing(self, pos: int) -> list[int]:
        """All rows with bit ``pos`` set (Rows(column=)): only the
        (key & 15) == pos >> 16 container of each row can hold it."""
        keys = list(self.bitmap.keys)
        if not keys:
            return []
        arr = np.array(keys, np.int64)
        low = pos & 0xFFFF
        out = []
        for key in arr[(arr & 15) == (pos >> 16)].tolist():
            c = self.bitmap.container(key)
            if c is not None and c.contains_low(low):
                out.append(key >> 4)
        return out

    def top(self, n: int = 10, row_ids=None) -> list[tuple[int, int]]:
        """TopN phase-1 candidates of this fragment: (row, count) pairs by
        count descending, then row, the first ``n`` (all for n = 0). As
        in the reference, they come from the row cache (a ranked cache
        keeps its ``cache_size`` highest rows, an LRU one its last
        written), from the exact counts when the cache is empty, or from
        the exact counts of ``row_ids`` when given. The ranking is
        memoized on the mutation counter and the cache."""
        if row_ids is not None:
            ranked = _ranked((r, self.count_row(r)) for r in row_ids)
            return ranked[:n] if n else ranked
        memo = self._top_memo
        cache = self.row_cache  # recalculate_cache swaps it
        if memo is None or memo[0] != self.mutations or memo[1] is not cache:
            version = self.mutations
            pairs = cache.top()
            if not pairs:
                rows, counts = self.row_counts()
                pairs = zip(rows.tolist(), counts.tolist())
            memo = self._top_memo = (version, cache, _ranked(pairs))
        return memo[2][:n] if n else list(memo[2])

    # ---------------------------------------------------------------- writes

    def set_bit(self, row: int, pos: int) -> bool:
        self._check_pos(pos)
        with self.lock:
            changed = self.bitmap.add_ids([(row << 20) + pos]) > 0
            if changed:
                self._log_op(OP_ADD, [(row << 20) + pos])
                self._after_row_write(row, [pos], added=True)
                self._note_write(1)
            return changed

    def clear_bit(self, row: int, pos: int) -> bool:
        self._check_pos(pos)
        with self.lock:
            changed = self.bitmap.remove_ids([(row << 20) + pos]) > 0
            if changed:
                self._log_op(OP_REMOVE, [(row << 20) + pos])
                self._after_row_write(row, [pos], added=False)
                self._note_write(1)
            return changed

    def clear_row(self, row: int) -> int:
        """Remove every bit of a row (ClearRow), logged as one REMOVE
        record; its write event carries the whole row's positions.
        Returns the number of bits cleared."""
        with self.lock:
            cols = self.row_columns(row)
            if cols.size == 0:
                return 0
            ids = cols + np.uint64(row << 20)
            removed = self.bitmap.remove_ids(ids)
            self._log_op(OP_REMOVE, ids)
            self._after_row_write(row, cols, added=False)
            self._note_write(1)
            return removed

    def write_row_words(self, row: int, words: np.ndarray) -> None:
        """Replace a row with dense words (Store), logged as a REMOVE of
        the old bits and an ADD of the new ones, each when non-empty; its
        write event carries no positions (the row is re-read)."""
        with self.lock:
            base = np.uint64(row << 20)
            old = self.row_columns(row) + base
            new = unpack_bits(words) + base
            if old.size:
                self.bitmap.remove_ids(old)
                self._log_op(OP_REMOVE, old)
            if new.size:
                self.bitmap.add_ids(new)
                self._log_op(OP_ADD, new)
            self._after_row_write(row, None, added=None)
            self._note_write(1)

    def bulk_import(self, rows, positions) -> int:
        """Batched import of (row, position) pairs (reference
        fragment.bulkImport). Returns #bits changed."""
        rows = np.asarray(rows, dtype=np.uint64)
        positions = np.asarray(positions, dtype=np.uint64)
        if rows.shape != positions.shape:
            raise ValueError("rows and positions must have identical shape")
        if positions.size and positions.max() >= SHARD_WIDTH:
            raise ValueError("position out of shard range")
        ids = (rows << np.uint64(20)) + positions
        with self.lock:
            changed = self.bitmap.add_ids(ids)
            if changed:
                self._log_op(OP_ADD, ids)
                groups = list(_group_by_row(rows, positions))
                for row, p in groups:
                    self._after_row_write(row, p, added=True)
                self._note_write(rows.size, len(groups))
            return changed

    def add_ids(self, ids) -> int:
        """Union raw bit ids (``row << 20 | position``) under the fragment
        lock (``import-roaring``). Returns #bits changed."""
        ids = np.asarray(ids, np.uint64)
        with self.lock:
            changed = self.bitmap.add_ids(ids)
            if changed:
                self._log_op(OP_ADD, ids)
                self._after_rows_added(ids >> np.uint64(20),
                                       ids & np.uint64(SHARD_WIDTH - 1))
            return changed

    def _after_rows_added(self, rows: np.ndarray,
                          positions: np.ndarray) -> None:
        """The write bookkeeping of a bulk add: positions grouped by row
        with one sort, and past a few rows one ``row_counts()`` pass for
        the row cache instead of a count a row."""
        groups = list(_group_by_row(rows, positions))
        counts = None
        if len(groups) > 8:
            r_ids, r_counts = self.row_counts()
            counts = dict(zip(r_ids.tolist(), r_counts.tolist()))
        for row, p in groups:
            self._after_row_write(
                row, p, added=True,
                row_count=None if counts is None else counts.get(row, 0))
        self._note_write(rows.size, len(groups))

    def import_mutex(self, rows, positions) -> int:
        """Mutex-aware batched import (reference
        fragment.bulkImportMutex): each column's previous row clears in
        the same locked pass, one ADD and one REMOVE record for the
        batch. Duplicate positions keep the LAST row. Returns the number
        of columns whose bit was newly set (a moved column counts once, a
        column already in its row not at all)."""
        rows = np.asarray(rows, np.uint64)
        positions = np.asarray(positions, np.uint64)
        if rows.shape != positions.shape:
            raise ValueError("rows and positions must have identical shape")
        if positions.size == 0:
            return 0
        if int(positions.max()) >= SHARD_WIDTH:
            raise ValueError("position out of shard range")
        keep = keep_last_unique(positions)
        rows, positions = rows[keep], positions[keep]
        with self.lock:
            cur_rows, cur_idx = merge_kernels.set_rows_for_positions(
                self.bitmap, positions)
            conflict = cur_rows.astype(np.uint64) != rows[cur_idx]
            target_set = np.zeros(positions.size, bool)
            target_set[cur_idx[~conflict]] = True
            removed = list(_group_by_row(cur_rows[conflict],
                                         positions[cur_idx[conflict]]))
            add_m = ~target_set
            added = list(_group_by_row(rows[add_m], positions[add_m]))
            for parts, op, bitmap_op in ((added, OP_ADD, self.bitmap.add_ids),
                                         (removed, OP_REMOVE,
                                          self.bitmap.remove_ids)):
                if parts:
                    ids = np.sort(np.concatenate(
                        [(np.uint64(r) << np.uint64(20)) + p
                         for r, p in parts]))
                    bitmap_op(ids)
                    self._log_op(op, ids)
            for r, p in added:
                self._after_row_write(r, p, added=True)
            for r, p in removed:
                self._after_row_write(r, p, added=False)
            self._note_batch_write(added, removed)
            return int(add_m.sum())

    def import_bsi(self, positions, stored, bit_depth: int,
                   exists_row: int = 0, offset_row: int = 2) -> int:
        """Batched BSI write (reference fragment.importValue): one lock,
        one logged add op and one logged remove op for a whole (position,
        stored-value) batch. ``positions`` must be duplicate-free. Every
        touched plane row emits one write event carrying its positions,
        so resident plane leaves are patched, not re-decoded. Returns the
        number of columns whose existence or stored value changed."""
        positions = np.asarray(positions, np.uint64)
        stored = np.asarray(stored, np.uint64)
        if positions.size and int(positions.max()) >= SHARD_WIDTH:
            raise ValueError("position out of shard range")
        with self.lock:
            added: list = []
            removed: list = []
            # the exists row and every bit plane probed in one batched
            # pass
            member = merge_kernels.member_matrix(
                self.bitmap,
                [exists_row] + [offset_row + i for i in range(bit_depth)],
                positions)
            exists_new = ~member[0]
            changed = exists_new.copy()
            if exists_new.any():
                added.append((exists_row, positions[exists_new]))
            for i in range(bit_depth):
                want = ((stored >> np.uint64(i)) & np.uint64(1)) == 1
                cur = member[1 + i]
                add_m, rem_m = want & ~cur, ~want & cur
                if add_m.any():
                    added.append((offset_row + i, positions[add_m]))
                if rem_m.any():
                    removed.append((offset_row + i, positions[rem_m]))
                changed |= add_m | rem_m
            if not changed.any():
                return 0
            for parts, op, bitmap_op in ((added, OP_ADD, self.bitmap.add_ids),
                                         (removed, OP_REMOVE,
                                          self.bitmap.remove_ids)):
                if parts:
                    ids = np.sort(np.concatenate(
                        [(np.uint64(r) << np.uint64(20)) + p
                         for r, p in parts]))
                    bitmap_op(ids)
                    self._log_op(op, ids)
            for r, p in added:
                self._after_row_write(r, p, added=True)
            for r, p in removed:
                self._after_row_write(r, p, added=False)
            self._note_batch_write(added, removed)
            return int(changed.sum())

    def replace_bitmap(self, bitmap: RoaringBitmap, rows) -> None:
        """Install a whole new bitmap (bulk dense load) as a fresh
        snapshot; ``rows`` are the rows whose content changed."""
        with self.lock:
            self.bitmap = bitmap
            self.mutations += 1
            self._snapshot_locked()
            r_ids, r_counts = self.row_counts()
            counts = dict(zip(r_ids.tolist(), r_counts.tolist()))
            for row in sorted(int(r) for r in rows):
                self._after_row_write(row, None, added=None,
                                      row_count=counts.get(row, 0))
            rescache.invalidate_write(self.scope, self.index, self.field,
                                      self.shard)

    def recalculate_cache(self) -> None:
        """Rebuild the row cache from exact container cardinalities and
        save it (``POST /recalculate-caches``)."""
        with self.lock:
            if not self._open:
                return
            fresh = new_row_cache(self.row_cache.kind,
                                  self.row_cache.max_size)
            rows, counts = self.row_counts()
            for r, c in zip(rows.tolist(), counts.tolist()):
                fresh.bulk_add(r, c)
            self.row_cache = fresh
            self.row_cache.save(self.path + ROW_CACHE_SUFFIX)
            self._cache_saved = True

    # ------------------------------------------------------------ durability

    def _log_op(self, op: int, ids) -> None:
        if not self._open:
            raise RuntimeError(f"fragment {self.path} is closed")
        record = encode_op(op, ids)
        wal = self.wal
        if wal is not None and wal.grouped:
            # the record rides the holder's WAL; the ACK point barriers on
            # it, so the mutator never waits on the disk under this lock
            wal.append_op(self.wal_key, record, self)
        else:
            if self._file is None:
                # opened at the first record appended here: a group-mode
                # holder keeps no descriptor a fragment (a YMDH field at
                # 1024 shards holds tens of thousands of them, past common
                # open-file limits)
                self._file = open(self.path, "ab")
            self._file.write(record)
            self._file.flush()
            if wal is None or wal.mode == MODE_PER_OP:
                try:
                    faults.disk_check("fsync", self.path)
                    wal_fsync(self._file.fileno())
                except OSError as e:
                    self._trip_health(f"per-op fsync of {self.path}: {e}")
                    raise
        self.op_n += 1
        if self.op_n > self.snapshot_threshold:
            self._snapshot_locked()

    def apply_recovered(self, op: int, ids) -> None:
        """Apply one replayed WAL op (holder open): the bitmap change
        without logging; the caller snapshots and recounts the row cache
        once per touched fragment afterwards. Dependent resident leaves
        are invalidated or rebuilt from the host, not patched."""
        ids = np.atleast_1d(np.asarray(ids, np.uint64))
        with self.lock:
            if op == OP_ADD:
                self.bitmap.add_ids(ids)
            else:
                self.bitmap.remove_ids(ids)
            self.mutations += 1
        if self.cache is not None:
            self.cache.invalidate_fragment(self.frag_id)
            for row in np.unique(ids >> np.uint64(20)).tolist():
                self.cache.apply_write(WriteEvent(
                    self.index, self.field, self.view, self.shard, row,
                    scope=self.scope))
        rescache.invalidate_write(self.scope, self.index, self.field,
                                  self.shard)

    def snapshot(self) -> None:
        """Compact: rewrite the file as a clean snapshot, dropping the log."""
        with self.lock:
            self._snapshot_locked()

    def _snapshot_locked(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        tmp = self.path + ".snapshotting"
        try:
            payload = faults.disk_filter_write(  # the torn-write seam
                self.path, serialize(self.bitmap))
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                faults.disk_check("fsync", self.path)
                os.fsync(f.fileno())
            # the old digests must go before the new snapshot is
            # published: a crash between the two would pair the new
            # bytes with stale digests and quarantine a healthy file
            _unlink(self.path + CHECKSUM_SUFFIX)
            os.replace(tmp, self.path)
        except OSError as e:
            # the old file is intact (tmp, then rename): reads go on, and
            # the node turns read-only until the disk answers again
            self._trip_health(f"snapshot of {self.path}: {e}")
            raise
        fsync_dir(os.path.dirname(self.path))
        # the digests of exactly these bytes, for verify-on-load. A
        # failed sidecar only makes the next open unverified: it never
        # condemns the snapshot beside it
        try:
            save_checksums(self.path + CHECKSUM_SUFFIX,
                           block_digests(self.bitmap.iter_ids(), BLOCK_ROWS))
        except OSError as e:
            self._trip_health(f"checksum sidecar of {self.path}: {e}")
        if self.wal is not None:
            # the lock is held: every op of this fragment appended so far
            # is in the snapshot and no longer pins a WAL segment
            self.wal.note_snapshot(self.wal_key, self.wal.current_seq())
        self.op_n = 0

    def _after_row_write(self, row: int, positions, added,
                         row_count: int | None = None) -> None:
        self.mutations += 1
        self._cache_saved = False
        self.row_cache.add(row, self.count_row(row) if row_count is None
                           else row_count)
        if self.cache is not None:
            self.cache.apply_write(WriteEvent(
                self.index, self.field, self.view, self.shard, row,
                positions=positions, added=added, scope=self.scope,
            ))

    def _note_write(self, n: int, rows: int = 1) -> None:
        """The write point of one change of ``n`` bits over ``rows`` rows
        (the reference's): the result cache's entries that depend on
        this (index, field, shard) die here, before the write's ACK
        barrier releases its 200, whether or not the cost plane is on;
        one ``fragment_row_writes`` count a row; and under a request's
        cost context, the write heat of a PQL write (bulk imports record
        theirs at the API; see ``storage/heat.py``)."""
        rescache.invalidate_write(self.scope, self.index, self.field,
                                  self.shard)
        global_stats().count("fragment_row_writes", rows)
        if current_cost() is not None:
            heat.global_heat().record_write(self.index, self.field,
                                            self.shard, n=float(n),
                                            scope=self.scope)

    def _note_batch_write(self, added, removed) -> None:
        """One write point for a batch of rows, weighted by its bits."""
        if added or removed:
            self._note_write(sum(len(p) for _, p in added)
                             + sum(len(p) for _, p in removed),
                             len(added) + len(removed))

    def _trip_health(self, reason: str) -> None:
        """Route a disk fault to the holder's StorageHealth latch through
        the WAL it threads down; a fragment built without one raises
        only."""
        health = getattr(self.wal, "health", None)
        if health is not None:
            health.trip(reason)

    def _check_pos(self, pos: int) -> None:
        if not 0 <= pos < SHARD_WIDTH:
            raise ValueError(f"position {pos} outside shard width {SHARD_WIDTH}")

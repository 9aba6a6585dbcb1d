"""Per-holder write-ahead log with group commit (reference storage/wal.py).

The port's copy of ``pilosa_tpu.storage.wal``, byte for byte in what it
writes: concurrent writers append op records into one holder-level log,
a commit thread issues one flush+fsync for the whole group, and only then
are the waiting acknowledgements released.

Three durability modes (the ``durability-mode`` server knob):

- ``group`` (default): ops append to the WAL; fragment files hold only
  snapshots. The ACK barrier (server/api.py) releases once the record's
  group has been fsynced. Fragment snapshots (threshold compaction,
  checkpoint, clean close) make WAL segments garbage-collectable.
- ``per-op``: every op record fsyncs the fragment's own file before the
  mutator returns.
- ``flush-only``: append+flush to the fragment's file, no fsync on the
  write path. Survives SIGKILL (the OS buffer outlives the process) but
  not power loss.

Recovery: ``recover()`` replays surviving segments on holder open, in
any mode. Op replay is a suffix re-application (every bit ends at its
last op's value), so replay needs no per-fragment positions, only two
invariants: a segment is deleted once every fragment with ops in it has
snapshotted at or past them, and segments are reclaimed oldest-first so
the survivors are always a contiguous tail of the log. Replayed fragments
are snapshotted at once and the segments dropped.

Segment record layout (little-endian):
  magic uint16 = 0x574C ('WL'), rtype uint16 (1=op 2=tombstone),
  keylen uint16, bodylen uint32, crc32 uint32 (over key+body),
  key bytes (utf-8 "index/field/view/shard"; tombstone keys are either
  a "/"-terminated prefix for index/field deletes or an exact fragment
  key for shard deletes, see tombstone_matches),
  body bytes (for ops: one roaring/format.py encode_op record).
A torn tail (crash mid-append) is dropped.

Disk faults: a failed group fsync (the ``disk_check("fsync", segment)``
seam of ``testing/faults.py`` sits before it) loses that group. Its
sequence numbers are latched (``_failed_seq``) so their barriers raise
forever, the holder's ``StorageHealth`` trips, and the commit loop parks
until the health probe calls ``clear_fault``, which opens a fresh segment
(the faulted one may end in a tear) before writes resume.

Not ported yet: the CDC cursor registry and ``read_tail``.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import weakref
import zlib

import numpy as np

from pilosa_tpu_torch.roaring.format import _OP_HEADER, OP_MAGIC
from pilosa_tpu_torch.testing import faults

_LOG = logging.getLogger("pilosa_tpu_torch.storage.wal")

MODE_GROUP = "group"
MODE_PER_OP = "per-op"
MODE_FLUSH_ONLY = "flush-only"
DURABILITY_MODES = (MODE_GROUP, MODE_PER_OP, MODE_FLUSH_ONLY)

# Group forming window / size bound (group-commit-max-ms /
# group-commit-max-ops): a record never waits longer than the window
# before its group's fsync starts, and a group never exceeds max-ops.
DEFAULT_GROUP_MAX_MS = 2.0
DEFAULT_GROUP_MAX_OPS = 256

# Rotate the active segment past this size; rotation checkpoints the
# fragments still pinning closed segments, so the WAL stays bounded by
# about two segments in steady state.
SEGMENT_MAX_BYTES = 16 << 20

WAL_MAGIC = 0x574C
REC_OP = 1
REC_TOMBSTONE = 2
_REC_HEADER = struct.Struct("<HHHII")


def wal_fsync(fd: int) -> None:
    """The op-log fsync: group segments and per-op fragment files."""
    os.fsync(fd)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync, so a rename, create or unlink in
    ``path`` survives a power cut; file systems that refuse directory
    fsync are passed over."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _check_mode(mode: str) -> None:
    if mode not in DURABILITY_MODES:
        raise ValueError(f"invalid durability mode {mode!r} "
                         f"(want one of {', '.join(DURABILITY_MODES)})")


def encode_wal_record(rtype: int, key: str, body: bytes = b"") -> bytes:
    kb = key.encode()
    crc = zlib.crc32(kb + body)
    return _REC_HEADER.pack(WAL_MAGIC, rtype, len(kb), len(body), crc) + kb + body


def iter_wal_records(buf: bytes):
    """Yield (rtype, key, body) records; stops at a torn or corrupt tail."""
    view = memoryview(buf)
    pos = 0
    while pos + _REC_HEADER.size <= len(view):
        magic, rtype, keylen, bodylen, crc = _REC_HEADER.unpack_from(view, pos)
        if magic != WAL_MAGIC:
            return
        end = pos + _REC_HEADER.size + keylen + bodylen
        if end > len(view):
            return  # torn write
        kb = bytes(view[pos + _REC_HEADER.size:pos + _REC_HEADER.size + keylen])
        body = bytes(view[pos + _REC_HEADER.size + keylen:end])
        if zlib.crc32(kb + body) != crc:
            return  # corrupt tail
        yield rtype, kb.decode(errors="replace"), body
        pos = end


def decode_op_body(body: bytes):
    """One op body (a fragment op-log record) back to (op, ids)."""
    if len(body) < _OP_HEADER.size:
        raise ValueError("wal: truncated op body")
    magic, op, id_count, crc = _OP_HEADER.unpack_from(body, 0)
    if magic != OP_MAGIC:
        raise ValueError("wal: bad op magic")
    raw = body[_OP_HEADER.size:_OP_HEADER.size + id_count * 8]
    if len(raw) != id_count * 8 or zlib.crc32(raw) != crc:
        raise ValueError("wal: corrupt op body")
    return op, np.frombuffer(raw, dtype="<u8")


def tombstone_matches(key: str, tomb: str) -> bool:
    """True when tombstone ``tomb`` deletes fragment ``key``: a
    "/"-terminated prefix matches everything under it, an exact fragment
    key only itself (shard 1's must not swallow shards 10-19)."""
    if tomb.endswith("/"):
        return key.startswith(tomb)
    return key == tomb


class _Segment:
    __slots__ = ("path", "start_seq", "last_seq", "nbytes")

    def __init__(self, path: str, start_seq: int):
        self.path = path
        self.start_seq = start_seq
        self.last_seq: dict[str, int] = {}  # op key -> last seq written
        self.nbytes = 0


class WriteAheadLog:
    """Holder-scoped op durability: group-commit segments in
    ``<data-dir>/.wal/`` plus the mode switch the fragment write path
    consults. Fragments call ``append_op`` / ``note_snapshot``; the API
    calls ``barrier()`` at every write acknowledgement."""

    def __init__(self, dir_path: str, mode: str = MODE_GROUP,
                 group_max_ms: float = DEFAULT_GROUP_MAX_MS,
                 group_max_ops: int = DEFAULT_GROUP_MAX_OPS):
        _check_mode(mode)
        self.dir = dir_path
        self.mode = mode
        self.group_max_ms = max(0.0, float(group_max_ms))
        self.group_max_ops = max(1, int(group_max_ops))
        self._fsync = wal_fsync
        self._cond = threading.Condition()
        # (key, encoded record, seq, fragment, rtype) pending the next group
        self._buffer: list = []
        self._seq = 0
        self._durable_seq = 0
        self._group_open_t = 0.0
        self._last_group_size = 0
        self._error: BaseException | None = None
        # highest seq whose group's fsync failed: those records are lost,
        # so a barrier on them raises forever, even once newer groups
        # commit past them
        self._failed_seq = 0
        self._closing = False
        # the holder's StorageHealth latch: a commit fault trips it, and
        # its probe calls clear_fault() once the disk answers again
        self.health = None
        self._thread: threading.Thread | None = None
        self._started = False
        # segment bookkeeping (commit/checkpoint threads + note_snapshot)
        self._seg_lock = threading.Lock()
        self._segments: list[_Segment] = []
        self._active: _Segment | None = None
        self._file = None
        self._snap_seq: dict[str, int] = {}
        self._tombstones: list[tuple[str, int]] = []
        self._dirty: dict[str, weakref.ref] = {}
        self._checkpointing = False
        self.groups = 0
        self.fsyncs = 0
        self.appended_ops = 0
        self.wal_bytes = 0
        self.max_group_ops = 0
        self.checkpoints = 0
        self.recovered_ops = 0
        self.commit_recoveries = 0

    # ------------------------------------------------------------ lifecycle

    @property
    def grouped(self) -> bool:
        """True when ops ride the WAL instead of fragment files."""
        return self.mode == MODE_GROUP and self._started

    def start(self) -> None:
        """Open the active segment and the commit thread (group mode only;
        the other modes need no WAL machinery)."""
        if self.mode != MODE_GROUP or self._started:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._open_segment()
        self._started = True
        self._thread = threading.Thread(target=self._commit_loop,
                                        daemon=True, name="wal-commit")
        self._thread.start()

    def _open_segment(self) -> None:
        with self._seg_lock:
            numbers = [int(os.path.basename(s.path).split(".")[0])
                       for s in self._segments]
            if os.path.isdir(self.dir):
                numbers += [int(e.split(".")[0]) for e in os.listdir(self.dir)
                            if e.endswith(".log") and e.split(".")[0].isdigit()]
            path = os.path.join(self.dir,
                                f"{max(numbers, default=0) + 1:08d}.log")
            if self._file is not None:
                self._file.close()
            self._file = open(path, "ab")
            seg = _Segment(path, self._seq + 1)
            self._segments.append(seg)
            self._active = seg
        fsync_dir(self.dir)

    def close(self) -> None:
        """Flush pending groups, stop the commit thread, and drop every
        segment whose ops are covered by durable snapshots (a clean close,
        where fragments snapshotted on their way down, leaves an empty
        WAL; a failed snapshot leaves its segment for recover())."""
        t = self._thread
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if t is not None:
            t.join(30)
            if t.is_alive():
                # still draining (or wedged in a slow fsync): closing the
                # file under it would truncate the shutdown flush silently.
                # Keep every segment for the next open's recover() and
                # fail future barriers instead of acking volatile writes.
                with self._cond:
                    if self._error is None:
                        self._error = OSError(
                            "wal close timed out with commit backlog")
                    self._cond.notify_all()
                _LOG.error("wal: commit thread did not drain within 30s on "
                           "close; leaving segments in %s for recovery",
                           self.dir)
                self._thread = None
                self._started = False
                return
        self._thread = None
        self._started = False
        with self._seg_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
        self._gc_segments(include_active=True)

    # ------------------------------------------------------------ write path

    def _enqueue(self, key: str, rtype: int, record: bytes, frag) -> int:
        with self._cond:
            if rtype == REC_OP and self._error is not None:
                raise OSError(f"wal commit failed: {self._error}")
            self._seq += 1
            seq = self._seq
            if not self._buffer:
                self._group_open_t = time.monotonic()
            self._buffer.append((key, record, seq, frag, rtype))
            self._cond.notify_all()
        return seq

    def append_op(self, key: str, record: bytes, frag=None) -> int:
        """Queue one op record for the next group; returns its sequence
        number (the ACK point's ``barrier()`` waits, not this). Called
        under the fragment lock; the critical section is a list append."""
        return self._enqueue(key, REC_OP,
                             encode_wal_record(REC_OP, key, record), frag)

    def tombstone(self, prefix: str) -> None:
        """Record a delete of every fragment ``prefix`` matches
        (tombstone_matches): replay must not resurrect its ops into a
        later re-creation. Registered for segment GC only once durable;
        callers that need it on disk follow with ``barrier()``."""
        if self.grouped:
            self._enqueue(prefix, REC_TOMBSTONE,
                          encode_wal_record(REC_TOMBSTONE, prefix), None)

    def note_snapshot(self, key: str, seq: int) -> None:
        """A fragment's snapshot (fsynced file + dir) now covers all its
        ops up to ``seq``: they no longer pin WAL segments."""
        with self._seg_lock:
            if seq > self._snap_seq.get(key, -1):
                self._snap_seq[key] = seq

    def discard_key(self, key: str) -> None:
        """A deleted fragment's ops need no preserving: release their
        segment pins (the durable tombstone still rules replay)."""
        with self._cond:
            seq = self._seq
        with self._seg_lock:
            if seq > self._snap_seq.get(key, -1):
                self._snap_seq[key] = seq
            self._dirty.pop(key, None)

    def current_seq(self) -> int:
        with self._cond:
            return self._seq

    def durable_seq(self) -> int:
        with self._cond:
            return self._durable_seq

    def barrier(self, seq: int | None = None) -> None:
        """Block until every op appended so far (or up to ``seq``) is
        durable: the write ACK gate. No-op outside group mode (per-op
        fsyncs inline; flush-only promises nothing)."""
        if not self.grouped:
            return
        with self._cond:
            target = self._seq if seq is None else seq
            # before the durable check: a recovered WAL commits newer
            # groups past a lost one, whose writes must never be acked
            if 0 < target <= self._failed_seq:
                raise OSError("wal commit failed: this write's group was "
                              "lost to a storage fault")
            while self._durable_seq < target:
                if self._error is not None:
                    raise OSError(f"wal commit failed: {self._error}")
                if self._closing and self._thread is None:
                    raise OSError("wal closed with ops pending")
                t = self._thread
                if t is not None and not t.is_alive():
                    raise OSError("wal commit thread died")
                self._cond.wait(1.0)

    def flush(self) -> None:
        self.barrier()

    def clear_fault(self) -> bool:
        """The disk answers again (the health probe's write succeeded):
        resume committing into a fresh segment, opened before the fault
        is cleared, since the faulted segment may end in a tear that
        replay stops at. False keeps the node degraded (no segment could
        be opened)."""
        with self._cond:
            if self._error is None:
                return True
        if self._started:
            try:
                self._open_segment()
            except OSError:
                return False
        with self._cond:
            self._error = None
            self._cond.notify_all()
        self.commit_recoveries += 1
        return True

    # ---------------------------------------------------------- commit loop

    def _commit_loop(self) -> None:
        # any escape must record an error and wake the barrier waiters: a
        # silently dead commit thread would wedge every write ACK
        try:
            self._run_commits()
        except BaseException as e:
            with self._cond:
                if self._error is None:
                    self._error = e
                self._cond.notify_all()

    def _run_commits(self) -> None:
        while True:
            with self._cond:
                while ((not self._buffer or self._error is not None)
                       and not self._closing):
                    self._cond.wait(0.5 if self._error is not None else None)
                if self._closing and (not self._buffer
                                      or self._error is not None):
                    break
                # Self-latching forming window: hold the group open up to
                # max_ms only with evidence of concurrency (this group
                # already has more than one record, or the previous one
                # did). A solo serial writer never waits.
                if (self.group_max_ms > 0 and not self._closing
                        and (len(self._buffer) > 1
                             or self._last_group_size > 1)):
                    deadline = self._group_open_t + self.group_max_ms / 1e3
                    while (len(self._buffer) < self.group_max_ops
                           and not self._closing):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                batch = self._buffer[:self.group_max_ops]
                self._buffer = self._buffer[self.group_max_ops:]
                self._last_group_size = len(batch)
                if self._buffer:
                    self._group_open_t = time.monotonic()
            end_seq = batch[-1][2]
            data = b"".join(rec for _, rec, _, _, _ in batch)
            try:
                with self._seg_lock:
                    f, seg = self._file, self._active
                    f.write(data)
                    f.flush()
                faults.disk_check("fsync", seg.path)
                self._fsync(f.fileno())
            except (OSError, ValueError) as e:
                # this group is lost (its bytes may be a torn tail): its
                # barriers fail forever, the node turns read-only, and
                # the loop parks until clear_fault(). The waiters wake
                # only after the trip, so a write that learns of the
                # loss finds the latch set
                with self._cond:
                    self._error = e
                    self._failed_seq = max(self._failed_seq, end_seq)
                if self.health is not None:
                    self.health.trip(f"wal commit fsync: {e}")
                with self._cond:
                    self._cond.notify_all()
                continue
            with self._seg_lock:
                seg.nbytes += len(data)
                for key, _, seq, frag, rtype in batch:
                    if rtype == REC_TOMBSTONE:
                        # registered only now, post-fsync: GC must never
                        # drop op segments on a tombstone a crash could
                        # still erase
                        self._tombstones.append((key, seq))
                        for k in list(self._dirty):
                            if tombstone_matches(k, key):
                                del self._dirty[k]
                        continue
                    seg.last_seq[key] = seq
                    if frag is not None:
                        self._dirty[key] = weakref.ref(frag)
            self.groups += 1
            self.fsyncs += 1
            self.appended_ops += len(batch)
            self.wal_bytes += len(data)
            self.max_group_ops = max(self.max_group_ops, len(batch))
            with self._cond:
                self._durable_seq = max(self._durable_seq, end_seq)
                self._cond.notify_all()
            if seg.nbytes > SEGMENT_MAX_BYTES and not self._closing:
                self._open_segment()
                self._spawn_checkpoint()

    # ------------------------------------------------- checkpoint / segments

    def _covered(self, key: str, last_seq: int) -> bool:
        if self._snap_seq.get(key, -1) >= last_seq:
            return True
        return any(ts_seq >= last_seq and tombstone_matches(key, prefix)
                   for prefix, ts_seq in self._tombstones)

    def _gc_segments(self, include_active: bool = False) -> None:
        """Reclaim covered segments oldest-first, stopping at the first
        that must stay: replay is a suffix re-application, so survivors
        must be a contiguous tail of the log, and a tombstone's segment
        must outlive every older segment holding ops it kills."""
        with self._seg_lock:
            keep = list(self._segments)
            while keep:
                seg = keep[0]
                if not include_active and seg is self._active:
                    break
                if not all(self._covered(k, s)
                           for k, s in seg.last_seq.items()):
                    break
                try:
                    os.unlink(seg.path)
                except OSError:
                    break
                keep.pop(0)
            if len(keep) != len(self._segments):
                self._segments = keep
                fsync_dir(self.dir)
            # tombstones older than every surviving segment can cover no
            # surviving or future op
            min_start = keep[0].start_seq if keep else self._seq + 1
            if self._tombstones:
                self._tombstones = [(p, s) for p, s in self._tombstones
                                    if s >= min_start]

    def _spawn_checkpoint(self) -> None:
        """Snapshot the fragments pinning closed segments, then GC, on a
        thread of its own so groups keep committing meanwhile."""
        with self._seg_lock:
            if self._checkpointing:
                return
            self._checkpointing = True
        threading.Thread(target=self._checkpoint, daemon=True,
                         name="wal-checkpoint").start()

    def _checkpoint(self) -> None:
        try:
            with self._seg_lock:
                pinned: dict[str, int] = {}
                for seg in self._segments:
                    if seg is self._active:
                        continue
                    for key, seq in seg.last_seq.items():
                        if not self._covered(key, seq):
                            pinned[key] = max(pinned.get(key, 0), seq)
                frags = [self._dirty.get(k) for k in pinned]
            for ref in frags:
                frag = ref() if ref is not None else None
                if frag is None or not frag._open:
                    continue
                try:
                    frag.snapshot()  # calls back into note_snapshot
                except OSError:
                    pass  # segment stays pinned; retried next rotation
            self.checkpoints += 1
            self._gc_segments()
        finally:
            with self._seg_lock:
                self._checkpointing = False

    # -------------------------------------------------------------- recovery

    def recover(self, holder) -> int:
        """Replay surviving segments into the holder's fragments (open
        time, single-threaded, any mode: a group-mode crash heals even if
        the restart is configured otherwise). Touched fragments are
        snapshotted (fresh .checksums) and their row caches recounted,
        and the segments deleted, so the state after open is
        self-contained fragment files and an empty WAL."""
        if not os.path.isdir(self.dir):
            return 0
        paths = sorted(os.path.join(self.dir, e) for e in os.listdir(self.dir)
                       if e.endswith(".log"))
        if not paths:
            return 0
        records = []
        for p in paths:
            with open(p, "rb") as f:
                records.extend(iter_wal_records(f.read()))
        # an op is dead if a later tombstone matches it
        tombs = [(i, key) for i, (rtype, key, _) in enumerate(records)
                 if rtype == REC_TOMBSTONE]
        # redo shard deletes: an exact-key tombstone whose fragment files
        # survived means the crash landed between the durable tombstone
        # and the unlinks. (Index/field deletes rename their directory
        # away before the tombstone is written.)
        for _, tk in tombs:
            parts = tk.split("/")
            if tk.endswith("/") or len(parts) != 4 or not parts[3].isdigit():
                continue
            idx = holder.index(parts[0])
            fld = idx.field(parts[1]) if idx is not None else None
            view = fld.views.get(parts[2]) if fld is not None else None
            if view is None:
                continue
            stale = view.fragments.pop(int(parts[3]), None)
            if stale is not None:
                stale.close(discard=True)
            frag_path = os.path.join(view.path, "fragments", parts[3])
            for p in (frag_path, frag_path + ".cache"):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
            # the unlink must be durable before the tombstone is erased
            fsync_dir(os.path.dirname(frag_path))
        applied = 0
        touched: dict[str, object] = {}
        for i, (rtype, key, body) in enumerate(records):
            if rtype != REC_OP:
                continue
            if any(ti > i and tombstone_matches(key, tk) for ti, tk in tombs):
                continue
            frag = self._resolve_fragment(holder, key)
            if frag is None:
                continue  # index/field deleted out from under the log
            try:
                op, ids = decode_op_body(body)
            except ValueError:
                continue  # corrupt record: skip, keep replaying
            frag.apply_recovered(op, ids)
            touched[key] = frag
            applied += 1
        for frag in touched.values():
            frag.snapshot()
            frag.recalculate_cache()  # replay bypassed the cache upkeep
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        fsync_dir(self.dir)
        self.recovered_ops += applied
        return applied

    @staticmethod
    def _resolve_fragment(holder, key: str):
        parts = key.split("/")
        if len(parts) != 4 or not parts[3].isdigit():
            return None
        index, field, view, shard = parts
        idx = holder.index(index)
        fld = idx.field(field) if idx is not None else None
        if fld is None:
            return None
        return fld.view(view, create=True).fragment(int(shard), create=True)

    # ---------------------------------------------------------------- stats

    def metrics(self) -> dict:
        with self._seg_lock:
            segments = len(self._segments)
            retained = sum(s.nbytes for s in self._segments)
        return {
            "groups_total": self.groups,
            "fsyncs_total": self.fsyncs,
            "appended_ops_total": self.appended_ops,
            "bytes_total": self.wal_bytes,
            "group_max_ops": self.max_group_ops,
            "checkpoints_total": self.checkpoints,
            "recovered_ops_total": self.recovered_ops,
            "commit_recoveries_total": self.commit_recoveries,
            "segments": segments,
            "retained_bytes": retained,
        }

"""Storage integrity: checksums, verified loads, quarantine, degradation.

The port's copy of ``pilosa_tpu.storage.integrity``, with the same bytes
on disk, so either package verifies and quarantines the other's files:

- **Checksum sidecars**: every snapshot writes the block digests of its
  bits beside the fragment file (``<fragment>.checksums``): per 100-row
  block, blake2b over the block's sorted bit ids, in self-checksummed
  JSON.
- **Verified loads**: opening a fragment decodes its snapshot with every
  decode error typed as ``CorruptFragmentError`` and, when a sidecar
  exists, compares the snapshot's digests with it before the op log is
  replayed. ``verify_fragment_file`` is the same check from the bytes on
  disk alone, shared by the scrubber (``parallel/scrub.py``) and the CLI
  ``check`` verb; its ``build_bitmap=False`` form digests the ids that
  ``roaring/kernels.py`` parses straight from the bytes.
- **Quarantine**: a fragment that fails verification is renamed, with
  its sidecars, to ``<name>.quarantine-<n>``, and is never decoded or
  served again (``View.open`` skips it, the scrubber re-snapshots it).
- **StorageHealth**: a failed WAL fsync, snapshot or ``.meta`` write
  trips the holder's latch; writes shed 503 and ``/status`` reports
  ``storageDegraded`` until a probe write into the data dir succeeds and
  the WAL reopens a fresh segment (``WriteAheadLog.clear_fault``).

Disk faults are injected through ``testing/faults.py``: every fragment
read here passes its seam.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import zlib

import numpy as np

from pilosa_tpu_torch.testing import faults

_LOG = logging.getLogger("pilosa_tpu_torch.storage.integrity")

# Sidecar beside every fragment snapshot holding its block digests.
CHECKSUM_SUFFIX = ".checksums"
# Quarantined artifacts: "<fragment>.quarantine-<n>", never decoded or
# served, skipped by every directory walk (View.open's isdigit filter).
QUARANTINE_MARK = ".quarantine-"
# Rows per checksum block (the reference fragment's BLOCK_ROWS).
BLOCK_ROWS = 100


class CorruptFragmentError(ValueError):
    """A fragment's bytes fail structural decode or digest verification;
    carries the path and the byte offset or block where known."""

    def __init__(self, path: str, reason: str, offset: int | None = None,
                 block: int | None = None):
        self.path = path
        self.reason = reason
        self.offset = offset
        self.block = block
        where = ""
        if offset is not None:
            where = f" at byte {offset}"
        elif block is not None:
            where = f" in checksum block {block}"
        super().__init__(f"corrupt fragment {path}{where}: {reason}")


# Decode failures that mean "these bytes are not a fragment".
DECODE_ERRORS = (ValueError, struct.error, zlib.error, OverflowError,
                 IndexError, MemoryError)


def block_digests(ids, block_rows: int = BLOCK_ROWS
                  ) -> list[tuple[int, str]]:
    """Per-block blake2b digests of a fragment's bit ids: for each block
    of ``block_rows`` rows, the digest of its ids as little-endian
    uint64. ``ids`` is one array, digested run by run of one block as
    the reference does (whatever its order: a corrupt file's ids may
    not be sorted), or an iterable of sorted consecutive arrays
    (``RoaringBitmap.iter_ids``), each split at block edges by binary
    search and hashed in place."""
    if isinstance(ids, np.ndarray):
        return _array_digests(ids, block_rows)
    span = np.uint64(block_rows) << np.uint64(20)
    out: list[tuple[int, str]] = []
    block, h = None, None
    for part in ids:
        if part.size == 0:
            continue
        part = np.ascontiguousarray(part, "<u8")
        first, last = int(part[0] // span), int(part[-1] // span)
        bounds = np.searchsorted(
            part, np.arange(first + 1, last + 1, dtype=np.uint64) * span)
        edges = [0, *bounds.tolist(), part.size]
        for b, lo, hi in zip(range(first, last + 1), edges, edges[1:]):
            if lo == hi:
                continue
            if b != block:
                if h is not None:
                    out.append((block, h.hexdigest()))
                block, h = b, hashlib.blake2b(digest_size=16)
            h.update(part[lo:hi])
    if h is not None:
        out.append((block, h.hexdigest()))
    return out


def _array_digests(ids: np.ndarray, block_rows: int
                   ) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    if ids.size:
        block_of = (ids >> np.uint64(20)) // block_rows
        boundaries = np.concatenate(
            ([0], np.nonzero(np.diff(block_of))[0] + 1, [ids.size]))
        for i in range(boundaries.size - 1):
            lo, hi = int(boundaries[i]), int(boundaries[i + 1])
            digest = hashlib.blake2b(ids[lo:hi].astype("<u8").tobytes(),
                                     digest_size=16).hexdigest()
            out.append((int(block_of[lo]), digest))
    return out


def save_checksums(path: str, blocks) -> None:
    """Persist a fragment's block digests atomically. Self-checksummed, so
    a torn sidecar reads as absent, not as a corrupt fragment."""
    body = json.dumps([[int(b), d] for b, d in blocks],
                      separators=(",", ":")).encode()
    payload = json.dumps(
        {"v": 1, "crc": zlib.crc32(body), "blocks": json.loads(body)},
        separators=(",", ":"),
    ).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checksums(path: str) -> list[tuple[int, str]] | None:
    """A checksum sidecar's digests; None when absent or torn (the load
    is then unverified)."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8", errors="strict"))
        blocks = doc["blocks"]
        body = json.dumps([[int(b), d] for b, d in blocks],
                          separators=(",", ":")).encode()
        if zlib.crc32(body) != doc["crc"]:
            return None
        return [(int(b), str(d)) for b, d in blocks]
    except (OSError, ValueError, KeyError, TypeError):
        return None


def verify_snapshot_blocks(bitmap, sidecar: list[tuple[int, str]],
                           path: str) -> None:
    """Compare a decoded snapshot's block digests with its sidecar (before
    op replay: the sidecar describes the snapshot alone). Raises
    CorruptFragmentError on the first block that differs."""
    if bitmap.keys and bitmap.keys[-1] >= 1 << 48:
        # only a corrupt snapshot has such a key: its ids wrap past 2^64,
        # and are listed and digested as the reference does
        from pilosa_tpu_torch.roaring import kernels

        ids = kernels.fragment_ids(kernels.flatten(bitmap))
    else:
        ids = bitmap.iter_ids()
    _check_digests(block_digests(ids), sidecar, path)


def _check_digests(live: list[tuple[int, str]],
                   sidecar: list[tuple[int, str]], path: str) -> None:
    if live == sidecar:
        return
    want = dict(sidecar)
    got = dict(live)
    for block in sorted(set(want) | set(got)):
        if want.get(block) != got.get(block):
            raise CorruptFragmentError(
                path,
                f"block digest mismatch (have {got.get(block)}, "
                f"checksum index says {want.get(block)})",
                block=block,
            )
    raise CorruptFragmentError(path, "block digest ordering mismatch")


def load_verified(data: bytes, path: str, verify: bool = False):
    """Decode a fragment file's snapshot with decode errors typed as
    CorruptFragmentError; with ``verify``, check its block digests
    against the sidecar when there is one. Returns (bitmap, ops_at); op
    replay stays with the caller."""
    from pilosa_tpu_torch.roaring.format import deserialize

    try:
        bitmap, ops_at = deserialize(data)
    except DECODE_ERRORS as e:
        raise _decode_error(path, data, e) from e
    if verify:
        sidecar = load_checksums(path + CHECKSUM_SUFFIX)
        if sidecar is not None:
            verify_snapshot_blocks(bitmap, sidecar, path)
            global_integrity().count("verified_loads")
        else:
            global_integrity().count("unverified_loads")
    return bitmap, ops_at


def read_file(path: str) -> bytes:
    """A whole fragment file, through the disk fault plane's read seam."""
    with open(path, "rb") as f:
        data = f.read()
    return faults.disk_filter_read(path, data)


def _decode_error(path: str, data: bytes,
                  e: Exception) -> CorruptFragmentError:
    # a truncation tears at EOF; other decode failures carry no reliable
    # offset, so the decoder's own message is reported instead
    offset = len(data) if "truncated" in str(e).lower() else None
    return CorruptFragmentError(path, f"snapshot decode failed: {e}",
                                offset=offset)


def verify_fragment_file(path: str, build_bitmap: bool = True):
    """The disk-versus-disk check shared by the scrubber and ``check``:
    read the file through the read seam, decode its snapshot with typed
    errors and, when a sidecar exists, compare its block digests. Raises
    CorruptFragmentError (OSError when the file cannot be read); returns
    (bitmap, data, ops_at). ``build_bitmap=False`` is the scrubber's
    fast path: the ids come straight from the bytes
    (``roaring/kernels.snapshot_ids``), the verdict is the same and the
    bitmap returned is None."""
    data = read_file(path)
    sidecar = load_checksums(path + CHECKSUM_SUFFIX)
    if not build_bitmap:
        from pilosa_tpu_torch.roaring import kernels

        try:
            ids, ops_at = kernels.snapshot_ids(data)
        except DECODE_ERRORS as e:
            raise _decode_error(path, data, e) from e
        if sidecar is not None:
            _check_digests(block_digests(ids), sidecar, path)
        return None, data, ops_at
    bitmap, ops_at = load_verified(data, path, verify=False)
    if sidecar is not None:
        verify_snapshot_blocks(bitmap, sidecar, path)
    return bitmap, data, ops_at


# ----------------------------------------------------------- quarantine


def quarantine_paths(path: str, reason: str = "") -> str:
    """Rename a corrupt fragment file and its ``.cache`` and
    ``.checksums`` sidecars to ``<path>.quarantine-<n>`` (the first free
    n), kept on disk for forensics. Returns the new path of the fragment
    file, or "" when it did not exist."""
    from pilosa_tpu_torch.storage.wal import fsync_dir

    n = 0
    while os.path.exists(f"{path}{QUARANTINE_MARK}{n}"):
        n += 1
    qpath = f"{path}{QUARANTINE_MARK}{n}"
    moved = ""
    for src, dst in ((path, qpath),
                     (path + ".cache", f"{qpath}.cache"),
                     (path + CHECKSUM_SUFFIX, f"{qpath}{CHECKSUM_SUFFIX}")):
        try:
            os.replace(src, dst)
        except OSError:
            continue
        if src == path:
            moved = dst
    fsync_dir(os.path.dirname(path) or ".")
    global_integrity().count("quarantined")
    _LOG.error("quarantined corrupt fragment %s -> %s (%s)",
               path, qpath, reason)
    return moved


def is_quarantined(name: str) -> bool:
    return QUARANTINE_MARK in name


def list_quarantined(data_dir: str) -> list[str]:
    """Every quarantined fragment file under a data dir (sidecars left
    out), sorted."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(data_dir):
        for name in filenames:
            if QUARANTINE_MARK in name and not name.endswith(
                    (".cache", CHECKSUM_SUFFIX)):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


# ------------------------------------------------------- process counters


class IntegrityStats:
    """Process-wide integrity counters; every key present from the first
    read, zeros included."""

    KEYS = ("verified_loads", "unverified_loads", "verify_failures",
            "quarantined", "read_repairs", "self_heals")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {k: 0 for k in self.KEYS}

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def metrics(self) -> dict:
        with self._lock:
            return {f"integrity_{k}_total": v
                    for k, v in sorted(self._counts.items())}


_INTEGRITY = IntegrityStats()


def global_integrity() -> IntegrityStats:
    return _INTEGRITY


# ------------------------------------------------------- storage health


class StorageHealth:
    """A holder's disk-fault latch.

    ``trip(reason)`` makes the node read-only (the API sheds writes with
    503 while ``degraded``) and starts a probe thread that tries a small
    fsynced write into the data dir every ``PROBE_INTERVAL_S``; the
    first that succeeds runs the ``on_clear`` callbacks (the WAL's
    ``clear_fault``) and, when none refuses, clears the latch. The probe
    passes the fault plane's fsync seam, so an armed rule keeps the node
    degraded as a full disk would."""

    PROBE_INTERVAL_S = 1.0

    def __init__(self, probe_dir: str | None = None):
        self._lock = threading.Lock()
        self._probe_dir = probe_dir
        self.degraded = False
        self.reason = ""
        self.trips = 0
        self.recoveries = 0
        self._on_clear: list = []
        self._probe_thread: threading.Thread | None = None
        self._closed = threading.Event()

    def on_clear(self, fn) -> None:
        """Register a recovery callback, run when a probe succeeds and
        before the latch clears; one returning False keeps it set."""
        with self._lock:
            self._on_clear.append(fn)

    def trip(self, reason: str) -> None:
        with self._lock:
            already = self.degraded
            self.degraded = True
            if not already:
                self.reason = reason
                self.trips += 1
            start_probe = (not already and self._probe_dir is not None
                           and not self._closed.is_set())
            if start_probe:
                self._probe_thread = threading.Thread(
                    target=self._probe_loop, daemon=True,
                    name="storage-health-probe")
        if not already:
            _LOG.error("storage degraded (%s): shedding writes read-only "
                       "until a probe write succeeds", reason)
        if start_probe:
            self._probe_thread.start()

    def clear(self) -> None:
        with self._lock:
            if not self.degraded:
                return
            self.degraded = False
            self.reason = ""
            self.recoveries += 1
        _LOG.warning("storage recovered: probe write succeeded, "
                     "resuming writes")

    def close(self) -> None:
        """Stop the probe thread, waiting for it to finish."""
        self._closed.set()
        t = self._probe_thread
        if t is not None and t is not threading.current_thread():
            t.join(10)

    def probe_write(self) -> None:
        """One small durable write into the data dir; raises OSError
        while the disk is still sick."""
        path = os.path.join(self._probe_dir, ".probe")
        with open(path, "wb") as f:
            f.write(b"probe")
            f.flush()
            faults.disk_check("fsync", path)
            os.fsync(f.fileno())
        try:
            os.unlink(path)
        except OSError:
            pass

    def _probe_loop(self) -> None:
        while not self._closed.is_set():
            self._closed.wait(self.PROBE_INTERVAL_S)
            with self._lock:
                if not self.degraded or self._closed.is_set():
                    return
            try:
                self.probe_write()
            except OSError:
                continue
            with self._lock:
                callbacks = list(self._on_clear)
            ok = True
            for fn in callbacks:
                try:
                    if fn() is False:
                        ok = False  # e.g. the WAL could not open a segment
                except OSError:
                    ok = False
            if ok:
                self.clear()
                return

    def metrics(self) -> dict:
        with self._lock:
            return {
                "storage_degraded": int(self.degraded),
                "storage_degraded_total": self.trips,
                "storage_recoveries_total": self.recoveries,
            }

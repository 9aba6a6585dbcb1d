"""Background scrubber: paced disk verification, quarantine and self-heal.

The port's copy of ``pilosa_tpu.parallel.scrub``. Verified loads catch
rot at open; a long-lived node may go months without reopening a
fragment, so a pass walks every local fragment on a byte budget and
re-derives each snapshot's block digests from the bytes on disk
(``integrity.verify_fragment_file``, the kernel parser's fast path),
comparing them with the ``.checksums`` sidecar. The verdict is disk
against disk: the live bitmap never enters it.

A snapshot racing the unlocked read can swap file and sidecar and fake a
mismatch, so a verdict is confirmed under the fragment lock before
anything acts on it. A confirmed corruption self-heals: the rotten file
is quarantined and a fresh snapshot written from the live bitmap, under
the same lock, so a write lands either in that snapshot or, after it, in
the WAL. Nothing on the device changes: the resident leaves were decoded
from the live bitmap, which the heal leaves alone. With no cluster a
fragment has no replica to read-repair from, as in the reference's
single node (the read-repair branch comes with the cluster planes).

Budget: ``scrub-interval`` seconds between passes (0: no ticker) and a
``scrub-max-bytes-per-sec`` pacer (``parallel/pacer.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from pilosa_tpu_torch.parallel.pacer import RepairPacer
from pilosa_tpu_torch.storage.integrity import (
    CorruptFragmentError,
    global_integrity,
    quarantine_paths,
    verify_fragment_file,
)

_LOG = logging.getLogger("pilosa_tpu_torch.parallel.scrub")


class Scrubber:
    """One holder's integrity scrubber: a ticker thread when
    ``interval_s`` > 0 (``Server.open``), single passes on demand
    (``POST /internal/scrub``, ``check --host``)."""

    def __init__(self, holder, interval_s: float = 0.0,
                 max_bytes_per_sec: float = 0.0):
        self.holder = holder
        self.interval_s = float(interval_s)
        self.pacer = RepairPacer(max_bytes_per_sec=max_bytes_per_sec)
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._pass_lock = threading.Lock()
        self.passes = 0
        self.fragments_scanned = 0
        self.bytes_scanned = 0
        self.corruptions = 0
        self.repaired = 0
        self.self_healed = 0
        self.unrepaired = 0
        self.last_pass_s = 0.0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Scrubber":
        if self.interval_s <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="storage-scrub")
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the ticker; a pass under way stops at its next fragment
        and is waited for."""
        self._closed.set()
        t = self._thread
        if t is not None:
            t.join(60)

    def _loop(self) -> None:
        while not self._closed.wait(self.interval_s):
            try:
                self.scrub_pass()
            except Exception as e:  # noqa: BLE001 — the ticker outlives
                # any one pass's surprise (a fragment deleted mid-walk)
                _LOG.warning("scrub pass failed: %s", e)

    # ----------------------------------------------------------------- pass

    def scrub_pass(self) -> dict:
        """Walk every local fragment once: verify, quarantine, heal.
        Returns the pass record (also folded into the counters)."""
        with self._pass_lock:
            t0 = time.perf_counter()
            bytes_before = self.bytes_scanned
            out = {"scanned": 0, "bytes": 0, "corrupt": 0, "repaired": 0,
                   "self_healed": 0, "unrepaired": 0, "skipped": 0}
            for iname, idx in list(self.holder.indexes.items()):
                for fname, field in list(idx.fields.items()):
                    for view in list(field.views.values()):
                        for shard in sorted(view.fragments):
                            if self._closed.is_set():
                                break
                            frag = view.fragment(shard)
                            if frag is None:
                                continue
                            self._scrub_fragment(iname, fname, view, shard,
                                                 frag, out)
            self.passes += 1
            self.last_pass_s = time.perf_counter() - t0
            out["bytes"] = self.bytes_scanned - bytes_before
            out["wall_s"] = round(self.last_pass_s, 3)
            return out

    def _verify_on_disk(self, frag, count: bool = True) -> None:
        """Verify one fragment's file, paced and counted by the bytes
        read even on corruption; ``count=False`` on the locked confirm
        keeps the counters one a fragment. Raises CorruptFragmentError."""
        try:
            verify_fragment_file(frag.path, build_bitmap=False)
        finally:
            try:
                size = os.path.getsize(frag.path)
            except OSError:
                size = 0
            self.pacer.consume(size)
            if count:
                self.fragments_scanned += 1
                self.bytes_scanned += size

    def _scrub_fragment(self, iname, fname, view, shard, frag, out) -> None:
        try:
            self._verify_on_disk(frag)
        except OSError:
            out["skipped"] += 1  # deleted or rotated mid-walk: not rot
            return
        except CorruptFragmentError:
            pass  # confirmed under the lock below
        else:
            out["scanned"] += 1
            return
        with frag.lock:
            try:
                self._verify_on_disk(frag, count=False)
            except OSError:
                out["skipped"] += 1
                return
            except CorruptFragmentError as err:
                confirmed = err
            else:
                out["scanned"] += 1
                return
        out["scanned"] += 1
        out["corrupt"] += 1
        self.corruptions += 1
        global_integrity().count("verify_failures")
        _LOG.error("scrub: %s", confirmed)
        self._heal(iname, fname, view, shard, frag, confirmed, out)

    # ----------------------------------------------------------------- heal

    def _heal(self, iname, fname, view, shard, frag, err, out) -> None:
        # the live bitmap is the only other copy: move the rotten file
        # aside and write a fresh snapshot from memory under the lock
        try:
            with frag.lock:
                quarantine_paths(frag.path, reason=str(err))
                # the .cache sidecar went with it: the close writes anew
                frag._cache_saved = False
                frag.snapshot()
        except OSError as e:  # a sick disk mid-heal: the next pass retries
            self.unrepaired += 1
            out["unrepaired"] += 1
            _LOG.error("scrub: self-heal of %s/%s/%s/%d failed (%s)",
                       iname, fname, view.name, shard, e)
            return
        global_integrity().count("self_heals")
        self.self_healed += 1
        out["self_healed"] += 1
        _LOG.warning("scrub: re-snapshotted %s/%s/%s/%d from the live "
                     "bitmap (no replica copy to read-repair from)",
                     iname, fname, view.name, shard)

    # -------------------------------------------------------------- metrics

    def metrics(self) -> dict:
        return {
            "scrub_passes_total": self.passes,
            "scrub_fragments_scanned_total": self.fragments_scanned,
            "scrub_bytes_total": self.bytes_scanned,
            "scrub_corruptions_detected_total": self.corruptions,
            "scrub_read_repairs_total": self.repaired,
            "scrub_self_heals_total": self.self_healed,
            "scrub_unrepaired_total": self.unrepaired,
            "scrub_last_pass_seconds": round(self.last_pass_s, 6),
            "scrub_paced_sleep_seconds": round(self.pacer.paced_sleep_s, 6),
        }

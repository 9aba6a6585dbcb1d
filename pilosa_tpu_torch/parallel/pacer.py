"""Token-bucket pacing of bulk background I/O (reference parallel/pacer.py).

The port's copy of ``pilosa_tpu.parallel.pacer.RepairPacer``; the
scrubber paces its disk reads with it (``scrub-max-bytes-per-sec``). Both
bounds are off by default:

- ``max_bytes_per_sec``: a bucket holding one second of budget (at least
  64 KiB, so a tiny rate still admits one block) debited per transfer; a
  transfer that overdraws sleeps the deficit off, so the aggregate rate
  converges on the budget while each transfer stays whole;
- ``max_inflight``: a semaphore bounding concurrent transfers.

``paced_sleep_s`` totals the sleeps (``scrub_paced_sleep_seconds``).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext

# Minimum bucket depth: one typical roaring block payload.
MIN_BURST_BYTES = 1 << 16


class RepairPacer:
    """One node's budget for a background plane's transfers. ``stats``
    (a counter sink with ``count(name, n)``) gets ``repair_paced_sleep_ms``;
    the port passes None until its stats plane is ported."""

    def __init__(self, max_bytes_per_sec: float = 0,
                 max_inflight: int = 0, stats=None):
        self.rate = float(max_bytes_per_sec or 0)
        self.max_inflight = int(max_inflight or 0)
        self.burst = max(self.rate, MIN_BURST_BYTES)
        self._tokens = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()
        self._sem = (threading.BoundedSemaphore(self.max_inflight)
                     if self.max_inflight > 0 else None)
        self.stats = stats
        self.paced_sleep_s = 0.0
        self.bytes_consumed = 0

    def slot(self):
        """Context manager bounding concurrent transfers (a no-op when
        ``max_inflight`` is 0)."""
        if self._sem is None:
            return nullcontext()
        return self._slot()

    @contextmanager
    def _slot(self):
        self._sem.acquire()
        try:
            yield
        finally:
            self._sem.release()

    def consume(self, nbytes: int) -> float:
        """Debit ``nbytes`` and sleep off any deficit; returns the seconds
        slept (0.0 when unpaced or within budget)."""
        if nbytes <= 0:
            return 0.0
        with self._lock:
            self.bytes_consumed += int(nbytes)
            if self.rate <= 0:
                return 0.0
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            self._tokens -= nbytes
            wait = (-self._tokens / self.rate) if self._tokens < 0 else 0.0
            self.paced_sleep_s += wait
        if wait > 0:
            if self.stats is not None:
                self.stats.count("repair_paced_sleep_ms", wait * 1e3)
            time.sleep(wait)
        return wait

"""Hedged replica reads with budgets, and per-node circuit breaking (the
port's copy of ``pilosa_tpu.qos.hedge``).

On one node nothing fans out, so no read is hedged and no breaker is
consulted: ``ServingQos`` builds the policy and the breakers from their
knobs (``qos-hedge-delay``, ``qos-hedge-budget``,
``qos-breaker-threshold``, ``qos-breaker-cooldown``) and reports their
counters, zeros from the first scrape, beside the admission gate's and
the deadline-expiry counter.
"""

from __future__ import annotations

import threading
import time

# Breaker states.
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class LatencyTracker:
    """Ring buffer of recent primary-read latencies; p95 over the window.

    A fixed window (not decaying buckets) is enough here: the quantile
    steers only the hedge delay, and a 256-sample window re-centers
    within a few seconds of traffic at serving rates.
    """

    def __init__(self, size: int = 256):
        self._size = size
        self._samples: list[float] = []
        self._next = 0
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            if len(self._samples) < self._size:
                self._samples.append(seconds)
            else:
                self._samples[self._next] = seconds
                self._next = (self._next + 1) % self._size

    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if not self._samples:
                return None
            ordered = sorted(self._samples)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[idx]


class HedgePolicy:
    """When and whether to hedge: p95-tracked delay + global budget."""

    # Samples before the tracked p95 replaces the configured initial
    # delay — quantiles over a handful of samples whipsaw the delay.
    MIN_SAMPLES = 20

    def __init__(self, initial_delay: float = 0.25,
                 budget_fraction: float = 0.05,
                 min_delay: float = 0.005, tracker_size: int = 256):
        self.initial_delay = initial_delay
        self.budget_fraction = budget_fraction
        self.min_delay = min_delay
        self.tracker = LatencyTracker(tracker_size)
        self._lock = threading.Lock()
        self.primaries = 0
        self.hedges = 0
        self.wins = 0
        self.budget_denied = 0

    def delay(self) -> float:
        """Hedge trigger delay: tracked p95 once warmed up, else the
        configured initial delay; floored so a microsecond-fast backend
        cannot hedge every single read."""
        p95 = (self.tracker.quantile(0.95)
               if self.tracker.count() >= self.MIN_SAMPLES else None)
        return max(self.min_delay, p95 if p95 is not None
                   else self.initial_delay)

    def note_primary(self) -> None:
        with self._lock:
            self.primaries += 1

    def record(self, seconds: float) -> None:
        self.tracker.add(seconds)

    def try_hedge(self) -> bool:
        """Spend one unit of hedge budget, or refuse (≤ fraction of
        primary reads may hedge; the +1 seat lets the very first slow
        read hedge instead of dividing by zero)."""
        with self._lock:
            if self.budget_fraction <= 0:
                self.budget_denied += 1
                return False
            if self.hedges + 1 > self.budget_fraction * self.primaries + 1:
                self.budget_denied += 1
                return False
            self.hedges += 1
            return True

    def note_win(self) -> None:
        with self._lock:
            self.wins += 1

    def metrics(self) -> dict:
        with self._lock:
            return {
                "hedges_total": self.hedges,
                "hedge_wins_total": self.wins,
                "hedge_budget_denied_total": self.budget_denied,
            }


class CircuitBreaker:
    """Per-node breaker: closed → open after ``threshold`` consecutive
    transport faults; open → half-open after ``cooldown`` seconds (one
    probe allowed); half-open → closed on success, → open on failure."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0):
        self.threshold = threshold
        self.cooldown = cooldown
        self._lock = threading.Lock()
        self.state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.opened_total = 0

    def allow(self) -> bool:
        """May a request be sent to this node right now? Open returns
        False (callers route around); after the cooldown exactly one
        caller gets True as the half-open probe."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown:
                    self.state = HALF_OPEN
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: one probe in flight; hold other traffic
            if not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state == OPEN:
                # a stale pre-open in-flight success: the node flapped
                # after this request departed, so it says nothing about
                # health NOW — only the half-open probe may close an
                # open breaker, or the cooldown discipline is lost
                return
            self.state = CLOSED
            self._failures = 0
            self._probing = False

    def record_inconclusive(self) -> None:
        """The request ended with no verdict on the NODE — its deadline
        expired, or a deterministic 4xx every replica would repeat.
        Releases a half-open probe seat WITHOUT moving the state: if the
        seat were never released, allow() would return False forever and
        the node would be locked out until process restart."""
        with self._lock:
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == HALF_OPEN or self._failures >= self.threshold:
                if self.state != OPEN:
                    self.opened_total += 1
                self.state = OPEN
                self._opened_at = time.monotonic()
                self._probing = False


class ServingQos:
    """The serving-QoS bundle one node carries: admission gate, hedge
    policy, per-node breakers, and the deadline-expiry counter. Wired by
    Server.open from ServerConfig; a default instance (gate off, hedging
    on with stock knobs) backs bare ``API()`` construction so every code
    path can assume it exists."""

    def __init__(self, max_inflight: int = 0, tenant_max: int = 0,
                 retry_after: float = 1.0,
                 hedge_delay: float = 0.25, hedge_budget: float = 0.05,
                 breaker_threshold: int = 5, breaker_cooldown: float = 5.0,
                 stats=None):
        from pilosa_tpu_torch.qos.admission import AdmissionController

        self.admission = AdmissionController(
            max_inflight=max_inflight, tenant_max=tenant_max,
            retry_after=retry_after, stats=stats,
        )
        self.hedge = HedgePolicy(initial_delay=hedge_delay,
                                 budget_fraction=hedge_budget)
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()
        self.deadline_expired = 0

    def breaker(self, node_id: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(node_id)
            if br is None:
                br = self._breakers[node_id] = CircuitBreaker(
                    self.breaker_threshold, self.breaker_cooldown
                )
            return br

    def note_deadline_expired(self) -> None:
        with self._lock:
            self.deadline_expired += 1

    def metrics(self) -> dict:
        """Flat series for /metrics — all keys present from scrape one so
        rate() windows never see a series appear mid-flight."""
        out = self.admission.metrics()
        out.update(self.hedge.metrics())
        with self._lock:
            out["deadline_expired_total"] = self.deadline_expired
            breakers = list(self._breakers.values())
        out["breaker_opened_total"] = sum(b.opened_total for b in breakers)
        out["breaker_open"] = sum(1 for b in breakers if b.state == OPEN)
        return out

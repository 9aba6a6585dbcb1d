"""Heat-driven residency tiering: moves leaves between the cache's tiers.

The port's copy of ``pilosa_tpu.storage.tiering``, acting on the heat of
``storage/heat.py`` and the tiers of the holder's ``DeviceRowCache``:

- **Demote**: device-resident entries (dense or compressed) whose heat
  fell below ``demote_heat`` move to the cache's host tier, compacted to
  their nonzero 4 KiB blocks: no device bytes, one upload and one K11
  launch away from a dense leaf.
- **Promote**: host-tier entries whose heat climbed to ``promote_heat``
  go back to dense residency. A query's hit on a host-tier entry
  promotes it inline too; the pass catches what queries did not touch.
  ``pacer`` is an injected object with ``consume(nbytes)`` returning the
  seconds it slept, which shapes the promotions' uploads; the server
  passes None, because the cluster's repair pacer is not ported yet.
- **Hysteresis**: ``promote_heat > demote_heat`` opens a dead band, and
  an entry promoted by the pass is immune from demotion for
  ``min_dwell_s``.

Stacked leaves span a whole shard block, so they tier at field
granularity under the field's hottest shard. Every move happens under
the cache lock; a reader between tiers re-decodes from the roaring files
(the miss path). Writes invalidate host copies.
"""

from __future__ import annotations

import threading
import time

DEFAULT_PROMOTE_HEAT = 4.0
DEFAULT_DEMOTE_HEAT = 1.0

# Bound on remembered decisions / dwell stamps: observability rings,
# not unbounded history (shard churn across many indexes).
MAX_TRACKED = 65536


class ResidencyTierer:
    """Promotion/demotion worker over (HeatMap, DeviceRowCache)."""

    def __init__(self, cache, heat=None, interval_s: float = 0.0,
                 promote_heat: float = DEFAULT_PROMOTE_HEAT,
                 demote_heat: float = DEFAULT_DEMOTE_HEAT,
                 min_dwell_s: float | None = None,
                 pacer=None, logger=None):
        if heat is None:
            from pilosa_tpu_torch.storage.heat import global_heat

            heat = global_heat()
        self.cache = cache
        self.heat = heat
        self.interval_s = float(interval_s)
        self.promote_heat = float(promote_heat)
        self.demote_heat = float(demote_heat)
        # dwell immunity defaults to two intervals (one pass of noise
        # cannot undo the last pass's promotion)
        self.min_dwell_s = (float(min_dwell_s) if min_dwell_s is not None
                            else max(2 * self.interval_s, 1.0))
        self.pacer = pacer
        self.logger = logger
        self._lock = threading.Lock()
        self._promoted_at: dict[tuple, float] = {}
        self._decisions: dict[tuple, str] = {}
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self.passes = 0
        self.promotions = 0
        self.demotions = 0
        self.promoted_bytes = 0
        self.demoted_bytes = 0
        self.paced_sleep_s = 0.0
        self.last_pass_s = 0.0

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "ResidencyTierer":
        if self.interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="residency-tierer"
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._closed.wait(self.interval_s):
            try:
                self.run_pass()
            except Exception as e:  # noqa: BLE001 — ticker must not die
                if self.logger is not None:
                    self.logger.warning("residency tiering pass failed: %s",
                                        e)

    def close(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # ---------------------------------------------------------------- pass

    def run_pass(self) -> dict:
        """One promote/demote sweep. Reads the heat snapshot and the
        cache's tier overlay, then acts per (scope, index, field,
        shard): device-resident + cold → host; host-resident + hot →
        dense (paced). Returns the pass record (tests, /internal)."""
        t0 = time.monotonic()
        score_by: dict[tuple, float] = {}
        field_score: dict[tuple, float] = {}
        for r in self.heat.snapshot()["shards"]:
            fkey = (r.get("scope", ""), r["index"], r["field"], r["shard"])
            score = r["access"] + r["writes"]
            score_by[fkey] = score
            # stacked leaves span a whole shard block: a field is as hot
            # as its hottest shard (demoting a stack strands EVERY shard
            # it covers, so one hot shard pins the leaf)
            skey = fkey[:3]
            if score > field_score.get(skey, 0.0):
                field_score[skey] = score
        per_frag, per_stack = self.cache.tier_overlay()
        promoted = demoted = 0
        promoted_bytes = demoted_bytes = 0
        paced = 0.0
        decisions: dict[tuple, str] = {}
        now = time.monotonic()

        def promote(keys_bytes, stamp_key):
            nonlocal promoted, promoted_bytes, paced
            for key, nbytes in keys_bytes:
                if self.pacer is not None:
                    # pace OUTSIDE the cache lock: a bandwidth-starved
                    # promotion sleeps here, serving lookups proceed
                    # (and may promote the entry themselves first —
                    # promote_key then no-ops)
                    paced += self.pacer.consume(nbytes)
                up = self.cache.promote_key(key)
                if up:
                    promoted += 1
                    promoted_bytes += up
            with self._lock:
                self._promoted_at[stamp_key] = now

        def dwell_held(stamp_key) -> bool:
            with self._lock:
                return (now - self._promoted_at.get(stamp_key, -1e9)
                        < self.min_dwell_s)

        for fkey, tiers in per_frag.items():
            score = score_by.get(fkey, 0.0)
            on_device = tiers["dense"] + tiers["compressed"] > 0
            if tiers["host"] > 0 and score >= self.promote_heat:
                promote(self.cache.host_keys_of(*fkey), fkey)
                decisions[fkey] = "promoted"
            elif on_device and score < self.demote_heat:
                if dwell_held(fkey):
                    decisions[fkey] = "hold"  # hysteresis dwell
                    continue
                n, freed = self.cache.demote_fragment_to_host(*fkey)
                if n:
                    demoted += n
                    demoted_bytes += freed
                    decisions[fkey] = "demoted"
                else:
                    decisions[fkey] = "resident"
            elif on_device:
                decisions[fkey] = "resident"
            else:
                decisions[fkey] = "host"
        for skey, tiers in per_stack.items():
            score = field_score.get(skey, 0.0)
            on_device = tiers["dense"] + tiers["compressed"] > 0
            if tiers["host"] > 0 and score >= self.promote_heat:
                promote(self.cache.host_stack_keys_of(*skey), skey)
                decisions[skey] = "promoted"
            elif on_device and score < self.demote_heat:
                if dwell_held(skey):
                    decisions[skey] = "hold"
                    continue
                n, freed = self.cache.demote_field_stacks_to_host(*skey)
                if n:
                    demoted += n
                    demoted_bytes += freed
                    decisions[skey] = "demoted"
                else:
                    decisions[skey] = "resident"
            elif on_device:
                decisions[skey] = "resident"
            else:
                decisions[skey] = "host"
        with self._lock:
            self.passes += 1
            self.promotions += promoted
            self.demotions += demoted
            self.promoted_bytes += promoted_bytes
            self.demoted_bytes += demoted_bytes
            self.paced_sleep_s += paced
            self.last_pass_s = time.monotonic() - t0
            self._decisions = decisions
            if len(self._promoted_at) > MAX_TRACKED:
                # drop the stalest dwell stamps (their immunity expired
                # long ago anyway)
                for k in sorted(self._promoted_at,
                                key=self._promoted_at.get)[
                        : len(self._promoted_at) - MAX_TRACKED // 2]:
                    del self._promoted_at[k]
        return {
            "promoted": promoted,
            "demoted": demoted,
            "promotedBytes": promoted_bytes,
            "demotedBytes": demoted_bytes,
            "pacedSleepS": round(paced, 6),
            "seconds": round(self.last_pass_s, 6),
            "fragmentsSeen": len(per_frag),
            "stackedFieldsSeen": len(per_stack),
        }

    # --------------------------------------------------------------- views

    def last_decisions(self) -> dict:
        """The latest pass's per-fragment verdicts."""
        with self._lock:
            return dict(self._decisions)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "intervalS": self.interval_s,
                "promoteHeat": self.promote_heat,
                "demoteHeat": self.demote_heat,
                "minDwellS": self.min_dwell_s,
                "passes": self.passes,
                "promotions": self.promotions,
                "demotions": self.demotions,
            }

    def metrics(self) -> dict:
        """The reference's residency_tier_* series: the pass counters
        here; the per-tier byte gauges are the cache's ``metrics()``."""
        with self._lock:
            return {
                "residency_tier_passes_total": self.passes,
                "residency_tier_pass_promotions_total": self.promotions,
                "residency_tier_pass_demotions_total": self.demotions,
                "residency_tier_promoted_bytes_total": self.promoted_bytes,
                "residency_tier_demoted_bytes_total": self.demoted_bytes,
                "residency_tier_paced_sleep_seconds_total":
                    round(self.paced_sleep_s, 6),
                "residency_tier_last_pass_seconds":
                    round(self.last_pass_s, 6),
            }

"""Per-shard heat: decayed access/write counters per (index, field, shard).

The port's copy of ``pilosa_tpu.storage.heat``, the signal that
heat-driven residency tiering (``storage/tiering.py``) reads: under
skewed traffic the residency cache needs to know which fragments are
hot now, so heat decays exponentially (half-life 5 minutes by default)
and is applied lazily at read and update time from the stored (value,
last-touch) pair, with no sweeper thread. ``merge_shard_heat`` folds
several nodes' tables into per-(index, shard) heat.

Which records fire: the reference's. Heat records fire only under a
served request's cost context (``utils/cost.py``, on by default):

- ``record_access_many``: once per operand assembly of a query served by
  the API (``Executor._note_operands`` and TopN's filter assembly;
  GroupBy records nothing, as in the reference);
- ``record_write`` for a PQL write served by the API: one a point write
  (Set, Clear, ClearRow, Store: ``n=1``), one a fragment's batch weighted
  by its bits (a mutex Set's move, a BSI value);
- ``record_write`` for ``/import`` (one a shard group, weighted by its
  bits), ``/import-value`` (one a shard, weighted by its columns) and
  ``/import-roaring`` (one a body), at the API, whenever the cost plane
  is on.

Direct calls of the executor or the fragments record nothing, as in the
reference outside a request. ``prometheus_lines`` renders the
``heat_*`` block of ``/metrics``.
"""

from __future__ import annotations

import threading
import time

DEFAULT_HALF_LIFE_S = 300.0


class HeatMap:
    """Decayed per-(index, field, shard) access/write counters."""

    # Decay is applied lazily and AMORTIZED: between applications the
    # raw adds accumulate, and once an entry's last decay is older than
    # this many seconds the pending decay folds in. The bounded error
    # (an add inside the interval decays as if it landed at the
    # interval's start) is negligible against a 5-minute half-life, and
    # it keeps the serving hot path to dict adds — no pow() per query.
    DECAY_INTERVAL_S = 1.0

    def __init__(self, half_life_s: float = DEFAULT_HALF_LIFE_S):
        self.half_life_s = float(half_life_s)
        self._lock = threading.Lock()
        # (scope, index, field, shard) -> [access, write, last_decay].
        # scope (the holder-unique data-dir tag, same convention as
        # frag_id/leaf_key) leads the key: two embedded Servers in one
        # process hold DIFFERENT replicas' data under identical
        # index/field names, and merging their heat would corrupt the
        # promote/demote signal exactly in in-process cluster setups.
        self._h: dict[tuple, list] = {}
        # access records not folded into _h yet (record_access_many)
        self._pending: dict[tuple, list] = {}
        self._pending_since = 0.0
        self.accesses_total = 0
        self.writes_total = 0

    def _decayed(self, entry: list, now: float) -> None:
        dt = now - entry[2]
        if dt >= self.DECAY_INTERVAL_S or self.half_life_s < 2.0:
            factor = 0.5 ** (dt / max(self.half_life_s, 1e-9))
            entry[0] *= factor
            entry[1] *= factor
            entry[2] = now

    def record_access(self, index: str, field: str, shards,
                      n: float = 1.0, scope: str = "") -> None:
        self.record_access_many(index, (field,), shards, n=n, scope=scope)

    def record_access_many(self, index: str, fields, shards,
                           n: float = 1.0, scope: str = "") -> None:
        """One query's resolved leaves touched ``shards`` of every field
        in ``fields``: the serving hot path. Unlike the reference, which
        walks every (field, shard) entry here (about 1 ms of interpreter
        time at 1024 shards, a query), a record only adds ``n`` to a
        pending group keyed by (scope, index, the fields, the shard list
        object). The groups fold into the entries, each as if all its
        adds landed at its first record's time, before any other read or
        write of the table and once the oldest group is
        DECAY_INTERVAL_S old, so the amortized decay's bounded error is
        the reference's; with a frozen clock the table is the
        reference's. Under a 2 s half-life every add decays, so a record
        folds at once."""
        now = time.monotonic()
        fresh = False
        with self._lock:
            self.accesses_total += len(shards) * len(fields)
            if self._pending and (
                    now - self._pending_since >= self.DECAY_INTERVAL_S):
                fresh = self._fold_locked()
            key = (scope, index, frozenset(fields), id(shards))
            group = self._pending.get(key)
            if group is None:
                if not self._pending:
                    self._pending_since = now
                # the list object stays referenced, so its id is not
                # reused while the group is pending
                self._pending[key] = [tuple(fields), shards, tuple(shards),
                                      float(n), now]
            else:
                group[3] += n
            if self.half_life_s < 2.0:
                fresh |= self._fold_locked()
        if fresh:  # table can only grow when a key was inserted
            self._maybe_prune()

    def _fold_locked(self) -> bool:
        """Fold the pending access groups into the entries (caller holds
        the lock); True when a key was inserted."""
        fresh = False
        for (scope, index, _, _), (fields, _, shards, n, t) in \
                self._pending.items():
            for field in fields:
                for shard in shards:
                    key = (scope, index, field, shard)
                    entry = self._h.get(key)
                    if entry is None:
                        self._h[key] = [n, 0.0, t]
                        fresh = True
                    else:
                        self._decayed(entry, t)
                        entry[0] += n
        self._pending.clear()
        return fresh

    def record_write(self, index: str, field: str, shard: int,
                     n: float = 1.0, scope: str = "") -> None:
        now = time.monotonic()
        with self._lock:
            fresh = self._fold_locked()
            self.writes_total += 1
            key = (scope, index, field, int(shard))
            entry = self._h.get(key)
            if entry is None:
                self._h[key] = [0.0, float(n), now]
                fresh = True
            else:
                self._decayed(entry, now)
                entry[1] += n
        if fresh:  # a write-only workload (bulk ingest) must bound the
            self._maybe_prune()  # table too, not just the read path

    def _maybe_prune(self, max_entries: int = 65536) -> None:
        """Bound the table: shard churn across many indexes must not
        grow it forever. Coldest (fully-decayed) entries drop first."""
        with self._lock:
            self._fold_locked()
            if len(self._h) <= max_entries:
                return
            now = time.monotonic()
            scored = []
            for key, entry in self._h.items():
                self._decayed(entry, now)
                scored.append((entry[0] + entry[1], key))
            scored.sort()
            for _, key in scored[: len(self._h) - max_entries // 2]:
                del self._h[key]

    # --------------------------------------------------------------- views

    def snapshot(self, k: int = 0, cache=None) -> dict:
        """Heat table sorted hottest-first (access + write heat). With a
        residency ``cache`` (``/debug/heatmap``) each row is overlaid
        with its device bytes: exact bytes for per-fragment entries, and
        the (index, field) bytes of the stacked leaves, which span a
        whole shard block and cannot be given to one shard."""
        now = time.monotonic()
        with self._lock:
            self._fold_locked()
            rows = []
            for (scope, index, field, shard), entry in self._h.items():
                self._decayed(entry, now)
                row = {
                    "index": index, "field": field, "shard": shard,
                    "access": round(entry[0], 3),
                    "writes": round(entry[1], 3),
                }
                if scope:
                    row["scope"] = scope
                rows.append(row)
        rows.sort(key=lambda r: r["access"] + r["writes"], reverse=True)
        if k:
            rows = rows[:k]
        out = {"halfLifeS": self.half_life_s, "shards": rows}
        if cache is not None:
            per_frag, per_field = cache.residency_overlay()
            for r in rows:
                key = (r.get("scope", ""), r["index"], r["field"],
                       r["shard"])
                nbytes = per_frag.get(key, 0)
                r["residentBytes"] = nbytes
                r["resident"] = bool(nbytes or per_field.get(
                    (r.get("scope", ""), r["index"], r["field"])))
            out["stackedBytesByField"] = [
                {"index": i, "field": f, "bytes": b,
                 **({"scope": sc} if sc else {})}
                for (sc, i, f), b in sorted(per_field.items())
            ]
        return out

    def hottest(self, k: int = 10) -> list[dict]:
        return self.snapshot(k=k)["shards"]

    def metrics(self) -> dict:
        with self._lock:
            self._fold_locked()
            return {
                "tracked_shards": len(self._h),
                "accesses_total": self.accesses_total,
                "writes_total": self.writes_total,
                "half_life_seconds": self.half_life_s,
            }

    def prometheus_lines(self, prefix: str, seen: set | None = None,
                         max_series: int = 32) -> str:
        """The untagged summary block and the ``max_series`` hottest
        shards as tagged gauges (the whole table is ``/debug/heatmap``)."""
        from pilosa_tpu_torch.utils.stats import (
            _meta_lines,
            escape_label,
            prometheus_block,
        )

        seen = seen if seen is not None else set()
        text = prometheus_block(self.metrics(), prefix, "heat", seen=seen)
        lines: list[str] = []
        family = f"{prefix}_heat_shard"
        lines.extend(_meta_lines(
            family, "gauge", "decayed per-shard access+write heat "
            "(hottest shards only; full table at /debug/heatmap)", seen,
        ))
        for r in self.hottest(max_series):
            # scope always labelled: two holders in one process share
            # the map
            lines.append(
                f'{family}{{scope="{escape_label(r.get("scope", ""))}",'
                f'index="{escape_label(r["index"])}",'
                f'field="{escape_label(r["field"])}",'
                f'shard="{r["shard"]}"}} '
                f'{r["access"] + r["writes"]:g}'
            )
        return text + "\n".join(lines) + ("\n" if lines else "")

    def forget(self, scope: str, index: str,
               field: str | None = None) -> None:
        """Drop the heat of a deleted field (``field`` None: of a whole
        index), so a re-creation under the name starts cold."""
        with self._lock:
            self._fold_locked()
            for key in [k for k in self._h if k[0] == scope
                        and k[1] == index
                        and (field is None or k[2] == field)]:
                del self._h[key]

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._h.clear()
            self.accesses_total = 0
            self.writes_total = 0


def merge_shard_heat(row_lists) -> dict:
    """Cluster-wide per-(index, shard) heat from several nodes'
    ``snapshot()["shards"]`` row lists — the autopilot planner's unit
    of movement is the (index, shard) group, summing field-level rows.

    Rows are first deduped by their full (scope, index, field, shard)
    key with MAX-merge: an in-process cluster shares one global heat
    map, so polling every member returns the same entries n times —
    max is exact dedup there, while genuinely distinct nodes (unique
    data-dir scope tags) contribute their own entries. Malformed rows
    are skipped, not fatal: one old-wire peer must not blank the
    plan."""
    by_key: dict[tuple, float] = {}
    for rows in row_lists:
        for r in rows or []:
            try:
                key = (str(r.get("scope", "")), str(r["index"]),
                       str(r["field"]), int(r["shard"]))
                heat = (float(r.get("access", 0.0))
                        + float(r.get("writes", 0.0)))
            except (AttributeError, KeyError, TypeError, ValueError):
                continue
            if heat > by_key.get(key, -1.0):
                by_key[key] = heat
    out: dict[tuple, float] = {}
    for (_scope, index, _field, shard), heat in by_key.items():
        group = (index, shard)
        out[group] = out.get(group, 0.0) + heat
    return out


_global_heat: HeatMap | None = None


def global_heat() -> HeatMap:
    global _global_heat
    if _global_heat is None:
        _global_heat = HeatMap()
    return _global_heat


def set_global_heat(heat: HeatMap) -> None:
    global _global_heat
    _global_heat = heat

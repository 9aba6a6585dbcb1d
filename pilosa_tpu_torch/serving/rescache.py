"""The write-invalidated result cache of the serving path (the port's
copy of ``pilosa_tpu.serving.rescache``).

- Keyed by ``(scope, index, PQL)`` with the pipeline's dedupe
  eligibility: a plain edge read (a PQL string, no shards, no deadline,
  no result options, read-only, pipeline-coalescable), its PQL trimmed.
- Valued by the pre-serialized ``{"results": [...]}`` bytes: a hit costs
  no parse, no plan, no launch, no JSON encoding.
- Invalidated by every write event ``(scope, index, field, shard)`` at
  the fragments' write points (``storage/fragment.py``: Set, Clear,
  ClearRow, Store, imports of bits, values and roaring bodies, WAL
  replay, closes), before the write's ACK; attr writes, row-cache
  recounts and schema deletes invalidate index-wide.
- Race-safe fills: the filler snapshots the write version before the
  query runs, and ``insert`` refuses when any dependency was written
  after it.

A read's dependencies are the fields its AST names for the field-local
call shapes (Count/Row/Union/Intersect/Xor/Difference/Shift/Range/Sum/
Min/Max); any other shape depends on the whole index. Eviction is
bounded by bytes and weighted by a decayed hit score.
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.pql.ast import Condition

DEFAULT_HALF_LIFE_S = 300.0

# Eviction hysteresis: one overflow scan frees down to this fraction of
# the budget so a thrashing insert rate pays one O(entries) scan per
# batch of evictions, not one per insert.
EVICT_TO_FRACTION = 0.9

# Per-entry bookkeeping overhead charged against the byte budget beside
# the payload itself (key strings, dict slots, score fields).
ENTRY_OVERHEAD_BYTES = 256

# Bound on the fill-race fence table: every first write to a distinct
# (scope, index, field) adds a version record whether or not any entry
# depends on it, so index/field churn would otherwise grow it forever
# (the same cardinality concern the cost ledger bounds with _MAX_PAIRS).
MAX_DEP_VERSIONS = 4096


class _Entry:
    __slots__ = ("payload", "fields", "score", "touched", "created",
                 "hits", "nbytes")

    def __init__(self, payload: bytes, fields: frozenset | None,
                 key_len: int, now: float):
        self.payload = payload
        self.fields = fields  # None = depends on the whole index
        self.score = 1.0  # decayed hit heat (the fill counts as one)
        self.touched = now
        self.created = now
        self.hits = 0
        self.nbytes = len(payload) + key_len + ENTRY_OVERHEAD_BYTES


class ResultCache:
    """Byte-bounded, write-invalidated map of pre-serialized responses.

    Thread-safe; every mutation happens under one lock (lookups are a
    dict get + float decay, writers a dict pop per registered entry).
    """

    def __init__(self, budget_bytes: int = 0,
                 half_life_s: float = DEFAULT_HALF_LIFE_S):
        self.budget_bytes = int(budget_bytes)
        self.half_life_s = float(half_life_s) or DEFAULT_HALF_LIFE_S
        self._lock = threading.Lock()
        self._entries: dict[tuple, _Entry] = {}
        # dependency registry: (scope, index, field) -> entry keys, with
        # field None for index-wide (wildcard) dependents; plus a
        # per-index key set for whole-index invalidation
        self._by_dep: dict[tuple, set] = {}
        self._by_index: dict[tuple, set] = {}
        # write-version fence (the fill-race cutoff): a global counter,
        # with the value at each dependency's last invalidation
        self._version = 0
        self._floor = 0  # fills snapshotted before a clear() refuse
        self._dep_version: dict[tuple, int] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.invalidations = 0
        self.invalidated_entries = 0
        self.evictions = 0
        self.fill_races = 0
        # cluster-edge refusal reasons (none on one node; the counter
        # and the inspector's block are the reference's)
        self.refusals: dict[str, int] = {}

    # ------------------------------------------------------------ config

    def configure(self, budget_bytes: int, half_life_s: float | None = None
                  ) -> "ResultCache":
        """Re-point the budget (Server.open) and, when given, the score
        half-life (``heat-half-life``). Shrinking evicts down to the new
        bound; a zero budget disables lookups and clears."""
        with self._lock:
            self.budget_bytes = int(budget_bytes)
            if half_life_s:
                self.half_life_s = float(half_life_s)
            if self.budget_bytes <= 0:
                self._clear_locked()
            else:
                self._evict_locked()
        return self

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    # ------------------------------------------------------------- reads

    def version(self) -> int:
        """The fill-race snapshot: take BEFORE execution starts; pass to
        ``insert`` so a dependency written after the snapshot refuses
        the stale fill."""
        with self._lock:
            return self._version

    def peek(self, scope: str, index: str, pql: str) -> bytes | None:
        """Payload bytes without counting a hit (the API peeks before
        the admission gate so a 429 shed doesn't inflate the hit
        counters); a served hit is recorded via ``record_hit``."""
        if self.budget_bytes <= 0:
            return None
        with self._lock:
            e = self._entries.get((scope, index, pql.strip()))
            return e.payload if e is not None else None

    def record_hit(self, scope: str, index: str, pql: str) -> None:
        now = time.monotonic()
        with self._lock:
            self.hits += 1
            e = self._entries.get((scope, index, pql.strip()))
            if e is not None:
                self._decay(e, now)
                e.score += 1.0
                e.hits += 1

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1

    # ------------------------------------------------------------- fills

    def insert(self, scope: str, index: str, pql: str, payload: bytes,
               fields: frozenset | set | None, snapshot: int) -> bool:
        """Install a fill captured at write-version ``snapshot``.
        Returns False (and counts a fill race) when any dependency was
        invalidated after the snapshot — the executed result may or may
        not contain that write, so the bytes must not outlive it."""
        if self.budget_bytes <= 0:
            return False
        key = (scope, index, pql.strip())
        deps = ([("f", scope, index, f) for f in sorted(fields)]
                if fields else [("w", scope, index)])
        now = time.monotonic()
        with self._lock:
            if snapshot < self._floor:
                # clear() fenced everything: the deps' invalidation
                # history is gone, so a pre-clear fill cannot prove
                # its freshness
                self.fill_races += 1
                return False
            # the index-wide epoch fences EVERY entry of the index
            # (schema deletes, attr writes, cache recounts)
            if self._dep_version.get(("e", scope, index), 0) > snapshot:
                self.fill_races += 1
                return False
            for dep in deps:
                if self._dep_version.get(dep, 0) > snapshot:
                    self.fill_races += 1
                    return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._deregister_locked(key, old)
            entry = _Entry(
                payload, frozenset(fields) if fields else None,
                len(scope) + len(index) + len(key[2]), now,
            )
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self.fills += 1
            regs = ([(scope, index, f) for f in entry.fields]
                    if entry.fields else [(scope, index, None)])
            for reg in regs:
                self._by_dep.setdefault(reg, set()).add(key)
            self._by_index.setdefault((scope, index), set()).add(key)
            self._evict_locked()
            return key in self._entries  # the fill itself may be coldest

    # ------------------------------------------------------- invalidation

    def invalidate(self, scope: str, index: str, field: str,
                   shard: int | None = None) -> int:
        """One (index, field, shard) write event (the WAL-visible write
        points — fragment mutation hooks). Drops every entry depending
        on the field plus every index-wide dependent, and advances the
        version fence so in-flight fills refuse to land."""
        with self._lock:
            self._version += 1
            v = self._version
            self._note_dep_locked(("f", scope, index, field), v)
            self._note_dep_locked(("w", scope, index), v)
            dropped = 0
            for reg in ((scope, index, field), (scope, index, None)):
                for key in list(self._by_dep.get(reg, ())):
                    dropped += self._drop_locked(key)
            # every write event counts, dropped entries or not, so
            # operators see the invalidation stream beside the fills
            self.invalidations += 1
            self.invalidated_entries += dropped
            return dropped

    def invalidate_index_wide(self, scope: str, index: str) -> int:
        """Index-scope invalidation: attr writes, TopN cache recounts,
        field/index deletes, restores — anything that can change results
        without a fragment write event."""
        with self._lock:
            self._version += 1
            self._note_dep_locked(("e", scope, index), self._version)
            dropped = 0
            for key in list(self._by_index.get((scope, index), ())):
                dropped += self._drop_locked(key)
            self.invalidations += 1
            self.invalidated_entries += dropped
            return dropped

    def _note_dep_locked(self, dep: tuple, v: int) -> None:
        """Record a dependency's invalidation version, keeping the table
        bounded: past MAX_DEP_VERSIONS the oldest half is dropped and the
        fill floor raised to the newest dropped version — a fill
        snapshotted before it can no longer prove its dependencies'
        history, so it refuses (counted as a fill race). A fill
        snapshotted at or after the floor is unaffected: every dropped
        record's version is <= the floor <= its snapshot, so the missing
        check could only have passed."""
        self._dep_version[dep] = v
        if len(self._dep_version) <= MAX_DEP_VERSIONS:
            return
        items = sorted(self._dep_version.items(), key=lambda kv: kv[1])
        cut = len(items) // 2
        for dep_key, _ in items[:cut]:
            del self._dep_version[dep_key]
        self._floor = max(self._floor, items[cut - 1][1])

    def clear(self) -> None:
        with self._lock:
            self._clear_locked()

    def _clear_locked(self) -> None:
        self._entries.clear()
        self._by_dep.clear()
        self._by_index.clear()
        self._bytes = 0
        self._version += 1
        # the version fence survives a clear: in-flight fills snapshotted
        # before it must not land after (their deps' history is gone)
        self._dep_version.clear()
        self._floor = self._version

    def _drop_locked(self, key: tuple) -> int:
        entry = self._entries.pop(key, None)
        if entry is None:
            return 0
        self._bytes -= entry.nbytes
        self._deregister_locked(key, entry)
        return 1

    def _deregister_locked(self, key: tuple, entry: _Entry) -> None:
        scope, index, _ = key
        regs = ([(scope, index, f) for f in entry.fields]
                if entry.fields else [(scope, index, None)])
        for reg in regs:
            keys = self._by_dep.get(reg)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_dep[reg]
        keys = self._by_index.get((scope, index))
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_index[(scope, index)]

    # ---------------------------------------------------------- eviction

    def _decay(self, entry: _Entry, now: float) -> None:
        dt = now - entry.touched
        if dt > 0:
            entry.score *= 0.5 ** (dt / max(self.half_life_s, 1e-9))
            entry.touched = now

    def _evict_locked(self) -> None:
        """Heat-weighted eviction: decay every entry's hit score and
        drop the coldest until under ``EVICT_TO_FRACTION`` of budget —
        one scan per overflow batch, so a hot Zipf head survives any
        burst of one-off fills."""
        if self._bytes <= self.budget_bytes:
            return
        now = time.monotonic()
        scored = []
        for key, entry in self._entries.items():
            self._decay(entry, now)
            scored.append((entry.score, key))
        scored.sort()
        target = int(self.budget_bytes * EVICT_TO_FRACTION)
        for _, key in scored:
            if self._bytes <= target:
                break
            self._drop_locked(key)
            self.evictions += 1

    # ------------------------------------------------------------- views

    def metrics(self) -> dict:
        with self._lock:
            return {
                "result_cache_entries": len(self._entries),
                "result_cache_bytes": self._bytes,
                "result_cache_budget_bytes": self.budget_bytes,
                "result_cache_hits_total": self.hits,
                "result_cache_misses_total": self.misses,
                "result_cache_fills_total": self.fills,
                "result_cache_invalidations_total": self.invalidations,
                "result_cache_invalidated_entries_total":
                    self.invalidated_entries,
                "result_cache_evictions_total": self.evictions,
                "result_cache_fill_races_total": self.fill_races,
                "result_cache_refusals_total": sum(self.refusals.values()),
            }

    def refusal_reasons(self) -> dict:
        with self._lock:
            return dict(self.refusals)

    def inspect(self, k: int = 100) -> dict:
        """GET /debug/rescache: the entry table hottest-first (decayed
        score, hits, bytes, age, dependency fields) plus totals —
        the runbook's first stop for a hot-tenant p99 regression."""
        now = time.monotonic()
        with self._lock:
            rows = []
            for (scope, index, pql), e in self._entries.items():
                self._decay(e, now)
                row = {
                    "index": index,
                    "pql": pql[:256],
                    "bytes": e.nbytes,
                    "hits": e.hits,
                    "score": round(e.score, 3),
                    "ageSeconds": round(now - e.created, 3),
                    "fields": (sorted(e.fields)
                               if e.fields is not None else None),
                }
                if scope:
                    row["scope"] = scope
                rows.append(row)
        rows.sort(key=lambda r: r["score"], reverse=True)
        if k:
            rows = rows[:k]
        out = self.metrics()
        out["halfLifeS"] = self.half_life_s
        out["refusals"] = self.refusal_reasons()
        out["entries"] = rows
        return out


# ------------------------------------------------------- field extraction
#
# AST → dependency field set, for the call shapes where every bit the
# result can depend on lives in an explicitly named field. Anything else
# returns None = depend on the whole index (correct by construction).

# Calls whose results are a pure function of their named fields' bits.
# Excluded on purpose: Not/All (read the hidden existence field),
# TopN (reads the fragment rank cache, rebuilt by recalculate-caches),
# Rows/GroupBy (enumerate row ids host-side), and every write call.
_FIELD_PRECISE = {"Count", "Row", "Union", "Intersect", "Difference",
                  "Xor", "Shift", "Range", "Sum", "Min", "Max"}

# Per-call parameters with a known field-independent meaning: skipping
# them is safe AND keeps the dependency set precise (Shift's count,
# Row/Range's time bounds).
_CALL_PARAM_ARGS = {
    "Shift": frozenset({"n"}),
    "Row": frozenset({"from", "to"}),
    "Range": frozenset({"from", "to"}),
}

# BSI aggregates name their field in the ``field=``/``_field=`` VALUE.
_FIELD_VALUE_CALLS = frozenset({"Sum", "Min", "Max"})

# Mirror of executor._RESERVED_ARGS: every key some call shape treats as
# a parameter rather than a field name. (Copied, not imported: the write
# hooks make storage/fragment.py import this module, and the executor
# imports storage — an import here would cycle.) A key from this set on
# a call where it is NOT a known parameter is ambiguous — "n", "from",
# "limit", ... are all legal field names, and whether the executor reads
# the key as a field is a contract that lives in another module. Bail to
# the whole-index dependency instead of guessing: a missed dependency
# serves stale bytes after an acked write, the one thing this cache must
# never do.
_AMBIGUOUS_ARGS = {"_field", "_col", "from", "to", "n", "limit", "offset",
                   "previous", "column", "filter", "field", "ids",
                   "timestamp", "excludeColumns", "shards", "aggregate",
                   "columnAttrs", "attrName", "attrValue", "like",
                   "threshold", "having"}


def _walk_fields(call, fields: set) -> bool:
    name = getattr(call, "name", None)
    if name == "Options":
        kids = getattr(call, "children", None) or ()
        return bool(kids) and all(_walk_fields(c, fields) for c in kids)
    if name not in _FIELD_PRECISE:
        return False
    args = getattr(call, "args", None) or {}
    params = _CALL_PARAM_ARGS.get(name, frozenset())
    for k, v in args.items():
        if isinstance(v, Condition):
            # Row(fare > 10): the key IS the field — condition_field()
            # applies no reserved-name filter, so neither do we
            fields.add(k)
        elif (k == "field" or k == "_field") and name in _FIELD_VALUE_CALLS:
            fields.add(str(v))  # Sum(field=sal)
        elif k in params:
            continue
        elif k in _AMBIGUOUS_ARGS or k.startswith("_"):
            return False  # conservative: depend on the whole index
        else:
            fields.add(k)  # Row(f=1): the key IS the field
    return all(_walk_fields(c, fields)
               for c in getattr(call, "children", ()) or ())


def query_field_deps(query) -> frozenset | None:
    """The field set a parsed READ query's result can depend on, or
    None when it must be treated as depending on the whole index."""
    fields: set = set()
    calls = getattr(query, "calls", None)
    if not calls:
        return None
    if not all(_walk_fields(c, fields) for c in calls):
        return None
    return frozenset(fields) if fields else None


# ------------------------------------------------------------- singleton
#
# One process-wide cache, scope-qualified keys (the heat/residency
# pattern): in-process multi-holder setups share the instance without
# sharing entries. Disabled (budget 0) until Server.open configures it.

_global_cache: ResultCache | None = None


def global_result_cache() -> ResultCache:
    global _global_cache
    if _global_cache is None:
        _global_cache = ResultCache(0)
    return _global_cache


def set_global_result_cache(cache: ResultCache) -> None:
    global _global_cache
    _global_cache = cache


def invalidate_write(scope: str, index: str, field: str,
                     shard: int | None = None) -> None:
    """The fragment-mutation hook (storage/fragment.py): one global
    read + a predicate when the cache is off — the write hot path's
    whole cost, same bar as the fault plane's off state."""
    cache = _global_cache
    if cache is not None and cache.budget_bytes > 0:
        cache.invalidate(scope, index, field, shard)


def invalidate_index_wide(scope: str, index: str) -> None:
    cache = _global_cache
    if cache is not None and cache.budget_bytes > 0:
        cache.invalidate_index_wide(scope, index)

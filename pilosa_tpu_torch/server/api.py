"""The API layer between HTTP and the holder/executor (reference api.go).

The port's copy of ``pilosa_tpu.server.api``: schema writes, PQL
queries answered as pre-serialized JSON bytes, bulk bit imports (a mutex
or bool field's through ``Fragment.import_mutex``, a time field's
timestamped bits also into each quantum view, one bulk import a view;
an import's shard groups on the ``ingest-workers`` pool) and int fields'
value imports, with the reference's validation and error texts so both
packages answer the same bytes.

The request envelope of a query (``query_raw``), the reference's:

- the in-flight tracker (``GET /debug/queries``), a cost context for
  the tenant ledger, the SLO engine and an optional PROFILE tree
  (``profile_out``), and the ``qos.admit`` span;
- the admission gate (edge requests only): a shed request is a 429 with
  ``retry_after``;
- reads that pipeline (``executor.pipeline_coalescable``) go through the
  ``QueryPipeline`` wave (``serve_pipelined``, on by default), with
  identical plain reads of one wave submitted once; other reads and
  writes run on ``execute``;
- a ``deadline`` (qos.Deadline) rides to the executor's dispatch
  boundary; expiry is a 504;
- a query at or over ``long_query_time`` lands in the slow-query ring,
  with its span tree when sampled.

``query_json_bytes`` puts the write-invalidated result cache
(``serving/rescache.py``) in front: a plain read is answered from cached
bytes (``_serve_result_cache_hit``: admission, tracking and accounting
still run), a miss fills after its run unless a write raced it.

A write is acknowledged only once durable (``_ack_durable``): in
``group`` mode the request waits for the WAL group holding its records
to be fsynced, in ``per-op`` mode every record was fsynced inline, and
``flush-only`` promises nothing. Before that, the request's patches of
resident leaves launch together (``DeviceRowCache.batch_writes``: one K3
launch a request), and every result-cache entry the write touches has
been invalidated at its fragments. A query may ask for the request-level
result options ``columnAttrs``, ``excludeColumns`` and
``excludeRowAttrs``. While the holder's ``StorageHealth`` latch is
tripped, every write is shed with a 503 and ``retry_after`` before the
executor sees it. ``scrub_now()`` runs one scrubber pass;
``import_roaring`` unions one shard's roaring bitmap (either layout) in
one locked pass; the deletes purge the residency cache and the heat map
of what they remove. The ``*_metrics`` methods and the ``*_json``
inspectors feed ``/metrics`` and the ``/debug`` routes;
``start_device_trace`` captures a ``torch.profiler`` trace.

Multi-process serving (``serving/mpserve.py``): ``mpserve`` is the
``OwnerRuntime`` when ``SO_REUSEPORT`` workers front this process. It
answers their ring queries through ``query_json_bytes(...,
pre_admitted=True, on_submitted=...)``: the worker's gate already
admitted the request, and ``on_submitted`` fires when the request's wave
is submitted (or, on the eager path, when it starts to run), the cutoff
of the owner's dedupe memo. ``mp_metrics`` and ``workers_json`` feed
``/metrics``, ``/debug/vars`` and ``/debug/workers``. Cluster and CDC
are not ported yet.
"""

from __future__ import annotations

import collections
import datetime as dt
import os
import threading
import time

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.executor.executor import (
    Executor,
    PQLError,
    column_attr_sets,
    instrument_calls,
    parse_time,
    pipeline_coalescable,
    strip_columns,
)
from pilosa_tpu_torch.executor.result import RowResult, results_json_bytes
from pilosa_tpu_torch.parallel.scrub import Scrubber
from pilosa_tpu_torch.pql import ParseError, parse
from pilosa_tpu_torch.qos import (
    AdmissionError,
    DeadlineExceeded,
    ServingQos,
    SLOEngine,
)
from pilosa_tpu_torch.roaring.format import load_any
from pilosa_tpu_torch.serving.rescache import (
    global_result_cache,
    invalidate_index_wide,
    query_field_deps,
)
from pilosa_tpu_torch.server.pipeline import QueryPipeline
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP, \
    shard_groups
from pilosa_tpu_torch.storage import heat
from pilosa_tpu_torch.storage.field import (
    TYPE_BOOL,
    TYPE_INT,
    TYPE_MUTEX,
    TYPE_TIME,
    FieldOptions,
)
from pilosa_tpu_torch.storage.integrity import global_integrity
from pilosa_tpu_torch.storage.view import VIEW_STANDARD, views_for_time
from pilosa_tpu_torch.storage.wal import MODE_FLUSH_ONLY
from pilosa_tpu_torch.utils.cost import (
    CostLedger,
    QueryProfile,
    activate_cost,
    cost_enabled,
    deactivate_cost,
    new_cost_context,
)
from pilosa_tpu_torch.utils.pool import concurrent_map
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.utils.tracing import (
    current_span,
    global_query_tracker,
    capture_device_trace,
    global_tracer,
)

# The reference's max-writes-per-request default: the most Set/Clear
# calls in one query, and the most bits in one import body.
MAX_WRITES_PER_REQUEST = 5000

# The reference's ingest-workers default: an import's shard groups apply
# one after another unless the knob raises it.
INGEST_WORKERS_DEFAULT = 1

# Capacity of the slow-query ring (the slow-query-ring knob's default).
SLOW_QUERY_RING_DEFAULT = 100


def _ascii_digits(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(uint8[n, width] ASCII digits of each value, left-aligned, its
    digit count); past a value's digits the row holds filler."""
    values = values.astype(np.uint64)
    width = len(str(int(values.max())))
    n_dig = np.ones(values.size, np.int64)
    for k in range(1, width):
        n_dig += values >= np.uint64(10 ** k)
    digits = np.empty((values.size, width), np.uint8)
    rest = values.copy()
    for k in range(width - 1, -1, -1):  # right-aligned, leading zeros
        digits[:, k] = rest % np.uint64(10)
        rest //= np.uint64(10)
    lead = (width - n_dig)[:, None]
    at = np.minimum(np.arange(width)[None, :] + lead, width - 1)
    return np.take_along_axis(digits, at, 1) + ord("0"), n_dig


def csv_lines(rows: np.ndarray, cols: np.ndarray) -> bytes:
    """A ``row,col`` line for each pair, each ended by a newline: one byte
    matrix a line (the row's digits, a comma, the column's digits, the
    newline), with each line's filler masked out."""
    rd, rn = _ascii_digits(rows)
    cd, cn = _ascii_digits(cols)
    n, wr, wc = rd.shape[0], rd.shape[1], cd.shape[1]
    line = np.concatenate([rd, np.full((n, 1), ord(","), np.uint8), cd,
                           np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    j = np.arange(line.shape[1])[None, :]
    keep = ((j < rn[:, None]) | (j == wr)
            | ((j > wr) & (j <= wr + cn[:, None])) | (j == wr + 1 + wc))
    return line[keep].tobytes()


class ApiError(Exception):
    """An error with its HTTP status; ``retry_after`` (seconds) becomes a
    ``Retry-After`` header."""

    def __init__(self, message: str, status: int = 400,
                 retry_after: float | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after = retry_after


class API:
    def __init__(self, holder, executor=None):
        self.holder = holder
        # the server's executor: the plain one, or a DistExecutor over a
        # mesh (use-mesh)
        self.executor = (executor if executor is not None
                         else Executor(holder, device=holder.device))
        self.max_writes_per_request = MAX_WRITES_PER_REQUEST
        self.tierer = None  # the server's ResidencyTierer, when one runs
        # the integrity scrubber: the server's ticker, or the one that
        # on-demand passes create
        self.scrubber = None
        # queries at or over this many seconds land in the slow-query
        # ring (0: off); deque(maxlen) appends are atomic and bounded
        self.long_query_time: float = 0.0
        self.long_queries: collections.deque = collections.deque(
            maxlen=SLOW_QUERY_RING_DEFAULT)
        self.slow_queries_total = 0
        self._slow_lock = threading.Lock()
        # POST /debug/trace-device: one capture at a time into this dir
        # ("" = <data-dir>/jax-traces, the reference's default)
        self.trace_log_dir: str = ""
        self._device_trace_lock = threading.Lock()
        self.logger = None
        self.ingest_workers: int = INGEST_WORKERS_DEFAULT
        # reads that pipeline ride the wave dispatcher (False: every
        # request runs on its own thread, the reference's switch)
        self.serve_pipelined: bool = True
        self._pipeline = None  # created at the first pipelined read
        self._pipeline_lock = threading.Lock()
        # admission gate (off: 0 = unlimited), hedge policy and breakers;
        # Server.open swaps in the configured bundle
        self.qos = ServingQos()
        # the server's default request deadline in seconds (0: none); a
        # request's header wins
        self.default_deadline_s: float = 0.0
        self.cost = CostLedger()
        self.slo = SLOEngine()
        # the multi-process serving runtime (serving/mpserve.py) while
        # SO_REUSEPORT workers front this process; None otherwise
        self.mpserve = None

    def node_id(self) -> str:
        return "local"

    # ----------------------------------------------------------------- query

    def query_raw(self, index: str, pql: str, shards=None,
                  remote: bool = False, opts: dict | None = None,
                  tenant: str = "default", deadline=None,
                  profile_out: list | None = None,
                  pre_admitted: bool = False,
                  on_submitted=None) -> list:
        """Execute and return the raw result objects, with the request's
        result options ``opts`` applied; ``shards`` restricts the calls
        to those shards. ``remote`` marks a peer's sub-query: it passes
        no admission gate and records no ledger or SLO event, and its
        writes skip the storage-degraded shed, as the reference's do.
        ``profile_out`` (a list) receives the PROFILE tree.
        ``pre_admitted``: a serving worker's gate already admitted the
        request (gating it again would shed requests the node has room
        for). ``on_submitted()`` is called once the request's wave is
        submitted, or as the eager path starts to execute."""
        tracer = global_tracer()
        tracker = global_query_tracker()
        inflight = tracker.start(index, pql, tenant=tenant, remote=remote)
        inflight_token = (tracker.activate(inflight)
                          if inflight is not None else None)
        prof = (QueryProfile(index, pql, self.node_id())
                if profile_out is not None else None)
        ctx = new_cost_context(tenant, index, prof)
        if ctx is None:
            prof = None  # the cost plane is off: no all-zero tree
        cost_token = activate_cost(ctx)
        t_start = time.perf_counter()
        err_status = None
        slot = None
        try:
            if not remote and not pre_admitted:
                if inflight is not None:
                    inflight.stage = "admission"
                try:
                    with tracer.span("qos.admit", tenant=tenant):
                        slot = self.qos.admission.admit(tenant)
                except AdmissionError as e:
                    raise ApiError(str(e), 429,
                                   retry_after=e.retry_after) from e
            return self._query_raw_admitted(index, pql, shards, remote, opts,
                                            deadline, slot, inflight,
                                            tracer, on_submitted)
        except ApiError as e:
            err_status = e.status
            raise
        except Exception:
            err_status = 500
            raise
        finally:
            deactivate_cost(cost_token)
            elapsed = time.perf_counter() - t_start
            if not remote and ctx is not None:
                error = err_status is not None and err_status >= 500
                self.cost.record_query(tenant, index, ctx, elapsed,
                                       error=error)
                if err_status != 429:  # a shed is policy, not failure
                    self.slo.record(elapsed, error=error)
            if profile_out is not None and err_status is None:
                profile_out.append(
                    prof.to_json(ctx) if prof is not None
                    else {"disabled": True,
                          "reason": "cost plane is disabled on this node"})
            tracker.finish(inflight, inflight_token)

    def _pipeline_for(self) -> QueryPipeline:
        if self._pipeline is None:
            with self._pipeline_lock:
                if self._pipeline is None:
                    self._pipeline = QueryPipeline(self)
        return self._pipeline

    def _query_raw_admitted(self, index, pql, shards, remote, opts,
                            deadline, slot, inflight, tracer,
                            on_submitted=None) -> list:
        t0 = time.perf_counter()
        try:
            if inflight is not None:
                inflight.stage = "parse"
            query = parse(pql)
            writes = len(query.write_calls())
            if 0 < self.max_writes_per_request < writes:
                raise ApiError(
                    f"too many writes in request: {writes} > "
                    f"max-writes-per-request {self.max_writes_per_request}"
                )
            if writes and not remote:
                self._check_not_storage_degraded()
            kwargs = {"shards": shards}
            if deadline is not None:
                kwargs["deadline"] = deadline
            if (writes == 0 and self.serve_pipelined
                    and pipeline_coalescable(query)):
                # plain edge reads are dedupe-eligible: identical PQL in
                # one wave submits once and shares the leader's results
                key = None
                if (shards is None and deadline is None and not remote
                        and not opts):
                    key = (index, pql)
                if inflight is not None:
                    inflight.stage = "pipeline.wave"
                deferreds = self._pipeline_for().run(index, query, kwargs,
                                                     key=key)
                if on_submitted is not None:
                    # the wave holding this request is submitted: the
                    # multi-process owner's dedupe cutoff, the boundary
                    # the wave's own dedupe draws
                    on_submitted()
                if inflight is not None:
                    inflight.stage = "executor.resolve"
                handles = iter(deferreds)
                results = instrument_calls(
                    index, query.calls, lambda call: next(handles).result())
            elif writes:
                if inflight is not None:
                    inflight.stage = "executor.execute"
                if on_submitted is not None:
                    on_submitted()  # the eager path runs right now
                with self.holder.cache.batch_writes():
                    results = self.executor.execute(index, query, **kwargs)
            else:
                if inflight is not None:
                    inflight.stage = "executor.execute"
                if on_submitted is not None:
                    on_submitted()
                results = self.executor.execute(index, query, **kwargs)
            if opts:
                results = self._apply_request_opts(index, results, opts)
            if writes:
                # attr writes change results (Row answers carry attrs)
                # without a fragment write: fence the index's cached
                # results; bit writes invalidated at their fragments
                if any(c.name in ("SetRowAttrs", "SetColumnAttrs")
                       for c in query.write_calls()):
                    idx = self.holder.index(index)
                    if idx is not None:
                        invalidate_index_wide(idx.scope, index)
                if inflight is not None:
                    inflight.stage = "wal.barrier"
                self._ack_durable()
            return results
        except DeadlineExceeded as e:
            self.qos.note_deadline_expired()
            raise ApiError(str(e), 504) from e
        except (ParseError, PQLError) as e:
            raise ApiError(str(e)) from e
        finally:
            if slot is not None:
                slot.release()
            elapsed = time.perf_counter() - t0
            if self.long_query_time > 0 and elapsed >= self.long_query_time:
                self._note_slow(index, pql, elapsed)

    def _note_slow(self, index: str, pql, elapsed: float) -> None:
        """One slow query into the ring: its PQL, seconds and time, and
        when it was sampled its trace id and whole span tree as of now."""
        entry = {
            "index": index,
            "pql": (pql if isinstance(pql, str) else str(pql))[:1024],
            "seconds": round(elapsed, 4),
            "at": dt.datetime.now(dt.timezone.utc).isoformat(),
        }
        cur = current_span()
        if cur is not None:
            entry["traceId"] = cur.trace_id
            entry["trace"] = cur.root().to_json()
        with self._slow_lock:
            self.slow_queries_total += 1
        self.long_queries.append(entry)
        if self.logger is not None:
            self.logger.warning(
                "long query (%.3fs > %.3fs) on %s: %s",
                elapsed, self.long_query_time, index, entry["pql"])

    def _check_not_storage_degraded(self) -> None:
        """503 with Retry-After while the disk is sick (the holder's
        StorageHealth latch); it clears when a probe write succeeds."""
        health = self.holder.health
        if not health.degraded:
            return
        raise ApiError(
            f"storage degraded ({health.reason}): writes are shed on "
            "this node until a probe write succeeds; reads still serve",
            503, retry_after=5.0)

    def _ack_durable(self) -> None:
        """The ACK gate: a 200 on a write means its op records are
        fsynced (group mode waits for their group; per-op fsynced inline;
        flush-only promises nothing). The key translation log is fsynced
        first: a keyed write's bit must not outlive its key→id record,
        or it would come back under another key."""
        wal = self.holder.wal
        if wal.mode != MODE_FLUSH_ONLY:
            with global_tracer().span("wal.barrier"):
                self.holder.translate.sync()
                wal.barrier()

    def _apply_request_opts(self, index: str, results: list,
                            opts: dict) -> list:
        """The request-level result options on every row result:
        ``columnAttrs`` attaches the columns' attrs, ``excludeRowAttrs``
        drops the row's, ``excludeColumns`` the columns."""
        idx = self.holder.index(index)
        out = []
        for res in results:
            if isinstance(res, RowResult):
                if opts.get("columnAttrs") and idx is not None:
                    res.column_attrs = column_attr_sets(idx, res)
                if opts.get("excludeRowAttrs"):
                    res.attrs = {}
                if opts.get("excludeColumns"):
                    res = strip_columns(res)
            out.append(res)
        return out

    def query_json_bytes(self, index: str, pql: str, shards=None,
                         remote: bool = False, opts: dict | None = None,
                         tenant: str = "default", deadline=None,
                         profile_out: list | None = None,
                         pre_admitted: bool = False,
                         on_submitted=None,
                         cache_hit_out: list | None = None) -> bytes:
        """The whole ``{"results": [...]}`` response envelope as bytes,
        with the result cache in front: a cache-eligible request (a plain
        edge read, as the pipeline's dedupe) is answered from cached
        bytes (``cache_hit_out`` receives True); a miss snapshots the
        write version before it runs and fills after, and the fill is
        refused if a write landed in between. ``pre_admitted`` and
        ``on_submitted`` as ``query_raw``'s (a cache hit is submitted
        at once)."""
        scope = None
        snap = None
        cache = global_result_cache()
        if (cache.enabled and not remote and shards is None
                and deadline is None and not opts):
            idx = self.holder.index(index)
            if idx is not None:
                scope = idx.scope
                payload = cache.peek(scope, index, pql)
                if payload is not None:
                    return self._serve_result_cache_hit(
                        cache, scope, index, pql, payload, tenant,
                        profile_out, pre_admitted, on_submitted,
                        cache_hit_out)
                if self._result_cacheable(pql):
                    # a miss only for fillable queries
                    cache.record_miss()
                    snap = cache.version()  # the fill-race cutoff
                else:
                    scope = None
        payload = results_json_bytes(self.query_raw(
            index, pql, shards=shards, remote=remote, opts=opts,
            tenant=tenant, deadline=deadline, profile_out=profile_out,
            pre_admitted=pre_admitted, on_submitted=on_submitted))
        if snap is not None:
            cache.insert(scope, index, pql, payload,
                         query_field_deps(parse(pql)), snap)
        return payload

    @staticmethod
    def _result_cacheable(pql: str) -> bool:
        """Read-only and pipeline-coalescable; a parse error is left to
        ``query_raw``."""
        try:
            query = parse(pql)
        except Exception:
            return False
        return not query.write_calls() and pipeline_coalescable(query)

    def _serve_result_cache_hit(self, cache, scope, index, pql, payload,
                                tenant, profile_out, pre_admitted,
                                on_submitted, cache_hit_out) -> bytes:
        """A cache hit's request envelope: admission, in-flight tracking,
        a ``rescache.hit`` span, and ledger and SLO accounting (a hit is
        billed as a query with no launch). No heat: residency follows
        the traffic that runs."""
        tracer = global_tracer()
        tracker = global_query_tracker()
        inflight = tracker.start(index, pql, tenant=tenant, remote=False)
        inflight_token = (tracker.activate(inflight)
                          if inflight is not None else None)
        ctx = new_cost_context(tenant, index, None)
        t_start = time.perf_counter()
        err_status = None
        slot = None
        try:
            if not pre_admitted:
                if inflight is not None:
                    inflight.stage = "admission"
                try:
                    with tracer.span("qos.admit", tenant=tenant):
                        slot = self.qos.admission.admit(tenant)
                except AdmissionError as e:
                    raise ApiError(str(e), 429,
                                   retry_after=e.retry_after) from e
            if inflight is not None:
                inflight.stage = "rescache"
            with tracer.span("rescache.hit", index=index):
                cache.record_hit(scope, index, pql)
            if on_submitted is not None:
                # a hit resolves at once: later identical arrivals start
                # their own (equally cached) pass
                on_submitted()
            if cache_hit_out is not None:
                cache_hit_out.append(True)
            if profile_out is not None:
                if ctx is not None:
                    profile_out.append({
                        "node": self.node_id(), "index": index,
                        "pql": pql[:1024], "wave": 1,
                        "dedupeHit": False, "resultCacheHit": True,
                        "calls": [], "remote": [],
                        "totals": ctx.totals(),
                    })
                else:
                    profile_out.append(
                        {"disabled": True,
                         "reason": "cost plane is disabled on this node"})
            return payload
        except ApiError as e:
            err_status = e.status
            raise
        except Exception:
            err_status = 500
            raise
        finally:
            if slot is not None:
                slot.release()
            elapsed = time.perf_counter() - t_start
            if ctx is not None:
                error = err_status is not None and err_status >= 500
                self.cost.record_query(
                    tenant, index, ctx, elapsed, error=error,
                    result_cache_hit=err_status is None)
                if err_status != 429:
                    self.slo.record(elapsed, error=error)
            tracker.finish(inflight, inflight_token)

    # ---------------------------------------------------------------- schema

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> dict:
        self._check_not_storage_degraded()  # schema writes hit .meta
        try:
            idx = self.holder.create_index(name, keys=keys,
                                           track_existence=track_existence)
        except ValueError as e:
            status = 409 if "already exists" in str(e) else 400
            raise ApiError(str(e), status) from e
        return idx.schema()

    def create_field(self, index: str, name: str,
                     options: dict | None = None) -> dict:
        self._check_not_storage_degraded()  # schema writes hit .meta
        idx = self._index(index)
        try:
            field = idx.create_field(name, FieldOptions.from_dict(options or {}))
        except ValueError as e:
            status = 409 if "already exists" in str(e) else 400
            raise ApiError(str(e), status) from e
        return {"name": field.name, "options": field.options.to_dict()}

    def delete_index(self, name: str) -> None:
        """Delete an index: its files, its WAL ops (a durable tombstone)
        and every residency entry and heat record of it."""
        idx = self.holder.index(name)
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise ApiError(str(e), 404) from e
        heat.global_heat().forget(idx.scope, name)

    def delete_field(self, index: str, name: str) -> None:
        idx = self._index(index)
        try:
            idx.delete_field(name)
        except KeyError as e:
            raise ApiError(str(e), 404) from e
        heat.global_heat().forget(idx.scope, index, name)

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    # ---------------------------------------------------------------- import

    def import_bits(self, index: str, field: str, rows, columns,
                    timestamps=None, clear: bool = False,
                    remote: bool = False) -> int:
        """Bulk bit import (reference api.Import / fragment.bulkImport),
        grouped by shard and written fragment-wise: a mutex or bool field
        clears each column's previous row in the same pass, and a time
        field's timestamped bits also go into each quantum view, one bulk
        import a view and shard. Returns the bits changed in the standard
        view. ``remote`` (a peer's slice) skips the storage-degraded
        shed."""
        idx = self._index(index)
        fld = self._field(idx, field)
        if not remote:
            self._check_not_storage_degraded()
        try:
            rows_i = np.asarray(rows, dtype=np.int64)
            columns_i = np.asarray(columns, dtype=np.int64)
        except OverflowError as e:
            raise ApiError(f"row/column id out of range: {e}") from e
        if rows_i.shape != columns_i.shape:
            raise ApiError("rows and columns must be the same length")
        if rows_i.size and (rows_i.min() < 0 or columns_i.min() < 0):
            raise ApiError("rows and columns must be non-negative")
        if timestamps is not None and len(timestamps) != rows_i.size:
            raise ApiError("timestamps must match rows length")
        if (fld.options.type == TYPE_BOOL and rows_i.size
                and rows_i.max() > 1):
            raise ApiError("bool field rows must be 0 (false) or 1 (true)")
        rows = rows_i.astype(np.uint64)
        columns = columns_i.astype(np.uint64)
        if rows.size == 0:
            return 0
        order, bounds, shards_sorted = shard_groups(columns)
        rows, columns = rows[order], columns[order]
        stamps = ([timestamps[i] for i in order]
                  if timestamps is not None and fld.options.type == TYPE_TIME
                  else None)
        mutex = fld.options.type in (TYPE_MUTEX, TYPE_BOOL)
        t0 = time.perf_counter()
        # the view once, before the groups fan out
        view = None if clear else fld.view(VIEW_STANDARD, create=True)

        def apply_group(i: int) -> int:
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if clear:
                return sum(fld.clear_bit(int(r), int(c)) for r, c in zip(
                    rows[lo:hi].tolist(), columns[lo:hi].tolist()))
            shard = int(shards_sorted[lo])
            pos = columns[lo:hi] & np.uint64(SHARD_WIDTH - 1)
            idx.mark_columns_exist(columns[lo:hi])
            frag = view.fragment(shard, create=True)
            if mutex:
                changed = frag.import_mutex(rows[lo:hi], pos)
            else:
                changed = frag.bulk_import(rows[lo:hi], pos)
            if stamps is not None:
                self._import_time_views(fld, shard, rows[lo:hi], pos,
                                        stamps[lo:hi])
            return changed

        n_groups = bounds.size - 1
        with self.holder.cache.batch_writes():
            if n_groups > 1 and self.ingest_workers > 1:
                # shard groups touch disjoint fragments, each under its
                # own lock; their K3 patches collect in the request's
                # batch and launch when it closes
                changed = sum(concurrent_map(
                    apply_group, range(n_groups),
                    max_workers=self.ingest_workers))
            else:
                changed = sum(apply_group(i) for i in range(n_groups))
        elapsed = time.perf_counter() - t0
        if cost_enabled():
            # write heat: one record a shard group, weighted by its bits
            record = heat.global_heat().record_write
            for i in range(n_groups):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                record(index, field, int(shards_sorted[lo]),
                       n=float(hi - lo), scope=idx.scope)
        self._ingest_stats("bits", rows.size, elapsed)
        self._ack_durable()
        return int(changed)

    @staticmethod
    def _ingest_stats(kind: str, n: int, elapsed: float | None) -> None:
        """The reference's ingest series of one import."""
        stats = global_stats()
        tags = {"kind": kind}
        stats.count("ingest_rows", n, tags=tags)
        stats.observe("ingest_batch_size", n, tags=tags)
        if elapsed is None:
            return
        stats.timing("ingest_apply", elapsed, tags=tags)
        if elapsed > 0:
            stats.gauge("ingest_rows_per_sec", n / elapsed, tags=tags)

    @staticmethod
    def _import_time_views(fld, shard: int, rows, pos, stamps) -> None:
        """One shard's timestamped bits into the quantum views of their
        timestamps, one bulk import a view (a bit without a timestamp
        stays in the standard view alone)."""
        by_view: dict[str, list] = {}
        for j, ts in enumerate(stamps):
            if not ts:
                continue
            for vname in views_for_time(VIEW_STANDARD,
                                        fld.options.time_quantum,
                                        parse_time(ts)):
                by_view.setdefault(vname, []).append(j)
        for vname, sel in by_view.items():
            sel = np.asarray(sel, np.int64)
            fld.view(vname, create=True).fragment(
                shard, create=True).bulk_import(rows[sel], pos[sel])

    def import_values(self, index: str, field: str, columns, values,
                      clear: bool = False, remote: bool = False) -> int:
        """Batched BSI value import (reference api.ImportValue), single
        node: duplicate columns keep the last value; imported columns are
        marked existing. ``clear`` clears the columns' values instead."""
        idx = self._index(index)
        fld = self._field(idx, field)
        if not remote:
            self._check_not_storage_degraded()
        if fld.options.type != TYPE_INT:
            raise ApiError(f"field {field!r} is not an int field")
        if len(columns) != len(values):
            raise ApiError("columns and values must be the same length")
        try:
            cols_i = np.asarray(columns, dtype=np.int64)
        except OverflowError as e:  # ids beyond int64: a 400, not a 500
            raise ApiError(f"column id out of range: {e}") from e
        if cols_i.size and cols_i.min() < 0:
            raise ApiError(f"column {int(cols_i.min())} is negative")
        changed = 0
        t0 = time.perf_counter()
        with self.holder.cache.batch_writes():
            try:
                if clear:
                    for col in cols_i.tolist():
                        changed += fld.clear_value(int(col))
                else:
                    changed = fld.import_values(cols_i.astype(np.uint64),
                                                values)
                    idx.mark_columns_exist(cols_i)
            except (ValueError, OverflowError) as e:
                raise ApiError(str(e)) from e
        elapsed = time.perf_counter() - t0
        if cost_enabled():
            # write heat: one record a shard, weighted by its columns
            shards_u, counts_u = np.unique(cols_i >> SHARD_WIDTH_EXP,
                                           return_counts=True)
            for shard, n in zip(shards_u.tolist(), counts_u.tolist()):
                heat.global_heat().record_write(index, field, int(shard),
                                                n=float(n), scope=idx.scope)
        self._ingest_stats("values", cols_i.size, elapsed)
        self._ack_durable()
        return int(changed)

    def import_roaring(self, index: str, field: str, shard: int,
                       data: bytes, remote: bool = False,
                       submitted_out: list | None = None) -> int:
        """One shard's bits as a roaring bitmap of ``row << 20 | position``
        ids, in the port's layout or upstream pilosa's (``load_any``
        sniffs the cookie), unioned into the standard view's fragment in
        one locked pass: one op record, and one K3 launch for every
        resident leaf the rows touch. A malformed body is a 400, more
        bits than max-writes-per-request a 413 (``remote``, a peer's
        slice, skips that limit and the storage-degraded shed). Returns
        the bits changed; ``submitted_out`` (a list) receives the bits
        the body held, which the tenant ledger bills."""
        idx = self._index(index)
        fld = self._field(idx, field)
        if not remote:
            self._check_not_storage_degraded()
        frag = fld.view(VIEW_STANDARD, create=True).fragment(shard,
                                                             create=True)
        try:
            bitmap, _ = load_any(data)
            ids = bitmap.to_ids()
        except ValueError as e:
            raise ApiError(str(e)) from e
        if submitted_out is not None:
            submitted_out.append(int(ids.size))
        limit = self.max_writes_per_request
        if not remote and 0 < limit < int(ids.size):
            raise ApiError(
                f"import-roaring body of {int(ids.size)} bits exceeds "
                f"max-writes-per-request {limit}; split the bitmap", 413)
        positions = np.unique(ids & np.uint64(SHARD_WIDTH - 1))
        with self.holder.cache.batch_writes():
            try:
                changed = frag.add_ids(ids)
            except ValueError as e:
                raise ApiError(str(e)) from e
            idx.mark_columns_exist(
                (shard << SHARD_WIDTH_EXP) + positions.astype(np.int64))
        self._ingest_stats("roaring", int(ids.size), None)
        if cost_enabled():
            heat.global_heat().record_write(index, field, shard,
                                            n=float(ids.size),
                                            scope=idx.scope)
        self._ack_durable()
        return changed

    # ---------------------------------------------------------------- export

    def export_csv_bytes(self, index: str, field: str) -> bytes:
        """``row,column`` lines of the standard view in shard, row and
        column order, a newline after each (reference api.ExportCSV),
        formatted by numpy from each fragment's sorted bit ids."""
        idx = self._index(index)
        fld = self._field(idx, field)
        view = fld.view(VIEW_STANDARD)
        rows, cols = [], []
        if view is not None:
            for shard in sorted(view.fragments):
                ids = view.fragment(shard).bitmap.to_ids()
                rows.append(ids >> np.uint64(SHARD_WIDTH_EXP))
                cols.append((ids & np.uint64(SHARD_WIDTH - 1))
                            + np.uint64(shard << SHARD_WIDTH_EXP))
        if not rows:
            return b""
        return csv_lines(np.concatenate(rows), np.concatenate(cols))

    def export_csv(self, index: str, field: str) -> str:
        return self.export_csv_bytes(index, field).decode()

    def recalculate_caches(self) -> None:
        """Recount and save every fragment's row-count cache (reference
        ``POST /recalculate-caches``), before returning. A recount can
        change TopN answers with no write: each index's cached results
        are fenced."""
        for idx in list(self.holder.indexes.values()):
            for field in list(idx.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        frag.recalculate_cache()
            invalidate_index_wide(idx.scope, idx.name)

    # ---------------------------------------------------------------- status

    def status(self) -> dict:
        health = self.holder.health
        out = {
            "state": "NORMAL",
            "nodes": [{"id": "local", "uri": "localhost",
                       "isCoordinator": True, "state": "NORMAL"}],
            "localID": "local",
            "maxWritesPerRequest": self.max_writes_per_request,
            "epoch": 0,
            "clusterDegraded": False,
            "storageDegraded": bool(health.degraded),
            "storageDegradedReason": health.reason,
        }
        if self.mpserve is not None:
            out["servingWorkers"] = self.mpserve.workers_json()
        return out

    def info(self) -> dict:
        """The reference's ``/info``, but for ``devices``: the port lists
        its torch device, ``{"id": 0, "platform": "gpu", "kind": <the
        card's name>}`` on a GPU and platform "cpu" under
        ``device="cpu"``, where the reference lists its JAX devices."""
        dev = self.holder.device
        if dev.type == "cuda":
            import torch

            index = dev.index if dev.index is not None else 0
            devices = [{"id": index, "platform": "gpu",
                        "kind": torch.cuda.get_device_name(index)}]
        else:
            devices = [{"id": 0, "platform": "cpu", "kind": "cpu"}]
        return {"shardWidth": SHARD_WIDTH, "cpuPhysicalCores": 0,
                "version": __version__, "devices": devices}

    def version(self) -> dict:
        return {"version": __version__}

    def max_shards(self) -> dict:
        return {"standard": {name: (idx.available_shards() or [0])[-1]
                             for name, idx in self.holder.indexes.items()}}

    def tiering_metrics(self) -> dict:
        """The tierer's ``residency_tier_*`` pass counters, zeros with no
        tierer."""
        if self.tierer is not None:
            return self.tierer.metrics()
        return {
            "residency_tier_passes_total": 0,
            "residency_tier_pass_promotions_total": 0,
            "residency_tier_pass_demotions_total": 0,
            "residency_tier_promoted_bytes_total": 0,
            "residency_tier_demoted_bytes_total": 0,
            "residency_tier_paced_sleep_seconds_total": 0.0,
            "residency_tier_last_pass_seconds": 0.0,
        }

    def durability_metrics(self) -> dict:
        """The WAL's series of the reference's ``wal`` block (its CDC
        series come with the CDC plane)."""
        out = self.holder.wal.metrics()
        del out["retained_bytes"]  # the reference's cdc_retained_bytes
        return out

    def integrity_metrics(self) -> dict:
        """The storage-integrity series: the degraded latch, the
        verified-load and quarantine counters and the scrubber's, every
        key present from the first read."""
        out = {
            "scrub_passes_total": 0,
            "scrub_fragments_scanned_total": 0,
            "scrub_bytes_total": 0,
            "scrub_corruptions_detected_total": 0,
            "scrub_read_repairs_total": 0,
            "scrub_self_heals_total": 0,
            "scrub_unrepaired_total": 0,
            "scrub_last_pass_seconds": 0.0,
            "scrub_paced_sleep_seconds": 0.0,
        }
        out.update(global_integrity().metrics())
        out.update(self.holder.health.metrics())
        if self.scrubber is not None:
            out.update(self.scrubber.metrics())
        return out

    def scrub_now(self) -> dict:
        """One scrub pass (``POST /internal/scrub``, ``check --host``):
        the server's scrubber when one runs (its pacing budget shared),
        else an unpaced one kept so that passes add up in the counters."""
        if self.scrubber is None:
            self.scrubber = Scrubber(self.holder)
        return self.scrubber.scrub_pass()

    def observability_metrics(self) -> dict:
        """Tracing, in-flight and slow-query series, every key present
        from the first scrape."""
        out = {"slow_queries_total": self.slow_queries_total}
        out.update(global_tracer().metrics())
        out.update(global_query_tracker().metrics())
        return out

    def tenants_json(self, k: int = 10, by: str = "device_ms") -> dict:
        """``GET /debug/tenants``: the per-(tenant, index) cost table and
        its top-K by one column."""
        return {
            "tenants": self.cost.snapshot(),
            "top": self.cost.top(k, by=by),
            "by": by,
            "totals": self.cost.metrics(),
        }

    def start_device_trace(self, seconds: float) -> dict:
        """Capture a ``torch.profiler`` trace around ``seconds`` of live
        traffic (``POST /debug/trace-device``) into the trace log dir:
        CPU ops and, on a CUDA server, every kernel the process
        launches, as one Chrome trace file. One capture at a time (409
        for a second); on a CUDA server whose torch cannot trace the
        card, or whose capture recorded no kernel, the route fails (500)
        rather than write a CPU-only trace."""
        seconds = float(seconds)
        if not 0 < seconds <= 60:
            raise ApiError("secs must be in (0, 60]")
        log_dir = os.path.expanduser(
            self.trace_log_dir
            or os.path.join(self.holder.data_dir, "jax-traces"))
        if not self._device_trace_lock.acquire(blocking=False):
            raise ApiError("a device trace capture is already running", 409)
        try:
            os.makedirs(log_dir, exist_ok=True)
            t0 = time.perf_counter()
            capture_device_trace(log_dir, self.holder.device, seconds)
            return {"logDir": log_dir,
                    "seconds": round(time.perf_counter() - t0, 3)}
        finally:
            self._device_trace_lock.release()

    def pipeline_metrics(self) -> dict:
        """The wave counters, zeros until the first pipelined read."""
        pipe = self._pipeline
        if pipe is None:
            return {"waves": 0, "coalesced": 0, "deduped": 0}
        return {"waves": pipe.waves, "coalesced": pipe.coalesced,
                "deduped": pipe.deduped}

    def fastlane_metrics(self) -> dict:
        """The reference's fast-lane series: its connection pool and
        remote wave batcher are cluster planes, zeros on one node (the
        HTTP server adds its connection and request counts)."""
        return {
            "pool_connections_created_total": 0,
            "pool_connections_reused_total": 0,
            "pool_connections_discarded_total": 0,
            "pool_requests_total": 0,
            "pool_idle_connections": 0,
            "remote_batches_total": 0,
            "remote_batched_queries_total": 0,
            "remote_batch_solo_total": 0,
            "remote_batch_fallbacks_total": 0,
        }

    def mp_metrics(self) -> dict:
        """The multi-process serving series, zeros in single-process
        mode from the first scrape."""
        if self.mpserve is not None:
            return self.mpserve.metrics()
        return {
            "serving_workers": 0,
            "serving_ring_depth": 0,
            "serving_ring_full_total": 0,
            "serving_owner_batch_size": 0.0,
            "serving_owner_batches_total": 0,
            "serving_owner_batched_requests_total": 0,
            "serving_ring_requests_total": 0,
            "serving_worker_shed_total": 0,
            "serving_worker_proxied_total": 0,
            "serving_worker_respawns_total": 0,
            "serving_workers_reaped_total": 0,
            "serving_responses_dropped_total": 0,
            "serving_ring_queries_total": 0,
            "serving_ring_deduped_total": 0,
        }

    def workers_json(self) -> dict:
        """``GET /debug/workers``: a row a worker (id, generation, pid,
        liveness, ring depth, its counters, its ring round-trip
        quantiles)."""
        if self.mpserve is None:
            return {"enabled": False, "workers": []}
        return {
            "enabled": True,
            "port": self.mpserve.port,
            "ownerPort": self.mpserve.owner_port,
            "workers": self.mpserve.workers_json(),
        }

    def rescache_metrics(self) -> dict:
        """The ``result_cache_*`` series, zeros while the cache is off."""
        return global_result_cache().metrics()

    def rescache_json(self, k: int = 100) -> dict:
        """``GET /debug/rescache``: the entries hottest first, with the
        totals and the configuration."""
        cache = global_result_cache()
        out = cache.inspect(k=k)
        out["enabled"] = cache.enabled
        return out

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index {name!r} not found", 404)
        return idx

    @staticmethod
    def _field(idx, name: str):
        fld = idx.field(name)
        if fld is None:
            raise ApiError(f"field {name!r} not found", 404)
        return fld

"""Tracing: context-propagating sampled spans and the query inspector
(the port's copy of ``pilosa_tpu.utils.tracing``).

- The active span rides ``contextvars``; every cross-thread handoff (the
  serving pipeline's wave queue, ``utils.pool``) captures the submitting
  context and restores it on the worker, so a span started anywhere
  lands in its request's tree.
- ``sample_rate`` (0..1) decides per request root; rate 0 returns a
  shared no-op handle. Child spans join the active trace or no-op.
- ``X-Pilosa-Trace: <trace_id>:<parent_span_id>`` roots a request's
  span under a caller's trace.
- ``QueryTracker`` (always on) backs ``GET /debug/queries``: trace id,
  PQL, index, age and stage of every live query.

On the device side, ``capture_device_trace`` captures a
``torch.profiler`` trace (``POST /debug/trace-device``).
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
from collections import deque

# Request header carrying trace context on internal hops
# (cluster_exec sub-queries, wave batches, sync manifest/blocks).
TRACE_HEADER = "X-Pilosa-Trace"


def _new_trace_id() -> str:
    return f"{random.getrandbits(64):016x}"


def _new_span_id() -> str:
    return f"{random.getrandbits(48):012x}"


class Span:
    """One timed operation in a trace tree.

    ``children`` may be appended from several threads (list.append is
    atomic under the GIL); ``to_json`` snapshots. ``remote`` holds
    subtrees another process finished and serialized (a serving
    worker's owner-side ``rpc.query``): they render as children with
    their own span ids, whose ``parentId`` is this span's id."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "parent",
                 "start", "end", "tags", "children", "remote")

    def __init__(self, name: str, tags: dict | None = None,
                 trace_id: str | None = None, parent: "Span | None" = None,
                 parent_id: str | None = None):
        self.name = name
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent = parent
        self.parent_id = parent.span_id if parent is not None else parent_id
        self.start = time.perf_counter()
        self.end = None
        self.tags = tags if tags is not None else {}
        self.children: list[Span] = []
        self.remote: list[dict] = []

    @property
    def duration(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def finish(self) -> None:
        if self.end is None:
            self.end = time.perf_counter()

    def root(self) -> "Span":
        s = self
        while s.parent is not None:
            s = s.parent
        return s

    def add_remote(self, subtree: dict) -> None:
        """Attach a serialized span subtree under this span."""
        if isinstance(subtree, dict):
            self.remote.append(subtree)

    def header_value(self) -> str:
        """This span as an ``X-Pilosa-Trace`` value (child hops parent
        to it)."""
        return f"{self.trace_id}:{self.span_id}"

    def to_json(self) -> dict:
        out = {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "durationMs": round(self.duration * 1e3, 3),
            "tags": self.tags,
            "children": ([c.to_json() for c in list(self.children)]
                         + list(self.remote)),
        }
        if self.parent_id is not None:
            out["parentId"] = self.parent_id
        return out


def parse_trace_header(value: str | None):
    """``"<trace_id>:<span_id>"`` → tuple, or None when absent/malformed
    (a malformed header must degrade to untraced, never 500)."""
    if not value:
        return None
    parts = value.strip().split(":")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        return None
    return parts[0], parts[1]


# The active span of the current logical request. None = not in a trace;
# _NOT_SAMPLED = the request's root made a negative sampling decision, so
# inner span sites must not re-sample their own roots.
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "pilosa_tpu_torch_trace_span", default=None
)
_NOT_SAMPLED = object()


def current_span() -> Span | None:
    cur = _current_span.get()
    return cur if isinstance(cur, Span) else None


class _NopHandle:
    """Shared no-op span handle: tracing off (or unsampled subtree) costs
    one contextvar read and zero allocations."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOP = _NopHandle()


class _SpanHandle:
    """Context manager activating one span in the current context."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._token = _current_span.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        span = self._span
        span.finish()
        if exc is not None and "error" not in span.tags:
            span.tags["error"] = str(exc) or exc_type.__name__
        _current_span.reset(self._token)
        if span.parent is None:
            self._tracer._record_root(span)
        return False


class _SuppressHandle:
    """Marks the request NOT SAMPLED for its whole context, so inner span
    sites (executor.Execute, remote legs) cannot root their own traces."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _current_span.set(_NOT_SAMPLED)
        return None

    def __exit__(self, *exc):
        _current_span.reset(self._token)
        return False


@contextlib.contextmanager
def use_span(span: Span):
    """Re-activate an existing span in this context (the query-batch
    receiver runs one item's submit and resolve phases at different
    points of its loop)."""
    token = _current_span.set(span)
    try:
        yield span
    finally:
        _current_span.reset(token)


class Tracer:
    """Sampled, context-propagating tracer; keeps the last N root trees."""

    def __init__(self, keep: int = 64, sample_rate: float = 0.0):
        self.sample_rate = sample_rate
        self.keep = keep
        self._lock = threading.Lock()
        self.finished: deque = deque(maxlen=keep)
        self.sampled_traces = 0
        self.spans_started = 0

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    # ------------------------------------------------------------ span sites

    def span(self, name: str, **tags):
        """Child span joining the active trace; no-op outside one.

        Join-only by design: instrumentation sites scattered through the
        planes (conn.checkout, wal.barrier, device.dispatch, ...) must
        never root standalone trees off background traffic — only the
        designated root sites (``request_root``, ``remote_root``,
        ``root_span``) start traces."""
        cur = _current_span.get()
        if cur is None or cur is _NOT_SAMPLED:
            return _NOP
        self.spans_started += 1
        span = Span(name, tags, trace_id=cur.trace_id, parent=cur)
        cur.children.append(span)
        return _SpanHandle(self, span)

    def root_span(self, name: str, **tags):
        """Join the active trace, or — outside one — ROOT a new trace
        subject to sampling. For sites that ARE a sensible trace root
        when reached directly: ``executor.Execute`` (in-process callers,
        tests, CLI) and ``sync.pass`` (the anti-entropy ticker)."""
        cur = _current_span.get()
        if cur is None:
            return self._maybe_root(name, tags)
        return self.span(name, **tags)

    def request_root(self, name: str, **tags):
        """Root span site for an EDGE request: samples once, and on a
        negative decision suppresses sampling for the whole request so
        exactly zero or one tree exists per request."""
        cur = _current_span.get()
        if isinstance(cur, Span):  # nested (in-process client re-entry)
            return self.span(name, **tags)
        rate = self.sample_rate
        if rate <= 0.0:
            return _NOP
        if rate < 1.0 and random.random() >= rate:
            return _SuppressHandle()
        self.sampled_traces += 1
        self.spans_started += 1
        return _SpanHandle(self, Span(name, tags))

    def remote_root(self, header_value: str | None, name: str, **tags):
        """Root span for a remote hop carrying ``X-Pilosa-Trace``. The
        coordinator already sampled, so the callee always traces when the
        header parses; without one, local sampling is SUPPRESSED — a
        remote sub-query belongs to its root's decision either way."""
        parsed = parse_trace_header(header_value)
        if parsed is None:
            return _SuppressHandle()
        trace_id, parent_id = parsed
        self.spans_started += 1
        return _SpanHandle(
            self, Span(name, tags, trace_id=trace_id, parent_id=parent_id)
        )

    def remote_span(self, header_value: str | None, name: str,
                    **tags) -> Span | None:
        """A detached span rooted under ``X-Pilosa-Trace``'s parent, for
        work whose subtree is shipped back to the caller (the serving
        owner's ``rpc.query``) and activated with ``use_span``. None
        when the header is absent or malformed. ``finish_root`` ends it
        and records it here; a caller that ships it finishes it
        itself."""
        parsed = parse_trace_header(header_value)
        if parsed is None:
            return None
        self.spans_started += 1
        return Span(name, tags, trace_id=parsed[0], parent_id=parsed[1])

    def finish_root(self, span: Span) -> None:
        """End a detached root span (``remote_span``) and record it in
        the finished ring."""
        span.finish()
        self._record_root(span)

    def _maybe_root(self, name: str, tags: dict):
        rate = self.sample_rate
        if rate <= 0.0:
            return _NOP
        if rate < 1.0 and random.random() >= rate:
            return _NOP
        self.sampled_traces += 1
        self.spans_started += 1
        return _SpanHandle(self, Span(name, tags))

    # -------------------------------------------------------------- finished

    def _record_root(self, span: Span) -> None:
        self.finished.append(span)  # deque(maxlen): atomic, bounded

    def record_foreign_tree(self, tree: dict) -> None:
        """Record a finished tree another process serialized: a serving
        worker's edge span with the owner's subtree grafted, shipped over
        the handshake channel, so ``/debug/traces`` shows one tree a
        request in either deployment shape."""
        if isinstance(tree, dict):
            self.sampled_traces += 1
            self.finished.append(_ForeignTree(tree))

    def recent(self) -> list[dict]:
        return [s.to_json() for s in list(self.finished)]

    def clear(self) -> None:
        self.finished.clear()
        self.sampled_traces = 0
        self.spans_started = 0

    def metrics(self) -> dict:
        return {
            "tracing_sampled_traces_total": self.sampled_traces,
            "tracing_spans_total": self.spans_started,
            "tracing_finished_traces": len(self.finished),
            "tracing_sample_rate": self.sample_rate,
        }


class _ForeignTree:
    """A finished span tree serialized by another process; quacks like a
    Span for the finished ring."""

    __slots__ = ("tree",)

    def __init__(self, tree: dict):
        self.tree = tree

    def to_json(self) -> dict:
        return self.tree


_global_tracer: Tracer | None = None


def global_tracer() -> Tracer:
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = Tracer()
    return _global_tracer


def set_global_tracer(tracer: Tracer) -> None:
    global _global_tracer
    _global_tracer = tracer


# ------------------------------------------------------ in-flight inspector


class InflightQuery:
    """One live query's inspector record. ``stage`` and
    ``shards_outstanding`` are plain attribute writes (no lock): the
    writers are the query's own threads and readers tolerate tearing —
    this is a debugging view, not an accounting ledger."""

    __slots__ = ("qid", "trace_id", "index", "pql", "tenant", "remote",
                 "started", "started_wall", "stage", "shards_outstanding")

    def __init__(self, qid: int, index: str, pql: str, tenant: str,
                 remote: bool, trace_id: str | None):
        self.qid = qid
        self.trace_id = trace_id
        self.index = index
        self.pql = pql
        self.tenant = tenant
        self.remote = remote
        self.started = time.perf_counter()
        self.started_wall = time.time()
        self.stage = "start"
        self.shards_outstanding: int | None = None

    def to_json(self) -> dict:
        out = {
            "id": self.qid,
            "index": self.index,
            "pql": self.pql,
            "tenant": self.tenant,
            "remote": self.remote,
            "ageSeconds": round(time.perf_counter() - self.started, 4),
            "stage": self.stage,
        }
        if self.trace_id is not None:
            out["traceId"] = self.trace_id
        if self.shards_outstanding is not None:
            out["shardsOutstanding"] = self.shards_outstanding
        return out


_current_query: contextvars.ContextVar = contextvars.ContextVar(
    "pilosa_tpu_torch_inflight_query", default=None
)


def current_query() -> InflightQuery | None:
    """The inspector record of the query owning this context (rides the
    same capture-and-restore hops as the trace context), so deep layers
    (cluster fan-out) can update stage/shards without plumbing."""
    return _current_query.get()


class QueryTracker:
    """Registry of in-flight queries behind ``GET /debug/queries``.

    Always on by default — the long-running-query view matters exactly
    when something is stuck, regardless of trace sampling. Cost per query
    is one lock round trip each for start/finish; ``enabled = False``
    turns even that off (the bench's bare baseline)."""

    def __init__(self):
        self.enabled = True
        self._lock = threading.Lock()
        self._live: dict[int, InflightQuery] = {}
        self._next = 0
        self.started_total = 0

    def start(self, index: str, pql, tenant: str = "default",
              remote: bool = False) -> InflightQuery | None:
        if not self.enabled:
            return None
        cur = current_span()
        q = InflightQuery(
            0, index,
            (pql[:1024] if isinstance(pql, str) else str(pql)[:1024]),
            tenant, remote, cur.trace_id if cur is not None else None,
        )
        with self._lock:
            self._next += 1
            q.qid = self._next
            self.started_total += 1
            self._live[q.qid] = q
        return q

    def activate(self, q: InflightQuery):
        """Bind ``q`` to the current context; returns a reset token."""
        return _current_query.set(q)

    def finish(self, q: InflightQuery | None, token=None) -> None:
        if q is None:
            return
        if token is not None:
            _current_query.reset(token)
        with self._lock:
            self._live.pop(q.qid, None)

    def snapshot(self) -> list[dict]:
        with self._lock:
            live = list(self._live.values())
        return [q.to_json() for q in
                sorted(live, key=lambda q: q.started)]

    def metrics(self) -> dict:
        with self._lock:
            return {
                "inflight_queries": len(self._live),
                "queries_tracked_total": self.started_total,
            }


_global_query_tracker: QueryTracker | None = None


def global_query_tracker() -> QueryTracker:
    global _global_query_tracker
    if _global_query_tracker is None:
        _global_query_tracker = QueryTracker()
    return _global_query_tracker


# ----------------------------------------------------------- device tracing


def device_trace_activities(device):
    """The ``torch.profiler`` activities of a capture on ``device``: the
    CPU, and on a CUDA device the card's kernels and copies. Raises
    RuntimeError on a CUDA device when this torch cannot trace the card
    (no CUPTI): a CPU-only trace of a CUDA server would hide every
    kernel."""
    from torch.profiler import ProfilerActivity, supported_activities

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "this torch build cannot trace CUDA activity (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    return activities


def prepare_device_tracing(device) -> None:
    """Run one empty ``torch.profiler`` session on the calling thread
    (the server's opening thread) on a CUDA device, so that the
    profiler's CUPTI setup is done there and then, not by the first
    capture under load. On an H100 80GB HBM3 the first capture of a
    ``chip_smoke.py`` run recorded no kernel event in 2 of 2 runs whose
    server had run no session, and recorded kernels in 4 of 4 runs with
    this session at open."""
    if device.type != "cuda":
        return
    from torch.profiler import profile

    with profile(activities=device_trace_activities(device)):
        pass


def capture_device_trace(log_dir: str, device, seconds: float) -> str:
    """Capture ``seconds`` of a ``torch.profiler`` trace of CPU ops and,
    on a CUDA device, every kernel the process launches (the
    hand-written kernels included), and export it as a Chrome trace file
    into ``log_dir`` (open it in Perfetto or chrome://tracing); returns
    its path. Exposed live at ``POST /debug/trace-device?secs=N``.

    On a CUDA device a trace that holds no kernel event is deleted and
    RuntimeError raised: on the H100 some sessions under load record the
    CPU side only (``scripts/trace_probe.py``), and such a file would
    pass for a trace of the card."""
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = device_trace_activities(device)
    with profile(activities=activities) as prof:
        time.sleep(seconds)
        if ProfilerActivity.CUDA in activities:
            # the kernels launched in the window finish inside the session
            torch.cuda.synchronize(device)
    path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if device.type == "cuda":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            os.unlink(path)
            raise RuntimeError("the device trace recorded no CUDA kernel "
                               f"event in {seconds} s; no trace written")
    return path

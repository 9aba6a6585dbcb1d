"""HTTP transport (reference http/handler.go), the port's copy.

Routes, with the reference's request and response bytes:

- ``POST /index/{i}`` and ``POST /index/{i}/field/{f}``: schema (field
  ``type`` set, int, time with its ``timeQuantum``, mutex or bool);
  ``GET /index/{i}`` its schema; ``DELETE /index/{i}`` and ``DELETE
  /index/{i}/field/{f}`` (404 on an unknown name);
- ``POST /index/{i}/query``: PQL in, ``{"results": [...]}`` out: Count,
  row algebra, Range, time windows (``from=``/``to=``), Shift, Not/All,
  Sum/Min/Max, TopN (``attrName=``), Rows (``like=``), GroupBy
  (``aggregate=Sum``, ``having=``), IncludesColumn, Options (``shards=``,
  ``excludeColumns=``, ``columnAttrs=``), Set (``timestamp=``), Clear,
  ClearRow, Store, SetRowAttrs and SetColumnAttrs, with string keys on
  keyed indexes and fields; the URL parameters ``shards=0,1`` (the calls
  run over those shards), ``remote`` and ``columnAttrs``,
  ``excludeColumns`` and ``excludeRowAttrs`` (``=true``, on every row
  result of the request);
- ``POST /index/{i}/field/{f}/import``: ``rows``/``columns`` and optional
  ``timestamps``; ``.../import-value``: ``columns``/``values`` for int
  fields; ``.../import-roaring/{shard}``: one shard's bits as a roaring
  bitmap, in the port's layout or upstream pilosa's (each body at most
  max-writes-per-request bits: 413 over it, 400 if malformed);
- protobuf (``application/x-protobuf``): a ``QueryRequest`` body and a
  ``QueryResponse`` answer (``Accept``), errors then encoded as a
  ``QueryResponse.err``; ``ImportRequest`` and ``ImportValueRequest``
  bodies. Without the ``google.protobuf`` runtime these answer 406;
- ``GET /export?index=&field=``: the standard view as ``row,column`` CSV;
- ``GET /schema`` and ``/internal/schema``, ``/status``, ``/info`` (the
  reference's, with the torch device under ``devices``), ``/version``,
  ``/internal/shards/max`` and ``/metrics`` (Prometheus text: the row
  cache, the tierer, the WAL and the integrity plane);
- ``POST /recalculate-caches``: every fragment's row-count cache
  recounted and saved, 204;
- ``POST /internal/translate/keys`` (``namespace``, ``keys``, ``create``
  in, ``{"ids": [...]}`` out) and ``GET /internal/translate/data?offset=N``
  (the translate log's bytes from ``offset``);
- ``POST /internal/scrub``: one integrity scrub pass, its record out;
- the serving envelope's inspectors: ``GET /debug/traces``,
  ``/debug/tenants`` (``?k=&by=``), ``/debug/heatmap`` (``?k=``,
  ``?tier=true``), ``/debug/rescache`` (``?k=``), ``/debug/slo``,
  ``/debug/queries``, ``/debug/queries/slow`` (and its old name
  ``/debug/long-queries``), ``/debug/vars``, ``/debug/pprof`` (thread
  stacks) and ``POST /debug/trace-device?secs=N`` (a ``torch.profiler``
  capture);
- ``GET /debug/workers``: the multi-process serving workers' table
  (``{"enabled": false, ...}`` in single-process mode).

A query's QoS envelope comes from its headers: ``X-Pilosa-Tenant`` and
``X-Pilosa-Deadline-Ms`` (a positive integer of milliseconds, else a
400; without it the server default applies to edge requests).
``?profile=true`` splices the PROFILE tree into the JSON answer. An edge
request roots a sampled ``http.query`` trace; a ``remote=true`` request
with ``X-Pilosa-Trace: <trace>:<span>`` joins that trace and returns
its finished span tree in the answer. An error with a ``retry_after``
(a shed: 429 at admission, 503 while the storage is degraded) carries a
``Retry-After`` header.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.parallel.reduction import global_reduce_stats
from pilosa_tpu_torch.qos import DEADLINE_HEADER, TENANT_HEADER, Deadline
from pilosa_tpu_torch.roaring.kernels import global_kernel_stats
from pilosa_tpu_torch.roaring.merge_kernels import global_merge_stats
from pilosa_tpu_torch.server.api import API, ApiError
from pilosa_tpu_torch.storage.heat import global_heat
from pilosa_tpu_torch.utils.cost import cost_enabled
from pilosa_tpu_torch.utils.stats import global_stats, prometheus_block
from pilosa_tpu_torch.utils.tracing import (
    TRACE_HEADER,
    global_query_tracker,
    global_tracer,
)

_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("POST", re.compile(r"^/index/([^/]+)/query$"), "post_query"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)/import$"), "post_import"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)/import-value$"),
     "post_import_value"),
    ("POST", re.compile(
        r"^/index/([^/]+)/field/([^/]+)/import-roaring/(\d+)$"),
     "post_import_roaring"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "post_field"),
    ("DELETE", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "delete_field"),
    ("POST", re.compile(r"^/index/([^/]+)$"), "post_index"),
    ("GET", re.compile(r"^/index/([^/]+)$"), "get_index"),
    ("DELETE", re.compile(r"^/index/([^/]+)$"), "delete_index"),
    ("GET", re.compile(r"^/schema$"), "get_schema"),
    ("GET", re.compile(r"^/status$"), "get_status"),
    ("GET", re.compile(r"^/info$"), "get_info"),
    ("GET", re.compile(r"^/version$"), "get_version"),
    ("GET", re.compile(r"^/export$"), "get_export"),
    ("GET", re.compile(r"^/metrics$"), "get_metrics"),
    ("POST", re.compile(r"^/recalculate-caches$"), "post_recalculate_caches"),
    ("GET", re.compile(r"^/internal/shards/max$"), "get_shards_max"),
    ("POST", re.compile(r"^/internal/scrub$"), "post_scrub"),
    ("POST", re.compile(r"^/internal/translate/keys$"), "post_translate_keys"),
    ("GET", re.compile(r"^/internal/translate/data$"), "get_translate_data"),
    ("GET", re.compile(r"^/internal/schema$"), "get_schema"),
    ("GET", re.compile(r"^/debug/traces$"), "get_traces"),
    ("GET", re.compile(r"^/debug/tenants$"), "get_tenants"),
    ("GET", re.compile(r"^/debug/heatmap$"), "get_heatmap"),
    ("GET", re.compile(r"^/debug/rescache$"), "get_rescache"),
    ("GET", re.compile(r"^/debug/slo$"), "get_slo"),
    ("GET", re.compile(r"^/debug/workers$"), "get_workers"),
    ("GET", re.compile(r"^/debug/queries$"), "get_inflight_queries"),
    ("GET", re.compile(r"^/debug/queries/slow$"), "get_long_queries"),
    ("GET", re.compile(r"^/debug/long-queries$"), "get_long_queries"),
    ("POST", re.compile(r"^/debug/trace-device$"), "post_trace_device"),
    ("GET", re.compile(r"^/debug/vars$"), "get_debug_vars"),
    ("GET", re.compile(r"^/debug/pprof/?$"), "get_pprof"),
]

# the exposition prefix of /metrics, the reference's
METRICS_PREFIX = "pilosa_tpu"
PROTOBUF = "application/x-protobuf"


class HTTPHandler(BaseHTTPRequestHandler):
    api: API = None  # set by make_http_server
    protocol_version = "HTTP/1.1"
    # idle keep-alive connections close after this long
    timeout = 120
    # status line + headers + body leave as one write per response
    wbufsize = -1

    def log_message(self, fmt, *args):
        pass

    def setup(self):
        super().setup()
        # connections against requests: keep-alive reuse on /metrics
        with self.server.metrics_lock:
            self.server.connections_opened += 1
            self.server.open_connections.add(self.connection)

    def finish(self):
        with self.server.metrics_lock:
            self.server.open_connections.discard(self.connection)
        super().finish()

    def _dispatch(self, method: str):
        self._body_read = False
        with self.server.metrics_lock:
            self.server.requests_served += 1
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            # chunk framing left in rfile would be parsed as the next
            # request line: reject and close
            self._body_read = True
            self._json({"error": "chunked request bodies are not "
                                 "supported; send Content-Length"},
                       status=411, headers={"Connection": "close"})
            return
        parsed = urlparse(self.path)
        self._query = parse_qs(parsed.query)
        for m, pattern, handler in _ROUTES:
            if m != method:
                continue
            match = pattern.match(parsed.path)
            if match:
                try:
                    getattr(self, handler)(*match.groups())
                except ApiError as e:
                    headers = None
                    if e.retry_after is not None:
                        # a shed write: tell the client when to come back
                        headers = {"Retry-After":
                                   str(max(1, int(e.retry_after)))}
                    self._drain_body()
                    self._json({"error": str(e)}, status=e.status,
                               headers=headers)
                except Exception as e:  # internal error → 500, not a crash
                    self._drain_body()
                    self._json({"error": f"internal: {e}"}, status=500)
                else:
                    self._drain_body()
                return
        self._drain_body()
        self._json({"error": "not found"}, status=404)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    # -------------------------------------------------------------- helpers

    def _body(self) -> bytes:
        self._body_read = True
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _drain_body(self) -> None:
        """Consume an unread request body so the connection stays aligned
        on the next request."""
        if getattr(self, "_body_read", True):
            return
        self._body_read = True
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            self.close_connection = True
            return
        while length > 0:
            chunk = self.rfile.read(min(length, 1 << 16))
            if not chunk:
                break
            length -= len(chunk)

    def _json_body(self) -> dict:
        raw = self._body()
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(f"invalid JSON body: {e}") from e

    def _json(self, obj, status: int = 200, headers: dict | None = None):
        self._raw(json.dumps(obj).encode(), status=status, headers=headers)

    def _raw(self, data: bytes, status: int = 200,
             headers: dict | None = None,
             content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _qos_envelope(self, remote: bool = False):
        """(tenant, deadline) from the request's headers. Without a
        deadline header the server default applies to edge requests
        only: a peer's sub-query carries its root's budget."""
        tenant = (self.headers.get(TENANT_HEADER) or "default").strip()
        raw = self.headers.get(DEADLINE_HEADER)
        if raw is not None:
            try:
                millis = int(raw)
                if millis <= 0:
                    raise ValueError
            except ValueError:
                raise ApiError(
                    f"invalid {DEADLINE_HEADER} header {raw!r}: must be a "
                    "positive integer of milliseconds"
                ) from None
            return tenant, Deadline.from_millis(millis)
        if not remote and self.api.default_deadline_s > 0:
            return tenant, Deadline.after(self.api.default_deadline_s)
        return tenant, None

    def _note_egress(self, tenant: str, index: str, nbytes: int,
                     remote: bool) -> None:
        """An edge query answer's bytes into the tenant ledger."""
        if not remote and cost_enabled():
            self.api.cost.add_egress(tenant, index, nbytes)

    def _note_ingest(self, index: str, rows: int, remote: bool) -> None:
        """An edge import's rows into the tenant ledger, under the
        tenant header."""
        if not remote and cost_enabled():
            tenant = (self.headers.get(TENANT_HEADER) or "default").strip()
            self.api.cost.add_ingest(tenant, index, rows)

    # --------------------------------------------------------------- routes

    def _flag(self, name: str) -> bool:
        return self._query.get(name, ["false"])[0] == "true"

    @staticmethod
    def _need_wire() -> None:
        from pilosa_tpu_torch import wire

        if not wire.available():
            raise ApiError("protobuf wire format unavailable", 406)

    def post_query(self, index):
        raw = self._body()
        proto_in = PROTOBUF in self.headers.get("Content-Type", "")
        proto_out = PROTOBUF in self.headers.get("Accept", "")
        if self._flag("profile") and proto_out:
            raise ApiError(
                "profile=true requires a JSON response (drop the "
                "application/x-protobuf Accept header)")
        if proto_in or proto_out:
            self._need_wire()
        if proto_in:
            from pilosa_tpu_torch.wire.serializer import decode_query_request

            pql, shards, remote, opts = decode_query_request(raw)
        else:
            try:
                pql = raw.decode()
            except UnicodeDecodeError as e:
                raise ApiError(f"query is not UTF-8: {e}") from e
            shards = None
            if "shards" in self._query:
                shards = [_int_param(s, "shards")
                          for s in self._query["shards"][0].split(",")]
            remote = self._flag("remote")
            opts = {}
        # request-level result options (reference handler query args)
        opts.update({k: True for k in ("columnAttrs", "excludeColumns",
                                       "excludeRowAttrs") if self._flag(k)})
        tenant, deadline = self._qos_envelope(remote=remote)
        profile_out = [] if self._flag("profile") else None
        # an edge request samples its trace here (one tree, or none for
        # the whole request); a peer's sub-query with X-Pilosa-Trace
        # joins its caller's trace and returns its subtree
        tracer = global_tracer()
        trace_hdr = self.headers.get(TRACE_HEADER) if remote else None
        if remote:
            root_cm = tracer.remote_root(trace_hdr, "rpc.query",
                                         node=self.api.node_id(),
                                         index=index)
        else:
            root_cm = tracer.request_root("http.query", index=index,
                                          tenant=tenant)
        with root_cm as root:
            if not proto_out:
                payload = self.api.query_json_bytes(
                    index, pql, shards=shards, remote=remote, opts=opts,
                    tenant=tenant, deadline=deadline,
                    profile_out=profile_out)
                if root is not None and trace_hdr:
                    # spliced into the closing brace of the envelope
                    root.finish()
                    payload = (payload[:-1] + b',"trace":' + json.dumps(
                        root.to_json(), separators=(",", ":")).encode()
                        + b"}")
                if profile_out:
                    payload = (payload[:-1] + b',"profile":' + json.dumps(
                        profile_out[0], separators=(",", ":")).encode()
                        + b"}")
                self._note_egress(tenant, index, len(payload), remote)
                self._raw(payload)
                return
            from pilosa_tpu_torch.wire.serializer import (
                encode_error,
                encode_results,
            )

            headers = None
            try:
                results = self.api.query_raw(
                    index, pql, shards=shards, remote=remote, opts=opts,
                    tenant=tenant, deadline=deadline,
                    profile_out=profile_out)
                trace_json = None
                if root is not None and trace_hdr:
                    root.finish()
                    trace_json = root.to_json()
                payload = encode_results(results, trace=trace_json)
                status = 200
            except ApiError as e:
                payload, status = encode_error(str(e)), e.status
                if e.retry_after is not None:
                    headers = {"Retry-After":
                               str(max(1, int(e.retry_after)))}
            self._note_egress(tenant, index, len(payload), remote)
            self._raw(payload, status=status, headers=headers,
                      content_type=PROTOBUF)

    def post_index(self, index):
        opts = self._json_body().get("options", {})
        self._json(self.api.create_index(
            index, keys=opts.get("keys", False),
            track_existence=opts.get("trackExistence", True)))

    def get_index(self, index):
        self._json(self.api._index(index).schema())

    def delete_index(self, index):
        self.api.delete_index(index)
        self._json({})

    def post_field(self, index, field):
        body = self._json_body()
        self._json(self.api.create_field(index, field,
                                         body.get("options", {})))

    def delete_field(self, index, field):
        self.api.delete_field(index, field)
        self._json({})

    def _check_import_size(self, n: int, remote: bool) -> None:
        """max-writes-per-request on an import body; a peer's slice
        (``remote``) is exempt."""
        limit = self.api.max_writes_per_request
        if not remote and 0 < limit < n:
            raise ApiError(
                f"import batch of {n} rows exceeds max-writes-per-request "
                f"{limit}; split the batch (the CLI clamps --batch-size to "
                "this server's limit automatically)", 413)

    def post_import(self, index, field):
        remote = self._flag("remote")
        if PROTOBUF in self.headers.get("Content-Type", ""):
            self._need_wire()
            from pilosa_tpu_torch.wire.serializer import decode_import_request

            rows, columns, timestamps, clear = decode_import_request(
                self._body())
        else:
            body = self._json_body()
            rows, columns = body.get("rows", []), body.get("columns", [])
            timestamps = body.get("timestamps")
            clear = bool(body.get("clear", False))
        self._check_import_size(len(columns), remote)
        changed = self.api.import_bits(
            index, field, rows, columns, timestamps=timestamps, clear=clear,
            remote=remote)
        self._note_ingest(index, len(columns), remote)
        self._json({"changed": changed})

    def post_import_value(self, index, field):
        remote = self._flag("remote")
        if PROTOBUF in self.headers.get("Content-Type", ""):
            self._need_wire()
            from pilosa_tpu_torch.wire.serializer import (
                decode_import_value_request,
            )

            columns, values, clear = decode_import_value_request(
                self._body())
        else:
            body = self._json_body()
            columns, values = body.get("columns", []), body.get("values", [])
            clear = bool(body.get("clear", False))
        self._check_import_size(len(columns), remote)
        changed = self.api.import_values(index, field, columns, values,
                                         clear=clear, remote=remote)
        self._note_ingest(index, len(columns), remote)
        self._json({"changed": changed})

    def post_import_roaring(self, index, field, shard):
        remote = self._flag("remote")
        submitted: list = []
        changed = self.api.import_roaring(index, field, int(shard),
                                          self._body(), remote=remote,
                                          submitted_out=submitted)
        # billed by the bits submitted, as the other import routes
        self._note_ingest(index, submitted[0] if submitted else changed,
                          remote)
        self._json({"changed": changed})

    def get_schema(self):
        self._json(self.api.schema())

    def get_info(self):
        self._json(self.api.info())

    def get_version(self):
        self._json(self.api.version())

    def get_export(self):
        index = (self._query.get("index") or [""])[0]
        field = (self._query.get("field") or [""])[0]
        if not index or not field:
            raise ApiError("export requires index= and field=")
        self._raw(self.api.export_csv_bytes(index, field),
                  content_type="text/csv")

    def get_shards_max(self):
        self._json(self.api.max_shards())

    def _fastlane_metrics(self) -> dict:
        out = self.api.fastlane_metrics()
        with self.server.metrics_lock:
            out["http_connections_total"] = self.server.connections_opened
            out["http_requests_total"] = self.server.requests_served
        return out

    def get_metrics(self):
        """The reference's blocks for the planes the port has, in its
        order: the stats registry, the row cache, the serving waves and
        fast lane, the result cache, the tierer, the WAL, the integrity
        plane, the host roaring kernels and the merge kernels, the
        mesh's reduction lanes, QoS, observability, then the tenant
        ledger, heat and the SLO engine. The multi-process serving
        series follow the fast lane's (zeros in single-process mode)."""
        seen: set = set()  # a family's HELP and TYPE once a page
        api = self.api
        stats = global_stats()
        prefix = stats.prefix
        text = stats.prometheus_text(seen)
        text += api.holder.cache.prometheus_lines(prefix, seen=seen)
        pm = api.pipeline_metrics()
        text += prometheus_block(
            {"waves_total": pm["waves"],
             "coalesced_requests_total": pm["coalesced"],
             "deduped_requests_total": pm["deduped"]},
            prefix, "serving", seen=seen)
        text += prometheus_block(self._fastlane_metrics(), prefix,
                                 "serving", seen=seen)
        text += prometheus_block(api.mp_metrics(), prefix, seen=seen)
        text += prometheus_block(api.rescache_metrics(), prefix, seen=seen)
        text += prometheus_block(api.tiering_metrics(), prefix, seen=seen)
        text += prometheus_block(api.durability_metrics(), prefix, "wal",
                                 seen=seen)
        text += prometheus_block(api.integrity_metrics(), prefix, seen=seen)
        text += prometheus_block(global_kernel_stats().metrics(), prefix,
                                 seen=seen)
        text += prometheus_block(global_merge_stats().metrics(), prefix,
                                 seen=seen)
        # the mesh's reduction lanes: dense-equivalent against actual
        # bytes and the row gathers, zeros until a mesh reduces
        text += prometheus_block(global_reduce_stats().snapshot(), prefix,
                                 "dist_reduce", seen=seen)
        text += prometheus_block(api.qos.metrics(), prefix, "qos",
                                 seen=seen)
        text += prometheus_block(api.observability_metrics(), prefix,
                                 seen=seen)
        text += api.cost.prometheus_lines(prefix, seen=seen)
        text += global_heat().prometheus_lines(prefix, seen=seen)
        text += api.slo.prometheus_lines(prefix, seen=seen)
        self._raw(text.encode(),
                  content_type="text/plain; version=0.0.4")

    def post_recalculate_caches(self):
        self._body()
        self.api.recalculate_caches()
        self.send_response(204)  # no body, so no Content-Length
        self.end_headers()

    def post_translate_keys(self):
        body = self._json_body()
        self._json({"ids": self.api.holder.translate.translate(
            body.get("namespace", ""), body.get("keys", []),
            create=bool(body.get("create", False)))})

    def get_translate_data(self):
        offset = _int_param((self._query.get("offset") or ["0"])[0],
                            "offset")
        self._raw(self.api.holder.translate.read_log(offset),
                  content_type="application/octet-stream")

    def post_scrub(self):
        """One integrity scrub pass (``check --host``): verify every
        fragment's disk bytes, quarantine and heal rot; the pass record."""
        self._body()
        self._json(self.api.scrub_now())

    def get_status(self):
        self._json(self.api.status())

    # ---------------------------------------------------------------- debug

    def _k_param(self, default: str) -> int:
        return _int_param((self._query.get("k") or [default])[0], "k")

    def get_traces(self):
        tracer = global_tracer()
        self._json({"enabled": tracer.enabled,
                    "sampleRate": tracer.sample_rate,
                    "traces": tracer.recent()})

    def get_tenants(self):
        """The per-(tenant, index) cost table and its top-K
        (``?k=10&by=device_ms``)."""
        k = self._k_param("10")
        if k <= 0:
            raise ApiError(f"k must be positive, got {k}")
        by = (self._query.get("by") or ["device_ms"])[0]
        try:
            self._json(self.api.tenants_json(k=k, by=by))
        except ValueError as e:
            raise ApiError(str(e)) from e

    def get_heatmap(self):
        """Decayed per-(index, field, shard) heat with the device-bytes
        overlay (``?k=100``; ``k=0`` the whole table); ``?tier=true``
        adds each row's tier (resident, compressed, host or cold), its
        bytes by tier and the tierer's last decision."""
        k = self._k_param("100")
        if k < 0:
            raise ApiError(f"k must be non-negative, got {k}")
        cache = self.api.holder.cache
        snap = global_heat().snapshot(k=k, cache=cache)
        if self._flag("tier"):
            per_frag, per_stack = cache.tier_overlay()
            tierer = self.api.tierer
            decisions = (tierer.last_decisions()
                         if tierer is not None else {})

            def label(tiers):
                if tiers["dense"] + tiers["compressed"] > 0:
                    return "resident" if tiers["dense"] else "compressed"
                return "host"

            for r in snap["shards"]:
                fkey = (r.get("scope", ""), r["index"], r["field"],
                        r["shard"])
                tiers = per_frag.get(fkey)
                stiers = per_stack.get(fkey[:3])
                if tiers is not None:
                    r["tier"] = label(tiers)
                    r["tierBytes"] = tiers
                elif stiers is not None:
                    # a stacked leaf tiers a whole field: every shard of
                    # it shows the leaf's tier
                    r["tier"] = label(stiers)
                    r["stackTierBytes"] = stiers
                else:
                    r["tier"] = "cold"
                d = decisions.get(fkey, decisions.get(fkey[:3]))
                if d is not None:
                    r["tierDecision"] = d
            snap["tiering"] = (tierer.to_json() if tierer is not None
                               else {"enabled": False})
        self._json(snap)

    def get_rescache(self):
        k = self._k_param("100")
        if k <= 0:
            raise ApiError(f"k must be positive, got {k}")
        self._json(self.api.rescache_json(k=k))

    def get_slo(self):
        self._json(self.api.slo.to_json())

    def get_workers(self):
        """The multi-process serving workers: generation, pid, liveness,
        ring depth, counters and ring round-trip quantiles of each."""
        self._json(self.api.workers_json())

    def get_inflight_queries(self):
        tracker = global_query_tracker()
        self._json({"queries": tracker.snapshot(),
                    "trackedTotal": tracker.started_total})

    def get_long_queries(self):
        self._json({"threshold": self.api.long_query_time,
                    "total": self.api.slow_queries_total,
                    "queries": list(self.api.long_queries)})

    def post_trace_device(self):
        """A ``torch.profiler`` capture around live traffic into the
        trace log dir (``?secs=N``, default 1)."""
        self._body()
        raw = (self._query.get("secs") or ["1"])[0]
        try:
            secs = float(raw)
        except ValueError as e:
            raise ApiError(f"invalid secs parameter {raw!r}") from e
        self._json(self.api.start_device_trace(secs))

    def get_debug_vars(self):
        """The reference's ``/debug/vars`` blocks for the planes the port
        has."""
        api = self.api
        snap = global_stats().snapshot()
        snap["residency"] = api.holder.cache.metrics()
        snap["serving_pipeline"] = api.pipeline_metrics()
        snap["qos"] = api.qos.metrics()
        snap["serving_fastlane"] = self._fastlane_metrics()
        snap["serving_mp"] = api.mp_metrics()
        snap["result_cache"] = api.rescache_metrics()
        snap["residency_tiering"] = api.tiering_metrics()
        snap["durability"] = api.durability_metrics()
        snap["integrity"] = api.integrity_metrics()
        snap["observability"] = api.observability_metrics()
        snap["dist_reduce"] = global_reduce_stats().snapshot()
        snap["tenants"] = api.cost.metrics()
        snap["heat"] = global_heat().metrics()
        snap["slo"] = api.slo.metrics()
        self._json(snap)

    def get_pprof(self):
        """Every thread's stack, as text."""
        import sys
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            out.append(f"--- thread {names.get(ident, ident)} ---")
            out.extend(line.rstrip()
                       for line in traceback.format_stack(frame))
        self._raw("\n".join(out).encode(), content_type="text/plain")


def _int_param(value: str, name: str) -> int:
    try:
        return int(value)
    except ValueError as e:
        raise ApiError(f"invalid {name} parameter {value!r}") from e


class PilosaHTTPServer(ThreadingHTTPServer):
    # a concurrent client wave would overflow socketserver's default
    # listen backlog of 5
    request_queue_size = 128
    disable_nagle_algorithm = True

    def __init__(self, *args, **kwargs):
        # before bind: a failed bind calls server_close
        self.metrics_lock = threading.Lock()
        self.connections_opened = 0
        self.requests_served = 0
        self.open_connections = set()
        super().__init__(*args, **kwargs)

    def server_close(self):
        """Close the listener and every open keep-alive connection, so
        no handler thread outlives the server."""
        import socket

        super().server_close()
        with self.metrics_lock:
            conns = list(self.open_connections)
            self.open_connections.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


def make_http_server(api: API, bind: str = "localhost", port: int = 10101):
    handler = type("BoundHandler", (HTTPHandler,), {"api": api})
    return PilosaHTTPServer((bind, port), handler)


def serve_in_thread(api: API, bind: str = "localhost", port: int = 0):
    """Start a server on an ephemeral port; returns (server, port, thread)."""
    server = make_http_server(api, bind, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1], thread

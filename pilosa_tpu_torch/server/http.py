"""HTTP transport (reference http/handler.go), the port's thin copy.

Routes of this slice, with the reference's request and response bytes:

- ``POST /index/{i}`` and ``POST /index/{i}/field/{f}``: schema (field
  ``type`` set, int, time with its ``timeQuantum``, mutex or bool);
- ``POST /index/{i}/query``: raw PQL in, ``{"results": [...]}`` out:
  Count, row algebra, Range, time windows (``from=``/``to=``), Shift,
  Not/All, Sum/Min/Max, TopN (``attrName=``), Rows (``like=``), GroupBy
  (``aggregate=Sum``, ``having=``), IncludesColumn, Options (``shards=``,
  ``excludeColumns=``, ``columnAttrs=``), Set (``timestamp=``), Clear,
  ClearRow, Store, SetRowAttrs and SetColumnAttrs, with string keys on
  keyed indexes and fields; the URL parameters ``columnAttrs``,
  ``excludeColumns`` and ``excludeRowAttrs`` (``=true``) apply to every
  row result of the request;
- ``POST /index/{i}/field/{f}/import``: JSON ``rows``/``columns`` and
  optional ``timestamps``;
- ``POST /index/{i}/field/{f}/import-value``: JSON ``columns``/``values``
  for int fields (a protobuf body is not yet ported);
- ``POST /recalculate-caches``: every fragment's row-count cache
  recounted and saved, 204;
- ``POST /internal/translate/keys``: JSON ``namespace``, ``keys`` and
  ``create`` in, ``{"ids": [...]}`` out (a client turns keys into ids
  this way before an ``/import``, which takes ids);
- ``GET /internal/translate/data?offset=N``: the translate log's bytes
  from ``offset``;
- ``POST /internal/scrub``: one integrity scrub pass, its record out;
- ``GET /status``.

An error with a ``retry_after`` (a write shed while the storage is
degraded: 503) carries a ``Retry-After`` header.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.server.api import API, ApiError

_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("POST", re.compile(r"^/index/([^/]+)/query$"), "post_query"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)/import$"), "post_import"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)/import-value$"),
     "post_import_value"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "post_field"),
    ("POST", re.compile(r"^/index/([^/]+)$"), "post_index"),
    ("POST", re.compile(r"^/recalculate-caches$"), "post_recalculate_caches"),
    ("POST", re.compile(r"^/internal/translate/keys$"), "post_translate_keys"),
    ("GET", re.compile(r"^/internal/translate/data$"), "get_translate_data"),
    ("POST", re.compile(r"^/internal/scrub$"), "post_scrub"),
    ("GET", re.compile(r"^/status$"), "get_status"),
]


class HTTPHandler(BaseHTTPRequestHandler):
    api: API = None  # set by make_http_server
    protocol_version = "HTTP/1.1"
    # idle keep-alive connections close after this long
    timeout = 120
    # status line + headers + body leave as one write per response
    wbufsize = -1

    def log_message(self, fmt, *args):
        pass

    def _dispatch(self, method: str):
        self._body_read = False
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

    # --------------------------------------------------------------- routes

    def post_query(self, index):
        try:
            pql = self._body().decode()
        except UnicodeDecodeError as e:
            raise ApiError(f"query is not UTF-8: {e}") from e
        # request-level result options (reference handler query args)
        opts = {k: True for k in ("columnAttrs", "excludeColumns",
                                  "excludeRowAttrs")
                if self._query.get(k, ["false"])[0] == "true"}
        self._raw(self.api.query_json_bytes(index, pql, opts))

    def post_index(self, index):
        opts = self._json_body().get("options", {})
        self._json(self.api.create_index(
            index, keys=opts.get("keys", False),
            track_existence=opts.get("trackExistence", True)))

    def post_field(self, index, field):
        body = self._json_body()
        self._json(self.api.create_field(index, field,
                                         body.get("options", {})))

    def _check_import_size(self, n: int) -> None:
        limit = self.api.max_writes_per_request
        if 0 < limit < n:
            raise ApiError(
                f"import batch of {n} rows exceeds max-writes-per-request "
                f"{limit}; split the batch (the CLI clamps --batch-size to "
                "this server's limit automatically)", 413)

    def post_import(self, index, field):
        body = self._json_body()
        rows, columns = body.get("rows", []), body.get("columns", [])
        self._check_import_size(len(columns))
        changed = self.api.import_bits(
            index, field, rows, columns, timestamps=body.get("timestamps"),
            clear=bool(body.get("clear", False)))
        self._json({"changed": changed})

    def post_import_value(self, index, field):
        if "application/x-protobuf" in self.headers.get("Content-Type", ""):
            raise ApiError("protobuf import-value bodies are not yet "
                           "ported; send JSON", 415)
        body = self._json_body()
        columns, values = body.get("columns", []), body.get("values", [])
        self._check_import_size(len(columns))
        changed = self.api.import_values(
            index, field, columns, values,
            clear=bool(body.get("clear", False)))
        self._json({"changed": changed})

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


def make_http_server(api: API, bind: str = "localhost", port: int = 10101):
    handler = type("BoundHandler", (HTTPHandler,), {"api": api})
    return PilosaHTTPServer((bind, port), handler)


def serve_in_thread(api: API, bind: str = "localhost", port: int = 0):
    """Start a server on an ephemeral port; returns (server, port, thread)."""
    server = make_http_server(api, bind, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1], thread

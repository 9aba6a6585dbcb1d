"""A ``SO_REUSEPORT`` serving worker (the port's copy of
``pilosa_tpu.serving.worker``): the request's host work, off the device
owner's interpreter lock.

One worker process is one inherited ``SO_REUSEPORT`` listening socket
and one shared-memory ring pair to the owner (``serving/mpserve.py``).
It runs the HTTP parse, the QoS envelope, the PQL parse, admission, the
degraded-mode shed and the response writes, and ships only the
execution to the device owner as a pickle-free frame.

Route split:

- ``POST /index/{i}/query`` (JSON, an edge request, unprofiled) goes
  over the ring.
- Everything else (imports, whose WAL ACK rides the owner's handler
  untouched, protobuf bodies, ``?profile=true``, ``?remote=true``,
  schema, ``/internal/*``, ``/debug/*``) is proxied verbatim to the
  owner's loopback listener over a keep-alive pool.
- ``GET /debug/worker`` answers locally: this worker's own counters and
  ring round-trip quantiles.

This module must stay importable without torch, numpy or the
storage and executor modules: a worker's start bounds the respawn time
after a crash, and a worker must never open a context on the card.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.pql import ParseError, parse
from pilosa_tpu_torch.qos import (
    DEADLINE_HEADER,
    TENANT_HEADER,
    AdmissionError,
    Deadline,
)
from pilosa_tpu_torch.serving import mpserve
from pilosa_tpu_torch.serving.shmring import (
    RingFull,
    ShmRing,
    decode_frame,
    encode_frame,
)
from pilosa_tpu_torch.utils.tracing import global_tracer

_QUERY_RE = re.compile(r"^/index/([^/]+)/query$")

# Worker-side parse memo: the request's PQL parse exists only to reject
# garbage before the ring and to count write calls for the degraded and
# limit gates, a pure function of the raw bytes, so repeated query
# bodies (the common serving shape) pay one parse. Values are
# (error_text | None, write_count); bounded by a wholesale clear, like
# the plan cache's. dict ops are atomic under the GIL; a racing double
# compute stores the same value twice.
_PARSE_MEMO: dict[bytes, tuple[str | None, int]] = {}
_PARSE_MEMO_MAX = 1024

# headers forwarded on the proxy hop, both ways
_PROXY_REQ_HEADERS = (
    "Content-Type", "Accept", "Accept-Encoding",
    "X-Pilosa-Deadline-Ms", "X-Pilosa-Tenant", "X-Pilosa-Trace",
)
_PROXY_RSP_HEADERS = ("Content-Type", "Retry-After", "Content-Encoding")


class OwnerGone(Exception):
    """The device owner did not answer (died, restarting, or wedged)."""


class _Pending:
    __slots__ = ("ev", "meta", "payload", "err")

    def __init__(self):
        self.ev = threading.Event()
        self.meta = None
        self.payload = None
        self.err = None


class WorkerGateway:
    """The worker's side of the owner channel: handshake + rings +
    response dispatch + counters. One per worker process."""

    REHANDSHAKE_WINDOW_S = 15.0

    def __init__(self, sock_path: str, worker_id: int):
        self.sock_path = sock_path
        self.worker_id = worker_id
        # how long a worker keeps retrying the handshake after losing
        # the owner before giving up and exiting (env-overridable so
        # tests and chaos schedules don't wait out the full window)
        self.rehandshake_window_s = float(os.environ.get(
            "PILOSA_TPU_MP_REHANDSHAKE_S", self.REHANDSHAKE_WINDOW_S))
        self.gen = 0
        self.cfg: dict = {}
        self.conn: socket.socket | None = None
        self._conn_lock = threading.Lock()
        self.sub: ShmRing | None = None   # this worker produces
        self.rsp: ShmRing | None = None   # this worker consumes
        self.ctl: mpserve.ControlBlock | None = None
        self._pending: dict[int, _Pending] = {}
        self._plock = threading.Lock()
        self._next_id = 0
        self.admission = None
        # worker-local counters (mirrored into the control block)
        self._clock = threading.Lock()
        self.requests = 0
        self.ring_requests = 0
        self.proxied = 0
        self.shed = 0
        self.ring_full = 0
        self._rtt_us: deque = deque(maxlen=512)
        self._rtt_p50 = 0
        self._rtt_p99 = 0
        self.owner_port = 0
        self.proxy_pool = None
        self.alive = True
        # False while the owner channel is down (mid re-handshake):
        # submits fail fast with OwnerGone instead of pushing into a
        # dead ring and waiting out the full request timeout
        self.connected = False
        self._stats_written = 0.0

    # ------------------------------------------------------------ handshake

    def connect(self) -> None:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(15.0)
        conn.connect(self.sock_path)
        conn.sendall(json.dumps(
            {"hello": {"worker": self.worker_id, "pid": os.getpid(),
                       "gen": self.gen}},
            separators=(",", ":")).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = conn.recv(65536)
            if not chunk:
                raise ConnectionError("owner closed during handshake")
            buf += chunk
        line, _, buf = buf.partition(b"\n")
        cfg = json.loads(line)["cfg"]
        old_sub, old_rsp, old_ctl = self.sub, self.rsp, self.ctl
        self.sub = ShmRing.attach(cfg["sub"])
        self.rsp = ShmRing.attach(cfg["rsp"])
        if old_ctl is None or old_ctl.name != cfg["ctl"]:
            # first connect, or a NEW owner process (fresh token →
            # fresh control segment): the old block belongs to a dead
            # owner — keeping it would read stale degraded flags and
            # write stats nobody scrapes
            self.ctl = mpserve.ControlBlock.attach(cfg["ctl"])
            if old_ctl is not None:
                old_ctl.close()
        for ring in (old_sub, old_rsp):
            if ring is not None:
                ring.close()
        self.cfg = cfg
        self.gen = cfg["gen"]
        self.owner_port = cfg["ownerPort"]
        if self.proxy_pool is None:
            from pilosa_tpu_torch.parallel.connpool import ConnectionPool

            self.proxy_pool = ConnectionPool(max_per_host=32, timeout=300.0)
        if self.admission is None:
            from pilosa_tpu_torch.qos import AdmissionController

            # per-worker share of the node's admission quota (the gate
            # runs HERE, before the ring — shed requests never cross)
            self.admission = AdmissionController(
                max_inflight=int(cfg.get("qosMaxInflight") or 0),
                tenant_max=int(cfg.get("qosTenantInflight") or 0),
            )
        else:
            # re-handshake: adopt the (possibly restarted-with-new-
            # config) owner's refreshed quotas in place — recreating
            # the controller would forget in-flight slots
            self.admission.max_inflight = int(
                cfg.get("qosMaxInflight") or 0)
            self.admission.tenant_max = int(
                cfg.get("qosTenantInflight") or 0)
        global_tracer().sample_rate = float(
            cfg.get("traceSampleRate") or 0.0
        )
        conn.sendall(b'{"ready":true}\n')
        conn.settimeout(None)
        with self._conn_lock:
            self.conn = conn
        self._buf = buf
        self.connected = True
        self.write_stats()

    def start_dispatcher(self) -> None:
        t = threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="mpserve-dispatch")
        t.start()

    def _dispatch_loop(self) -> None:
        while self.alive:
            conn = self.conn
            try:
                # drain, then declare the wait and re-check before
                # blocking (the coalesced-doorbell protocol — see
                # shmring.set_waiting): the owner rings the socket only
                # when this thread is actually asleep
                ring = self.rsp
                if ring is not None:
                    self._drain_responses()
                    ring.set_waiting()
                    if ring.depth() > 0:
                        continue
                if b"\n" in self._buf:
                    self._buf = self._buf.rpartition(b"\n")[2]
                    continue  # doorbell lines consumed; re-drain
                chunk = conn.recv(65536)
                if not chunk:
                    raise ConnectionError("owner channel closed")
                self._buf += chunk
            except (OSError, AttributeError, ConnectionError, TypeError):
                if not self.alive:
                    return
                self.connected = False
                self._rehandshake()

    def _drain_responses(self) -> None:
        ring = self.rsp
        if ring is None:
            return
        for rec in ring.drain():
            try:
                meta, payload = decode_frame(rec)
            except ValueError:
                continue
            with self._plock:
                entry = self._pending.pop(meta.get("id"), None)
            if entry is not None:
                entry.meta = meta
                entry.payload = payload
                entry.ev.set()

    def _rehandshake(self) -> None:
        """The owner channel died: fail in-flight waits, then try to
        reconnect (an owner RESTART recreates the handshake socket at
        the same path). If the owner stays gone, exit — a worker without
        a device owner serves nothing useful."""
        with self._plock:
            pending, self._pending = self._pending, {}
        for entry in pending.values():
            entry.err = "device owner restarted"
            entry.ev.set()
        deadline = time.monotonic() + self.rehandshake_window_s
        while self.alive and time.monotonic() < deadline:
            try:
                self.connect()
                return
            except (OSError, ValueError, KeyError, ConnectionError):
                time.sleep(0.5)
        os._exit(0)

    # --------------------------------------------------------------- submit

    def submit(self, header: dict, body: bytes,
               timeout: float) -> tuple[dict, bytes]:
        """Push one query frame and wait for its response frame.
        Raises ``RingFull`` (→ 429 shed) or ``OwnerGone`` (→ 503)."""
        if not self.connected:
            raise OwnerGone("device owner channel is down (re-handshake "
                            "in progress)")
        with self._plock:
            self._next_id += 1
            rid = self._next_id
            entry = _Pending()
            self._pending[rid] = entry
        header["id"] = rid
        frame = encode_frame(header, body)
        t0 = time.perf_counter()
        ring = self.sub
        try:
            pushed = ring is not None and ring.push(frame)
        except RingFull:
            pushed = False  # record exceeds TOTAL ring capacity: same
            # shed as a momentarily-full ring, and no _pending leak
        if not pushed:
            with self._plock:
                self._pending.pop(rid, None)
            with self._clock:
                self.ring_full += 1
            raise RingFull("serving ring full")
        if ring.take_waiting():
            self._doorbell()
        if not entry.ev.wait(timeout):
            with self._plock:
                self._pending.pop(rid, None)
            raise OwnerGone(
                f"device owner did not answer within {timeout:.0f}s"
            )
        if entry.err is not None:
            raise OwnerGone(entry.err)
        total = time.perf_counter() - t0
        self._note_rtt(total - float(entry.meta.get("ex") or 0.0))
        return entry.meta, entry.payload

    def _doorbell(self) -> None:
        try:
            with self._conn_lock:
                if self.conn is not None:
                    self.conn.sendall(mpserve._DOORBELL)
        except OSError:
            pass  # dispatcher notices EOF and re-handshakes

    def send_trace(self, tree: dict) -> None:
        """Ship a finished worker-side span tree to the owner so its
        /debug/traces renders one tree per request."""
        try:
            data = json.dumps({"trace": tree},
                              separators=(",", ":")).encode() + b"\n"
            with self._conn_lock:
                if self.conn is not None:
                    self.conn.sendall(data)
        except (OSError, ValueError, TypeError):
            pass

    # ------------------------------------------------------------- counters

    def _note_rtt(self, overhead_s: float) -> None:
        us = max(0, int(overhead_s * 1e6))
        with self._clock:
            self._rtt_us.append(us)
            if len(self._rtt_us) % 32 == 0 or self._rtt_p50 == 0:
                srt = sorted(self._rtt_us)
                self._rtt_p50 = srt[len(srt) // 2]
                self._rtt_p99 = srt[min(len(srt) - 1,
                                        int(len(srt) * 0.99))]

    def count(self, **kw) -> None:
        with self._clock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)
        # mirror into the control block at a bounded rate — the slot is
        # an observability surface, not an accounting ledger
        now = time.monotonic()
        if now - self._stats_written > 0.05:
            self._stats_written = now
            self.write_stats()

    def write_stats(self) -> None:
        ctl = self.ctl
        if ctl is None:
            return
        with self._clock:
            try:
                ctl.write_worker(
                    self.worker_id, self.gen, os.getpid(), self.requests,
                    self.ring_requests, self.proxied, self.shed,
                    self.ring_full, self._rtt_p50, self._rtt_p99,
                )
            except (TypeError, ValueError):
                pass  # ctl torn down during shutdown

    def local_stats(self) -> dict:
        with self._clock:
            rtts = sorted(self._rtt_us)
            return {
                "worker": self.worker_id,
                "gen": self.gen,
                "pid": os.getpid(),
                "requests": self.requests,
                "ringRequests": self.ring_requests,
                "proxied": self.proxied,
                "shed": self.shed,
                "ringFull": self.ring_full,
                "ringRttP50Us": (rtts[len(rtts) // 2] if rtts else 0),
                "ringRttP99Us": (rtts[min(len(rtts) - 1,
                                          int(len(rtts) * 0.99))]
                                 if rtts else 0),
                "ringRttSamples": len(rtts),
            }

    def degraded_flags(self) -> int:
        ctl = self.ctl
        return ctl.flags() if ctl is not None else 0

    def close(self) -> None:
        self.alive = False
        with self._conn_lock:
            if self.conn is not None:
                try:
                    self.conn.close()
                except OSError:
                    pass
        for ring in (self.sub, self.rsp):
            if ring is not None:
                ring.close()
        if self.ctl is not None:
            self.ctl.close()


class WorkerHandler(BaseHTTPRequestHandler):
    """Slim HTTP handler: the query route over the ring, everything else
    proxied to the owner. Its keep-alive discipline (body drains,
    chunked rejection, buffered single-write responses) is
    ``server/http.py``'s: a client cannot tell which deployment shape
    served it."""

    gw: WorkerGateway = None  # bound per process in worker_main
    protocol_version = "HTTP/1.1"
    timeout = 120
    wbufsize = -1

    def log_message(self, fmt, *args):
        pass

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

    def _json(self, obj, status: int = 200,
              headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        self._raw(data, status=status, headers=headers)

    def _raw(self, data: bytes, content_type: str = "application/json",
             status: int = 200, headers: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, method: str) -> None:
        self._body_read = False
        self.gw.count(requests=1)
        if "chunked" in (self.headers.get("Transfer-Encoding")
                         or "").lower():
            self._body_read = True
            self._json({"error": "chunked request bodies are not "
                                 "supported; send Content-Length"},
                       status=411, headers={"Connection": "close"})
            return
        parsed = urlparse(self.path)
        try:
            if method == "POST" and _QUERY_RE.match(parsed.path):
                index = _QUERY_RE.match(parsed.path).group(1)
                self._handle_query(index, parse_qs(parsed.query))
            elif method == "GET" and parsed.path == "/debug/worker":
                self._json(self.gw.local_stats())
            else:
                self._proxy(method, parsed)
        except Exception as e:  # noqa: BLE001 — 500, never a dead conn
            self._drain_body()
            self._json({"error": f"internal: {e}"}, status=500)
        else:
            self._drain_body()

    # ---------------------------------------------------------------- proxy

    def _proxy(self, method: str, parsed, body: bytes | None = None) -> None:
        """Forward one request verbatim to the owner's loopback
        listener and relay the response — the catch-all that keeps
        every non-hot route byte-identical to single-process mode."""
        if body is None:
            body = self._body() if method in ("POST", "DELETE") else b""
            if not body and method == "GET":
                self._body()  # drain a stray GET body for keep-alive
        headers = {}
        for name in _PROXY_REQ_HEADERS:
            val = self.headers.get(name)
            if val is not None:
                headers[name] = val
        path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
        url = f"http://127.0.0.1:{self.gw.owner_port}{path}"
        self.gw.count(proxied=1)
        try:
            resp = self.gw.proxy_pool.request(
                method, url, body=body or None, headers=headers,
            )
        except OSError as e:
            self._json({"error": f"device owner unreachable: {e}"},
                       status=502)
            return
        if resp.status == 204:
            self.send_response(204)
            self.end_headers()
            return
        self.send_response(resp.status)
        ct = resp.headers.get("Content-Type") or "application/json"
        self.send_header("Content-Type", ct)
        self.send_header("Content-Length", str(len(resp.data)))
        for name in _PROXY_RSP_HEADERS[1:]:
            val = resp.headers.get(name)
            if val is not None:
                self.send_header(name, val)
        self.end_headers()
        self.wfile.write(resp.data)

    # ---------------------------------------------------------------- query

    def _qos_envelope(self):
        """Tenant + deadline from headers — the same validation (and
        the same 400 text) as server/http.py's edge envelope."""
        tenant = (self.headers.get(TENANT_HEADER) or "default").strip()
        raw = self.headers.get(DEADLINE_HEADER)
        if raw is not None:
            try:
                millis = int(raw)
                if millis <= 0:
                    raise ValueError
            except ValueError:
                raise _EnvelopeError(
                    f"invalid {DEADLINE_HEADER} header {raw!r}: must be a "
                    "positive integer of milliseconds"
                ) from None
            return tenant, Deadline.from_millis(millis)
        default_s = float(self.gw.cfg.get("defaultDeadlineS") or 0.0)
        if default_s > 0:
            return tenant, Deadline.after(default_s)
        return tenant, None

    def _handle_query(self, index: str, query: dict) -> None:
        raw = self._body()
        content_type = self.headers.get("Content-Type", "")
        accept = self.headers.get("Accept", "")
        remote = bool(query and query.get("remote", ["false"])[0] == "true")
        profile = bool(query and
                       query.get("profile", ["false"])[0] == "true")
        if ("application/x-protobuf" in content_type
                or "application/x-protobuf" in accept
                or remote or profile):
            # protobuf negotiation, remote hops, and PROFILE are
            # rare/internal traffic: the owner's full handler answers
            # them byte-identically via the proxy
            self._proxy("POST", urlparse(self.path), body=raw)
            return
        try:
            tenant, deadline = self._qos_envelope()
        except _EnvelopeError as e:
            self._json({"error": str(e)}, status=400)
            return
        # worker-side parse: reject garbage before it crosses the ring,
        # and learn whether the request writes (for the degraded shed) —
        # memoized on the raw bytes (same bytes, same verdict)
        cached = _PARSE_MEMO.get(raw)
        if cached is None:
            try:
                cached = (None,
                          len(parse(raw.decode(errors="replace"))
                              .write_calls()))
            except ParseError as e:
                cached = (str(e), 0)
            if len(_PARSE_MEMO) >= _PARSE_MEMO_MAX:
                _PARSE_MEMO.clear()
            _PARSE_MEMO[raw] = cached
        perr, writes = cached
        if perr is not None:
            self._json({"error": perr}, status=400)
            return
        max_writes = int(self.gw.cfg.get("maxWritesPerRequest") or 0)
        if 0 < max_writes < writes:
            self._json({"error": (
                f"too many writes in request: {writes} > "
                f"max-writes-per-request {max_writes}")}, status=400)
            return
        if writes and not self._check_degraded():
            return
        # admission: this worker's share of the node quota, shed 429
        # WITHOUT a ring round trip
        slot = None
        try:
            slot = self.gw.admission.admit(tenant)
        except AdmissionError as e:
            self.gw.count(shed=1)
            self._json({"error": str(e)}, status=429,
                       headers={"Retry-After":
                                str(max(1, int(e.retry_after)))})
            return
        try:
            shards = None
            if query and "shards" in query:
                try:
                    shards = [int(s)
                              for s in query["shards"][0].split(",")]
                except ValueError:
                    self._json({"error": "invalid shards parameter "
                                f"{query['shards'][0]!r}"}, status=400)
                    return
            opts = {
                k: True for k in ("columnAttrs", "excludeColumns",
                                  "excludeRowAttrs")
                if query and query.get(k, ["false"])[0] == "true"
            }
            header: dict = {"op": "q", "ix": index, "t": tenant}
            if not writes:
                # read-only marker: ONLY frames the worker-side parse
                # proved write-free are eligible for the owner's
                # dedupe memo (a deduped write would mis-report its
                # per-call changed/unchanged result)
                header["ro"] = 1
            if deadline is not None:
                header["dl"] = deadline.to_millis()
            if shards is not None:
                header["sh"] = shards
            if opts:
                header["o"] = opts
            timeout = (deadline.remaining() + 5.0
                       if deadline is not None else 120.0)
            tracer = global_tracer()
            root_cm = tracer.request_root("http.query", index=index,
                                          tenant=tenant, worker=True)
            root = None
            try:
                with root_cm as root:
                    if root is not None:
                        header["tr"] = root.header_value()
                    meta, payload = self.gw.submit(header, raw, timeout)
                    if root is not None and meta.get("tr"):
                        # graft the owner-side subtree like a remote leg
                        root.add_remote(meta["tr"])
            except RingFull:
                self.gw.count(shed=1)
                self._json({"error": "serving ring full: the device "
                            "owner is saturated; retry after backoff"},
                           status=429, headers={"Retry-After": "1"})
                return
            except OwnerGone as e:
                self._json({"error": str(e)}, status=503,
                           headers={"Retry-After": "5"})
                return
            if root is not None:
                self.gw.send_trace(root.root().to_json())
            self.gw.count(ring_requests=1)
            headers = None
            if meta.get("ra") is not None:
                headers = {"Retry-After": str(max(1, int(meta["ra"])))}
            self._raw(payload, status=int(meta.get("st", 200)),
                      headers=headers)
        finally:
            if slot is not None:
                slot.release()

    def _check_degraded(self) -> bool:
        """Degraded-mode shedding, answered worker-side from the shared
        control block (no ring round-trip); the owner re-checks
        authoritatively for anything that still reaches it."""
        flags = self.gw.degraded_flags()
        if flags & mpserve.ControlBlock.FLAG_STORAGE_DEGRADED:
            self.gw.count(shed=1)
            self._json(
                {"error": mpserve.storage_degraded_msg(
                    self.gw.ctl.reason())},
                status=503, headers={"Retry-After": "5"})
            return False
        if flags & mpserve.ControlBlock.FLAG_CLUSTER_DEGRADED:
            self.gw.count(shed=1)
            self._json({"error": mpserve.CLUSTER_DEGRADED_MSG},
                       status=503, headers={"Retry-After": "5"})
            return False
        return True


class _EnvelopeError(Exception):
    pass


class WorkerHTTPServer(ThreadingHTTPServer):
    """Threading HTTP server over an ALREADY-BOUND listening socket
    (inherited from the owner with SO_REUSEPORT set)."""

    request_queue_size = 128
    disable_nagle_algorithm = True
    daemon_threads = True

    def __init__(self, sock: socket.socket, handler):
        super().__init__(sock.getsockname()[:2], handler,
                         bind_and_activate=False)
        self.socket.close()  # the unbound placeholder __init__ made
        self.socket = sock
        self.server_address = sock.getsockname()[:2]


def worker_main(sock_path: str, listen_fd: int, worker_id: int) -> int:
    """Entry point of ``python -m pilosa_tpu_torch serve-worker``,
    spawned by ``OwnerRuntime``, never run by hand."""
    gw = WorkerGateway(sock_path, worker_id)
    gw.connect()
    gw.start_dispatcher()
    lsock = socket.socket(fileno=listen_fd)
    handler = type("BoundWorkerHandler", (WorkerHandler,), {"gw": gw})
    server = WorkerHTTPServer(lsock, handler)
    try:
        server.serve_forever(poll_interval=0.5)
    except KeyboardInterrupt:
        pass
    finally:
        gw.close()
        server.server_close()
    return 0

"""Keep-alive HTTP connection pool (the port's copy of
``pilosa_tpu.parallel.connpool``): a serving worker's proxy to its
device owner's loopback listener rides it.

Bounded per-host sets of persistent ``http.client`` connections:

- **Exclusive checkout**: a connection serves one request at a time, so
  concurrent callers never share a socket.
- **Health-checked reuse**: a checked-out idle connection whose socket
  is already readable is half-closed (the server sent FIN) or poisoned
  (stray bytes): it is discarded, not reused. A reuse that still hits
  the keep-alive race (the server closed between the check and the
  request landing) is retried once on a fresh connection; a fresh
  connection's failure propagates.
- **Bounded**: at most ``max_per_host`` idle connections are kept per
  (scheme, host, port); extras close on check-in. A failed connection
  is always discarded.
- **TLS-capable**: an ``ssl.SSLContext`` applies to https hosts.

Transport faults raise the stdlib exceptions (``OSError``,
``TimeoutError``, ``http.client`` errors); an HTTP status is returned,
never raised. Requests pass the network fault plane
(``testing/faults.py``) when one is installed.
"""

from __future__ import annotations

import http.client
import select
import socket
import threading
from collections import deque
from urllib.parse import urlsplit

from pilosa_tpu_torch.testing import faults
from pilosa_tpu_torch.utils.tracing import global_tracer

# Retryable symptoms of the keep-alive race: the server closed a pooled
# connection between our health check and the request hitting its socket.
# Only ever retried when the connection was REUSED and nothing of the
# response was read — a fresh connection failing the same way is a real
# transport fault and propagates.
_STALE_ERRORS = (
    http.client.RemoteDisconnected,
    http.client.BadStatusLine,
    BrokenPipeError,
    ConnectionResetError,
    ConnectionAbortedError,
)


class PoolResponse:
    """Fully-read response: status + headers + body (the pool must drain
    the body before the connection can be reused, so streaming is not
    offered)."""

    __slots__ = ("status", "headers", "data")

    def __init__(self, status: int, headers, data: bytes):
        self.status = status
        self.headers = headers
        self.data = data


class ConnectionPool:
    """Bounded keep-alive pool over ``http.client`` connections."""

    def __init__(self, max_per_host: int = 8, timeout: float = 30.0,
                 ssl_context=None):
        self.max_per_host = max(1, int(max_per_host))
        self.timeout = timeout
        self.ssl_context = ssl_context
        # fault-injection source label (testing/faults.py): the node
        # name this pool sends AS, so partition rules can match one
        # direction of traffic. Set by the owning server; "" for bare
        # pools (CLI importer, tests), which rules match via src="*".
        self.fault_source = ""
        self._idle: dict[tuple, deque] = {}
        self._lock = threading.Lock()
        # lifecycle counters (read by /metrics via the owning server)
        self.created = 0
        self.reused = 0
        self.discarded = 0
        self.requests = 0

    # ------------------------------------------------------------ lifecycle

    def _checkout(self, key):
        """Pop a healthy idle connection for ``key``, or None."""
        while True:
            with self._lock:
                dq = self._idle.get(key)
                conn = dq.popleft() if dq else None
            if conn is None:
                return None
            sock = getattr(conn, "sock", None)
            if sock is None:
                self._note_discard(conn)
                continue
            try:
                # A readable idle socket means EOF (half-close) or stray
                # bytes — either way the connection cannot carry a fresh
                # request/response exchange.
                readable, _, _ = select.select([sock], [], [], 0)
            except (OSError, ValueError):
                readable = [sock]
            if readable:
                self._note_discard(conn)
                continue
            with self._lock:
                self.reused += 1
            return conn

    def _connect(self, key) -> http.client.HTTPConnection:
        scheme, host, port = key
        if scheme == "https":
            conn = http.client.HTTPSConnection(
                host, port, timeout=self.timeout, context=self.ssl_context
            )
        else:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.timeout)
        with self._lock:
            self.created += 1
        return conn

    def _checkin(self, key, conn) -> None:
        with self._lock:
            dq = self._idle.setdefault(key, deque())
            if len(dq) < self.max_per_host:
                dq.append(conn)
                return
        self._note_discard(conn)

    def _note_discard(self, conn) -> None:
        with self._lock:
            self.discarded += 1
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Drop every idle connection (server shutdown, tests)."""
        with self._lock:
            idle, self._idle = self._idle, {}
        for dq in idle.values():
            for conn in dq:
                try:
                    conn.close()
                except OSError:
                    pass

    def metrics(self) -> dict:
        with self._lock:
            idle = sum(len(dq) for dq in self._idle.values())
            return {
                "pool_connections_created_total": self.created,
                "pool_connections_reused_total": self.reused,
                "pool_connections_discarded_total": self.discarded,
                "pool_requests_total": self.requests,
                "pool_idle_connections": idle,
            }

    # -------------------------------------------------------------- request

    def request(self, method: str, url: str, body: bytes | None = None,
                headers: dict | None = None,
                timeout: float | None = None,
                _redelivery: bool = False) -> PoolResponse:
        """One request/response exchange on a pooled connection. Returns
        the status whatever it is (no exception on 4xx/5xx); raises the
        underlying socket/http.client error on transport faults."""
        parts = urlsplit(url)
        scheme = parts.scheme or "http"
        key = (scheme, parts.hostname,
               parts.port or (443 if scheme == "https" else 80))
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        # Fault injection (testing/faults.py): one global load + None
        # test when no plane is installed — the shipping path pays
        # nothing. ``_redelivery`` marks a duplicate-rule redelivery so
        # the second copy isn't itself re-intercepted (infinite
        # duplication otherwise).
        duplicate = False
        plane = faults._PLANE
        if plane is not None and not _redelivery:
            directive = plane.intercept(
                self.fault_source, f"{key[1]}:{key[2]}", parts.path or "/"
            )
            if directive is not None:
                if directive.delay_s > 0:
                    plane.sleep(directive.delay_s)
                if directive.drop:
                    # a partitioned link looks like a transport fault to
                    # the sender: same exception family a dead peer's
                    # kernel would produce, mapped to ClientError by the
                    # internal client
                    raise OSError(
                        f"fault injected: drop {self.fault_source or '?'}"
                        f" -> {key[1]}:{key[2]} {parts.path}"
                    )
                if directive.error is not None:
                    status, body_bytes = directive.error
                    return PoolResponse(
                        status, {"Content-Type": "application/json"},
                        body_bytes,
                    )
                duplicate = directive.duplicate
        with self._lock:
            self.requests += 1
        effective = self.timeout if timeout is None else timeout
        last_exc: Exception | None = None
        for fresh in (False, True):
            # conn.checkout span: pool acquisition cost per request —
            # whether this hop rode a pooled keep-alive socket or paid a
            # fresh TCP connect is exactly the fast-lane property the
            # pool exists for (no-op when the request is unsampled)
            with global_tracer().span("conn.checkout",
                                      host=f"{key[1]}:{key[2]}") as cspan:
                conn = None if fresh else self._checkout(key)
                reused = conn is not None
                if conn is None:
                    conn = self._connect(key)
                if cspan is not None:
                    cspan.tags["reused"] = reused
            # per-request timeout: conn.timeout only applies at connect,
            # so a reused connection's live socket is re-armed explicitly
            # (and RESET when no per-request cap rides this call — the
            # previous request may have left a tighter deadline cap)
            conn.timeout = effective
            if conn.sock is None:
                try:
                    with global_tracer().span("conn.connect",
                                              host=f"{key[1]}:{key[2]}"):
                        conn.connect()
                    # request/response hops are latency-bound small
                    # writes: never let Nagle hold the tail packet
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                except OSError:
                    self._note_discard(conn)
                    raise
            if conn.sock is not None:
                try:
                    conn.sock.settimeout(effective)
                except OSError as e:
                    self._note_discard(conn)
                    if not reused:
                        raise
                    last_exc = e
                    continue
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
            except _STALE_ERRORS as e:
                self._note_discard(conn)
                if not reused:
                    raise
                last_exc = e
                continue  # keep-alive race: one retry on a fresh socket
            except BaseException:
                # timeout mid-exchange, SSL fault, DNS, refused connect —
                # the request may have been processed, so never retried
                self._note_discard(conn)
                raise
            try:
                data = resp.read()
            except BaseException:
                # the status line ARRIVED: the server executed this
                # request, so a fault while reading the body must never
                # replay it (the retry invariant above is "nothing of
                # the response was read") — discard and propagate
                self._note_discard(conn)
                raise
            if resp.will_close:
                self._note_discard(conn)
            else:
                self._checkin(key, conn)
            if duplicate:
                # at-least-once delivery: the peer just processed a
                # copy; deliver another and return the LAST response —
                # what a duplicating network shows the sender
                return self.request(method, url, body=body,
                                    headers=headers, timeout=timeout,
                                    _redelivery=True)
            return PoolResponse(resp.status, resp.headers, data)
        raise last_exc  # pragma: no cover — loop always returns or raises

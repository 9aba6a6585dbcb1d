"""Command line of the port, with the reference's verbs, arguments,
output and exit codes:

- ``server``: run a node (``-c FILE``: the reference's TOML config,
  overridden by ``PILOSA_TPU_*`` environment variables, then by flags).
  It runs on the GPU (``--device cuda``, the default) unless
  ``--device cpu`` is given; asking for cuda on a machine without one
  exits with an error. Its knobs: ``--durability-mode``,
  ``--group-commit-max-ms``, ``--group-commit-max-ops`` (durability),
  ``--residency-host-tier-bytes``, ``--residency-promote-interval``,
  ``--residency-promote-heat``, ``--residency-demote-heat`` (tiering; an
  interval of 0, the default, runs no tierer), ``--scrub-interval`` and
  ``--scrub-max-bytes-per-sec`` (the integrity scrubber; 0: none).
  ``serving-workers``, ``ring-slots`` and ``ring-slot-bytes`` (config
  file or ``PILOSA_TPU_*``) run multi-process serving. A config knob of
  a plane the port does not have (cluster, CDC, autopilot, TLS, ...)
  set to anything but its default makes ``server`` exit with an error
  naming it.
- ``serve-worker``: one ``SO_REUSEPORT`` serving worker, spawned by a
  device owner with its listening socket and handshake channel, never
  run by hand. It parses its arguments before anything that imports
  torch, and imports none.
- ``import``: bulk-import ``row,col[,ts]`` (or ``col,value`` with
  ``--values``) CSVs, in-process with ``-d`` or over HTTP with
  ``--host`` (batches clamped to the server's ``maxWritesPerRequest``
  from ``/status``; a 413 splits a batch in half; ``--concurrency``
  POSTs in flight); ``export``: a field as ``row,column`` CSV (``-d`` or
  ``--host``); ``inspect``: per-fragment container counts of a data dir.
  The in-process verbs take ``--device`` like ``server``.
- ``config`` prints the resolved configuration as JSON,
  ``generate-config`` the default TOML, ``version`` the version.
- ``check``: the integrity check. ``-d`` verifies every fragment file of
  a stopped node's data dir against its ``.checksums`` and replays its
  op log, printing ``ok:`` lines to stdout and ``CORRUPT:`` and
  ``QUARANTINED:`` lines to stderr (exit 1 on any); ``--host`` runs one
  scrub pass on a live node (``POST /internal/scrub``) and prints its
  record (exit 1 if a fragment stayed unrepaired). Neither touches a
  device.
"""

from __future__ import annotations

import argparse
import collections
import glob
import http.client
import json
import os
import signal
import sys
import threading
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch import __version__

DEFAULT_HOST = "http://localhost:10101"
DEFAULT_IMPORT_BATCH = 100_000

_DEFAULT_TOML = """\
# pilosa-tpu server configuration. Precedence: flags > PILOSA_TPU_* env
# vars > this file > defaults (env var names: key uppercased, dashes ->
# underscores, e.g. PILOSA_TPU_ANTI_ENTROPY_INTERVAL).
data-dir = "~/.pilosa_tpu"
bind = "localhost"
port = 10101
# name = "node-<port>"        # stable node id in the cluster
# advertise = ""              # URI peers should use (default: bind:port)
# seeds = ["http://host:10101"]  # join an existing cluster via any member
replica-n = 1                 # replicas per shard
anti-entropy-interval = 600.0 # seconds; 0 disables the repair ticker
heartbeat-interval = 5.0      # seconds; 0 disables death detection
heartbeat-timeout = 2.0       # tight per-probe timeout for liveness
                              # checks (heartbeat, quorum, death
                              # corroboration) — a hung peer must not
                              # stall detection of other failures
# use-mesh = true             # force the device-mesh executor (default:
                              # auto - mesh when >1 JAX device)
# mesh-groups = 0             # reduction groups for multi-chip meshes;
                              # 0 = auto (flat 1-D mesh)
# topn-quantized-ranking = false # EQuARX 8-bit TopN/GroupBy candidate
                              # ranking on the inter-group wire; final
                              # results stay byte-identical (exact
                              # recount on the error-bound-widened
                              # window)
# device-budget-bytes = 0     # HBM residency budget; 0 = auto
long-query-time = 0.0         # log queries slower than this; 0 = off
max-writes-per-request = 5000 # reject larger write batches; 0 = unlimited
ingest-workers = 1            # local shard-group apply pool per import
                              # batch; raise where fragment writes pay real
                              # disk latency (docs/INGEST.md)

# Serving fast lane (docs/OPERATIONS.md): keep-alive pooling + batching
client-pool-size = 8          # keep-alive connections retained per peer
remote-batch = true           # coalesce same-node remote sub-queries onto
                              # /internal/query-batch (false = per-query)

# Multi-process serving tier (docs/OPERATIONS.md deployment shapes):
# shatters the single-interpreter serving ceiling with N SO_REUSEPORT
# worker processes fronting this (device-owner) process over
# shared-memory rings; requires SO_REUSEPORT (Linux), falls back to
# single-process otherwise
serving-workers = 0           # worker processes; 0 = single-process
ring-slots = 1024             # slots per ring direction per worker
ring-slot-bytes = 65536       # bytes per slot (large responses span
                              # consecutive slots)

# Skewed traffic (docs/OPERATIONS.md): write-invalidated result cache +
# heat-driven HBM residency tiering — the actuators on the heat plane
result-cache-bytes = 0        # pre-serialized hot-query response bytes
                              # kept across waves, invalidated at every
                              # (index,field,shard) write; 0 = off
residency-promote-interval = 0.0  # seconds between tiering passes
                              # (demote cold fragments to the compressed
                              # host tier, promote hot ones back); 0 = off
residency-promote-heat = 4.0  # heat above which host-tier fragments
                              # promote to device residency
residency-demote-heat = 1.0   # heat below which device-resident
                              # fragments demote host-side; the gap to
                              # promote-heat is the hysteresis dead band
residency-host-tier-bytes = 1073741824  # compressed host-tier budget

# Autopilot placement plane (docs/OPERATIONS.md autopilot): the
# coordinator periodically rebalances the hottest (index,shard) groups
# off overloaded nodes via epoch-fenced placement overrides + resize.
# The kill switch gates only the planner — overrides minted elsewhere
# are still honored by every node, keeping placement consistent.
autopilot-enabled = false     # master kill switch for the planner ticker
autopilot-interval = 30.0     # seconds between planner passes
autopilot-heat-budget = 1.5   # per-node heat ceiling as a multiple of
                              # mean node heat; the margin over 1.0 is
                              # the hysteresis dead band
autopilot-max-moves = 4       # shard-group moves per pass (further
                              # shaped by repair-max-bytes-per-sec)
autopilot-min-dwell = 0.0     # seconds a moved shard is frozen before
                              # it may move again; 0 = two intervals
autopilot-split-threshold = 0.0  # shard heat above this multiple of
                              # mean node load splits the shard into
                              # sub-shard column ranges; 0 = off
autopilot-split-ways = 2      # ranges a hot shard is split into

# Write-path durability (docs/OPERATIONS.md): what an HTTP 200 on a
# write means
durability-mode = "group"     # group = one fsync per commit group of
                              # concurrent writers (acked = durable);
                              # per-op = fsync every write; flush-only =
                              # legacy r5 behavior (OS buffer only)
group-commit-max-ms = 2.0     # max time a record waits for its group's
                              # fsync to start (bounds write ACK latency)
group-commit-max-ops = 256    # max op records fsynced per group

# Storage integrity (docs/OPERATIONS.md integrity runbook)
verify-on-load = true         # check fragment snapshots against their
                              # .checksums sidecars at open; corrupt
                              # files quarantine (never served) and
                              # read-repair from replicas
scrub-interval = 0.0          # seconds between background scrub passes
                              # over owned fragments' DISK bytes; 0 = off
scrub-max-bytes-per-sec = 0   # token-bucket budget for scrub reads;
                              # 0 = unpaced

# Anti-entropy / resize data plane (docs/OPERATIONS.md)
sync-workers = 8              # fragment diff/fetch/apply pipeline width
                              # per repair pass
repair-max-bytes-per-sec = 0  # token-bucket pacing of repair/resize
                              # transfers; 0 = unpaced
repair-max-inflight = 0       # concurrent repair transfers; 0 = unbounded
repair-compression = true     # zlib Content-Encoding on fragment and
                              # delta payloads (negotiated per peer)

# Replication & CDC (docs/OPERATIONS.md): WAL tail change feed ->
# cluster-safe result caching, stale-bounded read replicas, and
# `restore --as-of <seq>` point-in-time restore
cdc-enabled = false           # tail peers' WAL feeds to invalidate the
                              # result cache cluster-wide (lifts the
                              # single-node-only cache refusal)
cdc-max-retention-bytes = 67108864  # WAL bytes pinned for lagging tail
                              # cursors before they are forced off
                              # (410 Gone -> consumer resyncs)
cdc-poll-interval = "50ms"    # tailer poll cadence (Go duration)
cdc-max-batch-bytes = 1048576 # max event bytes per tail poll
# cdc-follow = ""             # upstream URI: run as a read replica
                              # (non-quorum follower; writes 403)
cdc-staleness-budget = "1s"   # declared follower staleness bound; reads
                              # past it shed 503 (X-Pilosa-Max-Staleness
                              # can tighten per request); 0 = unbounded

# Serving QoS (docs/QOS.md): admission -> deadline -> hedged reads
qos-max-inflight = 0          # concurrent-query cap; excess sheds 429 (0 = off)
qos-tenant-inflight = 0       # per-tenant cap (X-Pilosa-Tenant); 0 = global
qos-default-deadline = 0.0    # server-default request deadline; 0 = none
qos-hedge-delay = 0.25        # hedge trigger before the p95 tracker warms up
qos-hedge-budget = 0.05       # max hedges as a fraction of reads; 0 disables
qos-breaker-threshold = 5     # consecutive faults before a breaker opens
qos-breaker-cooldown = 5.0    # open -> half-open probe interval (seconds)
tracing = false               # legacy always-on switch (= sample rate 1.0)
trace-sample-rate = 0.0       # probabilistic trace sampling: 0 = off
                              # (zero overhead), 0.01 = 1% of requests
                              # root a cross-node span tree on
                              # /debug/traces (docs/OBSERVABILITY.md)
# trace-log-dir = ""          # where POST /debug/trace-device writes JAX
                              # profiler captures (default:
                              # <data-dir>/jax-traces)

# Query cost plane (docs/OBSERVABILITY.md): PROFILE is per-request
# (?profile=true), the ledger/heat surfaces are always on
slow-query-ring = 100         # offenders kept by /debug/queries/slow
                              # (threshold = long-query-time above)
heat-half-life = 300.0        # decay half-life (seconds) of the
                              # per-shard heat counters (/debug/heatmap)
# slo-objectives = ["reads:latency:100ms:0.99", "avail:errors:0.999"]
                              # declarative SLOs; burn rates exported as
                              # slo_* gauges and GET /debug/slo
# slo-windows = ["300s", "3600s"]  # burn-rate evaluation windows
                              # (default: the classic 5m/1h pair)
# statsd = "127.0.0.1:8125"   # statsd UDP sink (Prometheus /metrics is
                              # always on)
# diagnostics-endpoint = ""   # phone-home URL; empty = off
verbose = false

# [tls]
# certificate = "/path/node.crt"
# key = "/path/node.key"
# skip-verify = false         # accept self-signed peer certs
"""


def _load_config(path: str | None) -> dict:
    """The TOML file's keys, then the ``PILOSA_TPU_*`` environment
    variables over them (``PILOSA_TPU_DATA_DIR`` is ``data-dir``)."""
    cfg: dict = {}
    if path:
        import tomllib

        with open(path, "rb") as f:
            cfg = tomllib.load(f)
    for key, val in os.environ.items():
        if key.startswith("PILOSA_TPU_"):
            cfg[key[len("PILOSA_TPU_"):].lower().replace("_", "-")] = val
    return cfg


def cmd_server(args) -> int:
    from pilosa_tpu_torch.server import Server
    from pilosa_tpu_torch.server.server import (
        MESH_KNOBS,
        MP_KNOBS,
        SERVING_KNOBS,
    )
    from pilosa_tpu_torch.utils.logger import new_standard_logger

    if args.unported:
        print("error: the port does not have the plane of config knob(s) "
              f"{', '.join(args.unported)}; leave them at their defaults",
              file=sys.stderr)
        return 1
    new_standard_logger("pilosa_tpu_torch", verbose=args.verbose)
    server = Server(args.data_dir, bind=args.bind, port=args.port,
                    device=args.device,
                    verify_on_load=args.verify_on_load,
                    budget_bytes=args.residency_budget_bytes,
                    durability_mode=args.durability_mode,
                    group_commit_max_ms=args.group_commit_max_ms,
                    group_commit_max_ops=args.group_commit_max_ops,
                    residency_host_tier_bytes=args.residency_host_tier_bytes,
                    residency_promote_interval=args.residency_promote_interval,
                    residency_promote_heat=args.residency_promote_heat,
                    residency_demote_heat=args.residency_demote_heat,
                    scrub_interval=args.scrub_interval,
                    scrub_max_bytes_per_sec=args.scrub_max_bytes_per_sec,
                    max_writes_per_request=args.max_writes_per_request,
                    # the serving envelope's, the mesh's and multi-process
                    # serving's knobs: config file and env
                    **{k.replace("-", "_"): getattr(args, k.replace("-", "_"))
                       for k in SERVING_KNOBS + MESH_KNOBS
                       + MP_KNOBS}).open()
    print(f"pilosa_tpu_torch serving {args.data_dir} on "
          f"http://{args.bind}:{server.port} ({server.holder.device})",
          flush=True)
    try:
        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        stop.wait()
    finally:
        server.close()
    return 0


def cmd_serve_worker(args) -> int:
    """One ``SO_REUSEPORT`` serving worker (``serving/worker.py``)."""
    from pilosa_tpu_torch.serving.worker import worker_main

    return worker_main(args.handshake_sock, args.listen_fd, args.worker_id)


def _add_serve_worker(sub) -> None:
    p = sub.add_parser("serve-worker",
                       help="one serving worker (spawned by a server)")
    p.add_argument("--handshake-sock", required=True)
    p.add_argument("--listen-fd", type=int, required=True)
    p.add_argument("--worker-id", type=int, required=True)
    p.set_defaults(fn=cmd_serve_worker)


# ------------------------------------------------------------ HTTP client


class _HTTPStatusError(Exception):
    """A non-2xx answer (its code and body text)."""

    def __init__(self, code: int, detail: str):
        super().__init__(f"HTTP {code}: {detail}")
        self.code = code
        self.detail = detail


_conns = threading.local()  # a keep-alive connection a thread and host


def _http(method: str, url: str, data: bytes | None = None,
          content_type: str = "application/json"):
    """One request on this thread's keep-alive connection to the host;
    the answer's JSON (a 3xx or an error status raises)."""
    u = urllib.parse.urlsplit(url)
    pool = _conns.__dict__.setdefault("by_host", {})
    key = (u.scheme, u.netloc)
    path = u.path + (f"?{u.query}" if u.query else "")
    headers = {"Content-Type": content_type} if data is not None else {}
    for attempt in (0, 1):
        conn = pool.get(key)
        if conn is None:
            cls = (http.client.HTTPSConnection if u.scheme == "https"
                   else http.client.HTTPConnection)
            conn = pool[key] = cls(u.netloc, timeout=300.0)
        try:
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            break
        except (ConnectionError, http.client.RemoteDisconnected):
            # a kept-alive connection the server closed: once afresh
            conn.close()
            pool.pop(key, None)
            if attempt:
                raise
    if 300 <= resp.status < 400:
        location = resp.headers.get("Location", "")
        raise _HTTPStatusError(
            resp.status, "redirect" + (f" to {location}" if location else "")
            + " — point --host at the final URL")
    if resp.status >= 400:
        raise _HTTPStatusError(resp.status, body.decode(errors="replace"))
    return json.loads(body or b"{}")


def _iter_csv_bits(files, batch: float):
    """``row,col[,ts]`` lines as (rows, cols, timestamps|None) batches of
    at most ``batch`` lines, streamed."""
    rows, cols, timestamps = [], [], []
    any_ts = False
    for path in files:
        fh = sys.stdin if path == "-" else open(path)
        try:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                rows.append(int(parts[0]))
                cols.append(int(parts[1]))
                ts = parts[2] if len(parts) > 2 else None
                timestamps.append(ts)
                any_ts = any_ts or ts is not None
                if len(rows) >= batch:
                    yield rows, cols, (timestamps if any_ts else None)
                    rows, cols, timestamps = [], [], []
                    any_ts = False
        finally:
            if fh is not sys.stdin:
                fh.close()
    if rows:
        yield rows, cols, (timestamps if any_ts else None)


def _iter_csv_values(files, batch: float):
    """``col,value`` lines as (cols, vals) batches, streamed."""
    cols, vals = [], []
    for path in files:
        fh = sys.stdin if path == "-" else open(path)
        try:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                cols.append(int(parts[0]))
                vals.append(int(parts[1]))
                if len(cols) >= batch:
                    yield cols, vals
                    cols, vals = [], []
        finally:
            if fh is not sys.stdin:
                fh.close()
    if cols:
        yield cols, vals


def _in_process_api(data_dir: str, device):
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import Holder

    return API(Holder(data_dir, device=device).open())


def _probe_batch_limit(host: str) -> int:
    """The server's write-batch limit from /status (0: none advertised;
    a failed probe too, the 413 split then finds the size)."""
    try:
        st = _http("GET", f"{host}/status")
        return int(st.get("maxWritesPerRequest") or 0)
    except (_HTTPStatusError, OSError, http.client.HTTPException,
            ValueError):
        return 0


def _post_import(host: str, path: str, payload: dict) -> int:
    """POST one import body; a 413 splits it in half and posts both.
    Returns the bits changed."""
    body = json.dumps(payload).encode()
    try:
        return _http("POST", f"{host}{path}", body).get("changed", 0)
    except _HTTPStatusError as e:
        n = len(payload["columns"])
        if e.code == 413 and n > 1:
            lo = {k: (v[: n // 2] if isinstance(v, list) else v)
                  for k, v in payload.items()}
            hi = {k: (v[n // 2:] if isinstance(v, list) else v)
                  for k, v in payload.items()}
            return (_post_import(host, path, lo)
                    + _post_import(host, path, hi))
        raise


def cmd_import(args) -> int:
    if args.data_dir:
        api = _in_process_api(args.data_dir, args.device)
        if args.create:
            if api.holder.index(args.index) is None:
                api.create_index(args.index)
            if api.holder.index(args.index).field(args.field) is None:
                opts = ({"type": "int", "min": args.min, "max": args.max}
                        if args.values else {})
                api.create_field(args.index, args.field, opts)
        batch = args.batch_size if args.batch_size > 0 else 1_000_000
        n = 0
        if args.values:
            for cols, vals in _iter_csv_values(args.files, batch):
                n += api.import_values(args.index, args.field, cols, vals,
                                       clear=args.clear)
        else:
            for rows, cols, ts in _iter_csv_bits(args.files, batch):
                n += api.import_bits(args.index, args.field, rows, cols,
                                     timestamps=ts, clear=args.clear)
        api.holder.close()
        print(f"imported: {n} bits changed")
        return 0
    host = args.host.rstrip("/")
    batch = args.batch_size if args.batch_size > 0 else DEFAULT_IMPORT_BATCH
    limit = _probe_batch_limit(host)
    if limit > 0:
        batch = min(batch, limit)
    workers = max(1, args.concurrency)
    if args.values:
        path = f"/index/{args.index}/field/{args.field}/import-value"
        payloads = (
            {"columns": cols, "values": vals, "clear": args.clear}
            for cols, vals in _iter_csv_values(args.files, batch))
    else:
        path = f"/index/{args.index}/field/{args.field}/import"

        def _bit_payloads():
            for rows, cols, ts in _iter_csv_bits(args.files, batch):
                p = {"rows": rows, "columns": cols, "clear": args.clear}
                if ts:
                    p["timestamps"] = ts
                yield p

        payloads = _bit_payloads()
    total = 0
    try:
        if args.create:
            _http_create(host, args)
        # batch N+1 parses here while up to ``workers`` POSTs are in
        # flight
        inflight: collections.deque = collections.deque()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for payload in payloads:
                inflight.append(pool.submit(_post_import, host, path,
                                            payload))
                while len(inflight) > workers:
                    total += inflight.popleft().result()
            while inflight:
                total += inflight.popleft().result()
    except _HTTPStatusError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (OSError, http.client.HTTPException) as e:
        print(f"error: connection to {host} failed: {e}", file=sys.stderr)
        return 1
    print(f"imported: {total} bits changed")
    return 0


def _http_create(host: str, args) -> None:
    """The index and field for ``--create`` over HTTP (409: exists)."""
    for url, body in (
        (f"{host}/index/{args.index}", {}),
        (f"{host}/index/{args.index}/field/{args.field}",
         {"options": {"type": "int", "min": args.min, "max": args.max}}
         if args.values else {}),
    ):
        try:
            _http("POST", url, json.dumps(body).encode())
        except _HTTPStatusError as e:
            if e.code != 409:
                raise


def cmd_export(args) -> int:
    if args.data_dir:
        api = _in_process_api(args.data_dir, args.device)
        sys.stdout.write(api.export_csv(args.index, args.field))
        api.holder.close()
        return 0
    host = args.host.rstrip("/")
    url = f"{host}/export?index={args.index}&field={args.field}"
    with urllib.request.urlopen(url) as resp:
        sys.stdout.write(resp.read().decode())
    return 0


def cmd_config(args) -> int:
    from pilosa_tpu_torch.server.server import ServerConfig

    cfg = ServerConfig.from_dict(_load_config(args.config))
    print(json.dumps(cfg.to_dict(), indent=2))
    return 0


def cmd_generate_config(args) -> int:
    print(_DEFAULT_TOML, end="")
    return 0


def cmd_inspect(args) -> int:
    """Per-fragment statistics of a data dir (reference ctl/inspect.go)."""
    from pilosa_tpu_torch.roaring.bitmap import ARRAY, BITMAP, RUN
    from pilosa_tpu_torch.storage import Holder

    holder = Holder(args.data_dir, device=args.device).open()
    kind_names = {ARRAY: "array", BITMAP: "bitmap", RUN: "run"}
    for iname, idx in sorted(holder.indexes.items()):
        for fname, field in sorted(idx.fields.items()):
            for vname, view in sorted(field.views.items()):
                for shard, frag in sorted(view.fragments.items()):
                    kinds = {"array": 0, "bitmap": 0, "run": 0}
                    for key in frag.bitmap.keys:
                        kinds[kind_names[frag.bitmap.container(key).kind]] \
                            += 1
                    print(f"{iname}/{fname}/{vname}/{shard}: "
                          f"bits={frag.bitmap.count()} "
                          f"rows={len(frag.row_ids())} "
                          f"containers={len(frag.bitmap.keys)} {kinds} "
                          f"ops={frag.op_n}")
    holder.close()
    return 0


def cmd_check(args) -> int:
    """The integrity check: an offline scrub of a data dir (``-d``), or
    one live scrub pass on a running node (``--host``)."""
    if args.host:
        url = f"{args.host.rstrip('/')}/internal/scrub"
        try:
            req = urllib.request.Request(url, data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=3600) as resp:
                out = json.loads(resp.read() or b"{}")
        except Exception as e:  # noqa: BLE001 — any failure is reported
            print(f"error: live scrub via {url} failed: {e}",
                  file=sys.stderr)
            return 1
        print(f"live scrub: scanned={out.get('scanned', 0)} "
              f"bytes={out.get('bytes', 0)} corrupt={out.get('corrupt', 0)} "
              f"repaired={out.get('repaired', 0)} "
              f"self_healed={out.get('self_healed', 0)} "
              f"unrepaired={out.get('unrepaired', 0)}")
        return 1 if out.get("unrepaired", 0) else 0
    if not args.data_dir:
        print("error: check needs -d/--data-dir or --host", file=sys.stderr)
        return 1
    from pilosa_tpu_torch.roaring.format import replay_ops
    from pilosa_tpu_torch.storage import integrity

    def check(path: str) -> tuple[bool, str]:
        try:
            bitmap, data, ops_at = integrity.verify_fragment_file(path)
            n_ops, _ = replay_ops(bitmap, data, ops_at)
            return True, f"ok: {path} bits={bitmap.count()} ops={n_ops}"
        except Exception as e:  # noqa: BLE001 — every failure is a verdict
            return False, f"CORRUPT: {path}: {e}"

    data_dir = os.path.expanduser(args.data_dir)
    pattern = os.path.join(data_dir, "**", "fragments", "*")
    paths = [p for p in sorted(glob.glob(pattern, recursive=True))
             if os.path.isfile(p)
             and not p.endswith((".cache", integrity.CHECKSUM_SUFFIX))
             and not integrity.is_quarantined(os.path.basename(p))]
    bad = 0
    # decoding and digesting release the GIL: several files at once, the
    # verdicts printed in path order
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for ok, line in pool.map(check, paths):
            bad += not ok
            print(line, file=sys.stdout if ok else sys.stderr)
    quarantined = integrity.list_quarantined(data_dir)
    for q in quarantined:
        print(f"QUARANTINED: {q}", file=sys.stderr)
    return 1 if bad or quarantined else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["serve-worker"]:
        # a worker parses before the server's imports: it loads no torch
        parser = argparse.ArgumentParser(prog="pilosa_tpu_torch")
        _add_serve_worker(parser.add_subparsers(dest="cmd", required=True))
        args = parser.parse_args(argv)
        return args.fn(args)
    from pilosa_tpu_torch.server.server import ServerConfig
    from pilosa_tpu_torch.storage.residency import DEFAULT_BUDGET_BYTES
    from pilosa_tpu_torch.storage.wal import DURABILITY_MODES

    parser = argparse.ArgumentParser(
        prog="pilosa_tpu_torch",
        description="the PyTorch + CUDA port of pilosa-tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("server", help="run a server node")
    p.add_argument("-c", "--config", help="TOML config file")
    p.add_argument("-d", "--data-dir")
    p.add_argument("-b", "--bind")
    p.add_argument("--port", type=int)
    p.add_argument("--verbose", action="store_true", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--residency-budget-bytes", type=int,
                   help="device bytes for resident leaves")
    p.add_argument("--durability-mode", choices=DURABILITY_MODES,
                   help="what an HTTP 200 on a write means: group (one "
                   "fsync a commit group), per-op (one fsync a record) or "
                   "flush-only (no fsync)")
    p.add_argument("--group-commit-max-ms", type=float,
                   help="longest a record waits for its group's fsync")
    p.add_argument("--group-commit-max-ops", type=int,
                   help="most op records fsynced in one group")
    p.add_argument("--residency-host-tier-bytes", type=int,
                   help="host RAM for the residency cache's host tier")
    p.add_argument("--residency-promote-interval", type=float,
                   help="seconds between heat-driven tiering passes (0: "
                   "no tiering)")
    p.add_argument("--residency-promote-heat", type=float,
                   help="heat at which a host-tier leaf is promoted")
    p.add_argument("--residency-demote-heat", type=float,
                   help="heat below which a device leaf moves to host")
    p.add_argument("--scrub-interval", type=float,
                   help="seconds between integrity scrub passes (0: no "
                   "scrubber)")
    p.add_argument("--scrub-max-bytes-per-sec", type=int,
                   help="read budget of the scrubber (0: unpaced)")
    p.set_defaults(fn=cmd_server)

    _add_serve_worker(sub)

    p = sub.add_parser("import",
                       help="bulk-import CSV (row,col[,ts] or col,value)")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--field", required=True)
    p.add_argument("--host", default=DEFAULT_HOST)
    p.add_argument("-d", "--data-dir",
                   help="import in-process against a data dir")
    p.add_argument("--device", default=None,
                   help="with -d: cuda (default) or cpu")
    p.add_argument("--values", action="store_true",
                   help="CSV is col,value (int field)")
    p.add_argument("--clear", action="store_true")
    p.add_argument("--create", action="store_true",
                   help="create index/field if missing")
    p.add_argument("--min", type=int, default=0)
    p.add_argument("--max", type=int, default=1 << 32)
    p.add_argument("--batch-size", type=int, default=0,
                   help="rows per HTTP batch (default 100000, clamped to "
                        "the server's max-writes-per-request)")
    p.add_argument("--concurrency", type=int, default=1,
                   help="parallel in-flight POSTs; >1 reorders batches, so "
                        "duplicate columns across batches lose write order")
    p.add_argument("files", nargs="+", help="CSV files ('-' for stdin)")
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("export", help="export field as CSV")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--field", required=True)
    p.add_argument("--host", default=DEFAULT_HOST)
    p.add_argument("-d", "--data-dir")
    p.add_argument("--device", default=None,
                   help="with -d: cuda (default) or cpu")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("config", help="echo resolved config")
    p.add_argument("-c", "--config")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("generate-config", help="print default TOML config")
    p.set_defaults(fn=cmd_generate_config)

    p = sub.add_parser("inspect", help="dump fragment statistics")
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "check", help="verify fragment files against their checksum "
        "sidecars (offline -d scrub, or --host live scrub trigger)")
    p.add_argument("-d", "--data-dir",
                   help="offline scrub of a data dir (node stopped)")
    p.add_argument("--host", help="trigger a live scrub pass on a running "
                   "node")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("version", help="print version")
    p.set_defaults(fn=lambda a: (print(__version__), 0)[1])

    args = parser.parse_args(argv)
    if args.cmd == "server":
        # the config file and the environment resolve every knob; a flag
        # given on the command line overrides it
        cfg = ServerConfig.from_dict(_load_config(args.config))
        kwargs = cfg.server_kwargs()
        resolved = {"residency_budget_bytes": kwargs.pop(
            "budget_bytes", DEFAULT_BUDGET_BYTES), "verbose": cfg.verbose,
            **kwargs}
        for name, value in resolved.items():
            if getattr(args, name, None) is None:
                setattr(args, name, value)
        args.unported = cfg.unported()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

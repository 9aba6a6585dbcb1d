"""Tracing, the query inspector, the stats registry and the ``/metrics``
and ``/debug`` surface against the reference: the tracer's units driven
the same way in both packages, and a reference API server beside a port
Server on copies of one 4-shard dir.

Compared: span trees of served Counts, Rows, writes and a remote hop
(names, nesting and tags; ids and durations are random and clock
readings, so only their presence and consistency are checked);
``X-Pilosa-Trace`` round-trips into a ``remote=true`` answer; the
in-flight inspector's stages; ``StatsClient`` quantiles, histograms and
escaping; every ``/metrics`` family the port renders has the
reference's HELP and TYPE (the port renders no family of a plane it
does not have) and the page parses as Prometheus text; ``/debug/*`` JSON
keys; ``POST /debug/trace-device`` on a CPU server (a CPU trace file;
the card's is checked by ``tests/test_torch_cuda.py``) and its 400s; a
capture on a CUDA device that recorded no kernel writes no trace.
"""

import json
import os
import re
import threading

import numpy as np
import pytest

import pilosa_tpu.utils.pool as jpool
import pilosa_tpu.utils.stats as jstats
import pilosa_tpu.utils.tracing as jtracing
import pilosa_tpu_torch.utils.pool as ppool
import pilosa_tpu_torch.utils.stats as pstats
import pilosa_tpu_torch.utils.tracing as ptracing
from torch_serving_helpers import Pair, fresh_planes, seed_dir

TRACING = {"jax": jtracing, "port": ptracing}


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing") / "seed"
    return root, seed_dir(root)


@pytest.fixture
def pair(seed, tmp_path):
    with fresh_planes(sample_rate=1.0):
        p = Pair(seed[0], tmp_path, trace_sample_rate=1.0)
        try:
            yield p
        finally:
            p.close()


def _shape(tree) -> dict:
    """A span tree without its random ids and durations."""
    return {"name": tree["name"], "tags": tree["tags"],
            "children": [_shape(c) for c in tree["children"]]}


def _consistent(tree, parent=None) -> None:
    assert re.fullmatch(r"[0-9a-f]{16}", tree["traceId"])
    assert re.fullmatch(r"[0-9a-f]{12}", tree["spanId"])
    assert tree["durationMs"] >= 0
    if parent is not None:
        assert tree["traceId"] == parent["traceId"]
        assert tree["parentId"] == parent["spanId"]
    for c in tree["children"]:
        _consistent(c, tree)


# ------------------------------------------------------------------ units


def _tracer_steps(t) -> list:
    out = []
    tr = t.Tracer(sample_rate=1.0)
    with tr.root_span("root", a=1) as root:
        with tr.span("child", b=2) as child:
            out.append((t.current_span() is child,
                        child.parent_id == root.span_id))
        header = root.header_value()
    out.append(t.current_span() is None)
    out.append(_shape(tr.recent()[0]))
    out.append(t.parse_trace_header(header) == (root.trace_id, root.span_id))
    out.append([t.parse_trace_header(v) for v in (None, "", "x", "a:",
                                                  ":b", "a:b:c")])
    with tr.remote_root(header, "rpc.query", node="n1") as remote:
        out.append((remote.trace_id == root.trace_id,
                    remote.parent_id == root.span_id))
    with tr.remote_root("bad", "rpc.query") as none_span:
        with tr.span("inner") as inner:
            out.append((none_span, inner))
    off = t.Tracer(sample_rate=0.0)
    h = off.span("x")
    out.append((h is off.request_root("y") is off.span("z"),
                off.spans_started))
    with tr.root_span("pool") as proot:
        pool = ppool if t is ptracing else jpool
        ids = pool.concurrent_map(
            lambda i: (t.current_span() or proot).trace_id, range(4))
        out.append(all(i == proot.trace_id for i in ids))
    out.append(sorted(tr.metrics()))
    span = t.Span("s", {"k": 1})
    with t.use_span(span):
        out.append(t.current_span() is span)
    return out


def test_tracer_units_match_reference():
    assert _tracer_steps(ptracing) == _tracer_steps(jtracing)
    for mod in TRACING.values():
        mod_t = mod.Tracer(sample_rate=0.5)
        import random

        random.seed(0)
        for _ in range(50):
            with mod_t.request_root("http.query") as root:
                if root is None:
                    with mod_t.span("inner") as inner:
                        assert inner is None
        assert all(s.name == "http.query" for s in mod_t.finished)
    assert ptracing.TRACE_HEADER == jtracing.TRACE_HEADER


def _stats_steps(s) -> list:
    c = s.StatsClient()
    out = [c.quantile("none", 0.5), "quantile" in c.prometheus_text()]
    c.timing("t", 0.042)
    out.append([c.quantile("t", q) for q in (0.0, 0.5, 0.95)])
    c.observe("obs", 7)
    c.observe("obs", 3)
    out.append(c.quantile("obs", 0.5))
    out.append([s._quantile(v, q) for v, q in (([1.0], 1.0),
                                               ([1.0, 2.0], 1.0),
                                               ([3.0, 1.0, 2.0], 0.5))])
    for b in s.HISTOGRAM_BUCKETS_S:
        c.timing("all", b)
    c.timing("edge", np.nextafter(s.HISTOGRAM_BUCKETS_S[0], 1.0))
    c.timing("big", s.HISTOGRAM_BUCKETS_S[-1] * 2)
    c.count("qos_shed", 1, {"tenant": 'evil"} 1 back\\slash\nline'})
    c.gauge("g", 2.5, {"k": "v"})
    for v in (0.0004, 0.003, 0.003, 0.2, 9.0, 99.0):
        c.timing("query", v, {"call": "Count"})
    out.append(c.prometheus_text())
    out.append(json.dumps(c.snapshot(), sort_keys=True))
    return out


def test_stats_client_matches_reference():
    assert _stats_steps(pstats) == _stats_steps(jstats)
    assert pstats.SAMPLE_WINDOW == jstats.SAMPLE_WINDOW


# -------------------------------------------------------------- served


def _trees(pair, pkg) -> list:
    out = pair.json(pkg, "/debug/traces")
    assert out["enabled"] is True and out["sampleRate"] == 1.0
    for t in out["traces"]:
        _consistent(t)
    return out["traces"]


def test_served_span_trees_match_reference(pair):
    queries = [b"Count(Row(f=1))", b"Count(Intersect(Row(f=1), Row(g=7)))",
               b"Row(g=7)", b"Set(77, f=2)", b"Rows(f)", b"TopN(f, n=2)",
               b"Count(Row(nosuch=1))"]
    for q in queries:
        pair.same("POST", "/index/i/query", q,
                  {"X-Pilosa-Tenant": "t1"})
    trees = {pkg: [_shape(t) for t in _trees(pair, pkg)]
             for pkg in ("jax", "port")}
    assert len(trees["port"]) == len(trees["jax"]) == len(queries)
    # named difference: TopN's K8 launches at submit, on the dispatcher
    # thread, so its device.dispatch span hangs off the request's root;
    # the reference micro-batches the recount and flushes it at resolve,
    # under executeTopN (tagged batch=1)
    topn = queries.index(b"TopN(f, n=2)")
    ptop, jtop = trees["port"].pop(topn), trees["jax"].pop(topn)
    (pdisp,) = [c for c in ptop["children"] if c["name"] == "device.dispatch"]
    ptop["children"].remove(pdisp)
    (jexec,) = [c for c in jtop["children"]
                if c["name"] == "executor.Execute"]
    (jdisp,) = jexec["children"][0]["children"]
    jexec["children"][0]["children"] = []
    assert pdisp["tags"] == {"reduce": "countrows"}
    assert jdisp["tags"] == {"reduce": "countrows", "batch": 1}
    assert ptop == jtop
    assert trees["port"] == trees["jax"]
    (count,) = [t for t in _trees(pair, "port")
                if t["children"][-1]["children"]
                and t["children"][-1]["children"][0]["name"]
                == "executeCount"][:1]
    names = []

    def walk(t):
        names.append(t["name"])
        for c in t["children"]:
            walk(c)

    walk(count)
    assert names == ["http.query", "qos.admit", "pipeline.wave",
                     "executor.Execute", "executeCount", "device.dispatch"]
    write = _trees(pair, "port")[3]
    assert [c["name"] for c in write["children"]] == [
        "qos.admit", "executor.Execute", "wal.barrier"]


def test_trace_header_round_trips(pair):
    hdr = {"X-Pilosa-Trace": "aabbccddeeff0011:112233445566"}
    outs = {}
    for pkg in ("jax", "port"):
        st, _, body = pair.get(pkg, "POST",
                               "/index/i/query?remote=true&shards=0",
                               b"Count(Row(f=1))", hdr)
        assert st == 200
        outs[pkg] = json.loads(body)
    assert outs["port"]["results"] == outs["jax"]["results"]
    sub = outs["port"]["trace"]
    assert (sub["traceId"], sub["parentId"], sub["name"]) == (
        "aabbccddeeff0011", "112233445566", "rpc.query")
    _consistent(sub)
    assert _shape(sub) == _shape(outs["jax"]["trace"])
    # protobuf answers carry it as trace_json
    from pilosa_tpu_torch.wire import serializer as pser

    st, _, body = pair.get("port", "POST",
                           "/index/i/query?remote=true&shards=0",
                           b"Count(Row(f=1))",
                           {**hdr, "Accept": "application/x-protobuf"})
    assert st == 200
    dec = pser.decode_results_json(body)
    assert dec["trace"]["name"] == "rpc.query"
    # the peer's own ring keeps its rpc.query tree; a malformed header
    # traces nothing
    assert [t["name"] for t in _trees(pair, "port")] == ["rpc.query"] * 2
    pair.same("POST", "/index/i/query?remote=true", b"Count(Row(f=1))",
              {"X-Pilosa-Trace": "garbage"})
    assert len(_trees(pair, "port")) == 2


def test_inflight_inspector_stages_match_reference(pair):
    """A request held at the admission gate shows on /debug/queries with
    its stage, and drains once it answers; the slow ring keeps its span
    tree."""
    for pkg, api in pair.apis().items():
        api.long_query_time = 1e-9
        admission = api.qos.admission
        real = admission.admit
        entered, release = threading.Event(), threading.Event()

        def held(tenant="default", real=real, entered=entered,
                 release=release):
            entered.set()
            assert release.wait(30)
            return real(tenant)

        admission.admit = held
        res = []
        t = threading.Thread(target=lambda pkg=pkg: res.append(pair.get(
            pkg, "POST", "/index/i/query", b"Count(Row(f=1))")))
        t.start()
        try:
            assert entered.wait(30)
            live = pair.json(pkg, "/debug/queries")
            assert [(q["pql"], q["index"], q["stage"], q["tenant"],
                     q["remote"]) for q in live["queries"]] == [
                ("Count(Row(f=1))", "i", "admission", "default", False)]
            assert "traceId" in live["queries"][0]
        finally:
            release.set()
            t.join(60)
            admission.admit = real
        assert res[0][0] == 200
    for pkg in ("jax", "port"):
        assert pair.json(pkg, "/debug/queries")["queries"] == []
    slow = {pkg: pair.json(pkg, "/debug/queries/slow")
            for pkg in ("jax", "port")}
    for out in slow.values():
        (entry,) = out["queries"]
        _consistent(entry["trace"])
        entry["trace"] = _shape(entry["trace"])
        for k in ("seconds", "at", "traceId"):
            entry.pop(k)
    assert slow["port"] == slow["jax"]


def test_trace_device_on_a_cpu_server(pair):
    st, _, body = pair.get("port", "POST", "/debug/trace-device?secs=0.1")
    assert st == 200, body
    out = json.loads(body)
    assert sorted(out) == ["logDir", "seconds"] and out["seconds"] >= 0.1
    assert out["logDir"] == os.path.join(pair.roots["port"], "jax-traces")
    (name,) = os.listdir(out["logDir"])
    with open(os.path.join(out["logDir"], name)) as f:
        trace = json.load(f)
    assert "traceEvents" in trace
    for bad in ("0", "-1", "61", "nan", "x"):
        pair.same("POST", f"/debug/trace-device?secs={bad}")


def test_a_device_trace_without_kernels_is_refused(tmp_path, monkeypatch):
    """A capture on a CUDA device whose trace holds no kernel event (the
    profiler traced the CPU side only) writes no file and raises, so the
    route answers 500, not a CPU-only trace. Driven here with CPU
    activity alone under a ``cuda`` device."""
    import torch
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(ptracing, "device_trace_activities",
                        lambda device: [ProfilerActivity.CPU])
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        ptracing.capture_device_trace(str(tmp_path), torch.device("cuda"),
                                      0.01)
    assert os.listdir(tmp_path) == []
    path = ptracing.capture_device_trace(str(tmp_path), torch.device("cpu"),
                                         0.01)
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def _parse_page(text: str) -> dict:
    """family -> (help, type) of a Prometheus page, checking every line
    parses and every sample belongs to a declared family."""
    fams: dict = {}
    helps: dict = {}
    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? "
                        r"([-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|[Ii]nf|NaN))$")
    types = [line for line in text.splitlines() if line.startswith("# TYPE")]
    assert len(types) == len(set(types))
    for line in text.splitlines():
        if line.startswith("# HELP "):
            _, _, name, help_ = line.split(" ", 3)
            helps[name] = help_
        elif line.startswith("# TYPE "):
            _, _, name, type_ = line.split(" ")
            fams[name] = (helps[name], type_)
        else:
            m = sample.match(line)
            assert m, line
            name = m.group(1)
            assert name in fams or any(
                name.endswith(sfx) and name[:-len(sfx)] in fams
                for sfx in ("_bucket", "_sum", "_count")), line
    return fams


def test_metrics_families_match_reference(pair):
    for q in (b"Count(Row(f=1))", b"Set(5, f=3)", b"Row(g=7)",
              b"Count(Row(f=1))"):
        # profiled answers carry times: statuses only
        j, p = pair.both("POST", "/index/i/query?profile=true", q,
                         {"X-Pilosa-Tenant": "acme"})
        assert j[0] == p[0] == 200
    pair.same("POST", "/index/i/field/f/import",
              b'{"rows": [2], "columns": [9]}')
    pages = {pkg: _parse_page(pair.get(pkg, "GET", "/metrics")[2].decode())
             for pkg in ("jax", "port")}
    for name, meta in pages["port"].items():
        assert pages["jax"].get(name) == meta, name
    # the reference's families the port does not render are those of the
    # planes it has not ported: the cluster's (autopilot, elastic, CDC,
    # range routing), and the host-path and merge kernels' counters (the
    # mesh's dist_reduce_* and multi-process serving's serving_* are
    # rendered)
    unported = ("pilosa_tpu_autopilot_", "pilosa_tpu_elastic_",
                "pilosa_tpu_cdc_", "pilosa_tpu_cluster_",
                "pilosa_tpu_routing_range_",
                "pilosa_tpu_wal_cdc_", "pilosa_tpu_hostpath_",
                "pilosa_tpu_ingest_merge_")
    missing = [n for n in pages["jax"] if n not in pages["port"]]
    assert missing
    for name in missing:
        assert name.startswith(unported), name
    for family in ("pilosa_tpu_serving_waves_total",
                   "pilosa_tpu_qos_admitted_total",
                   "pilosa_tpu_slow_queries_total",
                   "pilosa_tpu_tracing_sampled_traces_total",
                   "pilosa_tpu_inflight_queries",
                   "pilosa_tpu_tenant_queries_total",
                   "pilosa_tpu_heat_shard", "pilosa_tpu_slo_events_total",
                   "pilosa_tpu_result_cache_hits_total",
                   "pilosa_tpu_query_seconds",
                   "pilosa_tpu_query_hist_seconds",
                   "pilosa_tpu_fragment_row_writes_total",
                   "pilosa_tpu_dist_reduce_dispatches",
                   "pilosa_tpu_serving_workers",
                   "pilosa_tpu_serving_ring_queries_total"):
        assert family in pages["port"], family


def test_debug_routes_match_reference(pair):
    pair.same("POST", "/index/i/query", b"Count(Row(f=1))")
    for path in ("/debug/traces", "/debug/tenants", "/debug/heatmap",
                 "/debug/rescache", "/debug/slo", "/debug/queries",
                 "/debug/queries/slow", "/debug/long-queries",
                 "/debug/vars"):
        j, p = pair.json("jax", path), pair.json("port", path)
        assert set(p) <= set(j), path
        if path not in ("/debug/vars", "/debug/heatmap"):
            assert sorted(p) == sorted(j), path
    for pkg in ("jax", "port"):
        st, headers, body = pair.get(pkg, "GET", "/debug/pprof")
        assert st == 200 and body.startswith(b"--- thread ")
        assert headers["Content-Type"] == "text/plain"

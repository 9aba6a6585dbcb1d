"""The protobuf wire and the rest of the single-node HTTP surface against
the reference: one server of each package on copies of one 3-shard data
dir (set, int and keyed fields, a keyed index, row and column attrs),
the same requests, byte-identical bodies and statuses.

Covered: protobuf ``QueryResponse`` bytes of every shape of the parity
corpus, keys and attrs included; protobuf requests with JSON answers;
protobuf imports and import-values; ``import-roaring`` in both layouts,
malformed and over the limit; ``/export``, ``/schema``,
``/internal/schema``, ``/version``, ``/internal/shards/max``, ``GET
/index/{i}``, the deletes and their 404s; ``/info`` (equal but for
``devices``, which is the torch device); ``/metrics`` (every family the
port renders has the reference's HELP, TYPE and value). The wire module
loads beside the reference's generated module and needs no protoc.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.heat as jheat
import pilosa_tpu.storage.residency as jres
import pilosa_tpu.wire as jwire
import pilosa_tpu.wire.serializer as jser
import pilosa_tpu.utils.stats as jstats
import pilosa_tpu.utils.tracing as jtracing
from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch import wire
from pilosa_tpu_torch.roaring import RoaringBitmap
from pilosa_tpu_torch.roaring.format import serialize, serialize_pilosa
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage import FieldOptions, Holder
from pilosa_tpu_torch.storage import heat as pheat
from pilosa_tpu_torch.utils import stats as pstats
from pilosa_tpu_torch.utils import tracing as ptracing
from pilosa_tpu_torch.wire import serializer as pser

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SW = 1 << 20
SHARDS = 3
BUDGET = 64 << 20
PROTOBUF = "application/x-protobuf"


def _seed_dir(root: Path) -> int:
    """Fields f (rows 1-3), g (row 7), int fare (0..100) and keyed tag on
    index i with a row's and a column's attrs; index u with column keys
    and a keyed field seg. Returns a column of f row 1 (the probe)."""
    rng = np.random.default_rng(11)
    h = Holder(str(root), device="cpu").open()
    api = API(h)
    try:
        idx = h.create_index("i")
        f = idx.create_field("f")
        g = idx.create_field("g")
        fare = idx.create_field("fare", FieldOptions(type="int", min=0,
                                                     max=100))
        for s in range(SHARDS):
            for fld, rows in ((f, (1, 2, 3)), (g, (7,))):
                for r in rows:
                    pos = np.unique(rng.integers(0, SW, 40 * r + 30))
                    fld.view("standard", create=True).fragment(
                        s, create=True).bulk_import(
                            np.full(pos.size, r, np.uint64),
                            pos.astype(np.uint64))
                    idx.mark_columns_exist(pos.astype(np.uint64)
                                           + np.uint64(s * SW))
        cols = np.unique(rng.integers(0, SHARDS * SW, 300)).astype(np.uint64)
        fare.import_values(cols, rng.integers(0, 101, cols.size))
        idx.mark_columns_exist(cols)
        probe = int(f.view("standard").fragment(0).row_columns(1)[0])
        api.create_field("i", "tag", {"keys": True})
        api.query_raw("i", 'Set(3, tag="apple") Set(5, tag="avocado") '
                      'Set(7, tag="banana") '
                      'SetRowAttrs(f, 1, name="one", n=3, ok=true, w=1.5) '
                      f'SetColumnAttrs({probe}, city="nyc", zip=10001)')
        api.create_index("u", keys=True)
        api.create_field("u", "seg", {"keys": True})
        api.query_raw("u", 'Set("alice", seg="pro") Set("bob", seg="pro") '
                      'Set("carol", seg="free") SetRowAttrs(seg, "pro", x=1)')
    finally:
        h.close()
    return probe


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    root = tmp_path_factory.mktemp("wire") / "seed"
    return root, _seed_dir(root)


@pytest.fixture
def servers(seed, tmp_path):
    """(reference base URL, port base URL, port Server, probe column);
    the reference's row cache, and both heat maps, stats registries and
    query trackers fresh for the test."""
    root, probe = seed
    shutil.copytree(root, tmp_path / "jax")
    shutil.copytree(root, tmp_path / "port")
    old_cache = jres.global_row_cache()
    old_heats = (jheat.global_heat(), pheat.global_heat())
    old_stats = (jstats.global_stats(), pstats.global_stats())
    jres.set_global_row_cache(jres.DeviceRowCache(BUDGET))
    jheat.set_global_heat(jheat.HeatMap())
    pheat.set_global_heat(pheat.HeatMap())
    # both stats registries and query trackers count this test's traffic
    # alone
    jstats.set_global_stats(jstats.StatsClient())
    pstats.set_global_stats(pstats.StatsClient())
    old_trackers = (jtracing._global_query_tracker,
                    ptracing._global_query_tracker)
    jtracing._global_query_tracker = jtracing.QueryTracker()
    ptracing._global_query_tracker = ptracing.QueryTracker()
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu",
                  budget_bytes=BUDGET).open()
    try:
        yield (f"http://localhost:{jport}", f"http://localhost:{port.port}",
               port, probe)
    finally:
        jserver.shutdown()
        jserver.server_close()
        jh.close()
        port.close()
        jres.set_global_row_cache(old_cache)
        jheat.set_global_heat(old_heats[0])
        pheat.set_global_heat(old_heats[1])
        jstats.set_global_stats(old_stats[0])
        pstats.set_global_stats(old_stats[1])
        (jtracing._global_query_tracker,
         ptracing._global_query_tracker) = old_trackers


def _req(base: str, method: str, path: str, body: bytes | None = None,
         ctype: str | None = None, accept: str | None = None):
    r = urllib.request.Request(base + path, data=body, method=method)
    if body is not None:
        r.add_header("Content-Type", ctype or "application/json")
    if accept:
        r.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _same(servers, method, path, body=None, ctype=None, accept=None):
    jbase, pbase = servers[0], servers[1]
    want = _req(jbase, method, path, body, ctype, accept)
    got = _req(pbase, method, path, body, ctype, accept)
    assert got == want, (method, path, body)
    return got


def _corpus(probe: int) -> list:
    return [("i", q.format(probe=probe)) for q in DRYRUN_QUERY_SHAPES] + [
        ("i", "Row(f=1)"),                            # row attrs
        ("i", "Options(Row(g=7), columnAttrs=true)"),  # column attrs
        ("i", f"IncludesColumn(Row(f=1), column={probe + 1})"),
        ("i", "Rows(f, column=99999999)"),            # empty row ids
        ("i", 'Min(Row(f=3), field="fare") Count(Row(f=9))'),
        ("i", "GroupBy(Rows(tag))"),
        ("i", "TopN(tag)"),
        ("u", 'Row(seg="pro")'),                      # column keys
        ("u", "TopN(seg, n=2)"),                      # pairs with keys
        ("u", "GroupBy(Rows(seg))"),                  # rowKey
        ("u", 'Rows(seg)'),
        ("i", "Count(Row(nope=1))"),                  # 400 as err
        ("i", "Count(Row(f=1)"),                      # parse error
        ("nope", "Count(Row(f=1))"),
    ]


def test_protobuf_answers_match_reference(servers):
    probe = servers[3]
    for index, pql in _corpus(probe):
        path = f"/index/{index}/query"
        status, body = _same(servers, "POST", path, pql.encode(),
                             "text/plain", PROTOBUF)
        decoded = pser.decode_results_json(body)
        assert decoded == jser.decode_results_json(body)
        if status == 200:
            # the JSON surface's dicts (an empty columnAttrs list has no
            # protobuf form)
            _, jbody = _req(servers[1], "POST", path, pql.encode())
            want = json.loads(jbody)
            for res in want["results"]:
                if isinstance(res, dict) and res.get("columnAttrs") == []:
                    del res["columnAttrs"]
            assert decoded == want, pql
        else:
            assert set(decoded) == {"error"}, pql
    # writes answer RESULT_CHANGED, and the next read shows them
    for pql in (b"Set(7, f=9) Clear(7, f=9) Set(8, f=9)",
                b"Count(Row(f=9)) Row(f=9)"):
        _same(servers, "POST", "/index/i/query", pql, "text/plain",
              PROTOBUF)


def test_protobuf_requests_match_reference(servers):
    probe = servers[3]
    p = wire.pb2()
    reqs = [
        p.QueryRequest(query="Row(f=1) Count(Row(g=7))", shards=[0, 2]),
        p.QueryRequest(query="Options(Row(f=1), shards=[1])",
                       column_attrs=True),
        p.QueryRequest(query="Row(f=1)", exclude_row_attrs=True,
                       exclude_columns=True, remote=True),
        p.QueryRequest(query=f"Row(g=7) IncludesColumn(Row(f=1), "
                       f"column={probe})", column_attrs=True),
        p.QueryRequest(query="Count(Row(nope=1))"),
        p.QueryRequest(query='Row(seg="pro")'),
    ]
    for i, req in enumerate(reqs):
        body = req.SerializeToString()
        assert body == jwire.pb2().QueryRequest.FromString(
            body).SerializeToString()
        index = "u" if "seg" in req.query else "i"
        for accept in (None, PROTOBUF):  # JSON answers and protobuf ones
            _same(servers, "POST", f"/index/{index}/query", body, PROTOBUF,
                  accept)
    # the URL's shards= and result options, and the profile refusal
    for path in ("/index/i/query?shards=0,2",
                 "/index/i/query?shards=1&columnAttrs=true",
                 "/index/i/query?excludeColumns=true&remote=true",
                 "/index/i/query?shards=x"):
        for accept in (None, PROTOBUF):
            _same(servers, "POST", path, b"Row(f=1) Count(Row(f=2))",
                  "text/plain", accept)
    status, _ = _same(servers, "POST", "/index/i/query?profile=true",
                      b"Count(Row(f=1))", "text/plain", PROTOBUF)
    assert status == 400
    # a body that is not a QueryRequest
    _same(servers, "POST", "/index/i/query", b"\x0a\x09Row(", PROTOBUF,
          PROTOBUF)


def test_protobuf_imports_match_reference(servers):
    rng = np.random.default_rng(3)
    rows = rng.integers(1, 5, 300)
    cols = rng.integers(0, SHARDS * SW, 300)
    body = pser.encode_import_request("i", "f", rows, cols)
    assert body == jser.encode_import_request("i", "f", rows, cols)
    status, _ = _same(servers, "POST", "/index/i/field/f/import", body,
                      PROTOBUF)
    assert status == 200
    clear = pser.encode_import_request("i", "f", rows[:50], cols[:50],
                                       clear=True)
    _same(servers, "POST", "/index/i/field/f/import", clear, PROTOBUF)
    vcols = rng.choice(SHARDS * SW, 200, replace=False)
    vals = rng.integers(0, 101, 200)
    vbody = pser.encode_import_value_request("i", "fare", vcols, vals)
    assert vbody == jser.encode_import_value_request("i", "fare", vcols,
                                                     vals)
    status, _ = _same(servers, "POST", "/index/i/field/fare/import-value",
                      vbody, PROTOBUF)
    assert status == 200
    for bad in (pser.encode_import_value_request("i", "fare", [1], [101]),
                pser.encode_import_value_request("i", "f", [1], [5]),
                pser.encode_import_request("i", "f", [1, 2], [1]),
                pser.encode_import_request("i", "nope", [1], [1]),
                pser.encode_import_request("i", "f", [1] * 5001,
                                           range(5001)),  # 413
                b"\x0a\x01"):  # a truncated message
        for path in ("/index/i/field/f/import",
                     "/index/i/field/fare/import-value"):
            _same(servers, "POST", path, bad, PROTOBUF)
    _same(servers, "POST", "/index/i/field/f/import?remote=true",
          pser.encode_import_request("i", "f", [4] * 5001, range(5001)),
          PROTOBUF)
    for pql in (b"Count(Row(f=1)) Count(Row(f=4)) Row(f=2)",
                b'Sum(field="fare") Min(field="fare") Max(field="fare")'):
        _same(servers, "POST", "/index/i/query", pql)


def _roaring(ids) -> RoaringBitmap:
    b = RoaringBitmap()
    b.add_ids(np.asarray(ids, np.uint64))
    return b


def test_import_roaring_matches_reference(servers):
    rng = np.random.default_rng(5)
    pos = np.unique(rng.integers(0, SW, 3000)).astype(np.uint64)
    own = _roaring((np.uint64(1) << np.uint64(20)) + pos[:1500])
    upstream = _roaring(np.concatenate([
        (np.uint64(4) << np.uint64(20)) + pos[1500:],
        (np.uint64(2) << np.uint64(20)) + pos[:10]]))
    assert serialize_pilosa(upstream) == \
        jres_format().serialize_pilosa(_jroaring(upstream))
    for path, body in (
            ("/index/i/field/f/import-roaring/1", serialize(own)),
            ("/index/i/field/f/import-roaring/2", serialize_pilosa(upstream)),
            ("/index/i/field/f/import-roaring/2", serialize_pilosa(upstream)),
            ("/index/i/field/f/import-roaring/5", serialize(own)),  # new
            ("/index/i/field/f/import-roaring/0", b"\x3c\x30\x00\x00junk"),
            ("/index/i/field/f/import-roaring/0", b"junkjunk"),
            ("/index/i/field/nope/import-roaring/0", serialize(own)),
            ("/index/nope/field/f/import-roaring/0", serialize(own)),
            ("/index/i/field/f/import-roaring/0",
             serialize(_roaring(np.arange(5001, dtype=np.uint64)))),
            ("/index/i/field/f/import-roaring/0?remote=true",
             serialize(_roaring(np.arange(5001, dtype=np.uint64)))),
    ):
        _same(servers, "POST", path, body, "application/octet-stream")
    for pql in (b"Count(Row(f=1)) Count(Row(f=4)) Count(Row(f=2))",
                b"Row(f=4) Count(All()) TopN(f)"):
        _same(servers, "POST", "/index/i/query", pql)
    for path in ("/export?index=i&field=f", "/internal/shards/max",
                 "/schema"):
        _same(servers, "GET", path)


def jres_format():
    import pilosa_tpu.roaring.format as jformat

    return jformat


def _jroaring(b: RoaringBitmap):
    from pilosa_tpu.roaring.bitmap import RoaringBitmap as JRoaringBitmap

    out = JRoaringBitmap()
    out.add_ids(b.to_ids())
    return out


def test_schema_routes_match_reference(servers):
    for path in ("/schema", "/internal/schema", "/version",
                 "/internal/shards/max", "/index/i", "/index/u",
                 "/index/nope", "/export?index=i&field=f",
                 "/export?index=i&field=tag", "/export?index=i&field=fare",
                 "/export?index=u&field=seg", "/export?index=i",
                 "/export?index=i&field=nope", "/export?index=nope&field=f",
                 "/status"):
        _same(servers, "GET", path)
    _same(servers, "POST", "/index/e", b"{}")
    _same(servers, "POST", "/index/e/field/x", b"{}")
    for path in ("/export?index=e&field=x", "/internal/shards/max",
                 "/index/e"):
        _same(servers, "GET", path)


def test_info_matches_reference_but_devices(servers):
    jinfo = json.loads(_req(servers[0], "GET", "/info")[1])
    pinfo = json.loads(_req(servers[1], "GET", "/info")[1])
    assert {k: v for k, v in pinfo.items() if k != "devices"} == \
        {k: v for k, v in jinfo.items() if k != "devices"}
    # the port's one device is its torch device, not a JAX device list
    assert pinfo["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu"}]
    assert servers[2].api.info()["devices"] == pinfo["devices"]


def _families(text: str) -> dict:
    """family -> [help, type, value] of a Prometheus page (untagged
    series only)."""
    out: dict = {}
    for line in text.splitlines():
        m = re.match(r"# (HELP|TYPE) (\S+) (.*)$", line)
        if m:
            out.setdefault(m.group(2), [None, None, None])[
                0 if m.group(1) == "HELP" else 1] = m.group(3)
            continue
        name, value = line.split(" ")
        if "{" not in name:
            out.setdefault(name, [None, None, None])[2] = float(value)
    return out


# series whose value is not a function of the requests: commit-group
# timing, and process-wide counters other tests also move
TIMING = ("pilosa_tpu_wal_groups_total", "pilosa_tpu_wal_fsyncs_total",
          "pilosa_tpu_wal_group_max_ops", "pilosa_tpu_wal_segments",
          "pilosa_tpu_wal_checkpoints_total")


# the host-path kernel and merge-kernel counters and the mesh's
# reduction counters: one set a process, moved by every test's bitmaps
# and meshes, so compared by their movement over the test's requests
PROCESS_WIDE = ("pilosa_tpu_hostpath_", "pilosa_tpu_ingest_merge_",
                "pilosa_tpu_dist_reduce_")


def test_metrics_families_match_reference(servers):
    before = [_families(_req(s, "GET", "/metrics")[1].decode())
              for s in servers[:2]]
    for path, body in (("/index/i/query", b"Count(Row(f=1)) Row(g=7)"),
                       ("/index/i/query", b"Set(9, f=1) Count(Row(f=1))"),
                       ("/index/i/field/f/import",
                        b'{"rows": [2, 3], "columns": [4, 5]}'),
                       ("/index/i/field/f/import",
                        json.dumps({"rows": [4] * 200, "columns": list(
                            range(0, 2000, 10))}).encode()),
                       ("/index/i/field/fare/import-value",
                        b'{"columns": [1, 3, 70000], "values": [9, 1, 4]}'),
                       ("/index/i/query", b"TopN(f) Count(Row(f=2))")):
        _same(servers, "POST", path, body)
    jstatus, jpage = _req(servers[0], "GET", "/metrics")
    pstatus, ppage = _req(servers[1], "GET", "/metrics")
    assert jstatus == pstatus == 200
    jf, pf = _families(jpage.decode()), _families(ppage.decode())
    for name in ("pilosa_tpu_residency_hits_total",
                 "pilosa_tpu_residency_tier_passes_total",
                 "pilosa_tpu_wal_appended_ops_total",
                 "pilosa_tpu_wal_commit_recoveries_total",
                 "pilosa_tpu_storage_degraded",
                 "pilosa_tpu_scrub_passes_total",
                 "pilosa_tpu_hostpath_kernel_calls_total",
                 "pilosa_tpu_hostpath_dense_decodes_total",
                 "pilosa_tpu_ingest_merge_kernel_calls_total",
                 "pilosa_tpu_ingest_merge_loop_fallbacks_total",
                 "pilosa_tpu_ingest_merge_probe_calls_total"):
        assert name in pf, name
    # the two blocks in the reference's order
    assert [n for n in pf if n.startswith(PROCESS_WIDE)] == \
        [n for n in jf if n.startswith(PROCESS_WIDE)]
    for name, (help_, type_, value) in pf.items():
        assert name in jf, name
        assert (help_, type_) == tuple(jf[name][:2]), name
        if name in TIMING or name.startswith("pilosa_tpu_integrity_"):
            continue
        if name.startswith(PROCESS_WIDE):
            assert value - before[1][name][2] == \
                jf[name][2] - before[0][name][2], name
            continue
        assert value == jf[name][2], name
    assert pf["pilosa_tpu_wal_appended_ops_total"][2] > 0
    moved = {n: pf[n][2] - before[1][n][2] for n in pf
             if n.startswith(PROCESS_WIDE)}
    assert moved["pilosa_tpu_hostpath_dense_decodes_total"] > 0
    assert moved["pilosa_tpu_ingest_merge_kernel_calls_total"] > 0
    assert moved["pilosa_tpu_ingest_merge_loop_fallbacks_total"] > 0
    assert moved["pilosa_tpu_ingest_merge_probe_calls_total"] > 0


def test_deletes_match_reference(servers):
    for method, path, body in (
            ("POST", "/index/i/query", b"Count(Row(f=1)) Row(f=2)"),
            ("DELETE", "/index/i/field/f", None),
            ("DELETE", "/index/i/field/f", None),           # 404
            ("DELETE", "/index/nope/field/f", None),        # 404
            ("GET", "/index/i", None),
            ("POST", "/index/i/query", b"Count(Row(f=1))"),  # unknown field
            ("POST", "/index/i/field/f", b"{}"),
            ("POST", "/index/i/query", b"Count(Row(f=1)) Row(f=2)"),
            ("DELETE", "/index/u", None),
            ("DELETE", "/index/u", None),                   # 404
            ("GET", "/index/u", None),
            ("POST", "/index/u/query", b'Row(seg="pro")'),
            ("POST", "/index/u", b'{"options": {"keys": true}}'),
            ("POST", "/index/u/field/seg", b'{"options": {"keys": true}}'),
            ("POST", "/index/u/query", b'Row(seg="pro") Count(All())'),
            ("GET", "/schema", None),
            ("GET", "/internal/shards/max", None)):
        _same(servers, method, path, body)


def test_delete_purges_every_residency_tier_and_heat(servers):
    """A deleted field leaves no entry in any tier of the port's cache
    and no heat; the field re-created under its name serves no old bit."""
    port = servers[2]
    base = servers[1]
    cache = port.holder.cache
    scope = port.holder.index("i").scope
    assert _req(base, "POST", "/index/i/query",
                b"Count(Row(f=1)) TopN(f) Count(Row(g=7))")[0] == 200
    assert cache.demote_field_stacks_to_host(scope, "i", "f")[0] > 0

    def keys_of(field):
        return [k for store in (cache._rows, cache._compressed, cache._host,
                                cache._updaters) for k in store
                if field in k[:5] and scope in k[:2]]

    assert keys_of("f") and keys_of("g")
    def heat_fields():
        return {r["field"] for r in pheat.global_heat().snapshot()["shards"]}

    assert "f" in heat_fields()
    assert _req(base, "DELETE", "/index/i/field/f")[0] == 200
    assert keys_of("f") == [] and keys_of("g")
    assert "f" not in heat_fields() and "g" in heat_fields()
    assert _req(base, "POST", "/index/i/field/f", b"{}")[0] == 200
    status, body = _req(base, "POST", "/index/i/query",
                        b"Count(Row(f=1)) Row(f=1) TopN(f)")
    assert (status, json.loads(body)["results"]) == (
        200, [0, {"attrs": {}, "columns": []}, []])


def test_prometheus_renderer_matches_reference():
    pairs = {"a_total": 3, "b": 1.5, "c": 1 << 40, "d_seconds": 0.000123}
    for sub in ("", "wal"):
        seen_p, seen_j = set(), set()
        assert pstats.prometheus_block(pairs, "p", sub, {"b": "bee"},
                                       seen_p) == \
            jstats.prometheus_block(pairs, "p", sub, {"b": "bee"}, seen_j)
        assert seen_p == seen_j
    assert pstats.prometheus_block({}, "p") == ""
    for v in ('a"b\\c\nd', 7):
        assert pstats.escape_label(v) == jstats.escape_label(v)
    tags = {"tenant": 'x"y', "a": 1}
    assert pstats._fmt_tags(tags) == jstats._fmt_tags(tags)
    assert pstats._fmt_tags(None) == jstats._fmt_tags(None) == ""


def test_wire_descriptor_is_the_reference_proto():
    assert (REPO / "pilosa_tpu_torch/wire/internal.proto").read_bytes() == \
        (REPO / "pilosa_tpu/wire/internal.proto").read_bytes()
    ref = jwire.pb2()
    assert ref is not None, "the reference's wire module did not build"
    assert wire.FILE_DESCRIPTOR == ref.DESCRIPTOR.serialized_pb
    p = wire.pb2()
    assert p.QueryResponse is not ref.QueryResponse
    assert p.QueryResponse.DESCRIPTOR.full_name == "pilosa_tpu.QueryResponse"


def test_wire_loads_beside_the_reference_without_protoc(tmp_path):
    """A process that has the reference's generated module registered in
    the default descriptor pool, and no protoc on PATH, builds the
    port's classes and encodes the same bytes."""
    assert jwire.pb2() is not None  # generated (with protoc) beforehand
    code = (
        "import shutil, sys\n"
        "assert shutil.which('protoc') is None\n"
        "import pilosa_tpu.wire.internal_pb2 as ref\n"
        "from pilosa_tpu_torch import wire\n"
        "p = wire.pb2()\n"
        "a = p.QueryRequest(query='Row(f=1)', shards=[1, 2]).SerializeToString()\n"
        "b = ref.QueryRequest(query='Row(f=1)', shards=[1, 2]).SerializeToString()\n"
        "assert a == b\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PATH"}
    env["PATH"] = str(tmp_path)  # an empty directory: no protoc
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_serializer_matches_reference_on_every_result_type():
    from pilosa_tpu.executor import result as jresult
    from pilosa_tpu_torch.executor import result as presult

    words = np.zeros(32768, np.uint32)
    words[[0, 5, 9000]] = [1 << 3, 0x80000001, 7]

    def results(m):
        row = m.RowResult({0: words, 2: words}, attrs={"a": 1, "b": "x",
                                                       "c": True, "d": 2.5})
        keyed = m.RowResult({0: words}, keys=["k1", "k2"])
        attrs_row = m.RowResult({1: words})
        attrs_row.column_attrs = [{"id": 5, "attrs": {"z": "q"}}]
        return [row, keyed, attrs_row, 7, True, False, None,
                m.ValCount(-3, 2), [m.Pair(1, 5), m.Pair(2, 3, key="k")],
                [m.GroupCount([{"field": "f", "rowID": 1},
                               {"field": "s", "rowKey": "a"}], 4, sum=9),
                 m.GroupCount([{"field": "f", "rowID": 2}], 1)],
                ["a", "b"], [1, 2, 3], []]

    got = pser.encode_results(results(presult))
    assert got == jser.encode_results(results(jresult))
    assert pser.decode_results_json(got) == jser.decode_results_json(got)
    assert pser.encode_error("boom") == jser.encode_error("boom")
    assert pser.decode_results_json(pser.encode_error("boom")) == \
        {"error": "boom"}
    q = jwire.pb2().QueryRequest(query="Row(f=1)", shards=[3],
                                 column_attrs=True, remote=True,
                                 exclude_columns=True).SerializeToString()
    assert pser.decode_query_request(q) == jser.decode_query_request(q)
    imp = jser.encode_import_request("i", "t", [1, 2], [3, 4],
                                     timestamps=["2019-01-01T00:00", None])
    for a, b in zip(pser.decode_import_request(imp),
                    jser.decode_import_request(imp)):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    iv = jser.encode_import_value_request("i", "v", [1, 2], [-5, 9],
                                          clear=True)
    for a, b in zip(pser.decode_import_value_request(iv),
                    jser.decode_import_value_request(iv)):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_protobuf_without_runtime_is_406_and_json_goes_on(servers,
                                                          monkeypatch):
    monkeypatch.setattr(wire, "_pb2", None)
    monkeypatch.setattr(wire, "_tried", True)
    base = servers[1]
    for path, body, ctype, accept in (
            ("/index/i/query", b"Count(Row(f=1))", "text/plain", PROTOBUF),
            ("/index/i/query", b"\x0a\x00", PROTOBUF, None),
            ("/index/i/field/f/import", b"\x0a\x00", PROTOBUF, None),
            ("/index/i/field/fare/import-value", b"\x0a\x00", PROTOBUF,
             None)):
        status, resp = _req(base, "POST", path, body, ctype, accept)
        assert (status, json.loads(resp)) == (
            406, {"error": "protobuf wire format unavailable"})
    status, resp = _req(base, "POST", "/index/i/query", b"Count(Row(f=9))")
    assert (status, json.loads(resp)) == (200, {"results": [0]})

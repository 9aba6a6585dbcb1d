"""The query cost plane against the reference: PQL PROFILE trees, the
tenant ledger, the heat map and the slow-query ring, a reference API
server beside a port Server on copies of one 4-shard dir.

Compared exactly: the shape of every ``?profile=true`` tree and every
count in it that does not depend on time (``wallMs`` and ``deviceMs``
are clock readings: only their sign is compared); the ledger's columns
but ``wall_ms`` and ``device_ms`` (times); ``/debug/heatmap`` rows; the
slow-query ring's size and total; the 400s of ``/debug/tenants``; the
kill switch. Named differences, each asserted: a plan with shift or
BSI-comparison steps launches them before its Count (one more
``dispatches`` than the reference's one fused program); a host-tier hit
moves the compact blocks and their index to the card (the bytes that
cross), where the reference notes the dense size. The operand memo
answers a repeated query in both packages alike: ``operandMemoHit`` and
the whole tree are equal.
"""

import json
import re

import pytest

import pilosa_tpu.storage.residency as jres
import pilosa_tpu.utils.cost as jcost
import pilosa_tpu_torch.utils.cost as pcost
from torch_serving_helpers import Pair, fresh_planes, seed_dir

TIMES = ("wallMs", "deviceMs")


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    root = tmp_path_factory.mktemp("cost") / "seed"
    return root, seed_dir(root)


@pytest.fixture
def pair(seed, tmp_path):
    with fresh_planes():
        p = Pair(seed[0], tmp_path)
        try:
            yield p
        finally:
            p.close()


def _untimed(tree):
    """The tree with each time replaced by whether it is above 0."""
    if isinstance(tree, dict):
        return {k: (v > 0 if k in TIMES else _untimed(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_untimed(v) for v in tree]
    return tree


def _profiled(pair, pkg, pql, headers=None):
    status, _, body = pair.get(pkg, "POST", "/index/i/query?profile=true",
                               pql.encode(), headers)
    assert status == 200, body
    return json.loads(body)


# (PQL, the extra launches of the port's plan: its steps)
SHAPES = [
    ("Count(Intersect(Row(f=1), Row(g=7)))", 0),
    ("Row(f=2)", 0),
    ("Union(Row(f=1), Row(f=3))", 0),
    ("Count(Row(f=1))", 0),
    ("Count(Difference(Row(f=3), Row(f=1)))", 0),
    ("Count(Shift(Row(f=1), n=1))", 1),
    ("Count(Range(fare < 30))", 1),
]


def test_profile_trees_match_reference(pair):
    for pql, steps in SHAPES:
        out = {pkg: _profiled(pair, pkg, pql) for pkg in ("jax", "port")}
        assert out["port"]["results"] == out["jax"]["results"], pql
        j = _untimed(out["jax"]["profile"])
        p = _untimed(out["port"]["profile"])
        if steps:
            (pc,), (jc,) = p["calls"], j["calls"]
            assert pc["dispatches"] == jc["dispatches"] + steps, pql
            assert p["totals"]["dispatches"] == \
                j["totals"]["dispatches"] + steps
            pc["dispatches"] = jc["dispatches"]
            p["totals"]["dispatches"] = j["totals"]["dispatches"]
        assert p == j, pql
        call = p["calls"][0]
        assert call["wallMs"] and call["deviceMs"] and call["shards"] == 4
    # the second time: the plan cache hits, the leaves are resident
    out = {pkg: _profiled(pair, pkg, "Count(Row(f=1))")
           for pkg in ("jax", "port")}
    p, j = _untimed(out["port"]["profile"]), _untimed(out["jax"]["profile"])
    assert p["calls"][0]["planCacheHit"] is j["calls"][0]["planCacheHit"] \
        is True
    assert p["totals"]["containers"] == j["totals"]["containers"] == {
        "array": 0, "bitmap": 0, "run": 0}
    # the operand memo answers in both packages: no leaf records, no
    # residency lookups
    assert p == j
    assert p["calls"][0]["operandMemoHit"] is True
    assert "leaves" not in p["calls"][0]
    assert p["totals"]["rowCacheHits"] == 0


def test_profile_rows_and_refusals_match_reference(pair):
    out = {pkg: _profiled(pair, pkg, "Row(f=1) Count(Row(g=7))")
           for pkg in ("jax", "port")}
    assert _untimed(out["port"]) == _untimed(out["jax"])
    assert out["port"]["profile"]["calls"][0]["rowsMaterialized"] > 0
    # no profile without the parameter, none on an error, and a 400 for
    # a protobuf answer
    body = pair.same("POST", "/index/i/query", b"Count(Row(f=1))")
    assert b"profile" not in body
    body = pair.same("POST", "/index/i/query?profile=true",
                     b"Count(Row(nosuch=1))")
    assert b"profile" not in body
    pair.same("POST", "/index/i/query?profile=true", b"Count(Row(f=1))",
              {"Accept": "application/x-protobuf"})


def test_profile_of_a_dedupe_and_a_cache_hit(seed, tmp_path):
    with fresh_planes(cache_bytes=1 << 20):
        pair = Pair(seed[0], tmp_path, result_cache_bytes=1 << 20)
        try:
            q = "Count(Row(f=1))"
            for _ in range(2):
                out = {pkg: _profiled(pair, pkg, q)
                       for pkg in ("jax", "port")}
            # the fill, then a hit: the stub tree of a cached answer
            assert _untimed(out["port"]) == _untimed(out["jax"])
            assert out["port"]["profile"]["resultCacheHit"] is True
            assert out["port"]["profile"]["calls"] == []
        finally:
            pair.close()


def test_cost_kill_switch_matches_reference(pair):
    for mod in (jcost, pcost):
        mod.set_cost_enabled(False)
    try:
        out = {pkg: _profiled(pair, pkg, "Count(Row(f=1))")
               for pkg in ("jax", "port")}
        assert out["port"] == out["jax"]
        assert out["port"]["profile"] == {
            "disabled": True, "reason": "cost plane is disabled on this node"}
        for api in pair.apis().values():
            assert api.cost.snapshot() == []
    finally:
        for mod in (jcost, pcost):
            mod.set_cost_enabled(True)
    assert pair.json("port", "/debug/heatmap")["shards"] == []


def _ledger(pair, pkg, path="/debug/tenants?k=2&by=queries"):
    out = pair.json(pkg, path)
    for key in ("tenants", "top"):
        for row in out[key]:
            for col in ("wall_ms", "device_ms"):  # times
                row[col] = row[col] > 0
    for col in ("wall_ms_total", "device_ms_total"):
        out["totals"][col] = out["totals"][col] > 0
    return out


def test_tenant_ledger_matches_reference(pair):
    for tenant, n in (("acme", 4), ("beta", 2)):
        for _ in range(n):
            pair.same("POST", "/index/i/query", b"Count(Row(f=1)) Row(g=7)",
                      {"X-Pilosa-Tenant": tenant})
    pair.same("POST", "/index/i/field/f/import",
              b'{"rows": [5, 5, 5], "columns": [1, 2, 3]}',
              {"X-Pilosa-Tenant": "loader"})
    pair.same("POST", "/index/i/field/fare/import-value",
              b'{"columns": [1, 2], "values": [3, 4]}',
              {"X-Pilosa-Tenant": "loader"})
    pair.same("POST", "/index/i/query", b"Count(Row(nosuch=1))",
              {"X-Pilosa-Tenant": "beta"})
    p, j = _ledger(pair, "port"), _ledger(pair, "jax")
    assert p == j
    rows = {r["tenant"]: r for r in p["tenants"]}
    assert rows["acme"]["queries"] == 4 and rows["acme"]["egress_bytes"] > 0
    assert rows["loader"]["ingest_rows"] == 5
    assert [r["tenant"] for r in p["top"]] == ["acme", "beta"]
    for path in ("/debug/tenants?by=bogus", "/debug/tenants?k=0",
                 "/debug/tenants?k=x", "/debug/heatmap?k=-1",
                 "/debug/rescache?k=0"):
        pair.same("GET", path)
    pages = {}
    for pkg in ("jax", "port"):
        page = pair.get(pkg, "GET", "/metrics")[2].decode()
        pages[pkg] = sorted(
            line for line in page.splitlines()
            if re.match(r"(# \w+ )?pilosa_tpu_tenant_", line)
            and "wall_ms" not in line and "device_ms" not in line)
    assert pages["port"] == pages["jax"]


def test_heatmap_matches_reference(pair):
    for q in (b"Count(Row(f=1))", b"Count(Row(f=1))", b"Row(g=7)",
              b'Sum(field="fare")', b"Set(9, f=2)"):
        pair.same("POST", "/index/i/query", q)
    pair.same("POST", "/index/i/field/f/import",
              b'{"rows": [3], "columns": [4]}')

    def rows(pkg, path):
        out = pair.json(pkg, path)
        for r in out["shards"]:
            r.pop("scope")
        out.pop("stackedBytesByField", None)
        return out

    for path in ("/debug/heatmap", "/debug/heatmap?k=0",
                 "/debug/heatmap?k=3"):
        p, j = rows("port", path), rows("jax", path)
        assert p == j, path
    assert len(rows("port", "/debug/heatmap?k=0")["shards"]) > 3
    tiered = pair.json("port", "/debug/heatmap?tier=true")
    assert {r["tier"] for r in tiered["shards"]} <= {
        "resident", "compressed", "host", "cold"}
    assert tiered["tiering"] == {"enabled": False}
    jt = pair.json("jax", "/debug/heatmap?tier=true")
    assert sorted(tiered) == sorted(jt)
    pages = {}
    for pkg in ("jax", "port"):
        page = pair.get(pkg, "GET", "/metrics")[2].decode()
        pages[pkg] = sorted(line.split("{scope=")[0] for line in
                            page.splitlines() if "pilosa_tpu_heat_" in line)
    assert pages["port"] == pages["jax"]


def test_host_tier_hit_notes_the_bytes_that_cross(pair):
    """A profiled Count whose leaf waits in the host tier. A sparse
    leaf: the port uploads its nonzero blocks and their index and
    scatters them with K11, and notes those bytes; the reference notes
    the dense leaf's. A leaf with most blocks set goes up whole in both,
    the same bytes."""
    sw = 1 << 20
    cols = [s * sw + k for s in range(4) for k in (3, 40, 900)]
    pair.same("POST", "/index/i/field/f/import", json.dumps(
        {"rows": [5] * len(cols), "columns": cols}).encode())
    pcache = pair.server.holder.cache
    scope = pair.server.holder.index("i").scope
    jscope = pair.jh.index("i").scope
    dense = 4 * (1 << 15) * 4  # 4 shards of 32768 words
    for row, sparse in ((5, True), (1, False)):
        q = f"Count(Row(f={row}))"
        pair.same("POST", "/index/i/query", q.encode())
        assert pcache.demote_field_stacks_to_host(scope, "i", "f")[0] >= 1
        assert jres.global_row_cache().demote_field_stacks_to_host(
            jscope, "i", "f")[0] >= 1
        # the leaf's key: ("stack", scope, index, field, views, row, block)
        (hentry,) = [e for k, e in pcache._host.items() if k[5] == row]
        out = {pkg: _profiled(pair, pkg, q + " ")
               for pkg in ("jax", "port")}
        assert out["port"]["results"] == out["jax"]["results"]
        pt = out["port"]["profile"]["totals"]
        jt = out["jax"]["profile"]["totals"]
        assert jt["bytesMoved"] == dense
        assert pt["rowCacheHits"] == jt["rowCacheHits"] == 1
        if sparse:
            compact = int(hentry.blocks.nbytes + hentry.idx.nbytes)
            assert pt["bytesMoved"] == compact < dense
        else:
            assert hentry.idx is None
            assert pt["bytesMoved"] == dense
    assert pcache.metrics()["residency_host_hits"] == 2


def test_slow_query_ring_matches_reference(seed, tmp_path):
    with fresh_planes():
        pair = Pair(seed[0], tmp_path, slow_query_ring=3,
                    long_query_time=1e-9)
        try:
            import collections

            pair.japi.long_queries = collections.deque(maxlen=3)
            pair.japi.long_query_time = 1e-9
            for i in range(5):
                pair.same("POST", "/index/i/query",
                          f"Count(Row(f={1 + i % 3}))".encode())
            outs = {pkg: pair.json(pkg, "/debug/queries/slow")
                    for pkg in ("jax", "port")}
            for out in outs.values():
                for e in out["queries"]:
                    assert e.pop("seconds") > 0 and e.pop("at")
            assert outs["port"] == outs["jax"]
            assert outs["port"]["total"] == 5
            assert len(outs["port"]["queries"]) == 3
            assert pair.json("port", "/debug/long-queries") == \
                pair.json("port", "/debug/queries/slow") | {
                    "queries": pair.json("port", "/debug/long-queries")[
                        "queries"]}
        finally:
            pair.close()


def test_debug_vars_blocks_match_reference(pair):
    for q in (b"Count(Row(f=1))", b"Set(3, f=1)", b"Row(g=7)"):
        pair.same("POST", "/index/i/query", q)
    j, p = pair.json("jax", "/debug/vars"), pair.json("port", "/debug/vars")
    for block in ("serving_pipeline", "qos", "result_cache", "slo",
                  "observability"):
        assert p[block] == j[block], block
    for block in ("tenants", "heat", "serving_fastlane", "integrity",
                  "residency_tiering"):
        assert sorted(p[block]) == sorted(j[block]), block
    # the reference's WAL block adds the CDC plane's series
    assert set(p["durability"]) < set(j["durability"])
    assert set(p) <= set(j)
    assert sorted(p["counters"]) == sorted(j["counters"])
    assert p["counters"] == j["counters"]
    assert sorted(p["distributions"]) == sorted(j["distributions"])

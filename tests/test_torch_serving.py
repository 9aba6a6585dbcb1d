"""The serving pipeline and the result cache against the reference: a
reference API server and a port Server on copies of one 4-shard dir,
the same requests, byte-identical answers.

Covered: concurrent clients over ``DRYRUN_QUERY_SHAPES`` answer the
serial bytes with the pipeline on and off (``serve_pipelined``);
identical wavemates submit once (both packages count the same dedupes);
a bad query does not poison its wave, and an error reaches every deduped
request; the wave counters on ``/metrics``; the result cache's hits,
fills and misses, and its invalidation by every write kind (Set, Clear,
ClearRow, Store, import, import-value, import-roaring, delete field and
delete index), a write to another field keeping the entry;
``/debug/rescache`` keys and entries, and the ``result_cache_*``
families. Waves are formed with ``Plug`` (the dispatcher held in its
first submit until the burst is queued), never with sleeps.
"""

import json
import threading

import numpy as np
import pytest

from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu_torch.roaring import RoaringBitmap
from pilosa_tpu_torch.roaring.format import serialize
from torch_serving_helpers import Pair, Plug, fresh_planes, run_threads, \
    seed_dir

SW = 1 << 20


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving") / "seed"
    return root, seed_dir(root)


@pytest.fixture
def pair(seed, tmp_path):
    with fresh_planes():
        p = Pair(seed[0], tmp_path)
        try:
            yield p
        finally:
            p.close()


@pytest.fixture
def cache_pair(seed, tmp_path):
    with fresh_planes(cache_bytes=1 << 20):
        p = Pair(seed[0], tmp_path, result_cache_bytes=1 << 20)
        try:
            yield p
        finally:
            p.close()


def _corpus(probe: int) -> list[str]:
    return [q.format(probe=probe) for q in DRYRUN_QUERY_SHAPES]


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipeline", "direct"])
def test_concurrent_clients_answer_the_serial_bytes(pair, seed, pipelined):
    for api in pair.apis().values():
        api.serve_pipelined = pipelined
    corpus = _corpus(seed[1])
    serial = {q: pair.same("POST", "/index/i/query", q.encode())
              for q in corpus}
    for pkg in ("jax", "port"):
        def client(k, pkg=pkg):
            out = []
            for q in corpus[k:] + corpus[:k]:
                status, _, body = pair.get(pkg, "POST", "/index/i/query",
                                           q.encode())
                out.append((q, status, body))
            return out

        for res in run_threads([lambda k=k: client(5 * k) for k in range(4)]):
            assert not isinstance(res, BaseException), res
            for q, status, body in res:
                assert (status, body) == (200, serial[q]), (pkg, q)
    waves = [api.pipeline_metrics()["waves"] for api in pair.apis().values()]
    if pipelined:
        assert all(w > 0 for w in waves)
    else:
        assert waves == [0, 0]
        assert pair.papi._pipeline is None


def _plugged(pair, pkg, queries: list[str]):
    """One plug request, then ``queries`` queued behind it as one wave:
    [(status, body)] of the burst, and the submits the executor saw."""
    api = pair.apis()[pkg]

    def post(q):
        return pair.get(pkg, "POST", "/index/i/query", q.encode())

    with Plug(api, len(queries)) as plug:
        first = []
        plug_thread = threading.Thread(
            target=lambda: first.append(post("Count(Row(g=7))")))
        plug_thread.start()
        waiter = None
        try:
            assert plug.entered.wait(30)
            waiter = threading.Thread(target=plug.wait_queued)
            waiter.start()
            burst = run_threads([lambda q=q: post(q) for q in queries])
        finally:
            plug.release.set()
            if waiter is not None:
                waiter.join(60)
            plug_thread.join(60)
    assert first and first[0][0] == 200
    return [(r[0], r[2]) for r in burst], plug.submits


def test_identical_wavemates_submit_once(pair):
    q = "Count(Row(f=1))"
    serial = pair.same("POST", "/index/i/query", q.encode())
    seen = {}
    for pkg in ("jax", "port"):
        burst, submits = _plugged(pair, pkg, [q] * 8)
        assert burst == [(200, serial)] * 8, pkg
        m = pair.apis()[pkg].pipeline_metrics()
        seen[pkg] = (submits, m["deduped"])
    # the plug, then the burst's one submit; 7 wavemates rode it
    assert seen["port"] == seen["jax"] == (2, 7)


def test_bad_query_does_not_poison_its_wave(pair):
    queries = (["Count(Row(f=1))"] * 3 + ["Count(Row(nosuch=1))"]
               + ["Count(Row(f=2))"] * 3)
    got = {pkg: _plugged(pair, pkg, queries)[0] for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    for q, (status, body) in zip(queries, got["port"]):
        if "nosuch" in q:
            assert status == 400 and b"nosuch" in body
        else:
            assert (status, body) == (200, pair.same(
                "POST", "/index/i/query", q.encode()))
    for api in pair.apis().values():
        assert api.pipeline_metrics()["coalesced"] >= len(queries)


def test_error_reaches_every_deduped_request(pair):
    """Identical requests failing at submit (an unknown field) each get
    the 400: a failed submit registers no leader, so none is deduped, in
    both packages; the pipeline serves on."""
    got = {pkg: _plugged(pair, pkg, ["Count(Row(ghost=1))"] * 6)[0]
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert [s for s, _ in got["port"]] == [400] * 6
    assert len({b for _, b in got["port"]}) == 1
    assert (pair.papi.pipeline_metrics()["deduped"]
            == pair.japi.pipeline_metrics()["deduped"] == 0)
    pair.same("POST", "/index/i/query", b"Count(Row(f=1))")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_shared_deferred_resolves_once_and_reraises_per_caller(pkg):
    """A deduped wave's shared handle: the first resolver runs the
    Deferred (not safe to resolve twice at once), every caller gets the
    value, or its own copy of the error."""
    if pkg == "jax":
        from pilosa_tpu.executor.executor import Deferred
        from pilosa_tpu.server.pipeline import _SharedDeferred
    else:
        from pilosa_tpu_torch.executor.executor import Deferred
        from pilosa_tpu_torch.server.pipeline import _SharedDeferred
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("launch failed")

    shared = _SharedDeferred(Deferred(boom))
    errs = run_threads([lambda: shared.result() for _ in range(6)])
    assert calls == [1]
    assert all(isinstance(e, ValueError) and str(e) == "launch failed"
               for e in errs)
    assert len({id(e) for e in errs}) == 6
    ok = _SharedDeferred(Deferred(lambda: calls.append(2) or 42))
    assert run_threads([ok.result] * 4) == [42] * 4
    assert calls == [1, 2]


def _families(text: str) -> dict:
    """family -> [help, type, value] of a Prometheus page (untagged
    series only)."""
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("# "):
            kind, name, rest = line[2:].split(" ", 2)
            out.setdefault(name, [None, None, None])[
                0 if kind == "HELP" else 1] = rest
            continue
        name, value = line.rsplit(" ", 1)
        if "{" not in name:
            out.setdefault(name, [None, None, None])[2] = float(value)
    return out


def test_wave_counters_on_metrics(pair):
    for pkg in ("jax", "port"):
        _plugged(pair, pkg, ["Count(Row(f=1))"] * 4 + ["Count(Row(f=2))"])
    pages = {pkg: _families(pair.get(pkg, "GET", "/metrics")[2].decode())
             for pkg in ("jax", "port")}
    for name in ("pilosa_tpu_serving_waves_total",
                 "pilosa_tpu_serving_coalesced_requests_total",
                 "pilosa_tpu_serving_deduped_requests_total"):
        assert pages["port"][name] == pages["jax"][name], name
    assert pages["port"]["pilosa_tpu_serving_deduped_requests_total"][2] == 3
    for pkg in ("jax", "port"):
        vars_ = pair.json(pkg, "/debug/vars")["serving_pipeline"]
        assert vars_ == {"waves": 2, "coalesced": 5, "deduped": 3}, pkg


# ----------------------------------------------------------- result cache


def _cache_state(api) -> dict:
    m = api.rescache_metrics()
    return {k: m[k] for k in ("result_cache_entries", "result_cache_hits_total",
                              "result_cache_misses_total",
                              "result_cache_fills_total")}


def test_result_cache_hits_match_reference(cache_pair):
    pair = cache_pair
    reads = ["Count(Row(f=1))", "Row(g=7)", 'Sum(field="fare")',
             "TopN(f, n=2)", "Rows(f)", "Count(Row(f=1))", "Row(g=7)",
             "  Count(Row(f=1))", "Options(Count(Row(f=1)), shards=[0])"]
    for q in reads * 2:
        pair.same("POST", "/index/i/query", q.encode())
    states = {pkg: _cache_state(api) for pkg, api in pair.apis().items()}
    assert states["port"] == states["jax"]
    # Rows(f) is not coalescable: never filled, never a miss; the
    # trimmed repeat is a hit
    assert states["port"]["result_cache_fills_total"] == 5
    ins = {pkg: pair.json(pkg, "/debug/rescache?k=50")
           for pkg in ("jax", "port")}
    assert sorted(ins["port"]) == sorted(ins["jax"])
    for pkg in ins:
        for row in ins[pkg]["entries"]:
            # an entry's bytes count its scope, the holder's data dir
            # path, which differs between the two copies
            row["bytes"] -= len(row.pop("scope"))
            for k in ("ageSeconds", "score"):  # clock-dependent
                row.pop(k)
        ins[pkg]["entries"].sort(key=lambda r: r["pql"])
    assert ins["port"]["entries"] == ins["jax"]["entries"]
    assert ins["port"]["enabled"] is True
    pages = {pkg: _families(pair.get(pkg, "GET", "/metrics")[2].decode())
             for pkg in ("jax", "port")}
    fams = [n for n in pages["jax"] if n.startswith("pilosa_tpu_result_cache")]
    assert len(fams) == 11
    for name in fams:
        want = pages["jax"][name]
        if name == "pilosa_tpu_result_cache_bytes":
            # one more byte an entry: "port" is a letter longer than "jax"
            want = want[:2] + [want[2] + ins["port"]["result_cache_entries"]]
        assert pages["port"][name] == want, name


def _roaring_body(rows, cols) -> bytes:
    bm = RoaringBitmap()
    bm.add_ids((np.asarray(rows, np.uint64) << np.uint64(20))
               + np.asarray(cols, np.uint64))
    return serialize(bm)


# (write request, the read whose cached answer it must change)
WRITES = {
    "set": (("POST", "/index/i/query", b"Set(123, f=1)"),
            "Count(Row(f=1))"),
    "clear": (("POST", "/index/i/query", b"Clear({probe}, f=1)"),
              "Count(Row(f=1))"),
    "clear_row": (("POST", "/index/i/query", b"ClearRow(f=2)"),
                  "Count(Row(f=2))"),
    "store": (("POST", "/index/i/query", b"Store(Row(g=7), f=3)"),
              "Count(Row(f=3))"),
    "import": (("POST", "/index/i/field/f/import",
                b'{"rows": [1, 1], "columns": [5, 2097157]}'),
               "Count(Row(f=1))"),
    "import_value": (("POST", "/index/i/field/fare/import-value",
                      b'{"columns": [1, 9], "values": [100, 100]}'),
                     'Sum(field="fare")'),
    "import_roaring": (("POST", "/index/i/field/f/import-roaring/0",
                        _roaring_body([1, 1], [11, 12])),
                       "Count(Row(f=1))"),
    "delete_field": (("DELETE", "/index/i/field/g", None),
                     "Count(Row(g=7))"),
    "delete_index": (("DELETE", "/index/i", None), "Count(Row(f=1))"),
}


@pytest.mark.parametrize("kind", sorted(WRITES))
def test_result_cache_invalidated_by_each_write(cache_pair, seed, kind):
    pair = cache_pair
    (method, path, body), read = WRITES[kind]
    if body is not None:
        body = body.replace(b"{probe}", str(seed[1]).encode())
    other = "Count(Row(g=7))" if "g=" not in read else "Count(Row(f=1))"
    before = pair.same("POST", "/index/i/query", read.encode())
    pair.same("POST", "/index/i/query", other.encode())
    assert pair.same("POST", "/index/i/query", read.encode()) == before
    hits = {pkg: api.rescache_metrics()["result_cache_hits_total"]
            for pkg, api in pair.apis().items()}
    assert hits["port"] == hits["jax"] == 1
    pair.same(method, path, body)
    after = pair.same("POST", "/index/i/query", read.encode())
    if kind.startswith("delete"):
        assert b"error" in after
    else:
        assert after != before  # the write's answer, never the cached one
    states = {pkg: api.rescache_metrics()
              for pkg, api in pair.apis().items()}
    for k in ("result_cache_hits_total", "result_cache_fills_total",
              "result_cache_entries", "result_cache_misses_total"):
        assert states["port"][k] == states["jax"][k], k
    assert states["port"]["result_cache_invalidations_total"] > 0
    if not kind.startswith("delete") and kind not in ("store",):
        # the other field's entry survived the write: a hit
        pair.same("POST", "/index/i/query", other.encode())
        assert (pair.papi.rescache_metrics()["result_cache_hits_total"]
                == pair.japi.rescache_metrics()["result_cache_hits_total"]
                == 2)


def test_result_cache_off_by_default(pair):
    for _ in range(2):
        pair.same("POST", "/index/i/query", b"Count(Row(f=1))")
    for pkg in ("jax", "port"):
        ins = pair.json(pkg, "/debug/rescache")
        assert ins["enabled"] is False and ins["entries"] == []
        assert ins["result_cache_hits_total"] == 0
    j = pair.json("jax", "/debug/rescache")
    p = pair.json("port", "/debug/rescache")
    assert json.dumps(sorted(p)) == json.dumps(sorted(j))

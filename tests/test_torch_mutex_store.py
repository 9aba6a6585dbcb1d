"""Mutex and bool fields, Store and ClearRow against the reference.

The same writes go through either package's executor or API on copies
of one small data dir; every answer is compared as ``result_to_json``
bytes, and the view directories, fragment files and sidecars byte for
byte after a clean close. The writes land on resident leaves, which must
equal a rebuild from the host rows afterwards, patched through K3 (its
plain version here) in one launch a request.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.executor import PQLError as JPQLError
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.api import ApiError as JApiError
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import Executor, PQLError, result_to_json
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API, ApiError
from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense

torch.set_num_threads(1)

W = 32768
SW = W * 32
SHARDS = 4
WINDOW = "from='2019-03-15T07:00', to='2020-03-15T07:00'"


def _outcome(fn):
    try:
        return fn()
    except (JPQLError, PQLError, JApiError, ApiError) as e:
        return (type(e).__name__, str(e))
    except Exception as e:  # the reference's bare ValueErrors
        return (type(e).__name__, str(e))


def _words(rng, density: float) -> np.ndarray:
    bits = rng.random(SHARDS * SW) < density
    return np.packbits(bits, bitorder="little").view("<u4")


def _mutex_rows(rng, shares) -> dict:
    """One row per column for the columns a draw puts below sum(shares):
    {row: words}, each column in one row at most."""
    draw = rng.random(SHARDS * SW)
    edges = np.cumsum(shares)
    out = {}
    for r, hi in enumerate(edges):
        lo = edges[r - 1] if r else 0.0
        out[r] = np.packbits((draw >= lo) & (draw < hi),
                             bitorder="little").view("<u4")
    return out


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    """Set field f, mutex field k (rows 0-3 over 8% of the columns), bool
    field b (about 3%), time field t with timestamped imports."""
    rng = np.random.default_rng(21)
    path = tmp_path_factory.mktemp("mutex") / "seed"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(
        h, {"f": {1: _words(rng, 0.01), 2: _words(rng, 0.004)},
            "k": _mutex_rows(rng, (0.04, 0.02, 0.012, 0.008)),
            "b": _mutex_rows(rng, (0.01, 0.02))},
        options={"k": FieldOptions(type="mutex"),
                 "b": FieldOptions(type="bool")},
        index="i")
    h.index("i").create_field("t", FieldOptions(type="time",
                                                time_quantum="YMDH"))
    cols = rng.integers(0, SHARDS * SW, 500)
    stamps = [f"2019-{m:02d}-11T0{m % 10}:00" for m in
              rng.integers(1, 13, cols.size)]
    API(h).import_bits("i", "t", rng.integers(0, 3, cols.size).tolist(),
                       cols.tolist(), timestamps=stamps)
    h.close()
    return path


def _open_pair(seed_dir, root):
    shutil.copytree(seed_dir, root / "jax")
    shutil.copytree(seed_dir, root / "port")
    return (jstorage.Holder(str(root / "jax")).open(),
            Holder(str(root / "port"), device="cpu").open())


@pytest.fixture
def pair(seed_dir, tmp_path):
    jh, ph = _open_pair(seed_dir, tmp_path)
    yield jh, ph
    jh.close()
    ph.close()


@pytest.fixture(scope="module")
def executors(seed_dir, tmp_path_factory):
    jh, ph = _open_pair(seed_dir, tmp_path_factory.mktemp("reads"))
    yield JExecutor(jh), Executor(ph, device="cpu")
    jh.close()
    ph.close()


def _same(jex, pex, pql):
    want = _outcome(lambda: json.dumps(j_result_to_json(
        jex.execute("i", pql))))
    got = _outcome(lambda: json.dumps(result_to_json(
        pex.execute("i", pql))))
    assert got == want, pql
    return got


def _view_files(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.sep + "views" + os.sep in rel:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _close_and_compare(jh, ph) -> None:
    jroot, proot = jh.data_dir, ph.data_dir
    jh.close()
    ph.close()
    want = _view_files(jroot)
    got = _view_files(proot)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def _resident(holder) -> dict:
    """Every resident [S, W] row leaf: (field, views, row) -> words."""
    return {(k[3], k[4], k[5]): a.numpy().view(np.uint32)
            for k, a in holder.cache._rows.items() if k[0] == "stack"}


def _check_resident(holder) -> None:
    """Each resident row leaf equals the OR of its views' host rows."""
    idx = holder.index("i")
    for (field, views, row), words in _resident(holder).items():
        fld = idx.field(field)
        want = np.zeros_like(words)
        for s in range(SHARDS):
            for vname in views:
                view = fld.view(vname) if fld else None
                frag = view.fragment(s) if view else None
                if frag is not None:
                    want[s] |= frag.row_words(row)
        assert np.array_equal(words, want), (field, row)


# --------------------------------------------------------- mutex and bool


SET_SCRIPTS = {
    "mutex moves": ["Set(5, k=1)", "Set(5, k=2)", "Set(5, k=2)",
                    f"Set({SW + 9}, k=0) Set({SW + 9}, k=3)", "Clear(5, k=2)",
                    "Clear(5, k=1)"],
    "bool": ["Set(7, b=true)", "Set(7, b=false)", "Set(7, b=1)",
             "Set(8, b=0) Clear(8, b=false)", "Set(9, b=2)",
             "Set(9, b=-1)"],
    "mutex rows past the seed": ["Set(11, k=9)", "Set(11, k=0)",
                                 f"Set({3 * SW + 1}, k=12)"],
}


@pytest.mark.parametrize("script", list(SET_SCRIPTS))
def test_mutex_and_bool_sets_match_reference(pair, script):
    """Sets move a column between rows of a mutex or bool field (a bool
    row past 1 is the reference's bare ValueError) on resident leaves;
    every answer, the leaves and the files match."""
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    reads = ["Row(k=1)", "Count(Row(k=2))", "Count(Row(k=0))",
             "Count(Row(k=3))", "Row(b=true)", "Count(Row(b=0))",
             "TopN(k)"]
    for pql in reads:
        _same(jex, pex, pql)
    for write in SET_SCRIPTS[script]:
        _same(jex, pex, write)
        for pql in reads:
            _same(jex, pex, pql)
        _check_resident(ph)
    _close_and_compare(jh, ph)


IMPORTS = {
    "moves": ("k", [2] * 6 + [0, 3], [0, SW, 2 * SW, 3 * SW, 5, 6, 7, 8]),
    "duplicates keep the last row": ("k", [1, 2, 3, 0, 2, 1],
                                     [40, 40, 41, 41, SW + 2, SW + 2]),
    "already in their rows": ("k", [0, 0], [0, 0]),
    "bool": ("b", [1, 0, 1, 1], [3, 3, SW + 4, 2 * SW]),
    "bool row 2": ("b", [1, 2], [3, 4]),
    "negative": ("k", [1, -1], [3, 4]),
    "clear": ("k", [0, 1], [0, 1]),
}


@pytest.mark.parametrize("case", list(IMPORTS))
def test_mutex_imports_match_reference(pair, case):
    """/import into a mutex or bool field through either API: the count
    it returns, the rows and the files (duplicate positions keep the last
    row, a bool row past 1 is refused before any write)."""
    jh, ph = pair
    field, rows, cols = IMPORTS[case]
    if case == "clear":
        rows, cols = [0, 1, 0], [int(c) for c in _cols_of(ph, "k", 0, 3)]
        kw = {"clear": True}
    else:
        kw = {}
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    reads = [f"Row({field}=0)", f"Row({field}=1)", f"Row({field}=2)",
             f"Count(Row({field}=3))"]
    for pql in reads:
        _same(jex, pex, pql)
    assert _outcome(lambda: API(ph).import_bits("i", field, rows, cols,
                                                **kw)) == \
        _outcome(lambda: JAPI(jh).import_bits("i", field, rows, cols, **kw))
    for pql in reads:
        _same(jex, pex, pql)
    _check_resident(ph)
    _close_and_compare(jh, ph)


def _cols_of(holder, field, row, n) -> list:
    frag = holder.index("i").field(field).view("standard").fragment(0)
    return frag.row_columns(row)[:n].tolist()


READS = [
    "TopN(k)", "TopN(k, n=2)", "TopN(k, Row(f=1))", "TopN(b)",
    "Rows(k)", "Rows(k, limit=2)", "Rows(b)", "Rows(k, column={col})",
    "GroupBy(Rows(k))", "GroupBy(Rows(k), Rows(b))",
    "GroupBy(Rows(k), filter=Row(f=1))",
    f"GroupBy(Rows(k), filter=Row(t=1, {WINDOW}))",
    "Count(Row(b=true))", "Row(b=false)", "Count(Row(b=1))",
    "Count(Intersect(Row(k=1), Row(b=true)))",
    "TopN(t)", "TopN(t, Row(k=0))", "Rows(t)", "GroupBy(Rows(t))",
    "GroupBy(Rows(t), Rows(k))",
    f"TopN(k, Row(t=0, {WINDOW}), n=4)",
    f"Count(Intersect(Row(t=2, {WINDOW}), Row(k=1)))",
    "Count(Row(k=1, from='2019-01-01', to='2020-01-01'))",  # not time
]


@pytest.mark.parametrize("pql", READS)
def test_reads_over_mutex_and_time_fields_match_reference(executors, pql):
    """TopN, Rows and GroupBy over a mutex field, a bool field and a time
    field's standard view, and time windows beside them."""
    jex, pex = executors
    frag = pex.holder.index("i").field("k").view("standard").fragment(1)
    col = SW + int(frag.row_columns(2)[0])
    _same(jex, pex, pql.format(col=col))


# ------------------------------------------------------- Store, ClearRow


STORES = {
    "into a new field": ["Store(Row(f=1), s=3)", "Row(s=3)"],
    "replacing a row": ["Store(Intersect(Row(f=1), Row(k=0)), f=2)"],
    "onto its own row": ["Store(Union(Row(f=1), Row(k=3)), f=1)"],
    "an empty result": ["Store(Row(f=99), f=1)"],
    "a window": [f"Store(Intersect(Row(t=1, {WINDOW}), Row(k=1)), s=1)",
                 "Count(Row(s=1))"],
    "into a mutex field": ["Store(Row(f=2), k=1)"],
    "into a time field": ["Store(Row(f=2), t=1)", f"Row(t=1, {WINDOW})"],
    "over some shards": ["Options(Store(Row(f=2), f=1), shards=[1, 3])"],
    "a negative row": ["Store(Row(f=1), s=-1)", "Store(Row(f=1), f=-2)"],
    "a row key": ["Store(Row(f=1), s='x')", "Store(Row(f=1), f='x')"],
    "no child": ["Store(f=1)"],
    "clear a row": ["ClearRow(f=1)", "ClearRow(f=1)"],
    "clear a mutex row": ["ClearRow(k=0)", "Set(5, k=0)"],
    "clear a time field": ["ClearRow(t=1)", f"Row(t=1, {WINDOW})"],
    "clear what is not there": ["ClearRow(f=42)", "ClearRow(nope=1)",
                                "ClearRow(f=-1)"],
    "clear over some shards": ["Options(ClearRow(f=2), shards=[0, 2])"],
    "store then clear": ["Store(Row(f=2), s=5)", "Count(Row(s=5))",
                         "ClearRow(s=5)", "Count(Row(s=5))",
                         "Store(Row(f=2), s=5)"],
}


@pytest.mark.parametrize("script", list(STORES))
def test_store_and_clear_row_match_reference(pair, script):
    """Store and ClearRow on resident leaves: every answer, the resident
    leaves and the files (a Store into a missing field creates it)."""
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    reads = ["Row(f=1)", "Count(Row(f=2))", "Row(k=0)", "Count(Row(k=1))",
             f"Count(Row(t=1, {WINDOW}))", "Count(Row(t=1))",
             "Count(Row(s=1))", "Count(Row(s=3))"]
    for pql in reads:
        _same(jex, pex, pql)
    for write in STORES[script]:
        _same(jex, pex, write)
        for pql in reads:
            _same(jex, pex, pql)
        _check_resident(ph)
    assert sorted(ph.index("i").fields) == sorted(jh.index("i").fields)
    _close_and_compare(jh, ph)


@pytest.fixture
def spy(monkeypatch):
    """Each K3 batch the port launches: its (slot, row, clear) targets."""
    calls = []
    real = kernels.word_patch_batch

    def wrap(targets):
        calls.append([(t[1], t[2], t[5]) for t in targets])
        return real(targets)

    monkeypatch.setattr(kernels, "word_patch_batch", wrap)
    return calls


def test_mutex_import_is_one_k3_launch(pair, spy):
    """A mutex /import moving one column a shard from row 0 to row 2 is
    one K3 launch: AND-NOT into resident Row(k=0), OR into Row(k=2) and
    both into the resident TopN matrix."""
    _, ph = pair
    api = API(ph)
    before = [api.query_raw("i", f"Count(Row(k={r}))")[0] for r in (0, 2)]
    topn = api.query_raw("i", "TopN(k)")[0]
    cols = [s * SW + _cols_of_shard(ph, s) for s in range(SHARDS)]
    spy.clear()
    assert api.import_bits("i", "k", [2] * SHARDS, cols) == SHARDS
    assert len(spy) == 1
    launch = spy[0]
    assert sorted(t for t in launch if t[1] is None) == sorted(
        [(s, None, True) for s in range(SHARDS)]
        + [(s, None, False) for s in range(SHARDS)])
    assert len([t for t in launch if t[1] is not None]) == 2 * SHARDS
    after = [api.query_raw("i", f"Count(Row(k={r}))")[0] for r in (0, 2)]
    assert after == [before[0] - SHARDS, before[1] + SHARDS]
    counts = {p.id: p.count for p in api.query_raw("i", "TopN(k)")[0]}
    assert counts[0] == {p.id: p.count for p in topn}[0] - SHARDS
    _check_resident(ph)


def _cols_of_shard(holder, shard) -> int:
    frag = holder.index("i").field("k").view("standard").fragment(shard)
    return int(frag.row_columns(0)[0])


def test_clear_row_patches_resident_leaves(pair, spy):
    """ClearRow of a sparse stored row patches its resident leaf in one
    K3 launch and keeps it resident; ClearRow of a row past half a row's
    words in a shard re-decodes that slot instead of staging its pairs."""
    _, ph = pair
    api = API(ph)
    api.query_raw("i", "Store(Intersect(Row(f=1), Row(k=1)), s=1)")
    n = api.query_raw("i", "Count(Row(s=1))")[0]
    assert n > 0
    spy.clear()
    assert api.query_raw("i", "ClearRow(s=1)") == [True]
    assert len(spy) == 1 and all(t[2] for t in spy[0])
    assert ("s", ("standard",), 1) in _resident(ph)
    assert api.query_raw("i", "Count(Row(s=1))") == [0]
    dense = np.full(SHARDS * W, 0xFFFFFFFF, np.uint32)
    dense[W:] = 0
    load_from_dense(ph, {"s": {2: dense}}, index="i")
    assert api.query_raw("i", "Count(Row(s=2))") == [SW]
    spy.clear()
    assert api.query_raw("i", "ClearRow(s=2)") == [True]
    assert spy == []  # shard 0's 2^20 positions re-decode the slot
    assert api.query_raw("i", "Count(Row(s=2))") == [0]
    _check_resident(ph)


def test_store_into_resident_row_matches_a_rebuild(pair, spy):
    """A Store replacing a resident row re-reads each shard's slot (its
    event carries no positions) and launches no K3 batch."""
    _, ph = pair
    api = API(ph)
    first = api.query_raw("i", "Count(Row(f=2))")[0]
    spy.clear()
    api.query_raw("i", "Store(Row(k=3), f=2)")
    assert spy == []
    assert api.query_raw("i", "Count(Row(f=2))")[0] == \
        api.query_raw("i", "Count(Row(k=3))")[0] != first
    _check_resident(ph)


def test_loader_keeps_mutex_rows_single_valued(tmp_path):
    """The dense loader refuses a column in two rows of a mutex field and
    a bool row past 1; its mutex files are what the reference writes for
    the same bits through import_mutex."""
    rng = np.random.default_rng(3)
    rows = _mutex_rows(rng, (0.1, 0.05, 0.02))
    h = Holder(str(tmp_path / "p"), device="cpu").open()
    with pytest.raises(ValueError, match="two rows"):
        load_from_dense(h, {"k": {0: rows[0], 1: rows[0] | rows[1]}},
                        options={"k": FieldOptions(type="mutex")},
                        index="i")
    with pytest.raises(ValueError, match="rows 0 and 1"):
        load_from_dense(h, {"b": {2: rows[0]}},
                        options={"b": FieldOptions(type="bool")}, index="i")
    load_from_dense(h, {"m": rows}, options={"m": FieldOptions(type="mutex")},
                    index="i")
    h.close()
    j = jstorage.Holder(str(tmp_path / "j")).open()
    idx = j.create_index("i")
    fld = idx.create_field("m", jstorage.FieldOptions(type="mutex"))
    for s in range(SHARDS):
        r_all, p_all = [], []
        for r, words in rows.items():
            pos = np.flatnonzero(np.unpackbits(
                words[s * W:(s + 1) * W].view(np.uint8), bitorder="little"))
            r_all.append(np.full(pos.size, r, np.uint64))
            p_all.append(pos.astype(np.uint64))
        fld.view("standard", create=True).fragment(s, create=True) \
            .import_mutex(np.concatenate(r_all), np.concatenate(p_all))
    j.close()
    want = {k: v for k, v in _view_files(tmp_path / "j").items()
            if os.sep + "m" + os.sep in k}
    got = {k: v for k, v in _view_files(tmp_path / "p").items()
           if os.sep + "m" + os.sep in k}
    assert got == want


# ------------------------------------------------------------------ HTTP


def _request(base, path, body):
    import urllib.error
    import urllib.request

    r = urllib.request.Request(base + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


HTTP = [
    ("/index/i", b"{}"),
    ("/index/i/field/k", b'{"options": {"type": "mutex"}}'),
    ("/index/i/field/b", b'{"options": {"type": "bool"}}'),
    ("/index/i/field/f", b"{}"),
    ("/index/i/field/z", b'{"options": {"type": "boolean"}}'),      # 400
    ("/index/i/field/k/import",
     b'{"rows": [1, 2, 2, 0, 3], "columns": [5, 5, 6, 1048577, 6]}'),
    ("/index/i/field/b/import", b'{"rows": [1, 0, 1], '
                                b'"columns": [5, 5, 9]}'),
    ("/index/i/field/b/import", b'{"rows": [1, 2], "columns": [5, 6]}'),
    ("/index/i/field/f/import", b'{"rows": [1, 1, 1, 2], '
                                b'"columns": [5, 6, 1048577, 6]}'),
    ("/index/i/query", b"Row(k=2) Row(k=3) Row(b=true) Row(b=false) "
                       b"TopN(k) Rows(k) GroupBy(Rows(k), Rows(b))"),
    ("/index/i/query", b"Set(6, k=1) Set(9, b=false) Row(k=1) Row(b=0)"),
    ("/index/i/query", b"Set(6, b=2)"),                               # 500
    ("/index/i/query", b"Store(Intersect(Row(f=1), Row(k=1)), s=7) "
                       b"Row(s=7) Count(Row(s=7))"),
    ("/index/i/query", b"Store(Row(f=1), k=0) Row(k=0) Row(k=1)"),
    ("/index/i/query", b"ClearRow(f=1) Row(f=1) ClearRow(f=1)"),
    ("/index/i/query", b"ClearRow(s=7) Count(Row(s=7))"),
    ("/index/i/query", b"Store(Row(f=2), s=-1)"),                     # 400
    ("/index/i/query", b"ClearRow(nope=1)"),                          # 400
]


def test_http_mutex_store_bodies_match_reference(tmp_path):
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    try:
        for path, body in HTTP:
            want = _request(f"http://localhost:{jport}", path, body)
            got = _request(f"http://localhost:{port.port}", path, body)
            assert got == want, (path, body)
    finally:
        jserver.shutdown()
        jserver.server_close()
        jh.close()
        port.close()
    assert _view_files(tmp_path / "port") == _view_files(tmp_path / "jax")

"""Time fields against the reference: quantum views, timestamped writes
and imports, from=/to= windows.

The view names and the greedy cover of a window are compared name for
name over seeded random windows for every quantum. The same timestamped
imports and Sets go through either package's API on a small data dir,
then every answer is compared as ``result_to_json`` bytes, and the view
directories, fragment files and sidecars byte for byte. Writes into a
resident window leaf (a view created after the leaf was built, a Clear
that re-decodes the slot) must leave the leaf equal to a rebuild.
"""

import datetime as dt
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.view as jview
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.executor import PQLError as JPQLError
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu.storage.field import FieldOptions as JFieldOptions
from pilosa_tpu_torch.executor import Executor, PQLError, result_to_json
from pilosa_tpu_torch.executor import batch
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage import FieldOptions, Holder
from pilosa_tpu_torch.storage import view as pview

torch.set_num_threads(1)

W = 32768
SW = W * 32
SHARDS = 4
UNITS = "YMDH"
# every quantum validate_quantum accepts: "" and the 15 subsequences
QUANTA = [""] + ["".join(c) for n in range(1, 5)
                 for c in itertools.combinations(UNITS, n)]
A, B = "2019-03-15T07:00", "2020-03-15T07:00"


def _outcome(fn, *args):
    """A call's value, or its exception as (class name, text), PQLError
    of either package named alike."""
    try:
        return fn(*args)
    except (JPQLError, PQLError) as e:
        return ("PQLError", str(e))
    except Exception as e:  # the reference raises bare ValueErrors here
        return (type(e).__name__, str(e))


# ------------------------------------------------------------ view names


@pytest.mark.parametrize("q", QUANTA + ["X", "HY", "DM", "YY", "ymd",
                                         "YMDHX", "MY", "Y M"])
def test_validate_quantum_matches_reference(q):
    assert _outcome(pview.validate_quantum, q) == \
        _outcome(jview.validate_quantum, q)


def _instants(rng, n: int) -> list:
    """Seeded instants in 2018-2021 (minutes included) and the edges the
    calendar has: month ends, 29 Feb 2020, year ends."""
    start = dt.datetime(2018, 1, 1)
    out = [start + dt.timedelta(minutes=int(m))
           for m in rng.integers(0, 4 * 366 * 24 * 60, n)]
    out += [dt.datetime(2020, 2, 29, 23, 59), dt.datetime(2020, 2, 29),
            dt.datetime(2019, 2, 28, 23), dt.datetime(2019, 12, 31, 23, 30),
            dt.datetime(2020, 1, 31, 12), dt.datetime(2019, 4, 30, 23),
            dt.datetime(2019, 3, 15, 7), dt.datetime(2020, 3, 15, 6, 59)]
    return out


@pytest.mark.parametrize("q", QUANTA)
def test_views_for_time_matches_reference(q):
    for t in _instants(np.random.default_rng(1), 40):
        assert pview.views_for_time("standard", q, t) == \
            jview.views_for_time("standard", q, t), (q, t)


def _windows(rng, n: int) -> list:
    """Seeded windows: random pairs (either order, so from >= to too),
    sub-hour windows, month ends, 29 Feb 2020, one unaligned year."""
    pts = _instants(rng, 2 * n)
    out = list(zip(pts[:n], pts[n:2 * n]))
    d = dt.datetime
    out += [
        (d(2019, 3, 15, 7), d(2020, 3, 15, 7)),
        (d(2019, 3, 15, 7, 10), d(2019, 3, 15, 7, 50)),   # inside an hour
        (d(2019, 3, 15, 7, 50), d(2019, 3, 15, 8, 10)),   # across one
        (d(2019, 1, 31, 22), d(2019, 3, 1, 1)),           # month ends
        (d(2020, 2, 28, 12), d(2020, 3, 1)),              # the leap day
        (d(2020, 2, 29), d(2020, 3, 1)),
        (d(2019, 12, 31, 23), d(2020, 1, 1, 1)),          # a year end
        (d(2018, 6, 1), d(2021, 2, 3, 4)),                # years
        (d(2019, 5, 5), d(2019, 5, 5)),                   # from == to
        (d(2019, 5, 6), d(2019, 5, 5)),                   # from > to
    ]
    return out


@pytest.mark.parametrize("q", QUANTA)
def test_views_by_time_range_matches_reference(q):
    for t0, t1 in _windows(np.random.default_rng(2), 16):
        assert pview.views_by_time_range("standard", q, t0, t1) == \
            jview.views_by_time_range("standard", q, t0, t1), (q, t0, t1)


def test_unaligned_year_is_a_cover_of_65_views():
    views = pview.views_by_time_range(
        "standard", "YMDH", dt.datetime.fromisoformat(A),
        dt.datetime.fromisoformat(B))
    assert len(views) == 65
    assert views[0] == "standard_2019031507"
    assert views[-1] == "standard_2020031506"
    assert [len(v) for v in views].count(len("standard_201904")) == 11


# ---------------------------------------------------------------- schema


@pytest.mark.parametrize("opts", [
    {"type": "time", "timeQuantum": "YMDH"},
    {"type": "time", "timeQuantum": "MD"},
    {"type": "time"},                      # no quantum
    {"type": "time", "timeQuantum": "HD"},
    {"type": "set", "timeQuantum": "YMD"},
])
def test_time_field_meta_matches_reference(tmp_path, opts):
    """Field creation writes the reference's .meta bytes, or refuses with
    its error."""
    def make(holder, options_cls, name):
        try:
            holder.create_index("i").create_field(
                "t", options_cls.from_dict(opts))
        except ValueError as e:
            return ("ValueError", str(e))
        with open(os.path.join(holder.data_dir, "i", "t", ".meta"),
                  "rb") as fh:
            return fh.read()

    j = jstorage.Holder(str(tmp_path / "j")).open()
    p = Holder(str(tmp_path / "p"), device="cpu").open()
    try:
        assert make(p, FieldOptions, "p") == make(j, JFieldOptions, "j")
    finally:
        j.close()
        p.close()


# ------------------------------------------------------------ executors


def _stamp(rng) -> str:
    t = dt.datetime(2019, 1, 1) + dt.timedelta(
        minutes=int(rng.integers(0, 485 * 24 * 60)))
    return t.isoformat(timespec="minutes")


def _fill(api, options_cls) -> None:
    """The same schema and timestamped imports through either package's
    API: time fields t (YMDH), d (YMD) and m (M), a set field s; bits
    without a timestamp stay in the standard view alone."""
    h = api.holder
    idx = h.create_index("i")
    idx.create_field("t", options_cls(type="time", time_quantum="YMDH"))
    idx.create_field("d", options_cls(type="time", time_quantum="YMD"))
    idx.create_field("m", options_cls(type="time", time_quantum="M"))
    idx.create_field("s")
    rng = np.random.default_rng(5)
    for field in ("t", "d", "m"):
        cols = rng.integers(0, SHARDS * SW, 600)
        rows = rng.integers(0, 4, cols.size)
        stamps = [None if k % 9 == 0 else _stamp(rng)
                  for k in range(cols.size)]
        api.import_bits("i", field, rows.tolist(), cols.tolist(),
                        timestamps=stamps)
    cols = rng.integers(0, SHARDS * SW, 400)
    api.import_bits("i", "s", rng.integers(0, 2, cols.size).tolist(),
                    cols.tolist())


def test_timestamped_imports_write_the_reference_files(tmp_path):
    """The same timestamped imports through either package's API write
    the same view directories, fragment files and sidecars."""
    for name, holder, api, opts in (
            ("jax", jstorage.Holder, JAPI, JFieldOptions),
            ("port", lambda d: Holder(d, device="cpu"), API, FieldOptions)):
        h = holder(str(tmp_path / name)).open()
        _fill(api(h), opts)
        h.close()
    want = _view_files(tmp_path / "jax")
    assert any("standard_2019" in k for k in want)
    assert _view_files(tmp_path / "port") == want


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("time")
    h = Holder(str(root / "seed"), device="cpu").open()
    _fill(API(h), FieldOptions)
    h.close()
    return root / "seed"


def _open_pair(seed_dir, root):
    shutil.copytree(seed_dir, root / "jax")
    shutil.copytree(seed_dir, root / "port")
    return (jstorage.Holder(str(root / "jax")).open(),
            Holder(str(root / "port"), device="cpu").open())


@pytest.fixture
def pair(seed_dir, tmp_path):
    """(reference, port) holders on copies of the seed dir."""
    jh, ph = _open_pair(seed_dir, tmp_path)
    yield jh, ph
    jh.close()
    ph.close()


@pytest.fixture(scope="module")
def executors(seed_dir, tmp_path_factory):
    """(reference, port) executors on copies of the seed dir, shared by
    the tests that only read."""
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


W1 = f"from='{A}', to='{B}'"
READS = [
    f"Count(Row(t=0, {W1}))",
    f"Row(t=1, {W1})",
    f"Count(Union(Row(t=0, {W1}), Row(t=1, {W1})))",
    f"Count(Intersect(Row(t=2, {W1}), Row(s=1)))",
    f"Range(t=3, {W1})",
    "Count(Row(t=0, from='2019-01-01T00:00', to='2020-01-01T00:00'))",
    "Row(t=1, from='2019-06-01T06:10', to='2019-06-01T06:50')",
    "Count(Row(t=0, from='2019-05-05T00:00', to='2019-05-05T00:00'))",
    "Row(t=0, from='2019-05-06T00:00', to='2019-05-05T00:00')",
    f"Count(Row(d=1, {W1}))",
    "Row(d=2, from='2019-02-28T13:00', to='2020-02-29T11:00')",
    "Count(Row(m=0, from='2019-01-31T23:00', to='2019-06-01T01:00'))",
    "Row(m=3, from='2019-02-01', to='2019-04-01')",
    "Count(Row(t=1))",
    f"Count(Not(Row(t=0, {W1})))",
    f"Count(Shift(Row(t=2, {W1}), n=3))",
    f"Count(Difference(Row(t=0), Row(t=0, {W1})))",
    f"TopN(t, Row(t=0, {W1}), n=3)",
    "Rows(t)",
    f"GroupBy(Rows(s), filter=Row(t=1, {W1}))",
    f"Count(Row(t=-1, from='junk'))",
    f"Count(Row(s=1, {W1}))",                    # not a time field
    f"Count(Row(t=1, from='{A}'))",              # one-sided window
    "Count(Row(t=1, to='2020-01-01'))",
    "Count(Row(t=1, from='yesterday', to='2020-01-01'))",
]


@pytest.mark.parametrize("pql", READS)
def test_time_reads_match_reference(executors, pql):
    _same(*executors, pql)


def _leaf(holder, field, views, row):
    """The resident [S, W] leaf of one row over ``views``, as numpy."""
    for key, arr in holder.cache._rows.items():
        if key[0] == "stack" and key[3] == field and key[4] == views \
                and key[5] == row:
            return arr.numpy().view(np.uint32)
    raise AssertionError(f"Row({field}={row}) over {len(views)} views is "
                         "not resident")


def _rebuild(holder, field, views, row) -> np.ndarray:
    idx = holder.index("i")
    spec = type("Spec", (), {"field": field, "views": views, "row": row})
    return np.stack([batch.host_row(idx, spec, s) for s in range(SHARDS)])


def test_writes_into_resident_windows_match_reference(pair):
    """A timestamped Set into a resident 65-view leaf at an hour whose
    view did not exist (K3 OR), a Clear on the time field (the slot is
    re-decoded), then a timestamped import at another new hour: every
    answer equals the reference's, the resident leaf equals a rebuild
    from the host rows, and the view files are the reference's."""
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    reads = [f"Count(Row(t=1, {W1}))", f"Row(t=1, {W1})",
             "Count(Row(t=1, from='2019-01-01T00:00', "
             "to='2020-01-01T00:00'))", "Count(Row(t=1))"]
    for pql in reads:
        _same(jex, pex, pql)
    views = tuple(pview.views_by_time_range(
        "standard", "YMDH", dt.datetime.fromisoformat(A),
        dt.datetime.fromisoformat(B)))
    fld = ph.index("i").field("t")
    col = 2 * SW + 12345
    assert fld.view("standard_2019060112") is None
    script = [
        f"Set({col}, t=1, timestamp='2019-06-01T12:00')",
        f"Set({col + 1}, t=1, timestamp='2019-06-01T12:30') "
        f"Set({col + 2}, t=1, timestamp='2019-01-02T03:00')",
        f"Clear({col}, t=1)",
        f"Set({SW + 7}, t=1, timestamp='2020-03-15T06:59')",
        f"Clear({SW + 7}, t=1) Clear({col + 1}, t=1)",
    ]
    for write in script:
        _same(jex, pex, write)
        for pql in reads:
            _same(jex, pex, pql)
        assert np.array_equal(_leaf(ph, "t", views, 1),
                              _rebuild(ph, "t", views, 1)), write
    assert fld.view("standard_2019060112") is not None
    japi, papi = JAPI(jh), API(ph)
    cols = [s * SW + 999 for s in range(SHARDS)]
    stamps = ["2019-09-17T05:00"] * SHARDS
    assert papi.import_bits("i", "t", [1] * SHARDS, cols,
                            timestamps=stamps) == \
        japi.import_bits("i", "t", [1] * SHARDS, cols, timestamps=stamps)
    for pql in reads:
        _same(jex, pex, pql)
    assert np.array_equal(_leaf(ph, "t", views, 1),
                          _rebuild(ph, "t", views, 1))
    jroot, proot = jh.data_dir, ph.data_dir
    jh.close()
    ph.close()
    assert _view_files(proot) == _view_files(jroot)


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


@pytest.mark.parametrize("pql", [
    "Set(9, s=1, timestamp='2019-06-01T12:00')",   # not a time field
    "Set(9, t=1, timestamp='junk')",
    "Set(9, t=1, timestamp='2019-06-01T12:00:30')",
    "Set(9, t=-1, timestamp='2019-06-01T12:00')",
    "Clear(9, t=1, timestamp='2019-06-01T12:00')",
])
def test_odd_timestamped_writes_answer_as_the_reference(pair, pql):
    """A timestamp on a field that is not a time field raises the
    reference's bare ValueError after the standard bit is set; a
    timestamp that does not parse raises before any write."""
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    _same(jex, pex, pql)
    _same(jex, pex, "Row(s=1) Row(t=1)")
    jroot, proot = jh.data_dir, ph.data_dir
    jh.close()
    ph.close()
    assert _view_files(proot) == _view_files(jroot)


def test_timestamped_import_is_one_k3_launch(pair, monkeypatch):
    """A timestamped /import of one bit a shard at an hour that had no
    view patches every resident leaf whose cover names that hour, day,
    month or year, in one K3 launch."""
    from pilosa_tpu_torch import kernels

    _, ph = pair
    api = API(ph)
    year = "from='2019-01-01T00:00', to='2020-01-01T00:00'"
    leaves = [f"Count(Row(t=0, {W1}))", f"Count(Row(t=1, {W1}))",
              f"Count(Row(t=0, {year}))",
              "Count(Row(t=1, from='2019-09-17T05:00', "
              "to='2019-09-17T06:00'))"]
    before = [api.query_raw("i", pql)[0] for pql in leaves]
    calls = []
    real = kernels.word_patch_batch

    def spy(targets):
        calls.append(targets)
        return real(targets)

    monkeypatch.setattr(kernels, "word_patch_batch", spy)
    cols = [s * SW + 2 * s + 1 for s in range(SHARDS)]
    assert ph.index("i").field("t").view("standard_2019091705") is None
    api.import_bits("i", "t", [s % 2 for s in range(SHARDS)], cols,
                    timestamps=["2019-09-17T05:00"] * SHARDS)
    assert len(calls) == 1
    # rows 0 and 1 of the 65-view cover (its month), row 0 of the year
    # and row 1 of the one-hour window, each in every shard it holds
    assert len(calls[0]) == 2 * SHARDS
    after = [api.query_raw("i", pql)[0] for pql in leaves]
    gained = [SHARDS // 2, SHARDS // 2, SHARDS // 2, SHARDS // 2]
    assert [a - b for a, b in zip(after, before)] == gained


# ----------------------------------------------------------------- HTTP


def _request(base, method, path, body):
    import urllib.error
    import urllib.request

    r = urllib.request.Request(base + path, data=body, method=method)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


HTTP = [
    ("/index/i", b"{}"),
    ("/index/i/field/t", b'{"options": {"type": "time", '
                         b'"timeQuantum": "YMDH"}}'),
    ("/index/i/field/d", b'{"options": {"type": "time", '
                         b'"timeQuantum": "YMD"}}'),
    ("/index/i/field/x", b'{"options": {"type": "time"}}'),        # 400
    ("/index/i/field/y", b'{"options": {"type": "time", '
                         b'"timeQuantum": "DY"}}'),                # 400
    ("/index/i/field/t/import",
     b'{"rows": [1, 1, 2, 1], "columns": [5, 1048580, 9, 77], '
     b'"timestamps": ["2019-06-01T12:00", "2019-06-02T01:30", null, '
     b'"2020-02-29T23:00"]}'),
    ("/index/i/field/d/import",
     b'{"rows": [1, 1], "columns": [5, 6], '
     b'"timestamps": ["2019-06-01T12:00", ""]}'),
    ("/index/i/field/t/import",
     b'{"rows": [1, 1], "columns": [5, 6], "timestamps": ["2019"]}'),
    ("/index/i/field/t/import",
     b'{"rows": [1], "columns": [5], "timestamps": ["junk"]}'),     # 500
    ("/index/i/query", f"Count(Row(t=1, {W1})) Row(t=1, {W1}) "
                       f"Row(d=1, {W1}) Row(t=2)".encode()),
    ("/index/i/query",
     b"Set(3, t=1, timestamp='2019-03-15T07:00') Row(t=1, "
     b"from='2019-03-15T07:00', to='2019-03-15T08:00')"),
    ("/index/i/query", f"Count(Row(t=1, from='{A}'))".encode()),    # 500
    ("/index/i/query", f"Count(Row(t=1, to='{B}'))".encode()),
    ("/index/i/query", b"Set(3, d=1, timestamp='nope')"),
    ("/index/i/query", f"Row(t=1, from='{B}', to='{A}')".encode()),
    ("/index/i/query", b"Clear(5, t=1) Row(t=1, from='2019-01-01', "
                       b"to='2021-01-01')"),
]


def test_http_time_bodies_match_reference(tmp_path):
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    try:
        for path, body in HTTP:
            want = _request(f"http://localhost:{jport}", "POST", path, body)
            got = _request(f"http://localhost:{port.port}", "POST", path,
                           body)
            assert got == want, (path, body)
    finally:
        jserver.shutdown()
        jserver.server_close()
        jh.close()
        port.close()
    assert _view_files(tmp_path / "port") == _view_files(tmp_path / "jax")

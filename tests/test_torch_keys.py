"""String keys against the reference: the translate log, keyed PQL through
both executors and over HTTP, and the translate routes.

The translate log is compared byte for byte after the same translations;
every answer as ``result_to_json`` bytes, or as the same exception text
where the reference raises. The keyed data dir comes from one numpy seed
through the port's dense loader (row keys and column keys); the reference
opens a copy of it.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu.storage.translate import TranslateStore as JTranslateStore
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense
from pilosa_tpu_torch.storage.translate import (
    TranslateStore,
    column_namespace,
    row_namespace,
)

torch.set_num_threads(1)

W = 32768
SW = W * 32
SHARDS = 3
N_KEYED = 3000  # columns 0 … 2999 have keys; the rest are ids alone


def _user_keys(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    raw = rng.integers(97, 123, (n, 12), dtype=np.uint8)
    return [bytes(r).decode() for r in raw]


USERS = _user_keys(5, N_KEYED)


def _words(rng, density_keyed: float, density: float) -> np.ndarray:
    """Dense rows: denser over the keyed columns than past them."""
    bits = rng.random(SHARDS * SW) < density
    bits[:N_KEYED] = rng.random(N_KEYED) < density_keyed
    return np.packbits(bits, bitorder="little").view("<u4")


def _pay_rows(rng) -> dict:
    """Mutex rows CRD/CSH/NOC, each column in one of them at most."""
    draw = rng.random(SHARDS * SW)
    draw[:N_KEYED] *= 0.01  # keyed columns nearly all paid
    out = {}
    for key, lo, hi in (("CRD", 0.0, 0.006), ("CSH", 0.006, 0.009),
                        ("NOC", 0.009, 0.0095)):
        out[key] = np.packbits((draw >= lo) & (draw < hi),
                               bitorder="little").view("<u4")
    return out


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    """Index ``u`` (keyed columns): set field ``seg`` with keys (rows
    alpha, beta, gamma and the bare id 7), mutex ``pay`` with keys, set
    field ``tag`` without keys, int field ``v``; index ``i`` without keys
    (field ``f``)."""
    rng = np.random.default_rng(31)
    path = tmp_path_factory.mktemp("keys") / "seed"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(
        h, {"seg": {"alpha": _words(rng, 0.3, 0.002),
                    "beta": _words(rng, 0.2, 0.001),
                    "gamma": _words(rng, 0.05, 0.0005),
                    7: _words(rng, 0.1, 0.001)},
            "pay": _pay_rows(rng),
            "tag": {1: _words(rng, 0.4, 0.003), 2: _words(rng, 0.1, 0.0)}},
        options={"seg": FieldOptions(keys=True),
                 "pay": FieldOptions(type="mutex", keys=True)},
        index="u", column_keys=USERS)
    h.index("u").create_field("v", FieldOptions(type="int", min=0, max=100))
    load_from_dense(h, {"f": {1: _words(rng, 0.1, 0.002)}}, index="i")
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


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # either package's PQLError, or a bare one
        return (type(e).__name__, str(e))


def _same(jex, pex, index, pql):
    want = _outcome(lambda: json.dumps(j_result_to_json(
        jex.execute(index, pql))))
    got = _outcome(lambda: json.dumps(result_to_json(
        pex.execute(index, pql))))
    assert got == want, pql
    return got


def _log(path) -> bytes:
    with open(os.path.join(path, ".translate.log"), "rb") as f:
        return f.read()


# --------------------------------------------------------- translate log


def _script(seed: int) -> list:
    """A seeded sequence of translate calls over three namespaces, new
    and known keys, with and without create, non-ASCII keys among them."""
    rng = np.random.default_rng(seed)
    pool = [f"k{i}" for i in range(40)] + ["é", "日本", "a/b", ""]
    spaces = [column_namespace("u"), row_namespace("u", "seg"),
              row_namespace("idx2", "f")]
    out = []
    for _ in range(60):
        keys = [pool[int(i)] for i in rng.integers(0, len(pool),
                                                   int(rng.integers(1, 6)))]
        out.append((spaces[int(rng.integers(0, 3))], keys,
                    bool(rng.random() < 0.7)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_translate_log_bytes_match_reference(tmp_path, seed):
    """The same translations write the same log and answer the same ids
    and keys; both reopen each other's log to the same maps."""
    j = JTranslateStore(str(tmp_path / "j.log")).open()
    p = TranslateStore(str(tmp_path / "p.log")).open()
    for ns, keys, create in _script(seed):
        assert p.translate(ns, keys, create=create) == \
            j.translate(ns, keys, create=create)
        assert p.translate_one(ns, keys[0]) == j.translate_one(ns, keys[0])
    for ns in {ns for ns, _, _ in _script(seed)}:
        ids = list(range(-1, 50))
        assert p.keys_of(ns, ids) == j.keys_of(ns, ids)
    j.sync()
    p.sync()
    assert p.log_size() == j.log_size()
    j.close()
    p.close()
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    # each opens the other's log
    j2 = JTranslateStore(str(tmp_path / "p.log")).open()
    p2 = TranslateStore(str(tmp_path / "j.log")).open()
    for ns, keys, _ in _script(seed):
        assert p2.translate(ns, keys) == j2.translate(ns, keys)
    j2.close()
    p2.close()


@pytest.mark.parametrize("cut", [1, 5, 8, 11, 14])
def test_replay_stops_at_a_torn_tail_as_the_reference(tmp_path, cut):
    """A log cut mid-record (in the header, the namespace or the key)
    replays to the same maps in both packages, and the next records
    append after the torn bytes in both, as the reference appends."""
    j = JTranslateStore(str(tmp_path / "w.log")).open()
    j.translate("c/u", ["alice", "bob", "carol"], create=True)
    j.translate("r/u/seg", ["x"], create=True)
    j.close()
    data = (tmp_path / "w.log").read_bytes()
    torn = data + data[:cut]  # a whole log, then a torn copy of a record
    for name in ("j.log", "p.log"):
        (tmp_path / name).write_bytes(torn)
    j = JTranslateStore(str(tmp_path / "j.log")).open()
    p = TranslateStore(str(tmp_path / "p.log")).open()
    for ns in ("c/u", "r/u/seg"):
        assert p.keys_of(ns, range(5)) == j.keys_of(ns, range(5))
    assert p.translate("c/u", ["dave", "alice"], create=True) == \
        j.translate("c/u", ["dave", "alice"], create=True)
    j.close()
    p.close()
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "j.log").read_bytes()


def test_read_log_and_apply_log_tail_either_way(tmp_path):
    """A replica of either package applies the other's log from any
    offset, known keys skipped, to the same maps and bytes."""
    prim_j = JTranslateStore(str(tmp_path / "pj.log")).open()
    prim_p = TranslateStore(str(tmp_path / "pp.log")).open()
    for ns, keys, _ in _script(7):
        prim_j.translate(ns, keys, create=True)
        prim_p.translate(ns, keys, create=True)
    size = prim_p.log_size()
    assert size == prim_j.log_size()
    for offset in (0, 9, size // 2, size):
        assert prim_p.read_log(offset) == prim_j.read_log(offset)
    data = prim_p.read_log(0)
    rep_j = JTranslateStore(str(tmp_path / "rj.log")).open()
    rep_p = TranslateStore(str(tmp_path / "rp.log")).open()
    rep_j.translate("c/u", ["k3", "zzz"], create=True)
    rep_p.translate("c/u", ["k3", "zzz"], create=True)
    half = len(data) // 2
    for chunk in (data[:half], data, data[:3]):  # a torn chunk, a repeat
        assert rep_p.apply_log(chunk) == rep_j.apply_log(chunk)
    for ns, keys, _ in _script(7):
        assert rep_p.translate(ns, keys) == rep_j.translate(ns, keys)
    for s in (prim_j, prim_p, rep_j, rep_p):
        s.close()
    assert (tmp_path / "rp.log").read_bytes() == \
        (tmp_path / "rj.log").read_bytes()


def test_loader_writes_the_records_sets_would_write(seed_dir, tmp_path):
    """The dense loader's translate records are those of a reference
    holder translating each column key, then each row key, in id order."""
    j = JTranslateStore(str(tmp_path / "t.log")).open()
    j.translate(column_namespace("u"), USERS, create=True)
    j.translate(row_namespace("u", "seg"), ["alpha", "beta", "gamma"],
                create=True)
    j.translate(row_namespace("u", "pay"), ["CRD", "CSH", "NOC"],
                create=True)
    j.close()
    assert _log(seed_dir) == (tmp_path / "t.log").read_bytes()


def test_loader_refuses_keys_it_cannot_place(tmp_path):
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    try:
        words = np.zeros(W, np.uint32)
        with pytest.raises(ValueError, match="without keys=true"):
            load_from_dense(h, {"f": {"a": words}}, index="i")
        load_from_dense(h, {}, index="k", column_keys=["a", "b"])
        with pytest.raises(ValueError, match="ids 0"):
            load_from_dense(h, {}, index="k", column_keys=["c"])
        with pytest.raises(ValueError, match="without keys=true"):
            load_from_dense(h, {}, index="i", column_keys=["a"])
    finally:
        h.close()


# ------------------------------------------------------------ keyed reads


KEY0, KEY1, KEY2 = USERS[0], USERS[1], USERS[2]

READS = [
    'Row(seg="alpha")', "Row(seg=7)", 'Row(seg="nope")', 'Range(seg="beta")',
    'Count(Row(seg="alpha"))', 'Count(Row(seg="nope"))',
    'Count(Intersect(Row(seg="alpha"), Row(tag=1)))',
    'Union(Row(seg="gamma"), Row(pay="NOC"))', 'Not(Row(seg="beta"))',
    'Xor(Row(seg="alpha"), Row(seg="nope"))',
    "TopN(seg)", "TopN(pay, n=2)", "TopN(seg, Row(tag=1), n=2)",
    "TopN(seg, ids=[0, 7, 9])", "TopN(tag)",
    "Rows(seg)", "Rows(seg, limit=2)", 'Rows(seg, like="%a")',
    'Rows(seg, like="g%", limit=2)', 'Rows(seg, like="%")',
    "Rows(seg, previous=0)", "Rows(seg, column=5)", "Rows(pay)",
    "Rows(tag)", 'Rows(seg, like="a_pha")', 'Rows(seg, like="%ta")',
    'Rows(seg, like="b%", limit=1)', 'Rows(seg, like="b%", previous=0)',
    # reference quirks
    'Rows(seg, column="key")', 'Rows(seg, previous="key")',
    'Rows(tag, like="x%")', 'Row(tag="key")', 'Count(Row(tag="key"))',
    "GroupBy(Rows(seg))", "GroupBy(Rows(seg), Rows(pay))",
    "GroupBy(Rows(pay), Rows(tag), limit=4)",
    'GroupBy(Rows(seg), Rows(tag), filter=Row(pay="CRD"))',
    "GroupBy(Rows(tag), Rows(seg), limit=5)",
    'GroupBy(Rows(seg), aggregate=Sum(field="v"))',
    f'IncludesColumn(Row(seg="alpha"), column="{KEY0}")',
    f'IncludesColumn(Row(seg="alpha"), column="{KEY1}")',
    'IncludesColumn(Row(seg="alpha"), column="ghost")',
    "IncludesColumn(Row(seg=7), column=5)",
    f'Options(IncludesColumn(Row(seg="alpha"), column="{KEY0}"), '
    'shards=[1])',
    'Options(Row(seg="alpha"), shards=[1])',
    'Options(Row(seg="alpha"), excludeColumns=true)',
    'Options(Row(seg="beta"), shards=[])',
    'Row(seg="alpha", from="2019-01-01T00:00", to="2020-01-01T00:00")',
]


@pytest.mark.parametrize("pql", READS)
def test_keyed_reads_match_reference(executors, pql):
    _same(*executors, "u", pql)


@pytest.mark.parametrize("pql", [
    'Row(f="x")', 'Set("k", f=1)', 'Clear("k", f=1)',
    'IncludesColumn(Row(f=1), column="k")', 'Rows(f, like="a")',
    'ClearRow(f="x")', 'Store(Row(f=1), f="x")', 'Store(Row(f=1), g="x")',
    'SetColumnAttrs("k", a=1)', 'Count(Row(f="x"))',
])
def test_keys_on_an_unkeyed_index_are_refused_as_the_reference(pair, pql):
    jh, ph = pair
    _same(JExecutor(jh), Executor(ph, device="cpu"), "i", pql)


def test_submitted_reads_carry_keys(executors):
    """The pipelined path (submit, then result) answers as execute."""
    jex, pex = executors
    pql = ('Row(seg="alpha") TopN(pay, n=2) Count(Row(seg="beta")) '
           'GroupBy(Rows(pay)) Options(Row(seg="gamma"), shards=[0])')
    want = json.dumps(j_result_to_json(jex.execute("u", pql)))
    got = json.dumps(result_to_json([d.result()
                                     for d in pex.submit("u", pql)]))
    assert got == want


# ----------------------------------------------------------- keyed writes


WRITES = {
    "set and clear": [
        f'Set("{KEY0}", seg="alpha")', 'Set("newuser", seg="alpha")',
        'Set("newuser", seg="delta")', 'Row(seg="delta")',
        'Clear("newuser", seg="delta")', 'Clear("ghost", seg="alpha")',
        'Clear("newuser", seg="nope")', 'Row(seg="alpha")',
        'Count(Row(seg="delta"))', 'Rows(seg)', "TopN(seg)",
        f"Set({2 * SW + 5}, seg=\"delta\")", 'Row(seg="delta")',
    ],
    "mutex": [
        f'Set("{KEY1}", pay="CSH")', f'Set("{KEY1}", pay="VOD")',
        "Rows(pay)", "TopN(pay)", 'Row(pay="VOD")', 'Row(pay="CSH")',
        f'Clear("{KEY1}", pay="VOD")', 'Count(Row(pay="VOD"))',
        "GroupBy(Rows(pay))",
    ],
    "clear row and store": [
        'ClearRow(seg="nope")', 'ClearRow(seg="beta")', 'Row(seg="beta")',
        'Store(Row(seg="alpha"), seg="copy")', 'Row(seg="copy")',
        'Store(Row(seg="gamma"), fresh="x")', 'Store(Row(seg="gamma"), tag="x")',
        'Store(Row(seg="gamma"), fresh=3)', "Rows(seg)",
        'Options(Store(Row(seg="beta"), seg="part"), shards=[0])',
        'Row(seg="part")',
    ],
    "created later": [
        'Count(Row(seg="late"))', 'Row(seg="late")',
        f'Set("{KEY2}", seg="late")', 'Count(Row(seg="late"))',
        'Row(seg="late")', 'Count(Intersect(Row(seg="late"), Row(tag=1)))',
        f'Set("{KEY2}", seg="late")', 'Count(Row(seg="late"))',
    ],
    "int values and errors": [
        f'Set("{KEY0}", v=5)', 'Set("brandnew", v=99)', 'Sum(field="v")',
        "Row(v > 3)", 'Set("x1", nofield=1)', 'Set("x2", seg=-1)',
        'Set(-3, seg="a")', 'Clear("x1", v=5)', 'Clear("brandnew", v=1)',
        "Row(v > 3)", 'Set("x3", seg=1.5)', "Rows(seg)",
    ],
}


@pytest.mark.parametrize("script", list(WRITES))
def test_keyed_writes_match_reference(pair, script):
    """The same keyed writes answer the same, read the same afterwards,
    and leave the same translate log and fragment files after a close."""
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    for pql in WRITES[script]:
        _same(jex, pex, "u", pql)
    jroot, proot = jh.data_dir, ph.data_dir
    jh.close()
    ph.close()
    assert _log(proot) == _log(jroot)
    jv, pv = _tree(jroot, "views"), _tree(proot, "views")
    assert sorted(pv) == sorted(jv)
    for k in jv:
        assert pv[k] == jv[k], k


def _tree(root, part: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if os.sep + part + os.sep in rel:
                with open(os.path.join(dirpath, name), "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_a_key_created_later_is_not_hidden_by_the_plan_cache(pair):
    """A Row of an unknown key compiles to the empty row; that plan is
    not cached, so the same (memoized) query sees the key once a Set
    creates it, on resident leaves too."""
    _, ph = pair
    pex = Executor(ph, device="cpu")
    pql = 'Count(Intersect(Row(seg="later"), Row(tag=1)))'
    assert pex.execute("u", pql) == [0]
    assert pex.execute("u", "Count(Row(tag=1))")[0] > 0  # n=1 resident
    assert not any(k[0] == "u" and "const0" in repr(v[3].node)
                   for k, v in pex._plan_cache.items())
    key = next(k for k in USERS if pex.execute(
        "u", f'IncludesColumn(Row(tag=1), column="{k}")') == [True])
    assert pex.execute("u", f'Set("{key}", seg="later")') == [True]
    assert pex.execute("u", pql) == [1]
    assert pex.execute("u", pql) == [1]  # now cached, and still right


def test_a_new_column_key_in_a_new_shard_is_read_back(tmp_path):
    """A column key whose id opens a shard the index did not have: the
    stacked leaves of the new shard list are decoded afresh (their key
    holds the shard list), and answer over every shard."""
    roots = {}
    for name, make in (("jax", lambda p: jstorage.Holder(p).open()),
                       ("port", lambda p: Holder(p, device="cpu").open())):
        h = make(str(tmp_path / name))
        h.create_index("u", keys=True).create_field(
            "s", (FieldOptions if name == "port" else
                  jstorage.FieldOptions)(keys=True))
        roots[name] = h
    jex = JExecutor(roots["jax"])
    pex = Executor(roots["port"], device="cpu")
    try:
        _same(jex, pex, "u", 'Set("a", s="x") Set("b", s="x")')
        _same(jex, pex, "u", 'Count(Row(s="x")) Row(s="x")')
        # ids past the first shard: columns by id, then a key
        _same(jex, pex, "u", f'Set({SW + 3}, s="x") Row(s="x")')
        _same(jex, pex, "u", f'Set("c", s="x") Count(Row(s="x")) '
                             'Row(s="x") TopN(s)')
    finally:
        roots["jax"].close()
        roots["port"].close()


# ------------------------------------------------------------------ HTTP


def _request(base: str, method: str, path: str, body):
    r = urllib.request.Request(base + path, data=body, method=method)
    if body is not None:
        r.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _keys_body(namespace: str, keys, create: bool) -> bytes:
    return json.dumps({"namespace": namespace, "keys": keys,
                       "create": create}).encode()


HTTP = [
    ("POST", "/index/u/query", f'Row(seg="alpha") TopN(seg, n=2)'.encode()),
    ("POST", "/index/u/query", b"GroupBy(Rows(seg), Rows(pay)) Rows(seg)"),
    ("POST", "/internal/translate/keys",
     _keys_body("c/u", [KEY0, "newA", "newB"], False)),
    ("POST", "/internal/translate/keys",
     _keys_body("c/u", [KEY0, "newA", "newB", "newA"], True)),
    ("POST", "/internal/translate/keys",
     _keys_body("r/u/seg", ["alpha", "omega"], True)),
    ("POST", "/internal/translate/keys", b'{"keys": ["z"]}'),
    ("POST", "/internal/translate/keys", b"{not json"),
    ("GET", "/internal/translate/data?offset=0", None),
    ("GET", "/internal/translate/data?offset=36000", None),
    ("GET", "/internal/translate/data", None),
    ("GET", "/internal/translate/data?offset=x", None),
    # an /import of the ids the route gave (new keys get ids 3000, 3001)
    ("POST", "/index/u/field/seg/import",
     b'{"rows": [3, 3, 0], "columns": [3000, 3001, 3001]}'),
    ("POST", "/index/u/query",
     b'Row(seg="omega") Count(Row(seg="omega")) Row(seg="alpha")'),
    ("POST", "/index/u/query", b'Set("newC", seg="omega") Rows(seg)'),
    ("POST", "/index/k2", b'{"options": {"keys": true}}'),
    ("POST", "/index/k2/field/f", b'{"options": {"keys": true}}'),
    ("POST", "/index/k2/query",
     b'Set("a", f="x") Set("b", f="x") Row(f="x") TopN(f)'),
    ("POST", "/index/k2/query", b'Count(Row(f="y")) Row(f=0)'),
    ("POST", "/index/u/query", b'Row(tag="k")'),
    ("POST", "/index/u/query", b'Rows(seg, column="k")'),
    ("POST", "/index/u/query", b'Rows(seg, previous="k")'),
    ("POST", "/index/u/query", b'Rows(tag, like="k%")'),
    ("POST", "/index/u/query",
     b'Rows(seg, like="b%", limit=1) Rows(seg, like="%a")'),
    ("POST", "/index/u/query",
     b'Clear("ghost", seg="alpha") Clear("newC", seg="nope") '
     b'ClearRow(seg="nope") Clear("newC", seg="omega") Row(seg="omega")'),
    ("POST", "/index/u/query",
     f'IncludesColumn(Row(seg="alpha"), column="{KEY0}") '
     'IncludesColumn(Row(seg="alpha"), column="ghost") '
     'GroupBy(Rows(tag), Rows(seg), limit=6) TopN(pay)'.encode()),
    ("POST", "/index/u/query",
     b'Store(Row(seg="alpha"), seg="kept") Count(Row(seg="kept")) '
     b'Set("late1", seg="later") Count(Row(seg="later"))'),
    ("POST", "/index/u/query?excludeColumns=true", b'Row(seg="omega")'),
    ("POST", "/index/u/query?excludeColumns=false&columnAttrs=true",
     b'Row(seg="omega")'),
    ("GET", "/internal/translate/data?offset=36200", None),
]


def test_http_keyed_bodies_match_reference(seed_dir, tmp_path):
    """Keyed queries, the translate routes and keyed schema over HTTP:
    the same status, content type and body bytes, and afterwards the
    same translate log."""
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    try:
        for method, path, body in HTTP:
            want = _request(f"http://localhost:{jport}", method, path, body)
            got = _request(f"http://localhost:{port.port}", method, path,
                           body)
            assert got == want, (method, path, body)
    finally:
        jserver.shutdown()
        jserver.server_close()
        jh.close()
        port.close()
    assert _log(tmp_path / "port") == _log(tmp_path / "jax")


def test_keyed_write_syncs_the_translate_log_before_the_ack(pair,
                                                              monkeypatch):
    """A keyed write's ACK fsyncs the translate log, then the WAL; an
    unkeyed write fsyncs no translate record."""
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import translate as translate_mod

    _, ph = pair
    events = []
    monkeypatch.setattr(translate_mod, "wal_fsync",
                        lambda fd: events.append("translate"))
    real = ph.wal.barrier
    monkeypatch.setattr(ph.wal, "barrier",
                        lambda: (events.append("wal"), real())[1])
    api = API(ph)
    api.query_raw("u", 'Set("fresh", seg="alpha")')
    assert events == ["translate", "wal"]
    events.clear()
    api.query_raw("u", "Set(9, seg=7)")
    assert events == ["wal"]

"""Row and column attributes against the reference: the attribute stores,
the attribute calls and options through both executors, and the
request-level URL options over HTTP.

The stores are compared through ``AttrStore`` (attrs, bulk reads and
block digests), never by the sqlite files' bytes; answers as
``result_to_json`` bytes, or the same exception text.
"""

import json
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
from pilosa_tpu.storage.attrs import AttrStore as JAttrStore
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense
from pilosa_tpu_torch.storage.attrs import ATTR_BLOCK_SIZE, AttrStore

torch.set_num_threads(1)

W = 32768
SW = W * 32
SHARDS = 2


# ---------------------------------------------------------------- stores


def _attr_ops(seed: int, n: int = 600) -> list:
    """Seeded set_attrs calls: ids over several 100-id blocks, values of
    every JSON type, nulls that delete a name."""
    rng = np.random.default_rng(seed)
    values = [1, -7, 2.5, "x", "ünï", True, False, [1, "a"], {"k": 1}, None]
    out = []
    for _ in range(n):
        id_ = int(rng.integers(0, 1300))
        attrs = {f"a{int(k)}": values[int(rng.integers(0, len(values)))]
                 for k in rng.integers(0, 6, int(rng.integers(1, 4)))}
        out.append((id_, attrs))
    return out


def _same_store(j, p, ids) -> None:
    for i in ids:
        assert p.attrs(i) == j.attrs(i), i
    assert p.bulk(ids) == j.bulk(ids)
    assert p.blocks() == j.blocks()


@pytest.mark.parametrize("seed", [1, 2])
def test_attr_stores_match_reference(tmp_path, seed):
    """The same merges (a null deletes its name) answer the same attrs,
    bulk reads past one 500-id chunk and block digests, and each package
    reads the other's file to the same."""
    j = JAttrStore(str(tmp_path / "j.db")).open()
    p = AttrStore(str(tmp_path / "p.db")).open()
    for id_, attrs in _attr_ops(seed):
        assert p.set_attrs(id_, attrs) == j.set_attrs(id_, attrs)
    ids = list(range(0, 1300, 1)) + [5000]
    _same_store(j, p, ids)
    # the bulk read's answer spans its three 500-id chunks
    assert {i // 500 for i in p.bulk(ids)} == {0, 1, 2}
    for block in range(14):
        assert p.block_data(block) == j.block_data(block)
    j.close()
    p.close()
    j2 = JAttrStore(str(tmp_path / "p.db")).open()
    p2 = AttrStore(str(tmp_path / "j.db")).open()
    _same_store(j2, p2, ids)
    j2.close()
    p2.close()


def test_merge_block_repairs_as_the_reference(tmp_path):
    """Anti-entropy: a replica merges a peer's differing blocks and ends
    with the peer's digests, in either package, from either package."""
    stores = {}
    for name, cls in (("pj", JAttrStore), ("pp", AttrStore),
                      ("rj", JAttrStore), ("rp", AttrStore)):
        stores[name] = cls(str(tmp_path / f"{name}.db")).open()
    for id_, attrs in _attr_ops(3):
        stores["pj"].set_attrs(id_, attrs)
        stores["pp"].set_attrs(id_, attrs)
    for id_, attrs in _attr_ops(4, 50):
        stores["rj"].set_attrs(id_, attrs)
        stores["rp"].set_attrs(id_, attrs)
    peer = dict(stores["pp"].blocks())
    for rep, prim in (("rj", "pp"), ("rp", "pj")):
        mine = dict(stores[rep].blocks())
        for block, digest in peer.items():
            if mine.get(block) != digest:
                stores[rep].merge_block(stores[prim].block_data(block))
    assert stores["rp"].blocks() == stores["rj"].blocks()
    assert stores["rp"].bulk(range(1300)) == stores["rj"].bulk(range(1300))
    assert ATTR_BLOCK_SIZE == 100
    for s in stores.values():
        s.close()


def test_holder_opens_an_attr_store_per_index_and_field(tmp_path):
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    idx = h.create_index("i")
    fld = idx.create_field("f")
    idx.column_attrs.set_attrs(3, {"a": 1})
    fld.row_attrs.set_attrs(1, {"b": "x"})
    h.close()
    j = jstorage.Holder(str(tmp_path / "d")).open()
    try:
        assert j.index("i").column_attrs.attrs(3) == {"a": 1}
        assert j.index("i").field("f").row_attrs.attrs(1) == {"b": "x"}
    finally:
        j.close()


# ------------------------------------------------------------- PQL calls


def _words(rng, density: float) -> np.ndarray:
    bits = rng.random(SHARDS * SW) < density
    bits[:64] = rng.random(64) < 0.5
    return np.packbits(bits, bitorder="little").view("<u4")


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    """Index ``i`` (set fields f with rows 1-5, g with row 7), index ``u``
    with keyed columns and a keyed field ``s``."""
    rng = np.random.default_rng(41)
    path = tmp_path_factory.mktemp("attrs") / "seed"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": {r: _words(rng, 0.0002 * r) for r in
                              range(1, 6)},
                        "g": {7: _words(rng, 0.0003)}}, index="i")
    keys = [f"user{i}" for i in range(64)]
    load_from_dense(h, {"s": {"red": _words(rng, 0.0)[:W],
                              "blue": _words(rng, 0.0)[:W]}},
                    options={"s": FieldOptions(keys=True)}, index="u",
                    column_keys=keys)
    h.close()
    return path


@pytest.fixture
def pair(seed_dir, tmp_path):
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    ph = Holder(str(tmp_path / "port"), device="cpu").open()
    yield jh, ph
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


SCRIPTS = {
    "row attrs": ("i", [
        'SetRowAttrs(f, 1, name="alice", active=true)', "Row(f=1)",
        'SetRowAttrs(f, 1, name=null, score=3.5)', "Row(f=1)",
        "Row(f=2)", 'SetRowAttrs(f, 9, x="y")', "Row(f=9)",
        "Count(Row(f=1))", "Union(Row(f=1), Row(f=2))",
        "Options(Row(f=1), excludeColumns=true)",
        'SetRowAttrs(nope, 1, a=1)', "SetRowAttrs(f)",
        'SetRowAttrs(f, "key", a=1)', "Row(f=1, from='2019-01-01T00:00', "
        "to='2020-01-01T00:00')", "Range(f=1)",
    ]),
    "topn filter": ("i", [
        'SetRowAttrs(f, 1, tier="gold", rank=1)',
        'SetRowAttrs(f, 3, tier="gold", rank=2)',
        'SetRowAttrs(f, 4, tier="silver")', 'SetRowAttrs(g, 7, tier="gold")',
        'TopN(f, attrName="tier", attrValue="gold")',
        'TopN(f, n=1, attrName="tier", attrValue="gold")',
        'TopN(f, attrName="tier", attrValue="bronze")',
        'TopN(f, attrName="rank", attrValue=2)',
        'TopN(f, attrName="rank")', 'TopN(f, attrName="missing", attrValue=1)',
        'TopN(f, Row(g=7), attrName="tier", attrValue="gold")',
        'TopN(f, ids=[1, 2, 3], attrName="tier", attrValue="gold")',
        'Options(TopN(f, attrName="tier", attrValue="gold"), shards=[1])',
    ]),
    "column attrs": ("i", [
        "SetColumnAttrs(3, plan=\"pro\")", "SetColumnAttrs(4, plan=\"free\")",
        f"SetColumnAttrs({SW + 2}, plan=\"pro\", seats=4)",
        "SetColumnAttrs(3, plan=null)", "SetColumnAttrs(x=1)",
        "Options(Row(f=1), columnAttrs=true)",
        "Options(Union(Row(f=1), Row(f=2), Row(g=7)), columnAttrs=true)",
        "Options(Row(f=1), columnAttrs=true, excludeColumns=true)",
        "Options(Count(Row(f=1)), columnAttrs=true)",
        "Options(Row(f=99), columnAttrs=true)",
    ]),
    "keyed": ("u", [
        'SetRowAttrs(s, "red", color="#f00")', 'Row(s="red")',
        'SetRowAttrs(s, "green", color="#0f0")', 'Row(s="green")',
        'Rows(s)', 'TopN(s, attrName="color", attrValue="#f00")',
        'SetColumnAttrs("user3", vip=true)', 'SetColumnAttrs("ghost", vip=1)',
        'Options(Row(s="red"), columnAttrs=true)',
        'Options(Row(s="blue"), columnAttrs=true, excludeColumns=true)',
        'SetRowAttrs(s, 1, color="#00f")', 'Row(s="blue")', "Row(s=1)",
    ]),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_attr_calls_match_reference(pair, script):
    """SetRowAttrs/SetColumnAttrs, the attrs on Row results, TopN's attr
    filter and Options(columnAttrs=) answer as the reference, and the
    stores hold the same afterwards."""
    jh, ph = pair
    index, calls = SCRIPTS[script]
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    for pql in calls:
        _same(jex, pex, index, pql)
    jidx, pidx = jh.index(index), ph.index(index)
    ids = list(range(0, 2 * SW, SW // 4)) + list(range(70))
    _same_store(jidx.column_attrs, pidx.column_attrs, ids)
    for name in pidx.fields:
        _same_store(jidx.field(name).row_attrs, pidx.field(name).row_attrs,
                    ids)


def test_row_attrs_are_read_at_submit(pair):
    """A pipelined Row keeps the attrs it had at submit, as the
    reference."""
    jh, ph = pair
    out = []
    for ex in (JExecutor(jh), Executor(ph, device="cpu")):
        ex.execute("i", 'SetRowAttrs(f, 2, v="before")')
        (d,) = ex.submit("i", "Row(f=2)")
        ex.execute("i", 'SetRowAttrs(f, 2, v="after")')
        out.append(d.result().attrs)
    assert out[1] == out[0] == {"v": "before"}


# ------------------------------------------------------------------ HTTP


def _request(base: str, path: str, body: bytes):
    r = urllib.request.Request(base + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


HTTP = [
    ("/index/i/query", b'SetRowAttrs(f, 1, name="a") SetColumnAttrs(3, z=1)'),
    ("/index/i/query?columnAttrs=true", b"Row(f=1) Count(Row(f=1))"),
    ("/index/i/query?excludeRowAttrs=true", b"Row(f=1) Row(f=2)"),
    ("/index/i/query?excludeColumns=true", b"Row(f=1) TopN(f, n=2)"),
    ("/index/i/query?columnAttrs=true&excludeRowAttrs=true"
     "&excludeColumns=true", b"Row(f=1)"),
    ("/index/i/query?columnAttrs=1", b"Row(f=1)"),
    ("/index/i/query?excludeRowAttrs=true",
     b"Options(Row(f=1), columnAttrs=true)"),
    ("/index/u/query", b'SetRowAttrs(s, "red", c=1) SetColumnAttrs("user5", '
                       b'k="v")'),
    ("/index/u/query?columnAttrs=true", b'Row(s="red")'),
    ("/index/u/query?excludeRowAttrs=true&columnAttrs=true",
     b'Row(s="red") Row(s="blue")'),
    ("/index/u/query?excludeColumns=true", b'Row(s="red")'),
    ("/index/nope/query?columnAttrs=true", b"Row(f=1)"),
    ("/index/i/query", b'TopN(f, attrName="name", attrValue="a")'),
]


def test_http_attr_bodies_match_reference(seed_dir, tmp_path):
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
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


def test_request_options_apply_to_every_row_result(pair):
    """API.query_raw with the request's options, as the reference's."""
    jh, ph = pair
    opts = {"columnAttrs": True, "excludeRowAttrs": True}
    pql = "SetRowAttrs(f, 1, a=1) SetColumnAttrs(5, b=2)"
    JAPI(jh).query_raw("i", pql)
    API(ph).query_raw("i", pql)
    want = j_result_to_json(JAPI(jh).query_raw("i", "Row(f=1) Row(f=2)",
                                               opts=opts))
    got = result_to_json(API(ph).query_raw("i", "Row(f=1) Row(f=2)",
                                           opts=opts))
    assert json.dumps(got) == json.dumps(want)

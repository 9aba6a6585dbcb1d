"""BSI int fields, Shift and Not/All: the port against pilosa_tpu on the CPU.

Kernel level: each new kernel's plain version (the wrapper on a CPU
tensor) against the JAX function it replaces. Executor and HTTP level:
both packages on copies of one data directory, compared by
``result_to_json`` bytes, before and after int-field writes, and each
package reading the other's files. Inputs are numpy words from a seed;
tolerance 0 throughout (integers).
"""

import json
import shutil
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor import batch as jbatch
from pilosa_tpu.executor import expr as jexpr
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.ops.bitops import shift as jshift
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import (
    Executor,
    PQLError,
    batch,
    expr,
    result_to_json,
)
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense

torch.set_num_threads(1)

W = 32768
SHARDS = 3  # not a power of two: the stacked leaves carry a zero slot
FARE_MIN, FARE_MAX = -50, 1000  # negative min: the offset encoding works
FARE_DEPTH = (FARE_MAX - FARE_MIN).bit_length()


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, shape, bit31=True) -> np.ndarray:
    """Random words; with ``bit31`` every eighth word has bit 31 set (a
    negative int32)."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    if bit31:
        w.reshape(-1)[::8] |= np.uint32(1 << 31)
    return w


def _planes(rng, n_shards: int, depth: int, density: float = 0.5,
            padded: int | None = None) -> np.ndarray:
    """uint32[padded, 2 + depth, W]: exists, a zero sign row, random bit
    planes under exists; padding slots stay zero."""
    padded = padded or n_shards
    out = np.zeros((padded, 2 + depth, W), np.uint32)
    exists = np.packbits(rng.random((n_shards, W * 32)) < density, axis=1,
                         bitorder="little").view("<u4")
    exists[:, ::8] |= np.uint32(1 << 31)
    out[:n_shards, 0] = exists
    out[:n_shards, 2:] = _words(rng, (n_shards, depth, W)) & exists[:, None]
    return out


# ------------------------------------------------------------------ kernels


SHIFTS = [0, 1, -1, 31, -31, 32, -32, 33, -33, W * 32 - 1, -(W * 32 - 1),
          1 << 20, -(1 << 20), (1 << 20) + 5, -(1 << 20) + 5]


@pytest.mark.parametrize("n", SHIFTS)
def test_row_shift_plain_matches_reference_shift(n):
    words = _words(np.random.default_rng(abs(n) % 97), (SHARDS, W))
    want = np.asarray(jshift(words, n))
    got = kernels.row_shift(_t(words), n)
    assert got.dtype == torch.int32
    assert np.array_equal(_u(got), want)


@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "==", "!="])
def test_bsi_compare_plain_matches_reference(op):
    rng = np.random.default_rng(3)
    depth = 7
    planes = _planes(rng, 3, depth, padded=4)
    exists = planes[:, 0].copy()
    for pred in (0, 1, 77, (1 << depth) - 1):
        want = np.asarray(jax.vmap(
            lambda p, e: jexpr._bsi_compare(op, p, e, jnp.int32(pred)))(
                planes, exists))
        got = kernels.bsi_compare(_t(planes), _t(exists), op, pred)
        assert np.array_equal(_u(got), want), pred


def _filter_rows(rng, planes, empty_shards=()):
    filt = _words(rng, planes[:, 0].shape)
    for s in empty_shards:
        filt[s] = 0
    return filt


@pytest.mark.parametrize("filtered", [False, True])
def test_bsi_sum_plain_matches_reference(filtered):
    rng = np.random.default_rng(5)
    planes = _planes(rng, 3, 9, padded=4)
    leaves = [planes]
    filt_node = None
    if filtered:
        leaves.append(_filter_rows(rng, planes, empty_shards=(1,)))
        filt_node = ("leaf", 1)
    structure = ("bsisum", 0, filt_node)
    ranks = tuple(x.ndim - 1 for x in leaves)
    want = np.asarray(jbatch.local_fn(structure, "bsisum", ranks, 0)(*leaves))
    got = batch.local_fn(structure, "bsisum", ranks)(*[_t(x) for x in leaves])
    assert want.shape == (2, 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("want_max", [0, 1])
@pytest.mark.parametrize("empty", [(), (0, 2), (0, 1, 2)])
def test_bsi_minmax_plain_and_merge_match_reference(want_max, empty):
    rng = np.random.default_rng(7 + want_max)
    planes = _planes(rng, 3, 10, density=0.001, padded=4)
    filt = _filter_rows(rng, planes, empty_shards=empty)
    kind = "max" if want_max else "min"
    for structure, leaves in [
        (("bsiminmax", want_max, 0, None), [planes]),
        (("bsiminmax", want_max, 0, ("leaf", 1)), [planes, filt]),
    ]:
        ranks = tuple(x.ndim - 1 for x in leaves)
        want = np.asarray(jbatch.local_fn(structure, kind, ranks, 0)(*leaves))
        got = batch.local_fn(structure, kind, ranks)(*[_t(x) for x in leaves])
        assert np.array_equal(got.numpy(), want), structure
    # the per-shard walk itself: nonempty is per shard, not global
    values, counts = kernels.bsi_minmax(_t(planes), _t(filt), bool(want_max))
    want_v, want_n = jax.vmap(
        lambda p, f: jexpr._bsi_minmax(bool(want_max), p, p[0] & f))(
            planes, filt)
    assert np.array_equal(counts.numpy(), np.asarray(want_n))
    live = np.asarray(want_n) > 0
    assert np.array_equal(values.numpy()[live], np.asarray(want_v)[live])


PLANNED = [
    ("shift", ("leaf", 0), 0),
    ("and", ("shift", ("or", ("leaf", 0), ("leaf", 1)), 0), ("leaf", 1)),
    ("bsicmp", ">", 2, ("leaf", 1), 1),
    ("diff", ("shift", ("bsicmp", "<=", 2, ("leaf", 0), 1), 0),
     ("bsicmp", "==", 2, ("leaf", 1), 1)),
    ("flipall", ("leaf", 1)),
]


@pytest.mark.parametrize("i", range(len(PLANNED)))
def test_planned_trees_match_reference_local_fn(i):
    """Shift / bsicmp lifted out as steps (K4 / K5), the rest through
    K1 / K2: the same rows, and the same counts, as the reference's one
    fused program."""
    tree = PLANNED[i]
    rng = np.random.default_rng(11 + i)
    planes = _planes(rng, 3, 8, padded=4)
    rows = [_words(rng, (4, W)), planes[:, 0].copy()]
    for r in rows:
        r[3] = 0  # the padding slot
    leaves = rows + [planes]
    ranks = (1, 1, 2)
    scalars = (-37, 100)
    tl = [_t(x) for x in leaves]
    want_rows = np.asarray(jbatch.local_fn(tree, "row", ranks, 2)(
        *leaves, *scalars))
    got_rows = batch.local_fn(tree, "row", ranks, 2)(*tl, *scalars)
    assert np.array_equal(_u(got_rows)[:3], want_rows[:3])
    assert np.array_equal(_u(expr.evaluate(tree, tl, scalars))[:3],
                          want_rows[:3])
    if tree[0] == "flipall":
        return  # a count of flipall would count the padding slot's ones
    want = np.asarray(jbatch.local_fn(("count", tree), "count", ranks, 2)(
        *leaves, *scalars))
    got = batch.local_fn(("count", tree), "count", ranks, 2)(*tl, *scalars)
    assert int(batch.merge_split(got.numpy())) == \
        int(jbatch.merge_split(want))


# ------------------------------------------------------- executors, HTTP


def _fare_planes(rng, cols: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Plane words of ``values`` at ``cols`` over SHARDS shards."""
    n = SHARDS * W * 32
    stored = (values - FARE_MIN).astype(np.uint64)
    planes = np.zeros((2 + FARE_DEPTH, n // 32), np.uint32)
    bits = np.zeros(n, bool)
    bits[cols] = True
    planes[0] = np.packbits(bits, bitorder="little").view("<u4")
    for i in range(FARE_DEPTH):
        bits[:] = False
        bits[cols[((stored >> np.uint64(i)) & np.uint64(1)) == 1]] = True
        planes[2 + i] = np.packbits(bits, bitorder="little").view("<u4")
    return planes


def _row(rng, density: float) -> np.ndarray:
    bits = rng.random(SHARDS * W * 32) < density
    return np.packbits(bits, bitorder="little").view("<u4")


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    rng = np.random.default_rng(2026)
    cols = np.sort(rng.choice(SHARDS * W * 32, 40_000, replace=False))
    values = rng.integers(FARE_MIN, FARE_MAX + 1, cols.size)
    path = tmp_path_factory.mktemp("bsi") / "data"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": {1: _row(rng, 0.01), 2: _row(rng, 0.02)},
                        "g": {7: _row(rng, 0.015)}}, index="i",
                    int_fields={"fare": (FARE_MIN, FARE_MAX,
                                         _fare_planes(rng, cols, values))})
    h.close()
    return path


def _open_pair(seed_dir, tmp_path):
    """(reference holder, port holder) on copies of the seed dir."""
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    return (jstorage.Holder(str(tmp_path / "jax")).open(),
            Holder(str(tmp_path / "port"), device="cpu").open())


@pytest.fixture
def pair(seed_dir, tmp_path):
    jh, ph = _open_pair(seed_dir, tmp_path)
    yield jh, ph
    jh.close()
    ph.close()


CORPUS = DRYRUN_QUERY_SHAPES[4:10] + [DRYRUN_QUERY_SHAPES[15]] + [
    "Count(Row(fare >< [0, 100]))",
    "Count(Row(fare >< [500, 100]))",
    "Row(fare == 17)",
    "Count(Row(fare != 17))",
    "Count(Range(fare <= -50))",
    "Count(Range(fare >= 1000))",
    "Count(Row(fare < 10.5)) Count(Row(fare > 10.5))",
    "Count(Row(fare == 10.5)) Count(Row(fare != 10.5))",
    "Count(Row(fare > 5000)) Count(Row(fare < 5000))",
    "Count(Row(fare < -5000)) Count(Row(fare >= -5000))",
    "Count(Shift(Row(f=1), n=-1))",
    "Count(Shift(Row(g=7), n=-33))",
    "Shift(Row(f=1), n=1048000)",
    "Count(All())",
    "Count(Not(Union(Row(f=1), Row(g=7))))",
    'Min(Row(f=99), field="fare")',
    'Max(Row(fare < 0), field="fare")',
    'Sum(Shift(Row(f=1), n=3), field="fare")',
    'Min(Row(fare > 990), field="fare")',
    "Count(Intersect(Row(fare > 500), Shift(Row(fare < 100), n=1)))",
]


def _json(to_json, results) -> bytes:
    return json.dumps(to_json(results)).encode()


def _assert_corpus_matches(jex, pex):
    for pql in CORPUS:
        want = _json(j_result_to_json, jex.execute("i", pql))
        got = _json(result_to_json, pex.execute("i", pql))
        assert got == want, pql


def test_bsi_shift_not_corpus_matches_reference(pair):
    jh, ph = pair
    _assert_corpus_matches(JExecutor(jh), Executor(ph, device="cpu"))


def test_int_writes_and_import_value_match_reference(seed_dir, tmp_path):
    jh, ph = _open_pair(seed_dir, tmp_path)
    try:
        _writes_then_corpus(jh, ph)
    finally:
        jh.close()
        ph.close()
    # each package reads the other's int-field files after close
    j2 = jstorage.Holder(str(tmp_path / "port")).open()
    p2 = Holder(str(tmp_path / "jax"), device="cpu").open()
    try:
        _assert_corpus_matches(JExecutor(j2), Executor(p2, device="cpu"))
    finally:
        j2.close()
        p2.close()


def _writes_then_corpus(jh, ph):
    japi, papi = JAPI(jh), API(ph)
    jex, pex = JExecutor(jh), papi.executor
    _assert_corpus_matches(jex, pex)  # leaves resident before the writes
    fare = ph.index("i").field("fare").view("bsig_fare").fragment(1)
    stored_col = W * 32 + int(np.flatnonzero(
        np.unpackbits(fare.row_words(0).view(np.uint8),
                      bitorder="little"))[0])
    script = [
        "Set(5, fare=-50) Set(5, fare=-50) Set(2097155, fare=1000)",
        f"Set({stored_col}, fare=3) Clear({stored_col + 1}, fare=0)",
        f"Clear({stored_col}, fare=0) Clear({stored_col}, fare=0)",
    ]
    for pql in script:
        want = _json(j_result_to_json, jex.execute("i", pql))
        assert _json(result_to_json, pex.execute("i", pql)) == want, pql
    with pytest.raises(ValueError) as want_e:
        jex.execute("i", "Set(77, fare=1001)")
    with pytest.raises(PQLError) as got_e:
        pex.execute("i", "Set(77, fare=1001)")
    assert str(got_e.value) == str(want_e.value)
    cols = [9, 1048576 + 3, 9, 2 * 1048576 + 8, 5, 12]
    vals = [1, 2, 3, -50, 999, 1000]  # column 9 twice: the last value stays
    assert papi.import_values("i", "fare", cols, vals) == \
        japi.import_values("i", "fare", cols, vals) == 5
    assert papi.import_values("i", "fare", cols, vals) == \
        japi.import_values("i", "fare", cols, vals) == 0
    assert ph.index("i").field("fare").value(9) == (3, True)
    _assert_corpus_matches(jex, pex)


def test_submit_then_set_value_reads_the_pre_write_planes(pair):
    """A BSI comparison computed at submit sees the planes as they were,
    as the reference's functional patches do."""
    _, ph = pair
    pex = Executor(ph, device="cpu")
    pql = "Count(Row(fare > 900))"
    before = pex.execute("i", pql)[0]
    pending = pex.submit("i", pql)[0]
    assert pex.execute("i", "Set(6, fare=950)") == [True]
    assert pending.result() == before
    assert pex.execute("i", pql)[0] == before + 1


WIDE_FIELDS = [
    # (max, values): a 41-bit field holding 2^40, 5 and 3e9, and a
    # 63-bit one holding values on both sides of 2^62 and 2^32
    (1 << 40, [1 << 40, 5, 3_000_000_000]),
    ((1 << 63) - 1, [(1 << 63) - 1, (1 << 62) + 7, 1 << 32, 12, 0]),
]


@pytest.mark.parametrize("fmax, values", WIDE_FIELDS)
@pytest.mark.parametrize("filtered", [False, True])
def test_wide_int_field_sums_and_refuses_min_max(pair, fmax, values,
                                                 filtered):
    """Sum, Min and Max on int fields past 31 bit planes, held against a
    Python-int oracle. (The port refused Min/Max here before K7 took 64
    bits. The reference is not the oracle: it accumulates the extremum in
    int32 and wraps past 31 planes, so it answers these wrongly.)"""
    _, ph = pair
    pex = Executor(ph, device="cpu")
    ph.index("i").create_field("wide", FieldOptions(type="int", min=0,
                                                    max=fmax))
    cols = [3 + 1048576 * (k % SHARDS) + 11 * k for k in range(len(values))]
    for c, v in zip(cols, values):
        assert pex.execute("i", f"Set({c}, wide={v})") == [True]
    f_row = ph.index("i").field("f")
    filt = "Row(f=1)"
    if filtered:  # keep the first and the last column in the filter only
        for c in cols:
            f_row.clear_bit(1, c)
        for c in (cols[0], cols[-1]):
            f_row.set_bit(1, c)
        values = [values[0], values[-1]]
    args = f'{filt}, field="wide"' if filtered else 'field="wide"'
    want = {"Sum": sum(values), "Min": min(values), "Max": max(values)}
    for name, v in want.items():
        n = len(values) if name == "Sum" else values.count(v)
        assert result_to_json(pex.execute("i", f"{name}({args})")[0]) == \
            {"value": v, "count": n}, name


def _request(base: str, path: str, body: bytes, ctype="application/json"):
    r = urllib.request.Request(base + path, data=body, method="POST")
    r.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def servers(seed_dir, tmp_path):
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    yield f"http://localhost:{jport}", f"http://localhost:{port.port}"
    jserver.shutdown()
    jserver.server_close()
    jh.close()
    port.close()


HTTP_REQUESTS = [
    ("/index/i/field/tip", b'{"options": {"type": "int", "min": 0, '
                           b'"max": 100000}}'),
    ("/index/i/field/bad", b'{"options": {"type": "int", "min": 5, '
                           b'"max": 1}}'),                         # 400
    ("/index/i/field/tip/import-value",
     b'{"columns": [1, 2, 1048577, 2], "values": [10, 20, 30, 40]}'),
    ("/index/i/field/tip/import-value",
     b'{"columns": [1, 3], "values": [10, 100001]}'),              # 400
    ("/index/i/field/tip/import-value",
     b'{"columns": [1, -3], "values": [10, 1]}'),                  # 400
    ("/index/i/field/tip/import-value",
     b'{"columns": [1, 3], "values": [10]}'),                      # 400
    ("/index/i/field/f/import-value",
     b'{"columns": [1], "values": [10]}'),                         # 400
    ("/index/i/field/nope/import-value",
     b'{"columns": [1], "values": [10]}'),                         # 404
    ("/index/i/query", b'Sum(field="tip") Min(field="tip") '
                       b'Max(Row(tip < 35), field="tip")'),
    ("/index/i/query", b"Count(Range(tip >= 20)) Row(tip >< [15, 35])"),
    ("/index/i/query", b'Set(4, tip=7) Clear(2, tip=0) Sum(field="tip")'),
    ("/index/i/query", b"Count(Shift(Row(f=1), n=2)) Count(Not(Row(f=2)))"),
    ("/index/i/query", b"Count(All()) Row(fare > 995)"),
    ("/index/i/query", b'Sum(Row(fare > 10), field="fare")'),
    ("/index/i/query", b"Count(Row(f > 3))"),                      # 400
    ("/index/i/query", b"Set(8, tip=-1)"),                         # 400
]


def test_http_int_field_bodies_match_reference(servers):
    jbase, pbase = servers
    for path, body in HTTP_REQUESTS:
        want = _request(jbase, path, body)
        got = _request(pbase, path, body)
        assert got == want, (path, body)
    # protobuf import-value bodies: the reference's answer, a truncated
    # message's too, and the values land as the reference's do
    from pilosa_tpu_torch.wire.serializer import encode_import_value_request

    for body in (b"\x0a\x01",
                 encode_import_value_request("i", "tip", [6, 1048579],
                                             [55, 66]),
                 encode_import_value_request("i", "tip", [7], [100001])):
        want = _request(jbase, "/index/i/field/tip/import-value", body,
                        ctype="application/x-protobuf")
        got = _request(pbase, "/index/i/field/tip/import-value", body,
                       ctype="application/x-protobuf")
        assert got == want, body
    assert _request(pbase, "/index/i/query", b'Sum(field="tip")') == \
        _request(jbase, "/index/i/query", b'Sum(field="tip")')

"""TopN, Rows, GroupBy, IncludesColumn and Options: the port against
pilosa_tpu on the CPU.

Kernel level: K8's and K9's plain versions (the wrappers on CPU tensors)
against the JAX functions they replace (the 'countrows' node and the
GroupBy level program). Executor and HTTP level: both packages on copies
of one data directory, compared by ``result_to_json`` bytes, on the dense
and the pruned GroupBy paths, before and after writes and an import.
Inputs are numpy words from a seed; tolerance 0 throughout (integers).
"""

import json
import shutil

import numpy as np
import pytest
import torch

import pilosa_tpu.executor.executor as jexecutor_mod
import pilosa_tpu.storage as jstorage
from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor import batch as jbatch
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import Executor, PQLError, batch, expr
from pilosa_tpu_torch.executor import executor as executor_mod
from pilosa_tpu_torch.executor import result_to_json
from pilosa_tpu_torch.roaring import RoaringBitmap
from pilosa_tpu_torch.roaring.bitmap import Container
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense
from pilosa_tpu_torch.storage.load import canonical_containers

torch.set_num_threads(1)

W = 32768
SHARDS = 3  # not a power of two: the stacked leaves carry a zero slot
FARE_MIN, FARE_MAX = -50, 1000  # negative min: the offset encoding works
FARE_DEPTH = (FARE_MAX - FARE_MIN).bit_length()


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))


def _words(rng, shape) -> np.ndarray:
    """Random words, bit 31 set in every eighth (a negative int32)."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    w.reshape(-1)[::8] |= np.uint32(1 << 31)
    return w


# ------------------------------------------------------------------ kernels


COUNTROWS_FILTERS = [
    (None, 0),
    (("leaf", 1), 0),
    (("or", ("leaf", 1), ("diff", ("leaf", 2), ("leaf", 1))), 0),
    (("and", ("shift", ("leaf", 1), 0), ("leaf", 2)), 1),  # a K4 step
]


@pytest.mark.parametrize("i", range(len(COUNTROWS_FILTERS)))
def test_count_rows_plain_matches_reference_countrows(i):
    """K8 (through the 'countrows' plan) against the reference's
    countrows program: zero pad rows, a zero padding slot, filters from
    a bare leaf to a tree with a shift step."""
    filt, n_scalars = COUNTROWS_FILTERS[i]
    rng = np.random.default_rng(30 + i)
    matrix = _words(rng, (4, 8, W))
    matrix[:, 5:] = 0  # zero pad rows, as TopN pads a chunk
    rows = [_words(rng, (4, W)) for _ in range(2)]
    for x in (matrix, *rows):
        x[3] = 0  # the padding slot
    leaves = [matrix, *rows]
    structure = ("countrows", 0, filt)
    ranks = tuple(x.ndim - 1 for x in leaves)
    scalars = (-37,)[:n_scalars]
    want = np.asarray(jbatch.local_fn(structure, "countrows", ranks,
                                      n_scalars)(*leaves, *scalars))
    got = batch.local_fn(structure, "countrows", ranks, n_scalars)(
        *[_t(x) for x in leaves], *scalars)
    assert want.shape == (2, 8)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(batch.merge_split(got.numpy())[5:], [0, 0, 0])
    per_shard = expr.evaluate(structure, [_t(x) for x in leaves], scalars)
    assert per_shard.shape == (4, 8)
    assert np.array_equal(batch.split_sum(per_shard, dim=0).numpy(), want)


def test_count_rows_wrapper_checks_shapes():
    m = torch.zeros((2, 3, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.count_rows(m, torch.zeros((2, 63), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.count_rows(m[0])
    assert kernels.count_rows(m).shape == (2, 3)


def _planes(rng, n_shards: int, depth: int, padded: int) -> np.ndarray:
    """uint32[padded, 2 + depth, W]: exists, a zero sign row, random bit
    planes under exists; padding slots stay zero."""
    out = np.zeros((padded, 2 + depth, W), np.uint32)
    exists = _words(rng, (n_shards, W)) | _words(rng, (n_shards, W))
    out[:n_shards, 0] = exists
    out[:n_shards, 2:] = _words(rng, (n_shards, depth, W)) & exists[:, None]
    return out


GROUPBY_LEVELS = [  # (dimension sizes, filter structure, aggregate)
    ((5,), None, False),
    ((5,), None, True),
    ((3, 4), ("leaf", 0), False),
    ((3, 4), ("and", ("leaf", 0), ("leaf", 1)), True),
    ((2, 3, 2), None, False),
    ((2, 3, 2), ("or", ("shift", ("leaf", 0), 0), ("leaf", 1)), True),
]


@pytest.mark.parametrize("i", range(len(GROUPBY_LEVELS)))
def test_groupby_level_plain_matches_reference(i):
    """K9 (plain) plus the port's split sums against the reference's
    local_groupby_level_fn: 1-3 dimensions, candidate indices padded to a
    power of two with index 0 as the reference pads them, with and
    without a filter and planes."""
    sizes, filt, has_agg = GROUPBY_LEVELS[i]
    rng = np.random.default_rng(40 + i)
    dims = [_words(rng, (4, n, W)) for n in sizes]
    filt_leaves = [_words(rng, (4, W)) for _ in range(2)] if filt else []
    for x in (*dims, *filt_leaves):
        x[3] = 0  # the padding slot
    planes = [_planes(rng, 3, 7, padded=4)] if has_agg else []
    cand = np.zeros((1, 0), np.int32)
    for n in sizes:
        cand = executor_mod._index_cross(cand, n)
    pad = int(2 ** np.ceil(np.log2(cand.shape[0]))) - cand.shape[0]
    cand = np.concatenate([cand, np.zeros((pad, len(sizes)), np.int32)])
    idxs = [np.ascontiguousarray(cand[:, d]) for d in range(len(sizes))]
    n_scalars = 1 if filt is not None and "shift" in str(filt) else 0
    scalars = (5,)[:n_scalars]
    args = [*filt_leaves, *dims, *planes]
    want = np.asarray(jbatch.local_groupby_level_fn(
        filt, len(filt_leaves), n_scalars, len(sizes), has_agg)(
            *args, *idxs, *scalars))
    got = batch.local_groupby_level_fn(
        filt, len(filt_leaves), n_scalars, len(sizes), has_agg)(
            *[_t(x) for x in args], *idxs, *scalars)
    c = cand.shape[0]
    assert want.shape == ((2 + 2 + 2 * 7) * c if has_agg else 2 * c,)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_groupby_level_wrapper_checks_its_arguments():
    d = torch.zeros((2, 3, 64), dtype=torch.int32)
    with pytest.raises(IndexError):
        kernels.groupby_level([d], [np.array([0, 3])])
    with pytest.raises(ValueError):
        kernels.groupby_level([d, d], [np.array([0]), np.array([0, 1])])
    with pytest.raises(ValueError):
        kernels.groupby_level([d] * (kernels.MAX_LEAVES + 1),
                              [np.array([0])] * (kernels.MAX_LEAVES + 1))
    out = kernels.groupby_level([d], [np.array([0, 2, 1])])
    assert out.shape == (2, 1, 3)


# ------------------------------------------------------------------ storage


def test_roaring_drops_emptied_containers_and_row_counts_follow(tmp_path):
    """Rows() lists a row from its containers: clearing a row's last bit
    must drop the container, so the row leaves row_counts and top."""
    bm = RoaringBitmap()
    bm.add_ids([(7 << 20) + 5, (9 << 20) + 70000])
    bm.remove_ids([(7 << 20) + 5])
    assert bm.keys == [(9 << 20) + 70000 >> 16]
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    try:
        f = h.create_index("i").create_field("f")
        f.set_bit(7, 5)
        f.set_bit(9, 5)
        f.set_bit(9, 70000)
        frag = f.view("standard").fragment(0)
        assert frag.row_counts()[0].tolist() == [7, 9]
        assert frag.top() == [(9, 2), (7, 1)]
        f.clear_bit(7, 5)
        rows, counts = frag.row_counts()
        assert rows.tolist() == [9] and counts.tolist() == [2]
        assert frag.top(1) == [(9, 2)]
        assert frag.rows_containing(5) == [9]
    finally:
        h.close()


def test_dense_load_picks_the_containers_from_lows_picks():
    """The bulk loader decides each container's form from its words; the
    result equals ``Container.from_lows`` on the same bits (array, run
    and bitmap forms, bit 31 set), and ``dense_words32`` gives the words
    back."""
    rng = np.random.default_rng(50)
    blocks = [np.packbits(rng.random((2, 65536)) < d, axis=1,
                          bitorder="little").view("<u4")
              for d in (0, 1e-4, 0.01, 0.06, 0.5)]
    runs = np.zeros((3, 65536), bool)
    runs[0, 100:5000] = True
    runs[1, ::2] = True
    runs[2, 65500:] = True
    blocks.append(np.packbits(runs, axis=1, bitorder="little").view("<u4"))
    words = np.concatenate(blocks)
    words[3, ::5] |= np.uint32(1 << 31)
    got = canonical_containers(words)
    kinds = set()
    for w, c in zip(words, got):
        lows = np.flatnonzero(np.unpackbits(w.view(np.uint8),
                                            bitorder="little"))
        if lows.size == 0:
            assert c is None
            continue
        want = Container.from_lows(lows.astype(np.uint16))
        assert (c.kind, c.n) == (want.kind, want.n)
        assert np.array_equal(c.data, want.data)
        assert np.array_equal(c.dense_words32(), w)
        kinds.add(c.kind)
    assert len(kinds) == 3


# ------------------------------------------------------- executors, HTTP


def _row(rng, density: float) -> np.ndarray:
    bits = rng.random(SHARDS * W * 32) < density
    return np.packbits(bits, bitorder="little").view("<u4")


def _sparse(rng, n: int) -> np.ndarray:
    cols = rng.choice(SHARDS * W * 32, n, replace=False)
    bits = np.zeros(SHARDS * W * 32, bool)
    bits[cols] = True
    return np.packbits(bits, bitorder="little").view("<u4")


def _fare_planes(cols: np.ndarray, values: np.ndarray) -> np.ndarray:
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


LONE_COL = 2 * W * 32 + 12345  # the only bit of row f=20


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    rng = np.random.default_rng(2027)
    f = {r: _row(rng, d) for r, d in zip(
        (0, 1, 2, 3, 4, 6, 7, 8),
        (0.004, 0.01, 0.02, 0.007, 0.012, 0.003, 0.009, 0.006))}
    f[5] = _sparse(rng, 30)  # under TopN's threshold=40
    f[9] = f[8].copy()       # a tie: ordered by row id
    lone = np.zeros(SHARDS * W, np.uint32)
    lone[LONE_COL >> 5] = np.uint32(1) << np.uint32(LONE_COL & 31)
    f[20] = lone
    g = {1: _row(rng, 0.3), 2: _row(rng, 0.05), 3: _sparse(rng, 12),
         7: _row(rng, 0.015)}
    cols = np.sort(rng.choice(SHARDS * W * 32, 60_000, replace=False))
    values = rng.integers(FARE_MIN, FARE_MAX + 1, cols.size)
    path = tmp_path_factory.mktemp("topn") / "data"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": f, "g": g}, index="i",
                    int_fields={"fare": (FARE_MIN, FARE_MAX,
                                         _fare_planes(cols, values))})
    h.index("i").create_field("h")  # a dimension without rows
    h.create_index("e").create_field("f")  # an index without shards
    h.close()
    return path


def _probe(seed_dir) -> tuple[int, int]:
    """(a column of f=1, a column outside f=1), both in shard 1."""
    h = Holder(str(seed_dir), device="cpu").open()
    try:
        words = h.index("i").field("f").view("standard").fragment(1).row_words(1)
    finally:
        h.close()
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return (W * 32 + int(np.flatnonzero(bits)[0]),
            W * 32 + int(np.flatnonzero(bits == 0)[0]))


def _reference_holder(path) -> "jstorage.Holder":
    """The reference's holder on ``path``, as it opens (verifying the
    port's .checksums sidecars, reading its .cache row caches: no
    recount is needed first)."""
    return jstorage.Holder(str(path)).open()


def _open_pair(seed_dir, tmp_path):
    """(reference holder, port holder) on copies of the seed dir."""
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    return (_reference_holder(tmp_path / "jax"),
            Holder(str(tmp_path / "port"), device="cpu").open())


@pytest.fixture
def pair(seed_dir, tmp_path):
    jh, ph = _open_pair(seed_dir, tmp_path)
    yield jh, ph
    jh.close()
    ph.close()


EXTRA = [
    "TopN(f, Row(g=7), n=3)",
    "TopN(f, ids=[1, 3, 5, 20, 99])",
    "TopN(f, n=0)",
    "TopN(f, n=3, threshold=1000000)",
    "TopN(g) TopN(h)",
    "TopN(f, Intersect(Row(g=1), Row(fare > 500)), n=4)",
    "Rows(f, previous=1)",
    "Rows(f, column={probe})",
    "Rows(f, previous=3, limit=2) Rows(h) Rows(g, column={absent})",
    "GroupBy(Rows(f), Rows(g), filter=Row(g=7))",
    "GroupBy(Rows(f), Rows(g), limit=3)",
    'GroupBy(Rows(f), aggregate=Sum(field="fare"), '
    "having=Condition(sum > 100000))",
    'GroupBy(Rows(g), aggregate=Sum(field="fare"), having=Condition(count < 20))',
    "GroupBy(Rows(f), Rows(h))",
    "GroupBy(Rows(g), Rows(f, previous=2), Rows(g, limit=2), "
    "filter=Intersect(Row(f=1), Shift(Row(g=7), n=1)))",
    'GroupBy(Rows(f), Rows(g, limit=3), filter=Row(fare > 500), '
    'aggregate=Sum(field="fare"))',
    "IncludesColumn(Row(f=1), column={absent})",
    "IncludesColumn(Union(Row(f=2), Row(g=7)), column={probe})",
    "Options(TopN(f, n=3), shards=[0, 2])",
    "Options(GroupBy(Rows(g)), shards=[1])",
    "Options(Row(f=5), excludeColumns=true)",
    "Options(IncludesColumn(Row(f=1), column={probe}), shards=[0])",
    "Options(Rows(f), shards=[2])",
    'Options(GroupBy(Rows(f), Rows(g), aggregate=Sum(field="fare")), '
    "shards=[0, 1])",
]


def _corpus(seed_dir) -> list:
    probe, absent = _probe(seed_dir)
    shapes = DRYRUN_QUERY_SHAPES[10:14] + DRYRUN_QUERY_SHAPES[16:20] + EXTRA
    return [q.format(probe=probe, absent=absent) for q in shapes]


def _json(to_json, results) -> bytes:
    return json.dumps(to_json(results)).encode()


def _assert_corpus_matches(jex, pex, corpus, execute: bool = False):
    """Each query through the port's pipelined path (``submit``, as the
    server reads), and with ``execute`` through ``execute`` too."""
    for pql in corpus:
        want = _json(j_result_to_json, jex.execute("i", pql))
        got = _json(result_to_json, [d.result() for d in pex.submit("i", pql)])
        assert got == want, pql
        if execute:
            assert _json(result_to_json, pex.execute("i", pql)) == want, pql


def _max_groups(monkeypatch, n: int) -> None:
    """GroupBy's dense threshold in both packages (read at call time)."""
    monkeypatch.setattr(jexecutor_mod, "GROUPBY_DENSE_MAX_GROUPS", n)
    monkeypatch.setattr(executor_mod, "GROUPBY_DENSE_MAX_GROUPS", n)


@pytest.mark.parametrize("max_groups", [4096, 8])
def test_topn_rows_groupby_corpus_matches_reference(pair, seed_dir,
                                                    monkeypatch, max_groups):
    _max_groups(monkeypatch, max_groups)
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    corpus = _corpus(seed_dir)
    _assert_corpus_matches(jex, pex, corpus, execute=max_groups == 8)
    assert pex.execute("e", "TopN(f) Rows(f) GroupBy(Rows(f))") == [[], [], []]
    assert pex.execute("i", "TopN(f, n=2)")[0][0].id == 2
    assert 20 in pex.execute("i", "Rows(f)")[0]


@pytest.mark.parametrize("max_groups", [4096, 8])
def test_writes_and_import_then_corpus_match_reference(seed_dir, tmp_path,
                                                       monkeypatch,
                                                       max_groups):
    _max_groups(monkeypatch, max_groups)
    jh, ph = _open_pair(seed_dir, tmp_path)
    try:
        japi, papi = JAPI(jh), API(ph)
        jex, pex = JExecutor(jh), papi.executor
        corpus = _corpus(seed_dir)
        _assert_corpus_matches(jex, pex, corpus)  # matrices resident first
        probe, absent = _probe(seed_dir)
        script = [
            f"Clear({LONE_COL}, f=20)",  # row 20 loses its last bit
            f"Set(5, f=7) Set(2097155, g=3) Set({absent}, f=30)",
            f"Clear({probe}, f=1) Set({probe}, f=6) Set({probe}, g=2)",
            "Set(6, fare=999) Set(7, fare=-50)",
        ]
        for pql in script:
            want = _json(j_result_to_json, jex.execute("i", pql))
            assert _json(result_to_json, pex.execute("i", pql)) == want, pql
        assert 20 not in pex.execute("i", "Rows(f)")[0]
        cols = [3, 4, 1048576 + 9, 2 * 1048576 + 1, 3]
        rows = [8, 8, 2, 40, 9]
        assert papi.import_bits("i", "f", rows, cols) == \
            japi.import_bits("i", "f", rows, cols)
        _assert_corpus_matches(jex, pex, corpus)
    finally:
        jh.close()
        ph.close()


def test_write_patches_resident_topn_matrix_in_place(pair):
    """A Set on a TopN candidate row patches the resident stacked matrix
    (K3's row form) instead of decoding it again."""
    _, ph = pair
    pex = Executor(ph, device="cpu")
    before = {p.id: p.count for p in pex.execute("i", "TopN(f, n=3)")[0]}
    misses = ph.cache.misses
    top = max(before, key=lambda r: (before[r], -r))
    view = ph.index("i").field("f").view("standard")
    col = next(c for c in range(SHARDS * W * 32)
               if not view.fragment(c >> 20).contains(top, c & (W * 32 - 1)))
    updates = ph.cache.updates
    assert pex.execute("i", f"Set({col}, f={top})") == [True]
    assert ph.cache.updates > updates
    after = {p.id: p.count for p in pex.execute("i", "TopN(f, n=3)")[0]}
    assert after[top] == before[top] + 1
    assert ph.cache.misses == misses


def test_groupby_refusals_match_reference(pair):
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    for pql in ["GroupBy(Row(f=1))",
                'GroupBy(Rows(f), aggregate=Min(field="fare"))',
                'GroupBy(Rows(f), aggregate=Sum(field="g"))',
                "GroupBy(Rows(f), having=Condition(sum > 3))",
                "GroupBy(Rows(f), having=Condition(count > x))",
                "IncludesColumn(Row(f=1))",
                "Options(Row(f=1), Row(g=7))"]:
        with pytest.raises(ValueError) as want:
            jex.execute("i", pql)
        with pytest.raises(PQLError) as got:
            pex.execute("i", pql)
        assert str(got.value) == str(want.value), pql
    # TopN's attribute filter answers (it was refused before row
    # attributes were ported)
    assert _json(result_to_json, pex.execute(
        "i", 'TopN(f, attrName="a", attrValue=1)')) == \
        _json(j_result_to_json, jex.execute(
            "i", 'TopN(f, attrName="a", attrValue=1)'))
    # past K9's 16 dimensions the port answers (it refused before the
    # prefix fold existed)
    dims = ", ".join(["Rows(g, limit=2)"] + ["Rows(g, limit=1)"]
                     * kernels.MAX_LEAVES)
    assert _json(result_to_json, pex.execute("i", f"GroupBy({dims})")) == \
        _json(j_result_to_json, jex.execute("i", f"GroupBy({dims})"))


def _wide_dims(n: int) -> str:
    """n GroupBy dimensions that stay cheap: at most 12 candidates a
    level, and row g=1 repeated (an AND with itself keeps it)."""
    head = ["Rows(f, limit=3)", "Rows(g, limit=2)",
            "Rows(g, previous=1, limit=2)"]
    return ", ".join(head + ["Rows(g, limit=1)"] * (n - len(head)))


WIDE_GROUPBY = [
    f"GroupBy({_wide_dims(17)})",
    f"GroupBy({_wide_dims(18)}, limit=5)",
    f"GroupBy({_wide_dims(18)}, having=Condition(count > 400))",
    f'GroupBy({_wide_dims(17)}, filter=Row(f=1), '
    'aggregate=Sum(field="fare"), having=Condition(sum > 0))',
    f"GroupBy({_wide_dims(17)}, Rows(h))",
]


@pytest.mark.parametrize("pql", WIDE_GROUPBY)
def test_groupby_past_sixteen_dimensions_matches_reference(pair, pql):
    jh, ph = pair
    assert _json(result_to_json, Executor(ph, device="cpu").execute(
        "i", pql)) == _json(j_result_to_json, JExecutor(jh).execute("i", pql))


@pytest.mark.parametrize("pql", [
    f'GroupBy({_wide_dims(18)}, aggregate=Sum(field="fare"))',
    f"GroupBy({_wide_dims(34)}, limit=7)",
])
def test_groupby_fold_chunks_match_reference(pair, monkeypatch, pql):
    """With the budget at two prefix groups' rows, the fold past 16
    dimensions runs chunk by chunk (and at 34 dimensions folds again
    inside each chunk); the groups concatenate as the reference's."""
    jh, ph = pair
    want = _json(j_result_to_json, JExecutor(jh).execute("i", pql))
    slots = SHARDS + 1  # the stacked matrices' zero slot
    monkeypatch.setattr(executor_mod, "GROUPBY_OUT_BUDGET_BYTES",
                        2 * slots * W * 4)
    folds = []
    fold = executor_mod._groupby_prefix_matrix
    monkeypatch.setattr(executor_mod, "_groupby_prefix_matrix",
                        lambda mats, cand: folds.append(len(cand)) or
                        fold(mats, cand))
    got = _json(result_to_json, Executor(ph, device="cpu").execute("i", pql))
    assert got == want
    assert len(folds) > 1 and max(folds) == 2


def test_groupby_level_chunks_concatenate_in_order(pair, monkeypatch):
    """A level split over several K9 chunks reads back as one."""
    jh, ph = pair
    pql = 'GroupBy(Rows(f), Rows(g), aggregate=Sum(field="fare"))'
    want = _json(j_result_to_json, JExecutor(jh).execute("i", pql))
    monkeypatch.setattr(executor_mod, "GROUPBY_OUT_BUDGET_BYTES",
                        7 * 4 * 4 * (2 + FARE_DEPTH))  # 7 candidates a chunk
    got = _json(result_to_json, Executor(ph, device="cpu").execute("i", pql))
    assert got == want


def _request(base: str, path: str, body: bytes):
    import urllib.error
    import urllib.request

    r = urllib.request.Request(base + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def servers(seed_dir, tmp_path):
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    jh = _reference_holder(tmp_path / "jax")
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    yield f"http://localhost:{jport}", f"http://localhost:{port.port}"
    jserver.shutdown()
    jserver.server_close()
    jh.close()
    port.close()


def test_http_topn_rows_groupby_bodies_match_reference(servers, seed_dir):
    jbase, pbase = servers
    probe, _ = _probe(seed_dir)
    bodies = [
        b"TopN(f, n=2) TopN(f, Row(g=7), n=3, threshold=40)",
        b"Rows(f) Rows(f, limit=2, previous=0)",
        b'GroupBy(Rows(f), Rows(g), aggregate=Sum(field="fare"), limit=5)',
        b"GroupBy(Rows(f), having=Condition(count > 40))",
        f"IncludesColumn(Row(f=1), column={probe}) "
        f"Options(TopN(g), shards=[0, 2])".encode(),
        f"Set({probe}, f=5) TopN(f, ids=[5]) Rows(f, column={probe})".encode(),
        b"TopN(nope)",                                    # 400
        b"GroupBy(Rows(f), having=Condition(sum > 1))",   # 400
    ]
    for body in bodies:
        want = _request(jbase, "/index/i/query", body)
        got = _request(pbase, "/index/i/query", body)
        assert got == want, body


def test_fragment_top_matches_reference_after_writes(pair):
    """Phase 1's candidates: the port's exact ranking equals the
    reference's, cold and after writes warm its ranked cache."""
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    for pql in ("", "Set(77, f=5) Clear(78, f=1) Set(3, f=9)"):
        if pql:
            jex.execute("i", pql)
            pex.execute("i", pql)
        for shard in range(SHARDS):
            jfrag = jh.index("i").field("f").view("standard").fragment(shard)
            pfrag = ph.index("i").field("f").view("standard").fragment(shard)
            for n in (0, 3, 40):
                assert pfrag.top(n) == [tuple(p) for p in jfrag.top(n)]


def test_topn_on_int_field_options_and_unknown_field(pair):
    jh, ph = pair
    jex, pex = JExecutor(jh), Executor(ph, device="cpu")
    ph.index("i").create_field("k", FieldOptions(type="set"))
    jh.index("i").create_field("k", jstorage.FieldOptions(type="set"))
    for pql in ("TopN(k)", "Rows(k)", "GroupBy(Rows(k), Rows(f))"):
        assert _json(result_to_json, pex.execute("i", pql)) == \
            _json(j_result_to_json, jex.execute("i", pql)), pql
    with pytest.raises(PQLError, match="not found"):
        pex.execute("i", "TopN(nope)")


# ------------------------------------------------- the row cache (C4, C5)


def _cached_pair(tmp_path, opts: dict):
    """Both packages' holders and executors on empty dirs, index ``i``
    with a field ``f`` of the given row-cache options and a filter
    field ``g``."""
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    ph = Holder(str(tmp_path / "port"), device="cpu").open()
    jidx, pidx = jh.create_index("i"), ph.create_index("i")
    jidx.create_field("f", jstorage.FieldOptions(**opts))
    pidx.create_field("f", FieldOptions(**opts))
    jidx.create_field("g")
    pidx.create_field("g")
    return jh, ph, JExecutor(jh), Executor(ph, device="cpu")


def _ladder_writes(counts: dict, shard: int = 0) -> str:
    """Sets giving row r ``counts[r]`` bits in ``shard``, every row's
    columns from the shard's start (so rows overlap), and g=1 on every
    other of those columns."""
    base = shard * W * 32
    sets = [f"Set({base + c}, f={r})" for r, n in counts.items()
            for c in range(n)]
    sets += [f"Set({base + c}, g=1)" for c in range(0, max(counts.values()),
                                                    2)]
    return " ".join(sets)


C4_CASES = [
    ({"cache_type": "ranked", "cache_size": 1}, {1: 5, 2: 4, 3: 3, 4: 2},
     "TopN(f, n=3)"),
    ({"cache_type": "ranked", "cache_size": 2}, {1: 5, 2: 4, 3: 3, 4: 2},
     "TopN(f) TopN(f, n=1) TopN(f, Row(g=1), n=2)"),
    ({"cache_type": "ranked", "cache_size": 3},
     {1: 2, 2: 7, 3: 7, 4: 1, 5: 9}, "TopN(f, n=4) TopN(f, threshold=3)"),
    ({"cache_type": "none"}, {1: 5, 2: 4, 3: 3}, "TopN(f, n=2)"),
]


@pytest.mark.parametrize("i", range(len(C4_CASES)))
def test_topn_candidates_come_from_the_row_cache(tmp_path, i):
    """ROADMAP C4: phase 1 takes each fragment's candidates from its row
    cache, as the reference does: at a small ranked ``cacheSize`` the
    answer holds only the cached rows (the none cache falls back to
    exact counts). Equal ``result_to_json`` bytes."""
    opts, counts, pql = C4_CASES[i]
    jh, ph, jex, pex = _cached_pair(tmp_path, opts)
    try:
        for ex in (jex, pex):
            ex.execute("i", _ladder_writes(counts))
        got = result_to_json(pex.execute("i", pql))
        assert got == j_result_to_json(jex.execute("i", pql)), pql
        if i == 0:
            assert got == [[{"id": 1, "count": 5}]]
        jfrag = jh.index("i").field("f").view("standard").fragment(0)
        pfrag = ph.index("i").field("f").view("standard").fragment(0)
        for n in (0, 2):
            assert pfrag.top(n) == [tuple(p) for p in jfrag.top(n)]
            ids = sorted(counts)[::-1] + [99]
            assert pfrag.top(n, row_ids=ids) == [
                tuple(p) for p in jfrag.top(n, row_ids=ids)]
    finally:
        jh.close()
        ph.close()


def test_fragment_without_cache_sidecar_ranks_exact_counts(tmp_path):
    """ROADMAP C4's deliberate difference: a fragment opened without its
    ``.cache`` sidecar fills its cache from the exact counts (the
    reference's starts empty and, after one write, ranks only that row).
    Pinned against a numpy oracle of the rows' bits."""
    rng = np.random.default_rng(44)
    words = {r: _sparse(rng, n) for r, n in ((1, 50), (2, 40), (3, 30),
                                             (4, 20))}
    path = tmp_path / "data"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": words}, index="i")
    h.close()
    for cache in path.glob("i/f/views/standard/fragments/*.cache"):
        cache.unlink()
    h = Holder(str(path), device="cpu").open()
    try:
        ex = Executor(h, device="cpu")
        col = 2 * W * 32 + 5  # shard 2
        ex.execute("i", f"Set({col}, f=4)")
        bits = {r: np.unpackbits(w.view(np.uint8), bitorder="little")
                for r, w in words.items()}
        bits[4][col] = 1
        want = sorted(({"id": r, "count": int(b.sum())}
                       for r, b in bits.items()),
                      key=lambda p: (-p["count"], p["id"]))[:3]
        assert result_to_json(ex.execute("i", "TopN(f, n=3)")) == [want]
    finally:
        h.close()


def test_lru_field_takes_writes_and_ranks_its_last_rows(tmp_path):
    """ROADMAP C5: an LRU field takes its first Set (the reference raises
    there, so the answer is pinned to an oracle): each fragment's TopN
    candidates are its ``cacheSize`` rows written last, each recounted
    exactly over every shard."""
    size = 3
    h = Holder(str(tmp_path / "data"), device="cpu").open()
    h.create_index("i").create_field(
        "f", FieldOptions(cache_type="lru", cache_size=size))
    h.close()
    h = Holder(str(tmp_path / "data"), device="cpu").open()  # load()ed
    rng = np.random.default_rng(45)
    bits = np.zeros((8, 2 * W * 32), bool)
    last: dict = {0: [], 1: []}  # each shard's rows, last written last
    try:
        ex = Executor(h, device="cpu")
        for _ in range(40):
            shard, row = int(rng.integers(0, 2)), int(rng.integers(0, 8))
            col = shard * W * 32 + int(rng.integers(0, 64))
            ex.execute("i", f"Set({col}, f={row})")
            if not bits[row, col]:
                bits[row, col] = True
                if row in last[shard]:
                    last[shard].remove(row)
                last[shard].append(row)
        cand = set(last[0][-size:]) | set(last[1][-size:])
        want = sorted(({"id": r, "count": int(bits[r].sum())}
                       for r in cand), key=lambda p: (-p["count"], p["id"]))
        got = result_to_json(ex.execute("i", "TopN(f) TopN(f, n=2)"))
        assert got == [want, want[:2]]
    finally:
        h.close()

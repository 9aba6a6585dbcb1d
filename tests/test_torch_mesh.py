"""The port's DistExecutor against the reference's, on the CPU.

The reference's DistExecutor runs on conftest's 8 forced CPU devices
(``make_mesh(n, groups=g)``); the port's on ``make_mesh(n,
devices=[cpu], groups=g)``, 8 members sharing the CPU. Both packages open
copies of one data directory of 3 or 5 shards (counts no mesh size
divides) and answer the same queries: ``__graft_entry__``'s dryrun
shapes, TopN (the quantized ranking on and off) and GroupBy, dense and
pruned, a pipelined micro-batch of Counts, and a Set between two mesh
reads of the leaf it patches. Answers must be byte-identical through
``result_to_json``, and the reduction accounting (``global_reduce_stats()``
snapshots, PROFILE's ``reduceBytes``) equal. Tolerance 0 throughout.
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
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.parallel import DistExecutor as JDistExecutor
from pilosa_tpu.parallel import make_mesh as j_make_mesh
from pilosa_tpu.parallel import reduction as jreduction
from pilosa_tpu.utils import cost as jcost
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.executor import executor as executor_mod
from pilosa_tpu_torch.parallel import (
    DistExecutor,
    ShardAssignment,
    make_mesh,
    mesh_groups,
)
from pilosa_tpu_torch.parallel import reduction
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import Holder
from pilosa_tpu_torch.utils import cost as pcost

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the reference's mesh matrix (tests/test_mesh_reduction.py): 1-D sizes
# 1 and 2, then 2-D groups x shards factorizations
MESH_CONFIGS = [(1, None), (2, None), (2, 2), (4, 2), (8, 2), (8, 4)]
IDS = [f"{n}dev-g{g or 1}" for n, g in MESH_CONFIGS]
N_SHARDS = 5
RANK_SHARDS = 3
RANK_ROWS = 300  # a pruning level over more than one 256-candidate block

EXTRA = [
    "TopN(f, Row(g=7), n=2)",
    "TopN(rank, n=3)",
    "TopN(rank, n=8)",
    "TopN(rank, n=5, threshold=40)",
    "TopN(rank, ids=[1, 5, 9])",
    "TopN(few, n=1)",
    "GroupBy(Rows(few))",
    "GroupBy(Rows(f), Rows(few), filter=Row(g=7))",
    "Count(Union(Row(f=2), Row(f=3)))",
    'Sum(field="fare")',
]
# past GroupBy's dense limit of 4 groups: pruned level by level
PRUNED = [
    "GroupBy(Rows(f), Rows(few), Rows(f))",
    'GroupBy(Rows(f), Rows(few), aggregate=Sum(field="fare"))',
]


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    """The dryrun's index at 5 shards (f rows 1-3, g row 7, an int fare,
    a keyed tag) plus ``rank``, 64 rows of distinct counts, and ``few``."""
    path = tmp_path_factory.mktemp("mesh") / "data"
    h = jstorage.Holder(str(path)).open()
    try:
        idx = h.create_index("dryrun")
        f = idx.create_field("f")
        g = idx.create_field("g")
        fare = idx.create_field("fare", jstorage.FieldOptions(
            type="int", min=0, max=100))
        idx.create_field("tag", jstorage.FieldOptions(keys=True))
        rank = idx.create_field("rank")
        few = idx.create_field("few")
        rng = np.random.default_rng(1)
        cols = []
        for shard in range(N_SHARDS):
            base = shard * SHARD_WIDTH
            for c in rng.choice(SHARD_WIDTH, 50, replace=False).tolist():
                f.set_bit(1 + (c % 3), base + c)
                if c % 2 == 0:
                    g.set_bit(7, base + c)
                cols.append(base + c)
            k = 0
            for r in range(64):
                # row r holds 2 + r bits a shard: distinct global counts
                for _ in range(2 + r):
                    rank.set_bit(r, base + (k * 97) % SHARD_WIDTH)
                    k += 1
            few.set_bit(1, base)
            few.set_bit(2, cols[-1])
        for c in cols[::10]:
            fare.set_value(c, int(rng.integers(0, 100)))
        idx.mark_columns_exist(cols)
        ex = JExecutor(h)
        for name, key_cols in (("alpha", cols[:7]), ("amber", cols[7:12]),
                               ("beta", cols[12:15])):
            for c in key_cols:
                ex.execute("dryrun", f'Set({c}, tag="{name}")')
        probe = next(c for c in cols if (c % SHARD_WIDTH) % 3 == 0)
    finally:
        h.close()
    return path, probe


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory):
    """``wide``: RANK_ROWS rows over 3 shards (a ranking lane of two
    256-candidate blocks), and ``one``: 1 row."""
    path = tmp_path_factory.mktemp("meshrank") / "data"
    h = jstorage.Holder(str(path)).open()
    try:
        idx = h.create_index("r")
        wide = idx.create_field("wide")
        one = idx.create_field("one")
        rows, cols = [], []
        for shard in range(RANK_SHARDS):
            base = shard * SHARD_WIDTH
            k = 0
            for r in range(RANK_ROWS):
                n = 1 + (r * 7) % 97 + (r % 5) * 60  # past 255 in a block
                rows += [r] * n
                cols += [base + (k + j) * 31 % SHARD_WIDTH for j in range(n)]
                k += n
            one.set_bit(1, base + 31)
        rows, cols = np.asarray(rows), np.asarray(cols)
        view = wide.view("standard", create=True)
        for shard in range(RANK_SHARDS):
            sel = cols // SHARD_WIDTH == shard
            view.fragment(shard, create=True).bulk_import(
                rows[sel], cols[sel] % SHARD_WIDTH)
        idx.mark_columns_exist(np.unique(cols).tolist())
    finally:
        h.close()
    return path


def _open_pair(src, tmp_path):
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    return (jstorage.Holder(str(tmp_path / "jax")).open(),
            Holder(str(tmp_path / "port"), device="cpu").open())


@pytest.fixture
def pair(seed_dir, tmp_path):
    jh, ph = _open_pair(seed_dir[0], tmp_path)
    yield jh, ph
    jh.close()
    ph.close()


def _meshes(jh, ph, cfg, quantized: bool, verify: bool = False):
    n, g = cfg
    return (JDistExecutor(jh, j_make_mesh(n, groups=g),
                          quantized_ranking=quantized,
                          verify_quantized=verify),
            DistExecutor(ph, make_mesh(n, devices=[CPU], groups=g),
                         quantized_ranking=quantized,
                         verify_quantized=verify))


def _json(to_json, results) -> str:
    return json.dumps(to_json(results))


def _same(jex, pex, index: str, pql: str) -> None:
    want = _json(j_result_to_json, jex.execute(index, pql))
    got = _json(result_to_json, pex.execute(index, pql))
    assert got == want, pql


def _fresh_stats():
    jreduction.global_reduce_stats().reset()
    reduction.global_reduce_stats().reset()


def _stats_equal() -> None:
    want = jreduction.global_reduce_stats().snapshot()
    got = reduction.global_reduce_stats().snapshot()
    assert got == want
    assert got["dispatches"] > 0


def _max_groups(monkeypatch, n: int) -> None:
    monkeypatch.setattr(jexecutor_mod, "GROUPBY_DENSE_MAX_GROUPS", n)
    monkeypatch.setattr(executor_mod, "GROUPBY_DENSE_MAX_GROUPS", n)


@pytest.mark.parametrize("quantized", [False, True], ids=["lossless", "q8"])
@pytest.mark.parametrize("cfg", MESH_CONFIGS, ids=IDS)
def test_mesh_answers_and_accounting_match_reference(pair, seed_dir, cfg,
                                                     quantized, monkeypatch):
    """Every dryrun shape, TopN and GroupBy (dense, and pruned past a
    dense limit of 4 groups), byte for byte, and the reduction counters
    equal after them."""
    jh, ph = pair
    jex, pex = _meshes(jh, ph, cfg, quantized, verify=quantized)
    probe = seed_dir[1]
    _fresh_stats()
    for pql in DRYRUN_QUERY_SHAPES + EXTRA:
        _same(jex, pex, "dryrun", pql.format(probe=probe))
    _stats_equal()
    _max_groups(monkeypatch, 4)
    _fresh_stats()
    for pql in PRUNED:
        _same(jex, pex, "dryrun", pql)
    _stats_equal()
    plain = Executor(ph, device="cpu")
    for pql in PRUNED + EXTRA[:7]:
        assert _json(result_to_json, pex.execute("dryrun", pql)) == _json(
            result_to_json, plain.execute("dryrun", pql)), pql


def test_quantized_levels_over_two_blocks_match_reference(rank_dir, tmp_path,
                                                         monkeypatch):
    """On a 2 x 2 mesh a pruning level of RANK_ROWS candidates crosses the
    8-bit lane in two scale blocks, with group totals past 255 (scales >
    1, a real error bound), and the TopN window shrinks below the
    candidates. Answers and counters equal the reference's, and the
    answers the single-device executor's."""
    jh, ph = _open_pair(rank_dir, tmp_path)
    try:
        _max_groups(monkeypatch, 1)
        _fresh_stats()
        jex, pex = _meshes(jh, ph, (4, 2), True, verify=True)
        queries = ("GroupBy(Rows(wide), Rows(one))", "TopN(wide, n=4)",
                   "TopN(wide, n=20)")
        for pql in queries:
            _same(jex, pex, "r", pql)
        _stats_equal()
        snap = reduction.global_reduce_stats().snapshot()
        assert snap["quantized_dispatches"] >= 3
        assert 0 < snap["quantized_actual_bytes"] < \
            snap["quantized_lossless_bytes"]
        assert 0 < snap["quantized_window_rows"] < \
            snap["quantized_candidate_rows"]
        plain = Executor(ph, device="cpu")
        for pql in queries[1:]:
            assert _json(result_to_json, pex.execute("r", pql)) == _json(
                result_to_json, plain.execute("r", pql)), pql
    finally:
        jh.close()
        ph.close()


@pytest.mark.parametrize("cfg", [(2, None), (8, 2)], ids=["2dev", "8dev-g2"])
def test_pipelined_counts_and_a_set_between_mesh_reads(pair, seed_dir, cfg):
    """Counts pipelined through ``submit`` micro-batch on both meshes (the
    reference's power-of-two batch shapes in the accounting); a Set
    through the mesh patches the resident leaf, and the next mesh read of
    it sees the bit."""
    jh, ph = pair
    jex, pex = _meshes(jh, ph, cfg, False)
    shapes = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=7)))",
              "Count(Row(f=2))"]
    _fresh_stats()
    for _ in range(2):
        want = [d.result() for d in jex.submit("dryrun", " ".join(shapes))]
        got = [d.result() for d in pex.submit("dryrun", " ".join(shapes))]
        assert got == want
    _stats_equal()
    col = 3 * SHARD_WIDTH + 77
    for pql in ("Count(Row(f=1))", f"Set({col}, f=1)", "Count(Row(f=1))",
                "Row(f=1)"):
        _same(jex, pex, "dryrun", pql)
    assert pex.execute("dryrun", f"IncludesColumn(Row(f=1), column={col})"
                       ) == [True]


def _profiled(pkg_cost, ex, pql: str) -> dict:
    prof = pkg_cost.QueryProfile("dryrun", pql)
    ctx = pkg_cost.new_cost_context("t", "dryrun", profile=prof)
    tok = pkg_cost.activate_cost(ctx)
    try:
        ex.execute("dryrun", pql)
    finally:
        pkg_cost.deactivate_cost(tok)
    return {"totals": ctx.totals().get("reduceBytes"),
            "calls": [c.get("reduceBytes") for c in prof.to_json()["calls"]]}


@pytest.mark.parametrize("cfg", [(2, None), (8, 2), (8, 4)],
                         ids=["2dev", "8dev-g2", "8dev-g4"])
def test_profile_reduce_bytes_match_reference(pair, cfg):
    """PROFILE's reduceBytes (on the call's node and in the totals) equal
    the reference's: a Count, a Row gather (roaring frames on a 2-D
    mesh) and a quantized TopN."""
    jh, ph = pair
    jex, pex = _meshes(jh, ph, cfg, True)
    for pql in ("Count(Row(f=1))", "Union(Row(f=1), Row(g=7))",
                "TopN(rank, n=3)", 'Max(field="fare")'):
        want = _profiled(jcost, jex, pql)
        got = _profiled(pcost, pex, pql)
        assert got == want, pql
        if pql.startswith(("Count", "TopN")) or cfg[1]:
            # a flat mesh's row gather crosses no lane
            assert got["totals"]["denseEquiv"] > 0, pql


def test_mesh_shapes_and_assignment():
    """make_mesh's grids, repeats of one device, the reference's
    ValueError, and ShardAssignment's slots against the reference's."""
    from pilosa_tpu.parallel.mesh import ShardAssignment as JAssignment

    m = make_mesh(8, devices=[CPU], groups=2)
    assert (m.size, m.shape, m.axis_names) == (
        8, {"groups": 2, "shards": 4}, ("groups", "shards"))
    assert m.members == [CPU] * 8
    assert mesh_groups(m) == (2, 4)
    assert mesh_groups(make_mesh(8, devices=[CPU], groups=4)) == (4, 2)
    assert mesh_groups(make_mesh(2, devices=[CPU])) is None
    assert make_mesh(devices=[CPU, CPU], groups=1).shape == {"shards": 2}
    with pytest.raises(ValueError, match="groups=3 does not divide 8"):
        make_mesh(8, devices=[CPU], groups=3)
    with pytest.raises(ValueError, match="groups=3 does not divide 8"):
        j_make_mesh(8, groups=3)
    for n, g in MESH_CONFIGS:
        for shards in ([0], [0, 2, 5], list(range(13)), []):
            want = JAssignment(shards, j_make_mesh(n, groups=g))
            got = ShardAssignment(shards, make_mesh(n, devices=[CPU],
                                                    groups=g))
            assert (got.padded, got.n_devices, got.local_slots,
                    got.slot_of) == (want.padded, want.n_devices,
                                     want.local_slots, want.slot_of)
            assert got.per * n == got.padded
    blk = ShardAssignment([0, 1], make_mesh(8, devices=[CPU]))
    assert blk.key() != executor_mod.batch.ShardBlock([0, 1]).key()


def test_server_use_mesh_builds_a_dist_executor(seed_dir, tmp_path):
    """``use-mesh`` on a CPU server: a one-member flat mesh answering as
    the plain executor; unset (no CUDA device visible) the plain
    Executor; groups and quantized ranking reach the executor."""
    from pilosa_tpu_torch.server import Server

    shutil.copytree(seed_dir[0], tmp_path / "d")
    for kwargs, want in (({}, Executor), ({"use_mesh": False}, Executor),
                         ({"use_mesh": True}, DistExecutor)):
        s = Server(str(tmp_path / "d"), port=0, device="cpu", **kwargs).open()
        try:
            assert type(s.executor) is want
            if want is DistExecutor:
                assert s.executor.mesh.size == 1
                assert mesh_groups(s.executor.mesh) is None
                plain = Executor(s.holder, device="cpu")
                for pql in ("Count(Row(f=1))", "TopN(rank, n=3)",
                            'Min(field="fare")'):
                    assert (_json(result_to_json,
                                  s.executor.execute("dryrun", pql))
                            == _json(result_to_json,
                                     plain.execute("dryrun", pql)))
        finally:
            s.close()
    with pytest.raises(ValueError, match="groups=2 does not divide 1"):
        Server(str(tmp_path / "d"), port=0, device="cpu", use_mesh=True,
               mesh_groups=2).open().close()
    s = Server(str(tmp_path / "d"), port=0, device="cpu", use_mesh=True,
               topn_quantized_ranking=True).open()
    try:
        assert s.executor.quantized_ranking is True
    finally:
        s.close()

"""Both executors on copies of one data directory: equal result bytes.

The data comes from one numpy seed through the port's dense loader; the
reference executor opens a copy of the same directory. Every comparison
is of ``result_to_json`` bytes, exact.
"""

import json
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu_torch.executor import Executor, expr, result_to_json
from pilosa_tpu_torch.storage import Holder, load_from_dense

torch.set_num_threads(1)

W = 32768
SHARDS = 3  # not a power of two: the stacked leaves carry a zero slot

QUERIES = DRYRUN_QUERY_SHAPES[:4] + [
    "Count(Row(f=1))",
    "Count(Union(Row(f=1), Row(g=7)))",
    "Count(Xor(Row(f=2), Row(g=7)))",
    "Count(Difference(Row(f=1), Row(f=2), Row(g=7)))",
    "Intersect(Row(f=1), Union(Row(f=2), Row(g=7)))",
    "Count(Intersect())",
    "Row(f=99)",
    "Count(Row(f=-1))",
]


def _words(rng, density: float) -> np.ndarray:
    bits = rng.random(SHARDS * W * 32) < density
    return np.packbits(bits, bitorder="little").view("<u4")


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    rng = np.random.default_rng(42)
    path = tmp_path_factory.mktemp("seed") / "data"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": {1: _words(rng, 0.01), 2: _words(rng, 0.02)},
                        "g": {7: _words(rng, 0.015)}}, index="i")
    h.close()
    return path


@pytest.fixture
def pair(seed_dir, tmp_path):
    """(reference executor, port executor) on copies of the seed dir."""
    shutil.copytree(seed_dir, tmp_path / "jax")
    shutil.copytree(seed_dir, tmp_path / "port")
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    ph = Holder(str(tmp_path / "port"), device="cpu").open()
    yield JExecutor(jh), Executor(ph, device="cpu")
    jh.close()
    ph.close()


def _bytes(to_json, results) -> bytes:
    return json.dumps(to_json(results)).encode()


def test_results_match_reference(pair):
    jex, pex = pair
    for pql in QUERIES:
        want = _bytes(j_result_to_json, jex.execute("i", pql))
        got = _bytes(result_to_json, pex.execute("i", pql))
        assert got == want, pql


def test_writes_then_reads_match_reference(pair):
    jex, pex = pair
    script = [
        "Set(5, f=1) Set(2097155, f=1)",
        "Count(Intersect(Row(f=1), Row(g=7)))",
        "Clear(5, f=1) Clear(5, f=1)",
        "Set(1048577, g=7) Count(Union(Row(f=1), Row(g=7)))",
        "Row(f=1)",
        "Set(10, f=1) Row(f=1)",  # a new shard-0 bit in a resident leaf
    ]
    for pql in script:
        want = _bytes(j_result_to_json, jex.execute("i", pql))
        got = _bytes(result_to_json, pex.execute("i", pql))
        assert got == want, pql


def test_submit_then_set_reads_the_pre_write_count(pair):
    """A queued micro-batch keeps the leaves it captured at submit: the
    reference patches functionally; the port patches in place after
    launching the pending group, whose leaves came from the operand
    memo."""
    pql = "Count(Intersect(Row(f=1), Row(g=7)))"
    for ex in pair:
        before = ex.execute("i", pql)[0]  # leaves resident
        col = 3 * W * 32 - 1
        hits = getattr(ex, "memo_hits", None)
        pending = ex.submit("i", pql) + ex.submit("i", "Count(Row(f=1))")
        if hits is not None:  # the port: the submit's leaves are memoized
            assert ex.memo_hits == hits + 1
        assert ex.execute("i", f"Set({col}, f=1) Set({col}, g=7)") == \
            [True, True]
        assert pending[0].result() == before
        assert ex.execute("i", pql)[0] == before + 1
    assert pair[0].execute("i", "Count(Row(f=1))") == \
        pair[1].execute("i", "Count(Row(f=1))")


def test_micro_batch_coalesces_counts(pair):
    _, pex = pair
    shapes = ["Count(Intersect(Row(f=1), Row(g=7)))",
              "Count(Intersect(Row(f=2), Row(g=7)))"]
    want = [pex.execute("i", q)[0] for q in shapes]
    handles = [pex.submit("i", shapes[k % 2])[0] for k in range(6)]
    assert [h.result() for h in handles] == [want[k % 2] for k in range(6)]
    assert pex.largest_batch == 6


@pytest.mark.parametrize("pql", [
    "Store(Row(f=1), f=5)", "ClearRow(f=1)",
    "Count(Row(f=1, from='2020-01-01', to='2021-01-01'))",
    "Options(Row(f=1), columnAttrs=true)",
    'TopN(f, n=2, attrName="x", attrValue=1)',
    'SetRowAttrs(f, 1, x=1) TopN(f, n=2, attrName="x", attrValue=1) '
    "Row(f=1)",
])
def test_formerly_unported_calls_match_reference(pair, pql):
    """Store, ClearRow, a time window (on a set field, which the
    reference refuses), Options(columnAttrs=), TopN's attribute filter
    and SetRowAttrs on a field without keys answer as the reference
    does, and the rows they touch read the same afterwards."""
    jex, pex = pair

    def outcome(ex, to_json):
        try:
            return _bytes(to_json, ex.execute("i", pql))
        except ValueError as e:  # either package's PQLError
            return str(e)

    assert outcome(pex, result_to_json) == outcome(jex, j_result_to_json)
    for after in ("Row(f=1)", "Row(f=5)"):
        assert _bytes(result_to_json, pex.execute("i", after)) == \
            _bytes(j_result_to_json, jex.execute("i", after))


_WIDE_ROWS = ["Row(f=1)", "Row(f=2)", "Row(g=7)", "Row(f=3)",
              "Shift(Row(f=1), n=1)"]


def _wide(op: str, n: int) -> str:
    return f"{op}(" + ", ".join(_WIDE_ROWS[k % 5] for k in range(n)) + ")"


def _nested(depth: int) -> str:
    """A right-nested Difference/Union tree: one stack slot per level."""
    node = "Row(f=1)"
    for k in range(depth):
        leaf = ["Row(f=2)", "Row(g=7)", "Row(f=1)"][k % 3]
        node = (f"Difference({leaf}, {node})" if k % 2
                else f"Union({leaf}, {node})")
    return node


WIDE = [f"Count({_wide('Union', 16)})", f"Count({_wide('Union', 17)})",
        f"Count({_wide('Union', 40)})", f"Count({_wide('Xor', 17)})",
        _wide("Xor", 40), f"Count({_nested(20)})", _nested(20),
        f"Count(Intersect({_wide('Union', 20)}, {_nested(17)}))"]


@pytest.mark.parametrize("pql", WIDE)
def test_wide_unions_are_refused_not_miscounted(pair, pql):
    """Trees past the kernels' 16 operands or 16 stack slots are cut into
    K2 'tree' steps and answer as the reference does (they were refused
    before the cut existed)."""
    jex, pex = pair
    assert _bytes(result_to_json, pex.execute("i", pql)) == \
        _bytes(j_result_to_json, jex.execute("i", pql))


def test_wide_union_cuts_the_fewest_tree_steps():
    leaves = [("leaf", i) for i in range(40)]
    node = leaves[0]
    for leaf in leaves[1:]:
        node = ("or", node, leaf)
    plan = expr.plan(("count", node))
    assert [s[0] for s in plan.steps] == ["tree", "tree"]
    assert [len(s[1][1]) for s in plan.steps] == [16, 16]
    assert len(plan.root[1]) == 10
    assert plan.root[1][0] == ("temp", 1)


def test_concurrent_counts_and_sets_lose_no_patch(seed_dir, tmp_path):
    """Readers micro-batch Counts while writers patch the same resident
    leaf in place; with a short switch interval, no write may be lost
    and no reader may see the count go backwards."""
    shutil.copytree(seed_dir, tmp_path / "port")
    h = Holder(str(tmp_path / "port"), device="cpu").open()
    ex = Executor(h, device="cpu")
    pql = "Count(Row(f=1))"
    base = ex.execute("i", pql)[0]  # leaf resident before the writers
    fld = h.index("i").field("f")
    view = fld.view("standard")
    free = [c for c in range(0, SHARDS * W * 32, 7919)
            if not view.fragment(c >> 20).contains(1, c & (W * 32 - 1))]
    writers = [free[k::4][:20] for k in range(4)]
    seen: dict = {}
    errors: list = []

    def read(k):
        try:
            out = [ex.submit("i", pql)[0].result() for _ in range(30)]
            seen[k] = out
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def write(cols):
        try:
            for c in cols:
                assert ex.execute("i", f"Set({c}, f=1)") == [True]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=read, args=(k,)) for k in range(8)]
        threads += [threading.Thread(target=write, args=(w,))
                    for w in writers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert errors == []
        n_new = sum(len(w) for w in writers)
        for out in seen.values():
            assert out == sorted(out)
            assert base <= out[0] and out[-1] <= base + n_new
        # the patched resident leaf agrees with the fragments on disk
        assert ex.execute("i", pql)[0] == base + n_new == \
            sum(view.fragment(s).count_row(1) for s in range(SHARDS))
    finally:
        h.close()

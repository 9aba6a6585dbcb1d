"""Empty-row (``const0``) filters in aggregates, TopN and GroupBy: the
port's answers pinned to a numpy oracle.

The reference gets these shapes wrong (it raises, or over-counts by the
number of plane rows), because its ``const0`` takes the first leaf's
shape, a plane stack or a candidate matrix; an unknown row key compiles
to the same ``const0``. The port's are right, so
they are held against numpy over the same seeded data, not against the
reference. Tolerance 0 (integers).
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense

torch.set_num_threads(1)

W = 32768
SHARDS = 3
N = SHARDS * W * 32
FARE_MIN, FARE_MAX = 0, 1000
FARE_DEPTH = (FARE_MAX - FARE_MIN).bit_length()


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, bitorder="little").view("<u4")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(executor, oracle): rows f=1, f=2, g=2, an int field fare on a
    third of the columns and a keyed field s without keys, from one numpy
    seed."""
    rng = np.random.default_rng(99)
    rows = {("f", 1): rng.random(N) < 0.01, ("f", 2): rng.random(N) < 0.02,
            ("g", 2): rng.random(N) < 0.015}
    has_fare = rng.random(N) < 0.003
    fare = np.where(has_fare, rng.integers(FARE_MIN, FARE_MAX + 1, N), 0)
    planes = np.zeros((2 + FARE_DEPTH, N // 32), np.uint32)
    planes[0] = _pack(has_fare)
    for i in range(FARE_DEPTH):
        planes[2 + i] = _pack(has_fare & (((fare >> i) & 1) == 1))
    path = tmp_path_factory.mktemp("const0") / "data"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": {1: _pack(rows["f", 1]), 2: _pack(rows["f", 2])},
                        "g": {2: _pack(rows["g", 2])}}, index="i",
                    int_fields={"fare": (FARE_MIN, FARE_MAX, planes)})
    # a keyed field that knows no key: every key names the empty row
    h.index("i").create_field("s", FieldOptions(keys=True))
    exists = has_fare | rows["f", 1] | rows["f", 2] | rows["g", 2]
    oracle = {"rows": rows, "fare": fare, "has_fare": has_fare,
              "exists": exists}
    yield Executor(h, device="cpu"), oracle
    h.close()


def _agg(oracle, name: str, mask) -> dict:
    sel = mask & oracle["has_fare"]
    vals = oracle["fare"][sel]
    if vals.size == 0:
        return {"value": 0, "count": 0}
    if name == "Sum":
        return {"value": int(vals.sum()), "count": int(vals.size)}
    v = int(vals.max() if name == "Max" else vals.min())
    return {"value": v, "count": int((vals == v).sum())}


def _none(oracle):
    return np.zeros(N, bool)


CASES = [
    ('Sum(Row(f=-1), field="fare")', lambda o: _agg(o, "Sum", _none(o))),
    ('Sum(Row(fare > 5000), field="fare")',
     lambda o: _agg(o, "Sum", _none(o))),
    ('Min(Intersect(), field="fare")', lambda o: _agg(o, "Min", _none(o))),
    ('Max(Not(Row(f=-1)), field="fare")',
     lambda o: _agg(o, "Max", o["exists"])),
    ('Min(Xor(Row(g=2), Union()), field="fare")',
     lambda o: _agg(o, "Min", o["rows"]["g", 2])),
    ('Max(Union(Row(f=2), Row(fare < -1)), field="fare")',
     lambda o: _agg(o, "Max", o["rows"]["f", 2])),
    ("GroupBy(Rows(f), filter=Row(f=-1))", lambda o: []),
    ("GroupBy(Rows(f), Rows(g), filter=Intersect())", lambda o: []),
    ("TopN(f, Intersect())", lambda o: []),
    ("TopN(f, Union(Row(f=-1), Row(g=2)), n=2)",
     lambda o: sorted(
         [{"id": r, "count": int((o["rows"]["f", r] & o["rows"]["g", 2])
                                 .sum())} for r in (1, 2)],
         key=lambda p: (-p["count"], p["id"]))),
    # an unknown row key (ROADMAP C3): the reference raises on the first
    # three and over-counts the fourth
    ('Sum(Row(s="r1"), field="fare")', lambda o: _agg(o, "Sum", _none(o))),
    ('GroupBy(Rows(f), filter=Intersect(Row(s="r0")))', lambda o: []),
    ('TopN(f, Row(s="r4"), n=2)', lambda o: []),
    ('Min(Not(Xor(Difference(Row(g=2), Row(s="r0")), Row(f=1))), '
     'field="fare")',
     lambda o: _agg(o, "Min", o["exists"]
                    & ~(o["rows"]["g", 2] ^ o["rows"]["f", 1]))),
]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_const0_shapes_match_numpy_oracle(data, i):
    ex, oracle = data
    pql, want = CASES[i]
    got = result_to_json(ex.execute("i", pql))[0]
    assert got == want(oracle), pql

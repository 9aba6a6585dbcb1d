"""K9's host plan and K2's program forms, on the CPU.

K9 (``csrc/groupby_level.cu``) walks a plan made on the host
(``kernels.groupby_plan``): candidates sorted, cut into tiles whose
distinct rows are staged once, each tile cut into groups sharing a
prefix. K2 (``csrc/tree_rows.cu``) runs a template kernel per program
form (``kernels.classify_program``). Neither kernel runs here; these
tests hold the plan and the forms exact, and their plain evaluation
against the plain versions and the JAX reference.
"""

import itertools

import numpy as np
import pytest
import torch

from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.executor import batch as jbatch
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import Executor, batch, expr
from pilosa_tpu_torch.storage import Holder, load_from_dense

torch.set_num_threads(1)

W = 32768


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32))


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


PLANS = {  # name -> (dimension sizes, C, filter, depth, max_slots)
    "one candidate": ((4, 3), 1, True, None, kernels.GROUPBY_MAX_SLOTS),
    "duplicates": ((3, 2), 40, False, None, kernels.GROUPBY_MAX_SLOTS),
    "C over the tile": ((6, 5, 4), 90, True, None, 7),
    "forced split, aggregate": ((5, 6), 30, True, 3, 9),
    "one dimension, aggregate": ((7,), 7, False, 5,
                                 kernels.GROUPBY_MAX_SLOTS),
    "16 dimensions": ((2,) * 16, 50, True, None, 20),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_slots_groups_and_order_are_exact(name):
    """Each tile stages exactly its candidates' distinct rows (after the
    filter, before the planes); every candidate's slot holds its row;
    the candidates are sorted lexicographically and written back to the
    caller's positions; tiles and groups partition the candidates, a
    group shares its prefix; the shared memory fits."""
    sizes, n_cand, has_filt, depth, max_slots = PLANS[name]
    rng = np.random.default_rng(len(name))
    idxs = [rng.integers(0, n, n_cand) for n in sizes]
    if name == "duplicates":
        idxs = [np.concatenate([ix[:20], ix[:20]]) for ix in idxs]
    plan = kernels.groupby_plan(idxs, has_filt, depth, W, True,
                                max_slots=max_slots)
    idx = np.stack(idxs)
    order = plan.order
    assert sorted(order.tolist()) == list(range(n_cand))
    assert np.array_equal(plan.cout, order)
    cands = idx[:, order].T
    assert [tuple(c) for c in cands] == sorted(tuple(c) for c in idx.T)
    assert np.array_equal(cands[np.argsort(order)], idx.T)  # the inverse
    k = 1 if depth is None else 2 + depth
    assert plan.smem_bytes <= kernels.GROUPBY_SMEM_BYTES
    covered = 0
    seen_tiles = []
    for slot0, n_slots, grp0, n_grps, c0, n in plan.tiles.tolist():
        assert c0 == covered and n > 0
        covered += n
        assert n_slots <= max_slots
        slots = [tuple(x) for x in plan.slots[slot0:slot0 + n_slots]]
        want = [(kernels.GROUPBY_SRC_FILT, 0)] if has_filt else []
        for d in range(len(sizes)):
            want += [(d, int(r)) for r in np.unique(cands[c0:c0 + n, d])]
        if depth is not None:
            want += [(kernels.GROUPBY_SRC_PLANES, r)
                     for r in (0, *range(2, 2 + depth))]
        assert slots == want
        for c in range(c0, c0 + n):
            for d in range(len(sizes)):
                assert slots[plan.cslots[c, d]] == (d, cands[c, d])
        at = c0
        for g0, gn in plan.groups[grp0:grp0 + n_grps].tolist():
            assert g0 == at and 1 <= gn <= kernels.GROUPBY_GROUP_MAX
            assert gn == 1 or depth is None
            at += gn
            assert (cands[g0:g0 + gn, :-1] == cands[g0, :-1]).all()
        assert at == c0 + n
        t = len(seen_tiles)
        seen_tiles.append(t)
        wl = plan.warps[t]
        assert wl.size == kernels.GROUPBY_WARPS + 1
        assert np.all(np.diff(wl) >= 0)
        got_units = sorted(map(tuple, plan.units[wl[0]:wl[-1]].tolist()))
        parts = 1 if depth is None else -(-depth // plan.part_planes)
        assert got_units == [(g, q) for g in range(grp0, grp0 + n_grps)
                             for q in range(parts)]
        assert (kernels.GROUPBY_SMEM_RESERVE + 8 * n_slots * plan.tile_words
                + 4 * n * k) <= plan.smem_bytes
    assert covered == n_cand
    if name in ("C over the tile", "forced split, aggregate"):
        assert len(plan.tiles) > 1


def test_plan_picks_the_main_path_shapes_one_tile():
    """At chip_smoke's three level shapes every distinct row is staged
    once (one tile), and the units spread over as many warps as they
    can."""
    q3 = np.array(list(itertools.product(range(10), range(8)))).T
    rng = np.random.default_rng(9)
    pick = rng.choice(10 * 8 * 16, 1000, replace=False)
    pruned = np.zeros((3, 1024), np.int64)
    pruned[:, :1000] = np.stack(np.unravel_index(pick, (10, 8, 16)))
    for idxs, filt, depth, rows in ((list(q3), True, None, 19),
                                    ([np.arange(10)], False, 20, 31),
                                    (list(pruned), True, None, 35)):
        plan = kernels.groupby_plan(idxs, filt, depth, W, True)
        assert len(plan.tiles) == 1 and plan.staged_rows == rows
        per_warp = np.diff(plan.warps[0])
        assert per_warp.sum() == plan.units.shape[0]
        assert (per_warp > 0).sum() == min(kernels.GROUPBY_WARPS,
                                           plan.units.shape[0])


LEVELS = [  # (dimension sizes, C, filter, depth, max_slots)
    ((5,), 8, False, None, kernels.GROUPBY_MAX_SLOTS),
    ((5,), 5, True, 7, 10),
    ((3, 4), 16, True, None, 5),
    ((3, 4, 2), 24, False, 4, 12),
    ((2, 3, 2), 1, True, None, kernels.GROUPBY_MAX_SLOTS),
]


@pytest.mark.parametrize("i", range(len(LEVELS)))
def test_plan_walk_matches_plain_and_reference(i):
    """The level evaluated the way K9 walks its plan (forced splits
    included) equals ``groupby_level_plain`` and, split-summed and
    packed, the reference's ``local_groupby_level_fn`` on the same numpy
    inputs (padding slot and pad candidates at index 0 included)."""
    sizes, n_cand, has_filt, depth, max_slots = LEVELS[i]
    rng = np.random.default_rng(50 + i)
    dims = [_words(rng, (4, n, W)) for n in sizes]
    filt = _words(rng, (4, W)) if has_filt else None
    planes = None
    if depth is not None:
        planes = _words(rng, (4, 2 + depth, W))
        planes[:, 2:] &= planes[:, :1]
        planes[:, 1] = 0
    for x in (*dims, *([filt] if has_filt else []),
              *([planes] if depth is not None else [])):
        x[3] = 0  # the padding slot
    idxs = [rng.integers(0, n, n_cand).astype(np.int32) for n in sizes]
    for ix in idxs:
        ix[-(n_cand // 4):] = 0  # pad candidates
    plan = kernels.groupby_plan(idxs, has_filt, depth, W, True,
                                max_slots=max_slots)
    t_dims = [_t(d) for d in dims]
    t_filt = _t(filt) if has_filt else None
    t_planes = _t(planes) if depth is not None else None
    got = kernels.groupby_plan_plain(plan, t_dims, t_filt, t_planes)
    want = kernels.groupby_level_plain(t_dims, idxs, t_filt, t_planes)
    assert torch.equal(got, want)

    packed = batch.split_sum(got, dim=0)
    port = (packed[:, 0].reshape(-1) if depth is None else torch.cat(
        [packed[:, 0].reshape(-1), packed[:, 1].reshape(-1),
         packed[:, 2:].reshape(-1)]))
    filt_structure = ("leaf", 0) if has_filt else None
    args = [*([filt] if has_filt else []), *dims,
            *([planes] if depth is not None else [])]
    ref = np.asarray(jbatch.local_groupby_level_fn(
        filt_structure, int(has_filt), 0, len(sizes), depth is not None)(
            *args, *idxs))
    assert np.array_equal(port.numpy(), ref)


# ------------------------------------------------------------------ K2


@pytest.fixture(scope="module")
def dryrun_executor(tmp_path_factory):
    """A 3-shard index with the DRYRUN shapes' fields: set fields f and g,
    int field fare (0..100)."""
    rng = np.random.default_rng(70)
    n = 3 * W
    h = Holder(str(tmp_path_factory.mktemp("dryrun")), device="cpu").open()
    rows = {r: _words(rng, n) & _words(rng, n) for r in (1, 2)}
    depth = 7
    planes = _words(rng, (2 + depth, n))
    planes[1] = 0
    planes[2:] &= planes[0]
    planes[8] = 0  # no bit 6: every stored value is at most 63
    load_from_dense(h, {"f": rows, "g": {7: _words(rng, n)}}, index="i",
                    int_fields={"fare": (0, 100, planes)})
    yield Executor(h, device="cpu")
    h.close()


def test_dryrun_row_programs_map_to_forms(dryrun_executor, monkeypatch):
    """Every program K2 gets for the DRYRUN corpus's row-producing shapes
    (and the row calls inside its counts) is a chain or a head-diff, and
    that form's plain evaluation equals ``tree_rows_plain``."""
    seen = []
    real = kernels.tree_rows

    def spy(program, leaves, salt=0):
        seen.append((tuple(program), list(leaves), salt))
        return real(program, leaves, salt)

    monkeypatch.setattr(kernels, "tree_rows", spy)
    row_shapes = []
    for pql in DRYRUN_QUERY_SHAPES:
        if pql.startswith(("Union(", "Xor(", "Difference(", "Row(",
                           "IncludesColumn(", "Count(")):
            row_shapes.append(pql.replace("{probe}", "5"))
    for pql in row_shapes:
        dryrun_executor.execute("i", pql)
    programs = {p for p, _, _ in seen}
    assert {kernels.classify_program(p).kind for p in programs} <= {
        kernels.FORM_CHAIN, kernels.FORM_HEAD_DIFF}
    assert len(programs) >= 3  # Union, Xor, Difference at least
    for program, leaves, salt in seen:
        form = kernels.classify_program(program)
        assert torch.equal(kernels.eval_form_plain(form, leaves, salt),
                           kernels.tree_rows_plain(program, leaves, salt))


FORM_CASES = [
    (("and", ("leaf", 0), ("leaf", 1)), kernels.FORM_CHAIN),
    (("or", ("leaf", 2), ("or", ("leaf", 0), ("leaf", 1))),
     kernels.FORM_CHAIN),
    (("xor", ("xor", ("leaf", 0), ("leaf", 0)), ("leaf", 1)),
     kernels.FORM_CHAIN),
    (("flipall", ("leaf", 1)), kernels.FORM_CHAIN),
    (("diff", ("diff", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
     kernels.FORM_HEAD_DIFF),
    (("diff", ("leaf", 2), ("and", ("leaf", 0), ("leaf", 1))),
     kernels.FORM_HEAD_DIFF),
    (("flipall", ("diff", ("leaf", 1), ("leaf", 0))),
     kernels.FORM_HEAD_DIFF),
    (("diff", ("leaf", 0), ("diff", ("leaf", 1), ("leaf", 2))),
     kernels.FORM_GENERAL),
    (("and", ("leaf", 0), ("or", ("leaf", 1), ("leaf", 2))),
     kernels.FORM_GENERAL),
    (("or", ("leaf", 0), ("const0",)), kernels.FORM_GENERAL),
]


@pytest.mark.parametrize("i", range(len(FORM_CASES)))
def test_classify_program_forms_evaluate_like_the_program(i):
    structure, kind = FORM_CASES[i]
    rng = np.random.default_rng(80 + i)
    leaves = [_t(_words(rng, (3, 64))) for _ in range(3)]
    program = expr.compile_program(structure)
    form = kernels.classify_program(program)
    assert form.kind == kind
    if kind != kernels.FORM_GENERAL:
        for salt in (0, 0x80000001):
            assert torch.equal(kernels.eval_form_plain(form, leaves, salt),
                               kernels.tree_rows_plain(program, leaves,
                                                       salt))
    salted = program + (kernels.OP_SALT, kernels.OP_NOT)
    form = kernels.classify_program(salted)
    assert form.kind == kind
    if kind != kernels.FORM_GENERAL:
        assert torch.equal(kernels.eval_form_plain(form, leaves, 7),
                           kernels.tree_rows_plain(salted, leaves, 7))

"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with the CUDA toolkit
(sm_90a) and skip elsewhere. On the GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import batch, expr

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

W = 32768


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _leaves(dev, n, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32)
                             .view(np.int32)).to(dev) for _ in range(n)]


@pytest.mark.parametrize("row_words", [W, 3 * W, 4099])
def test_tree_count_matches_plain(dev, row_words):
    tree = ("count", ("diff", ("or", ("leaf", 0), ("xor", ("leaf", 1),
                                                     ("const0",))),
                      ("leaf", 2)))
    prog = expr.compile_program(tree)
    n_words = 12 * row_words
    qs = [_leaves(dev, 3, (n_words,), s) for s in range(3)]
    got = kernels.tree_count(prog, qs, [0, 5, 0x80000000], row_words)
    want = kernels.tree_count_plain(prog, qs, [0, 5, 0x80000000], row_words)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.launches()["tree_count"] > 0


def test_intersect_count_matches_plain(dev):
    a, b = _leaves(dev, 2, (8, 4096), 9)
    for salt in (0, 7, 0x80000001):
        got = kernels.intersect_count(a, b, salt)
        want = kernels.popcount32(a & (b ^ kernels._salt_i32(salt))).sum(
            dim=1, dtype=torch.int32)
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4, W), (3, 1001)])
def test_tree_rows_matches_plain(dev, shape):
    prog = expr.compile_program(("xor", ("and", ("leaf", 0), ("leaf", 1)),
                                 ("diff", ("leaf", 2), ("const0",))))
    leaves = _leaves(dev, 3, shape, 4)
    got = kernels.tree_rows(prog, leaves)
    assert torch.equal(got, kernels.tree_rows_plain(prog, leaves))


@pytest.mark.parametrize("clear", [False, True])
def test_word_patch_matches_plain(dev, clear):
    (leaf,) = _leaves(dev, 1, (4, W), 5)
    rng = np.random.default_rng(6)
    pos = rng.choice(W * 32, 500, replace=False).astype(np.uint32)
    word_idx, masks = batch._word_masks(np.union1d(pos, pos | 31))
    k, p = leaf.clone(), leaf.clone()
    kernels.word_patch_batch([(k, 2, None, word_idx, masks, clear)])
    kernels.word_patch_batch_plain([(p, 2, None, word_idx, masks, clear)])
    assert torch.equal(k, p)
    assert torch.equal(k[:2], leaf[:2]) and torch.equal(k[3:], leaf[3:])


def _mixed_targets(rng, flat, planes, n_targets):
    """Distinct (leaf, slot[, row]) targets of both directions."""
    spots = [(0, s, None) for s in range(flat.shape[0])] + \
        [(1, s, r) for s in range(planes.shape[0])
         for r in range(planes.shape[1])]
    picks = rng.choice(len(spots), n_targets, replace=False)
    out = []
    for i in picks:
        leaf_i, slot, row = spots[i]
        pos = rng.choice(W * 32, int(rng.integers(1, 600)),
                         replace=False).astype(np.uint32)
        w, m = batch._word_masks(np.union1d(pos, pos | 31))
        out.append((leaf_i, slot, row, w, m, bool(rng.integers(0, 2))))
    return out


@pytest.mark.parametrize("n_targets", [1, 7, 30])
def test_word_patch_batch_mixed_matches_plain(dev, n_targets):
    """One launch over [S, W] and [S, R, W] targets of both directions,
    bit-exact against the plain version; the staging buffers are reused
    and grown across many batches."""
    flat, planes = _leaves(dev, 1, (8, W), 40)[0], \
        _leaves(dev, 1, (4, 6, W), 41)[0]
    rng = np.random.default_rng(42 + n_targets)
    k = [flat.clone(), planes.clone()]
    p = [flat.clone(), planes.clone()]
    before = kernels.launches()["word_patch"]
    for _ in range(9):
        spec = _mixed_targets(rng, flat, planes, n_targets)
        kernels.word_patch_batch([(k[i], s, r, w, m, c)
                                  for i, s, r, w, m, c in spec])
        kernels.word_patch_batch_plain([(p[i], s, r, w, m, c)
                                        for i, s, r, w, m, c in spec])
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert kernels.launches()["word_patch"] - before == 9


def test_word_patch_staging_never_waits(dev):
    """Batches issued while the stream is still busy take new staging
    buffers instead of waiting for the card; once it is idle, a buffer is
    reused. Each batch still lands in order, as the plain version has it;
    the launch floor's empty kernel runs."""
    flat, planes = _leaves(dev, 1, (8, W), 43)[0], \
        _leaves(dev, 1, (4, 6, W), 44)[0]
    rng = np.random.default_rng(45)
    k = [flat.clone(), planes.clone()]
    p = [flat.clone(), planes.clone()]
    specs = []

    def patch():
        specs.append(_mixed_targets(rng, flat, planes, 5))
        kernels.word_patch_batch([(k[i], s, r, w, m, c)
                                  for i, s, r, w, m, c in specs[-1]])

    patch()  # builds the kernel and makes the device's pool
    torch.cuda.synchronize()
    pool = kernels._pool(flat.device)
    assert kernels._pool(dev) is pool
    held = len(pool.slots)
    torch.cuda._sleep(1 << 30)  # keeps the stream busy for about 0.5 s
    for _ in range(3):
        patch()
    # the plain version (which copies to the card) runs only after this
    assert not torch.cuda.current_stream(dev).query(), \
        "a staged batch waited for the card"
    assert len(pool.slots) >= 3
    torch.cuda.synchronize()
    grown = len(pool.slots)
    patch()
    kernels.launch_floor(dev)
    torch.cuda.synchronize()
    assert len(pool.slots) == grown >= held
    for spec in specs:
        kernels.word_patch_batch_plain([(p[i], s, r, w, m, c)
                                        for i, s, r, w, m, c in spec])
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_tree_rows_not_matches_plain(dev):
    prog = expr.compile_program(("diff", ("flipall", ("leaf", 0)),
                                 ("flipall", ("leaf", 1))))
    leaves = _leaves(dev, 2, (4, W), 12)
    assert torch.equal(kernels.tree_rows(prog, leaves),
                       kernels.tree_rows_plain(prog, leaves))


@pytest.mark.parametrize("clear", [False, True])
def test_word_patch_row_form_matches_plain(dev, clear):
    (leaf,) = _leaves(dev, 1, (4, 6, W), 13)
    rng = np.random.default_rng(14)
    pos = rng.choice(W * 32, 500, replace=False).astype(np.uint32)
    word_idx, masks = batch._word_masks(np.union1d(pos, pos | 31))
    k, p = leaf.clone(), leaf.clone()
    kernels.word_patch_batch([(k, 2, 4, word_idx, masks, clear)])
    kernels.word_patch_batch_plain([(p, 2, 4, word_idx, masks, clear)])
    assert torch.equal(k, p)
    k[2, 4] = leaf[2, 4]
    assert torch.equal(k, leaf)  # nothing but slot 2's row 4 changed


SHIFTS = [0, 1, -1, 31, -31, 32, -32, 33, -33, W * 32 - 1, -(W * 32 - 1),
          1 << 20, -(1 << 20), (1 << 20) + 5, -(1 << 20) + 5]


@pytest.mark.parametrize("shape", [(4, W), (3, 1001)])
def test_row_shift_matches_plain(dev, shape):
    (words,) = _leaves(dev, 1, shape, 15)
    for n in SHIFTS:
        assert torch.equal(kernels.row_shift(words, n),
                           kernels.row_shift_plain(words, n)), n


def _planes(dev, n_shards, depth, row_words, seed, density_words=2):
    rng = np.random.default_rng(seed)
    exists = np.full((n_shards, row_words), 0xFFFFFFFF, np.uint32)
    for _ in range(density_words):
        exists &= rng.integers(0, 1 << 32, exists.shape, dtype=np.uint32)
    planes = rng.integers(0, 1 << 32, (n_shards, 2 + depth, row_words),
                          dtype=np.uint32) & exists[:, None]
    planes[:, 0] = exists
    planes[:, 1] = 0
    return torch.from_numpy(planes.view(np.int32)).to(dev)


@pytest.mark.parametrize("row_words", [W, 1001])
def test_bsi_compare_matches_plain(dev, row_words):
    depth = 20
    planes = _planes(dev, 5, depth, row_words, 16)
    exists = planes[:, 0].contiguous()
    for op in kernels.BSI_OPS:
        for pred in (0, 1, 777777, (1 << depth) - 1):
            assert torch.equal(kernels.bsi_compare(planes, exists, op, pred),
                               kernels.bsi_compare_plain(planes, exists, op,
                                                         pred)), (op, pred)


@pytest.mark.parametrize("row_words", [W, 1001])
def test_bsi_sum_matches_plain(dev, row_words):
    planes = _planes(dev, 5, 20, row_words, 17)
    (filt,) = _leaves(dev, 1, (5, row_words), 18)
    for f in (None, filt):
        assert torch.equal(kernels.bsi_sum(planes, f),
                           kernels.bsi_sum_plain(planes, f))


@pytest.mark.parametrize("want_max", [False, True])
def test_bsi_minmax_matches_plain(dev, want_max):
    planes = _planes(dev, 6, 20, W, 19, density_words=12)
    (filt,) = _leaves(dev, 1, (6, W), 20)
    filt[1] = 0
    filt[4] = 0  # shards without candidates
    for f in (None, filt):
        got_v, got_n = kernels.bsi_minmax(planes, f, want_max)
        want_v, want_n = kernels.bsi_minmax_plain(planes, f, want_max)
        assert torch.equal(got_n, want_n)
        live = want_n > 0
        assert torch.equal(got_v[live], want_v[live])
        assert torch.equal(batch.minmax_merge(got_v, got_n, want_max),
                           batch.minmax_merge(want_v, want_n, want_max))


@pytest.mark.parametrize("row_words", [W, 1001])
def test_count_rows_matches_plain(dev, row_words):
    (matrix,) = _leaves(dev, 1, (5, 8, row_words), 21)
    matrix[:, 6:] = 0  # zero pad rows
    (filt,) = _leaves(dev, 1, (5, row_words), 22)
    for f in (None, filt):
        got = kernels.count_rows(matrix, f)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.count_rows_plain(matrix, f))
    assert kernels.launches()["count_rows"] > 0


@pytest.mark.parametrize("row_words", [W, 1001])
@pytest.mark.parametrize("agg", [False, True])
def test_groupby_level_matches_plain(dev, row_words, agg):
    dims = [_leaves(dev, 1, (5, n, row_words), 23 + n)[0] for n in (3, 4, 2)]
    rng = np.random.default_rng(27)
    idxs = [rng.integers(0, d.shape[1], 70) for d in dims]
    (filt,) = _leaves(dev, 1, (5, row_words), 28)
    planes = _planes(dev, 5, 20, row_words, 29) if agg else None
    for k in (1, 3):
        for f in (None, filt):
            got = kernels.groupby_level(dims[:k], idxs[:k], f, planes)
            torch.cuda.synchronize()
            want = kernels.groupby_level_plain(dims[:k], idxs[:k], f, planes)
            assert torch.equal(got, want), (k, f is None)
    assert kernels.launches()["groupby_level"] > 0


def _chain(op, leaves):
    node = ("leaf", leaves[0])
    for i in leaves[1:]:
        node = (op, node, ("leaf", i))
    return node


def _right_deep(op, leaves):
    node = ("leaf", leaves[-1])
    for i in reversed(leaves[:-1]):
        node = (op, ("leaf", i), node)
    return node


K2_PROGRAMS = [  # (structure, the form classify_program must give)
    (("leaf", 3), kernels.FORM_CHAIN),
    (("flipall", ("leaf", 1)), kernels.FORM_CHAIN),
    (_chain("and", [0, 1]), kernels.FORM_CHAIN),
    (_chain("or", [0, 1, 2]), kernels.FORM_CHAIN),
    (_chain("xor", [4, 0, 2, 1, 3]), kernels.FORM_CHAIN),
    (_chain("and", list(range(9))), kernels.FORM_CHAIN),
    (("flipall", _chain("or", list(range(16)))), kernels.FORM_CHAIN),
    (_right_deep("xor", list(range(16))), kernels.FORM_CHAIN),
    (_chain("diff", [2, 0]), kernels.FORM_HEAD_DIFF),
    (_chain("diff", [0, 1, 2, 3, 4]), kernels.FORM_HEAD_DIFF),
    (("diff", ("leaf", 5), _chain("and", [0, 1, 2])), kernels.FORM_HEAD_DIFF),
    (("flipall", ("diff", ("leaf", 15), _chain("xor", list(range(15))))),
     kernels.FORM_HEAD_DIFF),
    (("diff", ("flipall", ("leaf", 0)), ("flipall", ("leaf", 1))),
     kernels.FORM_GENERAL),
    (("xor", ("diff", ("leaf", 0), ("leaf", 1)), ("or", ("leaf", 2),
                                                  ("const0",))),
     kernels.FORM_GENERAL),
    (_right_deep("diff", list(range(16))), kernels.FORM_GENERAL),  # depth 16
]


@pytest.mark.parametrize("shape", [(4, W), (3, 1001)])
@pytest.mark.parametrize("i", range(len(K2_PROGRAMS)))
def test_tree_rows_forms_match_plain(dev, shape, i):
    """Every K2 program form (chains and head-diffs in each leaf bucket,
    with OP_NOT after the root, the general register-stack interpreter
    up to a 16-deep stack), on 16-byte groups and on a ragged row (one
    word at a time)."""
    structure, form = K2_PROGRAMS[i]
    prog = expr.compile_program(structure)
    assert kernels.classify_program(prog).kind == form
    leaves = _leaves(dev, 16, shape, 40 + i)
    got = kernels.tree_rows(prog, leaves)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.tree_rows_plain(prog, leaves))


def test_tree_rows_salt_after_the_root_matches_plain(dev):
    prog = (kernels.OP_LEAF, kernels.OP_LEAF | 256, kernels.OP_AND,
            kernels.OP_SALT, kernels.OP_NOT)
    assert kernels.classify_program(prog).kind == kernels.FORM_CHAIN
    leaves = _leaves(dev, 2, (4, W), 60)
    for salt in (0, 7, 0x80000001):
        assert torch.equal(kernels.tree_rows(prog, leaves, salt),
                           kernels.tree_rows_plain(prog, leaves, salt))


def _level_case(dev, sizes, n_cand, seed, row_words=W, depth=None,
                filt=True, order="random"):
    rng = np.random.default_rng(seed)
    dims = [_leaves(dev, 1, (3, n, row_words), seed + d)[0]
            for d, n in enumerate(sizes)]
    idxs = [rng.integers(0, n, n_cand) for n in sizes]
    if order == "pad":  # the pruned level's pad candidates at index 0
        for ix in idxs:
            ix[n_cand // 2:] = 0
    f = _leaves(dev, 1, (3, row_words), seed + 99)[0] if filt else None
    planes = (_planes(dev, 3, depth, row_words, seed + 98)
              if depth is not None else None)
    return dims, idxs, f, planes


K9_EDGES = {  # name -> (sizes, C, depth, row_words, order)
    "one candidate": ((4, 3), 1, None, W, "random"),
    "C over the tile, not a multiple": ((8,) * 16, 300, None, W, "random"),
    "duplicated pads": ((10, 8, 16), 200, None, W, "pad"),
    "non-lexicographic": ((5, 7), 35, 20, W, "random"),
    "16 dimensions": ((2,) * 16, 64, None, W, "random"),
    "depth 63": ((6,), 6, 63, W, "random"),
    "ragged, vec 0": ((5, 3), 15, 7, 1001, "random"),
    "ragged tile": ((5, 3), 15, None, 3 * 1024 + 4, "random"),
}


@pytest.mark.parametrize("name", list(K9_EDGES))
def test_groupby_level_edges_match_plain(dev, name):
    sizes, n_cand, depth, row_words, order = K9_EDGES[name]
    dims, idxs, f, planes = _level_case(dev, sizes, n_cand, 70, row_words,
                                        depth, order=order)
    plan = kernels.groupby_plan(idxs, True, depth, row_words,
                                row_words % 4 == 0)
    if name.startswith("C over"):
        assert len(plan.tiles) > 1  # the plan had to split
    got = kernels.groupby_level(dims, idxs, f, planes)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.groupby_level_plain(dims, idxs, f,
                                                        planes))


@pytest.mark.parametrize("chunk", [2, 4])
@pytest.mark.parametrize("tile_words", [256, 512, 1024])
def test_groupby_level_plan_variants_match_plain(dev, chunk, tile_words):
    """K9 under forced plans: every word tile that fits, both chunks,
    groups of 8 and of 2."""
    dims, idxs, f, _ = _level_case(dev, (10, 8, 16), 300, 90)
    want = kernels.groupby_level_plain(dims, idxs, f)
    for group_max in (8, 2):
        try:
            plan = kernels.groupby_plan(idxs, True, None, W, True,
                                        tile_words=tile_words,
                                        chunk_elems=chunk,
                                        group_max=group_max)
        except ValueError:  # 35 rows of 1024 words do not fit
            assert tile_words == 1024
            return
        got = kernels.groupby_level(dims, idxs, f, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), group_max


K1_SALTS = [0, 7, 0x80000001, 0xFFFFFFFF]


@pytest.mark.parametrize("row_words", [W, 4099])
@pytest.mark.parametrize("i", range(len(K2_PROGRAMS)))
def test_tree_count_forms_match_plain(dev, monkeypatch, row_words, i):
    """K1 in every program form and leaf bucket (the general form up to a
    16-deep stack), over a 4-query micro-batch with four salts, on 16-byte
    groups and on ragged rows (one word at a time), one step a block and
    four."""
    structure, form = K2_PROGRAMS[i]
    prog = expr.compile_program(structure)
    for salted in (prog, prog + (kernels.OP_SALT,)):
        assert kernels.classify_program(salted).kind == form
        qs = [_leaves(dev, 16, (3 * row_words,), 80 + 4 * i + q)
              for q in range(len(K1_SALTS))]
        want = kernels.tree_count_plain(salted, qs, K1_SALTS, row_words)
        for steps in (1, 4):
            monkeypatch.setitem(kernels.TREE_COUNT_STEPS, form, steps)
            got = kernels.tree_count(salted, qs, K1_SALTS, row_words)
            torch.cuda.synchronize()
            assert torch.equal(got, want), steps


def _wide_planes(dev, n_shards, depth, row_words, seed):
    """Sparse planes whose every stored value is at least 2^40 when depth
    > 40, with shard 1 holding no column at all."""
    planes = _planes(dev, n_shards, depth, row_words, seed, density_words=10)
    if depth > 40:
        planes[:, 2 + 40] = planes[:, 0]
    planes[1] = 0
    return planes


def _minmax_oracle(planes, filt, want_max):
    """Per shard (value, count) from the set columns' Python-int values."""
    host = planes.cpu().numpy().view(np.uint32)
    mask = host[:, 0] if filt is None else host[:, 0] & filt.cpu().numpy(
    ).view(np.uint32)
    out = []
    for s in range(host.shape[0]):
        bits = np.unpackbits(mask[s].view(np.uint8), bitorder="little")
        cols = np.flatnonzero(bits)
        if cols.size == 0:
            out.append((None, 0))
            continue
        vals = [0] * cols.size
        for b in range(host.shape[1] - 2):
            plane = np.unpackbits(host[s, 2 + b].view(np.uint8),
                                  bitorder="little")[cols]
            for j in np.flatnonzero(plane):
                vals[j] |= 1 << b
        best = max(vals) if want_max else min(vals)
        out.append((best, vals.count(best)))
    return out


@pytest.mark.parametrize("row_words", [W, 1001])
@pytest.mark.parametrize("depth", [20, 41, 63])
@pytest.mark.parametrize("want_max", [False, True])
def test_bsi_minmax_wide_matches_plain_and_oracle(dev, row_words, depth,
                                                  want_max):
    """K7 at depth 20, 41 and 63 (values of 2^40 and more), with and
    without a filter, with a shard that has no column and one the filter
    empties, against the plain version and a Python-int oracle."""
    planes = _wide_planes(dev, 6, depth, row_words, 100 + depth)
    (filt,) = _leaves(dev, 1, (6, row_words), 101)
    filt[4] = 0
    for f in (None, filt):
        got_v, got_n = kernels.bsi_minmax(planes, f, want_max)
        torch.cuda.synchronize()
        want_v, want_n = kernels.bsi_minmax_plain(planes, f, want_max)
        assert got_v.dtype == torch.int64
        assert torch.equal(got_n, want_n)
        live = want_n > 0
        assert torch.equal(got_v[live], want_v[live])
        for s, (value, count) in enumerate(_minmax_oracle(planes, f,
                                                          want_max)):
            assert int(got_n[s]) == count, s
            if count:
                assert int(got_v[s]) == value, s
        assert int(got_n[1]) == 0 and (f is None or int(got_n[4]) == 0)
    assert kernels.launches()["bsi_minmax"] > 0


def test_wide_tree_runs_as_tree_steps_on_the_card(dev, tmp_path):
    """A 40-leaf Union and a 20-deep nested tree: the plan cuts 'tree'
    steps that K2 materializes, then K1 or K2 runs the root; the answers
    equal the same executor's on the CPU."""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.storage import Holder, load_from_dense

    rng = np.random.default_rng(110)
    rows = {r: rng.integers(0, 1 << 32, 2 * W, dtype=np.uint32)
            & rng.integers(0, 1 << 32, 2 * W, dtype=np.uint32)
            for r in range(6)}
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    h.close()
    union = "Union(" + ", ".join(f"Row(f={k % 6})" for k in range(40)) + ")"
    nested = "Row(f=0)"
    for k in range(20):
        op = "Difference" if k % 2 else "Union"
        nested = f"{op}(Row(f={k % 6}), {nested})"
    queries = [f"Count({union})", f"Count({nested})", nested,
               f"Count(Intersect({union}, {nested}))"]
    answers = {}
    for device in ("cpu", "cuda"):
        hd = Holder(str(tmp_path / "d"), device=device).open()
        try:
            kernels.reset_launches()
            answers[device] = [Executor(hd, device=device).execute("i", q)[0]
                               for q in queries]
            if device == "cuda":
                assert kernels.launches()["tree_rows"] >= 4
        finally:
            hd.close()
    cpu, cuda = answers["cpu"], answers["cuda"]
    assert cpu[:2] == cuda[:2] and cpu[3] == cuda[3]
    assert cpu[2].segments.keys() == cuda[2].segments.keys()
    for shard, words in cpu[2].segments.items():
        assert np.array_equal(words, cuda[2].segments[shard])


def _time_mutex_dir(path) -> None:
    """4 shards: a YMDH time field t filled by timestamped imports, a
    mutex field k and a set field f, written on the CPU."""
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import FieldOptions, Holder

    rng = np.random.default_rng(120)
    h = Holder(str(path), device="cpu").open()
    idx = h.create_index("i")
    idx.create_field("t", FieldOptions(type="time", time_quantum="YMDH"))
    idx.create_field("k", FieldOptions(type="mutex"))
    idx.create_field("f")
    api = API(h)
    cols = rng.integers(0, 4 * W * 32, 4000)
    stamps = [f"2019-{1 + m % 12:02d}-0{1 + m % 9}T{m % 24:02d}:00"
              for m in rng.integers(0, 1000, cols.size)]
    api.import_bits("i", "t", rng.integers(0, 3, cols.size).tolist(),
                    cols.tolist(), timestamps=stamps)
    cols = np.unique(rng.integers(0, 4 * W * 32, 20000))
    api.import_bits("i", "k", rng.integers(0, 4, cols.size).tolist(),
                    cols.tolist())
    api.import_bits("i", "f", [1] * 3000,
                    rng.integers(0, 4 * W * 32, 3000).tolist())
    h.close()


def _on_both_devices(tmp_path, script) -> None:
    """``script(api)`` on a CPU and a CUDA server API over copies of one
    time/mutex dir: the same answers, the CUDA one's K3 launches as
    ``script`` asserts, and each resident leaf equal to the OR of its
    views' host rows."""
    import shutil

    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import Holder

    _time_mutex_dir(tmp_path / "seed")
    answers = {}
    for device in ("cpu", "cuda"):
        shutil.copytree(tmp_path / "seed", tmp_path / device)
        h = Holder(str(tmp_path / device), device=device).open()
        try:
            kernels.reset_launches()
            answers[device] = script(API(h), device)
            idx = h.index("i")
            for key, arr in list(h.cache._rows.items()):
                if key[0] != "stack":
                    continue
                field, views, row = key[3], key[4], key[5]
                host = arr.cpu().numpy().view(np.uint32)
                want = np.zeros_like(host)
                for s in range(4):
                    for vname in views:
                        view = idx.field(field).view(vname)
                        frag = view.fragment(s) if view else None
                        if frag is not None:
                            want[s] |= frag.row_words(row)
                assert np.array_equal(host, want), key[3:6]
        finally:
            h.close()
    assert answers["cpu"] == answers["cuda"]


WINDOW = "from='2019-03-15T07:00', to='2020-03-15T07:00'"


def test_multi_view_leaf_patch_on_the_card(dev, tmp_path):
    """A timestamped Set into a view that did not exist when the 65-view
    leaf was built patches it through one K3 launch; a Clear on the time
    field re-decodes the slot; a timestamped import at a new hour is one
    launch for every leaf whose cover names it."""
    def script(api, device):
        q = [f"Count(Row(t=1, {WINDOW}))", f"Count(Row(t=0, {WINDOW}))",
             "Count(Row(t=1, from='2019-01-01', to='2020-01-01'))"]
        out = [api.query_raw("i", pql)[0] for pql in q]
        before = kernels.launches()["word_patch"]
        out += api.query_raw("i", "Set(1048579, t=1, "
                                  "timestamp='2019-06-28T13:00')")
        if device == "cuda":
            assert kernels.launches()["word_patch"] == before + 1
        out += [api.query_raw("i", pql)[0] for pql in q]
        out += api.query_raw("i", "Clear(1048579, t=1)")
        out += [api.query_raw("i", pql)[0] for pql in q]
        before = kernels.launches()["word_patch"]
        cols = [s * W * 32 + 77 for s in range(4)]
        out.append(api.import_bits("i", "t", [0, 1, 0, 1], cols,
                                   timestamps=["2019-09-17T05:00"] * 4))
        if device == "cuda":
            assert kernels.launches()["word_patch"] == before + 1
        return out + [api.query_raw("i", pql)[0] for pql in q]

    _on_both_devices(tmp_path, script)


def test_mutex_import_is_one_k3_launch_on_the_card(dev, tmp_path):
    def script(api, device):
        q = ["Count(Row(k=0))", "Count(Row(k=2))",
             "Count(Intersect(Row(k=0), Row(k=2)))"]
        out = [api.query_raw("i", pql)[0] for pql in q]
        topn = api.query_raw("i", "TopN(k)")[0]
        h = api.holder
        frag_cols = []
        for s in range(4):
            frag = h.index("i").field("k").view("standard").fragment(s)
            frag_cols.append(s * W * 32 + int(frag.row_columns(0)[0]))
        before = kernels.launches()["word_patch"]
        out.append(api.import_bits("i", "k", [2] * 4, frag_cols))
        if device == "cuda":
            assert kernels.launches()["word_patch"] == before + 1
        out += [api.query_raw("i", pql)[0] for pql in q]
        return out + [[(p.id, p.count) for p in topn],
                      [(p.id, p.count) for p in
                       api.query_raw("i", "TopN(k)")[0]]]

    _on_both_devices(tmp_path, script)


def test_store_and_clear_row_on_the_card(dev, tmp_path):
    """Store takes its child's row through K2 and rewrites each shard's
    row (re-read into the resident leaf); ClearRow of that sparse row is
    one K3 launch and leaves the leaf resident, empty."""
    def script(api, device):
        out = api.query_raw("i", f"Store(Union(Row(t=2, {WINDOW}), "
                                 "Row(k=1)), s=1)")
        out += api.query_raw("i", "Count(Row(s=1)) Count(Row(f=1))")
        assert out[1] > 0
        out += api.query_raw("i", "Store(Row(k=3), f=1)")
        out += api.query_raw("i", "Count(Row(f=1)) Count(Row(k=3))")
        before = kernels.launches()["word_patch"]
        out += api.query_raw("i", "ClearRow(s=1)")
        if device == "cuda":
            assert kernels.launches()["word_patch"] == before + 1
            assert kernels.launches()["tree_rows"] >= 2
        out += api.query_raw("i", "Count(Row(s=1))")
        assert any(k[0] == "stack" and k[3] == "s"
                   for k in api.holder.cache._rows)
        return out

    _on_both_devices(tmp_path, script)


def test_keyed_count_topn_groupby_on_the_card(dev, tmp_path):
    """A keyed index and keyed fields (row keys, column keys): Counts,
    TopN with its keys and attr filter, GroupBy by rowKey, a keyed Row
    and a keyed Set moving a mutex column (one K3 launch) answer on the
    card as on the CPU, through K1, K8, K9 and K3."""
    import json
    import shutil

    from pilosa_tpu_torch.executor import result_to_json
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import FieldOptions, Holder, load_from_dense

    rng = np.random.default_rng(130)
    n = 4 * W * 32
    pay = rng.integers(0, 4, n).astype(np.uint8)
    h = Holder(str(tmp_path / "seed"), device="cpu").open()
    load_from_dense(
        h, {"pay": {k: np.packbits(pay == i, bitorder="little").view("<u4")
                    for i, k in enumerate(("CRD", "CSH", "NOC", "DIS"))},
            "cab": {1: rng.integers(0, 1 << 32, 4 * W, dtype=np.uint32)}},
        options={"pay": FieldOptions(type="mutex", keys=True)},
        index="rides")
    seg = {f"s{k}": np.packbits(rng.random(W * 32) < 2.0 ** -k,
                                bitorder="little").view("<u4")
           for k in range(1, 5)}
    load_from_dense(h, {"segment": seg},
                    options={"segment": FieldOptions(keys=True)},
                    index="users",
                    column_keys=[f"u{i:07d}" for i in range(W * 32)])
    h.close()
    rides = ['Count(Intersect(Row(pay="CRD"), Row(cab=1)))',
             "TopN(pay, n=5)", "GroupBy(Rows(pay), Rows(cab))",
             'SetRowAttrs(pay, "CRD", kind="card") '
             'TopN(pay, n=5, attrName="kind", attrValue="card")',
             'Set(5, pay="VOD")', 'Count(Row(pay="VOD")) TopN(pay, n=5)']
    users = ['Count(Intersect(Row(segment="s1"), Row(segment="s2")))',
             'Row(segment="s4")', 'Set("new", segment="s1")',
             'Count(Row(segment="s1")) IncludesColumn(Row(segment="s1"), '
             'column="new")']
    answers = {}
    for device in ("cpu", "cuda"):
        shutil.copytree(tmp_path / "seed", tmp_path / device)
        hd = Holder(str(tmp_path / device), device=device).open()
        try:
            api = API(hd)
            kernels.reset_launches()
            out = [json.dumps(result_to_json(api.query_raw("rides", q)))
                   for q in rides]
            out += [json.dumps(result_to_json(api.query_raw("users", q)))
                    for q in users]
            answers[device] = out
            if device == "cuda":
                launched = kernels.launches()
                for name in ("tree_count", "count_rows", "groupby_level",
                             "word_patch"):
                    assert launched[name] > 0, name
        finally:
            hd.close()
    assert answers["cuda"] == answers["cpu"]


# ------------------------------------------------ K10, K11 and the tiers


def _sparse_blocks(rng, n_blocks: int, nb: int) -> np.ndarray:
    words = np.zeros(n_blocks * 1024, np.uint32)
    for b in rng.choice(n_blocks, nb, replace=False):
        words[b * 1024:(b + 1) * 1024] = rng.integers(0, 1 << 32, 1024,
                                                      dtype=np.uint32)
    return words


@pytest.mark.parametrize("n_blocks,nb", [(1, 0), (1, 1), (40, 33),
                                         (4096, 391), (4096, 0), (257, 256)])
def test_block_gather_and_scatter_match_plain(dev, n_blocks, nb):
    """K10 and K11 bit-exact against their plain versions: padding that
    repeats the first real index, an all-zero leaf, a full prefix past
    32 entries (the 32-way search's several rounds)."""
    rng = np.random.default_rng(n_blocks + nb)
    words = _sparse_blocks(rng, n_blocks, nb)
    block_idx = np.flatnonzero(words.reshape(-1, 1024).any(axis=1)).astype(
        np.int32)
    k = len(block_idx)
    idx_host = np.full(max(1, 1 << max(k - 1, 0).bit_length()),
                       block_idx[0] if k else 0, np.int32)
    idx_host[:k] = block_idx
    flat = torch.from_numpy(words.view(np.int32)).to(dev)
    idx = torch.from_numpy(idx_host).to(dev)
    blocks = kernels.block_gather(flat, idx)
    assert torch.equal(blocks, kernels.block_gather_plain(flat, idx))
    back = kernels.block_scatter(blocks, idx, n_blocks, block_idx)
    torch.cuda.synchronize()
    assert torch.equal(back, kernels.block_scatter_plain(blocks, idx,
                                                         n_blocks))
    assert torch.equal(back, flat)


@pytest.mark.parametrize("n_leaves", [1, 2, 5, 16])
def test_block_gather_batch_matches_plain(dev, n_leaves):
    """The batched K10 bit-exact against its plain version: leaves of
    mixed sizes (an all-zero one among them), duplicate padding, each
    leaf's rows and index copy in outputs of its own (one without a
    copy); the one-leaf call equal to the batch's rows."""
    rng = np.random.default_rng(40 + n_leaves)
    flats, idxs = [], []
    for k in range(n_leaves):
        n_blocks = int(rng.integers(1, 300))
        nb = 0 if k == 1 else int(rng.integers(1, n_blocks + 1) // 2 + 1)
        words = _sparse_blocks(rng, n_blocks, min(nb, n_blocks))
        block_idx = np.flatnonzero(words.reshape(-1, 1024).any(axis=1)
                                   ).astype(np.int32)
        m = len(block_idx)
        idx = np.full(max(1, 1 << max(m - 1, 0).bit_length()),
                      block_idx[0] if m else 0, np.int32)
        idx[:m] = block_idx
        flats.append(torch.from_numpy(words.view(np.int32)).to(dev))
        idxs.append(idx)
    outs = [torch.full((i.size * 1025,), -7, dtype=torch.int32, device=dev)
            for i in idxs]
    before = kernels.launches()
    kernels.block_gather_batch(flats, idxs, outs, with_index=True)
    after = kernels.launches()
    want = kernels.block_gather_batch_plain(
        flats, [torch.from_numpy(i).to(dev) for i in idxs])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([o[:i.size * 1024].view(-1, 1024)
                                  for o, i in zip(outs, idxs)]), want)
    assert np.array_equal(torch.cat([o[i.size * 1024:] for o, i in zip(
        outs, idxs)]).cpu().numpy(), np.concatenate(idxs))
    assert after["block_gather"] == before["block_gather"] + 1
    assert after["block_gather_batch"] == before["block_gather_batch"] + (
        n_leaves > 1)
    bare = [torch.full((i.size * 1024,), -7, dtype=torch.int32, device=dev)
            for i in idxs]
    kernels.block_gather_batch(flats, idxs, bare)
    for f, i, o, b in zip(flats, idxs, outs, bare):
        one = kernels.block_gather(f, torch.from_numpy(i).to(dev))
        assert torch.equal(one.view(-1), o[:i.size * 1024])
        assert torch.equal(b, o[:i.size * 1024])


@pytest.mark.parametrize("nb", [1, 512, 960, 961, 2048])
def test_block_gather_one_leaf_either_transport(dev, nb):
    """One leaf through the batch wrapper: an index of at most 960
    entries in the launch's parameters, a longer one through the staged
    table; blocks and index copy bit-exact either way."""
    rng = np.random.default_rng(47 + nb)
    n_blocks = 4096
    words = _sparse_blocks(rng, n_blocks, min(nb, 2048))
    idx = np.sort(rng.choice(n_blocks, nb, replace=False)).astype(np.int32)
    flat = torch.from_numpy(words.view(np.int32)).to(dev)
    out = torch.full((nb * 1025,), -7, dtype=torch.int32, device=dev)
    kernels.block_gather_batch([flat], [idx], [out], with_index=True)
    want = kernels.block_gather_plain(flat, torch.from_numpy(idx).to(dev))
    torch.cuda.synchronize()
    assert torch.equal(out[:nb * 1024].view(nb, 1024), want)
    assert np.array_equal(out[nb * 1024:].cpu().numpy(), idx)


def test_block_gather_out_of_range_gives_zero_blocks(dev):
    """An index outside its own leaf yields a zero block, in the batch
    (a neighbour's block number past this leaf's end) and alone."""
    rng = np.random.default_rng(44)
    a = torch.from_numpy(_sparse_blocks(rng, 8, 8).view(np.int32)).to(dev)
    b = torch.from_numpy(_sparse_blocks(rng, 3, 3).view(np.int32)).to(dev)
    ia, ib = np.array([7, -1, 2, 0], np.int32), np.array([5, 2], np.int32)
    oa = torch.full((4 * 1024,), -7, dtype=torch.int32, device=dev)
    ob = torch.full((2 * 1024,), -7, dtype=torch.int32, device=dev)
    kernels.block_gather_batch([a, b], [ia, ib], [oa, ob])
    oa, ob = oa.view(4, 1024), ob.view(2, 1024)
    torch.cuda.synchronize()
    blocks_a, blocks_b = a.view(-1, 1024), b.view(-1, 1024)
    assert torch.equal(oa[0], blocks_a[7]) and torch.equal(oa[2],
                                                           blocks_a[2])
    assert not oa[1].any() and not ob[0].any()
    assert torch.equal(ob[1], blocks_b[2])
    one = kernels.block_gather(b, torch.tensor([3, 1], dtype=torch.int32,
                                               device=dev))
    assert not one[0].any() and torch.equal(one[1], blocks_b[1])


def test_tier_pass_gathers_on_the_card(dev):
    """One host-tier demotion of several block-indexed stacks is one K10
    launch; only their compact blocks are read back, the host entries
    hold the plain gather's blocks and every leaf comes back bit-exact."""
    from pilosa_tpu_torch.storage.residency import DeviceRowCache

    rng = np.random.default_rng(45)
    cache = DeviceRowCache(budget_bytes=64 << 20, device=dev)
    hosts = {}
    for n in range(6):
        hosts[n] = _sparse_blocks(rng, 64, 2 + 3 * n).reshape(2, 32 * 1024)
        cache.get_row(("stack", "/d", "i", "f", n), lambda h=hosts[n]:
                      h.copy())
    before = kernels.launches()
    moved, freed = cache.demote_field_stacks_to_host("/d", "i", "f")
    after = kernels.launches()
    assert moved == 6 and freed == 6 * 2 * 32 * 1024 * 4
    assert after["block_gather_batch"] == before["block_gather_batch"] + 1
    assert after["block_gather"] == before["block_gather"] + 1
    compact = 0
    for n, host in hosts.items():
        entry = cache._host[("stack", "/d", "i", "f", n)]
        assert np.array_equal(entry.blocks,
                              host.reshape(-1, 1024)[entry.idx])
        compact += entry.blocks.nbytes
        got = cache.get_row(("stack", "/d", "i", "f", n), lambda: 1 / 0)
        assert np.array_equal(got.cpu().numpy().view(np.uint32), host)
    assert cache.readback_bytes == compact


def test_eviction_compresses_several_victims_in_one_launch(dev):
    """An eviction that demotes several victims gathers them in one K10
    launch, each compressed copy in a tensor of its own (blocks and the
    index K11 reads, exactly its accounted bytes); every one promotes
    back bit-exact through K11."""
    from pilosa_tpu_torch.storage.residency import DeviceRowCache

    rng = np.random.default_rng(46)
    leaf = 2 * 32 * 1024 * 4
    cache = DeviceRowCache(budget_bytes=3 * leaf, device=dev)
    hosts = {n: _sparse_blocks(rng, 64, 1 + 2 * n).reshape(2, 32 * 1024)
             for n in range(4)}
    for n, host in hosts.items():
        cache.get_row((n,), lambda h=host: h.copy())
    before = kernels.launches()
    wide = rng.integers(1, 1 << 32, (5, 32 * 1024), dtype=np.uint32)
    cache.get_row(("wide",), lambda: wide.copy())
    after = kernels.launches()
    assert cache.compressions == 4
    assert after["block_gather"] == before["block_gather"] + 1
    assert after["block_gather_batch"] == before["block_gather_batch"] + 1
    for n in hosts:
        centry = cache._compressed[(n,)]
        assert centry.words.untyped_storage().nbytes() == centry.nbytes
    for n, host in hosts.items():
        got = cache.get_row((n,), lambda: 1 / 0)
        assert np.array_equal(got.cpu().numpy().view(np.uint32), host)


def test_residency_tiers_round_trip_on_the_card(dev):
    """The cache on the card: a sparse leaf demoted by K10, promoted by
    K11, moved to the host tier and served back, bit-exact; a K3 patch
    makes a leaf drop instead of compress."""
    from pilosa_tpu_torch.storage.residency import DeviceRowCache, WordPatch

    rng = np.random.default_rng(3)
    host = _sparse_blocks(rng, 64, 9).reshape(2, 32 * 1024)
    cache = DeviceRowCache(budget_bytes=400 << 10, device=dev)
    key = ("stack", "/d", "i", "f", ("standard",), 1, "blk")
    cache.get_row(key, lambda: host.copy())
    before = kernels.launches()
    cache.get_row(("other",), lambda: _sparse_blocks(rng, 64, 3).reshape(
        2, -1))  # key -> compressed
    got = cache.get_row(key, lambda: 1 / 0)  # -> dense again
    after = kernels.launches()
    assert after["block_gather"] > before["block_gather"]
    assert after["block_scatter"] > before["block_scatter"]
    assert np.array_equal(got.cpu().numpy().view(np.uint32), host)
    cache.demote_field_stacks_to_host("/d", "i", "f")
    got = cache.get_row(key, lambda: 1 / 0)
    assert cache.host_hits == 1
    assert np.array_equal(got.cpu().numpy().view(np.uint32), host)
    cache.register_updater(key, ("/d", "i", "f"), lambda ev: WordPatch(
        0, None, np.array([5], np.int32), np.array([1], np.uint32), False))
    from pilosa_tpu_torch.storage.residency import WriteEvent

    cache.apply_write(WriteEvent("i", "f", "standard", 0, 1, scope="/d"))
    cache.get_row(("third",), lambda: _sparse_blocks(rng, 64, 3).reshape(
        2, -1))
    torch.cuda.synchronize()
    assert key not in cache._rows and key not in cache._compressed


def _memo_dir(path, rows: int) -> dict:
    """Rows 0..rows-1 of a set field f over 2 shards, ~1/4 of the bits
    set, written on the CPU; returns the host words of each row."""
    from pilosa_tpu_torch.storage import Holder, load_from_dense

    rng = np.random.default_rng(120)
    words = {r: rng.integers(0, 1 << 32, 2 * W, dtype=np.uint32)
             & rng.integers(0, 1 << 32, 2 * W, dtype=np.uint32)
             for r in range(rows)}
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"f": words}, index="i")
    h.close()
    return words


def test_memo_hit_after_a_k3_patch_reads_the_patched_words(dev, tmp_path):
    """The operand memo on the card: a Count served from the memo after a
    Set and an import reads the words K3 patched in place, the same
    tensor the memo and the cache hold, equal to the CPU's answer."""
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import Holder

    import shutil

    words = _memo_dir(tmp_path / "d", 2)
    free = np.flatnonzero(np.unpackbits(
        (~words[0] & words[1]).view(np.uint8), bitorder="little"))
    q = "Count(Intersect(Row(f=0), Row(f=1)))"
    answers = {}
    for device in ("cpu", "cuda"):
        # each device writes into a copy of its own
        shutil.copytree(tmp_path / "d", tmp_path / device)
        h = Holder(str(tmp_path / device), device=device).open()
        try:
            api = API(h)
            ex = api.executor
            got = [api.query_raw("i", q)[0] for _ in range(2)]
            assert ex.memo_hits >= 1
            leaf = next(iter(ex._operand_memo.values()))[2][0]
            k3 = kernels.launches()["word_patch"]
            assert api.query_raw("i", f"Set({int(free[0])}, f=0)") == [True]
            api.import_bits("i", "f", [0], [int(free[1])])
            if device == "cuda":
                assert kernels.launches()["word_patch"] == k3 + 2
            hits = ex.memo_hits
            got += [api.query_raw("i", q)[0] for _ in range(3)]
            assert ex.memo_hits >= hits + 2
            # the leaf was patched in place, not replaced
            assert next(iter(ex._operand_memo.values()))[2][0] is leaf
            answers[device] = got
        finally:
            h.close()
    assert answers["cuda"] == answers["cpu"]
    assert answers["cuda"][2] == answers["cuda"][0] + 2


def test_eviction_frees_a_leaf_the_memo_held(dev, tmp_path):
    """An eviction bumps the cache's generation, whose listener clears
    the executor's operand memo: the evicted leaf's device memory is
    freed at once, though the memo held it a query earlier."""
    import gc
    import weakref

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.storage import Holder

    _memo_dir(tmp_path / "d", 3)
    leaf = 2 * W * 4
    # one dense leaf: its bits are dense, so it is dropped, not compressed
    h = Holder(str(tmp_path / "d"), device="cuda",
               budget_bytes=leaf + leaf // 2).open()
    try:
        ex = Executor(h, device="cuda")
        for _ in range(2):
            ex.execute("i", "Count(Row(f=0))")
        assert ex.memo_hits == 1 and ex._operand_memo
        held = next(iter(ex._operand_memo.values()))[2][0]
        ref = weakref.ref(held)
        del held
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        gen = h.cache.generation
        ex.execute("i", "Count(Row(f=1))")  # evicts row 0's leaf
        gc.collect()
        torch.cuda.synchronize()
        assert h.cache.generation > gen and h.cache.evictions == 1
        assert ref() is None  # nothing holds the evicted leaf
        # row 1's leaf went up and row 0's came down: no net growth
        assert torch.cuda.memory_allocated() - before < leaf // 2
        got = ex.execute("i", "Count(Row(f=0))")[0]
    finally:
        h.close()
    hc = Holder(str(tmp_path / "d"), device="cpu").open()
    try:
        assert got == Executor(hc, device="cpu").execute(
            "i", "Count(Row(f=0))")[0]
    finally:
        hc.close()


def test_quarantine_and_self_heal_on_the_card(dev, tmp_path):
    """A data dir with a rotten fragment opens on the card with it
    quarantined; a byte flipped under a resident leaf is healed by a
    scrub pass that keeps the leaf (no row-cache miss after); every
    Count runs through K1 and equals a CPU server's answer."""
    import os
    import shutil

    from pilosa_tpu_torch.parallel.scrub import Scrubber
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.storage import Holder

    rng = np.random.default_rng(21)
    h = Holder(str(tmp_path / "seed"), device="cpu").open()
    idx = h.create_index("i")
    for name, rows in (("f", (1, 2)), ("g", (7,))):
        fld = idx.create_field(name)
        for s in range(4):
            for r in rows:
                pos = np.unique(rng.integers(0, W * 32, 5000)).astype(
                    np.uint64)
                fld.view("standard", create=True).fragment(
                    s, create=True).bulk_import(
                        np.full(pos.size, r, np.uint64), pos)
    h.close()

    def frag_path(root, shard):
        return os.path.join(root, "i", "f", "views", "standard",
                            "fragments", str(shard))

    p = frag_path(str(tmp_path / "seed"), 1)
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) - 3)
        b = f.read(1)
        f.seek(os.path.getsize(p) - 3)
        f.write(bytes([b[0] ^ 0x10]))
    q = ["Count(Intersect(Row(f=1), Row(g=7)))", "Count(Row(f=2))",
         "Options(Count(Row(f=1)), shards=[1])"]
    answers = {}
    for device in ("cpu", "cuda"):
        root = str(tmp_path / device)
        shutil.copytree(tmp_path / "seed", root)
        h = Holder(root, device=device).open()
        try:
            assert sorted(h.index("i").field("f").view(
                "standard").fragments) == [0, 2, 3]
            api = API(h)
            kernels.reset_launches()
            out = [api.query_raw("i", pql)[0] for pql in q]
            p = frag_path(root, 0)
            with open(p, "r+b") as f:
                f.seek(os.path.getsize(p) - 3)
                b = f.read(1)
                f.seek(os.path.getsize(p) - 3)
                f.write(bytes([b[0] ^ 0x10]))
            misses = h.cache.misses
            rec = Scrubber(h).scrub_pass()
            assert rec["self_healed"] == 1 and rec["corrupt"] == 1
            out += [api.query_raw("i", pql)[0] for pql in q]
            assert h.cache.misses == misses
            if device == "cuda":
                assert kernels.launches()["tree_count"] > 0
            answers[device] = out
        finally:
            h.close()
    assert answers["cuda"] == answers["cpu"]
    assert answers["cpu"][2] == 0


# ------------------------------------------------- the serving envelope


def _serving_dir(path) -> None:
    """4 shards: fields f (rows 1-3) and g (row 7), written on the CPU."""
    from pilosa_tpu_torch.storage import Holder, load_from_dense

    rng = np.random.default_rng(150)
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {
        "f": {r: rng.integers(0, 1 << 32, 4 * W, dtype=np.uint32)
              & rng.integers(0, 1 << 32, 4 * W, dtype=np.uint32)
              for r in (1, 2, 3)},
        "g": {7: rng.integers(0, 1 << 32, 4 * W, dtype=np.uint32)}},
        index="i")
    h.close()


def _post(port, path, body=b"", headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_wave_launched_by_the_dispatcher_reads_back_on_request_threads(
        dev, tmp_path):
    """One wave of 12 reads, queued behind a held dispatcher: the
    dispatcher thread launches K1 (one micro-batch for the same-shape
    Counts) and K2 for requests whose own threads read the results back;
    every answer equals a CPU server's (the plain versions)."""
    import shutil
    import threading

    from pilosa_tpu_torch.server import Server

    _serving_dir(tmp_path / "seed")
    queries = ([f"Count(Intersect(Row(f={r}), Row(g=7)))" for r in (1, 2, 3)]
               * 3 + ["Row(f=1)", "Count(Union(Row(f=1), Row(f=3)))",
                      "Union(Row(f=2), Row(g=7))"])
    answers = {}
    for device in ("cpu", "cuda"):
        shutil.copytree(tmp_path / "seed", tmp_path / device)
        server = Server(str(tmp_path / device), port=0,
                        device=device).open()
        try:
            _post(server.port, "/index/i/query", b"Count(Row(g=7))")
            api = server.api
            real = api.executor
            entered, release = threading.Event(), threading.Event()

            class Held:
                def __getattr__(self, name):
                    return getattr(real, name)

                def submit(self, index, query, **kwargs):
                    if not entered.is_set():
                        entered.set()
                        assert release.wait(60)
                    return real.submit(index, query, **kwargs)

            api.executor = Held()
            out = [None] * len(queries)
            threads = [threading.Thread(target=lambda: _post(
                server.port, "/index/i/query", b"Count(Row(f=1))"))]
            threads += [threading.Thread(
                target=lambda k=k: out.__setitem__(k, _post(
                    server.port, "/index/i/query", queries[k].encode())))
                for k in range(len(queries))]
            try:
                threads[0].start()
                assert entered.wait(60)
                for t in threads[1:]:
                    t.start()
                pipe = api._pipeline
                for _ in range(60000):
                    if pipe._q.qsize() >= len(queries):
                        break
                    threading.Event().wait(0.001)
                kernels.reset_launches()
                release.set()
            finally:
                release.set()
                for t in threads:
                    t.join(120)
                api.executor = real
            answers[device] = out
            if device == "cuda":
                counts = sum(q.startswith("Count") for q in queries)
                launched = kernels.launches()
                # the wave's 9 same-shape Counts share one K1 launch
                assert 0 < launched["tree_count"] < counts
                assert launched["tree_rows"] >= 2
                assert api.pipeline_metrics()["coalesced"] >= len(queries)
        finally:
            server.close()
    assert all(s == 200 for s, _ in answers["cuda"])
    assert answers["cuda"] == answers["cpu"]


def test_trace_device_records_cuda_kernels(dev, tmp_path):
    """``POST /debug/trace-device`` on a CUDA server under load, asked
    once: the Chrome trace holds the card's kernel events, K1's among
    them (``tree_count_*``), not a CPU-only trace. The capture is asked
    once every client has had an answer (K1 built, loaded and launched)
    and the load runs until it has answered, so its whole window sees
    launches."""
    import json
    import os
    import threading

    from pilosa_tpu_torch.server import Server

    _serving_dir(tmp_path / "d")
    server = Server(str(tmp_path / "d"), port=0, device="cuda").open()
    stop = threading.Event()
    answered = threading.Barrier(5)

    def load():
        first = True
        while first or not stop.is_set():
            assert _post(server.port, "/index/i/query",
                         b"Count(Intersect(Row(f=1), Row(g=7)))")[0] == 200
            if first:
                answered.wait(600)
                first = False

    clients = [threading.Thread(target=load) for _ in range(4)]
    try:
        for t in clients:
            t.start()
        answered.wait(600)
        log_dir = tmp_path / "d" / "jax-traces"
        status, body = _post(server.port, "/debug/trace-device?secs=0.5")
        assert status == 200, body
        out = json.loads(body)
        assert out["logDir"] == str(log_dir)
        assert sorted(out) == ["logDir", "seconds"]
    finally:
        stop.set()
        for t in clients:
            t.join(60)
        server.close()
    (name,) = os.listdir(out["logDir"])
    with open(os.path.join(out["logDir"], name)) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = {e.get("name", "") for e in events
                    if e.get("cat") == "kernel"}
    assert any("tree_count" in n for n in kernel_names), sorted(
        kernel_names)[:10]


# ---------------------------------------------------------- mesh lanes


def _split_parts(dev, members: int, n: int, lo_max: int, hi_max: int,
                 seed: int) -> torch.Tensor:
    """int32[M, 2, n] split channels, the first column's group sums at
    the given maxima (a lane's bound exactly)."""
    rng = np.random.default_rng(seed)
    parts = np.zeros((members, 2, n), np.int32)
    parts[:, 0] = rng.integers(0, lo_max // members + 1, (members, n))
    parts[:, 1] = rng.integers(0, hi_max // members + 1, (members, n))
    parts[:, 0, 0] = lo_max // members
    parts[0, 0, 0] += lo_max % members
    return torch.from_numpy(parts).to(dev)


def _lane_layouts(parts: torch.Tensor, mode: str) -> dict:
    """The same [M, ...] partials as lane_reduce takes them: stacked, a
    member list, transposed member views (a micro-batch's [B, 2]) and
    strided views of a wider buffer."""
    m = parts.shape[0]
    wide = torch.zeros((*parts.shape[:-1], 3 * parts.shape[-1]),
                       dtype=parts.dtype, device=parts.device)
    wide[..., ::3] = parts
    out = {"stacked": parts, "members": [parts[k].clone() for k in range(m)],
           "stacked_strided": wide[..., ::3],
           "members_strided": [wide[k, ..., ::3] for k in range(m)]}
    if mode == "sum":
        out["members_b2"] = [parts[k].t().contiguous().t() for k in range(m)]
    return out


@pytest.mark.parametrize("members,groups,n,widths", [
    (8, 2, 1, (1, 1)), (8, 4, 700, (2, 1)), (8, 2, 129, (4, 2)),
    (4, 4, 3, (2, 4)), (64, 8, 5, (2, 2))])
def test_lane_reduce_matches_plain(dev, members, groups, n, widths):
    """K12+K13 through lanes of each width (group sums at 255, 65 535 and
    past them), from the members' partials in every layout, against the
    plain version, bit-exact, dtype too; the flat mesh's sum against
    torch.sum."""
    bound = {1: 255, 2: 65535, 4: 1 << 24}
    parts = _split_parts(dev, members, n, bound[widths[0]] * groups,
                         bound[widths[1]] * groups, members + n)
    want = kernels.lane_reduce_plain(parts, groups, widths)
    before = kernels.launches()["lane_reduce"]
    layouts = _lane_layouts(parts, "sum")
    for name, layout in layouts.items():
        got = kernels.lane_reduce(layout, groups, widths)
        assert got.dtype == torch.int32 and torch.equal(got, want), name
    assert kernels.launches()["lane_reduce"] == before + len(layouts)
    flat = kernels.lane_reduce(list(parts), 1, (4, 4))
    assert torch.equal(flat, kernels.lane_reduce_plain(parts, 1, (4, 4)))
    assert torch.equal(flat.cpu(), parts.cpu().sum(0, dtype=torch.int32))
    column = [parts[k, :, 0] for k in range(members)]  # [2] partials
    assert torch.equal(kernels.lane_reduce(column, groups, widths),
                       want[:, :1])


@pytest.mark.parametrize("dtype,width", [(torch.int64, 8), (torch.int32, 4),
                                         (torch.int32, 1), (torch.int64, 2)])
@pytest.mark.parametrize("mode", ["max", "min"])
def test_lane_extrema_match_plain(dev, dtype, width, mode):
    """The extremum lanes, narrowed where the width says (past their
    bound too: the cast wraps), from every layout and 0-d partials, and
    the flat fold over the members."""
    rng = np.random.default_rng(width)
    hi = 2 if width == 1 else 1 << 40 if dtype == torch.int64 else 1 << 30
    vals = torch.from_numpy(rng.integers(-hi if width > 1 else 0, hi,
                                         (8, 5))).to(dtype).to(dev)
    want = kernels.lane_reduce_plain(vals, 4, width, mode)
    assert want.dtype == (torch.int64 if width == 8 else torch.int32)
    for name, layout in _lane_layouts(vals, mode).items():
        got = kernels.lane_reduce(layout, 4, width, mode)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    scalars = [vals[k, 2] for k in range(8)]  # 0-d partials
    assert torch.equal(kernels.lane_reduce(scalars, 4, width, mode),
                       want[2:3])
    size = vals.element_size()
    assert torch.equal(kernels.lane_reduce(vals, 1, size, mode),
                       kernels.lane_reduce_plain(vals, 1, size, mode))


@pytest.mark.parametrize("rows,groups", [(1, 2), (300, 2), (65536, 4),
                                         (1000, 4)])
def test_quant_reduce_matches_plain(dev, rows, groups):
    """K14+K15 against its plain version, bit-exact, dtype too: blocks
    past 255 (scales > 1), an all-small block (scale 1), R not a multiple
    of 256, from the members' partials in every layout (a GroupBy
    level's [2, k, c] as [2, k*c] too), and the flat mesh's lossless
    pass-through (groups None); one launch a call."""
    parts = _split_parts(dev, 8, rows, 1 << 20, 1 << 12, rows)
    parts[:, 0, :256] %= 16  # the first block's totals <= 255: s == 1
    parts[:, 1, :256] = 0
    _, s = kernels.quant_pack_plain(parts, groups)
    assert int(s[:, 0].max()) == 1
    assert rows < 257 or int(s[:, 1:].max()) > 1
    layouts = _lane_layouts(parts, "sum")
    k = 2 if rows % 2 == 0 else 1
    layouts["groupby"] = [p.reshape(2, k, rows // k).clone().reshape(2, rows)
                          for p in parts]
    for g in (groups, None):
        want = kernels.quant_reduce_plain(parts, g)
        assert want.shape == (2, rows + -(-rows // 256))
        before = kernels.launches()["quant_reduce"]
        for name, layout in layouts.items():
            got = kernels.quant_reduce(layout, g)
            assert got.dtype == torch.int32 and torch.equal(got, want), \
                (name, g)
        assert kernels.launches()["quant_reduce"] == before + len(layouts)


def test_mesh_of_eight_members_on_one_card(dev, tmp_path):
    """``make_mesh(8, devices=[cuda], groups=2)``: the Star-Trace Counts,
    a Row, a TopN over the quantized lane and a Set between two reads,
    each equal to the single-device executor's, with K12+K13 and
    K14+K15 launched and no other lane kernel."""
    from pilosa_tpu_torch.executor import Executor, result_to_json
    from pilosa_tpu_torch.parallel import DistExecutor, make_mesh
    from pilosa_tpu_torch.storage import Holder

    _serving_dir(tmp_path / "d")
    h = Holder(str(tmp_path / "d"), device="cuda").open()
    try:
        mesh = DistExecutor(h, make_mesh(8, devices=[dev], groups=2),
                            quantized_ranking=True, verify_quantized=True)
        plain = Executor(h, device="cuda")
        queries = ["Count(Intersect(Row(f=1), Row(g=7)))",
                   "Count(Union(Row(f=2), Row(f=3)))",
                   "Count(Xor(Row(f=1), Row(g=7)))", "Row(f=2)",
                   "TopN(f, n=2)"]
        kernels.reset_launches()
        for q in queries:
            want = result_to_json(plain.execute("i", q))
            assert result_to_json(mesh.execute("i", q)) == want, q
        # a write through the mesh patches the resident leaf it read
        col = next(c for c in range(4 * W * 32) if not plain.execute(
            "i", f"IncludesColumn(Row(f=1), column={c})")[0])
        assert mesh.execute("i", f"Set({col}, f=1)") == [True]
        for q in queries[:1] + ["Row(f=1)"]:
            want = result_to_json(plain.execute("i", q))
            assert result_to_json(mesh.execute("i", q)) == want, q
        got = [d.result() for d in mesh.submit("i", " ".join(queries[:3]))]
        assert got == plain.execute("i", " ".join(queries[:3]))
        launched = kernels.launches()
        assert launched["lane_reduce"] > 0
        assert launched["quant_reduce"] > 0  # the quantized TopN
        assert "lane_pack" not in launched and "lane_fold" not in launched
        assert "quant_pack" not in launched and "quant_fold" not in launched
    finally:
        h.close()


def test_server_use_mesh_on_one_card(dev, tmp_path):
    """``use-mesh = true`` on one card builds a flat one-member mesh that
    answers as the plain executor; unset, one card serves with the plain
    Executor."""
    import shutil

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel import DistExecutor
    from pilosa_tpu_torch.server import Server

    _serving_dir(tmp_path / "seed")
    answers = {}
    for name, kwargs in (("plain", {}), ("mesh", {"use_mesh": True})):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
        server = Server(str(tmp_path / name), port=0, device="cuda",
                        **kwargs).open()
        try:
            want = DistExecutor if kwargs else Executor
            assert type(server.executor) is want
            if kwargs:
                assert server.executor.mesh.members == [
                    torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
            answers[name] = [_post(server.port, "/index/i/query", q)
                             for q in (b"Count(Intersect(Row(f=1), Row(g=7)))",
                                       b"TopN(f, n=2)", b"Row(g=7)")]
        finally:
            server.close()
    assert answers["mesh"] == answers["plain"]
    assert all(status == 200 for status, _ in answers["mesh"])

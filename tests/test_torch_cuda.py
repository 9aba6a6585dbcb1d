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
    kernels.word_patch(k, 2, word_idx, masks, word_idx.size, clear)
    kernels.word_patch_plain(p, 2, np.stack([word_idx, masks.view(np.int32)]),
                             clear)
    assert torch.equal(k, p)
    assert torch.equal(k[:2], leaf[:2]) and torch.equal(k[3:], leaf[3:])


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
    kernels.word_patch(k, 2, word_idx, masks, word_idx.size, clear, row=4)
    kernels.word_patch_plain(p, 2, np.stack([word_idx, masks.view(np.int32)]),
                             clear, row=4)
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

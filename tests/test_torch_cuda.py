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

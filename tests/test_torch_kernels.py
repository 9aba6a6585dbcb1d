"""The port's kernel plain versions against the JAX functions they replace.

On the CPU every kernel wrapper runs its plain PyTorch version (a CUDA
tensor would launch the kernel), so these tests pin the arithmetic the
CUDA kernels must match: exact integer equality, zero tolerance. Inputs
are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

from bench_pallas import pallas_intersect_count
from pilosa_tpu.executor import batch as jbatch
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import batch, expr

torch.set_num_threads(1)

W = 32768


def _t(words: np.ndarray) -> torch.Tensor:
    """uint32 host words → the port's int32 view (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        rng.integers(0, 1 << 32, 4096, dtype=np.uint32),
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xAAAAAAAA],
                 np.uint32),
    ])
    got = kernels.popcount32(_t(words)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.bitwise_count(words).astype(np.int32))


@pytest.mark.parametrize("salt", [0, 7, 0x80000001])
def test_intersect_count_matches_pallas_interpret(salt):
    rows, words, bw = 8, 4096, 512
    fn = pallas_intersect_count(bw, rows=rows, words=words, interpret=True)
    rng = np.random.default_rng(salt & 0xFF)
    a = rng.integers(0, 1 << 32, (rows, words), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (rows, words), dtype=np.uint32)
    want = np.asarray(fn(a, b, np.full(1, salt, np.uint32))).ravel()
    got = kernels.intersect_count(_t(a), _t(b), salt).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def _random_tree(rng, n_leaves: int, depth: int = 0):
    """A random and/or/xor/diff tree using every leaf index < n_leaves,
    with the occasional const0."""
    if n_leaves == 1 and (depth > 2 or rng.random() < 0.5):
        return ("const0",) if rng.random() < 0.1 else ("leaf", 0)
    op = ["and", "or", "xor", "diff"][int(rng.integers(4))]
    if n_leaves == 1:
        return (op, ("leaf", 0), ("const0",))
    split = int(rng.integers(1, n_leaves))
    left = _random_tree(rng, split, depth + 1)
    right = _shift_leaves(_random_tree(rng, n_leaves - split, depth + 1),
                          split)
    return (op, left, right)


def _shift_leaves(node, k):
    if node[0] == "leaf":
        return ("leaf", node[1] + k)
    if node[0] == "const0":
        return node
    return (node[0],) + tuple(_shift_leaves(c, k) for c in node[1:])


def _stacked(rng, n_shards: int, n: int, density: float = 0.5):
    """n stacked leaves uint32[next_pow2(n_shards), W], zero padding."""
    padded = 1 << (n_shards - 1).bit_length() if n_shards > 1 else 1
    out = []
    for _ in range(n):
        leaf = np.zeros((padded, W), np.uint32)
        bits = rng.random((n_shards, W * 32)) < density
        leaf[:n_shards] = np.packbits(bits, axis=1,
                                      bitorder="little").view("<u4")
        out.append(leaf)
    return out


@pytest.mark.parametrize("seed,n_leaves,n_shards", [
    (1, 1, 1), (2, 2, 3), (3, 3, 2), (4, 4, 3), (5, 2, 5), (6, 3, 1),
])
def test_count_and_row_match_local_fn(seed, n_leaves, n_shards):
    rng = np.random.default_rng(seed)
    tree = _random_tree(rng, n_leaves)
    leaves = _stacked(rng, n_shards, n_leaves, density=float(rng.random()))
    ranks = (1,) * n_leaves
    tl = [_t(x) for x in leaves]

    want_count = np.asarray(jbatch.local_fn(("count", tree), "count", ranks,
                                            0)(*leaves))
    got_count = batch.local_fn(("count", tree), "count", ranks)(*tl)
    assert got_count.dtype == torch.int32
    assert np.array_equal(got_count.numpy(), want_count)

    want_rows = np.asarray(jbatch.local_fn(tree, "row", ranks, 0)(*leaves))
    got_rows = batch.local_fn(tree, "row", ranks)(*tl)
    assert np.array_equal(_u(got_rows), want_rows)
    # the plain recursive evaluator agrees with the compiled program
    assert np.array_equal(_u(expr.evaluate(tree, tl)), want_rows)


def test_micro_batch_matches_local_fn_batched():
    rng = np.random.default_rng(11)
    tree = ("diff", ("or", ("leaf", 0), ("leaf", 1)), ("leaf", 2))
    structure = ("count", tree)
    n_q, ranks = 3, (1, 1, 1)
    leaves = _stacked(rng, 3, 3 * n_q, density=0.3)
    want = np.asarray(jbatch.local_fn_batched(structure, "count", ranks, 0,
                                              n_q)(*leaves))
    got = batch.local_fn_batched(structure, "count", ranks,
                                 n_q)(*[_t(x) for x in leaves])
    assert want.shape == (n_q, 2)
    assert np.array_equal(got.numpy(), want)


def test_const0_only_count_is_zero():
    leaves = [np.zeros((4, W), np.uint32)]
    structure = ("count", ("or", ("const0",), ("const0",)))
    want = np.asarray(jbatch.local_fn(structure, "count", (1,), 0)(*leaves))
    got = batch.local_fn(structure, "count", (1,))(*[_t(x) for x in leaves])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("clear", [False, True])
def test_word_patch_matches_delta_with_bit31_and_pads(clear):
    rng = np.random.default_rng(21)
    arr = rng.integers(0, 1 << 32, (4, W), dtype=np.uint32)
    positions = rng.choice(W * 32, 300, replace=False).astype(np.uint32)
    # bit 31 of every touched word: a mask that is negative as int32
    positions = np.union1d(positions, (positions & ~np.uint32(31)) | 31)
    jw, jm = jbatch._word_masks(positions)  # padded to a power of two
    n_real = np.unique(positions >> 5).size
    assert jw.size > n_real and (jm[:n_real] >> 31).all()
    fn = jbatch._andnot_delta if clear else jbatch._or_delta
    want = np.asarray(fn(arr, 2, jw, jm))

    # the port's own masks are the reference's without the padding
    pw, pm = batch._word_masks(positions)
    assert np.array_equal(pw, jw[:n_real]) and np.array_equal(pm, jm[:n_real])
    leaf = _t(arr.copy())
    kernels.word_patch_batch([(leaf, 2, None, pw, pm, clear)])
    assert np.array_equal(_u(leaf), want)
    # the reference's pads repeat word 0: K3 takes no pad
    with pytest.raises(ValueError):
        kernels.word_patch_batch([(_t(arr.copy()), 2, None, jw, jm, clear)])


@pytest.mark.parametrize("clear", [False, True])
def test_word_patch_row_form_matches_delta_row(clear):
    """K3 into one inner row of an [S, R, W] leaf (a BSI plane matrix)."""
    rng = np.random.default_rng(22)
    arr = rng.integers(0, 1 << 32, (4, 5, W), dtype=np.uint32)
    positions = rng.choice(W * 32, 200, replace=False).astype(np.uint32)
    positions = np.union1d(positions, (positions & ~np.uint32(31)) | 31)
    jw, jm = jbatch._word_masks(positions)
    fn = jbatch._andnot_delta_row if clear else jbatch._or_delta_row
    want = np.asarray(fn(arr, 1, 3, jw, jm))
    leaf = _t(arr.copy())
    pw, pm = batch._word_masks(positions)
    kernels.word_patch_batch([(leaf, 1, 3, pw, pm, clear)])
    assert np.array_equal(_u(leaf), want)
    with pytest.raises(IndexError):
        kernels.word_patch_batch([(leaf, 1, 5, pw, pm, clear)])
    with pytest.raises(ValueError):
        kernels.word_patch_batch([(leaf[:, 0].contiguous(), 1, 0, pw, pm,
                                   clear)])


def _positions(rng, n: int) -> np.ndarray:
    pos = rng.choice(W * 32, n, replace=False).astype(np.uint32)
    return np.union1d(pos, (pos & ~np.uint32(31)) | 31)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_word_patch_batch_plain_matches_reference_forms(seed):
    """One K3 batch of mixed targets (two [S, W] leaves, an [S, R, W]
    leaf, several slots and rows, both directions) against the
    reference's _or_delta / _andnot_delta and their _row forms applied
    one by one."""
    rng = np.random.default_rng(seed)
    flat = [rng.integers(0, 1 << 32, (4, W), dtype=np.uint32)
            for _ in range(2)]
    planes = rng.integers(0, 1 << 32, (4, 5, W), dtype=np.uint32)
    leaves = [_t(a.copy()) for a in flat] + [_t(planes.copy())]
    want = [a.copy() for a in flat] + [planes.copy()]
    targets = []
    spots = [(0, 0, None), (0, 3, None), (1, 3, None), (2, 1, 0), (2, 1, 4),
             (2, 3, 4), (1, 0, None)]
    for k, (leaf_i, slot, row) in enumerate(spots):
        clear = bool(rng.integers(0, 2))
        pos = _positions(rng, int(rng.integers(1, 400)))
        jw, jm = jbatch._word_masks(pos)
        if row is None:
            fn = jbatch._andnot_delta if clear else jbatch._or_delta
            want[leaf_i] = np.asarray(fn(want[leaf_i], slot, jw, jm))
        else:
            fn = jbatch._andnot_delta_row if clear else jbatch._or_delta_row
            want[leaf_i] = np.asarray(fn(want[leaf_i], slot, row, jw, jm))
        pw, pm = batch._word_masks(pos)
        targets.append((leaves[leaf_i], slot, row, pw, pm, clear))
    order = rng.permutation(len(targets))  # one row a target: any order
    kernels.word_patch_batch([targets[i] for i in order])
    for got, w in zip(leaves, want):
        assert np.array_equal(_u(got), w)
    blob, t, n = kernels.word_patch_pack(targets)
    assert (t, n) == (len(targets), sum(x[3].size for x in targets))
    assert blob.size == 16 * t + 4 + 8 * n


def test_word_patches_of_one_row_both_ways_apply_in_order():
    """Set then Clear of one bit (and Clear then Set of another) in one
    request: merge_word_patches splits the batch where a row turns, so
    the last write wins, as the reference's patches applied one by one."""
    from pilosa_tpu_torch.storage.residency import (
        WordPatch,
        merge_word_patches,
    )

    arr = np.zeros((2, W), np.uint32)
    arr[1, 9] = 1 << 4
    leaf = _t(arr.copy())
    one = np.array([7], np.int32)
    nine = np.array([9], np.int32)
    bit = np.array([1 << 31], np.uint32)
    patches = [(leaf, WordPatch(1, None, one, bit, False)),   # Set
               (leaf, WordPatch(0, None, one, bit, False)),   # other slot
               (leaf, WordPatch(1, None, nine, bit, False)),  # merges
               (leaf, WordPatch(1, None, one, bit, True)),    # Clear: splits
               (leaf, WordPatch(1, None, nine,
                                np.array([1 << 4], np.uint32), True)),
               (leaf, WordPatch(1, None, nine,
                                np.array([1 << 4], np.uint32), False))]
    launches = merge_word_patches(patches)
    assert len(launches) == 3
    assert [len(t) for t in launches] == [2, 1, 1]
    assert launches[0][0][3].tolist() == [7, 9]  # one merged target
    jnp_apply = arr.copy()
    for p in [p for _, p in patches]:
        fn = jbatch._andnot_delta if p.clear else jbatch._or_delta
        jnp_apply = np.asarray(fn(jnp_apply, p.slot, p.word_idx, p.masks))
    want = jnp_apply
    for targets in launches:
        kernels.word_patch_batch(targets)
    assert np.array_equal(_u(leaf), want)
    assert want[1, 7] == 0 and want[0, 7] == 1 << 31
    assert want[1, 9] == (1 << 31) | (1 << 4)

def test_flipall_program_matches_reference_rows():
    """OP_NOT: the grammar's flipall in K2's program."""
    rng = np.random.default_rng(23)
    leaves = _stacked(rng, 3, 2, density=0.4)
    tree = ("or", ("flipall", ("leaf", 0)), ("diff", ("leaf", 1),
                                            ("flipall", ("const0",))))
    want = np.asarray(jbatch.local_fn(tree, "row", (1, 1), 0)(*leaves))
    prog = expr.compile_program(tree)
    assert kernels.OP_NOT in [c & 0xFF for c in prog]
    got = kernels.tree_rows(prog, [_t(x) for x in leaves])
    assert np.array_equal(_u(got), want)
    # a count of flipall stays off the flat K1 path (padding slots)
    assert batch.count_elementwise_sub(("count", tree), (1, 1)) is None


def test_word_patch_rejects_bad_input():
    leaf = torch.zeros((2, W), dtype=torch.int32)
    one, m = np.array([0]), np.array([1])
    with pytest.raises(IndexError):
        kernels.word_patch_batch([(leaf, 2, None, one, m, False)])
    with pytest.raises(IndexError):
        kernels.word_patch_batch([(leaf, 0, None, np.array([W]), m, False)])
    with pytest.raises(ValueError):
        kernels.word_patch_batch([(leaf, 0, None, np.array([3, 3]),
                                   np.array([1, 2]), False)])
    with pytest.raises(ValueError):  # two targets on one row
        kernels.word_patch_batch([(leaf, 0, None, one, m, False),
                                  (leaf, 0, None, np.array([5]), m, True)])
    with pytest.raises(ValueError):  # a target without a pair
        kernels.word_patch_batch([(leaf, 0, None, one[:0], m[:0], False)])
    with pytest.raises(TypeError):
        kernels.word_patch_batch([(leaf.to(torch.int64), 0, None, one, m,
                                   False)])
    assert torch.equal(leaf, torch.zeros_like(leaf))


def test_program_checks():
    with pytest.raises(ValueError):
        kernels.check_program((kernels.OP_AND,), 1)  # stack underflow
    with pytest.raises(ValueError):
        kernels.check_program((kernels.OP_LEAF | (3 << 8),), 2)  # leaf 3 of 2
    with pytest.raises(ValueError):
        kernels.check_program((kernels.OP_LEAF, kernels.OP_LEAF), 1)  # 2 left
    with pytest.raises(ValueError):
        kernels.check_program((kernels.OP_NOT, kernels.OP_LEAF), 1)  # empty
    deep = ("leaf", 0)
    for i in range(1, 17):
        deep = ("or", ("leaf", i), deep)  # right-deep: stack of 17
    with pytest.raises(ValueError):
        expr.compile_program(deep)


K1_FORM_PROGRAMS = [
    ("and", ("leaf", 0), ("leaf", 1)),
    ("or", ("or", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
    ("xor", ("leaf", 2), ("xor", ("leaf", 0), ("leaf", 1))),
    ("diff", ("diff", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
    ("diff", ("leaf", 2), ("or", ("leaf", 0), ("leaf", 1))),
    ("flipall", ("and", ("leaf", 1), ("leaf", 0))),
]
K1_SALTS = [0, 7, 0x80000001, 0xFFFFFFFF]


def _tree_count_form(form, batch_leaves, salts, row_words: int):
    """K1's arithmetic for a chain or head-diff form: the form's fold per
    query, with that query's own xor mask, then per-row popcounts."""
    out = []
    for leaves, salt in zip(batch_leaves, salts):
        words = kernels.eval_form_plain(form, leaves, salt)
        out.append(kernels.popcount32(words.reshape(-1, row_words)).sum(
            dim=1, dtype=torch.int32))
    return torch.stack(out)


@pytest.mark.parametrize("i", range(len(K1_FORM_PROGRAMS)))
@pytest.mark.parametrize("salted", [False, True])
def test_k1_form_with_per_query_salts_matches_plain(i, salted):
    """K1 runs a fold form with one xor mask a query (from its salt): the
    form's arithmetic over a 4-query micro-batch with four salts equals
    the program's plain count, query by query."""
    program = expr.compile_program(K1_FORM_PROGRAMS[i])
    if salted:
        program = program + (kernels.OP_SALT,)
    form = kernels.classify_program(program)
    assert form.kind in (kernels.FORM_CHAIN, kernels.FORM_HEAD_DIFF)
    rng = np.random.default_rng(90 + i)
    batch_leaves = [[_t(x) for x in _stacked(rng, 2, 3, 0.4)]
                    for _ in K1_SALTS]
    want = kernels.tree_count_plain(program, batch_leaves, K1_SALTS, W)
    got = _tree_count_form(form, batch_leaves, K1_SALTS, W)
    assert torch.equal(got, want)
    if salted:  # the salts really differ between the queries
        assert not torch.equal(want[1], kernels.tree_count_plain(
            program, batch_leaves[1:2], [0], W)[0])

"""The host roaring kernels (``pilosa_tpu_torch.roaring.kernels``) against
the reference's (``pilosa_tpu.roaring.kernels``).

Each test builds the same bitmap in both packages from one seeded numpy
id set (through each package's own ``add_ids``, so the containers are
each package's write path's, and their bytes are compared first), then
requires byte-identical outputs: ids, dense words, popcounts, set
operations, digests, block slices, snapshot parses, ``Fragment.row_words``
and its container tally, and the ``KernelStats`` counters each call
bumps. The container-kind mix is steered through ``Container.from_lows``
by the shape of each container's lows.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.roaring import kernels as jk
from pilosa_tpu.roaring.bitmap import RoaringBitmap as JBitmap
from pilosa_tpu.roaring.format import deserialize as j_deserialize
from pilosa_tpu.roaring.format import serialize as j_serialize
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.storage.integrity import block_digests as j_digests
from pilosa_tpu_torch.roaring import kernels as pk
from pilosa_tpu_torch.roaring.bitmap import BITMAP, RoaringBitmap
from pilosa_tpu_torch.roaring.format import OP_ADD, encode_op, serialize
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.integrity import block_digests

torch.set_num_threads(1)

U = np.uint64
OPS = ("and", "or", "xor", "andnot")


def make_ids(rng, n_containers: int, kinds: str = "mixed",
             key_span: int = 64) -> np.ndarray:
    """Sorted unique ids over ``n_containers`` random container keys,
    each container's lows shaped to make an array, bitmap or run
    container (or a full or one-bit one)."""
    keys = rng.choice(key_span, size=min(n_containers, key_span),
                      replace=False)
    ids = []
    for key in keys.tolist():
        kind = (rng.choice(["array", "bitmap", "run", "full", "single"])
                if kinds == "mixed" else kinds)
        if kind == "array":
            lows = rng.choice(65536, size=int(rng.integers(1, 2000)),
                              replace=False)
        elif kind == "bitmap":
            lows = rng.choice(65536, size=int(rng.integers(4200, 20000)),
                              replace=False)
        elif kind == "run":
            starts = np.sort(rng.choice(65000, size=int(rng.integers(1, 8)),
                                        replace=False))
            lows = np.concatenate([
                np.arange(s, min(s + int(rng.integers(20, 400)), 65536))
                for s in starts.tolist()])
        elif kind == "full":
            lows = np.arange(65536)
        else:
            lows = rng.choice(65536, size=1)
        ids.append(np.unique(lows).astype(U) + (U(key) << U(16)))
    return np.concatenate(ids) if ids else np.empty(0, U)


def twin(ids) -> tuple:
    """(reference bitmap, port bitmap) of ``ids``, their bytes equal."""
    jb, pb = JBitmap(), RoaringBitmap()
    if len(ids):
        jb.add_ids(np.asarray(ids, U).copy())
        pb.add_ids(np.asarray(ids, U).copy())
    assert serialize(pb) == j_serialize(jb)
    return jb, pb


def same_ids(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == np.uint64
    assert got.tobytes() == want.astype(np.uint64).tobytes()


def stats_delta(fn) -> tuple[dict, dict]:
    """Each package's ``KernelStats`` movement over ``fn()``."""
    before = (jk.global_kernel_stats().metrics(),
              pk.global_kernel_stats().metrics())
    fn()
    after = (jk.global_kernel_stats().metrics(),
             pk.global_kernel_stats().metrics())
    return tuple({k: a[k] - b[k] for k in a} for a, b in zip(after, before))


# ----------------------------------------------------------------- to_ids


@pytest.mark.parametrize("seed", range(6))
def test_fragment_ids_match_reference(seed):
    rng = np.random.default_rng(seed)
    jb, pb = twin(make_ids(rng, int(rng.integers(1, 40))))
    same_ids(pk.fragment_ids(pk.flatten(pb)), jk.fragment_ids(jk.flatten(jb)))
    same_ids(pb.to_ids(), jb.to_ids())


def test_fragment_ids_empty_and_degenerate():
    assert pk.fragment_ids(pk.flatten(RoaringBitmap())).size == 0
    for i, kind in enumerate(("full", "single", "run", "bitmap", "array")):
        jb, pb = twin(make_ids(np.random.default_rng(i), 1, kinds=kind))
        same_ids(pk.fragment_ids(pk.flatten(pb)),
                 jk.fragment_ids(jk.flatten(jb)))


def test_flatten_key_windows_match_reference():
    jb, pb = twin(make_ids(np.random.default_rng(7), 30, key_span=48))
    for lo, hi in [(0, 15), (16, 31), (5, 5), (40, 200), (100, 120),
                   (None, 20), (20, None)]:
        pf, jf = pk.flatten(pb, lo, hi), jk.flatten(jb, lo, hi)
        assert pf.n_containers == jf.n_containers
        assert pf.kind_counts() == jf.kind_counts()
        assert pf.total() == jf.total()
        same_ids(pk.fragment_ids(pf), jk.fragment_ids(jf))


def test_range_ids_match_reference():
    jb, pb = twin(make_ids(np.random.default_rng(11), 20, key_span=32))
    for start, stop in [(0, 1 << 20), (1 << 20, 3 << 20), (65536, 131072),
                        (12345, 1_500_000), (5, 5)]:
        same_ids(pk.range_ids(pk.flatten(pb, start >> 16, (stop - 1) >> 16),
                              start, stop),
                 jk.range_ids(jk.flatten(jb, start >> 16, (stop - 1) >> 16),
                              start, stop))
        same_ids(pb.range_ids(start, stop), jb.range_ids(start, stop))


# ----------------------------------------------------------- dense decode


@pytest.mark.parametrize("seed", range(6))
def test_dense_words32_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    jb, pb = twin(make_ids(rng, int(rng.integers(1, 30)), key_span=32))
    for base_key, n in [(0, 16), (16, 16), (0, 32), (3, 5)]:
        got = pk.dense_words32(pk.flatten(pb, base_key, base_key + n - 1),
                               base_key, n)
        want = jk.dense_words32(jk.flatten(jb, base_key, base_key + n - 1),
                                base_key, n)
        assert got.dtype == np.uint32
        assert got.tobytes() == want.tobytes()
        # and the bitmap's own range decode, against the reference's walk
        assert pb.dense_range_words32(base_key << 16, (base_key + n) << 16
                                      ).tobytes() == \
            jb.dense_range_words32(base_key << 16,
                                   (base_key + n) << 16).tobytes()


def test_dense_words32_empty_and_dense_windows():
    got = pk.dense_words32(pk.flatten(RoaringBitmap(), 0, 15), 0, 16)
    assert got.shape == (16 * 2048,) and not got.any()
    # an all-bitmap window (the flat view's own buffer) and a window of
    # arrays dense enough to take the packbits branch
    rng = np.random.default_rng(3)
    for kinds in ("bitmap", "array", "run"):
        ids = make_ids(rng, 16, kinds=kinds, key_span=16)
        jb, pb = twin(ids)
        assert pk.dense_words32(pk.flatten(pb, 0, 15), 0, 16).tobytes() == \
            jk.dense_words32(jk.flatten(jb, 0, 15), 0, 16).tobytes()


# --------------------------------------------------------------- popcount


@pytest.mark.parametrize("seed", range(4))
def test_popcount_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    jb, pb = twin(make_ids(rng, int(rng.integers(1, 25))))
    assert pk.popcount(pk.flatten(pb)) == jk.popcount(jk.flatten(jb)) \
        == pb.count()


# ---------------------------------------------------------------- set ops


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed", range(3))
def test_set_ops_match_reference(seed, op):
    rng = np.random.default_rng(300 + seed)
    # overlapping key ranges, so every pairing of kinds occurs
    ja, pa = twin(make_ids(rng, int(rng.integers(1, 20)), key_span=24))
    jb, pb = twin(make_ids(rng, int(rng.integers(1, 20)), key_span=24))
    pf, jf = getattr(pk, f"fragment_{op}"), getattr(jk, f"fragment_{op}")
    same_ids(pf(pa, pb), jf(ja, jb))
    # a flat view is an operand too
    same_ids(pf(pk.flatten(pa), pb), jf(jk.flatten(ja), jb))


@pytest.mark.parametrize("op", OPS)
def test_set_ops_empty_operands(op):
    ja, pa = twin(make_ids(np.random.default_rng(5), 5))
    je, pe = twin([])
    pf, jf = getattr(pk, f"fragment_{op}"), getattr(jk, f"fragment_{op}")
    same_ids(pf(pa, pe), jf(ja, je))
    same_ids(pf(pe, pa), jf(je, ja))
    assert pf(pe, pe).size == 0


def test_bitmap_bitmap_lane_matches_reference():
    ja, pa = twin(np.arange(0, 30000, 2, dtype=U))
    jb, pb = twin(np.arange(0, 30000, 3, dtype=U))
    assert pa.container(0).kind == BITMAP and pb.container(0).kind == BITMAP
    for op in OPS:
        same_ids(getattr(pk, f"fragment_{op}")(pa, pb),
                 getattr(jk, f"fragment_{op}")(ja, jb))


def test_sorted_set_ops_lopsided_and_linear():
    big = np.arange(0, 3_000_000, 3, dtype=U)
    small = np.asarray([0, 5, 9, 2_999_997, 4_000_000], U)
    mid = np.arange(0, 3_000_000, 7, dtype=U)
    for a, b in [(small, big), (big, small), (mid, big), (small, small),
                 (np.empty(0, U), big), (big, np.empty(0, U))]:
        same_ids(pk.intersect_sorted(a, b), jk.intersect_sorted(a, b))
        same_ids(pk.setdiff_sorted(a, b), jk.setdiff_sorted(a, b))


def test_diff_ids_match_reference():
    rng = np.random.default_rng(17)
    ja, pa = twin(make_ids(rng, 10, key_span=12))
    jb, pb = twin(make_ids(rng, 10, key_span=12))
    for got, want in zip(pk.diff_ids(pa, pb), jk.diff_ids(ja, jb)):
        same_ids(got, want)


# ---------------------------------------------------------------- digests


@pytest.mark.parametrize("seed", range(3))
def test_digests_identical_through_kernel_ids(seed):
    rng = np.random.default_rng(400 + seed)
    jb, pb = twin(make_ids(rng, int(rng.integers(1, 30)), key_span=400))
    assert block_digests(pk.fragment_ids(pk.flatten(pb))) == \
        j_digests(jk.fragment_ids(jk.flatten(jb)))


def test_block_slices_match_reference():
    jb, pb = twin(make_ids(np.random.default_rng(21), 40, key_span=4000))
    ids = pb.to_ids()
    blocks = sorted({int(b) for b, _ in block_digests(ids)})
    for rows in (100, 7):
        got = pk.block_slices(ids, blocks + [10**6, 3], rows)
        want = jk.block_slices(jb.to_ids(), blocks + [10**6, 3], rows)
        assert sorted(got) == sorted(want)
        for b in want:
            same_ids(got[b], want[b])
    assert pk.block_slices(ids, []) == {}


def test_diff_digests_match_reference():
    local = [(0, "aa"), (1, "bb"), (3, "dd")]
    peer = [(0, "aa"), (1, "XX"), (2, "cc")]
    for a, b in [(local, peer), (peer, peer), ([], peer), (peer, [])]:
        assert pk.diff_digests(a, b) == jk.diff_digests(a, b)


# ------------------------------------------------------ snapshot fast path


@pytest.mark.parametrize("seed", range(3))
def test_snapshot_ids_match_reference(seed):
    jb, pb = twin(make_ids(np.random.default_rng(500 + seed),
                           int(np.random.default_rng(seed).integers(1, 30))))
    buf = serialize(pb) + encode_op(OP_ADD, np.asarray([1, 2, 3], U))
    got, got_at = pk.snapshot_ids(buf)
    want, want_at = jk.snapshot_ids(buf)
    assert got_at == want_at == j_deserialize(buf)[1]
    same_ids(got, want)


def test_snapshot_ids_rejects_and_falls_back_as_reference():
    _, pb = twin(make_ids(np.random.default_rng(3), 5))
    buf = serialize(pb)
    for bad in (buf[:10], buf[:-3], b"\x00" * 40):
        with pytest.raises(ValueError) as want:
            jk.snapshot_ids(bad)
        with pytest.raises(ValueError) as got:
            pk.snapshot_ids(bad)
        assert str(got.value) == str(want.value)
    # duplicate container keys: the decoder's last-wins semantics
    _, pb = twin(np.asarray([1, 2, 70000], U))
    dup = bytearray(serialize(pb))
    dup[20 + 16:20 + 16 + 8] = dup[20:20 + 8]
    same_ids(pk.snapshot_ids(bytes(dup))[0], jk.snapshot_ids(bytes(dup))[0])


# ------------------------------------------------------- KernelStats


def test_kernel_stats_move_as_the_reference():
    rng = np.random.default_rng(9)
    ja, pa = twin(make_ids(rng, 12, key_span=16))
    jb, pb = twin(make_ids(rng, 12, key_span=16))

    def calls(k, a, b):
        def run():
            f = k.flatten(a, 0, 15)
            k.dense_words32(f, 0, 16)
            k.popcount(f)
            k.range_ids(f, 1000, 900000)
            k.fragment_and(a, b)
            k.fragment_or(a, b)
            k.diff_ids(a, b)
            k.block_slices(k.fragment_ids(k.flatten(a)), [0, 1])
            k.snapshot_ids(j_serialize(a) if k is jk else serialize(a))
        return run

    j_delta, _ = stats_delta(calls(jk, ja, jb))
    _, p_delta = stats_delta(calls(pk, pa, pb))
    assert p_delta == j_delta
    assert p_delta["hostpath_dense_decodes_total"] == 1
    assert p_delta["hostpath_set_ops_total"] == 2


# ------------------------------------------------- Fragment.row_words


def _twin_fragments(tmp_path):
    """One fragment of each package holding the same rows: row 0 with two
    array containers, one run container and one bitmap container; row 3
    with random bits; row 1 empty."""
    rng = np.random.default_rng(7)
    cols0 = np.concatenate([
        np.asarray([5, 9, 70000], U),
        np.arange(3 << 16, (3 << 16) + 5000, dtype=U),
        np.unique(rng.integers(5 << 16, 6 << 16, 9000).astype(U))])
    cols3 = np.unique(rng.integers(0, 1 << 20, 30000).astype(U))
    rows = np.concatenate([np.zeros(cols0.size, U), np.full(cols3.size, 3, U)])
    cols = np.concatenate([cols0, cols3])
    jf = JFragment(str(tmp_path / "j"), "i", "f", "standard", 0).open()
    pf = Fragment(str(tmp_path / "p"), "i", "f", "standard", 0).open()
    jf.bulk_import(rows.copy(), cols.copy())
    pf.bulk_import(rows.copy(), cols.copy())
    assert serialize(pf.bitmap) == j_serialize(jf.bitmap)
    return jf, pf


def test_row_words_and_its_tally_match_reference(tmp_path):
    import pilosa_tpu.utils.cost as jcost
    import pilosa_tpu_torch.utils.cost as pcost

    jf, pf = _twin_fragments(tmp_path)
    tallies = []
    try:
        for cost, frag in ((jcost, jf), (pcost, pf)):
            was = cost.cost_enabled()
            cost.set_cost_enabled(True)
            ctx = cost.new_cost_context("t", "i")
            tok = cost.activate_cost(ctx)
            try:
                words = [frag.row_words(r) for r in (0, 0, 1, 3)]
            finally:
                cost.deactivate_cost(tok)
                cost.set_cost_enabled(was)
            tallies.append(((ctx.c_array, ctx.c_bitmap, ctx.c_run),
                            [w.tobytes() for w in words]))
        assert tallies[0] == tallies[1]
        # row 0 twice: two array, one bitmap and one run container each
        assert tallies[1][0][0] >= 4 and tallies[1][0][2] >= 2
    finally:
        jf.close()
        pf.close()


def test_row_words_outside_a_cost_context_match_reference(tmp_path):
    jf, pf = _twin_fragments(tmp_path)
    try:
        for row in range(5):
            got, want = pf.row_words(row), jf.row_words(row)
            assert got.dtype == np.uint32 and got.shape == (32768,)
            assert got.tobytes() == want.tobytes()
    finally:
        jf.close()
        pf.close()

"""The whole-batch merge kernels (``pilosa_tpu_torch.roaring.merge_kernels``)
against the reference's (``pilosa_tpu.roaring.merge_kernels``).

Container choice is part of the bytes on disk, so every merge is held to
the reference's by the serialized bytes of the merged bitmap and its
changed-bit count: the port's ``merge_ids`` and its per-container
``_merge_loop`` against the reference's ``merge_ids``, over seeded
array/bitmap/run mixes and the edges the loop defines (the ARRAY
promotion threshold, a bitmap that stays a bitmap above ARRAY_MAX, an
unchanged container kept as the same object, removal to empty). The
batched membership probes, the mutex and BSI imports through them, WAL
replay and the ``MergeStats`` counters are held to the reference's too.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.roaring import merge_kernels as jm
from pilosa_tpu.roaring.bitmap import RoaringBitmap as JBitmap
from pilosa_tpu.roaring.format import serialize as j_serialize
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu_torch.roaring import merge_kernels as pm
from pilosa_tpu_torch.roaring.bitmap import (
    ARRAY_MAX,
    BITMAP,
    RUN,
    RoaringBitmap,
)
from pilosa_tpu_torch.roaring.format import OP_ADD, OP_REMOVE, serialize
from pilosa_tpu_torch.storage.fragment import Fragment
from test_torch_host_kernels import make_ids

torch.set_num_threads(1)

U = np.uint64


def triple(ids) -> tuple:
    """(reference, port for the kernel, port for the loop) bitmaps of
    ``ids``, their bytes equal."""
    jb = JBitmap()
    pk_b, pl_b = RoaringBitmap(), RoaringBitmap()
    if len(ids):
        for b in (jb, pk_b, pl_b):
            b.add_ids(np.asarray(ids, U).copy())
    assert serialize(pk_b) == serialize(pl_b) == j_serialize(jb)
    return jb, pk_b, pl_b


def assert_merge_identical(jb, pb, pl, batch, remove):
    want = jm.merge_ids(jb, batch.copy(), remove)
    got = pm.merge_ids(pb, batch.copy(), remove)
    loop = pl._merge_loop(batch.copy(), remove)
    assert got == loop == want, (got, loop, want, remove)
    assert serialize(pb) == serialize(pl) == j_serialize(jb)
    assert pb.keys == pl.keys == jb.keys


# ------------------------------------------------------- randomized fuzz


@pytest.mark.parametrize("seed", range(6))
def test_merge_matches_reference_randomized(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        jb, pb, pl = triple(make_ids(rng, int(rng.integers(0, 30))))
        span = int(rng.integers(1, 64)) << 16
        batch = rng.integers(0, span, int(rng.integers(64, 20000))).astype(U)
        assert_merge_identical(jb, pb, pl, batch, bool(rng.integers(0, 2)))


@pytest.mark.parametrize("kind", ["array", "bitmap", "run", "full",
                                  "single"])
def test_merge_matches_reference_each_kind(kind):
    rng = np.random.default_rng(len(kind))
    for remove in (False, True):
        jb, pb, pl = triple(make_ids(rng, 8, kinds=kind, key_span=8))
        batch = rng.integers(0, 8 << 16, 5000).astype(U)
        assert_merge_identical(jb, pb, pl, batch, remove)


def test_merge_duplicate_and_unsorted_batches():
    rng = np.random.default_rng(3)
    jb, pb, pl = triple(make_ids(rng, 10))
    base = rng.integers(0, 16 << 16, 4000).astype(U)
    batch = np.concatenate([base, base[:1000], base[::-1]])
    assert_merge_identical(jb, pb, pl, batch, False)


# ------------------------------------------------------ edges of the loop


def test_array_promote_threshold_boundary():
    for base_n in (ARRAY_MAX - 10, ARRAY_MAX - 1, ARRAY_MAX):
        for extra in (9, 10, 11, 12):
            jb, pb, pl = triple(np.arange(base_n, dtype=U) * U(3))
            batch = np.arange(extra, dtype=U) * U(3) + U(1)
            assert_merge_identical(jb, pb, pl, batch, False)


def test_bitmap_stays_bitmap_above_array_max():
    rng = np.random.default_rng(0)
    jb, pb, pl = triple(np.unique(rng.integers(0, 65536, 60000)).astype(U))
    assert pb.container(0).kind == BITMAP
    assert_merge_identical(jb, pb, pl, np.arange(65536, dtype=U), False)
    assert pb.container(0).kind == BITMAP


def test_unchanged_containers_stay_the_same_objects():
    _, pb, _ = triple(np.arange(0, 130000, 2, dtype=U))
    before = {k: pb.container(k) for k in pb.keys}
    assert pm.merge_ids(pb, np.arange(0, 130000, 4, dtype=U), False) == 0
    assert all(pb.container(k) is c for k, c in before.items())


def test_remove_to_empty_pops_containers():
    pre = np.arange(200, dtype=U) + (U(5) << U(16))
    jb, pb, pl = triple(pre)
    batch = np.concatenate([pre, np.arange(64, dtype=U)])  # key 0 absent
    assert_merge_identical(jb, pb, pl, batch, True)
    assert pb.keys == []


def test_run_containers_merge_in_the_stream():
    jb, pb, pl = triple(np.arange(60000, dtype=U))
    assert pb.container(0).kind == RUN
    assert_merge_identical(jb, pb, pl, np.arange(60000, 65536, dtype=U),
                           False)


def test_small_batches_take_the_loop():
    stats = pm.global_merge_stats()
    before = (stats.loop_fallbacks, stats.kernel_calls)
    jb, pb, _ = triple([])
    small = np.arange(pm.KERNEL_MIN_IDS - 1, dtype=U) * U(5)
    assert pb.add_ids(small.copy()) == jb.add_ids(small.copy())
    assert (stats.loop_fallbacks, stats.kernel_calls) == \
        (before[0] + 1, before[1])
    big = np.arange(pm.KERNEL_MIN_IDS, dtype=U) * U(7)
    assert pb.add_ids(big.copy()) == jb.add_ids(big.copy())
    assert stats.kernel_calls == before[1] + 1
    assert serialize(pb) == j_serialize(jb)
    assert pm.KERNEL_MIN_IDS == jm.KERNEL_MIN_IDS


# ----------------------------------------------------- membership probes


@pytest.mark.parametrize("seed", range(3))
def test_set_rows_for_positions_match_reference(seed):
    rng = np.random.default_rng(seed)
    ids = ((rng.integers(0, 30, 20000).astype(U) << U(20))
           + rng.integers(0, 1 << 20, 20000).astype(U))
    jb, pb, _ = triple(ids)
    pos = rng.integers(0, 1 << 20, 3000).astype(U)
    got = pm.set_rows_for_positions(pb, pos)
    want = jm.set_rows_for_positions(jb, pos)
    assert sorted(zip(*(a.tolist() for a in got))) == \
        sorted(zip(*(a.tolist() for a in want)))


@pytest.mark.parametrize("seed", range(3))
def test_member_matrix_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ids = ((rng.integers(0, 40, 15000).astype(U) << U(20))
           + rng.integers(0, 1 << 20, 15000).astype(U))
    jb, pb, _ = triple(ids)
    pos = rng.integers(0, 1 << 20, 2000).astype(U)
    rows = [0, 2, 3, 7, 39, 41]  # row 41 has no containers
    got = pm.member_matrix(pb, rows, pos)
    assert got.dtype == bool and got.shape == (len(rows), pos.size)
    assert got.tobytes() == jm.member_matrix(jb, rows, pos).tobytes()
    assert not pm.member_matrix(RoaringBitmap(), rows, pos).any()


# ------------------------------------------------- mutex / BSI imports


def _frags(tmp_path, name):
    return (JFragment(str(tmp_path / f"j{name}"), "i", "f", "standard",
                      0).open(),
            Fragment(str(tmp_path / f"p{name}"), "i", "f", "standard",
                     0).open())


@pytest.mark.parametrize("seed", range(3))
def test_import_mutex_matches_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    jf, pf = _frags(tmp_path, seed)
    try:
        for _ in range(2):
            n = int(rng.integers(1, 4000))
            rows = rng.integers(0, 16, n).astype(U)
            pos = rng.integers(0, 1 << 20, n).astype(U)
            assert pf.import_mutex(rows.copy(), pos.copy()) == \
                jf.import_mutex(rows.copy(), pos.copy())
            assert serialize(pf.bitmap) == j_serialize(jf.bitmap)
    finally:
        jf.close()
        pf.close()


@pytest.mark.parametrize("seed", range(3))
def test_import_bsi_matches_reference(seed, tmp_path):
    rng = np.random.default_rng(20 + seed)
    jf, pf = _frags(tmp_path, seed)
    depth = int(rng.integers(1, 33))
    try:
        for _ in range(3):
            pos = np.unique(rng.integers(0, 1 << 20,
                                         int(rng.integers(1, 2500)))).astype(U)
            vals = rng.integers(0, 1 << depth, pos.size).astype(U)
            assert pf.import_bsi(pos.copy(), vals.copy(), depth) == \
                jf.import_bsi(pos.copy(), vals.copy(), depth)
            assert serialize(pf.bitmap) == j_serialize(jf.bitmap)
    finally:
        jf.close()
        pf.close()


# --------------------------------------------------- WAL-replay identity


@pytest.mark.parametrize("seed", range(2))
def test_replay_identical_through_kernel_and_loop(seed, tmp_path,
                                                  monkeypatch):
    rng = np.random.default_rng(30 + seed)
    ops = []
    for _ in range(8):
        n = int(rng.integers(1, 6000))
        ids = ((rng.integers(0, 24, n).astype(U) << U(20))
               + rng.integers(0, 1 << 20, n).astype(U))
        ops.append((OP_ADD if rng.integers(0, 3) else OP_REMOVE, ids))
    jf, pf = _frags(tmp_path, "k")
    try:
        for op, ids in ops:
            jf.apply_recovered(op, ids.copy())
            pf.apply_recovered(op, ids.copy())
        want = j_serialize(jf.bitmap)
        assert serialize(pf.bitmap) == want
    finally:
        jf.close()
        pf.close()
    # every merge through the per-container loop: the same bytes
    monkeypatch.setattr(pm, "KERNEL_MIN_IDS", 1 << 62)
    pl = Fragment(str(tmp_path / "pl"), "i", "f", "standard", 0).open()
    try:
        for op, ids in ops:
            pl.apply_recovered(op, ids.copy())
        assert serialize(pl.bitmap) == want
    finally:
        pl.close()


def test_merge_stats_move_as_the_reference():
    def delta(mod, bm_cls, rows):
        stats = mod.global_merge_stats()
        before = stats.metrics()
        bm = bm_cls()
        bm.add_ids(np.arange(5000, dtype=U))
        bm.add_ids(np.arange(10, dtype=U) * U(3))
        bm.remove_ids(np.arange(0, 5000, 2, dtype=U))
        mod.member_matrix(bm, rows, np.arange(100, dtype=U))
        mod.set_rows_for_positions(bm, np.arange(100, dtype=U))
        return {k: v - before[k] for k, v in stats.metrics().items()}

    want = delta(jm, JBitmap, [0, 1])
    assert delta(pm, RoaringBitmap, [0, 1]) == want
    assert want["ingest_merge_kernel_calls_total"] == 2
    assert want["ingest_merge_loop_fallbacks_total"] == 1
    assert want["ingest_merge_probe_calls_total"] == 2

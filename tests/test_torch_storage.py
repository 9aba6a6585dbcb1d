"""Data directories shared by pilosa_tpu and the port: each opens the other's.

Here each holder is closed before the other opens its directory;
``test_torch_wal.py`` opens directories copied from a live holder, whose
acknowledged ops still sit in the write-ahead log.
"""

import json
import os
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.storage.field import FieldOptions as JFieldOptions
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage import (
    FieldOptions,
    Holder,
    load_existence,
    load_from_dense,
)

torch.set_num_threads(1)

W = 32768
SHARDS = 3


def _seed_rows(seed: int, rows=(1, 2, 7), density=0.02) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for r in rows:
        bits = rng.random(SHARDS * W * 32) < density
        out[r] = np.packbits(bits, bitorder="little").view("<u4")
    return out


def _columns(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint64)


def _rows_of(field, rows) -> dict:
    """{row: uint32[SHARDS * W]} read through either package's fragments."""
    view = field.view("standard")
    out = {}
    for r in rows:
        parts = []
        for s in range(SHARDS):
            frag = view.fragment(s) if view else None
            parts.append(frag.row_words(r) if frag is not None
                         else np.zeros(W, np.uint32))
        out[r] = np.concatenate(parts)
    return out


def _jax_fill(path, fields: dict) -> None:
    """Write the seed through the reference's own import path."""
    h = jstorage.Holder(str(path)).open()
    idx = h.create_index("i")
    for fname, rows in fields.items():
        fld = idx.create_field(fname)
        view = fld.view("standard", create=True)
        for r, words in rows.items():
            cols = _columns(words)
            for s in range(SHARDS):
                sel = (cols >> np.uint64(20)) == s
                if sel.any():
                    view.fragment(s, create=True).bulk_import(
                        np.full(int(sel.sum()), r, np.uint64),
                        cols[sel] & np.uint64(W * 32 - 1))
    h.close()


def test_reference_dir_opens_in_port(tmp_path):
    fields = {"f": _seed_rows(1), "g": _seed_rows(2, rows=(7,))}
    _jax_fill(tmp_path / "jax", fields)
    # single-bit writes too, so the files carry an op history
    h = jstorage.Holder(str(tmp_path / "jax")).open()
    f = h.index("i").field("f")
    f.set_bit(1, 5)
    f.clear_bit(2, int(_columns(fields["f"][2])[0]))
    want = _rows_of(f, (1, 2, 7))
    h.close()

    p = Holder(str(tmp_path / "jax"), device="cpu").open()
    try:
        got = _rows_of(p.index("i").field("f"), (1, 2, 7))
        for r in want:
            assert np.array_equal(got[r], want[r]), r
        assert np.array_equal(_rows_of(p.index("i").field("g"), (7,))[7],
                              fields["g"][7])
        assert p.index("i").track_existence
        assert "_exists" in p.index("i").fields
    finally:
        p.close()


def test_port_writes_survive_close_and_reopen(tmp_path):
    rows = _seed_rows(3)
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    fld = h.index("i").field("f")
    fld.set_bit(1, 2 * W * 32 + 77)
    cleared = int(_columns(rows[2])[3])
    assert fld.clear_bit(2, cleared)
    assert not fld.clear_bit(2, cleared)  # already clear: no op
    want = _rows_of(fld, (1, 2, 7))
    h.close()

    h = Holder(str(tmp_path / "d"), device="cpu").open()
    try:
        got = _rows_of(h.index("i").field("f"), (1, 2, 7))
        for r in want:
            assert np.array_equal(got[r], want[r]), r
        assert not h.index("i").field("f").view("standard").fragment(
            cleared >> 20).contains(2, cleared & (W * 32 - 1))
    finally:
        h.close()


def test_reference_reads_port_files(tmp_path):
    rows = _seed_rows(4)
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    fld = h.index("i").field("f")
    fld.set_bit(7, 123)
    fld.clear_bit(1, int(_columns(rows[1])[0]))
    want = _rows_of(fld, (1, 2, 7))
    exists = h.index("i").field("_exists").view("standard").fragment(0) \
        .count_row(0)
    h.close()

    j = jstorage.Holder(str(tmp_path / "d")).open()  # verify-on-load default
    try:
        got = _rows_of(j.index("i").field("f"), (1, 2, 7))
        for r in want:
            assert np.array_equal(got[r], want[r]), r
        assert j.index("i").field("_exists").view("standard").fragment(0) \
            .count_row(0) == exists
    finally:
        j.close()


def test_port_rewrite_drops_stale_reference_sidecars(tmp_path):
    """A reference-written fragment carries digest and row-count
    sidecars; after the port rewrites its snapshot (and the sidecars with
    it), the reference must still open it (no quarantine) and see the new
    bits."""
    fields = {"f": _seed_rows(5)}
    _jax_fill(tmp_path / "d", fields)
    frag_path = tmp_path / "d" / "i" / "f" / "views" / "standard" / \
        "fragments" / "0"
    assert os.path.exists(str(frag_path) + ".checksums")
    extra = {9: _seed_rows(6, rows=(9,))[9]}
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": extra}, index="i")
    h.index("i").field("f").set_bit(1, 99)
    want = _rows_of(h.index("i").field("f"), (1, 2, 7, 9))
    h.close()

    j = jstorage.Holder(str(tmp_path / "d")).open()
    try:
        got = _rows_of(j.index("i").field("f"), (1, 2, 7, 9))
        for r in want:
            assert np.array_equal(got[r], want[r]), r
        assert not any(".quarantine-" in n
                       for n in os.listdir(frag_path.parent))
    finally:
        j.close()


@pytest.mark.parametrize("density", [0.0003, 0.02, 0.6])
def test_dense_load_writes_the_reference_bytes(tmp_path, density):
    """One numpy seed through both packages' fill paths gives byte-equal
    fragment files: the loader picks the reference's container forms."""
    fields = {"f": _seed_rows(7, density=density)}
    _jax_fill(tmp_path / "jax", fields)
    h = Holder(str(tmp_path / "port"), device="cpu").open()
    load_from_dense(h, fields, index="i")
    h.close()
    rel = os.path.join("i", "f", "views", "standard", "fragments")
    for s in range(SHARDS):
        for name in (str(s), f"{s}.checksums", f"{s}.cache"):
            with open(tmp_path / "jax" / rel / name, "rb") as a, \
                    open(tmp_path / "port" / rel / name, "rb") as b:
                assert a.read() == b.read(), name


def test_write_after_torn_tail_survives_reopen(tmp_path):
    """A crash mid-append leaves a torn op record; the next open must
    drop it before appending, or replay would stop at the tear and lose
    every acknowledged write behind it."""
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    fld = h.create_index("i").create_field("f")
    fld.set_bit(1, 10)
    path = fld.view("standard").fragment(0).path
    h.close()
    with open(path, "ab") as f:
        f.write(b"\x50\x4f\x01\x00\x05")  # a record header cut short

    h = Holder(str(tmp_path / "d"), device="cpu").open()
    fld = h.index("i").field("f")
    assert fld.set_bit(1, 20)
    h.close()
    for holder in (Holder(str(tmp_path / "d"), device="cpu"),
                   jstorage.Holder(str(tmp_path / "d"))):
        holder.open()
        try:
            frag = holder.index("i").field("f").view("standard").fragment(0)
            assert frag.contains(1, 10) and frag.contains(1, 20)
        finally:
            holder.close()


def _tree_bytes(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_fields_built_apart_then_existence_match_one_load(tmp_path):
    """chip_smoke's parallel build: each field loaded into its own
    directory without existence marks, the field directories moved into
    one data dir whose existence rows ``load_existence`` wrote, gives the
    same files as one ``load_from_dense`` call, and the reference reads
    it."""
    fields = {"f": _seed_rows(5), "g": _seed_rows(6, rows=(0, 3))}
    one = Holder(str(tmp_path / "one"), device="cpu").open()
    load_from_dense(one, fields, index="i")
    one.close()

    exists = np.zeros(SHARDS * W, np.uint32)
    for rows in fields.values():
        for words in rows.values():
            exists |= words
    main = Holder(str(tmp_path / "main"), device="cpu").open()
    load_existence(main, exists, index="i")
    main.close()
    for fname, rows in fields.items():
        part = tmp_path / f"part-{fname}"
        h = Holder(str(part), device="cpu").open()
        load_from_dense(h, {fname: rows}, index="i", existence=False)
        assert h.index("i").field("_exists").view("standard") is None or \
            not h.index("i").field("_exists").view("standard").fragments
        h.close()
        os.rename(part / "i" / fname, tmp_path / "main" / "i" / fname)
    assert _tree_bytes(tmp_path / "main") == _tree_bytes(tmp_path / "one")

    j = jstorage.Holder(str(tmp_path / "main")).open()
    try:
        got = _rows_of(j.index("i").field("g"), (0, 3))
        for r in (0, 3):
            assert np.array_equal(got[r], fields["g"][r])
        assert j.index("i").field("_exists").view("standard").fragment(
            1).count_row(0) == int(np.bitwise_count(
                exists[W:2 * W]).sum())
    finally:
        j.close()


# ------------------------------------------------------------- sidecars


def _write_script(holder, options_cls) -> None:
    """One sequence of Set/Clear/import writes, a snapshot in the middle,
    then a close: the same calls on either package's storage tree."""
    idx = holder.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", options_cls(type="int", min=-5, max=1000))
    for c in (3, 70, 1048576 + 5, 2 * 1048576 + 9):
        f.set_bit(1, c)
    f.set_bit(2, 70)
    f.set_bit(4, 2 * 1048576 + 1)
    f.clear_bit(1, 70)
    rng = np.random.default_rng(11)
    pos = np.unique(rng.integers(0, W * 32, 3000)).astype(np.uint64)
    rows = rng.integers(0, 12, pos.size).astype(np.uint64)
    f.view("standard").fragment(1, create=True).bulk_import(rows, pos)
    v.set_value(5, 17)
    v.set_value(1048576 + 3, -5)
    cols = rng.integers(0, SHARDS * W * 32, 500)
    v.import_values(cols, rng.integers(-5, 1001, cols.size))
    v.clear_value(5)
    idx.mark_columns_exist([3, 1048576 + 5, 2 * 1048576 + 1])
    for view in list(f.views.values()) + list(v.views.values()):
        for frag in view.fragments.values():
            frag.snapshot()
    f.set_bit(3, 11)
    f.clear_bit(2, 70)
    v.set_value(9, 999)
    v.import_values([9, 1048576 + 3], [0, 1000])
    holder.close()


def _view_files(root) -> dict:
    return {k: b for k, b in _tree_bytes(root).items()
            if os.sep + "views" + os.sep in k}


@pytest.mark.parametrize("mode", ["per-op", "group", "flush-only"])
def test_same_writes_write_the_reference_files_and_sidecars(tmp_path, mode):
    """The port writes each fragment file, its .checksums and its .cache
    byte for byte as the reference does, in each durability mode, for the
    same writes (group mode's files are the clean close's snapshots)."""
    _write_script(jstorage.Holder(str(tmp_path / "jax"),
                                  durability_mode=mode).open(),
                  JFieldOptions)
    _write_script(Holder(str(tmp_path / "port"), device="cpu",
                         durability_mode=mode).open(),
                  FieldOptions)
    want, got = _view_files(tmp_path / "jax"), _view_files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".checksums") for k in got) >= 2 * SHARDS
    assert sum(k.endswith(".cache") for k in got) >= 2 * SHARDS
    for k in want:
        assert got[k] == want[k], k


def test_reference_ranks_topn_on_a_port_dir_without_recount(tmp_path):
    """A directory the port wrote and closed carries complete row caches:
    the reference, reopened on it, ranks TopN's candidates from them
    exactly as the port ranks exact counts, with no recount first."""
    rows = _seed_rows(8, rows=(1, 2, 3, 7, 9), density=0.01)
    rows[9] = rows[9] & rows[1]  # rows of very different sizes
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    fld = h.index("i").field("f")
    for c in range(0, 4000, 7):
        fld.set_bit(9, c)
    fld.clear_bit(1, int(_columns(rows[1])[0]))
    h.close()
    shutil.copytree(tmp_path / "d", tmp_path / "copy")
    j = jstorage.Holder(str(tmp_path / "d")).open()
    p = Holder(str(tmp_path / "copy"), device="cpu").open()
    try:
        frag = j.index("i").field("f").view("standard").fragment(0)
        assert len(frag.row_cache) == 5
        for pql in ("TopN(f, n=3)", "TopN(f)", "TopN(f, Row(f=7), n=2)"):
            assert json.dumps(result_to_json(Executor(p, device="cpu")
                                             .execute("i", pql))) == \
                json.dumps(j_result_to_json(JExecutor(j).execute("i", pql)))
    finally:
        j.close()
        p.close()


def test_http_recalculate_caches(tmp_path):
    """POST /recalculate-caches over the port's HTTP answers 204 and
    rewrites every .cache as the reference's recount writes it."""
    rows = _seed_rows(9, rows=(1, 4))
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    h.close()
    rel = os.path.join("i", "f", "views", "standard", "fragments", "0.cache")
    with open(tmp_path / "d" / rel, "w") as fh:
        fh.write('{"kind": "ranked", "counts": [[4, 1]]}')  # stale
    shutil.copytree(tmp_path / "d", tmp_path / "jax")
    j = jstorage.Holder(str(tmp_path / "jax")).open()
    j.index("i").field("f").view("standard").fragment(0).recalculate_cache()
    server = Server(str(tmp_path / "d"), port=0, device="cpu").open()
    try:
        req = urllib.request.Request(
            f"http://localhost:{server.port}/recalculate-caches", data=b"",
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 204
            assert resp.read() == b""
        with open(tmp_path / "d" / rel, "rb") as a, \
                open(tmp_path / "jax" / rel, "rb") as b:
            assert a.read() == b.read()
    finally:
        server.close()
        j.close()


# ------------------------------------------- one K3 launch a write request


def _resident_leaf(holder, field, row):
    """The resident [S, W] stacked leaf of Row(field=row)."""
    for key, arr in holder.cache._rows.items():
        if key[0] == "stack" and key[3] == field and key[5] == row:
            return arr
    raise AssertionError(f"Row({field}={row}) is not resident")


def _rebuilt(holder, field, row, shards) -> np.ndarray:
    view = holder.index("i").field(field).view("standard")
    return np.stack([view.fragment(s).row_words(row)
                     if view.fragment(s) is not None
                     else np.zeros(W, np.uint32) for s in shards])


@pytest.fixture
def eight_shards(tmp_path, monkeypatch):
    """A port server's API over 8 shards with row 1 of f and the
    existence row resident (row 2 is not), and a spy on K3's batch
    wrapper."""
    from pilosa_tpu_torch import kernels
    from pilosa_tpu_torch.server.api import API

    rng = np.random.default_rng(12)
    rows = {}
    for r in (1, 2):
        bits = rng.random(8 * W * 32) < 0.01
        rows[r] = np.packbits(bits, bitorder="little").view("<u4")
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    api = API(h)
    api.query_raw("i", "Count(Not(Row(f=1)))")
    calls = []
    real = kernels.word_patch_batch

    def spy(targets):
        calls.append([(t[1], t[2], t[5]) for t in targets])
        return real(targets)

    monkeypatch.setattr(kernels, "word_patch_batch", spy)
    yield api, rows, calls
    h.close()


def test_import_into_resident_rows_is_one_k3_launch(eight_shards):
    """An /import of one new column into each of 8 shards patches the
    resident row and the existence leaf in one K3 batch (16 targets), and
    the next Counts show the writes."""
    api, rows, calls = eight_shards
    h = api.holder
    exists = rows[1] | rows[2]
    cols = [s * W * 32 + int(np.flatnonzero(
        exists[s * W:(s + 1) * W] == 0)[0]) * 32 for s in range(8)]
    assert api.import_bits("i", "f", [1] * 8, cols) == 8
    assert len(calls) == 1
    assert sorted(calls[0]) == sorted([(s, None, False) for s in range(8)]
                                      * 2)
    want = int(np.bitwise_count(rows[1]).sum()) + 8
    assert api.query_raw("i", "Count(Row(f=1))") == [want]
    assert api.query_raw("i", "Count(Not(Row(f=1)))") == \
        [int(np.bitwise_count(exists & ~rows[1]).sum())]
    assert np.array_equal(_resident_leaf(h, "f", 1).numpy().view(np.uint32),
                          _rebuilt(h, "f", 1, range(8)))
    # import-value and a write query open the same scope
    assert api.query_raw("i", "Set(5, f=1) Set(2097157, f=1)") == [True, True]
    assert len(calls) == 2  # row 1 (and _exists) in shards 0 and 2: one


def test_set_then_clear_in_one_request_applies_in_order(eight_shards):
    api, rows, calls = eight_shards
    h = api.holder
    col = int(np.flatnonzero(rows[1][:W] == 0)[0]) * 32
    before = api.query_raw("i", "Count(Row(f=1))")
    assert api.query_raw("i", f"Set({col}, f=1) Clear({col}, f=1)") == \
        [True, True]
    assert len(calls) == 2  # the row turned: the batch split
    assert api.query_raw("i", "Count(Row(f=1))") == before
    assert api.query_raw("i", f"Clear({col}, f=1) Set({col}, f=1)") == \
        [False, True]
    assert api.query_raw("i", "Count(Row(f=1))") == [before[0] + 1]
    assert np.array_equal(_resident_leaf(h, "f", 1).numpy().view(np.uint32),
                          _rebuilt(h, "f", 1, range(8)))


def test_leaf_built_inside_a_write_scope_equals_a_rebuild(eight_shards,
                                                           monkeypatch):
    """A leaf whose decode is under way while a write scope collects
    patches (the cache's pending build) ends equal to a rebuild from the
    fragments, and so does the resident leaf the scope patched."""
    from pilosa_tpu_torch.executor import batch

    api, rows, _ = eight_shards
    h = api.holder
    entered, release = threading.Event(), threading.Event()
    real_host_row = batch.host_row

    def held_host_row(idx, spec, shard):
        if spec.row == 2 and not entered.is_set():
            entered.set()
            release.wait(60)
        return real_host_row(idx, spec, shard)

    monkeypatch.setattr(batch, "host_row", held_host_row)
    out = []
    reader = threading.Thread(target=lambda: out.append(
        api.query_raw("i", "Count(Row(f=2))")))
    # Count(Row(f=2)) has not run yet, so its leaf is not resident
    reader.start()
    assert entered.wait(60)
    fld = h.index("i").field("f")
    assert len(h.cache._pending_builds) == 1  # Row(f=2)'s, mid-decode
    with h.cache.batch_writes():
        for s in range(8):
            for r in (1, 2):
                fld.set_bit(r, s * W * 32 + 64 + r)
                fld.clear_bit(r, s * W * 32 + int(np.flatnonzero(
                    rows[r][s * W:(s + 1) * W])[0]) * 32
                    + int(np.flatnonzero(np.unpackbits(
                        rows[r][s * W:(s + 1) * W][np.flatnonzero(
                            rows[r][s * W:(s + 1) * W])[:1]].view(np.uint8),
                        bitorder="little"))[0]))
        release.set()
        reader.join(60)
    for r in (1, 2):
        assert np.array_equal(
            _resident_leaf(h, "f", r).numpy().view(np.uint32),
            _rebuilt(h, "f", r, range(8))), r
    want = int(np.bitwise_count(_rebuilt(h, "f", 2, range(8))).sum())
    assert api.query_raw("i", "Count(Row(f=2))") == [want]


@pytest.mark.parametrize("kind", ["run", "array", "bitmap"])
def test_adding_present_bits_leaves_the_container(kind):
    """Existence marks of columns already marked (and clears of absent
    bits) change nothing and keep the container as it was, for each
    container form; a batch with one new bit still merges."""
    from pilosa_tpu_torch.roaring import RoaringBitmap
    from pilosa_tpu_torch.roaring.bitmap import ARRAY, BITMAP, RUN

    rng = np.random.default_rng(4)
    lows = {"run": np.arange(100, 60000),
            "array": np.sort(rng.choice(65536, 900, replace=False)),
            "bitmap": np.sort(rng.choice(65536, 30000, replace=False))}[kind]
    bm = RoaringBitmap()
    bm.add_ids(lows.astype(np.uint64) + (7 << 16))
    c = bm.container(7)
    assert c.kind == {"run": RUN, "array": ARRAY, "bitmap": BITMAP}[kind]
    present = rng.choice(lows, 50, replace=False).astype(np.uint64) + (7 << 16)
    absent = np.setdiff1d(np.arange(65536), lows)[:50].astype(np.uint64) + \
        (7 << 16)
    assert bm.add_ids(present) == 0 and bm.container(7) is c
    assert bm.remove_ids(absent) == 0 and bm.container(7) is c
    assert np.array_equal(c.contains_lows(np.arange(65536, dtype=np.uint16)),
                          np.isin(np.arange(65536), lows))
    assert bm.add_ids(np.append(present, absent[:1])) == 1
    assert bm.container(7).n == lows.size + 1


def test_open_holds_no_descriptors_and_close_keeps_clean_sidecars(tmp_path):
    """A group-mode holder keeps no file descriptor a fragment (a YMDH
    field at 1024 shards holds tens of thousands), and a clean close
    leaves a .cache sidecar it did not change as it was; a per-op write
    opens its fragment's file, and a written fragment's sidecar is
    rewritten."""
    rows = _seed_rows(13, rows=(1, 2))
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    load_from_dense(h, {"f": rows}, index="i")
    h.close()
    frags = os.path.join(str(tmp_path / "d"), "i", "f", "views", "standard",
                         "fragments")
    before = {n: os.stat(os.path.join(frags, n)).st_mtime_ns
              for n in os.listdir(frags) if n.endswith(".cache")}
    assert len(before) == SHARDS
    fds = len(os.listdir("/proc/self/fd"))
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    try:
        # the WAL's, the translate log and three attribute stores (the
        # index's and its two fields'), which the reference holds too
        assert len(os.listdir("/proc/self/fd")) <= fds + 4 + 1 + 3
        h.index("i").field("f").set_bit(3, 5)  # shard 0 changes
    finally:
        h.close()
    after = {n: os.stat(os.path.join(frags, n)).st_mtime_ns for n in before}
    assert [n for n in before if after[n] != before[n]] == ["0.cache"]
    p = Holder(str(tmp_path / "d"), device="cpu",
               durability_mode="per-op").open()
    try:
        fds = len(os.listdir("/proc/self/fd"))
        p.index("i").field("f").set_bit(3, 6)
        assert len(os.listdir("/proc/self/fd")) == fds + 1
    finally:
        p.close()


# ------------------------------------------------------- keys and attrs


_KEYED_SCRIPT = [
    ("users", 'Set("alice", likes="pizza") Set("bob", likes="pizza") '
              'Set("alice", likes="sushi") Set("carol", tier=2) '
              f'Set({2 * W * 32 + 9}, likes="pizza")'),
    ("users", 'SetRowAttrs(likes, "pizza", cuisine="italian") '
              'SetColumnAttrs("bob", plan="pro") SetRowAttrs(tier, 2, x=1) '
              'SetColumnAttrs(7, y=[1, 2])'),
    ("repos", "Set(3, stars=1) Set(1048580, stars=2) "
              'SetRowAttrs(stars, 1, name="a") SetColumnAttrs(3, o="b")'),
]
_KEYED_READS = [
    ("users", 'Row(likes="pizza") Row(likes="sushi") TopN(likes) Rows(likes)'
              ' GroupBy(Rows(likes), Rows(tier)) Row(tier=2)'),
    ("users", 'Options(Row(likes="pizza"), columnAttrs=true) '
              'IncludesColumn(Row(likes="sushi"), column="alice") '
              'TopN(likes, attrName="cuisine", attrValue="italian")'),
    ("repos", "Row(stars=1) Options(Row(stars=1), columnAttrs=true) "
              "TopN(stars)"),
]


def _build_keyed(holder, executor, options_cls) -> None:
    users = holder.create_index("users", keys=True)
    users.create_field("likes", options_cls(keys=True))
    users.create_field("tier")
    holder.create_index("repos").create_field("stars")
    for index, pql in _KEYED_SCRIPT:
        executor.execute(index, pql)
    holder.close()


def _names(root) -> list:
    """Every file and directory name under ``root``, by relative path."""
    out = []
    for dirpath, dirs, files in os.walk(root):
        for name in dirs + files:
            out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


def _answers(holder, executor, to_json) -> list:
    return [json.dumps(to_json(executor.execute(index, pql)))
            for index, pql in _KEYED_READS]


def _attr_stores(holder) -> dict:
    """Each attribute store's blocks and contents, through AttrStore."""
    out = {}
    for name, idx in sorted(holder.indexes.items()):
        out[name] = (idx.column_attrs.blocks(),
                     idx.column_attrs.bulk(range(3000)))
        for fname, fld in sorted(idx.fields.items()):
            out[f"{name}/{fname}"] = (fld.row_attrs.blocks(),
                                      fld.row_attrs.bulk(range(3000)))
    return out


_PACKAGES = {
    "reference": (lambda d: jstorage.Holder(d).open(), JExecutor,
                  j_result_to_json, JFieldOptions),
    "port": (lambda d: Holder(d, device="cpu").open(),
             lambda h: Executor(h, device="cpu"), result_to_json,
             FieldOptions),
}


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_keyed_dir_with_attrs_opens_in_the_other_package(tmp_path, writer,
                                                         reader):
    """A data dir with keyed indexes and fields and row and column
    attributes, written by one package, has the files the other writes
    for the same calls (the .translate.log byte for byte, .colattrs.db and
    .rowattrs.db at every level) and opens in the other with the same
    answers and the same attribute stores, which it leaves as it found
    them."""
    w_open, w_exec, w_json, w_opts = _PACKAGES[writer]
    r_open, r_exec, r_json, r_opts = _PACKAGES[reader]
    wdir, odir = str(tmp_path / "w"), str(tmp_path / "o")
    h = w_open(wdir)
    _build_keyed(h, w_exec(h), w_opts)
    h = r_open(odir)
    _build_keyed(h, r_exec(h), r_opts)
    names = _names(wdir)
    assert names == _names(odir)
    for want in (".translate.log", os.path.join("users", ".colattrs.db"),
                 os.path.join("users", "likes", ".rowattrs.db"),
                 os.path.join("repos", "stars", ".rowattrs.db")):
        assert want in names
    with open(os.path.join(wdir, ".translate.log"), "rb") as a, \
            open(os.path.join(odir, ".translate.log"), "rb") as b:
        assert a.read() == b.read()

    h = w_open(wdir)
    want, want_attrs = _answers(h, w_exec(h), w_json), _attr_stores(h)
    h.close()
    h = r_open(wdir)
    try:
        assert _answers(h, r_exec(h), r_json) == want
        assert _attr_stores(h) == want_attrs
    finally:
        h.close()
    assert _names(wdir) == names


# ------------------------------------------ import-roaring and the deletes


def test_add_ids_writes_the_reference_bytes_and_patches_once(eight_shards,
                                                             tmp_path):
    """``Fragment.add_ids`` (import-roaring's write) logs the reference's
    op record and leaves the reference's fragment and sidecars; into the
    resident row it is one K3 batch; both roaring layouts decode to the
    reference's bitmap."""
    import pilosa_tpu.roaring.format as jformat
    from pilosa_tpu.roaring.bitmap import RoaringBitmap as JRoaringBitmap
    from pilosa_tpu_torch.roaring import RoaringBitmap
    from pilosa_tpu_torch.roaring import format as pformat

    api, rows, calls = eight_shards
    rng = np.random.default_rng(4)
    ids = np.concatenate([
        (np.uint64(1) << np.uint64(20)) + rng.integers(0, W * 32, 900,
                                                       dtype=np.uint64),
        (np.uint64(9) << np.uint64(20)) + rng.integers(0, W * 32, 40,
                                                       dtype=np.uint64)])
    b, jb = RoaringBitmap(), JRoaringBitmap()
    b.add_ids(ids)
    jb.add_ids(ids)
    for ser, jser in ((pformat.serialize, jformat.serialize),
                      (pformat.serialize_pilosa, jformat.serialize_pilosa)):
        blob = ser(b)
        assert blob == jser(jb)
        got, jgot = pformat.load_any(blob), jformat.load_any(blob)
        assert got[1] == jgot[1]
        assert np.array_equal(got[0].to_ids(), jgot[0].to_ids())
    for bad in (b"\x3c\x30\x00\x00\x01\x00\x00\x00", b"\x3c\x30",
                pformat.serialize_pilosa(b)[:-7]):
        with pytest.raises(ValueError) as e:
            pformat.load_any(bad)
        with pytest.raises(ValueError) as je:
            jformat.load_any(bad)
        assert str(e.value) == str(je.value)
    # the write, beside the reference's on a copy of the same files
    h = api.holder
    h.wal.barrier()
    frag = h.index("i").field("f").view("standard").fragment(3)
    frag.snapshot()
    shutil.copytree(h.data_dir, tmp_path / "ref")
    jh = jstorage.Holder(str(tmp_path / "ref"),
                         durability_mode="per-op").open()
    try:
        jfrag = jh.index("i").field("f").view("standard").fragment(3)
        before = len(calls)
        assert frag.add_ids(ids) == jfrag.add_ids(ids)
        assert len(calls) == before + 1  # row 1 resident; row 9 is not
        assert frag.add_ids(ids) == jfrag.add_ids(ids) == 0
        assert frag.row_counts()[0].tolist() == \
            [int(r) for r in jfrag.row_ids()]
        # the row cache holds each written row's exact count
        counts = dict(zip(*(a.tolist() for a in frag.row_counts())))
        assert all(counts[r] == c for r, c in frag.row_cache.top())
        frag.snapshot()
        jfrag.snapshot()
        for suffix in ("", ".checksums"):
            with open(frag.path + suffix, "rb") as a, \
                    open(jfrag.path + suffix, "rb") as b_:
                assert a.read() == b_.read(), suffix
    finally:
        jh.close()
    assert np.array_equal(_resident_leaf(h, "f", 1).numpy().view(np.uint32),
                          _rebuilt(h, "f", 1, range(8)))


def _delete_and_crash_copy(pkg, tmp_path) -> str:
    """A group-mode holder of ``pkg`` writes f and g through the WAL,
    deletes field f and index u, and is copied live after the barrier
    (no close, no snapshot)."""
    if pkg == "port":
        h = Holder(str(tmp_path / "live"), device="cpu").open()
        opts = FieldOptions
    else:
        h = jstorage.Holder(str(tmp_path / "live")).open()
        opts = JFieldOptions
    try:
        idx = h.create_index("i")
        f, g = idx.create_field("f"), idx.create_field("g", opts())
        for col in (1, 5, W * 32 + 7, 2 * W * 32 + 9):
            f.set_bit(1, col)
            g.set_bit(2, col)
        h.create_index("u").create_field("x").set_bit(3, 4)
        h.wal.barrier()
        idx.delete_field("f")
        h.delete_index("u")
        dst = tmp_path / f"copy-{pkg}"
        h.wal.barrier()
        shutil.copytree(h.data_dir, dst)
        return str(dst)
    finally:
        h.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_deletes_survive_a_crash_in_either_package(tmp_path, writer):
    """Delete a field and an index, copy the live dir (their ops still in
    the WAL): each package's reopen of the copy has neither, a same-name
    re-creation holds no old bit, and g's writes replay."""
    copy = _delete_and_crash_copy("port" if writer == "port" else "jax",
                                  tmp_path)
    for reader in ("reference", "port"):
        d = tmp_path / f"{writer}-read-by-{reader}"
        shutil.copytree(copy, d)
        if reader == "port":
            h = Holder(str(d), device="cpu").open()
            ex = Executor(h, device="cpu")
            opts, to_json = FieldOptions, result_to_json
        else:
            h = jstorage.Holder(str(d)).open()
            ex = JExecutor(h)
            opts, to_json = JFieldOptions, j_result_to_json
        try:
            assert sorted(h.indexes) == ["i"]
            assert "f" not in h.index("i").fields
            assert not any(n.startswith(".trash-") for n in os.listdir(d))
            h.index("i").create_field("f", opts())
            h.create_index("u").create_field("x", opts())
            got = [to_json(r) for r in ex.execute(
                "i", "Count(Row(f=1)) Count(Row(g=2))")]
            got += [to_json(r) for r in ex.execute("u", "Count(Row(x=3))")]
            assert got == [0, 4, 0]
        finally:
            h.close()


def test_deleted_field_recreated_serves_no_resident_bits(eight_shards):
    """Row 1 of f is resident; the field deleted and re-created under its
    name answers from the new (empty) field, on the card's path too."""
    api, rows, calls = eight_shards
    h = api.holder
    assert api.query_raw("i", "Count(Row(f=1))")[0] > 0
    scope = h.index("i").scope
    assert any(k[0] == "stack" and k[3] == "f" for k in h.cache._rows)
    api.delete_field("i", "f")
    assert not any(scope in k[:2] and "f" in k[2:4]
                   for store in (h.cache._rows, h.cache._compressed,
                                 h.cache._host) for k in store)
    api.create_field("i", "f", {})
    assert api.query_raw("i", "Count(Row(f=1)) Count(Row(f=2))") == [0, 0]
    api.import_bits("i", "f", [1], [3])
    assert api.query_raw("i", "Count(Row(f=1))") == [1]

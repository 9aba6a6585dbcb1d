"""The port's group-commit WAL against the reference's (storage/wal.py).

The same write sequence through either package's holder writes the same
segment bytes; a data directory copied from a live holder (acknowledged
ops still in the WAL, as a crash leaves it) opens in the other package
with the same fragment files, sidecars and answers as the writer's own
reopen; tombstones, torn tails, the durability modes, the ACK barrier
and a SIGKILL mid-burst behave as the reference's tests hold them.
Threads synchronise on barriers and events, never on sleeps.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.wal as jwal
from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.roaring.format import encode_op as j_encode_op
from pilosa_tpu.storage.field import FieldOptions as JFieldOptions
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.roaring.format import encode_op
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage import FieldOptions, Holder
from pilosa_tpu_torch.storage import fragment as frag_mod
from pilosa_tpu_torch.storage import wal

torch.set_num_threads(1)

W = 32768
SW = W * 32
SHARDS = 3
REPO = Path(__file__).resolve().parents[1]


def _port(path, **kw) -> Holder:
    return Holder(str(path), device="cpu", **kw)


def _crash_copy(holder, dst):
    """A crash as the reference's tests make one: barrier, then copy the
    data dir of the live holder (no close, no snapshot, no cache save)."""
    holder.wal.barrier()
    shutil.copytree(holder.data_dir, dst)
    return str(dst)


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _view_files(root) -> dict:
    """Fragment files, .checksums and .cache sidecars."""
    return {k: b for k, b in _tree(root).items()
            if os.sep + "views" + os.sep in k}


def _wal_bytes(root) -> int:
    d = os.path.join(root, ".wal")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _frag(holder, field="f", shard=0, index="i"):
    idx = holder.index(index) or holder.create_index(index)
    fld = idx.field(field) or idx.create_field(field)
    return fld.view("standard", create=True).fragment(shard, create=True)


# ------------------------------------------------------------ write script


def _write_script(holder, options_cls, barrier_each: bool = False) -> None:
    """Set/Clear/import writes and BSI values over SHARDS shards, with a
    snapshot of some fragments midway: the same calls on either package.
    Fields f and g, int field fare: the DRYRUN corpus's schema."""
    sync = holder.wal.barrier if barrier_each else (lambda: None)
    rng = np.random.default_rng(17)
    idx = holder.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    fare = idx.create_field("fare", options_cls(type="int", min=0, max=100))
    sync()
    for r, n in ((1, 900), (2, 400), (3, 60), (4, 5)):
        cols = np.unique(rng.integers(0, SHARDS * SW, n)).astype(np.uint64)
        for s in range(SHARDS):
            sel = (cols >> np.uint64(20)) == s
            if sel.any():
                f.view("standard", create=True).fragment(
                    s, create=True).bulk_import(
                        np.full(int(sel.sum()), r, np.uint64),
                        cols[sel] & np.uint64(SW - 1))
                sync()
        idx.mark_columns_exist(cols)
        sync()
    for c in (3, 70, SW + 5, 2 * SW + 9):
        g.set_bit(7, c)
        sync()
    f.clear_bit(1, int(np.flatnonzero(
        f.view("standard").fragment(0).row_words(1))[0]) * 32)
    sync()
    for view in list(f.views.values()):
        view.fragment(1).snapshot()
    cols = rng.integers(0, SHARDS * SW, 300)
    fare.import_values(cols, rng.integers(0, 101, cols.size))
    sync()
    idx.mark_columns_exist(cols)
    sync()
    fare.set_value(5, 42)
    sync()
    fare.clear_value(int(cols[0]))
    sync()
    g.set_bit(7, SW + 77)
    f.set_bit(2, 2 * SW + 3)
    f.clear_bit(2, 2 * SW + 3)
    f.set_bit(9, 11)
    sync()


def _probe(holder) -> int:
    words = holder.index("i").field("f").view("standard").fragment(
        1).row_words(1)
    return SW + int(np.flatnonzero(np.unpackbits(
        words.view(np.uint8), bitorder="little"))[0])


def _corpus(probe: int) -> list:
    return [q.format(probe=probe) for q in DRYRUN_QUERY_SHAPES
            if "like=" not in q]  # keys are not ported yet


def _answers(execute, to_json, corpus) -> list:
    return [json.dumps(to_json(execute(q))) for q in corpus]


# ----------------------------------------------------------- record format


def test_record_codec_matches_reference():
    rng = np.random.default_rng(3)
    for rtype, key, ids in ((wal.REC_OP, "i/f/standard/0",
                             rng.integers(0, 1 << 40, 9).astype(np.uint64)),
                            (wal.REC_OP, "i/fare/bsig_fare/12",
                             np.arange(1, dtype=np.uint64)),
                            (wal.REC_TOMBSTONE, "i/f/", None),
                            (wal.REC_TOMBSTONE, "i/f/standard/1", None)):
        body = b"" if ids is None else encode_op(1, ids)
        assert body == (b"" if ids is None else j_encode_op(1, ids))
        rec = wal.encode_wal_record(rtype, key, body)
        assert rec == jwal.encode_wal_record(rtype, key, body)
        assert list(wal.iter_wal_records(rec)) == \
            list(jwal.iter_wal_records(rec))
        if ids is not None:
            op, got = wal.decode_op_body(body)
            assert op == 1 and np.array_equal(got, ids)
    assert (wal.WAL_MAGIC, wal.REC_OP, wal.REC_TOMBSTONE) == \
        (jwal.WAL_MAGIC, jwal.REC_OP, jwal.REC_TOMBSTONE)
    assert (wal.DEFAULT_GROUP_MAX_MS, wal.DEFAULT_GROUP_MAX_OPS,
            wal.SEGMENT_MAX_BYTES) == (jwal.DEFAULT_GROUP_MAX_MS,
                                       jwal.DEFAULT_GROUP_MAX_OPS,
                                       jwal.SEGMENT_MAX_BYTES)
    for key, tomb in (("i/f/standard/1", "i/f/standard/1"),
                      ("i/f/standard/10", "i/f/standard/1"),
                      ("i/f/standard/10", "i/f/"), ("i/g/x/1", "i/f/")):
        assert wal.tombstone_matches(key, tomb) == \
            jwal.tombstone_matches(key, tomb)


def test_segment_bytes_match_reference(tmp_path):
    """One single-threaded write sequence with a barrier after each write
    leaves the same segment files in both packages' .wal."""
    j = jstorage.Holder(str(tmp_path / "jax")).open()
    p = _port(tmp_path / "port").open()
    try:
        _write_script(j, JFieldOptions, barrier_each=True)
        _write_script(p, FieldOptions, barrier_each=True)
        want = _tree(tmp_path / "jax" / ".wal")
        got = _tree(tmp_path / "port" / ".wal")
        assert sorted(got) == sorted(want) and len(got) == 1
        for k in want:
            assert got[k] == want[k], k
        assert len(list(wal.iter_wal_records(next(iter(got.values()))))) > 20
    finally:
        j.close()
        p.close()
    # a clean close snapshots every dirty fragment and empties the WAL
    assert _wal_bytes(tmp_path / "port") == 0


# -------------------------------------------------------- crash-copy parity


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_crash_copy_opens_in_the_other_package(tmp_path, writer):
    """A group-mode holder written, barriered and copied live: the other
    package's open replays its WAL into the same fragment files,
    .checksums, .cache and answers as the writer's own package's open of
    the same copy, before and after a clean close."""
    if writer == "reference":
        live = jstorage.Holder(str(tmp_path / "live")).open()
        _write_script(live, JFieldOptions)
    else:
        live = _port(tmp_path / "live").open()
        _write_script(live, FieldOptions)
    try:
        copy_j = _crash_copy(live, tmp_path / "copy_j")
        copy_p = _crash_copy(live, tmp_path / "copy_p")
    finally:
        live.close()
    assert _wal_bytes(copy_p) > 0
    j = jstorage.Holder(copy_j).open()
    p = _port(copy_p).open()
    try:
        assert p.wal.metrics()["recovered_ops_total"] == \
            j.wal.metrics()["recovered_ops_total"] > 0
        assert _wal_bytes(copy_p) == 0
        want, got = _view_files(copy_j), _view_files(copy_p)
        assert sorted(got) == sorted(want)
        assert sum(k.endswith(".checksums") for k in got) >= 2 * SHARDS
        for k in want:
            assert got[k] == want[k], k
        corpus = _corpus(_probe(p))
        jex, pex = JExecutor(j), Executor(p, device="cpu")
        assert _answers(lambda q: pex.execute("i", q), result_to_json,
                        corpus) == \
            _answers(lambda q: jex.execute("i", q), j_result_to_json, corpus)
    finally:
        j.close()
        p.close()
    want, got = _view_files(copy_j), _view_files(copy_p)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def _time_mutex_script(holder, options_cls) -> None:
    """Timestamped Sets into a YMDH field (each creates its time views),
    a mutex import that moves columns, a Clear across the time views, a
    Store and a ClearRow: the same calls on either package's holder."""
    idx = holder.create_index("i")
    t = idx.create_field("t", options_cls(type="time", time_quantum="YMDH"))
    k = idx.create_field("k", options_cls(type="mutex"))
    f = idx.create_field("f")
    import datetime as dt

    rng = np.random.default_rng(23)
    for j, col in enumerate(rng.integers(0, SHARDS * SW, 40).tolist()):
        t.set_bit(j % 3, col, timestamp=dt.datetime(2019, 1 + j % 12, 3,
                                                    j % 24))
    t.clear_bit(1, int(col))
    cols = np.unique(rng.integers(0, SW, 300)).astype(np.uint64)
    frag = k.view("standard", create=True).fragment(0, create=True)
    frag.import_mutex(np.zeros(cols.size, np.uint64), cols)
    frag.import_mutex(np.full(cols.size // 2, 2, np.uint64),
                      cols[:cols.size // 2])
    for s in range(SHARDS):
        f.view("standard", create=True).fragment(s, create=True).bulk_import(
            np.ones(50, np.uint64),
            rng.integers(0, SW, 50).astype(np.uint64))
    k.view("standard").fragment(0).clear_row(2)
    words = f.view("standard").fragment(1).row_words(1)
    f.view("standard").fragment(2).write_row_words(4, words)
    f.view("standard").fragment(1).clear_row(1)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_time_view_and_clear_row_records_replay_in_either_package(
        tmp_path, writer):
    """A crash copy whose WAL holds timestamped writes, mutex moves, a
    Store's REMOVE/ADD and ClearRow records, with one time view's
    directory gone (it exists only in the log): either package's open
    recreates the view and replays into the same files and answers."""
    if writer == "reference":
        live = jstorage.Holder(str(tmp_path / "live")).open()
        _time_mutex_script(live, JFieldOptions)
    else:
        live = _port(tmp_path / "live").open()
        _time_mutex_script(live, FieldOptions)
    try:
        copies = [_crash_copy(live, tmp_path / n) for n in ("cj", "cp")]
    finally:
        live.close()
    gone = os.path.join("i", "t", "views", "standard_2019050304")
    for c in copies:
        shutil.rmtree(os.path.join(c, gone))
    j = jstorage.Holder(copies[0]).open()
    p = _port(copies[1]).open()
    try:
        assert p.wal.metrics()["recovered_ops_total"] == \
            j.wal.metrics()["recovered_ops_total"] > 0
        assert p.index("i").field("t").view("standard_2019050304") \
            is not None
        window = "from='2019-01-01T00:00', to='2019-12-31T00:00'"
        corpus = [f"Row(t={r}, {window})" for r in range(3)] + [
            "Row(t=0, from='2019-05-03T04:00', to='2019-05-03T05:00')",
            "Row(k=0)", "Row(k=2)", "Row(f=1)", "Row(f=4)", "TopN(k)"]
        jex, pex = JExecutor(j), Executor(p, device="cpu")
        assert _answers(lambda q: pex.execute("i", q), result_to_json,
                        corpus) == \
            _answers(lambda q: jex.execute("i", q), j_result_to_json, corpus)
    finally:
        j.close()
        p.close()
    want, got = _view_files(copies[0]), _view_files(copies[1])
    assert any("standard_2019050304" in k for k in got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_recovered_fragments_verify_and_rank(tmp_path):
    """Replay snapshots every touched fragment, so the next verified open
    (the default) checks fresh .checksums, and recounts its row cache."""
    h = _port(tmp_path / "h").open()
    frag = _frag(h)
    for i in range(20):
        frag.set_bit(4, i)
    frag.set_bit(2, 7)
    d = _crash_copy(h, tmp_path / "c")
    h.close()
    p = _port(d).open()
    try:
        f2 = p.index("i").field("f").view("standard").fragment(0)
        assert f2.top(2) == [(4, 20), (2, 1)]
        assert os.path.exists(f2.path + ".checksums")
    finally:
        p.close()
    p = _port(d, verify_on_load=True).open()
    p.close()


# ------------------------------------------------------------- tombstones


def _both_reopen(live, tmp_path):
    """Crash-copy a live reference holder twice; open one copy in each
    package."""
    copy_j = _crash_copy(live, tmp_path / "copy_j")
    copy_p = _crash_copy(live, tmp_path / "copy_p")
    return jstorage.Holder(copy_j).open(), _port(copy_p).open()


def _row_sets(holder, field="f") -> dict:
    view = holder.index("i").field(field).view("standard")
    out = {}
    for shard, frag in sorted(view.fragments.items()):
        for row in range(12):
            words = frag.row_words(row)
            if words.any():
                out[(shard, row)] = np.flatnonzero(np.unpackbits(
                    words.view(np.uint8), bitorder="little")).tolist()
    return out


def test_reference_index_tombstone_blocks_resurrection(tmp_path):
    live = jstorage.Holder(str(tmp_path / "live")).open()
    _frag(live).set_bit(1, 5)
    live.delete_index("i")
    _frag(live).set_bit(2, 6)  # same names, a new era
    j, p = _both_reopen(live, tmp_path)
    live.close()
    try:
        assert _row_sets(p) == _row_sets(j) == {(0, 2): [6]}
    finally:
        j.close()
        p.close()


def test_reference_shard_tombstone_spares_decimal_siblings(tmp_path):
    live = jstorage.Holder(str(tmp_path / "live")).open()
    _frag(live, shard=1).set_bit(1, 1)
    _frag(live, shard=10).set_bit(2, 2)
    live.index("i").field("f").view("standard").remove_fragment(1)
    j, p = _both_reopen(live, tmp_path)
    live.close()
    try:
        assert _row_sets(p) == _row_sets(j) == {(10, 2): [2]}
    finally:
        j.close()
        p.close()


def test_reference_crashed_shard_delete_is_redone(tmp_path):
    """A durable shard tombstone whose unlinks never ran: replay deletes
    the fragment's files before anything else."""
    live = jstorage.Holder(str(tmp_path / "live")).open()
    frag = _frag(live)
    frag.set_bit(1, 5)
    frag.snapshot()  # the bit is in the fragment file itself
    _frag(live, shard=1).set_bit(3, 9)
    live.wal.tombstone(frag.wal_key)
    live.wal.barrier()  # ... and the delete crashes right here
    j, p = _both_reopen(live, tmp_path)
    live.close()
    try:
        assert _row_sets(p) == _row_sets(j) == {(1, 3): [9]}
        view = p.index("i").field("f").view("standard")
        assert not os.path.exists(os.path.join(view.path, "fragments", "0"))
    finally:
        j.close()
        p.close()


def test_reference_field_delete_skips_its_ops(tmp_path):
    live = jstorage.Holder(str(tmp_path / "live")).open()
    _frag(live).set_bit(1, 5)
    _frag(live, field="g").set_bit(1, 6)
    live.index("i").delete_field("f")
    j, p = _both_reopen(live, tmp_path)
    live.close()
    try:
        assert p.index("i").field("f") is None
        assert _row_sets(p, "g") == _row_sets(j, "g") == {(0, 1): [6]}
    finally:
        j.close()
        p.close()


# -------------------------------------------------------------- torn tails


def test_torn_segment_tail_is_cut_at_every_byte_offset(tmp_path):
    """A segment whose last record is cut at any byte: both packages'
    readers drop exactly that record, and the port's open replays the
    rest."""
    first = wal.encode_wal_record(
        wal.REC_OP, "i/f/standard/0", encode_op(1, np.array(
            [(1 << 20) + 4, (1 << 20) + 70000], np.uint64)))
    last = wal.encode_wal_record(
        wal.REC_OP, "i/f/standard/0", encode_op(1, np.arange(
            (2 << 20) + 10, (2 << 20) + 13, dtype=np.uint64)))
    buf = first + last
    base = tmp_path / "base"
    h = _port(base).open()
    _frag(h)
    h.close()
    for cut in range(len(first), len(buf)):
        got = list(wal.iter_wal_records(buf[:cut]))
        assert got == list(jwal.iter_wal_records(buf[:cut]))
        assert [k for _, k, _ in got] == ["i/f/standard/0"], cut
    for cut in (len(first), len(first) + 7, len(buf) - 1, len(buf)):
        d = tmp_path / f"cut{cut}"
        shutil.copytree(base, d)
        (d / ".wal").mkdir(exist_ok=True)
        (d / ".wal" / "00000001.log").write_bytes(buf[:cut])
        p = _port(d).open()
        try:
            frag = p.index("i").field("f").view("standard").fragment(0)
            assert frag.contains(1, 4) and frag.contains(1, 70000)
            assert frag.count_row(2) == (3 if cut == len(buf) else 0)
        finally:
            p.close()
    bad = bytearray(buf)
    bad[-1] ^= 0x55  # a corrupt crc in the tail record
    assert len(list(wal.iter_wal_records(bytes(bad)))) == 1


# --------------------------------------------------------- durability modes


def test_port_defaults_to_group_commit(tmp_path):
    h = _port(tmp_path / "h")
    assert h.wal.mode == wal.MODE_GROUP
    s = Server(str(tmp_path / "s"), port=0, device="cpu")
    assert s.holder.wal.mode == wal.MODE_GROUP
    with pytest.raises(ValueError, match="durability"):
        _port(tmp_path / "x", durability_mode="maybe")
    from pilosa_tpu_torch.__main__ import main

    with pytest.raises(SystemExit):
        main(["server", "-d", str(tmp_path / "y"), "--durability-mode",
              "maybe"])


def test_group_mode_keeps_ops_out_of_fragment_files(tmp_path):
    h = _port(tmp_path / "h").open()
    frag = _frag(h)
    frag.set_bit(1, 5)
    h.wal.barrier()
    with open(frag.path, "rb") as fh:
        size = len(fh.read())
    h.close()
    jh = jstorage.Holder(str(tmp_path / "h")).open()
    try:
        jf = jh.index("i").field("f").view("standard").fragment(0)
        assert jf.contains(1, 5)
    finally:
        jh.close()
    empty = _port(tmp_path / "e").open()
    path = _frag(empty).path
    empty.close()
    assert size == os.path.getsize(path)  # a bare snapshot, no op record


@pytest.mark.parametrize("mode,fsyncs_a_write", [("per-op", 1),
                                                  ("flush-only", 0)])
def test_fragment_modes_fsync_as_the_reference(tmp_path, monkeypatch, mode,
                                               fsyncs_a_write):
    calls = []
    monkeypatch.setattr(frag_mod, "wal_fsync",
                        lambda fd: calls.append(fd) or os.fsync(fd))
    h = _port(tmp_path / "h", durability_mode=mode).open()
    frag = _frag(h)
    before = len(calls)
    for i in range(5):
        frag.set_bit(1, i)
    frag.bulk_import(np.full(3, 2, np.uint64), np.arange(3, dtype=np.uint64))
    assert len(calls) - before == 6 * fsyncs_a_write
    assert h.wal.metrics()["fsyncs_total"] == 0  # no WAL machinery
    h.wal.barrier()  # a free no-op outside group mode
    h.close()
    d = _port(tmp_path / "h").open()
    try:
        assert d.index("i").field("f").view("standard").fragment(
            0).count_row(1) == 5
    finally:
        d.close()


def test_barrier_releases_only_after_the_fsync(tmp_path):
    h = _port(tmp_path / "h").open()
    entered, release = threading.Event(), threading.Event()
    fsynced = []

    def held_fsync(fd):
        entered.set()
        release.wait(60)
        os.fsync(fd)
        fsynced.append(fd)

    h.wal._fsync = held_fsync
    frag = _frag(h)
    frag.set_bit(1, 1)
    seen = []
    t = threading.Thread(target=lambda: (h.wal.barrier(),
                                         seen.append(len(fsynced))))
    t.start()
    assert entered.wait(60)
    assert t.is_alive() and not seen  # the append alone is not durable
    release.set()
    t.join(60)
    assert seen == [1]
    assert h.wal.durable_seq() == h.wal.current_seq()
    h.close()


def test_one_fsync_covers_a_group_of_concurrent_writers(tmp_path):
    h = _port(tmp_path / "h").open()
    frags = [_frag(h, shard=s) for s in range(4)]
    gate = threading.Barrier(8)

    def writer(tid):
        gate.wait(60)
        for k in range(25):
            frags[tid % 4].set_bit(1, tid * 100 + k)
        h.wal.barrier()

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    m = h.wal.metrics()
    assert m["appended_ops_total"] == 200
    assert m["fsyncs_total"] == m["groups_total"] <= 200
    h.close()
    d = _port(tmp_path / "h").open()
    try:
        assert sum(d.index("i").field("f").view("standard").fragment(
            s).count_row(1) for s in range(4)) == 200
    finally:
        d.close()


def test_commit_failure_fails_the_barrier(tmp_path):
    h = _port(tmp_path / "h").open()

    def broken(fd):
        raise OSError("disk gone")

    h.wal._fsync = broken
    _frag(h).set_bit(1, 1)
    with pytest.raises(OSError, match="wal commit failed"):
        h.wal.barrier()
    with pytest.raises(OSError, match="wal commit failed"):
        _frag(h).set_bit(1, 2)  # later writes fail too, not ack silently
    h.wal._error = None
    h.wal._fsync = os.fsync
    h.close()


def test_segment_rotation_checkpoints_and_gcs(tmp_path, monkeypatch):
    monkeypatch.setattr(wal, "SEGMENT_MAX_BYTES", 4096)
    h = _port(tmp_path / "h").open()
    frag = _frag(h)
    for i in range(300):
        frag.set_bit(1, i)
        h.wal.barrier()
    # the last rotation's checkpoint may still run: take its turn
    h.wal._spawn_checkpoint()
    while True:
        with h.wal._seg_lock:
            if not h.wal._checkpointing:
                break
        h.wal.barrier()
    h.wal._checkpoint()
    m = h.wal.metrics()
    assert m["checkpoints_total"] > 0 and m["segments"] <= 2, m
    d = _crash_copy(h, tmp_path / "c")
    h.close()
    p = _port(d).open()
    try:
        assert p.index("i").field("f").view("standard").fragment(
            0).count_row(1) == 300
    finally:
        p.close()


@pytest.mark.parametrize("mode", ["flush-only", "per-op"])
def test_mode_switch_after_crash_still_recovers(tmp_path, mode):
    h = _port(tmp_path / "h").open()
    _frag(h).set_bit(1, 5)
    _frag(h, shard=2).set_bit(3, 8)
    d = _crash_copy(h, tmp_path / "c")
    h.close()
    p = _port(d, durability_mode=mode).open()
    try:
        view = p.index("i").field("f").view("standard")
        assert view.fragment(0).contains(1, 5)
        assert view.fragment(2).contains(3, 8)
        assert p.wal.metrics()["recovered_ops_total"] == 2
        assert not [f for f in os.listdir(os.path.join(d, ".wal"))
                    if f.endswith(".log")]
    finally:
        p.close()


# --------------------------------------------------------- ACK over HTTP


def _post(port, path, body) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read() or b"{}")


@pytest.mark.parametrize("mode", ["group", "per-op"])
def test_http_200_means_fsynced(tmp_path, monkeypatch, mode):
    """Every write a 200 acknowledges (Set/Clear, /import, import-value)
    is fsynced by then: its WAL group in group mode, its record in
    per-op mode."""
    fragment_fsyncs = []
    monkeypatch.setattr(frag_mod, "wal_fsync",
                        lambda fd: fragment_fsyncs.append(fd) or os.fsync(fd))
    server = Server(str(tmp_path / "d"), bind="127.0.0.1", port=0,
                    device="cpu", durability_mode=mode).open()
    w = server.holder.wal
    try:
        _post(server.port, "/index/i", b"{}")
        _post(server.port, "/index/i/field/f", b"{}")
        _post(server.port, "/index/i/field/v",
              b'{"options": {"type": "int", "min": 0, "max": 50}}')
        writes = [("/index/i/query", b"Set(3, f=1) Set(1048579, f=2)"),
                  ("/index/i/query", b"Clear(3, f=1)"),
                  ("/index/i/field/f/import",
                   b'{"rows": [4, 4], "columns": [9, 2097161]}'),
                  ("/index/i/field/v/import-value",
                   b'{"columns": [5, 1048581], "values": [7, 50]}')]
        for path, body in writes:
            before = len(fragment_fsyncs)
            _post(server.port, path, body)
            if mode == "group":
                assert w.durable_seq() == w.current_seq() > 0
                assert not fragment_fsyncs
            else:
                assert len(fragment_fsyncs) > before
        if mode == "group":
            assert w.metrics()["fsyncs_total"] >= len(writes)
    finally:
        server.close()


# ----------------------------------------------- SIGKILL mid-burst, on cpu


def test_sigkill_mid_burst_every_acked_write_survives(tmp_path):
    """A port server process (group mode, cpu) SIGKILLed while 4 clients
    write: the reopened directory holds every acknowledged write and
    nothing but acknowledged and in-flight ones."""
    data = tmp_path / "d"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "-d", str(data),
         "-b", "127.0.0.1", "--port", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = proc.stdout.readline()  # printed once the server serves
        assert "serving" in line, line
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        _post(port, "/index/i", b"{}")
        _post(port, "/index/i/field/f", b"{}")
        acked, inflight = set(), {}
        lock = threading.Condition()
        stop = threading.Event()

        def writer(tid):
            k = 0
            while not stop.is_set():
                col = tid + 4 * k + (k % 3) * SW  # over three shards
                k += 1
                with lock:
                    inflight[tid] = col
                try:
                    out = _post(port, "/index/i/query",
                                f"Set({col}, f=1)".encode())
                except Exception:
                    return  # the kill landed mid-request
                if out == {"results": [True]}:
                    with lock:
                        acked.add(col)
                        inflight.pop(tid, None)
                        lock.notify_all()

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        with lock:
            assert lock.wait_for(lambda: len(acked) >= 60, timeout=120)
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
        stop.set()
        for t in threads:
            t.join(60)
        with lock:
            acked_now, maybe = set(acked), set(inflight.values())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    h = _port(data).open()
    try:
        assert h.wal.metrics()["recovered_ops_total"] > 0
        view = h.index("i").field("f").view("standard")
        got = set()
        for shard, frag in view.fragments.items():
            bits = np.unpackbits(frag.row_words(1).view(np.uint8),
                                 bitorder="little")
            got.update((shard * SW + np.flatnonzero(bits)).tolist())
        assert acked_now <= got <= acked_now | maybe
        assert _wal_bytes(data) == 0
    finally:
        h.close()

"""The port's storage-integrity plane against the reference's.

Each test feeds both packages the same seeded input: fragment files
flipped or truncated at every offset, snapshot bytes, data dirs with
rotten fragments opened by both (the same quarantines, artifacts and
answers), scrub passes (the same records), an injected ENOSPC over HTTP
(the same statuses, headers, bodies and recovery), the CLI ``check``
verb, the server knobs, the integrity counters and the pacer. The
device-side cases hold the resident leaves: a self-heal keeps them, a
refused write patches nothing, a quarantined shard stacks as zeros.
At most 4 shards, one torch thread; the only waits are the health
probe's (its interval lowered and restored in ``finally``).
"""

import errno
import glob
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pilosa_tpu.roaring.kernels as jkernels
import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.integrity as jintegrity
import pilosa_tpu.storage.residency as jres
from __graft_entry__ import DRYRUN_QUERY_SHAPES
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.parallel.pacer import RepairPacer as JRepairPacer
from pilosa_tpu.parallel.scrub import Scrubber as JScrubber
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.testing import faults as jfaults
from pilosa_tpu_torch import __main__ as cli
from pilosa_tpu_torch import kernels as pkernels
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.parallel import pacer as ppacer
from pilosa_tpu_torch.parallel.pacer import RepairPacer
from pilosa_tpu_torch.parallel.scrub import Scrubber
from pilosa_tpu_torch.roaring import RoaringBitmap, kernels
from pilosa_tpu_torch.roaring.format import deserialize, encode_op, serialize
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.server import config_from_dict, config_from_toml
from pilosa_tpu_torch.storage import FieldOptions, Fragment, Holder, integrity
from pilosa_tpu_torch.storage import fragment as frag_mod
from pilosa_tpu_torch.testing import faults

torch.set_num_threads(1)

SW = 1 << 20
SHARDS = 4
PROBE_S = 0.05


@pytest.fixture(autouse=True)
def _clean_planes():
    """Both packages' fault planes cleared and probe intervals restored
    after every test."""
    old = (integrity.StorageHealth.PROBE_INTERVAL_S,
           jintegrity.StorageHealth.PROBE_INTERVAL_S)
    integrity.StorageHealth.PROBE_INTERVAL_S = PROBE_S
    jintegrity.StorageHealth.PROBE_INTERVAL_S = PROBE_S
    try:
        yield
    finally:
        faults.clear_disk()
        jfaults.clear_disk()
        (integrity.StorageHealth.PROBE_INTERVAL_S,
         jintegrity.StorageHealth.PROBE_INTERVAL_S) = old


def _flip(path, offset, mask=0x10):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _frag_path(root, field, shard, view="standard", index="i"):
    return os.path.join(str(root), index, field, "views", view, "fragments",
                        str(shard))


def _seed_dir(path) -> None:
    """Index i over SHARDS shards: set fields f (rows 1-3) and g (row 7),
    int field fare (0..100), written through the port and closed (every
    fragment a snapshot with its .checksums and .cache)."""
    rng = np.random.default_rng(11)
    h = Holder(str(path), device="cpu").open()
    try:
        idx = h.create_index("i")
        f = idx.create_field("f")
        g = idx.create_field("g")
        fare = idx.create_field("fare", FieldOptions(type="int", min=0,
                                                     max=100))
        for s in range(SHARDS):
            for fld, rows in ((f, (1, 2, 3)), (g, (7,))):
                for r in rows:
                    pos = np.unique(rng.integers(0, SW, 40 * r + 30))
                    fld.view("standard", create=True).fragment(
                        s, create=True).bulk_import(
                            np.full(pos.size, r, np.uint64),
                            pos.astype(np.uint64))
                    idx.mark_columns_exist(pos.astype(np.uint64)
                                           + np.uint64(s * SW))
        cols = np.unique(rng.integers(0, SHARDS * SW, 300)).astype(np.uint64)
        fare.import_values(cols, rng.integers(0, 101, cols.size))
        idx.mark_columns_exist(cols)
    finally:
        h.close()


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("integrity") / "seed"
    _seed_dir(root)
    return root


def _copies(seed, tmp_path, *names):
    out = []
    for name in names:
        shutil.copytree(seed, tmp_path / name)
        out.append(tmp_path / name)
    return out


def _probe_col(root) -> int:
    """A column set in f row 1 of shard 0."""
    frag = Fragment(_frag_path(root, "f", 0), "i", "f", "standard", 0)
    frag.open()
    try:
        return int(frag.row_columns(1)[0])
    finally:
        frag.close(discard=True)


def _corpus(probe: int) -> list:
    return [q.format(probe=probe) for q in DRYRUN_QUERY_SHAPES
            if "like=" not in q] + [
        "Options(Count(Row(f=1)), shards=[1])",
        "Options(Count(Intersect(Row(f=1), Row(g=7))), shards=[1, 2])",
        "Count(Intersect(Row(f=2), Row(g=7)))",
    ]


def _answers(execute, to_json, corpus) -> list:
    return [json.dumps(to_json(execute(q))) for q in corpus]


def _rel(paths, root) -> list:
    return sorted(os.path.relpath(p, root) for p in paths)


def _quarantine_files(root) -> list:
    return _rel([p for p in glob.glob(os.path.join(str(root), "**", "*"),
                                      recursive=True)
                 if integrity.QUARANTINE_MARK in os.path.basename(p)], root)


def _counts(stats) -> dict:
    return dict(stats.metrics())


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


# ------------------------------------------------------- corruption fuzz


def _fuzz_file(tmp_path):
    """A fragment file with a snapshot (40 bits of row 1) and an op tail
    (6 bits of row 2), and its sidecar."""
    frag = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    for i in range(40):
        frag.set_bit(1, i * 7)
    frag.snapshot()
    for i in range(6):
        frag.set_bit(2, i)
    frag.close()
    with open(frag.path, "rb") as f:
        data = f.read()
    with open(frag.path + integrity.CHECKSUM_SUFFIX, "rb") as f:
        sidecar = f.read()
    return frag.path, data, sidecar


def _ids(bitmap) -> list:
    """Every id, listed as the reference's ``to_ids`` lists them (a
    corrupt key's ids wrap past 2^64 there)."""
    if hasattr(bitmap, "to_ids"):
        return bitmap.to_ids().tolist()
    return kernels.fragment_ids(kernels.flatten(bitmap)).tolist()


def _outcome(fn):
    """What a verify or open did: its typed error's text, offset and
    block, or what it returned."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", type(e).__name__, str(e), getattr(e, "offset", 0),
                getattr(e, "block", 0))


def _open_outcome(cls, path, ops: list):
    """A verified open's verdict and bits; its op count goes to ``ops``
    (the port's open snapshots a torn tail away, the reference's keeps
    counting the records it replayed)."""
    def run():
        frag = cls(path, "i", "f", "standard", 0, verify_on_load=True).open()
        try:
            ops.append(frag.op_n)
            return _ids(frag.bitmap)
        finally:
            frag.close(discard=True)
    return _outcome(run)


def _verify_outcomes(mod, path) -> list:
    def full():
        bitmap, _data, ops_at = mod.verify_fragment_file(path)
        return ops_at, _ids(bitmap)

    def fast():
        return mod.verify_fragment_file(path, build_bitmap=False)[2]
    return [_outcome(full), _outcome(fast)]


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_every_offset_gets_the_reference_verdict(tmp_path, damage):
    """The TestCorruptionFuzz recipe: flip a bit at, or truncate at,
    every offset of a small fragment file. verify_fragment_file in both
    modes and a verified open give the reference's verdict: the same
    CorruptFragmentError text, offset and block, or the same ops and
    bits (the op tail's CRCs drop a damaged record, never invent one)."""
    path, data, sidecar = _fuzz_file(tmp_path)
    n_corrupt = 0
    for at in range(len(data)):
        if damage == "flip":
            buf = bytearray(data)
            buf[at] ^= 0x04
            buf = bytes(buf)
        else:
            buf = data[:at]
        with open(path, "wb") as f:
            f.write(buf)
        with open(path + integrity.CHECKSUM_SUFFIX, "wb") as f:
            f.write(sidecar)
        ops = []
        want = _verify_outcomes(jintegrity, path)
        want.append(_open_outcome(JFragment, path, ops))
        got = _verify_outcomes(integrity, path)
        # after the reference's open: the port's open rewrites a torn tail
        got.append(_open_outcome(Fragment, path, ops))
        assert got == want, (damage, at)
        if len(ops) == 2:  # opened: no record invented, none lost intact
            assert ops[1] in (ops[0], 0) and ops[0] <= 6, (damage, at)
        n_corrupt += got[2][0] == "error"
    assert 0 < n_corrupt < len(data)


def _mixed_bitmap(seed: int) -> RoaringBitmap:
    """Array, bitmap and run containers at seeded keys."""
    rng = np.random.default_rng(seed)
    ids = []
    for key in np.unique(rng.integers(0, 1 << 24, 12)).tolist():
        kind = rng.integers(0, 3)
        base = key << 16
        if kind == 0:
            lows = rng.integers(0, 1 << 16, rng.integers(1, 300))
        elif kind == 1:
            lows = rng.integers(0, 1 << 16, 9000)
        else:
            lo = int(rng.integers(0, 60000))
            lows = np.arange(lo, lo + int(rng.integers(1, 5000)))
        ids.append(np.unique(lows).astype(np.uint64) + np.uint64(base))
    bm = RoaringBitmap()
    bm.add_ids(np.concatenate(ids))
    return bm


@pytest.mark.parametrize("seed", range(4))
def test_snapshot_ids_match_reference_and_decoder(seed):
    bm = _mixed_bitmap(seed)
    buf = serialize(bm) + encode_op(1, np.arange(3, dtype=np.uint64))
    got, at = kernels.snapshot_ids(buf)
    want, jat = jkernels.snapshot_ids(buf)
    assert at == jat == len(serialize(bm))
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(_ids(deserialize(buf)[0]),
                                          np.uint64))
    assert integrity.block_digests(got) == jintegrity.block_digests(want)


def _snapshot(descrs, payload: bytes) -> bytes:
    import struct

    head = struct.pack("<IHHIQ", 0x50C4B175, 1, 0, len(descrs), len(payload))
    return head + b"".join(struct.pack("<QHHI", *d) for d in descrs) + payload


IRREGULAR = {
    # a key twice: the decoder keeps the last
    "duplicate_key": _snapshot([(3, 1, 1, 4), (3, 1, 0, 2)],
                               np.array([5, 9, 7], "<u2").tobytes()),
    # a bitmap payload short of 1024 words
    "short_bitmap": _snapshot([(1, 2, 0, 8 * 1023)],
                              np.full(1023, 5, "<u8").tobytes()),
    "bad_magic": b"\x00" * 24,
    "truncated_header": b"\x75\xb1\xc4\x50",
    "unknown_kind": _snapshot([(0, 7, 0, 2)], b"\x01\x00"),
    "truncated_payload": _snapshot([(0, 1, 1, 4)], b"\x01\x00"),
    "length_mismatch": _snapshot([(0, 1, 0, 2)], b"\x01\x00")[:-2]
    + b"\x01\x00\x00\x00",
}


@pytest.mark.parametrize("name", sorted(IRREGULAR))
def test_irregular_and_malformed_snapshots_as_the_reference(name):
    buf = IRREGULAR[name]

    def run(mod):
        try:
            ids, at = mod.snapshot_ids(buf)
            return ("ok", ids.tolist(), at)
        except Exception as e:  # noqa: BLE001 — the text is compared
            return ("error", type(e).__name__, str(e))
    assert run(kernels) == run(jkernels)


def test_kernel_stats_count_as_the_reference():
    buf = serialize(_mixed_bitmap(9))
    before = kernels.global_kernel_stats().metrics()
    jbefore = jkernels.global_kernel_stats().metrics()
    kernels.snapshot_ids(buf)
    jkernels.snapshot_ids(buf)
    assert _delta(kernels.global_kernel_stats().metrics(), before) == \
        _delta(jkernels.global_kernel_stats().metrics(), jbefore)


# ---------------------------------------------------- startup quarantine


def _rot(root) -> None:
    """Shard 1 rotten in both set fields, shard 2's g torn mid-container,
    shard 3's f without its sidecar (not rot: it opens unverified)."""
    for field in ("f", "g"):
        p = _frag_path(root, field, 1)
        _flip(p, os.path.getsize(p) - 3)
    p = _frag_path(root, "g", 2)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    os.unlink(_frag_path(root, "f", 3) + integrity.CHECKSUM_SUFFIX)


def _surviving(holder) -> dict:
    return {f"{fn}/{vn}": sorted(v.fragments)
            for fn, fld in holder.index("i").fields.items()
            for vn, v in fld.views.items()}


def test_startup_quarantine_matches_reference(seed_dir, tmp_path):
    """C6: a data dir with rotten fragments opens in the port as in the
    reference: the same fragments quarantined under the same names and
    left out, the same counters, the same answers over the parity corpus
    (quarantined shards included); each package then opens the other's
    quarantined dir with no new quarantine and the same answers."""
    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    probe = _probe_col(pdir)
    _rot(jdir)
    _rot(pdir)
    corpus = _corpus(probe)
    jbefore = _counts(jintegrity.global_integrity())
    jh = jstorage.Holder(str(jdir)).open()
    jd = _delta(_counts(jintegrity.global_integrity()), jbefore)
    before = _counts(integrity.global_integrity())
    ph = Holder(str(pdir), device="cpu").open()
    pd = _delta(_counts(integrity.global_integrity()), before)
    try:
        assert pd == jd
        assert pd["integrity_quarantined_total"] == 3
        assert pd["integrity_verify_failures_total"] == 3
        assert pd["integrity_unverified_loads_total"] >= 1
        assert _surviving(ph) == _surviving(jh)
        assert 1 not in ph.index("i").field("f").view("standard").fragments
        assert _quarantine_files(pdir) == _quarantine_files(jdir)
        assert _rel(integrity.list_quarantined(str(pdir)), pdir) == \
            _rel(jintegrity.list_quarantined(str(jdir)), jdir) == sorted(
                os.path.join("i", f, "views", "standard", "fragments",
                             f"{s}.quarantine-0")
                for f, s in (("f", 1), ("g", 1), ("g", 2)))
        want = _answers(lambda q: JExecutor(jh).execute("i", q),
                        j_result_to_json, corpus)
        got = _answers(lambda q: Executor(ph, device="cpu").execute("i", q),
                       result_to_json, corpus)
        assert got == want
    finally:
        jh.close()
        ph.close()
    # the other package's quarantined dir: nothing new to quarantine
    before = _counts(integrity.global_integrity())
    ph = Holder(str(jdir), device="cpu").open()
    jh = jstorage.Holder(str(pdir)).open()
    try:
        assert _delta(_counts(integrity.global_integrity()),
                      before)["integrity_quarantined_total"] == 0
        assert _quarantine_files(jdir) == _quarantine_files(pdir)
        assert _answers(lambda q: Executor(ph, device="cpu").execute("i", q),
                        result_to_json, corpus) == want
        assert _answers(lambda q: JExecutor(jh).execute("i", q),
                        j_result_to_json, corpus) == want
    finally:
        jh.close()
        ph.close()


def test_quarantined_shard_stacks_as_zeros(seed_dir, tmp_path):
    """A quarantined (field, shard) is absent from its view: its slot in
    a stacked leaf is zeros, so an Intersect of two fields keeps the
    same shard order, and the shard list still holds it (the existence
    field and fare cover it), as the reference's does."""
    (pdir, jdir) = _copies(seed_dir, tmp_path, "port", "jax")
    _rot(pdir)
    _rot(jdir)
    ph = Holder(str(pdir), device="cpu").open()
    jh = jstorage.Holder(str(jdir)).open()
    try:
        assert ph.index("i").available_shards() == \
            jh.index("i").available_shards() == list(range(SHARDS))
        q = ("Count(Intersect(Row(f=1), Row(g=7))) Count(Row(f=1)) "
             "Options(Count(Row(g=7)), shards=[1, 2])")
        got = result_to_json(Executor(ph, device="cpu").execute("i", q))
        assert got == j_result_to_json(JExecutor(jh).execute("i", q))
        leaves = {k[3]: v for k, v in ph.cache._rows.items()
                  if k[0] == "stack" and k[6][1] == tuple(range(SHARDS))}
        f_leaf = leaves["f"].numpy()
        g_leaf = leaves["g"].numpy()
        assert not f_leaf[1].any() and not g_leaf[1].any()
        assert not g_leaf[2].any()
        assert f_leaf[0].any() and f_leaf[2].any() and g_leaf[3].any()
    finally:
        ph.close()
        jh.close()


# ------------------------------------------------------------- scrubber


def _pass(record) -> dict:
    return {k: v for k, v in record.items() if k != "wall_s"}


def _scrub_both(seed_dir, tmp_path, prepare):
    """``prepare(pkg, root, holder)`` on each package's copy, then two
    scrub passes each; returns the records and the artifacts."""
    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    jh = jstorage.Holder(str(jdir)).open()
    ph = Holder(str(pdir), device="cpu").open()
    try:
        out = {}
        for pkg, root, h, scrubber in (("jax", jdir, jh, JScrubber(jh)),
                                       ("port", pdir, ph, Scrubber(ph))):
            with prepare(pkg, root, h):
                first = scrubber.scrub_pass()
            second = scrubber.scrub_pass()
            out[pkg] = (_pass(first), _pass(second), _quarantine_files(root),
                        scrubber.metrics()["scrub_self_heals_total"])
        return out, jh, ph
    except BaseException:
        jh.close()
        ph.close()
        raise


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _flipped(pkg, root, h):
    for field, shard in (("f", 0), ("g", 3)):
        p = _frag_path(root, field, shard)
        _flip(p, os.path.getsize(p) - 3)
    return _Nothing()


class _Racy:
    """The first (unlocked) read of each file sees a flipped byte, the
    locked re-read the truth: a racing snapshot, not rot."""

    def __init__(self, mod):
        self.mod, self.real, self.seen = mod, mod.read_file, set()

    def read(self, path):
        data = self.real(path)
        if path in self.seen:
            return data
        self.seen.add(path)
        buf = bytearray(data)
        buf[-3] ^= 0x40
        return bytes(buf)

    def __enter__(self):
        self.mod.read_file = self.read
        return self

    def __exit__(self, *exc):
        self.mod.read_file = self.real
        return False


class _ReadFlip:
    """Bit-flip-on-read through the fault plane: both the unlocked read
    and the locked confirm see it."""

    def __init__(self, plane_mod, root):
        self.plane_mod, self.root = plane_mod, root

    def __enter__(self):
        plane = self.plane_mod.install_disk()
        plane.add("read", path=_frag_path(self.root, "f", 2),
                  flip_offset=-3, flip_mask=0x02)
        return self

    def __exit__(self, *exc):
        self.plane_mod.clear_disk()
        return False


SCRUB_CASES = {
    "self_heal": _flipped,
    "clean": lambda pkg, root, h: _Nothing(),
    "racing_snapshot": lambda pkg, root, h: _Racy(
        jintegrity if pkg == "jax" else integrity),
    "read_flip": lambda pkg, root, h: _ReadFlip(
        jfaults if pkg == "jax" else faults, root),
}


@pytest.mark.parametrize("case", sorted(SCRUB_CASES))
def test_scrub_pass_records_match_reference(seed_dir, tmp_path, case):
    """The same pass records (all but wall_s) and artifacts: rot is
    detected, quarantined and re-snapshotted from the live bitmap; a
    clean pass and a racing snapshot quarantine nothing; the second
    pass finds the disk clean, and the answers are unchanged."""
    out, jh, ph = _scrub_both(seed_dir, tmp_path, SCRUB_CASES[case])
    try:
        assert out["port"] == out["jax"]
        first, second, artifacts, heals = out["port"]
        assert first["scanned"] == second["scanned"] > 0
        assert first["bytes"] == second["bytes"] > 0
        assert second["corrupt"] == 0
        want_heals = {"self_heal": 2, "read_flip": 1}.get(case, 0)
        assert first["corrupt"] == first["self_healed"] == heals == \
            want_heals
        assert len(artifacts) == 3 * want_heals  # with .cache, .checksums
        corpus = _corpus(_probe_col(tmp_path / "port"))
        assert _answers(lambda q: Executor(ph, device="cpu").execute("i", q),
                        result_to_json, corpus) == \
            _answers(lambda q: JExecutor(jh).execute("i", q),
                     j_result_to_json, corpus)
    finally:
        jh.close()
        ph.close()


def test_self_heal_keeps_the_resident_leaf(seed_dir, tmp_path):
    """Rot under a resident leaf: the heal re-snapshots from the live
    bitmap under the fragment lock and leaves the device alone, so the
    next Count is served from the same tensor (the cache's hits and
    misses move as the reference's cache's do, no miss), and the heal's
    snapshot plus the WAL hold every write: one made before it, and one
    racing it that waits on the fragment lock."""
    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    jcache = jres.DeviceRowCache(1 << 30)
    old = jres.global_row_cache()
    jres.set_global_row_cache(jcache)
    jh = jstorage.Holder(str(jdir)).open()
    ph = Holder(str(pdir), device="cpu").open()
    try:
        q = "Count(Intersect(Row(f=1), Row(g=7)))"
        jex, pex = JExecutor(jh), Executor(ph, device="cpu")
        for ex, to_json in ((jex, j_result_to_json), (pex, result_to_json)):
            ex.execute("i", "Set(5, f=1)")
            to_json(ex.execute("i", q))
        jh.wal.barrier()
        ph.wal.barrier()
        key = next(k for k in ph.cache._rows
                   if k[0] == "stack" and k[3] == "f")
        leaf = ph.cache._rows[key]
        before = (ph.cache.metrics(), jcache.metrics())
        racer = {}
        frag = ph.index("i").field("f").view("standard").fragment(0)
        real_snapshot = frag.snapshot

        def snapshot_with_a_racing_write():
            # the heal holds the fragment lock: this Set waits on it and
            # lands after the snapshot, in the WAL
            racer["t"] = threading.Thread(
                target=lambda: racer.setdefault(
                    "r", pex.execute("i", "Set(9, f=1)")))
            racer["t"].start()
            real_snapshot()

        frag.snapshot = snapshot_with_a_racing_write
        recs = []
        for h, root, scrubber in ((jh, jdir, JScrubber(jh)),
                                  (ph, pdir, Scrubber(ph))):
            p = _frag_path(root, "f", 0)
            _flip(p, os.path.getsize(p) - 3)
            recs.append(_pass(scrubber.scrub_pass()))
        racer["t"].join(30)
        assert not racer["t"].is_alive() and racer["r"] == [True]
        del frag.snapshot
        assert recs[0] == recs[1] and recs[1]["self_healed"] == 1
        jex.execute("i", "Set(9, f=1)")
        want = j_result_to_json(jex.execute("i", q))
        got = result_to_json(pex.execute("i", q))
        assert got == want
        after = (ph.cache.metrics(), jcache.metrics())
        assert ph.cache._rows[key] is leaf
        for k in ("residency_misses", "residency_hits"):
            assert after[0][k] - before[0][k] == after[1][k] - before[1][k]
        assert after[0]["residency_misses"] == before[0]["residency_misses"]
        # the healed file holds Set(5); Set(9) waits in the WAL
        healed = Fragment(_frag_path(pdir, "f", 0), "i", "f", "standard", 0,
                          verify_on_load=True).open()
        assert healed.contains(1, 5) and not healed.contains(1, 9)
        healed.close(discard=True)
        ph.wal.barrier()
        shutil.copytree(pdir, tmp_path / "crash")  # a crash now
        crashed = Holder(str(tmp_path / "crash"), device="cpu").open()
        try:
            assert result_to_json(Executor(crashed, device="cpu").execute(
                "i", "Row(f=1)"))[0]["columns"][:3] == \
                j_result_to_json(jex.execute("i", "Row(f=1)"))[0][
                    "columns"][:3]
            assert crashed.index("i").field("f").view("standard").fragment(
                0).contains(1, 9)
        finally:
            crashed.close()
    finally:
        jh.close()
        ph.close()
        jres.set_global_row_cache(old)


# -------------------------------------------------- degraded over HTTP


def _request(base, method, path, body=None):
    r = urllib.request.Request(base + path, data=body, method=method)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.headers.get("Retry-After"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), e.read()


class _Pair:
    """A reference server and a port server (CPU) on copies of one dir."""

    def __init__(self, seed, tmp_path):
        self.jdir, self.pdir = _copies(seed, tmp_path, "jax", "port")
        self.jh = jstorage.Holder(str(self.jdir)).open()
        self.japi = JAPI(self.jh)
        self.jserver, jport, _ = j_serve_in_thread(self.japi)
        self.server = Server(str(self.pdir), port=0, device="cpu").open()
        self.bases = {"jax": f"http://localhost:{jport}",
                      "port": f"http://localhost:{self.server.port}"}
        self.holders = {"jax": self.jh, "port": self.server.holder}
        self.roots = {"jax": str(self.jdir), "port": str(self.pdir)}

    def both(self, method, path, body=None):
        """The same request to both; each answer with its data dir's
        path written as <dir>."""
        out = {}
        for pkg, base in self.bases.items():
            status, retry, raw = _request(base, method, path, body)
            out[pkg] = (status, retry,
                        raw.decode().replace(self.roots[pkg], "<dir>"))
        assert out["port"] == out["jax"], (method, path, body)
        return out["port"]

    def close(self):
        self.jserver.shutdown()
        self.jserver.server_close()
        self.jh.close()
        self.server.close()


def _wait_healthy(holders, degraded: bool) -> None:
    """The health probe's wait: until every latch reads ``degraded``."""
    deadline = time.monotonic() + 10
    while any(h.health.degraded != degraded for h in holders):
        assert time.monotonic() < deadline, "probe did not settle"
        time.sleep(PROBE_S / 2)


def _hold_wal_fault_until_barrier_waits(plane, wal):
    """Make a WAL group's fsync fault fire only once a write's ACK
    barrier waits on the WAL's condition. A barrier that arrives after
    its group already failed answers "this write's group was lost"; one
    that waits answers the fsync's own error. Which one a write meets
    depends on thread timing (in the reference the commit loop wakes
    the waiters before it trips the latch), so under load the two
    packages could answer different 500 bodies. Returns the undo."""
    real = plane.check

    def check(op, path):
        if op == "fsync" and f"{os.sep}.wal{os.sep}" in path:
            deadline = time.monotonic() + 30
            while not wal._cond._waiters:
                assert time.monotonic() < deadline, "no barrier waited"
                time.sleep(0.001)
        return real(op, path)

    plane.check = check
    return lambda: vars(plane).pop("check", None)


def test_enospc_on_the_wal_over_http_matches_reference(seed_dir, tmp_path):
    """C7 and C8: an fsync ENOSPC on the WAL fails the write whose group
    it hit (500, the reference's body), trips the latch (/status says so,
    with the reason), sheds every later write, import and schema write
    with 503 and Retry-After while reads answer; when the rule goes the
    probe clears it, writes resume, the counters show one trip and one
    recovery, and the lost group's barrier still raises."""
    pair = _Pair(seed_dir, tmp_path)
    try:
        pair.both("POST", "/index/i/query", b"Set(1, f=9)")
        rules = {}
        for pkg, mod in (("jax", jfaults), ("port", faults)):
            rules[pkg] = (mod.install_disk(), None)
            rules[pkg] = (rules[pkg][0], rules[pkg][0].add(
                "fsync", path=pair.roots[pkg], errno_=errno.ENOSPC))
        # the first op after Set(1) opens the group the fault hits (a
        # request's ops may span two groups, the later one committed
        # after the recovery)
        lost = {pkg: h.wal.current_seq() + 1
                for pkg, h in pair.holders.items()}
        undo = [_hold_wal_fault_until_barrier_waits(
            rules[pkg][0], pair.holders[pkg].wal) for pkg in rules]
        try:
            status, _, body = pair.both("POST", "/index/i/query",
                                        b"Set(2, f=9)")
        finally:
            for fn in undo:
                fn()
        assert status == 500 and "No space left" in body
        _wait_healthy(pair.holders.values(), True)
        st = json.loads(pair.both("GET", "/status")[2])
        assert st["storageDegraded"] is True
        assert "No space left" in st["storageDegradedReason"]
        for method, path, body in (
                ("POST", "/index/i/query", b"Set(3, f=9)"),
                ("POST", "/index/i/query", b"Set(4, f=9) Count(Row(f=9))"),
                ("POST", "/index/j", b"{}"),
                ("POST", "/index/i/field/h", b"{}"),
                ("POST", "/index/nope/field/h", b"{}"),
                ("POST", "/index/i/field/f/import",
                 b'{"rows": [9], "columns": [3]}'),
                ("POST", "/index/i/field/fare/import-value",
                 b'{"columns": [3], "values": [4]}')):
            status, retry, _ = pair.both(method, path, body)
            assert (status, retry) == (503, "5"), path
        for pql in (b"Row(f=9)", b"Count(Row(f=1))", b"TopN(f, n=2)"):
            assert pair.both("POST", "/index/i/query", pql)[0] == 200
        for pkg, (plane, rule) in rules.items():
            plane.remove(rule.id)
        _wait_healthy(pair.holders.values(), False)
        assert json.loads(pair.both("GET", "/status")[2])[
            "storageDegraded"] is False
        assert pair.both("POST", "/index/i/query", b"Set(5, f=9)")[2] == \
            '{"results":[true]}'
        assert pair.both("POST", "/index/i/query", b"Row(f=9)")[2] == \
            '{"results":[{"attrs":{},"columns":[1,2,5]}]}'
        jm = pair.japi.integrity_metrics()
        pm = pair.server.api.integrity_metrics()
        assert sorted(pm) == sorted(jm)
        for k in pm:
            if k.startswith(("storage_", "scrub_")):
                assert pm[k] == jm[k], k
        assert (pm["storage_degraded"], pm["storage_degraded_total"],
                pm["storage_recoveries_total"]) == (0, 1, 1)
        assert pair.server.holder.wal.metrics()[
            "commit_recoveries_total"] == 1
        for pkg, h in pair.holders.items():
            with pytest.raises(OSError, match="wal commit failed"):
                h.wal.barrier(lost[pkg])
    finally:
        pair.close()
    # the lost write was applied in memory and snapshotted at the clean
    # close in both packages: it reads back after the restart
    jh = jstorage.Holder(str(pair.jdir)).open()
    ph = Holder(str(pair.pdir), device="cpu").open()
    try:
        want = j_result_to_json(JExecutor(jh).execute("i", "Row(f=9)"))
        assert result_to_json(Executor(ph, device="cpu").execute(
            "i", "Row(f=9)")) == want
    finally:
        jh.close()
        ph.close()


def test_refused_write_patches_nothing_on_the_device(seed_dir, tmp_path,
                                                    monkeypatch):
    """Shed before the card: while degraded, a refused Set and import
    never reach the executor, so no patch is issued and the resident
    leaf's words stay as they were; the write whose group failed had
    patched the leaf, as the reference served it."""
    (pdir,) = _copies(seed_dir, tmp_path, "port")
    calls = []
    real = pkernels.word_patch_batch
    monkeypatch.setattr(pkernels, "word_patch_batch",
                        lambda targets: calls.append(len(targets))
                        or real(targets))
    h = Holder(str(pdir), device="cpu").open()
    api = API(h)
    try:
        assert api.query_raw("i", "Count(Row(f=1))")[0] > 0
        key = next(k for k in h.cache._rows if k[0] == "stack")
        plane = faults.install_disk()
        rule = plane.add("fsync", path=str(pdir), errno_=errno.ENOSPC)
        # the fault fires once Set(3)'s barrier waits, so the write meets
        # the fsync's own error, not "this write's group was lost"
        undo = _hold_wal_fault_until_barrier_waits(plane, h.wal)
        try:
            with pytest.raises(OSError, match="No space left"):
                api.query_raw("i", "Set(3, f=1)")
        finally:
            undo()
        # the waiters wake before the latch trips: wait for the trip
        _wait_healthy([h], True)
        assert calls == [1] and h.health.degraded
        words = h.cache._rows[key].clone()
        for write in (lambda: api.query_raw("i", "Set(4, f=1)"),
                      lambda: api.import_bits("i", "f", [1], [6]),
                      lambda: api.create_field("i", "h")):
            with pytest.raises(Exception) as err:
                write()
            assert getattr(err.value, "status", None) == 503
            assert err.value.retry_after == 5.0
        assert calls == [1]
        assert torch.equal(h.cache._rows[key], words)
        plane.remove(rule.id)
        _wait_healthy([h], False)
        assert api.query_raw("i", "Set(4, f=1)") == [True]
        assert calls == [1, 1]
    finally:
        h.close()


def test_failed_group_never_acks_in_either_package(tmp_path):
    """The lost group's barrier raises forever: clearing the fault and
    committing newer groups past it does not turn it into a late ACK;
    the commit loop resumes in a fresh segment."""
    outcomes = {}
    for pkg, holder_cls, mod in (
            ("jax", jstorage.Holder, jfaults),
            ("port", lambda d: Holder(d, device="cpu"), faults)):
        h = holder_cls(str(tmp_path / pkg)).open()
        try:
            frag = h.create_index("i").create_field("f").view(
                "standard", create=True).fragment(0, create=True)
            frag.set_bit(1, 1)
            h.wal.barrier()
            plane = mod.install_disk()
            rule = plane.add("fsync", path=h.data_dir, errno_=errno.ENOSPC)
            frag.set_bit(1, 2)
            lost = h.wal.current_seq()
            with pytest.raises(OSError, match="wal commit failed") as e1:
                h.wal.barrier(lost)
            with pytest.raises(OSError, match="wal commit failed"):
                frag.set_bit(1, 3)  # the loop is parked: refused
            # the reference's commit loop wakes the waiters before it
            # trips the latch: wait for the trip, or the wait for the
            # clear below could return before the fault was ever latched
            _wait_healthy([h], True)
            plane.remove(rule.id)
            _wait_healthy([h], False)
            frag.set_bit(1, 4)
            h.wal.barrier()
            with pytest.raises(OSError, match="group was lost") as e2:
                h.wal.barrier(lost)
            segments = sorted(os.listdir(os.path.join(h.data_dir, ".wal")))
            outcomes[pkg] = (str(e1.value).replace(h.data_dir, "<dir>"),
                             str(e2.value), segments,
                             _ids(frag.bitmap), h.health.metrics())
        finally:
            mod.clear_disk()
            h.close()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][2] == ["00000001.log", "00000002.log"]


def _trip_snapshot(h, mod):
    frag = h.index("i").field("f").view("standard").fragment(0)
    plane = mod.install_disk()
    plane.add("fsync", path=frag.path, errno_=errno.ENOSPC, count=1)
    with pytest.raises(OSError):
        frag.snapshot()


def _trip_torn_snapshot(h, mod):
    """A torn write: the snapshot's payload cut short lands, and the
    next open quarantines it."""
    frag = h.index("i").field("f").view("standard").fragment(0)
    plane = mod.install_disk()
    plane.add("write", path=frag.path, truncate_to=30, count=1)
    frag.snapshot()


def _trip_meta(h, mod):
    plane = mod.install_disk()
    plane.add("write", path=".meta", errno_=errno.ENOSPC, count=1)
    with pytest.raises(OSError):
        h.index("i").create_field("h")


def _trip_meta_fsync(h, mod):
    plane = mod.install_disk()
    plane.add("fsync", path=".meta", errno_=errno.ENOSPC, count=1)
    with pytest.raises(OSError):
        h.create_index("j")


TRIPS = {"snapshot": _trip_snapshot, "torn_snapshot": _trip_torn_snapshot,
         "field_meta": _trip_meta, "index_meta_fsync": _trip_meta_fsync}


@pytest.mark.parametrize("case", sorted(TRIPS))
def test_snapshot_and_meta_faults_trip_as_the_reference(seed_dir, tmp_path,
                                                        case):
    """A failed snapshot fsync and a failed .meta write or fsync trip the
    latch with the reference's reason; a torn snapshot write does not
    trip (the bytes landed) but the next open quarantines it."""
    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    integrity.StorageHealth.PROBE_INTERVAL_S = 30.0  # no clear mid-test
    jintegrity.StorageHealth.PROBE_INTERVAL_S = 30.0
    out = {}
    for pkg, root, holder_cls, mod in (
            ("jax", jdir, jstorage.Holder, jfaults),
            ("port", pdir, lambda d: Holder(d, device="cpu"), faults)):
        h = holder_cls(str(root)).open()
        try:
            TRIPS[case](h, mod)
            out[pkg] = (h.health.degraded,
                        h.health.reason.replace(str(root), "<dir>"))
        finally:
            mod.clear_disk()
            h.close()
        h = holder_cls(str(root)).open()
        try:
            out[pkg] += (_quarantine_files(root),)
        finally:
            h.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == (case != "torn_snapshot")


def test_per_op_fsync_fault_trips_as_the_reference(seed_dir, tmp_path):
    """In per-op durability a failed fsync of a fragment's own file
    raises out of the write and trips the latch; the probe clears it
    once the rule goes (no WAL segment to reopen)."""
    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    out = {}
    for pkg, root, holder_cls, mod in (
            ("jax", jdir, jstorage.Holder, jfaults),
            ("port", pdir, lambda d, **kw: Holder(d, device="cpu", **kw),
             faults)):
        h = holder_cls(str(root), durability_mode="per-op").open()
        try:
            frag = h.index("i").field("f").view("standard").fragment(0)
            plane = mod.install_disk()
            rule = plane.add("fsync", path=frag.path, errno_=errno.EIO)
            with pytest.raises(OSError) as err:
                frag.set_bit(9, 9)
            out[pkg] = [str(err.value).replace(str(root), "<dir>"),
                        h.health.reason.replace(str(root), "<dir>")]
            plane.remove(rule.id)
            _wait_healthy([h], False)
            frag.set_bit(9, 10)
            out[pkg] += [h.health.metrics(), frag.contains(9, 9),
                         frag.contains(9, 10)]
        finally:
            mod.clear_disk()
            h.close()
    assert out["port"] == out["jax"]
    assert "per-op fsync" in out["port"][1]


def test_failed_sidecar_write_never_condemns_the_snapshot(seed_dir,
                                                          tmp_path,
                                                          monkeypatch):
    """The old sidecar goes before the new snapshot is published, so a
    failed sidecar write leaves none: the latch trips, and the next open
    is an unverified load of the healthy file, not a quarantine."""
    import pilosa_tpu.storage.fragment as jfrag_mod

    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    integrity.StorageHealth.PROBE_INTERVAL_S = 30.0
    jintegrity.StorageHealth.PROBE_INTERVAL_S = 30.0

    def broken(path, blocks):
        raise OSError(errno.ENOSPC, "No space left on device", path)

    out = {}
    for pkg, root, holder_cls, mod in (
            ("jax", jdir, jstorage.Holder, jfrag_mod),
            ("port", pdir, lambda d: Holder(d, device="cpu"), frag_mod)):
        h = holder_cls(str(root)).open()
        try:
            frag = h.index("i").field("f").view("standard").fragment(0)
            frag.set_bit(9, 9)
            with monkeypatch.context() as m:
                m.setattr(mod, "save_checksums", broken)
                frag.snapshot()
            out[pkg] = [h.health.reason.replace(str(root), "<dir>"),
                        os.path.exists(frag.path + ".checksums")]
        finally:
            h.close()
        h = holder_cls(str(root)).open()
        try:
            out[pkg] += [h.index("i").field("f").view("standard").fragment(
                0).contains(9, 9), _quarantine_files(root)]
        finally:
            h.close()
    assert out["port"] == out["jax"]
    assert out["port"][1:] == [False, True, []]


# ------------------------------------------------------------------ CLI


def _cli(main, argv, capsys, root=None) -> tuple:
    """Exit code, stdout and stderr of a CLI run, ``root`` as <dir>."""
    rc = main(argv)
    cap = capsys.readouterr()
    if root is None:
        return rc, cap.out, cap.err
    return (rc, cap.out.replace(str(root), "<dir>"),
            cap.err.replace(str(root), "<dir>"))


@pytest.mark.parametrize("state", ["clean", "corrupt", "quarantined"])
def test_offline_check_matches_reference(seed_dir, tmp_path, capsys, state):
    """``check -d``: the reference's ok:, CORRUPT: and QUARANTINED:
    lines and exit code, paths aside."""
    from pilosa_tpu.cli import main as jmain

    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    for root, holder_cls in ((jdir, jstorage.Holder),
                             (pdir, lambda d: Holder(d, device="cpu"))):
        if state != "clean":
            _rot(root)
        if state == "quarantined":
            holder_cls(str(root)).open().close()
    want = _cli(jmain, ["check", "-d", str(jdir)], capsys, jdir)
    got = _cli(cli.main, ["check", "-d", str(pdir)], capsys, pdir)
    assert got == want
    assert got[0] == (0 if state == "clean" else 1)
    # the fragments of _exists, f, g and fare's bsig view
    assert got[1].count("ok: ") == 4 * SHARDS - (0 if state == "clean"
                                                 else 3)
    assert got[2].count("QUARANTINED: ") == (3 if state == "quarantined"
                                              else 0)
    assert got[2].count("CORRUPT: ") == (3 if state == "corrupt" else 0)


def test_check_without_a_target_matches_reference(capsys):
    from pilosa_tpu.cli import main as jmain

    assert _cli(cli.main, ["check"], capsys) == \
        _cli(jmain, ["check"], capsys) == \
        (1, "", "error: check needs -d/--data-dir or --host\n")


def test_live_check_matches_reference(seed_dir, tmp_path, capsys):
    """``check --host``: one scrub pass on the live node through POST
    /internal/scrub, the same line and exit code, a second pass clean."""
    from pilosa_tpu.cli import main as jmain

    pair = _Pair(seed_dir, tmp_path)
    try:
        for root in pair.roots.values():
            p = _frag_path(root, "g", 1)
            _flip(p, os.path.getsize(p) - 3)
        lines = []
        for _ in range(2):
            want = _cli(jmain, ["check", "--host", pair.bases["jax"]],
                        capsys)
            got = _cli(cli.main, ["check", "--host", pair.bases["port"]],
                       capsys)
            assert got == want
            lines.append(got)
        assert lines[0][0] == lines[1][0] == 0
        assert "corrupt=1" in lines[0][1] and "self_healed=1" in lines[0][1]
        assert "corrupt=0" in lines[1][1]
        recs = [_request(base, "POST", "/internal/scrub", b"")
                for base in pair.bases.values()]
        assert recs[0][:2] == recs[1][:2] == (200, None)
        assert _pass(json.loads(recs[0][2])) == _pass(json.loads(recs[1][2]))
        assert json.loads(recs[1][2])["corrupt"] == 0
    finally:
        pair.close()


# ------------------------------------------------- knobs, counters, pacer


def test_server_knobs_round_trip_as_the_reference(tmp_path):
    from pilosa_tpu.server import ServerConfig

    raw = {"verify-on-load": "false", "scrub-interval": "1m30s",
           "scrub_max_bytes_per_sec": "1048576",
           "residency-promote-interval": "500ms",
           "durability-mode": "per-op", "group-commit-max-ops": "64"}
    want = ServerConfig.from_dict(raw).to_dict()
    kwargs = config_from_dict(raw)
    assert kwargs["scrub_interval"] == 90.0
    assert kwargs["scrub_max_bytes_per_sec"] == 1 << 20
    server = Server(str(tmp_path / "d"), port=0, device="cpu", **kwargs)
    got = server.config()
    assert got == {k: want[k] for k in got}
    assert Server(str(tmp_path / "e"), device="cpu").config() == {
        k: ServerConfig().to_dict()[k] for k in got}
    toml = tmp_path / "c.toml"
    toml.write_text('scrub-interval = "90s"\nscrub-max-bytes-per-sec = 4096\n'
                    "verify-on-load = false\n")
    assert config_from_toml(str(toml)) == {"scrub_interval": 90.0,
                                           "scrub_max_bytes_per_sec": 4096,
                                           "verify_on_load": False}
    for bad in ({"scrub_interval": -1},):
        with pytest.raises(ValueError, match="scrub-interval") as e:
            Server(str(tmp_path / "f"), device="cpu", **bad)
        with pytest.raises(ValueError) as je:
            ServerConfig(**bad)
        assert str(e.value) == str(je.value)


def test_cli_server_reads_toml_knobs_and_flags_override(tmp_path,
                                                       monkeypatch):
    """``server -c FILE`` takes the file's knobs under the reference's
    names; a flag given on the command line wins."""
    seen = {}
    monkeypatch.setattr(cli, "cmd_server", lambda args: seen.update(
        vars(args)) or 0)
    toml = tmp_path / "node.toml"
    toml.write_text('scrub-interval = "1m"\nscrub-max-bytes-per-sec = 4096\n'
                    'verify-on-load = false\ndurability-mode = "per-op"\n')
    assert cli.main(["server", "-d", str(tmp_path / "d"), "-c", str(toml),
                     "--scrub-max-bytes-per-sec", "7"]) == 0
    assert (seen["scrub_interval"], seen["scrub_max_bytes_per_sec"],
            seen["verify_on_load"], seen["durability_mode"]) == \
        (60.0, 7, False, "per-op")
    seen.clear()
    assert cli.main(["server", "-d", str(tmp_path / "d")]) == 0
    assert (seen["scrub_interval"], seen["scrub_max_bytes_per_sec"],
            seen["verify_on_load"]) == (0.0, 0, True)


def test_scrub_ticker_runs_with_the_server_and_stops_first(seed_dir,
                                                          tmp_path):
    """scrub-interval > 0 starts a ticker at open that heals rot on its
    own; the close stops it before the holder closes."""
    (pdir,) = _copies(seed_dir, tmp_path, "port")
    server = Server(str(pdir), port=0, device="cpu", scrub_interval=0.05,
                    scrub_max_bytes_per_sec=1 << 30).open()
    try:
        scrubber = server.api.scrubber
        assert scrubber is not None and scrubber._thread.is_alive()
        p = _frag_path(pdir, "f", 2)
        _flip(p, os.path.getsize(p) - 3)
        deadline = time.monotonic() + 10
        while scrubber.self_healed == 0:
            assert time.monotonic() < deadline
            time.sleep(0.05)  # the ticker's interval
    finally:
        server.close()
    assert not scrubber._thread.is_alive()
    server = Server(str(tmp_path / "none"), port=0, device="cpu").open()
    try:
        assert server.api.scrubber is None
    finally:
        server.close()


def test_integrity_metrics_match_reference(seed_dir, tmp_path):
    """Every key of the reference's integrity series, the latch's and
    the scrubber's values equal on fresh nodes and after a pass."""
    jdir, pdir = _copies(seed_dir, tmp_path, "jax", "port")
    jh = jstorage.Holder(str(jdir)).open()
    ph = Holder(str(pdir), device="cpu").open()
    try:
        japi, papi = JAPI(jh), API(ph)
        for step in range(2):
            jm, pm = japi.integrity_metrics(), papi.integrity_metrics()
            assert sorted(pm) == sorted(jm)
            for k in pm:
                if k.startswith(("storage_", "scrub_")) and \
                        k != "scrub_last_pass_seconds":
                    assert pm[k] == jm[k], (step, k)
            assert _pass(papi.scrub_now()) == _pass(japi.scrub_now())
        assert pm["scrub_passes_total"] == 1
    finally:
        jh.close()
        ph.close()


def test_repair_pacer_matches_reference(monkeypatch):
    """The same bucket on one fake clock: the same sleeps, totals and
    slot bound."""
    import pilosa_tpu.parallel.pacer as jpacer

    clock = {"t": 100.0}
    slept = {"jax": [], "port": []}
    current = {"pkg": "jax"}
    # one time module serves both pacers: patched once, recording per package
    monkeypatch.setattr(jpacer.time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(jpacer.time, "sleep",
                        lambda s: slept[current["pkg"]].append(s))
    assert ppacer.time is jpacer.time
    out = {}
    for pkg, cls in (("jax", JRepairPacer), ("port", RepairPacer)):
        current["pkg"] = pkg
        clock["t"] = 100.0
        p = cls(max_bytes_per_sec=100_000, max_inflight=2)
        waits = []
        for n, dt in ((50_000, 0.0), (80_000, 0.1), (0, 0.0), (200_000, 0.5),
                      (10, 3.0)):
            clock["t"] += dt
            waits.append(p.consume(n))
        unpaced = cls()
        with p.slot(), p.slot():
            busy = not p._sem.acquire(blocking=False)
        out[pkg] = (waits, p.paced_sleep_s, p.bytes_consumed, busy,
                    unpaced.consume(1 << 30), unpaced.bytes_consumed)
    assert out["port"] == out["jax"]
    assert slept["port"] == slept["jax"] and len(slept["port"]) == 2


def test_disk_fault_plane_matches_reference():
    """The same rules give the same errors, flips, truncations, counts
    and JSON."""
    out = {}
    for pkg, mod in (("jax", jfaults), ("port", faults)):
        assert mod.disk_active() is None
        plane = mod.install_disk()
        plane.add("fsync", path="a/", errno_=errno.EIO, count=1)
        plane.add("read", path="b", flip_offset=-1, flip_mask=0x81)
        plane.add("write", truncate_to=2)
        res = []
        for op, path in (("fsync", "x/a/1"), ("fsync", "x/a/1"),
                         ("write", "a/1")):
            try:
                mod.disk_check(op, path)
                res.append("ok")
            except OSError as e:
                res.append((e.errno, str(e)))
        res.append(mod.disk_filter_read("b1", b"\x00\x01\x02"))
        res.append(mod.disk_filter_read("c", b"\x00"))
        res.append(mod.disk_filter_write("c", b"abcdef"))
        snap = plane.snapshot()
        for r in snap["rules"]:
            r.pop("id")
        res.append(snap)
        with pytest.raises(ValueError) as e:
            plane.add("chmod", errno_=1)
        res.append(str(e.value))
        mod.clear_disk()
        res.append(mod.disk_filter_write("c", b"abc"))
        out[pkg] = res
    assert out["port"] == out["jax"]

"""The executor's operand memo and the residency generation against the
reference's, on copies of one small data directory.

A repeated (plan, shard block) assembly is served from the memo until the
row cache's generation moves; the generation moves wherever the
reference's does: a write patch (``apply_write``), ``invalidate``, the
two demotions of ``_demote_matching_locked`` (a dense and a compressed
entry), ``clear`` and the two evictions of ``_evict`` (a dense entry and
a compressed one). One scenario drives each of those sites between
repeated Counts in both packages: the memo's hit/miss sequence, the
answers and the bump sites seen must be the reference's, and the memo is
empty right after every bump.
"""

import shutil
import sys

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.residency as jres
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.storage import Holder

torch.set_num_threads(1)

# one dense [2, 32768] leaf (256 KiB) and two compressed copies of two
# 4 KiB blocks (8200 bytes with their index) fit: a second dense leaf
# compresses the first, a third compressed copy is dropped
BUDGET = 262_144 + 2 * 8_200 + 1_000
ROWS = 6


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    """Rows 1..ROWS of field f over shards 0 and 1, their bits in the
    first 4096 columns of each shard (one of a shard's 32 blocks: every
    leaf compresses)."""
    root = tmp_path_factory.mktemp("memo") / "seed"
    h = jstorage.Holder(str(root)).open()
    try:
        field = h.create_index("i").create_field("f")
        rng = np.random.default_rng(3)
        for shard in (0, 1):
            frag = field.view("standard", create=True).fragment(
                shard, create=True)
            rows = np.repeat(np.arange(1, ROWS + 1), 300).astype(np.uint64)
            cols = rng.integers(0, 4096, rows.size).astype(np.uint64)
            frag.bulk_import(rows, cols)
    finally:
        h.close()
    return root


def _scenario(ex, cache, scope, log):
    """The steps: each an action, then Counts; ``log`` gets (step, hit)
    for every operand assembly. Returns the answers."""
    out = []

    def count(row, n=2):
        for _ in range(n):
            out.append(ex.execute("i", f"Count(Row(f={row}))")[0])

    log.append(("warm", None))
    count(1)
    log.append(("write", None))
    out.append(ex.execute("i", "Set(4000, f=1)")[0])
    count(1)
    log.append(("invalidate", None))
    key = next(k for k in list(cache._rows) if k[0] == "stack")
    cache.invalidate(key)
    count(1)
    log.append(("demote dense", None))
    cache.demote_field_stacks_to_host(scope, "i", "f")
    count(1)
    log.append(("evict", None))
    for row in range(2, ROWS + 1):
        count(row, 1)
    count(1)
    log.append(("demote compressed", None))
    cache.demote_field_stacks_to_host(scope, "i", "f")
    count(1)
    count(ROWS, 1)
    log.append(("clear", None))
    cache.clear()
    count(1)
    return out


def _spy(ex, cache, log, sites):
    """Record each assembly's memo verdict, and each generation bump's
    site, checking the memo is empty right after it."""
    real_note = ex._note_operands

    def note(*a, **k):
        log.append(("hit", bool(k.get("memo_hit", False))))
        return real_note(*a, **k)

    ex._note_operands = note
    real_bump = cache._bump_generation

    def bump():
        frame = sys._getframe(1)
        sites.add((frame.f_code.co_name, frame.f_lineno))
        real_bump()
        assert ex._operand_memo == {}

    cache._bump_generation = bump


def test_memo_hits_and_clears_as_the_reference(seed_dir, tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(seed_dir, jdir)
    shutil.copytree(seed_dir, pdir)
    old = jres.global_row_cache()
    jres.set_global_row_cache(jres.DeviceRowCache(BUDGET))
    jh = jstorage.Holder(str(jdir)).open()
    ph = Holder(str(pdir), device="cpu", budget_bytes=BUDGET).open()
    try:
        runs = {}
        for pkg, ex, cache, h in (
                ("jax", JExecutor(jh), jres.global_row_cache(), jh),
                ("port", Executor(ph, device="cpu"), ph.cache, ph)):
            log, sites = [], set()
            _spy(ex, cache, log, sites)
            gen0 = cache.generation
            answers = _scenario(ex, cache, h.index("i").scope, log)
            names = sorted({name for name, _ in sites})
            lines = {name: len({ln for n, ln in sites if n == name})
                     for name in names}
            runs[pkg] = (answers, log, names, lines, cache.generation > gen0,
                         cache.metrics())
        assert runs["port"][:5] == runs["jax"][:5]
        answers, log, names, lines, moved, metrics = runs["port"]
        # every one of the seven sites bumped: two lines each for the
        # demotion and the eviction
        assert names == ["_demote_matching_locked", "_evict", "apply_write",
                         "clear", "invalidate"]
        assert lines == {"_demote_matching_locked": 2, "_evict": 2,
                         "apply_write": 1, "clear": 1, "invalidate": 1}
        assert moved and metrics["residency_evictions"] > 0
        assert metrics["residency_compressions"] > 0
        # after each bump site the next Count re-resolves its leaves and
        # the one after it is served from the memo
        steps: dict = {}
        step = None
        for kind, hit in log:
            if hit is None:
                step = kind
                continue
            steps.setdefault(step, []).append(hit)
        for step in ("warm", "write", "invalidate", "demote dense",
                     "clear"):
            assert steps[step][:2] == [False, True], step
        # the Set's bit reads back, from the memo too
        assert answers[2] is True
        assert answers[3] == answers[4] == answers[0] + 1
    finally:
        jh.close()
        ph.close()
        jres.set_global_row_cache(old)


def test_memo_under_concurrent_reads_and_writes(seed_dir, tmp_path):
    """More reader threads than cores Count a row from the memo while a
    writer sets new bits in it, one acknowledged Set at a time, with the
    interpreter switching threads every few microseconds: a Count that
    starts after a Set returned must see that bit (a memo entry served
    past its generation would not), and none sees a bit not yet set."""
    import threading
    import time

    shutil.copytree(seed_dir, tmp_path / "d")
    h = Holder(str(tmp_path / "d"), device="cpu").open()
    ex = Executor(h, device="cpu")
    q = "Count(Row(f=1))"
    base = ex.execute("i", q)[0]
    cols = [5000 + 7 * k for k in range(40)]  # outside the seeded columns
    acked = [0]  # Sets acknowledged so far
    stop = threading.Event()
    errors: list = []

    def reader():
        try:
            while not stop.is_set():
                low = acked[0]
                got = ex.execute("i", q)[0]
                if not base + low <= got <= base + len(cols):
                    errors.append((low, got))
        except Exception as e:  # recorded, then the test fails on it
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(12)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        for k, col in enumerate(cols, 1):
            assert ex.execute("i", f"Set({col}, f=1)") == [True]
            acked[0] = k
            assert time.monotonic() < deadline
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        h.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert ex.memo_hits > 0 and ex.memo_misses >= len(cols)

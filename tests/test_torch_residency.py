"""Residency tiers, heat and tiering: the port against pilosa_tpu on the CPU.

Kernel level: K10's and K11's plain versions (the wrappers on CPU
tensors) against the reference's jitted ``_gather_blocks`` and
``_scatter_blocks``. Cache level: the reference's residency tests and
its tiering tests, each scenario run through both packages' caches,
giving equal arrays, equal ``metrics()`` and equal ``tier_overlay()``.
Heat: the reference's unit tests with the clock of both modules
replaced. Server level: a server of each package on copies of one
8-shard data dir with a small budget, equal answers and tier counters.
Inputs are numpy words from a seed; tolerance 0 throughout (integers).

These files share test workers with timing-sensitive reference tests,
so nothing here sleeps, shapes stay at 8 shards and 8 rows, torch runs
one thread, and only the server-wiring test starts a tierer thread.
"""

import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pilosa_tpu.storage as jstorage
import pilosa_tpu.storage.heat as jheat
import pilosa_tpu.storage.residency as jres
import pilosa_tpu.storage.tiering as jtier
import pilosa_tpu_torch.storage.heat as pheat
import pilosa_tpu_torch.storage.residency as pres
import pilosa_tpu_torch.storage.tiering as ptier
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.result import result_to_json as j_result_to_json
from pilosa_tpu.server.api import API as JAPI
from pilosa_tpu.server.http import serve_in_thread as j_serve_in_thread
from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.executor import Executor, result_to_json
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage import Holder, load_from_dense

torch.set_num_threads(1)

W = 32768
BW = pres.COMPRESS_BLOCK_WORDS
ROW_BYTES = pres.ROW_BYTES


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def sparse_row(rng, n_blocks_set, words: int = W) -> np.ndarray:
    """Dense uint32[words] with random data in n_blocks_set blocks."""
    row = np.zeros(words, np.uint32)
    for b in rng.choice(words // BW, n_blocks_set, replace=False):
        row[b * BW:(b + 1) * BW] = rng.integers(1, 1 << 32, BW,
                                                dtype=np.uint32)
    return row


# ------------------------------------------------------------- kernels


def _padded(block_idx: np.ndarray) -> np.ndarray:
    nb = len(block_idx)
    idx = np.full(max(1, 1 << max(nb - 1, 0).bit_length()),
                  block_idx[0] if nb else 0, np.int32)
    idx[:nb] = block_idx
    return idx


def _leaf(i: int) -> np.ndarray:
    """The kernel cases: a sparse [S, W] leaf, an all-zero leaf and an
    [R, S, W] matrix (R=3, S=4) with a block set in some rows."""
    rng = np.random.default_rng(60 + i)
    if i == 0:
        return np.stack([sparse_row(rng, k) for k in (3, 0, 7, 1)])
    if i == 1:
        return np.zeros((4, W), np.uint32)
    return np.stack([np.stack([sparse_row(rng, (r + s) % 3)
                               for s in range(4)]) for r in range(3)])


@pytest.mark.parametrize("i", range(3))
def test_block_gather_plain_matches_reference(i):
    """K10 against ``_gather_blocks``: padded by repeating the first real
    index (not sorted past the real prefix), as the caches pad."""
    host = _leaf(i)
    flat = host.reshape(-1)
    block_idx = np.flatnonzero(flat.reshape(-1, BW).any(axis=1)).astype(
        np.int32)
    idx = _padded(block_idx)
    want = np.asarray(jres._gather_blocks(flat, idx, BW))
    got = kernels.block_gather(_t(flat), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == (idx.size, BW)
    assert np.array_equal(_u(got), want)


@pytest.mark.parametrize("i", range(3))
def test_block_scatter_plain_matches_reference(i):
    """K11 against ``_scatter_blocks``: duplicate padding with identical
    blocks, an all-zero leaf (no real block), a matrix."""
    host = _leaf(i)
    flat = host.reshape(-1)
    n_blocks = flat.size // BW
    block_idx = np.flatnonzero(flat.reshape(-1, BW).any(axis=1)).astype(
        np.int32)
    idx = _padded(block_idx)
    blocks = flat.reshape(-1, BW)[idx]
    want = np.asarray(jres._scatter_blocks(blocks, idx, n_blocks, BW))
    got = kernels.block_scatter(_t(blocks), torch.from_numpy(idx), n_blocks,
                                block_idx)
    assert np.array_equal(_u(got), want)
    assert np.array_equal(want, flat)


def test_block_kernels_check_their_arguments():
    flat = torch.zeros(4 * BW, dtype=torch.int32)
    idx = torch.tensor([1, 3], dtype=torch.int32)
    blocks = kernels.block_gather(flat, idx)
    with pytest.raises(ValueError):
        kernels.block_gather(flat[:BW + 1], idx)
    with pytest.raises(ValueError):
        kernels.block_gather(flat, idx.long())
    with pytest.raises(ValueError, match="ascend"):
        kernels.block_scatter(blocks, idx, 4, np.array([3, 1], np.int32))
    with pytest.raises(ValueError, match="ascend"):
        kernels.block_scatter(blocks, idx, 3, np.array([1, 3], np.int32))
    with pytest.raises(ValueError):
        kernels.block_scatter(blocks[:1], idx, 4, np.array([1], np.int32))


def _batch_case(case: str) -> list:
    """Flat leaves of one K10 batch: mixed sizes (an [S, W] leaf, one row,
    an [R, S, W] matrix), an all-zero leaf among them, or a batch of
    one."""
    if case == "one":
        return [_leaf(0).reshape(-1)]
    if case == "zero":
        return [_leaf(1).reshape(-1), _leaf(0).reshape(-1)]
    rng = np.random.default_rng(64)
    return [_leaf(0).reshape(-1), sparse_row(rng, 5), _leaf(2).reshape(-1),
            sparse_row(rng, 1)]


def _block_index(flat: np.ndarray) -> np.ndarray:
    return np.flatnonzero(flat.reshape(-1, BW).any(axis=1)).astype(np.int32)


def _gather_outs(idxs, with_index: bool = True) -> list:
    """Per-leaf flat K10 outputs, the blocks then (``with_index``) the
    index copy, poisoned, so every word checked was written."""
    return [torch.full((i.size * (BW + with_index),), -7, dtype=torch.int32)
            for i in idxs]


@pytest.mark.parametrize("case", ["mixed", "zero", "one"])
def test_block_gather_batch_plain_matches_reference(case):
    """The batched K10's plain version, and the wrapper on CPU tensors,
    against ``_gather_blocks`` leaf by leaf: each leaf's padded index
    (duplicates past the real prefix), the plain rows concatenated in
    leaf order, the wrapper's in each leaf's own output with its index
    copy beside them."""
    flats = _batch_case(case)
    idxs = [_padded(_block_index(f)) for f in flats]
    want = [np.asarray(jres._gather_blocks(f, i, BW))
            for f, i in zip(flats, idxs)]
    plain = kernels.block_gather_batch_plain(
        [_t(f) for f in flats], [torch.from_numpy(i) for i in idxs])
    assert plain.dtype == torch.int32 and plain.shape == (
        sum(i.size for i in idxs), BW)
    outs = _gather_outs(idxs)
    kernels.block_gather_batch([_t(f) for f in flats], idxs, outs,
                               with_index=True)
    bare = _gather_outs(idxs, with_index=False)
    kernels.block_gather_batch([_t(f) for f in flats], idxs, bare)
    rows = 0
    for w, i, out, b in zip(want, idxs, outs, bare):
        assert np.array_equal(_u(plain[rows:rows + i.size]), w)
        assert np.array_equal(_u(out[:i.size * BW]).reshape(-1, BW), w)
        assert np.array_equal(out[i.size * BW:].numpy(), i)
        assert np.array_equal(_u(b).reshape(-1, BW), w)
        rows += i.size


@pytest.mark.parametrize("case", ["mixed", "zero", "one"])
def test_block_gather_table_layout(case):
    """The table the batched kernel reads (csrc/block_gather.cu): each
    leaf's address, block count, output and index copy (0 without one),
    the row starts, zero padding to a 16-byte offset, then the
    concatenated indices."""
    flats = [_t(f) for f in _batch_case(case)]
    idxs = [_padded(_block_index(_u(f))) for f in flats]
    n = len(flats)
    for with_index in (True, False):
        outs = _gather_outs(idxs, with_index)
        blob, offset = kernels._gather_table(flats, idxs, outs, with_index)
        assert offset % 16 == 0 and offset >= 36 * n + 4
        assert blob.size == offset + 4 * sum(i.size for i in idxs)
        leaves = blob[:32 * n].view(np.int64).reshape(n, 4)
        assert leaves.tolist() == [
            [f.data_ptr(), f.numel() // BW, o.data_ptr(),
             o[i.size * BW:].data_ptr() if with_index else 0]
            for f, o, i in zip(flats, outs, idxs)]
        assert list(blob[32 * n:36 * n + 4].view(np.int32)) == list(
            np.cumsum([0] + [i.size for i in idxs]))
        assert not blob[36 * n + 4:offset].any()
        assert np.array_equal(blob[offset:].view(np.int32),
                              np.concatenate(idxs))


def test_block_gather_batch_checks_its_arguments():
    flat = torch.zeros(4 * BW, dtype=torch.int32)
    idx = np.array([1, 3], np.int32)
    out = torch.zeros(2 * BW, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.block_gather_batch([], [], [])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [idx, idx], [out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [idx], [out, out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat[:BW + 1]], [idx], [out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [idx.astype(np.int64)], [out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [np.zeros(0, np.int32)], [out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [np.array([[1, 3]], np.int32)],
                                   [out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat.long()], [idx], [out])
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [idx], [out[:BW]])
    with pytest.raises(ValueError):  # no room for the index copy
        kernels.block_gather_batch([flat], [idx], [out], with_index=True)
    with pytest.raises(ValueError):
        kernels.block_gather_batch([flat], [idx], [out.view(2, BW)])
    with pytest.raises(ValueError):
        kernels.block_gather_batch(
            [flat], [idx], [torch.zeros(4 * BW, dtype=torch.int32)[::2]])


# -------------------------------------------------------- cache twins


class Twin:
    """The reference's DeviceRowCache and the port's, driven alike."""

    def __init__(self, **kw):
        self.ref = jres.DeviceRowCache(**kw)
        self.port = pres.DeviceRowCache(device="cpu", **kw)
        self.calls: dict = {}

    def get(self, key, host: np.ndarray) -> np.ndarray:
        """Both caches' array for ``key`` (decoding ``host`` on a miss),
        held equal; returns it."""
        def decoder(side):
            def decode():
                self.calls[key, side] = self.calls.get((key, side), 0) + 1
                return host.copy()
            return decode

        want = np.asarray(self.ref.get_row(key, decoder("ref")))
        got = _u(self.port.get_row(key, decoder("port")))
        assert np.array_equal(got, want), key
        assert self.calls.get((key, "port")) == self.calls.get((key, "ref"))
        self.check()
        return got

    def decodes(self, key) -> int:
        return self.calls.get((key, "port"), 0)

    def both(self, fn):
        """``fn(cache)`` on each; the port's result."""
        fn(self.ref)
        out = fn(self.port)
        self.check()
        return out

    def check(self) -> None:
        assert self.port.metrics() == self.ref.metrics()
        assert self.port.tier_overlay() == self.ref.tier_overlay()


def test_demote_compress_promote_roundtrip():
    rng = np.random.default_rng(7)
    c = Twin(budget_bytes=200 << 10)  # one 128 KiB row fits
    a, b = sparse_row(rng, 3), sparse_row(rng, 2)
    c.get(("a",), a)
    c.get(("b",), b)  # a: dense -> compressed
    assert c.port.compressions == 1
    assert c.port.compressed_bytes < ROW_BYTES // 4
    assert np.array_equal(c.get(("a",), a), a)  # promoted, no decode
    assert c.decodes(("a",)) == 1 and c.port.decompressions == 1
    assert np.array_equal(c.get(("b",), b), b)
    assert c.decodes(("b",)) == 1


def test_dense_rows_drop_instead_of_compress():
    rng = np.random.default_rng(8)
    c = Twin(budget_bytes=200 << 10)
    full = rng.integers(1, 1 << 32, W, dtype=np.uint32)
    c.get(("full",), full)
    c.get(("other",), sparse_row(rng, 1))
    assert c.port.compressions == 0 and c.port.evictions == 1
    c.get(("full",), full)
    assert c.decodes(("full",)) == 2


def test_all_zero_row_roundtrip():
    c = Twin(budget_bytes=200 << 10)
    c.get(("z",), np.zeros(W, np.uint32))
    c.get(("f",), np.ones(W, np.uint32))
    assert c.port.compressions == 1
    assert not c.get(("z",), np.zeros(W, np.uint32)).any()
    assert c.decodes(("z",)) == 1


def test_invalidate_hits_both_tiers():
    rng = np.random.default_rng(9)
    c = Twin(budget_bytes=200 << 10)
    a, b = sparse_row(rng, 2), sparse_row(rng, 2)
    c.get(("frag", 1, "a"), a)
    c.get(("frag", 1, "b"), b)  # a now compressed
    c.both(lambda cache: cache.invalidate_fragment(("frag", 1)))
    assert len(c.port) == 0 and c.port.bytes_used == 0
    c.get(("frag", 1, "a"), a)
    assert c.decodes(("frag", 1, "a")) == 2


def test_compressed_tier_evicts_under_total_budget():
    rng = np.random.default_rng(10)
    c = Twin(budget_bytes=160 << 10)
    for i in range(16):
        c.get((i,), sparse_row(rng, 14))
    assert c.port.bytes_used <= c.port.budget_bytes + ROW_BYTES
    assert c.port.evictions > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_randomized_roundtrip_vs_oracle(seed):
    rng = np.random.default_rng(seed)
    c = Twin(budget_bytes=200 << 10)
    hosts = {i: sparse_row(rng, int(rng.integers(0, 16))) for i in range(6)}
    for i, host in hosts.items():
        c.get((i,), host)
    for i in rng.permutation(6):
        assert np.array_equal(c.get((int(i),), hosts[int(i)]), hosts[int(i)])


def test_stacked_leaf_shapes_compress():
    """Stacked [S, W] leaves and [S, 2 + depth, W] planes take the same
    path: multi-dimensional shapes survive the round trip."""
    rng = np.random.default_rng(11)
    c = Twin(budget_bytes=500 << 10)
    stacked = np.stack([sparse_row(rng, 2) for _ in range(2)])
    planes = np.zeros((2, 3, W), np.uint32)
    planes[0, 1, :BW] = 5
    c.get(("s",), stacked)
    c.get(("p",), planes)
    c.get(("big",), rng.integers(1, 1 << 32, (2, W), dtype=np.uint32))
    assert c.port.compressions >= 1
    assert np.array_equal(c.get(("s",), stacked), stacked)
    got = c.port.get_row(("p",), lambda: 1 / 0)
    assert got.shape == planes.shape and np.array_equal(_u(got), planes)


def test_working_set_within_budget_stays_dense():
    rng = np.random.default_rng(12)
    c = Twin(budget_bytes=600 << 10)  # 4 rows fit
    rows = [sparse_row(rng, 2) for _ in range(4)]
    for _ in range(4):
        for i, r in enumerate(rows):
            c.get((i,), r)
    assert c.port.compressions == 0 and c.port.evictions == 0
    assert all(c.decodes((i,)) == 1 for i in range(4))


def test_apply_write_patches_dense_and_spares_unrelated():
    """A write reaches exactly the tagged and affected entries: the
    affected dense one is patched in place (no eviction, no decode),
    the others are untouched."""
    rng = np.random.default_rng(13)
    c = Twin(budget_bytes=4 << 20)
    affected, unrelated = sparse_row(rng, 2), sparse_row(rng, 2)
    c.get(("stack", "i", "f", 1), affected)
    c.get(("stack", "i", "g", 1), unrelated)
    import jax.numpy as jnp

    probed = []

    def probe(patch):
        def p(ev):
            probed.append(ev.row)
            return patch if ev.row == 1 else None
        return p

    c.ref.register_updater(("stack", "i", "f", 1), ("", "i", "f"),
                           probe(lambda arr: arr | jnp.uint32(1)))
    c.port.register_updater(("stack", "i", "f", 1), ("", "i", "f"),
                            probe(lambda arr: arr.bitwise_or_(1)))
    for row, field in ((1, "f"), (7, "f"), (1, "g")):
        c.both(lambda cache: cache.apply_write(
            jres.WriteEvent("i", field, "standard", 0, row)
            if cache is c.ref else
            pres.WriteEvent("i", field, "standard", 0, row)))
    assert probed == [1, 1, 7, 7] and c.port.updates == 1
    assert len(c.port) == 2 and c.port.misses == 2
    assert np.array_equal(c.get(("stack", "i", "f", 1), affected),
                          affected | np.uint32(1))
    assert c.decodes(("stack", "i", "f", 1)) == 1


def test_apply_write_invalidates_compressed_copies():
    rng = np.random.default_rng(14)
    c = Twin(budget_bytes=200 << 10)
    c.get(("stack", "i", "f", 1), sparse_row(rng, 2))
    for cache in (c.ref, c.port):
        cache.register_updater(("stack", "i", "f", 1), ("", "i", "f"),
                               lambda ev: (lambda arr: arr)
                               if ev.row == 1 else None)
    c.get(("stack", "i", "f", 2), sparse_row(rng, 2))  # 1 compressed
    assert c.port.compressions == 1
    c.both(lambda cache: cache.apply_write(
        (jres if cache is c.ref else pres).WriteEvent("i", "f", "standard",
                                                      0, 1)))
    assert ("stack", "i", "f", 1) not in c.port._compressed
    assert ("stack", "i", "f", 2) in c.port._rows


def test_updaters_dropped_with_entries():
    rng = np.random.default_rng(15)
    c = Twin(budget_bytes=4 << 20)
    c.get(("k",), sparse_row(rng, 2))
    c.both(lambda cache: cache.register_updater(("k",), ("", "i", "f"),
                                                lambda ev: None))
    assert ("", "i", "f") in c.port._tag_index
    c.both(lambda cache: cache.invalidate(("k",)))
    assert not c.port._tag_index and not c.port._updaters
    c.both(lambda cache: cache.register_updater(("gone",), ("", "i", "f"),
                                                lambda ev: None))
    assert not c.port._updaters
    c.port.apply_write(pres.WriteEvent("i", "f", "standard", 0, 1))


def test_touch_refreshes_lru_position():
    rng = np.random.default_rng(11)
    c = Twin(budget_bytes=300 << 10)  # two rows fit
    hot, cold = sparse_row(rng, 20), sparse_row(rng, 20)
    c.get(("hot",), hot)
    c.get(("cold",), cold)
    c.both(lambda cache: cache.touch([("hot",), ("missing",)]))
    c.get(("new",), sparse_row(rng, 20))  # over budget
    c.get(("hot",), hot)
    assert c.decodes(("hot",)) == 1
    c.get(("cold",), cold)
    assert c.decodes(("cold",)) == 2


def test_patch_listener_weakly_held_and_sees_the_promoted_tensor():
    """The port's counterpart of the reference's generation listeners
    (its in-place patches need a listener before the patch, not after a
    functional swap): a listener is told the tensor about to change,
    which after a promotion is the new dense tensor, and a dead
    registrant is dropped."""
    rng = np.random.default_rng(16)
    cache = pres.DeviceRowCache(budget_bytes=200 << 10)
    seen = []

    class L:
        def cb(self, arr):
            seen.append(arr)

    keep, gone = L(), L()
    cache.add_patch_listener(keep.cb)
    cache.add_patch_listener(gone.cb)
    del gone
    key = ("stack", "i", "f", 1)
    host = sparse_row(rng, 2)
    first = cache.get_row(key, lambda: host.copy())
    cache.register_updater(key, ("", "i", "f"),
                           lambda ev: (lambda arr: arr.bitwise_or_(2)))
    cache.get_row(("other",), lambda: sparse_row(rng, 2))  # key compressed
    assert cache.compressions == 1
    promoted = cache.get_row(key, lambda: 1 / 0)
    assert promoted is not first
    cache.apply_write(pres.WriteEvent("i", "f", "standard", 0, 1))
    assert len(seen) == 1 and seen[0] is promoted
    assert len(cache._patch_listeners) == 1
    assert np.array_equal(_u(promoted), host | np.uint32(2))


# ------------------------------------------------------- executors


def _month_words(n_shards: int, n_rows: int) -> dict:
    """Rows splitting the columns into contiguous ranges (one a row),
    boundaries inside shards and blocks: sparse, compressible leaves."""
    n = n_shards * W * 32
    edges = [n * m // n_rows + 37 * m for m in range(n_rows)] + [n]
    out = {}
    for m in range(n_rows):
        bits = np.zeros(n, bool)
        bits[edges[m]:edges[m + 1]] = True
        out[m] = np.packbits(bits, bitorder="little").view("<u4")
    return out


@pytest.fixture(scope="module")
def month_dir(tmp_path_factory):
    """8 shards: ``month`` (8 contiguous-range rows, compressible) and
    ``cab`` (3 Bernoulli rows, incompressible)."""
    rng = np.random.default_rng(2031)
    n = 8 * W * 32
    cab = {c: np.packbits(rng.random(n) < p, bitorder="little").view("<u4")
           for c, p in ((0, 0.5), (1, 0.3), (2, 0.05))}
    path = tmp_path_factory.mktemp("months") / "data"
    h = Holder(str(path), device="cpu").open()
    load_from_dense(h, {"month": _month_words(8, 8), "cab": cab},
                    index="rides")
    h.close()
    return path


MONTH_QUERIES = [
    "Count(Intersect(Row(month=3), Row(cab=1)))",
    "Count(Union(Row(month=5), Row(month=6), Row(month=7)))",
    "TopN(cab, Row(month=2), n=3)",
    "Count(Row(month=0)) Count(Row(month=1))",
    "Count(Intersect(Row(month=3), Row(cab=0)))",
    "Row(month=4)",
]


def test_executor_queues_survive_demotion(month_dir, tmp_path):
    """A queued micro-batch may hold a dense leaf that the cache then
    demotes: it keeps the tensor (K10 only reads it) and answers as the
    reference does; the caches make the same tier moves."""
    shutil.copytree(month_dir, tmp_path / "jax")
    shutil.copytree(month_dir, tmp_path / "port")
    budget = 3 << 20  # three 1 MiB leaves of 8 shards
    jcache = jres.DeviceRowCache(budget)
    old = jres.global_row_cache()
    jres.set_global_row_cache(jcache)
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    ph = Holder(str(tmp_path / "port"), device="cpu", budget_bytes=budget)
    ph.open()
    try:
        jex, pex = JExecutor(jh), Executor(ph, device="cpu")
        pair = ("Count(Row(month=1)) "
                "Count(Intersect(Row(month=2), Row(cab=2)))")
        jqueued = jex.submit("rides", pair)
        queued = pex.submit("rides", pair)
        for pql in MONTH_QUERIES:  # demotes the queued leaves
            assert result_to_json(pex.execute("rides", pql)) == \
                j_result_to_json(jex.execute("rides", pql)), pql
        assert ph.cache.compressions > 0
        assert [d.result() for d in queued] == \
            [d.result() for d in jqueued]
        for pql in MONTH_QUERIES[::-1]:  # promotions (K11)
            assert result_to_json(pex.execute("rides", pql)) == \
                j_result_to_json(jex.execute("rides", pql)), pql
        assert ph.cache.decompressions > 0
        for k in ("residency_compressions", "residency_decompressions",
                  "residency_evictions", "residency_entries_compressed",
                  "residency_bytes_used", "residency_bytes_compressed"):
            assert ph.cache.metrics()[k] == jcache.metrics()[k], k
    finally:
        jh.close()
        ph.close()
        jres.set_global_row_cache(old)


# ----------------------------------------------------------- tiering


class FakePacer:
    """``consume(nbytes)`` records and returns a paced time (no sleep)."""

    def __init__(self):
        self.debits = []

    def consume(self, nbytes: int) -> float:
        self.debits.append(nbytes)
        return 0.25


def _mkrow(seed: int) -> np.ndarray:
    a = np.zeros(W, np.uint32)
    a[seed * 512:seed * 512 + 8] = 5
    return a


PKGS = {"ref": (jres, jheat, jtier), "port": (pres, pheat, ptier)}


def _cache(pkg, **kw):
    res = PKGS[pkg][0]
    return (res.DeviceRowCache(**kw) if pkg == "ref"
            else res.DeviceRowCache(device="cpu", **kw))


def _arr(pkg, arr) -> np.ndarray:
    return np.asarray(arr) if pkg == "ref" else _u(arr)


def _no_decode():
    raise AssertionError("the entry must be served without a decode")


def _pass(t) -> dict:
    out = t.run_pass()
    out.pop("seconds")
    return out


def _tiering_twins(scenario):
    """Run ``scenario(pkg)`` for both packages: equal records."""
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def test_demote_promote_cycle():
    def scenario(pkg):
        res, heat_mod, tier = PKGS[pkg]
        cache = _cache(pkg, budget_bytes=64 << 20, host_budget_bytes=8 << 20)
        heat = heat_mod.HeatMap(half_life_s=60.0)
        scope = "/d/i"
        for shard in range(2):
            for row in range(2):
                cache.get_row((scope, "i", "f", "standard", shard, row),
                              lambda r=row: _mkrow(r + 1))
        heat.record_access("i", "f", [0], n=50.0, scope=scope)
        t = tier.ResidencyTierer(cache=cache, heat=heat, interval_s=0,
                                 promote_heat=4.0, demote_heat=1.0,
                                 min_dwell_s=0)
        rec = [_pass(t), cache.metrics(), cache.tier_overlay()]
        assert rec[0]["demoted"] == 2  # shard 1's two rows
        assert rec[2][0][(scope, "i", "f", 1)]["host"] > 0
        assert rec[2][0][(scope, "i", "f", 1)]["dense"] == 0
        heat.record_access("i", "f", [1], n=50.0, scope=scope)
        rec += [_pass(t), cache.metrics(), t.last_decisions()]
        assert rec[3]["promoted"] == 2
        arr = cache.get_row((scope, "i", "f", "standard", 1, 0), _no_decode)
        assert np.array_equal(_arr(pkg, arr), _mkrow(1))
        return rec + [t.metrics()["residency_tier_promoted_bytes_total"]]

    _tiering_twins(scenario)


def test_plane_stack_tiers_at_field_granularity():
    def scenario(pkg):
        res, heat_mod, tier = PKGS[pkg]
        cache = _cache(pkg, budget_bytes=64 << 20)
        heat = heat_mod.HeatMap(half_life_s=60.0)
        scope = "/d/i"
        key = ("stackp", scope, "i", "f", 5, (0, 4))
        cache.get_row(key, lambda: _mkrow(1))
        per_frag, per_stack = cache.tier_overlay()
        assert (scope, "i", "f") in per_stack
        assert not any(k[0] == "stackp" for k in per_frag)
        heat.record_access("i", "f", [0], n=50.0, scope=scope)
        t = tier.ResidencyTierer(cache=cache, heat=heat, interval_s=0,
                                 promote_heat=4.0, demote_heat=1.0,
                                 min_dwell_s=0)
        rec = [_pass(t), t.last_decisions()]
        assert rec[0]["demoted"] == 0
        heat.clear()
        rec += [_pass(t), t.last_decisions(), cache.metrics()]
        assert rec[2]["demoted"] == 1
        heat.record_access("i", "f", [0], n=50.0, scope=scope)
        rec += [_pass(t), cache.metrics()]
        assert rec[5]["promoted"] == 1
        arr = cache.get_row(key, _no_decode)
        assert np.array_equal(_arr(pkg, arr), _mkrow(1))
        return rec

    _tiering_twins(scenario)


def test_host_hit_promotes_on_access():
    def scenario(pkg):
        cache = _cache(pkg, budget_bytes=64 << 20)
        scope = "/d/i"
        key = (scope, "i", "f", "standard", 0, 1)
        cache.get_row(key, lambda: _mkrow(2))
        moved = cache.demote_fragment_to_host(scope, "i", "f", 0)
        rec = [moved, cache.metrics()]
        arr = cache.get_row(key, _no_decode)
        assert np.array_equal(_arr(pkg, arr), _mkrow(2))
        assert cache.host_hits == 1 and cache.tier_promotions == 1
        return rec + [cache.metrics()]

    _tiering_twins(scenario)


def test_write_invalidates_host_copy():
    def scenario(pkg):
        cache = _cache(pkg, budget_bytes=64 << 20)
        scope = "/d/i"
        key = (scope, "i", "f", "standard", 0, 1)
        cache.get_row(key, lambda: _mkrow(1))
        cache.demote_fragment_to_host(scope, "i", "f", 0)
        cache.invalidate(key)
        assert cache.metrics()["residency_entries_host"] == 0
        fresh = _mkrow(3)
        arr = cache.get_row(key, lambda: fresh.copy())
        assert np.array_equal(_arr(pkg, arr), fresh)
        return [cache.metrics()]

    _tiering_twins(scenario)


def test_write_to_host_tier_stack_invalidates_it():
    """A write routed to a host-tier stacked leaf invalidates the copy
    (the updater stayed registered across the demotion)."""
    def scenario(pkg):
        res = PKGS[pkg][0]
        cache = _cache(pkg, budget_bytes=64 << 20)
        key = ("stack", "/d/i", "i", "f", ("standard",), 1, "blk")
        cache.get_row(key, lambda: _mkrow(1))
        cache.register_updater(key, ("/d/i", "i", "f"),
                               lambda ev: (lambda arr: arr))
        rec = [cache.demote_field_stacks_to_host("/d/i", "i", "f")]
        cache.apply_write(res.WriteEvent("i", "f", "standard", 0, 1,
                                         scope="/d/i"))
        return rec + [cache.metrics(), cache.tier_overlay()]

    rec = _tiering_twins(scenario)
    assert rec[1]["residency_entries_host"] == 0


def test_hysteresis_dwell_blocks_flipflop():
    def scenario(pkg):
        res, heat_mod, tier = PKGS[pkg]
        cache = _cache(pkg, budget_bytes=64 << 20)
        heat = heat_mod.HeatMap(half_life_s=60.0)
        scope = "/d/i"
        cache.get_row((scope, "i", "f", "standard", 0, 1), lambda: _mkrow(1))
        cache.demote_fragment_to_host(scope, "i", "f", 0)
        heat.record_access("i", "f", [0], n=50.0, scope=scope)
        t = tier.ResidencyTierer(cache=cache, heat=heat, interval_s=0,
                                 promote_heat=4.0, demote_heat=1.0,
                                 min_dwell_s=3600.0)
        rec = [_pass(t)]
        heat.clear()
        rec += [_pass(t), t.last_decisions()]
        assert rec[1]["demoted"] == 0
        assert rec[2][(scope, "i", "f", 0)] == "hold"
        t.min_dwell_s = 0.0
        rec += [_pass(t), cache.metrics()]
        assert rec[3]["demoted"] == 1
        return rec

    _tiering_twins(scenario)


def test_host_budget_bounds_tier():
    def scenario(pkg):
        cache = _cache(pkg, budget_bytes=64 << 20, host_budget_bytes=6000)
        scope = "/d/i"
        for shard in range(4):
            cache.get_row((scope, "i", "f", "standard", shard, 1),
                          lambda s=shard: _mkrow(s + 1))
            cache.demote_fragment_to_host(scope, "i", "f", shard)
        assert cache.host_bytes <= 6000 and cache.evictions > 0
        return [cache.metrics(), cache.tier_overlay()]

    _tiering_twins(scenario)


def test_pacer_shapes_promotions():
    """The injected pacer is debited once a promoted entry, outside the
    cache lock, and its paced time is reported."""
    def scenario(pkg):
        res, heat_mod, tier = PKGS[pkg]
        cache = _cache(pkg, budget_bytes=64 << 20)
        heat = heat_mod.HeatMap(half_life_s=60.0)
        scope = "/d/i"
        for row in range(3):
            cache.get_row((scope, "i", "f", "standard", 0, row),
                          lambda r=row: _mkrow(r + 1))
        cache.demote_fragment_to_host(scope, "i", "f", 0)
        heat.record_access("i", "f", [0], n=50.0, scope=scope)
        pacer = FakePacer()
        t = tier.ResidencyTierer(cache=cache, heat=heat, interval_s=0,
                                 promote_heat=4.0, demote_heat=1.0,
                                 min_dwell_s=0, pacer=pacer)
        out = _pass(t)
        assert out["promoted"] == 3 and out["pacedSleepS"] == 0.75
        m = t.metrics()
        m.pop("residency_tier_last_pass_seconds")
        return [out, pacer.debits, m]

    rec = _tiering_twins(scenario)
    assert len(rec[1]) == 3


class GatherSpy:
    """Counts the port cache's K10 calls: batches and the leaves in each."""

    def __init__(self, monkeypatch):
        self.batches = []
        real = kernels.block_gather_batch

        def spy(flats, idxs, outs, **kw):
            self.batches.append(len(flats))
            return real(flats, idxs, outs, **kw)

        monkeypatch.setattr(kernels, "block_gather_batch", spy)


def _stack(field: str, n) -> tuple:
    return ("stack", "/d", "i", field, ("standard",), n, "blk")


def _patch_both(c: Twin, key, slot: int, words: np.ndarray,
                masks: np.ndarray) -> None:
    """One write routed to ``key`` in both caches: the reference's
    functional OR, the port's K3 ``WordPatch``."""
    import jax.numpy as jnp

    delta = np.zeros((2, W), np.uint32)
    delta[slot, words] = masks
    c.ref.register_updater(key, ("/d", "i", "f"),
                           lambda ev: (lambda arr: arr | jnp.asarray(delta))
                           if ev.row == 9 else None)
    c.port.register_updater(key, ("/d", "i", "f"),
                            lambda ev: pres.WordPatch(slot, None, words,
                                                      masks, False)
                            if ev.row == 9 else None)
    c.both(lambda cache: cache.apply_write(
        (jres if cache is c.ref else pres).WriteEvent(
            "i", "f", "standard", 0, 9, scope="/d")))


def _host_entries_equal(c: Twin) -> None:
    assert list(c.port._host) == list(c.ref._host)
    for key, want in c.ref._host.items():
        got = c.port._host[key]
        assert np.array_equal(got.blocks, np.asarray(want.blocks)), key
        assert got.blocks.dtype == np.asarray(want.blocks).dtype
        if want.idx is None:
            assert got.idx is None
        else:
            assert np.array_equal(got.idx, np.asarray(want.idx))
        assert tuple(got.shape) == tuple(want.shape)
        assert got.n_blocks == want.n_blocks
        if want.block_idx is None:
            assert got.block_idx is None
        else:
            assert np.array_equal(got.block_idx, want.block_idx)


def test_demotion_sequence_matches_reference(monkeypatch):
    """Writes, evictions and one host-tier demotion through both caches:
    an eviction that demotes several victims decides as the reference
    does in one K10 launch; the demotion of a field's stacks (sparse
    dense entries, a K3-patched one, an incompressible one, an all-zero
    one and compressed copies) gathers every block-indexed entry in one
    launch and leaves equal host entries, metrics and tier overlays;
    every entry comes back equal to its words."""
    spy = GatherSpy(monkeypatch)
    rng = np.random.default_rng(71)
    c = Twin(budget_bytes=16 * ROW_BYTES, host_budget_bytes=64 << 20)
    hosts = {n: np.stack([sparse_row(rng, int(rng.integers(1, 6)))
                          for _ in range(2)]) for n in range(5)}
    hosts["full"] = rng.integers(1, 1 << 32, (2, W), dtype=np.uint32)
    hosts["zero"] = np.zeros((2, W), np.uint32)
    for n, host in hosts.items():
        c.get(_stack("f", n), host)
    assert c.port.compressions == 0 and not spy.batches
    # a K3 patch of entry 3: it keeps its words on the card, loses its
    # block index
    words = np.array([7, 4000, 30000], np.int32)
    masks = np.array([1, 0x80000000, 0xFFFF], np.uint32)
    _patch_both(c, _stack("f", 3), 1, words, masks)
    hosts[3] = hosts[3].copy()
    hosts[3][1, words] |= masks
    assert c.port.updates == 1
    # a wide leaf over budget: the LRU victims 0, 1 and 2 are demoted
    # together (one launch) until it fits
    wide = np.stack([sparse_row(rng, 3) for _ in range(6)])
    c.get(_stack("g", 0), wide)
    assert c.port.compressions == 3 and spy.batches == [3]
    for n in (0, 1, 2):
        # each copy owns exactly its accounted bytes
        centry = c.port._compressed[_stack("f", n)]
        assert centry.words.untyped_storage().nbytes() == centry.nbytes
        assert centry.idx.untyped_storage().data_ptr() == \
            centry.blocks.untyped_storage().data_ptr()
    # one step of the tierer: the field's stacks to host
    want = c.ref.demote_field_stacks_to_host("/d", "i", "f")
    assert c.port.demote_field_stacks_to_host("/d", "i", "f") == want
    c.check()
    assert want[0] == 7
    assert spy.batches == [3, 1]  # entry 4 alone is dense and indexed
    _host_entries_equal(c)
    # read back: the whole words of the patched, full and zero entries,
    # the compressed copies' blocks and indices, entry 4's blocks alone
    host = c.port._host
    assert c.port.readback_bytes == 3 * 2 * ROW_BYTES + sum(
        host[_stack("f", n)].nbytes for n in (0, 1, 2)) + \
        host[_stack("f", 4)].blocks.nbytes
    for n, host in hosts.items():
        assert np.array_equal(c.get(_stack("f", n), host), host), n
    assert all(c.decodes(_stack("f", n)) == 1 for n in hosts)


def test_demotion_eviction_of_gathered_victims_matches_reference(
        monkeypatch):
    """An eviction whose own second loop drops compressed copies it has
    just made: the same entries end compressed, dropped and evicted as
    in the reference, and only the survivors are gathered."""
    spy = GatherSpy(monkeypatch)
    rng = np.random.default_rng(72)
    c = Twin(budget_bytes=3 * ROW_BYTES + (100 << 10))
    rows = {n: sparse_row(rng, 16) for n in range(3)}
    for n, row in rows.items():
        c.get((n,), row)
    big = rng.integers(1, 1 << 32, (3, W), dtype=np.uint32)
    c.get(("big",), big)  # 0, 1, 2 compressed; 0 and 1 dropped again
    assert c.port.compressions == 3 and c.port.evictions == 2
    assert list(c.port._compressed) == [(2,)] and spy.batches == [1]
    for n, row in rows.items():
        assert np.array_equal(c.get((n,), row), row)
    assert [c.decodes((n,)) for n in rows] == [2, 2, 1]


# --------------------------------------------------------------- heat


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both heat modules; returns a list
    whose element 0 is the time."""
    now = [1000.0]

    class FakeTime:
        @staticmethod
        def monotonic():
            return now[0]

    monkeypatch.setattr(jheat, "time", FakeTime)
    monkeypatch.setattr(pheat, "time", FakeTime)
    return now


def _heats(**kw):
    return jheat.HeatMap(**kw), pheat.HeatMap(**kw)


def _snaps(heats) -> tuple:
    return (heats[0].snapshot(residency_overlay=False), heats[1].snapshot())


def test_heat_decay_half_life(clock):
    heats = _heats(half_life_s=0.05)
    for h in heats:
        h.record_access("i", "f", [0], n=8.0)
    clock[0] += 0.1  # two half-lives
    rows = [h.hottest(1) for h in heats]
    assert rows[1] == rows[0] and rows[1][0]["access"] == 2.0


def test_heat_decay_is_amortized(clock):
    """Adds inside DECAY_INTERVAL_S accumulate undecayed; the pending
    decay folds in once the interval passes."""
    heats = _heats(half_life_s=10.0)
    for dt, n in ((0.0, 4.0), (0.5, 4.0), (10.0, 0.0)):
        clock[0] += dt
        for h in heats:
            h.record_access("i", "f", [3], n=n, scope="/s")
            h.record_write("i", "f", 3, n=1.0, scope="/s")
        want, got = _snaps(heats)
        assert got == want
    assert heats[1].metrics() == heats[0].metrics()


def test_heat_batched_access_records_match_reference(clock):
    """The port batches a query's access records (one pending group per
    shard list) and folds them before any read or write and once a
    group is DECAY_INTERVAL_S old. With the clock standing still the
    table is the reference's exactly; over a moving clock, with reads
    and writes in between, each entry stays within the decay of one
    interval of the reference's (the error its own amortized decay
    admits: an add decays as if it landed at its interval's start)."""
    half_life = 20.0
    tol = 1 - 0.5 ** (pheat.HeatMap.DECAY_INTERVAL_S / half_life)
    for dt in (0.0, 0.25):
        heats = _heats(half_life_s=half_life)
        shards = [0, 1, 2, 5]
        for step in range(24):
            clock[0] += dt
            for h in heats:
                h.record_access_many("i", ("f", "g"), shards, scope="/s")
                if step % 7 == 3:
                    h.record_write("i", "g", 5, n=2.0, scope="/s")
            if step % 5 == 4 or step == 23:
                want, got = (
                    {(r["field"], r["shard"]): r for r in snap["shards"]}
                    for snap in _snaps(heats))
                assert got.keys() == want.keys()
                for key, r in want.items():
                    for col in ("access", "writes"):
                        if dt == 0.0:
                            assert got[key][col] == r[col], (key, col)
                        else:
                            assert abs(got[key][col] - r[col]) <= \
                                tol * r[col] + 1e-3, (step, key, col)
        assert heats[1].metrics() == heats[0].metrics()


def test_heat_prune_bounds_table(clock):
    heats = _heats()
    for shard in range(300):
        clock[0] += 0.01
        for h in heats:
            h.record_access("i", "f", [shard], n=1.0 + shard % 7)
    for h in heats:
        h._maybe_prune(max_entries=100)
    assert heats[1].metrics()["tracked_shards"] <= 100
    want, got = _snaps(heats)
    assert got == want


def test_heat_write_only_workload_bounded(clock):
    heats = _heats()
    for h in heats:
        for shard in range(300):
            h.record_write("i", "f", shard)
        h._maybe_prune(max_entries=100)
    assert heats[1].metrics() == heats[0].metrics()
    assert heats[1].metrics()["tracked_shards"] <= 100


def test_heat_scope_separates_holders(clock):
    heats = _heats()
    for h in heats:
        h.record_access("i", "f", [0], n=5.0, scope="/data/a")
        h.record_access("i", "f", [0], n=1.0, scope="/data/b")
    rows = heats[1].hottest(10)
    assert rows == heats[0].hottest(10) and len(rows) == 2
    assert rows[0]["scope"] == "/data/a" and rows[0]["access"] == 5.0


def test_merge_shard_heat_matches_reference():
    rows = [[{"index": "i", "field": "f", "shard": 0, "access": 2.0,
              "writes": 1.0},
             {"index": "i", "field": "g", "shard": 0, "access": 4.0,
              "writes": 0.0, "scope": "/a"}],
            [{"index": "i", "field": "f", "shard": 0, "access": 1.0,
              "writes": 0.5},
             {"index": "j", "field": "f", "shard": 3, "access": 0.5},
             {"bad": 1}, None]]
    assert pheat.merge_shard_heat(rows) == jheat.merge_shard_heat(rows)


def test_heat_hottest_and_metrics_match_reference(clock):
    """Ranking (ties keep insertion order), ``k``, scope-less rows and
    the totals, after decay folds in."""
    heats = _heats(half_life_s=30.0)
    for shard, n in ((4, 3.0), (1, 9.0), (7, 3.0), (2, 0.5)):
        for h in heats:
            h.record_access("i", "f", [shard], n=n)
            h.record_access_many("i", ("g", "h"), [shard, shard + 8], n=n)
            h.record_write("i", "f", shard, n=n / 2)
        clock[0] += 2.0
    for k in (0, 1, 3):
        assert heats[1].hottest(k) == heats[0].hottest(k)
    assert heats[1].metrics() == heats[0].metrics()


# ------------------------------------------------------------- servers


def _post(base: str, path: str, body: bytes):
    r = urllib.request.Request(base + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


TIER_KEYS = ("residency_compressions", "residency_decompressions",
             "residency_evictions", "residency_entries",
             "residency_entries_compressed", "residency_entries_host",
             "residency_bytes_used", "residency_bytes_compressed",
             "residency_bytes_host", "residency_host_hits",
             "residency_tier_promotions", "residency_tier_demotions")


def test_servers_match_reference_through_the_tiers(month_dir, tmp_path,
                                                  clock):
    """A server of each package on copies of one 8-shard data dir with a
    budget of three leaves: the same PQL (reads, a Set, an /import)
    gives the same bodies and the same tier counters, through the
    compressed tier, one tierer pass to the host tier and the host hits
    that follow; the write heat is the same (the heat clock stands
    still)."""
    shutil.copytree(month_dir, tmp_path / "jax")
    shutil.copytree(month_dir, tmp_path / "port")
    budget = 3 << 20
    old_cache, old_heats = jres.global_row_cache(), (jheat.global_heat(),
                                                      pheat.global_heat())
    jcache = jres.DeviceRowCache(budget)
    jres.set_global_row_cache(jcache)
    jheat.set_global_heat(jheat.HeatMap())
    pheat.set_global_heat(pheat.HeatMap())
    jh = jstorage.Holder(str(tmp_path / "jax")).open()
    jserver, jport, _ = j_serve_in_thread(JAPI(jh))
    port = Server(str(tmp_path / "port"), port=0, device="cpu",
                  budget_bytes=budget).open()
    bases = (f"http://localhost:{jport}", f"http://localhost:{port.port}")

    def same(path: str, body: bytes) -> None:
        want = _post(bases[0], path, body)
        assert _post(bases[1], path, body) == want, body
        assert want[0] == 200, want

    def counters() -> None:
        pm = port.holder.cache.metrics()
        jm = jcache.metrics()
        assert {k: pm[k] for k in TIER_KEYS} == {k: jm[k] for k in TIER_KEYS}

    try:
        for pql in MONTH_QUERIES + MONTH_QUERIES[::-1]:
            same("/index/rides/query", pql.encode())
        counters()
        assert port.holder.cache.compressions > 0
        # every device leaf of both fields is colder than demote_heat
        tierers = (jtier.ResidencyTierer(cache=jcache, heat=jheat.global_heat(),
                                         demote_heat=1e9, promote_heat=2e9),
                   ptier.ResidencyTierer(cache=port.holder.cache,
                                         demote_heat=1e9, promote_heat=2e9))
        outs = [_pass(t) for t in tierers]
        assert outs[1] == outs[0] and outs[1]["demoted"] > 0
        counters()
        for pql in MONTH_QUERIES:
            same("/index/rides/query", pql.encode())
        counters()
        assert port.holder.cache.host_hits > 0
        same("/index/rides/query", b"Set(5, month=7) Count(Row(month=7))")
        same("/index/rides/field/month/import",
             b'{"rows": [1, 1], "columns": [9, 2000000]}')
        same("/index/rides/query", b"Count(Row(month=1)) Row(month=7)")
        counters()
        jsnap = {(r["field"], r["shard"]): r
                 for r in jheat.global_heat().snapshot(
                     residency_overlay=False)["shards"]}
        psnap = {(r["field"], r["shard"]): r
                 for r in pheat.global_heat().snapshot()["shards"]}
        assert psnap.keys() == jsnap.keys()
        for key, r in jsnap.items():
            assert psnap[key]["writes"] == r["writes"], key
    finally:
        jserver.shutdown()
        jserver.server_close()
        jh.close()
        port.close()
        jres.set_global_row_cache(old_cache)
        jheat.set_global_heat(old_heats[0])
        pheat.set_global_heat(old_heats[1])


def test_server_tiering_knobs_and_wiring(month_dir, tmp_path):
    """The reference's knobs and validation errors; a tierer runs only
    with an interval above 0, demotes a cold field's leaves to the host
    tier, serves them back, and stops at the server's close."""
    for kw, msg in (({"residency_promote_interval": -1}, "interval"),
                    ({"residency_demote_heat": -1.0}, "demote-heat"),
                    ({"residency_promote_heat": 1.0,
                      "residency_demote_heat": 1.0}, "must exceed"),
                    ({"residency_host_tier_bytes": -1}, "host-tier-bytes")):
        with pytest.raises(ValueError, match=msg):
            Server(str(tmp_path / "x"), device="cpu", **kw)
    plain = Server(str(tmp_path / "y"), port=0, device="cpu").open()
    try:
        assert plain.api.tierer is None
        assert plain.holder.cache.host_budget_bytes == 1 << 30
    finally:
        plain.close()
    shutil.copytree(month_dir, tmp_path / "port")
    old = pheat.global_heat()
    pheat.set_global_heat(pheat.HeatMap())
    server = Server(str(tmp_path / "port"), port=0, device="cpu",
                    residency_promote_interval=3600.0,  # parked: manual
                    residency_promote_heat=3.0, residency_demote_heat=0.5,
                    residency_host_tier_bytes=8 << 20)
    try:
        server.open()
        tierer = server.api.tierer
        assert tierer is not None and tierer._thread is not None
        assert server.holder.cache.host_budget_bytes == 8 << 20
        base = f"http://localhost:{server.port}"
        for pql in (b"Count(Row(cab=1))", b"Count(Row(month=2))"):
            assert _post(base, "/index/rides/query", pql)[0] == 200
        pheat.global_heat().clear()  # both fields cold
        for _ in range(4):  # cab hot again (8 shards x 4 > 3.0)
            _post(base, "/index/rides/query", b"Count(Row(cab=1))")
        out = tierer.run_pass()
        assert out["demoted"] == 1
        scope = server.holder.index("rides").scope
        decisions = tierer.last_decisions()
        assert decisions[(scope, "rides", "month")] == "demoted"
        assert decisions[(scope, "rides", "cab")] == "resident"
        st, body = _post(base, "/index/rides/query", b"Count(Row(month=2))")
        assert st == 200
        assert server.holder.cache.host_hits == 1
    finally:
        server.close()
        pheat.set_global_heat(old)
    assert tierer._thread is None and server.api.tierer is None

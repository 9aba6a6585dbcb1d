"""Device residency: which stacked leaves live in device memory.

The port's copy of ``pilosa_tpu.storage.residency``: a byte-budgeted LRU
of device tensors (bytes counted as the tensors' device bytes), keyed by
the executor's leaf keys. The host roaring files stay the source of
truth; a miss decodes on the host and uploads.

Three tiers, as in the reference. Dense entries are ready for the
kernels. When the dense tier overflows the budget, a sparse entry (at
most half of its 4 KiB blocks nonzero, judged from the host words at
insert) is *demoted* instead of dropped: K10 ``block_gather`` compacts
its nonzero blocks on the card into ``int32[nb_padded, 1024]``, one
launch for every entry one eviction demotes; a hit on it scatters them
back into a dense tensor with K11 ``block_scatter`` and promotes it.
Other entries are dropped, then the least recently used compressed
ones. The third tier, in host RAM with a budget of its own
(``host_budget_bytes``), holds what heat-driven tiering
(``storage/tiering.py``) demotes there: the compact blocks of a sparse
entry, gathered on the card by one K10 launch for the step's entries
before only they are read back (or the whole flat words, for an entry
without a block index), one upload and one K11 launch from a dense
tensor again, on access or when the tierer's pass sees the heat come
back. Byte accounting is the reference's (a compressed entry is
its blocks plus its index), so one sequence of operations makes the
same decisions in both packages.

Derived entries (the executor's stacked query leaves) register an
*updater*: a write to one fragment row becomes an in-place patch of the
affected shard slot (kernel K3, ``kernels.word_patch_batch``) instead of
an eviction. Because the patch is in place, the cache tells its patch
listeners (the executors) which tensor is about to change first, so a
queued micro-batch holding it launches before the write lands — the
submit-time snapshot that the JAX package gets from functional updates.

Patches are collected, not launched one by one: inside a
``batch_writes()`` scope (one write request) they wait until the scope
closes and then go to the card in as few K3 launches as ordering allows
(one, unless a row is patched both ways); outside a scope each write
flushes at once. Any lookup flushes first, so a read sees every write
collected before it, and collection keeps the order of the fragments'
writes across threads, so the leaves end as the host rows are. A patched
leaf loses its block index, so it is later dropped rather than
compressed (as in the reference); a write routed to a compressed or host
copy invalidates that copy; and every demotion launches the collected
patches first, so K10 reads the patched words.

A ``generation`` counter moves wherever the reference's does: a write
routed to a dense entry, an invalidation, each entry an eviction or a
demotion takes off the card, and ``clear``. The executor's operand memo
serves its assembled leaves only while it stands, and its listener
drops them at each move, so an evicted or demoted leaf's memory is
freed at once. A patch collected for later launch moves it too, so a
read after a write never takes the memo's shortcut past the lookup
that launches the collected patches.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch import kernels
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD, next_pow2
from pilosa_tpu_torch.utils.cost import current_cost
from pilosa_tpu_torch.utils.stats import prometheus_block

ROW_BYTES = WORDS_PER_SHARD * 4  # 128 KiB per shard row

# Default device budget for resident leaves: 16 GiB of an 80 GB card.
DEFAULT_BUDGET_BYTES = 16 << 30

# Default host-tier budget (the residency-host-tier-bytes knob).
DEFAULT_HOST_BUDGET_BYTES = 1 << 30

# Compression granularity: 4 KiB blocks (32 a shard row).
COMPRESS_BLOCK_WORDS = kernels.BLOCK_WORDS

# Demote as compressed only when it saves memory; denser entries drop.
COMPRESS_MAX_OCCUPANCY = 0.5


class WriteEvent:
    """One fragment-row mutation, as seen by dependent cache entries.

    positions: in-shard bit positions touched, or None when unknown (bulk
    row replace). added: True = bits only set, False = bits only cleared,
    None = mixed/unknown.
    """

    __slots__ = ("index", "field", "view", "shard", "row", "positions",
                 "added", "scope")

    def __init__(self, index, field, view, shard, row, positions=None,
                 added=None, scope=""):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.row = row
        self.positions = positions
        self.added = added
        self.scope = scope


class WordPatch(NamedTuple):
    """One K3 patch of a resident leaf: word masks ORed into (or, with
    ``clear``, cleared from) ``leaf[slot]``, or ``leaf[slot, row]`` when
    ``row`` is not None. ``word_idx`` ascends, unique."""

    slot: int
    row: int | None
    word_idx: np.ndarray
    masks: np.ndarray
    clear: bool


def merge_word_patches(patches) -> list:
    """``(leaf, WordPatch)`` pairs in write order → K3 launches, each a
    list of ``word_patch_batch`` targets holding every row at most once.
    A row's patches merge on the host while they go one way; a row
    patched the other way starts the next launch, so the writes apply in
    their order."""
    launches, cur = [], {}
    for leaf, p in patches:
        key = (leaf.data_ptr(), p.slot, p.row)
        prev = cur.get(key)
        if prev is not None and prev[3] != p.clear:
            launches.append(cur)
            cur, prev = {}, None
        if prev is None:
            cur[key] = (leaf, p.slot, p.row, p.clear, [p.word_idx],
                        [p.masks])
        else:
            prev[4].append(p.word_idx)
            prev[5].append(p.masks)
    if cur:
        launches.append(cur)
    out = []
    for launch in launches:
        targets = []
        for leaf, slot, row, clear, words, masks in launch.values():
            if len(words) == 1:
                w, m = words[0], masks[0]
            else:
                w, inv = np.unique(np.concatenate(words), return_inverse=True)
                m = np.zeros(w.size, np.uint32)
                np.bitwise_or.at(m, inv, np.concatenate(masks))
            targets.append((leaf, slot, row, w, m, clear))
        out.append(targets)
    return out


def upload(host: np.ndarray, device) -> torch.Tensor:
    """uint32 host words → int32 tensor on ``device`` (same bits)."""
    return torch.from_numpy(
        np.ascontiguousarray(host, np.uint32).view(np.int32)).to(device)


def _upload_async(host: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the stream:
    through pinned memory on the card (the caching host allocator keeps
    it until the copy has run), as it is on the CPU."""
    t = torch.from_numpy(host)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _compressed_nbytes(block_idx: np.ndarray) -> int:
    """A compressed entry's bytes, known from its block index before K10
    has run: the padded blocks and the padded index."""
    return next_pow2(len(block_idx)) * (COMPRESS_BLOCK_WORDS + 1) * 4


class _CompressedEntry:
    """A sparse entry's nonzero blocks on the card (K10's output): one
    flat int32 tensor of exactly its accounted bytes, the nb_padded
    blocks, then their padded index."""

    __slots__ = ("words", "shape", "n_blocks", "block_idx")

    def __init__(self, words, shape, n_blocks, block_idx):
        self.words = words  # device int32[nb_padded * 1025]
        self.shape = shape
        self.n_blocks = n_blocks
        self.block_idx = block_idx  # host copy of the real prefix

    @property
    def blocks(self) -> torch.Tensor:  # int32[nb_padded, 1024]
        n = next_pow2(len(self.block_idx))
        return self.words[:n * COMPRESS_BLOCK_WORDS].view(
            n, COMPRESS_BLOCK_WORDS)

    @property
    def idx(self) -> torch.Tensor:  # int32[nb_padded]
        return self.words[next_pow2(len(self.block_idx))
                          * COMPRESS_BLOCK_WORDS:]

    @property
    def nbytes(self) -> int:
        return _compressed_nbytes(self.block_idx)


class _HostEntry:
    """A host-tier copy: the nonzero blocks in host RAM, or the whole
    flat words when the entry is incompressible or all zero."""

    __slots__ = ("blocks", "idx", "shape", "n_blocks", "block_idx")

    def __init__(self, blocks, idx, shape, n_blocks, block_idx):
        self.blocks = blocks  # np.uint32[nb_padded, bw], or flat words
        self.idx = idx  # np.int32[nb_padded], or None = flat words
        self.shape = shape
        self.n_blocks = n_blocks
        self.block_idx = block_idx  # nonzero-block index (or None)

    @property
    def nbytes(self) -> int:
        n = int(self.blocks.nbytes)
        if self.idx is not None:
            n += int(self.idx.nbytes)
        return n


def _padded_index(block_idx: np.ndarray) -> np.ndarray:
    """The real block indices padded to a power of two by repeating the
    first (an all-zero entry pads with block 0, whose words are zero)."""
    nb = len(block_idx)
    idx = np.full(next_pow2(nb), block_idx[0] if nb else 0, np.int32)
    idx[:nb] = block_idx
    return idx


class DeviceRowCache:
    """Byte-budgeted three-tier LRU of device tensors with write-patched
    entries: dense, compressed on the card, compressed in host RAM."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 device="cpu",
                 host_budget_bytes: int = DEFAULT_HOST_BUDGET_BYTES):
        self.budget_bytes = int(budget_bytes)
        self.host_budget_bytes = int(host_budget_bytes)
        self.device = torch.device(device)
        self._rows: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        # nonzero-block index of each dense entry, from its host words at
        # insert (np.int32, ascending), or None: incompressible or patched
        self._block_idx: dict[tuple, np.ndarray | None] = {}
        self._compressed: OrderedDict[tuple, _CompressedEntry] = \
            OrderedDict()
        self._host: OrderedDict[tuple, _HostEntry] = OrderedDict()
        self._bytes = 0
        self._compressed_bytes = 0
        self._host_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compressions = 0
        self.decompressions = 0
        self.host_hits = 0  # host-tier lookups served (inline promotes)
        self.tier_promotions = 0  # host -> dense (lookup or pass)
        self.tier_demotions = 0  # dense/compressed -> host
        self.updates = 0
        self.write_events = 0
        # device-to-host bytes of the demotions to the host tier (not one
        # of the reference's metrics)
        self.readback_bytes = 0
        # derived-entry dependency registry: key -> (tag, probe); tag ->
        # keys. apply_write routes each fragment mutation to exactly the
        # entries registered under its (scope, index, field) tag.
        self._updaters: dict[tuple, tuple[tuple, Callable]] = {}
        self._tag_index: dict[tuple, set[tuple]] = {}
        self._patch_listeners: list = []
        # Snapshot validity counter: bumped wherever the reference bumps
        # its own (an entry removed or a dense entry written: write patch,
        # invalidate, evict, demote, clear), never on an addition. Holders
        # of (key -> tensor) snapshots taken outside the cache (the
        # executor's operand memo) serve them only while it is unchanged;
        # listeners, weakly held zero-argument callables, run on every
        # bump so an evicted or demoted leaf's memory is freed at once.
        self.generation = 0
        self._gen_listeners: list = []
        # One lock for all bookkeeping; writers patch under it. Host
        # decodes run outside it (get_or_build).
        self._lock = threading.RLock()
        # in-flight builds: key -> buffered write events, replayed onto
        # the entry after its unlocked decode
        self._pending_builds: dict[tuple, list] = {}
        self._build_done = threading.Condition(self._lock)
        # K3 patches collected in write order, (leaf, WordPatch), and the
        # per-thread depth of open batch_writes() scopes
        self._patches: list = []
        self._scope = threading.local()

    def __len__(self) -> int:
        return len(self._rows) + len(self._compressed)

    @property
    def bytes_used(self) -> int:
        return self._bytes + self._compressed_bytes

    @property
    def compressed_bytes(self) -> int:
        return self._compressed_bytes

    @property
    def host_bytes(self) -> int:
        return self._host_bytes

    def touch(self, keys) -> None:
        """Refresh LRU positions without fetching."""
        with self._lock:
            for key in keys:
                if key in self._rows:
                    self._rows.move_to_end(key)
                elif key in self._compressed:
                    self._compressed.move_to_end(key)

    def add_generation_listener(self, fn) -> None:
        """Register a bound method called (under the cache lock) on every
        generation bump; held weakly. Listeners must be lock-free and
        cheap (the executor's clears a dict)."""
        with self._lock:
            self._gen_listeners.append(weakref.WeakMethod(fn))

    def remove_generation_listener(self, fn) -> None:
        """Unregister ``fn`` (and drop dead references)."""
        with self._lock:
            live = []
            for ref in self._gen_listeners:
                cb = ref()  # bind once: a second ref() could race GC
                if cb is not None and cb != fn:
                    live.append(ref)
            self._gen_listeners = live

    def _bump_generation(self) -> None:
        """Caller holds the lock: bump, and notify snapshot holders."""
        self.generation += 1
        if self._gen_listeners:
            live = []
            for ref in self._gen_listeners:
                cb = ref()
                if cb is not None:
                    cb()
                    live.append(ref)
            self._gen_listeners = live

    def add_patch_listener(self, fn) -> None:
        """Register a bound method called as ``fn(tensor)`` (under the
        cache lock) right before ``tensor`` is patched in place; held
        weakly so registrants can be garbage-collected. A promoted entry
        is a new tensor, so a listener never confuses it with the one a
        demotion left to its holders."""
        with self._lock:
            self._patch_listeners.append(weakref.WeakMethod(fn))

    def _before_patch(self, arr: torch.Tensor) -> None:
        live = []
        for ref in self._patch_listeners:
            cb = ref()
            if cb is not None:
                cb(arr)
                live.append(ref)
        self._patch_listeners = live

    @contextlib.contextmanager
    def batch_writes(self):
        """One write request's scope: the K3 patches its writes collect
        launch together when the outermost scope of this thread closes
        (before the request's acknowledgement)."""
        depth = getattr(self._scope, "depth", 0)
        self._scope.depth = depth + 1
        try:
            yield
        finally:
            self._scope.depth = depth
            if depth == 0:
                with self._lock:
                    self._flush_patches_locked()

    def _flush_patches_locked(self) -> None:
        if not self._patches:
            return
        patches, self._patches = self._patches, []
        for targets in merge_word_patches(patches):
            kernels.word_patch_batch(targets)

    def _route_locked(self, key: tuple, apply) -> None:
        """Collect a K3 patch of the dense entry ``key``, or run a host
        row decode (after the patches collected before it, to keep the
        writes' order). The entry's occupancy may change: it is dropped,
        not compressed, when it is evicted later."""
        arr = self._rows[key]
        self._block_idx[key] = None
        self._before_patch(arr)
        if isinstance(apply, WordPatch):
            self._patches.append((arr, apply))
        else:
            self._flush_patches_locked()
            apply(arr)
        self.updates += 1

    def _lookup_locked(self, key: tuple):
        """Dense hit, or promotion from the compressed or host tier (one
        K11 launch); None on a miss."""
        self._flush_patches_locked()  # a read sees every collected write
        arr = self._rows.get(key)
        if arr is not None:
            self.hits += 1
            self._rows.move_to_end(key)
            return arr
        centry = self._compressed.pop(key, None)
        if centry is not None:
            self.hits += 1
            self.decompressions += 1
            self._compressed_bytes -= centry.nbytes
            arr = kernels.block_scatter(
                centry.blocks, centry.idx, centry.n_blocks,
                centry.block_idx).view(centry.shape)
            self._insert_dense(key, arr, centry.block_idx)
            return arr
        hentry = self._host.pop(key, None)
        if hentry is not None:
            # the access is the heat: upload, scatter and promote inline;
            # the updaters stayed registered across the demotion
            self.hits += 1
            self.host_hits += 1
            self.tier_promotions += 1
            self._host_bytes -= hentry.nbytes
            arr = self._upload_host_entry(hentry)
            self._insert_dense(key, arr, hentry.block_idx)
            return arr
        return None

    def _put_locked(self, key: tuple, host: np.ndarray) -> torch.Tensor:
        arr = upload(host, self.device)
        self._insert_dense(key, arr, self._host_block_index(host))
        cost = current_cost()
        if cost is not None:  # host-to-device bytes of the request
            cost.note_upload(_nbytes(arr))
        return arr

    def get_row(self, key: tuple, decode: Callable[[], np.ndarray]
                ) -> torch.Tensor:
        """The device tensor for ``key``, decoding+uploading on a miss."""
        cost = current_cost()
        with self._lock:
            arr = self._lookup_locked(key)
            if arr is not None:
                if cost is not None:
                    cost.note_cache(True)
                return arr
            self.misses += 1
            if cost is not None:
                cost.note_cache(False)
            return self._put_locked(key, decode())

    def get_or_build(self, key: tuple, tag: tuple, probe: Callable,
                     decode: Callable[[], np.ndarray]) -> torch.Tensor:
        """get_row for derived (write-patched) entries.

        On a miss the builder registers the probe (from the ``probe``
        factory) and claims the key BEFORE decoding, so writes landing
        during the unlocked host decode are buffered and replayed as
        patches after the upload; concurrent builders of one key wait for
        the first. Delta patches are idempotent, so an event the decode
        already saw replays harmlessly."""
        cost = current_cost()
        with self._lock:
            while True:
                arr = self._lookup_locked(key)
                if arr is not None:
                    self._register_locked(key, tag, probe)
                    if cost is not None:
                        cost.note_cache(True)
                    return arr
                if key not in self._pending_builds:
                    break
                self._build_done.wait()
            if cost is not None:
                cost.note_cache(False)
            buf: list = []
            self._pending_builds[key] = buf
            self._updaters[key] = (tag, probe())
            self._tag_index.setdefault(tag, set()).add(key)
        try:
            host = decode()
        except BaseException:
            with self._lock:
                self._pending_builds.pop(key, None)
                self._drop_updater(key)
                self._build_done.notify_all()
            raise
        with self._lock:
            try:
                self.misses += 1
                reg = self._updaters.get(key)
                if reg is None:
                    # invalidate_tag raced the build: serve the decode to
                    # this query but don't cache it
                    return upload(host, self.device)
                arr = self._put_locked(key, host)
                for ev in buf:  # replay writes that landed mid-decode
                    apply = reg[1](ev)
                    if apply is not None and key in self._rows:
                        self._route_locked(key, apply)
                self._flush_patches_locked()
                return arr
            finally:
                self._pending_builds.pop(key, None)
                self._build_done.notify_all()

    @staticmethod
    def _host_block_index(host: np.ndarray):
        """Nonzero-block indices from the host words at insert, so a
        demotion needs no read back from the card. None: incompressible
        (over half the blocks nonzero, or not whole uint32 blocks)."""
        if host.dtype != np.uint32 or host.size % COMPRESS_BLOCK_WORDS:
            return None
        # a block's largest 64-bit word is not zero: the fastest exact
        # test numpy has (about 7 ms for a 1024-shard leaf's 128 MiB)
        mask = np.ascontiguousarray(host).view(np.uint64).reshape(
            -1, COMPRESS_BLOCK_WORDS // 2).max(axis=1) != 0
        if mask.mean() > COMPRESS_MAX_OCCUPANCY:
            return None
        return np.flatnonzero(mask).astype(np.int32)

    def _insert_dense(self, key: tuple, arr: torch.Tensor,
                      block_idx) -> None:
        self._rows[key] = arr
        self._block_idx[key] = block_idx
        self._bytes += _nbytes(arr)
        self._evict()

    def register_updater(self, key: tuple, tag: tuple,
                         probe: Callable) -> None:
        """Attach a write-routing probe to a resident entry: ``probe(event)``
        returns None when the write does not touch the entry, else its
        patch (a ``WordPatch`` or an in-place ``apply(arr)``). A no-op for
        a key in neither device tier."""
        with self._lock:
            self._register_locked(key, tag, lambda: probe)

    def _register_locked(self, key: tuple, tag: tuple, probe_factory) -> None:
        if key in self._rows or key in self._compressed:
            old = self._updaters.get(key)
            if old is not None and old[0] == tag:
                return
            if old is not None:
                self._tag_index[old[0]].discard(key)
            self._updaters[key] = (tag, probe_factory())
            self._tag_index.setdefault(tag, set()).add(key)

    def invalidate(self, key: tuple) -> None:
        """Drop ``key`` from every tier (a write a copy cannot take)."""
        with self._lock:
            arr = self._rows.pop(key, None)
            if arr is not None:
                self._bytes -= _nbytes(arr)
            self._block_idx.pop(key, None)
            centry = self._compressed.pop(key, None)
            if centry is not None:
                self._compressed_bytes -= centry.nbytes
            hentry = self._host.pop(key, None)
            if hentry is not None:
                self._host_bytes -= hentry.nbytes
            if arr is not None or centry is not None or hentry is not None:
                self._bump_generation()
            self._drop_updater(key)

    def invalidate_fragment(self, frag_id: tuple) -> None:
        with self._lock:
            for store in (self._rows, self._compressed, self._host):
                for k in [k for k in store if k[: len(frag_id)] == frag_id]:
                    self.invalidate(k)

    def invalidate_tag(self, tag: tuple) -> None:
        """Drop every derived entry registered under a (scope, index,
        field) tag (field close/delete, bulk reload)."""
        with self._lock:
            for key in list(self._tag_index.get(tag, ())):
                self.invalidate(key)

    def invalidate_field(self, scope: str, index: str, field: str) -> None:
        """Drop every entry of a deleted field from every tier, and every
        updater registered for one: its per-fragment rows, the executor's
        stacked leaves and row matrices. A field re-created under the
        name starts cold."""
        def match(key: tuple) -> bool:
            if key and isinstance(key[0], str) and key[0].startswith(
                    "stack"):
                key = key[1:]
            return key[:3] == (scope, index, field)

        with self._lock:
            for store in (self._rows, self._compressed, self._host,
                          self._updaters):
                for key in [k for k in store if match(k)]:
                    self.invalidate(key)

    def _drop_updater(self, key: tuple) -> None:
        reg = self._updaters.pop(key, None)
        if reg is not None:
            keys = self._tag_index.get(reg[0])
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._tag_index[reg[0]]

    def apply_write(self, event: WriteEvent) -> None:
        """Route one fragment mutation to the derived entries that depend
        on it: dense entries are patched in place, compressed and host
        copies invalidated, everything else is untouched. Runs fully
        under the lock so concurrent writers can't lose each other's
        read-modify-write of a shared leaf."""
        tag = (event.scope, event.index, event.field)
        with self._lock:
            self.write_events += 1
            for key in list(self._tag_index.get(tag, ())):
                reg = self._updaters.get(key)
                if reg is None:
                    continue
                pending = self._pending_builds.get(key)
                if pending is not None:
                    pending.append(event)
                    continue
                apply = reg[1](event)
                if apply is None:
                    continue
                if key not in self._rows:
                    self.invalidate(key)
                    continue
                self._route_locked(key, apply)
                self._bump_generation()
            if getattr(self._scope, "depth", 0) == 0:
                self._flush_patches_locked()

    # ------------------------------------------------ host tier (tiering)

    def demote_fragment_to_host(self, scope: str, index: str, field: str,
                                shard: int) -> tuple[int, int]:
        """Move every per-fragment entry of one (scope, index, field,
        shard) to the host tier (the tierer's cold verdict). Returns
        (entries moved, device bytes freed). A reader between tiers
        re-decodes from the roaring files (the miss path)."""
        with self._lock:
            return self._demote_matching_locked(
                lambda k: self._frag_match(k, scope, index, field, shard))

    def demote_field_stacks_to_host(self, scope: str, index: str,
                                    field: str) -> tuple[int, int]:
        """Move the executor's stacked leaves of one field to the host
        tier (a leaf spans a whole shard block, so stacks tier at field
        granularity). The updaters stay registered: a write routed to a
        host-tier leaf invalidates it."""
        with self._lock:
            return self._demote_matching_locked(
                lambda k: self._stack_match(k, scope, index, field))

    @staticmethod
    def _frag_match(key: tuple, scope, index, field, shard) -> bool:
        # frag_id + (row,): (scope, index, field, view, shard, ...), never
        # a stack key (those lead with a "stack*" tag)
        return (len(key) >= 6 and key[0] == scope and key[1] == index
                and key[2] == field and isinstance(key[4], int)
                and key[4] == shard
                and not (isinstance(key[0], str)
                         and key[0].startswith("stack")))

    @staticmethod
    def _stack_match(key: tuple, scope, index, field) -> bool:
        # ("stack"/"stackp", scope, index, field, ...); the row matrices
        # ("stackm") and the shared zero leaf ("stackz") never tier
        return (len(key) >= 4 and key[0] in ("stack", "stackp")
                and key[1] == scope and key[2] == index
                and key[3] == field)

    def _demote_matching_locked(self, match) -> tuple[int, int]:
        self._flush_patches_locked()  # the copies hold every write
        moved = 0
        freed = 0
        dense = [(k, self._rows[k], self._block_idx.get(k))
                 for k in self._rows if match(k)]
        compact = self._gather_to_host_locked(
            [(k, arr, bi) for k, arr, bi in dense
             if bi is not None and len(bi)])
        for key, arr, block_idx in dense:
            del self._rows[key]
            self._block_idx.pop(key, None)
            self._bytes -= _nbytes(arr)
            freed += _nbytes(arr)
            moved += 1
            self._bump_generation()
            shape = tuple(arr.shape)
            if key in compact:
                blocks, idx_host = compact[key]
                hentry = _HostEntry(blocks, idx_host, shape,
                                    arr.numel() // COMPRESS_BLOCK_WORDS,
                                    block_idx)
                self._host[key] = hentry
                self._host_bytes += hentry.nbytes
                continue
            # the read back to host RAM, under the lock as the reference's
            host = arr.cpu().numpy().view(np.uint32).reshape(-1)
            self.readback_bytes += host.nbytes
            if block_idx is None:
                # a patched entry lost its block index: recompute it
                block_idx = self._host_block_index(host)
            self._host_insert_locked(key, host, shape, block_idx)
        for key in [k for k in self._compressed if match(k)]:
            centry = self._compressed.pop(key)
            self._compressed_bytes -= centry.nbytes
            freed += centry.nbytes
            self._bump_generation()
            words = centry.words.cpu().numpy()
            n = words.size // (COMPRESS_BLOCK_WORDS + 1)
            hentry = _HostEntry(
                words[:n * COMPRESS_BLOCK_WORDS].view(np.uint32).reshape(
                    n, COMPRESS_BLOCK_WORDS),
                words[n * COMPRESS_BLOCK_WORDS:], centry.shape,
                centry.n_blocks, centry.block_idx)
            self.readback_bytes += hentry.nbytes
            self._host[key] = hentry
            self._host_bytes += hentry.nbytes
            moved += 1
        if moved:
            self.tier_demotions += moved
            self._evict_host_locked()
        return moved, freed

    def _gather_to_host_locked(self, entries) -> dict:
        """The compact blocks of ``(key, dense tensor, block index)``
        entries on the host: one K10 launch gathers them all into one
        buffer on the card, read back once, so only their blocks cross
        to the host. Returns ``{key: (uint32 blocks, padded index)}``,
        each array its own."""
        if not entries:
            return {}
        idxs = [_padded_index(bi) for _, _, bi in entries]
        bw = COMPRESS_BLOCK_WORDS
        buf = torch.empty(sum(i.size for i in idxs) * bw, dtype=torch.int32,
                          device=self.device)
        outs, at = [], 0
        for i in idxs:
            outs.append(buf[at:at + i.size * bw])
            at += i.size * bw
        kernels.block_gather_batch([arr.reshape(-1) for _, arr, _ in entries],
                                   idxs, outs)
        host = buf.cpu().numpy().view(np.uint32)
        self.readback_bytes += host.nbytes
        compact, at = {}, 0
        for (key, _, _), i in zip(entries, idxs):
            compact[key] = (host[at:at + i.size * bw].reshape(i.size, bw)
                            .copy(), i)
            at += i.size * bw
        return compact

    def _host_insert_locked(self, key: tuple, flat_host: np.ndarray,
                            shape, block_idx) -> None:
        if block_idx is not None and len(block_idx):
            idx_host = _padded_index(block_idx)
            blocks = flat_host.reshape(-1, COMPRESS_BLOCK_WORDS)[idx_host]
            hentry = _HostEntry(blocks, idx_host, shape,
                                flat_host.size // COMPRESS_BLOCK_WORDS,
                                block_idx)
        else:
            # incompressible or all zero: the whole flat words (host RAM
            # is the cheap tier)
            hentry = _HostEntry(flat_host.copy(), None, shape, 0, block_idx)
        self._host[key] = hentry
        self._host_bytes += hentry.nbytes

    def _upload_host_entry(self, hentry: _HostEntry) -> torch.Tensor:
        """Host -> device for one host-tier entry: the compact blocks go
        up and one K11 launch scatters them to the dense shape (the whole
        words go up as they are when there is no block index). The
        request's cost context is given the bytes that cross, the blocks
        and their index, where the reference notes the dense size."""
        cost = current_cost()
        if hentry.idx is None:
            arr = upload(hentry.blocks.reshape(hentry.shape), self.device)
            if cost is not None:
                cost.note_upload(_nbytes(arr))
            return arr
        if cost is not None:
            cost.note_upload(int(hentry.blocks.nbytes + hentry.idx.nbytes))
        blocks = _upload_async(hentry.blocks.view(np.int32), self.device)
        idx = _upload_async(hentry.idx, self.device)
        return kernels.block_scatter(blocks, idx, hentry.n_blocks,
                                     hentry.block_idx).view(hentry.shape)

    def promote_key(self, key: tuple) -> int:
        """The tierer's promotion of one host-tier entry back to dense;
        returns the host bytes freed, 0 when the key is no longer in the
        host tier (a query's lookup promoted it first)."""
        with self._lock:
            hentry = self._host.pop(key, None)
            if hentry is None:
                return 0
            self._host_bytes -= hentry.nbytes
            self.tier_promotions += 1
            arr = self._upload_host_entry(hentry)
            self._insert_dense(key, arr, hentry.block_idx)
            return int(hentry.nbytes)

    def host_keys_of(self, scope: str, index: str, field: str,
                     shard: int) -> list:
        """(key, nbytes) of the host-tier entries of one fragment."""
        with self._lock:
            return [(k, e.nbytes) for k, e in self._host.items()
                    if self._frag_match(k, scope, index, field, shard)]

    def host_stack_keys_of(self, scope: str, index: str,
                           field: str) -> list:
        with self._lock:
            return [(k, e.nbytes) for k, e in self._host.items()
                    if self._stack_match(k, scope, index, field)]

    def _evict_host_locked(self) -> None:
        # LRU within the host tier's own budget
        while self._host_bytes > self.host_budget_bytes and self._host:
            key, hentry = self._host.popitem(last=False)
            self._host_bytes -= hentry.nbytes
            self.evictions += 1
            self._drop_updater(key)

    def residency_overlay(self) -> tuple[dict, dict]:
        """Device bytes for the heat map (``/debug/heatmap``):
        ``(per_fragment, per_field)``, exact bytes per (scope, index,
        field, shard) for per-fragment entries and (scope, index, field)
        totals for the stacked leaves (one spans a whole shard block).
        Dense and compressed entries count; the host tier is not on the
        card."""
        with self._lock:
            items = [(k, _nbytes(a)) for k, a in self._rows.items()]
            items += [(k, e.nbytes) for k, e in self._compressed.items()]
        per_frag: dict[tuple, int] = {}
        per_field: dict[tuple, int] = {}
        for key, nbytes in items:
            tag = key[0]
            if isinstance(tag, str) and tag.startswith("stack"):
                if len(key) >= 4 and tag != "stackz":
                    fkey = (key[1], key[2], key[3])
                    per_field[fkey] = per_field.get(fkey, 0) + int(nbytes)
                continue
            if len(key) >= 6 and isinstance(key[4], int):
                fkey = (key[0], key[1], key[2], key[4])
                per_frag[fkey] = per_frag.get(fkey, 0) + int(nbytes)
        return per_frag, per_field

    def tier_overlay(self) -> tuple[dict, dict]:
        """The tierer's view: ``(per_fragment, per_field_stacks)``, bytes
        by tier keyed (scope, index, field, shard) for per-fragment
        entries and (scope, index, field) for the stacked leaves. Row
        matrices and zero leaves are left out (never tiered)."""
        with self._lock:
            stores = (("dense", self._rows, _nbytes),
                      ("compressed", self._compressed, lambda e: e.nbytes),
                      ("host", self._host, lambda e: e.nbytes))
            per_frag: dict[tuple, dict] = {}
            per_stack: dict[tuple, dict] = {}
            for tier, store, size in stores:
                for key, entry in store.items():
                    tag = key[0]
                    if isinstance(tag, str) and tag.startswith("stack"):
                        # first: a plane-stack key is len 6 with an int at
                        # [4] and would pass for a fragment entry
                        if tag not in ("stack", "stackp") or len(key) < 4:
                            continue
                        out, okey = per_stack, (key[1], key[2], key[3])
                    elif len(key) >= 6 and isinstance(key[4], int):
                        out, okey = per_frag, (key[0], key[1], key[2],
                                               key[4])
                    else:
                        continue
                    slot = out.get(okey)
                    if slot is None:
                        slot = out[okey] = {"dense": 0, "compressed": 0,
                                            "host": 0}
                    slot[tier] += int(size(entry))
        return per_frag, per_stack

    def metrics(self) -> dict:
        """The reference's residency gauges and counters, by its names."""
        with self._lock:
            return {
                "residency_entries": len(self._rows) + len(self._compressed),
                "residency_entries_compressed": len(self._compressed),
                "residency_bytes_used": self.bytes_used,
                "residency_bytes_compressed": self._compressed_bytes,
                "residency_budget_bytes": self.budget_bytes,
                "residency_hits": self.hits,
                "residency_misses": self.misses,
                "residency_evictions": self.evictions,
                "residency_compressions": self.compressions,
                "residency_decompressions": self.decompressions,
                "residency_updates": self.updates,
                "residency_write_events": self.write_events,
                "residency_entries_host": len(self._host),
                "residency_bytes_host": self._host_bytes,
                "residency_host_budget_bytes": self.host_budget_bytes,
                "residency_host_hits": self.host_hits,
                "residency_tier_promotions": self.tier_promotions,
                "residency_tier_demotions": self.tier_demotions,
            }

    # the counters among metrics(): ``/metrics`` gives them ``_total``
    _MONOTONIC_METRICS = frozenset({
        "residency_hits", "residency_misses", "residency_evictions",
        "residency_compressions", "residency_decompressions",
        "residency_updates", "residency_write_events",
        "residency_host_hits", "residency_tier_promotions",
        "residency_tier_demotions",
    })

    def prometheus_lines(self, prefix: str = "pilosa_tpu",
                         seen: set | None = None) -> str:
        """metrics() as the reference's ``/metrics`` block: counters with
        the ``_total`` suffix, ints exact, each family with its ``# HELP``
        and ``# TYPE``."""
        return prometheus_block(
            {(f"{name}_total" if name in self._MONOTONIC_METRICS
              else name): v for name, v in self.metrics().items()},
            prefix, seen=seen)

    def clear(self) -> None:
        with self._lock:
            self._bump_generation()
            self._patches.clear()
            self._rows.clear()
            self._block_idx.clear()
            self._compressed.clear()
            self._host.clear()
            self._updaters.clear()
            self._tag_index.clear()
            self._bytes = 0
            self._compressed_bytes = 0
            self._host_bytes = 0

    def _evict(self) -> None:
        # Demotion only under real pressure: the dense tier may use the
        # whole budget while it fits. Over budget, LRU dense entries are
        # demoted (compressible) or dropped, the newest always staying;
        # then LRU compressed entries are dropped, the new ones after
        # the old. A compressed copy's bytes are known from its block
        # index, so every decision is made first, as the reference makes
        # it; the survivors are gathered in one K10 launch, then go in.
        demoted: OrderedDict = OrderedDict()  # key -> (dense, block index)
        pending = 0  # their compressed bytes
        while self.bytes_used + pending > self.budget_bytes \
                and len(self._rows) > 1:
            key, arr = self._rows.popitem(last=False)
            block_idx = self._block_idx.pop(key, None)
            self._bytes -= _nbytes(arr)
            self._bump_generation()
            if block_idx is not None:  # stays, compressed
                demoted[key] = (arr, block_idx)
                pending += _compressed_nbytes(block_idx)
                self.compressions += 1
            else:
                self.evictions += 1
                self._drop_updater(key)
        while self.bytes_used + pending > self.budget_bytes \
                and (self._compressed or demoted):
            if self._compressed:
                key, centry = self._compressed.popitem(last=False)
                self._compressed_bytes -= centry.nbytes
            else:
                key, (_, block_idx) = demoted.popitem(last=False)
                pending -= _compressed_nbytes(block_idx)
            self._bump_generation()
            self.evictions += 1
            self._drop_updater(key)
        if demoted:
            self._compress_locked(demoted)

    def _compress_locked(self, demoted: OrderedDict) -> None:
        """Dense -> compressed for ``{key: (dense tensor, block index)}``:
        one K10 launch gathers every entry's nonzero blocks (after the
        collected patches, so it reads the patched words) and its index
        into a tensor of its own; then the entries go in, in order. A
        queued micro-batch holding a dense tensor keeps it alive; K10
        only reads it."""
        self._flush_patches_locked()
        idxs = [_padded_index(bi) for _, bi in demoted.values()]
        flats = [arr.reshape(-1) for arr, _ in demoted.values()]
        stores = [f.new_empty(i.size * (COMPRESS_BLOCK_WORDS + 1))
                  for f, i in zip(flats, idxs)]
        kernels.block_gather_batch(flats, idxs, stores, with_index=True)
        for (key, (arr, block_idx)), words in zip(demoted.items(), stores):
            centry = _CompressedEntry(words, tuple(arr.shape),
                                      arr.numel() // COMPRESS_BLOCK_WORDS,
                                      block_idx)
            self._compressed[key] = centry
            self._compressed_bytes += centry.nbytes

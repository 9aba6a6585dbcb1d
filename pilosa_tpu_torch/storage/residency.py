"""Device residency: which stacked leaves live in device memory.

The port's copy of ``pilosa_tpu.storage.residency``, dense tier only: a
byte-budgeted LRU of device tensors (bytes counted as the tensors'
device bytes), keyed by the executor's leaf keys. The host roaring files
stay the source of truth; a miss decodes on the host and uploads.

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
writes across threads, so the leaves end as the host rows are. The
compressed and host tiers are not ported yet.
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

# Default device budget for resident leaves: 16 GiB of an 80 GB card.
DEFAULT_BUDGET_BYTES = 16 << 30


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceRowCache:
    """Byte-budgeted LRU of device tensors with write-patched entries."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 device="cpu"):
        self.budget_bytes = int(budget_bytes)
        self.device = torch.device(device)
        self._rows: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.updates = 0
        self.write_events = 0
        # derived-entry dependency registry: key -> (tag, probe); tag ->
        # keys. apply_write routes each fragment mutation to exactly the
        # entries registered under its (scope, index, field) tag.
        self._updaters: dict[tuple, tuple[tuple, Callable]] = {}
        self._tag_index: dict[tuple, set[tuple]] = {}
        self._patch_listeners: list = []
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

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def add_patch_listener(self, fn) -> None:
        """Register a bound method called as ``fn(tensor)`` (under the
        cache lock) right before ``tensor`` is patched in place; held
        weakly so registrants can be garbage-collected."""
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

    def _route_locked(self, arr: torch.Tensor, apply) -> None:
        """Collect a K3 patch of ``arr``, or run a host row decode (after
        the patches collected before it, to keep the writes' order)."""
        self._before_patch(arr)
        if isinstance(apply, WordPatch):
            self._patches.append((arr, apply))
        else:
            self._flush_patches_locked()
            apply(arr)
        self.updates += 1

    def _lookup_locked(self, key: tuple):
        self._flush_patches_locked()  # a read sees every collected write
        arr = self._rows.get(key)
        if arr is not None:
            self.hits += 1
            self._rows.move_to_end(key)
        return arr

    def _put_locked(self, key: tuple, host: np.ndarray) -> torch.Tensor:
        arr = upload(host, self.device)
        self._rows[key] = arr
        self._bytes += _nbytes(arr)
        self._evict()
        return arr

    def get_row(self, key: tuple, decode: Callable[[], np.ndarray]
                ) -> torch.Tensor:
        """The device tensor for ``key``, decoding+uploading on a miss."""
        with self._lock:
            arr = self._lookup_locked(key)
            if arr is not None:
                return arr
            self.misses += 1
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
        with self._lock:
            while True:
                arr = self._lookup_locked(key)
                if arr is not None:
                    self._register_locked(key, tag, probe)
                    return arr
                if key not in self._pending_builds:
                    break
                self._build_done.wait()
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
                        self._route_locked(arr, apply)
                self._flush_patches_locked()
                return arr
            finally:
                self._pending_builds.pop(key, None)
                self._build_done.notify_all()

    def _register_locked(self, key: tuple, tag: tuple, probe_factory) -> None:
        if key in self._rows:
            old = self._updaters.get(key)
            if old is not None and old[0] == tag:
                return
            if old is not None:
                self._tag_index[old[0]].discard(key)
            self._updaters[key] = (tag, probe_factory())
            self._tag_index.setdefault(tag, set()).add(key)

    def invalidate(self, key: tuple) -> None:
        with self._lock:
            arr = self._rows.pop(key, None)
            if arr is not None:
                self._bytes -= _nbytes(arr)
            self._drop_updater(key)

    def invalidate_fragment(self, frag_id: tuple) -> None:
        with self._lock:
            for k in [k for k in self._rows if k[: len(frag_id)] == frag_id]:
                self.invalidate(k)

    def invalidate_tag(self, tag: tuple) -> None:
        """Drop every derived entry registered under a (scope, index,
        field) tag (field close/delete, bulk reload)."""
        with self._lock:
            for key in list(self._tag_index.get(tag, ())):
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
        on it: resident entries are patched in place, everything else is
        untouched. Runs fully under the lock so concurrent writers can't
        lose each other's read-modify-write of a shared leaf."""
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
                self._route_locked(self._rows[key], apply)
            if getattr(self._scope, "depth", 0) == 0:
                self._flush_patches_locked()

    def clear(self) -> None:
        with self._lock:
            self._patches.clear()
            self._rows.clear()
            self._updaters.clear()
            self._tag_index.clear()
            self._bytes = 0

    def _evict(self) -> None:
        # LRU within the byte budget; the newest entry always stays
        while self._bytes > self.budget_bytes and len(self._rows) > 1:
            key, arr = self._rows.popitem(last=False)
            self._bytes -= _nbytes(arr)
            self.evictions += 1
            self._drop_updater(key)

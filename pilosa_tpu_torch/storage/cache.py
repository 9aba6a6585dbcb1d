"""Per-fragment row cache: (rowID → count), persisted beside the fragment.

The port's copy of ``pilosa_tpu.storage.cache`` (reference cache.go):
three kinds, ``ranked`` (bounded, sorted by count, default size 50k),
``lru`` and ``none``. TopN's phase 1 takes each fragment's candidates
from it (``Fragment.top``); every write path keeps it as the reference
keeps it, and a clean close saves it as the ``.cache`` sidecar, byte for
byte the reference's, so a data directory the port wrote opens in the
reference with its TopN candidates ranked. One fault of the reference is
not copied: its ``LRUCache`` loses its ``OrderedDict`` at load, so an
LRU field raises on its first write; the port's keeps it.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

DEFAULT_CACHE_SIZE = 50_000

# A ranked cache trims to max_size once it holds this much more.
_RANK_SLACK = 1.1


class RankCache:
    """Bounded map rowID → count keeping the highest-count rows."""

    kind = CACHE_TYPE_RANKED

    def __init__(self, max_size: int = DEFAULT_CACHE_SIZE):
        self.max_size = max_size
        self._counts: dict[int, int] = {}

    def bulk_add(self, row: int, count: int) -> None:
        if count <= 0:
            self._counts.pop(row, None)
            return
        self._counts[row] = count

    add = bulk_add

    def top(self):
        """All cached (row, count) pairs, highest count first (ties: lower
        row id first)."""
        self._trim()
        return sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def __len__(self):
        return len(self._counts)

    def _trim(self) -> None:
        if len(self._counts) <= self.max_size * _RANK_SLACK:
            return
        keep = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        self._counts = dict(keep[: self.max_size])

    # --- persistence ---

    def save(self, path: str) -> None:
        """Write the sidecar atomically: fsynced under a temporary name,
        renamed, the directory fsynced."""
        from pilosa_tpu_torch.storage.wal import fsync_dir

        self._trim()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"kind": self.kind, "counts": list(self._counts.items())}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(path) or ".")

    def load(self, path: str) -> bool:
        """Read the sidecar; False (and an empty cache) when it is missing
        or unreadable."""
        try:
            with open(path) as f:
                data = json.load(f)
            self._counts = {int(r): int(c) for r, c in data.get("counts", [])}
        except (OSError, ValueError):
            self._counts = {}
            return False
        return True


class LRUCache(RankCache):
    """LRU variant: recency-bounded instead of count-ranked."""

    kind = CACHE_TYPE_LRU

    def __init__(self, max_size: int = DEFAULT_CACHE_SIZE):
        super().__init__(max_size)
        self._counts = OrderedDict()

    def bulk_add(self, row: int, count: int) -> None:
        if count <= 0:
            self._counts.pop(row, None)
            return
        self._counts[row] = count
        self._counts.move_to_end(row)
        while len(self._counts) > self.max_size:
            self._counts.popitem(last=False)

    add = bulk_add

    def _trim(self) -> None:
        pass

    def load(self, path: str) -> bool:
        ok = super().load(path)
        self._counts = OrderedDict(self._counts)  # recency order: the file's
        return ok


class NoneCache(RankCache):
    """Disabled cache (fields that never serve TopN)."""

    kind = CACHE_TYPE_NONE

    def bulk_add(self, row: int, count: int) -> None:
        pass

    add = bulk_add

    def top(self):
        return []

    def save(self, path: str) -> None:
        pass

    def load(self, path: str) -> bool:
        return True  # nothing is ever saved


def new_row_cache(kind: str, size: int = DEFAULT_CACHE_SIZE):
    if kind == CACHE_TYPE_RANKED:
        return RankCache(size)
    if kind == CACHE_TYPE_LRU:
        return LRUCache(size)
    if kind == CACHE_TYPE_NONE:
        return NoneCache(size)
    raise ValueError(f"unknown cache type {kind!r}")

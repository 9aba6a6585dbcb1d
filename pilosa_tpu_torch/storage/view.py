"""Views: named fragment groups within a field (reference view.go).

The port's thin copy of ``pilosa_tpu.storage.view``: the same directory
layout (``views/<name>/fragments/<shard>``). The ``standard`` view holds
set rows and ``bsig_<field>`` an int field's bit planes; other views on
disk (time quanta) are opened and left alone.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch.storage.cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE
from pilosa_tpu_torch.storage.fragment import Fragment

VIEW_STANDARD = "standard"


def view_name_bsi(field_name: str) -> str:
    return f"bsig_{field_name}"


def _each(fn, frags: list) -> None:
    """``fn`` on every fragment, in up to 8 threads."""
    workers = min(8, os.cpu_count() or 1, len(frags))
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(fn, frags))
    else:
        for frag in frags:
            fn(frag)


class View:
    def __init__(self, path: str, index: str, field: str, name: str,
                 scope: str = "", cache=None,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 verify_on_load: bool = False, wal=None):
        self.path = path  # .../views/<name>
        self.index = index
        self.field = field
        self.name = name
        self.scope = scope
        self.cache = cache
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.verify_on_load = verify_on_load
        self.wal = wal
        self.fragments: dict[int, Fragment] = {}
        # serializes first-write fragment creation: two writers racing an
        # unlocked check-then-create would get distinct Fragment objects
        # for one file and one writer's bits would vanish
        self._create_lock = threading.Lock()

    def _new_fragment(self, shard: int) -> Fragment:
        return Fragment(os.path.join(self.path, "fragments", str(shard)),
                        self.index, self.field, self.name, shard,
                        scope=self.scope, cache=self.cache,
                        cache_type=self.cache_type,
                        cache_size=self.cache_size,
                        verify_on_load=self.verify_on_load, wal=self.wal)

    def open(self) -> "View":
        """Open every fragment file, several at once: verifying a
        snapshot's digests is numpy and hashlib work that runs outside
        the GIL."""
        frag_dir = os.path.join(self.path, "fragments")
        os.makedirs(frag_dir, exist_ok=True)
        frags = [self._new_fragment(int(entry))
                 for entry in sorted(os.listdir(frag_dir)) if entry.isdigit()]
        _each(Fragment.open, frags)
        self.fragments.update((f.shard, f) for f in frags)
        return self

    def close(self) -> None:
        """Close every fragment, several at once: in group mode each dirty
        one snapshots and digests its bit ids."""
        _each(Fragment.close, list(self.fragments.values()))

    def fragment(self, shard: int, create: bool = False) -> Fragment | None:
        frag = self.fragments.get(shard)
        if frag is None and create:
            with self._create_lock:
                frag = self.fragments.get(shard)
                if frag is None:
                    frag = self._new_fragment(shard).open()
                    self.fragments[shard] = frag
        return frag

    def available_shards(self) -> list[int]:
        return sorted(self.fragments)

"""Holder: root of the storage tree, owns the data directory (reference holder.go).

The port's thin copy of ``pilosa_tpu.storage.holder``. It opens the same
directory layout, so a data directory written by either package opens in
the other. The holder owns the write-ahead log every fragment logs
through (``storage/wal.py``): ``durability_mode`` selects group commit
(the default), per-op fsync or flush-only, and ``open()`` replays the
segments a crash left behind, whichever package wrote them, before
serving. It also owns the device residency cache that every fragment
reports its writes to (``budget_bytes`` on the card, ``host_budget_bytes``
for its host tier), the key translation log ``.translate.log``
(``storage/translate.py``) of every keyed index and field, and the
``StorageHealth`` latch (``health``) that disk faults trip.
"""

from __future__ import annotations

import os
import shutil
import threading

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.storage.index import (
    Index,
    _rename_to_trash,
    _validate_name,
)
from pilosa_tpu_torch.storage.integrity import StorageHealth
from pilosa_tpu_torch.storage.residency import (
    DEFAULT_BUDGET_BYTES,
    DEFAULT_HOST_BUDGET_BYTES,
    DeviceRowCache,
)
from pilosa_tpu_torch.storage.translate import TranslateStore
from pilosa_tpu_torch.storage.wal import (
    DEFAULT_GROUP_MAX_MS,
    DEFAULT_GROUP_MAX_OPS,
    MODE_GROUP,
    WriteAheadLog,
)


class Holder:
    def __init__(self, data_dir: str, device=None,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 verify_on_load: bool = True,
                 durability_mode: str = MODE_GROUP,
                 group_commit_max_ms: float = DEFAULT_GROUP_MAX_MS,
                 group_commit_max_ops: int = DEFAULT_GROUP_MAX_OPS,
                 host_budget_bytes: int = DEFAULT_HOST_BUDGET_BYTES):
        self.data_dir = os.path.expanduser(data_dir)
        # every fragment's snapshot is checked against its .checksums
        # sidecar on open (the reference holder's default)
        self.verify_on_load = bool(verify_on_load)
        # the disk-fault latch (storage/integrity.py): a failed WAL
        # fsync, snapshot or .meta write makes the node read-only until
        # a probe write into the data dir succeeds
        self.health = StorageHealth(probe_dir=self.data_dir)
        self.wal = WriteAheadLog(os.path.join(self.data_dir, ".wal"),
                                 mode=durability_mode,
                                 group_max_ms=group_commit_max_ms,
                                 group_max_ops=group_commit_max_ops)
        self.wal.health = self.health
        self.health.on_clear(self.wal.clear_fault)
        self.device = device_mod.resolve(device)
        self.cache = DeviceRowCache(budget_bytes, self.device,
                                    host_budget_bytes=host_budget_bytes)
        self.indexes: dict[str, Index] = {}
        self._create_lock = threading.Lock()
        self.translate: TranslateStore | None = None  # opened in open()

    def _index(self, path: str, name: str, **kw) -> Index:
        return Index(path, name, cache=self.cache, wal=self.wal,
                     verify_on_load=self.verify_on_load, **kw).open()

    def open(self) -> "Holder":
        os.makedirs(self.data_dir, exist_ok=True)
        self.translate = TranslateStore(
            os.path.join(self.data_dir, ".translate.log")).open()
        for entry in sorted(os.listdir(self.data_dir)):
            p = os.path.join(self.data_dir, entry)
            if entry.startswith(".trash-"):
                # a reference delete_index crashed between rename and rmtree
                shutil.rmtree(p, ignore_errors=True)
            elif os.path.isdir(p) and not entry.startswith("."):
                self.indexes[entry] = self._index(p, entry)
        # replay the acknowledged but unsnapshotted ops a crash left in
        # the WAL (in any mode), snapshot what they touched, start afresh
        self.wal.recover(self)
        self.wal.start()
        return self

    def close(self) -> None:
        # the probe first: its clear_fault must not open a WAL segment
        # under the close
        self.health.close()
        for idx in list(self.indexes.values()):
            idx.close()  # group mode: dirty fragments snapshot here
        if self.translate:
            self.translate.close()
        # every fragment snapshotted: the WAL truncates to nothing (a
        # failed snapshot leaves its segment for the next recover())
        self.wal.close()
        self.cache.clear()

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Index:
        with self._create_lock:
            if name in self.indexes:
                raise ValueError(f"index {name!r} already exists")
            _validate_name(name)
            idx = self._index(os.path.join(self.data_dir, name), name,
                              keys=keys, track_existence=track_existence)
            self.indexes[name] = idx
            return idx

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def delete_index(self, name: str) -> None:
        """Rename-then-tombstone (``Index.delete_field``'s order): the
        index leaves the tree in one rename, the durable tombstone of its
        prefix keeps replay from resurrecting its ops, then the files go
        and every residency entry of the index leaves the cache."""
        idx = self.indexes.pop(name, None)
        if idx is None:
            raise KeyError(f"index {name!r} not found")
        trash = _rename_to_trash(idx.path, self.data_dir, name)
        self.wal.tombstone(f"{name}/")
        self.wal.barrier()
        idx.close(discard=True)
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)

    def schema(self) -> list[dict]:
        return [idx.schema() for _, idx in sorted(self.indexes.items())]

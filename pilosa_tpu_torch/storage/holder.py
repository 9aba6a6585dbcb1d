"""Holder: root of the storage tree, owns the data directory (reference holder.go).

The port's thin copy of ``pilosa_tpu.storage.holder``. It opens the same
directory layout, so a data directory written by either package opens in
the other once the writer has closed it cleanly (the reference's
group-commit WAL is empty after a clean close; this package does not
replay WAL segments, and refuses a directory that still holds some). The
holder owns the device residency cache that every fragment reports its
writes to.
"""

from __future__ import annotations

import os
import threading

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.storage.index import Index, _validate_name
from pilosa_tpu_torch.storage.residency import (
    DEFAULT_BUDGET_BYTES,
    DeviceRowCache,
)


def _wal_has_ops(data_dir: str) -> bool:
    wal = os.path.join(data_dir, ".wal")
    if not os.path.isdir(wal):
        return False
    return any(os.path.getsize(os.path.join(wal, f)) > 0
               for f in os.listdir(wal)
               if os.path.isfile(os.path.join(wal, f)))


class Holder:
    def __init__(self, data_dir: str, device=None,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 verify_on_load: bool = True):
        self.data_dir = os.path.expanduser(data_dir)
        # every fragment's snapshot is checked against its .checksums
        # sidecar on open (the reference holder's default)
        self.verify_on_load = bool(verify_on_load)
        self.device = device_mod.resolve(device)
        self.cache = DeviceRowCache(budget_bytes, self.device)
        self.indexes: dict[str, Index] = {}
        self._create_lock = threading.Lock()

    def open(self) -> "Holder":
        os.makedirs(self.data_dir, exist_ok=True)
        if _wal_has_ops(self.data_dir):
            raise RuntimeError(
                f"{self.data_dir} holds unreplayed write-ahead-log segments; "
                "open and close it with pilosa_tpu first")
        for entry in sorted(os.listdir(self.data_dir)):
            p = os.path.join(self.data_dir, entry)
            if os.path.isdir(p) and not entry.startswith("."):
                self.indexes[entry] = Index(
                    p, entry, cache=self.cache,
                    verify_on_load=self.verify_on_load).open()
        return self

    def close(self) -> None:
        for idx in list(self.indexes.values()):
            idx.close()
        self.cache.clear()

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Index:
        if keys:
            raise ValueError("index keys are not yet ported")
        with self._create_lock:
            if name in self.indexes:
                raise ValueError(f"index {name!r} already exists")
            _validate_name(name)
            idx = Index(os.path.join(self.data_dir, name), name,
                        track_existence=track_existence, cache=self.cache,
                        verify_on_load=self.verify_on_load).open()
            self.indexes[name] = idx
            return idx

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

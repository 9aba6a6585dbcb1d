"""Field: a named boolean matrix with a schema (reference field.go).

The port's thin copy of ``pilosa_tpu.storage.field``. The ``.meta`` file
and the view layout are the reference's, so every field type on disk
opens; this slice writes and queries ``set`` fields in the standard view
only, and refuses the other types.
"""

from __future__ import annotations

import json
import os
import threading

from pilosa_tpu_torch.shardwidth import position, shard_of
from pilosa_tpu_torch.storage.fragment import fsync_dir
from pilosa_tpu_torch.storage.view import VIEW_STANDARD, View

TYPE_SET = "set"
FIELD_TYPES = ("set", "int", "time", "mutex", "bool")
CACHE_TYPE_RANKED = "ranked"
DEFAULT_CACHE_SIZE = 50_000


class FieldOptions:
    """Field schema, serialized exactly as the reference's ``.meta``."""

    def __init__(self, type: str = TYPE_SET,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE, min: int = 0,
                 max: int = 0, time_quantum: str = "", keys: bool = False):
        if type not in FIELD_TYPES:
            raise ValueError(f"invalid field type {type!r}")
        self.type = type
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.min = min
        self.max = max
        self.time_quantum = time_quantum
        self.keys = keys

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "min": self.min,
            "max": self.max,
            "timeQuantum": self.time_quantum,
            "keys": self.keys,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FieldOptions":
        return cls(
            type=d.get("type", TYPE_SET),
            cache_type=d.get("cacheType", CACHE_TYPE_RANKED),
            cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
            min=d.get("min", 0),
            max=d.get("max", 0),
            time_quantum=d.get("timeQuantum", ""),
            keys=d.get("keys", False),
        )

    def check_ported(self) -> None:
        """Raise for the schema features this slice cannot serve."""
        if self.type != TYPE_SET:
            raise ValueError(f"field type {self.type!r} is not yet ported")
        if self.keys:
            raise ValueError("field keys are not yet ported")


class Field:
    def __init__(self, path: str, index: str, name: str,
                 options: FieldOptions | None = None, scope: str = "",
                 cache=None):
        self.path = path
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.scope = scope
        self.cache = cache
        self.views: dict[str, View] = {}
        self._create_lock = threading.Lock()

    def open(self) -> "Field":
        os.makedirs(self.path, exist_ok=True)
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                self.options = FieldOptions.from_dict(json.load(f))
        else:
            self._save_meta()
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for name in sorted(os.listdir(views_dir)):
                self.views[name] = self._new_view(name).open()
        return self

    def close(self) -> None:
        for v in list(self.views.values()):
            v.close()
        if self.cache is not None:
            self.cache.invalidate_tag((self.scope, self.index, self.name))

    def _new_view(self, name: str) -> View:
        return View(os.path.join(self.path, "views", name), self.index,
                    self.name, name, scope=self.scope, cache=self.cache)

    def _save_meta(self) -> None:
        meta = os.path.join(self.path, ".meta")
        with open(meta, "w") as f:
            json.dump(self.options.to_dict(), f)
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(self.path)
        fsync_dir(os.path.dirname(self.path) or ".")

    def view(self, name: str, create: bool = False) -> View | None:
        v = self.views.get(name)
        if v is None and create:
            with self._create_lock:
                v = self.views.get(name)
                if v is None:
                    v = self._new_view(name).open()
                    self.views[name] = v
        return v

    def available_shards(self) -> list[int]:
        shards: set[int] = set()
        for v in list(self.views.values()):
            shards.update(v.available_shards())
        return sorted(shards)

    def set_bit(self, row: int, column: int) -> bool:
        self.options.check_ported()
        frag = self.view(VIEW_STANDARD, create=True).fragment(
            shard_of(column), create=True)
        return frag.set_bit(row, position(column))

    def clear_bit(self, row: int, column: int) -> bool:
        self.options.check_ported()
        changed = False
        for v in list(self.views.values()):
            frag = v.fragment(shard_of(column))
            if frag is not None:
                changed |= frag.clear_bit(row, position(column))
        return changed

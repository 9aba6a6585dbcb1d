"""Field: a named boolean matrix with a schema (reference field.go).

The port's copy of ``pilosa_tpu.storage.field``, with the reference's
``.meta`` file and view layout and its five types:

- ``set``: rows in the standard view;
- ``mutex``: a column in one row at most, so a Set clears the column's
  previous row;
- ``bool``: a mutex field of rows 0 (false) and 1 (true);
- ``time``: a set field whose timestamped writes also land in one view
  per unit of its time quantum (``standard_YYYY[MM[DD[HH]]]``);
- ``int``: BSI bit-sliced integers in one ``bsig_<field>`` view whose
  rows are [exists, sign, bit 0 … bit depth-1], offset-encoded against
  the field minimum so every stored magnitude is non-negative
  (aggregates add ``base·count`` back).

A field with ``keys`` names its rows by string keys (the holder's
translate log); every field keeps its row attributes in ``.rowattrs.db``.
"""

from __future__ import annotations

import datetime as dt
import json
import os
import threading

import numpy as np

from pilosa_tpu_torch.serving import rescache
from pilosa_tpu_torch.shardwidth import (
    SHARD_WIDTH,
    keep_last_unique,
    position,
    shard_groups,
    shard_of,
)
from pilosa_tpu_torch.storage.attrs import AttrStore
from pilosa_tpu_torch.storage.cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE
from pilosa_tpu_torch.storage.view import (
    VIEW_STANDARD,
    View,
    validate_quantum,
    view_name_bsi,
    views_for_time,
)
from pilosa_tpu_torch.storage.wal import fsync_dir
from pilosa_tpu_torch.testing import faults

TYPE_SET = "set"
TYPE_INT = "int"
TYPE_TIME = "time"
TYPE_MUTEX = "mutex"
TYPE_BOOL = "bool"
FIELD_TYPES = (TYPE_SET, TYPE_INT, TYPE_TIME, TYPE_MUTEX, TYPE_BOOL)

# BSI plane layout within the bsig view.
BSI_EXISTS_ROW = 0
BSI_SIGN_ROW = 1  # reserved; offset encoding keeps magnitudes non-negative
BSI_OFFSET_ROW = 2


class FieldOptions:
    """Field schema, serialized exactly as the reference's ``.meta``."""

    def __init__(self, type: str = TYPE_SET,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE, min: int = 0,
                 max: int = 0, time_quantum: str = "", keys: bool = False):
        if type not in FIELD_TYPES:
            raise ValueError(f"invalid field type {type!r}")
        if type == TYPE_INT and max < min:
            raise ValueError("int field requires max >= min")
        if type == TYPE_TIME:
            validate_quantum(time_quantum)
            if not time_quantum:
                raise ValueError("time field requires a time quantum")
        self.type = type
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.min = min
        self.max = max
        self.time_quantum = time_quantum
        self.keys = keys

    @property
    def base(self) -> int:
        return self.min

    @property
    def bit_depth(self) -> int:
        span = self.max - self.min
        return max(1, span.bit_length())

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


class Field:
    def __init__(self, path: str, index: str, name: str,
                 options: FieldOptions | None = None, scope: str = "",
                 cache=None, verify_on_load: bool = False, wal=None):
        self.path = path
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.scope = scope
        self.cache = cache
        self.verify_on_load = verify_on_load
        self.wal = wal
        self.views: dict[str, View] = {}
        self._create_lock = threading.Lock()
        self.row_attrs: AttrStore | None = None  # opened in open()

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
        self.row_attrs = AttrStore(os.path.join(self.path,
                                                ".rowattrs.db")).open()
        return self

    def close(self, discard: bool = False) -> None:
        for v in list(self.views.values()):
            v.close(discard=discard)
        if self.row_attrs is not None:
            self.row_attrs.close()
        if self.cache is not None:
            if discard:
                # a delete: a field re-created under this name must find
                # no entry of the old one in any tier
                self.cache.invalidate_field(self.scope, self.index,
                                            self.name)
            else:
                self.cache.invalidate_tag((self.scope, self.index,
                                           self.name))
        # a field closing (a delete, or the holder shutting down) fences
        # every cached result of the index
        rescache.invalidate_index_wide(self.scope, self.index)

    def _new_view(self, name: str) -> View:
        return View(os.path.join(self.path, "views", name), self.index,
                    self.name, name, scope=self.scope, cache=self.cache,
                    cache_type=self.options.cache_type,
                    cache_size=self.options.cache_size,
                    verify_on_load=self.verify_on_load, wal=self.wal)

    def _save_meta(self) -> None:
        meta = os.path.join(self.path, ".meta")
        try:
            faults.disk_check("write", meta)
            with open(meta, "w") as f:
                json.dump(self.options.to_dict(), f)
                f.flush()
                faults.disk_check("fsync", meta)
                os.fsync(f.fileno())
        except OSError as e:
            # a full disk on a schema write turns the node read-only
            health = getattr(self.wal, "health", None)
            if health is not None:
                health.trip(f".meta write of {meta}: {e}")
            raise
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

    def bsi_view_name(self) -> str:
        return view_name_bsi(self.name)

    # ---------------------------------------------------------------- writes

    def set_bit(self, row: int, column: int,
                timestamp: dt.datetime | None = None) -> bool:
        """Set (row, column). A mutex or bool field clears the column's
        previous row first; a timestamp also writes the bit into each of
        the time quantum's views (after the standard view, so a
        timestamp on another type raises with the standard bit set, as
        in the reference)."""
        if self.options.type == TYPE_INT:
            raise ValueError("set_bit on int field; use set_value")
        if self.options.type == TYPE_BOOL and row not in (0, 1):
            raise ValueError("bool field rows must be 0 (false) or 1 (true)")
        shard, pos = shard_of(column), position(column)
        frag = self.view(VIEW_STANDARD, create=True).fragment(shard,
                                                              create=True)
        if self.options.type in (TYPE_MUTEX, TYPE_BOOL):
            for other in frag.row_ids():
                if other != row and frag.contains(other, pos):
                    frag.clear_bit(other, pos)
        changed = frag.set_bit(row, pos)
        if timestamp is not None:
            if self.options.type != TYPE_TIME:
                raise ValueError("timestamped write on non-time field")
            for vname in views_for_time(VIEW_STANDARD,
                                        self.options.time_quantum, timestamp):
                self.view(vname, create=True).fragment(
                    shard, create=True).set_bit(row, pos)
        return changed

    def clear_bit(self, row: int, column: int) -> bool:
        """Clear (row, column) in every view but the BSI planes: the
        standard view and each time view."""
        changed = False
        for v in list(self.views.values()):
            if v.name == self.bsi_view_name():
                continue
            frag = v.fragment(shard_of(column))
            if frag is not None:
                changed |= frag.clear_bit(row, position(column))
        return changed

    def _check_int(self, what: str) -> None:
        if self.options.type != TYPE_INT:
            raise ValueError(f"{what} on non-int field")

    def set_value(self, column: int, value: int) -> bool:
        """BSI write (reference field.SetValue): offset-encode and write the
        exists bit + magnitude bit planes."""
        self._check_int("set_value")
        if not self.options.min <= value <= self.options.max:
            raise ValueError(
                f"value {value} outside field range "
                f"[{self.options.min}, {self.options.max}]"
            )
        stored = value - self.options.base
        pos = position(column)
        frag = self.view(self.bsi_view_name(), create=True).fragment(
            shard_of(column), create=True)
        changed = frag.set_bit(BSI_EXISTS_ROW, pos)
        for i in range(self.options.bit_depth):
            if (stored >> i) & 1:
                changed |= frag.set_bit(BSI_OFFSET_ROW + i, pos)
            else:
                changed |= frag.clear_bit(BSI_OFFSET_ROW + i, pos)
        return changed

    def import_values(self, columns, values) -> int:
        """Batched BSI import (reference field.importValue): validates and
        offset-encodes the whole batch, groups by shard, and writes each
        shard's planes in one locked fragment pass (Fragment.import_bsi).
        Duplicate columns keep the LAST value. Returns the number of
        columns whose value changed."""
        self._check_int("import_values")
        columns = np.atleast_1d(np.asarray(columns, np.uint64))
        values = np.atleast_1d(np.asarray(values, np.int64))
        if columns.size == 0:
            return 0
        bad = (values < self.options.min) | (values > self.options.max)
        if bad.any():
            v = int(values[bad][0])
            raise ValueError(
                f"value {v} outside field range "
                f"[{self.options.min}, {self.options.max}]"
            )
        keep = keep_last_unique(columns)
        columns, values = columns[keep], values[keep]
        stored = (values - self.options.base).astype(np.uint64)
        view = self.view(self.bsi_view_name(), create=True)
        order, bounds, shards_sorted = shard_groups(columns)
        cols_s, stored_s = columns[order], stored[order]
        changed = 0
        for i in range(bounds.size - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            frag = view.fragment(int(shards_sorted[lo]), create=True)
            changed += frag.import_bsi(
                cols_s[lo:hi] & np.uint64(SHARD_WIDTH - 1),
                stored_s[lo:hi], self.options.bit_depth,
                exists_row=BSI_EXISTS_ROW, offset_row=BSI_OFFSET_ROW,
            )
        return changed

    def value(self, column: int) -> tuple[int, bool]:
        """One column's BSI value, read on the host (reference
        field.Value)."""
        self._check_int("value")
        pos = position(column)
        view = self.view(self.bsi_view_name())
        frag = view.fragment(shard_of(column)) if view else None
        if frag is None or not frag.contains(BSI_EXISTS_ROW, pos):
            return 0, False
        stored = 0
        for i in range(self.options.bit_depth):
            if frag.contains(BSI_OFFSET_ROW + i, pos):
                stored |= 1 << i
        return stored + self.options.base, True

    def clear_value(self, column: int) -> bool:
        self._check_int("clear_value")
        pos = position(column)
        view = self.view(self.bsi_view_name())
        frag = view.fragment(shard_of(column)) if view else None
        if frag is None:
            return False
        changed = frag.clear_bit(BSI_EXISTS_ROW, pos)
        for i in range(self.options.bit_depth):
            frag.clear_bit(BSI_OFFSET_ROW + i, pos)
        return changed

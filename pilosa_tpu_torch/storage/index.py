"""Index: a named database of fields + existence tracking (reference index.go).

The port's thin copy of ``pilosa_tpu.storage.index``: the same ``.meta``
file and field layout, the internal ``_exists`` field recording which
columns exist (row 0 of its standard view), the ``keys`` option (string
column keys, through the holder's translate log) and the column
attributes in ``.colattrs.db``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, shard_groups
from pilosa_tpu_torch.storage.attrs import AttrStore
from pilosa_tpu_torch.storage.field import Field, FieldOptions, TYPE_SET
from pilosa_tpu_torch.storage.view import VIEW_STANDARD
from pilosa_tpu_torch.storage.wal import fsync_dir
from pilosa_tpu_torch.testing import faults

EXISTENCE_FIELD = "_exists"


class Index:
    def __init__(self, path: str, name: str, keys: bool = False,
                 track_existence: bool = True, cache=None,
                 verify_on_load: bool = False, wal=None):
        self.path = path
        self.name = name
        # residency scope: unique per holder data dir, so two holders in
        # one process never share cache keys or write-routing tags
        self.scope = path
        self.keys = keys
        self.track_existence = track_existence
        self.cache = cache
        self.verify_on_load = verify_on_load
        self.wal = wal
        self.fields: dict[str, Field] = {}
        self._create_lock = threading.Lock()
        # schema epoch: bumped on field create so cached plans revalidate
        self.plan_epoch = 0
        self._shards_memo: tuple[int, list[int]] | None = None
        self.column_attrs: AttrStore | None = None  # opened in open()

    def open(self) -> "Index":
        os.makedirs(self.path, exist_ok=True)
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                d = json.load(f)
            self.keys = d.get("keys", False)
            self.track_existence = d.get("trackExistence", True)
        else:
            self._save_meta()
        for entry in sorted(os.listdir(self.path)):
            p = os.path.join(self.path, entry)
            if entry.startswith(".trash-"):
                # a delete_field crashed between rename and rmtree
                shutil.rmtree(p, ignore_errors=True)
            elif os.path.isdir(p) and not entry.startswith("."):
                self.fields[entry] = Field(
                    p, self.name, entry, scope=self.scope, cache=self.cache,
                    verify_on_load=self.verify_on_load, wal=self.wal).open()
        if self.track_existence and EXISTENCE_FIELD not in self.fields:
            self.create_field(EXISTENCE_FIELD,
                              FieldOptions(type=TYPE_SET, cache_type="none"))
        self.column_attrs = AttrStore(os.path.join(self.path,
                                                   ".colattrs.db")).open()
        return self

    def close(self, discard: bool = False) -> None:
        for f in list(self.fields.values()):
            f.close(discard=discard)
        if self.column_attrs is not None:
            self.column_attrs.close()

    def _save_meta(self) -> None:
        meta = os.path.join(self.path, ".meta")
        try:
            faults.disk_check("write", meta)
            with open(meta, "w") as f:
                json.dump({"keys": self.keys,
                           "trackExistence": self.track_existence}, f)
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

    def create_field(self, name: str, options: FieldOptions | None = None
                     ) -> Field:
        options = options or FieldOptions()
        with self._create_lock:
            if name in self.fields:
                raise ValueError(f"field {name!r} already exists")
            _validate_name(name, allow_internal=name == EXISTENCE_FIELD)
            field = Field(os.path.join(self.path, name), self.name, name,
                          options, scope=self.scope, cache=self.cache,
                          verify_on_load=self.verify_on_load,
                          wal=self.wal).open()
            self.fields[name] = field
            self.plan_epoch += 1
            return field

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def delete_field(self, name: str) -> None:
        """Rename-then-tombstone, as the reference deletes: the rename
        takes the field out of the tree in one step (a crash leaves the
        whole field or none), the durable tombstone keeps replay from
        resurrecting its ops into a re-creation under the same name, and
        only then do the files go. ``open()`` sweeps a ``.trash-*`` that
        a crash leaves."""
        field = self.fields.pop(name, None)
        if field is None:
            raise KeyError(f"field {name!r} not found")
        trash = _rename_to_trash(field.path, self.path, name)
        if self.wal is not None:
            self.wal.tombstone(f"{self.name}/{name}/")
            self.wal.barrier()
        field.close(discard=True)
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)
        self.plan_epoch += 1
        self._shards_memo = None  # a delete can shrink the shard set

    def public_fields(self) -> list[Field]:
        return [f for n, f in sorted(self.fields.items())
                if not n.startswith("_")]

    def mark_columns_exist(self, columns) -> None:
        """Set row 0 of the _exists field for every column, one bulk
        import per shard."""
        if not self.track_existence:
            return
        cols = np.asarray(columns, np.uint64)
        if cols.size == 0:
            return
        view = self.fields[EXISTENCE_FIELD].view(VIEW_STANDARD, create=True)
        order, bounds, shards_sorted = shard_groups(cols)
        cols = cols[order]
        zeros = np.zeros(cols.size, np.uint64)
        for i in range(bounds.size - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            frag = view.fragment(int(shards_sorted[lo]), create=True)
            frag.bulk_import(zeros[lo:hi],
                             cols[lo:hi] & np.uint64(SHARD_WIDTH - 1))

    def available_shards(self) -> list[int]:
        """Sorted union of every field's shard set, memoized on the total
        fragment count (the shard set only grows, by fragment creation);
        the same list object is returned until it changes, which keys
        the executor's shard-block memo."""
        n_frags = sum(len(v.fragments) for f in list(self.fields.values())
                      for v in list(f.views.values()))
        memo = self._shards_memo
        if memo is not None and memo[0] == n_frags:
            return memo[1]
        shards: set[int] = set()
        for f in list(self.fields.values()):
            shards.update(f.available_shards())
        out = sorted(shards)
        self._shards_memo = (n_frags, out)
        return out

    def schema(self) -> dict:
        return {
            "name": self.name,
            "options": {"keys": self.keys,
                        "trackExistence": self.track_existence},
            "fields": [{"name": f.name, "options": f.options.to_dict()}
                       for f in self.public_fields()],
        }


def _rename_to_trash(path: str, parent: str, name: str) -> str | None:
    """Move ``path`` to ``parent/.trash-{name}`` and fsync ``parent``:
    the rename must be on disk before the delete is acknowledged, or a
    power cut would bring the snapshot files back. None when ``path`` is
    already gone."""
    trash = os.path.join(parent, f".trash-{name}")
    shutil.rmtree(trash, ignore_errors=True)
    try:
        os.rename(path, trash)
    except OSError:
        return None
    fsync_dir(parent)
    return trash


def _validate_name(name: str, allow_internal: bool = False) -> None:
    ok_first = name[:1].isalpha() or (allow_internal and name[:1] == "_")
    if not name or len(name) > 230 or not ok_first or not all(
        c.isalnum() or c in "-_" for c in name
    ):
        raise ValueError(f"invalid name {name!r}")

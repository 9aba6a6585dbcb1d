"""Attribute storage: JSON attributes on rows and columns (reference attr.go).

The port's copy of ``pilosa_tpu.storage.attrs``: one sqlite3 file per
index (``.colattrs.db``, column attrs) and per field (``.rowattrs.db``,
row attrs), one JSON object per id dumped with sorted keys, so either
package reads the other's files, and blake2b digests over blocks of 100
ids for anti-entropy diffing.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading

ATTR_BLOCK_SIZE = 100


class AttrStore:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        self._conn: sqlite3.Connection | None = None

    def open(self) -> "AttrStore":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, data TEXT NOT NULL)"
        )
        self._conn.commit()
        return self

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def attrs(self, id_: int) -> dict:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM attrs WHERE id = ?", (int(id_),)
            ).fetchone()
        return json.loads(row[0]) if row else {}

    def set_attrs(self, id_: int, attrs: dict) -> dict:
        """Merge attrs into the existing set (null values delete keys,
        matching the reference's merge semantics)."""
        with self._lock:
            current = self.attrs(id_)
            for k, v in attrs.items():
                if v is None:
                    current.pop(k, None)
                else:
                    current[k] = v
            self._conn.execute(
                "INSERT INTO attrs (id, data) VALUES (?, ?) "
                "ON CONFLICT(id) DO UPDATE SET data = excluded.data",
                (int(id_), json.dumps(current, sort_keys=True)),
            )
            self._conn.commit()
        return current

    def bulk(self, ids) -> dict[int, dict]:
        """One read for many ids, chunked under SQLite's host-parameter
        limit (999 in older builds) so TopN-scale candidate lists work."""
        ids = [int(i) for i in ids]
        out: dict[int, dict] = {}
        with self._lock:
            for lo in range(0, len(ids), 500):
                chunk = ids[lo:lo + 500]
                marks = ",".join("?" * len(chunk))
                rows = self._conn.execute(
                    f"SELECT id, data FROM attrs WHERE id IN ({marks})",
                    chunk,
                ).fetchall()
                out.update((int(i), json.loads(d)) for i, d in rows)
        return out

    def blocks(self) -> list[tuple[int, str]]:
        """Content-hashed ATTR_BLOCK_SIZE-id blocks (anti-entropy diffing)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, data FROM attrs ORDER BY id"
            ).fetchall()
        out = []
        current_block, hasher = None, None
        for id_, data in rows:
            block = int(id_) // ATTR_BLOCK_SIZE
            if block != current_block:
                if current_block is not None:
                    out.append((current_block, hasher.hexdigest()))
                current_block, hasher = block, hashlib.blake2b(digest_size=16)
            hasher.update(f"{id_}={data};".encode())
        if current_block is not None:
            out.append((current_block, hasher.hexdigest()))
        return out

    def block_data(self, block: int) -> dict[int, dict]:
        lo, hi = block * ATTR_BLOCK_SIZE, (block + 1) * ATTR_BLOCK_SIZE
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, data FROM attrs WHERE id >= ? AND id < ?", (lo, hi)
            ).fetchall()
        return {int(i): json.loads(d) for i, d in rows}

    def merge_block(self, data: dict) -> None:
        """Union-merge a peer's block (anti-entropy repair)."""
        for id_, attrs in data.items():
            self.set_attrs(int(id_), attrs)

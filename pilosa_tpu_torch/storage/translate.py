"""Key translation: string keys ↔ sequential ids (reference translate.go).

The port's copy of ``pilosa_tpu.storage.translate``, byte for byte in
what it writes: indexes translate column keys, fields translate row keys,
and the holder keeps one append-only log of (namespace, key) records,
replayed on open. The id is implicit in the record's place among its
namespace's records, so a replica tails the log by offset
(``read_log``/``apply_log``), and logs of disjoint namespaces concatenate
into the union of their mappings.

Record layout (little-endian): uint16 namespace length, uint32 key
length, namespace bytes, key bytes (utf-8). A torn tail is dropped.
"""

from __future__ import annotations

import os
import struct
import threading

from pilosa_tpu_torch.storage.wal import wal_fsync

_REC = struct.Struct("<HI")  # namespace-length, key-length


def _records(buf: bytes):
    """(namespace, key) of every whole record in ``buf``, in order."""
    pos, size, end_buf = 0, _REC.size, len(buf)
    unpack = _REC.unpack_from
    names: dict[bytes, str] = {}
    while pos + size <= end_buf:
        ns_len, key_len = unpack(buf, pos)
        head = pos + size
        end = head + ns_len + key_len
        if end > end_buf:
            return  # torn tail
        ns_b = buf[head:head + ns_len]
        ns = names.get(ns_b)
        if ns is None:
            ns = names[ns_b] = ns_b.decode()
        yield ns, buf[head + ns_len:end].decode()
        pos = end


class TranslateStore:
    """Bidirectional key↔id maps per namespace, backed by an append log.

    Namespaces: ``c/<index>`` for column keys, ``r/<index>/<field>`` for
    row keys (ids in both spaces start at 0 and grow densely)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        self._key_to_id: dict[str, dict[str, int]] = {}
        self._id_to_key: dict[str, list[str]] = {}
        self._file = None
        self._dirty = False  # appended records not fsynced yet

    # ------------------------------------------------------------- lifecycle

    def open(self) -> "TranslateStore":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                buf = f.read()
            self._replay(buf, append=False)
        self._file = open(self.path, "ab")
        return self

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    # ------------------------------------------------------------ translate

    def translate(self, namespace: str, keys, create: bool = False
                  ) -> list[int | None]:
        """Keys → ids. With create=False unknown keys map to None; with
        create=True they get the next ids, their records appended in
        order in one write."""
        out = []
        new = []
        pack = _REC.pack
        with self._lock:
            ids = self._key_to_id.setdefault(namespace, {})
            table = self._id_to_key.setdefault(namespace, [])
            ns_b = namespace.encode()
            try:
                for key in keys:
                    id_ = ids.get(key)
                    if id_ is None and create:
                        id_ = ids[key] = len(table)
                        table.append(key)
                        key_b = key.encode()
                        new.append(pack(len(ns_b), len(key_b)) + ns_b + key_b)
                    out.append(id_)
            finally:  # a key that does not encode stops the call here
                self._append(b"".join(new))
        return out

    def translate_one(self, namespace: str, key: str, create: bool = False
                      ) -> int | None:
        return self.translate(namespace, [key], create=create)[0]

    def keys_of(self, namespace: str, ids) -> list[str | None]:
        """Ids → keys (None for ids never assigned)."""
        with self._lock:
            table = self._id_to_key.get(namespace, [])
            return [table[i] if 0 <= int(i) < len(table) else None
                    for i in ids]

    # --------------------------------------------------------- replication

    def log_size(self) -> int:
        with self._lock:
            if self._file:
                self._file.flush()
            return (os.path.getsize(self.path) if os.path.exists(self.path)
                    else 0)

    def read_log(self, offset: int) -> bytes:
        """Raw log bytes from ``offset`` (the primary's side of tailing)."""
        with self._lock:
            if self._file:
                self._file.flush()
            with open(self.path, "rb") as f:
                f.seek(offset)
                return f.read()

    def apply_log(self, data: bytes) -> int:
        """The replica's side: replay records received from the primary,
        appending those of keys not known here; returns the records
        read."""
        with self._lock:
            return self._replay(data, append=True)

    # -------------------------------------------------------------- helpers

    def _replay(self, buf: bytes, append: bool) -> int:
        """Assign the next id to each key of ``buf``'s records not known
        yet (its record appended too with ``append``); returns the
        records read."""
        n = 0
        new = []
        ns_cur, ids, table = None, None, None
        try:
            for ns, key in _records(buf):
                n += 1
                if ns is not ns_cur:
                    ns_cur = ns
                    ids = self._key_to_id.setdefault(ns, {})
                    table = self._id_to_key.setdefault(ns, [])
                if key not in ids:
                    ids[key] = len(table)
                    table.append(key)
                    if append:
                        key_b = key.encode()
                        ns_b = ns.encode()
                        new.append(_REC.pack(len(ns_b), len(key_b)) + ns_b
                                   + key_b)
        finally:
            self._append(b"".join(new))
        return n

    def _append(self, records: bytes) -> None:
        if self._file is None or not records:
            return
        self._file.write(records)
        self._file.flush()
        self._dirty = True

    def sync(self) -> None:
        """Fsync the appended records (the ACK gate calls it in the
        fsyncing durability modes): a keyed write's bit that outlived its
        key→id record would come back under another, later key, since
        ids are implicit in append order. Nothing to do when nothing was
        appended, so unkeyed writes pay nothing."""
        with self._lock:
            if not self._dirty or self._file is None:
                return
            self._file.flush()
            wal_fsync(self._file.fileno())
            self._dirty = False


def column_namespace(index: str) -> str:
    return f"c/{index}"


def row_namespace(index: str, field: str) -> str:
    return f"r/{index}/{field}"

"""Result types for query execution (the port's copy of
``pilosa_tpu.executor.result``, so both packages answer the same bytes).

Reference: row.go — a Row is per-shard segments each
wrapping a bitmap, so cross-shard merges are cheap concatenation; plus the
pair/group shapes the executor reduces (Pairs for TopN, GroupCounts for
GroupBy).
"""

from __future__ import annotations

import json

import numpy as np

from pilosa_tpu_torch.ops.packing import popcount_words, unpack_bits
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class RowResult:
    """Query-result set of columns: shard → dense uint32 words (host)."""

    def __init__(self, segments: dict[int, np.ndarray] | None = None, attrs=None, keys=None):
        self.segments = segments or {}
        self.attrs = attrs or {}
        self.keys = keys  # translated column keys, when the index uses keys
        self.column_attrs = None  # [{"id": col, "attrs": {...}}] via Options(columnAttrs=true)

    def columns(self) -> np.ndarray:
        parts = [
            unpack_bits(words, offset=shard * SHARD_WIDTH)
            for shard, words in sorted(self.segments.items())
        ]
        if not parts:
            return np.empty(0, np.uint64)
        return np.concatenate(parts)

    def count(self) -> int:
        return sum(popcount_words(w) for w in self.segments.values())

    def merge(self, other: "RowResult") -> "RowResult":
        """Cross-node reduce: union segments (shards are disjoint across
        owners, so collisions only appear with replication — union is
        correct either way)."""
        out = dict(self.segments)
        for shard, words in other.segments.items():
            if shard in out:
                out[shard] = np.bitwise_or(out[shard], words)
            else:
                out[shard] = words
        return RowResult(out, {**other.attrs, **self.attrs})

    def to_json(self) -> dict:
        if self.keys is not None:
            out = {"attrs": self.attrs, "keys": self.keys}
        else:
            out = {"attrs": self.attrs, "columns": self.columns().tolist()}
        if self.column_attrs is not None:
            out["columnAttrs"] = self.column_attrs
        return out


class Pair:
    """TopN result element (reference Pair{ID, Count})."""

    __slots__ = ("id", "count", "key")

    def __init__(self, id: int, count: int, key: str | None = None):
        self.id = id
        self.count = count
        self.key = key

    def to_json(self) -> dict:
        d = {"id": self.id, "count": self.count}
        if self.key is not None:
            d["key"] = self.key
        return d

    def __eq__(self, other):
        if not isinstance(other, Pair):
            return NotImplemented
        return (self.id == other.id and self.count == other.count
                and self.key == other.key)

    def __hash__(self):
        # key is attached after construction for keyed fields; exclude it
        # so the hash is stable over the Pair's lifetime
        return hash((self.id, self.count))

    def __repr__(self) -> str:
        return f"Pair(id={self.id}, count={self.count}, key={self.key!r})"


class ValCount:
    """Sum/Min/Max result (reference ValCount{Val, Count})."""

    __slots__ = ("value", "count")

    def __init__(self, value: int, count: int):
        self.value = value
        self.count = count

    def to_json(self) -> dict:
        return {"value": self.value, "count": self.count}

    def __eq__(self, other):
        if not isinstance(other, ValCount):
            return NotImplemented
        return self.value == other.value and self.count == other.count

    def __hash__(self):
        return hash((self.value, self.count))

    def __repr__(self) -> str:
        return f"ValCount(value={self.value}, count={self.count})"


class GroupCount:
    """GroupBy result element (reference GroupCount; ``sum`` set when the
    call carries aggregate=Sum(...))."""

    __slots__ = ("group", "count", "sum")

    def __init__(self, group: list[dict], count: int, sum: int | None = None):
        self.group = group  # [{"field": name, "rowID": id}, ...]
        self.count = count
        self.sum = sum

    def to_json(self) -> dict:
        out = {"group": self.group, "count": self.count}
        if self.sum is not None:
            out["sum"] = self.sum
        return out

    def __eq__(self, other):
        if not isinstance(other, GroupCount):
            return NotImplemented
        return (self.group == other.group and self.count == other.count
                and self.sum == other.sum)

    # value-equal but holds a list; deliberately unhashable
    __hash__ = None

    def __repr__(self) -> str:
        return (f"GroupCount(group={self.group}, count={self.count}, "
                f"sum={self.sum})")


def result_to_json(res):
    """Serialize any executor result for the HTTP response envelope."""
    if isinstance(res, (RowResult, Pair, ValCount, GroupCount)):
        return res.to_json()
    if isinstance(res, list):
        return [result_to_json(r) for r in res]
    if isinstance(res, np.integer):
        return int(res)
    return res


# ------------------------------------------------- pre-serialized responses
#
# The serving fast lane encodes hot result shapes (Count, Row, TopN pairs,
# ValCount) straight to compact-JSON bytes once, instead of dict-building
# then json.dumps per request. RowResult encodings memoize ON the result
# object — the encoded-bytes cache keyed by result identity — so a wave of
# identical coalesced queries (server/pipeline.py dedupe) pays the
# segment-unpack + encode exactly once however many clients asked.


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def result_json_bytes(res) -> bytes:
    """Compact-JSON bytes of ``result_to_json(res)`` (exact same JSON
    value; whitespace-free encoding)."""
    if isinstance(res, bool):  # before int — bool subclasses int
        return b"true" if res else b"false"
    if isinstance(res, (int, np.integer)):
        return b"%d" % int(res)
    if isinstance(res, RowResult):
        cached = getattr(res, "_json_bytes", None)
        if cached is None:
            cached = res._json_bytes = _dumps(res.to_json())
        return cached
    if isinstance(res, ValCount):
        return b'{"value":%d,"count":%d}' % (res.value, res.count)
    return _dumps(result_to_json(res))


def results_json_bytes(results) -> bytes:
    """The whole ``{"results": [...]}`` response envelope as bytes."""
    return (b'{"results":['
            + b",".join(result_json_bytes(r) for r in results) + b"]}")

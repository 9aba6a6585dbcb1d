"""Roaring file format + append-only op log (host durability layer).

The port's copy of ``pilosa_tpu.roaring.format`` (snapshot + op log), byte
for byte the same layout, so each package opens the other's fragment
files. The upstream-pilosa import layout is not ported yet.

Layout (little-endian):
  header:  magic uint32 = 0x50C4B175, version uint16, flags uint16,
           container_count uint32, payload_bytes uint64
  descrs:  container_count × (key uint64, kind uint16, n_minus_1 uint16,
           payload_len uint32)
  payload: concatenated container data
           array: n × uint16 | bitmap: 1024 × uint64 | run: n_runs × 2 × uint16
  ops:     sequence of records until EOF:
           op_magic uint16 = 0x4F50, op uint16 (1=add 2=remove),
           id_count uint32, crc32 uint32 (over ids bytes), ids × uint64
"""


from __future__ import annotations

import struct
import zlib

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import ARRAY, BITMAP, RUN, Container, RoaringBitmap

MAGIC = 0x50C4B175
VERSION = 1
_HEADER = struct.Struct("<IHHIQ")
_DESCR = struct.Struct("<QHHI")

OP_MAGIC = 0x4F50
OP_ADD = 1
OP_REMOVE = 2
_OP_HEADER = struct.Struct("<HHII")


def serialize(bitmap: RoaringBitmap) -> bytes:
    descrs = []
    payloads = []
    for key in bitmap.keys:
        c = bitmap.container(key)
        data = np.ascontiguousarray(c.data)
        raw = data.astype(
            {ARRAY: "<u2", BITMAP: "<u8", RUN: "<u2"}[c.kind], copy=False
        ).tobytes()
        descrs.append(_DESCR.pack(key, c.kind, c.n - 1, len(raw)))
        payloads.append(raw)
    payload = b"".join(payloads)
    header = _HEADER.pack(MAGIC, VERSION, 0, len(descrs), len(payload))
    return header + b"".join(descrs) + payload


def deserialize(buf: bytes | memoryview) -> tuple[RoaringBitmap, int]:
    """Parse a snapshot; returns (bitmap, offset-where-ops-begin)."""
    buf = memoryview(buf)
    if len(buf) < _HEADER.size:
        raise ValueError("roaring: truncated header")
    magic, version, _flags, n_containers, payload_bytes = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"roaring: bad magic 0x{magic:08X}")
    if version != VERSION:
        raise ValueError(f"roaring: unsupported version {version}")
    pos = _HEADER.size
    b = RoaringBitmap()
    descr_end = pos + n_containers * _DESCR.size
    data_pos = descr_end
    for _ in range(n_containers):
        key, kind, n_minus_1, payload_len = _DESCR.unpack_from(buf, pos)
        pos += _DESCR.size
        raw = buf[data_pos : data_pos + payload_len]
        if len(raw) != payload_len:
            raise ValueError("roaring: truncated container payload")
        data_pos += payload_len
        n = n_minus_1 + 1
        if kind == ARRAY:
            data = np.frombuffer(raw, dtype="<u2").copy()
        elif kind == BITMAP:
            data = np.frombuffer(raw, dtype="<u8").copy()
        elif kind == RUN:
            data = np.frombuffer(raw, dtype="<u2").copy().reshape(-1, 2)
        else:
            raise ValueError(f"roaring: unknown container kind {kind}")
        b._containers[int(key)] = Container(kind, data, n)
    b.keys = sorted(b._containers)
    expected_end = descr_end + payload_bytes
    if data_pos != expected_end:
        raise ValueError("roaring: payload length mismatch")
    return b, data_pos


def encode_op(op: int, ids) -> bytes:
    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.uint64))
    raw = ids.astype("<u8", copy=False).tobytes()
    return _OP_HEADER.pack(OP_MAGIC, op, ids.size, zlib.crc32(raw)) + raw


def replay_ops(bitmap: RoaringBitmap, buf: bytes | memoryview,
               offset: int) -> tuple[int, int]:
    """Apply trailing op records onto the snapshot; returns (op count,
    offset where the valid records end).

    A torn final record (crash mid-append) is tolerated and ignored,
    matching the reference's crash model for the op log; an end offset
    short of the buffer tells the caller a torn tail is there.
    """
    buf = memoryview(buf)
    n_ops = 0
    pos = offset
    while pos + _OP_HEADER.size <= len(buf):
        magic, op, id_count, crc = _OP_HEADER.unpack_from(buf, pos)
        if magic != OP_MAGIC:
            break
        body_end = pos + _OP_HEADER.size + id_count * 8
        if body_end > len(buf):
            break  # torn write
        raw = bytes(buf[pos + _OP_HEADER.size : body_end])
        if zlib.crc32(raw) != crc:
            break  # torn/corrupt tail
        ids = np.frombuffer(raw, dtype="<u8")
        if op == OP_ADD:
            bitmap.add_ids(ids)
        elif op == OP_REMOVE:
            bitmap.remove_ids(ids)
        n_ops += 1
        pos = body_end
    return n_ops, pos

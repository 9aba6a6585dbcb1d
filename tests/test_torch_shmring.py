"""The port's shared-memory ring (``pilosa_tpu_torch/serving/shmring.py``)
against the reference's: frame round trips, records over several slots,
backpressure, a byte corrupted at every offset of a slot, torn chunk
chains, the dead-reader reclaim, and frames written by either package's
ring read back byte for byte by the other's (one shared-memory layout).
Everything is in-process; the multi-process end to end is
``tests/test_torch_mpserve.py``."""

import os
import struct
import threading

import pytest

import pilosa_tpu.serving.shmring as jring
import pilosa_tpu_torch.serving.shmring as pring
from pilosa_tpu_torch.serving import (
    RingFull,
    ShmRing,
    decode_frame,
    encode_frame,
)
from pilosa_tpu_torch.serving.shmring import _HDR_SIZE, _SLOT_HDR

_UNIQ = iter(range(1, 1 << 30))


def _ring(slots=8, slot_bytes=256, mod=pring):
    name = f"ptrt-{os.getpid():x}-{next(_UNIQ)}"
    return mod.ShmRing.create(name, slots, slot_bytes)


def _drop(*rings):
    for r in rings:
        r.close()
    rings[0].unlink()


@pytest.fixture
def ring():
    r = _ring()
    yield r
    _drop(r)


# ------------------------------------------------------------- framing


@pytest.mark.parametrize("header,body", [
    ({"op": "q", "ix": "i", "t": "tenant-1", "id": 7}, b"Count(Row(f=1))"),
    ({"st": 200}, b""),
    ({}, bytes(range(256)) * 3),
    ({"st": 429, "ra": 1, "id": 2**40, "tr": {"name": "rpc.query"}},
     b'{"error": "x"}'),
], ids=["query", "empty-body", "binary-body", "nested-header"])
def test_frames_round_trip_as_the_reference_encodes_them(header, body):
    frame = encode_frame(header, body)
    assert frame == jring.encode_frame(header, body)
    assert decode_frame(frame) == (header, body)
    assert jring.decode_frame(frame) == (header, body)


@pytest.mark.parametrize("record", [
    b"", b"\x01", b"\x00\x00\x00",                 # shorter than prefix
    struct.pack("<I", 999) + b"{}",                # hlen beyond record
    struct.pack("<I", 4) + b"nope",                # not JSON
    struct.pack("<I", 2) + b"[]",                  # JSON, not an object
])
def test_malformed_frame_raises_value_error(record):
    with pytest.raises(ValueError):
        decode_frame(record)


# ---------------------------------------------------------- ring basics


def test_push_pop_round_trip(ring):
    recs = [f"record-{i}".encode() for i in range(5)]
    for rec in recs:
        assert ring.push(rec)
    assert [ring.pop() for _ in recs] == recs
    assert ring.pop() is None
    m = ring.metrics()
    assert (m["pushed"], m["popped"], m["torn"], m["depth"]) == (5, 5, 0, 0)


@pytest.mark.parametrize("size,chunks", [(1, 1), (256, 1), (257, 2),
                                         (256 * 3 + 57, 4), (256 * 8, 8)])
def test_record_spans_slots_and_wraps(size, chunks):
    ring = _ring(slots=8, slot_bytes=256)
    try:
        rec = os.urandom(size)
        assert ring.push(rec)
        assert ring.depth() == chunks
        assert ring.pop() == rec
        assert ring.depth() == 0
        for _ in range(5):  # past the ring's end, several times
            assert ring.push(rec)
            assert ring.pop() == rec
    finally:
        _drop(ring)


def test_record_beyond_capacity_raises():
    ring = _ring(slots=4, slot_bytes=256)
    try:
        with pytest.raises(RingFull):
            ring.push(b"x" * (4 * 256 + 1))
        assert ring.metrics()["full_rejects"] == 0
    finally:
        _drop(ring)


@pytest.mark.parametrize("slots,slot_bytes", [(1, 256), (8, 64), (0, 4096)])
def test_create_validates_geometry(slots, slot_bytes):
    name = f"ptrt-{os.getpid():x}-geo{next(_UNIQ)}"
    with pytest.raises(ValueError):
        ShmRing.create(name, slots, slot_bytes)
    with pytest.raises(ValueError):
        jring.ShmRing.create(name + "j", slots, slot_bytes)


def test_drain_returns_the_batch_and_waiting_flag_hands_off(ring):
    for i in range(6):
        ring.push(f"r{i}".encode())
    assert ring.drain(4) == [f"r{i}".encode() for i in range(4)]
    assert ring.drain() == [b"r4", b"r5"]
    assert ring.drain() == []
    assert not ring.take_waiting()
    ring.set_waiting()
    assert ring.take_waiting()
    assert not ring.take_waiting()  # consumed


# --------------------------------------------------------- backpressure


def test_full_ring_rejects_and_counts():
    ring = _ring(slots=4, slot_bytes=256)
    try:
        payload = b"y" * 200
        for _ in range(4):
            assert ring.push(payload)
        assert not ring.push(payload)  # full: shed, do not queue
        assert not ring.push(payload)
        assert ring.metrics()["full_rejects"] == 2
        assert ring.pop() == payload  # one slot frees one record's room
        assert ring.push(payload)
        # a multi-chunk record needs all its slots free at once
        ring.drain()
        assert ring.push(b"a" * 256)
        assert not ring.push(b"b" * (256 * 3 + 1))  # needs 4, has 3
        assert ring.metrics()["full_rejects"] == 3
        ring.pop()
        assert ring.push(b"b" * (256 * 3 + 1))
    finally:
        _drop(ring)


def test_threaded_producer_keeps_order_under_backpressure():
    """A producer thread pushing through a 2-slot ring (retrying while
    it is full) and a consumer popping: every record arrives, in
    order."""
    ring = _ring(slots=2, slot_bytes=256)
    try:
        n = 500
        got: list[bytes] = []

        def producer():
            for i in range(n):
                rec = f"m{i}".encode()
                while not ring.push(rec):
                    pass

        t = threading.Thread(target=producer)
        t.start()
        try:
            while len(got) < n:
                rec = ring.pop()
                if rec is not None:
                    got.append(rec)
        finally:
            t.join(10)
        assert got == [f"m{i}".encode() for i in range(n)]
    finally:
        _drop(ring)


# ------------------------------------------------------ torn records


def test_corruption_at_every_offset_is_skipped_never_decoded():
    """One byte flipped at each offset of a published record's slot
    (its header and its payload): the consumer surfaces nothing for it,
    counts it torn, and still delivers the next record."""
    payload = bytes(range(64))
    follow = b"follower-record"
    for off in range(_SLOT_HDR.size + len(payload)):
        ring = _ring(slots=8, slot_bytes=256)
        try:
            assert ring.push(payload)
            assert ring.push(follow)
            ring._buf[_HDR_SIZE + off] ^= 0xFF
            assert ring.pop() is None, f"offset {off}"
            assert ring.torn == 1, f"offset {off}"
            assert ring.pop() == follow, f"offset {off}"
        finally:
            _drop(ring)


def test_unpublished_record_is_invisible(ring):
    """A producer dying before its head moved leaves an empty ring, not
    a torn record."""
    ring.push(b"will-be-unpublished")
    struct.pack_into("<Q", ring._buf, 16, 0)  # head as before the push
    assert ring.pop() is None
    assert ring.torn == 0
    assert ring.depth() == 0


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_torn_chunk_chain_is_skipped_whole(chunk):
    """A byte flipped in any chunk of a 3-chunk record consumes the
    record's whole chain; the surviving chunks (valid seq and crc) are
    never reassembled into a headless record, and the next record
    arrives."""
    ring = _ring(slots=8, slot_bytes=256)
    try:
        big = os.urandom(256 * 2 + 40)
        follow = b"next-record"
        ring.push(big)
        ring.push(follow)
        slot = _SLOT_HDR.size + 256
        ring._buf[_HDR_SIZE + chunk * slot + _SLOT_HDR.size] ^= 0xFF
        assert ring.pop() is None
        assert ring.torn == 1
        assert ring.pop() == follow
        assert ring.pop() is None
    finally:
        _drop(ring)


def test_promised_continuation_missing_is_torn():
    """A head covering only the first chunk of a multi-chunk record is
    torn, not an endless wait."""
    ring = _ring(slots=8, slot_bytes=256)
    try:
        ring.push(b"z" * 300)  # 2 chunks
        struct.pack_into("<Q", ring._buf, 16, 1)  # head: 1 chunk only
        assert ring.pop() is None
        assert ring.torn == 1
    finally:
        _drop(ring)


# ------------------------------------------------------------- reclaim


def test_dead_reader_slots_reclaimed_and_ring_reusable():
    ring = _ring(slots=8, slot_bytes=256)
    try:
        assert ring.reclaim() == 0
        ring.push(b"one")
        ring.push(b"x" * 300)  # 2 chunks: one record
        ring.push(b"three")
        assert ring.depth() == 4
        assert ring.reclaim() == 3  # records, not chunks
        assert ring.depth() == 0
        assert ring.pop() is None
        assert ring.push(b"after")  # reusable at once
        assert ring.pop() == b"after"
    finally:
        _drop(ring)


# ------------------------------------------------------- across packages


@pytest.mark.parametrize("writer,reader", [(pring, jring), (jring, pring)],
                         ids=["port-to-reference", "reference-to-port"])
@pytest.mark.parametrize("size", [0, 100, 256 * 5 + 3])
def test_either_package_reads_the_others_frames(writer, reader, size):
    """A frame pushed by one package's ring, attached by name from the
    other's, pops byte for byte; the shared cursors and slot headers
    match, and the reader's reclaim and metrics agree."""
    w = _ring(slots=8, slot_bytes=256, mod=writer)
    r = reader.ShmRing.attach(w.name)
    try:
        assert (r.slots, r.slot_bytes) == (w.slots, w.slot_bytes)
        frame = writer.encode_frame({"id": size, "st": 200},
                                    os.urandom(size))
        assert w.push(frame) and w.push(b"second")
        assert r.depth() == w.depth()
        got = r.pop()
        assert got == frame
        assert reader.decode_frame(got) == writer.decode_frame(frame)
        assert r.reclaim() == 1  # "second", dropped as a dead peer's
        assert w.depth() == 0
        assert w.push(b"third") and r.pop() == b"third"
    finally:
        r.close()
        w.close()
        w.unlink()

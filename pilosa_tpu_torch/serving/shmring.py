"""Pickle-free shared-memory rings of the multi-process serving plane
(the port's copy of ``pilosa_tpu.serving.shmring``, byte for byte the
same layout: a frame either package writes, the other reads).

One ``ShmRing`` is a fixed-slot single-producer/single-consumer ring of
length-prefixed byte records over ``multiprocessing.shared_memory``:
the channel between the ``SO_REUSEPORT`` worker processes and the
device-owner process (``serving/mpserve.py``).

- **Pickle-free**: records are raw bytes (a compact-JSON frame header
  and the pre-serialized payload). Nothing is unpickled from shared
  memory, so a corrupt or hostile peer can at worst produce a frame
  that fails validation.
- **Torn-record-safe framing**: each slot carries ``(seq, len, crc32)``
  ahead of its payload. A record becomes visible only when the
  producer's head cursor advances (written last), and the consumer
  checks seq, bounds and crc before it trusts a byte: a producer dying
  mid-write leaves an invisible record; a torn or corrupt one is
  counted (``torn``) and skipped, never decoded.
- **Backpressure instead of unbounded queueing**: ``push`` returns
  ``False`` when the ring lacks space (``full_rejects``), and the
  caller sheds (a 429 at the worker).
- **SPSC across processes, thread-safe within one**: one producer
  process and one consumer process a ring; each side guards its cursor
  with a lock of its own process, so many handler threads can share a
  ring end.

A record larger than one slot spans consecutive slots (a continuation
bit rides the length word).
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from multiprocessing import shared_memory

# Header: magic u32 | slots u32 | slot_bytes u32 | waiting u32 |
#         head u64 | tail u64 | (pad to 64)
_MAGIC = 0x50524E47  # "PRNG" — pilosa ring
_HDR_FMT = "<IIII"
_HDR_SIZE = 64
_WAIT_OFF = 12
_HEAD_OFF = 16
_TAIL_OFF = 24
# Per-slot header: seq u64 | len u32 (bit 31 = continuation follows,
# bit 30 = first chunk of a record — lets the consumer skip a torn
# record's WHOLE chunk chain instead of reassembling a headless tail) |
# crc32 u32
_SLOT_HDR = struct.Struct("<QII")
_MORE = 0x80000000
_FIRST = 0x40000000
_LEN_MASK = 0x3FFFFFFF


class RingFull(Exception):
    """The ring lacks space for this record — shed, don't queue."""


def encode_frame(header: dict, body: bytes = b"") -> bytes:
    """One wire record: ``u32 header_len | compact-JSON header | body``.
    The header carries routing metadata (request id, index, tenant,
    deadline budget, trace context); the body is the already-serialized
    payload bytes — no pickling anywhere."""
    h = json.dumps(header, separators=(",", ":")).encode()
    return struct.pack("<I", len(h)) + h + body


def decode_frame(record: bytes) -> tuple[dict, bytes]:
    """Inverse of :func:`encode_frame`. Raises ``ValueError`` on a
    malformed record (bad length prefix, non-JSON header) — the caller
    drops the frame, it never reaches execution."""
    if len(record) < 4:
        raise ValueError(f"frame too short ({len(record)} bytes)")
    (hlen,) = struct.unpack_from("<I", record)
    if hlen > len(record) - 4:
        raise ValueError(
            f"frame header length {hlen} exceeds record ({len(record)})"
        )
    header = json.loads(record[4:4 + hlen])
    if not isinstance(header, dict):
        raise ValueError("frame header is not an object")
    return header, record[4 + hlen:]


class ShmRing:
    """Fixed-slot SPSC byte ring in a named shared-memory segment."""

    def __init__(self, shm: shared_memory.SharedMemory, created: bool):
        self._shm = shm
        self._created = created
        buf = shm.buf
        magic, slots, slot_bytes, _ = struct.unpack_from(_HDR_FMT, buf, 0)
        if magic != _MAGIC:
            raise ValueError(f"not a pilosa ring: {shm.name}")
        self.slots = slots
        self.slot_bytes = slot_bytes
        self._slot_size = _SLOT_HDR.size + slot_bytes
        self._buf = buf
        # in-process thread safety only; cross-process safety comes from
        # the SPSC protocol (each cursor has exactly one writing process)
        self._plock = threading.Lock()
        self._clock = threading.Lock()
        # local-side counters (each end keeps its own; exported via the
        # serving metrics block)
        self.pushed = 0
        self.popped = 0
        self.full_rejects = 0
        self.torn = 0

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def create(cls, name: str, slots: int, slot_bytes: int) -> "ShmRing":
        if slots < 2:
            raise ValueError(f"ring needs >= 2 slots, got {slots}")
        if slot_bytes < 256:
            raise ValueError(f"slot_bytes must be >= 256, got {slot_bytes}")
        size = _HDR_SIZE + slots * (_SLOT_HDR.size + slot_bytes)
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        struct.pack_into(_HDR_FMT, shm.buf, 0, _MAGIC, slots, slot_bytes, 0)
        struct.pack_into("<QQ", shm.buf, _HEAD_OFF, 0, 0)
        return cls(shm, created=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name)
        try:
            # the attaching process must not let its resource tracker
            # unlink (or warn about) a segment the creator owns
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker internals are CPython
            pass           # detail; double-unlink is handled either way
        return cls(shm, created=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        """Remove the backing segment (creator side, after both ends
        closed or the peer died)."""
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    # -------------------------------------------------------------- cursors

    def _head(self) -> int:
        return struct.unpack_from("<Q", self._buf, _HEAD_OFF)[0]

    def _tail(self) -> int:
        return struct.unpack_from("<Q", self._buf, _TAIL_OFF)[0]

    def depth(self) -> int:
        """Published-but-unconsumed slots (a gauge, racy by nature)."""
        return max(0, self._head() - self._tail())

    # --------------------------------------------------- doorbell coalescing

    # Producers notify a sleeping consumer out of band (the mpserve
    # doorbell byte on the handshake socket). A doorbell per record is a
    # syscall per record under lock contention — measurably the top cost
    # of the whole IPC path — so the consumer DECLARES when it is about
    # to block (``set_waiting`` then a final ``depth`` check, closing the
    # lost-wakeup race), and producers ring only when ``take_waiting``
    # observes a declared sleeper. Races are benign: at worst an extra
    # doorbell, never a lost one.

    def set_waiting(self) -> None:
        struct.pack_into("<I", self._buf, _WAIT_OFF, 1)

    def take_waiting(self) -> bool:
        if struct.unpack_from("<I", self._buf, _WAIT_OFF)[0]:
            struct.pack_into("<I", self._buf, _WAIT_OFF, 0)
            return True
        return False

    # ------------------------------------------------------------- producer

    def push(self, data: bytes) -> bool:
        """Publish one record; ``False`` = insufficient free slots (the
        backpressure signal — callers shed, nothing queues)."""
        nchunks = max(1, -(-len(data) // self.slot_bytes))
        if nchunks > self.slots:
            raise RingFull(
                f"record of {len(data)} bytes exceeds ring capacity "
                f"({self.slots} slots x {self.slot_bytes} bytes)"
            )
        buf = self._buf
        with self._plock:
            head = self._head()
            if head + nchunks - self._tail() > self.slots:
                self.full_rejects += 1
                return False
            for i in range(nchunks):
                chunk = data[i * self.slot_bytes:(i + 1) * self.slot_bytes]
                off = _HDR_SIZE + ((head + i) % self.slots) * self._slot_size
                buf[off + _SLOT_HDR.size:
                    off + _SLOT_HDR.size + len(chunk)] = chunk
                length = (len(chunk)
                          | (_MORE if i < nchunks - 1 else 0)
                          | (_FIRST if i == 0 else 0))
                _SLOT_HDR.pack_into(buf, off, head + i + 1, length,
                                    zlib.crc32(chunk))
            # publish LAST: the record set is invisible until head moves,
            # so a producer crash mid-write leaves nothing half-readable
            struct.pack_into("<Q", buf, _HEAD_OFF, head + nchunks)
            self.pushed += 1
        return True

    # ------------------------------------------------------------- consumer

    def pop(self) -> bytes | None:
        """Consume one record, or ``None`` when the ring is empty or the
        next record failed validation (counted in ``torn`` and skipped —
        the caller just polls again)."""
        with self._clock:
            rec, _ = self._pop_locked()
            return rec

    def _pop_locked(self) -> tuple[bytes | None, bool]:
        """One record with ``_clock`` already held. Returns ``(record,
        progressed)``: ``(None, True)`` = a torn record was consumed
        and skipped, ``(None, False)`` = ring empty."""
        buf = self._buf
        if buf is None:  # closed concurrently (shutdown/reap race)
            return None, False
        tail = struct.unpack_from("<Q", buf, _TAIL_OFF)[0]
        head = struct.unpack_from("<Q", buf, _HEAD_OFF)[0]
        if tail >= head:
            return None, False
        parts: list[bytes] = []
        first = True
        while True:
            off = _HDR_SIZE + (tail % self.slots) * self._slot_size
            seq, length, crc = _SLOT_HDR.unpack_from(buf, off)
            more = bool(length & _MORE)
            is_first = bool(length & _FIRST)
            length &= _LEN_MASK
            payload = bytes(
                buf[off + _SLOT_HDR.size:off + _SLOT_HDR.size + length]
            ) if length <= self.slot_bytes else b""
            if (seq != tail + 1 or length > self.slot_bytes
                    or zlib.crc32(payload) != crc
                    or is_first != first):
                # torn/corrupt record: consume this slot AND any
                # published continuation chunks of the same record
                # (a valid-looking continuation must never be
                # reassembled into a headless record), surface
                # nothing
                self.torn += 1
                tail += 1
                while tail < head:
                    off = (_HDR_SIZE
                           + (tail % self.slots) * self._slot_size)
                    seq2, length2, _ = _SLOT_HDR.unpack_from(buf, off)
                    if seq2 != tail + 1 or (length2 & _FIRST):
                        break  # next record (or unreadable slot)
                    tail += 1
                struct.pack_into("<Q", buf, _TAIL_OFF, tail)
                return None, True
            parts.append(payload)
            tail += 1
            first = False
            if not more:
                struct.pack_into("<Q", buf, _TAIL_OFF, tail)
                self.popped += 1
                return b"".join(parts), True
            if tail >= head:
                # continuation promised but not published — cannot
                # happen with a live correct producer (head moves
                # after the whole record); treat as torn
                self.torn += 1
                struct.pack_into("<Q", buf, _TAIL_OFF, tail)
                return None, True

    def pop_many(self, limit: int | None = None) -> list[bytes]:
        """Consume up to ``limit`` records (all published records when
        ``None``) under ONE consumer-lock acquisition. Torn records are
        counted and skipped without ending the batch: the drain-side
        half of the doorbell coalescing, one lock and cursor round trip
        for a batch instead of one a record."""
        out: list[bytes] = []
        with self._clock:
            while limit is None or len(out) < limit:
                rec, progressed = self._pop_locked()
                if rec is not None:
                    out.append(rec)
                elif not progressed:
                    break  # empty — torn skips keep draining
        return out

    def drain(self, limit: int | None = None) -> list[bytes]:
        """Pop until empty (or ``limit`` records) — one drain per
        doorbell is how worker waves reach the owner as a batch."""
        return self.pop_many(limit)

    # ------------------------------------------------------ dead-peer reap

    def reclaim(self) -> int:
        """Drop every unconsumed record and return how many were lost.
        Only valid once the PEER process is known dead (worker reaped by
        the owner, or an owner restart detected by a worker): the
        surviving side resets the consumer cursor so the ring is
        immediately reusable and nothing is left half-in-flight."""
        with self._plock, self._clock:
            buf = self._buf
            if buf is None:  # already closed (shutdown beat the reap)
                return 0
            head = struct.unpack_from("<Q", buf, _HEAD_OFF)[0]
            tail = struct.unpack_from("<Q", buf, _TAIL_OFF)[0]
            dropped = 0
            # count RECORDS (one _FIRST chunk each; continuation chunks
            # collapse), best-effort: the headers may themselves be
            # torn, in which case each unreadable slot counts as one
            while tail < head:
                off = _HDR_SIZE + (tail % self.slots) * self._slot_size
                seq, length, _ = _SLOT_HDR.unpack_from(buf, off)
                tail += 1
                if seq != tail or (length & _FIRST):
                    dropped += 1
            struct.pack_into("<Q", buf, _TAIL_OFF, head)
            return dropped

    def metrics(self) -> dict:
        return {
            "depth": self.depth(),
            "pushed": self.pushed,
            "popped": self.popped,
            "full_rejects": self.full_rejects,
            "torn": self.torn,
        }

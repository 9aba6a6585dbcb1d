"""Deterministic disk-fault injection, the port's copy of the disk half of
``pilosa_tpu.testing.faults``.

The storage seams call three hooks: ``disk_check(op, path)`` just before
the write or fsync it models (an armed errno rule raises ``OSError``
there), ``disk_filter_read(path, data)`` on every fragment read (a flip
rule XORs a mask into one byte) and ``disk_filter_write(path, data)`` on
every snapshot payload (a truncate rule drops its tail). With no plane
installed each hook is one module-global load and an ``is None`` test.
``install_disk`` arms a plane, ``clear_disk`` removes it. The rules match
by op and path substring and fire at most ``count`` times, as the
reference's do, so a test trips both packages through the same seams.
(The network plane and the crash points are not ported.)
"""

from __future__ import annotations

import itertools
import os
import threading

# The one global the storage seams read; None means no faults.
_DISK = None

DISK_OPS = ("read", "write", "fsync")


def disk_active():
    """The installed DiskFaultPlane, or None (the normal state)."""
    return _DISK


def install_disk(plane: "DiskFaultPlane | None" = None) -> "DiskFaultPlane":
    global _DISK
    _DISK = plane if plane is not None else DiskFaultPlane()
    return _DISK


def clear_disk() -> None:
    global _DISK
    _DISK = None


def disk_check(op: str, path: str) -> None:
    """Raise OSError when an armed errno rule matches (op, path)."""
    plane = _DISK
    if plane is not None:
        plane.check(op, path)


def disk_filter_read(path: str, data: bytes) -> bytes:
    """Bit-flip-on-read seam of every fragment load and scrub read."""
    plane = _DISK
    if plane is None:
        return data
    return plane.filter(path, data, "read")


def disk_filter_write(path: str, data: bytes) -> bytes:
    """Torn-write seam of every snapshot payload."""
    plane = _DISK
    if plane is None:
        return data
    return plane.filter(path, data, "write")


class DiskFaultRule:
    """One rule: ``op`` in DISK_OPS, ``path`` a substring ("*" matches
    any file), and one effect: ``errno_`` raises OSError, ``flip_offset``
    XORs ``flip_mask`` into one byte read, ``truncate_to`` drops a
    write's tail. ``count`` bounds its firings (None: unbounded)."""

    _ids = itertools.count(1)

    def __init__(self, op: str, path: str = "*", errno_: int | None = None,
                 flip_offset: int | None = None, flip_mask: int = 0x01,
                 truncate_to: int | None = None, count: int | None = None):
        if op not in DISK_OPS:
            raise ValueError(
                f"unknown disk fault op {op!r} (want one of {DISK_OPS})"
            )
        if errno_ is None and flip_offset is None and truncate_to is None:
            raise ValueError(
                "disk fault rule needs errno_, flip_offset, or truncate_to"
            )
        self.id = next(DiskFaultRule._ids)
        self.op = op
        self.path = path
        self.errno_ = errno_
        self.flip_offset = flip_offset
        self.flip_mask = int(flip_mask) & 0xFF
        self.truncate_to = truncate_to
        self.count = count if count is None else int(count)
        self.matched = 0

    def matches(self, op: str, path: str) -> bool:
        if self.count is not None and self.matched >= self.count:
            return False
        if self.op != op:
            return False
        return self.path == "*" or self.path in path

    def to_json(self) -> dict:
        return {
            "id": self.id, "op": self.op, "path": self.path,
            "errno": self.errno_, "flipOffset": self.flip_offset,
            "flipMask": self.flip_mask, "truncateTo": self.truncate_to,
            "count": self.count, "matched": self.matched,
        }


class DiskFaultPlane:
    """The rule set and the intercepts the storage seams call."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rules: list[DiskFaultRule] = []
        self.read_faults = 0
        self.write_faults = 0
        self.fsync_faults = 0

    def add(self, op: str, path: str = "*", **kw) -> DiskFaultRule:
        rule = DiskFaultRule(op, path=path, **kw)
        with self._lock:
            self.rules.append(rule)
        return rule

    def remove(self, rule_id: int) -> bool:
        with self._lock:
            before = len(self.rules)
            self.rules = [r for r in self.rules if r.id != rule_id]
            return len(self.rules) != before

    def check(self, op: str, path: str) -> None:
        with self._lock:
            for rule in self.rules:
                if rule.errno_ is None or not rule.matches(op, path):
                    continue
                rule.matched += 1
                if op == "fsync":
                    self.fsync_faults += 1
                elif op == "write":
                    self.write_faults += 1
                else:
                    self.read_faults += 1
                raise OSError(rule.errno_, os.strerror(rule.errno_), path)

    def filter(self, path: str, data: bytes, op: str) -> bytes:
        with self._lock:
            for rule in self.rules:
                if not rule.matches(op, path):
                    continue
                if op == "read" and rule.flip_offset is not None and data:
                    rule.matched += 1
                    self.read_faults += 1
                    buf = bytearray(data)
                    buf[rule.flip_offset % len(buf)] ^= rule.flip_mask or 0x01
                    data = bytes(buf)
                elif op == "write" and rule.truncate_to is not None:
                    rule.matched += 1
                    self.write_faults += 1
                    data = data[:rule.truncate_to]
            return data

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rules": [r.to_json() for r in self.rules],
                "readFaults": self.read_faults,
                "writeFaults": self.write_faults,
                "fsyncFaults": self.fsync_faults,
            }

"""Deterministic fault injection, the port's copy of
``pilosa_tpu.testing.faults``: the network plane, the crash points and
the disk plane.

**The network plane** intercepts requests that ride the keep-alive
pool (``parallel/connpool.py``). Each ``FaultRule`` matches one
direction of traffic, (source node, destination endpoint or name, route
prefix), and acts: ``drop`` raises a transport fault before any byte
leaves, ``delay`` sleeps ``delay_ms`` first, ``error`` answers a
synthetic status without contacting the peer, ``duplicate`` delivers
the request twice and returns the second answer. ``partition(a, b)``
is a pair of drop rules; ``install`` arms a plane, ``clear`` removes
it, ``active`` returns it. With no plane installed the pool pays one
module-global load and an ``is None`` test a request.

**Crash points**: ``crash_point(name)`` SIGKILLs the process when the
name is armed in-process (``arm_crash_point``) or by
``PILOSA_TPU_CRASH_POINT``.

**The disk plane**: the storage seams call three hooks,
``disk_check(op, path)`` just before the write or fsync it models (an
armed errno rule raises ``OSError`` there), ``disk_filter_read(path,
data)`` on every fragment read (a flip rule XORs a mask into one byte)
and ``disk_filter_write(path, data)`` on every snapshot payload (a
truncate rule drops its tail). With no plane installed each hook is one
module-global load and an ``is None`` test. ``install_disk`` arms a
plane, ``clear_disk`` removes it. The rules match by op and path
substring and fire at most ``count`` times, as the reference's do, so a
test trips both packages through the same seams.
"""

from __future__ import annotations

import itertools
import os
import signal
import threading
import time

# The one global the connpool hot path reads. None = off: the off-path
# cost is a module-attribute load and an identity test, nothing else.
_PLANE = None

_ENV_CRASH = os.environ.get("PILOSA_TPU_CRASH_POINT", "")
_armed_crash: set[str] = set()

ACTIONS = ("drop", "delay", "error", "duplicate")


def active():
    """The installed FaultPlane, or None (the normal state)."""
    return _PLANE


def install(plane: "FaultPlane | None" = None) -> "FaultPlane":
    """Install (and return) the global fault plane."""
    global _PLANE
    _PLANE = plane if plane is not None else FaultPlane()
    return _PLANE


def clear() -> None:
    """Uninstall the global plane: the wire is clean again."""
    global _PLANE
    _PLANE = None


def arm_crash_point(name: str) -> None:
    _armed_crash.add(name)


def disarm_crash_points() -> None:
    _armed_crash.clear()


def crash_point(name: str) -> None:
    """SIGKILL this process when ``name`` is armed — the hard-kill the
    crash-recovery oracle needs BETWEEN two specific control-plane
    steps (a timer-based kill cannot land there deterministically).
    SIGKILL, not sys.exit: no finally blocks, no flushes — the same
    shape as a power cut."""
    if not _armed_crash and not _ENV_CRASH:
        return
    if name in _armed_crash or name == _ENV_CRASH:
        os.kill(os.getpid(), signal.SIGKILL)


class FaultRule:
    """One match-and-act rule. ``src`` is the sender's registered node
    name (or ``*``); ``dst`` matches the destination ``host:port``
    endpoint OR its registered name (or ``*``); ``route`` is a path
    prefix (``*`` = any). ``count`` bounds how many requests the rule
    fires on (None = unlimited); an exhausted rule stops matching but
    stays listed with its hit count."""

    _ids = itertools.count(1)

    def __init__(self, action: str, src: str = "*", dst: str = "*",
                 route: str = "*", delay_ms: float = 0.0,
                 status: int = 503, count: int | None = None,
                 body: bytes = b'{"error": "fault injected"}'):
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (want one of {ACTIONS})"
            )
        self.id = next(FaultRule._ids)
        self.action = action
        self.src = src
        self.dst = dst
        self.route = route
        self.delay_ms = float(delay_ms)
        self.status = int(status)
        self.body = body
        self.count = count if count is None else int(count)
        self.matched = 0

    def matches(self, src: str, dst_endpoint: str, dst_name: str,
                route: str) -> bool:
        if self.count is not None and self.matched >= self.count:
            return False
        if self.src != "*" and self.src != src:
            return False
        if self.dst not in ("*", dst_endpoint, dst_name):
            return False
        if self.route != "*" and not route.startswith(self.route):
            return False
        return True

    def to_json(self) -> dict:
        return {
            "id": self.id, "action": self.action, "src": self.src,
            "dst": self.dst, "route": self.route,
            "delayMs": self.delay_ms, "status": self.status,
            "count": self.count, "matched": self.matched,
        }


class _Directive:
    """The folded effect of every matching rule on one request."""

    __slots__ = ("delay_s", "drop", "error", "duplicate")

    def __init__(self):
        self.delay_s = 0.0
        self.drop = False
        self.error: tuple[int, bytes] | None = None
        self.duplicate = False


class FaultPlane:
    """Rule registry + the per-request intercept connpool calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rules: list[FaultRule] = []
        # endpoint ("host:port") → node name, so rules written against
        # names (the operator's vocabulary) match wire endpoints
        self._names: dict[str, str] = {}
        self.dropped = 0
        self.delayed = 0
        self.errored = 0
        self.duplicated = 0

    # ------------------------------------------------------------- registry

    def name_endpoint(self, name: str, endpoint: str) -> None:
        with self._lock:
            self._names[endpoint] = name

    def add(self, action: str, src: str = "*", dst: str = "*",
            route: str = "*", **kw) -> FaultRule:
        rule = FaultRule(action, src=src, dst=dst, route=route, **kw)
        with self._lock:
            self.rules.append(rule)
        return rule

    def remove(self, rule_id: int) -> bool:
        with self._lock:
            before = len(self.rules)
            self.rules = [r for r in self.rules if r.id != rule_id]
            return len(self.rules) != before

    def clear_rules(self) -> None:
        with self._lock:
            self.rules = []

    def partition(self, a: str, b: str,
                  bidirectional: bool = True) -> list[FaultRule]:
        """Blackhole a→b (and b→a when bidirectional): the two nodes'
        requests to each other fail at transport, exactly like a
        network partition. Names or endpoints both work."""
        rules = [self.add("drop", src=a, dst=b)]
        if bidirectional:
            rules.append(self.add("drop", src=b, dst=a))
        return rules

    def isolate(self, node: str) -> list[FaultRule]:
        """Cut a node off entirely: nothing in, nothing out."""
        return [self.add("drop", src=node), self.add("drop", dst=node)]

    def heal(self) -> int:
        """Remove every drop rule (partitions end; other rule kinds —
        delay/error shaping — stay installed). Returns #removed."""
        with self._lock:
            keep = [r for r in self.rules if r.action != "drop"]
            removed = len(self.rules) - len(keep)
            self.rules = keep
        return removed

    # ------------------------------------------------------------ intercept

    def intercept(self, src: str, dst_endpoint: str,
                  route: str) -> _Directive | None:
        """Fold every matching rule into one directive (None = clean
        pass). Called by ConnectionPool.request for every request while
        a plane is installed; rule evaluation is O(rules) under one
        lock — this is a test/chaos surface, not a production path."""
        with self._lock:
            name = self._names.get(dst_endpoint, "")
            directive = None
            for rule in self.rules:
                if not rule.matches(src, dst_endpoint, name, route):
                    continue
                rule.matched += 1
                if directive is None:
                    directive = _Directive()
                if rule.action == "drop":
                    directive.drop = True
                    self.dropped += 1
                elif rule.action == "delay":
                    directive.delay_s += rule.delay_ms / 1000.0
                    self.delayed += 1
                elif rule.action == "error":
                    directive.error = (rule.status, rule.body)
                    self.errored += 1
                else:  # duplicate
                    directive.duplicate = True
                    self.duplicated += 1
            return directive

    def sleep(self, seconds: float) -> None:
        """Delay hook (overridable in tests for virtual time)."""
        time.sleep(seconds)

    # ---------------------------------------------------------- observability

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rules": [r.to_json() for r in self.rules],
                "names": dict(self._names),
                "dropped": self.dropped,
                "delayed": self.delayed,
                "errored": self.errored,
                "duplicated": self.duplicated,
            }


# --------------------------------------------------------------- disk plane

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

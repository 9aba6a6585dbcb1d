"""Request deadlines (the port's copy of ``pilosa_tpu.qos.deadline``).

A request carries a deadline from the HTTP edge (``X-Pilosa-Deadline-Ms``,
the remaining budget in integer milliseconds, or the server default)
through the API and the serving pipeline to the executor, which checks
it at the dispatch boundary: an expired request raises before any kernel
is launched for it. Expiry maps to HTTP 504.
"""

from __future__ import annotations

import time

# Remaining request budget in integer milliseconds on inter-node hops.
DEADLINE_HEADER = "X-Pilosa-Deadline-Ms"
# Admission-control tenant identity (header-derived quotas).
TENANT_HEADER = "X-Pilosa-Tenant"


class DeadlineExceeded(Exception):
    """The request's deadline passed before its work completed (HTTP
    504). A property of the request, not of the node."""


class Deadline:
    """Absolute deadline on the local monotonic clock."""

    __slots__ = ("_at",)

    def __init__(self, at: float):
        self._at = at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    @classmethod
    def from_millis(cls, millis: int) -> "Deadline":
        """Re-anchor a wire budget (remaining ms) on this node's clock."""
        return cls(time.monotonic() + millis / 1000.0)

    def remaining(self) -> float:
        return self._at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "request") -> None:
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(
                f"deadline exceeded ({what}, {-rem * 1e3:.0f}ms past)"
            )

    def to_millis(self) -> int:
        """Remaining budget for the wire; >= 1 so an in-flight hop never
        serializes to a zero budget (expiry is raised locally instead)."""
        return max(1, int(self.remaining() * 1000))

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"

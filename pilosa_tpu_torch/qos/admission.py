"""Admission control: a token gate in front of the serving pipeline (the
port's copy of ``pilosa_tpu.qos.admission``).

The gate bounds concurrent in-flight queries, for the whole node and per
tenant (the ``X-Pilosa-Tenant`` header), and sheds the excess with 429
and a Retry-After hint instead of letting the pipeline's queue grow.
Only edge requests are gated: a peer's sub-query (``remote=true``) was
admitted once at its root.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class AdmissionError(Exception):
    """Request shed at admission (HTTP 429). ``retry_after`` is the
    client backoff hint in seconds (Retry-After header)."""

    def __init__(self, message: str, retry_after: float = 1.0,
                 tenant: str = "default"):
        super().__init__(message)
        self.retry_after = retry_after
        self.tenant = tenant


class AdmissionSlot:
    """One admitted request's token; release exactly once."""

    __slots__ = ("_controller", "tenant", "_released")

    def __init__(self, controller: "AdmissionController", tenant: str):
        self._controller = controller
        self.tenant = tenant
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._controller._release(self.tenant)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AdmissionController:
    """Concurrent in-flight gate with per-tenant quotas.

    ``max_inflight`` bounds the whole node (0 = unlimited, gate off);
    ``tenant_max`` bounds one tenant (0 = inherit the global limit), so a
    single hot tenant cannot starve the rest even when the node as a
    whole has headroom. In-flight counts are tracked either way, so
    /metrics shows queue pressure before an operator turns the gate on.
    """

    def __init__(self, max_inflight: int = 0, tenant_max: int = 0,
                 retry_after: float = 1.0, stats=None):
        self.max_inflight = max_inflight
        self.tenant_max = tenant_max
        self.retry_after = retry_after
        self._stats = stats
        self._lock = threading.Lock()
        self._inflight = 0
        self._by_tenant: dict[str, int] = defaultdict(int)
        self.admitted = 0
        self.shed = 0

    def admit(self, tenant: str = "default") -> AdmissionSlot:
        """Take one in-flight token or raise AdmissionError (→ 429)."""
        with self._lock:
            if 0 < self.max_inflight <= self._inflight:
                self.shed += 1
                reason = (f"server at admission limit "
                          f"({self._inflight}/{self.max_inflight} in flight)")
            else:
                limit = self.tenant_max or self.max_inflight
                if 0 < limit <= self._by_tenant[tenant]:
                    self.shed += 1
                    reason = (f"tenant {tenant!r} at admission limit "
                              f"({self._by_tenant[tenant]}/{limit} in flight)")
                else:
                    self._inflight += 1
                    self._by_tenant[tenant] += 1
                    self.admitted += 1
                    return AdmissionSlot(self, tenant)
        if self._stats is not None:
            self._stats.count("qos_shed", 1, {"tenant": tenant})
        raise AdmissionError(reason, retry_after=self.retry_after,
                             tenant=tenant)

    def _release(self, tenant: str) -> None:
        with self._lock:
            self._inflight -= 1
            n = self._by_tenant[tenant] - 1
            if n <= 0:
                self._by_tenant.pop(tenant, None)
            else:
                self._by_tenant[tenant] = n

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def metrics(self) -> dict:
        with self._lock:
            return {
                "admitted_total": self.admitted,
                "shed_total": self.shed,
                "inflight": self._inflight,
            }

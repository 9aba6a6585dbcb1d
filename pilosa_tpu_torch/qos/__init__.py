"""Serving QoS (the port's copy of ``pilosa_tpu.qos``): admission control,
deadlines, the hedge policy and breakers, and the SLO engine.

A query is admitted (or shed 429) at the HTTP edge and carries a deadline
through the API, the serving pipeline and the executor.
"""

from pilosa_tpu_torch.qos.admission import (
    AdmissionController,
    AdmissionError,
    AdmissionSlot,
)
from pilosa_tpu_torch.qos.deadline import (
    DEADLINE_HEADER,
    TENANT_HEADER,
    Deadline,
    DeadlineExceeded,
)
from pilosa_tpu_torch.qos.hedge import (
    CircuitBreaker,
    HedgePolicy,
    LatencyTracker,
    ServingQos,
)
from pilosa_tpu_torch.qos.slo import SLOEngine, SLOObjective

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "AdmissionSlot",
    "CircuitBreaker",
    "DEADLINE_HEADER",
    "TENANT_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "HedgePolicy",
    "LatencyTracker",
    "SLOEngine",
    "SLOObjective",
    "ServingQos",
]

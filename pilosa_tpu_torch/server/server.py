"""Server: a holder, its executor and the HTTP listener, opened together.

The port's thin counterpart of ``pilosa_tpu.server.server``; the CLI's
``server`` subcommand runs one. ``durability_mode``,
``group_commit_max_ms`` and ``group_commit_max_ops`` are the reference's
knobs, with its defaults (group commit, 2.0 ms, 256 ops), and so are the
residency tiering knobs, with its defaults and validation errors:
``residency_host_tier_bytes`` (the host tier's budget, 1 GiB),
``residency_promote_interval`` (seconds between tiering passes; 0, the
default, runs no tierer), ``residency_promote_heat`` (4.0) and
``residency_demote_heat`` (1.0). A tierer starts with the server when
the interval is above 0 and stops at its close. So do the integrity
knobs: ``scrub_interval`` (seconds between scrubber passes; 0, the
default, runs no scrubber) and ``scrub_max_bytes_per_sec`` (the
scrubber's read budget; 0 unpaced). A scrubber starts at open when the
interval is above 0 and is the first thing closed. The serving
envelope's knobs are the reference's too: the admission gate and the
default deadline (``qos_max_inflight``, ``qos_tenant_inflight``,
``qos_default_deadline``), the hedge and breaker knobs (built and
reported; nothing fans out on one node), ``slo_objectives`` and
``slo_windows``, ``tracing`` and ``trace_sample_rate`` (the global
tracer's rate), ``trace_log_dir`` (``POST /debug/trace-device``),
``long_query_time`` and ``slow_query_ring`` (the slow-query ring),
``result_cache_bytes`` (the process's result cache; 0 turns it off and
empties it), ``ingest_workers`` (the import pool) and ``heat_half_life``
(the decay half-life of the heat map and of the result cache's scores).

``ServerConfig`` is the reference's whole configuration (its names,
defaults, parsing and validation; durations as Go strings such as
"90s"): ``server_kwargs()`` gives a Server its ported knobs, and
``unported()`` names the knobs of planes the port lacks that are set.
``use_mesh``, ``mesh_groups`` and ``topn_quantized_ranking`` choose the
executor: a ``DistExecutor`` over the visible CUDA devices (the holder's
device on the CPU), factored into ``mesh_groups`` groups, ranking TopN
and gating GroupBy pruning over the 8-bit lane, when ``use_mesh`` is
set, or when it is unset and more than one CUDA device is visible; the
plain ``Executor`` otherwise, so one card serves as before.

Multi-process serving: ``serving_workers`` > 0 (the
``serving-workers`` knob, or ``PILOSA_TPU_SERVING_WORKERS``) makes
``open`` bind the full HTTP surface on loopback and start that many
``SO_REUSEPORT`` worker processes on ``bind:port``
(``start_serving_workers``, ``serving/mpserve.py``), each with a pair of
``ring_slots`` x ``ring_slot_bytes`` shared-memory rings; ``port`` is
then the workers'. Without ``SO_REUSEPORT`` the server warns and serves
from one process. The owner keeps its device and executor.

``config_from_dict`` reads the knobs above (snake case too),
``config_from_toml`` from a TOML file, and ``Server.config()`` dumps
them under the same names.
"""

from __future__ import annotations

import collections
import logging

import torch

from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel import DistExecutor
from pilosa_tpu_torch.parallel.scrub import Scrubber
from pilosa_tpu_torch.qos import ServingQos, SLOEngine
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import serve_in_thread
from pilosa_tpu_torch.storage import Holder
from pilosa_tpu_torch.storage.heat import global_heat
from pilosa_tpu_torch.storage.residency import (
    DEFAULT_BUDGET_BYTES,
    DEFAULT_HOST_BUDGET_BYTES,
)
from pilosa_tpu_torch.storage.tiering import (
    DEFAULT_DEMOTE_HEAT,
    DEFAULT_PROMOTE_HEAT,
    ResidencyTierer,
)
from pilosa_tpu_torch.storage.wal import (
    DEFAULT_GROUP_MAX_MS,
    DEFAULT_GROUP_MAX_OPS,
    DURABILITY_MODES,
    MODE_GROUP,
)
from pilosa_tpu_torch.serving.mpserve import (
    MAX_WORKERS,
    mp_unsupported_reason,
)
from pilosa_tpu_torch.serving.rescache import global_result_cache
from pilosa_tpu_torch.utils.durations import parse_duration
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.utils.tracing import (
    global_tracer,
    prepare_device_tracing,
)


def _parse_bool(value) -> bool:
    """TOML gives real bools; env vars give strings ('false', '0', ...)."""
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "t", "yes", "on")
    return bool(value)


def _parse_list(value) -> list[str]:
    if isinstance(value, str):
        return [v.strip() for v in value.split(",") if v.strip()]
    return list(value)


# The serving envelope's knobs, under their config names.
SERVING_KNOBS = (
    "qos-max-inflight", "qos-tenant-inflight", "qos-default-deadline",
    "qos-hedge-delay", "qos-hedge-budget", "qos-breaker-threshold",
    "qos-breaker-cooldown", "slo-objectives", "slo-windows", "tracing",
    "trace-sample-rate", "trace-log-dir", "long-query-time",
    "slow-query-ring", "result-cache-bytes", "ingest-workers",
    "heat-half-life",
)

# The device mesh's knobs (the executor the server builds).
MESH_KNOBS = ("use-mesh", "mesh-groups", "topn-quantized-ranking")

# Multi-process serving's knobs (serving/mpserve.py).
MP_KNOBS = ("serving-workers", "ring-slots", "ring-slot-bytes")


class ServerConfig:
    """The reference's server configuration: every knob under its config
    name, with its defaults, parsing (``from_dict``) and validation
    errors, so ``config`` prints the reference's resolved config for the
    same file. The port serves the knobs in ``PORTED``; ``unported()``
    names each other knob set to anything but its default, and the
    ``server`` verb refuses those."""

    # the knobs whose planes the port has
    PORTED = frozenset((
        "data-dir", "bind", "port", "verbose", "device-budget-bytes",
        "max-writes-per-request", "durability-mode", "group-commit-max-ms",
        "group-commit-max-ops", "verify-on-load", "scrub-interval",
        "scrub-max-bytes-per-sec", "residency-promote-interval",
        "residency-promote-heat", "residency-demote-heat",
        "residency-host-tier-bytes",
    ) + SERVING_KNOBS + MESH_KNOBS + MP_KNOBS)

    def __init__(
        self,
        data_dir: str = "~/.pilosa_tpu",
        bind: str = "localhost",
        port: int = 10101,
        anti_entropy_interval: float = 600.0,
        replica_n: int = 1,
        verbose: bool = False,
        device_budget_bytes: int | None = None,
        name: str = "",
        advertise: str = "",
        seeds: list[str] | None = None,
        heartbeat_interval: float = 5.0,
        heartbeat_timeout: float = 2.0,
        use_mesh: bool | None = None,
        mesh_groups: int = 0,
        topn_quantized_ranking: bool = False,
        tracing: bool = False,
        trace_sample_rate: float = 0.0,
        trace_log_dir: str = "",
        diagnostics_endpoint: str = "",
        statsd: str = "",
        long_query_time: float = 0.0,
        max_writes_per_request: int = 5000,
        ingest_workers: int = 1,
        tls_certificate: str = "",
        tls_key: str = "",
        tls_skip_verify: bool = False,
        qos_max_inflight: int = 0,
        qos_tenant_inflight: int = 0,
        qos_default_deadline: float = 0.0,
        qos_hedge_delay: float = 0.25,
        qos_hedge_budget: float = 0.05,
        qos_breaker_threshold: int = 5,
        qos_breaker_cooldown: float = 5.0,
        client_pool_size: int = 8,
        remote_batch: bool = True,
        sync_workers: int = 8,
        repair_max_bytes_per_sec: int = 0,
        repair_max_inflight: int = 0,
        repair_compression: bool = True,
        durability_mode: str = "group",
        group_commit_max_ms: float = 2.0,
        group_commit_max_ops: int = 256,
        slow_query_ring: int = 100,
        heat_half_life: float = 300.0,
        slo_objectives: list[str] | None = None,
        slo_windows: list[str] | None = None,
        verify_on_load: bool = True,
        scrub_interval: float = 0.0,
        scrub_max_bytes_per_sec: int = 0,
        serving_workers: int = 0,
        ring_slots: int = 1024,
        ring_slot_bytes: int = 65536,
        result_cache_bytes: int = 0,
        residency_promote_interval: float = 0.0,
        residency_promote_heat: float = 4.0,
        residency_demote_heat: float = 1.0,
        residency_host_tier_bytes: int = 1 << 30,
        autopilot_enabled: bool = False,
        autopilot_interval: float = 30.0,
        autopilot_heat_budget: float = 1.5,
        autopilot_max_moves: int = 4,
        autopilot_min_dwell: float = 0.0,
        autopilot_split_threshold: float = 0.0,
        autopilot_split_ways: int = 2,
        cdc_enabled: bool = False,
        cdc_max_retention_bytes: int = 64 << 20,
        cdc_poll_interval: float = 0.05,
        cdc_max_batch_bytes: int = 1 << 20,
        cdc_follow: str = "",
        cdc_staleness_budget: float = 1.0,
    ):
        self.data_dir = data_dir
        self.bind = bind
        self.port = port
        self.anti_entropy_interval = anti_entropy_interval
        self.replica_n = replica_n
        self.verbose = verbose
        self.device_budget_bytes = device_budget_bytes
        self.name = name
        self.advertise = advertise
        self.seeds = seeds or []
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = float(heartbeat_timeout)
        if self.heartbeat_timeout <= 0:
            raise ValueError(
                f"invalid heartbeat-timeout {heartbeat_timeout!r} "
                "(want > 0)"
            )
        self.use_mesh = use_mesh
        if mesh_groups < 0:
            raise ValueError(
                f"invalid mesh-groups {mesh_groups!r} (want >= 0)"
            )
        self.mesh_groups = mesh_groups
        self.topn_quantized_ranking = bool(topn_quantized_ranking)
        self.tracing = tracing
        self.trace_sample_rate = float(trace_sample_rate)
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(
                f"invalid trace-sample-rate {trace_sample_rate!r} "
                "(want 0.0..1.0)"
            )
        self.trace_log_dir = trace_log_dir
        self.diagnostics_endpoint = diagnostics_endpoint
        self.statsd = statsd
        self.long_query_time = long_query_time
        self.max_writes_per_request = max_writes_per_request
        self.ingest_workers = ingest_workers
        self.tls_certificate = tls_certificate
        self.tls_key = tls_key
        self.tls_skip_verify = tls_skip_verify
        self.qos_max_inflight = qos_max_inflight
        self.qos_tenant_inflight = qos_tenant_inflight
        self.qos_default_deadline = qos_default_deadline
        self.qos_hedge_delay = qos_hedge_delay
        self.qos_hedge_budget = qos_hedge_budget
        self.qos_breaker_threshold = qos_breaker_threshold
        self.qos_breaker_cooldown = qos_breaker_cooldown
        self.client_pool_size = client_pool_size
        self.remote_batch = remote_batch
        self.sync_workers = sync_workers
        self.repair_max_bytes_per_sec = repair_max_bytes_per_sec
        self.repair_max_inflight = repair_max_inflight
        self.repair_compression = repair_compression
        if durability_mode not in DURABILITY_MODES:
            raise ValueError(
                f"invalid durability-mode {durability_mode!r} "
                f"(want one of {', '.join(DURABILITY_MODES)})"
            )
        self.durability_mode = durability_mode
        self.group_commit_max_ms = float(group_commit_max_ms)
        self.group_commit_max_ops = int(group_commit_max_ops)
        self.slow_query_ring = int(slow_query_ring)
        if self.slow_query_ring < 1:
            raise ValueError(
                f"invalid slow-query-ring {slow_query_ring!r} (want >= 1)"
            )
        self.heat_half_life = float(heat_half_life)
        if self.heat_half_life <= 0:
            raise ValueError(
                f"invalid heat-half-life {heat_half_life!r} (want > 0)"
            )
        self.slo_objectives = list(slo_objectives or [])
        self.slo_windows = list(slo_windows or [])
        self.verify_on_load = _parse_bool(verify_on_load)
        self.scrub_interval = float(scrub_interval)
        if self.scrub_interval < 0:
            raise ValueError(
                f"invalid scrub-interval {scrub_interval!r} (want >= 0)"
            )
        self.scrub_max_bytes_per_sec = int(scrub_max_bytes_per_sec)
        self.serving_workers = int(serving_workers)
        if not 0 <= self.serving_workers <= MAX_WORKERS:
            raise ValueError(
                f"invalid serving-workers {serving_workers!r} "
                f"(want 0..{MAX_WORKERS})"
            )
        self.ring_slots = int(ring_slots)
        if self.ring_slots < 2:
            raise ValueError(
                f"invalid ring-slots {ring_slots!r} (want >= 2)"
            )
        self.ring_slot_bytes = int(ring_slot_bytes)
        if self.ring_slot_bytes < 256:
            raise ValueError(
                f"invalid ring-slot-bytes {ring_slot_bytes!r} "
                "(want >= 256)"
            )
        self.result_cache_bytes = int(result_cache_bytes)
        if self.result_cache_bytes < 0:
            raise ValueError(
                f"invalid result-cache-bytes {result_cache_bytes!r} "
                "(want >= 0)"
            )
        self.residency_promote_interval = float(residency_promote_interval)
        if self.residency_promote_interval < 0:
            raise ValueError(
                "invalid residency-promote-interval "
                f"{residency_promote_interval!r} (want >= 0)"
            )
        self.residency_promote_heat = float(residency_promote_heat)
        self.residency_demote_heat = float(residency_demote_heat)
        if self.residency_demote_heat < 0:
            raise ValueError(
                f"invalid residency-demote-heat {residency_demote_heat!r} "
                "(want >= 0)"
            )
        if self.residency_promote_heat <= self.residency_demote_heat:
            raise ValueError(
                f"residency-promote-heat {residency_promote_heat!r} must "
                f"exceed residency-demote-heat {residency_demote_heat!r} "
                "(the gap IS the hysteresis dead band)"
            )
        self.residency_host_tier_bytes = int(residency_host_tier_bytes)
        if self.residency_host_tier_bytes < 0:
            raise ValueError(
                "invalid residency-host-tier-bytes "
                f"{residency_host_tier_bytes!r} (want >= 0)"
            )
        self.autopilot_enabled = _parse_bool(autopilot_enabled)
        self.autopilot_interval = float(autopilot_interval)
        if self.autopilot_interval <= 0:
            raise ValueError(
                f"invalid autopilot-interval {autopilot_interval!r} "
                "(want > 0; use autopilot-enabled=false to turn the "
                "planner off)"
            )
        self.autopilot_heat_budget = float(autopilot_heat_budget)
        if self.autopilot_heat_budget <= 1.0:
            raise ValueError(
                f"invalid autopilot-heat-budget {autopilot_heat_budget!r} "
                "(want > 1.0: the margin over mean node heat IS the "
                "hysteresis dead band)"
            )
        self.autopilot_max_moves = int(autopilot_max_moves)
        if self.autopilot_max_moves < 1:
            raise ValueError(
                f"invalid autopilot-max-moves {autopilot_max_moves!r} "
                "(want >= 1)"
            )
        self.autopilot_min_dwell = float(autopilot_min_dwell)
        if self.autopilot_min_dwell < 0:
            raise ValueError(
                f"invalid autopilot-min-dwell {autopilot_min_dwell!r} "
                "(want >= 0; 0 = two intervals)"
            )
        self.autopilot_split_threshold = float(autopilot_split_threshold)
        if self.autopilot_split_threshold < 0:
            raise ValueError(
                f"invalid autopilot-split-threshold "
                f"{autopilot_split_threshold!r} (want >= 0; 0 disables "
                "sub-shard splits)"
            )
        self.autopilot_split_ways = int(autopilot_split_ways)
        if self.autopilot_split_ways < 2:
            raise ValueError(
                f"invalid autopilot-split-ways {autopilot_split_ways!r} "
                "(want >= 2: a split needs at least two ranges)"
            )
        self.cdc_enabled = _parse_bool(cdc_enabled)
        self.cdc_max_retention_bytes = int(cdc_max_retention_bytes)
        if self.cdc_max_retention_bytes < 0:
            raise ValueError(
                f"invalid cdc-max-retention-bytes "
                f"{cdc_max_retention_bytes!r} (want >= 0)"
            )
        self.cdc_poll_interval = float(cdc_poll_interval)
        if self.cdc_poll_interval <= 0:
            raise ValueError(
                f"invalid cdc-poll-interval {cdc_poll_interval!r} "
                "(want > 0)"
            )
        self.cdc_max_batch_bytes = int(cdc_max_batch_bytes)
        if self.cdc_max_batch_bytes <= 0:
            raise ValueError(
                f"invalid cdc-max-batch-bytes {cdc_max_batch_bytes!r} "
                "(want > 0)"
            )
        self.cdc_follow = str(cdc_follow or "")
        self.cdc_staleness_budget = float(cdc_staleness_budget)
        if self.cdc_staleness_budget < 0:
            raise ValueError(
                f"invalid cdc-staleness-budget {cdc_staleness_budget!r} "
                "(want >= 0; 0 = unbounded)"
            )
        # built once to validate; Server.open builds the live engine
        SLOEngine.from_config(self.slo_objectives, self.slo_windows)

    @property
    def tls_enabled(self) -> bool:
        return bool(self.tls_certificate and self.tls_key)

    @classmethod
    def from_dict(cls, d: dict) -> "ServerConfig":
        d = dict(d)
        for k in list(d):
            if isinstance(k, str) and "_" in k:
                d.setdefault(k.replace("_", "-"), d[k])
        tls = d.get("tls") if isinstance(d.get("tls"), dict) else {}
        return cls(
            data_dir=d.get("data-dir", d.get("data_dir", "~/.pilosa_tpu")),
            bind=d.get("bind", "localhost"),
            port=int(d.get("port", 10101)),
            anti_entropy_interval=float(
                d.get("anti-entropy-interval", d.get("anti_entropy_interval", 600.0))
            ),
            replica_n=int(d.get("replica-n", d.get("replica_n", 1))),
            verbose=_parse_bool(d.get("verbose", False)),
            name=d.get("name", ""),
            advertise=d.get("advertise", ""),
            seeds=_parse_list(d.get("seeds", d.get("gossip-seeds", []))),
            heartbeat_interval=float(d.get("heartbeat-interval", 5.0)),
            heartbeat_timeout=parse_duration(
                d.get("heartbeat-timeout", d.get("heartbeat_timeout", 2.0))
            ),
            tracing=_parse_bool(d.get("tracing", False)),
            trace_sample_rate=float(
                d.get("trace-sample-rate", d.get("trace_sample_rate", 0.0))
            ),
            trace_log_dir=d.get("trace-log-dir",
                                d.get("trace_log_dir", "")),
            diagnostics_endpoint=d.get("diagnostics-endpoint", ""),
            statsd=d.get("statsd", ""),
            long_query_time=parse_duration(
                d.get("long-query-time", d.get("long_query_time", 0.0))
            ),
            max_writes_per_request=int(
                d.get("max-writes-per-request",
                      d.get("max_writes_per_request", 5000))
            ),
            ingest_workers=int(
                d.get("ingest-workers", d.get("ingest_workers", 1))
            ),
            tls_certificate=d.get("tls-certificate", tls.get("certificate", "")),
            tls_key=d.get("tls-key", tls.get("key", "")),
            tls_skip_verify=_parse_bool(
                d.get("tls-skip-verify", tls.get("skip-verify", False))
            ),
            device_budget_bytes=(
                int(d["device-budget-bytes"])
                if d.get("device-budget-bytes") not in (None, "") else None
            ),
            use_mesh=(
                _parse_bool(d["use-mesh"])
                if d.get("use-mesh") not in (None, "") else None
            ),
            mesh_groups=int(d.get("mesh-groups", 0) or 0),
            topn_quantized_ranking=_parse_bool(
                d.get("topn-quantized-ranking", False)
            ),
            qos_max_inflight=int(d.get("qos-max-inflight", 0)),
            qos_tenant_inflight=int(d.get("qos-tenant-inflight", 0)),
            qos_default_deadline=parse_duration(
                d.get("qos-default-deadline", 0.0)
            ),
            qos_hedge_delay=parse_duration(d.get("qos-hedge-delay", 0.25)),
            qos_hedge_budget=float(d.get("qos-hedge-budget", 0.05)),
            qos_breaker_threshold=int(d.get("qos-breaker-threshold", 5)),
            qos_breaker_cooldown=parse_duration(
                d.get("qos-breaker-cooldown", 5.0)
            ),
            client_pool_size=int(
                d.get("client-pool-size", d.get("client_pool_size", 8))
            ),
            remote_batch=_parse_bool(d.get("remote-batch", True)),
            sync_workers=int(
                d.get("sync-workers", d.get("sync_workers", 8))
            ),
            repair_max_bytes_per_sec=int(
                d.get("repair-max-bytes-per-sec",
                      d.get("repair_max_bytes_per_sec", 0))
            ),
            repair_max_inflight=int(
                d.get("repair-max-inflight",
                      d.get("repair_max_inflight", 0))
            ),
            repair_compression=_parse_bool(
                d.get("repair-compression",
                      d.get("repair_compression", True))
            ),
            durability_mode=str(
                d.get("durability-mode", d.get("durability_mode", "group"))
            ),
            group_commit_max_ms=float(
                d.get("group-commit-max-ms",
                      d.get("group_commit_max_ms", 2.0))
            ),
            group_commit_max_ops=int(
                d.get("group-commit-max-ops",
                      d.get("group_commit_max_ops", 256))
            ),
            slow_query_ring=int(
                d.get("slow-query-ring", d.get("slow_query_ring", 100))
            ),
            heat_half_life=parse_duration(
                d.get("heat-half-life", d.get("heat_half_life", 300.0))
            ),
            slo_objectives=_parse_list(
                d.get("slo-objectives", d.get("slo_objectives", []))
            ),
            slo_windows=_parse_list(
                d.get("slo-windows", d.get("slo_windows", []))
            ),
            verify_on_load=_parse_bool(
                d.get("verify-on-load", d.get("verify_on_load", True))
            ),
            scrub_interval=parse_duration(
                d.get("scrub-interval", d.get("scrub_interval", 0.0))
            ),
            scrub_max_bytes_per_sec=int(
                d.get("scrub-max-bytes-per-sec",
                      d.get("scrub_max_bytes_per_sec", 0))
            ),
            serving_workers=int(
                d.get("serving-workers", d.get("serving_workers", 0))
            ),
            ring_slots=int(
                d.get("ring-slots", d.get("ring_slots", 1024))
            ),
            ring_slot_bytes=int(
                d.get("ring-slot-bytes", d.get("ring_slot_bytes", 65536))
            ),
            result_cache_bytes=int(
                d.get("result-cache-bytes", d.get("result_cache_bytes", 0))
            ),
            residency_promote_interval=parse_duration(
                d.get("residency-promote-interval",
                      d.get("residency_promote_interval", 0.0))
            ),
            residency_promote_heat=float(
                d.get("residency-promote-heat",
                      d.get("residency_promote_heat", 4.0))
            ),
            residency_demote_heat=float(
                d.get("residency-demote-heat",
                      d.get("residency_demote_heat", 1.0))
            ),
            residency_host_tier_bytes=int(
                d.get("residency-host-tier-bytes",
                      d.get("residency_host_tier_bytes", 1 << 30))
            ),
            autopilot_enabled=_parse_bool(
                d.get("autopilot-enabled", False)
            ),
            autopilot_interval=parse_duration(
                d.get("autopilot-interval", 30.0)
            ),
            autopilot_heat_budget=float(
                d.get("autopilot-heat-budget", 1.5)
            ),
            autopilot_max_moves=int(
                d.get("autopilot-max-moves", 4)
            ),
            autopilot_min_dwell=parse_duration(
                d.get("autopilot-min-dwell", 0.0)
            ),
            autopilot_split_threshold=float(
                d.get("autopilot-split-threshold",
                      d.get("autopilot_split_threshold", 0.0))
            ),
            autopilot_split_ways=int(
                d.get("autopilot-split-ways",
                      d.get("autopilot_split_ways", 2))
            ),
            cdc_enabled=_parse_bool(d.get("cdc-enabled", False)),
            cdc_max_retention_bytes=int(
                d.get("cdc-max-retention-bytes", 64 << 20)
            ),
            cdc_poll_interval=parse_duration(
                d.get("cdc-poll-interval", 0.05)
            ),
            cdc_max_batch_bytes=int(
                d.get("cdc-max-batch-bytes", 1 << 20)
            ),
            cdc_follow=d.get("cdc-follow", ""),
            cdc_staleness_budget=parse_duration(
                d.get("cdc-staleness-budget", 1.0)
            ),
        )

    def to_dict(self) -> dict:
        return {
            "data-dir": self.data_dir,
            "bind": self.bind,
            "port": self.port,
            "anti-entropy-interval": self.anti_entropy_interval,
            "replica-n": self.replica_n,
            "verbose": self.verbose,
            "name": self.name,
            "advertise": self.advertise,
            "seeds": self.seeds,
            "heartbeat-interval": self.heartbeat_interval,
            "heartbeat-timeout": self.heartbeat_timeout,
            "tracing": self.tracing,
            "trace-sample-rate": self.trace_sample_rate,
            "trace-log-dir": self.trace_log_dir,
            "diagnostics-endpoint": self.diagnostics_endpoint,
            "statsd": self.statsd,
            "long-query-time": self.long_query_time,
            "max-writes-per-request": self.max_writes_per_request,
            "ingest-workers": self.ingest_workers,
            "tls-certificate": self.tls_certificate,
            "tls-key": self.tls_key,
            "tls-skip-verify": self.tls_skip_verify,
            "device-budget-bytes": self.device_budget_bytes,
            "use-mesh": self.use_mesh,
            "mesh-groups": self.mesh_groups,
            "topn-quantized-ranking": self.topn_quantized_ranking,
            "qos-max-inflight": self.qos_max_inflight,
            "qos-tenant-inflight": self.qos_tenant_inflight,
            "qos-default-deadline": self.qos_default_deadline,
            "qos-hedge-delay": self.qos_hedge_delay,
            "qos-hedge-budget": self.qos_hedge_budget,
            "qos-breaker-threshold": self.qos_breaker_threshold,
            "qos-breaker-cooldown": self.qos_breaker_cooldown,
            "client-pool-size": self.client_pool_size,
            "remote-batch": self.remote_batch,
            "sync-workers": self.sync_workers,
            "repair-max-bytes-per-sec": self.repair_max_bytes_per_sec,
            "repair-max-inflight": self.repair_max_inflight,
            "repair-compression": self.repair_compression,
            "durability-mode": self.durability_mode,
            "group-commit-max-ms": self.group_commit_max_ms,
            "group-commit-max-ops": self.group_commit_max_ops,
            "slow-query-ring": self.slow_query_ring,
            "heat-half-life": self.heat_half_life,
            "slo-objectives": self.slo_objectives,
            "slo-windows": self.slo_windows,
            "verify-on-load": self.verify_on_load,
            "scrub-interval": self.scrub_interval,
            "scrub-max-bytes-per-sec": self.scrub_max_bytes_per_sec,
            "serving-workers": self.serving_workers,
            "ring-slots": self.ring_slots,
            "ring-slot-bytes": self.ring_slot_bytes,
            "result-cache-bytes": self.result_cache_bytes,
            "residency-promote-interval": self.residency_promote_interval,
            "residency-promote-heat": self.residency_promote_heat,
            "residency-demote-heat": self.residency_demote_heat,
            "residency-host-tier-bytes": self.residency_host_tier_bytes,
            "autopilot-enabled": self.autopilot_enabled,
            "autopilot-interval": self.autopilot_interval,
            "autopilot-heat-budget": self.autopilot_heat_budget,
            "autopilot-max-moves": self.autopilot_max_moves,
            "autopilot-min-dwell": self.autopilot_min_dwell,
            "autopilot-split-threshold": self.autopilot_split_threshold,
            "autopilot-split-ways": self.autopilot_split_ways,
            "cdc-enabled": self.cdc_enabled,
            "cdc-max-retention-bytes": self.cdc_max_retention_bytes,
            "cdc-poll-interval": self.cdc_poll_interval,
            "cdc-max-batch-bytes": self.cdc_max_batch_bytes,
            "cdc-follow": self.cdc_follow,
            "cdc-staleness-budget": self.cdc_staleness_budget,
        }

    def unported(self) -> list[str]:
        """The knobs of planes the port lacks (cluster, CDC, autopilot,
        TLS, statsd, ...) set to anything but their defaults."""
        default = ServerConfig().to_dict()
        return [name for name, value in self.to_dict().items()
                if name not in self.PORTED and value != default[name]]

    def server_kwargs(self) -> dict:
        """``Server`` keyword arguments of the ported knobs (``verbose``
        is the CLI's: its logger)."""
        out = {name.replace("-", "_"): value
               for name, value in self.to_dict().items()
               if name in self.PORTED
               and name not in ("device-budget-bytes", "verbose")}
        if self.device_budget_bytes:
            out["budget_bytes"] = int(self.device_budget_bytes)
        return out



# The knobs ``config_from_dict`` reads, under their config names.
_KNOBS = ("verify-on-load", "durability-mode", "group-commit-max-ms",
          "group-commit-max-ops", "residency-host-tier-bytes",
          "residency-promote-interval", "residency-promote-heat",
          "residency-demote-heat", "scrub-interval",
          "scrub-max-bytes-per-sec") + SERVING_KNOBS + MESH_KNOBS + MP_KNOBS


def config_from_dict(d: dict) -> dict:
    """Server keyword arguments from a config mapping: the knobs ``d``
    names (kebab or snake case), parsed as ``ServerConfig`` parses them;
    the others keep their defaults."""
    named = {str(k).replace("_", "-") for k in d}
    cfg = ServerConfig.from_dict(d)
    return {name.replace("-", "_"): getattr(cfg, name.replace("-", "_"))
            for name in _KNOBS if name in named}


def config_from_toml(path: str) -> dict:
    """``config_from_dict`` of a TOML file."""
    import tomllib

    with open(path, "rb") as f:
        return config_from_dict(tomllib.load(f))


class Server:
    def __init__(self, data_dir: str, bind: str = "localhost",
                 port: int = 10101, device=None,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 verify_on_load: bool = True,
                 durability_mode: str = MODE_GROUP,
                 group_commit_max_ms: float = DEFAULT_GROUP_MAX_MS,
                 group_commit_max_ops: int = DEFAULT_GROUP_MAX_OPS,
                 residency_host_tier_bytes: int = DEFAULT_HOST_BUDGET_BYTES,
                 residency_promote_interval: float = 0.0,
                 residency_promote_heat: float = DEFAULT_PROMOTE_HEAT,
                 residency_demote_heat: float = DEFAULT_DEMOTE_HEAT,
                 scrub_interval: float = 0.0,
                 scrub_max_bytes_per_sec: int = 0,
                 max_writes_per_request: int = 5000,
                 qos_max_inflight: int = 0,
                 qos_tenant_inflight: int = 0,
                 qos_default_deadline: float = 0.0,
                 qos_hedge_delay: float = 0.25,
                 qos_hedge_budget: float = 0.05,
                 qos_breaker_threshold: int = 5,
                 qos_breaker_cooldown: float = 5.0,
                 slo_objectives: list[str] | None = None,
                 slo_windows: list[str] | None = None,
                 tracing: bool = False,
                 trace_sample_rate: float = 0.0,
                 trace_log_dir: str = "",
                 long_query_time: float = 0.0,
                 slow_query_ring: int = 100,
                 result_cache_bytes: int = 0,
                 ingest_workers: int = 1,
                 heat_half_life: float = 300.0,
                 use_mesh: bool | None = None,
                 mesh_groups: int = 0,
                 topn_quantized_ranking: bool = False,
                 serving_workers: int = 0,
                 ring_slots: int = 1024,
                 ring_slot_bytes: int = 65536):
        # the serving envelope's knobs, validated as ServerConfig does
        cfg = ServerConfig(
            qos_max_inflight=qos_max_inflight,
            qos_tenant_inflight=qos_tenant_inflight,
            qos_default_deadline=qos_default_deadline,
            qos_hedge_delay=qos_hedge_delay,
            qos_hedge_budget=qos_hedge_budget,
            qos_breaker_threshold=qos_breaker_threshold,
            qos_breaker_cooldown=qos_breaker_cooldown,
            slo_objectives=slo_objectives, slo_windows=slo_windows,
            tracing=tracing, trace_sample_rate=trace_sample_rate,
            trace_log_dir=trace_log_dir, long_query_time=long_query_time,
            slow_query_ring=slow_query_ring,
            result_cache_bytes=result_cache_bytes,
            ingest_workers=ingest_workers, heat_half_life=heat_half_life,
            use_mesh=use_mesh, mesh_groups=mesh_groups,
            topn_quantized_ranking=topn_quantized_ranking,
            serving_workers=serving_workers, ring_slots=ring_slots,
            ring_slot_bytes=ring_slot_bytes)
        self.serving_workers = cfg.serving_workers
        self.ring_slots = cfg.ring_slots
        self.ring_slot_bytes = cfg.ring_slot_bytes
        self.use_mesh = cfg.use_mesh
        self.mesh_groups = cfg.mesh_groups
        self.topn_quantized_ranking = cfg.topn_quantized_ranking
        for name in SERVING_KNOBS:
            attr = name.replace("-", "_")
            setattr(self, attr, getattr(cfg, attr))
        self.scrub_interval = float(scrub_interval)
        if self.scrub_interval < 0:
            raise ValueError(
                f"invalid scrub-interval {scrub_interval!r} (want >= 0)")
        self.scrub_max_bytes_per_sec = int(scrub_max_bytes_per_sec)
        self.residency_promote_interval = float(residency_promote_interval)
        if self.residency_promote_interval < 0:
            raise ValueError(
                "invalid residency-promote-interval "
                f"{residency_promote_interval!r} (want >= 0)"
            )
        self.residency_promote_heat = float(residency_promote_heat)
        self.residency_demote_heat = float(residency_demote_heat)
        if self.residency_demote_heat < 0:
            raise ValueError(
                f"invalid residency-demote-heat {residency_demote_heat!r} "
                "(want >= 0)"
            )
        if self.residency_promote_heat <= self.residency_demote_heat:
            raise ValueError(
                f"residency-promote-heat {residency_promote_heat!r} must "
                f"exceed residency-demote-heat {residency_demote_heat!r} "
                "(the gap IS the hysteresis dead band)"
            )
        self.residency_host_tier_bytes = int(residency_host_tier_bytes)
        if self.residency_host_tier_bytes < 0:
            raise ValueError(
                "invalid residency-host-tier-bytes "
                f"{residency_host_tier_bytes!r} (want >= 0)"
            )
        self.holder = Holder(data_dir, device=device,
                             budget_bytes=budget_bytes,
                             verify_on_load=verify_on_load,
                             durability_mode=durability_mode,
                             group_commit_max_ms=group_commit_max_ms,
                             group_commit_max_ops=group_commit_max_ops,
                             host_budget_bytes=self.residency_host_tier_bytes)
        self.verify_on_load = bool(verify_on_load)
        self.durability_mode = durability_mode
        self.group_commit_max_ms = float(group_commit_max_ms)
        self.group_commit_max_ops = int(group_commit_max_ops)
        self.max_writes_per_request = int(max_writes_per_request)
        self.bind = bind
        self._port = port
        self.api = None
        self._http = None
        self._thread = None
        self._mpserve = None  # the OwnerRuntime while workers serve

    @property
    def port(self) -> int:
        """The public port: the serving workers' while they run (the
        owner's own listener is then on loopback), the HTTP listener's
        otherwise."""
        if self._mpserve is not None:
            return self._mpserve.port
        return self._http.server_address[1] if self._http else self._port

    @property
    def executor(self):
        return self.api.executor

    def config(self) -> dict:
        """The knobs under their config names (``config_from_dict``'s
        inverse)."""
        return {name: getattr(self, name.replace("-", "_"))
                for name in _KNOBS}

    def open(self) -> "Server":
        # the process's result cache, sized here (0 turns it off and
        # drops what an earlier server in this process left), and the
        # heat half-life of its entries' scores and of the heat map
        global_result_cache().configure(self.result_cache_bytes,
                                        half_life_s=self.heat_half_life)
        global_heat().half_life_s = self.heat_half_life
        self.holder.open()
        try:
            executor = self._executor()
        except BaseException:
            self.holder.close()
            raise
        self.api = API(self.holder, executor)
        api = self.api
        api.max_writes_per_request = self.max_writes_per_request
        api.long_query_time = self.long_query_time
        api.long_queries = collections.deque(maxlen=self.slow_query_ring)
        api.slo = SLOEngine.from_config(self.slo_objectives,
                                        self.slo_windows)
        api.ingest_workers = max(1, self.ingest_workers)
        api.qos = ServingQos(
            max_inflight=self.qos_max_inflight,
            tenant_max=self.qos_tenant_inflight,
            hedge_delay=self.qos_hedge_delay,
            hedge_budget=self.qos_hedge_budget,
            breaker_threshold=self.qos_breaker_threshold,
            breaker_cooldown=self.qos_breaker_cooldown,
            stats=global_stats())
        api.default_deadline_s = self.qos_default_deadline
        api.trace_log_dir = self.trace_log_dir
        rate = self.trace_sample_rate
        if rate <= 0 and self.tracing:
            rate = 1.0  # `tracing = true`: every request
        # before the serving workers: each copies the sample rate from
        # its handshake
        global_tracer().sample_rate = rate
        prepare_device_tracing(self.holder.device)
        if self.residency_promote_interval > 0:
            # no pacer: the cluster's repair pacer is not ported yet
            self.api.tierer = ResidencyTierer(
                cache=self.holder.cache, heat=global_heat(),
                interval_s=self.residency_promote_interval,
                promote_heat=self.residency_promote_heat,
                demote_heat=self.residency_demote_heat,
            ).start()
        if self.scrub_interval > 0:
            self.api.scrubber = Scrubber(
                self.holder, interval_s=self.scrub_interval,
                max_bytes_per_sec=self.scrub_max_bytes_per_sec).start()
        mp_workers = 0
        if self.serving_workers > 0:
            reason = mp_unsupported_reason(self)
            if reason is None:
                mp_workers = self.serving_workers
            else:
                logging.getLogger("pilosa_tpu_torch").warning(
                    "multi-process serving disabled: %s (falling back to "
                    "single-process mode)", reason)
        # with workers the public port is theirs, and this process (the
        # device owner) keeps its whole HTTP surface on loopback
        self._http, _, self._thread = serve_in_thread(
            self.api, "127.0.0.1" if mp_workers else self.bind,
            0 if mp_workers else self._port)
        if mp_workers:
            try:
                self.start_serving_workers(mp_workers)
            except BaseException:
                self.close()
                raise
        return self

    def start_serving_workers(self, n_workers: int | None = None,
                              port: int | None = None,
                              ring_slots: int | None = None,
                              ring_slot_bytes: int | None = None):
        """Start multi-process serving over this open server: ``n_workers``
        (default ``serving_workers``) ``SO_REUSEPORT`` worker processes
        on ``bind:port`` (default the server's port; 0 picks a free one,
        as a server already listening on its own port needs), with rings
        of ``ring_slots`` x ``ring_slot_bytes`` (default the knobs').
        ``open`` calls it when ``serving-workers`` > 0; ``port`` is the
        workers' until ``stop_serving_workers``. Returns the
        ``OwnerRuntime``."""
        from pilosa_tpu_torch.serving.mpserve import OwnerRuntime

        if self._mpserve is not None:
            raise RuntimeError("serving workers are already running")
        runtime = OwnerRuntime(
            self, n_workers or self.serving_workers, self.bind,
            self._port if port is None else port,
            ring_slots or self.ring_slots,
            ring_slot_bytes or self.ring_slot_bytes).start()
        self._mpserve = runtime
        self.api.mpserve = runtime
        return runtime

    def stop_serving_workers(self) -> None:
        """Stop the workers and their rings; the owner's listener serves
        on alone."""
        if self._mpserve is not None:
            runtime, self._mpserve = self._mpserve, None
            self.api.mpserve = None
            runtime.close()

    def _executor(self):
        """The reference's choice: a mesh when use-mesh is set, or when it
        is unset and more than one CUDA device is visible."""
        use_mesh = self.use_mesh
        if use_mesh is None:
            use_mesh = (self.holder.device.type == "cuda"
                        and torch.cuda.device_count() > 1)
        if use_mesh:
            return DistExecutor(
                self.holder, groups=self.mesh_groups or None,
                quantized_ranking=self.topn_quantized_ranking)
        return Executor(self.holder, device=self.holder.device)

    def close(self) -> None:
        # the workers first: they proxy to the owner's listener, and one
        # outliving its owner would handshake into a closing runtime
        self.stop_serving_workers()
        if self.api is not None and self.api.scrubber is not None:
            self.api.scrubber.close()  # no pass may walk a closing holder
        if self.api is not None and self.api.tierer is not None:
            self.api.tierer.close()
            self.api.tierer = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._thread.join(timeout=10)
            self._http = None
        self.holder.close()

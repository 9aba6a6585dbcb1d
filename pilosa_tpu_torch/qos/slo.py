"""SLO engine: declarative latency/error objectives with multi-window
burn rates (the port's copy of ``pilosa_tpu.qos.slo``).

Objectives come from ``slo-objectives`` as compact specs:

    "reads:latency:100ms:0.99"   99% of queries complete under 100 ms
    "avail:errors:0.999"         99.9% of queries succeed (no 5xx)

Every edge query feeds one good or bad event per objective into
1-second buckets; burn rates are computed at read time over the
``slo-windows`` (default 300 s and 3600 s): (bad fraction over the
window) / (1 - target). ``slo_breach{objective=}`` is 1 when every
window burns above 1.0; ``GET /debug/slo`` serves the same rows.
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.utils.stats import (
    _meta_lines,
    escape_label,
    prometheus_block,
)

DEFAULT_WINDOWS_S = (300.0, 3600.0)

# the durations of every other knob's grammar
from pilosa_tpu_torch.utils.durations import parse_duration as _parse_duration_s


class SLOObjective:
    """One declarative objective. ``kind`` is ``latency`` (good = no
    error AND under threshold) or ``errors`` (good = no server error)."""

    __slots__ = ("name", "kind", "threshold_s", "target")

    def __init__(self, name: str, kind: str, target: float,
                 threshold_s: float | None = None):
        if kind not in ("latency", "errors"):
            raise ValueError(
                f"objective {name!r}: kind must be latency or errors, "
                f"got {kind!r}"
            )
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"objective {name!r}: target must be in (0, 1), "
                f"got {target!r}"
            )
        if kind == "latency" and (threshold_s is None or threshold_s <= 0):
            raise ValueError(
                f"objective {name!r}: latency objectives need a positive "
                "threshold"
            )
        self.name = name
        self.kind = kind
        self.threshold_s = threshold_s
        self.target = target

    def is_bad(self, latency_s: float, error: bool) -> bool:
        if self.kind == "errors":
            return error
        return error or latency_s > self.threshold_s

    @classmethod
    def parse(cls, spec: str) -> "SLOObjective":
        """``name:latency:<threshold>:<target>`` or
        ``name:errors:<target>`` — raises ValueError on malformed specs
        so a typo fails at config load, not silently at runtime."""
        parts = [p.strip() for p in str(spec).split(":")]
        if len(parts) == 4 and parts[1] == "latency":
            return cls(parts[0], "latency", float(parts[3]),
                       threshold_s=_parse_duration_s(parts[2]))
        if len(parts) == 3 and parts[1] == "errors":
            return cls(parts[0], "errors", float(parts[2]))
        raise ValueError(
            f"invalid slo objective {spec!r} (want "
            "'name:latency:100ms:0.99' or 'name:errors:0.999')"
        )

    def to_json(self) -> dict:
        out = {"name": self.name, "kind": self.kind, "target": self.target}
        if self.threshold_s is not None:
            out["thresholdMs"] = round(self.threshold_s * 1e3, 3)
        return out


class SLOEngine:
    """Bucketed good/bad event stream + lazy multi-window burn rates."""

    def __init__(self, objectives: list[SLOObjective] | None = None,
                 windows_s=DEFAULT_WINDOWS_S):
        self.objectives = list(objectives or [])
        self.windows_s = tuple(float(w) for w in windows_s) or \
            DEFAULT_WINDOWS_S
        if any(w <= 0 for w in self.windows_s):
            raise ValueError("slo windows must be positive seconds")
        self._lock = threading.Lock()
        # per objective: {epoch_second: [total, bad]}
        self._buckets: list[dict[int, list]] = [
            {} for _ in self.objectives
        ]
        self.events_total = 0

    @classmethod
    def from_config(cls, objective_specs, windows_spec=None) -> "SLOEngine":
        objectives = [SLOObjective.parse(s) for s in (objective_specs or [])]
        windows = (tuple(_parse_duration_s(w) for w in windows_spec)
                   if windows_spec else DEFAULT_WINDOWS_S)
        return cls(objectives, windows)

    # ------------------------------------------------------------ recording

    def record(self, latency_s: float, error: bool = False) -> None:
        if not self.objectives:
            return
        sec = int(time.time())
        with self._lock:
            self.events_total += 1
            for i, obj in enumerate(self.objectives):
                buckets = self._buckets[i]
                b = buckets.get(sec)
                if b is None:
                    b = buckets[sec] = [0, 0]
                    self._prune_locked(buckets, sec)
                b[0] += 1
                if obj.is_bad(latency_s, error):
                    b[1] += 1

    def _prune_locked(self, buckets: dict, now_sec: int) -> None:
        horizon = now_sec - int(max(self.windows_s)) - 5
        if len(buckets) > max(self.windows_s) + 16:
            for k in [k for k in buckets if k < horizon]:
                del buckets[k]

    # ----------------------------------------------------------- evaluation

    def _window_stats(self, i: int, window_s: float,
                      now_sec: int) -> tuple[int, int]:
        lo = now_sec - int(window_s)
        total = bad = 0
        for sec, (t, b) in self._buckets[i].items():
            if sec > lo:
                total += t
                bad += b
        return total, bad

    def burn_rates(self) -> list[dict]:
        """One row per objective: per-window burn rates + the breach
        flag (every window burning above 1.0)."""
        now_sec = int(time.time())
        out = []
        with self._lock:
            for i, obj in enumerate(self.objectives):
                budget = 1.0 - obj.target
                row = obj.to_json()
                row["windows"] = {}
                burning = bool(self.windows_s)
                for w in self.windows_s:
                    total, bad = self._window_stats(i, w, now_sec)
                    rate = ((bad / total) / budget) if total else 0.0
                    row["windows"][f"{int(w)}s"] = {
                        "events": total, "bad": bad,
                        "burnRate": round(rate, 4),
                    }
                    if rate < 1.0:
                        burning = False
                row["breach"] = burning
                out.append(row)
        return out

    def to_json(self) -> dict:
        return {
            "windows": [int(w) for w in self.windows_s],
            "eventsTotal": self.events_total,
            "objectives": self.burn_rates(),
        }

    def metrics(self, rows: list | None = None) -> dict:
        """Flat summary for /debug/vars (tagged gauges ride
        prometheus_lines). ``rows`` lets a caller that already computed
        burn_rates() avoid a second bucket walk per scrape."""
        if rows is None:
            rows = self.burn_rates()
        return {
            "objectives": len(self.objectives),
            "events_total": self.events_total,
            "breaching": sum(1 for r in rows if r["breach"]),
        }

    def prometheus_lines(self, prefix: str, seen: set | None = None) -> str:
        seen = seen if seen is not None else set()
        rows = self.burn_rates()  # ONE bucket walk per scrape
        text = prometheus_block(self.metrics(rows), prefix, "slo",
                                seen=seen)
        lines: list[str] = []
        burn = f"{prefix}_slo_burn_rate"
        lines.extend(_meta_lines(
            burn, "gauge", "error-budget burn rate per objective per "
            "window (1.0 = budget consumed exactly at the sustainable "
            "rate)", seen,
        ))
        for r in rows:
            for wname, w in r["windows"].items():
                lines.append(
                    f'{burn}{{objective="{escape_label(r["name"])}",'
                    f'window="{wname}"}} {w["burnRate"]:g}'
                )
        breach = f"{prefix}_slo_breach"
        lines.extend(_meta_lines(
            breach, "gauge", "1 when every window burns above 1.0 "
            "(multi-window AND)", seen,
        ))
        for r in rows:
            lines.append(
                f'{breach}{{objective="{escape_label(r["name"])}"}} '
                f'{1 if r["breach"] else 0}'
            )
        return text + "\n".join(lines) + ("\n" if lines else "")

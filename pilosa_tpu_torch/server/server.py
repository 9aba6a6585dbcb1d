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
interval is above 0 and is the first thing closed.

``config_from_dict`` reads these knobs under the reference's config
names (``scrub-interval``, ...; snake case too, durations as Go
strings such as "90s"), ``config_from_toml`` from a TOML file, and
``Server.config()`` dumps them under the same names.
"""

from __future__ import annotations

import re

from pilosa_tpu_torch.parallel.scrub import Scrubber
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
    MODE_GROUP,
)

_NUMBER = r"[0-9]+(?:\.[0-9]+)?|\.[0-9]+"
_COMPOUND_RE = re.compile(rf"^(?:(?:{_NUMBER})(?:ms|us|s|m|h))+$")
_PARTS_RE = re.compile(rf"({_NUMBER})(ms|us|s|m|h)")
_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(value) -> float:
    """Seconds from a number or a Go-style duration string ("1m30s",
    "500ms"); "" is 0, anything else malformed a ValueError."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    if not s:
        return 0.0
    if _COMPOUND_RE.fullmatch(s):
        return sum(float(num) * _UNITS[unit]
                   for num, unit in _PARTS_RE.findall(s))
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"invalid duration: {value!r}") from None


def _parse_bool(value) -> bool:
    """A TOML bool, or a string such as "false" or "1"."""
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "t", "yes", "on")
    return bool(value)


# Every Server knob under its reference config name, with its parser.
_KNOBS = (
    ("verify-on-load", _parse_bool),
    ("durability-mode", str),
    ("group-commit-max-ms", float),
    ("group-commit-max-ops", int),
    ("residency-host-tier-bytes", int),
    ("residency-promote-interval", parse_duration),
    ("residency-promote-heat", float),
    ("residency-demote-heat", float),
    ("scrub-interval", parse_duration),
    ("scrub-max-bytes-per-sec", int),
)


def config_from_dict(d: dict) -> dict:
    """Server keyword arguments from a config mapping: the knobs ``d``
    names (kebab or snake case), parsed; the others keep their
    defaults."""
    out = {}
    for name, parse in _KNOBS:
        arg = name.replace("-", "_")
        for key in (name, arg):
            if key in d:
                out[arg] = parse(d[key])
                break
    return out


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
                 scrub_max_bytes_per_sec: int = 0):
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
        self.bind = bind
        self._port = port
        self.api = None
        self._http = None
        self._thread = None

    @property
    def port(self) -> int:
        return self._http.server_address[1] if self._http else self._port

    @property
    def executor(self):
        return self.api.executor

    def config(self) -> dict:
        """The knobs under their config names (``config_from_dict``'s
        inverse)."""
        return {name: getattr(self, name.replace("-", "_"))
                for name, _ in _KNOBS}

    def open(self) -> "Server":
        self.holder.open()
        self.api = API(self.holder)
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
        self._http, _, self._thread = serve_in_thread(self.api, self.bind,
                                                      self._port)
        return self

    def close(self) -> None:
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

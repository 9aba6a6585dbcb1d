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
the interval is above 0 and stops at its close.
"""

from __future__ import annotations

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
                 residency_demote_heat: float = DEFAULT_DEMOTE_HEAT):
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
        self._http, _, self._thread = serve_in_thread(self.api, self.bind,
                                                      self._port)
        return self

    def close(self) -> None:
        if self.api is not None and self.api.tierer is not None:
            self.api.tierer.close()
            self.api.tierer = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._thread.join(timeout=10)
            self._http = None
        self.holder.close()

"""Diagnostics report (the port's copy of
``pilosa_tpu.utils.diagnostics``): an hourly usage report (version,
platform, node and index counts) POSTed to ``diagnostics-endpoint``.
Off unless an endpoint is set; a failed report is dropped.
"""

from __future__ import annotations

import json
import threading
import urllib.request

DEFAULT_INTERVAL = 3600.0


class DiagnosticsCollector:
    def __init__(self, api, endpoint: str = "", interval: float = DEFAULT_INTERVAL):
        self.api = api
        self.endpoint = endpoint
        self.interval = interval
        self._timer: threading.Timer | None = None
        self._closed = False

    @property
    def enabled(self) -> bool:
        return bool(self.endpoint)

    def payload(self) -> dict:
        import platform

        from pilosa_tpu_torch import __version__

        info = {
            "version": __version__,
            "os": platform.system(),
            "arch": platform.machine(),
            "numNodes": 1,
            "numIndexes": len(self.api.holder.indexes),
        }
        return info

    def start(self) -> None:
        if not self.enabled or self._closed:
            return
        self._timer = threading.Timer(self.interval, self._flush)
        self._timer.daemon = True
        self._timer.start()

    def _flush(self) -> None:
        try:
            req = urllib.request.Request(
                self.endpoint,
                data=json.dumps(self.payload()).encode(),
                method="POST",
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=10)
        except Exception:
            pass  # diagnostics must never disturb the server
        self.start()

    def close(self) -> None:
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()

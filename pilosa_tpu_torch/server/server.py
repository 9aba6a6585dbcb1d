"""Server: a holder, its executor and the HTTP listener, opened together.

The port's thin counterpart of ``pilosa_tpu.server.server``; the CLI's
``server`` subcommand runs one. ``durability_mode``,
``group_commit_max_ms`` and ``group_commit_max_ops`` are the reference's
knobs, with its defaults (group commit, 2.0 ms, 256 ops).
"""

from __future__ import annotations

from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import serve_in_thread
from pilosa_tpu_torch.storage import Holder
from pilosa_tpu_torch.storage.residency import DEFAULT_BUDGET_BYTES
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
                 group_commit_max_ops: int = DEFAULT_GROUP_MAX_OPS):
        self.holder = Holder(data_dir, device=device,
                             budget_bytes=budget_bytes,
                             verify_on_load=verify_on_load,
                             durability_mode=durability_mode,
                             group_commit_max_ms=group_commit_max_ms,
                             group_commit_max_ops=group_commit_max_ops)
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
        self._http, _, self._thread = serve_in_thread(self.api, self.bind,
                                                      self._port)
        return self

    def close(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._thread.join(timeout=10)
            self._http = None
        self.holder.close()

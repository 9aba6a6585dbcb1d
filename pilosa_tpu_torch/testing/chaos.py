"""Chaos schedules for multi-process serving (the port's copy of
``MpServingChaos`` and ``run_mp_chaos`` from ``pilosa_tpu.testing.chaos``;
its cluster harness comes with the cluster planes).

A schedule runs a device owner with N ``SO_REUSEPORT`` workers under a
mixed load of Sets and Counts and SIGKILLs random workers mid-burst,
seeded (``random.Random(seed)``) so a failing run replays. It holds the
plane to zero lost acknowledged writes and an owner that never wedges.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.request

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

N_ROWS = 4
INDEX = "chaos"
FIELD = "f"


def _post(base: str, path: str, data: bytes,
          content_type: str = "application/json", timeout: float = 10.0):
    r = urllib.request.Request(f"{base}{path}", data=data, method="POST")
    r.add_header("Content-Type", content_type)
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


class MpServingChaos:
    """A kill-a-worker schedule for multi-process serving: one device
    owner and N ``SO_REUSEPORT`` workers under a mixed read and write
    load; the schedule SIGKILLs random workers mid-burst. Two oracles
    gate it:

    1. **Zero lost acked writes** — every Set() a client saw 200-acked
       through ANY worker is queryable afterwards (the WAL ACK barrier
       crossed the ring; a worker death must not un-happen it).
    2. **Owner never wedges** — after every kill the owner still
       answers a probe query within a bounded deadline (dead workers'
       in-flight ring slots were reclaimed, nothing blocks the drain
       loops) and the worker fleet respawns back to N.
    """

    PROBE_DEADLINE_S = 10.0
    RESPAWN_DEADLINE_S = 30.0

    def __init__(self, tmp_dir, n_workers: int = 2, seed: int = 0,
                 n_kills: int = 3, kill_gap_s: float = 0.8,
                 writer_threads: int = 3, reader_threads: int = 2,
                 device=None, log=lambda msg: None):
        self.tmp_dir = str(tmp_dir)
        self.n_workers = n_workers
        self.rng = random.Random(seed)
        self.n_kills = n_kills
        self.kill_gap_s = kill_gap_s
        self.writer_threads = writer_threads
        self.reader_threads = reader_threads
        self.device = device
        self.log = log
        self.server = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.acked: set[tuple[int, int]] = set()
        self.write_errors = 0
        self.events: list[str] = []
        self.wedges: list[str] = []

    def boot(self) -> "MpServingChaos":
        import socket as _socket

        from pilosa_tpu_torch.server import Server

        if not hasattr(_socket, "SO_REUSEPORT"):
            raise RuntimeError("SO_REUSEPORT unavailable")
        self.server = Server(self.tmp_dir, port=0, device=self.device,
                             serving_workers=self.n_workers,
                             use_mesh=False).open()
        if self.server._mpserve is None:
            raise RuntimeError("multi-process serving did not start")
        base = f"http://localhost:{self.server.port}"
        _post(base, f"/index/{INDEX}", b"{}")
        _post(base, f"/index/{INDEX}/field/{FIELD}", b"{}")
        return self

    def close(self) -> None:
        self._stop.set()
        if self.server is not None:
            self.server.close()

    # -------------------------------------------------------------- workload

    def _public(self) -> str:
        return f"http://localhost:{self.server.port}"

    def _owner(self) -> str:
        return f"http://127.0.0.1:{self.server._mpserve.owner_port}"

    def _writer(self, t: int) -> None:
        i = 0
        while not self._stop.is_set():
            shard = i % 2
            pos = t * 100_000 + (i // 2)
            col = shard * SHARD_WIDTH + pos
            row = 1 + (i % N_ROWS)
            i += 1
            try:
                out = _post(self._public(), f"/index/{INDEX}/query",
                            f"Set({col}, {FIELD}={row})".encode(),
                            content_type="text/plain", timeout=5.0)
            except Exception:  # noqa: BLE001 — a kill mid-request:
                self.write_errors += 1  # unacked, the ledger owes nothing
                continue
            if out.get("results") == [True]:
                with self._lock:
                    self.acked.add((row, col))
            time.sleep(0.005)

    def _reader(self) -> None:
        while not self._stop.is_set():
            try:
                _post(self._public(), f"/index/{INDEX}/query",
                      f"Count(Row({FIELD}=1))".encode(),
                      content_type="text/plain", timeout=5.0)
            except Exception:  # noqa: BLE001 — resets from dying
                pass           # workers are expected mid-kill
            time.sleep(0.01)

    # --------------------------------------------------------------- oracle

    def _probe_owner(self) -> bool:
        """Owner-never-wedges, half 1: a probe query through the
        owner's own listener answers within the deadline."""
        deadline = time.monotonic() + self.PROBE_DEADLINE_S
        while time.monotonic() < deadline:
            try:
                out = _post(self._owner(), f"/index/{INDEX}/query",
                            f"Count(Row({FIELD}=1))".encode(),
                            content_type="text/plain", timeout=5.0)
                if "results" in out:
                    return True
            except Exception:  # noqa: BLE001
                time.sleep(0.1)
        return False

    def _kill_one_worker(self) -> str:
        mp = self.server._mpserve
        pids = [w["pid"] for w in mp.workers_json()
                if w["alive"] and w["pid"]]
        if not pids:
            return "kill-skipped"
        pid = self.rng.choice(pids)
        try:
            os.kill(pid, 9)
        except ProcessLookupError:
            return "kill-raced"
        return f"kill-worker pid={pid}"

    def run_schedule(self) -> dict:
        mp = self.server._mpserve
        threads = [
            threading.Thread(target=self._writer, args=(t,), daemon=True)
            for t in range(self.writer_threads)
        ] + [
            threading.Thread(target=self._reader, daemon=True)
            for _ in range(self.reader_threads)
        ]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        time.sleep(self.kill_gap_s)  # let the burst establish
        for _ in range(self.n_kills):
            event = self._kill_one_worker()
            self.events.append(event)
            self.log(f"  event: {event}")
            if not self._probe_owner():
                self.wedges.append(f"owner probe timed out after {event}")
            if not mp.wait_workers(self.n_workers,
                                   timeout=self.RESPAWN_DEADLINE_S):
                self.wedges.append(f"fleet never respawned after {event}")
            time.sleep(self.kill_gap_s)
        self._stop.set()
        for t in threads:
            t.join(timeout=10)
        # final owner-never-wedges check, then the acked-write oracle
        # against the owner's authoritative listener
        if not self._probe_owner():
            self.wedges.append("owner probe timed out at finale")
        with self._lock:
            acked = set(self.acked)
        missing = set(acked)
        for _ in range(3):
            got: set[tuple[int, int]] = set()
            for row in range(1, N_ROWS + 1):
                try:
                    out = _post(self._owner(), f"/index/{INDEX}/query",
                                f"Row({FIELD}={row})".encode(),
                                content_type="text/plain", timeout=30.0)
                except Exception:  # noqa: BLE001
                    continue
                got.update((row, c) for c in
                           out.get("results", [{}])[0].get("columns", []))
            missing = acked - got
            if not missing:
                break
            time.sleep(0.2)
        m = mp.metrics()
        return {
            "events": list(self.events),
            "acked_writes": len(acked),
            "write_errors": self.write_errors,
            "lost_acked_writes": len(missing),
            "lost_sample": sorted(missing)[:5],
            "owner_wedges": list(self.wedges),
            "respawns": m["serving_worker_respawns_total"],
            "dropped_inflight": sum(w["droppedInflight"]
                                    for w in mp.workers_json()),
            "wall_s": round(time.monotonic() - t0, 2),
            "ok": not missing and not self.wedges,
        }


def run_mp_chaos(tmp_dir, n_schedules: int = 2, n_workers: int = 2,
                 seed: int = 0, n_kills: int = 3, device=None,
                 log=lambda msg: None) -> dict:
    """Run ``n_schedules`` independent kill-a-worker schedules (a fresh
    server each) and fold the two oracles."""
    records = []
    for i in range(n_schedules):
        schedule_seed = seed * 1000 + i
        log(f"mp chaos schedule {i + 1}/{n_schedules} "
            f"(seed {schedule_seed})")
        harness = MpServingChaos(
            f"{tmp_dir}/mpsched{i}", n_workers=n_workers,
            seed=schedule_seed, n_kills=n_kills, device=device, log=log,
        )
        try:
            harness.boot()
            record = harness.run_schedule()
        finally:
            harness.close()
        record["seed"] = schedule_seed
        records.append(record)
        log(f"  -> ok={record['ok']} acked={record['acked_writes']} "
            f"kills={len(record['events'])} wall={record['wall_s']}s")
    failed = [r for r in records if not r["ok"]]
    return {
        "schedules": n_schedules,
        "n_workers": n_workers,
        "kills_total": sum(len(r["events"]) for r in records),
        "acked_writes_total": sum(r["acked_writes"] for r in records),
        "lost_acked_writes": sum(r["lost_acked_writes"] for r in records),
        "owner_wedges": [w for r in records for w in r["owner_wedges"]],
        "respawns_total": sum(r["respawns"] for r in records),
        "dropped_inflight_total": sum(r["dropped_inflight"]
                                      for r in records),
        "failed_seeds": [r["seed"] for r in failed],
        "ok": not failed,
    }

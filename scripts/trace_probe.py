#!/usr/bin/env python3
"""Which ``torch.profiler`` sessions record the hand-written kernels, on
one NVIDIA GPU.

    python3 scripts/trace_probe.py ORDER [--sync] [--secs S] [--busy N]
        [--procs P] [--window W] [--late-load] [--server]

While a worker thread launches a kernel in a loop, runs one ``secs``
``torch.profiler`` session (CPU and CUDA activity, 0.3 s by default)
for each entry of ORDER, a comma-separated list of ``main`` (the
session on the main thread) and ``thread`` (on a fresh thread);
``preinit`` first runs one empty session on the main thread, then two
``thread`` sessions; ``mainN`` / ``threadN`` run N such sessions.

- the worker launches K1 (``tree_count``, through its ctypes binding
  on the current stream) and waits for it after each launch; ``--busy
  N`` launches N of them between waits, so up to N kernels are in
  flight when the session stops; the worker pauses 1 ms after each wait
  (about a thousand waits a second, a served load's rate).
- ``--sync`` calls ``torch.cuda.synchronize()`` inside the session,
  just before it stops, as ``utils/tracing.capture_device_trace`` does.
- ``--window W`` stops the load W seconds after the session is asked
  for, whether or not the session has started recording by then (as a
  fixed-length load around ``POST /debug/trace-device`` does); by
  default the load runs until the session has stopped.

Each session's line gives ``enter_s``, the seconds the profiler took to
start recording (its CUPTI set-up: long in a process's first session).

``--late-load`` compiles K1 first but loads its library (the first
launch) only after the ``preinit`` session. ``--server`` drives a port
``Server`` on the card instead (4 shards, 4 HTTP clients sending a Count
until each capture has answered) and asks ``POST
/debug/trace-device?secs=S`` once a session, printing its status and its
kernel events; with ``--late-load`` the kernel libraries load at the
first query, after the open's profiler session, as a server's do, and
without it every library is loaded before the server opens.

Prints, for each session, the kernel events of its Chrome trace and the
first kernel names, then one summary line. ``--procs P`` runs the same
arguments in P fresh processes, one after another, and sums their
summaries: the first session of a process is the case ``POST
/debug/trace-device`` meets once a server, for example:

    python3 scripts/trace_probe.py thread --procs 6
    python3 scripts/trace_probe.py thread --procs 6 --sync

A session that records no kernel event is what ``POST
/debug/trace-device`` refuses with a 500. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _sessions(order: str) -> list:
    out = []
    for part in order.split(","):
        m = re.fullmatch(r"(main|thread)(\d*)", part)
        if m is None:
            raise SystemExit(f"trace_probe: bad ORDER entry {part!r}")
        out += [m.group(1)] * int(m.group(2) or 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("order", nargs="?", default="thread")
    ap.add_argument("--sync", action="store_true")
    ap.add_argument("--secs", type=float, default=0.3)
    ap.add_argument("--busy", type=int, default=1)
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--window", type=float, default=0.0)
    ap.add_argument("--late-load", action="store_true")
    ap.add_argument("--server", action="store_true")
    args = ap.parse_args()
    if args.procs:
        return _fresh_processes(args)
    if args.server:
        return _server_sessions(args)
    import torch

    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from pilosa_tpu_torch import kernels
    from pilosa_tpu_torch.executor import expr

    dev = torch.device("cuda")
    prog = expr.compile_program(("count", ("and", ("leaf", 0), ("leaf", 1))))
    a, b = [torch.randint(-2**31, 2**31 - 1, (64 * 32768,),
                          dtype=torch.int32, device=dev) for _ in range(2)]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.late_load:
        kernels.build(["tree_count"])  # compiled, not loaded
    else:
        kernels.tree_count(prog, [[a, b]], [0], 32768)  # built and loaded
    torch.cuda.synchronize()

    def launch() -> None:
        kernels.tree_count(prog, [[a, b]], [0], 32768)

    def work(stop: threading.Event, until: float) -> None:
        while not stop.is_set() and time.perf_counter() < until:
            for _ in range(args.busy):
                launch()
            torch.cuda.synchronize()
            time.sleep(0.001)

    def session(where: str):
        stop = threading.Event()
        asked = time.perf_counter()
        until = asked + args.window if args.window > 0 else float("inf")
        worker = threading.Thread(target=work, args=(stop, until))
        worker.start()
        box: list = []

        def run() -> None:
            t0 = time.perf_counter()
            with profile(activities=activities) as prof:
                box.append(time.perf_counter() - t0)
                time.sleep(args.secs)
                if args.sync:
                    torch.cuda.synchronize()
            path = Path(tempfile.mkdtemp()) / "trace.json"
            prof.export_chrome_trace(str(path))
            box.append(path)

        try:
            if where == "main":
                run()
            else:
                t = threading.Thread(target=run)
                t.start()
                t.join()
        finally:
            stop.set()
            worker.join()
        events = json.loads(box[1].read_text())["traceEvents"]
        names = sorted({e["name"][:48] for e in events
                        if e.get("cat") == "kernel"})
        return (sum(e.get("cat") == "kernel" for e in events), names[:2],
                round(box[0], 3))

    if args.order == "preinit":
        with profile(activities=activities):
            pass
        sessions = ["thread", "thread"]
    else:
        sessions = _sessions(args.order)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    empty = 0
    for i, where in enumerate(sessions):
        n, names, enter_s = session(where)
        empty += n == 0
        print(json.dumps({"order": args.order, "session": i, "where": where,
                          "sync": args.sync, "busy": args.busy,
                          "window": args.window, "enter_s": enter_s, "kernel_events": n,
                          "kernels": names}), flush=True)
    print(json.dumps({"summary": True, "order": args.order,
                      "sync": args.sync, "busy": args.busy,
                      "window": args.window, "sessions": len(sessions),
                      "empty": empty}),
          flush=True)
    return 0


def _server_sessions(args) -> int:
    """``--server``: the captures of ``POST /debug/trace-device`` on a port
    server under an HTTP load, one line each."""
    import http.client
    import shutil

    import numpy as np
    import torch

    from pilosa_tpu_torch import kernels
    from pilosa_tpu_torch.server import Server
    from pilosa_tpu_torch.storage import Holder, load_from_dense

    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 2
    tmp = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(150)
    w = 32768
    h = Holder(str(tmp / "d"), device="cpu").open()
    load_from_dense(h, {
        "f": {r: rng.integers(0, 1 << 32, 4 * w, dtype=np.uint32)
              for r in (1, 2, 3)},
        "g": {7: rng.integers(0, 1 << 32, 4 * w, dtype=np.uint32)}},
        index="i")
    h.close()
    if not args.late_load:
        for name in kernels.SOURCES:
            kernels._lib(name)
    server = Server(str(tmp / "d"), port=0, device="cuda").open()

    def post(path: str, body: bytes = b""):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        try:
            conn.request("POST", path, body=body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    empty = 0
    sessions = _sessions(args.order)
    try:
        for i in range(len(sessions)):
            stop = threading.Event()

            def load() -> None:
                while not stop.is_set():
                    post("/index/i/query",
                         b"Count(Intersect(Row(f=1), Row(g=7)))")

            clients = [threading.Thread(target=load) for _ in range(4)]
            for t in clients:
                t.start()
            time.sleep(0.2)
            t0 = time.perf_counter()
            status, body = post(f"/debug/trace-device?secs={args.secs}")
            took = time.perf_counter() - t0
            stop.set()
            for t in clients:
                t.join(60)
            n = 0
            if status == 200:
                log_dir = Path(json.loads(body)["logDir"])
                for f in log_dir.glob("*.json"):
                    n += sum(e.get("cat") == "kernel" for e in json.loads(
                        f.read_text())["traceEvents"])
                    f.unlink()
            empty += n == 0
            print(json.dumps({"order": args.order, "session": i,
                              "server": True, "late_load": args.late_load,
                              "status": status, "seconds": round(took, 3),
                              "kernel_events": n}), flush=True)
    finally:
        server.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"summary": True, "order": args.order, "server": True,
                      "late_load": args.late_load,
                      "sessions": len(sessions), "empty": empty}),
          flush=True)
    return 0


def _fresh_processes(args) -> int:
    """Run this probe's arguments in ``args.procs`` processes of their own
    and print the sum of their summary lines."""
    argv = [sys.executable, __file__, args.order, "--secs", str(args.secs),
            "--busy", str(args.busy), "--window", str(args.window)]
    for flag in ("sync", "late_load", "server"):
        if getattr(args, flag):
            argv.append("--" + flag.replace("_", "-"))
    sessions = empty = first_empty = 0
    for _ in range(args.procs):
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        lines = [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{")]
        first_empty += lines[0]["kernel_events"] == 0
        sessions += lines[-1]["sessions"]
        empty += lines[-1]["empty"]
        print(json.dumps(lines[0]), flush=True)
    print(json.dumps({"summary": True, "order": args.order,
                      "procs": args.procs, "sync": args.sync,
                      "busy": args.busy,
                      "window": args.window,
                      "sessions": sessions, "empty": empty,
                      "first_sessions_empty": first_empty}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Which ``torch.profiler`` sessions record the hand-written kernels, on
one NVIDIA GPU.

    python3 scripts/trace_probe.py ORDER

While a worker thread launches K1 (``tree_count``) in a loop, runs one
0.3 s ``torch.profiler`` session (CPU and CUDA activity) for each entry
of ORDER, a comma-separated list of ``main`` (the session on the main
thread) and ``thread`` (on a fresh thread); ``preinit`` first runs one
empty session on the main thread, then two ``thread`` sessions. Prints,
for each session, the kernel events of its Chrome trace and the first
kernel names. Run each ORDER in a process of its own, for example:

    for m in thread,thread main,thread preinit; do
        python3 scripts/trace_probe.py $m; done

A session that records no kernel event is what ``POST
/debug/trace-device`` refuses with a 500 (``utils/tracing.py``). Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
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

    def work(stop: threading.Event) -> None:
        while not stop.is_set():
            kernels.tree_count(prog, [[a, b]], [0], 32768)
            torch.cuda.synchronize()

    def session(where: str):
        stop = threading.Event()
        worker = threading.Thread(target=work, args=(stop,))
        worker.start()
        box: list = []

        def run() -> None:
            with profile(activities=activities) as prof:
                time.sleep(0.3)
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
        events = json.loads(box[0].read_text())["traceEvents"]
        names = sorted({e["name"][:48] for e in events
                        if e.get("cat") == "kernel"})
        return sum(e.get("cat") == "kernel" for e in events), names[:2]

    order = sys.argv[1] if len(sys.argv) > 1 else "thread"
    if order == "preinit":
        with profile(activities=activities):
            pass
        sessions = ["thread", "thread"]
    else:
        sessions = order.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    for where in sessions:
        n, names = session(where)
        print(json.dumps({"order": order, "session": where,
                          "kernel_events": n, "kernels": names}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

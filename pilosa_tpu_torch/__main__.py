"""Command line: ``python -m pilosa_tpu_torch server -d DIR --port P``.

Runs on the GPU (``--device cuda``, the default) unless ``--device cpu``
is given; asking for cuda on a machine without one exits with an error.
``--durability-mode`` (group, per-op or flush-only), ``--group-commit-max-ms``
and ``--group-commit-max-ops`` are the reference's durability knobs;
``--residency-host-tier-bytes``, ``--residency-promote-interval``,
``--residency-promote-heat`` and ``--residency-demote-heat`` its residency
tiering knobs (an interval of 0, the default, runs no tierer).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def cmd_server(args) -> int:
    from pilosa_tpu_torch.server import Server

    server = Server(args.data_dir, bind=args.bind, port=args.port,
                    device=args.device,
                    budget_bytes=args.residency_budget_bytes,
                    durability_mode=args.durability_mode,
                    group_commit_max_ms=args.group_commit_max_ms,
                    group_commit_max_ops=args.group_commit_max_ops,
                    residency_host_tier_bytes=args.residency_host_tier_bytes,
                    residency_promote_interval=args.residency_promote_interval,
                    residency_promote_heat=args.residency_promote_heat,
                    residency_demote_heat=args.residency_demote_heat).open()
    print(f"pilosa_tpu_torch serving {args.data_dir} on "
          f"http://{args.bind}:{server.port} ({server.holder.device})",
          flush=True)
    try:
        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        stop.wait()
    finally:
        server.close()
    return 0


def main(argv=None) -> int:
    from pilosa_tpu_torch.storage.residency import (
        DEFAULT_BUDGET_BYTES,
        DEFAULT_HOST_BUDGET_BYTES,
    )
    from pilosa_tpu_torch.storage.tiering import (
        DEFAULT_DEMOTE_HEAT,
        DEFAULT_PROMOTE_HEAT,
    )
    from pilosa_tpu_torch.storage.wal import (
        DEFAULT_GROUP_MAX_MS,
        DEFAULT_GROUP_MAX_OPS,
        DURABILITY_MODES,
        MODE_GROUP,
    )

    parser = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("server", help="run a server node")
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("-b", "--bind", default="localhost")
    p.add_argument("--port", type=int, default=10101)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--residency-budget-bytes", type=int,
                   default=DEFAULT_BUDGET_BYTES,
                   help="device bytes for resident leaves")
    p.add_argument("--durability-mode", choices=DURABILITY_MODES,
                   default=MODE_GROUP,
                   help="what an HTTP 200 on a write means: group (one "
                   "fsync a commit group), per-op (one fsync a record) or "
                   "flush-only (no fsync)")
    p.add_argument("--group-commit-max-ms", type=float,
                   default=DEFAULT_GROUP_MAX_MS,
                   help="longest a record waits for its group's fsync")
    p.add_argument("--group-commit-max-ops", type=int,
                   default=DEFAULT_GROUP_MAX_OPS,
                   help="most op records fsynced in one group")
    p.add_argument("--residency-host-tier-bytes", type=int,
                   default=DEFAULT_HOST_BUDGET_BYTES,
                   help="host RAM for the residency cache's host tier")
    p.add_argument("--residency-promote-interval", type=float, default=0.0,
                   help="seconds between heat-driven tiering passes (0: "
                   "no tiering)")
    p.add_argument("--residency-promote-heat", type=float,
                   default=DEFAULT_PROMOTE_HEAT,
                   help="heat at which a host-tier leaf is promoted")
    p.add_argument("--residency-demote-heat", type=float,
                   default=DEFAULT_DEMOTE_HEAT,
                   help="heat below which a device leaf moves to host")
    p.set_defaults(fn=cmd_server)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

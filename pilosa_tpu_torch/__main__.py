"""Command line: ``python -m pilosa_tpu_torch server -d DIR --port P``
and ``python -m pilosa_tpu_torch check -d DIR | --host URL``.

``server`` runs on the GPU (``--device cuda``, the default) unless
``--device cpu`` is given; asking for cuda on a machine without one exits
with an error. ``--durability-mode`` (group, per-op or flush-only),
``--group-commit-max-ms`` and ``--group-commit-max-ops`` are the
reference's durability knobs; ``--residency-host-tier-bytes``,
``--residency-promote-interval``, ``--residency-promote-heat`` and
``--residency-demote-heat`` its residency tiering knobs (an interval of
0, the default, runs no tierer); ``--scrub-interval`` and
``--scrub-max-bytes-per-sec`` its integrity scrubber's (0: no scrubber).
``-c FILE`` reads any of them from a TOML file under the reference's
config names (``scrub-interval = "90s"``); a flag given overrides it.

``check`` is the reference's integrity check, with its output and exit
codes: ``-d`` verifies every fragment file of a stopped node's data dir
against its ``.checksums`` and replays its op log, printing ``ok:`` lines
to stdout and ``CORRUPT:`` and ``QUARANTINED:`` lines to stderr (exit 1
on any); ``--host`` runs one scrub pass on a live node (``POST
/internal/scrub``) and prints its record (exit 1 if a fragment stayed
unrepaired). Neither touches a device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor


def cmd_server(args) -> int:
    from pilosa_tpu_torch.server import Server

    server = Server(args.data_dir, bind=args.bind, port=args.port,
                    device=args.device,
                    verify_on_load=args.verify_on_load,
                    budget_bytes=args.residency_budget_bytes,
                    durability_mode=args.durability_mode,
                    group_commit_max_ms=args.group_commit_max_ms,
                    group_commit_max_ops=args.group_commit_max_ops,
                    residency_host_tier_bytes=args.residency_host_tier_bytes,
                    residency_promote_interval=args.residency_promote_interval,
                    residency_promote_heat=args.residency_promote_heat,
                    residency_demote_heat=args.residency_demote_heat,
                    scrub_interval=args.scrub_interval,
                    scrub_max_bytes_per_sec=args.scrub_max_bytes_per_sec
                    ).open()
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


def cmd_check(args) -> int:
    """The integrity check: an offline scrub of a data dir (``-d``), or
    one live scrub pass on a running node (``--host``)."""
    if args.host:
        url = f"{args.host.rstrip('/')}/internal/scrub"
        try:
            req = urllib.request.Request(url, data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=3600) as resp:
                out = json.loads(resp.read() or b"{}")
        except Exception as e:  # noqa: BLE001 — any failure is reported
            print(f"error: live scrub via {url} failed: {e}",
                  file=sys.stderr)
            return 1
        print(f"live scrub: scanned={out.get('scanned', 0)} "
              f"bytes={out.get('bytes', 0)} corrupt={out.get('corrupt', 0)} "
              f"repaired={out.get('repaired', 0)} "
              f"self_healed={out.get('self_healed', 0)} "
              f"unrepaired={out.get('unrepaired', 0)}")
        return 1 if out.get("unrepaired", 0) else 0
    if not args.data_dir:
        print("error: check needs -d/--data-dir or --host", file=sys.stderr)
        return 1
    from pilosa_tpu_torch.roaring.format import replay_ops
    from pilosa_tpu_torch.storage import integrity

    def check(path: str) -> tuple[bool, str]:
        try:
            bitmap, data, ops_at = integrity.verify_fragment_file(path)
            n_ops, _ = replay_ops(bitmap, data, ops_at)
            return True, f"ok: {path} bits={bitmap.count()} ops={n_ops}"
        except Exception as e:  # noqa: BLE001 — every failure is a verdict
            return False, f"CORRUPT: {path}: {e}"

    data_dir = os.path.expanduser(args.data_dir)
    pattern = os.path.join(data_dir, "**", "fragments", "*")
    paths = [p for p in sorted(glob.glob(pattern, recursive=True))
             if os.path.isfile(p)
             and not p.endswith((".cache", integrity.CHECKSUM_SUFFIX))
             and not integrity.is_quarantined(os.path.basename(p))]
    bad = 0
    # decoding and digesting release the GIL: several files at once, the
    # verdicts printed in path order
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for ok, line in pool.map(check, paths):
            bad += not ok
            print(line, file=sys.stdout if ok else sys.stderr)
    quarantined = integrity.list_quarantined(data_dir)
    for q in quarantined:
        print(f"QUARANTINED: {q}", file=sys.stderr)
    return 1 if bad or quarantined else 0


def main(argv=None) -> int:
    from pilosa_tpu_torch.server.server import config_from_toml
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
    p.add_argument("--scrub-interval", type=float, default=0.0,
                   help="seconds between integrity scrub passes (0: no "
                   "scrubber)")
    p.add_argument("--scrub-max-bytes-per-sec", type=int, default=0,
                   help="read budget of the scrubber (0: unpaced)")
    p.add_argument("-c", "--config",
                   help="TOML file of knobs under the reference's names; "
                   "flags override it")
    # verify-on-load has no flag, only the config file's key
    p.set_defaults(fn=cmd_server, verify_on_load=True)
    p = sub.add_parser(
        "check", help="verify fragment files against their checksum "
        "sidecars (offline -d scrub, or --host live scrub trigger)")
    p.add_argument("-d", "--data-dir",
                   help="offline scrub of a data dir (node stopped)")
    p.add_argument("--host", help="trigger a live scrub pass on a running "
                   "node")
    p.set_defaults(fn=cmd_check)
    args = parser.parse_args(argv)
    if getattr(args, "config", None):
        # the file's knobs become the defaults, so a flag given wins
        sub.choices["server"].set_defaults(**config_from_toml(args.config))
        args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

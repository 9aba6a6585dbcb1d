#!/usr/bin/env python3
"""Chip smoke test of pilosa_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the three CUDA kernels from ``pilosa_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card,
   bit-exact, at the main path's shapes (int32[1024, 32768] leaves, a
   4-query micro-batch, a patch whose masks have bit 31 set), and time
   both with CUDA events beside the kernel's memory bound;
4. drive the main path: a 1B-column (1024-shard) Star-Trace-like data
   directory written through the port's Holder, the port's HTTP server
   on 127.0.0.1, Count and row algebra queries (16 concurrent Count
   clients among them), writes through /import and Set/Clear, every
   answer checked against a numpy oracle over the same host words, with
   the kernels' launch counters zeroed just before and read just after.

The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. No JAX, nothing of pilosa_tpu.
"""

from __future__ import annotations

import argparse
import http.client
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 rate
INT_OPS_PER_S = 67e12      # H100 SXM non-tensor-core peak
N_SHARDS = 1024            # 2^30 columns: BASELINE config 1
WORDS = 32768
SPARSE_ROW = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, launches: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of (event time of ``launches`` back-to-back
    calls) / launches, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / launches)
    return statistics.median(per)


def max_abs_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def check_kernels(torch, kernels, batch, leaves, rng) -> list:
    """Phase 3: every kernel against its plain version, bit-exact."""
    from pilosa_tpu_torch.executor import expr

    out = []
    leaf_bytes = leaves[0].numel() * 4

    # K1: a 4-query micro-batch of Count(Intersect(Row, Row)) at 1B columns
    prog = expr.compile_program(("count", ("and", ("leaf", 0), ("leaf", 1))))
    mb = [[leaves[i], leaves[4 + i]] for i in range(4)]
    row_words = batch.COUNT_CHUNK_WORDS
    got = kernels.tree_count(prog, mb, [0] * 4, row_words)
    want = kernels.tree_count_plain(prog, mb, [0] * 4, row_words)
    err = max_abs_err(torch, got, want)
    # the other ops, const0 and the salt, on one query
    wide = expr.compile_program(
        ("count", ("diff", ("or", ("leaf", 0), ("xor", ("leaf", 1),
                                                 ("const0",))),
                   ("and", ("leaf", 2), ("leaf", 0)))))
    trio = [[leaves[0], leaves[5], leaves[6]]]
    err = max(err, max_abs_err(
        torch, kernels.tree_count(wide, trio, [0], row_words),
        kernels.tree_count_plain(wide, trio, [0], row_words)))
    # the Pallas kernel's own contract at its bench shape: R=8, W=2^25
    a = torch.stack(leaves[:8]).reshape(8, -1)
    b = torch.stack(leaves[8:16]).reshape(8, -1)
    for salt in (0, 7, 0x80000001):
        got_p = kernels.intersect_count(a, b, salt)
        want_p = kernels.tree_count_plain(
            (kernels.OP_LEAF, kernels.OP_LEAF | 256, kernels.OP_SALT,
             kernels.OP_AND), [[a, b]], [salt], a.shape[1])[0]
        err = max(err, max_abs_err(torch, got_p, want_p))
    del a, b
    if err != 0:
        fail(f"tree_count disagrees with its plain version by {err}")
    n_bytes = 4 * 2 * leaf_bytes
    out.append({
        "name": "tree_count", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/tree_count.cu",
        "replaces": "bench_pallas.py:63",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.tree_count(prog, mb, [0] * 4,
                                                        row_words)),
        "plain_ms": cuda_ms(torch, lambda: kernels.tree_count_plain(
            prog, mb, [0] * 4, row_words), launches=2, reps=3),
        "bound_ms": 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                              4 * 3 * leaves[0].numel() / INT_OPS_PER_S),
        "bound_by": "bytes", "library_ms": None,
        "shape": "4 queries x 2 leaves x int32[1024, 32768]",
    })

    # K2: Intersect(Row, Row) words at 1B columns
    prog2 = expr.compile_program(("and", ("leaf", 0), ("leaf", 1)))
    pair = [leaves[0], leaves[4]]
    got = kernels.tree_rows(prog2, pair)
    want = kernels.tree_rows_plain(prog2, pair)
    err = max_abs_err(torch, got, want)
    wide_rows = expr.compile_program(
        ("xor", ("diff", ("leaf", 0), ("leaf", 1)), ("or", ("leaf", 2),
                                                     ("const0",))))
    err = max(err, max_abs_err(
        torch, kernels.tree_rows(wide_rows, trio[0]),
        kernels.tree_rows_plain(wide_rows, trio[0])))
    if err != 0:
        fail(f"tree_rows disagrees with its plain version by {err}")
    del got, want
    out.append({
        "name": "tree_rows", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/tree_rows.cu",
        "replaces": "pilosa_tpu/executor/expr.py:62",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.tree_rows(prog2, pair)),
        "plain_ms": cuda_ms(torch, lambda: kernels.tree_rows_plain(prog2,
                                                                   pair)),
        "bound_ms": 1e3 * 3 * leaf_bytes / HBM_BYTES_PER_S,
        "bound_by": "bytes",
        "library_ms": cuda_ms(torch, lambda: torch.bitwise_and(*pair)),
        "shape": "2 leaves x int32[1024, 32768] -> int32[1024, 32768]",
    })

    # K3: a 1024-word patch with bit 31 set in every mask, OR then AND-NOT
    positions = rng.choice(WORDS * 32, 1024, replace=False).astype(np.uint32)
    positions = np.union1d(positions, (positions & ~np.uint32(31)) | 31)
    word_idx, masks = batch._word_masks(positions)
    if not (masks & np.uint32(1 << 31)).all():
        fail("patch masks lack bit 31")
    n = int(word_idx.size)
    slot = leaves[1].shape[0] // 2 + 1
    err = 0
    for clear in (False, True):
        k_leaf = leaves[1].clone()
        p_leaf = leaves[1].clone()
        kernels.word_patch(k_leaf, slot, word_idx, masks, n, clear)
        pairs = np.stack([word_idx, masks.view(np.int32)])
        kernels.word_patch_plain(p_leaf, slot, pairs, clear)
        err = max(err, max_abs_err(torch, k_leaf, p_leaf))
        if not torch.equal(k_leaf[:slot], leaves[1][:slot]):
            fail("word_patch touched another slot")
    if err != 0:
        fail(f"word_patch disagrees with its plain version by {err}")
    out.append({
        "name": "word_patch", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/word_patch.cu",
        "replaces": "pilosa_tpu/executor/batch.py:196",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.word_patch(
            k_leaf, slot, word_idx, masks, n, False)),
        "plain_ms": cuda_ms(torch, lambda: kernels.word_patch_plain(
            p_leaf, slot, pairs, False)),
        "bound_ms": 1e3 * 16 * n / HBM_BYTES_PER_S,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"{n} (word, mask) pairs into one slot of int32[1024, 32768]",
    })
    del k_leaf, p_leaf
    return out


class Client:
    """One keep-alive HTTP connection to the server."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def post(self, path: str, body: bytes) -> tuple[int, bytes]:
        self.conn.request("POST", path, body=body)
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def query(self, pql: str) -> list:
        status, body = self.post("/index/repository/query", pql.encode())
        if status != 200:
            fail(f"{pql} answered {status}: {body[:300]!r}")
        return json.loads(body)["results"]

    def close(self) -> None:
        self.conn.close()


def run_main_path(data_dir: str, words: dict, rng) -> dict:
    """Phase 4 through the server; returns the run's numbers."""
    from pilosa_tpu_torch.server import Server

    server = Server(data_dir, bind="127.0.0.1", port=0).open()
    try:
        return _serve_and_check(server, words, rng)
    finally:
        server.close()


def _count_oracle(words, op, leaves) -> int:
    acc = words[leaves[0]]
    for leaf in leaves[1:]:
        w = words[leaf]
        acc = {"and": acc & w, "or": acc | w, "xor": acc ^ w,
               "diff": acc & ~w}[op]
    return int(np.bitwise_count(acc).sum(dtype=np.int64))


def _serve_and_check(server, words: dict, rng) -> dict:
    c = Client(server.port)
    stats = {}
    # sparse rows: one per field through /import, plus Set writes
    n_cols = N_SHARDS * WORDS * 32
    shared = rng.choice(n_cols, 300, replace=False)
    sg = np.union1d(shared, rng.choice(n_cols, 1700, replace=False))
    lang = np.union1d(shared, rng.choice(n_cols, 1200, replace=False))
    for field, cols in (("stargazer", sg[:-3]), ("language", lang)):
        body = json.dumps({"rows": [SPARSE_ROW] * len(cols),
                           "columns": cols.tolist()}).encode()
        status, resp = c.post(f"/index/repository/field/{field}/import", body)
        if status != 200 or json.loads(resp)["changed"] != len(cols):
            fail(f"import into {field} answered {status} {resp!r}")
    sets = " ".join(f"Set({int(col)}, stargazer={SPARSE_ROW})"
                    for col in sg[-3:])
    if c.query(sets) != [True, True, True]:
        fail("Set of the sparse row did not change bits")

    shapes = [
        ("Count(Intersect(Row(stargazer=0), Row(language=1)))", "and",
         [("stargazer", 0), ("language", 1)]),
        ("Count(Union(Row(stargazer=1), Row(language=2)))", "or",
         [("stargazer", 1), ("language", 2)]),
        ("Count(Xor(Row(stargazer=2), Row(language=3)))", "xor",
         [("stargazer", 2), ("language", 3)]),
        ("Count(Difference(Row(stargazer=3), Row(language=0)))", "diff",
         [("stargazer", 3), ("language", 0)]),
        ("Count(Intersect(Row(stargazer=0), Row(stargazer=1), "
         "Row(language=2)))", "and",
         [("stargazer", 0), ("stargazer", 1), ("language", 2)]),
    ]
    truth = {pql: _count_oracle(words, op, leaves)
             for pql, op, leaves in shapes}
    t0 = time.perf_counter()
    for pql, _, _ in shapes:  # first touch: leaves decoded and uploaded
        got = c.query(pql)[0]
        if got != truth[pql]:
            fail(f"{pql} = {got}, oracle {truth[pql]}")
    stats["first_touch_s"] = time.perf_counter() - t0

    row = c.query(f"Row(stargazer={SPARSE_ROW})")[0]["columns"]
    if row != sg.tolist():
        fail("Row(stargazer=10) differs from the oracle")
    inter = c.query(f"Intersect(Row(stargazer={SPARSE_ROW}), "
                    f"Row(language={SPARSE_ROW}))")[0]["columns"]
    if inter != np.intersect1d(sg, lang).tolist():
        fail("Intersect of the sparse rows differs from the oracle")
    got = c.query(f"Count(Row(stargazer={SPARSE_ROW}))")[0]
    if got != sg.size:
        fail(f"Count(Row(stargazer=10)) = {got}, oracle {sg.size}")

    # 16 concurrent Count clients, closed loop
    n_clients, per_client = 16, 40
    errors: list = []
    latencies: list = []
    lock = threading.Lock()

    def client(k: int) -> None:
        cl = Client(server.port)
        try:
            for j in range(per_client):
                pql = shapes[(k + j) % len(shapes)][0]
                t = time.perf_counter()
                got = cl.query(pql)[0]
                dt = time.perf_counter() - t
                with lock:
                    latencies.append(dt)
                    if got != truth[pql]:
                        errors.append((pql, got))
        finally:
            cl.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail("a Count client hung")
    wall = time.perf_counter() - t0
    if errors or len(latencies) != n_clients * per_client:
        fail(f"concurrent Counts wrong or missing: {errors[:3]}")
    lat = sorted(latencies)
    stats.update(qps=len(lat) / wall, clients=n_clients, queries=len(lat),
                 p50_ms=1e3 * lat[len(lat) // 2],
                 p99_ms=1e3 * lat[int(0.99 * (len(lat) - 1))],
                 largest_batch=server.executor.largest_batch)

    # a write a resident leaf must show (K3 OR), then its undo (K3 AND-NOT)
    sg0, lang1 = words[("stargazer", 0)], words[("language", 1)]
    cand = np.flatnonzero(~sg0 & lang1)[0]
    bit = int(np.flatnonzero(np.unpackbits(
        np.array([~sg0[cand] & lang1[cand]], np.uint32).view(np.uint8),
        bitorder="little"))[0])
    col = int(cand) * 32 + bit
    pql = shapes[0][0]
    if c.query(f"Set({col}, stargazer=0)") != [True]:
        fail("Set on a dense row changed nothing")
    if c.query(pql)[0] != truth[pql] + 1:
        fail("Count after Set does not show the write")
    if c.query("Count(Row(stargazer=0))")[0] != \
            int(np.bitwise_count(sg0).sum(dtype=np.int64)) + 1:
        fail("Count(Row(stargazer=0)) after Set is wrong")
    if c.query(f"Clear({col}, stargazer=0)") != [True]:
        fail("Clear changed nothing")
    if c.query(pql)[0] != truth[pql]:
        fail("Count after Clear does not show the write")
    stats["resident_bytes"] = server.holder.cache.bytes_used
    c.close()
    return stats


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    if not (Path(__file__).resolve().parent / "pilosa_tpu_torch").is_dir():
        print("chip_smoke: pilosa_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch import kernels
    from pilosa_tpu_torch.executor import batch
    from pilosa_tpu_torch.storage import Holder, load_from_dense

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          + json.dumps({k: round(v, 1) for k, v in built.items()}), flush=True)
    for log in sorted(kernels.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.name.split('-')[0]}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    words = {(f, r): rng.integers(0, 1 << 32, N_SHARDS * WORDS,
                                  dtype=np.uint32)
             for f in ("stargazer", "language") for r in range(4)}
    print(f"data: 8 rows x {N_SHARDS} shards in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # phase 3: kernels against their plain versions on the card
    leaves = [torch.from_numpy(w.view(np.int32)).to(dev).reshape(N_SHARDS,
                                                                WORDS)
              for w in words.values()]
    leaves += [torch.roll(leaf, 1, 0) for leaf in leaves]  # 16 for R=8 x 2
    report = check_kernels(torch, kernels, batch, leaves, rng)
    del leaves
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for k in report:
        print(f"kernel {k['name']}: bit-exact, {k['ms']:.4f} ms "
              f"(plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms"
              f" by {k['bound_by']}) at {k['shape']}", flush=True)

    # phase 4: the main path
    scratch = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        holder = Holder(str(scratch / "data")).open()
        fields = {}
        for (f, r), w in words.items():
            fields.setdefault(f, {})[r] = w
        load_from_dense(holder, fields, index="repository")
        holder.close()
        print(f"data dir: {time.perf_counter() - t0:.1f}s", flush=True)
        kernels.reset_launches()
        stats = run_main_path(str(scratch / "data"), words, rng)
        launched = kernels.launches()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name, n in launched.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for k in report:
        k["launches"] = launched[k["name"]]
    print("main path: " + json.dumps(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in stats.items()}), flush=True)
    print(f"launches: {json.dumps(launched)}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in report]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

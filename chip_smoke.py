#!/usr/bin/env python3
"""Chip smoke test of pilosa_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the seven CUDA kernels from ``pilosa_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card,
   bit-exact, at the main paths' shapes (int32[1024, 32768] leaves, a
   4-query micro-batch, a patch whose masks have bit 31 set, the
   int32[1024, 22, 32768] planes of a depth-20 int field), and time both
   with CUDA events beside the kernel's memory bound;
4. drive two main paths through the port's HTTP server on 127.0.0.1 over
   one 1B-column (1024-shard) data directory written through the port's
   Holder, every answer checked against a numpy oracle over the same
   host words, the kernels' launch counters zeroed just before each path
   and read just after it:
   a. Star-Trace (index ``repository``): Count and row algebra (16
      concurrent Count clients), Shift and Not, writes through /import
      and Set/Clear;
   b. NYC-taxi rides (index ``rides``, BASELINE config 3): a set field
      ``cab_type``, an int field ``fare`` (cents, 0..1048575, depth 20)
      and an int field ``tip`` filled through /import-value; Range,
      between, Sum, Min and Max, a Set on ``tip`` that the next
      aggregates must show, then 16 concurrent clients over five BSI
      shapes.

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
N_SHARDS = 1024            # 2^30 columns: BASELINE configs 1-3
WORDS = 32768
SPARSE_ROW = 10
FARE_MAX = (1 << 20) - 1   # cents; bit depth 20
FARE_DEPTH = 20           # even: the oracle reads the planes in pairs
TIP_MAX = 100_000
N_TIPS = 100_000
IMPORT_BATCH = 5000        # the server's max-writes-per-request
FARE_THRESHOLDS = (100_000, 524_287, 1_000_000)
FARE_BETWEEN = (250_000, 750_000)
SHIFTS = (0, 1, -1, 31, -31, 32, -32, 33, -33, WORDS * 32 - 1,
          -(WORDS * 32 - 1), 1 << 20, -(1 << 20), (1 << 20) + 5,
          -(1 << 20) + 5)
NO_LIBRARY = None  # no PyTorch call computes a popcount or a bit shift


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


def _bytes_ms(n_bytes: float) -> float:
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def check_port_kernels(torch, kernels, batch, leaves, planes) -> list:
    """Phase 3, slice 2: OP_NOT, K3's row form and K4-K7 against their
    plain versions, bit-exact, at the 1B-column shapes: int32[1024, 32768]
    rows and the int32[1024, 22, 32768] planes of a depth-20 field."""
    from pilosa_tpu_torch.executor import expr

    out = []
    row_bytes = leaves[0].numel() * 4
    depth = planes.shape[1] - 2

    # OP_NOT in K2 (the grammar's flipall)
    prog = expr.compile_program(("diff", ("flipall", ("leaf", 0)),
                                 ("flipall", ("leaf", 1))))
    pair = [leaves[0], leaves[4]]
    if max_abs_err(torch, kernels.tree_rows(prog, pair),
                   kernels.tree_rows_plain(prog, pair)) != 0:
        fail("tree_rows with OP_NOT disagrees with its plain version")

    # K3's row form on the planes leaf: bit 31 set in every mask
    rng = np.random.default_rng(5)
    positions = rng.choice(WORDS * 32, 1024, replace=False).astype(np.uint32)
    positions = np.union1d(positions, (positions & ~np.uint32(31)) | 31)
    word_idx, masks = batch._word_masks(positions)
    pairs = np.stack([word_idx, masks.view(np.int32)])
    slot, row = N_SHARDS // 2 + 1, 7
    for clear in (False, True):
        k_planes = planes.clone()
        kernels.word_patch(k_planes, slot, word_idx, masks, word_idx.size,
                           clear, row=row)
        want = planes[slot, row].clone()
        plain = planes[slot].clone()
        kernels.word_patch_plain(plain[None], 0, pairs, clear, row=row)
        if not torch.equal(k_planes[slot], plain):
            fail("word_patch's row form disagrees with its plain version")
        k_planes[slot, row] = want
        if not torch.equal(k_planes, planes):
            fail("word_patch's row form touched another row")
        del k_planes

    # K4 at every shift the tests hold, including the extremes
    words = leaves[0]
    err = 0
    for n in SHIFTS:
        err = max(err, max_abs_err(torch, kernels.row_shift(words, n),
                                   kernels.row_shift_plain(words, n)))
    if err != 0:
        fail(f"row_shift disagrees with its plain version by {err}")
    out.append({
        "name": "row_shift", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/row_shift.cu",
        "replaces": "pilosa_tpu/ops/bitops.py:27",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.row_shift(words, 1)),
        "plain_ms": cuda_ms(torch, lambda: kernels.row_shift_plain(words, 1),
                            launches=2, reps=3),
        "bound_ms": _bytes_ms(2 * row_bytes), "bound_by": "bytes",
        "library_ms": NO_LIBRARY,
        "shape": f"int32[{N_SHARDS}, {WORDS}], n in {len(SHIFTS)} shifts",
    })

    # K5: all six operators, at the clamped ends of the predicate too
    exists = planes[:, 0].contiguous()
    err = 0
    for op in kernels.BSI_OPS:
        for pred in (0, FARE_THRESHOLDS[1], (1 << depth) - 1):
            err = max(err, max_abs_err(
                torch, kernels.bsi_compare(planes, exists, op, pred),
                kernels.bsi_compare_plain(planes, exists, op, pred)))
    if err != 0:
        fail(f"bsi_compare disagrees with its plain version by {err}")
    pred = FARE_THRESHOLDS[1]
    out.append({
        "name": "bsi_compare", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/bsi_compare.cu",
        "replaces": "pilosa_tpu/executor/expr.py:114",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.bsi_compare(planes, exists, ">",
                                                         pred)),
        "plain_ms": cuda_ms(torch, lambda: kernels.bsi_compare_plain(
            planes, exists, ">", pred), launches=2, reps=3),
        "bound_ms": _bytes_ms((depth + 2) * row_bytes), "bound_by": "bytes",
        "library_ms": NO_LIBRARY,
        "shape": f"planes int32[{N_SHARDS}, {depth + 2}, {WORDS}] + exists",
    })

    # K6 with and without a filter row
    filt = leaves[1]
    err = max(max_abs_err(torch, kernels.bsi_sum(planes, f),
                          kernels.bsi_sum_plain(planes, f))
              for f in (None, filt))
    if err != 0:
        fail(f"bsi_sum disagrees with its plain version by {err}")
    out.append({
        "name": "bsi_sum", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/bsi_sum.cu",
        "replaces": "pilosa_tpu/executor/expr.py:96",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.bsi_sum(planes, filt)),
        "plain_ms": cuda_ms(torch, lambda: kernels.bsi_sum_plain(planes,
                                                                 filt),
                            launches=2, reps=3),
        "bound_ms": _bytes_ms((depth + 2) * row_bytes), "bound_by": "bytes",
        "library_ms": NO_LIBRARY,
        "shape": f"planes int32[{N_SHARDS}, {depth + 2}, {WORDS}] + filter",
    })

    # K7 for min and max, and a filter that empties some shards
    sparse = filt.clone()
    sparse[::3] = 0
    sparse[1::3] &= leaves[2][1::3] & leaves[3][1::3]
    err = 0
    for want_max in (False, True):
        for f in (None, filt, sparse):
            got_v, got_n = kernels.bsi_minmax(planes, f, want_max)
            want_v, want_n = kernels.bsi_minmax_plain(planes, f, want_max)
            live = want_n > 0
            err = max(err, max_abs_err(torch, got_n, want_n),
                      max_abs_err(torch, got_v[live], want_v[live]))
            if not torch.equal(batch.minmax_merge(got_v, got_n, want_max),
                               batch.minmax_merge(want_v, want_n, want_max)):
                fail("bsi_minmax's merged result disagrees")
    if err != 0:
        fail(f"bsi_minmax disagrees with its plain version by {err}")
    out.append({
        "name": "bsi_minmax", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/bsi_minmax.cu",
        "replaces": "pilosa_tpu/executor/expr.py:147",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.bsi_minmax(planes, filt, True)),
        "plain_ms": cuda_ms(torch, lambda: kernels.bsi_minmax_plain(
            planes, filt, True), launches=2, reps=3),
        "bound_ms": _bytes_ms((depth + 2) * row_bytes), "bound_by": "bytes",
        "library_ms": NO_LIBRARY,
        "shape": f"planes int32[{N_SHARDS}, {depth + 2}, {WORDS}] + filter",
    })
    return out


class Client:
    """One keep-alive HTTP connection to the server."""

    def __init__(self, port: int, index: str = "repository"):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.index = index

    def post(self, path: str, body: bytes) -> tuple[int, bytes]:
        self.conn.request("POST", path, body=body)
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def query(self, pql: str) -> list:
        status, body = self.post(f"/index/{self.index}/query", pql.encode())
        if status != 200:
            fail(f"{pql} answered {status}: {body[:300]!r}")
        return json.loads(body)["results"]

    def close(self) -> None:
        self.conn.close()


def run_main_paths(data_dir: str, words: dict, rides: dict, oracle: dict,
                   rng, kernels) -> tuple[dict, dict, dict, dict]:
    """Phase 4 through one server: the Star-Trace path, then the rides
    path, each with the launch counters zeroed just before it and read
    just after. Returns (star numbers, star launches, rides numbers,
    rides launches)."""
    from pilosa_tpu_torch.server import Server

    server = Server(data_dir, bind="127.0.0.1", port=0).open()
    try:
        kernels.reset_launches()
        star = _serve_and_check(server, words, rng)
        star_launched = kernels.launches()
        kernels.reset_launches()
        ride_stats = _serve_rides(server, rides, oracle)
        rides_launched = kernels.launches()
        return star, star_launched, ride_stats, rides_launched
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
    latencies, wall = closed_loop(server.port, "repository",
                                  [pql for pql, _, _ in shapes], truth,
                                  n_clients, per_client)
    stats.update(_latency_stats(latencies, wall), clients=n_clients,
                 largest_batch=server.executor.largest_batch)

    # Shift (K4, then K1) and Not (diff against the existence row, K1)
    sg0 = words[("stargazer", 0)].reshape(N_SHARDS, WORDS)
    carry = np.zeros_like(sg0)
    carry[:, 1:] = sg0[:, :-1] >> np.uint32(31)  # no bit crosses a shard
    want = int(np.bitwise_count((sg0 << np.uint32(1)) | carry).sum(
        dtype=np.int64))
    got = c.query("Count(Shift(Row(stargazer=0), n=1))")[0]
    if got != want:
        fail(f"Count(Shift(Row(stargazer=0), n=1)) = {got}, oracle {want}")
    exists = np.zeros(N_SHARDS * WORDS, np.uint32)
    for w in words.values():
        exists |= w
    for cols in (sg, lang):
        np.bitwise_or.at(exists, cols >> 5,
                         np.uint32(1) << (cols & 31).astype(np.uint32))
    want = int(np.bitwise_count(exists & ~words[("stargazer", 1)]).sum(
        dtype=np.int64))
    got = c.query("Count(Not(Row(stargazer=1)))")[0]
    if got != want:
        fail(f"Count(Not(Row(stargazer=1))) = {got}, oracle {want}")

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


def make_rides(rng) -> dict:
    """Host words of the rides index, one column per ride: ``cab_type``
    rows 0-2 (each ride exactly one cab type), the ``fare`` planes
    uint32[2 + 20, 2^25] (15/16 of the rides carry a fare, uniform over
    0..FARE_MAX cents: random plane words under the exists row), and
    N_TIPS (column, tip) pairs on distinct random rides."""
    n_words = N_SHARDS * WORDS
    a = rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
    cab = {0: a, 1: ~a & b, 2: ~a & ~b}
    planes = np.zeros((2 + FARE_DEPTH, n_words), np.uint32)
    for _ in range(4):
        planes[0] |= rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
    for i in range(FARE_DEPTH):
        planes[2 + i] = rng.integers(0, 1 << 32, n_words,
                                     dtype=np.uint32) & planes[0]
    tip_cols = np.sort(rng.choice(n_words * 32, N_TIPS, replace=False))
    tip_vals = rng.integers(0, TIP_MAX + 1, N_TIPS)
    return {"cab": cab, "fare": planes, "tip_cols": tip_cols,
            "tip_vals": tip_vals}


def _pair_bits() -> np.ndarray:
    """table[b1 << 8 | b0][k]: bit k of byte b0 at bit 0, of b1 at bit 1."""
    idx = np.arange(1 << 16)[:, None]
    return (((idx >> np.arange(8)) & 1)
            | (((idx >> (8 + np.arange(8))) & 1) << 1)).astype(np.uint32)


def _fare_values(planes: np.ndarray, lo: int, hi: int, pair_bits):
    """(values uint32, exists bool) of the columns of words [lo, hi): the
    value of every column built from its bits, two planes per table
    lookup — a path independent of the bit-sliced kernels."""
    by = planes[:, lo:hi].view(np.uint8)
    values = np.zeros((by.shape[1], 8), np.uint32)
    for i in range(0, FARE_DEPTH, 2):
        pair = by[2 + i].astype(np.uint16) | (
            by[3 + i].astype(np.uint16) << np.uint16(8))
        values |= pair_bits[pair] << np.uint32(i)
    exists = np.unpackbits(by[0], bitorder="little").astype(bool)
    return values.reshape(-1), exists


def _tip_answers(cols, vals, fare_of: dict) -> dict:
    """Sum/Min of tip and Max of tip under Row(fare > N) for the rides
    ``cols`` with tips ``vals``; ``fare_of`` maps a column to its fare
    (absent: no fare)."""
    n = FARE_THRESHOLDS[1]
    lo = int(vals.min())
    under = np.array([fare_of.get(int(c), -1) > n for c in cols])
    top = int(vals[under].max())
    return {
        'Sum(field="tip")': {"value": int(vals.sum()), "count": int(vals.size)},
        'Min(field="tip")': {"value": lo, "count": int((vals == lo).sum())},
        f'Max(Row(fare > {n}), field="tip")': {
            "value": top, "count": int((vals[under] == top).sum())},
    }


def rides_oracle(rides: dict) -> dict:
    """Every rides answer, from the host words, one chunk of shards at a
    time; also a ride with fare > FARE_THRESHOLDS[1] and no tip (for the
    write check)."""
    planes, cab1 = rides["fare"], rides["cab"][1]
    gt = dict.fromkeys(FARE_THRESHOLDS, 0)
    between = cab_sum = cab_n = 0
    lo_v, hi_v = FARE_BETWEEN
    chunk = 4 * WORDS
    free_col = None
    tipped = set(rides["tip_cols"].tolist())
    pair_bits = _pair_bits()
    for lo in range(0, planes.shape[1], chunk):
        values, exists = _fare_values(planes, lo, lo + chunk, pair_bits)
        for n in gt:
            gt[n] += int(np.count_nonzero(exists & (values > n)))
        between += int(np.count_nonzero(exists & (values >= lo_v)
                                        & (values <= hi_v)))
        c1 = exists & np.unpackbits(cab1[lo:lo + chunk].view(np.uint8),
                                    bitorder="little").astype(bool)
        cab_sum += int(values[c1].sum(dtype=np.int64))
        cab_n += int(np.count_nonzero(c1))
        if free_col is None:
            for c in np.flatnonzero(exists & (values > FARE_THRESHOLDS[1])):
                if lo * 32 + int(c) not in tipped:
                    free_col = lo * 32 + int(c)
                    break
    cols = rides["tip_cols"]
    word, bit = cols >> 5, (cols & 31).astype(np.uint32)
    has = ((planes[0, word] >> bit) & 1) == 1
    fare = np.zeros(cols.size, np.int64)
    for i in range(FARE_DEPTH):
        fare |= (((planes[2 + i, word] >> bit) & 1).astype(np.int64) << i)
    fare_of = {int(c): int(f) for c, f in zip(cols[has], fare[has])}
    truth = {f"Count(Range(fare > {n}))": gt[n] for n in FARE_THRESHOLDS}
    truth[f"Count(Row(fare >< [{lo_v}, {hi_v}]))"] = between
    truth['Sum(Row(cab_type=1), field="fare")'] = {"value": cab_sum,
                                                   "count": cab_n}
    truth.update(_tip_answers(cols, rides["tip_vals"], fare_of))
    return {"truth": truth, "fare_of": fare_of, "free_col": free_col}


def _serve_rides(server, rides: dict, oracle: dict) -> dict:
    """Phase 4b: the rides index through the server; returns its numbers."""
    stats = {}
    truth = oracle["truth"]
    c = Client(server.port, "rides")
    status, resp = c.post("/index/rides/field/tip", json.dumps(
        {"options": {"type": "int", "min": 0, "max": TIP_MAX}}).encode())
    if status != 200:
        fail(f"creating the tip field answered {status} {resp!r}")
    t0 = time.perf_counter()
    changed = 0
    cols, vals = rides["tip_cols"], rides["tip_vals"]
    for lo in range(0, N_TIPS, IMPORT_BATCH):
        body = json.dumps({"columns": cols[lo:lo + IMPORT_BATCH].tolist(),
                           "values": vals[lo:lo + IMPORT_BATCH].tolist()})
        status, resp = c.post("/index/rides/field/tip/import-value",
                              body.encode())
        if status != 200:
            fail(f"import-value answered {status} {resp[:300]!r}")
        changed += json.loads(resp)["changed"]
    stats["tip_import_s"] = time.perf_counter() - t0
    if changed != N_TIPS:
        fail(f"import-value changed {changed} columns, not {N_TIPS}")
    status, resp = c.post("/index/rides/field/tip/import-value",
                          b'{"columns": [1], "values": [100001]}')
    if status != 400:
        fail(f"an out-of-range tip answered {status}, not 400")

    t0 = time.perf_counter()
    for pql, want in truth.items():  # first touch: planes decoded, uploaded
        got = c.query(pql)[0]
        if got != want:
            fail(f"{pql} = {got}, oracle {want}")
    stats["first_touch_s"] = time.perf_counter() - t0

    # a write the resident tip planes must show (K3's row form), and back
    col = oracle["free_col"]
    if col is None:
        fail("no untipped ride with a high fare")
    more = _tip_answers(np.append(cols, col), np.append(vals, TIP_MAX),
                        {**oracle["fare_of"], col: FARE_THRESHOLDS[1] + 1})
    if c.query(f"Set({col}, tip={TIP_MAX})") != [True]:
        fail("Set of a tip changed nothing")
    for pql, want in more.items():
        got = c.query(pql)[0]
        if got != want:
            fail(f"{pql} after Set = {got}, oracle {want}")
    if c.query(f"Clear({col}, tip=0)") != [True]:
        fail("Clear of a tip changed nothing")
    for pql in more:
        if c.query(pql)[0] != truth[pql]:
            fail(f"{pql} after Clear does not match the oracle")

    shapes = [f"Count(Range(fare > {FARE_THRESHOLDS[0]}))",
              f"Count(Row(fare >< [{FARE_BETWEEN[0]}, {FARE_BETWEEN[1]}]))",
              'Sum(Row(cab_type=1), field="fare")', 'Min(field="tip")',
              f'Max(Row(fare > {FARE_THRESHOLDS[1]}), field="tip")']
    n_clients, per_client = 16, 20
    latencies, wall = closed_loop(server.port, "rides", shapes, truth,
                                  n_clients, per_client)
    stats.update(_latency_stats(latencies, wall), clients=n_clients,
                 resident_bytes=server.holder.cache.bytes_used)
    c.close()
    return stats


def _latency_stats(latencies: list, wall: float) -> dict:
    lat = sorted(latencies)
    return {"qps": len(lat) / wall, "queries": len(lat),
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(0.99 * (len(lat) - 1))]}


def closed_loop(port: int, index: str, shapes: list, truth: dict,
                n_clients: int, per_client: int) -> tuple[list, float]:
    """``n_clients`` keep-alive clients, each sending ``per_client``
    queries back to back over ``shapes``; every answer is held against
    ``truth``. Returns (latencies in s, wall s)."""
    errors: list = []
    latencies: list = []
    lock = threading.Lock()

    def client(k: int) -> None:
        cl = Client(port, index)
        try:
            for j in range(per_client):
                pql = shapes[(k + j) % len(shapes)]
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
            fail(f"a client on {index} hung")
    wall = time.perf_counter() - t0
    if errors or len(latencies) != n_clients * per_client:
        fail(f"concurrent queries on {index} wrong or missing: {errors[:3]}")
    return latencies, wall


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
    rides = make_rides(rng)
    print(f"data: 8 Star-Trace rows, 3 cab_type rows and 22 fare planes x "
          f"{N_SHARDS} shards in {time.perf_counter() - t0:.1f}s", flush=True)

    # phase 3: kernels against their plain versions on the card
    leaves = [torch.from_numpy(w.view(np.int32)).to(dev).reshape(N_SHARDS,
                                                                WORDS)
              for w in words.values()]
    leaves += [torch.roll(leaf, 1, 0) for leaf in leaves]  # 16 for R=8 x 2
    report = check_kernels(torch, kernels, batch, leaves, rng)
    planes = torch.from_numpy(rides["fare"].view(np.int32)).to(dev).reshape(
        2 + FARE_DEPTH, N_SHARDS, WORDS).permute(1, 0, 2).contiguous()
    report += check_port_kernels(torch, kernels, batch, leaves, planes)
    del leaves, planes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for k in report:
        print(f"kernel {k['name']}: bit-exact, {k['ms']} ms "
              f"(plain {k['plain_ms']} ms, bound {k['bound_ms']} ms"
              f" by {k['bound_by']}) at {k['shape']}", flush=True)
    print("kernel tree_rows with OP_NOT and word_patch's [S, R, W] row "
          "form: bit-exact", flush=True)

    # phase 4: the main paths
    scratch = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        holder = Holder(str(scratch / "data")).open()
        fields = {}
        for (f, r), w in words.items():
            fields.setdefault(f, {})[r] = w
        load_from_dense(holder, fields, index="repository")
        print(f"data dir repository: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        load_from_dense(holder, {"cab_type": rides["cab"]}, index="rides",
                        int_fields={"fare": (0, FARE_MAX, rides["fare"])})
        holder.close()
        print(f"data dir rides: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        oracle = rides_oracle(rides)
        print(f"rides oracle: {time.perf_counter() - t0:.1f}s", flush=True)
        star, star_launched, ride_stats, rides_launched = run_main_paths(
            str(scratch / "data"), words, rides, oracle, rng, kernels)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    expected = {
        "Star-Trace": (star_launched, ("tree_count", "tree_rows",
                                       "word_patch", "row_shift")),
        "rides": (rides_launched, ("tree_count", "word_patch", "bsi_compare",
                                   "bsi_sum", "bsi_minmax")),
    }
    for path, (launched, names) in expected.items():
        for name in names:
            if launched[name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
    for k in report:
        k["launches"] = star_launched[k["name"]] + rides_launched[k["name"]]
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was not launched on a main path")
    print("main path Star-Trace: " + json.dumps(star), flush=True)
    print(f"launches Star-Trace: {json.dumps(star_launched)}", flush=True)
    print("main path rides: " + json.dumps(ride_stats), flush=True)
    print(f"launches rides: {json.dumps(rides_launched)}", flush=True)
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

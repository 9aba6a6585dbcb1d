#!/usr/bin/env python3
"""Chip smoke test of pilosa_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--verify-on-load]

(``python3 chip_smoke.py --load-client`` is one of its load-client
processes, started by the serving path.)

Phases, each of which ends the run with a non-zero exit when it fails:

1. print the card's name and power limit (nvidia-smi); build the
   fastbits host library (``pilosa_tpu_torch/native``, g++) and fail if
   it is not active: row decodes, small write merges and bit packing
   must run natively, not through their numpy fallbacks;
2. build the thirteen CUDA kernels from ``pilosa_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card,
   bit-exact, at the main paths' shapes (int32[1024, 32768] leaves, a
   4-query micro-batch, a K3 patch whose masks have bit 31 set and a
   mixed K3 batch of [S, W] slots and [S, R, W] plane rows, OR and
   AND-NOT, in one launch, the
   int32[1024, 22, 32768] planes of a depth-20 int field, an 8-row TopN
   chunk int32[1024, 8, 32768], GroupBy levels of 80 and 1024
   candidates), K1 and K2 in every program form (K1 as a 4-query
   micro-batch with four salts), K7 on synthetic depth-41 and depth-63
   planes against a numpy oracle, K9 at its edge shapes, and time each
   with CUDA events beside the kernel's bound (K1 per form, with ptxas'
   registers and stack of every K1 and K7 instance; K3's whole call
   apart from its launch alone and the launch floor;
   K9 also beside its popcount floor, with the bytes it stages and its
   plan variants), and K10 and K11 at a month leaf's shape (32 768
   blocks, ~391 real ones padded to 512), on random blocks and on an
   all-zero leaf, beside index_select and zeros + index_copy_, K10 as
   the cache calls it (into one compressed entry's storage), alone on a
   device index, and batched over 16 month leaves in one launch, its
   whole call apart from its device time (a CUDA graph of launches),
   and the mesh lanes at the mesh path's shapes (8 members of 128
   slots: a Count's one lane, the taxi candidates): K12+K13 from every
   input layout the executor gives it, its whole call at a Count's
   reduce beside its device time, its C call alone, torch.stack of the
   members and torch.sum of that stack; K14+K15 from the same layouts
   (and a GroupBy level's [2, k, c] as [2, k*c]) over 2 and 4 groups and
   the flat mesh, its whole call over 65 536 candidates in 4 groups
   beside its device time, its C call alone and torch.stack of the
   members.
   Meanwhile worker processes (one per field, three for the time
   field's views, one for the existence rows; the pickup_year worker
   also writes payment_type, the repository worker the users index and
   the 84 pickup_month rows)
   write the data directory from the same host words;
4. drive nine main paths through the port's HTTP server on 127.0.0.1 over
   that 1B-column (1024-shard) data directory, written through the port's
   Holder, every answer checked against a numpy oracle over the same
   host words, the kernels' launch counters zeroed just before each path
   and read just after it. The server runs in the default group-commit
   durability mode and prints its WAL's groups, fsyncs and ops after each
   path, and the time its clean close takes. The server opens without
   verifying the
   fragments' .checksums, and times the verification of 64 fragments;
   with --verify-on-load it opens as the port does by default,
   verifying every fragment, and times that open:
   a. Star-Trace (index ``repository``): Count and row algebra (16
      concurrent Count clients), Shift and Not, a 20-leaf Union and a
      20-deep nested tree (cut into K2 'tree' steps), writes through
      /import and Set/Clear, then one /import of a bit into each of the
      1024 shards of a resident row, which must make exactly one K3
      launch;
   b. NYC-taxi rides (index ``rides``, BASELINE config 3): a set field
      ``cab_type``, an int field ``fare`` (cents, 0..1048575, depth 20)
      and an int field ``tip`` filled through /import-value; Range,
      between, Sum, Min and Max, a Set on ``tip`` that the next
      aggregates must show, then 16 concurrent clients over five BSI
      shapes;
   c. the taxi queries on ``rides`` (BASELINE config 2; Litwintschik's
      "1.1 Billion Taxi Rides" queries 1-4): set fields
      ``passenger_count``, ``pickup_year`` and ``trip_distance``, one row
      per ride each; TopN (filtered too), Rows, GroupBy over one, two and
      three dimensions (the last past the dense limit, so pruned level by
      level) and over 17 (past K9's 16), Sum aggregate, having, Options(shards=), IncludesColumn, a
      Set that the next TopN and GroupBy must show, then 16 concurrent
      clients over five shapes of queries 1-3;
   d. the time path (index ``events``, BASELINE config 4): a YMDH time
      field over 8 event-hours, a mutex and a bool field; 16 concurrent
      clients over five shapes (Counts over one Y view and over 65-view
      windows, their Union, an Intersect with a mutex row, a TopN under
      a window), the bool row, a GroupBy under a window and an empty
      window; then a timestamped Set into the resident 65-view leaf (one
      K3 launch) and a Clear (the slot re-decoded), a timestamped
      /import of a bit in each of 128 shards at an hour with no view
      (one K3 launch), a mutex /import moving a column in each of 128
      shards (one K3 launch), a Store of a sparse row and a
      ClearRow of it (one K3 launch, the leaf still resident), every
      answer against the oracle after each;
   e. the keys path (upstream pilosa's ``keys`` option; the taxi
      records' string payment_type column): a mutex field
      ``payment_type`` with row keys on ``rides`` (1024 shards) and an
      index ``users`` with 2^22 column keys and a keyed field
      ``segment``; 16 concurrent clients over five shapes (a keyed
      Intersect Count, TopN and GroupBy on rides, a Count and a Row
      returned as column keys on users), then Rows with like=, row and
      column attrs (SetRowAttrs, TopN(attrName=), Options(columnAttrs=),
      ?excludeRowAttrs), IncludesColumn by key, a keyed Set that creates
      a row key and moves a mutex column (one K3 launch), a new column
      key that opens a fifth users shard, 1000 keys through
      /internal/translate/keys then /import by id, and the translate
      log's new bytes;
   f. the wire path (the NYC TLC trip records' store_and_fwd_flag, 1% of
      the rides, as Litwintschik's benchmark loads it): /schema, GET
      /index/rides, /internal/shards/max, /version and /info; a set
      field ``store_and_fwd_flag`` whose row 1 is made resident, then
      loaded through import-roaring by 16 clients, one shard's bits a
      request in bodies under /status's maxWritesPerRequest (odd shards
      in upstream pilosa's roaring layout), one K3 launch a request, and
      one body over the limit (413); 16 closed-loop protobuf clients
      (QueryRequest in, QueryResponse out, decoded by the port's
      decode_results_json) for 1 s and the same five shapes as JSON
      for 1 s (an Intersect Count, a filtered TopN, a Sum, a filtered
      GroupBy and a Row over two shards); a protobuf ImportRequest and
      ImportValueRequest of 4096 bits and values (one K3 launch each);
      the /export CSV (about 10.7 M lines) against the oracle's SHA-256;
      /metrics parsed; the field deleted (its leaves leave the card, its
      directory the disk, a query of it gets the reference's 400),
      re-created empty on the card and deleted again;
   i. the mesh path (after the wire path; its letter follows the
      serving path's): ``DistExecutor`` over ``make_mesh(8,
      devices=[cuda:0], groups=g)`` on the server's holder at 1024
      shards, the flat 1 x 8 mesh, then 2 x 4 and 4 x 2 with the 8-bit
      ranking lane (one pass verifying it against the lossless
      ranking): the five Star-Trace Counts through ``execute`` and
      pipelined through ``submit`` (micro-batched), a Row gather
      (roaring frames on the 2-D meshes), the tip's Sum, Min, Max and a
      Range count, taxi queries 1-4 (Q4 also with its dimensions
      reversed: a quantized pruning level of 512 candidates) and a Set
      and its Clear through HTTP between mesh reads of the leaf they
      patch; every answer the oracle's and the single-device
      executor's; the lane kernels' launches and the reductions per
      query kind, a 2-D mesh's Count ms beside M1's, the reduction's
      dense and actual bytes, the quantized windows and ms per query
      printed;
   g. the tier path (the NYC TLC months as Litwintschik's benchmark
      loads them): a set field ``pickup_month`` of 84 contiguous-range
      rows on ``rides``; the budget lowered to 16 dense months beside
      the cab_type leaves; 16 concurrent clients (3 queries each) over
      a month x cab Count, a quarter's Count and a month's TopN(cab_type) (K10
      demotes each eviction's victims in one launch, K11 promotes); a
      Count of every month, one tierer pass to the host tier (the dense
      months gathered by one K10 launch before their compact blocks are
      read back; the bytes read back printed; the operand memo empty
      after it and the demoted bytes freed on the card, by
      ``torch.cuda.memory_allocated``), 84 serial Counts that are
      host-tier hits, a Set
      into a host-tier leaf (its copy invalidated) and into a dense one
      (one K3 launch, the leaf then dropped, not compressed), every
      answer against the oracle; the budget restored;
   h. the serving envelope (on ``repository``, after the taxi path):
      16 closed-loop clients over the five Star-Trace Count shapes for
      3 s through the pipeline wave, then 3 s with
      ``api.serve_pipelined = False``, each with QPS, p50, p99, waves,
      coalesced and deduped requests, K1 launches a query and the mean
      micro-batch, and the operand memo's hits and misses a served
      Count (the direct loop must make hits); ``?profile=true`` trees of
      a Count and of a Row; the result cache on: repeated Counts served
      as hits, then a Set, an /import and an import-roaring each land in
      a counted row and the next Count answers the new oracle value;
      with the result cache off again, Counts answered from the operand
      memo (the leaves K3 patched in place) against the same value; two
      tenants under a
      per-tenant gate of 2 in flight (429 with Retry-After, every 200
      against the oracle); an ``X-Pilosa-Deadline-Ms: 1`` GroupBy (taxi
      query 4) queued in a wave behind a Count of a cold leaf is a
      504; ``POST /debug/trace-device?secs=1`` under load, asked once,
      the load running until it answers (the trace's K1 kernel events
      counted); ``/debug/traces``, ``/debug/slo``,
      ``/debug/vars``, ``/debug/queries`` and ``/metrics`` with the
      serving planes' families; then multi-process serving over the
      same open server, started by ``Server.start_serving_workers`` (what
      ``Server.open`` calls when ``serving-workers`` > 0) with 4
      ``SO_REUSEPORT`` workers on a port of their own and rings sized to
      ``/dev/shm`` (``df`` printed; ``os.cpu_count()`` printed): the five
      Count shapes from 2 client processes of 8 keep-alive clients each
      (``chip_smoke.py --load-client``, every answer against the oracle
      passed in as JSON) for 3 s against the single-process wave, then
      3 s through the workers, each with QPS, p50, p99, K1 launches and
      operand-memo hits a served Count, the wave's counters and the
      owner's batches, batched requests, deduped frames and queries
      served, and the workers' ring round-trip p50/p99 from the control
      block; a Set and a Clear through one worker read back through
      each of the others; one worker SIGKILLed under the client
      processes' load (no wrong answer, a respawn with a new pid, the
      reaped worker counted); the workers handshake again after the
      owner's half restarts and take a sample rate of 1, and one Count's
      trace is a worker's ``http.query`` root holding the owner's
      ``rpc.query`` subtree; ``/debug/workers`` and the ``serving_*``
      families on ``/metrics``; the workers stopped;
5. the crash phase, on a 64-shard directory of its own, run after phase
   3 while the data-dir builders still run: a port server process on
   the card takes Set, Clear, /import, /import-value,
   timestamped Sets into a YMDH field, Sets moving columns of a mutex
   field and keyed Sets (new column keys, new and old row keys) from 4
   HTTP clients and is SIGKILLed after 400 acknowledged writes; a port
   Holder reopens the directory on the card, replays the WAL and the
   translate log, and every acknowledged write must read back (in each
   of its time views, under its own keys), every Count equal the numpy
   oracle, no mutex column sit in two rows, no key hold a column no
   client sent for it, and the WAL be empty after the open;
6. the integrity path, on a copy of rides' cab_type and pickup_year at
   64 shards in a directory of its own: four payload bytes flipped (one
   shard rotten in both fields), one fragment torn, one .checksums
   deleted, then a port server opens it on the card verifying every
   fragment (five quarantined, Count, TopN and Options(shards=) against
   the oracle without those fragments); a byte flipped under a resident
   cab_type leaf is healed by ``python -m pilosa_tpu_torch check --host``
   (self_healed=1, no row-cache miss after); 16 Count clients for 1 s
   without and during a scrub pass, whose MB/s is printed; an ENOSPC on
   every fsync under the directory fails one Set, sheds the next and an
   index create with 503 and Retry-After with no K3 launch while 16
   clients read on, and once the rule goes the probe recovers (seconds
   printed) and a Set makes one K3 launch; ``check -d`` offline (exit 1,
   six QUARANTINED lines, every other fragment ok) and a reopen on the
   card with every answer the oracle's.

Before the kernels JSON a line gives the set-up seconds (the data dirs
waited for, the server's open and close, each path's first touch)
beside an earlier run's on the same card (P1 in PERF.md). The
second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. No JAX, nothing of pilosa_tpu.
"""

from __future__ import annotations

import argparse
import copy
import datetime as dt
import errno
import hashlib
import http.client
import itertools
import json
import multiprocessing
import os
import resource
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 rate
INT_OPS_PER_S = 67e12      # H100 SXM non-tensor-core peak
SMS = 132                  # H100 SXM streaming multiprocessors
POPC_PER_CLOCK_PER_SM = 16  # 32-bit popcounts, compute capability 9.0
N_SHARDS = 1024            # 2^30 columns: BASELINE configs 1-3
WORDS = 32768
SPARSE_ROW = 10
FARE_MAX = (1 << 20) - 1   # cents; bit depth 20
FARE_DEPTH = 20           # even: the oracle reads the planes in pairs
TIP_MAX = 100_000
N_TIPS = 50_000            # 100 000 until the mesh path came
IMPORT_BATCH = 5000        # the server's max-writes-per-request
FARE_THRESHOLDS = (100_000, 524_287, 1_000_000)
FARE_BETWEEN = (250_000, 750_000)
SHIFTS = (0, 1, -1, 31, -31, 32, -32, 33, -33, WORDS * 32 - 1,
          -(WORDS * 32 - 1), 1 << 20, -(1 << 20), (1 << 20) + 5,
          -(1 << 20) + 5)
NO_LIBRARY = None  # no PyTorch call computes a popcount or a bit shift


def _chain(op: str, leaves: list):
    node = ("leaf", leaves[0])
    for i in leaves[1:]:
        node = (op, node, ("leaf", i))
    return node


def _right_deep(op: str, leaves: list):
    node = ("leaf", leaves[-1])
    for i in reversed(leaves[:-1]):
        node = (op, ("leaf", i), node)
    return node


# K2's program forms, each with the form its classifier must give (0
# general, 1 chain, 2 head-diff): a chain in every leaf bucket, head-diffs
# of leaves and of a fold, OP_NOT after the root, and the general
# interpreter up to a 16-deep stack over 16 leaves
K2_FORMS = [
    (("leaf", 3), 1), (("flipall", ("leaf", 1)), 1),
    (_chain("and", [0, 1]), 1), (_chain("or", [0, 1, 2]), 1),
    (_chain("xor", [4, 0, 2, 1, 3]), 1), (_chain("and", list(range(9))), 1),
    (("flipall", _chain("or", list(range(16)))), 1),
    (_right_deep("xor", list(range(16))), 1),
    (_chain("diff", [2, 0]), 2), (_chain("diff", [0, 1, 2, 3, 4]), 2),
    (("diff", ("leaf", 5), _chain("and", [0, 1, 2])), 2),
    (("flipall", ("diff", ("leaf", 15), _chain("xor", list(range(15))))), 2),
    (("diff", ("flipall", ("leaf", 0)), ("flipall", ("leaf", 1))), 0),
    (("xor", ("diff", ("leaf", 0), ("leaf", 1)),
      ("or", ("leaf", 2), ("const0",))), 0),
    (_right_deep("diff", list(range(16))), 0),
]

# The taxi path's set fields (Litwintschik's "1.1 Billion Taxi Rides"
# queries 1-4): field -> (first row, share of the rides in each row). One
# row per ride and field, drawn from --seed with this skew.
TAXI_FIELDS = {
    "passenger_count": (0, (0.004, 0.70, 0.14, 0.04, 0.02, 0.05, 0.03,
                            0.0005, 0.0003, 0.0002)),
    "pickup_year": (2009, (0.15, 0.15, 0.14, 0.13, 0.12, 0.11, 0.10, 0.10)),
    # rounded miles 0-62, and 63 for 63 miles or more
    "trip_distance": (0, tuple(0.7 ** k + 0.002 for k in range(63))
                      + (0.01,)),
}
# Device bytes the server may keep resident: the rides path's 7.2 GB
# beside the taxi path's 10.25 GiB of dimension rows and TopN chunks
SERVER_BUDGET_BYTES = 64 << 30
# P1's set-up (an earlier run of this script on an NVIDIA H100 80GB HBM3
# at 700 W, with the mesh path, before multi-process serving), printed
# beside this run's
P1_SETUP_S = {"data_dirs": 391.1, "open": 233.7, "close": 63.4,
              "first_touch Star-Trace": 2.050, "first_touch rides": 9.327,
              "first_touch taxi": 21.699, "first_touch time": 4.488,
              "first_touch keys": 4.698}
SETUP_S: dict = {}  # this run's set-up seconds, filled as they pass


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
    check_k1_forms(torch, kernels, expr, leaves, row_words)
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

    # K2: Intersect(Row, Row) words at 1B columns, then every program form
    prog2 = expr.compile_program(("and", ("leaf", 0), ("leaf", 1)))
    pair = [leaves[0], leaves[4]]
    got = kernels.tree_rows(prog2, pair)
    want = kernels.tree_rows_plain(prog2, pair)
    err = max_abs_err(torch, got, want)
    del got, want
    for structure, form in K2_FORMS:
        p = expr.compile_program(structure)
        if kernels.classify_program(p).kind != form:
            fail(f"tree_rows classified {structure} as "
                 f"{kernels.classify_program(p)}, not form {form}")
        err = max(err, max_abs_err(torch, kernels.tree_rows(p, leaves),
                                   kernels.tree_rows_plain(p, leaves)))
    if err != 0:
        fail(f"tree_rows disagrees with its plain version by {err}")
    print(f"kernel tree_rows: {len(K2_FORMS) + 1} programs (chains and "
          "head-diffs in each leaf bucket, the general form to a 16-deep "
          "stack) bit-exact", flush=True)
    # the kernel and the library in turns (kernel, library, library,
    # kernel), each the mean of its two turns
    turns = [cuda_ms(torch, fn) for fn in (
        lambda: kernels.tree_rows(prog2, pair),
        lambda: torch.bitwise_and(*pair), lambda: torch.bitwise_and(*pair),
        lambda: kernels.tree_rows(prog2, pair))]
    k2_ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"kernel tree_rows 2-leaf AND in turns with torch.bitwise_and, "
          f"ms: {turns}", flush=True)
    for name, structure, n in (
            ("3-leaf Union", ("or", ("or", ("leaf", 0), ("leaf", 1)),
                              ("leaf", 2)), 3),
            ("2-leaf Difference under OP_NOT",
             ("diff", ("flipall", ("leaf", 0)), ("flipall", ("leaf", 1))),
             2)):
        p = expr.compile_program(structure)
        form = kernels.classify_program(p).kind
        ms = cuda_ms(torch, lambda: kernels.tree_rows(p, leaves[:n]))
        print(f"kernel tree_rows {name} (form {form}): {ms} ms, bound "
              f"{_bytes_ms((n + 1) * leaf_bytes)} ms, "
              f"{(n + 1) * leaf_bytes / ms / 1e6:.1f} GB/s", flush=True)
    print(f"kernel tree_rows 2-leaf AND: {k2_ms} ms = "
          f"{3 * leaf_bytes / k2_ms / 1e6:.1f} GB/s; torch.bitwise_and "
          f"{lib_ms} ms = {3 * leaf_bytes / lib_ms / 1e6:.1f} GB/s",
          flush=True)
    out.append({
        "name": "tree_rows", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/tree_rows.cu",
        "replaces": "pilosa_tpu/executor/expr.py:62",
        "max_abs_err": err,
        "ms": k2_ms,
        "plain_ms": cuda_ms(torch, lambda: kernels.tree_rows_plain(prog2,
                                                                   pair)),
        "bound_ms": 1e3 * 3 * leaf_bytes / HBM_BYTES_PER_S,
        "bound_by": "bytes",
        "library_ms": lib_ms,
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
        kernels.word_patch_batch([(k_leaf, slot, None, word_idx, masks,
                                   clear)])
        kernels.word_patch_batch_plain([(p_leaf, slot, None, word_idx, masks,
                                         clear)])
        err = max(err, max_abs_err(torch, k_leaf, p_leaf))
        if not torch.equal(k_leaf[:slot], leaves[1][:slot]):
            fail("word_patch touched another slot")
    if err != 0:
        fail(f"word_patch disagrees with its plain version by {err}")
    one = [(k_leaf, slot, None, word_idx, masks, False)]
    k3 = k3_times(torch, kernels, one, k_leaf.device)
    print(f"kernel word_patch, {n} pairs into one row: whole call "
          f"{k3['call_ms']} ms, device {k3['device_ms']} ms, launch floor "
          f"{k3['floor_ms']} ms", flush=True)
    out.append({
        "name": "word_patch", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/word_patch.cu",
        "replaces": "pilosa_tpu/executor/batch.py:196",
        "max_abs_err": err,
        "ms": k3["call_ms"],
        "plain_ms": cuda_ms(torch, lambda: kernels.word_patch_batch_plain(
            [(p_leaf, slot, None, word_idx, masks, False)])),
        # 16 bytes a pair take nanoseconds; the launch floor (an empty
        # kernel through the same ctypes path) is the least the card
        # takes for this work
        "bound_ms": max(1e3 * 16 * n / HBM_BYTES_PER_S, k3["floor_ms"]),
        "bound_by": "launch", "library_ms": None,
        "bytes_bound_ms": 1e3 * 16 * n / HBM_BYTES_PER_S,
        "device_ms": k3["device_ms"], "launch_floor_ms": k3["floor_ms"],
        "shape": f"{n} (word, mask) pairs into one slot of int32[1024, 32768]",
    })
    del k_leaf, p_leaf
    return out


def k3_times(torch, kernels, targets, dev) -> dict:
    """K3's whole call (host packing, staging copy and launch: events
    around back-to-back calls), its launch alone on a blob already staged
    on the card, and the launch floor (an empty kernel through the same
    ctypes path)."""
    blob, t, n = kernels.word_patch_pack(targets)
    staged = torch.from_numpy(blob).to(dev)
    return {
        "call_ms": cuda_ms(torch, lambda: kernels.word_patch_batch(targets),
                           launches=100),
        "device_ms": cuda_ms(torch, lambda: kernels.word_patch_launch_staged(
            staged, t, n), launches=100),
        "floor_ms": cuda_ms(torch, lambda: kernels.launch_floor(dev),
                            launches=100),
    }


def _bytes_ms(n_bytes: float) -> float:
    return 1e3 * n_bytes / HBM_BYTES_PER_S


K1_SALTS = (0, 7, 0x80000001, 0xFFFFFFFF)


def check_k1_forms(torch, kernels, expr, leaves, row_words: int) -> None:
    """K1 in every program form of K2_FORMS (and each with OP_SALT after
    the root), as a 4-query micro-batch with four salts over rotations of
    the 16 leaves, bit-exact; then K1's times per form beside their
    bounds."""
    batch4 = [leaves[q:] + leaves[:q] for q in range(4)]
    err = 0
    for structure, form in K2_FORMS:
        p = expr.compile_program(structure)
        for prog in (p, p + (kernels.OP_SALT,)):
            got_form = kernels.classify_program(prog).kind
            if got_form != form:
                fail(f"tree_count classified {prog} as form {got_form}, "
                     f"not {form}")
            err = max(err, max_abs_err(
                torch, kernels.tree_count(prog, batch4, K1_SALTS, row_words),
                kernels.tree_count_plain(prog, batch4, K1_SALTS, row_words)))
    if err != 0:
        fail(f"tree_count's forms disagree with the plain version by {err}")
    print(f"kernel tree_count: {2 * len(K2_FORMS)} programs in every form "
          f"and leaf bucket, 4 queries with salts {list(K1_SALTS)}, "
          "bit-exact", flush=True)
    leaf_bytes = leaves[0].numel() * 4
    for name, structure, n in (
            ("2-leaf AND", ("and", ("leaf", 0), ("leaf", 1)), 2),
            ("3-leaf Union", _chain("or", [0, 1, 2]), 3),
            ("2-leaf Difference under OP_NOT (general)",
             ("diff", ("flipall", ("leaf", 0)), ("flipall", ("leaf", 1))),
             2)):
        prog = expr.compile_program(structure)
        form = kernels.classify_program(prog).kind
        mb = [batch4[q][:n] for q in range(4)]
        bound = _bytes_ms(4 * n * leaf_bytes)
        ms = cuda_ms(torch, lambda: kernels.tree_count(
            prog, mb, [0] * 4, row_words))
        print(f"kernel tree_count {name} (form {form}, "
              f"{kernels.TREE_COUNT_STEPS[form]} steps a block), 4 queries: "
              f"{ms} ms, bound {bound} ms, {100 * bound / ms:.1f}% of the "
              "bound", flush=True)


def print_ptxas(kernels, name: str) -> None:
    """Registers, stack frame and spills of every instance in a kernel's
    build log (ptxas -v)."""
    logs = sorted(kernels.BUILD_DIR.glob(f"lib{name}-*.log"))
    if not logs:
        print(f"ptxas {name}: no build log (built before this run)")
        return
    entry, rows = None, []
    for line in logs[-1].read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "stack frame" in line and entry:
            frame = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split("registers")[0].strip()
            rows.append((entry, regs, frame))
            entry = None
    framed = [r for r in rows if not r[2].startswith("0 bytes stack frame, "
                                                     "0 bytes spill stores")]
    print(f"ptxas {name}: {len(rows)} instances, {len(framed)} with a stack "
          "frame or spills", flush=True)
    for entry, regs, frame in rows:
        print(f"  {name} {entry[:60]}: {regs} registers; {frame}")


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

    # K3 in one launch over a mixed batch: slots of an [S, W] leaf and
    # rows of the [S, R, W] planes, both directions, bit 31 in every mask
    rng = np.random.default_rng(5)
    flat = leaves[2].clone()
    k_planes, p_planes, p_flat = planes.clone(), planes.clone(), flat.clone()
    spots = ([(0, s_, None) for s_ in rng.choice(N_SHARDS, 24, replace=False)]
             + [(1, s_, int(r)) for s_, r in zip(
                 rng.choice(N_SHARDS, 40, replace=False),
                 rng.integers(0, planes.shape[1], 40))])
    spec = []
    for k, (which, s_, row) in enumerate(spots):
        pos = rng.choice(WORDS * 32, int(rng.integers(1, 1500)),
                         replace=False).astype(np.uint32)
        w, m = batch._word_masks(np.union1d(pos, (pos & ~np.uint32(31)) | 31))
        spec.append((which, int(s_), row, w, m, bool(k % 3 == 0)))
    kernels.word_patch_batch([((flat, k_planes)[i], s_, r, w, m, c)
                              for i, s_, r, w, m, c in spec])
    kernels.word_patch_batch_plain([((p_flat, p_planes)[i], s_, r, w, m, c)
                                    for i, s_, r, w, m, c in spec])
    if not (torch.equal(flat, p_flat) and torch.equal(k_planes, p_planes)):
        fail("word_patch's mixed batch disagrees with its plain version")
    n_pairs = sum(x[3].size for x in spec)
    print(f"kernel word_patch: a mixed batch of {len(spec)} targets "
          f"({n_pairs} pairs; [S, W] slots and [S, R, W] rows, OR and "
          "AND-NOT) bit-exact in one launch", flush=True)
    del flat, k_planes, p_planes, p_flat

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
    check_k7_wide(torch, kernels, batch, planes.device)
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


def _minmax_oracle(planes: np.ndarray, mask: np.ndarray, want_max: bool):
    """Per shard (value, count) of the masked columns' values, built in
    uint64 from the planes; (None, 0) for a shard without one."""
    out = []
    for s in range(planes.shape[0]):
        cols = np.flatnonzero(np.unpackbits(mask[s].view(np.uint8),
                                            bitorder="little"))
        if cols.size == 0:
            out.append((None, 0))
            continue
        vals = np.zeros(cols.size, np.uint64)
        for b in range(planes.shape[1] - 2):
            bits = np.unpackbits(planes[s, 2 + b].view(np.uint8),
                                 bitorder="little")[cols]
            vals |= bits.astype(np.uint64) << np.uint64(b)
        best = vals.max() if want_max else vals.min()
        out.append((int(best), int((vals == best).sum())))
    return out


def check_k7_wide(torch, kernels, batch, dev) -> None:
    """K7 past 31 planes: synthetic depth-41 and depth-63 planes over 64
    shards, every stored value at least 2^40 (plane 40 set on every
    column), sparse columns, one shard without any and one the filter
    empties; Max and Min with and without the filter, against the plain
    version and a Python-int oracle, and the merged result."""
    rng = np.random.default_rng(41)
    for depth in (41, 63):
        exists = np.full((64, WORDS), 0xFFFFFFFF, np.uint32)
        for _ in range(10):
            exists &= rng.integers(0, 1 << 32, exists.shape, dtype=np.uint32)
        exists[5] = 0
        host = rng.integers(0, 1 << 32, (64, 2 + depth, WORDS),
                            dtype=np.uint32) & exists[:, None]
        host[:, 0], host[:, 1], host[:, 2 + 40] = exists, 0, exists
        filt = rng.integers(0, 1 << 32, (64, WORDS), dtype=np.uint32)
        filt[9] = 0
        planes = torch.from_numpy(host.view(np.int32)).to(dev)
        f_dev = torch.from_numpy(filt.view(np.int32)).to(dev)
        for want_max in (True, False):
            for f, mask in ((None, exists), (f_dev, exists & filt)):
                got_v, got_n = kernels.bsi_minmax(planes, f, want_max)
                want_v, want_n = kernels.bsi_minmax_plain(planes, f, want_max)
                live = want_n > 0
                if not (torch.equal(got_n, want_n)
                        and torch.equal(got_v[live], want_v[live])):
                    fail(f"bsi_minmax at depth {depth} disagrees with its "
                         "plain version")
                oracle = _minmax_oracle(host, mask, want_max)
                if [int(n) for n in got_n.tolist()] != [n for _, n in oracle]\
                        or any(n and int(got_v[s]) != v
                               for s, (v, n) in enumerate(oracle)):
                    fail(f"bsi_minmax at depth {depth} disagrees with the "
                         "oracle")
                best = [v for v, n in oracle if n]
                best = max(best) if want_max else min(best)
                merged = batch.minmax_merge(got_v, got_n, want_max)
                if int(merged[0]) != best or best < 1 << 40:
                    fail(f"bsi_minmax's merge at depth {depth} gave "
                         f"{int(merged[0])}, oracle {best}")
        del planes, f_dev
    print("kernel bsi_minmax: depth 41 and 63 over 64 shards (values of "
          "2^40 and more), Max and Min, filtered and not: bit-exact and "
          "equal to the oracle", flush=True)


def _sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), for the popcount floor."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(smi.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {smi.stdout!r} {smi.stderr!r}")


def _k9_edges(torch, kernels, leaves) -> int:
    """K9 against its plain version at the edge shapes, over 64 shards:
    one candidate; 300 candidates over 16 dimensions of 8 rows, which the
    plan must split into tiles; the pruned level's duplicated pad index
    0; candidates out of lexicographic order with depth-20 planes; 16
    dimensions; depth-63 planes; rows of 1001 words (no 16-byte groups)
    and of 3076 words (a ragged last word tile). Returns the largest
    error."""
    rng = np.random.default_rng(11)
    s = 64

    def dim(first, n, words=WORDS):
        return torch.stack([leaves[(first + j) % 16][:s, :words]
                            for j in range(n)], dim=1).contiguous()

    def planes(depth, words=WORDS):
        return torch.stack([leaves[i % 16][:s, :words] ^ (i * 40503)
                            for i in range(2 + depth)], dim=1).contiguous()

    cases = {
        "one candidate": ([dim(0, 4), dim(5, 3)], 1, None, WORDS),
        "split tiles": ([dim(d, 8) for d in range(16)], 300, None, WORDS),
        "pad index 0": ([dim(0, 10), dim(3, 8), dim(7, 16)], 200, None,
                        WORDS),
        "unsorted, depth 20": ([dim(2, 5), dim(9, 7)], 35, 20, WORDS),
        "16 dimensions": ([dim(d, 2) for d in range(16)], 64, None, WORDS),
        "depth 63": ([dim(4, 6)], 6, 63, WORDS),
        "1001 words": ([dim(1, 5, 1001), dim(6, 3, 1001)], 15, 7, 1001),
        "3076 words": ([dim(1, 5, 3076), dim(6, 3, 3076)], 15, None, 3076),
    }
    err = 0
    for name, (dims, n_cand, depth, words) in cases.items():
        idxs = [rng.integers(0, d.shape[1], n_cand) for d in dims]
        if name == "pad index 0":
            for ix in idxs:
                ix[n_cand // 2:] = 0
        f = leaves[15][:s, :words].contiguous()
        p = planes(depth, words) if depth is not None else None
        plan = kernels.groupby_plan(idxs, True, depth, words, words % 4 == 0)
        if name == "split tiles" and len(plan.tiles) < 2:
            fail("the split-tiles edge case fit one tile")
        got = kernels.groupby_level(dims, idxs, f, p)
        want = kernels.groupby_level_plain(dims, idxs, f, p)
        e = max_abs_err(torch, got, want)
        print(f"kernel groupby_level edge {name}: {len(dims)} dimensions, "
              f"C = {n_cand}, {words} words, {len(plan.tiles)} tile(s): "
              f"max_abs_err {e}", flush=True)
        err = max(err, e)
    return err


def check_taxi_kernels(torch, kernels, leaves, planes) -> list:
    """Phase 3, slice 3: K8 and K9 against their plain versions,
    bit-exact, at the taxi path's shapes: an 8-row TopN chunk
    int32[1024, 8, 32768] with and without a filter and with zero pad
    rows; GroupBy levels of Q3 (dimensions of 10 and 8 rows, C = 80, a
    filter), Q2 (10 rows, the depth-20 fare planes) and a pruned level (3
    dimensions, 1000 candidates padded with index 0 to 1024)."""
    out = []
    row_bytes = leaves[0].numel() * 4
    n_shards = leaves[0].shape[0]

    # K8
    matrix = torch.stack(leaves[:8], dim=1)
    padded = matrix.clone()
    padded[:, 6:] = 0
    filt = leaves[8]
    err = 0
    for m in (matrix, padded):
        for f in (None, filt):
            err = max(err, max_abs_err(torch, kernels.count_rows(m, f),
                                       kernels.count_rows_plain(m, f)))
    if err != 0:
        fail(f"count_rows disagrees with its plain version by {err}")
    out.append({
        "name": "count_rows", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/count_rows.cu",
        "replaces": "pilosa_tpu/executor/expr.py:86",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.count_rows(matrix, filt)),
        "plain_ms": cuda_ms(torch, lambda: kernels.count_rows_plain(
            matrix, filt), launches=2, reps=3),
        "bound_ms": _bytes_ms(9 * row_bytes + n_shards * 8 * 4),
        "bound_by": "bytes", "library_ms": NO_LIBRARY,
        "shape": f"int32[{n_shards}, 8, {WORDS}] + filter",
    })
    del matrix, padded

    # K9: Q3's level, Q2's level and a pruned level
    d10 = torch.stack(leaves[:10], dim=1)
    d8 = torch.stack(leaves[8:16], dim=1)
    d16 = torch.stack(leaves[:16], dim=1)
    q3 = np.array(list(itertools.product(range(10), range(8))), np.int32).T
    rng = np.random.default_rng(9)
    pick = rng.choice(10 * 8 * 16, 1000, replace=False)
    pruned = np.zeros((3, 1024), np.int32)  # 24 pad candidates at index 0
    pruned[:, :1000] = np.stack(np.unravel_index(pick, (10, 8, 16)))
    levels = {
        "Q3": ([d10, d8], list(q3), leaves[15], None),
        "Q2": ([d10], [np.arange(10)], None, planes),
        "pruned": ([d10, d8, d16], list(pruned), leaves[3], None),
    }
    err = 0
    for dims, idxs, f, p in levels.values():
        got = kernels.groupby_level(dims, idxs, f, p)
        want = kernels.groupby_level_plain(dims, idxs, f, p)
        err = max(err, max_abs_err(torch, got, want))
        del got, want
    err = max(err, _k9_edges(torch, kernels, leaves))
    if err != 0:
        fail(f"groupby_level disagrees with its plain version by {err}")
    sm_hz = _sm_clock_hz()
    for name, (dims, idxs, f, p) in levels.items():
        c = len(idxs[0])
        rows = sum(len(np.unique(ix)) for ix in idxs)
        extra = (f is not None) + (p.shape[1] if p is not None else 0)
        k = 1 if p is None else p.shape[1]
        bound = _bytes_ms((rows + extra) * row_bytes + n_shards * k * c * 4)
        # one popcount per mask word per count (count, n, each plane)
        popc_ms = 1e3 * c * k * leaves[0].numel() / (
            POPC_PER_CLOCK_PER_SM * SMS * sm_hz)
        gather = c * len(dims) * row_bytes
        ms = cuda_ms(torch, lambda: kernels.groupby_level(dims, idxs, f, p),
                     launches=3, reps=3)
        depth = None if p is None else p.shape[1] - 2
        plan = kernels.groupby_plan(idxs, f is not None, depth, WORDS, True)
        staged = plan.staged_rows * row_bytes
        print(f"kernel groupby_level at {name}: {len(dims)} dimensions, "
              f"C = {c}{', filter' if f is not None else ''}"
              f"{', depth-20 planes' if p is not None else ''}: {ms} ms, "
              f"bound {bound} ms by bytes, popcount floor {popc_ms} ms at "
              f"{sm_hz / 1e9:.3f} GHz; staged from HBM {staged} bytes "
              f"({staged / ((rows + extra) * row_bytes):.3f}x the distinct "
              f"input {(rows + extra) * row_bytes} bytes; a gather per "
              f"candidate reads {gather}); plan: {len(plan.tiles)} tile(s), "
              f"{len(plan.groups)} groups, TW {plan.tile_words}, chunk "
              f"{plan.chunk_elems}, {plan.smem_bytes} B shared", flush=True)
        variants = {}
        for tw, ce, gm in itertools.product(kernels.GROUPBY_TILE_WORDS,
                                            (2, 4), (None, 8, 2)):
            try:
                v = kernels.groupby_plan(idxs, f is not None, depth, WORDS,
                                         True, tile_words=tw, chunk_elems=ce,
                                         group_max=gm)
            except ValueError:
                continue  # that word tile does not fit
            variants[f"TW{tw}/ce{ce}/g{gm or 'auto'}"] = round(cuda_ms(
                torch, lambda: kernels.groupby_level(dims, idxs, f, p,
                                                     plan=v),
                launches=2, reps=3), 4)
        print(f"kernel groupby_level at {name}, plan variants (ms): "
              + json.dumps(variants), flush=True)
    dims, idxs, f, p = levels["Q3"]
    out.append({
        "name": "groupby_level", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/groupby_level.cu",
        "replaces": "pilosa_tpu/executor/batch.py:696",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.groupby_level(dims, idxs, f, p),
                      launches=3, reps=3),
        "plain_ms": cuda_ms(torch, lambda: kernels.groupby_level_plain(
            dims, idxs, f, p), launches=1, reps=3),
        "bound_ms": _bytes_ms(19 * row_bytes + n_shards * 80 * 4),
        "bound_by": "bytes", "library_ms": NO_LIBRARY,
        "shape": f"Q3 level: int32[{n_shards}, 10|8, {WORDS}], C = 80, "
                 "filter",
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


# The crash phase: a small directory of its own on the card
CRASH_SHARDS = 64
CRASH_CLIENTS = 4
CRASH_ACKS = 400           # acknowledged writes before the SIGKILL
CRASH_VALUE_MAX = 1000
# the hours of the crash phase's timestamped Sets
CRASH_STAMPS = ("2019-03-15T06:00", "2019-12-31T23:00", "2020-02-29T12:00",
                "2020-03-15T07:00")
# the row keys of the keyed crash index that exist before the writers
CRASH_ROW_KEYS = ("r0", "r1", "r2", "r3")


def _crash_writer(port: int, k: int, rng, oracle: dict, lock, acked,
                  errors: list) -> None:
    """One client of the crash phase: Set, Clear, /import and import-value
    on columns of its own (col % CRASH_CLIENTS == k), timestamped Sets into
    the YMDH field ``ts``, Sets moving columns of its own between rows
    of the mutex field ``mx`` and keyed Sets on index ``crashk`` (a new
    column key each, an existing or a new row key), each write's effect
    applied to ``oracle`` only once its 200 arrives; the write in flight
    is kept in ``oracle["inflight"][k]``."""
    n_cols = CRASH_SHARDS * WORDS * 32
    mine = oracle["bits"], oracle["vals"]
    own_bits: list = []
    c = Client(port, "crash")

    def fresh(n: int) -> np.ndarray:
        return rng.integers(0, n_cols // CRASH_CLIENTS, n) * CRASH_CLIENTS + k

    mx_cols = np.unique(fresh(16)).tolist()  # moved between mutex rows
    j = 0
    while True:
        op = j % 7
        j += 1
        if op == 0:
            r, col = int(rng.integers(0, 4)), int(fresh(1)[0])
            path, body = "/index/crash/query", f"Set({col}, f={r})".encode()
            effect = [("set", r, col)]
        elif op == 1 and own_bits:
            r, col = own_bits.pop(int(rng.integers(0, len(own_bits))))
            path, body = "/index/crash/query", f"Clear({col}, f={r})".encode()
            effect = [("clear", r, col)]
        elif op == 3:
            cols = np.unique(fresh(16))
            vals = rng.integers(0, CRASH_VALUE_MAX + 1, cols.size)
            path = "/index/crash/field/v/import-value"
            body = json.dumps({"columns": cols.tolist(),
                               "values": vals.tolist()}).encode()
            effect = [("val", int(v), int(col)) for col, v in zip(cols, vals)]
        elif op == 4:
            r, col = int(rng.integers(0, 4)), int(fresh(1)[0])
            stamp = CRASH_STAMPS[int(rng.integers(0, len(CRASH_STAMPS)))]
            path = "/index/crash/query"
            body = f"Set({col}, ts={r}, timestamp='{stamp}')".encode()
            effect = [("tset", (r, stamp), col)]
        elif op == 5:
            r = int(rng.integers(0, 4))
            col = mx_cols[int(rng.integers(0, len(mx_cols)))]
            path, body = "/index/crash/query", f"Set({col}, mx={r})".encode()
            effect = [("mset", r, col)]
        elif op == 6:
            ck = f"w{k}-c{j}"
            rk = (CRASH_ROW_KEYS[int(rng.integers(0, len(CRASH_ROW_KEYS)))]
                  if rng.random() < 0.5 else f"w{k}-r{j}")
            path = "/index/crashk/query"
            body = f'Set("{ck}", kf="{rk}")'.encode()
            effect = [("kset", rk, ck)]
        else:
            cols = np.unique(fresh(32))
            rows = rng.integers(0, 4, cols.size)
            path = "/index/crash/field/f/import"
            body = json.dumps({"rows": rows.tolist(),
                               "columns": cols.tolist()}).encode()
            effect = [("set", int(r), int(col)) for r, col in zip(rows, cols)]
        with lock:
            oracle["inflight"][k] = effect
        try:
            status, resp = c.post(path, body)
        except (OSError, http.client.HTTPException):
            return  # the SIGKILL landed mid-request: this write is in flight
        if status != 200:
            with lock:
                errors.append((path, status, resp[:200]))
                lock.notify_all()
            return
        with lock:
            for kind, a, col in effect:
                if kind == "set":
                    mine[0][a].add(col)
                    own_bits.append((a, col))
                elif kind == "clear":
                    mine[0][a].discard(col)
                elif kind == "tset":
                    oracle["tsets"].add((a[0], a[1], col))
                elif kind == "mset":
                    oracle["mx"][col] = a
                elif kind == "kset":
                    oracle["keyed"].setdefault(a, set()).add(col)
                else:
                    mine[1][col] = a
            oracle["inflight"][k] = []
            acked[0] += 1
            lock.notify_all()


def run_crash_phase(scratch: Path, seed: int, kernels) -> dict:
    """A port server process on the card, 4 HTTP clients writing (Set,
    Clear, /import, import-value), SIGKILLed after CRASH_ACKS
    acknowledged writes; a port Holder reopens the directory on the card
    and every acknowledged write must read back, every Count equal the
    numpy oracle, and the WAL be empty after the open."""
    from pilosa_tpu_torch.executor import Executor, result_to_json
    from pilosa_tpu_torch.storage import Holder

    data = scratch / "crash"
    log = open(scratch / "crash-server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "-d", str(data),
         "-b", "127.0.0.1", "--port", "0"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=log, text=True)
    stats: dict = {}
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()  # printed once the server serves
        if "serving" not in line:
            fail(f"the crash phase's server did not start: {line!r}")
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        stats["server_start_s"] = time.perf_counter() - t0
        c = Client(port, "crash")
        for path, body in (("/index/crash", b"{}"),
                           ("/index/crash/field/f", b"{}"),
                           ("/index/crash/field/v", json.dumps(
                               {"options": {"type": "int", "min": 0,
                                            "max": CRASH_VALUE_MAX}}
                           ).encode()),
                           ("/index/crash/field/ts", json.dumps(
                               {"options": {"type": "time",
                                            "timeQuantum": "YMDH"}}
                           ).encode()),
                           ("/index/crash/field/mx", json.dumps(
                               {"options": {"type": "mutex"}}).encode()),
                           ("/index/crashk", json.dumps(
                               {"options": {"keys": True}}).encode()),
                           ("/index/crashk/field/kf", json.dumps(
                               {"options": {"keys": True}}).encode())):
            status, resp = c.post(path, body)
            if status != 200:
                fail(f"crash phase: {path} answered {status} {resp!r}")
        # a bit in every shard, then reads, so that the writes below patch
        # resident leaves over all the shards
        first = np.arange(CRASH_SHARDS) * WORDS * 32 + WORDS * 32 - 1
        status, resp = c.post("/index/crash/field/f/import", json.dumps(
            {"rows": [0] * CRASH_SHARDS, "columns": first.tolist()}).encode())
        if status != 200:
            fail(f"crash phase: the first import answered {status} {resp!r}")
        oracle = {"bits": {r: set() for r in range(4)}, "vals": {},
                  "tsets": set(), "mx": {},
                  "keyed": {rk: {"seed"} for rk in CRASH_ROW_KEYS},
                  "inflight": {k: [] for k in range(CRASH_CLIENTS)}}
        oracle["bits"][0].update(first.tolist())
        c.index = "crashk"
        c.query(" ".join(f'Set("seed", kf="{rk}")' for rk in CRASH_ROW_KEYS))
        c.index = "crash"
        for pql in ("Count(Row(f=0))", "Count(Row(f=1))",
                    "Count(Intersect(Row(f=2), Row(f=3)))"):
            c.query(pql)
        c.close()
        lock = threading.Condition()
        acked, errors = [0], []
        threads = [threading.Thread(target=_crash_writer, args=(
            port, k, np.random.default_rng([seed, k]), oracle, lock, acked,
            errors))
            for k in range(CRASH_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        with lock:
            lock.wait_for(lambda: acked[0] >= CRASH_ACKS or errors,
                          timeout=300)
        proc.kill()  # SIGKILL: no close, no snapshot, no cache save
        proc.wait(60)
        stats["write_s"] = time.perf_counter() - t0
        for t in threads:
            t.join(60)
        if errors or acked[0] < CRASH_ACKS:
            fail(f"crash phase writes failed or stalled at {acked[0]} acks: "
                 f"{errors[:3]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        log.close()
    stats["acked_writes"] = acked[0]
    inflight = [e for effects in oracle["inflight"].values() for e in effects]
    stats["inflight_effects"] = len(inflight)

    t0 = time.perf_counter()
    holder = Holder(str(data)).open()
    stats["reopen_s"] = time.perf_counter() - t0
    try:
        stats["recovered_ops"] = holder.wal.metrics()["recovered_ops_total"]
        wal_dir = data / ".wal"
        left = sum((wal_dir / f).stat().st_size for f in os.listdir(wal_dir))
        if left or stats["recovered_ops"] <= 0:
            fail(f"crash phase: {stats['recovered_ops']} ops recovered, "
                 f"{left} bytes left in .wal after the open")
        fld, vfld = holder.index("crash").field("f"), \
            holder.index("crash").field("v")
        bits = {r: set(cols) for r, cols in oracle["bits"].items()}
        vals = dict(oracle["vals"])
        # an in-flight write may have landed in part (its ops ride WAL
        # groups shard by shard): take what its columns hold
        for kind, a, col in inflight:
            if kind == "val":
                got, there = vfld.value(col)
                if there:
                    vals[col] = got
            elif kind in ("tset", "mset", "kset"):
                continue  # held against the time views, rows and keys below
            elif fld.view("standard").fragment(col >> 20) is not None and \
                    fld.view("standard").fragment(col >> 20).contains(
                        a, col & (WORDS * 32 - 1)):
                bits[a].add(col)
            else:
                bits[a].discard(col)
        ex = Executor(holder)
        _check_crash_time_mutex(holder, ex, oracle, inflight)
        stats.update(_check_crash_keys(holder, ex, oracle, inflight))
        stats["timestamped_sets"] = len(oracle["tsets"])
        stats["mutex_columns"] = len(oracle["mx"])
        for r in range(4):
            got = result_to_json(ex.execute("crash", f"Row(f={r})"))[0]
            if got["columns"] != sorted(bits[r]):
                lost = sorted(bits[r] - set(got["columns"]))[:5]
                fail(f"crash phase: Row(f={r}) lost acknowledged writes "
                     f"{lost} or holds others")
            count = ex.execute("crash", f"Count(Row(f={r}))")[0]
            if count != len(bits[r]):
                fail(f"crash phase: Count(Row(f={r})) = {count}, oracle "
                     f"{len(bits[r])}")
        for col, v in vals.items():
            if vfld.value(col) != (v, True):
                fail(f"crash phase: column {col} reads {vfld.value(col)}, "
                     f"acknowledged {v}")
        want = {"value": sum(vals.values()), "count": len(vals)}
        got = result_to_json(ex.execute("crash", 'Sum(field="v")'))[0]
        if got != want:
            fail(f"crash phase: Sum(field=\"v\") = {got}, oracle {want}")
        half = CRASH_VALUE_MAX // 2
        n = ex.execute("crash", f"Count(Range(v > {half}))")[0]
        want_n = sum(v > half for v in vals.values())
        if n != want_n:
            fail(f"crash phase: Count(Range(v > {half})) = {n}, oracle "
                 f"{want_n}")
        stats["bits"] = sum(len(b) for b in bits.values())
        stats["values"] = len(vals)
    finally:
        holder.close()
    return stats


def _check_crash_keys(holder, ex, oracle: dict, inflight: list) -> dict:
    """After the crash phase's replay: every acknowledged keyed Set reads
    back under its own row key and column key, and no key holds a column
    that no client sent for it (an in-flight Set may have landed): every
    row with a bit has a key, every column of a row a key, and the row's
    keys are the acknowledged ones, plus in-flight ones at most."""
    from pilosa_tpu_torch.executor import result_to_json
    from pilosa_tpu_torch.storage.translate import row_namespace

    sent = {rk: set(cks) for rk, cks in oracle["keyed"].items()}
    for kind, rk, ck in inflight:
        if kind == "kset":
            sent.setdefault(rk, set()).add(ck)
    view = holder.index("crashk").field("kf").view("standard")
    row_ids = sorted({r for frag in view.fragments.values()
                      for r in frag.row_ids()})
    row_keys = holder.translate.keys_of(row_namespace("crashk", "kf"),
                                        row_ids)
    if None in row_keys or not set(row_keys) <= set(sent):
        fail(f"crash phase: keyed rows {row_ids[:5]} read back under keys "
             f"{row_keys[:5]}, not ones a client sent")
    for rk in sorted(set(row_keys) | set(oracle["keyed"])):
        got = result_to_json(ex.execute("crashk", f'Row(kf="{rk}")'))[0]
        n = ex.execute("crashk", f'Count(Row(kf="{rk}"))')[0]
        have = set(got["keys"])
        lost = oracle["keyed"].get(rk, set()) - have
        if lost or not have <= sent[rk] or n != len(got["keys"]):
            fail(f"crash phase: Row(kf=\"{rk}\") holds {sorted(have)[:5]} "
                 f"({n} columns), lost acknowledged {sorted(lost)[:5]}")
    return {"keyed_sets": sum(len(v) for v in oracle["keyed"].values())
            - len(CRASH_ROW_KEYS),
            "keyed_row_keys": len(row_keys)}


def _holds(field, view: str, row: int, col: int) -> bool:
    v = field.view(view)
    frag = v.fragment(col >> 20) if v is not None else None
    return frag is not None and frag.contains(row, col & (WORDS * 32 - 1))


def _check_crash_time_mutex(holder, ex, oracle: dict, inflight: list
                            ) -> None:
    """After the crash phase's replay: every acknowledged timestamped Set
    in the standard view and in each of its Y, M, D and H views, the time
    windows' Counts equal to the acknowledged bits (an in-flight Set
    counted where its Y view holds it: a request's records are durable
    in the order written), and the mutex field's rows disjoint and as the
    acknowledged Sets left them (an in-flight Set's column in its old row
    or its new one)."""
    from pilosa_tpu_torch.executor import result_to_json
    from pilosa_tpu_torch.storage.view import views_for_time

    ts, mx = holder.index("crash").field("ts"), \
        holder.index("crash").field("mx")
    want = {r: set() for r in range(4)}
    for r, stamp, col in oracle["tsets"]:
        views = ["standard"] + views_for_time(
            "standard", "YMDH", dt.datetime.fromisoformat(stamp))
        lost = [v for v in views if not _holds(ts, v, r, col)]
        if lost:
            fail(f"crash phase: the acknowledged Set({col}, ts={r}, "
                 f"timestamp='{stamp}') is missing from {lost}")
        want[r].add(col)
    for kind, a, col in inflight:
        if kind == "tset" and _holds(ts, views_for_time(
                "standard", "Y", dt.datetime.fromisoformat(a[1]))[0], a[0],
                col):
            want[a[0]].add(col)
    for r in range(4):
        got = ex.execute("crash", f"Count(Row(ts={r}, from='2019-01-01', "
                                  "to='2021-01-01'))")[0]
        if got != len(want[r]):
            fail(f"crash phase: Count(Row(ts={r}, <2019-2020>)) = {got}, "
                 f"acknowledged {len(want[r])}")
    rows = {r: set(result_to_json(ex.execute("crash", f"Row(mx={r})"))[0][
        "columns"]) for r in range(4)}
    for r, s in itertools.combinations(range(4), 2):
        if rows[r] & rows[s]:
            fail(f"crash phase: mutex rows {r} and {s} share columns "
                 f"{sorted(rows[r] & rows[s])[:5]}")
    moving = {col: a for kind, a, col in inflight if kind == "mset"}
    for col, r in oracle["mx"].items():
        ok = {r, moving[col]} if col in moving else {r}
        if not any(col in rows[x] for x in ok):
            fail(f"crash phase: the acknowledged Set({col}, mx={r}) reads "
                 f"back in no row of {sorted(ok)}")
    owned = set(oracle["mx"]) | set(moving)
    stray = set().union(*rows.values()) - owned
    if stray:
        fail(f"crash phase: mutex columns {sorted(stray)[:5]} were never "
             "written")


def run_main_paths(data_dir: str, words: dict, rides: dict, oracle: dict,
                   taxi: dict, events: dict, users: dict, wire: dict,
                   months: dict, mesh: dict, rng, kernels,
                   verify_on_load: bool) -> dict:
    """Phase 4 through one server: the Star-Trace path, the rides path,
    the taxi path, the serving-envelope path, the time path, the keys
    path, the wire path, the mesh path and the tier path (last: it lowers
    the residency budget), each with the
    launch counters zeroed just before it and read just after. Returns
    {path: (numbers, launches)}."""
    from pilosa_tpu_torch.server import Server

    # verify-on-load (the port's default) digests every bit id of the
    # 1B-column dirs, ~21e9 of them: minutes of set-up that no kernel
    # runs in, so unless asked this server opens without it and a sample
    # of the heaviest view is verified and timed instead
    t0 = time.perf_counter()
    server = Server(data_dir, bind="127.0.0.1", port=0,
                    budget_bytes=SERVER_BUDGET_BYTES,
                    residency_host_tier_bytes=TIER_HOST_BYTES,
                    verify_on_load=verify_on_load).open()
    SETUP_S["open"] = time.perf_counter() - t0
    print(f"server open (verify-on-load {verify_on_load}): "
          f"{SETUP_S['open']:.1f}s", flush=True)
    if not verify_on_load:
        _time_verify_sample(server.holder)
    try:
        out = {}
        for path, serve in (
                ("Star-Trace", lambda: _serve_and_check(server, words, rng)),
                ("rides", lambda: _serve_rides(server, rides, oracle)),
                ("taxi", lambda: _serve_taxi(server, taxi)),
                ("serving", lambda: _serve_envelope(server, words, taxi,
                                                    events, kernels)),
                ("time", lambda: _serve_time(server, events)),
                ("keys", lambda: _serve_keys(
                    server, keys_truth(taxi["keys"], users), taxi["keys"],
                    users)),
                ("wire", lambda: _serve_wire(server, wire, kernels)),
                ("mesh", lambda: _serve_mesh(server, mesh, words, kernels)),
                ("tier", lambda: _serve_tier(server, months, rng))):
            kernels.reset_launches()
            t0 = time.perf_counter()
            stats = serve()
            out[path] = (stats, kernels.launches())
            stats["wal"] = server.holder.wal.metrics()
            if "first_touch_s" in stats:
                SETUP_S[f"first_touch {path}"] = stats["first_touch_s"]
            print(f"path {path}: {time.perf_counter() - t0:.1f}s", flush=True)
        return out
    finally:
        t0 = time.perf_counter()
        server.close()
        SETUP_S["close"] = time.perf_counter() - t0
        print(f"server close (group mode snapshots every dirty fragment): "
              f"{SETUP_S['close']:.1f}s", flush=True)


def _time_verify_sample(holder, n: int = 64) -> None:
    """Verify-on-load's work (read, decode, digest every bit id, compare
    with .checksums) over the first ``n`` fragments of the fare planes,
    in 8 threads as ``View.open`` runs it; prints the rate."""
    from pilosa_tpu_torch.storage.integrity import load_verified

    view = holder.index("rides").field("fare").view("bsig_fare")
    frags = [view.fragments[s] for s in sorted(view.fragments)[:n]]
    n = len(frags)

    def verify(frag) -> int:
        with open(frag.path, "rb") as f:
            bitmap, _ = load_verified(f.read(), frag.path, verify=True)
        return bitmap.count()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        n_ids = sum(pool.map(verify, frags))
    secs = time.perf_counter() - t0
    print(f"verify-on-load sample: {n} bsig_fare fragments, {n_ids} bit ids "
          f"in {secs:.2f}s ({n_ids / secs / 1e6:.1f}M ids/s in 8 threads)",
          flush=True)


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

    # trees past K1/K2's 16 operands and 16 stack slots: the plan cuts
    # them into K2 'tree' steps, whose launches count as tree_rows'
    from pilosa_tpu_torch import kernels

    dense = [(f, r) for f in ("stargazer", "language") for r in range(4)]
    union = [dense[(3 * k) % 8] for k in range(20)]
    nested, acc = f"Row({dense[0][0]}={dense[0][1]})", words[dense[0]]
    for k in range(20):
        f, r = dense[(5 * k + 1) % 8]
        if k % 2:
            nested, acc = f"Difference(Row({f}={r}), {nested})", \
                words[(f, r)] & ~acc
        else:
            nested, acc = f"Union(Row({f}={r}), {nested})", \
                words[(f, r)] | acc
    wide = {
        "Count(Union(" + ", ".join(f"Row({f}={r})" for f, r in union) + "))":
            _count_oracle(words, "or", union),
        f"Count({nested})": int(np.bitwise_count(acc).sum(dtype=np.int64)),
    }
    before = kernels.launches()["tree_rows"]
    for pql, want in wide.items():
        got = c.query(pql)[0]
        if got != want:
            fail(f"{pql[:60]}... = {got}, oracle {want}")
    stats["wide_tree_steps"] = kernels.launches()["tree_rows"] - before
    if stats["wide_tree_steps"] < len(wide):
        fail("the wide trees ran without K2 'tree' steps")

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

    # one bit into each of the 1024 shards of the resident row: one /import,
    # one K3 launch for every resident leaf it touches
    sg0 = sg0.reshape(N_SHARDS, WORDS)
    cols, pick, low = _one_bit_a_shard(sg0)
    body = json.dumps({"rows": [0] * N_SHARDS,
                       "columns": cols.tolist()}).encode()
    before = kernels.launches()["word_patch"]
    t0 = time.perf_counter()
    status, resp = c.post("/index/repository/field/stargazer/import", body)
    stats["import_1024_shards_ms"] = 1e3 * (time.perf_counter() - t0)
    stats["import_1024_shards_k3_launches"] = \
        kernels.launches()["word_patch"] - before
    if status != 200 or json.loads(resp)["changed"] != N_SHARDS:
        fail(f"the 1024-shard import answered {status} {resp!r}")
    if stats["import_1024_shards_k3_launches"] != 1:
        fail(f"the 1024-shard import made "
             f"{stats['import_1024_shards_k3_launches']} word_patch "
             "launches, not 1")
    lang1 = lang1.reshape(N_SHARDS, WORDS)
    gained = int(((lang1[np.arange(N_SHARDS), pick] >> low.astype(np.uint32))
                  & 1).sum())
    if c.query(pql)[0] != truth[pql] + gained:
        fail("Count after the 1024-shard import does not show it")
    if c.query("Count(Row(stargazer=0))")[0] != \
            int(np.bitwise_count(sg0).sum(dtype=np.int64)) + N_SHARDS:
        fail("Count(Row(stargazer=0)) after the 1024-shard import is wrong")
    stats["resident_bytes"] = server.holder.cache.bytes_used
    c.close()
    return stats


def _one_bit_a_shard(sg0: np.ndarray):
    """The Star-Trace path's 1024-shard import: in each shard of
    ``sg0`` [S, W] the lowest clear bit of its first word not all set.
    Returns (columns, word index, bit) a shard."""
    pick = np.argmax(sg0 != np.uint32(0xFFFFFFFF), axis=1)
    free = sg0[np.arange(N_SHARDS), pick]
    low = np.array([int(np.flatnonzero(~np.unpackbits(np.array(
        [w], np.uint32).view(np.uint8), bitorder="little").astype(bool))[0])
        for w in free.tolist()])
    return (np.arange(N_SHARDS) * WORDS + pick) * 32 + low, pick, low


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


def rides_oracle(rides: dict, group: np.ndarray, n_groups: int) -> dict:
    """Every rides answer, from the host words, one chunk of shards at a
    time; also a ride with fare > FARE_THRESHOLDS[1] and no tip (for the
    write check), and the fare sum of each category of ``group`` (one
    uint8 category per ride)."""
    planes, cab1 = rides["fare"], rides["cab"][1]
    group_sums = np.zeros(n_groups, np.int64)
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
        g = group[lo * 32:(lo + chunk) * 32]
        # float64 weights: every chunk's sums stay below 2^53, exact
        group_sums += np.bincount(g[exists], weights=values[exists],
                                  minlength=n_groups).astype(np.int64)
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
    return {"truth": truth, "fare_of": fare_of, "free_col": free_col,
            "group_sums": group_sums}


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
    print(f"tip import ({N_TIPS} values through /import-value, durability "
          f"{server.holder.wal.mode}): {stats['tip_import_s']:.3f}s; with "
          "per-op fsyncs 100 000 of them took 89.249 s on an H100 80GB "
          "HBM3 at 700 W",
          flush=True)
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


# ---------------------------------------------------------------- taxi path


def _category_lut(p) -> np.ndarray:
    """uint8[65536]: the category of each 16-bit draw, category k on about
    p[k] of the draws and on at least one."""
    p = np.asarray(p, float) / sum(p)
    counts = np.maximum(1, np.round(p * 65536).astype(np.int64))
    counts[np.argmax(counts)] += 65536 - int(counts.sum())
    return np.repeat(np.arange(p.size, dtype=np.uint8), counts)


def make_taxi(rng) -> dict:
    """Per-ride categories of the three taxi set fields: uint8[2^30]
    each, ride i in category cat[i] (its row is TAXI_FIELDS' first row +
    cat[i]), drawn with TAXI_FIELDS' skew."""
    n = N_SHARDS * WORDS * 32
    step = 1 << 26
    out = {}
    for field, (_, p) in TAXI_FIELDS.items():
        lut = _category_lut(p)
        cat = np.empty(n, np.uint8)
        for lo in range(0, n, step):
            cat[lo:lo + step] = lut[rng.integers(0, 1 << 16, min(step, n - lo),
                                                 dtype=np.uint16)]
        out[field] = cat
    return out


def category_rows(cat: np.ndarray, n_rows: int) -> dict:
    """{category: uint32 words} of a per-ride category array: each bit of
    the categories packed into a plane, then the rows split out of the
    planes one bit at a time (one AND per prefix), so every ride lands in
    exactly one row."""
    n_bits = max(1, (n_rows - 1).bit_length())
    planes = [np.packbits((cat >> np.uint8(b)) & np.uint8(1),
                          bitorder="little").view("<u4")
              for b in range(n_bits)]
    masks = {0: None}  # prefix of the top bits -> its rides (None: all)
    for b in reversed(range(n_bits)):
        nxt = {}
        for v, m in masks.items():
            for bit in (0, 1):
                w = (v << 1) | bit
                if w << b >= n_rows:
                    continue  # no category below n_rows has this prefix
                p = planes[b] if bit else ~planes[b]
                nxt[w] = p if m is None else m & p
        masks = nxt
    return masks


def _pairs(counts, rows, n: int = 10) -> list:
    """TopN's JSON: (row, count) by count descending, then row."""
    order = sorted((-int(c), int(r)) for r, c in zip(rows, counts) if c > 0)
    return [{"id": r, "count": -c} for c, r in (order[:n] if n else order)]


def _groups(names: list, keys: list, counts, sums=None) -> list:
    """GroupBy's JSON for groups with a count, keys ascending."""
    out = []
    for i, key in enumerate(keys):
        if counts[i] <= 0:
            continue
        g = {"group": [{"field": f, "rowID": int(r)}
                       for f, r in zip(names, key)], "count": int(counts[i])}
        if sums is not None:
            g["sum"] = int(sums[i])
        out.append(g)
    return out


def taxi_oracle(rides: dict, taxi: dict, fare_sums: np.ndarray) -> dict:
    """Every taxi answer from the per-ride categories (np.bincount over
    the combined group key, chunk by chunk), the cab_type words and the
    fare sums per passenger count; also the Set check's ride and row."""
    pc, yr, dist = (taxi[f] for f in TAXI_FIELDS)
    (pc0, pcp), (yr0, yrp), (d0, dp) = TAXI_FIELDS.values()
    n_pc, n_yr, n_d = len(pcp), len(yrp), len(dp)
    groups = np.zeros(n_pc * n_yr * n_d, np.int64)
    pc_cab1 = np.zeros(n_pc, np.int64)
    pay, n_pay = taxi["payment_type"], len(PAYMENT_TYPES)
    pay_pc = np.zeros(n_pay * n_pc, np.int64)
    pay_cab1 = np.zeros(n_pay, np.int64)
    cab = rides["cab"]
    step = 1 << 26
    for lo in range(0, pc.size, step):
        key = (pc[lo:lo + step].astype(np.int32) * n_yr
               + yr[lo:lo + step]) * n_d + dist[lo:lo + step]
        groups += np.bincount(key, minlength=groups.size)
        c1 = np.unpackbits(cab[1][lo // 32:(lo + step) // 32].view(np.uint8),
                           bitorder="little").astype(bool)
        pc_cab1 += np.bincount(pc[lo:lo + step][c1], minlength=n_pc)
        p = pay[lo:lo + step]
        pay_pc += np.bincount(p.astype(np.int32) * n_pc + pc[lo:lo + step],
                              minlength=pay_pc.size)
        pay_cab1 += np.bincount(p[c1], minlength=n_pay)
    g3 = groups.reshape(n_pc, n_yr, n_d)
    by_pc, by_d = g3.sum(axis=(1, 2)), g3.sum(axis=(0, 1))
    q3 = g3.sum(axis=2).reshape(-1)
    cab_rows = sorted(cab)
    cab_n = [int(np.bitwise_count(cab[r]).sum(dtype=np.int64))
             for r in cab_rows]
    cab_02 = [int(np.bitwise_count(np.concatenate(
        [cab[r][:WORDS], cab[r][2 * WORDS:3 * WORDS]])).sum(dtype=np.int64))
        for r in cab_rows]
    pc_rows = [pc0 + k for k in range(n_pc)]
    yr_rows = [yr0 + k for k in range(n_yr)]
    d_rows = [d0 + k for k in range(n_d)]
    having = int(np.median(by_pc))
    q3_keys = [(p, y) for p in pc_rows for y in yr_rows]
    q4_keys = [(p, y, d) for p in pc_rows for y in yr_rows for d in d_rows]
    names = list(TAXI_FIELDS)
    shard3 = np.unpackbits(cab[1][3 * WORDS:4 * WORDS].view(np.uint8),
                           bitorder="little")
    top_d = _pairs(by_d, d_rows, 5)
    set_row = top_d[-1]["id"]  # the fifth distance row gains a ride
    set_col = int(np.flatnonzero(dist[:1 << 20] != set_row - d0)[0])
    truth = {
        "TopN(cab_type)": _pairs(cab_n, cab_rows),
        "GroupBy(Rows(cab_type))": _groups(["cab_type"], [(r,) for r in
                                                          cab_rows], cab_n),
        'GroupBy(Rows(passenger_count), aggregate=Sum(field="fare"))':
            _groups(["passenger_count"], [(r,) for r in pc_rows], by_pc,
                    fare_sums),
        "GroupBy(Rows(passenger_count), Rows(pickup_year))":
            _groups(names[:2], q3_keys, q3),
        "TopN(passenger_count, Row(cab_type=1), n=5)":
            _pairs(pc_cab1, pc_rows, 5),
        "TopN(trip_distance, n=5)": top_d,
        "Rows(passenger_count)": [r for r, c in zip(pc_rows, by_pc) if c],
        "Rows(trip_distance, limit=10)":
            [r for r, c in zip(d_rows, by_d) if c][:10],
        f"GroupBy(Rows(passenger_count), having=Condition(count > {having}))":
            [g for g in _groups(["passenger_count"], [(r,) for r in pc_rows],
                                by_pc) if g["count"] > having],
        "Options(TopN(cab_type), shards=[0, 2])": _pairs(cab_02, cab_rows),
        f"IncludesColumn(Row(cab_type=1), column="
        f"{3 * WORDS * 32 + int(np.flatnonzero(shard3)[0])})": True,
        f"IncludesColumn(Row(cab_type=1), column="
        f"{3 * WORDS * 32 + int(np.flatnonzero(shard3 == 0)[0])})": False,
    }
    q4 = "GroupBy(Rows(passenger_count), Rows(pickup_year), " \
         "Rows(trip_distance))"
    # past K9's 16 dimensions: the first three passenger counts by year,
    # the year repeated 16 times (a ride has one year)
    q17 = ("GroupBy(Rows(passenger_count, limit=3), "
           + ", ".join(["Rows(pickup_year)"] * 16) + ")")
    q17_keys = [(p,) + (y,) * 16 for p in pc_rows[:3] for y in yr_rows]
    q17_counts = [int(q3[(p - pc0) * n_yr + y - yr0]) for p, y, *_ in
                  q17_keys]
    after = groups.copy()
    after[(int(pc[set_col]) * n_yr + int(yr[set_col])) * n_d
          + set_row - d0] += 1
    by_d_after = by_d.copy()
    by_d_after[set_row - d0] += 1
    # the keys path: a CRD ride of the middle shard moves to a new key
    mid = (N_SHARDS // 2) * WORDS * 32
    vod = mid + int(np.flatnonzero(pay[mid:mid + WORDS * 32] == 0)[0])
    keys = {"pay_n": pay_pc.reshape(n_pay, n_pc).sum(axis=1),
            "pay_pc": pay_pc, "pay_cab1": pay_cab1,
            "crd_shard0": np.flatnonzero(pay[:WORDS * 32] == 0),
            "vod_ride": vod, "vod_old": int(pay[vod])}
    return {"truth": truth, "q4": q4, "q17": q17, "keys": keys,
            "q17_truth": _groups(names[:1] + names[1:2] * 16, q17_keys,
                                 q17_counts),
            "q4_truth": _groups(names, q4_keys, groups),
            "q4_after": _groups(names, q4_keys, after),
            "set": f"Set({set_col}, trip_distance={set_row})",
            "topn_after": _pairs(by_d_after, d_rows, 5),
            "q4_groups": int(np.count_nonzero(groups)),
            "avg_fare": {r: float(s) / float(c) for r, s, c in
                         zip(pc_rows, fare_sums, by_pc) if c}}


def build_oracles(rides: dict, taxi: dict) -> tuple[dict, dict]:
    """The rides and the taxi oracles."""
    t0 = time.perf_counter()
    oracle = rides_oracle(rides, taxi["passenger_count"],
                          len(TAXI_FIELDS["passenger_count"][1]))
    truth = taxi_oracle(rides, taxi, oracle["group_sums"])
    print(f"rides and taxi oracles: {time.perf_counter() - t0:.1f}s",
          flush=True)
    return oracle, truth


def _serve_taxi(server, oracle: dict) -> dict:
    """Phase 4c: the taxi queries through the server; returns its
    numbers."""
    stats = {}
    truth = oracle["truth"]
    c = Client(server.port, "rides")
    t0 = time.perf_counter()
    for pql, want in truth.items():  # first touch: matrices decoded
        got = c.query(pql)[0]
        if got != want:
            fail(f"{pql} = {str(got)[:300]}, oracle {str(want)[:300]}")
    stats["first_touch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if c.query(oracle["q4"])[0] != oracle["q4_truth"]:
        fail(f"{oracle['q4']} differs from the oracle")
    stats["q4_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.query(oracle["q4"])
    stats["q4_warm_s"] = time.perf_counter() - t0
    stats["q4_groups"] = oracle["q4_groups"]
    t0 = time.perf_counter()
    if c.query(oracle["q17"])[0] != oracle["q17_truth"]:
        fail("GroupBy over 17 dimensions differs from the oracle")
    stats["groupby_17_dims_s"] = time.perf_counter() - t0

    # a write the resident matrices must show (K3's row form)
    if c.query(oracle["set"]) != [True]:
        fail(f"{oracle['set']} changed nothing")
    if c.query("TopN(trip_distance, n=5)")[0] != oracle["topn_after"]:
        fail("TopN(trip_distance) after the Set differs from the oracle")
    if c.query(oracle["q4"])[0] != oracle["q4_after"]:
        fail(f"{oracle['q4']} after the Set differs from the oracle")

    shapes = ["TopN(cab_type)", "GroupBy(Rows(cab_type))",
              'GroupBy(Rows(passenger_count), aggregate=Sum(field="fare"))',
              "GroupBy(Rows(passenger_count), Rows(pickup_year))",
              "TopN(passenger_count, Row(cab_type=1), n=5)"]
    n_clients, per_client = 16, 20
    per_shape: dict = {}
    latencies, wall = closed_loop(server.port, "rides", shapes, truth,
                                  n_clients, per_client, per_shape)
    stats.update(_latency_stats(latencies, wall), clients=n_clients,
                 resident_bytes=server.holder.cache.bytes_used)
    stats["p50_ms_by_shape"] = {
        pql: 1e3 * sorted(lat)[len(lat) // 2] for pql, lat in per_shape.items()}
    stats["avg_fare_cents_by_passenger_count"] = oracle["avg_fare"]
    c.close()
    return stats


def _latency_stats(latencies: list, wall: float) -> dict:
    lat = sorted(latencies)
    return {"qps": len(lat) / wall, "queries": len(lat),
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(0.99 * (len(lat) - 1))]}


def closed_loop(port: int, index: str, shapes: list, truth: dict,
                n_clients: int, per_client: int, per_shape=None,
                stride: int = 1) -> tuple[list, float]:
    """``n_clients`` keep-alive clients, each sending ``per_client``
    queries back to back over ``shapes`` (PQL on ``index``, or (index,
    PQL) pairs), client k from shape k x ``stride`` on; every answer is
    held against ``truth``. Returns (latencies in s, wall s);
    ``per_shape``, a dict, also gets each shape's latencies."""
    errors: list = []
    latencies: list = []
    lock = threading.Lock()

    def client(k: int) -> None:
        conns: dict = {}
        try:
            for j in range(per_client):
                shape = shapes[(k * stride + j) % len(shapes)]
                name, pql = shape if isinstance(shape, tuple) else (index,
                                                                    shape)
                cl = conns.get(name) or conns.setdefault(name,
                                                         Client(port, name))
                t = time.perf_counter()
                got = cl.query(pql)[0]
                dt = time.perf_counter() - t
                with lock:
                    latencies.append(dt)
                    if per_shape is not None:
                        per_shape.setdefault(pql, []).append(dt)
                    if got != truth[pql]:
                        errors.append((pql, got))
        finally:
            for cl in conns.values():
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


# ------------------------------------------------------ serving envelope

ENVELOPE_CLIENTS = 16
# cut from 10 s, 3 s and 3 s to hold the run under 1 100 s, then from
# 5 s and 2 s to pay for the multi-process serving step
ENVELOPE_LOOP_S = 3.0     # each of the pipeline and the direct loops
TENANT_LOOP_S = 1.0       # two tenants against the per-tenant gate
TRACE_LEAD_S = 0.5        # the load's start before a trace-device capture
TENANT_INFLIGHT = 2       # qos-tenant-inflight of that loop
ENVELOPE_ROW = 20         # a stargazer row of known bits for PROFILE
ENVELOPE_ROW_BITS = 4096
ENVELOPE_FAMILIES = (
    "pilosa_tpu_serving_waves_total",
    "pilosa_tpu_serving_deduped_requests_total",
    "pilosa_tpu_qos_admitted_total", "pilosa_tpu_qos_shed_total",
    "pilosa_tpu_qos_deadline_expired_total",
    "pilosa_tpu_result_cache_hits_total",
    "pilosa_tpu_result_cache_invalidations_total",
    "pilosa_tpu_tenant_queries_total", "pilosa_tpu_slo_burn_rate",
    "pilosa_tpu_tracing_sampled_traces_total", "pilosa_tpu_heat_shard",
    "pilosa_tpu_slow_queries_total", "pilosa_tpu_query_seconds")


def star_trace_after(words: dict) -> dict:
    """The Star-Trace rows as the Star-Trace path leaves them: its one
    /import set a bit in each shard of stargazer row 0 (its Set was
    cleared again; its sparse rows are not counted here)."""
    out = dict(words)
    sg0 = words[("stargazer", 0)].reshape(N_SHARDS, WORDS).copy()
    cols, _, _ = _one_bit_a_shard(sg0)
    _set_bits(sg0.reshape(-1), cols)
    out[("stargazer", 0)] = sg0.reshape(-1)
    return out


def _envelope_shapes(words: dict) -> tuple[list, dict]:
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
    return ([pql for pql, _, _ in shapes],
            {pql: _count_oracle(words, op, leaves)
             for pql, op, leaves in shapes})


def _wave_loop(server, shapes: list, truth: dict, kernels) -> dict:
    """The closed loop of ``ENVELOPE_CLIENTS`` for ``ENVELOPE_LOOP_S``
    with its wave counters and K1 launches."""
    ex = server.api.executor
    before = server.api.pipeline_metrics()
    k1 = kernels.launches()["tree_count"]
    memo0 = (ex.memo_hits, ex.memo_misses)
    latencies = timed_loop(server.port, "repository", shapes, truth,
                           ENVELOPE_CLIENTS, ENVELOPE_LOOP_S)
    after = server.api.pipeline_metrics()
    out = _latency_stats(latencies, ENVELOPE_LOOP_S)
    out.update({k: after[k] - before[k] for k in after})
    # the operand memo's answers among the Counts that reached the
    # executor (deduped wavemates did not)
    out["memo_hits"] = ex.memo_hits - memo0[0]
    out["memo_misses"] = ex.memo_misses - memo0[1]
    out["memo_hits_per_query"] = out["memo_hits"] / out["queries"]
    out["memo_misses_per_query"] = out["memo_misses"] / out["queries"]
    launches = kernels.launches()["tree_count"] - k1
    if not launches:
        fail(f"{out['queries']} served Counts made no K1 launch")
    out["k1_launches"] = launches
    out["k1_launches_per_query"] = launches / out["queries"]
    # the Counts that reached the executor (deduped wavemates did not)
    out["mean_batch"] = (out["queries"] - out["deduped"]) / max(launches, 1)
    return out


def _query_json(port: int, pql: str, path: str = "/index/repository/query",
                headers: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=pql.encode(), headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def _tenant_loop(port: int, shapes: list, truth: dict) -> dict:
    """Half the clients as tenant alpha, half as beta, closed loop for
    ``TENANT_LOOP_S``: every 200 against the oracle, every 429 with a
    Retry-After."""
    errors, lock = [], threading.Lock()
    counts = {"ok": 0, "shed": 0}
    stop = time.perf_counter() + TENANT_LOOP_S

    def client(k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        headers = {"X-Pilosa-Tenant": "alpha" if k % 2 else "beta"}
        try:
            j = k
            while time.perf_counter() < stop:
                pql = shapes[j % len(shapes)]
                conn.request("POST", "/index/repository/query",
                             body=pql.encode(), headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                with lock:
                    if resp.status == 200:
                        counts["ok"] += 1
                        if json.loads(body)["results"][0] != truth[pql]:
                            errors.append((pql, body[:100]))
                    elif (resp.status == 429
                          and resp.getheader("Retry-After") == "1"):
                        counts["shed"] += 1
                    else:
                        errors.append((pql, resp.status, body[:200]))
                j += 1
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(ENVELOPE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail("a tenant client hung")
    if errors or not counts["ok"] or not counts["shed"]:
        fail(f"tenant loop: {counts}, errors {errors[:3]}")
    return counts


def _deadline_504(server, q4: str, want, events: dict) -> dict:
    """A 1 ms budget on taxi query 4 (a pruned GroupBy) queued in the
    wave behind a Count whose leaf is cold on ``events`` (the time path
    runs later): that Count's submit decodes and uploads the leaf of
    1024 shards on the dispatcher, so the GroupBy's budget runs out
    before its dispatch and the executor refuses it, 504. The Count
    answers the oracle; then query 4 without a budget answers it."""
    port = server.port
    for attempt, row in enumerate((0, 1, 2, 3), 1):
        pql = f"Count(Row(kind={row}))"
        first: list = []
        t = threading.Thread(target=lambda: first.append(_query_json(
            port, pql, "/index/events/query")))
        t.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 60 and not any(
                q["pql"] == pql and q["stage"] == "pipeline.wave"
                for q in _get_json(port, "/debug/queries")["queries"]):
            time.sleep(0.001)
        status, _, body = _query_json(port, q4, "/index/rides/query",
                                      {"X-Pilosa-Deadline-Ms": "1"})
        t.join(timeout=600)
        if (not first or first[0][0] != 200 or json.loads(first[0][2])[
                "results"][0] != _popcount(events["kind"][row])):
            fail(f"{pql} on events differs from the oracle")
        if status == 504:
            status2, _, body2 = _query_json(port, q4, "/index/rides/query")
            if status2 != 200 or json.loads(body2)["results"][0] != want:
                fail(f"{q4} after the 504 differs from the oracle")
            return {"deadline_status": 504, "deadline_attempts": attempt,
                    "deadline_body": json.loads(body)["error"]}
    fail(f"a 1 ms deadline on {q4} answered {status}, not 504")


def _trace_under_load(server, shapes: list, truth: dict) -> dict:
    """``POST /debug/trace-device?secs=1`` while 16 clients load the
    server, asked once; the Chrome trace's kernel events counted by name.
    The clients start TRACE_LEAD_S before the request and stop once it
    has answered, so the whole of the capture's window sees launches
    however long the profiler takes to start recording (a fixed-length
    load could end before a slow start, and the capture then recorded no
    kernel: ``scripts/trace_probe.py --window``)."""
    box: dict = {}
    done = threading.Event()
    load = threading.Thread(target=lambda: box.update(lat=timed_loop(
        server.port, "repository", shapes, truth, ENVELOPE_CLIENTS, 600.0,
        until=done)))
    load.start()
    time.sleep(TRACE_LEAD_S)
    try:
        status, _, body = _query_json(server.port, "",
                                      "/debug/trace-device?secs=1")
    finally:
        done.set()
        load.join(timeout=600)
    if status != 200:
        fail(f"trace-device answered {status}: {body[:300]!r}")
    out = json.loads(body)
    files = sorted(Path(out["logDir"]).glob("*.json"))
    if len(files) != 1:
        fail(f"trace-device wrote {len(files)} files to {out['logDir']}")
    size = files[0].stat().st_size
    events = json.loads(files[0].read_text())["traceEvents"]
    files[0].unlink()
    kernels_seen: dict = {}
    cats: dict = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        if e.get("cat") == "kernel":
            # "void (anonymous namespace)::tree_count_form_kernel<...>(...)"
            name = e.get("name", "").removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("<")[0].split("(")[0]
            kernels_seen[name] = kernels_seen.get(name, 0) + 1
    k1 = sum(n for name, n in kernels_seen.items() if "tree_count" in name)
    if not k1:
        fail(f"the device trace holds no tree_count kernel: "
             f"{sorted(kernels_seen)[:8]}; events by category {cats}")
    return {"trace_seconds": out["seconds"], "trace_bytes": size,
            "trace_events": len(events), "trace_kernel_events": kernels_seen,
            "trace_load_queries": len(box.get("lat", []))}


def _serve_envelope(server, words: dict, taxi: dict, events: dict,
                    kernels) -> dict:
    """Phase 4h: the serving envelope on ``repository`` (see the module
    docstring); returns its numbers."""
    from pilosa_tpu_torch.qos import ServingQos, SLOEngine
    from pilosa_tpu_torch.serving.rescache import global_result_cache
    from pilosa_tpu_torch.utils.stats import global_stats
    from pilosa_tpu_torch.utils.tracing import global_tracer

    api = server.api
    api.slo = SLOEngine.from_config(
        ["reads:latency:100ms:0.99", "avail:errors:0.999"], ["10s", "60s"])
    st = star_trace_after(words)
    shapes, truth = _envelope_shapes(st)
    stats: dict = {}

    steps = stats["step_s"] = {}
    t_step = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 3)
        t_step[0] = now

    # (a) the pipeline wave against each request on its own thread
    stats["pipeline"] = _wave_loop(server, shapes, truth, kernels)
    api.serve_pipelined = False
    try:
        stats["direct"] = _wave_loop(server, shapes, truth, kernels)
    finally:
        api.serve_pipelined = True
    for name in ("pipeline", "direct"):
        loop = stats[name]
        print(f"serving {name}: {loop['qps']:.3f} QPS, p50 "
              f"{loop['p50_ms']:.3f} ms; a served Count: "
              f"{loop['memo_hits_per_query']:.3f} operand-memo hits, "
              f"{loop['memo_misses_per_query']:.3f} misses, "
              f"{loop['k1_launches_per_query']:.3f} K1 launches", flush=True)
    if not stats["direct"]["memo_hits"]:
        fail(f"the direct loop's {stats['direct']['queries']} Counts made "
             "no operand-memo hit")
    step("loops")

    # (c) PROFILE trees of a Count and of a Row of known bits
    c = Client(server.port)
    rng = np.random.default_rng(ENVELOPE_ROW)
    # in the first 16 shards: one /import of few fragments (the Row's
    # block still spans all 1024)
    row_cols = np.sort(rng.choice(min(16, N_SHARDS) * WORDS * 32,
                                  ENVELOPE_ROW_BITS, replace=False))
    body = json.dumps({"rows": [ENVELOPE_ROW] * row_cols.size,
                       "columns": row_cols.tolist()}).encode()
    if c.post("/index/repository/field/stargazer/import", body)[0] != 200:
        fail("the PROFILE row's import failed")
    count_pql = shapes[0]
    status, body = c.post("/index/repository/query?profile=true",
                          count_pql.encode())
    prof = json.loads(body)
    call = prof["profile"]["calls"][0]
    if (status != 200 or prof["results"][0] != truth[count_pql]
            or call["dispatches"] < 1 or call["shards"] != N_SHARDS
            or prof["profile"]["totals"]["shards"] != N_SHARDS
            or {leaf["field"] for leaf in call.get("leaves", ())}
            != {"stargazer", "language"}):
        fail(f"PROFILE of {count_pql}: {str(prof)[:400]}")
    status, body = c.post("/index/repository/query?profile=true",
                          f"Row(stargazer={ENVELOPE_ROW})".encode())
    rprof = json.loads(body)
    rcall = rprof["profile"]["calls"][0]
    if (status != 200 or rprof["results"][0]["columns"] != row_cols.tolist()
            or rcall["rowsMaterialized"] != ENVELOPE_ROW_BITS
            or rcall["shards"] != N_SHARDS or rcall["dispatches"] < 1):
        fail(f"PROFILE of Row(stargazer={ENVELOPE_ROW}): "
             f"{str(rprof['profile'])[:400]}")
    stats["profile_count"] = {k: call[k] for k in (
        "wallMs", "deviceMs", "dispatches", "maxDispatchBatch", "shards",
        "rowCacheHits", "rowCacheMisses", "bytesMoved")}
    stats["profile_row"] = {k: rcall[k] for k in (
        "wallMs", "deviceMs", "dispatches", "shards", "rowsMaterialized",
        "bytesMoved")}

    step("profile")

    # (b) the result cache: hits, then three writes into a counted row
    cache = global_result_cache()
    cache.configure(64 << 20)
    try:
        counted = shapes[0]  # stargazer 0 AND language 1
        want = truth[counted]
        sg0 = st[("stargazer", 0)].reshape(N_SHARDS, WORDS)
        lang1 = words[("language", 1)].reshape(N_SHARDS, WORDS)
        free = lang1 & ~sg0
        picks = []
        for shard in (5, N_SHARDS // 2, N_SHARDS - 7):
            w = int(np.flatnonzero(free[shard])[0])
            bit = int(np.flatnonzero(np.unpackbits(np.array(
                [free[shard, w]], np.uint32).view(np.uint8),
                bitorder="little"))[0])
            picks.append((shard, w * 32 + bit))
        for _ in range(3):
            if c.query(counted)[0] != want:
                fail("a cached Count differs from the oracle")
        hits0 = cache.metrics()["result_cache_hits_total"]
        if hits0 < 2:
            fail(f"repeated Counts made {hits0} result-cache hits")
        from pilosa_tpu_torch.roaring import RoaringBitmap
        from pilosa_tpu_torch.roaring.format import serialize

        bm = RoaringBitmap()
        bm.add_ids(np.array([picks[2][1]], np.uint64))  # row 0: id = pos
        writes = [
            ("set", lambda: c.query(
                f"Set({picks[0][0] * WORDS * 32 + picks[0][1]}, "
                "stargazer=0)") == [True]),
            ("import", lambda: c.post(
                "/index/repository/field/stargazer/import", json.dumps(
                    {"rows": [0], "columns": [picks[1][0] * WORDS * 32
                                              + picks[1][1]]}).encode())[0]
                == 200),
            ("import_roaring", lambda: c.post(
                "/index/repository/field/stargazer/import-roaring/"
                f"{picks[2][0]}", serialize(bm))[0] == 200),
        ]
        k3_before = kernels.launches()["word_patch"]
        for name, write in writes:
            if not write():
                fail(f"the result-cache {name} write failed")
            want += 1
            for _ in range(2):  # the write's answer, then a hit of it
                got = c.query(counted)[0]
                if got != want:
                    fail(f"after the {name}: {counted} answered {got}, the "
                         f"oracle {want} (a stale result-cache hit)")
        # the mesh path reads these rows after this path's writes
        st_after = dict(st)
        sg0_after = st[("stargazer", 0)].copy()
        _set_bits(sg0_after, np.array([shard * WORDS * 32 + pos
                                       for shard, pos in picks]))
        st_after[("stargazer", 0)] = sg0_after
        _, MESH_TRUTH["star"] = _envelope_shapes(st_after)
        if MESH_TRUTH["star"][counted] != want:
            fail("the Star-Trace truth after the serving writes is off")
        MESH_TRUTH["row"] = (f"Row(stargazer={ENVELOPE_ROW})",
                             row_cols.tolist())
        m = cache.metrics()
        stats["rescache"] = {k: m[k] for k in (
            "result_cache_hits_total", "result_cache_misses_total",
            "result_cache_fills_total", "result_cache_invalidations_total",
            "result_cache_fill_races_total", "result_cache_entries")}
        stats["rescache"]["k3_launches"] = \
            kernels.launches()["word_patch"] - k3_before
        if stats["rescache"]["k3_launches"] < len(writes):
            fail(f"the result cache's {len(writes)} writes made "
                 f"{stats['rescache']['k3_launches']} K3 launches")
    finally:
        cache.configure(0)
    # the result cache off, the Count is answered from the operand memo:
    # its leaves are the tensors K3 patched in place for the three writes
    ex = api.executor
    memo0 = ex.memo_hits
    for _ in range(3):
        got = c.query(counted)[0]
        if got != want:
            fail(f"{counted} from the operand memo after the writes: "
                 f"{got}, the oracle {want}")
    stats["memo_after_writes_hits"] = ex.memo_hits - memo0
    if not stats["memo_after_writes_hits"]:
        fail("no Count after the writes was served from the operand memo")
    for shard, col in picks:  # the oracle of the loops below
        _set_bits(st[("stargazer", 0)], [shard * WORDS * 32 + col])
    shapes, truth = _envelope_shapes(st)
    step("rescache")

    # (d) two tenants against the per-tenant gate, then the deadline
    api.qos = ServingQos(tenant_max=TENANT_INFLIGHT, stats=global_stats())
    try:
        stats["tenants"] = _tenant_loop(server.port, shapes, truth)
        stats["tenants"]["qos"] = api.qos.metrics()
    finally:
        api.qos = ServingQos(stats=global_stats())
    stats.update(_deadline_504(server, taxi["q4"], taxi["q4_after"],
                               events))
    if api.qos.metrics()["deadline_expired_total"] != 1:
        fail("the 504 did not count a deadline expiry")
    step("tenants_deadline")

    # (e) a torch.profiler capture with the card's kernels under load
    stats.update(_trace_under_load(server, shapes, truth))
    step("trace")

    # (f) the debug routes and the serving planes' families (a fresh
    # connection: the server closes one idle for 120 s)
    c.close()
    c = Client(server.port)
    global_tracer().sample_rate = 1.0
    try:
        for pql in shapes[:2]:
            if c.query(pql)[0] != truth[pql]:
                fail(f"{pql} under tracing differs from the oracle")
        traces = _get_json(server.port, "/debug/traces")["traces"]
    finally:
        global_tracer().sample_rate = 0.0
    names = set()

    def walk(t):
        names.add(t["name"])
        for ch in t["children"]:
            walk(ch)

    for t in traces:
        walk(t)
    if not {"http.query", "pipeline.wave", "executor.Execute",
            "device.dispatch"} <= names:
        fail(f"/debug/traces spans: {sorted(names)}")
    slo = _get_json(server.port, "/debug/slo")
    vars_ = _get_json(server.port, "/debug/vars")
    live = _get_json(server.port, "/debug/queries")
    for block in ("serving_pipeline", "qos", "result_cache", "tenants",
                  "heat", "slo", "observability"):
        if block not in vars_:
            fail(f"/debug/vars has no {block} block")
    status, _, body = _http(server.port, "GET", "/metrics")
    fams = _metric_families(body.decode())
    missing = [f for f in ENVELOPE_FAMILIES if f not in fams]
    if status != 200 or missing:
        fail(f"/metrics lacks {missing}")
    stats["slo"] = [{"name": o["name"], "windows": o["windows"],
                     "breach": o["breach"]} for o in slo["objectives"]]
    stats["trace_spans"] = sorted(names)
    stats["queries_tracked"] = live["trackedTotal"]
    stats["metrics_families"] = len(fams)
    c.close()
    step("debug_routes")

    # (g) multi-process serving over this server: a column of shard 100
    # (not in the PROFILE row's first 16 shards) whose existence bit
    # stargazer 0 already set
    free_col = 100 * WORDS * 32 + int(np.flatnonzero(np.unpackbits(
        st[("stargazer", 0)].reshape(N_SHARDS, WORDS)[100].view(np.uint8),
        bitorder="little"))[0])
    stats["mp"] = _serve_mp(server, shapes, truth, kernels,
                            ENVELOPE_ROW_BITS, free_col)
    step("mp")
    return stats


# ------------------------------------------------- multi-process serving

MP_WORKERS = 4            # SO_REUSEPORT workers in front of the owner
MP_CLIENT_PROCS = 2       # load-client processes, each with
MP_CLIENTS_PER_PROC = 8   # keep-alive clients of its own
MP_LOOP_S = 3.0           # each of the single-process and workers' loops
MP_KILL_LOAD_S = 2.0      # the load a worker is SIGKILLed under,
MP_KILL_AT_S = 0.5        # this far into it
# ring geometries, largest first: a ring that outgrows /dev/shm dies of
# SIGBUS at its first write, not at its creation
MP_RING_GEOMETRIES = ((1024, 65536), (256, 8192), (64, 4096))


def _ring_geometry() -> tuple[int, int]:
    """The largest of MP_RING_GEOMETRIES whose rings (two a worker) fill
    at most half of /dev/shm's free bytes; prints ``df /dev/shm``."""
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                        text=True, timeout=30)
    print("df /dev/shm: " + " | ".join(df.stdout.strip().splitlines()),
          flush=True)
    free = shutil.disk_usage("/dev/shm").free
    for slots, slot_bytes in MP_RING_GEOMETRIES:
        need = MP_WORKERS * 2 * (64 + slots * (16 + slot_bytes))
        if need <= free // 2:
            print(f"serving rings: {slots} x {slot_bytes} B, {need} B of "
                  f"/dev/shm for {MP_WORKERS} workers ({free} B free)",
                  flush=True)
            return slots, slot_bytes
    fail(f"/dev/shm has {free} B free: too little for {MP_WORKERS} "
         "workers' rings")


def load_client() -> int:
    """A load-client process (``chip_smoke.py --load-client``): reads
    {port, index, shapes, truth, clients, seconds, tolerate} as a JSON
    line on stdin, opens its keep-alive clients, prints ``ready``, waits
    for a ``go`` line, runs them closed-loop for ``seconds`` holding
    every answer against ``truth``, and prints one JSON line: the
    latencies, the wrong answers, the statuses other than 200 and (with
    ``tolerate``) the connections reset under it, which it reopens."""
    cfg = json.loads(sys.stdin.readline())
    lock = threading.Lock()
    out = {"latencies": [], "errors": [], "statuses": {}, "resets": 0}
    conns = [http.client.HTTPConnection("127.0.0.1", cfg["port"],
                                        timeout=600)
             for _ in range(cfg["clients"])]
    for c in conns:
        c.connect()
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    stop = time.perf_counter() + cfg["seconds"]
    path = f"/index/{cfg['index']}/query"

    def client(k: int) -> None:
        c, j = conns[k], k
        while time.perf_counter() < stop:
            pql = cfg["shapes"][j % len(cfg["shapes"])]
            j += 1
            t = time.perf_counter()
            try:
                c.request("POST", path, body=pql.encode())
                resp = c.getresponse()
                body = resp.read()
            except (OSError, http.client.HTTPException):
                if not cfg["tolerate"]:
                    raise
                c.close()
                c = http.client.HTTPConnection("127.0.0.1", cfg["port"],
                                               timeout=600)
                with lock:
                    out["resets"] += 1
                continue
            dt = time.perf_counter() - t
            with lock:
                if resp.status != 200:
                    key = str(resp.status)
                    out["statuses"][key] = out["statuses"].get(key, 0) + 1
                    continue
                out["latencies"].append(dt)
                got = json.loads(body)["results"][0]
                if got != cfg["truth"][pql]:
                    out["errors"].append([pql, got])
        c.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps(out), flush=True)
    return 0


def _process_loop(port: int, shapes: list, truth: dict, seconds: float,
                  tolerate: bool = False, during=None) -> dict:
    """MP_CLIENT_PROCS load-client processes of MP_CLIENTS_PER_PROC
    clients each against ``port`` for ``seconds``, started together once
    every process has its connections open; ``during()`` runs while they
    load. Their results merged; fails on a wrong answer, or (unless
    ``tolerate``) on any status but 200."""
    cfg = json.dumps({"port": port, "index": "repository", "shapes": shapes,
                      "truth": truth, "clients": MP_CLIENTS_PER_PROC,
                      "seconds": seconds, "tolerate": tolerate})
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--load-client"], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(MP_CLIENT_PROCS)]
    merged = {"latencies": [], "errors": [], "statuses": {}, "resets": 0,
              "start_s": 0.0}
    try:
        for p in procs:
            p.stdin.write(cfg + "\n")
            p.stdin.flush()
        t0 = time.perf_counter()
        for p in procs:
            if p.stdout.readline().strip() != "ready":
                fail("a load-client process did not start")
        merged["start_s"] = time.perf_counter() - t0
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        if during is not None:
            during()
        for p in procs:
            line = p.stdout.readline()
            if p.wait(timeout=seconds + 120) != 0 or not line:
                fail(f"a load-client process exited {p.returncode}")
            got = json.loads(line)
            merged["latencies"] += got["latencies"]
            merged["errors"] += got["errors"]
            merged["resets"] += got["resets"]
            for k, n in got["statuses"].items():
                merged["statuses"][k] = merged["statuses"].get(k, 0) + n
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if merged["errors"]:
        fail(f"wrong answers under the process load: {merged['errors'][:3]}")
    if not merged["latencies"] or (merged["statuses"] and not tolerate):
        fail(f"process load on {port}: {len(merged['latencies'])} answers, "
             f"statuses {merged['statuses']}")
    return merged


def _mp_run(server, port: int, shapes: list, truth: dict, kernels,
            runtime=None) -> dict:
    """One MP_LOOP_S process load against ``port``: QPS, p50, p99, K1
    launches and operand-memo hits a served Count, the wave's and (with
    ``runtime``) the owner's counters over it."""
    ex = server.api.executor
    k1 = kernels.launches()["tree_count"]
    memo0 = ex.memo_hits
    wave0 = server.api.pipeline_metrics()
    own0 = runtime.metrics() if runtime is not None else None
    got = _process_loop(port, shapes, truth, MP_LOOP_S)
    out = _latency_stats(got["latencies"], MP_LOOP_S)
    out["clients_start_s"] = got["start_s"]
    wave = server.api.pipeline_metrics()
    out.update({k: wave[k] - wave0[k] for k in wave})
    out["k1_launches_per_query"] = \
        (kernels.launches()["tree_count"] - k1) / out["queries"]
    out["memo_hits_per_query"] = (ex.memo_hits - memo0) / out["queries"]
    if runtime is not None:
        own = runtime.metrics()
        for name, key in (("batches", "serving_owner_batches_total"),
                          ("batched_requests",
                           "serving_owner_batched_requests_total"),
                          ("deduped", "serving_ring_deduped_total"),
                          ("queries_served", "serving_ring_queries_total")):
            out[f"owner_{name}"] = own[key] - own0[key]
        out["ring_rtt_us"] = [(w["id"], w["ringRttP50Us"], w["ringRttP99Us"])
                              for w in runtime.workers_json()]
        if out["owner_queries_served"] != out["queries"]:
            fail(f"the owner served {out['owner_queries_served']} ring "
                 f"queries of {out['queries']} answered")
    if not kernels.launches()["tree_count"] - k1:
        fail(f"{out['queries']} served Counts made no K1 launch")
    return out


def _worker_conns(port: int, n: int) -> dict:
    """A keep-alive connection to each of the ``n`` workers (the kernel
    spreads connections over them), keyed by worker id."""
    by_worker: dict = {}
    for _ in range(64):
        c = Client(port)
        c.conn.request("GET", "/debug/worker")
        resp = c.conn.getresponse()
        wid = json.loads(resp.read())["worker"]
        if wid in by_worker:
            c.close()
        else:
            by_worker[wid] = c
        if len(by_worker) == n:
            return by_worker
    fail(f"64 connections reached workers {sorted(by_worker)} of {n}")


def _serve_mp(server, shapes: list, truth: dict, kernels,
              row_bits: int, free_col: int) -> dict:
    """Phase 4h, last step: multi-process serving on the open server (see
    the module docstring). Returns its numbers."""
    from pilosa_tpu_torch.serving.mpserve import mp_unsupported_reason
    from pilosa_tpu_torch.utils.tracing import global_tracer

    stats: dict = {"cpu_count": os.cpu_count()}
    print(f"serving mp: os.cpu_count() = {stats['cpu_count']}", flush=True)
    steps = stats["step_s"] = {}
    t_step = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 3)
        t_step[0] = now

    reason = mp_unsupported_reason(server)
    if reason is not None:
        fail(f"multi-process serving cannot run here: {reason}")
    slots, slot_bytes = _ring_geometry()
    stats["rings"] = [slots, slot_bytes]
    owner_port = server.port
    # (1) the single-process wave under the client processes
    stats["single"] = _mp_run(server, owner_port, shapes, truth, kernels)
    step("single")
    t0 = time.perf_counter()
    rt = server.start_serving_workers(MP_WORKERS, port=0, ring_slots=slots,
                                      ring_slot_bytes=slot_bytes)
    stats["spawn_s"] = time.perf_counter() - t0
    step("spawn")
    conns: dict = {}
    try:
        if server.port == owner_port or rt.owner_port != owner_port:
            fail("the workers did not take a port of their own")
        # (2) the same load through the workers
        stats["workers"] = _mp_run(server, server.port, shapes, truth,
                                   kernels, rt)
        step("workers")
        for name in ("single", "workers"):
            r = stats[name]
            print(f"serving mp {name}: {r['qps']:.3f} QPS, p50 "
                  f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; a served "
                  f"Count: {r['k1_launches_per_query']:.3f} K1 launches, "
                  f"{r['memo_hits_per_query']:.3f} memo hits; waves "
                  f"{r['waves']}, deduped {r['deduped']}", flush=True)
        w = stats["workers"]
        print(f"serving mp owner: batches {w['owner_batches']}, "
              f"batched_requests {w['owner_batched_requests']}, deduped "
              f"{w['owner_deduped']}, queries_served "
              f"{w['owner_queries_served']}; ring RTT (worker, p50 us, "
              f"p99 us) {w['ring_rtt_us']}", flush=True)
        stats["qps_ratio"] = w["qps"] / stats["single"]["qps"]
        print(f"serving mp: workers/single QPS {stats['qps_ratio']:.3f}",
              flush=True)
        # (3) a Set and a Clear through one worker, read back through the
        # others: a 200 means fsynced
        conns = _worker_conns(server.port, MP_WORKERS)
        ids = sorted(conns)
        k3 = kernels.launches()["word_patch"]
        count = f"Count(Row(stargazer={ENVELOPE_ROW}))"
        for write, want in ((f"Set({free_col}, stargazer={ENVELOPE_ROW})",
                             row_bits + 1),
                            (f"Clear({free_col}, stargazer={ENVELOPE_ROW})",
                             row_bits)):
            if conns[ids[0]].query(write) != [True]:
                fail(f"{write} through worker {ids[0]} was not applied")
            for wid in ids[1:]:
                got = conns[wid].query(count)[0]
                if got != want:
                    fail(f"after {write} through worker {ids[0]}, worker "
                         f"{wid} read {got}, the oracle {want}")
        stats["write_k3_launches"] = kernels.launches()["word_patch"] - k3
        print(f"serving mp writes: Set and Clear through worker {ids[0]} "
              f"read back through workers {ids[1:]} "
              f"({stats['write_k3_launches']} K3 launches)", flush=True)
        for c in conns.values():
            c.close()
        conns = {}
        step("writes")
        # (4) SIGKILL one worker under load: no wrong answer, a respawn
        m0 = rt.metrics()
        victim = rt.workers_json()[0]
        killed = _process_loop(
            server.port, shapes, truth, MP_KILL_LOAD_S, tolerate=True,
            during=lambda: (time.sleep(MP_KILL_AT_S),
                            os.kill(victim["pid"], signal.SIGKILL)))
        step("kill_load")
        if not rt.wait_workers(MP_WORKERS, timeout=30):
            fail("the killed worker was not respawned")
        step("respawn")
        m1 = rt.metrics()
        table = rt.workers_json()
        stats["kill"] = {
            "answers": len(killed["latencies"]), "resets": killed["resets"],
            "statuses": killed["statuses"],
            "respawns": m1["serving_worker_respawns_total"]
            - m0["serving_worker_respawns_total"],
            "reaped": m1["serving_workers_reaped_total"]
            - m0["serving_workers_reaped_total"],
            "dropped_inflight": sum(w["droppedInflight"] for w in table),
            "responses_dropped": m1["serving_responses_dropped_total"]
            - m0["serving_responses_dropped_total"],
            "new_pid": table[0]["pid"] != victim["pid"]}
        if (stats["kill"]["respawns"] != 1 or stats["kill"]["reaped"] < 1
                or not stats["kill"]["new_pid"]):
            fail(f"the kill: {stats['kill']}")
        print(f"serving mp kill: worker {victim['id']} (pid {victim['pid']}) "
              f"SIGKILLed under load: {stats['kill']}", flush=True)
        # (5) the surfaces, and one stitched trace: the workers take the
        # sample rate at their handshake, so the owner restarts its half
        global_tracer().sample_rate = 1.0
        rt.simulate_restart()
        if not rt.wait_workers(MP_WORKERS, timeout=30):
            fail("the workers did not handshake again after the restart")
        step("restart")
        c = Client(server.port)
        try:
            if c.query(shapes[0])[0] != truth[shapes[0]]:
                fail(f"{shapes[0]} through a traced worker is wrong")
        finally:
            c.close()
        tree = None
        for _ in range(200):
            for t in _get_json(server.port, "/debug/traces")["traces"]:
                kids = [k for k in t["children"] if k["name"] == "rpc.query"]
                if t["tags"].get("worker") and kids:
                    tree = t
            if tree is not None:
                break
            time.sleep(0.02)
        global_tracer().sample_rate = 0.0
        if tree is None:
            fail("no stitched worker trace with the owner's rpc.query")
        names: set = set()

        def walk(t):
            names.add(t["name"])
            for ch in t["children"]:
                walk(ch)

        walk(tree)
        stats["trace_spans"] = sorted(names)
        step("trace")
        table = _get_json(server.port, "/debug/workers")
        if (not table["enabled"] or len(table["workers"]) != MP_WORKERS
                or not all(w["alive"] for w in table["workers"])):
            fail(f"/debug/workers: {table}")
        status, _, body = _http(server.port, "GET", "/metrics")
        fams = _metric_families(body.decode())
        missing = [k for k in server.api.mp_metrics()
                   if f"pilosa_tpu_{k}" not in fams]
        if status != 200 or missing or \
                fams["pilosa_tpu_serving_workers"] != MP_WORKERS:
            fail(f"/metrics: serving families missing {missing}")
        stats["metrics"] = {k: v for k, v in fams.items()
                            if k.startswith("pilosa_tpu_serving_")
                            and k[len("pilosa_tpu_"):]
                            in server.api.mp_metrics()}
        print(f"serving mp surfaces: {len(table['workers'])} workers alive, "
              f"trace spans {stats['trace_spans']}", flush=True)
        step("surfaces")
    finally:
        for c in conns.values():
            c.close()
        global_tracer().sample_rate = 0.0
        server.stop_serving_workers()
    step("stop")
    print(f"serving mp steps (s): {steps}", flush=True)
    if server.port != owner_port:
        fail("the server's port did not return to its own listener")
    return stats


# ---------------------------------------------------------------- time path

# BASELINE config 4 (time-quantum YMDH views: multi-view Union + Count over
# a one-year window): index ``events``, a time field ``t`` (quantum YMDH,
# rows 0-3) set at 8 event-hours, each hour setting each column of row r
# with probability 2^-EVENT_ROW_LOG2[r] (1/64, 1/256, 1/1024, 1/4096 of a
# shard), the bit in the standard view and in its Y, M, D and H views as
# a timestamped write puts it; a mutex field ``kind`` (rows 0-3, every
# column in one, KIND_SHARES) and a bool field ``active`` (row 1 on 70% of
# the columns, row 0 on the rest). The cut from a live YMDH deployment: 8
# event-hours, not one an hour (with 16 the command overran its 1200 s on
# a slow host of an H100 80GB HBM3 at 700 W: each event-hour adds up to 4
# views of 1024 fragments to build, open and close). They straddle both
# window edges: 06:00 and 07:00 on 2019-03-15 and on 2020-03-15.
EVENT_HOURS = tuple(dt.datetime.fromisoformat(s) for s in (
    "2019-01-01T00:00", "2019-03-15T06:00", "2019-03-15T07:00",
    "2019-06-01T12:00", "2019-12-31T23:00", "2020-02-29T12:00",
    "2020-03-15T06:00", "2020-03-15T07:00"))
EVENT_ROW_LOG2 = (6, 8, 10, 12)
KIND_SHARES = (0.50, 0.25, 0.15, 0.10)
ACTIVE_SHARES = (0.30, 0.70)
WINDOW_A, WINDOW_B = "2019-03-15T07:00", "2020-03-15T07:00"
WINDOW = f"from='{WINDOW_A}', to='{WINDOW_B}'"
YEAR_2019 = "from='2019-01-01T00:00', to='2020-01-01T00:00'"
SET_STAMP = "2019-06-01T12:00"   # the timestamped Set's hour
NEW_HOUR = "2019-09-17T05:00"    # no event there: its H, D and M views
# the timestamped and the mutex /import write a column of every 8th shard
# (128 of the 1024; every shard until the multi-process serving step
# needed the seconds: the close then snapshots 7/8 fewer fragments of
# them)
TIME_WRITE_STRIDE = 8
TIME_SHAPES = [
    f"Count(Row(t=0, {YEAR_2019}))",                        # one Y view
    f"Count(Row(t=1, {WINDOW}))",                           # 65 views
    f"Count(Union(Row(t=0, {WINDOW}), Row(t=1, {WINDOW})))",
    f"Count(Intersect(Row(t=2, {WINDOW}), Row(kind=1)))",
    f"TopN(kind, Row(t=0, {WINDOW}), n=4)",
]
TIME_SINGLES = [
    "Count(Row(active=true))",
    f"GroupBy(Rows(kind), filter=Row(t=1, {WINDOW}))",
    f"Count(Row(t=1, from='{WINDOW_B}', to='{WINDOW_A}'))",  # empty cover
    "Count(Intersect(Row(kind=0), Row(kind=2)))",           # mutex: none
    "Count(Union(Row(kind=0), Row(kind=1), Row(kind=2), Row(kind=3)))",
]


def _bernoulli_columns(rng, p: float) -> np.ndarray:
    """The sorted columns of the 2^30, each in with probability ``p`` on
    its own: the gaps between them are geometric."""
    n_cols = N_SHARDS * WORDS * 32
    parts, end = [], -1
    while end < n_cols:
        n = int((n_cols - end) * p * 1.01) + 4096
        steps = np.cumsum(rng.geometric(p, n), dtype=np.int64) + end
        parts.append(steps)
        end = int(steps[-1])
    pos = np.concatenate(parts)
    return pos[pos < n_cols]


def _words_of(pos: np.ndarray) -> np.ndarray:
    """uint32 words of the 2^30 columns with the sorted ``pos`` set."""
    word = pos >> 5
    bits = np.uint32(1) << (pos & 31).astype(np.uint32)
    starts = np.flatnonzero(np.diff(word, prepend=-1))
    out = np.zeros(N_SHARDS * WORDS, np.uint32)
    out[word[starts]] = np.bitwise_or.reduceat(bits, starts)
    return out


def _bernoulli_words(rng, log2: int) -> np.ndarray:
    """uint32 words of the 2^30 columns, each column set with probability
    2^-log2 on its own."""
    return _words_of(_bernoulli_columns(rng, 1.0 / (1 << log2)))


def _share_rows(seed: int, tag: int, shares) -> dict:
    """{row: uint32 words}: each column in exactly one row, row k on about
    shares[k] of them, drawn 2^26 columns a task from its own generator."""
    lut = _category_lut(shares)
    n_cols = N_SHARDS * WORDS * 32
    step = min(1 << 26, n_cols)
    out = {r: np.empty(N_SHARDS * WORDS, np.uint32)
           for r in range(len(shares))}

    def chunk(lo: int) -> None:
        rng = np.random.default_rng([seed, tag, lo // step])
        cat = lut[rng.integers(0, 1 << 16, step, dtype=np.uint16)]
        for r, w in out.items():
            w[lo // 32:(lo + step) // 32] = np.packbits(
                cat == r, bitorder="little").view("<u4")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(chunk, range(0, n_cols, step)))
    return out


def make_events(seed: int) -> dict:
    """Host words of the events index: ``hours[h][r]`` the columns that
    event-hour h sets in row r of ``t``, ``kind`` and ``active`` rows. Each
    array comes from a generator of its own (seeded from ``seed``), eight
    at a time."""
    jobs = [(h, r) for h in range(len(EVENT_HOURS))
            for r in range(len(EVENT_ROW_LOG2))]

    def draw(job):
        h, r = job
        return _bernoulli_words(np.random.default_rng([seed, 4, h, r]),
                                EVENT_ROW_LOG2[r])

    with ThreadPoolExecutor(8) as pool:
        words = list(pool.map(draw, jobs))
    hours = [words[h * 4:(h + 1) * 4] for h in range(len(EVENT_HOURS))]
    return {"hours": hours, "kind": _share_rows(seed, 5, KIND_SHARES),
            "active": _share_rows(seed, 6, ACTIVE_SHARES)}


def event_views(quantum: str = "YMDH") -> dict:
    """{view name: event-hour indices whose bits it holds}: the standard
    view holds every hour, each quantum view the hours it spans."""
    from pilosa_tpu_torch.storage.view import views_for_time

    out: dict = {"standard": list(range(len(EVENT_HOURS)))}
    for h, t in enumerate(EVENT_HOURS):
        for name in views_for_time("standard", quantum, t):
            out.setdefault(name, []).append(h)
    return out


def _or_hours(ev: dict, hours, row: int) -> np.ndarray:
    acc = np.zeros(N_SHARDS * WORDS, np.uint32)
    for h in hours:
        acc |= ev["hours"][h][row]
    return acc


def _popcount(w) -> int:
    return int(np.bitwise_count(w).sum(dtype=np.int64))


def events_oracle(ev: dict) -> dict:
    """The words the time path's answers come from: each row over the
    window [WINDOW_A, WINDOW_B), row 0 over 2019, every hour's rows 0 and
    1 together (the columns a write may take as free), ``kind`` and
    ``active``. ``time_truth`` turns them into answers; the writes update
    them."""
    a, b = (dt.datetime.fromisoformat(s) for s in (WINDOW_A, WINDOW_B))
    inside = [h for h, t in enumerate(EVENT_HOURS) if a <= t < b]
    every = range(len(EVENT_HOURS))
    return {"win": [_or_hours(ev, inside, r) for r in range(4)],
            "y0": _or_hours(ev, [h for h, t in enumerate(EVENT_HOURS)
                                 if t.year == 2019], 0),
            "any01": _or_hours(ev, every, 0) | _or_hours(ev, every, 1),
            "kind": {r: w.copy() for r, w in ev["kind"].items()},
            "active": ev["active"][1], "inside_hours": len(inside)}


def time_truth(o: dict) -> dict:
    """Every served and single answer of the time path from the oracle's
    words."""
    win, kind = o["win"], o["kind"]
    by_kind = [_popcount(kind[r] & win[0]) for r in range(4)]
    filt = [_popcount(kind[r] & win[1]) for r in range(4)]
    n = N_SHARDS * WORDS * 32
    vals = [_popcount(o["y0"]), _popcount(win[1]),
            _popcount(win[0] | win[1]), _popcount(win[2] & kind[1]),
            _pairs(by_kind, range(4), 4),
            _popcount(o["active"]),
            _groups(["kind"], [(r,) for r in range(4)], filt), 0,
            _popcount(kind[0] & kind[2]),
            n if sum(_popcount(kind[r]) for r in range(4)) == n else -1]
    return dict(zip(TIME_SHAPES + TIME_SINGLES, vals))


def _set_bits(w: np.ndarray, cols) -> None:
    cols = np.asarray(cols, np.int64)
    np.bitwise_or.at(w, cols >> 5, np.uint32(1) << (cols & 31).astype(
        np.uint32))


def _clear_bits(w: np.ndarray, cols) -> None:
    cols = np.asarray(cols, np.int64)
    np.bitwise_and.at(w, cols >> 5, ~(np.uint32(1) << (cols & 31).astype(
        np.uint32)))


def _first_per_shard(w: np.ndarray, want_set: bool) -> np.ndarray:
    """Each shard's first column whose bit in ``w`` is (or is not) set."""
    shards = w.reshape(N_SHARDS, WORDS)
    probe = shards if want_set else ~shards
    word = np.argmax(probe != 0, axis=1)
    vals = probe[np.arange(N_SHARDS), word]
    low = np.array([(v & -v).bit_length() - 1 for v in vals.tolist()])
    return (np.arange(N_SHARDS) * WORDS + word) * 32 + low


def _check_time(c, o: dict, what: str) -> None:
    truth = time_truth(o)
    for pql, want in truth.items():
        got = c.query(pql)[0]
        if got != want:
            fail(f"time path, {what}: {pql} = {str(got)[:200]}, oracle "
                 f"{str(want)[:200]}")


def _k3(kernels) -> int:
    return kernels.launches()["word_patch"]


def _serve_time(server, o: dict) -> dict:
    """Phase 4d: BASELINE config 4 through the server: the five served
    shapes (16 clients), the single checks, then the writes, each
    followed by every answer against the oracle."""
    from pilosa_tpu_torch import kernels
    from pilosa_tpu_torch.storage.view import views_by_time_range

    stats: dict = {}
    c = Client(server.port, "events")
    truth = time_truth(o)
    window = views_by_time_range(
        "standard", "YMDH", dt.datetime.fromisoformat(WINDOW_A),
        dt.datetime.fromisoformat(WINDOW_B))
    stats["views_per_leaf"] = {"window": len(window), "year_2019": 1}
    stats["event_hours_in_window"] = o["inside_hours"]
    if len(window) != 65:
        fail(f"the window's cover has {len(window)} views, not 65")
    # the first touch of one 65-view leaf: the host ORs up to 65 views of
    # 1024 shards, then one upload
    t0 = time.perf_counter()
    pql = TIME_SHAPES[1]
    if c.query(pql)[0] != truth[pql]:
        fail(f"{pql} differs from the oracle")
    stats["first_touch_65_view_leaf_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pql in TIME_SHAPES + TIME_SINGLES:
        got = c.query(pql)[0]
        if got != truth[pql]:
            fail(f"{pql} = {str(got)[:200]}, oracle {str(truth[pql])[:200]}")
    stats["first_touch_s"] = time.perf_counter() - t0

    n_clients, per_client = 16, 20
    per_shape: dict = {}
    latencies, wall = closed_loop(server.port, "events", TIME_SHAPES, truth,
                                  n_clients, per_client, per_shape)
    stats.update(_latency_stats(latencies, wall), clients=n_clients)
    stats["p50_ms_by_shape"] = {
        pql: 1e3 * sorted(lat)[len(lat) // 2] for pql, lat in per_shape.items()}

    # a timestamped Set into the resident 65-view leaf (K3 OR), then a
    # Clear across the time views (the slot is re-decoded)
    col = int(_first_per_shard(o["any01"], want_set=False)[N_SHARDS // 2])
    before = _k3(kernels)
    if c.query(f"Set({col}, t=1, timestamp='{SET_STAMP}')") != [True]:
        fail("the timestamped Set changed nothing")
    stats["timestamped_set_k3_launches"] = _k3(kernels) - before
    _set_bits(o["win"][1], [col])
    _check_time(c, o, "after the timestamped Set")
    before = _k3(kernels)
    if c.query(f"Clear({col}, t=1)") != [True]:
        fail("the Clear on the time field changed nothing")
    stats["clear_k3_launches"] = _k3(kernels) - before
    _clear_bits(o["win"][1], [col])
    _check_time(c, o, "after the Clear")
    if stats["timestamped_set_k3_launches"] != 1:
        fail(f"the timestamped Set made {stats['timestamped_set_k3_launches']}"
             " K3 launches, not 1")

    # a timestamped /import of a bit in every TIME_WRITE_STRIDE-th shard at
    # an hour with no view: one K3 launch for the window leaves of rows 0
    # and 1 and the 2019 leaf
    cols = _first_per_shard(o["any01"], want_set=False)[::TIME_WRITE_STRIDE]
    rows = np.arange(cols.size) % 2
    body = json.dumps({"rows": rows.tolist(), "columns": cols.tolist(),
                       "timestamps": [NEW_HOUR] * cols.size}).encode()
    before = _k3(kernels)
    t0 = time.perf_counter()
    status, resp = c.post("/index/events/field/t/import", body)
    stats["timestamped_import_ms"] = 1e3 * (time.perf_counter() - t0)
    stats["timestamped_import_k3_launches"] = _k3(kernels) - before
    if status != 200 or json.loads(resp)["changed"] != cols.size:
        fail(f"the timestamped import answered {status} {resp!r}")
    if stats["timestamped_import_k3_launches"] != 1:
        fail(f"the timestamped import made "
             f"{stats['timestamped_import_k3_launches']} K3 launches, not 1")
    for r in (0, 1):
        _set_bits(o["win"][r], cols[rows == r])
    _set_bits(o["y0"], cols[rows == 0])
    _set_bits(o["any01"], cols)
    _check_time(c, o, "after the timestamped import")

    # a mutex /import moving a column of every TIME_WRITE_STRIDE-th shard
    # from kind=0 to kind=2, with both rows resident: one K3 launch
    # (AND-NOT and OR)
    for r in (0, 2):
        if c.query(f"Count(Row(kind={r}))")[0] != _popcount(o["kind"][r]):
            fail(f"Count(Row(kind={r})) differs from the oracle")
    cols = _first_per_shard(o["kind"][0], want_set=True)[::TIME_WRITE_STRIDE]
    body = json.dumps({"rows": [2] * cols.size,
                       "columns": cols.tolist()}).encode()
    before = _k3(kernels)
    t0 = time.perf_counter()
    status, resp = c.post("/index/events/field/kind/import", body)
    stats["mutex_import_ms"] = 1e3 * (time.perf_counter() - t0)
    stats["mutex_import_k3_launches"] = _k3(kernels) - before
    if status != 200 or json.loads(resp)["changed"] != cols.size:
        fail(f"the mutex import answered {status} {resp!r}")
    if stats["mutex_import_k3_launches"] != 1:
        fail(f"the mutex import made {stats['mutex_import_k3_launches']} K3 "
             "launches, not 1")
    _clear_bits(o["kind"][0], cols)
    _set_bits(o["kind"][2], cols)
    for r in (0, 2):
        if c.query(f"Count(Row(kind={r}))")[0] != _popcount(o["kind"][r]):
            fail(f"Count(Row(kind={r})) after the mutex import is wrong")
    _check_time(c, o, "after the mutex import")

    # Store of a sparse row, then ClearRow on its resident leaf
    wal = server.holder.wal
    stored = o["win"][3] & o["kind"][1]
    bytes0 = wal.metrics()["bytes_total"]
    t0 = time.perf_counter()
    if c.query(f"Store(Intersect(Row(t=3, {WINDOW}), Row(kind=1)), "
               "seg=1)") != [True]:
        fail("Store answered other than true")
    stats["store_s"] = time.perf_counter() - t0
    stats["store_wal_bytes"] = wal.metrics()["bytes_total"] - bytes0
    stats["store_bits"] = _popcount(stored)
    if c.query("Count(Row(seg=1))")[0] != stats["store_bits"]:
        fail("Count(Row(seg=1)) after the Store differs from the oracle")
    if c.query("Row(seg=1)")[0]["columns"][:1000] != \
            np.flatnonzero(np.unpackbits(stored.view(np.uint8),
                                         bitorder="little"))[:1000].tolist():
        fail("Row(seg=1) after the Store differs from the oracle")
    cache = server.holder.cache
    evictions = cache.evictions
    before = _k3(kernels)
    if c.query("ClearRow(seg=1)") != [True]:
        fail("ClearRow answered other than true")
    stats["clear_row_k3_launches"] = _k3(kernels) - before
    if c.query("Count(Row(seg=1))")[0] != 0:
        fail("Count(Row(seg=1)) after ClearRow is not 0")
    resident = any(k[0] == "stack" and k[2] == "events" and k[3] == "seg"
                   for k in list(cache._rows))
    if stats["clear_row_k3_launches"] != 1 or not resident or \
            cache.evictions != evictions:
        fail(f"ClearRow did not patch the resident leaf in one K3 launch "
             f"({stats['clear_row_k3_launches']} launches, resident "
             f"{resident})")
    _check_time(c, o, "after Store and ClearRow")
    stats["resident_bytes"] = cache.bytes_used
    c.close()
    return stats


# ---------------------------------------------------------------- keys path

# String keys (upstream pilosa's documented ``keys`` option: column keys on
# an index, row keys on a field), in two parts. (1) ``payment_type`` on
# ``rides``: the string payment_type column of the NYC TLC trip records
# that Litwintschik's "1.1 Billion Taxi Rides" benchmark loads, as a mutex
# field with row keys, every ride in one row with these shares (synthetic
# skew, as the taxi path's), at the full 1024 shards. (2) ``users``: an
# index with column keys, 2^USERS_LOG2 seeded 12-character keys (ids 0 …
# 2^22 - 1, 4 shards; cut from 2^30 because a keyed column space of 1B
# would put 1B strings in the translate store's dicts, in the reference
# and the port alike, and its replay would not fit the run), and a set
# field ``segment`` with 16 row keys, user in segment k with probability
# 2^-(2 + 10k/15): 1/4 down to 1/4096, so the rarest row holds about
# 1 000 users.
PAYMENT_TYPES = (("CRD", 0.55), ("CSH", 0.42), ("NOC", 0.015),
                 ("DIS", 0.01), ("UNK", 0.005))
PAYMENT_JOB = "pickup_year"  # the data job that also writes payment_type
USERS_JOB = "repository"     # the data job that also writes users
USERS_LOG2 = 22
USER_SEGMENTS = tuple(f"s{k:02d}" for k in range(16))
COMMON, OTHER, RAREST = USER_SEGMENTS[0], USER_SEGMENTS[1], USER_SEGMENTS[-1]
KEYS_SHAPES = [
    ("rides", 'Count(Intersect(Row(payment_type="CRD"), Row(cab_type=1)))'),
    ("rides", "TopN(payment_type, n=5)"),
    ("rides", "GroupBy(Rows(payment_type), Rows(passenger_count), "
              "limit=20)"),
    ("users", f'Count(Intersect(Row(segment="{COMMON}"), '
              f'Row(segment="{OTHER}")))'),
    ("users", f'Row(segment="{RAREST}")'),
]
NEW_USERS = 1000  # keys created through /internal/translate/keys


def make_payment(seed: int) -> np.ndarray:
    """Per-ride payment category (index into PAYMENT_TYPES): uint8[2^30],
    from a generator of its own."""
    rng = np.random.default_rng([seed, 8])
    lut = _category_lut([p for _, p in PAYMENT_TYPES])
    n = N_SHARDS * WORDS * 32
    step = 1 << 26
    cat = np.empty(n, np.uint8)
    for lo in range(0, n, step):
        cat[lo:lo + step] = lut[rng.integers(0, 1 << 16, min(step, n - lo),
                                             dtype=np.uint16)]
    return cat


def make_users(seed: int) -> dict:
    """The users index: ``keys`` (2^USERS_LOG2 distinct 12-letter keys,
    key i naming column i: 7 random letters, then i in base 26) and
    ``segments`` ({row key: uint32 words})."""
    rng = np.random.default_rng([seed, 9])
    n = 1 << USERS_LOG2
    raw = np.empty((n, 12), np.uint8)
    raw[:, :7] = rng.integers(97, 123, (n, 7), dtype=np.uint8)
    i = np.arange(n)
    for d in range(5):
        raw[:, 11 - d] = 97 + (i // 26 ** d) % 26
    text = raw.tobytes().decode("ascii")
    keys = [text[j:j + 12] for j in range(0, 12 * n, 12)]
    segments = {name: np.packbits(rng.random(n) < 2.0 ** -(2 + 10 * k / 15),
                                  bitorder="little").view("<u4")
                for k, name in enumerate(USER_SEGMENTS)}
    return {"keys": keys, "segments": segments}


def _columns_of(words: np.ndarray) -> np.ndarray:
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little"))


def _translate_records(namespace: str, keys) -> bytes:
    """The translate log's records for ``keys`` (the reference's format:
    uint16 namespace length, uint32 key length, namespace, key)."""
    ns = namespace.encode()
    return b"".join(struct.pack("<HI", len(ns), len(k.encode())) + ns
                    + k.encode() for k in keys)


def users_truth(users: dict) -> dict:
    """The users answers: per-segment counts, the served Intersect, the
    rarest row's keys, a user in COMMON and the ids of the rarest's
    first two users (their column attrs)."""
    seg, keys = users["segments"], users["keys"]
    rare = _columns_of(seg[RAREST])
    common = _columns_of(seg[COMMON])
    return {"n": {k: _popcount(w) for k, w in seg.items()},
            "both": _popcount(seg[COMMON] & seg[OTHER]),
            "rarest_keys": [keys[c] for c in rare.tolist()],
            "rarest_ids": rare.tolist(), "in_common": keys[int(common[0])]}


def keys_truth(o: dict, u: dict) -> dict:
    """The five served shapes' answers from the taxi oracle's payment
    counts (``o``) and the users truth (``u``)."""
    names = [k for k, _ in PAYMENT_TYPES]
    pc0, pcp = TAXI_FIELDS["passenger_count"]
    n_pc = len(pcp)
    top = sorted((-int(c), i) for i, c in enumerate(o["pay_n"]) if c)[:5]
    groups = []
    for i in sorted(range(len(names)), key=lambda i: names[i]):
        for p in range(n_pc):
            c = int(o["pay_pc"][i * n_pc + p])
            if c:
                groups.append({"group": [
                    {"field": "payment_type", "rowKey": names[i]},
                    {"field": "passenger_count", "rowID": pc0 + p}],
                    "count": c})
    return {
        KEYS_SHAPES[0][1]: int(o["pay_cab1"][0]),
        KEYS_SHAPES[1][1]: [{"id": i, "count": -c, "key": names[i]}
                            for c, i in top],
        KEYS_SHAPES[2][1]: groups[:20],
        KEYS_SHAPES[3][1]: u["both"],
        KEYS_SHAPES[4][1]: {"attrs": {}, "keys": u["rarest_keys"]},
    }


def _timed(stats: dict, name: str, c, pql: str, want, path=None):
    """One check outside the loop: the answer against ``want``, its wall
    time kept in ``stats["checks"]``."""
    t0 = time.perf_counter()
    if path is None:
        got = c.query(pql)
    else:
        status, body = c.post(path, pql.encode())
        if status != 200:
            fail(f"{pql} on {path} answered {status}: {body[:300]!r}")
        got = json.loads(body)["results"]
    ms = 1e3 * (time.perf_counter() - t0)
    if got != want:
        fail(f"{name}: {pql} = {str(got)[:300]}, oracle {str(want)[:300]}")
    stats.setdefault("checks", {})[name] = {"ms": ms,
                                            "answer": str(got)[:80]}
    return got


def _serve_keys(server, truth: dict, o: dict, u: dict) -> dict:
    """Phase 4e: string keys through the server: the five served shapes
    (16 clients over both indexes), then the single checks (Rows by key,
    row and column attrs, a keyed Set creating a row key and moving a
    mutex column, a new column key in a new shard, keys created through
    /internal/translate/keys and imported by id), each against the
    oracle."""
    from pilosa_tpu_torch import kernels

    stats: dict = {}
    rides, users = Client(server.port, "rides"), Client(server.port, "users")
    clients = {"rides": rides, "users": users}
    log0 = server.holder.translate.log_size()
    t0 = time.perf_counter()
    for index, pql in KEYS_SHAPES:  # first touch: leaves decoded
        got = clients[index].query(pql)[0]
        if got != truth[pql]:
            fail(f"{pql} = {str(got)[:300]}, oracle {str(truth[pql])[:300]}")
    stats["first_touch_s"] = time.perf_counter() - t0

    n_clients, per_client = 16, 20
    per_shape: dict = {}
    latencies, wall = closed_loop(server.port, "rides", KEYS_SHAPES, truth,
                                  n_clients, per_client, per_shape)
    stats.update(_latency_stats(latencies, wall), clients=n_clients)
    stats["p50_ms_by_shape"] = {
        pql: 1e3 * sorted(lat)[len(lat) // 2] for pql, lat in per_shape.items()}
    # the two Count shapes alone, as many clients: how much of their p50
    # in the mix is waiting behind the TopN's and GroupBy's host work
    per_count: dict = {}
    latencies, wall = closed_loop(server.port, "rides",
                                  [KEYS_SHAPES[0], KEYS_SHAPES[3]], truth,
                                  n_clients, per_client // 2, per_count)
    stats["counts_alone"] = {**_latency_stats(latencies, wall),
                             "p50_ms_by_shape": {
                                 pql: 1e3 * sorted(lat)[len(lat) // 2]
                                 for pql, lat in per_count.items()}}

    names = [k for k, _ in PAYMENT_TYPES]
    _timed(stats, "rows", rides, "Rows(payment_type)", [names])
    _timed(stats, "rows_like", rides, 'Rows(payment_type, like="C%")',
           [[k for k in names if k.startswith("C")]])
    # row attrs: the TopN filter and the Row result carry them
    _timed(stats, "set_row_attrs", rides,
           'SetRowAttrs(payment_type, "CRD", kind="card")', [None])
    _timed(stats, "topn_attr", rides, 'TopN(payment_type, n=5, '
           'attrName="kind", attrValue="card")',
           [[{"id": 0, "count": int(o["pay_n"][0]), "key": "CRD"}]])
    crd0 = o["crd_shard0"].tolist()
    pql = 'Options(Row(payment_type="CRD"), shards=[0])'
    _timed(stats, "row_attrs", rides, pql,
           [{"attrs": {"kind": "card"}, "columns": crd0}])
    _timed(stats, "exclude_row_attrs", rides, pql,
           [{"attrs": {}, "columns": crd0}],
           path="/index/rides/query?excludeRowAttrs=true")
    # column attrs on two users of the rarest segment
    ka, kb = u["rarest_keys"][:2]
    _timed(stats, "set_column_attrs", users,
           f'SetColumnAttrs("{ka}", plan="pro") '
           f'SetColumnAttrs("{kb}", plan="pro")', [None, None])
    _timed(stats, "column_attrs", users,
           f'Options(Row(segment="{RAREST}"), columnAttrs=true)',
           [{"attrs": {}, "keys": u["rarest_keys"], "columnAttrs": [
               {"id": i, "attrs": {"plan": "pro"}}
               for i in u["rarest_ids"][:2]]}])
    _timed(stats, "includes_known", users,
           f'IncludesColumn(Row(segment="{COMMON}"), '
           f'column="{u["in_common"]}")', [True])
    _timed(stats, "includes_unknown", users,
           f'IncludesColumn(Row(segment="{COMMON}"), column="no-such-user")',
           [False])

    # a keyed Set creating row key VOD and moving the ride out of its row:
    # one K3 launch (the ride's old row is resident)
    ride, old = o["vod_ride"], names[o["vod_old"]]
    before = _k3(kernels)
    _timed(stats, "set_new_row_key", rides,
           f'Set({ride}, payment_type="VOD")', [True])
    stats["set_new_row_key_k3_launches"] = _k3(kernels) - before
    if stats["set_new_row_key_k3_launches"] != 1:
        fail(f"the keyed mutex Set made "
             f"{stats['set_new_row_key_k3_launches']} K3 launches, not 1")
    _timed(stats, "count_new_row_key", rides,
           'Count(Row(payment_type="VOD")) '
           f'Count(Row(payment_type="{old}"))',
           [1, int(o["pay_n"][o["vod_old"]]) - 1])

    # a new column key: id 2^22, the first column of a fifth shard; the
    # users leaves' residency key holds their shard list, so the next
    # queries decode leaves of the five-shard block afresh
    n_users = 1 << USERS_LOG2
    before = _k3(kernels)
    _timed(stats, "set_new_column_key", users,
           f'Set("new-user", segment="{COMMON}")', [True])
    stats["new_shard_k3_launches"] = _k3(kernels) - before
    _timed(stats, "count_over_five_shards", users,
           f'Count(Row(segment="{COMMON}")) {KEYS_SHAPES[3][1]} '
           f'IncludesColumn(Row(segment="{COMMON}"), column="new-user")',
           [u["n"][COMMON] + 1, u["both"], True])
    shards = sorted({k[-1][1] for k in list(server.holder.cache._rows)
                     if k[0] == "stack" and k[2] == "users"}, key=len)
    stats["users_leaf_shards"] = len(shards[-1]) if shards else 0
    if stats["users_leaf_shards"] != n_users // (WORDS * 32) + 1:
        fail(f"the users leaves span {stats['users_leaf_shards']} shards "
             "after the new column key opened one")

    # keys turned into ids by the translate route, then imported by id
    new_keys = [f"import-{i:05d}" for i in range(NEW_USERS)]
    t0 = time.perf_counter()
    status, body = users.post("/internal/translate/keys", json.dumps(
        {"namespace": "c/users", "keys": new_keys, "create": True}).encode())
    ids = json.loads(body)["ids"] if status == 200 else None
    stats["translate_keys_ms"] = 1e3 * (time.perf_counter() - t0)
    if ids != list(range(n_users + 1, n_users + 1 + NEW_USERS)):
        fail(f"/internal/translate/keys answered {status} {body[:200]!r}")
    status, body = users.post("/internal/translate/keys", json.dumps(
        {"namespace": "r/users/segment", "keys": [OTHER]}).encode())
    (row,) = json.loads(body)["ids"]
    before = _k3(kernels)
    t0 = time.perf_counter()
    status, body = users.post("/index/users/field/segment/import",
                              json.dumps({"rows": [row] * NEW_USERS,
                                          "columns": ids}).encode())
    stats["import_by_id_ms"] = 1e3 * (time.perf_counter() - t0)
    stats["import_by_id_k3_launches"] = _k3(kernels) - before
    if status != 200 or json.loads(body)["changed"] != NEW_USERS:
        fail(f"the import of the translated ids answered {status} {body!r}")
    _timed(stats, "count_after_import", users,
           f'Count(Row(segment="{OTHER}")) Count(Intersect(Row(segment='
           f'"{OTHER}"), Row(segment="{COMMON}")))',
           [u["n"][OTHER] + NEW_USERS, u["both"]])

    # the translate log gained exactly the path's new keys, in order
    tail = server.holder.translate.read_log(log0)
    want = (_translate_records("r/rides/payment_type", ["VOD"])
            + _translate_records("c/users", ["new-user"] + new_keys))
    if tail != want:
        fail(f"the translate log gained {len(tail)} bytes, not the "
             f"{len(want)} of the path's new keys")
    stats["translate_log_bytes"] = server.holder.translate.log_size()
    stats["translate_log_bytes_added"] = len(tail)
    stats["resident_bytes"] = server.holder.cache.bytes_used
    rides.close()
    users.close()
    return stats


# ---------------------------------------------------------------- wire path

# The wire path: the NYC TLC trip records' store_and_fwd_flag column (row
# 1, "Y": the trip was held in the vehicle before it reached the vendor),
# as Litwintschik's "1.1 Billion Taxi Rides" loads it, on the 2^30 rides:
# each ride Y with probability 1%, about 10 486 a shard. A bulk loader
# sends it as upstream pilosa's loaders do, one shard's bits a request to
# import-roaring (odd shards in upstream pilosa's roaring layout, even
# ones in the port's), in bodies under /status's maxWritesPerRequest as
# the reference's CLI splits them; then protobuf clients send
# QueryRequest bodies and read QueryResponse answers as go-pilosa and
# python-pilosa do, and the same shapes as JSON beside them.
SFF = "store_and_fwd_flag"
SFF_P = 0.01
WIRE_CLIENTS = 16
# cut from 20 s and 10 s, then 5 s each, for the serving-envelope path
WIRE_PROTO_S = 1.0    # the protobuf clients' closed loop (3.0 until the
WIRE_JSON_S = 1.0     # mesh path came, 2.0 until multi-process serving);
#                       the same shapes as JSON
WIRE_WRITES = 4096    # bits of the protobuf ImportRequest, values of the
WIRE_SHARDS = (0, 1)  # ImportValueRequest; the Row shape's shards
WIRE_SERIAL = 16      # import-roaring requests sent one at a time
WIRE_SHAPES = [
    f"Count(Intersect(Row({SFF}=1), Row(cab_type=0)))",
    f"TopN(cab_type, Row({SFF}=1), n=3)",
    f'Sum(Row({SFF}=1), field="fare")',
    f"GroupBy(Rows(cab_type), filter=Row({SFF}=1))",
    f"Row({SFF}=1)",  # over WIRE_SHARDS alone
]
LEAF_BYTES = N_SHARDS * WORDS * 4  # one row across the 1024 shards


def wire_truth(rides: dict, seed: int) -> dict:
    """The store_and_fwd_flag columns (row 1) from ``seed``, every wire
    answer from them and the rides' host words, the protobuf writes' rows
    and values (on rides with no tip), and the tip Sum after them."""
    rng = np.random.default_rng([seed, 14])
    pos = _bernoulli_columns(rng, SFF_P)
    words = _words_of(pos)
    counts = [_popcount(words & rides["cab"][r]) for r in range(3)]
    word, bit = pos >> 5, (pos & 31).astype(np.uint32)
    planes = rides["fare"]
    has = ((planes[0, word] >> bit) & 1) == 1
    fare = np.zeros(pos.size, np.int64)
    for i in range(FARE_DEPTH):
        fare |= (((planes[2 + i, word] >> bit) & 1).astype(np.int64) << i)
    truth = dict(zip(WIRE_SHAPES, [
        counts[0],
        _pairs(counts, range(3), 3),
        {"value": int(fare[has].sum()), "count": int(has.sum())},
        _groups(["cab_type"], [(r,) for r in range(3)], counts),
        {"attrs": {}, "columns": pos[pos < len(WIRE_SHARDS) * WORDS * 32]
         .tolist()},
    ]))
    n_cols = N_SHARDS * WORDS * 32
    row2 = np.sort(rng.choice(n_cols, WIRE_WRITES, replace=False))
    cand = rng.choice(n_cols, 2 * WIRE_WRITES, replace=False)
    tip_cols = np.sort(cand[~np.isin(cand, rides["tip_cols"])][:WIRE_WRITES])
    tip_vals = rng.integers(0, TIP_MAX + 1, tip_cols.size)
    tips = np.concatenate([rides["tip_vals"], tip_vals])
    csv = _export_oracle(pos, row2)
    return {"truth": truth, "pos": pos, "row2": row2, "tip_cols": tip_cols,
            "export_sha256": hashlib.sha256(csv).digest(),
            "export_bytes": len(csv),
            "tip_vals": tip_vals,
            "tip_sum": {"value": int(rides["tip_vals"].sum()),
                        "count": int(rides["tip_vals"].size)},
            "tip_sum_after": {"value": int(tips.sum()),
                              "count": int(tips.size)}}


def _export_oracle(pos: np.ndarray, row2: np.ndarray) -> bytes:
    """The export's CSV from the host columns, in shard, row and column
    order (formatted by Python's int-to-string, not the server's numpy
    path)."""
    rows = np.concatenate([np.ones(pos.size, np.int64),
                           np.full(row2.size, 2, np.int64)])
    cols = np.concatenate([pos, row2]).astype(np.int64)
    order = np.lexsort((cols, rows, cols >> 20))
    lines = map("{},{}\n".format, rows[order].tolist(),
                cols[order].tolist())
    return "".join(lines).encode()


def _get_json(port: int, path: str):
    status, _, body = _http(port, "GET", path)
    if status != 200:
        fail(f"GET {path} answered {status}: {body[:300]!r}")
    return json.loads(body)


def _metric_families(text: str) -> dict:
    """family -> its untagged sample's value (None with only tagged
    samples) of a Prometheus page; every sample's family (a summary's or
    histogram's ``_bucket``/``_sum``/``_count`` series included) must
    lead with its HELP and TYPE lines."""
    meta: dict = {}
    values: dict = {}
    for line in text.splitlines():
        if line.startswith("# "):
            kind, name = line.split(" ")[1:3]
            meta.setdefault(name, set()).add(kind)
            values.setdefault(name, None)
            continue
        name, value = line.rsplit(" ", 1)
        family = name.split("{", 1)[0]
        if meta.get(family) != {"HELP", "TYPE"}:
            family = next((family[:-len(sfx)] for sfx in
                           ("_bucket", "_sum", "_count")
                           if family.endswith(sfx) and meta.get(
                               family[:-len(sfx)]) == {"HELP", "TYPE"}),
                          None)
            if family is None:
                fail(f"/metrics: {name} has no HELP and TYPE lines")
        if "{" not in name:
            values[name] = float(value)
    return values


def _wire_loop(port: int, requests: list, truth: list, seconds: float,
               decode) -> tuple[list, dict]:
    """WIRE_CLIENTS keep-alive clients sending ``requests`` ((path, body,
    headers) each) round robin for ``seconds``, each answer decoded by
    ``decode`` and held against ``truth``; (latencies, {shape index:
    latencies})."""
    errors, latencies, per_shape = [], [], {}
    lock = threading.Lock()
    stop = time.perf_counter() + seconds

    def client(k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            j = k
            while time.perf_counter() < stop:
                i = j % len(requests)
                path, body, headers = requests[i]
                t = time.perf_counter()
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                dt = time.perf_counter() - t
                got = (decode(raw)["results"][0] if resp.status == 200
                       else (resp.status, raw[:200]))
                with lock:
                    latencies.append(dt)
                    per_shape.setdefault(i, []).append(dt)
                    if got != truth[i]:
                        errors.append((i, str(got)[:200]))
                j += 1
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(WIRE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            fail("a wire client hung")
    if errors or not latencies:
        fail(f"wire answers wrong or missing: {errors[:3]}")
    return latencies, per_shape


def _k3_of(kernels) -> int:
    return kernels.launches()["word_patch"]


def _serve_wire(server, wt: dict, kernels) -> dict:
    """Phase 4, the wire path on ``rides``: the schema surface, a bulk
    import-roaring load of store_and_fwd_flag (one K3 launch a request),
    protobuf and JSON clients, protobuf writes, the export, /metrics and
    the field's delete; returns its numbers."""
    import torch

    from pilosa_tpu_torch import __version__
    from pilosa_tpu_torch.roaring import RoaringBitmap
    from pilosa_tpu_torch.roaring.format import serialize, serialize_pilosa
    from pilosa_tpu_torch.wire import pb2
    from pilosa_tpu_torch.wire.serializer import (
        decode_results_json,
        encode_import_request,
        encode_import_value_request,
    )

    t_path = time.perf_counter()
    stats: dict = {}
    port = server.port
    rides_dir = Path(server.holder.data_dir) / "rides"
    c = Client(port, "rides")

    # 1. the schema surface
    schema = _get_json(port, "/schema")
    rides = [i for i in schema["indexes"] if i["name"] == "rides"][0]
    on_disk = sorted(p.name for p in rides_dir.iterdir()
                     if p.is_dir() and not p.name.startswith((".", "_")))
    if sorted(f["name"] for f in rides["fields"]) != on_disk:
        fail(f"/schema lists {[f['name'] for f in rides['fields']]}, the "
             f"data dir holds {on_disk}")
    if _get_json(port, "/index/rides") != rides:
        fail("GET /index/rides differs from its /schema entry")
    if _get_json(port, "/internal/shards/max")["standard"]["rides"] != \
            N_SHARDS - 1:
        fail("/internal/shards/max does not give rides its last shard")
    if _get_json(port, "/version") != {"version": __version__}:
        fail("/version is not the package's")
    devices = _get_json(port, "/info")["devices"]
    if devices != [{"id": 0, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0)}]:
        fail(f"/info lists the devices {devices}")
    stats["fields_listed"] = len(on_disk)

    # 2. the bulk roaring load into a resident (empty) row
    status, resp = c.post(f"/index/rides/field/{SFF}", b"{}")
    if status != 200:
        fail(f"creating {SFF} answered {status} {resp!r}")
    if c.query(f"Count(Row({SFF}=1))") != [0]:
        fail(f"the new {SFF} is not empty")
    limit = _get_json(port, "/status")["maxWritesPerRequest"]
    pos = wt["pos"]
    t0 = time.perf_counter()
    bounds = np.searchsorted(pos, np.arange(N_SHARDS + 1) * WORDS * 32)
    bodies = []
    for s in range(N_SHARDS):
        local = pos[bounds[s]:bounds[s + 1]] - s * WORDS * 32
        for part in np.array_split(local, -(-local.size // limit)):
            b = RoaringBitmap()
            b.add_ids((np.uint64(1) << np.uint64(20)) + part.astype(np.uint64))
            blob = serialize_pilosa(b) if s % 2 else serialize(b)
            bodies.append((s, int(part.size), blob))
    stats["load_encode_s"] = time.perf_counter() - t0
    ops_before = _metric_families(_http(port, "GET", "/metrics")[2].decode())
    errors: list = []
    lock = threading.Lock()
    next_body = itertools.count()

    def loader(stop: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            while (i := next(next_body)) < stop:
                shard, n, blob = bodies[i]
                conn.request("POST", f"/index/rides/field/{SFF}/"
                             f"import-roaring/{shard}", body=blob,
                             headers={"Content-Type":
                                      "application/octet-stream"})
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status != 200 or json.loads(raw)["changed"] != n:
                    with lock:
                        errors.append((shard, resp.status, raw[:200]))
        finally:
            conn.close()

    # the first WIRE_SERIAL requests one at a time: each is one K3 launch;
    # then the rest from WIRE_CLIENTS clients, where a request's flush
    # also launches the patches other requests collected before it
    k3_before = _k3_of(kernels)
    loader(WIRE_SERIAL)
    k3_serial = _k3_of(kernels) - k3_before
    if errors or k3_serial != WIRE_SERIAL:
        fail(f"{WIRE_SERIAL} serial import-roaring requests made "
             f"{k3_serial} K3 launches: {errors[:3]}")
    next_body = itertools.count(WIRE_SERIAL)
    k3_before = _k3_of(kernels)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=loader, args=(len(bodies),))
               for _ in range(WIRE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            fail("an import-roaring client hung")
    load_s = time.perf_counter() - t0
    if errors:
        fail(f"import-roaring failed: {errors[:3]}")
    k3 = _k3_of(kernels) - k3_before
    n_conc = len(bodies) - WIRE_SERIAL
    bits = int(bounds[N_SHARDS] - bounds[0]) - sum(
        n for _, n, _ in bodies[:WIRE_SERIAL])
    stats.update(load_s=load_s, load_requests=len(bodies),
                 load_concurrent_requests=n_conc, load_bits=int(pos.size),
                 load_bits_per_s=bits / load_s,
                 k3_launches_per_serial_request=k3_serial / WIRE_SERIAL,
                 k3_launches_per_concurrent_request=k3 / n_conc)
    print(f"import-roaring: {pos.size} bits in {len(bodies)} requests "
          f"(encode {stats['load_encode_s']:.1f}s); {WIRE_SERIAL} serial "
          f"requests, K3 launches a request {k3_serial / WIRE_SERIAL}; "
          f"{n_conc} requests over {WIRE_CLIENTS} clients in {load_s:.3f}s "
          f"({bits / load_s:.0f} bits/s), K3 launches a request "
          f"{k3 / n_conc}", flush=True)
    if not 0 < k3 <= n_conc:
        fail(f"the load made {k3} K3 launches in {n_conc} requests")
    over = RoaringBitmap()
    over.add_ids((np.uint64(1) << np.uint64(20))
                 + np.arange(limit + 1, dtype=np.uint64))
    status, resp = c.post(f"/index/rides/field/{SFF}/import-roaring/0",
                          serialize(over))
    want = {"error": f"import-roaring body of {limit + 1} bits exceeds "
                     f"max-writes-per-request {limit}; split the bitmap"}
    if (status, json.loads(resp)) != (413, want):
        fail(f"an over-limit body answered {status} {resp[:200]!r}")
    if c.query(f"Count(Row({SFF}=1))") != [int(pos.size)]:
        fail(f"Count(Row({SFF}=1)) after the load differs from the oracle")

    # 3. protobuf clients, then the same shapes as JSON
    p = pb2()
    proto_h = {"Content-Type": "application/x-protobuf",
               "Accept": "application/x-protobuf"}
    truth = [wt["truth"][q] for q in WIRE_SHAPES]
    proto = [("/index/rides/query", p.QueryRequest(
        query=q, shards=list(WIRE_SHARDS) if q == WIRE_SHAPES[-1] else []
    ).SerializeToString(), proto_h) for q in WIRE_SHAPES]
    as_json = [("/index/rides/query" + (
        "?shards=" + ",".join(map(str, WIRE_SHARDS))
        if q == WIRE_SHAPES[-1] else ""), q.encode(), {})
        for q in WIRE_SHAPES]
    for name, reqs, seconds, decode in (
            ("protobuf", proto, WIRE_PROTO_S, decode_results_json),
            ("json", as_json, WIRE_JSON_S, json.loads)):
        t0 = time.perf_counter()
        lat, per_shape = _wire_loop(port, reqs, truth, seconds, decode)
        wall = time.perf_counter() - t0
        stats[name] = {**_latency_stats(lat, wall),
                       "p50_ms_by_shape": {
                           WIRE_SHAPES[i]: _p50_ms(v)
                           for i, v in sorted(per_shape.items())}}
        print(f"wire {name}: {json.dumps(stats[name])}", flush=True)

    # 4. protobuf writes into resident leaves: one K3 launch each
    if c.query(f"Count(Row({SFF}=2))") != [0]:
        fail(f"row 2 of {SFF} is not empty")
    if c.query('Sum(field="tip")') != [wt["tip_sum"]]:
        fail("Sum(field=tip) before the protobuf import-value differs")
    for what, path, body, check, want in (
            ("import", f"/index/rides/field/{SFF}/import",
             encode_import_request("rides", SFF, [2] * WIRE_WRITES,
                                   wt["row2"]),
             f"Count(Row({SFF}=2))", WIRE_WRITES),
            ("import-value", "/index/rides/field/tip/import-value",
             encode_import_value_request("rides", "tip", wt["tip_cols"],
                                         wt["tip_vals"]),
             'Sum(field="tip")', wt["tip_sum_after"])):
        before = _k3_of(kernels)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/x-protobuf"})
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        stats[f"protobuf_{what}_ms"] = 1e3 * (time.perf_counter() - t0)
        launched = _k3_of(kernels) - before
        stats[f"protobuf_{what}_k3_launches"] = launched
        if resp.status != 200 or launched != 1:
            fail(f"protobuf {what}: {resp.status} {raw[:200]!r}, "
                 f"{launched} K3 launches")
        if c.query(check) != [want]:
            fail(f"{check} after the protobuf {what} differs from the "
                 "oracle")

    # 5. the export, against the CSV of the oracle's columns
    t0 = time.perf_counter()
    status, _, body = _http(port, "GET", f"/export?index=rides&field={SFF}")
    export_s = time.perf_counter() - t0
    if status != 200 or hashlib.sha256(body).digest() != \
            wt["export_sha256"]:
        fail(f"/export answered {status} with {len(body)} bytes, not the "
             f"oracle's {wt['export_bytes']}")
    stats.update(export_s=export_s, export_bytes=len(body),
                 export_mb_per_s=len(body) / 1e6 / export_s,
                 export_lines=body.count(b"\n"))
    print(f"export: {stats['export_lines']} lines, {len(body)} bytes in "
          f"{export_s:.3f}s ({stats['export_mb_per_s']:.1f} MB/s), sha256 "
          "equal to the oracle's", flush=True)
    del body

    # 6. /metrics
    families = _metric_families(_http(port, "GET", "/metrics")[2].decode())
    for name in ("pilosa_tpu_residency_hits_total",
                 "pilosa_tpu_residency_bytes_used",
                 "pilosa_tpu_residency_tier_passes_total",
                 "pilosa_tpu_wal_appended_ops_total",
                 "pilosa_tpu_wal_commit_recoveries_total",
                 "pilosa_tpu_storage_degraded",
                 "pilosa_tpu_scrub_passes_total"):
        if name not in families:
            fail(f"/metrics has no {name}")
    grown = (families["pilosa_tpu_wal_appended_ops_total"]
             - ops_before["pilosa_tpu_wal_appended_ops_total"])
    if grown < len(bodies):
        fail(f"the WAL's ops grew by {grown} over {len(bodies)} requests")
    stats.update(metrics_families=len(families), wal_ops_grown=int(grown))

    # 7. the delete: the leaves leave the card, the files the disk
    resident = server.holder.cache.bytes_used
    status, _, resp = _http(port, "DELETE", f"/index/rides/field/{SFF}")
    if (status, resp) != (200, b"{}"):
        fail(f"DELETE of {SFF} answered {status} {resp[:200]!r}")
    freed = resident - server.holder.cache.bytes_used
    stats["delete_freed_bytes"] = freed
    if freed < LEAF_BYTES:
        fail(f"the delete freed {freed} resident bytes, not a leaf's "
             f"{LEAF_BYTES}")
    if (rides_dir / SFF).exists():
        fail(f"{rides_dir / SFF} is still on disk")
    status, resp = c.post("/index/rides/query",
                          f"Count(Row({SFF}=1))".encode())
    if (status, json.loads(resp)) != (
            400, {"error": f"field '{SFF}' not found"}):
        fail(f"a query of the deleted field answered {status} {resp!r}")
    status, resp = c.post(f"/index/rides/field/{SFF}", b"{}")
    counts = kernels.launches()["tree_count"]
    if status != 200 or c.query(f"Count(Row({SFF}=1))") != [0]:
        fail(f"the re-created {SFF} is not empty")
    if kernels.launches()["tree_count"] <= counts:
        fail("the re-created field's Count did not run on the card")
    status, _, resp = _http(port, "DELETE", f"/index/rides/field/{SFF}")
    if status != 200:
        fail(f"the second DELETE of {SFF} answered {status}")
    stats["resident_bytes"] = server.holder.cache.bytes_used
    stats["path_s"] = time.perf_counter() - t_path
    c.close()
    return stats


# ---------------------------------------------------------------- tier path

# The residency tiers on a deployment users run: the NYC TLC trip records
# that Litwintschik's "1.1 Billion Taxi Rides" loads (2009-01 .. 2015-12,
# tech.marksblogg.com/benchmarks.html) arrive month file after month
# file, so column ids follow pickup time. ``rides`` gains a set field
# ``pickup_month``, rows 0-83 (months from 2009-01), each month a
# contiguous range of the 2^30 columns (boundaries floor(m 2^30 / 84),
# inside shards and 4 KiB blocks): a 128 MiB leaf with about 391 of its
# 32 768 blocks nonzero, 2 MiB compressed. Cuts: equal months, not the
# TLC's monthly volumes; pickup_month independent of the synthetic
# pickup_year; no column marked existing by it (the rides' existence row
# stays as the other fields give it). Built in the repository worker.
N_MONTHS = 84
MONTH_JOB = "repository"
TIER_CLIENTS = 16
TIER_PER_CLIENT = 3       # 30, 18, then 10 before runs passed 1 100 s, 6
#                           until multi-process serving
TIER_DENSE_MONTHS = 16   # month leaves the lowered budget keeps dense
TIER_MATRIX_ROWS = 4     # TopN(cab_type)'s candidate matrix: 3 rows + 1 pad
TIER_SWEEP = 30          # months promoted after the writes
TIER_HOST_BYTES = 4 << 30  # the server's host tier
MONTH_A, MONTH_B = 10, 50  # the dense and the host-tier write targets


def month_edges() -> np.ndarray:
    """The 85 column boundaries of the 84 months."""
    return np.arange(N_MONTHS + 1, dtype=np.int64) * (N_SHARDS * WORDS * 32) \
        // N_MONTHS


def range_words(lo: int, hi: int, out: np.ndarray) -> np.ndarray:
    """``out`` (uint32 words) holding exactly the columns [lo, hi)."""
    out[:] = 0
    wlo, whi = lo >> 5, hi >> 5
    head = (0xFFFFFFFF << (lo & 31)) & 0xFFFFFFFF
    if wlo == whi:
        out[wlo] = head & ((1 << (hi & 31)) - 1)
        return out
    out[wlo] = head
    out[wlo + 1:whi] = 0xFFFFFFFF
    if hi & 31:
        out[whi] = (1 << (hi & 31)) - 1
    return out


def graph_ms(torch, fn, launches: int = 100, reps: int = 5) -> float:
    """The device time of ``fn``: ``launches`` calls captured in one CUDA
    graph, replayed; median over ``reps`` of (event time of a replay) /
    launches. The host's part of each call is not replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / launches)
    del graph
    return statistics.median(per)


def turns_ms(torch, fns: dict, launches: int, rounds: int = 4) -> dict:
    """``cuda_ms`` of each of ``fns`` in turns (A, B, B, A, ...) over
    ``rounds`` rounds; the median per name. Host-bound calls drift with
    the host, so calls compared with each other are timed in turns."""
    names = list(fns)
    got: dict = {n: [] for n in names}
    for r in range(rounds):
        for n in names if r % 2 == 0 else names[::-1]:
            got[n].append(cuda_ms(torch, fns[n], launches=launches))
    return {n: statistics.median(v) for n, v in got.items()}


def _padded_month_index(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A leaf's nonzero-block index and its padded form (to a power of
    two, repeating the first), as the residency cache pads it."""
    block_idx = np.flatnonzero(words.reshape(-1, 1024).any(axis=1)
                               ).astype(np.int32)
    nb = len(block_idx)
    idx_host = np.full(max(1, 1 << max(nb - 1, 0).bit_length()),
                       block_idx[0] if nb else 0, np.int32)
    idx_host[:nb] = block_idx
    return block_idx, idx_host


TIER_BATCH_MONTHS = 16  # the month leaves a tier pass finds dense


def _staged_gather(torch, kernels, dev, flats, idxs, outs):
    """K10's staged batch launch alone, on its table already on the card:
    a function that launches it (no count), for the device time of the
    wrapper's launch without its host work (the wrapper's staging pool
    records an event, which a CUDA graph cannot hold)."""
    blob, offset = kernels._gather_table(flats, idxs, outs, False)
    staged = torch.from_numpy(blob).to(dev)
    lib = kernels._lib("block_gather")
    n_out = (blob.size - offset) // 4

    def launch():
        rc = lib.block_gather_batch_launch(
            None, staged.data_ptr(), blob.size, offset, len(flats), n_out,
            kernels._raw_stream(staged.get_device()))
        if rc:
            fail(f"block_gather_batch launch failed: cudaError {rc}")
    return launch, blob.size


def check_block_kernels(torch, kernels, dev) -> list:
    """Phase 3, the residency tiers: K10 and K11 against their plain
    versions, bit-exact, at the month leaf's shape (n_blocks 32 768, a
    month's ~391 nonzero blocks padded to 512 by repeating the first), on
    random blocks at random places (duplicates in the padding), and on an
    all-zero leaf (no real block, one padding block); K11 gives back the
    leaf it came from, from K10's output and index copy. K10 as the
    residency cache calls it (``block_gather_batch`` into one compressed
    entry's own storage, the index passed in the launch's parameters and
    copied to the card beside its blocks),
    as the one-leaf ``block_gather`` on a device index, and batched over
    TIER_BATCH_MONTHS month leaves (a tier pass's dense months, one
    launch, one buffer). Times: K10's whole calls, timed in turns with
    index_select, and their device times (a CUDA graph of launches),
    beside the launch floor; K11 beside zeros + index_copy_."""
    edges = month_edges()
    n_blocks = N_SHARDS * WORDS // kernels.BLOCK_WORDS
    host = np.zeros(N_SHARDS * WORDS, np.uint32)
    rng = np.random.default_rng(11)
    cases = {}
    m = N_MONTHS // 2
    cases["month"] = range_words(int(edges[m]), int(edges[m + 1]), host).copy()
    rand = np.zeros_like(host)
    pick = rng.choice(n_blocks, 390, replace=False)
    for b in pick:
        rand[b * 1024:(b + 1) * 1024] = rng.integers(0, 1 << 32, 1024,
                                                     dtype=np.uint32)
    cases["random"] = rand
    cases["zero"] = np.zeros_like(host)
    err = 0
    timed = None
    for name, words in cases.items():
        block_idx, idx_host = _padded_month_index(words)
        nb = len(block_idx)
        flat = torch.from_numpy(words.view(np.int32)).to(dev)
        idx = torch.from_numpy(idx_host).to(dev)
        want = kernels.block_gather_plain(flat, idx)
        err = max(err, max_abs_err(torch, kernels.block_gather(flat, idx),
                                   want))
        entry = torch.empty(idx_host.size * 1025, dtype=torch.int32,
                            device=dev)
        kernels.block_gather_batch([flat], [idx_host], [entry],
                                   with_index=True)
        blocks = entry[:idx_host.size * 1024].view(-1, 1024)
        idx_copy = entry[idx_host.size * 1024:]
        err = max(err, max_abs_err(torch, blocks, want),
                  max_abs_err(torch, idx_copy, idx))
        back = kernels.block_scatter(blocks, idx_copy, n_blocks, block_idx)
        err = max(err, max_abs_err(torch, back, kernels.block_scatter_plain(
            blocks, idx_copy, n_blocks)), max_abs_err(torch, back, flat))
        if name == "month":
            timed = (flat, idx, idx_host, blocks, block_idx, nb)
        print(f"kernel block_gather/block_scatter on the {name} leaf: "
              f"{nb} nonzero blocks padded to {idx_host.size}", flush=True)
    del cases, rand
    # the batch: TIER_BATCH_MONTHS month leaves, one launch, one buffer
    flats, idxs = [], []
    for k in range(TIER_BATCH_MONTHS):
        mk = (m + 1 + k) % N_MONTHS
        words = range_words(int(edges[mk]), int(edges[mk + 1]), host)
        flats.append(torch.from_numpy(words.view(np.int32)).to(dev))
        idxs.append(_padded_month_index(words)[1])
    dev_idxs = [torch.from_numpy(i).to(dev) for i in idxs]
    want = kernels.block_gather_batch_plain(flats, dev_idxs)
    n_rows = int(sum(i.size for i in idxs))
    starts = np.cumsum([0] + [i.size * 1024 for i in idxs])

    def tier_batch(buf=None):
        # as the tier pass calls it: one buffer, a slice a leaf
        if buf is None:
            buf = torch.empty(n_rows * 1024, dtype=torch.int32, device=dev)
        outs = [buf[starts[k]:starts[k + 1]] for k in range(len(idxs))]
        kernels.block_gather_batch(flats, idxs, outs)
        return buf, outs

    out, outs = tier_batch(torch.full((n_rows * 1024,), -7,
                                      dtype=torch.int32, device=dev))
    err = max(err, max_abs_err(torch, out.view(-1, 1024), want))
    torch.cuda.synchronize()
    if err != 0:
        fail(f"block_gather/block_scatter disagree with their plain "
             f"versions by {err}")
    flat, idx, idx_host, blocks, block_idx, nb = timed
    nbp = idx_host.size
    floor = cuda_ms(torch, lambda: kernels.launch_floor(dev), launches=100)
    long_idx = idx.long()

    def entry_gather():
        # as an eviction calls it for one victim
        entry = flat.new_empty(nbp * 1025)
        kernels.block_gather_batch([flat], [idx_host], [entry],
                                   with_index=True)

    def library():
        return flat.view(-1, 1024).index_select(0, long_idx)

    calls = turns_ms(torch, {
        "entry": entry_gather,
        "single": lambda: kernels.block_gather(flat, idx),
        "index_select": library}, launches=100)
    batch_launch, batch_table = _staged_gather(
        torch, kernels, dev, flats, idxs, outs)
    k10 = {"entry_ms": calls["entry"],
           "entry_device_ms": graph_ms(torch, entry_gather),
           "single_ms": calls["single"],
           "single_device_ms": graph_ms(torch, lambda: kernels.block_gather(
               flat, idx)),
           "library_ms": calls["index_select"],
           "library_device_ms": graph_ms(torch, library),
           "batch_ms": cuda_ms(torch, tier_batch, launches=20),
           "batch_device_ms": graph_ms(torch, batch_launch, launches=20)}
    print(f"kernel block_gather at {nbp} of {n_blocks} blocks: "
          f"block_gather_batch into an entry's storage {k10['entry_ms']} ms "
          f"(device {k10['entry_device_ms']} ms), block_gather "
          f"{k10['single_ms']} ms (device {k10['single_device_ms']} ms), "
          f"index_select {k10['library_ms']} ms (device "
          f"{k10['library_device_ms']} ms), launch floor {floor} ms",
          flush=True)
    print(f"kernel block_gather_batch over {len(flats)} month leaves "
          f"({n_rows} blocks): whole call {k10['batch_ms']} ms, device "
          f"{k10['batch_device_ms']} ms", flush=True)
    # each input read once (the index, or the table with it, each
    # distinct block), each output written once (the rows, the index
    # copy)
    gather_bytes = nbp * 4 + np.unique(idx_host).size * 4096 \
        + nbp * (4096 + 4)
    batch_bytes = batch_table + sum(
        np.unique(i).size for i in idxs) * 4096 + n_rows * 4096
    scatter_bytes = n_blocks * 4096 + nb * 4096 + nb * 4

    def library_scatter():
        out = torch.zeros((n_blocks, 1024), dtype=torch.int32, device=dev)
        return out.index_copy_(0, long_idx, blocks)

    return [{
        "name": "block_gather", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/block_gather.cu",
        "replaces": "pilosa_tpu/storage/residency.py:80",
        "max_abs_err": err,
        # the wrapper the cache calls, into one entry's storage
        "ms": k10["entry_ms"], "device_ms": k10["entry_device_ms"],
        "single_ms": k10["single_ms"],
        "single_device_ms": k10["single_device_ms"],
        "plain_ms": cuda_ms(torch, lambda: kernels.block_gather_plain(
            flat, idx), launches=100),
        "bound_ms": _bytes_ms(gather_bytes), "bound_by": "bytes",
        "library_ms": k10["library_ms"],
        "library_device_ms": k10["library_device_ms"],
        "launch_floor_ms": floor,
        "shape": f"int32[{n_blocks} x 1024] -> int32[{nbp}, 1024] "
                 f"({nb} real blocks) and its index",
    }, {
        "name": "block_gather_batch", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/block_gather.cu",
        "replaces": "pilosa_tpu/storage/residency.py:80",
        "max_abs_err": err,
        "ms": k10["batch_ms"], "device_ms": k10["batch_device_ms"],
        "plain_ms": cuda_ms(torch, lambda: kernels.block_gather_batch_plain(
            flats, dev_idxs), launches=20),
        "bound_ms": _bytes_ms(batch_bytes), "bound_by": "bytes",
        # no one PyTorch call gathers from several tensors
        "library_ms": None,
        "launch_floor_ms": floor,
        "shape": f"{len(flats)} x int32[{n_blocks} x 1024] -> "
                 f"int32[{n_rows}, 1024]",
    }, {
        "name": "block_scatter", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/block_scatter.cu",
        "replaces": "pilosa_tpu/storage/residency.py:86",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernels.block_scatter(
            blocks, idx, n_blocks, block_idx), launches=20),
        "plain_ms": cuda_ms(torch, lambda: kernels.block_scatter_plain(
            blocks, idx, n_blocks), launches=20),
        "bound_ms": _bytes_ms(scatter_bytes), "bound_by": "bytes",
        "library_ms": cuda_ms(torch, library_scatter, launches=20),
        "launch_floor_ms": floor,
        "shape": f"int32[{nbp}, 1024] ({nb} real blocks) -> "
                 f"int32[{n_blocks} x 1024]",
    }]


# ---------------------------------------------------------------- mesh path

MESH_MEMBERS = 8  # members of one card, as the reference's 8 forced devices
# (groups, quantized ranking) of the mesh path's three meshes: the flat
# 1 x 8, then 2 x 4 and 4 x 2 with the 8-bit ranking lane
MESH_CONFIGS = ((1, False), (2, True), (4, True))
MESH_ROUNDS = 4    # each Star-Trace Count shape submitted this often a round
MESH_TIP_RANGE = 50_000
# a 2-D mesh's Count and submitted Count ms in M1 (an H100 run of this
# script with K12 and K13 apart), printed beside this run's
M1_MESH_COUNT_MS = {2: "3.6 / 1.5 ms", 4: "4.8 / 1.0 ms"}
# the mesh path's oracle inputs the serving path leaves behind: the
# Star-Trace Counts after its writes, and its PROFILE row's columns
MESH_TRUTH: dict = {}


def _lane_case(torch, dev, members: int, n: int, seed: int):
    """Split-channel partials int32[members, 2, n] as the mesh's members
    give them at 1024 shards (each member's sums of 128 slots)."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 128 * 32767 + 1, (members, n))
    hi = rng.integers(0, 128 * 32 + 1, (members, n))
    return torch.from_numpy(np.stack([lo, hi], 1).astype(np.int32)).to(dev)


def _lane_layouts(torch, parts, mode: str) -> dict:
    """The same [M, ...] partials as lane_reduce takes them: stacked, a
    list of members (each its own allocation, as the members' kernels
    write them), transposed member views (a micro-batch's [B, 2]) and
    strided views of a wider buffer, stacked and as members."""
    m = parts.shape[0]
    wide = torch.zeros((*parts.shape[:-1], 3 * parts.shape[-1]),
                       dtype=parts.dtype, device=parts.device)
    wide[..., ::3] = parts
    out = {"stacked": parts, "members": [parts[k].clone() for k in range(m)],
           "stacked_strided": wide[..., ::3],
           "members_strided": [wide[k, ..., ::3] for k in range(m)]}
    if mode == "sum":
        out["members_b2"] = [parts[k].t().contiguous().t() for k in range(m)]
    return out


def _check_lane_reduce(torch, kernels, parts, groups: int, widths,
                       mode: str, what: str) -> int:
    """K12+K13 from every layout of ``parts`` (and the executor's [2] or
    0-d partials of its first element) against its plain version,
    bit-exact, dtype too. Returns the largest difference (0)."""
    want = kernels.lane_reduce_plain(parts, groups, widths, mode)
    err = 0
    layouts = _lane_layouts(torch, parts, mode)
    layouts["first element"] = [parts[k, ..., 0]
                                for k in range(parts.shape[0])]
    for name, layout in layouts.items():
        got = kernels.lane_reduce(layout, groups, widths, mode)
        ref = want[..., :1] if name == "first element" else want
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            fail(f"lane_reduce differs from its plain version at {what}, "
                 f"{mode}, from the {name} layout")
        err = max(err, max_abs_err(torch, got, ref))
    return err


def _check_quant_reduce(torch, kernels, parts, groups, what: str) -> int:
    """K14+K15 from every layout of ``parts`` (those of _lane_layouts and
    GroupBy's [2, k, c] member partials viewed as [2, k*c], contiguous
    and strided) against its plain version, bit-exact, dtype too.
    Returns the largest difference (0)."""
    want = kernels.quant_reduce_plain(parts, groups)
    m, _, rows = parts.shape
    k = 2 if rows % 2 == 0 else 1
    cube = torch.zeros((m, 2, k, 2 * (rows // k)), dtype=parts.dtype,
                       device=parts.device)
    cube[..., ::2] = parts.reshape(m, 2, k, rows // k)
    layouts = _lane_layouts(torch, parts, "sum")
    layouts["groupby"] = [p.reshape(2, k, rows // k).clone().reshape(
        2, rows) for p in parts]
    layouts["groupby_strided"] = [cube[j, ..., ::2].reshape(2, rows)
                                  for j in range(m)]
    err = 0
    for name, layout in layouts.items():
        got = kernels.quant_reduce(layout, groups)
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"quant_reduce differs from its plain version at {what}, "
                 f"from the {name} layout")
        err = max(err, max_abs_err(torch, got, want))
    return err


def check_mesh_kernels(torch, kernels, dev) -> list:
    """Phase 3, the mesh lanes: K12+K13 and K14+K15 against their plain
    versions, bit-exact (values and dtypes), at the mesh path's shapes (8
    members of 128 slots: a Count's N = 1, the taxi candidates 4, 80 and
    512, over 2 and 4 groups and the flat mesh; K12+K13 from every input
    layout the executor gives it, the split channels and the int64 max
    and min lanes) and K14+K15 at R = 4, 80, 512 and 65 536 over 2 and 4
    groups and the flat mesh's lossless pass-through, from every layout
    and with a block of scale 1. Times: the whole wrapper call
    (host-bound at these sizes), its device time apart (its calls in a
    CUDA graph), its C call alone and a torch.empty of its output (the
    host's split of the call), the plain version, the byte bound beside
    the launch floor; K12+K13 at a Count's reduce from the list of member
    partials beside torch.stack of that list, torch.sum of the stack (the
    PyTorch way to the same function from the same inputs) and torch.sum
    of a stacked tensor; K14+K15 from the list of 8 members at R = 65 536
    over 4 groups beside torch.stack of that list (the old path's first
    step) and its flat pass-through."""
    from pilosa_tpu_torch.parallel import reduction

    floor = cuda_ms(torch, lambda: kernels.launch_floor(dev), launches=100)
    err = 0
    for n, groups in ((1, 2), (1, 4), (4, 2), (80, 4), (512, 2)):
        parts = _lane_case(torch, dev, MESH_MEMBERS, n, n + groups)
        slots = N_SHARDS // groups
        widths = tuple(reduction.lane_dtype_bytes(b) for b in
                       reduction.split_channel_bounds(slots))
        what = f"n={n}, groups={groups}"
        err = max(err, _check_lane_reduce(torch, kernels, parts, groups,
                                          widths, "sum", what))
        err = max(err, _check_lane_reduce(torch, kernels, parts, 1, (4, 4),
                                          "sum", f"n={n}, flat"))
        if not torch.equal(kernels.lane_reduce(parts, 1, (4, 4)),
                           parts.sum(0, dtype=torch.int32)):
            fail(f"lane_reduce's flat sum differs from torch.sum at n={n}")
        best = parts[:, 0].to(torch.int64) - (1 << 40)
        for mode in ("max", "min"):
            for g in (groups, 1):
                err = max(err, _check_lane_reduce(
                    torch, kernels, best, g, 8, mode, f"n={n}, groups={g}"))
    for rows in (4, 80, 512, 1 << 16):
        parts = _lane_case(torch, dev, MESH_MEMBERS, rows, rows)
        parts[:, 0, :256] %= 2  # an all-small block: scale 1
        parts[:, 1, :256] = 0
        for groups in (2, 4, None):
            if groups is not None and int(kernels.quant_pack_plain(
                    parts, groups)[1][:, 0].max()) != 1:
                fail(f"quant_reduce's check at R={rows} has no block of "
                     "scale 1")
            err = max(err, _check_quant_reduce(
                torch, kernels, parts, groups, f"R={rows}, groups={groups}"))
    # a Count's reduce (N = 1, 2 x 4) from the members' partials for
    # K12+K13, R = 65 536 over 4 groups for K14+K15
    parts = _lane_case(torch, dev, MESH_MEMBERS, 1, 3)
    members = [parts[k].clone() for k in range(MESH_MEMBERS)]
    widths = tuple(reduction.lane_dtype_bytes(b) for b in
                   reduction.split_channel_bounds(N_SHARDS // 2))
    rows = 1 << 16
    nb = -(-rows // reduction.QUANT_BLOCK)
    qparts = _lane_case(torch, dev, MESH_MEMBERS, rows, rows)
    qmembers = [qparts[k].clone() for k in range(MESH_MEMBERS)]
    common = {"route": "cuda", "max_abs_err": err, "bound_by": "bytes",
              "launch_floor_ms": floor}

    def call():
        return kernels.lane_reduce(members, 2, widths)

    def quant_call():
        return kernels.quant_reduce(qmembers, 4)

    lane_bytes = _bytes_ms(MESH_MEMBERS * 2 * 4 + 2 * 4)
    quant_bytes = _bytes_ms(MESH_MEMBERS * 2 * rows * 4 + 2 * (rows + nb) * 4)
    return [{
        **common, "name": "lane_reduce",
        "source": "pilosa_tpu_torch/csrc/lane_reduce.cu",
        "replaces": "pilosa_tpu/parallel/reduction.py:211",
        "ms": cuda_ms(torch, call, launches=100),
        "device_ms": graph_ms(torch, call),
        "c_call_ms": cuda_ms(torch, kernels.lane_reduce_staged(
            members, 2, widths), launches=100),
        "plain_ms": cuda_ms(torch, lambda: kernels.lane_reduce_plain(
            members, 2, widths), launches=100),
        "bound_ms": lane_bytes, "bytes_bound_ms": lane_bytes,
        "library_ms": cuda_ms(torch, lambda: torch.sum(
            torch.stack(members), 0, dtype=torch.int32), launches=100),
        "library_stacked_ms": cuda_ms(torch, lambda: torch.sum(
            parts, 0, dtype=torch.int32), launches=100),
        "stack_ms": cuda_ms(torch, lambda: torch.stack(members),
                            launches=100),
        "empty_ms": cuda_ms(torch, lambda: torch.empty(
            2, 1, dtype=torch.int32, device=dev), launches=100),
        "flat_ms": cuda_ms(torch, lambda: kernels.lane_reduce(
            members, 1, (4, 4)), launches=100),
        "shape": f"{MESH_MEMBERS} members' int32[2, 1] -> lanes of {widths} "
                 f"bytes over 2 groups -> int32[2, 1] (flat: 1 group)",
    }, {
        **common, "name": "quant_reduce",
        "source": "pilosa_tpu_torch/csrc/quant_reduce.cu",
        "replaces": "pilosa_tpu/parallel/reduction.py:132",
        "ms": cuda_ms(torch, quant_call, launches=100),
        "device_ms": graph_ms(torch, quant_call),
        "c_call_ms": cuda_ms(torch, kernels.quant_reduce_staged(
            qmembers, 4), launches=100),
        "plain_ms": cuda_ms(torch, lambda: kernels.quant_reduce_plain(
            qmembers, 4), launches=20),
        "bound_ms": quant_bytes, "bytes_bound_ms": quant_bytes,
        "library_ms": None,
        "stack_ms": cuda_ms(torch, lambda: torch.stack(qmembers),
                            launches=100),
        "empty_ms": cuda_ms(torch, lambda: torch.empty(
            2, rows + nb, dtype=torch.int32, device=dev), launches=100),
        "flat_ms": cuda_ms(torch, lambda: kernels.quant_reduce(
            qmembers, None), launches=100),
        "shape": f"{MESH_MEMBERS} members' int32[2, {rows}] -> 8-bit lanes "
                 f"over 4 groups -> int32[2, {rows + nb}] (flat: lossless)",
    }]


def _q4_by_distance(q4: str, groups: list) -> tuple[str, list]:
    """Q4 with its dimensions reversed (trip_distance first, so its second,
    quantized pruning level holds 64 x 8 = 512 candidates: two scale
    blocks) and its oracle's groups in that order."""
    names = q4[len("GroupBy("):-1].split(", ")
    pql = "GroupBy(" + ", ".join(reversed(names)) + ")"
    out = [{"group": g["group"][::-1], "count": g["count"]} for g in groups]
    out.sort(key=lambda g: tuple(d["rowID"] for d in g["group"]))
    return pql, out


def mesh_truth(taxi_truth: dict, rides: dict, wire: dict) -> dict:
    """The mesh path's answers from the oracles: the tips as the rides and
    wire paths leave them, the taxi queries 1-4 (Q4 after the taxi path's
    Set, and reversed) and Q1 cut to n=1; the Star-Trace Counts and the
    Row come from the serving path (MESH_TRUTH)."""
    tips = np.concatenate([rides["tip_vals"], wire["tip_vals"]])
    lo, hi = int(tips.min()), int(tips.max())
    truth = {
        'Sum(field="tip")': wire["tip_sum_after"],
        'Min(field="tip")': {"value": lo, "count": int((tips == lo).sum())},
        'Max(field="tip")': {"value": hi, "count": int((tips == hi).sum())},
        f"Count(Range(tip > {MESH_TIP_RANGE}))":
            int((tips > MESH_TIP_RANGE).sum()),
    }
    t = taxi_truth["truth"]
    for pql in ("TopN(cab_type)",
                'GroupBy(Rows(passenger_count), aggregate=Sum(field="fare"))',
                "GroupBy(Rows(passenger_count), Rows(pickup_year))"):
        truth[pql] = t[pql]
    truth["TopN(cab_type, n=1)"] = t["TopN(cab_type)"][:1]
    truth[taxi_truth["q4"]] = taxi_truth["q4_after"]
    q4r, groups = _q4_by_distance(taxi_truth["q4"], taxi_truth["q4_after"])
    truth[q4r] = groups
    return truth


def _mesh_json(results) -> list:
    """An executor's results as the HTTP answer shows them."""
    from pilosa_tpu_torch.executor import result_to_json

    return json.loads(json.dumps(result_to_json(results)))


def _free_bit(words: np.ndarray, other: np.ndarray, shard: int) -> int:
    """A column of ``shard`` set in ``other`` and clear in ``words``."""
    free = (other & ~words).reshape(N_SHARDS, WORDS)[shard]
    w = int(np.flatnonzero(free)[0])
    bit = int(np.flatnonzero(np.unpackbits(np.array([free[w]], np.uint32)
                                           .view(np.uint8),
                                           bitorder="little"))[0])
    return shard * WORDS * 32 + w * 32 + bit


def _serve_mesh(server, truth: dict, words: dict, kernels) -> dict:
    """The mesh path: ``DistExecutor(server.holder, make_mesh(8,
    devices=[cuda:0], groups=g))`` for g = 1 (flat), 2 and 4 (the 8-bit
    ranking lane on), each driven through ``execute`` and ``submit`` over
    the Star-Trace Counts (pipelined, so they micro-batch), a Row gather,
    the tip's Sum, Min, Max and a Range count, taxi queries 1-4 (Q4 also
    reversed) and TopN(cab_type, n=1) (a window to rank, on Q1's
    matrix), and a Set through HTTP between two mesh reads of the leaf it
    patches (then its Clear). Every answer equals the oracle's and the
    server's single-device executor's; with the ranking lane on, TopN and
    GroupBy are the lossless answers (one pass with verify_quantized).
    Prints, per mesh, the lane kernels' launches and the reductions per
    query kind (one K12+K13 launch a lossless reduction, three a Min or
    Max), the reduction's
    dense and actual bytes, the quantized windows and ms per query."""
    from pilosa_tpu_torch.parallel import DistExecutor, make_mesh
    from pilosa_tpu_torch.parallel.reduction import global_reduce_stats

    dev = server.holder.device
    single = server.executor
    star = MESH_TRUTH["star"]
    row_pql, row_cols = MESH_TRUTH["row"]
    lanes = ("lane_reduce", "quant_reduce")
    kinds = {
        "count": [(pql, "repository", want) for pql, want in star.items()],
        "row": [(row_pql, "repository", {"attrs": {}, "columns": row_cols})],
        "bsi": [(pql, "rides", truth[pql]) for pql in (
            'Sum(field="tip")', 'Min(field="tip")', 'Max(field="tip")',
            f"Count(Range(tip > {MESH_TIP_RANGE}))")],
        "topn": [(pql, "rides", truth[pql]) for pql in (
            "TopN(cab_type)", "TopN(cab_type, n=1)")],
        "groupby": [(pql, "rides", want) for pql, want in truth.items()
                    if pql.startswith("GroupBy")],
    }
    stats: dict = {"members": MESH_MEMBERS, "configs": {}}
    t_path = time.perf_counter()
    for groups, quantized in MESH_CONFIGS:
        t_cfg = time.perf_counter()
        mesh = make_mesh(MESH_MEMBERS, devices=[dev], groups=groups)
        ex = DistExecutor(server.holder, mesh, quantized_ranking=quantized,
                          verify_quantized=quantized and groups == 2)
        global_reduce_stats().reset()
        cfg: dict = {"launches": {}, "ms": {}}
        for kind, queries in kinds.items():
            before = kernels.launches()
            reductions = global_reduce_stats().snapshot()["dispatches"]
            t0 = time.perf_counter()
            for pql, index, want in queries:
                got = _mesh_json(ex.execute(index, pql))[0]
                if got != want:
                    fail(f"mesh g={groups}: {pql} = {str(got)[:300]}, "
                         f"oracle {str(want)[:300]}")
                if _mesh_json(single.execute(index, pql))[0] != got:
                    fail(f"mesh g={groups}: {pql} differs from the "
                         "single-device executor")
            cfg["ms"][kind] = 1e3 * (time.perf_counter() - t0) / len(queries)
            after = kernels.launches()
            cfg["launches"][kind] = {k: after[k] - before[k] for k in lanes}
            cfg["launches"][kind]["reductions"] = global_reduce_stats(
            ).snapshot()["dispatches"] - reductions
        # the Counts pipelined: MESH_ROUNDS of each shape, one micro-batch
        # a shape
        before = kernels.launches()
        t0 = time.perf_counter()
        pending = [(pql, d) for _ in range(MESH_ROUNDS)
                   for pql in star
                   for d in ex.submit("repository", pql)]
        for pql, d in pending:
            if d.result() != star[pql]:
                fail(f"mesh g={groups}: submitted {pql} differs")
        cfg["ms"]["count_submit"] = 1e3 * (time.perf_counter() - t0) / len(
            pending)
        after = kernels.launches()
        cfg["launches"]["count_submit"] = {k: after[k] - before[k]
                                           for k in (*lanes, "tree_count")}
        # a micro-batch is one K1 launch a member
        if cfg["launches"]["count_submit"]["tree_count"] >= \
                len(pending) * MESH_MEMBERS:
            fail(f"mesh g={groups}: the submitted Counts did not "
                 "micro-batch")
        # a Set through HTTP between two mesh reads of the leaf it patches
        pql = next(iter(star))  # stargazer 0 AND language 1
        col = _free_bit(star_trace_after(words)[("stargazer", 0)],
                        words[("language", 1)], (100 + groups) % N_SHARDS)
        c = Client(server.port)
        for write, delta in ((f"Set({col}, stargazer=0)", 1),
                             (f"Clear({col}, stargazer=0)", 0)):
            if c.query(write) != [True]:
                fail(f"mesh g={groups}: {write} changed nothing")
            got = _mesh_json(ex.execute("repository", pql))[0]
            if got != star[pql] + delta:
                fail(f"mesh g={groups}: {pql} after {write} = {got}, "
                     f"oracle {star[pql] + delta}")
        c.close()
        snap = global_reduce_stats().snapshot()
        cfg["reduce"] = {k: snap[k] for k in (
            "dispatches", "hier_dispatches", "dense_bytes", "actual_bytes",
            "intra_bytes", "row_gathers", "row_dense_bytes",
            "row_actual_bytes", "quantized_dispatches",
            "quantized_actual_bytes", "quantized_lossless_bytes",
            "quantized_window_rows", "quantized_candidate_rows")}
        if quantized and not (snap["quantized_dispatches"]
                              and snap["quantized_window_rows"]):
            fail(f"mesh g={groups}: the 8-bit lane was not used")
        if quantized and not cfg["launches"]["topn"]["quant_reduce"]:
            fail(f"mesh g={groups}: the quantized TopN launched no "
                 "quant_reduce")
        cfg["s"] = time.perf_counter() - t_cfg
        stats["configs"][f"{groups}x{MESH_MEMBERS // groups}"] = cfg
        print(f"mesh g={groups} quantized={quantized}: {cfg['s']:.1f}s, "
              f"lane launches by kind {json.dumps(cfg['launches'])}, "
              f"reduce bytes dense {snap['dense_bytes']} actual "
              f"{snap['actual_bytes']} (rows {snap['row_dense_bytes']} -> "
              f"{snap['row_actual_bytes']}), window "
              f"{snap['quantized_window_rows']} of "
              f"{snap['quantized_candidate_rows']} candidates, ms a query "
              f"{json.dumps({k: round(v, 3) for k, v in cfg['ms'].items()})}"
              + (f" (Count {cfg['ms']['count']:.3f} ms, submit "
                 f"{cfg['ms']['count_submit']:.3f} ms; M1, before K12+K13 "
                 f"were one kernel: {M1_MESH_COUNT_MS[groups]})"
                 if groups in M1_MESH_COUNT_MS else ""),
              flush=True)
        del ex
    stats["path_s"] = time.perf_counter() - t_path
    return stats


def _build_months(holder) -> None:
    """The pickup_month field, one month (one 128 MiB row) at a time."""
    from pilosa_tpu_torch.storage import load_from_dense

    edges = month_edges()
    buf = np.zeros(N_SHARDS * WORDS, np.uint32)
    for m in range(N_MONTHS):
        range_words(int(edges[m]), int(edges[m + 1]), buf)
        load_from_dense(holder, {"pickup_month": {m: buf}}, index="rides",
                        existence=False)


def _range_count(words: np.ndarray, lo: int, hi: int) -> int:
    """Set bits of ``words`` among the columns [lo, hi)."""
    wlo, whi = lo >> 5, hi >> 5
    mask = np.zeros(whi - wlo + 1, np.uint32)
    range_words(lo - (wlo << 5), hi - (wlo << 5), mask)
    part = words[wlo:whi + 1] if whi < words.size else np.concatenate(
        [words[wlo:], np.zeros(1, np.uint32)])
    return int(np.bitwise_count(part & mask).sum(dtype=np.int64))


def months_truth(rides: dict) -> dict:
    """Each month's rides and its rides of each cab type."""
    t0 = time.perf_counter()
    edges = month_edges()
    cab = [[_range_count(rides["cab"][c], int(edges[m]), int(edges[m + 1]))
            for c in range(3)] for m in range(N_MONTHS)]
    sizes = [int(edges[m + 1] - edges[m]) for m in range(N_MONTHS)]
    print(f"months oracle: {time.perf_counter() - t0:.1f}s", flush=True)
    return {"sizes": sizes, "cab": cab, "edges": edges}


def _topn(counts) -> list:
    pairs = [{"id": c, "count": int(n)} for c, n in enumerate(counts) if n]
    return sorted(pairs, key=lambda p: (-p["count"], p["id"]))[:3]


def tier_shapes(rng, mt: dict) -> tuple[list, dict]:
    """TIER_CLIENTS x TIER_PER_CLIENT queries, a third of each shape:
    the month x cab Count (m over 84, c over 3), the quarter's Count (m
    over 0..81: the quarter's last month is 83 at most) and the month's
    TopN(cab_type); with their answers."""
    shapes, truth = [], {}
    for i in range(TIER_CLIENTS * TIER_PER_CLIENT):
        m, c = int(rng.integers(0, N_MONTHS)), int(rng.integers(0, 3))
        if i % 3 == 0:
            pql = (f"Count(Intersect(Row(pickup_month={m}), "
                   f"Row(cab_type={c})))")
            want = mt["cab"][m][c]
        elif i % 3 == 1:
            m = min(m, N_MONTHS - 3)
            pql = (f"Count(Union(Row(pickup_month={m}), "
                   f"Row(pickup_month={m + 1}), Row(pickup_month={m + 2})))")
            want = sum(mt["sizes"][m:m + 3])
        else:
            pql = f"TopN(cab_type, Row(pickup_month={m}), n=3)"
            want = _topn(mt["cab"][m])
        shapes.append(pql)
        truth[pql] = want
    return shapes, truth


def _month_key(m: int, store) -> tuple | None:
    for k in list(store):
        if k[0] == "stack" and k[3] == "pickup_month" and k[5] == m:
            return k
    return None


def _memo_a_month(c, mt: dict) -> None:
    """Month 0's Count twice: the second assembly is stored in the
    operand memo, which then holds a dense month leaf into the pass."""
    for _ in range(2):
        if c.query("Count(Row(pickup_month=0))") != [mt["sizes"][0]]:
            fail("Count(Row(pickup_month=0)) before a tier pass")


def _tier_pass(cache, executor, scope: str, stats: dict, name: str) -> None:
    """One ResidencyTierer pass (no thread) with a demote_heat above
    every field's heat: every stacked leaf of rides moves to host, and
    the device memory of each leaf it demotes is freed (the executor's
    operand memo, cleared at each demotion, holds none of them)."""
    import gc

    import torch

    from pilosa_tpu_torch.storage.heat import global_heat
    from pilosa_tpu_torch.storage.tiering import ResidencyTierer

    rows = global_heat().snapshot()["shards"]
    month = max(r["access"] + r["writes"] for r in rows
                if r.get("scope", "") == scope
                and r["field"] == "pickup_month")
    demote = max(r["access"] + r["writes"] for r in rows) + 1.0
    tierer = ResidencyTierer(cache, demote_heat=demote,
                             promote_heat=2 * demote, min_dwell_s=0)
    read0 = cache.readback_bytes
    on_card = cache.device.type == "cuda"
    memo_before = len(executor._operand_memo)
    if not memo_before:
        fail(f"tier pass {name}: the operand memo held no leaf before it")
    gc.collect()  # what only a reference cycle keeps is not the memo's
    alloc0 = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    out = tierer.run_pass()
    secs = time.perf_counter() - t0
    readback = cache.readback_bytes - read0
    # the generation bump at each demotion cleared the executor's operand
    # memo: the demoted leaves' device memory is free, none held by it
    if executor._operand_memo:
        fail(f"tier pass {name}: the operand memo kept "
             f"{len(executor._operand_memo)} entries")
    gc.collect()
    freed = (alloc0 - torch.cuda.memory_allocated()) if on_card else 0
    held = out["demotedBytes"] - freed
    if on_card and held >= N_SHARDS * WORDS * 2:  # half a month leaf
        fail(f"tier pass {name}: {out['demotedBytes']} bytes demoted, "
             f"{freed} freed on the card (memory_allocated)")
    _, per_stack = cache.tier_overlay()
    months = per_stack.get((scope, "rides", "pickup_month"))
    if months is None or months["dense"] or months["compressed"] \
            or not months["host"] or not out["demoted"]:
        fail(f"tier pass {name} left month stacks on the card: {months} "
             f"{out}")
    stats[name] = {"month_heat": month, "demote_heat": demote,
                   "seconds": secs, "demoted": out["demoted"],
                   "demoted_bytes": out["demotedBytes"],
                   "freed_bytes": freed, "memo_entries_before": memo_before,
                   "readback_bytes": readback,
                   "month_host_bytes": months["host"]}
    print(f"tier {name}: {out['demoted']} entries, {out['demotedBytes']} "
          f"device bytes to host in {secs:.3f}s, {readback} bytes read "
          f"back (month heat {month:.1f}, demote-heat {demote:.1f}); "
          f"month stacks {months['host']} host bytes; {freed} bytes freed "
          f"on the card, {memo_before} operand-memo entries before it, "
          "none after", flush=True)


def _serve_tier(server, mt: dict, rng) -> dict:
    """Phase 4f: the residency tiers on the 84-month path. The server's
    budget is lowered so that at most TIER_DENSE_MONTHS month leaves stay
    dense beside the cab_type leaves and TopN's matrix; 16 clients send
    the three shapes (K10 demotes, K11 promotes); a Count of every month
    puts each on the card, and the same traffic runs again without first
    touches; one tierer pass moves the month stacks to host; 84 serial Counts are host-tier hits (an
    upload and a K11 launch each); a Set into a host-tier month leaf
    invalidates its copy and a Set into a dense one is one K3 launch,
    after which that leaf is dropped rather than compressed; every
    answer against the oracle. The budget is restored afterwards."""
    from pilosa_tpu_torch import kernels

    cache = server.holder.cache
    scope = server.holder.index("rides").scope
    leaf = N_SHARDS * WORDS * 4
    # a month's compressed copy: its ~391 nonzero blocks padded to 512
    per_month = N_SHARDS * WORDS // N_MONTHS // 1024 + 2
    compressed = (1 << (per_month - 1).bit_length()) * (4096 + 4)
    budget0 = cache.budget_bytes
    cache.budget_bytes = (3 + TIER_MATRIX_ROWS + TIER_DENSE_MONTHS) * leaf \
        + N_MONTHS * compressed
    stats: dict = {"budget_bytes": cache.budget_bytes}
    c = Client(server.port, "rides")
    t_path = time.perf_counter()
    try:
        shapes, truth = tier_shapes(rng, mt)
        m0 = cache.metrics()
        lat, wall = closed_loop(server.port, "rides", shapes, truth,
                                TIER_CLIENTS, TIER_PER_CLIENT,
                                stride=TIER_PER_CLIENT)
        stats.update(_latency_stats(lat, wall))
        m1 = cache.metrics()
        for k in ("compressions", "decompressions", "evictions"):
            stats[k] = m1[f"residency_{k}"] - m0[f"residency_{k}"]
        stats["compressed_bytes"] = cache.compressed_bytes
        stats["loop_launches"] = {k: kernels.launches()[k] for k in
                                  ("block_gather", "block_gather_batch",
                                   "block_scatter")}
        print(f"tier loop: {stats['qps']:.3f} QPS, p50 "
              f"{stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms; "
              f"compressions {stats['compressions']}, decompressions "
              f"{stats['decompressions']}, evictions {stats['evictions']}, "
              f"compressed bytes {stats['compressed_bytes']}; launches "
              f"{stats['loop_launches']}", flush=True)
        if not stats["compressions"] or not stats["decompressions"]:
            fail(f"the tier loop compressed {stats['compressions']} and "
                 f"promoted {stats['decompressions']} leaves")

        # every month on the card (dense or compressed) before the pass
        for m in range(N_MONTHS):
            if c.query(f"Count(Row(pickup_month={m}))") != [mt["sizes"][m]]:
                fail(f"Count(Row(pickup_month={m})) = wrong before the pass")
        # the same traffic again, every month on the card: the tiers'
        # churn (K10 demotions, K11 promotions) without first touches
        shapes, truth = tier_shapes(rng, mt)
        m0 = cache.metrics()
        lat, wall = closed_loop(server.port, "rides", shapes, truth,
                                TIER_CLIENTS, TIER_PER_CLIENT,
                                stride=TIER_PER_CLIENT)
        m1 = cache.metrics()
        warm = stats["warm"] = _latency_stats(lat, wall)
        for k in ("compressions", "decompressions", "evictions", "misses"):
            warm[k] = m1[f"residency_{k}"] - m0[f"residency_{k}"]
        print(f"tier warm loop: {warm['qps']:.3f} QPS, p50 "
              f"{warm['p50_ms']:.3f} ms, p99 {warm['p99_ms']:.3f} ms; "
              f"compressions {warm['compressions']}, decompressions "
              f"{warm['decompressions']}, evictions {warm['evictions']}, "
              f"misses {warm['misses']}", flush=True)
        _memo_a_month(c, mt)
        _tier_pass(cache, server.api.executor, scope, stats, "pass_1")
        h0 = cache.host_hits
        k11 = kernels.launches()["block_scatter"]
        times = []
        for m in range(N_MONTHS):
            t0 = time.perf_counter()
            got = c.query(f"Count(Row(pickup_month={m}))")[0]
            times.append(time.perf_counter() - t0)
            if got != mt["sizes"][m]:
                fail(f"Count(Row(pickup_month={m})) = {got} after the tier "
                     f"pass, oracle {mt['sizes'][m]}")
        stats["host_hits"] = cache.host_hits - h0
        stats["host_count_p50_ms"] = 1e3 * sorted(times)[len(times) // 2]
        stats["host_count_k11"] = kernels.launches()["block_scatter"] - k11
        print(f"tier host hits: {stats['host_hits']} of {N_MONTHS} serial "
              f"Counts, p50 {stats['host_count_p50_ms']:.3f} ms, K11 "
              f"{stats['host_count_k11']}", flush=True)
        if stats["host_hits"] < N_MONTHS or stats["host_count_k11"] < N_MONTHS:
            fail(f"only {stats['host_hits']} of the {N_MONTHS} Counts after "
                 "the tier pass were host-tier hits")

        # the writes: B in the host tier, A dense
        _memo_a_month(c, mt)
        _tier_pass(cache, server.api.executor, scope, stats, "pass_2")
        edges, sizes = mt["edges"], mt["sizes"]
        if c.query(f"Count(Row(pickup_month={MONTH_A}))") != [sizes[MONTH_A]]:
            fail(f"Count(Row(pickup_month={MONTH_A})) before the writes")
        key_a = _month_key(MONTH_A, cache._rows)
        key_b = _month_key(MONTH_B, cache._host)
        if key_a is None or key_b is None:
            fail("month A is not dense or month B not in the host tier")
        before = _k3(kernels)
        if c.query(f"Set({int(edges[MONTH_A]) + 12345}, "
                   f"pickup_month={MONTH_B})") != [True]:
            fail("the Set into the host-tier month leaf changed nothing")
        stats["host_set_k3_launches"] = _k3(kernels) - before
        if key_b in cache._host or stats["host_set_k3_launches"]:
            fail("the Set into a host-tier leaf did not invalidate its copy")
        before = _k3(kernels)
        if c.query(f"Set({int(edges[MONTH_B]) + 777}, "
                   f"pickup_month={MONTH_A})") != [True]:
            fail("the Set into the dense month leaf changed nothing")
        stats["dense_set_k3_launches"] = _k3(kernels) - before
        if stats["dense_set_k3_launches"] != 1 or \
                cache._block_idx.get(key_a, 0) is not None:
            fail(f"the Set into a dense leaf made "
                 f"{stats['dense_set_k3_launches']} K3 launches")
        got = c.query(f"Count(Row(pickup_month={MONTH_A})) "
                      f"Count(Row(pickup_month={MONTH_B}))")
        if got != [sizes[MONTH_A] + 1, sizes[MONTH_B] + 1]:
            fail(f"the month Counts after the writes: {got}")
        ev0 = cache.evictions
        sweep = [m for m in range(N_MONTHS)
                 if m not in (MONTH_A, MONTH_B)][:TIER_SWEEP]
        for m in sweep:
            if c.query(f"Count(Row(pickup_month={m}))") != [sizes[m]]:
                fail(f"Count(Row(pickup_month={m})) after the writes")
        if key_a in cache._rows or key_a in cache._compressed:
            fail("the patched month leaf was kept, not dropped")
        stats["sweep_evictions"] = cache.evictions - ev0
        got = c.query(f"Count(Row(pickup_month={MONTH_A})) "
                      f"Count(Intersect(Row(pickup_month={MONTH_B}), "
                      f"Row(pickup_month={MONTH_A})))")
        if got != [sizes[MONTH_A] + 1, 2]:
            fail(f"Count(Row(pickup_month={MONTH_A})) re-decoded: {got}")
        stats["residency"] = cache.metrics()
        stats["path_s"] = time.perf_counter() - t_path
        print(f"tier writes: host-tier Set {stats['host_set_k3_launches']} "
              f"K3, dense Set {stats['dense_set_k3_launches']} K3, the "
              f"patched leaf dropped (sweep evictions "
              f"{stats['sweep_evictions']}); the path {stats['path_s']:.1f}s",
              flush=True)
    finally:
        c.close()
        cache.budget_bytes = budget0
    return stats


# ------------------------------------------------------------ data dirs

# Host data the data-dir builders read: set before they fork, so each
# worker process inherits it instead of receiving a pickled copy.
_BUILD_DATA: dict = {}
# one worker each, all at once; "existence" writes the indexes' _exists
# rows straight into the data dir, the others a field each into a part
# ------------------------------------------------------------ integrity path

# The integrity path: rides' cab_type and pickup_year over the first
# INTEG_SHARDS shards, copied into a directory of its own. A scrub pass is
# serial host work (blake2b over 8 bytes a set bit): 507 fragments took
# 18-25 s on the host of an NVIDIA H100 80GB HBM3 machine, so 64 shards
# keep each of the path's two passes near 5 s where the full 1024 would
# take ~80 s of the script's 1200 (256 shards until a run passed 1 100 s,
# then 128 until one on a slow host passed 1 200 s).
INTEG_SHARDS = 64
INTEG_FIELDS = ("cab_type", "pickup_year")
INTEG_CLIENTS = 16
INTEG_WINDOW_S = 1.0      # 5.0, then 3.0, before the run passed 1 100 s,
#                           2.0 until multi-process serving
INTEG_PAIRS = ((0, 2009), (1, 2012), (2, 2016), (0, 2015))


def integrity_words(rides: dict, taxi: dict) -> dict:
    """{(field, row): uint32 words} of cab_type and pickup_year over the
    integrity path's shards: the host words the data dir was built from,
    cut to those shards (copies: the path's writes update them)."""
    n = INTEG_SHARDS * WORDS
    out = {("cab_type", r): w[:n].copy() for r, w in rides["cab"].items()}
    base, p = TAXI_FIELDS["pickup_year"]
    rows = category_rows(taxi["pickup_year"][:n * 32], len(p))
    out.update({("pickup_year", base + k): w for k, w in rows.items()})
    return out


def _integ_truth(words: dict, shards=None) -> dict:
    """The path's query shapes and their answers from ``words``."""
    def cut(w):
        return w if shards is None else \
            w.reshape(INTEG_SHARDS, WORDS)[list(shards)]

    def count(w) -> int:
        return int(np.bitwise_count(cut(w)).sum(dtype=np.int64))
    truth = {f"Count(Intersect(Row(cab_type={a}), Row(pickup_year={b})))":
             count(words[("cab_type", a)] & words[("pickup_year", b)])
             for a, b in INTEG_PAIRS}
    truth["TopN(cab_type)"] = _pairs(
        [count(words[("cab_type", r)]) for r in range(3)], range(3))
    return truth


def _set_bit(words: np.ndarray, col: int) -> None:
    words[col >> 5] |= np.uint32(1 << (col & 31))


def _last_clear(words: np.ndarray) -> int:
    """The highest column whose bit is clear in ``words``."""
    i = int(np.flatnonzero(words != np.uint32(0xFFFFFFFF))[-1])
    return i * 32 + ((~int(words[i])) & 0xFFFFFFFF).bit_length() - 1


def _copy_integrity_dir(data_dir: Path, out: Path) -> None:
    """rides' schema and the two fields' fragments of shards 0 to
    INTEG_SHARDS - 1, with their .checksums and .cache sidecars."""
    src = data_dir / "rides"
    (out / "rides").mkdir(parents=True)
    shutil.copy(src / ".meta", out / "rides" / ".meta")
    for field in INTEG_FIELDS:
        frags = out / "rides" / field / "views" / "standard" / "fragments"
        frags.mkdir(parents=True)
        shutil.copy(src / field / ".meta", out / "rides" / field / ".meta")
        have = src / field / "views" / "standard" / "fragments"
        for s in range(INTEG_SHARDS):
            for suffix in ("", ".checksums", ".cache"):
                if (have / f"{s}{suffix}").exists():
                    shutil.copy(have / f"{s}{suffix}", frags / f"{s}{suffix}")


def _flip_byte(path: Path, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x10]))


def _rot_integrity_dir(root: Path, rng) -> dict:
    """Four payload flips (two a field, one shard rotten in both), one
    fragment torn mid-container and one .checksums deleted (not rot),
    on distinct shards drawn from ``rng``; returns what was done."""
    q, c2, p2, torn, bare = (int(s) for s in rng.choice(INTEG_SHARDS, 5,
                                                        replace=False))

    def frag(field, s):
        return (root / "rides" / field / "views" / "standard" / "fragments"
                / str(s))
    for field, s in (("cab_type", q), ("pickup_year", q), ("cab_type", c2),
                     ("pickup_year", p2)):
        _flip_byte(frag(field, s), frag(field, s).stat().st_size - 3)
    with open(frag("cab_type", torn), "r+b") as f:
        f.truncate(frag("cab_type", torn).stat().st_size // 2)
    (root / "rides" / "pickup_year" / "views" / "standard" / "fragments"
     / f"{bare}.checksums").unlink()
    return {"both": q, "cab_type": [q, c2, torn], "pickup_year": [q, p2],
            "bare": bare}


def _drop_shards(words: dict, rot: dict) -> None:
    """The quarantined fragments' bits out of the oracle words."""
    for (field, _), w in words.items():
        v = w.reshape(INTEG_SHARDS, WORDS)
        for s in rot[field]:
            v[s] = 0


def timed_loop(port: int, index: str, shapes: list, truth: dict,
               n_clients: int, seconds: float, until=None) -> list:
    """``n_clients`` keep-alive clients sending ``shapes`` round robin for
    ``seconds`` (or until the event ``until`` is set, if sooner), every
    answer held against ``truth``; the latencies."""
    errors, latencies = [], []
    lock = threading.Lock()
    stop = time.perf_counter() + seconds

    def client(k: int) -> None:
        c = Client(port, index)
        try:
            j = k
            while time.perf_counter() < stop and not (
                    until is not None and until.is_set()):
                pql = shapes[j % len(shapes)]
                t = time.perf_counter()
                got = c.query(pql)[0]
                dt = time.perf_counter() - t
                with lock:
                    latencies.append(dt)
                    if got != truth[pql]:
                        errors.append((pql, got))
                j += 1
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail(f"a client on {index} hung")
    if errors or not latencies:
        fail(f"concurrent queries on {index} wrong or missing: {errors[:3]}")
    return latencies


def _http(port: int, method: str, path: str, body: bytes = b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body if method == "POST" else None)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def _p50_ms(latencies: list) -> float:
    return 1e3 * sorted(latencies)[len(latencies) // 2]


def _check_integ(c, truth: dict, what: str) -> None:
    for pql, want in truth.items():
        got = c.query(pql)[0]
        if got != want:
            fail(f"integrity path ({what}): {pql} answered {got}, the "
                 f"oracle {want}")


def run_integrity_phase(data_dir: Path, scratch: Path, words: dict,
                        seed: int, kernels) -> dict:
    """The integrity path on the card over a copy of rides' cab_type and
    pickup_year at INTEG_SHARDS shards: rot before the open (quarantined
    at open, the answers the oracle without those fragments), rot under a
    resident leaf (``check --host`` self-heals it, the leaf kept), an
    injected ENOSPC on the WAL's fsync (writes shed with no K3 launch,
    reads answering, the probe recovering, one K3 launch after), then
    ``check -d`` offline and a reopen. Returns its numbers."""
    from pilosa_tpu_torch.executor import Executor, result_to_json
    from pilosa_tpu_torch.server import Server
    from pilosa_tpu_torch.storage import Holder
    from pilosa_tpu_torch.storage.integrity import (
        global_integrity,
        list_quarantined,
    )
    from pilosa_tpu_torch.testing import faults

    repo = Path(__file__).resolve().parent
    root = scratch / "integrity"
    stats: dict = {}
    t0 = time.perf_counter()
    _copy_integrity_dir(data_dir, root)
    stats["copy_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 12)
    rot = _rot_integrity_dir(root, rng)
    _drop_shards(words, rot)
    stats["rot"] = rot

    # 1. rot before the open: quarantined at open, never served
    before = global_integrity().metrics()
    t0 = time.perf_counter()
    server = Server(str(root), bind="127.0.0.1", port=0).open()
    stats["open_s"] = time.perf_counter() - t0
    print(f"integrity: server open with verify-on-load over "
          f"{2 * INTEG_SHARDS} fragments: {stats['open_s']:.2f}s", flush=True)
    try:
        after = global_integrity().metrics()
        got = {k: after[f"integrity_{k}_total"]
               - before[f"integrity_{k}_total"]
               for k in ("quarantined", "verify_failures")}
        quarantined = list_quarantined(str(root))
        if got != {"quarantined": 5, "verify_failures": 5} or \
                len(quarantined) != 5:
            fail(f"integrity: the open quarantined {got}, {quarantined}")
        c = Client(server.port, "rides")
        truth = _integ_truth(words)
        _check_integ(c, truth, "after the open")
        q = rot["both"]
        for shards in ([q], [rot["cab_type"][1], rot["bare"]],
                       [rot["bare"]]):
            opts = f"shards=[{', '.join(map(str, shards))}]"
            sub = _integ_truth(words, shards)
            for pql in list(sub)[:2] + ["TopN(cab_type)"]:
                got = c.query(f"Options({pql}, {opts})")[0]
                if got != sub[pql]:
                    fail(f"integrity: Options({pql}, {opts}) answered "
                         f"{got}, the oracle {sub[pql]}")

        # 2. rot under a resident leaf: a live check heals it in place
        healed = sorted(set(range(INTEG_SHARDS))
                        - set(rot["cab_type"]) - {rot["bare"]})[0]
        path = (root / "rides" / "cab_type" / "views" / "standard"
                / "fragments" / str(healed))
        misses = server.holder.cache.misses
        _flip_byte(path, path.stat().st_size - 3)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch", "check", "--host",
             f"http://127.0.0.1:{server.port}"], cwd=repo,
            capture_output=True, text=True, timeout=600)
        stats["check_host_s"] = time.perf_counter() - t0
        if res.returncode != 0 or "self_healed=1" not in res.stdout:
            fail(f"integrity: check --host exited {res.returncode}: "
                 f"{res.stdout!r} {res.stderr[-2000:]!r}")
        scrubber = server.api.scrubber
        stats["heal_pass"] = {"line": res.stdout.strip(),
                              "wall_s": scrubber.last_pass_s,
                              "bytes": scrubber.bytes_scanned}
        if not Path(f"{path}.quarantine-0").exists():
            fail("integrity: the healed fragment left no .quarantine-0")
        _check_integ(c, truth, "after the self-heal")
        if server.holder.cache.misses != misses:
            fail("integrity: the heal cost "
                 f"{server.holder.cache.misses - misses} row-cache misses "
                 "(the resident leaf was dropped)")
        shapes = list(truth)
        quiet = timed_loop(server.port, "rides", shapes, truth,
                           INTEG_CLIENTS, INTEG_WINDOW_S)
        box: dict = {}
        scrub = threading.Thread(target=lambda: box.setdefault(
            "r", _http(server.port, "POST", "/internal/scrub")))
        scrub.start()
        busy = timed_loop(server.port, "rides", shapes, truth,
                          INTEG_CLIENTS, INTEG_WINDOW_S)
        scrub.join(timeout=900)
        status, _, body = box["r"]
        rec = json.loads(body)
        if status != 200 or rec["corrupt"] != 0:
            fail(f"integrity: the second scrub answered {status} {rec}")
        stats["scrub"] = {k: rec[k] for k in ("scanned", "bytes", "wall_s")}
        stats["scrub"]["mb_per_s"] = rec["bytes"] / 1e6 / rec["wall_s"]
        stats["heal_pass"]["mb_per_s"] = (stats["heal_pass"]["bytes"] / 1e6
                                          / stats["heal_pass"]["wall_s"])
        stats["count_p50_ms"] = {"without_pass": _p50_ms(quiet),
                                 "during_pass": _p50_ms(busy)}
        stats["count_queries"] = {"without_pass": len(quiet),
                                  "during_pass": len(busy)}
        print(f"integrity: scrub pass {stats['scrub']}; Count p50 "
              f"{stats['count_p50_ms']}", flush=True)

        # 3. degraded and back: ENOSPC on every fsync under the data dir
        plane = faults.install_disk()
        rule = plane.add("fsync", path=str(root), errno_=errno.ENOSPC)
        # the last clear bits of rows 1 and 2: each Set changes a bit
        lost_col = _last_clear(words[("cab_type", 1)])
        acked_col = _last_clear(words[("cab_type", 2)])
        status, _, body = _http(server.port, "POST", "/index/rides/query",
                                f"Set({lost_col}, cab_type=1)".encode())
        stats["lost_set_status"] = status
        print(f"integrity: the Set whose fsync failed answered {status} "
              f"{body[:200]!r}", flush=True)
        if status == 200:
            fail("integrity: a write whose fsync failed was acknowledged")
        lost_seq = server.holder.wal.current_seq()
        _set_bit(words[("cab_type", 1)], lost_col)  # served until restart
        truth = _integ_truth(words)
        st = json.loads(_http(server.port, "GET", "/status")[2])
        if not st["storageDegraded"] or \
                "No space left" not in st["storageDegradedReason"]:
            fail(f"integrity: /status under ENOSPC: {st}")
        patches = kernels.launches()["word_patch"]
        for path_, body in (("/index/rides/query",
                             f"Set({acked_col}, cab_type=2)".encode()),
                            ("/index/j", b"{}")):
            status, retry, resp = _http(server.port, "POST", path_, body)
            if status != 503 or not retry:
                fail(f"integrity: {path_} while degraded answered {status} "
                     f"Retry-After {retry}: {resp[:200]!r}")
        degraded = timed_loop(server.port, "rides", shapes, truth,
                              INTEG_CLIENTS, 1.0)
        if kernels.launches()["word_patch"] != patches:
            fail("integrity: a refused write launched K3")
        plane.remove(rule.id)
        t0 = time.perf_counter()
        while json.loads(_http(server.port, "GET", "/status")[2])[
                "storageDegraded"]:
            if time.perf_counter() - t0 > 10:
                fail("integrity: the probe did not clear within 10 s")
            time.sleep(0.01)
        stats["recovery_s"] = time.perf_counter() - t0
        status, _, body = _http(server.port, "POST", "/index/rides/query",
                                f"Set({acked_col}, cab_type=2)".encode())
        if (status, json.loads(body)["results"]) != (200, [True]):
            fail(f"integrity: the Set after recovery answered {status} "
                 f"{body!r}")
        if kernels.launches()["word_patch"] != patches + 1:
            fail("integrity: the Set after recovery made "
                 f"{kernels.launches()['word_patch'] - patches} K3 launches")
        _set_bit(words[("cab_type", 2)], acked_col)
        truth = _integ_truth(words)
        _check_integ(c, truth, "after the recovery")
        m = server.api.integrity_metrics()
        if (m["storage_degraded"], m["storage_degraded_total"],
                m["storage_recoveries_total"]) != (0, 1, 1):
            fail(f"integrity: metrics after the recovery {m}")
        try:
            server.holder.wal.barrier(lost_seq)
        except OSError:
            pass
        else:
            fail("integrity: the lost write's barrier returned")
        stats["degraded_queries"] = len(degraded)
        print(f"integrity: degraded Count p50 {_p50_ms(degraded):.3f} ms "
              f"over {len(degraded)} queries; probe recovery "
              f"{stats['recovery_s']:.3f}s", flush=True)
        c.close()
    finally:
        faults.clear_disk()
        server.close()

    # 4. offline check, then a reopen on the card
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch", "check",
                          "-d", str(root)], cwd=repo, capture_output=True,
                         text=True, timeout=900)
    stats["check_d_s"] = time.perf_counter() - t0
    ok = [ln for ln in res.stdout.splitlines() if ln.startswith("ok: ")]
    qlines = [ln for ln in res.stderr.splitlines()
              if ln.startswith("QUARANTINED: ")]
    frags = [p for p in root.glob("rides/*/views/*/fragments/*")
             if p.name.isdigit()]
    if res.returncode != 1 or len(qlines) != 6 or "CORRUPT:" in res.stderr \
            or len(ok) != len(frags):
        fail(f"integrity: check -d exited {res.returncode} with {len(ok)} "
             f"ok of {len(frags)}, {len(qlines)} quarantined: "
             f"{res.stderr[-2000:]!r}")
    print(f"integrity: check -d {stats['check_d_s']:.2f}s, {len(ok)} ok, "
          f"{len(qlines)} quarantined", flush=True)
    t0 = time.perf_counter()
    holder = Holder(str(root)).open()
    stats["reopen_s"] = time.perf_counter() - t0
    try:
        ex = Executor(holder)
        for pql, want in truth.items():
            got = result_to_json(ex.execute("rides", pql))[0]
            if got != want:
                fail(f"integrity: after the reopen {pql} answered {got}, "
                     f"the oracle {want}")
        frag = holder.index("rides").field("cab_type").view(
            "standard").fragment(INTEG_SHARDS - 1)
        for col, row in ((lost_col, 1), (acked_col, 2)):
            # the lost write too: applied in memory, the clean close
            # snapshotted it, as the reference's does
            if not frag.contains(row, col & (WORDS * 32 - 1)):
                fail(f"integrity: Set({col}, cab_type={row}) is gone after "
                     "the reopen")
    finally:
        holder.close()
    return stats


EVENT_JOBS = ("events-0", "events-1", "events-2")  # the time field's views
DATA_JOBS = ("repository", "rides", *TAXI_FIELDS, *EVENT_JOBS, "events-kind",
             "existence")


def event_view_groups(job: str) -> list:
    """The time views one events job writes, as (event-hours, view names)
    groups: views over the same event-hours hold the same bits (a day or
    a month of one event-hour equals its hour), so a group is built once
    and its files copied to the other names. The groups are dealt to the
    jobs by their hours, largest first, each to the least loaded job."""
    by_hours: dict = {}
    for name, hours in event_views().items():
        by_hours.setdefault(tuple(hours), []).append(name)
    load = {j: 0 for j in EVENT_JOBS}
    mine = []
    for hours, names in sorted(by_hours.items(), key=lambda g: -len(g[0])):
        j = min(load, key=load.get)
        load[j] += 4 + len(hours)  # a view's fixed cost, then its bits
        if j == job:
            mine.append((hours, names))
    return mine


def _category_words(cat: np.ndarray, n_rows: int) -> np.ndarray:
    """uint32 words of the rides that hold a category below n_rows (each
    of them sits in one of the field's rows)."""
    return np.packbits(cat < n_rows, bitorder="little").view("<u4")


def _build_part(job: str, out_dir: str) -> float:
    """Write one job's part of the data dir through a Holder on the CPU
    (in a worker process); returns its seconds."""
    from pilosa_tpu_torch.storage import FieldOptions, Holder, \
        load_existence, load_from_dense

    t0 = time.perf_counter()
    words, rides, taxi, events, users = (_BUILD_DATA[k] for k in (
        "words", "rides", "taxi", "events", "users"))
    holder = Holder(out_dir, device="cpu").open()
    if job == USERS_JOB:
        # the keyed index: its column keys, then its keyed rows, written
        # to this part's translate log
        load_from_dense(holder, {"segment": users["segments"]},
                        options={"segment": FieldOptions(keys=True)},
                        index="users", column_keys=users["keys"])
    if job == PAYMENT_JOB:
        rows = category_rows(taxi["payment_type"], len(PAYMENT_TYPES))
        load_from_dense(holder, {"payment_type": {
            PAYMENT_TYPES[k][0]: rows[k] for k in range(len(PAYMENT_TYPES))}},
            options={"payment_type": FieldOptions(type="mutex", keys=True)},
            index="rides", existence=False)
    if job == "repository":
        fields: dict = {}
        for (f, r), w in words.items():
            fields.setdefault(f, {})[r] = w
        load_from_dense(holder, fields, index="repository", existence=False)
    if job == MONTH_JOB:
        _build_months(holder)
    elif job == "rides":
        load_from_dense(holder, {"cab_type": rides["cab"]}, index="rides",
                        int_fields={"fare": (0, FARE_MAX, rides["fare"])},
                        existence=False)
    elif job == "existence":
        rep = np.zeros(N_SHARDS * WORDS, np.uint32)
        for w in words.values():
            rep |= w
        load_existence(holder, rep, index="repository")
        del rep
        ride = rides["fare"][0].copy()  # an int field marks its exists row
        for w in rides["cab"].values():
            ride |= w
        for field, (_, p) in TAXI_FIELDS.items():
            ride |= _category_words(taxi[field], len(p))
        load_existence(holder, ride, index="rides")
        del ride
        # every column of events is in one kind row
        load_existence(holder, np.full(N_SHARDS * WORDS, 0xFFFFFFFF,
                                       np.uint32), index="events")
    elif job == "events-kind":
        load_from_dense(holder, {"kind": events["kind"],
                                 "active": events["active"]},
                        options={"kind": FieldOptions(type="mutex"),
                                 "active": FieldOptions(type="bool")},
                        index="events", existence=False)
    elif job in EVENT_JOBS:
        t_opts = {"t": FieldOptions(type="time", time_quantum="YMDH")}
        groups = event_view_groups(job)
        for hours, names in groups:
            rows = {r: _or_hours(events, hours, r)
                    for r in range(len(EVENT_ROW_LOG2))}
            load_from_dense(holder, {}, views={"t": {names[0]: rows}},
                            options=t_opts, index="events", existence=False)
        holder.close()  # the copies take the .cache sidecars written here
        views = Path(out_dir) / "events" / "t" / "views"
        for _, names in groups:
            for name in names[1:]:
                shutil.copytree(views / names[0], views / name)
        return time.perf_counter() - t0
    else:
        row0, p = TAXI_FIELDS[job]
        rows = category_rows(taxi[job], len(p))
        load_from_dense(holder, {job: {row0 + k: w for k, w in rows.items()}},
                        index="rides", existence=False)
    holder.close()
    return time.perf_counter() - t0


def _with_seconds(fn, *args):
    """(fn(*args), its seconds)."""
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def start_data_dirs(scratch: Path, words: dict, rides: dict, taxi: dict,
                    events: dict, users: dict):
    """Fork one worker per DATA_JOBS entry to build the data dir in
    parallel: each field into its own part directory under ``scratch``,
    the existence rows into ``scratch / "data"``. Returns the executor
    with each job's future as ``.jobs``."""
    _BUILD_DATA.update(words=words, rides=rides, taxi=taxi, events=events,
                       users=users)
    builders = ProcessPoolExecutor(len(DATA_JOBS),
                                   mp_context=multiprocessing.get_context(
                                       "fork"))
    builders.jobs = {
        job: builders.submit(_build_part, job, str(
            scratch / ("data" if job == "existence" else f"part-{job}")))
        for job in DATA_JOBS}
    return builders


def finish_data_dirs(builders, scratch: Path, data_dir: Path) -> None:
    """Wait for every builder, then move each part's fields into the data
    dir (renames within one file system; an index only a part holds moves
    whole) and append each part's translate log to the data dir's (the
    parts translate disjoint namespaces, so the logs concatenate into
    the union of their keys)."""
    for job, fut in builders.jobs.items():
        try:
            secs = fut.result()
        except Exception as exc:  # a failed build fails the run
            fail(f"data dir job {job} failed: {exc!r}")
        print(f"data dir {job}: {secs:.1f}s", flush=True)
    builders.shutdown()
    _BUILD_DATA.clear()
    log = open(data_dir / ".translate.log", "ab")
    for job in DATA_JOBS:
        part = scratch / f"part-{job}"
        if job == "existence":
            continue
        log.write((part / ".translate.log").read_bytes())
        for index in os.listdir(part):
            if index.startswith("."):
                continue  # the WAL and the translate log
            if not (data_dir / index).exists():
                os.rename(part / index, data_dir / index)
                continue
            for field in os.listdir(part / index):
                src, dst = part / index / field, data_dir / index / field
                if not src.is_dir() or field.startswith("_"):
                    continue
                if not dst.exists():
                    os.rename(src, dst)
                    continue
                # a field built in parts (the time field's views)
                for view in os.listdir(src / "views"):
                    os.rename(src / "views" / view, dst / "views" / view)
        shutil.rmtree(part)
    log.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--verify-on-load", action="store_true",
                    help="open the server as the port does by default, "
                    "verifying every fragment's .checksums, and time it")
    args = ap.parse_args()
    t_run = time.perf_counter()

    if not (Path(__file__).resolve().parent / "pilosa_tpu_torch").is_dir():
        print("chip_smoke: pilosa_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the server keeps every fragment file open: about 61 000 of them with
    # the time path's views
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard == resource.RLIM_INFINITY:
        hard = 1 << 20
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    print(f"open files: soft limit {soft} raised to {hard}", flush=True)
    from pilosa_tpu_torch import kernels, native
    from pilosa_tpu_torch.executor import batch
    from pilosa_tpu_torch.native import build as native_build

    # the host helpers (row decodes, small write merges, packing) must run
    # natively here: the numpy fallback is not what a card run measures
    t0 = time.perf_counter()
    if not native.available():
        fail("the fastbits host library did not build or load (g++ is "
             "needed beside nvcc); its numpy fallback is not measured")
    print(f"native: fastbits active, {native_build.lib_path().name} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

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
        if log.name.startswith(("libtree_count", "libbsi_minmax")):
            continue  # printed per instance below
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.name.split('-')[0]}: {line.strip()}")
    print_ptxas(kernels, "tree_count")
    print_ptxas(kernels, "bsi_minmax")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    # the events and keys data come from generators of their own (seeded
    # from --seed), so they are drawn in threads beside the Star-Trace,
    # rides and taxi draws, which share one generator in order; numpy's
    # bulk draws release the interpreter lock
    t_data = time.perf_counter()
    side = ThreadPoolExecutor(2)
    events_f = side.submit(_with_seconds, make_events, args.seed)
    keys_f = side.submit(_with_seconds, lambda: (make_payment(args.seed),
                                                 make_users(args.seed)))
    t0 = time.perf_counter()
    words = {(f, r): rng.integers(0, 1 << 32, N_SHARDS * WORDS,
                                  dtype=np.uint32)
             for f in ("stargazer", "language") for r in range(4)}
    rides = make_rides(rng)
    print(f"data: 8 Star-Trace rows, 3 cab_type rows and 22 fare planes x "
          f"{N_SHARDS} shards in {time.perf_counter() - t0:.1f}s", flush=True)
    # The taxi categories come from the generator as it stands after
    # phase 3's one draw (the K3 patch positions), drawn now so that the
    # data dirs build during phase 3; the main paths go on from there.
    path_rng = copy.deepcopy(rng)
    path_rng.choice(WORDS * 32, 1024, replace=False)
    t0 = time.perf_counter()
    taxi = make_taxi(path_rng)
    print(f"taxi categories: {time.perf_counter() - t0:.1f}s", flush=True)
    events, secs = events_f.result()
    print(f"events: {len(EVENT_HOURS)} event-hours x 4 rows, kind and "
          f"active in {secs:.1f}s (in a thread)", flush=True)
    (taxi["payment_type"], users), secs = keys_f.result()
    side.shutdown()
    print(f"keys: payment_type of {N_SHARDS} shards and "
          f"{len(users['keys'])} user keys in {len(USER_SEGMENTS)} segments "
          f"in {secs:.1f}s (in a thread)", flush=True)
    print(f"data drawn in {time.perf_counter() - t_data:.1f}s", flush=True)

    scratch = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    data_dir = scratch / "data"
    builders = start_data_dirs(scratch, words, rides, taxi, events, users)
    # the oracles run in a thread beside phase 3 and the data-dir build:
    # numpy's bulk work releases the interpreter lock
    pool = ThreadPoolExecutor(1)
    oracles = pool.submit(build_oracles, rides, taxi)
    time_oracle = pool.submit(events_oracle, events)
    user_oracle = pool.submit(users_truth, users)
    month_oracle = pool.submit(months_truth, rides)
    wire_oracle = pool.submit(wire_truth, rides, args.seed)
    integ_words = pool.submit(integrity_words, rides, taxi)
    try:
        # phase 3: kernels against their plain versions on the card
        t3 = time.perf_counter()
        leaves = [torch.from_numpy(w.view(np.int32)).to(dev).reshape(
            N_SHARDS, WORDS) for w in words.values()]
        leaves += [torch.roll(leaf, 1, 0) for leaf in leaves]  # 16: R=8 x 2
        report = check_kernels(torch, kernels, batch, leaves, rng)
        planes = torch.from_numpy(rides["fare"].view(np.int32)).to(
            dev).reshape(2 + FARE_DEPTH, N_SHARDS, WORDS).permute(
                1, 0, 2).contiguous()
        report += check_port_kernels(torch, kernels, batch, leaves, planes)
        report += check_taxi_kernels(torch, kernels, leaves, planes)
        report += check_block_kernels(torch, kernels, dev)
        report += check_mesh_kernels(torch, kernels, dev)
        print(f"phase 3: {time.perf_counter() - t3:.1f}s", flush=True)
        del leaves, planes
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for k in report:
            print(f"kernel {k['name']}: bit-exact, {k['ms']} ms "
                  f"(plain {k['plain_ms']} ms, bound {k['bound_ms']} ms"
                  f" by {k['bound_by']}) at {k['shape']}", flush=True)
        print("kernel tree_rows with OP_NOT: bit-exact", flush=True)

        # phase 5, the crash phase, on a directory of its own while the
        # data-dir builders still run (its server process and the reopen
        # are the only users of the card meanwhile)
        kernels.reset_launches()
        t0 = time.perf_counter()
        crash = run_crash_phase(scratch, args.seed, kernels)
        crash_launches = kernels.launches()
        print(f"crash phase (beside the data-dir build): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        # phase 4: the main paths
        t0 = time.perf_counter()
        finish_data_dirs(builders, scratch, data_dir)
        SETUP_S["data_dirs"] = time.perf_counter() - t0
        print(f"data dirs waited for: {SETUP_S['data_dirs']:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        oracle, taxi_truth = oracles.result()
        ev_oracle = time_oracle.result()
        users_o = user_oracle.result()
        months_o = month_oracle.result()
        wire_o = wire_oracle.result()
        integ_o = integ_words.result()
        del taxi, events, users
        print(f"oracles waited for: {time.perf_counter() - t0:.1f}s",
              flush=True)
        paths = run_main_paths(str(data_dir), words, rides, oracle,
                               taxi_truth, ev_oracle, users_o, wire_o,
                               months_o, mesh_truth(taxi_truth, rides, wire_o),
                               path_rng, kernels, args.verify_on_load)
        paths["crash"] = (crash, crash_launches)
        kernels.reset_launches()
        t0 = time.perf_counter()
        integ = run_integrity_phase(data_dir, scratch, integ_o, args.seed,
                                    kernels)
        integ["path_s"] = time.perf_counter() - t0
        paths["integrity"] = (integ, kernels.launches())
    finally:
        builders.shutdown(cancel_futures=True)
        pool.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)
    expected = {
        "Star-Trace": ("tree_count", "tree_rows", "word_patch", "row_shift"),
        "rides": ("tree_count", "word_patch", "bsi_compare", "bsi_sum",
                  "bsi_minmax"),
        "taxi": ("count_rows", "groupby_level", "word_patch"),
        "serving": ("tree_count", "tree_rows", "word_patch", "groupby_level"),
        "time": ("tree_count", "tree_rows", "word_patch", "count_rows",
                 "groupby_level"),
        "keys": ("tree_count", "count_rows", "groupby_level", "word_patch"),
        "wire": ("tree_count", "tree_rows", "word_patch", "count_rows",
                 "groupby_level", "bsi_sum"),
        "mesh": ("tree_count", "tree_rows", "word_patch", "bsi_compare",
                 "bsi_sum", "bsi_minmax", "count_rows", "groupby_level",
                 "lane_reduce", "quant_reduce"),
        "tier": ("block_gather", "block_gather_batch", "block_scatter",
                 "tree_count", "count_rows", "word_patch"),
        "crash": ("tree_count", "tree_rows", "bsi_compare", "bsi_sum"),
        "integrity": ("tree_count", "count_rows", "word_patch"),
    }
    for path, names in expected.items():
        for name in names:
            if paths[path][1][name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
    for k in report:
        k["launches"] = sum(launched[k["name"]]
                            for _, launched in paths.values())
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was not launched on a main path")
    for path, (stats, launched) in paths.items():
        print(f"main path {path}: " + json.dumps(stats), flush=True)
        print(f"launches {path}: {json.dumps(launched)}", flush=True)
    print("set-up s, this run against P1: "
          + json.dumps({k: [round(v, 3), P1_SETUP_S.get(k)]
                        for k, v in SETUP_S.items()}), flush=True)
    print(f"run: {time.perf_counter() - t_run:.1f}s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K3 and K10 also give their device time apart from their call (K10
    # its one-leaf block_gather's and index_select's too), K3, K10 and
    # K11 the launch floor
    extra = ("device_ms", "single_ms", "single_device_ms",
             "library_device_ms", "launch_floor_ms", "bytes_bound_ms",
             "flat_ms", "c_call_ms", "stack_ms", "empty_ms",
             "library_stacked_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--load-client"]:
        sys.exit(load_client())
    sys.exit(main())

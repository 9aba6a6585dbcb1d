#!/usr/bin/env python3
"""K3 ``word_patch``'s way to the card, timed on one NVIDIA GPU.

    python3 scripts/k3_transport.py [--seed N]

A K3 batch (row addresses, run offsets, directions, then the (word,
mask) pairs) reaches the kernel through the pinned staging buffers
``kernels.word_patch_batch`` keeps: one host-to-device copy, then the
launch. For write batches of the shapes the main paths make (a Set into
one row, a 1024-pair patch, one bit into each of 64 or 1024 shards of a
resident row and the existence row, a BSI write over 18 planes) it times
the whole call (host packing included: CUDA events around 100
back-to-back calls, median of 5, twice), the launch alone on a blob
already staged, and the launch floor (an empty kernel through the same
ctypes path), after holding the batch bit-exact against the plain
version. Then it times a batch issued while the stream is busy (behind a
``torch.cuda._sleep`` of about 0.5 s): the host's time for the call and
whether the stream was still busy after it, so that a staging buffer
taken then was not waited for. Prints the card, then one JSON line per
shape and one for the busy stream. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_SHARDS, WORDS = 1024, 32768


def _targets(np, rng, leaf, planes, shape: str) -> list:
    """K3 targets of one write shape (kernels.word_patch_batch's form)."""
    from pilosa_tpu_torch.executor import batch

    def masks(n_bits):
        pos = rng.choice(WORDS * 32, n_bits, replace=False).astype(np.uint32)
        return batch._word_masks(pos)

    if shape == "set":  # Set(col, f=row): one pair into one row
        return [(leaf, 7, None, *masks(1), False)]
    if shape == "patch_1024":  # chip_smoke's K3 shape
        pos = rng.choice(WORDS * 32, 1024, replace=False).astype(np.uint32)
        w, m = batch._word_masks(np.union1d(pos, (pos & ~np.uint32(31)) | 31))
        return [(leaf, 513, None, w, m, False)]
    if shape.startswith("import_"):  # one bit a shard, row + existence
        n = int(shape.split("_")[1])
        out = []
        for s in range(n):
            out.append((leaf, s, None, *masks(1), False))
            out.append((planes, s, 0, *masks(1), False))
        return out
    if shape == "bsi_set":  # Set(col, v=x): exists + 17 planes, both ways
        return [(planes, 9, r, *masks(1), r % 2 == 1) for r in range(18)]
    raise ValueError(shape)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_transport: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pilosa_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    kernels.build(["word_patch"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    leaf = torch.from_numpy(rng.integers(0, 1 << 32, (N_SHARDS, WORDS),
                                         dtype=np.uint32).view(np.int32)).to(dev)
    planes = torch.from_numpy(rng.integers(
        0, 1 << 32, (N_SHARDS, 19, WORDS),
        dtype=np.uint32).view(np.int32)).to(dev)
    cuda_ms = chip_smoke.cuda_ms
    floor = cuda_ms(torch, lambda: kernels.launch_floor(dev), launches=100)
    for shape in ("set", "patch_1024", "bsi_set", "import_64",
                  "import_1024"):
        targets = _targets(np, rng, leaf, planes, shape)
        blob, t, n = kernels.word_patch_pack(targets)
        # bit-exact against the plain version
        want = [x.clone() for x in (leaf, planes)]
        got = [x.clone() for x in (leaf, planes)]
        for out, fn in ((want, kernels.word_patch_batch_plain),
                        (got, kernels.word_patch_batch)):
            swap = {id(leaf): out[0], id(planes): out[1]}
            fn([(swap[id(x[0])], *x[1:]) for x in targets])
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            print(f"k3_transport: the kernel disagrees at {shape}",
                  file=sys.stderr)
            return 1
        del got, want

        turns = [cuda_ms(torch, lambda: kernels.word_patch_batch(targets),
                         launches=100) for _ in range(2)]
        staged = torch.from_numpy(blob).to(dev)
        row = {
            "shape": shape, "targets": t, "pairs": n, "blob_bytes": blob.size,
            "call_ms": sum(turns) / 2,
            "device_ms": cuda_ms(torch, lambda: kernels.word_patch_launch_staged(
                staged, t, n), launches=100),
            "launch_floor_ms": floor,
            "bytes_bound_ms": 1e3 * 16 * n / chip_smoke.HBM_BYTES_PER_S,
            "turns_ms": turns,
        }
        print(json.dumps(row), flush=True)

    # batches behind a busy stream: new staging buffers, no wait
    targets = _targets(np, rng, leaf, planes, "import_64")
    torch.cuda.synchronize()
    held = len(kernels._pool(dev).slots)
    torch.cuda._sleep(1 << 30)
    t0 = time.perf_counter()
    for _ in range(8):
        kernels.word_patch_batch(targets)
    host_ms = 1e3 * (time.perf_counter() - t0) / 8
    busy = not torch.cuda.current_stream(dev).query()
    torch.cuda.synchronize()
    print(json.dumps({"shape": "import_64 x 8 behind a busy stream",
                      "host_call_ms": host_ms, "stream_busy_after": busy,
                      "buffers_before": held,
                      "buffers_after": len(kernels._pool(dev).slots)}),
          flush=True)
    if not busy:
        print("k3_transport: a batch waited for the card", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

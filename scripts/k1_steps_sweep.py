#!/usr/bin/env python3
"""K1 ``tree_count``'s time by steps a block, on one NVIDIA GPU.

    python3 scripts/k1_steps_sweep.py [--seed N]

Times the 4-query micro-batches that ``chip_smoke.py`` times (a 2-leaf
AND, a 3-leaf Union chain, and a 2-leaf Difference under OP_NOT, which is
the general form) over random int32[1024, 32768] leaves at 1, 2, 4 and 8
steps a block, by setting ``kernels.TREE_COUNT_STEPS`` for the form, and
prints the card, then one JSON line per program with its byte bound.
``kernels.TREE_COUNT_STEPS`` holds the steps this sweep found best.
Exits non-zero without a CUDA device, or if a time's count disagrees
with the plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_SHARDS, WORDS = 1024, 32768


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_steps_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pilosa_tpu_torch import kernels
    from pilosa_tpu_torch.executor import expr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    kernels.build(["tree_count"])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    leaves = [torch.randint(-(1 << 31), 1 << 31, (N_SHARDS, WORDS),
                            dtype=torch.int32, device="cuda", generator=gen)
              for _ in range(12)]
    leaf_bytes = N_SHARDS * WORDS * 4
    for name, structure, n in (
            ("2-leaf AND", ("and", ("leaf", 0), ("leaf", 1)), 2),
            ("3-leaf Union", chip_smoke._chain("or", [0, 1, 2]), 3),
            ("2-leaf Difference under OP_NOT (general)",
             ("diff", ("flipall", ("leaf", 0)), ("flipall", ("leaf", 1))),
             2)):
        prog = expr.compile_program(structure)
        form = kernels.classify_program(prog).kind
        mb = [leaves[3 * q:3 * q + n] for q in range(4)]
        want = kernels.tree_count_plain(prog, mb, [0] * 4, WORDS)
        chosen = kernels.TREE_COUNT_STEPS[form]
        times = {}
        try:
            for steps in (1, 2, 4, 8):
                kernels.TREE_COUNT_STEPS[form] = steps
                if not torch.equal(kernels.tree_count(prog, mb, [0] * 4,
                                                      WORDS), want):
                    print(f"k1_steps_sweep: {name} at {steps} steps "
                          "disagrees with the plain version", file=sys.stderr)
                    return 1
                times[steps] = chip_smoke.cuda_ms(
                    torch, lambda: kernels.tree_count(prog, mb, [0] * 4,
                                                      WORDS))
        finally:
            kernels.TREE_COUNT_STEPS[form] = chosen
        print(json.dumps({"program": name, "form": form,
                          "steps_in_use": chosen, "ms_by_steps": times,
                          "bound_ms": chip_smoke._bytes_ms(
                              4 * n * leaf_bytes)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K10 ``block_gather`` and K11 ``block_scatter`` alone, on one NVIDIA GPU.

    python3 scripts/k10_gather.py

Builds the two kernels (and K3's, whose empty kernel is the launch
floor), prints the card and ptxas' register and shared-memory report,
then runs ``chip_smoke.check_block_kernels``: K10 (as the residency
cache calls it, and alone on a device index) and K11 bit-exact against
their plain versions at a 1024-shard month leaf's shape (and on random
and all-zero leaves), K10 batched over 16 month leaves in one launch,
with K10's whole calls and device times beside ``index_select`` and the
launch floor. Prints one JSON line of the kernel rows. Exits non-zero
without a CUDA device or when a kernel disagrees with its plain version.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k10_gather: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pilosa_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    built = kernels.build(["block_gather", "block_scatter", "word_patch"])
    print(f"build: {built}", flush=True)
    for log in sorted(kernels.BUILD_DIR.glob("libblock_*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {log.name.split('-')[0]}: {line.strip()}")
    rows = chip_smoke.check_block_kernels(torch, kernels,
                                          torch.device("cuda"))
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

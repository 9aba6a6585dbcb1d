"""Device selection for the port's entry points.

Every entry point (Holder, Executor, Server, the CLI) runs on ``cuda``
unless its caller asks for the CPU, as the tests do. Asking for cuda on a
machine without a GPU raises: nothing falls back to the CPU, so a run
that reports a device number has really run on that device.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means cuda. Returns a validated ``torch.device``; raises
    RuntimeError when cuda is asked for and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pilosa_tpu_torch runs on a CUDA GPU by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev

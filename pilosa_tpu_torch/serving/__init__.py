"""The serving tier (the port's copy of ``pilosa_tpu.serving``): the
result cache (``rescache``) and multi-process serving.

One interpreter runs the request's host work in single-process mode:
HTTP parse, the QoS envelope, PQL parse, the wave and the response
writes. Multi-process serving spreads that work over N
``SO_REUSEPORT`` worker processes (``worker.py``) in front of one
device-owner process (``mpserve.py``), which keeps the holder, the WAL,
the card and the executor; edge queries cross a pickle-free
shared-memory ring a worker (``shmring.py``) with torn-record-safe
framing and backpressure. Platforms without ``SO_REUSEPORT`` fall back
to single-process mode. None of these modules imports torch.
"""

from pilosa_tpu_torch.serving.shmring import (
    RingFull,
    ShmRing,
    decode_frame,
    encode_frame,
)

__all__ = ["RingFull", "ShmRing", "decode_frame", "encode_frame"]

"""Bounded concurrent map (the port's copy of ``pilosa_tpu.utils.pool``):
the ``ingest-workers`` pool applies an import's shard groups through
``concurrent_map``. Each worker call runs in a copy of the submitting
thread's ``contextvars`` context, so the trace span, the in-flight query
record and the cost context survive the hop.
"""

from __future__ import annotations

import contextvars
from concurrent.futures import ThreadPoolExecutor

# The reference's bound on one fan-out's threads.
MAX_FANOUT = 16


def concurrent_map(fn, items, max_workers: int = MAX_FANOUT) -> list:
    """Apply ``fn`` to every item concurrently; results in input order.

    The first exception propagates to the caller (after in-flight calls
    finish: pool shutdown joins its threads). Each worker invocation
    runs inside a copy of the submitting thread's ``contextvars``
    context, so the active trace span, in-flight query record and cost
    context survive the hop. Copies are O(1) (immutable HAMT) and
    per-item, so concurrent workers never contend on one Context.
    """
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    ctxs = [contextvars.copy_context() for _ in items]
    with ThreadPoolExecutor(max_workers=min(max_workers, len(items))) as pool:
        return list(pool.map(lambda p: p[0].run(fn, p[1]),
                             zip(ctxs, items)))

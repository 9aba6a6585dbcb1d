"""Views: named fragment groups within a field (reference view.go).

The port's thin copy of ``pilosa_tpu.storage.view``: the same directory
layout (``views/<name>/fragments/<shard>``). The ``standard`` view holds
set rows, ``bsig_<field>`` an int field's bit planes, and a time field's
quantum views ``standard_YYYY[MM[DD[HH]]]`` its timestamped bits.
``views_by_time_range`` covers a [from, to) window with the coarsest
views the quantum provides, name for name as the reference does. A
fragment that fails its open's verification is quarantined
(``storage/integrity.py``) and the view opens without it, as the
reference's does.
"""

from __future__ import annotations

import datetime as dt
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch.storage.cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.integrity import (
    CorruptFragmentError,
    global_integrity,
    quarantine_paths,
)

_LOG = logging.getLogger("pilosa_tpu_torch.storage.view")

VIEW_STANDARD = "standard"
_UNITS = "YMDH"


def view_name_bsi(field_name: str) -> str:
    return f"bsig_{field_name}"


def validate_quantum(q: str) -> str:
    """``q`` if it is "" or a subsequence of YMDH, else ValueError."""
    if q == "":
        return q
    if any(c not in _UNITS for c in q) or \
            "".join(u for u in _UNITS if u in q) != q:
        raise ValueError(
            f"invalid time quantum {q!r} (want a subsequence of YMDH)")
    return q


def _trunc(t: dt.datetime, unit: str) -> dt.datetime:
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0,
                         microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _advance(t: dt.datetime, unit: str) -> dt.datetime:
    if unit == "Y":
        return t.replace(year=t.year + 1)
    if unit == "M":
        return (t.replace(day=28) + dt.timedelta(days=4)).replace(day=1)
    if unit == "D":
        return t + dt.timedelta(days=1)
    return t + dt.timedelta(hours=1)


def _name(base: str, t: dt.datetime, unit: str) -> str:
    fmt = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}[unit]
    return f"{base}_{t.strftime(fmt)}"


def views_for_time(base: str, quantum: str, t: dt.datetime) -> list[str]:
    """The views a write stamped ``t`` lands in besides ``base``: one per
    unit of the quantum."""
    return [_name(base, t, u) for u in quantum]


def views_by_time_range(base: str, quantum: str, t_from: dt.datetime,
                        t_to: dt.datetime) -> list[str]:
    """The cover of [t_from, t_to) by quantum views, in time order: from
    ``t_from`` truncated to the finest unit, each step takes the coarsest
    unit aligned there whose span ends by ``t_to``, else the finest unit
    (a window edge inside an hour takes that whole hour). Empty when
    t_from >= t_to or the quantum is empty."""
    if not quantum:
        return []
    units = [u for u in _UNITS if u in quantum]  # coarse to fine
    finest = units[-1]
    out: list[str] = []
    t = _trunc(t_from, finest)
    while t < t_to:
        for u in units:
            if _trunc(t, u) == t and _advance(t, u) <= t_to:
                break
        else:
            u = finest
        out.append(_name(base, t, u))
        t = _advance(t, u)
    return out


def _each(fn, frags: list) -> list:
    """``fn`` on every fragment, in up to 8 threads; the results in
    order."""
    workers = min(8, os.cpu_count() or 1, len(frags))
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            return list(pool.map(fn, frags))
    return [fn(frag) for frag in frags]


def _open_checked(frag: Fragment) -> CorruptFragmentError | None:
    try:
        frag.open()
    except CorruptFragmentError as e:
        return e
    return None


class View:
    def __init__(self, path: str, index: str, field: str, name: str,
                 scope: str = "", cache=None,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 verify_on_load: bool = False, wal=None):
        self.path = path  # .../views/<name>
        self.index = index
        self.field = field
        self.name = name
        self.scope = scope
        self.cache = cache
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.verify_on_load = verify_on_load
        self.wal = wal
        self.fragments: dict[int, Fragment] = {}
        # serializes first-write fragment creation: two writers racing an
        # unlocked check-then-create would get distinct Fragment objects
        # for one file and one writer's bits would vanish
        self._create_lock = threading.Lock()

    def _new_fragment(self, shard: int) -> Fragment:
        return Fragment(os.path.join(self.path, "fragments", str(shard)),
                        self.index, self.field, self.name, shard,
                        scope=self.scope, cache=self.cache,
                        cache_type=self.cache_type,
                        cache_size=self.cache_size,
                        verify_on_load=self.verify_on_load, wal=self.wal)

    def open(self) -> "View":
        """Open every fragment file, several at once: verifying a
        snapshot's digests is numpy and hashlib work that runs outside
        the GIL. A fragment whose bytes fail to decode or verify is
        quarantined and left out: its rotten bytes are never served."""
        frag_dir = os.path.join(self.path, "fragments")
        os.makedirs(frag_dir, exist_ok=True)
        frags = [self._new_fragment(int(entry))
                 for entry in sorted(os.listdir(frag_dir)) if entry.isdigit()]
        for frag, err in zip(frags, _each(_open_checked, frags)):
            if err is not None:
                global_integrity().count("verify_failures")
                quarantine_paths(frag.path, reason=str(err))
                _LOG.error("startup quarantine of %s/%s/%s/%d: %s",
                           self.index, self.field, self.name, frag.shard, err)
                continue
            self.fragments[frag.shard] = frag
        return self

    def close(self, discard: bool = False) -> None:
        """Close every fragment, several at once: in group mode each dirty
        one snapshots and digests its bit ids. ``discard``: the files are
        about to go (a delete), so nothing is written."""
        _each(lambda frag: frag.close(discard=discard),
              list(self.fragments.values()))

    def fragment(self, shard: int, create: bool = False) -> Fragment | None:
        frag = self.fragments.get(shard)
        if frag is None and create:
            with self._create_lock:
                frag = self.fragments.get(shard)
                if frag is None:
                    frag = self._new_fragment(shard).open()
                    self.fragments[shard] = frag
        return frag

    def available_shards(self) -> list[int]:
        return sorted(self.fragments)

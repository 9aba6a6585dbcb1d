"""Bulk load of dense row words into a holder's fragments.

The counterpart of carrying weights over: the tests fill both packages
from one numpy seed, and ``chip_smoke.py`` builds a 1B-column data
directory, without pushing billions of column ids through the op log.
Each fragment that gains a bit is rewritten as one fresh snapshot, in the
container forms ``Container.from_lows`` would pick, so the files are the
ones either package writes for the same bits. Rows may go into a named
view (a time field's quantum views), and a mutex or bool field's rows
are checked to hold each column once. A keyed field's rows and a keyed
index's columns may be named by string keys: their translate records are
written in id order, as a Set of each key in turn would write them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import (
    ARRAY,
    ARRAY_MAX,
    BITMAP,
    RUN,
    Container,
    RoaringBitmap,
)
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD
from pilosa_tpu_torch.storage.field import (
    BSI_EXISTS_ROW,
    BSI_OFFSET_ROW,
    TYPE_BOOL,
    TYPE_INT,
    TYPE_MUTEX,
    FieldOptions,
)
from pilosa_tpu_torch.storage.index import EXISTENCE_FIELD
from pilosa_tpu_torch.storage.translate import column_namespace, row_namespace
from pilosa_tpu_torch.storage.view import VIEW_STANDARD

CONTAINER_WORDS = 2048  # uint32 words per roaring container
CONTAINERS_PER_ROW = WORDS_PER_SHARD // CONTAINER_WORDS


def _lows(words: np.ndarray) -> list:
    """uint32[k, 2048] container words → each container's sorted uint16
    set positions. The nonzero words give up their lowest set bit a pass
    (its index read off the float exponent), so the work grows with the
    set bits, not with 32 a nonzero word."""
    ci, wi = np.nonzero(words)
    w = words[ci, wi]
    base = (ci.astype(np.int64) << 16) | (wi.astype(np.int64) << 5)
    keys = []
    while w.size:
        low = w & (~w + np.uint32(1))
        keys.append(base + (np.frexp(low.astype(np.float64))[1] - 1))
        w = w ^ low
        left = w != 0
        w, base = w[left], base[left]
    key = np.sort(np.concatenate(keys)) if keys else np.empty(0, np.int64)
    lows = (key & 0xFFFF).astype(np.uint16)
    bounds = np.searchsorted(key >> 16, np.arange(words.shape[0] + 1))
    return [lows[bounds[i]:bounds[i + 1]] for i in range(words.shape[0])]


def canonical_containers(words: np.ndarray) -> list:
    """uint32[n, 2048] container words → the n containers (None for an
    empty one) that ``Container.from_lows`` builds for the same bits. The
    form is decided for all containers at once from their cardinalities
    and run counts; a run container's runs come from the bits where a run
    starts and ends, an array container's values from its set bits."""
    words = np.ascontiguousarray(words, np.uint32)
    n = np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    carry = np.zeros_like(words)
    carry[:, 1:] = words[:, :-1] >> np.uint32(31)
    starts = words & ~((words << np.uint32(1)) | carry)
    n_runs = np.bitwise_count(starts).sum(axis=1, dtype=np.int64)
    runs = 4 * n_runs < np.minimum(2 * n, 8192)  # runs beat both forms
    is_bitmap = (n > ARRAY_MAX) & ~runs
    is_array = (n > 0) & ~is_bitmap & ~runs
    carry[:, :-1] = words[:, 1:] << np.uint32(31)
    carry[:, -1] = 0
    ends = words & ~((words >> np.uint32(1)) | carry)
    forms = {}
    for mask, src in ((is_array, (words,)), (runs, (starts, ends))):
        idx = np.flatnonzero(mask)
        if idx.size:
            parts = [_lows(a[idx]) for a in src]
            forms.update(zip(idx.tolist(), zip(*parts)))
    out = []
    for i in range(words.shape[0]):
        if n[i] == 0:
            out.append(None)
        elif is_bitmap[i]:
            out.append(Container(BITMAP, words[i].view("<u8").copy(), int(n[i])))
        elif runs[i]:
            first, last = forms[i]
            out.append(Container(RUN, np.stack([first, last], axis=1), int(n[i])))
        else:
            out.append(Container(ARRAY, forms[i][0], int(n[i])))
    return out


def _load_fragment(frag, rows: dict, single_valued: bool = False) -> int:
    """OR ``rows`` ({row: uint32[32768]}) into one fragment as a fresh
    snapshot, unless it gains no bit; returns the number of bits the
    fragment gained. ``single_valued`` (a mutex or bool field): a column
    set in two rows of the result is a ValueError."""
    old = frag.bitmap
    bm = RoaringBitmap()
    bm._containers = dict(old._containers)
    before = old.count()
    # every row's containers in one block, so their forms are decided in
    # one pass
    keys = [(row << 4) + j for row in rows for j in range(CONTAINERS_PER_ROW)]
    block = np.stack([np.asarray(w, np.uint32) for w in rows.values()]) \
        .reshape(len(keys), CONTAINER_WORDS)
    for i, key in enumerate(keys):
        c = old.container(key)
        if c is not None:
            block[i] |= c.dense_words32()
    for key, c in zip(keys, canonical_containers(block)):
        if c is None:
            bm._containers.pop(key, None)
        else:
            bm._containers[key] = c
    bm.keys = sorted(bm._containers)
    if single_valued:
        seen = np.zeros(WORDS_PER_SHARD, np.uint32)
        for row in sorted({k >> 4 for k in bm.keys}):
            words = bm.dense_range_words32(row << 20, (row + 1) << 20)
            if (seen & words).any():
                raise ValueError(f"{frag.field}: a column of shard "
                                 f"{frag.shard} is in two rows of a mutex "
                                 "field")
            seen |= words
    gained = bm.count() - before
    if gained:  # bits are only added: an equal count is an equal bitmap
        frag.replace_bitmap(bm, rows)
    return gained


def _check_planes(name: str, opts: FieldOptions, planes: np.ndarray) -> None:
    """Plane words must hold values the field can store: no magnitude or
    sign bit on a column that does not exist, and no stored value above
    ``max - min`` (checked on the values only when some depth-bit value
    would exceed it)."""
    depth = opts.bit_depth
    if planes.ndim != 2 or planes.shape[0] != BSI_OFFSET_ROW + depth:
        raise ValueError(f"int field {name!r} takes {BSI_OFFSET_ROW + depth} "
                         f"plane rows, got {planes.shape}")
    missing = ~planes[BSI_EXISTS_ROW]
    if any((row & missing).any() for row in planes[1:]):
        raise ValueError(f"int field {name!r}: plane bits on columns "
                         "without the exists bit")
    span = opts.max - opts.min
    if span < (1 << depth) - 1:
        bits = np.unpackbits(planes[BSI_OFFSET_ROW:].view(np.uint8), axis=1,
                             bitorder="little").astype(np.uint64)
        weights = np.uint64(1) << np.arange(depth, dtype=np.uint64)
        if int((weights @ bits).max()) > span:
            raise ValueError(f"int field {name!r}: a stored value exceeds "
                             f"max - min = {span}")


def _translate_rows(holder, idx, fld, rows: dict) -> dict:
    """``rows`` with each string key replaced by its row id (new keys
    take the next ids, in the order given)."""
    keys = [r for r in rows if isinstance(r, str)]
    if not keys:
        return rows
    if not fld.options.keys:
        raise ValueError(f"row key {keys[0]!r} on field {fld.name!r} "
                         "without keys=true")
    ids = dict(zip(keys, holder.translate.translate(
        row_namespace(idx.name, fld.name), keys, create=True)))
    return {ids.get(r, r) if isinstance(r, str) else r: w
            for r, w in rows.items()}


def _translate_columns(holder, idx, column_keys) -> None:
    """Give column key i the column id i (keys new to the index, or
    already holding those ids)."""
    if not idx.keys:
        raise ValueError(f"column keys on index {idx.name!r} without "
                         "keys=true")
    ids = holder.translate.translate(column_namespace(idx.name),
                                     list(column_keys), create=True)
    if not np.array_equal(np.asarray(ids, np.int64),
                          np.arange(len(ids), dtype=np.int64)):
        raise ValueError(f"column keys of index {idx.name!r} must take "
                         "the ids 0 … n-1")


def load_from_dense(holder, fields: dict, *, index: str,
                    int_fields: dict | None = None,
                    views: dict | None = None,
                    options: dict | None = None,
                    existence: bool = True,
                    column_keys=None) -> int:
    """Set the bits of dense words in ``index`` (created, with its fields,
    when missing).

    ``fields`` is ``{field: {row: words}}`` for set-like fields, where
    ``words`` are uint32, ``n_shards x 32768`` of them, shard-major — bit
    ``b`` of the flat array is column ``b``. ``views`` is ``{field:
    {view: {row: words}}}``: rows written into a named view of the field
    (a time field's ``standard_YYYY…`` views). ``options`` is ``{field:
    FieldOptions}`` for the set-like fields the loader creates (a set
    field by default); a mutex or bool field's rows must leave each
    column in one row at most, and a bool field has rows 0 and 1 alone.
    ``int_fields`` is ``{field: (min, max, planes)}`` for int fields,
    ``planes`` being uint32[2 + depth, n_shards x 32768]: the exists row,
    the sign row and the bit planes of the offset-encoded values, as the
    field's ``bsig`` view holds them. Columns that gain a bit (int
    fields: the exists bit) are marked existing, as an import marks them,
    unless ``existence`` is False (a caller building fields in parallel
    marks them once with ``load_existence``). A keyed field's rows may
    be string keys; ``column_keys`` (a sequence of strings) names column
    ``i`` by ``column_keys[i]`` in a keyed index (created with keys when
    missing). Returns the number of bits set that were not set before."""
    idx = holder.index(index) or holder.create_index(
        index, keys=column_keys is not None)
    if column_keys is not None:
        _translate_columns(holder, idx, column_keys)
    options = options or {}
    exists: dict[int, np.ndarray] = {}
    gained = 0
    layers = [(fname, VIEW_STANDARD, rows, options.get(fname))
              for fname, rows in fields.items()]
    layers += [(fname, vname, rows, options.get(fname))
               for fname, by_view in (views or {}).items()
               for vname, rows in by_view.items()]
    for fname, (lo, hi, planes) in (int_fields or {}).items():
        opts = FieldOptions(type=TYPE_INT, min=lo, max=hi)
        planes = np.asarray(planes, np.uint32)
        _check_planes(fname, opts, planes)
        layers.append((fname, None, dict(enumerate(planes)), opts))
    for fname, vname, rows, opts in layers:
        fld = idx.field(fname) or idx.create_field(fname, opts)
        bsi = vname is None
        if not bsi:
            rows = _translate_rows(holder, idx, fld, rows)
        if (fld.options.type == TYPE_INT) != bsi:
            raise ValueError(f"field {fname!r} is a {fld.options.type} field")
        single_valued = fld.options.type in (TYPE_MUTEX, TYPE_BOOL)
        if fld.options.type == TYPE_BOOL and any(int(r) not in (0, 1)
                                                 for r in rows):
            raise ValueError(f"bool field {fname!r} has rows 0 and 1 only")
        view = fld.view(vname or fld.bsi_view_name(), create=True)
        per_shard: dict[int, dict] = {}
        for row, words in rows.items():
            if int(row) < 0:
                raise ValueError(f"row {row} is negative")
            w = np.asarray(words, np.uint32).reshape(-1, WORDS_PER_SHARD)
            marks = not bsi or int(row) == BSI_EXISTS_ROW
            for shard in np.flatnonzero(w.any(axis=1)).tolist():
                per_shard.setdefault(shard, {})[int(row)] = w[shard]
                if marks:
                    acc = exists.get(shard)
                    exists[shard] = w[shard] if acc is None else acc | w[shard]
        # fragments are independent: several are built at once (their
        # container forms, snapshot and block digests are numpy and
        # hashlib work that runs outside the GIL)
        jobs = sorted(per_shard.items())
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            gained += sum(pool.map(
                lambda job: _load_fragment(view.fragment(job[0], create=True),
                                           job[1], single_valued), jobs))
    if existence:
        _load_existence(idx, exists)
    return gained


def _load_existence(idx, exists: dict) -> None:
    if idx.track_existence and exists:
        view = idx.field(EXISTENCE_FIELD).view(VIEW_STANDARD, create=True)
        for shard, words in sorted(exists.items()):
            _load_fragment(view.fragment(shard, create=True), {0: words})


def load_existence(holder, words, *, index: str) -> None:
    """Mark the columns whose bit is set in dense ``words`` (uint32,
    ``n_shards x 32768`` of them, shard-major) existing in ``index``
    (created when missing), as ``load_from_dense`` marks the columns it
    loads."""
    idx = holder.index(index) or holder.create_index(index)
    w = np.asarray(words, np.uint32).reshape(-1, WORDS_PER_SHARD)
    _load_existence(idx, {shard: w[shard] for shard in
                          np.flatnonzero(w.any(axis=1)).tolist()})
